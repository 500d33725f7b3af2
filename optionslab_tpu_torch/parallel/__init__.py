"""Monte Carlo and risk over a device mesh, from one controller: the
topology-invariant sharded tensor engine, every kernel route at a global
block offset, and VaR/ES from per-shard tails (``mesh`` says how a mesh is
built and what a sharded call does)."""

from .mesh import BOOK_AXIS, PATH_AXIS, Mesh, book_sharding, make_mesh, path_sharding, \
    replicated, shard, unshard
from .sharded_mc import sharded_book_greeks, sharded_book_price, sharded_mc_price
from .sharded_pallas import (sharded_exotic_greeks, sharded_exotic_price,
                             sharded_heston_exotic_greeks,
                             sharded_heston_exotic_price,
                             sharded_heston_greeks,
                             sharded_local_vol_greeks,
                             sharded_local_vol_price,
                             sharded_multi_asset_greeks,
                             sharded_multi_asset_price,
                             sharded_pallas_greeks,
                             sharded_slv_greeks, sharded_slv_price)
from .sharded_risk import sharded_historical_var_es, sharded_mc_var

__all__ = [
    "BOOK_AXIS",
    "PATH_AXIS",
    "Mesh",
    "make_mesh",
    "path_sharding",
    "book_sharding",
    "replicated",
    "shard",
    "unshard",
    "sharded_mc_price",
    "sharded_book_price",
    "sharded_book_greeks",
    "sharded_pallas_greeks",
    "sharded_exotic_price",
    "sharded_exotic_greeks",
    "sharded_heston_greeks",
    "sharded_heston_exotic_price",
    "sharded_heston_exotic_greeks",
    "sharded_multi_asset_price",
    "sharded_multi_asset_greeks",
    "sharded_local_vol_price",
    "sharded_local_vol_greeks",
    "sharded_slv_price",
    "sharded_slv_greeks",
    "sharded_historical_var_es",
    "sharded_mc_var",
]
