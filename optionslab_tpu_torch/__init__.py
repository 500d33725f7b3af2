"""optionslab_tpu_torch — the PyTorch/CUDA port of ``optionslab_tpu``.

The port imports ``torch`` and never ``jax``; ``optionslab_tpu`` stays the
reference that its tests compare it with. This slice carries the main path:
a book of GBM European contracts priced by Monte Carlo with the full Greek
ladder from one pass of a hand-written CUDA kernel (``csrc/gbm_mc.cu``),
served through :class:`MonteCarloPricer` and the HTTP server's ``/mc``;
and the GBM exotic path: path-dependent payoffs, likelihood-ratio and
pathwise Greek ladders and contract books from two more kernels
(``csrc/exotic_mc.cu``, ``csrc/exotic_greeks.cu``), served through the
``ops.exotic_kernel`` functions, the ``models.exotics`` dataclasses and the
server's ``/exotic`` and ``/book/exotic``.

Subpackages
-----------
``models``  Black–Scholes, Monte Carlo, exotics (closed forms, scan engine,
            dataclasses) and contract books
``ops``     the kernels' wrappers and plain versions, samplers, QMC, math
``utils``   dtype policy, exceptions, validation, logging, timing
"""

from .models import (
    BlackScholesPricer,
    MCConfig,
    MCMethod,
    MCResult,
    MonteCarloPricer,
    bs_greeks,
    bs_greeks_ad,
    bs_price,
    bs_vega,
    mc_greeks,
    mc_price,
    mc_price_control_variate,
    mc_price_result,
)
from .ops import (
    exotic_greeks,
    exotic_kernel_ladder,
    exotic_lr_greeks,
    exotic_price,
    gbm_mc_price,
    gbm_mc_price_greeks,
    gbm_mc_price_only,
    gbm_paths_per_launch,
)
from .server import PricingServer
from .types import ContractBatch
from .utils import ValidationError

__all__ = [
    "BlackScholesPricer",
    "ContractBatch",
    "MCConfig",
    "MCMethod",
    "MCResult",
    "MonteCarloPricer",
    "PricingServer",
    "ValidationError",
    "bs_greeks",
    "bs_greeks_ad",
    "bs_price",
    "bs_vega",
    "exotic_greeks",
    "exotic_kernel_ladder",
    "exotic_lr_greeks",
    "exotic_price",
    "gbm_mc_price",
    "gbm_mc_price_greeks",
    "gbm_mc_price_only",
    "gbm_paths_per_launch",
    "mc_greeks",
    "mc_price",
    "mc_price_control_variate",
    "mc_price_result",
]
