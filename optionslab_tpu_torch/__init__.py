"""optionslab_tpu_torch — the PyTorch/CUDA port of ``optionslab_tpu``.

The port imports ``torch`` and never ``jax``; ``optionslab_tpu`` stays the
reference that its tests compare it with. This slice carries the main path:
a book of GBM European contracts priced by Monte Carlo with the full Greek
ladder from one pass of a hand-written CUDA kernel (``csrc/gbm_mc.cu``),
served through :class:`MonteCarloPricer` and the HTTP server's ``/mc``.

Subpackages
-----------
``models``  Black–Scholes closed form (the oracle) and Monte Carlo
``ops``     the GBM kernel's wrapper and plain version, samplers, math
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
from .ops import gbm_mc_price, gbm_mc_price_greeks, gbm_mc_price_only, gbm_paths_per_launch
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
    "gbm_mc_price",
    "gbm_mc_price_greeks",
    "gbm_mc_price_only",
    "gbm_paths_per_launch",
    "mc_greeks",
    "mc_price",
    "mc_price_control_variate",
    "mc_price_result",
]
