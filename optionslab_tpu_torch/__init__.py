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
server's ``/exotic`` and ``/book/exotic``; and the Heston European path: the
Lewis and COS pricers, the scan engine and calibration (``models.heston``),
and Euler and QE prices and Greek ladders and whole-chain pricing with the
calibration gradient from four more kernels (``csrc/heston_mc.cu``,
``csrc/heston_qe.cu``, ``csrc/heston_chain.cu``), served through the
``ops.heston_kernel`` functions, :class:`HestonPricer` and the server's
``/price`` with ``model: "heston"``; and the Heston/Bates exotic path: the
Bates model (``models.bates``), the scan engine of ``models.heston_exotics``
and path-dependent prices, one-pass LR Greek ladders and contract books
under Heston or Bates, Euler or QE, from one more kernel
(``csrc/heston_exotic.cu``), served through the ``ops.heston_exotic_kernel``
functions, the Heston/Bates books and the server's ``/exotic`` and
``/book/exotic`` with ``model: "heston"|"bates"`` and ``/price`` with
``model: "bates"``; and the smile path: Dupire local vol (``models.local_vol``:
the surface, the local-vol PDE, the scan engine) and stochastic local vol
(``models.slv``: the particle calibration, the scan engine), priced on two
more kernels (``csrc/local_vol_mc.cu``, ``csrc/slv_mc.cu``) through
``ops.local_vol_kernel.LocalVolKernelPricer`` and
``ops.slv_kernel.SLVKernelPricer``, and served by ``/exotic`` with
``model: "lv"|"slv"``; and the multi-asset path: correlated baskets,
rainbows, spreads and the basket Asian on d = 2–4 assets with a per-asset
likelihood-ratio Greek ladder, from one more kernel
(``csrc/multi_asset_mc.cu``) through ``ops.multi_asset_kernel``, the scan
engine and closed forms of ``models.multi_asset``, the Bermudan max-call
bracket of ``models.multi_asset_american``, and the server's ``/basket``.

Subpackages
-----------
``models``  Black–Scholes, Monte Carlo, exotics (closed forms, scan engine,
            dataclasses), contract books, Heston, Bates and the
            Heston/Bates exotics' scan engine, local vol and SLV, the
            multi-asset engines and the multi-asset Bermudan bracket
``ops``     the kernels' wrappers and plain versions, samplers, QMC, math
``greeks``  the autograd Greeks engine: the model adapters, the
            finite-difference oracle and the lattice Greeks
``risk``    VaR/ES, stress, sensitivity, portfolio Greeks, counterparty
            exposure (GBM, Heston, AMC under GBM/Heston/Bates/SLV/rough
            Bergomi) and CVA/DVA/FVA, served by the server's ``/xva``
``surface`` SVI/SSVI/eSSVI surfaces and their arbitrage checks, the chain
            calibration (to a surface, to Heston/Bates/rough Bergomi, to a
            Dupire surface), served by the server's ``/calibrate``; the
            learned surfaces (MLP, PINN, kernel ridge, forests, the quote
            interpolator) and grid search
``optimize`` hyperparameter studies (TPE/Sobol/random, pruning, SQLite),
            search spaces and objectives, ``torch.export`` and ``.onnx``
            artifacts, reproducibility
``data``    chain loading without pandas (CBOE, OptionMetrics, csv,
            synthetic), the market-data client
``backtest`` the delta-hedge backtest and its strike × sigma sweep, with
            no loop over days
``benchmarks`` the vol-surface benchmark harness (error, speed,
            stability, EPP across the surface models)
``parallel`` device meshes from one controller: the topology-invariant
            sharded Monte Carlo, every kernel route sharded by global path
            block, VaR/ES from per-shard tails
``utils``   dtype policy, exceptions, validation, logging, timing,
            profiling, checkpoints, the plots and the HTML desk report

``python -m optionslab_tpu_torch.cli <command>`` (``cli.py``) is the
command line: every subcommand of the JAX package's, on ``--device``
(``cuda`` unless ``cpu`` is asked for).
"""

from . import (backtest, benchmarks, data, greeks, models, ops, optimize, parallel, risk, surface,
               utils)
from .models import (
    BatesParams,
    BatesPricer,
    BinomialTree,
    BlackScholesPricer,
    CrankNicolsonSolver,
    DupireLocalVol,
    KouJumpDiffusion,
    LocalVolSurface,
    MCConfig,
    MCMethod,
    HestonParams,
    HestonPricer,
    MCResult,
    MonteCarloMLSurrogate,
    MertonJumpDiffusion,
    MonteCarloPricer,
    SABRModel,
    SLVModel,
    bs_greeks,
    bs_greeks_ad,
    bs_price,
    bates_price,
    bs_vega,
    calibrate_bates,
    calibrate_heston,
    calibrate_heston_mc,
    heston_price,
    implied_volatility,
    mc_greeks,
    mc_price,
    mc_price_control_variate,
    mc_price_result,
)
from .ops import (
    LocalVolKernelPricer,
    SLVKernelPricer,
    exotic_greeks,
    exotic_kernel_ladder,
    exotic_lr_greeks,
    exotic_price,
    gbm_mc_price,
    gbm_mc_price_greeks,
    gbm_mc_price_only,
    gbm_paths_per_launch,
    heston_chain_ladder,
    heston_kernel_exotic_book_price,
    heston_kernel_exotic_lr_greeks,
    heston_kernel_exotic_price,
    heston_kernel_greeks,
    heston_kernel_price,
    make_chain_pricer,
    multi_asset_kernel_greeks,
    multi_asset_kernel_price,
)
from .server import PricingServer
from .types import ContractBatch
from .utils import ValidationError, setup_logging

__all__ = [
    "backtest",
    "benchmarks",
    "data",
    "greeks",
    "models",
    "ops",
    "optimize",
    "parallel",
    "risk",
    "surface",
    "utils",
    "BatesParams",
    "BatesPricer",
    "BinomialTree",
    "BlackScholesPricer",
    "CrankNicolsonSolver",
    "ContractBatch",
    "DupireLocalVol",
    "LocalVolKernelPricer",
    "LocalVolSurface",
    "HestonParams",
    "HestonPricer",
    "KouJumpDiffusion",
    "MCConfig",
    "MCMethod",
    "MCResult",
    "MertonJumpDiffusion",
    "MonteCarloMLSurrogate",
    "MonteCarloPricer",
    "PricingServer",
    "SABRModel",
    "SLVKernelPricer",
    "SLVModel",
    "ValidationError",
    "bates_price",
    "bs_greeks",
    "bs_greeks_ad",
    "bs_price",
    "bs_vega",
    "calibrate_bates",
    "calibrate_heston",
    "calibrate_heston_mc",
    "exotic_greeks",
    "exotic_kernel_ladder",
    "exotic_lr_greeks",
    "exotic_price",
    "gbm_mc_price",
    "gbm_mc_price_greeks",
    "gbm_mc_price_only",
    "gbm_paths_per_launch",
    "heston_chain_ladder",
    "heston_kernel_exotic_book_price",
    "heston_kernel_exotic_lr_greeks",
    "heston_kernel_exotic_price",
    "heston_kernel_greeks",
    "heston_kernel_price",
    "heston_price",
    "implied_volatility",
    "make_chain_pricer",
    "multi_asset_kernel_greeks",
    "multi_asset_kernel_price",
    "mc_greeks",
    "mc_price",
    "mc_price_control_variate",
    "mc_price_result",
    "setup_logging",
]
