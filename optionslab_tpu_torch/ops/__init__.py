"""Kernels and numerical primitives. Each kernel's module holds its plain
torch version beside the wrapper that launches the CUDA kernel."""

from .exotic_kernel import (
    autocall_lr_greeks,
    autocall_price,
    cliquet_lr_greeks,
    cliquet_price,
    exotic_book_lr_greeks,
    exotic_book_price,
    exotic_greeks,
    exotic_kernel_ladder,
    exotic_lr_greeks,
    exotic_price,
    range_accrual_lr_greeks,
    range_accrual_price,
)
from .heston_exotic_kernel import (
    heston_kernel_autocall_lr_greeks,
    heston_kernel_autocall_price,
    heston_kernel_cliquet_lr_greeks,
    heston_kernel_cliquet_price,
    heston_kernel_exotic_book_lr_greeks,
    heston_kernel_exotic_book_price,
    heston_kernel_exotic_lr_greeks,
    heston_kernel_exotic_price,
    heston_kernel_range_accrual_lr_greeks,
    heston_kernel_range_accrual_price,
)
from .heston_kernel import (
    heston_chain_ladder,
    heston_kernel_greeks,
    heston_kernel_price,
    make_chain_pricer,
)
from .local_vol_kernel import LocalVolKernelPricer, fit_sigma_polys, local_vol_kernel_price
from .multi_asset_kernel import multi_asset_kernel_greeks, multi_asset_kernel_price
from .optim import scan_adam, scan_adam_batched, scan_adam_cached
from .slv_kernel import SLVKernelPricer, fit_leverage_polys, slv_kernel_exotic_price
from .tridiag import tridiag_solve
from .gbm_kernel import (
    gbm_mc_price,
    gbm_mc_price_greeks,
    gbm_mc_price_only,
    gbm_paths_per_launch,
)

__all__ = [
    "autocall_lr_greeks",
    "autocall_price",
    "cliquet_lr_greeks",
    "cliquet_price",
    "exotic_book_lr_greeks",
    "exotic_book_price",
    "exotic_greeks",
    "exotic_kernel_ladder",
    "exotic_lr_greeks",
    "exotic_price",
    "fit_leverage_polys",
    "fit_sigma_polys",
    "gbm_mc_price",
    "gbm_mc_price_greeks",
    "gbm_mc_price_only",
    "gbm_paths_per_launch",
    "heston_chain_ladder",
    "heston_kernel_autocall_lr_greeks",
    "heston_kernel_autocall_price",
    "heston_kernel_cliquet_lr_greeks",
    "heston_kernel_cliquet_price",
    "heston_kernel_exotic_book_lr_greeks",
    "heston_kernel_exotic_book_price",
    "heston_kernel_exotic_lr_greeks",
    "heston_kernel_exotic_price",
    "heston_kernel_range_accrual_lr_greeks",
    "heston_kernel_range_accrual_price",
    "heston_kernel_greeks",
    "heston_kernel_price",
    "LocalVolKernelPricer",
    "local_vol_kernel_price",
    "make_chain_pricer",
    "multi_asset_kernel_greeks",
    "multi_asset_kernel_price",
    "range_accrual_lr_greeks",
    "range_accrual_price",
    "scan_adam",
    "scan_adam_batched",
    "scan_adam_cached",
    "SLVKernelPricer",
    "slv_kernel_exotic_price",
    "tridiag_solve",
]
