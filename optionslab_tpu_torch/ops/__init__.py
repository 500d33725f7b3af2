"""Kernels and numerical primitives. Each kernel's module holds its plain
torch version beside the wrapper that launches the CUDA kernel."""

from .gbm_kernel import (
    gbm_mc_price,
    gbm_mc_price_greeks,
    gbm_mc_price_only,
    gbm_paths_per_launch,
)

__all__ = ["gbm_mc_price", "gbm_mc_price_greeks", "gbm_mc_price_only", "gbm_paths_per_launch"]
