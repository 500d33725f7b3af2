"""Chain data: vendor-file loading and standardization (without pandas), the
synthetic chains, and the cached, rate-limited market-data client."""

from ._table import ColumnTable
from .loader import (
    OptionChainDataset,
    OptionChainLoader,
    load_option_data,
    standardize_columns,
)
from .market import (
    MarketDataClient,
    RateLimiter,
    TTLCache,
    calibrate_model_to_market,
    retry_with_backoff,
)
from .synthetic import (
    generate_synthetic_chain,
    generate_synthetic_smile,
    generate_synthetic_surface,
    synthetic_iv,
)

__all__ = [
    "ColumnTable",
    "OptionChainDataset",
    "OptionChainLoader",
    "load_option_data",
    "standardize_columns",
    "TTLCache",
    "RateLimiter",
    "retry_with_backoff",
    "MarketDataClient",
    "calibrate_model_to_market",
    "generate_synthetic_chain",
    "generate_synthetic_smile",
    "generate_synthetic_surface",
    "synthetic_iv",
]
