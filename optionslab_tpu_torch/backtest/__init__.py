from .engine import (
    BacktestEngine,
    BacktestResult,
    realized_vol,
    realized_vs_implied,
    run_delta_hedge_backtest,
)

__all__ = [
    "BacktestEngine",
    "BacktestResult",
    "realized_vol",
    "realized_vs_implied",
    "run_delta_hedge_backtest",
]
