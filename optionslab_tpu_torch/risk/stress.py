"""Scenario stress testing over a market frame.

The port of ``optionslab_tpu/risk/stress.py``: ``StressScenario`` (field,
magnitude, relative/absolute) and ``StressTester.run_scenarios``, which
reprices a market frame per scenario and reports total/mean/median/worst
P&L and the cross-instrument ES95. The frame is duck-typed (``columns``,
``copy()``, item get/set), so a pandas DataFrame or any frame-like object
works; the report is a DataFrame when pandas is installed, else its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from ..utils.exceptions import ValidationError
from ._frames import host, report


@dataclasses.dataclass(frozen=True)
class StressScenario:
    name: str
    field: str
    magnitude: float
    relative: bool = True  # True: multiply by (1+magnitude); False: add

    def apply(self, df):
        if self.field not in df.columns:
            raise ValidationError(f"scenario field {self.field!r} not in market data")
        out = df.copy()
        if self.relative:
            out[self.field] = out[self.field] * (1.0 + self.magnitude)
        else:
            out[self.field] = out[self.field] + self.magnitude
        return out


class StressTester:
    """``price_fn(df) -> instrument values`` (tensor, array or list) is
    revalued per scenario; the report aggregates P&L statistics."""

    def __init__(self, price_fn: Callable):
        self.price_fn = price_fn

    def run_scenarios(self, market_df, scenarios: Sequence[StressScenario]):
        base = host(self.price_fn(market_df))
        rows = []
        for sc in scenarios:
            pnl = host(self.price_fn(sc.apply(market_df))) - base
            tail = np.sort(pnl)[: max(1, int(np.ceil(0.05 * pnl.size)))]
            rows.append({
                "scenario": sc.name,
                "field": sc.field,
                "magnitude": sc.magnitude,
                "total_pnl": float(pnl.sum()),
                "mean_pnl": float(pnl.mean()),
                "median_pnl": float(np.median(pnl)),
                "worst_pnl": float(pnl.min()),
                "es95": float(-tail.mean()),
            })
        return report(rows)
