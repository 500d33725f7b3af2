"""Feature engineering for vol-surface models.

The port of ``optionslab_tpu/surface/features.py``: 7 features from 5 base
columns — moneyness S/K, log-moneyness, TTM, TTM², risk-free rate,
historical vol, and a rolling vol-skew (the deviation of the historical vol
from its 20-row rolling mean). Host numpy on any frame-like input (a pandas
DataFrame or a column table, ``data/_table.py``); the rolling mean is
pandas' ``rolling(20, min_periods=1).mean()`` written out (NaNs skipped).
"""

from __future__ import annotations

import numpy as np

from ..utils.exceptions import DataError
from .base import BASE_COLUMNS, FEATURE_COLUMNS

SKEW_WINDOW = 20


def _rolling_mean(x: np.ndarray, window: int) -> np.ndarray:
    """Trailing mean over ``window`` rows of the finite values, NaN where the
    window holds none."""
    ok = ~np.isnan(x)
    csum = np.concatenate([[0.0], np.cumsum(np.where(ok, x, 0.0))])
    ccnt = np.concatenate([[0], np.cumsum(ok)])
    hi = np.arange(1, len(x) + 1)
    lo = np.maximum(hi - window, 0)
    cnt = ccnt[hi] - ccnt[lo]
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(cnt > 0, (csum[hi] - csum[lo]) / cnt, np.nan)


def engineer_features(df, inplace: bool = False):
    """Base columns → the 7 model features. Requires BASE_COLUMNS."""
    missing = [c for c in BASE_COLUMNS if c not in df.columns]
    if missing:
        raise DataError(f"engineer_features: missing base columns {missing}")
    out = df if inplace else df.copy()
    s = np.asarray(out["underlying_price"], np.float64)
    k = np.asarray(out["strike_price"], np.float64)
    if np.any(k <= 0) or np.any(s <= 0):
        raise DataError("prices/strikes must be positive")
    out["moneyness"] = s / k
    out["log_moneyness"] = np.log(s / k)
    out["ttm_squared"] = np.asarray(out["time_to_maturity"]) ** 2
    hv = np.asarray(out["historical_volatility"], np.float64)
    skew = hv - _rolling_mean(hv, SKEW_WINDOW)
    out["volatility_skew"] = np.where(np.isnan(skew), 0.0, skew)
    return out


__all__ = ["engineer_features", "FEATURE_COLUMNS", "BASE_COLUMNS", "SKEW_WINDOW"]
