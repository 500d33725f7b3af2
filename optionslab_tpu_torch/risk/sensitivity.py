"""Model-agnostic sensitivity analysis on frame-priced portfolios.

The port of ``optionslab_tpu/risk/sensitivity.py``: finite-difference
delta, gamma and vega with relative or absolute bumps through a black-box
``price_fn(df)``. The frame is duck-typed as in :mod:`.stress`; the prices
may be tensors, arrays or lists, and the Greeks come back as numpy arrays.
The autograd engine (``optionslab_tpu_torch.greeks``) supersedes this for
differentiable pricers.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ._frames import host


def _bump(df, column: str, h: float, relative: bool):
    up = df.copy()
    dn = df.copy()
    if relative:
        up[column] = up[column] * (1.0 + h)
        dn[column] = dn[column] * (1.0 - h)
        step = host(df[column]) * h
    else:
        up[column] = up[column] + h
        dn[column] = dn[column] - h
        step = np.full(host(df[column]).shape, h)
    return up, dn, step


class SensitivityAnalysis:
    def __init__(self, price_fn: Callable, spot_col: str = "underlying_price",
                 vol_col: str = "historical_volatility"):
        self.price_fn = price_fn
        self.spot_col = spot_col
        self.vol_col = vol_col

    def _p(self, df) -> np.ndarray:
        return host(self.price_fn(df))

    def compute_delta(self, df, h: float = 0.01, relative: bool = True):
        up, dn, step = _bump(df, self.spot_col, h, relative)
        return (self._p(up) - self._p(dn)) / (2.0 * step)

    def compute_gamma(self, df, h: float = 0.01, relative: bool = True):
        up, dn, step = _bump(df, self.spot_col, h, relative)
        return (self._p(up) - 2.0 * self._p(df) + self._p(dn)) / (step**2)

    def compute_vega(self, df, h: float = 0.01, relative: bool = False):
        up, dn, step = _bump(df, self.vol_col, h, relative)
        return (self._p(up) - self._p(dn)) / (2.0 * step)

    def compute_all(self, df, h: float = 0.01):
        return {
            "delta": self.compute_delta(df, h),
            "gamma": self.compute_gamma(df, h),
            "vega": self.compute_vega(df, h),
        }
