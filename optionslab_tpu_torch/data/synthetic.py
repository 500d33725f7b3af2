"""Synthetic option-chain and smile generation — the offline data source.

The port of ``optionslab_tpu/data/synthetic.py``: the same numpy
``default_rng`` draws in the same order, so a seed gives the reference's
chain; the chain's option prices come from the port's Black–Scholes in
float64 on ``device``. Ground truth is an SVI-style parametric surface, so
tests can measure a model's error against a known truth.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.black_scholes import bs_price
from ._table import ColumnTable, to_frame


def synthetic_iv(log_moneyness, maturity, base_vol=0.2, skew=-0.1, smile=0.15,
                 term_slope=0.03):
    """Parametric IV: σ(k, T) = base + skew·k + smile·k² + term·√T, floored."""
    k = np.asarray(log_moneyness, np.float64)
    t = np.asarray(maturity, np.float64)
    iv = base_vol + skew * k + smile * k * k + term_slope * np.sqrt(t)
    return np.maximum(iv, 0.03)


def generate_synthetic_smile(n_strikes: int = 21, maturity: float = 0.5,
                             spot: float = 100.0, base_vol: float = 0.2,
                             skew: float = -0.1, smile: float = 0.15,
                             noise: float = 0.0, seed: int = 0):
    """(log_strikes, vols) for one maturity slice."""
    rng = np.random.default_rng(seed)
    k = np.linspace(-0.4, 0.4, n_strikes)
    iv = synthetic_iv(k, maturity, base_vol, skew, smile)
    if noise > 0:
        iv = iv + rng.normal(0.0, noise, iv.shape)
    del spot
    return k, np.maximum(iv, 0.02)


def generate_synthetic_surface(n_strikes: int = 21, n_maturities: int = 6,
                               spot: float = 100.0, noise: float = 0.0, seed: int = 0):
    """(log_strikes, maturities, iv_grid (n_T, n_K))."""
    rng = np.random.default_rng(seed)
    k = np.linspace(-0.4, 0.4, n_strikes)
    t = np.linspace(0.1, 2.0, n_maturities)
    iv = synthetic_iv(k[None, :], t[:, None])
    if noise > 0:
        iv = iv + rng.normal(0.0, noise, iv.shape)
    del spot
    return k, t, np.maximum(iv, 0.02)


def generate_synthetic_chain(n_rows: int = 500, spot: float = 100.0,
                             rate: float = 0.03, noise: float = 0.004,
                             seed: int = 0,
                             moneyness_range: tuple = (-0.35, 0.35),
                             ttm_range: tuple = (0.05, 2.0), device="cuda"):
    """A chain frame with the 5 base columns + implied_volatility + option
    price: a pandas DataFrame where pandas is installed, else a column table
    (``data/_table.py``). The prices are Black–Scholes in float64 on
    ``device``."""
    rng = np.random.default_rng(seed)
    strikes = spot * np.exp(rng.uniform(*moneyness_range, n_rows))
    ttm = rng.uniform(*ttm_range, n_rows)
    k = np.log(spot / strikes)
    iv = synthetic_iv(-k, ttm) + rng.normal(0.0, noise, n_rows)
    iv = np.maximum(iv, 0.03)
    cp = rng.choice([1.0, -1.0], n_rows)
    f64 = dict(dtype=torch.float64, device=device)
    price = bs_price(torch.tensor(float(spot), **f64), torch.tensor(strikes, **f64),
                     torch.tensor(ttm, **f64), torch.tensor(float(rate), **f64),
                     torch.tensor(iv, **f64), torch.tensor(cp, **f64),
                     torch.tensor(0.0, **f64)).cpu().numpy()
    hist_vol = 0.2 + 0.02 * rng.standard_normal(n_rows)
    return to_frame(ColumnTable({
        "underlying_price": np.full(n_rows, float(spot)),
        "strike_price": strikes,
        "time_to_maturity": ttm,
        "risk_free_rate": np.full(n_rows, float(rate)),
        "historical_volatility": np.abs(hist_vol),
        "implied_volatility": iv,
        "option_type": np.where(cp > 0, "call", "put").astype(object),
        "option_price": price,
    }))
