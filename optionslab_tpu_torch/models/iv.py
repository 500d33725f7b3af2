"""Implied volatility: a safeguarded Newton on tensors, a whole chain at once.

The port of ``optionslab_tpu/models/iv.py``. One fixed-count loop serves
every quote: each iterate keeps a live bisection bracket [lo, hi]; a Newton
step that leaves the bracket, or meets a tiny vega, falls back to the
bracket's midpoint elementwise (``torch.where``), so the loop has no
data-dependent control flow and never synchronises with the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import ContractBatch
from ..utils.config import EPS_TIME, as_tensors, input_device
from ..utils.exceptions import ArbitrageViolationError, ValidationError
from .black_scholes import bs_price, bs_vega

SIGMA_LO = 1e-4
SIGMA_HI = 10.0


def _no_arb_bounds(spot, strike, maturity, rate, cp, dividend):
    """European no-arbitrage price bounds."""
    df_r = torch.exp(-rate * maturity)
    df_q = torch.exp(-dividend * maturity)
    lower = torch.clamp_min(cp * (spot * df_q - strike * df_r), 0.0)
    upper = torch.where(cp > 0, spot * df_q, strike * df_r)
    return lower, upper


def implied_vol(price, spot, strike, maturity, rate, cp=1.0, dividend=0.0,
                n_iter: int = 64):
    """Implied vol for tensors of prices/contracts; NaN where no solution.

    Safeguarded Newton: carry (sigma, lo, hi); the Newton candidate is taken
    only inside the live bracket and with a healthy vega, else the bracket
    midpoint; the bracket tightens every iteration, so ``n_iter=64`` leaves
    a bracket far below float32 resolution. Follows the inputs' device and
    dtype: numbers, numpy arrays and lists alone give float32 on the card.
    """
    args = (price, spot, strike, maturity, rate, cp, dividend)
    price, spot, strike, maturity, rate, cp, dividend = torch.broadcast_tensors(
        *as_tensors(*args, device=input_device(*args)))
    lower, upper = _no_arb_bounds(spot, strike, maturity, rate, cp, dividend)
    valid = (price > lower + 1e-12) & (price < upper - 1e-12) & (maturity > EPS_TIME)

    lo = torch.full_like(price, SIGMA_LO)
    hi = torch.full_like(price, SIGMA_HI)
    sig0 = torch.sqrt(2.0 * torch.abs(torch.log(spot / strike) + (rate - dividend) * maturity)
                      / torch.clamp_min(maturity, EPS_TIME))  # Brenner–Subrahmanyam start
    sig = torch.clamp(torch.where(torch.isfinite(sig0) & (sig0 > 0.05), sig0, 0.2),
                      SIGMA_LO, SIGMA_HI)
    for _ in range(n_iter):
        fx = bs_price(spot, strike, maturity, rate, sig, cp, dividend) - price
        vega = bs_vega(spot, strike, maturity, rate, sig, dividend)
        lo = torch.where(fx < 0, sig, lo)  # price is increasing in sigma
        hi = torch.where(fx > 0, sig, hi)
        newton = sig - fx / torch.clamp_min(vega, 1e-12)
        use_newton = (vega > 1e-10) & (newton > lo) & (newton < hi)
        sig = torch.where(use_newton, newton, 0.5 * (lo + hi))
    return torch.where(valid, sig, torch.full_like(sig, float("nan")))


def implied_volatility(price, S, K, T, r, option_type="call", q=0.0, validate: bool = True,
                       device="cuda"):
    """The reference signature: Python numbers or arrays in, a tensor on
    ``device`` out; raises on arbitrage-violating inputs when ``validate``
    (checked on the host in float64, as the reference does)."""
    cp = 1.0 if str(option_type).lower() in ("call", "c", "1") else -1.0
    if validate:
        S_, K_, T_, r_, q_ = (np.asarray(v, np.float64) for v in (S, K, T, r, q))
        df_r, df_q = np.exp(-r_ * T_), np.exp(-q_ * T_)
        lower = np.maximum(cp * (S_ * df_q - K_ * df_r), 0.0)
        upper = np.where(cp > 0, S_ * df_q, K_ * df_r)
        if np.any(np.asarray(price) <= lower):
            raise ArbitrageViolationError(f"price {price} at/below no-arbitrage lower bound {lower}")
        if np.any(np.asarray(price) >= upper):
            raise ArbitrageViolationError(f"price {price} at/above no-arbitrage upper bound {upper}")
        if np.any(T_ <= 0):
            raise ValidationError("maturity must be positive for IV inversion")
    args = as_tensors(price, S, K, T, r, cp, q, device=device)
    return implied_vol(*args)


implied_volatility_vectorized = implied_vol


def iv_surface_from_prices(prices, spot, strikes, maturities, rate, cp=1.0, dividend=0.0):
    """(n_maturities, n_strikes) price grid → IV grid in one pass, on the
    device of ``prices`` (the card for a numpy or list grid)."""
    prices = torch.as_tensor(prices, device=input_device(prices))
    k = torch.as_tensor(strikes, device=prices.device)[None, :]
    t = torch.as_tensor(maturities, device=prices.device)[:, None]
    return implied_vol(prices, spot, k, t, rate, cp, dividend)


def iv_batch(batch: ContractBatch, prices) -> torch.Tensor:
    """ContractBatch protocol entry: invert the batch's prices to vols."""
    b = batch.broadcast()
    return implied_vol(prices, b.spot, b.strike, b.maturity, b.rate, b.cp, b.dividend)
