"""Multi-asset exotics: correlated baskets, rainbows, spreads.

The port of ``optionslab_tpu/models/multi_asset.py``: a correlated-GBM scan
engine (the asset axis a small leading dimension, correlation through one
Cholesky product per step, memory O(assets × paths), never the path
history) on normals drawn from an explicit ``torch.Generator``, and the
closed forms that serve as oracles:

* Margrabe (1978) exchange option — exact for spread strikes K = 0;
* the geometric basket: a product of lognormals is lognormal, so the
  geometric-average basket option has a Black formula (exact);
* Kirk's approximation for K ≠ 0 spreads (documented approximate).

The engines compute in float32 on the generator's device and are
differentiable end to end (pathwise Greeks by ``torch.autograd``,
:func:`multi_asset_greeks`); the closed forms compute in float64 (tensor
arguments keep their dtype and device, so autograd runs through them).

A correlation matrix that is not positive definite (beyond the 1e-6
jitter) raises ``ValidationError`` (the reference returns NaN prices).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.math import norm_cdf
from ..utils.exceptions import ValidationError


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _chol(corr, n_assets: int, dev=None) -> torch.Tensor:
    """Cholesky factor of ``corr + 1e-6·I`` in float32 (the jitter handles a
    singular corr such as rho = 1; checking |rho| <= 1 is the caller's
    job). Raises ``ValidationError`` if the jittered matrix is not positive
    definite."""
    c = _f32(corr, dev)
    if c.shape != (n_assets, n_assets):
        raise ValidationError(f"corr must be ({n_assets},{n_assets}), got {tuple(c.shape)}")
    chol, info = torch.linalg.cholesky_ex(c + 1e-6 * torch.eye(n_assets, dtype=c.dtype,
                                                                device=c.device))
    if int(info) != 0:
        raise ValidationError("corr must be positive definite")
    return chol


def _drift_terms(spots, vols, dividends, dev):
    spots = _f32(spots, dev)
    vols = _f32(vols, dev)
    dividends = torch.broadcast_to(_f32(dividends, dev), spots.shape)
    return spots, vols, dividends


def multi_asset_terminal(spots, vols, corr, rate, dividends, maturity, generator, n_paths: int,
                         n_steps: int = 1, antithetic: bool = True) -> torch.Tensor:
    """Terminal spots (n_assets, n_paths) under correlated GBM.

    Terminal-only payoffs need just the sum of the per-step shocks, so any
    ``n_steps`` collapses to one normal draw per asset (exact, as in the
    single-asset engine); ``n_steps`` is accepted for API symmetry."""
    dev = generator.device
    spots, vols, dividends = _drift_terms(spots, vols, dividends, dev)
    d = spots.shape[0]
    chol = _chol(corr, d, dev)
    half = n_paths // 2 if antithetic else n_paths
    z = torch.randn((d, half), generator=generator, dtype=torch.float32, device=dev)
    if antithetic:
        z = torch.cat([z, -z], dim=1)
    zc = chol @ z
    t = torch.as_tensor(maturity, dtype=torch.float32, device=dev)
    drift = (rate - dividends - 0.5 * vols**2) * t
    return spots[:, None] * torch.exp(drift[:, None] + (vols * torch.sqrt(t))[:, None] * zc)


def _disc_mean_stderr(pay, rate, maturity):
    df = math.exp(-float(rate) * float(maturity))
    n = pay.shape[-1]
    return df * pay.mean(), df * pay.std(correction=1) / math.sqrt(n)


def basket_price(spots, weights, strike, maturity, rate, vols, corr, generator, cp: float = 1.0,
                 dividends=0.0, n_paths: int = 200_000, kind: str = "arithmetic",
                 return_stderr: bool = False):
    """Weighted-basket option on the terminal basket level.

    ``kind="arithmetic"``: B = Σ w_i S_i(T) (no closed form — MC).
    ``kind="geometric"``:  B = Π S_i(T)^{w_i} (lognormal — the exact closed
    form is :func:`geometric_basket_closed_form`, kept as oracle).
    """
    if kind not in ("arithmetic", "geometric"):
        raise ValidationError(f"kind must be arithmetic|geometric, got {kind!r}")
    terminal = multi_asset_terminal(spots, vols, corr, rate, dividends, maturity, generator,
                                    n_paths)
    w = _f32(weights, terminal.device)[:, None]
    if kind == "arithmetic":
        basket = (w * terminal).sum(dim=0)
    else:
        basket = torch.exp((w * torch.log(terminal)).sum(dim=0))
    pay = torch.clamp_min(cp * (basket - strike), 0.0)
    price, se = _disc_mean_stderr(pay, rate, maturity)
    return (price, se) if return_stderr else price


def rainbow_price(spots, strike, maturity, rate, vols, corr, generator, cp: float = 1.0,
                  dividends=0.0, n_paths: int = 200_000, flavor: str = "best_of",
                  return_stderr: bool = False):
    """Rainbow option: call/put on the best/worst terminal asset.

    ``flavor``: "best_of" → max_i S_i(T); "worst_of" → min_i S_i(T)."""
    if flavor not in ("best_of", "worst_of"):
        raise ValidationError(f"flavor must be best_of|worst_of, got {flavor!r}")
    terminal = multi_asset_terminal(spots, vols, corr, rate, dividends, maturity, generator,
                                    n_paths)
    level = terminal.amax(dim=0) if flavor == "best_of" else terminal.amin(dim=0)
    pay = torch.clamp_min(cp * (level - strike), 0.0)
    price, se = _disc_mean_stderr(pay, rate, maturity)
    return (price, se) if return_stderr else price


def spread_price(spot1, spot2, strike, maturity, rate, vol1, vol2, rho, generator,
                 cp: float = 1.0, div1: float = 0.0, div2: float = 0.0, n_paths: int = 200_000,
                 return_stderr: bool = False):
    """Spread option on S1(T) − S2(T) − K (Margrabe-exact at K = 0)."""
    corr = [[1.0, float(rho)], [float(rho), 1.0]]
    dev = generator.device
    terminal = multi_asset_terminal(torch.stack([_f32(spot1, dev), _f32(spot2, dev)]),
                                    torch.stack([_f32(vol1, dev), _f32(vol2, dev)]), corr, rate,
                                    [div1, div2], maturity, generator, n_paths)
    pay = torch.clamp_min(cp * (terminal[0] - terminal[1] - strike), 0.0)
    price, se = _disc_mean_stderr(pay, rate, maturity)
    return (price, se) if return_stderr else price


# ---------------------------------------------------------------------------
# Closed forms (oracles + fast paths), float64
# ---------------------------------------------------------------------------
def _f64(x) -> torch.Tensor:
    """A tensor argument as it is; anything else as a float64 tensor."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float64))


def margrabe_price(spot1, spot2, maturity, vol1, vol2, rho, div1: float = 0.0,
                   div2: float = 0.0):
    """Margrabe (1978) exchange option E[(S1(T) − S2(T))⁺] discounted —
    exact for any correlation (the rate drops out)."""
    spot1, spot2, maturity, vol1, vol2, rho, div1, div2 = map(
        _f64, (spot1, spot2, maturity, vol1, vol2, rho, div1, div2))
    sig = torch.sqrt(torch.clamp_min(vol1**2 - 2.0 * rho * vol1 * vol2 + vol2**2, 1e-12))
    st = sig * torch.sqrt(maturity)
    f1 = spot1 * torch.exp(-div1 * maturity)
    f2 = spot2 * torch.exp(-div2 * maturity)
    d1 = (torch.log(f1 / f2) + 0.5 * st * st) / st
    return f1 * norm_cdf(d1) - f2 * norm_cdf(d1 - st)


def geometric_basket_closed_form(spots, weights, strike, maturity, rate, vols, corr,
                                 cp: float = 1.0, dividends=0.0):
    """Black formula on the lognormal geometric basket (exact oracle).

    ln B(T) ~ Normal with
      μ_B = Σ w_i (ln S_i + (r − q_i − σ_i²/2)T),  σ_B² = wᵀ Σ w · T.
    """
    w, spots, vols, corr, strike, maturity, rate = map(
        _f64, (weights, spots, vols, corr, strike, maturity, rate))
    dividends = torch.broadcast_to(_f64(dividends), spots.shape)
    cov = corr * vols[:, None] * vols[None, :]
    var_b = (w @ (cov @ w)) * maturity
    sd = torch.sqrt(torch.clamp_min(var_b, 1e-12))
    mu = torch.sum(w * (torch.log(spots) + (rate - dividends - 0.5 * vols**2) * maturity))
    fwd = torch.exp(mu + 0.5 * var_b)
    d1 = (mu + var_b - torch.log(strike)) / sd
    d2 = d1 - sd
    df = torch.exp(-rate * maturity)
    return df * cp * (fwd * norm_cdf(cp * d1) - strike * norm_cdf(cp * d2))


def kirk_spread_approx(spot1, spot2, strike, maturity, rate, vol1, vol2, rho, div1: float = 0.0,
                       div2: float = 0.0):
    """Kirk (1995) approximation for K ≠ 0 spread calls (documented
    approximate; exact at K = 0, where it reduces to Margrabe)."""
    spot1, spot2, strike, maturity, rate, vol1, vol2, rho, div1, div2 = map(
        _f64, (spot1, spot2, strike, maturity, rate, vol1, vol2, rho, div1, div2))
    f1 = spot1 * torch.exp((rate - div1) * maturity)
    f2 = spot2 * torch.exp((rate - div2) * maturity)
    fk = f2 / (f2 + strike)
    sig = torch.sqrt(torch.clamp_min(vol1**2 - 2.0 * rho * vol1 * vol2 * fk + (vol2 * fk) ** 2,
                                     1e-12))
    st = sig * torch.sqrt(maturity)
    d1 = (torch.log(f1 / (f2 + strike)) + 0.5 * st * st) / st
    df = torch.exp(-rate * maturity)
    return df * (f1 * norm_cdf(d1) - (f2 + strike) * norm_cdf(d1 - st))


# ---------------------------------------------------------------------------
# Path-dependent: basket Asian (running average of the basket level)
# ---------------------------------------------------------------------------
def basket_asian_price(spots, weights, strike, maturity, rate, vols, corr, generator,
                       cp: float = 1.0, dividends=0.0, n_paths: int = 100_000,
                       n_steps: int = 64, return_stderr: bool = False):
    """Arithmetic Asian on the arithmetic basket: the scan carries the
    log-spots (d, paths) and the running basket sum; O(d × paths) memory."""
    dev = generator.device
    spots, vols, dividends = _drift_terms(spots, vols, dividends, dev)
    w = _f32(weights, dev)[:, None]
    d = spots.shape[0]
    chol = _chol(corr, d, dev)
    half = n_paths // 2
    dt = float(maturity) / n_steps
    drift = ((rate - dividends - 0.5 * vols**2) * dt)[:, None]
    sig_dt = (vols * math.sqrt(dt))[:, None]
    log_s = torch.zeros((d, 2 * half), dtype=torch.float32, device=dev)
    acc = torch.zeros(2 * half, dtype=torch.float32, device=dev)
    for _ in range(n_steps):
        z = torch.randn((d, half), generator=generator, dtype=torch.float32, device=dev)
        log_s = log_s + drift + sig_dt * (chol @ torch.cat([z, -z], dim=1))
        acc = acc + (w * spots[:, None] * torch.exp(log_s)).sum(dim=0)
    pay = torch.clamp_min(cp * (acc / n_steps - strike), 0.0)
    price, se = _disc_mean_stderr(pay, rate, maturity)
    return (price, se) if return_stderr else price


def multi_asset_greeks(price_fn, spots, vols, **kwargs) -> dict:
    """Per-asset delta and vega vectors of any multi-asset pricer by
    autograd. ``price_fn(spots, vols, **kwargs) -> price`` is built on the
    differentiable engine (float32 tensors in, a scalar tensor out)."""
    spots, vols = (_f32(x, None).detach().clone().requires_grad_(True) for x in (spots, vols))
    with torch.enable_grad():
        price = price_fn(spots, vols, **kwargs)
        d_s, d_v = torch.autograd.grad(price, (spots, vols))
    return {"price": price.detach(), "delta": d_s, "vega": d_v}
