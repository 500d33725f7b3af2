"""Value-at-Risk: device-side quantiles over simulated P&L.

The port of ``optionslab_tpu/risk/var.py``. Conventions: P&L positive =
profit; VaR/ES are returned as POSITIVE losses. Historical VaR/ES
(empirical quantile + tail mean), parametric normal and lognormal, Monte
Carlo VaR on the GBM terminal, delta-normal multi-asset VaR wᵀΣw, option
VaR by full revaluation through a vectorized pricer ``fn(spots) -> values``
(one call for the whole scenario set), additive stress shifts, and the
Euler allocations of VaR and ES.

Every function runs on the device of its tensor arguments (the card when
they are numbers or arrays) and returns 0-d tensors. The JAX ``key``
arguments of :func:`monte_carlo_var` and :func:`option_var` are
``torch.Generator``s here, whose device is the device of the draw.
Quantiles interpolate linearly between order statistics, as
``jnp.quantile`` and ``torch.quantile`` do; the port sorts itself because
``torch.quantile`` refuses inputs above 2^24 elements.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.math import norm_pdf, norm_ppf
from ..utils.config import as_tensors, input_device, resolve_dtype
from ..utils.exceptions import ValidationError

__all__ = ["VaRAnalyzer", "historical_var", "historical_es", "parametric_var", "parametric_es",
           "lognormal_var", "monte_carlo_var", "delta_normal_var", "option_var", "stressed_var",
           "component_var", "component_es"]


def _check_confidence(confidence: float):
    if not 0.5 < confidence < 1.0:
        raise ValidationError(f"confidence must be in (0.5, 1), got {confidence}")


def _tensors(*args) -> list[torch.Tensor]:
    return as_tensors(*args, dtype=resolve_dtype(*args), device=input_device(*args))


def quantiles(x: torch.Tensor, qs, dim: int = 0) -> torch.Tensor:
    """The quantiles ``qs`` of ``x`` along ``dim`` from one sort, stacked on
    a new leading axis; each linear between the order statistics at floor
    and ceil of q·(n − 1)."""
    n = x.shape[dim]
    xs = torch.sort(x.movedim(dim, -1).contiguous(), dim=-1).values
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(math.floor(pos))
        w = pos - lo
        out.append(xs[..., lo] * (1.0 - w) + xs[..., min(lo + 1, n - 1)] * w)
    return torch.stack(out)


def quantile(x: torch.Tensor, q: float, dim: int = 0) -> torch.Tensor:
    """The ``q`` quantile of ``x`` along ``dim`` (see :func:`quantiles`)."""
    return quantiles(x, (q,), dim)[0]


# ---------------------------------------------------------------------------
# Historical
# ---------------------------------------------------------------------------
def historical_var(pnl, confidence: float = 0.95):
    """Positive loss at the (1-confidence) quantile of the P&L sample."""
    _check_confidence(confidence)
    (pnl,) = _tensors(pnl)
    return -quantile(pnl.reshape(-1), 1.0 - confidence)


def historical_es(pnl, confidence: float = 0.95):
    """Mean loss beyond VaR (positive)."""
    _check_confidence(confidence)
    (pnl,) = _tensors(pnl)
    pnl = pnl.reshape(-1)
    tail = pnl <= quantile(pnl, 1.0 - confidence)
    return -torch.where(tail, pnl, 0.0).sum() / tail.sum()


# ---------------------------------------------------------------------------
# Parametric
# ---------------------------------------------------------------------------
def parametric_var(mu, sigma, confidence: float = 0.95, horizon: float = 1.0):
    """Normal P&L: VaR = -(μ·h - z·σ·√h)."""
    _check_confidence(confidence)
    mu, sigma, c = _tensors(mu, sigma, confidence)
    z = norm_ppf(c)
    return -(mu * horizon - z * sigma * math.sqrt(horizon))


def parametric_es(mu, sigma, confidence: float = 0.95, horizon: float = 1.0):
    """Normal ES = -(μ·h) + σ√h·φ(z)/(1-c)."""
    _check_confidence(confidence)
    mu, sigma, c = _tensors(mu, sigma, confidence)
    z = norm_ppf(c)
    return -(mu * horizon) + sigma * math.sqrt(horizon) * norm_pdf(z) / (1.0 - c)


def lognormal_var(value, mu, sigma, confidence: float = 0.95, horizon: float = 1.0):
    """Loss quantile of V·(exp(X)-1), X ~ N((μ-σ²/2)h, σ²h)."""
    _check_confidence(confidence)
    value, mu, sigma, c = _tensors(value, mu, sigma, confidence)
    z = norm_ppf(1.0 - c)
    drift = (mu - 0.5 * sigma**2) * horizon
    ret_q = torch.exp(drift + sigma * math.sqrt(horizon) * z) - 1.0
    return -value * ret_q


# ---------------------------------------------------------------------------
# Monte Carlo
# ---------------------------------------------------------------------------
def _gbm_growth(generator: torch.Generator, n_paths: int, mu, sigma, horizon, dtype):
    z = torch.randn(n_paths, generator=generator, dtype=dtype, device=generator.device)
    return torch.exp((mu - 0.5 * sigma**2) * horizon + sigma * math.sqrt(horizon) * z)


def _var_es(pnl, confidence: float, return_es: bool):
    var = historical_var(pnl, confidence)
    if return_es:
        return var, historical_es(pnl, confidence)
    return var


def monte_carlo_var(value, mu, sigma, generator: torch.Generator, confidence: float = 0.95,
                    horizon: float = 1.0, n_paths: int = 100_000, return_es: bool = False):
    """GBM revaluation VaR: ``n_paths`` normals from ``generator`` on its
    device."""
    _check_confidence(confidence)
    dtype = resolve_dtype(value, mu, sigma)
    value, mu, sigma = as_tensors(value, mu, sigma, dtype=dtype, device=generator.device)
    pnl = value * (_gbm_growth(generator, n_paths, mu, sigma, horizon, dtype) - 1.0)
    return _var_es(pnl, confidence, return_es)


# ---------------------------------------------------------------------------
# Delta-normal portfolio
# ---------------------------------------------------------------------------
def delta_normal_var(positions, cov, confidence: float = 0.95, horizon: float = 1.0):
    """Multi-asset delta-normal VaR = z·√(wᵀΣw)·√h.

    ``positions``: currency exposures per asset; ``cov``: per-period return
    covariance. The quadratic form is summed elementwise, so no matmul (and
    no TF32) touches it."""
    _check_confidence(confidence)
    w, cov, c = _tensors(positions, cov, confidence)
    w = w.reshape(-1)
    if tuple(cov.shape) != (w.numel(), w.numel()):
        raise ValidationError(f"cov shape {tuple(cov.shape)} incompatible with {w.numel()} "
                              "positions")
    port_sigma = torch.sqrt(torch.clamp_min((w[:, None] * cov * w[None, :]).sum(), 0.0))
    return norm_ppf(c) * port_sigma * math.sqrt(horizon)


# ---------------------------------------------------------------------------
# Option-aware VaR (full revaluation through an injected pricer)
# ---------------------------------------------------------------------------
def option_var(pricer_fn, spot, mu, sigma, generator: torch.Generator,
               confidence: float = 0.95, horizon: float = 1.0 / 252.0, n_paths: int = 50_000,
               return_es: bool = False):
    """Full-revaluation option VaR: simulate spots over the horizon on the
    generator's device, reprice the book with ``pricer_fn(spots) -> values``
    in one call."""
    _check_confidence(confidence)
    dtype = resolve_dtype(spot, mu, sigma)
    spot, mu, sigma = as_tensors(spot, mu, sigma, dtype=dtype, device=generator.device)
    spots = spot * _gbm_growth(generator, n_paths, mu, sigma, horizon, dtype)
    v0 = pricer_fn(spot.reshape(1))[0]
    pnl = pricer_fn(spots) - v0
    return _var_es(pnl, confidence, return_es)


# ---------------------------------------------------------------------------
# Stress shifts
# ---------------------------------------------------------------------------
def stressed_var(base_var, shift_pct):
    """Additive stress on a computed VaR."""
    base_var, shift_pct = _tensors(base_var, shift_pct)
    return base_var * (1.0 + shift_pct)


class VaRAnalyzer:
    """Object adapter mirroring the reference's ``VaRAnalyzer``, on
    ``device`` (numbers and arrays go there; a tensor argument keeps its
    own device). Each Monte Carlo call draws from a fresh generator seeded
    with ``seed``, as the reference reuses one key."""

    def __init__(self, confidence: float = 0.95, horizon: float = 1.0, seed: int = 0,
                 device="cuda"):
        _check_confidence(confidence)
        self.confidence = confidence
        self.horizon = horizon
        self.seed = seed
        self.device = device

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _on(self, *xs) -> list[torch.Tensor]:
        return as_tensors(*xs, dtype=resolve_dtype(*xs),
                          device=input_device(*xs, default=self.device))

    def historical(self, pnl):
        return float(historical_var(*self._on(pnl), self.confidence))

    def historical_expected_shortfall(self, pnl):
        return float(historical_es(*self._on(pnl), self.confidence))

    def parametric(self, mu, sigma):
        return float(parametric_var(*self._on(mu, sigma), self.confidence, self.horizon))

    def parametric_lognormal(self, value, mu, sigma):
        return float(lognormal_var(*self._on(value, mu, sigma), self.confidence, self.horizon))

    def monte_carlo(self, value, mu, sigma, n_paths: int = 100_000):
        return float(monte_carlo_var(value, mu, sigma, self._generator(), self.confidence,
                                     self.horizon, n_paths))

    def delta_normal(self, positions, cov):
        return float(delta_normal_var(*self._on(positions, cov), self.confidence, self.horizon))

    def option_portfolio(self, pricer_fn, spot, mu, sigma, n_paths: int = 50_000):
        return float(option_var(pricer_fn, spot, mu, sigma, self._generator(), self.confidence,
                                min(self.horizon, 1.0) / 252.0 if self.horizon >= 1.0
                                else self.horizon, n_paths))

    def stress_table(self, base_var, shifts):
        (base,) = self._on(base_var)
        return {float(s): float(stressed_var(base, float(s))) for s in np.asarray(shifts)}


# ---------------------------------------------------------------------------
# Component (Euler) allocation
# ---------------------------------------------------------------------------
def _components(pnl_components) -> torch.Tensor:
    (x,) = _tensors(pnl_components)
    if x.dim() != 2:
        raise ValidationError("pnl_components must be (n_obs, n_components)")
    return x


def _allocation(comp: torch.Tensor, key: str) -> dict:
    total = comp.sum()
    return {key: total, "components": comp,
            "pct": comp / torch.where(total == 0.0, 1.0, total)}


def component_var(pnl_components, confidence: float = 0.95, window: int = 0):
    """Euler allocation of historical VaR to P&L components.

    ``pnl_components``: (n_obs, n_components); the portfolio P&L is the row
    sum. Component i is −E[X_i | X_p in the VaR window], which sums to the
    total. ``window``: the number of tail observations averaged (0 = the
    single quantile observation). Returns dict(total_var, components, pct).
    """
    _check_confidence(confidence)
    x = _components(pnl_components)
    port = x.sum(dim=1)
    n = port.shape[0]
    k = max(int(np.floor((1.0 - confidence) * n)), 0)
    order = torch.argsort(port, stable=True)
    if window <= 0:
        sel = order[k:k + 1]
    else:
        size = min(window, n)
        lo = min(max(k - window // 2, 0), n - size)  # lax.dynamic_slice clamps the start
        sel = order[lo:lo + size]
    return _allocation(-x[sel, :].mean(dim=0), "total_var")


def component_es(pnl_components, confidence: float = 0.95):
    """Euler allocation of historical EXPECTED SHORTFALL: component i gets
    −E[X_i | X_p ≤ VaR_p], summing to the total ES."""
    _check_confidence(confidence)
    x = _components(pnl_components)
    port = x.sum(dim=1)
    w = (port <= quantile(port, 1.0 - confidence)).to(x.dtype)
    denom = torch.clamp_min(w.sum(), 1.0)
    return _allocation(-(x * w[:, None]).sum(dim=0) / denom, "total_es")
