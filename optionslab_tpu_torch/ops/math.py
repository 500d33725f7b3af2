"""Numerical primitives shared by the pricers.

Branches are ``torch.where`` with safe operands on both sides, so gradients
never see NaN/inf from the untaken branch.
"""

from __future__ import annotations

import torch

from ..utils.config import EPS_TIME, EPS_VOL

SQRT_2PI = 2.5066282746310002


def norm_cdf(x: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtr(x)


def norm_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / SQRT_2PI


def norm_ppf(p: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtri(p)


def safe_div(num, den, fill=0.0):
    """num/den with den==0 mapped to ``fill`` and no NaN in gradients."""
    safe_den = torch.where(den == 0, 1.0, den)
    return torch.where(den == 0, fill, num / safe_den)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0."""
    return torch.sqrt(torch.clamp_min(x, 0.0))


def d1_d2(spot, strike, maturity, rate, vol, dividend=0.0):
    """Black–Scholes d1/d2 with the denominator clamped for T<=0 or vol<=0;
    the caller masks the degenerate region (see black_scholes)."""
    t = torch.clamp_min(maturity, EPS_TIME)
    v = torch.clamp_min(vol, EPS_VOL)
    sig_sqrt_t = v * torch.sqrt(t)
    d1 = (torch.log(spot / strike) + (rate - dividend + 0.5 * v * v) * t) / sig_sqrt_t
    d2 = d1 - sig_sqrt_t
    return d1, d2


def smooth_max(x: torch.Tensor, width) -> torch.Tensor:
    """Softplus-smoothed max(x, 0): width→0 recovers the kink."""
    w = torch.clamp_min(torch.as_tensor(width, dtype=x.dtype, device=x.device), 1e-12)
    return w * torch.logaddexp(x / w, torch.zeros_like(x))


def smooth_indicator(x: torch.Tensor, width) -> torch.Tensor:
    """Sigmoid-smoothed 1{x>0}."""
    w = torch.clamp_min(torch.as_tensor(width, dtype=x.dtype, device=x.device), 1e-12)
    return torch.reciprocal(1.0 + torch.exp(-x / w))
