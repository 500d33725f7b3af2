"""SABR: Hagan (2002) lognormal implied vol, Black-76 pricing, calibration.

The port of ``optionslab_tpu/models/sabr.py``. The ATM branch is a
``torch.where`` over a series for z/x(z), so one expression serves a whole
smile and autograd flows through it; :func:`calibrate_sabr` fits (α, ρ, ν)
with β fixed by Adam (``ops/optim.scan_adam_cached``) on transformed
parameters (α > 0 and ν > 0 by softplus, ρ ∈ (−1, 1) by tanh).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.math import norm_cdf
from ..utils.config import EPS_TIME, as_tensors, input_device
from ..utils.exceptions import CalibrationError, ValidationError
from .heston import _softplus

FIELDS = ("alpha", "beta", "rho", "nu")


@dataclasses.dataclass(frozen=True)
class SABRParams:
    alpha: torch.Tensor  # ATM vol level
    beta: torch.Tensor  # CEV exponent (usually fixed)
    rho: torch.Tensor  # spot/vol correlation
    nu: torch.Tensor  # vol of vol

    @classmethod
    def make(cls, alpha=0.2, beta=0.5, rho=-0.3, nu=0.4, dtype=torch.float32, device=None):
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (alpha, beta, rho, nu)))

    @classmethod
    def from_numpy(cls, fields, device=None) -> "SABRParams":
        """Parameters from numpy arrays (or numbers) keyed by field name,
        keeping their dtype: the JAX package's ``SABRParams`` carried across."""
        return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device) for k in FIELDS})

    def validate(self):
        a, b, r, n = (float(torch.as_tensor(getattr(self, f)).detach().reshape(-1)[0])
                      for f in FIELDS)
        if a <= 0 or n < 0:
            raise ValidationError(f"alpha must be > 0 and nu >= 0: alpha={a}, nu={n}")
        if not 0.0 <= b <= 1.0:
            raise ValidationError(f"beta must be in [0,1]: {b}")
        if not -1.0 < r < 1.0:
            raise ValidationError(f"rho must be in (-1,1): {r}")


def sabr_implied_vol(forward, strike, maturity, params: SABRParams):
    """Hagan et al. (2002) lognormal implied vol, branch-free: z/x(z) takes its
    Taylor series 1 − ρz/2 + (3ρ² − 2)z²/12 for |z| < 1e-4 (the ATM limit)."""
    f, k, t, _ = as_tensors(forward, strike, maturity, params.alpha)
    f, k = torch.broadcast_tensors(f, k)
    t = torch.clamp_min(t, EPS_TIME)
    a, b, rho, nu = params.alpha, params.beta, params.rho, params.nu

    logfk = torch.log(f / k)
    fk_mid = (f * k) ** ((1.0 - b) / 2.0)
    one_m_b = 1.0 - b

    z = (nu / torch.clamp_min(a, 1e-12)) * fk_mid * logfk
    sqrt_term = torch.sqrt(torch.clamp_min(1.0 - 2.0 * rho * z + z * z, 1e-12))
    x_of_z = torch.log(torch.clamp_min((sqrt_term + z - rho) / (1.0 - rho), 1e-12))
    small = torch.abs(z) < 1e-4
    z_safe = torch.where(small, 1.0, z)
    ratio_exact = z_safe / torch.where(small, 1.0, x_of_z)
    ratio_series = 1.0 - 0.5 * rho * z + (3.0 * rho * rho - 2.0) / 12.0 * z * z
    ratio = torch.where(small, ratio_series, ratio_exact)

    denom = fk_mid * (1.0 + one_m_b**2 / 24.0 * logfk**2 + one_m_b**4 / 1920.0 * logfk**4)
    correction = 1.0 + t * (one_m_b**2 / 24.0 * a * a / fk_mid**2
                            + 0.25 * rho * b * nu * a / fk_mid
                            + (2.0 - 3.0 * rho * rho) / 24.0 * nu * nu)
    return (a / denom) * ratio * correction


def sabr_atm_vol(forward, maturity, params: SABRParams):
    """ATM implied vol."""
    return sabr_implied_vol(forward, forward, maturity, params)


def sabr_smile(forward, strikes, maturity, params: SABRParams):
    """The vol smile over a strike grid."""
    return sabr_implied_vol(forward, strikes, maturity, params)


def black76_price(forward, strike, maturity, rate, vol, cp=1.0):
    """Black-76 on forwards."""
    forward, strike, maturity, rate, vol, cp = as_tensors(forward, strike, maturity, rate, vol,
                                                          cp)
    t = torch.clamp_min(maturity, EPS_TIME)
    v = torch.clamp_min(vol, 1e-12)
    sig_sqrt_t = v * torch.sqrt(t)
    d1 = (torch.log(forward / strike) + 0.5 * v * v * t) / sig_sqrt_t
    d2 = d1 - sig_sqrt_t
    df = torch.exp(-rate * t)
    live = df * cp * (forward * norm_cdf(cp * d1) - strike * norm_cdf(cp * d2))
    intrinsic = df * torch.clamp_min(cp * (forward - strike), 0.0)
    return torch.where(maturity <= EPS_TIME, intrinsic, live)


def sabr_price(forward, strike, maturity, rate, params: SABRParams, cp=1.0):
    vol = sabr_implied_vol(forward, strike, maturity, params)
    return black76_price(forward, strike, maturity, rate, vol, cp)


def _sabr_unpack(x, beta):
    return SABRParams(alpha=_softplus(x[0]), beta=beta, rho=torch.tanh(x[1]),
                      nu=_softplus(x[2]))


def _sabr_loss(x, forward, ks, maturity, vols, beta):
    model = sabr_implied_vol(forward, ks, maturity, _sabr_unpack(x, beta))
    return torch.mean((model - vols) ** 2)


def calibrate_sabr(forward, strikes, maturity, market_vols, beta: float = 0.5,
                   init: SABRParams | None = None, n_steps: int = 400,
                   learning_rate: float = 0.05, device=None) -> tuple[SABRParams, float]:
    """Fit (α, ρ, ν) to a smile with β fixed; the loss is the mean squared
    implied-vol error. Runs in float32 on ``device``, by default the device
    of ``market_vols`` when it is a tensor, else the card."""
    from ..ops.optim import scan_adam_cached

    if device is None:
        device = input_device(market_vols)
    f32 = dict(dtype=torch.float32, device=device)
    vols = torch.as_tensor(market_vols, **f32)
    ks = torch.as_tensor(strikes, **f32)
    if init is None:
        init = SABRParams.make(alpha=float(vols.mean()), beta=beta)

    def inv_sp(x):
        return torch.log(torch.expm1(torch.clamp_min(torch.as_tensor(x, **f32), 1e-6)))

    x0 = torch.stack([inv_sp(init.alpha),
                      torch.atanh(torch.clamp(torch.as_tensor(init.rho, **f32), -0.99, 0.99)),
                      inv_sp(torch.clamp_min(torch.as_tensor(init.nu, **f32), 1e-3))])
    beta_t = torch.tensor(float(beta), **f32)
    best_x, best_loss, _ = scan_adam_cached(
        _sabr_loss, x0, (torch.tensor(float(forward), **f32), ks,
                         torch.tensor(float(maturity), **f32), vols, beta_t),
        n_steps, learning_rate)
    best = float(best_loss)
    if not math.isfinite(best):
        raise CalibrationError("SABR calibration diverged (non-finite loss)")
    params = _sabr_unpack(best_x.detach(), beta_t)
    params.validate()
    return params, best


class SABRModel:
    """Object adapter; its parameters live on ``device``."""

    def __init__(self, alpha=0.2, beta=0.5, rho=-0.3, nu=0.4, device="cuda"):
        self.params = SABRParams.make(alpha, beta, rho, nu, device=device)
        self.params.validate()

    def implied_vol(self, F, K, T):
        return sabr_implied_vol(F, K, T, self.params)

    def atm_vol(self, F, T):
        return sabr_atm_vol(F, T, self.params)

    def smile(self, F, strikes, T):
        return sabr_smile(F, strikes, T, self.params)

    def price(self, S, K, T, r, sigma=None, option_type="call", q=0.0):
        """Unified-protocol price: ``sigma`` is ignored (the model supplies
        its own vol)."""
        cp = 1.0 if str(option_type).lower() in ("call", "c", "1") else -1.0
        dev = self.params.alpha.device
        S, T, r, q = as_tensors(S, T, r, q, device=dev)
        forward = S * torch.exp((r - q) * T)
        return sabr_price(forward, K, T, r, self.params, cp)
