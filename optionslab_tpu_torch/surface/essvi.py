"""eSSVI — extended SSVI with per-expiry (theta, rho, psi) slices.

The port of ``optionslab_tpu/surface/essvi.py`` (Hendriks & Martini 2017):
each slice stays in the SSVI family

    w_i(k) = 1/2 ( theta_i + rho_i psi_i k
                   + sqrt((psi_i k + theta_i rho_i)^2 + theta_i^2 (1 - rho_i^2)) )

with (rho_i, psi_i) free per expiry. theta_i and psi_i increase by
construction (cumulative softplus increments); the Gatheral–Jacquier
butterfly conditions in psi-form and the calendar condition on a dense grid
are smooth penalties; the exact g(k) ≥ 0 and calendar checks run after the
fit (:func:`essvi_report`). The whole surface calibrates in ONE Adam loop
over every slice (scattered quotes carry a slice index), float32 on the
device, with no host synchronisation inside the loop.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.heston import _softplus
from ..utils.config import input_device
from ..utils.exceptions import CalibrationError, ValidationError
from .svi import _f32, _inv_softplus, _on, linspace

__all__ = ["ESSVIParams", "essvi_total_variance", "essvi_derivatives",
           "essvi_g", "calibrate_essvi", "essvi_surface_iv_fn",
           "essvi_report"]


@dataclasses.dataclass(frozen=True)
class ESSVIParams:
    """Per-expiry eSSVI parameters (float32 tensors of shape (n_expiries,))."""

    theta: torch.Tensor  # ATM total variance per slice, increasing
    rho: torch.Tensor  # per-slice correlation in (-1, 1)
    psi: torch.Tensor  # per-slice skew scale psi = theta*phi, increasing

    @classmethod
    def make(cls, theta, rho, psi, dtype=torch.float32, device="cuda"):
        return cls(*(torch.atleast_1d(torch.as_tensor(x, dtype=dtype, device=device))
                     for x in (theta, rho, psi)))

    @classmethod
    def from_numpy(cls, theta, rho, psi, device="cuda") -> "ESSVIParams":
        """Parameters from numpy arrays (e.g. the JAX package's fit), as
        float32 tensors on ``device``."""
        return cls.make(*(np.array(x, np.float32) for x in (theta, rho, psi)), device=device)

    @property
    def n_slices(self) -> int:
        return int(self.theta.shape[0])

    def validate(self):
        th, rho, psi = (getattr(self, f).detach().cpu().numpy().astype(np.float64)
                        for f in ("theta", "rho", "psi"))
        if np.any(th <= 0) or np.any(psi <= 0):
            raise ValidationError("eSSVI needs theta > 0 and psi > 0")
        if np.any(np.abs(rho) >= 1.0):
            raise ValidationError("eSSVI rho must be in (-1, 1)")
        if np.any(np.diff(th) < -1e-9):
            raise ValidationError("eSSVI theta must be non-decreasing in T")


def _args(*xs):
    """Tensors stay as they are; numbers and arrays follow the first tensor
    (float32 on the card when there is none)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if like is None:
        like = torch.empty(0, dtype=torch.float32, device=input_device())
    return [_on(x, like) for x in xs]


def essvi_total_variance(k, theta, rho, psi):
    """w(k) for one slice (broadcasts over k and slice params alike)."""
    k, theta, rho, psi = _args(k, theta, rho, psi)
    root = torch.sqrt((psi * k + theta * rho) ** 2 + theta * theta * (1.0 - rho * rho))
    return 0.5 * (theta + rho * psi * k + root)


def essvi_derivatives(k, theta, rho, psi):
    """(w, w', w'') in closed form for one slice."""
    k, theta, rho, psi = _args(k, theta, rho, psi)
    u = psi * k + theta * rho
    root = torch.sqrt(u * u + theta * theta * (1.0 - rho * rho))
    w = 0.5 * (theta + rho * psi * k + root)
    wp = 0.5 * (rho * psi + psi * u / root)
    wpp = 0.5 * psi * psi * theta * theta * (1.0 - rho * rho) / (root ** 3)
    return w, wp, wpp


def essvi_g(k, theta, rho, psi):
    """Gatheral's density function g(k) >= 0 <=> butterfly-arbitrage-free."""
    k, theta, rho, psi = _args(k, theta, rho, psi)
    w, wp, wpp = essvi_derivatives(k, theta, rho, psi)
    w = torch.clamp_min(w, 1e-12)
    return (1.0 - k * wp / (2.0 * w)) ** 2 - 0.25 * wp * wp * (1.0 / w + 0.25) + 0.5 * wpp


def _pack(theta0, rho0, psi0):
    """Initial packed vector: increments in softplus^-1 space + arctanh rho."""
    zero = torch.zeros(1, dtype=theta0.dtype, device=theta0.device)
    th_inc = torch.diff(torch.cat([zero, theta0]))
    ps_inc = torch.diff(torch.cat([zero, psi0]))
    return torch.cat([_inv_softplus(torch.clamp_min(th_inc, 1e-6)),
                      torch.atanh(torch.clamp(rho0, -0.95, 0.95)),
                      _inv_softplus(torch.clamp_min(ps_inc, 1e-6))])


def _unpack(x, n):
    theta = torch.cumsum(_softplus(x[:n]) + 1e-7, dim=0)
    rho = torch.tanh(x[n:2 * n]) * 0.999
    psi = torch.cumsum(_softplus(x[2 * n:]) + 1e-7, dim=0)
    return ESSVIParams(theta=theta, rho=rho, psi=psi)


def _essvi_loss(x, k_flat, w_flat, wgt, idx, k_dense, butterfly_penalty, calendar_penalty):
    """The joint eSSVI loss; the slice count is x's length / 3."""
    n = x.shape[0] // 3
    p = _unpack(x, n)
    w = essvi_total_variance(k_flat, p.theta[idx], p.rho[idx], p.psi[idx])
    fit = torch.sum(wgt * (w - w_flat) ** 2) / n
    # Gatheral-Jacquier butterfly (psi-form) as smooth penalties
    b1 = torch.clamp_min(p.psi * (1.0 + torch.abs(p.rho)) - 4.0, 0.0)
    b2 = torch.clamp_min(p.psi ** 2 * (1.0 + torch.abs(p.rho)) - 4.0 * p.theta, 0.0)
    pen_b = torch.mean(b1 ** 2) + torch.mean(b2 ** 2)
    # calendar: w_{i+1}(k) >= w_i(k) on the dense grid
    w_sl = essvi_total_variance(k_dense[None, :], p.theta[:, None], p.rho[:, None],
                                p.psi[:, None])
    cross = (torch.clamp_min(w_sl[:-1] - w_sl[1:], 0.0) if n > 1
             else torch.zeros((), dtype=x.dtype, device=x.device))
    pen_c = torch.mean(cross ** 2) / torch.clamp_min(torch.mean(w_flat) ** 2, 1e-12)
    return fit + butterfly_penalty * pen_b + calendar_penalty * pen_c


def calibrate_essvi(slice_log_strikes, slice_total_variances, *,
                    thetas_init=None, n_steps: int = 1500,
                    learning_rate: float = 0.02,
                    butterfly_penalty: float = 50.0,
                    calendar_penalty: float = 50.0,
                    device=None) -> tuple[ESSVIParams, float]:
    """Joint eSSVI fit of all expiry slices in one Adam loop.

    ``slice_log_strikes`` / ``slice_total_variances``: lists (one entry per
    expiry, ascending maturity) of per-quote forward log-moneyness and
    observed total variance. Returns (params, loss). Each quote weighs
    1 / (mean slice w)² / (quotes in its slice), so every slice contributes
    O(1) to the loss whatever its maturity or density.
    """
    n = len(slice_log_strikes)
    if n != len(slice_total_variances) or n == 0:
        raise ValidationError("need matching, non-empty per-slice quote lists")
    if device is None:
        device = input_device(*slice_log_strikes, *slice_total_variances)

    def host(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float64)

    ks = [host(k) for k in slice_log_strikes]
    ws = [host(w) for w in slice_total_variances]
    slice_of = np.concatenate([np.full(len(ks[i]), i) for i in range(n)])
    k_flat = _f32(np.concatenate(ks).astype(np.float32), device)
    w_flat = _f32(np.concatenate(ws).astype(np.float32), device)
    idx = torch.as_tensor(slice_of, dtype=torch.int64, device=device)
    w_mean = np.array([max(float(np.mean(w)), 1e-8) for w in ws])
    cnt = np.array([max(len(k), 1) for k in ks], np.float64)
    wgt = _f32((1.0 / (w_mean[slice_of] ** 2 * cnt[slice_of])).astype(np.float32), device)

    if thetas_init is None:
        # ATM w per slice: the quote nearest k = 0
        thetas_init = np.array([float(w[np.argmin(np.abs(k))]) for k, w in zip(ks, ws)])
    thetas_init = host(thetas_init)
    th0 = _f32(np.maximum.accumulate(np.maximum(thetas_init, 1e-5)).astype(np.float32), device)
    rho0 = torch.full((n,), -0.3, dtype=torch.float32, device=device)
    psi0 = _f32(np.maximum.accumulate(
        np.maximum(0.5 * np.sqrt(np.maximum(thetas_init, 1e-5)), 1e-4)).astype(np.float32),
        device)
    x0 = _pack(th0, rho0, psi0)

    lo = float(k_flat.min()) - 0.3
    hi = float(k_flat.max()) + 0.3
    k_dense = linspace(lo, hi, 101, device)

    from ..ops.optim import scan_adam_cached

    best_x, best_loss, _ = scan_adam_cached(
        _essvi_loss, x0,
        (k_flat, w_flat, wgt, idx, k_dense, _f32(butterfly_penalty, device),
         _f32(calendar_penalty, device)),
        n_steps, learning_rate)
    best = float(best_loss)
    if not math.isfinite(best):
        raise CalibrationError("eSSVI calibration diverged (non-finite loss)")
    return _unpack(best_x.detach(), n), best


def essvi_report(params: ESSVIParams, k_lo: float = -1.5, k_hi: float = 1.5,
                 n_k: int = 201) -> dict:
    """Exact post-fit no-arbitrage verification on a dense grid."""
    k = linspace(k_lo, k_hi, n_k, params.theta.device)
    th, rho, psi = params.theta[:, None], params.rho[:, None], params.psi[:, None]
    g = essvi_g(k[None, :], th, rho, psi).cpu().numpy()
    w = essvi_total_variance(k[None, :], th, rho, psi).cpu().numpy()
    cal_viol = (float(np.mean(np.diff(w, axis=0) < -1e-8))
                if params.n_slices > 1 else 0.0)
    bfly_free = [bool(np.all(g[i] >= -1e-7)) for i in range(params.n_slices)]
    return {
        "butterfly_free": bfly_free,
        "min_g": float(g.min()),
        "calendar_violation_rate": cal_viol,
        "theta_monotone": True,  # by construction (cumulative softplus)
        "psi_monotone": True,  # by construction
        "arbitrage_free": cal_viol == 0.0 and all(bfly_free),
    }


def interp_total_variance(w_sl, expiries, t):
    """Total variance at maturities ``t`` from per-expiry slices ``w_sl``
    (n_exp, *t.shape): linear in T between expiries (``jnp.interp``'s
    segment: the right-hand one at an interior expiry, the last one at the
    last), w_1·T/T_1 before the first expiry and w_n·T/T_n after the last,
    floored at 1e-10. T is clamped into [T_1, T_n] by ``torch.clamp``, whose
    gradient at a bound is 1: dw/dT on the last expiry is the last
    segment's slope."""
    n = expiries.shape[0]
    t_lo, t_hi = expiries[0], expiries[-1]
    t_c = torch.clamp(t, t_lo, t_hi)
    if n == 1:
        w_in = w_sl[0]
    else:
        i = torch.clamp(torch.searchsorted(expiries, t_c.detach().contiguous(), right=True),
                        1, n - 1)
        w_left = torch.gather(w_sl, 0, (i - 1)[None]).squeeze(0)
        w_right = torch.gather(w_sl, 0, i[None]).squeeze(0)
        x_left = expiries[i - 1]
        w_in = w_left + ((t_c - x_left) / (expiries[i] - x_left)) * (w_right - w_left)
    w = torch.where(t < t_lo, w_sl[0] * t / t_lo,
                    torch.where(t > t_hi, w_sl[-1] * t / t_hi, w_in))
    return torch.clamp_min(w, 1e-10)


def surface_iv_fn(w_slices, expiries):
    """``iv_fn(k, T)`` from a function of k giving the (n_exp, *k.shape)
    slice total variances: elementwise in broadcast (k, T), float32 on the
    slices' device, differentiable by autograd in both."""

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=torch.float32, device=expiries.device)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=expiries.device)

    def iv_fn(k, t):
        k, t = f32(k), f32(t)
        kb, tb = torch.broadcast_tensors(k, t)
        w = interp_total_variance(w_slices(kb), expiries, tb)
        return torch.sqrt(w / torch.clamp_min(t, 1e-8))

    return iv_fn


def essvi_surface_iv_fn(params: ESSVIParams, expiries):
    """Smooth-in-(k, T) implied-vol function from the eSSVI slices, with the
    T-interpolation of :func:`~.chain_calibration.svi_surface_iv_fn` (linear
    w in T between slices, proportional-to-T extrapolation at both ends) — a
    drop-in input for :class:`~..models.local_vol.DupireLocalVol`."""
    expiries = _f32(np.asarray(expiries.detach().cpu() if isinstance(expiries, torch.Tensor)
                               else expiries, np.float32), params.theta.device)
    def w_slices(k):
        view = (-1,) + (1,) * k.dim()
        return essvi_total_variance(k[None], params.theta.reshape(view),
                                    params.rho.reshape(view), params.psi.reshape(view))

    return surface_iv_fn(w_slices, expiries)
