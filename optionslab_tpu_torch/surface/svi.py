"""SVI / SSVI parametric volatility surfaces with no-arbitrage diagnostics.

The port of ``optionslab_tpu/surface/svi.py``:

* raw SVI total variance w(k) = a + b(ρ(k−m) + √((k−m)² + σ²)), its closed
  form w', w'', Gatheral's density function g(k), the Dupire local
  variance of two slices and the butterfly check;
* the SSVI surface w(k, θ) = θ/2 (1 + ρφk + √((φk + ρ)² + 1 − ρ²)) with
  the power law φ(θ) = η/θ^γ;
* the calibrators: a Zeliade-style quasi-explicit warm start (a batched
  3 × 3 ridge solve per (m, σ) grid point, the smallest residual wins), then
  Adam over constrained transforms with smooth penalties
  (``ops/optim.scan_adam_cached``: the reference's clip, best iterate and
  ``n_steps + 2`` loss evaluations), float32 on the device, no host
  synchronisation inside a loop.

Parameters are 0-d float32 tensors. Functions of parameters run on the
parameters' device; calibrators on their tensor inputs' device, or on
``device`` (default the card) for numbers and numpy arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.heston import _softplus
from ..utils.config import input_device
from ..utils.exceptions import CalibrationError, ValidationError


def _scalar(x) -> float:
    return float(torch.as_tensor(x).reshape(-1)[0])


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # a read-only view (a broadcast): torch warns on those
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """A tensor argument as it is; numbers and arrays on ``like``'s device in
    its dtype."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=like.dtype, device=like.device)


def linspace(start, stop, num: int, device, dtype=torch.float32) -> torch.Tensor:
    """``jnp.linspace``, rounding for rounding: start·(1 − s) + stop·s with
    s = i/(num − 1), the last point ``stop`` itself (``torch.linspace``
    fills its upper half from the stop, a different rounding)."""
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) / float(div)
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def _inv_softplus(x):
    return torch.log(torch.expm1(torch.clamp_min(x, 1e-8)))


@dataclasses.dataclass(frozen=True)
class SVIParams:
    a: torch.Tensor
    b: torch.Tensor
    rho: torch.Tensor
    m: torch.Tensor
    sigma: torch.Tensor

    @classmethod
    def make(cls, a=0.02, b=0.1, rho=-0.3, m=0.0, sigma=0.2, dtype=torch.float32,
             device="cuda"):
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (a, b, rho, m, sigma)))

    @classmethod
    def from_numpy(cls, a, b, rho, m, sigma, device="cuda") -> "SVIParams":
        """Parameters from numbers or numpy arrays (e.g. the JAX package's
        ``np.asarray`` of a fitted slice), as float32 tensors on ``device``."""
        return cls(*(_f32(np.array(x, np.float32), device) for x in (a, b, rho, m, sigma)))

    def validate(self):
        a, b, rho, sig = (_scalar(x) for x in (self.a, self.b, self.rho, self.sigma))
        if b < 0 or sig <= 0:
            raise ValidationError(f"SVI requires b >= 0, sigma > 0 (b={b}, sigma={sig})")
        if not -1.0 < rho < 1.0:
            raise ValidationError(f"SVI rho must be in (-1,1): {rho}")
        if a + b * sig * np.sqrt(1.0 - rho**2) < 0:
            raise ValidationError(
                "SVI min total variance negative: a + b·σ·√(1-ρ²) = "
                f"{a + b * sig * np.sqrt(1 - rho**2):.6f} < 0"
            )


def svi_total_variance(k, p: SVIParams):
    """w(k) = a + b(ρ(k−m) + √((k−m)² + σ²))."""
    km = _on(k, p.a) - p.m
    return p.a + p.b * (p.rho * km + torch.sqrt(km * km + p.sigma * p.sigma))


def svi_implied_vol(k, maturity, p: SVIParams):
    w = torch.clamp_min(svi_total_variance(k, p), 1e-12)
    return torch.sqrt(w / torch.clamp_min(_on(maturity, p.a), 1e-12))


def svi_derivatives(k, p: SVIParams):
    """(w, w', w'') in closed form."""
    km = _on(k, p.a) - p.m
    root = torch.sqrt(km * km + p.sigma * p.sigma)
    w = p.a + p.b * (p.rho * km + root)
    wp = p.b * (p.rho + km / root)
    wpp = p.b * p.sigma * p.sigma / (root * root * root)
    return w, wp, wpp


def svi_g(k, p: SVIParams):
    """Gatheral's g(k) ≥ 0 ⟺ butterfly-arbitrage-free density:

        g = (1 − k·w'/(2w))² − (w'/4)²·(1/w + 1/4) + w''/2
    """
    k = _on(k, p.a)
    w, wp, wpp = svi_derivatives(k, p)
    w = torch.clamp_min(w, 1e-12)
    return (1.0 - k * wp / (2.0 * w)) ** 2 - 0.25 * wp * wp * (1.0 / w + 0.25) + 0.5 * wpp


def svi_local_variance(k, maturity, p_t: SVIParams, p_t_next: SVIParams, dt):
    """Dupire local variance from two SVI slices: σ_loc² = ∂_T w / g(k)."""
    del maturity  # the slices carry it
    w_t = svi_total_variance(k, p_t)
    w_next = svi_total_variance(k, p_t_next)
    dw_dt = (w_next - w_t) / torch.clamp_min(_on(dt, p_t.a), 1e-12)
    g = torch.clamp_min(svi_g(k, p_t), 1e-8)
    return torch.clamp_min(dw_dt, 0.0) / g


def check_butterfly(p: SVIParams, k_grid=None) -> bool:
    k = (linspace(-1.5, 1.5, 201, p.a.device) if k_grid is None else _on(k_grid, p.a))
    return bool(torch.all(svi_g(k, p) >= -1e-8))


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------
def _svi_pack(p: SVIParams):
    return torch.stack([p.a, _inv_softplus(p.b), torch.atanh(torch.clamp(p.rho, -0.99, 0.99)),
                        p.m, _inv_softplus(p.sigma)])


def _svi_unpack(x) -> SVIParams:
    return SVIParams(a=x[0], b=_softplus(x[1]), rho=torch.tanh(x[2]), m=x[3],
                     sigma=_softplus(x[4]) + 1e-4)


def _svi_solve_grid(k, w_obs, mm, ss):
    """One 3 × 3 ridge solve per (m, σ) grid point (batched), projected onto
    the domain; returns the smallest residual's (a, b, ρ, m, σ)."""
    km = k[None, :] - mm[:, None]  # (G, n)
    root = torch.sqrt(km * km + ss[:, None] ** 2)
    one = torch.ones_like(km)
    phi = torch.stack([one, km, root], dim=-1)  # (G, n, 3)
    gram = torch.einsum("gnf,gne->gfe", phi, phi) \
        + 1e-7 * torch.eye(3, dtype=k.dtype, device=k.device)[None, :, :]
    rhs = torch.einsum("gnf,n->gf", phi, w_obs)
    coef = torch.linalg.solve(gram, rhs[..., None])[..., 0]
    # domain projection: b ≥ 0, |rho| ≤ 0.95, min-variance ≥ 0
    b = torch.clamp_min(coef[:, 2], 1e-6)
    rho = torch.clamp(coef[:, 1] / b, -0.95, 0.95)
    a = coef[:, 0]
    fit = a[:, None] + b[:, None] * (rho[:, None] * km + root)
    resid = torch.mean((fit - w_obs[None, :]) ** 2, dim=1)
    # penalize negative minimum variance: the winner must be admissible
    min_w = a + b * ss * torch.sqrt(1.0 - rho * rho)
    resid = resid + 1e3 * torch.clamp_min(-min_w, 0.0) ** 2
    g = torch.argmin(resid)  # the first of equal minima, as jnp.argmin
    return a[g], b[g], rho[g], mm[g], ss[g]


def _svi_quasi_explicit_init(k, w_obs):
    """Zeliade-style warm start: for FIXED (m, σ) the slice w = a + c·(k−m) +
    d·√((k−m)² + σ²) is linear in (a, c = bρ, d = b), so each (m, σ) grid
    point costs one exact 3 × 3 ridge solve and the best residual wins: an
    11 × 10 grid, then 9 × 9 around its winner. The ridge systems are
    ill-conditioned (their columns 1, k − m and the root are nearly
    collinear), so the search runs in float64 on float32 quotes. Returns the
    stacked float64 (a, b, ρ, m, σ)."""
    dev = k.device
    f64 = dict(device=dev, dtype=torch.float64)
    span = torch.clamp_min(k.max() - k.min(), 1e-3)
    k, w_obs = k.double(), w_obs.double()
    ms = k.min() + linspace(0.05, 0.95, 11, **f64) * span
    sigs = torch.exp(linspace(math.log(0.02), math.log(1.0), 10, **f64))
    mm, ss = torch.meshgrid(ms, sigs, indexing="ij")
    _, _, _, m0, s0 = _svi_solve_grid(k, w_obs, mm.reshape(-1), ss.reshape(-1))
    # local refinement around the coarse winner (±1 coarse cell)
    dm = span * 0.09
    mm2, ss2 = torch.meshgrid(m0 + linspace(-dm, dm, 9, dev).double(),
                              s0 * torch.exp(linspace(-0.26, 0.26, 9, **f64)), indexing="ij")
    # a may be negative (admissibility only needs a + bσ√(1−ρ²) ≥ 0, which
    # the residual's penalty enforced)
    return torch.stack(_svi_solve_grid(k, w_obs, mm2.reshape(-1), ss2.reshape(-1)))


def _svi_loss(x, k, w_obs, k_dense, w_scale, butterfly_penalty):
    p = _svi_unpack(x)
    w = svi_total_variance(k, p)
    fit = torch.mean((w - w_obs) ** 2) / w_scale
    min_w = p.a + p.b * p.sigma * torch.sqrt(1.0 - p.rho**2)
    pen_pos = torch.clamp_min(-min_w, 0.0) ** 2 / w_scale
    g = svi_g(k_dense, p)
    pen_bfly = torch.mean(torch.clamp_min(-g, 0.0) ** 2)
    return fit + butterfly_penalty * (pen_pos + pen_bfly)


def calibrate_svi(log_strikes, total_variance=None, *, vols=None, maturity=None,
                  init: SVIParams | None = None, n_steps: int = 800,
                  learning_rate: float = 0.02, butterfly_penalty: float = 10.0,
                  device=None) -> tuple[SVIParams, float]:
    """Fit one SVI slice. Accepts total variances directly or (vols, T).

    Constraint handling: smooth penalties on min-variance positivity and on
    g(k) < 0 over 101 points past the quotes. Two Adam loops: ``n_steps`` at
    ``learning_rate`` from the quasi-explicit warm start, then
    max(n_steps // 3, 100) at a fifth of it from the best iterate (Adam's
    step noise floors the loss at the main rate). The fit term is divided by
    the squared mean observed w, so short and long slices converge alike.
    """
    from ..ops.optim import scan_adam_cached

    if device is None:
        device = input_device(log_strikes, total_variance, vols)
    k = _f32(log_strikes, device)
    if total_variance is None:
        if vols is None or maturity is None:
            raise ValidationError("provide total_variance or (vols, maturity)")
        total_variance = _f32(vols, device) ** 2 * _f32(maturity, device)
    w_obs = _f32(total_variance, device)

    if init is None:
        a0, b0, r0, m0, s0 = _svi_quasi_explicit_init(k, w_obs)
        init = SVIParams(a=a0, b=b0, rho=r0, m=m0, sigma=s0)
    x0 = _svi_pack(SVIParams(*(_f32(getattr(init, f), device) for f in SVI_FIELDS)))
    k_dense = linspace(float(k.min()) - 0.3, float(k.max()) + 0.3, 101, device)
    w_scale = torch.clamp_min(torch.mean(w_obs) ** 2, 1e-12)

    args = (k, w_obs, k_dense, w_scale, _f32(butterfly_penalty, device))
    best_x, best_loss, _ = scan_adam_cached(_svi_loss, x0, args, n_steps, learning_rate)
    best_x, best_loss, _ = scan_adam_cached(_svi_loss, best_x, args, max(n_steps // 3, 100),
                                            learning_rate / 5.0)
    best = float(best_loss)
    if not math.isfinite(best):
        raise CalibrationError("SVI calibration diverged (non-finite loss)")
    return _svi_unpack(best_x.detach()), best


SVI_FIELDS = ("a", "b", "rho", "m", "sigma")


# ---------------------------------------------------------------------------
# SSVI
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SSVIParams:
    """Surface SVI: w(k, θ) = θ/2 · (1 + ρφ(θ)k + √((φ(θ)k + ρ)² + 1 − ρ²)),
    φ(θ) = η / θ^γ (power-law), θ = ATM total variance per maturity."""

    rho: torch.Tensor
    eta: torch.Tensor
    gamma: torch.Tensor

    @classmethod
    def make(cls, rho=-0.3, eta=1.0, gamma=0.5, dtype=torch.float32, device="cuda"):
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device) for x in (rho, eta, gamma)))

    @classmethod
    def from_numpy(cls, rho, eta, gamma, device="cuda") -> "SSVIParams":
        """Parameters from numbers or numpy arrays, as float32 tensors."""
        return cls(*(_f32(np.array(x, np.float32), device) for x in (rho, eta, gamma)))

    def validate(self):
        rho, eta, gamma = (_scalar(x) for x in (self.rho, self.eta, self.gamma))
        if not -1.0 < rho < 1.0:
            raise ValidationError(f"SSVI rho must be in (-1,1): {rho}")
        if eta <= 0 or not 0.0 < gamma < 1.0:
            raise ValidationError(f"SSVI needs eta > 0, gamma in (0,1): eta={eta}, gamma={gamma}")
        # Gatheral-Jacquier sufficient no-butterfly condition
        if eta * (1.0 + abs(rho)) > 2.0:
            raise ValidationError(
                f"SSVI butterfly condition η(1+|ρ|) ≤ 2 violated: {eta * (1 + abs(rho)):.4f}"
            )


def ssvi_phi(theta, p: SSVIParams):
    return p.eta / torch.clamp_min(_on(theta, p.eta), 1e-12) ** p.gamma


def ssvi_total_variance(k, theta, p: SSVIParams):
    k = _on(k, p.eta)
    theta = _on(theta, p.eta)
    ph = ssvi_phi(theta, p)
    return 0.5 * theta * (1.0 + p.rho * ph * k + torch.sqrt((ph * k + p.rho) ** 2 + 1.0
                                                            - p.rho**2))


def ssvi_implied_vol(k, theta, maturity, p: SSVIParams):
    w = torch.clamp_min(ssvi_total_variance(k, theta, p), 1e-12)
    return torch.sqrt(w / torch.clamp_min(_on(maturity, p.eta), 1e-12))


def _ssvi_unpack(x):
    return SSVIParams(rho=torch.tanh(x[0]), eta=_softplus(x[1]),
                      gamma=(torch.tanh(x[2]) + 1.0) / 2.0 * 0.98 + 0.01)


def _ssvi_loss(x, k, th, w_obs):
    p = _ssvi_unpack(x)
    w = ssvi_total_variance(k, th, p)
    fit = torch.mean((w - w_obs) ** 2)
    pen = torch.clamp_min(p.eta * (1.0 + torch.abs(p.rho)) - 2.0, 0.0) ** 2
    return fit + 10.0 * pen


def _ssvi_pack(rho, eta, gamma):
    return torch.stack([torch.atanh(torch.clamp(rho, -0.99, 0.99)), _inv_softplus(eta),
                        torch.atanh(torch.clamp(gamma * 2 - 1, -0.99, 0.99))])


def calibrate_ssvi(log_strikes, thetas, total_variances, init: SSVIParams | None = None,
                   n_steps: int = 600, learning_rate: float = 0.02,
                   device=None) -> tuple[SSVIParams, float]:
    """Fit (ρ, η, γ) across maturities. ``log_strikes`` / ``thetas`` /
    ``total_variances`` are (n_mat, n_k) / (n_mat,) / (n_mat, n_k)."""
    from ..ops.optim import scan_adam_cached

    if device is None:
        device = input_device(log_strikes, thetas, total_variances)
    k = _f32(log_strikes, device)
    th = _f32(thetas, device)[:, None]
    w_obs = _f32(total_variances, device)
    init = init or SSVIParams.make(device=device)
    x0 = _ssvi_pack(*(_f32(getattr(init, f), device) for f in ("rho", "eta", "gamma")))
    best_x, best_loss, _ = scan_adam_cached(_ssvi_loss, x0, (k, th, w_obs), n_steps,
                                            learning_rate)
    best = float(best_loss)
    if not math.isfinite(best):
        raise CalibrationError("SSVI calibration diverged (non-finite loss)")
    return _ssvi_unpack(best_x.detach()), best


class SVIModel:
    """Object adapter for one SVI slice on ``device``."""

    def __init__(self, params: SVIParams | None = None, device="cuda"):
        self.device = params.a.device if params is not None else torch.device(device)
        self.params = params or SVIParams.make(device=device)

    def total_variance(self, k):
        return svi_total_variance(k, self.params)

    def implied_vol(self, k, maturity):
        return svi_implied_vol(k, maturity, self.params)

    def smile(self, log_strikes, maturity):
        return svi_implied_vol(log_strikes, maturity, self.params)

    def calibrate(self, log_strikes, vols, maturity, **kw):
        kw.setdefault("device", self.device)
        self.params, loss = calibrate_svi(log_strikes, vols=vols, maturity=maturity, **kw)
        return loss

    def is_butterfly_free(self, k_grid=None) -> bool:
        return check_butterfly(self.params, k_grid)


class SSVIModel:
    """Object adapter for an SSVI surface on ``device``."""

    def __init__(self, params: SSVIParams | None = None, device="cuda"):
        self.device = params.eta.device if params is not None else torch.device(device)
        self.params = params or SSVIParams.make(device=device)

    def total_variance(self, k, theta):
        return ssvi_total_variance(k, theta, self.params)

    def implied_vol(self, k, theta, maturity):
        return ssvi_implied_vol(k, theta, maturity, self.params)

    def calibrate(self, log_strikes, thetas, total_variances, **kw):
        kw.setdefault("device", self.device)
        self.params, loss = calibrate_ssvi(log_strikes, thetas, total_variances, **kw)
        return loss


def calibrate_svi_surface(log_strikes, maturities, iv_grid, n_steps: int = 800,
                          learning_rate: float = 0.02, device=None):
    """Calibrate one SVI slice per maturity and report cross-slice
    no-arbitrage diagnostics.

    ``iv_grid``: (n_maturities, n_strikes). Returns (params_list, report dict
    with per-slice loss, butterfly-free flags, and the calendar violation
    rate of the FITTED surface).
    """
    if device is None:
        device = input_device(log_strikes, iv_grid)
    k = _f32(log_strikes, device)
    mats = np.asarray(maturities, np.float64)
    iv_grid = np.asarray(iv_grid.cpu() if isinstance(iv_grid, torch.Tensor) else iv_grid,
                         np.float64)
    params_list, losses = [], []
    for i, t in enumerate(mats):
        p, loss = calibrate_svi(k, vols=iv_grid[i], maturity=float(t), n_steps=n_steps,
                                learning_rate=learning_rate, device=device)
        params_list.append(p)
        losses.append(loss)
    w_fit = torch.stack([svi_total_variance(k, p) for p in params_list]).cpu().numpy()
    cal_viol = float(np.mean(np.diff(w_fit, axis=0) < -1e-8))
    bfly_free = [check_butterfly(p, k) for p in params_list]
    return params_list, {
        "slice_losses": losses,
        "butterfly_free": bfly_free,
        "calendar_violation_rate": cal_viol,
        "arbitrage_free": cal_viol == 0.0 and all(bfly_free),
    }
