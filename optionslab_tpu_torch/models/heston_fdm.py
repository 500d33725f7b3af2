"""Heston PDE solver: Douglas ADI on a (log-spot, variance) grid.

The port of ``optionslab_tpu/models/heston_fdm.py``: European and American
options on the full 2-D Heston PDE

    V_t + (r-q-v/2) V_x + kappa(theta-v) V_v + v/2 V_xx
        + rho*sigma*v V_xv + sigma^2 v/2 V_vv - r V = 0,

in float32 on the device of the call (``device``, the card by default).

* Each Douglas step is one tridiagonal solve along x (all variance rows in
  one launch) and one along v (all spot columns in one launch, read through
  the kernel's strides, no transpose copy) of ``ops/tridiag.py``; the mixed
  term is an explicit stencil. The sinh-stretched variance grid and the
  frozen (detached) mesh are the reference's.
* :func:`heston_fdm_greeks` reads the spot/v0 ladder off a biquadratic
  readout of one solve (autograd with ``create_graph``), and the
  kappa/theta/sigma/rho/rate/maturity sensitivities from one reverse pass
  through a second solve: the tridiagonal solve's backward is its adjoint
  solve, one launch per step.
* :func:`_heston_adi_bermudan` and :func:`_slv_adi_bermudan` record the
  continuation slices at the exercise dates for the certified brackets
  (``heston_american``, ``slv_american``); the SLV engine rebuilds its
  x-operator every step from the frozen leverage rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.tridiag import tridiag_apply, tridiag_solve
from ..utils.exceptions import ValidationError
from .heston import HestonParams
from .slv import _interp

__all__ = ["heston_fdm_price", "heston_fdm_greeks"]

THETA_S = 0.5  # Douglas implicitness


def _linspace(a, b, n: int) -> torch.Tensor:
    """``jnp.linspace(a, b, n)`` for 0-dim tensors: a·(1 − s) + b·s with
    s = k/(n−1), the end point exact."""
    s = torch.arange(n - 1, dtype=torch.float32, device=a.device) / (n - 1)
    return torch.cat([a * (1.0 - s) + b * s, b.reshape(1)])


def _ends(mid, first, last):
    """``mid`` (.., m−2) with ``first`` and ``last`` columns added on the last
    axis (scalars or columns)."""
    shape = mid.shape[:-1] + (1,)
    return torch.cat([torch.as_tensor(first, dtype=mid.dtype, device=mid.device).expand(shape),
                      mid,
                      torch.as_tensor(last, dtype=mid.dtype, device=mid.device).expand(shape)],
                     dim=-1)


def _f32(device):
    return lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)


def _geometry(spot, strike, maturity, kap, th, sig, v0, n_x: int, n_v: int):
    """The frozen mesh: (x, dx, x_lo, v, gp, dxi, c_v), all detached."""
    vbar = torch.maximum(v0, th)
    half_width = 5.0 * torch.sqrt(vbar * maturity) + 1.5 * torch.abs(torch.log(spot / strike)) + 0.5
    x_lo = (torch.log(strike) - half_width).detach()
    x_hi = (torch.log(strike) + half_width).detach()
    x = _linspace(x_lo, x_hi, n_x)
    dx = (x_hi - x_lo) / (n_x - 1)
    # sinh-stretched variance grid reaching far into the CIR tail
    v_max = (1.5 * vbar + 10.0 * sig * torch.sqrt(vbar / (2.0 * kap))
             + 2.0 * sig * sig / kap).detach()
    c_v = vbar.detach()
    xi_max = torch.arcsinh(v_max / c_v)
    xi = _linspace(torch.zeros_like(xi_max), xi_max, n_v)
    dxi = xi_max / (n_v - 1)
    v = c_v * torch.sinh(xi)
    gp = c_v * torch.cosh(xi)  # dv/dξ; d²v/dξ² = v itself
    return x, dx, x_lo, v, gp, dxi, c_v


def _v_operator(v, gp, dxi, c_v, kap, th, sig, rate, dt):
    """The v-direction stencil (a2, b2, c2), (1, n_v), in the ξ coordinate,
    and its implicit sweep matrix (i2_lo, i2_di, i2_up): shared by every
    spot column."""
    vk = v[None, :]
    gpk = gp[None, :]
    conv_v = (kap * (th - vk) / gpk - 0.5 * sig * sig * vk * vk / gpk**3) / (2.0 * dxi)
    diff_v = 0.5 * sig * sig * vk / (gpk * gpk * dxi * dxi)
    a2 = diff_v - conv_v
    c2 = diff_v + conv_v
    b2 = -2.0 * diff_v - 0.5 * rate
    # v = 0 row: degenerate PDE, upwind drift kappa*theta > 0 (g'(0) = c);
    # v = v_max row: dV/dv ~ 0 far field
    up0 = kap * th / (c_v * dxi)
    a2 = _ends(a2[:, 1:-1], 0.0, 0.0)
    b2 = _ends(b2[:, 1:-1], -up0 - 0.5 * rate, -0.5 * rate)
    c2 = _ends(c2[:, 1:-1], up0, 0.0)
    i2 = (-THETA_S * dt * a2, 1.0 - THETA_S * dt * b2, -THETA_S * dt * c2)
    return (a2, b2, c2), i2


def _x_operator(vj, l2, rate, dividend, dx, dt, n_x: int):
    """The x-direction stencil (a1, b1, c1), (n_v, n_x), with identity rows
    at the pinned x-boundaries, and its implicit sweep matrix. ``vj`` is
    v[:, None], ``l2`` the squared leverage row (1, n_x) or 1."""
    conv_x = (rate - dividend - 0.5 * l2 * vj) / (2.0 * dx)
    diff_x = 0.5 * l2 * vj / (dx * dx)
    a1 = diff_x - conv_x
    c1 = diff_x + conv_x
    b1 = -2.0 * diff_x - 0.5 * rate
    a1, b1, c1 = (z.expand(vj.shape[0], n_x) for z in (a1, b1, c1))
    a1 = _ends(a1[:, 1:-1], 0.0, 0.0)
    c1 = _ends(c1[:, 1:-1], 0.0, 0.0)
    b1 = _ends(b1[:, 1:-1], 0.0, 0.0)
    i1_di = _ends((1.0 - THETA_S * dt * b1)[:, 1:-1], 1.0, 1.0)
    return (a1, b1, c1), (-THETA_S * dt * a1, i1_di, -THETA_S * dt * c1)


def _mixed(vgrid, coef, dx, dxi):
    """ρσ·v·V_xv = (ρσ·v/g')·V_xξ by central differences (zero at the edges);
    ``coef`` is ρσ(·L)·(v/g') on the interior, broadcastable to (n_v−2, n_x−2)."""
    core = (vgrid[2:, 2:] - vgrid[2:, :-2] - vgrid[:-2, 2:] + vgrid[:-2, :-2]) / (4.0 * dx * dxi)
    return F.pad(coef * core, (1, 1, 1, 1))


def _douglas(vg, tau, ops, bounds, dt):
    """One Douglas step from ``vg`` (n_v, n_x): explicit predictor, x-sweep,
    v-sweep, Dirichlet x-boundaries pinned."""
    (a1, b1, c1), (i1_lo, i1_di, i1_up), (a2, b2, c2), (i2_lo, i2_di, i2_up), a0v = ops
    blo, bhi = bounds(tau)
    a1v = tridiag_apply(a1, b1, c1, vg)
    a2v = tridiag_apply(a2, b2, c2, vg.T).T
    y0 = vg + dt * (a0v + a1v + a2v)
    # x-sweep: (I - th dt A1) Y1 = Y0 - th dt A1 V
    rhs1 = _ends((y0 - THETA_S * dt * a1v)[:, 1:-1], blo, bhi)
    y1 = tridiag_solve(i1_lo, i1_di, i1_up, rhs1)
    # v-sweep: (I - th dt A2) Y2 = Y1 - th dt A2 V, the columns as systems
    rhs2 = (y1 - THETA_S * dt * a2v).T
    y2 = tridiag_solve(i2_lo, i2_di, i2_up, rhs2).T
    return _ends(y2[:, 1:-1], blo, bhi)


def _boundary(s_grid, intrinsic, strike, rate, dividend, cp, american: bool):
    def x_boundary(tau):
        """Dirichlet values at x_lo / x_hi for time-to-maturity tau."""
        df_r = torch.exp(-rate * tau)
        df_q = torch.exp(-dividend * tau)
        lo_eu = torch.clamp_min(cp * (s_grid[0] * df_q - strike * df_r), 0.0)
        hi_eu = torch.clamp_min(cp * (s_grid[-1] * df_q - strike * df_r), 0.0)
        if american:
            lo_eu = torch.maximum(lo_eu, intrinsic[0, 0])
            hi_eu = torch.maximum(hi_eu, intrinsic[0, -1])
        return lo_eu.reshape(1, 1), hi_eu.reshape(1, 1)

    return x_boundary


def _adi_setup(spot, strike, maturity, rate, dividend, cp, params: HestonParams, n_x: int,
               n_v: int, n_t: int, american: bool, device):
    """Grids, Douglas stencils and the (projection-free) step closure.
    Returns ``(step, intrinsic, meta)`` with ``meta = (x_lo, dx, dxi, c_v)``
    (v maps through ξ = asinh(v/c_v))."""
    f32 = _f32(device)
    spot, strike, maturity, rate, dividend, cp = map(f32, (spot, strike, maturity, rate,
                                                           dividend, cp))
    kap, th, sig, rho, v0 = map(f32, (params.kappa, params.theta, params.sigma, params.rho,
                                      params.v0))
    x, dx, x_lo, v, gp, dxi, c_v = _geometry(spot, strike, maturity, kap, th, sig, v0, n_x, n_v)
    dt = maturity / n_t
    s_grid = torch.exp(x)
    intrinsic = torch.clamp_min(cp * (s_grid[None, :] - strike), 0.0).expand(n_v, n_x)
    x_ops = _x_operator(v[:, None], 1.0, rate, dividend, dx, dt, n_x)
    v_stencil, i2 = _v_operator(v, gp, dxi, c_v, kap, th, sig, rate, dt)
    mixed_coef = rho * sig * (v[1:-1] / gp[1:-1])[:, None]
    bounds = _boundary(s_grid, intrinsic, strike, rate, dividend, cp, american)

    def step(vg, i: int):
        tau = (i + 1.0) * dt
        a0v = _mixed(vg, mixed_coef, dx, dxi)
        return _douglas(vg, tau, (*x_ops, v_stencil, i2, a0v), bounds, dt)

    return step, intrinsic, (x_lo, dx, dxi, c_v)


def _bilinear_at(grid, xq, vq, x_lo, dx, dxi, c_v):
    """Bilinear read of a (n_v, n_x) grid at (log-spot xq, variance vq); v
    maps through the sinh stretch; queries clamp to the grid edges. Any
    query shape."""
    n_v, n_x = grid.shape
    fx = torch.clamp((xq - x_lo) / dx, 0.0, n_x - 1.001)
    fv = torch.clamp(torch.arcsinh(vq / c_v) / dxi, 0.0, n_v - 1.001)
    ix = torch.floor(fx).to(torch.int64)
    iv = torch.floor(fv).to(torch.int64)
    wx = fx - ix
    wv = fv - iv
    p00 = grid[iv, ix]
    p01 = grid[iv, ix + 1]
    p10 = grid[iv + 1, ix]
    p11 = grid[iv + 1, ix + 1]
    return (1 - wv) * ((1 - wx) * p00 + wx * p01) + wv * ((1 - wx) * p10 + wx * p11)


def _solve_grid(spot, strike, maturity, rate, dividend, cp, params, n_x, n_v, n_t,
                american, device):
    """The backward solve to t = 0: (grid, meta)."""
    step, intrinsic, meta = _adi_setup(spot, strike, maturity, rate, dividend, cp, params,
                                       n_x, n_v, n_t, american, device)
    vg = intrinsic
    for i in range(n_t):
        vg = step(vg, i)
        if american:
            vg = torch.maximum(vg, intrinsic)
    return vg, meta


def _heston_adi(spot, strike, maturity, rate, dividend, cp, params: HestonParams, n_x: int,
                n_v: int, n_t: int, american: bool, device):
    vg, (x_lo, dx, dxi, c_v) = _solve_grid(spot, strike, maturity, rate, dividend, cp, params,
                                           n_x, n_v, n_t, american, device)
    f32 = _f32(device)
    return _bilinear_at(vg, torch.log(f32(spot)), f32(params.v0), x_lo, dx, dxi, c_v)


def _readout_quad(vg, x_lo, dx, dxi, c_v, spot, v0):
    """Biquadratic (3x3 Lagrange) readout at (log spot, v0): smooth in both
    coordinates, so autograd delta/gamma (spot) and vega/vomma (v0) are the
    central stencils; with the frozen mesh v0 enters only here."""
    n_v, n_x = vg.shape
    fx = (torch.log(spot) - x_lo) / dx
    fv = torch.arcsinh(v0 / c_v) / dxi
    jx = int(torch.clamp(torch.round(fx.detach()), 1, n_x - 2))
    jv = int(torch.clamp(torch.round(fv.detach()), 1, n_v - 2))
    tx = fx - jx
    tv = fv - jv
    wx = (0.5 * tx * (tx - 1.0), 1.0 - tx * tx, 0.5 * tx * (tx + 1.0))
    wv = (0.5 * tv * (tv - 1.0), 1.0 - tv * tv, 0.5 * tv * (tv + 1.0))
    out = 0.0
    for a in range(3):
        for b in range(3):
            out = out + wv[a] * wx[b] * vg[jv + a - 1, jx + b - 1]
    return out


def _fdm_greeks_pipeline(spot, strike, maturity, rate, dividend, cp, params: HestonParams,
                         n_x: int, n_v: int, n_t: int, american: bool, device) -> dict:
    f32 = _f32(device)
    frozen = params.to(dtype=torch.float32, device=device)
    frozen = HestonParams(*(getattr(frozen, k).detach() for k in ("v0", "kappa", "theta",
                                                                  "sigma", "rho")))
    with torch.no_grad():
        vg, (x_lo, dx, dxi, c_v) = _solve_grid(spot, strike, maturity, rate, dividend, cp,
                                               frozen, n_x, n_v, n_t, american, device)
    s = f32(spot).requires_grad_(True)
    w = frozen.v0.clone().requires_grad_(True)
    price = _readout_quad(vg, x_lo, dx, dxi, c_v, s, w)
    delta, vega = torch.autograd.grad(price, (s, w), create_graph=True)
    gamma, vanna = torch.autograd.grad(delta, (s, w), retain_graph=True, allow_unused=True)
    (vomma,) = torch.autograd.grad(vega, (w,), allow_unused=True)
    zero = torch.zeros((), device=device)

    # kappa/theta/sigma/rho/rate/maturity: one reverse pass through a second
    # solve (each tridiagonal solve's backward is one adjoint solve)
    pk = torch.stack([frozen.kappa, frozen.theta, frozen.sigma, frozen.rho, f32(rate),
                      f32(maturity)]).requires_grad_(True)
    pp = HestonParams(v0=frozen.v0, kappa=pk[0], theta=pk[1], sigma=pk[2], rho=pk[3])
    vg2, meta2 = _solve_grid(spot, strike, pk[5], pk[4], dividend, cp, pp, n_x, n_v, n_t,
                             american, device)
    (gp,) = torch.autograd.grad(_readout_quad(vg2, *meta2, f32(spot), frozen.v0), (pk,))
    out = {"price": price, "delta": delta, "gamma": gamma if gamma is not None else zero,
           "vega_v0": vega, "vanna_v0": vanna if vanna is not None else zero,
           "vomma_v0": vomma if vomma is not None else zero,
           "d_kappa": gp[0], "d_theta": gp[1], "d_sigma": gp[2], "d_rho": gp[3],
           "rho_rate": gp[4], "theta_cal": -gp[5]}
    return out


def _cp_of(option_type) -> float:
    return 1.0 if str(option_type).lower() in ("call", "c", "1") else -1.0


def heston_fdm_greeks(spot, strike, maturity, rate, params: HestonParams, dividend=0.0,
                      option_type="call", american: bool = False, n_x: int = 201,
                      n_v: int = 101, n_t: int = 200, device="cuda") -> dict:
    """Full Greek ladder through the 2-D ADI solve, European or American, on
    ``device``: the spot/v0 ladder (delta, gamma, vega_v0, vanna_v0,
    vomma_v0) from the biquadratic readout of one solve; kappa/theta/sigma/
    rho/rate sensitivities and calendar theta (``theta_cal`` = −dV/dT) from
    one reverse pass through a second solve. Python floats."""
    params.validate()
    if float(maturity) <= 0:
        raise ValidationError("maturity must be > 0 for the Greek ladder")
    out = _fdm_greeks_pipeline(float(spot), float(strike), float(maturity), float(rate),
                               float(dividend), _cp_of(option_type), params, n_x, n_v, n_t,
                               bool(american), torch.device(device))
    return {k: float(v.detach()) for k, v in out.items()}


def _bermudan_dates(step, intrinsic, n_dates: int, spd: int):
    """Run ``n_dates`` blocks of ``spd`` steps, projecting on the exercise
    value after each block but the last; returns (grid at t = 0, cont_all)
    with cont_all (n_dates+1, n_v, n_x) by forward date index (entry 0
    unused, entry n_dates zero)."""
    vg = intrinsic
    conts = []
    for b in range(n_dates):
        for j in range(spd):
            vg = step(vg, b * spd + j)
        if b < n_dates - 1:
            conts.append(vg)
            vg = torch.maximum(vg, intrinsic)
    zero = torch.zeros((1,) + intrinsic.shape, dtype=intrinsic.dtype, device=intrinsic.device)
    cont_all = torch.cat([zero, torch.stack(conts[::-1]), zero]) if conts else \
        torch.cat([zero, zero])
    return vg, cont_all


def _heston_adi_bermudan(spot, strike, maturity, rate, dividend, cp, params: HestonParams,
                         n_x: int, n_v: int, n_dates: int, steps_per_date: int, device):
    """Bermudan ADI: projection only at the ``n_dates`` exercise dates,
    recording the continuation slice at each just before it. Returns
    ``(price0, cont_all, x_lo, dx, dxi, c_v)``."""
    step, intrinsic, (x_lo, dx, dxi, c_v) = _adi_setup(
        spot, strike, maturity, rate, dividend, cp, params, n_x, n_v, n_dates * steps_per_date,
        True, device)
    vg, cont_all = _bermudan_dates(step, intrinsic, n_dates, steps_per_date)
    f32 = _f32(device)
    price0 = _bilinear_at(vg, torch.log(f32(spot)), f32(params.v0), x_lo, dx, dxi, c_v)
    return price0, cont_all, x_lo, dx, dxi, c_v


def heston_fdm_price(spot, strike, maturity, rate, params: HestonParams, dividend=0.0,
                     option_type="call", american: bool = False, n_x: int = 201,
                     n_v: int = 101, n_t: int = 200, device="cuda"):
    """Heston European/American price by Douglas ADI on the 2-D PDE, on
    ``device``. Scalars in, a 0-dim float32 tensor out (a Python float for
    maturity <= 0, the intrinsic value)."""
    params.validate()
    if float(maturity) <= 0:
        return float(np.maximum((1.0 if str(option_type).lower().startswith("c") else -1.0)
                                * (float(spot) - float(strike)), 0.0))
    return _heston_adi(spot, strike, float(maturity), rate, dividend, _cp_of(option_type),
                       params, n_x, n_v, n_t, bool(american), torch.device(device))


def _slv_rows(maturity: float, n_dates: int, spd: int, n_rows: int) -> list[int]:
    """The leverage row in force on the forward interval each backward step
    integrates over, in the reference's float32 arithmetic."""
    f = np.float32
    n_t = n_dates * spd
    mat = f(maturity)
    dt = mat / f(n_t)
    dt_mc = mat / f(n_rows)
    rows = []
    for i in range(n_t):
        tau = f(i + 1) * dt
        t_fwd = mat - tau + f(0.5) * dt
        rows.append(int(np.clip(np.int32(t_fwd / dt_mc), 0, n_rows - 1)))
    return rows


def _slv_adi_bermudan(spot, strike, maturity, rate, dividend, cp, params: HestonParams,
                      mixing, x_rows, l_rows, n_x: int, n_v: int, n_dates: int,
                      steps_per_date: int, device):
    """Bermudan ADI under the frozen-leverage SLV law: the x-diffusion is
    L(x, t)²·v and the mixed term ρσ·L·v, with L read from the same
    per-substep leverage rows the Monte Carlo replays (piecewise constant in
    time); the x-operator is rebuilt every step, the v-operator is static.
    Returns ``(price0, cont_all, x_lo, dx, dxi, c_v)``."""
    f32 = _f32(device)
    spot_f, strike, rate, dividend, cp = map(f32, (spot, strike, rate, dividend, cp))
    mat = f32(maturity)
    kap, th, rho, v0 = map(f32, (params.kappa, params.theta, params.rho, params.v0))
    sig = f32(mixing) * f32(params.sigma)
    n_t = n_dates * steps_per_date
    x, dx, x_lo, v, gp, dxi, c_v = _geometry(spot_f, strike, mat, kap, th, sig, v0, n_x, n_v)
    dt = mat / n_t
    s_grid = torch.exp(x)
    intrinsic = torch.clamp_min(cp * (s_grid[None, :] - strike), 0.0).expand(n_v, n_x)
    # leverage on the ADI x-grid, one row per Monte Carlo substep (the rows
    # are indexed by relative log-spot)
    x_rows, l_rows = f32(x_rows), f32(l_rows)
    x_rel = x - torch.log(spot_f)
    lev_tab = torch.stack([_interp(x_rel, xr, lr) for xr, lr in zip(x_rows, l_rows)])
    rows = _slv_rows(float(maturity), n_dates, steps_per_date, x_rows.shape[0])
    v_stencil, i2 = _v_operator(v, gp, dxi, c_v, kap, th, sig, rate, dt)
    vj = v[:, None]
    w_mixed = (v[1:-1] / gp[1:-1])[:, None]
    bounds = _boundary(s_grid, intrinsic, strike, rate, dividend, cp, True)

    def step(vg, i: int):
        tau = (i + 1.0) * dt
        lev = lev_tab[rows[i]]
        x_ops = _x_operator(vj, (lev * lev)[None, :], rate, dividend, dx, dt, n_x)
        a0v = _mixed(vg, rho * sig * lev[None, 1:-1] * w_mixed, dx, dxi)
        return _douglas(vg, tau, (*x_ops, v_stencil, i2, a0v), bounds, dt)

    vg, cont_all = _bermudan_dates(step, intrinsic, n_dates, steps_per_date)
    price0 = _bilinear_at(vg, torch.log(spot_f), v0, x_lo, dx, dxi, c_v)
    return price0, cont_all, x_lo, dx, dxi, c_v
