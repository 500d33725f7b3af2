"""Heston PDE solver: Douglas ADI on a (log-spot, variance) grid.

The port of ``optionslab_tpu/models/heston_fdm.py``: European and American
options on the full 2-D Heston PDE

    V_t + (r-q-v/2) V_x + kappa(theta-v) V_v + v/2 V_xx
        + rho*sigma*v V_xv + sigma^2 v/2 V_vv - r V = 0,

in float32 on the device of the call (``device``, the card by default).

* This module builds the grids, the Douglas operators, the boundary table
  and the exercise value with torch; the time loop is ``ops/heston_adi.py``:
  one launch of its forward kernel a solve on the card (a tridiagonal solve
  along x and one along v each step, the mixed term an explicit stencil).
  The sinh-stretched variance grid and the frozen (detached) mesh are the
  reference's.
* :func:`heston_fdm_greeks` reads the spot/v0 ladder off a biquadratic
  readout of one solve (autograd with ``create_graph``), and the
  kappa/theta/sigma/rho/rate/maturity sensitivities from one reverse pass
  through a second solve: one launch of the reverse kernel, whose
  gradients torch chains through the operators' construction.
* :func:`_heston_adi_bermudan` and :func:`_slv_adi_bermudan` record the
  continuation slices at the exercise dates for the certified brackets
  (``heston_american``, ``slv_american``); the SLV loop rebuilds its
  x-operator every step from the frozen leverage rows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.heston_adi import (THETA_S, AdiOps, SlvLeverage, _ends, adi_bermudan, adi_loop,
                              x_operator)
from ..utils.exceptions import ValidationError
from .heston import HestonParams
from .slv import _interp

__all__ = ["heston_fdm_price", "heston_fdm_greeks"]


def _linspace(a, b, n: int) -> torch.Tensor:
    """``jnp.linspace(a, b, n)`` for 0-dim tensors: a·(1 − s) + b·s with
    s = k/(n−1), the end point exact."""
    s = torch.arange(n - 1, dtype=torch.float32, device=a.device) / (n - 1)
    return torch.cat([a * (1.0 - s) + b * s, b.reshape(1)])


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


def _boundary_table(s_grid, intrinsic, strike, rate, dividend, cp, dt, n_t: int,
                    american: bool):
    """(n_t, 2) Dirichlet values at x_lo / x_hi after each backward step,
    tau = (k + 1)·dt."""
    tau = (torch.arange(n_t, device=dt.device) + 1.0) * dt
    df_r = torch.exp(-rate * tau)
    df_q = torch.exp(-dividend * tau)
    lo_eu = torch.clamp_min(cp * (s_grid[0] * df_q - strike * df_r), 0.0)
    hi_eu = torch.clamp_min(cp * (s_grid[-1] * df_q - strike * df_r), 0.0)
    if american:
        lo_eu = torch.maximum(lo_eu, intrinsic[0, 0])
        hi_eu = torch.maximum(hi_eu, intrinsic[0, -1])
    return torch.stack([lo_eu, hi_eu], dim=1)


def _adi_setup(spot, strike, maturity, rate, dividend, cp, params: HestonParams, n_x: int,
               n_v: int, n_t: int, american: bool, device):
    """Grids, Douglas operators and the boundary table of the loop.
    Returns ``(ops, meta)`` with ``meta = (x_lo, dx, dxi, c_v)`` (v maps
    through ξ = asinh(v/c_v)); ``ops.intrinsic`` is the loop's start."""
    f32 = _f32(device)
    spot, strike, maturity, rate, dividend, cp = map(f32, (spot, strike, maturity, rate,
                                                           dividend, cp))
    kap, th, sig, rho, v0 = map(f32, (params.kappa, params.theta, params.sigma, params.rho,
                                      params.v0))
    x, dx, x_lo, v, gp, dxi, c_v = _geometry(spot, strike, maturity, kap, th, sig, v0, n_x, n_v)
    dt = maturity / n_t
    s_grid = torch.exp(x)
    intrinsic = torch.clamp_min(cp * (s_grid[None, :] - strike), 0.0).expand(n_v, n_x)
    x_stencil, x_sweep = x_operator(v[:, None], 1.0, rate, dividend, dx, dt, n_x)
    v_stencil, v_sweep = _v_operator(v, gp, dxi, c_v, kap, th, sig, rate, dt)
    mixed_coef = rho * sig * (v[1:-1] / gp[1:-1])[:, None]
    bounds = _boundary_table(s_grid, intrinsic, strike, rate, dividend, cp, dt, n_t, american)
    ops = AdiOps(x_stencil, x_sweep, v_stencil, v_sweep, mixed_coef, dt, 4.0 * dx * dxi, bounds,
                 intrinsic)
    return ops, (x_lo, dx, dxi, c_v)


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
    """The backward solve to t = 0, one loop of ``ops/heston_adi.py``:
    (grid, meta)."""
    ops, meta = _adi_setup(spot, strike, maturity, rate, dividend, cp, params, n_x, n_v, n_t,
                           american, device)
    return adi_loop(ops, ops.intrinsic, american), meta


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
    # solve (the loop's backward is one launch of the reverse kernel)
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


def _heston_adi_bermudan(spot, strike, maturity, rate, dividend, cp, params: HestonParams,
                         n_x: int, n_v: int, n_dates: int, steps_per_date: int, device):
    """Bermudan ADI: projection only at the ``n_dates`` exercise dates,
    recording the continuation slice at each just before it. Returns
    ``(price0, cont_all, x_lo, dx, dxi, c_v)``."""
    ops, (x_lo, dx, dxi, c_v) = _adi_setup(
        spot, strike, maturity, rate, dividend, cp, params, n_x, n_v, n_dates * steps_per_date,
        True, device)
    vg, cont_all = adi_bermudan(ops, ops.intrinsic, steps_per_date)
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


def _slv_setup(spot, strike, maturity, rate, dividend, cp, params: HestonParams, mixing, x_rows,
               l_rows, n_x: int, n_v: int, n_dates: int, steps_per_date: int, device):
    """The SLV loop's operands: ``(ops, slv, meta, v0)`` (the x-side built
    every step from ``slv``'s leverage rows; ``meta = (x_lo, dx, dxi, c_v)``)."""
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
    v_stencil, v_sweep = _v_operator(v, gp, dxi, c_v, kap, th, sig, rate, dt)
    bounds = _boundary_table(s_grid, intrinsic, strike, rate, dividend, cp, dt, n_t, True)
    ops = AdiOps(None, None, v_stencil, v_sweep, None, dt, 4.0 * dx * dxi, bounds, intrinsic)
    slv = SlvLeverage(lev_tab, tuple(rows), v[:, None], (v[1:-1] / gp[1:-1])[:, None],
                      rho * sig, rate, dividend, dx)
    return ops, slv, (x_lo, dx, dxi, c_v), v0


def _slv_adi_bermudan(spot, strike, maturity, rate, dividend, cp, params: HestonParams,
                      mixing, x_rows, l_rows, n_x: int, n_v: int, n_dates: int,
                      steps_per_date: int, device):
    """Bermudan ADI under the frozen-leverage SLV law: the x-diffusion is
    L(x, t)²·v and the mixed term ρσ·L·v, with L read from the same
    per-substep leverage rows the Monte Carlo replays (piecewise constant in
    time); the x-operator is rebuilt every step, the v-operator is static.
    Returns ``(price0, cont_all, x_lo, dx, dxi, c_v)``."""
    ops, slv, (x_lo, dx, dxi, c_v), v0 = _slv_setup(
        spot, strike, maturity, rate, dividend, cp, params, mixing, x_rows, l_rows, n_x, n_v,
        n_dates, steps_per_date, device)
    vg, cont_all = adi_bermudan(ops, ops.intrinsic, steps_per_date, slv)
    price0 = _bilinear_at(vg, torch.log(_f32(device)(spot)), v0, x_lo, dx, dxi, c_v)
    return price0, cont_all, x_lo, dx, dxi, c_v
