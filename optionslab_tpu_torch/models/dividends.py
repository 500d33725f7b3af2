"""Discrete cash dividends: PDE jump conditions and exact between-date Monte
Carlo.

The port of ``optionslab_tpu/models/dividends.py``. GBM between ex-dates; at
each ex-date the spot drops S -> max(S - D, 0).

* :func:`fdm_price_discrete_dividends` — the θ = 1/2 scheme on the log-spot
  grid of ``models/fdm.py`` (Howard's policy iteration for the American)
  with the jump condition V(S, t_d^-) = V(S - D, t_d^+) applied by
  interpolation at the step whose time level crosses t_d: the whole loop
  one :func:`theta_loop` with a jump table, one launch of
  ``csrc/theta_pde.cu`` on the card. European and American, float32, on
  ``device``.
* :func:`mc_price_discrete_dividends` — exact simulation, one lognormal
  factor per inter-dividend interval, antithetic, from one
  ``torch.Generator`` on ``device``; simulated in float32, reduced in
  float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.theta_pde import EUROPEAN, HOWARD, Jumps, theta_loop
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from .fdm import _grid, _read_price
from .slv import _interp_table

__all__ = ["fdm_price_discrete_dividends", "mc_price_discrete_dividends",
           "dividend_parity_gap"]


def _check_divs(dividends, maturity):
    if not dividends:
        return np.zeros(0), np.zeros(0)
    t = np.asarray([d[0] for d in dividends], np.float64)
    a = np.asarray([d[1] for d in dividends], np.float64)
    if np.any(a < 0):
        raise ValidationError("dividend amounts must be non-negative")
    if np.any(t <= 0) or np.any(t >= maturity):
        raise ValidationError("dividend dates must lie strictly inside (0, maturity)")
    order = np.argsort(t)
    return t[order], a[order]


def _fdm_div_operands(spot, strike, maturity, rate, vol, div_amounts, *, cp: float,
                      n_space: int, n_time: int, american: bool, div_steps: tuple, device):
    """The grid and the arguments of :func:`theta_loop` (but the mode) of the
    backward θ = 1/2 scheme with the dividend shifts at fixed steps
    (``div_steps``: the step after which the new time level has crossed that
    dividend's date, backward from T): (x, spot, ops, the jump table or
    None). The per-step end values are one table, formed by the per-step
    loop's elementwise operations on all the steps at once (the step's k + 1
    is exact in float32, so each entry rounds as that step's did)."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).reshape(1)  # noqa: E731
    spot, strike, maturity, rate, vol = map(f32, (spot, strike, maturity, rate, vol))
    t = torch.clamp_min(maturity, EPS_TIME)
    # widen the grid down: the pre-dividend region needs S - sum(D)
    x, dx = _grid(spot, vol, maturity, n_space, 7.0, strike)
    s_nodes = torch.exp(x)  # (1, n)
    dt = t / n_time
    sig2 = vol * vol
    mu = rate - 0.5 * sig2
    theta_s = 0.5
    a = 0.5 * sig2 / dx**2 - 0.5 * mu / dx
    b = -sig2 / dx**2 - rate
    c = 0.5 * sig2 / dx**2 + 0.5 * mu / dx
    intrinsic = torch.clamp_min(cp * (s_nodes - strike), 0.0)
    ones = torch.ones_like(s_nodes)
    edge = torch.zeros_like(s_nodes, dtype=torch.bool)
    edge[:, 0] = edge[:, -1] = True
    lo = torch.where(edge, 0.0, -theta_s * dt * a * ones)
    di = torch.where(edge, 1.0, 1.0 - theta_s * dt * b * ones)
    up = torch.where(edge, 0.0, -theta_s * dt * c * ones)
    amounts = [float(d) for d in div_amounts]
    # forward times of the dividends, for the PV of those still to come
    div_t = [t - dt * (k + 1.0) for k in div_steps]
    tau = torch.arange(1, n_time + 1, dtype=torch.float32, device=device) * dt  # (k + 1)·dt
    t_now = t - tau
    rem = 0.0
    for td, amt in zip(div_t, amounts):
        rem = rem + torch.where(td > t_now, amt * torch.exp(-rate * (td - t_now)), 0.0)
    low = (0.0 if cp > 0 else strike * torch.exp(-rate * tau) - (s_nodes[:, 0] - rem)) + \
        torch.zeros_like(tau)
    high = (s_nodes[:, -1] - rem - strike * torch.exp(-rate * tau) if cp > 0 else 0.0) + \
        torch.zeros_like(tau)
    if american:
        low = torch.maximum(low, intrinsic[:, 0])
        high = torch.maximum(high, intrinsic[:, -1])
    ends = torch.stack([torch.clamp_min(low, 0.0), torch.clamp_min(high, 0.0)], dim=-1)[None]
    # the jump condition V(S, t_d^-) = V(max(S - D, S_min), t_d^+) at each
    # dividend's step: _interp's gather table on the grid (None: no jump)
    shifts = [(k, d) for k, d in zip(div_steps, amounts) if d > 0.0]
    table = None
    if shifts:
        codes, weights = zip(*(_interp_table(torch.clamp_min(s_nodes[0] - d, s_nodes[0, 0]),
                                             s_nodes[0]) for _, d in shifts))
        table = Jumps(tuple(k for k, _ in shifts), torch.stack(codes)[None],
                      torch.stack(weights)[None])
    w = (1.0 - theta_s) * dt
    col = lambda z: z.reshape(1, 1)  # noqa: E731
    ops = (lo, di, up, col(a), col(b), col(c), col(w), intrinsic, intrinsic, ends)
    return x, spot, ops, table


def _fdm_div_single(spot, strike, maturity, rate, vol, div_amounts, *, cp: float, n_space: int,
                    n_time: int, american: bool, div_steps: tuple, device):
    """Backward θ = 1/2 scheme with the dividend shifts at fixed steps: one
    :func:`theta_loop` with a jump table (European, or Howard's obstacle
    step for the American)."""
    x, spot, ops, jumps = _fdm_div_operands(
        spot, strike, maturity, rate, vol, div_amounts, cp=cp, n_space=n_space, n_time=n_time,
        american=american, div_steps=div_steps, device=device)
    v = theta_loop(*ops, HOWARD if american else EUROPEAN, jumps=jumps)
    return _read_price(v, x, spot)[0]


def _div_steps(div_times, maturity: float, n_time: int) -> tuple:
    """The step whose new time level sits just past each ex-date (backward):
    tau crosses T - t_d at k = round((T - t_d)/dt) - 1."""
    dt = maturity / n_time
    steps = tuple(int(np.clip(np.round((maturity - tdi) / dt) - 1, 0, n_time - 1))
                  for tdi in div_times)
    if len(set(steps)) != len(steps):
        raise ValidationError("dividend dates too close for the time grid; raise n_time")
    return steps


def fdm_price_discrete_dividends(spot, strike, maturity, rate, vol, dividends, cp: float = 1.0,
                                 american: bool = False, n_space: int = 401,
                                 n_time: int = 400, device="cuda") -> float:
    """PDE price with discrete cash dividends [(t_i, D_i), ...] on
    ``device``. European or American; the American call captures exercise
    just before each ex-date."""
    td, da = _check_divs(dividends, float(maturity))
    if n_space % 2 == 0:
        raise ValidationError("n_space must be odd")
    steps = _div_steps(td, float(maturity), n_time)
    return float(_fdm_div_single(
        float(spot), float(strike), float(maturity), float(rate), float(vol),
        np.asarray(da, np.float32), cp=float(cp), n_space=n_space, n_time=n_time,
        american=american, div_steps=steps, device=torch.device(device)))


def _mc_div_core(spot, strike, maturity, rate, vol, div_t, div_a, generator, *, cp: float,
                 n_paths: int, device):
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    spot, strike, maturity, rate, vol = map(f32, (spot, strike, maturity, rate, vol))
    div_t, div_a = f32(div_t), f32(div_a)
    m = div_t.shape[0]
    bounds = torch.cat([torch.zeros(1, dtype=torch.float32, device=device), div_t,
                        maturity.reshape(1)])
    dts = torch.diff(bounds)  # (m+1,)
    half = n_paths // 2
    z = torch.randn((half, m + 1), generator=generator, dtype=torch.float32, device=device)
    z = torch.cat([z, -z])
    growth = torch.exp((rate - 0.5 * vol * vol) * dts[None, :]
                       + vol * torch.sqrt(dts)[None, :] * z)
    s = torch.full((n_paths,), float(spot), dtype=torch.float32, device=device)
    for i in range(m + 1):
        s = s * growth[:, i]
        if i < m:
            s = torch.clamp_min(s - div_a[i], 0.0)
    # simulated in float32, reduced in float64: the parity identity
    # C - P = S0 - PV(divs) - K df then holds to ~1e-4
    pay = torch.clamp_min(cp * (s - strike), 0.0).to(torch.float64)
    disc = torch.exp(-rate.to(torch.float64) * maturity)
    return disc * pay.mean(), disc * pay.std(correction=0) / math.sqrt(n_paths)


def mc_price_discrete_dividends(spot, strike, maturity, rate, vol, dividends, cp: float = 1.0,
                                n_paths: int = 262_144, seed: int = 0, device="cuda"):
    """Exact Monte Carlo with cash dividends, European: (price, stderr) as
    Python floats, the paths drawn on ``device`` from a generator seeded with
    ``seed``."""
    td, da = _check_divs(dividends, float(maturity))
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return tuple(float(x) for x in _mc_div_core(
        float(spot), float(strike), float(maturity), float(rate), float(vol),
        np.asarray(td, np.float32), np.asarray(da, np.float32), gen, cp=float(cp),
        n_paths=n_paths, device=dev))


def dividend_parity_gap(call, put, spot, strike, maturity, rate, dividends):
    """|C - P - (S0 - PV(divs) - K e^{-rT})|, the exact European identity with
    deterministic cash dividends (absorption aside)."""
    pv = sum(d * np.exp(-rate * t) for t, d in dividends)
    return abs(call - put - (spot - pv - strike * np.exp(-rate * maturity)))
