"""Exotic payoffs under Heston (and Bates) stochastic volatility: the scan
engine.

The port of ``optionslab_tpu/models/heston_exotics.py``. The steps are a
Python loop carrying (log-spot, variance, running statistics), so memory
holds O(paths) state and never (paths × steps). Variance transitions: full
truncation Euler or Andersen (2008) quadratic-exponential (``scheme="qe"``),
both branch-free; a :class:`~.bates.BatesParams` adds compound-Poisson
log-jumps with the −λ·k̄·dt martingale compensator. Draws come from an
explicit ``torch.Generator`` on the device where the paths live.

This is the statistical oracle of the kernel of
``ops/heston_exotic_kernel.py``: the tests hold the two to each other within
their standard errors (different generators), and both to the GBM engines
in the σ_v → 0, v0 = θ limit.
"""

from __future__ import annotations

import math

import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from .heston import _qe_transition

HESTON_EXOTIC_KINDS = (
    "asian_arith", "asian_geo", "lookback_float", "lookback_fixed",
    "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out",
    "barrier_down-and-in",
    "one_touch_up", "one_touch_down", "no_touch_up", "no_touch_down",
    # double kinds take barrier=(lower, upper)
    "barrier_double-out", "barrier_double-in",
    "one_touch_double", "no_touch_double",
    # pay-at-hit one-touches: unit cash discounted at the first hit
    "one_touch_up_hit", "one_touch_down_hit", "one_touch_double_hit",
)


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _jumps_of(params):
    """(λ, μ_J, σ_J) of a BatesParams, None for HestonParams."""
    return (params.lam, params.mu_j, params.sigma_j) if hasattr(params, "lam") else None


def _heston_scan(generator: torch.Generator, spot, maturity, rate, dividend, params, n_paths: int,
                 n_steps: int, init, update, scheme: str, antithetic: bool, jumps=None):
    """Scan (x, v, stats) through ``n_steps`` on ``generator``'s device;
    returns (S_T, stats).

    ``init(s0 vector) -> stats``; ``update(stats, s, i) -> stats`` with ``s``
    the spot vector after step ``i`` (averages over steps 1..n, as the GBM
    engines and the kernels). ``jumps=(λ, μ_J, σ_J)`` adds per step the jump
    N·μ_J + σ_J·√N·Z, N ~ Poisson(λ dt), exact in distribution."""
    if scheme not in ("euler", "qe"):
        raise ValidationError(f"scheme must be euler|qe, got {scheme!r}")
    dev = generator.device
    spot = _f32(spot, dev)
    half = n_paths // 2 if antithetic else n_paths
    n_eff = half * 2 if antithetic else n_paths
    t = torch.clamp_min(_f32(maturity, dev), EPS_TIME)
    dt = t / n_steps
    sqrt_dt = torch.sqrt(dt)
    kap, th, sig, rho = (_f32(getattr(params, k), dev) for k in ("kappa", "theta", "sigma", "rho"))
    srho = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0))
    mu_dt = (_f32(rate, dev) - _f32(dividend, dev)) * dt
    if jumps is not None:
        lam, mu_j, sigma_j = (_f32(x, dev) for x in jumps)
        kbar = torch.exp(mu_j + 0.5 * sigma_j**2) - 1.0
        mu_dt = mu_dt - lam * kbar * dt  # the jump-martingale compensator
        lam_dt = (lam * dt).expand(n_eff).contiguous()
    if scheme == "qe":
        emkd = torch.exp(-kap * dt)
        c1 = th * (1.0 - emkd)
        s2_v = sig**2 * emkd * (1.0 - emkd) / kap
        s2_0 = th * sig**2 * (1.0 - emkd) ** 2 / (2.0 * kap)
        k0 = -rho * kap * th * dt / sig
        k1 = 0.5 * dt * (kap * rho / sig - 0.5) - rho / sig
        k2 = 0.5 * dt * (kap * rho / sig - 0.5) + rho / sig
        k3 = 0.5 * dt * (1.0 - rho**2)
        k4 = 0.5 * dt * (1.0 - rho**2)

    def mirror(z):
        return torch.cat([z, -z]) if antithetic else z

    x = torch.zeros(n_eff, dtype=torch.float32, device=dev)
    v = _f32(params.v0, dev).expand(n_eff).clone()
    stats = init(spot.expand(n_eff))
    for i in range(n_steps):
        z = torch.randn((3 if jumps is not None else 2, half), generator=generator, device=dev)
        zv, zo = mirror(z[0]), mirror(z[1])
        jump = 0.0
        if jumps is not None:
            # Poisson counts are not mirrored by the antithetic pairing
            n_jump = torch.poisson(lam_dt, generator=generator)
            jump = n_jump * mu_j + sigma_j * torch.sqrt(n_jump) * mirror(z[2])
        if scheme == "qe":
            uh = torch.rand(half, generator=generator, device=dev) * (1.0 - 2e-7) + 1e-7
            u = torch.cat([uh, 1.0 - uh]) if antithetic else uh
            v_new = _qe_transition(v, zv, u, c1, emkd, s2_v, s2_0)
            # QE folds the correlation into the k-weights: the spot shock is
            # the independent normal zo (Andersen 2008, eq. 33)
            x = x + mu_dt + k0 + k1 * v + k2 * v_new \
                + torch.sqrt(torch.clamp_min(k3 * v + k4 * v_new, 0.0)) * zo + jump
            v = v_new
        else:
            zx = rho * zv + srho * zo
            vp = torch.clamp_min(v, 0.0)
            sq = torch.sqrt(vp)
            x = x + mu_dt - 0.5 * vp * dt + sq * sqrt_dt * zx + jump
            v = v + kap * (th - vp) * dt + sig * sq * sqrt_dt * zv
        stats = update(stats, spot * torch.exp(x), i)
    return spot * torch.exp(x), stats


def exotic_stat_fns(kind: str, cp: float, barrier, rdt=0.0):
    """(init, update) running-statistic pair of ``kind``: ``init(s0 vector)
    -> stat``; ``update(stat, s, i) -> stat`` with ``s`` the spot after step
    ``i``. Pay-at-hit kinds carry (hit flag, df at the first hit) and need
    ``rdt`` = rate·dt."""
    barrier_up = "up" in kind
    double = "double" in kind
    hit_pay = kind.endswith("_hit")
    if double:
        b_lo, b_hi = float(barrier[0]), float(barrier[1])
    else:
        b = float(barrier)

    def _hit(s):
        if double:
            return ((s <= b_lo) | (s >= b_hi)).to(torch.float32)
        return ((s >= b) if barrier_up else (s <= b)).to(torch.float32)

    def init(s0):
        if kind.startswith("asian"):
            return torch.zeros_like(s0)
        if kind.startswith("lookback"):
            return s0
        if hit_pay:
            h = _hit(s0)
            return (h, h)  # (hit, df at the first hit; df(0) = 1)
        return _hit(s0)

    def update(stat, s, i):
        if kind == "asian_arith":
            return stat + s
        if kind == "asian_geo":
            return stat + torch.log(s)
        if kind == "lookback_float":  # float call: min; float put: max
            return torch.minimum(stat, s) if cp > 0 else torch.maximum(stat, s)
        if kind == "lookback_fixed":  # fixed call: max; fixed put: min
            return torch.maximum(stat, s) if cp > 0 else torch.minimum(stat, s)
        if hit_pay:
            h, dfh = stat
            now = _hit(s)
            dfh = dfh + (1.0 - h) * now * math.exp(-float(rdt) * (i + 1.0))
            return (torch.maximum(h, now), dfh)
        return torch.maximum(stat, _hit(s))

    return init, update


def exotic_payoff(kind: str, cp: float, strike, n_steps: int, s_t, stat):
    """Terminal payoff from (S_T, running stat), the counterpart of
    :func:`exotic_stat_fns`."""
    knock_in = kind.endswith("in")
    if kind.endswith("_hit"):
        return stat[1]  # df at the hit carried in the stat (no terminal df)
    if kind == "asian_arith":
        return torch.clamp_min(cp * (stat / n_steps - strike), 0.0)
    if kind == "asian_geo":
        return torch.clamp_min(cp * (torch.exp(stat / n_steps) - strike), 0.0)
    if kind == "lookback_float":
        return s_t - stat if cp > 0 else stat - s_t
    if kind == "lookback_fixed":
        return torch.clamp_min(cp * (stat - strike), 0.0)
    if "touch" in kind:
        return stat if kind.startswith("one") else (1.0 - stat)
    vanilla = torch.clamp_min(cp * (s_t - strike), 0.0)
    return vanilla * (stat if knock_in else (1.0 - stat))


def _mean_stderr(pay: torch.Tensor, df: float):
    n = pay.shape[0]
    return df * pay.mean(), df * pay.std(correction=1) / math.sqrt(n)


def heston_exotic_price(kind: str, spot, strike, maturity, rate, params,
                        generator: torch.Generator, cp: float = 1.0, dividend: float = 0.0,
                        barrier=0.0, n_paths: int = 100_000, n_steps: int = 64,
                        scheme: str = "euler", antithetic: bool = True,
                        return_stderr: bool = False):
    """An exotic under Heston (or Bates, when ``params`` is a BatesParams)
    by the scan engine, on ``generator``'s device.

    ``kind`` ∈ :data:`HESTON_EXOTIC_KINDS`; the conventions are the GBM
    engines' (Asian averages over steps 1..n; lookback extrema include S0;
    barriers and touches monitored at every step; one-touches pay unit cash
    at expiry, ``_hit`` kinds at the first hit). Returns the price, or
    (price, stderr) with ``return_stderr=True``."""
    if kind not in HESTON_EXOTIC_KINDS:
        raise ValidationError(f"unknown heston exotic kind {kind!r}; choose {HESTON_EXOTIC_KINDS}")
    init, update = exotic_stat_fns(kind, float(cp), barrier,
                                   rdt=float(rate) * float(maturity) / n_steps)
    s_t, stat = _heston_scan(generator, spot, maturity, rate, dividend, params, n_paths, n_steps,
                             init, update, scheme, antithetic, jumps=_jumps_of(params))
    pay = exotic_payoff(kind, float(cp), float(strike), n_steps, s_t, stat)
    # pay-at-hit kinds carry the discount in the stat
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * float(maturity))
    price, stderr = _mean_stderr(pay, df)
    return (price, stderr) if return_stderr else price


def heston_range_accrual_price(spot, lower, upper, maturity, rate, params,
                               generator: torch.Generator, dividend: float = 0.0,
                               notional: float = 100.0, n_paths: int = 100_000,
                               n_steps: int = 252, scheme: str = "euler",
                               antithetic: bool = True, return_stderr: bool = False):
    """Range-accrual note (notional × fraction of steps with lower ≤ S ≤
    upper, paid at expiry) under Heston or Bates by the scan engine."""
    lower, upper = float(lower), float(upper)
    if not 0.0 < lower < upper:
        raise ValidationError("need 0 < lower < upper")

    def init(s0):
        return torch.zeros_like(s0)

    def update(stat, s, i):
        return stat + ((s >= lower) & (s <= upper)).to(torch.float32)

    _, acc = _heston_scan(generator, spot, maturity, rate, dividend, params, n_paths, n_steps,
                          init, update, scheme, antithetic, jumps=_jumps_of(params))
    price, stderr = _mean_stderr(float(notional) * acc / n_steps,
                                 math.exp(-float(rate) * float(maturity)))
    return (price, stderr) if return_stderr else price


def heston_cliquet_price(spot, maturity, rate, params, generator: torch.Generator,
                         dividend: float = 0.0, local_floor: float = -0.05,
                         local_cap: float = 0.05, global_floor: float = 0.0,
                         global_cap: float = 1e9, notional: float = 100.0, n_periods: int = 12,
                         n_paths: int = 100_000, n_steps: int = 252, scheme: str = "euler",
                         antithetic: bool = True, return_stderr: bool = False):
    """Cliquet/ratchet under Heston or Bates by the scan engine: the sum of
    the period returns, each clipped to [local_floor, local_cap], clipped
    to [global_floor, global_cap], times the notional."""
    if n_periods <= 0 or n_steps % n_periods:
        raise ValidationError("n_steps must be a positive multiple of n_periods")
    per = n_steps // n_periods

    def init(s0):
        return (s0, torch.zeros_like(s0))

    def update(stats, s, i):
        s_start, acc = stats
        if (i + 1) % per:
            return stats
        capped = torch.clamp(s / s_start - 1.0, float(local_floor), float(local_cap))
        return (s, acc + capped)

    _, (_, acc) = _heston_scan(generator, spot, maturity, rate, dividend, params, n_paths,
                               n_steps, init, update, scheme, antithetic,
                               jumps=_jumps_of(params))
    pay = float(notional) * torch.clamp(acc, float(global_floor), float(global_cap))
    price, stderr = _mean_stderr(pay, math.exp(-float(rate) * float(maturity)))
    return (price, stderr) if return_stderr else price


def heston_autocall_price(spot, maturity, rate, params, generator: torch.Generator,
                          dividend: float = 0.0, notional: float = 100.0,
                          autocall_barrier: float = 1.0, coupon_barrier: float = 0.8,
                          ki_barrier: float = 0.7, coupon_rate: float = 0.08, n_obs: int = 4,
                          n_paths: int = 100_000, n_steps: int = 252, scheme: str = "euler",
                          antithetic: bool = True, return_stderr: bool = False):
    """Autocallable/snowball note under Heston or Bates by the scan engine;
    barriers relative to spot, coupons and redemptions discounted at their
    dates."""
    if n_obs <= 0 or n_steps % n_obs:
        raise ValidationError("n_steps must be a positive multiple of n_obs")
    obs_every = n_steps // n_obs
    s0 = float(spot)
    dt = max(float(maturity), EPS_TIME) / n_steps
    coupon = float(notional) * float(coupon_rate) / n_obs

    def init(s):
        return (torch.ones_like(s, dtype=torch.bool), torch.zeros_like(s, dtype=torch.bool),
                torch.zeros_like(s))

    def update(stats, s, i):
        alive, ki, pv = stats
        ki = ki | (s <= float(ki_barrier) * s0)
        if (i + 1) % obs_every:
            return (alive, ki, pv)
        df = math.exp(-float(rate) * (i + 1) * dt)
        called = alive & (s >= float(autocall_barrier) * s0)
        couponed = alive & (s >= float(coupon_barrier) * s0)
        pv = pv + torch.where(couponed, df * coupon, 0.0) \
            + torch.where(called, df * float(notional), 0.0)
        return (alive & ~called, ki, pv)

    s_t, (alive, ki, pv) = _heston_scan(generator, spot, maturity, rate, dividend, params,
                                        n_paths, n_steps, init, update, scheme, antithetic,
                                        jumps=_jumps_of(params))
    df_t = math.exp(-float(rate) * float(maturity))
    loss = torch.clamp_max(s_t / s0, 1.0)
    final = torch.where(ki, float(notional) * loss, float(notional))
    price, stderr = _mean_stderr(pv + torch.where(alive, df_t * final, 0.0), 1.0)
    return (price, stderr) if return_stderr else price
