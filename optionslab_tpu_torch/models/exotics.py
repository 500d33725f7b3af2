"""Exotic options: closed-form oracles, a scan Monte Carlo engine, and the
dataclass façade over the scan engine and the fused kernels.

The port of ``optionslab_tpu/models/exotics.py``.

* Closed forms, in float64 unless given tensors of another dtype: the
  discrete geometric Asian, the discretely monitored range accrual, the
  continuously monitored double barrier and double no-touch (image
  expansion), and the one-touch at expiry or at hit.
* The scan engine carries (log-spot, running statistics) over the time
  steps in a Python loop, drawing its normals from an explicit
  ``torch.Generator`` (antithetic halves); it is differentiable, and
  :func:`exotic_greeks` takes its Greeks by ``torch.autograd``.
* The American Longstaff–Schwartz pricer regresses on the ITM paths with
  fixed-shape ITM-weighted normal equations, one small solve per date on
  the device.
* ``engine="pallas"`` on the dataclasses runs the fused kernels of
  ``ops/exotic_kernel.py`` on the instance's ``device``; ``engine="scan"``
  runs the scan engine there.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import exotic_kernel as ek
from ..ops.math import norm_cdf
from ..utils.exceptions import ValidationError
from .american import _forward_log_paths


def _f64(x) -> torch.Tensor:
    """A tensor argument as it is; a number as a float64 scalar tensor."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(float(x), dtype=torch.float64)


# ---------------------------------------------------------------------------
# Closed forms (the oracles)
# ---------------------------------------------------------------------------
def geometric_asian_closed_form(spot, strike, maturity, rate, vol, cp=1.0, dividend=0.0,
                                n_steps: int = 64):
    """Discrete geometric-average Asian: log(G/S0) is exactly
    Normal(μ_g, σ_g²) with μ_g = (r − q − σ²/2)·dt·(m+1)/2 and
    σ_g² = σ²·dt·(m+1)(2m+1)/(6m), priced by the Black formula on G."""
    spot, strike, t, rate, vol, dividend = map(_f64, (spot, strike, maturity, rate, vol,
                                                      dividend))
    m = float(n_steps)
    dt = t / m
    mu_g = (rate - dividend - 0.5 * vol**2) * dt * (m + 1.0) / 2.0
    var_g = vol**2 * dt * (m + 1.0) * (2.0 * m + 1.0) / (6.0 * m)
    sd = torch.sqrt(torch.clamp_min(var_g, 1e-30))
    fwd_g = spot * torch.exp(mu_g + 0.5 * var_g)
    d1 = (torch.log(spot / strike) + mu_g + var_g) / sd
    d2 = d1 - sd
    return torch.exp(-rate * t) * cp * (fwd_g * norm_cdf(cp * d1) - strike * norm_cdf(cp * d2))


def range_accrual_closed_form(spot, lower, upper, maturity, rate, vol, dividend=0.0,
                              notional=100.0, n_steps: int = 252):
    """Exact price of the discretely monitored range-accrual note under GBM:
    V = df·N·(1/n)·Σᵢ [Φ(d2(L, tᵢ)) − Φ(d2(U, tᵢ))],
    d2(K, t) = (ln(S0/K) + (r − q − σ²/2)t)/(σ√t)."""
    spot, t, rate, vol, dividend = map(_f64, (spot, maturity, rate, vol, dividend))
    t_i = torch.arange(1, n_steps + 1, dtype=t.dtype) * (t / n_steps)
    mu = rate - dividend - 0.5 * vol * vol
    sig_sq = vol * torch.sqrt(t_i)

    def d2(k):
        return (torch.log(spot / k) + mu * t_i) / sig_sq

    p_in = norm_cdf(d2(float(lower))) - norm_cdf(d2(float(upper)))
    return torch.exp(-rate * t) * notional * p_in.mean()


def _double_barrier_terms(spot, lower, upper, maturity, rate, vol, dividend, n_images: int):
    """Image-expansion pieces of the double-barrier closed forms.

    The density of x = ln(S_T/S0) absorbed at l = ln(L/S0) < 0 < u = ln(U/S0)
    is e^{νx − ν²s²/2}·q(x), ν = m/σ², s = σ√T, with the driftless absorbed
    density q(x) = Σₙ [φ_s(x − 2nD) − φ_s(x − 2u + 2nD)], D = u − l. Every
    payoff integral reduces to J_β(c) = ∫e^{βx}φ_s(x−c)dx over (lo, hi).
    Returns (l, u, s, ν, e^{−ν²s²/2}, j_integral)."""
    spot = _f64(spot)
    l = torch.log(lower / spot)
    u = torch.log(upper / spot)
    t = torch.clamp_min(_f64(maturity), 1e-12)
    s = vol * torch.sqrt(t)
    m = rate - dividend - 0.5 * vol * vol
    nu = m / (vol * vol)
    pref = torch.exp(-0.5 * nu * nu * s * s)
    delta = u - l

    def j_integral(beta, lo, hi):
        total = 0.0
        for n in range(-n_images, n_images + 1):
            for c, sign in ((2.0 * n * delta, 1.0), (2.0 * u - 2.0 * n * delta, -1.0)):
                amp = torch.exp(beta * c + 0.5 * beta * beta * s * s)
                total = total + sign * amp * (norm_cdf((hi - c - beta * s * s) / s)
                                              - norm_cdf((lo - c - beta * s * s) / s))
        return total

    return l, u, s, nu, pref, j_integral


def double_barrier_closed_form(spot, strike, lower, upper, maturity, rate, vol, cp=1.0,
                               dividend=0.0, knock: str = "out", n_images: int = 8):
    """Continuously monitored double-barrier option under GBM: knock-out by
    the image expansion, knock-in by in-out parity against Black–Scholes."""
    if knock not in ("out", "in"):
        raise ValidationError("knock must be 'out' or 'in'")
    if not 0.0 < lower < upper:
        raise ValidationError("need 0 < lower < upper")
    spot = _f64(spot)
    l, u, s, nu, pref, j_int = _double_barrier_terms(spot, lower, upper, maturity, rate, vol,
                                                     dividend, n_images)
    k = torch.log(strike / spot)
    df = torch.exp(-rate * _f64(maturity))
    if cp > 0:
        lo, hi = torch.maximum(l, k), u
    else:
        lo, hi = l, torch.minimum(u, k)
    lo = torch.minimum(lo, hi)  # empty exercise region → zero integral
    ko = df * pref * cp * (spot * j_int(nu + 1.0, lo, hi) - strike * j_int(nu, lo, hi))
    ko = torch.where((spot <= lower) | (spot >= upper), 0.0, ko)
    if knock == "out":
        return ko
    from .black_scholes import bs_price

    return bs_price(spot, _f64(strike), _f64(maturity), _f64(rate), _f64(vol), cp,
                    _f64(dividend)) - ko


def double_no_touch_closed_form(spot, lower, upper, maturity, rate, vol, dividend=0.0,
                                cash: float = 1.0, n_images: int = 8):
    """Continuously monitored double no-touch: ``cash`` at expiry iff the path
    never leaves (lower, upper). The double one-touch is df·cash − this."""
    if not 0.0 < lower < upper:
        raise ValidationError("need 0 < lower < upper")
    spot = _f64(spot)
    l, u, _s, nu, pref, j_int = _double_barrier_terms(spot, lower, upper, maturity, rate, vol,
                                                      dividend, n_images)
    df = torch.exp(-rate * _f64(maturity))
    p_stay = pref * j_int(nu, l, u)
    p_stay = torch.where((spot <= lower) | (spot >= upper), 0.0, torch.clamp(p_stay, 0.0, 1.0))
    return df * cash * p_stay


def one_touch_closed_form(spot, barrier, maturity, rate, vol, dividend=0.0, cash: float = 1.0,
                          pay: str = "expiry"):
    """Continuously monitored one-touch under GBM. ``pay="expiry"``: df·P(hit)
    by the reflection formula; ``pay="hit"``: cash at the first hit
    (Rubinstein–Reiner). A spot at or through the barrier pays at once."""
    if pay not in ("expiry", "hit"):
        raise ValidationError("pay must be 'expiry' or 'hit'")
    s = _f64(spot)
    b, t, sig = (torch.as_tensor(x, dtype=s.dtype) for x in (barrier, maturity, vol))
    sqt = sig * torch.sqrt(t)
    up = b >= s
    m = torch.log(b / s)
    hit0 = torch.where(up, m <= 0.0, m >= 0.0)
    if pay == "expiry":
        nu = rate - dividend - 0.5 * sig * sig
        arg1 = torch.where(up, (-m + nu * t), (m - nu * t)) / sqt
        p_hit = norm_cdf(arg1) + torch.exp(2.0 * nu * m / (sig * sig)) \
            * norm_cdf(torch.where(up, (-m - nu * t), (m + nu * t)) / sqt)
        df = torch.exp(-rate * t)
        return df * cash * torch.where(hit0, 1.0, torch.clamp(p_hit, 0.0, 1.0))
    mu = (rate - dividend - 0.5 * sig * sig) / (sig * sig)
    lam = torch.sqrt(mu * mu + 2.0 * rate / (sig * sig))
    eta = torch.where(up, -1.0, 1.0).to(s.dtype)
    z = m / sqt + lam * sqt
    ratio = b / s
    val = (ratio ** (mu + lam) * norm_cdf(eta * z)
           + ratio ** (mu - lam) * norm_cdf(eta * z - 2.0 * eta * lam * sqt))
    return cash * torch.where(hit0, 1.0, torch.clamp(val, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Scan engine
# ---------------------------------------------------------------------------
def _as(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.tensor(float(x), dtype=dtype, device=device)


def _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths, n_steps, init_stats,
              update, antithetic=True, dtype=torch.float32):
    """Simulate paths step by step; ``update(stats, s, i)`` folds the running
    statistics. Returns (terminal spots (n_paths,), final stats). Antithetic
    pairs are the two halves of the path axis. Differentiable in every
    market argument given as a tensor."""
    dev = generator.device
    spot, maturity, rate, dividend, vol = (_as(x, dtype, dev)
                                           for x in (spot, maturity, rate, dividend, vol))
    dt = maturity / n_steps
    drift = (rate - dividend - 0.5 * vol * vol) * dt
    sig_dt = vol * torch.sqrt(dt)
    half = n_paths // 2 if antithetic else n_paths
    n_eff = 2 * half if antithetic else n_paths
    log_s = torch.zeros(n_eff, dtype=dtype, device=dev)
    stats = init_stats(spot.expand(n_eff))
    for i in range(n_steps):
        z = torch.randn(half, generator=generator, dtype=dtype, device=dev)
        if antithetic:
            z = torch.cat([z, -z])
        log_s = log_s + drift + sig_dt * z
        stats = update(stats, spot * torch.exp(log_s), i)
    return spot * torch.exp(log_s), stats


def _discounted_mean_stderr(pay, rate, maturity):
    df = torch.exp(-_as(rate, pay.dtype, pay.device) * _as(maturity, pay.dtype, pay.device))
    return df * pay.mean(), df * pay.std(correction=1) / math.sqrt(pay.shape[0])


def _result(price, stderr, return_stderr):
    return (price, stderr) if return_stderr else price


def asian_price(spot, strike, maturity, rate, vol, generator, cp=1.0, dividend=0.0,
                n_paths: int = 100_000, n_steps: int = 64, averaging: str = "arithmetic",
                return_stderr: bool = False):
    """Fixed-strike Asian on the average over every step after t = 0."""
    if averaging not in ("arithmetic", "geometric"):
        raise ValidationError(f"averaging must be arithmetic|geometric, got {averaging}")
    geo = averaging == "geometric"
    _, acc = _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
                       torch.zeros_like, lambda acc, s, i: acc + (torch.log(s) if geo else s))
    avg = torch.exp(acc / n_steps) if geo else acc / n_steps
    pay = torch.clamp_min(cp * (avg - strike), 0.0)
    return _result(*_discounted_mean_stderr(pay, rate, maturity), return_stderr)


def _barrier_side(barrier_type: str):
    parts = barrier_type.split("-")
    if len(parts) != 3 or parts[0] not in ("up", "down") or parts[2] not in ("in", "out"):
        raise ValidationError(f"unknown barrier type {barrier_type!r}")
    return parts[0] == "up", parts[2] == "in"


def barrier_price(spot, strike, barrier, maturity, rate, vol, generator, cp=1.0, dividend=0.0,
                  n_paths: int = 100_000, n_steps: int = 64, barrier_type: str = "up-and-out",
                  rebate: float = 0.0, continuous: bool = False, return_stderr: bool = False):
    """Single barrier option. ``continuous=False``: discrete monitoring at
    every step. ``continuous=True``: the Brownian-bridge correction carries
    each path's survival probability, exp(−2·ln(B/S_t)·ln(B/S_{t+1})/(σ²Δt))
    being the crossing probability between monitoring dates."""
    up, knock_in = _barrier_side(barrier_type)

    def hit(s):
        return (s >= barrier) if up else (s <= barrier)

    if not continuous:
        terminal, crossed = _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths,
                                      n_steps, hit, lambda c, s, i: c | hit(s))
        survival = (~crossed).to(terminal.dtype)
    else:
        inv_sig2dt = 1.0 / max(float(vol) ** 2 * float(maturity) / n_steps, 1e-12)

        def update(stats, s, i):
            surv, s_prev = stats
            a = torch.log(barrier / torch.clamp_min(s_prev, 1e-12))
            b = torch.log(barrier / torch.clamp_min(s, 1e-12))
            p_cross = torch.where(hit(s), 1.0,
                                  torch.clamp(torch.exp(-2.0 * a * b * inv_sig2dt), 0.0, 1.0))
            return (surv * (1.0 - p_cross), s)

        terminal, (survival, _) = _gbm_scan(
            generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
            lambda s0: (torch.where(hit(s0), 0.0, 1.0).to(s0.dtype), s0), update)
    vanilla = torch.clamp_min(cp * (terminal - strike), 0.0)
    if knock_in:
        pay = vanilla * (1.0 - survival) + rebate * survival
    else:
        pay = vanilla * survival + rebate * (1.0 - survival)
    return _result(*_discounted_mean_stderr(pay, rate, maturity), return_stderr)


def lookback_price(spot, strike, maturity, rate, vol, generator, cp=1.0, dividend=0.0,
                   n_paths: int = 100_000, n_steps: int = 64, floating: bool = True,
                   return_stderr: bool = False):
    """Lookback on the running extrema. Floating: call S_T − min, put
    max − S_T. Fixed: call max − K, put K − min."""
    terminal, (mn, mx) = _gbm_scan(
        generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
        lambda s0: (s0, s0), lambda st, s, i: (torch.minimum(st[0], s), torch.maximum(st[1], s)))
    if floating:
        pay = terminal - mn if cp > 0 else mx - terminal
    else:
        pay = torch.clamp_min(mx - strike, 0.0) if cp > 0 else torch.clamp_min(strike - mn, 0.0)
    return _result(*_discounted_mean_stderr(pay, rate, maturity), return_stderr)


def autocallable_price(spot, maturity, rate, vol, generator, dividend=0.0,
                       notional: float = 100.0, autocall_barrier: float = 1.0,
                       coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                       coupon_rate: float = 0.08, n_obs: int = 4, n_paths: int = 100_000,
                       n_steps: int = 252, return_stderr: bool = False):
    """Autocall note: at each of ``n_obs`` dates the note redeems at par when
    S >= autocall·S0, coupons accrue while S >= coupon·S0, and a knock-in at
    ki·S0 turns the final redemption into a short put."""
    obs_every = n_steps // n_obs

    def update(stats, s, i):
        alive, ki, pv = stats
        ki = ki | (s <= ki_barrier * spot)
        is_obs = (i + 1) % obs_every == 0
        t_obs = (i + 1) // obs_every * obs_every * (maturity / n_steps)
        df = torch.exp(-_as(rate, s.dtype, s.device) * _as(t_obs, s.dtype, s.device))
        if is_obs:
            called = alive & (s >= autocall_barrier * spot)
            pv = pv + torch.where(alive & (s >= coupon_barrier * spot),
                                  df * notional * coupon_rate / n_obs, 0.0)
            pv = pv + torch.where(called, df * notional, 0.0)
            alive = alive & ~called
        return (alive, ki, pv)

    terminal, (alive, ki, pv) = _gbm_scan(
        generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
        lambda s0: (torch.ones_like(s0, dtype=torch.bool), torch.zeros_like(s0, dtype=torch.bool),
                    torch.zeros_like(s0)), update)
    df_t = torch.exp(-_as(rate, pv.dtype, pv.device) * _as(maturity, pv.dtype, pv.device))
    final = torch.where(ki, notional * torch.clamp_max(terminal / spot, 1.0), notional)
    pay = pv + torch.where(alive, df_t * final, 0.0)
    return _result(pay.mean(), pay.std(correction=1) / math.sqrt(pay.shape[0]), return_stderr)


def cliquet_price(spot, maturity, rate, vol, generator, dividend=0.0,
                  local_floor: float = -0.05, local_cap: float = 0.05,
                  global_floor: float = 0.0, global_cap: float = 1e9,
                  notional: float = 100.0, n_periods: int = 12, n_paths: int = 100_000,
                  n_steps: int = 252, return_stderr: bool = False):
    """Cliquet/ratchet: notional × the globally floored and capped sum of the
    locally floored and capped period returns."""
    per = n_steps // n_periods

    def update(stats, s, i):
        s_start, acc = stats
        if (i + 1) % per == 0:
            return (s, acc + torch.clamp(s / s_start - 1.0, local_floor, local_cap))
        return (s_start, acc)

    _, (_, acc) = _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
                            lambda s0: (s0, torch.zeros_like(s0)), update)
    pay = notional * torch.clamp(acc, global_floor, global_cap)
    return _result(*_discounted_mean_stderr(pay, rate, maturity), return_stderr)


def double_barrier_price(spot, strike, lower, upper, maturity, rate, vol, generator, cp=1.0,
                         dividend=0.0, n_paths: int = 100_000, n_steps: int = 64,
                         knock: str = "out", continuous: bool = False,
                         return_stderr: bool = False):
    """Double-barrier option. ``continuous=True`` multiplies in the two
    one-sided bridge non-crossing probabilities per step. Oracle:
    :func:`double_barrier_closed_form`."""
    if knock not in ("out", "in"):
        raise ValidationError("knock must be 'out' or 'in'")

    def out_of_band(s):
        return (s <= lower) | (s >= upper)

    if not continuous:
        terminal, crossed = _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths,
                                      n_steps, out_of_band, lambda c, s, i: c | out_of_band(s))
        survival = (~crossed).to(terminal.dtype)
    else:
        inv_sig2dt = 1.0 / max(float(vol) ** 2 * float(maturity) / n_steps, 1e-12)

        def p_cross(level, s_prev, s):
            a = torch.log(level / torch.clamp_min(s_prev, 1e-12))
            b = torch.log(level / torch.clamp_min(s, 1e-12))
            return torch.clamp(torch.exp(-2.0 * a * b * inv_sig2dt), 0.0, 1.0)

        def update(stats, s, i):
            surv, s_prev = stats
            p_stay = (1.0 - p_cross(upper, s_prev, s)) * (1.0 - p_cross(lower, s_prev, s))
            return (surv * torch.where(out_of_band(s), 0.0, p_stay), s)

        terminal, (survival, _) = _gbm_scan(
            generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
            lambda s0: (torch.where(out_of_band(s0), 0.0, 1.0).to(s0.dtype), s0), update)
    vanilla = torch.clamp_min(cp * (terminal - strike), 0.0)
    pay = vanilla * (survival if knock == "out" else (1.0 - survival))
    return _result(*_discounted_mean_stderr(pay, rate, maturity), return_stderr)


def _touch_scan(generator, spot, maturity, rate, vol, dividend, n_paths, n_steps, hit):
    """(terminal, hit flag, df at the first hit) of a discretely monitored touch."""
    rdt = float(rate) * float(maturity) / n_steps

    def init(s0):
        h = hit(s0).to(s0.dtype)
        return (h, h)  # df(0) = 1

    def update(stats, s, i):
        h, dfh = stats
        now = hit(s).to(s.dtype)
        return (torch.maximum(h, now), dfh + (1.0 - h) * now * math.exp(-rdt * (i + 1.0)))

    terminal, (h, dfh) = _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths,
                                   n_steps, init, update)
    return terminal, h, dfh


def _check_touch(touch: str, pay: str) -> None:
    if touch not in ("one", "no"):
        raise ValidationError("touch must be 'one' or 'no'")
    if pay not in ("expiry", "hit"):
        raise ValidationError("pay must be 'expiry' or 'hit'")
    if pay == "hit" and touch == "no":
        raise ValidationError("a no-touch pays at expiry by definition")


def _touch_result(h, dfh, cash, touch, pay, rate, maturity, return_stderr):
    if pay == "hit":  # discounted at the hit: no terminal df
        return _result(*_discounted_mean_stderr(cash * dfh, 0.0, maturity), return_stderr)
    pay_arr = cash * (h if touch == "one" else (1.0 - h))
    return _result(*_discounted_mean_stderr(pay_arr, rate, maturity), return_stderr)


def double_touch_price(spot, lower, upper, maturity, rate, vol, generator, dividend=0.0,
                       cash: float = 1.0, n_paths: int = 100_000, n_steps: int = 64,
                       touch: str = "no", pay: str = "expiry", return_stderr: bool = False):
    """Double one-touch / no-touch digital, discrete monitoring; ``pay="hit"``
    (one-touch only) pays at the first band exit."""
    _check_touch(touch, pay)
    _, h, dfh = _touch_scan(generator, spot, maturity, rate, vol, dividend, n_paths, n_steps,
                            lambda s: (s <= lower) | (s >= upper))
    return _touch_result(h, dfh, cash, touch, pay, rate, maturity, return_stderr)


def range_accrual_price(spot, lower, upper, maturity, rate, vol, generator, dividend=0.0,
                        notional=100.0, n_paths: int = 100_000, n_steps: int = 252,
                        antithetic: bool = True, return_stderr: bool = False):
    """Range-accrual (corridor) note by the scan engine."""
    if not 0.0 <= lower < upper:
        raise ValidationError("need 0 <= lower < upper")
    _, acc = _gbm_scan(generator, spot, maturity, rate, dividend, vol, n_paths, n_steps,
                       torch.zeros_like,
                       lambda st, s, i: st + ((s >= lower) & (s <= upper)).to(s.dtype),
                       antithetic)
    pay = notional * acc / n_steps
    return _result(*_discounted_mean_stderr(pay, rate, maturity), return_stderr)


def one_touch_price(spot, barrier, maturity, rate, vol, generator, dividend=0.0,
                    cash: float = 1.0, n_paths: int = 100_000, n_steps: int = 64,
                    touch: str = "one", pay: str = "expiry", return_stderr: bool = False):
    """Single one-touch / no-touch digital, discrete monitoring; the side is
    up when barrier >= spot."""
    _check_touch(touch, pay)
    up = float(barrier) >= float(spot)
    _, h, dfh = _touch_scan(generator, spot, maturity, rate, vol, dividend, n_paths, n_steps,
                            lambda s: (s >= barrier) if up else (s <= barrier))
    return _touch_result(h, dfh, cash, touch, pay, rate, maturity, return_stderr)


def barrier_rebate_price(spot, strike, barrier, maturity, rate, vol, generator, cp=1.0,
                         dividend=0.0, rebate: float = 1.0, n_paths: int = 100_000,
                         n_steps: int = 64, barrier_type: str = "up-and-out",
                         return_stderr: bool = False):
    """Barrier option with the market rebate conventions on shared paths: a
    knock-out pays ``rebate`` at the first hit, a knock-in pays it at expiry
    if never knocked in. Discrete monitoring."""
    up, knock_in = _barrier_side(barrier_type)
    terminal, h, dfh = _touch_scan(generator, spot, maturity, rate, vol, dividend, n_paths,
                                   n_steps, lambda s: (s >= barrier) if up else (s <= barrier))
    df_t = torch.exp(-_as(rate, terminal.dtype, terminal.device)
                     * _as(maturity, terminal.dtype, terminal.device))
    vanilla = torch.clamp_min(cp * (terminal - strike), 0.0)
    if knock_in:
        pay = df_t * (vanilla * h + rebate * (1.0 - h))
    else:
        pay = df_t * vanilla * (1.0 - h) + rebate * dfh
    return _result(pay.mean(), pay.std(correction=0) / math.sqrt(pay.shape[0]), return_stderr)


# ---------------------------------------------------------------------------
# American via Longstaff–Schwartz
# ---------------------------------------------------------------------------
def _lsm_paths(generator, spot, maturity, rate, vol, dividend, n_paths, n_dates):
    """(n_dates, n_paths) float32 GBM spots at the exercise dates, antithetic
    halves, on the generator's device."""
    dt = maturity / n_dates
    drift = (rate - dividend - 0.5 * vol * vol) * dt
    return spot * torch.exp(_forward_log_paths(generator, n_paths, n_dates, drift,
                                               vol * math.sqrt(dt), torch.float32))


def _lsm_backward(s_paths, strike, rate, dt, cp, basis, on_date=None):
    """The Longstaff–Schwartz backward pass. Each date regresses the
    discounted cash flow on polynomials in the centred moneyness S/K − 1
    over the in-the-money paths: ITM-weighted normal equations of fixed
    shape, solved on the device without a host check. Calls
    ``on_date(spots, exercise mask)`` from the last date but one down to
    the first; returns the cash flows discounted to the first date."""
    n_dates, n_paths = s_paths.shape
    disc = math.exp(-rate * dt)
    ridge = 1e-8 * torch.eye(basis + 1, device=s_paths.device)
    cash = torch.clamp_min(cp * (s_paths[-1] - strike), 0.0)
    for idx in range(n_dates - 2, -1, -1):
        s = s_paths[idx]
        ex = torch.clamp_min(cp * (s - strike), 0.0)
        itm = ex > 0
        x = s / strike - 1.0
        feats = torch.stack([x**p for p in range(basis + 1)])  # (b+1, paths)
        fw = feats * itm.to(feats.dtype)
        y = disc * cash
        a_mat = (fw @ feats.T) / n_paths
        b_vec = (fw @ y) / n_paths
        coef = torch.linalg.solve_ex(a_mat + ridge, b_vec[:, None])[0][:, 0]
        exercise = itm & (ex > coef @ feats)
        cash = torch.where(exercise, ex, y)
        if on_date is not None:
            on_date(s, exercise)
    return cash


def american_lsm_price(spot, strike, maturity, rate, vol, generator: torch.Generator, cp=-1.0,
                       dividend=0.0, n_paths: int = 100_000, n_dates: int = 50, basis: int = 3,
                       return_stderr: bool = False):
    """Longstaff–Schwartz American price (float32, on the generator's
    device), floored at the intrinsic value; the uncertified lower-bound
    estimate (``models/american.py`` brackets it)."""
    maturity, rate, vol = float(maturity), float(rate), float(vol)
    dt = maturity / n_dates
    s_paths = _lsm_paths(generator, spot, maturity, rate, vol, dividend, n_paths, n_dates)
    pay = math.exp(-rate * dt) * _lsm_backward(s_paths, strike, rate, dt, cp, basis)
    price = torch.clamp_min(pay.mean(), max(cp * (float(spot) - float(strike)), 0.0))
    stderr = pay.std(correction=1) / math.sqrt(pay.shape[0])
    return (price, stderr) if return_stderr else price


def lsm_exercise_boundary(spot, strike, maturity, rate, vol, generator: torch.Generator,
                          cp=-1.0, dividend=0.0, n_paths: int = 50_000, n_dates: int = 50):
    """Early-exercise boundary estimate at each date but the last (n_dates
    − 1 entries, earliest first): the highest exercised spot of a put, the
    lowest of a call, NaN where no path exercised."""
    maturity, rate, vol = float(maturity), float(rate), float(vol)
    dt = maturity / n_dates
    s_paths = _lsm_paths(generator, spot, maturity, rate, vol, dividend, n_paths, n_dates)
    rows = []

    def record(s, exercise):
        if cp < 0:
            edge = torch.where(exercise, s, -math.inf).max()
        else:
            edge = torch.where(exercise, s, math.inf).min()
        rows.append(torch.where(exercise.any(), edge, math.nan))

    _lsm_backward(s_paths, strike, rate, dt, cp, 3, record)
    return torch.stack(rows[::-1])


def exotic_greeks(price_fn, spot, vol, rate, maturity, **kwargs) -> dict:
    """delta/vega/rho/theta of a scan-engine price by ``torch.autograd``.

    ``price_fn(spot, vol, rate, maturity) -> price`` must be built on the
    scan engine (pathwise derivatives; barrier indicators have none)."""
    args = [torch.tensor(float(x), dtype=torch.float32, requires_grad=True)
            for x in (spot, vol, rate, maturity)]
    with torch.enable_grad():
        price = price_fn(*args, **kwargs)
        grads = torch.autograd.grad(price, args)
    return {"price": price.detach(), "delta": grads[0], "vega": grads[1], "rho": grads[2],
            "theta": -grads[3]}


# ---------------------------------------------------------------------------
# Dataclass façade: engine="scan" (autograd-capable) | "pallas" (the kernels)
# ---------------------------------------------------------------------------
def _cp(option_type: str) -> float:
    return 1.0 if option_type == "call" else -1.0


@dataclasses.dataclass
class _Exotic:
    def _generator(self) -> torch.Generator:
        return torch.Generator(device=torch.device(self.device)).manual_seed(self.seed)

    def _kernel_out(self, out, return_stderr):
        price, se, _ = out
        return (price, se) if return_stderr else price


@dataclasses.dataclass
class AsianOption(_Exotic):
    spot: float
    strike: float
    maturity: float
    rate: float
    vol: float
    option_type: str = "call"
    dividend: float = 0.0
    averaging: str = "arithmetic"
    n_paths: int = 100_000
    n_steps: int = 64
    seed: int = 0
    engine: str = "scan"
    device: str = "cuda"

    def _kind(self) -> str:
        return "asian_arith" if self.averaging == "arithmetic" else "asian_geo"

    def price(self, return_stderr: bool = False):
        if self.engine == "pallas":
            return self._kernel_out(ek.exotic_price(
                self._kind(), self.spot, self.strike, self.maturity, self.rate, self.vol,
                _cp(self.option_type), self.dividend, n_paths=self.n_paths,
                n_steps=self.n_steps, seed=self.seed, device=self.device), return_stderr)
        return asian_price(self.spot, self.strike, self.maturity, self.rate, self.vol,
                           self._generator(), _cp(self.option_type), self.dividend,
                           self.n_paths, self.n_steps, self.averaging, return_stderr)

    def greeks(self) -> dict:
        cp = _cp(self.option_type)
        if self.engine == "pallas":
            return ek.exotic_greeks(self._kind(), self.spot, self.strike, self.maturity,
                                    self.rate, self.vol, cp, self.dividend,
                                    n_paths=self.n_paths, n_steps=self.n_steps,
                                    seed=self.seed, device=self.device)
        return exotic_greeks(
            lambda s, v, r, t: asian_price(s, self.strike, t, r, v, self._generator(), cp,
                                           self.dividend, self.n_paths, self.n_steps,
                                           self.averaging),
            self.spot, self.vol, self.rate, self.maturity)


@dataclasses.dataclass
class BarrierOption(_Exotic):
    spot: float
    strike: float
    barrier: float
    maturity: float
    rate: float
    vol: float
    option_type: str = "call"
    barrier_type: str = "up-and-out"
    rebate: float = 0.0
    dividend: float = 0.0
    n_paths: int = 100_000
    n_steps: int = 64
    seed: int = 0
    engine: str = "scan"
    continuous: bool = False  # Brownian-bridge correction
    device: str = "cuda"

    def price(self, return_stderr: bool = False):
        if self.engine == "pallas" and self.rebate == 0.0 and not self.continuous:
            return self._kernel_out(ek.exotic_price(
                f"barrier_{self.barrier_type}", self.spot, self.strike, self.maturity,
                self.rate, self.vol, _cp(self.option_type), self.dividend,
                barrier=self.barrier, n_paths=self.n_paths, n_steps=self.n_steps,
                seed=self.seed, device=self.device), return_stderr)
        return barrier_price(self.spot, self.strike, self.barrier, self.maturity, self.rate,
                             self.vol, self._generator(), _cp(self.option_type), self.dividend,
                             self.n_paths, self.n_steps, self.barrier_type, self.rebate,
                             self.continuous, return_stderr)


@dataclasses.dataclass
class LookbackOption(_Exotic):
    spot: float
    strike: float
    maturity: float
    rate: float
    vol: float
    option_type: str = "call"
    floating: bool = True
    dividend: float = 0.0
    n_paths: int = 100_000
    n_steps: int = 64
    seed: int = 0
    engine: str = "scan"
    device: str = "cuda"

    def _kind(self) -> str:
        return "lookback_float" if self.floating else "lookback_fixed"

    def price(self, return_stderr: bool = False):
        if self.engine == "pallas":
            return self._kernel_out(ek.exotic_price(
                self._kind(), self.spot, self.strike, self.maturity, self.rate, self.vol,
                _cp(self.option_type), self.dividend, n_paths=self.n_paths,
                n_steps=self.n_steps, seed=self.seed, device=self.device), return_stderr)
        return lookback_price(self.spot, self.strike, self.maturity, self.rate, self.vol,
                              self._generator(), _cp(self.option_type), self.dividend,
                              self.n_paths, self.n_steps, self.floating, return_stderr)

    def greeks(self) -> dict:
        cp = _cp(self.option_type)
        if self.engine == "pallas":
            return ek.exotic_greeks(self._kind(), self.spot, self.strike, self.maturity,
                                    self.rate, self.vol, cp, self.dividend,
                                    n_paths=self.n_paths, n_steps=self.n_steps,
                                    seed=self.seed, device=self.device)
        return exotic_greeks(
            lambda s, v, r, t: lookback_price(s, self.strike, t, r, v, self._generator(), cp,
                                              self.dividend, self.n_paths, self.n_steps,
                                              self.floating),
            self.spot, self.vol, self.rate, self.maturity)


@dataclasses.dataclass
class AmericanOptionLSM(_Exotic):
    spot: float
    strike: float
    maturity: float
    rate: float
    vol: float
    option_type: str = "put"
    dividend: float = 0.0
    n_paths: int = 100_000
    n_dates: int = 50
    seed: int = 0
    device: str = "cuda"

    def price(self, return_stderr: bool = False):
        return american_lsm_price(self.spot, self.strike, self.maturity, self.rate, self.vol,
                                  self._generator(), _cp(self.option_type), self.dividend,
                                  self.n_paths, self.n_dates, return_stderr=return_stderr)

    def exercise_boundary(self):
        return lsm_exercise_boundary(self.spot, self.strike, self.maturity, self.rate, self.vol,
                                     self._generator(), _cp(self.option_type), self.dividend,
                                     self.n_paths, self.n_dates)


@dataclasses.dataclass
class AutocallableNote(_Exotic):
    spot: float
    maturity: float
    rate: float
    vol: float
    dividend: float = 0.0
    notional: float = 100.0
    autocall_barrier: float = 1.0
    coupon_barrier: float = 0.8
    ki_barrier: float = 0.7
    coupon_rate: float = 0.08
    n_obs: int = 4
    n_paths: int = 100_000
    n_steps: int = 252
    seed: int = 0
    engine: str = "scan"
    device: str = "cuda"

    def price(self, return_stderr: bool = False):
        terms = (self.notional, self.autocall_barrier, self.coupon_barrier, self.ki_barrier,
                 self.coupon_rate, self.n_obs)
        if self.engine == "pallas":
            return self._kernel_out(ek.autocall_price(
                self.spot, self.maturity, self.rate, self.vol, self.dividend, *terms,
                n_paths=self.n_paths, n_steps=self.n_steps, seed=self.seed,
                device=self.device), return_stderr)
        return autocallable_price(self.spot, self.maturity, self.rate, self.vol,
                                  self._generator(), self.dividend, *terms, self.n_paths,
                                  self.n_steps, return_stderr)


@dataclasses.dataclass
class CliquetOption(_Exotic):
    spot: float
    maturity: float
    rate: float
    vol: float
    dividend: float = 0.0
    local_floor: float = -0.05
    local_cap: float = 0.05
    global_floor: float = 0.0
    global_cap: float = 1e9
    notional: float = 100.0
    n_periods: int = 12
    n_paths: int = 100_000
    n_steps: int = 252
    seed: int = 0
    engine: str = "scan"
    device: str = "cuda"

    def price(self, return_stderr: bool = False):
        terms = (self.local_floor, self.local_cap, self.global_floor, self.global_cap,
                 self.notional, self.n_periods)
        if self.engine == "pallas":
            return self._kernel_out(ek.cliquet_price(
                self.spot, self.maturity, self.rate, self.vol, self.dividend, *terms,
                n_paths=self.n_paths, n_steps=self.n_steps, seed=self.seed,
                device=self.device), return_stderr)
        return cliquet_price(self.spot, self.maturity, self.rate, self.vol, self._generator(),
                             self.dividend, *terms, self.n_paths, self.n_steps, return_stderr)


def price_asian_option(S, K, T, r, sigma, option_type="call", **kw):
    return AsianOption(S, K, T, r, sigma, option_type, **kw).price()


def price_barrier_option(S, K, B, T, r, sigma, option_type="call", barrier_type="up-and-out",
                         **kw):
    return BarrierOption(S, K, B, T, r, sigma, option_type, barrier_type, **kw).price()


def price_american_lsm(S, K, T, r, sigma, option_type="put", **kw):
    return AmericanOptionLSM(S, K, T, r, sigma, option_type, **kw).price()


def price_lookback_option(S, K, T, r, sigma, option_type="call", floating=True, **kw):
    return LookbackOption(S, K, T, r, sigma, option_type, floating, **kw).price()
