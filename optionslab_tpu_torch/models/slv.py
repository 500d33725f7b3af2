"""Stochastic local volatility (SLV): Heston variance × Dupire leverage.

    dS/S = (r − q) dt + L(t, S) √v dW_S
    dv   = κ(θ − v) dt + η·σ √v dW_v,      d⟨W_S, W_v⟩ = ρ dt

The port of ``optionslab_tpu/models/slv.py``. By Gyöngy's lemma vanillas
reprice exactly iff L²(t, S) = σ_LV²(t, S) / E[v_t | S_t = S]; ``mixing``
(η) runs from pure local vol (0) to the full Heston vol-of-vol (1), and
exotics move with it while vanillas stay pinned.

The calibration is the particle method of Guyon & Henry-Labordère: one loop
over the steps carries the particle cloud (log-spot, variance); each step
estimates E[v | S] by a fixed-width binned regression (``n_bins`` bins of
standardised log-moneyness, a counts-weighted 3-tap smoother for thin bins)
and reads the leverage row back per particle by linear interpolation,
clamped at the row's ends. The bins are summed in a fixed order (one masked
sum per bin, no scatter atomics), so one seed gives one leverage table bit
for bit on any device. Draws come from an explicit ``torch.Generator`` on
the device where the particles live; payoff conventions are those of
``models/heston_exotics.py``.
"""

from __future__ import annotations

import math

import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from .heston import HestonParams
from .heston_exotics import HESTON_EXOTIC_KINDS, _mean_stderr, exotic_payoff, exotic_stat_fns
from .local_vol import DupireLocalVol, LocalVolSurface, _bilinear

__all__ = ["SLVModel", "slv_exotic_price", "slv_calibrate_leverage", "slv_replay_price",
           "slv_cliquet_price", "slv_autocall_price", "slv_range_accrual_price",
           "slv_variance_swap", "slv_swap_strikes", "SLV_KINDS"]

SLV_KINDS = ("european",) + HESTON_EXOTIC_KINDS

_Z_MAX = 4.0          # the bin grid spans mean ± 4 cross-sectional stds
_COND_FLOOR = 1e-6    # floor on E[v|S] before the root
_LEV_MAX = 50.0       # leverage cap (guards empty-tail pathologies)


def _conditional_variance(x, vp, n_bins: int):
    """Binned Nadaraya–Watson estimate of E[v | x] on the particle cloud:
    (bin centres in log-spot (n_bins,), smoothed conditional mean
    (n_bins,)); thin bins borrow their neighbours' mass, empty ones take the
    global mean. Each bin is one masked sum (a fixed-order reduction)."""
    m = x.mean()
    s = torch.clamp_min(x.std(correction=0), 1e-6)
    width = 2.0 * _Z_MAX / n_bins
    z = (x - m) / s
    idx = torch.clamp(torch.floor((z + _Z_MAX) / width), 0, n_bins - 1).to(torch.int64)
    onehot = idx.unsqueeze(0) == torch.arange(n_bins, device=x.device).unsqueeze(1)
    counts = onehot.sum(dim=1).to(vp.dtype)
    vsum = torch.where(onehot, vp.unsqueeze(0), 0.0).sum(dim=1)

    def tap3(a):
        return a + torch.cat([a[:1], a[:-1]]) + torch.cat([a[1:], a[-1:]])

    counts_s, vsum_s = tap3(counts), tap3(vsum)
    cond = torch.where(counts_s > 0, vsum_s / torch.clamp_min(counts_s, 1.0), vp.mean())
    z_centers = -_Z_MAX + (torch.arange(n_bins, dtype=x.dtype, device=x.device) + 0.5) * width
    return m + s * z_centers, cond


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at ``x``, clamped to fp's
    end values outside [xp[0], xp[-1]] (``jnp.interp``'s rule)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    tiny = dx.abs() <= torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps
    f = torch.where(tiny, f0, f0 + ((x - x0) / torch.where(tiny, 1.0, dx)) * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _interp_table(x, xp):
    """:func:`_interp` at ``x`` as a gather table for any ``fp`` on ``xp``:
    (code, weight), each of x's shape. A node that interpolates has code
    i − 1 ≥ 0 and weight (x − x0)/dx, so f0 + weight·(f1 − f0) rounds as
    :func:`_interp` does; a node that takes one value of fp (a tie of nodes,
    or x beyond an end) has code −1 − (its index). The same operations as
    :func:`_interp`'s, in its order."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x0 = xp[i - 1]
    dx = xp[i] - x0
    tiny = dx.abs() <= torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps
    weight = (x - x0) / torch.where(tiny, 1.0, dx)
    code = torch.where(tiny, -i, i - 1)
    code = torch.where(x < xp[0], -1, code)
    code = torch.where(x > xp[-1], -n, code)
    return code.to(torch.int32), weight


def _slv_scan(generator: torch.Generator, spot, maturity, rate, dividend, params, mixing,
              lv_grids, n_paths: int, n_steps: int, n_bins: int, init, update, antithetic: bool,
              leverage_rows=None, wants_var: bool = False):
    """The particle loop: calibrate the leverage (``leverage_rows=None``) or
    replay stored rows; always carries the payoff statistics.

    ``update(stats, s, i)`` (or ``update(stats, s, i, L²v⁺dt)`` with
    ``wants_var``) sees the spot after step ``i``. Returns (S_T, stats,
    (x_rows, l_rows)) with rows of shape (n_steps, n_bins): row i is the
    leverage in force on [t_i, t_{i+1})."""
    dev = generator.device

    def f32(x):
        return torch.as_tensor(float(x), dtype=torch.float32, device=dev)

    half = n_paths // 2 if antithetic else n_paths
    n_eff = 2 * half if antithetic else n_paths
    t = torch.clamp_min(f32(maturity), EPS_TIME)
    dt = t / n_steps
    sqrt_dt = torch.sqrt(dt)
    kap, th, rho = f32(params.kappa), f32(params.theta), f32(params.rho)
    sig = f32(mixing) * f32(params.sigma)
    srho = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0))
    rq = f32(rate) - f32(dividend)
    rq_dt = rq * dt
    spot_t = f32(spot)
    if leverage_rows is None:
        k_grid, t_grid, vol_grid = (g.to(dev) for g in lv_grids)
    else:
        x_rows, l_rows = (torch.as_tensor(r, dtype=torch.float32, device=dev)
                          for r in leverage_rows)

    def mirror(z):
        return torch.cat([z, -z]) if antithetic else z

    x = torch.zeros(n_eff, dtype=torch.float32, device=dev)
    v = f32(params.v0).expand(n_eff).clone()
    stats = init(spot_t.expand(n_eff))
    rows_x, rows_l = [], []
    for i in range(n_steps):
        z = torch.randn((2, half), generator=generator, device=dev)
        zv, zo = mirror(z[0]), mirror(z[1])
        zx = rho * zv + srho * zo
        vp = torch.clamp_min(v, 0.0)
        t_now = i * dt
        if leverage_rows is None:
            x_row, cond = _conditional_variance(x, vp, n_bins)
            # the surface is indexed by forward log-moneyness
            l_row = _bilinear(k_grid, t_grid, vol_grid, x_row - rq * t_now, t_now) / torch.sqrt(
                torch.clamp_min(cond, _COND_FLOOR))
            l_row = torch.clamp(l_row, 0.0, _LEV_MAX)
        else:
            x_row, l_row = x_rows[i], l_rows[i]
        lev = _interp(x, x_row, l_row)
        lv2 = lev * lev * vp
        sq = torch.sqrt(vp)
        x = x + rq_dt - 0.5 * lv2 * dt + lev * sq * sqrt_dt * zx
        v = v + kap * (th - vp) * dt + sig * sq * sqrt_dt * zv
        s = spot_t * torch.exp(x)
        stats = update(stats, s, i, lv2 * dt) if wants_var else update(stats, s, i)
        rows_x.append(x_row)
        rows_l.append(l_row)
    return spot_t * torch.exp(x), stats, (torch.stack(rows_x), torch.stack(rows_l))


def _stat_payoff(kind, cp, strike, barrier, n_steps, rdt=0.0):
    if kind == "european":
        def init(s0):
            return torch.zeros_like(s0)

        def update(stat, s, i):
            return stat

        def payoff(s_t, stat):
            return torch.clamp_min(cp * (s_t - strike), 0.0)

        return init, update, payoff
    init, update = exotic_stat_fns(kind, cp, barrier, rdt=rdt)
    return init, update, lambda s_t, stat: exotic_payoff(kind, cp, strike, n_steps, s_t, stat)


def _check_kind(kind: str) -> None:
    if kind not in SLV_KINDS:
        raise ValidationError(f"unknown SLV kind {kind!r}; choose {SLV_KINDS}")


def _df(rate, maturity) -> float:
    return math.exp(-float(rate) * float(maturity))


def slv_exotic_price(kind: str, spot, strike, maturity, rate, params: HestonParams,
                     generator: torch.Generator, lv_k_grid, lv_t_grid, lv_vol_grid,
                     cp: float = 1.0, dividend: float = 0.0, barrier=0.0, mixing: float = 1.0,
                     n_paths: int = 131_072, n_steps: int = 64, n_bins: int = 31,
                     antithetic: bool = True, return_stderr: bool = False,
                     return_leverage: bool = False):
    """Calibrate the SLV leverage and price ``kind`` in one particle loop.

    ``lv_*_grid`` are a :class:`LocalVolSurface`'s (k_grid, t_grid, grid),
    the Dupire surface the leverage must reproduce. ``return_leverage=True``
    also returns the per-step (x_rows, l_rows)."""
    _check_kind(kind)
    init, update, payoff = _stat_payoff(kind, float(cp), float(strike), barrier, n_steps,
                                        rdt=float(rate) * float(maturity) / n_steps)
    s_t, stat, rows = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                                (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps, n_bins,
                                init, update, antithetic)
    price, stderr = _mean_stderr(payoff(s_t, stat),
                                 1.0 if kind.endswith("_hit") else _df(rate, maturity))
    out = (price, stderr) if return_stderr else price
    return (out, rows) if return_leverage else out


def slv_calibrate_leverage(spot, maturity, rate, params: HestonParams,
                           generator: torch.Generator, lv_k_grid, lv_t_grid, lv_vol_grid,
                           dividend: float = 0.0, mixing: float = 1.0, n_paths: int = 131_072,
                           n_steps: int = 64, n_bins: int = 31, antithetic: bool = True):
    """The particle calibration alone: (x_rows, l_rows), each (n_steps,
    n_bins); row i is L(t_i, ·) on its particle-adapted log-spot grid."""
    init, update, _ = _stat_payoff("european", 1.0, float(spot), 0.0, n_steps)
    _, _, rows = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                           (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps, n_bins, init,
                           update, antithetic)
    return rows


def slv_variance_swap(spot, maturity, rate, params: HestonParams, generator: torch.Generator,
                      lv_k_grid, lv_t_grid, lv_vol_grid, dividend: float = 0.0,
                      mixing: float = 1.0, n_paths: int = 131_072, n_steps: int = 128,
                      n_bins: int = 31, antithetic: bool = True, return_stderr: bool = False):
    """Fair variance swap strike E[(1/T)∫L²v dt] under SLV by the log
    contract: E[log(S_T/S0)] = (r−q)T − ½E[∫L²v dt] exactly under the
    log-Euler scheme, so terminal logs alone estimate K_var (mixing-invariant
    by Gyöngy)."""
    s_t, _, _ = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                          (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps, n_bins,
                          lambda s0: torch.zeros((), device=s0.device),
                          lambda stats, s, i: stats, antithetic)
    t = max(float(maturity), EPS_TIME)
    x = torch.log(s_t / float(spot))
    drift = (float(rate) - float(dividend)) * t
    if antithetic:
        half = n_paths // 2
        x = 0.5 * (x[:half] + x[half:])
    rv = -(2.0 / t) * (x - drift)
    m = rv.mean()
    se = rv.std(correction=1) / math.sqrt(rv.shape[0])
    return (m, se) if return_stderr else m


def _periodic(n_steps: int, n: int, what: str) -> int:
    if n <= 0 or n_steps % n:
        raise ValidationError(f"n_steps must be a positive multiple of {what}")
    return n_steps // n


def slv_cliquet_price(spot, maturity, rate, params: HestonParams, generator: torch.Generator,
                      lv_k_grid, lv_t_grid, lv_vol_grid, dividend: float = 0.0,
                      mixing: float = 1.0, local_floor: float = -0.05, local_cap: float = 0.05,
                      global_floor: float = 0.0, global_cap: float = 1e9,
                      notional: float = 100.0, n_periods: int = 12, n_paths: int = 131_072,
                      n_steps: int = 252, n_bins: int = 31, antithetic: bool = True,
                      return_stderr: bool = False):
    """Cliquet under SLV: the product's value lives in the forward smile,
    which ``mixing`` marks with every vanilla repriced. Conventions of
    ``heston_exotics.heston_cliquet_price``."""
    per = _periodic(n_steps, n_periods, "n_periods")

    def init(s0):
        return (s0, torch.zeros_like(s0))

    def update(stats, s, i):
        s_start, acc = stats
        if (i + 1) % per:
            return stats
        return (s, acc + torch.clamp(s / s_start - 1.0, float(local_floor), float(local_cap)))

    _, (_, acc), _ = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                               (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps, n_bins,
                               init, update, antithetic)
    pay = float(notional) * torch.clamp(acc, float(global_floor), float(global_cap))
    price, stderr = _mean_stderr(pay, _df(rate, maturity))
    return (price, stderr) if return_stderr else price


def slv_swap_strikes(spot, maturity, rate, params: HestonParams, generator: torch.Generator,
                     lv_k_grid, lv_t_grid, lv_vol_grid, dividend: float = 0.0,
                     mixing: float = 1.0, n_paths: int = 131_072, n_steps: int = 128,
                     n_bins: int = 31, antithetic: bool = True):
    """Both swap strikes from one simulation under SLV: ``(K_var, se_var,
    K_vol, se_vol)``, K_vol in vol units. K_var is pinned to the smile at
    every ``mixing``; K_vol moves with it (the convexity of √RV)."""
    _, iv, _ = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                         (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps, n_bins,
                         torch.zeros_like, lambda stat, s, i, dv: stat + dv, antithetic,
                         wants_var=True)
    t = max(float(maturity), EPS_TIME)
    rv = iv / t
    vol = torch.sqrt(torch.clamp_min(rv, 0.0))
    if antithetic:  # stats over the independent pair means
        half = rv.shape[0] // 2
        rv = 0.5 * (rv[:half] + rv[half:])
        vol = 0.5 * (vol[:half] + vol[half:])
    rn = math.sqrt(rv.shape[0])
    return (rv.mean(), rv.std(correction=1) / rn, vol.mean(), vol.std(correction=1) / rn)


def slv_range_accrual_price(spot, lower, upper, maturity, rate, params: HestonParams,
                            generator: torch.Generator, lv_k_grid, lv_t_grid, lv_vol_grid,
                            dividend: float = 0.0, mixing: float = 1.0, notional: float = 100.0,
                            n_paths: int = 131_072, n_steps: int = 64, n_bins: int = 31,
                            antithetic: bool = True, return_stderr: bool = False):
    """Range-accrual note under SLV: notional × the fraction of steps with
    lower ≤ S ≤ upper, paid at expiry."""
    lower, upper = float(lower), float(upper)

    def update(stat, s, i):
        return stat + ((s >= lower) & (s <= upper)).to(torch.float32)

    _, acc, _ = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                          (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps, n_bins,
                          torch.zeros_like, update, antithetic)
    price, stderr = _mean_stderr(float(notional) * acc / n_steps, _df(rate, maturity))
    return (price, stderr) if return_stderr else price


def slv_autocall_price(spot, maturity, rate, params: HestonParams, generator: torch.Generator,
                       lv_k_grid, lv_t_grid, lv_vol_grid, dividend: float = 0.0,
                       mixing: float = 1.0, notional: float = 100.0,
                       autocall_barrier: float = 1.0, coupon_barrier: float = 0.8,
                       ki_barrier: float = 0.7, coupon_rate: float = 0.08, n_obs: int = 4,
                       n_paths: int = 131_072, n_steps: int = 252, n_bins: int = 31,
                       antithetic: bool = True, return_stderr: bool = False):
    """Autocallable under SLV; barriers relative to spot, coupons and
    redemptions discounted at their dates (``heston_autocall_price``'s
    conventions)."""
    obs_every = _periodic(n_steps, n_obs, "n_obs")
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

    s_t, (alive, ki, pv), _ = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing,
                                        (lv_k_grid, lv_t_grid, lv_vol_grid), n_paths, n_steps,
                                        n_bins, init, update, antithetic)
    final = torch.where(ki, float(notional) * torch.clamp_max(s_t / s0, 1.0), float(notional))
    price, stderr = _mean_stderr(pv + torch.where(alive, _df(rate, maturity) * final, 0.0), 1.0)
    return (price, stderr) if return_stderr else price


def slv_replay_price(kind: str, spot, strike, maturity, rate, params: HestonParams,
                     generator: torch.Generator, x_rows, l_rows, cp: float = 1.0,
                     dividend: float = 0.0, barrier=0.0, mixing: float = 1.0,
                     n_paths: int = 131_072, n_steps: int = 64, antithetic: bool = True,
                     return_stderr: bool = False):
    """Price ``kind`` by replaying stored leverage rows (the
    :func:`slv_calibrate_leverage` output) instead of re-calibrating: the
    scan-side oracle of the kernel of ``ops/slv_kernel.py``, which replays
    the same rows through its polynomial table. ``n_steps`` must equal the
    calibration's."""
    _check_kind(kind)
    if x_rows.shape[0] != n_steps:
        raise ValidationError(f"leverage rows have {x_rows.shape[0]} steps, n_steps={n_steps}")
    init, update, payoff = _stat_payoff(kind, float(cp), float(strike), barrier, n_steps,
                                        rdt=float(rate) * float(maturity) / n_steps)
    s_t, stat, _ = _slv_scan(generator, spot, maturity, rate, dividend, params, mixing, None,
                             n_paths, n_steps, x_rows.shape[1], init, update, antithetic,
                             leverage_rows=(x_rows, l_rows))
    price, stderr = _mean_stderr(payoff(s_t, stat),
                                 1.0 if kind.endswith("_hit") else _df(rate, maturity))
    return (price, stderr) if return_stderr else price


class SLVModel:
    """Façade: Dupire surface + Heston parameters + mixing → exotic prices.

    >>> dup = DupireLocalVol(iv_fn, spot, rate)
    >>> slv = SLVModel(dup, HestonParams.make(...), mixing=0.7)
    >>> slv.price("barrier_up-and-out", strike=105, maturity=1.0, barrier=130,
    ...           generator=torch.Generator("cuda").manual_seed(0))
    """

    def __init__(self, surface, params: HestonParams, mixing: float = 1.0):
        if isinstance(surface, DupireLocalVol):
            surface = surface.surface
        if not isinstance(surface, LocalVolSurface):
            raise ValidationError("surface must be a DupireLocalVol or LocalVolSurface")
        self.surface = surface
        self.params = params
        self.mixing = float(mixing)

    def _grids(self):
        s = self.surface
        return s.k_grid, s.t_grid, s.grid

    def price(self, kind, strike, maturity, generator: torch.Generator, cp: float = 1.0,
              barrier=0.0, n_paths: int = 131_072, n_steps: int = 64, n_bins: int = 31,
              return_stderr: bool = False):
        s = self.surface
        return slv_exotic_price(kind, s.spot, strike, maturity, s.rate, self.params, generator,
                                *self._grids(), cp=cp, dividend=s.dividend, barrier=barrier,
                                mixing=self.mixing, n_paths=n_paths, n_steps=n_steps,
                                n_bins=n_bins, return_stderr=return_stderr)

    def cliquet(self, maturity, generator: torch.Generator, **kw):
        """Cliquet; keyword arguments forward to :func:`slv_cliquet_price`."""
        s = self.surface
        return slv_cliquet_price(s.spot, maturity, s.rate, self.params, generator,
                                 *self._grids(), dividend=s.dividend, mixing=self.mixing, **kw)

    def autocall(self, maturity, generator: torch.Generator, **kw):
        """Autocallable; keyword arguments forward to :func:`slv_autocall_price`."""
        s = self.surface
        return slv_autocall_price(s.spot, maturity, s.rate, self.params, generator,
                                  *self._grids(), dividend=s.dividend, mixing=self.mixing, **kw)

    def leverage(self, maturity, generator: torch.Generator, n_paths: int = 131_072,
                 n_steps: int = 64, n_bins: int = 31):
        s = self.surface
        return slv_calibrate_leverage(s.spot, maturity, s.rate, self.params, generator,
                                      *self._grids(), dividend=s.dividend, mixing=self.mixing,
                                      n_paths=n_paths, n_steps=n_steps, n_bins=n_bins)
