"""Stochastic-local-vol (SLV) Monte Carlo in one kernel pass: 20 path kinds,
the cliquet, autocall and range accrual, and one-pass likelihood-ratio
Greek ladders.

The port of ``optionslab_tpu/ops/slv_pallas.py``. Two phases, each where it
is cheapest:

1. **Calibrate** (once per surface and maturity): the particle method of
   ``models/slv.py`` gives per-step leverage rows L(t_i, x) on
   particle-adapted grids; each row is then fitted by a density-weighted
   degree-6 polynomial in x = log(S/S0) over its interior band
   (:func:`fit_leverage_polys`).
2. **Replay** (one launch per contract or ladder): ``csrc/slv_mc.cu`` (the
   port of ``_slv_kernel``). Every lane of the reference's (128, 512) counter
   space carries one antithetic pair of (log-spot, variance) paths, ``(zv,
   zo)`` and ``(−zv, −zo)``, through full-truncation Euler with the
   leverage as a Horner evaluation of the step's row:
   x += μdt − ½L²v⁺dt + L√v⁺√dt·(ρzv + √(1−ρ²)zo), v += κ(θ−v⁺)dt + ησ√v⁺√dt·zv.

``lr=True`` reduces likelihood-ratio score moments in the same pass: D1 =
pay·zo₀, DG = pay·(zo₀²−1), DX = pay·zo₀·zv₀ (the L0' cross term), DV =
pay·score_v0, SR = pay·Σ rate scores (+ DR for the autocall and the
pay-at-hit touches, + B0/B1 for the lookbacks). delta/gamma are sticky-strike
(the leverage surface fixed in physical spot), v0-vega and rho frozen-leverage.

Dispatch. CUDA tensors go through :func:`_slv_cuda` (it counts its launches
in ``.launches`` and raises if it cannot build or launch), CPU tensors
through :func:`_slv_plain`, the same sums from the same counters with the
same float32 operations in the same order. The pricer runs on its
``device`` (default: the surface's). Samplers ``prng`` (Philox stream 0 at
``(row, col, step, 0)``) and ``hash`` (the reference's counters).

Names. ``pallas_slv_exotic_price`` → :func:`slv_kernel_exotic_price`;
:class:`SLVKernelPricer` and :func:`fit_leverage_polys` keep theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .exotic_kernel import _check_tensor, _chunking, _launch_checked, _mean_stderr, _n_blocks
from .heston_exotic_kernel import _kernel_codes as _exotic_codes
from .heston_kernel import _count, _dispatch, _require_cuda, _stream, _sum_blocks
from .kernel_rng import draw_normals, sqrt_rn
from .local_vol_kernel import MAX_STEPS, _horner

ROWS = 128
LANES = 512
PATHS_PER_BLOCK = 2 * ROWS * LANES  # one antithetic pair per lane
DEGREE = 6

# the scalar head before the per-step leverage table; each step row is
# [x_lo_i, x_hi_i, c_deg, ..., c_0]. _S_A.._S_E are the structured kinds'
# product parameters and the double kinds' band, zero otherwise.
(_S_S0, _S_K, _S_LOGB, _S_INVN, _S_RDT, _S_DT, _S_SQDT, _S_MUDT,
 _S_KAPPA, _S_THETA, _S_SIGV, _S_RHO, _S_SRHO, _S_V0,
 _S_A, _S_B, _S_C, _S_D, _S_E) = range(19)
_N_SCALARS = 19
_ROW = DEGREE + 3

KINDS = (
    "european", "asian_arith", "asian_geo", "lookback_float", "lookback_fixed",
    "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out", "barrier_down-and-in",
    "one_touch_up", "one_touch_down", "no_touch_up", "no_touch_down",
    # double kinds: band (lower, upper) in the relative-log slots _S_A/_S_B
    "barrier_double-out", "barrier_double-in", "one_touch_double", "no_touch_double",
    # pay-at-hit one-touches: cash discounted at the first hit in the kernel
    "one_touch_up_hit", "one_touch_down_hit", "one_touch_double_hit",
)
STRUCTURED_KINDS = ("cliquet", "autocall", "range_accrual")
SAMPLERS = ("prng", "hash")


def _n_moments(kind: str, lr: bool) -> int:
    if not lr:
        return 2
    if kind.startswith("lookback"):
        return 9
    return 8 if (kind == "autocall" or kind.endswith("_hit")) else 7


def _check_launch(kind: str, sampler: str, lr: bool, n_steps: int) -> None:
    if kind not in KINDS and kind not in STRUCTURED_KINDS:
        raise ValidationError(f"unknown SLV kernel kind {kind!r}; choose "
                              f"{KINDS + STRUCTURED_KINDS}")
    if sampler not in SAMPLERS:
        raise ValidationError("SLV kernel samplers are prng|hash")
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValidationError(f"n_steps must be in [1, {MAX_STEPS}], got {n_steps}")


# ---------------------------------------------------------------------------
# The kernel: plain version
# ---------------------------------------------------------------------------
def _horner0(table) -> torch.Tensor:
    """L(x = 0) of step 0's polynomial (unfloored), at the clamped start."""
    row = table[0]
    xc = torch.clamp(torch.zeros((), dtype=torch.float32, device=table.device), row[0], row[1])
    acc = row[2]
    for j in range(1, DEGREE + 1):
        acc = acc * xc + row[2 + j]
    return acc


def _slv_block_plain(seed, block, p, *, kind, n_steps, cp, period, sampler, lr):
    """Per-lane moment terms (each (nb, ROWS, LANES) float32, the lane's two
    paths summed) of path blocks ``block``: a line-by-line twin of the
    reference's ``_slv_kernel`` body."""
    nb = block.shape[0]
    shape = (nb, ROWS, LANES)
    (s0, strike, log_b, inv_n, rdt, dt, sqrt_dt, mu_dt, kappa, theta_v, sigma_v, rho, srho, v0,
     pA, pB, pC, pD, pE) = (p[j] for j in range(_N_SCALARS))
    table = p[_N_SCALARS:].reshape(n_steps, _ROW)
    zero = torch.zeros(shape, dtype=torch.float32, device=p.device)
    one = zero + 1.0
    hit_pay = kind.endswith("_hit")
    double = "double" in kind
    barrier_up = "up" in kind

    def f(b):
        return b.to(torch.float32)

    def hit_test(x):
        if double:
            return f((x <= pA) | (x >= pB))
        return f(x >= log_b) if barrier_up else f(x <= log_b)

    def init_stat():
        if kind in ("asian_arith", "asian_geo", "range_accrual") or kind.startswith("lookback"):
            return (zero,)  # sums, the accrual counter, or the extremum of x from x0 = 0
        if kind == "european":
            return ()
        if kind == "cliquet":
            return (zero, zero)  # (period-start x, capped-return sum)
        if kind == "autocall":
            return (one, zero, zero) + ((zero,) if lr else ())  # (alive, knocked in, pv[, dr])
        h0 = zero + hit_test(torch.zeros((), device=p.device))  # x0 = 0 beyond a level: hit
        return (h0, h0) + ((zero,) if lr else ()) if hit_pay else (h0,)

    def update_stat(stat, x, i):
        if kind == "asian_arith":
            return (stat[0] + torch.exp(x),)
        if kind == "asian_geo":
            return (stat[0] + x,)
        if kind.startswith("lookback"):
            lo = (cp > 0) == (kind == "lookback_float")
            return ((torch.minimum if lo else torch.maximum)(stat[0], x),)
        if kind == "european":
            return stat
        if kind == "cliquet":
            x_start, acc = stat
            is_end = 1.0 if (i + 1) % period == 0 else 0.0
            capped = torch.clamp(torch.exp(x - x_start) - 1.0, pA, pB)
            return (x_start + is_end * (x - x_start), acc + is_end * capped)
        if kind == "autocall":
            alive, ki, pv = stat[:3]
            ki = torch.maximum(ki, f(x <= pC))
            is_obs = 1.0 if (i + 1) % period == 0 else 0.0
            steps = float(i + 1)
            df_i = torch.exp(-rdt * steps)
            called = alive * is_obs * f(x >= pA)
            couponed = alive * is_obs * f(x >= pB)
            cash = pD * couponed + pE * called
            pv = pv + df_i * cash
            alive = alive * (1.0 - called)
            if lr:  # DR = −Σ tᵢ·dfᵢ·cashᵢ (coupon and call legs)
                return (alive, ki, pv, stat[3] - steps * dt * df_i * cash)
            return (alive, ki, pv)
        if kind == "range_accrual":
            return (stat[0] + f((x >= pA) & (x <= pB)),)
        now = hit_test(x)
        if hit_pay:
            h, pv = stat[:2]
            newly = (1.0 - h) * now
            steps = float(i + 1)
            df_i = torch.exp(-rdt * steps)
            pv = pv + newly * df_i
            if lr:  # ∂pv/∂r = −t_hit·df_hit on the newly-hit event
                return (torch.maximum(h, now), pv, stat[2] - steps * dt * newly * df_i)
            return (torch.maximum(h, now), pv)
        return (torch.maximum(stat[0], now),)

    df_t = torch.exp(-rdt * float(n_steps))

    def autocall_final(stat, x):
        loss = torch.clamp_min(1.0 - torch.exp(x), 0.0)
        return pE * (1.0 - stat[1] * loss)

    def payoff(stat, x):
        s_t = s0 * torch.exp(x)
        if kind == "asian_arith":
            return torch.clamp_min(cp * (s0 * stat[0] * inv_n - strike), 0.0)
        if kind == "asian_geo":
            return torch.clamp_min(cp * (s0 * torch.exp(stat[0] * inv_n) - strike), 0.0)
        if kind == "lookback_float":
            ext = s0 * torch.exp(stat[0])
            return (s_t - ext) if cp > 0 else (ext - s_t)
        if kind == "lookback_fixed":
            return torch.clamp_min(cp * (s0 * torch.exp(stat[0]) - strike), 0.0)
        if kind == "european":
            return torch.clamp_min(cp * (s_t - strike), 0.0)
        if kind == "cliquet":
            return pE * torch.clamp(stat[1], pC, pD)
        if kind == "autocall":  # discounted in the kernel
            return stat[2] + stat[0] * df_t * autocall_final(stat, x)
        if kind == "range_accrual":
            return pE * stat[0] * inv_n
        if hit_pay:
            return stat[1]  # df at the hit carried in the kernel (host df = 1)
        if "touch" in kind:
            return stat[0] if kind.startswith("one") else (1.0 - stat[0])
        vanilla = torch.clamp_min(cp * (s_t - strike), 0.0)
        return vanilla * (stat[0] if kind.endswith("in") else (1.0 - stat[0]))

    srho_g = torch.clamp_min(srho, 1e-4)

    def advance(x, v, zv, zo, i):
        ind = f(v > 0.0)
        vp = v * ind
        sq = sqrt_rn(vp)
        lev = _horner(table[i], x)
        sig = lev * sq  # the instantaneous vol of x
        zx = rho * zv + srho * zo
        x_new = x + mu_dt - 0.5 * sig * sig * dt + sig * sqrt_dt * zx
        v_new = v + kappa * (theta_v - vp) * dt + sigma_v * sq * sqrt_dt * zv
        if not lr:
            return x_new, v_new, None
        # the rate drift score: μ enters the x-step mean and loads on the
        # independent shock zo; gated where v⁺ = 0
        ds = zo * dt * ind / (srho_g * lev * torch.clamp_min(sq, 1e-6) * sqrt_dt)
        return x_new, v_new, ds

    xa = xb = zero
    va = vb = v0.expand(shape)
    sta, stb = init_stat(), init_stat()
    zv0 = zo0 = sra = srb = zero
    for i in range(n_steps):
        zv, zo = draw_normals(sampler, seed, block, i, n_steps, ROWS, LANES)
        xa, va, dsa = advance(xa, va, zv, zo, i)
        xb, vb, dsb = advance(xb, vb, -zv, -zo, i)
        sta = update_stat(sta, xa, i)
        stb = update_stat(stb, xb, i)
        if lr:
            if i == 0:
                zv0, zo0 = zv, zo
            sra, srb = sra + dsa, srb + dsb

    moms = [zero] * _n_moments(kind, lr)
    if lr:
        v0g = torch.clamp_min(v0, 1e-8)
        sq_v0dt = sqrt_rn(v0g * dt)
        inv_v0 = 1.0 / v0g
        l0 = torch.clamp_min(_horner0(table), 1e-4)  # the start-state leverage
        a_head = (kappa * dt - 1.0) / (torch.clamp_min(sigma_v, 1e-4) * sq_v0dt)
        b_head = l0 * sqrt_dt / (2.0 * sqrt_rn(v0g))
    for sign, x, st, sr in ((1.0, xa, sta, sra), (-1.0, xb, stb, srb)):
        pay = payoff(st, x)
        terms = [pay, pay * pay]
        if lr:
            zvs, zos = (zv0, zo0) if sign > 0 else (-zv0, -zo0)
            zxs = rho * zvs + srho * zos
            # score_v0 = −zv₀·a − zo₀·(b − ρa)/√(1−ρ²) − 1/v0, a = ∂zv₀/∂v0 and
            # b = ∂zx₀/∂v0 at a fixed path (b carries the leverage L0)
            a_t = a_head - zvs * (0.5 * inv_v0)
            b_t = b_head - zxs * (0.5 * inv_v0)
            sc_v = -zvs * a_t - zos * (b_t - rho * a_t) / srho_g - inv_v0
            terms += [pay * zos, pay * (zos * zos - 1.0), pay * zos * zvs, pay * sc_v, pay * sr]
            if hit_pay:
                terms.append(st[2])
            elif kind == "autocall":  # DR: the carried legs, then the redemption's
                t_total = dt * float(n_steps)
                terms.append(st[3] - st[0] * t_total * df_t * autocall_final(st, x))
            if kind.startswith("lookback"):
                # the extremum includes the start: ∂pay/∂x0 where it is attained at t = 0
                at0 = f(st[0] == 0.0)
                if kind == "lookback_fixed":
                    f0 = cp * at0 * f(cp * (s0 - strike) > 0.0)
                else:
                    f0 = -at0 if cp > 0 else at0
                terms += [f0, f0 * zos]
        moms = [m + t for m, t in zip(moms, terms)]
    return moms


def _slv_plain(seed: int, block0: int, params: torch.Tensor, *, kind: str, n_steps: int,
               n_blocks: int, cp: float, period: int = 1, sampler: str = "prng",
               lr: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: per-row sums ``(n_mom, ROWS)``
    float32 of ``n_blocks`` path blocks from ``block0``. Runs on any
    device."""
    _check_launch(kind, sampler, lr, n_steps)
    return _sum_blocks(
        lambda blk: _slv_block_plain(seed, blk, params, kind=kind, n_steps=n_steps, cp=float(cp),
                                     period=period, sampler=sampler, lr=lr),
        n_blocks, block0, LANES, (_n_moments(kind, lr),), params.device)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------
_SAMPLER_ID = {"prng": 0, "hash": 1}
# the statistic families of csrc/slv_mc.cu (a template parameter each) are the
# Heston exotic kernel's, then the European
_F_EURO = 8


def _kernel_codes(kind: str, cp: float) -> tuple[int, int]:
    """(family, mode) of a kind: the Heston exotic kernel's codes (the family
    a template parameter of the kernel, the mode a runtime argument), and
    the European's."""
    return (_F_EURO, 0) if kind == "european" else _exotic_codes(kind, cp)


def _slv_cuda(seed: int, block0: int, params: torch.Tensor, *, kind: str, n_steps: int,
              n_blocks: int, cp: float, period: int = 1, sampler: str = "prng",
              lr: bool = False) -> torch.Tensor:
    """The kernel: per-row sums ``(n_mom, ROWS)`` float32 on the card.
    Launches on PyTorch's current stream and does not synchronize.
    ``_slv_cuda.launches`` counts its launches."""
    _check_launch(kind, sampler, lr, n_steps)
    dev = params.device
    _require_cuda("_slv_cuda", dev)
    _check_tensor("params", params, dev, (_N_SCALARS + _ROW * n_steps,))
    if n_blocks < 1 or period < 1:
        raise ValueError(f"n_blocks {n_blocks} and period {period} must be positive")
    n_chunks, per_chunk = _chunking(n_blocks)
    family, mode = _kernel_codes(kind, cp)
    lib = _build.load_library()
    n_mom = _n_moments(kind, lr)
    partials = torch.empty((n_mom, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, ROWS), dtype=torch.float32, device=dev)
    err = lib.slv_moments(
        params.data_ptr(), int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF, n_blocks,
        per_chunk, n_chunks, n_steps, period, float(cp), family, mode, _SAMPLER_ID[sampler],
        int(lr), n_mom, partials.data_ptr(), out.data_ptr(), dev.index, _stream(dev))
    _launch_checked("slv_moments", err)
    _count(_slv_cuda)
    return out


_slv_cuda.launches = 0


# ---------------------------------------------------------------------------
# Host side: the leverage table, parameters, moments → price / Greeks
# ---------------------------------------------------------------------------
def fit_leverage_polys(x_rows, l_rows):
    """Per-step degree-6 polynomial fits of calibrated leverage rows (the
    ``models.slv.slv_calibrate_leverage`` output, tensors or arrays), weighted
    by the Gaussian density in the standardised coordinate over the interior
    band |z| ≤ 3.2 (the far tail bins are count-starved and carry the
    calibration's fallback values). Returns (rows float64 (n_steps,
    DEGREE+3) of [x_lo, x_hi, c_deg..c_0], the worst density-weighted rms
    residual)."""
    def f64(r):
        return (r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
                else np.asarray(r)).astype(np.float64)

    x_rows, l_rows = f64(x_rows), f64(l_rows)
    n_steps = x_rows.shape[0]
    rows = np.empty((n_steps, _ROW), np.float64)
    resid = 0.0
    for i in range(n_steps):
        xg, lg = x_rows[i], l_rows[i]
        m = 0.5 * (xg[0] + xg[-1])
        s = max((xg[-1] - xg[0]) / 8.0, 1e-6)  # the grid spans ±4 stds
        z = (xg - m) / s
        keep = np.abs(z) <= 3.2
        dens = np.exp(-0.5 * z[keep] ** 2)
        if xg[keep][-1] - xg[keep][0] < 1e-4:
            # early steps: the cloud is still nearly a point; a constant fit is
            # exact where a degree-6 fit would be ill-conditioned
            c = np.zeros(DEGREE + 1)
            c[-1] = float((dens * lg[keep]).sum() / dens.sum())
        else:
            c = np.polyfit(xg[keep], lg[keep], DEGREE, w=np.sqrt(dens))
        rows[i] = np.concatenate([[xg[keep][0], xg[keep][-1]], c])
        err = np.polyval(c, xg[keep]) - lg[keep]
        resid = max(resid, float(np.sqrt((dens * err**2).sum() / dens.sum())))
    return rows, resid


_FROZEN_FIXINGS = ("frozen-fixings hedge delta: barriers/baselines set from spot at inception "
                   "held fixed (the scale-invariant unconditional delta is 0)")
_STICKY = "sticky-strike: physical leverage surface fixed under the spot bump"


class SLVKernelPricer:
    """Calibrate once, price many on the kernel: the particle calibration
    (``models/slv.py``, ``n_cal_paths`` particles from a ``torch.Generator``
    seeded ``cal_seed`` on the pricer's device) and the polynomial fits run at
    construction, then every ``price``/``greeks``/structured call is one
    kernel launch.

    >>> dup = DupireLocalVol(iv_fn, spot, rate)
    >>> pricer = SLVKernelPricer(dup, HestonParams.make(...), maturity=1.0, mixing=0.8)
    >>> pricer.price("barrier_up-and-out", strike=100.0, barrier=120.0)
    """

    def __init__(self, dupire, params, maturity, mixing: float = 1.0, n_steps: int = 64,
                 n_cal_paths: int = 262_144, n_bins: int = 31, cal_seed: int = 0, device=None):
        from ..models.slv import slv_calibrate_leverage

        surface = getattr(dupire, "surface", dupire)
        dev = torch.device(device) if device is not None else surface.device
        t_total = max(float(maturity), EPS_TIME)
        gen = torch.Generator(device=dev).manual_seed(int(cal_seed))
        self.x_rows, self.l_rows = slv_calibrate_leverage(
            surface.spot, t_total, surface.rate, params, gen, surface.k_grid, surface.t_grid,
            surface.grid, dividend=surface.dividend, mixing=float(mixing), n_paths=n_cal_paths,
            n_steps=int(n_steps), n_bins=n_bins)
        rows, resid = fit_leverage_polys(self.x_rows, self.l_rows)
        self._setup(rows, resid, params, mixing, surface.spot, surface.rate, surface.dividend,
                    maturity, dev)

    @classmethod
    def from_numpy(cls, rows, fit_residual, params, spot, rate, dividend, maturity,
                   mixing: float = 1.0, device="cuda") -> "SLVKernelPricer":
        """A pricer on a fitted leverage table (float64 (n_steps, 9), e.g. the
        JAX package's ``SLVKernelPricer.rows``) instead of calibrating one."""
        out = object.__new__(cls)
        out.x_rows = out.l_rows = None
        out._setup(np.asarray(rows, np.float64), float(fit_residual), params, mixing, spot, rate,
                   dividend, maturity, device)
        return out

    def _setup(self, rows, resid, params, mixing, spot, rate, dividend, maturity, device):
        self.spot = float(spot)
        self.rate = float(rate)
        self.dividend = float(dividend)
        self.t_total = max(float(maturity), EPS_TIME)
        self.rows, self.fit_residual = rows, resid
        self.n_steps = rows.shape[0]
        self.params = params
        self.mixing = float(mixing)
        self.device = torch.device(device)
        dt = self.t_total / self.n_steps
        rho = float(params.rho)
        self._head = np.asarray(
            [self.spot, 0.0, 0.0, 1.0 / self.n_steps, self.rate * dt, dt, math.sqrt(dt),
             (self.rate - self.dividend) * dt, float(params.kappa), float(params.theta),
             self.mixing * float(params.sigma), rho, math.sqrt(max(1.0 - rho * rho, 0.0)),
             float(params.v0), 0.0, 0.0, 0.0, 0.0, 0.0], np.float64)

    def _vector(self, head) -> torch.Tensor:
        vec = np.concatenate([head, self.rows.ravel()]).astype(np.float32)
        return torch.tensor(vec, device=self.device)

    def _params_vec(self, kind, strike, barrier, lower=0.0, upper=0.0) -> torch.Tensor:
        if kind not in KINDS:
            raise ValidationError(f"unknown SLV kernel kind {kind!r}; choose {KINDS}")
        head = self._head.copy()
        head[_S_K] = float(strike)
        if "double" in kind:
            if not 0.0 < float(lower) < float(upper):
                raise ValidationError("double kinds need 0 < lower < upper")
            head[_S_A] = math.log(float(lower) / self.spot)
            head[_S_B] = math.log(float(upper) / self.spot)
        elif "barrier" in kind or "touch" in kind:
            if float(barrier) <= 0.0:
                raise ValidationError("barrier level must be positive")
            head[_S_LOGB] = math.log(float(barrier) / self.spot)
        return self._vector(head)

    def _launch(self, p, *, seed, **kw) -> torch.Tensor:
        return _dispatch(_slv_cuda, _slv_plain, self.device, seed, 0, p, n_steps=self.n_steps,
                         **kw)

    def _check_lr(self, sampler: str) -> None:
        if sampler not in SAMPLERS:
            raise ValidationError("LR scores assume iid normals; SLV kernel samplers are "
                                  "prng|hash")
        if self.mixing * float(self.params.sigma) < 1e-3:
            raise ValidationError(
                "the LR v0 score diverges as mixing*sigma -> 0 (the variance transition "
                "degenerates); at mixing ~ 0 the model is local vol: use "
                "ops.local_vol_kernel.LocalVolKernelPricer.greeks instead")

    def price(self, kind, strike, cp: float = 1.0, barrier: float = 0.0,
              n_paths: int = 1_000_000, seed: int = 0, sampler: str = "prng",
              lower: float = 0.0, upper: float = 0.0):
        """(price, stderr, actual_paths) of one contract on the calibrated
        leverage, price and stderr float32 tensors on the pricer's device.
        Barriers and touches monitor discretely at every step; payoff
        conventions are ``models/slv.slv_exotic_price``'s."""
        if sampler not in SAMPLERS:
            raise ValidationError("SLV kernel samplers are prng|hash")
        p = self._params_vec(kind, strike, barrier, lower, upper)
        n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
        pay, pay2 = self._launch(p, seed=seed, kind=kind, n_blocks=n_blocks, cp=float(cp),
                                 sampler=sampler)
        n = n_blocks * PATHS_PER_BLOCK
        df = 1.0 if kind.endswith("_hit") else math.exp(-self.rate * self.t_total)
        price, se = _mean_stderr(pay, pay2, n, df, sampler)
        return price, se, n

    def greeks(self, kind, strike, cp: float = 1.0, barrier: float = 0.0,
               n_paths: int = 1_000_000, seed: int = 0, sampler: str = "prng",
               lower: float = 0.0, upper: float = 0.0) -> dict:
        """Price + stderr + LR delta/gamma (sticky-strike), v0-vega and
        rate-rho (frozen-leverage) in one kernel pass, any kind; ``vega`` is
        the spot-vol convention 2√v0·vega_v0."""
        self._check_lr(sampler)
        p = self._params_vec(kind, strike, barrier, lower, upper)
        n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
        outs = self._launch(p, seed=seed, kind=kind, n_blocks=n_blocks, cp=float(cp),
                            sampler=sampler, lr=True)
        return self._combine_lr(outs, n_blocks * PATHS_PER_BLOCK, kind)

    def cliquet(self, local_floor: float = -0.05, local_cap: float = 0.05,
                global_floor: float = 0.0, global_cap: float = 1e9, notional: float = 100.0,
                n_periods: int = 12, n_paths: int = 1_000_000, seed: int = 0,
                sampler: str = "prng", greeks: bool = False):
        """Cliquet on the calibrated leverage: (price, stderr, n), or the LR
        ladder with ``greeks`` (frozen-fixings delta/gamma). Conventions of
        ``models/slv.slv_cliquet_price``."""
        if n_periods <= 0 or self.n_steps % n_periods:
            raise ValidationError("n_steps must be a positive multiple of n_periods")
        return self._structured("cliquet", (float(local_floor), float(local_cap),
                                            float(global_floor), float(global_cap),
                                            float(notional)),
                                self.n_steps // n_periods, n_paths, seed, sampler, greeks)

    def autocall(self, notional: float = 100.0, autocall_barrier: float = 1.0,
                 coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                 coupon_rate: float = 0.08, n_obs: int = 4, n_paths: int = 1_000_000,
                 seed: int = 0, sampler: str = "prng", greeks: bool = False):
        """Autocallable on the calibrated leverage; barriers relative to spot,
        cash flows discounted in the kernel; ``greeks`` adds the LR ladder
        (the DR moment completes rho). Conventions of
        ``models/slv.slv_autocall_price``."""
        if n_obs <= 0 or self.n_steps % n_obs:
            raise ValidationError("n_steps must be a positive multiple of n_obs")
        return self._structured("autocall", (math.log(max(float(autocall_barrier), 1e-9)),
                                             math.log(max(float(coupon_barrier), 1e-9)),
                                             math.log(max(float(ki_barrier), 1e-9)),
                                             float(notional) * float(coupon_rate) / n_obs,
                                             float(notional)),
                                self.n_steps // n_obs, n_paths, seed, sampler, greeks)

    def range_accrual(self, lower, upper, notional: float = 100.0, n_paths: int = 1_000_000,
                      seed: int = 0, sampler: str = "prng", greeks: bool = False):
        """Range-accrual note on the calibrated leverage: notional × the
        fraction of steps with lower ≤ S ≤ upper; ``greeks`` adds the LR
        ladder (the corridor is absolute, so its delta is the hedge delta)."""
        if not 0.0 < float(lower) < float(upper):
            raise ValidationError("need 0 < lower < upper")
        return self._structured("range_accrual", (math.log(float(lower) / self.spot),
                                                  math.log(float(upper) / self.spot), 0.0, 0.0,
                                                  float(notional)),
                                1, n_paths, seed, sampler, greeks)

    def _structured(self, kind, abcde, period, n_paths, seed, sampler, greeks):
        if sampler not in SAMPLERS:
            raise ValidationError("SLV kernel samplers are prng|hash")
        if greeks:
            self._check_lr(sampler)
        head = self._head.copy()
        head[_S_A:_S_E + 1] = abcde
        n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
        outs = self._launch(self._vector(head), seed=seed, kind=kind, n_blocks=n_blocks, cp=1.0,
                            sampler=sampler, lr=greeks, period=period)
        n = n_blocks * PATHS_PER_BLOCK
        if greeks:
            return self._combine_lr(outs, n, kind)
        df = 1.0 if kind == "autocall" else math.exp(-self.rate * self.t_total)
        price, se = _mean_stderr(outs[0], outs[1], n, df, sampler)
        return price, se, n

    def _combine_lr(self, outs: torch.Tensor, n: int, kind: str) -> dict:
        """Per-row moment sums → the ladder dict. The autocall and the
        pay-at-hit touches are discounted in the kernel (df = 1), and their DR
        moment completes rho."""
        discounted = kind == "autocall" or kind.endswith("_hit")
        df = 1.0 if discounted else math.exp(-self.rate * self.t_total)
        t = self.t_total
        dt = t / self.n_steps
        price, se = _mean_stderr(outs[0], outs[1], n, df, "prng")
        v0 = float(self.params.v0)
        rho = float(self.params.rho)
        srho = max(math.sqrt(max(1.0 - rho * rho, 0.0)), 1e-4)
        # the start-state leverage and its slope from step 0's polynomial
        c0 = self.rows[0]
        x0c = float(np.clip(0.0, c0[0], c0[1]))
        l0 = max(float(np.polyval(c0[2:], x0c)), 1e-4)
        dl0 = float(np.polyval(np.polyder(c0[2:]), x0c))
        s_cond = srho * l0 * math.sqrt(v0 * dt)  # the conditional std of x1
        m = outs.double().sum(dim=1).cpu().numpy() / n
        m_d, m_g, m_x, m_v, m_sr = m[2:7]
        # sticky-strike first-step score: the mean shift (1 − L0L0'v0dt +
        # L0'√(v0dt)ρzv0) loads on zo0/s, the std sensitivity L0'/L0 on zo0² − 1
        delta = (df / self.spot) * (m_d * (1.0 - l0 * dl0 * v0 * dt) / s_cond
                                    + m_x * rho * dl0 / (srho * l0) + m_g * dl0 / l0)
        gamma = df * m_g / (self.spot * s_cond) ** 2 - delta / self.spot
        if kind.startswith("lookback"):
            delta = delta + df * m[7]
            gamma = gamma + 2.0 * df * m[8] / (self.spot * s_cond)
        dv0 = df * m_v
        rho_rate = m_sr + m[7] if discounted else df * m_sr - t * float(price)
        return {"price": price, "std_error": se, "delta": float(delta), "gamma": float(gamma),
                "vega_v0": float(dv0), "vega": float(2.0 * math.sqrt(v0) * dv0),
                "rho": float(rho_rate), "paths": n, "fit_residual": self.fit_residual,
                "delta_convention": _FROZEN_FIXINGS if kind in STRUCTURED_KINDS else _STICKY,
                "vega_convention": "frozen-leverage dynamics sensitivity, 2*sqrt(v0)*vega_v0"}


def slv_kernel_exotic_price(dupire, params, kind, strike, maturity, cp: float = 1.0,
                            barrier: float = 0.0, mixing: float = 1.0, n_paths: int = 1_000_000,
                            n_steps: int = 64, seed: int = 0, sampler: str = "prng",
                            lower: float = 0.0, upper: float = 0.0, device=None):
    """One-shot: calibrate the leverage, fit the table, price ``kind`` on the
    kernel. Returns (price, stderr, actual_paths, fit_residual); use
    :class:`SLVKernelPricer` for repeated pricing on one surface."""
    pricer = SLVKernelPricer(dupire, params, maturity, mixing=mixing, n_steps=n_steps,
                             device=device)
    price, se, n = pricer.price(kind, strike, cp=cp, barrier=barrier, n_paths=n_paths, seed=seed,
                                sampler=sampler, lower=lower, upper=upper)
    return price, se, n, pricer.fit_residual
