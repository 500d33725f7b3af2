"""Path-dependent (exotic) payoffs under Heston and Bates: prices, one-pass
likelihood-ratio Greek ladders and contract books, each in one kernel pass.

The port of the exotic part of ``optionslab_tpu/ops/heston_pallas.py``
(``:1050-2169``). One CUDA source, ``csrc/heston_exotic.cu`` (the port of
``_heston_exotic_kernel``): every lane simulates one antithetic pair of
(log-spot, variance) paths through all steps, full-truncation Euler or
Andersen QE, with Bates compound-Poisson log-jumps when the parameters are a
``BatesParams``, carrying the payoff's running statistic in relative-log
space (Asian sum, extremum, barrier/touch state, cliquet, autocall or
range-accrual state) and, with ``lr``, the joint-density score
accumulators. It returns per-row sums of pay, pay² and, with ``lr``, D1, DG,
DV, SR, TS (+DR for the autocall and the pay-at-hit touches).

Geometry. ``ROWS × LANES`` lanes per path block, one antithetic pair each:
the reference's counter space, from which ``hash`` and ``sobol_bb`` draw, so
the path set is the reference's own. ``prng`` is Philox keyed by ``(seed,
salt ^ block)``: the normals on stream 0, the QE uniform on stream 1, the
jump draw on stream 2 (``ops/kernel_rng.py``). Book contracts interleave the
rows (contract = row % nc, 7 slots each: K, log(B/S0), A, B, C, D, E).

Dispatch. CUDA tensors go through :func:`_heston_exotic_cuda` (it counts
its launches in ``.launches`` and raises if it cannot build or launch), CPU
tensors through :func:`_heston_exotic_plain`, which computes the same sums
from the same counters with the same float32 operations in the same order;
it reuses the Euler step (``heston_kernel._euler_step``), the QE transition
(``heston_kernel._qe_advance``) and the bridge (``heston_kernel.
_bridge_offsets``) of the European kernels. The public functions take a
``device`` (default ``"cuda"``).

Names. ``pallas_heston_*`` → ``heston_kernel_*`` (``heston_exotic_price``
and ``heston_cliquet_price`` are the scan engine's, ``models/
heston_exotics.py``): :func:`heston_kernel_exotic_price`,
:func:`heston_kernel_exotic_lr_greeks`, the book, cliquet, autocall and
range-accrual pairs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .exotic_kernel import (
    _book_lists,
    _book_pad,
    _book_table,
    _bridge_plan_arrays,
    _check_tensor,
    _chunking,
    _f32,
    _launch_checked,
    _mean_stderr,
    _n_blocks,
)
from .heston_kernel import (
    _BRIDGE_LEVELS,
    _bridge_offsets,
    _count,
    _dispatch,
    _euler_step,
    _qe_advance,
    _qe_consts,
    _require_cuda,
    _stream,
    _sum_blocks,
)
from .kernel_rng import draw_jump, draw_normals, draw_uniform, sqrt_rn

ROWS = 128
LANES = 512
PATHS_PER_BLOCK = 2 * ROWS * LANES  # one antithetic pair per lane

HESTON_EXOTIC_KINDS = (
    "asian_arith", "asian_geo", "lookback_float", "lookback_fixed",
    "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out",
    "barrier_down-and-in",
    "one_touch_up", "one_touch_down", "no_touch_up", "no_touch_down",
    "cliquet", "autocall", "range_accrual",
    # double kinds: band (lower, upper) in the relative-log slots A/B
    "barrier_double-out", "barrier_double-in",
    "one_touch_double", "no_touch_double",
    # pay-at-hit one-touches: cash discounted at the first hit in the kernel
    # (host df = 1, like the autocall); their LR rho/theta need a DR moment
    "one_touch_up_hit", "one_touch_down_hit", "one_touch_double_hit",
)
STRUCTURED = ("cliquet", "autocall", "range_accrual")
SAMPLERS = ("prng", "hash", "sobol_bb")
SCHEMES = ("euler", "qe")

# the float32 parameter vector: a common head, the scheme's tail, then the
# Bates jump tail [thr0, thr1, thr2, mu_j, sigma_j, lam] under jumps
(_HX_S0, _HX_K, _HX_LOGB, _HX_INVN, _HX_RDT, _HX_DT, _HX_SQDT,
 _HX_A, _HX_B, _HX_C, _HX_D, _HX_E, _HX_DYN) = range(13)
# euler tail: [mu_dt, kappa, theta, sigma_v, rho, srho, v0]
# qe tail:    [mu_dt, emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4, v0]
_TAIL = {"euler": 7, "qe": 11}
_N_JUMP = 6
_BOOK_SLOTS = (_HX_K, _HX_LOGB, _HX_A, _HX_B, _HX_C, _HX_D, _HX_E)
QMC_SALT = 0x2C9277B5  # the seed salt of this kernel's Sobol scrambles (the European's differs)


def n_params(scheme: str, jumps: bool) -> int:
    """Length of the parameter vector of ``scheme`` with or without jumps."""
    return _HX_DYN + _TAIL[scheme] + (_N_JUMP if jumps else 0)


def _n_moments(kind: str, lr: bool) -> int:
    if not lr:
        return 2
    return 8 if (kind == "autocall" or kind.endswith("_hit")) else 7


def _check_launch(kind: str, sampler: str, scheme: str, lr: bool, n_steps: int) -> None:
    if kind not in HESTON_EXOTIC_KINDS:
        raise ValidationError(f"unknown heston exotic kind {kind!r}; choose {HESTON_EXOTIC_KINDS}")
    if sampler not in SAMPLERS:
        raise ValidationError(f"the Heston exotic kernel samplers are prng|hash|sobol_bb, "
                              f"got {sampler!r}")
    if scheme not in SCHEMES:
        raise ValidationError(f"scheme must be euler|qe, got {scheme!r}")
    if n_steps < 1:
        raise ValidationError(f"n_steps must be positive, got {n_steps}")
    if lr and scheme != "euler":
        raise ValidationError("the LR scores differentiate the Euler transition densities: "
                              "lr needs scheme='euler'")
    if lr and sampler == "sobol_bb":
        raise ValidationError("LR scores assume iid normals — use prng/hash")
    _check_exotic_sampler(sampler, scheme, n_steps)


def _check_exotic_sampler(sampler: str, scheme: str, n_steps: int) -> None:
    """The reference's sampler checks (``_check_exotic_sampler``)."""
    if sampler.startswith("sobol"):
        if sampler != "sobol_bb":
            raise ValidationError("the Heston exotic kernel samplers are prng|hash|sobol_bb")
        if scheme != "euler":
            raise ValidationError("sobol_bb bridge QMC requires the Euler scheme (QE consumes a "
                                  "third uniform stream the bridge cannot pin)")
        if n_steps < 2:
            raise ValidationError("sobol_bb needs n_steps >= 2")


# ---------------------------------------------------------------------------
# The kernel: plain version
# ---------------------------------------------------------------------------
def _exotic_block_plain(seed, block, p, book, *, kind, n_steps, cp, period, sampler, scheme, lr,
                        jumps):
    """Per-lane moment terms (each (nb, ROWS, LANES) float32, the lane's two
    antithetic branches summed) of path blocks ``block``: a line-by-line twin
    of the reference's ``_heston_exotic_kernel`` body."""
    nb = block.shape[0]
    shape = (nb, ROWS, LANES)
    dev = p.device
    s0, inv_n, rdt, dt, sqrt_dt = (p[i] for i in (_HX_S0, _HX_INVN, _HX_RDT, _HX_DT, _HX_SQDT))
    rid = torch.arange(ROWS, device=dev)
    per_row = book[rid % book.shape[0]]  # (ROWS, 7): contract = row % nc
    strike, log_b, pA, pB, pC, pD, pE = (per_row[:, j].reshape(1, ROWS, 1) for j in range(7))
    mu_dt = p[_HX_DYN]
    if scheme == "euler":
        kappa, theta, sigma_v, rho, srho, v0 = (p[_HX_DYN + j] for j in range(1, 7))
        coeffs = (mu_dt, dt, sqrt_dt, kappa, theta, sigma_v, None, None)
    else:
        qe_c = [p[_HX_DYN + j] for j in range(10)]
        v0 = p[_HX_DYN + 10]
    if jumps:
        jb = _HX_DYN + _TAIL[scheme]
        thr0, thr1, thr2, mu_j, sigma_j, lam = (p[jb + j] for j in range(_N_JUMP))

    hit_pay = kind.endswith("_hit")
    double = "double" in kind
    barrier_up = "up" in kind
    knock_in = kind.endswith("in")
    qmc = sampler == "sobol_bb"
    residual = "hash" if qmc else sampler
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    one = zero + 1.0

    def f(b):
        return b.to(torch.float32)

    def hit_test(x):
        if double:
            return f((x <= pA) | (x >= pB))
        return f(x >= log_b) if barrier_up else f(x <= log_b)

    def init_stat():
        if kind in ("asian_arith", "asian_geo", "range_accrual") or kind.startswith("lookback"):
            return (zero,)  # sums, accrual counter, or the extremum of x seeded at x0 = 0
        if kind == "cliquet":
            return (zero, zero)  # (period-start x, capped-return sum)
        if kind == "autocall":
            return (one, zero, zero) + ((zero,) if lr else ())  # (alive, knocked in, pv[, dr])
        h0 = zero + hit_test(torch.zeros((), device=dev))  # x0 = 0 beyond a level: hit
        if hit_pay:
            return (h0, h0) + ((zero,) if lr else ())  # (hit, pv = df at the first hit[, dr])
        return (h0,)

    def update_stat(stat, x, i):
        if kind == "asian_arith":
            return (stat[0] + torch.exp(x),)
        if kind == "asian_geo":
            return (stat[0] + x,)
        if kind.startswith("lookback"):
            lo = (cp > 0) == (kind == "lookback_float")  # float call / fixed put: min
            return ((torch.minimum if lo else torch.maximum)(stat[0], x),)
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
        if kind == "cliquet":
            return pE * torch.clamp(stat[1], pC, pD)
        if kind == "autocall":
            return stat[2] + stat[0] * df_t * autocall_final(stat, x)  # discounted in-kernel
        if hit_pay:
            return stat[1]  # df at the hit carried in the kernel (host df = 1)
        if "touch" in kind:
            return stat[0] if kind.startswith("one") else (1.0 - stat[0])
        if kind == "range_accrual":
            return pE * stat[0] * inv_n
        vanilla = torch.clamp_min(cp * (s_t - strike), 0.0)
        return vanilla * (stat[0] if knock_in else (1.0 - stat[0]))

    df_t = torch.exp(-rdt * float(n_steps))

    def autocall_final(stat, x):
        loss = torch.clamp_min(1.0 - torch.exp(x), 0.0)
        return pE * (1.0 - stat[1] * loss)

    if lr:
        srho_g = torch.clamp_min(srho, 1e-4)
        mu_over_dt = mu_dt / dt
        two_dt = 2.0 * dt

    def scores(v, zv, zo):
        """The step's rate score ds and maturity score ts of one branch (the
        joint density at fixed endpoints), gated where v⁺ = 0."""
        ind = f(v > 0.0)
        vp = v * ind
        sq = sqrt_rn(vp)
        inv_sqvdt = ind / (torch.clamp_min(sq, 1e-6) * sqrt_dt)
        ds = zo * dt * inv_sqvdt / srho_g
        kth = kappa * (theta - vp)
        ts = (zv * kth / sigma_v * inv_sqvdt
              + zo * (mu_over_dt - 0.5 * vp - rho * kth / sigma_v) * inv_sqvdt / srho_g
              + ind * (zv * zv + zo * zo - 2.0) / two_dt)
        return ds, ts

    xa, xb = zero, zero
    va = vb = v0.expand(shape)
    sta, stb = init_stat(), init_stat()
    zv0 = zo0 = sra = srb = tta = ttb = zero

    def body(i, offs):
        nonlocal xa, va, xb, vb, sta, stb, zv0, zo0, sra, srb, tta, ttb
        zv, zo = draw_normals(residual, seed, block, i, n_steps, ROWS, LANES)
        if offs is None:
            zva, zoa, zvb, zob = zv, zo, -zv, -zo
        else:  # conditional-law residuals pinned to the shared bridge targets
            ovp, oop, ovm, oom = offs
            zva, zoa = zv + ovp, zo + oop
            zvb, zob = -zv + ovm, -zo + oom
        if scheme == "qe":  # the spot shock is the independent normal zo
            u = draw_uniform(residual, seed, block, i, n_steps, ROWS, LANES)
            xa, va = _qe_advance(xa, va, qe_c, zva, zoa, u)
            xb, vb = _qe_advance(xb, vb, qe_c, zvb, zob, 1.0 - u)
        else:
            if lr:
                dsa, tsa = scores(va, zva, zoa)
                dsb, tsb = scores(vb, zvb, zob)
            xa, va, _ = _euler_step(xa, va, [], coeffs, zva, zoa, rho * zva + srho * zoa)
            xb, vb, _ = _euler_step(xb, vb, [], coeffs, zvb, zob, rho * zvb + srho * zob)
        if jumps:
            # compound-Poisson log-jump: the count shared by the pair, the
            # size normal mirrored
            uj, zj = draw_jump(residual, seed, block, i, n_steps, ROWS, LANES)
            n_j = f(uj > thr0) + f(uj > thr1) + f(uj > thr2)
            jsz = sigma_j * sqrt_rn(n_j)
            xa = xa + n_j * mu_j + jsz * zj
            xb = xb + n_j * mu_j - jsz * zj
            if lr:  # the Poisson dt-score: ∂ ln P(n | λdt)/∂dt = n/dt − λ
                tj = n_j / dt - lam
                tsa = tsa + tj
                tsb = tsb + tj
        sta = update_stat(sta, xa, i)
        stb = update_stat(stb, xb, i)
        if lr:
            if i == 0:
                zv0, zo0 = zv, zo
            sra, srb = sra + dsa, srb + dsb
            tta, ttb = tta + tsa, ttb + tsb

    if qmc:
        for a, b, offs in _bridge_offsets(seed, block, n_steps, LANES, zero, QMC_SALT):
            for i in range(a, b):
                body(i, offs)
    else:
        for i in range(n_steps):
            body(i, None)

    moms = [zero] * _n_moments(kind, lr)
    if lr:
        v0g = torch.clamp_min(v0, 1e-8)
        sq_v0dt = sqrt_rn(v0g * dt)
        inv_v0 = 1.0 / v0g
        half_inv_v0 = 0.5 * inv_v0
        a_head = (kappa * dt - 1.0) / (sigma_v * sq_v0dt)
        b_head = sqrt_dt / (2.0 * sqrt_rn(v0g))
    for sign, x, st, sr, ts in ((1.0, xa, sta, sra, tta), (-1.0, xb, stb, srb, ttb)):
        pay = payoff(st, x)
        terms = [pay, pay * pay]
        if lr:
            zvs, zos = (zv0, zo0) if sign > 0 else (-zv0, -zo0)
            zxs = rho * zvs + srho * zos
            # score_v0 = −zv₀·a − zo₀·(b − ρa)/√(1−ρ²) − 1/v0 with a = ∂zv₀/∂v0,
            # b = ∂zx₀/∂v0 at fixed path
            a_t = a_head - zvs * half_inv_v0
            b_t = b_head - zxs * half_inv_v0
            sc_v = -zvs * a_t - zos * (b_t - rho * a_t) / srho_g - inv_v0
            terms += [pay * zos, pay * (zos * zos - 1.0), pay * sc_v, pay * sr, pay * ts]
            if hit_pay:
                terms.append(st[2])
            elif kind == "autocall":  # DR: the carried legs plus the final redemption's
                t_total = dt * float(n_steps)
                terms.append(st[3] - st[0] * t_total * df_t * autocall_final(st, x))
        moms = [m + t for m, t in zip(moms, terms)]
    return moms


def _heston_exotic_plain(seed: int, block0: int, params: torch.Tensor, book: torch.Tensor, *,
                         kind: str, n_steps: int, n_blocks: int, cp: float, period: int = 1,
                         sampler: str = "prng", scheme: str = "euler", lr: bool = False,
                         jumps: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: per-row sums ``(n_mom, ROWS)``
    float32 of ``n_blocks`` path blocks from ``block0``. Runs on any
    device."""
    _check_launch(kind, sampler, scheme, lr, n_steps)
    return _sum_blocks(
        lambda blk: _exotic_block_plain(seed, blk, params, book, kind=kind, n_steps=n_steps,
                                        cp=float(cp), period=period, sampler=sampler,
                                        scheme=scheme, lr=lr, jumps=jumps),
        n_blocks, block0, LANES, (_n_moments(kind, lr),), params.device)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------
_SAMPLER_ID = {"prng": 0, "hash": 1, "sobol_bb": 2}
_SCHEME_ID = {"euler": 0, "qe": 1}
# payoff families of csrc/heston_exotic.cu (a template parameter each)
(_F_ASIAN_ARITH, _F_ASIAN_GEO, _F_LOOKBACK, _F_HIT, _F_HIT_AT, _F_CLIQUET, _F_AUTOCALL,
 _F_RANGE) = range(8)
_SIDE = {"up": 0, "down": 1, "double": 2}
_HIT_PAY = {"out": 0, "in": 1, "one_touch": 2, "no_touch": 3}


def _kernel_codes(kind: str, cp: float) -> tuple[int, int]:
    """(family, mode) of a kind: the family is a template parameter of the
    CUDA kernel, the mode a runtime argument (lookback: bit 0 floating, bit 1
    running minimum; barrier/touch: side | payoff << 2; pay-at-hit touches:
    side)."""
    fixed = {"asian_arith": _F_ASIAN_ARITH, "asian_geo": _F_ASIAN_GEO, "cliquet": _F_CLIQUET,
             "autocall": _F_AUTOCALL, "range_accrual": _F_RANGE}
    if kind in fixed:
        return fixed[kind], 0
    if kind.startswith("lookback"):
        floating = kind == "lookback_float"
        return _F_LOOKBACK, int(floating) | (int(floating == (cp > 0)) << 1)
    side = _SIDE["double" if "double" in kind else ("up" if "up" in kind else "down")]
    if kind.endswith("_hit"):
        return _F_HIT_AT, side
    if "touch" in kind:
        pay = _HIT_PAY["one_touch" if kind.startswith("one") else "no_touch"]
    else:
        pay = _HIT_PAY["in" if kind.endswith("in") else "out"]
    return _F_HIT, side | (pay << 2)


def _heston_exotic_cuda(seed: int, block0: int, params: torch.Tensor, book: torch.Tensor, *,
                        kind: str, n_steps: int, n_blocks: int, cp: float, period: int = 1,
                        sampler: str = "prng", scheme: str = "euler", lr: bool = False,
                        jumps: bool = False) -> torch.Tensor:
    """The kernel: per-row sums ``(n_mom, ROWS)`` float32 on the card.
    Launches on PyTorch's current stream and does not synchronize.
    ``_heston_exotic_cuda.launches`` counts its launches."""
    _check_launch(kind, sampler, scheme, lr, n_steps)
    dev = params.device
    _require_cuda("_heston_exotic_cuda", dev)
    nc = book.shape[0] if book.dim() == 2 else 0
    if nc < 1 or nc > ROWS or ROWS % nc:
        raise ValueError(f"book must have a power-of-two row count dividing {ROWS}, got {nc}")
    _check_tensor("params", params, dev, (n_params(scheme, jumps),))
    _check_tensor("book", book, dev, (nc, 7))
    if n_blocks < 1 or period < 1:
        raise ValueError(f"n_blocks {n_blocks} and period {period} must be positive")
    n_chunks, per_chunk = _chunking(n_blocks)
    family, mode = _kernel_codes(kind, cp)
    plan_i, plan_f = (_bridge_plan_arrays(n_steps, _BRIDGE_LEVELS) if sampler == "sobol_bb"
                      else (np.zeros(32, np.int32), np.zeros(23, np.float32)))
    lib = _build.load_library()
    n_mom = _n_moments(kind, lr)
    partials = torch.empty((n_mom, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, ROWS), dtype=torch.float32, device=dev)
    err = lib.heston_exotic_moments(
        params.data_ptr(), book.data_ptr(), nc, int(seed) & 0xFFFFFFFF,
        int(block0) & 0xFFFFFFFF, n_blocks, per_chunk, n_chunks, n_steps, period, float(cp),
        family, mode, _SCHEME_ID[scheme], int(jumps), _SAMPLER_ID[sampler], int(lr), n_mom,
        plan_i.ctypes.data, plan_f.ctypes.data, partials.data_ptr(), out.data_ptr(), dev.index,
        _stream(dev))
    _launch_checked("heston_exotic_moments", err)
    _count(_heston_exotic_cuda)
    return out


_heston_exotic_cuda.launches = 0


# ---------------------------------------------------------------------------
# Host side: parameter vectors, moments → price / stderr / Greeks
# ---------------------------------------------------------------------------
def _exotic_params(spot, strike, maturity, rate, params, dividend, barrier, n_steps, scheme):
    """(parameter list of Python floats, t). ``params`` is a HestonParams or
    a BatesParams: the Bates tail (inverse-CDF count thresholds P(N ≤ k),
    k = 0..2, the size parameters and the intensity) is appended and the
    −λ·k̄ compensator folds into the drift. The kernel reads the float32
    rounding of each value, as the reference's."""
    t = max(float(maturity), EPS_TIME)
    dt = t / n_steps
    mu = float(rate) - float(dividend)
    bates = hasattr(params, "lam")
    if bates:
        lam = float(params.lam)
        mu_j, sig_j = float(params.mu_j), float(params.sigma_j)
        kbar = math.exp(mu_j + 0.5 * sig_j**2) - 1.0
        mu -= lam * kbar
    log_b = (math.log(max(float(barrier), 1e-30) / float(spot)) if float(barrier) > 0.0
             else 0.0)
    head = [float(spot), float(strike), log_b, 1.0 / n_steps, float(rate) * dt, dt,
            math.sqrt(dt), 0.0, 0.0, 0.0, 0.0, 0.0]
    if scheme == "qe":
        tail = _qe_consts(float(params.kappa), float(params.theta), float(params.sigma),
                          float(params.rho), float(params.v0), dt, mu)
    else:
        rho = float(params.rho)
        tail = [mu * dt, float(params.kappa), float(params.theta), float(params.sigma), rho,
                math.sqrt(max(1.0 - rho * rho, 0.0)), float(params.v0)]
    if bates:
        ld = lam * dt
        p0 = math.exp(-ld)
        tail += [p0, p0 * (1.0 + ld), p0 * (1.0 + ld + 0.5 * ld * ld), mu_j, sig_j, lam]
    return head + tail, t


def _set_double_band(p, spot, lower, upper) -> None:
    """The double-barrier band into the relative-log A/B slots."""
    if not 0.0 < lower < upper:
        raise ValidationError("double kinds need 0 < lower < upper")
    p[_HX_A] = math.log(float(lower) / float(spot))
    p[_HX_B] = math.log(float(upper) / float(spot))


def _lr_scalars(spot, t, rate, params, n_steps) -> np.ndarray:
    """[spot, t, df, v0, dt, √(1−ρ²), rate], float32 as the reference's."""
    return np.asarray([float(spot), t, math.exp(-float(rate) * t), float(params.v0),
                       t / n_steps, math.sqrt(max(1.0 - float(params.rho) ** 2, 0.0)),
                       float(rate)], np.float32)


def _run(p, book, *, device, seed, **kw) -> torch.Tensor:
    """Per-row moment sums of one launch; ``book`` is a (nc, 7) table or
    None (one contract: the slots of ``p``)."""
    if book is None:
        book = [[p[j] for j in _BOOK_SLOTS]]
    dev = torch.device(device)
    params = torch.tensor(np.asarray(p, np.float32), device=dev)
    book_t = torch.tensor(np.asarray(book, np.float32), device=dev)
    return _dispatch(_heston_exotic_cuda, _heston_exotic_plain, dev, seed, 0, params, book_t,
                     **kw)


def _price(kind, p, *, df, n_paths, n_steps, seed, sampler, scheme, params, device, cp=1.0,
           period=1):
    """(price, stderr, paths) of one price launch."""
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
    pay, pay2 = _run(p, None, device=device, seed=seed, kind=kind, n_steps=n_steps,
                     n_blocks=n_blocks, cp=float(cp), period=period, sampler=sampler,
                     scheme=scheme, jumps=hasattr(params, "lam"))
    price, se = _mean_stderr(pay, pay2, n_blocks * PATHS_PER_BLOCK, df, sampler)
    return price, se, n_blocks * PATHS_PER_BLOCK


def _combine_exotic_lr(means, n: int, scalars, n_steps: int, discounted: bool = False) -> dict:
    """Moment means (float64 tensors, global or per contract) → price,
    stderr, delta, gamma, vega_v0, vega, rho, theta. ``scalars``:
    :func:`_lr_scalars`. D1 and DG are zo₀-scores (the joint-density LR),
    hence the 1/(√(1−ρ²)·√(v0 dt)) scaling; theta = r·price − df·E[pay·TS]/n
    (TS sums the per-step dt scores at a fixed step count).
    ``discounted=True`` (autocall, pay-at-hit): the payoff is discounted in
    the kernel, so df = 1 and the DR moment completes rho and theta."""
    spot, t, df, v0, dt, srho, rate = (float(s) for s in scalars[:7])
    if discounted:
        df = 1.0
    pay_m, pay2_m, d1_m, dg_m, dv_m, sr_m, ts_m = means[:7]
    price = df * pay_m
    var = torch.clamp_min(pay2_m - pay_m * pay_m, 0.0)
    c = 1.0 / (max(srho, 1e-4) * math.sqrt(v0 * dt))
    dv0 = df * dv_m
    score_t_m = ts_m / n_steps
    out = {
        "price": price,
        "std_error": df * torch.sqrt(var / n),
        "delta": df * d1_m * c / spot,
        "gamma": df * (dg_m * c * c - d1_m * c) / (spot * spot),
        "vega_v0": dv0,
        "vega": 2.0 * math.sqrt(v0) * dv0,
    }
    if discounted:
        dr_m = means[7]
        out["rho"] = sr_m + dr_m
        out["theta"] = -score_t_m - rate / t * dr_m
    else:
        out["rho"] = df * sr_m - t * price
        out["theta"] = rate * price - df * score_t_m
    return {k: _f32(v) for k, v in out.items()}


def _lr(kind, p, t, *, spot, rate, params, cp, period, n_paths, n_steps, seed, sampler,
        device) -> dict:
    """One ``lr`` launch → the LR ladder dict (float32 tensors) + ``paths``."""
    if sampler.startswith("sobol"):
        raise ValidationError("LR scores assume iid normals — use prng/hash")
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
    sums = _run(p, None, device=device, seed=seed, kind=kind, n_steps=n_steps,
                n_blocks=n_blocks, cp=float(cp), period=period, sampler=sampler, scheme="euler",
                lr=True, jumps=hasattr(params, "lam"))
    n = n_blocks * PATHS_PER_BLOCK
    out = _combine_exotic_lr(list(sums.double().sum(dim=1) / n), n,
                             _lr_scalars(spot, t, rate, params, n_steps), n_steps,
                             discounted=kind == "autocall" or kind.endswith("_hit"))
    out["paths"] = n
    return out


def heston_kernel_exotic_price(kind: str, spot, strike, maturity, rate, params, cp: float = 1.0,
                               dividend: float = 0.0, barrier: float = 0.0,
                               n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                               sampler: str = "prng", scheme: str = "euler", lower: float = 0.0,
                               upper: float = 0.0, device="cuda"):
    """``(price, stderr, actual_paths)`` of an exotic under Heston (or Bates)
    in one kernel launch.

    ``kind`` ∈ :data:`HESTON_EXOTIC_KINDS` except the structured kinds
    (their own functions); the payoff conventions are the GBM exotic
    kernel's. ``scheme``: ``euler`` (full truncation) or ``qe`` (Andersen).
    ``sampler="sobol_bb"`` (Euler, ``n_steps >= 2``): hybrid bridge QMC
    pinning 4 dyadic z-sum coordinates on each of the variance and
    orthogonal spot streams, hash residuals per segment, with the
    8-replicate randomized-QMC stderr. Price and stderr are float32 tensors
    on ``device``."""
    if kind not in HESTON_EXOTIC_KINDS:
        raise ValidationError(f"unknown heston exotic kind {kind!r}; choose {HESTON_EXOTIC_KINDS}")
    if kind in STRUCTURED:
        raise ValidationError(f"use heston_kernel_{kind}_price for structured params")
    _check_exotic_sampler(sampler, scheme, n_steps)
    p, t = _exotic_params(spot, strike, maturity, rate, params, dividend, barrier, n_steps,
                          scheme)
    if "double" in kind:
        _set_double_band(p, spot, lower, upper)
    # pay-at-hit kinds discount in the kernel at the hit step: host df = 1
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * t)
    return _price(kind, p, df=df, n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler,
                  scheme=scheme, params=params, device=device, cp=cp)


def heston_kernel_exotic_lr_greeks(kind: str, spot, strike, maturity, rate, params,
                                   cp: float = 1.0, dividend: float = 0.0, barrier: float = 0.0,
                                   n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                                   sampler: str = "prng", lower: float = 0.0, upper: float = 0.0,
                                   device="cuda") -> dict:
    """Price + likelihood-ratio delta/gamma/vega_v0/vega/rho/theta in one
    kernel pass (Euler), for any non-structured kind, barriers and touches
    included (their pathwise derivative is zero almost everywhere).

    The scores differentiate the Euler transition densities: the spot
    scores use the first step's independent shock zo₀, the v0 score is the
    exact ∂ln p/∂v0 of the two step-0 transitions, the rate and maturity
    scores sum per-step terms gated where v⁺ = 0. ``vega`` is 2√v0·vega_v0;
    ``theta`` is −dV/dT at a fixed step count. The dict carries ``paths``."""
    if kind not in HESTON_EXOTIC_KINDS or kind in STRUCTURED:
        raise ValidationError(f"use heston_kernel_{kind}_lr_greeks for structured params"
                              if kind in STRUCTURED else f"unknown heston exotic kind {kind!r}")
    if sampler.startswith("sobol"):
        raise ValidationError("LR scores assume iid normals — use prng/hash")
    p, t = _exotic_params(spot, strike, maturity, rate, params, dividend, barrier, n_steps,
                          "euler")
    if "double" in kind:
        _set_double_band(p, spot, lower, upper)
    return _lr(kind, p, t, spot=spot, rate=rate, params=params, cp=cp, period=1,
               n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler, device=device)


# ---------------------------------------------------------------------------
# Structured products: cliquet, autocall, range accrual
# ---------------------------------------------------------------------------
def _cliquet_params(spot, maturity, rate, params, dividend, local_floor, local_cap,
                    global_floor, global_cap, notional, n_periods, n_steps, scheme):
    if n_periods <= 0 or n_steps % n_periods:
        raise ValidationError("n_steps must be a positive multiple of n_periods")
    p, t = _exotic_params(spot, 0.0, maturity, rate, params, dividend, 0.0, n_steps, scheme)
    p[_HX_A], p[_HX_B] = float(local_floor), float(local_cap)
    p[_HX_C], p[_HX_D] = float(global_floor), float(global_cap)
    p[_HX_E] = float(notional)
    return p, t


def _autocall_params(spot, maturity, rate, params, dividend, notional, autocall_barrier,
                     coupon_barrier, ki_barrier, coupon_rate, n_obs, n_steps, scheme):
    if n_obs <= 0 or n_steps % n_obs:
        raise ValidationError("n_steps must be a positive multiple of n_obs")
    p, t = _exotic_params(spot, 0.0, maturity, rate, params, dividend, 0.0, n_steps, scheme)
    p[_HX_A] = math.log(max(float(autocall_barrier), 1e-9))
    p[_HX_B] = math.log(max(float(coupon_barrier), 1e-9))
    p[_HX_C] = math.log(max(float(ki_barrier), 1e-9))
    p[_HX_D] = float(notional) * float(coupon_rate) / n_obs
    p[_HX_E] = float(notional)
    return p, t


def _range_params(spot, lower, upper, maturity, rate, params, dividend, notional, n_steps,
                  scheme):
    if not 0.0 < lower < upper:
        raise ValidationError("need 0 < lower < upper")
    p, t = _exotic_params(spot, 0.0, maturity, rate, params, dividend, 0.0, n_steps, scheme)
    p[_HX_A] = math.log(float(lower) / float(spot))
    p[_HX_B] = math.log(float(upper) / float(spot))
    p[_HX_E] = float(notional)
    return p, t


_FROZEN_FIXINGS = {
    "cliquet": ("frozen-fixings hedge delta: initial fixing held at its current level (the "
                "scale-invariant unconditional delta is 0)"),
    "autocall": ("frozen-fixings hedge delta: barriers held at their inception levels (the "
                 "scale-invariant unconditional delta is 0)"),
}


def heston_kernel_cliquet_price(spot, maturity, rate, params, dividend: float = 0.0,
                                local_floor: float = -0.05, local_cap: float = 0.05,
                                global_floor: float = 0.0, global_cap: float = 1e9,
                                notional: float = 100.0, n_periods: int = 12,
                                n_paths: int = 1_000_000, n_steps: int = 252, seed: int = 0,
                                sampler: str = "prng", scheme: str = "euler", device="cuda"):
    """Cliquet under Heston or Bates in one launch: ``(price, stderr,
    actual_paths)`` (scan oracle: ``models.heston_exotics.
    heston_cliquet_price``)."""
    p, t = _cliquet_params(spot, maturity, rate, params, dividend, local_floor, local_cap,
                           global_floor, global_cap, notional, n_periods, n_steps, scheme)
    _check_exotic_sampler(sampler, scheme, n_steps)
    return _price("cliquet", p, df=math.exp(-float(rate) * t), n_paths=n_paths, n_steps=n_steps,
                  seed=seed, sampler=sampler, scheme=scheme, params=params, device=device,
                  period=n_steps // n_periods)


def heston_kernel_cliquet_lr_greeks(spot, maturity, rate, params, dividend: float = 0.0,
                                    local_floor: float = -0.05, local_cap: float = 0.05,
                                    global_floor: float = 0.0, global_cap: float = 1e9,
                                    notional: float = 100.0, n_periods: int = 12,
                                    n_paths: int = 1_000_000, n_steps: int = 252, seed: int = 0,
                                    sampler: str = "prng", device="cuda") -> dict:
    """Cliquet price + LR ladder in one pass: vega_v0/rho/theta are the
    forward-smile sensitivities; delta/gamma are frozen-fixings hedge
    sensitivities (``delta_convention``)."""
    p, t = _cliquet_params(spot, maturity, rate, params, dividend, local_floor, local_cap,
                           global_floor, global_cap, notional, n_periods, n_steps, "euler")
    out = _lr("cliquet", p, t, spot=spot, rate=rate, params=params, cp=1.0,
              period=n_steps // n_periods, n_paths=n_paths, n_steps=n_steps, seed=seed,
              sampler=sampler, device=device)
    out["delta_convention"] = _FROZEN_FIXINGS["cliquet"]
    return out


def heston_kernel_autocall_price(spot, maturity, rate, params, dividend: float = 0.0,
                                 notional: float = 100.0, autocall_barrier: float = 1.0,
                                 coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                                 coupon_rate: float = 0.08, n_obs: int = 4,
                                 n_paths: int = 1_000_000, n_steps: int = 252, seed: int = 0,
                                 sampler: str = "prng", scheme: str = "euler", device="cuda"):
    """Autocallable under Heston or Bates in one launch: ``(price, stderr,
    actual_paths)``. Barrier levels are relative to spot (compared in log
    space in the kernel); coupons and redemptions are discounted in the
    kernel (scan oracle: ``models.heston_exotics.heston_autocall_price``)."""
    p, _t = _autocall_params(spot, maturity, rate, params, dividend, notional, autocall_barrier,
                             coupon_barrier, ki_barrier, coupon_rate, n_obs, n_steps, scheme)
    _check_exotic_sampler(sampler, scheme, n_steps)
    return _price("autocall", p, df=1.0, n_paths=n_paths, n_steps=n_steps, seed=seed,
                  sampler=sampler, scheme=scheme, params=params, device=device,
                  period=n_steps // n_obs)


def heston_kernel_autocall_lr_greeks(spot, maturity, rate, params, dividend: float = 0.0,
                                     notional: float = 100.0, autocall_barrier: float = 1.0,
                                     coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                                     coupon_rate: float = 0.08, n_obs: int = 4,
                                     n_paths: int = 1_000_000, n_steps: int = 252,
                                     seed: int = 0, sampler: str = "prng",
                                     device="cuda") -> dict:
    """Autocall LR ladder under Heston or Bates in one pass; the DR moment
    (−Σ tᵢ·dfᵢ·cashᵢ, the redemption included) completes rho and theta.
    delta/gamma are frozen-fixings hedge sensitivities."""
    p, t = _autocall_params(spot, maturity, rate, params, dividend, notional, autocall_barrier,
                            coupon_barrier, ki_barrier, coupon_rate, n_obs, n_steps, "euler")
    out = _lr("autocall", p, t, spot=spot, rate=rate, params=params, cp=1.0,
              period=n_steps // n_obs, n_paths=n_paths, n_steps=n_steps, seed=seed,
              sampler=sampler, device=device)
    out["delta_convention"] = _FROZEN_FIXINGS["autocall"]
    return out


def heston_kernel_range_accrual_price(spot, lower, upper, maturity, rate, params,
                                      dividend: float = 0.0, notional: float = 100.0,
                                      n_paths: int = 1_000_000, n_steps: int = 252,
                                      seed: int = 0, sampler: str = "prng",
                                      scheme: str = "euler", device="cuda"):
    """Range-accrual note under Heston or Bates in one launch: ``(price,
    stderr, actual_paths)``; the corridor is compared in relative log space
    in the kernel."""
    p, t = _range_params(spot, lower, upper, maturity, rate, params, dividend, notional,
                         n_steps, scheme)
    _check_exotic_sampler(sampler, scheme, n_steps)
    return _price("range_accrual", p, df=math.exp(-float(rate) * t), n_paths=n_paths,
                  n_steps=n_steps, seed=seed, sampler=sampler, scheme=scheme, params=params,
                  device=device)


def heston_kernel_range_accrual_lr_greeks(spot, lower, upper, maturity, rate, params,
                                          dividend: float = 0.0, notional: float = 100.0,
                                          n_paths: int = 1_000_000, n_steps: int = 252,
                                          seed: int = 0, sampler: str = "prng",
                                          device="cuda") -> dict:
    """Range-accrual LR ladder under Heston or Bates (Euler): the payoff is
    indicators only, so the joint-density scores are its Greeks."""
    p, t = _range_params(spot, lower, upper, maturity, rate, params, dividend, notional,
                         n_steps, "euler")
    return _lr("range_accrual", p, t, spot=spot, rate=rate, params=params, cp=1.0, period=1,
               n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler, device=device)


# ---------------------------------------------------------------------------
# Contract books: one launch prices N contracts under one Heston/Bates dynamics
# ---------------------------------------------------------------------------
def _heston_book_vec(kind, spot, strikes, barriers, lowers, uppers):
    """The (nc_pad, 7) book [K, log(B/S0), log(L/S0), log(U/S0), 0, 0, 0],
    the levels in relative log space (the kernel compares x directly).
    Returns (book, nc, nc_pad, strikes, barriers, lowers, uppers) with the
    lists normalized."""
    strikes, barriers, lowers, uppers = _book_lists(kind, strikes, barriers, lowers, uppers)
    nc = len(strikes)
    spot = float(spot)
    log_bs = [math.log(max(b, 1e-30) / spot) if b > 0.0 else 0.0 for b in barriers]
    if "double" in kind:
        a_log = [math.log(lo / spot) for lo in lowers]
        b_log = [math.log(up / spot) for up in uppers]
    else:
        a_log = b_log = [0.0] * nc
    nc_pad = _book_pad(nc)
    return (_book_table(strikes, log_bs, a_log, b_log, nc_pad), nc, nc_pad, strikes, barriers,
            lowers, uppers)


def _check_heston_book_call(kind, sampler, scheme, n_steps) -> None:
    if kind not in HESTON_EXOTIC_KINDS or kind in STRUCTURED:
        raise ValidationError(f"book pricing supports the non-structured exotic kinds: "
                              f"got {kind!r}")
    if sampler.startswith("sobol"):
        raise ValidationError("book launches support prng|hash samplers (the QMC replicate "
                              "groups ride the row axis the book interleaves)")
    _check_exotic_sampler(sampler, scheme, n_steps)


def _book_run(kind, spot, strikes, maturity, rate, params, cp, dividend, barriers, lowers,
              uppers, n_paths, n_steps, seed, sampler, scheme, device, lr):
    """One book launch: (per-contract means (n_mom, nc) float64, n per
    contract, nc, t)."""
    _check_heston_book_call(kind, sampler, scheme, n_steps)
    book, nc, nc_pad, strikes, barriers, lowers, uppers = _heston_book_vec(
        kind, spot, strikes, barriers, lowers, uppers)
    # contract 0's levels also ride the scalar vector, as the reference's
    # single-contract books need
    p, t = _exotic_params(spot, strikes[0], maturity, rate, params, dividend, barriers[0],
                          n_steps, scheme)
    if "double" in kind:
        _set_double_band(p, spot, lowers[0], uppers[0])
    paths_per_block = (ROWS // nc_pad) * LANES * 2
    n_blocks = _n_blocks(n_paths, paths_per_block)
    sums = _run(p, book, device=device, seed=seed, kind=kind, n_steps=n_steps, n_blocks=n_blocks,
                cp=float(cp), sampler=sampler, scheme=scheme, lr=lr,
                jumps=hasattr(params, "lam"))
    n = n_blocks * paths_per_block
    means = sums.double().reshape(sums.shape[0], ROWS // nc_pad, nc_pad).sum(dim=1)[:, :nc] / n
    return means, n, t


def heston_kernel_exotic_book_price(kind: str, spot, strikes, maturity, rate, params,
                                    cp: float = 1.0, dividend: float = 0.0, barriers=None,
                                    lowers=None, uppers=None, n_paths: int = 1_000_000,
                                    n_steps: int = 64, seed: int = 0, sampler: str = "prng",
                                    scheme: str = "euler", device="cuda"):
    """Price a book of same-kind exotics (mixed strikes / barriers / bands)
    under one Heston/Bates dynamics in one kernel launch. Contracts
    interleave the rows (contract = row % nc, the book padded to a power of
    two); ``n_paths`` is per contract. Returns ``(prices, stderrs,
    n_paths)`` with one entry per contract."""
    means, n, t = _book_run(kind, spot, strikes, maturity, rate, params, cp, dividend, barriers,
                            lowers, uppers, n_paths, n_steps, seed, sampler, scheme, device,
                            lr=False)
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * t)
    var = torch.clamp_min(means[1] - means[0] * means[0], 0.0)
    return _f32(df * means[0]), _f32(df * torch.sqrt(var / n)), n


def heston_kernel_exotic_book_lr_greeks(kind: str, spot, strikes, maturity, rate, params,
                                        cp: float = 1.0, dividend: float = 0.0, barriers=None,
                                        lowers=None, uppers=None, n_paths: int = 1_000_000,
                                        n_steps: int = 64, seed: int = 0, sampler: str = "prng",
                                        device="cuda") -> dict:
    """Per-contract price + LR delta/gamma/vega_v0/vega/rho/theta of a book
    under one Heston/Bates dynamics in one launch (Euler; ``n_paths`` per
    contract). Every value has one entry per contract, plus ``paths``."""
    means, n, t = _book_run(kind, spot, strikes, maturity, rate, params, cp, dividend, barriers,
                            lowers, uppers, n_paths, n_steps, seed, sampler, "euler", device,
                            lr=True)
    out = _combine_exotic_lr(list(means), n, _lr_scalars(spot, t, rate, params, n_steps),
                             n_steps, discounted=kind.endswith("_hit"))
    out["paths"] = n
    return out
