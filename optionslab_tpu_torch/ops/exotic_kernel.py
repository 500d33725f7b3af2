"""Path-dependent (exotic) GBM Monte Carlo: price, LR and pathwise Greek
ladders, and contract books, each in one kernel pass.

The port of ``optionslab_tpu/ops/exotic_pallas.py``. Two kernels:

* ``csrc/exotic_mc.cu`` (the port of ``_exotic_kernel``) simulates every
  path through all time steps, carrying the running statistic of the payoff
  (sum, log-sum, extremum, barrier state, coupon state) and, with ``lr``,
  the likelihood-ratio scores; it returns per-row sums of pay, pay² and the
  score moments D1/DG/DZ/D2 (+DR);
* ``csrc/exotic_greeks.cu`` (the port of ``_exotic_greeks_kernel``) returns
  per-row sums of pay, pay², P0, G1 and G2 for the pathwise ladder of
  Asians and lookbacks.

Geometry. ``ROWS``, ``LANES`` and ``LANES_G`` keep the reference's meaning:
a path block is ``ROWS × LANES`` lanes of four antithetic paths each. On the
card they are no longer a tiling; they are the counter space from which the
``hash`` and ``sobol_bb`` samplers draw (row ``r``, lane ``c`` of block
``b``), so the path set is the reference's own and the port is checked
against it path for path. Book contracts interleave the rows
(contract = row % nc).

Dispatch. Tensors on a CUDA device go through the kernel wrappers
(:func:`_exotic_moments_cuda`, :func:`_exotic_greeks_cuda`), which raise if
they cannot build or launch; tensors on the CPU go through the plain torch
versions (:func:`_exotic_moments_plain`, :func:`_exotic_greeks_plain`),
which compute the same sums from the same counters with the same float32
arithmetic in the same order. The public functions take a ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .kernel_rng import (
    GOLDEN,
    GROUP_SALT,
    HASH_SALT,
    box_muller,
    bridge_plan,
    draw_normals,
    fmix32,
    sobol_nd,
    wrap32,
)

ROWS = 128  # path-block rows (the reference's sublanes)
LANES = 512  # path-block lanes, price kernel
LANES_G = 256  # path-block lanes, Greeks kernel

PAYOFF_KINDS = (
    "asian_arith", "asian_geo", "lookback_float", "lookback_fixed",
    "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out",
    "barrier_down-and-in", "cliquet", "autocall",
    # digital barriers: unit cash at expiry if the barrier was hit (one-touch)
    # or never hit (no-touch) on the monitoring grid
    "one_touch_up", "one_touch_down", "no_touch_up", "no_touch_down",
    # arithmetic Asian minus its geometric control variate (the exact
    # closed-form mean is added back on the host)
    "asian_arith_cv",
    # notional × fraction of monitoring steps with L <= S <= U, at expiry
    "range_accrual",
    # knock band (lower, upper) monitored every step, and its digital pair
    "barrier_double-out", "barrier_double-in",
    "one_touch_double", "no_touch_double",
    # pay-at-hit one-touches: unit cash discounted at the first hit step
    "one_touch_up_hit", "one_touch_down_hit", "one_touch_double_hit",
)
GREEK_KINDS = ("asian_arith", "asian_geo", "lookback_float", "lookback_fixed")
SAMPLERS = ("prng", "hash", "sobol_bb", "sobol_bb_hash")

# the 14 float32 parameter slots of a launch
(_P_S0, _P_K, _P_DRIFT_DT, _P_VOLSQDT, _P_BARRIER, _P_INV_N, _P_GROWTH,
 _P_RDT, _P_SQDT, _P_A, _P_B, _P_C, _P_D, _P_E) = range(14)
N_PARAMS = 14
# per-contract book slots: K, BARRIER, A, B, C, D, E
_BOOK_SLOTS = (_P_K, _P_BARRIER, _P_A, _P_B, _P_C, _P_D, _P_E)

PATHS_PER_BLOCK = 4 * ROWS * LANES
PATHS_PER_BLOCK_G = 4 * ROWS * LANES_G

# CUDA blocks a launch aims for (rows × chunks): a constant, not read from the
# card, so the summation order depends only on the geometry
_TARGET_CTAS = 4096
# lanes (blocks × rows × lanes) per step of the plain versions' block loop
_PLAIN_CHUNK_ELEMS = 1 << 22
_LAUNCH_LOCK = threading.Lock()  # the server launches from several threads


def _check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValidationError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")


def _is_qmc(sampler: str) -> bool:
    return sampler.startswith("sobol_bb")


def _n_moments(kind: str, lr: bool) -> int:
    if not lr:
        return 2
    return 7 if (kind == "autocall" or kind.endswith("_hit")) else 6


def _chunking(n_blocks: int) -> tuple[int, int]:
    """(n_chunks, blocks_per_chunk) of a kernel's launch grid."""
    n_chunks = max(1, min(n_blocks, -(-_TARGET_CTAS // ROWS)))
    per_chunk = -(-n_blocks // n_chunks)
    return -(-n_blocks // per_chunk), per_chunk


def _block_ids(block0: int, start: int, stop: int, device) -> torch.Tensor:
    """Global path-block ids ``block0 + [start, stop)`` as int32 (nb, 1, 1)."""
    ids = [wrap32(block0 + b) for b in range(start, stop)]
    return torch.tensor(ids, dtype=torch.int32, device=device).reshape(-1, 1, 1)


# ---------------------------------------------------------------------------
# Price kernel: plain version
# ---------------------------------------------------------------------------
def _exotic_block_plain(seed, block, p, book, *, kind, n_steps, cp, period, sampler, lr):
    """Moment tensors (each (nb, ROWS, LANES) float32, one term per lane
    summed over its 4 antithetic branches) of path blocks ``block``.

    A line-by-line twin of the reference kernel's body: the same counters,
    the same float32 operations in the same order.
    """
    nb = block.shape[0]
    shape = (nb, ROWS, LANES)
    dev = p.device
    s0, drift_dt, vol_sqrt_dt, inv_n, growth, rdt = (
        p[i] for i in (_P_S0, _P_DRIFT_DT, _P_VOLSQDT, _P_INV_N, _P_GROWTH, _P_RDT))
    inv_s0 = 1.0 / s0
    dt = p[_P_SQDT] * p[_P_SQDT]
    rid = torch.arange(ROWS, device=dev)
    per_row = book[rid % book.shape[0]]  # (ROWS, 7): contract = row % nc
    strike, barrier, pA, pB, pC, pD, pE = (per_row[:, j].reshape(1, ROWS, 1) for j in range(7))

    hit_pay = kind.endswith("_hit")
    barrier_up = "up" in kind
    knock_in = kind.endswith("in")
    geo = kind.startswith("asian_geo")
    qmc = _is_qmc(sampler)
    residual = "hash" if (qmc or sampler.endswith("hash")) else "prng"
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    one = zero + 1.0

    def hit_test(s):
        if "double" in kind:
            return ((s <= pA) | (s >= pB)).to(torch.float32)
        return ((s >= barrier) if barrier_up else (s <= barrier)).to(torch.float32)

    def init_stat(s_like):
        if kind == "asian_arith_cv":
            return (s_like, zero)
        if kind.startswith("asian_arith"):
            return (s_like,)
        if geo or kind == "range_accrual":
            return (zero,)
        if kind.startswith("lookback"):
            return (s_like,)
        if kind == "cliquet":
            return (s_like, zero)
        if kind == "autocall":
            return (one, zero, zero) + ((zero,) if lr else ())
        h0 = hit_test(s_like)
        if hit_pay:
            return (h0, h0) + ((zero,) if lr else ())
        return (h0,)

    def update_stat(stat, s, i):
        if kind == "asian_arith_cv":
            return (stat[0] + s, stat[1] + torch.log(s * inv_s0))
        if kind.startswith("asian"):
            return (stat[0] + s,)
        if kind.startswith("lookback"):
            use_min = (kind == "lookback_float") == (cp > 0)
            return (torch.minimum(stat[0], s) if use_min else torch.maximum(stat[0], s),)
        if kind == "cliquet":
            s_start, acc = stat
            is_end = 1.0 if (i + 1) % period == 0 else 0.0
            capped = torch.clamp(s / s_start - 1.0, pA, pB)
            return (s_start + is_end * (s - s_start), acc + is_end * capped)
        if kind == "autocall":
            alive, ki, pv = stat[:3]
            ki = torch.maximum(ki, (s <= pC).to(torch.float32))
            is_obs = 1.0 if (i + 1) % period == 0 else 0.0
            df_i = torch.exp(-rdt * float(i + 1))
            called = alive * is_obs * (s >= pA).to(torch.float32)
            couponed = alive * is_obs * (s >= pB).to(torch.float32)
            cash = pD * couponed + pE * called
            pv = pv + df_i * cash
            alive = alive * (1.0 - called)
            if lr:
                t_i = dt * float(i + 1)
                return (alive, ki, pv, stat[3] - t_i * df_i * cash)
            return (alive, ki, pv)
        if kind == "range_accrual":
            return (stat[0] + ((s >= pA) & (s <= pB)).to(torch.float32),)
        now = hit_test(s)
        if hit_pay:
            h, pv = stat[:2]
            newly = (1.0 - h) * now
            steps = float(i + 1)
            df_i = torch.exp(-rdt * steps)
            pv = pv + newly * df_i
            if lr:
                return (torch.maximum(h, now), pv, stat[2] - steps * dt * newly * df_i)
            return (torch.maximum(h, now), pv)
        return (torch.maximum(stat[0], now),)

    def payoff(stat, s):
        s_t = s0 * torch.exp(s) if geo else s
        if kind == "asian_arith_cv":
            avg = (stat[0] - s0) * inv_n
            geo_avg = s0 * torch.exp(stat[1] * inv_n)
            return (torch.clamp_min(cp * (avg - strike), 0.0)
                    - torch.clamp_min(cp * (geo_avg - strike), 0.0))
        if kind.startswith("asian"):
            avg = (stat[0] - s0) * inv_n if kind == "asian_arith" else s0 * torch.exp(stat[0] * inv_n)
            return torch.clamp_min(cp * (avg - strike), 0.0)
        if kind == "lookback_float":
            return (s_t - stat[0]) if cp > 0 else (stat[0] - s_t)
        if kind == "lookback_fixed":
            return torch.clamp_min(cp * (stat[0] - strike), 0.0)
        if kind == "cliquet":
            return pE * torch.clamp(stat[1], pC, pD)
        if kind == "autocall":
            alive, ki, pv = stat[:3]
            df_t = torch.exp(-rdt * float(n_steps))
            loss = torch.clamp_min(1.0 - s_t / s0, 0.0)
            final = pE * (1.0 - ki * loss)
            return pv + alive * df_t * final
        if hit_pay:
            return stat[1]
        if "touch" in kind:
            return stat[0] if kind.startswith("one") else (1.0 - stat[0])
        if kind == "range_accrual":
            return pE * stat[0] * inv_n
        vanilla = torch.clamp_min(cp * (s_t - strike), 0.0)
        return vanilla * (stat[0] if knock_in else (1.0 - stat[0]))

    # geo always, and every kind under QMC, carries relative log-spots
    state0 = zero if (geo or qmc) else s0.expand(shape)
    states = [state0] * 4
    stats = [init_stat(s0.expand(shape))] * 4
    scores = [zero] * 6  # z1 at step 0 (cos, sin), Σz (cos, sin), Σ(z²-1) (cos, sin)

    def body(i, offs):
        nonlocal states, stats, scores
        xa, xb, xc, xd = states
        z1, z2 = draw_normals(residual, seed, block, i, n_steps, ROWS, LANES)
        if offs is not None:
            oc_p, oc_m, os_p, os_m = offs
            xa = xa + drift_dt + vol_sqrt_dt * (z1 + oc_p)
            xb = xb + drift_dt + vol_sqrt_dt * (-z1 + oc_m)
            xc = xc + drift_dt + vol_sqrt_dt * (z2 + os_p)
            xd = xd + drift_dt + vol_sqrt_dt * (-z2 + os_m)
        elif geo:
            xa = xa + drift_dt + vol_sqrt_dt * z1
            xb = xb + drift_dt - vol_sqrt_dt * z1
            xc = xc + drift_dt + vol_sqrt_dt * z2
            xd = xd + drift_dt - vol_sqrt_dt * z2
        else:
            # the antithetic shares the exponential: e^{-s·z} = 1/e^{s·z}
            w1 = torch.exp(vol_sqrt_dt * z1)
            w2 = torch.exp(vol_sqrt_dt * z2)
            xa = xa * (growth * w1)
            xb = xb * growth / w1
            xc = xc * (growth * w2)
            xd = xd * growth / w2
        states = [xa, xb, xc, xd]
        in_price = offs is not None and not geo
        stats = [update_stat(st, s0 * torch.exp(x) if in_price else x, i)
                 for st, x in zip(stats, states)]
        if lr:
            zf1, zf2, sz1, sz2, szz1, szz2 = scores
            scores = [z1 if i == 0 else zf1, z2 if i == 0 else zf2, sz1 + z1, sz2 + z2,
                      szz1 + z1 * z1 - 1.0, szz2 + z2 * z2 - 1.0]

    if qmc:
        for a, b, offs in _bridge_offsets(seed, block, n_steps, residual, zero):
            for i in range(a, b):
                body(i, offs)
    else:
        for i in range(n_steps):
            body(i, None)

    zf1, zf2, sz1, sz2, szz1, szz2 = scores
    branch_scores = ((zf1, sz1, szz1), (-zf1, -sz1, szz1), (zf2, sz2, szz2), (-zf2, -sz2, szz2))
    n_mom = _n_moments(kind, lr)
    moms = [zero] * n_mom
    for x, st, (zf, sz, szz) in zip(states, stats, branch_scores):
        pay = payoff(st, s0 * torch.exp(x) if (qmc and not geo) else x)
        terms = [pay, pay * pay]
        if lr:
            terms += [pay * zf, pay * (zf * zf - 1.0), pay * sz, pay * szz]
            if hit_pay:
                terms.append(st[2])
            elif kind == "autocall":
                alive, ki = st[0], st[1]
                df_t = torch.exp(-rdt * float(n_steps))
                loss = torch.clamp_min(1.0 - x / s0, 0.0)
                final = pE * (1.0 - ki * loss)
                terms.append(st[3] - (dt * float(n_steps)) * df_t * alive * final)
        moms = [m + t for m, t in zip(moms, terms)]
    return moms


def _qmc_scrambles(seed: int, dev, salt: int = HASH_SALT) -> list:
    """Digital shifts of the 8 replicate groups (row & 7), 8 dimensions,
    each as int32 of shape (1, ROWS, 1); ``salt`` seeds the hash chain (the
    Heston exotic kernel's differs from the others')."""
    g_id = torch.arange(ROWS, dtype=torch.int32, device=dev).reshape(1, -1, 1) & 7
    h = fmix32((wrap32(seed) + g_id * GROUP_SALT) * GOLDEN + wrap32(salt))
    scrambles = []
    for _ in range(8):
        scrambles.append(h & ((1 << 30) - 1))
        h = fmix32(h + wrap32(0x9E3779B9))
    return scrambles


def _bridge_offsets(seed, block, n_steps, residual, zero):
    """[(a, b, offsets)] per bridge segment of the ``sobol_bb`` sampler.

    A scrambled Sobol point per lane (8 independently scrambled replicate
    groups, row & 7) pins the terminal sum and up to 7 bisection midpoints
    of the z-sums; each segment's residual normals are shifted by constant
    offsets so that every antithetic branch hits its bridge target.
    """
    dev = block.device
    bounds, constructs = bridge_plan(n_steps, 8)
    n_pairs = (1 + len(constructs) + 1) // 2
    rid = torch.arange(ROWS, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    cid = torch.arange(LANES, dtype=torch.int32, device=dev).reshape(1, 1, -1)
    idx = block * ((ROWS // 8) * LANES) + (rid >> 3) * LANES + cid + 1
    us = sobol_nd(idx, _qmc_scrambles(seed, dev), 2 * n_pairs)
    g = []
    for k in range(n_pairs):
        g.extend(box_muller(us[2 * k], us[2 * k + 1]))
    csum = {0: zero, n_steps: math.sqrt(float(n_steps)) * g[0]}
    for (m, a, b), gd in zip(constructs, g[1:]):
        frac = (m - a) / (b - a)
        sd = math.sqrt((m - a) * (b - m) / (b - a))
        csum[m] = csum[a] + (csum[b] - csum[a]) * frac + sd * gd
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        sc, ss = zero, zero
        for i in range(a, b):
            z1, z2 = draw_normals(residual, seed, block, i, n_steps, ROWS, LANES)
            sc = sc + z1
            ss = ss + z2
        target = csum[b] - csum[a]
        inv = 1.0 / (b - a)
        out.append((a, b, ((target - sc) * inv, (target + sc) * inv,
                           (target - ss) * inv, (target + ss) * inv)))
    return out


def _exotic_moments_plain(seed: int, block0: int, params: torch.Tensor, book: torch.Tensor,
                          *, kind: str, n_steps: int, n_blocks: int, cp: float,
                          period: int = 1, sampler: str = "prng",
                          lr: bool = False) -> torch.Tensor:
    """Plain torch version of the price kernel: per-row moment sums
    ``(n_mom, ROWS)`` float32 of ``n_blocks`` path blocks from ``block0``.

    Per-lane float32 arithmetic as in the kernel; sums are taken in float64
    and over the blocks in bounded steps. Runs on any device.
    """
    _check_launch(kind, sampler, lr, n_steps)
    dev = params.device
    sums = torch.zeros((_n_moments(kind, lr), ROWS), dtype=torch.float64, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (ROWS * LANES))
    for b in range(0, n_blocks, step):
        block = _block_ids(block0, b, min(n_blocks, b + step), dev)
        moms = _exotic_block_plain(seed, block, params, book, kind=kind, n_steps=n_steps,
                                   cp=float(cp), period=period, sampler=sampler, lr=lr)
        for m, term in enumerate(moms):
            sums[m] += term.sum(dim=(0, 2), dtype=torch.float64)
    return sums.to(torch.float32)


def _check_launch(kind: str, sampler: str, lr: bool, n_steps: int) -> None:
    if kind not in PAYOFF_KINDS:
        raise ValidationError(f"unknown exotic kind {kind!r}; choose {PAYOFF_KINDS}")
    _check_sampler(sampler)
    if n_steps < 1:
        raise ValidationError(f"n_steps must be positive, got {n_steps}")
    if _is_qmc(sampler):
        if n_steps < 2:
            raise ValidationError("bridge QMC needs n_steps >= 2 (terminal + "
                                  "midpoint coordinates)")
        if lr:
            raise ValidationError("LR scores assume iid normals; the bridge-QMC "
                                  "samplers correlate increments — use prng/hash")


# ---------------------------------------------------------------------------
# Greeks kernel: plain version
# ---------------------------------------------------------------------------
def _greeks_block_plain(seed, block, p, *, kind, n_steps, cp, sampler):
    """(pay, pay², P0, G1, G2) tensors (nb, ROWS, LANES_G) of path blocks
    ``block``, each lane's 4 branches summed: the twin of the reference's
    ``_exotic_greeks_kernel`` body."""
    shape = (block.shape[0], ROWS, LANES_G)
    s0, strike, drift_dt, vol_sqrt_dt, inv_n, growth, sqdt = (
        p[i] for i in (_P_S0, _P_K, _P_DRIFT_DT, _P_VOLSQDT, _P_INV_N, _P_GROWTH, _P_SQDT))
    geo = kind == "asian_geo"
    signs = (1.0, -1.0, 1.0, -1.0)  # branch sign on (w1, w1, w2, w2)
    zero = torch.zeros(shape, dtype=torch.float32, device=p.device)
    state0 = zero if geo else s0.expand(shape)
    xs = [state0] * 4
    w1 = w2 = zero
    # asian: (Σ S or Σ log S, Σ S·W or Σ W, Σ S·(i/n)); lookback: (extremum,
    # W at the extremum, i/n at the extremum)
    auxs = [(zero, zero, zero) if kind.startswith("asian") else (state0, zero, zero)] * 4
    minimum = (kind == "lookback_float") == (cp > 0)
    for i in range(n_steps):
        z1, z2 = draw_normals(sampler, seed, block, i, n_steps, ROWS, LANES_G)
        w1 = w1 + sqdt * z1
        w2 = w2 + sqdt * z2
        if geo:
            xs = [xs[0] + drift_dt + vol_sqrt_dt * z1, xs[1] + drift_dt - vol_sqrt_dt * z1,
                  xs[2] + drift_dt + vol_sqrt_dt * z2, xs[3] + drift_dt - vol_sqrt_dt * z2]
        else:
            e1 = torch.exp(vol_sqrt_dt * z1)
            e2 = torch.exp(vol_sqrt_dt * z2)
            xs = [xs[0] * (growth * e1), xs[1] * growth / e1,
                  xs[2] * (growth * e2), xs[3] * growth / e2]
        frac = float(i + 1) * inv_n  # t_{i+1}/T
        new_auxs = []
        for b, (x, aux) in enumerate(zip(xs, auxs)):
            wb = signs[b] * (w1 if b < 2 else w2)
            if kind == "asian_arith":
                asum, aw, ai = aux
                new_auxs.append((asum + x, aw + x * wb, ai + x * frac))
            elif geo:
                lsum, cw, _ = aux
                new_auxs.append((lsum + x, cw + wb, zero))
            else:
                m, mw, mt = aux
                better = (x < m) if minimum else (x > m)
                new_auxs.append((torch.where(better, x, m), torch.where(better, wb, mw),
                                 torch.where(better, frac, mt)))
        auxs = new_auxs

    moms = [zero] * 5
    for b, (x, aux) in enumerate(zip(xs, auxs)):
        wb = signs[b] * (w1 if b < 2 else w2)
        if kind == "asian_arith":
            asum, aw, ai = aux
            avg = asum * inv_n
            pay = torch.clamp_min(cp * (avg - strike), 0.0)
            ind = (pay > 0).to(torch.float32)
            p0 = cp * ind * avg
            g1 = cp * ind * aw * inv_n
            g2 = cp * ind * ai * inv_n
        elif geo:
            lsum, cw, _ = aux
            avg = s0 * torch.exp(lsum * inv_n)
            pay = torch.clamp_min(cp * (avg - strike), 0.0)
            ind = (pay > 0).to(torch.float32)
            p0 = cp * ind * avg
            g1 = cp * ind * avg * cw * inv_n
            g2 = zero  # the host substitutes (n+1)/(2n) · P0
        elif kind == "lookback_fixed":
            m, mw, mt = aux
            pay = torch.clamp_min(cp * (m - strike), 0.0)
            ind = (pay > 0).to(torch.float32)
            p0 = cp * ind * m
            g1 = cp * ind * m * mw
            g2 = cp * ind * m * mt
        else:  # lookback_float: pay = cp·(S_T − m), homogeneous of degree 1
            m, mw, mt = aux
            pay = cp * (x - m)
            p0 = pay
            g1 = cp * (x * wb - m * mw)
            g2 = cp * (x * 1.0 - m * mt)
        moms = [a + v for a, v in zip(moms, (pay, pay * pay, p0, g1, g2))]
    return moms


def _check_greeks_launch(kind: str, sampler: str, n_steps: int) -> None:
    if kind not in GREEK_KINDS:
        raise ValidationError(
            f"in-kernel Greeks support {GREEK_KINDS}; for {kind!r} use the scan "
            "engine's AD (models/exotics.exotic_greeks) — barrier indicators have "
            "zero pathwise derivative")
    if sampler not in ("prng", "hash"):
        raise ValidationError("the Greeks kernel supports prng/hash only")
    if n_steps < 1:
        raise ValidationError(f"n_steps must be positive, got {n_steps}")


def _exotic_greeks_plain(seed: int, block0: int, params: torch.Tensor, *, kind: str,
                         n_steps: int, n_blocks: int, cp: float,
                         sampler: str = "prng") -> torch.Tensor:
    """Plain torch version of the Greeks kernel: per-row sums ``(5, ROWS)``
    float32 of pay, pay², P0, G1 and G2. Runs on any device."""
    _check_greeks_launch(kind, sampler, n_steps)
    dev = params.device
    sums = torch.zeros((5, ROWS), dtype=torch.float64, device=dev)
    step = max(1, _PLAIN_CHUNK_ELEMS // (ROWS * LANES_G))
    for b in range(0, n_blocks, step):
        block = _block_ids(block0, b, min(n_blocks, b + step), dev)
        moms = _greeks_block_plain(seed, block, params, kind=kind, n_steps=n_steps,
                                   cp=float(cp), sampler=sampler)
        for m, term in enumerate(moms):
            sums[m] += term.sum(dim=(0, 2), dtype=torch.float64)
    return sums.to(torch.float32)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------
_SAMPLER_ID = {"prng": 0, "hash": 1, "sobol_bb": 2, "sobol_bb_hash": 2}
# payoff families of csrc/exotic_mc.cu (a template parameter each)
(_F_ASIAN_ARITH, _F_ASIAN_GEO, _F_ASIAN_CV, _F_LOOKBACK, _F_HIT, _F_HIT_AT, _F_CLIQUET,
 _F_AUTOCALL, _F_RANGE) = range(9)
_SIDE = {"up": 0, "down": 1, "double": 2}
_HIT_PAY = {"out": 0, "in": 1, "one_touch": 2, "no_touch": 3}


def _kernel_codes(kind: str, cp: float) -> tuple[int, int]:
    """(family, mode) of a payoff kind: the family is a template parameter
    of the CUDA kernel, the mode a runtime argument (lookback: bit 0 floating,
    bit 1 running minimum; barrier/touch: side | payoff << 2; pay-at-hit
    touches: side)."""
    fixed = {"asian_arith": _F_ASIAN_ARITH, "asian_geo": _F_ASIAN_GEO,
             "asian_arith_cv": _F_ASIAN_CV, "cliquet": _F_CLIQUET,
             "autocall": _F_AUTOCALL, "range_accrual": _F_RANGE}
    if kind in fixed:
        return fixed[kind], 0
    if kind.startswith("lookback"):
        floating = kind == "lookback_float"
        return _F_LOOKBACK, int(floating) | (int(floating == (cp > 0)) << 1)
    side = _SIDE["double" if "double" in kind else ("up" if "up" in kind else "down")]
    if kind.endswith("_hit"):  # pay-at-hit touches
        return _F_HIT_AT, side
    if "touch" in kind:
        pay = _HIT_PAY["one_touch" if kind.startswith("one") else "no_touch"]
    else:
        pay = _HIT_PAY["in" if kind.endswith("in") else "out"]
    return _F_HIT, side | (pay << 2)


def _bridge_plan_arrays(n_steps: int, max_levels: int = 8):
    """The ``sobol_bb`` bridge plan (``bridge_plan(n_steps, max_levels)``,
    ``max_levels`` <= 8) as the C entry points take it: 32 int32 (n_seg,
    bounds[9], n_con, mid[7], lo[7], hi[7]; the last three index the sorted
    bounds) and 23 float32 (√n, frac[7], sd[7], 1/len per segment [8])."""
    ints = np.zeros(32, np.int32)
    floats = np.zeros(23, np.float32)
    bounds, constructs = bridge_plan(n_steps, max_levels)
    pos = {b: j for j, b in enumerate(bounds)}
    ints[0] = len(bounds) - 1
    ints[1:1 + len(bounds)] = bounds
    ints[10] = len(constructs)
    floats[0] = math.sqrt(float(n_steps))
    for j, (m, a, b) in enumerate(constructs):
        ints[11 + j], ints[18 + j], ints[25 + j] = pos[m], pos[a], pos[b]
        floats[1 + j] = (m - a) / (b - a)
        floats[8 + j] = math.sqrt((m - a) * (b - m) / (b - a))
    for j, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        floats[15 + j] = 1.0 / (b - a)
    return ints, floats


def _check_tensor(name, t, dev, shape) -> None:
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 of shape {shape} on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_checked(fn_name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn_name} launch failed: {_build.error_string(err)} ({err})")


def _exotic_moments_cuda(seed: int, block0: int, params: torch.Tensor, book: torch.Tensor,
                         *, kind: str, n_steps: int, n_blocks: int, cp: float,
                         period: int = 1, sampler: str = "prng",
                         lr: bool = False) -> torch.Tensor:
    """The price kernel: per-row moment sums ``(n_mom, ROWS)`` float32 on the
    card. Launches on PyTorch's current stream and does not synchronize.
    ``_exotic_moments_cuda.launches`` counts its launches."""
    _check_launch(kind, sampler, lr, n_steps)
    dev = params.device
    if dev.type != "cuda":
        raise ValueError(f"_exotic_moments_cuda needs CUDA tensors, got {dev}")
    nc = book.shape[0] if book.dim() == 2 else 0
    if nc < 1 or nc > ROWS or ROWS % nc:
        raise ValueError(f"book must have a power-of-two row count dividing {ROWS}, got {nc}")
    _check_tensor("params", params, dev, (N_PARAMS,))
    _check_tensor("book", book, dev, (nc, 7))
    if n_blocks < 1 or period < 1:
        raise ValueError(f"n_blocks {n_blocks} and period {period} must be positive")
    n_chunks, per_chunk = _chunking(n_blocks)
    family, mode = _kernel_codes(kind, cp)
    plan_i, plan_f = _bridge_plan_arrays(n_steps) if _is_qmc(sampler) else (
        np.zeros(32, np.int32), np.zeros(23, np.float32))
    lib = _build.load_library()
    n_mom = _n_moments(kind, lr)
    partials = torch.empty((n_mom, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, ROWS), dtype=torch.float32, device=dev)
    err = lib.exotic_mc_moments(
        params.data_ptr(), book.data_ptr(), nc, int(seed) & 0xFFFFFFFF,
        int(block0) & 0xFFFFFFFF, n_blocks, per_chunk, n_chunks, n_steps, period, float(cp),
        family, mode, _SAMPLER_ID[sampler], int(lr), n_mom, plan_i.ctypes.data,
        plan_f.ctypes.data, partials.data_ptr(), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _launch_checked("exotic_mc_moments", err)
    with _LAUNCH_LOCK:
        _exotic_moments_cuda.launches += 1
    return out


_exotic_moments_cuda.launches = 0

_GREEK_KIND_ID = {k: i for i, k in enumerate(GREEK_KINDS)}


def _exotic_greeks_cuda(seed: int, block0: int, params: torch.Tensor, *, kind: str,
                        n_steps: int, n_blocks: int, cp: float,
                        sampler: str = "prng") -> torch.Tensor:
    """The Greeks kernel: per-row sums ``(5, ROWS)`` float32 on the card.
    ``_exotic_greeks_cuda.launches`` counts its launches."""
    _check_greeks_launch(kind, sampler, n_steps)
    dev = params.device
    if dev.type != "cuda":
        raise ValueError(f"_exotic_greeks_cuda needs CUDA tensors, got {dev}")
    _check_tensor("params", params, dev, (N_PARAMS,))
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    n_chunks, per_chunk = _chunking(n_blocks)
    lib = _build.load_library()
    partials = torch.empty((5, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((5, ROWS), dtype=torch.float32, device=dev)
    err = lib.exotic_greeks_moments(
        params.data_ptr(), int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF, n_blocks,
        per_chunk, n_chunks, n_steps, float(cp), _GREEK_KIND_ID[kind], _SAMPLER_ID[sampler],
        partials.data_ptr(), out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _launch_checked("exotic_greeks_moments", err)
    with _LAUNCH_LOCK:
        _exotic_greeks_cuda.launches += 1
    return out


_exotic_greeks_cuda.launches = 0


def _exotic_moments(seed, block0, params, book, **kw) -> torch.Tensor:
    """The price kernel for CUDA tensors, its plain version for CPU tensors."""
    dev = params.device
    if dev.type == "cuda":
        return _exotic_moments_cuda(seed, block0, params, book, **kw)
    if dev.type == "cpu":
        return _exotic_moments_plain(seed, block0, params, book, **kw)
    raise ValueError(f"no exotic kernel for device {dev}")


def _exotic_greeks_moments(seed, block0, params, **kw) -> torch.Tensor:
    """The Greeks kernel for CUDA tensors, its plain version for CPU tensors."""
    dev = params.device
    if dev.type == "cuda":
        return _exotic_greeks_cuda(seed, block0, params, **kw)
    if dev.type == "cpu":
        return _exotic_greeks_plain(seed, block0, params, **kw)
    raise ValueError(f"no exotic Greeks kernel for device {dev}")


# ---------------------------------------------------------------------------
# Host side: parameters, moments → price / stderr / Greeks
# ---------------------------------------------------------------------------
def _base_params(spot, strike, maturity, rate, vol, dividend, barrier, n_steps):
    """The 14 parameter slots (Python floats) and the clamped maturity."""
    if n_steps < 1:
        raise ValidationError(f"n_steps must be positive, got {n_steps}")
    t = max(float(maturity), EPS_TIME)
    dt = t / n_steps
    drift_dt = (float(rate) - float(dividend) - 0.5 * float(vol) ** 2) * dt
    p = [0.0] * N_PARAMS
    p[_P_S0] = float(spot)
    p[_P_K] = float(strike)
    p[_P_DRIFT_DT] = drift_dt
    p[_P_VOLSQDT] = float(vol) * math.sqrt(dt)
    p[_P_BARRIER] = float(barrier)
    p[_P_INV_N] = 1.0 / n_steps
    p[_P_GROWTH] = math.exp(drift_dt)  # full-precision host exp
    p[_P_RDT] = float(rate) * dt
    p[_P_SQDT] = math.sqrt(dt)
    return p, t


def _n_blocks(n_paths: int, paths_per_block: int) -> int:
    return max(1, math.ceil(n_paths / paths_per_block))


def _run(p, book, *, device, seed=0, **kw) -> torch.Tensor:
    """Per-row moment sums of one launch; ``book`` is a (nc, 7) array or None
    (one contract: the slots of ``p``)."""
    if book is None:
        book = [[p[j] for j in _BOOK_SLOTS]]
    dev = torch.device(device)
    params = torch.tensor(np.asarray(p, np.float32), device=dev)
    book_t = torch.tensor(np.asarray(book, np.float32), device=dev)
    return _exotic_moments(seed, 0, params, book_t, **kw)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _mean_stderr(pay: torch.Tensor, pay2: torch.Tensor, n: int, df: float, sampler: str):
    """(price, stderr) float32 from per-row sums, computed in float64.

    Plain samplers: sqrt(Var/n). QMC samplers (``sobol_bb*``, and the
    multi-asset kernel's ``sobol``): the 8 row groups (row & 7) are
    independently scrambled replicates, and the stderr is the std of their
    means over sqrt(8) — the randomized-QMC replication estimate."""
    pay = pay.double()
    mean = pay.sum() / n
    if sampler.startswith("sobol"):
        rep = pay.reshape(ROWS // 8, 8).sum(dim=0) * (8.0 / n)
        se = rep.std(correction=1) / math.sqrt(8.0)
    else:
        var = torch.clamp_min(pay2.double().sum() / n - mean * mean, 0.0)
        se = torch.sqrt(var / n)
    return _f32(df * mean), _f32(df * se)


def _check_double(kind, lower, upper, p) -> None:
    if "double" in kind:
        if not 0.0 < lower < upper:
            raise ValidationError("double kinds need 0 < lower < upper")
        p[_P_A], p[_P_B] = float(lower), float(upper)


def exotic_price(kind: str, spot, strike, maturity, rate, vol, cp: float = 1.0,
                 dividend: float = 0.0, barrier: float = 0.0, n_paths: int = 1_000_000,
                 n_steps: int = 64, seed: int = 0, sampler: str = "prng",
                 control_variate: bool = False, lower: float = 0.0, upper: float = 0.0,
                 device="cuda"):
    """Exotic price in one kernel launch: ``(price, stderr, actual_paths)``.

    ``kind`` ∈ :data:`PAYOFF_KINDS` except the structured cliquet, autocall
    and range accrual (their own functions). Paths round up to whole blocks
    of ``PATHS_PER_BLOCK``. Samplers: ``prng`` (Philox) and ``hash``, plain
    MC; ``sobol_bb`` / ``sobol_bb_hash`` (the same sampler), hybrid bridge
    QMC with the 8-replicate randomized-QMC stderr.
    ``control_variate=True`` (``asian_arith`` only) prices the difference
    against the geometric Asian on the same paths and adds back its exact
    discrete closed form (Kemna–Vorst); the stderr is the difference's.
    Price and stderr are float32 tensors on ``device``.
    """
    if control_variate:
        if kind != "asian_arith":
            raise ValidationError("control_variate applies to asian_arith "
                                  "(geometric Kemna–Vorst CV)")
        kind = "asian_arith_cv"
    if kind not in PAYOFF_KINDS:
        raise ValidationError(f"unknown exotic kind {kind!r}; choose {PAYOFF_KINDS}")
    if kind in ("cliquet", "autocall", "range_accrual"):
        raise ValidationError(f"use {kind}_price for structured params")
    p, t = _base_params(spot, strike, maturity, rate, vol, dividend, barrier, n_steps)
    _check_double(kind, lower, upper, p)
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
    # pay-at-hit kinds discount in the kernel at the hit step: host df = 1
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * t)
    pay, pay2 = _run(p, None, device=device, seed=seed, kind=kind, n_steps=n_steps,
                     n_blocks=n_blocks, cp=float(cp), sampler=sampler)
    price, se = _mean_stderr(pay, pay2, n_blocks * PATHS_PER_BLOCK, df, sampler)
    if kind == "asian_arith_cv":
        from ..models.exotics import geometric_asian_closed_form

        cf = geometric_asian_closed_form(spot, strike, t, rate, vol, cp, dividend, n_steps)
        price = _f32(price.double() + float(cf))
    return price, se, n_blocks * PATHS_PER_BLOCK


def _structured_params(spot, maturity, rate, vol, dividend, n_steps, **slots):
    p, t = _base_params(spot, 0.0, maturity, rate, vol, dividend, 0.0, n_steps)
    for slot, value in slots.items():
        p[{"A": _P_A, "B": _P_B, "C": _P_C, "D": _P_D, "E": _P_E}[slot]] = float(value)
    return p, t


def _cliquet_params(spot, maturity, rate, vol, dividend, local_floor, local_cap,
                    global_floor, global_cap, notional, n_periods, n_steps):
    if n_periods <= 0 or n_steps % n_periods:
        raise ValidationError("n_steps must be a positive multiple of n_periods")
    return _structured_params(spot, maturity, rate, vol, dividend, n_steps,
                              A=local_floor, B=local_cap, C=global_floor, D=global_cap,
                              E=notional)


def _autocall_params(spot, maturity, rate, vol, dividend, notional, autocall_barrier,
                     coupon_barrier, ki_barrier, coupon_rate, n_obs, n_steps):
    if n_obs <= 0 or n_steps % n_obs:
        raise ValidationError("n_steps must be a positive multiple of n_obs")
    s = float(spot)
    return _structured_params(spot, maturity, rate, vol, dividend, n_steps,
                              A=float(autocall_barrier) * s, B=float(coupon_barrier) * s,
                              C=float(ki_barrier) * s,
                              D=float(notional) * float(coupon_rate) / n_obs, E=notional)


def _range_params(spot, lower, upper, maturity, rate, vol, dividend, notional, n_steps):
    if not 0.0 <= lower < upper:
        raise ValidationError("need 0 <= lower < upper")
    return _structured_params(spot, maturity, rate, vol, dividend, n_steps,
                              A=lower, B=upper, E=notional)


def _structured_price(kind, p, t, rate, *, period, n_paths, n_steps, seed, sampler, device,
                      discounted=False):
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
    pay, pay2 = _run(p, None, device=device, seed=seed, kind=kind, n_steps=n_steps,
                     n_blocks=n_blocks, cp=1.0, period=period, sampler=sampler)
    df = 1.0 if discounted else math.exp(-float(rate) * t)
    price, se = _mean_stderr(pay, pay2, n_blocks * PATHS_PER_BLOCK, df, sampler)
    return price, se, n_blocks * PATHS_PER_BLOCK


def cliquet_price(spot, maturity, rate, vol, dividend: float = 0.0,
                  local_floor: float = -0.05, local_cap: float = 0.05,
                  global_floor: float = 0.0, global_cap: float = 1e9,
                  notional: float = 100.0, n_periods: int = 12,
                  n_paths: int = 1_000_000, n_steps: int = 252, seed: int = 0,
                  sampler: str = "prng", device="cuda"):
    """Cliquet/ratchet in one launch: ``(price, stderr, actual_paths)``."""
    p, t = _cliquet_params(spot, maturity, rate, vol, dividend, local_floor, local_cap,
                           global_floor, global_cap, notional, n_periods, n_steps)
    return _structured_price("cliquet", p, t, rate, period=n_steps // n_periods,
                             n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler,
                             device=device)


def autocall_price(spot, maturity, rate, vol, dividend: float = 0.0,
                   notional: float = 100.0, autocall_barrier: float = 1.0,
                   coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                   coupon_rate: float = 0.08, n_obs: int = 4, n_paths: int = 1_000_000,
                   n_steps: int = 252, seed: int = 0, sampler: str = "prng", device="cuda"):
    """Autocallable/snowball note in one launch: ``(price, stderr,
    actual_paths)``. Coupons and redemptions are discounted in the kernel
    at their observation dates."""
    p, t = _autocall_params(spot, maturity, rate, vol, dividend, notional, autocall_barrier,
                            coupon_barrier, ki_barrier, coupon_rate, n_obs, n_steps)
    return _structured_price("autocall", p, t, rate, period=n_steps // n_obs,
                             n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler,
                             device=device, discounted=True)


def range_accrual_price(spot, lower, upper, maturity, rate, vol, dividend: float = 0.0,
                        notional: float = 100.0, n_paths: int = 1_000_000,
                        n_steps: int = 252, seed: int = 0, sampler: str = "prng",
                        device="cuda"):
    """Range-accrual (corridor) note: notional × fraction of monitoring steps
    with ``lower <= S <= upper``, paid at expiry. ``(price, stderr,
    actual_paths)``; exact oracle ``models.exotics.range_accrual_closed_form``."""
    p, t = _range_params(spot, lower, upper, maturity, rate, vol, dividend, notional, n_steps)
    return _structured_price("range_accrual", p, t, rate, period=1, n_paths=n_paths,
                             n_steps=n_steps, seed=seed, sampler=sampler, device=device)


# ---------------------------------------------------------------------------
# Likelihood-ratio Greek ladders (payoff-agnostic)
# ---------------------------------------------------------------------------
def _lr_ladder(means, n: int, *, spot, sig, t, df, mu, rate, n_steps, discounted) -> dict:
    """Score moments → price, stderr, delta, gamma, vega, rho, theta.

    ``means`` are the per-path means (float64) of pay, pay², D1 = pay·z₁,
    DG = pay·(z₁²−1), DZ = pay·Σzᵢ, D2 = pay·Σ(zᵢ²−1) and, when
    ``discounted`` (the kernel discounted the payoff: autocall, pay-at-hit),
    DR = the explicit ∂pv/∂r moment:

      delta = df·E[D1]/(S0·σ√dt)      gamma = df·(E[DG]/(σ²dt) − E[D1]/(σ√dt))/S0²
      vega  = df·(E[D2]/σ − √dt·E[DZ])
      rho   = df·(√dt/σ)·E[DZ] − T·price          (discounted: + E[DR], no −T·price)
      theta = r·price − df·E[score_T]              (discounted: −E[score_T] − (r/T)·E[DR])
      score_T = Σ(zᵢ²−1)/(2T) + μ√dt/(σT)·Σzᵢ,  μ = r − q − σ²/2.
    """
    pay_m, pay2_m, d1_m, dg_m, dz_m, d2_m = means[:6]
    dt = t / n_steps
    sqdt = math.sqrt(dt)
    price = df * pay_m
    var = torch.clamp_min(pay2_m - pay_m * pay_m, 0.0)
    score_t_m = d2_m / (2.0 * t) + mu * sqdt / (sig * t) * dz_m
    out = {
        "price": price,
        "std_error": df * torch.sqrt(var / n),
        "delta": df * d1_m / (spot * sig * sqdt),
        "gamma": df * (dg_m / (sig * sig * dt) - d1_m / (sig * sqdt)) / (spot * spot),
        "vega": df * (d2_m / sig - sqdt * dz_m),
    }
    if discounted:
        dr_m = means[6]
        out["rho"] = sqdt / sig * dz_m + dr_m
        out["theta"] = -score_t_m - rate / t * dr_m
    else:
        out["rho"] = df * sqdt / sig * dz_m - t * price
        out["theta"] = rate * price - df * score_t_m
    return {k: _f32(v) for k, v in out.items()}


def _lr_greeks(kind, p, t, *, spot, rate, vol, dividend, cp, period, n_paths, n_steps, seed,
               sampler, device) -> dict:
    """One ``lr`` launch → the LR ladder dict (float32 tensors) + ``paths``."""
    discounted = kind == "autocall" or kind.endswith("_hit")
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
    sums = _run(p, None, device=device, seed=seed, kind=kind, n_steps=n_steps,
                n_blocks=n_blocks, cp=float(cp), period=period, sampler=sampler, lr=True)
    n = n_blocks * PATHS_PER_BLOCK
    out = _lr_ladder(list(sums.double().sum(dim=1) / n), n, spot=float(spot), sig=float(vol),
                     t=t, df=1.0 if discounted else math.exp(-float(rate) * t),
                     mu=float(rate) - float(dividend) - 0.5 * float(vol) ** 2,
                     rate=float(rate), n_steps=n_steps, discounted=discounted)
    out["paths"] = n
    return out


def exotic_lr_greeks(kind: str, spot, strike, maturity, rate, vol, cp: float = 1.0,
                     dividend: float = 0.0, barrier: float = 0.0, n_paths: int = 1_000_000,
                     n_steps: int = 64, seed: int = 0, sampler: str = "prng",
                     lower: float = 0.0, upper: float = 0.0, device="cuda") -> dict:
    """Price + likelihood-ratio delta/gamma/vega/rho/theta in one kernel pass,
    for any payoff kind, barriers included (their pathwise derivative is zero
    almost everywhere). The dict also carries ``paths``."""
    if kind not in PAYOFF_KINDS or kind == "asian_arith_cv":
        raise ValidationError(f"unknown exotic kind {kind!r}; choose {PAYOFF_KINDS}")
    if kind in ("cliquet", "autocall", "range_accrual"):
        raise ValidationError(f"use {kind}_lr_greeks for structured params")
    p, t = _base_params(spot, strike, maturity, rate, vol, dividend, barrier, n_steps)
    _check_double(kind, lower, upper, p)
    return _lr_greeks(kind, p, t, spot=spot, rate=rate, vol=vol, dividend=dividend, cp=cp,
                      period=1, n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler,
                      device=device)


def cliquet_lr_greeks(spot, maturity, rate, vol, dividend: float = 0.0,
                      local_floor: float = -0.05, local_cap: float = 0.05,
                      global_floor: float = 0.0, global_cap: float = 1e9,
                      notional: float = 100.0, n_periods: int = 12,
                      n_paths: int = 1_000_000, n_steps: int = 252, seed: int = 0,
                      sampler: str = "prng", device="cuda") -> dict:
    """Cliquet price + LR ladder in one pass (delta/gamma with the initial
    fixing frozen: the hedge sensitivity)."""
    p, t = _cliquet_params(spot, maturity, rate, vol, dividend, local_floor, local_cap,
                           global_floor, global_cap, notional, n_periods, n_steps)
    return _lr_greeks("cliquet", p, t, spot=spot, rate=rate, vol=vol, dividend=dividend,
                      cp=1.0, period=n_steps // n_periods, n_paths=n_paths, n_steps=n_steps,
                      seed=seed, sampler=sampler, device=device)


def autocall_lr_greeks(spot, maturity, rate, vol, dividend: float = 0.0,
                       notional: float = 100.0, autocall_barrier: float = 1.0,
                       coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                       coupon_rate: float = 0.08, n_obs: int = 4, n_paths: int = 1_000_000,
                       n_steps: int = 252, seed: int = 0, sampler: str = "prng",
                       device="cuda") -> dict:
    """Autocall price + LR ladder in one pass; the in-kernel coupon-discount
    derivative (DR moment) completes rho and theta."""
    p, t = _autocall_params(spot, maturity, rate, vol, dividend, notional, autocall_barrier,
                            coupon_barrier, ki_barrier, coupon_rate, n_obs, n_steps)
    return _lr_greeks("autocall", p, t, spot=spot, rate=rate, vol=vol, dividend=dividend,
                      cp=1.0, period=n_steps // n_obs, n_paths=n_paths, n_steps=n_steps,
                      seed=seed, sampler=sampler, device=device)


def range_accrual_lr_greeks(spot, lower, upper, maturity, rate, vol, dividend: float = 0.0,
                            notional: float = 100.0, n_paths: int = 1_000_000,
                            n_steps: int = 252, seed: int = 0, sampler: str = "prng",
                            device="cuda") -> dict:
    """Range-accrual price + LR ladder in one pass."""
    p, t = _range_params(spot, lower, upper, maturity, rate, vol, dividend, notional, n_steps)
    return _lr_greeks("range_accrual", p, t, spot=spot, rate=rate, vol=vol,
                      dividend=dividend, cp=1.0, period=1, n_paths=n_paths, n_steps=n_steps,
                      seed=seed, sampler=sampler, device=device)


# ---------------------------------------------------------------------------
# Contract books: one launch prices a book of same-kind contracts
# ---------------------------------------------------------------------------
_BOOK_KINDS_EXCLUDED = ("cliquet", "autocall", "range_accrual", "asian_arith_cv")


def _book_pad(n_contracts: int) -> int:
    """The book padded to the next power of two (rows interleave contracts:
    contract = row % nc, so nc must divide ROWS)."""
    if not 1 <= n_contracts <= ROWS:
        raise ValidationError(f"book size must be 1..{ROWS}: {n_contracts}")
    p = 1
    while p < n_contracts:
        p *= 2
    return p


def _book_table(strikes, barriers, lowers, uppers, nc_pad) -> list:
    """(nc_pad, 7) rows [K, BARRIER, A, B, C, D, E], padded by repeating the
    last contract."""
    nc = len(strikes)
    return [[float(strikes[j]), float(barriers[j]), float(lowers[j]), float(uppers[j]),
             0.0, 0.0, 0.0] for j in (min(i, nc - 1) for i in range(nc_pad))]


def _book_lists(kind, strikes, barriers, lowers, uppers):
    """Normalize and validate the per-contract parameter lists of ``kind``."""
    strikes = [float(s) for s in strikes]
    nc = len(strikes)
    if nc == 0:
        raise ValidationError("empty contract book")

    def norm(xs, name, need):
        if xs is None:
            if need:
                raise ValidationError(f"kind {kind!r} needs {name} (one per contract)")
            return [0.0] * nc
        xs = [float(x) for x in xs]
        if len(xs) != nc:
            raise ValidationError(f"{name} must have one entry per contract ({nc}): "
                                  f"got {len(xs)}")
        return xs

    needs_band = "double" in kind
    barriers = norm(barriers, "barriers", ("barrier" in kind or "touch" in kind)
                    and not needs_band)
    lowers = norm(lowers, "lowers", needs_band)
    uppers = norm(uppers, "uppers", needs_band)
    if needs_band:
        for lo, up in zip(lowers, uppers):
            if not 0.0 < lo < up:
                raise ValidationError("double kinds need 0 < lower < upper per contract")
    return strikes, barriers, lowers, uppers


def _check_book_call(kind, sampler) -> None:
    if kind not in PAYOFF_KINDS or kind in _BOOK_KINDS_EXCLUDED:
        raise ValidationError(f"book pricing supports the non-structured PAYOFF_KINDS: "
                              f"got {kind!r}")
    _check_sampler(sampler)
    if _is_qmc(sampler):
        raise ValidationError("book launches support prng|hash samplers (the QMC "
                              "replicate groups ride the row axis the book interleaves)")


def _book_run(kind, spot, strikes, maturity, rate, vol, cp, dividend, barriers, lowers,
              uppers, n_paths, n_steps, seed, sampler, device, lr):
    """One book launch: (per-contract means (n_mom, nc) float64, n per
    contract, nc, t, df)."""
    _check_book_call(kind, sampler)
    strikes, barriers, lowers, uppers = _book_lists(kind, strikes, barriers, lowers, uppers)
    nc = len(strikes)
    nc_pad = _book_pad(nc)
    p, t = _base_params(spot, strikes[0], maturity, rate, vol, dividend, barriers[0], n_steps)
    if "double" not in kind:
        lowers = uppers = [0.0] * nc
    paths_per_block = (ROWS // nc_pad) * LANES * 4
    n_blocks = _n_blocks(n_paths, paths_per_block)
    sums = _run(p, _book_table(strikes, barriers, lowers, uppers, nc_pad), device=device,
                seed=seed, kind=kind, n_steps=n_steps, n_blocks=n_blocks, cp=float(cp),
                sampler=sampler, lr=lr)
    n = n_blocks * paths_per_block
    means = sums.double().reshape(sums.shape[0], ROWS // nc_pad, nc_pad).sum(dim=1)[:, :nc] / n
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * t)
    return means, n, t, df


def exotic_book_price(kind: str, spot, strikes, maturity, rate, vol, cp: float = 1.0,
                      dividend: float = 0.0, barriers=None, lowers=None, uppers=None,
                      n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                      sampler: str = "prng", device="cuda"):
    """Price a book of same-kind contracts (mixed strikes / barriers / bands)
    under one GBM in ONE kernel launch. Contracts interleave the rows
    (contract = row % nc, book padded to a power of two); ``n_paths`` is per
    contract. Returns ``(prices, stderrs, n_paths)``, one entry per contract."""
    means, n, _t, df = _book_run(kind, spot, strikes, maturity, rate, vol, cp, dividend,
                                 barriers, lowers, uppers, n_paths, n_steps, seed, sampler,
                                 device, lr=False)
    var = torch.clamp_min(means[1] - means[0] * means[0], 0.0)
    return _f32(df * means[0]), _f32(df * torch.sqrt(var / n)), n


def exotic_book_lr_greeks(kind: str, spot, strikes, maturity, rate, vol, cp: float = 1.0,
                          dividend: float = 0.0, barriers=None, lowers=None, uppers=None,
                          n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                          sampler: str = "prng", device="cuda") -> dict:
    """Per-contract price + LR delta/gamma/vega/rho/theta for a book in ONE
    launch (``n_paths`` per contract); every value has one entry per
    contract, plus ``paths``."""
    means, n, t, df = _book_run(kind, spot, strikes, maturity, rate, vol, cp, dividend,
                                barriers, lowers, uppers, n_paths, n_steps, seed, sampler,
                                device, lr=True)
    out = _lr_ladder(list(means), n, spot=float(spot), sig=float(vol), t=t, df=df,
                     mu=float(rate) - float(dividend) - 0.5 * float(vol) ** 2,
                     rate=float(rate), n_steps=n_steps, discounted=kind.endswith("_hit"))
    out["paths"] = n
    return out


# ---------------------------------------------------------------------------
# Pathwise Greeks (Asians, lookbacks): the Greeks kernel
# ---------------------------------------------------------------------------
def _combine_greeks(sums: torch.Tensor, n: int, *, spot, rate, vol, t, a_drift, df, kind,
                    n_steps) -> dict:
    """P0/G1/G2 row sums → the first-order ladder, in float64:

      delta = df·E[P0]/S0,  vega = df·(E[G1] − σT·E[G2]),  rho = −T·price + df·T·E[G2],
      theta = r·price − df·(a·E[G2] + σ/(2T)·E[G1]),  dividend_rho = −df·T·E[G2],

    with a = r − q − σ²/2; for ``asian_geo`` E[G2] = (n+1)/(2n)·E[P0] exactly."""
    pay_m, pay2_m, p0_m, g1_m, g2_m = list(sums.double().sum(dim=1) / n)
    if kind == "asian_geo":
        g2_m = 0.5 * (1.0 + 1.0 / n_steps) * p0_m  # Σ(i/n)/n = (n+1)/(2n)
    price = df * pay_m
    var = torch.clamp_min(pay2_m - pay_m * pay_m, 0.0)
    out = {
        "price": price,
        "std_error": df * torch.sqrt(var / n),
        "delta": df * p0_m / spot,
        "vega": df * (g1_m - vol * t * g2_m),
        "rho": -t * price + df * t * g2_m,
        "theta": rate * price - df * (a_drift * g2_m + vol / (2.0 * t) * g1_m),
        "dividend_rho": -df * t * g2_m,
    }
    return {k: _f32(v) for k, v in out.items()}


def exotic_greeks(kind: str, spot, strike, maturity, rate, vol, cp: float = 1.0,
                  dividend: float = 0.0, n_paths: int = 1_000_000, n_steps: int = 64,
                  seed: int = 0, sampler: str = "prng", device="cuda") -> dict:
    """Exotic price + pathwise delta/vega/rho/theta/dividend_rho in ONE pass
    of the Greeks kernel (``kind`` ∈ :data:`GREEK_KINDS`). Chain rules:
    ∂S_i/∂S0 = S_i/S0, ∂S_i/∂σ = S_i(W_i − σt_i), ∂S_i/∂r = S_i t_i,
    ∂S_i/∂T = S_i(a·t_i/T + σW_i/(2T)). For ``lookback_fixed`` with
    K = S0 exactly, delta is ill-defined (an atom at the kink). The dict
    carries ``paths``."""
    _check_greeks_launch(kind, sampler, n_steps)
    p, t = _base_params(spot, strike, maturity, rate, vol, dividend, 0.0, n_steps)
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK_G)
    params = torch.tensor(np.asarray(p, np.float32), device=torch.device(device))
    sums = _exotic_greeks_moments(seed, 0, params, kind=kind, n_steps=n_steps,
                                  n_blocks=n_blocks, cp=float(cp), sampler=sampler)
    n = n_blocks * PATHS_PER_BLOCK_G
    out = _combine_greeks(sums, n, spot=float(spot), rate=float(rate), vol=float(vol), t=t,
                          a_drift=float(rate) - float(dividend) - 0.5 * float(vol) ** 2,
                          df=math.exp(-float(rate) * t), kind=kind, n_steps=n_steps)
    out["paths"] = n
    return out


# ---------------------------------------------------------------------------
# The user-facing ladder dispatch (CLI / HTTP vocabulary)
# ---------------------------------------------------------------------------
def exotic_kernel_ladder(kind: str, spot, strike=0.0, maturity=1.0, rate=0.05, vol=0.2,
                         cp: float = 1.0, dividend: float = 0.0, barrier: float = 0.0,
                         barrier_type: str = "up-and-out", averaging: str = "arithmetic",
                         floating: bool = True, n_paths: int = 1_000_000, n_steps: int = 64,
                         seed: int = 0, sampler: str | None = None, lower: float = 0.0,
                         upper: float = 0.0, pay: str = "expiry", device="cuda") -> dict:
    """Fused-kernel Greek ladders by façade kind: pathwise for asian/lookback,
    likelihood-ratio for barrier/touch/double/cliquet/autocallable. Returns
    Python floats plus ``kind``, ``greek_method``, ``paths`` and the
    ``n_steps`` used (cliquet/autocall round up to whole periods).
    ``sampler=None`` means ``"prng"`` (Philox) on every device."""
    sampler = "prng" if sampler is None else sampler
    kw = dict(n_paths=n_paths, n_steps=n_steps, seed=seed, sampler=sampler, device=device)
    method = "likelihood-ratio"
    if kind == "asian":
        k = "asian_arith" if averaging.startswith("arith") else "asian_geo"
        out = exotic_greeks(k, spot, strike, maturity, rate, vol, cp, dividend, **kw)
        method = "pathwise"
    elif kind == "lookback":
        k = "lookback_float" if floating else "lookback_fixed"
        out = exotic_greeks(k, spot, strike, maturity, rate, vol, cp, dividend, **kw)
        method = "pathwise"
    elif kind == "barrier":
        out = exotic_lr_greeks(f"barrier_{barrier_type}", spot, strike, maturity, rate, vol,
                               cp, dividend, barrier=barrier, **kw)
    elif kind in ("double-barrier", "double_barrier"):
        knock = "in" if barrier_type.endswith("in") else "out"
        out = exotic_lr_greeks(f"barrier_double-{knock}", spot, strike, maturity, rate, vol,
                               cp, dividend, lower=lower, upper=upper, **kw)
    elif kind in ("double-touch", "double_touch"):
        touch = "one" if barrier_type.startswith("one") else "no"
        if pay == "hit":
            if touch != "one":
                raise ValidationError("a no-touch pays at expiry by definition")
            k = "one_touch_double_hit"
        else:
            k = f"{touch}_touch_double"
        out = exotic_lr_greeks(k, spot, strike, maturity, rate, vol, cp, dividend,
                               lower=lower, upper=upper, **kw)
    elif kind in ("one-touch", "no-touch", "one_touch", "no_touch"):
        one = kind.replace("_", "-").startswith("one")
        if pay == "hit" and not one:
            raise ValidationError("a no-touch pays at expiry by definition")
        side = "up" if barrier >= spot else "down"
        k = f"{'one' if one else 'no'}_touch_{side}" + ("_hit" if pay == "hit" else "")
        out = exotic_lr_greeks(k, spot, strike, maturity, rate, vol, cp, dividend,
                               barrier=barrier, **kw)
    elif kind == "cliquet":
        if kw["n_steps"] % 12:  # 12 monthly resets
            kw["n_steps"] = max(12, -(-kw["n_steps"] // 12) * 12)
        out = cliquet_lr_greeks(spot, maturity, rate, vol, dividend, **kw)
    elif kind in ("autocallable", "autocall"):
        if kw["n_steps"] % 4:  # the default 4 observations
            kw["n_steps"] = max(4, -(-kw["n_steps"] // 4) * 4)
        out = autocall_lr_greeks(spot, maturity, rate, vol, dividend, **kw)
    else:
        raise ValidationError(
            f"kernel Greek ladder not available for kind {kind!r}; choose asian|lookback|"
            "barrier|one-touch|no-touch|double-barrier|double-touch|cliquet|autocallable")
    res = {k2: float(v) for k2, v in out.items() if k2 != "paths"}
    res.update(kind=kind, greek_method=method, paths=int(out["paths"]), n_steps=kw["n_steps"])
    if kind in ("cliquet", "autocallable", "autocall"):
        res["delta_convention"] = ("frozen-fixings hedge delta: initial fixing and barriers "
                                   "fixed at inception; a re-striking spot bump would show ~0")
    return res
