"""Heston European Monte Carlo: price, pathwise and CRN Greek ladders, and
whole-chain pricing with the calibration gradient, each in one kernel pass.

The port of the European part of ``optionslab_tpu/ops/heston_pallas.py``.
Three CUDA sources, four kernels:

* ``csrc/heston_mc.cu`` (the port of ``_heston_kernel``): full-truncation
  Euler; per-row sums of pay, pay², Σ1{ex}·S_T and, in ``vega`` mode,
  Σ1{ex}·S_T·∂x_T/∂v0, in ``ladder`` mode the same for v0, κ, θ, σ, ρ and T
  (forward sensitivities carried through the recursion). Samplers ``prng``,
  ``hash`` and ``sobol_bb`` (bridge QMC over both Brownian streams);
* ``csrc/heston_qe.cu``: ``_heston_qe_kernel`` (Andersen QE price) and
  ``_heston_qe_ladder_kernel`` (the base QE path system plus six bumped
  systems on common draws, one warp per system on shared draws, on the
  launch plan of the source's ``heston_qe_ladder_plan``);
* ``csrc/heston_chain.cu`` (the port of ``_heston_chain_kernel``): a whole
  option chain on one variable-dt grid, per quote pay, pay² and the five
  pathwise-gradient moments, folded in at the quote's expiry step.

Geometry. ``ROWS``, ``LANES`` and ``LADDER_LANES`` keep the reference's
meaning: a path block is ``ROWS × lanes`` lanes of one antithetic pair each,
and on the card they are the counter space of the ``hash`` and ``sobol_bb``
samplers, so the path set is the reference's own. ``prng`` is Philox keyed
by ``(seed, salt ^ block)``: normals on stream 0 at ``(row, col, step, 0)``,
the QE uniform on stream 1.

Dispatch. CUDA tensors go through the ``_*_cuda`` wrappers (each counts its
launches in ``.launches`` and raises if it cannot build or launch), CPU
tensors through the plain torch versions (``_*_plain``), which compute the
same sums from the same counters with the same float32 operations in the
same order. The public functions take a ``device`` (default ``"cuda"``).

Names. ``pallas_heston_price`` → :func:`heston_kernel_price`,
``pallas_heston_greeks`` → :func:`heston_kernel_greeks` (``heston_price`` is
the Lewis pricer of ``models/heston.py``), ``pallas_heston_chain_ladder`` →
:func:`heston_chain_ladder`; :func:`make_chain_pricer` keeps its name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .exotic_kernel import (
    _LAUNCH_LOCK,
    _block_ids,
    _bridge_plan_arrays,
    _check_tensor,
    _chunking,
    _f32,
    _launch_checked,
    _n_blocks,
    _qmc_scrambles,
)
from .kernel_rng import (
    HASH_SALT,
    box_muller,
    bridge_plan,
    draw_normals,
    draw_uniform,
    sobol_nd,
    sqrt_rn,
)

ROWS = 128
LANES = 512
PATHS_PER_BLOCK = 2 * ROWS * LANES  # one antithetic pair per lane
LADDER_LANES = 256  # the ladder kernels' narrower counter space
LADDER_PATHS_PER_BLOCK = 2 * ROWS * LADDER_LANES

SAMPLERS = ("prng", "hash", "sobol_bb")
MODES = ("price", "vega", "ladder")
_N_MOM = {"price": 3, "vega": 4, "ladder": 9}
N_PARAMS = 12  # Euler: S0, K, mu_dt, dt, sqrt_dt, kappa, theta, sigma_v, rho, srho, v0, T
QE_SETS = 7  # QE ladder: base + bumps of (v0, kappa, theta, sigma, rho, T)
N_CHAIN_HEAD = 9  # chain: S0, mu, kappa, theta, sigma_v, rho, srho, v0, crho
_BRIDGE_LEVELS = 4  # ≤ 4 bridge coordinates per stream: 2·4 Sobol dimensions

# lanes (blocks × rows × lanes) per step of the plain versions' block loop
_PLAIN_CHUNK_ELEMS = 1 << 21


def _lanes(mode: str) -> int:
    return LADDER_LANES if mode == "ladder" else LANES


def _check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValidationError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")


def _check_launch(sampler: str, n_steps: int, *, qe: bool = False, sens: bool = False) -> None:
    """The reference launcher's ``ValidationError`` cases (``_launch``)."""
    _check_sampler(sampler)
    if n_steps < 1:
        raise ValidationError(f"n_steps must be positive, got {n_steps}")
    if sampler.startswith("sobol"):
        if qe:
            raise ValidationError("bridge QMC rides the Euler scheme only (the QE variance "
                                  "transition consumes a uniform the bridge does not pin)")
        if sens:
            raise ValidationError("bridge QMC is price/delta/rho only — use prng/hash for the "
                                  "sensitivity ladder")
        if n_steps < 2:
            raise ValidationError("bridge QMC needs n_steps >= 2 (terminal + midpoint "
                                  "coordinates)")


def _sum_blocks(block_fn, n_blocks: int, block0: int, lanes: int, n_out, dev) -> torch.Tensor:
    """Σ over path blocks of ``block_fn(block ids)``'s per-lane terms (each
    (nb, ROWS, lanes) float32, or a list of lists), per row, in float64 and in
    bounded steps of blocks; returned as float32 of shape ``n_out + (ROWS,)``."""
    sums = torch.zeros(tuple(n_out) + (ROWS,), dtype=torch.float64, device=dev)
    flat = sums.view(-1, ROWS)
    step = max(1, _PLAIN_CHUNK_ELEMS // (ROWS * lanes))
    for b in range(0, n_blocks, step):
        terms = block_fn(_block_ids(block0, b, min(n_blocks, b + step), dev))
        for m, term in enumerate(terms):
            flat[m] += term.sum(dim=(0, 2), dtype=torch.float64)
    return sums.to(torch.float32)


# ---------------------------------------------------------------------------
# Kernel 4: full-truncation Euler (plain version)
# ---------------------------------------------------------------------------
def _bridge_offsets(seed, block, n_steps, lanes, zero, salt: int = HASH_SALT):
    """[(a, b, (ovp, oop, ovm, oom))] per bridge segment of ``sobol_bb``.

    One scrambled Sobol point per lane (8 replicate groups, row & 7) pins up
    to 4 dyadic z-sum coordinates of the variance stream z_v and 4 of the
    orthogonal spot stream z_o (dimension pairs: z_v level k, z_o level k);
    the hash residuals of each segment are shifted by constant offsets so
    that each antithetic branch hits the shared bridge targets. ``salt``
    seeds the scrambles' hash chain (the exotic kernel has its own)."""
    dev = block.device
    bounds, constructs = bridge_plan(n_steps, _BRIDGE_LEVELS)
    n_lvl = 1 + len(constructs)
    rid = torch.arange(ROWS, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    cid = torch.arange(lanes, dtype=torch.int32, device=dev).reshape(1, 1, -1)
    idx = block * ((ROWS // 8) * lanes) + (rid >> 3) * lanes + cid + 1
    us = sobol_nd(idx, _qmc_scrambles(seed, dev, salt), 2 * n_lvl)
    gv, go = [], []
    for k in range(n_lvl):
        c, s = box_muller(us[2 * k], us[2 * k + 1])
        gv.append(c)
        go.append(s)
    csums = []
    for g in (gv, go):
        csum = {0: zero, n_steps: math.sqrt(float(n_steps)) * g[0]}
        for (m, a, b), gd in zip(constructs, g[1:]):
            frac = (m - a) / (b - a)
            sd = math.sqrt((m - a) * (b - m) / (b - a))
            csum[m] = csum[a] + (csum[b] - csum[a]) * frac + sd * gd
        csums.append(csum)
    out = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        sv, so = zero, zero
        for i in range(a, b):
            z1, z2 = draw_normals("hash", seed, block, i, n_steps, ROWS, lanes)
            sv = sv + z1
            so = so + z2
        tv = csums[0][b] - csums[0][a]
        to = csums[1][b] - csums[1][a]
        inv = 1.0 / (b - a)
        out.append((a, b, ((tv - sv) * inv, (to - so) * inv, (tv + sv) * inv,
                           (to + so) * inv)))
    return out


def _euler_step(x, v, sens, c, sv, so, sx):
    """One full-truncation Euler step of one branch (shocks ``sv``, ``so``
    and the spot shock ``sx``) and the forward sensitivities it carries,
    shared by the Euler and chain kernels' plain versions (``csrc/
    heston_euler.cuh`` on the card).

    ``c``: (drift, dt, √dt, κ, θ, σ_v, ρ/√(1−ρ²), 1/T) of the step.
    ``sens`` holds (∂x, ∂v) per parameter: none (price); v0 (2 slots);
    v0, κ, θ, σ and ∂x for ρ (9 slots, the chain); the same plus (∂x, ∂v)
    for T with dt = T/n (11 slots, the ladder). Each is the exact pathwise
    derivative of the recursion: d√v⁺ = 1{v>0}·dv/(2√v⁺); κ, θ and σ enter
    dv explicitly; ρ only the spot shock; T every dt and √dt."""
    drift, dt, sqrt_dt, kappa, theta, sigma_v, crho, inv_t = c
    ind = (v > 0.0).to(torch.float32)  # full truncation: v⁺ = max(v, 0)
    vp = v * ind
    sq = sqrt_rn(vp)
    x_new = x + drift - 0.5 * vp * dt + sq * sqrt_dt * sx
    v_new = v + kappa * (theta - vp) * dt + sigma_v * sq * sqrt_dt * sv
    if not sens:
        return x_new, v_new, sens
    inv2sq = ind / (2.0 * torch.clamp_min(sq, 1e-6))  # guarded at the origin

    def prop(dx, dv, ex_dv=None):
        dsq = inv2sq * dv
        dx_n = dx - 0.5 * ind * dv * dt + dsq * sqrt_dt * sx
        dv_n = dv - kappa * ind * dv * dt + sigma_v * dsq * sqrt_dt * sv
        if ex_dv is not None:
            dv_n = dv_n + ex_dv
        return dx_n, dv_n

    out = list(prop(sens[0], sens[1]))
    if len(sens) == 2:
        return x_new, v_new, out
    out += prop(sens[2], sens[3], ex_dv=(theta - vp) * dt)  # kappa
    out += prop(sens[4], sens[5], ex_dv=kappa * dt)  # theta
    out += prop(sens[6], sens[7], ex_dv=sq * sqrt_dt * sv)  # sigma
    out.append(sens[8] + sq * sqrt_dt * (sv - crho * so))  # rho: the spot shock only
    if len(sens) == 11:  # T: every dt and √dt rescales (fixed step count)
        dxm, dvm = sens[9], sens[10]
        dsqm = inv2sq * dvm * sqrt_dt + sq * sqrt_dt * (0.5 * inv_t)
        out.append(dxm + drift * inv_t - 0.5 * (ind * dvm * dt + vp * dt * inv_t) + dsqm * sx)
        out.append(dvm + kappa * (theta - vp) * dt * inv_t - kappa * ind * dvm * dt
                   + sigma_v * dsqm * sv)
    return x_new, v_new, out


def _euler_block_plain(seed, block, p, *, n_steps, cp, sampler, mode):
    """Per-lane moment terms (each (nb, ROWS, lanes) float32, the lane's two
    antithetic branches summed) of path blocks ``block``: a line-by-line twin
    of the reference's ``_heston_kernel`` body."""
    lanes = _lanes(mode)
    shape = (block.shape[0], ROWS, lanes)
    s0, strike, mu_dt, dt, sqrt_dt, kappa, theta, sigma_v, rho, srho, v0, t_mat = (
        p[i] for i in range(N_PARAMS))
    coeffs = (mu_dt, dt, sqrt_dt, kappa, theta, sigma_v, rho / torch.clamp_min(srho, 1e-4),
              1.0 / t_mat)
    zero = torch.zeros(shape, dtype=torch.float32, device=p.device)
    one = zero + 1.0

    sens0 = {"price": [], "vega": [zero, one], "ladder": [zero, one] + [zero] * 9}[mode]
    xa, va, xb, vb = zero, v0.expand(shape), zero, v0.expand(shape)
    sa, sb = list(sens0), list(sens0)

    def body(i, offs):
        nonlocal xa, va, xb, vb, sa, sb
        residual = "hash" if sampler == "sobol_bb" else sampler
        zv, zo = draw_normals(residual, seed, block, i, n_steps, ROWS, lanes)
        if offs is None:
            zva, zoa, zvb, zob = zv, zo, -zv, -zo
        else:
            ovp, oop, ovm, oom = offs
            zva, zoa = zv + ovp, zo + oop
            zvb, zob = -zv + ovm, -zo + oom
        zxa = rho * zva + srho * zoa
        zxb = rho * zvb + srho * zob
        xa, va, sa = _euler_step(xa, va, sa, coeffs, zva, zoa, zxa)
        xb, vb, sb = _euler_step(xb, vb, sb, coeffs, zvb, zob, zxb)

    if sampler == "sobol_bb":
        for a, b, offs in _bridge_offsets(seed, block, n_steps, lanes, zero):
            for i in range(a, b):
                body(i, offs)
    else:
        for i in range(n_steps):
            body(i, None)

    # the dx slots of the moments beyond pay/pay²/m1
    slots = {"price": (), "vega": (0,), "ladder": (0, 2, 4, 6, 8, 9)}[mode]
    moms = [zero] * _N_MOM[mode]
    for x, sens in ((xa, sa), (xb, sb)):
        st = s0 * torch.exp(x)
        d = cp * (st - strike)
        pay = torch.clamp_min(d, 0.0)
        ind_st = torch.where(d > 0, st, zero)
        terms = [pay, pay * pay, ind_st] + [ind_st * sens[j] for j in slots]
        moms = [m + t for m, t in zip(moms, terms)]
    return moms


def _heston_mc_plain(seed: int, block0: int, params: torch.Tensor, *, n_steps: int,
                     n_blocks: int, cp: float, sampler: str = "prng",
                     mode: str = "price") -> torch.Tensor:
    """Plain torch version of the Euler kernel: per-row sums ``(n_mom,
    ROWS)`` float32 of ``n_blocks`` path blocks from ``block0``. Runs on any
    device."""
    _check_euler(sampler, n_steps, mode)
    return _sum_blocks(lambda blk: _euler_block_plain(seed, blk, params, n_steps=n_steps,
                                                      cp=float(cp), sampler=sampler, mode=mode),
                       n_blocks, block0, _lanes(mode), (_N_MOM[mode],), params.device)


def _check_euler(sampler: str, n_steps: int, mode: str) -> None:
    if mode not in MODES:
        raise ValidationError(f"mode must be one of {MODES}, got {mode!r}")
    _check_launch(sampler, n_steps, sens=mode != "price")


# ---------------------------------------------------------------------------
# Kernels 5 and 6: Andersen QE, price and CRN ladder (plain version)
# ---------------------------------------------------------------------------
def _qe_advance(x, v, c, zv, zx, u):
    """One QE step of one path system: the reference's branch-free form."""
    mu_dt, emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4 = c[:10]
    m = c1 + emkd * v
    s2 = s2_v * v + s2_0
    psi = s2 / torch.clamp_min(m * m, 1e-30)
    inv_psi = 2.0 / torch.clamp_min(psi, 1e-10)
    b2 = torch.clamp_min(inv_psi - 1.0 + sqrt_rn(torch.clamp_min(inv_psi * (inv_psi - 1.0), 0.0)),
                         0.0)
    a = m / (1.0 + b2)
    root = sqrt_rn(b2) + zv
    v_quad = a * (root * root)
    p_mass = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-7)
    beta = (1.0 - p_mass) / torch.clamp_min(m, 1e-30)
    v_exp = torch.where(u <= p_mass, torch.zeros_like(v),
                        torch.log((1.0 - p_mass) / torch.clamp_min(1.0 - u, 1e-30))
                        / torch.clamp_min(beta, 1e-30))
    v_new = torch.where(psi <= 1.5, v_quad, v_exp)
    x_new = x + mu_dt + k0 + k1 * v + k2 * v_new \
        + sqrt_rn(torch.clamp_min(k3 * v + k4 * v_new, 0.0)) * zx
    return x_new, v_new


def _qe_block_plain(seed, block, p, *, n_steps, cp, sampler, n_sets):
    """Per-lane terms of the QE kernels: pay, pay², m1 of the base system
    and, for ``n_sets`` = 7, Σpay of each bumped system."""
    lanes = LANES if n_sets == 1 else LADDER_LANES
    shape = (block.shape[0], ROWS, lanes)
    s0, strike = p[0], p[1]
    consts = [[p[2 + s * 11 + j] for j in range(11)] for s in range(n_sets)]
    zero = torch.zeros(shape, dtype=torch.float32, device=p.device)
    carry = []
    for c in consts:
        v0 = c[10].expand(shape)
        carry.append([zero, v0, zero, v0])
    for i in range(n_steps):
        zv, zx = draw_normals(sampler, seed, block, i, n_steps, ROWS, lanes)
        u = draw_uniform(sampler, seed, block, i, n_steps, ROWS, lanes)
        for s, c in enumerate(consts):
            xa, va, xb, vb = carry[s]
            xa, va = _qe_advance(xa, va, c, zv, zx, u)
            xb, vb = _qe_advance(xb, vb, c, -zv, -zx, 1.0 - u)
            carry[s] = [xa, va, xb, vb]
    moms = [zero] * (3 + n_sets - 1)
    for s in range(n_sets):
        for x in (carry[s][0], carry[s][2]):
            st = s0 * torch.exp(x)
            d = cp * (st - strike)
            pay = torch.clamp_min(d, 0.0)
            if s == 0:
                moms[0] = moms[0] + pay
                moms[1] = moms[1] + pay * pay
                moms[2] = moms[2] + torch.where(d > 0, st, zero)
            else:
                moms[2 + s] = moms[2 + s] + pay
    return moms


def _qe_plain(seed, block0, params, *, n_steps, n_blocks, cp, sampler, n_sets):
    _check_launch(sampler, n_steps, qe=True)
    lanes = LANES if n_sets == 1 else LADDER_LANES
    return _sum_blocks(lambda blk: _qe_block_plain(seed, blk, params, n_steps=n_steps,
                                                   cp=float(cp), sampler=sampler,
                                                   n_sets=n_sets),
                       n_blocks, block0, lanes, (2 + n_sets,), params.device)


def _heston_qe_plain(seed: int, block0: int, params: torch.Tensor, *, n_steps: int,
                     n_blocks: int, cp: float, sampler: str = "prng") -> torch.Tensor:
    """Plain torch version of the QE price kernel: per-row sums ``(3, ROWS)``
    of pay, pay² and Σ1{ex}·S_T. ``params``: [S0, K] + 11 QE constants."""
    return _qe_plain(seed, block0, params, n_steps=n_steps, n_blocks=n_blocks, cp=cp,
                     sampler=sampler, n_sets=1)


def _heston_qe_ladder_plain(seed: int, block0: int, params: torch.Tensor, *, n_steps: int,
                            n_blocks: int, cp: float, sampler: str = "prng") -> torch.Tensor:
    """Plain torch version of the QE ladder kernel: per-row sums ``(9, ROWS)``
    (pay, pay², m1 of the base system, Σpay of the six bumped systems).
    ``params``: [S0, K] + 7 × 11 QE constants."""
    return _qe_plain(seed, block0, params, n_steps=n_steps, n_blocks=n_blocks, cp=cp,
                     sampler=sampler, n_sets=QE_SETS)


# ---------------------------------------------------------------------------
# Kernel 7: the whole chain (plain version)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A chain's time grid and quotes, on one device.

    Quote q expires at the end of step ``quote_steps[q]``; ``exp_ptr`` and
    ``exp_quote`` list, per step, the quotes that expire at its end (CSR)."""

    quote_steps: tuple
    cps: tuple
    maturities: tuple
    dts: torch.Tensor  # (n_steps,) float32
    sqrt_dts: torch.Tensor  # (n_steps,) float32, correctly rounded roots of dts
    strikes: torch.Tensor  # (Q,) float32
    cps_t: torch.Tensor  # (Q,) float32
    exp_ptr: torch.Tensor  # (n_steps + 1,) int32
    exp_quote: torch.Tensor  # (Q,) int32

    @property
    def n_steps(self) -> int:
        return int(self.dts.shape[0])

    @property
    def n_quotes(self) -> int:
        return len(self.quote_steps)


def _chain_grid(maturities, max_dt: float):
    """Variable step grid whose boundaries hit every expiry exactly.
    Returns (dts float64 ndarray, quote_steps: the END-of-step index per quote)."""
    mats = np.asarray(maturities, np.float64).ravel()
    uniq = np.unique(np.maximum(mats, EPS_TIME))
    dts, q_step_of_expiry = [], {}
    t_prev = 0.0
    for te in uniq:
        n_sub = max(1, int(math.ceil((te - t_prev) / max_dt - 1e-9)))
        dts += [(te - t_prev) / n_sub] * n_sub
        q_step_of_expiry[float(te)] = len(dts) - 1
        t_prev = te
    steps = tuple(q_step_of_expiry[float(max(t, EPS_TIME))] for t in mats)
    return np.asarray(dts, np.float64), steps


def chain_plan(strikes, maturities, cps, max_dt: float, device) -> ChainPlan:
    """The :class:`ChainPlan` of a chain (``cps`` ±1 per quote)."""
    strikes = np.asarray(strikes, np.float64).ravel()
    mats = np.asarray(maturities, np.float64).ravel()
    cps_arr = np.asarray(cps, np.float64).ravel()
    if not (strikes.size == mats.size == cps_arr.size) or strikes.size == 0:
        raise ValidationError("strikes/maturities/cps must have equal, nonzero length")
    dts, quote_steps = _chain_grid(mats, max_dt)
    dev = torch.device(device)
    dts_t = torch.tensor(dts.astype(np.float32), device=dev)
    order = np.argsort(np.asarray(quote_steps), kind="stable")
    ptr = np.searchsorted(np.asarray(quote_steps)[order], np.arange(len(dts) + 1))
    return ChainPlan(quote_steps=quote_steps, cps=tuple(float(c) for c in cps_arr),
                     maturities=tuple(float(t) for t in mats), dts=dts_t, sqrt_dts=sqrt_rn(dts_t),
                     strikes=torch.tensor(strikes.astype(np.float32), device=dev),
                     cps_t=torch.tensor(cps_arr.astype(np.float32), device=dev),
                     exp_ptr=torch.tensor(ptr.astype(np.int32), device=dev),
                     exp_quote=torch.tensor(order.astype(np.int32), device=dev))


def _chain_block_plain(seed, block, head, plan: ChainPlan, *, sampler):
    """Per-lane terms ``[q·7 + m]`` (pay, pay², Σ1{ex}·S·∂x/∂p for p = v0, κ,
    θ, σ, ρ) of path blocks ``block``: the twin of ``_heston_chain_kernel``."""
    shape = (block.shape[0], ROWS, LANES)
    s0, mu, kappa, theta, sigma_v, rho, srho, v0, crho = (head[i] for i in range(N_CHAIN_HEAD))
    zero = torch.zeros(shape, dtype=torch.float32, device=head.device)
    one = zero + 1.0
    n_steps = plan.n_steps

    expiring = {}
    for q, i in enumerate(plan.quote_steps):
        expiring.setdefault(i, []).append(q)
    sens0 = [zero, one] + [zero] * 7
    xa, va, xb, vb = zero, v0.expand(shape), zero, v0.expand(shape)
    sa, sb = list(sens0), list(sens0)
    terms = [None] * (7 * plan.n_quotes)
    for i in range(n_steps):
        dt = plan.dts[i]
        coeffs = (mu * dt, dt, plan.sqrt_dts[i], kappa, theta, sigma_v, crho, None)
        zv, zo = draw_normals(sampler, seed, block, i, n_steps, ROWS, LANES)
        zx = rho * zv + srho * zo
        xa, va, sa = _euler_step(xa, va, sa, coeffs, zv, zo, zx)
        xb, vb, sb = _euler_step(xb, vb, sb, coeffs, -zv, -zo, -zx)
        for q in expiring.get(i, ()):
            strike, cpq = plan.strikes[q], plan.cps[q]
            accs = [zero] * 7
            for x, sens in ((xa, sa), (xb, sb)):
                st = s0 * torch.exp(x)
                dd = cpq * (st - strike)
                pay = torch.clamp_min(dd, 0.0)
                ind_st = torch.where(dd > 0, st, zero)
                accs[0] = accs[0] + pay
                accs[1] = accs[1] + pay * pay
                for k, sl in enumerate((0, 2, 4, 6, 8)):
                    accs[2 + k] = accs[2 + k] + ind_st * sens[sl]
            terms[7 * q:7 * q + 7] = accs
    return terms


def _check_chain(head: torch.Tensor, plan: ChainPlan, sampler: str) -> None:
    if sampler not in ("prng", "hash"):
        raise ValidationError("the chain kernel supports prng/hash only")
    if head.shape != (N_CHAIN_HEAD,) or head.device != plan.dts.device:
        raise ValueError(f"head must be ({N_CHAIN_HEAD},) on {plan.dts.device}, got "
                         f"{tuple(head.shape)} on {head.device}")


def _heston_chain_plain(seed: int, block0: int, head: torch.Tensor, plan: ChainPlan, *,
                        n_blocks: int, sampler: str = "prng") -> torch.Tensor:
    """Plain torch version of the chain kernel: per-row sums ``(Q, 7, ROWS)``
    float32. ``head``: the 9 scalars (S0, mu, κ, θ, σ, ρ, √(1−ρ²), v0,
    ρ/√(1−ρ²))."""
    _check_chain(head, plan, sampler)
    return _sum_blocks(lambda blk: _chain_block_plain(seed, blk, head, plan, sampler=sampler),
                       n_blocks, block0, LANES, (plan.n_quotes, 7), head.device)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------
_SAMPLER_ID = {"prng": 0, "hash": 1, "sobol_bb": 2}
_MODE_ID = {m: i for i, m in enumerate(MODES)}


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _count(fn) -> None:
    with _LAUNCH_LOCK:
        fn.launches += 1


def _require_cuda(name: str, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")


def _heston_mc_cuda(seed: int, block0: int, params: torch.Tensor, *, n_steps: int,
                    n_blocks: int, cp: float, sampler: str = "prng",
                    mode: str = "price") -> torch.Tensor:
    """The Euler kernel: per-row sums ``(n_mom, ROWS)`` float32 on the card.
    Launches on PyTorch's current stream and does not synchronize.
    ``_heston_mc_cuda.launches`` counts its launches."""
    _check_euler(sampler, n_steps, mode)
    dev = params.device
    _require_cuda("_heston_mc_cuda", dev)
    _check_tensor("params", params, dev, (N_PARAMS,))
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    n_chunks, per_chunk = _chunking(n_blocks)
    plan_i, plan_f = (_bridge_plan_arrays(n_steps, _BRIDGE_LEVELS) if sampler == "sobol_bb"
                      else (np.zeros(32, np.int32), np.zeros(23, np.float32)))
    lib = _build.load_library()
    n_mom = _N_MOM[mode]
    partials = torch.empty((n_mom, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, ROWS), dtype=torch.float32, device=dev)
    err = lib.heston_mc_moments(
        params.data_ptr(), int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF, n_blocks,
        per_chunk, n_chunks, n_steps, float(cp), _MODE_ID[mode], _SAMPLER_ID[sampler],
        plan_i.ctypes.data, plan_f.ctypes.data, partials.data_ptr(), out.data_ptr(),
        dev.index, _stream(dev))
    _launch_checked("heston_mc_moments", err)
    _count(_heston_mc_cuda)
    return out


_heston_mc_cuda.launches = 0


def _qe_cuda(fn, seed, block0, params, *, n_steps, n_blocks, cp, sampler, n_sets):
    _check_launch(sampler, n_steps, qe=True)
    dev = params.device
    _require_cuda(fn.__name__, dev)
    _check_tensor("params", params, dev, (2 + 11 * n_sets,))
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    lib = _build.load_library()
    if n_sets == 1:
        n_chunks, per_chunk = _chunking(n_blocks)
    else:  # the ladder's work units are the kernel's own: its source plans them
        c_chunks, c_per = ctypes.c_int(), ctypes.c_int()
        _launch_checked("heston_qe_ladder_plan", lib.heston_qe_ladder_plan(
            n_blocks, ctypes.byref(c_chunks), ctypes.byref(c_per)))
        n_chunks, per_chunk = c_chunks.value, c_per.value
    n_mom = 2 + n_sets
    partials = torch.empty((n_mom, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, ROWS), dtype=torch.float32, device=dev)
    err = lib.heston_qe_moments(
        params.data_ptr(), int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF, n_blocks,
        per_chunk, n_chunks, n_steps, float(cp), n_sets, _SAMPLER_ID[sampler],
        partials.data_ptr(), out.data_ptr(), dev.index, _stream(dev))
    _launch_checked("heston_qe_moments", err)
    _count(fn)
    return out


def _heston_qe_cuda(seed: int, block0: int, params: torch.Tensor, *, n_steps: int,
                    n_blocks: int, cp: float, sampler: str = "prng") -> torch.Tensor:
    """The QE price kernel: per-row sums ``(3, ROWS)`` on the card.
    ``_heston_qe_cuda.launches`` counts its launches."""
    return _qe_cuda(_heston_qe_cuda, seed, block0, params, n_steps=n_steps, n_blocks=n_blocks,
                    cp=cp, sampler=sampler, n_sets=1)


def _heston_qe_ladder_cuda(seed: int, block0: int, params: torch.Tensor, *, n_steps: int,
                           n_blocks: int, cp: float, sampler: str = "prng") -> torch.Tensor:
    """The QE ladder kernel: per-row sums ``(9, ROWS)`` on the card.
    ``_heston_qe_ladder_cuda.launches`` counts its launches."""
    return _qe_cuda(_heston_qe_ladder_cuda, seed, block0, params, n_steps=n_steps,
                    n_blocks=n_blocks, cp=cp, sampler=sampler, n_sets=QE_SETS)


_heston_qe_cuda.launches = 0
_heston_qe_ladder_cuda.launches = 0


def _heston_chain_cuda(seed: int, block0: int, head: torch.Tensor, plan: ChainPlan, *,
                       n_blocks: int, sampler: str = "prng") -> torch.Tensor:
    """The chain kernel: per-row sums ``(Q, 7, ROWS)`` float32 on the card.
    ``_heston_chain_cuda.launches`` counts its launches."""
    _check_chain(head, plan, sampler)
    dev = head.device
    _require_cuda("_heston_chain_cuda", dev)
    _check_tensor("head", head, dev, (N_CHAIN_HEAD,))
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    n_chunks, per_chunk = _chunking(n_blocks)
    lib = _build.load_library()
    q = plan.n_quotes
    partials = torch.empty((7 * q, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((q, 7, ROWS), dtype=torch.float32, device=dev)
    err = lib.heston_chain_moments(
        head.data_ptr(), plan.dts.data_ptr(), plan.sqrt_dts.data_ptr(),
        plan.strikes.data_ptr(), plan.cps_t.data_ptr(), plan.exp_ptr.data_ptr(),
        plan.exp_quote.data_ptr(), q, int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF,
        n_blocks, per_chunk, n_chunks, plan.n_steps, _SAMPLER_ID[sampler],
        partials.data_ptr(), out.data_ptr(), dev.index, _stream(dev))
    _launch_checked("heston_chain_moments", err)
    _count(_heston_chain_cuda)
    return out


_heston_chain_cuda.launches = 0


def _dispatch(cuda_fn, plain_fn, dev, *args, **kw) -> torch.Tensor:
    """A kernel for CUDA tensors, its plain version for CPU tensors."""
    if dev.type == "cuda":
        return cuda_fn(*args, **kw)
    if dev.type == "cpu":
        return plain_fn(*args, **kw)
    raise ValueError(f"no Heston kernel for device {dev}")


# ---------------------------------------------------------------------------
# Host side: parameter vectors, moments → price / stderr / Greeks
# ---------------------------------------------------------------------------
def _params_vec(spot, strike, maturity, rate, params, dividend, n_steps):
    """(t, float32[12]) of the Euler kernel."""
    t = max(float(maturity), EPS_TIME)
    dt = t / n_steps
    rho = float(params.rho)
    return t, np.asarray([
        float(spot), float(strike), (float(rate) - float(dividend)) * dt, dt, math.sqrt(dt),
        float(params.kappa), float(params.theta), float(params.sigma), rho,
        math.sqrt(max(1.0 - rho * rho, 0.0)), float(params.v0), t,
    ], np.float32)


def _qe_consts(kap, th, sig, rho, v0, dt, mu):
    """The 11 per-set QE constants (Andersen eq. 33, gamma1 = gamma2 = 1/2):
    [mu_dt, emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4, v0]."""
    emkd = math.exp(-kap * dt)
    c1 = th * (1.0 - emkd)
    s2_v = sig * sig * emkd * (1.0 - emkd) / kap
    s2_0 = th * sig * sig * (1.0 - emkd) ** 2 / (2.0 * kap)
    g1 = g2 = 0.5
    k0 = -rho * kap * th * dt / sig
    k1 = g1 * dt * (kap * rho / sig - 0.5) - rho / sig
    k2 = g2 * dt * (kap * rho / sig - 0.5) + rho / sig
    k3 = g1 * dt * (1.0 - rho * rho)
    k4 = g2 * dt * (1.0 - rho * rho)
    return [mu * dt, emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4, v0]


def _params_vec_qe(spot, strike, maturity, rate, params, dividend, n_steps):
    """(t, float32[13]) of the QE price kernel: [S0, K] + one constant set."""
    t = max(float(maturity), EPS_TIME)
    c = _qe_consts(float(params.kappa), float(params.theta), float(params.sigma),
                   float(params.rho), float(params.v0), t / n_steps,
                   float(rate) - float(dividend))
    return t, np.asarray([float(spot), float(strike)] + c, np.float32)


def _params_vec_qe_ladder(spot, strike, maturity, rate, params, dividend, n_steps,
                          h_rel: float = 1e-3):
    """Base + 6 CRN-bumped QE constant sets (v0, κ, θ, σ, ρ, T). Returns (t,
    float32[2 + 7·11], hs): ``hs`` are the absolute bumps the finite
    differences divide by; multiplicative bumps except ρ (additive, kept
    inside (−1, 1))."""
    t = max(float(maturity), EPS_TIME)
    mu = float(rate) - float(dividend)
    kap, th = float(params.kappa), float(params.theta)
    sig, rho, v0 = float(params.sigma), float(params.rho), float(params.v0)
    dt = t / n_steps
    h_v0 = h_rel * max(v0, 1e-2)
    h_kap = h_rel * max(kap, 0.1)
    h_th = h_rel * max(th, 1e-2)
    h_sig = h_rel * max(sig, 1e-2)
    rho_b = min(rho + h_rel, 0.999)
    h_rho = rho_b - rho
    h_t = h_rel * t
    sets = [
        (kap, th, sig, rho, v0, dt),
        (kap, th, sig, rho, v0 + h_v0, dt),
        (kap + h_kap, th, sig, rho, v0, dt),
        (kap, th + h_th, sig, rho, v0, dt),
        (kap, th, sig + h_sig, rho, v0, dt),
        (kap, th, sig, rho_b, v0, dt),
        (kap, th, sig, rho, v0, (t + h_t) / n_steps),
    ]
    p = [float(spot), float(strike)]
    for k_, t_, s_, r_, v_, d_ in sets:
        p += _qe_consts(k_, t_, s_, r_, v_, d_, mu)
    return t, np.asarray(p, np.float32), [h_v0, h_kap, h_th, h_sig, h_rho, h_t]


def _combine_moments(outs: torch.Tensor, n: int, *, spot, t, df, v0, cp, mode,
                     rate=0.0, sampler="prng") -> dict:
    """Per-row moment sums → price/stderr/delta/rho (+ v0-vega, or the full
    ladder), in float64. Under ``sobol_bb`` the stderr is the std of the 8
    replicate groups' means (row % 8) over √8."""
    outs = outs.double()
    pay, pay2, m1 = outs[0], outs[1], outs[2]
    mean = pay.sum() / n
    if sampler.startswith("sobol"):
        rep = pay.reshape(ROWS // 8, 8).sum(dim=0) * (8.0 / n)
        se = rep.std(correction=1) / math.sqrt(8.0)
    else:
        se = torch.sqrt(torch.clamp_min(pay2.sum() / n - mean * mean, 0.0) / n)
    mean1 = m1.sum() / n
    price = df * mean
    out = {
        "price": price,
        "std_error": df * se,
        "delta": df * cp * mean1 / spot,  # ∂S_T/∂S0 = S_T/S0
        "rho": t * (df * cp * mean1 - price),  # ∂x_T/∂r = T, plus the discount
    }
    if mode == "ladder":
        dv0, dkap, dth, dsig, drho, dt_m = [df * cp * outs[3 + k].sum() / n for k in range(6)]
        out.update(vega_v0=dv0, vega=2.0 * math.sqrt(v0) * dv0, d_kappa=dkap, d_theta=dth,
                   d_sigma=dsig, d_rho=drho, theta=rate * price - dt_m)
    elif mode == "vega":
        dv0 = df * cp * outs[3].sum() / n
        out.update(vega_v0=dv0, vega=2.0 * math.sqrt(v0) * dv0)
    return {k: _f32(v) for k, v in out.items()}


def _combine_qe_ladder(outs: torch.Tensor, n: int, *, spot, t, df, v0, rate, hs, cp) -> dict:
    """QE CRN-bump moment sums → the ladder dict (the Euler ladder's keys):
    forward differences of the bumped systems' payoff means."""
    outs = outs.double()
    mean = outs[0].sum() / n
    var = torch.clamp_min(outs[1].sum() / n - mean * mean, 0.0)
    mean1 = outs[2].sum() / n
    price = df * mean
    d = [(outs[3 + k].sum() / n - mean) / hs[k] for k in range(6)]
    out = {
        "price": price,
        "std_error": df * torch.sqrt(var / n),
        "delta": df * cp * mean1 / spot,
        "rho": t * (df * cp * mean1 - price),
        "vega_v0": df * d[0],
        "vega": 2.0 * math.sqrt(v0) * df * d[0],
        "d_kappa": df * d[1],
        "d_theta": df * d[2],
        "d_sigma": df * d[3],
        "d_rho": df * d[4],
        "theta": rate * price - df * d[5],  # −∂(df·mean)/∂T
    }
    return {k: _f32(v) for k, v in out.items()}


def heston_kernel_greeks(spot, strike, maturity, rate, params, cp: float = 1.0,
                         dividend: float = 0.0, n_paths: int = 1_000_000, n_steps: int = 100,
                         seed: int = 0, sampler: str = "prng", vega: bool = True,
                         ladder: bool = False, scheme: str = "euler", h_rel: float = 1e-3,
                         device="cuda") -> dict:
    """Heston price + stderr + pathwise delta/rho (+ v0-vega) in one kernel pass.

    ``params``: a :class:`~optionslab_tpu_torch.models.heston.HestonParams`
    (or anything with v0/kappa/theta/sigma/rho). ``vega=True`` carries
    (∂x/∂v0, ∂v/∂v0) through the Euler recursion and adds ``vega_v0``
    (∂price/∂v0) and ``vega`` (∂price/∂√v0). ``ladder=True`` returns the
    full ladder: ``d_kappa``, ``d_theta``, ``d_sigma``, ``d_rho`` and
    ``theta`` (−∂V/∂T), exact pathwise derivatives of the Euler scheme.
    ``scheme="qe"`` with ``ladder=True``: the same keys on the Andersen-QE
    scheme by common-random-number forward bumps of relative size
    ``h_rel``. Values are float32 tensors on ``device``; the dict carries
    ``paths``.
    """
    dev = torch.device(device)
    if scheme not in ("euler", "qe"):
        raise ValidationError(f"scheme must be euler|qe, got {scheme!r}")
    if scheme == "qe":
        if not ladder:
            raise ValidationError("scheme='qe' greeks require ladder=True (the CRN-bump "
                                  "kernel) — price/delta/rho alone ride heston_kernel_price")
        _check_launch(sampler, n_steps, qe=True)
        t, p, hs = _params_vec_qe_ladder(spot, strike, maturity, rate, params, dividend,
                                         n_steps, h_rel)
        n_blocks = _n_blocks(n_paths, LADDER_PATHS_PER_BLOCK)
        sums = _dispatch(_heston_qe_ladder_cuda, _heston_qe_ladder_plain, dev, seed, 0,
                         torch.tensor(p, device=dev), n_steps=n_steps, n_blocks=n_blocks,
                         cp=float(cp), sampler=sampler)
        n = n_blocks * LADDER_PATHS_PER_BLOCK
        out = _combine_qe_ladder(sums, n, spot=float(spot), t=t, df=math.exp(-float(rate) * t),
                                 v0=float(params.v0), rate=float(rate),
                                 hs=[float(np.float32(h)) for h in hs], cp=float(cp))
        out["paths"] = n
        return out
    mode = "ladder" if ladder else ("vega" if vega else "price")
    _check_euler(sampler, n_steps, mode)
    t, p = _params_vec(spot, strike, maturity, rate, params, dividend, n_steps)
    ppb = LADDER_PATHS_PER_BLOCK if ladder else PATHS_PER_BLOCK
    n_blocks = _n_blocks(n_paths, ppb)
    sums = _dispatch(_heston_mc_cuda, _heston_mc_plain, dev, seed, 0, torch.tensor(p, device=dev),
                     n_steps=n_steps, n_blocks=n_blocks, cp=float(cp), sampler=sampler, mode=mode)
    out = _combine_moments(sums, n_blocks * ppb, spot=float(spot), t=t,
                           df=math.exp(-float(rate) * t), v0=float(params.v0), cp=float(cp),
                           mode=mode, rate=float(rate), sampler=sampler)
    out["paths"] = n_blocks * ppb
    return out


def heston_kernel_price(spot, strike, maturity, rate, params, cp: float = 1.0,
                        dividend: float = 0.0, n_paths: int = 1_000_000, n_steps: int = 100,
                        seed: int = 0, sampler: str = "prng", scheme: str = "euler",
                        device="cuda"):
    """``(price, stderr, actual_paths)`` under Heston in one kernel launch.

    ``scheme``: ``euler`` (full truncation) or ``qe`` (Andersen
    quadratic-exponential, near-unbiased at coarse steps). ``sampler=
    "sobol_bb"`` (Euler, ``n_steps >= 2``): hybrid bridge QMC over both
    Brownian streams with the 8-replicate randomized-QMC stderr."""
    if scheme == "qe":
        dev = torch.device(device)
        _check_launch(sampler, n_steps, qe=True)
        t, p = _params_vec_qe(spot, strike, maturity, rate, params, dividend, n_steps)
        n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
        sums = _dispatch(_heston_qe_cuda, _heston_qe_plain, dev, seed, 0,
                         torch.tensor(p, device=dev), n_steps=n_steps, n_blocks=n_blocks,
                         cp=float(cp), sampler=sampler)
        out = _combine_moments(sums, n_blocks * PATHS_PER_BLOCK, spot=float(spot), t=t,
                               df=math.exp(-float(rate) * t), v0=float(params.v0),
                               cp=float(cp), mode="price")
        return out["price"], out["std_error"], n_blocks * PATHS_PER_BLOCK
    if scheme != "euler":
        raise ValidationError(f"scheme must be euler|qe, got {scheme!r}")
    out = heston_kernel_greeks(spot, strike, maturity, rate, params, cp, dividend, n_paths,
                               n_steps, seed, sampler, vega=False, device=device)
    return out["price"], out["std_error"], out["paths"]


# ---------------------------------------------------------------------------
# The chain: prices + the 5-parameter gradient, and the differentiable pricer
# ---------------------------------------------------------------------------
def _chain_head(pvec: torch.Tensor, spot, rate, dividend) -> torch.Tensor:
    """The chain kernel's 9 scalars from pvec = (v0, κ, θ, σ, ρ), float32."""
    pvec = pvec.detach().to(torch.float32)
    v0, kap, th, sig, rho = pvec.unbind()
    srho = sqrt_rn(torch.clamp_min(1.0 - rho * rho, 1e-8))
    crho = rho / torch.clamp_min(srho, 1e-4)
    f32 = np.float32
    mu = torch.tensor(f32(f32(rate) - f32(dividend)), device=pvec.device)
    s0 = torch.tensor(f32(spot), device=pvec.device)
    return torch.stack([s0, mu, kap, th, sig, rho, srho, v0, crho]).contiguous()


def _chain_reduce(sums: torch.Tensor, plan: ChainPlan, rate: float, n: int):
    """Per-quote (price, stderr, 5-parameter gradient) float32 from the chain
    kernel's (Q, 7, ROWS) row sums, in float64."""
    tot = sums.double().sum(dim=2) / n  # (Q, 7)
    mats = np.maximum(np.asarray(plan.maturities, np.float64), EPS_TIME)
    dfs = torch.tensor(np.exp(-float(rate) * mats), dtype=torch.float64, device=sums.device)
    pay, pay2 = tot[:, 0], tot[:, 1]
    var = torch.clamp_min(pay2 - pay * pay, 0.0)
    cps = plan.cps_t.double()
    prices = dfs * pay
    ses = dfs * torch.sqrt(var / n)
    grads = (dfs * cps)[:, None] * tot[:, 2:]
    return _f32(prices), _f32(ses), _f32(grads)


def _chain_run(plan: ChainPlan, pvec: torch.Tensor, *, spot, rate, dividend, n_blocks, seed,
               sampler):
    head = _chain_head(pvec, spot, rate, dividend)
    sums = _dispatch(_heston_chain_cuda, _heston_chain_plain, head.device, seed, 0, head, plan,
                     n_blocks=n_blocks, sampler=sampler)
    return _chain_reduce(sums, plan, float(rate), n_blocks * PATHS_PER_BLOCK)


def _pvec(params, device) -> torch.Tensor:
    return torch.tensor([float(params.v0), float(params.kappa), float(params.theta),
                         float(params.sigma), float(params.rho)], dtype=torch.float32,
                        device=device)


def heston_chain_ladder(strikes, maturities, cps, spot, rate, params, dividend: float = 0.0,
                        n_paths: int = 1_000_000, max_dt: float = 0.01, seed: int = 0,
                        sampler: str = "prng", device="cuda"):
    """Price a whole option chain under Heston and return every quote's
    gradient in (v0, κ, θ, σ, ρ), in one kernel launch.

    ``cps``: +1/−1 per quote. Returns ``(prices (Q,), stderrs (Q,), grads
    (Q, 5))``, float32 on ``device``. The time grid is variable-step so that
    every expiry lands on a step boundary (steps of at most ``max_dt``
    years). The differentiable form is :func:`make_chain_pricer`."""
    dev = torch.device(device)
    plan = chain_plan(strikes, maturities, cps, max_dt, dev)
    return _chain_run(plan, _pvec(params, dev), spot=spot, rate=rate, dividend=dividend,
                      n_blocks=_n_blocks(n_paths, PATHS_PER_BLOCK), seed=seed, sampler=sampler)


class _ChainPrices(torch.autograd.Function):
    """prices(pvec) whose vector-Jacobian product is the kernel's own
    gradient moments: no autograd through the simulation, and no second
    launch for the backward."""

    @staticmethod
    def forward(ctx, pvec, run):
        prices, _, grads = run(pvec)
        ctx.save_for_backward(grads)
        return prices

    @staticmethod
    def backward(ctx, ct):
        (grads,) = ctx.saved_tensors
        return grads.T @ ct.to(grads.dtype), None


def make_chain_pricer(strikes, maturities, cps, spot, rate, dividend: float = 0.0,
                      n_paths: int = 1_000_000, max_dt: float = 0.01, seed: int = 0,
                      sampler: str = "prng", device="cuda"):
    """A differentiable chain pricer ``pvec (5,) → prices (Q,)``: each call
    is one launch of the chain kernel, and its backward returns
    ``grads.T @ cotangent`` from the in-kernel pathwise moments. The fixed
    seed makes the loss surface deterministic (see
    ``models.heston.calibrate_heston_mc``)."""
    dev = torch.device(device)
    plan = chain_plan(strikes, maturities, cps, max_dt, dev)
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)

    def run(pvec):
        return _chain_run(plan, pvec, spot=spot, rate=rate, dividend=dividend,
                          n_blocks=n_blocks, seed=seed, sampler=sampler)

    def prices(pvec: torch.Tensor) -> torch.Tensor:
        return _ChainPrices.apply(pvec, run)

    return prices
