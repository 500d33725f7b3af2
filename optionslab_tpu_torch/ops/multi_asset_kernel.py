"""Correlated multi-asset Monte Carlo in one kernel pass: baskets, rainbows,
spreads and the basket Asian on d = 2–4 GBM assets, with a one-pass
likelihood-ratio Greek ladder per asset.

The port of ``optionslab_tpu/ops/multi_asset_pallas.py``. One CUDA source,
``csrc/multi_asset_mc.cu`` (the port of ``_ma_kernel``). Every lane of the
reference's (128, 256) counter space carries four antithetic systems of d
log-spots: per step each asset i draws one Box–Muller pair (z_cos, z_sin) at
draw index k·d + i, the Cholesky factor correlates each stream once
(shock_i = Σ_{j≤i} L_ij z_j), branches A/B take ±(cos stream), C/D ±(sin
stream), and x_i += drift_i·dt ± σ_i√dt·shock_i. The payoff (arithmetic or
geometric basket, best-/worst-of, S₁ − S₂, the running basket average, or
the arithmetic basket minus its geometric control variate) is taken after
the step loop. It returns per-row sums of pay, pay² and, with ``lr``, the
ladder's score moments (delta_i, vega_i, gamma_ij for i ≤ j, theta, rho).

Samplers: ``prng`` (Philox keyed by ``(seed, salt ^ block)`` at counter
``(row, col, k·d + i, 0)``), ``hash`` (the reference's counters) and
``sobol`` (terminal kinds, ``n_steps = 1``: one scrambled 2d-dimensional
Sobol point per path, point index ``block·16·256 + (row >> 3)·256 + col +
1``, 8 replicate groups row & 7 with the scramble salt ``0x632BE5AB``,
Box–Muller on dimensions (2i, 2i + 1)).

Dispatch. CUDA tensors go through :func:`_ma_cuda` (it counts its launches
in ``.launches`` and raises if it cannot build or launch), CPU tensors
through :func:`_ma_plain`, the same sums from the same counters with the
same float32 operations in the same order.

Error bars. The price route's ``sobol`` stderr is the randomized-QMC one
(the spread of the 8 replicate groups' means over √8); the ladder's
``std_error`` is the plain-MC formula for every sampler, indicative only
under ``sobol``. (The reference's docstring says the price route's is the
plain-MC formula; its numbers are these.)

Names. ``pallas_multi_asset_price`` → :func:`multi_asset_kernel_price`,
``pallas_multi_asset_greeks`` → :func:`multi_asset_kernel_greeks`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .exotic_kernel import (
    _check_tensor,
    _launch_checked,
    _mean_stderr,
    _n_blocks,
    _qmc_scrambles,
)
from .heston_kernel import _count, _dispatch, _require_cuda, _stream, _sum_blocks
from .kernel_rng import box_muller, draw_normals, sobol_nd

ROWS = 128
LANES = 256  # 4 branches × d ≤ 4 assets per lane
PATHS_PER_BLOCK = 4 * ROWS * LANES

KINDS = ("basket", "basket_geo", "rainbow_best", "rainbow_worst", "spread",
         "basket_asian",
         # internal: arithmetic-basket payoff minus its geometric control
         # variate (the exact closed-form mean is added back on the host)
         "basket_cv")
SAMPLERS = ("prng", "hash", "sobol")


def _n_out(d: int, lr: bool) -> int:
    return 2 + (2 * d + d * (d + 1) // 2 + 2 if lr else 0)


def _n_params(d: int, kind: str, lr: bool) -> int:
    """Length of the parameter vector (:func:`_params_vec`)."""
    return 4 * d + d * d + 1 + (kind == "basket_cv") + ((d * d + 2 * d + 2) if lr else 0)


def _check_launch(d: int, kind: str, n_steps: int, sampler: str, lr: bool) -> None:
    """The reference launcher's ``ValidationError`` cases and the kind/d/lr
    pairs the kernel takes."""
    if kind not in KINDS:
        raise ValidationError(f"unknown kind {kind!r}; choose {KINDS}")
    if sampler not in SAMPLERS:
        raise ValidationError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
    if not 2 <= d <= 4:
        raise ValidationError(f"kernel supports 2..4 assets, got {d}")
    if n_steps < 1:
        raise ValidationError(f"n_steps must be positive, got {n_steps}")
    if sampler == "sobol" and n_steps != 1:
        raise ValidationError(
            "multi-asset QMC is terminal-only (n_steps=1): the 2d-dim Sobol point drives the "
            "exact one-step GBM increment; use prng/hash for multi-step monitoring "
            "(basket_asian)")
    if kind == "spread" and d != 2:
        raise ValidationError("spread requires exactly 2 assets")
    if kind == "basket_cv" and lr:
        raise ValidationError("the geometric control variate has no LR ladder")


# ---------------------------------------------------------------------------
# The kernel: plain version
# ---------------------------------------------------------------------------
def _ma_block_plain(seed, block, p, *, d, kind, n_steps, cp, sampler, lr):
    """Per-lane moment terms (each (nb, ROWS, LANES) float32, the lane's four
    branches summed) of path blocks ``block``: a line-by-line twin of the
    reference's ``_ma_kernel`` body."""
    dev = p.device
    shape = (block.shape[0], ROWS, LANES)
    s0 = [p[4 * i] for i in range(d)]
    drift = [p[4 * i + 1] for i in range(d)]
    sig = [p[4 * i + 2] for i in range(d)]
    w = [p[4 * i + 3] for i in range(d)]
    L = [[p[4 * d + i * d + j] for j in range(d)] for i in range(d)]
    strike = p[4 * d + d * d]
    if kind == "basket_cv":
        g0 = p[4 * d + d * d + 1]  # Π s0^w from the host in float64
    if lr:
        base_inv = 4 * d + d * d + 1
        Linv = [[p[base_inv + i * d + j] for j in range(d)] for i in range(d)]
        base_x = base_inv + d * d
        inv_sig = [p[base_x + i] for i in range(d)]
        sqdt, c0 = p[base_x + d], p[base_x + d + 1]
        c1 = [p[base_x + d + 2 + i] for i in range(d)]
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)

    if sampler == "sobol":  # one 2d-dim point per path; n_steps == 1
        rid = torch.arange(ROWS, dtype=torch.int32, device=dev).reshape(1, -1, 1)
        cid = torch.arange(LANES, dtype=torch.int32, device=dev).reshape(1, 1, -1)
        idx = block * ((ROWS // 8) * LANES) + (rid >> 3) * LANES + cid + 1
        us = sobol_nd(idx, _qmc_scrambles(seed, dev), 2 * d)
        sob = [box_muller(us[2 * i], us[2 * i + 1]) for i in range(d)]

    def basket_level(x_b):
        lvl = w[0] * s0[0] * torch.exp(x_b[0])
        for i in range(1, d):
            lvl = lvl + w[i] * s0[i] * torch.exp(x_b[i])
        return lvl

    xs = [[zero] * d for _ in range(4)]  # log(S_i/S0_i) per branch
    asian = [zero] * 4
    g1 = [[zero] * d, [zero] * d]  # per stream: g = L⁻ᵀz at the first step
    va = [[zero] * d, [zero] * d]  # Σ_k g_k,i·(Lz_k)_i
    vb = [[zero] * d, [zero] * d]  # Σ_k g_k,i
    vq = [zero, zero]  # Σ_k |z_k|²
    for step in range(n_steps):
        streams = ([], [])
        for i in range(d):
            c, s = (sob[i] if sampler == "sobol" else
                    draw_normals(sampler, seed, block, step * d + i, n_steps * d, ROWS, LANES))
            streams[0].append(c)
            streams[1].append(s)
        shocks = []
        for zz in streams:
            sh = []
            for i in range(d):
                acc = L[i][0] * zz[0]
                for j in range(1, i + 1):
                    acc = acc + L[i][j] * zz[j]
                sh.append(acc)
            shocks.append(sh)
        if lr:
            for t, zz in enumerate(streams):
                for i in range(d):
                    g = Linv[0][i] * zz[0]
                    for j in range(1, d):
                        g = g + Linv[j][i] * zz[j]
                    if step == 0:
                        g1[t][i] = g
                    va[t][i] = va[t][i] + g * shocks[t][i]
                    vb[t][i] = vb[t][i] + g
                qsum = zz[0] * zz[0]
                for i in range(1, d):
                    qsum = qsum + zz[i] * zz[i]
                vq[t] = vq[t] + qsum
        for t in range(2):
            for i in range(d):
                m = sig[i] * shocks[t][i]  # the branch sign is exact: ±m
                xs[2 * t][i] = xs[2 * t][i] + drift[i] + m
                xs[2 * t + 1][i] = xs[2 * t + 1][i] + drift[i] - m
        if kind == "basket_asian":
            asian = [a + basket_level(x_b) for a, x_b in zip(asian, xs)]

    moms = [zero] * _n_out(d, lr)
    for b in range(4):
        x_b = xs[b]
        if kind in ("basket", "basket_cv"):
            pay = torch.clamp_min(cp * (basket_level(x_b) - strike), 0.0)
            if kind == "basket_cv":
                glog = w[0] * x_b[0]
                for i in range(1, d):
                    glog = glog + w[i] * x_b[i]
                pay = pay - torch.clamp_min(cp * (g0 * torch.exp(glog) - strike), 0.0)
        elif kind == "basket_geo":
            lg = w[0] * (torch.log(s0[0]) + x_b[0])
            for i in range(1, d):
                lg = lg + w[i] * (torch.log(s0[i]) + x_b[i])
            pay = torch.clamp_min(cp * (torch.exp(lg) - strike), 0.0)
        elif kind in ("rainbow_best", "rainbow_worst"):
            ext = torch.maximum if kind == "rainbow_best" else torch.minimum
            lvl = s0[0] * torch.exp(x_b[0])
            for i in range(1, d):
                lvl = ext(lvl, s0[i] * torch.exp(x_b[i]))
            pay = torch.clamp_min(cp * (lvl - strike), 0.0)
        elif kind == "spread":
            lvl = s0[0] * torch.exp(x_b[0]) - s0[1] * torch.exp(x_b[1])
            pay = torch.clamp_min(cp * (lvl - strike), 0.0)
        else:  # basket_asian
            pay = torch.clamp_min(cp * (asian[b] * (1.0 / n_steps) - strike), 0.0)
        terms = [pay, pay * pay]
        if lr:
            t, sgn = b // 2, (1.0, -1.0)[b % 2]
            terms += [pay * (sgn * g1[t][i]) for i in range(d)]
            terms += [pay * (inv_sig[i] * (va[t][i] - float(n_steps)) - sqdt * sgn * vb[t][i])
                      for i in range(d)]
            terms += [pay * (g1[t][i] * g1[t][j]) for i in range(d) for j in range(i, d)]
            sb_r = sgn * vb[t][0] * inv_sig[0]
            sb_th = c1[0] * sgn * vb[t][0]
            for i in range(1, d):
                sb_r = sb_r + sgn * vb[t][i] * inv_sig[i]
                sb_th = sb_th + c1[i] * sgn * vb[t][i]
            terms += [pay * (c0 * (vq[t] - float(n_steps * d)) + sb_th), pay * (sqdt * sb_r)]
        moms = [m + term for m, term in zip(moms, terms)]
    return moms


def _ma_plain(seed: int, block0: int, params: torch.Tensor, *, d: int, kind: str,
              n_steps: int, n_blocks: int, cp: float, sampler: str = "prng",
              lr: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: per-row sums ``(n_out, ROWS)``
    float32 of ``n_blocks`` path blocks from ``block0``. Runs on any
    device."""
    _check_launch(d, kind, n_steps, sampler, lr)
    return _sum_blocks(
        lambda blk: _ma_block_plain(seed, blk, params, d=d, kind=kind, n_steps=n_steps,
                                    cp=float(cp), sampler=sampler, lr=lr),
        n_blocks, block0, LANES, (_n_out(d, lr),), params.device)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------
_KIND_ID = {k: i for i, k in enumerate(KINDS)}
_SAMPLER_ID = {s: i for i, s in enumerate(SAMPLERS)}


@functools.lru_cache(maxsize=None)
def _plan(n_blocks: int, n_steps: int) -> tuple[int, int]:
    """(n_chunks, blocks_per_chunk) of a launch: the kernel source's plan
    (``multi_asset_plan``), a function of the geometry alone."""
    n_chunks, per = ctypes.c_int(), ctypes.c_int()
    _launch_checked("multi_asset_plan", _build.load_library().multi_asset_plan(
        n_blocks, n_steps, ctypes.byref(n_chunks), ctypes.byref(per)))
    return n_chunks.value, per.value


def _ma_cuda(seed: int, block0: int, params: torch.Tensor, *, d: int, kind: str, n_steps: int,
             n_blocks: int, cp: float, sampler: str = "prng", lr: bool = False) -> torch.Tensor:
    """The kernel: per-row sums ``(n_out, ROWS)`` float32 on the card.
    Launches on PyTorch's current stream and does not synchronize.
    ``_ma_cuda.launches`` counts its launches."""
    _check_launch(d, kind, n_steps, sampler, lr)
    dev = params.device
    _require_cuda("_ma_cuda", dev)
    n_params = _n_params(d, kind, lr)
    _check_tensor("params", params, dev, (n_params,))
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    n_chunks, per_chunk = _plan(n_blocks, n_steps)
    lib = _build.load_library()
    n_out = _n_out(d, lr)
    partials = torch.empty((n_out, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_out, ROWS), dtype=torch.float32, device=dev)
    err = lib.multi_asset_moments(
        params.data_ptr(), n_params, int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF,
        n_blocks, per_chunk, n_chunks, d, _KIND_ID[kind], n_steps, float(cp),
        _SAMPLER_ID[sampler], int(lr), n_out, partials.data_ptr(), out.data_ptr(), dev.index,
        _stream(dev))
    _launch_checked("multi_asset_moments", err)
    _count(_ma_cuda)
    return out


_ma_cuda.launches = 0


# ---------------------------------------------------------------------------
# Host side: parameters, moments → price / stderr / Greeks
# ---------------------------------------------------------------------------
def _params_vec(spots, weights, strike, maturity, rate, vols, corr, dividends, n_steps,
                lr: bool = False, cv: bool = False):
    """(d, T, float32 parameter vector): per asset i ``[s0_i, drift_dt_i,
    sig_sqrt_dt_i, w_i]``, the row-major Cholesky factor L, ``strike``, then
    ``g0 = Π s0^w`` (``cv``), then (``lr``) the row-major L⁻¹, the per-asset
    1/σ_i, ``[√dt, 1/(2T)]`` and the theta weights ``c1_i =
    drift_dt_i/(σ_i·√dt·T)``; the reference's vector bit for bit."""
    spots = np.asarray(spots, np.float64).ravel()
    vols = np.asarray(vols, np.float64).ravel()
    d = spots.size
    if not 2 <= d <= 4:
        raise ValidationError(f"kernel supports 2..4 assets, got {d}")
    if vols.size != d:
        raise ValidationError("vols must match spots length")
    weights = (np.asarray(weights, np.float64).ravel() if weights is not None
               else np.full(d, 1.0 / d))
    if weights.size != d:
        raise ValidationError(f"weights must have {d} entries, got {weights.size}")
    divs = np.broadcast_to(np.asarray(dividends, np.float64), (d,))
    c = np.asarray(corr, np.float64)
    if c.shape != (d, d):
        raise ValidationError(f"corr must be ({d},{d}), got {c.shape}")
    try:  # the reference lets numpy's LinAlgError through
        L = np.linalg.cholesky(c + 1e-9 * np.eye(d))
    except np.linalg.LinAlgError as e:
        raise ValidationError("corr must be positive definite") from e
    t = max(float(maturity), EPS_TIME)
    dt = t / n_steps
    p = []
    for i in range(d):
        p += [spots[i], (float(rate) - divs[i] - 0.5 * vols[i] ** 2) * dt,
              vols[i] * math.sqrt(dt), weights[i]]
    p += list(L.ravel())
    p += [float(strike)]
    if cv:
        p += [float(np.prod(spots ** weights))]  # g0 = Π s0^w (float64 host)
    if lr:
        p += list(np.linalg.inv(L).ravel())
        sqdt = math.sqrt(dt)
        p += list(1.0 / vols)  # inv_sig
        p += [sqdt, 1.0 / (2.0 * t)]  # sqdt, c0
        p += [((float(rate) - divs[i] - 0.5 * vols[i] ** 2) * dt) / (vols[i] * sqdt * t)
              for i in range(d)]  # c1 (theta weights)
    return d, t, np.asarray(p, np.float32)


def _launch(p: np.ndarray, *, device, seed: int, d: int, kind: str, n_steps: int,
            n_paths: int, cp: float, sampler: str, lr: bool) -> tuple[torch.Tensor, int]:
    """Per-row moment sums of one launch and its path count."""
    dev = torch.device(device)
    n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
    outs = _dispatch(_ma_cuda, _ma_plain, dev, seed, 0, torch.tensor(p, device=dev), d=d,
                     kind=kind, n_steps=n_steps, n_blocks=n_blocks, cp=float(cp),
                     sampler=sampler, lr=lr)
    return outs, n_blocks * PATHS_PER_BLOCK


def _weights(weights, d: int) -> np.ndarray:
    return (np.asarray(weights, np.float64).ravel() if weights is not None
            else np.full(d, 1.0 / d))


def multi_asset_kernel_price(kind: str, spots, strike, maturity, rate, vols, corr, weights=None,
                             cp: float = 1.0, dividends=0.0, n_paths: int = 1_000_000,
                             n_steps: int = 1, seed: int = 0, sampler: str = "prng",
                             control_variate: bool = False, device="cuda"):
    """(price, stderr, actual_paths) from the multi-asset kernel; price and
    stderr are float32 tensors on ``device``.

    ``kind`` ∈ {basket, basket_geo, rainbow_best, rainbow_worst, spread,
    basket_asian}. Terminal payoffs are exact with ``n_steps=1`` (GBM
    increments are exact at any step size); ``basket_asian`` monitors the
    basket at every one of the ``n_steps`` dates. ``weights`` defaults to
    equal; ``spread`` ignores weights and requires exactly 2 assets.

    ``sampler="sobol"`` (terminal kinds, ``n_steps=1`` only): one scrambled
    2d-dim Sobol point per path drives the exact terminal law. The stderr is
    then the randomized-QMC one: the std of the 8 independently scrambled
    replicate groups' means over √8.

    ``control_variate=True`` (``basket`` only): the kernel prices the
    difference against the geometric basket on the same paths and the exact
    geometric-basket closed form is added back; the stderr is the CV
    estimator's. Composes with any sampler.
    """
    if control_variate:
        if kind != "basket":
            raise ValidationError("control_variate applies to the arithmetic basket "
                                  "(geometric CV)")
        kind = "basket_cv"
    if kind not in KINDS:
        raise ValidationError(f"unknown kind {kind!r}; choose {KINDS}")
    d, t, p = _params_vec(spots, weights, strike, maturity, rate, vols, corr, dividends,
                          n_steps, cv=kind == "basket_cv")
    if kind == "spread" and d != 2:
        raise ValidationError("spread requires exactly 2 assets")
    outs, n = _launch(p, device=device, seed=seed, d=d, kind=kind, n_steps=n_steps,
                      n_paths=n_paths, cp=cp, sampler=sampler, lr=False)
    price, se = _mean_stderr(outs[0], outs[1], n, math.exp(-float(rate) * t), sampler)
    if kind == "basket_cv":
        from ..models.multi_asset import geometric_basket_closed_form

        price = price + float(geometric_basket_closed_form(
            spots, _weights(weights, d), strike, t, rate, vols, corr, cp, dividends))
    return price, se, n


def multi_asset_kernel_greeks(kind: str, spots, strike, maturity, rate, vols, corr,
                              weights=None, cp: float = 1.0, dividends=0.0,
                              n_paths: int = 1_000_000, n_steps: int = 1, seed: int = 0,
                              sampler: str = "prng", device="cuda") -> dict:
    """Price + stderr + the full per-asset likelihood-ratio Greek ladder in
    one kernel pass (any kind: LR differentiates the correlated Gaussian
    density, so the rainbows' kinks cost nothing):

      delta_i  = df·E[pay·g₁ᵢ] / (S0_i·σ_i·√dt),  g₁ = L⁻ᵀζ₁
      gamma_ij = (Hˣ_ij − δ_ij·S0_i·delta_i) / (S0_i·S0_j),
                 Hˣ_ij = df·(E[pay·g₁ᵢg₁ⱼ] − C⁻¹_ij·E[pay])/(σ_iσ_j·dt)
      vega_i   = df·E[pay·(Σ_k gₖᵢ[(Lzₖ)ᵢ/σᵢ − √dt] − n/σᵢ)]
      theta    = r·price − df·E[pay·score_T]  (−∂V/∂T at fixed n_steps)
      rho      = df·E[pay·√dt·Σ_kᵢ gₖᵢ/σᵢ] − T·price

    with ζ₁/zₖ the per-step pre-correlation iid normals. LR variance grows
    like 1/dt for gamma and like n_steps for vega/theta/rho. Returns {price,
    std_error (float32 tensors on ``device``), delta (d,), vega (d,), gamma
    (d, d) (float64 tensors), theta, rho (floats), paths}. ``std_error`` is
    the plain-MC formula for every sampler (indicative only under
    ``sobol``, whose ladder is the pure 2d-dim QMC terminal law)."""
    if kind not in KINDS or kind == "basket_cv":
        raise ValidationError(f"unknown kind {kind!r}; choose {KINDS}")
    d, t, p = _params_vec(spots, weights, strike, maturity, rate, vols, corr, dividends,
                          n_steps, lr=True)
    if kind == "spread" and d != 2:
        raise ValidationError("spread requires exactly 2 assets")
    outs, n = _launch(p, device=device, seed=seed, d=d, kind=kind, n_steps=n_steps,
                      n_paths=n_paths, cp=cp, sampler=sampler, lr=True)
    return _combine_lr(outs, n, d, t, rate, spots, vols, corr, n_steps)


def _combine_lr(outs: torch.Tensor, n: int, d: int, t: float, rate, spots, vols, corr,
                n_steps: int) -> dict:
    """Host-side assembly of the LR ladder from the kernel's per-row sums
    (float64). The C⁻¹ of the gamma terms is formed from ``corr + 1e-9·I``,
    the kernel factor's jitter."""
    df = math.exp(-float(rate) * t)
    rate_f = float(rate)
    price, se = _mean_stderr(outs[0], outs[1], n, df, "prng")
    spots_a = np.asarray(spots, np.float64).ravel()
    vols_a = np.asarray(vols, np.float64).ravel()
    dt = t / n_steps
    sqdt = math.sqrt(dt)
    m = outs.double().sum(dim=1).cpu().numpy() / n
    ntri = d * (d + 1) // 2
    m_pay, m_del, m_veg = m[0], m[2:2 + d], m[2 + d:2 + 2 * d]
    m_gam = m[2 + 2 * d:2 + 2 * d + ntri]
    m_th, m_rho = m[2 + 2 * d + ntri], m[3 + 2 * d + ntri]
    delta = df * m_del / (spots_a * vols_a * sqdt)
    vega = df * m_veg
    cinv = np.linalg.inv(np.asarray(corr, np.float64) + 1e-9 * np.eye(d))
    cinv = 0.5 * (cinv + cinv.T)  # gamma comes back exactly symmetric
    iu, ju = np.triu_indices(d)
    mg = np.empty((d, d))
    mg[iu, ju] = m_gam
    mg[ju, iu] = m_gam
    hx = df * (mg - cinv * m_pay) / (np.outer(vols_a, vols_a) * dt)
    gamma = hx / np.outer(spots_a, spots_a) - np.diag(delta / spots_a)
    price_f = float(price)
    return {"price": price, "std_error": se, "delta": torch.from_numpy(delta),
            "vega": torch.from_numpy(vega), "gamma": torch.from_numpy(gamma),
            "theta": rate_f * price_f - df * float(m_th),
            "rho": df * float(m_rho) - t * price_f, "paths": n}
