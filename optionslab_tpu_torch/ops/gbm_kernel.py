"""GBM Monte Carlo price + full Greek ladder in one kernel pass.

The port of ``optionslab_tpu/ops/gbm_pallas.py``. The kernel
(``csrc/gbm_mc.cu``) sums, per contract row, Σpay, Σpay², Σ1{ex}·S_T and
Σ1{ex}·S_T·z over every simulated path; :func:`_combine` turns those moments
into price, stderr, Δ, Γ, vega, ρ, θ, dual-Δ and dividend-ρ on the host
side of the call.

Geometry. :func:`_prepare` and :func:`_lanes_for` keep the reference's
meaning: a book of ``c`` contracts is replicated ``reps`` times onto
``rows`` (padded to a multiple of ``SUBLANES``) and each path block gives a
row ``4·lanes`` paths. On the card these no longer describe a tiling; they
define the counter space from which the ``hash`` and ``sobol`` samplers
draw, so the path set is the reference's own and the port can be checked
against it path for path.

Dispatch. A batch on a CUDA device goes through the kernel
(:func:`_gbm_moments_cuda`), which raises if it cannot build or launch; a
batch on the CPU goes through the plain torch version
(:func:`_gbm_moments_plain`), which computes the same sums from the same
counters.
"""

from __future__ import annotations

import math
import threading

import torch

from ..types import FIELDS, ContractBatch
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .kernel_rng import (
    GOLDEN,
    GROUP_SALT,
    HASH_SALT,
    TWO_PI,
    fmix32,
    hash_uniform,
    philox_uniform_pair,
    sobol_pair,
    wrap32,
)

# The reference's logical layout, kept so the `hash`/`sobol` path set is the
# reference's: rows are padded to SUBLANES, books smaller than TARGET_ROWS
# are replicated up to it, and lanes follow the reference's VMEM budget.
SUBLANES = 8
TARGET_ROWS = 256
_VMEM_ELEMS_PER_BUF = 256 * 1024

SAMPLERS = ("prng", "hash", "sobol")
_SAMPLER_ID = {"prng": 0, "hash": 1, "sobol": 2}
_MASK30 = (1 << 30) - 1

# CUDA blocks a launch aims for (rows x chunks). A constant, not read from
# the card, so the summation order and hence the result depend only on the
# seed and the geometry.
_TARGET_CTAS = 4096
# Elements (blocks x rows x lanes) per step of the plain version's loop.
_PLAIN_CHUNK_ELEMS = 1 << 22
_LAUNCH_LOCK = threading.Lock()  # the server launches from several threads


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's and CUDA's sqrtf are.

    torch's CPU float32 sqrt is off by an ulp on some inputs; the float64
    root rounded once to float32 is exact (53 >= 2·24 + 2 bits).
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _lanes_for(rows: int) -> int:
    """Lanes per path block: the reference's VMEM-budget width, 128-aligned."""
    return int(min(2048, max(128, (_VMEM_ELEMS_PER_BUF // rows) // 128 * 128)))


def _geometry(c: int) -> tuple[int, int]:
    """(reps, rows) for a book of ``c`` contracts."""
    reps = max(1, TARGET_ROWS // c)
    rows = ((c * reps + SUBLANES - 1) // SUBLANES) * SUBLANES
    return reps, rows


def _n_blocks(n_paths: int, lanes: int, reps: int) -> int:
    return max(1, math.ceil(n_paths / (4 * lanes * reps)))


def _check_sampler(sampler: str) -> None:
    if sampler not in SAMPLERS:
        raise ValidationError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")


def _prepare(batch: ContractBatch):
    """Flatten + replicate the book onto ``rows`` rows.

    Returns ``(b, flat, params, c, reps, rows, pad)``: the broadcast batch,
    its fields flattened to float32, the 7 per-row kernel inputs
    ``(s0, k, cp, a, s, rep_id, cid)`` of shape ``(rows,)``, and the
    geometry. Row ``rep*c + j`` holds replica ``rep`` of contract ``j``;
    the edge-padded tail rows are skipped by the kernel and discarded by
    :func:`_combine`.
    """
    b = batch.broadcast()
    c = max(b.size, 1)
    flat = ContractBatch(*(getattr(b, k).reshape(-1).to(torch.float32) for k in FIELDS))
    reps, rows = _geometry(c)
    pad = rows - c * reps

    def expand(x):
        tiled = x.repeat(reps)
        if pad:
            tiled = torch.cat([tiled, tiled[-1:].expand(pad)])
        return tiled.contiguous()

    t = torch.clamp_min(flat.maturity, EPS_TIME)
    s0 = expand(flat.spot)
    k = expand(flat.strike)
    cp = expand(flat.cp)
    a = expand((flat.rate - flat.dividend - 0.5 * flat.vol**2) * flat.maturity)
    s = expand(flat.vol * _sqrt_rn(t))
    row = torch.arange(rows, dtype=torch.int32, device=flat.spot.device)
    rep_id = torch.clamp_max(row // c, reps - 1)
    cid = row % c
    return b, flat, (s0, k, cp, a, s, rep_id, cid), c, reps, rows, pad


def gbm_paths_per_launch(batch: ContractBatch, n_paths: int) -> int:
    """Actual number of simulated paths per contract for a given request."""
    reps, rows = _geometry(max(batch.size, 1))
    lanes = _lanes_for(rows)
    return _n_blocks(n_paths, lanes, reps) * 4 * lanes * reps


# ---------------------------------------------------------------------------
# The moment pass: plain version and kernel
# ---------------------------------------------------------------------------
def _uniforms(sampler, seed, block, row, col, *, rows, lanes, reps, rep_id, cid):
    """(u1, u2) for path blocks ``block`` (nb,1,1), rows ``row`` (1,R,1) and
    lanes ``col`` (1,1,lanes), all int32, from the kernel's counters."""
    if sampler == "hash":
        ctr = block * wrap32(2 * rows * lanes) + row * lanes + col
        return hash_uniform(ctr, seed), hash_uniform(ctr + wrap32(rows * lanes), seed)
    if sampler == "sobol":
        salted = wrap32(int(seed) * GOLDEN)
        if reps % 8 == 0:
            idx = block * wrap32((reps // 8) * lanes) + (rep_id >> 3) * lanes + col + 1
            h = fmix32((cid + (rep_id & 7) * GROUP_SALT) ^ salted)
        else:
            idx = block * wrap32(reps * lanes) + rep_id * lanes + col + 1
            h = fmix32(cid ^ salted)
        return sobol_pair(idx, h & _MASK30, fmix32(h + HASH_SALT) & _MASK30)
    return philox_uniform_pair(row, col, seed, block)


def _gbm_moments_plain(seed: int, block0: int, params, *, n_blocks: int, rows: int,
                       active_rows: int, lanes: int, sampler: str, reps: int,
                       greeks: bool) -> torch.Tensor:
    """Plain torch version of the kernel: per-row moment sums
    ``(n_mom, rows)`` float32 (n_mom = 4 with greeks, else 2), padded rows 0.

    Same counters and float32 path arithmetic as the kernel, in the same
    order; sums are taken in float64 and over the blocks in steps of
    ``_PLAIN_CHUNK_ELEMS`` so memory stays bounded. Runs on any device.
    """
    dev = params[0].device
    s0, k, cp, a, s, rep_id, cid = (p[:active_rows].reshape(1, active_rows, 1) for p in params)
    row = torch.arange(active_rows, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    col = torch.arange(lanes, dtype=torch.int32, device=dev).reshape(1, 1, -1)
    n_mom = 4 if greeks else 2
    sums = torch.zeros((n_mom, active_rows), dtype=torch.float64, device=dev)
    base = s0 * torch.exp(a)  # S0·e^{drift}, one exp for all four branches
    step = max(1, _PLAIN_CHUNK_ELEMS // (active_rows * lanes))
    for b in range(0, n_blocks, step):
        blocks = torch.arange(b, min(n_blocks, b + step), dtype=torch.int64, device=dev)
        block = (blocks + block0).to(torch.int32).reshape(-1, 1, 1)
        u1, u2 = _uniforms(sampler, seed, block, row, col, rows=rows, lanes=lanes,
                           reps=reps, rep_id=rep_id, cid=cid)
        radius = _sqrt_rn(-2.0 * torch.log(u1))
        theta = TWO_PI * u2
        z_cos = radius * torch.cos(theta)
        z_sin = radius * torch.sin(theta)
        grow_cos = torch.exp(s * z_cos)
        grow_sin = torch.exp(s * z_sin)
        for z, st in ((z_cos, base * grow_cos), (-z_cos, base / grow_cos),
                      (z_sin, base * grow_sin), (-z_sin, base / grow_sin)):
            x = cp * (st - k)
            pay = torch.clamp_min(x, 0.0)
            terms = [pay, pay * pay]
            if greeks:
                ind_st = torch.where(x > 0, st, 0.0)
                terms += [ind_st, ind_st * z]
            for m, term in enumerate(terms):
                sums[m] += term.sum(dim=(0, 2), dtype=torch.float64)
    out = torch.zeros((n_mom, rows), dtype=torch.float32, device=dev)
    out[:, :active_rows] = sums.to(torch.float32)
    return out


def _chunking(n_blocks: int, active_rows: int) -> tuple[int, int]:
    """(n_chunks, blocks_per_chunk) of the kernel's launch grid."""
    n_chunks = max(1, min(n_blocks, -(-_TARGET_CTAS // active_rows)))
    per_chunk = -(-n_blocks // n_chunks)
    return -(-n_blocks // per_chunk), per_chunk


def _gbm_moments_cuda(seed: int, block0: int, params, *, n_blocks: int, rows: int,
                      active_rows: int, lanes: int, sampler: str, reps: int,
                      greeks: bool) -> torch.Tensor:
    """The kernel: per-row moment sums ``(n_mom, rows)`` float32 on the card.

    Launches on PyTorch's current stream and does not synchronize.
    ``_gbm_moments_cuda.launches`` counts its launches.
    """
    _check_sampler(sampler)
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"_gbm_moments_cuda needs CUDA tensors, got {dev}")
    for p, dtype in zip(params, (torch.float32,) * 5 + (torch.int32,) * 2):
        if p.device != dev or p.dtype != dtype or p.shape != (rows,) or not p.is_contiguous():
            raise ValueError(f"kernel input must be contiguous {dtype} of shape ({rows},) "
                             f"on {dev}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if not 1 <= active_rows <= rows:
        raise ValueError(f"active_rows {active_rows} outside [1, {rows}]")
    n_chunks, per_chunk = _chunking(n_blocks, active_rows)
    if active_rows * n_chunks >= 2**31 or (4 if greeks else 2) * rows >= 2**31:
        raise ValueError(f"book of {active_rows} rows is too large for one launch")
    lib = _build.load_library()
    n_mom = 4 if greeks else 2
    partials = torch.empty((n_mom, active_rows, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, rows), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gbm_mc_moments(
        *(p.data_ptr() for p in params), int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF,
        n_blocks, per_chunk, n_chunks, rows, active_rows, lanes, reps,
        _SAMPLER_ID[sampler], int(greeks), partials.data_ptr(), out.data_ptr(), dev.index,
        stream)
    if err:
        raise RuntimeError(f"gbm_mc_moments launch failed: {_build.error_string(err)} ({err})")
    with _LAUNCH_LOCK:
        _gbm_moments_cuda.launches += 1
    return out


_gbm_moments_cuda.launches = 0


def _gbm_moments(seed, block0, params, **kw) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = params[0].device
    if dev.type == "cuda":
        return _gbm_moments_cuda(seed, block0, params, **kw)
    if dev.type == "cpu":
        return _gbm_moments_plain(seed, block0, params, **kw)
    raise ValueError(f"no GBM kernel for device {dev}")


# ---------------------------------------------------------------------------
# Moments → price / stderr / Greeks
# ---------------------------------------------------------------------------
def _merge(v: torch.Tensor, c: int, reps: int) -> torch.Tensor:
    """Per-row sums → per-contract sums (rows j, j+c, j+2c, ... are
    replicas of contract j)."""
    return v[: c * reps].reshape(reps, c).sum(dim=0)


def _replication_stderr(pay_rows: torch.Tensor, c: int, reps: int, n: torch.Tensor):
    """Randomized-QMC stderr over the 8 replicate groups of each contract."""
    grp = pay_rows[: c * reps].reshape(reps // 8, 8, c).sum(dim=0) * (8.0 / n)
    return grp.std(dim=0, correction=1) / math.sqrt(8.0)


def _expire(flat, price, stderr):
    """Expired contracts (T <= EPS_TIME) price at intrinsic with no error."""
    expired = flat.maturity <= EPS_TIME
    intrinsic = torch.clamp_min(flat.cp * (flat.spot - flat.strike), 0.0)
    return torch.where(expired, intrinsic, price), torch.where(expired, 0.0, stderr)


def _combine(b, flat, sums, c, reps, n_per_row, dtype, sampler: str = "prng") -> dict:
    """Row moments → price/stderr per original contract, plus the Greeks
    when ``sums`` holds all four moments (``(4, rows)``; the price-only
    kernel gives ``(2, rows)``).

    Under the replicated-scramble QMC layout (sobol, reps % 8 == 0) the
    stderr is the randomized replication estimate over the 8 replica groups.
    """
    n = torch.tensor(float(n_per_row * reps), dtype=torch.float32, device=sums.device)
    pay, pay2 = (_merge(v, c, reps) for v in sums[:2])
    df = torch.exp(-flat.rate * flat.maturity)
    mean_pay = pay / n
    price = df * mean_pay
    if sampler == "sobol" and reps % 8 == 0:
        stderr = df * _replication_stderr(sums[0], c, reps, n)
    else:
        stderr = df * torch.sqrt(torch.clamp_min(pay2 / n - mean_pay**2, 0.0) / n)

    out = {}
    if sums.shape[0] == 4:
        mean_m1, mean_mz = (_merge(v, c, reps) / n for v in sums[2:])
        t = torch.clamp_min(flat.maturity, EPS_TIME)
        sqrt_t = torch.sqrt(t)
        sig_sqrt_t = torch.clamp_min(flat.vol * sqrt_t, 1e-12)
        delta = df * flat.cp * mean_m1 / flat.spot
        out = {
            "delta": delta,
            "gamma": df * flat.cp * (mean_mz / sig_sqrt_t - mean_m1) / flat.spot**2,
            "vega": df * flat.cp * (mean_mz * sqrt_t - flat.vol * t * mean_m1),
            # identities on the same moments: price = S·delta - K·cp·df·E[1{}]
            "rho": t * (df * flat.cp * mean_m1 - price),
            "theta": -(
                -flat.rate * price
                + df * flat.cp * (
                    (flat.rate - flat.dividend - 0.5 * flat.vol**2) * mean_m1
                    + flat.vol / (2.0 * sqrt_t) * mean_mz
                )
            ),
            "dual_delta": (price - flat.spot * delta) / flat.strike,
            "dividend_rho": -t * flat.spot * delta,
        }
    price, stderr = _expire(flat, price, stderr)
    out = {"price": price, "std_error": stderr, **out}
    return {kk: v.reshape(b.shape).to(dtype) for kk, v in out.items()}


def _run(batch: ContractBatch, n_paths: int, seed: int, sampler: str, greeks: bool):
    _check_sampler(sampler)
    b, flat, params, c, reps, rows, _pad = _prepare(batch)
    lanes = _lanes_for(rows)
    n_blocks = _n_blocks(n_paths, lanes, reps)
    sums = _gbm_moments(seed, 0, params, n_blocks=n_blocks, rows=rows, active_rows=c * reps,
                        lanes=lanes, sampler=sampler, reps=reps, greeks=greeks)
    return b, flat, sums, c, reps, n_blocks * 4 * lanes


@torch.no_grad()
def gbm_mc_price_greeks(batch: ContractBatch, n_paths: int = 1_000_000, seed: int = 0,
                        sampler: str = "prng") -> dict:
    """Price + stderr + full first/second-order Greek ladder, one kernel pass.

    ``n_paths`` is the per-contract path budget, rounded up to whole path
    blocks (see :func:`gbm_paths_per_launch`). ``sampler`` is ``"prng"``
    (Philox), ``"hash"`` or ``"sobol"`` (scrambled QMC). Returns a dict of
    price/std_error/delta/gamma/vega/rho/theta/dual_delta/dividend_rho
    tensors shaped like the broadcast batch, on the batch's device. Not
    differentiable: :func:`gbm_mc_price` is the entry for autograd.
    """
    b, flat, sums, c, reps, n_per_row = _run(batch, n_paths, seed, sampler, greeks=True)
    return _combine(b, flat, sums, c, reps, n_per_row, batch.dtype, sampler=sampler)


@torch.no_grad()
def gbm_mc_price_only(batch: ContractBatch, n_paths: int = 1_000_000, seed: int = 0,
                      sampler: str = "prng"):
    """(price, stderr) with the Greek accumulators compiled out. Same path
    set as :func:`gbm_mc_price_greeks`, so prices agree to f32 reduction
    order."""
    out = _combine(*_run(batch, n_paths, seed, sampler, greeks=False), batch.dtype,
                   sampler=sampler)
    return out["price"], out["std_error"]


# ---------------------------------------------------------------------------
# Differentiable price: backward returns the kernel's own Greeks
# ---------------------------------------------------------------------------
class _GbmMcPrice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spot, strike, maturity, rate, vol, dividend, cp, n_paths, seed, sampler):
        batch = ContractBatch(spot, strike, maturity, rate, vol, dividend, cp)
        out = gbm_mc_price_greeks(batch, n_paths=n_paths, seed=seed, sampler=sampler)
        ctx.shapes = [f.shape for f in (spot, strike, maturity, rate, vol, dividend)]
        ctx.dtypes = [f.dtype for f in (spot, strike, maturity, rate, vol, dividend)]
        ctx.save_for_backward(out["delta"], out["dual_delta"], -out["theta"], out["rho"],
                              out["vega"], out["dividend_rho"])
        return out["price"]

    @staticmethod
    def backward(ctx, g):
        # broadcast-VJP: a field shared across the book (e.g. a scalar
        # strike) receives the SUM of the per-contract sensitivities
        grads = [(greek * g).sum_to_size(shape).to(dtype)
                 for greek, shape, dtype in zip(ctx.saved_tensors, ctx.shapes, ctx.dtypes)]
        return (*grads, None, None, None, None)


def gbm_mc_price(batch: ContractBatch, n_paths: int = 1_000_000, seed: int = 0,
                 sampler: str = "prng") -> torch.Tensor:
    """Differentiable price through the fused kernel.

    ``torch.autograd`` of this function returns the kernel's own Greeks,
    computed in the same forward pass: d/dspot = delta, d/dstrike =
    dual_delta, d/dmaturity = -theta, d/drate = rho, d/dvol = vega,
    d/ddividend = dividend_rho. ``cp`` gets no gradient.
    """
    return _GbmMcPrice.apply(batch.spot, batch.strike, batch.maturity, batch.rate,
                             batch.vol, batch.dividend, batch.cp, n_paths, seed, sampler)
