"""The Douglas ADI time loop of the Heston and SLV PDEs (``models/heston_fdm.py``).

The reference runs each loop on the device: one ``lax.scan`` over the step of
``optionslab_tpu/models/heston_fdm.py:160-177`` in ``_heston_adi`` (:200),
``_adi_solve_grid`` (:219, rematerialised by ``jax.checkpoint`` for reverse
mode), ``_heston_adi_bermudan`` (:331) and ``_slv_adi_bermudan`` (:403).
Here a whole loop is one launch of ``heston_adi_kernel`` (``csrc/heston_adi.cu``)
on CUDA tensors and the plain torch loop (:func:`_adi_plain`, two batched
tridiagonal solves a step) on CPU tensors; any other device raises.

Each step, from the grid V (n_v, n_x) of log-spot columns and variance rows:
the mixed stencil a0v, ``a1v = A1·V`` along x and ``a2v = A2·V`` along v, the
predictor ``y0 = V + dt·((a0v + a1v) + a2v)``, the x-sweep
``(I − θ·dt·A1)·y1 = y0 − θ·dt·a1v`` with the Dirichlet columns written in,
the v-sweep ``(I − θ·dt·A2)·y2 = y1 − θ·dt·a2v`` (the columns as systems),
and the ends pinned again. The modes: :data:`EUROPEAN`; :data:`AMERICAN`
(``max(V, intrinsic)`` after every step); :data:`BERMUDAN` (the projection
only at the end of each exercise-date block but the last, the continuation
slice recorded before it); and the SLV Bermudan, where the x-operator and
the mixed coefficient change every step with the frozen leverage row.

:func:`adi_loop` puts the European and American loops behind an
``autograd.Function``; its backward is one launch of
``heston_adi_adjoint_kernel`` (the hand-written reverse recursion
:func:`_adi_reverse_plain` on the CPU) over the grids the forward kept, on
one thread-block cluster where :func:`adjoint_cluster_plan` finds one that
holds the grid's bands and one cooperative launch otherwise: each
solve's adjoint is ``_TridiagSolve.backward``'s rule (the transposed system,
diag ← −λx, lower ← −λx₋₁, upper ← −λx₊₁), the projection splits a tie half
and half as ``torch.maximum``'s derivative does.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build
from .tridiag import (DUMP_BYTES, PAD_ROWS, _neighbours, _tridiag_plain, tridiag_apply,
                      tridiag_solve)

EUROPEAN, AMERICAN, BERMUDAN = 0, 1, 2
THETA_S = 0.5  # Douglas implicitness
SMEM_LIMIT = 232_448  # bytes of shared memory a CUDA block can use on sm_90 (227 KB)
_LAUNCH_LOCK = threading.Lock()  # the server prices from several threads


class AdiOps(NamedTuple):
    """The loop's operands, every one computed by torch (so no ``exp`` in the
    kernel can differ from torch's). Under SLV the x-side fields are None:
    the loop builds them every step from :class:`SlvLeverage`."""

    x_stencil: tuple | None  # (a1, b1, c1) of A1, each (n_v, n_x)
    x_sweep: tuple | None  # (lower, diag, upper) of I − θ·dt·A1, each (n_v, n_x)
    v_stencil: tuple  # (a2, b2, c2) of A2, each (1, n_v)
    v_sweep: tuple  # (lower, diag, upper) of I − θ·dt·A2, each (1, n_v)
    mixed: torch.Tensor | None  # (n_v − 2, 1): ρσ·v/g' on the interior rows
    dt: torch.Tensor  # 0-dim
    den: torch.Tensor  # 0-dim 4·dx·dξ, the mixed stencil's denominator (frozen mesh)
    bounds: torch.Tensor  # (n_t, 2): the Dirichlet values at x_lo and x_hi each step
    intrinsic: torch.Tensor  # (n_v, n_x) exercise value


class SlvLeverage(NamedTuple):
    """The SLV x-operator's inputs: the leverage row of step k is
    ``lev[rows[k]]``; the x-diffusion is L²·v and the mixed term ρσ·L·v."""

    lev: torch.Tensor  # (n_rows, n_x) leverage on the ADI x-grid
    rows: tuple  # (n_t,) Python ints
    vj: torch.Tensor  # (n_v, 1) variance nodes
    w: torch.Tensor  # (n_v − 2, 1) v/g' on the interior rows
    rs: torch.Tensor  # 0-dim ρ·σ
    rate: torch.Tensor
    dividend: torch.Tensor
    dx: torch.Tensor


def _ends(mid, first, last):
    """``mid`` (.., m−2) with ``first`` and ``last`` columns added on the last
    axis (scalars or columns)."""
    shape = mid.shape[:-1] + (1,)
    return torch.cat([torch.as_tensor(first, dtype=mid.dtype, device=mid.device).expand(shape),
                      mid,
                      torch.as_tensor(last, dtype=mid.dtype, device=mid.device).expand(shape)],
                     dim=-1)


def x_operator(vj, l2, rate, dividend, dx, dt, n_x: int):
    """The x-direction stencil (a1, b1, c1), (n_v, n_x), with identity rows
    at the pinned x-boundaries, and its implicit sweep matrix. ``vj`` is
    v[:, None], ``l2`` the squared leverage row (1, n_x) or 1."""
    conv_x = (rate - dividend - 0.5 * l2 * vj) / (2.0 * dx)
    diff_x = 0.5 * l2 * vj / (dx * dx)
    a1 = diff_x - conv_x
    c1 = diff_x + conv_x
    b1 = -2.0 * diff_x - 0.5 * rate
    a1, b1, c1 = (z.expand(vj.shape[0], n_x) for z in (a1, b1, c1))
    a1 = _ends(a1[:, 1:-1], 0.0, 0.0)
    c1 = _ends(c1[:, 1:-1], 0.0, 0.0)
    b1 = _ends(b1[:, 1:-1], 0.0, 0.0)
    i1_di = _ends((1.0 - THETA_S * dt * b1)[:, 1:-1], 1.0, 1.0)
    return (a1, b1, c1), (-THETA_S * dt * a1, i1_di, -THETA_S * dt * c1)


def mixed(vgrid, coef, den):
    """ρσ·v·V_xv = (ρσ·v/g')·V_xξ by central differences (zero at the edges);
    ``coef`` is ρσ(·L)·(v/g') on the interior, broadcastable to (n_v−2, n_x−2),
    ``den`` = 4·dx·dξ."""
    core = (vgrid[2:, 2:] - vgrid[2:, :-2] - vgrid[:-2, 2:] + vgrid[:-2, :-2]) / den
    return F.pad(coef * core, (1, 1, 1, 1))


def douglas(vg, x_stencil, x_sweep, v_stencil, v_sweep, a0v, blo, bhi, dt):
    """One Douglas step from ``vg`` (n_v, n_x): explicit predictor, x-sweep,
    v-sweep, Dirichlet x-boundaries pinned. Returns (y1, the new grid)."""
    a1, b1, c1 = x_stencil
    a2, b2, c2 = v_stencil
    a1v = tridiag_apply(a1, b1, c1, vg)
    a2v = tridiag_apply(a2, b2, c2, vg.T).T
    y0 = vg + dt * (a0v + a1v + a2v)
    # x-sweep: (I - th dt A1) Y1 = Y0 - th dt A1 V
    rhs1 = _ends((y0 - THETA_S * dt * a1v)[:, 1:-1], blo, bhi)
    y1 = tridiag_solve(*x_sweep, rhs1)
    # v-sweep: (I - th dt A2) Y2 = Y1 - th dt A2 V, the columns as systems
    rhs2 = (y1 - THETA_S * dt * a2v).T
    y2 = tridiag_solve(*v_sweep, rhs2).T
    return y1, _ends(y2[:, 1:-1], blo, bhi)


def _slv_x(slv: SlvLeverage, k: int, dt, n_x: int):
    """Step k's x-operator and mixed coefficient under frozen leverage."""
    lev = slv.lev[slv.rows[k]]
    x_stencil, x_sweep = x_operator(slv.vj, (lev * lev)[None, :], slv.rate, slv.dividend, slv.dx,
                                    dt, n_x)
    return x_stencil, x_sweep, slv.rs * lev[None, 1:-1] * slv.w


def _projects(mode: int, k: int, spd: int, n_t: int) -> bool:
    """Whether step k ends with the projection on the exercise value."""
    if mode == AMERICAN:
        return True
    return mode == BERMUDAN and (k + 1) % spd == 0 and k + 1 < n_t


def _check_mode(mode: int, spd: int, n_t: int, slv) -> None:
    if mode not in (EUROPEAN, AMERICAN, BERMUDAN) or spd < 1 or n_t % spd:
        raise ValueError(f"bad ADI mode {mode} or steps a date {spd} for {n_t} steps")
    if slv is not None and mode != BERMUDAN:
        raise ValueError("the SLV loop runs in the Bermudan mode only")


def _adi_plain(ops: AdiOps, start, mode: int, spd: int = 1, slv: SlvLeverage | None = None,
               history: bool = False):
    """The plain loop: returns (grid, continuation slices or None, history
    or None). The slices (Bermudan) are (n_dates + 1, n_v, n_x) by forward
    date index, entries 0 and n_dates zero; the history (with ``history``)
    is each step's input grid, y1 and new grid before the projection, each
    (n_t, n_v, n_x)."""
    n_t = ops.bounds.shape[0]
    _check_mode(mode, spd, n_t, slv)
    n_x = start.shape[1]
    vg = start
    conts, hist = [], []
    for k in range(n_t):
        if slv is None:
            x_stencil, x_sweep, coef = ops.x_stencil, ops.x_sweep, ops.mixed
        else:
            x_stencil, x_sweep, coef = _slv_x(slv, k, ops.dt, n_x)
        y1, vp = douglas(vg, x_stencil, x_sweep, ops.v_stencil, ops.v_sweep,
                         mixed(vg, coef, ops.den), ops.bounds[k, 0], ops.bounds[k, 1], ops.dt)
        if history:
            hist.append((vg, y1, vp))
        if _projects(mode, k, spd, n_t):
            if mode == BERMUDAN:
                conts.append(vp)
            vp = torch.maximum(vp, ops.intrinsic)
        vg = vp
    cont = None
    if mode == BERMUDAN:
        zero = torch.zeros((1,) + start.shape, dtype=start.dtype, device=start.device)
        cont = torch.cat([zero, torch.stack(conts[::-1]), zero]) if conts else \
            torch.cat([zero, zero])
    return vg, cont, (tuple(torch.stack(h) for h in zip(*hist)) if history else None)


# pointers of one forward launch, in the order of csrc/heston_adi.cu's AdiArgs
_FWD_FIELDS = ("a1", "b1", "c1", "lo1", "di1", "up1", "a2", "b2", "c2", "lo2", "di2", "up2",
               "mc", "scal", "bounds", "intr", "start", "lev", "rows", "v", "w", "out", "cont",
               "vbuf", "y1buf", "y2buf", "xpiv")
# and of one reverse launch (AdjointArgs)
_REV_FIELDS = ("a1", "b1", "c1", "lo1", "di1", "up1", "a2", "b2", "c2", "lo2", "di2", "up2",
               "mc", "scal", "intr", "vin", "y1h", "vph", "gout",
               "g_a1", "g_b1", "g_c1", "g_lo1", "g_di1", "g_up1", "p_a2", "p_b2", "p_c2",
               "p_lo2", "p_di2", "p_up2", "p_mc", "p_dts", "p_td1", "p_td2", "p_b1", "p_bv",
               "g_intr", "g_start", "stage")
KWARPS = 4  # warps a CUDA block (csrc/heston_adi.cu kWarps)


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(n_v: int, n_x: int) -> int:
    """Shared memory of one CUDA block of the cooperative forward kernel
    (``Layout`` in ``csrc/heston_adi.cu``): four block-wide v-sweep planes
    of n_v + 2·8 nodes (the lower diagonal and the tables); per warp six
    solve planes of max(n_x, n_v) + 2·8 nodes, five x-rows of n_x + 2, three
    v-columns of n_v + 2 and the dump slots."""
    vplane = _r4(n_v + 2 * PAD_ROWS)
    plane = max(n_x, n_v) + 2 * PAD_ROWS
    per_warp = 6 * plane + 5 * (n_x + 2) + 3 * (n_v + 2)
    per_warp = _r4(per_warp) + DUMP_BYTES // 4
    return 4 * (4 * vplane + KWARPS * per_warp)


MAX_CLUSTER = 16  # CTAs of the largest cluster an H100 runs (non-portable above 8)
BAND_ROWS = 8  # a cluster's first plan: about this many variance rows a CTA


def _bands(n_v: int, n_x: int, ctas: int) -> tuple[int, int]:
    """(rows, columns) of a CTA's bands on a cluster of ``ctas``: the columns
    a multiple of 4, so that a band starts on 16 bytes."""
    return -(-n_v // ctas), -(-(-(-n_x // ctas)) // 4) * 4


def cluster_bytes(n_v: int, n_x: int, ctas: int) -> int:
    """Shared memory of one CTA of the cluster kernel (``ClusterLayout`` in
    ``csrc/heston_adi.cu``) on a cluster of ``ctas`` CTAs, a band of rows and
    of columns (a multiple of 4) each: V on its rows with a halo row each
    side ((rows + 2) × (ctas·cols + 4)), V, y1 and the exercise value on its
    columns (cols × (n_v + 2), cols × n_v twice), nine node-major x-sweep
    planes of n_x + 2·8 nodes × (rows | 1) (the stencil, the lower diagonal,
    the tables, the right-hand side and d'), the v-sweep's lower diagonal and
    tables (4 × (n_v + 2·8)) and stencil (3 × n_v), two v-sweep planes of
    n_v + 2·8 nodes × (cols | 1), the 16 CTAs' window addresses and the dump
    slots."""
    rows, cols = _bands(n_v, n_x, ctas)
    xplane = (n_x + 2 * PAD_ROWS) * (rows | 1)
    vplane = (n_v + 2 * PAD_ROWS) * (cols | 1)
    floats = ((rows + 2) * (ctas * cols + 4) + cols * (n_v + 2) + 2 * cols * n_v + 9 * xplane
              + 4 * (n_v + 2 * PAD_ROWS) + 3 * n_v + 2 * vplane + MAX_CLUSTER)
    return 4 * (-(-floats // 2) * 2 + DUMP_BYTES // 4)


def cluster_plan(n_v: int, n_x: int) -> int:
    """The forward kernel's route for an (n_v, n_x) grid, from its shape
    alone: the CTAs of the one thread-block cluster that holds it (about
    :data:`BAND_ROWS` rows a CTA, 2 to :data:`MAX_CLUSTER`, more where a
    CTA's bands do not fit in :data:`SMEM_LIMIT`; a band of at most 64 rows,
    two lanes each, and 128 columns, a lane each, on the CTA's four chain
    warps), or 0 where no cluster of 16 holds it: the cooperative kernel."""
    for ctas in range(min(MAX_CLUSTER, max(2, -(-n_v // BAND_ROWS))), MAX_CLUSTER + 1):
        rows, cols = _bands(n_v, n_x, ctas)
        if cluster_bytes(n_v, n_x, ctas) <= SMEM_LIMIT and rows <= 64 and cols <= 128:
            return ctas
    return 0


MAX_BAND = 128  # systems a phase of one CTA solves: a lane each on four chain warps
ROW_SUMS = 7  # sums a row of the reverse kernel keeps (csrc/heston_adi.cu kRowSums)


def adjoint_layout(n_v: int, n_x: int, blocks: int, cluster: bool) -> dict:
    """The planes of one CTA of the reverse kernel (``AdjointLayout`` in
    ``csrc/heston_adi.cu``) on ``blocks`` CTAs of the cluster route (two
    history buffers; the sweeps' forward halves apart from their solutions,
    so the check runs beside the back substitution) or of the cooperative
    route (one buffer; each solution over its forward half): {plane:
    (offset, floats)} in floats, each plane rounded up to 4 floats, and
    "rows", "cols", "recv" (the moves' span, which the cooperative route
    stages in global memory a block) and "floats"."""
    rows, cols = _bands(n_v, n_x, blocks)
    bufs = 2 if cluster else 1
    w, hx, vt = _r4(n_x + 2 * PAD_ROWS), _r4(n_x + 2), _r4(n_v + 2 * PAD_ROWS)
    xch = -(-n_x // 32)
    sizes = {"xlo": rows * w, "xden": rows * w, "xcs": rows * w, "xrcp": rows * w,
             "xd": rows * w if cluster else 0, "xlam1": rows * w, "vrow": bufs * (rows + 2) * hx, "y1row": bufs * rows * hx,
             "ga1": rows * hx, "racc": 6 * rows * n_x, "rsum": ROW_SUMS * rows,
             "rpart": ROW_SUMS * rows * xch, "vlo": vt, "vden": vt, "vcs": vt, "vrcp": vt,
             "vst": 4 * n_v, "pcol": bufs * cols * (n_v + 2), "icol": cols * n_v,
             "vrhs": vt * (cols | 1), "vd": vt * (cols | 1) if cluster else 0,
             "vds": vt * (cols | 1), "gedge": 2 * n_v,
             "cacc": 4 * cols * n_v, "first": max(rows, cols), "xlam2": rows * w, "rl": n_v * cols, "ga2": n_v * cols,
             "gn": n_v * (cols + 8), "peers": MAX_CLUSTER, "dump": DUMP_BYTES // 4}
    out, at = {}, 0
    for name, size in sizes.items():
        out[name] = (at, size)
        at += _r4(size)
    out.update(rows=rows, cols=cols, floats=at,
               recv=out["peers"][0] - out["xlam2"][0])
    return out


def adjoint_bytes(n_v: int, n_x: int, blocks: int, cluster: bool) -> int:
    """Shared memory of one CTA of the reverse kernel: :func:`adjoint_layout`'s
    floats. Its largest parts at 201 × 101 on 13 CTAs: the six node
    accumulators of the row band and the four of the column band, the
    x-sweeps' tables and the two history buffers."""
    return 4 * adjoint_layout(n_v, n_x, blocks, cluster)["floats"]


def adjoint_cluster_plan(n_v: int, n_x: int) -> int:
    """The reverse kernel's route for an (n_v, n_x) grid, from its shape
    alone: the CTAs of the one thread-block cluster whose bands, every
    accumulator and two history buffers fit in :data:`SMEM_LIMIT` a CTA
    (about :data:`BAND_ROWS` rows a CTA, 2 to :data:`MAX_CLUSTER`; at most
    :data:`MAX_BAND` rows and columns a band), or 0 where no cluster of 16
    holds them: the cooperative kernel, one block an SM."""
    for ctas in range(min(MAX_CLUSTER, max(2, -(-n_v // BAND_ROWS))), MAX_CLUSTER + 1):
        rows, cols = _bands(n_v, n_x, ctas)
        if adjoint_bytes(n_v, n_x, ctas, True) <= SMEM_LIMIT and max(rows, cols) <= MAX_BAND:
            return ctas
    return 0


def _f32_flat(t, dev, shape=None) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor on ``dev`` (a broadcast view is
    materialised), checked against ``shape``."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"the ADI kernels take float32 tensors on {dev}, got {t.dtype} on "
                         f"{t.device}")
    if shape is not None:
        t = t.expand(shape)
    return t.contiguous()


def _scalars(ops: AdiOps, slv: SlvLeverage | None, dev) -> torch.Tensor:
    """The kernel's scalars on the card: dt, 4·dx·dξ and, under SLV, ρσ,
    r − q, 2·dx, dx·dx and r/2, each computed by torch as ``x_operator``
    computes it."""
    vals = [ops.dt, ops.den]
    if slv is not None:
        vals += [slv.rs, slv.rate - slv.dividend, 2.0 * slv.dx, slv.dx * slv.dx, 0.5 * slv.rate]
    vals += [torch.zeros((), device=dev)] * (8 - len(vals))
    return torch.stack([_f32_flat(v.reshape(()), dev) for v in vals])


def _check_shapes(ops: AdiOps, start, slv, ctas: int = 0) -> tuple[int, int, int]:
    """(n_v, n_x, n_t); with ``ctas`` 0 raises where one CUDA block of the
    cooperative forward kernel cannot hold the grid (``ctas``: the blocks
    of the route that holds it)."""
    n_v, n_x = start.shape
    n_t = ops.bounds.shape[0]
    if n_v < 3 or n_x < 3 or n_t < 1 or ops.bounds.shape != (n_t, 2):
        raise ValueError(f"bad ADI shapes: grid {tuple(start.shape)}, bounds "
                         f"{tuple(ops.bounds.shape)}")
    if not ctas and smem_bytes(n_v, n_x) > SMEM_LIMIT:
        raise ValueError(f"a {n_v} x {n_x} grid needs {smem_bytes(n_v, n_x)} bytes of shared "
                         f"memory a CUDA block, more than the {SMEM_LIMIT} it has")
    if slv is None and (ops.x_stencil is None or ops.mixed is None):
        raise ValueError("the Heston loop needs its x-operator and mixed coefficient")
    return n_v, n_x, n_t


def _launch(fn_name: str, fields, tensors: dict, dims, dev) -> None:
    ptrs = np.array([tensors[f].data_ptr() if tensors.get(f) is not None else 0
                     for f in fields], dtype=np.int64)
    dims = np.asarray(dims, dtype=np.int32)
    lib = _build.load_library()
    err = getattr(lib, fn_name)(ptrs.ctypes.data, dims.ctypes.data, dev.index,
                                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} failed: {_build.error_string(err)} ({err})")


def _adi_cuda(ops: AdiOps, start, mode: int, spd: int = 1, slv: SlvLeverage | None = None,
              history: bool = False):
    """The forward kernel: one launch on PyTorch's current stream, no
    synchronize. Arguments and returns as :func:`_adi_plain`'s, every tensor
    float32 on one CUDA device. The route is :func:`cluster_plan`'s, from
    the grid's shape alone: one thread-block cluster, or the cooperative
    kernel where no cluster holds the grid. ``_adi_cuda.launches`` counts
    the launches."""
    dev = start.device
    if dev.type != "cuda":
        raise ValueError(f"_adi_cuda needs CUDA tensors, got the grid on {dev}")
    route = cluster_plan(*start.shape)
    n_v, n_x, n_t = _check_shapes(ops, start, slv, route)
    _check_mode(mode, spd, n_t, slv)
    grid = (n_v, n_x)
    t = {"start": _f32_flat(start, dev, grid), "intr": _f32_flat(ops.intrinsic, dev, grid),
         "bounds": _f32_flat(ops.bounds, dev), "scal": _scalars(ops, slv, dev)}
    for name, op in zip(("a2", "b2", "c2", "lo2", "di2", "up2"), (*ops.v_stencil, *ops.v_sweep)):
        t[name] = _f32_flat(op, dev, (1, n_v))
    if slv is None:
        for name, op in zip(("a1", "b1", "c1", "lo1", "di1", "up1"),
                            (*ops.x_stencil, *ops.x_sweep)):
            t[name] = _f32_flat(op, dev, grid)
        t["mc"] = _f32_flat(ops.mixed, dev, (n_v - 2, 1))
        t["xpiv"] = torch.empty((3, n_v, n_x), device=dev)  # the x-sweeps' tables
    else:
        t["lev"] = _f32_flat(slv.lev, dev)
        rows = torch.tensor(slv.rows, dtype=torch.int32)
        if rows.shape != (n_t,) or rows.min() < 0 or rows.max() >= slv.lev.shape[0]:
            raise ValueError(f"leverage rows {slv.rows} do not index {slv.lev.shape[0]} rows "
                             f"for {n_t} steps")
        t["rows"] = rows.to(dev)
        t["v"] = _f32_flat(slv.vj, dev, (n_v, 1))
        t["w"] = _f32_flat(slv.w, dev, (n_v - 2, 1))
        if t["lev"].shape[1:] != (n_x,):
            raise ValueError(f"leverage rows of {t['lev'].shape[1:]} nodes for {n_x} x-nodes")
    t["out"] = torch.empty(grid, device=dev)
    if mode == BERMUDAN:
        t["cont"] = torch.zeros((n_t // spd + 1, n_v, n_x), device=dev)
    t["vbuf"] = torch.empty((n_t if history else 2, n_v, n_x), device=dev)
    t["y1buf"] = torch.empty((n_t if history else 1, n_v, n_x), device=dev)
    if history:
        t["y2buf"] = torch.empty((n_t, n_v, n_x), device=dev)
    _launch("heston_adi_launch", _FWD_FIELDS, t,
            (n_v, n_x, n_t, mode, spd, int(slv is not None), int(history), route), dev)
    with _LAUNCH_LOCK:
        _adi_cuda.launches += 1
    hist = (t["vbuf"], t["y1buf"], t["y2buf"]) if history else None
    return t["out"], t.get("cont"), hist


_adi_cuda.launches = 0


def _dispatch(ops: AdiOps, start, mode: int, spd: int = 1, slv: SlvLeverage | None = None,
              history: bool = False):
    """The kernel for CUDA tensors, the plain loop for CPU tensors."""
    dev = start.device
    if dev.type == "cuda":
        return _adi_cuda(ops, start, mode, spd, slv, history)
    if dev.type == "cpu":
        return _adi_plain(ops, start, mode, spd, slv, history)
    raise ValueError(f"no ADI time loop for device {dev}")


def _down_up(v):
    """(v[r−1], v[r+1]) along the first axis of (n_v, n_x), zero beyond."""
    up, down = _neighbours(v.T)
    return up.T, down.T


def _adi_reverse_plain(ops: AdiOps, start, hist, g, american: bool):
    """The reverse recursion of the European/American loop by hand (not
    autograd), over the forward's history ``(vin, y1, vp)``: each step's
    input grid, x-sweep solution and new grid before the projection. ``g``
    is the gradient of the final grid. Returns the gradients of (a1, b1, c1,
    lower, diag, upper of the x-sweep, a2, b2, c2, lower, diag, upper of the
    v-sweep, mixed, dt, bounds, intrinsic, start), each of its input's
    shape."""
    a1, b1, c1 = ops.x_stencil
    lo1, di1, up1 = ops.x_sweep
    a2, b2, c2 = ops.v_stencil
    lo2, di2, up2 = ops.v_sweep
    mc, dt, den, intr = ops.mixed, ops.dt, ops.den, ops.intrinsic
    vin, y1h, vph = hist
    n_t, n_v, n_x = vin.shape
    td = THETA_S * dt
    # the adjoint systems: _TridiagSolve.backward's transposed diagonals
    lo1t, _ = _neighbours(up1)
    _, up1t = _neighbours(lo1)
    lo2t, _ = _neighbours(up2)
    _, up2t = _neighbours(lo2)
    zeros = torch.zeros_like(vin[0])
    g_x = [zeros.clone() for _ in range(6)]  # a1, b1, c1, lo1, di1, up1
    g_v = [torch.zeros(n_v, dtype=vin.dtype, device=vin.device) for _ in range(6)]
    g_mc = torch.zeros(n_v - 2, dtype=vin.dtype, device=vin.device)
    g_dts = g_td = torch.zeros((), dtype=vin.dtype, device=vin.device)
    g_b = torch.zeros(n_t, 2, dtype=vin.dtype, device=vin.device)
    g_i = zeros.clone()
    interior = torch.ones(n_x, dtype=torch.bool, device=vin.device)
    interior[0] = interior[-1] = False
    for k in reversed(range(n_t)):
        v, y1, vp = vin[k], y1h[k], vph[k]
        if american:
            split = torch.where(vp == intr, g / 2, g)
            g_i = g_i + split.masked_fill(vp > intr, 0.0)
            g = split.masked_fill(vp < intr, 0.0)
        # the pinned ends take the bounds' share; the v-sweep adjoint on the
        # interior columns: λ2 = T2⁻ᵀ g
        g_b[k, 0] += g[:, 0].sum()
        g_b[k, 1] += g[:, -1].sum()
        gy2 = torch.where(interior, g, 0.0)
        lam2 = _tridiag_plain(lo2t, di2, up2t, gy2.T).T
        vp_up, vp_down = _down_up(vp)
        for i, x in enumerate((vp_up, vp, vp_down)):
            g_v[3 + i] += (-lam2 * x).sum(1)
        a2v = tridiag_apply(a2, b2, c2, v.T).T
        g_td = g_td - (lam2 * a2v).sum()
        ga2p = -lam2 * td
        # the x-sweep adjoint: λ1 = T1⁻ᵀ λ2
        lam1 = _tridiag_plain(lo1t, di1, up1t, lam2)
        y1_left, y1_right = _neighbours(y1)
        for i, x in enumerate((y1_left, y1, y1_right)):
            g_x[3 + i] += -lam1 * x
        g_b[k, 0] += lam1[:, 0].sum()
        g_b[k, 1] += lam1[:, -1].sum()
        # the predictor
        gy0 = torch.where(interior, lam1, 0.0)
        core = (v[2:, 2:] - v[2:, :-2] - v[:-2, 2:] + v[:-2, :-2]) / den
        a1v = tridiag_apply(a1, b1, c1, v)
        s = F.pad(mc * core, (1, 1, 1, 1)) + a1v + a2v
        g_dts = g_dts + (gy0 * s).sum()
        g_td = g_td - (gy0 * a1v).sum()
        gs = dt * gy0
        ga1 = gs + -gy0 * td
        ga2 = gs + ga2p
        ga0 = gs[1:-1, 1:-1]
        v_left, v_right = _neighbours(v)
        for i, x in enumerate((v_left, v, v_right)):
            g_x[i] += ga1 * x
        v_up, v_down = _down_up(v)
        for i, x in enumerate((v_up, v, v_down)):
            g_v[i] += (ga2 * x).sum(1)
        g_mc += (ga0 * core).sum(1)
        gn = F.pad(ga0 * mc / den, (1, 1, 1, 1))
        # the grid's gradient: the predictor's identity, A1ᵀ, A2ᵀ and the
        # mixed stencil's transpose
        _, xr = _neighbours(a1 * ga1)
        xl, _ = _neighbours(c1 * ga1)
        rl = gy0 + ((b1 * ga1 + xr) + xl)
        _, vr = _down_up(a2.T * ga2)
        vl, _ = _down_up(c2.T * ga2)
        vt = (b2.T * ga2 + vr) + vl
        gn_pad = F.pad(gn, (1, 1, 1, 1))
        mt = (gn_pad[:-2, :-2] - gn_pad[:-2, 2:]) - gn_pad[2:, :-2] + gn_pad[2:, 2:]
        g = (rl + vt) + mt
    g_dt = g_dts + THETA_S * g_td
    return (*g_x[:3], *g_x[3:], *(x[None, :] for x in g_v), g_mc[:, None], g_dt, g_b, g_i, g)


def _adjoint_route(n_v: int, n_x: int, dev) -> tuple[int, int]:
    """(CTAs of the cluster or 0, blocks) of the reverse kernel: the cluster
    of :func:`adjoint_cluster_plan`, else one cooperative block an SM of the
    card; raises where the cooperative blocks' bands do not fit either."""
    ctas = adjoint_cluster_plan(n_v, n_x)
    if ctas:
        return ctas, ctas
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    layout = adjoint_layout(n_v, n_x, blocks, False)
    if 4 * layout["floats"] > SMEM_LIMIT or max(layout["rows"], layout["cols"]) > MAX_BAND:
        raise ValueError(f"no route of the reverse kernel holds a {n_v} x {n_x} grid: "
                         f"{4 * layout['floats']} bytes a block on {blocks} blocks")
    return 0, blocks


def _adjoint_operands(ops: AdiOps, start, hist, g, american: bool) -> tuple[dict, tuple]:
    """(tensors by field, dims) of one reverse launch on the route of
    :func:`_adjoint_route`: the operands as float32 on the card, the
    gradient slots zeroed, and on the cooperative route the staging buffer
    of the moves, zeroed."""
    dev = start.device
    if dev.type != "cuda":
        raise ValueError(f"_adi_adjoint_cuda needs CUDA tensors, got the grid on {dev}")
    ctas, blocks = _adjoint_route(*start.shape, dev)
    n_v, n_x, n_t = _check_shapes(ops, start, None, blocks)
    grid = (n_v, n_x)
    t = {"intr": _f32_flat(ops.intrinsic, dev, grid), "scal": _scalars(ops, None, dev),
         "gout": _f32_flat(g, dev, grid), "mc": _f32_flat(ops.mixed, dev, (n_v - 2, 1))}
    for name, op in zip(("a1", "b1", "c1", "lo1", "di1", "up1"), (*ops.x_stencil, *ops.x_sweep)):
        t[name] = _f32_flat(op, dev, grid)
    for name, op in zip(("a2", "b2", "c2", "lo2", "di2", "up2"), (*ops.v_stencil, *ops.v_sweep)):
        t[name] = _f32_flat(op, dev, (1, n_v))
    for name, h in zip(("vin", "y1h", "vph"), hist):
        t[name] = _f32_flat(h, dev, (n_t, n_v, n_x))
    n = n_v * n_x
    sizes = {"g_a1": n, "g_b1": n, "g_c1": n, "g_lo1": n, "g_di1": n, "g_up1": n,
             "p_a2": n_v, "p_b2": n_v, "p_c2": n_v, "p_lo2": n_x * n_v, "p_di2": n_x * n_v,
             "p_up2": n_x * n_v, "p_mc": n_v, "p_dts": n_v, "p_td1": n_v, "p_td2": n_v,
             "p_b1": n_t * n_v * 2, "p_bv": n_t * 2, "g_intr": n, "g_start": n}
    buf = torch.zeros(sum(sizes.values()), device=dev)
    at = 0
    for name, size in sizes.items():
        t[name] = buf[at:at + size]
        at += size
    if not ctas:  # the cooperative route's moves, a block each, moved 16 bytes at a time
        t["stage"] = torch.zeros(blocks * adjoint_layout(n_v, n_x, blocks, False)["recv"],
                                 device=dev)
    return t, (n_v, n_x, n_t, int(american), ctas, blocks)


def _adjoint_grads(t: dict, n_v: int, n_x: int, n_t: int) -> tuple:
    """The gradients of :func:`_adi_reverse_plain`'s order from a reverse
    launch's slots: the per-row, per-column and per-step slots summed."""
    grid = (n_v, n_x)
    g_dt = t["p_dts"].sum() + THETA_S * -(t["p_td1"].sum() + t["p_td2"].sum())
    g_b = t["p_b1"].view(n_t, n_v, 2).sum(1) + t["p_bv"].view(n_t, 2)
    return (*(t[k].view(grid) for k in ("g_a1", "g_b1", "g_c1", "g_lo1", "g_di1", "g_up1")),
            *(t[k][None, :] for k in ("p_a2", "p_b2", "p_c2")),
            *(t[k].view(n_x, n_v).sum(0, keepdim=True) for k in ("p_lo2", "p_di2", "p_up2")),
            t["p_mc"][1:-1, None], g_dt, g_b, t["g_intr"].view(grid), t["g_start"].view(grid))


def _adi_adjoint_cuda(ops: AdiOps, start, hist, g, american: bool):
    """The reverse kernel: one launch on PyTorch's current stream.
    Arguments and returns as :func:`_adi_reverse_plain`'s (the history as
    :func:`_adi_cuda` returns it). The route is :func:`_adjoint_route`'s,
    from the grid's shape (and, on the cooperative route, the card's SM
    count). ``_adi_adjoint_cuda.launches`` counts the launches."""
    t, dims = _adjoint_operands(ops, start, hist, g, american)
    _launch("heston_adi_adjoint_launch", _REV_FIELDS, t, dims, start.device)
    with _LAUNCH_LOCK:
        _adi_adjoint_cuda.launches += 1
    return _adjoint_grads(t, *dims[:3])


_adi_adjoint_cuda.launches = 0

# the Function's differentiable inputs after (mode, den), in order
_INPUTS = ("a1", "b1", "c1", "lo1", "di1", "up1", "a2", "b2", "c2", "lo2", "di2", "up2",
           "mixed", "dt", "bounds", "intrinsic", "start")


def _ops_of(den, xs) -> tuple[AdiOps, torch.Tensor]:
    return AdiOps(tuple(xs[0:3]), tuple(xs[3:6]), tuple(xs[6:9]), tuple(xs[9:12]), xs[12],
                  xs[13], den, xs[14], xs[15]), xs[16]


class _AdiLoop(torch.autograd.Function):
    """The European or American loop. Its forward is one launch of the
    forward kernel that keeps each step's grids; its backward is one launch
    of the reverse kernel (the plain reverse recursion on the CPU)."""

    @staticmethod
    def forward(ctx, mode, den, *xs):
        ops, start = _ops_of(den, xs)
        out, _, hist = _dispatch(ops, start, mode, history=True)
        ctx.mode = mode
        ctx.save_for_backward(den, *xs, *hist)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        den, xs, hist = saved[0], saved[1:1 + len(_INPUTS)], saved[1 + len(_INPUTS):]
        ops, start = _ops_of(den, xs)
        dev = start.device
        american = ctx.mode == AMERICAN
        if dev.type == "cuda":
            grads = _adi_adjoint_cuda(ops, start, hist, g, american)
        else:
            grads = _adi_reverse_plain(ops, start, hist, g, american)
        grads = [gr.reshape(x.shape) if need else None
                 for gr, x, need in zip(grads, xs, ctx.needs_input_grad[2:])]
        return (None, None, *grads)


def adi_loop(ops: AdiOps, start, american: bool) -> torch.Tensor:
    """The European or American Heston loop from ``start``: the (n_v, n_x)
    grid at t = 0. Differentiable in every operand of ``ops`` but ``den``
    (the frozen mesh) and in ``start``: where any of them needs a gradient,
    the loop is :class:`_AdiLoop`, whose backward is the reverse kernel."""
    mode = AMERICAN if american else EUROPEAN
    xs = (*ops.x_stencil, *ops.x_sweep, *ops.v_stencil, *ops.v_sweep, ops.mixed, ops.dt,
          ops.bounds, ops.intrinsic, start)
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _AdiLoop.apply(mode, ops.den.detach(), *xs)
    return _dispatch(ops, start, mode)[0]


def adi_bermudan(ops: AdiOps, start, spd: int, slv: SlvLeverage | None = None):
    """The Bermudan loop (projection at the end of each block of ``spd``
    steps but the last), under Heston or, with ``slv``, frozen leverage:
    returns (grid at t = 0, continuation slices (n_dates + 1, n_v, n_x)).
    Takes no gradient."""
    with torch.no_grad():
        out, cont, _ = _dispatch(ops, start, BERMUDAN, spd, slv)
    return out, cont
