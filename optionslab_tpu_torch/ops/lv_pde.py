"""The local-vol implicit time loop (``models/local_vol.py`` ``_lv_solve`` and
``models/local_vol_american.py`` ``lv_bermudan_slices``).

The reference runs each as one device program: a ``lax.scan`` over the
implicit steps (``optionslab_tpu/models/local_vol.py:197``) and nested scans
over the dates and their steps (``optionslab_tpu/models/
local_vol_american.py:85-125``). Its diagonals change every step (σ(S, t)
is read at each step's time), so each step forms its pivots again. Here
:func:`lv_loop` runs the loop in one launch of the CUDA kernel
``csrc/lv_pde.cu`` on CUDA tensors, and as the plain torch loop
(:func:`_lv_plain`, one solve a step by the kernel's warp-partitioned
solve, :func:`~.tridiag.warp_solve`) on CPU tensors; any other device
raises. The caller forms every step's diagonals and end values first as one
table (``models/local_vol.py`` ``_lv_tables``).

Each step sets the right-hand side's ends from the table, solves
``(lo_k, di_k, up_k)·v = rhs`` and then, by mode, keeps v (European),
clamps it to ψ (projection: the American PDE), or, at the end of every
block of ``spd`` steps but the last, records v as that date's continuation
slice and then clamps it (Bermudan). The loop takes no gradient.
"""

from __future__ import annotations

import torch

from . import _build
from .theta_pde import set_ends
from .tridiag import (_DTYPE_ID, _LAUNCH_LOCK, SMEM_LIMIT, WARP_LANES, check_operands,
                      warp_capacity, warp_factor_values, warp_rows, warp_solve)

EUROPEAN, PROJECTION, BERMUDAN = 0, 1, 2


def _check(lo, di, up, ends, psi, v, mode: int, spd: int) -> tuple[int, int, int]:
    """(B, n, n_time) of a loop's operands; raises on a bad shape or mode."""
    batch, n_time, n = lo.shape
    if n < 3 or batch < 1 or any(t.shape != lo.shape for t in (di, up)) \
            or ends.shape != (batch, n_time, 2) or psi.shape != (batch, n) \
            or v.shape != (batch, n) or mode not in (EUROPEAN, PROJECTION, BERMUDAN) \
            or spd < 1 or (mode == BERMUDAN and n_time % spd):
        raise ValueError(f"bad local-vol loop: tables {tuple(lo.shape)}, ends "
                         f"{tuple(ends.shape)}, ψ {tuple(psi.shape)}, v {tuple(v.shape)}, "
                         f"mode {mode}, {spd} steps a date")
    return batch, n, n_time


def _lv_plain(lo, di, up, ends, psi, v, mode: int, spd: int = 1):
    """The plain loop: (B, n_time, n) step diagonals ``lo``, ``di``, ``up``;
    (B, n_time, 2) end values ``ends``; (B, n) exercise value ``psi`` and
    initial ``v``. Returns (v, the Bermudan continuation slices (B,
    n_time/spd − 1, n) by date in the order of the loop, else None)."""
    _, _, n_time = _check(lo, di, up, ends, psi, v, mode, spd)
    conts = []
    for k in range(n_time):
        v = warp_solve(lo[:, k], di[:, k], up[:, k], set_ends(v, ends[:, k, 0], ends[:, k, 1]))
        if mode == PROJECTION:
            v = torch.maximum(v, psi)
        elif mode == BERMUDAN and (k + 1) % spd == 0 and k + 1 < n_time:
            conts.append(v)
            v = torch.maximum(v, psi)
    if mode != BERMUDAN:
        return v, None
    return v, torch.stack(conts, 1) if conts else v.new_zeros((v.shape[0], 0, v.shape[1]))


LV_WARPS = 8  # a CUDA block: the contract's solving warp, an idle warp, 6 producers
MAX_RING = 2 * (LV_WARPS - 2)  # slots of the factor ring
FLAG_BYTES = -(-(MAX_RING + 1) * 4 // 16) * 16  # the ring's flags


def lv_plan(n: int, itemsize: int) -> tuple[int, int, int]:
    """(ring slots, shared bytes a block, workspace values a contract) of the
    kernel. A slot holds one step's factors (:func:`~.tridiag.warp_factor_values`,
    planes of the register capacity's rows, or of m where the rows do not
    fit in registers) and its two end values. Where a lane's rows fit in
    registers (:func:`~.tridiag.warp_capacity`) the ring is in shared memory,
    as many slots as fit up to MAX_RING; else MAX_RING slots and the solving
    warp's v in a device-memory workspace. Depends on n and the dtype alone."""
    m = warp_rows(n)
    slot = warp_factor_values(warp_capacity(n, itemsize) or m) + 2
    if warp_capacity(n, itemsize):
        ring = min(MAX_RING, (SMEM_LIMIT - FLAG_BYTES) // (slot * itemsize))
        return ring, FLAG_BYTES + ring * slot * itemsize, 0
    return MAX_RING, FLAG_BYTES, MAX_RING * slot + WARP_LANES * m


def _lv_launch(lo, di, up, ends, psi, v, mode: int, spd: int = 1):
    """The kernel's operands made ready on the card: (launch, out, slices),
    ``launch()`` one launch of the kernel alone on PyTorch's current stream
    (what a CUDA graph of calls times), writing ``out`` (B, n) and, Bermudan,
    the slices (B, n_time/spd − 1, n); else ``slices`` is None."""
    ops = (lo, di, up, ends, psi, v)
    dev = check_operands("_lv_cuda", ops)
    batch, n, n_time = _check(*ops, mode, spd)
    ring, _, work_values = lv_plan(n, v.element_size())
    lo, di, up, ends, psi, v0 = (t.contiguous() for t in ops)
    out = torch.empty_like(v0)
    n_conts = n_time // spd - 1 if mode == BERMUDAN else 0
    conts = torch.empty((batch, max(n_conts, 0), n), dtype=v.dtype, device=dev)
    work = torch.empty((batch, work_values), dtype=v.dtype, device=dev) if work_values else None

    def launch():
        err = _build.load_library().lv_pde_launch(
            lo.data_ptr(), di.data_ptr(), up.data_ptr(), ends.data_ptr(), psi.data_ptr(),
            v0.data_ptr(), out.data_ptr(), conts.data_ptr() if n_conts > 0 else 0,
            0 if work is None else work.data_ptr(), batch, n, n_time, mode, spd, ring,
            _DTYPE_ID[v.dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"lv_pde_launch failed: {_build.error_string(err)} ({err})")
        with _LAUNCH_LOCK:
            _lv_cuda.launches += 1

    return launch, out, conts if mode == BERMUDAN else None


def _lv_cuda(lo, di, up, ends, psi, v, mode: int, spd: int = 1):
    """The kernel: one launch on PyTorch's current stream, no synchronize,
    one CUDA block a contract. Arguments and returns as :func:`_lv_plain`'s,
    on one CUDA device, of one dtype, float32 or float64. Any grid runs (the
    plan of :func:`lv_plan`). ``_lv_cuda.launches`` counts the launches."""
    launch, out, conts = _lv_launch(lo, di, up, ends, psi, v, mode, spd)
    launch()
    return out, conts


_lv_cuda.launches = 0


def lv_loop(lo, di, up, ends, psi, v, mode: int, spd: int = 1):
    """``lo.shape[1]`` implicit steps from ``v`` on per-step diagonals:
    returns (v, the Bermudan continuation slices or None), as
    :func:`_lv_plain`. ``mode``: :data:`EUROPEAN`, :data:`PROJECTION` or
    :data:`BERMUDAN` (``spd`` steps a date). Takes no gradient."""
    dev = v.device
    with torch.no_grad():
        if dev.type == "cuda":
            return _lv_cuda(lo, di, up, ends, psi, v, mode, spd)
        if dev.type == "cpu":
            return _lv_plain(lo, di, up, ends, psi, v, mode, spd)
    raise ValueError(f"no local-vol time loop for device {dev}")
