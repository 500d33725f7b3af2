"""The θ-scheme time loop of the Crank–Nicolson book (``models/fdm.py``).

The reference runs the loop on the device: a ``lax.scan`` over the time
steps (``optionslab_tpu/models/fdm.py:162``) with Howard's policy sweeps in
a ``fori_loop`` (``:101``). Here :func:`theta_loop` runs it in one launch of
the CUDA kernel ``csrc/theta_pde.cu`` on CUDA tensors, and as the plain
torch loop (:func:`_theta_plain`, one batched tridiagonal solve a step or a
sweep) on CPU tensors; any other device raises.

Each step forms the explicit right-hand side ``v + w·(a·v₋ + b·v + c·v₊)``,
sets its ends from a table, and solves ``(lo, di, up)·v = rhs``: as it is
(European), clamped to ψ after the solve (projection), or as the obstacle
problem min(B·v − rhs, v − ψ) = 0 by Howard's policy iteration.

:func:`theta_loop` is a ``torch.autograd.Function``. Its forward is the one
launch (the plain loop on the CPU); its backward runs the plain loop again
on the same device under autograd (each solve then one launch of the
tridiagonal kernel and its adjoint) and returns the gradient of that graph,
as a ``jax.checkpoint`` of the whole loop would. The kernel's forward equals
the plain loop bit for bit, so the recomputed graph is the graph of the
value returned.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .tridiag import (DUMP_BYTES, PAD_ROWS, plan_systems, sm_count, tridiag_apply,
                      tridiag_solve)

EUROPEAN, PROJECTION, HOWARD = 0, 1, 2
HOWARD_SWEEPS = 8
_DTYPE_ID = {torch.float32: 0, torch.float64: 1}
_LAUNCH_LOCK = threading.Lock()  # the server prices from several threads


def set_ends(v, first, last):
    """``v`` with column 0 replaced by ``first`` and column -1 by ``last``."""
    return torch.cat([first[:, None], v[:, 1:-1], last[:, None]], dim=1)


def howard_lcp_solve(lo, di, up, rhs, psi, n_iter: int = HOWARD_SWEEPS):
    """Obstacle problem min(B·v − rhs, v − ψ) = 0 by policy (Howard)
    iteration: each sweep solves the tridiagonal system with the exercise
    rows replaced by v = ψ, then re-selects them from the complementarity
    residuals; the end rows stay Dirichlet. All (B, n)."""
    interior = torch.ones_like(rhs, dtype=torch.bool)
    interior[:, 0] = False
    interior[:, -1] = False
    m = torch.zeros_like(rhs, dtype=torch.bool)
    v = torch.maximum(rhs, psi)
    for _ in range(n_iter):
        v = tridiag_solve(torch.where(m, 0.0, lo), torch.where(m, 1.0, di),
                          torch.where(m, 0.0, up), torch.where(m, psi, rhs))
        m = ((tridiag_apply(lo, di, up, v) - rhs) > (v - psi)) & interior
    return torch.maximum(v, psi)


def _theta_plain(lo, di, up, a, b, c, w, psi, v, ends, mode: int):
    """The plain loop: (B, n) diagonals ``lo``, ``di``, ``up`` of the
    implicit side, ψ and the initial ``v``; (B, 1) explicit operator ``a``,
    ``b``, ``c`` and weight ``w``; (B, n_time, 2) end values ``ends``."""
    for k in range(ends.shape[1]):
        rhs = v + w * (a * torch.roll(v, 1, dims=1) + b * v + c * torch.roll(v, -1, dims=1))
        rhs = set_ends(rhs, ends[:, k, 0], ends[:, k, 1])
        if mode == HOWARD:
            v = howard_lcp_solve(lo, di, up, rhs, psi)
        else:
            v = tridiag_solve(lo, di, up, rhs)
            if mode == PROJECTION:
                v = torch.maximum(v, psi)
    return v


def tile_bytes(n: int, systems: int, itemsize: int) -> int:
    """Shared memory of one block of the kernel (``ThetaTile`` in
    ``csrc/theta_pde.cu``): twelve n × pitch planes (the implicit side's
    three diagonals, the right-hand side, v, ψ, the working c', d' and
    pivots, and the unexercised matrix's tables: den, c' and RN(1/den)), the
    contracts' four coefficients and one byte a node for the exercise set,
    every plane with PAD_ROWS rows of padding at both ends; then (8-byte
    aligned) each contract's first changed row, an int; then the lanes' dump
    slots."""
    plane = (n + 2 * PAD_ROWS) * (systems | 1)
    planes = -(-((12 * plane + 4 * systems) * itemsize + plane) // 8) * 8
    return planes + -(-4 * systems // 8) * 8 + DUMP_BYTES


def _theta_cuda(lo, di, up, a, b, c, w, psi, v, ends, mode: int, count_solves: bool = False):
    """The kernel: one launch on PyTorch's current stream, no synchronize.
    Arguments as :func:`_theta_plain`'s, on one CUDA device, of one dtype,
    float32 or float64. With ``count_solves``, returns (values, solves,
    pivots): int32 counts a CUDA block of the solves each of its contracts
    ran (Howard stops sweeping a step at its fixed point) and of the pivot
    nodes its chains formed (the tables' n, then for each later Howard sweep
    the rows from its restart on). A grid too long for one CUDA block's
    shared memory raises ``ValueError``.
    ``_theta_cuda.launches`` counts the launches."""
    ops = (lo, di, up, a, b, c, w, psi, v, ends)
    dev = v.device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError(f"_theta_cuda needs CUDA tensors on one device, got "
                         f"{[t.device for t in ops]}")
    if v.dtype not in _DTYPE_ID or any(t.dtype != v.dtype for t in ops):
        raise ValueError(f"the θ-scheme kernel takes float32 or float64 operands of one "
                         f"dtype, got {[t.dtype for t in ops]}")
    batch, n = v.shape
    n_time = ends.shape[1]
    if n < 3 or batch < 1 or ends.shape != (batch, n_time, 2) or mode not in (0, 1, 2):
        raise ValueError(f"bad θ-scheme shapes or mode: v {tuple(v.shape)}, ends "
                         f"{tuple(ends.shape)}, mode {mode}")
    grid = [t.expand(batch, n).contiguous() for t in (lo, di, up, psi, v)]
    coef = torch.stack([t.reshape(-1).expand(batch) for t in (a, b, c, w)])
    ends = ends.contiguous()
    systems = plan_systems(batch, sm_count(dev.index),
                           lambda k: tile_bytes(n, k, v.element_size()))
    counts = torch.empty((2, -(-batch // systems)), dtype=torch.int32, device=dev)
    out = torch.empty_like(grid[4])
    err = _build.load_library().theta_pde_launch(
        grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(), coef.data_ptr(),
        grid[3].data_ptr(), grid[4].data_ptr(), ends.data_ptr(), out.data_ptr(),
        counts.data_ptr(), batch, n, n_time, mode, systems, _DTYPE_ID[v.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"theta_pde_launch failed: {_build.error_string(err)} ({err})")
    with _LAUNCH_LOCK:
        _theta_cuda.launches += 1
    return (out, counts[0], counts[1]) if count_solves else out


_theta_cuda.launches = 0


class _ThetaLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mode, *ops):
        ctx.mode = mode
        ctx.save_for_backward(*ops)
        dev = ops[-2].device
        if dev.type == "cuda":
            return _theta_cuda(*ops, mode)
        if dev.type == "cpu":
            return _theta_plain(*ops, mode)
        raise ValueError(f"no θ-scheme time loop for device {dev}")

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            # a view of each input that needs a gradient: distinct nodes, so
            # an input passed twice (ψ and the initial v) gets each part once,
            # and the graph stays attached for a higher derivative
            xs = [t.view_as(t) if need else t.detach()
                  for t, need in zip(ctx.saved_tensors, needs)]
            out = _theta_plain(*xs, ctx.mode)
        want = [x for x, need in zip(xs, needs) if need]
        grads = iter(torch.autograd.grad(out, want, g, create_graph=torch.is_grad_enabled(),
                                         allow_unused=True))
        return (None,) + tuple(next(grads) if need else None for need in needs)


def theta_loop(lo, di, up, a, b, c, w, psi, v, ends, mode: int) -> torch.Tensor:
    """``ends.shape[1]`` θ-scheme steps from ``v``; returns the (B, n) values.

    ``lo``, ``di``, ``up``: (B, n) diagonals of ``I − θ·dt·L`` with Dirichlet
    end rows; ``a``, ``b``, ``c``: (B, 1) the operator ``L``'s neighbour
    weights; ``w``: (B, 1) the explicit weight ``(1 − θ)·dt``; ``psi``: (B, n)
    the exercise value; ``ends``: (B, n_time, 2) the right-hand side's first
    and last value at each step; ``mode``: :data:`EUROPEAN`,
    :data:`PROJECTION` or :data:`HOWARD`. Differentiable in every tensor.
    """
    return _ThetaLoop.apply(mode, lo, di, up, a, b, c, w, psi, v, ends)
