"""Batched tridiagonal solve (the Thomas algorithm).

The port of ``optionslab_tpu/ops/tridiag.py``, whose ``lax.scan`` XLA runs
as one loop on the device. Here a solve is one launch of the CUDA kernel
``csrc/tridiag.cu`` (two lanes a system, each system staged in shared
memory) on CUDA tensors, and the plain torch loop along the system axis on
CPU tensors: :func:`tridiag_solve` dispatches by device and never falls
back.

:func:`tridiag_solve` is a ``torch.autograd.Function``: its backward is the
adjoint solve Tᵀλ = g on the transposed diagonals (lowerᵀᵢ = upperᵢ₋₁,
upperᵀᵢ = lowerᵢ₊₁), one more solve through the same dispatch, and the
gradients are rhs ← λ, diagᵢ ← −λᵢxᵢ, lowerᵢ ← −λᵢxᵢ₋₁, upperᵢ ← −λᵢxᵢ₊₁,
each summed back to its input's broadcast shape. So a reverse pass through
a PDE costs one launch per solve, as the forward does; the adjoint solve is
the same Function, so higher derivatives take one launch a solve too.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import _build

_DTYPE_ID = {torch.float32: 0, torch.float64: 1}
_LAUNCH_LOCK = threading.Lock()  # the server solves from several threads
SMEM_LIMIT = 232_448  # bytes of shared memory a CUDA block can use on sm_90 (227 KB)
MAX_SYSTEMS = 16  # one warp a CUDA block, two lanes a system
PAD_ROWS = 8  # rows of padding at each end of a tile's planes (tri::kPad)
DUMP_BYTES = 256  # the lanes' dump slots at the end of a tile (tri::kDumpBytes)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_systems(batch: int, n_sms: int, tile_bytes) -> int:
    """Systems per CUDA block: the least power of two (at most
    :data:`MAX_SYSTEMS`) that puts ``batch`` systems in one wave of one block
    an SM, halved while its tile, ``tile_bytes(systems)``, exceeds
    :data:`SMEM_LIMIT`. Raises ``ValueError`` where one system alone does not
    fit: no other kernel takes over."""
    systems = 1
    while systems < MAX_SYSTEMS and systems * n_sms < batch:
        systems *= 2
    while tile_bytes(systems) > SMEM_LIMIT:
        if systems == 1:
            raise ValueError(f"a system needs {tile_bytes(1)} bytes of shared memory, more "
                             f"than the {SMEM_LIMIT} a CUDA block has")
        systems //= 2
    return systems


def check_operands(name: str, ops) -> torch.device:
    """The device of a kernel's operands: CUDA tensors on one device, of one
    dtype, float32 or float64 (the θ-scheme and local-vol loops); raises
    ``ValueError`` otherwise."""
    dev = ops[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ops):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{[t.device for t in ops]}")
    if ops[0].dtype not in _DTYPE_ID or any(t.dtype != ops[0].dtype for t in ops):
        raise ValueError(f"{name} takes float32 or float64 operands of one dtype, got "
                         f"{[t.dtype for t in ops]}")
    return dev


def tile_bytes(n: int, systems: int, broadcast, itemsize: int) -> int:
    """Shared memory of one block of the tridiagonal kernel (``Tile`` in
    ``csrc/tridiag.cu``): each operand n × pitch values (n for a broadcast
    row), c' and d' over the upper diagonal and the right-hand side where
    those hold a row a system, else n × pitch more each, every plane with
    PAD_ROWS rows of padding at both ends; then the lanes' dump slots."""
    pitch = systems | 1
    steps = [1 if b else pitch for b in broadcast]
    own = sum(step != pitch for step in steps[2:])
    return (n + 2 * PAD_ROWS) * (sum(steps) + own * pitch) * itemsize + DUMP_BYTES


def _tridiag_plain(lower, diag, upper, rhs) -> torch.Tensor:
    """The plain torch version: a loop along the system axis, vectorised over
    the leading axes."""
    lower, diag, upper, rhs = torch.broadcast_tensors(lower, diag, upper, rhs)
    n = diag.shape[-1]
    c_prev = torch.zeros_like(diag[..., 0])
    d_prev = c_prev
    cs, ds = [], []
    for i in range(n):
        a, b = lower[..., i], diag[..., i]
        denom = b - a * c_prev
        denom = torch.where(denom.abs() < 1e-30, torch.sign(denom) * 1e-30 + 1e-30, denom)
        c_prev = upper[..., i] / denom
        d_prev = (rhs[..., i] - a * d_prev) / denom
        cs.append(c_prev)
        ds.append(d_prev)
    x_next = torch.zeros_like(c_prev)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = ds[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


def _tridiag_cuda(lower, diag, upper, rhs) -> torch.Tensor:
    """The kernel: one launch on PyTorch's current stream, no synchronize.

    The four operands broadcast; each is read through its own strides (a
    broadcast or transposed operand is not copied; one whose leading axes do
    not collapse to one batch axis is). A system too long for one CUDA
    block's shared memory raises ``ValueError`` (:func:`plan_systems`).
    ``_tridiag_cuda.launches`` counts the launches."""
    dev = rhs.device
    if dev.type != "cuda" or any(t.device != dev for t in (lower, diag, upper)):
        raise ValueError(f"_tridiag_cuda needs CUDA tensors on one device, got "
                         f"{[t.device for t in (lower, diag, upper, rhs)]}")
    dtype = torch.promote_types(torch.promote_types(lower.dtype, diag.dtype),
                                torch.promote_types(upper.dtype, rhs.dtype))
    if dtype not in _DTYPE_ID:
        raise ValueError(f"the tridiagonal kernel takes float32 or float64, got {dtype}")
    ops = torch.broadcast_tensors(*(t.to(dtype) for t in (lower, diag, upper, rhs)))
    shape = ops[0].shape
    n = shape[-1]
    batch = int(np.prod(shape[:-1], dtype=np.int64))
    if n < 1 or batch < 1:
        return torch.empty(shape, dtype=dtype, device=dev)
    if batch >= 2**31:
        raise ValueError(f"batch of {batch} systems is too large for one launch")
    flat = [t.reshape(batch, n) for t in ops]
    x = torch.empty_like(flat[3])  # the rhs's layout where it is dense, else row-major
    broadcast = [t.stride(0) == 0 for t in flat]
    systems = plan_systems(batch, sm_count(dev.index),
                           lambda k: tile_bytes(n, k, broadcast, x.element_size()))
    strides = np.array([s for t in (*flat, x) for s in t.stride()], dtype=np.int64)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tridiag_solve_launch(
        *(t.data_ptr() for t in flat), x.data_ptr(), strides.ctypes.data, batch, n, systems,
        _DTYPE_ID[dtype], dev.index, stream)
    if err:
        raise RuntimeError(f"tridiag_solve_launch failed: {_build.error_string(err)} ({err})")
    with _LAUNCH_LOCK:
        _tridiag_cuda.launches += 1
    return x.reshape(shape)


_tridiag_cuda.launches = 0


def _solve(lower, diag, upper, rhs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = rhs.device
    if dev.type == "cuda":
        return _tridiag_cuda(lower, diag, upper, rhs)
    if dev.type == "cpu":
        return _tridiag_plain(lower, diag, upper, rhs)
    raise ValueError(f"no tridiagonal solve for device {dev}")


def _neighbours(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(v[i-1], v[i+1]) along the last axis, zero beyond the ends."""
    zero = torch.zeros_like(v[..., :1])
    return torch.cat([zero, v[..., :-1]], dim=-1), torch.cat([v[..., 1:], zero], dim=-1)


def tridiag_apply(lower, diag, upper, v) -> torch.Tensor:
    """T v for T with diagonals (lower, diag, upper) along the last axis,
    matrix-free: ``lower·v[i-1] + diag·v[i] + upper·v[i+1]``, v zero
    beyond its ends."""
    left, right = _neighbours(v)
    return lower * left + diag * v + upper * right


class _TridiagSolve(torch.autograd.Function):
    """The solve on four operands of one shape; its backward is itself on
    the transposed diagonals, so it differentiates again."""

    @staticmethod
    def forward(ctx, lower, diag, upper, rhs):
        x = _solve(lower, diag, upper, rhs)
        ctx.save_for_backward(lower, diag, upper, x)
        return x

    @staticmethod
    def backward(ctx, g):
        lower, diag, upper, x = ctx.saved_tensors
        upper_t, _ = _neighbours(upper)  # the transposed diagonals: upper[i-1], lower[i+1]
        _, lower_t = _neighbours(lower)
        lam = _TridiagSolve.apply(upper_t, diag, lower_t, g)
        x_left, x_right = _neighbours(x)
        return -lam * x_left, -lam * x, -lam * x_right, lam


def tridiag_solve(lower, diag, upper, rhs) -> torch.Tensor:
    """Solve T x = rhs where T has diagonals (lower, diag, upper).

    Shapes: all (..., n); ``lower[..., 0]`` and ``upper[..., n-1]`` are
    ignored. The leading axes batch by broadcasting. A pivot below 1e-30 in
    magnitude is replaced as in the reference (``sign·1e-30 + 1e-30``).
    Differentiable in all four operands, to any order, by the adjoint solve.
    """
    # broadcast views (no copy): the adjoint shifts each operand along the
    # system axis, which needs it at its full length there
    ops = torch.broadcast_tensors(*(torch.as_tensor(t) for t in (lower, diag, upper, rhs)))
    return _TridiagSolve.apply(*ops)
