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


# ---------------------------------------------------------------------------
# The warp-partitioned solve (csrc/warp_tridiag.cuh), modelled in torch
#
# One system of n unknowns split over the 32 lanes of a warp, m =
# warp_rows(n) rows a lane (lane p holds rows p·m … p·m + m − 1; rows from n
# on are padding, a = c = d = 0 and b = 1; a_0 and c_{n−1} are taken as 0).
# The factors depend on the matrix alone (warp_factors); a solve on them is
# the right-hand side's pass (warp_solve_rhs). Every operation is rounded on
# its own, in the order the kernel's note names, so on the card this model
# and the kernel agree bit for bit; a shuffle from past the warp's end gives
# the lane its own value, as __shfl_up_sync/__shfl_down_sync do. Tensors here
# are (B, 32) a row: entry [b, p] is row p·m + i of system b.
# ---------------------------------------------------------------------------

WARP_LANES = 32
PCR_STAGES = 5  # the reduced system's cyclic reduction: strides 1, 2, 4, 8, 16


def warp_rows(n: int) -> int:
    """Rows a lane of the warp-partitioned solve holds: ⌈n/32⌉, at least 2
    (a lane's first rows and its last, the separator, are distinct)."""
    return max(2, -(-n // WARP_LANES))


def warp_factor_values(m: int) -> int:
    """Values of one warp's factors in memory (``wtri::factor_values``):
    five row planes (ρ, ℓ, γ, α', γ') and 13 scalars (the separator's a and
    c, r_B, k1 and k2 a stage), 32 lanes each."""
    return (5 * m + 3 + 2 * PCR_STAGES) * WARP_LANES


def warp_capacity(n: int, itemsize: int) -> int:
    """Rows a lane keeps in registers in the kernels of the partitioned
    solve (``wtri::register_rows``): 8, or 16 in float32; 0 where a lane's
    rows do not fit and live in device memory."""
    m = warp_rows(n)
    return 8 if m <= 8 else 16 if itemsize == 4 and m <= 16 else 0


def _shfl_up(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.cat([x[:, :s], x[:, :-s]], 1)


def _shfl_down(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.cat([x[:, s:], x[:, -s:]], 1)


def _lane_rows(x: torch.Tensor, m: int, pad: float) -> list:
    """(B, n) → m tensors (B, 32): row i of every lane, the padding ``pad``."""
    batch, n = x.shape
    full = torch.cat([x, x.new_full((batch, WARP_LANES * m - n), pad)], 1)
    lanes = full.reshape(batch, WARP_LANES, m)
    return [lanes[:, :, i] for i in range(m)]


def _from_lane_rows(rows: list, n: int) -> torch.Tensor:
    """The inverse of :func:`_lane_rows`: (B, n)."""
    return torch.stack(rows, 2).reshape(rows[0].shape[0], -1)[:, :n]


def warp_factors(lower, diag, upper) -> dict:
    """The factors of the partitioned solve of (B, n) systems: the matrix's
    part of the work, formed once for every solve on the same matrix.

    A lane's first m − 1 rows are its interior, row m − 1 its separator.
    Forward over the interior (i = 0 … m − 2): piv = b_0, then b_i − a_i·γ_{i−1};
    ρ_i = 1/piv; ℓ_i = a_i·ρ_i; γ_i = c_i·ρ_i; α_0 = ℓ_0, then α_i = −(ℓ_i·α_{i−1}).
    Backward (i = m − 3 … 0): α'_i = α_i − γ_i·α'_{i+1}, γ'_i = −(γ_i·γ'_{i+1})
    (α'_{m−2} = α_{m−2}, γ'_{m−2} = γ_{m−2}): interior row i is then
    x_i = δ'_i − α'_i·y_{p−1} − γ'_i·y_p, y_p the separator of lane p. The
    separator rows form the reduced system A·y_{p−1} + B·y_p + C·y_{p+1} = D
    with A = −(a·α'_{m−2}), B = (b − a·γ'_{m−2}) − c·α'_0⁺, C = −(c·γ'_0⁺) (⁺:
    lane p + 1's), solved by cyclic reduction: at stride s, k1 = A/B⁻,
    k2 = C/B⁺ (⁻, ⁺: lanes p ∓ s), A ← −(A⁻·k1), B ← (B − C⁻·k1) − A⁺·k2,
    C ← −(C⁺·k2); then r_B = 1/B."""
    lower, diag, upper = torch.broadcast_tensors(lower, diag, upper)
    n = diag.shape[-1]
    m = warp_rows(n)
    lower = torch.cat([torch.zeros_like(lower[:, :1]), lower[:, 1:]], 1)
    upper = torch.cat([upper[:, :-1], torch.zeros_like(upper[:, :1])], 1)
    a, b, c = (_lane_rows(t, m, p) for t, p in ((lower, 0.0), (diag, 1.0), (upper, 0.0)))
    rho, ell, gam, alf = [], [], [], []
    for i in range(m - 1):
        piv = b[0] if i == 0 else b[i] - a[i] * gam[i - 1]
        r = torch.ones_like(piv) / piv
        rho.append(r)
        ell.append(a[i] * r)
        gam.append(c[i] * r)
        alf.append(ell[0] if i == 0 else -(ell[i] * alf[i - 1]))
    alf_f, gam_f = list(alf), list(gam)
    for i in range(m - 3, -1, -1):
        alf_f[i] = alf[i] - gam[i] * alf_f[i + 1]
        gam_f[i] = -(gam[i] * gam_f[i + 1])
    sa, sb, sc = a[m - 1], b[m - 1], c[m - 1]
    big_a = -(sa * alf_f[m - 2])
    big_b = (sb - sa * gam_f[m - 2]) - sc * _shfl_down(alf_f[0], 1)
    big_c = -(sc * _shfl_down(gam_f[0], 1))
    k1s, k2s = [], []
    for st in range(PCR_STAGES):
        s = 1 << st
        k1 = big_a / _shfl_up(big_b, s)
        k2 = big_c / _shfl_down(big_b, s)
        big_a, big_b, big_c = (-(_shfl_up(big_a, s) * k1),
                               (big_b - _shfl_up(big_c, s) * k1) - _shfl_down(big_a, s) * k2,
                               -(_shfl_down(big_c, s) * k2))
        k1s.append(k1)
        k2s.append(k2)
    return {"n": n, "m": m, "rho": rho, "ell": ell, "gam": gam, "alf_f": alf_f,
            "gam_f": gam_f, "sa": sa, "sc": sc, "k1": k1s, "k2": k2s,
            "rb": torch.ones_like(big_b) / big_b}


def warp_solve_rhs(f: dict, rhs) -> torch.Tensor:
    """The partitioned solve's pass on one right-hand side, (B, n), given
    the matrix's :func:`warp_factors`. Forward δ_0 = d_0·ρ_0, δ_i =
    d_i·ρ_i − ℓ_i·δ_{i−1}; backward δ'_i = δ_i − γ_i·δ'_{i+1}; the separator's
    D = (d_{m−1} − a·δ_{m−2}) − c·δ'_0⁺; at each stride D ← (D − D⁻·k1) − D⁺·k2;
    y = D·r_B; then x_i = (δ'_i − α'_i·y⁻) − γ'_i·y for the interior rows
    (y⁻: lane p − 1's separator) and x_{m−1} = y."""
    n, m = f["n"], f["m"]
    d = _lane_rows(rhs.expand(f["rb"].shape[0], n), m, 0.0)
    e = [None] * (m - 1)
    for i in range(m - 1):
        q = d[i] * f["rho"][i]
        e[i] = q if i == 0 else q - f["ell"][i] * e[i - 1]
    for i in range(m - 3, -1, -1):
        e[i] = e[i] - f["gam"][i] * e[i + 1]
    big_d = (d[m - 1] - f["sa"] * e[m - 2]) - f["sc"] * _shfl_down(e[0], 1)
    for st in range(PCR_STAGES):
        s = 1 << st
        big_d = (big_d - _shfl_up(big_d, s) * f["k1"][st]) - _shfl_down(big_d, s) * f["k2"][st]
    y = big_d * f["rb"]
    y_left = _shfl_up(y, 1)
    x = [(e[i] - f["alf_f"][i] * y_left) - f["gam_f"][i] * y for i in range(m - 1)] + [y]
    return _from_lane_rows(x, n)


def warp_solve(lower, diag, upper, rhs) -> torch.Tensor:
    """Solve T x = rhs, all (B, n), by the warp-partitioned solve: its
    factors (:func:`warp_factors`), then its right-hand side's pass. The
    matrices are diagonally dominant in every caller (the θ-scheme's
    I − θ·dt·L, Howard's identity rows, the local-vol steps), so no pivot is
    guarded or exchanged. No gradient."""
    return warp_solve_rhs(warp_factors(lower, diag, upper), rhs)


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
