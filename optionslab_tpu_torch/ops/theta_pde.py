"""The θ-scheme time loop of the Crank–Nicolson book (``models/fdm.py``) and
of the cash-dividend PDE (``models/dividends.py``), forward and reverse.

The reference runs the loop on the device: a ``lax.scan`` over the time
steps (``optionslab_tpu/models/fdm.py:162``, ``optionslab_tpu/models/
dividends.py:137``) with Howard's policy sweeps in a ``fori_loop``
(``fdm.py:101``), and ``jax.grad`` runs its reverse mode. Here
:func:`theta_loop` runs it in one launch of the CUDA kernel
``csrc/theta_pde.cu`` on CUDA tensors, and as the plain torch loop
(:func:`_theta_plain`, one batched tridiagonal solve a step or a sweep) on
CPU tensors; any other device raises. A loop with a jump table (the
dividend PDE) is its own kernel, ``theta_jump_kernel``: one warp a
contract, each solve split over the warp's lanes (``csrc/warp_tridiag.cuh``),
and its plain loop solves by that partition's model
(:func:`~.tridiag.warp_solve`), not by Thomas.

Each step forms the explicit right-hand side ``v + w·(a·v₋ + b·v + c·v₊)``,
sets its ends from a table, and solves ``(lo, di, up)·v = rhs``: as it is
(European), clamped to ψ after the solve (projection), or as the obstacle
problem min(B·v − rhs, v − ψ) = 0 by Howard's policy iteration. A jump
table (:class:`Jumps`) then replaces v at a few steps by its linear
interpolation at shifted nodes (a cash dividend's drop), clamped to ψ again
in the American modes.

:func:`theta_loop` is a ``torch.autograd.Function`` where a gradient is
needed. Its forward is the one launch, which then keeps each step's
solution and, for Howard, the exercise set of the step's last solve (on the
CPU the plain loop's ``history``). Its first-order backward is one launch of
the reverse kernel ``theta_pde_adjoint_kernel`` (on the CPU
:func:`_theta_reverse_plain`, the same recursion written out step by step).
Asked for a graph of the gradient (``create_graph=True``, a second
derivative), the backward runs the plain loop again under autograd and
differentiates that, as a ``jax.checkpoint`` of the whole loop would; the
kernel's forward equals the plain loop bit for bit, so that graph is the
graph of the value returned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .tridiag import (_DTYPE_ID, _LAUNCH_LOCK, DUMP_BYTES, PAD_ROWS, SMEM_LIMIT, WARP_LANES,
                      _neighbours, _solve, check_operands, plan_systems, sm_count, tridiag_apply,
                      tridiag_solve, warp_capacity, warp_factor_values, warp_factors, warp_rows,
                      warp_solve, warp_solve_rhs)

EUROPEAN, PROJECTION, HOWARD = 0, 1, 2
HOWARD_SWEEPS = 8


class Jumps(NamedTuple):
    """A jump table: after step ``steps[i]`` (its solve and clamp), node j of
    contract b takes ``f0 + weight·(f1 − f0)`` with f0 = v[code], f1 =
    v[code + 1] for ``code = index[b, i, j] ≥ 0``, and v[−1 − code] for a
    negative code. ``index``: (B, J, n) int32; ``weight``: (B, J, n) of v's
    dtype."""
    steps: tuple
    index: torch.Tensor
    weight: torch.Tensor


def set_ends(v, first, last):
    """``v`` with column 0 replaced by ``first`` and column -1 by ``last``."""
    return torch.cat([first[:, None], v[:, 1:-1], last[:, None]], dim=1)


def _howard(lo, di, up, rhs, psi, solve=tridiag_solve, tables=None):
    """The obstacle problem min(B·v − rhs, v − ψ) = 0 by policy (Howard)
    iteration: each of HOWARD_SWEEPS sweeps solves the tridiagonal system
    with the exercise rows replaced by v = ψ (by ``solve``), then re-selects
    them from the complementarity residuals; the end rows stay Dirichlet.
    All (B, n). Returns (the last sweep's solution before the clamp to ψ, the
    exercise set that sweep solved with): where the sweeps stop short of
    their fixed point, the set its residuals then pick is another.
    ``tables``: the unexercised matrix's :func:`~.tridiag.warp_factors`, on
    which the first sweep solves; the sweeps then stop at their fixed point,
    as the jump-table kernel does (each later sweep would solve the same
    system again: the values are the 8 sweeps')."""
    interior = torch.ones_like(rhs, dtype=torch.bool)
    interior[:, 0] = False
    interior[:, -1] = False
    m = torch.zeros_like(rhs, dtype=torch.bool)
    for sweep in range(HOWARD_SWEEPS):
        used = m
        if sweep == 0 and tables is not None:
            v = warp_solve_rhs(tables, rhs)
        else:
            v = solve(torch.where(m, 0.0, lo), torch.where(m, 1.0, di),
                      torch.where(m, 0.0, up), torch.where(m, psi, rhs))
        m = ((tridiag_apply(lo, di, up, v) - rhs) > (v - psi)) & interior
        if tables is not None and torch.equal(m, used):
            break
    return v, used


def apply_jump(v, index, weight):
    """One jump of a :class:`Jumps` table on (B, n) values: ``index`` and
    ``weight`` (B, n)."""
    code = index.long()
    left = code.clamp_min(0)
    f0 = v.gather(1, left)
    f1 = v.gather(1, (left + 1).clamp_max(v.shape[1] - 1))
    return torch.where(code >= 0, f0 + weight * (f1 - f0), v.gather(1, (-1 - code).clamp_min(0)))


def _theta_plain(lo, di, up, a, b, c, w, psi, v, ends, mode: int, jumps: Jumps | None = None,
                 history: bool = False):
    """The plain loop: (B, n) diagonals ``lo``, ``di``, ``up`` of the
    implicit side, ψ and the initial ``v``; (B, 1) explicit operator ``a``,
    ``b``, ``c`` and weight ``w``; (B, n_time, 2) end values ``ends``.
    With ``history`` returns (v, each step's solution before the clamp
    (B, n_time, n), and for Howard the exercise set of each step's last
    solve (B, n_time, n) bool, else None). With a jump table every solve is
    the warp-partitioned one (:func:`~.tridiag.warp_solve`, the jump-table
    kernel's), the unexercised matrix's factors formed once; without, the
    Thomas solve (``fdm_price``'s)."""
    jump_at = {} if jumps is None else {k: i for i, k in enumerate(jumps.steps)}
    tables = None
    if jumps is not None:
        tables = warp_factors(*torch.broadcast_tensors(lo, di, up, v)[:3])
    sols, sets = [], []
    for k in range(ends.shape[1]):
        rhs = v + w * (a * torch.roll(v, 1, dims=1) + b * v + c * torch.roll(v, -1, dims=1))
        rhs = set_ends(rhs, ends[:, k, 0], ends[:, k, 1])
        if mode == HOWARD:
            u, m = _howard(lo, di, up, rhs, psi) if tables is None \
                else _howard(lo, di, up, rhs, psi, warp_solve, tables)
            v = torch.maximum(u, psi)
        else:
            u = tridiag_solve(lo, di, up, rhs) if tables is None else warp_solve_rhs(tables, rhs)
            m = None
            v = torch.maximum(u, psi) if mode == PROJECTION else u
        if history:
            sols.append(u)
            sets.append(m)
        i = jump_at.get(k)
        if i is not None:
            v = apply_jump(v, jumps.index[:, i], jumps.weight[:, i])
            if mode != EUROPEAN:
                v = torch.maximum(v, psi)
    if not history:
        return v
    if not sols:
        empty = v.new_empty((v.shape[0], 0, v.shape[1]))
        return v, empty, empty.bool() if mode == HOWARD else None
    return v, torch.stack(sols, 1), torch.stack(sets, 1) if mode == HOWARD else None


def _theta_reverse_plain(lo, di, up, a, b, c, w, psi, v0, ends, mode: int, hist_u, hist_m, g):
    """The reverse of the loop by hand (not autograd), step by step from the
    last, over the forward's history (``hist_u``: each step's solution before
    the clamp; ``hist_m``: Howard's exercise set of each step's last solve).
    ``g`` is the gradient of the values returned. Each step: the clamp's
    adjoint (a tie splits half and half, as ``torch.maximum``'s derivative
    does); the adjoint solve on the transposed diagonals of the step's
    matrix (Howard's exercised rows replaced by v = ψ: their λ goes to ψ);
    the right-hand side's adjoint (its ends to ``ends``, its interior to the
    step's input v and to a, b, c and w). Returns the gradients of (lo, di,
    up, a, b, c, w, ψ, v0, ends), each of its operand's broadcast shape
    ((B, n), (B, 1) or (B, n_time, 2))."""
    batch, n_time, n = hist_u.shape
    lo, di, up, psi, v0 = (t.expand(batch, n) for t in (lo, di, up, psi, v0))
    a, b, c, w = (t.expand(batch, 1) for t in (a, b, c, w))
    grid = [torch.zeros_like(v0) for _ in range(4)]  # lo, di, up, ψ
    coef = [torch.zeros_like(a) for _ in range(4)]  # a, b, c, w
    g_ends = torch.zeros((batch, n_time, 2), dtype=v0.dtype, device=v0.device)
    edge = torch.zeros_like(v0, dtype=torch.bool)
    edge[:, 0] = edge[:, -1] = True
    ex = torch.zeros_like(edge)
    lo_m, di_m, up_m = lo, di, up
    g = g.expand(batch, n)
    for k in reversed(range(n_time)):
        u = hist_u[:, k]
        vin = v0 if k == 0 else hist_u[:, k - 1]
        if mode != EUROPEAN:
            if k:
                vin = torch.maximum(vin, psi)
            split = torch.where(u == psi, g / 2, g)
            grid[3] = grid[3] + split.masked_fill(u > psi, 0.0)
            g = split.masked_fill(u < psi, 0.0)
        if mode == HOWARD:
            ex = hist_m[:, k]
            lo_m, di_m, up_m = (torch.where(ex, 0.0, lo), torch.where(ex, 1.0, di),
                                torch.where(ex, 0.0, up))
        lo_t, _ = _neighbours(up_m)  # the transposed diagonals: upper[i-1], lower[i+1]
        _, up_t = _neighbours(lo_m)
        lam = _solve(lo_t, di_m, up_t, g)
        grid[3] = grid[3] + torch.where(ex, lam, 0.0)
        lam = torch.where(ex, 0.0, lam)
        u_left, u_right = _neighbours(u)
        for i, x in enumerate((u_left, u, u_right)):
            grid[i] = grid[i] - lam * x
        g_ends[:, k, 0] = lam[:, 0]
        g_ends[:, k, 1] = lam[:, -1]
        gi = torch.where(edge, 0.0, lam)
        v_left, v_right = _neighbours(vin)
        coef[3] = coef[3] + (gi * (a * v_left + b * vin + c * v_right)).sum(1, keepdim=True)
        gw = w * gi
        for i, x in enumerate((v_left, vin, v_right)):
            coef[i] = coef[i] + (gw * x).sum(1, keepdim=True)
        _, right = _neighbours(a * gw)
        left, _ = _neighbours(c * gw)
        g = gi + b * gw + right + left
    return (*grid[:3], *coef, grid[3], g, g_ends)


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


ADJOINT_PLANES = 10  # the diagonals, ψ, the gradient, λ's share, four accumulators
ADJOINT_TABLE_PLANES = 9  # the shared route's tables and history rows
ADJOINT_WORK_ROWS = 7  # the device route's workspace rows a contract
ADJOINT_THREADS = 128  # a CUDA block of the reverse: each thread's four shares in the tile


def _round8(nbytes: int) -> int:
    return -(-nbytes // 8) * 8


def adjoint_row(n: int, itemsize: int) -> int:
    """Values in a contract's row of a plane of the reverse kernel's tile:
    n rounded up to an odd number of 16-byte units (16-byte vector loads,
    and lanes on several contracts' rows in different banks)."""
    per16 = 16 // itemsize
    return (-(-n // per16) | 1) * per16


def adjoint_tile_bytes(n: int, systems: int, itemsize: int, device_tables: bool = False) -> int:
    """Shared memory of one block of the reverse kernel (``AdjointTile`` in
    ``csrc/theta_pde.cu``): ADJOINT_PLANES planes of a row of
    :func:`adjoint_row` values a contract (the three diagonals, ψ, the
    gradient, the right-hand side's share of λ, and the accumulators of lo,
    di, up and ψ), on the shared
    route ADJOINT_TABLE_PLANES more (the LU and UL factorizations' tables,
    three history rows), the contracts' four coefficients and each thread's
    shares of a, b, c and w; then (8-byte aligned) each contract's count of
    runs and its runs (two ints each, at most ⌈n / 2⌉); on the shared route
    two exercise-set rows a contract of 4 · ⌊(n + 6) / 4⌋ bytes.
    ``device_tables``: the device route, whose tables and history stay in
    device memory."""
    planes = ADJOINT_PLANES + (0 if device_tables else ADJOINT_TABLE_PLANES)
    values = planes * systems * adjoint_row(n, itemsize) + 4 * systems + 4 * ADJOINT_THREADS
    runs = _round8(values * itemsize)
    masks = runs + _round8(4 * systems) + 8 * systems * ((n + 1) // 2)
    sets = 0 if device_tables else 2 * systems * ((n + 6) // 4 * 4)
    return _round8(masks + sets)


def adjoint_plan(batch: int, n: int, itemsize: int, n_sms: int) -> tuple[int, bool]:
    """(contracts a CUDA block, device route) of the reverse kernel: the
    shared route wherever one contract's tile fits in a block's shared
    memory (:func:`plan_systems` on its tile), else the device route, whose
    tile holds every grid the forward takes."""
    device = adjoint_tile_bytes(n, 1, itemsize) > SMEM_LIMIT
    return plan_systems(batch, n_sms, lambda k: adjoint_tile_bytes(n, k, itemsize, device)), device


def _grid_operands(lo, di, up, a, b, c, w, psi, v, batch, n):
    grid = [t.expand(batch, n).contiguous() for t in (lo, di, up, psi, v)]
    coef = torch.stack([t.reshape(-1).expand(batch) for t in (a, b, c, w)]).contiguous()
    return grid, coef


def _check_loop(name: str, ops, mode: int) -> tuple[torch.device, int, int, int]:
    """(device, B, n, n_time) of a loop kernel's operands (``ops`` as
    :func:`_theta_plain`'s); raises on a bad shape, mode, device or dtype."""
    dev = check_operands(name, ops)
    v, ends = ops[-2], ops[-1]
    batch, n = v.shape
    n_time = ends.shape[1]
    if n < 3 or batch < 1 or ends.shape != (batch, n_time, 2) or mode not in (0, 1, 2):
        raise ValueError(f"bad θ-scheme shapes or mode: v {tuple(v.shape)}, ends "
                         f"{tuple(ends.shape)}, mode {mode}")
    return dev, batch, n, n_time


def _theta_cuda(lo, di, up, a, b, c, w, psi, v, ends, mode: int, count_solves: bool = False,
                history: bool = False):
    """The kernel: one launch on PyTorch's current stream, no synchronize.
    Arguments as :func:`_theta_plain`'s (no jump table), on one CUDA device,
    of one dtype, float32 or float64. Returns the values; with ``history``
    also the step's solutions and exercise sets of :func:`_theta_plain`'s
    history (the sets as bool, one byte a node); with ``count_solves`` also
    (solves, pivots): int32 counts a CUDA block of the solves each of its
    contracts ran (Howard stops sweeping a step at its fixed point) and of
    the pivot nodes its chains formed (the tables' n, then for each later
    Howard sweep the rows from its restart on). A grid too long for one CUDA
    block's shared memory raises ``ValueError``.
    ``_theta_cuda.launches`` counts the launches."""
    dev, batch, n, n_time = _check_loop("_theta_cuda", (lo, di, up, a, b, c, w, psi, v, ends),
                                        mode)
    grid, coef = _grid_operands(lo, di, up, a, b, c, w, psi, v, batch, n)
    ends = ends.contiguous()
    systems = plan_systems(batch, sm_count(dev.index),
                           lambda k: tile_bytes(n, k, v.element_size()))
    counts = torch.empty((2, -(-batch // systems)), dtype=torch.int32, device=dev)
    out = torch.empty_like(grid[4])
    hist_u = hist_m = None
    if history:
        hist_u = torch.empty((batch, n_time, n), dtype=v.dtype, device=dev)
        hist_m = torch.empty(hist_u.shape, dtype=torch.bool, device=dev) if mode == HOWARD \
            else None
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = _build.load_library().theta_pde_launch(
        grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(), coef.data_ptr(),
        grid[3].data_ptr(), grid[4].data_ptr(), ends.data_ptr(), out.data_ptr(),
        counts.data_ptr(), ptr(hist_u), ptr(hist_m), batch, n, n_time, mode, systems,
        _DTYPE_ID[v.dtype], dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"theta_pde_launch failed: {_build.error_string(err)} ({err})")
    with _LAUNCH_LOCK:
        _theta_cuda.launches += 1
    result = (out,) + ((hist_u, hist_m) if history else ()) \
        + ((counts[0], counts[1]) if count_solves else ())
    return result if len(result) > 1 else out


_theta_cuda.launches = 0

JUMP_WARPS = 4  # contracts a CUDA block of the jump-table kernel, a warp each


def jump_area(n: int, itemsize: int) -> int:
    """Values of one contract's area of the jump-table kernel (``jump_area``
    in ``csrc/theta_pde.cu``), its planes of 32 lanes × the register capacity
    (:func:`~.tridiag.warp_capacity`) or, where the rows are in device
    memory, × m rows: the unexercised a, b, c and the jump's gather row,
    Howard's working factors; in device memory four planes more (v, the
    right-hand side, ψ, the exercise set) and the tables' factors."""
    registers = warp_capacity(n, itemsize)
    rows = registers or warp_rows(n)
    return (4 if registers else 8) * WARP_LANES * rows \
        + (1 if registers else 2) * warp_factor_values(rows)


def jump_plan(batch: int, n: int, itemsize: int) -> tuple[int, int, int]:
    """(contracts a CUDA block, shared bytes a block, workspace values a
    contract) of the jump-table kernel: a warp a contract, up to JUMP_WARPS
    to a block; each warp's area in shared memory where a lane's rows fit in
    registers (:func:`~.tridiag.warp_capacity`), else in a device-memory
    workspace. Depends on n and the dtype alone, never on the card."""
    warps = min(JUMP_WARPS, batch)
    if warp_capacity(n, itemsize):
        return warps, warps * jump_area(n, itemsize) * itemsize, 0
    return warps, 0, jump_area(n, itemsize)


def _jump_launch(lo, di, up, a, b, c, w, psi, v, ends, mode: int, jumps: Jumps):
    """The jump-table kernel's operands made ready on the card: (launch, out,
    counts), ``launch()`` one launch of the kernel alone on PyTorch's current
    stream (what a CUDA graph of calls times), writing ``out`` (B, n) and
    ``counts`` (2, B) int32: the solves each contract ran, then the rows whose
    factors its later Howard sweeps re-formed."""
    dev, batch, n, n_time = _check_loop("_theta_jumps_cuda",
                                        (lo, di, up, a, b, c, w, psi, v, ends), mode)
    grid, coef = _grid_operands(lo, di, up, a, b, c, w, psi, v, batch, n)
    ends = ends.contiguous()
    jump_at = index = weight = None
    n_jumps = len(jumps.steps)
    if n_jumps:
        if jumps.index.shape != (batch, n_jumps, n) or jumps.weight.shape != (batch, n_jumps, n):
            raise ValueError(f"bad jump table: index {tuple(jumps.index.shape)}, weight "
                             f"{tuple(jumps.weight.shape)} for {n_jumps} steps")
        jump_at = torch.full((n_time,), -1, dtype=torch.int32, device=dev)
        for i, k in enumerate(jumps.steps):  # fills on the card: no copy from the host
            jump_at[k] = i
        index = jumps.index.to(dev, torch.int32).contiguous()
        weight = jumps.weight.to(dev, v.dtype).contiguous()
    warps, _, work_values = jump_plan(batch, n, v.element_size())
    work = torch.empty((batch, work_values), dtype=v.dtype, device=dev) if work_values else None
    counts = torch.empty((2, batch), dtype=torch.int32, device=dev)
    out = torch.empty_like(grid[4])
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731

    def launch():
        err = _build.load_library().theta_jump_launch(
            grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(), coef.data_ptr(),
            grid[3].data_ptr(), grid[4].data_ptr(), ends.data_ptr(), out.data_ptr(),
            counts.data_ptr(), ptr(jump_at), ptr(index), ptr(weight), ptr(work), n_jumps, batch,
            n, n_time, mode, warps, _DTYPE_ID[v.dtype], dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"theta_jump_launch failed: {_build.error_string(err)} ({err})")
        with _LAUNCH_LOCK:
            _theta_jumps_cuda.launches += 1

    return launch, out, counts


def _theta_jumps_cuda(lo, di, up, a, b, c, w, psi, v, ends, mode: int, jumps: Jumps,
                      count_solves: bool = False):
    """The jump-table kernel (``theta_jump_kernel``): one launch on PyTorch's
    current stream, no synchronize, one warp a contract. Arguments as
    :func:`_theta_plain`'s with its jump table, on one CUDA device, of one
    dtype, float32 or float64; returns the values, with ``count_solves`` also
    (solves, re-formed rows): int32 counts a contract of the solves it ran
    (Howard stops sweeping a step at its fixed point) and of the rows whose
    factors its later Howard sweeps re-formed. Any grid runs: the rows in
    registers, or in a workspace of device memory (:func:`jump_plan`).
    ``_theta_jumps_cuda.launches`` counts the launches."""
    launch, out, counts = _jump_launch(lo, di, up, a, b, c, w, psi, v, ends, mode, jumps)
    launch()
    return (out, counts[0], counts[1]) if count_solves else out


_theta_jumps_cuda.launches = 0


def _theta_adjoint_cuda(lo, di, up, a, b, c, w, psi, v0, ends, mode: int, hist_u, hist_m, g):
    """The reverse kernel: one launch on PyTorch's current stream, no
    synchronize. Arguments and returns as :func:`_theta_reverse_plain`'s (the
    history as :func:`_theta_cuda` keeps it). The route is
    :func:`adjoint_plan`'s: the accumulators of lo, di, up and ψ stay in the
    block's shared memory for the launch and each thread's shares of a, b, c
    and w in its registers, each written once; the tables and the history
    rows are in shared memory too, or on the device route (grids too long for
    that) in a workspace of device memory and in the history itself. The
    sums run in a fixed order, no atomics. ``_theta_adjoint_cuda.launches``
    counts the launches."""
    ops = (lo, di, up, a, b, c, w, psi, v0, ends, hist_u, g)
    dev = check_operands("_theta_adjoint_cuda", ops)
    batch, n_time, n = hist_u.shape
    if n < 3 or ends.shape != (batch, n_time, 2) or mode not in (0, 1, 2) \
            or (mode == HOWARD) != (hist_m is not None):
        raise ValueError(f"bad θ-scheme reverse: history {tuple(hist_u.shape)}, ends "
                         f"{tuple(ends.shape)}, mode {mode}")
    grid, coef = _grid_operands(lo, di, up, a, b, c, w, psi, v0, batch, n)
    systems, device = adjoint_plan(batch, n, v0.element_size(), sm_count(dev.index))
    hist_u = hist_u.contiguous()
    if hist_m is not None:
        hist_m = hist_m.to(torch.bool).contiguous()
    g = g.expand(batch, n).contiguous()
    g_grid = torch.empty((5, batch, n), dtype=v0.dtype, device=dev)  # lo, di, up, ψ, v0
    g_coef = torch.empty((4, batch), dtype=v0.dtype, device=dev)
    g_ends = torch.empty((batch, n_time, 2), dtype=v0.dtype, device=dev)
    work = torch.empty((batch, ADJOINT_WORK_ROWS, n), dtype=v0.dtype, device=dev) if device \
        else None
    err = _build.load_library().theta_pde_adjoint_launch(
        grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(), coef.data_ptr(),
        grid[3].data_ptr(), grid[4].data_ptr(), hist_u.data_ptr(),
        0 if hist_m is None else hist_m.data_ptr(), g.data_ptr(), g_grid.data_ptr(),
        g_coef.data_ptr(), g_ends.data_ptr(), 0 if work is None else work.data_ptr(), batch, n,
        n_time, mode, systems, _DTYPE_ID[v0.dtype], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"theta_pde_adjoint_launch failed: {_build.error_string(err)} "
                           f"({err})")
    with _LAUNCH_LOCK:
        _theta_adjoint_cuda.launches += 1
    return (*g_grid[:3], *(x[:, None] for x in g_coef), g_grid[3], g_grid[4], g_ends)


_theta_adjoint_cuda.launches = 0


def _dispatch(*ops, mode: int, history: bool = False, jumps: Jumps | None = None):
    """The kernel for CUDA tensors (with a jump table the jump-table
    kernel), the plain loop for CPU tensors."""
    dev = ops[-2].device
    if dev.type == "cuda":
        if jumps is not None:
            return _theta_jumps_cuda(*ops, mode, jumps)
        return _theta_cuda(*ops, mode, history=history)
    if dev.type == "cpu":
        return _theta_plain(*ops, mode, jumps=jumps, history=history)
    raise ValueError(f"no θ-scheme time loop for device {dev}")


class _ThetaLoop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mode, *ops):
        out, hist_u, hist_m = _dispatch(*ops, mode=mode, history=True)
        ctx.mode = mode
        ctx.save_for_backward(*ops, hist_u, hist_m)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        ops, (hist_u, hist_m) = saved[:-2], saved[-2:]
        needs = ctx.needs_input_grad[1:]
        if torch.is_grad_enabled():
            # a graph of the gradient is asked for (a higher derivative): the
            # plain loop again under autograd, on a view of each input that
            # needs a gradient (distinct nodes, so an input passed twice, ψ
            # and the initial v, gets each part once)
            with torch.enable_grad():
                xs = [t.view_as(t) if need else t.detach() for t, need in zip(ops, needs)]
                out = _theta_plain(*xs, ctx.mode)
            want = [x for x, need in zip(xs, needs) if need]
            grads = iter(torch.autograd.grad(out, want, g, create_graph=True,
                                             allow_unused=True))
            return (None,) + tuple(next(grads) if need else None for need in needs)
        dev = g.device
        if dev.type == "cuda":
            grads = _theta_adjoint_cuda(*ops, ctx.mode, hist_u, hist_m, g)
        elif dev.type == "cpu":
            grads = _theta_reverse_plain(*ops, ctx.mode, hist_u, hist_m, g)
        else:
            raise ValueError(f"no θ-scheme reverse for device {dev}")
        return (None,) + tuple(gr.sum_to_size(x.shape) if need else None
                               for gr, x, need in zip(grads, ops, needs))


def theta_loop(lo, di, up, a, b, c, w, psi, v, ends, mode: int,
               jumps: Jumps | None = None) -> torch.Tensor:
    """``ends.shape[1]`` θ-scheme steps from ``v``; returns the (B, n) values.

    ``lo``, ``di``, ``up``: (B, n) diagonals of ``I − θ·dt·L`` with Dirichlet
    end rows; ``a``, ``b``, ``c``: (B, 1) the operator ``L``'s neighbour
    weights; ``w``: (B, 1) the explicit weight ``(1 − θ)·dt``; ``psi``: (B, n)
    the exercise value; ``ends``: (B, n_time, 2) the right-hand side's first
    and last value at each step; ``mode``: :data:`EUROPEAN`,
    :data:`PROJECTION` or :data:`HOWARD`; ``jumps``: a :class:`Jumps` table
    or None. Differentiable in every tensor where there is no jump table: a
    loop with one takes no gradient.
    """
    ops = (lo, di, up, a, b, c, w, psi, v, ends)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ops)
    if jumps is not None:
        if grad:
            raise ValueError("a θ-scheme loop with a jump table takes no gradient")
        return _dispatch(*ops, mode=mode, jumps=jumps)
    if grad:
        return _ThetaLoop.apply(mode, *ops)
    return _dispatch(*ops, mode=mode)
