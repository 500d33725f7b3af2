"""Time the θ-scheme, ADI and local-vol kernels of two source trees in turns on one card.

Usage (on a machine with a CUDA card and ``nvcc``)::

    python tools/pde_in_turns.py --parent DIR [--out FILE] [--only reverse|loops] [--fit]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked with ``git archive``. Each tree's
``csrc/theta_pde.cu``, ``csrc/heston_adi.cu`` and ``csrc/lv_pde.cu`` are built
by ``nvcc`` into a library of their own; both are driven through this checkout's wrappers
(``ops/theta_pde.py``, ``ops/heston_adi.py``) on the same operands:
``fdm_price``'s 256 x 201 x 200 book (European, projection and Howard,
float32 and float64) and the Heston ADI loops at the defaults (European and
American 201 x 101 x 200, Bermudan 50 and 25 dates x 8 steps, SLV 161 x 81 at
25 x 8). The two outputs of each case must be bitwise equal; each kernel is
timed by CUDA events in turns: other, this, this, other. The θ-scheme
reverse kernels run at 256 x 201 x 200, European, projection and Howard,
float32 and float64, on one forward's history and one seeded gradient, each
tree through its own launch (this tree's plan: the shared route, which a
tree without the device route's workspace argument also takes); their
gradients may differ by the order of their sums and by their rounding, and
the largest gap, relative to each gradient's largest entry, is printed.
``fdm_price``'s first-order gradient at 256 x 201 x 200 float32 (European and
American), the forward with its history and the reverse on each tree's
kernels, is timed by the host clock (a mean of 5 warm calls) in the same
turns. The ADI reverse kernels run at 201 x 101 x 200, European and American,
on one history and
one seeded weight grid, each tree driven through its own pointer table
(``_REV_FIELDS``, read from its source; the fields this tree lacks get zeroed
buffers of the size their name has: a work grid, or three for ``xpiv``; its
``p_td2`` slots one a column or a row, whichever is more) and
this tree's dims (route included); the two trees' gradients may differ by
their sums' order, and the largest gap, relative to each gradient's largest
entry, is printed. With ``--fit`` each tree's reverse step is also fitted to
t = c0 + cx·n_x + cv·n_v (``chip_smoke.step_fit``) on the grids of
``chip_smoke.adi_reverse_fit_inputs``, in turns. ``--only reverse`` times the
θ-scheme and ADI reverse kernels alone.

The two single-contract loops (``--only loops`` times them alone): the
dividend PDE at 401 x 400 float32 (``chip_smoke.DIV_SHAPE``, its two
dividends; the European call and the American put) and the local-vol loop
on the sample smile (the European and American at 201 x 200, the Bermudan
put at 401 x 25 dates x 8), each tree's kernel launched alone on operands
made ready first (its own launch: a tree with ``theta_jump_launch`` takes the
dividend loop there, one without through ``theta_pde_launch``'s jump table;
``lv_pde_launch`` with or without the ring and the workspace), timed as a
CUDA graph of calls (``chip_smoke.graph_time``) in turns. Their solves round
otherwise (Thomas's against the warp-partitioned solve), so the largest gap
of the two outputs, relative to the largest value, is printed.

Prints one line a case and the card's
name and power limit; with ``--out`` also writes the times there as JSON.

The ABI this assumes of the other tree, checked before anything is built:
``heston_adi_launch`` takes the parameter types of this tree's;
``theta_pde_launch`` this tree's, or those with the jump table (three
pointers after ``hist_m`` and the count of jumps), which the θ cases pass as
null; ``lv_pde_launch`` this tree's, or those without the workspace pointer
and the ring; the other tree's ``_FWD_FIELDS`` (the forward launch's pointer
table) is this tree's; its forward launch reads no ``dims`` entry past this
tree's last (index 7, the route, which a tree without the cluster kernel
does not read); and its θ kernel writes at most the two ints a block of the
counts buffer that this tree's wrapper allocates (a tree that counts only
the solves writes the first); ``theta_pde_adjoint_launch`` takes this tree's
parameters, or those without the workspace pointer after ``g_ends``;
``heston_adi_adjoint_launch`` reads no ``dims``
entry past this tree's last (index 5) and its pointer table names only
fields this tool can allocate.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from optionslab_tpu_torch.ops import _build  # noqa: E402
from optionslab_tpu_torch.ops import heston_adi as ha  # noqa: E402
from optionslab_tpu_torch.ops import theta_pde as tp  # noqa: E402

SOURCES = ("theta_pde.cu", "heston_adi.cu", "lv_pde.cu")
LAUNCHES = {"heston_adi.cu": "heston_adi_launch"}
FORWARD_DIMS = 8  # dims entries this tree's ADI wrapper passes
REVERSE_DIMS = 6  # and its reverse wrapper
# the other tree's reverse fields this tree does not have: grids of work each
OTHER_FIELDS = {"w_gy1": 1, "w_ga2p": 1, "w_rl": 1, "w_ga2": 1, "w_gn": 1, "xpiv": 3}
_P, _I = ctypes.c_void_p, ctypes.c_int


def launch_types(src: str, name: str) -> list[str]:
    """The parameter types of ``extern "C" int name(...)`` in ``src``."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    if m is None:
        raise SystemExit(f"pde_in_turns: no extern \"C\" {name} in the other tree")
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


def fields(path: pathlib.Path, name: str) -> tuple:
    """A pointer table (``_FWD_FIELDS``, ``_REV_FIELDS``) of an
    ``ops/heston_adi.py``, read without importing it."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise SystemExit(f"pde_in_turns: no {name} in {path}")


def dims_read(src: str, name: str) -> int:
    """One past the largest ``dims`` index that ``extern "C" int name`` reads."""
    body = src[src.index(f'extern "C" int {name}'):]
    end = body.find('extern "C"', 1)
    body = body if end < 0 else body[:end]
    return max(int(k) for k in re.findall(r"dims\[(\d+)\]", body)) + 1


def reverse_abi(other: pathlib.Path) -> bool:
    """Whether the other tree's ``theta_pde_adjoint_launch`` takes this
    tree's parameters (True) or those without the workspace pointer (False);
    stops on any other."""
    name = "theta_pde_adjoint_launch"
    theirs = launch_types((other / "optionslab_tpu_torch" / "csrc" / "theta_pde.cu").read_text(),
                          name)
    ours = launch_types((_build.CSRC / "theta_pde.cu").read_text(), name)
    if theirs == ours:
        return True
    if theirs == ours[:12] + ours[13:]:
        return False
    raise SystemExit(f"pde_in_turns: {name} takes other arguments there")


def forward_abi(other: pathlib.Path) -> dict:
    """Which launches the other tree's θ-scheme and local-vol sources take:
    {"jump_table": its ``theta_pde_launch`` takes a jump table (the tree
    before the jump-table kernel), "jump_kernel": it has
    ``theta_jump_launch``, "lv_ring": its ``lv_pde_launch`` takes this
    tree's arguments (else those without the workspace and the ring)};
    stops on any other."""
    csrc = other / "optionslab_tpu_torch" / "csrc"
    theta, lv = (csrc / "theta_pde.cu").read_text(), (csrc / "lv_pde.cu").read_text()
    ours = launch_types((_build.CSRC / "theta_pde.cu").read_text(), "theta_pde_launch")
    theirs = launch_types(theta, "theta_pde_launch")
    if theirs not in (ours, ours[:11] + ["const void*"] * 3 + ["int"] + ours[11:]):
        raise SystemExit("pde_in_turns: theta_pde_launch takes other arguments there")
    lv_ours = launch_types((_build.CSRC / "lv_pde.cu").read_text(), "lv_pde_launch")
    lv_theirs = launch_types(lv, "lv_pde_launch")
    if lv_theirs not in (lv_ours, lv_ours[:8] + lv_ours[9:14] + lv_ours[15:]):
        raise SystemExit("pde_in_turns: lv_pde_launch takes other arguments there")
    jump_kernel = 'extern "C" int theta_jump_launch' in theta
    if jump_kernel and launch_types(theta, "theta_jump_launch") != launch_types(
            (_build.CSRC / "theta_pde.cu").read_text(), "theta_jump_launch"):
        raise SystemExit("pde_in_turns: theta_jump_launch takes other arguments there")
    return {"jump_table": theirs != ours, "jump_kernel": jump_kernel,
            "lv_ring": lv_theirs == lv_ours}


def check_abi(other: pathlib.Path) -> None:
    """Stops unless the other tree's launches take this checkout's arguments
    (the ABI in the module's docstring)."""
    forward_abi(other)
    for name, fn in [*LAUNCHES.items(), ("heston_adi.cu", "heston_adi_adjoint_launch")]:
        theirs = (other / "optionslab_tpu_torch" / "csrc" / name).read_text()
        ours = (_build.CSRC / name).read_text()
        if launch_types(theirs, fn) != launch_types(ours, fn):
            raise SystemExit(f"pde_in_turns: {fn} takes other arguments there")
    reverse_abi(other)
    py = other / "optionslab_tpu_torch" / "ops" / "heston_adi.py"
    if fields(py, "_FWD_FIELDS") != ha._FWD_FIELDS:
        raise SystemExit("pde_in_turns: the other tree's ADI pointer table differs")
    unknown = set(fields(py, "_REV_FIELDS")) - set(ha._REV_FIELDS) - set(OTHER_FIELDS)
    if unknown:
        raise SystemExit(f"pde_in_turns: the other tree's reverse takes {sorted(unknown)}")
    src = (other / "optionslab_tpu_torch" / "csrc" / "heston_adi.cu").read_text()
    if dims_read(src, "heston_adi_launch") > FORWARD_DIMS:
        raise SystemExit("pde_in_turns: the other tree's ADI launch reads more dims")
    if dims_read(src, "heston_adi_adjoint_launch") > REVERSE_DIMS:
        raise SystemExit("pde_in_turns: the other tree's ADI reverse launch reads more dims")


class _JumpTableLib:
    """A library whose ``theta_pde_launch`` takes a jump table, seen through
    this tree's launch: the θ cases' calls get null jump pointers and no
    jumps; every other function is the library's."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def theta_pde_launch(self, *args):
        return self.lib.theta_pde_launch(*args[:11], 0, 0, 0, 0, *args[11:])


def build(csrc: pathlib.Path, out: pathlib.Path, workspace: bool = True,
          abi: dict | None = None):
    """The library of ``csrc``'s PDE kernels, each source by its own nvcc;
    ``workspace``: its θ-scheme reverse launch takes the workspace pointer;
    ``abi``: :func:`forward_abi` of the tree (None: this tree's)."""
    abi = abi or {"jump_table": False, "jump_kernel": True, "lv_ring": True}
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.cuda_tool("nvcc")

    def compile_one(name):
        obj = out / (name + ".o")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj), str(csrc / name)],
                       check=True, capture_output=True, text=True)
        return str(obj)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        objects = list(pool.map(compile_one, SOURCES))
    lib_path = out / "libpde.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *objects], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.theta_pde_launch.argtypes = [_P] * (14 if abi["jump_table"] else 11) \
        + [_I] * (8 if abi["jump_table"] else 7) + [_P]
    lib.theta_pde_launch.restype = _I
    if abi["jump_kernel"]:
        lib.theta_jump_launch.argtypes = [_P] * 13 + [_I] * 8 + [_P]
        lib.theta_jump_launch.restype = _I
    lib.lv_pde_launch.argtypes = [_P] * (9 if abi["lv_ring"] else 8) \
        + [_I] * (8 if abi["lv_ring"] else 7) + [_P]
    lib.lv_pde_launch.restype = _I
    lib.theta_pde_adjoint_launch.argtypes = [_P] * (13 if workspace else 12) + [_I] * 7 + [_P]
    lib.theta_pde_adjoint_launch.restype = _I
    for fn in ("heston_adi_launch", "heston_adi_adjoint_launch"):
        getattr(lib, fn).argtypes = [_P, _P, _I, _P]
        getattr(lib, fn).restype = _I
    return _JumpTableLib(lib) if abi["jump_table"] else lib


def on(lib, fn):
    """``fn`` with the wrappers' library set to ``lib`` (a library of the two
    PDE sources alone, so a failed launch's code is reported as a number)."""
    def call():
        saved = _build.load_library, _build.error_string
        _build.load_library = lambda: lib
        _build.error_string = lambda code: f"CUDA error {code}"
        try:
            return fn()
        finally:
            _build.load_library, _build.error_string = saved
    return call


def theta_cases(dev):
    from optionslab_tpu_torch.models import fdm

    book = cs.pricer_book(cs.THETA_SHAPE[0], dev, seed=11)
    for dtype in (torch.float32, torch.float64):
        args = [getattr(book, f).to(dtype) for f in cs.FDM_FIELDS]
        for name, mode in cs.THETA_MODES.items():
            _, ops = fdm._cn_operands(*args, *cs.THETA_SHAPE[1:], 0.5, mode != tp.EUROPEAN)
            tag = f"theta {name} {'x'.join(map(str, cs.THETA_SHAPE))} {str(dtype)[6:]}"
            yield tag, (lambda ops=ops, mode=mode: tp._theta_cuda(*ops, mode)), 3


def adi_cases(dev):
    for tag, ops, slv, mode, spd in cs.adi_cases(dev):
        if ops.intrinsic.shape[1] == 41:
            continue
        yield (f"adi {tag}",
               lambda ops=ops, slv=slv, mode=mode, spd=spd: ha._adi_cuda(
                   ops, ops.intrinsic, mode, spd, slv)[0], 5)


def theta_reverse(lib, workspace: bool, ops, mode, hist_u, hist_m, g):
    """One launch of a tree's θ-scheme reverse kernel on this tree's plan
    (the shared route: the tree without the workspace argument has no other)
    and operands; the gradients as ``tp._theta_adjoint_cuda`` returns them."""
    if workspace:
        return on(lib, lambda: tp._theta_adjoint_cuda(*ops, mode, hist_u, hist_m, g))()
    dev = g.device
    batch, n_time, n = hist_u.shape
    systems, device = tp.adjoint_plan(batch, n, g.element_size(), tp.sm_count(dev.index))
    if device:
        raise SystemExit("pde_in_turns: the other tree's θ reverse has no device route")
    grid, coef = tp._grid_operands(*ops[:9], batch, n)
    g_grid = torch.empty((5, batch, n), dtype=g.dtype, device=dev)
    g_coef = torch.empty((4, batch), dtype=g.dtype, device=dev)
    g_ends = torch.empty((batch, n_time, 2), dtype=g.dtype, device=dev)
    err = lib.theta_pde_adjoint_launch(
        grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(), coef.data_ptr(),
        grid[3].data_ptr(), grid[4].data_ptr(), hist_u.data_ptr(),
        0 if hist_m is None else hist_m.data_ptr(), g.data_ptr(), g_grid.data_ptr(),
        g_coef.data_ptr(), g_ends.data_ptr(), batch, n, n_time, mode, systems,
        0 if g.dtype == torch.float32 else 1, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise SystemExit(f"pde_in_turns: the other tree's θ reverse failed: CUDA error {err}")
    return (*g_grid[:3], *(x[:, None] for x in g_coef), g_grid[3], g_grid[4], g_ends)


def theta_reverse_cases(dev, workspace: dict, lib):
    """The θ-scheme reverse at THETA_SHAPE in three modes and two dtypes on
    one forward's history (this tree's forward on ``lib``): (tag, {tree:
    fn(lib)})."""
    from optionslab_tpu_torch.models import fdm

    book = cs.pricer_book(cs.THETA_SHAPE[0], dev, seed=11)
    for dtype in (torch.float32, torch.float64):
        args = [getattr(book, f).to(dtype) for f in cs.FDM_FIELDS]
        for name, mode in cs.THETA_MODES.items():
            _, ops = fdm._cn_operands(*args, *cs.THETA_SHAPE[1:], 0.5, mode != tp.EUROPEAN)
            _, hist_u, hist_m = on(lib, lambda ops=ops, mode=mode: tp._theta_cuda(
                *ops, mode, history=True))()
            gen = torch.Generator(device=dev).manual_seed(5)
            g = torch.randn(hist_u[:, 0].shape, generator=gen, device=dev, dtype=dtype)
            yield (f"theta adjoint {name} {'x'.join(map(str, cs.THETA_SHAPE))} {str(dtype)[6:]}",
                   {who: (lambda lib, w=w, ops=ops, mode=mode, hist_u=hist_u, hist_m=hist_m,
                          g=g: theta_reverse(lib, w, ops, mode, hist_u, hist_m, g))
                    for who, w in workspace.items()})


def gradient_wall(lib, workspace: bool, fields, american: bool) -> float:
    """Host ms (a mean of 5 warm calls) of ``fdm_price``'s gradient in S, K,
    T, r, σ and q on the library ``lib``: its forward with the history, and
    its reverse through :func:`theta_reverse`."""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.types import ContractBatch

    def call():
        leaves = [x.detach().requires_grad_(True) for x in fields[:6]]
        price = fdm.fdm_price(ContractBatch(*leaves, fields[6]), american=american)
        return torch.autograd.grad(price.sum(), leaves)

    saved = tp._theta_adjoint_cuda
    if not workspace:  # a launch this tree's wrapper cannot make
        tp._theta_adjoint_cuda = lambda *a: theta_reverse(lib, False, a[:10], *a[10:])
    try:
        return on(lib, lambda: cs.timed(call, 5)[1])()
    finally:
        tp._theta_adjoint_cuda = saved


def reverse(ops, hist, weight, american: bool, rev_fields: tuple):
    """One launch of the reverse kernel through the pointer table
    ``rev_fields``, on this tree's operands and dims; the gradients as
    ``ha._adi_adjoint_cuda`` returns them."""
    start = ops.intrinsic
    t, dims = ha._adjoint_operands(ops, start, hist, weight, american)
    n = dims[0] * dims[1]
    for name in rev_fields:
        if name not in t and name in OTHER_FIELDS:
            t[name] = torch.zeros(OTHER_FIELDS[name] * n, device=start.device)
    if rev_fields != ha._REV_FIELDS:  # a tree that sums λ2·a2v by column
        t["p_td2"] = torch.zeros(max(dims[0], dims[1]), device=start.device)
    ha._launch("heston_adi_adjoint_launch", rev_fields, t, dims, start.device)
    return ha._adjoint_grads(t, *dims[:3])


def reverse_cases(dev, rev: dict):
    """The reverse at the defaults, European and American: (tag, {tree: fn})."""
    for tag, ops, _, mode, _ in cs.adi_cases(dev):
        if ops.intrinsic.shape[1] == 41 or mode == ha.BERMUDAN:
            continue
        n_v, n_x = ops.intrinsic.shape
        _, _, hist = ha._adi_cuda(ops, ops.intrinsic, mode, history=True)
        weight = torch.tensor(cs.np.random.default_rng(n_x).normal(size=(n_v, n_x)),
                              dtype=torch.float32, device=dev)
        yield f"adi adjoint {tag}", {
            who: (lambda f=f, ops=ops, hist=hist, weight=weight, mode=mode: reverse(
                ops, hist, weight, mode == ha.AMERICAN, f)) for who, f in rev.items()}


def jump_table_launch(lib, ops, mode, jumps):
    """The dividend loop on a tree before the jump-table kernel: its
    ``theta_pde_launch`` with the jump table, one contract a block, on
    operands made ready first. Returns (launch, out)."""
    dev = ops[-2].device
    batch, n = ops[-2].shape
    n_time = ops[-1].shape[1]
    grid, coef = tp._grid_operands(*ops[:9], batch, n)
    ends = ops[-1].contiguous()
    jump_at = torch.full((n_time,), -1, dtype=torch.int32, device=dev)
    for i, k in enumerate(jumps.steps):
        jump_at[k] = i
    index = jumps.index.to(dev, torch.int32).contiguous()
    weight = jumps.weight.to(dev, grid[0].dtype).contiguous()
    counts = torch.empty((2, batch), dtype=torch.int32, device=dev)
    out = torch.empty_like(grid[4])

    def launch():
        err = lib.lib.theta_pde_launch(
            grid[0].data_ptr(), grid[1].data_ptr(), grid[2].data_ptr(), coef.data_ptr(),
            grid[3].data_ptr(), grid[4].data_ptr(), ends.data_ptr(), out.data_ptr(),
            counts.data_ptr(), 0, 0, jump_at.data_ptr(), index.data_ptr(), weight.data_ptr(),
            len(jumps.steps), batch, n, n_time, mode, 1, 0 if grid[0].dtype == torch.float32
            else 1, dev.index, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise SystemExit(f"pde_in_turns: the other tree's jump table failed: CUDA error {err}")

    return launch, out


def lv_plain_launch(lib, ops, mode, spd):
    """The local-vol loop on a tree whose ``lv_pde_launch`` takes no ring
    and no workspace (a block a contract, the tile in shared memory), on
    operands made ready first. Returns (launch, out)."""
    from optionslab_tpu_torch.ops import lv_pde as lvp

    lo, di, up, ends, psi, v0 = (t.contiguous() for t in ops)
    batch, n_time, n = lo.shape
    dev = lo.device
    out = torch.empty_like(v0)
    n_conts = n_time // spd - 1 if mode == lvp.BERMUDAN else 0
    conts = torch.empty((batch, max(n_conts, 0), n), dtype=v0.dtype, device=dev)

    def launch():
        err = lib.lv_pde_launch(
            lo.data_ptr(), di.data_ptr(), up.data_ptr(), ends.data_ptr(), psi.data_ptr(),
            v0.data_ptr(), out.data_ptr(), conts.data_ptr() if n_conts > 0 else 0, batch, n,
            n_time, mode, spd, 0 if v0.dtype == torch.float32 else 1, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise SystemExit(f"pde_in_turns: the other tree's lv_pde_launch failed: CUDA error "
                             f"{err}")

    return launch, out


def loop_cases(dev, libs: dict, abi: dict):
    """The dividend and local-vol loops: (tag, {tree: (launch, out)}), each
    tree's kernel on operands made ready on its library."""
    from optionslab_tpu_torch.models import dividends as dv
    from optionslab_tpu_torch.models import local_vol as lvm
    from optionslab_tpu_torch.ops import lv_pde as lvp

    steps = dv._div_steps([t for t, _ in cs.SL_DIVS], 1.0, cs.DIV_SHAPE[1])
    amounts = cs.np.asarray([d for _, d in cs.SL_DIVS], cs.np.float32)
    for name, cp, mode in (("european call", 1.0, tp.EUROPEAN), ("american put", -1.0, tp.HOWARD)):
        _, _, ops, jumps = dv._fdm_div_operands(
            100.0, 100.0, 1.0, 0.05, 0.2, amounts, cp=cp, n_space=cs.DIV_SHAPE[0],
            n_time=cs.DIV_SHAPE[1], american=mode == tp.HOWARD, div_steps=steps, device=dev)
        made = {}
        for who, lib in libs.items():
            if who == "other" and not abi["jump_kernel"]:
                made[who] = jump_table_launch(lib, ops, mode, jumps)
            else:
                launch, out, _ = on(lib, lambda ops=ops, mode=mode, jumps=jumps: tp._jump_launch(
                    *ops, mode, jumps))()
                made[who] = (on(lib, launch), out)
        yield f"dividend {name} {'x'.join(map(str, cs.DIV_SHAPE))} float32", made
    dup = cs.smile_dupire(dev)
    grids = (dup.surface.k_grid, dup.surface.t_grid, dup.surface.grid)
    n_b, dates, spd = cs.LV_BERMUDAN
    for name, args, mode, k in (
            ("european call", (100.0, 1.0, 1.0, *cs.LV_PDE, False), lvp.EUROPEAN, 1),
            ("american put", (100.0, 1.0, -1.0, *cs.LV_PDE, False), lvp.PROJECTION, 1),
            ("bermudan put", (100.0, 1.0, -1.0, n_b, dates * spd, True), lvp.BERMUDAN, spd)):
        _, intr, lo, di, up, ends = lvm._lv_tables(*grids, cs.S0, cs.RATE, 0.0, *args)
        ops = [t[None] for t in (lo, di, up, ends, intr, intr)]
        made = {}
        for who, lib in libs.items():
            if who == "other" and not abi["lv_ring"]:
                made[who] = lv_plain_launch(lib, ops, mode, k)
            else:
                launch, out, _ = lvp._lv_launch(*ops, mode, k)
                made[who] = (on(lib, launch), out)
        yield f"local-vol {name} {lo.shape[1]}x{lo.shape[0]} float32", made


def in_turns(libs: dict, fns: dict, iters: int) -> dict:
    """Device ms of each tree's ``fns[tree]`` on its library, in turns:
    other, this, this, other."""
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        times[who].append(cs.event_time(on(libs[who], fns[who]), iters))
    return times


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, type=pathlib.Path,
                        help="the root of the other tree")
    parser.add_argument("--out", type=pathlib.Path, help="a JSON file for the times")
    parser.add_argument("--only", choices=("reverse", "loops"),
                        help="time only the θ-scheme and ADI reverse kernels, or only the "
                             "dividend and local-vol loops")
    parser.add_argument("--fit", action="store_true", help="fit each tree's reverse step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pde_in_turns: no CUDA device")
    dev = torch.device("cuda", 0)
    check_abi(args.parent)
    abi = forward_abi(args.parent)
    workspace = {"other": reverse_abi(args.parent), "this": True}
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.parent / "optionslab_tpu_torch" / "csrc",
                               pathlib.Path(tmp) / "other", workspace["other"], abi),
                "this": build(_build.CSRC, pathlib.Path(tmp) / "this")}
        results = {}
        if args.only != "reverse":
            for tag, made in loop_cases(dev, libs, abi):
                for launch, _ in made.values():
                    launch()
                torch.cuda.synchronize()
                outs = {who: out for who, (_, out) in made.items()}
                gap = ((outs["this"] - outs["other"]).abs().max()
                       / outs["other"].abs().max()).item()
                times = {"other": [], "this": []}
                for who in ("other", "this", "this", "other"):
                    reads = cs.graph_time(made[who][0], iters=10, reps=3)
                    times[who].append(min(reads))
                results[tag] = {**times, "gap": gap}
                print(f"{tag}: the two trees' values within {gap:.2e} of the largest; device ms "
                      f"of the kernel alone (a CUDA graph of calls), in turns [{card}]: other "
                      + " / ".join(f"{t:.4f}" for t in times["other"]) + ", this "
                      + " / ".join(f"{t:.4f}" for t in times["this"])
                      + f"; this / other {min(times['this']) / min(times['other']):.3f}",
                      flush=True)
        forward = [] if args.only else [*theta_cases(dev), *adi_cases(dev)]
        for tag, fn, iters in forward:
            outs = {k: on(lib, fn)() for k, lib in libs.items()}
            torch.cuda.synchronize()
            if not torch.equal(outs["other"], outs["this"]):
                raise SystemExit(f"{tag}: the two trees' kernels differ")
            results[tag] = times = in_turns(libs, {"other": fn, "this": fn}, iters)
            print(f"{tag}: bitwise equal; device ms by CUDA events, in turns [{card}]: other "
                  + " / ".join(f"{t:.4f}" for t in times["other"]) + ", this "
                  + " / ".join(f"{t:.4f}" for t in times["this"])
                  + f"; this / other {min(times['this']) / min(times['other']):.3f}",
                  flush=True)
        reverse_cases_ = [] if args.only == "loops" else theta_reverse_cases(dev, workspace,
                                                                              libs["this"])
        for tag, fns in reverse_cases_:
            calls = {k: (lambda k=k: fns[k](libs[k])) for k in libs}
            outs = {k: on(libs[k], calls[k])() for k in libs}
            torch.cuda.synchronize()
            gap = cs.grad_gaps(outs["this"], outs["other"])[0]
            results[tag] = times = in_turns(libs, calls, 3)
            print(f"{tag}: largest relative gap of the gradients {gap:.2e}; device ms by CUDA "
                  f"events, in turns [{card}]: other "
                  + " / ".join(f"{t:.4f}" for t in times["other"]) + ", this "
                  + " / ".join(f"{t:.4f}" for t in times["this"])
                  + f"; this / other {min(times['this']) / min(times['other']):.3f}",
                  flush=True)
        book = cs.pricer_book(cs.THETA_SHAPE[0], dev, seed=11)
        book_fields = [getattr(book, f) for f in cs.FDM_FIELDS]
        for american in () if args.only == "loops" else (False, True):
            tag = f"fdm_price gradient {'american' if american else 'european'} " \
                  f"{'x'.join(map(str, cs.THETA_SHAPE))} float32"
            times = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                times[who].append(gradient_wall(libs[who], workspace[who], book_fields, american))
            results[tag] = times
            print(f"{tag}: host wall ms (a mean of 5 warm calls), in turns [{card}]: other "
                  + " / ".join(f"{t:.2f}" for t in times["other"]) + ", this "
                  + " / ".join(f"{t:.2f}" for t in times["this"])
                  + f"; this / other {min(times['this']) / min(times['other']):.3f}", flush=True)
        rev = {"other": fields(args.parent / "optionslab_tpu_torch" / "ops" / "heston_adi.py",
                               "_REV_FIELDS"), "this": ha._REV_FIELDS}
        for tag, fns in [] if args.only == "loops" else reverse_cases(dev, rev):
            outs = {k: on(libs[k], fns[k])() for k in libs}
            torch.cuda.synchronize()
            gap = cs.adi_grad_gap(outs["this"], outs["other"])
            results[tag] = times = in_turns(libs, fns, 5)
            print(f"{tag}: largest relative gap of the gradients {gap:.2e}; device ms by CUDA "
                  f"events, in turns [{card}]: other "
                  + " / ".join(f"{t:.4f}" for t in times["other"]) + ", this "
                  + " / ".join(f"{t:.4f}" for t in times["this"])
                  + f"; this / other {min(times['this']) / min(times['other']):.3f}",
                  flush=True)
        if args.fit:
            points = {"other": [], "this": []}
            for n_x, n_v, ops, hist, weight in cs.adi_reverse_fit_inputs(dev):
                fns = {who: (lambda f=f: reverse(ops, hist, weight, False, f))
                       for who, f in rev.items()}
                for who in libs:
                    on(libs[who], fns[who])()
                times = in_turns(libs, fns, 5)
                for who in libs:
                    points[who].append((n_x, n_v, min(times[who]) / cs.ADI_FIT_STEPS * 1e3))
            for who in ("other", "this"):
                c0, cx, cv, worst = cs.step_fit(points[who])
                results[f"adi adjoint fit {who}"] = {"points": points[who], "c0": c0, "cx": cx,
                                                     "cv": cv}
                print(f"adi adjoint step fit, {who} tree, µs a step on (n_x, n_v, µs) "
                      f"{[(x, v, round(t, 2)) for x, v, t in points[who]]} [{card}]: "
                      f"{c0:.2f} + {cx:.4f}·n_x + {cv:.4f}·n_v (largest residual {worst:.2f})",
                      flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "cases": results}, indent=1))
    print(card)


if __name__ == "__main__":
    main()
