"""Time the θ-scheme and ADI forward kernels of two source trees in turns on one card.

Usage (on a machine with a CUDA card and ``nvcc``)::

    python tools/pde_in_turns.py --parent DIR [--out FILE]

``DIR`` is the root of another tree of this repository, for example an
earlier commit unpacked with ``git archive``. Each tree's
``csrc/theta_pde.cu`` and ``csrc/heston_adi.cu`` are built by ``nvcc`` into a
library of their own; both are driven through this checkout's wrappers
(``ops/theta_pde.py``, ``ops/heston_adi.py``) on the same operands:
``fdm_price``'s 256 x 201 x 200 book (European, projection and Howard,
float32 and float64) and the Heston ADI loops at the defaults (European and
American 201 x 101 x 200, Bermudan 50 and 25 dates x 8 steps, SLV 161 x 81 at
25 x 8). The two outputs of each case must be bitwise equal; each kernel is
timed by CUDA events in turns: other, this, this, other. Prints one line a
case and the card's name and power limit; with ``--out`` also writes the
times there as JSON.

The ABI this assumes of the other tree, checked before anything is built:
``theta_pde_launch`` and ``heston_adi_launch`` take the parameter types of
this tree's; the other tree's ``_FWD_FIELDS`` (the forward launch's pointer
table) is this tree's; its forward launch reads no ``dims`` entry past this
tree's last (index 7, the route, which a tree without the cluster kernel
does not read); and its θ kernel writes at most the two ints a block of the
counts buffer that this tree's wrapper allocates (a tree that counts only
the solves writes the first).
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

SOURCES = ("theta_pde.cu", "heston_adi.cu")
LAUNCHES = {"theta_pde.cu": "theta_pde_launch", "heston_adi.cu": "heston_adi_launch"}
FORWARD_DIMS = 8  # dims entries this tree's ADI wrapper passes
_P, _I = ctypes.c_void_p, ctypes.c_int


def launch_types(src: str, name: str) -> list[str]:
    """The parameter types of ``extern "C" int name(...)`` in ``src``."""
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    if m is None:
        raise SystemExit(f"pde_in_turns: no extern \"C\" {name} in the other tree")
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


def fwd_fields(path: pathlib.Path) -> tuple:
    """``_FWD_FIELDS`` of an ``ops/heston_adi.py``, read without importing it."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "_FWD_FIELDS"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise SystemExit(f"pde_in_turns: no _FWD_FIELDS in {path}")


def check_abi(other: pathlib.Path) -> None:
    """Stops unless the other tree's launches take this checkout's arguments
    (the ABI in the module's docstring)."""
    for name in SOURCES:
        theirs = (other / "optionslab_tpu_torch" / "csrc" / name).read_text()
        ours = (_build.CSRC / name).read_text()
        if launch_types(theirs, LAUNCHES[name]) != launch_types(ours, LAUNCHES[name]):
            raise SystemExit(f"pde_in_turns: {LAUNCHES[name]} takes other arguments there")
    if fwd_fields(other / "optionslab_tpu_torch" / "ops" / "heston_adi.py") != ha._FWD_FIELDS:
        raise SystemExit("pde_in_turns: the other tree's ADI pointer table differs")
    src = (other / "optionslab_tpu_torch" / "csrc" / "heston_adi.cu").read_text()
    body = src[src.index('extern "C" int heston_adi_launch'):]
    body = body[:body.find('extern "C"', 1)]
    if max(int(k) for k in re.findall(r"dims\[(\d+)\]", body)) >= FORWARD_DIMS:
        raise SystemExit("pde_in_turns: the other tree's ADI launch reads more dims")


def build(csrc: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    """The library of ``csrc``'s PDE kernels, each source by its own nvcc."""
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
    lib.theta_pde_launch.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    lib.theta_pde_launch.restype = _I
    lib.heston_adi_launch.argtypes = [_P, _P, _I, _P]
    lib.heston_adi_launch.restype = _I
    return lib


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, type=pathlib.Path,
                        help="the root of the other tree")
    parser.add_argument("--out", type=pathlib.Path, help="a JSON file for the times")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pde_in_turns: no CUDA device")
    dev = torch.device("cuda", 0)
    check_abi(args.parent)
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"other": build(args.parent / "optionslab_tpu_torch" / "csrc",
                               pathlib.Path(tmp) / "other"),
                "this": build(_build.CSRC, pathlib.Path(tmp) / "this")}
        results = {}
        for tag, fn, iters in [*theta_cases(dev), *adi_cases(dev)]:
            outs = {k: on(lib, fn)() for k, lib in libs.items()}
            torch.cuda.synchronize()
            if not torch.equal(outs["other"], outs["this"]):
                raise SystemExit(f"{tag}: the two trees' kernels differ")
            times = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                times[who].append(cs.event_time(on(libs[who], fn), iters))
            results[tag] = times
            print(f"{tag}: bitwise equal; device ms by CUDA events, in turns [{card}]: other "
                  + " / ".join(f"{t:.4f}" for t in times["other"]) + ", this "
                  + " / ".join(f"{t:.4f}" for t in times["this"])
                  + f"; this / other {min(times['this']) / min(times['other']):.3f}",
                  flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "cases": results}, indent=1))
    print(card)


if __name__ == "__main__":
    main()
