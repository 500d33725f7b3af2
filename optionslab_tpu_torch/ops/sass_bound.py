"""Instruction-issue lower bound of a path kernel, from its compiled SASS.

The path kernels move next to no bytes, so their least time on the card is
set by how many instructions of each kind one loop trip issues. This module
reads the SASS of the built library (``cuobjdump -sass``), finds a kernel's
hot loop and counts its instructions by pipe:

* the hot loop is the innermost loop (a backward branch) whose body holds a
  ``MUFU.RSQ``: every trip of it does one Box–Muller, whose ``sqrtf``
  issues one ``MUFU.RSQ``. For the exotic and Heston kernels that is the
  time-step loop (one step of one lane), for the terminal GBM kernel the
  lane loop (one lane). A kernel whose trip takes more square roots than
  the Box–Muller's names their count, ``rsq_per_trip`` (the Heston Euler
  and chain kernels: 3, one ``sqrtf(v⁺)`` per antithetic branch; the QE
  kernels: 1 + 6 per path system);
* the code a trip skips on its fast path is left out: a region that a
  forward conditional branch jumps over and that holds a call or a loop
  (the slow paths of ``sincosf``, ``sqrtf`` and the divide);
* the ``MUFU.RSQ`` count of what remains over ``rsq_per_trip`` is the
  compiler's unroll factor, and every count is divided by it;
* the bridge-QMC (``sobol_bb``) instances of the Heston kernels run two
  loops per bridge segment, a pre-pass (one Box–Muller per trip) and the
  replay of the same steps (the step itself), so one step costs a trip of
  each: :func:`two_pass_counts` finds both and adds their per-trip counts.

Code behind a branch on a runtime argument (a kernel family's mode) is
counted as if it ran, so a kernel whose step loop holds such code gets a
bound above its least time; the kernels keep that code out of their loops.

Pipe rates per SM and clock for compute capability 9.0 (CUDA C++
Programming Guide, throughput of native arithmetic instructions): 128 for
FP32 add/multiply/FMA, 64 for 32-bit integer add/multiply/shift/logic/compare,
16 for the multi-function unit (transcendentals) and for float↔int
conversions, and 4 warp instructions (128 thread instructions) issued per SM
and clock. The bound of a launch is its trip count times the busiest pipe's
count over that pipe's rate, over SMs × SM clock.
"""

from __future__ import annotations

import re
import subprocess
from dataclasses import dataclass
from pathlib import Path

PIPE_RATE = {"fp32": 128, "int": 64, "mufu": 16, "issue": 128}

_FP32 = {"FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FCHK", "FRND", "FSWZADD", "HFMA2",
         "HADD2", "HMUL2", "FSET"}
_INT = {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP", "IMNMX",
        "SEL", "PRMT", "FLO", "POPC", "BREV", "I2FP", "IABS", "VIADD", "VIMNMX", "PLOP3", "P2R",
        "R2P", "MOV", "IDP", "BMSK", "SGXT"}
_XU = {"MUFU", "I2F", "F2I", "F2F", "I2I"}

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[0-7T]\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


@dataclass(frozen=True)
class Instr:
    addr: int
    pred: bool  # predicated (@P / @!P)
    op: str  # full opcode with modifiers, e.g. "MUFU.RSQ"
    args: str

    @property
    def base(self) -> str:
        return self.op.split(".")[0]

    def branch_target(self) -> int | None:
        if self.base != "BRA":
            return None
        m = re.search(r"0x([0-9a-f]+)", self.args)
        return int(m.group(1), 16) if m else None


def parse_functions(sass: str) -> dict[str, list[Instr]]:
    """``{mangled name: [Instr]}`` of a ``cuobjdump -sass`` listing."""
    funcs: dict[str, list[Instr]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = funcs.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = _LINE.search(line)
        if m and current is not None:
            current.append(Instr(int(m.group(1), 16), bool(m.group(2)), m.group(3),
                                 m.group(4).strip()))
    return funcs


def _pipe(instr: Instr) -> str | None:
    if instr.base in _XU:
        return "mufu"
    if instr.base in _FP32:
        return "fp32"
    if instr.base in _INT:
        return "int"
    return None


def _rsq_loops(instrs: list[Instr]) -> list[tuple[int, int, list[Instr]]]:
    """(lo, hi, body) of every loop whose body, its skipped regions left out,
    holds a ``MUFU.RSQ``, innermost (smallest span) first."""
    loops = [(t, i.addr) for i in instrs if (t := i.branch_target()) is not None and t < i.addr]
    calls = [i.addr for i in instrs if i.base == "CALL"]

    def skipped(lo: int, hi: int) -> list[tuple[int, int]]:
        """Regions inside (lo, hi] that a forward conditional branch jumps
        over and that hold a call or a nested loop."""
        out = []
        for i in instrs:
            t = i.branch_target()
            if not (i.pred and t is not None and lo <= i.addr < t <= hi):
                continue
            if any(i.addr < c < t for c in calls) or any(
                    i.addr < b <= t and a < b for a, b in loops if (a, b) != (lo, hi)):
                out.append((i.addr, t))
        return out

    found = []
    for lo, hi in sorted(set(loops), key=lambda ab: ab[1] - ab[0]):
        holes = skipped(lo, hi)
        body = [i for i in instrs if lo <= i.addr <= hi
                and not any(a < i.addr < b for a, b in holes)]
        if any(i.op.startswith("MUFU.RSQ") for i in body):
            found.append((lo, hi, body))
    if not found:
        raise ValueError("no loop with a MUFU.RSQ (one Box–Muller per trip) in this function")
    return found


def _trip_counts(lo: int, hi: int, body: list[Instr], rsq_per_trip: int) -> dict[str, float]:
    n_rsq = sum(i.op.startswith("MUFU.RSQ") for i in body)
    if n_rsq % rsq_per_trip:
        raise ValueError(f"the hot loop 0x{lo:x}..0x{hi:x} holds {n_rsq} MUFU.RSQ, not a "
                         f"multiple of {rsq_per_trip} per trip")
    unroll = n_rsq // rsq_per_trip
    counts = {"fp32": 0, "int": 0, "mufu": 0, "issue": len(body)}
    for i in body:
        pipe = _pipe(i)
        if pipe is not None:
            counts[pipe] += 1
    out = {k: v / unroll for k, v in counts.items()}
    out.update(unroll=unroll, span=hi - lo)
    return out


def hot_loop_counts(instrs: list[Instr], rsq_per_trip: int = 1) -> dict[str, float]:
    """Instructions per trip of the hot loop (the innermost loop with a
    ``MUFU.RSQ``), by pipe (``fp32``, ``int``, ``mufu``) and in all
    (``issue``), with ``unroll`` and the loop's ``span`` in bytes of code.
    ``rsq_per_trip``: the ``MUFU.RSQ`` count of one trip; a loop whose count
    is not a multiple of it is refused."""
    return _trip_counts(*_rsq_loops(instrs)[0], rsq_per_trip)


def two_pass_counts(instrs: list[Instr], rsq_per_trip=(1, 3)) -> dict[str, float]:
    """Instructions per time step of a two-pass bridge kernel (``sobol_bb``):
    every bridge segment runs a pre-pass loop (one Box–Muller per trip, the
    residuals' sums) and then a replay loop (the step itself) over the same
    steps, so one step costs one trip of each. The two loops are the
    innermost ``MUFU.RSQ`` loops that hold no other such loop, in code order;
    ``rsq_per_trip`` gives each one's roots per trip. Returns the per-pipe
    sums of both loops' per-trip counts, with ``unroll`` and ``span`` per
    loop."""
    found = _rsq_loops(instrs)
    inner = [(lo, hi, body) for lo, hi, body in found
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b, _ in found)]
    if len(inner) != 2:
        raise ValueError(f"a two-pass kernel has two innermost MUFU.RSQ loops, found {len(inner)}")
    passes = [_trip_counts(lo, hi, body, rsq)
              for (lo, hi, body), rsq in zip(sorted(inner), rsq_per_trip)]
    out = {k: passes[0][k] + passes[1][k] for k in PIPE_RATE}
    out.update(unroll=tuple(p["unroll"] for p in passes), span=tuple(p["span"] for p in passes))
    return out


def pipe_ms(counts: dict[str, float], trips: float, n_sm: int, clock_hz: float) -> dict:
    """Milliseconds each pipe needs for ``trips`` loop trips at ``counts`` per trip."""
    return {p: counts[p] * trips / (PIPE_RATE[p] * n_sm * clock_hz) * 1e3 for p in PIPE_RATE}


def bound_ms(counts: dict[str, float], trips: float, n_sm: int, clock_hz: float):
    """(ms, busiest pipe) of ``trips`` loop trips at ``counts`` per trip."""
    per_pipe = pipe_ms(counts, trips, n_sm, clock_hz)
    pipe = max(per_pipe, key=per_pipe.get)
    return per_pipe[pipe], pipe


def dump_sass(library: Path, cuobjdump: str = "cuobjdump") -> str:
    """``cuobjdump -sass`` of a built library."""
    proc = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True)
    return proc.stdout


def find_function(funcs: dict[str, list[Instr]], *parts: str) -> list[Instr]:
    """The one function whose mangled name contains every string of ``parts``."""
    hits = [name for name in funcs if all(p in name for p in parts)]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} functions match {parts}: {hits[:4]}")
    return funcs[hits[0]]


def _unit_free(name: str) -> str:
    """A mangled name without its anonymous namespace, whose name nvcc derives
    from the translation unit: ``<length>_GLOBAL__N_...`` is cut by its length."""
    m = re.search(r"(\d+)_GLOBAL__N_", name)
    if m is None:
        return name
    return name[:m.start()] + name[m.start(1) + len(m.group(1)) + int(m.group(1)):]


def compare(funcs_a: dict[str, list[Instr]], funcs_b: dict[str, list[Instr]],
            *parts: str) -> dict:
    """The functions of two listings whose mangled names contain every string
    of ``parts``: how many each listing has, how many are the same code in
    both (every instruction's address, predication, opcode and operands), and
    each listing's instruction total over them. Functions are paired by name
    less their anonymous namespace."""
    a, b = ({_unit_free(n): v for n, v in f.items() if all(p in n for p in parts)}
            for f in (funcs_a, funcs_b))
    return {"functions": [len(a), len(b)],
            "same": sum(n in b and a[n] == b[n] for n in a),
            "instructions": [sum(map(len, f.values())) for f in (a, b)]}


def main(argv: list[str] | None = None) -> None:
    """``python -m optionslab_tpu_torch.ops.sass_bound LIB_A LIB_B PART...``:
    one JSON line per PART, :func:`compare` of the two built libraries'
    listings over the functions whose names contain it."""
    import json
    import sys

    from ._build import cuda_tool

    lib_a, lib_b, *parts = sys.argv[1:] if argv is None else argv
    funcs = [parse_functions(dump_sass(Path(lib), cuda_tool("cuobjdump")))
             for lib in (lib_a, lib_b)]
    for part in parts:
        print(json.dumps({"part": part, **compare(*funcs, part)}))


if __name__ == "__main__":
    main()
