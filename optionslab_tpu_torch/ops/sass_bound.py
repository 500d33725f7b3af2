"""Instruction-issue lower bound of a path kernel, from its compiled SASS.

The path kernels move next to no bytes, so their least time on the card is
set by how many instructions of each kind one lane-step issues. This module
reads the SASS of the built library (``cuobjdump -sass``), finds a kernel's
loops and counts their instructions by pipe, in one entry point,
:func:`nest_counts`:

* the hot loop is the innermost loop (a backward branch) whose body holds a
  ``MUFU.RSQ``: every trip of it does one Box–Muller, whose ``sqrtf``
  issues one ``MUFU.RSQ``. For the exotic and Heston kernels that is the
  time-step loop (one step of one lane), for the terminal GBM kernel the
  lane loop (one lane). A kernel whose trip takes more square roots than
  the Box–Muller's names their count (the Heston Euler and chain kernels:
  3, one ``sqrtf(v⁺)`` per antithetic branch; the QE kernels: 1 + 6 per
  path system);
* the code a trip skips on its fast path is left out: a region that a
  forward conditional branch jumps over and that holds a call or a loop
  (the slow paths of ``sincosf``, ``sqrtf`` and the divide), unless that
  would leave the loop none of its roots (a guard around the whole draw);
* the ``MUFU.RSQ`` count of what remains over the roots per trip is the
  compiler's unroll factor, and every count is divided by it;
* the bridge-QMC (``sobol_bb``) instances of the Heston kernels run two
  sibling loops per bridge segment, a pre-pass (one Box–Muller per trip)
  and the replay of the same steps (the step itself), so one step costs a
  trip of each;
* a kernel whose lane-step is spread over a loop nest (the QE ladder: one
  warp per path system advances in an inner loop what the whole CUDA block
  drew in the loop around it) weights each loop by its trips per lane-step,
  and may leave out what only that layout needs (shared-memory moves,
  barriers, the loops' addresses and control: :func:`_bookkeeping`), so its
  bound is the function's; a kernel whose lane ends in a large epilogue
  (the multi-asset terminal payoffs) adds the region after its step loop
  once per lane, along its shortest path.

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

import hashlib
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

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?(U?P[0-7T])\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
# a register or predicate an instruction names (not RZ, URZ, PT, UPT), with a
# 64- or 128-bit operand's width
_REG = re.compile(r"\b(U?R\d+|U?P[0-6])\b(\.64|\.128)?")
# shared-memory moves and barriers: a layout's own traffic, not the function's
_SHARED = {"LDS", "LDSM", "STS", "BAR"}
# opcodes that write no register
_NO_DEST = {"ST", "STS", "STG", "STL", "RED", "BAR", "BRA", "BRX", "EXIT", "RET", "CALL", "BSSY",
            "BSYNC", "NOP", "WARPSYNC", "MEMBAR", "DEPBAR", "YIELD", "FENCE", "CCTL", "ERRBAR"}


@dataclass(frozen=True)
class Instr:
    addr: int
    pred: bool  # predicated (@P / @!P)
    op: str  # full opcode with modifiers, e.g. "MUFU.RSQ"
    args: str
    guard: str = ""  # the predicate register of a predicated instruction

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
            current.append(Instr(int(m.group(1), 16), bool(m.group(2)), m.group(4),
                                 m.group(5).strip(), m.group(3) or ""))
    return funcs


def _pipe(instr: Instr) -> str | None:
    if instr.base in _XU:
        return "mufu"
    if instr.base in _FP32:
        return "fp32"
    if instr.base in _INT:
        return "int"
    return None


def _loops(instrs: list[Instr]) -> list[tuple[int, int]]:
    """(lo, hi) of every loop (a backward branch at ``hi`` to ``lo``),
    innermost (smallest span) first."""
    loops = {(t, i.addr) for i in instrs if (t := i.branch_target()) is not None and t < i.addr}
    return sorted(loops, key=lambda ab: ab[1] - ab[0])


def _body(instrs: list[Instr], lo: int, hi: int, loops) -> list[Instr]:
    """The instructions of the loop ``lo..hi`` less the regions inside it that
    a forward conditional branch jumps over and that hold a call or a nested
    loop (the slow paths a trip skips). If that would leave none of the
    loop's own ``MUFU.RSQ`` (those outside its nested loops), the regions
    holding one stay: the branch is around the trip's own draw (a guard
    that is false only past the last step), not around a slow path."""
    calls = [i.addr for i in instrs if i.base == "CALL"]
    nested = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
    roots = [i.addr for i in instrs if i.op.startswith("MUFU.RSQ") and lo <= i.addr <= hi
             and not any(a <= i.addr <= b for a, b in nested)]
    holes = []
    for i in instrs:
        t = i.branch_target()
        if not (i.pred and t is not None and lo <= i.addr < t <= hi):
            continue
        if any(i.addr < c < t for c in calls) or any(
                i.addr < b <= t and a < b for a, b in loops if (a, b) != (lo, hi)):
            holes.append((i.addr, t))

    def inside(x, regions):
        return any(a < x < b for a, b in regions)

    if roots and all(inside(r, holes) for r in roots):
        holes = [(a, b) for a, b in holes if not any(a < r < b for r in roots)]
    return [i for i in instrs if lo <= i.addr <= hi and not inside(i.addr, holes)]


def _rsq_loops(instrs: list[Instr]) -> list[tuple[int, int, list[Instr]]]:
    """(lo, hi, body) of every loop whose body, its skipped regions left out,
    holds a ``MUFU.RSQ``, innermost (smallest span) first."""
    loops = _loops(instrs)
    found = []
    for lo, hi in loops:
        body = _body(instrs, lo, hi, loops)
        if any(i.op.startswith("MUFU.RSQ") for i in body):
            found.append((lo, hi, body))
    if not found:
        raise ValueError("no loop with a MUFU.RSQ (one Box–Muller per trip) in this function")
    return found


def _trip_counts(lo: int, hi: int, body: list[Instr], rsq_per_trip: int) -> dict[str, float]:
    n_rsq = sum(i.op.startswith("MUFU.RSQ") for i in body)
    if not n_rsq:
        raise ValueError(f"the loop 0x{lo:x}..0x{hi:x} holds no MUFU.RSQ of its own")
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


def _enclosing(loops, lo: int, hi: int) -> tuple[int, int] | None:
    """The innermost loop that strictly encloses the span ``lo..hi``."""
    outer = [(a, b) for a, b in loops if a <= lo and hi <= b and (a, b) != (lo, hi)]
    return outer[0] if outer else None


def _shortest_path(region: list[Instr]) -> dict[str, int]:
    """Per-pipe counts of the fewest instructions that a pass from the first
    to the last instruction of ``region`` (in code order) can issue. A
    forward branch may be taken or not; a backward branch (a loop inside the
    region) is never taken, and an unconditional one ends no pass; a branch
    out of the region is not taken, an unconditional one or an ``EXIT`` ends
    the pass there."""
    keys = ("issue", "fp32", "int", "mufu")
    index = {i.addr: n for n, i in enumerate(region)}
    end = (0,) * len(keys)
    dead = (float("inf"),) * len(keys)
    best: list[tuple] = [end] * (len(region) + 1)
    for n in range(len(region) - 1, -1, -1):
        i = region[n]
        t = i.branch_target()
        nexts = []
        if i.base == "BRA":
            inside = t in index
            if inside and t > i.addr:  # forward within the region: may be taken
                nexts.append(best[index[t]])
            elif not i.pred:  # an unconditional jump back (a loop) or out
                nexts.append(dead if inside else end)
            if i.pred:
                nexts.append(best[n + 1])
        elif i.base in ("EXIT", "RET") and not i.pred:
            nexts.append(end)
        else:
            nexts.append(best[n + 1])
        tail = min(nexts)
        own = (1,) + tuple(int(_pipe(i) == k) for k in keys[1:])
        best[n] = tuple(a + b for a, b in zip(own, tail))
    if best[0][0] == float("inf"):
        raise ValueError("no pass through the region")
    return dict(zip(keys, best[0]))


def _regs(operand: str) -> list[str]:
    """The registers an operand names, a 64-bit (128-bit) one as its 2 (4)."""
    out = []
    for m in _REG.finditer(operand):
        out += _widen(m.group(1), {".64": 2, ".128": 4}.get(m.group(2), 1))
    return out


def _widen(reg: str, width: int) -> list[str]:
    if width == 1 or "P" in reg:
        return [reg]
    m = re.fullmatch(r"(U?R)(\d+)", reg)
    return [f"{m.group(1)}{int(m.group(2)) + k}" for k in range(width)]


def _defs_reads(i: Instr) -> tuple[list[str], list[tuple[str, bool]]]:
    """(registers ``i`` writes, [(register it reads, read as a memory
    address)]). The destination is the first operand (a second predicate
    right after it too, as ``ISETP P0, P1`` or a carry ``IADD3 R0, P0``),
    as wide as the opcode's ``.64``/``.WIDE``/``.128``."""
    ops = [o.strip() for o in re.split(r",(?![^\[]*\])", i.args)] if i.args else []
    reads = [(i.guard, False)] if _REG.fullmatch(i.guard) else []
    dests: list[str] = []
    k = 0
    if i.base not in _NO_DEST and ops and _REG.fullmatch(ops[0]):
        width = 4 if ".128" in i.op else 2 if (".64" in i.op or ".WIDE" in i.op) else 1
        dests, k = _widen(ops[0], width), 1
        if len(ops) > 1 and re.fullmatch(r"U?P([0-6]|T)", ops[1]):
            dests += _regs(ops[1])
            k = 2
    for op in ops[k:]:
        reads += [(r, "[" in op) for r in _regs(op)]
    return dests, reads


def _bookkeeping(instrs: list[Instr], lo: int, hi: int, counted: set[int],
                 steering: set[int]) -> set[int]:
    """Addresses of the instructions of ``counted`` (within the loop
    ``lo..hi``) that only serve a layout: shared-memory moves and barriers,
    the branches of ``steering``, and every instruction whose results are
    read, along the region's control flow, only as shared-memory addresses,
    as the predicates of those branches or by other such instructions (a
    buffer's address, a loop's counter and bound; an instruction's read of
    its own result, a counter's increment, is left aside). A result read by a
    skipped slow path, by arithmetic or as the data of a store is the
    function's own; a result read nowhere in the loop may be read after it
    and is kept too."""
    region = [i for i in instrs if lo <= i.addr <= hi]
    index = {i.addr: n for n, i in enumerate(region)}
    n_instr = len(region)
    preds: list[list[int]] = [[] for _ in region]
    for n, i in enumerate(region):
        t = i.branch_target()
        nexts = []
        if i.base == "BRA":
            if t in index:
                nexts.append(index[t])
            if i.pred:
                nexts.append(n + 1)
        elif not (i.base in ("EXIT", "RET") and not i.pred):
            nexts.append(n + 1)
        for m in nexts:
            if m < n_instr:
                preds[m].append(n)
    # reaching definitions, one bit per (instruction, register) written
    info = [_defs_reads(i) for i in region]
    def_at: list[int] = []
    reg_mask: dict[str, int] = {}
    gen = [0] * n_instr
    for n, (dests, _) in enumerate(info):
        for r in dests:
            bit = 1 << len(def_at)
            def_at.append(n)
            gen[n] |= bit
            reg_mask[r] = reg_mask.get(r, 0) | bit
    kill = [0 if region[n].pred else
            sum(reg_mask[r] for r in set(info[n][0])) & ~gen[n] for n in range(n_instr)]
    into, out = [0] * n_instr, [0] * n_instr
    changed = True
    while changed:
        changed = False
        for n in range(n_instr):
            x = 0
            for p in preds[n]:
                x |= out[p]
            y = gen[n] | (x & ~kill[n])
            if x != into[n] or y != out[n]:
                into[n], out[n], changed = x, y, True
    uses: dict[int, list[tuple[int, bool]]] = {}  # defining instruction -> its readers
    for n, (_, reads) in enumerate(info):
        for r, addr in reads:
            bits = into[n] & reg_mask.get(r, 0)
            while bits:
                low = bits & -bits
                uses.setdefault(def_at[low.bit_length() - 1], []).append((n, addr))
                bits ^= low
    book = {n for n, i in enumerate(region)
            if i.addr in counted and (i.base in _SHARED or i.addr in steering)}
    changed = True
    while changed:
        changed = False
        for n, i in enumerate(region):
            if n in book or i.addr not in counted or not info[n][0] or i.base in _NO_DEST:
                continue
            readers = [(m, addr) for m, addr in uses.get(n, []) if m != n]  # not its own next trip
            if readers and all(m in book and (addr or region[m].base != "STS")
                               for m, addr in readers):
                book.add(n)
                changed = True
    return {region[n].addr for n in book}


def nest_counts(instrs: list[Instr], levels, tail: float = 0.0, n_steps: int = 1,
                bookkeeping: bool = True) -> dict[str, float]:
    """Instructions per lane-step of a kernel, by pipe (``fp32``, ``int``,
    ``mufu``) and in all (``issue``), with ``unroll`` and ``span`` (bytes of
    code) per loop and the epilogue's ``tail_issue`` per pass.

    ``levels`` = ``((rsq_per_trip, weight), ...)``: level 0 is the innermost
    ``MUFU.RSQ`` loop, level j + 1 the loop that encloses level j. Each level
    is counted as its body less the level inside it and its own skipped
    regions, per trip (its ``MUFU.RSQ`` count over ``rsq_per_trip`` is the
    compiler's unroll; a count that is not a multiple is refused), times
    ``weight``, its trips per lane-step. A step loop alone is
    ``((roots, 1),)``. A pair ``rsq_per_trip`` at level 0 names two sibling
    loops, in code order, each run once per step: a bridge kernel's
    pre-pass and replay. The split QE ladder: ``((6, 7), (1, 1))``, the
    advance loop (one system pair a trip) 7 times and the chunk loop that
    draws once.

    ``tail``: passes per lane of the region after the outermost level's
    loop, up to the end of the loop that encloses it (or of the function),
    over the lane's ``n_steps``: the payoff and moments of a lane that is
    carried through its steps. That region is counted along its shortest
    path (:func:`_shortest_path`), so code behind a runtime argument (a
    payoff kind) never raises the bound.

    ``bookkeeping=False`` leaves out what only the kernel's layout needs
    (:func:`_bookkeeping`): shared-memory moves, barriers, and the
    addresses, counters and branches of the levels' loops."""
    loops = _loops(instrs)
    found = _rsq_loops(instrs)
    roots0, weight0 = levels[0]
    if isinstance(roots0, tuple):
        inner = sorted((lo, hi, body) for lo, hi, body in found
                       if not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b, _ in found))
        if len(inner) != len(roots0):
            raise ValueError(f"level 0 names {len(roots0)} sibling MUFU.RSQ loops, "
                             f"found {len(inner)}")
        parts = [(lo, hi, body, rsq, weight0) for (lo, hi, body), rsq in zip(inner, roots0)]
    else:
        parts = [(*found[0], roots0, weight0)]
    ranges = [(lo, hi) for lo, hi, *_ in parts]
    for j, (rsq, weight) in enumerate(levels[1:], 1):
        span = (min(a for a, _ in ranges), max(b for _, b in ranges))
        found_j = _enclosing(loops, *span)
        if found_j is None:
            raise ValueError(f"level {j}: no loop encloses 0x{span[0]:x}..0x{span[1]:x}")
        lo, hi = found_j
        body = [i for i in _body(instrs, lo, hi, loops)
                if not any(a <= i.addr <= b for a, b in ranges)]
        parts.append((lo, hi, body, rsq, weight))
        ranges.append((lo, hi))
    lo, hi = min(a for a, _ in ranges), max(b for _, b in ranges)
    if not bookkeeping:
        level_loops = [(a, b) for a, b, *_ in parts]
        steering = {b for _, b in level_loops}  # each loop's backward branch
        for i in instrs:  # a branch around a whole inner level: its zero-trip test
            t = i.branch_target()
            if i.pred and t is not None and any(i.addr < a and b < t for a, b in level_loops):
                steering.add(i.addr)
        counted = {i.addr for _, _, body, _, _ in parts for i in body}
        book = _bookkeeping(instrs, lo, hi, counted, steering)
        parts = [(a, b, [i for i in body if i.addr not in book], rsq, weight)
                 for a, b, body, rsq, weight in parts]
    out = {k: 0.0 for k in PIPE_RATE}
    unrolls, spans = [], []
    for a, b, body, rsq, weight in parts:
        counts = _trip_counts(a, b, body, rsq)
        for k in PIPE_RATE:
            out[k] += weight * counts[k]
        unrolls.append(counts["unroll"])
        spans.append(counts["span"])
    tail_issue = 0
    if tail:
        outer = _enclosing(loops, lo, hi)
        stop = outer[1] if outer else instrs[-1].addr
        counts = _shortest_path([i for i in instrs if hi < i.addr <= stop])
        for k in PIPE_RATE:
            out[k] += tail / n_steps * counts[k]
        tail_issue = counts["issue"]
    out.update(unroll=tuple(unrolls), span=tuple(spans), tail_issue=tail_issue)
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


def digest(funcs: dict[str, list[Instr]], *parts: str) -> tuple[int, str]:
    """(count, SHA-256) of the code of the functions whose mangled names
    contain every string of ``parts``, taken in the order of their names less
    their anonymous namespace: two builds whose digests agree compiled those
    functions to the same instructions (:func:`compare` without the second
    listing at hand)."""
    picked = sorted((_unit_free(n), v) for n, v in funcs.items() if all(p in n for p in parts))
    h = hashlib.sha256()
    for name, instrs in picked:
        h.update(name.encode())
        for i in instrs:
            h.update(f"{i.addr:x} {i.pred} {i.op} {i.args};".encode())
    return len(picked), h.hexdigest()


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
