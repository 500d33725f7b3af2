"""Build the CUDA sources of ``csrc/`` with ``nvcc`` and load them with ctypes.

One library holds every kernel. It is compiled once per content hash of
``csrc/*`` and the build flags, into ``optionslab_tpu_torch/_build/<hash>/``;
later calls and later processes load the cached file. Each ``.cu`` source is
compiled to an object by its own ``nvcc``, all started together, and the
objects are then linked. The sources have a plain C interface (no PyTorch
headers). Nothing here runs at import time: the CPU-only test environment
imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "liboptionslab_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", name)] if home else []
    candidates += [shutil.which(name) or "", f"/usr/local/cuda/bin/{name}"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(f"{name} not found: set CUDA_HOME or put {name} on PATH")


def _run_nvcc(procs) -> None:
    for cmd, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{stdout}{stderr}")


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: concurrent processes never load a
    # half-written library
    tmp_dir = Path(tempfile.mkdtemp(dir=out.parent))
    procs = []
    try:
        objects = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp_dir / (src.stem + ".o")
            cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objects.append(str(obj))
        _run_nvcc(procs)
        lib = tmp_dir / LIB_NAME
        cmd = [cuda_tool("nvcc"), "-shared", "-o", str(lib), *objects]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True))]
        _run_nvcc(procs)
        os.replace(lib, out)
    finally:
        for _cmd, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp_dir, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gbm_mc_moments.argtypes = [
        _P, _P, _P, _P, _P, _P, _P,  # s0, k, cp, a, s, rep_id, cid
        _U, _U,                      # seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _I, _I, _I,              # rows, active_rows, lanes, reps
        _I, _I,                      # sampler, greeks
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.gbm_mc_moments.restype = _I
    lib.exotic_mc_moments.argtypes = [
        _P, _P, _I,                  # params, book, nc
        _U, _U,                      # seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _I, _F,                  # n_steps, period, cp
        _I, _I, _I, _I, _I,          # family, mode, sampler, lr, n_mom
        _P, _P,                      # plan ints, plan floats (host arrays)
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.exotic_mc_moments.restype = _I
    lib.exotic_greeks_moments.argtypes = [
        _P, _U, _U,                  # params, seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _F, _I, _I,              # n_steps, cp, kind, sampler
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.exotic_greeks_moments.restype = _I
    lib.heston_mc_moments.argtypes = [
        _P, _U, _U,                  # params, seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _F, _I, _I,              # n_steps, cp, mode, sampler
        _P, _P,                      # plan ints, plan floats (host arrays)
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.heston_mc_moments.restype = _I
    lib.heston_qe_moments.argtypes = [
        _P, _U, _U,                  # params, seed, block0
        _I, _I, _I,                  # n_blocks, units_per_chunk, n_chunks
        _I, _F, _I, _I,              # n_steps, cp, n_sets, sampler
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.heston_qe_moments.restype = _I
    lib.heston_qe_occupancy.argtypes = [_I, _I, _I, _P, _P]  # n_sets, sampler, device, out ×2
    lib.heston_qe_occupancy.restype = _I
    lib.heston_qe_ladder_plan.argtypes = [_I, _P, _P]  # n_blocks, out n_chunks, units_per_chunk
    lib.heston_qe_ladder_plan.restype = _I
    lib.heston_chain_moments.argtypes = [
        _P, _P, _P, _P, _P,          # head, dt, sqrt_dt, strikes, cps
        _P, _P, _I,                  # exp_ptr, exp_quote, n_quotes
        _U, _U,                      # seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _I,                      # n_steps, sampler
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.heston_chain_moments.restype = _I
    lib.heston_exotic_moments.argtypes = [
        _P, _P, _I,                  # params, book, nc
        _U, _U,                      # seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _I, _F,                  # n_steps, period, cp
        _I, _I, _I, _I,              # family, mode, scheme, jumps
        _I, _I, _I,                  # sampler, lr, n_mom
        _P, _P,                      # plan ints, plan floats (host arrays)
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.heston_exotic_moments.restype = _I
    lib.local_vol_moments.argtypes = [
        _P, _U, _U,                  # params, seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _F,                      # n_steps, cp
        _I, _I, _I, _I, _I,          # family, mode, sampler, greeks, n_mom
        _P, _P,                      # plan ints, plan floats (host arrays)
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.local_vol_moments.restype = _I
    lib.slv_moments.argtypes = [
        _P, _U, _U,                  # params, seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _I, _F,                  # n_steps, period, cp
        _I, _I, _I, _I, _I,          # family, mode, sampler, lr, n_mom
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.slv_moments.restype = _I
    lib.multi_asset_moments.argtypes = [
        _P, _I, _U, _U,              # params, n_params, seed, block0
        _I, _I, _I,                  # n_blocks, blocks_per_chunk, n_chunks
        _I, _I, _I, _F,              # d, kind, n_steps, cp
        _I, _I, _I,                  # sampler, lr, n_mom
        _P, _P,                      # partials, out
        _I, _P,                      # device, stream
    ]
    lib.multi_asset_moments.restype = _I
    lib.multi_asset_plan.argtypes = [_I, _I, _P, _P]  # n_blocks, n_steps, out n_chunks, per
    lib.multi_asset_plan.restype = _I
    lib.multi_asset_occupancy.argtypes = [_I, _I, _I, _I, _I,  # d, asian, lr, sampler, device
                                          _P, _P, _P]  # out registers, local bytes, blocks/SM
    lib.multi_asset_occupancy.restype = _I
    lib.tridiag_solve_launch.argtypes = [
        _P, _P, _P, _P, _P,          # lower, diag, upper, rhs, x
        _P,                          # strides (host int64[10])
        _I, _I, _I, _I,              # batch, n, systems per block, dtype
        _I, _P,                      # device, stream
    ]
    lib.tridiag_solve_launch.restype = _I
    lib.tridiag_chain_launch.argtypes = [_P, _P, _I, _I, _I, _P]  # abcd, out, n, dtype, dev, st
    lib.tridiag_chain_launch.restype = _I
    lib.tridiag_rhs_chain_launch.argtypes = [  # abcd, out, n, back nodes, dtype, dev, st
        _P, _P, _I, _I, _I, _I, _P]
    lib.tridiag_rhs_chain_launch.restype = _I
    lib.tridiag_fma_chain_launch.argtypes = [  # abcd, out, n, ahead, dtype, dev, st
        _P, _P, _I, _I, _I, _I, _P]
    lib.tridiag_fma_chain_launch.restype = _I
    lib.tridiag_warp_probe_launch.argtypes = [_P, _P, _I, _I, _I, _I, _P]  # abcd, out, n, kind
    lib.tridiag_warp_probe_launch.restype = _I
    lib.tridiag_div_check_launch.argtypes = [
        _P, _P, _P, _P,              # num, den, out, counts (uint64[3])
        ctypes.c_int64, _I, _I, _P,  # n, dtype, device, stream
    ]
    lib.tridiag_div_check_launch.restype = _I
    lib.theta_pde_launch.argtypes = [
        _P, _P, _P, _P,              # lower, diag, upper, coef (a, b, c, w)
        _P, _P, _P,                  # psi, v0, ends
        _P, _P,                      # out, counts (2, blocks): solves, pivot nodes
        _P, _P,                      # history: solutions, exercise sets (or null)
        _I, _I, _I, _I, _I, _I,      # batch, n, n_time, mode, systems per block, dtype
        _I, _P,                      # device, stream
    ]
    lib.theta_pde_launch.restype = _I
    lib.theta_jump_launch.argtypes = [
        _P, _P, _P, _P,              # lower, diag, upper, coef (a, b, c, w)
        _P, _P, _P,                  # psi, v0, ends
        _P, _P,                      # out, counts (2, batch): solves, re-formed rows
        _P, _P, _P,                  # jump table: at (or null), index, weight
        _P, _I,                      # workspace (or null), jumps
        _I, _I, _I, _I, _I, _I,      # batch, n, n_time, mode, contracts per block, dtype
        _I, _P,                      # device, stream
    ]
    lib.theta_jump_launch.restype = _I
    lib.theta_pde_adjoint_launch.argtypes = [
        _P, _P, _P, _P,              # lower, diag, upper, coef (a, b, c, w)
        _P, _P,                      # psi, v0
        _P, _P, _P,                  # history: solutions, exercise sets; the gradient
        _P, _P, _P,                  # gradients: grid (5, batch, n), coef, ends
        _P,                          # the device route's workspace (or null)
        _I, _I, _I, _I, _I, _I,      # batch, n, n_time, mode, systems per block, dtype
        _I, _P,                      # device, stream
    ]
    lib.theta_pde_adjoint_launch.restype = _I
    lib.lv_pde_launch.argtypes = [
        _P, _P, _P, _P,              # lower, diag, upper (batch, n_time, n), ends
        _P, _P, _P, _P,              # psi, v0, out, Bermudan slices (or null)
        _P,                          # workspace (or null)
        _I, _I, _I, _I, _I, _I, _I,  # batch, n, n_time, mode, steps a date, ring slots, dtype
        _I, _P,                      # device, stream
    ]
    lib.lv_pde_launch.restype = _I
    for name in ("heston_adi_launch", "heston_adi_adjoint_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _I, _P]  # pointers (host int64[]), dims (host int32[]), dev, st
        fn.restype = _I
    lib.gbm_mc_error_string.argtypes = [_I]
    lib.gbm_mc_error_string.restype = ctypes.c_char_p
    return lib


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    return BUILD_DIR / _digest() / LIB_NAME


def load_library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use."""
    global _lib, _build_seconds
    with _lock:
        if _lib is None:
            path = library_path()
            t0 = time.perf_counter()
            if not path.exists():
                _compile(path)
            _build_seconds = time.perf_counter() - t0
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def build_seconds() -> float | None:
    """Seconds the first :func:`load_library` call in this process took
    (compile included when the cache was cold); None before it."""
    return _build_seconds


def error_string(code: int) -> str:
    return load_library().gbm_mc_error_string(code).decode()
