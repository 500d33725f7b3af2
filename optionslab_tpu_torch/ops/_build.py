"""Build the CUDA sources of ``csrc/`` with ``nvcc`` and load them with ctypes.

The library is compiled once per content hash of ``csrc/*`` and the build
flags, into ``optionslab_tpu_torch/_build/<hash>/``; later calls and later
processes load the cached file. The sources have a plain C interface (no
PyTorch headers), so a build takes seconds, not minutes. Nothing here runs
at import time: the CPU-only test environment imports every module.
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
LIB_NAME = "libgbm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_seconds: float | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: concurrent processes never load a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


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
    lib.gbm_mc_error_string.argtypes = [_I]
    lib.gbm_mc_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The compiled kernel library, built on first use."""
    global _lib, _build_seconds
    with _lock:
        if _lib is None:
            path = BUILD_DIR / _digest() / LIB_NAME
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
