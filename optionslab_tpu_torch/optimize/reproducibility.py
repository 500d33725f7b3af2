"""Reproducibility kit: seeds, determinism, data hashing, thread pinning.

The port of ``optionslab_tpu/optimize/reproducibility.py``: global seeding
across ``random``, numpy and torch (the card's generators too), SHA256
per-trial seeds, BLAS/OMP thread pinning, seeded CV splitting, data hashing
and the environment fingerprint a study records. ``trial_key`` gives a
seeded ``torch.Generator`` per trial.
"""

from __future__ import annotations

import hashlib
import os
import random

import numpy as np
import torch


def set_global_seed(seed: int = 42) -> None:
    """Seed python, numpy and torch (every CUDA device too), set
    PYTHONHASHSEED, and ask torch for deterministic algorithms (warnings
    only where an op has none)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    torch.cuda.manual_seed_all(seed)
    torch.use_deterministic_algorithms(True, warn_only=True)


def get_trial_seed(base_seed: int, trial_number: int, study_name: str = "") -> int:
    """Deterministic, well-separated per-trial seed via SHA256."""
    payload = f"{study_name}|{base_seed}|{trial_number}".encode()
    return int.from_bytes(hashlib.sha256(payload).digest()[:4], "big")


def trial_key(base_seed: int, trial_number: int, study_name: str = "",
              device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for one trial."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        get_trial_seed(base_seed, trial_number, study_name))


def set_thread_limits(n_threads: int = 1) -> None:
    """Pin BLAS/OMP thread pools for run-to-run determinism."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(n_threads)


def compute_data_hash(data) -> str:
    """SHA256 of array/DataFrame contents."""
    if hasattr(data, "to_csv"):
        payload = data.to_csv(index=False).encode()
    else:
        payload = np.ascontiguousarray(np.asarray(data)).tobytes()
    return hashlib.sha256(payload).hexdigest()


def seeded_kfold(n: int, k: int, seed: int):
    """Deterministic k-fold index generator."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    folds = np.array_split(idx, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val


def environment_fingerprint() -> dict:
    """Versions, the git commit and the device, for study metadata."""
    import platform
    import subprocess
    import sys

    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                                text=True, timeout=5).stdout.strip() or None
    except Exception:
        commit = None
    return {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "git_commit": commit,
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
    }
