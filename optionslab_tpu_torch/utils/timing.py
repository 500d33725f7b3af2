"""Wall-clock timing with a registry that the server's ``/metrics`` reads.

CUDA work is asynchronous, so :class:`Timer` synchronizes the card before it
reads the clock: a timing covers the device work, not only its enqueue.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch

_TIMINGS: dict[str, list[float]] = defaultdict(list)
_LOCK = threading.Lock()


def _sync() -> None:
    # no CUDA context yet means no CUDA work can be pending
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Context manager: ``with Timer("solve") as t: ...; t.ms``."""

    def __init__(self, label: str = ""):
        self.label = label
        self.ms = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if self.label:
            with _LOCK:
                _TIMINGS[self.label].append(self.ms)
        return False


def get_timings() -> dict[str, list[float]]:
    """All recorded timings (ms) keyed by label."""
    with _LOCK:
        return {k: list(v) for k, v in _TIMINGS.items()}


def reset_timings() -> None:
    with _LOCK:
        _TIMINGS.clear()
