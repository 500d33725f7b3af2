"""Wall-clock timing with a registry that the server's ``/metrics`` reads.

CUDA work is asynchronous, so :class:`Timer`, :func:`timed` and
:func:`benchmark_fn` synchronize the card before they read the clock: a
timing covers the device work, not only its enqueue.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from typing import Callable

import torch

_TIMINGS: dict[str, list[float]] = defaultdict(list)
_LOCK = threading.Lock()


def _sync() -> None:
    # no CUDA context yet means no CUDA work can be pending
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _record(label: str, ms: float) -> None:
    with _LOCK:
        _TIMINGS[label].append(ms)


def timed(label: str | None = None) -> Callable:
    """Decorator: record the synchronized wall-clock ms of each call under
    ``label`` (default: the function's qualified name)."""

    def deco(fn: Callable) -> Callable:
        key = label or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            _record(key, (time.perf_counter() - t0) * 1e3)
            return out

        return wrapper

    return deco


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
            _record(self.label, self.ms)
        return False


def get_timings() -> dict[str, list[float]]:
    """All recorded timings (ms) keyed by label."""
    with _LOCK:
        return {k: list(v) for k, v in _TIMINGS.items()}


def reset_timings() -> None:
    with _LOCK:
        _TIMINGS.clear()


def benchmark_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10, **kwargs) -> dict:
    """Latency harness: warm up (at least once: the first call builds the
    kernels), then time ``iters`` synchronized calls. Returns mean/p50/p95/
    min in ms."""
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    samples = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()
    n = len(samples)
    return {
        "mean_ms": sum(samples) / n,
        "p50_ms": samples[n // 2],
        "p95_ms": samples[min(n - 1, int(0.95 * n))],
        "min_ms": samples[0],
        "iters": n,
    }
