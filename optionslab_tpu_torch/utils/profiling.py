"""Device profiling hooks.

``trace(dir)`` records everything in its block with ``torch.profiler`` (the
host and, on a card, its CUDA kernels) and writes a Chrome trace into
``dir``, viewable in Perfetto or ``chrome://tracing``; ``annotate(name)``
marks a region so the kernels group under it in the trace. The wall-clock
registry lives in ``utils.timing``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile everything in the block: ``with trace("traces") as d: run()``;
    the trace lands in ``d/trace.<ns>.json`` when the block ends."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "optionslab_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace.{time.time_ns()}.json"))


def annotate(name: str):
    """Named region for the profiler timeline (usable as a context manager
    or a decorator)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """Per-device live-memory statistics: bytes in use, peak bytes and the
    card's total memory, keyed by device; {"cpu": None} without a card."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
