from .harness import (
    BenchmarkEntry,
    ErrorMetrics,
    SpeedMetrics,
    StabilityMetrics,
    VolSurfaceBenchmark,
    compute_epp,
    surface_epp,
)

__all__ = [
    "VolSurfaceBenchmark",
    "ErrorMetrics",
    "SpeedMetrics",
    "StabilityMetrics",
    "BenchmarkEntry",
    "compute_epp",
    "surface_epp",
]
