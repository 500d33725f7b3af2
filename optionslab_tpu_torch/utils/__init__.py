from .checkpoint import restore_pytree, save_pytree
from .config import DEFAULT_DTYPE, DEFAULT_SEED, EPS_TIME, EPS_VOL, as_tensors, resolve_dtype
from .exceptions import (
    ArbitrageViolationError,
    CalibrationError,
    ConvergenceError,
    DataError,
    DependencyError,
    ModelError,
    OptionsLabTPUError,
    ValidationError,
)
from .logging import get_logger, setup_logging
from .profiling import annotate, device_memory_stats, trace
from .timing import Timer, benchmark_fn, get_timings, reset_timings, timed
from .validation import (
    check_non_negative,
    check_option_type,
    check_positive,
    check_required_columns,
)

__all__ = [
    "DEFAULT_DTYPE",
    "DEFAULT_SEED",
    "EPS_TIME",
    "EPS_VOL",
    "as_tensors",
    "resolve_dtype",
    "OptionsLabTPUError",
    "ValidationError",
    "CalibrationError",
    "ConvergenceError",
    "ArbitrageViolationError",
    "DataError",
    "ModelError",
    "DependencyError",
    "setup_logging",
    "save_pytree",
    "restore_pytree",
    "trace",
    "annotate",
    "device_memory_stats",
    "get_logger",
    "timed",
    "Timer",
    "benchmark_fn",
    "get_timings",
    "reset_timings",
    "check_required_columns",
    "check_positive",
    "check_non_negative",
    "check_option_type",
]
