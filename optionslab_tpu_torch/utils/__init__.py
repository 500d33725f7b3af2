from .config import DEFAULT_DTYPE, EPS_TIME, EPS_VOL, as_tensors
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
from .logging import get_logger
from .timing import Timer, get_timings, reset_timings
from .validation import check_non_negative, check_option_type, check_positive

__all__ = [
    "DEFAULT_DTYPE",
    "EPS_TIME",
    "EPS_VOL",
    "as_tensors",
    "OptionsLabTPUError",
    "ValidationError",
    "CalibrationError",
    "ConvergenceError",
    "ArbitrageViolationError",
    "DataError",
    "ModelError",
    "DependencyError",
    "get_logger",
    "Timer",
    "get_timings",
    "reset_timings",
    "check_positive",
    "check_non_negative",
    "check_option_type",
]
