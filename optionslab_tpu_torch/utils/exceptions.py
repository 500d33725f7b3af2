"""Exception hierarchy: one library base class with focused subclasses, the
same tree as ``optionslab_tpu.utils.exceptions`` so callers catch the same
names."""

from __future__ import annotations


class OptionsLabTPUError(Exception):
    """Base class for every error raised by the library."""


class ValidationError(OptionsLabTPUError, ValueError):
    """Invalid user input: bad shapes, negative prices, unknown option type."""


class CalibrationError(OptionsLabTPUError, RuntimeError):
    """A model calibration failed to converge or produced invalid parameters."""


class ConvergenceError(OptionsLabTPUError, RuntimeError):
    """An iterative solver (IV Newton, PDE stepper) failed to converge."""


class ArbitrageViolationError(OptionsLabTPUError, ValueError):
    """Quoted prices violate static no-arbitrage bounds (e.g. IV inversion)."""


class DataError(OptionsLabTPUError, ValueError):
    """Malformed or missing market data (columns, NaNs, empty chains)."""


class ModelError(OptionsLabTPUError, RuntimeError):
    """A model was used before training / with incompatible features."""


class DependencyError(OptionsLabTPUError, ImportError):
    """An optional dependency is not installed."""
