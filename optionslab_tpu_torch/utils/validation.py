"""Input validation helpers."""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .exceptions import DataError, ValidationError


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def check_required_columns(df, required: Iterable[str]) -> None:
    """Raise DataError if any required column is missing from a frame: any
    object with a ``columns`` collection (a pandas DataFrame among them)."""
    missing = [c for c in required if c not in df.columns]
    if missing:
        raise DataError(f"missing required columns: {missing}")


def check_positive(name: str, value) -> None:
    arr = _numpy(value)
    if np.any(~np.isfinite(arr)) or np.any(arr <= 0):
        raise ValidationError(f"{name} must be positive and finite, got {value!r}")


def check_non_negative(name: str, value) -> None:
    arr = _numpy(value)
    if np.any(~np.isfinite(arr)) or np.any(arr < 0):
        raise ValidationError(f"{name} must be >= 0 and finite, got {value!r}")


def check_option_type(option_type) -> int:
    """Normalize an option type to cp = +1 (call) / -1 (put)."""
    if isinstance(option_type, str):
        t = option_type.lower()
        if t in ("call", "c"):
            return 1
        if t in ("put", "p"):
            return -1
        raise ValidationError(f"unknown option type {option_type!r}")
    v = int(option_type)
    if v in (1, -1):
        return v
    raise ValidationError(f"option type must be 'call'/'put'/+1/-1, got {option_type!r}")
