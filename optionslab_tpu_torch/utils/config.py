"""Dtype policy, env-driven constants, feature flags and numerical floors.

Compute defaults to float32. Every public function follows the dtype of its
tensor inputs, so float64 tensors give float64 results (the closed forms are
checked that way against the JAX package).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

# Env-driven constants, the same names and defaults as the JAX package's.
DATA_DIR = os.environ.get("OPTIONSLAB_DATA_DIR", "data")
MODEL_DIR = os.environ.get("OPTIONSLAB_MODEL_DIR", "models")
DEFAULT_SEED = int(os.environ.get("OPTIONSLAB_SEED", "42"))
DEFAULT_BATCH_SIZE = int(os.environ.get("OPTIONSLAB_BATCH_SIZE", "1024"))
DEFAULT_EPOCHS = int(os.environ.get("OPTIONSLAB_EPOCHS", "200"))

DEFAULT_DTYPE = torch.float32

# Numerical floors shared across pricers.
EPS_TIME = 1e-10  # treat maturities below this as expired
EPS_VOL = 1e-12  # treat vols below this as deterministic


def _dtype_of(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    if isinstance(a, (bool, int, float, complex)):
        return None  # a weak python scalar takes no part in the promotion
    try:
        return torch.from_numpy(np.zeros(0, np.asarray(a).dtype)).dtype
    except TypeError:  # a dtype torch has no counterpart for
        return None


def resolve_dtype(*args, default=None) -> torch.dtype:
    """Result dtype for a pricer given its inputs: the promotion of the
    floating dtypes among tensors and arrays, else ``default`` (else
    :data:`DEFAULT_DTYPE`) when every input is a python scalar."""
    floats = [d for d in map(_dtype_of, (a for a in args if a is not None))
              if d is not None and d.is_floating_point]
    if not floats:
        return default or DEFAULT_DTYPE
    out = floats[0]
    for d in floats[1:]:
        out = torch.promote_types(out, d)
    return out


def as_tensors(*args, dtype=None, device=None) -> list[torch.Tensor]:
    """Convert scalars and tensors to tensors of one floating dtype.

    The dtype is ``dtype`` if given, else the promotion of the floating
    tensor arguments, else :data:`DEFAULT_DTYPE`; the device is ``device``
    if given, else that of the first tensor argument.
    """
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if dtype is None:
        floats = [t.dtype for t in tensors if t.is_floating_point()]
        dtype = DEFAULT_DTYPE
        if floats:
            dtype = floats[0]
            for d in floats[1:]:
                dtype = torch.promote_types(dtype, d)
    if device is None and tensors:
        device = tensors[0].device
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in args]


def input_device(*args, default="cuda"):
    """The device of the first tensor argument, else ``default``: an entry
    point given only numbers, numpy arrays or lists runs on the card."""
    return next((a.device for a in args if isinstance(a, torch.Tensor)), default)


# Feature flags: whether each optional dependency is installed. Found, not
# imported: importing the package imports none of them (pandas among them).
def _probe(modname: str) -> bool:
    return importlib.util.find_spec(modname) is not None


SKLEARN_AVAILABLE = _probe("sklearn")
SCIPY_AVAILABLE = _probe("scipy")
PANDAS_AVAILABLE = _probe("pandas")
YFINANCE_AVAILABLE = _probe("yfinance")
OPTUNA_AVAILABLE = _probe("optuna")
ONNX_AVAILABLE = _probe("onnxruntime")


def default_device_kind() -> str:
    """The name of CUDA device 0, or "cpu" when there is no card."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"
