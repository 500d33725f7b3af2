"""Dtype policy and numerical floors shared by the pricers.

Compute defaults to float32. Every public function follows the dtype of its
tensor inputs, so float64 tensors give float64 results (the closed forms are
checked that way against the JAX package).
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float32

# Numerical floors shared across pricers.
EPS_TIME = 1e-10  # treat maturities below this as expired
EPS_VOL = 1e-12  # treat vols below this as deterministic


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
