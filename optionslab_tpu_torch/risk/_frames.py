"""Host-side helpers for the frame-priced risk tools: a frame is any object
with ``columns``, ``copy()`` and item get/set by column (a pandas DataFrame
among them); a report is a pandas DataFrame when pandas is installed, else
its list of row dicts."""

from __future__ import annotations

import numpy as np
import torch


def host(x) -> np.ndarray:
    """A tensor, array, series or number as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def report(rows: list[dict]):
    try:
        import pandas as pd
    except ImportError:
        return rows
    return pd.DataFrame(rows)
