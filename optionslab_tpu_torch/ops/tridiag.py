"""Batched tridiagonal solve (the Thomas algorithm).

The port of ``optionslab_tpu/ops/tridiag.py``: a loop along the system axis,
vectorised over the leading axes, differentiable by ``torch.autograd``. Not
a kernel: the local-vol PDE (``models/local_vol.py``) calls it once per time
step on a few hundred nodes.
"""

from __future__ import annotations

import torch


def tridiag_solve(lower, diag, upper, rhs) -> torch.Tensor:
    """Solve T x = rhs where T has diagonals (lower, diag, upper).

    Shapes: all (..., n); ``lower[..., 0]`` and ``upper[..., n-1]`` are
    ignored. The leading axes batch by broadcasting. A pivot below 1e-30 in
    magnitude is replaced as in the reference (``sign·1e-30 + 1e-30``).
    """
    lower, diag, upper, rhs = torch.broadcast_tensors(lower, diag, upper, rhs)
    n = diag.shape[-1]
    c_prev = torch.zeros_like(diag[..., 0])
    d_prev = c_prev
    cs, ds = [], []
    for i in range(n):
        a, b = lower[..., i], diag[..., i]
        denom = b - a * c_prev
        denom = torch.where(denom.abs() < 1e-30, torch.sign(denom) * 1e-30 + 1e-30, denom)
        c_prev = upper[..., i] / denom
        d_prev = (rhs[..., i] - a * d_prev) / denom
        cs.append(c_prev)
        ds.append(d_prev)
    x_next = torch.zeros_like(c_prev)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = ds[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)
