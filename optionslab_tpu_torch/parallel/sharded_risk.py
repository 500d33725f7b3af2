"""Sharded VaR/ES: tail quantiles of P&L samples spread over a mesh.

The port of ``optionslab_tpu/parallel/sharded_risk.py``. A (1-c) tail
quantile needs only each shard's worst ceil((1-c)·n) observations: every
shard takes its own smallest k with ``torch.topk`` on its device, only
those k values per shard move to the mesh's first device (in shard order),
and the exact global quantile and tail mean come from the gathered tails —
the same as sorting the whole sample.
"""

from __future__ import annotations

import math

import torch

from ..ops.kernel_rng import TWO_PI, _bits24_to_uniform, philox4x32_10
from .mesh import Mesh, path_sharding

VAR_SALT = 0xBB67AE85  # key salt of sharded_mc_var's per-shard Philox stream
_U32 = 0xFFFFFFFF


def _tail_count(confidence: float, n: int) -> int:
    """ceil((1-c)·n) with an epsilon guard against float artifacts like
    0.05·80000 = 4000.0000000000005 → 4001."""
    return max(1, int(math.ceil((1.0 - confidence) * n - 1e-9)))


def _var_es(tails, m: int, home):
    """(VaR, ES) from the shards' worst tails, gathered in shard order."""
    flat = torch.cat([t.to(home) for t in tails])
    worst_m = -torch.topk(-flat, m, sorted=True).values
    return -worst_m[-1], -worst_m.mean()


def sharded_historical_var_es(pnl_sharded, confidence: float, mesh: Mesh):
    """(VaR, ES) of a P&L sample sharded over the mesh's path axis.

    ``pnl_sharded``: the per-shard pieces (a list, one 1-D tensor per path
    slice, as :func:`~.mesh.shard` with :func:`~.mesh.path_sharding` makes
    them) or one 1-D tensor, which is split into equal pieces placed on the
    path axis' devices (its length divisible by the axis size). Returns
    positive-loss VaR and ES, exact (the same as a global sort), on the
    first device.
    """
    devs = path_sharding(mesh).devices()
    n_dev = len(devs)
    if isinstance(pnl_sharded, torch.Tensor):
        if pnl_sharded.shape[0] % n_dev:
            raise ValueError(f"{pnl_sharded.shape[0]} samples not divisible by {n_dev} shards")
        pieces = [p.to(d) for p, d in zip(torch.chunk(pnl_sharded.reshape(-1), n_dev), devs)]
    else:
        pieces = [p.reshape(-1) for p in pnl_sharded]
        if len(pieces) != n_dev:
            raise ValueError(f"{len(pieces)} pieces for a path axis of {n_dev}")
    n_total = sum(p.shape[0] for p in pieces)
    m = _tail_count(confidence, n_total)
    # worst case: the whole global tail sits on one shard
    tails = [-torch.topk(-p, min(p.shape[0], m + 1), sorted=True).values for p in pieces]
    return _var_es(tails, m, devs[0])


def _shard_normals(seed: int, shard: int, n: int, device) -> torch.Tensor:
    """``n`` float32 normals of shard ``shard``: Philox4x32-10 keyed by
    ``(seed, VAR_SALT ^ shard)`` at counters ``(i, 0, 0, 0)``, four words a
    counter, two Box–Muller pairs (the reference folds the device index into
    its key)."""
    ctr = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    words = philox4x32_10(ctr, 0, 0, 0, int(seed) & _U32, (shard & _U32) ^ VAR_SALT)
    u = [_bits24_to_uniform(w >> 8) for w in words]
    z = []
    for u1, u2 in ((u[0], u[1]), (u[2], u[3])):
        radius = torch.sqrt(-2.0 * torch.log(u1))
        z += [radius * torch.cos(TWO_PI * u2), radius * torch.sin(TWO_PI * u2)]
    return torch.stack(z, dim=-1).reshape(-1)[:n]


def sharded_mc_var(value, mu, sigma, seed: int, mesh: Mesh, confidence: float = 0.95,
                   horizon: float = 1.0, n_paths: int = 1_000_000):
    """Monte Carlo VaR with the simulation AND the quantile sharded: each
    path shard draws its own normals from (seed, shard index) and keeps its
    worst tail; only tail values leave a device. Returns (VaR, ES) on the
    first device."""
    devs = path_sharding(mesh).devices()
    n_dev = len(devs)
    if n_paths % n_dev:
        raise ValueError(f"n_paths={n_paths} not divisible by {n_dev} devices")
    n_local = n_paths // n_dev
    m = _tail_count(confidence, n_paths)
    k = min(n_local, m + 1)
    drift = (mu - 0.5 * sigma**2) * horizon
    scale = sigma * math.sqrt(horizon)
    tails = []
    for d, dev in enumerate(devs):
        z = _shard_normals(seed, d, n_local, dev)
        pnl = value * (torch.exp(drift + scale * z) - 1.0)
        tails.append(-torch.topk(-pnl, k, sorted=True).values)
    return _var_es(tails, m, devs[0])
