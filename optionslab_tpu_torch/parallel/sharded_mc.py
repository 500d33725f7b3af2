"""Multi-device Monte Carlo: the path axis sharded over a mesh.

The port of ``optionslab_tpu/parallel/sharded_mc.py``, built on the same
topology-invariant construction:

  * The global path range is cut into fixed blocks of ``PATH_BLOCK`` paths.
    Block ``g`` always draws its normals from a counter stream keyed by
    ``(seed, g)`` (:func:`_block_normals`, Philox4x32-10 where the reference
    folds ``g`` into a key), so the same (seed, global block) produces the
    same normals on any mesh.
  * Devices own contiguous global block ranges. Every op that computes
    block moments has the same shape on every mesh: a shard steps through
    the globally aligned chunks of ``CHUNK_BLOCKS`` blocks that its range
    touches (computing a chunk whole and keeping its own blocks), and every
    sum is a fixed pairwise tree of elementwise adds (:func:`_tree_sum`),
    whose association depends on the length alone.
  * Per-block moments are moved to the mesh's first device in shard order,
    which is global block order, and reduced there in that one order, so
    prices are bit-identical on 1-, 2-, 4- and 8-device meshes.
  * Only O(blocks) scalars per contract leave a device.

``sharded_book_price`` adds the 2-D (book × paths) decomposition with
padding and returns a full :class:`MCResult`; ``sharded_book_greeks``
differentiates straight through the sharded engine with autograd (``.to()``,
``cat`` and the sums are differentiable) and adds the likelihood-ratio/
pathwise gamma moment of the same pass.

The functions take ``seed: int`` where the reference takes a key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.monte_carlo import MCConfig, MCResult, _validate_config
from ..ops.kernel_rng import TWO_PI, _bits24_to_uniform, philox4x32_10
from ..types import FIELDS, ContractBatch
from ..utils.config import EPS_TIME
from .mesh import BOOK_AXIS, PATH_AXIS, path_sharding

PATH_BLOCK = 1000  # global RNG block: fixed regardless of topology
CHUNK_BLOCKS = 64  # global blocks per op: every op's shape is the same on every mesh
MC_BLOCK_SALT = 0x6A09E667  # key salt of the engine's Philox stream (the kernels' differs)
_U32 = 0xFFFFFFFF


def _check_paths(cfg: MCConfig, n_path_devices: int) -> int:
    if cfg.antithetic and PATH_BLOCK % 2:
        raise ValueError("PATH_BLOCK must be even for antithetic sampling")
    if cfg.n_paths % (PATH_BLOCK * n_path_devices):
        raise ValueError(
            f"n_paths={cfg.n_paths} must be divisible by PATH_BLOCK*paths-axis "
            f"= {PATH_BLOCK}*{n_path_devices} (fixed global RNG blocks keep "
            "streams topology-invariant)")
    return cfg.n_paths // PATH_BLOCK


def _tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` by a fixed pairwise tree over the axis zero-padded
    to a power of two. Only elementwise adds, each correctly rounded, so the
    bits depend on the axis' length and values alone: not on the other
    axes' sizes, the device, the thread count or a library's reduction
    plan."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(0, (n - 1).bit_length())
    if width != n:
        x = F.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _block_normals(seed: int, blocks: torch.Tensor, n_steps: int, antithetic: bool,
                   dtype, device) -> torch.Tensor:
    """Standard normals ``(len(blocks), half, n_steps)`` of global path blocks
    ``blocks`` (half = ``PATH_BLOCK/2`` with antithetic pairs, else
    ``PATH_BLOCK``). Block ``g`` draws from Philox4x32-10 keyed by
    ``(seed, MC_BLOCK_SALT ^ g)`` at counters ``(i, 0, 0, 0)``: four output
    words a counter, 24 bits each to a uniform, two Box–Muller pairs. The
    draws depend on (seed, g) alone."""
    half = PATH_BLOCK // 2 if antithetic else PATH_BLOCK
    need = half * n_steps
    ctr = torch.arange(-(-need // 4), dtype=torch.int64, device=device)[None, :]
    key1 = (blocks.to(device=device, dtype=torch.int64)[:, None] & _U32) ^ MC_BLOCK_SALT
    words = philox4x32_10(ctr, 0, 0, 0, int(seed) & _U32, key1)
    u = [_bits24_to_uniform(w >> 8).to(dtype) for w in words]
    z = []
    for u1, u2 in ((u[0], u[1]), (u[2], u[3])):
        radius = torch.sqrt(-2.0 * torch.log(u1))
        theta = TWO_PI * u2
        z += [radius * torch.cos(theta), radius * torch.sin(theta)]
    z = torch.stack(z, dim=-1).reshape(len(blocks), -1)[:, :need]
    return z.reshape(len(blocks), half, n_steps)


def _block_moments(batch_b: ContractBatch, z: torch.Tensor, cfg: MCConfig):
    """Moments of path blocks from their normals ``z`` (``(..., half,
    n_steps)``, leading axes one per block) for a 1-D book ``batch_b``.

    Returns (Σ payoff, Σ pair-mean, Σ pair-mean², Σ gamma-weight), each
    ``(contracts,) + z.shape[:-2]``, where the antithetic PAIR means are the
    independent samples for the stderr, and the gamma weight is the mixed
    pathwise–likelihood-ratio integrand cp·1{exercise}·S_T·(z_eff/(σ√T) − 1)
    (Glasserman §7.3; see ``models/monte_carlo.mc_greeks``).
    """
    n_steps = z.shape[-1]
    zsum = _tree_sum(z, -1)
    if cfg.antithetic:
        zsum = torch.cat([zsum, -zsum], dim=-1)
    half = z.shape[-2]
    lead = (None,) * zsum.dim()

    def col(x):
        return x[(...,) + lead]

    dt = batch_b.maturity / n_steps
    drift = (batch_b.rate - batch_b.dividend - 0.5 * batch_b.vol**2) * batch_b.maturity
    vol_term = batch_b.vol * torch.sqrt(dt)
    terminal = col(batch_b.spot) * torch.exp(col(drift) + col(vol_term) * zsum)
    x = col(batch_b.cp) * (terminal - col(batch_b.strike))
    pay = torch.clamp_min(x, 0.0)
    pair = 0.5 * (pay[..., :half] + pay[..., half:]) if cfg.antithetic else pay
    z_eff = zsum / math.sqrt(n_steps)
    sig_sqrt_t = batch_b.vol * torch.sqrt(torch.clamp_min(batch_b.maturity, EPS_TIME))
    gw = col(batch_b.cp) * torch.where(x > 0, terminal, 0.0) * (z_eff / col(sig_sqrt_t) - 1.0)
    return (_tree_sum(pay), _tree_sum(pair), _tree_sum(pair * pair), _tree_sum(gw))


def _shard_moments(batch_b: ContractBatch, seed: int, cfg: MCConfig, g0: int, g1: int):
    """Per-block moments of global blocks [g0, g1) on ``batch_b``'s device:
    four tensors (contracts, g1 − g0). The shard steps through the globally
    aligned chunks of ``CHUNK_BLOCKS`` blocks its range touches, each
    computed whole (the same op shapes on every mesh)."""
    dev = batch_b.spot.device
    pieces = []
    for k in range(g0 // CHUNK_BLOCKS, -(-g1 // CHUNK_BLOCKS)):
        start = k * CHUNK_BLOCKS
        blocks = torch.arange(start, start + CHUNK_BLOCKS, dtype=torch.int64)
        z = _block_normals(seed, blocks, cfg.n_steps, cfg.antithetic, cfg.dtype, dev)
        moms = _block_moments(batch_b, z, cfg)
        lo, hi = max(g0, start) - start, min(g1, start + CHUNK_BLOCKS) - start
        pieces.append([m[..., lo:hi] for m in moms])
    return [torch.cat([p[m] for p in pieces], dim=-1) for m in range(4)]


def _reduce_canonical(shard_moms, device) -> list:
    """Per-block moments of the path shards (in shard order, which is global
    block order) moved to ``device``, joined into the global block sequence
    and reduced in that ONE order: bit-identical on any mesh size."""
    return [_tree_sum(torch.cat([s[m].to(device) for s in shard_moms], dim=-1))
            for m in range(4)]


def _combine(batch_b: ContractBatch, moms, cfg: MCConfig):
    pay_sum, pair_sum, pair2_sum, gw_sum = moms
    n = float(cfg.n_paths)
    n_pairs = float(cfg.n_paths // (2 if cfg.antithetic else 1))
    df = batch_b.discount()
    mean = pay_sum / n
    pair_mean = pair_sum / n_pairs
    var = torch.clamp_min(pair2_sum / n_pairs - pair_mean * pair_mean, 0.0)
    var = var * n_pairs / max(n_pairs - 1.0, 1.0)  # ddof=1
    expired = batch_b.maturity <= EPS_TIME
    price = torch.where(expired, batch_b.intrinsic(), df * mean)
    se = torch.where(expired, 0.0, df * torch.sqrt(var / n_pairs))
    gamma = df / torch.clamp_min(batch_b.spot, 1e-30) ** 2 * (gw_sum / n)
    return price, se, gamma


def _rows(batch: ContractBatch, lo: int, hi: int, device) -> ContractBatch:
    return ContractBatch(*(getattr(batch, k)[lo:hi].to(device) for k in FIELDS))


def _engine(batch: ContractBatch, seed: int, cfg: MCConfig, grid):
    """(price, se, gamma) of a 1-D book on a device grid ``grid[i][j]`` (book
    slice i, path slice j), on ``grid[0][0]``. Every shard's work is issued
    before any result is moved."""
    _validate_config(cfg)
    n_book, n_path = len(grid), len(grid[0])
    g_total = _check_paths(cfg, n_path)
    bpd = g_total // n_path
    per = batch.shape[0] // n_book
    home = grid[0][0]
    moms = [[_shard_moments(_rows(batch, i * per, (i + 1) * per, grid[i][j]), seed, cfg,
                            j * bpd, (j + 1) * bpd) for j in range(n_path)]
            for i in range(n_book)]
    out = [_combine(_rows(batch, i * per, (i + 1) * per, home), _reduce_canonical(moms[i], home),
                    cfg) for i in range(n_book)]
    return tuple(torch.cat([o[k] for o in out]) for k in range(3))


def _flat(batch: ContractBatch) -> ContractBatch:
    b = batch.broadcast()
    return ContractBatch(*(getattr(b, k).reshape(-1) for k in FIELDS))


def sharded_mc_price(batch: ContractBatch, seed: int, cfg: MCConfig, mesh) -> MCResult:
    """Price with the path axis sharded over the mesh's ``paths`` axis.

    Works for any mesh with a ``paths`` axis; the ``book`` axis replicates
    the contracts here (contract sharding is the 2-D entry point,
    :func:`sharded_book_price`), so the path shards run on the devices of
    the first book row. Results are on the mesh's first device.
    """
    shape = batch.broadcast().shape
    price, se, _gamma = _engine(_flat(batch), seed, cfg, [path_sharding(mesh).devices()])
    return MCResult(price=price.reshape(shape), std_error=se.reshape(shape),
                    n_paths=cfg.n_paths)


def _pad_book(batch: ContractBatch, n_book: int):
    """Broadcast to 1-D and edge-pad the book to a multiple of the book axis."""
    b = batch.broadcast()
    if len(b.shape) != 1:
        raise ValueError(f"sharded_book_price expects a 1-D book, got {tuple(b.shape)}")
    c = b.shape[0]
    pad = (-c) % n_book
    if pad:
        b = ContractBatch(*(torch.cat([getattr(b, k), getattr(b, k)[-1:].expand(pad)])
                            for k in FIELDS))
    return b, c


def _book_grid(mesh) -> list:
    """The mesh's devices as rows of book slices, each a list of path slices."""
    axes = (mesh.axis_names.index(BOOK_AXIS), mesh.axis_names.index(PATH_AXIS))
    return [list(row) for row in np.transpose(mesh.devices, axes)]


def sharded_book_price(batch: ContractBatch, seed: int, cfg: MCConfig, mesh,
                       return_result: bool = False):
    """Contracts sharded over ``book``, paths over ``paths`` — the full 2-D
    decomposition. Books of any length are padded transparently; path
    randomness is shared across the book (common random numbers), exactly
    as the unsharded engine does.

    Returns the price tensor, or a full :class:`MCResult` (price, stderr,
    n_paths) with ``return_result=True``, on the mesh's first device.
    """
    padded, c = _pad_book(batch, mesh.shape[BOOK_AXIS])
    price, se, _gamma = _engine(padded, seed, cfg, _book_grid(mesh))
    price, se = price[:c], se[:c]
    if return_result:
        return MCResult(price=price, std_error=se, n_paths=cfg.n_paths)
    return price


def sharded_book_greeks(batch: ContractBatch, seed: int, cfg: MCConfig, mesh) -> dict:
    """Full Greek ladder on the sharded 2-D engine, parity with
    ``models/monte_carlo.mc_greeks``: pathwise autograd first-order Greeks
    (common random numbers by construction — the randomness is a function of
    (seed, global block) only) plus the LR/PW gamma computed in the same
    sharded pass. Tensors on the mesh's first device.
    """
    home = _book_grid(mesh)[0][0]
    padded, c = _pad_book(batch, mesh.shape[BOOK_AXIS])
    leaves = {k: getattr(padded, k).detach().to(home).requires_grad_(True)
              for k in FIELDS if k != "cp"}
    with torch.enable_grad():
        b = ContractBatch(cp=padded.cp.to(home), **leaves)
        price, se, gamma = _engine(b, seed, cfg, _book_grid(mesh))
        names = ("spot", "vol", "rate", "maturity", "strike", "dividend")
        grads = dict(zip(names, torch.autograd.grad(price.sum(), [leaves[k] for k in names])))

    def take(x):
        return x.detach()[:c]

    return {
        "price": take(price),
        "std_error": take(se),
        "delta": take(grads["spot"]),
        "gamma": take(gamma),
        "vega": take(grads["vol"]),
        "rho": take(grads["rate"]),
        "theta": take(-grads["maturity"]),
        "dual_delta": take(grads["strike"]),
        "dividend_rho": take(grads["dividend"]),
    }
