"""The hand-written kernels over a device mesh.

The port of ``optionslab_tpu/parallel/sharded_pallas.py``, the multi-device
face of ``ops/``'s kernels:

  * **Global block ownership.** A single-device launch computes path blocks
    ``[0, n)``; a sharded call gives shard ``d`` (its linear index over
    every mesh axis) the contiguous slice ``[d·bpd, (d+1)·bpd)`` and passes
    the offset to the kernel as its ``block0``. Every sampler stream is a
    pure function of (seed, GLOBAL block id), so the union of the paths
    simulated is the same for every topology: 1, 2, 4 or 8 shards
    integrate the same sample set, and only the float32 association of the
    shards' sums differs.
  * **Moments, not payoffs, leave a device.** Each shard's kernel reduces
    its blocks to per-row moment tiles; the tiles are moved to the mesh's
    first device and summed there in shard order (the reference's
    ``psum``), and the Greeks are combined once from the global moments.
  * **One controller.** Every shard's launch is issued on its own device
    before any tile is moved, so shards on different cards overlap. A
    device may repeat in a mesh; on a CPU tensor each launch is the
    kernel's plain version, on a CUDA tensor the kernel.

The block count is rounded up so that every shard owns the same number of
blocks, and the functions report the paths actually simulated.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import exotic_kernel as ek
from ..ops import gbm_kernel as gk
from ..ops import heston_exotic_kernel as hx
from ..ops import heston_kernel as hk
from ..ops import local_vol_kernel as lk
from ..ops import multi_asset_kernel as mk
from ..ops import slv_kernel as sk
from ..types import FIELDS, ContractBatch
from ..utils.exceptions import ValidationError
from .mesh import BOOK_AXIS, PATH_AXIS, Mesh


def _mesh_axes(mesh: Mesh):
    """(axis names to reduce over, total device count) for this mesh."""
    names = [n for n in (BOOK_AXIS, PATH_AXIS) if n in mesh.shape]
    if not names:  # arbitrary user mesh: reduce over every axis
        names = list(mesh.shape.keys())
    n_dev = 1
    for n in names:
        n_dev *= mesh.shape[n]
    return tuple(names), n_dev


def _device_linear_index(mesh: Mesh, names, coords: dict) -> int:
    """The linear shard id of the device at ``coords`` (axis name → index)
    over the axes ``names``, the first axis slowest."""
    d = 0
    for n in names:
        d = d * mesh.shape[n] + coords[n]
    return d


def _shard_devices(mesh: Mesh) -> list:
    """The devices the path blocks shard over, in linear shard order."""
    names, _ = _mesh_axes(mesh)
    by_id = {}
    for idx in np.ndindex(mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, idx))
        by_id.setdefault(_device_linear_index(mesh, names, coords), mesh.devices[idx])
    return [by_id[d] for d in sorted(by_id)]


def _round_blocks(n_paths: int, per_block: int, n_dev: int) -> int:
    n_blocks = max(1, math.ceil(n_paths / per_block))
    return ((n_blocks + n_dev - 1) // n_dev) * n_dev


def _fan_out(mesh: Mesh, n_blocks: int, launch) -> torch.Tensor:
    """``launch(device, block0, n)`` for every shard, each on its slice of
    the ``n_blocks`` global blocks, all issued before any result moves; the
    tiles summed on the first device in shard order."""
    devs = _shard_devices(mesh)
    bpd = n_blocks // len(devs)
    tiles = [launch(dev, d * bpd, bpd) for d, dev in enumerate(devs)]
    total = tiles[0].to(devs[0])
    for tile in tiles[1:]:
        total = total + tile.to(devs[0])
    return total


def _home(mesh: Mesh) -> torch.device:
    return _shard_devices(mesh)[0]


def _vector(p, device) -> torch.Tensor:
    return torch.tensor(np.asarray(p, np.float32), device=device)


# ---------------------------------------------------------------------------
# GBM European book: the fused price + Greek ladder kernel
# ---------------------------------------------------------------------------
@torch.no_grad()
def sharded_pallas_greeks(batch: ContractBatch, mesh: Mesh, n_paths: int = 1_000_000,
                          seed: int = 0, sampler: str = "prng") -> dict:
    """Price + stderr + the full first/second-order Greek ladder from the
    GBM kernel (``csrc/gbm_mc.cu``), with the path-block axis sharded over
    every device of ``mesh`` (``book`` and ``paths`` axes both shard blocks;
    a contract book rides the kernel's rows on each shard).

    ``n_paths`` is the per-contract GLOBAL path budget across the whole
    mesh, rounded up to whole blocks on every shard; ``n_paths`` in the
    result is the count simulated. On a one-device mesh this is
    ``ops.gbm_kernel.gbm_mc_price_greeks`` bit for bit. Tensors on the
    mesh's first device.
    """
    gk._check_sampler(sampler)
    home = _home(mesh)
    batch = ContractBatch(*(getattr(batch, k).to(home) for k in FIELDS))
    b, flat, params, c, reps, rows, _pad = gk._prepare(batch)
    lanes = gk._lanes_for(rows)
    per_block = 4 * lanes  # cos/sin × (±antithetic) per row
    _names, n_dev = _mesh_axes(mesh)
    # global block count, rounded up so every device owns the same number
    n_blocks = _round_blocks(n_paths, per_block * reps, n_dev)

    def launch(dev, block0, n):
        return gk._gbm_moments(seed, block0, [p.to(dev) for p in params], n_blocks=n,
                               rows=rows, active_rows=c * reps, lanes=lanes,
                               sampler=sampler, reps=reps, greeks=True)

    sums = _fan_out(mesh, n_blocks, launch)
    out = gk._combine(b, flat, sums, c, reps, n_blocks * per_block, batch.dtype,
                      sampler=sampler)
    # actual per-contract path count (blocks round up to a full device grid)
    out["n_paths"] = n_blocks * per_block * reps
    return out


# ---------------------------------------------------------------------------
# Path-dependent GBM payoffs: the exotic price and Greeks kernels
# ---------------------------------------------------------------------------
@torch.no_grad()
def sharded_exotic_price(kind: str, spot, strike, maturity, rate, vol, mesh: Mesh,
                         cp: float = 1.0, dividend: float = 0.0, barrier: float = 0.0,
                         n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                         sampler: str = "prng", lower: float = 0.0, upper: float = 0.0):
    """``ops.exotic_kernel.exotic_price`` with path blocks sharded over every
    device of ``mesh`` (global-block ownership: the same topology-invariant
    path set as :func:`sharded_pallas_greeks`). Returns (price, stderr,
    actual_paths); ``n_paths`` is the global budget, rounded up to a full
    device grid of blocks. Pay-at-hit kinds are discounted in the kernel, as
    in the unsharded call."""
    if kind not in ek.PAYOFF_KINDS or kind == "asian_arith_cv":
        raise ValidationError(f"unknown exotic kind {kind!r}; choose {ek.PAYOFF_KINDS}")
    if kind in ("cliquet", "autocall", "range_accrual"):
        raise ValidationError(f"use the {kind}_price function (its structured params) on "
                              "one device")
    p, t = ek._base_params(spot, strike, maturity, rate, vol, dividend, barrier, n_steps)
    ek._check_double(kind, lower, upper, p)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, ek.PATHS_PER_BLOCK, n_dev)
    home = _home(mesh)
    params = _vector(p, home)
    book = _vector([[p[j] for j in ek._BOOK_SLOTS]], home)

    def launch(dev, block0, n):
        return ek._exotic_moments(seed, block0, params.to(dev), book.to(dev), kind=kind,
                                  n_steps=n_steps, n_blocks=n, cp=float(cp), period=1,
                                  sampler=sampler)

    pay, pay2 = _fan_out(mesh, n_blocks, launch)
    n = n_blocks * ek.PATHS_PER_BLOCK
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * t)
    price, se = ek._mean_stderr(pay, pay2, n, df, sampler)
    return price, se, n


@torch.no_grad()
def sharded_exotic_greeks(kind: str, spot, strike, maturity, rate, vol, mesh: Mesh,
                          cp: float = 1.0, dividend: float = 0.0, n_paths: int = 1_000_000,
                          n_steps: int = 64, seed: int = 0, sampler: str = "prng") -> dict:
    """``ops.exotic_kernel.exotic_greeks`` (price + pathwise delta/vega/rho/
    theta/dividend_rho, ONE kernel pass) sharded over ``mesh``: each shard
    owns a contiguous global block range, the five moment tiles are summed
    on the first device, and the ladder is combined once."""
    if kind not in ek.GREEK_KINDS:
        raise ValidationError(
            f"in-kernel Greeks support {ek.GREEK_KINDS}; for {kind!r} use "
            "the scan engine's autograd (models/exotics.exotic_greeks)")
    if sampler.startswith("sobol"):
        raise ValidationError("the Greeks kernel supports prng/hash only")
    p, t = ek._base_params(spot, strike, maturity, rate, vol, dividend, 0.0, n_steps)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, ek.PATHS_PER_BLOCK_G, n_dev)
    params = _vector(p, _home(mesh))

    def launch(dev, block0, n):
        return ek._exotic_greeks_moments(seed, block0, params.to(dev), kind=kind,
                                         n_steps=n_steps, n_blocks=n, cp=float(cp),
                                         sampler=sampler)

    sums = _fan_out(mesh, n_blocks, launch)
    n = n_blocks * ek.PATHS_PER_BLOCK_G
    out = ek._combine_greeks(sums, n, spot=float(spot), rate=float(rate), vol=float(vol), t=t,
                             a_drift=float(rate) - float(dividend) - 0.5 * float(vol) ** 2,
                             df=math.exp(-float(rate) * t), kind=kind, n_steps=n_steps)
    out["paths"] = n
    return out


# ---------------------------------------------------------------------------
# Multi-asset: the correlated-GBM kernel
# ---------------------------------------------------------------------------
def _ma_sums(mesh, seed, p, *, d, kind, n_steps, n_blocks, cp, sampler, lr):
    params = torch.tensor(p, device=_home(mesh))

    def launch(dev, block0, n):
        return mk._dispatch(mk._ma_cuda, mk._ma_plain, dev, seed, block0, params.to(dev), d=d,
                            kind=kind, n_steps=n_steps, n_blocks=n, cp=float(cp),
                            sampler=sampler, lr=lr)

    return _fan_out(mesh, n_blocks, launch)


@torch.no_grad()
def sharded_multi_asset_price(kind: str, spots, strike, maturity, rate, vols, corr,
                              mesh: Mesh, weights=None, cp: float = 1.0, dividends=0.0,
                              n_paths: int = 1_000_000, n_steps: int = 1, seed: int = 0,
                              sampler: str = "prng", control_variate: bool = False):
    """``ops.multi_asset_kernel.multi_asset_kernel_price`` with path blocks
    sharded over ``mesh`` (global-block ownership, topology-invariant path
    set). Returns (price, stderr, actual_paths). ``control_variate=True``
    (basket only) applies the geometric control variate: the difference's
    moments are summed over the shards and the exact closed form is added
    once."""
    if control_variate:
        if kind != "basket":
            raise ValidationError("control_variate applies to the arithmetic basket "
                                  "(geometric CV)")
        kind = "basket_cv"
    if kind not in mk.KINDS:
        raise ValidationError(f"unknown kind {kind!r}; choose {mk.KINDS}")
    d, t, p = mk._params_vec(spots, weights, strike, maturity, rate, vols, corr, dividends,
                             n_steps, cv=kind == "basket_cv")
    if kind == "spread" and d != 2:
        raise ValidationError("spread requires exactly 2 assets")
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, mk.PATHS_PER_BLOCK, n_dev)
    outs = _ma_sums(mesh, seed, p, d=d, kind=kind, n_steps=n_steps, n_blocks=n_blocks, cp=cp,
                    sampler=sampler, lr=False)
    n = n_blocks * mk.PATHS_PER_BLOCK
    price, se = mk._mean_stderr(outs[0], outs[1], n, math.exp(-float(rate) * t), sampler)
    if kind == "basket_cv":
        from ..models.multi_asset import geometric_basket_closed_form

        price = price + float(geometric_basket_closed_form(
            spots, mk._weights(weights, d), strike, t, rate, vols, corr, cp, dividends))
    return price, se, n


@torch.no_grad()
def sharded_multi_asset_greeks(kind: str, spots, strike, maturity, rate, vols, corr,
                               mesh: Mesh, weights=None, cp: float = 1.0, dividends=0.0,
                               n_paths: int = 1_000_000, n_steps: int = 1, seed: int = 0,
                               sampler: str = "prng") -> dict:
    """``ops.multi_asset_kernel.multi_asset_kernel_greeks`` — the full
    per-asset likelihood-ratio ladder (delta/vega vectors, d×d gamma matrix,
    theta, rho) — with path blocks sharded over ``mesh``. Only the
    2+2d+d(d+1)/2+2 moment tiles leave a shard; the ladder is assembled once
    from the global moments."""
    if kind not in mk.KINDS or kind == "basket_cv":
        raise ValidationError(f"unknown kind {kind!r}; choose {mk.KINDS}")
    d, t, p = mk._params_vec(spots, weights, strike, maturity, rate, vols, corr, dividends,
                             n_steps, lr=True)
    if kind == "spread" and d != 2:
        raise ValidationError("spread requires exactly 2 assets")
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, mk.PATHS_PER_BLOCK, n_dev)
    outs = _ma_sums(mesh, seed, p, d=d, kind=kind, n_steps=n_steps, n_blocks=n_blocks, cp=cp,
                    sampler=sampler, lr=True)
    return mk._combine_lr(outs, n_blocks * mk.PATHS_PER_BLOCK, d, t, rate, spots, vols, corr,
                          n_steps)


# ---------------------------------------------------------------------------
# Stochastic vol: the Heston Euler, QE and QE-ladder kernels
# ---------------------------------------------------------------------------
@torch.no_grad()
def sharded_heston_greeks(spot, strike, maturity, rate, params, mesh: Mesh, cp: float = 1.0,
                          dividend: float = 0.0, n_paths: int = 1_000_000, n_steps: int = 100,
                          seed: int = 0, sampler: str = "prng", vega: bool = True,
                          ladder: bool = False, scheme: str = "euler") -> dict:
    """``ops.heston_kernel.heston_kernel_greeks`` (price + pathwise
    delta/rho + v0-vega, one kernel pass) with path blocks sharded over
    ``mesh`` — the same topology-invariant construction as
    :func:`sharded_pallas_greeks`.

    ``ladder=True`` shards the full parameter-sensitivity variant
    (v0/kappa/theta/sigma/rho + calendar theta, 9 moment tiles); with
    ``scheme="qe"`` that is the CRN-bump QE ladder. Plain ``scheme="qe"``
    (with ``vega=False``) shards the Andersen-QE price kernel (price/delta/
    rho only)."""
    if scheme not in ("euler", "qe"):
        raise ValidationError(f"scheme must be euler|qe, got {scheme!r}")
    if scheme == "qe" and vega and not ladder:
        raise ValidationError("scheme='qe' needs ladder=True for sensitivities (the CRN-bump "
                              "kernel); plain qe is price/delta/rho only")
    home = _home(mesh)
    hs = None
    if scheme == "qe" and ladder:
        hk._check_launch(sampler, n_steps, qe=True)
        t, p, hs = hk._params_vec_qe_ladder(spot, strike, maturity, rate, params, dividend,
                                            n_steps)
        fns, kw = (hk._heston_qe_ladder_cuda, hk._heston_qe_ladder_plain), {}
    elif scheme == "qe":
        hk._check_launch(sampler, n_steps, qe=True)
        t, p = hk._params_vec_qe(spot, strike, maturity, rate, params, dividend, n_steps)
        fns, kw = (hk._heston_qe_cuda, hk._heston_qe_plain), {}
    else:
        mode = "ladder" if ladder else ("vega" if vega else "price")
        hk._check_euler(sampler, n_steps, mode)
        t, p = hk._params_vec(spot, strike, maturity, rate, params, dividend, n_steps)
        fns, kw = (hk._heston_mc_cuda, hk._heston_mc_plain), {"mode": mode}
    ppb = hk.LADDER_PATHS_PER_BLOCK if ladder else hk.PATHS_PER_BLOCK
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, ppb, n_dev)
    pvec = torch.tensor(p, device=home)

    def launch(dev, block0, n):
        return hk._dispatch(*fns, dev, seed, block0, pvec.to(dev), n_steps=n_steps,
                            n_blocks=n, cp=float(cp), sampler=sampler, **kw)

    sums = _fan_out(mesh, n_blocks, launch)
    n = n_blocks * ppb
    df = math.exp(-float(rate) * t)
    if hs is not None:
        out = hk._combine_qe_ladder(sums, n, spot=float(spot), t=t, df=df, v0=float(params.v0),
                                    rate=float(rate), hs=[float(np.float32(h)) for h in hs],
                                    cp=float(cp))
    else:
        out = hk._combine_moments(sums, n, spot=float(spot), t=t, df=df, v0=float(params.v0),
                                  cp=float(cp), mode=kw.get("mode", "price"), rate=float(rate),
                                  sampler=sampler)
    out["paths"] = n
    return out


# ---------------------------------------------------------------------------
# Local vol: the Dupire-smile kernel
# ---------------------------------------------------------------------------
def _lv_sums(pricer, mesh, seed, p, n_blocks, **kw):
    def launch(dev, block0, n):
        return lk._dispatch(lk._lv_cuda, lk._lv_plain, dev, seed, block0, p.to(dev),
                            n_steps=pricer.n_steps, n_blocks=n, **kw)

    return _fan_out(mesh, n_blocks, launch)


@torch.no_grad()
def sharded_local_vol_price(pricer, strike, mesh: Mesh, cp: float = 1.0,
                            payoff: str = "european", barrier: float = 0.0,
                            n_paths: int = 1_000_000, seed: int = 0, sampler: str = "prng",
                            lower: float = 0.0, upper: float = 0.0):
    """``ops.local_vol_kernel.LocalVolKernelPricer.price`` — smile-consistent
    exotics on the fitted per-step σ-polynomial table — with path blocks
    sharded over ``mesh``. ``pricer`` is a fitted
    :class:`~..ops.local_vol_kernel.LocalVolKernelPricer`. Returns (price,
    stderr, actual_paths); pay-at-hit payoffs are discounted in the kernel,
    as in the unsharded call."""
    p = pricer._params(strike, payoff, barrier, lower, upper)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, lk.PATHS_PER_BLOCK, n_dev)
    pay, pay2 = _lv_sums(pricer, mesh, seed, p, n_blocks, cp=float(cp), payoff=payoff,
                         sampler=sampler)
    n = n_blocks * lk.PATHS_PER_BLOCK
    price, se = lk._mean_stderr(pay, pay2, n, pricer._df(payoff), sampler)
    return price, se, n


@torch.no_grad()
def sharded_local_vol_greeks(pricer, strike, mesh: Mesh, cp: float = 1.0,
                             payoff: str = "european", barrier: float = 0.0,
                             n_paths: int = 1_000_000, seed: int = 0, sampler: str = "prng",
                             lower: float = 0.0, upper: float = 0.0) -> dict:
    """``LocalVolKernelPricer.greeks`` (sticky-strike LR delta/gamma +
    parallel-shift vega, one kernel pass) sharded over ``mesh``: the 5 (7
    for lookbacks) moment tiles are summed over the shards and the ladder is
    assembled once — the single-device estimate for the same global path
    set."""
    p = pricer._params(strike, payoff, barrier, lower, upper)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, lk.PATHS_PER_BLOCK, n_dev)
    outs = _lv_sums(pricer, mesh, seed, p, n_blocks, cp=float(cp), payoff=payoff,
                    sampler=sampler, greeks=True)
    return pricer._combine_greeks(outs, n_blocks * lk.PATHS_PER_BLOCK, payoff)


# ---------------------------------------------------------------------------
# Heston/Bates exotics: the stochastic-vol path-dependent kernel
# ---------------------------------------------------------------------------
def _hx_sums(mesh, seed, p, params, n_blocks, **kw):
    home = _home(mesh)
    pvec = _vector(p, home)
    book = _vector([[p[j] for j in hx._BOOK_SLOTS]], home)

    def launch(dev, block0, n):
        return hx._dispatch(hx._heston_exotic_cuda, hx._heston_exotic_plain, dev, seed, block0,
                            pvec.to(dev), book.to(dev), n_blocks=n, period=1,
                            jumps=hasattr(params, "lam"), **kw)

    return _fan_out(mesh, n_blocks, launch)


def _check_hx_kind(kind: str) -> None:
    if kind not in hx.HESTON_EXOTIC_KINDS or kind in hx.STRUCTURED:
        raise ValidationError(
            f"sharded heston exotics cover the non-structured kinds, got {kind!r}")


@torch.no_grad()
def sharded_heston_exotic_price(kind: str, spot, strike, maturity, rate, params, mesh: Mesh,
                                cp: float = 1.0, dividend: float = 0.0, barrier: float = 0.0,
                                n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                                sampler: str = "prng", scheme: str = "euler",
                                lower: float = 0.0, upper: float = 0.0):
    """``ops.heston_exotic_kernel.heston_kernel_exotic_price`` with path
    blocks sharded over ``mesh`` (global-block ownership — the same
    topology-invariant path set as every kernel family here). Heston or
    Bates ``params``, Euler or Andersen-QE scheme. Returns (price, stderr,
    actual_paths)."""
    _check_hx_kind(kind)
    hx._check_exotic_sampler(sampler, scheme, n_steps)
    p, t = hx._exotic_params(spot, strike, maturity, rate, params, dividend, barrier, n_steps,
                             scheme)
    if "double" in kind:
        hx._set_double_band(p, spot, lower, upper)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, hx.PATHS_PER_BLOCK, n_dev)
    pay, pay2 = _hx_sums(mesh, seed, p, params, n_blocks, kind=kind, n_steps=n_steps,
                         cp=float(cp), sampler=sampler, scheme=scheme)
    n = n_blocks * hx.PATHS_PER_BLOCK
    df = 1.0 if kind.endswith("_hit") else math.exp(-float(rate) * t)
    price, se = ek._mean_stderr(pay, pay2, n, df, sampler)
    return price, se, n


@torch.no_grad()
def sharded_heston_exotic_greeks(kind: str, spot, strike, maturity, rate, params, mesh: Mesh,
                                 cp: float = 1.0, dividend: float = 0.0, barrier: float = 0.0,
                                 n_paths: int = 1_000_000, n_steps: int = 64, seed: int = 0,
                                 sampler: str = "prng", lower: float = 0.0,
                                 upper: float = 0.0) -> dict:
    """``heston_kernel_exotic_lr_greeks`` (price + joint-density LR
    delta/gamma/v0-vega/rho/theta, one pass, Euler scheme) sharded over
    ``mesh``: the moment tiles are summed over the shards and the ladder is
    combined once — the single-device estimate for the same global path
    set."""
    _check_hx_kind(kind)
    if sampler.startswith("sobol"):
        raise ValidationError("LR scores assume iid normals — use prng/hash")
    p, t = hx._exotic_params(spot, strike, maturity, rate, params, dividend, barrier, n_steps,
                             "euler")
    if "double" in kind:
        hx._set_double_band(p, spot, lower, upper)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, hx.PATHS_PER_BLOCK, n_dev)
    sums = _hx_sums(mesh, seed, p, params, n_blocks, kind=kind, n_steps=n_steps, cp=float(cp),
                    sampler=sampler, scheme="euler", lr=True)
    n = n_blocks * hx.PATHS_PER_BLOCK
    out = hx._combine_exotic_lr(list(sums.double().sum(dim=1) / n), n,
                                hx._lr_scalars(spot, t, rate, params, n_steps), n_steps,
                                discounted=kind.endswith("_hit"))
    out["paths"] = n
    return out


# ---------------------------------------------------------------------------
# SLV: the stochastic-local-vol kernel (the particle calibration runs once,
# on the pricer's device; only the replay fans out)
# ---------------------------------------------------------------------------
def _slv_sums(pricer, mesh, seed, p, n_blocks, **kw):
    def launch(dev, block0, n):
        return sk._dispatch(sk._slv_cuda, sk._slv_plain, dev, seed, block0, p.to(dev),
                            n_steps=pricer.n_steps, n_blocks=n, **kw)

    return _fan_out(mesh, n_blocks, launch)


@torch.no_grad()
def sharded_slv_price(pricer, kind: str, strike, mesh: Mesh, cp: float = 1.0,
                      barrier: float = 0.0, n_paths: int = 1_000_000, seed: int = 0,
                      sampler: str = "prng", lower: float = 0.0, upper: float = 0.0):
    """``ops.slv_kernel.SLVKernelPricer.price`` — exotics under
    Heston × Dupire-leverage dynamics — with path blocks sharded over
    ``mesh``. ``pricer`` is a calibrated
    :class:`~..ops.slv_kernel.SLVKernelPricer`; its leverage table goes to
    every shard. Returns (price, stderr, actual_paths)."""
    if sampler not in sk.SAMPLERS:
        raise ValidationError("SLV kernel samplers are prng|hash")
    p = pricer._params_vec(kind, strike, barrier, lower, upper)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, sk.PATHS_PER_BLOCK, n_dev)
    pay, pay2 = _slv_sums(pricer, mesh, seed, p, n_blocks, kind=kind, cp=float(cp),
                          sampler=sampler)
    n = n_blocks * sk.PATHS_PER_BLOCK
    df = 1.0 if kind.endswith("_hit") else math.exp(-pricer.rate * pricer.t_total)
    price, se = sk._mean_stderr(pay, pay2, n, df, sampler)
    return price, se, n


@torch.no_grad()
def sharded_slv_greeks(pricer, kind: str, strike, mesh: Mesh, cp: float = 1.0,
                       barrier: float = 0.0, n_paths: int = 1_000_000, seed: int = 0,
                       sampler: str = "prng", lower: float = 0.0, upper: float = 0.0) -> dict:
    """``SLVKernelPricer.greeks`` (sticky-strike LR delta/gamma +
    frozen-leverage v0-vega/rho, one pass) sharded over ``mesh``: the 7 (9
    for lookbacks) moment tiles are summed over the shards and the ladder is
    assembled once — the single-device estimate for the same global path
    set."""
    pricer._check_lr(sampler)
    p = pricer._params_vec(kind, strike, barrier, lower, upper)
    _names, n_dev = _mesh_axes(mesh)
    n_blocks = _round_blocks(n_paths, sk.PATHS_PER_BLOCK, n_dev)
    outs = _slv_sums(pricer, mesh, seed, p, n_blocks, kind=kind, cp=float(cp), sampler=sampler,
                     lr=True)
    return pricer._combine_lr(outs, n_blocks * sk.PATHS_PER_BLOCK, kind)
