"""Quasi-Monte Carlo exotics with Brownian-bridge path construction.

The port of ``optionslab_tpu/models/qmc_exotics.py``. The bridge gives Sobol
dimension 0 to the terminal point, dimension 1 to the midpoint, then bisects,
so the best-stratified dimensions carry most of the path's variance. The
normals come from ``ops/rng.qmc_normals``: unscrambled without a generator,
randomly shifted with one. The path matrix (n_paths × n_steps) is
materialised on the generator's (or ``device``'s) device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.rng import MAX_SOBOL_DIM, qmc_normals
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError


@functools.lru_cache(maxsize=32)
def _bridge_order(n_steps: int):
    """Static bridge schedule (index, left, right): filling W[index[i]] from
    W[left[i]] and W[right[i]] in order builds the path; entry 0 is the
    terminal point (right = −1: unconditioned). Times are 1-based on a grid
    with W[0] = 0."""
    index, left, right = [n_steps], [0], [-1]
    segments = [(0, n_steps)]
    while segments:
        nxt = []
        for lo, hi in segments:
            if hi - lo <= 1:
                continue
            mid = (lo + hi) // 2
            index.append(mid)
            left.append(lo)
            right.append(hi)
            nxt.append((lo, mid))
            nxt.append((mid, hi))
        segments = nxt
    return (np.asarray(index, np.int32), np.asarray(left, np.int32),
            np.asarray(right, np.int32))


def brownian_bridge_paths(z, maturity):
    """(n, n_steps) normals → (n, n_steps + 1) Brownian paths W (W[:, 0] = 0);
    column j of ``z`` drives the j-th bridge refinement (terminal first)."""
    n, m = z.shape
    # the bridge weights in the normals' precision, as the reference forms them
    f = np.float64 if z.dtype == torch.float64 else np.float32
    t = f(maturity)
    dt = t / f(m)
    index, left, right = _bridge_order(m)
    cols = [None] * (m + 1)
    cols[0] = torch.zeros(n, dtype=z.dtype, device=z.device)
    cols[m] = float(np.sqrt(t)) * z[:, 0]
    for j in range(1, len(index)):
        i, lo, hi = int(index[j]), int(left[j]), int(right[j])
        t_i, t_lo, t_hi = f(i) * dt, f(lo) * dt, f(hi) * dt
        frac = (t_i - t_lo) / (t_hi - t_lo)
        var = (t_hi - t_i) * (t_i - t_lo) / (t_hi - t_lo)
        cols[i] = cols[lo] + float(frac) * (cols[hi] - cols[lo]) + float(np.sqrt(var)) * z[:, j]
    return torch.stack(cols, dim=1)


def _qmc_gbm_paths(spot, maturity, rate, dividend, vol, n_paths, n_steps, generator, device,
                   dtype=torch.float32):
    if n_steps > MAX_SOBOL_DIM:
        raise ValidationError(f"QMC exotics support n_steps <= {MAX_SOBOL_DIM} (Sobol table); "
                              f"use the scan or kernel engines beyond that")
    dev = generator.device if generator is not None else torch.device(device)
    z = qmc_normals(n_paths, n_steps, generator=generator, dtype=dtype, device=dev)
    w = brownian_bridge_paths(z, maturity)
    times = torch.linspace(0.0, float(maturity), n_steps + 1, dtype=torch.float64).to(dtype)
    drift = (rate - dividend - 0.5 * vol * vol) * times.to(dev)
    return spot * torch.exp(drift[None, :] + vol * w)


def _df(rate, maturity) -> float:
    return math.exp(-float(rate) * max(float(maturity), EPS_TIME))


def qmc_asian_price(spot, strike, maturity, rate, vol, generator=None, cp=1.0, dividend=0.0,
                    n_paths: int = 65_536, n_steps: int = 64, averaging: str = "arithmetic",
                    return_stderr: bool = False, device="cuda"):
    """Arithmetic or geometric fixed-strike Asian under bridge Sobol, on the
    generator's device (``device`` when no generator: unscrambled points).
    The stderr is the plain-MC formula, pessimistic for QMC."""
    paths = _qmc_gbm_paths(spot, maturity, rate, dividend, vol, n_paths, n_steps, generator,
                           device)
    fixings = paths[:, 1:]
    avg = (torch.exp(torch.log(fixings).mean(dim=1)) if averaging == "geometric"
           else fixings.mean(dim=1))
    pay = torch.clamp_min(cp * (avg - strike), 0.0)
    df = _df(rate, maturity)
    price = df * pay.mean()
    if return_stderr:
        return price, df * pay.std(correction=1) / math.sqrt(n_paths)
    return price


def qmc_lookback_price(spot, strike, maturity, rate, vol, generator=None, cp=1.0, dividend=0.0,
                       n_paths: int = 65_536, n_steps: int = 64, floating: bool = True,
                       device="cuda"):
    """Floating- or fixed-strike lookback under bridge Sobol."""
    paths = _qmc_gbm_paths(spot, maturity, rate, dividend, vol, n_paths, n_steps, generator,
                           device)
    mn = paths.min(dim=1).values
    mx = paths.max(dim=1).values
    terminal = paths[:, -1]
    if floating:
        pay = terminal - mn if cp > 0 else mx - terminal
    else:
        pay = torch.clamp_min(mx - strike, 0.0) if cp > 0 else torch.clamp_min(strike - mn, 0.0)
    return _df(rate, maturity) * pay.mean()


def qmc_barrier_price(spot, strike, barrier, maturity, rate, vol, generator=None, cp=1.0,
                      dividend=0.0, n_paths: int = 65_536, n_steps: int = 64,
                      barrier_type: str = "up-and-out", device="cuda"):
    """Discretely monitored single barrier under bridge Sobol (t = 0 is a
    monitoring point, as in the reference)."""
    parts = barrier_type.split("-")
    if len(parts) != 3 or parts[0] not in ("up", "down") or parts[2] not in ("in", "out"):
        raise ValidationError(f"unknown barrier type {barrier_type!r}")
    up = parts[0] == "up"
    knock_in = parts[2] == "in"
    paths = _qmc_gbm_paths(spot, maturity, rate, dividend, vol, n_paths, n_steps, generator,
                           device)
    crossed = (paths >= barrier).any(dim=1) if up else (paths <= barrier).any(dim=1)
    vanilla = torch.clamp_min(cp * (paths[:, -1] - strike), 0.0)
    pay = torch.where(crossed, vanilla, 0.0) if knock_in else torch.where(crossed, 0.0, vanilla)
    return _df(rate, maturity) * pay.mean()
