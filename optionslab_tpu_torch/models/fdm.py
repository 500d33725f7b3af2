"""Finite-difference PDE pricers: the θ-scheme (Crank–Nicolson) and explicit Euler.

The port of ``optionslab_tpu/models/fdm.py``. Each contract gets a uniform
log-spot grid of its own; the book is the leading axis of every
``(book, n_space)`` tensor, so one time loop steps every contract.
American contracts solve the per-step obstacle problem by Howard policy
iteration (default) or by the first-order projection ``V = max(V, ψ)``.

On the card the whole θ-scheme time loop is one launch of
``csrc/theta_pde.cu`` (``ops/theta_pde.py``), which keeps every contract's
grid in shared memory from the first step to the last; on the CPU it is the
plain loop of one batched Thomas solve (``ops/tridiag.py``) a step or a
Howard sweep. ``PERF.md`` records the count and the time it costs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.theta_pde import EUROPEAN, HOWARD, PROJECTION, theta_loop
from ..ops.theta_pde import set_ends as _set_ends
from ..types import ContractBatch
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from .binomial import _flat_args


def _fma(a, b, c):
    """a·b + c rounded once, as XLA's fused CPU loops evaluate the
    reference's grid (torch's eager ops round the product and the sum
    apart). float32 goes through float64, where the product is exact;
    float64 adds the product's exact error (Veltkamp–Dekker) to the sum's
    (Knuth's two-sum). Elementwise IEEE operations only, so the card and the
    CPU give the same bits."""
    if a.dtype != torch.float64:
        return (a.double() * b.double() + c.double()).to(a.dtype)
    split = 134217729.0  # 2**27 + 1
    p = a * b
    ca, cb = split * a, split * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bv = s - p
    t = (p - (s - bv)) + (c - bv)
    return s + (t + e)


def _unit_linspace(n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` as XLA computes it: step i·(1/(n−1)), the
    reciprocal rounded once, then −1·(1 − step) + 1·step; ``torch.linspace``
    rounds the inner nodes differently."""
    div = n - 1
    if div < 1:
        return torch.full((n,), -1.0, dtype=dtype, device=device)
    recip = torch.tensor(1.0, dtype=dtype) / torch.tensor(float(div), dtype=dtype)
    step = torch.arange(div, dtype=dtype, device=device) * recip.to(device)
    ones = torch.ones(1, dtype=dtype, device=device)
    return torch.cat([step - (1.0 - step), ones])


def _grid(spot, vol, maturity, n_space, width, strike=None):
    """(B, n_space) uniform log-spot grids centred on log(S0), wide enough for
    the diffusion cone and the strike; log(K) sits mid-cell. Detached: the
    mesh must not move under a derivative in S, σ or T (the price is read
    off by interpolation at log S instead).

    At S0 = K the shift that puts log(K) mid-cell is a tie: ``frac`` is an
    integer in exact arithmetic, so rounding picks −dx/2 or +dx/2. The
    nodes are therefore built with the reference's own roundings (its
    linspace, one rounding for each ``a·b + c``, a correctly rounded root),
    so both packages take the same side of the tie."""
    t = torch.clamp_min(maturity, EPS_TIME)
    root = torch.sqrt(t.to(torch.float64)).to(t.dtype)
    spread = width * torch.clamp_min(vol, 0.05)
    if strike is not None:
        half = _fma(spread, root, torch.abs(torch.log(spot / strike)))
    else:
        half = spread * root
    lin = _unit_linspace(n_space, spot.dtype, spot.device)
    shape = (spot.shape[0], n_space)
    x = _fma(lin.expand(shape), half[:, None].expand(shape), torch.log(spot)[:, None].expand(shape))
    if strike is not None:
        dx = x[:, 1] - x[:, 0]
        frac = torch.remainder((torch.log(strike) - x[:, 0]) / dx, 1.0)
        x = x + ((frac - 0.5) * dx)[:, None]
    x = x.detach()
    return x, x[:, 1] - x[:, 0]


def _read_price(v, x, spot):
    """Quadratic (3-node Lagrange) interpolation of each row at log(S)."""
    mid = x.shape[-1] // 2
    xe = torch.log(spot)
    x0, x1, x2 = x[:, mid - 1], x[:, mid], x[:, mid + 1]
    l0 = (xe - x1) * (xe - x2) / ((x0 - x1) * (x0 - x2))
    l1 = (xe - x0) * (xe - x2) / ((x1 - x0) * (x1 - x2))
    l2 = (xe - x0) * (xe - x1) / ((x2 - x0) * (x2 - x1))
    return l0 * v[:, mid - 1] + l1 * v[:, mid] + l2 * v[:, mid + 1]


def _cn_operands(spot, strike, maturity, rate, vol, dividend, cp, n_space: int, n_time: int,
                 theta_scheme: float, american: bool, width: float = 6.0):
    """The grids and the θ-scheme's operands for a book of (B,) contracts:
    (x, the arguments of :func:`theta_loop` but the mode)."""
    col = lambda z: z[:, None]  # noqa: E731
    t = torch.clamp_min(maturity, EPS_TIME)
    x, dx = _grid(spot, vol, maturity, n_space, width, strike)
    s_nodes = torch.exp(x)
    dt = t / n_time
    sig2 = vol * vol
    mu = rate - dividend - 0.5 * sig2
    a = 0.5 * sig2 / dx**2 - 0.5 * mu / dx
    b = -sig2 / dx**2 - rate
    c = 0.5 * sig2 / dx**2 + 0.5 * mu / dx

    intrinsic = torch.clamp_min(col(cp) * (s_nodes - col(strike)), 0.0)
    ones = torch.ones_like(s_nodes)
    zeros = torch.zeros_like(spot)
    lo = _set_ends(col(-theta_scheme * dt * a) * ones, zeros, zeros)
    di = _set_ends(1.0 - col(theta_scheme * dt * b) * ones, zeros + 1.0, zeros + 1.0)
    up = _set_ends(col(-theta_scheme * dt * c) * ones, zeros, zeros)

    # the asymptotic values at the grid ends after each step, times to
    # expiry (k + 1)·dt (the integer k + 1 is exact, so each is the product a
    # step-by-step loop forms); American deep-ITM ends sit in the exercise
    # region
    tau = torch.arange(1, n_time + 1, dtype=dt.dtype, device=dt.device) * col(dt)
    call = col(cp) > 0
    k_disc = col(strike) * torch.exp(-col(rate) * tau)
    low = torch.where(call, 0.0, k_disc - s_nodes[:, :1] * torch.exp(-col(dividend) * tau))
    high = torch.where(call, s_nodes[:, -1:] * torch.exp(-col(dividend) * tau) - k_disc, 0.0)
    if american:
        low = torch.maximum(low, intrinsic[:, :1])
        high = torch.maximum(high, intrinsic[:, -1:])
    ends = torch.stack([torch.clamp_min(low, 0.0), torch.clamp_min(high, 0.0)], dim=-1)
    return x, (lo, di, up, col(a), col(b), col(c), col((1.0 - theta_scheme) * dt), intrinsic,
               intrinsic, ends)


def _cn_book(spot, strike, maturity, rate, vol, dividend, cp, n_space: int, n_time: int,
             theta_scheme: float, american: bool, width: float = 6.0, lcp: bool = False):
    """The θ-scheme (θ = 0.5 Crank–Nicolson, θ = 1 implicit): the reference's
    ``_cn_single`` for a book of (B,) contracts at once; returns (B,) prices."""
    x, ops = _cn_operands(spot, strike, maturity, rate, vol, dividend, cp, n_space, n_time,
                          theta_scheme, american, width)
    mode = (HOWARD if lcp else PROJECTION) if american else EUROPEAN
    return _read_price(theta_loop(*ops, mode), x, spot)


def fdm_price(batch: ContractBatch, n_space: int = 201, n_time: int = 200,
              american: bool = False, scheme: str = "crank-nicolson",
              american_method: str = "policy") -> torch.Tensor:
    """Whole-book PDE prices on the batch's device.

    ``american_method``: "policy" (default) solves each step's obstacle
    problem by Howard iteration (second order); "projection" is the
    first-order ``V = max(V, ψ)`` clamp after each step.
    """
    theta_scheme = {"crank-nicolson": 0.5, "implicit": 1.0}.get(scheme)
    if theta_scheme is None:
        raise ValidationError(f"unknown scheme {scheme!r}")
    if american_method not in ("policy", "projection"):
        raise ValidationError(f"unknown american_method {american_method!r}")
    if n_space % 2 == 0:
        raise ValidationError("n_space must be odd so S0 sits on a grid node")
    shape, (s, k, t, r, sig, q, cp) = _flat_args(batch)
    prices = _cn_book(s, k, t, r, sig, q, cp, n_space, n_time, theta_scheme, american,
                      lcp=american_method == "policy")
    intrinsic = torch.clamp_min(cp * (s - k), 0.0)
    return torch.where(t <= EPS_TIME, intrinsic, prices).reshape(shape)


def explicit_fdm_price(batch: ContractBatch, n_space: int = 201, n_time: int = 2000,
                       american: bool = False) -> torch.Tensor:
    """Explicit Euler on the same grids; the ends are pinned to intrinsic.
    Stable only below the CFL bound (:func:`explicit_fdm_stable_steps`)."""
    shape, (s, k, t, r, sig, q, cp) = _flat_args(batch)
    col = lambda z: z[:, None]  # noqa: E731
    tt = torch.clamp_min(t, EPS_TIME)
    x, dx = _grid(s, sig, t, n_space, 6.0, k)
    s_nodes = torch.exp(x)
    dt = tt / n_time
    sig2 = sig * sig
    mu = r - q - 0.5 * sig2
    a = col(0.5 * sig2 / dx**2 - 0.5 * mu / dx)
    bb = col(-sig2 / dx**2 - r)
    c = col(0.5 * sig2 / dx**2 + 0.5 * mu / dx)
    dt = col(dt)
    intrinsic = torch.clamp_min(col(cp) * (s_nodes - col(k)), 0.0)
    v = intrinsic
    for _ in range(n_time):
        v = v + dt * (a * torch.roll(v, 1, dims=1) + bb * v + c * torch.roll(v, -1, dims=1))
        v = _set_ends(v, intrinsic[:, 0], intrinsic[:, -1])
        if american:
            v = torch.maximum(v, intrinsic)
    return _read_price(v, x, s).reshape(shape)


def explicit_fdm_stable_steps(vol, maturity, n_space: int = 201, width: float = 6.0) -> int:
    """CFL-stable step count for the explicit scheme."""
    t = max(float(maturity), 1e-10)
    dx = 2 * width * max(float(vol), 0.05) * math.sqrt(t) / (n_space - 1)
    dt_max = dx * dx / max(float(vol) ** 2, 1e-12)
    return int(np.ceil(t / dt_max)) + 1


class CrankNicolsonSolver:
    """Object adapter over :func:`fdm_price`, pricing on ``device``."""

    def __init__(self, n_space: int = 201, n_time: int = 200, american: bool = False,
                 device="cuda"):
        self.n_space = n_space
        self.n_time = n_time
        self.american = american
        self.device = device

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        batch = ContractBatch.make(S, K, T, r, sigma, option_type, q, device=self.device)
        return fdm_price(batch, n_space=self.n_space, n_time=self.n_time, american=self.american)


class ExplicitFDMSolver:
    """Object adapter over :func:`explicit_fdm_price`, pricing on ``device``."""

    def __init__(self, n_space: int = 201, n_time: int = 2000, american: bool = False,
                 device="cuda"):
        self.n_space = n_space
        self.n_time = n_time
        self.american = american
        self.device = device

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        batch = ContractBatch.make(S, K, T, r, sigma, option_type, q, device=self.device)
        return explicit_fdm_price(batch, n_space=self.n_space, n_time=self.n_time,
                                  american=self.american)
