"""Dupire local volatility: the surface, the local-vol PDE and the scan engine.

The port of ``optionslab_tpu/models/local_vol.py``.

* :class:`DupireLocalVol` takes σ_loc²(k, T) from a smooth implied-vol
  function ``iv_fn(k, T)`` by the total-variance form of Dupire's formula

      σ_loc² = ∂_T w / [1 − (k/w)∂_k w + ¼(−¼ − 1/w + k²/w²)(∂_k w)² + ½ ∂²_k w],

  w = iv²·T, its derivatives by ``torch.autograd`` over the whole (n_t, n_k)
  grid at once (``iv_fn`` is elementwise, so the gradient of Σw is the grid
  of ∂w); the result is a :class:`LocalVolSurface`, bilinear in
  (log-forward-moneyness, T), clamped at the grid's edges.
* ``DupireLocalVol.price`` solves the local-vol PDE: implicit time steps
  through the surface, every step's diagonals formed as one table and the
  whole loop one launch of ``csrc/lv_pde.cu`` (``ops/lv_pde.py``).
* :func:`local_vol_mc_price` and the swap strikes run the scan engine: a
  log-Euler loop over the steps with a bilinear σ(S, t) lookup per step and
  antithetic normals from an explicit ``torch.Generator``; the statistical
  oracle of the kernel of ``ops/local_vol_kernel.py``.
* :func:`local_vol_cliquet_price` and :func:`local_vol_autocall_price` run
  the SLV scan (``models/slv.py``) at mixing 0, which is pure local vol.

Every function runs on the device of the surface's tensors;
:class:`DupireLocalVol` and :class:`LocalVolSurface` build on ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..ops.lv_pde import EUROPEAN, PROJECTION, lv_loop
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError


def _bilinear(grid_x, grid_y, values, xq, yq):
    """Differentiable bilinear interpolation on uniform grids; clamps outside
    the grid. ``values``: (n_y, n_x); ``xq``/``yq`` broadcastable."""
    nx, ny = grid_x.shape[0], grid_y.shape[0]
    dx = grid_x[1] - grid_x[0]
    dy = grid_y[1] - grid_y[0]
    fx = torch.clamp((xq - grid_x[0]) / dx, 0.0, nx - 1.001)
    fy = torch.clamp((yq - grid_y[0]) / dy, 0.0, ny - 1.001)
    fx, fy = torch.broadcast_tensors(fx, fy)
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    tx = fx - ix
    ty = fy - iy
    v00 = values[iy, ix]
    v01 = values[iy, ix + 1]
    v10 = values[iy + 1, ix]
    v11 = values[iy + 1, ix + 1]
    return (v00 * (1 - tx) * (1 - ty) + v01 * tx * (1 - ty)
            + v10 * (1 - tx) * ty + v11 * tx * ty)


class LocalVolSurface:
    """σ_loc(S, t) interpolator on a dense (log-moneyness, T) grid: float32
    tensors ``k_grid`` (n_k,), ``t_grid`` (n_t,), ``grid`` (n_t, n_k) on
    ``device`` (default ``"cuda"``, as :class:`DupireLocalVol`)."""

    def __init__(self, k_grid, t_grid, local_vol_grid, spot, rate, dividend=0.0, device="cuda"):
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device).detach()

        self.k_grid = f32(k_grid)
        self.t_grid = f32(t_grid)
        self.grid = f32(local_vol_grid)
        self.spot = float(spot)
        self.rate = float(rate)
        self.dividend = float(dividend)

    @classmethod
    def from_numpy(cls, k_grid, t_grid, grid, spot, rate, dividend=0.0,
                   device="cuda") -> "LocalVolSurface":
        """A surface from numpy arrays, e.g. the JAX package's ``np.asarray``
        of its ``LocalVolSurface`` grids."""
        return cls(np.array(k_grid, np.float32), np.array(t_grid, np.float32),
                   np.array(grid, np.float32), spot, rate, dividend, device=device)

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def to(self, device) -> "LocalVolSurface":
        return LocalVolSurface(self.k_grid, self.t_grid, self.grid, self.spot, self.rate,
                               self.dividend, device=device)

    def __call__(self, s, t):
        """σ_loc at spot level(s) ``s`` and time(s) ``t`` (k = log(s/F(t)))."""
        s = torch.as_tensor(s, dtype=torch.float32, device=self.device)
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        fwd = self.spot * torch.exp((self.rate - self.dividend) * t)
        k = torch.log(torch.clamp_min(s, 1e-12) / fwd)
        return _bilinear(self.k_grid, self.t_grid, self.grid, k, t)


class DupireLocalVol:
    """Extracts σ_loc(k, T) from an implied-vol function and prices through it."""

    def __init__(self, iv_fn, spot, rate, dividend=0.0, k_range=(-0.8, 0.8),
                 t_range=(0.02, 2.5), n_k: int = 121, n_t: int = 60, device="cuda"):
        """``iv_fn(k, T) -> implied vol``: a smooth function of log-moneyness
        and maturity tensors, elementwise and differentiable by autograd
        (e.g. :func:`sample_smile_iv_fn`)."""
        self.iv_fn = iv_fn
        self.spot = float(spot)
        self.rate = float(rate)
        self.dividend = float(dividend)
        dev = torch.device(device)
        self.k_grid = torch.linspace(*k_range, n_k, dtype=torch.float64).to(torch.float32).to(dev)
        self.t_grid = torch.linspace(*t_range, n_t, dtype=torch.float64).to(torch.float32).to(dev)
        self.surface = self._build()

    @property
    def device(self) -> torch.device:
        return self.surface.device

    def to(self, device) -> "DupireLocalVol":
        """The same Dupire surface with its tensors on ``device``."""
        out = object.__new__(DupireLocalVol)
        out.__dict__.update(self.__dict__)
        out.k_grid, out.t_grid = self.k_grid.to(device), self.t_grid.to(device)
        out.surface = self.surface.to(device)
        return out

    def local_variance(self, k, t) -> torch.Tensor:
        """Dupire in total-variance form, the derivatives of w by autograd."""
        with torch.enable_grad():
            k = torch.as_tensor(k, dtype=torch.float32).detach().requires_grad_(True)
            t = torch.as_tensor(t, dtype=torch.float32, device=k.device).detach() \
                .requires_grad_(True)
            iv = self.iv_fn(k, t)
            w = iv * iv * t
            dw_dk, dw_dt = torch.autograd.grad(w.sum(), (k, t), create_graph=True)
            (d2w_dk2,) = torch.autograd.grad(dw_dk.sum(), (k,))
        k, w, dw_dk, dw_dt = k.detach(), w.detach(), dw_dk.detach(), dw_dt.detach()
        w_safe = torch.clamp_min(w, 1e-8)
        denom = (1.0 - k / w_safe * dw_dk
                 + 0.25 * (-0.25 - 1.0 / w_safe + (k / w_safe) ** 2) * dw_dk**2
                 + 0.5 * d2w_dk2)
        return torch.clamp(torch.clamp_min(dw_dt, 1e-8) / torch.clamp_min(denom, 1e-4), 1e-6, 4.0)

    def _build(self) -> LocalVolSurface:
        kk, tt = torch.meshgrid(self.k_grid, self.t_grid, indexing="xy")  # (n_t, n_k)
        var = self.local_variance(kk, tt)
        return LocalVolSurface(self.k_grid, self.t_grid, torch.sqrt(var), self.spot, self.rate,
                               self.dividend, device=self.k_grid.device)

    def _solve(self, strike, maturity, cp, n_space: int = 201, n_time: int = 200,
               american: bool = False):
        s = self.surface
        return _lv_solve(s.k_grid, s.t_grid, s.grid, self.spot, self.rate, self.dividend, strike,
                         maturity, cp, n_space=n_space, n_time=n_time, american=american)

    def price(self, S, K, T, r=None, sigma=None, option_type="call", q=None):
        """PricerProtocol-compatible price by the local-vol PDE; ``r``,
        ``sigma`` and ``q`` are ignored (the surface supplies the dynamics).
        A float32 tensor on the surface's device."""
        if abs(float(S) - self.spot) > 1e-9 * max(self.spot, 1.0):
            raise ValidationError(f"local-vol surface was built for spot {self.spot}; "
                                  f"rebuild for S={S}")
        cp = 1.0 if str(option_type).lower() in ("call", "c", "1") else -1.0
        return self._solve(float(K), float(T), cp)


def sample_smile_iv_fn(base_vol=0.2, skew=-0.15, smile=0.1, term=0.02):
    """Smooth synthetic implied-vol surface iv(k, T) for demos and tests."""

    def iv(k, t):
        t = torch.as_tensor(t)
        return base_vol + skew * k + smile * k * k + term * torch.sqrt(torch.clamp_min(t, 1e-6))

    return iv


def _sigma_at(k_grid, t_grid, vol_grid, spot, rate, dividend):
    def sigma_at(s, t):
        fwd = spot * torch.exp((rate - dividend) * t)
        kq = torch.log(torch.clamp_min(s, 1e-12) / fwd)
        return _bilinear(k_grid, t_grid, vol_grid, kq, t)

    return sigma_at


def _lv_tables(k_grid, t_grid, vol_grid, spot, rate, dividend, strike, maturity, cp,
               n_space: int, n_time: int, floor_low: bool):
    """The grid and every step's operands of the implicit local-vol loop,
    float32 on the surface's device: (x, intrinsic, lo, di, up, ends). Step
    i runs from calendar time T − (i + 1)·dt to T − i·dt and reads σ(S, t)
    at its midpoint (clamped to 1e-4); ``lo``, ``di``, ``up`` are its (n_time,
    n) diagonals, ``ends`` its (n_time, 2) end values at time to expiry (i +
    1)·dt: the put's discounted strike less the low node (floored at
    intrinsic with ``floor_low``, the American put's deep boundary), the
    call's forward less the discounted strike at the high node. One pass of
    the per-step loop's elementwise operations on all the steps at once
    (i + 0.5 and i + 1 are exact in float32), so each entry rounds as that
    step's did."""
    dev = vol_grid.device

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    strike, cp = f32(strike), f32(cp)
    t_total = torch.clamp_min(f32(maturity), EPS_TIME)
    sigma_at = _sigma_at(k_grid, t_grid, vol_grid, spot, rate, dividend)
    atm_vol = sigma_at(f32(spot), 0.5 * t_total)
    half = 6.0 * torch.clamp_min(atm_vol, 0.1) * torch.sqrt(t_total)
    x = math.log(spot) + torch.linspace(-1.0, 1.0, n_space, dtype=torch.float32, device=dev) * half
    dx = x[1] - x[0]
    s_nodes = torch.exp(x)
    dt = t_total / n_time
    intrinsic = torch.clamp_min(cp * (s_nodes - strike), 0.0)
    edge = torch.zeros(n_space, dtype=torch.bool, device=dev)
    edge[0] = edge[-1] = True
    steps = torch.arange(n_time, dtype=torch.float32, device=dev)
    tau = t_total - (steps + 0.5) * dt  # calendar time of each step
    sig = sigma_at(s_nodes, torch.clamp_min(tau, 1e-4)[:, None])  # (n_time, n)
    sig2 = sig * sig
    mu = rate - dividend - 0.5 * sig2
    a = 0.5 * sig2 / dx**2 - 0.5 * mu / dx
    b = -sig2 / dx**2 - rate
    c = 0.5 * sig2 / dx**2 + 0.5 * mu / dx
    lo = torch.where(edge, 0.0, -dt * a)
    di = torch.where(edge, 1.0, 1.0 - dt * b)
    up = torch.where(edge, 0.0, -dt * c)
    tau_exp = (steps + 1.0) * dt
    df_exp = strike * torch.exp(-rate * tau_exp)
    low = df_exp - s_nodes[0]
    if floor_low:
        low = torch.maximum(low, intrinsic[0])
    vlo = torch.where(cp > 0, 0.0, low)
    vhi = torch.where(cp > 0, s_nodes[-1] * torch.exp(-dividend * tau_exp) - df_exp, 0.0)
    ends = torch.stack([torch.clamp_min(vlo, 0.0), torch.clamp_min(vhi, 0.0)], dim=-1)
    return x, intrinsic, lo, di, up, ends


def _lv_solve(k_grid, t_grid, vol_grid, spot, rate, dividend, strike, maturity, cp,
              n_space: int = 201, n_time: int = 200, american: bool = False) -> torch.Tensor:
    """Implicit time stepping of the local-vol PDE in log-spot through the
    interpolated surface, the American clamped to intrinsic after each step:
    one :func:`lv_loop` on the step tables of :func:`_lv_tables`. The value
    at the spot node."""
    _, intrinsic, lo, di, up, ends = _lv_tables(k_grid, t_grid, vol_grid, spot, rate, dividend,
                                                strike, maturity, cp, n_space, n_time, False)
    v, _ = lv_loop(lo[None], di[None], up[None], ends[None], intrinsic[None], intrinsic[None],
                   PROJECTION if american else EUROPEAN)
    return v[0, n_space // 2]


def _lv_scan(surface, maturity, generator: torch.Generator, n_paths: int, n_steps: int,
             update):
    """Log-Euler paths through ``surface`` with a bilinear σ(S, t) lookup per
    step and antithetic normals; ``update(acc, log_s, sig, dt) -> acc`` sees
    every step. Returns (log_s, acc, t_total, half)."""
    dev = generator.device
    grids = (surface.k_grid.to(dev), surface.t_grid.to(dev), surface.grid.to(dev))
    sigma_at = _sigma_at(*grids, surface.spot, surface.rate, surface.dividend)
    t_total = torch.clamp_min(torch.tensor(float(maturity), dtype=torch.float32, device=dev),
                              EPS_TIME)
    dt = t_total / n_steps
    sqrt_dt = torch.sqrt(dt)
    half = n_paths // 2
    log_s = torch.zeros(2 * half, dtype=torch.float32, device=dev)
    acc = torch.zeros_like(log_s)
    drift = surface.rate - surface.dividend
    for i in range(n_steps):
        sig = sigma_at(surface.spot * torch.exp(log_s), i * dt)
        z = torch.randn(half, generator=generator, device=dev)
        z = torch.cat([z, -z])
        log_s = log_s + (drift - 0.5 * sig * sig) * dt + sig * sqrt_dt * z
        acc = update(acc, log_s, sig, dt)
    return log_s, acc, t_total, half


def _generator(dupire, seed: int) -> torch.Generator:
    return torch.Generator(device=dupire.surface.device).manual_seed(int(seed))


def local_vol_mc_price(dupire: DupireLocalVol, strike, maturity, cp=1.0, payoff: str = "european",
                       n_paths: int = 200_000, n_steps: int = 100, seed: int = 0):
    """European or arithmetic-Asian price by Monte Carlo under a Dupire
    surface (the scan engine, on the surface's device). Returns (price,
    stderr), float32 tensors."""
    if payoff not in ("european", "asian"):
        raise ValidationError(f"payoff must be european|asian, got {payoff}")
    s0 = dupire.surface.spot

    def update(acc, log_s, sig, dt):
        return acc + s0 * torch.exp(log_s)

    log_s, acc, t_total, _ = _lv_scan(dupire.surface, maturity, _generator(dupire, seed),
                                      n_paths, n_steps, update)
    underlying = acc / n_steps if payoff == "asian" else s0 * torch.exp(log_s)
    pay = torch.clamp_min(float(cp) * (underlying - float(strike)), 0.0)
    df = torch.exp(-dupire.surface.rate * t_total)
    return df * pay.mean(), df * pay.std(correction=1) / math.sqrt(pay.shape[0])


def _lv_realized_variance(dupire: DupireLocalVol, maturity, seed: int, n_paths: int,
                          n_steps: int):
    """Per-path model integrated variance RV = (1/T)∫σ_loc(S_t, t)² dt along
    local-vol paths (left-point sampling). Returns (E[RV], se, E[√RV], se),
    the stderrs over the antithetic pair means."""

    def update(acc, log_s, sig, dt):
        return acc + sig * sig * dt

    _, acc, t_total, half = _lv_scan(dupire.surface, maturity, _generator(dupire, seed), n_paths,
                                     n_steps, update)
    rv = acc / t_total
    vol = torch.sqrt(rv)
    rv_pm = 0.5 * (rv[:half] + rv[half:])
    vol_pm = 0.5 * (vol[:half] + vol[half:])
    rn = math.sqrt(half)
    return (rv.mean(), rv_pm.std(correction=1) / rn, vol.mean(), vol_pm.std(correction=1) / rn)


def _check_varswap_wing_coverage(dupire: DupireLocalVol, maturity) -> None:
    """Warn when the Dupire grid's k-range cannot span the strike strip a
    variance swap integrates over (≈ ±2.5·σ_ATM·√T in log-moneyness): beyond
    ``k_grid`` the surface clamps to its edge value and biases K_var."""
    kg = dupire.surface.k_grid.cpu().numpy()
    tg = dupire.surface.t_grid.cpu().numpy()
    vg = dupire.surface.grid.cpu().numpy()
    t = float(maturity)
    sig_atm = float(vg[np.argmin(np.abs(tg - t)), np.argmin(np.abs(kg))])
    need = 2.5 * sig_atm * np.sqrt(max(t, 1e-8))
    if need > min(-float(kg[0]), float(kg[-1])) + 1e-9:
        warnings.warn(
            f"Dupire k_grid [{float(kg[0]):.2f}, {float(kg[-1]):.2f}] does not span the "
            f"±{need:.2f} log-moneyness strip a T={t:g} variance swap integrates over; clamped "
            "wings bias K_var (18% shortfall measured on the default ±0.8 grid). Rebuild the "
            "surface with k_range=(-2.5, 2.5) or wider.", stacklevel=3)


def local_vol_swap_strikes(dupire: DupireLocalVol, maturity, n_paths: int = 200_000,
                           n_steps: int = 100, seed: int = 0):
    """Both swap strikes from one simulation: ``(K_var, se_var, K_vol,
    se_vol)``. Needs a ``k_grid`` that spans the replication strip (see
    :func:`local_vol_variance_swap`)."""
    _check_varswap_wing_coverage(dupire, maturity)
    return _lv_realized_variance(dupire, maturity, seed, n_paths, n_steps)


def local_vol_variance_swap(dupire: DupireLocalVol, maturity, n_paths: int = 200_000,
                            n_steps: int = 100, seed: int = 0):
    """Fair variance swap strike E[(1/T)∫σ_loc²(S_t, t) dt] under the Dupire
    dynamics: (K_var, stderr). It agrees with the model-free replication of
    the same smile up to discretization when the surface's ``k_grid`` spans
    ≈ ±2.5·σ_ATM·√T (``k_range=(-2.5, 2.5)`` is safe); a warning fires when
    it does not. On a flat surface K_var = σ² with zero stderr."""
    m, se, _, _ = local_vol_swap_strikes(dupire, maturity, n_paths, n_steps, seed)
    return m, se


def local_vol_vol_swap_strike(dupire: DupireLocalVol, maturity, n_paths: int = 200_000,
                              n_steps: int = 100, seed: int = 0):
    """Fair volatility swap strike E[√((1/T)∫σ_loc² dt)]: (K_vol, stderr),
    below √K_var by Jensen."""
    _, _, m, se = local_vol_swap_strikes(dupire, maturity, n_paths, n_steps, seed)
    return m, se


def _lv_slv_args(dupire: DupireLocalVol, maturity, seed: int):
    """The arguments of an SLV scan at mixing 0 on ``dupire``'s surface."""
    from .heston import HestonParams

    s = dupire.surface
    par = HestonParams.make(0.04, 2.0, 0.04, 0.3, -0.7, device=s.device)
    return (s.spot, float(maturity), s.rate, par, _generator(dupire, seed), s.k_grid, s.t_grid,
            s.grid)


def local_vol_cliquet_price(dupire: DupireLocalVol, maturity, local_floor: float = -0.05,
                            local_cap: float = 0.05, global_floor: float = 0.0,
                            global_cap: float = 1e9, notional: float = 100.0, n_periods: int = 12,
                            n_paths: int = 131_072, n_steps: int = 252, seed: int = 0,
                            return_stderr: bool = False):
    """Cliquet under pure Dupire local vol: the SLV scan at mixing 0, where
    the leverage absorbs the deterministic variance path so the
    instantaneous vol is σ_loc(S, t) exactly. Conventions of
    ``models/exotics.cliquet_price``."""
    from .slv import slv_cliquet_price

    return slv_cliquet_price(*_lv_slv_args(dupire, maturity, seed), dividend=dupire.dividend,
                             mixing=0.0, local_floor=local_floor, local_cap=local_cap,
                             global_floor=global_floor, global_cap=global_cap, notional=notional,
                             n_periods=n_periods, n_paths=n_paths, n_steps=n_steps,
                             return_stderr=return_stderr)


def local_vol_autocall_price(dupire: DupireLocalVol, maturity, notional: float = 100.0,
                             autocall_barrier: float = 1.0, coupon_barrier: float = 0.8,
                             ki_barrier: float = 0.7, coupon_rate: float = 0.08, n_obs: int = 4,
                             n_paths: int = 131_072, n_steps: int = 252, seed: int = 0,
                             return_stderr: bool = False):
    """Autocallable under pure Dupire local vol (the SLV scan at mixing 0).
    Conventions of ``models/exotics.autocallable_price``."""
    from .slv import slv_autocall_price

    return slv_autocall_price(*_lv_slv_args(dupire, maturity, seed), dividend=dupire.dividend,
                              mixing=0.0, notional=notional, autocall_barrier=autocall_barrier,
                              coupon_barrier=coupon_barrier, ki_barrier=ki_barrier,
                              coupon_rate=coupon_rate, n_obs=n_obs, n_paths=n_paths,
                              n_steps=n_steps, return_stderr=return_stderr)
