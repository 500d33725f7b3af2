"""Rough Bergomi (rBergomi): exact Volterra-Gaussian simulation.

The port of ``optionslab_tpu/models/rbergomi.py``. Bayer–Friz–Gatheral
dynamics

    v_t = xi0 · exp(eta·V~_t − eta²/2 · t^{2H}),
    V~_t = sqrt(2H) ∫_0^t (t−s)^{H−1/2} dW_s,
    dS/S = (r−q) dt + sqrt(v_t) (rho dW + sqrt(1−rho²) dW⊥).

The joint (V~, W) draw on the grid is exact: its 2n × 2n covariance is built
and Cholesky-factorised once on the host in float64 (``lru_cache``d) and each
batch of paths is one (paths × 2n) @ (2n × 2n) ``torch.matmul`` in full
float32 (the reference asks XLA for ``Precision.HIGHEST``; the port checks
that ``torch.get_float32_matmul_precision()`` is "highest" at each such
product and raises otherwise, so TF32 is never switched on silently).

Random numbers come from the ``torch.Generator`` a caller passes (its device
is the device of the call): the Volterra block first, then the orthogonal
spot block, both antithetic. Greeks are autograd of one fixed draw (common
random numbers), gamma a central difference of the autograd delta.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..utils.exceptions import CalibrationError, ValidationError

__all__ = ["RBergomiParams", "rbergomi_price", "rbergomi_greeks", "rbergomi_smile_iv",
           "rbergomi_variance_grid", "rbergomi_cliquet_price", "rbergomi_autocall_price",
           "rbergomi_chain_price", "calibrate_rbergomi", "xi_curve_from_variance_swaps",
           "RBERGOMI_EXOTIC_KINDS", "rbergomi_exotic_price", "rbergomi_exotic_greeks"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RBergomiParams:
    """hurst in (0, 1/2]: roughness; eta: vol-of-vol; rho: spot/vol
    correlation; xi0: (flat) forward variance level."""

    hurst: float = 0.1
    eta: float = 1.9
    rho: float = -0.9
    xi0: float = 0.04

    def validate(self):
        if not 0.0 < self.hurst <= 0.5:
            raise ValidationError(f"hurst must be in (0, 0.5]: {self.hurst}")
        if not -1.0 < self.rho < 1.0:
            raise ValidationError(f"rho must be in (-1, 1): {self.rho}")
        if self.eta < 0 or self.xi0 <= 0:
            raise ValidationError(f"need eta >= 0, xi0 > 0: {self.eta}, {self.xi0}")


@functools.lru_cache(maxsize=16)
def _volterra_cov_host(n_steps: int, hurst: float, maturity: float):
    """Cov([V~_{t_1..n}, W_{t_1..n}]) in float64 on the host (cached).

    C_VV[i,i] = t_i^{2H} exactly; off-diagonals by 64-node Gauss–Legendre
    after the u = w^{1/(H+1/2)} substitution that removes the endpoint
    singularity; C_VW in closed form; C_WW = min(t_i, t_j)."""
    h = float(hurst)
    n = int(n_steps)
    t = np.linspace(maturity / n, maturity, n)
    p = 1.0 / (h + 0.5)
    x64, w64 = np.polynomial.legendre.leggauss(64)
    c_vv = np.empty((n, n))
    for i in range(n):
        ti = t[i]
        c_vv[i, i] = ti ** (2 * h)
        if i + 1 < n:
            tj = t[i + 1:]
            b = ti ** (1.0 / p)
            w_nodes = 0.5 * b * (x64 + 1.0)
            w_w = 0.5 * b * w64
            u = w_nodes ** p
            f = (tj[:, None] - ti + u[None, :]) ** (h - 0.5)
            val = 2 * h * p * (f * w_w[None, :]).sum(axis=1)
            c_vv[i, i + 1:] = val
            c_vv[i + 1:, i] = val
    sq2h = np.sqrt(2 * h)
    ti_ = t[:, None]
    tj_ = t[None, :]
    mn = np.minimum(ti_, tj_)
    c_vw = sq2h / (h + 0.5) * (ti_ ** (h + 0.5) - (ti_ - mn) ** (h + 0.5))
    cov = np.block([[c_vv, c_vw], [c_vw.T, mn]])
    cov += 1e-12 * np.eye(2 * n)  # numerical PSD
    return cov


@functools.lru_cache(maxsize=16)
def _volterra_chol(n_steps: int, hurst: float, maturity: float):
    """Cholesky factor of the block-ordered [V~_{1..n}, W_{1..n}] covariance
    (host, cached, float32)."""
    return np.linalg.cholesky(_volterra_cov_host(n_steps, hurst, maturity)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _volterra_chol_causal(n_steps: int, hurst: float, maturity: float):
    """The causal (time-interleaved) Cholesky factor: state order (V~_1, W_1,
    V~_2, W_2, ...), so each state is a lower-triangular map of the iid
    normals e_1..e_{2i} and any future block's law given the past is an
    explicit Gaussian (``models/rbergomi_american.py``)."""
    n = int(n_steps)
    cov = _volterra_cov_host(n, hurst, maturity)
    perm = np.empty(2 * n, np.int64)
    perm[0::2] = np.arange(n)
    perm[1::2] = n + np.arange(n)
    return np.linalg.cholesky(cov[np.ix_(perm, perm)]).astype(np.float32)


def _check_precision() -> None:
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the Volterra products need full float32 matmuls: "
                           "torch.get_float32_matmul_precision() is "
                           f"{torch.get_float32_matmul_precision()!r}, not 'highest'")


def _matmul_t(a, b):
    """a @ bᵀ in full float32 (checked)."""
    _check_precision()
    return torch.matmul(a, b.T)


def _factor(n: int, hurst: float, maturity: float, device) -> torch.Tensor:
    return torch.as_tensor(_volterra_chol(n, hurst, float(maturity)), device=device)


def rbergomi_variance_grid(params: RBergomiParams, v_tilde, t_grid):
    """v_t on the grid from the exact Volterra draw."""
    return params.xi0 * torch.exp(params.eta * v_tilde
                                  - 0.5 * params.eta**2 * t_grid ** (2 * params.hurst))


def _antithetic(generator, half: int, cols: int):
    z = torch.randn((half, cols), generator=generator, dtype=F32, device=generator.device)
    return torch.cat([z, -z])


def _draw(generator, n_paths: int, n: int):
    """(z, zp): the antithetic (paths × 2n) Volterra block, then the
    (paths × n) orthogonal spot block."""
    z = _antithetic(generator, n_paths // 2, 2 * n)
    return z, _antithetic(generator, n_paths // 2, n)


def _t32(x, device):
    return torch.as_tensor(x, dtype=F32, device=device)


def _t_grid(maturity: float, n: int, device):
    return torch.as_tensor(np.linspace(maturity / n, maturity, n).astype(np.float32),
                           device=device)


def _log_increments(z, zp, lmat, t_grid, dt, xi_left, eta, rho, hurst):
    """(sqrt(v_left)·dz − v_left·dt/2) per step, (paths, n): the left-point
    spot integral's terms from the exact (V~, W) draw."""
    n = t_grid.shape[0]
    vw = _matmul_t(z, lmat)  # the exact joint (V~, W) draw
    v_tilde, w_lvl = vw[:, :n], vw[:, n:]
    dw = torch.diff(w_lvl, dim=1, prepend=torch.zeros_like(w_lvl[:, :1]))
    expf = torch.exp(eta * v_tilde - 0.5 * eta**2 * t_grid[None, :] ** (2 * hurst))
    expf_left = torch.cat([torch.ones_like(expf[:, :1]), expf[:, :-1]], dim=1)
    v_left = xi_left * expf_left
    srho = torch.sqrt(torch.clamp_min(1.0 - rho**2, 0.0))
    dz = rho * dw + srho * torch.sqrt(dt) * zp
    return torch.sqrt(v_left) * dz - 0.5 * v_left * dt


def _terminal_spots(spot, rate, dividend, xi0, eta, rho, *, hurst: float, maturity: float,
                    z, zp):
    """Terminal spots S_T from the normals (z, zp), differentiable in (spot,
    rate, dividend, xi0, eta, rho). ``xi0`` is a scalar or the (n,)
    forward-variance curve at the left grid times [0, t_1, ..., t_{n-1}]."""
    dev = z.device
    n = zp.shape[1]
    lmat = _factor(n, hurst, maturity, dev)
    t_grid = _t_grid(maturity, n, dev)
    dt = _t32(maturity / n, dev)
    xi_left = torch.as_tensor(xi0, dtype=F32, device=dev).reshape(-1).expand(n)[None, :]
    log_s = _log_increments(z, zp, lmat, t_grid, dt, xi_left, eta, rho, hurst).sum(dim=1)
    return spot * torch.exp((rate - dividend) * maturity + log_s)


def _rbergomi_core(spot, strikes, maturity, rate, dividend, cp, params: RBergomiParams,
                   generator, n_paths: int, n_steps: int, xi_left=None):
    dev = generator.device
    xi = _t32(params.xi0 if xi_left is None else xi_left, dev)
    z, zp = _draw(generator, n_paths, n_steps)
    st = _terminal_spots(_t32(spot, dev), _t32(rate, dev), _t32(dividend, dev), xi,
                         _t32(params.eta, dev), _t32(params.rho, dev), hurst=params.hurst,
                         maturity=maturity, z=z, zp=zp)
    disc = torch.exp(-_t32(rate, dev) * maturity)
    pay = torch.clamp_min(cp[:, None] * (st[None, :] - strikes[:, None]), 0.0)
    return disc * pay.mean(dim=1), disc * pay.std(dim=1, correction=0) / math.sqrt(n_paths)


def _cp_of(option_type) -> float:
    return 1.0 if str(option_type).lower() in ("call", "c", "1") else -1.0


def rbergomi_price(spot, strikes, maturity, rate, params: RBergomiParams,
                   generator: torch.Generator, dividend=0.0, option_type="call",
                   n_paths: int = 100_000, n_steps: int = 256, xi_curve=None):
    """European prices under rBergomi over a strike array (one path set for
    every strike), on the generator's device: (prices, stderr).

    ``xi_curve``: an optional forward-variance term structure, a callable
    t -> xi0(t) (evaluated on the host at the left grid times) or an
    (n_steps,) array at [0, t_1, ..., t_{n-1}]; it overrides ``params.xi0``."""
    params.validate()
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    dev = generator.device
    strikes = torch.atleast_1d(torch.as_tensor(strikes, dtype=F32, device=dev))
    cp = torch.full(strikes.shape, _cp_of(option_type), dtype=F32, device=dev)
    xi_left = None
    if xi_curve is not None:
        t_left = np.linspace(0.0, float(maturity), n_steps, endpoint=False)
        xi_left = (np.asarray([float(xi_curve(t)) for t in t_left], np.float32)
                   if callable(xi_curve) else np.asarray(xi_curve, np.float32))
        if xi_left.shape != (n_steps,):
            raise ValidationError(f"xi_curve array must have shape ({n_steps},), "
                                  f"got {xi_left.shape}")
        if np.any(xi_left <= 0):
            raise ValidationError("xi_curve must be positive")
    return _rbergomi_core(spot, strikes, float(maturity), rate, dividend, cp, params, generator,
                          n_paths, n_steps, xi_left=xi_left)


def xi_curve_from_variance_swaps(maturities, variance_strikes):
    """Forward-variance curve xi0(t) from variance-swap strikes: piecewise
    constant between quoted maturities, xi0 = d(K_var·T)/dT. Returns a
    callable t -> xi0(t) (flat beyond the ends)."""
    t = np.asarray(maturities, np.float64)
    k = np.asarray(variance_strikes, np.float64)
    if t.ndim != 1 or t.shape != k.shape or len(t) == 0:
        raise ValidationError("need matching 1-D maturities/strikes")
    if np.any(np.diff(t) <= 0) or t[0] <= 0:
        raise ValidationError("maturities must be positive and increasing")
    tot = k * t
    fwd = np.diff(tot, prepend=0.0) / np.diff(t, prepend=0.0)
    if np.any(fwd <= 0):
        raise ValidationError("variance-swap term structure implies non-positive forward "
                              "variance (calendar arbitrage in the quotes)")

    def xi(tq):
        idx = np.searchsorted(t, np.asarray(tq, np.float64), side="left")
        return fwd[np.minimum(idx, len(fwd) - 1)]

    return xi


def rbergomi_smile_iv(k_log_moneyness, maturity, params: RBergomiParams,
                      generator: torch.Generator, spot=100.0, rate=0.0, n_paths: int = 200_000,
                      n_steps: int = 256):
    """Implied-vol smile at forward log-moneyness points (OTM side priced,
    both sides on the same draw), as a numpy array."""
    from .iv import implied_vol

    k = np.atleast_1d(np.asarray(k_log_moneyness, np.float64))
    fwd = spot * np.exp(rate * maturity)
    strikes = fwd * np.exp(k)
    cp = np.where(k <= 0, -1.0, 1.0)
    prices = np.empty_like(k)
    state = generator.get_state()
    for sign in (-1.0, 1.0):
        m = cp == sign
        if m.any():
            generator.set_state(state)  # both sides on one draw, as on one key
            p, _ = rbergomi_price(spot, strikes[m], maturity, rate, params, generator,
                                  option_type="call" if sign > 0 else "put", n_paths=n_paths,
                                  n_steps=n_steps)
            prices[m] = p.cpu().numpy()
    dev = generator.device
    return implied_vol(_t32(prices, dev), _t32(spot, dev), _t32(strikes, dev),
                       _t32(maturity, dev), _t32(rate, dev), _t32(cp, dev)).cpu().numpy()


def rbergomi_greeks(spot, strike, maturity, rate, params: RBergomiParams,
                    generator: torch.Generator, dividend=0.0, option_type="call",
                    n_paths: int = 200_000, n_steps: int = 128) -> dict:
    """Pathwise Greeks under rough Bergomi: delta, rate rho, dividend
    sensitivity, d/d xi0 (and its Black–Scholes-equivalent ``vega`` =
    dP/dxi0 · 2√xi0), d/d eta, d/d rho by one autograd pass over one fixed
    draw; gamma by a central difference of the autograd delta on the same
    draw. Python floats."""
    params.validate()
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    cp = _cp_of(option_type)
    dev = generator.device
    z, zp = _draw(generator, n_paths, n_steps)

    def price_of(s, r, q, x0, et, rh):
        st = _terminal_spots(s, r, q, x0, et, rh, hurst=params.hurst, maturity=float(maturity),
                             z=z, zp=zp)
        return torch.exp(-r * float(maturity)) * torch.clamp_min(cp * (st - strike), 0.0).mean()

    def leaves(s):
        return [_t32(x, dev).requires_grad_(True) for x in (s, rate, dividend, params.xi0,
                                                            params.eta, params.rho)]

    args = leaves(spot)
    price = price_of(*args)
    grads = torch.autograd.grad(price, args)
    h = 0.02 * float(spot)
    deltas = []
    for s in (float(spot) + h, float(spot) - h):
        a = leaves(s)
        deltas.append(torch.autograd.grad(price_of(*a), a[0])[0])
    gamma = (deltas[0] - deltas[1]) / (2.0 * h)
    d_s, d_r, d_q, d_xi0, d_eta, d_rho = (float(g) for g in grads)
    return {"price": float(price), "delta": d_s, "gamma": float(gamma), "rho_rate": d_r,
            "div_sens": d_q, "vega_xi0": d_xi0, "vega": d_xi0 * 2.0 * float(np.sqrt(params.xi0)),
            "vega_eta": d_eta, "corr_sens": d_rho}


RBERGOMI_EXOTIC_KINDS = (
    "asian_arith", "asian_geo", "lookback_float", "lookback_fixed",
    "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out", "barrier_down-and-in",
    "one_touch_up", "one_touch_down", "no_touch_up", "no_touch_down",
    # range accrual: barrier = lower bound, strike = upper bound, pays 100 x
    # the accrual fraction
    "range_accrual",
    # double kinds take barrier=(lower, upper)
    "barrier_double-out", "barrier_double-in", "one_touch_double", "no_touch_double",
    # pay-at-hit one-touches: unit cash discounted at the first hit
    "one_touch_up_hit", "one_touch_down_hit", "one_touch_double_hit",
)


def _spot_paths(spot, maturity, rate, dividend, xi0, eta, rho, hurst, z, zp):
    """The full spot-path matrix under the exact Volterra law: ``(s_path, x)``
    (paths, n_steps) at t_1..t_n, x = ln(S_{t_i}/S0) with the drift;
    differentiable in (spot, rate, dividend, xi0, eta, rho)."""
    dev = z.device
    n = zp.shape[1]
    lmat = _factor(n, hurst, maturity, dev)
    t_grid = _t_grid(maturity, n, dev)
    dt = _t32(maturity / n, dev)
    inc = _log_increments(z, zp, lmat, t_grid, dt, xi0, eta, rho, hurst)
    x = torch.cumsum(inc, dim=1) + (rate - dividend) * t_grid[None, :]
    return spot * torch.exp(x), x


def _rbergomi_exotic_core(kind, spot, strike, maturity, rate, dividend, cp, barrier, xi0, eta,
                          rho, hurst, z, zp, return_stderr):
    """Path matrix under the exact Volterra law → the payoff. Monitoring
    matches the GBM/Heston engines (Asian averages steps 1..n; extrema,
    barriers and touches include S0)."""
    s_path, x = _spot_paths(spot, maturity, rate, dividend, xi0, eta, rho, hurst, z, zp)
    s_t = s_path[:, -1]
    barrier_up = "up" in kind
    knock_in = kind.endswith("in")
    if kind == "range_accrual":
        in_rng = ((s_path >= barrier) & (s_path <= strike)).to(F32)
        pay = 100.0 * in_rng.mean(dim=1)
    elif kind == "asian_arith":
        pay = torch.clamp_min(cp * (s_path.mean(dim=1) - strike), 0.0)
    elif kind == "asian_geo":
        pay = torch.clamp_min(cp * (spot * torch.exp(x.mean(dim=1)) - strike), 0.0)
    elif kind == "lookback_float":
        ext = (torch.minimum(s_path.min(dim=1).values, spot) if cp > 0
               else torch.maximum(s_path.max(dim=1).values, spot))
        pay = cp * (s_t - ext)
    elif kind == "lookback_fixed":
        ext = (torch.maximum(s_path.max(dim=1).values, spot) if cp > 0
               else torch.minimum(s_path.min(dim=1).values, spot))
        pay = torch.clamp_min(cp * (ext - strike), 0.0)
    elif kind.endswith("_hit"):
        # cash at the first hit: the hit step off the path matrix
        if "double" in kind:
            hit_mat = (s_path <= barrier[0]) | (s_path >= barrier[1])
            hit0 = (spot <= barrier[0]) | (spot >= barrier[1])
        elif barrier_up:
            hit_mat, hit0 = s_path >= barrier, spot >= barrier
        else:
            hit_mat, hit0 = s_path <= barrier, spot <= barrier
        any_hit = hit_mat.any(dim=1)
        first = torch.argmax(hit_mat.to(torch.uint8), dim=1).to(F32) + 1.0
        dt = _t32(maturity, s_path.device) / hit_mat.shape[1]
        df_hit = torch.exp(-rate * dt * first)
        pay = torch.where(hit0, 1.0, torch.where(any_hit, df_hit, 0.0))
    else:
        if "double" in kind:
            hit = ((torch.minimum(s_path.min(dim=1).values, spot) <= barrier[0])
                   | (torch.maximum(s_path.max(dim=1).values, spot) >= barrier[1]))
        elif barrier_up:
            hit = torch.maximum(s_path.max(dim=1).values, spot) >= barrier
        else:
            hit = torch.minimum(s_path.min(dim=1).values, spot) <= barrier
        hit = hit.to(F32)
        if "touch" in kind:
            pay = hit if kind.startswith("one") else (1.0 - hit)
        else:
            vanilla = torch.clamp_min(cp * (s_t - strike), 0.0)
            pay = vanilla * (hit if knock_in else (1.0 - hit))
    # the pay-at-hit kinds carry the discount in the payoff already
    df = 1.0 if kind.endswith("_hit") else torch.exp(-rate * maturity)
    price = df * pay.mean()
    if not return_stderr:
        return price
    return price, df * pay.std(correction=1) / math.sqrt(pay.shape[0])


def _exotic_args(params, spot, rate, dividend, dev):
    return (_t32(spot, dev), _t32(rate, dev), _t32(dividend, dev), _t32(params.xi0, dev),
            _t32(params.eta, dev), _t32(params.rho, dev))


def rbergomi_exotic_price(kind: str, spot, strike, maturity, rate, params: RBergomiParams,
                          generator: torch.Generator, cp: float = 1.0, dividend: float = 0.0,
                          barrier=0.0, n_paths: int = 100_000, n_steps: int = 256,
                          return_stderr: bool = False):
    """Exotics under rough volatility (``kind`` in RBERGOMI_EXOTIC_KINDS) on
    the generator's device; at eta -> 0 they reduce to the GBM engines with
    sigma = sqrt(xi0). The price (and stderr) as 0-dim tensors."""
    params.validate()
    if kind not in RBERGOMI_EXOTIC_KINDS:
        raise ValidationError(f"unknown rbergomi exotic kind {kind!r}; "
                              f"choose {RBERGOMI_EXOTIC_KINDS}")
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    dev = generator.device
    b = ((float(barrier[0]), float(barrier[1])) if "double" in kind else float(barrier))
    s0, r, q, xi0, eta, rho = _exotic_args(params, spot, rate, dividend, dev)
    z, zp = _draw(generator, n_paths, n_steps)
    return _rbergomi_exotic_core(kind, s0, float(strike), float(maturity), r, q, float(cp), b,
                                 xi0, eta, rho, float(params.hurst), z, zp, return_stderr)


def _pair_se(pay, df):
    """Stderr over the antithetic pair means (paths i and i + n/2)."""
    half = pay.shape[0] // 2
    pair_mean = 0.5 * (pay[:half] + pay[half:])
    return df * pair_mean.std(correction=1) / math.sqrt(half)


def rbergomi_cliquet_price(spot, maturity, rate, params: RBergomiParams,
                           generator: torch.Generator, dividend: float = 0.0,
                           local_floor: float = -0.05, local_cap: float = 0.05,
                           global_floor: float = 0.0, global_cap: float = 1e9,
                           notional: float = 100.0, n_periods: int = 12,
                           n_paths: int = 100_000, n_steps: int = 252,
                           return_stderr: bool = False):
    """Cliquet under rough volatility: period returns at ``n_periods`` equal
    fixings, local clip then global clip, discounted at maturity."""
    params.validate()
    if n_periods <= 0 or n_steps % n_periods:
        raise ValidationError("n_steps must be a positive multiple of n_periods")
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    dev = generator.device
    s0, r, q, xi0, eta, rho = _exotic_args(params, spot, rate, dividend, dev)
    z, zp = _draw(generator, n_paths, n_steps)
    s_path, _ = _spot_paths(s0, float(maturity), r, q, xi0, eta, rho, float(params.hurst), z,
                            zp)
    per = n_steps // n_periods
    fix = s_path[:, per * np.arange(1, n_periods + 1) - 1]
    prev = torch.cat([s0.expand(n_paths, 1), fix[:, :-1]], dim=1)
    acc = torch.clamp(fix / prev - 1.0, local_floor, local_cap).sum(dim=1)
    pay = notional * torch.clamp(acc, global_floor, global_cap)
    df = torch.exp(-r * float(maturity))
    price = df * pay.mean()
    return (price, _pair_se(pay, df)) if return_stderr else price


def rbergomi_autocall_price(spot, maturity, rate, params: RBergomiParams,
                            generator: torch.Generator, dividend: float = 0.0,
                            notional: float = 100.0, autocall_barrier: float = 1.0,
                            coupon_barrier: float = 0.8, ki_barrier: float = 0.7,
                            coupon_rate: float = 0.08, n_obs: int = 4, n_paths: int = 100_000,
                            n_steps: int = 252, return_stderr: bool = False):
    """Autocallable under rough volatility, with the conventions of
    ``models/exotics``: n_obs equal observations (call at par + coupon when
    S >= autocall·S0, coupons while S >= coupon barrier·S0), per-step
    knock-in at ki·S0 making the redemption a short put."""
    params.validate()
    if n_obs <= 0 or n_steps % n_obs:
        raise ValidationError("n_steps must be a positive multiple of n_obs")
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    dev = generator.device
    s0, r, q, xi0, eta, rho = _exotic_args(params, spot, rate, dividend, dev)
    z, zp = _draw(generator, n_paths, n_steps)
    s_path, _ = _spot_paths(s0, float(maturity), r, q, xi0, eta, rho, float(params.hurst), z,
                            zp)
    cols = (n_steps // n_obs) * np.arange(1, n_obs + 1) - 1
    s_obs = s_path[:, cols]
    t_obs = _t32(maturity / n_steps, dev) * torch.as_tensor(cols + 1, dtype=F32, device=dev)
    df_obs = torch.exp(-r * t_obs)
    call_hit = s_obs >= autocall_barrier * s0
    # alive at observation j <=> no call at an earlier observation
    prior_calls = torch.cumsum(call_hit.to(torch.int32), dim=1) - call_hit.to(torch.int32)
    alive_at = prior_calls == 0
    couponed = alive_at & (s_obs >= coupon_barrier * s0)
    called = alive_at & call_hit
    pv = (torch.where(couponed, df_obs * notional * coupon_rate / n_obs, 0.0)
          + torch.where(called, df_obs * notional, 0.0)).sum(dim=1)
    ki = (s_path <= ki_barrier * s0).any(dim=1)
    alive_end = ~call_hit.any(dim=1)
    loss = torch.clamp_max(s_path[:, -1] / s0, 1.0)
    final = torch.where(ki, notional * loss, notional)
    df_t = torch.exp(-r * float(maturity))
    pay = pv + torch.where(alive_end, df_t * final, 0.0)
    price = pay.mean()
    return (price, _pair_se(pay, 1.0)) if return_stderr else price


# ---------------------------------------------------------------------------
# Chain pricing and the (H, eta, rho, xi0) calibration
# ---------------------------------------------------------------------------
_GL64_X, _GL64_W = np.polynomial.legendre.leggauss(64)


def _volterra_cov_dynamic(t_grid, h):
    """The (2n, 2n) covariance of (V~, W) as a differentiable function of the
    Hurst exponent ``h`` (the host quadrature in torch ops, on any positive
    grid); powers of possibly-zero bases are masked before the power so the
    h-gradient never sees 0·log 0."""
    t = t_grid
    dev = t.device
    p = 1.0 / (h + 0.5)
    xq = torch.as_tensor(_GL64_X, dtype=F32, device=dev)
    wq = torch.as_tensor(_GL64_W, dtype=F32, device=dev)
    b = t ** (h + 0.5)
    wn = 0.5 * b[:, None] * (xq[None, :] + 1.0)
    ww = 0.5 * b[:, None] * wq[None, :]
    u = wn ** p
    diff = t[None, :, None] - t[:, None, None] + u[:, None, :]
    later = t[None, :] >= t[:, None]
    f = torch.where(later[:, :, None], diff, 1.0) ** (h - 0.5)
    val = 2.0 * h * p * torch.einsum("iq,ijq->ij", ww, f)
    upper = torch.where(t[None, :] > t[:, None], val, 0.0)
    c_vv = upper + upper.T + torch.diag(t ** (2.0 * h))
    mn = torch.minimum(t[:, None], t[None, :])
    gap = t[:, None] - mn
    gap_pow = torch.where(gap > 0, torch.where(gap > 0, gap, 1.0) ** (h + 0.5), 0.0)
    c_vw = torch.sqrt(2.0 * h) / (h + 0.5) * (b[:, None] - gap_pow)
    return torch.cat([torch.cat([c_vv, c_vw], dim=1), torch.cat([c_vw.T, mn], dim=1)], dim=0)


def _volterra_logs_dynamic(t_grid, h, eta, rho, xi0, rate, dividend, z, zp):
    """Relative log-spot paths ln(S_{t_i}/S0) on a positive grid,
    differentiable in every parameter including h; (z, zp) drawn once by the
    caller so every loss evaluation reuses the same noise."""
    t = t_grid
    n = t.shape[0]
    cov = _volterra_cov_dynamic(t, h)
    jit_eps = 1e-6 * torch.mean(torch.diag(cov))
    lmat = torch.linalg.cholesky(cov + jit_eps * torch.eye(2 * n, dtype=cov.dtype,
                                                           device=cov.device))
    vw = _matmul_t(z, lmat)
    v_tilde, w_lvl = vw[:, :n], vw[:, n:]
    dw = torch.diff(w_lvl, dim=1, prepend=torch.zeros_like(w_lvl[:, :1]))
    dt = torch.diff(t, prepend=torch.zeros_like(t[:1]))
    expf = torch.exp(eta * v_tilde - 0.5 * eta**2 * t[None, :] ** (2.0 * h))
    expf_left = torch.cat([torch.ones_like(expf[:, :1]), expf[:, :-1]], dim=1)
    v_left = xi0 * expf_left
    srho = torch.sqrt(torch.clamp_min(1.0 - rho**2, 0.0))
    dz = rho * dw + srho * torch.sqrt(dt)[None, :] * zp
    return (torch.cumsum(torch.sqrt(v_left) * dz - 0.5 * v_left * dt[None, :], dim=1)
            + (rate - dividend) * t[None, :])


def _chain_grid(expiries, max_dt: float, min_seg: int):
    """Host simulation grid through every expiry: (t_grid, expiry_index),
    each segment subdivided at ~max_dt (at least ``min_seg`` substeps)."""
    exps = sorted({float(t) for t in np.asarray(expiries).ravel()})
    if exps[0] <= 0:
        raise ValidationError("expiries must be positive")
    grid: list[float] = []
    idx: dict[float, int] = {}
    prev = 0.0
    for te in exps:
        m = max(min_seg, int(np.ceil((te - prev) / max_dt)))
        grid.extend(np.linspace(prev, te, m + 1)[1:].tolist())
        idx[te] = len(grid) - 1
        prev = te
    return np.asarray(grid, np.float32), idx


def _chain_setup(strikes, maturities, cps, rate, max_dt, min_seg, dev):
    strikes = np.asarray(strikes, np.float32).ravel()
    mats = np.asarray(maturities, np.float32).ravel()
    cps = np.asarray(cps, np.float32).ravel()
    t_grid, idx = _chain_grid(mats, max_dt, min_seg)
    e_idx = torch.as_tensor([idx[float(t)] for t in mats], dtype=torch.int64, device=dev)
    dfs = torch.exp(-_t32(rate, dev) * _t32(mats, dev))
    return _t32(t_grid, dev), e_idx, _t32(strikes, dev), _t32(cps, dev), dfs, strikes, mats, cps


def rbergomi_chain_price(strikes, maturities, cps, spot, rate, params: RBergomiParams,
                         generator: torch.Generator, dividend: float = 0.0,
                         n_paths: int = 131_072, max_dt: float = 0.02, min_seg: int = 16):
    """A multi-expiry vanilla chain under rough Bergomi on one path set to the
    longest expiry (common random numbers across the chain), with the
    covariance built in the graph (H differentiable)."""
    params.validate()
    dev = generator.device
    tg, e_idx, ks, cpj, dfs, *_ = _chain_setup(strikes, maturities, cps, rate, max_dt,
                                               min_seg, dev)
    z, zp = _draw(generator, n_paths, tg.shape[0])
    x = _volterra_logs_dynamic(tg, _t32(params.hurst, dev), _t32(params.eta, dev),
                               _t32(params.rho, dev), _t32(params.xi0, dev), _t32(rate, dev),
                               _t32(dividend, dev), z, zp)
    pay = torch.clamp_min(cpj[None, :] * (float(spot) * torch.exp(x[:, e_idx]) - ks[None, :]),
                          0.0)
    return dfs * pay.mean(dim=0)


def _rb_to_unconstrained(p: RBergomiParams, device):
    h = np.clip(p.hurst, 1e-3, 0.499)
    return torch.tensor([np.log(h / (0.5 - h)), np.log(np.expm1(max(p.eta, 1e-4))),
                         np.arctanh(np.clip(p.rho, -0.999, 0.999)), np.log(max(p.xi0, 1e-6))],
                        dtype=F32, device=device)


def _rb_from_unconstrained(x):
    return (0.5 * torch.sigmoid(x[0]), torch.nn.functional.softplus(x[1]), torch.tanh(x[2]),
            torch.exp(x[3]))


def calibrate_rbergomi(market_prices, strikes, maturities, cps, spot, rate,
                       dividend: float = 0.0, init: RBergomiParams | None = None,
                       n_steps: int = 300, learning_rate: float = 0.05, n_paths: int = 65_536,
                       max_dt: float = 0.02, min_seg: int = 16, seed: int = 0, weights=None,
                       device="cuda") -> tuple[RBergomiParams, float]:
    """Calibrate (H, eta, rho, xi0) to a vanilla chain by Adam
    (``ops/optim.scan_adam``) on a common-random-numbers Monte Carlo loss on
    ``device``: the noise is drawn once (generator seeded ``seed``) and every
    step reprices the same path functional; the covariance and its Cholesky
    factor are in the differentiated graph, so dLoss/dH flows. The loss is
    the mean squared relative price error (``weights`` optional). Returns
    (params, best_loss)."""
    from ..ops.optim import scan_adam

    dev = torch.device(device)
    market = _t32(np.asarray(market_prices, np.float32).ravel(), dev)
    w = torch.ones_like(market) if weights is None else \
        _t32(np.asarray(weights, np.float32).ravel(), dev)
    tg, e_idx, ks, cpj, dfs, strikes_np, mats, cps_np = _chain_setup(
        strikes, maturities, cps, rate, max_dt, min_seg, dev)
    if not market.shape[0] == strikes_np.shape[0] == mats.shape[0] == cps_np.shape[0]:
        raise ValidationError("market/strikes/maturities/cps must align")
    init = init or RBergomiParams(hurst=0.15, eta=1.5, rho=-0.6, xi0=0.04)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    z, zp = _draw(gen, n_paths, tg.shape[0])
    s0, r, q = float(spot), _t32(rate, dev), _t32(dividend, dev)

    def loss_fn(x):
        h, eta, rho, xi0 = _rb_from_unconstrained(x)
        xl = _volterra_logs_dynamic(tg, h, eta, rho, xi0, r, q, z, zp)
        pay = torch.clamp_min(cpj[None, :] * (s0 * torch.exp(xl[:, e_idx]) - ks[None, :]), 0.0)
        model = dfs * pay.mean(dim=0)
        rel = (model - market) / torch.clamp_min(market, 1e-3)
        return torch.mean(w * rel * rel)

    best_x, best_loss, _ = scan_adam(loss_fn, _rb_to_unconstrained(init, dev), n_steps,
                                     learning_rate)
    if not np.isfinite(float(best_loss)):
        raise CalibrationError("rBergomi calibration diverged (non-finite loss)")
    h, eta, rho, xi0 = (float(v) for v in _rb_from_unconstrained(best_x))
    params = RBergomiParams(hurst=h, eta=eta, rho=rho, xi0=xi0)
    params.validate()
    return params, float(best_loss)


def rbergomi_exotic_greeks(kind: str, spot, strike, maturity, rate, params: RBergomiParams,
                           generator: torch.Generator, cp: float = 1.0, dividend: float = 0.0,
                           n_paths: int = 100_000, n_steps: int = 256) -> dict:
    """Pathwise Greeks of the continuous rough-vol exotics (Asians,
    lookbacks): delta, rate rho, d/d xi0 (and ``vega`` = dP/dxi0·2√xi0),
    d/d eta, d/d rho by one autograd pass over one fixed draw; gamma by a
    central difference (±0.5) of the autograd delta on the same draw."""
    params.validate()
    if kind not in ("asian_arith", "asian_geo", "lookback_float", "lookback_fixed"):
        raise ValidationError("pathwise AD covers asian/lookback kinds (continuous payoffs), "
                              f"got {kind!r}")
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic)")
    dev = generator.device
    z, zp = _draw(generator, n_paths, n_steps)
    q = _t32(dividend, dev)

    def price_of(s0, r, xi0, eta, rho):
        return _rbergomi_exotic_core(kind, s0, float(strike), float(maturity), r, q, float(cp),
                                     0.0, xi0, eta, rho, float(params.hurst), z, zp, False)

    def leaves(s):
        return [_t32(x, dev).requires_grad_(True)
                for x in (s, rate, params.xi0, params.eta, params.rho)]

    args = leaves(spot)
    price = price_of(*args)
    grads = torch.autograd.grad(price, args)
    h = 0.5
    d_up, d_dn = (torch.autograd.grad(price_of(*a), a[0])[0]
                  for a in (leaves(float(np.float32(spot) + np.float32(h))),
                            leaves(float(np.float32(spot) - np.float32(h)))))
    d_xi0 = float(grads[2])
    return {"price": float(price), "delta": float(grads[0]), "gamma": float((d_up - d_dn) / 1.0),
            "rho": float(grads[1]), "vega_xi0": d_xi0,
            "vega": d_xi0 * 2.0 * float(np.sqrt(params.xi0)), "vega_eta": float(grads[3]),
            "corr_sens": float(grads[4])}
