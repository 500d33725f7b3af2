"""American options: certified [lower, upper] price brackets under GBM.

The port of ``optionslab_tpu/models/american.py``. Three engines:

1. **Payoff-feature LSM** — polynomials in the centred moneyness S/K − 1
   plus the normalised intrinsic h/K, fitted on one path set
   (:func:`fit_lsm_policy`) and priced out of sample on fresh paths
   (:func:`lsm_lower_bound`, by default with the dual's martingale as a
   control variate). Upper bounds on that policy: Andersen–Broadie nested
   simulation (:func:`ab_upper_bound`) and the deterministic polynomial
   martingale (:func:`dual_upper_bound`, exact lognormal partial moments).
2. **Grid engine** — a Bermudan induction on a uniform log-spot grid whose
   one-step expectation of the piecewise-linear value is a closed-form
   Gaussian hat-moment convolution (:func:`grid_value_surface`, float64,
   ``conv1d``). The value splits into Black–Scholes plus a residual: the
   discounted BS part telescopes and the residual's conditional expectation
   is an exact windowed hat sum, so one forward pass gives both certified
   bounds (``method="grid"`` of :func:`american_price_interval`).
3. **Continuous-exercise certificate** (:func:`american_continuous_interval`):
   the Bermudan bracket plus the rK·Δt pad.

The Monte Carlo passes draw from one ``torch.Generator`` on the device,
loop over the exercise dates in Python and keep every path alive under a
mask (no data-dependent shapes); the regressions solve their small normal
equations with ``torch.linalg.solve_ex`` (no host check per date). The
LSM fits and the nested bound run in float32, the closed-form dual, the
grid engine and its bounds in float64.
"""

from __future__ import annotations

import dataclasses
import math
from math import comb

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.math import norm_cdf
from ..utils.exceptions import ValidationError
from .black_scholes import bs_price

F64 = torch.float64


def _features(s, strike, cp, basis: int):
    """(basis + 2, ...) regression features 1, x, …, x^basis, h/K with
    x = S/K − 1 (centred: stable float32 normal equations) and h the
    intrinsic payoff (the kink feature near the exercise boundary)."""
    x = s / strike - 1.0
    polys = [x**p for p in range(basis + 1)]
    h = torch.clamp_min(cp * (s - strike), 0.0) / strike
    return torch.stack(polys + [h], dim=0)


def _antithetic(generator, half, dtype):
    z = torch.randn(half, generator=generator, dtype=dtype, device=generator.device)
    return torch.cat([z, -z])


def _forward_log_paths(generator, n_paths, n_dates, drift, sig_dt, dtype):
    """(n_dates, n_paths) GBM log-spot moves from 0 at the exercise dates,
    antithetic halves, on the generator's device (the GBM LSM's paths too)."""
    half = n_paths // 2
    log_s = torch.zeros(2 * half, dtype=dtype, device=generator.device)
    rows = []
    for _ in range(n_dates):
        log_s = log_s + drift + sig_dt * _antithetic(generator, half, dtype)
        rows.append(log_s)
    return torch.stack(rows)


LSM_FIELDS = ("coefs", "vcoefs", "spot", "strike", "maturity", "rate", "vol", "cp", "dividend",
              "n_dates", "basis")


@dataclasses.dataclass(frozen=True)
class LSMPolicy:
    """Exercise policy: per-date continuation regression coefficients.

    ``coefs`` (ITM-weighted) drive the exercise rule; ``vcoefs``
    (unweighted, all paths) are the value-surface fit the dual uses. Row i
    is exercise date i (date i at time (i + 1)·Δt); the last row is zero.
    """

    coefs: torch.Tensor  # (n_dates, n_feat)
    vcoefs: torch.Tensor
    spot: float
    strike: float
    maturity: float
    rate: float
    vol: float
    cp: float
    dividend: float
    n_dates: int
    basis: int

    @classmethod
    def from_numpy(cls, fields, device=None) -> "LSMPolicy":
        """A policy from its fields, the coefficient tables as numpy arrays
        (keeping their dtype): ``{k: getattr(jax_policy, k) for k in
        LSM_FIELDS}`` carries a policy fitted by the JAX package across."""
        out = {k: fields[k] for k in LSM_FIELDS}
        for k in ("coefs", "vcoefs"):
            out[k] = torch.as_tensor(np.array(out[k]), device=device)
        return cls(**out)


def _fit_coefs(spot, strike, maturity, rate, vol, generator, cp, dividend, n_paths: int,
               n_dates: int, basis: int):
    dtype = torch.float32
    dt = maturity / n_dates
    drift = (rate - dividend - 0.5 * vol * vol) * dt
    sig_dt = vol * math.sqrt(dt)
    s_paths = spot * torch.exp(_forward_log_paths(generator, n_paths, n_dates, drift, sig_dt,
                                                  dtype))
    disc = math.exp(-rate * dt)
    n_feat = basis + 2
    ridge = 1e-7 * torch.eye(n_feat, dtype=dtype, device=s_paths.device)

    def solve(a, b):
        return torch.linalg.solve_ex(a / n_paths + ridge, (b / n_paths)[:, None])[0][:, 0]

    cash = torch.clamp_min(cp * (s_paths[-1] - strike), 0.0)
    coefs, vcoefs = [], []
    for idx in range(n_dates - 2, -1, -1):
        s = s_paths[idx]
        ex = torch.clamp_min(cp * (s - strike), 0.0)
        itm = ex > 0
        feats = _features(s, strike, cp, basis)
        fw = feats * itm.to(dtype)
        y = disc * cash
        coef = solve(fw @ feats.T, fw @ y)
        # the unweighted all-paths fit: the ITM policy fit extrapolates badly
        # out of the money, which the dual's value surface cannot afford
        vcoef = solve(feats @ feats.T, feats @ y)
        exercise = itm & (ex > coef @ feats)
        cash = torch.where(exercise, ex, y)
        coefs.append(coef)
        vcoefs.append(vcoef)
    # ascending dates and an all-zero terminal row: continuation at maturity
    # is 0, so the policy exercises any ITM payoff there
    term = torch.zeros((1, n_feat), dtype=dtype, device=s_paths.device)
    return (torch.cat([torch.stack(coefs[::-1]), term]) if coefs else term,
            torch.cat([torch.stack(vcoefs[::-1]), term]) if vcoefs else term)


def fit_lsm_policy(spot, strike, maturity, rate, vol, generator: torch.Generator | None = None,
                   cp=-1.0, dividend=0.0, n_paths: int = 200_000, n_dates: int = 50,
                   basis: int = 3, device="cuda") -> LSMPolicy:
    """Fit the exercise policy on its own path set (the training pass),
    drawing from ``generator`` on its device, or from a generator seeded 0
    on ``device``."""
    gen = (generator if generator is not None
           else torch.Generator(device=torch.device(device)).manual_seed(0))
    args = [float(x) for x in (spot, strike, maturity, rate, vol, cp, dividend)]
    coefs, vcoefs = _fit_coefs(*args[:5], gen, args[5], args[6], n_paths, n_dates, basis)
    return LSMPolicy(coefs, vcoefs, *args[:5], args[5], args[6], n_dates, basis)


def _policy_exercise(policy_coefs, s, idx, strike, cp, basis):
    """(stop, intrinsic): True where the policy exercises at date ``idx``."""
    ex = torch.clamp_min(cp * (s - strike), 0.0)
    cont = torch.einsum("f,f...->...", policy_coefs[idx].to(s.dtype),
                        _features(s, strike, cp, basis))
    return (ex > 0) & (ex > cont), ex


def _mean_se(x):
    return x.mean(), x.std(correction=1) / math.sqrt(x.shape[0])


def _lower_from_policy(policy: LSMPolicy, generator, n_paths: int):
    """Out-of-sample lower bound: fresh float32 paths follow the policy."""
    p = policy
    dt = p.maturity / p.n_dates
    drift = (p.rate - p.dividend - 0.5 * p.vol * p.vol) * dt
    log_paths = _forward_log_paths(generator, n_paths, p.n_dates, drift, p.vol * math.sqrt(dt),
                                   torch.float32)
    s_paths = p.spot * torch.exp(log_paths)
    coefs = p.coefs.to(s_paths.device)
    alive = torch.ones(s_paths.shape[1], dtype=torch.bool, device=s_paths.device)
    pv = torch.zeros_like(s_paths[0])
    for idx in range(p.n_dates):
        stop, ex = _policy_exercise(coefs, s_paths[idx], idx, p.strike, p.cp, p.basis)
        df = math.exp(-p.rate * dt * (idx + 1))
        pv = pv + torch.where(alive & stop, df * ex, 0.0)
        alive = alive & ~stop
    price, se = _mean_se(pv)
    return torch.clamp_min(price, max(p.cp * (p.spot - p.strike), 0.0)), se


def lsm_lower_bound(policy: LSMPolicy, generator: torch.Generator, n_paths: int = 200_000,
                    use_cv: bool = True):
    """Unbiased lower bound (fresh paths, fixed policy). ``use_cv`` (the
    default) subtracts the dual's deterministic value-surface martingale at
    the stopping time: the same policy value, a stderr at dual-gap scale."""
    if use_cv:
        return _lsm_lower_cv(policy, generator, n_paths)
    return _lower_from_policy(policy, generator, n_paths)


def _ab_upper(policy: LSMPolicy, generator, n_outer: int, n_inner: int):
    """Andersen–Broadie duality gap by nested policy simulation (float32).

    V_k is the discounted policy value, M its martingale part with
    increments V_k − Ê[V_k | F_{k−1}], the conditional expectations from
    fresh inner policy simulations (the European option as control
    variate); U = Ê[max_k (h̃_k − M_k)] bounds the price above for any V.
    """
    p = policy
    dtype = torch.float32
    dev = generator.device
    n_dates = p.n_dates
    dt = p.maturity / n_dates
    drift = (p.rate - p.dividend - 0.5 * p.vol * p.vol) * dt
    sig_dt = p.vol * math.sqrt(dt)
    coefs = p.coefs.to(dev)

    def continuation_value(s, start_idx):
        """Ê[policy payoff from date start_idx + 1, discounted to start_idx |
        s] by n_inner antithetic inner paths per state, with the European
        option's Black–Scholes value as control variate."""
        half = n_inner // 2
        logs = torch.log(s)[..., None].expand(s.shape + (2 * half,))
        alive = torch.ones(logs.shape, dtype=torch.bool, device=dev)
        pv = torch.zeros(logs.shape, dtype=dtype, device=dev)
        euro = torch.clamp_min(p.cp * (s - p.strike), 0.0)[..., None].expand(logs.shape)
        for j in range(start_idx + 1, n_dates):
            z = torch.randn(s.shape + (half,), generator=generator, dtype=dtype, device=dev)
            logs = logs + drift + sig_dt * torch.cat([z, -z], dim=-1)
            stop, ex = _policy_exercise(coefs, torch.exp(logs), j, p.strike, p.cp, p.basis)
            df = math.exp(-p.rate * dt * (j - start_idx))
            pv = pv + torch.where(alive & stop, df * ex, 0.0)
            alive = alive & ~stop
            euro = df * ex
        tau = max((n_dates - 1 - start_idx) * dt, 1e-8)
        euro_cf = bs_price(s, p.strike, tau, p.rate, p.vol, p.cp, p.dividend)
        return pv.mean(dim=-1) - (euro.mean(dim=-1) - euro_cf)

    half_o = n_outer // 2
    log_s = torch.zeros(2 * half_o, dtype=dtype, device=dev)
    m_k = torch.zeros_like(log_s)
    h0 = max(p.cp * (p.spot - p.strike), 0.0)
    gap = torch.full_like(log_s, h0)
    for idx in range(n_dates):
        s_prev = p.spot * torch.exp(log_s)
        log_s = log_s + drift + sig_dt * _antithetic(generator, half_o, dtype)
        s = p.spot * torch.exp(log_s)
        df = math.exp(-p.rate * dt * (idx + 1))
        stop, ex = _policy_exercise(coefs, s, idx, p.strike, p.cp, p.basis)
        h = df * ex
        v_k = torch.where(stop, h, df * continuation_value(s, idx))
        e_v = math.exp(-p.rate * dt * idx) * continuation_value(s_prev, idx - 1)
        m_k = m_k + (v_k - e_v)
        gap = torch.maximum(gap, h - m_k)
    return _mean_se(gap)


def ab_upper_bound(policy: LSMPolicy, generator: torch.Generator, n_outer: int = 2_000,
                   n_inner: int = 128):
    """Andersen–Broadie dual upper bound for the fitted policy."""
    return _ab_upper(policy, generator, n_outer, n_inner)


# ---------------------------------------------------------------------------
# Closed-form martingale dual: no inner simulation
# ---------------------------------------------------------------------------
def _partial_moment(m, s, mu, sig, lo, hi):
    """E[S'^m · 1{lo < S' < hi} | S = s] for ln S' = ln s + mu + sig·Z."""
    def zc(x):
        x = torch.as_tensor(x, dtype=s.dtype, device=s.device)
        return (torch.log(torch.clamp_min(x, 1e-30) / s) - mu) / sig

    scale = s**m * math.exp(m * mu + 0.5 * m * m * sig * sig)
    return scale * (norm_cdf(zc(hi) - m * sig) - norm_cdf(zc(lo) - m * sig))


def _solve_boundaries(coefs, strike, cp, basis: int, n_dates: int, n_grid: int = 2048):
    """Per-date exercise boundary on a dense geometric grid: the highest
    spot (put) / lowest spot (call) where intrinsic beats the regressed
    continuation. The boundary defines the piecewise value approximation:
    its imperfections cost tightness, never validity."""
    lo, hi = (0.05, 1.0) if cp < 0 else (1.0, 20.0)
    grid = strike * torch.as_tensor(np.geomspace(lo, hi, n_grid), dtype=coefs.dtype,
                                    device=coefs.device)
    ex = torch.clamp_min(cp * (grid - strike), 0.0)
    cont = coefs @ _features(grid, strike, cp, basis)  # (n_dates, G)
    better = ex[None, :] > cont
    ranks = torch.arange(n_grid, device=coefs.device)[None, :]
    found = better.any(dim=1)
    if cp < 0:
        pick = torch.argmax(torch.where(better, ranks, -1), dim=1)
        return torch.where(found, grid[pick], grid[0])
    pick = torch.argmax(torch.where(better.flip(1), ranks, -1), dim=1)
    return torch.where(found, grid.flip(0)[pick], grid[-1])


def _piecewise_value(s, b, coef, strike, cp, basis: int):
    """Ṽ(s): intrinsic in the exercise region (cut at boundary b), the
    regression Ĉ elsewhere."""
    ex = torch.clamp_min(cp * (s - strike), 0.0)
    cont = torch.einsum("f,f...->...", coef, _features(s, strike, cp, basis))
    in_ex = (s < b) if cp < 0 else (s > b)
    return torch.where(in_ex, ex, cont)


def _expect_piecewise(s, b, coef, strike, cp, basis: int, mu, sig):
    """Exact E[Ṽ(S') | S = s] by lognormal partial moments: intrinsic over
    the exercise region, each monomial (S/K − 1)^j binomially expanded over
    the continuation region, the payoff feature over its sub-interval."""
    k = strike
    big = k * 1e6
    if cp < 0:
        ex_part = k * _partial_moment(0, s, mu, sig, 0.0, b) - _partial_moment(1, s, mu, sig,
                                                                                0.0, b)
        c_lo, c_hi, h_lo, h_hi = b, big, b, k
    else:
        ex_part = _partial_moment(1, s, mu, sig, b, big) - k * _partial_moment(0, s, mu, sig,
                                                                                b, big)
        c_lo, c_hi, h_lo, h_hi = 0.0, b, k, b
    cont_part = torch.zeros_like(s)
    for j in range(basis + 1):
        term = torch.zeros_like(s)
        for m in range(j + 1):
            term = term + comb(j, m) * ((-1.0) ** (j - m)) * (
                _partial_moment(m, s, mu, sig, c_lo, c_hi) / k**m)
        cont_part = cont_part + coef[j] * term
    h_pm = cp * (_partial_moment(1, s, mu, sig, h_lo, h_hi)
                 - k * _partial_moment(0, s, mu, sig, h_lo, h_hi)) / k
    return ex_part + cont_part + coef[basis + 1] * h_pm


def _dual_setup(policy: LSMPolicy, device):
    p = policy
    dt = p.maturity / p.n_dates
    mu = (p.rate - p.dividend - 0.5 * p.vol * p.vol) * dt
    sig = p.vol * math.sqrt(dt)
    coefs = p.coefs.to(device=device, dtype=F64)
    vcoefs = p.vcoefs.to(device=device, dtype=F64)
    bounds = _solve_boundaries(coefs, p.strike, p.cp, p.basis, p.n_dates)
    return dt, mu, sig, coefs, vcoefs, bounds


def _dual_upper_cf(policy: LSMPolicy, generator, n_outer: int):
    """Deterministic-martingale dual (float64): M's increments are ṽ(S_k)
    minus its exact conditional expectation, so the outer average is the
    only noise; U = Ê[max_k (h̃_k − M_k)] is valid for any martingale."""
    p = policy
    dev = generator.device
    dt, mu, sig, _, vcoefs, bounds = _dual_setup(p, dev)
    half = n_outer // 2
    log_s = torch.zeros(2 * half, dtype=F64, device=dev)
    m_mart = torch.zeros_like(log_s)
    best = torch.full_like(log_s, max(p.cp * (p.spot - p.strike), 0.0))
    for idx in range(p.n_dates):
        s_prev = p.spot * torch.exp(log_s)
        log_s = log_s + mu + sig * _antithetic(generator, half, F64)
        s = p.spot * torch.exp(log_s)
        df = math.exp(-p.rate * dt * (idx + 1))
        v_k = df * _piecewise_value(s, bounds[idx], vcoefs[idx], p.strike, p.cp, p.basis)
        e_v = df * _expect_piecewise(s_prev, bounds[idx], vcoefs[idx], p.strike, p.cp, p.basis,
                                     mu, sig)
        m_mart = m_mart + (v_k - e_v)
        best = torch.maximum(best, df * torch.clamp_min(p.cp * (s - p.strike), 0.0) - m_mart)
    return _mean_se(best)


def dual_upper_bound(policy: LSMPolicy, generator: torch.Generator, n_outer: int = 500_000):
    """Closed-form-martingale dual upper bound (no nested simulation)."""
    return _dual_upper_cf(policy, generator, n_outer)


def _lsm_lower_cv(policy: LSMPolicy, generator, n_paths: int):
    """The LSM policy's lower bound with the dual's value-surface martingale
    (M_0 = 0) subtracted at the stopping time: unbiased by optional
    stopping, its noise the duality gap's rather than the payoff's."""
    p = policy
    dev = generator.device
    dt, mu, sig, coefs, vcoefs, bounds = _dual_setup(p, dev)
    half = n_paths // 2
    log_s = torch.zeros(2 * half, dtype=F64, device=dev)
    m_mart = torch.zeros_like(log_s)
    alive = torch.ones_like(log_s, dtype=torch.bool)
    pv = torch.zeros_like(log_s)
    for idx in range(p.n_dates):
        s_prev = p.spot * torch.exp(log_s)
        log_s = log_s + mu + sig * _antithetic(generator, half, F64)
        s = p.spot * torch.exp(log_s)
        df = math.exp(-p.rate * dt * (idx + 1))
        v_k = df * _piecewise_value(s, bounds[idx], vcoefs[idx], p.strike, p.cp, p.basis)
        e_v = df * _expect_piecewise(s_prev, bounds[idx], vcoefs[idx], p.strike, p.cp, p.basis,
                                     mu, sig)
        m_mart = m_mart + (v_k - e_v)
        stop, ex = _policy_exercise(coefs, s, idx, p.strike, p.cp, p.basis)
        pv = pv + torch.where(alive & stop, df * ex - m_mart, 0.0)
        alive = alive & ~stop
    pv = pv + torch.where(alive, -m_mart, 0.0)  # unstopped paths: 0 − M_T
    price, se = _mean_se(pv)
    return torch.clamp_min(price, max(p.cp * (p.spot - p.strike), 0.0)), se


# ---------------------------------------------------------------------------
# Grid value surface + telescoping-BS dual
# ---------------------------------------------------------------------------
def _hat_pieces(c, m, s, h):
    """E[Λ_c(z)] for z ~ N(m, s²), split into the (left, right) halves of
    the hat so the grid-end nodes can keep only their interior half:

        left  = E[(z − (c−h))/h · 1{c−h < z < c}]
        right = E[((c+h) − z)/h · 1{c < z < c+h}]
    """
    inv = 1.0 / s
    al, be, ga = (c - h - m) * inv, (c - m) * inv, (c + h - m) * inv

    def phi(u):
        return torch.exp(-0.5 * u * u) * 0.3989422804014327

    left = ((m - (c - h)) * (norm_cdf(be) - norm_cdf(al)) + s * (phi(al) - phi(be))) / h
    right = (((c + h) - m) * (norm_cdf(ga) - norm_cdf(be)) - s * (phi(be) - phi(ga))) / h
    return left, right


GRID_FIELDS = ("y0", "h", "resid", "cresid", "price", "spot", "strike", "maturity", "rate",
               "vol", "cp", "dividend", "n_dates")


@dataclasses.dataclass(frozen=True)
class GridValue:
    """Bermudan value surface on a uniform log-spot grid.

    ``resid[k]`` holds Ṽ_k − BS(·, τ_k) at the nodes for exercise date k
    (k = 0 … n_dates − 1, date k at time (k + 1)·Δt), ``cresid`` the same
    for the continuation value; the dual and the policy rebuild Ṽ = BS +
    linear-interp(resid). ``price`` is the induction's estimate at t = 0.
    """

    y0: float
    h: float
    resid: torch.Tensor   # (n_dates, G) float32
    cresid: torch.Tensor  # (n_dates, G) float32
    price: torch.Tensor
    spot: float
    strike: float
    maturity: float
    rate: float
    vol: float
    cp: float
    dividend: float
    n_dates: int

    @classmethod
    def from_numpy(cls, fields, device=None) -> "GridValue":
        """A surface from its fields, the tables as numpy arrays (keeping
        their dtype): ``{k: getattr(jax_gv, k) for k in GRID_FIELDS}``
        carries a JAX package surface across."""
        out = {k: fields[k] for k in GRID_FIELDS}
        for k in ("resid", "cresid", "price"):
            out[k] = torch.as_tensor(np.array(out[k]), device=device)
        return cls(**out)


def _band_width(mu_f: float, s_f: float, h_f: float) -> int:
    return int(math.ceil((8.0 * s_f + abs(mu_f)) / h_f)) + 2


def _edge_weights(y, m0, s, h):
    """Hat weights of the nodes ``y`` for a Gaussian N(m0, s²), the tail
    mass beyond each end folded onto the end node (clamped extrapolation)."""
    lw, rw = _hat_pieces(y, m0, s, h)
    w0 = lw + rw
    first = rw[..., :1] + norm_cdf((y[..., :1] - m0) / s)
    last = lw[..., -1:] + 1.0 - norm_cdf((y[..., -1:] - m0) / s)
    return torch.cat([first, w0[..., 1:-1], last], dim=-1)


def _grid_induction(spot, strike, maturity, rate, vol, cp, dividend, n_dates: int, n_grid: int,
                    band: int, width: float = 10.0, device="cuda"):
    """Backward induction V = max(ψ, e^{−rΔt}·E[V_lin(S') | ·]) in float64
    with the exact one-step expectation of the piecewise-linear interpolant
    (Gaussian hat moments). The kernel is shift-invariant on the uniform log
    grid and clamped extrapolation equals edge padding, so each step is one
    length-(2·band + 1) correlation (``conv1d``). Returns (y0, h, resid,
    cresid, price); the residual surfaces against the European are float32."""
    opts = dict(dtype=F64, device=device)
    t = torch.tensor(float(maturity), **opts)
    spot_t = torch.tensor(float(spot), **opts)
    dt = t / n_dates
    mu = (rate - dividend - 0.5 * vol * vol) * dt
    s = vol * torch.sqrt(dt)
    half_w = width * vol * torch.sqrt(t) + abs(math.log(spot / strike))
    y = math.log(strike) + torch.linspace(-1.0, 1.0, n_grid, **opts) * half_w
    h = y[1] - y[0]

    # weight of the node at offset d for a state one step back; the end taps
    # carry the tail mass (edge padding makes them read the clamped edge)
    d = torch.arange(-band, band + 1, **opts)
    kern = _edge_weights(d * h, mu, s, h)
    taps = kern[None, None, :]

    def expect(v):  # E[V_lin(S') | y_i] for every node i: out[i] = Σ kern[j]·vp[i + j]
        vp = F.pad(v[None, None, :], (band, band), mode="replicate")
        return F.conv1d(vp, taps)[0, 0]

    s_nodes = torch.exp(y)
    psi = torch.clamp_min(cp * (s_nodes - strike), 0.0)
    disc1 = torch.exp(-rate * dt)

    def bs_nodes(k):  # European value at the nodes, time to expiry (n − k)·Δt
        tau = (n_dates - k) * dt
        return torch.where(tau > 0, bs_price(s_nodes, strike, torch.clamp_min(tau, 1e-12), rate,
                                             vol, cp, dividend), psi)

    v = psi
    res, cres = [], []
    for k in range(n_dates - 2, -1, -1):
        cont = disc1 * expect(v)
        v = torch.maximum(psi, cont)
        eu = bs_nodes(k + 1.0)
        res.append((v - eu).to(torch.float32))
        cres.append((cont - eu).to(torch.float32))
    # terminal rows: Ṽ_n = ψ = BS(τ = 0), residual 0 (continuation too)
    zero = torch.zeros((1, n_grid), dtype=torch.float32, device=device)
    resid = torch.cat([torch.stack(res[::-1]), zero]) if res else zero
    cresid = torch.cat([torch.stack(cres[::-1]), zero]) if cres else zero

    # t = 0: discounted expectation of the date-0 value from S0 (no exercise
    # at t = 0), one explicit hat-weight row
    v0_nodes = resid[0].to(F64) + bs_nodes(1.0)
    w0 = _edge_weights(y, torch.log(spot_t) + mu, s, h)
    price = disc1 * torch.dot(w0, v0_nodes)
    return float(y[0]), float(h), resid, cresid, price


def grid_value_surface(spot, strike, maturity, rate, vol, cp=-1.0, dividend=0.0,
                       n_dates: int = 500, n_grid: int = 1024, width: float = 10.0,
                       device="cuda") -> GridValue:
    """The transition-kernel Bermudan engine: a near-exact value surface on
    ``device``, the substrate of the certified bracket."""
    spot, strike, maturity, rate, vol, cp, dividend = (
        float(x) for x in (spot, strike, maturity, rate, vol, cp, dividend))
    dt = maturity / n_dates
    mu = (rate - dividend - 0.5 * vol * vol) * dt
    s = vol * math.sqrt(dt)
    half_w = width * vol * math.sqrt(maturity) + abs(math.log(spot / strike))
    band = _band_width(mu, s, 2.0 * half_w / (n_grid - 1))
    y0, h, resid, cresid, price = _grid_induction(spot, strike, maturity, rate, vol, cp,
                                                  dividend, n_dates, n_grid, band, width, device)
    return GridValue(y0, h, resid, cresid, price, spot, strike, maturity, rate, vol, cp,
                     dividend, n_dates)


def _interp_row(row, y0, h, y):
    """Clamped linear interpolation of one grid row at points y."""
    g = row.shape[-1]
    pos = (y - y0) / h
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, g - 2)
    frac = torch.clamp(pos - i0, 0.0, 1.0)
    return (1.0 - frac) * row[i0] + frac * row[i0 + 1]


def _e_resid(row, y_prev, y0, h, mu, s_step, window: int):
    """Exact E[lininterp(row)(y') | y_prev] by the windowed hat moments over
    ±window nodes around the mean; the tails clamp at the window's edges
    (mass there below 1e-15 unless the window met the grid's edge, where
    clamping is exact)."""
    g = row.shape[-1]
    m = y_prev + mu
    jc = torch.clamp(torch.round((m - y0) / h).to(torch.int64), window, g - 1 - window)
    idx = jc[:, None] + torch.arange(-window, window + 1, device=row.device)[None, :]
    c = y0 + idx.to(F64) * h
    w = _edge_weights(c, m[:, None], s_step, h)
    return (w * row[idx]).sum(dim=1)


def _grid_setup(maturity, rate, vol, dividend, n_dates):
    dt = maturity / n_dates
    return dt, (rate - dividend - 0.5 * vol * vol) * dt, vol * math.sqrt(dt)


def _euro_nodes(sj, strike, tau, rate, vol, cp, dividend, at_expiry):
    """Black–Scholes value with ``tau`` to expiry; ``at_expiry`` at τ = 0."""
    if tau > 0:
        return bs_price(sj, strike, max(tau, 1e-12), rate, vol, cp, dividend)
    return at_expiry


def _grid_bracket(gv: GridValue, generator, n_outer: int, window: int = 24):
    """One forward pass, both certified bounds, sharing the telescoping-BS
    plus residual-hat martingale M (M_0 = 0, exact conditional
    expectations):

      lower = Ê[h̃_τ − M_τ]          (τ the grid policy; E[M_τ] = 0)
      upper = Ê[max_k (h̃_k − M_k)]  (valid for any martingale)
    """
    dev = generator.device
    n_dates = gv.n_dates
    dt, mu, s_step = _grid_setup(gv.maturity, gv.rate, gv.vol, gv.dividend, n_dates)
    resid, cresid = gv.resid.to(dev), gv.cresid.to(dev)
    half = n_outer // 2
    bs0 = bs_price(torch.tensor(gv.spot, dtype=F64, device=dev), gv.strike, gv.maturity, gv.rate,
                   gv.vol, gv.cp, gv.dividend)
    h0 = max(gv.cp * (gv.spot - gv.strike), 0.0)
    y = torch.full((2 * half,), math.log(gv.spot), dtype=F64, device=dev)
    m_mart = torch.zeros_like(y)
    best = torch.full_like(y, h0)
    alive = torch.ones_like(y, dtype=torch.bool)
    f_low = torch.zeros_like(y)
    for k in range(n_dates):
        y_prev = y
        y = y_prev + mu + s_step * _antithetic(generator, half, F64)
        sj = torch.exp(y)
        df = math.exp(-gv.rate * dt * (k + 1))
        ex = torch.clamp_min(gv.cp * (sj - gv.strike), 0.0)
        euro = _euro_nodes(sj, gv.strike, (n_dates - 1 - k) * dt, gv.rate, gv.vol, gv.cp,
                           gv.dividend, ex)
        m_mart = m_mart + df * (_interp_row(resid[k], gv.y0, gv.h, y)
                                - _e_resid(resid[k], y_prev, gv.y0, gv.h, mu, s_step, window))
        m_k = (df * euro - bs0) + m_mart
        h_k = df * ex
        best = torch.maximum(best, h_k - m_k)
        # the grid policy: exercise when intrinsic ≥ continuation
        stop = alive & (ex > 0) & (ex >= euro + _interp_row(cresid[k], gv.y0, gv.h, y))
        f_low = torch.where(stop, h_k - m_k, f_low)
        alive = alive & ~stop
        if k == n_dates - 1:  # unstopped paths: payoff 0 (OTM) minus M_n
            f_low = torch.where(alive, -m_k, f_low)
    lower, lower_se = _mean_se(f_low)
    upper, upper_se = _mean_se(best)
    return torch.clamp_min(lower, h0), lower_se, upper, upper_se


def _grid_lower(gv: GridValue, generator, n_paths: int):
    """Out-of-sample lower bound under the grid policy (exercise when
    intrinsic ≥ continuation), the European payoff as control variate."""
    dev = generator.device
    n_dates = gv.n_dates
    dt, drift, sig_dt = _grid_setup(gv.maturity, gv.rate, gv.vol, gv.dividend, n_dates)
    cresid = gv.cresid.to(dev)
    half = n_paths // 2
    y = torch.full((2 * half,), math.log(gv.spot), dtype=F64, device=dev)
    alive = torch.ones_like(y, dtype=torch.bool)
    pv = torch.zeros_like(y)
    for idx in range(n_dates):
        y = y + drift + sig_dt * _antithetic(generator, half, F64)
        sj = torch.exp(y)
        ex = torch.clamp_min(gv.cp * (sj - gv.strike), 0.0)
        euro = _euro_nodes(sj, gv.strike, (n_dates - 1 - idx) * dt, gv.rate, gv.vol, gv.cp,
                           gv.dividend, torch.zeros_like(sj))
        stop = (ex > 0) & (ex >= euro + _interp_row(cresid[idx], gv.y0, gv.h, y))
        df = math.exp(-gv.rate * dt * (idx + 1))
        pv = pv + torch.where(alive & stop, df * ex, 0.0)
        alive = alive & ~stop
    euro_pay = df * ex  # the discounted terminal European payoff
    euro_cf = bs_price(torch.tensor(gv.spot, dtype=F64, device=dev), gv.strike, gv.maturity,
                       gv.rate, gv.vol, gv.cp, gv.dividend)
    price, se = _mean_se(pv - (euro_pay - euro_cf))
    return torch.clamp_min(price, max(gv.cp * (gv.spot - gv.strike), 0.0)), se


def _grid_dual_upper(gv: GridValue, generator, n_outer: int, window: int = 24):
    """Dual upper bound with the telescoping-BS martingale: Ṽ_k(S) =
    BS(S, τ_k) + lininterp(resid_k)(ln S); the discounted BS part is an
    exact martingale (evaluated, never summed), the residual part's
    conditional expectation exact hat moments over a ±window stencil."""
    dev = generator.device
    n_dates = gv.n_dates
    dt, mu, s_step = _grid_setup(gv.maturity, gv.rate, gv.vol, gv.dividend, n_dates)
    resid = gv.resid.to(dev)
    half = n_outer // 2
    bs0 = bs_price(torch.tensor(gv.spot, dtype=F64, device=dev), gv.strike, gv.maturity, gv.rate,
                   gv.vol, gv.cp, gv.dividend)
    y = torch.full((2 * half,), math.log(gv.spot), dtype=F64, device=dev)
    m_mart = torch.zeros_like(y)
    best = torch.full_like(y, max(gv.cp * (gv.spot - gv.strike), 0.0))
    for k in range(n_dates):
        y_prev = y
        y = y_prev + mu + s_step * _antithetic(generator, half, F64)
        sj = torch.exp(y)
        df = math.exp(-gv.rate * dt * (k + 1))
        ex = torch.clamp_min(gv.cp * (sj - gv.strike), 0.0)
        m_mart = m_mart + df * (_interp_row(resid[k], gv.y0, gv.h, y)
                                - _e_resid(resid[k], y_prev, gv.y0, gv.h, mu, s_step, window))
        euro = _euro_nodes(sj, gv.strike, (n_dates - 1 - k) * dt, gv.rate, gv.vol, gv.cp,
                           gv.dividend, ex)
        m_k = (df * euro - bs0) + m_mart
        best = torch.maximum(best, df * ex - m_k)
    return _mean_se(best)


def american_price_interval(spot, strike, maturity, rate, vol, cp=-1.0, dividend=0.0,
                            seed: int = 0, n_fit: int = 200_000, n_lower: int = 200_000,
                            n_outer: int = 200_000, n_inner: int = 128, n_dates: int = 50,
                            basis: int = 3, method: str = "grid", n_grid: int = 1024,
                            device="cuda") -> dict:
    """[lower, upper] bracket of the Bermudan/American price on ``device``.

    ``method``: "grid" (default; the grid engine's certified bounds from one
    pass of min(n_outer, 131072) paths, plus the induction's ``estimate``),
    "closed_form" (the LSM policy, its control-variate lower bound and the
    polynomial-martingale dual) or "nested" (Andersen–Broadie). Returns a
    dict of 0-d tensors (lower, lower_se, upper, upper_se, width[,
    estimate]); the price lies in [lower − 3·lower_se, upper + 3·upper_se]
    with about 99.7% confidence. One generator seeded ``seed`` serves every
    stage in turn.
    """
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    if method == "grid":
        gv = grid_value_surface(spot, strike, maturity, rate, vol, cp, dividend, n_dates, n_grid,
                                device=device)
        s_step = float(vol) * math.sqrt(float(maturity) / n_dates)
        window = min(int(math.ceil(8.0 * s_step / gv.h)) + 2, n_grid // 2 - 1)
        lower, lower_se, upper, upper_se = _grid_bracket(gv, gen, min(n_outer, 131072), window)
        upper = torch.maximum(upper, lower)
        return {"lower": lower, "lower_se": lower_se, "upper": upper, "upper_se": upper_se,
                "width": upper - lower, "estimate": gv.price}
    if method not in ("closed_form", "nested"):
        raise ValidationError(f"unknown method {method!r}; choose grid|closed_form|nested")
    policy = fit_lsm_policy(spot, strike, maturity, rate, vol, gen, cp, dividend, n_fit, n_dates,
                            basis)
    lower, lower_se = lsm_lower_bound(policy, gen, n_lower)
    if method == "closed_form":
        upper, upper_se = dual_upper_bound(policy, gen, n_outer)
    else:
        upper, upper_se = ab_upper_bound(policy, gen, n_outer, n_inner)
    upper = torch.maximum(upper.to(lower.dtype), lower)  # estimator noise guard
    return {"lower": lower, "lower_se": lower_se, "upper": upper,
            "upper_se": upper_se.to(lower.dtype), "width": upper - lower}


def _readout(spot, strike, maturity, rate, vol, cp, dividend, v0_nodes, y0, h, n_dates: int):
    """Differentiable t = 0 readout: the discounted hat-weight expectation of
    the (fixed) date-0 value surface from S0, floored at intrinsic. Smooth
    in spot, so autograd gives the Bermudan delta and gamma."""
    n_grid = v0_nodes.shape[0]
    dt = maturity / n_dates
    mu = (rate - dividend - 0.5 * vol * vol) * dt
    s = vol * math.sqrt(dt)
    y = y0 + h * torch.arange(n_grid, dtype=v0_nodes.dtype, device=v0_nodes.device)
    w0 = _edge_weights(y, torch.log(spot) + mu, s, h)
    cont = math.exp(-rate * dt) * torch.dot(w0, v0_nodes)
    return torch.maximum(cont, torch.clamp_min(cp * (spot - strike), 0.0))


def american_grid_greeks(spot, strike, maturity, rate, vol, cp=-1.0, dividend=0.0,
                         n_dates: int = 500, n_grid: int = 2048, fd_eps: float = 1e-3,
                         richardson: bool = True, device="cuda") -> dict:
    """American price, delta, gamma, theta, vega and rho from the grid
    engine, as floats. Delta and gamma: autograd of the smooth readout;
    ``richardson`` extrapolates every output across (n_grid, n_grid/2) to
    remove the surface's O(h²) bias. Theta: one-period surface difference.
    Vega and rho: central differences of the deterministic induction."""
    if richardson:
        hi = american_grid_greeks(spot, strike, maturity, rate, vol, cp, dividend, n_dates,
                                  n_grid, fd_eps, richardson=False, device=device)
        lo = american_grid_greeks(spot, strike, maturity, rate, vol, cp, dividend, n_dates,
                                  n_grid // 2, fd_eps, richardson=False, device=device)
        return {k: hi[k] + (hi[k] - lo[k]) / 3.0 for k in hi}
    spot, strike, maturity, rate, vol, cp, dividend = (
        float(x) for x in (spot, strike, maturity, rate, vol, cp, dividend))
    dt = maturity / n_dates

    def v0_row(gv_, r_, v_):
        y = gv_.y0 + gv_.h * torch.arange(gv_.resid.shape[-1], dtype=F64, device=device)
        return gv_.resid[0].to(F64) + bs_price(torch.exp(y), strike, max(maturity - dt, 1e-12),
                                               r_, v_, cp, dividend)

    def reprice(r_, v_):
        gv_ = grid_value_surface(spot, strike, maturity, r_, v_, cp, dividend, n_dates, n_grid,
                                 device=device)
        s0 = torch.tensor(spot, dtype=F64, device=device)
        return float(_readout(s0, strike, maturity, r_, v_, cp, dividend, v0_row(gv_, r_, v_),
                              gv_.y0, gv_.h, n_dates))

    gv = grid_value_surface(spot, strike, maturity, rate, vol, cp, dividend, n_dates, n_grid,
                            device=device)
    v0_nodes = v0_row(gv, rate, vol)
    s0 = torch.tensor(spot, dtype=F64, device=device, requires_grad=True)
    with torch.enable_grad():
        price = _readout(s0, strike, maturity, rate, vol, cp, dividend, v0_nodes, gv.y0, gv.h,
                         n_dates)
        (delta,) = torch.autograd.grad(price, s0, create_graph=True)
        (gamma,) = torch.autograd.grad(delta, s0)
    price, delta = price.detach(), delta.detach()
    # theta: the date-0 surface is the value one period ahead
    y_spot = torch.tensor([math.log(spot)], dtype=F64, device=device)
    v_next = float(_interp_row(v0_nodes, gv.y0, gv.h, y_spot)[0])
    theta = (v_next - float(price)) / dt
    vega = (reprice(rate, vol + fd_eps) - reprice(rate, vol - fd_eps)) / (2 * fd_eps)
    rho = (reprice(rate + fd_eps, vol) - reprice(rate - fd_eps, vol)) / (2 * fd_eps)
    return {"price": float(price), "delta": float(delta), "gamma": float(gamma), "theta": theta,
            "vega": vega, "rho": rho}


def american_continuous_interval(spot, strike, maturity, rate, vol, cp=-1.0, dividend=0.0,
                                 seed: int = 0, n_outer: int = 16_384, n_dates: int = 4_000,
                                 n_grid: int = 8_192, device="cuda") -> dict:
    """Certified bracket of the continuous-exercise American price: the
    Bermudan-n grid bracket, its upper bound raised by the forgone-drift pad
    rK·Δt for a put (0 for a call without dividends; a dividend-paying call
    has no uniform drift bound and raises)."""
    out = american_price_interval(spot, strike, maturity, rate, vol, cp, dividend, seed=seed,
                                  n_outer=n_outer, n_dates=n_dates, n_grid=n_grid,
                                  method="grid", device=device)
    if cp < 0:
        pad = float(rate) * float(strike) * float(maturity) / n_dates
    elif float(dividend) == 0.0:
        pad = 0.0
    else:
        raise ValidationError(
            "continuous-exercise pad needs a uniform drift bound; for dividend-paying calls use "
            "american_price_interval(method='grid') at large n_dates instead")
    out = dict(out)
    out["upper"] = out["upper"] + pad
    out["width"] = out["upper"] - out["lower"]
    out["pad"] = pad
    return out
