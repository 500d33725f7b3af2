"""Certified [lower, upper] bracket for American puts under Heston and Bates.

The port of ``optionslab_tpu/models/heston_american.py``.

* Lower bound: an exercise policy (LSM regressions on (S, v) features, or
  the Bermudan-ADI continuation slices of ``models/heston_fdm.py``) valued
  out of sample on fresh paths.
* Upper bound: the value-surface dual — M_k sums df·Ṽ_k(X_k) minus an
  antithetic inner one-date estimate of its conditional mean; with the ADI
  slices the same martingale also controls the lower bound (one joint
  pipeline).
* Dynamics: Andersen QE with ``n_sub`` substeps a date, in float32 on the
  device; Bates adds an exact compound-Poisson log-jump per substep. The
  continuous-exercise pad is K·(1 − e^{−rT/n}).

Random numbers: one ``torch.Generator`` per call on the device, drawn in
turn by the fit, the lower bound and the dual (the reference splits its key
in three). Bates jumps draw from a second generator of their own, so the
diffusion draws do not depend on the jumps: at λ = 0 a Bates bracket equals
the Heston bracket to the digit, as in the reference.

The LSM regressions are float64 solves on the host (numpy), as in the
reference; the paths are simulated on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..types import ContractBatch
from ..utils.exceptions import ValidationError
from .american import _mean_se
from .heston import heston_price
from .heston_fdm import _bilinear_at, _heston_adi_bermudan

__all__ = ["AdiSlices", "LSMCoefs", "fit_heston_lsm", "heston_lsm_lower", "heston_ab_upper",
           "heston_american_bracket"]

N_FEAT = 9
N_SFEAT = 13
_JUMP_SALT = 0x5BD1E995  # seeds the jump stream from the diffusion generator's seed


class LSMCoefs(NamedTuple):
    """(policy, surface) regression coefficients, each (n_dates+1, F)."""

    policy: torch.Tensor
    surface: torch.Tensor

    @classmethod
    def from_numpy(cls, policy, surface, device=None) -> "LSMCoefs":
        """Coefficients fitted by the JAX package (numpy arrays), float32."""
        return cls(*(torch.as_tensor(np.array(a, np.float32), device=device)
                     for a in (policy, surface)))


class AdiSlices(NamedTuple):
    """Bermudan-ADI continuation slices and their grid geometry:
    ``cont_all`` (n_dates+1, n_v, n_x) and the 0-dim x_lo, dx, dxi, c_v."""

    cont_all: torch.Tensor
    x_lo: torch.Tensor
    dx: torch.Tensor
    dxi: torch.Tensor
    c_v: torch.Tensor

    @classmethod
    def from_numpy(cls, cont_all, x_lo, dx, dxi, c_v, device=None) -> "AdiSlices":
        """Slices recorded by the JAX package (numpy arrays), float32."""
        return cls(*(torch.as_tensor(np.array(a, np.float32), device=device)
                     for a in (cont_all, x_lo, dx, dxi, c_v)))


def _features(s, v, ex, xp=torch):
    """(..., F) polynomial features in (moneyness s = S/K, variance v) plus
    the payoff (the exercise-boundary kink); torch tensors, or numpy arrays
    with ``xp=np``."""
    return _stack(xp, [xp.ones_like(s), s, s * s, s * s * s, v, v * v, s * v, s * s * v, ex])


def _sfeatures(s, v, ex, xp=torch):
    """The richer basis of the value-surface fit (the dual martingale)."""
    s2 = s * s
    return _stack(xp, [xp.ones_like(s), s, s2, s2 * s, s2 * s2, v, v * v, s * v, s2 * v,
                       s * v * v, ex, ex * s, ex * v])


def _stack(xp, cols):
    return torch.stack(cols, dim=-1) if xp is torch else np.stack(cols, axis=-1)


def _is_bates(params) -> bool:
    return hasattr(params, "lam")


def _f32_params(params, device):
    """The parameters as float32 tensors on ``device`` (HestonParams or
    BatesParams)."""
    return params.to(dtype=torch.float32, device=device)


def _qe_consts(params, dt):
    kap, th = params.kappa, params.theta
    sig, rho = params.sigma, params.rho
    emkd = torch.exp(-kap * dt)
    c1 = th * (1.0 - emkd)
    s2_v = sig**2 * emkd * (1.0 - emkd) / kap
    s2_0 = th * sig**2 * (1.0 - emkd) ** 2 / (2.0 * kap)
    g1 = g2 = 0.5
    k0 = -rho * kap * th * dt / sig
    k1 = g1 * dt * (kap * rho / sig - 0.5) - rho / sig
    k2 = g2 * dt * (kap * rho / sig - 0.5) + rho / sig
    k3 = g1 * dt * (1.0 - rho**2)
    k4 = g2 * dt * (1.0 - rho**2)
    return emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4


def _jump_consts(params, dt):
    """Bates (λ·dt, μ_J, σ_J), or None for Heston."""
    if not _is_bates(params):
        return None
    return (params.lam * dt, params.mu_j, params.sigma_j)


def _jump_comp(params):
    """λ·k̄, the drift compensator (0 for Heston)."""
    if not _is_bates(params):
        return 0.0
    return params.lam * (torch.exp(params.mu_j + 0.5 * params.sigma_j**2) - 1.0)


def _qe_apply(x, v, zv, zx, u, consts, mu_dt):
    """One QE substep with the normals and the uniform supplied: the single
    transition law of every pipeline."""
    emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4 = consts
    m = c1 + emkd * v
    s2 = s2_v * v + s2_0
    psi = s2 / torch.clamp_min(m * m, 1e-30)
    inv_psi = 2.0 / torch.clamp_min(psi, 1e-10)
    b2 = torch.clamp_min(inv_psi - 1.0 + torch.sqrt(torch.clamp_min(inv_psi * (inv_psi - 1.0),
                                                                    0.0)), 0.0)
    a = m / (1.0 + b2)
    v_quad = a * (torch.sqrt(b2) + zv) ** 2
    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-7)
    beta = (1.0 - p) / torch.clamp_min(m, 1e-30)
    v_exp = torch.where(u <= p, 0.0, torch.log((1.0 - p) / torch.clamp_min(1.0 - u, 1e-30))
                        / torch.clamp_min(beta, 1e-30))
    v_new = torch.where(psi <= 1.5, v_quad, v_exp)
    x_new = x + mu_dt + k0 + k1 * v + k2 * v_new \
        + torch.sqrt(torch.clamp_min(k3 * v + k4 * v_new, 0.0)) * zx
    return x_new, v_new


def _uniform(generator, shape, dtype):
    """Uniforms on [1e-7, 1 − 1e-7), as ``jax.random.uniform(minval, maxval)``."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return torch.clamp_min(u * (1.0 - 2e-7) + 1e-7, 1e-7)


def _jumps(jgen, lam_dt, shape, dtype):
    """(N, Z): Poisson(λ·dt) counts and standard normals from the jump stream."""
    rate = torch.full(shape, 1.0, dtype=dtype, device=jgen.device) * lam_dt
    n_j = torch.poisson(rate, generator=jgen)
    zj = torch.randn(shape, generator=jgen, dtype=dtype, device=jgen.device)
    return n_j, zj


def _jump_generator(generator: torch.Generator) -> torch.Generator:
    """The jump stream of a call: a generator on the same device seeded from
    the diffusion generator's seed."""
    return torch.Generator(device=generator.device).manual_seed(
        (generator.initial_seed() ^ _JUMP_SALT) & 0xFFFFFFFFFFFF)


def _simulate_dates(gen, jgen, spot, params, rate, maturity, n_dates, n_sub, n_paths):
    """(S, v) at every exercise date: (n_dates+1, n_paths) float32 on the
    generator's device."""
    dtype = torch.float32
    dev = gen.device
    dt = torch.as_tensor(maturity / (n_dates * n_sub), dtype=dtype, device=dev)
    consts = _qe_consts(params, dt)
    jc = _jump_consts(params, dt)
    mu_dt = (rate - _jump_comp(params)) * dt
    x = torch.zeros(n_paths, dtype=dtype, device=dev)
    v = params.v0.expand(n_paths).clone()
    xs, vs = [x], [v]
    for _ in range(n_dates):
        for _ in range(n_sub):
            z = torch.randn((2, n_paths), generator=gen, dtype=dtype, device=dev)
            u = _uniform(gen, (n_paths,), dtype)
            x, v = _qe_apply(x, v, z[0], z[1], u, consts, mu_dt)
            if jc is not None:
                n_j, zj = _jumps(jgen, jc[0], (n_paths,), dtype)
                x = x + n_j * jc[1] + jc[2] * torch.sqrt(n_j) * zj
        xs.append(x)
        vs.append(v)
    return spot * torch.exp(torch.stack(xs)), torch.stack(vs)


def _fit_lsm_from_paths(s_paths, v_paths, strike, maturity, rate, cp, n_dates):
    """Backward-induction LSM on precomputed (S, v) date paths, float64 on the
    host: (policy, surface) coefficients, float32 on the paths' device. The
    policy fit is ITM-only least squares (minimum norm: the features are
    collinear there by construction), the surface fit an all-path ridge."""
    dev = s_paths.device
    s = s_paths.double().cpu().numpy()
    v = v_paths.double().cpu().numpy()
    k_ = float(strike)
    disc = math.exp(-float(rate) * float(maturity) / n_dates)
    cash = np.maximum(cp * (s[-1] - k_), 0.0)
    coefs = np.zeros((n_dates + 1, N_FEAT))
    scoefs = np.zeros((n_dates + 1, N_SFEAT))
    for d in range(n_dates - 1, 0, -1):
        cash *= disc
        ex = np.maximum(cp * (s[d] - k_), 0.0)
        sbasis = _sfeatures(s[d] / k_, v[d], ex / k_, xp=np)
        ata = sbasis.T @ sbasis + 1e-7 * len(ex) * np.eye(N_SFEAT)
        scoefs[d] = np.linalg.solve(ata, sbasis.T @ (cash / k_))
        itm = ex > 0
        if itm.sum() > 10 * N_FEAT:
            basis = _features(s[d, itm] / k_, v[d, itm], ex[itm] / k_, xp=np)
            coef, *_ = np.linalg.lstsq(basis, cash[itm] / k_, rcond=None)
            coefs[d] = coef
            cont = basis @ coef * k_
            take = ex[itm] > cont
            idx = np.where(itm)[0][take]
            cash[idx] = ex[idx]
    return LSMCoefs.from_numpy(coefs, scoefs, device=dev)


def fit_heston_lsm(spot, strike, maturity, rate, params, generator: torch.Generator,
                   cp: float = -1.0, n_dates: int = 50, n_sub: int = 2,
                   n_paths: int = 100_000, jump_generator: torch.Generator | None = None):
    """LSM regressions on (S, v) paths drawn on the generator's device:
    ``LSMCoefs(policy, surface)``. The ITM-only policy coefficients are
    huge but cancelling (never evaluate them off the money); the all-path
    ridge surface is well conditioned everywhere."""
    if cp > 0:
        raise ValidationError("bracket supports puts (cp=-1) only")
    p = _f32_params(params, generator.device)
    jgen = jump_generator if jump_generator is not None else _jump_generator(generator)
    s_paths, v_paths = _simulate_dates(generator, jgen, float(spot), p, float(rate),
                                       float(maturity), n_dates, n_sub, n_paths)
    return _fit_lsm_from_paths(s_paths, v_paths, strike, maturity, rate, cp, n_dates)


def _grid_cont(surf, d, s, v, strike):
    """Continuation at date d from the Bermudan-ADI slices, clipped to the
    put's hard bounds [0, K]; queries off the grid clamp to its edge."""
    cont_all, x_lo, dx, dxi, c_v = surf
    cont = _bilinear_at(cont_all[d], torch.log(torch.clamp_min(s, 1e-12)), v, x_lo, dx, dxi,
                        c_v)
    return torch.clamp(cont, 0.0, strike)


def _continuation(surf, d, s, v, strike, ex, kind):
    """Fitted (``poly``: coefficients (n_dates+1, F)) or PDE (``grid``)
    continuation value at date d."""
    if kind == "grid":
        return _grid_cont(surf, d, s, v, strike)
    return (_features(s / strike, v, ex / strike) @ surf[d]) * strike


def _exercise_now(surf, d, s, v, strike, cp, n_dates, kind="poly"):
    """The policy at date d: exercise if ITM and the payoff beats the
    continuation; always (if ITM) at the last date."""
    ex = torch.clamp_min(cp * (s - strike), 0.0)
    if d >= n_dates:
        return ex, ex > 0.0
    cont = _continuation(surf, d, s, v, strike, ex, kind)
    return ex, (ex > 0.0) & (ex > cont)


def _surface_value(surf, d, s, v, strike, cp, n_dates, kind="poly"):
    """Ṽ_d(s, v) = max(payoff, continuation), the deterministic surface the
    dual martingale is built from; zero continuation at the last date."""
    ex = torch.clamp_min(cp * (s - strike), 0.0)
    if kind == "grid":
        return torch.maximum(ex, _grid_cont(surf, d, s, v, strike))
    cont = torch.clamp((_sfeatures(s / strike, v, ex / strike) @ surf[d]) * strike, 0.0, strike)
    if d >= n_dates:
        cont = torch.zeros_like(cont)
    return torch.maximum(ex, cont)


def _lower_pipeline(surf, gen, jgen, spot, strike, maturity, rate, params, cp, n_dates, n_sub,
                    n_paths, kind="poly", use_cv=False, c_euro=0.0):
    s_paths, v_paths = _simulate_dates(gen, jgen, spot, params, rate, maturity, n_dates, n_sub,
                                       n_paths)
    dt = maturity / n_dates
    alive = torch.ones(n_paths, dtype=torch.bool, device=gen.device)
    cash = torch.zeros(n_paths, dtype=torch.float32, device=gen.device)
    for d in range(1, n_dates + 1):
        ex, take = _exercise_now(surf, d, s_paths[d], v_paths[d], strike, cp, n_dates, kind)
        cash = torch.where(alive & take, math.exp(-rate * dt * d) * ex, cash)
        alive = alive & ~take
    if use_cv:
        # European control variate on the same paths, centred at the CF price
        euro = math.exp(-rate * maturity) * torch.clamp_min(cp * (s_paths[-1] - strike), 0.0)
        em = euro.mean()
        beta = torch.sum((cash - cash.mean()) * (euro - em)) \
            / torch.clamp_min(torch.sum((euro - em) ** 2), 1e-12)
        cash = cash - beta * (euro - c_euro)
    return _mean_se(cash)


def heston_lsm_lower(coefs, generator: torch.Generator, spot, strike, maturity, rate, params,
                     cp: float = -1.0, n_dates: int = 50, n_sub: int = 2,
                     n_paths: int = 200_000, kind: str = "poly", c_euro=None,
                     jump_generator: torch.Generator | None = None):
    """Out-of-sample policy value: (lower bound, stderr) as Python floats.
    ``coefs`` is the policy surface (LSM policy coefficients, or
    :class:`AdiSlices` with ``kind='grid'``); a European price ``c_euro``
    turns on the control variate."""
    jgen = jump_generator if jump_generator is not None else _jump_generator(generator)
    m, se = _lower_pipeline(coefs, generator, jgen, float(spot), float(strike), float(maturity),
                            float(rate), _f32_params(params, generator.device), float(cp),
                            n_dates, n_sub, n_paths, kind=kind, use_cv=c_euro is not None,
                            c_euro=0.0 if c_euro is None else float(c_euro))
    return float(m), float(se)


def _upper_pipeline(coefs, gen, jgen, spot, strike, maturity, rate, params, cp, n_dates, n_sub,
                    n_outer, n_inner, kind="poly", with_lower=False):
    """The value-surface dual upper bound, M_k = Σ_{j≤k} [df_j·Ṽ_j(X_j) −
    Ê[df_j·Ṽ_j(X_j) | X_{j−1}]] with antithetic inner one-date transitions;
    with ``with_lower`` also the martingale-controlled lower bound
    df_τ·ex_τ − M̂_τ on the same outer paths."""
    dtype = torch.float32
    dev = gen.device
    dt = maturity / n_dates
    dt_sub = torch.as_tensor(maturity / (n_dates * n_sub), dtype=dtype, device=dev)
    consts = _qe_consts(params, dt_sub)
    jc = _jump_consts(params, dt_sub)
    mu_sub = (rate - _jump_comp(params)) * dt_sub
    s_out, v_out = _simulate_dates(gen, jgen, spot, params, rate, maturity, n_dates, n_sub,
                                   n_outer)
    half = n_inner // 2

    def date_step_anti(x, v):
        """One-date transition of (n_outer, half) states with an antithetic
        pair per draw: (n_outer, 2·half) results."""
        xa, xb, va, vb = x, x, v, v
        for _ in range(n_sub):
            z = torch.randn((2, n_outer, half), generator=gen, dtype=dtype, device=dev)
            u = _uniform(gen, (n_outer, half), dtype)
            xa, va = _qe_apply(xa, va, z[0], z[1], u, consts, mu_sub)
            xb, vb = _qe_apply(xb, vb, -z[0], -z[1], 1.0 - u, consts, mu_sub)
            if jc is not None:
                # the count shared across the pair, the size mirrored
                n_j, zj = _jumps(jgen, jc[0], (n_outer, half), dtype)
                jsz = jc[2] * torch.sqrt(n_j)
                xa = xa + n_j * jc[1] + jsz * zj
                xb = xb + n_j * jc[1] - jsz * zj
        return torch.cat([xa, xb], dim=1), torch.cat([va, vb], dim=1)

    m_k = torch.zeros(n_outer, dtype=dtype, device=dev)
    best = torch.full((n_outer,), max(cp * (spot - strike), 0.0), dtype=dtype, device=dev)
    alive = torch.ones(n_outer, dtype=torch.bool, device=dev)
    low = torch.zeros(n_outer, dtype=dtype, device=dev)
    for k in range(1, n_dates + 1):
        df = math.exp(-rate * dt * k)
        # the surface at the outer state, exact
        vk = df * _surface_value(coefs, k, s_out[k], v_out[k], strike, cp, n_dates, kind)
        # its conditional mean given X_{k-1}, by antithetic one-date moves
        x_prev = torch.log(s_out[k - 1] / spot)[:, None].expand(n_outer, half)
        v_prev = v_out[k - 1][:, None].expand(n_outer, half)
        x_tr, v_tr = date_step_anti(x_prev, v_prev)
        v_in = _surface_value(coefs, k, spot * torch.exp(x_tr), v_tr, strike, cp, n_dates, kind)
        m_k = m_k + vk - df * v_in.mean(dim=1)
        cand = df * torch.clamp_min(cp * (s_out[k] - strike), 0.0) - m_k
        best = torch.maximum(best, cand)
        if with_lower:
            # the stopping time depends on the outer state alone
            _, take = _exercise_now(coefs, k, s_out[k], v_out[k], strike, cp, n_dates, kind)
            low = torch.where(alive & take, cand, low)
            alive = alive & ~take
    up = _mean_se(best)
    if not with_lower:
        return up
    # never exercised: zero payoff at expiry, the estimator is 0 − M̂_n
    return up + _mean_se(torch.where(alive, -m_k, low))


def heston_ab_upper(coefs, generator: torch.Generator, spot, strike, maturity, rate, params,
                    cp: float = -1.0, n_dates: int = 50, n_sub: int = 2, n_outer: int = 500,
                    n_inner: int = 400, kind: str = "poly",
                    jump_generator: torch.Generator | None = None):
    """Value-surface dual upper bound: (upper, stderr) as Python floats."""
    jgen = jump_generator if jump_generator is not None else _jump_generator(generator)
    m, se = _upper_pipeline(coefs, generator, jgen, float(spot), float(strike), float(maturity),
                            float(rate), _f32_params(params, generator.device), float(cp),
                            n_dates, n_sub, n_outer, n_inner, kind=kind)
    return float(m), float(se)


def heston_american_bracket(spot, strike, maturity, rate, params, cp: float = -1.0,
                            n_dates: int = 50, n_sub: int = 2, n_fit: int = 100_000,
                            n_lower: int = 200_000, n_outer: int = 512, n_inner: int = 2048,
                            seed: int = 0, method: str = "lsm", n_x: int = 201, n_v: int = 101,
                            steps_per_date: int = 8, use_cv: bool | None = None,
                            device="cuda") -> dict:
    """Certified Bermudan bracket plus the continuous-exercise pad, on
    ``device`` (``params``, HestonParams or BatesParams, are moved there).

    Returns {lower, lower_se, upper, upper_se, width, pad, continuous_upper,
    n_dates, method} (+ ``adi_bermudan`` for ``method="adi"``) as Python
    numbers. ``"lsm"``: regression surfaces; ``"adi"`` (Heston only): the
    Bermudan-ADI slices drive the policy, the dual and the lower bound's
    martingale control variate. ``use_cv`` (lsm) centres the lower bound on
    the European CF price.
    """
    if method not in ("lsm", "adi"):
        raise ValidationError(f"method must be 'lsm' or 'adi', got {method!r}")
    use_cv = bool(use_cv)
    bates = _is_bates(params)
    if bates and method == "adi":
        raise ValidationError("the ADI method solves the pure-diffusion PDE; use method='lsm' "
                              "for Bates (jump) dynamics")
    dev = torch.device(device)
    p = _f32_params(params, dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    jgen = _jump_generator(gen)
    c_euro = None
    if use_cv:
        batch = ContractBatch.make(float(spot), float(strike), float(maturity), float(rate), 0.2,
                                   "put" if cp < 0 else "call", device=dev)
        if bates:
            from .bates import bates_price

            c_euro = float(bates_price(batch, p))
        else:
            c_euro = float(heston_price(batch, p))
    args = (float(spot), float(strike), float(maturity), float(rate), p, float(cp))
    extra = {}
    if method == "adi":
        if cp > 0:
            raise ValidationError("bracket supports puts (cp=-1) only")
        price0, *surf = _heston_adi_bermudan(*args[:4], 0.0, float(cp), p, n_x, n_v, n_dates,
                                             steps_per_date, dev)
        extra["adi_bermudan"] = float(price0)
        up, up_se, lo, lo_se = (float(a) for a in _upper_pipeline(
            AdiSlices(*surf), gen, jgen, *args, n_dates, n_sub, n_outer, n_inner, kind="grid",
            with_lower=True))
    else:
        pol, sur = fit_heston_lsm(spot, strike, maturity, rate, p, gen, cp, n_dates, n_sub, n_fit,
                                  jump_generator=jgen)
        lo, lo_se = heston_lsm_lower(pol, gen, spot, strike, maturity, rate, p, cp, n_dates,
                                     n_sub, n_lower, c_euro=c_euro, jump_generator=jgen)
        up, up_se = heston_ab_upper(sur, gen, spot, strike, maturity, rate, p, cp, n_dates, n_sub,
                                    n_outer, n_inner, jump_generator=jgen)
    # interest-on-strike pad, floored at 0 for r <= 0
    pad = max(float(strike) * (1.0 - math.exp(-float(rate) * float(maturity) / n_dates)), 0.0)
    return {"lower": lo, "lower_se": lo_se, "upper": up, "upper_se": up_se, "width": up - lo,
            "pad": pad, "continuous_upper": up + pad, "n_dates": n_dates, "method": method,
            **extra}
