"""Variance and volatility swaps: static replication and the Heston closed forms.

The port of ``optionslab_tpu/models/var_swap.py``.

* Fair variance strikes by Carr–Madan log-contract replication (the CBOE
  discrete strike sum) and a VIX-style index.
* Under Heston, exact strikes from the CIR integrated-variance Laplace
  transform: E[I_T] and Var[I_T] are its first two cumulants, taken by
  ``torch.autograd`` at s = 0; the volatility swap strike E[√(I_T/T)] is the
  integral identity E[√X] = (1/√π) ∫₀^∞ (1 − E[e^{−u²X}])/u² du on fixed
  Gauss–Legendre panels; Brockhaus–Long's convexity approximation beside it.
* :func:`heston_integrated_variance_mc`, the Monte Carlo oracle, draws from
  an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from ..utils.config import as_tensors, input_device
from ..utils.exceptions import ValidationError
from .black_scholes import bs_price
from .heston import HestonParams, _gl_nodes

__all__ = [
    "variance_swap_strike_replication",
    "variance_swap_strike_from_iv",
    "vix_style_index",
    "heston_integrated_variance_laplace",
    "heston_expected_variance",
    "heston_variance_of_variance",
    "heston_variance_swap_strike",
    "heston_vol_swap_strike",
    "heston_vol_swap_strike_brockhaus_long",
    "heston_integrated_variance_mc",
    "bates_variance_swap_strike",
]


def variance_swap_strike_replication(strikes, otm_prices, spot, maturity, rate, dividend=0.0):
    """Fair variance strike from OTM option prices (CBOE VIX methodology):

        K_var = (2 e^{rT} / T) Σ ΔK_i / K_i² · Q(K_i) − (F/K0 − 1)² / T

    ``strikes`` ascending; ``otm_prices[i]`` the OTM option at strike i (put
    below the forward, call above). K0 is the largest strike at or below the
    forward, or the smallest strike when the whole grid sits above it.
    Follows the tensor arguments' device, else runs on the card.
    """
    args = (strikes, otm_prices, spot, maturity, rate, dividend)
    k, q, spot, t, rate, dividend = as_tensors(*args, device=input_device(*args))
    fwd = spot * torch.exp((rate - dividend) * t)
    below = torch.where(k <= fwd, k, -math.inf)
    k0 = torch.where(torch.any(k <= fwd), torch.max(below), torch.min(k))
    dk = torch.cat([k[1:2] - k[0:1], 0.5 * (k[2:] - k[:-2]), k[-1:] - k[-2:-1]])
    total = torch.sum(dk / (k * k) * q)
    return (2.0 * torch.exp(rate * t) / t) * total - (fwd / k0 - 1.0) ** 2 / t


def variance_swap_strike_from_iv(spot, strikes, ivs, maturity, rate, dividend=0.0):
    """Fair variance strike from an implied-vol smile: price the OTM strip
    by Black–Scholes at each strike's vol, then replicate."""
    args = (strikes, ivs, spot, maturity, rate, dividend)
    k, iv, spot, t, rate, dividend = as_tensors(*args, device=input_device(*args))
    fwd = spot * torch.exp((rate - dividend) * t)
    cp = torch.where(k <= fwd, -1.0, 1.0)  # puts below the forward, calls above
    q = bs_price(spot, k, t, rate, iv, cp, dividend)
    return variance_swap_strike_replication(k, q, spot, t, rate, dividend)


def vix_style_index(spot, strikes, ivs, maturity, rate, dividend=0.0):
    """Single-expiry VIX-style index: 100·√K_var."""
    kv = variance_swap_strike_from_iv(spot, strikes, ivs, maturity, rate, dividend)
    return 100.0 * torch.sqrt(torch.clamp_min(kv, 0.0))


def heston_integrated_variance_laplace(s, params: HestonParams, maturity):
    """log E[exp(−s·I_T)], I_T = ∫₀^T v_t dt, v ~ CIR(κ, θ, σ): the CIR
    bond-price formula in its e^{−γT}-normalised (overflow-safe) form, smooth
    at s = 0 so autograd yields the cumulants."""
    s, t, _ = as_tensors(s, maturity, params.v0)
    kap, th, sig, v0 = params.kappa, params.theta, params.sigma, params.v0
    gam = torch.sqrt(kap * kap + 2.0 * sig * sig * s)
    emgt = torch.exp(-gam * t)
    denom = (gam + kap) * (1.0 - emgt) + 2.0 * gam * emgt
    b = 2.0 * s * (1.0 - emgt) / denom
    log_a = (2.0 * kap * th / (sig * sig)) * (torch.log(2.0 * gam) + 0.5 * (kap - gam) * t
                                              - torch.log(denom))
    return log_a - b * v0


def _cumulant_derivs(params: HestonParams, maturity, order: int):
    """The ``order``-th derivative of the Laplace exponent at s = 0."""
    t = torch.as_tensor(maturity, dtype=params.v0.dtype, device=params.v0.device)
    s = torch.zeros((), dtype=t.dtype, device=t.device, requires_grad=True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(heston_integrated_variance_laplace(s, params, t), s,
                                   create_graph=order > 1)
        if order > 1:
            (g,) = torch.autograd.grad(g, s)
    return g.detach(), t


def heston_expected_variance(params: HestonParams, maturity):
    """E[I_T/T], the fair variance-swap strike, as −K'(0)/T of the cumulant
    transform (= θ + (v0 − θ)(1 − e^{−κT})/(κT))."""
    g, t = _cumulant_derivs(params, maturity, 1)
    return -g / t


def heston_variance_of_variance(params: HestonParams, maturity):
    """Var[I_T/T] = K''(0)/T² by second-order autograd."""
    h, t = _cumulant_derivs(params, maturity, 2)
    return h / (t * t)


def heston_variance_swap_strike(params: HestonParams, maturity):
    """Alias with the contract-language name."""
    return heston_expected_variance(params, maturity)


def heston_vol_swap_strike(params: HestonParams, maturity, n_nodes: int = 128,
                           u_max: float = 2000.0):
    """Exact fair volatility-swap strike E[√(I_T/T)] under Heston:
    (1/√π) ∫₀^∞ (1 − L(u²/T))/u² du on Gauss–Legendre panels [0, 2], [2, 20],
    [20, u_max], plus the analytic tail 1/u_max (where L ≈ 0). Evaluated in
    float64 (near u = 0 the transform cancels in float32, by 5e-4 of the
    strike at T = 2), returned in the parameters' dtype."""
    dtype, dev = params.v0.dtype, params.v0.device
    p64 = HestonParams(*(getattr(params, k).to(torch.float64)
                         for k in ("v0", "kappa", "theta", "sigma", "rho")))
    t = torch.as_tensor(maturity, dtype=torch.float64, device=dev)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for a, b in ((0.0, 2.0), (2.0, 20.0), (20.0, float(u_max))):
        u_np, w_np = _gl_nodes(n_nodes, a, b)
        u = torch.tensor(u_np, dtype=torch.float64, device=dev)
        w = torch.tensor(w_np, dtype=torch.float64, device=dev)
        logl = heston_integrated_variance_laplace(u * u / t, p64, t)
        total = total + torch.sum(w * (-torch.expm1(logl) / (u * u)))
    total = total + 1.0 / u_max
    return (total / math.sqrt(math.pi)).to(dtype)


def heston_vol_swap_strike_brockhaus_long(params: HestonParams, maturity):
    """Brockhaus–Long (2000): K_vol ≈ √K_var − Var[X]/(8 K_var^{3/2})."""
    kv = heston_expected_variance(params, maturity)
    vv = heston_variance_of_variance(params, maturity)
    return torch.sqrt(kv) - vv / (8.0 * kv**1.5)


def heston_integrated_variance_mc(params: HestonParams, maturity, generator: torch.Generator,
                                  n_paths: int = 100_000, n_steps: int = 252):
    """Monte Carlo oracle: full-truncation Euler of the CIR variance with
    antithetic normals, trapezoid integration. Returns (mean I/T, its
    stderr, mean √(I/T), its stderr) on the generator's device."""
    if n_paths % 2:
        raise ValidationError("n_paths must be even (antithetic pairs)")
    dev = generator.device
    p = HestonParams(*(getattr(params, k).to(dev) for k in ("v0", "kappa", "theta", "sigma",
                                                            "rho")))
    dtype = p.v0.dtype
    t = torch.as_tensor(maturity, dtype=dtype, device=dev)
    dt = t / n_steps
    sq_dt = torch.sqrt(dt)
    half = n_paths // 2
    v = p.v0.expand(n_paths).clone()
    acc = torch.zeros((n_paths,), dtype=dtype, device=dev)
    for _ in range(n_steps):
        z = torch.randn((half,), generator=generator, dtype=dtype, device=dev)
        z = torch.cat([z, -z])
        vp = torch.clamp_min(v, 0.0)
        v = v + p.kappa * (p.theta - vp) * dt + p.sigma * torch.sqrt(vp) * sq_dt * z
        acc = acc + 0.5 * (vp + torch.clamp_min(v, 0.0)) * dt
    x = acc / t
    rx = torch.sqrt(torch.clamp_min(x, 0.0))
    rn = math.sqrt(n_paths)
    return (x.mean(), x.std(correction=0) / rn, rx.mean(), rx.std(correction=0) / rn)


def bates_variance_swap_strike(params, maturity):
    """Exact fair variance-swap strike under Bates, on realised quadratic
    variation: K_var = E[(1/T)∫v dt] + λ(μ_J² + σ_J²). ``params``: a
    ``bates.BatesParams``; reduces to the Heston strike at λ = 0."""
    diff = heston_expected_variance(
        HestonParams(v0=params.v0, kappa=params.kappa, theta=params.theta, sigma=params.sigma,
                     rho=params.rho), maturity)
    return diff + params.lam * (params.mu_j**2 + params.sigma_j**2)
