"""Forward-start options under Heston and Bates, semi-analytic and by Monte
Carlo.

The port of ``optionslab_tpu/models/forward_start.py``. Payoff at T2:
S_{T1}·max(cp·(S_{T2}/S_{T1} − k), 0). With X = ln(S_{T2}/S_{T1}) and
τ = T2 − T1,

    V = S0 e^{-q T1} · LewisPrice(spot=1, strike=k, T=τ, cf=φ_R),
    φ_R(u) = exp(θ·C(u, τ)) · M_{v_T1}(D(u, τ)),

with (C, D) the Heston log-forward CF pieces (``heston._heston_cd``) and M
the noncentral-χ² MGF of v_{T1} under the share measure (κ* = κ − ρσ,
θ* = κθ/κ*). Bates multiplies the jump CF over τ. The prices are complex
tensor arithmetic in the parameters' dtype, on the device of the call, and
differentiable by autograd; :func:`forward_start_mc_price` is the
full-truncation Euler oracle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..types import ContractBatch
from .heston import _heston_cd, lewis_price
from .iv import implied_vol

__all__ = ["forward_start_price", "forward_start_mc_price", "forward_smile_iv"]


def _cir_share_mgf(z, params, t1):
    """E^S[exp(z·v_{T1})] under the share measure (shifted CIR)."""
    kap_s = params.kappa - params.rho * params.sigma
    # the kappa* -> 0 singularity: c and lambda have finite limits
    kap_s = torch.where(torch.abs(kap_s) < 1e-6, 1e-6, kap_s)
    theta_s = params.kappa * params.theta / kap_s
    # the t1 -> 0 singularity of lambda: expm1, clamped away from 0 keeping
    # its sign (kappa* < 0 is legitimate for rho*sigma > kappa)
    one_memkt = -torch.expm1(-kap_s * t1)
    one_memkt = torch.where(torch.abs(one_memkt) < 1e-12, 1e-12, one_memkt)
    emkt = 1.0 - one_memkt
    c = params.sigma**2 * one_memkt / (4.0 * kap_s)
    nu = 4.0 * kap_s * theta_s / params.sigma**2
    lam = 4.0 * kap_s * emkt * params.v0 / (params.sigma**2 * one_memkt)
    one_m = 1.0 - 2.0 * c * z
    return torch.exp(-0.5 * nu * torch.log(one_m) + lam * c * z / one_m)


def _forward_return_cf(u, params, t1, tau, jump_cf=None):
    hp = params.heston if hasattr(params, "heston") else params
    C, D = _heston_cd(u, hp, tau)
    phi = torch.exp(hp.theta * C) * _cir_share_mgf(D, hp, t1)
    if jump_cf is not None:
        phi = phi * jump_cf(u, tau)
    return phi


def forward_start_price(spot, k_ratio, t1, t2, rate, params, dividend=0.0, option_type=1.0,
                        n_nodes: int = 128, u_max: float = 200.0, device="cuda"):
    """Forward-start option: payoff S_{T1}·max(cp·(S_{T2}/S_{T1} − k), 0).

    ``params``: HestonParams or BatesParams, moved to ``device``; the price
    is in their dtype. Semi-analytic by the Lewis engine on the
    forward-return CF; differentiable by autograd."""
    params = params.to(device=torch.device(device))
    dtype, dev = params.kappa.dtype, params.kappa.device
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    t1_, t2_ = t(t1), t(t2)
    tau = t2_ - t1_
    jump_cf = None
    if hasattr(params, "lam"):  # Bates: the iid jump CF over tau
        from .bates import _jump_cf

        jump_cf = lambda u, tt: _jump_cf(u, params, tt)  # noqa: E731
    cf = lambda u, tt: _forward_return_cf(u, params, t1_, tt, jump_cf)  # noqa: E731
    k = t(k_ratio)
    unit = ContractBatch(spot=torch.ones_like(k), strike=k, maturity=tau, rate=t(rate),
                         vol=t(0.2), dividend=t(dividend), cp=t(option_type))
    unit_price = lewis_price(unit, cf, n_nodes=n_nodes, u_max=u_max)
    return t(spot) * torch.exp(-t(dividend) * t1_) * unit_price


def forward_smile_iv(k_ratios, t1, t2, params, rate=0.0, dividend=0.0, device="cuda"):
    """Forward implied-vol smile: Black–Scholes implied vols of forward-start
    prices on the unit asset over [T1, T2]."""
    prices = forward_start_price(1.0, k_ratios, t1, t2, rate, params, dividend=dividend,
                                 device=device)
    # undo the e^{-q T1} prefactor: the unit-asset option value itself
    prices = prices / np.exp(-float(dividend) * float(t1))
    dt, dev = prices.dtype, prices.device
    one = torch.ones((), dtype=dt, device=dev)
    k = torch.as_tensor(k_ratios, dtype=dt, device=dev)
    return implied_vol(prices, one, k, torch.as_tensor(float(t2) - float(t1), dtype=dt,
                                                       device=dev),
                       torch.as_tensor(rate, dtype=dt, device=dev), cp=one,
                       dividend=torch.as_tensor(dividend, dtype=dt, device=dev))


def forward_start_mc_price(spot, k_ratio, t1, t2, rate, params, generator: torch.Generator,
                           dividend=0.0, option_type=1.0, n_paths: int = 200_000,
                           n_steps: int = 200, antithetic: bool = True):
    """Monte Carlo oracle: full-truncation Euler to T2 recording S at T1, in
    float32 on the generator's device. Returns (price, stderr), 0-dim
    tensors. Heston or Bates parameters."""
    dev = generator.device
    params = params.to(dtype=torch.float32, device=dev)
    hp = params.heston if hasattr(params, "heston") else params
    has_jumps = hasattr(params, "lam")
    f = np.float32
    dt_h = f(t2) / f(n_steps)
    # T1 snapped to the nearest grid index (exact when t1/t2·n_steps is whole)
    i1 = int(np.round(f(t1) / dt_h))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    rate, dividend, t2_ = f32(rate), f32(dividend), f32(t2)
    dt = t2_ / n_steps
    sq_dt = torch.sqrt(dt)
    half = n_paths // 2 if antithetic else n_paths
    n_eff = half * 2 if antithetic else n_paths
    rho, srho = hp.rho, torch.sqrt(torch.clamp_min(1.0 - hp.rho**2, 0.0))
    if has_jumps:
        kbar = torch.exp(params.mu_j + 0.5 * params.sigma_j**2) - 1.0

    def pair(z):
        return torch.cat([z, -z]) if antithetic else z

    x = torch.zeros(n_eff, dtype=torch.float32, device=dev)
    v = hp.v0.expand(n_eff).clone()
    x1 = x
    for i in range(n_steps):
        z = torch.randn((3, half), generator=generator, dtype=torch.float32, device=dev)
        zv = pair(z[0])
        zx = rho * zv + srho * pair(z[1])
        vp = torch.clamp_min(v, 0.0)
        sq_v = torch.sqrt(vp)
        x_new = x + (rate - dividend) * dt - 0.5 * vp * dt + sq_v * sq_dt * zx
        if has_jumps:
            n_jump = torch.poisson((params.lam * dt).expand(n_eff).contiguous(),
                                   generator=generator)
            x_new = x_new - params.lam * kbar * dt + n_jump * params.mu_j \
                + params.sigma_j * torch.sqrt(n_jump) * pair(z[2])
        v = v + hp.kappa * (hp.theta - vp) * dt + hp.sigma * sq_v * sq_dt * zv
        x = x_new
        if i + 1 == i1:
            x1 = x_new
    s1 = float(spot) * torch.exp(x1)
    pay = s1 * torch.clamp_min(f32(option_type) * (torch.exp(x - x1) - f32(k_ratio)), 0.0)
    disc = torch.exp(-rate * t2_)
    return disc * pay.mean(), disc * pay.std(correction=0) / math.sqrt(n_eff)
