"""Bates (1996) stochastic volatility with jumps.

The port of ``optionslab_tpu/models/bates.py``:

    dS/S = (r − q − λk̄) dt + √v dW_S + (e^J − 1) dN
    dv   = κ(θ − v) dt + σ√v dW_v,   d⟨W_S, W_v⟩ = ρ dt
    J ~ N(μ_J, σ_J²),  N ~ Poisson(λ),  k̄ = e^{μ_J + σ_J²/2} − 1

The characteristic function factorizes, φ_Bates = φ_Heston · φ_jump (both
forward-normalized), so :func:`bates_price` runs the port's Lewis engine and
:func:`bates_price_cos` its COS engine with the jump cumulants added; both
follow the batch's dtype and are differentiable by ``torch.autograd``.
λ → 0 is exactly Heston; σ → 0 with v0 = θ is Merton. :func:`bates_mc_price`
is the scan engine (a Python loop over the steps on a ``torch.Generator``);
the Bates kernel path is ``ops/heston_exotic_kernel.py`` with a
:class:`BatesParams`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..types import ContractBatch
from ..utils.config import EPS_TIME
from ..utils.exceptions import CalibrationError, ValidationError
from .heston import (
    HestonParams,
    _flat,
    _heston_cf,
    _heston_cumulants,
    _mc_payoff,
    _normals,
    _softplus,
    cos_price,
    lewis_price,
)

__all__ = ["BatesParams", "bates_price", "bates_price_cos", "bates_mc_price", "calibrate_bates",
           "BatesPricer"]

PARAM_NAMES = ("v0", "kappa", "theta", "sigma", "rho", "lam", "mu_j", "sigma_j")


@dataclasses.dataclass(frozen=True)
class BatesParams:
    """Heston parameters plus lognormal jumps: ``lam`` the jump intensity
    (per year), ``mu_j`` / ``sigma_j`` the mean / std of the log-jump."""

    v0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor
    lam: torch.Tensor
    mu_j: torch.Tensor
    sigma_j: torch.Tensor

    @classmethod
    def make(cls, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, lam=0.5, mu_j=-0.1,
             sigma_j=0.15, dtype=torch.float32, device=None) -> "BatesParams":
        """Parameters as tensors of ``dtype``; tensors that already have it
        pass through (their autograd graph with them)."""
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (v0, kappa, theta, sigma, rho, lam, mu_j, sigma_j)))

    @classmethod
    def from_numpy(cls, fields, device=None) -> "BatesParams":
        """Parameters from numpy arrays (or numbers) keyed by field name,
        keeping their dtype: ``{k: np.asarray(getattr(jax_params, k)) for k
        in PARAM_NAMES}`` carries the JAX package's parameters across."""
        return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device)
                      for k in PARAM_NAMES})

    def to(self, dtype=None, device=None) -> "BatesParams":
        return BatesParams(*(getattr(self, k).to(dtype=dtype, device=device)
                             for k in PARAM_NAMES))

    @property
    def heston(self) -> HestonParams:
        return HestonParams(v0=self.v0, kappa=self.kappa, theta=self.theta, sigma=self.sigma,
                            rho=self.rho)

    def validate(self) -> None:
        self.heston.validate()
        lam = float(self.lam.detach().reshape(-1)[0])
        sigma_j = float(self.sigma_j.detach().reshape(-1)[0])
        if lam < 0:
            raise ValidationError(f"jump intensity must be >= 0: {lam}")
        if sigma_j < 0:
            raise ValidationError(f"jump vol must be >= 0: {sigma_j}")


def _kbar(params: BatesParams) -> torch.Tensor:
    return torch.exp(params.mu_j + 0.5 * params.sigma_j**2) - 1.0


def _jump_cf(u, params: BatesParams, maturity):
    """Forward-normalized CF of the compensated jump part of ln(S_T/F):
    exp(λT(e^{iuμ_J − u²σ_J²/2} − 1) − iuλTk̄); φ(−i) = 1."""
    iu = 1j * u
    return torch.exp(params.lam * maturity * (
        torch.exp(iu * params.mu_j - 0.5 * u * u * params.sigma_j**2) - 1.0)
        - iu * params.lam * maturity * _kbar(params))


def _bates_cf(u, params: BatesParams, maturity):
    return _heston_cf(u, params.heston, maturity) * _jump_cf(u, params, maturity)


def bates_price(batch: ContractBatch, params: BatesParams, n_nodes: int = 128,
                u_max: float = 200.0) -> torch.Tensor:
    """European prices by the Lewis integral with the Bates CF."""
    return lewis_price(batch, lambda u, t: _bates_cf(u, params, t), n_nodes=n_nodes, u_max=u_max)


def bates_price_cos(batch: ContractBatch, params: BatesParams, n_terms: int = 256,
                    trunc_l: float = 12.0) -> torch.Tensor:
    """European prices by the COS expansion: the Heston cumulants plus the
    jump cumulants (c1 += λT(μ_J − k̄), c2 += λT(μ_J² + σ_J²)) set the
    truncation range."""

    def cumulants(flat, t):
        c1, c2 = _heston_cumulants(params.heston, flat.rate, flat.dividend, t)
        c1 = c1 + params.lam * t * (params.mu_j - _kbar(params))
        c2 = c2 + params.lam * t * (params.mu_j**2 + params.sigma_j**2)
        return c1, c2

    return cos_price(batch, lambda u, t: _bates_cf(u, params, t), cumulants, n_terms, trunc_l)


def bates_mc_price(batch: ContractBatch, params: BatesParams, generator: torch.Generator,
                   n_paths: int = 100_000, n_steps: int = 100,
                   antithetic: bool = True) -> torch.Tensor:
    """Full-truncation Euler Monte Carlo with compound-Poisson log-jumps, on
    the batch's device in float32. Per step the jump is N·μ_J + σ_J·√N·Z
    with N ~ Poisson(λ dt) (exact in distribution); the normals of a step are
    mirrored by the antithetic pairing, the counts are not (they have no
    sign symmetry)."""
    flat = _flat(batch).astype(torch.float32)
    par = params.to(dtype=torch.float32, device=flat.spot.device)
    dev = flat.spot.device
    c = flat.spot.shape[0]
    half = n_paths // 2 if antithetic else n_paths
    n_eff = 2 * half if antithetic else n_paths
    t = torch.clamp_min(flat.maturity, EPS_TIME)[:, None]
    dt = t / n_steps
    sqrt_dt = torch.sqrt(dt)
    srho = torch.sqrt(torch.clamp_min(1.0 - par.rho**2, 0.0))
    kbar = _kbar(par)
    rate_dt = (par.lam * dt).expand(c, n_eff).contiguous()
    x = torch.zeros((c, n_eff), dtype=torch.float32, device=dev)
    v = par.v0.expand(c, n_eff).clone()
    for _ in range(n_steps):
        zv = _normals(generator, (c, half), dev, antithetic)
        zo = _normals(generator, (c, half), dev, antithetic)
        zj = _normals(generator, (c, half), dev, antithetic)
        zx = par.rho * zv + srho * zo
        n_jump = torch.poisson(rate_dt, generator=generator)
        vp = torch.clamp_min(v, 0.0)
        sq_v = torch.sqrt(vp)
        jump = n_jump * par.mu_j + par.sigma_j * torch.sqrt(n_jump) * zj
        x = x + (flat.rate - flat.dividend)[:, None] * dt - par.lam * kbar * dt - 0.5 * vp * dt \
            + sq_v * sqrt_dt * zx + jump
        v = v + par.kappa * (par.theta - vp) * dt + par.sigma * sq_v * sqrt_dt * zv
    return _mc_payoff(batch, flat, x)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------
def _to_unconstrained(p: BatesParams) -> torch.Tensor:
    def inv_sp(x):
        return torch.log(torch.expm1(torch.clamp_min(x, 1e-8)))

    return torch.stack([inv_sp(p.v0), inv_sp(p.kappa), inv_sp(p.theta), inv_sp(p.sigma),
                        torch.atanh(torch.clamp(p.rho, -0.99, 0.99)),
                        inv_sp(torch.clamp_min(p.lam, 1e-6)), p.mu_j,
                        inv_sp(torch.clamp_min(p.sigma_j, 1e-6))])


def _from_unconstrained(x: torch.Tensor) -> BatesParams:
    return BatesParams(v0=_softplus(x[0]), kappa=_softplus(x[1]), theta=_softplus(x[2]),
                       sigma=_softplus(x[3]), rho=torch.tanh(x[4]), lam=_softplus(x[5]),
                       mu_j=x[6], sigma_j=_softplus(x[7]))


def calibrate_bates(market_prices, batch: ContractBatch, init: BatesParams | None = None,
                    n_steps: int = 600, learning_rate: float = 0.02,
                    weights=None) -> tuple[BatesParams, float]:
    """Fit all 8 Bates parameters to prices (relative-MSE loss) by Adam
    (``ops/optim.scan_adam``) through autograd of :func:`bates_price`, on
    the batch's device. Returns (params, best loss); raises
    CalibrationError on a non-finite loss."""
    from ..ops.optim import scan_adam

    dev = batch.device
    target = torch.as_tensor(market_prices, dtype=batch.dtype, device=dev)
    w = (torch.ones_like(target) if weights is None
         else torch.as_tensor(weights, dtype=batch.dtype, device=dev))
    init = init or BatesParams.make()
    x0 = _to_unconstrained(init.to(dtype=batch.dtype, device=dev))

    def loss_fn(x):
        model = bates_price(batch, _from_unconstrained(x))
        rel = (model - target) / torch.clamp_min(target, 1e-4)
        return torch.mean(w * rel * rel)

    best_x, best_loss, _ = scan_adam(loss_fn, x0, n_steps, learning_rate)
    best = float(best_loss)
    if not math.isfinite(best):
        raise CalibrationError("Bates calibration diverged (non-finite loss)")
    return _from_unconstrained(best_x.detach()), best


class BatesPricer:
    """Object façade (the shape of :class:`~.heston.HestonPricer`).
    ``device`` (default the card) holds the parameters and runs the
    engines."""

    def __init__(self, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, lam=0.5, mu_j=-0.1,
                 sigma_j=0.15, device="cuda"):
        self.device = torch.device(device)
        self.params = BatesParams.make(v0, kappa, theta, sigma, rho, lam, mu_j, sigma_j,
                                       device=self.device)
        self.params.validate()

    def price_european(self, S, K, T, r, option_type="call", q=0.0, engine: str = "lewis"):
        """``engine``: "lewis" or "cos"."""
        batch = ContractBatch.make(S, K, T, r, 0.2, option_type, q, device=self.device)
        if engine == "cos":
            return bates_price_cos(batch, self.params)
        if engine != "lewis":
            raise ValidationError(f"unknown engine {engine!r}; lewis|cos")
        return bates_price(batch, self.params)
