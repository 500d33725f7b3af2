"""Heston stochastic volatility: semi-analytic pricing, Monte Carlo, calibration.

The port of ``optionslab_tpu/models/heston.py``.

* :func:`heston_price` — the Lewis (2000) single integral on a fixed
  Gauss–Legendre rule, with the Gatheral ("little trap") characteristic
  function on complex tensors; :func:`heston_price_cos` — the Fang–Oosterlee
  COS expansion, an independent second engine. Both follow the dtype of the
  contract batch and are differentiable by ``torch.autograd`` in every
  contract field and every model parameter.
* :func:`heston_mc_price` — the scan engine: a Python loop over the time
  steps drawing from an explicit ``torch.Generator`` (full-truncation Euler
  or Andersen QE), a statistical oracle for the kernels of
  ``ops/heston_kernel.py``; :func:`heston_simulate_paths` returns whole
  paths.
* :func:`calibrate_heston` fits by Adam (``ops/optim.py``) through autograd
  of the Lewis pricer; :func:`calibrate_heston_mc` fits through the chain
  kernel's in-kernel gradients (``ops.heston_kernel.make_chain_pricer``).
* :class:`HestonPricer` — the object façade; ``engine="pallas"`` (the
  reference's wire value) runs the Euler kernel on the pricer's ``device``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..types import ContractBatch
from ..utils.config import EPS_TIME
from ..utils.exceptions import CalibrationError, ValidationError
from ..utils.logging import get_logger

logger = get_logger(__name__)

PARAM_NAMES = ("v0", "kappa", "theta", "sigma", "rho")


@dataclasses.dataclass(frozen=True)
class HestonParams:
    """v0: initial variance, kappa: mean-reversion speed, theta: long-run
    variance, sigma: vol-of-vol, rho: spot/vol correlation."""

    v0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    sigma: torch.Tensor
    rho: torch.Tensor

    @classmethod
    def make(cls, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, dtype=torch.float32,
             device=None) -> "HestonParams":
        """Parameters as tensors of ``dtype``; tensors that already have it
        pass through (their autograd graph with them)."""
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device)
                     for x in (v0, kappa, theta, sigma, rho)))

    @classmethod
    def from_numpy(cls, fields, device=None) -> "HestonParams":
        """Parameters from numpy arrays (or numbers) keyed by field name,
        keeping their dtype: ``{k: np.asarray(getattr(jax_params, k)) for k
        in PARAM_NAMES}`` carries the JAX package's parameters across."""
        return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device)
                      for k in PARAM_NAMES})

    def to(self, dtype=None, device=None) -> "HestonParams":
        return HestonParams(*(getattr(self, k).to(dtype=dtype, device=device)
                              for k in PARAM_NAMES))

    def feller_ok(self) -> torch.Tensor:
        """2κθ ≥ σ² (variance stays strictly positive)."""
        return 2.0 * self.kappa * self.theta >= self.sigma**2

    def validate(self) -> None:
        vals = {k: float(getattr(self, k).detach().reshape(-1)[0]) for k in PARAM_NAMES}
        if vals["v0"] <= 0 or vals["kappa"] <= 0 or vals["theta"] <= 0 or vals["sigma"] <= 0:
            raise ValidationError(f"Heston params must be positive: {vals}")
        if not -1.0 < vals["rho"] < 1.0:
            raise ValidationError(f"rho must be in (-1, 1): {vals['rho']}")
        if 2 * vals["kappa"] * vals["theta"] < vals["sigma"] ** 2:
            logger.warning("Feller condition violated (2κθ=%.4f < σ²=%.4f): variance can hit zero",
                           2 * vals["kappa"] * vals["theta"], vals["sigma"] ** 2)


@functools.lru_cache(maxsize=8)
def _gl_nodes(n: int, a: float, b: float):
    """Gauss–Legendre nodes and weights on [a, b] (numpy float64, cached)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (b - a) * x + 0.5 * (a + b), 0.5 * (b - a) * w


def _heston_cd(u: torch.Tensor, params: HestonParams, maturity):
    """(C, D) of the Heston log-forward CF exp(θ·C + v0·D) at complex ``u``,
    little-trap branch (stable for large T)."""
    kappa, sigma, rho = params.kappa, params.sigma, params.rho
    iu = 1j * u
    alpha = -0.5 * u * (u + 1j)
    beta = kappa - rho * sigma * iu
    gamma2 = 0.5 * sigma**2
    d = torch.sqrt(beta**2 - 4.0 * alpha * gamma2)
    rp = (beta + d) / sigma**2
    rm = (beta - d) / sigma**2
    g = rm / rp
    ed = torch.exp(-d * maturity)
    D = rm * (1.0 - ed) / (1.0 - g * ed)
    C = kappa * (rm * maturity - (2.0 / sigma**2) * torch.log((1.0 - g * ed) / (1.0 - g)))
    return C, D


def _heston_cf(u: torch.Tensor, params: HestonParams, maturity) -> torch.Tensor:
    """CF of log(S_T/F) under Heston (Gatheral's form) at complex ``u``."""
    C, D = _heston_cd(u, params, maturity)
    return torch.exp(params.theta * C + params.v0 * D)


def _flat(batch: ContractBatch) -> ContractBatch:
    b = batch.broadcast()
    return ContractBatch(*(f.reshape(-1) for f in b._fields()))


def lewis_price(batch: ContractBatch, cf_fn, n_nodes: int = 128,
                u_max: float = 200.0) -> torch.Tensor:
    """Generic Lewis single-integral pricer

        C = S e^{-qT} − (√(SK) e^{-(r+q)T/2} / π) ∫₀^∞ Re[e^{iuk} φ(u − i/2)] du / (u² + ¼),
        k = ln(S/K) + (r − q)T,

    for a forward-normalized CF ``cf_fn(u, t)``, on a fixed Gauss–Legendre
    rule over [1e-8, u_max]. Puts by put–call parity."""
    shape = batch.shape
    dtype = batch.dtype
    flat = _flat(batch)
    dev = flat.spot.device
    u_np, w_np = _gl_nodes(n_nodes, 1e-8, u_max)
    u = torch.tensor(u_np, dtype=dtype, device=dev)[:, None]
    w = torch.tensor(w_np, dtype=dtype, device=dev)[:, None]

    t = torch.clamp_min(flat.maturity, EPS_TIME)
    k = torch.log(flat.spot / flat.strike) + (flat.rate - flat.dividend) * t
    phi = cf_fn(u - 0.5j, t[None, :])
    integrand = torch.real(torch.exp(1j * u * k[None, :]) * phi) / (u * u + 0.25)
    integral = torch.sum(w * integrand, dim=0)

    df_q = torch.exp(-flat.dividend * t)
    df_r = torch.exp(-flat.rate * t)
    call = flat.spot * df_q - (torch.sqrt(flat.spot * flat.strike)
                               * torch.exp(-(flat.rate + flat.dividend) * t / 2.0)
                               / math.pi * integral)
    call = torch.clamp_min(call, 0.0)
    put = call - flat.spot * df_q + flat.strike * df_r  # parity
    price = torch.where(flat.cp > 0, call, put)
    intrinsic = torch.clamp_min(flat.cp * (flat.spot - flat.strike), 0.0)
    price = torch.where(flat.maturity <= EPS_TIME, intrinsic, price)
    return price.reshape(shape).to(dtype)


def heston_price(batch: ContractBatch, params: HestonParams, n_nodes: int = 128,
                 u_max: float = 200.0) -> torch.Tensor:
    """European prices by the Lewis integral with the Heston CF."""
    return lewis_price(batch, lambda u, t: _heston_cf(u, params, t), n_nodes=n_nodes,
                       u_max=u_max)


# ---------------------------------------------------------------------------
# COS method (Fang–Oosterlee 2008): the second semi-analytic engine
# ---------------------------------------------------------------------------
def _heston_cumulants(params: HestonParams, rate, dividend, t):
    """c1, c2 of ln(S_T/S_0) (COS paper eq. 30) for the truncation range."""
    v0, k, th, s = params.v0, params.kappa, params.theta, params.sigma
    rho = params.rho
    ekt = torch.exp(-k * t)
    c1 = (rate - dividend) * t + (1.0 - ekt) * (th - v0) / (2.0 * k) - 0.5 * th * t
    c2 = (1.0 / (8.0 * k**3)) * (
        s * t * k * ekt * (v0 - th) * (8.0 * k * rho - 4.0 * s)
        + k * rho * s * (1.0 - ekt) * (16.0 * th - 8.0 * v0)
        + 2.0 * th * k * t * (-4.0 * k * rho * s + s**2 + 4.0 * k**2)
        + s**2 * ((th - 2.0 * v0) * torch.exp(-2.0 * k * t) + th * (6.0 * ekt - 7.0) + 2.0 * v0)
        + 8.0 * k**2 * (v0 - th) * (1.0 - ekt)
    )
    return c1, torch.clamp_min(c2, 1e-12)


def heston_price_cos(batch: ContractBatch, params: HestonParams, n_terms: int = 256,
                     trunc_l: float = 12.0) -> torch.Tensor:
    """European prices by the COS expansion on [c1 ∓ L·√c2] around the
    log-moneyness; the put coefficients are evaluated (bounded payoff) and
    calls follow by parity."""
    return cos_price(batch, lambda u, t: _heston_cf(u, params, t),
                     lambda flat, t: _heston_cumulants(params, flat.rate, flat.dividend, t),
                     n_terms, trunc_l)


def cos_price(batch: ContractBatch, cf_fn, cumulants_fn, n_terms: int = 256,
              trunc_l: float = 12.0) -> torch.Tensor:
    """The COS engine for a forward-normalized CF ``cf_fn(u, t)`` whose
    truncation range comes from ``cumulants_fn(flat batch, t) -> (c1, c2)``
    of ln(S_T/S_0)."""
    shape = batch.shape
    dtype = batch.dtype
    flat = _flat(batch)
    dev = flat.spot.device
    t = torch.clamp_min(flat.maturity, EPS_TIME)
    x = torch.log(flat.spot / flat.strike)

    c1, c2 = cumulants_fn(flat, t)
    a = c1 + x - trunc_l * torch.sqrt(c2)
    bb = c1 + x + trunc_l * torch.sqrt(c2)
    width = bb - a

    k = torch.arange(n_terms, dtype=dtype, device=dev)[:, None]
    u = k * math.pi / width[None, :]
    phi = cf_fn(u - 0.0j, t[None, :]) * torch.exp(
        1j * u * (flat.rate - flat.dividend)[None, :] * t[None, :])

    # put payoff cosine coefficients on [a, d0], d0 = 0 clipped into [a, b]
    kpw = k * math.pi / width[None, :]
    d0 = torch.minimum(torch.clamp_min(a, 0.0), bb)[None, :]
    arg_d = kpw * (d0 - a[None, :])
    chi = (torch.cos(arg_d) * torch.exp(d0) - torch.exp(a[None, :])
           + kpw * torch.sin(arg_d) * torch.exp(d0)) / (1.0 + kpw * kpw)
    psi = torch.where(k == 0, d0 - a[None, :],
                      torch.sin(arg_d) / torch.where(k == 0, torch.ones_like(kpw), kpw))
    v_k = 2.0 / width[None, :] * flat.strike[None, :] * (-chi + psi)

    terms = torch.real(phi * torch.exp(1j * u * (x - a)[None, :])) * v_k
    terms = torch.cat([terms[:1] * 0.5, terms[1:]])  # Σ' halves the k=0 term
    put = torch.exp(-flat.rate * t) * torch.sum(terms, dim=0)
    put = torch.clamp_min(put, 0.0)
    call = put + flat.spot * torch.exp(-flat.dividend * t) - flat.strike * torch.exp(-flat.rate * t)
    price = torch.where(flat.cp > 0, call, put)
    intrinsic = torch.clamp_min(flat.cp * (flat.spot - flat.strike), 0.0)
    price = torch.where(flat.maturity <= EPS_TIME, intrinsic, price)
    return price.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# Monte Carlo: the scan engine (a loop over steps, no path matrix)
# ---------------------------------------------------------------------------
def _mc_setup(batch: ContractBatch, params: HestonParams, n_paths: int, antithetic: bool):
    flat = _flat(batch).astype(torch.float32)
    params = params.to(dtype=torch.float32, device=flat.spot.device)
    half = n_paths // 2 if antithetic else n_paths
    n_eff = 2 * half if antithetic else n_paths
    t = torch.clamp_min(flat.maturity, EPS_TIME)[:, None]
    return flat, params, half, n_eff, t


def _normals(generator, shape, device, antithetic: bool):
    z = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return torch.cat([z, -z], dim=-1) if antithetic else z


def _mc_payoff(batch: ContractBatch, flat: ContractBatch, x: torch.Tensor) -> torch.Tensor:
    st = flat.spot[:, None] * torch.exp(x)
    pay = torch.clamp_min(flat.cp[:, None] * (st - flat.strike[:, None]), 0.0)
    price = torch.exp(-flat.rate * flat.maturity) * pay.mean(dim=-1)
    intrinsic = torch.clamp_min(flat.cp * (flat.spot - flat.strike), 0.0)
    return torch.where(flat.maturity <= EPS_TIME, intrinsic, price).reshape(batch.shape)


def heston_mc_price(batch: ContractBatch, params: HestonParams, generator: torch.Generator,
                    n_paths: int = 100_000, n_steps: int = 100, antithetic: bool = True,
                    scheme: str = "euler") -> torch.Tensor:
    """Heston Monte Carlo on the batch's device, float32.

    ``scheme="euler"``: full truncation (v⁺ = max(v, 0) in drift and
    diffusion; O(dt) bias). ``scheme="qe"``: Andersen (2008)
    quadratic-exponential, near-unbiased at coarse steps; both branches are
    computed and selected. Each step draws its normals (and, for QE, its
    uniform) from ``generator``; antithetic pairs share them."""
    if scheme == "qe":
        return _heston_mc_qe(batch, params, generator, n_paths, n_steps, antithetic)
    if scheme != "euler":
        raise ValidationError(f"scheme must be euler|qe, got {scheme!r}")
    flat, par, half, n_eff, t = _mc_setup(batch, params, n_paths, antithetic)
    dev = flat.spot.device
    c = flat.spot.shape[0]
    dt = t / n_steps
    sqrt_dt = torch.sqrt(dt)
    srho = torch.sqrt(torch.clamp_min(1.0 - par.rho**2, 0.0))
    x = torch.zeros((c, n_eff), dtype=torch.float32, device=dev)
    v = par.v0.expand(c, n_eff).clone()
    for _ in range(n_steps):
        zv = _normals(generator, (c, half), dev, antithetic)
        zo = _normals(generator, (c, half), dev, antithetic)
        zx = par.rho * zv + srho * zo
        vp = torch.clamp_min(v, 0.0)
        sq_v = torch.sqrt(vp)
        x = x + (flat.rate - flat.dividend)[:, None] * dt - 0.5 * vp * dt + sq_v * sqrt_dt * zx
        v = v + par.kappa * (par.theta - vp) * dt + par.sigma * sq_v * sqrt_dt * zv
    return _mc_payoff(batch, flat, x)


def _heston_mc_qe(batch: ContractBatch, params: HestonParams, generator: torch.Generator,
                  n_paths: int, n_steps: int, antithetic: bool) -> torch.Tensor:
    """Andersen QE with central (γ1 = γ2 = 1/2) log-spot weights."""
    flat, par, half, n_eff, t = _mc_setup(batch, params, n_paths, antithetic)
    dev = flat.spot.device
    c = flat.spot.shape[0]
    dt = t / n_steps
    kap, th, sig, rho = par.kappa, par.theta, par.sigma, par.rho
    emkd = torch.exp(-kap * dt)
    # exact conditional moments of v_{t+dt} | v_t: mean c1 + emkd·v, variance s2_v·v + s2_0
    c1 = th * (1.0 - emkd)
    s2_v = sig**2 * emkd * (1.0 - emkd) / kap
    s2_0 = th * sig**2 * (1.0 - emkd) ** 2 / (2.0 * kap)
    # log-spot weights (Andersen eq. 33)
    k0 = -rho * kap * th * dt / sig
    k1 = 0.5 * dt * (kap * rho / sig - 0.5) - rho / sig
    k2 = 0.5 * dt * (kap * rho / sig - 0.5) + rho / sig
    k3 = 0.5 * dt * (1.0 - rho**2)
    k4 = 0.5 * dt * (1.0 - rho**2)
    x = torch.zeros((c, n_eff), dtype=torch.float32, device=dev)
    v = par.v0.expand(c, n_eff).clone()
    for _ in range(n_steps):
        zv = _normals(generator, (c, half), dev, antithetic)
        zx = _normals(generator, (c, half), dev, antithetic)
        u = torch.rand((c, n_eff), generator=generator, device=dev) * (1.0 - 2e-7) + 1e-7
        v_new = _qe_transition(v, zv, u, c1, emkd, s2_v, s2_0)
        x = x + (flat.rate - flat.dividend)[:, None] * dt + k0 + k1 * v + k2 * v_new \
            + torch.sqrt(torch.clamp_min(k3 * v + k4 * v_new, 0.0)) * zx
        v = v_new
    return _mc_payoff(batch, flat, x)


def _qe_transition(v, zv, u, c1, emkd, s2_v, s2_0):
    """Andersen's QE variance step: quadratic branch for psi <= 1.5,
    exponential branch above, both computed and selected."""
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
    v_exp = torch.where(u <= p, torch.zeros_like(v),
                        torch.log((1.0 - p) / torch.clamp_min(1.0 - u, 1e-30))
                        / torch.clamp_min(beta, 1e-30))
    return torch.where(psi <= 1.5, v_quad, v_exp)


def heston_simulate_paths(spot, params: HestonParams, rate, dividend, maturity,
                          generator: torch.Generator, n_paths: int = 1000, n_steps: int = 252):
    """(spots, variances), each (n_paths, n_steps + 1), by full-truncation
    Euler on ``generator``'s device; variances are v⁺."""
    dev = generator.device
    par = params.to(dtype=torch.float32, device=dev)
    dt = torch.tensor(float(maturity) / n_steps, dtype=torch.float32, device=dev)
    sqrt_dt = torch.sqrt(dt)
    drift = float(rate) - float(dividend)
    srho = torch.sqrt(torch.clamp_min(1.0 - par.rho**2, 0.0))
    x = torch.zeros(n_paths, dtype=torch.float32, device=dev)
    v = par.v0.expand(n_paths).clone()
    xs, vs = [x], [v]
    for _ in range(n_steps):
        z = torch.randn((2, n_paths), generator=generator, device=dev)
        zx = par.rho * z[0] + srho * z[1]
        vp = torch.clamp_min(v, 0.0)
        sq_v = torch.sqrt(vp)
        x = x + (drift - 0.5 * vp) * dt + sq_v * sqrt_dt * zx
        v = v + par.kappa * (par.theta - vp) * dt + par.sigma * sq_v * sqrt_dt * z[0]
        xs.append(x)
        vs.append(vp)
    spots = float(spot) * torch.exp(torch.stack(xs, dim=1))
    return spots, torch.stack(vs, dim=1)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------
def _to_unconstrained(p: HestonParams) -> torch.Tensor:
    def inv_sp(x):
        return torch.log(torch.expm1(torch.clamp_min(x, 1e-8)))

    return torch.stack([inv_sp(p.v0), inv_sp(p.kappa), inv_sp(p.theta), inv_sp(p.sigma),
                        torch.atanh(torch.clamp(p.rho, -0.999, 0.999))])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a linear cut-over (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _from_unconstrained(x: torch.Tensor) -> HestonParams:
    return HestonParams(v0=_softplus(x[0]), kappa=_softplus(x[1]), theta=_softplus(x[2]),
                        sigma=_softplus(x[3]), rho=torch.tanh(x[4]))


def _fit(loss_of_params, init: HestonParams, device, n_steps: int, learning_rate: float,
         what: str):
    from ..ops.optim import scan_adam

    x0 = _to_unconstrained(init.to(dtype=torch.float32, device=device))
    best_x, best_loss, _ = scan_adam(lambda x: loss_of_params(_from_unconstrained(x)), x0,
                                     n_steps, learning_rate)
    best = float(best_loss)
    if not math.isfinite(best):
        raise CalibrationError(f"{what} diverged (non-finite loss)")
    params = _from_unconstrained(best_x.detach())
    params.validate()
    return params, best


def _rel_loss(market, weights, device):
    market = torch.as_tensor(market, dtype=torch.float32, device=device).reshape(-1)
    w = (torch.ones_like(market) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=device).reshape(-1))

    def loss(model):
        rel = (model.reshape(-1) - market) / torch.clamp_min(market, 1e-3)
        return torch.mean(w * rel * rel)

    return loss


def calibrate_heston(market_prices, batch: ContractBatch, init: HestonParams | None = None,
                     n_steps: int = 500, learning_rate: float = 0.05,
                     weights=None) -> tuple[HestonParams, float]:
    """Fit Heston to prices by Adam on the relative price error, with
    softplus/tanh transforms for positivity and ρ ∈ (−1, 1); gradients by
    autograd through :func:`heston_price`. Runs on the batch's device.
    Returns (params, best loss); raises CalibrationError on a non-finite
    loss."""
    dev = batch.device
    loss = _rel_loss(market_prices, weights, dev)
    return _fit(lambda p: loss(heston_price(batch, p)), init or HestonParams.make(), dev,
                n_steps, learning_rate, "Heston calibration")


def calibrate_heston_mc(market_prices, strikes, maturities, cps, spot, rate,
                        dividend: float = 0.0, init: HestonParams | None = None,
                        n_steps: int = 200, learning_rate: float = 0.05,
                        n_paths: int = 1_000_000, max_dt: float = 0.02, seed: int = 0,
                        sampler: str = "prng", weights=None,
                        device="cuda") -> tuple[HestonParams, float]:
    """Kernel-speed Monte Carlo calibration: each Adam step prices the whole
    chain and takes its (v0, κ, θ, σ, ρ) gradient from one launch of the
    chain kernel (``ops.heston_kernel.make_chain_pricer``: in-kernel
    pathwise moments, no autograd through the simulation). The fixed seed
    makes the loss surface deterministic. ``n_steps`` Adam steps make
    ``n_steps + 2`` launches. Returns (params, best loss)."""
    from ..ops.heston_kernel import make_chain_pricer

    dev = torch.device(device)
    pricer = make_chain_pricer(strikes, maturities, cps, spot, rate, dividend=dividend,
                               n_paths=n_paths, max_dt=max_dt, seed=seed, sampler=sampler,
                               device=dev)
    loss = _rel_loss(market_prices, weights, dev)

    def of_params(p: HestonParams):
        return loss(pricer(torch.stack([p.v0, p.kappa, p.theta, p.sigma, p.rho])))

    return _fit(of_params, init or HestonParams.make(), dev, n_steps, learning_rate,
                "Heston MC calibration")


class HestonPricer:
    """Object façade. ``device`` (default the card) holds the parameters and
    runs every engine."""

    def __init__(self, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, device="cuda"):
        self.device = torch.device(device)
        self.params = HestonParams.make(v0, kappa, theta, sigma, rho, device=self.device)
        self.params.validate()

    def _batch(self, S, K, T, r, option_type, q) -> ContractBatch:
        return ContractBatch.make(S, K, T, r, torch.sqrt(self.params.v0), option_type, q,
                                  device=self.device)

    def price_european(self, S, K, T, r, option_type="call", q=0.0, engine: str = "lewis"):
        """``engine``: "lewis" (Gauss–Legendre Lewis integral) or "cos"
        (Fang–Oosterlee), two independent semi-analytic engines."""
        batch = self._batch(S, K, T, r, option_type, q)
        if engine == "cos":
            return heston_price_cos(batch, self.params)
        return heston_price(batch, self.params)

    price = price_european

    def price_monte_carlo(self, S, K, T, r, option_type="call", q=0.0, n_paths=100_000,
                          n_steps=100, seed=0, engine="scan"):
        """``engine="pallas"``: the Euler kernel of ``ops/heston_kernel.py``
        (one launch); ``engine="scan"``: :func:`heston_mc_price`."""
        if engine == "pallas":
            from ..ops.heston_kernel import heston_kernel_price

            cp = 1.0 if str(option_type).lower().startswith("c") else -1.0
            price, _, _ = heston_kernel_price(S, K, T, r, self.params, cp, q, n_paths=n_paths,
                                              n_steps=n_steps, seed=seed, device=self.device)
            return price
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return heston_mc_price(self._batch(S, K, T, r, option_type, q), self.params, gen,
                               n_paths=n_paths, n_steps=n_steps)

    def simulate_paths(self, S, T, r, q=0.0, n_paths=1000, n_steps=252, seed=0):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return heston_simulate_paths(S, self.params, r, q, T, gen, n_paths=n_paths,
                                     n_steps=n_steps)
