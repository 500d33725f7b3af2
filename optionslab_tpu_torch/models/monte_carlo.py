"""Monte Carlo pricing engine: the tensor path, and the kernel path through
``ops/gbm_kernel.py``.

* ``MCMethod.TENSOR`` simulates with torch tensor ops from normals drawn
  with an explicit ``torch.Generator``; the steps axis reduces to a sum of
  shocks, and the contract axis broadcasts against one shared draw (common
  random numbers by construction).
* ``MCMethod.KERNEL`` prices through the fused GBM kernel, with the full
  Greek ladder from the same pass.
* Greeks on the tensor path are pathwise by ``torch.autograd`` through the
  simulator at fixed normals; gamma uses the mixed likelihood-ratio /
  pathwise estimator (see :func:`mc_greeks`).

The enum's wire values (``"xla"``, ``"pallas"``) are those of
``optionslab_tpu.models.monte_carlo.MCMethod``, so configs and request
bodies written for the JAX package work unchanged.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable

import torch

from ..ops.gbm_kernel import gbm_mc_price_greeks
from ..types import ContractBatch
from ..utils.config import DEFAULT_DTYPE, EPS_TIME
from ..utils.exceptions import ValidationError


class MCMethod(enum.Enum):
    """Sampling backend."""

    TENSOR = "xla"  # torch tensor ops from a torch.Generator
    QMC = "qmc"  # scrambled Sobol: not ported yet (needs ops/rng)
    KERNEL = "pallas"  # fused GBM kernel (ops/gbm_kernel.py)


@dataclasses.dataclass(frozen=True)
class MCConfig:
    n_paths: int = 100_000
    n_steps: int = 1  # 1 = exact single-step terminal GBM
    antithetic: bool = True
    method: MCMethod = MCMethod.TENSOR
    dtype: torch.dtype = DEFAULT_DTYPE


@dataclasses.dataclass(frozen=True)
class MCResult:
    """Price with MC standard error."""

    price: torch.Tensor
    std_error: torch.Tensor
    n_paths: int

    def confidence_interval(self, z: float = 1.96):
        return self.price - z * self.std_error, self.price + z * self.std_error


def _validate_config(cfg: MCConfig) -> None:
    if cfg.n_paths <= 0:
        raise ValidationError(f"n_paths must be positive, got {cfg.n_paths}")
    if cfg.n_steps <= 0:
        raise ValidationError(f"n_steps must be positive, got {cfg.n_steps}")
    if cfg.antithetic and cfg.n_paths % 2:
        raise ValidationError("antithetic sampling requires an even n_paths")
    if cfg.method == MCMethod.QMC:
        raise ValidationError("MCMethod.QMC is not yet ported; use TENSOR or KERNEL")


# ---------------------------------------------------------------------------
# Normal draws — (n_paths, n_steps), shared across the contract axis (CRN)
# ---------------------------------------------------------------------------
def draw_normals(generator: torch.Generator, cfg: MCConfig) -> torch.Tensor:
    """(n_paths, n_steps) standard normals on the generator's device
    (antithetic pairs are rows i and i + n/2)."""
    _validate_config(cfg)
    n, m = cfg.n_paths, cfg.n_steps
    rows = n // 2 if cfg.antithetic else n
    z = torch.randn((rows, m), generator=generator, dtype=cfg.dtype, device=generator.device)
    return torch.cat([z, -z], dim=0) if cfg.antithetic else z


# ---------------------------------------------------------------------------
# GBM terminal / path simulation (differentiable)
# ---------------------------------------------------------------------------
def gbm_terminal(batch: ContractBatch, z: torch.Tensor) -> torch.Tensor:
    """Terminal spots (contracts..., n_paths) from normals z (n_paths, n_steps).

    The step axis reduces to a sum of shocks: GBM increments are exact at
    any step count for terminal-only payoffs.
    """
    n_steps = z.shape[-1]
    dt = batch.maturity[..., None] / n_steps
    drift = (batch.rate - batch.dividend - 0.5 * batch.vol**2)[..., None] * batch.maturity[..., None]
    vol_term = batch.vol[..., None] * torch.sqrt(dt)
    shock = torch.einsum("pm,...m->...p", z, vol_term.expand(batch.shape + (n_steps,)))
    return batch.spot[..., None] * torch.exp(drift + shock)


def gbm_paths(batch: ContractBatch, z: torch.Tensor) -> torch.Tensor:
    """Full paths (contracts..., n_paths, n_steps+1) including t=0."""
    n_steps = z.shape[-1]
    dt = (batch.maturity / n_steps)[..., None, None]
    drift = (batch.rate - batch.dividend - 0.5 * batch.vol**2)[..., None, None] * dt
    shock = batch.vol[..., None, None] * torch.sqrt(dt) * z
    log_path = torch.cumsum(drift + shock, dim=-1)
    s0 = batch.spot[..., None, None]
    paths = s0 * torch.exp(log_path)
    return torch.cat([s0.expand(paths[..., :1].shape), paths], dim=-1)


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------
def _price_from_normals(batch: ContractBatch, z: torch.Tensor,
                        payoff_fn: Callable | None = None) -> torch.Tensor:
    b = batch.broadcast()
    terminal = gbm_terminal(b, z)
    payoffs = b.intrinsic(terminal) if payoff_fn is None else payoff_fn(b, terminal)
    live = b.discount() * payoffs.mean(dim=-1)
    # expired contracts: intrinsic
    return torch.where(b.maturity <= EPS_TIME, b.intrinsic(), live)


def mc_price(batch: ContractBatch, generator: torch.Generator, cfg: MCConfig = MCConfig(),
             payoff_fn: Callable | None = None) -> torch.Tensor:
    """Discounted expected payoff. Differentiable wrt every batch field.

    ``payoff_fn(batch, terminal) -> payoffs`` defaults to vanilla intrinsic.
    """
    return _price_from_normals(batch, draw_normals(generator, cfg), payoff_fn)


def mc_price_result(batch: ContractBatch, generator: torch.Generator,
                    cfg: MCConfig = MCConfig()) -> MCResult:
    """Price + standard error."""
    z = draw_normals(generator, cfg)
    b = batch.broadcast()
    pay = b.intrinsic(gbm_terminal(b, z))
    df = b.discount()
    price = df * pay.mean(dim=-1)
    if cfg.antithetic:
        # stderr from antithetic PAIR means (the independent samples)
        half = cfg.n_paths // 2
        pair = 0.5 * (pay[..., :half] + pay[..., half:])
        se = df * pair.std(dim=-1, correction=1) / math.sqrt(half)
    else:
        se = df * pay.std(dim=-1, correction=1) / math.sqrt(cfg.n_paths)
    expired = b.maturity <= EPS_TIME
    price = torch.where(expired, b.intrinsic(), price)
    se = torch.where(expired, 0.0, se)
    return MCResult(price=price, std_error=se, n_paths=cfg.n_paths)


def mc_price_control_variate(batch: ContractBatch, generator: torch.Generator,
                             cfg: MCConfig = MCConfig()) -> MCResult:
    """Control variate on the terminal spot, whose mean E[S_T] = F is known.

    beta = cov(payoff, S_T)/var(S_T), estimated from the same draw.
    """
    z = draw_normals(generator, cfg)
    b = batch.broadcast()
    terminal = gbm_terminal(b, z)
    pay = b.intrinsic(terminal)
    cv = terminal - b.forward()[..., None]  # zero-mean control
    pay_c = pay - pay.mean(dim=-1, keepdim=True)
    beta = (pay_c * cv).mean(dim=-1) / torch.clamp_min((cv * cv).mean(dim=-1), 1e-12)
    adjusted = pay - beta[..., None] * cv
    df = b.discount()
    price = df * adjusted.mean(dim=-1)
    se = df * adjusted.std(dim=-1, correction=1) / math.sqrt(cfg.n_paths)
    return MCResult(price=price, std_error=se, n_paths=cfg.n_paths)


# ---------------------------------------------------------------------------
# Greeks: pathwise autograd + likelihood-ratio gamma
# ---------------------------------------------------------------------------
def mc_greeks(batch: ContractBatch, generator: torch.Generator,
              cfg: MCConfig = MCConfig()) -> dict:
    """Full MC Greeks in one reverse-mode sweep + LR/PW gamma.

    delta/vega/rho/theta/dual_delta/dividend_rho: pathwise, by autograd of
    the discounted payoff at fixed normals.

    gamma: the vanilla payoff's pathwise second derivative is a.e. 0, so the
    mixed pathwise–likelihood-ratio estimator (Glasserman §7.3) is used; for
    single-step exact GBM

        Γ = e^{-rT}/S_0² · E[ cp·1{cp(S_T-K)>0} · S_T · (Z/(σ√T) - 1) ]
    """
    z = draw_normals(generator, cfg)
    b0 = batch.broadcast()
    S, sig, r, T, q, K = args = [
        x.detach().clone().requires_grad_(True)
        for x in (b0.spot, b0.vol, b0.rate, b0.maturity, b0.dividend, b0.strike)]
    with torch.enable_grad():
        b = ContractBatch(S, K, T, r, sig, q, b0.cp)
        total = (b.discount() * b.intrinsic(gbm_terminal(b, z)).mean(dim=-1)).sum()
        dS, dsig, dr, dT, dq, dK = torch.autograd.grad(total, args)

    # LR-PW gamma on the effective single-step representation:
    # z_eff = (sum of step shocks)/sqrt(n_steps) is standard normal
    z_eff = z.sum(dim=-1) / math.sqrt(z.shape[-1])
    terminal = gbm_terminal(b0, z)
    sig_sqrt_t = b0.vol * torch.sqrt(torch.clamp_min(b0.maturity, EPS_TIME))
    indicator = (b0.cp[..., None] * (terminal - b0.strike[..., None])) > 0
    weight = z_eff / sig_sqrt_t[..., None] - 1.0
    gamma = (
        b0.discount()
        / torch.clamp_min(b0.spot, 1e-30) ** 2
        * (b0.cp[..., None] * torch.where(indicator, terminal, 0.0) * weight).mean(dim=-1)
    )
    return {
        "price": _price_from_normals(batch, z),
        "delta": dS,
        "gamma": gamma,
        "vega": dsig,
        "rho": dr,
        "theta": -dT,
        "dual_delta": dK,
        "dividend_rho": dq,
    }


# ---------------------------------------------------------------------------
# Object-style pricer
# ---------------------------------------------------------------------------
class MonteCarloPricer:
    """Object-style adapter over the functional engine, on one device.

    Every call draws from a generator seeded with ``seed``, so repeated
    calls with the same inputs give the same numbers. With
    ``method=MCMethod.KERNEL`` a call is one pass of the fused GBM kernel on
    ``device`` (the plain torch version when ``device`` is the CPU).
    """

    def __init__(self, n_paths: int = 100_000, n_steps: int = 1, antithetic: bool = True,
                 method: MCMethod = MCMethod.TENSOR, seed: int = 0, dtype=None,
                 device="cuda"):
        self.cfg = MCConfig(n_paths=n_paths, n_steps=n_steps, antithetic=antithetic,
                            method=method, dtype=dtype or DEFAULT_DTYPE)
        _validate_config(self.cfg)
        self.seed = seed
        self.device = torch.device(device)

    def _batch(self, S, K, T, r, sigma, option_type, q) -> ContractBatch:
        return ContractBatch.make(S, K, T, r, sigma, option_type, q, dtype=self.cfg.dtype,
                                  device=self.device)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def _kernel(self, batch: ContractBatch) -> dict:
        return gbm_mc_price_greeks(batch, n_paths=self.cfg.n_paths, seed=self.seed)

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0, return_result: bool = False):
        b = self._batch(S, K, T, r, sigma, option_type, q)
        if self.cfg.method == MCMethod.KERNEL:
            out = self._kernel(b)
            if return_result:
                return MCResult(price=out["price"], std_error=out["std_error"],
                                n_paths=self.cfg.n_paths)
            return out["price"]
        if return_result:
            return mc_price_result(b, self._generator(), self.cfg)
        return mc_price(b, self._generator(), self.cfg)

    # batch aliases — the functional engine is batched by construction
    price_batch = price

    def delta_gamma(self, S, K, T, r, sigma, option_type="call", q=0.0):
        g = self.greeks(S, K, T, r, sigma, option_type, q)
        return g["delta"], g["gamma"]

    delta_gamma_batch = delta_gamma

    def greeks(self, S, K, T, r, sigma, option_type="call", q=0.0) -> dict:
        b = self._batch(S, K, T, r, sigma, option_type, q)
        if self.cfg.method == MCMethod.KERNEL:
            return self._kernel(b)
        return mc_greeks(b, self._generator(), self.cfg)
