"""Jump diffusions: Merton (lognormal jumps) and Kou (double-exponential jumps).

The port of ``optionslab_tpu/models/jump_diffusion.py``.

* :func:`merton_price` — the Poisson-weighted Black–Scholes series with a
  fixed number of terms, one pass over (contracts × terms).
* :func:`merton_mc_price` and :func:`kou_mc_price` draw the exact
  compound-Poisson terminal law per path (no step loop) from an explicit
  ``torch.Generator`` on the batch's device; Kou's jump sum keeps the
  reference's fixed buffer of ``max_jumps`` candidate jumps per path.
"""

from __future__ import annotations

import torch

from ..types import ContractBatch
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from .black_scholes import bs_price


def merton_kappa(mu_j, sigma_j):
    """E[e^J] − 1 for lognormal jumps."""
    return torch.exp(mu_j + 0.5 * sigma_j**2) - 1.0


def _param(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def merton_price(batch: ContractBatch, lam, mu_j, sigma_j, n_terms: int = 40) -> torch.Tensor:
    """Merton (1976): price = Σ_n P(N = n) · BS(σ_n, r_n) with
    σ_n² = σ² + n·σ_J²/T, r_n = r − λκ + n·(μ_J + σ_J²/2)/T; ``n_terms`` = 40
    covers λT up to about 10 to a 1e-12 tail mass."""
    b = batch.broadcast()
    dtype, dev = b.dtype, b.device
    lam, mu_j, sigma_j = (_param(x, dtype, dev) for x in (lam, mu_j, sigma_j))
    t = torch.clamp_min(b.maturity, EPS_TIME)
    kappa = merton_kappa(mu_j, sigma_j)
    lam_p = lam * (1.0 + kappa)  # intensity under the n-conditioned measure

    n = torch.arange(n_terms, dtype=dtype, device=dev)
    tc = t[..., None]
    # the clamp keeps λ = 0 finite: n = 0 → weight 1, n ≥ 1 → exp(−69n) ≈ 0
    log_w = (-lam_p * tc + n * torch.log(torch.clamp_min(lam_p * tc, 1e-30))
             - torch.lgamma(n + 1.0))
    w = torch.exp(log_w)
    sig_n = torch.sqrt(b.vol[..., None] ** 2 + n * sigma_j**2 / tc)
    r_n = b.rate[..., None] - lam * kappa + n * (mu_j + 0.5 * sigma_j**2) / tc
    prices_n = bs_price(b.spot[..., None], b.strike[..., None], tc, r_n, sig_n,
                        b.cp[..., None], b.dividend[..., None])
    price = torch.sum(w * prices_n, dim=-1)
    intrinsic = torch.clamp_min(b.cp * (b.spot - b.strike), 0.0)
    return torch.where(b.maturity <= EPS_TIME, intrinsic, price)


def _flat32(batch: ContractBatch):
    b = batch.broadcast()
    return b.shape, ContractBatch(*(f.reshape(-1).to(torch.float32) for f in b._fields()))


def _terminal_price(flat: ContractBatch, shape, drift_adj, z, jump_sum):
    """Discounted mean payoff of S_T = S0·exp(drift + σ√T·z + jumps), (C, P)."""
    t = torch.clamp_min(flat.maturity, EPS_TIME)[:, None]
    drift = (flat.rate - flat.dividend - drift_adj - 0.5 * flat.vol**2)[:, None] * t
    diffu = (flat.vol * torch.sqrt(t[:, 0]))[:, None] * z
    st = flat.spot[:, None] * torch.exp(drift + diffu + jump_sum)
    pay = torch.clamp_min(flat.cp[:, None] * (st - flat.strike[:, None]), 0.0)
    price = torch.exp(-flat.rate * flat.maturity) * pay.mean(dim=1)
    intrinsic = torch.clamp_min(flat.cp * (flat.spot - flat.strike), 0.0)
    return torch.where(flat.maturity <= EPS_TIME, intrinsic, price).reshape(shape)


def _antithetic(z, jump_sum, antithetic: bool):
    if antithetic:
        return torch.cat([z, -z], dim=1), torch.cat([jump_sum, jump_sum], dim=1)
    return z, jump_sum


def merton_mc_price(batch: ContractBatch, lam, mu_j, sigma_j, generator: torch.Generator,
                    n_paths: int = 100_000, antithetic: bool = True) -> torch.Tensor:
    """Exact terminal sampling in float32: N ~ Poisson(λT), Σ jumps | N ~
    Normal(Nμ_J, Nσ_J²), one draw of each per path; antithetic pairs share
    their jumps."""
    shape, flat = _flat32(batch)
    dev = flat.spot.device
    lam, mu_j, sigma_j = (_param(x, torch.float32, dev) for x in (lam, mu_j, sigma_j))
    c = flat.spot.shape[0]
    t = torch.clamp_min(flat.maturity, EPS_TIME)[:, None]
    half = n_paths // 2 if antithetic else n_paths
    rates = (lam * t).expand(c, half).contiguous()
    n_jumps = torch.poisson(rates, generator=generator)
    zj = torch.randn((c, half), generator=generator, device=dev)
    jump_sum = n_jumps * mu_j + torch.sqrt(n_jumps) * sigma_j * zj
    z = torch.randn((c, half), generator=generator, device=dev)
    z, jump_sum = _antithetic(z, jump_sum, antithetic)
    return _terminal_price(flat, shape, lam * merton_kappa(mu_j, sigma_j), z, jump_sum)


def merton_simulate_path(spot, maturity, rate, vol, lam, mu_j, sigma_j,
                         generator: torch.Generator, n_steps: int = 252, dividend=0.0):
    """One jump-diffusion trajectory of ``n_steps + 1`` points (float32, on
    the generator's device)."""
    dev = generator.device
    spot, maturity, rate, vol, lam, mu_j, sigma_j, dividend = (
        _param(x, torch.float32, dev)
        for x in (spot, maturity, rate, vol, lam, mu_j, sigma_j, dividend))
    dt = maturity / n_steps
    z = torch.randn(n_steps, generator=generator, device=dev)
    n_jumps = torch.poisson((lam * dt).expand(n_steps).contiguous(), generator=generator)
    zj = torch.randn(n_steps, generator=generator, device=dev)
    jumps = n_jumps * mu_j + torch.sqrt(n_jumps) * sigma_j * zj
    kappa = merton_kappa(mu_j, sigma_j)
    incr = (rate - dividend - lam * kappa - 0.5 * vol**2) * dt + vol * torch.sqrt(dt) * z + jumps
    log_path = torch.cat([torch.zeros(1, device=dev), torch.cumsum(incr, 0)])
    return spot * torch.exp(log_path)


def kou_kappa(p_up, eta1, eta2):
    """E[e^J] − 1 for Kou jumps: p·η₁/(η₁−1) + (1−p)·η₂/(η₂+1) − 1 (η₁ > 1)."""
    return p_up * eta1 / (eta1 - 1.0) + (1.0 - p_up) * eta2 / (eta2 + 1.0) - 1.0


def kou_mc_price(batch: ContractBatch, lam, p_up, eta1, eta2, generator: torch.Generator,
                 n_paths: int = 100_000, max_jumps: int = 32,
                 antithetic: bool = True) -> torch.Tensor:
    """Kou (2002) double-exponential jumps by Monte Carlo, float32.

    The jump sum takes ``max_jumps`` candidate jumps per path (sign from
    Bernoulli(p_up), size Exp(η±)) masked by the path's Poisson count: a
    count above ``max_jumps`` is truncated to it, as in the reference (the
    tail P(N > max_jumps) is negligible for λT up to about 8).
    """
    shape, flat = _flat32(batch)
    dev = flat.spot.device
    lam, p_up, eta1, eta2 = (_param(x, torch.float32, dev) for x in (lam, p_up, eta1, eta2))
    c = flat.spot.shape[0]
    t = torch.clamp_min(flat.maturity, EPS_TIME)[:, None]
    half = n_paths // 2 if antithetic else n_paths
    n_jumps = torch.poisson((lam * t).expand(c, half).contiguous(), generator=generator)
    u = torch.rand((c, half, max_jumps), generator=generator, device=dev)
    e = torch.empty((c, half, max_jumps), device=dev).exponential_(generator=generator)
    jump_vals = torch.where(u < p_up, e / eta1, -e / eta2)
    mask = torch.arange(max_jumps, device=dev)[None, None, :] < n_jumps[..., None]
    jump_sum = torch.sum(torch.where(mask, jump_vals, 0.0), dim=-1)
    z = torch.randn((c, half), generator=generator, device=dev)
    z, jump_sum = _antithetic(z, jump_sum, antithetic)
    return _terminal_price(flat, shape, lam * kou_kappa(p_up, eta1, eta2), z, jump_sum)


class MertonJumpDiffusion:
    """Object adapter: the series price, the Monte Carlo price and one path,
    computed on ``device``."""

    def __init__(self, lam=0.5, mu_j=-0.1, sigma_j=0.2, device="cuda"):
        if lam < 0 or sigma_j < 0:
            raise ValidationError("lambda and sigma_j must be non-negative")
        self.lam, self.mu_j, self.sigma_j = lam, mu_j, sigma_j
        self.device = device

    @property
    def kappa(self):
        return float(merton_kappa(torch.tensor(self.mu_j), torch.tensor(self.sigma_j)))

    def _batch(self, S, K, T, r, sigma, option_type, q):
        return ContractBatch.make(S, K, T, r, sigma, option_type, q, device=self.device)

    def _generator(self, seed):
        return torch.Generator(device=torch.device(self.device)).manual_seed(seed)

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        return merton_price(self._batch(S, K, T, r, sigma, option_type, q), self.lam, self.mu_j,
                            self.sigma_j)

    def price_monte_carlo(self, S, K, T, r, sigma, option_type="call", q=0.0, n_paths=100_000,
                          seed=0):
        return merton_mc_price(self._batch(S, K, T, r, sigma, option_type, q), self.lam,
                               self.mu_j, self.sigma_j, self._generator(seed), n_paths=n_paths)

    def simulate_path(self, S, T, r, sigma, n_steps=252, q=0.0, seed=0):
        return merton_simulate_path(S, T, r, sigma, self.lam, self.mu_j, self.sigma_j,
                                    self._generator(seed), n_steps=n_steps, dividend=q)


class KouJumpDiffusion:
    """Object adapter over :func:`kou_mc_price`, computed on ``device``."""

    def __init__(self, lam=0.5, p_up=0.4, eta1=10.0, eta2=5.0, device="cuda"):
        if eta1 <= 1.0:
            raise ValidationError("eta1 must exceed 1 for a finite jump mean")
        if not 0.0 <= p_up <= 1.0:
            raise ValidationError("p_up must be a probability")
        self.lam, self.p_up, self.eta1, self.eta2 = lam, p_up, eta1, eta2
        self.device = device

    @property
    def kappa(self):
        return float(kou_kappa(*(torch.tensor(x) for x in (self.p_up, self.eta1, self.eta2))))

    def price_monte_carlo(self, S, K, T, r, sigma, option_type="call", q=0.0, n_paths=100_000,
                          seed=0):
        batch = ContractBatch.make(S, K, T, r, sigma, option_type, q, device=self.device)
        gen = torch.Generator(device=torch.device(self.device)).manual_seed(seed)
        return kou_mc_price(batch, self.lam, self.p_up, self.eta1, self.eta2, gen,
                            n_paths=n_paths)
