"""Pure-jump Lévy models: Variance Gamma and Normal Inverse Gaussian.

The port of ``optionslab_tpu/models/levy.py``. Both models are a
characteristic function on the port's Lewis engine (``heston.lewis_price``),
martingale-normalised with the exponential compensator ω = ψ(−i) so that
φ(−i) = 1:

  VG  (Madan–Carr–Chang 1998):  ψ(u) = −T/ν · ln(1 − iuθν + ½σ²νu²)
  NIG (Barndorff-Nielsen 1997): ψ(u) = Tδ(√(α² − β²) − √(α² − (β + iu)²))

The Monte Carlo prices draw the exact terminal law by subordination (a
gamma or inverse-Gaussian time change of a Brownian motion), one draw per
path, from an explicit ``torch.Generator`` on the batch's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..types import ContractBatch
from ..utils.exceptions import ValidationError
from .heston import lewis_price
from .jump_diffusion import _flat32

__all__ = ["VGParams", "NIGParams", "vg_price", "nig_price", "vg_mc_price", "nig_mc_price"]


def _first(x) -> float:
    return float(torch.as_tensor(x).detach().reshape(-1)[0])


@dataclasses.dataclass(frozen=True)
class VGParams:
    """sigma: diffusion scale, nu: variance of the gamma subordinator (ν → 0
    recovers Black–Scholes), theta: drift of the subordinated BM (skew)."""

    sigma: torch.Tensor
    nu: torch.Tensor
    theta: torch.Tensor

    @classmethod
    def make(cls, sigma=0.2, nu=0.2, theta=-0.14, dtype=torch.float32, device=None):
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device) for x in (sigma, nu, theta)))

    @classmethod
    def from_numpy(cls, fields, device=None) -> "VGParams":
        """Parameters from numpy arrays (or numbers) keyed by field name,
        keeping their dtype: the JAX package's ``VGParams`` carried across."""
        return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device)
                      for k in ("sigma", "nu", "theta")})

    def validate(self):
        s, n, th = _first(self.sigma), _first(self.nu), _first(self.theta)
        if s <= 0 or n <= 0:
            raise ValidationError(f"VG needs sigma > 0, nu > 0: {s}, {n}")
        if 1.0 - th * n - 0.5 * s * s * n <= 0:
            raise ValidationError("VG martingale condition 1 - theta*nu - sigma^2*nu/2 > 0 "
                                  f"violated: {1.0 - th * n - 0.5 * s * s * n}")


@dataclasses.dataclass(frozen=True)
class NIGParams:
    """alpha: tail heaviness, beta: skew (|beta| < alpha), delta: scale."""

    alpha: torch.Tensor
    beta: torch.Tensor
    delta: torch.Tensor

    @classmethod
    def make(cls, alpha=8.0, beta=-3.0, delta=0.3, dtype=torch.float32, device=None):
        return cls(*(torch.as_tensor(x, dtype=dtype, device=device) for x in (alpha, beta, delta)))

    @classmethod
    def from_numpy(cls, fields, device=None) -> "NIGParams":
        """Parameters from numpy arrays (or numbers) keyed by field name,
        keeping their dtype: the JAX package's ``NIGParams`` carried across."""
        return cls(**{k: torch.as_tensor(np.array(fields[k]), device=device)
                      for k in ("alpha", "beta", "delta")})

    def validate(self):
        a, b, d = _first(self.alpha), _first(self.beta), _first(self.delta)
        if d <= 0 or a <= 0 or abs(b) >= a:
            raise ValidationError(f"NIG needs delta > 0, 0 < |beta| < alpha: {a}, {b}, {d}")
        if abs(b + 1.0) >= a:
            raise ValidationError(f"NIG martingale condition |beta + 1| < alpha violated: "
                                  f"beta={b}, alpha={a}")


def _clog1p(z):
    """Complex log(1 + z) without forming 1 + z for tiny |z| (the rounding
    would blow up the VG CF's ν → 0 limit in float32)."""
    series = z * (1.0 - z * (0.5 - z / 3.0))
    return torch.where(torch.abs(z) < 1e-4, series, torch.log(1.0 + z))


def _vg_log_cf_unnorm(u, p: VGParams, t):
    """log E[e^{iuX_t}] of the raw VG process (no compensator)."""
    iu = 1j * u
    z = -iu * p.theta * p.nu + 0.5 * p.sigma**2 * p.nu * u * u
    return -(t / p.nu) * _clog1p(z)


def _nig_log_cf_unnorm(u, p: NIGParams, t):
    iu = 1j * u
    g0 = torch.sqrt(p.alpha**2 - p.beta**2)
    return t * p.delta * (g0 - torch.sqrt(p.alpha**2 - (p.beta + iu) ** 2))


def _minus_i(t) -> torch.Tensor:
    """The complex scalar −i in the complex dtype that matches ``t``."""
    ctype = torch.complex128 if t.dtype == torch.float64 else torch.complex64
    return torch.tensor(-1j, dtype=ctype, device=t.device)


def _normalized_cf(log_cf_unnorm, params, u, t):
    """φ of ln(S_T/F): subtract iu·ω so that φ(−i) = 1."""
    omega = log_cf_unnorm(_minus_i(t), params, t)
    return torch.exp(log_cf_unnorm(u, params, t) - 1j * u * omega)


def vg_price(batch: ContractBatch, params: VGParams, n_nodes: int = 256,
             u_max: float = 400.0) -> torch.Tensor:
    """European prices under Variance Gamma by the Lewis integral (VG's CF
    decays only polynomially: a denser rule than Heston's)."""
    return lewis_price(batch, lambda u, t: _normalized_cf(_vg_log_cf_unnorm, params, u, t),
                       n_nodes=n_nodes, u_max=u_max)


def nig_price(batch: ContractBatch, params: NIGParams, n_nodes: int = 256,
              u_max: float = 400.0) -> torch.Tensor:
    """European prices under Normal Inverse Gaussian by the Lewis integral."""
    return lewis_price(batch, lambda u, t: _normalized_cf(_nig_log_cf_unnorm, params, u, t),
                       n_nodes=n_nodes, u_max=u_max)


def _params32(params, device):
    return type(params)(*(torch.as_tensor(getattr(params, f.name), dtype=torch.float32,
                                          device=device)
                          for f in dataclasses.fields(params)))


def _mc_result(shape, flat: ContractBatch, x, omega, n_paths):
    t = flat.maturity[:, None]
    st = flat.spot[:, None] * torch.exp((flat.rate - flat.dividend)[:, None] * t + x - omega)
    pay = torch.clamp_min(flat.cp[:, None] * (st - flat.strike[:, None]), 0.0)
    df = torch.exp(-flat.rate * flat.maturity)
    price = df * pay.mean(dim=-1)
    stderr = df * pay.std(dim=-1, correction=0) / math.sqrt(n_paths)
    return price.reshape(shape), stderr.reshape(shape)


def vg_mc_price(batch: ContractBatch, params: VGParams, generator: torch.Generator,
                n_paths: int = 200_000):
    """Exact terminal Monte Carlo by gamma subordination: G ~ Gamma(T/ν, ν),
    X = θG + σ√G·Z. Returns (price, stderr), float32."""
    shape, flat = _flat32(batch)
    dev = flat.spot.device
    p = _params32(params, dev)
    c = flat.spot.shape[0]
    t = flat.maturity[:, None]
    # torch has no gamma sampler that takes a generator: draw Gamma(k, 1) by
    # Marsaglia–Tsang from the generator's normals and uniforms
    g = p.nu * _gamma(generator, (t / p.nu).expand(c, n_paths))
    z = torch.randn((c, n_paths), generator=generator, device=dev)
    x = p.theta * g + p.sigma * torch.sqrt(g) * z
    omega = torch.real(_vg_log_cf_unnorm(_minus_i(t), p, t))
    return _mc_result(shape, flat, x, omega, n_paths)


def _gamma(generator: torch.Generator, shape_k: torch.Tensor) -> torch.Tensor:
    """Gamma(k, 1) draws for a tensor of shapes k > 0 (Marsaglia–Tsang 2000,
    with the k < 1 boost U^{1/k}). A fixed number of proposal rounds, each
    draw fixed at its first acceptance; a draw still unaccepted after the
    last round (chance below 1e-20) keeps its last proposal."""
    dev = shape_k.device
    k = shape_k.contiguous()
    boost = k < 1.0
    a = torch.where(boost, k + 1.0, k)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(k)
    done = torch.zeros_like(k, dtype=torch.bool)
    for _ in range(16):
        x = torch.randn(k.shape, generator=generator, device=dev)
        u = torch.rand(k.shape, generator=generator, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        out = torch.where(done, out, d * torch.clamp_min(v, 1e-30))
        done = done | ok
    u = torch.rand(k.shape, generator=generator, device=dev)
    return torch.where(boost, out * u ** (1.0 / k), out)


def nig_mc_price(batch: ContractBatch, params: NIGParams, generator: torch.Generator,
                 n_paths: int = 200_000):
    """Exact terminal Monte Carlo by inverse-Gaussian subordination: I_t ~
    IG(δt/γ₀, (δt)²) by Michael–Schucany–Haas, X = βI + √I·Z. Returns
    (price, stderr), float32."""
    shape, flat = _flat32(batch)
    dev = flat.spot.device
    p = _params32(params, dev)
    c = flat.spot.shape[0]
    t = flat.maturity[:, None]
    g0 = torch.sqrt(p.alpha**2 - p.beta**2)
    mu = p.delta * t / g0
    lam = (p.delta * t) ** 2
    nrm = torch.randn((c, n_paths), generator=generator, device=dev)
    y = nrm * nrm
    x1 = mu + mu * mu * y / (2.0 * lam) - (mu / (2.0 * lam)) * torch.sqrt(
        4.0 * mu * lam * y + (mu * y) ** 2)
    u = torch.rand((c, n_paths), generator=generator, device=dev)
    ig = torch.where(u <= mu / (mu + x1), x1, mu * mu / x1)
    z = torch.randn((c, n_paths), generator=generator, device=dev)
    x = p.beta * ig + torch.sqrt(ig) * z
    omega = torch.real(_nig_log_cf_unnorm(_minus_i(t), p, t))
    return _mc_result(shape, flat, x, omega, n_paths)
