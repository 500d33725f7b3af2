"""Counterparty exposure under HESTON stochastic volatility.

The port of ``optionslab_tpu/risk/exposure_heston.py``. The joint (S_t, v_t)
state is simulated by Andersen-QE date transitions (the transition law of
``models.heston_american``), and revaluation uses the HOMOGENEITY of the
Heston vanilla price — C(S, K, v, τ) = K · c(log(S/K), v, τ) — so one
Lewis-CF sweep over a (variance node, position, date, x node) grid of
normalized prices (one batched ``heston_price`` call in float64 on the
device) precomputes the marks, and every (path, date) mark is a bilinear
read. The CF work does not grow with the path count.

Random numbers: a generator seeded with ``seed`` on ``device`` draws each
substep's two normals and one uniform, in order (Bates jumps, if the
parameters carry them, from the jump stream of ``models.heston_american``).

Exact oracles: a LONG option's discounted EE equals its time-0 Lewis price
at every date; σ_v → 0, v0 = θ reproduces the GBM engine; the CVA of a long
option is (1-R) V0 (1 − e^{−λT}).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.heston import HestonParams, heston_price
from ..models.heston_american import _f32_params, _jump_generator, _simulate_dates
from ..types import ContractBatch
from ..utils.exceptions import ValidationError
from .exposure import ExposureResult, _generator, _positions, _profile, _result

__all__ = ["heston_exposure_profile"]


def _bilinear(table, x, v, x0, dx, v0_, dv):
    """Uniform-grid bilinear read, clamped to the edges: ``table`` (n_v,
    n_dates, n_x) at the (paths, n_dates) points (x, v), date j of the
    points reading slice j of the table."""
    n_v, n_d, n_x = table.shape
    fx = torch.clamp((x - x0) / dx, 0.0, n_x - 1.001)
    fv = torch.clamp((v - v0_) / dv, 0.0, n_v - 1.001)
    ix = fx.to(torch.int64)
    iv = fv.to(torch.int64)
    wx = fx - ix
    wv = fv - iv
    j = torch.arange(n_d, device=table.device)[None, :]
    t00 = table[iv, j, ix]
    t01 = table[iv, j, ix + 1]
    t10 = table[iv + 1, j, ix]
    t11 = table[iv + 1, j, ix + 1]
    return ((1 - wv) * ((1 - wx) * t00 + wx * t01)
            + wv * ((1 - wx) * t10 + wx * t11))


def _tables(opts, dates, rate, params, x_grid, v_grid, device):
    """(n_v, n_opt, n_dates, n_x) float32 normalized prices c(x, v; τ), the
    τ ≈ 0 slices replaced by the intrinsic value (the expiry-date mark)."""
    n_v, n_x = len(v_grid), len(x_grid)
    taus, cps = [], []
    for p in opts:
        for t in dates:
            taus.append(max(p.maturity - t, 1e-6))
            cps.append(1.0 if p.option_type == "call" else -1.0)
    taus = np.asarray(taus)  # (n_opt*n_dates,)
    cps = np.asarray(cps)
    m = len(taus) * n_x
    f64 = torch.float64
    batch = ContractBatch.make(
        spot=np.tile(np.exp(x_grid), n_v * len(taus)), strike=1.0,
        maturity=np.tile(np.repeat(taus, n_x), n_v), rate=rate, vol=0.2,
        option_type=np.tile(np.repeat(cps, n_x), n_v), dtype=f64, device=device)
    # the Heston CF cancels in float32 at small sigma_v (terms carry
    # 1/sigma^2): the table is built in float64, one node's v0 per row
    pv = HestonParams.make(v0=np.repeat(np.maximum(v_grid, 1e-6), m),
                           **{k: float(getattr(params, k)) for k in
                              ("kappa", "theta", "sigma", "rho")}, dtype=f64, device=device)
    tables = heston_price(batch, pv).reshape(n_v, len(opts), len(dates), n_x)
    intr = np.maximum(cps[:, None] * (np.exp(x_grid)[None, :] - 1.0), 0.0)
    intr = torch.as_tensor(intr.reshape(len(opts), len(dates), n_x), dtype=f64, device=device)
    tiny = torch.as_tensor((taus < 2e-6).reshape(len(opts), len(dates)), device=device)
    return torch.where(tiny[None, :, :, None], intr[None], tables).to(torch.float32)


def heston_exposure_profile(book, params: HestonParams, *, horizon: float | None = None,
                            n_dates: int = 16, n_sub: int = 4, n_paths: int = 32_768,
                            seed: int = 0, quantile: float = 0.95, netting: bool = True,
                            spot: float | None = None, rate: float | None = None,
                            n_x: int = 81, n_v: int = 24, x_half_width: float = 2.0,
                            device="cuda") -> ExposureResult:
    """EE/EPE/PFE/ENE profile of a single-underlying netting set under
    Heston dynamics, with smile-consistent CF revaluation, on ``device``.

    ``book``: list of :class:`~.portfolio.Position` / ``OptionsPortfolio``
    on ONE underlying (calls/puts/forwards; each position's ``vol`` field is
    ignored — the model prices the mark).
    """
    pos = _positions(book)
    if not pos:
        raise ValidationError("heston_exposure_profile needs a non-empty book")
    if len({p.underlying for p in pos}) > 1:
        raise ValidationError("Heston exposure supports one underlying "
                              "(one (S, v) state); split the netting set")
    if not 0.0 < quantile < 1.0:
        raise ValidationError(f"quantile must be in (0,1): {quantile}")
    params.validate()
    p0 = pos[0]
    spot = float(p0.spot if spot is None else spot)
    rate = float(p0.rate if rate is None else rate)
    horizon = float(horizon if horizon is not None else max(p.maturity for p in pos))
    if horizon <= 0:
        raise ValidationError("horizon must be positive")

    gen = _generator(seed, device)
    s_paths, v_paths = _simulate_dates(gen, _jump_generator(gen), spot,
                                       _f32_params(params, device), rate, horizon, n_dates,
                                       n_sub, n_paths)
    s_all = s_paths[1:].T  # (n_paths, n_dates); the profile excludes t=0
    v_all = v_paths[1:].T
    del s_paths, v_paths
    dates = np.linspace(horizon / n_dates, horizon, n_dates)

    # normalized-price tables c(x, v; τ) per (position, date), indexed by
    # u = sqrt(v): vanilla prices are near-linear in vol, so the
    # interpolation error drops an order of magnitude against a uniform-v
    # grid of the same node count
    x0, dx = -x_half_width, 2.0 * x_half_width / (n_x - 1)
    x_grid = np.linspace(-x_half_width, x_half_width, n_x)
    v_cap = 6.0 * max(float(params.theta), float(params.v0))
    u_cap = np.sqrt(v_cap)
    v_lo, dv = 0.0, u_cap / (n_v - 1)  # grid coords in u-space
    v_grid = np.linspace(0.0, u_cap, n_v) ** 2
    opts = [p for p in pos if p.option_type != "forward"]
    tables = _tables(opts, dates, rate, params, x_grid, v_grid, device) if opts else None

    dates_t = torch.as_tensor(dates, dtype=torch.float32, device=device)
    uq = torch.sqrt(torch.clamp_min(v_all, 0.0))
    marks, oi = [], 0
    for p in pos:
        alive = (p.maturity - dates_t[None, :]) > -1e-9
        if p.option_type == "forward":
            tau = torch.clamp_min(p.maturity - dates_t, 1e-8)[None, :]
            val = s_all - p.strike * torch.exp(-rate * tau)
        else:
            xq = torch.log(torch.clamp_min(s_all, 1e-12) / p.strike)
            val = _bilinear(tables[:, oi], xq, uq, x0, dx, v_lo, dv) * p.strike
            oi += 1
        marks.append(p.quantity * torch.where(alive, val, 0.0))
    vals = [sum(marks)] if netting else marks

    e_pos = sum(torch.clamp_min(v, 0.0) for v in vals)
    e_neg = sum(torch.clamp_min(-v, 0.0) for v in vals)
    return _result(dates, _profile(e_pos, e_neg, dates_t, rate, quantile), quantile, rate,
                   n_paths)
