"""Certified [lower, upper] bracket for American puts under stochastic local
vol.

The port of ``optionslab_tpu/models/slv_american.py``: the Heston bracket's
construction (``models/heston_american.py``) on the SLV transition law. The
particle-calibrated leverage rows (``models/slv.slv_calibrate_leverage``,
one row per Monte Carlo substep) are computed once and frozen, so every
pipeline (policy fit, lower bound, dual, inner conditional means) samples
the same full-truncation Euler + leverage law. ``method="adi"`` (the
default) drives the policy, the dual and the lower bound's control variate
with the SLV Bermudan-ADI slices (``models/heston_fdm._slv_adi_bermudan``);
``method="lsm"`` with regression surfaces.

The bracket runs on its surface's device. Random numbers: the calibration
draws from a generator seeded ``seed``, the pipelines from one seeded
``seed + 1``, in turn (the reference's ``PRNGKey(seed)`` and
``PRNGKey(seed + 1)`` split in three).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.exceptions import ValidationError
from .american import _mean_se
from .heston import HestonParams
from .heston_american import (AdiSlices, _exercise_now, _f32_params, _fit_lsm_from_paths,
                              _surface_value)
from .heston_fdm import _slv_adi_bermudan
from .local_vol import LocalVolSurface
from .slv import _interp, slv_calibrate_leverage

__all__ = ["LeverageRows", "slv_american_bracket", "fit_slv_lsm"]


class LeverageRows(NamedTuple):
    """Frozen leverage rows, one per Monte Carlo substep: ``x_rows`` (relative
    log-spot nodes) and ``l_rows`` (leverage), each (n_steps, n_bins)."""

    x_rows: torch.Tensor
    l_rows: torch.Tensor

    @classmethod
    def from_numpy(cls, x_rows, l_rows, device=None) -> "LeverageRows":
        """Rows calibrated by the JAX package (numpy arrays), float32."""
        return cls(*(torch.as_tensor(np.array(a, np.float32), device=device)
                     for a in (x_rows, l_rows)))


def _dyn(params, mixing, rate, dividend, maturity, n_dates, n_sub):
    dev = params.kappa.device
    a = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    dt = a(maturity) / (n_dates * n_sub)
    rho = a(params.rho)
    return (a(params.kappa), a(params.theta), a(mixing) * a(params.sigma), rho,
            torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0)), (a(rate) - a(dividend)) * dt, dt,
            torch.sqrt(dt))


def _slv_apply(x, v, zv, zo, dyn, x_row, l_row):
    """One full-truncation Euler substep of (x = log(S/S0), v) under the
    frozen leverage row: the single transition law of every pipeline."""
    kap, th, sig, rho, srho, mu_dt, dt, sqdt = dyn
    vp = torch.clamp_min(v, 0.0)
    sq = torch.sqrt(vp)
    lev = _interp(x, x_row, l_row)
    sigx = lev * sq
    zx = rho * zv + srho * zo
    x_new = x + mu_dt - 0.5 * sigx * sigx * dt + sigx * sqdt * zx
    v_new = v + kap * (th - vp) * dt + sig * sq * sqdt * zv
    return x_new, v_new


def _simulate_dates(gen, spot, params, mixing, rate, dividend, maturity, x_rows, l_rows,
                    n_dates, n_sub, n_paths):
    """Antithetic (S, v) at every exercise date: (n_dates+1, 2·(n_paths//2))."""
    dev = gen.device
    dyn = _dyn(params, mixing, rate, dividend, maturity, n_dates, n_sub)
    half = n_paths // 2
    x = torch.zeros(2 * half, dtype=torch.float32, device=dev)
    v = torch.full((2 * half,), float(params.v0), dtype=torch.float32, device=dev)
    xs, vs = [x], [v]
    for d in range(1, n_dates + 1):
        xa, xb, va, vb = x[:half], x[half:], v[:half], v[half:]
        for j in range(n_sub):
            i = (d - 1) * n_sub + j
            z = torch.randn((2, half), generator=gen, dtype=torch.float32, device=dev)
            xa, va = _slv_apply(xa, va, z[0], z[1], dyn, x_rows[i], l_rows[i])
            xb, vb = _slv_apply(xb, vb, -z[0], -z[1], dyn, x_rows[i], l_rows[i])
        x, v = torch.cat([xa, xb]), torch.cat([va, vb])
        xs.append(x)
        vs.append(v)
    return spot * torch.exp(torch.stack(xs)), torch.stack(vs)


def fit_slv_lsm(spot, strike, maturity, rate, params: HestonParams, generator: torch.Generator,
                x_rows, l_rows, cp: float = -1.0, mixing: float = 1.0, dividend: float = 0.0,
                n_dates: int = 25, n_sub: int = 4, n_paths: int = 100_000):
    """LSM policy and value-surface regressions on SLV paths drawn on the
    generator's device: ``LSMCoefs(policy, surface)``."""
    if cp > 0:
        raise ValidationError("bracket supports puts (cp=-1) only")
    s_paths, v_paths = _simulate_dates(
        generator, float(spot), _f32_params(params, generator.device), mixing, float(rate),
        float(dividend), float(maturity), x_rows, l_rows, n_dates, n_sub, n_paths)
    return _fit_lsm_from_paths(s_paths, v_paths, strike, maturity, rate, cp, n_dates)


def _lower_pipeline(coefs, gen, spot, strike, maturity, rate, dividend, params, mixing, x_rows,
                    l_rows, cp, n_dates, n_sub, n_paths):
    s_paths, v_paths = _simulate_dates(gen, spot, params, mixing, rate, dividend, maturity,
                                       x_rows, l_rows, n_dates, n_sub, n_paths)
    dt = maturity / n_dates
    alive = torch.ones(s_paths.shape[1], dtype=torch.bool, device=gen.device)
    cash = torch.zeros(s_paths.shape[1], dtype=torch.float32, device=gen.device)
    for d in range(1, n_dates + 1):
        ex, take = _exercise_now(coefs, d, s_paths[d], v_paths[d], strike, cp, n_dates, "poly")
        cash = torch.where(alive & take, math.exp(-rate * dt * d) * ex, cash)
        alive = alive & ~take
    return _mean_se(cash)


def _upper_pipeline(coefs, gen, spot, strike, maturity, rate, dividend, params, mixing, x_rows,
                    l_rows, cp, n_dates, n_sub, n_outer, n_inner, kind="poly",
                    with_lower=False):
    """The value-surface dual upper bound on the frozen-leverage law (see
    ``heston_american._upper_pipeline``), with the martingale-controlled
    lower bound on the same outer paths when ``with_lower``."""
    dev = gen.device
    dt = maturity / n_dates
    dyn = _dyn(params, mixing, rate, dividend, maturity, n_dates, n_sub)
    s_out, v_out = _simulate_dates(gen, spot, params, mixing, rate, dividend, maturity, x_rows,
                                   l_rows, n_dates, n_sub, n_outer)
    n_outer = s_out.shape[1]
    half = n_inner // 2

    def date_step_anti(x, v, k):
        xa, xb, va, vb = x, x, v, v
        for j in range(n_sub):
            i = (k - 1) * n_sub + j
            z = torch.randn((2, n_outer, half), generator=gen, dtype=torch.float32, device=dev)
            xa, va = _slv_apply(xa, va, z[0], z[1], dyn, x_rows[i], l_rows[i])
            xb, vb = _slv_apply(xb, vb, -z[0], -z[1], dyn, x_rows[i], l_rows[i])
        return torch.cat([xa, xb], dim=1), torch.cat([va, vb], dim=1)

    m_k = torch.zeros(n_outer, dtype=torch.float32, device=dev)
    best = torch.full((n_outer,), max(cp * (spot - strike), 0.0), dtype=torch.float32,
                      device=dev)
    alive = torch.ones(n_outer, dtype=torch.bool, device=dev)
    low = torch.zeros(n_outer, dtype=torch.float32, device=dev)
    for k in range(1, n_dates + 1):
        dfk = math.exp(-rate * dt * k)
        vk = dfk * _surface_value(coefs, k, s_out[k], v_out[k], strike, cp, n_dates, kind)
        x_prev = torch.log(s_out[k - 1] / spot)[:, None].expand(n_outer, half).contiguous()
        v_prev = v_out[k - 1][:, None].expand(n_outer, half)
        x_tr, v_tr = date_step_anti(x_prev, v_prev, k)
        v_in = _surface_value(coefs, k, spot * torch.exp(x_tr), v_tr, strike, cp, n_dates, kind)
        m_k = m_k + vk - dfk * v_in.mean(dim=1)
        cand = dfk * torch.clamp_min(cp * (s_out[k] - strike), 0.0) - m_k
        best = torch.maximum(best, cand)
        if with_lower:
            _, take = _exercise_now(coefs, k, s_out[k], v_out[k], strike, cp, n_dates, kind)
            low = torch.where(alive & take, cand, low)
            alive = alive & ~take
    up = _mean_se(best)
    if not with_lower:
        return up
    return up + _mean_se(torch.where(alive, -m_k, low))


def slv_american_bracket(dupire, params: HestonParams, strike, maturity, cp: float = -1.0,
                         mixing: float = 1.0, n_dates: int = 25, n_sub: int = 4,
                         n_fit: int = 100_000, n_lower: int = 200_000, n_outer: int = 512,
                         n_inner: int = 2048, n_cal_paths: int = 131_072, n_bins: int = 31,
                         seed: int = 0, method: str = "adi", n_x: int = 161, n_v: int = 81,
                         steps_per_date: int = 8) -> dict:
    """Certified Bermudan bracket under stochastic local vol plus the
    continuous-exercise pad, on the device of ``dupire``'s surface (a
    :class:`~.local_vol.DupireLocalVol` or a bare
    :class:`~.local_vol.LocalVolSurface`; ``params`` are moved there).

    Returns {lower, lower_se, upper, upper_se, width, pad, continuous_upper,
    n_dates, mixing, method} (+ ``adi_bermudan`` for ``method="adi"``) as
    Python numbers: the frozen-leverage Euler-Bermudan value lies in
    [lower, upper] up to the quoted stderrs.
    """
    if cp > 0:
        raise ValidationError("bracket supports puts (cp=-1) only — an American call pays no "
                              "early-exercise premium without dividends")
    sf = dupire if isinstance(dupire, LocalVolSurface) else dupire.surface
    if method not in ("lsm", "adi"):
        raise ValidationError(f"method must be 'lsm' or 'adi', got {method!r}")
    dev = sf.device
    par32 = _f32_params(params, dev)
    # one leverage row per Monte Carlo substep: every pipeline replays the
    # identical frozen-leverage law (the duality's prerequisite)
    cal_gen = torch.Generator(device=dev).manual_seed(int(seed))
    x_rows, l_rows = slv_calibrate_leverage(
        sf.spot, float(maturity), sf.rate, par32, cal_gen, sf.k_grid, sf.t_grid, sf.grid,
        dividend=sf.dividend, mixing=mixing, n_paths=n_cal_paths, n_steps=n_dates * n_sub,
        n_bins=n_bins)
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    args = (float(sf.spot), float(strike), float(maturity), float(sf.rate), float(sf.dividend),
            par32, float(mixing), x_rows, l_rows, float(cp), n_dates, n_sub)
    extra = {}
    if method == "adi":
        price0, *surf = _slv_adi_bermudan(
            float(sf.spot), float(strike), float(maturity), float(sf.rate), float(sf.dividend),
            float(cp), par32, float(mixing), x_rows, l_rows, n_x, n_v, n_dates, steps_per_date,
            dev)
        extra["adi_bermudan"] = float(price0)
        up, up_se, lo, lo_se = (float(a) for a in _upper_pipeline(
            AdiSlices(*surf), gen, *args, n_outer, n_inner, kind="grid", with_lower=True))
    else:
        pol, sur = fit_slv_lsm(sf.spot, strike, maturity, sf.rate, par32, gen, x_rows, l_rows,
                               cp=cp, mixing=mixing, dividend=sf.dividend, n_dates=n_dates,
                               n_sub=n_sub, n_paths=n_fit)
        lo, lo_se = (float(a) for a in _lower_pipeline(pol, gen, *args, n_lower))
        up, up_se = (float(a) for a in _upper_pipeline(sur, gen, *args, n_outer, n_inner))
    pad = max(float(strike) * (1.0 - math.exp(-float(sf.rate) * float(maturity) / n_dates)), 0.0)
    return {"lower": lo, "lower_se": lo_se, "upper": up, "upper_se": up_se, "width": up - lo,
            "pad": pad, "continuous_upper": up + pad, "n_dates": n_dates,
            "mixing": float(mixing), "method": method, **extra}
