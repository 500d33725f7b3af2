"""Certified [lower, upper] bracket for American puts under Dupire local vol.

The port of ``optionslab_tpu/models/local_vol_american.py``.

* :func:`lv_bermudan_slices` — a Bermudan implicit solve through σ(S, t)
  (one launch of ``csrc/lv_pde.cu`` on the card, ``ops/lv_pde.py``),
  projecting on the exercise value only at the ``n_dates`` exercise dates
  and recording the continuation slice at each.
* Those slices drive the exercise policy, the dual martingale's value
  surface and the martingale control variate of the lower bound
  (:func:`_lv_dual_pipeline`): the martingale's increments are the surface
  at the realised state minus an inner one-date estimate of its
  conditional expectation, unbiased, so both bounds stay valid.
* The Monte Carlo dynamics are log-Euler with ``n_sub`` substeps per date
  under the same σ(S, t) lookup as the PDE, antithetic normals from one
  ``torch.Generator`` on the device.
* The continuous-exercise pad is K·(1 − e^{−rT/n}).
"""

from __future__ import annotations

import math

import torch

from ..ops.lv_pde import BERMUDAN, lv_loop
from ..utils.exceptions import ValidationError
from .local_vol import DupireLocalVol, _lv_tables, _sigma_at

__all__ = ["local_vol_american_bracket", "lv_bermudan_slices"]


def lv_bermudan_slices(k_grid, t_grid, vol_grid, spot, rate, dividend, strike, maturity, cp,
                       n_dates: int, steps_per_date: int = 8, n_space: int = 401):
    """Bermudan implicit solve through σ(S, t) on the surface's device,
    float32: one :func:`lv_loop` on the step tables of ``_lv_tables`` (the
    put's low end floored at intrinsic). Returns ``(price0, cont_all, x)``:
    ``cont_all`` is (n_dates + 1, n_space) continuation values by forward
    date index (entry 0 unused, entry n_dates zero), ``x`` the uniform
    log-spot nodes (spot mid-grid)."""
    x, intrinsic, lo, di, up, ends = _lv_tables(k_grid, t_grid, vol_grid, spot, rate, dividend,
                                                strike, maturity, cp, n_space,
                                                n_dates * steps_per_date, True)
    v, conts = lv_loop(lo[None], di[None], up[None], ends[None], intrinsic[None],
                       intrinsic[None], BERMUDAN, steps_per_date)
    zero = torch.zeros((1, n_space), dtype=torch.float32, device=x.device)
    cont_all = torch.cat([zero, conts[0].flip(0), zero])
    return v[0, n_space // 2], cont_all, x


def _interp1(sl, x0, dx, n_x, s):
    """Linear read of a 1-D slice at log-spot; clamps at the edges."""
    f = torch.clamp((torch.log(torch.clamp_min(s, 1e-12)) - x0) / dx, 0.0, n_x - 1.001)
    i = torch.floor(f).to(torch.int64)
    t = f - i
    return (1.0 - t) * sl[i] + t * sl[i + 1]


def _cont_at(surf, d, s, strike):
    cont_all, x0, dx = surf
    return torch.clamp(_interp1(cont_all[d], x0, dx, cont_all.shape[1], s), 0.0, strike)


def _substep_times(n: int, dt: float, device) -> torch.Tensor:
    """The substeps' start times i·dt as one device tensor: indexing it
    gives each step its time without a host-to-device copy."""
    return torch.arange(n, dtype=torch.float32, device=device) * dt


def _lv_simulate_dates(generator, k_grid, t_grid, vol_grid, spot, rate, dividend, maturity,
                       n_dates: int, n_sub: int, n_paths: int):
    """Antithetic log-Euler spots at every exercise date: (n_dates + 1, n)."""
    dev = generator.device
    dt = maturity / (n_dates * n_sub)
    sqdt = math.sqrt(dt)
    sig_of = _sigma_at(k_grid, t_grid, vol_grid, spot, rate, dividend)
    half = n_paths // 2
    times = _substep_times(n_dates * n_sub, dt, dev)
    ls = torch.zeros(2 * half, dtype=torch.float32, device=dev)
    rows = [ls]
    for i in range(n_dates * n_sub):
        sig = sig_of(spot * torch.exp(ls), times[i])
        z = torch.randn(half, generator=generator, device=dev)
        ls = ls + (rate - dividend - 0.5 * sig * sig) * dt + sig * sqdt * torch.cat([z, -z])
        if (i + 1) % n_sub == 0:
            rows.append(ls)
    return spot * torch.exp(torch.stack(rows))


def _lv_dual_pipeline(surf, generator, k_grid, t_grid, vol_grid, spot, strike, maturity, rate,
                      dividend, cp, n_dates: int, n_sub: int, n_outer: int, n_inner: int):
    """The joint dual upper bound and martingale-controlled lower bound:
    (upper, upper_se, lower, lower_se) as 0-d tensors."""
    dev = generator.device
    dt = maturity / n_dates
    dts = maturity / (n_dates * n_sub)
    sqdts = math.sqrt(dts)
    sig_of = _sigma_at(k_grid, t_grid, vol_grid, spot, rate, dividend)
    s_out = _lv_simulate_dates(generator, k_grid, t_grid, vol_grid, spot, rate, dividend,
                               maturity, n_dates, n_sub, n_outer)
    half = n_inner // 2
    drift = rate - dividend
    times = _substep_times(n_dates * n_sub, dts, dev)

    def surface_value(d, s):
        ex = torch.clamp_min(cp * (s - strike), 0.0)
        return torch.maximum(ex, _cont_at(surf, d, s, strike))

    def date_step_anti(ls, k):
        """One date's transition of (n_outer, half) log-spots, each draw
        with its antithetic partner → (n_outer, 2·half)."""
        la, lb = ls, ls
        for j in range(n_sub):
            t_now = times[(k - 1) * n_sub + j]
            z = torch.randn(ls.shape, generator=generator, device=dev)
            sa = sig_of(spot * torch.exp(la), t_now)
            sb = sig_of(spot * torch.exp(lb), t_now)
            la = la + (drift - 0.5 * sa * sa) * dts + sa * sqdts * z
            lb = lb + (drift - 0.5 * sb * sb) * dts - sb * sqdts * z
        return torch.cat([la, lb], dim=1)

    h0 = max(cp * (spot - strike), 0.0)
    m_k = torch.zeros(s_out.shape[1], dtype=torch.float32, device=dev)
    best = torch.full_like(m_k, h0)
    alive = torch.ones_like(m_k, dtype=torch.bool)
    low = torch.zeros_like(m_k)
    for k in range(1, n_dates + 1):
        dfk = math.exp(-rate * dt * k)
        vk = dfk * surface_value(k, s_out[k])
        l_prev = torch.log(s_out[k - 1] / spot)[:, None].expand(-1, half)
        l_tr = date_step_anti(l_prev, k)
        t2 = dfk * surface_value(k, spot * torch.exp(l_tr)).mean(dim=1)
        m_k = m_k + vk - t2
        ex_k = torch.clamp_min(cp * (s_out[k] - strike), 0.0)
        cand = dfk * ex_k - m_k
        best = torch.maximum(best, cand)
        take = ex_k > 0.0
        if k < n_dates:
            take = take & (ex_k > _cont_at(surf, k, s_out[k], strike))
        low = torch.where(alive & take, cand, low)
        alive = alive & ~take
    low = torch.where(alive, -m_k, low)
    rt = math.sqrt(n_outer)
    return (best.mean(), best.std(correction=1) / rt, low.mean(), low.std(correction=1) / rt)


def local_vol_american_bracket(dupire: DupireLocalVol, strike, maturity, cp: float = -1.0,
                               n_dates: int = 25, n_sub: int = 8, n_outer: int = 4096,
                               n_inner: int = 1024, n_space: int = 401, steps_per_date: int = 8,
                               seed: int = 0, device="cuda") -> dict:
    """Certified Bermudan bracket under the Dupire surface (its grids moved
    to ``device``), plus the continuous-exercise pad.

    Returns {lower, lower_se, upper, upper_se, width, pad, continuous_upper,
    lv_bermudan, n_dates} as Python numbers: the Euler-Bermudan value on the
    date grid lies in [lower, upper] up to the quoted stderrs;
    ``lv_bermudan`` is the PDE's own answer (a diagnostic);
    ``continuous_upper`` = upper + K·(1 − e^{−rT/n}).
    """
    if cp > 0:
        raise ValidationError("bracket supports puts (cp=-1) only — an American call pays no "
                              "early-exercise premium without dividends")
    sf = dupire.surface.to(device)
    grids = (sf.k_grid, sf.t_grid, sf.grid)
    strike, maturity, cp = float(strike), float(maturity), float(cp)
    price0, cont_all, x = lv_bermudan_slices(*grids, dupire.spot, dupire.rate, dupire.dividend,
                                             strike, maturity, cp, n_dates, steps_per_date,
                                             n_space)
    surf = (cont_all, x[0], x[1] - x[0])
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    up, up_se, lo, lo_se = (float(a) for a in _lv_dual_pipeline(
        surf, gen, *grids, dupire.spot, strike, maturity, dupire.rate, dupire.dividend, cp,
        n_dates, n_sub, n_outer, n_inner))
    pad = max(strike * (1.0 - math.exp(-dupire.rate * maturity / n_dates)), 0.0)
    return {"lower": lo, "lower_se": lo_se, "upper": up, "upper_se": up_se, "width": up - lo,
            "pad": pad, "continuous_upper": up + pad, "lv_bermudan": float(price0),
            "n_dates": n_dates}
