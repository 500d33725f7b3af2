"""AMC exposure: EE/PFE/CVA profiles for PATH-DEPENDENT trades.

The port of ``optionslab_tpu/risk/exposure_amc.py``. A path-dependent
trade's value at an exposure date depends on the path's accumulated state,
so it is marked by American Monte Carlo: regress the trade's discounted
terminal cashflow on basis functions of the date's Markov state (S plus
the payoff's running statistic, plus the variance under stochastic vol and
the forward-Volterra mean under rough Bergomi) and use the fitted
conditional expectation as the mark. The regression is fit on a TRAINING
half of the paths and the exposure is measured on the other half, out of
sample, so the martingale oracle E[df_t V̂_t] = V_0 holds within stderr.

Device program: the fine path (the GBM and rough-Bergomi levels as
cumulative sums with no time loop; Heston/Bates QE and frozen-leverage SLV
as a host loop of small launches over the fine steps, where the reference
runs a ``lax.scan``), the running statistics (cumsum / cummax / cummin),
every date's ridge normal equations as one batched (dates, F, F)
``torch.linalg.solve``, and the marks on the valuation half. The products
run in full float32: TF32 must stay off (checked, as in ``models.rbergomi``).

Random numbers, drawn in this order from a generator seeded with ``seed``
on ``device``:
  - GBM: the (paths, fine steps) normals in one draw;
  - Heston/Bates: per fine step, the (2, paths) normals then the paths'
    uniforms; Bates jumps from the jump stream of ``models.heston_american``
    (a second generator seeded from the first's seed), per step the Poisson
    counts then the jump normals, so λ = 0 reproduces Heston bit for bit;
  - SLV: the leverage calibration first, on its own generator seeded with
    ``seed + 104_729``; then per fine step the (2, paths) normals;
  - rough Bergomi: the (paths, 2n) causal Volterra normals, then the
    (paths, n) orthogonal spot normals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.black_scholes import bs_price
from ..models.rbergomi import _check_precision, _matmul_t
from ..utils.exceptions import ValidationError
from .exposure import ExposureResult, _generator, _profile, _result

__all__ = ["ExoticPosition", "amc_exposure_profile", "amc_dynamics_kwargs", "AMC_KINDS"]

F32 = torch.float32


def amc_dynamics_kwargs(model: str, *, spot, rate, vol, heston_params=None, bates_params=None,
                        rbergomi_params=None, mixing=1.0, device="cuda") -> dict:
    """Map a model name to :func:`amc_exposure_profile` dynamics kwargs (the
    one place ``/xva`` reads them). The ``*_params`` are override DICTS
    (the ``/american`` route's conventions); ``vol`` seeds the SLV smile's
    base level. An override dict the chosen model cannot consume raises
    ``ValidationError`` rather than being dropped."""
    model = str(model).lower()
    consumes = {"bs": (), "heston": ("heston_params",), "bates": ("bates_params",),
                "slv": ("heston_params",), "rbergomi": ("rbergomi_params",)}
    if model not in consumes:
        raise ValidationError(f"unknown xva model {model!r}; choose "
                              "bs|heston|bates|slv|rbergomi")
    overrides = {"heston_params": heston_params, "bates_params": bates_params,
                 "rbergomi_params": rbergomi_params}
    stray = [k for k, v in overrides.items() if v and k not in consumes[model]]
    if stray:
        raise ValidationError(
            f"model={model!r} does not consume {', '.join(stray)}; it "
            f"accepts {list(consumes[model]) or 'no override dicts'}")
    if model != "slv" and float(mixing) != 1.0:
        raise ValidationError("mixing applies to model='slv' only")
    if model == "bs":
        return {}
    if model == "heston":
        from ..models.heston import HestonParams

        return {"heston_params": HestonParams.make(**(heston_params or {}), device=device)}
    if model == "bates":
        from ..models.bates import BatesParams

        return {"heston_params": BatesParams.make(**(bates_params or {}), device=device)}
    if model == "slv":
        from ..models.heston import HestonParams
        from ..models.local_vol import DupireLocalVol, sample_smile_iv_fn

        return {"dupire": DupireLocalVol(sample_smile_iv_fn(base_vol=vol), spot, rate,
                                         device=device),
                "heston_params": HestonParams.make(**(heston_params or {}), device=device),
                "mixing": float(mixing)}
    from ..models.rbergomi import RBergomiParams

    return {"rbergomi_params": RBergomiParams(**(rbergomi_params or {}))}


AMC_KINDS = ("vanilla", "asian_arith", "lookback_float", "lookback_fixed",
             "barrier_up-and-out", "barrier_up-and-in",
             "barrier_down-and-out", "barrier_down-and-in")


@dataclasses.dataclass(frozen=True)
class ExoticPosition:
    """One (possibly path-dependent) trade in an AMC netting set."""

    kind: str = "vanilla"
    quantity: float = 1.0
    strike: float = 100.0
    maturity: float = 1.0
    option_type: str = "call"
    barrier: float = 0.0
    vol: float = 0.2

    def validate(self):
        if self.kind not in AMC_KINDS:
            raise ValidationError(f"kind must be one of {AMC_KINDS}, got {self.kind!r}")
        if "barrier" in self.kind and self.barrier <= 0:
            raise ValidationError("barrier kinds need barrier > 0")
        if self.maturity <= 0 or self.vol <= 0:
            raise ValidationError("need maturity > 0 and vol > 0")


def _features(s, stat, spot, strike, cp, v=None, m=None):
    """Regression basis in the normalized Markov state (s, stat[, v[, m]]),
    plus the two INTRINSIC features max(cp(s−K),0) and max(cp(stat−K),0)
    (the payoff kink that polynomials smooth over). Under Heston-type
    dynamics the variance joins the state; under rough Bergomi the
    forward-Volterra conditional mean m = E[V~_next | F_t] too."""
    x = s / spot
    a = stat / spot
    k = strike / spot
    exs = torch.clamp_min(cp * (x - k), 0.0)
    exa = torch.clamp_min(cp * (a - k), 0.0)
    cols = [torch.ones_like(x), x, x * x, x * x * x, a, a * a, x * a, x * x * a, exs, exa]
    if v is not None:
        cols += [v, v * v, x * v, exs * v]
    if m is not None:
        cols += [m, m * m, x * m]
    return torch.stack(cols, dim=-1)


def _fine_loop(n_paths, n_fine, d_idx, device, step):
    """Run ``step(i, x, v) -> (x, v)`` over the fine grid from x = 0:
    (n_fine, paths) log-spots and the (n_dates, paths) variance at the date
    substeps ``d_idx`` (a list of step indices)."""
    x = torch.zeros(n_paths, dtype=F32, device=device)
    xs = torch.empty((n_fine, n_paths), dtype=F32, device=device)
    vs = torch.empty((len(d_idx), n_paths), dtype=F32, device=device)
    at = {i: j for j, i in enumerate(d_idx)}
    v = None
    for i in range(n_fine):
        x, v = step(i, x, v)
        xs[i] = x
        if i in at:
            vs[at[i]] = v
    return xs, vs


def _sim_fine_heston(gen, n_paths, n_fine, dt, d_idx, spot, rate, dividend, params):
    """(paths, n_fine) spots and (paths, n_dates) variances under
    Andersen-QE Heston, the transition law of the American brackets
    (``models.heston_american._qe_apply``). ``BatesParams`` add the exact
    compound-Poisson log-jump per substep with the martingale compensator
    in the drift."""
    from ..models.heston_american import (_f32_params, _jump_comp, _jump_consts,
                                          _jump_generator, _jumps, _qe_apply, _qe_consts,
                                          _uniform)

    dev = gen.device
    p32 = _f32_params(params, dev)
    dt_t = torch.tensor(dt, dtype=F32, device=dev)
    consts = _qe_consts(p32, dt_t)
    jc = _jump_consts(p32, dt_t)
    jgen = _jump_generator(gen)
    mu_dt = (torch.tensor(rate - dividend, dtype=F32, device=dev) - _jump_comp(p32)) * dt_t

    def step(i, x, v):
        if v is None:
            v = p32.v0.expand(n_paths).clone()
        z = torch.randn((2, n_paths), generator=gen, dtype=F32, device=dev)
        u = _uniform(gen, (n_paths,), F32)
        x, v = _qe_apply(x, v, z[0], z[1], u, consts, mu_dt)
        if jc is not None:
            n_j, zj = _jumps(jgen, jc[0], (n_paths,), F32)
            x = x + n_j * jc[1] + jc[2] * torch.sqrt(n_j) * zj
        return x, v

    xs, vd = _fine_loop(n_paths, n_fine, d_idx, dev, step)
    return (spot * torch.exp(xs)).T.contiguous(), vd.T.contiguous()


def _sim_fine_slv(gen, n_paths, n_fine, dt, d_idx, spot, rate, dividend, params, mixing,
                  x_rows, l_rows):
    """(paths, n_fine) spots and (paths, n_dates) variances under the
    FROZEN-LEVERAGE Euler-SLV law, one leverage row per fine substep
    (``models.slv_american._slv_apply``)."""
    from ..models.heston_american import _f32_params
    from ..models.slv_american import _dyn, _slv_apply

    dev = gen.device
    p32 = _f32_params(params, dev)
    dyn = _dyn(p32, mixing, rate, dividend, dt * n_fine, n_fine, 1)

    def step(i, x, v):
        if v is None:
            v = torch.full((n_paths,), float(params.v0), dtype=F32, device=dev)
        z = torch.randn((2, n_paths), generator=gen, dtype=F32, device=dev)
        return _slv_apply(x, v, z[0], z[1], dyn, x_rows[i], l_rows[i])

    xs, vd = _fine_loop(n_paths, n_fine, d_idx, dev, step)
    return (spot * torch.exp(xs)).T.contiguous(), vd.T.contiguous()


def _m_readout_dates(lc: np.ndarray, n_dates: int, n_sub: int):
    """(n_dates, 2n) host matrix M with m_d = M[d] @ e, the conditional mean
    E[V~ at the NEXT exposure date | F at date d] under the causal Volterra
    factorization: the American bracket's readout shifted by one date (its
    row 0 sits at t=0). The last date reads out zero (its mark is the
    settled payoff)."""
    from ..models.rbergomi_american import _m_readout_matrix

    return _m_readout_matrix(lc, n_dates, n_sub)[1:]


def _sim_fine_rbergomi(gen, n_paths, n_fine, dt, spot, rate, dividend, params, lc, mmat):
    """(paths, n_fine) spots and variances under the EXACT rough-Bergomi
    law (the joint Volterra/Brownian vector by the causal Cholesky factor),
    plus the (paths, n_dates) forward-Volterra feature m."""
    n = n_fine
    dev = gen.device
    t_fine = torch.arange(1, n + 1, dtype=F32, device=dev) * dt
    eta, rho, xi0 = (torch.tensor(float(x), dtype=F32, device=dev)
                     for x in (params.eta, params.rho, params.xi0))
    e = torch.randn((n_paths, 2 * n), generator=gen, dtype=F32, device=dev)
    zp = torch.randn((n_paths, n), generator=gen, dtype=F32, device=dev)
    g = _matmul_t(e, lc)
    v_tilde = g[:, 0::2]
    w_lvl = g[:, 1::2]
    dw = torch.diff(w_lvl, dim=1, prepend=w_lvl.new_zeros((n_paths, 1)))
    v_grid = xi0 * torch.exp(eta * v_tilde - 0.5 * eta * eta
                             * t_fine[None, :] ** (2.0 * float(params.hurst)))
    v_left = torch.cat([xi0.expand(n_paths, 1), v_grid[:, :-1]], dim=1)
    srho = torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0))
    dz = rho * dw + srho * torch.sqrt(torch.tensor(dt, dtype=F32, device=dev)) * zp
    x = torch.cumsum(torch.sqrt(v_left) * dz - 0.5 * v_left * dt, dim=1) \
        + (rate - dividend) * t_fine[None, :]
    return spot * torch.exp(x), v_grid, _matmul_t(e, mmat)


def _running_stat(s_fine, kind, cp):
    """(paths, steps) running statistic AFTER each substep; S0 excluded
    from averages (steps 1..n convention) but INCLUDED in extrema via the
    caller seeding the cummax/cummin with S0."""
    if kind == "asian_arith":
        cnt = torch.arange(1, s_fine.shape[1] + 1, dtype=s_fine.dtype, device=s_fine.device)
        return torch.cumsum(s_fine, dim=1) / cnt[None, :]
    if kind in ("lookback_float", "lookback_fixed"):
        lo = (cp > 0) == (kind == "lookback_float")
        return (torch.cummin if lo else torch.cummax)(s_fine, dim=1).values
    return s_fine  # vanilla / barrier: state is S itself


def _ridge_fit(phi_tr, y, wtr, ridge, half):
    """(dates, F) coefficients of the weighted ridge normal equations,
    one batched solve."""
    g = torch.einsum("pdf,pdg->dfg", phi_tr * wtr[..., None], phi_tr)
    b = torch.einsum("pdf,pd->df", phi_tr, y * wtr)
    g = g + ridge * half * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)[None]
    return torch.linalg.solve(g, b[..., None])[..., 0]


def amc_exposure_profile(book, *, spot: float = 100.0, rate: float = 0.05,
                         vol: float | None = None, dividend: float = 0.0,
                         horizon: float | None = None, n_dates: int = 24, n_sub: int = 8,
                         n_paths: int = 65536, seed: int = 0, quantile: float = 0.95,
                         ridge: float = 1e-6, heston_params=None, dupire=None,
                         mixing: float = 1.0, rbergomi_params=None,
                         device="cuda") -> ExposureResult:
    """EE/EPE/PFE/ENE profile of a netting set of path-dependent trades, on
    ``device``.

    ``book``: list of :class:`ExoticPosition` on ONE underlying. Dynamics:
    risk-neutral GBM at ``vol`` (default: the first position's vol); with
    ``heston_params``, Andersen-QE Heston (``HestonParams``) or Bates with
    exact compound-Poisson jumps (``BatesParams``); with ``dupire`` (+
    ``heston_params`` + ``mixing``), the frozen-leverage Euler-SLV law on
    leverage rows calibrated on the card; with ``rbergomi_params``, the
    exact rough-Bergomi law. Under a stochastic-vol law the regression
    state gains the variance (and, under rough Bergomi, m) and each
    position's ``vol`` is ignored. Barrier/extrema monitoring and Asian
    averaging run on the FINE grid (``n_dates * n_sub`` substeps over the
    horizon). Knocked-out trades mark to zero; knocked-in trades mark as the
    Black–Scholes vanilla after the hit under GBM and by a second regression
    under stochastic vol.
    """
    pos = list(book)
    if not pos:
        raise ValidationError("amc_exposure_profile needs a non-empty book")
    for p in pos:
        p.validate()
    if not 0.0 < quantile < 1.0:
        raise ValidationError(f"quantile must be in (0,1): {quantile}")
    if n_paths % 2:
        raise ValidationError("n_paths must be even (train/valuation split)")
    if rbergomi_params is not None and (heston_params is not None or dupire is not None):
        raise ValidationError("rbergomi_params is exclusive with heston_params/dupire")
    if dupire is not None and heston_params is None:
        raise ValidationError("SLV exposure needs heston_params alongside dupire")
    _check_precision()
    horizon = float(horizon if horizon is not None else max(p.maturity for p in pos))
    vol = float(vol if vol is not None else pos[0].vol)
    n_fine = n_dates * n_sub
    dt = horizon / n_fine
    # trade i's final monitoring substep (1-based index into the fine grid)
    m_idx = [max(1, min(n_fine, int(round(p.maturity / dt)))) for p in pos]
    d_host = list(range(n_sub - 1, n_fine, n_sub))  # date-grid substeps
    d_idx = torch.tensor(d_host, device=device)
    dates = (d_idx.to(F32) + 1.0) * dt
    half = n_paths // 2

    m_dates = v_dates = None
    if rbergomi_params is not None:
        rbergomi_params.validate()
        from ..models.rbergomi import _volterra_chol_causal

        lc_np = _volterra_chol_causal(n_fine, float(rbergomi_params.hurst), horizon)
        s_fine, v_fine, m_dates = _sim_fine_rbergomi(
            _generator(seed, device), n_paths, n_fine, dt, spot, rate, dividend,
            rbergomi_params, torch.as_tensor(lc_np, device=device),
            torch.as_tensor(_m_readout_dates(lc_np, n_dates, n_sub), device=device))
        v_dates = v_fine[:, d_idx]
        del v_fine
    elif dupire is not None:
        from ..models.slv import slv_calibrate_leverage

        surface = getattr(dupire, "surface", dupire)
        x_rows, l_rows = slv_calibrate_leverage(
            spot, horizon, rate, heston_params, _generator(seed + 104_729, device),
            surface.k_grid.to(device), surface.t_grid.to(device), surface.grid.to(device),
            dividend=dividend, mixing=mixing, n_paths=min(n_paths, 262_144), n_steps=n_fine)
        s_fine, v_dates = _sim_fine_slv(_generator(seed, device), n_paths, n_fine, dt, d_host,
                                        spot, rate, dividend, heston_params, mixing, x_rows,
                                        l_rows)
    elif heston_params is not None:
        s_fine, v_dates = _sim_fine_heston(_generator(seed, device), n_paths, n_fine, dt, d_host,
                                           spot, rate, dividend, heston_params)
    else:
        gen = _generator(seed, device)
        z = torch.randn((n_paths, n_fine), generator=gen, dtype=F32, device=device)
        w = torch.cumsum(z, dim=1) * np.float32(np.sqrt(dt))
        del z
        t_fine = torch.arange(1, n_fine + 1, dtype=F32, device=device) * dt
        s_fine = spot * torch.exp((rate - dividend - 0.5 * vol * vol) * t_fine[None, :]
                                  + vol * w)
        del w

    v_net = torch.zeros((half, n_dates), dtype=F32, device=device)
    for p, mi in zip(pos, m_idx):
        cp = 1.0 if str(p.option_type).lower().startswith("c") else -1.0
        t_mat = mi * dt
        s_trade = s_fine[:, :mi]
        stat = _running_stat(s_trade, p.kind, cp)
        if p.kind.startswith("lookback"):
            stat = (torch.clamp_max(stat, spot) if (cp > 0) == (p.kind == "lookback_float")
                    else torch.clamp_min(stat, spot))
        if "barrier" in p.kind:
            up = "up" in p.kind
            ext = (torch.cummax if up else torch.cummin)(s_trade, dim=1).values
            ext = torch.clamp_min(ext, spot) if up else torch.clamp_max(ext, spot)
            hit = ((ext >= p.barrier) if up else (ext <= p.barrier)).to(F32)
            del ext
        s_t = s_trade[:, -1]
        if p.kind == "asian_arith":
            pay = torch.clamp_min(cp * (stat[:, -1] - p.strike), 0.0)
        elif p.kind == "lookback_float":
            pay = cp * (s_t - stat[:, -1])
        elif p.kind == "lookback_fixed":
            pay = torch.clamp_min(cp * (stat[:, -1] - p.strike), 0.0)
        elif "barrier" in p.kind:
            van_pay = torch.clamp_min(cp * (s_t - p.strike), 0.0)
            pay = van_pay * (hit[:, -1] if p.kind.endswith("in") else (1.0 - hit[:, -1]))
        else:
            pay = torch.clamp_min(cp * (s_t - p.strike), 0.0)

        # marks on the date grid (paths, n_dates)
        d_trade = torch.clamp_max(d_idx, mi - 1)
        sd = s_fine[:, d_idx]
        statd = stat[:, d_trade]
        del stat
        tau = t_mat - dates  # (n_dates,)
        live = tau > 1e-9  # regression dates strictly before maturity
        # y: cashflow discounted from maturity back to each date
        disc = torch.exp(-rate * torch.clamp_min(tau, 0.0))[None, :]
        y = pay[:, None] * disc
        phi = _features(sd, statd, spot, p.strike, cp, v_dates, m_dates)
        del statd
        if "barrier" in p.kind:
            hd = hit[:, d_trade]
            del hit
            wgt = 1.0 - hd  # regress the not-knocked (out: surviving) paths
        else:
            wgt = torch.ones_like(sd)
        wtr = wgt[:half] * live[None, :]
        # per-date column scales (training-half RMS, floored): at high vol
        # the raw polynomial columns span orders of magnitude and the f32
        # Gram matrix goes singular; solve in the scaled space and keep the
        # SAME scales at evaluation (no centering: the intercept stays)
        n_w = torch.clamp_min(wtr.sum(dim=0), 1.0)  # (dates,)
        rms = torch.sqrt(torch.einsum("pdf,pd->df", phi[:half] ** 2, wtr) / n_w[:, None])
        rms = torch.clamp_min(rms, 1e-6)  # (dates, F)
        phi_tr = phi[:half] / rms[None, :, :]
        coef = _ridge_fit(phi_tr, y[:half], wtr, ridge, half)
        phi_v = phi[half:] / rms[None, :, :]
        del phi
        cont = torch.einsum("pdf,df->pd", phi_v, coef)
        if p.kind != "lookback_float":
            cont = torch.clamp_min(cont, 0.0)
        if "barrier" in p.kind:
            hv = hd[half:]
            if p.kind.endswith("out"):
                cont = (1.0 - hv) * cont
            elif v_dates is None:
                van = bs_price(sd[half:], p.strike, torch.clamp_min(tau, 1e-8)[None, :], rate,
                               p.vol, cp, dividend)
                cont = (1.0 - hv) * cont + hv * van
            else:
                # stochastic vol: no flat-vol shortcut — a SECOND
                # regression on the knocked-in paths marks the vanilla leg
                c_in = _ridge_fit(phi_tr, van_pay[:half, None] * disc, hd[:half] * live[None, :],
                                  ridge, half)
                van = torch.clamp_min(torch.einsum("pdf,df->pd", phi_v, c_in), 0.0)
                cont = (1.0 - hv) * cont + hv * van
        del phi_tr, phi_v
        # at/after maturity: the settled payoff is exposure THROUGH the
        # payoff date (the closed-form engine's convention), zero afterwards
        settled = dates <= t_mat + 0.5 * dt * n_sub
        v_trade = torch.where((~live)[None, :], torch.where(settled[None, :], y[half:], 0.0),
                              cont)
        v_net = v_net + p.quantity * v_trade

    e_pos = torch.clamp_min(v_net, 0.0)
    e_neg = torch.clamp_min(-v_net, 0.0)
    return _result(dates, _profile(e_pos, e_neg, dates, rate, quantile), quantile, rate, half)
