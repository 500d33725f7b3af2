"""Counterparty exposure profiles and CVA/DVA/FVA on simulated paths.

The port of ``optionslab_tpu/risk/exposure.py``. The profile is one device
program: exact GBM risk-factor levels on the date grid (the cumulative sum
of the normals: S_t is an exact function of them, no time loop), every
position revalued in closed form at every (path, date) by broadcasting
``bs_price`` over a (paths, dates) grid, and quantiles on the device for
the PFE. The only Python loop is over the netting set's instruments, each
one broadcast valuation.

Conventions:
  - EE(t)   = E[(V_t - C_t)^+]                  (undiscounted)
  - EE*(t)  = E[df(0,t) (V_t - C_t)^+]          (discounted)
  - EPE     = time-average of EE(t) on the grid
  - PFE_q(t)= q-quantile of (V_t - C_t)^+
  - ENE(t)  = E[(-(V_t - C_t))^+]               (our exposure to them)
  - CVA     = (1-R) sum_j 1/2 (EE*_{j-1} + EE*_j) (SP(t_{j-1}) - SP(t_j))
    with survival SP(t) = exp(-lambda t) (flat hazard), trapezoid in EE*.
  - Collateral: received C_t = (V_{t-MPoR} - threshold)^+ — a margin
    period of risk lags the mark the collateral tracks.

Random numbers: one ``torch.Generator`` seeded with ``seed`` on ``device``
per call, drawing the (paths, dates, factors) normals in one call, so two
calls with one seed and one factor count share their paths (common random
numbers). Paths run in float32; the credit legs (:func:`cva_dva`) are
float64 numpy on the host, as in the reference, so one profile fed to both
packages gives the same CVA, DVA and FVA.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.black_scholes import bs_price
from ..utils.exceptions import ValidationError
from .portfolio import OptionsPortfolio, Position
from .var import quantiles

__all__ = ["ExposureResult", "exposure_profile", "cva_dva", "cva_allocation", "cva_greeks",
           "cva_wwr", "xva_report"]

F32 = torch.float32


@dataclasses.dataclass
class ExposureResult:
    dates: np.ndarray          # (m,) years, t=0 excluded
    ee: np.ndarray             # (m,) expected exposure
    ee_discounted: np.ndarray  # (m,)
    ene: np.ndarray            # (m,) expected negative exposure
    ene_discounted: np.ndarray
    pfe: np.ndarray            # (m,) q-quantile exposure
    quantile: float
    epe: float                 # time-averaged EE
    max_pfe: float
    rate: float
    n_paths: int
    # the port's error bars (not in the JAX package's result): the standard
    # error of EE, and of the PFE from the order statistics at
    # q ± sqrt(q(1-q)/n) (a distribution-free one-sigma band)
    ee_stderr: np.ndarray | None = None
    pfe_stderr: np.ndarray | None = None

    @classmethod
    def from_numpy(cls, fields) -> "ExposureResult":
        """A profile from numpy arrays and numbers keyed by field name:
        ``{f.name: getattr(jax_result, f.name) for f in
        dataclasses.fields(jax_result)}`` carries the JAX package's profile
        across (without error bars, which it does not have)."""
        arrays = ("dates", "ee", "ee_discounted", "ene", "ene_discounted", "pfe")

        def value(name):
            x = fields[name]
            return np.array(x) if name in arrays else int(x) if name == "n_paths" else float(x)

        return cls(**{f.name: value(f.name) for f in dataclasses.fields(cls)
                      if f.name not in ("ee_stderr", "pfe_stderr")})

    @property
    def effective_ee(self) -> np.ndarray:
        """Basel effective EE: the running maximum of EE(t)."""
        return np.maximum.accumulate(self.ee)

    @property
    def eepe(self) -> float:
        """Effective EPE: time-average of effective EE over the first year
        of the profile (or the whole profile if shorter)."""
        m = self.dates <= 1.0 + 1e-9
        eff = self.effective_ee
        return float(np.mean(eff[m] if m.any() else eff))

    def to_dict(self) -> dict:
        return {
            "dates": [float(t) for t in self.dates],
            "ee": [float(x) for x in self.ee],
            "ee_discounted": [float(x) for x in self.ee_discounted],
            "ene": [float(x) for x in self.ene],
            "pfe": [float(x) for x in self.pfe],
            "quantile": self.quantile,
            "epe": self.epe,
            "effective_ee": [float(x) for x in self.effective_ee],
            "eepe": self.eepe,
            "max_pfe": self.max_pfe,
            "n_paths": self.n_paths,
        }


def _positions(book) -> list[Position]:
    if isinstance(book, OptionsPortfolio):
        return book.positions
    return list(book)


def _value_grid(s_grid, t_grid, pos: Position, rate, dividend, vol_shift=0.0):
    """Mark-to-market of one position on the (paths, dates) grid.
    ``vol_shift`` moves the MARKING vol together with the dynamics vol (CVA
    vega is a parallel shift of both)."""
    tau = torch.clamp_min(pos.maturity - t_grid, 1e-8)
    # a deal stays in the netting set THROUGH its payoff date (the payoff is
    # exposure until it settles); it drops only after maturity
    alive = (pos.maturity - t_grid) > -1e-9
    if pos.option_type == "forward":
        v = s_grid * torch.exp(-dividend * tau) - pos.strike * torch.exp(-rate * tau)
    else:
        cp = 1.0 if pos.option_type == "call" else -1.0
        v = bs_price(s_grid, pos.strike, tau, rate, pos.vol + vol_shift, cp, dividend)
    return pos.quantity * torch.where(alive, v, 0.0)


def _book_setup(pos, spot, rate, vol, corr, horizon):
    """Shared netting-set setup: one risk factor per distinct underlying
    (first-appearance order), spot/vol per factor, correlation Cholesky."""
    p0 = pos[0]
    rate = float(p0.rate if rate is None else rate)
    horizon = float(horizon if horizon is not None else max(p.maturity for p in pos))
    if horizon <= 0:
        raise ValidationError("horizon must be positive")
    unds: list[str] = []
    for p in pos:
        if p.underlying not in unds:
            unds.append(p.underlying)
    m = len(unds)
    u_idx = {u: i for i, u in enumerate(unds)}
    first = {p.underlying: p for p in reversed(pos)}
    spots = np.array([float(spot if spot is not None and m == 1 else first[u].spot)
                      for u in unds], np.float32)
    vols = np.array([float(vol if vol is not None and m == 1 else first[u].vol)
                     for u in unds], np.float32)
    if corr is None:
        chol = np.eye(m, dtype=np.float32)
    else:
        c = np.asarray(corr, np.float64)
        if c.shape != (m, m):
            raise ValidationError(f"corr must be ({m}, {m}) for underlyings {unds}, got "
                                  f"{c.shape}")
        try:
            chol = np.linalg.cholesky(c).astype(np.float32)
        except np.linalg.LinAlgError as e:
            raise ValidationError("corr must be positive definite") from e
    return rate, horizon, u_idx, spots, vols, chol


def _date_grid(horizon: float, n_dates: int, device) -> torch.Tensor:
    return torch.linspace(horizon / n_dates, horizon, n_dates, dtype=F32, device=device)


def _brownian(gen: torch.Generator, n_paths: int, dates: torch.Tensor, chol) -> torch.Tensor:
    """(paths, dates, factors) correlated Brownian levels on the date grid.
    The factor mixing is summed elementwise over the few factors (no
    matmul, so no TF32)."""
    m = chol.shape[0]
    z = torch.randn((n_paths, dates.shape[0], m), generator=gen, dtype=F32, device=dates.device)
    if m > 1:
        c = torch.as_tensor(chol, device=dates.device)
        z = torch.stack([sum(z[..., j] * c[k, j] for j in range(k + 1)) for k in range(m)], -1)
    dt = torch.diff(dates, prepend=dates.new_zeros(1))
    return torch.cumsum(z * torch.sqrt(dt)[None, :, None], dim=1)


def _levels(w, dates, spots, vols, rate, dividend):
    """Exact GBM levels from the Brownian levels ``w``; ``spots``, ``vols``
    and ``rate`` may be tensors carrying a graph."""
    vg = vols[None, None, :]
    return spots[None, None, :] * torch.exp((rate - dividend - 0.5 * vg * vg)
                                            * dates[None, :, None] + vg * w)


def _sim_spots(gen, n_paths, dates, spots, vols, chol, rate, dividend):
    """(paths, dates, factors) exact GBM levels on the date grid."""
    dev = dates.device
    return _levels(_brownian(gen, n_paths, dates, chol), dates,
                   torch.as_tensor(spots, device=dev), torch.as_tensor(vols, device=dev),
                   rate, dividend)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _profile(e_pos, e_neg, dates, rate, q):
    """(EE, EE*, ENE, ENE*, PFE, EE stderr, PFE stderr) on the host from the
    (paths, dates) exposures."""
    n = e_pos.shape[0]
    df = torch.exp(-rate * dates)[None, :]
    band = math.sqrt(q * (1.0 - q) / n)
    pfe, lo, hi = quantiles(e_pos, (q, max(q - band, 0.0), min(q + band, 1.0)), dim=0)
    outs = (e_pos.mean(dim=0), (df * e_pos).mean(dim=0), e_neg.mean(dim=0),
            (df * e_neg).mean(dim=0), pfe, e_pos.std(dim=0) / math.sqrt(n), 0.5 * (hi - lo))
    return [x.cpu().numpy() for x in outs]


def _result(dates, outs, q, rate, n_paths) -> ExposureResult:
    ee, ee_d, ene, ene_d, pfe, ee_se, pfe_se = outs
    if isinstance(dates, torch.Tensor):
        dates = dates.cpu().numpy()
    return ExposureResult(dates=dates, ee=ee, ee_discounted=ee_d, ene=ene, ene_discounted=ene_d,
                          pfe=pfe, quantile=q, epe=float(np.mean(ee)), max_pfe=float(pfe.max()),
                          rate=rate, n_paths=n_paths, ee_stderr=ee_se, pfe_stderr=pfe_se)


def exposure_profile(book, *, horizon: float | None = None, n_dates: int = 24,
                     n_paths: int = 65536, seed: int = 0, quantile: float = 0.95,
                     netting: bool = True, collateral_threshold: float | None = None,
                     mpor: float = 0.0, spot: float | None = None, rate: float | None = None,
                     vol: float | None = None, dividend: float = 0.0, corr=None,
                     device="cuda") -> ExposureResult:
    """EE/EPE/PFE/ENE profile of a netting set on simulated GBM paths, on
    ``device``.

    ``book``: an :class:`~.portfolio.OptionsPortfolio` or list of
    :class:`~.portfolio.Position` (``option_type`` may also be
    ``"forward"``). Risk-neutral GBM dynamics at ``vol`` (default: each
    underlying's first position's vol). Positions with distinct
    ``underlying`` labels get their own correlated factor (``corr``: an
    (m, m) matrix in first-appearance order, default identity).
    ``collateral_threshold``: the counterparty posts (V − H)^+ observed
    ``mpor`` years earlier. ``netting=False`` computes the gross exposure
    sum_i (V_i)^+.
    """
    pos = _positions(book)
    if not pos:
        raise ValidationError("exposure_profile needs a non-empty book")
    if not 0.0 < quantile < 1.0:
        raise ValidationError(f"quantile must be in (0,1): {quantile}")
    rate, horizon, u_idx, spots, vols, chol = _book_setup(pos, spot, rate, vol, corr, horizon)
    dates = _date_grid(horizon, n_dates, device)
    lag = int(np.ceil(mpor / (horizon / n_dates) - 1e-9)) if mpor > 0 else 0

    s_all = _sim_spots(_generator(seed, device), n_paths, dates, spots, vols, chol, rate,
                       dividend)
    t_grid = dates[None, :]
    grids = (_value_grid(s_all[:, :, u_idx[p.underlying]], t_grid, p, rate, dividend)
             for p in pos)
    vs = [sum(grids)] if netting else list(grids)
    del s_all

    def exposed(v):
        if collateral_threshold is not None:
            v_lag = v if lag == 0 else torch.cat([v.new_zeros((n_paths, lag)), v[:, :-lag]],
                                                 dim=1)
            return v - torch.clamp_min(v_lag - collateral_threshold, 0.0)
        return v

    e_pos = sum(torch.clamp_min(exposed(v), 0.0) for v in vs)
    e_neg = sum(torch.clamp_min(-exposed(v), 0.0) for v in vs)
    return _result(dates, _profile(e_pos, e_neg, dates, rate, quantile), quantile, rate,
                   n_paths)


def _credit_leg(profile, t, lam, rec) -> float:
    """(1-R) · trapezoid of the discounted profile against the flat-hazard
    default density on the grid ``t`` (t=0 included)."""
    sp = np.exp(-lam * t)
    dpd = sp[:-1] - sp[1:]
    prof = np.concatenate([[profile[0]], profile])
    mid = 0.5 * (prof[:-1] + prof[1:])
    return float((1.0 - rec) * np.sum(mid * dpd))


def cva_dva(exposure: ExposureResult, hazard_rate: float, recovery: float = 0.4,
            own_hazard_rate: float | None = None, own_recovery: float = 0.4,
            funding_spread: float | None = None) -> dict:
    """CVA (and DVA when ``own_hazard_rate`` is given; and FVA when
    ``funding_spread`` is given) from a profile.

    Flat-hazard survival SP(t) = exp(-lambda t); trapezoid in discounted EE
    between grid points (t=0 takes the first grid value). FVA (symmetric,
    uncollateralized): FCA = s·∫EE*, FBA = s·∫ENE*, FVA = FCA − FBA,
    trapezoid on the same grid, no survival weighting.
    """
    if hazard_rate < 0 or recovery < 0 or recovery > 1:
        raise ValidationError("need hazard_rate >= 0 and recovery in [0,1]")
    t = np.concatenate([[0.0], exposure.dates])
    out = {"cva": _credit_leg(exposure.ee_discounted, t, hazard_rate, recovery),
           "hazard_rate": hazard_rate, "recovery": recovery}
    if own_hazard_rate is not None:
        out["dva"] = _credit_leg(exposure.ene_discounted, t, own_hazard_rate, own_recovery)
        out["bcva"] = out["cva"] - out["dva"]
    if funding_spread is not None:
        if funding_spread < 0:
            raise ValidationError("funding_spread must be >= 0")

        def time_integral(profile):
            prof = np.concatenate([[profile[0]], profile])
            mid = 0.5 * (prof[:-1] + prof[1:])
            return float(np.sum(mid * np.diff(t)))

        fca = funding_spread * time_integral(exposure.ee_discounted)
        fba = funding_spread * time_integral(exposure.ene_discounted)
        out.update(fca=fca, fba=fba, fva=fca - fba, funding_spread=funding_spread)
    return out


def cva_allocation(book, hazard_rate: float, recovery: float = 0.4, *, method: str = "euler",
                   horizon: float | None = None, n_dates: int = 24, n_paths: int = 65536,
                   seed: int = 0, spot: float | None = None, rate: float | None = None,
                   vol: float | None = None, dividend: float = 0.0, corr=None,
                   device="cuda") -> dict:
    """Per-trade CVA attribution for an (uncollateralized) netting set.

    ``method="euler"``: CVA_i from the per-trade contributions
    E[df 1{V>0} V_i]; they sum to the total CVA exactly. ``"incremental"``:
    CVA(book) − CVA(book without trade i) on common random numbers.
    Returns {"total_cva", "allocations", "method", "trades"}.
    """
    pos = _positions(book)
    if not pos:
        raise ValidationError("cva_allocation needs a non-empty book")
    if method not in ("euler", "incremental"):
        raise ValidationError(f"method must be euler|incremental: {method!r}")
    rate_, horizon_, u_idx, spots, vols, chol = _book_setup(pos, spot, rate, vol, corr, horizon)
    dates = _date_grid(horizon_, n_dates, device)
    s_all = _sim_spots(_generator(seed, device), n_paths, dates, spots, vols, chol, rate_,
                       dividend)
    t_grid = dates[None, :]
    v_each = [_value_grid(s_all[:, :, u_idx[p.underlying]], t_grid, p, rate_, dividend)
              for p in pos]
    del s_all
    ind = (sum(v_each) > 0.0).to(F32)
    df = torch.exp(-rate_ * dates)[None, :]
    # float64 on the host: the legs then sum to the total's leg to 1e-16
    per_trade = [(df * ind * vi).mean(dim=0).double().cpu().numpy() for vi in v_each]
    del v_each, ind

    t = np.concatenate([[0.0], dates.cpu().numpy()])
    total = _credit_leg(np.sum(per_trade, axis=0), t, hazard_rate, recovery)
    if method == "euler":
        alloc = [_credit_leg(c, t, hazard_rate, recovery) for c in per_trade]
    else:
        kw = dict(horizon=horizon_, n_dates=n_dates, n_paths=n_paths, seed=seed, rate=rate_,
                  dividend=dividend, device=device)
        alloc = []
        for i in range(len(pos)):
            rest = pos[:i] + pos[i + 1:]
            if rest:
                # the corr ordering survives only if removing trade i keeps
                # the same underlying set
                if corr is not None and len({p.underlying for p in rest}) != len(spots):
                    raise ValidationError("incremental allocation with corr requires every "
                                          "underlying to appear in >= 2 trades")
                prof = exposure_profile(rest, corr=corr, **kw)
                cva_rest = cva_dva(prof, hazard_rate, recovery)["cva"]
            else:
                cva_rest = 0.0
            alloc.append(total - cva_rest)
    return {"total_cva": total, "allocations": alloc, "method": method,
            "trades": [f"{p.quantity:+g} {p.option_type} K={p.strike:g} "
                       f"T={p.maturity:g} ({p.underlying})" for p in pos]}


def cva_greeks(book, hazard_rate: float, recovery: float = 0.4, *,
               horizon: float | None = None, n_dates: int = 24, n_paths: int = 65536,
               seed: int = 0, spot: float | None = None, rate: float | None = None,
               vol: float | None = None, dividend: float = 0.0, corr=None,
               device="cuda") -> dict:
    """CVA sensitivities by autograd through the WHOLE exposure simulation:
    dCVA/dS0 and dCVA/dσ per underlying, dCVA/dr and dCVA/dλ, from one
    reverse sweep on common random numbers.

    Exact oracle: for a LONG option netting set CVA = (1-R) V0 (1 − e^{−λT})
    and every sensitivity is the BS Greek scaled by (1-R)(1 − e^{−λT});
    dCVA/dλ = (1-R) V0 T e^{−λT}.
    """
    pos = _positions(book)
    if not pos:
        raise ValidationError("cva_greeks needs a non-empty book")
    rate_, horizon_, u_idx, spots, vols, chol = _book_setup(pos, spot, rate, vol, corr, horizon)
    dates = _date_grid(horizon_, n_dates, device)
    w = _brownian(_generator(seed, device), n_paths, dates, chol)
    leaves = [torch.tensor(x, dtype=F32, device=device).requires_grad_(True)
              for x in (spots, vols, rate_, hazard_rate)]
    spots_v, vols_v, rate_v, lam = leaves
    base_vols = torch.as_tensor(vols, device=device)
    with torch.enable_grad():
        s_all = _levels(w, dates, spots_v, vols_v, rate_v, dividend)
        t_grid = dates[None, :]
        v = torch.zeros((n_paths, n_dates), dtype=F32, device=device)
        for p in pos:
            i = u_idx[p.underlying]
            v = v + _value_grid(s_all[:, :, i], t_grid, p, rate_v, dividend,
                                vol_shift=vols_v[i] - base_vols[i])
        df = torch.exp(-rate_v * dates)[None, :]
        ee_star = (df * torch.clamp_min(v, 0.0)).mean(dim=0)
        sp = torch.exp(-lam * torch.cat([dates.new_zeros(1), dates]))
        dpd = sp[:-1] - sp[1:]
        prof = torch.cat([ee_star[:1], ee_star])
        cva = (1.0 - recovery) * torch.sum(0.5 * (prof[:-1] + prof[1:]) * dpd)
        grads = torch.autograd.grad(cva, leaves)
    unds = list(u_idx)
    return {
        "cva": float(cva.detach()),
        "cva_delta": {u: float(grads[0][i]) for i, u in enumerate(unds)},
        "cva_vega": {u: float(grads[1][i]) for i, u in enumerate(unds)},
        "cva_rho": float(grads[2]),
        "cva_hazard_sens": float(grads[3]),
    }


def cva_wwr(book, hazard_rate: float, recovery: float = 0.4, *, wwr_beta: float = 0.0,
            horizon: float | None = None, n_dates: int = 24, n_paths: int = 65536,
            seed: int = 0, spot: float | None = None, rate: float | None = None,
            vol: float | None = None, dividend: float = 0.0, corr=None,
            device="cuda") -> dict:
    """CVA with WRONG-WAY RISK: the default intensity rides the first
    underlying's factor, λ_t = λ0 · (S_t/S_0)^{−β}, so survival is path
    dependent, SP_t = exp(−Σ λ_s dt), and

        CVA = (1-R) · E[ sum_j df_j E_j (SP_{j-1} - SP_j) ].

    β = 0 reduces exactly to the profile CVA on the same paths; both
    estimators here run on one set of paths. Returns {"cva", "cva_beta0",
    "wwr_ratio", "wwr_beta"}.
    """
    pos = _positions(book)
    if not pos:
        raise ValidationError("cva_wwr needs a non-empty book")
    rate_, horizon_, u_idx, spots, vols, chol = _book_setup(pos, spot, rate, vol, corr, horizon)
    dates = _date_grid(horizon_, n_dates, device)
    dt = horizon_ / n_dates
    s_all = _sim_spots(_generator(seed, device), n_paths, dates, spots, vols, chol, rate_,
                       dividend)
    t_grid = dates[None, :]
    v = torch.zeros((n_paths, n_dates), dtype=F32, device=device)
    for p in pos:
        v = v + _value_grid(s_all[:, :, u_idx[p.underlying]], t_grid, p, rate_, dividend)
    e = torch.clamp_min(v, 0.0)
    df = torch.exp(-rate_ * dates)[None, :]
    ratio = s_all[:, :, 0] / float(spots[0])

    def run(beta: float) -> float:
        lam = hazard_rate * ratio ** (-beta)
        sp = torch.exp(-torch.cumsum(lam * dt, dim=1))  # SP at the date grid
        sp_prev = torch.cat([torch.ones((n_paths, 1), dtype=F32, device=device), sp[:, :-1]],
                            dim=1)
        return float((1.0 - recovery) * torch.mean(torch.sum(df * e * (sp_prev - sp), dim=1)))

    cva_b, cva_0 = run(float(wwr_beta)), run(0.0)
    return {"cva": cva_b, "cva_beta0": cva_0, "wwr_ratio": cva_b / max(cva_0, 1e-12),
            "wwr_beta": wwr_beta}


def xva_report(book, *, hazard_rate: float = 0.02, recovery: float = 0.4,
               own_hazard_rate: float | None = None, funding_spread: float | None = None,
               **exposure_kwargs) -> dict:
    """One-call exposure profile + CVA/DVA (+ FVA) summary for a netting
    set."""
    prof = exposure_profile(book, **exposure_kwargs)
    adj = cva_dva(prof, hazard_rate, recovery, own_hazard_rate, funding_spread=funding_spread)
    return {**prof.to_dict(), **adj}
