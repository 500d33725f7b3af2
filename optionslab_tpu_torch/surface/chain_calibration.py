"""End-to-end option chain → SVI/SSVI/eSSVI surface → dynamic model or
Dupire local vol.

The port of ``optionslab_tpu/surface/chain_calibration.py``, one function per
step of a desk's morning: :func:`calibrate_chain` (backfill the implied
vols, bucket the expiries, fit one SVI slice per bucket, SSVI on the
scattered quotes, optionally eSSVI, and the static no-arbitrage report),
:func:`svi_surface_iv_fn` and :func:`local_vol_from_chain` (a smooth
iv(k, T) and the Dupire surface from it), :func:`calibrate_model_to_chain`
(Heston, Bates, the Heston chain kernel, rough Bergomi). The chain is any
frame-like input or an ``OptionChainDataset``, held as a column table of
numpy arrays (no pandas); the fits run in float32 on ``device`` (by default
the dataset's, else the card).

Moneyness is forward log-moneyness k = log(K/F), F = S·exp(rT).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..data._table import as_table
from ..utils.exceptions import CalibrationError, ValidationError
from .essvi import surface_iv_fn
from .svi import (SSVIParams, SVIParams, SVI_FIELDS, _f32, _inv_softplus, _ssvi_unpack,
                  calibrate_svi, check_butterfly, linspace, ssvi_total_variance,
                  svi_total_variance)

__all__ = ["ChainCalibrationResult", "calibrate_chain", "chain_smile_data",
           "svi_surface_iv_fn", "local_vol_from_chain",
           "calibrate_model_to_chain"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass
class ChainCalibrationResult:
    """Everything the vol-surface page displays; the fitted parameters are
    float32 tensors on the fit's device."""

    expiries: np.ndarray  # (n_exp,) bucket maturities (years)
    n_quotes: np.ndarray  # (n_exp,) quotes used per slice
    svi_params: list  # [SVIParams] per expiry
    svi_rmse_vol: np.ndarray  # (n_exp,) RMSE in vol points
    thetas: np.ndarray  # (n_exp,) fitted ATM total variance
    ssvi: SSVIParams
    ssvi_rmse_vol: float
    report: dict
    spot: float
    rate: float
    slice_quotes: list = dataclasses.field(default_factory=list, repr=False)
    # [(k, iv_adjusted)] per expiry: the exact data each slice was fit to
    essvi: object = None  # ESSVIParams when essvi=True
    essvi_rmse_vol: float = float("nan")

    @classmethod
    def from_numpy(cls, *, svi_params, ssvi, essvi=None, device="cuda",
                   **fields) -> "ChainCalibrationResult":
        """A result from numpy data, e.g. the JAX package's fit: each of
        ``svi_params`` a mapping of (a, b, rho, m, sigma) or those five in
        order, ``ssvi`` a mapping or (rho, eta, gamma), ``essvi`` a mapping or
        (theta, rho, psi) or None; the other fields as the dataclass's."""
        from .essvi import ESSVIParams

        def args(p, names):
            return [p[n] for n in names] if hasattr(p, "keys") else list(p)

        return cls(svi_params=[SVIParams.from_numpy(*args(p, SVI_FIELDS), device=device)
                               for p in svi_params],
                   ssvi=SSVIParams.from_numpy(*args(ssvi, ("rho", "eta", "gamma")),
                                              device=device),
                   essvi=None if essvi is None else ESSVIParams.from_numpy(
                       *args(essvi, ("theta", "rho", "psi")), device=device),
                   **fields)

    def to_dict(self) -> dict:
        def p2d(p):
            return {f: float(getattr(p, f)) for f in SVI_FIELDS}

        return {
            "expiries": [float(t) for t in self.expiries],
            "n_quotes": [int(n) for n in self.n_quotes],
            "svi_params": [p2d(p) for p in self.svi_params],
            "svi_rmse_vol": [float(x) for x in self.svi_rmse_vol],
            "thetas": [float(t) for t in self.thetas],
            "ssvi": {"rho": float(self.ssvi.rho), "eta": float(self.ssvi.eta),
                     "gamma": float(self.ssvi.gamma)},
            "ssvi_rmse_vol": float(self.ssvi_rmse_vol),
            "report": self.report,
            "spot": self.spot,
            "rate": self.rate,
            **({"essvi": {
                "theta": [float(x) for x in _host(self.essvi.theta)],
                "rho": [float(x) for x in _host(self.essvi.rho)],
                "psi": [float(x) for x in _host(self.essvi.psi)]},
                "essvi_rmse_vol": float(self.essvi_rmse_vol)}
               if self.essvi is not None else {}),
        }

    def svi_vol(self, log_moneyness, expiry_index: int):
        """Fitted slice vol at forward log-moneyness k = log(K/F)."""
        t = float(self.expiries[expiry_index])
        p = self.svi_params[expiry_index]
        w = svi_total_variance(_f32(_host(log_moneyness), p.a.device), p)
        return torch.sqrt(torch.clamp_min(w, 1e-12) / t)


def _bucket_expiries(ttm: np.ndarray, n_bins: int):
    """Group maturities: exact distinct values when few, quantile bins else.

    Returns (labels, bucket_ttm) where labels[i] indexes bucket_ttm."""
    uniq = np.unique(np.round(ttm, 6))
    if len(uniq) <= n_bins:
        labels = np.searchsorted(uniq, np.round(ttm, 6))
        return labels, uniq
    edges = np.quantile(ttm, np.linspace(0.0, 1.0, n_bins + 1))
    edges[0] -= 1e-9
    labels = np.clip(np.searchsorted(edges, ttm, side="left") - 1, 0, n_bins - 1)
    bucket_ttm = np.array([np.median(ttm[labels == b]) if np.any(labels == b)
                           else 0.5 * (edges[b] + edges[b + 1])
                           for b in range(n_bins)])
    keep = np.array([np.any(labels == b) for b in range(n_bins)])
    remap = np.cumsum(keep) - 1
    return remap[labels], bucket_ttm[keep]


def _atm_term_structure(k_all, ttm, iv, k_window: float = 0.15):
    """Smooth sigma_atm(T) estimate from near-the-money quotes (binned
    medians + linear interpolation). Returns a vectorized callable."""
    atm = np.abs(k_all) < k_window
    if atm.sum() < 8:
        level = float(np.median(iv))
        return lambda t: np.full_like(np.asarray(t, np.float64), level)
    t_atm, iv_atm = ttm[atm], iv[atm]
    nb = int(np.clip(atm.sum() // 8, 2, 12))
    edges = np.quantile(t_atm, np.linspace(0.0, 1.0, nb + 1))
    idx = np.clip(np.searchsorted(edges, t_atm, side="left") - 1, 0, nb - 1)
    centers, meds = [], []
    for b in range(nb):
        m = idx == b
        if m.any():
            centers.append(float(np.median(t_atm[m])))
            meds.append(float(np.median(iv_atm[m])))
    centers, meds = np.asarray(centers), np.asarray(meds)
    return lambda t: np.interp(np.asarray(t, np.float64), centers, meds)


def _ssvi_scattered_loss(x, k, th, w_obs):
    p = _ssvi_unpack(x)
    w = ssvi_total_variance(k, th, p)
    fit = torch.mean((w - w_obs) ** 2)
    pen = torch.clamp_min(p.eta * (1.0 + torch.abs(p.rho)) - 2.0, 0.0) ** 2
    return fit + 10.0 * pen


def _calibrate_ssvi_scattered(k_flat, theta_flat, w_flat, n_steps, learning_rate, device):
    """SSVI (rho, eta, gamma) fit directly on the scattered quotes: the total
    variance is pointwise, so each quote carries its expiry's theta and no
    maturity grid is needed. One Adam loop."""
    from ..ops.optim import scan_adam_cached

    args = tuple(_f32(np.asarray(a, np.float32), device) for a in (k_flat, theta_flat, w_flat))
    x0 = torch.stack([torch.atanh(_f32(-0.3, device)), _inv_softplus(_f32(1.0, device)),
                      torch.atanh(_f32(0.5 * 2 - 1, device))])
    best_x, best_loss, _ = scan_adam_cached(_ssvi_scattered_loss, x0, args, n_steps,
                                            learning_rate)
    if not math.isfinite(float(best_loss)):
        raise CalibrationError("SSVI chain calibration diverged")
    return _ssvi_unpack(best_x.detach())


def _resolve_device(chain, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device(getattr(chain, "device", "cuda"))


def _chain_with_iv(chain, from_prices: bool, device):
    """The chain's column table, its implied vols backfilled from prices when
    asked or when it has none (one implied-vol call on ``device``)."""
    table = as_table(chain)
    if from_prices or "implied_volatility" not in table:
        if not hasattr(chain, "backfill_implied_vol"):
            from ..data.loader import OptionChainDataset

            chain = OptionChainDataset(table, device)
        table = chain.backfill_implied_vol(device=device).table
    return table


def calibrate_chain(chain, *, n_expiry_bins: int = 6, from_prices: bool = False,
                    min_quotes_per_slice: int = 8, n_steps: int = 600,
                    learning_rate: float = 0.02,
                    essvi: bool = False, device=None) -> ChainCalibrationResult:
    """Chain snapshot → per-expiry SVI slices + global SSVI + arb report.

    ``chain``: an ``OptionChainDataset`` or a frame with the standard columns
    (``data/loader.py``). ``from_prices=True`` backfills implied vols from
    option prices first (one implied-vol call). Quotes inside an expiry
    bucket are level-adjusted to the bucket's maturity by the ATM vol term
    structure before their slice is fit. ``essvi=True`` also fits an eSSVI
    surface jointly over all slices (one Adam loop) and merges its exact
    no-arbitrage report under ``report["essvi_*"]``.
    """
    dev = _resolve_device(chain, device)
    df = _chain_with_iv(chain, from_prices, dev)

    need = ["underlying_price", "strike_price", "time_to_maturity", "implied_volatility"]
    for c in need:
        if c not in df:
            raise ValidationError(f"chain is missing column {c!r}")

    iv = np.asarray(df["implied_volatility"], np.float64)
    ok = np.isfinite(iv) & (iv > 0.01) & (iv < 3.0)
    df = df.take(ok)
    if len(df) < min_quotes_per_slice:
        raise ValidationError(f"only {len(df)} usable quotes after filtering")

    s = np.asarray(df["underlying_price"], np.float64)
    strike = np.asarray(df["strike_price"], np.float64)
    ttm = np.asarray(df["time_to_maturity"], np.float64)
    iv = np.asarray(df["implied_volatility"], np.float64)
    rate = (float(np.median(np.asarray(df["risk_free_rate"], np.float64)))
            if "risk_free_rate" in df else 0.0)
    spot = float(np.median(s))

    fwd = s * np.exp(rate * ttm)
    k_all = np.log(strike / fwd)

    labels, bucket_ttm = _bucket_expiries(ttm, n_expiry_bins)
    sigma_atm = _atm_term_structure(k_all, ttm, iv)

    svi_params, rmse, thetas, counts, expiries = [], [], [], [], []
    slice_quotes = []  # (k, iv, T) per kept slice, for SSVI + diagnostics
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for b, t in enumerate(bucket_ttm):
        sel = labels == b
        if sel.sum() < min_quotes_per_slice:
            continue
        kb, tb = k_all[sel], ttm[sel]
        t = float(t)
        # level-adjust each quote's vol to the bucket maturity, then fit the
        # smile at the single maturity t
        ivb = iv[sel] * sigma_atm(t) / sigma_atm(tb)
        p, _ = calibrate_svi(kb, vols=ivb, maturity=t, n_steps=n_steps,
                             learning_rate=learning_rate, device=dev)
        w_fit = _host(svi_total_variance(_f32(kb, dev), p))
        vol_fit = np.sqrt(np.maximum(w_fit, 1e-12) / t)
        svi_params.append(p)
        rmse.append(float(np.sqrt(np.mean((vol_fit - ivb) ** 2))))
        thetas.append(float(svi_total_variance(zero, p)))
        counts.append(int(sel.sum()))
        expiries.append(t)
        slice_quotes.append((kb, ivb, t))

    if not svi_params:
        raise CalibrationError(f"no expiry bucket has >= {min_quotes_per_slice} quotes")

    order = np.argsort(expiries)
    svi_params = [svi_params[i] for i in order]
    slice_quotes = [slice_quotes[i] for i in order]
    expiries = np.asarray(expiries, np.float64)[order]
    rmse = np.asarray(rmse)[order]
    thetas = np.asarray(thetas)[order]
    counts = np.asarray(counts)[order]

    # SSVI on the scattered quotes, theta taken from each quote's slice fit
    k_flat = np.concatenate([q[0] for q in slice_quotes])
    w_flat = np.concatenate([(q[1] ** 2) * q[2] for q in slice_quotes])
    th_flat = np.concatenate([np.full(len(q[0]), thetas[i])
                              for i, q in enumerate(slice_quotes)])
    ssvi = _calibrate_ssvi_scattered(k_flat, th_flat, w_flat, n_steps, learning_rate, dev)
    w_ssvi = _host(ssvi_total_variance(_f32(k_flat, dev), _f32(th_flat, dev), ssvi))
    t_flat = np.concatenate([np.full(len(q[0]), q[2]) for q in slice_quotes])
    ssvi_rmse = float(np.sqrt(np.mean(
        (np.sqrt(np.maximum(w_ssvi, 1e-12) / t_flat)
         - np.concatenate([q[1] for q in slice_quotes])) ** 2)))

    # --- static no-arbitrage diagnostics on the FITTED surface ------------
    k_dense = linspace(float(k_all.min()), float(k_all.max()), 101, dev)
    w_slices = torch.stack([svi_total_variance(k_dense, p) for p in svi_params]).cpu().numpy()
    calendar_violation_rate = (float(np.mean(np.diff(w_slices, axis=0) < -1e-8))
                               if len(svi_params) > 1 else 0.0)
    bfly = [check_butterfly(p, k_dense) for p in svi_params]
    eta_r = float(ssvi.eta) * (1.0 + abs(float(ssvi.rho)))
    report = {
        "butterfly_free": bfly,
        "calendar_violation_rate": calendar_violation_rate,
        "theta_monotone": bool(np.all(np.diff(thetas) >= -1e-8)),
        "ssvi_butterfly_condition": eta_r,  # <= 2 is arb-free
        "ssvi_butterfly_free": eta_r <= 2.0 + 1e-9,
        "arbitrage_free": (calendar_violation_rate == 0.0 and all(bfly)),
        "total_quotes_used": int(counts.sum()),
    }

    essvi_params, essvi_rmse = None, float("nan")
    if essvi:
        from .essvi import calibrate_essvi, essvi_report, essvi_total_variance

        ks = [q[0] for q in slice_quotes]
        ws = [(q[1] ** 2) * q[2] for q in slice_quotes]
        essvi_params, _ = calibrate_essvi(ks, ws, thetas_init=thetas,
                                          n_steps=max(n_steps, 1200),
                                          learning_rate=learning_rate, device=dev)
        errs = []
        for i, (kq, ivq, tq) in enumerate(slice_quotes):
            w_e = _host(essvi_total_variance(_f32(kq, dev), essvi_params.theta[i],
                                             essvi_params.rho[i], essvi_params.psi[i]))
            errs.append(np.sqrt(np.maximum(w_e, 1e-12) / tq) - ivq)
        essvi_rmse = float(np.sqrt(np.mean(np.concatenate(errs) ** 2)))
        rep_e = essvi_report(essvi_params, float(k_all.min()) - 0.2, float(k_all.max()) + 0.2)
        report.update({f"essvi_{k}": v for k, v in rep_e.items()})

    return ChainCalibrationResult(
        expiries=expiries, n_quotes=counts, svi_params=svi_params,
        svi_rmse_vol=rmse, thetas=thetas, ssvi=ssvi, ssvi_rmse_vol=ssvi_rmse,
        report=report, spot=spot, rate=rate,
        slice_quotes=[(q[0], q[1]) for q in slice_quotes],
        essvi=essvi_params, essvi_rmse_vol=essvi_rmse)


def svi_surface_iv_fn(result: ChainCalibrationResult):
    """Smooth-in-(k, T) implied-vol function from the calibrated slices.

    Total variance is linear in T between slice fits (calendar-monotone when
    the slices are); before the first expiry w = w_1·T/T_1, after the last
    w = w_n·T/T_n, both with dw/dT > 0 so the Dupire numerator stays
    positive. Elementwise in broadcast (k, T), float32 on the slices'
    device, differentiable by autograd in k and T: the input
    :class:`~..models.local_vol.DupireLocalVol` needs. dw/dT on an expiry is
    the slope of the segment after it, on the last expiry the last
    segment's (``essvi.interp_total_variance``).
    """
    params = list(result.svi_params)
    dev = params[0].a.device
    expiries = _f32(np.asarray(result.expiries, np.float32), dev)

    def w_slices(k):
        return torch.stack([svi_total_variance(k, p) for p in params])

    return surface_iv_fn(w_slices, expiries)


def local_vol_from_chain(chain, *, n_expiry_bins: int = 5,
                         from_prices: bool = False, n_steps: int = 600,
                         n_k: int = 121, n_t: int = 60,
                         result: ChainCalibrationResult | None = None, device=None):
    """Market chain → Dupire local-volatility surface, one call: calibrate
    SVI slices (unless ``result`` is given), build the smooth surface
    function, extract σ_loc(k, T) by autograd on an n_t × n_k grid ending on
    the last expiry. Returns (DupireLocalVol, ChainCalibrationResult); the
    surface is on ``device`` (by default the fit's)."""
    from ..models.local_vol import DupireLocalVol

    if result is None:
        result = calibrate_chain(chain, n_expiry_bins=n_expiry_bins, from_prices=from_prices,
                                 n_steps=n_steps, device=device)
    dev = torch.device(device) if device is not None else result.svi_params[0].a.device
    iv_fn = svi_surface_iv_fn(result)
    k_all = np.concatenate([q[0] for q in result.slice_quotes])
    k_pad = 0.1 + 0.15 * (k_all.max() - k_all.min())
    dupire = DupireLocalVol(
        iv_fn, spot=result.spot, rate=result.rate,
        k_range=(float(k_all.min() - k_pad), float(k_all.max() + k_pad)),
        t_range=(max(0.25 * float(result.expiries[0]), 0.01), float(result.expiries[-1])),
        n_k=n_k, n_t=n_t, device=dev)
    return dupire, result


def calibrate_model_to_chain(chain, model: str = "heston", *,
                             from_prices: bool = False, n_steps: int = 800,
                             max_quotes: int = 400, seed: int = 0,
                             mc_paths: int = 1_000_000,
                             mc_max_dt: float = 0.02, device=None) -> dict:
    """Fit a dynamic model directly to the chain's option prices: "heston"
    and "bates" by Adam through the Lewis prices (``calibrate_heston`` /
    ``calibrate_bates``), "heston-mc" through the Heston chain kernel (one
    launch per Adam step prices the quotes and their 5-parameter gradient;
    quotes thinned to 12; ``prng`` on the card, ``hash`` on the CPU),
    "rbergomi" on common random numbers (quotes thinned to 24). Returns the
    fitted params, the loss, and the price and IV RMSE (the Monte Carlo fits
    repriced by Lewis, rough Bergomi on a generator seeded ``seed + 1``)."""
    from ..models.black_scholes import bs_price
    from ..models.iv import implied_vol
    from ..types import ContractBatch

    dev = _resolve_device(chain, device)
    df = _chain_with_iv(chain, from_prices, dev)
    iv = np.asarray(df["implied_volatility"], np.float64)
    ok = np.isfinite(iv) & (iv > 0.01) & (iv < 3.0)
    df = df.take(ok)
    if model == "heston-mc":
        max_quotes = min(max_quotes, 12)
    elif model == "rbergomi":
        # one program reprices every quote off a shared path set, so quotes
        # are cheap: the grid (union of expiries) is what scales
        max_quotes = min(max_quotes, 24)
    if len(df) > max_quotes:  # deterministic thinning for the Adam loop
        df = df.take(np.linspace(0, len(df) - 1, max_quotes).astype(int))

    s = np.asarray(df["underlying_price"], np.float64)
    strike = np.asarray(df["strike_price"], np.float64)
    ttm = np.asarray(df["time_to_maturity"], np.float64)
    iv = np.asarray(df["implied_volatility"], np.float64)
    rate = (np.asarray(df["risk_free_rate"], np.float64)
            if "risk_free_rate" in df else np.zeros_like(s))
    cp = (np.where(np.asarray(df["option_type"]).astype(str) == "put", -1.0, 1.0)
          if "option_type" in df else np.ones_like(s))

    batch = ContractBatch.make(spot=s, strike=strike, maturity=ttm, rate=rate, vol=iv,
                               option_type=cp, device=dev)
    if "option_price" in df:
        target = np.asarray(df["option_price"], np.float64)
    else:
        f64 = dict(dtype=torch.float64, device=dev)
        target = _host(bs_price(*(torch.as_tensor(x, **f64) for x in (s, strike, ttm, rate,
                                                                      iv, cp, 0.0))))

    if model == "heston":
        from ..models.heston import calibrate_heston, heston_price

        params, loss = calibrate_heston(target, batch, n_steps=n_steps)
        names = ("v0", "kappa", "theta", "sigma", "rho")
        fitted = _host(heston_price(batch, params))
    elif model == "bates":
        from ..models.bates import bates_price, calibrate_bates

        params, loss = calibrate_bates(target, batch, n_steps=n_steps)
        names = ("v0", "kappa", "theta", "sigma", "rho", "lam", "mu_j", "sigma_j")
        fitted = _host(bates_price(batch, params))
    elif model == "heston-mc":
        from ..models.heston import calibrate_heston_mc, heston_price

        # the card's Philox sampler there; the counter hash on the CPU
        sampler = "prng" if dev.type == "cuda" else "hash"
        params, loss = calibrate_heston_mc(
            target, strike, ttm, cp, float(np.median(s)), float(np.median(rate)),
            n_steps=min(n_steps, 200), n_paths=mc_paths, max_dt=mc_max_dt, seed=seed,
            sampler=sampler, device=dev)
        names = ("v0", "kappa", "theta", "sigma", "rho")
        fitted = _host(heston_price(batch, params))
    elif model == "rbergomi":
        from ..models.rbergomi import calibrate_rbergomi, rbergomi_chain_price

        n_paths = min(mc_paths, 131_072)
        params, loss = calibrate_rbergomi(
            target, strike, ttm, cp, float(np.median(s)), float(np.median(rate)),
            n_steps=min(n_steps, 300), n_paths=n_paths, max_dt=mc_max_dt, seed=seed,
            device=dev)
        names = ("hurst", "eta", "rho", "xi0")
        # diagnostics on an independent generator: the reported RMSE includes
        # the fit's own Monte Carlo error instead of reusing its noise
        fitted = _host(rbergomi_chain_price(
            strike, ttm, cp, float(np.median(s)), float(np.median(rate)), params,
            torch.Generator(device=dev).manual_seed(seed + 1), n_paths=n_paths,
            max_dt=mc_max_dt))
    else:
        raise ValidationError(f"model must be heston|heston-mc|bates|rbergomi, got {model!r}")

    iv_fit = _host(implied_vol(*(_f32(np.asarray(x, np.float32), dev)
                                 for x in (fitted, s, strike, ttm, rate, cp))))
    good = np.isfinite(iv_fit)
    return {
        "model": model,
        "params": {n: float(getattr(params, n)) for n in names},
        "loss": float(loss),
        "price_rmse": float(np.sqrt(np.mean((fitted - target) ** 2))),
        "iv_rmse": (float(np.sqrt(np.mean((iv_fit[good] - iv[good]) ** 2)))
                    if good.any() else float("nan")),
        "n_quotes": int(len(df)),
    }


def chain_smile_data(chain, result: ChainCalibrationResult, expiry_index: int,
                     n_fit: int = 101):
    """Quotes the slice was fit to (level-adjusted to the bucket maturity)
    and the fitted SVI curve, for plotting: a dict of k_market, iv_market,
    k_fit, iv_fit (numpy) and expiry."""
    del chain  # the result carries the quotes each slice was fit to
    t = float(result.expiries[expiry_index])
    k, iv_adj = result.slice_quotes[expiry_index]
    k_fit = (np.linspace(k.min() - 0.05, k.max() + 0.05, n_fit) if len(k)
             else np.linspace(-0.3, 0.3, n_fit))
    iv_fit = _host(result.svi_vol(k_fit, expiry_index))
    return {"k_market": np.asarray(k), "iv_market": np.asarray(iv_adj),
            "k_fit": k_fit, "iv_fit": iv_fit, "expiry": t}
