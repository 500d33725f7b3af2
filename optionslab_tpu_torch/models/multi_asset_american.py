"""Certified [lower, upper] bracket for multi-asset Bermudan options.

The port of ``optionslab_tpu/models/multi_asset_american.py``. The canonical
product is the Bermudan max-call on d dividend-paying assets — the
Broadie–Glasserman (1997) / Andersen–Broadie (2004) benchmark, where early
exercise is optimal (the dividend yield makes waiting costly) and no PDE
engine scales past d = 2; ``kind="min_put"`` prices the put on the minimum.

- **Lower bound**: an LSM policy on order-statistic features (the sorted
  asset prices: the payoff depends on the order statistics only), valued
  out of sample.
- **Upper bound**: the value-surface dual (Glasserman ch. 8): an all-path
  ridge fit of the continuation value defines Ṽ; the martingale increment
  at date k is df_k·Ṽ_k(X_k) − Ê[df_k·Ṽ_k(X_k)|X_{k−1}], the conditional
  mean estimated by antithetic one-date inner transitions (exact GBM).
  E[max_k (df_k·payoff_k − M_k)] is an upper bound in expectation; inner
  noise only biases it up.

The bracket certifies the Bermudan value on the date grid. The regressions
are float64 numpy solves on the host; the simulation runs on a
``torch.Generator``'s device in float32. :func:`max_call_lower` and
:func:`max_call_upper` take coefficients as numpy arrays or tensors, so a
fit made elsewhere (e.g. the JAX package's ``fit_max_call_lsm``) prices
through this package's pipelines unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.exceptions import ValidationError

__all__ = ["fit_max_call_lsm", "max_call_lower", "max_call_upper", "max_call_bracket"]

N_FEAT = 8
N_SFEAT = 12
KINDS = ("max_call", "min_put")


def _order_stats(s: torch.Tensor, kind: str = "max_call"):
    """The two payoff-relevant order statistics along the asset axis (top-2
    for the max-call, bottom-2 for the min-put); for d = 1 both coincide
    (the ridge handles the collinearity)."""
    y = torch.sort(s, dim=-1).values
    one = s.shape[-1] == 1
    if kind == "min_put":
        return y[..., 0], y[..., 0 if one else 1]
    return y[..., -1], y[..., -1 if one else -2]


def _payoff(y1, strike, kind: str):
    return torch.clamp_min(strike - y1 if kind == "min_put" else y1 - strike, 0.0)


def _features(y1, y2, ex):
    """Policy basis (ITM-only fit): polynomials in the top-2 order
    statistics of S/K plus the payoff (the exercise boundary's kink)."""
    return torch.stack([torch.ones_like(y1), y1, y1 * y1, y1 * y1 * y1, y2, y2 * y2, y1 * y2,
                        ex], dim=-1)


def _sfeatures(y1, y2, ex):
    """The richer all-path basis of the dual's value surface."""
    a2 = y1 * y1
    b2 = y2 * y2
    return torch.stack([torch.ones_like(y1), y1, a2, a2 * y1, a2 * a2, y2, b2, y1 * y2, a2 * y2,
                        y1 * b2, ex, ex * y1], dim=-1)


def _simulate_dates(generator, spots, vols, chol, rate, dividend, maturity, n_dates: int,
                    n_paths: int) -> torch.Tensor:
    """Correlated GBM at every exercise date, (n_dates+1, n_paths, d),
    float32 on the generator's device; exact per-interval transitions."""
    dt = maturity / n_dates
    drift = (rate - dividend - 0.5 * vols * vols) * dt
    sig_sdt = vols * math.sqrt(dt)
    d = spots.shape[0]
    x = torch.zeros((n_paths, d), dtype=torch.float32, device=spots.device)
    xs = [x]
    for _ in range(n_dates):
        z = torch.randn((n_paths, d), generator=generator, dtype=torch.float32,
                        device=spots.device)
        x = x + drift[None, :] + sig_sdt[None, :] * (z @ chol.T)
        xs.append(x)
    return spots[None, None, :] * torch.exp(torch.stack(xs))


def _setup(spots, vols, corr, d: int, dev):
    spots = torch.as_tensor(np.atleast_1d(np.asarray(spots, np.float32)), device=dev)
    vols = torch.broadcast_to(
        torch.as_tensor(np.atleast_1d(np.asarray(vols, np.float32)), device=dev), (d,))
    c = np.asarray(corr, np.float64) if corr is not None else np.eye(d)
    if c.shape != (d, d):
        raise ValidationError(f"corr must be ({d}, {d}), got {c.shape}")
    try:
        chol = np.linalg.cholesky(c)
    except np.linalg.LinAlgError as e:
        raise ValidationError("corr must be positive definite") from e
    return spots, vols, torch.as_tensor(chol, dtype=torch.float32, device=dev)


def fit_max_call_lsm(spots, strike, maturity, rate, vols, generator: torch.Generator,
                     dividend: float = 0.0, corr=None, n_dates: int = 9,
                     n_paths: int = 100_000, kind: str = "max_call"):
    """Backward LSM on order-statistic features (float64 host solves).

    Returns (policy_coefs, surface_coefs) as float32 numpy arrays of shape
    (n_dates+1, F): the ITM-only exercise rule and the all-path ridge value
    surface."""
    d = len(np.atleast_1d(spots))
    spots_t, vols_t, chol = _setup(spots, vols, corr, d, generator.device)
    s = _simulate_dates(generator, spots_t, vols_t, chol, float(rate), float(dividend),
                        float(maturity), n_dates, n_paths).cpu().double()
    k_ = float(strike)
    disc = math.exp(-float(rate) * float(maturity) / n_dates)
    y1, y2 = _order_stats(s, kind)
    ex_all = _payoff(y1, k_, kind)
    cash = ex_all[-1].numpy().copy()
    coefs = np.zeros((n_dates + 1, N_FEAT))
    scoefs = np.zeros((n_dates + 1, N_SFEAT))
    for t in range(n_dates - 1, 0, -1):
        cash *= disc
        ex = ex_all[t].numpy()
        args = (y1[t] / k_, y2[t] / k_, ex_all[t] / k_)
        sb = _sfeatures(*args).numpy()
        ata = sb.T @ sb + 1e-7 * len(ex) * np.eye(N_SFEAT)
        scoefs[t] = np.linalg.solve(ata, sb.T @ (cash / k_))
        itm = ex > 0
        if itm.sum() > 10 * N_FEAT:
            basis = _features(*args).numpy()[itm]
            coef, *_ = np.linalg.lstsq(basis, cash[itm] / k_, rcond=None)
            coefs[t] = coef
            take = ex[itm] > basis @ coef * k_
            idx = np.where(itm)[0][take]
            cash[idx] = ex[idx]
    return coefs.astype(np.float32), scoefs.astype(np.float32)


def _coef_tensor(coefs, dev) -> torch.Tensor:
    c = coefs.detach().cpu().numpy() if isinstance(coefs, torch.Tensor) else np.asarray(coefs)
    return torch.as_tensor(c.astype(np.float32), device=dev)


def _lower_pipeline(coefs, generator, spots, vols, chol, strike, maturity, rate, dividend,
                    n_dates, n_paths, kind):
    s_paths = _simulate_dates(generator, spots, vols, chol, rate, dividend, maturity, n_dates,
                              n_paths)
    dt = maturity / n_dates
    alive = torch.ones(n_paths, dtype=torch.bool, device=spots.device)
    cash = torch.zeros(n_paths, dtype=torch.float32, device=spots.device)
    for t in range(1, n_dates + 1):
        y1, y2 = _order_stats(s_paths[t], kind)
        ex = _payoff(y1, strike, kind)
        cont = (_features(y1 / strike, y2 / strike, ex / strike) @ coefs[t]) * strike
        take = (ex > 0.0) & ((t >= n_dates) | (ex > cont))
        cash = torch.where(alive & take, math.exp(-rate * dt * t) * ex, cash)
        alive = alive & ~take
    return cash.mean(), cash.std(correction=1) / math.sqrt(n_paths)


def max_call_lower(coefs, generator: torch.Generator, spots, strike, maturity, rate, vols,
                   dividend: float = 0.0, corr=None, n_dates: int = 9,
                   n_paths: int = 200_000, kind: str = "max_call"):
    """Out-of-sample policy value: (lower bound, stderr) as floats."""
    d = len(np.atleast_1d(spots))
    dev = generator.device
    spots_t, vols_t, chol = _setup(spots, vols, corr, d, dev)
    m, se = _lower_pipeline(_coef_tensor(coefs, dev), generator, spots_t, vols_t, chol,
                            float(strike), float(maturity), float(rate), float(dividend),
                            n_dates, n_paths, kind)
    return float(m), float(se)


def _surface_value(scoefs, t, s, strike, n_dates, vmax, kind):
    """Ṽ_t = max(payoff, clipped continuation fit); zero continuation at the
    last date. ``vmax`` bounds the polynomial wings (min-put: K; max-call: a
    deterministic 8-sigma envelope of the terminal max)."""
    y1, y2 = _order_stats(s, kind)
    ex = _payoff(y1, strike, kind)
    if t >= n_dates:
        return ex
    cont = torch.clamp((_sfeatures(y1 / strike, y2 / strike, ex / strike) @ scoefs[t]) * strike,
                       0.0, vmax)
    return torch.maximum(ex, cont)


def _upper_pipeline(scoefs, generator, spots, vols, chol, strike, maturity, rate, dividend,
                    n_dates, n_outer, n_inner, kind):
    dt = maturity / n_dates
    drift = (rate - dividend - 0.5 * vols * vols) * dt
    sig_sdt = vols * math.sqrt(dt)
    s_out = _simulate_dates(generator, spots, vols, chol, rate, dividend, maturity, n_dates,
                            n_outer)
    half = n_inner // 2
    d = spots.shape[0]
    # the wing cap must be a deterministic constant (peeking at the paths
    # would break the dual's martingale property): a generous 8-sigma
    # envelope of the terminal max
    if kind == "min_put":
        vmax = strike  # a put on the min is worth at most K
    else:
        vmax = float(spots.max()) * math.exp(
            (abs(rate - dividend) + 8.0 * float(vols.max()) / math.sqrt(maturity)) * maturity)
    y1_0, _ = _order_stats(s_out[0], kind)
    best = _payoff(y1_0, strike, kind)
    m_t = torch.zeros(n_outer, dtype=torch.float32, device=spots.device)
    for t in range(1, n_dates + 1):
        df_t = math.exp(-rate * dt * t)
        vk = df_t * _surface_value(scoefs, t, s_out[t], strike, n_dates, vmax, kind)
        # antithetic one-date inner transitions from X_{t-1}
        z = torch.randn((n_outer, half, d), generator=generator, dtype=torch.float32,
                        device=spots.device)
        step = drift + sig_sdt * (z @ chol.T)
        s_prev = s_out[t - 1][:, None, :]
        s_in = torch.cat([s_prev * torch.exp(step), s_prev * torch.exp(2.0 * drift - step)],
                         dim=1)
        v_in = _surface_value(scoefs, t, s_in, strike, n_dates, vmax, kind)
        m_t = m_t + vk - df_t * v_in.mean(dim=1)
        y1, _ = _order_stats(s_out[t], kind)
        best = torch.maximum(best, df_t * _payoff(y1, strike, kind) - m_t)
    return best.mean(), best.std(correction=1) / math.sqrt(n_outer)


def max_call_upper(scoefs, generator: torch.Generator, spots, strike, maturity, rate, vols,
                   dividend: float = 0.0, corr=None, n_dates: int = 9, n_outer: int = 2048,
                   n_inner: int = 512, kind: str = "max_call"):
    """Value-surface dual upper bound: (upper, stderr) as floats."""
    d = len(np.atleast_1d(spots))
    dev = generator.device
    spots_t, vols_t, chol = _setup(spots, vols, corr, d, dev)
    m, se = _upper_pipeline(_coef_tensor(scoefs, dev), generator, spots_t, vols_t, chol,
                            float(strike), float(maturity), float(rate), float(dividend),
                            n_dates, n_outer, n_inner, kind)
    return float(m), float(se)


def max_call_bracket(spots, strike, maturity, rate, vols, dividend: float = 0.0, corr=None,
                     n_dates: int = 9, n_fit: int = 100_000, n_lower: int = 200_000,
                     n_outer: int = 2048, n_inner: int = 512, seed: int = 0,
                     kind: str = "max_call", device="cuda") -> dict:
    """Certified Bermudan max-call (or min-put) bracket on d correlated
    assets.

    Returns {lower, lower_se, upper, upper_se, width, n_dates, kind}: the
    Bermudan value on the ``n_dates`` grid lies in [lower, upper] up to the
    quoted MC stderrs. The defaults are the Broadie–Glasserman /
    Andersen–Broadie setup's grid (T = 3, 9 exercise dates). The fit, the
    lower and the upper pipeline draw in turn from one generator seeded with
    ``seed`` on ``device``, so the policy is valued out of sample."""
    if float(maturity) <= 0:
        raise ValidationError("maturity must be positive")
    if kind not in KINDS:
        raise ValidationError(f"kind must be max_call|min_put: {kind!r}")
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    coefs, scoefs = fit_max_call_lsm(spots, strike, maturity, rate, vols, gen, dividend, corr,
                                     n_dates, n_fit, kind=kind)
    lo, lo_se = max_call_lower(coefs, gen, spots, strike, maturity, rate, vols, dividend, corr,
                               n_dates, n_lower, kind=kind)
    up, up_se = max_call_upper(scoefs, gen, spots, strike, maturity, rate, vols, dividend, corr,
                               n_dates, n_outer, n_inner, kind=kind)
    return {"lower": lo, "lower_se": lo_se, "upper": up, "upper_se": up_se, "width": up - lo,
            "n_dates": n_dates, "kind": kind}
