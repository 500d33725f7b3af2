"""Certified [lower, upper] bracket for American puts under rough Bergomi:
duality on a non-Markovian law through exact conditional Gaussians.

The port of ``optionslab_tpu/models/rbergomi_american.py``. Paths come from
the causal (time-interleaved) Cholesky factor of the exact (V~, W)
covariance (``rbergomi._volterra_chol_causal``), so each path is its iid
coordinate vector e and the law of any future block given F_{t_k} is an
explicit Gaussian: mean L[rows, :2k] e_past, factor L[rows, 2k:]. The dual's
inner transitions are one masked product (the conditional mean) plus a
small fresh-block product; a gradient control variate with exactly
zero-mean anchors removes the linear part of the inner noise. Regressions
use (S, v, m) features, m_k = E[V~_{t_{k+1}} | F_{t_k}].

The bracket certifies the Bermudan value of the discrete left-point
rBergomi law on the (n_dates × n_sub)-step grid, plus the interest-on-strike
pad. It runs on ``device``, all products in full float32 (checked, as in
``models/rbergomi.py``); the LSM solves are float64 on the host, as in the
reference. Random numbers: one ``torch.Generator`` seeded ``seed``, drawn in
turn by the fit, the lower bound and the dual (the reference splits its key
in three and folds 7 into the dual's).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.exceptions import ValidationError
from .american import _mean_se
from .heston_american import _stack
from .rbergomi import F32, RBergomiParams, _matmul_t, _volterra_chol_causal

__all__ = ["RBergomiPolicy", "fit_rbergomi_lsm", "rbergomi_lsm_lower", "rbergomi_dual_upper",
           "rbergomi_american_bracket"]

N_FEAT = 12
N_SFEAT = 16


class RBergomiPolicy(NamedTuple):
    """The standardised ITM policy fit: coefficients, feature means and
    feature scales, each (n_dates+1, 12)."""

    coefs: torch.Tensor
    mus: torch.Tensor
    sds: torch.Tensor

    @classmethod
    def from_numpy(cls, coefs, mus, sds, device=None) -> "RBergomiPolicy":
        """A policy fitted by the JAX package (numpy arrays), float32."""
        return cls(*(torch.as_tensor(np.array(a, np.float32), device=device)
                     for a in (coefs, mus, sds)))


def _features(s, v, m, ex, xp=torch):
    """Policy basis (ITM-only fit): polynomials in (moneyness, variance,
    forward-Volterra mean m) and the payoff kink; torch tensors, or numpy
    arrays with ``xp=np``."""
    s2 = s * s
    return _stack(xp, [xp.ones_like(s), s, s2, s2 * s, v, v * v, s * v, s2 * v, ex, m, m * m,
                       s * m])


def _sfeatures(s, v, m, ex, xp=torch):
    """The richer all-path basis of the dual's value surface."""
    s2 = s * s
    return _stack(xp, [xp.ones_like(s), s, s2, s2 * s, s2 * s2, v, v * v, s * v, s2 * v, ex,
                       ex * s, ex * v, m, m * m, s * m, v * m])


def _m_readout_matrix(lc: np.ndarray, n_dates: int, n_sub: int):
    """(n_dates+1, 2n) host matrix M with m_d = M[d] @ e, the conditional mean
    E[V~_{t_{(d+1)·n_sub}} | F_{t_{d·n_sub}}]: row 2(j_next−1) of the causal
    factor with the columns of the date's future zeroed. Rows 0 and n_dates
    are zero."""
    n = n_dates * n_sub
    out = np.zeros((n_dates + 1, 2 * n), np.float32)
    for d in range(1, n_dates):
        j_next = (d + 1) * n_sub
        row = lc[2 * (j_next - 1)].copy()
        row[2 * d * n_sub:] = 0.0
        out[d] = row
    return out


def _draw(generator, n_paths: int, n: int):
    """(e, zp): the antithetic causal coordinates (paths, 2n), then the
    orthogonal spot block (paths, n)."""
    half = n_paths // 2
    dev = generator.device
    e = torch.randn((half, 2 * n), generator=generator, dtype=F32, device=dev)
    zp = torch.randn((half, n), generator=generator, dtype=F32, device=dev)
    return torch.cat([e, -e]), torch.cat([zp, -zp])


def _simulate_dates(e, zp, spot, eta, rho, xi0, rate, *, hurst, maturity, n_dates, n_sub):
    """Exact-law paths at every exercise date from the normals (e, zp):
    (s, v, m, w, e), s/v/m/w of shape (n_dates+1, paths) — spot, variance,
    the forward-Volterra feature and the W level at the dates."""
    dev = e.device
    n_paths = e.shape[0]
    n = n_dates * n_sub
    spot, eta, rho, xi0, rate = (torch.as_tensor(a, dtype=F32, device=dev)
                                 for a in (spot, eta, rho, xi0, rate))
    lc_np = _volterra_chol_causal(n, hurst, float(maturity))
    lc = torch.as_tensor(lc_np, device=dev)
    mmat = torch.as_tensor(_m_readout_matrix(lc_np, n_dates, n_sub), device=dev)
    t_grid = torch.as_tensor(np.linspace(maturity / n, maturity, n).astype(np.float32),
                             device=dev)
    dt = torch.as_tensor(maturity / n, dtype=F32, device=dev)
    g = _matmul_t(e, lc)
    v_tilde, w_lvl = g[:, 0::2], g[:, 1::2]
    dw = torch.diff(w_lvl, dim=1, prepend=torch.zeros_like(w_lvl[:, :1]))
    v_grid = xi0 * torch.exp(eta * v_tilde - 0.5 * eta**2 * t_grid[None, :] ** (2.0 * hurst))
    v_left = torch.cat([torch.full_like(v_grid[:, :1], float(xi0)), v_grid[:, :-1]], dim=1)
    srho = torch.sqrt(torch.clamp_min(1.0 - rho**2, 0.0))
    dz = rho * dw + srho * torch.sqrt(dt) * zp
    x = torch.cumsum(torch.sqrt(v_left) * dz - 0.5 * v_left * dt, dim=1) \
        + rate * t_grid[None, :]
    cols = torch.as_tensor(n_sub * np.arange(1, n_dates + 1) - 1, device=dev)

    def dates(first, rows):
        return torch.cat([torch.full((1, n_paths), float(first), dtype=F32, device=dev), rows.T])

    s = dates(spot, spot * torch.exp(x[:, cols]))
    v = dates(xi0, v_grid[:, cols])
    w = dates(0.0, w_lvl[:, cols])
    m = _matmul_t(mmat, e)
    return s, v, m, w, e


def _sim(generator, params: RBergomiParams, spot, rate, maturity, n_dates, n_sub, n_paths):
    e, zp = _draw(generator, n_paths, n_dates * n_sub)
    return _simulate_dates(e, zp, float(spot), float(params.eta), float(params.rho),
                           float(params.xi0), float(rate), hurst=float(params.hurst),
                           maturity=float(maturity), n_dates=n_dates, n_sub=n_sub)


def _fit_from_paths(s, v, m, strike, maturity, rate, cp, n_dates):
    """Backward-induction LSM on (S, v, m), float64 on the host, with the
    per-date standardisation of the policy features kept apart (folding it
    into the coefficients recreates the huge cancelling terms float32 cannot
    evaluate). Returns (RBergomiPolicy, surface coefficients) on the paths'
    device."""
    dev = s.device
    s, v, m = (a.double().cpu().numpy() for a in (s, v, m))
    k_ = float(strike)
    disc = math.exp(-float(rate) * float(maturity) / n_dates)
    cash = np.maximum(cp * (s[-1] - k_), 0.0)
    coefs = np.zeros((n_dates + 1, N_FEAT))
    mus = np.zeros((n_dates + 1, N_FEAT))
    sds = np.ones((n_dates + 1, N_FEAT))
    scoefs = np.zeros((n_dates + 1, N_SFEAT))
    for d in range(n_dates - 1, 0, -1):
        cash *= disc
        ex = np.maximum(cp * (s[d] - k_), 0.0)
        sbasis = _sfeatures(s[d] / k_, v[d], m[d], ex / k_, xp=np)
        ata = sbasis.T @ sbasis + 1e-7 * len(ex) * np.eye(N_SFEAT)
        scoefs[d] = np.linalg.solve(ata, sbasis.T @ (cash / k_))
        itm = ex > 0
        if itm.sum() > 10 * N_FEAT:
            basis = _features(s[d, itm] / k_, v[d, itm], m[d, itm], ex[itm] / k_, xp=np)
            mu = basis.mean(axis=0)
            sd = np.maximum(basis.std(axis=0), 1e-12)
            mu[0], sd[0] = 0.0, 1.0  # keep the intercept
            b = (basis - mu) / sd
            ata = b.T @ b + 1e-6 * len(b) * np.eye(N_FEAT)
            coef = np.linalg.solve(ata, b.T @ (cash[itm] / k_))
            coefs[d], mus[d], sds[d] = coef, mu, sd
            take = ex[itm] > b @ coef * k_
            idx = np.where(itm)[0][take]
            cash[idx] = ex[idx]
    return (RBergomiPolicy.from_numpy(coefs, mus, sds, device=dev),
            torch.as_tensor(scoefs.astype(np.float32), device=dev))


def fit_rbergomi_lsm(spot, strike, maturity, rate, params: RBergomiParams,
                     generator: torch.Generator, cp: float = -1.0, n_dates: int = 25,
                     n_sub: int = 2, n_paths: int = 65_536):
    """LSM on (S, v, m) features over paths drawn on the generator's device:
    (RBergomiPolicy, surface coefficients)."""
    if cp > 0:
        raise ValidationError("bracket supports puts (cp=-1) only")
    params.validate()
    s, v, m, _, _ = _sim(generator, params, spot, rate, maturity, n_dates, n_sub, n_paths)
    return _fit_from_paths(s, v, m, strike, maturity, rate, cp, n_dates)


def _exercise_now(policy, d, s, v, m, strike, cp, n_dates):
    coefs, mus, sds = policy
    ex = torch.clamp_min(cp * (s - strike), 0.0)
    if d >= n_dates:
        return ex, ex > 0.0
    feat = (_features(s / strike, v, m, ex / strike) - mus[d]) / sds[d]
    return ex, (ex > 0.0) & (ex > (feat @ coefs[d]) * strike)


def _surface_value(scoefs, d, s, v, m, strike, cp, n_dates):
    ex = torch.clamp_min(cp * (s - strike), 0.0)
    if d >= n_dates:
        return ex
    cont = torch.clamp((_sfeatures(s / strike, v, m, ex / strike) @ scoefs[d]) * strike, 0.0,
                       strike)
    return torch.maximum(ex, cont)


def _lower_pipeline(policy, generator, spot, strike, maturity, rate, params, cp, n_dates, n_sub,
                    n_paths):
    s, v, m, _, _ = _sim(generator, params, spot, rate, maturity, n_dates, n_sub, n_paths)
    dt = maturity / n_dates
    alive = torch.ones(s.shape[1], dtype=torch.bool, device=s.device)
    cash = torch.zeros(s.shape[1], dtype=F32, device=s.device)
    for d in range(1, n_dates + 1):
        ex, take = _exercise_now(policy, d, s[d], v[d], m[d], strike, cp, n_dates)
        cash = torch.where(alive & take, math.exp(-rate * dt * d) * ex, cash)
        alive = alive & ~take
    return _mean_se(cash)


def rbergomi_lsm_lower(policy, generator: torch.Generator, spot, strike, maturity, rate,
                       params: RBergomiParams, cp: float = -1.0, n_dates: int = 25,
                       n_sub: int = 2, n_paths: int = 131_072):
    """Out-of-sample policy value: (lower bound, stderr) as Python floats."""
    m, se = _lower_pipeline(policy, generator, float(spot), float(strike), float(maturity),
                            float(rate), params, float(cp), n_dates, n_sub, n_paths)
    return float(m), float(se)


def _upper_pipeline(scoefs, generator, spot, strike, maturity, rate, params, cp, n_dates, n_sub,
                    n_outer, n_inner):
    """The value-surface dual on the exact conditional Gaussian law: at date
    k the inner samples of the date-k state given the outer past are drawn
    from rows 2j0..2j1−1 of the causal factor (the mean from the masked past,
    the fresh part from the in-block columns), and the surface's gradient at
    the exactly-known conditional means of (S, v, m) is a zero-mean control
    variate."""
    dev = generator.device
    hurst, eta, rho, xi0 = (float(params.hurst), float(params.eta), float(params.rho),
                            float(params.xi0))
    n = n_dates * n_sub
    lc = torch.as_tensor(_volterra_chol_causal(n, hurst, float(maturity)), device=dev)
    dt_sub = np.float32(maturity / n)
    dt = maturity / n_dates
    srho = math.sqrt(max(1.0 - np.float32(rho) ** 2, 0.0))
    s_out, v_out, m_out, w_out, e_out = _sim(generator, params, spot, rate, maturity, n_dates,
                                             n_sub, n_outer)
    half = n_inner // 2
    col_idx = torch.arange(2 * n, device=dev)

    def inner_states(k, zeta, zp_in):
        """(s, v, m) at date k for the inner draws (n_outer, q, ...) given the
        outer past, and the exact conditional means (E v_k, E m_k)."""
        j0 = (k - 1) * n_sub
        e_masked = torch.where((col_idx < 2 * j0)[None, :], e_out, 0.0)
        lrows = lc[2 * j0:2 * j0 + 2 * n_sub]
        mu = _matmul_t(e_masked, lrows)  # (n_outer, 2 n_sub)
        a_blk = lrows[:, 2 * j0:2 * j0 + 2 * n_sub]
        g_fresh = mu[:, None, :] + torch.matmul(zeta, a_blk.T)
        vt_in, w_in = g_fresh[..., 0::2], g_fresh[..., 1::2]
        # the m feature of the inner date-k states: V~ at grid j1 + n_sub
        # given (outer past, fresh block); unused (0) at the last date
        j1 = k * n_sub
        lm = lc[min(2 * (j1 + n_sub - 1), 2 * n - 2)]
        mu_m = _matmul_t(e_masked, lm[None, :])[:, 0]
        a_m = lm[2 * j0:2 * j0 + 2 * n_sub]
        m_in = mu_m[:, None] + torch.matmul(zeta, a_m)
        if k >= n_dates:
            m_in = torch.zeros_like(m_in)
        # the control variate's anchors: v_k lognormal in the last fresh V~
        # coordinate, m_k linear in it
        idx_v = 2 * (n_sub - 1)
        t_k = dt_sub * np.float32(j0 + n_sub)
        ev = xi0 * torch.exp(eta * mu[:, idx_v] + 0.5 * eta**2 * (torch.sum(a_blk[idx_v] ** 2)
                                                                  - t_k ** (2.0 * hurst)))
        em = torch.zeros_like(mu_m) if k >= n_dates else mu_m
        # the left-point spot integral over the date's substeps
        x = torch.log(s_out[k - 1] / spot)[:, None]
        v_left = v_out[k - 1][:, None]
        w_prev = w_out[k - 1][:, None]
        for j in range(n_sub):
            dz = rho * (w_in[..., j] - w_prev) + srho * math.sqrt(dt_sub) * zp_in[..., j]
            x = x + rate * dt_sub - 0.5 * v_left * dt_sub + torch.sqrt(v_left) * dz
            t_j = dt_sub * np.float32(j0 + j + 1)
            v_left = xi0 * torch.exp(eta * vt_in[..., j] - 0.5 * eta**2 * t_j ** (2.0 * hurst))
            w_prev = w_in[..., j]
        return spot * torch.exp(x), v_left, m_in, ev, em

    m_k = torch.zeros(n_outer, dtype=F32, device=dev)
    best = torch.full((n_outer,), max(cp * (spot - strike), 0.0), dtype=F32, device=dev)
    for k in range(1, n_dates + 1):
        df_k = math.exp(-rate * dt * k)
        vk = df_k * _surface_value(scoefs, k, s_out[k], v_out[k], m_out[k], strike, cp, n_dates)
        zeta = torch.randn((n_outer, half, 2 * n_sub), generator=generator, dtype=F32,
                           device=dev)
        zp_in = torch.randn((n_outer, half, n_sub), generator=generator, dtype=F32, device=dev)
        zeta, zp_in = torch.cat([zeta, -zeta], dim=1), torch.cat([zp_in, -zp_in], dim=1)
        s_in, v_in, m_in, ev, em = inner_states(k, zeta, zp_in)
        es = s_out[k - 1] * math.exp(rate * dt)  # the exact martingale
        # the surface's gradient at each outer path's anchor (rows independent)
        svm = torch.stack([es, ev, em], dim=-1).requires_grad_(True)
        with torch.enable_grad():
            val = _surface_value(scoefs, k, svm[:, 0], svm[:, 1], svm[:, 2], strike, cp,
                                 n_dates)
            (g,) = torch.autograd.grad(val.sum(), svm)
        val_in = _surface_value(scoefs, k, s_in, v_in, m_in, strike, cp, n_dates)
        cv = (g[:, 0:1] * (s_in - es[:, None]) + g[:, 1:2] * (v_in - ev[:, None])
              + g[:, 2:3] * (m_in - em[:, None]))
        m_k = m_k + vk - df_k * (val_in - cv).mean(dim=1)
        ex_k = torch.clamp_min(cp * (s_out[k] - strike), 0.0)
        best = torch.maximum(best, df_k * ex_k - m_k)
    return _mean_se(best)


def rbergomi_dual_upper(scoefs, generator: torch.Generator, spot, strike, maturity, rate,
                        params: RBergomiParams, cp: float = -1.0, n_dates: int = 25,
                        n_sub: int = 2, n_outer: int = 512, n_inner: int = 1024):
    """Value-surface dual upper bound: (upper, stderr) as Python floats."""
    m, se = _upper_pipeline(scoefs, generator, float(spot), float(strike), float(maturity),
                            float(rate), params, float(cp), n_dates, n_sub, n_outer, n_inner)
    return float(m), float(se)


def rbergomi_american_bracket(spot, strike, maturity, rate, params: RBergomiParams,
                              cp: float = -1.0, n_dates: int = 25, n_sub: int = 2,
                              n_fit: int = 65_536, n_lower: int = 131_072, n_outer: int = 512,
                              n_inner: int = 1024, seed: int = 0, device="cuda") -> dict:
    """Certified Bermudan bracket under rough Bergomi plus the continuous pad,
    on ``device``: {lower, lower_se, upper, upper_se, width, pad,
    continuous_upper, n_dates} as Python numbers."""
    if cp > 0:
        raise ValidationError("bracket supports puts (cp=-1) only")
    params.validate()
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    pol, sur = fit_rbergomi_lsm(spot, strike, maturity, rate, params, gen, cp, n_dates, n_sub,
                                n_fit)
    lo, lo_se = rbergomi_lsm_lower(pol, gen, spot, strike, maturity, rate, params, cp, n_dates,
                                   n_sub, n_lower)
    up, up_se = rbergomi_dual_upper(sur, gen, spot, strike, maturity, rate, params, cp, n_dates,
                                    n_sub, n_outer, n_inner)
    pad = max(float(strike) * (1.0 - math.exp(-float(rate) * float(maturity) / n_dates)), 0.0)
    return {"lower": lo, "lower_se": lo_se, "upper": up, "upper_se": up_se, "width": up - lo,
            "pad": pad, "continuous_upper": up + pad, "n_dates": n_dates}
