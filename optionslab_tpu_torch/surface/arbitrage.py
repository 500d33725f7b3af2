"""Static no-arbitrage checks and post-hoc enforcement for vol surfaces.

The port of ``optionslab_tpu/surface/arbitrage.py``:

* :func:`butterfly_check` — Gatheral's density function g(k) from
  non-uniform finite differences of w(k); :func:`calendar_check` — w(T)
  non-decreasing per strike; :func:`surface_arbitrage_report` — both over a
  whole surface; :func:`validate_domain` — a plausibility score.
* :func:`isotonic_pava` / :func:`enforce_calendar` — the exact
  pool-adjacent-violators projection, host numpy (sequential pooling);
  :func:`enforce_convexity` — a fixed number of sweeps lifting each concave
  triple's midpoint to the chord, whole-tensor ops on the device with no
  host synchronisation; :func:`correct_arbitrage` — both.

The checks run on the device of their tensor inputs, or on ``device``
(default the card) for numbers and numpy arrays, in the inputs' floating
dtype (numpy float64 stays float64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import input_device, input_tensors


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def butterfly_check(log_strikes, total_variance, tol: float = 1e-8, device=None):
    """g(k) ≥ 0 via non-uniform finite differences of w(k), along the last
    axis of ``total_variance``. Returns (g values, violation mask)."""
    k, w = input_tensors(log_strikes, total_variance, device=device)
    dk_f = k[..., 2:] - k[..., 1:-1]
    dk_b = k[..., 1:-1] - k[..., :-2]
    wp = (w[..., 2:] - w[..., :-2]) / (dk_f + dk_b)
    wpp = 2.0 * (dk_b * w[..., 2:] - (dk_f + dk_b) * w[..., 1:-1] + dk_f * w[..., :-2]) / (
        dk_f * dk_b * (dk_f + dk_b)
    )
    w_mid = torch.clamp_min(w[..., 1:-1], 1e-12)
    k_mid = k[..., 1:-1]
    g = (1.0 - k_mid * wp / (2.0 * w_mid)) ** 2 - 0.25 * wp**2 * (1.0 / w_mid + 0.25) + 0.5 * wpp
    return g, g < -tol


def calendar_check(maturities, total_variance, tol: float = 1e-8, device=None):
    """w(k, T) non-decreasing in T per strike. total_variance: (n_T, n_K).

    Returns (dw/dT forward differences, violation mask)."""
    t, w = input_tensors(maturities, total_variance, device=device)
    t = t.reshape(-1, 1)
    dw = (w[1:] - w[:-1]) / torch.clamp_min(t[1:] - t[:-1], 1e-12)
    return dw, dw < -tol


def _surface_w(log_strikes, maturities, iv_surface, device):
    k, t, iv = input_tensors(log_strikes, maturities, iv_surface, device=device)
    return k, t, iv * iv * t.reshape(-1, 1)


def surface_arbitrage_report(log_strikes, maturities, iv_surface, device=None) -> dict:
    """Full-surface audit: violation rates + arb-free flag (the metric the
    benchmark harness reports as arb-free %)."""
    k, t, w = _surface_w(log_strikes, maturities, iv_surface, device)
    _, cal_mask = calendar_check(t, w)
    _, bf_mask = butterfly_check(k, w)
    bf_rows = bf_mask.to(w.dtype).mean(dim=-1).cpu().numpy()
    cal_rate = float(cal_mask.to(w.dtype).mean())
    bf_rate = float(np.mean(bf_rows))
    return {
        "calendar_violation_rate": cal_rate,
        "butterfly_violation_rate": bf_rate,
        "arbitrage_free": cal_rate == 0.0 and bf_rate == 0.0,
    }


def validate_domain(moneyness, maturity, iv) -> float:
    """Heuristic plausibility score in [0,1]: penalizes IVs outside
    [1%, 300%], extreme moneyness, and non-finite values (host numpy)."""
    m = np.asarray(_host(moneyness), np.float64)
    t = np.asarray(_host(maturity), np.float64)
    v = np.asarray(_host(iv), np.float64)
    checks = [
        np.mean((v > 0.01) & (v < 3.0)),
        np.mean((m > 0.2) & (m < 5.0)),
        np.mean((t > 0) & (t < 30.0)),
        np.mean(np.isfinite(v)),
    ]
    return float(np.mean(checks))


# ---------------------------------------------------------------------------
# Enforcement (projections)
# ---------------------------------------------------------------------------
def isotonic_pava(y, weights=None):
    """Exact pool-adjacent-violators projection onto non-decreasing sequences
    (host numpy, sequential pooling); :func:`enforce_calendar` applies it per
    strike column."""
    y = np.asarray(_host(y), np.float64).copy()
    w = np.ones_like(y) if weights is None else np.asarray(_host(weights), np.float64).copy()
    n = y.size
    vals, wts, cnts = [], [], []
    for i in range(n):
        vals.append(y[i]); wts.append(w[i]); cnts.append(1)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v2, w2, c2 = vals.pop(), wts.pop(), cnts.pop()
            v1, w1, c1 = vals.pop(), wts.pop(), cnts.pop()
            vals.append((v1 * w1 + v2 * w2) / (w1 + w2))
            wts.append(w1 + w2)
            cnts.append(c1 + c2)
    out = np.empty(n)
    pos = 0
    for v, c in zip(vals, cnts):
        out[pos:pos + c] = v
        pos += c
    return out


def enforce_calendar(total_variance):
    """Project each strike column of w(T, K) onto non-decreasing-in-T."""
    w = np.asarray(_host(total_variance), np.float64)
    return np.stack([isotonic_pava(w[:, j]) for j in range(w.shape[1])], axis=1)


def enforce_convexity(y, n_iter: int = 200, device=None):
    """Iterative projection of sequences (the last axis) onto discrete
    convexity (second differences ≥ 0): ``n_iter`` sweeps, each lifting the
    midpoint of every concave triple to its chord, all from the previous
    sweep's values. Whole-tensor ops, no host synchronisation."""
    (v,) = input_tensors(y, device=device)
    for _ in range(int(n_iter)):
        mid = torch.minimum(v[..., 1:-1], 0.5 * (v[..., :-2] + v[..., 2:]))
        v = torch.cat([v[..., :1], mid, v[..., -1:]], dim=-1)
    return v


def detect_arbitrage_violations(log_strikes, maturities, iv_surface, device=None) -> dict:
    """Boolean masks per violation type, as numpy arrays."""
    k, t, w = _surface_w(log_strikes, maturities, iv_surface, device)
    _, cal = calendar_check(t, w)
    _, bf = butterfly_check(k, w)
    return {"calendar": cal.cpu().numpy(), "butterfly": bf.cpu().numpy()}


def correct_arbitrage(log_strikes, maturities, iv_surface, convexity_iters: int = 200,
                      device=None):
    """Calendar PAVA + per-slice convexity repair of w, returning the
    corrected IV surface as a float64 numpy array."""
    iv = np.asarray(_host(iv_surface), np.float64)
    t = np.asarray(_host(maturities), np.float64).reshape(-1, 1)
    w = enforce_calendar(iv * iv * t)
    dev = device if device is not None else input_device(log_strikes, maturities, iv_surface)
    w = enforce_convexity(w, convexity_iters, device=dev).cpu().numpy()
    w = np.maximum(w, 1e-10)
    return np.sqrt(w / np.maximum(t, 1e-12))
