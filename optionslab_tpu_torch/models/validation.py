"""Pricing validation: parity, bounds, Greek consistency, MC convergence.

The port of ``optionslab_tpu/models/validation.py``: put–call parity,
European no-arbitrage bounds, the sign and range of Greeks, the butterfly
check of one smile slice, an empirical σ ~ 1/√N Monte Carlo study and a
random-sweep pricer audit. The checks run on the device of their tensor
inputs (else ``device``, by default the card) in their inputs' floating
dtype; results are Python numbers and numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import ContractBatch
from ..utils.config import input_device, input_tensors
from .black_scholes import bs_price
from .monte_carlo import MCConfig, mc_price_result



def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_put_call_parity(call_price, put_price, spot, strike, maturity, rate,
                          dividend=0.0, atol: float = 1e-5, device=None) -> dict:
    """C − P = S·e^{−qT} − K·e^{−rT}."""
    c, p, s, k, t, r, q = input_tensors(call_price, put_price, spot, strike, maturity, rate,
                                        dividend, device=device)
    err = torch.abs((c - p) - (s * torch.exp(-q * t) - k * torch.exp(-r * t)))
    return {
        "passed": bool(torch.all(err <= atol)),
        "max_error": float(torch.max(err)),
        "errors": _host(err),
    }


def check_price_bounds(price, spot, strike, maturity, rate, cp=1.0, dividend=0.0,
                       atol: float = 1e-10, device=None) -> dict:
    """European no-arbitrage bounds:
    call: max(S·e^{-qT} - K·e^{-rT}, 0) <= C <= S·e^{-qT}
    put:  max(K·e^{-rT} - S·e^{-qT}, 0) <= P <= K·e^{-rT}
    """
    p, s, k, t, r, cp, q = input_tensors(price, spot, strike, maturity, rate, cp, dividend,
                                         device=device)
    s, k = s * torch.exp(-q * t), k * torch.exp(-r * t)
    lower = torch.clamp_min(cp * (s - k), 0.0)
    upper = torch.where(cp > 0, s, k)
    ok = (p >= lower - atol) & (p <= upper + atol)
    return {"passed": bool(torch.all(ok)), "violations": _host(~ok)}


def check_greeks_consistency(greeks: dict, cp=1.0) -> dict:
    """Sign/range sanity: 0 ≤ Δ_call ≤ 1, −1 ≤ Δ_put ≤ 0, Γ ≥ 0, vega ≥ 0;
    rho's sign follows cp (host numpy)."""
    cp = _host(cp)
    delta = _host(greeks["delta"])
    issues = []
    if np.any((cp > 0) & ((delta < -1e-9) | (delta > 1 + 1e-9))):
        issues.append("call delta outside [0, 1]")
    if np.any((cp < 0) & ((delta < -1 - 1e-9) | (delta > 1e-9))):
        issues.append("put delta outside [-1, 0]")
    if "gamma" in greeks and np.any(_host(greeks["gamma"]) < -1e-9):
        issues.append("negative gamma")
    if "vega" in greeks and np.any(_host(greeks["vega"]) < -1e-9):
        issues.append("negative vega")
    if "rho" in greeks and np.any(np.sign(_host(greeks["rho"])) * cp < -1e-9):
        issues.append("rho sign inconsistent with option type")
    return {"passed": not issues, "issues": issues}


def check_smile_butterfly(log_strikes, total_variance, tol: float = 1e-8, device=None) -> dict:
    """Butterfly (density) positivity on one smile slice: the surface
    module's non-uniform-grid check."""
    from ..surface.arbitrage import butterfly_check

    g, mask = butterfly_check(log_strikes, total_variance, tol, device=device)
    return {
        "passed": not bool(torch.any(mask)),
        "min_g": float(torch.min(g)),
        "violations": _host(mask),
    }


def mc_convergence_study(spot=100.0, strike=100.0, maturity=1.0, rate=0.05,
                         vol=0.2, path_counts=(1_000, 4_000, 16_000, 64_000),
                         seed: int = 0, antithetic: bool = False, device="cuda") -> dict:
    """Empirical σ ~ 1/√N harness: per path count N (the i-th drawn from a
    generator seeded ``seed + i``), the absolute error against Black–Scholes
    and the stderr, and the fitted log-log slope of the stderrs (≈ −0.5)."""
    exact = float(bs_price(spot, strike, maturity, rate, vol, 1.0, 0.0))
    batch = ContractBatch.make(spot, strike, maturity, rate, vol, "call", device=device)
    errors, stderrs = [], []
    for i, n in enumerate(path_counts):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        res = mc_price_result(batch, gen, MCConfig(n_paths=int(n), antithetic=antithetic))
        errors.append(abs(float(res.price) - exact))
        stderrs.append(float(res.std_error))
    log_n = np.log(np.asarray(path_counts, np.float64))
    log_se = np.log(np.asarray(stderrs, np.float64))
    slope = float(np.polyfit(log_n, log_se, 1)[0])
    return {
        "path_counts": list(path_counts),
        "abs_errors": errors,
        "stderrs": stderrs,
        "stderr_slope": slope,  # ≈ -0.5
        "converged": bool(abs(slope + 0.5) < 0.15),
    }


def validate_pricer(price_fn, n_points: int = 32, seed: int = 0,
                    atol_parity: float = 5e-3, atol_bounds: float = 1e-10,
                    device=None) -> dict:
    """End-to-end pricer audit: a random parameter sweep (numpy, ``seed``)
    through parity, bounds, and Greek checks. ``price_fn(S, K, T, r, sigma,
    cp, q) -> price`` gets numpy arrays; the checks run on its answers'
    device (``device`` when it answers with numpy)."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(50, 150, n_points)
    K = rng.uniform(50, 150, n_points)
    T = rng.uniform(0.05, 2.0, n_points)
    r = rng.uniform(0.0, 0.08, n_points)
    sig = rng.uniform(0.1, 0.5, n_points)
    calls = price_fn(S, K, T, r, sig, 1.0, 0.0)
    puts = price_fn(S, K, T, r, sig, -1.0, 0.0)
    if device is None:
        device = input_device(calls, puts)
    parity = check_put_call_parity(calls, puts, S, K, T, r, atol=atol_parity, device=device)
    bounds_c = check_price_bounds(calls, S, K, T, r, 1.0, atol=atol_bounds, device=device)
    bounds_p = check_price_bounds(puts, S, K, T, r, -1.0, atol=atol_bounds, device=device)
    return {
        "parity": parity,
        "call_bounds": bounds_c,
        "put_bounds": bounds_p,
        "passed": parity["passed"] and bounds_c["passed"] and bounds_p["passed"],
    }
