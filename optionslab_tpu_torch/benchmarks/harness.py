"""Vol-surface benchmark harness: error / speed / stability across models.

The port of ``optionslab_tpu/benchmarks/harness.py``: a registry of unified
``calibrate/predict/get_params`` wrappers (SVI, SSVI, eSSVI, SABR, MLP,
kernel ridge, random forest, PINN) over the port's own models;
``ErrorMetrics`` (RMSE/MAE/MAPE/max, ATM |k| < 0.05 and wing |k| > 0.2
splits, term-structure error), ``SpeedMetrics`` (calibration and prediction
ms, smiles/s), ``StabilityMetrics`` (parameter CV across trials,
arbitrage-free %, convergence %), ``run(data, n_trials)``, the results table
and the best-model pick; and the EPP (exploitable profit proxy): the
discounted butterfly-violation mass of the dense predicted smile.

Every wrapper fits on the harness's ``device`` (the card unless the caller
asks for the CPU; the random forest is a host model). Timings synchronise the
device around each fit and each prediction. The results table follows the
port's frame rule: a pandas DataFrame where pandas is installed, else the
column table; :meth:`VolSurfaceBenchmark.records` gives the rows as dicts
either way.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable

import numpy as np
import torch

from ..data._table import ColumnTable, to_frame
from ..risk._frames import host
from ..surface.arbitrage import butterfly_check
from ..utils.exceptions import OptionsLabTPUError
from ..utils.logging import get_logger

__all__ = ["VolSurfaceBenchmark", "ErrorMetrics", "SpeedMetrics", "StabilityMetrics",
           "BenchmarkEntry", "compute_epp", "surface_epp"]

logger = get_logger(__name__)

# what a trial's fit may raise and still count as not converged: the port's
# own errors and numerical failures (a CUDA error is not among them)
FIT_FAILURES = (OptionsLabTPUError, ValueError, ArithmeticError, np.linalg.LinAlgError,
                torch.linalg.LinAlgError)


# ---------------------------------------------------------------------------
# Metric dataclasses
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ErrorMetrics:
    rmse: float
    mae: float
    mape: float
    max_error: float
    atm_rmse: float
    wing_rmse: float
    term_rmse: float

    @classmethod
    def from_predictions(cls, k, t, pred, truth):
        k = host(k).ravel()
        pred = host(pred).ravel()
        truth = host(truth).ravel()
        err = pred - truth
        atm = np.abs(k) < 0.05
        wing = np.abs(k) > 0.2

        def rmse(mask):
            return float(np.sqrt(np.mean(err[mask] ** 2))) if mask.any() else float("nan")

        # term-structure error: per-maturity mean-IV error
        t = host(t).ravel()
        term_err = []
        for tv in np.unique(t):
            m = t == tv
            term_err.append(pred[m].mean() - truth[m].mean())
        return cls(
            rmse=float(np.sqrt(np.mean(err**2))),
            mae=float(np.mean(np.abs(err))),
            mape=float(np.mean(np.abs(err) / np.maximum(truth, 1e-12))) * 100.0,
            max_error=float(np.max(np.abs(err))),
            atm_rmse=rmse(atm),
            wing_rmse=rmse(wing),
            term_rmse=float(np.sqrt(np.mean(np.asarray(term_err) ** 2))),
        )


@dataclasses.dataclass
class SpeedMetrics:
    calibration_ms: float
    prediction_ms: float
    smiles_per_second: float
    # best of the trials ≈ steady state (the first call builds and warms
    # up); the mean includes it. Both are reported.
    calibration_warm_ms: float = 0.0
    prediction_warm_ms: float = 0.0


@dataclasses.dataclass
class StabilityMetrics:
    param_cv: float  # mean coefficient of variation of fitted params
    arb_free_pct: float
    convergence_pct: float


@dataclasses.dataclass
class BenchmarkEntry:
    model: str
    error: ErrorMetrics
    speed: SpeedMetrics
    stability: StabilityMetrics
    epp_bps: float


# ---------------------------------------------------------------------------
# EPP — exploitable profit proxy from butterfly violations
# ---------------------------------------------------------------------------
def compute_epp(log_strikes, total_variance, maturity, device=None) -> float:
    """Basis-point measure of the arbitrage a predicted smile leaks: the
    integrated magnitude of negative Gatheral density g(k)<0, scaled by
    vega mass. 0 for an arbitrage-free smile."""
    g, mask = butterfly_check(log_strikes, total_variance, device=device)
    g = host(g)
    k = host(log_strikes)[1:-1]
    neg = np.where(host(mask), -g, 0.0)
    if neg.size < 2:
        return 0.0
    epp = np.trapezoid(neg, k)
    del maturity
    return float(epp * 1e4)  # bps


def surface_epp(log_strikes, maturities, iv_grid, device=None) -> float:
    """Mean EPP across maturity slices."""
    t = host(maturities).reshape(-1, 1)
    w = host(iv_grid) ** 2 * t
    return float(np.mean([
        compute_epp(log_strikes, w[i], t[i, 0], device=device) for i in range(w.shape[0])
    ]))


# ---------------------------------------------------------------------------
# Model wrappers — unified calibrate/predict/get_params
# ---------------------------------------------------------------------------
class SVIWrapper:
    name = "svi"

    def __init__(self, n_steps: int = 600, device="cuda"):
        self.n_steps = n_steps
        self.device = device

    def calibrate(self, k, vols, t, seed=0):
        from ..surface.svi import calibrate_svi

        self.t = float(np.mean(t))
        self.params, loss = calibrate_svi(k, vols=vols, maturity=self.t,
                                          n_steps=self.n_steps, device=self.device)
        return loss

    def predict(self, k, t=None):
        from ..surface.svi import svi_implied_vol

        return host(svi_implied_vol(np.asarray(k), self.t, self.params))

    def get_params(self) -> np.ndarray:
        return np.asarray([float(self.params.a), float(self.params.b),
                           float(self.params.rho), float(self.params.m),
                           float(self.params.sigma)])


class SABRWrapper:
    name = "sabr"

    def __init__(self, beta: float = 0.5, n_steps: int = 400, device="cuda"):
        self.beta = beta
        self.n_steps = n_steps
        self.device = device

    def calibrate(self, k, vols, t, seed=0):
        from ..models.sabr import calibrate_sabr

        self.t = float(np.mean(t))
        self.forward = 100.0
        strikes = self.forward * np.exp(np.asarray(k))
        self.params, loss = calibrate_sabr(self.forward, strikes, self.t, vols,
                                           beta=self.beta, n_steps=self.n_steps,
                                           device=self.device)
        return loss

    def predict(self, k, t=None):
        from ..models.sabr import sabr_implied_vol

        strikes = torch.as_tensor(self.forward * np.exp(np.asarray(k)),
                                  device=self.params.alpha.device)
        return host(sabr_implied_vol(self.forward, strikes, self.t, self.params))

    def get_params(self) -> np.ndarray:
        return np.asarray([float(self.params.alpha), float(self.params.rho),
                           float(self.params.nu)])


class SSVIWrapper:
    """Single-slice SSVI fit (θ taken from the observed ATM variance)."""

    name = "ssvi"

    def __init__(self, n_steps: int = 500, device="cuda"):
        self.n_steps = n_steps
        self.device = device

    def calibrate(self, k, vols, t, seed=0):
        from ..surface.svi import calibrate_ssvi

        k = np.asarray(k)
        vols = np.asarray(vols)
        self.t = float(np.mean(t))
        atm_idx = int(np.argmin(np.abs(k)))
        self.theta = float(vols[atm_idx] ** 2 * self.t)
        w = (vols**2 * self.t)[None, :]
        self.params, loss = calibrate_ssvi(k[None, :], np.asarray([self.theta]), w,
                                           n_steps=self.n_steps, device=self.device)
        return loss

    def predict(self, k, t=None):
        from ..surface.svi import ssvi_implied_vol

        return host(ssvi_implied_vol(np.asarray(k), self.theta, self.t, self.params))

    def get_params(self) -> np.ndarray:
        return np.asarray([float(self.params.rho), float(self.params.eta),
                           float(self.params.gamma)])


class _FeatureModelWrapper:
    """Adapts VolatilityModelBase subclasses to smile calibration; the
    frame is the port's column table."""

    model_cls = None
    model_kwargs: dict = {}

    def _frame(self, k, vols, t):
        from ..surface.features import engineer_features

        k = np.asarray(k)
        table = ColumnTable({
            "underlying_price": 100.0,
            "strike_price": 100.0 * np.exp(-k),
            "time_to_maturity": t if np.ndim(t) else np.full(k.size, t),
            "risk_free_rate": 0.03,
            "historical_volatility": 0.2,
        })
        if vols is not None:
            table["implied_volatility"] = np.asarray(vols)
        return engineer_features(table)

    def calibrate(self, k, vols, t, seed=0):
        self.t = t
        self.model = self.model_cls(seed=seed, **self.model_kwargs)
        metrics = self.model.train(self._frame(k, vols, t))
        return metrics["rmse"]

    def predict(self, k, t=None):
        return self.model.predict_volatility(self._frame(k, None, t if t is not None else self.t))

    def get_params(self) -> np.ndarray:
        return np.asarray([])  # nonparametric


class MLPWrapper(_FeatureModelWrapper):
    name = "mlp"

    def __init__(self, epochs: int = 2000, device="cuda"):
        from ..surface.mlp import MLPModel

        # 2000 full-batch epochs on a 1-smile fit; dropout nearly off
        self.model_cls = MLPModel
        self.model_kwargs = {"hidden_layers": (32, 16), "epochs": epochs,
                             "dropout_rate": 0.02, "device": device}


class KernelRidgeWrapper(_FeatureModelWrapper):
    name = "kernel_ridge"

    def __init__(self, device="cuda"):
        from ..surface.kernel_ridge import KernelRidgeModel

        self.model_cls = KernelRidgeModel
        self.model_kwargs = {"gamma": 0.7, "alpha": 1e-4, "device": device}


class RandomForestWrapper(_FeatureModelWrapper):
    name = "random_forest"

    def __init__(self, device="cuda"):
        from ..surface.forest import RandomForestVolatilityModel

        del device  # a host model (scikit-learn)
        self.model_cls = RandomForestVolatilityModel
        self.model_kwargs = {"n_estimators": 50}


class PINNWrapper:
    name = "pinn"

    def __init__(self, epochs: int = 1200, device="cuda"):
        self.epochs = epochs
        self.device = device

    def calibrate(self, k, vols, t, seed=0):
        from ..surface.pinn import PINNVolatilityModel

        self.t = t
        table = ColumnTable({
            "log_moneyness": np.asarray(k),
            "time_to_maturity": t if np.ndim(t) else np.full(np.asarray(k).size, t),
            "implied_volatility": np.asarray(vols),
        })
        self.model = PINNVolatilityModel(hidden_layers=(64, 64),
                                         n_collocation=256,
                                         epochs=self.epochs, seed=seed, device=self.device)
        metrics = self.model.train(table)
        return metrics["rmse"]

    def predict(self, k, t=None):
        tt = t if t is not None else self.t
        table = ColumnTable({
            "log_moneyness": np.asarray(k),
            "time_to_maturity": tt if np.ndim(tt) else np.full(np.asarray(k).size, tt),
        })
        return self.model.predict_volatility(table)

    def get_params(self) -> np.ndarray:
        return np.asarray([])


class ESSVIWrapper:
    """Single-slice eSSVI (theta, rho, psi) — butterfly-arb-free by
    construction of the penalty/parameterization (surface/essvi.py)."""

    name = "essvi"

    def __init__(self, n_steps: int = 800, device="cuda"):
        self.n_steps = n_steps
        self.device = device

    def calibrate(self, k, vols, t, seed=0):
        from ..surface.essvi import calibrate_essvi

        self.t = float(np.mean(t))
        w = np.asarray(vols, np.float64) ** 2 * self.t
        self.params, loss = calibrate_essvi([np.asarray(k)], [w],
                                            n_steps=self.n_steps, device=self.device)
        return loss

    def predict(self, k, t=None):
        from ..surface.essvi import essvi_total_variance

        w = host(essvi_total_variance(
            torch.as_tensor(np.asarray(k, np.float32), device=self.params.theta.device),
            self.params.theta[0], self.params.rho[0], self.params.psi[0]))
        return np.sqrt(np.maximum(w, 1e-12) / self.t)

    def get_params(self) -> np.ndarray:
        return np.asarray([float(self.params.theta[0]),
                           float(self.params.rho[0]),
                           float(self.params.psi[0])])


DEFAULT_WRAPPERS: dict[str, Callable] = {
    "svi": SVIWrapper,
    "ssvi": SSVIWrapper,
    "essvi": ESSVIWrapper,
    "sabr": SABRWrapper,
    "mlp": MLPWrapper,
    "kernel_ridge": KernelRidgeWrapper,
    "random_forest": RandomForestWrapper,
    "pinn": PINNWrapper,
}

COLUMNS = ("model", "rmse_bps", "mae_bps", "atm_rmse_bps", "wing_rmse_bps", "calibration_ms",
           "calibration_warm_ms", "prediction_ms", "prediction_warm_ms", "arb_free_pct",
           "convergence_pct", "param_cv", "epp_bps")


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------
class VolSurfaceBenchmark:
    """``wrappers``: a registry of factories called with no argument; the
    default registry's wrappers fit on ``device``."""

    def __init__(self, models: list[str] | None = None, wrappers: dict | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        registry = wrappers or {n: functools.partial(f, device=self.device)
                                for n, f in DEFAULT_WRAPPERS.items()}
        names = models or list(registry)
        unknown = [n for n in names if n not in registry]
        if unknown:
            raise ValueError(f"unknown benchmark models {unknown}; have {list(registry)}")
        self.factories = {n: registry[n] for n in names}
        self.entries: list[BenchmarkEntry] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, log_strikes, vols, maturity, n_trials: int = 3,
            truth_fn: Callable | None = None) -> "VolSurfaceBenchmark":
        """Benchmark every model on one smile: fit quality vs (optionally)
        a noiseless truth function, timings, stability across reseeded
        trials, arbitrage-freeness, EPP."""
        k = np.asarray(log_strikes)
        vols = np.asarray(vols)
        k_dense = np.linspace(k.min(), k.max(), 101)
        truth_dense = truth_fn(k_dense) if truth_fn else None

        for name, factory in self.factories.items():
            logger.info("benchmarking %s", name)
            params_across, cal_times, pred_times, converged = [], [], [], 0
            wrapper = None
            for trial in range(n_trials):
                wrapper = factory()
                self._sync()
                t0 = time.perf_counter()
                try:
                    wrapper.calibrate(k, vols, maturity, seed=trial)
                    self._sync()
                    converged += 1
                except FIT_FAILURES as e:
                    logger.warning("%s trial %d failed: %s", name, trial, e)
                    continue
                cal_times.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                wrapper.predict(k_dense)
                self._sync()
                pred_times.append((time.perf_counter() - t0) * 1e3)
                p = wrapper.get_params()
                if p.size:
                    params_across.append(p)
            if wrapper is None or not cal_times:
                continue

            pred_fit = host(wrapper.predict(k)).ravel()
            target = truth_fn(k) if truth_fn else vols
            error = ErrorMetrics.from_predictions(
                k, np.full(k.size, np.mean(maturity)), pred_fit, target)
            if truth_dense is not None:
                dense_pred = host(wrapper.predict(k_dense)).ravel()
                error = ErrorMetrics.from_predictions(
                    k_dense, np.full(k_dense.size, np.mean(maturity)),
                    dense_pred, truth_dense)

            pred_dense = host(wrapper.predict(k_dense)).ravel()
            w_dense = pred_dense**2 * np.mean(maturity)
            _, bf_mask = butterfly_check(k_dense, w_dense, device=self.device)
            arb_free = 100.0 * (1.0 - float(np.mean(host(bf_mask))))
            epp = compute_epp(k_dense, w_dense, np.mean(maturity), device=self.device)

            if params_across and len(params_across) > 1:
                pa = np.stack(params_across)
                cv = np.abs(pa.std(axis=0) / np.maximum(np.abs(pa.mean(axis=0)), 1e-12))
                param_cv = float(cv.mean())
            else:
                param_cv = 0.0

            self.entries.append(BenchmarkEntry(
                model=name,
                error=error,
                speed=SpeedMetrics(
                    calibration_ms=float(np.mean(cal_times)),
                    prediction_ms=float(np.mean(pred_times)),
                    smiles_per_second=1e3 / float(np.mean(pred_times)),
                    calibration_warm_ms=float(np.min(cal_times)),
                    prediction_warm_ms=float(np.min(pred_times)),
                ),
                stability=StabilityMetrics(
                    param_cv=param_cv,
                    arb_free_pct=arb_free,
                    convergence_pct=100.0 * converged / n_trials,
                ),
                epp_bps=epp,
            ))
        return self

    def records(self) -> list[dict]:
        """The results table's rows, one dict per model (NaN as None, as a
        JSON table writes it)."""
        rows = []
        for e in self.entries:
            row = {
                "model": e.model,
                "rmse_bps": e.error.rmse * 1e4,
                "mae_bps": e.error.mae * 1e4,
                "atm_rmse_bps": e.error.atm_rmse * 1e4,
                "wing_rmse_bps": e.error.wing_rmse * 1e4,
                "calibration_ms": e.speed.calibration_ms,
                "calibration_warm_ms": e.speed.calibration_warm_ms,
                "prediction_ms": e.speed.prediction_ms,
                "prediction_warm_ms": e.speed.prediction_warm_ms,
                "arb_free_pct": e.stability.arb_free_pct,
                "convergence_pct": e.stability.convergence_pct,
                "param_cv": e.stability.param_cv,
                "epp_bps": e.epp_bps,
            }
            rows.append({k: None if isinstance(v, float) and math.isnan(v) else v
                         for k, v in row.items()})
        return rows

    def to_dataframe(self):
        """The results table: a pandas DataFrame where pandas is installed,
        else the column table."""
        rows = self.records()
        return to_frame(ColumnTable({c: np.asarray([np.nan if r[c] is None else r[c]
                                                    for r in rows],
                                                   object if c == "model" else np.float64)
                                     for c in COLUMNS}))

    def best_model(self, metric: str = "rmse_bps") -> str:
        rows = self.records()
        if not rows:
            raise ValueError("no successful benchmark entries")
        ranked = sorted(rows, key=lambda r: (r[metric] is None, r[metric] or 0.0))
        return str(ranked[0]["model"])
