"""Volatility-surface model base: train/predict/evaluate/save/load lifecycle.

The port of ``optionslab_tpu/surface/base.py``: host numpy throughout (the
scaler, the feature checks, the metrics, the json + npz persistence), so it
is the reference's code with one change: the feature checks read the
columns' numpy dtypes, and need no pandas. A frame is any frame-like input
(``data/_table.py``): a pandas DataFrame or a column table.
"""

from __future__ import annotations

import abc
import json
import pathlib
import time
from typing import Any

import numpy as np

from ..utils.exceptions import DataError, ModelError

FEATURE_COLUMNS = [
    "moneyness",
    "log_moneyness",
    "time_to_maturity",
    "ttm_squared",
    "risk_free_rate",
    "historical_volatility",
    "volatility_skew",
]
BASE_COLUMNS = [
    "underlying_price",
    "strike_price",
    "time_to_maturity",
    "risk_free_rate",
    "historical_volatility",
]
TARGET_COLUMN = "implied_volatility"


class StandardScaler:
    """Minimal standard scaler (replaces sklearn's)."""

    def __init__(self):
        self.mean_ = None
        self.scale_ = None

    def fit(self, x):
        x = np.asarray(x, np.float64)
        self.mean_ = x.mean(axis=0)
        self.scale_ = np.where(x.std(axis=0) < 1e-12, 1.0, x.std(axis=0))
        return self

    def transform(self, x):
        if self.mean_ is None:
            raise ModelError("scaler not fitted")
        return (np.asarray(x) - self.mean_) / self.scale_

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def inverse_transform(self, x):
        return np.asarray(x) * self.scale_ + self.mean_

    def state(self):
        return {"mean": self.mean_, "scale": self.scale_}

    @classmethod
    def from_state(cls, state):
        s = cls()
        s.mean_ = np.asarray(state["mean"])
        s.scale_ = np.asarray(state["scale"])
        return s


def validate_features(df, columns) -> None:
    """Missing / non-numeric / NaN / inf checks (reference: base.py:296-316)."""
    missing = [c for c in columns if c not in df.columns]
    if missing:
        raise DataError(f"missing feature columns: {missing}")
    for c in columns:
        col = np.asarray(df[c])
        if col.dtype.kind not in "biuf":
            raise DataError(f"feature column {c!r} is not numeric")
        if np.any(~np.isfinite(col)):
            raise DataError(f"feature column {c!r} contains NaN/inf")


def regression_metrics(y_true, y_pred) -> dict:
    """rmse / mae / r2 / mape (reference: base.py:233-238)."""
    y_true = np.asarray(y_true, np.float64).ravel()
    y_pred = np.asarray(y_pred, np.float64).ravel()
    err = y_pred - y_true
    ss_res = float(np.sum(err**2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    return {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mae": float(np.mean(np.abs(err))),
        "r2": 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0,
        "mape": float(np.mean(np.abs(err) / np.maximum(np.abs(y_true), 1e-12))) * 100.0,
    }


class VolatilityModelBase(abc.ABC):
    """Abstract vol-surface model with lifecycle hooks and timing registry."""

    def __init__(self, feature_columns=None):
        self.feature_columns = list(feature_columns or FEATURE_COLUMNS)
        self.is_trained = False
        self.scaler = StandardScaler()
        self._timings: dict[str, list[float]] = {}
        self.training_history: dict[str, Any] = {}

    # -- lifecycle hooks (reference: base.py:90-99) -------------------------
    def _on_train_start(self, df):
        pass

    def _on_train_end(self, metrics):
        pass

    def _record(self, name: str, ms: float):
        self._timings.setdefault(name, []).append(ms)

    def get_benchmark_timings(self) -> dict:
        return {k: list(v) for k, v in self._timings.items()}

    # -- public API ---------------------------------------------------------
    def train(self, df, **kwargs) -> dict:
        validate_features(df, self.feature_columns + [TARGET_COLUMN])
        self._on_train_start(df)
        t0 = time.perf_counter()
        metrics = self._train_impl(df, **kwargs)
        self._record("train", (time.perf_counter() - t0) * 1e3)
        self.is_trained = True
        self._on_train_end(metrics)
        return metrics

    def predict_volatility(self, df) -> np.ndarray:
        if not self.is_trained:
            raise ModelError(f"{type(self).__name__} used before training")
        validate_features(df, self.feature_columns)
        t0 = time.perf_counter()
        out = np.asarray(self._predict_impl(df))
        self._record("predict", (time.perf_counter() - t0) * 1e3)
        return out

    def evaluate(self, df) -> dict:
        pred = self.predict_volatility(df)
        return regression_metrics(np.asarray(df[TARGET_COLUMN]), pred)

    # -- persistence --------------------------------------------------------
    def save_model(self, path) -> None:
        if not self.is_trained:
            raise ModelError("cannot save an untrained model")
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays, meta = self._state()
        np.savez(path / "arrays.npz", **{k: np.asarray(v) for k, v in arrays.items()})
        meta = dict(meta)
        meta["__class__"] = type(self).__name__
        meta["feature_columns"] = self.feature_columns
        if self.scaler.mean_ is not None:
            np.savez(path / "scaler.npz", **self.scaler.state())
        (path / "meta.json").write_text(json.dumps(meta, default=float))

    def load_model(self, path) -> "VolatilityModelBase":
        path = pathlib.Path(path)
        meta = json.loads((path / "meta.json").read_text())
        arrays = dict(np.load(path / "arrays.npz", allow_pickle=False))
        if (path / "scaler.npz").exists():
            self.scaler = StandardScaler.from_state(dict(np.load(path / "scaler.npz")))
        self.feature_columns = meta.get("feature_columns", self.feature_columns)
        self._load_state(arrays, meta)
        self.is_trained = True
        return self

    # -- to implement -------------------------------------------------------
    @abc.abstractmethod
    def _train_impl(self, df, **kwargs) -> dict: ...

    @abc.abstractmethod
    def _predict_impl(self, df) -> np.ndarray: ...

    @abc.abstractmethod
    def _state(self) -> tuple[dict, dict]:
        """(arrays, json-able meta) for persistence."""

    @abc.abstractmethod
    def _load_state(self, arrays: dict, meta: dict) -> None: ...

    # -- shared helpers -----------------------------------------------------
    def _features_matrix(self, df, fit_scaler: bool = False) -> np.ndarray:
        x = np.stack([np.asarray(df[c], np.float32) for c in self.feature_columns], axis=1)
        if fit_scaler:
            return self.scaler.fit_transform(x).astype(np.float32)
        return self.scaler.transform(x).astype(np.float32)
