"""Tree-ensemble volatility models on scikit-learn.

The port of ``optionslab_tpu/surface/forest.py``: ``RandomForestRegressor``
(100 trees, depth 10) and sklearn's histogram gradient booster in the
XGBoost slot. Trees are sequential host algorithms with no device win, so
these models run on the host as in the reference. scikit-learn is optional:
where it cannot be imported, training raises :class:`DependencyError`.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

from ..utils.exceptions import DependencyError
from .base import TARGET_COLUMN, VolatilityModelBase, regression_metrics


def _require_sklearn():
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise DependencyError("scikit-learn is required for tree-ensemble models") from e


class _SklearnVolModel(VolatilityModelBase):
    """Shared plumbing for sklearn-estimator-backed models."""

    def _make_estimator(self):
        raise NotImplementedError

    def _train_impl(self, df, **kwargs) -> dict:
        _require_sklearn()
        x = self._features_matrix(df, fit_scaler=True)
        y = np.asarray(df[TARGET_COLUMN], np.float64)
        self.estimator = self._make_estimator()
        self.estimator.fit(x, y)
        return regression_metrics(y, self.estimator.predict(x))

    def _predict_impl(self, df) -> np.ndarray:
        return np.asarray(self.estimator.predict(self._features_matrix(df)))

    def _state(self):
        buf = io.BytesIO()
        pickle.dump(self.estimator, buf)
        payload = np.frombuffer(buf.getvalue(), dtype=np.uint8)
        return {"estimator_pickle": payload}, {"params": self.get_params()}

    def _load_state(self, arrays, meta):
        _require_sklearn()
        self.estimator = pickle.loads(arrays["estimator_pickle"].tobytes())

    def get_params(self) -> dict:
        return {}


class RandomForestVolatilityModel(_SklearnVolModel):
    """100 trees, depth 10."""

    def __init__(self, n_estimators: int = 100, max_depth: int = 10, seed: int = 0,
                 feature_columns=None):
        super().__init__(feature_columns)
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.seed = seed

    def _make_estimator(self):
        from sklearn.ensemble import RandomForestRegressor

        return RandomForestRegressor(
            n_estimators=self.n_estimators, max_depth=self.max_depth,
            random_state=self.seed, n_jobs=-1,
        )

    def get_params(self):
        return {"n_estimators": self.n_estimators, "max_depth": self.max_depth}

    def feature_importances(self) -> dict:
        return dict(zip(self.feature_columns, self.estimator.feature_importances_))


class GradientBoostingVolatilityModel(_SklearnVolModel):
    """The XGBoost slot on sklearn's histogram gradient booster with early
    stopping."""

    def __init__(self, max_iter: int = 300, learning_rate: float = 0.08,
                 max_depth: int = 6, early_stopping: bool = True, seed: int = 0,
                 feature_columns=None):
        super().__init__(feature_columns)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.early_stopping = early_stopping
        self.seed = seed

    def _make_estimator(self):
        from sklearn.ensemble import HistGradientBoostingRegressor

        return HistGradientBoostingRegressor(
            max_iter=self.max_iter, learning_rate=self.learning_rate,
            max_depth=self.max_depth, early_stopping=self.early_stopping,
            random_state=self.seed,
        )

    def get_params(self):
        return {"max_iter": self.max_iter, "learning_rate": self.learning_rate,
                "max_depth": self.max_depth}


# the reference's name for the XGBoost slot
XGBVolatilityModel = GradientBoostingVolatilityModel
