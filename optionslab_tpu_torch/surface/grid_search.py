"""Hyperparameter grid search and nested cross-validation for surface models.

The port of ``optionslab_tpu/surface/grid_search.py``: ``tune_model`` over a
parameter grid with k-fold CV and ``nested_cross_validate``. Folds are rows
of the column table (``data/_table.py``), so no pandas is needed; the
folds are numpy's, the reference's exactly.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..data._table import as_table
from ..utils.logging import get_logger
from .base import TARGET_COLUMN, regression_metrics

logger = get_logger(__name__)


def _param_combos(grid: dict):
    keys = list(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        yield dict(zip(keys, combo))


def _kfold_indices(n: int, k: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    folds = np.array_split(idx, k)
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        yield train, val


def tune_model(model_cls, df, param_grid: dict, n_folds: int = 3, metric: str = "rmse",
               seed: int = 0, **fixed_kwargs):
    """Exhaustive grid search with k-fold CV. Returns
    (best_params, best_score, results list)."""
    table = as_table(df)
    results = []
    best_params, best_score = None, float("inf")
    for params in _param_combos(param_grid):
        scores = []
        for train_idx, val_idx in _kfold_indices(len(table), n_folds, seed):
            model = model_cls(**{**fixed_kwargs, **params})
            model.train(table.take(train_idx))
            scores.append(model.evaluate(table.take(val_idx))[metric])
        mean_score = float(np.mean(scores))
        results.append({"params": params, metric: mean_score, "scores": scores})
        logger.info("grid point %s -> %s=%.6f", params, metric, mean_score)
        if mean_score < best_score:
            best_score, best_params = mean_score, params
    return best_params, best_score, results


def nested_cross_validate(model_cls, df, param_grid: dict, outer_folds: int = 3,
                          inner_folds: int = 2, metric: str = "rmse", seed: int = 0,
                          **fixed_kwargs):
    """Unbiased generalization estimate: inner grid search per outer fold."""
    table = as_table(df)
    outer_scores = []
    for train_idx, test_idx in _kfold_indices(len(table), outer_folds, seed):
        inner = table.take(train_idx)
        best_params, _, _ = tune_model(model_cls, inner, param_grid, n_folds=inner_folds,
                                       metric=metric, seed=seed + 1, **fixed_kwargs)
        model = model_cls(**{**fixed_kwargs, **best_params})
        model.train(inner)
        test = table.take(test_idx)
        m = regression_metrics(np.asarray(test[TARGET_COLUMN]), model.predict_volatility(test))
        outer_scores.append({"params": best_params, **m})
    return outer_scores
