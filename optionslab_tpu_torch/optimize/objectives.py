"""Objective factories for hyperparameter studies.

The port of ``optionslab_tpu/optimize/objectives.py``: CV objectives with
pruning hooks for any surface model (folds are rows of the column table, so
no pandas is needed), the pricing surrogate's held-out price error, and a
hyper-objective around a model calibration; metric dispatch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..data._table import as_table
from ..utils.exceptions import ValidationError
from .reproducibility import seeded_kfold
from .search import TrialPruned

METRICS = {
    "rmse": lambda y, p: float(np.sqrt(np.mean((p - y) ** 2))),
    "mae": lambda y, p: float(np.mean(np.abs(p - y))),
    "mape": lambda y, p: float(np.mean(np.abs(p - y) / np.maximum(np.abs(y), 1e-12))),
}


def get_metric(name: str) -> Callable:
    if name not in METRICS:
        raise ValidationError(f"unknown metric {name!r}; choose {list(METRICS)}")
    return METRICS[name]


def make_surface_model_objective(model_cls, space, df, n_folds: int = 3,
                                 metric: str = "rmse", prune: bool = True,
                                 **fixed_kwargs) -> Callable:
    """CV objective over any VolatilityModelBase subclass; reports per-fold
    scores for the pruner."""
    score = get_metric(metric)
    table = as_table(df)
    target = np.asarray(table["implied_volatility"])

    def objective(trial, trial_seed) -> float:
        params = space.suggest(trial)
        space.validate(params)
        fold_scores = []
        for fold, (tr_idx, va_idx) in enumerate(seeded_kfold(len(table), n_folds, trial_seed)):
            model = model_cls(**{**fixed_kwargs, **params, "seed": int(trial_seed % 2**31)})
            model.train(table.take(tr_idx))
            pred = model.predict_volatility(table.take(va_idx))
            fold_scores.append(score(target[va_idx], pred))
            trial.report(float(np.mean(fold_scores)), fold)
            if prune and trial.should_prune():
                raise TrialPruned()
        return float(np.mean(fold_scores))

    return objective


def make_surrogate_objective(space, n_train: int = 20_000, n_eval: int = 5_000,
                             device="cuda") -> Callable:
    """Objective for the pricing surrogate: price-head RMSE on held-out
    contracts; every fit runs on ``device`` (default the card)."""
    from ..models.surrogate import MonteCarloMLSurrogate, generate_training_data

    x_eval, y_eval, _ = generate_training_data(n_eval, seed=987, device=device)

    def objective(trial, trial_seed) -> float:
        params = space.suggest(trial)
        space.validate(params)
        model = MonteCarloMLSurrogate(seed=int(trial_seed % 2**31), device=device, **params)
        model.fit(n_samples=n_train)
        pred = model._forward(x_eval)
        return float(np.sqrt(np.mean((pred[:, 0] - y_eval[:, 0]) ** 2)))

    return objective


def make_calibration_objective(pricer_builder, market_prices, batch) -> Callable:
    """Hyper-objective around a model calibration (e.g. Heston learning-rate
    / n_steps tuning): value = final calibration loss.
    ``pricer_builder(market_prices, batch, learning_rate=, n_steps=)``
    returns (params, loss)."""

    def objective(trial, trial_seed) -> float:
        lr = trial.suggest_float("learning_rate", 1e-3, 0.2, log=True)
        n_steps = trial.suggest_int("n_steps", 50, 500, log=True)
        _, loss = pricer_builder(market_prices, batch, learning_rate=lr, n_steps=n_steps)
        return float(loss)

    return objective
