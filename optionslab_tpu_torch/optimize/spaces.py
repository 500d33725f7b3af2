"""Search-space definitions per model family.

The port of ``optionslab_tpu/optimize/spaces.py`` (no device work): the
protocol ``suggest/validate/get_default_params`` with spaces for the MLP,
the boosted-tree model, kernel ridge and the pricing surrogate; invalid
parameters raise :class:`ValidationError`.
"""

from __future__ import annotations

from typing import Protocol

from ..utils.exceptions import ValidationError


class SearchSpace(Protocol):
    def suggest(self, trial) -> dict: ...

    def validate(self, params: dict) -> None: ...

    def get_default_params(self) -> dict: ...


class MLPSearchSpace:
    """Hidden width/depth, dropout, lr, batch size."""

    WIDTHS = (16, 32, 64, 128)

    def suggest(self, trial) -> dict:
        depth = trial.suggest_int("n_layers", 1, 3)
        width = trial.suggest_categorical("width", list(self.WIDTHS))
        return {
            "hidden_layers": tuple([width] * depth),
            "dropout_rate": trial.suggest_float("dropout_rate", 0.0, 0.4),
            "learning_rate": trial.suggest_float("learning_rate", 1e-4, 2e-2, log=True),
            "batch_size": trial.suggest_categorical("batch_size", [32, 64, 128, 256]),
        }

    def validate(self, params: dict) -> None:
        if not params.get("hidden_layers"):
            raise ValidationError("hidden_layers must be non-empty")
        if not 0.0 <= params.get("dropout_rate", 0.0) < 1.0:
            raise ValidationError("dropout_rate must be in [0, 1)")
        if params.get("learning_rate", 1e-3) <= 0:
            raise ValidationError("learning_rate must be positive")

    def get_default_params(self) -> dict:
        return {"hidden_layers": (64, 32), "dropout_rate": 0.1,
                "learning_rate": 3e-3, "batch_size": 64}


class GradientBoostingSearchSpace:
    """max_iter/depth/lr (the boosted-tree space)."""

    def suggest(self, trial) -> dict:
        return {
            "max_iter": trial.suggest_int("max_iter", 50, 500, log=True),
            "max_depth": trial.suggest_int("max_depth", 3, 10),
            "learning_rate": trial.suggest_float("learning_rate", 0.01, 0.3, log=True),
        }

    def validate(self, params: dict) -> None:
        if params.get("max_iter", 1) <= 0 or params.get("max_depth", 1) <= 0:
            raise ValidationError("max_iter/max_depth must be positive")
        if not 0 < params.get("learning_rate", 0.1) <= 1:
            raise ValidationError("learning_rate must be in (0, 1]")

    def get_default_params(self) -> dict:
        return {"max_iter": 300, "max_depth": 6, "learning_rate": 0.08}


class KernelRidgeSearchSpace:
    def suggest(self, trial) -> dict:
        return {
            "gamma": trial.suggest_float("gamma", 0.05, 5.0, log=True),
            "alpha": trial.suggest_float("alpha", 1e-6, 1e-1, log=True),
        }

    def validate(self, params: dict) -> None:
        if params.get("gamma", 1.0) <= 0 or params.get("alpha", 1e-3) <= 0:
            raise ValidationError("gamma/alpha must be positive")

    def get_default_params(self) -> dict:
        return {"gamma": 1.0, "alpha": 1e-3}


class SurrogateSearchSpace:
    """Spaces for the MC ML surrogate (``monte_carlo_ml`` slot)."""

    def suggest(self, trial) -> dict:
        depth = trial.suggest_int("n_layers", 1, 3)
        width = trial.suggest_categorical("width", [64, 128, 256])
        return {
            "hidden_layers": tuple([width] * depth),
            "learning_rate": trial.suggest_float("learning_rate", 1e-4, 1e-2, log=True),
            "epochs": trial.suggest_int("epochs", 50, 400, log=True),
        }

    def validate(self, params: dict) -> None:
        if not params.get("hidden_layers"):
            raise ValidationError("hidden_layers must be non-empty")

    def get_default_params(self) -> dict:
        return {"hidden_layers": (128, 128), "learning_rate": 1e-3, "epochs": 300}
