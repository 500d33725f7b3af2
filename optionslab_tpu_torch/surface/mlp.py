"""MLP volatility-surface model.

The port of ``optionslab_tpu/surface/mlp.py``: configurable hidden layers,
GELU (tanh form), dropout, clipped AdamW with early stopping, an optional
input-gradient smoothness penalty, MC-dropout uncertainty and input-gradient
"greeks". The weights, the training data and the optimizer state live on
``device`` (default the card); the frame's features are read on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import TARGET_COLUMN, VolatilityModelBase, regression_metrics
from .nn_core import (
    apply_mlp,
    flatten_params,
    init_mlp,
    make_generator,
    mc_dropout_predict,
    train_mlp,
    unflatten_params,
)


def smoothness_penalty(params, xb: torch.Tensor, weight: float, layernorm: bool):
    """weight · mean (∂f/∂x)²: the input-gradient smoothness term, row by row
    (rows are independent, so the gradient of the sum is per row)."""
    xx = xb.detach().requires_grad_(True)
    with torch.enable_grad():
        out = apply_mlp(params, xx, layernorm=layernorm).sum()
        (grads,) = torch.autograd.grad(out, xx, create_graph=True)
    return weight * torch.mean(grads**2)


class MLPModel(VolatilityModelBase):
    def __init__(self, hidden_layers=(64, 32), dropout_rate: float = 0.1,
                 learning_rate: float = 3e-3, epochs: int = 300,
                 batch_size: int = 64, patience: int = 30,
                 smoothness_weight: float = 0.0, seed: int = 0,
                 feature_columns=None, layernorm: bool = False, device="cuda"):
        # layernorm defaults off, as in the reference: normalizing across the
        # hidden features of a ~1-D smile input destroys the fit
        super().__init__(feature_columns)
        self.hidden_layers = tuple(hidden_layers)
        self.layernorm = bool(layernorm)
        self.dropout_rate = dropout_rate
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.patience = patience
        self.smoothness_weight = smoothness_weight
        self.seed = seed
        self.device = torch.device(device)
        self.params = None

    def _x(self, df) -> torch.Tensor:
        return torch.as_tensor(self._features_matrix(df), device=self.device)

    def _forward_np(self, x: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            return apply_mlp(self.params, x, layernorm=self.layernorm).cpu().numpy().ravel()

    # -- training -----------------------------------------------------------
    def _train_impl(self, df, **kwargs) -> dict:
        x = self._features_matrix(df, fit_scaler=True)
        y = np.asarray(df[TARGET_COLUMN], np.float32)
        gen = make_generator(self.seed, self.device)
        params = init_mlp(gen, [x.shape[1], *self.hidden_layers, 1])

        extra = None
        if self.smoothness_weight > 0.0:
            def extra(p, xb):
                return smoothness_penalty(p, xb, self.smoothness_weight, self.layernorm)

        self.params, history = train_mlp(
            params, x, y, extra, generator=gen, epochs=self.epochs,
            batch_size=self.batch_size, learning_rate=self.learning_rate,
            dropout_rate=self.dropout_rate, patience=self.patience,
            layernorm=self.layernorm,
        )
        self.training_history = history
        pred = self._forward_np(torch.as_tensor(x, device=self.device))
        return regression_metrics(y, pred)

    # -- inference ----------------------------------------------------------
    def _predict_impl(self, df) -> np.ndarray:
        return self._forward_np(self._x(df))

    def predict_with_uncertainty(self, df, mc_samples: int = 32):
        """(mean, std) via MC dropout."""
        mean, std = mc_dropout_predict(self.params, self._x(df),
                                       make_generator(self.seed + 2, self.device),
                                       n_samples=mc_samples, dropout_rate=self.dropout_rate,
                                       layernorm=self.layernorm)
        return mean.cpu().numpy().ravel(), std.cpu().numpy().ravel()

    def input_gradients(self, df) -> np.ndarray:
        """∂vol/∂feature per row, in raw feature units."""
        x = self._x(df).requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(apply_mlp(self.params, x, layernorm=self.layernorm).sum(),
                                       x)
        # chain rule through the scaler back to raw feature units
        return g.cpu().numpy() / self.scaler.scale_

    # -- persistence --------------------------------------------------------
    def _state(self):
        meta = {
            "hidden_layers": list(self.hidden_layers),
            "dropout_rate": self.dropout_rate,
            "seed": self.seed,
            "layernorm": self.layernorm,
        }
        return flatten_params(self.params), meta

    def _load_state(self, arrays, meta):
        self.hidden_layers = tuple(int(h) for h in meta["hidden_layers"])
        self.dropout_rate = float(meta["dropout_rate"])
        # saves made before the layernorm flag trained with it on
        self.layernorm = bool(meta.get("layernorm", True))
        self.params = unflatten_params(arrays, self.device)
