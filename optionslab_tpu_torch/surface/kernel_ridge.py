"""Kernel-ridge volatility model (the reference's answer to sklearn's SVR).

The port of ``optionslab_tpu/surface/kernel_ridge.py``: an RBF kernel on the
7 engineered features, the closed-form solve (K + λI)α = y by one Cholesky
factorisation in float32 on ``device`` (default the card), and predictions
by one kernel product. Where the factorisation fails (the kernel matrix is
not positive definite in float32) the reference's XLA Cholesky returns NaN;
the port raises :class:`ModelError` naming the fit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.exceptions import ModelError
from .base import TARGET_COLUMN, VolatilityModelBase, regression_metrics
from .nn_core import require_full_fp32


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i|² + |b_j|² − 2 a_i·b_j, the reference's expansion."""
    return (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)


def cholesky_solve(a: torch.Tensor, y: torch.Tensor, what: str) -> torch.Tensor:
    """a⁻¹ y for a symmetric positive definite ``a``; raises ModelError when
    the factorisation fails."""
    require_full_fp32()
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) != 0:
        raise ModelError(f"{what}: the {a.shape[0]} x {a.shape[0]} kernel matrix is not "
                         f"positive definite in {a.dtype} (Cholesky failed at order "
                         f"{int(info)}); raise the regularisation or drop duplicate points")
    return torch.cholesky_solve(y.reshape(-1, 1), chol).reshape(y.shape)


def _rbf(x1, x2, gamma: float):
    return torch.exp(-gamma * torch.clamp_min(pairwise_sq_dists(x1, x2), 0.0))


def _fit(x, y, gamma: float, alpha_reg: float):
    a = _rbf(x, x, gamma) + alpha_reg * torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return cholesky_solve(a, y, "KernelRidgeModel fit")


def _predict(x_train, alpha, x_new, gamma: float):
    return _rbf(x_new, x_train, gamma) @ alpha


class KernelRidgeModel(VolatilityModelBase):
    """RBF kernel ridge on the 7 engineered features."""

    def __init__(self, gamma: float = 1.0, alpha: float = 1e-3, feature_columns=None,
                 max_train_points: int = 4096, seed: int = 0, device="cuda"):
        super().__init__(feature_columns)
        self.gamma = gamma
        self.alpha = alpha
        self.max_train_points = max_train_points
        self.seed = seed
        self.device = torch.device(device)
        self._x_train = None
        self._dual = None

    def _train_impl(self, df, **kwargs) -> dict:
        x = self._features_matrix(df, fit_scaler=True)
        y = np.asarray(df[TARGET_COLUMN], np.float32)
        if x.shape[0] > self.max_train_points:
            rng = np.random.default_rng(self.seed)
            idx = rng.choice(x.shape[0], self.max_train_points, replace=False)
            x, y = x[idx], y[idx]
        self._x_train = torch.as_tensor(x, device=self.device)
        self._dual = _fit(self._x_train, torch.as_tensor(y, device=self.device),
                          float(np.float32(self.gamma)), float(np.float32(self.alpha)))
        pred = _predict(self._x_train, self._dual, self._x_train, float(np.float32(self.gamma)))
        return regression_metrics(y, pred.cpu().numpy())

    def _predict_impl(self, df) -> np.ndarray:
        x = torch.as_tensor(self._features_matrix(df), device=self.device)
        return _predict(self._x_train, self._dual, x,
                        float(np.float32(self.gamma))).cpu().numpy()

    def _state(self):
        return ({"x_train": self._x_train.cpu().numpy(), "dual": self._dual.cpu().numpy()},
                {"gamma": self.gamma, "alpha": self.alpha})

    def _load_state(self, arrays, meta):
        self._x_train = torch.as_tensor(np.asarray(arrays["x_train"], np.float32),
                                        device=self.device)
        self._dual = torch.as_tensor(np.asarray(arrays["dual"], np.float32), device=self.device)
        self.gamma = float(meta["gamma"])
        self.alpha = float(meta["alpha"])


# the reference's model name
SVRModel = KernelRidgeModel
