"""Volatility surface generator: scattered quotes → dense (K, T) grid.

The port of ``optionslab_tpu/surface/generator.py``, on ``device`` (default
the card), in float32:

* ``rbf``: a Gaussian RBF fit, one Cholesky solve, exact at the quotes; one
  kernel product per query grid. Where the kernel matrix is not positive
  definite in float32 (duplicate quotes, or near-duplicates at ``reg``
  1e-8) the reference's XLA Cholesky returns NaN and the port raises
  :class:`ModelError`;
* ``idw``: inverse-distance weighting, one (grid × quotes) weight product;
* ``nearest``: the argmin over the same distance matrix.

Coordinates are standardised per axis before interpolation so strike and
maturity contribute comparably; generated grids are cached per grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.exceptions import DataError, DependencyError, ValidationError
from .kernel_ridge import cholesky_solve, pairwise_sq_dists


def _rbf_fit(points, values, epsilon: float, reg: float):
    d2 = torch.clamp_min(pairwise_sq_dists(points, points), 0.0)
    k = torch.exp(-d2 / (2.0 * epsilon * epsilon))
    a = k + reg * torch.eye(points.shape[0], dtype=points.dtype, device=points.device)
    return cholesky_solve(a, values, "VolatilitySurfaceGenerator rbf fit")


def _rbf_eval(points, coefs, queries, epsilon: float):
    d2 = torch.clamp_min(pairwise_sq_dists(queries, points), 0.0)
    return torch.exp(-d2 / (2.0 * epsilon * epsilon)) @ coefs


def _idw_eval(points, values, queries, power: float = 2.0):
    w = torch.clamp_min(pairwise_sq_dists(queries, points), 1e-12) ** (-power / 2.0)
    return (w @ values) / w.sum(dim=1)


def _nearest_eval(points, values, queries):
    return values[torch.argmin(pairwise_sq_dists(queries, points), dim=1)]


class VolatilitySurfaceGenerator:
    """Scattered-quote interpolator with a grid cache.

    ``method`` ∈ {"rbf", "idw", "nearest"}.
    """

    def __init__(self, strikes, maturities, vols, method: str = "rbf",
                 epsilon: float = 0.35, idw_power: float = 2.0, reg: float = 1e-8,
                 device="cuda"):
        strikes = np.asarray(strikes, np.float32)
        maturities = np.asarray(maturities, np.float32)
        vols = np.asarray(vols, np.float32)
        if not (strikes.shape == maturities.shape == vols.shape) or strikes.ndim != 1:
            raise ValidationError("strikes/maturities/vols must be equal-length 1-D arrays")
        if strikes.size < 4:
            raise DataError("need at least 4 quotes to build a surface")
        if np.any(~np.isfinite(vols)) or np.any(vols <= 0):
            raise DataError("vols must be positive and finite")
        if method not in ("rbf", "idw", "nearest"):
            raise ValidationError(f"unknown interpolation method {method!r}")
        self.method = method
        self.epsilon = float(np.float32(epsilon))
        self.idw_power = idw_power
        self.device = torch.device(device)
        self._k_scale = float(strikes.std() or 1.0)
        self._t_scale = float(maturities.std() or 1.0)
        self._k_mean = float(strikes.mean())
        self._t_mean = float(maturities.mean())
        self._points = torch.as_tensor(
            np.stack([(strikes - self._k_mean) / self._k_scale,
                      (maturities - self._t_mean) / self._t_scale], axis=1), device=self.device)
        self._values = torch.as_tensor(vols, device=self.device)
        self._coefs = (_rbf_fit(self._points, self._values, self.epsilon,
                                float(np.float32(reg))) if method == "rbf" else None)
        self._cache: dict = {}

    def _normalize(self, strikes, maturities):
        k = (torch.as_tensor(np.asarray(strikes, np.float32), device=self.device)
             - self._k_mean) / self._k_scale
        t = (torch.as_tensor(np.asarray(maturities, np.float32), device=self.device)
             - self._t_mean) / self._t_scale
        return torch.stack([k.reshape(-1), t.reshape(-1)], dim=1)

    @torch.no_grad()
    def _eval(self, queries):
        if self.method == "rbf":
            return _rbf_eval(self._points, self._coefs, queries, self.epsilon)
        if self.method == "idw":
            return _idw_eval(self._points, self._values, queries, self.idw_power)
        return _nearest_eval(self._points, self._values, queries)

    # -- public API (mirrors the reference) ---------------------------------
    def generate_surface(self, strike_grid, maturity_grid) -> np.ndarray:
        """(n_T, n_K) IV grid; cached per grid signature."""
        kg = np.asarray(strike_grid, np.float32)
        tg = np.asarray(maturity_grid, np.float32)
        cache_key = (kg.tobytes(), tg.tobytes())
        if cache_key in self._cache:
            return self._cache[cache_key]
        kk, tt = np.meshgrid(kg, tg)
        out = self._eval(self._normalize(kk.ravel(), tt.ravel())).cpu().numpy().reshape(tt.shape)
        self._cache[cache_key] = out
        return out

    def get_volatility(self, strike, maturity) -> float:
        return float(self._eval(self._normalize(np.float32(strike), np.float32(maturity)))[0])

    def get_surface_batch(self, strikes, maturities) -> np.ndarray:
        return self._eval(self._normalize(strikes, maturities)).cpu().numpy()

    def clear_cache(self):
        self._cache.clear()

    def plot_surface(self, strike_grid=None, maturity_grid=None, path=None):
        """3-D surface render; saves to ``path`` if given. Needs matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise DependencyError("matplotlib is required for plot_surface") from e
        kg = np.asarray(strike_grid if strike_grid is not None
                        else np.linspace(-0.3, 0.3, 25), np.float32)
        tg = np.asarray(maturity_grid if maturity_grid is not None
                        else np.linspace(0.1, 2.0, 15), np.float32)
        iv = self.generate_surface(kg, tg)
        kk, tt = np.meshgrid(kg, tg)
        fig = plt.figure(figsize=(8, 5))
        ax = fig.add_subplot(projection="3d")
        ax.plot_surface(kk, tt, iv, cmap="viridis", linewidth=0)
        ax.set_xlabel("strike coordinate")
        ax.set_ylabel("maturity")
        ax.set_zlabel("implied vol")
        if path:
            fig.savefig(path, dpi=110, bbox_inches="tight")
        return fig
