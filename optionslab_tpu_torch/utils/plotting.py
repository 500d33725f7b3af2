"""Matplotlib render helpers for the command line.

The port of ``optionslab_tpu/utils/plotting.py``: the smile fits, the 3-D
SSVI surface and the early-exercise boundary as PNG files, from
``python -m optionslab_tpu_torch.cli plot``. matplotlib is optional: each
function raises :class:`DependencyError` without it, before it computes
anything, and forces the headless Agg backend with it. They return the
figure so tests can inspect its artists.
"""
from __future__ import annotations

import numpy as np
import torch

from .exceptions import DependencyError

__all__ = ["plot_smile_fits", "plot_ssvi_surface", "plot_exercise_boundary"]


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:
        raise DependencyError("matplotlib is required for plotting") from e


def plot_smile_fits(chain, result, path=None, max_panels: int = 6):
    """Market quotes + fitted SVI smile, one panel per expiry."""
    from ..surface.chain_calibration import chain_smile_data

    plt = _plt()
    n = min(len(result.expiries), max_panels)
    ncol = min(n, 3)
    nrow = (n + ncol - 1) // ncol
    fig, axes = plt.subplots(nrow, ncol, figsize=(4.2 * ncol, 3.2 * nrow),
                             squeeze=False)
    for i in range(n):
        ax = axes[i // ncol][i % ncol]
        d = chain_smile_data(chain, result, i)
        ax.plot(d["k_market"], d["iv_market"], ".", ms=4, alpha=0.6,
                label="market")
        ax.plot(d["k_fit"], d["iv_fit"], lw=1.5,
                label=f"SVI (rmse {result.svi_rmse_vol[i] * 100:.2f} vol pts)")
        ax.set_title(f"T = {d['expiry']:.3f}y  ({result.n_quotes[i]} quotes)")
        ax.set_xlabel("log-moneyness k = ln(K/F)")
        ax.set_ylabel("implied vol")
        ax.legend(fontsize=7)
    for j in range(n, nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig


def plot_ssvi_surface(result, path=None, n_k: int = 41, n_t: int = 25):
    """3-D render of the calibrated SSVI surface (theta linearly
    interpolated between fitted expiries), evaluated on the fit's device."""
    from ..surface.svi import ssvi_total_variance

    plt = _plt()
    t_lo, t_hi = float(result.expiries[0]), float(result.expiries[-1])
    tg = np.linspace(t_lo, t_hi, n_t)
    kg = np.linspace(-0.4, 0.4, n_k)
    theta_g = np.interp(tg, result.expiries, result.thetas)
    kk, tt = np.meshgrid(kg, tg)
    dev = result.ssvi.eta.device
    w = ssvi_total_variance(
        torch.as_tensor(kk, dtype=torch.float32, device=dev),
        torch.as_tensor(np.broadcast_to(theta_g[:, None], kk.shape).copy(),
                        dtype=torch.float32, device=dev),
        result.ssvi).cpu().numpy()
    iv = np.sqrt(np.maximum(w, 1e-12) / tt)
    fig = plt.figure(figsize=(8, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(kk, tt, iv, cmap="viridis", linewidth=0)
    ax.set_xlabel("log-moneyness k")
    ax.set_ylabel("maturity (y)")
    ax.set_zlabel("implied vol")
    rho = float(result.ssvi.rho)
    eta = float(result.ssvi.eta)
    ax.set_title(f"SSVI surface  (rho={rho:.3f}, eta={eta:.3f}, "
                 f"rmse {result.ssvi_rmse_vol * 100:.2f} vol pts)")
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig


def plot_exercise_boundary(spot=100.0, strike=100.0, maturity=1.0, rate=0.05,
                           vol=0.2, cp=-1.0, n_paths: int = 50_000,
                           n_dates: int = 50, seed: int = 0, path=None, device="cuda"):
    """LSM early-exercise boundary vs time for an American option, the
    paths drawn on ``device`` from a generator seeded with ``seed``
    (reference: ``exotic_options.py:309`` + dashboard exotics page)."""
    from ..models.exotics import lsm_exercise_boundary

    plt = _plt()
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    boundary = lsm_exercise_boundary(
        spot, strike, maturity, rate, vol, gen, cp=cp,
        n_paths=n_paths, n_dates=n_dates).cpu().numpy()
    # the boundary is defined at the intermediate exercise dates
    t = np.linspace(maturity / n_dates, maturity, n_dates)[:len(boundary)]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(t, boundary, lw=1.5, label="LSM exercise boundary")
    ax.axhline(strike, color="gray", ls="--", lw=1, label=f"strike {strike:g}")
    ax.set_xlabel("time (y)")
    ax.set_ylabel("critical spot")
    kind = "put" if cp < 0 else "call"
    ax.set_title(f"American {kind} early-exercise boundary "
                 f"(S0={spot:g}, sigma={vol:g}, r={rate:g})")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
    return fig
