"""Arbitrage-constrained PINN volatility surface.

The port of ``optionslab_tpu/surface/pinn.py``: the network outputs total
variance w(k, T) = σ²T through a softplus head; penalties by autograd on
collocation points: calendar ∂w/∂T ≥ 0, butterfly (Gatheral's g(k) ≥ 0 from
∂w/∂k and ∂²w/∂k²) and the Roger–Lee wing slope |∂w/∂k| ≤ 2; annealed
penalty weights and a cosine-decayed clipped AdamW; the numeric calendar and
butterfly audits; an ensemble of independently seeded fits with a
deterministic member selection.

The derivatives are taken per point by ``torch.autograd.grad`` of the
summed output with ``create_graph=True`` (the points are independent, so
this equals the reference's per-point ``vmap(grad)``); training
differentiates through them once more. The ensemble is one batched network
(weights with a leading member axis, ``torch.baddbmm``), each member drawing
its collocation points from its own generator. The loop is issued from the
host with no host synchronisation per epoch; the weights, the quotes and
the optimizer state live on ``device`` (default the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.exceptions import ModelError, ValidationError
from .base import TARGET_COLUMN, VolatilityModelBase, regression_metrics
from .nn_core import (
    ClippedAdamW,
    apply_mlp,
    clone_params,
    cosine_decay_schedule,
    flatten_params,
    gelu_tanh_ops,
    init_mlp,
    leaves,
    make_generator,
    require_full_fp32,
    unflatten_params,
    where_params,
)

PENALTY_PRESETS = {
    "weak": {"calendar": 0.1, "butterfly": 0.1, "wing": 0.01},
    "medium": {"calendar": 1.0, "butterfly": 1.0, "wing": 0.1},
    "strong": {"calendar": 10.0, "butterfly": 10.0, "wing": 1.0},
}


def _w_fn(params, k, t):
    """Total variance w(k, T) ≥ 0: a softplus head over the MLP (no
    LayerNorm, as in the reference; GELU from elementary ops, since the
    training differentiates it three times)."""
    raw = apply_mlp(params, torch.stack([k, t], dim=-1), layernorm=False,
                    activation=gelu_tanh_ops)[..., 0]
    return F.softplus(raw)


def _w_derivs(params, k, t, create_graph: bool = True):
    """(w, ∂w/∂k, ∂²w/∂k², ∂w/∂T) at independent points."""
    with torch.enable_grad():
        k = k.detach().requires_grad_(True)
        t = t.detach().requires_grad_(True)
        w = _w_fn(params, k, t)
        dwdk, dwdt = torch.autograd.grad(w.sum(), (k, t), create_graph=True)
        (d2wdk2,) = torch.autograd.grad(dwdk.sum(), k, create_graph=create_graph)
    return w, dwdk, d2wdk2, dwdt


def _g_of(k, w, dwdk, d2wdk2):
    """Gatheral's butterfly density function g(k)."""
    w_safe = torch.clamp_min(w, 1e-8)
    return (1.0 - k * dwdk / (2.0 * w_safe)) ** 2 \
        - 0.25 * dwdk**2 * (1.0 / w_safe + 0.25) + 0.5 * d2wdk2


def _g_fn(params, k, t):
    w, dwdk, d2wdk2, _ = _w_derivs(params, k, t)
    return _g_of(k, w, dwdk, d2wdk2)


def _calendar(dwdt):
    return torch.mean(torch.clamp_min(-dwdt, 0.0) ** 2, dim=-1)


def _butterfly(g):
    return torch.mean(torch.clamp_min(-g, 0.0) ** 2, dim=-1)


def _wing(dwdk):
    return torch.mean(torch.clamp_min(torch.abs(dwdk) - 2.0, 0.0) ** 2, dim=-1)


def calendar_penalty(params, k, t):
    """mean max(0, −∂w/∂T)²: total variance must not fall in T."""
    return _calendar(_w_derivs(params, k, t)[3])


def butterfly_penalty(params, k, t):
    """mean max(0, −g)²."""
    return _butterfly(_g_fn(params, k, t))


def wing_penalty(params, k, t):
    """Roger–Lee: mean max(0, |∂w/∂k| − 2)²."""
    return _wing(_w_derivs(params, k, t)[1])


def _implied_vol(w, t):
    return torch.sqrt(torch.clamp_min(w, 1e-12) / torch.clamp_min(t, 1e-6))


def _pinn_loss(p, kk, tt, lam: float, k_obs, t_obs, iv, lam_w):
    """(loss, fit) per member: the fit in IV space on the quotes (w errors
    at short T amplify as 1/√T in vol) plus the annealed penalties on the
    collocation points ``kk``, ``tt`` ((B, n_col) for params stacked on B
    members, (n_col,) otherwise). One forward serves both sets of points."""
    lam_cal, lam_bf, lam_wing = lam_w
    n_obs = k_obs.shape[-1]
    k_all = torch.cat([k_obs.expand(*kk.shape[:-1], n_obs), kk], dim=-1)
    t_all = torch.cat([t_obs.expand(*tt.shape[:-1], n_obs), tt], dim=-1)
    w, dwdk, d2wdk2, dwdt = _w_derivs(p, k_all, t_all)
    fit = torch.mean((_implied_vol(w[..., :n_obs], t_obs) - iv) ** 2, dim=-1)
    c = slice(n_obs, None)
    g = _g_of(kk, w[..., c], dwdk[..., c], d2wdk2[..., c])
    pen = (lam_cal * _calendar(dwdt[..., c]) + lam_bf * _butterfly(g)
           + lam_wing * _wing(dwdk[..., c]))
    return fit + lam * pen, fit


def _draw(generators, n_col: int, lo: float, hi: float) -> torch.Tensor:
    """(B, n_col) uniform points on [lo, hi), member b's from its own generator."""
    u = torch.stack([torch.rand(n_col, generator=g, device=g.device) for g in generators])
    return u * (hi - lo) + lo


def _train_pinn_core(params_b, k_obs, t_obs, iv, lam_w, ranges, generators, *,
                     epochs, n_col, warm, track_from, learning_rate):
    """B independent annealed PINN fits as one batched network (the
    reference's ``_train_pinn_scanned`` at B = 1, ``_train_pinn_ensemble``
    above it): params with a leading member axis, member b's collocation
    points from ``generators[b]``. The best-loss iterate is tracked from ``track_from``
    on, with ``torch.where``. Returns (best_params, best_loss (B,),
    losses (B, epochs), fits (B, epochs)) on the device."""
    require_full_fp32()
    k_lo, k_hi, t_lo, t_hi = ranges
    params = clone_params(params_b)
    opt = ClippedAdamW(params, cosine_decay_schedule(learning_rate, epochs, alpha=0.02),
                       weight_decay=1e-6, max_norm=1.0, members=True)
    best_p = clone_params(params)
    best_l = torch.full((len(generators),), math.inf, device=k_obs.device)
    losses, fits = [], []
    for e in range(epochs):
        lam = min(1.0, e / warm) ** 2
        kk = _draw(generators, n_col, k_lo, k_hi)
        tt = _draw(generators, n_col, t_lo, t_hi)
        live = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
                for layer in params]
        loss, fit = _pinn_loss(live, kk, tt, lam, k_obs, t_obs, iv, lam_w)
        opt.step(torch.autograd.grad(loss.sum(), leaves(live), allow_unused=True,
                                     materialize_grads=True))
        loss = loss.detach()
        if e >= track_from:
            better = loss < best_l
            best_p = where_params(better, params, best_p)
            best_l = torch.where(better, loss, best_l)
        losses.append(loss)
        fits.append(fit.detach())
    return best_p, best_l, torch.stack(losses, dim=1), torch.stack(fits, dim=1)


def _member_selection_stats(params_b, k_obs, t_obs, iv, ranges):
    """Per member (observed-quote IV RMSE, worst arbitrage violation on a
    fixed 25 × 13 audit lattice): the deterministic selection statistics."""
    k_lo, k_hi, t_lo, t_hi = ranges
    dev = k_obs.device
    kg = torch.linspace(k_lo, k_hi, 25, dtype=torch.float32, device=dev)
    tg = torch.linspace(t_lo, t_hi, 13, dtype=torch.float32, device=dev)
    kk, tt = (a.reshape(-1) for a in torch.meshgrid(kg, tg, indexing="xy"))
    with torch.no_grad():
        w_obs = _w_fn(params_b, k_obs.expand(params_b[0]["w"].shape[0], -1),
                      t_obs.expand(params_b[0]["w"].shape[0], -1))
        rmse = torch.sqrt(torch.mean((_implied_vol(w_obs, t_obs) - iv) ** 2, dim=-1))
    n = params_b[0]["w"].shape[0]
    w, dwdk, d2wdk2, dwdt = _w_derivs(params_b, kk.expand(n, -1), tt.expand(n, -1),
                                      create_graph=False)
    g = _g_of(kk, w, dwdk, d2wdk2).detach()
    viol = torch.maximum(torch.clamp_min(-dwdt.detach(), 0.0).amax(dim=-1),
                         torch.clamp_min(-g, 0.0).amax(dim=-1))
    return rmse, viol


def select_ensemble_member(rmse_b, viol_b, tol: float = 1e-6) -> int:
    """Lexicographic member choice: arbitrage-clean members first (worst
    audit violation ≤ tol), then the lowest observed-quote RMSE. A diverged
    member (NaN stats) ranks last: NaN comparisons are all false, so without
    the guard ``bool(nan > tol)`` reads as clean."""
    rmse_b = np.asarray(rmse_b, np.float64)
    viol_b = np.asarray(viol_b, np.float64)
    bad = ~(np.isfinite(rmse_b) & np.isfinite(viol_b))
    keys = [(bool(b), bool(b or v > tol), float(r) if not b else np.inf, i)
            for i, (r, v, b) in enumerate(zip(rmse_b, viol_b, bad))]
    return min(keys)[3]


def check_calendar_arbitrage(w_grid, axis: int = 0) -> float:
    """Numeric violation fraction: w must be non-decreasing along maturity."""
    d = np.diff(np.asarray(w_grid), axis=axis)
    return float(np.mean(d < -1e-8))


def check_butterfly_arbitrage(k, w) -> float:
    """Numeric g(k) check by non-uniform finite differences on one slice;
    the violation fraction over the interior points (``np.gradient``'s
    one-sided endpoint second derivative misfires at the box's edge)."""
    k = np.asarray(k, np.float64)
    w = np.asarray(w, np.float64)
    wp = np.gradient(w, k)
    wpp = np.gradient(wp, k)
    w_safe = np.maximum(w, 1e-8)
    g = (1 - k * wp / (2 * w_safe)) ** 2 - 0.25 * wp**2 * (1 / w_safe + 0.25) + 0.5 * wpp
    return float(np.mean((g < -1e-6)[1:-1]))


def _f32(x) -> float:
    return float(np.float32(x))


class PINNVolatilityModel(VolatilityModelBase):
    """PINN surface model: inputs (log-moneyness, TTM), output total variance.

    The physics constraints need the raw (k, T) coordinates, so this model
    uses exactly those two features.
    """

    def __init__(self, hidden_layers=(64, 64), preset: str = "medium",
                 penalty_weights: dict | None = None, n_collocation: int = 512,
                 learning_rate: float = 3e-3, epochs: int = 1200,
                 batch_size: int = 512, patience: int = 200, seed: int = 0, device="cuda"):
        super().__init__(feature_columns=["log_moneyness", "time_to_maturity"])
        if preset not in PENALTY_PRESETS:
            raise ValidationError(f"unknown preset {preset!r}; choose {list(PENALTY_PRESETS)}")
        self.hidden_layers = tuple(hidden_layers)
        self.weights = dict(penalty_weights or PENALTY_PRESETS[preset])
        self.preset = preset
        self.n_collocation = n_collocation
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.patience = patience
        self.seed = seed
        self.device = torch.device(device)
        self.params = None
        self._k_range = (-1.0, 1.0)
        self._t_range = (0.01, 3.0)

    def _col(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    # -- training -----------------------------------------------------------
    def _train_impl(self, df, n_seeds: int = 1, **kwargs) -> dict:
        k_np = np.asarray(df["log_moneyness"], np.float32)
        t_np = np.asarray(df["time_to_maturity"], np.float32)
        iv_np = np.asarray(df[TARGET_COLUMN], np.float32)
        k_obs, t_obs, iv = self._col(k_np), self._col(t_np), self._col(iv_np)

        self._k_range = (float(k_np.min()) - 0.25, float(k_np.max()) + 0.25)
        self._t_range = (max(float(t_np.min()) * 0.5, 1e-3), float(t_np.max()) * 1.25)

        if n_seeds < 1:
            raise ValidationError(f"n_seeds must be >= 1: {n_seeds}")
        gens = [make_generator(self.seed + i, self.device) for i in range(n_seeds)]
        # head bias so softplus(bias) ≈ the mean observed total variance: the
        # net starts on the surface instead of at softplus(0) ≈ 0.69
        w_mean = float(np.mean(iv_np * iv_np * t_np))
        inv_sp = float(np.log(np.expm1(max(w_mean, 1e-4))))
        inits = []
        for g in gens:
            p = init_mlp(g, [2, *self.hidden_layers, 1])
            p[-1]["b"][0] = inv_sp
            inits.append(p)
        params_b = [{k: torch.stack([p[i][k] for p in inits]) for k in inits[0][i]}
                    for i in range(len(inits[0]))]

        lam_w = tuple(_f32(self.weights[k]) for k in ("calendar", "butterfly", "wing"))
        ranges = tuple(_f32(v) for v in (*self._k_range, *self._t_range))
        # penalty annealing: fit the surface first, then ramp the penalties
        # to full weight over the first 30% of training; track the best
        # loss from 40% in
        best_b, best_l, losses_b, fits_b = _train_pinn_core(
            params_b, k_obs, t_obs, iv, lam_w, ranges, gens, epochs=int(self.epochs),
            n_col=int(self.n_collocation), warm=max(1, int(self.epochs * 0.3)),
            track_from=int(self.epochs * 0.4), learning_rate=float(self.learning_rate))
        if n_seeds == 1:
            i_best = 0
            self.ensemble_params = None
            self.ensemble_best_losses = None
            self.ensemble_selection = None
        else:
            # the kept member: arbitrage-clean on a fixed audit lattice, then
            # the quote RMSE; never the training loss, whose per-member
            # collocation noise can crown a lucky fit
            rmse_b, viol_b = _member_selection_stats(best_b, k_obs, t_obs, iv, ranges)
            rmse_b, viol_b = rmse_b.cpu().numpy(), viol_b.cpu().numpy()
            i_best = select_ensemble_member(rmse_b, viol_b)
            self.ensemble_params = best_b
            self.ensemble_best_losses = best_l.cpu().numpy()
            self.ensemble_selection = {
                "index": int(i_best),
                "loss_argmin": int(np.argmin(self.ensemble_best_losses)),
                "rmse": rmse_b,
                "max_violation": viol_b,
            }
        self.params = [{k: v[i_best].clone() for k, v in layer.items()} for layer in best_b]
        self.training_history = {"loss": [float(v) for v in losses_b[i_best].cpu().numpy()],
                                 "fit": [float(v) for v in fits_b[i_best].cpu().numpy()]}
        pred_iv = self._iv(k_np, t_np)
        metrics = regression_metrics(iv_np, pred_iv)
        if n_seeds > 1:
            metrics["ensemble_loss_spread"] = float(
                self.ensemble_best_losses.max() - self.ensemble_best_losses.min())
            metrics["ensemble_selected"] = int(i_best)
        return metrics

    def iv_band(self, k, t):
        """Across-seed band of the ensemble surface: dict of (mean, std, lo,
        hi) implied-vol arrays over the member nets. Needs ``train(df,
        n_seeds > 1)`` first."""
        if getattr(self, "ensemble_params", None) is None:
            raise ModelError("iv_band needs train(df, n_seeds > 1)")
        k, t = self._col(k), self._col(t)
        with torch.no_grad():
            ivs = _implied_vol(_w_fn(self.ensemble_params, k, t), t)
        return {"mean": ivs.mean(dim=0).cpu().numpy(),
                "std": ivs.std(dim=0, correction=0).cpu().numpy(),
                "lo": ivs.amin(dim=0).cpu().numpy(),
                "hi": ivs.amax(dim=0).cpu().numpy()}

    def _iv(self, k, t) -> np.ndarray:
        k, t = self._col(k), self._col(t)
        with torch.no_grad():
            return _implied_vol(_w_fn(self.params, k, t), t).cpu().numpy()

    def export_forward(self):
        """The deployable forward: raw (k, T) feature matrix → implied-vol
        column (``optimize.export_surface_model``)."""
        params = self.params

        def fn(x):
            return _implied_vol(_w_fn(params, x[:, 0], x[:, 1]), x[:, 1])[:, None]

        return fn

    def _predict_impl(self, df) -> np.ndarray:
        return self._iv(df["log_moneyness"], df["time_to_maturity"]).ravel()

    def total_variance_grid(self, k_grid, t_grid):
        kk, tt = torch.meshgrid(self._col(k_grid), self._col(t_grid), indexing="xy")
        with torch.no_grad():
            w = _w_fn(self.params, kk.reshape(-1), tt.reshape(-1))
        return w.cpu().numpy().reshape(kk.shape)

    def check_arbitrage(self, n_k: int = 101, n_t: int = 21) -> dict:
        """Dense-grid audit of the fitted surface."""
        k = np.linspace(*self._k_range, n_k)
        t = np.linspace(*self._t_range, n_t)
        w = self.total_variance_grid(k, t)  # (n_t, n_k)
        cal_viol = check_calendar_arbitrage(w, axis=0)
        bf_viols = [check_butterfly_arbitrage(k, w[i]) for i in range(n_t)]
        return {
            "calendar_violation_rate": cal_viol,
            "butterfly_violation_rate": float(np.mean(bf_viols)),
            "arbitrage_free": cal_viol == 0.0 and float(np.mean(bf_viols)) == 0.0,
        }

    # -- persistence --------------------------------------------------------
    def _state(self):
        meta = {
            "hidden_layers": list(self.hidden_layers),
            "preset": self.preset,
            "weights": self.weights,
            "k_range": list(self._k_range),
            "t_range": list(self._t_range),
            "seed": self.seed,
        }
        return flatten_params(self.params), meta

    def _load_state(self, arrays, meta):
        self.hidden_layers = tuple(int(h) for h in meta["hidden_layers"])
        self.weights = dict(meta["weights"])
        self._k_range = tuple(meta["k_range"])
        self._t_range = tuple(meta["t_range"])
        self.params = unflatten_params(arrays, self.device)


def dryrun_train_step_sharded(n_devices: int, devices=None, params=None,
                              n_quotes: int | None = None):
    """One data-parallel PINN train step on an ``n_devices`` mesh (the
    reference's layer sizes [2, 16, 16, 1] and penalties): the quotes are
    split over the shards, each shard takes the gradient of its share of the
    mean-squared fit on its own device, the collocation penalties' gradient
    is taken once on the first device, the gradients are summed there in
    shard order, and one Adam step (lr 1e-3) updates the parameters.

    ``devices`` defaults to the visible CUDA devices (``parallel.make_mesh``),
    ``params`` to a seed-0 initialisation on the first device, ``n_quotes``
    to 16 a device. Returns (loss, params after the step); raises if the
    loss is not finite."""
    from ..parallel.mesh import make_mesh

    devs = make_mesh(n_devices, devices=devices).device_list()
    home = devs[0]
    if params is None:
        params = init_mlp(make_generator(0, home), [2, 16, 16, 1])
    params = [{k: v.detach().to(home).clone() for k, v in layer.items()} for layer in params]
    n = n_quotes or 16 * n_devices
    k_obs = torch.linspace(-0.5, 0.5, n, dtype=torch.float32, device=home)
    t_obs = torch.full((n,), 0.5, dtype=torch.float32, device=home)
    w_obs = torch.full((n,), 0.02, dtype=torch.float32, device=home)
    kk = torch.linspace(-0.5, 0.5, 32, dtype=torch.float32, device=home)
    tt = torch.full((32,), 0.5, dtype=torch.float32, device=home)

    def grads_on(dev, loss_fn):
        live = [{k: v.detach().to(dev).requires_grad_(True) for k, v in layer.items()}
                for layer in params]
        with torch.enable_grad():
            loss = loss_fn(live)
            g = torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), g

    pieces = [torch.tensor_split(x, len(devs)) for x in (k_obs, t_obs, w_obs)]
    shards = []
    for j, dev in enumerate(devs):
        k, t, w = (piece[j].to(dev) for piece in pieces)
        shards.append(grads_on(dev, lambda p, k=k, t=t, w=w:
                               torch.sum((_w_fn(p, k, t) - w) ** 2) / n))
    pen_loss, pen_grads = grads_on(home, lambda p: calendar_penalty(p, kk, tt)
                                   + butterfly_penalty(p, kk, tt) + wing_penalty(p, kk, tt))
    loss = shards[0][0].to(home)
    grads = [g.to(home) for g in shards[0][1]]
    for s_loss, s_grads in shards[1:]:
        loss = loss + s_loss.to(home)
        grads = [a + b.to(home) for a, b in zip(grads, s_grads)]
    loss = loss + pen_loss
    grads = [a + b for a, b in zip(grads, pen_grads)]
    opt = ClippedAdamW(params, 1e-3, weight_decay=0.0, max_norm=math.inf)
    opt.step(grads)
    if not math.isfinite(float(loss)):
        raise ModelError("PINN sharded train step produced a non-finite loss")
    return loss, params
