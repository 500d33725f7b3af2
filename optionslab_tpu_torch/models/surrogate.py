"""ML pricing surrogate: an MLP predicting (price, delta, gamma).

The port of ``optionslab_tpu/models/surrogate.py``: one multi-head MLP
trained on the device (default the card) on labels from the closed-form
``bs_greeks``, or on any pricer's outputs (``fit_to_pricer``: on the card,
one book launch of the GBM kernel gives price, delta and gamma for every
sampled contract); split-conformal bands; R² scores; save/load in the
reference's npz + json layout; ``.onnx`` export.

The contracts and the conformal split are drawn by numpy's
``default_rng``, so they are the reference's exactly; the weights'
initialisation and the per-epoch shuffles come from a ``torch.Generator``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from ..surface.nn_core import (
    ClippedAdamW,
    apply_mlp,
    clone_params,
    flatten_params,
    grad_step,
    init_mlp,
    make_generator,
    require_full_fp32,
    unflatten_params,
)
from ..utils.exceptions import ModelError
from .black_scholes import bs_greeks

PARAM_RANGES = {  # the reference's training box
    "spot": (50.0, 150.0),
    "strike": (50.0, 150.0),
    "maturity": (0.05, 2.0),
    "rate": (0.01, 0.1),
    "vol": (0.1, 0.5),
    "dividend": (0.0, 0.03),
}

WIDE_PARAM_RANGES = {  # production box: LEAPS maturities + crisis vols
    "spot": (50.0, 150.0),
    "strike": (50.0, 150.0),
    "maturity": (0.02, 5.0),
    "rate": (0.0, 0.12),
    "vol": (0.05, 1.0),
    "dividend": (0.0, 0.06),
}


def sample_contracts(n: int, seed: int = 0, ranges: dict | None = None) -> dict:
    """Random contract parameters over a training box (by default the
    reference's), as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    ranges = ranges or PARAM_RANGES
    out = {k: rng.uniform(lo, hi, n).astype(np.float32) for k, (lo, hi) in ranges.items()}
    out["cp"] = rng.choice(np.asarray([1.0, -1.0], np.float32), n)
    return out


SURROGATE_FEATURES = ("moneyness", "log_moneyness", "sqrt_maturity",
                      "maturity_x_vol", "rate", "dividend", "vol", "cp")


def engineer_surrogate_features(p: dict) -> np.ndarray:
    """(n, 8): moneyness, log-moneyness, √T, T·σ, r, q, σ, cp."""
    m = p["spot"] / p["strike"]
    return np.stack([
        m,
        np.log(m),
        np.sqrt(p["maturity"]),
        p["maturity"] * p["vol"],
        p["rate"],
        p["dividend"],
        p["vol"],
        p["cp"],
    ], axis=1).astype(np.float32)


PRICE_LOG_EPS = 1e-5  # the price head learns log(price/K + eps): relative
# error evens out across moneyness (deep-OTM prices span 4+ decades)


def generate_training_data(n: int = 50_000, seed: int = 0, ranges: dict | None = None,
                           device="cuda"):
    """(features, targets, contracts): targets (log(price/K + eps), delta,
    gamma·K) from one closed-form ``bs_greeks`` call on ``device``."""
    p = sample_contracts(n, seed, ranges)
    x = engineer_surrogate_features(p)
    dev = torch.device(device)
    g = bs_greeks(*(torch.as_tensor(p[k], device=dev)
                    for k in ("spot", "strike", "maturity", "rate", "vol", "cp", "dividend")))
    price, delta, gamma = (g[k].cpu().numpy() for k in ("price", "delta", "gamma"))
    y = np.stack([
        np.log(price / p["strike"] + PRICE_LOG_EPS),
        delta,
        gamma * p["strike"],  # scale-free gamma
    ], axis=1).astype(np.float32)
    return x, y, p


class MonteCarloMLSurrogate:
    """Multi-output (price, delta, gamma) surrogate with save/load and R²."""

    N_OUTPUTS = 3

    def __init__(self, hidden_layers=(128, 128), epochs: int = 300,
                 batch_size: int = 1024, learning_rate: float = 1e-3, seed: int = 0,
                 param_ranges: dict | None = None,
                 calibration_quantile: float = 0.9, device="cuda"):
        self.hidden_layers = tuple(hidden_layers)
        self.epochs = epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.param_ranges = dict(param_ranges or PARAM_RANGES)
        self.calibration_quantile = calibration_quantile
        self.device = torch.device(device)
        self.params = None
        self._x_mean = None
        self._x_scale = None
        self._y_mean = np.zeros(self.N_OUTPUTS, np.float32)
        self._y_scale = np.ones(self.N_OUTPUTS, np.float32)
        self._q_resid = np.zeros(self.N_OUTPUTS, np.float32)
        self.history = {}

    # -- training -----------------------------------------------------------
    def fit(self, n_samples: int = 50_000):
        x, y, _ = generate_training_data(n_samples, self.seed, self.param_ranges, self.device)
        return self._fit_xy(x, y)

    def fit_to_pricer(self, pricer_fn, n_samples: int = 20_000):
        """Train on an arbitrary pricer's outputs: ``pricer_fn(params dict)
        -> (n, 3) [price/K, delta, gamma·K]`` (an array or a tensor); the
        price column is turned into the log target here."""
        p = sample_contracts(n_samples, self.seed, self.param_ranges)
        x = engineer_surrogate_features(p)
        y = pricer_fn(p)
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        y = np.asarray(y, np.float32).copy()
        y[:, 0] = np.log(np.maximum(y[:, 0], 0.0) + PRICE_LOG_EPS)
        return self._fit_xy(x, y)

    def _fit_xy(self, x, y):
        # split-conformal calibration: hold out 10% the net never trains on
        n_cal = max(1, x.shape[0] // 10)
        rng = np.random.default_rng(self.seed + 1)
        perm = rng.permutation(x.shape[0])
        cal_idx, fit_idx = perm[:n_cal], perm[n_cal:]
        x_cal, y_cal = x[cal_idx], y[cal_idx]
        x, y = x[fit_idx], y[fit_idx]
        self._x_mean = x.mean(axis=0)
        self._x_scale = np.where(x.std(axis=0) < 1e-12, 1.0, x.std(axis=0))
        xs = (x - self._x_mean) / self._x_scale
        # per-head target standardization: without it the widest-scaled head
        # dominates the joint MSE and starves the others
        self._y_mean = y.mean(axis=0)
        self._y_scale = np.where(y.std(axis=0) < 1e-12, 1.0, y.std(axis=0))
        ys = (y - self._y_mean) / self._y_scale
        gen = make_generator(self.seed, self.device)
        params = init_mlp(gen, [x.shape[1], *self.hidden_layers, self.N_OUTPUTS])
        self.params, self.history = _train_multi(params, xs, ys, gen, epochs=self.epochs,
                                                 batch_size=self.batch_size,
                                                 learning_rate=self.learning_rate)
        # distribution-free uncertainty: per-head |residual| quantile on the
        # held-out set (split conformal)
        resid = np.abs(self._forward(x_cal) - y_cal)
        self._q_resid = np.quantile(resid, self.calibration_quantile,
                                    axis=0).astype(np.float32)
        return self.score_xy(x, y)

    # -- inference ----------------------------------------------------------
    def _forward(self, x: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise ModelError("surrogate not fitted")
        xs = (x - self._x_mean) / self._x_scale
        with torch.no_grad():
            raw = apply_mlp(self.params, torch.as_tensor(np.asarray(xs, np.float32),
                                                         device=self.device))
        return raw.cpu().numpy() * self._y_scale + self._y_mean

    def predict(self, S, K, T, r, sigma, option_type="call", q=0.0,
                return_uncertainty: bool = False) -> dict:
        """Batched (price, delta, gamma) in one forward; with
        ``return_uncertainty`` the conformal bands (``price_lo``,
        ``price_hi``, ``delta_err``, ``gamma_err``) at
        ``calibration_quantile`` coverage."""
        S, K, T, r, sigma = (np.asarray(a, np.float32).ravel() for a in (S, K, T, r, sigma))
        n = max(map(len, (S, K, T, r, sigma)))

        def broad(a):
            return np.broadcast_to(a, (n,)).astype(np.float32)

        cp = np.full(n, 1.0 if str(option_type).lower().startswith("c") else -1.0, np.float32)
        p = {"spot": broad(S), "strike": broad(K), "maturity": broad(T),
             "rate": broad(r), "vol": broad(sigma),
             "dividend": broad(np.asarray(q, np.float32)), "cp": cp}
        out = self._forward(engineer_surrogate_features(p))

        def to_price(v):
            return np.maximum(np.exp(v) - PRICE_LOG_EPS, 0.0) * p["strike"]

        result = {
            "price": to_price(out[:, 0]),
            "delta": out[:, 1],
            "gamma": out[:, 2] / p["strike"],
        }
        if return_uncertainty:
            q0, q1, q2 = self._q_resid
            result["price_lo"] = to_price(out[:, 0] - q0)
            result["price_hi"] = to_price(out[:, 0] + q0)
            result["delta_err"] = np.full(n, float(q1), np.float32)
            result["gamma_err"] = np.full(n, float(q2), np.float32) / p["strike"]
        return result

    def predict_single(self, S, K, T, r, sigma, option_type="call", q=0.0) -> dict:
        out = self.predict([S], [K], [T], [r], [sigma], option_type, q)
        return {k: float(v[0]) for k, v in out.items()}

    # -- evaluation ---------------------------------------------------------
    def score_xy(self, x, y) -> dict:
        pred = self._forward(x)
        r2 = []
        for j in range(self.N_OUTPUTS):
            ss_res = float(np.sum((pred[:, j] - y[:, j]) ** 2))
            ss_tot = float(np.sum((y[:, j] - y[:, j].mean()) ** 2))
            r2.append(1.0 - ss_res / max(ss_tot, 1e-12))
        return {"r2_price": r2[0], "r2_delta": r2[1], "r2_gamma": r2[2]}

    def score(self, n_samples: int = 10_000, seed: int = 123) -> dict:
        x, y, _ = generate_training_data(n_samples, seed, device=self.device)
        return self.score_xy(x, y)

    # -- persistence --------------------------------------------------------
    def save(self, path):
        if self.params is None:
            raise ModelError("cannot save an unfitted surrogate")
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        arrays = flatten_params(self.params)
        arrays["x_mean"] = self._x_mean
        arrays["x_scale"] = self._x_scale
        arrays["y_mean"] = self._y_mean
        arrays["y_scale"] = self._y_scale
        arrays["q_resid"] = self._q_resid
        np.savez(path / "arrays.npz", **arrays)
        (path / "meta.json").write_text(json.dumps({
            "hidden_layers": list(self.hidden_layers), "seed": self.seed,
            "param_ranges": {k: list(v) for k, v in self.param_ranges.items()},
            "calibration_quantile": self.calibration_quantile}))

    def export_onnx(self, path, atol: float = 2e-4) -> dict:
        """The fitted surrogate as a ``.onnx`` file: the whole standardized
        pipeline ``(x-μ)/σ -> MLP -> ·y_scale + y_mean`` in the graph,
        parity-checked against ``_forward`` at export. The outputs are the
        internal heads ``[log(price/K + eps), delta, gamma·K]``."""
        if self.params is None:
            raise ModelError("cannot export an unfitted surrogate")
        from ..optimize.onnx_emit import OnnxLiteRuntime, export_mlp_onnx

        manifest = export_mlp_onnx(
            self.params, path,
            mean=np.asarray(self._x_mean, np.float32),
            scale=np.asarray(self._x_scale, np.float32),
            layernorm=True,
            out_scale=np.asarray(self._y_scale, np.float32),
            out_mean=np.asarray(self._y_mean, np.float32),
            metadata={"model": type(self).__name__,
                      "heads": ["log_price_over_strike", "delta",
                                "gamma_times_strike"],
                      "features": list(SURROGATE_FEATURES)},
            doc="MonteCarloMLSurrogate raw heads (scalers folded in)")
        p = sample_contracts(64, self.seed + 7, self.param_ranges)
        x = engineer_surrogate_features(p)
        err = float(np.max(np.abs(self._forward(x) - OnnxLiteRuntime(path).predict(x))))
        if err > atol:
            raise ModelError(f"surrogate onnx export failed parity: "
                             f"max|err|={err:.3e} > {atol}")
        manifest["roundtrip_max_abs_err"] = err
        return manifest

    def load(self, path):
        path = pathlib.Path(path)
        meta = json.loads((path / "meta.json").read_text())
        arrays = dict(np.load(path / "arrays.npz"))
        self._x_mean = arrays.pop("x_mean")
        self._x_scale = arrays.pop("x_scale")
        self._y_mean = arrays.pop("y_mean", np.zeros(self.N_OUTPUTS, np.float32))
        self._y_scale = arrays.pop("y_scale", np.ones(self.N_OUTPUTS, np.float32))
        self._q_resid = arrays.pop("q_resid", np.zeros(self.N_OUTPUTS, np.float32))
        self.hidden_layers = tuple(int(h) for h in meta["hidden_layers"])
        self.param_ranges = {k: tuple(v) for k, v in meta.get(
            "param_ranges", {k: list(v) for k, v in PARAM_RANGES.items()}).items()}
        self.calibration_quantile = meta.get("calibration_quantile", 0.9)
        self.params = unflatten_params(arrays, self.device)
        return self


def _train_multi(params, x, y, generator: torch.Generator, *, epochs, batch_size,
                 learning_rate):
    """Multi-output MSE training: clipped AdamW (optax's default weight
    decay 1e-4), a fresh shuffle of the device-resident data every epoch,
    minibatches as slices; the per-epoch losses are read once, at the end."""
    require_full_fp32()
    dev = generator.device
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    params = clone_params(params)
    n = x.shape[0]
    batch_size = min(batch_size, n)
    n_batches = max(1, n // batch_size)
    opt = ClippedAdamW(params, learning_rate, weight_decay=1e-4, max_norm=1.0)
    epoch_losses = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator, device=dev)
        xs, ys = x[perm], y[perm]
        losses = []
        for i in range(n_batches):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            losses.append(grad_step(params, opt,
                                     lambda p: F.mse_loss(apply_mlp(p, xs[sl]), ys[sl])))
        epoch_losses.append(torch.stack(losses).mean())
    history = {"loss": [float(v) for v in torch.stack(epoch_losses).cpu().numpy()]}
    return params, history
