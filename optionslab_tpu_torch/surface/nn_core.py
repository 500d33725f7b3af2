"""Shared MLP core for the learned surfaces and the pricing surrogate.

The port of ``optionslab_tpu/surface/nn_core.py``: an MLP as a list of
dicts of tensors (``w`` (fan_in, fan_out), ``b``, ``ln_scale``,
``ln_bias``), a functional forward (:func:`apply_mlp`), He initialisation,
dropout from an explicit ``torch.Generator``, and the training recipe
(clip by global norm, AdamW, early stopping or best-validation tracking).

Written out to match the reference's arithmetic:

* GELU is the tanh approximation (``jax.nn.gelu``'s default), not torch's
  erf default;
* LayerNorm uses the population variance with the epsilon 1e-6 inside the
  square root;
* :class:`ClippedAdamW` is ``optax.chain(clip_by_global_norm(c),
  adamw(lr, weight_decay=wd))``: the gradient is scaled by ``c / norm`` only
  when ``norm >= c`` (no epsilon), Adam's epsilon sits outside the square
  root, every leaf is decayed (LayerNorm scales too), and a schedule is read
  at the update count before the update.

The reference runs a whole fit as one device program; here the loop is
issued from the host, but each step stays on the device: losses are kept as
tensors, minibatches are slices of device-resident tensors, and the best
iterate is chosen by ``torch.where``. Values are read where the reference
reads them: per epoch on the early-stopping path, at the end otherwise.
Matrix products run in full float32 (:func:`require_full_fp32`).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.exceptions import ModelError

LN_EPS = 1e-6
_GELU_C = math.sqrt(2.0 / math.pi)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: 0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³)))."""
    return F.gelu(h, approximate="tanh")


def gelu_tanh_ops(h: torch.Tensor) -> torch.Tensor:
    """The same GELU from elementary ops, in ``jax.nn.gelu``'s order, for
    autograd to third order: torch's fused GELU gives a NaN third derivative
    in float32 once |x| reaches ≈20."""
    return h * (0.5 * (1.0 + torch.tanh(_GELU_C * (h + 0.044715 * h**3))))


def require_full_fp32() -> None:
    """The learned surfaces' accuracy claims sit at the 1e-3 level, which
    TF32 products would erode: refuse to run with TF32 matmuls on."""
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise ModelError("the learned surfaces need full float32 matrix products: "
                         "torch.get_float32_matmul_precision() must be 'highest' and "
                         "torch.backends.cuda.matmul.allow_tf32 False")


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def init_mlp(generator: torch.Generator, sizes: Sequence[int], dtype=torch.float32) -> list:
    """He-initialised params on the generator's device: a list of
    {'w', 'b', 'ln_scale', 'ln_bias'}."""
    dev = generator.device
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator, dtype=dtype, device=dev)
        params.append({
            "w": w * math.sqrt(2.0 / fan_in),
            "b": torch.zeros(fan_out, dtype=dtype, device=dev),
            "ln_scale": torch.ones(fan_out, dtype=dtype, device=dev),
            "ln_bias": torch.zeros(fan_out, dtype=dtype, device=dev),
        })
    return params


def _linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if w.dim() == 3:  # members stacked on a leading axis: h is (B, n, fan_in)
        return torch.baddbmm(b.unsqueeze(1), h.expand(w.shape[0], *h.shape[-2:]), w)
    if h.dim() == 2:
        return torch.addmm(b, h, w)
    return torch.matmul(h, w) + b


def _layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(h − mean)·rsqrt(var + 1e-6)·scale + bias, population variance."""
    if scale.dim() == 1:
        return F.layer_norm(h, (h.shape[-1],), scale, bias, LN_EPS)
    return F.layer_norm(h, (h.shape[-1],), None, None, LN_EPS) * scale.unsqueeze(1) \
        + bias.unsqueeze(1)


def apply_mlp(params, x: torch.Tensor, *, dropout_rate: float = 0.0,
              generator: torch.Generator | None = None, layernorm: bool = True,
              activation: Callable = gelu_tanh) -> torch.Tensor:
    """Forward pass; hidden layers get activation (+LayerNorm, +dropout),
    the final layer is linear. Params with a leading member axis (``w``
    (B, fan_in, fan_out)) run B networks at once on x of (B, n, d) or (n, d).
    Dropout draws its masks from ``generator`` (none without one)."""
    h = x
    n = len(params)
    for i, layer in enumerate(params):
        h = _linear(h, layer["w"], layer["b"])
        if i < n - 1:
            if layernorm:
                h = _layer_norm(h, layer["ln_scale"], layer["ln_bias"])
            h = activation(h)
            if dropout_rate > 0.0 and generator is not None:
                keep = torch.rand(h.shape, generator=generator, dtype=h.dtype,
                                  device=h.device) < (1.0 - dropout_rate)
                h = torch.where(keep, h / (1.0 - dropout_rate), 0.0)
    return h


def leaves(params) -> list:
    """The parameter tensors in a fixed order (layer by layer, by key)."""
    return [layer[k] for layer in params for k in sorted(layer)]


def clone_params(params) -> list:
    return [{k: v.detach().clone() for k, v in layer.items()} for layer in params]


def where_params(cond: torch.Tensor, new, old) -> list:
    """``new`` where ``cond`` else ``old``, leaf by leaf; ``cond`` is 0-d or,
    for stacked members, (B,)."""
    def pick(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)

    return [{k: pick(a[k], b[k]) for k in a} for a, b in zip(new, old)]


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1=0.9,
    b2=0.999, eps=1e-8, weight_decay=wd))`` written out, updating the
    parameter tensors in place.

    ``learning_rate`` is a number or a schedule ``lr(count)`` read at the
    number of updates made before this one. With ``members`` the leaves carry
    a leading axis of independent networks and each is clipped by its own
    global norm, as under ``vmap``.
    """

    def __init__(self, params, learning_rate, weight_decay: float = 1e-4,
                 max_norm: float = 1.0, members: bool = False):
        self.leaves = leaves(params)
        self.learning_rate = learning_rate
        self.weight_decay = float(weight_decay)
        self.max_norm = float(max_norm)
        self.members = members
        self.mu = [torch.zeros_like(p) for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    def _clip(self, grads: list) -> list:
        """The gradient scaled by min(1, max_norm / global norm)."""
        if self.members:
            b = grads[0].shape[0]
            norm = torch.cat([g.reshape(b, -1) for g in grads], 1).square().sum(1).sqrt()
        else:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.clamp(self.max_norm / norm, max=1.0)
        if self.members:
            return [g * scale.reshape((-1,) + (1,) * (g.dim() - 1)) for g in grads]
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = self._clip(list(grads))
        lr = self.learning_rate
        lr = float(lr(self.count) if callable(lr) else lr)
        self.count += 1
        torch._foreach_mul_(self.mu, _B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - _B2)
        denom = torch._foreach_div(self.nu, 1.0 - _B2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(self.mu, 1.0 - _B1 ** self.count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.leaves, alpha=self.weight_decay)
        torch._foreach_add_(self.leaves, upd, alpha=-lr)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``: init·((1 − α)·½(1 + cos(π·min(c, T)/T)) + α)."""
    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
                             + alpha)

    return schedule


def grad_step(params, opt: ClippedAdamW, loss_fn) -> torch.Tensor:
    """One optimizer step on ``loss_fn(params)``; returns the detached loss."""
    live = [{k: v.detach().requires_grad_(True) for k, v in layer.items()} for layer in params]
    loss = loss_fn(live)
    opt.step(torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                 materialize_grads=True))
    return loss.detach()


def train_mlp(params, x, y, loss_extra_fn=None, *, generator: torch.Generator,
              epochs: int = 200, batch_size: int = 256, learning_rate: float = 1e-3,
              weight_decay: float = 1e-5, dropout_rate: float = 0.1, patience: int = 15,
              grad_clip: float = 1.0, val_fraction: float = 0.15, verbose: bool = False,
              layernorm: bool = True):
    """Clipped AdamW with early stopping (the reference's recipe) on the
    generator's device; the generator draws the train/validation permutation
    and every dropout mask.

    ``loss_extra_fn(params, xb) -> scalar`` adds physics/smoothness
    penalties. Without one (and not ``verbose``) every epoch runs and the
    best validation iterate is tracked on the device; with one, training
    stops ``patience`` epochs after the last improvement, reading the
    validation loss each epoch. Returns (best_params, history dict).
    """
    require_full_fp32()
    dev = generator.device
    x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev).reshape(-1, 1)
    params = clone_params(params)
    n = x.shape[0]
    n_val = max(1, int(n * val_fraction))
    perm = torch.randperm(n, generator=generator, device=dev)
    x, y = x[perm], y[perm]
    x_tr, y_tr = x[n_val:], y[n_val:]
    x_va, y_va = x[:n_val], y[:n_val]
    n_tr = x_tr.shape[0]
    batch_size = min(batch_size, n_tr)
    n_batches = max(1, n_tr // batch_size)
    opt = ClippedAdamW(params, learning_rate, weight_decay, grad_clip)

    def batch_loss(p, xb, yb):
        pred = apply_mlp(p, xb, dropout_rate=dropout_rate, generator=generator,
                         layernorm=layernorm)
        loss = F.mse_loss(pred, yb)
        if loss_extra_fn is not None:
            loss = loss + loss_extra_fn(p, xb)
        return loss

    @torch.no_grad()
    def val_loss(p):
        return F.mse_loss(apply_mlp(p, x_va, layernorm=layernorm), y_va)

    def epoch():
        losses = []
        for i in range(n_batches):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            losses.append(grad_step(params, opt,
                                     lambda p: batch_loss(p, x_tr[sl], y_tr[sl])))
        return torch.stack(losses).mean()

    if loss_extra_fn is None and not verbose:
        best_p, best_v = clone_params(params), val_loss(params)
        tr_hist, va_hist = [], []
        for _ in range(epochs):
            tr_hist.append(epoch())
            vl = val_loss(params)
            better = vl < best_v
            best_p = where_params(better, params, best_p)
            best_v = torch.where(better, vl, best_v)
            va_hist.append(vl)
        va = torch.stack(va_hist).cpu().numpy()
        history = {"train_loss": [float(v) for v in torch.stack(tr_hist).cpu().numpy()],
                   "val_loss": [float(v) for v in va],
                   "best_epoch": int(va.argmin()),
                   "best_val_loss": float(best_v)}
        return best_p, history

    best_params, best_val, best_epoch = clone_params(params), float("inf"), 0
    history = {"train_loss": [], "val_loss": []}
    for e in range(epochs):
        tr_loss = epoch()
        vl = float(val_loss(params))
        history["train_loss"].append(float(tr_loss))
        history["val_loss"].append(vl)
        if vl < best_val - 1e-7:
            best_val, best_params, best_epoch = vl, clone_params(params), e
        elif e - best_epoch >= patience:
            break
    history["best_epoch"] = best_epoch
    history["best_val_loss"] = best_val
    return best_params, history


@torch.no_grad()
def mc_dropout_predict(params, x: torch.Tensor, generator: torch.Generator,
                       n_samples: int = 32, dropout_rate: float = 0.1,
                       layernorm: bool = True):
    """MC-dropout mean and (population) std over ``n_samples`` stochastic
    forwards, run as one batch of forwards."""
    xs = x.expand(n_samples, *x.shape)
    preds = apply_mlp(params, xs, dropout_rate=dropout_rate, generator=generator,
                      layernorm=layernorm)
    return preds.mean(dim=0), preds.std(dim=0, correction=0)


def flatten_params(params) -> dict:
    """{"layer{i}_{key}": numpy array}: the reference's persistence layout."""
    return {f"layer{i}_{k}": v.detach().cpu().numpy()
            for i, layer in enumerate(params) for k, v in layer.items()}


def params_from_numpy(arrays: dict, device="cuda") -> list:
    """Params on ``device`` from the ``layer{i}_{key}`` layout of
    :func:`flatten_params` (the reference's too, so its trained weights carry
    across); other keys are ignored."""
    layers = {}
    for name, v in arrays.items():
        if not name.startswith("layer"):
            continue
        idx, key = name[5:].split("_", 1)
        layers.setdefault(int(idx), {})[key] = torch.tensor(
            np.asarray(v, np.float32), device=torch.device(device))
    return [layers[i] for i in sorted(layers)]


unflatten_params = params_from_numpy  # the reference's name
