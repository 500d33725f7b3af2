"""Adam loops on the device, for the calibrations.

The port of ``optionslab_tpu/ops/optim.py``. There the whole Adam loop is one
``lax.scan`` under ``jit``; here it is a Python loop of tensor ops that stay
on the loss's device, with no host synchronisation per step: the best
iterate is tracked with ``torch.where``, never with a Python comparison.

The update is optax's ``chain(clip_by_global_norm(clip), adam(lr))`` written
out: the gradient is scaled by ``clip / norm`` only when ``norm >= clip``
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, so it is not
used), then Adam with b1 0.9, b2 0.999, eps 1e-8 and bias correction.

Semantics of the reference: the loss at step k is evaluated at the iterate
before the k-th update; a NaN or infinite loss never replaces the best
iterate; the result is ``(best_x, min(best_loss, loss(best_x)), last
loss)``. A loop of ``n_steps`` evaluates the loss ``n_steps + 2`` times
(once at ``x0``, once per step with its gradient, once at ``best_x``).
"""

from __future__ import annotations

import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam_loop(loss_fn, x0: torch.Tensor, n_steps: int, learning_rate: float,
               clip: float | None):
    """The batched core: ``x0`` is (B, ...), ``loss_fn`` maps it to (B,)
    losses of B independent problems."""
    x = x0.detach().clone()
    red = tuple(range(1, x.dim()))
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    with torch.no_grad():
        best_loss = loss_fn(x).detach()
    best_x = x.clone()
    last = best_loss
    view = (-1,) + (1,) * (x.dim() - 1)
    for k in range(1, int(n_steps) + 1):
        xr = x.detach().requires_grad_(True)
        loss = loss_fn(xr)
        (grad,) = torch.autograd.grad(loss.sum(), xr)
        loss = loss.detach()
        if clip:
            g_norm = torch.sqrt((grad * grad).sum(dim=red, keepdim=True))
            grad = torch.where(g_norm < clip, grad, grad / g_norm * clip)
        mu = (1.0 - _B1) * grad + _B1 * mu
        nu = (1.0 - _B2) * (grad * grad) + _B2 * nu
        mu_hat = mu / (1.0 - _B1 ** k)
        nu_hat = nu / (1.0 - _B2 ** k)
        better = torch.isfinite(loss) & (loss < best_loss)
        best_x = torch.where(better.reshape(view), x, best_x)
        best_loss = torch.where(better, loss, best_loss)
        x = x + (-learning_rate) * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
        last = loss
    with torch.no_grad():
        final = loss_fn(best_x).detach()
    return best_x, torch.minimum(best_loss, final), last


def scan_adam(loss_fn, x0: torch.Tensor, n_steps: int = 400, learning_rate: float = 0.02,
              clip: float | None = 1.0):
    """Minimize the scalar ``loss_fn(x)`` with Adam on ``x0``'s device.

    Returns ``(best_x, best_loss, final_loss)`` as tensors (module
    docstring). ``loss_fn`` must be differentiable by ``torch.autograd``.
    """
    best_x, best_loss, last = _adam_loop(lambda xb: loss_fn(xb[0]).reshape(1), x0[None],
                                         n_steps, learning_rate, clip)
    return best_x[0], best_loss[0], last[0]


def scan_adam_cached(loss_fn, x0: torch.Tensor, args=(), n_steps: int = 400,
                     learning_rate: float = 0.02, clip: float | None = 1.0):
    """:func:`scan_adam` on ``loss_fn(x, *args)``. The reference keeps a jit
    cache across calls here; PyTorch runs eagerly, so this is the same loop
    with the data passed as arguments."""
    return scan_adam(lambda x: loss_fn(x, *args), x0, n_steps, learning_rate, clip)


def scan_adam_batched(loss_fn, x0s: torch.Tensor, args=(), n_steps: int = 400,
                      learning_rate: float = 0.02, clip: float | None = 1.0):
    """A batch of independent calibrations in one loop.

    ``x0s`` is (B, ...) and every element of ``args`` carries a leading
    batch axis. The batch dimension is written out rather than mapped:
    ``loss_fn(xs, *args)`` takes the whole (B, ...) batch and returns the
    (B,) losses, problem b depending on row b only. The clip norm, Adam's
    moments and the best iterate are per problem. Returns ``(best_xs,
    best_losses, final_losses)``, each with the leading B axis.
    """
    return _adam_loop(lambda xs: loss_fn(xs, *args), x0s, n_steps, learning_rate, clip)
