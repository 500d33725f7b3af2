"""The port's Adam loops against optax's ``clip_by_global_norm(1.0) + adam``
trajectory (the reference's ``ops/optim.py``), step for step.

Both run in float32 from the same start; the tolerance 1e-6 covers the
float32 rounding of the two implementations' moment updates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from optionslab_tpu.ops import optim as jopt
from optionslab_tpu_torch.ops import optim as topt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(7)
A = RNG.normal(size=(4, 4)).astype(np.float32)
A = (A @ A.T + 4.0 * np.eye(4)).astype(np.float32)  # symmetric positive definite
B = RNG.normal(size=4).astype(np.float32)
X0 = (5.0 * RNG.normal(size=4)).astype(np.float32)  # far enough that the clip triggers


def quad_j(x):
    return 0.5 * x @ (jnp.asarray(A) @ x) - jnp.asarray(B) @ x


def quad_t(x):
    return 0.5 * x @ (torch.from_numpy(A) @ x) - torch.from_numpy(B) @ x


def optax_trajectory(loss, x0, n, lr):
    """The iterates x_0..x_n of optax's chain, and the losses at x_0..x_{n-1}."""
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    x = jnp.asarray(x0, jnp.float32)
    state = tx.init(x)
    xs, losses = [x], []
    for _ in range(n):
        val, g = jax.value_and_grad(loss)(x)
        upd, state = tx.update(g, state, x)
        x = optax.apply_updates(x, upd)
        xs.append(x)
        losses.append(float(val))
    return [np.asarray(v) for v in xs], losses


@pytest.mark.parametrize("n_steps,lr", [(1, 0.1), (25, 0.1), (60, 0.5)])
def test_scan_adam_matches_optax(n_steps, lr):
    xs, losses = optax_trajectory(quad_j, X0, n_steps, lr)
    best_x, best_loss, final = topt.scan_adam(quad_t, torch.from_numpy(X0), n_steps, lr)
    j_best, j_best_loss, j_final = jopt.scan_adam(quad_j, jnp.asarray(X0), n_steps, lr)
    assert best_x.dtype == torch.float32
    np.testing.assert_allclose(best_x.numpy(), np.asarray(j_best), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(best_loss), float(j_best_loss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(final), float(j_final), rtol=1e-6, atol=1e-6)
    # the best iterate is the trajectory's best among x_0..x_{n-1}
    k = int(np.argmin(losses))
    np.testing.assert_allclose(best_x.numpy(), xs[k], rtol=1e-6, atol=1e-6)


def test_every_iterate_matches_optax():
    n, lr = 30, 0.2
    xs, _ = optax_trajectory(quad_j, X0, n, lr)
    seen = []

    def spy(x):
        seen.append(x.detach().clone())
        return quad_t(x)

    topt.scan_adam(spy, torch.from_numpy(X0), n, lr)
    iterates = [s.numpy() for s in seen[1:-1]]  # drop the loss at x0 and at best_x
    assert len(iterates) == n
    for k in range(n):
        np.testing.assert_allclose(iterates[k], xs[k], rtol=1e-6, atol=1e-6, err_msg=str(k))


X_STAR = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
CUT = 0.5 * (X0[0] + X_STAR[0])  # half way to the optimum along x[0]
SIDE = float(np.sign(X_STAR[0] - X0[0]))


def nan_past_cut_j(x):
    return jnp.where(SIDE * (x[0] - CUT) > 0, jnp.nan, quad_j(x))


def nan_past_cut_t(x):
    return torch.where(SIDE * (x[0] - CUT) > 0, torch.tensor(float("nan")), quad_t(x))


def test_nan_loss_never_replaces_best():
    """The loss turns NaN once the iterate crosses a cut half way to the
    optimum (its gradient there is 0 in both frameworks)."""
    n, lr = 40, 0.2
    ref = jopt.scan_adam(nan_past_cut_j, jnp.asarray(X0), n, lr)
    ours = topt.scan_adam(nan_past_cut_t, torch.from_numpy(X0), n, lr)
    assert np.isnan(float(ref[2])) and np.isnan(float(ours[2]))  # the run ended past the cut
    assert np.isfinite(float(ours[1]))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_nan_from_the_start_keeps_x0():
    ref = jopt.scan_adam(lambda x: quad_j(x) * jnp.nan, jnp.asarray(X0), 5, 0.1)
    best, loss, final = topt.scan_adam(lambda x: quad_t(x) * float("nan"),
                                       torch.from_numpy(X0), 5, 0.1)
    np.testing.assert_array_equal(best.numpy(), X0)
    np.testing.assert_array_equal(np.asarray(ref[0]), X0)
    assert np.isnan(float(loss)) and np.isnan(float(final)) and np.isnan(float(ref[1]))


def test_no_clip_matches_plain_adam():
    n, lr = 15, 0.3
    ref = jopt.scan_adam(quad_j, jnp.asarray(X0), n, lr, clip=None)
    ours = topt.scan_adam(quad_t, torch.from_numpy(X0), n, lr, clip=None)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-6, atol=1e-6)


def _loss_args_j(x, a, b):
    return 0.5 * x @ (a @ x) - b @ x


def _loss_args_t(x, a, b):
    return 0.5 * x @ (a @ x) - b @ x


def test_cached_and_batched_match_reference():
    n, lr = 20, 0.2
    ref = jopt.scan_adam_cached(_loss_args_j, jnp.asarray(X0), (jnp.asarray(A), jnp.asarray(B)),
                                n, lr)
    ours = topt.scan_adam_cached(_loss_args_t, torch.from_numpy(X0),
                                 (torch.from_numpy(A), torch.from_numpy(B)), n, lr)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-6, atol=1e-6)

    scales = np.asarray([1.0, 0.5, 2.0], np.float32)
    x0s = np.stack([X0 * s for s in scales])
    a_s = np.stack([A * s for s in scales])
    b_s = np.stack([B] * 3)
    jref = jopt.scan_adam_batched(_loss_args_j, jnp.asarray(x0s),
                                  (jnp.asarray(a_s), jnp.asarray(b_s)), n, lr)

    def batched_loss(xs, a, b):  # the batch axis written out: (B, 4) → (B,)
        return 0.5 * torch.einsum("bi,bij,bj->b", xs, a, xs) - torch.einsum("bi,bi->b", b, xs)

    tout = topt.scan_adam_batched(batched_loss, torch.from_numpy(x0s),
                                  (torch.from_numpy(a_s), torch.from_numpy(b_s)), n, lr)
    for o, r in zip(tout, jref):
        assert o.shape[0] == 3
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
