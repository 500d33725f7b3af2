"""The θ-scheme time loop (``optionslab_tpu_torch/ops/theta_pde.py``) on the CPU.

* The end values' table that ``models/fdm.py`` hands the loop equals the
  per-step ``boundary(tau)`` of the loop it replaced, bit for bit, float32
  and float64 (``tau = (k + 1)·dt``: the integer is exact).
* The gradient of ``fdm_price`` through the loop's ``autograd.Function``
  (its backward recomputes the plain loop under autograd) against
  ``jax.grad`` of the reference ``fdm_price`` in S, K, T, r, σ and q,
  European and Howard American at 41 × 20, float64 to 1e-8 relative of the
  largest derivative (the same operations in the same order as the
  reference's scan; XLA and torch may round a reduction differently); its
  second derivative in S against double autograd through the plain loop.
* The launch plan that the CUDA wrappers share; a device other than the CPU
  and the card raises. The kernel itself runs on the card only
  (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.models import fdm as tf
from optionslab_tpu_torch.ops import theta_pde as tp
from optionslab_tpu_torch.ops import tridiag as tt
from optionslab_tpu_torch.types import ContractBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("spot", "strike", "maturity", "rate", "vol", "dividend")


def _book(n=6, seed=5):
    rng = np.random.default_rng(seed)
    return {"spot": rng.uniform(80, 120, n), "strike": rng.uniform(80, 120, n),
            "maturity": rng.uniform(0.2, 2.0, n), "rate": rng.uniform(0.0, 0.08, n),
            "vol": rng.uniform(0.1, 0.5, n), "dividend": rng.uniform(0.0, 0.04, n),
            "cp": np.where(np.arange(n) % 2 == 0, 1.0, -1.0)}


def _args(book, dtype):
    return [torch.tensor(book[k], dtype=dtype) for k in FIELDS + ("cp",)]


def _boundary_per_step(s, k, t, r, q, cp, x, intrinsic, n_time, american):
    """The loop's own end values, one step at a time (``_cn_book`` before the
    loop took a table)."""
    s_nodes = torch.exp(x)
    dt = torch.clamp_min(t, 1e-10) / n_time
    out = []
    for step in range(n_time):
        tau = (step + 1.0) * dt
        low = torch.where(cp > 0, 0.0, k * torch.exp(-r * tau) - s_nodes[:, 0] * torch.exp(-q * tau))
        high = torch.where(cp > 0, s_nodes[:, -1] * torch.exp(-q * tau) - k * torch.exp(-r * tau),
                           0.0)
        if american:
            low = torch.maximum(low, intrinsic[:, 0])
            high = torch.maximum(high, intrinsic[:, -1])
        out.append(torch.stack([torch.clamp_min(low, 0.0), torch.clamp_min(high, 0.0)], -1))
    return torch.stack(out, 1)


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_end_table_equals_the_per_step_boundary(dtype, american):
    s, k, t, r, v, q, cp = _args(_book(7, seed=1), dtype)
    x, ops = tf._cn_operands(s, k, t, r, v, q, cp, 41, 37, 0.5, american)
    ends = ops[-1]
    assert ends.shape == (7, 37, 2) and ends.dtype == dtype
    assert torch.equal(ends, _boundary_per_step(s, k, t, r, q, cp, x, ops[-2], 37, american))


@pytest.fixture(scope="module")
def jax_fdm_grads():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from optionslab_tpu.models.fdm import fdm_price
    from optionslab_tpu.types import ContractBatch as JBatch

    book = _book()
    out = {}
    with jax.enable_x64(True):
        cp = jnp.asarray(book["cp"])
        for american in (False, True):
            def total(*fields, american=american):
                return fdm_price(JBatch(*fields, cp), 41, 20, american=american).sum()

            grads = jax.grad(total, argnums=tuple(range(6)))(
                *(jnp.asarray(book[f]) for f in FIELDS))
            out[american] = [np.asarray(g) for g in grads]
    return book, out


@pytest.mark.parametrize("american", [False, True])
def test_gradient_matches_jax_grad(jax_fdm_grads, american):
    book, ref = jax_fdm_grads
    args = _args(book, torch.float64)
    leaves = [a.requires_grad_(True) for a in args[:6]]
    price = tf.fdm_price(ContractBatch(*leaves, args[6]), 41, 20, american=american)
    grads = torch.autograd.grad(price.sum(), leaves)
    for name, got, want in zip(FIELDS, grads, ref[american]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(), err_msg=name)


def test_second_derivative_through_the_function():
    """The backward runs under autograd when asked for a graph: gamma through
    the Function equals double autograd through the plain loop."""
    args = _args(_book(4, seed=2), torch.float64)
    spot = args[0].requires_grad_(True)
    x, ops = tf._cn_operands(spot, *args[1:], 21, 10, 0.5, True)
    gammas = []
    for loop in (tp.theta_loop, tp._theta_plain):
        price = tf._read_price(loop(*ops, tp.HOWARD), x, spot)
        (delta,) = torch.autograd.grad(price.sum(), spot, create_graph=True)
        gammas.append(torch.autograd.grad(delta.sum(), spot)[0])
    torch.testing.assert_close(gammas[0], gammas[1], rtol=1e-10, atol=1e-12)


def test_other_devices_raise():
    _, ops = tf._cn_operands(*_args(_book(2), torch.float64), 11, 3, 0.5, False)
    with pytest.raises(ValueError, match="no θ-scheme time loop for device meta"):
        tp.theta_loop(*(o.to("meta") for o in ops), tp.EUROPEAN)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel's entry never runs the loop
        tp._theta_cuda(*ops, tp.EUROPEAN)


@pytest.mark.parametrize("batch,n_sms,want", [(1, 132, 1), (101, 132, 1), (133, 132, 2),
                                              (256, 132, 2), (1024, 132, 8),
                                              (10_000, 132, 16)])
def test_plan_fills_one_wave(batch, n_sms, want):
    assert tt.plan_systems(batch, n_sms, lambda k: 0) == want


def test_plan_halves_until_the_tile_fits():
    # float64 401-node θ-scheme tiles: 16 contracts need 0.7 MB, 4 fit in 227 KB
    # (planes of 401 nodes and 16 padding rows, 417 mask bytes aligned to 8,
    # the contract's first changed row in 8 bytes)
    assert tp.tile_bytes(401, 1, 8) == (12 * 417 + 4) * 8 + 424 + 8 + 256
    assert tt.plan_systems(10_000, 132, lambda k: tp.tile_bytes(401, k, 8)) == 4
    # the tridiagonal tile: a broadcast row is staged once; c' takes its own
    # plane where the upper diagonal is one shared row
    assert tt.tile_bytes(201, 2, (False,) * 4, 4) == 217 * 4 * 3 * 4 + 256
    assert tt.tile_bytes(201, 2, (True, True, True, False), 8) == 217 * (3 + 3 + 3) * 8 + 256
    with pytest.raises(ValueError, match="shared memory"):
        tt.plan_systems(1, 132, lambda k: tp.tile_bytes(4000, k, 8))
