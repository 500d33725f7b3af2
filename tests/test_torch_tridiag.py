"""The port's batched tridiagonal solve (``optionslab_tpu_torch/ops/tridiag.py``).

* The plain version against ``optionslab_tpu.ops.tridiag.tridiag_solve`` on
  numpy-seeded diagonally dominant systems, float32 to 1e-6 relative (the
  same operations in the same order; XLA and torch round each alike but may
  vectorise differently), float64 to 1e-12, with broadcast operands and the
  1e-30 pivot guard.
* The ``autograd.Function``'s adjoint backward (run with the plain solve)
  against autograd through the plain loop and against ``jax.grad`` of the
  reference, float64 to 1e-10; its second derivatives and an operand
  broadcast along the system axis against autograd through the loop;
  ``tridiag_apply`` against the solve.
* ``cuda``-marked (they skip without a card): the CUDA kernel equals the
  plain version bit for bit on the card, float32 and float64, at the PDE
  shapes of the port (the ADI's row and column sweeps, the column sweep's
  shared coefficients and transposed right-hand side read through the
  kernel's strides; the dividend PDE; the Crank–Nicolson book) and at
  5,000 systems (full 16-system tiles, a ragged last one), one launch per
  solve and one per backward solve; other dtypes and a system beyond a CUDA
  block's shared memory raise. On
  the card this file runs without JAX (``--noconftest``): the reference
  tests then skip.
"""

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.ops import tridiag as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from optionslab_tpu.ops.tridiag import tridiag_solve

    return jax, tridiag_solve


def _system(shapes, n, seed=0, dtype=np.float64):
    """(lower, diag, upper, rhs) of the given leading shapes, diagonally
    dominant."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.0, 1.0, shapes[0] + (n,))
    up = rng.uniform(-1.0, 1.0, shapes[2] + (n,))
    di = 2.5 + rng.uniform(0.0, 1.0, shapes[1] + (n,))
    rhs = rng.normal(size=shapes[3] + (n,))
    return tuple(a.astype(dtype) for a in (lo, di, up, rhs))


SHAPES = {
    "one": ((), (), (), ()),
    "batch": ((5,), (5,), (5,), (5,)),
    "broadcast": ((), (3,), (1,), (2, 3)),
    "rhs_only": ((), (), (), (4, 6)),
}


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_reference(jref, shape, dtype, rtol):
    jax, jsolve = jref
    ops = _system(SHAPES[shape], 17, seed=len(shape), dtype=dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jsolve(*(jax.numpy.asarray(a) for a in ops)))
    got = tt.tridiag_solve(*(torch.tensor(a) for a in ops))
    assert got.dtype == torch.from_numpy(ops[3]).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol)


def test_pivot_guard_matches_reference(jref):
    """A zero pivot takes the guard (sign·1e-30 + 1e-30) in both packages."""
    jax, jsolve = jref
    lo = np.array([0.0, 1.0, 1.0, 0.5], np.float32)
    di = np.array([0.0, 2.0, 1e-31, 3.0], np.float32)
    up = np.array([1.0, 0.5, 0.0, 0.0], np.float32)
    rhs = np.array([1e-30, 1.0, 2.0, 3.0], np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jsolve(*(jax.numpy.asarray(a) for a in (lo, di, up, rhs))))
    got = tt.tridiag_solve(*(torch.tensor(a) for a in (lo, di, up, rhs))).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("shape", ["batch", "broadcast"])
def test_adjoint_matches_autograd_of_the_loop(shape):
    ops = [torch.tensor(a, requires_grad=True) for a in _system(SHAPES[shape], 11, seed=3)]
    w = torch.tensor(np.random.default_rng(4).normal(
        size=torch.broadcast_shapes(*(o.shape for o in ops))))
    got = torch.autograd.grad((tt.tridiag_solve(*ops) * w).sum(), ops)
    want = torch.autograd.grad((tt._tridiag_plain(*ops) * w).sum(), ops)
    for g, r, o in zip(got, want, ops):
        assert g.shape == o.shape
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_adjoint_matches_jax_grad(jref):
    jax, jsolve = jref
    ops = _system(SHAPES["broadcast"], 9, seed=5)
    w = np.random.default_rng(6).normal(size=(2, 3, 9))
    with jax.enable_x64(True):
        want = jax.grad(lambda *a: (jsolve(*a) * w).sum(), argnums=(0, 1, 2, 3))(
            *(jax.numpy.asarray(a) for a in ops))
    t_ops = [torch.tensor(a, requires_grad=True) for a in ops]
    got = torch.autograd.grad((tt.tridiag_solve(*t_ops) * torch.tensor(w)).sum(), t_ops)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-12)


def test_second_derivatives_match_autograd_of_the_loop():
    """The adjoint is the Function itself, so the solve differentiates twice
    (as the reference's ``lax.scan`` does): a Hessian-vector product against
    double autograd through the plain loop, float64 to 1e-10."""
    ops = [torch.tensor(a, requires_grad=True) for a in _system(SHAPES["broadcast"], 9, seed=8)]
    w = torch.tensor(np.random.default_rng(9).normal(size=(2, 3, 9)))
    hvp = []
    for solve in (tt.tridiag_solve, tt._tridiag_plain):
        grads = torch.autograd.grad((solve(*ops) ** 2 * w).sum(), ops, create_graph=True)
        hvp.append(torch.autograd.grad(sum(g.sum() for g in grads), ops))
    for g, r in zip(*hvp):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_operand_broadcast_along_the_system_axis_gets_its_gradient():
    """A coefficient of length 1 on the system axis stands for a constant
    diagonal: its gradient is the sum over the nodes, as through the loop."""
    lo, di, up, rhs = _system(SHAPES["batch"], 7, seed=10)
    ops = [torch.tensor(a, requires_grad=True)
           for a in (lo[:, :1], di[:, :1], up[:, :1], rhs)]
    got = torch.autograd.grad(tt.tridiag_solve(*ops).sum(), ops)
    want = torch.autograd.grad(tt._tridiag_plain(*ops).sum(), ops)
    for g, r, o in zip(got, want, ops):
        assert g.shape == o.shape
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_tridiag_apply_inverts_the_solve():
    """``tridiag_apply`` is T·v: applied to the solution it gives back the
    right-hand side."""
    ops = [torch.tensor(a) for a in _system(SHAPES["broadcast"], 13, seed=11)]
    x = tt.tridiag_solve(*ops)
    torch.testing.assert_close(tt.tridiag_apply(*ops[:3], x), ops[3].expand_as(x),
                               rtol=1e-12, atol=1e-12)


def test_first_lower_and_last_upper_get_no_gradient():
    ops = [torch.tensor(a, requires_grad=True) for a in _system(SHAPES["one"], 6, seed=7)]
    tt.tridiag_solve(*ops).sum().backward()
    assert ops[0].grad[0].item() == 0.0 and ops[2].grad[-1].item() == 0.0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel entry never runs the plain loop: CPU tensors raise."""
    ops = [torch.tensor(a) for a in _system(SHAPES["one"], 4)]
    with pytest.raises(ValueError, match="CUDA"):
        tt._tridiag_cuda(*ops)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# (batch, n): the ADI row sweep (n_v rows of n_x), its column sweep (n_x
# columns of n_v: the coefficients one (1, n_v) row read with batch stride 0,
# the right-hand side a transposed view), the dividend PDE, the
# Crank–Nicolson book
CARD_SHAPES = [(101, 201, False), (201, 101, True), (1, 401, False), (256, 201, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch,n,transposed", CARD_SHAPES)
def test_kernel_bitwise_equals_plain_on_card(cuda_device, batch, n, transposed, dtype):
    lo, di, up, rhs = (torch.tensor(a, dtype=dtype, device=cuda_device)
                       for a in _system(((batch,),) * 4, n, seed=batch + n))
    if transposed:  # the ADI column sweep's layout: shared coefficients, a transposed rhs
        lo, di, up = lo[:1], di[:1], up[:1]
        rhs = rhs.T.contiguous().T
    before = tt._tridiag_cuda.launches
    got = tt.tridiag_solve(lo, di, up, rhs)
    assert tt._tridiag_cuda.launches == before + 1
    want = tt._tridiag_plain(lo, di, up, rhs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.device == cuda_device
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bitwise_at_full_tiles_on_card(cuda_device, dtype):
    """5,000 systems: 16 to a CUDA block (a full warp, two lanes a system), the
    last block ragged;
    a transposed right-hand side with shared coefficients the same way."""
    ops = [torch.tensor(a, dtype=dtype, device=cuda_device)
           for a in _system(((5000,),) * 4, 37, seed=12)]
    col = [o[:1] for o in ops[:3]] + [ops[3].T.contiguous().T]
    for case in (ops, col):
        assert torch.equal(tt.tridiag_solve(*case), tt._tridiag_plain(*case))


@pytest.mark.cuda
def test_kernel_refuses_a_system_beyond_shared_memory_on_card(cuda_device):
    ops = [torch.ones(8000, dtype=torch.float64, device=cuda_device) for _ in range(4)]
    before = tt._tridiag_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        tt.tridiag_solve(*ops)
    assert tt._tridiag_cuda.launches == before


@pytest.mark.cuda
def test_kernel_broadcast_and_backward_on_card(cuda_device):
    ops = [torch.tensor(a, device=cuda_device, requires_grad=True)
           for a in _system(SHAPES["broadcast"], 33, seed=9)]
    before = tt._tridiag_cuda.launches
    x = tt.tridiag_solve(*ops)
    assert torch.equal(x.detach(), tt._tridiag_plain(*(o.detach() for o in ops)))
    got = torch.autograd.grad(x.sum(), ops)
    assert tt._tridiag_cuda.launches == before + 2  # the solve and its adjoint
    want = torch.autograd.grad(tt._tridiag_plain(*ops).sum(), ops)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_kernel_rejects_other_dtypes_on_card(cuda_device):
    ops = [torch.ones(4, dtype=torch.float16, device=cuda_device) for _ in range(4)]
    with pytest.raises(ValueError, match="float32 or float64"):
        tt.tridiag_solve(*ops)
