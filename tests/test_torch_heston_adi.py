"""The Douglas ADI loop of the port (``optionslab_tpu_torch/ops/heston_adi.py``)
on the CPU, where it runs as its plain torch loop and its hand-written
reverse recursion.

* The plain forward in its four modes (European, American, Bermudan, SLV
  Bermudan) against ``optionslab_tpu.models.heston_fdm`` at 41 × 21 × 16 on
  a market and leverage rows drawn from a numpy seed, the reference pinned
  to float32: the grids and slices to 2e-5 of the strike, the prices to
  1e-5 relative (``tests/test_torch_heston_fdm.py``'s bounds). Each
  reference call runs once in the module.
* The plain reverse (``_AdiLoop``'s backward on the CPU) against
  ``torch.autograd.grad`` through the plain forward, for every input of the
  Function, European and American, to 1e-5 of each gradient's largest
  entry; at the put's pinned x_lo column the projection ties (the boundary
  value is the exercise value), and the tie splits the gradient half and
  half as ``torch.maximum``'s derivative does.
* A CPU call never loads the kernel library; another device raises. The
  kernels themselves run on the card only (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import heston_fdm as jf
from optionslab_tpu.models.heston import HestonParams as JParams
from optionslab_tpu_torch.models import heston_fdm as tf
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.ops import _build
from optionslab_tpu_torch.ops import heston_adi as ha


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_X, N_V, N_T = 41, 21, 16
N_DATES, SPD = 4, 4
CPU = torch.device("cpu")
_RNG = np.random.default_rng(2024)
# spot, strike, maturity, rate, dividend; v0, kappa, theta, sigma, rho
MARKET = (float(_RNG.uniform(90, 110)), float(_RNG.uniform(95, 105)),
          float(_RNG.uniform(0.5, 1.5)), float(_RNG.uniform(0.01, 0.05)),
          float(_RNG.uniform(0.0, 0.02)))
PAR = (float(_RNG.uniform(0.03, 0.06)), float(_RNG.uniform(1.0, 3.0)),
       float(_RNG.uniform(0.03, 0.06)), float(_RNG.uniform(0.2, 0.5)),
       float(_RNG.uniform(-0.8, -0.3)))
MIXING = 0.7
# leverage rows by relative log-spot: 8 substeps x 9 bins, smooth and positive
X_ROWS = np.sort(_RNG.uniform(-1.0, 1.0, (8, 9)), axis=1).astype(np.float32)
L_ROWS = (1.0 + 0.3 * np.sin(3.0 * X_ROWS + _RNG.uniform(0, 3, (8, 1)))).astype(np.float32)


def _jpar():
    return JParams(*(jnp.float32(x) for x in PAR))


def _tpar():
    return HestonParams.make(*PAR)


@pytest.fixture(scope="module")
def reference():
    """The reference's grids and prices, one call each."""
    s, k, t, r, q = MARKET
    out = {}
    for cp, american in ((1.0, False), (-1.0, True)):
        grid, meta = jf._adi_solve_grid(s, k, t, r, q, cp, _jpar(), N_X, N_V, N_T, american)
        out[american] = np.asarray(grid), [float(m) for m in meta]
    out["bermudan"] = [np.asarray(a) for a in jf._heston_adi_bermudan(
        s, k, t, r, q, -1.0, _jpar(), N_X, N_V, N_DATES, SPD)]
    out["slv"] = [np.asarray(a) for a in jf._slv_adi_bermudan(
        s, k, t, r, q, -1.0, _jpar(), MIXING, jnp.asarray(X_ROWS), jnp.asarray(L_ROWS),
        N_X, N_V, N_DATES, SPD)]
    return out


def _setup(cp, american, n_t=N_T):
    s, k, t, r, q = MARKET
    return tf._adi_setup(s, k, t, r, q, cp, _tpar(), N_X, N_V, n_t, american, CPU)


@pytest.mark.parametrize("american", [False, True])
def test_plain_loop_matches_reference(reference, american):
    ops, meta = _setup(-1.0 if american else 1.0, american)
    mode = ha.AMERICAN if american else ha.EUROPEAN
    grid, cont, _ = ha._adi_plain(ops, ops.intrinsic, mode)
    want, want_meta = reference[american]
    assert cont is None and grid.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), want, atol=2e-5 * MARKET[1])
    np.testing.assert_allclose([float(m) for m in meta], want_meta, rtol=1e-6)
    price = tf._bilinear_at(grid, torch.log(torch.tensor(MARKET[0])), torch.tensor(PAR[0]),
                            *meta)
    want_price = jf._bilinear_at(jnp.asarray(want), jnp.log(jnp.float32(MARKET[0])),
                                 jnp.float32(PAR[0]), *want_meta)
    assert float(price) == pytest.approx(float(want_price), rel=1e-5)


def test_bermudan_loop_matches_reference(reference):
    s, k, t, r, q = MARKET
    got = tf._heston_adi_bermudan(s, k, t, r, q, -1.0, _tpar(), N_X, N_V, N_DATES, SPD, CPU)
    want = reference["bermudan"]
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    assert got[1].shape == (N_DATES + 1, N_V, N_X)
    assert not got[1][0].any() and not got[1][-1].any()
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=2e-5 * k)


def test_slv_loop_matches_reference(reference):
    s, k, t, r, q = MARKET
    got = tf._slv_adi_bermudan(s, k, t, r, q, -1.0, _tpar(), MIXING, torch.tensor(X_ROWS),
                               torch.tensor(L_ROWS), N_X, N_V, N_DATES, SPD, CPU)
    want = reference["slv"]
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=2e-5 * k)
    np.testing.assert_allclose([float(a) for a in got[2:]], [float(a) for a in want[2:]],
                               rtol=1e-6)


def _leaves(ops, start):
    """Fresh leaves for every input of ``_AdiLoop`` (the start a tensor of its
    own, not the exercise value's)."""
    xs = (*ops.x_stencil, *ops.x_sweep, *ops.v_stencil, *ops.v_sweep, ops.mixed, ops.dt,
          ops.bounds, ops.intrinsic, start)
    return [x.detach().clone().requires_grad_(True) for x in xs]


def _grads(ops, american, weight):
    """(the Function's gradients, autograd's through the plain forward) of
    sum(weight · grid) in every input."""
    mode = ha.AMERICAN if american else ha.EUROPEAN
    out = []
    for through_function in (True, False):
        xs = _leaves(ops, ops.intrinsic)
        if through_function:
            grid = ha._AdiLoop.apply(mode, ops.den, *xs)
        else:
            grid = ha._adi_plain(*ha._ops_of(ops.den, xs), mode)[0]
        gs = torch.autograd.grad((grid * weight).sum(), xs, allow_unused=True)
        out.append([torch.zeros_like(x) if g is None else g for g, x in zip(gs, xs)])
    return out


@pytest.mark.parametrize("american", [False, True])
def test_plain_reverse_matches_autograd_of_the_plain_loop(american):
    ops, _ = _setup(-1.0 if american else 1.0, american)
    weight = torch.tensor(np.random.default_rng(7).normal(size=(N_V, N_X)), dtype=torch.float32)
    got, want = _grads(ops, american, weight)
    for name, g, w in zip(ha._INPUTS, got, want):
        assert g.shape == w.shape, name
        scale = w.abs().max().item()
        assert scale > 0.0 or name == "intrinsic", name
        assert (g - w).abs().max().item() <= 1e-5 * max(scale, 1e-30), (name, g, w)


def test_american_tie_at_the_boundary_splits_the_gradient():
    """The put's x_lo column is pinned to max(European bound, exercise value)
    = the exercise value, so each projection there ties: the last step's
    gradient goes half to the bound and half to the exercise value."""
    ops, _ = _setup(-1.0, True)
    _, _, (_, _, vp) = ha._adi_plain(ops, ops.intrinsic, ha.AMERICAN, history=True)
    assert torch.equal(vp[:, :, 0], ops.intrinsic[None, :, 0].expand(N_T, N_V))
    weight = torch.zeros(N_V, N_X)
    weight[N_V // 2, 0] = 1.0
    got, want = _grads(ops, True, weight)
    by_name = dict(zip(ha._INPUTS, got))
    assert by_name["bounds"][-1, 0].item() == 0.5
    assert by_name["intrinsic"][N_V // 2, 0].item() == 0.5
    for name, g, w in zip(ha._INPUTS, got, want):
        assert (g - w).abs().max().item() <= 1e-5 * max(w.abs().max().item(), 1e-30), name


def test_cpu_calls_never_load_the_library(monkeypatch):
    def refuse():
        raise AssertionError("a CPU call loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = ha._adi_cuda.launches, ha._adi_adjoint_cuda.launches
    s, k, t, r, q = MARKET
    tf.heston_fdm_price(s, k, t, r, _tpar(), q, "put", True, 21, 11, 4, device="cpu")
    g = tf.heston_fdm_greeks(s, k, t, r, _tpar(), q, "put", False, 21, 11, 4, device="cpu")
    assert all(np.isfinite(list(g.values())))
    tf._heston_adi_bermudan(s, k, t, r, q, -1.0, _tpar(), 21, 11, 2, 2, CPU)
    assert (ha._adi_cuda.launches, ha._adi_adjoint_cuda.launches) == before


def test_other_devices_and_bad_modes_raise():
    ops, _ = _setup(1.0, False, n_t=4)
    with pytest.raises(ValueError, match="no ADI time loop"):
        ha._dispatch(ops, ops.intrinsic.to("meta"), ha.EUROPEAN)
    with pytest.raises(ValueError, match="bad ADI mode"):
        ha._adi_plain(ops, ops.intrinsic, ha.BERMUDAN, spd=3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ha._adi_cuda(ops, ops.intrinsic, ha.EUROPEAN)
    with pytest.raises(ValueError, match="shared memory"):
        ha._check_shapes(ops, torch.zeros(3, 4000), None)
