"""The port's Greeks engine (``optionslab_tpu_torch/greeks``) against
``optionslab_tpu.greeks``, in float64 on the CPU.

* Every adapter's first- and second-order Greeks on a 3-contract book, to
  1e-9 relative (the PDE adapter on a 41 × 20 grid to 1e-7: its gradients
  run through the θ-scheme Function and the tridiagonal adjoint).
* A ``price_fn`` that couples contracts: the port takes the exact diagonal
  of the second-order Jacobians, as the reference's ``jacfwd`` does.
* ``greeks_fd``, ``greeks_batch``, the object protocol, the convenience
  wrappers and the lattice Greeks (vanna, charm, vomma by autograd through
  the CRR lattice).
* The finite-difference fallback of ``compute_greeks_unified`` runs only
  for a pricer that returns no autograd graph (a numpy black box, a tensor
  computed without grad), and never hides an error the pricer raises.
* ``greeks_fdm`` at its default grid within the reference test's bounds
  of the Black–Scholes Greeks, and the American PDE's Greeks on a small
  grid against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

from optionslab_tpu import greeks as jg
from optionslab_tpu.models.bates import BatesParams as JBates
from optionslab_tpu.models.black_scholes import BlackScholesPricer as JBSPricer
from optionslab_tpu.models.black_scholes import bs_price as j_bs
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu.models.sabr import SABRParams as JSABR
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch import greeks as tg
from optionslab_tpu_torch.models.bates import BatesParams
from optionslab_tpu_torch.models.black_scholes import BlackScholesPricer, bs_greeks, bs_price
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.models.sabr import SABRParams
from optionslab_tpu_torch.types import ContractBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
SPOTS = [90.0, 100.0, 112.0]
ARGS = (SPOTS, 100.0, 1.0, 0.05, 0.2, 0.01)
SCALAR = (100.0, 100.0, 1.0, 0.05, 0.2, 0.0)
HP = dict(v0=0.04, kappa=2.0, theta=0.05, sigma=0.3, rho=-0.7)
BP = dict(HP, lam=0.4, mu_j=-0.1, sigma_j=0.15)
SP = dict(alpha=0.25, beta=0.5, rho=-0.3, nu=0.4)


def _t(args):
    return [torch.tensor(a, dtype=F64) for a in args]


def _j(args):
    return [jnp.asarray(a, jnp.float64) for a in args]


def _ref_second_order(fn, args):
    """The reference's Greeks with second order, jitted (its eager
    ``jacfwd`` of ``grad`` takes seconds a call)."""
    return jax.jit(lambda *a: jg.greeks_from_fn(fn, *a, second_order=True))(*_j(args))


def _close(port: dict, ref: dict, rtol: float, atol: float = 1e-10, keys=None):
    keys = keys or ref.keys()
    for k in keys:
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


ADAPTERS = {
    "bs": (lambda: tg.bs_price_fn(-1.0), lambda: jg.bs_price_fn(-1.0), 1e-9),
    "heston": (lambda: tg.heston_price_fn(HestonParams.make(**HP, dtype=F64), 1.0),
               lambda: jg.heston_price_fn(JHeston.make(**HP, dtype=jnp.float64), 1.0), 1e-9),
    "bates": (lambda: tg.bates_price_fn(BatesParams.make(**BP, dtype=F64), -1.0),
              lambda: jg.bates_price_fn(JBates.make(**BP, dtype=jnp.float64), -1.0), 1e-9),
    "sabr": (lambda: tg.sabr_price_fn(SABRParams.make(**SP, dtype=F64), 1.0),
             lambda: jg.sabr_price_fn(JSABR.make(**SP, dtype=jnp.float64), 1.0), 1e-9),
    "merton": (lambda: tg.merton_price_fn(0.5, -0.1, 0.15, 1.0),
               lambda: jg.merton_price_fn(0.5, -0.1, 0.15, 1.0), 1e-9),
    "fdm": (lambda: tg.fdm_price_fn(-1.0, n_space=41, n_time=20),
            lambda: jg.fdm_price_fn(-1.0, n_space=41, n_time=20), 1e-7),
}


@pytest.mark.parametrize("name", sorted(ADAPTERS))
def test_adapter_greeks_match_reference(name):
    port_fn, ref_fn, rtol = ADAPTERS[name]
    g = tg.greeks_from_fn(port_fn(), *_t(ARGS), second_order=True)
    ref = _ref_second_order(ref_fn(), ARGS)
    assert set(g) == set(ref)
    _close(g, ref, rtol, atol=1e-9)


def _coupled_port(s, k, t, r, sig, q):
    return bs_price(s, k, t, r, sig, 1.0, q) + 1e-3 * s * torch.roll(s, 1) * torch.roll(sig, -1)


def _coupled_ref(s, k, t, r, sig, q):
    return j_bs(s, k, t, r, sig, 1.0, q) + 1e-3 * s * jnp.roll(s, 1) * jnp.roll(sig, -1)


def test_coupled_price_fn_gets_the_reference_diagonal():
    g = tg.greeks_from_fn(_coupled_port, *_t(ARGS), second_order=True)
    ref = _ref_second_order(_coupled_ref, ARGS)
    _close(g, ref, 1e-10)
    # the coupling's cross terms are off the diagonal: marking the function
    # contractwise (one sweep over the summed gradient) would pick them up
    summed = tg.greeks_from_fn(tg.contractwise(_coupled_port), *_t(ARGS), second_order=True)
    assert not np.allclose(summed["gamma"].numpy(), np.asarray(ref["gamma"]), rtol=1e-6)
    assert not np.allclose(summed["vanna"].numpy(), np.asarray(ref["vanna"]), rtol=1e-6)


def test_bs_second_order_equals_closed_form():
    g = tg.greeks_from_fn(tg.bs_price_fn(1.0), *_t(ARGS), second_order=True)
    ex = bs_greeks(*_t(ARGS[:5]), 1.0, torch.tensor(ARGS[5], dtype=F64))
    _close(g, {k: ex[k].numpy() for k in ("price", "delta", "gamma", "vega", "theta", "rho",
                                          "vanna", "vomma", "charm")}, 1e-9)


def test_greeks_fd_matches_reference():
    g = tg.greeks_fd(tg.bs_price_fn(-1.0), *_t(ARGS))
    ref = jg.greeks_fd(jg.bs_price_fn(-1.0), *_j(ARGS))
    assert set(g) == set(ref)
    _close(g, ref, 1e-9, atol=1e-9)


def test_greeks_batch_matches_reference():
    b = ContractBatch.make(SPOTS, 100.0, [0.5, 1.0, 2.0], 0.03, 0.25, ["call", "put", "call"],
                           dtype=F64)
    jb = JBatch.make(SPOTS, 100.0, [0.5, 1.0, 2.0], 0.03, 0.25, ["call", "put", "call"],
                     dtype=jnp.float64)

    def port(batch):
        return bs_price(batch.spot, batch.strike, batch.maturity, batch.rate, batch.vol,
                        batch.cp, batch.dividend)

    def ref(batch):
        return j_bs(batch.spot, batch.strike, batch.maturity, batch.rate, batch.vol, batch.cp,
                    batch.dividend)

    _close(tg.greeks_batch(port, b, second_order=False),
           jg.greeks_batch(ref, jb, second_order=False), 1e-10)


def test_object_pricer_and_wrappers_match_reference():
    g = tg.compute_greeks_unified(BlackScholesPricer(), *_t(ARGS[:5]), "put",
                                  torch.tensor(0.01, dtype=F64))
    ref = jg.compute_greeks_unified(JBSPricer(), *_j(ARGS[:5]), "put", jnp.float64(0.01))
    _close(g, ref, 1e-10)
    jp, js = JHeston.make(**HP, dtype=jnp.float64), JSABR.make(**SP, dtype=jnp.float64)
    _close(tg.greeks_heston(HestonParams.make(**HP, dtype=F64), *_t(ARGS[:5]), "put"),
           jax.jit(lambda *a: jg.greeks_heston(jp, *a, "put"))(*_j(ARGS[:5])), 1e-9, atol=1e-9)
    _close(tg.greeks_sabr(SABRParams.make(**SP, dtype=F64), *_t(ARGS[:4]), "call"),
           jax.jit(lambda *a: jg.greeks_sabr(js, *a, "call"))(*_j(ARGS[:4])), 1e-9, atol=1e-9)


class _NumpyBS:
    """A black box: numpy in, numpy out."""

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        S, K, T, r, sigma, q = (np.asarray(x, np.float64) for x in (S, K, T, r, sigma, q))
        cp = 1.0 if option_type == "call" else -1.0
        d1 = (np.log(S / K) + (r - q + 0.5 * sigma**2) * T) / (sigma * np.sqrt(T))
        d2 = d1 - sigma * np.sqrt(T)
        return cp * (S * np.exp(-q * T) * norm.cdf(cp * d1)
                     - K * np.exp(-r * T) * norm.cdf(cp * d2))


class _DetachedBS:
    """A torch pricer that computes without grad: it returns no graph."""

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        with torch.no_grad():
            return BlackScholesPricer().price(S, K, T, r, sigma, option_type, q)


class _Failing:
    def price(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("pricer", [_NumpyBS(), _DetachedBS()], ids=["numpy", "no_grad"])
def test_fallback_only_without_a_graph(pricer):
    g = tg.compute_greeks_unified(pricer, *_t(ARGS[:5]), "call", torch.tensor(0.01, dtype=F64))
    fd = tg.greeks_fd(tg.bs_price_fn(1.0), *_t(ARGS))
    assert set(g) == set(fd)
    _close(g, {k: v.numpy() for k, v in fd.items()}, 1e-9, atol=1e-9)
    ref = jg.compute_greeks_unified(_NumpyBS(), *ARGS[:5], "call", 0.01)
    _close(g, ref, 1e-6, atol=1e-6)  # the reference's arguments are float32 here
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tg.compute_greeks_unified(_Failing(), *_t(ARGS[:5]), "call")
    with pytest.raises(TypeError, match="no autograd graph"):
        tg.greeks_from_fn(lambda *a: _NumpyBS().price(*(x.detach() for x in a)), *_t(ARGS))


def test_tree_greeks_match_reference():
    """The reference's lattice Greeks are float32 (its ContractBatch.make
    default), so the port runs in float32 too. An odd step count keeps every
    terminal node off the strike: at a node on the payoff's kink the
    autograd Greeks take the side float32 rounding puts the node on."""
    f32 = [torch.tensor(a, dtype=torch.float32) for a in ARGS]
    g = tg.compute_greeks(*f32[:5], "put", f32[5], american=True, n_steps=17,
                          second_order=True)
    ref = jax.jit(lambda *a: jg.compute_greeks(*a[:5], "put", a[5], american=True, n_steps=17,
                                               second_order=True))(*_j(ARGS))
    assert set(g) == set(ref)
    for k, v in ref.items():  # float32: the book's largest value sets the noise floor
        v = np.asarray(v)
        np.testing.assert_allclose(g[k].numpy(), v, rtol=2e-5, atol=1e-5 * np.abs(v).max(),
                                   err_msg=k)


def test_greeks_fdm_within_the_reference_bounds():
    """tests/test_greeks.py: PDE delta within 5e-3 and vega within 0.5 of
    Black–Scholes at the default 201 × 100 grid."""
    args = _t(SCALAR)
    ex = bs_greeks(*args[:5], 1.0, args[5])
    g = tg.greeks_fdm(*args[:5], "call", args[5])
    assert abs(float(g["delta"] - ex["delta"])) < 5e-3
    assert abs(float(g["vega"] - ex["vega"])) < 0.5


def test_greeks_fdm_american_matches_reference():
    """The American PDE Greeks (Howard iteration, its adjoint through the
    tridiagonal kernel's plain version here) on the reference's small grid."""
    fn = tg.fdm_price_fn(-1.0, n_space=41, n_time=20, american=True)
    g = tg.greeks_from_fn(fn, *_t(ARGS), second_order=False)
    ref = jg.greeks_from_fn(jg.fdm_price_fn(-1.0, n_space=41, n_time=20, american=True),
                            *_j(ARGS), second_order=False)
    _close(g, ref, 1e-7, atol=1e-9)
