"""The port's Heston model (``models/heston.py``) against the JAX package's:
the Lewis and COS engines to 1e-10 in float64, their autograd Greeks against
``jax.grad``, calibration, and the scan Monte Carlo engine against Lewis."""

import inspect
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optionslab_tpu.models import heston as jh
from optionslab_tpu.types import ContractBatch as JContractBatch
from optionslab_tpu_torch.models import heston as th
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.types import ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
PARAM_GRID = [
    (0.04, 2.0, 0.04, 0.3, -0.7),   # textbook
    (0.09, 1.0, 0.09, 0.9, -0.9),   # extreme rho / vol-of-vol
    (0.04, 0.5, 0.06, 0.5, 0.9),    # positive rho
    (0.02, 3.0, 0.02, 0.6, -0.5),   # Feller-violating, thin v0
]
STRIKES = [60.0, 80.0, 100.0, 120.0, 160.0]
LITERATURE = (0.0175, 1.5768, 0.0398, 0.5751, -0.5711)  # Albrecher et al., "little trap"


def _pair(pvals, t, cp, rate=0.03, q=0.01):
    jb = JContractBatch.make(100.0, jnp.asarray(STRIKES, jnp.float64), t, rate, 0.2, cp,
                             dividend=q, dtype=jnp.float64)
    tb = ContractBatch.make(100.0, torch.tensor(STRIKES, dtype=F64), t, rate, 0.2, cp, q,
                            dtype=F64)
    return (jb, jh.HestonParams.make(*pvals, dtype=jnp.float64), tb,
            th.HestonParams.make(*pvals, dtype=F64))


@pytest.mark.parametrize("engine", ["lewis", "cos"])
@pytest.mark.parametrize("pvals", PARAM_GRID)
def test_engines_match_reference(pvals, engine):
    for t in (0.1, 1.0, 5.0):
        for cp in ("call", "put"):
            jb, jp, tb, tp = _pair(pvals, t, cp)
            if engine == "lewis":
                ref = np.asarray(jh.heston_price(jb, jp))
                ours = th.heston_price(tb, tp)
            else:
                ref = np.asarray(jh.heston_price_cos(jb, jp))
                ours = th.heston_price_cos(tb, tp)
            assert ours.dtype == F64 and ours.shape == (5,)
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-10, atol=1e-10)


def test_literature_value():
    jb = JContractBatch.make(100.0, 100.0, 1.0, 0.0, 0.2, "call", dtype=jnp.float64)
    tb = ContractBatch.make(100.0, 100.0, 1.0, 0.0, 0.2, "call", dtype=F64)
    ref = float(jh.heston_price(jb, jh.HestonParams.make(*LITERATURE, dtype=jnp.float64),
                                n_nodes=192, u_max=300.0))
    ours = float(th.heston_price(tb, th.HestonParams.make(*LITERATURE, dtype=F64), n_nodes=192,
                                 u_max=300.0))
    assert abs(ours - 5.7851) < 2e-3
    assert abs(ours - ref) < 1e-10


def test_zero_volofvol_is_black_scholes_and_parity():
    tb = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call", dtype=F64)
    par = th.HestonParams.make(0.04, 2.0, 0.04, 1e-4, 0.0, dtype=F64)
    bs = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0))
    assert abs(float(th.heston_price(tb, par)) - bs) < 1e-4
    assert abs(float(th.heston_price_cos(tb, par)) - bs) < 1e-4
    par = th.HestonParams.make(dtype=F64)
    c = float(th.heston_price(tb, par))
    p = float(th.heston_price(tb.replace(cp=-1.0), par))
    assert abs((c - p) - (100 - 100 * np.exp(-0.05))) < 1e-6


def test_expired_contract_is_intrinsic():
    tb = ContractBatch.make(torch.tensor([90.0, 110.0], dtype=F64), 100.0, 0.0, 0.05, 0.2,
                            "call", dtype=F64)
    par = th.HestonParams.make(dtype=F64)
    np.testing.assert_allclose(th.heston_price(tb, par).numpy(), [0.0, 10.0])
    np.testing.assert_allclose(th.heston_price_cos(tb, par).numpy(), [0.0, 10.0])


NAMES = ("S", "K", "T", "r", "q", "v0", "kappa", "theta", "sigma", "rho")
POINT = (100.0, 95.0, 0.75, 0.04, 0.01) + (0.04, 2.0, 0.04, 0.3, -0.7)


@pytest.mark.parametrize("engine", ["lewis", "cos"])
def test_autograd_greeks_match_jax_grad(engine):
    jfn = jh.heston_price if engine == "lewis" else jh.heston_price_cos
    tfn = th.heston_price if engine == "lewis" else th.heston_price_cos

    def jprice(*a):
        b = JContractBatch(a[0], a[1], a[2], a[3], jnp.float64(0.2), a[4], jnp.float64(1.0))
        return jfn(b, jh.HestonParams(*a[5:])).sum()

    ref = jax.grad(jprice, argnums=tuple(range(10)))(*(jnp.float64(v) for v in POINT))
    x = [torch.tensor(v, dtype=F64, requires_grad=True) for v in POINT]
    b = ContractBatch(x[0], x[1], x[2], x[3], torch.tensor(0.2, dtype=F64), x[4],
                      torch.tensor(1.0, dtype=F64))
    ours = torch.autograd.grad(tfn(b, th.HestonParams(*x[5:])), x)
    for name, o, r in zip(NAMES, ours, ref):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-8, atol=1e-10, err_msg=name)


def test_params_carry_across_and_validate():
    jp = jh.HestonParams.make(0.05, 1.5, 0.06, 0.4, -0.3)
    tp = th.HestonParams.from_numpy({k: np.asarray(getattr(jp, k)) for k in th.PARAM_NAMES})
    assert tp.v0.dtype == torch.float32 and float(tp.rho) == float(np.float32(-0.3))
    assert bool(tp.feller_ok()) == bool(jp.feller_ok())
    assert not bool(th.HestonParams.make(0.04, 0.5, 0.04, 1.0, -0.9).feller_ok())
    with pytest.raises(ValidationError):
        th.HestonPricer(v0=-0.1, device="cpu")
    with pytest.raises(ValidationError):
        th.HestonPricer(rho=1.5, device="cpu")


def test_unconstrained_round_trip():
    p = th.HestonParams.make(0.05, 1.8, 0.05, 0.4, -0.6)
    x = th._to_unconstrained(p)
    ref = np.asarray(jh._to_unconstrained(jh.HestonParams.make(0.05, 1.8, 0.05, 0.4, -0.6)))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-6)
    back = th._from_unconstrained(x)
    for k in th.PARAM_NAMES:
        assert abs(float(getattr(back, k)) - float(getattr(p, k))) < 1e-6


def test_calibration_recovers_params():
    """test_advanced_models.py:166 on the port: Adam through autograd of
    Lewis refits a 3 × 5 surface generated from known parameters."""
    true = th.HestonParams.make(v0=0.05, kappa=1.8, theta=0.05, sigma=0.4, rho=-0.6)
    strikes = torch.tensor([80.0, 90.0, 100.0, 110.0, 120.0])
    mats = torch.tensor([0.25, 0.5, 1.0])
    b = ContractBatch.make(100.0, strikes[None, :], mats[:, None], 0.03, 0.2, "call")
    market = th.heston_price(b, true)
    fit, loss = th.calibrate_heston(market, b, n_steps=400)
    rel = (th.heston_price(b, fit) - market).abs() / market
    assert loss < 1e-4
    assert float(rel.max()) < 0.05
    # the market prices equal the reference's, in float32
    jtrue = jh.HestonParams.make(v0=0.05, kappa=1.8, theta=0.05, sigma=0.4, rho=-0.6)
    jb = JContractBatch.make(100.0, jnp.asarray(strikes.numpy())[None, :],
                             jnp.asarray(mats.numpy())[:, None], 0.03, 0.2, "call",
                             dtype=jnp.float32)
    np.testing.assert_allclose(market.numpy(), np.asarray(jh.heston_price(jb, jtrue)),
                               rtol=2e-5, atol=2e-5)


def _mc(pvals, scheme, n_steps, seed, rate=0.0, n_paths=100_000):
    gen = torch.Generator().manual_seed(seed)
    return float(th.heston_mc_price(ContractBatch.make(100.0, 100.0, 1.0, rate, 0.2, "call"),
                                    th.HestonParams.make(*pvals), gen, n_paths=n_paths,
                                    n_steps=n_steps, scheme=scheme))


def _lewis64(pvals, rate=0.0, **kw):
    return float(th.heston_price(ContractBatch.make(100.0, 100.0, 1.0, rate, 0.2, "call",
                                                    dtype=F64),
                                 th.HestonParams.make(*pvals, dtype=F64), **kw))


@pytest.mark.parametrize("scheme,n_steps,n_paths,bound", [("euler", 100, 100_000, 0.08),
                                                          ("qe", 32, 200_000, 0.06)])
def test_scan_engine_matches_lewis(scheme, n_steps, n_paths, bound):
    """test_advanced_models.py:54 and :68 on the port's scan engine."""
    exact = _lewis64(LITERATURE, n_nodes=192, u_max=300.0)
    assert abs(_mc(LITERATURE, scheme, n_steps, 0, n_paths=n_paths) - exact) < bound


def test_qe_crushes_euler_bias_when_feller_violated():
    pvals = (0.04, 0.5, 0.04, 1.0, -0.9)  # 2κθ = 0.04 << σ² = 1
    logging.disable(logging.WARNING)
    try:
        exact = _lewis64(pvals, rate=0.02)
        eu = np.mean([_mc(pvals, "euler", 8, s, rate=0.02, n_paths=200_000) for s in range(3)])
        qe = np.mean([_mc(pvals, "qe", 8, s, rate=0.02, n_paths=200_000) for s in range(3)])
    finally:
        logging.disable(logging.NOTSET)
    assert abs(eu - exact) > 1.0
    assert abs(qe - exact) < 0.08


def test_scan_engine_validation_and_paths():
    with pytest.raises(ValidationError):
        th.heston_mc_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2),
                           th.HestonParams.make(), torch.Generator(), n_paths=1000, n_steps=4,
                           scheme="milstein")
    spots, variances = th.heston_simulate_paths(100.0, th.HestonParams.make(), 0.05, 0.0, 1.0,
                                                torch.Generator().manual_seed(0), n_paths=64,
                                                n_steps=50)
    assert spots.shape == variances.shape == (64, 51)
    assert bool((variances >= 0).all()) and float(spots[:, 0].min()) == 100.0


def test_pricer_engines_on_cpu():
    pricer = th.HestonPricer(device="cpu")
    lew = float(pricer.price(100.0, 100.0, 1.0, 0.05))
    cos = float(pricer.price_european(100.0, 100.0, 1.0, 0.05, engine="cos"))
    assert abs(lew - cos) < 2e-4
    scan = float(pricer.price_monte_carlo(100.0, 100.0, 1.0, 0.05, n_paths=100_000, n_steps=50))
    assert abs(scan - lew) < 0.15
    spots, _ = pricer.simulate_paths(100.0, 1.0, 0.05, n_paths=8, n_steps=4)
    assert spots.shape == (8, 5)
    # entry points default to the card
    for fn in (th.HestonPricer, th.calibrate_heston_mc):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
