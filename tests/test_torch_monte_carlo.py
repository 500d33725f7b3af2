"""The port's Monte Carlo engine against the JAX package: the tensor path on
the same numpy normals (float64), the pricer's kernel route, and the slice
as a whole — a book through the port against ``pallas_mc_price_greeks``."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import optionslab_tpu_torch as ot
from optionslab_tpu.ops import gbm_pallas as gp
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch.models import monte_carlo as tmc
from optionslab_tpu_torch.models.black_scholes import bs_greeks
from optionslab_tpu_torch.types import FIELDS, ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError

# the JAX package's models/__init__ re-exports functions under module names
jmc = importlib.import_module("optionslab_tpu.models.monte_carlo")

MC_KEYS = ("price", "delta", "gamma", "vega", "rho", "theta", "dual_delta", "dividend_rho")


def _np(t):
    return t.detach().cpu().numpy()


def _books(rng, n=6):
    f = dict(spot=rng.uniform(85, 115, n), strike=rng.uniform(90, 110, n),
             maturity=rng.uniform(0.25, 2.0, n), rate=rng.uniform(0.0, 0.06, n),
             vol=rng.uniform(0.15, 0.4, n), dividend=rng.uniform(0.0, 0.03, n),
             cp=np.where(np.arange(n) % 2 == 0, 1.0, -1.0))
    jb = JBatch(**{k: jnp.asarray(v) for k, v in f.items()})
    tb = ContractBatch(**{k: torch.as_tensor(v) for k, v in f.items()})
    return jb, tb


@pytest.fixture
def same_normals(monkeypatch):
    """Make both packages' draw_normals return one numpy draw (float64)."""
    def use(z):
        monkeypatch.setattr(jmc, "draw_normals", lambda key, cfg: jnp.asarray(z))
        monkeypatch.setattr(tmc, "draw_normals", lambda gen, cfg: torch.as_tensor(z))
    return use


@pytest.mark.parametrize("n_steps", [1, 4])
def test_gbm_terminal_and_paths_match_jax(rng, n_steps):
    jb, tb = _books(rng)
    z = rng.standard_normal((2048, n_steps))
    np.testing.assert_allclose(_np(tmc.gbm_terminal(tb, torch.as_tensor(z))),
                               np.asarray(jmc.gbm_terminal(jb, jnp.asarray(z))), rtol=1e-12)
    np.testing.assert_allclose(_np(tmc.gbm_paths(tb, torch.as_tensor(z))),
                               np.asarray(jmc.gbm_paths(jb, jnp.asarray(z))), rtol=1e-12)


def test_mc_price_and_result_match_jax(rng, same_normals):
    jb, tb = _books(rng)
    jb = jb.replace(maturity=jb.maturity.at[0].set(0.0))  # an expired contract
    tb = tb.replace(maturity=torch.as_tensor(np.array(jb.maturity)))
    z = rng.standard_normal((4096, 1))
    same_normals(np.concatenate([z, -z]))
    jcfg, tcfg = jmc.MCConfig(n_paths=8192), tmc.MCConfig(n_paths=8192)
    np.testing.assert_allclose(_np(tmc.mc_price(tb, None, tcfg)),
                               np.asarray(jmc.mc_price(jb, None, jcfg)), rtol=1e-12)
    tr, jr = tmc.mc_price_result(tb, None, tcfg), jmc.mc_price_result(jb, None, jcfg)
    np.testing.assert_allclose(_np(tr.price), np.asarray(jr.price), rtol=1e-12)
    np.testing.assert_allclose(_np(tr.std_error), np.asarray(jr.std_error), rtol=1e-10)
    tc, jc = tmc.mc_price_control_variate(tb, None, tcfg), jmc.mc_price_control_variate(
        jb, None, jcfg)
    np.testing.assert_allclose(_np(tc.price), np.asarray(jc.price), rtol=1e-10)
    np.testing.assert_allclose(_np(tc.std_error), np.asarray(jc.std_error), rtol=1e-10)
    lo, hi = tr.confidence_interval()
    assert torch.all(lo <= tr.price) and torch.all(tr.price <= hi)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_mc_greeks_autograd_matches_jax_grad(rng, same_normals, n_steps):
    jb, tb = _books(rng)
    same_normals(rng.standard_normal((4096, n_steps)))
    jcfg = jmc.MCConfig(n_paths=4096, n_steps=n_steps, antithetic=False)
    tcfg = tmc.MCConfig(n_paths=4096, n_steps=n_steps, antithetic=False)
    jg, tg = jmc.mc_greeks(jb, None, jcfg), tmc.mc_greeks(tb, None, tcfg)
    for k in MC_KEYS:
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]), rtol=1e-9, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("kwargs", [dict(n_paths=0), dict(n_steps=0),
                                    dict(n_paths=1001, antithetic=True),
                                    dict(method=tmc.MCMethod.QMC)])
def test_validate_config_errors(kwargs):
    with pytest.raises(ValidationError):
        tmc._validate_config(tmc.MCConfig(**kwargs))
    with pytest.raises(ValidationError):
        tmc.MonteCarloPricer(**kwargs, device="cpu")


def test_method_wire_values_match_jax():
    assert tmc.MCMethod("xla") is tmc.MCMethod.TENSOR
    assert tmc.MCMethod("pallas") is tmc.MCMethod.KERNEL
    assert tmc.MCMethod.KERNEL.value == jmc.MCMethod.PALLAS.value
    assert tmc.MCMethod.TENSOR.value == jmc.MCMethod.XLA.value


def test_draw_normals_antithetic_and_reproducible():
    cfg = tmc.MCConfig(n_paths=1000, n_steps=2, dtype=torch.float64)
    z1 = tmc.draw_normals(torch.Generator().manual_seed(3), cfg)
    z2 = tmc.draw_normals(torch.Generator().manual_seed(3), cfg)
    assert z1.shape == (1000, 2) and z1.dtype == torch.float64
    torch.testing.assert_close(z1[500:], -z1[:500])
    torch.testing.assert_close(z1, z2)


def test_pricer_kernel_route_matches_bs():
    pricer = tmc.MonteCarloPricer(n_paths=1_000_000, method=tmc.MCMethod.KERNEL, seed=4,
                                  device="cpu")
    out = pricer.greeks(100.0, 100.0, 1.0, 0.05, 0.2, "call")
    ex = bs_greeks(100.0, 100.0, 1.0, 0.05, 0.2)
    assert abs(float(out["price"]) - float(ex["price"])) < 4 * float(out["std_error"])
    for k, bound in (("delta", 5e-3), ("gamma", 1e-3), ("vega", 0.5), ("rho", 0.5),
                     ("dual_delta", 5e-3)):
        assert abs(float(out[k]) - float(ex[k])) < bound, k
    res = pricer.price(100.0, 100.0, 1.0, 0.05, 0.2, "call", return_result=True)
    assert float(res.price) == float(out["price"]) and res.n_paths == 1_000_000
    d, g = pricer.delta_gamma(100.0, 100.0, 1.0, 0.05, 0.2)
    assert float(d) == float(out["delta"]) and float(g) == float(out["gamma"])


def test_pricer_tensor_route_matches_bs():
    pricer = tmc.MonteCarloPricer(n_paths=200_000, seed=1, device="cpu")
    res = pricer.price([95.0, 105.0], 100.0, 1.0, 0.05, 0.2, "put", return_result=True)
    ex = bs_greeks(torch.tensor([95.0, 105.0]), 100.0, 1.0, 0.05, 0.2, -1.0)["price"]
    assert torch.all((res.price - ex).abs() < 4 * res.std_error)
    g = pricer.greeks(100.0, 100.0, 1.0, 0.05, 0.2)
    assert abs(float(g["delta"]) - 0.6368) < 0.01
    torch.testing.assert_close(pricer.price(100.0, 100.0, 1.0, 0.05, 0.2),
                               pricer.price(100.0, 100.0, 1.0, 0.05, 0.2))


def test_slice_book_matches_jax_pallas_path():
    """The slice end to end: a 64-contract mixed book through the port's
    public entry against the JAX kernel path, both with sampler="hash"."""
    n = 64
    i = np.arange(n)
    jb = JBatch.make(np.linspace(90.0, 110.0, n), 100.0, np.linspace(0.5, 2.0, n), 0.04,
                     np.linspace(0.2, 0.35, n), np.where(i % 3 == 0, -1.0, 1.0), 0.01,
                     dtype=jnp.float32)
    ref = gp.pallas_mc_price_greeks(jb, n_paths=65_536, seed=11, sampler="hash")
    tb = ot.ContractBatch.from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS})
    out = ot.gbm_mc_price_greeks(tb, n_paths=65_536, seed=11, sampler="hash")
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]), rtol=1e-4, err_msg=k)
    # and both agree with Black–Scholes at this path count
    ex = bs_greeks(tb.spot, tb.strike, tb.maturity, tb.rate, tb.vol, tb.cp, tb.dividend)
    assert torch.all((out["price"] - ex["price"]).abs() < 5 * out["std_error"])


def test_jax_reference_untouched_by_patching():
    """The JAX pricer still draws its own normals (the fixture is scoped)."""
    z = jmc.draw_normals(jax.random.PRNGKey(0), jmc.MCConfig(n_paths=8))
    assert z.shape == (8, 1)
