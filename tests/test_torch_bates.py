"""The port's Bates model (``models/bates.py``) against the JAX package's:
Lewis and COS to 1e-10 in float64 (the Heston engines' tolerance: the same
quadrature and expansion in the same precision), the λ → 0 and σ → 0
reductions, autograd against ``jax.grad``, the scan Monte Carlo against
Lewis, calibration and the pricer façade."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optionslab_tpu.models import bates as jb
from optionslab_tpu.models.jump_diffusion import merton_price
from optionslab_tpu.types import ContractBatch as JContractBatch
from optionslab_tpu_torch.models import bates as tb
from optionslab_tpu_torch.models.heston import HestonParams, heston_price
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
STRIKES = [70.0, 90.0, 100.0, 110.0, 140.0]
PARAM_GRID = [
    (0.04, 2.0, 0.04, 0.3, -0.7, 0.5, -0.1, 0.15),  # the default
    (0.09, 1.0, 0.09, 0.9, -0.9, 1.5, -0.25, 0.3),  # heavy jumps, extreme vol-of-vol
    (0.02, 3.0, 0.03, 0.4, 0.3, 0.2, 0.05, 0.1),    # upward jumps, positive rho
]


def _pair(pvals, t, cp, rate=0.03, q=0.01, strikes=STRIKES):
    jbatch = JContractBatch.make(100.0, jnp.asarray(strikes, jnp.float64), t, rate, 0.2, cp,
                                 dividend=q, dtype=jnp.float64)
    tbatch = ContractBatch.make(100.0, torch.tensor(strikes, dtype=F64), t, rate, 0.2, cp, q,
                                dtype=F64)
    return (jbatch, jb.BatesParams.make(*pvals, dtype=jnp.float64), tbatch,
            tb.BatesParams.make(*pvals, dtype=F64))


@pytest.mark.parametrize("engine", ["lewis", "cos"])
@pytest.mark.parametrize("pvals", PARAM_GRID)
def test_engines_match_reference(pvals, engine):
    for t in (0.1, 1.0, 4.0):
        for cp in ("call", "put"):
            jbatch, jpar, tbatch, tpar = _pair(pvals, t, cp)
            if engine == "lewis":
                ref, ours = jb.bates_price(jbatch, jpar), tb.bates_price(tbatch, tpar)
            else:
                ref, ours = jb.bates_price_cos(jbatch, jpar), tb.bates_price_cos(tbatch, tpar)
            assert ours.dtype == F64 and ours.shape == (5,)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_zero_intensity_is_heston():
    _, _, tbatch, _ = _pair(PARAM_GRID[0], 1.0, "call")
    pb = tb.BatesParams.make(lam=0.0, dtype=F64)
    ph = HestonParams.make(dtype=F64)
    np.testing.assert_allclose(tb.bates_price(tbatch, pb).numpy(),
                               heston_price(tbatch, ph).numpy(), rtol=0, atol=1e-12)


def test_frozen_variance_is_merton():
    """v0 = θ with a vanishing vol-of-vol freezes v at θ: Bates is Merton
    with σ = √θ (the reference's bound, 1e-4: the residual vol-of-vol)."""
    strikes = [80.0, 100.0, 120.0]
    jbatch = JContractBatch.make(100.0, jnp.asarray(strikes), 1.0, 0.05, 0.2, "call",
                                 dtype=jnp.float64)
    tbatch = ContractBatch.make(100.0, torch.tensor(strikes, dtype=F64), 1.0, 0.05, 0.2, "call",
                                dtype=F64)
    pm = tb.BatesParams.make(0.04, 2.0, 0.04, 1e-3, 0.0, 0.5, -0.1, 0.15, dtype=F64)
    np.testing.assert_allclose(tb.bates_price(tbatch, pm).numpy(),
                               np.asarray(merton_price(jbatch, 0.5, -0.1, 0.15)), atol=1e-4)


def test_jumps_add_value_otm_and_parity():
    _, _, tbatch, _ = _pair(PARAM_GRID[0], 1.0, "call")
    with_j = tb.bates_price(tbatch, tb.BatesParams.make(lam=1.0, sigma_j=0.2, dtype=F64))
    without = tb.bates_price(tbatch, tb.BatesParams.make(lam=0.0, dtype=F64))
    assert with_j[-1] > without[-1]  # the 140-strike call
    p = tb.BatesParams.make(dtype=F64)
    c = tb.bates_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call", dtype=F64), p)
    q = tb.bates_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "put", dtype=F64), p)
    assert abs(float(c - q) - (100.0 - 100.0 * np.exp(-0.05))) < 1e-10


def test_expiring_contract_prices_intrinsic():
    p = tb.BatesParams.make(dtype=F64)
    b = ContractBatch.make(110.0, 100.0, 0.0, 0.05, 0.2, "call", dtype=F64)
    assert abs(float(tb.bates_price(b, p)) - 10.0) < 1e-10
    assert abs(float(tb.bates_price_cos(b, p)) - 10.0) < 1e-10


def test_autograd_matches_jax_grad():
    """∂price/∂(every parameter) of the ATM call by autograd of the port's
    Lewis engine against jax.grad of the reference's, float64."""
    names = tb.PARAM_NAMES
    vals = PARAM_GRID[0]
    x = {k: torch.tensor(v, dtype=F64, requires_grad=True) for k, v in zip(names, vals)}
    batch = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call", dtype=F64)
    (ours,) = [torch.stack(torch.autograd.grad(tb.bates_price(batch, tb.BatesParams(**x)),
                                               list(x.values())))]
    jbatch = JContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call", dtype=jnp.float64)
    ref = jax.grad(lambda v: jb.bates_price(jbatch, jb.BatesParams(*v)))(
        [jnp.asarray(v, jnp.float64) for v in vals])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-8, atol=1e-10)


def test_from_numpy_carries_jax_params():
    jpar = jb.BatesParams.make(0.05, 1.5, 0.05, 0.4, -0.6, 0.8, -0.08, 0.12)
    tpar = tb.BatesParams.from_numpy({k: np.asarray(getattr(jpar, k)) for k in tb.PARAM_NAMES})
    assert tpar.lam.dtype == torch.float32 and float(tpar.mu_j) == float(np.float32(-0.08))
    assert isinstance(tpar.heston, HestonParams) and float(tpar.heston.rho) == float(tpar.rho)
    jbatch = JContractBatch.make(100.0, jnp.asarray([90.0, 110.0]), 1.0, 0.05, 0.2, "call")
    tbatch = ContractBatch.make(100.0, torch.tensor([90.0, 110.0]), 1.0, 0.05, 0.2, "call")
    np.testing.assert_allclose(tb.bates_price(tbatch, tpar).numpy(),
                               np.asarray(jb.bates_price(jbatch, jpar)), rtol=1e-5)
    assert tpar.to(dtype=F64).sigma_j.dtype == F64


def test_mc_matches_lewis():
    """The scan engine (float32, full-truncation Euler with Poisson-count
    jumps) against Lewis: the mean of 8 seeds within 4 of their standard
    errors plus the Euler bias at 50 steps (measured on the reference's
    test size: a few cents, 0.03 allowed)."""
    strikes = [80.0, 100.0, 120.0]
    batch = ContractBatch.make(100.0, torch.tensor(strikes), 1.0, 0.05, 0.2, "call")
    exact = tb.bates_price(batch.astype(F64), tb.BatesParams.make(dtype=F64)).numpy()
    reps = np.stack([tb.bates_mc_price(batch, tb.BatesParams.make(),
                                       torch.Generator().manual_seed(s), n_paths=25_000,
                                       n_steps=50).numpy() for s in range(8)])
    se = reps.std(axis=0, ddof=1) / np.sqrt(8)
    assert np.all(np.abs(reps.mean(axis=0) - exact) < 4 * se + 0.03), (reps.mean(0), exact, se)


def test_calibration_recovers_prices():
    """calibrate_bates on the reference's test: prices of known parameters
    (float64 Lewis), recovered to 2% (the reference's bound) from the
    default start."""
    strikes = [80.0, 90.0, 100.0, 110.0, 120.0]
    batch = ContractBatch.make(100.0, torch.tensor(strikes, dtype=F64), 1.0, 0.05, 0.2, "call",
                               dtype=F64)
    true = tb.BatesParams.make(0.05, 1.5, 0.05, 0.4, -0.6, 0.8, -0.08, 0.12, dtype=F64)
    target = tb.bates_price(batch, true).detach()
    fitted, loss = tb.calibrate_bates(target, batch, n_steps=400, learning_rate=0.02)
    assert loss < 1e-4
    refit = tb.bates_price(batch, fitted).detach()
    np.testing.assert_allclose(refit.numpy(), target.numpy(), rtol=0.02)


def test_pricer_facade():
    pr = tb.BatesPricer(device="cpu")
    a = float(pr.price_european(100.0, 100.0, 1.0, 0.05))
    b = float(pr.price_european(100.0, 100.0, 1.0, 0.05, engine="cos"))
    assert abs(a - b) < 1e-4 and 5.0 < a < 20.0
    ref = float(jb.BatesPricer().price_european(100.0, 100.0, 1.0, 0.05))
    assert a == pytest.approx(ref, rel=1e-5)
    with pytest.raises(ValidationError):
        pr.price_european(100.0, 100.0, 1.0, 0.05, engine="fft")
    with pytest.raises(ValidationError):
        tb.BatesPricer(lam=-1.0, device="cpu")
    with pytest.raises(ValidationError):
        tb.BatesPricer(sigma_j=-0.1, device="cpu")
