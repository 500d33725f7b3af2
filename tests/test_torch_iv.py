"""The port's implied-vol solver against ``optionslab_tpu.models.iv``.

A numpy-seeded chain (calls and puts, dividends, a few quotes outside the
no-arbitrage bounds and one expired contract) goes through both solvers in
float64 (to 1e-9) and float32 (to 1e-5 absolute in vol); then the oracle
checks of ``tests/test_iv_solver.py``: round trips, NaN where no solution,
the surface, and the arbitrage errors of the scalar wrapper.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import iv as jiv
from optionslab_tpu.models.black_scholes import bs_price as jbs_price
from optionslab_tpu_torch.models import iv as tiv
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.types import ContractBatch
from optionslab_tpu_torch.utils.exceptions import ArbitrageViolationError, ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 40


@pytest.fixture(scope="module")
def chain():
    """(inputs, true vols, reference IVs) per dtype: the JAX solver runs once
    per dtype."""
    rng = np.random.default_rng(7)
    spot = rng.uniform(80, 120, N)
    strike = rng.uniform(60, 150, N)
    mat = rng.uniform(0.02, 3.0, N)
    rate = rng.uniform(0.0, 0.08, N)
    div = rng.uniform(0.0, 0.04, N)
    cp = np.where(rng.uniform(size=N) < 0.5, 1.0, -1.0)
    vol = rng.uniform(0.05, 1.2, N)
    price = np.array(jbs_price(*(jnp.asarray(x) for x in (spot, strike, mat, rate, vol, cp,
                                                            div))))
    price[3] = 0.0  # below the lower bound
    price[5] = spot[5] * 2.0  # above the upper bound
    mat[8] = 0.0  # expired
    out = {}
    for dt in (np.float64, np.float32):
        args = [x.astype(dt) for x in (price, spot, strike, mat, rate, cp, div)]
        out[dt] = (args, np.asarray(jiv.implied_vol(*(jnp.asarray(a) for a in args))))
    return out, vol


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_implied_vol_matches_reference(chain, dtype, atol):
    (by_dtype, _) = chain
    args, ref = by_dtype[dtype]
    ours = tiv.implied_vol(*(torch.tensor(a) for a in args)).numpy()
    assert ours.dtype == dtype
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[[3, 5, 8]]).all()
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def test_round_trip_recovers_the_vols(chain):
    (by_dtype, vol) = chain
    args, _ = by_dtype[np.float64]
    ours = tiv.implied_vol(*(torch.tensor(a) for a in args)).numpy()
    live = ~np.isnan(ours)
    assert live.sum() == N - 3
    np.testing.assert_allclose(ours[live], vol[live], atol=2e-6)


@pytest.mark.parametrize("S,K,T,r,sigma,cp,q,tol", [
    (100.0, 80.0, 1.0, 0.05, 0.25, -1.0, 0.0, 1e-6),
    (100.0, 120.0, 1.0, 0.05, 0.25, 1.0, 0.0, 1e-6),
    (100.0, 100.0, 0.01, 0.05, 0.3, 1.0, 0.0, 1e-6),
    (100.0, 100.0, 1.0, 0.05, 1.5, 1.0, 0.0, 1e-6),
    (100.0, 100.0, 1.0, 0.05, 0.02, 1.0, 0.0, 1e-5),
    (100.0, 110.0, 0.5, 0.03, 0.4, -1.0, 0.02, 1e-6),
    (100.0, 200.0, 1.0, 0.05, 0.35, 1.0, 0.0, 1e-5),
])
def test_round_trips(S, K, T, r, sigma, cp, q, tol):
    args = [torch.tensor(x, dtype=torch.float64) for x in (S, K, T, r, sigma)]
    price = bs_price(*args, cp, q)
    iv = tiv.implied_vol(price, *args[:4], cp, q)
    assert abs(float(iv) - sigma) < tol


def test_surface_and_batch_protocol():
    strikes = torch.tensor([80.0, 100.0, 120.0], dtype=torch.float64)
    mats = torch.tensor([0.25, 1.0], dtype=torch.float64)
    prices = bs_price(100.0, strikes[None, :], mats[:, None], 0.05, 0.3, 1.0, 0.0)
    surf = tiv.iv_surface_from_prices(prices, 100.0, strikes, mats, 0.05)
    assert surf.shape == (2, 3)
    np.testing.assert_allclose(surf.numpy(), 0.3, atol=1e-6)
    ref = jiv.iv_surface_from_prices(jnp.asarray(prices.numpy()), 100.0,
                                     jnp.asarray(strikes.numpy()), jnp.asarray(mats.numpy()), 0.05)
    np.testing.assert_allclose(surf.numpy(), np.asarray(ref), atol=1e-9)
    batch = ContractBatch.make(100.0, strikes, 1.0, 0.05, 0.3, "call", dtype=torch.float64)
    np.testing.assert_allclose(tiv.iv_batch(batch, prices[1]).numpy(), 0.3, atol=1e-6)


def test_batch_with_nan_for_invalid():
    prices = torch.tensor([10.45, 200.0, 0.0], dtype=torch.float64)
    iv = tiv.implied_vol(prices, 100.0, 100.0, 1.0, 0.05).numpy()
    assert abs(iv[0] - 0.2) < 1e-3 and np.isnan(iv[1:]).all()


@pytest.mark.parametrize("price,K,T,exc", [(0.001, 60.0, 1.0, ArbitrageViolationError),
                                           (150.0, 100.0, 1.0, ArbitrageViolationError),
                                           (5.0, 100.0, 0.0, ValidationError)])
def test_scalar_wrapper_raises_as_the_reference(price, K, T, exc):
    with pytest.raises(exc):
        tiv.implied_volatility(price, 100.0, K, T, 0.05, "call", device="cpu")
    with pytest.raises(ValueError):
        jiv.implied_volatility(price, 100.0, K, T, 0.05, "call")


def test_scalar_wrapper_matches_reference():
    ours = tiv.implied_volatility(7.5, 100.0, 105.0, 0.75, 0.03, "put", 0.01, device="cpu")
    ref = jiv.implied_volatility(7.5, 100.0, 105.0, 0.75, 0.03, "put", 0.01)
    assert ours.device.type == "cpu" and ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(ref), abs=1e-5)
