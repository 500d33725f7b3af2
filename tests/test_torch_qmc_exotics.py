"""The port's Brownian-bridge QMC exotics against
``optionslab_tpu.models.qmc_exotics``.

Without a generator (JAX: without a key) both packages draw the same
unscrambled Sobol points, so the bridge paths agree exactly and the prices
to float32 rounding (2e-6 relative); with a generator the points are
randomly shifted and the geometric Asian is held to its closed form. Then
the oracle checks of ``tests/test_qmc_exotics.py`` at small sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import qmc_exotics as jq
from optionslab_tpu_torch.models import qmc_exotics as tq
from optionslab_tpu_torch.models.exotics import geometric_asian_closed_form
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,n_steps", [(np.float32, 16), (np.float64, 13)])
def test_bridge_matches_reference(dtype, n_steps):
    z = np.random.default_rng(0).standard_normal((256, n_steps)).astype(dtype)
    ours = tq.brownian_bridge_paths(torch.tensor(z), 1.3).numpy()
    ref = np.asarray(jq.brownian_bridge_paths(jnp.asarray(z), 1.3))
    assert ours.dtype == dtype and ours.shape == (256, n_steps + 1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    assert [a.tolist() for a in tq._bridge_order(n_steps)] == \
        [a.tolist() for a in jq._bridge_order(n_steps)]


CASES = {
    "asian_arith": (jq.qmc_asian_price, tq.qmc_asian_price, {}),
    "asian_geo_put": (jq.qmc_asian_price, tq.qmc_asian_price,
                      {"averaging": "geometric", "cp": -1.0}),
    "lookback_fixed_put": (jq.qmc_lookback_price, tq.qmc_lookback_price,
                           {"floating": False, "cp": -1.0}),
    "barrier_down_in_put": (jq.qmc_barrier_price, tq.qmc_barrier_price,
                            {"barrier": 85.0, "barrier_type": "down-and-in", "cp": -1.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unscrambled_prices_match_reference(case):
    jfn, tfn, kw = CASES[case]
    kw = dict(kw)
    barrier = (kw.pop("barrier"),) if "barrier" in kw else ()
    args = (100.0, 105.0, *barrier, 1.0, 0.05, 0.25)
    size = dict(n_paths=4096, n_steps=16)
    ref = float(jfn(*args, None, dividend=0.01, **size, **kw))
    ours = tfn(*args, None, dividend=0.01, device="cpu", **size, **kw)
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(ref, rel=2e-6)


def test_scrambled_geometric_asian_hits_the_closed_form():
    cf = float(geometric_asian_closed_form(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0, 64))
    prices = [tq.qmc_asian_price(100.0, 100.0, 1.0, 0.05, 0.2, torch.Generator().manual_seed(s),
                                 n_paths=16_384, n_steps=64, averaging="geometric")
              for s in range(3)]
    assert np.mean([abs(float(p) - cf) for p in prices]) < 0.005
    p, se = tq.qmc_asian_price(100.0, 100.0, 1.0, 0.05, 0.2, torch.Generator().manual_seed(9),
                               n_paths=16_384, n_steps=64, averaging="geometric",
                               return_stderr=True)
    assert abs(float(p) - cf) < float(se)  # the plain-MC stderr is pessimistic for QMC


def test_bridge_covariance_and_edges():
    z = torch.randn((100_000, 16), generator=torch.Generator().manual_seed(0))
    w = tq.brownian_bridge_paths(z, 2.0).numpy()
    times = np.linspace(0, 2.0, 17)
    np.testing.assert_allclose(w.var(axis=0)[1:], times[1:], rtol=0.03)
    assert abs(float(np.mean(w[:, 4] * w[:, 16])) - times[4]) < 0.02
    np.testing.assert_array_equal(w[:, 0], 0.0)


def test_lookback_and_barrier_partition():
    kw = dict(n_paths=16_384, n_steps=32, device="cpu")
    lb = float(tq.qmc_lookback_price(100.0, 100.0, 1.0, 0.05, 0.2, None, 1.0, **kw))
    assert lb > 10.45  # above the European
    ko = float(tq.qmc_barrier_price(100.0, 100.0, 120.0, 1.0, 0.05, 0.2, None, 1.0, **kw))
    ki = float(tq.qmc_barrier_price(100.0, 100.0, 120.0, 1.0, 0.05, 0.2, None, 1.0,
                                    barrier_type="up-and-in", **kw))
    assert abs((ko + ki) - 10.4506) < 0.1


def test_bad_inputs_raise():
    with pytest.raises(ValidationError):
        tq.qmc_asian_price(100.0, 100.0, 1.0, 0.05, 0.2, None, n_paths=1024, n_steps=128,
                           device="cpu")
    with pytest.raises(ValidationError):
        tq.qmc_barrier_price(100.0, 100.0, 120.0, 1.0, 0.05, 0.2, None, barrier_type="sideways",
                             device="cpu")
