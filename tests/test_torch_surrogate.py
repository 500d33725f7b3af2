"""The port's pricing surrogate (``optionslab_tpu_torch/models/surrogate.py``)
against ``optionslab_tpu.models.surrogate`` on the CPU.

The contracts, features and conformal split come from numpy on both sides
and are identical; the closed-form labels agree to float32 rounding; the
forward on weights carried across agrees to 1e-5; saves load across both
packages; the ``.onnx`` export is the reference's graph. The weights'
initialisation and the shuffles differ by design (torch generators), so a
whole fit is held to the reference test's own accuracy envelope
(``tests/test_ml_vs_mc.py:138``) at that test's configuration.
"""

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.models import surrogate as jsur
from optionslab_tpu.optimize.onnx_emit import OnnxLiteRuntime as JRuntime
from optionslab_tpu.surface import nn_core as jnn
from optionslab_tpu_torch.models import surrogate as tsur
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.optimize.onnx_emit import OnnxLiteRuntime
from optionslab_tpu_torch.utils.exceptions import ModelError

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    """A reference surrogate with initialised weights and scalers (no
    training) and the port's copy of it, through the reference's save."""
    x, y, _ = jsur.generate_training_data(2_000, seed=4)
    ref = jsur.MonteCarloMLSurrogate(hidden_layers=(16, 16), seed=3)
    ref.params = jnn.init_mlp(jax.random.PRNGKey(3), [8, 16, 16, 3])
    ref._x_mean, ref._x_scale = x.mean(0), x.std(0)
    ref._y_mean, ref._y_scale = y.mean(0), y.std(0)
    ref._q_resid = np.asarray([0.01, 0.02, 0.03], np.float32)
    return ref


@pytest.fixture(scope="module")
def fitted():
    """The reference test's fixture configuration: (64, 64), 60 epochs,
    20,000 samples."""
    s = tsur.MonteCarloMLSurrogate(hidden_layers=(64, 64), epochs=60, seed=0, device=CPU)
    s.fit(n_samples=20_000)
    return s


@pytest.mark.parametrize("ranges", [None, tsur.WIDE_PARAM_RANGES], ids=["reference", "wide"])
def test_contracts_and_features_are_the_references(ranges):
    p = tsur.sample_contracts(500, seed=11, ranges=ranges)
    q = jsur.sample_contracts(500, seed=11, ranges=ranges)
    assert p.keys() == q.keys()
    for k in p:
        np.testing.assert_array_equal(p[k], q[k])
    np.testing.assert_array_equal(tsur.engineer_surrogate_features(p),
                                  jsur.engineer_surrogate_features(q))
    assert tsur.SURROGATE_FEATURES == jsur.SURROGATE_FEATURES
    assert tsur.PARAM_RANGES == jsur.PARAM_RANGES and tsur.PRICE_LOG_EPS == jsur.PRICE_LOG_EPS


def test_training_data_matches_reference():
    """The labels from the port's bs_greeks: float32 rounding of the
    reference's (1e-5 relative, 1e-6 absolute in price/K, delta, gamma·K;
    the log target of a deep out-of-the-money price magnifies the float32
    rounding of the closed form, so the price is compared before the log)."""
    x, y, p = tsur.generate_training_data(3_000, seed=5, device=CPU)
    jx, jy, _ = jsur.generate_training_data(3_000, seed=5)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(np.exp(y[:, 0]), np.exp(jy[:, 0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y[:, 1:], jy[:, 1:], rtol=1e-5, atol=1e-6)
    assert y.dtype == np.float32 and y.shape == (3_000, 3)


def test_forward_and_predict_match_reference_on_carried_weights(carried, tmp_path):
    """``_forward`` to 1e-5 through the reference's save and the port's load,
    and back."""
    carried.save(tmp_path / "ref")
    port = tsur.MonteCarloMLSurrogate(device=CPU).load(tmp_path / "ref")
    x = jsur.engineer_surrogate_features(jsur.sample_contracts(256, seed=6))
    np.testing.assert_allclose(port._forward(x), carried._forward(x), rtol=1e-5, atol=1e-5)
    a = port.predict([100.0, 90.0], [100.0, 95.0], [1.0, 0.5], [0.05, 0.02], [0.2, 0.3],
                     "put", 0.01, return_uncertainty=True)
    b = carried.predict([100.0, 90.0], [100.0, 95.0], [1.0, 0.5], [0.05, 0.02], [0.2, 0.3],
                        "put", 0.01, return_uncertainty=True)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5)
    single = port.predict_single(100.0, 100.0, 1.0, 0.05, 0.2)
    assert set(single) == {"price", "delta", "gamma"}
    port.save(tmp_path / "port")
    back = jsur.MonteCarloMLSurrogate().load(tmp_path / "port")
    np.testing.assert_allclose(back._forward(x), port._forward(x), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(back._q_resid, port._q_resid)
    assert back.param_ranges == port.param_ranges


def test_onnx_export_is_the_references_graph(carried, tmp_path):
    """The same nodes, initializers and metadata as the reference's export of
    the same weights; the lite runtime matches ``_forward`` within the
    export's own 2e-4 bound."""
    port = tsur.MonteCarloMLSurrogate(device=CPU)
    carried.save(tmp_path / "ref")
    port.load(tmp_path / "ref")
    manifest = port.export_onnx(tmp_path / "port.onnx")
    carried.export_onnx(tmp_path / "ref.onnx")
    mine, theirs = OnnxLiteRuntime(tmp_path / "port.onnx"), JRuntime(tmp_path / "ref.onnx")
    assert mine.nodes == theirs.nodes and mine.metadata == theirs.metadata
    assert mine.tensors.keys() == theirs.tensors.keys()
    for k in mine.tensors:
        np.testing.assert_array_equal(mine.tensors[k], theirs.tensors[k])
    assert manifest["layernorm"] and manifest["output_affine"]
    assert manifest["roundtrip_max_abs_err"] <= 2e-4


def test_unfitted_surrogate_raises(tmp_path):
    s = tsur.MonteCarloMLSurrogate(device=CPU)
    for call in (lambda: s._forward(np.zeros((1, 8), np.float32)),
                 lambda: s.save(tmp_path / "x"), lambda: s.export_onnx(tmp_path / "x.onnx")):
        with pytest.raises(ModelError):
            call()


def test_fit_meets_the_reference_envelope(fitted):
    """tests/test_ml_vs_mc.py:138: delta R² above 0.99, price above 0.95."""
    scores = fitted.score(5_000)
    assert scores["r2_delta"] > 0.99
    assert scores["r2_price"] > 0.95
    loss = fitted.history["loss"]
    assert len(loss) == 60 and loss[-1] < loss[0]


def test_conformal_bands_cover(fitted):
    """Split-conformal bands at 0.9 cover fresh call prices at the reference
    test's rate (0.85, tests/test_ml_vs_mc.py:60), and bracket the point."""
    p = tsur.sample_contracts(4_000, seed=77)
    out = fitted.predict(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"], "call", 0.0,
                         return_uncertainty=True)
    truth = bs_price(*(torch.as_tensor(p[k]) for k in ("spot", "strike", "maturity", "rate",
                                                       "vol")), 1.0, 0.0).numpy()
    inside = (out["price_lo"] <= truth) & (truth <= out["price_hi"])
    assert inside.mean() >= 0.85
    assert np.all(out["price_lo"] <= out["price"] + 1e-6)
    assert np.all(out["price"] <= out["price_hi"] + 1e-6)
    assert float(out["delta_err"][0]) > 0


@pytest.mark.parametrize("as_tensor", [False, True])
def test_fit_to_pricer_takes_arrays_and_tensors(as_tensor):
    """A pricer's (n, 3) [price/K, delta, gamma·K], as numpy or a tensor; the
    price column becomes the log target."""
    seen = {}

    def pricer(p):
        k = torch.as_tensor(p["strike"])
        g = tsur.bs_greeks(*(torch.as_tensor(p[n]) for n in ("spot", "strike", "maturity",
                                                              "rate", "vol", "cp",
                                                              "dividend")))
        y = torch.stack([g["price"] / k, g["delta"], g["gamma"] * k], 1)
        seen["y"] = y.numpy()
        return y if as_tensor else y.numpy()

    s = tsur.MonteCarloMLSurrogate(hidden_layers=(16,), epochs=3, seed=1, device=CPU)
    scores = s.fit_to_pricer(pricer, n_samples=1_000)
    assert set(scores) == {"r2_price", "r2_delta", "r2_gamma"}
    x, y, _ = tsur.generate_training_data(1_000, seed=1, device=CPU)
    np.testing.assert_allclose(np.log(seen["y"][:, 0] + tsur.PRICE_LOG_EPS), y[:, 0], rtol=1e-5,
                               atol=1e-5)


def test_training_is_deterministic():
    a, b = (tsur.MonteCarloMLSurrogate(hidden_layers=(8,), epochs=2, seed=5, device=CPU)
            for _ in range(2))
    a.fit(2_000)
    b.fit(2_000)
    x = tsur.engineer_surrogate_features(tsur.sample_contracts(64, 9))
    np.testing.assert_array_equal(a._forward(x), b._forward(x))


def test_label_error_model_matches_the_spread_of_launches():
    """``chip_smoke.label_error_model`` (the exact standard errors of the GBM
    kernel's price, delta and gamma estimators, antithetic pairs included)
    against the spread of 48 independently seeded launches of the kernel's
    plain version, where ≥ 25 in-the-money paths are expected: the median
    ratio per estimator within 10 %, every ratio within 0.5–1.6 (the spread
    of 48 draws is itself ≈10 % uncertain: 5 of its sd either way, more for
    the heavier-tailed gamma)."""
    import chip_smoke as cs
    from optionslab_tpu_torch import ContractBatch
    from optionslab_tpu_torch.ops import gbm_kernel as gk

    p = tsur.sample_contracts(40, seed=21)
    b = ContractBatch(**{k: torch.as_tensor(p[k]) for k in cs.FDM_FIELDS})
    n = gk.gbm_paths_per_launch(b, 4_096)
    runs = [gk.gbm_mc_price_greeks(b, n_paths=4_096, seed=s) for s in range(48)]
    k = b.strike.double()
    spread = torch.stack([torch.stack([r["price"].double() / k, r["delta"].double(),
                                       r["gamma"].double() * k]) for r in runs]).std(0)
    se, lam, _ = cs.label_error_model(b, n)
    ok = lam >= cs.LN_POISSON
    assert int(ok.sum()) >= 20
    ratio = (spread / se)[:, ok]
    assert bool(((ratio.median(1).values - 1.0).abs() < 0.1).all()), ratio.median(1)
    assert float(ratio.min()) > 0.5 and float(ratio.max()) < 1.6, ratio
