"""The port's ContractBatch, math primitives and Black–Scholes closed form
against the JAX package on the same inputs."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.ops import math as jmath
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch.models import black_scholes as tbs
from optionslab_tpu_torch.ops import math as tmath
from optionslab_tpu_torch.types import FIELDS, ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX package's models/__init__ re-exports a function under the module's name
jbs = importlib.import_module("optionslab_tpu.models.black_scholes")

GREEKS = ("price", "delta", "gamma", "vega", "theta", "rho", "dual_delta",
          "vanna", "charm", "vomma", "speed")


def _book(rng, n=12):
    return dict(spot=rng.uniform(60, 140, n), strike=rng.uniform(70, 130, n),
                maturity=rng.uniform(0.05, 3.0, n), rate=rng.uniform(-0.01, 0.08, n),
                vol=rng.uniform(0.05, 0.8, n), dividend=rng.uniform(0.0, 0.05, n),
                cp=np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0))


def _np(t):
    return t.detach().cpu().numpy()


class TestContractBatch:
    def test_from_numpy_round_trip(self, rng):
        f = _book(rng)
        jb = JBatch.make(f["spot"], f["strike"], f["maturity"], f["rate"], f["vol"], f["cp"],
                         f["dividend"], dtype=jnp.float32)
        tb = ContractBatch.from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS})
        for k in FIELDS:
            assert getattr(tb, k).dtype == torch.float32
            np.testing.assert_array_equal(_np(getattr(tb, k)), np.asarray(getattr(jb, k)))
        assert tb.shape == tuple(jb.shape) and tb.size == jb.size

    def test_broadcast_and_helpers_match_jax(self, rng):
        spots = rng.uniform(80, 120, (3, 4))
        strikes = rng.uniform(90, 110, (4,))
        jb = JBatch.make(spots, strikes, 0.75, 0.03, 0.25, "put", 0.01, dtype=jnp.float64)
        tb = ContractBatch.make(spots, strikes, 0.75, 0.03, 0.25, "put", 0.01,
                                dtype=torch.float64)
        jbb, tbb = jb.broadcast(), tb.broadcast()
        assert tbb.shape == (3, 4) == tuple(jbb.shape)
        for k in FIELDS:
            np.testing.assert_array_equal(_np(getattr(tbb, k)), np.asarray(getattr(jbb, k)))
        np.testing.assert_allclose(_np(tb.intrinsic()), np.asarray(jb.intrinsic()), rtol=1e-14)
        np.testing.assert_allclose(_np(tb.discount()), np.asarray(jb.discount()), rtol=1e-14)
        np.testing.assert_allclose(_np(tb.forward()), np.asarray(jb.forward()), rtol=1e-14)
        paths = rng.uniform(50, 150, (3, 4, 5))
        np.testing.assert_allclose(_np(tbb.intrinsic(torch.as_tensor(paths))),
                                   np.asarray(jbb.intrinsic(jnp.asarray(paths))), rtol=1e-14)

    def test_structure_helpers(self):
        b = ContractBatch.make([90.0, 110.0], 100.0, 1.0, 0.05, 0.2, ["call", "put"])
        assert b.dtype == torch.float32 and b.device == torch.device("cpu")
        np.testing.assert_array_equal(_np(b.cp), [1.0, -1.0])
        assert b.astype(torch.float64).dtype == torch.float64
        assert float(b.replace(vol=0.3).vol) == pytest.approx(0.3)
        assert ContractBatch.single(100.0, 100.0, 1.0, 0.05, 0.2).size == 1

    def test_bad_option_type(self):
        with pytest.raises(ValidationError):
            ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "straddle")


class TestMath:
    def test_primitives_match_jax(self, rng):
        x = rng.normal(size=64) * 3
        p = rng.uniform(1e-6, 1 - 1e-6, 64)
        tx, tp = torch.as_tensor(x), torch.as_tensor(p)
        np.testing.assert_allclose(_np(tmath.norm_cdf(tx)), np.asarray(jmath.norm_cdf(x)),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(_np(tmath.norm_pdf(tx)), np.asarray(jmath.norm_pdf(x)),
                                   rtol=1e-13)
        np.testing.assert_allclose(_np(tmath.norm_ppf(tp)), np.asarray(jmath.norm_ppf(p)),
                                   rtol=1e-10)
        np.testing.assert_allclose(_np(tmath.smooth_max(tx, 0.5)),
                                   np.asarray(jmath.smooth_max(x, 0.5)), rtol=1e-13)
        np.testing.assert_allclose(_np(tmath.smooth_indicator(tx, 0.5)),
                                   np.asarray(jmath.smooth_indicator(x, 0.5)), rtol=1e-13)
        den = np.where(rng.uniform(size=64) < 0.3, 0.0, x)
        np.testing.assert_array_equal(_np(tmath.safe_div(tx, torch.as_tensor(den))),
                                      np.asarray(jmath.safe_div(x, den)))
        np.testing.assert_array_equal(_np(tmath.safe_sqrt(tx)), np.asarray(jmath.safe_sqrt(x)))

    def test_d1_d2_match_jax(self, rng):
        f = _book(rng)
        args = [f[k] for k in ("spot", "strike", "maturity", "rate", "vol", "dividend")]
        td = tmath.d1_d2(*map(torch.as_tensor, args))
        jd = jmath.d1_d2(*args)
        for t, j in zip(td, jd):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-12)


class TestBlackScholes:
    def test_golden_values(self):
        assert float(tbs.bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0)) == pytest.approx(
            10.4506, abs=1e-4)
        assert float(tbs.bs_price(100.0, 100.0, 1.0, 0.05, 0.2, -1.0)) == pytest.approx(
            5.5735, abs=1e-4)
        assert float(tbs.BlackScholesPricer().price(100.0, 100.0, 1.0, 0.05, 0.2, "put")) \
            == pytest.approx(5.5735, abs=1e-4)

    def test_greeks_match_jax_f64(self, rng):
        f = _book(rng, 32)
        f["maturity"][:3] = [0.0, -0.1, 1e-12]  # expired rows take the masks
        f["vol"][3] = 0.0  # deterministic row
        args = [f[k] for k in ("spot", "strike", "maturity", "rate", "vol", "cp", "dividend")]
        tg = tbs.bs_greeks(*map(torch.as_tensor, args))
        jg = jbs.bs_greeks(*map(jnp.asarray, args))
        for k in GREEKS:
            assert tg[k].dtype == torch.float64
            np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]), rtol=1e-10, atol=1e-10,
                                       err_msg=k)
        np.testing.assert_allclose(
            _np(tbs.bs_vega(*map(torch.as_tensor, args[:5]), torch.as_tensor(args[6]))),
            np.asarray(jbs.bs_vega(*args[:5], args[6])), rtol=1e-10, atol=1e-10)

    def test_greeks_ad_match_closed_form(self, rng):
        f = _book(rng, 16)
        args = [torch.as_tensor(f[k]) for k in
                ("spot", "strike", "maturity", "rate", "vol", "cp", "dividend")]
        ad = tbs.bs_greeks_ad(*args)
        cf = tbs.bs_greeks(*args)
        for k in ("delta", "gamma", "vega", "theta", "rho", "dual_delta"):
            np.testing.assert_allclose(_np(ad[k]), _np(cf[k]), rtol=1e-9, atol=1e-11,
                                       err_msg=k)

    def test_batch_protocol(self):
        b = ContractBatch.make([90.0, 100.0], 100.0, 1.0, 0.05, 0.2, ["call", "put"])
        np.testing.assert_allclose(_np(tbs.price(b)), _np(tbs.greeks(b)["price"]))
        np.testing.assert_allclose(_np(tbs.price(b))[1], 5.5735, atol=1e-3)


class TestUtils:
    @pytest.mark.parametrize("value", [0.0, -1.0, float("nan"), float("inf"), [1.0, -2.0]])
    def test_check_positive_rejects(self, value):
        from optionslab_tpu_torch.utils.validation import check_positive

        with pytest.raises(ValidationError):
            check_positive("spot", value)

    def test_checks_accept_and_match_reference(self):
        from optionslab_tpu.utils import validation as jval
        from optionslab_tpu_torch.utils import validation as tval

        tval.check_positive("spot", torch.tensor([1.0, 2.0]))
        tval.check_non_negative("rate", 0.0)
        with pytest.raises(ValidationError):
            tval.check_non_negative("rate", torch.tensor(-0.1))
        for t in ("call", "C", "put", "p", 1, -1):
            assert tval.check_option_type(t) == jval.check_option_type(t)

    def test_timer_registry(self):
        from optionslab_tpu_torch.utils.timing import Timer, get_timings, reset_timings

        reset_timings()
        with Timer("unit") as t:
            torch.ones(8).sum()
        assert t.ms >= 0.0 and get_timings()["unit"] == [t.ms]
        reset_timings()
        assert get_timings() == {}
