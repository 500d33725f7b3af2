"""The port's pricing validation (``optionslab_tpu_torch/models/validation.py``)
against ``optionslab_tpu.models.validation`` on the CPU: the parity, bounds,
Greek and butterfly checks give the reference's verdicts and errors (float64
to 1e-12); the Monte Carlo convergence study, whose generators differ, meets
the reference's own slope oracle; the pricer audit passes Black–Scholes and
fails a broken pricer."""

import numpy as np
import pytest
import torch

from optionslab_tpu.models import validation as jv
from optionslab_tpu_torch.models import validation as tv
from optionslab_tpu_torch.models.black_scholes import bs_greeks, bs_price

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(5)
S, K = RNG.uniform(80, 120, 16), RNG.uniform(80, 120, 16)
T, R, V = RNG.uniform(0.1, 2.0, 16), RNG.uniform(0.0, 0.06, 16), RNG.uniform(0.1, 0.4, 16)


def _prices(cp):
    return bs_price(*(torch.tensor(x) for x in (S, K, T, R, V)), cp, 0.0).numpy()


def test_checks_match_reference():
    c, p = _prices(1.0), _prices(-1.0)
    p_bad = p.copy()
    p_bad[3] += 0.1
    for puts in (p, p_bad):
        got = tv.check_put_call_parity(c, puts, S, K, T, R, device=CPU)
        want = jv.check_put_call_parity(c, puts, S, K, T, R)
        assert got["passed"] == want["passed"]
        assert got["max_error"] == pytest.approx(want["max_error"], rel=1e-12, abs=1e-14)
        np.testing.assert_allclose(got["errors"], want["errors"], rtol=1e-12, atol=1e-14)
    c_bad = c.copy()
    c_bad[[1, 7]] = [-1.0, 1e4]
    for calls in (c, c_bad):
        got = tv.check_price_bounds(calls, S, K, T, R, 1.0, device=CPU)
        want = jv.check_price_bounds(calls, S, K, T, R, 1.0)
        assert got["passed"] == want["passed"]
        assert np.array_equal(got["violations"], np.asarray(want["violations"]))
    g = {k: v.numpy() for k, v in bs_greeks(*(torch.tensor(x) for x in (S, K, T, R, V)),
                                            1.0, 0.0).items()}
    assert tv.check_greeks_consistency(g, 1.0) == jv.check_greeks_consistency(g, 1.0)
    g["gamma"] = -g["gamma"]
    assert tv.check_greeks_consistency(g, 1.0) == jv.check_greeks_consistency(g, 1.0)
    k = np.linspace(-0.5, 0.5, 21)
    w = (0.2 - 0.1 * k + 0.1 * k * k) ** 2
    w[10] += 0.01
    got, want = tv.check_smile_butterfly(k, w, device=CPU), jv.check_smile_butterfly(k, w)
    assert got["passed"] == want["passed"] is False
    assert got["min_g"] == pytest.approx(want["min_g"], rel=1e-12)


def test_mc_convergence_study_meets_the_reference_oracle():
    out = tv.mc_convergence_study(device=CPU)
    assert out["converged"] and abs(out["stderr_slope"] + 0.5) < 0.15
    assert out["path_counts"] == [1_000, 4_000, 16_000, 64_000]
    exact = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0))
    assert all(e < 4.0 * s + 1e-6 for e, s in zip(out["abs_errors"], out["stderrs"]))
    assert exact == pytest.approx(10.450583572185565, rel=1e-6)


def test_validate_pricer():
    def price_fn(s, k, t, r, sig, cp, q):
        return bs_price(*(torch.tensor(x) for x in (s, k, t, r, sig)), cp, q)

    out = tv.validate_pricer(price_fn)
    assert out["passed"] and out["parity"]["max_error"] < 1e-9

    def broken(s, k, t, r, sig, cp, q):
        return price_fn(s, k, t, r, sig, cp, q) + (0.5 if cp > 0 else 0.0)

    assert not tv.validate_pricer(broken)["passed"]
