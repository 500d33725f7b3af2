"""The port's market-risk tools (``optionslab_tpu_torch/risk``: VaR/ES,
component VaR/ES, stress, sensitivity, the options portfolio) against
``optionslab_tpu.risk`` on the same inputs, on the CPU.

Everything deterministic matches to float64 rounding (1e-12 relative, the
quantile-free closed forms to 1e-12, the portfolio's Greeks to 1e-10);
the Monte Carlo VaR draws from a ``torch.Generator`` and is held to its
closed form within the reference test's bounds.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import norm

from optionslab_tpu import risk as jr
from optionslab_tpu.models.black_scholes import bs_price as j_bs
from optionslab_tpu_torch import risk as tr
from optionslab_tpu_torch.models.black_scholes import bs_greeks, bs_price
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(12)
PNL = RNG.standard_t(4, 20_001) * 1.3 + 0.1
COMP = RNG.normal(0.0, 1.0, (4_000, 3)) * [1.0, 2.0, 0.5] + [0.0, 0.1, -0.05]
COV = np.array([[0.04, 0.01, 0.0], [0.01, 0.09, -0.02], [0.0, -0.02, 0.0625]]) / 252.0


def _num(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(port, ref, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(_num(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("conf", [0.95, 0.99, 0.975])
def test_historical_and_parametric_match_reference(conf):
    pnl = torch.tensor(PNL)
    _eq(tr.historical_var(pnl, conf), jr.historical_var(PNL, conf))
    _eq(tr.historical_es(pnl, conf), jr.historical_es(PNL, conf))
    mu, sig = torch.tensor(0.02, dtype=torch.float64), torch.tensor(1.5, dtype=torch.float64)
    _eq(tr.parametric_var(mu, sig, conf, 10.0), jr.parametric_var(0.02, 1.5, conf, 10.0), 1e-9)
    _eq(tr.parametric_es(mu, sig, conf, 10.0), jr.parametric_es(0.02, 1.5, conf, 10.0), 1e-9)
    _eq(tr.lognormal_var(torch.tensor(1e6, dtype=torch.float64), mu, sig / 10, conf, 0.5),
        jr.lognormal_var(1e6, 0.02, 0.15, conf, 0.5), 1e-9)
    _eq(tr.delta_normal_var(torch.tensor([1e6, -5e5, 2e5]), torch.tensor(COV), conf, 10.0),
        jr.delta_normal_var(np.array([1e6, -5e5, 2e5]), COV, conf, 10.0), 1e-9)
    _eq(tr.stressed_var(torch.tensor(3.0, dtype=torch.float64), 0.25), 3.75)


@pytest.mark.parametrize("window", [0, 1, 7, 400])
def test_component_var_and_es_match_reference(window):
    x = torch.tensor(COMP)
    got, ref = tr.component_var(x, 0.99, window), jr.component_var(COMP, 0.99, window)
    assert set(got) == set(ref)
    for k in ref:
        _eq(got[k], ref[k])
    _eq(got["components"].sum(), got["total_var"])
    got, ref = tr.component_es(x, 0.975), jr.component_es(COMP, 0.975)
    for k in ref:
        _eq(got[k], ref[k])


def test_monte_carlo_var_against_closed_forms():
    """tests/test_risk.py: the GBM Monte Carlo VaR within 0.5 of the
    lognormal closed form at 400,000 paths; the option VaR of one long call
    within (0, 10); ES beyond VaR."""
    a = tr.VaRAnalyzer(confidence=0.95, horizon=1.0, seed=1, device="cpu")
    mc = a.monte_carlo(100.0, 0.05, 0.2, n_paths=400_000)
    assert abs(mc - a.parametric_lognormal(100.0, 0.05, 0.2)) < 0.5
    assert a.monte_carlo(100.0, 0.05, 0.2, n_paths=1000) == a.monte_carlo(100.0, 0.05, 0.2,
                                                                           n_paths=1000)
    b = tr.VaRAnalyzer(confidence=0.99, seed=2, device="cpu")
    var = b.option_portfolio(lambda s: bs_price(s, 100.0, 0.5, 0.03, 0.25, 1.0, 0.0), 100.0,
                             0.05, 0.25, n_paths=100_000)
    assert 0.0 < var < 10.0
    es = tr.ExpectedShortfall.monte_carlo(torch.tensor(100.0), 0.05, 0.2, n_paths=200_000)
    assert es > mc
    gen = torch.Generator().manual_seed(3)
    v, e = tr.monte_carlo_var(torch.tensor(1.0, dtype=torch.float64), 0.0, 0.2, gen, 0.99,
                              n_paths=200_000, return_es=True)
    exact = 1.0 - np.exp(-0.02 + 0.2 * norm.ppf(0.01))
    assert v.dtype == torch.float64 and abs(float(v) - exact) < 0.01 and float(e) > float(v)
    assert tr.VaRAnalyzer(device="cpu").stress_table(10.0, [0.0, 0.5, 1.0]) == \
        jr.VaRAnalyzer().stress_table(10.0, [0.0, 0.5, 1.0])
    for bad in (lambda: tr.historical_var(torch.zeros(10), 0.3),
                lambda: tr.VaRAnalyzer(confidence=1.5),
                lambda: tr.component_var(torch.zeros(10)),
                lambda: tr.delta_normal_var(torch.ones(2), torch.eye(3))):
        with pytest.raises(ValidationError):
            bad()


def _market():
    return pd.DataFrame({
        "underlying_price": [95.0, 100.0, 105.0, 100.0, 110.0, 90.0],
        "strike": [100.0, 100.0, 100.0, 110.0, 100.0, 95.0],
        "maturity": [0.5, 1.0, 0.25, 1.0, 2.0, 0.75],
        "historical_volatility": [0.2, 0.25, 0.3, 0.2, 0.15, 0.4],
    })


def _price_np(df):
    return np.asarray(j_bs(df["underlying_price"].to_numpy(), df["strike"].to_numpy(),
                           df["maturity"].to_numpy(), 0.03,
                           df["historical_volatility"].to_numpy(), 1.0, 0.0))


def _price_torch(df):
    col = {k: torch.tensor(np.asarray(df[k]), dtype=torch.float64) for k in df.columns}
    return bs_price(col["underlying_price"], col["strike"], col["maturity"], 0.03,
                    col["historical_volatility"], 1.0, 0.0)


class _Frame(dict):
    """A frame-like object without pandas: columns, copy, item get/set."""

    @property
    def columns(self):
        return list(self)

    def copy(self):
        return _Frame(self)


SCENARIOS = [("crash", "underlying_price", -0.2, True), ("vol_up", "historical_volatility",
                                                          0.1, False),
             ("rally", "underlying_price", 0.1, True)]


def test_stress_and_sensitivity_match_reference():
    df = _market()
    port = tr.StressTester(_price_torch).run_scenarios(
        df, [tr.StressScenario(*s) for s in SCENARIOS])
    ref = jr.StressTester(_price_np).run_scenarios(df, [jr.StressScenario(*s) for s in SCENARIOS])
    pd.testing.assert_frame_equal(port, ref, rtol=1e-12)
    frame = _Frame({k: df[k].to_numpy() for k in df.columns})
    rows = tr.StressTester(_price_torch).run_scenarios(
        frame, [tr.StressScenario(*s) for s in SCENARIOS])
    pd.testing.assert_frame_equal(pd.DataFrame(rows) if isinstance(rows, list) else rows, ref,
                                  rtol=1e-12)
    with pytest.raises(ValidationError):
        tr.StressScenario("x", "nope", 0.1).apply(frame)
    got = tr.SensitivityAnalysis(_price_torch).compute_all(frame)
    ref = jr.SensitivityAnalysis(_price_np).compute_all(df)
    for k in ref:
        _eq(got[k], ref[k], 1e-9, 1e-9)
    _eq(tr.SensitivityAnalysis(_price_torch).compute_delta(df, 0.5, relative=False),
        jr.SensitivityAnalysis(_price_np).compute_delta(df, 0.5, relative=False), 1e-9, 1e-9)


def _book(pkg, custom: bool):
    pf = pkg.OptionsPortfolio(device="cpu", dtype=torch.float64) if pkg is tr \
        else pkg.OptionsPortfolio()
    legs = [(10.0, 100.0, 100.0, 1.0, 0.05, 0.2, "call", 0.0, "A"),
            (-5.0, 100.0, 110.0, 0.5, 0.05, 0.25, "put", 0.01, "A"),
            (3.0, 50.0, 45.0, 2.0, 0.03, 0.35, "call", 0.02, "B"),
            (-2.0, 50.0, 55.0, 0.2, 0.03, 0.3, "put", 0.0, "B")]
    for leg in legs:
        pf.add_position(pkg.Position(*leg))
    if custom:
        fn = (lambda s, k, t, r, sig, q: bs_price(s, k, t, r, sig, -1.0, q)) if pkg is tr else \
            (lambda s, k, t, r, sig, q: j_bs(s, k, t, r, sig, -1.0, q))
        pf.add_position(pkg.Position(4.0, 50.0, 50.0, 1.5, 0.03, 0.3, "put", 0.0, "B",
                                     price_fn=fn))
    return pf


def test_portfolio_matches_reference_and_sums_bs_greeks():
    port, ref = _book(tr, True), _book(jr, True)
    # the reference's Greeks once, jitted (eager, its jacfwd takes seconds),
    # for every method that reads them
    gr = jax.jit(ref.position_greeks)()
    ref.position_greeks = lambda: gr
    g = port.position_greeks()
    assert set(g) == set(gr)
    for k in gr:
        _eq(g[k], np.asarray(gr[k], np.float64), 1e-10, 1e-12)
    agg, agg_r = port.aggregate_greeks(), ref.aggregate_greeks()
    for k in agg_r:
        assert agg[k] == pytest.approx(agg_r[k], rel=1e-10, abs=1e-12), k
    # the book's Greeks are the quantity-weighted sums of the closed forms
    p = port.positions
    cf = bs_greeks(*(torch.tensor([getattr(x, f) for x in p], dtype=torch.float64)
                     for f in ("spot", "strike", "maturity", "rate", "vol")),
                   torch.tensor([x.cp() for x in p], dtype=torch.float64),
                   torch.tensor([x.dividend for x in p], dtype=torch.float64))
    qty = np.array([x.quantity for x in p])
    for k in ("price", "delta", "gamma", "vega", "theta", "rho", "vanna", "vomma", "charm"):
        assert agg[k] == pytest.approx(float((qty * cf[k].numpy()).sum()), rel=1e-9), k
    assert port.delta_hedge_ratio() == pytest.approx(ref.delta_hedge_ratio(), rel=1e-10)
    assert port.vega_buckets() == pytest.approx(ref.vega_buckets(), rel=1e-10)
    by, by_r = port.greeks_by_underlying(), ref.greeks_by_underlying()
    for k in by_r:
        assert by[k] == pytest.approx(by_r[k], rel=1e-10, abs=1e-12), k
    pd.testing.assert_frame_equal(port.position_report(), ref.position_report(), rtol=1e-10)
    shifts = ([-0.2, 0.0, 0.1], [-0.3, 0.0, 0.5])
    plain = _book(tr, False)
    _eq(plain.scenario_pnl(*shifts), _book(jr, False).scenario_pnl(*shifts), 1e-10, 1e-10)
    with pytest.raises(ValidationError):
        tr.OptionsPortfolio(device="cpu").position_greeks()
    with pytest.raises(ValidationError):
        port.add_position(tr.Position(1.0, 100.0, 100.0, -1.0, 0.05, 0.2))
