"""The port's chain data layer (``optionslab_tpu_torch/data``: the column
table, the loader and vendor parsers, the synthetic chains, the market-data
client and ``calibrate_model_to_market``) against ``optionslab_tpu.data`` on
the CPU.

The vendor parses match the reference's pandas DataFrames column by column
exactly, and the backfilled implied vols (float64 on both sides) to 1e-9
relative; the synthetic chain for a seed is the reference's, its prices
Black–Scholes in float64 to 1e-12. With ``pandas`` masked in
``sys.modules`` (the card's machine has none) the CBOE parse and the filters
still run and ``.df`` is the column table.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

from optionslab_tpu.data import loader as jload
from optionslab_tpu.data import market as jmarket
from optionslab_tpu.data import synthetic as jsyn
from optionslab_tpu_torch.data import (ColumnTable, MarketDataClient, OptionChainDataset,
                                       OptionChainLoader, RateLimiter, TTLCache,
                                       calibrate_model_to_market, load_option_data,
                                       retry_with_backoff, standardize_columns)
from optionslab_tpu_torch.data import synthetic as tsyn
from optionslab_tpu_torch.utils.exceptions import DataError, DependencyError

CBOE = "tests/data/cboe_spx_quotedata.csv"
OM = "tests/data/optionmetrics_opprcd_sample.csv"
SPOT, RATE = 5123.41, 0.043


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_pandas(monkeypatch):
    """The card's machine: ``import pandas`` fails."""
    monkeypatch.setitem(sys.modules, "pandas", None)


def _same_frame(port, ref, float_rtol=0.0, float_atol=0.0):
    """Column by column: the same names in the same order, numbers equal
    (NaN where NaN), text equal as text."""
    assert list(port.columns) == list(ref.columns)
    for c in ref.columns:
        a, b = np.asarray(port[c]), ref[c].to_numpy()
        if b.dtype.kind in "iuf":
            assert a.dtype.kind in "iuf", c
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                       rtol=float_rtol, atol=float_atol, err_msg=c)
        else:
            assert np.array_equal(a.astype(str), b.astype(str)), c


def test_column_table_basics():
    t = ColumnTable({"a": [1.0, 2.0, 3.0], "b": np.array(["x", "y", "z"], dtype=object),
                     "c": 0.5})
    assert t.columns == ["a", "b", "c"] and len(t) == 3 and "a" in t
    assert np.array_equal(t["c"], [0.5, 0.5, 0.5])
    t["d"] = "call"
    assert list(t["d"]) == ["call"] * 3
    sub = t.take(np.array([True, False, True]))
    assert len(sub) == 2 and list(sub["b"]) == ["x", "z"]
    assert list(t.take([2, 0])["a"]) == [3.0, 1.0]
    assert t.drop(columns=["b"]).columns == ["a", "c", "d"]
    with pytest.raises(ValueError):
        t["e"] = [1.0, 2.0]
    copy = t.copy()
    copy["a"][0] = 9.0
    assert t["a"][0] == 1.0
    back = ColumnTable.from_frame(pd.DataFrame({"a": [1.0, 2.0]}))
    assert back.columns == ["a"] and len(back) == 2


def test_synthetic_data_match_reference():
    want = jsyn.generate_synthetic_chain(n_rows=300, seed=3)
    got = tsyn.generate_synthetic_chain(n_rows=300, seed=3, device="cpu")
    assert isinstance(got, pd.DataFrame)
    _same_frame(got.drop(columns=["option_price"]), want.drop(columns=["option_price"]))
    np.testing.assert_allclose(got["option_price"], want["option_price"], rtol=1e-12,
                               atol=1e-12)
    for a, b in zip(tsyn.generate_synthetic_smile(noise=0.01, seed=2),
                    jsyn.generate_synthetic_smile(noise=0.01, seed=2)):
        assert np.array_equal(a, b)
    for a, b in zip(tsyn.generate_synthetic_surface(noise=0.01, seed=2),
                    jsyn.generate_synthetic_surface(noise=0.01, seed=2)):
        assert np.array_equal(a, b)


def test_standardize_and_filters_match_reference():
    raw = pd.DataFrame({"Spot": [100.0] * 6, "Strike": [80.0, 90.0, 100.0, 110.0, 120.0, 150.0],
                        "TTM": [0.5, 1.0, 0.02, 2.5, 1.0, 1.0], "r": 0.03,
                        "Type": ["C", "p", "call", "Put", "x", "c"],
                        "bid": [20.0, 1.0, 5.0, 0.0, 1.0, 0.1],
                        "ask": [21.0, 1.2, 5.5, 0.2, 3.0, 0.3],
                        "Volume": [10, 0, 5, 3, 8, 1], "openInterest": [5, 9, 0, 2, 7, 1]})
    _same_frame(standardize_columns(raw), jload.standardize_columns(raw))
    got, want = OptionChainDataset(raw, device="cpu"), jload.OptionChainDataset(raw)
    for name, kw in (("filter_liquidity", dict(min_volume=2, min_open_interest=1,
                                               max_spread_pct=0.5)),
                     ("filter_moneyness", dict(lo=0.8, hi=1.2)),
                     ("filter_maturity", dict(min_ttm=0.05, max_ttm=2.0))):
        _same_frame(getattr(got, name)(**kw).df, getattr(want, name)(**kw).df)
    _same_frame(got.with_log_moneyness().df, want.with_log_moneyness().df)
    # the rolling mean of the skew feature in another order of sums
    _same_frame(got.to_model_input(), want.to_model_input(), float_atol=1e-15)
    with pytest.raises(DataError):
        OptionChainDataset({"strike_price": [1.0]}, device="cpu")


@pytest.fixture(scope="module")
def vendor():
    return (jload.load_option_data("cboe", path=CBOE, rate=RATE),
            load_option_data("cboe", path=CBOE, rate=RATE, device="cpu"),
            jload.load_option_data("optionmetrics", path=OM, spot=SPOT, rate=RATE),
            load_option_data("optionmetrics", path=OM, spot=SPOT, rate=RATE, device="cpu"))


def test_vendor_parses_match_reference(vendor):
    j_cboe, t_cboe, j_om, t_om = vendor
    _same_frame(t_cboe.df, j_cboe.df)
    _same_frame(t_om.df, j_om.df)
    assert (t_cboe.df["option_type"] == "call").sum() == 132
    assert t_cboe.df["time_to_maturity"].min() == pytest.approx(28 / 365.0, abs=1e-12)
    with pytest.raises(DataError):
        load_option_data("optionmetrics", path=OM, rate=RATE, device="cpu")


def test_backfilled_vols_match_reference(vendor):
    j_cboe, t_cboe, j_om, t_om = vendor
    for j, t in ((j_cboe, t_cboe), (j_om, t_om)):
        j_liq = j.filter_liquidity(max_spread_pct=0.5)
        t_liq = t.filter_liquidity(max_spread_pct=0.5)
        want = jload.OptionChainDataset(j_liq.df.drop(columns=["implied_volatility"])
                                        ).backfill_implied_vol().df
        got = OptionChainDataset(t_liq.df.drop(columns=["implied_volatility"]),
                                 device="cpu").backfill_implied_vol().df
        _same_frame(got.drop(columns=["implied_volatility"]),
                    want.drop(columns=["implied_volatility"]))
        np.testing.assert_allclose(got["implied_volatility"], want["implied_volatility"],
                                   rtol=1e-9)
        # the vendor's own column stays where it is present
        _same_frame(t_liq.backfill_implied_vol().df, j_liq.backfill_implied_vol().df)


def test_cboe_without_pandas(no_pandas):
    ch = OptionChainLoader.from_cboe(CBOE, rate=RATE, device="cpu")
    assert isinstance(ch.df, ColumnTable) and len(ch) == 264
    liquid = ch.filter_liquidity(max_spread_pct=0.5).filter_moneyness(0.85, 1.2)
    assert 0 < len(liquid) < len(ch)
    assert np.all(np.asarray(liquid.df["bid"]) > 0)
    back = OptionChainDataset(liquid.table.drop(columns=["implied_volatility"]),
                              device="cpu").backfill_implied_vol()
    assert np.nanmedian(np.abs(back.df["implied_volatility"]
                               - liquid.df["implied_volatility"][:len(back)])) < 0.02
    with pytest.raises(DependencyError):
        OptionChainLoader.from_parquet("chain.parquet", device="cpu")
    assert isinstance(tsyn.generate_synthetic_chain(50, device="cpu"), ColumnTable)


def test_loader_errors_and_gates():
    with pytest.raises(DataError):
        load_option_data("bloomberg")
    with pytest.raises(DependencyError):
        OptionChainLoader.from_yfinance("SPY")
    with pytest.raises(DependencyError):
        MarketDataClient().get_quote("SPY")
    ds = load_option_data("synthetic", n_rows=40, seed=1, device="cpu")
    assert len(ds) == 40 and ds.device == torch.device("cpu")


def test_cache_rate_limit_and_retry():
    now = [0.0]
    cache = TTLCache(ttl=10.0, clock=lambda: now[0])
    cache.put("k", 1)
    assert cache.get("k") == 1 and len(cache) == 1
    now[0] = 11.0
    assert cache.get("k") is None
    slept = []
    rl = RateLimiter(0.5, clock=lambda: now[0], sleep=lambda s: slept.append(s))
    rl.wait()
    rl.wait()
    assert slept and abs(slept[0] - 0.5) < 1e-9
    calls = {"n": 0}

    @retry_with_backoff(retries=3, base_delay=0.0, sleep=lambda s: None)
    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("boom")
        return 42

    assert flaky() == 42 and flaky.failure_count == 2

    @retry_with_backoff(retries=2, base_delay=0.0, sleep=lambda s: None)
    def always_fails():
        raise RuntimeError("nope")

    with pytest.raises(DataError):
        always_fails()
    client = MarketDataClient(ttl=100.0, min_interval=0.0)
    assert client.fetch("x", lambda: 7) == 7 and client.fetch("x", lambda: 8) == 7


def _quadratic(x):
    target = torch.tensor([0.3, -0.2, 1.5], dtype=x.dtype, device=x.device)
    return torch.sum((x - target) ** 2) + 0.1 * torch.sum(torch.sin(3.0 * x))


def test_calibrate_model_to_market_returns_the_iterate_it_scores():
    """The reported loss is the objective at the returned point, inside the
    box; the reference pairs the point after a step's update with the loss
    before it (ROADMAP Queue 3)."""
    import jax.numpy as jnp

    bounds = ([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0])
    x, best = calibrate_model_to_market(_quadratic, [0.9, 0.9, -0.9], bounds, n_steps=60,
                                        device="cpu")
    assert best == float(_quadratic(torch.tensor(x)))
    assert np.all(x >= -1.0) and np.all(x <= 1.0)

    def j_obj(v):
        target = jnp.asarray([0.3, -0.2, 1.5], v.dtype)
        return jnp.sum((v - target) ** 2) + 0.1 * jnp.sum(jnp.sin(3.0 * v))

    jx, jbest = jmarket.calibrate_model_to_market(j_obj, [0.9, 0.9, -0.9], bounds,
                                                  n_steps=60)
    # the same Adam path: the port's best iterate is one step behind the
    # reference's, and scores no worse than the reference's own claim
    assert best == pytest.approx(jbest, rel=1e-5)
    assert float(j_obj(jnp.asarray(jx))) != pytest.approx(jbest, rel=1e-9)
    free, _ = calibrate_model_to_market(_quadratic, np.zeros(3), n_steps=200,
                                        learning_rate=0.05, device="cpu")
    assert np.all(np.isfinite(free))
