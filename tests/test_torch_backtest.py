"""The port's delta-hedge backtest (``optionslab_tpu_torch.backtest``)
against ``optionslab_tpu.backtest`` on the CPU.

The reference scans the days in float32; the port evaluates the same
carry in closed form over the whole series in float64 (one batched
``bs_greeks``, the hedge as the delta of the last rebalance day, the cash
recurrence as a cumulative sum). On the same seeded series the daily P&L
agrees to 1e-4, the cumulative P&L and the statistics built on it to 2e-3
(the reference's float32 accumulation over 252 steps: ≈6e-4 measured), the
premium and the settlement to 1e-5, the rebalance count exactly.
"""

import numpy as np
import pytest
import torch

from optionslab_tpu.backtest import BacktestEngine as JEngine
from optionslab_tpu.backtest import realized_vol as j_realized_vol
from optionslab_tpu.backtest import realized_vs_implied as j_rvi
from optionslab_tpu_torch.backtest import (
    BacktestEngine,
    BacktestResult,
    realized_vol,
    realized_vs_implied,
    run_delta_hedge_backtest,
)
from optionslab_tpu_torch.data import ColumnTable
from optionslab_tpu_torch.utils.exceptions import DataError, ValidationError

CPU = "cpu"
DAILY_ATOL, CUM_ATOL, PREMIUM_ATOL = 1e-4, 2e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gbm_series(sigma=0.2, n=253, seed=0, mu=0.05):
    """tests/test_data_backtest.py's series, rounded to float32 (the
    reference's input dtype) so both engines see the same prices."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / 252.0
    z = rng.standard_normal(n - 1)
    log_p = np.cumsum((mu - sigma**2 / 2) * dt + sigma * np.sqrt(dt) * z)
    return (100.0 * np.exp(np.concatenate([[0.0], log_p]))).astype(np.float32).astype(np.float64)


# ---------------------------------------------------------------------------
# the reference's oracles (tests/test_data_backtest.py:141-185)
# ---------------------------------------------------------------------------
def test_hedged_pnl_small_when_vol_correct():
    prices = gbm_series(sigma=0.2, seed=3)
    res = BacktestEngine(rate=0.05, device=CPU).run_delta_hedge(
        prices, strike=100.0, maturity=1.0, sigma=0.2)
    assert abs(res.total_pnl) < 0.6 * res.option_premium
    assert res.daily_pnl.shape == (252,)
    assert res.n_rebalances == 252


@pytest.mark.parametrize("sigma,hedge_sigma,seed,wins", [(0.4, 0.2, 5, False),
                                                          (0.1, 0.35, 7, True)])
def test_selling_mispriced_vol(sigma, hedge_sigma, seed, wins):
    prices = gbm_series(sigma=sigma, seed=seed)
    res = BacktestEngine(rate=0.05, device=CPU).run_delta_hedge(
        prices, strike=100.0, maturity=1.0, sigma=hedge_sigma)
    assert (res.total_pnl > 0) == wins


def test_weekly_rebalance_and_stats():
    res = run_delta_hedge_backtest(gbm_series(seed=11), strike=100.0, maturity=1.0, sigma=0.2,
                                   rebalance_every=5, device=CPU)
    assert res.n_rebalances == int(np.ceil(252 / 5))
    assert 0.0 <= res.win_rate <= 1.0
    assert res.max_drawdown >= 0.0


def test_bad_series_raises():
    with pytest.raises(DataError):
        BacktestEngine(device=CPU).run_delta_hedge(np.array([100.0, -5.0] * 10))
    with pytest.raises(DataError):
        BacktestEngine(device=CPU).run_delta_hedge(np.array([100.0]))
    with pytest.raises(ValidationError):
        BacktestEngine(device=CPU).run_delta_hedge(gbm_series(), maturity=-1.0)


def test_realized_vol_recovers_truth_and_matches_the_reference():
    prices = gbm_series(sigma=0.3, n=2000, seed=17)
    rv = realized_vol(prices, window=252)
    assert abs(np.nanmean(rv[500:]) - 0.3) < 0.05
    for window in (5, 20, 252, 4000):
        np.testing.assert_allclose(realized_vol(prices, window), j_realized_vol(prices, window),
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# the port's run against the reference's on the same series
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("option_type", ["call", "put"])
@pytest.mark.parametrize("rebalance_every,tx_cost", [(1, 0.0), (5, 0.0), (1, 0.001),
                                                     (5, 0.002)])
def test_run_delta_hedge_matches_the_reference(rebalance_every, tx_cost, option_type):
    prices = gbm_series(sigma=0.25, seed=21)
    kw = dict(strike=102.0, maturity=1.0, sigma=0.2, option_type=option_type,
              rebalance_every=rebalance_every)
    ref = JEngine(rate=0.03, tx_cost=tx_cost).run_delta_hedge(prices, **kw)
    got = BacktestEngine(rate=0.03, tx_cost=tx_cost, device=CPU).run_delta_hedge(prices, **kw)
    assert isinstance(got, BacktestResult)
    np.testing.assert_allclose(got.daily_pnl, ref.daily_pnl, atol=DAILY_ATOL)
    np.testing.assert_allclose(got.cumulative_pnl, ref.cumulative_pnl, atol=CUM_ATOL)
    assert got.option_premium == pytest.approx(ref.option_premium, abs=PREMIUM_ATOL)
    assert got.final_settlement == pytest.approx(ref.final_settlement, abs=PREMIUM_ATOL)
    assert got.n_rebalances == ref.n_rebalances
    summary, ref_summary = got.summary(), ref.summary()
    assert summary.keys() == ref_summary.keys()
    for key in ("total_pnl", "sharpe", "max_drawdown"):
        assert summary[key] == pytest.approx(ref_summary[key], abs=CUM_ATOL), key


def test_defaults_follow_the_series():
    """No strike, maturity or sigma: the first price, the series' length in
    trading years and the mean realized vol, as the reference's."""
    prices = gbm_series(seed=2, n=130)
    ref = JEngine().run_delta_hedge(prices)
    got = BacktestEngine(device=CPU).run_delta_hedge(torch.as_tensor(prices))
    np.testing.assert_allclose(got.daily_pnl, ref.daily_pnl, atol=DAILY_ATOL)
    assert got.option_premium == pytest.approx(ref.option_premium, abs=PREMIUM_ATOL)


def test_sweep_matches_the_reference_vmap():
    prices = gbm_series(seed=13, n=60)
    kw = dict(strikes=[95.0, 100.0, 105.0], sigmas=[0.15, 0.25], maturity=60 / 252.0)
    ref = JEngine(rate=0.03).run_delta_hedge_sweep(prices, **kw)
    got = BacktestEngine(rate=0.03, device=CPU).run_delta_hedge_sweep(prices, **kw)
    assert got.shape == ref.shape == (3, 2)
    np.testing.assert_allclose(got, ref, atol=CUM_ATOL)
    # each cell is the single run's total P&L
    one = BacktestEngine(rate=0.03, device=CPU).run_delta_hedge(
        prices, strike=100.0, maturity=60 / 252.0, sigma=0.25)
    assert got[1, 1] == pytest.approx(one.total_pnl, abs=1e-9)


def test_no_loop_over_days():
    """The same number of torch operations for 253 and 1,009 prices: the
    engine's work is a fixed chain of whole-series ops."""
    counts = []
    for n in (253, 1009):
        prices = gbm_series(seed=4, n=n)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            BacktestEngine(device=CPU).run_delta_hedge(prices, strike=100.0, maturity=1.0,
                                                      sigma=0.2)
        counts.append(sum(e.count for e in prof.key_averages() if e.key.startswith("aten::")))
    assert counts[0] == counts[1]


@pytest.mark.parametrize("sweep", [False, True])
def test_smoke_script_counts_the_same_ops_at_its_two_lengths(sweep):
    """``chip_smoke.aten_ops``, the exact count its command-line phase holds
    equal at ``CLI_BACKTEST_LENGTHS`` prices, is equal there for the single
    backtest and the strike × sigma sweep, and nonzero."""
    import chip_smoke as cs

    eng, counts = BacktestEngine(device=CPU), []
    for n in cs.CLI_BACKTEST_LENGTHS:
        prices = gbm_series(seed=5, n=n)
        if sweep:
            counts.append(cs.aten_ops(lambda p=prices: eng.run_delta_hedge_sweep(
                p, [95.0, 100.0, 105.0], [0.15, 0.25], 1.0)))
        else:
            counts.append(cs.aten_ops(lambda p=prices: eng.run_delta_hedge(
                p, strike=100.0, maturity=1.0, sigma=0.2)))
    assert counts[0] == counts[1] > 0


@pytest.mark.parametrize("hide_pandas", [False, True])
def test_realized_vs_implied_with_and_without_pandas(hide_pandas, monkeypatch):
    prices = gbm_series(seed=9)
    ref = j_rvi(prices, 0.22)
    if hide_pandas:
        import sys

        monkeypatch.setitem(sys.modules, "pandas", None)
    got = realized_vs_implied(prices, 0.22)
    if hide_pandas:
        assert isinstance(got, ColumnTable)
    else:
        assert type(got).__name__ == "DataFrame"
    assert list(got.columns) == list(ref.columns)
    for col in ref.columns:
        np.testing.assert_allclose(np.asarray(got[col], np.float64),
                                   ref[col].to_numpy(np.float64), rtol=1e-12)
