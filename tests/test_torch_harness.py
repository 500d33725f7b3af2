"""The port's vol-surface benchmark harness (``optionslab_tpu_torch.
benchmarks``) against ``optionslab_tpu.benchmarks`` on the CPU.

The EPP is the same function of the same butterfly check: to 1e-9 in
float64. The harness fits on the reference test's smile (21 strikes,
noise 2e-3, seed 3) with one trial: each model's error metrics within
0.5% of the reference's (float32 Adam and ridge solves; 0.06% measured)
plus 0.05 bps, its arbitrage-free share and EPP equal to 0.5 points.
"""

import json
import sys

import numpy as np
import pytest
import torch

from optionslab_tpu.benchmarks import VolSurfaceBenchmark as JBench
from optionslab_tpu.benchmarks import compute_epp as j_epp
from optionslab_tpu.benchmarks import surface_epp as j_surface_epp
from optionslab_tpu.data.synthetic import generate_synthetic_smile, generate_synthetic_surface
from optionslab_tpu.data.synthetic import synthetic_iv
from optionslab_tpu_torch.benchmarks import (
    BenchmarkEntry,
    ErrorMetrics,
    VolSurfaceBenchmark,
    compute_epp,
    surface_epp,
)
from optionslab_tpu_torch.data import ColumnTable

CPU = "cpu"
METRICS = ("rmse_bps", "mae_bps", "atm_rmse_bps", "wing_rmse_bps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smile():
    return generate_synthetic_smile(n_strikes=21, maturity=0.5, noise=0.002, seed=3)


def _records(bench):
    return json.loads(bench.to_dataframe().to_json(orient="records"))


@pytest.mark.parametrize("w_fn", [lambda k: 0.04 + 0.02 * k**2,
                                  lambda k: 0.04 + 2.5 * np.abs(k),
                                  lambda k: 0.04 + 0.3 * k + 0.5 * k**2 - 2.0 * k**4],
                         ids=["clean", "lee-violating", "quartic"])
def test_compute_epp_matches_the_reference(w_fn):
    k = np.linspace(-0.4, 0.4, 41)
    w = w_fn(k)
    assert compute_epp(k, w, 0.5, device=CPU) == pytest.approx(j_epp(k, w, 0.5), rel=1e-9,
                                                               abs=1e-12)


def test_epp_oracles_and_surface_epp():
    k = np.linspace(-0.4, 0.4, 41)
    assert compute_epp(k, 0.04 + 0.02 * k**2, 0.5, device=CPU) == 0.0
    assert compute_epp(k, 0.04 + 2.5 * np.abs(k), 0.5, device=CPU) > 0.0
    ks, t, iv = generate_synthetic_surface(21, 4)
    got = surface_epp(ks, t, iv, device=CPU)
    assert got >= 0.0 and got == pytest.approx(j_surface_epp(ks, t, iv), rel=1e-9, abs=1e-12)


def test_error_metrics_match_the_reference():
    from optionslab_tpu.benchmarks import ErrorMetrics as JMetrics

    rng = np.random.default_rng(0)
    k = np.linspace(-0.4, 0.4, 30)
    t = np.repeat([0.25, 0.5, 1.0], 10)
    truth = 0.2 + 0.1 * k**2
    pred = truth + rng.normal(0, 0.003, 30)
    got, ref = ErrorMetrics.from_predictions(k, t, pred, truth), JMetrics.from_predictions(
        k, t, pred, truth)
    for name in ("rmse", "mae", "mape", "max_error", "atm_rmse", "wing_rmse", "term_rmse"):
        assert getattr(got, name) == pytest.approx(getattr(ref, name), rel=1e-12), name


@pytest.mark.parametrize("model", ["svi", "sabr", "ssvi", "kernel_ridge"])
def test_harness_matches_the_reference(smile, model):
    k, vols = smile
    ref = _records(JBench(models=[model]).run(k, vols, 0.5, n_trials=1))[0]
    bench = VolSurfaceBenchmark(models=[model], device=CPU).run(k, vols, 0.5, n_trials=1)
    got = bench.records()[0]
    assert isinstance(bench.entries[0], BenchmarkEntry)
    assert set(got) == set(ref) and got["model"] == model
    for key in METRICS:
        assert got[key] == pytest.approx(ref[key], rel=5e-3, abs=0.05), key
    assert got["arb_free_pct"] == pytest.approx(ref["arb_free_pct"], abs=0.5)
    assert got["epp_bps"] == pytest.approx(ref["epp_bps"], abs=0.5)
    assert got["convergence_pct"] == ref["convergence_pct"] == 100.0
    assert got["calibration_ms"] > 0 and got["prediction_ms"] > 0


def test_best_model_truth_fn_and_the_table(smile):
    """tests/test_benchmark_harness.py:45: the best model and SVI nearly
    arbitrage-free against a noiseless truth; the table as a DataFrame."""
    k, vols = smile
    bench = VolSurfaceBenchmark(models=["svi", "random_forest"], device=CPU)
    bench.run(k, vols, maturity=0.5, n_trials=1, truth_fn=lambda kk: synthetic_iv(kk, 0.5))
    assert bench.best_model() in ("svi", "random_forest")
    df = bench.to_dataframe()
    assert list(df.model) == ["svi", "random_forest"]
    assert float(df[df.model == "svi"].arb_free_pct.iloc[0]) > 95.0
    ranked = sorted(bench.records(), key=lambda r: r["epp_bps"])
    assert bench.best_model("epp_bps") == ranked[0]["model"]


def test_unknown_model_raises():
    with pytest.raises(ValueError):
        VolSurfaceBenchmark(models=["lstm"], device=CPU)
    with pytest.raises(ValueError, match="no successful"):
        VolSurfaceBenchmark(models=["svi"], device=CPU).best_model()


def test_stability_cv_present_for_parametric(smile):
    k, vols = smile
    bench = VolSurfaceBenchmark(models=["svi"], device=CPU).run(k, vols, 0.5, n_trials=3)
    entry = bench.entries[0]
    assert entry.stability.param_cv >= 0.0 and entry.stability.convergence_pct == 100.0
    assert entry.speed.calibration_warm_ms <= entry.speed.calibration_ms


def test_a_failed_fit_counts_against_convergence(smile):
    """A trial whose fit raises one of the port's errors is not converged;
    the model without any converged trial has no row."""
    from optionslab_tpu_torch.utils.exceptions import CalibrationError

    class Flaky:
        name = "flaky"

        def calibrate(self, k, vols, t, seed=0):
            if seed == 0:
                raise CalibrationError("diverged")
            self.level = float(np.mean(vols))

        def predict(self, k, t=None):
            return np.full(np.shape(k), self.level)

        def get_params(self):
            return np.asarray([self.level])

    class Broken(Flaky):
        def calibrate(self, k, vols, t, seed=0):
            raise CalibrationError("never")

    k, vols = smile
    bench = VolSurfaceBenchmark(models=["flaky", "broken"],
                                wrappers={"flaky": Flaky, "broken": Broken},
                                device=CPU).run(k, vols, 0.5, n_trials=2)
    (row,) = bench.records()
    assert row["model"] == "flaky" and row["convergence_pct"] == 50.0


def test_the_table_without_pandas(smile, monkeypatch):
    k, vols = smile
    bench = VolSurfaceBenchmark(models=["ssvi"], device=CPU).run(k, vols, 0.5, n_trials=1)
    monkeypatch.setitem(sys.modules, "pandas", None)
    table = bench.to_dataframe()
    assert isinstance(table, ColumnTable) and list(table["model"]) == ["ssvi"]
    assert table["rmse_bps"][0] == pytest.approx(bench.records()[0]["rmse_bps"])
    assert bench.best_model() == "ssvi"
