"""The port's command line (``optionslab_tpu_torch.cli``) against the JAX
package's (``optionslab_tpu.cli``) on the CPU: one case per subcommand
branch, the same argv (the port's with ``--device cpu`` in front), the same
JSON keys, and the values held to the reference's.

How each case's values are held:

- deterministic outputs (closed forms, PDEs, lattices, fits) within the
  case's stated tolerance;
- the kernel-backed branches, which draw the ``hash`` sampler on the CPU
  in both packages, per moment within rtol 2e-4 (float32 sums in another
  order);
- branches whose draws come from a PRNG key (a ``torch.Generator`` in the
  port) within 4 combined standard errors of the reference's;
- where the reference's kernel runs its ``prng`` sampler (stubbed in
  interpret mode on the CPU), the port's value against the closed form
  within 4 standard errors;
- the error exits.

The Monte Carlo sizes are cut (``--n-paths 1`` is one kernel block).
"""

import argparse
import contextlib
import io
import json
import math
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import optionslab_tpu.models as jmodels
import optionslab_tpu_torch.models as tmodels
from optionslab_tpu.cli import main as jmain
from optionslab_tpu_torch.cli import COMMANDS, main as tmain
from optionslab_tpu_torch.utils.exceptions import DependencyError, ModelError

ROOT = Path(__file__).resolve().parent.parent
BS_ATM_CALL = 10.450583572185565
HESTON_LEWIS = 10.394226  # heston_price at HestonParams.make()'s defaults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(fn, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return json.loads(buf.getvalue())


def run_both(argv, ref_f32: bool = True):
    """(reference's JSON, port's JSON) for one argv; the reference pinned to
    float32, its default outside the test session's x64."""
    ctx = jax.enable_x64(False) if ref_f32 else contextlib.nullcontext()
    with ctx:
        ref = _run(jmain, argv)
    return ref, _run(tmain, ["--device", "cpu", *argv])


def _leaves(x, prefix=""):
    """(path, number) of every numeric leaf of a JSON value."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield prefix, float(x)


def assert_close(ref, port, rtol=2e-4, atol=1e-5, skip=()):
    """Every numeric leaf of ``port`` within rtol/atol of ``ref``'s (keys
    in ``skip``, and timings, not compared); the strings equal."""
    r = dict(_leaves(ref))
    p = dict(_leaves(port))
    assert set(r) == set(p)
    for k, v in r.items():
        name = k.rsplit(".", 1)[-1]
        if name in skip or name.endswith("_ms") or name == "smiles_per_second":
            continue
        assert p[k] == pytest.approx(v, rel=rtol, abs=atol), k


def assert_within_se(ref, port, key="price", se="std_error", k=4.0):
    bound = k * math.hypot(ref[se], port[se])
    assert abs(port[key] - ref[key]) < bound, (key, port[key], ref[key], bound)


def same_keys(ref, port):
    assert set(port) == set(ref), (set(ref) ^ set(port))


# ---------------------------------------------------------------------------
# one case per branch: (argv, how the values are held)
# ---------------------------------------------------------------------------
def close(**kw):
    return lambda r, p: assert_close(r, p, **kw)


def mc(key="price", se="std_error", also=()):
    def check(r, p):
        assert_within_se(r, p, key, se)
        for name in also:
            assert p[name] == pytest.approx(r[name], rel=2e-4, abs=1e-5), name
    return check


def bracket(r, p):
    """A certified bracket: each bound within 4 combined stderr."""
    assert_within_se(r, p, "lower", "lower_se")
    assert_within_se(r, p, "upper", "upper_se")


def vs_oracle(oracle, key="price", se="std_error"):
    def check(r, p):
        del r  # the reference's kernel ran its prng sampler, stubbed in interpret mode
        assert abs(p[key] - oracle) < 4.0 * p[se], (p[key], oracle, p[se])
    return check


def bs_price(r, p):
    assert_close(r, p, rtol=1e-6)
    assert p["price"] == pytest.approx(BS_ATM_CALL, rel=1e-6)


def var(r, p):
    """The closed forms to 1e-5; the Monte Carlo VaR (other draws, 100,000
    paths) within 2%."""
    assert_close(r, p, rtol=1e-5, skip=("monte_carlo_var",))
    assert p["monte_carlo_var"] == pytest.approx(r["monte_carlo_var"], rel=0.02)


def bench_harness(r, p):
    """The fits' error, arbitrage and EPP metrics to 2e-3 (float32 Adam and
    ridge solves), the same best model."""
    assert_close(r, p, rtol=2e-3, atol=1e-3)
    assert p["best"] == r["best"]


K1 = ["--n-paths", "1"]  # one kernel block

CASES = [
    pytest.param(["price", "--model", "bs"], bs_price, id="price-bs"),
    pytest.param(["price", "--model", "binomial"], close(rtol=2e-5), id="price-binomial"),
    # the θ-scheme: the port's float32 loop against the reference's
    pytest.param(["price", "--model", "fdm"], close(rtol=1e-4), id="price-fdm"),
    pytest.param(["price", "--model", "heston"], close(rtol=1e-5), id="price-heston"),
    pytest.param(["price", "--model", "bates"], close(rtol=1e-5), id="price-bates"),
    pytest.param(["price", "--model", "vg"], close(rtol=1e-5), id="price-vg"),
    pytest.param(["price", "--model", "nig"], close(rtol=1e-5), id="price-nig"),
    pytest.param(["price", "--model", "merton"], close(rtol=1e-5), id="price-merton"),
    pytest.param(["greeks"], close(rtol=1e-5, atol=1e-6), id="greeks-bs"),
    pytest.param(["greeks", "--model", "heston", *K1, "--n-steps", "4"],
                 vs_oracle(HESTON_LEWIS), id="greeks-heston"),
    pytest.param(["greeks", "--model", "heston-qe", *K1, "--n-steps", "4"],
                 vs_oracle(HESTON_LEWIS), id="greeks-heston-qe"),
    pytest.param(["mc", "--n-paths", "20000"], mc(), id="mc-xla"),
    pytest.param(["mc", "--method", "qmc", "--n-paths", "20000"], mc(), id="mc-qmc"),
    pytest.param(["mc", "--method", "pallas", *K1], vs_oracle(BS_ATM_CALL), id="mc-pallas"),
    pytest.param(["iv", "--price", "10.4506"], close(rtol=1e-5), id="iv"),
    pytest.param(["exotic", "--cv", *K1, "--n-steps", "8"], close(), id="exotic-cv"),
    pytest.param(["exotic", "--kind", "range-accrual", *K1, "--n-steps", "8"], close(),
                 id="exotic-range-accrual"),
    pytest.param(["exotic", "--kind", "double-barrier", "--lower", "80", "--upper", "130",
                  "--rebate", "2", *K1, "--n-steps", "8"], close(), id="exotic-double-barrier"),
    pytest.param(["exotic", "--kind", "double-touch", "--touch", "one", *K1, "--n-steps", "8"],
                 close(), id="exotic-double-touch"),
    pytest.param(["exotic", "--kind", "one-touch", "--barrier", "125", "--pay", "hit", *K1,
                  "--n-steps", "8"], close(), id="exotic-one-touch-hit"),
    pytest.param(["exotic", "--kind", "no-touch", "--barrier", "125", *K1, "--n-steps", "8"],
                 close(), id="exotic-no-touch"),
    pytest.param(["exotic", "--kind", "barrier", "--barrier", "130", "--rebate", "5", *K1,
                  "--n-steps", "8"], close(), id="exotic-barrier-rebate"),
    pytest.param(["exotic", "--kind", "asian", "--n-paths", "4096"], mc(), id="exotic-asian"),
    pytest.param(["exotic", "--kind", "barrier", "--n-paths", "4096"], mc(), id="exotic-barrier"),
    pytest.param(["exotic", "--kind", "lookback", "--n-paths", "4096"], mc(),
                 id="exotic-lookback"),
    pytest.param(["exotic", "--kind", "american", "--n-paths", "4096"], mc(),
                 id="exotic-american"),
    pytest.param(["exotic", "--kind", "autocallable", "--n-paths", "4096"], mc(),
                 id="exotic-autocallable"),
    pytest.param(["exotic", "--kind", "cliquet", "--n-paths", "4096"], mc(), id="exotic-cliquet"),
    pytest.param(["exotic", "--kind", "barrier", "--greeks", *K1, "--n-steps", "4"], close(),
                 id="exotic-greeks-lr"),
    pytest.param(["exotic", "--kind", "asian", "--greeks", *K1, "--n-steps", "4"], close(),
                 id="exotic-greeks-pathwise"),
    pytest.param(["exotic", "--model", "heston", "--kind", "double-barrier", "--lower", "80",
                  "--upper", "130", *K1, "--n-steps", "4"], close(), id="exotic-heston"),
    pytest.param(["exotic", "--model", "heston", "--kind", "double-touch", "--lower", "80",
                  "--upper", "130", "--greeks", *K1, "--n-steps", "4"], close(),
                 id="exotic-heston-greeks"),
    pytest.param(["exotic", "--model", "bates-qe", "--kind", "asian", *K1, "--n-steps", "4"],
                 close(), id="exotic-bates-qe"),
    pytest.param(["exotic", "--model", "heston", "--kind", "autocallable", "--greeks", *K1,
                  "--n-steps", "8"], close(), id="exotic-heston-autocall-greeks"),
    pytest.param(["exotic", "--model", "heston", "--kind", "cliquet", *K1, "--n-steps", "8"],
                 close(), id="exotic-heston-cliquet"),
    pytest.param(["exotic", "--model", "heston", "--kind", "range-accrual", "--greeks", *K1,
                  "--n-steps", "8"], close(), id="exotic-heston-range-accrual-greeks"),
    pytest.param(["exotic", "--model", "rbergomi", "--kind", "double-touch", "--n-paths", "4096",
                  "--n-steps", "8"], mc(), id="exotic-rbergomi"),
    pytest.param(["exotic", "--model", "rbergomi", "--kind", "autocallable", "--n-paths",
                  "4096", "--n-steps", "8"], mc(), id="exotic-rbergomi-autocall"),
    pytest.param(["exotic", "--model", "lv", "--kind", "double-touch", "--lower", "80",
                  "--upper", "130", *K1, "--n-steps", "8"], close(), id="exotic-lv"),
    pytest.param(["exotic", "--model", "lv", "--kind", "barrier", "--barrier", "130", "--greeks",
                  *K1, "--n-steps", "8"], close(), id="exotic-lv-greeks"),
    pytest.param(["exotic", "--model", "lv", "--kind", "range-accrual", "--lower", "90",
                  "--upper", "112", *K1, "--n-steps", "8"], close(), id="exotic-lv-range"),
    pytest.param(["exotic", "--model", "lv", "--kind", "cliquet", "--n-paths", "512",
                  "--n-steps", "8"], mc(), id="exotic-lv-cliquet"),
    # SLV: the leverage comes from a particle calibration that draws from a
    # PRNG key, so even the kernel branches are held within stderr
    pytest.param(["exotic", "--model", "slv", "--kind", "asian", "--mixing", "0.5",
                  "--n-paths", "16384", "--n-steps", "8"], mc(), id="exotic-slv-scan"),
    pytest.param(["exotic", "--model", "slv", "--kind", "barrier", "--greeks", *K1,
                  "--n-steps", "4"], mc(), id="exotic-slv-greeks"),
    pytest.param(["exotic", "--model", "slv", "--kind", "autocallable", *K1, "--n-steps", "4",
                  "--n-obs", "2"], mc(), id="exotic-slv-autocall"),
    pytest.param(["american", "--n-paths", "2048", "--n-dates", "10"], close(rtol=1e-5),
                 id="american-bs"),
    pytest.param(["american", "--model", "maxcall", "--n-dates", "3"], bracket,
                 id="american-maxcall"),
    pytest.param(["american", "--type", "put", "--model", "lv", "--n-dates", "2"], bracket,
                 id="american-lv"),
    pytest.param(["american", "--type", "put", "--model", "rbergomi", "--hurst", "0.15",
                  "--n-dates", "3"], bracket, id="american-rbergomi"),
    pytest.param(["american", "--type", "put", "--model", "heston", "--n-dates", "3"], bracket,
                 id="american-heston"),
    pytest.param(["american", "--type", "put", "--model", "bates", "--n-dates", "3"], bracket,
                 id="american-bates"),
    pytest.param(["american", "--type", "put", "--model", "slv", "--mixing", "0.5",
                  "--n-dates", "3"], bracket, id="american-slv"),
    pytest.param(["basket", "--kind", "geometric", "--n-paths", "20000"],
                 mc(also=("closed_form",)), id="basket-xla"),
    pytest.param(["basket", "--kind", "geometric", "--engine", "kernel", "--sampler", "sobol",
                  *K1], close(), id="basket-kernel-sobol"),
    pytest.param(["basket", "--engine", "kernel", "--sampler", "hash", "--greeks", *K1],
                 close(), id="basket-kernel-greeks"),
    pytest.param(["surface"], close(rtol=1e-4), id="surface-svi"),
    pytest.param(["surface", "--model", "ssvi"], close(rtol=1e-4), id="surface-ssvi"),
    pytest.param(["var", "--value", "100"], var, id="var"),
    pytest.param(["book", "--kind", "asian", "--strikes", "90", "100", "110", "--n-paths",
                  "20000", "--n-steps", "16"], close(), id="book-bs"),
    pytest.param(["book", "--kind", "barrier", "--model", "heston", "--strikes", "95", "105",
                  "--barriers", "125", "135", "--greeks", "--n-paths", "20000", "--n-steps",
                  "8"], close(rtol=1e-3), id="book-heston-greeks"),
    pytest.param(["bench-harness", "--models", "svi,kernel_ridge", "--trials", "2"],
                 bench_harness, id="bench-harness"),
]


@pytest.mark.parametrize("argv,check", CASES)
def test_subcommand_against_reference(argv, check):
    ref, port = run_both(argv)
    same_keys(ref, port)
    check(ref, port)


# ---------------------------------------------------------------------------
# branches whose checks need more than one number
# ---------------------------------------------------------------------------
def test_backtest_against_reference():
    """The float64 closed form against the reference's float32 scan: the
    premium to 1e-5, the P&L statistics to 2e-3 (252 float32 steps of cash
    accumulation)."""
    ref, port = run_both(["backtest"])
    same_keys(ref, port)
    assert port["n_rebalances"] == ref["n_rebalances"] == 252
    for key, tol in (("option_premium", 1e-5), ("final_settlement", 1e-5),
                     ("total_pnl", 2e-3), ("sharpe", 2e-3), ("max_drawdown", 2e-3),
                     ("win_rate", 1e-12)):
        assert port[key] == pytest.approx(ref[key], abs=tol), key


def test_varswap_against_reference():
    """The closed forms and the replications to 1e-4 of the reference in
    float64 (its float32 vol-swap quadrature is off by 2.4e-4); the LV and
    SLV Monte Carlo strikes within 4 combined stderr, their vol strikes to
    1e-3."""
    ref, port = run_both(["varswap"], ref_f32=False)
    same_keys(ref, port)
    for key in ("heston_variance_strike", "heston_vol_strike_exact",
                "heston_vol_strike_brockhaus_long", "flat_smile_variance_strike",
                "flat_smile_vol_check", "smile_replication_variance_strike",
                "vix_style_index_flat"):
        assert port[key] == pytest.approx(ref[key], rel=1e-4), key
    assert_within_se(ref, port, "local_vol_variance_strike", "local_vol_variance_stderr")
    assert_within_se(ref, port, "slv_variance_strike_mixing1", "slv_variance_stderr")
    for key in ("local_vol_vol_strike", "slv_vol_strike_mixing1"):
        assert port[key] == pytest.approx(ref[key], rel=1e-3), key


def test_calibrate_surface_against_reference():
    """SVI slices + SSVI on the synthetic chain: the same expiry bins and
    quote counts, each slice's rmse within 2e-4 vol and the arbitrage
    report's flags equal (float32 Adam in both)."""
    ref, port = run_both(["calibrate", "--steps", "60"])
    same_keys(ref, port)
    np.testing.assert_allclose(port["expiries"], ref["expiries"], rtol=1e-9)
    assert port["n_quotes"] == ref["n_quotes"]
    np.testing.assert_allclose(port["svi_rmse_vol"], ref["svi_rmse_vol"], atol=2e-4)
    assert port["ssvi_rmse_vol"] == pytest.approx(ref["ssvi_rmse_vol"], abs=2e-4)
    assert port["report"]["arbitrage_free"] == ref["report"]["arbitrage_free"]


@pytest.mark.parametrize("model,tol", [("heston", {"loss": 5e-3, "price_rmse": 2e-3}),
                                       ("bates", {"loss": 3e-2, "price_rmse": 5e-3})])
def test_calibrate_model_against_reference(model, tol):
    """Heston or Bates fit to the synthetic chain's prices by 20 Adam steps
    on Lewis prices: the same quotes, the loss and the price rmse within
    the model's relative tolerance (float32 Adam paths part from the
    reference's step by step)."""
    ref, port = run_both(["calibrate", "--model", model, "--steps", "20"])
    same_keys(ref, port)
    assert port["model"] == model and port["n_quotes"] == ref["n_quotes"]
    assert set(port["params"]) == set(ref["params"])
    for key, rel in tol.items():
        assert port[key] == pytest.approx(ref[key], rel=rel), key


@pytest.mark.parametrize("model", ["heston-mc", "rbergomi"])
def test_calibrate_model_routes_as_the_reference(model, monkeypatch):
    """The Monte Carlo fits (held to the reference by the chain-calibration
    tests): the same call of ``calibrate_model_to_chain`` from the same
    argv, the chain's columns equal."""
    import optionslab_tpu.surface.chain_calibration as jcc

    import optionslab_tpu_torch.surface.chain_calibration as tcc

    calls = {}
    for name, mod in (("ref", jcc), ("port", tcc)):
        def record(chain, model, name=name, **kw):
            calls[name] = (chain, model, kw)
            return {"model": model}
        monkeypatch.setattr(mod, "calibrate_model_to_chain", record)
    run_both(["calibrate", "--model", model, "--steps", "7", "--mc-paths", "4096"])
    (jchain, jmodel, jkw), (tchain, tmodel, tkw) = calls["ref"], calls["port"]
    assert tmodel == jmodel == model
    assert tkw.pop("device") == torch.device("cpu") and tkw == jkw
    for col in ("strike_price", "underlying_price", "time_to_maturity", "implied_volatility"):
        np.testing.assert_allclose(np.asarray(tchain.table[col], np.float64),
                                   np.asarray(jchain.df[col], np.float64), rtol=1e-12)


@pytest.mark.parametrize("argv", [
    ["xva", "--paths", "4096", "--dates", "4"],
    ["xva", "--exotic-kind", "asian_arith", "--paths", "4096", "--dates", "4"],
    ["xva", "--model", "rbergomi", "--option-type", "put", "--paths", "8192", "--dates", "4"],
], ids=["closed-form", "amc-exotic", "amc-rbergomi"])
def test_xva_against_reference(argv):
    """Exposure on different draws: the dates equal; EPE and CVA within 5%
    (the EE's sampling error at 4,096 paths is ≈1.5%)."""
    ref, port = run_both(argv)
    same_keys(ref, port)
    assert port["dates"] == pytest.approx(ref["dates"], rel=1e-6)
    assert port["epe"] == pytest.approx(ref["epe"], rel=0.05)
    assert port["cva"] == pytest.approx(ref["cva"], rel=0.05)


def test_price_fdm_american_against_reference(monkeypatch):
    """``price --model fdm --american``: both packages' ``fdm_price`` cut to
    a 41 x 40 grid (the port's plain Howard loop takes ≈20 s at the default
    201 x 200 on one CPU thread); the American put to 1e-4. At S0 = K the
    grid's mid-cell shift is a tie, which both packages break the same way."""
    for mod in (jmodels, tmodels):
        real = mod.fdm_price
        monkeypatch.setattr(mod, "fdm_price", lambda b, american, real=real: real(
            b, n_space=41, n_time=40, american=american))
    ref, port = run_both(["price", "--model", "fdm", "--american", "--type", "put"])
    same_keys(ref, port)
    assert port["price"] == pytest.approx(ref["price"], rel=1e-4)
    assert port["price"] > _run(tmain, ["--device", "cpu", "price", "--model", "bs",
                                        "--type", "put"])["price"]


def test_price_heston_american_against_reference(monkeypatch):
    """``price --model heston --american``: the ADI cut to 41 x 21 x 16 in
    both packages; the port's float32 ADI to 1e-4 of the reference's."""
    import optionslab_tpu.models.heston_fdm as jh

    import optionslab_tpu_torch.models.heston_fdm as th

    for mod, pkg in ((jh, jmodels), (th, tmodels)):
        real = mod.heston_fdm_price
        monkeypatch.setattr(pkg, "heston_fdm_price", lambda *a, real=real, **k: real(
            *a, n_x=41, n_v=21, n_t=16, **k))
    ref, port = run_both(["price", "--model", "heston", "--american", "--type", "put"])
    same_keys(ref, port)
    assert port["price"] == pytest.approx(ref["price"], rel=1e-4)


# ---------------------------------------------------------------------------
# error exits, plots, the report, the export, info, serve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["teleport"],
    ["basket", "--greeks"],
    ["american", "--type", "call", "--model", "rbergomi"],
    ["exotic", "--cv", "--kind", "barrier"],
    ["exotic", "--kind", "no-touch", "--pay", "hit"],
], ids=["unknown", "basket-greeks-xla", "rbergomi-call", "cv-barrier", "no-touch-hit"])
def test_error_exits_as_the_reference(argv, capsys):
    with pytest.raises(SystemExit) as ref:
        jmain(argv)
    with pytest.raises(SystemExit) as port:
        tmain(["--device", "cpu", *argv])
    capsys.readouterr()
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("what", ["boundary", "smiles", "ssvi-surface"])
def test_plot_writes_the_figure(what, tmp_path):
    out = tmp_path / f"{what}.png"
    got = _run(tmain, ["--device", "cpu", "plot", "--what", what, "--steps", "60", "--out",
                       str(out)])
    assert got == {"written": str(out), "plot": what}
    assert out.stat().st_size > 10_000 and out.read_bytes()[:4] == b"\x89PNG"


def test_plot_rbf_surface_refuses_duplicate_quotes(tmp_path):
    """The synthetic chain quotes calls and puts at one (strike, expiry):
    the port's quote interpolator refuses the singular kernel matrix."""
    with pytest.raises(ModelError, match="positive definite"):
        tmain(["--device", "cpu", "plot", "--what", "rbf-surface", "--n-rows", "200",
               "--out", str(tmp_path / "r.png")])


@pytest.mark.parametrize("command", ["plot", "report"])
def test_plot_and_report_need_matplotlib_before_any_fit(command, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    calls = []
    monkeypatch.setattr("optionslab_tpu_torch.surface.chain_calibration.calibrate_chain",
                        lambda *a, **k: calls.append(a))
    t0 = time.perf_counter()
    with pytest.raises(DependencyError, match="matplotlib"):
        tmain(["--device", "cpu", command, "--out", str(tmp_path / "x")])
    assert time.perf_counter() - t0 < 1.0 and calls == []


def test_report_subcommand(tmp_path, capsys):
    """The report's sections and summary keys are the reference's (the
    whole report is held to the reference in test_torch_report.py)."""
    ref_out, port_out = tmp_path / "ref.html", tmp_path / "port.html"
    argv = ["report", "--steps", "30", "--bins", "3", "--n-rows", "240", "--no-essvi",
            "--no-boundary", "--no-xva"]
    with jax.enable_x64(False):
        ref = _run(jmain, [*argv, "--out", str(ref_out)])
    port = _run(tmain, ["--device", "cpu", *argv, "--out", str(port_out)])
    capsys.readouterr()
    assert set(port) == set(ref) and port["sections"] == ref["sections"]
    np.testing.assert_allclose(port["svi_rmse_vol"], ref["svi_rmse_vol"], atol=5e-4)
    assert port_out.read_text().count("<h2>") == ref_out.read_text().count("<h2>")


def test_export_subcommand(tmp_path):
    """``export --onnx``: a ``.pt2`` artifact and its ``.onnx`` twin; the
    reference's JSON keys (its run without the ``.onnx`` twin)."""
    out = tmp_path / "m.pt2"
    got = _run(tmain, ["--device", "cpu", "export", "--epochs", "3", "--n-rows", "120",
                       "--out", str(out), "--onnx"])
    with jax.enable_x64(False):
        ref = _run(jmain, ["export", "--epochs", "3", "--n-rows", "120", "--out",
                           str(tmp_path / "m.hlo")])
    assert set(got) == set(ref) | {"onnx"} and set(got["export"]) == set(ref["export"])
    assert got["export"]["path"] == str(out) and out.exists()
    assert (tmp_path / "m.onnx").exists() and got["onnx"]["path"] == str(tmp_path / "m.onnx")
    assert set(got["final_metrics"]) == set(ref["final_metrics"])


def test_info_names_the_device():
    got = _run(tmain, ["--device", "cpu", "info"])
    ref = _run(jmain, ["info"])
    assert set(got) == set(ref) - {"tpu"} | {"cuda"}
    assert got["backend"] == "cpu" and got["device_kind"] == "cpu"


def test_every_reference_subcommand_is_ported():
    from optionslab_tpu.cli import COMMANDS as JCOMMANDS
    from optionslab_tpu.cli import build_parser as jparser

    from optionslab_tpu_torch.cli import build_parser as tparser

    assert set(COMMANDS) == set(JCOMMANDS)

    def flags(parser):
        """Per subcommand: each argument's dest, flags, default and choices
        (export's --out default aside)."""
        (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
        return {name: {(a.dest, tuple(a.option_strings),
                        None if (name, a.dest) == ("export", "out") else
                        tuple(a.default) if isinstance(a.default, list) else a.default,
                        tuple(a.choices or ()))
                       for a in sp._actions if a.dest != "help"}
                for name, sp in sub.choices.items()}, sub

    (ref, _), (port, sub) = flags(jparser()), flags(tparser())
    assert set(ref) == set(port)
    for name in ref:
        assert port[name] == ref[name], name
    (out,) = [a for a in sub.choices["export"]._actions if a.dest == "out"]
    assert out.default == "surface_mlp.pt2"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_module_entry_imports_no_jax():
    """``python -m optionslab_tpu_torch.cli --device cpu info`` in a fresh
    process: its import trace holds neither jax nor the JAX package."""
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "optionslab_tpu_torch.cli",
                           "--device", "cpu", "info"], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["backend"] == "cpu"
    imported = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if "|" in line}
    assert not {m for m in imported if m == "jax" or m.startswith("jax.")}
    assert not {m for m in imported if m == "optionslab_tpu" or m.startswith("optionslab_tpu.")}


def test_serve_answers_health_and_price():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "optionslab_tpu_torch.cli", "--device", "cpu",
                             "serve", "--port", str(port)], cwd=ROOT, env=_env(),
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
                assert time.monotonic() < deadline, "the server never answered /health"
                time.sleep(0.2)
        assert health["status"] == "ok" and health["device"] == "cpu"
        req = urllib.request.Request(url + "/price", data=json.dumps({"model": "bs"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["price"] == pytest.approx(BS_ATM_CALL, rel=1e-5)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
    assert proc.poll() is not None
