"""The port's chain calibration (``optionslab_tpu_torch/surface/
chain_calibration.py``) and ``/calibrate`` against the reference's on the
CPU, and the reference tests' own oracles on the port.

Each reference fit runs once for the module, pinned to float32 as the port
computes (``jax.enable_x64(False)``; ``tests/conftest.py`` turns x64 on).
Whole fits after hundreds of Adam steps agree within stated bounds; the
reference's fitted result carried into the port (``from_numpy``) holds the
surface function, the smile data, ``to_dict`` and the Dupire grid to the
reference near-exactly, but for the grid's last time column, where the
reference halves dw/dT (ROADMAP Queue 3) and the port takes the last
segment's slope.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.data import loader as jload
from optionslab_tpu.models import local_vol as jlv
from optionslab_tpu.server import handle_calibrate as j_handle
from optionslab_tpu.surface import chain_calibration as jcc
from optionslab_tpu_torch.data import (ColumnTable, OptionChainDataset,
                                       generate_synthetic_chain, load_option_data)
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.models.local_vol import local_vol_mc_price
from optionslab_tpu_torch.server import handle_calibrate
from optionslab_tpu_torch.surface import chain_calibration as tcc
from optionslab_tpu_torch.surface.svi import SVI_FIELDS
from optionslab_tpu_torch.utils.exceptions import ValidationError

CPU = "cpu"
CBOE = "tests/data/cboe_spx_quotedata.csv"
SPOT, RATE = 5123.41, 0.043


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _num(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def chains():
    return (jload.load_option_data("synthetic", n_rows=500, seed=3),
            load_option_data("synthetic", n_rows=500, seed=3, device=CPU))


@pytest.fixture(scope="module")
def fits(chains):
    """One fit a side, with eSSVI: the slices and SSVI are those of the
    plain call (eSSVI only adds to the result)."""
    with jax.enable_x64(False):
        ref = jcc.calibrate_chain(chains[0], n_expiry_bins=4, n_steps=500, essvi=True)
    return ref, tcc.calibrate_chain(chains[1], n_expiry_bins=4, n_steps=500, essvi=True)


def _carry(ref):
    """The reference's fitted result as numpy, into the port."""
    return tcc.ChainCalibrationResult.from_numpy(
        expiries=ref.expiries, n_quotes=ref.n_quotes,
        svi_params=[{f: np.asarray(getattr(p, f)) for f in SVI_FIELDS} for p in ref.svi_params],
        svi_rmse_vol=ref.svi_rmse_vol, thetas=ref.thetas,
        ssvi={f: np.asarray(getattr(ref.ssvi, f)) for f in ("rho", "eta", "gamma")},
        ssvi_rmse_vol=ref.ssvi_rmse_vol, report=ref.report, spot=ref.spot, rate=ref.rate,
        slice_quotes=ref.slice_quotes,
        essvi=None if ref.essvi is None else [np.asarray(ref.essvi.theta),
                                              np.asarray(ref.essvi.rho),
                                              np.asarray(ref.essvi.psi)],
        essvi_rmse_vol=ref.essvi_rmse_vol, device=CPU)


def test_whole_fit_matches_reference(fits):
    ref, port = fits
    assert np.array_equal(port.expiries, ref.expiries)
    assert np.array_equal(port.n_quotes, ref.n_quotes)
    for (kp, ivp), (kr, ivr) in zip(port.slice_quotes, ref.slice_quotes):
        assert np.array_equal(kp, kr) and np.array_equal(ivp, ivr)
    np.testing.assert_allclose(port.svi_rmse_vol, ref.svi_rmse_vol, rtol=0, atol=5e-4)
    for i, (k, _) in enumerate(ref.slice_quotes):
        np.testing.assert_allclose(_num(port.svi_vol(k, i)), np.asarray(ref.svi_vol(k, i)),
                                   rtol=0, atol=1e-3)
    assert port.ssvi_rmse_vol == pytest.approx(ref.ssvi_rmse_vol, abs=1e-3)
    np.testing.assert_allclose(port.thetas, ref.thetas, rtol=0, atol=1e-4)
    assert port.essvi_rmse_vol == pytest.approx(ref.essvi_rmse_vol, abs=1e-3)
    for key, value in ref.report.items():
        if isinstance(value, (bool, list)):
            assert port.report[key] == value, key
    assert port.report["ssvi_butterfly_condition"] == pytest.approx(
        ref.report["ssvi_butterfly_condition"], abs=5e-3)


def test_bucketing_and_atm_term_structure_match_reference():
    rng = np.random.default_rng(6)
    ttm = rng.uniform(0.05, 2.0, 300)
    for n_bins in (3, 6, 400):
        for a, b in zip(tcc._bucket_expiries(ttm, n_bins), jcc._bucket_expiries(ttm, n_bins)):
            assert np.array_equal(a, b)
    few = np.repeat([0.1, 0.5, 1.0], 7)
    for a, b in zip(tcc._bucket_expiries(few, 6), jcc._bucket_expiries(few, 6)):
        assert np.array_equal(a, b)
    k = rng.uniform(-0.4, 0.4, 300)
    iv = 0.2 + 0.05 * np.sqrt(ttm) - 0.1 * k
    tq = np.linspace(0.0, 2.5, 11)
    assert np.array_equal(tcc._atm_term_structure(k, ttm, iv)(tq),
                          jcc._atm_term_structure(k, ttm, iv)(tq))
    assert np.array_equal(tcc._atm_term_structure(k[:5], ttm[:5], iv[:5])(tq),
                          jcc._atm_term_structure(k[:5], ttm[:5], iv[:5])(tq))


def test_carried_fit_surface_smiles_and_dict_match_reference(chains, fits):
    ref, _ = fits
    carried = _carry(ref)
    with jax.enable_x64(False):
        j_iv = jcc.svi_surface_iv_fn(ref)
        kq = np.linspace(-0.4, 0.3, 9, dtype=np.float32)
        tq = np.concatenate([ref.expiries, [0.03, 0.4, 1.1, 2.5]]).astype(np.float32)
        want = np.asarray(j_iv(kq[:, None], tq[None, :]))
        want_smiles = [jcc.chain_smile_data(chains[0], ref, i) for i in range(len(ref.expiries))]
    got = _num(tcc.svi_surface_iv_fn(carried)(torch.tensor(kq)[:, None],
                                              torch.tensor(tq)[None, :]))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for i, w in enumerate(want_smiles):
        d = tcc.chain_smile_data(chains[1], carried, i)
        for key in ("k_market", "iv_market", "k_fit"):
            assert np.array_equal(d[key], w[key])
        np.testing.assert_allclose(d["iv_fit"], w["iv_fit"], rtol=1e-6)
        assert d["expiry"] == w["expiry"]
    got_d, want_d = carried.to_dict(), ref.to_dict()
    assert json.loads(json.dumps(got_d)) == json.loads(json.dumps(want_d))


def test_dupire_grid_matches_reference_but_its_last_column(fits):
    """Everywhere but the last expiry the port's Dupire grid is the
    reference's; on the last column the reference's clip passes half of
    dw/dT (JAX's gradient of a clip at its bound), the port the one-sided
    slope: the reference's own value one float32 step below that expiry."""
    ref, _ = fits
    carried = _carry(ref)
    n_k, n_t = 41, 12
    with jax.enable_x64(False):
        j_lv, _ = jcc.local_vol_from_chain(None, result=ref, n_k=n_k, n_t=n_t)
        want = np.asarray(j_lv.surface.grid)
        t_last = np.float32(ref.expiries[-1])
        below = jlv.DupireLocalVol(  # the same shapes: the reference's op caches hit
            jcc.svi_surface_iv_fn(ref), ref.spot, ref.rate,
            k_range=(float(j_lv.k_grid[0]), float(j_lv.k_grid[-1])),
            t_range=(float(np.nextafter(t_last, np.float32(0))),) * 2, n_k=n_k, n_t=n_t)
        one_sided = np.asarray(below.surface.grid)[0]
    t_lv, _ = tcc.local_vol_from_chain(None, result=carried, n_k=n_k, n_t=n_t)
    got = _num(t_lv.surface.grid)
    assert float(t_lv.t_grid[-1]) == float(t_last)
    np.testing.assert_allclose(_num(t_lv.k_grid), np.asarray(j_lv.k_grid), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=1e-5)
    np.testing.assert_allclose(got[-1], one_sided, rtol=1e-4)
    # the reference's halved slope: its local variance there is below the
    # one-sided value wherever neither is at the clip floor
    live = one_sided ** 2 > 2e-6
    assert np.all(want[-1][live] ** 2 < 0.75 * one_sided[live] ** 2)


def test_reference_oracles_on_the_port_fit(chains, fits):
    """``tests/test_chain_calibration.py:29-75`` on the port."""
    _, res = fits
    assert len(res.svi_params) == 4
    assert np.all(res.svi_rmse_vol < 0.009)
    assert res.ssvi_rmse_vol < 0.02 and -1 < float(res.ssvi.rho) < 1
    rep = res.report
    assert rep["arbitrage_free"] and all(rep["butterfly_free"])
    assert rep["calendar_violation_rate"] == 0.0 and rep["theta_monotone"]
    assert rep["ssvi_butterfly_condition"] <= 2.0 + 1e-6
    assert np.all(np.diff(res.expiries) > 0) and np.all(np.diff(res.thetas) > 0)
    d = json.loads(json.dumps(res.to_dict()))
    assert len(d["svi_params"]) == 4 and set(d["svi_params"][0]) == set(SVI_FIELDS)
    smile = tcc.chain_smile_data(chains[1], res, 0)
    assert len(smile["k_market"]) == res.n_quotes[0]
    assert len(smile["k_fit"]) == len(smile["iv_fit"]) == 101 and np.all(smile["iv_fit"] > 0)
    with pytest.raises(ValidationError):
        tcc.calibrate_chain(chains[1].table.take(np.arange(3)), n_expiry_bins=2, device=CPU)


def test_vendor_chain_held_out_vols():
    """``tests/test_real_chain_workflow.py:122-157`` on the port: the CBOE
    chain, filtered, every 7th quote held out, fit from the mids."""
    ch = (load_option_data("cboe", path=CBOE, rate=RATE, device=CPU)
          .filter_liquidity(max_spread_pct=0.5).filter_moneyness(0.85, 1.2))
    rows = np.arange(len(ch))
    held, used = ch.table.take(rows % 7 == 0), ch.table.take(rows % 7 != 0)
    res = tcc.calibrate_chain(OptionChainDataset(used, device=CPU), n_expiry_bins=6,
                              from_prices=True, n_steps=400, essvi=True)
    assert res.essvi_rmse_vol <= res.ssvi_rmse_vol + 1e-4
    assert res.report["essvi_arbitrage_free"], res.report
    assert res.ssvi_rmse_vol < 0.01
    assert res.report["arbitrage_free"] and res.report["ssvi_butterfly_free"]
    assert res.report["calendar_violation_rate"] == 0.0
    t = np.asarray(held["time_to_maturity"], np.float64)
    k = np.log(np.asarray(held["strike_price"], np.float64) / (SPOT * np.exp(RATE * t)))
    fitted = _num(tcc.svi_surface_iv_fn(res)(k.astype(np.float32), t.astype(np.float32)))
    err = np.abs(fitted - np.asarray(held["implied_volatility"], np.float64))
    assert np.median(err) < 0.008 and np.quantile(err, 0.9) < 0.02


def test_local_vol_pipeline_reprices_vanillas(fits):
    """``tests/test_chain_calibration.py:78-124`` on the port's fit: chain →
    SVI surface → Dupire local vol → the PDE and the Monte Carlo reprice."""
    _, res = fits
    lv, _ = tcc.local_vol_from_chain(None, result=res)
    iv_fn = tcc.svi_surface_iv_fn(res)
    for i in (0, len(res.expiries) - 1):
        t = float(res.expiries[i])
        assert abs(float(iv_fn(0.05, t)) - float(res.svi_vol(0.05, i))) < 1e-6

    def bs(strike, t):
        k = float(np.log(strike / (res.spot * np.exp(res.rate * t))))
        return float(bs_price(res.spot, strike, t, res.rate, float(iv_fn(k, t)), 1.0))

    for strike, t in [(100.0, 1.0), (90.0, 0.5), (110.0, 1.5)]:
        assert abs(float(lv.price(res.spot, strike, t)) / bs(strike, t) - 1.0) < 4e-3
    p, se = local_vol_mc_price(lv, 100.0, 1.0, cp=1.0, n_paths=100_000, n_steps=100)
    assert abs(float(p) - bs(100.0, 1.0)) < 3 * float(se) + 0.02
    assert float(iv_fn(0.0, 0.3 * float(res.expiries[0]))) > 0.05


@pytest.mark.parametrize("model,kw,bounds", [
    ("heston", dict(n_steps=60), dict(iv=2e-4, v0=5e-3, rho=1e-2)),
    ("heston-mc", dict(n_steps=3, mc_paths=8_192, mc_max_dt=0.25), dict(iv=2e-4, v0=2e-4,
                                                                         rho=2e-4)),
])
def test_model_fit_matches_reference(chains, model, kw, bounds):
    """The ``heston`` fit through Lewis and the ``heston-mc`` fit through the
    chain kernel's plain version, ``hash`` paths on both sides."""
    with jax.enable_x64(False):
        want = jcc.calibrate_model_to_chain(chains[0], model, **kw)
    got = tcc.calibrate_model_to_chain(chains[1], model, **kw)
    assert got["n_quotes"] == want["n_quotes"] and got["model"] == model
    assert got["iv_rmse"] == pytest.approx(want["iv_rmse"], abs=bounds["iv"])
    for name in ("v0", "rho"):
        assert got["params"][name] == pytest.approx(want["params"][name], abs=bounds[name])
    assert set(got["params"]) == set(want["params"])


@pytest.mark.slow
@pytest.mark.parametrize("model,kw", [
    ("heston", dict(n_steps=600)), ("heston-mc", dict(n_steps=30, mc_paths=131_072,
                                                      mc_max_dt=0.25))])
def test_model_fit_matches_reference_at_the_reference_tests_sizes(chains, model, kw):
    with jax.enable_x64(False):
        want = jcc.calibrate_model_to_chain(chains[0], model, **kw)
    got = tcc.calibrate_model_to_chain(chains[1], model, **kw)
    assert got["iv_rmse"] == pytest.approx(want["iv_rmse"], abs=1e-4)
    for name, value in want["params"].items():
        assert got["params"][name] == pytest.approx(value, rel=2e-2, abs=1e-3), name


def test_unknown_model_raises(chains):
    with pytest.raises(ValidationError):
        tcc.calibrate_model_to_chain(chains[1], "sabr2")


def _calibrate_body(n_steps=300):
    rng = np.random.default_rng(0)
    n = 120
    k = rng.uniform(-0.3, 0.3, n)
    t = rng.uniform(0.1, 1.5, n)
    iv = 0.2 - 0.1 * k + 0.15 * k * k + 0.02 * np.sqrt(t)
    return {"underlying_price": [100.0] * n, "strike_price": (100.0 * np.exp(-k)).tolist(),
            "time_to_maturity": t.tolist(), "implied_volatility": iv.tolist(),
            "risk_free_rate": 0.03, "n_expiry_bins": 3, "n_steps": n_steps}


def test_calibrate_route_matches_reference_handler():
    body = _calibrate_body()
    with jax.enable_x64(False):
        want = j_handle(dict(body))
    got = handle_calibrate(dict(body), torch.device(CPU))
    assert json.loads(json.dumps(got)).keys() == want.keys()
    assert got["n_quotes"] == want["n_quotes"] and got["expiries"] == want["expiries"]
    np.testing.assert_allclose(got["svi_rmse_vol"], want["svi_rmse_vol"], atol=5e-4)
    np.testing.assert_allclose(got["thetas"], want["thetas"], atol=1e-4)
    assert all(r < 0.02 for r in got["svi_rmse_vol"])
    assert got["report"]["arbitrage_free"] == want["report"]["arbitrage_free"]
    for bad in ({k: v for k, v in body.items() if k != "strike_price"},
                {**body, "time_to_maturity": body["time_to_maturity"][:-1]},
                {**body, "implied_volatility": ["x"] * 120}):
        with pytest.raises(ValidationError):
            handle_calibrate(bad, torch.device(CPU))


def test_chain_and_route_without_pandas(monkeypatch):
    """The card's machine has no pandas: the chain, the fit and the route
    run on the column table."""
    monkeypatch.setitem(sys.modules, "pandas", None)
    chain = generate_synthetic_chain(n_rows=240, seed=4, device=CPU)
    assert isinstance(chain, ColumnTable)
    res = tcc.calibrate_chain(chain.drop(columns=["implied_volatility"]), n_expiry_bins=3,
                              n_steps=150, device=CPU)
    assert len(res.svi_params) == 3 and np.all(res.svi_rmse_vol < 0.015)
    out = handle_calibrate(_calibrate_body(n_steps=150), torch.device(CPU))
    assert len(out["svi_params"]) == 3 and out["report"]["total_quotes_used"] == 120
