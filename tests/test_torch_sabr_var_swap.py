"""The port's SABR and variance/volatility swaps against
``optionslab_tpu.models.sabr`` and ``optionslab_tpu.models.var_swap``.

Deterministic functions run on the same inputs through both packages:
float64 to 1e-9 relative, float32 to 1e-5 relative (SABR prices: 1e-6 of the
forward, a deep out-of-the-money put being a small difference). The
calibration is held to its generating parameters, the Monte Carlo oracle to
the closed forms and to the reference's Monte Carlo within 4 standard
errors; then the oracle checks of
``tests/test_advanced_models.py::TestSABR`` and ``tests/test_var_swap.py``.
"""

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.models import bates as jbates
from optionslab_tpu.models import heston as jh
from optionslab_tpu.models import sabr as js
from optionslab_tpu.models import var_swap as jv
from optionslab_tpu_torch.models import bates as tbates
from optionslab_tpu_torch.models import heston as th
from optionslab_tpu_torch.models import sabr as ts
from optionslab_tpu_torch.models import var_swap as tv
from optionslab_tpu_torch.types import ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"f64": np.float64, "f32": np.float32}
RTOL = {"f64": 1e-9, "f32": 1e-5}
STRIKES = np.linspace(60.0, 150.0, 15)


def _sabr(dtype):
    jp = js.SABRParams.make(0.25, 0.6, -0.35, 0.5, dtype=DTYPES[dtype])
    return jp, ts.SABRParams.from_numpy({k: np.asarray(getattr(jp, k)) for k in ts.FIELDS})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sabr_matches_reference(dtype):
    f = DTYPES[dtype]
    jp, tp = _sabr(dtype)
    ks = STRIKES.astype(f)
    fwd, t, r = f(103.0), f(1.5), f(0.03)
    ours = ts.sabr_smile(torch.tensor(fwd), torch.tensor(ks), torch.tensor(t), tp)
    assert ours.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(js.sabr_smile(fwd, ks, t, jp)),
                               rtol=RTOL[dtype])
    assert float(ts.sabr_atm_vol(torch.tensor(fwd), torch.tensor(t), tp)) == pytest.approx(
        float(js.sabr_atm_vol(fwd, t, jp)), rel=RTOL[dtype])
    for cp in (1.0, -1.0):
        ours = ts.sabr_price(torch.tensor(fwd), torch.tensor(ks), torch.tensor(t),
                             torch.tensor(r), tp, cp).numpy()
        ref = np.asarray(js.sabr_price(fwd, ks, t, r, jp, cp))
        atol = 1e-9 * fwd if dtype == "f64" else 1e-6 * fwd
        np.testing.assert_allclose(ours, ref, rtol=RTOL[dtype], atol=atol)


def test_calibrate_sabr_recovers_a_generated_smile():
    truth = ts.SABRParams.make(0.3, 0.5, -0.4, 0.6)
    vols = ts.sabr_smile(100.0, torch.tensor(STRIKES[2:-2], dtype=torch.float32), 1.0, truth)
    fit, loss = ts.calibrate_sabr(100.0, STRIKES[2:-2], 1.0, vols, beta=0.5, n_steps=400)
    assert loss < 1e-8 and float(fit.beta) == 0.5
    for k, tol in (("alpha", 2e-3), ("rho", 0.02), ("nu", 0.02)):
        assert abs(float(getattr(fit, k)) - float(getattr(truth, k))) < tol, k
    ref, ref_loss = js.calibrate_sabr(100.0, STRIKES[2:-2], 1.0, vols.numpy(), beta=0.5,
                                      n_steps=400)
    assert float(fit.rho) == pytest.approx(float(ref.rho), abs=0.02)


class TestSABROracles:
    def test_atm_formula_and_continuity(self):
        m = ts.SABRModel(alpha=0.2, beta=0.5, rho=-0.3, nu=0.4, device="cpu")
        a, b, rho, nu = 0.2, 0.5, -0.3, 0.4
        fmid = 100.0 ** (1 - b)
        expect = a / fmid * (1 + (1 - b) ** 2 / 24 * a * a / fmid**2
                             + 0.25 * rho * b * nu * a / fmid + (2 - 3 * rho**2) / 24 * nu * nu)
        assert abs(float(m.atm_vol(100.0, 1.0)) - expect) < 1e-7
        assert abs(float(m.implied_vol(100.0, 100.0, 1.0))
                   - float(m.implied_vol(100.0, 100.0 + 1e-5, 1.0))) < 1e-5

    def test_flat_and_skewed_smiles(self):
        par = ts.SABRParams.make(alpha=0.25, beta=1.0, rho=0.0, nu=1e-8, dtype=torch.float64)
        vols = ts.sabr_implied_vol(100.0, torch.tensor([80.0, 100.0, 125.0],
                                                       dtype=torch.float64), 1.0, par)
        np.testing.assert_allclose(vols.numpy(), 0.25, atol=1e-4)
        smile = ts.SABRModel(alpha=2.0, beta=1.0, rho=-0.4, nu=0.6, device="cpu").smile(
            100.0, torch.linspace(70, 130, 13), 1.0)
        assert float(smile.min()) > 0 and float(smile[0]) > float(smile[-1])

    def test_black76_and_model_price(self):
        m = ts.SABRModel(device="cpu")
        fwd = 100.0 * np.exp(0.03)
        vol = float(m.implied_vol(fwd, 100.0, 1.0))
        ref = float(js.black76_price(fwd, 100.0, 1.0, 0.03, vol, 1.0))
        assert float(m.price(100.0, 100.0, 1.0, 0.03)) == pytest.approx(ref, rel=1e-5)
        assert float(ts.black76_price(fwd, 100.0, 0.0, 0.03, vol, -1.0)) == 0.0

    def test_validation(self):
        for kw in (dict(alpha=-0.1), dict(beta=1.5), dict(rho=1.0)):
            with pytest.raises(ValidationError):
                ts.SABRModel(device="cpu", **kw)


def _heston(dtype):
    jp = jh.HestonParams.make(0.05, 1.5, 0.04, 0.5, -0.6, dtype=DTYPES[dtype])
    return jp, th.HestonParams.from_numpy({k: np.asarray(getattr(jp, k))
                                           for k in th.PARAM_NAMES})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fn", ["heston_expected_variance", "heston_variance_of_variance",
                                "heston_vol_swap_strike", "heston_vol_swap_strike_brockhaus_long"])
def test_heston_closed_forms_match_reference(fn, dtype):
    jp, tp = _heston(dtype)
    for t in (0.25, 1.3):
        ours = getattr(tv, fn)(tp, t)
        assert ours.dtype == (torch.float64 if dtype == "f64" else torch.float32)
        assert float(ours) == pytest.approx(float(getattr(jv, fn)(jp, DTYPES[dtype](t))),
                                            rel=RTOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_replication_and_bates_match_reference(dtype):
    f = DTYPES[dtype]
    ks = np.exp(np.linspace(-2.0, 2.0, 60)).astype(f) * f(100.0)
    ivs = (0.2 - 0.08 * np.log(ks / 100.0)).astype(f)
    args = (f(100.0), ks, ivs, f(0.5), f(0.03), f(0.01))
    ours = tv.vix_style_index(*(torch.tensor(a) for a in args))
    assert float(ours) == pytest.approx(float(jv.vix_style_index(*args)), rel=RTOL[dtype])
    jb = jbates.BatesParams.make(dtype=f)
    tb = tbates.BatesParams.from_numpy({k: np.asarray(getattr(jb, k))
                                        for k in tbates.PARAM_NAMES})
    assert float(tv.bates_variance_swap_strike(tb, 1.0)) == pytest.approx(
        float(jv.bates_variance_swap_strike(jb, f(1.0))), rel=RTOL[dtype])


class TestVarSwapOracles:
    @pytest.fixture(scope="class")
    def params(self):
        return th.HestonParams.make(v0=0.04, kappa=2.0, theta=0.05, sigma=0.3, rho=-0.7,
                                    dtype=torch.float64)

    def test_flat_smile_recovers_sigma_squared(self):
        S, r, T, sig = 100.0, 0.03, 0.75, 0.22
        ks = torch.tensor(np.exp(np.linspace(-3.0, 3.0, 2000)) * S * np.exp(r * T))
        kv = float(tv.variance_swap_strike_from_iv(S, ks, torch.full_like(ks, sig), T, r))
        assert abs(kv / sig**2 - 1.0) < 3e-4
        kv_q = float(tv.variance_swap_strike_from_iv(S, ks, torch.full_like(ks, sig), T, r,
                                                     dividend=r))
        assert abs(kv_q / sig**2 - 1.0) < 3e-4
        above = torch.linspace(150.0, 300.0, 50, dtype=torch.float64)
        assert np.isfinite(float(tv.variance_swap_strike_from_iv(
            S, above, torch.full_like(above, 0.2), 1.0, 0.0)))

    def test_heston_smile_replication_matches_closed_form(self, params):
        S, r, T = 100.0, 0.03, 0.75
        strikes = np.exp(np.linspace(-2.5, 2.5, 1500)) * S * np.exp(r * T)
        cp = np.where(strikes <= S * np.exp(r * T), -1.0, 1.0)
        batch = ContractBatch.make(S, strikes, T, r, 0.2, cp, dtype=torch.float64)
        q = th.heston_price(batch, params)
        kv_rep = float(tv.variance_swap_strike_replication(torch.tensor(strikes), q, S, T, r))
        assert abs(kv_rep / float(tv.heston_expected_variance(params, T)) - 1.0) < 5e-4

    def test_expected_variance_laplace_and_slope(self, params):
        for T in (0.25, 1.0, 3.0):
            analytic = 0.05 + (0.04 - 0.05) * (1 - np.exp(-2.0 * T)) / (2.0 * T)
            assert abs(float(tv.heston_expected_variance(params, T)) - analytic) < 1e-12
        assert abs(float(tv.heston_integrated_variance_laplace(
            torch.zeros((), dtype=torch.float64), params, 1.0))) < 1e-14
        # the strike's slope in v0 is (1 − e^{−κT})/(κT)
        ev_up = float(tv.heston_expected_variance(th.HestonParams.make(
            0.04 + 1e-6, 2.0, 0.05, 0.3, -0.7, dtype=torch.float64), 1.0))
        ev_dn = float(tv.heston_expected_variance(th.HestonParams.make(
            0.04 - 1e-6, 2.0, 0.05, 0.3, -0.7, dtype=torch.float64), 1.0))
        assert abs((ev_up - ev_dn) / 2e-6 - (1 - np.exp(-2.0)) / 2.0) < 1e-8

    def test_moments_match_mc(self, params):
        m, se, rm, rse = tv.heston_integrated_variance_mc(
            params, 1.0, torch.Generator().manual_seed(0), n_paths=100_000, n_steps=100)
        ev = float(tv.heston_expected_variance(params, 1.0))
        assert abs(float(m) - ev) < 4 * float(se) + 5e-5  # + the O(dt) bias
        vv = float(tv.heston_variance_of_variance(params, 1.0))
        assert abs(float(se) ** 2 * 100_000 / vv - 1.0) < 0.05
        kq = float(tv.heston_vol_swap_strike(params, 1.0))
        assert abs(float(rm) - kq) < 4 * float(rse) + 5e-5
        assert kq < np.sqrt(ev)  # Jensen
        with pytest.raises(ValidationError):
            tv.heston_integrated_variance_mc(params, 1.0, torch.Generator(), n_paths=3)
        # and the reference's own Monte Carlo on the same scheme and sizes
        jp = jh.HestonParams.make(0.04, 2.0, 0.05, 0.3, -0.7, dtype=np.float64)
        ref = jv.heston_integrated_variance_mc(jp, 1.0, jax.random.PRNGKey(0), n_paths=100_000,
                                               n_steps=100)
        for ours, se_o, theirs, se_t in ((m, se, ref[0], ref[1]), (rm, rse, ref[2], ref[3])):
            assert abs(float(ours) - float(theirs)) < 4 * np.hypot(float(se_o), float(se_t))

    def test_bates_lam_zero_is_heston(self, params):
        b = tbates.BatesParams.make(0.04, 2.0, 0.05, 0.3, -0.7, lam=0.0, dtype=torch.float64)
        assert float(tv.bates_variance_swap_strike(b, 1.0)) == pytest.approx(
            float(tv.heston_variance_swap_strike(params, 1.0)), rel=1e-14)
