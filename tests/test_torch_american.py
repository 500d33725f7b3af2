"""The port's certified American brackets against
``optionslab_tpu.models.american``.

* Deterministic parts run in float64 on both sides: the grid induction
  (value surface, residual tables, estimate), the readout Greeks, the
  exercise boundaries and the exact partial-moment expectation agree to
  1e-9 (the float32 residual tables to 1e-6).
* The Monte Carlo bounds draw from different generators; each runs on the
  reference's own policy or value surface, carried across by
  ``LSMPolicy.from_numpy`` / ``GridValue.from_numpy``, and agrees with the
  reference's bound within 4 combined standard errors.
* Then the oracle checks of ``tests/test_american.py`` at ``n_grid`` 128,
  ``n_dates`` 9 and ``n_outer`` 8192, and the device defaults of the
  entry points that build their state from Python numbers.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import american as ja
from optionslab_tpu_torch.models import american as ta
from optionslab_tpu_torch.models.binomial import binomial_greeks, binomial_price
from optionslab_tpu_torch.models.black_scholes import bs_price
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


S, K, T, R, SIG = 100.0, 100.0, 1.0, 0.05, 0.2
N_DATES, N_GRID, N_OUTER = 9, 128, 8192


def _f(x) -> float:
    return float(np.asarray(x.detach() if isinstance(x, torch.Tensor) else x))


def _agree(ours, ref, k=4.0):
    """Two (value, stderr) Monte Carlo estimates within k combined stderrs."""
    (a, sa), (b, sb) = ((_f(v), _f(s)) for v, s in (ours, ref))
    assert abs(a - b) < k * math.hypot(sa, sb), (a, sa, b, sb)


GRID_CASES = {"put": (-1.0, 0.0), "call_div": (1.0, 0.03)}


@pytest.fixture(scope="module")
def ref_surfaces():
    return {name: ja.grid_value_surface(S, 95.0, T, R, SIG, cp, q, N_DATES, N_GRID)
            for name, (cp, q) in GRID_CASES.items()}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_value_surface_matches_reference(ref_surfaces, case):
    cp, q = GRID_CASES[case]
    ref = ref_surfaces[case]
    ours = ta.grid_value_surface(S, 95.0, T, R, SIG, cp, q, N_DATES, N_GRID, device="cpu")
    assert ours.resid.dtype == torch.float32 and ours.price.dtype == torch.float64
    assert ours.y0 == pytest.approx(ref.y0, rel=1e-12) and ours.h == pytest.approx(ref.h,
                                                                                   rel=1e-12)
    assert _f(ours.price) == pytest.approx(_f(ref.price), rel=1e-9)
    for k in ("resid", "cresid"):
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_grid_induction_matches_reference():
    band = ta._band_width(0.001, 0.05, 0.02)
    assert band == ja._band_width(0.001, 0.05, 0.02)
    ref = ja._grid_induction(S, K, 0.5, R, 0.3, -1.0, 0.01, 5, 64, band)
    ours = ta._grid_induction(S, K, 0.5, R, 0.3, -1.0, 0.01, 5, 64, band, device="cpu")
    assert ours[0] == pytest.approx(float(ref[0]), rel=1e-12)
    assert _f(ours[4]) == pytest.approx(_f(ref[4]), rel=1e-9)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def carried_surface(ref_surfaces):
    ref = ref_surfaces["put"]
    return ref, ta.GridValue.from_numpy({k: getattr(ref, k) for k in ta.GRID_FIELDS})


def test_grid_bounds_on_the_reference_surface(carried_surface):
    ref, gv = carried_surface
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    args = (ref.spot, ref.strike, ref.maturity, ref.rate, ref.vol, ref.cp, ref.dividend, key)
    lo, lo_se, up, up_se = ta._grid_bracket(gv, gen, N_OUTER, 20)
    rlo, rlo_se, rup, rup_se = ja._grid_bracket(ref.resid, ref.cresid, ref.y0, ref.h, *args,
                                                N_OUTER, N_DATES, 20)
    _agree((lo, lo_se), (rlo, rlo_se))
    _agree((up, up_se), (rup, rup_se))
    _agree(ta._grid_lower(gv, gen, N_OUTER),
           ja._grid_lower(ref.cresid, ref.y0, ref.h, *args, N_OUTER, N_DATES))
    _agree(ta._grid_dual_upper(gv, gen, N_OUTER, 20),
           ja._grid_dual_upper(ref.resid, ref.y0, ref.h, *args, N_OUTER, N_DATES, 20))


@pytest.fixture(scope="module")
def policies():
    ref = ja.fit_lsm_policy(S, K, T, R, SIG, jax.random.PRNGKey(4), -1.0, 0.0, 16_384, N_DATES)
    return ref, ta.LSMPolicy.from_numpy({k: getattr(ref, k) for k in ta.LSM_FIELDS})


def test_lsm_bounds_on_the_reference_policy(policies):
    ref, pol = policies
    gen = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(5)
    _agree(ta.lsm_lower_bound(pol, gen, 16_384), ja.lsm_lower_bound(ref, key, 16_384))
    _agree(ta.lsm_lower_bound(pol, gen, 16_384, use_cv=False),
           ja.lsm_lower_bound(ref, key, 16_384, use_cv=False))
    _agree(ta.dual_upper_bound(pol, gen, 16_384), ja.dual_upper_bound(ref, key, 16_384))
    _agree(ta.ab_upper_bound(pol, gen, 256, 64), ja.ab_upper_bound(ref, key, 256, 64))


def test_fit_lsm_policy_is_statistically_the_reference(policies):
    ref, _ = policies
    ours = ta.fit_lsm_policy(S, K, T, R, SIG, torch.Generator().manual_seed(4), -1.0, 0.0,
                             16_384, N_DATES)
    assert ours.coefs.shape == ref.coefs.shape == (N_DATES, 5)
    assert ours.coefs.dtype == torch.float32 and not ours.coefs[-1].any()
    # both fits price within noise of each other on one fresh path set
    gen = torch.Generator().manual_seed(6)
    lo_ours = ta.lsm_lower_bound(ours, gen, 16_384, use_cv=False)
    gen = torch.Generator().manual_seed(6)
    lo_ref = ta.lsm_lower_bound(ta.LSMPolicy.from_numpy({k: getattr(ref, k)
                                                         for k in ta.LSM_FIELDS}),
                                gen, 16_384, use_cv=False)
    assert abs(_f(lo_ours[0]) - _f(lo_ref[0])) < 0.05


def test_closed_form_dual_pieces_match_reference(policies):
    ref, pol = policies
    coefs = jnp.asarray(ref.coefs, jnp.float64)
    b_ref = np.asarray(ja._solve_boundaries(coefs, K, -1.0, 3, N_DATES))
    b = ta._solve_boundaries(pol.coefs.double(), K, -1.0, 3, N_DATES).numpy()
    np.testing.assert_allclose(b, b_ref, rtol=1e-9)
    dt = T / N_DATES
    mu, sig = (R - 0.5 * SIG**2) * dt, SIG * math.sqrt(dt)
    s = np.array([80.0, 95.0, 100.0, 120.0])
    vco = np.asarray(ref.vcoefs, np.float64)[4]
    ours = ta._expect_piecewise(torch.tensor(s), torch.tensor(b[4]), torch.tensor(vco), K, -1.0,
                                3, mu, sig).numpy()
    theirs = np.asarray(ja._expect_piecewise(jnp.asarray(s), b_ref[4], jnp.asarray(vco), K,
                                             -1.0, 3, mu, sig))
    np.testing.assert_allclose(ours, theirs, rtol=1e-9)
    # and the closed form is the mean of the piecewise value over the next step
    z = torch.randn(400_000, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    snext = 95.0 * torch.exp(mu + sig * z)
    mc = ta._piecewise_value(snext, torch.tensor(b[4]), torch.tensor(vco), K, -1.0, 3)
    assert abs(_f(mc.mean()) - ours[1]) < 4 * _f(mc.std()) / math.sqrt(400_000)


def test_grid_greeks_match_reference():
    kw = dict(n_dates=20, n_grid=128, richardson=False)
    ours = ta.american_grid_greeks(S, K, T, R, SIG, **kw, device="cpu")
    ref = ja.american_grid_greeks(S, K, T, R, SIG, **kw)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=1e-8, abs=1e-9), k


@pytest.fixture(scope="module")
def put_interval():
    return ta.american_price_interval(S, K, T, R, SIG, -1.0, n_outer=N_OUTER, n_dates=N_DATES,
                                      n_grid=N_GRID, device="cpu")


class TestBracketOracles:
    def test_grid_bracket_against_the_reference_and_crr(self, put_interval):
        out = put_interval
        ref = ja.american_price_interval(S, K, T, R, SIG, -1.0, n_outer=N_OUTER, n_dates=N_DATES,
                                         n_grid=N_GRID)
        assert set(out) == set(ref)
        _agree((out["lower"], out["lower_se"]), (ref["lower"], ref["lower_se"]))
        _agree((out["upper"], out["upper_se"]), (ref["upper"], ref["upper_se"]))
        assert _f(out["estimate"]) == pytest.approx(_f(ref["estimate"]), rel=1e-9)
        lo, hi = _f(out["lower"]), _f(out["upper"])
        assert lo <= hi and _f(out["width"]) < 0.01 and _f(out["upper_se"]) < 2e-3
        euro = _f(bs_price(S, K, T, R, SIG, -1.0))
        crr = _f(binomial_price(ContractBatch.make(S, K, T, R, SIG, "put", dtype=torch.float64),
                                american=True, n_steps=512))
        # Bermudan-9 sits between the European and the continuous American
        assert euro < lo and hi < crr

    def test_closed_form_and_nested_methods(self):
        kw = dict(n_fit=16_384, n_lower=16_384, n_dates=N_DATES, device="cpu")
        cf = ta.american_price_interval(S, K, T, R, SIG, -1.0, seed=1, n_outer=16_384,
                                        method="closed_form", **kw)
        nest = ta.american_price_interval(S, K, T, R, SIG, -1.0, seed=1, n_outer=256,
                                          n_inner=64, method="nested", **kw)
        for out in (cf, nest):
            assert set(out) == {"lower", "lower_se", "upper", "upper_se", "width"}
            assert _f(out["lower"]) <= _f(out["upper"])
            assert 5.9 < _f(out["lower"]) - 3 * _f(out["lower_se"]) < 6.1
        assert _f(cf["upper"]) + 3 * _f(cf["upper_se"]) < 6.3 and _f(cf["width"]) < 0.2
        # the nested dual at 256 × 64 paths: valid, noisy
        assert _f(nest["upper"]) + 3 * _f(nest["upper_se"]) >= \
            _f(nest["lower"]) - 3 * _f(nest["lower_se"])
        with pytest.raises(ValidationError):
            ta.american_price_interval(S, K, T, R, SIG, method="magic", device="cpu")

    def test_single_date_is_european(self):
        euro = _f(bs_price(torch.tensor(S, dtype=torch.float64), K, T, R, SIG, -1.0, 0.0))
        out = ta.american_price_interval(S, K, T, R, SIG, -1.0, n_outer=2048, n_dates=1,
                                         n_grid=512, device="cpu")
        assert abs(_f(out["lower"]) - euro) < 1e-6 and abs(_f(out["upper"]) - euro) < 1e-6

    def test_call_without_dividend_is_european(self):
        euro = _f(bs_price(S, K, T, R, SIG, 1.0, 0.0))
        out = ta.american_continuous_interval(S, K, T, R, SIG, cp=1.0, n_outer=2048,
                                              n_dates=N_DATES, n_grid=N_GRID, device="cpu")
        assert out["pad"] == 0.0
        assert _f(out["lower"]) - 3 * _f(out["lower_se"]) <= euro
        assert euro <= _f(out["upper"]) + 3 * _f(out["upper_se"]) + 1e-4
        with pytest.raises(ValidationError):
            ta.american_continuous_interval(S, K, T, R, SIG, cp=1.0, dividend=0.02,
                                            n_dates=N_DATES, n_grid=N_GRID, device="cpu")

    def test_continuous_interval_contains_crr(self):
        crr = _f(binomial_price(ContractBatch.make(S, K, T, R, SIG, "put", dtype=torch.float64),
                                american=True, n_steps=512))
        out = ta.american_continuous_interval(S, K, T, R, SIG, n_outer=4096, n_dates=50,
                                              n_grid=256, device="cpu")
        assert out["pad"] == pytest.approx(R * K * T / 50)
        assert _f(out["lower"]) - 3 * _f(out["lower_se"]) <= crr
        assert crr <= _f(out["upper"]) + 3 * _f(out["upper_se"])

    def test_grid_greeks_near_the_lattice(self):
        g = ta.american_grid_greeks(S, K, T, R, SIG, n_dates=100, n_grid=512, device="cpu")
        bg = binomial_greeks(ContractBatch.make(S, K, T, R, SIG, "put", dtype=torch.float64),
                             american=True, n_steps=512)
        for k, tol in (("delta", 5e-3), ("gamma", 1e-3), ("theta", 0.1), ("vega", 0.5),
                       ("rho", 0.5), ("price", 0.03)):
            assert abs(g[k] - _f(bg[k])) < tol, k


@pytest.mark.parametrize("fn", [
    "american_price_interval", "american_continuous_interval", "american_grid_greeks",
    "grid_value_surface", "fit_lsm_policy", "local_vol_american_bracket",
    "implied_volatility", "MertonJumpDiffusion", "KouJumpDiffusion", "SABRModel",
    "BinomialTree", "CrankNicolsonSolver", "ExplicitFDMSolver", "AmericanOptionLSM",
    "qmc_asian_price", "qmc_lookback_price", "qmc_barrier_price"])
def test_float_built_entry_points_default_to_cuda(fn):
    import optionslab_tpu_torch.models as models

    assert inspect.signature(getattr(models, fn)).parameters["device"].default == "cuda"



_STRIKES = np.linspace(80.0, 120.0, 5)
_ARRAY_CALLS = {  # entry points that take arrays, given them through ``a``
    "implied_volatility_vectorized": lambda m, a: m.implied_volatility_vectorized(
        a(np.full(5, 10.0)), 100.0, a(_STRIKES), 1.0, 0.05),
    "iv_surface_from_prices": lambda m, a: m.iv_surface_from_prices(
        a(np.full((2, 5), 10.0)), 100.0, a(_STRIKES), a(np.array([0.5, 1.0])), 0.05),
    "calibrate_sabr": lambda m, a: m.calibrate_sabr(100.0, a(_STRIKES), 1.0,
                                                    a(np.full(5, 0.2)), n_steps=2)[0].alpha,
    "variance_swap_strike_replication": lambda m, a: m.variance_swap_strike_replication(
        a(_STRIKES), a(np.full(5, 1.0)), 100.0, 1.0, 0.05),
    "vix_style_index": lambda m, a: m.vix_style_index(100.0, a(_STRIKES), a(np.full(5, 0.2)),
                                                      1.0, 0.05),
}


@pytest.mark.parametrize("fn", sorted(_ARRAY_CALLS))
def test_array_entry_points_default_to_cuda(fn):
    """Numpy inputs alone go to the card; CPU tensors keep the work there."""
    import optionslab_tpu_torch.models as models

    call = _ARRAY_CALLS[fn]
    if torch.cuda.is_available():
        assert call(models, np.asarray).device.type == "cuda"
    else:  # this torch has no CUDA: asking for the card is what fails
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call(models, np.asarray)
    assert call(models, torch.tensor).device.type == "cpu"
