"""The port's counterparty exposure and XVA (``optionslab_tpu_torch/risk``:
``exposure``, ``exposure_heston``, ``exposure_amc``) against
``optionslab_tpu.risk`` and against the exact oracles of the reference's
``tests/test_exposure.py``, on the CPU at 4,096–16,384 paths and at most
12 dates.

The two packages draw different paths, so a Monte Carlo profile is held to
its oracle, or to the reference's profile, within 4 standard errors (the
port's ``ee_stderr`` and ``pfe_stderr``; the reference's, of the same law,
taken equal); everything deterministic matches to float rounding: the
credit legs of one shared profile (``ExposureResult.from_numpy``) to 1e-12,
the Euler allocations' sum to the total, and a Bates profile at λ = 0 to
the Heston profile bit for bit.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy.stats import norm

from optionslab_tpu import risk as jr
from optionslab_tpu.models.bates import BatesParams as JBates
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu.models.local_vol import LocalVolSurface as JSurface
from optionslab_tpu.models.rbergomi import RBergomiParams as JRough
from optionslab_tpu_torch import risk as tr
from optionslab_tpu_torch.models.bates import BatesParams
from optionslab_tpu_torch.models.black_scholes import bs_greeks, bs_price
from optionslab_tpu_torch.models.heston import HestonParams, heston_price
from optionslab_tpu_torch.models.local_vol import LocalVolSurface
from optionslab_tpu_torch.models.rbergomi import RBergomiParams
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
CPU = dict(device="cpu")
V0 = float(bs_price(S, K, T, R, SIG, 1.0, 0.0))
HP = (0.04, 2.0, 0.04, 0.3, -0.7)


def _call(qty=1.0, strike=K, maturity=T, kind="call", und="UND", pkg=tr):
    return pkg.Position(quantity=qty, spot=S, strike=strike, maturity=maturity, rate=R, vol=SIG,
                        option_type=kind, underlying=und)


def _within(got, want, se, k=4.0, extra=0.0):
    got, want, se = (np.asarray(x, np.float64) for x in (got, want, se))
    assert np.all(np.abs(got - want) <= k * se + extra), (got, want, se)


def test_long_call_discounted_ee_is_flat_at_v0():
    prof = tr.exposure_profile([_call()], n_dates=12, n_paths=16384, **CPU)
    df = np.exp(-R * prof.dates)
    _within(prof.ee_discounted, V0, df * prof.ee_stderr)
    _within(prof.ee, V0 * np.exp(R * prof.dates), prof.ee_stderr)
    assert float(np.max(prof.ene)) < 1e-6


def test_forward_pfe_matches_lognormal_quantile():
    q = 0.95
    prof = tr.exposure_profile([_call(kind="forward")], n_dates=10, n_paths=16384, quantile=q,
                               seed=2, **CPU)
    t = prof.dates
    s_q = S * np.exp((R - 0.5 * SIG**2) * t + SIG * np.sqrt(t) * norm.ppf(q))
    _within(prof.pfe, np.maximum(s_q - K * np.exp(-R * (T - t)), 0.0), prof.pfe_stderr)
    assert prof.ene[-1] > 0.5 and prof.ee[-1] > 0.5


def test_flat_hazard_cva_closed_form_and_facade():
    lam, rec = 0.03, 0.4
    prof = tr.exposure_profile([_call()], n_dates=12, n_paths=16384, seed=4, **CPU)
    adj = tr.cva_dva(prof, hazard_rate=lam, recovery=rec, funding_spread=0.01)
    scale = (1.0 - rec) * (1.0 - np.exp(-lam * T))
    se = float(np.max(np.exp(-R * prof.dates) * prof.ee_stderr))
    _within(adj["cva"], scale * V0, scale * se)
    _within(adj["fva"], 0.01 * V0 * T, 0.01 * T * se, extra=0.01 * V0 * T / 12)  # trapezoid
    assert adj["fba"] == pytest.approx(0.0, abs=1e-6)
    assert adj["fca"] == pytest.approx(adj["fva"], rel=1e-9)
    pf = tr.OptionsPortfolio(**CPU)
    pf.add_position(_call(qty=2.0))
    pf.add_position(_call(qty=-1.0, strike=110.0, maturity=0.5, kind="put"))
    rep = tr.xva_report(pf, n_dates=8, n_paths=4096, own_hazard_rate=0.01, **CPU)
    assert rep["bcva"] == pytest.approx(rep["cva"] - rep["dva"])
    assert set(rep) == set(jr.xva_report([_call(pkg=jr)], n_dates=2, n_paths=256,
                                         own_hazard_rate=0.01))


def test_netting_collateral_and_mpor():
    book = [_call(qty=1.0), _call(qty=-1.0)]
    assert float(np.max(tr.exposure_profile(book, n_dates=6, n_paths=4096, **CPU).ee)) == 0.0
    gross = tr.exposure_profile(book, n_dates=6, n_paths=4096, netting=False, **CPU)
    assert float(np.min(gross.ee)) > 1.0
    coll = tr.exposure_profile([_call()], n_dates=6, n_paths=4096, collateral_threshold=0.0,
                               **CPU)
    assert float(np.max(coll.ee)) < 1e-5
    un = tr.exposure_profile([_call()], n_dates=12, n_paths=8192, seed=8, **CPU)
    lag = tr.exposure_profile([_call()], n_dates=12, n_paths=8192, seed=8,
                              collateral_threshold=0.0, mpor=2.0 / 12.0, **CPU)
    thr = tr.exposure_profile([_call()], n_dates=12, n_paths=8192, seed=8,
                              collateral_threshold=8.0, **CPU)
    assert 0.01 < lag.epe < 0.5 * un.epe and thr.epe < un.epe


def test_cva_dva_on_a_shared_profile_matches_reference():
    ref = jr.exposure_profile([_call(kind="forward", strike=S * np.exp(R * T), pkg=jr),
                               _call(qty=0.5, pkg=jr)], n_dates=8, n_paths=4096, seed=5)
    port = tr.ExposureResult.from_numpy({f.name: getattr(ref, f.name)
                                         for f in dataclasses.fields(ref)})
    kw = dict(hazard_rate=0.02, recovery=0.35, own_hazard_rate=0.015, own_recovery=0.45,
              funding_spread=0.012)
    got, want = tr.cva_dva(port, **kw), jr.cva_dva(ref, **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-15), k
    assert port.eepe == pytest.approx(ref.eepe, rel=1e-12)
    np.testing.assert_array_equal(port.effective_ee, ref.effective_ee)
    assert port.to_dict() == ref.to_dict()
    with pytest.raises(ValidationError):
        tr.cva_dva(port, 0.02, funding_spread=-0.01)


def test_two_underlyings_and_cva_allocation():
    corr = [[1.0, 0.5], [0.5, 1.0]]
    book = [_call(qty=2.0), _call(qty=-1.0, strike=110.0, maturity=0.8),
            _call(qty=1.0, strike=90.0, maturity=0.5, kind="put", und="B"),
            _call(qty=-0.5, kind="forward", und="B")]
    out = tr.cva_allocation(book, 0.02, n_dates=10, n_paths=8192, seed=1, corr=corr, **CPU)
    assert abs(sum(out["allocations"]) - out["total_cva"]) < 1e-9 * out["total_cva"]
    prof = tr.exposure_profile(book, n_dates=10, n_paths=8192, seed=1, corr=corr, **CPU)
    assert out["total_cva"] == pytest.approx(tr.cva_dva(prof, 0.02)["cva"], rel=1e-5)
    ref = jr.cva_allocation([_call(qty=2.0, pkg=jr), _call(qty=-1.0, strike=110.0, maturity=0.8,
                                                           pkg=jr),
                             _call(qty=1.0, strike=90.0, maturity=0.5, kind="put", und="B",
                                   pkg=jr), _call(qty=-0.5, kind="forward", und="B", pkg=jr)],
                            0.02, n_dates=10, n_paths=8192, seed=1, corr=corr)
    assert out["trades"] == ref["trades"]
    assert out["total_cva"] == pytest.approx(ref["total_cva"], rel=0.1)
    hedge = tr.cva_allocation([_call(), _call(qty=-0.5)], 0.02, method="incremental",
                              n_dates=8, n_paths=4096, seed=2, **CPU)
    assert hedge["allocations"][1] < 0 < hedge["allocations"][0]
    for bad in ([], [_call(und="X"), _call(und="Y")]):
        with pytest.raises(ValidationError):
            tr.cva_allocation(bad, 0.02, corr=[[1.0, 2.0], [2.0, 1.0]], **CPU)


def test_cva_greeks_and_wrong_way_risk():
    lam, rec = 0.03, 0.4
    g = tr.cva_greeks([_call()], lam, rec, n_dates=12, n_paths=16384, **CPU)
    scale = (1.0 - rec) * (1.0 - np.exp(-lam * T))
    bs = bs_greeks(S, K, T, R, SIG, 1.0, 0.0)
    assert g["cva"] == pytest.approx(scale * V0, rel=0.02)
    assert g["cva_delta"]["UND"] == pytest.approx(scale * float(bs["delta"]), rel=0.03)
    assert g["cva_vega"]["UND"] == pytest.approx(scale * float(bs["vega"]), rel=0.05)
    assert g["cva_hazard_sens"] == pytest.approx((1 - rec) * V0 * T * np.exp(-lam * T),
                                                 rel=0.03)
    w0 = tr.cva_wwr([_call()], lam, wwr_beta=0.0, n_dates=12, n_paths=8192, **CPU)
    assert w0["cva"] == w0["cva_beta0"] and w0["wwr_ratio"] == pytest.approx(1.0, abs=1e-6)
    w_put = tr.cva_wwr([_call(kind="put")], lam, wwr_beta=3.0, n_dates=12, n_paths=8192, **CPU)
    w_call = tr.cva_wwr([_call()], lam, wwr_beta=3.0, n_dates=12, n_paths=8192, **CPU)
    assert w_put["wwr_ratio"] > 1.1 and w_call["wwr_ratio"] < 0.9


def test_heston_exposure_long_call_is_flat_at_lewis():
    hp = HestonParams.make(*HP, dtype=torch.float64)
    prof = tr.heston_exposure_profile([_call()], hp, n_dates=8, n_paths=16384, **CPU)
    v0 = float(heston_price(ContractBatch.make(S, K, T, R, SIG, dtype=torch.float64), hp))
    df = np.exp(-R * prof.dates)
    _within(prof.ee_discounted, v0, df * prof.ee_stderr, extra=0.005 * v0)  # the table read
    book = [_call(), _call(qty=-1.0)]
    assert float(np.max(tr.heston_exposure_profile(book, hp, n_dates=4, n_paths=4096,
                                                   **CPU).ee)) == 0.0
    with pytest.raises(ValidationError):
        tr.heston_exposure_profile([_call(), _call(und="B")], hp, **CPU)


BOOK = (("asian_arith", 1.0, 100.0, "call", 0.0), ("barrier_up-and-out", 1.0, 100.0, "call",
                                                     125.0),
        ("lookback_fixed", -0.3, 105.0, "put", 0.0))
AMC_KW = dict(spot=S, rate=R, n_paths=16384, n_dates=6, n_sub=4, seed=3)


def _amc_book(pkg, book=BOOK):
    return [pkg.ExoticPosition(kind=k, quantity=q, strike=s, option_type=o, barrier=b)
            for k, q, s, o, b in book]


def _flat(pkg):
    k = np.linspace(-3.0, 3.0, 11)
    t = np.linspace(0.01, 2.0, 9)
    if pkg is tr:
        return LocalVolSurface(k, t, np.full((9, 11), 0.2), S, R, device="cpu")
    return JSurface(np.asarray(k, np.float32), np.asarray(t, np.float32),
                    np.full((9, 11), 0.2, np.float32), S, R)


DYNAMICS = {
    "bs": lambda pkg: {},
    "heston": lambda pkg: {"heston_params": (HestonParams if pkg is tr else JHeston).make(*HP)},
    "bates": lambda pkg: {"heston_params": (BatesParams if pkg is tr else JBates).make(
        *HP, lam=0.6, mu_j=-0.1, sigma_j=0.15)},
    "slv": lambda pkg: {"heston_params": (HestonParams if pkg is tr else JHeston).make(
        0.04, 2.0, 0.04, 0.5, -0.7), "dupire": _flat(pkg), "mixing": 0.5},
    "rbergomi": lambda pkg: {"rbergomi_params": (RBergomiParams if pkg is tr else JRough)()},
}


@pytest.mark.parametrize("model", sorted(DYNAMICS))
def test_amc_profile_matches_reference(model):
    port = tr.amc_exposure_profile(_amc_book(tr), **AMC_KW, **DYNAMICS[model](tr), **CPU)
    ref = jr.amc_exposure_profile(_amc_book(jr), **AMC_KW, **DYNAMICS[model](jr))
    np.testing.assert_allclose(port.dates, ref.dates, rtol=1e-6)
    assert port.n_paths == ref.n_paths == 8192
    comb = math.sqrt(2.0)
    _within(port.ee, ref.ee, comb * port.ee_stderr)
    _within(port.pfe, ref.pfe, comb * port.pfe_stderr, extra=1e-6)


def test_amc_barrier_in_plus_out_is_the_vanilla():
    """The hit state routes each path to exactly one of the two marks: the
    in and out profiles add up to the closed-form vanilla's."""
    pair = (("barrier_up-and-in", 1.0, 100.0, "call", 120.0),
            ("barrier_up-and-out", 1.0, 100.0, "call", 120.0))
    amc = tr.amc_exposure_profile(_amc_book(tr, pair), spot=S, rate=R, n_paths=16384,
                                  n_dates=6, n_sub=4, **CPU)
    cf = tr.exposure_profile([_call()], horizon=1.0, n_dates=6, n_paths=16384, seed=7, **CPU)
    _within(amc.ee, cf.ee, np.hypot(amc.ee_stderr, cf.ee_stderr))


def test_amc_bates_at_zero_intensity_is_heston_bit_for_bit():
    book = _amc_book(tr, BOOK[:2])
    kw = dict(spot=S, rate=R, n_paths=4096, n_dates=4, n_sub=4, **CPU)
    a = tr.amc_exposure_profile(book, heston_params=HestonParams.make(*HP), **kw)
    b = tr.amc_exposure_profile(book, heston_params=BatesParams.make(*HP, lam=0.0), **kw)
    for f in ("ee", "ee_discounted", "ene", "pfe"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_amc_validation_and_dynamics_kwargs():
    for bad in (dict(book=[]), dict(book=[tr.ExoticPosition(kind="rainbow")]),
                dict(book=[tr.ExoticPosition(kind="barrier_up-and-out")]),
                dict(book=[tr.ExoticPosition()], n_paths=12345),
                dict(book=[tr.ExoticPosition()], dupire=object()),
                dict(book=[tr.ExoticPosition()], rbergomi_params=RBergomiParams(),
                     heston_params=HestonParams.make())):
        with pytest.raises(ValidationError):
            tr.amc_exposure_profile(**bad, **CPU)
    for model, kw in (("garch", {}), ("bates", {"heston_params": {"v0": 0.05}}),
                      ("heston", {"mixing": 0.5})):
        with pytest.raises(ValidationError):
            tr.amc_dynamics_kwargs(model, spot=S, rate=R, vol=SIG, **kw, **CPU)
    dyn = tr.amc_dynamics_kwargs("slv", spot=S, rate=R, vol=SIG, mixing=0.3,
                                 heston_params={"sigma": 0.4}, **CPU)
    assert dyn["mixing"] == 0.3 and float(dyn["heston_params"].sigma) == pytest.approx(0.4)
    assert tr.amc_dynamics_kwargs("bs", spot=S, rate=R, vol=SIG) == {}


def _v0(model) -> float:
    """The time-0 price of the long ATM put under each model's oracle
    dynamics: Black–Scholes (GBM; SLV on a flat surface at mixing 0; rough
    Bergomi at η → 0, vol √ξ0), Lewis for Heston and Bates."""
    b = ContractBatch.make(S, K, T, R, SIG, "put", dtype=torch.float64)
    if model == "heston":
        return float(heston_price(b, HestonParams.make(*HP, dtype=torch.float64)))
    if model == "bates":
        from optionslab_tpu_torch.models.bates import bates_price

        return float(bates_price(b, BatesParams.make(*HP, lam=0.6, mu_j=-0.1, sigma_j=0.15,
                                                     dtype=torch.float64)))
    return float(bs_price(S, K, T, R, SIG, -1.0, 0.0))


ORACLE_DYNAMICS = {**DYNAMICS,
                   "slv": lambda pkg: {**DYNAMICS["slv"](pkg), "mixing": 0.0},
                   "rbergomi": lambda pkg: {"rbergomi_params": RBergomiParams(eta=1e-6)}}


@pytest.mark.parametrize("model", sorted(ORACLE_DYNAMICS))
def test_amc_long_put_martingale_oracle(model):
    """A long option's discounted AMC mark averages to its time-0 price at
    every date (the out-of-sample split keeps the regression's positive-part
    bias at the basis residual: 2% of the price allowed beside 4 stderr)."""
    prof = tr.amc_exposure_profile([tr.ExoticPosition(option_type="put")], **AMC_KW,
                                   **ORACLE_DYNAMICS[model](tr), **CPU)
    v0 = _v0(model)
    _within(prof.ee_discounted, v0, np.exp(-R * prof.dates) * prof.ee_stderr, extra=0.02 * v0)
