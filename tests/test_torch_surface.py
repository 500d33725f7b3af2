"""The port's parametric surfaces (``optionslab_tpu_torch/surface``: SVI, SSVI,
eSSVI, the arbitrage checks and repairs, the surface-model base and the
features) against ``optionslab_tpu.surface`` on the same inputs, on the CPU.

The closed forms run in float64 on both sides and agree to 1e-12 relative;
the pieces the reference computes in float32 (the SVI warm start, the loss
and its gradient, the fits) are compared with the reference pinned to
float32 (``jax.enable_x64(False)``: ``tests/conftest.py`` turns x64 on), to
1e-6 relative where nothing iterates and to stated bounds after Adam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from optionslab_tpu.surface import arbitrage as jarb
from optionslab_tpu.surface import base as jbase
from optionslab_tpu.surface import essvi as jes
from optionslab_tpu.surface import features as jfeat
from optionslab_tpu.surface import svi as jsvi
from optionslab_tpu_torch.data import ColumnTable
from optionslab_tpu_torch.surface import arbitrage as tarb
from optionslab_tpu_torch.surface import base as tbase
from optionslab_tpu_torch.surface import essvi as tes
from optionslab_tpu_torch.surface import features as tfeat
from optionslab_tpu_torch.surface import svi as tsvi
from optionslab_tpu_torch.utils.exceptions import DataError, ModelError, ValidationError

CPU = "cpu"
F64 = dict(dtype=torch.float64, device=CPU)


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


def _eq(port, ref, rtol=1e-12, atol=1e-14):
    np.testing.assert_allclose(_num(port), np.asarray(ref), rtol=rtol, atol=atol)


RNG = np.random.default_rng(7)
SVI_DRAWS = [dict(a=RNG.uniform(-0.01, 0.05), b=RNG.uniform(0.02, 0.4),
                  rho=RNG.uniform(-0.9, 0.5), m=RNG.uniform(-0.2, 0.2),
                  sigma=RNG.uniform(0.05, 0.5)) for _ in range(4)]
K = np.linspace(-1.2, 1.0, 57)


def _svi_pair(d):
    return (jsvi.SVIParams.make(**d, dtype=jnp.float64),
            tsvi.SVIParams.make(**d, dtype=torch.float64, device=CPU))


@pytest.mark.parametrize("i", range(len(SVI_DRAWS)))
def test_svi_closed_forms_match_reference(i):
    jp, tp = _svi_pair(SVI_DRAWS[i])
    kt = torch.tensor(K, **F64)
    _eq(tsvi.svi_total_variance(kt, tp), jsvi.svi_total_variance(K, jp))
    _eq(tsvi.svi_implied_vol(kt, 0.7, tp), jsvi.svi_implied_vol(K, 0.7, jp))
    for a, b in zip(tsvi.svi_derivatives(kt, tp), jsvi.svi_derivatives(K, jp)):
        _eq(a, b)
    _eq(tsvi.svi_g(kt, tp), jsvi.svi_g(K, jp), atol=1e-12)
    jq, tq = _svi_pair({**SVI_DRAWS[i], "a": SVI_DRAWS[i]["a"] + 0.01})
    _eq(tsvi.svi_local_variance(kt, 0.5, tp, tq, 0.25),
        jsvi.svi_local_variance(K, 0.5, jp, jq, 0.25), atol=1e-12)
    assert tsvi.check_butterfly(tp, kt) == jsvi.check_butterfly(jp, K)


@pytest.mark.parametrize("rho,eta,gamma", [(-0.3, 1.0, 0.5), (-0.7, 1.1, 0.3), (0.2, 0.6, 0.8)])
def test_ssvi_and_essvi_closed_forms_match_reference(rho, eta, gamma):
    jp = jsvi.SSVIParams.make(rho, eta, gamma, dtype=jnp.float64)
    tp = tsvi.SSVIParams.make(rho, eta, gamma, dtype=torch.float64, device=CPU)
    th = np.array([0.01, 0.04, 0.09])[:, None]
    kt, tht = torch.tensor(K, **F64), torch.tensor(th, **F64)
    _eq(tsvi.ssvi_total_variance(kt, tht, tp), jsvi.ssvi_total_variance(K, th, jp))
    _eq(tsvi.ssvi_implied_vol(kt, tht, 0.5, tp), jsvi.ssvi_implied_vol(K, th, 0.5, jp))
    theta, r, psi = np.array([0.02, 0.05, 0.1]), np.array([rho, rho / 2, -0.1]), \
        np.array([0.1, 0.2, 0.35]) * eta
    args_j = (K[None, :], theta[:, None], r[:, None], psi[:, None])
    args_t = tuple(torch.tensor(a, **F64) for a in args_j)
    _eq(tes.essvi_total_variance(*args_t), jes.essvi_total_variance(*args_j))
    for a, b in zip(tes.essvi_derivatives(*args_t), jes.essvi_derivatives(*args_j)):
        _eq(a, b, atol=1e-12)
    _eq(tes.essvi_g(*args_t), jes.essvi_g(*args_j), atol=1e-12)


def test_params_validate_and_carry_across():
    with pytest.raises(ValidationError):
        tsvi.SVIParams.make(b=-0.1, device=CPU).validate()
    with pytest.raises(ValidationError):
        tsvi.SVIParams.make(a=-1.0, device=CPU).validate()
    with pytest.raises(ValidationError):
        tsvi.SSVIParams.make(eta=3.0, device=CPU).validate()
    with pytest.raises(ValidationError):
        tes.ESSVIParams.make([0.04, 0.02], [0.1, 0.1], [0.2, 0.3], device=CPU).validate()
    tsvi.SVIParams.make(device=CPU).validate()
    tsvi.SSVIParams.make(device=CPU).validate()
    jp = jsvi.SVIParams.make(**SVI_DRAWS[0])
    tp = tsvi.SVIParams.from_numpy(*(np.asarray(getattr(jp, f)) for f in tsvi.SVI_FIELDS),
                                   device=CPU)
    assert all(float(getattr(tp, f)) == float(getattr(jp, f)) for f in tsvi.SVI_FIELDS)
    assert tp.a.dtype == torch.float32
    e = tes.ESSVIParams.from_numpy([0.02, 0.05], [-0.3, -0.2], [0.1, 0.2], device=CPU)
    assert e.n_slices == 2 and e.theta.dtype == torch.float32


def _noisy_smile(seed, t=0.5):
    rng = np.random.default_rng(seed)
    k = np.sort(rng.uniform(-0.35, 0.3, 24))
    iv = 0.2 - 0.12 * k + 0.2 * k * k + rng.normal(0.0, 0.003, k.size)
    return k.astype(np.float32), (iv * iv * t).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quasi_explicit_init_winner_matches_reference(seed):
    """The warm start on float32 quotes: the reference with x64 on searches
    its grid in float64 (the grid constants promote), as the port does."""
    k, w = _noisy_smile(seed)
    want = np.asarray(jsvi._svi_quasi_explicit_init(jnp.asarray(k), jnp.asarray(w)))
    assert want.dtype == np.float64
    got = tsvi._svi_quasi_explicit_init(torch.tensor(k), torch.tensor(w))
    _eq(got, want, rtol=1e-6, atol=1e-9)


def test_svi_loss_and_gradient_match_reference():
    k, w = _noisy_smile(5)
    x = np.array([0.01, -1.2, -0.5, 0.05, -1.5], np.float32)
    k_dense = np.linspace(k.min() - 0.3, k.max() + 0.3, 101).astype(np.float32)
    w_scale = np.float32(np.mean(w) ** 2)
    with jax.enable_x64(False):
        args = (jnp.asarray(k), jnp.asarray(w), jnp.asarray(k_dense), jnp.float32(w_scale),
                jnp.float32(10.0))
        # a large penalty point too: b·σ small, a negative
        xs = [x, np.array([-0.05, -3.0, 0.3, 0.0, -4.0], np.float32)]
        want = [jax.value_and_grad(jsvi._svi_loss)(jnp.asarray(xi), *args) for xi in xs]
    targs = (torch.tensor(k), torch.tensor(w), torch.tensor(k_dense), torch.tensor(w_scale),
             torch.tensor(10.0))
    for xi, (lw, gw) in zip(xs, want):
        xt = torch.tensor(xi, requires_grad=True)
        loss = tsvi._svi_loss(xt, *targs)
        (g,) = torch.autograd.grad(loss, xt)
        _eq(loss, lw, rtol=1e-6)
        _eq(g, gw, rtol=1e-5, atol=1e-6 * float(np.max(np.abs(gw))))


def test_svi_fit_matches_reference():
    k, w = _noisy_smile(11, t=1.0)
    with jax.enable_x64(False):
        jp, jl = jsvi.calibrate_svi(k, w, n_steps=300)
    tp, tl = tsvi.calibrate_svi(k, w, n_steps=300, device=CPU)
    kt = torch.tensor(k)
    # 400 Adam steps from warm starts that differ in the last float32 bits
    _eq(tsvi.svi_total_variance(kt, tp), jsvi.svi_total_variance(k, jp), rtol=2e-3)
    assert tl == pytest.approx(jl, rel=0.05, abs=1e-7)
    model = tsvi.SVIModel(device=CPU)
    model.calibrate(k, np.sqrt(w), 1.0, n_steps=300)
    assert model.is_butterfly_free()
    _eq(model.smile(kt, 1.0), np.sqrt(np.asarray(jsvi.svi_total_variance(k, jp))), rtol=1e-3)


def test_ssvi_and_surface_fits_match_reference():
    k = np.linspace(-0.4, 0.4, 15)
    ts = np.array([0.25, 0.75, 1.5])
    iv = 0.2 - 0.1 * k[None, :] + 0.15 * k[None, :] ** 2 + 0.03 * np.sqrt(ts[:, None])
    th = (0.2 + 0.03 * np.sqrt(ts)) ** 2 * ts
    w = iv * iv * ts[:, None]
    kk = np.broadcast_to(k, w.shape)
    with jax.enable_x64(False):
        jp, jl = jsvi.calibrate_ssvi(kk, th, w, n_steps=300)
        jlist, jrep = jsvi.calibrate_svi_surface(k, ts, iv, n_steps=100)
    tp, tl = tsvi.calibrate_ssvi(kk, th, w, n_steps=300, device=CPU)
    for f in ("rho", "eta", "gamma"):
        assert float(getattr(tp, f)) == pytest.approx(float(getattr(jp, f)), abs=2e-4)
    tlist, trep = tsvi.calibrate_svi_surface(k, ts, iv, n_steps=100, device=CPU)
    assert trep["butterfly_free"] == jrep["butterfly_free"]
    assert trep["arbitrage_free"] == jrep["arbitrage_free"]
    assert trep["calendar_violation_rate"] == jrep["calendar_violation_rate"]
    for a, b in zip(tlist, jlist):
        _eq(tsvi.svi_total_variance(torch.tensor(k, dtype=torch.float32), a),
            jsvi.svi_total_variance(k.astype(np.float32), b), rtol=1e-3, atol=1e-6)
    model = tsvi.SSVIModel(tp)
    _eq(model.implied_vol(torch.tensor(k, **F64), th[1], ts[1]),
        jsvi.ssvi_implied_vol(k, th[1], ts[1], jp), rtol=1e-3)


def _surface_with_violations():
    k = np.linspace(-0.5, 0.5, 21)
    t = np.array([0.25, 0.5, 1.0, 1.5])
    iv = 0.2 - 0.1 * k[None, :] + 0.1 * k[None, :] ** 2 + 0.0 * t[:, None]
    iv[2] *= 0.6  # a calendar violation: the 1y slice below the 6m one
    iv[1, 9:12] += np.array([0.03, -0.04, 0.03])  # a saw-tooth: butterfly violations
    return k, t, iv


def test_arbitrage_checks_match_reference():
    k, t, iv = _surface_with_violations()
    w = iv * iv * t[:, None]
    kt, wt, tt = (torch.tensor(a, **F64) for a in (k, w, t))
    for i in range(len(t)):
        g, m = tarb.butterfly_check(kt, wt[i])
        gj, mj = jarb.butterfly_check(k, w[i])
        _eq(g, gj, atol=1e-12)
        assert np.array_equal(_num(m), np.asarray(mj))
    dw, cal = tarb.calendar_check(tt, wt)
    dwj, calj = jarb.calendar_check(t, w)
    _eq(dw, dwj)
    assert np.array_equal(_num(cal), np.asarray(calj)) and _num(cal).any()
    rep = tarb.surface_arbitrage_report(k, t, iv, device=CPU)
    want = jarb.surface_arbitrage_report(k, t, iv)
    assert rep["arbitrage_free"] is want["arbitrage_free"] is False
    for key in ("calendar_violation_rate", "butterfly_violation_rate"):
        assert rep[key] == pytest.approx(want[key], rel=1e-7)  # the reference's float32 mean
    masks, want_masks = (tarb.detect_arbitrage_violations(k, t, iv, device=CPU),
                         jarb.detect_arbitrage_violations(k, t, iv))
    for key in ("calendar", "butterfly"):
        assert np.array_equal(masks[key], np.asarray(want_masks[key]))
    m = np.array([0.1, 0.8, 1.0, 1.2, 6.0])
    assert tarb.validate_domain(m, [0.5, 1, 2, 40, 1], [0.2, np.nan, 0.3, 4.0, 0.2]) == \
        jarb.validate_domain(m, [0.5, 1, 2, 40, 1], [0.2, np.nan, 0.3, 4.0, 0.2])


def test_projections_match_reference():
    rng = np.random.default_rng(3)
    y = np.cumsum(rng.normal(0.0, 1.0, 40))
    wts = rng.uniform(0.5, 2.0, 40)
    _eq(tarb.isotonic_pava(y), jarb.isotonic_pava(y))
    _eq(tarb.isotonic_pava(y, wts), jarb.isotonic_pava(y, wts))
    v = rng.normal(0.0, 1.0, (3, 33)) + np.linspace(-1, 1, 33) ** 2
    got = tarb.enforce_convexity(torch.tensor(v, **F64), 200)
    for i in range(3):  # bit for bit: the same minimum of the same chord
        assert np.array_equal(_num(got[i]), np.asarray(jarb.enforce_convexity(v[i], 200)))
    k, t, iv = _surface_with_violations()
    _eq(tarb.enforce_calendar(iv * iv * t[:, None]),
        jarb.enforce_calendar(iv * iv * t[:, None]))
    fixed = tarb.correct_arbitrage(k, t, iv, device=CPU)
    _eq(fixed, jarb.correct_arbitrage(k, t, iv))
    assert not tarb.detect_arbitrage_violations(k, t, fixed, device=CPU)["calendar"].any()


def test_essvi_report_and_iv_fn_match_reference():
    theta, rho, psi = [0.01, 0.03, 0.06], [-0.5, -0.4, -0.3], [0.08, 0.12, 0.18]
    expiries = [0.25, 0.75, 1.5]
    with jax.enable_x64(False):
        jp = jes.ESSVIParams.make(theta, rho, psi)
        want = jes.essvi_report(jp, -1.0, 1.0, 101)
        j_iv = jes.essvi_surface_iv_fn(jp, expiries)
        kq = np.linspace(-0.5, 0.5, 7, dtype=np.float32)
        tq = np.array([0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0], np.float32)
        want_iv = np.asarray(j_iv(kq[:, None], tq[None, :]))
    tp = tes.ESSVIParams.make(theta, rho, psi, device=CPU)
    got = tes.essvi_report(tp, -1.0, 1.0, 101)
    assert got["butterfly_free"] == want["butterfly_free"]
    assert got["arbitrage_free"] == want["arbitrage_free"]
    assert got["min_g"] == pytest.approx(want["min_g"], rel=1e-6)
    t_iv = tes.essvi_surface_iv_fn(tp, expiries)
    _eq(t_iv(torch.tensor(kq)[:, None], torch.tensor(tq)[None, :]), want_iv, rtol=1e-6)


def test_essvi_fit_matches_reference():
    rng = np.random.default_rng(4)
    ts = [0.2, 0.6, 1.2]
    ks = [np.sort(rng.uniform(-0.3, 0.3, 20)) for _ in ts]
    ws = [(0.2 - 0.1 * k + 0.15 * k * k + rng.normal(0.0, 0.002, k.size)) ** 2 * t
          for k, t in zip(ks, ts)]
    with jax.enable_x64(False):
        jp, jl = jes.calibrate_essvi(ks, ws, n_steps=400)
    tp, tl = tes.calibrate_essvi(ks, ws, n_steps=400, device=CPU)
    for f in ("theta", "rho", "psi"):
        _eq(getattr(tp, f), getattr(jp, f), rtol=2e-3, atol=2e-4)
    assert tl == pytest.approx(jl, rel=0.05)


def test_base_scaler_metrics_and_features_match_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(0.0, 2.0, (50, 3))
    x[:, 2] = 1.5  # a constant column: scale 1
    s, sj = tbase.StandardScaler().fit(x), jbase.StandardScaler().fit(x)
    _eq(s.transform(x), sj.transform(x))
    _eq(s.inverse_transform(s.transform(x)), x)
    with pytest.raises(ModelError):
        tbase.StandardScaler().transform(x)
    y, yp = rng.uniform(0.1, 0.4, 30), rng.uniform(0.1, 0.4, 30)
    got, want = tbase.regression_metrics(y, yp), jbase.regression_metrics(y, yp)
    assert got.keys() == want.keys() and all(got[k] == pytest.approx(want[k], rel=1e-12)
                                             for k in got)
    n = 45
    cols = {"underlying_price": np.full(n, 100.0), "strike_price": rng.uniform(80, 120, n),
            "time_to_maturity": rng.uniform(0.1, 2.0, n), "risk_free_rate": np.full(n, 0.03),
            "historical_volatility": rng.uniform(0.15, 0.25, n)}
    cols["historical_volatility"][[3, 30]] = np.nan
    want = jfeat.engineer_features(pd.DataFrame(cols))
    for frame in (pd.DataFrame(cols), ColumnTable(cols)):
        got = tfeat.engineer_features(frame)
        for c in tbase.FEATURE_COLUMNS:
            _eq(np.asarray(got[c], np.float64), want[c].to_numpy(np.float64), atol=1e-15)
    with pytest.raises(DataError):
        tfeat.engineer_features(ColumnTable({"strike_price": [1.0]}))
    table = ColumnTable({**cols, "implied_volatility": np.full(n, 0.2)})
    table["historical_volatility"] = np.full(n, 0.2)
    tbase.validate_features(tfeat.engineer_features(table), tbase.FEATURE_COLUMNS)
    table["bad"] = np.array(["x"] * n, dtype=object)
    with pytest.raises(DataError):
        tbase.validate_features(table, ["bad"])


class _Mean(tbase.VolatilityModelBase):
    def _train_impl(self, df, **kw):
        self.level = float(np.mean(np.asarray(df[tbase.TARGET_COLUMN])))
        self._features_matrix(df, fit_scaler=True)
        return {"level": self.level}

    def _predict_impl(self, df):
        return np.full(len(df[self.feature_columns[0]]), self.level)

    def _state(self):
        return {"level": np.array(self.level)}, {"kind": "mean"}

    def _load_state(self, arrays, meta):
        self.level = float(arrays["level"])


def test_model_base_lifecycle_and_persistence(tmp_path):
    rng = np.random.default_rng(9)
    n = 30
    cols = {c: rng.uniform(0.5, 1.5, n) for c in tbase.FEATURE_COLUMNS}
    cols[tbase.TARGET_COLUMN] = rng.uniform(0.15, 0.25, n)
    m = _Mean()
    with pytest.raises(ModelError):
        m.predict_volatility(ColumnTable(cols))
    m.train(ColumnTable(cols))
    rmse = m.evaluate(ColumnTable(cols))["rmse"]
    assert rmse == pytest.approx(np.std(cols["implied_volatility"]))
    m.save_model(tmp_path / "mean")
    back = _Mean().load_model(tmp_path / "mean")
    assert back.level == m.level and back.is_trained
    _eq(back.scaler.mean_, m.scaler.mean_)
    assert set(m.get_benchmark_timings()) == {"train", "predict"}
