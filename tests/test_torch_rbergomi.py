"""The port's rough Bergomi (``optionslab_tpu_torch/models/rbergomi.py`` and
``rbergomi_american.py``) against ``optionslab_tpu.models.rbergomi`` and
``rbergomi_american``.

* The host covariance, both Cholesky factors and the m-feature readout
  matrix are the reference's numpy arithmetic: equal exactly.
* Fed the reference's own normals (drawn from its keys as it draws them),
  the terminal spots, the path matrix behind every exotic kind, the causal
  date simulation and the in-graph chain simulation agree with the
  reference to float32 matmul tolerance (1e-5 relative; the chain's float32
  Cholesky to 1e-4), and the pathwise Greeks (autograd against
  ``jax.grad``) to 1e-4 relative plus 1e-4 absolute.
* Drawing from their own generators, prices, exotic prices and the bracket's
  bounds (on the reference's own policy and surface, carried across by
  ``RBergomiPolicy.from_numpy``) agree with the reference's within 4
  combined standard errors.
* Then oracles of ``tests/test_rbergomi.py`` and
  ``tests/test_rbergomi_american.py`` at small sizes (η → 0 is Black–Scholes,
  E[v_t] = ξ0, the η → 0 bracket overlaps the GBM certificate), the
  calibration's loss falling, and the full-float32 matmul check.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import rbergomi as jr
from optionslab_tpu.models import rbergomi_american as jra
from optionslab_tpu_torch.models import rbergomi as tr
from optionslab_tpu_torch.models import rbergomi_american as tra
from optionslab_tpu_torch.models.american import american_price_interval
from optionslab_tpu_torch.models.black_scholes import bs_price


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HP = (0.1, 1.9, -0.9, 0.04)  # hurst, eta, rho, xi0
JPAR, TPAR = jr.RBergomiParams(*HP), tr.RBergomiParams(*HP)
F32 = jnp.float32


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ref_normals(key, n_paths, n):
    """(z, zp) as the reference draws them from ``key``, antithetic."""
    k1, k2 = jax.random.split(key)
    half = n_paths // 2
    z = jax.random.normal(k1, (half, 2 * n), F32)
    zp = jax.random.normal(k2, (half, n), F32)
    z, zp = jnp.concatenate([z, -z]), jnp.concatenate([zp, -zp])
    return z, zp, torch.tensor(np.asarray(z)), torch.tensor(np.asarray(zp))


def _within(got, want, n_se=4.0):
    assert abs(got[0] - want[0]) < n_se * math.hypot(got[1], want[1]), (got, want)


# ---------------------------------------------------------------------------
# Host factors and fed normals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,h,t", [(8, 0.1, 1.0), (12, 0.35, 0.5)])
def test_host_factors_equal_reference(n, h, t):
    np.testing.assert_array_equal(tr._volterra_cov_host(n, h, t), jr._volterra_cov_host(n, h, t))
    np.testing.assert_array_equal(tr._volterra_chol(n, h, t), jr._volterra_chol(n, h, t))
    lc = tr._volterra_chol_causal(n, h, t)
    np.testing.assert_array_equal(lc, jr._volterra_chol_causal(n, h, t))
    np.testing.assert_array_equal(tra._m_readout_matrix(lc, n // 2, 2),
                                  jra._m_readout_matrix(lc, n // 2, 2))


def test_terminal_spots_on_reference_normals():
    key = jax.random.PRNGKey(0)
    _, _, z, zp = _ref_normals(key, 2000, 16)
    args = (100.0, 0.03, 0.01, 0.04, 1.9, -0.9)
    with jax.enable_x64(False):
        want = np.asarray(jr._terminal_spots(*(F32(a) for a in args), hurst=0.1, maturity=1.0,
                                             key=key, n_paths=2000, n_steps=16))
    got = tr._terminal_spots(*(torch.tensor(a) for a in args), hurst=0.1, maturity=1.0, z=z,
                             zp=zp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_pathwise_greeks_on_reference_normals():
    key = jax.random.PRNGKey(1)
    _, _, z, zp = _ref_normals(key, 4000, 8)
    args = (100.0, 0.03, 0.01, 0.04, 1.9, -0.9)

    def jprice(*a):
        st = jr._terminal_spots(*a, hurst=0.1, maturity=1.0, key=key, n_paths=4000, n_steps=8)
        return jnp.exp(-a[1]) * jnp.maximum(st - 100.0, 0.0).mean()

    with jax.enable_x64(False):
        want = jax.grad(jprice, argnums=tuple(range(6)))(*(F32(a) for a in args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    st = tr._terminal_spots(*leaves, hurst=0.1, maturity=1.0, z=z, zp=zp)
    got = torch.autograd.grad(torch.exp(-leaves[1]) * torch.clamp_min(st - 100.0, 0.0).mean(),
                              leaves)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("kind", jr.RBERGOMI_EXOTIC_KINDS)
def test_exotic_payoffs_on_reference_normals(kind):
    key = jax.random.PRNGKey(2)
    _, _, z, zp = _ref_normals(key, 2000, 8)
    barrier = (85.0, 115.0) if "double" in kind else (110.0 if "up" in kind else 90.0)
    strike = 105.0 if kind == "range_accrual" else 100.0
    jb = tuple(F32(b) for b in barrier) if "double" in kind else F32(barrier)
    with jax.enable_x64(False):
        want = jr._rbergomi_exotic_core(kind, F32(100.0), F32(strike), 1.0, F32(0.03), F32(0.0),
                                        -1.0, jb, F32(0.04), F32(1.9), F32(-0.9), 0.1, key, 2000,
                                        8, True)
    got = tr._rbergomi_exotic_core(kind, torch.tensor(100.0), strike, 1.0, torch.tensor(0.03),
                                   torch.tensor(0.0), -1.0, barrier, torch.tensor(0.04),
                                   torch.tensor(1.9), torch.tensor(-0.9), 0.1, z, zp, True)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-6)


def test_exotic_greeks_on_reference_normals():
    key = jax.random.PRNGKey(3)
    _, _, z, zp = _ref_normals(key, 2000, 8)

    def jprice(s0, r, xi0, eta, rho):
        return jr._rbergomi_exotic_core("asian_arith", s0, F32(100.0), 1.0, r, F32(0.0), 1.0,
                                        F32(0.0), xi0, eta, rho, 0.1, key, 2000, 8, False)

    args = (100.0, 0.03, 0.04, 1.9, -0.9)
    with jax.enable_x64(False):
        want = jax.grad(jprice, argnums=tuple(range(5)))(*(F32(a) for a in args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    price = tr._rbergomi_exotic_core("asian_arith", leaves[0], 100.0, 1.0, leaves[1],
                                     torch.tensor(0.0), 1.0, 0.0, *leaves[2:], 0.1, z, zp, False)
    for g, w in zip(torch.autograd.grad(price, leaves), want):
        assert float(g) == pytest.approx(float(w), rel=1e-4, abs=1e-4)


def test_date_simulation_on_reference_normals():
    key = jax.random.PRNGKey(4)
    n_dates, n_sub = 4, 2
    _, _, e, zp = _ref_normals(key, 1000, n_dates * n_sub)
    with jax.enable_x64(False):
        want = jra._simulate_dates(key, F32(100.0), F32(1.9), F32(-0.9), F32(0.04), F32(0.05),
                                   hurst=0.1, maturity=1.0, n_dates=n_dates, n_sub=n_sub,
                                   n_paths=1000)
    got = tra._simulate_dates(e, zp, 100.0, 1.9, -0.9, 0.04, 0.05, hurst=0.1, maturity=1.0,
                              n_dates=n_dates, n_sub=n_sub)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_chain_simulation_and_hurst_gradient_on_reference_normals():
    t_grid, idx = jr._chain_grid([0.1, 0.3], 0.05, 4)
    np.testing.assert_array_equal(tr._chain_grid([0.1, 0.3], 0.05, 4)[0], t_grid)
    key = jax.random.PRNGKey(5)
    jz, jzp, z, zp = _ref_normals(key, 2000, len(t_grid))
    col = idx[0.3]

    def jput(h):
        x = jr._volterra_logs_dynamic(jnp.asarray(t_grid), h, F32(1.9), F32(-0.9), F32(0.04),
                                      F32(0.0), F32(0.0), jz, jzp)
        return jnp.maximum(95.0 - 100.0 * jnp.exp(x[:, col]), 0.0).mean()

    with jax.enable_x64(False):
        want, want_g = jax.value_and_grad(jput)(F32(0.1))
        cov = np.asarray(jr._volterra_cov_dynamic(jnp.asarray(t_grid), F32(0.1)))
    h = torch.tensor(0.1, requires_grad=True)
    tg = torch.tensor(t_grid)
    np.testing.assert_allclose(tr._volterra_cov_dynamic(tg, torch.tensor(0.1)).numpy(), cov,
                               rtol=1e-5, atol=1e-6)
    x = tr._volterra_logs_dynamic(tg, h, torch.tensor(1.9), torch.tensor(-0.9),
                                  torch.tensor(0.04), torch.tensor(0.0), torch.tensor(0.0), z, zp)
    put = torch.clamp_min(95.0 - 100.0 * torch.exp(x[:, col]), 0.0).mean()
    (g,) = torch.autograd.grad(put, h)
    assert float(put) == pytest.approx(float(want), rel=1e-4)
    assert float(g) == pytest.approx(float(want_g), rel=1e-3, abs=1e-3)


# ---------------------------------------------------------------------------
# Own generators: statistical agreement with the reference
# ---------------------------------------------------------------------------
def test_prices_agree_with_reference():
    ks = [90.0, 100.0, 110.0]
    want = jr.rbergomi_price(100.0, ks, 1.0, 0.03, JPAR, jax.random.PRNGKey(0), n_paths=20_000,
                             n_steps=16)
    got = tr.rbergomi_price(100.0, ks, 1.0, 0.03, TPAR, _gen(0), n_paths=20_000, n_steps=16)
    for i in range(3):
        _within((float(got[0][i]), float(got[1][i])),
                (float(want[0][i]), float(want[1][i])))


@pytest.mark.parametrize("kind", ["asian_arith", "barrier_up-and-out", "one_touch_down_hit",
                                  "cliquet", "autocall"])
def test_exotics_agree_with_reference(kind):
    kw = dict(n_paths=20_000, n_steps=16, return_stderr=True)
    if kind == "cliquet":
        want = jr.rbergomi_cliquet_price(100.0, 1.0, 0.03, JPAR, jax.random.PRNGKey(1),
                                         n_periods=4, **kw)
        got = tr.rbergomi_cliquet_price(100.0, 1.0, 0.03, TPAR, _gen(1), n_periods=4, **kw)
    elif kind == "autocall":
        want = jr.rbergomi_autocall_price(100.0, 1.0, 0.03, JPAR, jax.random.PRNGKey(1), **kw)
        got = tr.rbergomi_autocall_price(100.0, 1.0, 0.03, TPAR, _gen(1), **kw)
    else:
        b = 120.0 if "up" in kind else 85.0
        want = jr.rbergomi_exotic_price(kind, 100.0, 100.0, 1.0, 0.03, JPAR,
                                        jax.random.PRNGKey(1), barrier=b, **kw)
        got = tr.rbergomi_exotic_price(kind, 100.0, 100.0, 1.0, 0.03, TPAR, _gen(1), barrier=b,
                                       **kw)
    _within([float(a) for a in got], [float(a) for a in want])


def test_greeks_agree_with_reference():
    want = jr.rbergomi_greeks(100.0, 100.0, 1.0, 0.03, JPAR, jax.random.PRNGKey(2),
                              n_paths=20_000, n_steps=8)
    got = tr.rbergomi_greeks(100.0, 100.0, 1.0, 0.03, TPAR, _gen(2), n_paths=20_000, n_steps=8)
    assert set(got) == set(want)
    assert got["price"] == pytest.approx(want["price"], rel=0.02)
    assert got["delta"] == pytest.approx(want["delta"], abs=0.01)
    assert got["vega"] == pytest.approx(want["vega"], rel=0.05)


@pytest.fixture(scope="module")
def bracket_fit():
    pol, sur = jra.fit_rbergomi_lsm(100.0, 105.0, 0.5, 0.06, JPAR, jax.random.PRNGKey(0), -1.0,
                                    4, 2, 8192)
    return tuple(np.asarray(a) for a in pol), np.asarray(sur)


def test_bracket_bounds_on_reference_policy_and_surface(bracket_fit):
    pol, sur = bracket_fit
    args = (100.0, 105.0, 0.5, 0.06)
    _within(tra.rbergomi_lsm_lower(tra.RBergomiPolicy.from_numpy(*pol), _gen(1), *args, TPAR,
                                   -1.0, 4, 2, 16_384),
            jra.rbergomi_lsm_lower(tuple(jnp.asarray(a) for a in pol), jax.random.PRNGKey(1),
                                   *args, JPAR, -1.0, 4, 2, 16_384))
    _within(tra.rbergomi_dual_upper(torch.tensor(sur), _gen(2), *args, TPAR, -1.0, 4, 2, 128,
                                    128),
            jra.rbergomi_dual_upper(jnp.asarray(sur), jax.random.PRNGKey(2), *args, JPAR, -1.0,
                                    4, 2, 128, 128))


def test_lsm_fit_on_the_same_paths_matches():
    key = jax.random.PRNGKey(6)
    with jax.enable_x64(False):
        s, v, m, _, _ = jra._simulate_dates(key, F32(100.0), F32(1.9), F32(-0.9), F32(0.04),
                                            F32(0.06), hurst=0.1, maturity=0.5, n_dates=4,
                                            n_sub=2, n_paths=8192)
    got = tra._fit_from_paths(*(torch.tensor(np.asarray(a)) for a in (s, v, m)), 105.0, 0.5,
                              0.06, -1.0, 4)
    # the reference's fit_rbergomi_lsm on the same key draws the same paths
    want = jra.fit_rbergomi_lsm(100.0, 105.0, 0.5, 0.06, JPAR, key, -1.0, 4, 2, 8192)
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Oracles on the port alone
# ---------------------------------------------------------------------------
def test_eta_zero_is_black_scholes_and_variance_is_xi0():
    p = tr.RBergomiParams(hurst=0.2, eta=1e-8, rho=-0.5, xi0=0.04)
    ks = torch.tensor([90.0, 100.0, 110.0])
    prices, se = tr.rbergomi_price(100.0, ks, 1.0, 0.03, p, _gen(3), n_paths=20_000, n_steps=8)
    bs = bs_price(torch.tensor(100.0), ks, 1.0, 0.03, 0.2, 1.0)
    assert bool(((prices - bs).abs() < 4 * se + 2e-3).all()), (prices, bs)
    n = 16
    z, _ = tr._draw(_gen(4), 20_000, n)
    vw = z @ torch.tensor(tr._volterra_chol(n, 0.1, 1.0)).T
    t = torch.tensor(np.linspace(1.0 / n, 1.0, n).astype(np.float32))
    v = tr.rbergomi_variance_grid(TPAR, vw[:, :n], t)
    ev, sd = v.mean(0), v.std(0) / math.sqrt(v.shape[0])
    assert bool(((ev - 0.04).abs() < 4 * sd + 1e-4).all())


def test_variance_swap_curve_matches_reference():
    mats, kv = [0.25, 0.5, 1.0], [0.03, 0.035, 0.04]
    want, got = jr.xi_curve_from_variance_swaps(mats, kv), tr.xi_curve_from_variance_swaps(mats,
                                                                                        kv)
    tq = np.linspace(0.0, 1.5, 13)
    np.testing.assert_array_equal(got(tq), want(tq))
    curve = got(np.linspace(0.0, 1.0, 8, endpoint=False))
    flat = tr.rbergomi_price(100.0, [100.0], 1.0, 0.0, TPAR, _gen(5), n_paths=4000, n_steps=8,
                             xi_curve=np.full(8, 0.04, np.float32))
    base = tr.rbergomi_price(100.0, [100.0], 1.0, 0.0, TPAR, _gen(5), n_paths=4000, n_steps=8)
    assert torch.equal(flat[0], base[0]) and curve.shape == (8,)


def test_eta_zero_bracket_overlaps_gbm_certificate():
    p = tr.RBergomiParams(hurst=0.3, eta=1e-6, rho=-0.5, xi0=0.04)
    br = tra.rbergomi_american_bracket(100.0, 105.0, 0.5, 0.06, p, n_dates=6, n_sub=1,
                                       n_fit=8192, n_lower=16_384, n_outer=128, n_inner=128,
                                       device="cpu")
    gbm = american_price_interval(100.0, 105.0, 0.5, 0.06, 0.2, n_dates=6, n_outer=8192,
                                  n_grid=256, device="cpu")
    assert br["lower"] - 3 * br["lower_se"] <= float(gbm["upper"]) + 3 * float(
        gbm["upper_se"]) + 1e-3
    assert br["upper"] + 3 * br["upper_se"] >= float(gbm["lower"]) - 3 * float(
        gbm["lower_se"]) - 1e-3
    assert br["continuous_upper"] == pytest.approx(br["upper"] + br["pad"])


def test_calibration_lowers_the_loss():
    strikes = np.array([95.0, 100.0, 105.0], np.float32)
    mats = np.array([0.2, 0.2, 0.2], np.float32)
    cps = np.array([-1.0, 1.0, 1.0], np.float32)
    market = tr.rbergomi_chain_price(strikes, mats, cps, 100.0, 0.0, TPAR, _gen(7), n_paths=4096,
                                     max_dt=0.1, min_seg=4).numpy()
    init = tr.RBergomiParams(hurst=0.3, eta=1.0, rho=-0.3, xi0=0.06)
    kw = dict(init=init, learning_rate=0.08, n_paths=2048, max_dt=0.1, min_seg=4,
              device="cpu")
    _, loss0 = tr.calibrate_rbergomi(market, strikes, mats, cps, 100.0, 0.0, n_steps=1, **kw)
    p, loss = tr.calibrate_rbergomi(market, strikes, mats, cps, 100.0, 0.0, n_steps=25, **kw)
    assert np.isfinite(loss) and loss < 0.5 * loss0
    assert 0.0 < p.hurst < 0.5 and -1.0 < p.rho < 1.0


def test_matmuls_refuse_tf32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            tr.rbergomi_price(100.0, [100.0], 1.0, 0.0, TPAR, _gen(8), n_paths=64, n_steps=4)
    finally:
        torch.set_float32_matmul_precision(prev)


def test_validation():
    from optionslab_tpu_torch.utils.exceptions import ValidationError

    with pytest.raises(ValidationError):
        tr.RBergomiParams(hurst=0.7).validate()
    with pytest.raises(ValidationError):
        tr.rbergomi_price(100.0, [100.0], 1.0, 0.0, TPAR, _gen(0), n_paths=101)
    with pytest.raises(ValidationError):
        tr.rbergomi_exotic_price("asian", 100.0, 100.0, 1.0, 0.0, TPAR, _gen(0))
    with pytest.raises(ValidationError):
        tr.rbergomi_cliquet_price(100.0, 1.0, 0.0, TPAR, _gen(0), n_periods=5, n_steps=16)
    with pytest.raises(ValidationError):
        tra.rbergomi_american_bracket(100.0, 100.0, 1.0, 0.05, TPAR, cp=1.0, device="cpu")
