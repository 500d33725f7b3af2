"""The port's stochastic-vol American brackets
(``optionslab_tpu_torch/models/heston_american.py`` and ``slv_american.py``)
against ``optionslab_tpu.models.heston_american`` and ``slv_american``.

* The deterministic pieces on numpy inputs: the feature bases, the QE
  constants and transition (fed the same normals and uniforms), the ADI
  continuation read, the value surface and the exercise rule, to 1e-6
  relative (float32); the LSM backward induction on the same paths to 1e-9
  (float64 host solves in both).
* The bounds draw from different generators: on the reference's own
  regression coefficients and ADI slices (carried across by
  ``LSMCoefs.from_numpy`` and ``AdiSlices.from_numpy``) and, for SLV, its
  own leverage rows (``LeverageRows.from_numpy``), each bound agrees with the
  reference's within 4 combined standard errors — Heston, Bates and SLV.
* A Bates bracket at λ = 0 equals the Heston bracket to the digit (the jumps
  draw from a stream of their own); the bracket's contract as in
  ``tests/test_heston_american.py``; the entry points that build state from
  numbers default to the card.
"""

import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import heston_american as ja
from optionslab_tpu.models import heston_fdm as jf
from optionslab_tpu.models import slv as jslv
from optionslab_tpu.models import slv_american as jsa
from optionslab_tpu.models.bates import BatesParams as JBates
from optionslab_tpu.models.heston import HestonParams as JParams
from optionslab_tpu.models.local_vol import DupireLocalVol as JDupire
from optionslab_tpu.models.local_vol import sample_smile_iv_fn as j_smile
from optionslab_tpu_torch.models import heston_american as ta
from optionslab_tpu_torch.models import slv_american as tsa
from optionslab_tpu_torch.models.bates import BatesParams
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, K, T, R = 100.0, 100.0, 1.0, 0.05
HP = (0.04, 2.0, 0.04, 0.3, -0.7)
ND = 6
JP = JParams(*(jnp.float32(x) for x in HP))


def _tp():
    return HestonParams.make(*HP)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _within(got, want, n_se=4.0):
    comb = math.hypot(got[1], want[1])
    assert abs(got[0] - want[0]) < n_se * comb, (got, want)


# ---------------------------------------------------------------------------
# Deterministic pieces
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(0)
    s = rng.uniform(70.0, 130.0, 200).astype(np.float32)
    v = rng.uniform(0.0, 0.12, 200).astype(np.float32)
    return s, v


def test_feature_bases_match(states):
    s, v = states
    ex = np.maximum(K - s, 0.0).astype(np.float32) / K
    for jfn, tfn in ((ja._features, ta._features), (ja._sfeatures, ta._sfeatures)):
        want = jfn(jnp.asarray(s / K), jnp.asarray(v), jnp.asarray(ex))
        _close(tfn(torch.tensor(s / K), torch.tensor(v), torch.tensor(ex)), want)


def test_qe_constants_and_transition_match(states):
    s, v = states
    rng = np.random.default_rng(1)
    zv, zx = rng.normal(size=(2, 200)).astype(np.float32)
    u = rng.uniform(1e-7, 1 - 1e-7, 200).astype(np.float32)
    x = np.log(s / S).astype(np.float32)
    dt = np.float32(T / 12)
    want_c = ja._qe_consts(JP, dt)
    got_c = ta._qe_consts(_tp(), torch.tensor(dt))
    _close([float(a) for a in got_c], [float(a) for a in want_c])
    want = ja._qe_apply(jnp.asarray(x), jnp.asarray(v), jnp.asarray(zv), jnp.asarray(zx),
                        jnp.asarray(u), want_c, jnp.float32(R) * dt)
    got = ta._qe_apply(*(torch.tensor(a) for a in (x, v, zv, zx, u)), got_c,
                       torch.tensor(np.float32(R) * dt))
    for g, w in zip(got, want):
        _close(g, w, rtol=2e-6, atol=2e-7)


@pytest.fixture(scope="module")
def slices():
    """The reference's Bermudan-ADI continuation slices (41 × 21, 4 steps a
    date) as numpy arrays."""
    out = jf._heston_adi_bermudan(S, K, T, R, 0.0, -1.0, JP, 41, 21, ND, 4)
    return float(out[0]), tuple(np.asarray(a) for a in out[1:])


def test_grid_reads_surface_and_exercise_match(states, slices):
    s, v = states
    _, surf = slices
    tsurf = ta.AdiSlices.from_numpy(*surf)
    js, jv, ts, tv = jnp.asarray(s), jnp.asarray(v), torch.tensor(s), torch.tensor(v)
    for d in (1, 3, ND):
        _close(ta._grid_cont(tsurf, d, ts, tv, K), ja._grid_cont(surf, d, js, jv, K), atol=1e-4)
        _close(ta._surface_value(tsurf, d, ts, tv, K, -1.0, ND, "grid"),
               ja._surface_value(surf, d, js, jv, K, -1.0, ND, "grid"), atol=1e-4)
    rng = np.random.default_rng(2)
    coefs = rng.normal(size=(ND + 1, ja.N_SFEAT)).astype(np.float32) * 0.1
    pol = rng.normal(size=(ND + 1, ja.N_FEAT)).astype(np.float32) * 0.1
    for d in (2, ND):
        _close(ta._surface_value(torch.tensor(coefs), d, ts, tv, K, -1.0, ND),
               ja._surface_value(jnp.asarray(coefs), d, js, jv, K, -1.0, ND), atol=1e-4)
        for kind, surf_t, surf_j in (("poly", torch.tensor(pol), jnp.asarray(pol)),
                                     ("grid", tsurf, surf)):
            ex_t, take_t = ta._exercise_now(surf_t, d, ts, tv, K, -1.0, ND, kind)
            ex_j, take_j = ja._exercise_now(surf_j, d, js, jv, K, -1.0, ND, kind)
            _close(ex_t, ex_j)
            agree = take_t.numpy() == np.asarray(take_j)
            assert agree.mean() > 0.99, (kind, d)


def test_lsm_fit_on_the_same_paths_matches(states):
    rng = np.random.default_rng(3)
    n = 4000
    s_paths = S * np.exp(np.cumsum(rng.normal(0, 0.08, (ND + 1, n)), axis=0)).astype(np.float32)
    s_paths[0] = S
    v_paths = rng.uniform(0.01, 0.08, (ND + 1, n)).astype(np.float32)
    want = ja._fit_lsm_from_paths(s_paths, v_paths, K, T, R, -1.0, ND)
    got = ta._fit_lsm_from_paths(torch.tensor(s_paths), torch.tensor(v_paths), K, T, R, -1.0, ND)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The bounds on the reference's own surfaces
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def coefs():
    pol, sur = ja.fit_heston_lsm(S, K, T, R, JP, jax.random.PRNGKey(0), -1.0, ND, 2, 20_000)
    return np.asarray(pol), np.asarray(sur)


@pytest.mark.parametrize("use_cv", [False, True])
def test_heston_lower_bound_on_reference_policy(coefs, use_cv):
    c_euro = 5.5 if use_cv else None  # any centring constant keeps the estimator unbiased
    want = ja.heston_lsm_lower(coefs[0], jax.random.PRNGKey(1), S, K, T, R, JP, -1.0, ND, 2,
                               40_000, c_euro=c_euro)
    pol = ta.LSMCoefs.from_numpy(*coefs).policy
    got = ta.heston_lsm_lower(pol, _gen(1), S, K, T, R, _tp(), -1.0, ND, 2, 40_000,
                              c_euro=c_euro)
    _within(got, want)


def test_heston_dual_on_reference_surface(coefs):
    want = ja.heston_ab_upper(coefs[1], jax.random.PRNGKey(2), S, K, T, R, JP, -1.0, ND, 2, 256,
                              128)
    got = ta.heston_ab_upper(ta.LSMCoefs.from_numpy(*coefs).surface, _gen(2), S, K, T, R, _tp(),
                             -1.0, ND, 2, 256, 128)
    _within(got, want)


def test_heston_joint_pipeline_on_reference_slices(slices):
    _, surf = slices
    want = [float(a) for a in ja._upper_pipeline(
        tuple(jnp.asarray(a) for a in surf), jax.random.PRNGKey(3), S, K, T, R, JP, -1.0, ND, 2,
        256, 128, kind="grid", with_lower=True)]
    g = _gen(3)
    got = [float(a) for a in ta._upper_pipeline(ta.AdiSlices.from_numpy(*surf), g,
                                                 ta._jump_generator(g), S, K, T, R, _tp(), -1.0,
                                                 ND, 2, 256, 128, kind="grid", with_lower=True)]
    _within(got[:2], want[:2])
    _within(got[2:], want[2:])


def test_bates_bounds_on_reference_surfaces():
    bp = (*HP, 0.5, -0.1, 0.15)
    jb = JBates(*(jnp.float32(x) for x in bp))
    tb = BatesParams.make(*bp)
    pol, sur = ja.fit_heston_lsm(S, K, T, R, jb, jax.random.PRNGKey(4), -1.0, 4, 2, 20_000)
    co = ta.LSMCoefs.from_numpy(pol, sur)
    _within(ta.heston_lsm_lower(co.policy, _gen(5), S, K, T, R, tb, -1.0, 4, 2, 40_000),
            ja.heston_lsm_lower(pol, jax.random.PRNGKey(5), S, K, T, R, jb, -1.0, 4, 2, 40_000))
    _within(ta.heston_ab_upper(co.surface, _gen(6), S, K, T, R, tb, -1.0, 4, 2, 256, 128),
            ja.heston_ab_upper(sur, jax.random.PRNGKey(6), S, K, T, R, jb, -1.0, 4, 2, 256, 128))


@pytest.fixture(scope="module")
def slv_state():
    """The reference's leverage rows (4 dates × 2 substeps) and its SLV LSM
    fit on them."""
    sf = JDupire(j_smile(), S, R).surface
    par = JParams.make(0.04, 2.0, 0.04, 0.5, -0.7)
    x_rows, l_rows = jslv.slv_calibrate_leverage(S, T, R, par, jax.random.PRNGKey(0), sf.k_grid,
                                                 sf.t_grid, sf.grid, n_paths=8192, n_steps=8,
                                                 n_bins=15)
    pol, sur = jsa.fit_slv_lsm(S, K, T, R, par, jax.random.PRNGKey(1), x_rows, l_rows, n_dates=4,
                               n_sub=2, n_paths=20_000)
    return tuple(np.asarray(a) for a in (x_rows, l_rows, pol, sur))


def test_slv_bounds_on_reference_rows_and_surfaces(slv_state):
    x_rows, l_rows, pol, sur = slv_state
    jpar = JParams(*(jnp.float32(x) for x in (0.04, 2.0, 0.04, 0.5, -0.7)))
    tpar = HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7)
    rows = tsa.LeverageRows.from_numpy(x_rows, l_rows)
    co = ta.LSMCoefs.from_numpy(pol, sur)
    jargs = (S, K, T, R, 0.0, jpar, 1.0, jnp.asarray(x_rows), jnp.asarray(l_rows), -1.0, 4, 2)
    targs = (S, K, T, R, 0.0, tpar, 1.0, rows.x_rows, rows.l_rows, -1.0, 4, 2)
    want_lo = [float(a) for a in jsa._lower_pipeline(pol, jax.random.PRNGKey(2), *jargs, 40_000)]
    got_lo = [float(a) for a in tsa._lower_pipeline(co.policy, _gen(2), *targs, 40_000)]
    _within(got_lo, want_lo)
    want_up = [float(a) for a in jsa._upper_pipeline(sur, jax.random.PRNGKey(3), *jargs, 256,
                                                     128)]
    got_up = [float(a) for a in tsa._upper_pipeline(co.surface, _gen(3), *targs, 256, 128)]
    _within(got_up, want_up)


# ---------------------------------------------------------------------------
# The brackets' contract
# ---------------------------------------------------------------------------
KW = dict(n_dates=4, n_fit=8_000, n_lower=16_000, n_outer=128, n_inner=128, use_cv=True,
          device="cpu")


def test_bates_at_zero_intensity_equals_heston_to_the_digit():
    b0 = BatesParams.make(*HP, lam=0.0, mu_j=-0.1, sigma_j=0.15)
    rh = ta.heston_american_bracket(S, K, T, R, _tp(), **KW)
    r0 = ta.heston_american_bracket(S, K, T, R, b0, **KW)
    assert rh["lower"] == pytest.approx(r0["lower"], abs=1e-6)
    assert rh["upper"] == pytest.approx(r0["upper"], abs=1e-6)
    rj = ta.heston_american_bracket(S, K, T, R, BatesParams.make(*HP, lam=0.5), **KW)
    assert rj["lower"] > rh["upper"]  # negative jumps add put value


def test_bracket_contract():
    b = ta.heston_american_bracket(S, K, T, R, _tp(), method="adi", n_dates=4, n_outer=128,
                                   n_inner=128, n_x=41, n_v=21, steps_per_date=4, device="cpu")
    assert b["method"] == "adi" and 5.0 < b["adi_bermudan"] < 7.0
    assert b["lower"] - 3 * b["lower_se"] < b["upper"] + 3 * b["upper_se"]
    assert b["pad"] == pytest.approx(K * (1.0 - np.exp(-R * T / 4)))
    assert b["continuous_upper"] == pytest.approx(b["upper"] + b["pad"])
    with pytest.raises(ValidationError):
        ta.fit_heston_lsm(S, K, T, R, _tp(), _gen(0), cp=1.0)
    with pytest.raises(ValidationError):
        ta.heston_american_bracket(S, K, T, R, _tp(), method="pde", device="cpu")
    with pytest.raises(ValidationError):
        ta.heston_american_bracket(S, K, T, R, BatesParams.make(*HP), method="adi",
                                   device="cpu")


@pytest.mark.parametrize("fn", [
    "heston_fdm_price", "heston_fdm_greeks", "heston_american_bracket",
    "fdm_price_discrete_dividends", "mc_price_discrete_dividends", "forward_start_price",
    "forward_smile_iv", "calibrate_rbergomi", "rbergomi_american_bracket"])
def test_float_built_entry_points_default_to_cuda(fn):
    import optionslab_tpu_torch.models as models

    assert inspect.signature(getattr(models, fn)).parameters["device"].default == "cuda"


def test_brackets_follow_their_state_to_the_device():
    """A bracket moves the parameters it is given to its device; the SLV
    bracket runs where its surface lives."""
    from optionslab_tpu_torch.models.local_vol import DupireLocalVol, sample_smile_iv_fn

    out = ta.heston_american_bracket(S, K, T, R, HestonParams.make(*HP, dtype=torch.float64),
                                     **{**KW, "use_cv": False})
    assert all(isinstance(v, (float, int, str)) for v in out.values())
    dup = DupireLocalVol(sample_smile_iv_fn(), S, R, device="cpu")
    b = tsa.slv_american_bracket(dup, HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7), K, T,
                                 mixing=0.5, n_dates=4, n_sub=2, n_outer=64, n_inner=64,
                                 n_cal_paths=8192, n_bins=15, n_x=41, n_v=21, steps_per_date=4)
    assert b["method"] == "adi" and b["mixing"] == 0.5
    assert b["lower"] - 3 * b["lower_se"] < b["upper"] + 3 * b["upper_se"]
    with pytest.raises(ValidationError):
        tsa.slv_american_bracket(dup, _tp(), K, T, cp=1.0)
