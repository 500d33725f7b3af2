"""The port's stochastic local vol (``models/slv.py``) against the JAX
package's, and the pure-LV structured wrappers of ``models/local_vol.py``.

The particle calibration and the scan engines draw from a ``torch.Generator``
where the reference draws from ``jax.random``, so they are compared
statistically:

* prices within 5 combined standard errors (plus the stated allowance where
  both engines calibrate their own leverage);
* leverage rows on the central band (|z| ≤ 1.75 of the particle grid) within
  6% of the reference's: the binned E[v | S] of 65,536 particles in 31 bins
  moves by ~3% from one seed to another in either package;
* ``_conditional_variance`` and the interpolation are deterministic and are
  held to the reference on the same inputs to rtol 1e-5 (float32 sums in
  another order) and 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optionslab_tpu.models import local_vol as jlv
from optionslab_tpu.models import slv as jslv
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu_torch.models import local_vol as tlv
from optionslab_tpu_torch.models import slv as tslv
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


S, R, T = 100.0, 0.03, 1.0
PAR, JPAR = HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7), JHeston.make(0.04, 2.0, 0.04, 0.5, -0.7)
N_STEPS = 8
N_PATHS = 16_384
CPU = "cpu"


@pytest.fixture(scope="module")
def jdup():
    return jlv.DupireLocalVol(jlv.sample_smile_iv_fn(), S, R)


@pytest.fixture(scope="module")
def tdup():
    return tlv.DupireLocalVol(tlv.sample_smile_iv_fn(), S, R, device=CPU)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _grids(d):
    s = d.surface
    return s.k_grid, s.t_grid, s.grid


def _close(ours, ref, extra=0.0):
    (p, se), (q, qe) = ((float(a), float(b)) for a, b in (ours, ref))
    assert abs(p - q) < 5 * math.hypot(se, qe) + extra, (p, se, q, qe)


def test_conditional_variance_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0.01, 0.2, 20_000).astype(np.float32)
    vp = np.maximum(rng.normal(0.04, 0.02, 20_000), 0.0).astype(np.float32)
    jc, jv = (np.asarray(a) for a in jslv._conditional_variance(jnp.asarray(x), jnp.asarray(vp),
                                                                 31))
    tc, tv = tslv._conditional_variance(torch.tensor(x), torch.tensor(vp), 31)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5)
    # a thin cloud: empty bins fall back to the neighbours' mass, then the mean
    xs = np.array([0.0, 0.0, 0.5, 1.0], np.float32)
    vs = np.array([0.01, 0.03, 0.05, 0.07], np.float32)
    jc, jv = (np.asarray(a) for a in jslv._conditional_variance(jnp.asarray(xs),
                                                                 jnp.asarray(vs), 31))
    tc, tv = tslv._conditional_variance(torch.tensor(xs), torch.tensor(vs), 31)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6)


def test_interp_matches_jnp_interp_and_clamps():
    xp = np.sort(np.random.default_rng(1).normal(0, 0.3, 31)).astype(np.float32)
    fp = np.random.default_rng(2).uniform(0.5, 1.5, 31).astype(np.float32)
    x = np.concatenate([np.linspace(-2.0, 2.0, 201), xp, [xp[0] - 1.0, xp[-1] + 1.0]]) \
        .astype(np.float32)
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    ours = tslv._interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert ours[-2] == fp[0] and ours[-1] == fp[-1]
    # a degenerate row (all grid points equal) takes the left value, not NaN
    flat = tslv._interp(torch.tensor([0.0, 1e-3]), torch.zeros(5), torch.arange(5.0))
    assert torch.isfinite(flat).all()


def test_calibration_statistically_matches_reference(jdup, tdup):
    jx, jl = (np.asarray(a) for a in jslv.slv_calibrate_leverage(
        S, T, R, JPAR, jax.random.PRNGKey(0), *_grids(jdup), n_paths=65_536, n_steps=N_STEPS))
    tx, tl = tslv.slv_calibrate_leverage(S, T, R, PAR, _gen(), *_grids(tdup), n_paths=65_536,
                                         n_steps=N_STEPS)
    assert tx.shape == tl.shape == (N_STEPS, 31) and tx.dtype == torch.float32
    np.testing.assert_allclose(tx[1:, [0, -1]].numpy(), jx[1:, [0, -1]], rtol=1e-2)
    for i in range(1, N_STEPS):
        xs = np.linspace(jx[i, 8], jx[i, 22], 9)
        a, b = np.interp(xs, jx[i], jl[i]), np.interp(xs, tx[i].numpy(), tl[i].numpy())
        assert np.abs(a - b).max() < 0.06 * a.mean(), i
    # one seed, one table: the bins are summed in a fixed order
    tx2, tl2 = tslv.slv_calibrate_leverage(S, T, R, PAR, _gen(), *_grids(tdup), n_paths=65_536,
                                           n_steps=N_STEPS)
    assert torch.equal(tx, tx2) and torch.equal(tl, tl2)


def test_mixing_zero_leverage_is_sigma_lv_over_sqrt_v(tdup):
    """At mixing 0, v is deterministic, so L²·v = σ_LV² row by row."""
    tx, tl = tslv.slv_calibrate_leverage(S, T, R, PAR, _gen(), *_grids(tdup), mixing=0.0,
                                         n_paths=8_192, n_steps=N_STEPS)
    dt = T / N_STEPS
    v = 0.04  # v0 = θ: the deterministic variance stays at θ
    for i in (3, 6):
        x = tx[i, 10:21]
        sig = tdup.surface(S * torch.exp(x), torch.tensor(i * dt))
        np.testing.assert_allclose((tl[i, 10:21] ** 2 * v).numpy(),
                                   (sig ** 2).numpy(), rtol=2e-2)


@pytest.mark.parametrize("kind,cp,barrier", [("european", 1.0, 0.0),
                                             ("barrier_up-and-out", 1.0, 125.0),
                                             ("asian_arith", -1.0, 0.0),
                                             ("barrier_double-out", 1.0, (80.0, 125.0))])
def test_exotic_price_matches_reference(jdup, tdup, kind, cp, barrier):
    ref = jslv.slv_exotic_price(kind, S, 100.0, T, R, JPAR, jax.random.PRNGKey(1), *_grids(jdup),
                                cp=cp, barrier=barrier, n_paths=N_PATHS, n_steps=N_STEPS,
                                return_stderr=True)
    ours = tslv.slv_exotic_price(kind, S, 100.0, T, R, PAR, _gen(1), *_grids(tdup), cp=cp,
                                 barrier=barrier, n_paths=N_PATHS, n_steps=N_STEPS,
                                 return_stderr=True)
    _close(ours, ref, 0.02)


def test_replay_matches_reference_on_the_same_rows(jdup):
    jx, jl = jslv.slv_calibrate_leverage(S, T, R, JPAR, jax.random.PRNGKey(0), *_grids(jdup),
                                         n_paths=32_768, n_steps=N_STEPS)
    ref = jslv.slv_replay_price("barrier_down-and-in", S, 100.0, T, R, JPAR,
                                jax.random.PRNGKey(5), jx, jl, cp=-1.0, barrier=85.0,
                                n_paths=N_PATHS, n_steps=N_STEPS, return_stderr=True)
    ours = tslv.slv_replay_price("barrier_down-and-in", S, 100.0, T, R, PAR, _gen(5),
                                 torch.tensor(np.asarray(jx)), torch.tensor(np.asarray(jl)),
                                 cp=-1.0, barrier=85.0, n_paths=N_PATHS, n_steps=N_STEPS,
                                 return_stderr=True)
    _close(ours, ref)
    with pytest.raises(ValidationError):
        tslv.slv_replay_price("european", S, 100.0, T, R, PAR, _gen(), torch.zeros(3, 31),
                              torch.ones(3, 31), n_steps=N_STEPS)


def test_european_reprices_the_dupire_pde(tdup):
    """Gyöngy: the calibrated SLV reprices the local-vol vanilla at mixing 1."""
    pde = float(tdup._solve(105.0, T, 1.0, n_space=101, n_time=50))
    p, se = tslv.slv_exotic_price("european", S, 105.0, T, R, PAR, _gen(2), *_grids(tdup),
                                  n_paths=65_536, n_steps=16, return_stderr=True)
    assert abs(float(p) - pde) < 5 * float(se) + 0.08


@pytest.mark.parametrize("name", ["cliquet", "autocall", "range_accrual"])
def test_structured_scans_match_reference(jdup, tdup, name):
    kw = dict(n_paths=N_PATHS, n_steps=N_STEPS, return_stderr=True)
    if name == "cliquet":
        kw["n_periods"] = 4
    elif name == "autocall":
        kw["n_obs"] = 4
    args = (S, 90.0, 110.0, T, R) if name == "range_accrual" else (S, T, R)
    ref = getattr(jslv, f"slv_{name}_price")(*args, JPAR, jax.random.PRNGKey(3), *_grids(jdup),
                                             **kw)
    ours = getattr(tslv, f"slv_{name}_price")(*args, PAR, _gen(3), *_grids(tdup), **kw)
    _close(ours, ref, 0.05)


def test_swap_strikes_match_reference(jdup, tdup):
    ref = [float(v) for v in jslv.slv_swap_strikes(S, T, R, JPAR, jax.random.PRNGKey(4),
                                                   *_grids(jdup), n_paths=N_PATHS,
                                                   n_steps=N_STEPS)]
    ours = [float(v) for v in tslv.slv_swap_strikes(S, T, R, PAR, _gen(4), *_grids(tdup),
                                                    n_paths=N_PATHS, n_steps=N_STEPS)]
    for m in (0, 2):
        assert abs(ours[m] - ref[m]) < 5 * math.hypot(ours[m + 1], ref[m + 1]) + 2e-3
    var = tslv.slv_variance_swap(S, T, R, PAR, _gen(4), *_grids(tdup), n_paths=N_PATHS,
                                 n_steps=N_STEPS, return_stderr=True)
    jvar = jslv.slv_variance_swap(S, T, R, JPAR, jax.random.PRNGKey(4), *_grids(jdup),
                                  n_paths=N_PATHS, n_steps=N_STEPS, return_stderr=True)
    _close(var, jvar, 2e-3)


def test_flat_mixing_zero_variance_swap_is_sigma_squared():
    flat = tlv.LocalVolSurface(torch.linspace(-3.0, 3.0, 11), torch.linspace(0.01, 2.0, 9),
                               torch.full((9, 11), 0.2), S, R, device=CPU)
    par = HestonParams.make(0.04, 2.0, 0.04, 0.3, -0.7)
    m, se, vol, _ = tslv.slv_swap_strikes(S, T, R, par, _gen(), flat.k_grid, flat.t_grid,
                                          flat.grid, mixing=0.0, n_paths=4_096, n_steps=N_STEPS)
    assert float(m) == pytest.approx(0.04, rel=1e-4) and float(se) < 1e-6
    assert float(vol) == pytest.approx(0.2, rel=1e-4)


def test_model_facade_matches_functions(tdup):
    model = tslv.SLVModel(tdup, PAR, mixing=0.5)
    p = model.price("one_touch_up", 0.0, T, _gen(6), barrier=120.0, n_paths=4_096,
                    n_steps=N_STEPS)
    q = tslv.slv_exotic_price("one_touch_up", S, 0.0, T, R, PAR, _gen(6), *_grids(tdup),
                              barrier=120.0, mixing=0.5, n_paths=4_096, n_steps=N_STEPS)
    assert float(p) == float(q)
    c = model.cliquet(T, _gen(6), n_periods=4, n_paths=4_096, n_steps=N_STEPS)
    a = model.autocall(T, _gen(6), n_obs=4, n_paths=4_096, n_steps=N_STEPS)
    xr, lr = model.leverage(T, _gen(6), n_paths=4_096, n_steps=N_STEPS)
    assert math.isfinite(float(c)) and 0.0 < float(a) < 120.0 and xr.shape == lr.shape
    (price, rows) = tslv.slv_exotic_price("european", S, 100.0, T, R, PAR, _gen(), *_grids(tdup),
                                          n_paths=4_096, n_steps=N_STEPS, return_leverage=True)
    assert rows[0].shape == (N_STEPS, 31) and float(price) > 0.0


@pytest.mark.parametrize("name", ["cliquet", "autocall"])
def test_pure_lv_wrappers_match_reference(jdup, tdup, name):
    kw = dict(n_paths=N_PATHS, n_steps=N_STEPS, return_stderr=True,
              **({"n_periods": 4} if name == "cliquet" else {"n_obs": 4}))
    ref = getattr(jlv, f"local_vol_{name}_price")(jdup, T, **kw)
    ours = getattr(tlv, f"local_vol_{name}_price")(tdup, T, seed=1, **kw)
    _close(ours, ref, 0.05)


def test_validation(tdup):
    with pytest.raises(ValidationError):
        tslv.slv_exotic_price("lookback", S, 100.0, T, R, PAR, _gen(), *_grids(tdup))
    with pytest.raises(ValidationError):
        tslv.SLVModel("not a surface", PAR)
    with pytest.raises(ValidationError):
        tslv.slv_cliquet_price(S, T, R, PAR, _gen(), *_grids(tdup), n_periods=3, n_steps=8)
    with pytest.raises(ValidationError):
        tslv.slv_autocall_price(S, T, R, PAR, _gen(), *_grids(tdup), n_obs=5, n_steps=8)
    assert set(tslv.SLV_KINDS) == set(jslv.SLV_KINDS)
