"""The port's Dupire local vol (``models/local_vol.py``) and Thomas solve
(``ops/tridiag.py``) against the JAX package's.

The reference runs under this suite's x64 setting (``tests/conftest.py``),
so its Dupire grids are float32 (it casts them) while its PDE nodes are
float64; the port computes in float32 throughout. Tolerances:

* ``_bilinear``, the surface lookup, the Dupire grid: rtol 1e-6 — the same
  float32 formulas, autograd in place of vmapped ``jax.grad`` (measured ≤
  1.2e-7 on the grid);
* ``tridiag_solve``: 1e-12 in float64, 1e-5 in float32;
* the PDE: rtol 1e-5 (float32 nodes against the reference's float64 ones,
  measured 2.7e-6);
* the scan engines draw from different generators: within 5 combined
  standard errors.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.models import local_vol as jlv
from optionslab_tpu.ops.tridiag import tridiag_solve as j_tridiag
from optionslab_tpu_torch.models import local_vol as tlv
from optionslab_tpu_torch.ops.tridiag import tridiag_solve
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, R = 100.0, 0.05
CPU = "cpu"


@pytest.fixture(scope="module")
def jdup():
    return jlv.DupireLocalVol(jlv.sample_smile_iv_fn(), S, R)


@pytest.fixture(scope="module")
def tdup():
    return tlv.DupireLocalVol(tlv.sample_smile_iv_fn(), S, R, device=CPU)


def _flat(vol=0.2):
    return tlv.LocalVolSurface(torch.linspace(-3.0, 3.0, 11), torch.linspace(0.01, 2.0, 9),
                               torch.full((9, 11), vol), S, R, device=CPU)


def test_bilinear_matches_reference_inside_and_clamped():
    rng = np.random.default_rng(0)
    gx = np.linspace(-0.8, 0.8, 13).astype(np.float32)
    gy = np.linspace(0.02, 2.5, 7).astype(np.float32)
    vals = rng.uniform(0.1, 0.4, (7, 13)).astype(np.float32)
    xq = rng.uniform(-1.2, 1.2, 500).astype(np.float32)  # a third beyond the grid
    yq = rng.uniform(-0.5, 3.0, 500).astype(np.float32)
    ref = np.asarray(jlv._bilinear(jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(vals),
                                   jnp.asarray(xq), jnp.asarray(yq)))
    ours = tlv._bilinear(torch.tensor(gx), torch.tensor(gy), torch.tensor(vals),
                         torch.tensor(xq), torch.tensor(yq)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    # the edges clamp to the grid's last cells
    edge = tlv._bilinear(torch.tensor(gx), torch.tensor(gy), torch.tensor(vals),
                         torch.tensor([-5.0, 5.0]), torch.tensor([0.02, 2.5]))
    np.testing.assert_allclose(edge.numpy(), [vals[0, 0], vals[-1, -1]], rtol=2e-3)


def test_dupire_grid_matches_reference(jdup, tdup):
    # the grids to float32 rounding (the reference's k = 0 node is 1e-17)
    np.testing.assert_allclose(tdup.surface.k_grid.numpy(), np.asarray(jdup.surface.k_grid),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tdup.surface.t_grid.numpy(), np.asarray(jdup.surface.t_grid),
                               rtol=1e-6)
    np.testing.assert_allclose(tdup.surface.grid.numpy(), np.asarray(jdup.surface.grid),
                               rtol=1e-6)
    assert tdup.surface.grid.dtype == torch.float32 and tdup.device.type == "cpu"


def test_local_variance_off_grid_matches_reference(jdup, tdup):
    k = np.linspace(-0.7, 0.7, 9, dtype=np.float32)
    t = np.linspace(0.1, 2.0, 9, dtype=np.float32)
    ref = np.asarray(jdup.local_variance(jnp.asarray(k), jnp.asarray(t)))
    np.testing.assert_allclose(tdup.local_variance(torch.tensor(k), torch.tensor(t)).numpy(),
                               ref, rtol=1e-6)


def test_surface_call_matches_reference(jdup, tdup):
    s = np.array([60.0, 85.0, 100.0, 120.0, 180.0], np.float32)
    t = np.array([0.0, 0.3, 1.0, 2.0, 3.0], np.float32)
    ref = np.asarray(jdup.surface(jnp.asarray(s), jnp.asarray(t)))
    np.testing.assert_allclose(tdup.surface(torch.tensor(s), torch.tensor(t)).numpy(), ref,
                               rtol=1e-6)


def test_surface_from_numpy_and_to(jdup, tdup):
    surf = tlv.LocalVolSurface.from_numpy(np.asarray(jdup.surface.k_grid),
                                          np.asarray(jdup.surface.t_grid),
                                          np.asarray(jdup.surface.grid), S, R, device=CPU)
    assert torch.equal(surf.grid, torch.tensor(np.asarray(jdup.surface.grid)))
    moved = tdup.to(CPU)
    assert moved is not tdup and torch.equal(moved.surface.grid, tdup.surface.grid)


def test_surface_defaults_to_the_card():
    """A surface carried across with no device goes to the card, as
    ``DupireLocalVol`` does; a CPU-only build refuses rather than keep it on
    the host, where the pricers built on it would quietly run their plain
    versions."""
    args = (np.linspace(-1.0, 1.0, 5), np.linspace(0.1, 1.0, 3), np.full((3, 5), 0.2), S, R)
    if torch.cuda.is_available():
        assert tlv.LocalVolSurface.from_numpy(*args).device.type == "cuda"
        assert tlv.LocalVolSurface(*args).device.type == "cuda"
    else:
        for make in (tlv.LocalVolSurface.from_numpy, tlv.LocalVolSurface):
            with pytest.raises((AssertionError, RuntimeError)):
                make(*args)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_tridiag_matches_reference(dtype, tol):
    rng = np.random.default_rng(1)
    lo, up = rng.uniform(-1, 1, (2, 4, 9)).astype(dtype)
    di = (3.0 + rng.uniform(0, 1, (4, 9))).astype(dtype)
    rhs = rng.normal(size=(4, 9)).astype(dtype)
    ref = np.asarray(j_tridiag(*(jnp.asarray(a) for a in (lo, di, up, rhs))))
    assert ref.dtype == dtype
    ours = tridiag_solve(*(torch.tensor(a) for a in (lo, di, up, rhs))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)
    # and it solves the system
    x = torch.tensor(ours, dtype=torch.float64)
    a, b, c = (torch.tensor(v, dtype=torch.float64) for v in (lo, di, up))
    back = b * x
    back[:, 1:] += a[:, 1:] * x[:, :-1]
    back[:, :-1] += c[:, :-1] * x[:, 1:]
    np.testing.assert_allclose(back.numpy(), rhs, rtol=10 * tol, atol=10 * tol)


def test_tridiag_broadcasts_and_differentiates():
    di = torch.full((5,), 4.0, dtype=torch.float64, requires_grad=True)
    x = tridiag_solve(torch.ones(5, dtype=torch.float64), di, torch.ones(5, dtype=torch.float64),
                      torch.arange(10.0, dtype=torch.float64).reshape(2, 5))
    assert x.shape == (2, 5)
    (g,) = torch.autograd.grad(x.sum(), di)
    assert torch.isfinite(g).all() and (g != 0).any()


@pytest.mark.parametrize("strike,cp", [(95.0, 1.0), (110.0, -1.0)])
def test_pde_matches_reference(jdup, tdup, strike, cp):
    ref = float(jlv._lv_solve(jdup.surface.k_grid, jdup.surface.t_grid, jdup.surface.grid, S, R,
                              0.0, strike, 1.0, cp, n_space=41, n_time=20))
    ours = tdup._solve(strike, 1.0, cp, n_space=41, n_time=20)
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(ref, rel=1e-5)


def test_pde_american_put_at_least_european(tdup):
    eu = float(tdup._solve(110.0, 1.0, -1.0, n_space=41, n_time=20))
    am = float(tdup._solve(110.0, 1.0, -1.0, n_space=41, n_time=20, american=True))
    assert am >= eu - 1e-6 and am >= 10.0 - 1e-4


def test_price_rejects_other_spot(tdup):
    with pytest.raises(ValidationError):
        tdup.price(101.0, 100.0, 1.0)


def test_flat_surface_pde_matches_black_scholes():
    from optionslab_tpu_torch.models.black_scholes import bs_price

    flat = tlv.DupireLocalVol(lambda k, t: 0.2 + 0.0 * k, S, R, device=CPU)
    p = float(flat._solve(100.0, 1.0, 1.0, n_space=201, n_time=100))
    assert p == pytest.approx(bs_price(100.0, 100.0, 1.0, R, 0.2, 1.0).item(), abs=0.02)


@pytest.mark.parametrize("payoff", ["european", "asian"])
def test_scan_engine_matches_reference(jdup, tdup, payoff):
    jp, jse = jlv.local_vol_mc_price(jdup, 100.0, 1.0, payoff=payoff, n_paths=40_000,
                                     n_steps=25)
    tp, tse = tlv.local_vol_mc_price(tdup, 100.0, 1.0, payoff=payoff, n_paths=40_000,
                                     n_steps=25, seed=1)
    assert tp.dtype == torch.float32
    assert abs(float(tp) - float(jp)) < 5 * math.hypot(float(tse), float(jse))


def test_scan_engine_rejects_bad_payoff(tdup):
    with pytest.raises(ValidationError):
        tlv.local_vol_mc_price(tdup, 100.0, 1.0, payoff="lookback")


def test_swap_strikes_match_reference():
    jd = jlv.DupireLocalVol(jlv.sample_smile_iv_fn(), S, R, k_range=(-2.5, 2.5))
    td = tlv.DupireLocalVol(tlv.sample_smile_iv_fn(), S, R, k_range=(-2.5, 2.5), device=CPU)
    ref = [float(v) for v in jlv.local_vol_swap_strikes(jd, 1.0, n_paths=20_000, n_steps=20)]
    ours = [float(v) for v in tlv.local_vol_swap_strikes(td, 1.0, n_paths=20_000, n_steps=20,
                                                         seed=2)]
    for m in (0, 2):
        assert abs(ours[m] - ref[m]) < 5 * math.hypot(ours[m + 1], ref[m + 1])
    assert ours[2] < math.sqrt(ours[0])  # Jensen
    var, se_var = tlv.local_vol_variance_swap(td, 1.0, n_paths=2_000, n_steps=10)
    vol, _ = tlv.local_vol_vol_swap_strike(td, 1.0, n_paths=2_000, n_steps=10)
    assert float(se_var) > 0 and 0.0 < float(vol) < math.sqrt(float(var))


def test_flat_variance_swap_is_sigma_squared_exactly():
    flat = tlv.DupireLocalVol(lambda k, t: 0.25 + 0.0 * k, S, R, k_range=(-2.5, 2.5), device=CPU)
    m, se = tlv.local_vol_variance_swap(flat, 1.0, n_paths=2_000, n_steps=10)
    assert float(m) == pytest.approx(0.0625, rel=1e-5) and float(se) < 1e-7


def test_narrow_grid_warns_for_swaps():
    high = tlv.DupireLocalVol(tlv.sample_smile_iv_fn(base_vol=0.4), S, R, device=CPU)
    with pytest.warns(UserWarning, match="k_grid"):  # ±2.5·σ_ATM > 0.8
        tlv.local_vol_variance_swap(high, 1.0, n_paths=1_000, n_steps=4)
    wide = tlv.DupireLocalVol(tlv.sample_smile_iv_fn(), S, R, k_range=(-2.5, 2.5), device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tlv.local_vol_variance_swap(wide, 1.0, n_paths=1_000, n_steps=4)


def test_flat_surface_call_matches_bilinear_value():
    flat = _flat(0.3)
    out = flat(torch.tensor([50.0, 100.0, 300.0]), torch.tensor([0.5, 1.0, 5.0]))
    np.testing.assert_allclose(out.numpy(), 0.3, rtol=1e-6)
