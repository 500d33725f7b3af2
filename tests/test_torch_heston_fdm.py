"""The port's Heston ADI (``optionslab_tpu_torch/models/heston_fdm.py``)
against ``optionslab_tpu.models.heston_fdm``.

Both packages solve the same float32 Douglas scheme on a 41 × 21 grid with
16 steps (the reference pinned to float32 by its own casts), so they agree
to float32 rounding: prices to 1e-5 relative, the continuation slices to
2e-5 of the strike, the Greek ladder to 1e-4 relative (vomma, a second
difference of the readout, to 1e-3), the grid geometry to 1e-6. The SLV
Bermudan slices run on the reference's own leverage rows, carried across by
``LeverageRows.from_numpy``. Then the oracles of ``tests/test_heston_fdm.py``
on the port alone at small grids: the European against Lewis, the
frozen-variance limit against the 1-D PDE (0.03 at 121 × 21 × 100 and the
1-D 121 × 100; the
reference's 0.02 is at its default 201 × 101 × 200), American ≥ European,
the intrinsic value at expiry; and autograd delta through the scheme
against ``jax.grad`` of the reference to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import heston_fdm as jf
from optionslab_tpu.models import slv as jslv
from optionslab_tpu.models.heston import HestonParams as JParams
from optionslab_tpu.models.local_vol import DupireLocalVol as JDupire
from optionslab_tpu.models.local_vol import sample_smile_iv_fn as j_smile
from optionslab_tpu_torch.models import heston_fdm as tf
from optionslab_tpu_torch.models.fdm import fdm_price
from optionslab_tpu_torch.models.heston import HestonParams, heston_price
from optionslab_tpu_torch.models.slv_american import LeverageRows
from optionslab_tpu_torch.types import ContractBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PAR = (0.04, 2.0, 0.05, 0.4, -0.6)  # v0, kappa, theta, sigma, rho
GRID = (41, 21, 16)
CPU = torch.device("cpu")


def _jpar(par=PAR):
    return JParams(*(jnp.float32(x) for x in par))


def _tpar(par=PAR):
    return HestonParams.make(*par)


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("option_type,strike", [("call", 95.0), ("put", 105.0)])
def test_price_matches_reference(option_type, strike, american):
    args = (100.0, strike, 0.7, 0.03)
    want = float(jf.heston_fdm_price(*args, _jpar(), 0.01, option_type, american, *GRID))
    got = tf.heston_fdm_price(*args, _tpar(), 0.01, option_type, american, *GRID, device="cpu")
    assert got.dtype == torch.float32 and got.device == CPU
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("american", [False, True])
def test_greek_ladder_matches_reference(american):
    args = (100.0, 105.0, 0.7, 0.03)
    want = jf.heston_fdm_greeks(*args, _jpar(), 0.01, "put", american, *GRID)
    got = tf.heston_fdm_greeks(*args, _tpar(), 0.01, "put", american, *GRID, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        rel = 1e-3 if k == "vomma_v0" else 1e-4
        assert got[k] == pytest.approx(w, rel=rel, abs=1e-5), k


def test_bermudan_slices_match_reference():
    args = (100.0, 100.0, 1.0, 0.05, 0.0, -1.0)
    want = jf._heston_adi_bermudan(*args, _jpar(), 41, 21, 5, 4)
    got = tf._heston_adi_bermudan(*args, _tpar(), 41, 21, 5, 4, CPU)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    assert got[1].shape == (6, 21, 41)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5 * 100.0)
    np.testing.assert_allclose([float(a) for a in got[2:]], [float(a) for a in want[2:]],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def leverage_rows():
    """The reference's particle-calibrated leverage rows on its sample smile
    (4 dates × 2 substeps)."""
    dup = JDupire(j_smile(), 100.0, 0.03)
    sf = dup.surface
    x_rows, l_rows = jslv.slv_calibrate_leverage(
        100.0, 1.0, 0.03, JParams.make(0.04, 2.0, 0.04, 0.5, -0.7), jax.random.PRNGKey(0),
        sf.k_grid, sf.t_grid, sf.grid, mixing=0.7, n_paths=8192, n_steps=8, n_bins=15)
    return np.asarray(x_rows), np.asarray(l_rows)


def test_slv_bermudan_slices_match_reference(leverage_rows):
    x_rows, l_rows = leverage_rows
    args = (100.0, 100.0, 1.0, 0.03, 0.0, -1.0)
    par = (0.04, 2.0, 0.04, 0.5, -0.7)
    want = jf._slv_adi_bermudan(*args, _jpar(par), 0.7, jnp.asarray(x_rows), jnp.asarray(l_rows),
                                41, 21, 4, 4)
    rows = LeverageRows.from_numpy(x_rows, l_rows)
    got = tf._slv_adi_bermudan(*args, _tpar(par), 0.7, rows.x_rows, rows.l_rows, 41, 21, 4, 4,
                               CPU)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=2e-5 * 100.0)
    np.testing.assert_allclose([float(a) for a in got[2:]], [float(a) for a in want[2:]],
                               rtol=1e-6)


def test_slv_rows_follow_the_reference_float32_rule():
    """The leverage row of each backward step, computed on the host in the
    reference's float32 arithmetic, lands where the reference's does."""
    rows = tf._slv_rows(0.7, 3, 5, 6)
    f = np.float32
    dt, dt_mc = f(0.7) / f(15), f(0.7) / f(6)
    want = [int(np.clip(np.int32((f(0.7) - f(i + 1) * dt + f(0.5) * dt) / dt_mc), 0, 5))
            for i in range(15)]
    assert rows == want and rows[0] == 5 and rows[-1] == 0


def test_european_matches_lewis():
    par = _tpar((0.04, 2.0, 0.05, 0.3, -0.7))
    for cp, strike in (("call", 90.0), ("put", 100.0)):
        lw = float(heston_price(ContractBatch.make(100.0, strike, 1.0, 0.05, 0.2, cp), par))
        pde = float(tf.heston_fdm_price(100.0, strike, 1.0, 0.05, par, option_type=cp, n_x=81,
                                        n_v=41, n_t=50, device="cpu"))
        assert abs(pde / lw - 1.0) < 1e-2, (cp, pde, lw)


def test_frozen_variance_matches_1d_pde():
    frozen = _tpar((0.04, 2.0, 0.04, 1e-3, 0.0))
    for american in (False, True):
        bs1d = float(fdm_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "put"),
                               n_space=121, n_time=100, american=american))
        adi = float(tf.heston_fdm_price(100.0, 100.0, 1.0, 0.05, frozen, option_type="put",
                                        american=american, n_x=121, n_v=21, n_t=100,
                                        device="cpu"))
        assert abs(adi - bs1d) < 0.03, (american, adi, bs1d)


def test_american_above_european_and_expiry_intrinsic():
    par = _tpar()
    eu = float(tf.heston_fdm_price(100.0, 105.0, 1.0, 0.05, par, option_type="put", n_x=41,
                                   n_v=21, n_t=16, device="cpu"))
    am = float(tf.heston_fdm_price(100.0, 105.0, 1.0, 0.05, par, option_type="put",
                                   american=True, n_x=41, n_v=21, n_t=16, device="cpu"))
    assert am > eu > 5.0
    out = tf.heston_fdm_price(110.0, 100.0, 0.0, 0.05, par, device="cpu")
    assert isinstance(out, float) and out == 10.0


def test_autograd_delta_through_the_scheme_matches_jax_grad():
    """The bilinear readout's slope in spot, through the frozen mesh."""
    want = float(jax.grad(lambda s: jf.heston_fdm_price(s, 105.0, 0.7, 0.03, _jpar(), 0.01,
                                                        "put", False, *GRID))(jnp.float32(100.0)))
    spot = torch.tensor(100.0, requires_grad=True)
    price = tf.heston_fdm_price(spot, 105.0, 0.7, 0.03, _tpar(), 0.01, "put", False, *GRID,
                                device="cpu")
    (delta,) = torch.autograd.grad(price, spot)
    assert -1.0 < float(delta) < 0.0
    assert float(delta) == pytest.approx(want, rel=1e-4)
