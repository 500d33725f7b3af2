"""The port's local-vol American bracket against
``optionslab_tpu.models.local_vol_american``.

* ``lv_bermudan_slices`` runs on the reference's own Dupire grids through
  both packages (float32): the Bermudan price to 1e-6 relative, the
  continuation slices to 2e-5 of the strike.
* The bracket draws from different generators: each bound agrees with the
  reference's within 4 combined standard errors.
* Then the oracle checks of ``tests/test_local_vol_american.py`` at
  ``n_space`` 81, ``n_outer`` 512 and ``n_inner`` 128: on a flat surface the
  bracket overlaps the GBM grid bracket and holds the PDE American within
  the pad; on the sample smile it holds the local-vol PDE American.
"""

import numpy as np
import pytest
import torch

from optionslab_tpu.models import local_vol as jlv
from optionslab_tpu.models import local_vol_american as jla
from optionslab_tpu_torch.models import local_vol as tlv
from optionslab_tpu_torch.models import local_vol_american as tla
from optionslab_tpu_torch.models.american import american_price_interval
from optionslab_tpu_torch.models.fdm import fdm_price
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


S, K, T, R, VOL = 100.0, 100.0, 1.0, 0.05, 0.2
SIZES = dict(n_dates=9, n_sub=4, n_outer=512, n_inner=128, n_space=81, steps_per_date=4)


@pytest.fixture(scope="module")
def ref_smile():
    return jlv.DupireLocalVol(jlv.sample_smile_iv_fn(), S, R)


@pytest.fixture(scope="module")
def smile():
    return tlv.DupireLocalVol(tlv.sample_smile_iv_fn(), S, R, device="cpu")


@pytest.fixture(scope="module")
def flat():
    return tlv.DupireLocalVol(lambda k, t: VOL + 0.0 * k + 0.0 * t, S, R, device="cpu")


@pytest.mark.parametrize("strike,maturity", [(100.0, 1.0), (90.0, 0.5)])
def test_bermudan_slices_match_reference(ref_smile, strike, maturity):
    sf = ref_smile.surface
    grids = (sf.k_grid, sf.t_grid, sf.grid)
    args = (S, R, 0.0, strike, maturity, -1.0, 9, 4, 81)
    price0, cont, x = jla.lv_bermudan_slices(*grids, *args)
    ours = tla.lv_bermudan_slices(*(torch.tensor(np.asarray(g)) for g in grids), *args)
    assert ours[1].shape == (10, 81) and ours[1].dtype == torch.float32
    assert float(ours[0]) == pytest.approx(float(price0), rel=1e-6)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(x), rtol=1e-6)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(cont), rtol=0, atol=2e-5 * strike)


def test_bracket_matches_reference(ref_smile, smile):
    ours = tla.local_vol_american_bracket(smile, K, T, seed=0, device="cpu", **SIZES)
    ref = jla.local_vol_american_bracket(ref_smile, K, T, seed=0, **SIZES)
    assert set(ours) == set(ref) and ours["n_dates"] == 9
    assert ours["pad"] == pytest.approx(ref["pad"], rel=1e-12)
    assert ours["lv_bermudan"] == pytest.approx(ref["lv_bermudan"], rel=1e-4)
    for k in ("lower", "upper"):
        comb = np.hypot(ours[f"{k}_se"], ref[f"{k}_se"])
        assert abs(ours[k] - ref[k]) < 4 * comb, (k, ours, ref)
    # the smile lifts the ATM put above its flat-vol value; the bracket holds
    # the local-vol PDE's continuous American within the pad
    assert ours["width"] < 0.05 and ours["lower"] > 6.3
    am_pde = float(smile._solve(K, T, -1.0, n_space=201, n_time=200, american=True))
    assert ours["lower"] - 3 * ours["lower_se"] - 0.01 < am_pde
    assert am_pde < ours["continuous_upper"] + 3 * ours["upper_se"] + 0.01


def test_flat_surface_overlaps_the_gbm_bracket(flat):
    b = tla.local_vol_american_bracket(flat, K, T, seed=0, device="cpu", **SIZES)
    g = american_price_interval(S, K, T, R, VOL, cp=-1.0, n_dates=9, n_grid=128, n_outer=8192,
                                device="cpu")
    assert float(g["lower"] - 3 * g["lower_se"]) < b["upper"] + 3 * b["upper_se"]
    assert b["lower"] - 3 * b["lower_se"] < float(g["upper"] + 3 * g["upper_se"]), (b, g)
    bs_am = float(fdm_price(ContractBatch.make(S, K, T, R, VOL, "put", dtype=torch.float64),
                            41, 40, american=True))
    assert b["lower"] - 3 * b["lower_se"] < bs_am < b["continuous_upper"] + 3 * b["upper_se"]
    assert abs(b["lv_bermudan"] - b["lower"]) < 0.1  # the PDE diagnostic, within its O(dt)


def test_bracket_runs_on_the_requested_device_and_rejects_calls(flat):
    with pytest.raises(ValidationError):
        tla.local_vol_american_bracket(flat, K, T, cp=1.0, device="cpu")
    out = tla.local_vol_american_bracket(flat, K, T, n_dates=2, n_sub=2, n_outer=64, n_inner=16,
                                         n_space=21, steps_per_date=2, device="cpu")
    assert all(isinstance(v, (float, int)) for v in out.values())
    assert np.isfinite(out["width"])
