"""The port's multi-asset Bermudan bracket against the JAX package's
``models/multi_asset_american.py``, and the oracle tests of
``tests/test_multi_asset_american.py``.

Both packages' lower and upper pipelines run on one policy: the JAX fit's
``(policy_coefs, surface_coefs)``, passed to the port as numpy arrays. They
draw from different generators, so each bound agrees within 5 × combined
stderr. The d = 1 min-put is the standard Bermudan put: its bracket
overlaps the port's GBM grid certificate (``models/american.py``), as in
``tests/test_multi_asset_american.py:91``.

Oracles: the published Broadie–Glasserman / Andersen–Broadie 2-asset value
(T = 3, 9 dates, r = 5%, q = 10%, σ = 20%, ρ = 0: 13.902 at S0 = 100); d = 1
with q = 0 collapses to the European call; the lower bound dominates the
European max-call on the same dynamics.
"""

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.models import multi_asset_american as jmaa
from optionslab_tpu_torch.models import multi_asset_american as maa
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.models.multi_asset import rainbow_price
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BG_ATM = 13.902
KW = dict(maturity=3.0, rate=0.05, dividend=0.10, n_dates=9)
CPU = "cpu"


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("kind,spots,corr", [
    ("max_call", [100.0, 100.0], None),
    ("max_call", [95.0, 100.0, 105.0], [[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]]),
    ("min_put", [100.0, 100.0], [[1.0, 0.4], [0.4, 1.0]]),
])
def test_bounds_on_the_jax_fit_match_jax(kind, spots, corr):
    d = len(spots)
    args = (spots, 100.0, KW["maturity"], KW["rate"], [0.2] * d)
    kw = dict(dividend=KW["dividend"], corr=corr, n_dates=KW["n_dates"], kind=kind)
    coefs, scoefs = jmaa.fit_max_call_lsm(*args, jax.random.PRNGKey(1), **kw, n_paths=30_000)
    coefs, scoefs = np.asarray(coefs), np.asarray(scoefs)
    lo, lo_se = maa.max_call_lower(coefs, gen(2), *args, **kw, n_paths=50_000)
    lo_j, lo_se_j = jmaa.max_call_lower(coefs, jax.random.PRNGKey(2), *args, **kw,
                                        n_paths=50_000)
    assert abs(lo - lo_j) < 5 * np.hypot(lo_se, lo_se_j), (lo, lo_j)
    up, up_se = maa.max_call_upper(scoefs, gen(3), *args, **kw, n_outer=512, n_inner=128)
    up_j, up_se_j = jmaa.max_call_upper(scoefs, jax.random.PRNGKey(3), *args, **kw,
                                        n_outer=512, n_inner=128)
    assert abs(up - up_j) < 5 * np.hypot(up_se, up_se_j), (up, up_j)
    assert up > lo - 3 * (lo_se + up_se)


def test_fit_shapes_and_the_port_fit_prices_like_the_jax_fit():
    args = ([100.0, 100.0], 100.0, KW["maturity"], KW["rate"], [0.2, 0.2])
    kw = dict(dividend=KW["dividend"], n_dates=KW["n_dates"])
    coefs, scoefs = maa.fit_max_call_lsm(*args, gen(4), **kw, n_paths=30_000)
    assert coefs.shape == (10, maa.N_FEAT) and scoefs.shape == (10, maa.N_SFEAT)
    assert coefs.dtype == scoefs.dtype == np.float32
    assert not coefs[0].any() and not coefs[-1].any() and coefs[1:-1].any()
    jc, _ = jmaa.fit_max_call_lsm(*args, jax.random.PRNGKey(4), **kw, n_paths=30_000)
    lo, se = maa.max_call_lower(coefs, gen(5), *args, **kw, n_paths=50_000)
    lo_j, se_j = maa.max_call_lower(np.asarray(jc), gen(5), *args, **kw, n_paths=50_000)
    assert abs(lo - lo_j) < 5 * np.hypot(se, se_j)


def test_bg_atm_point_smoke():
    b = maa.max_call_bracket([100.0, 100.0], 100.0, vols=[0.2, 0.2], n_fit=50_000,
                             n_lower=100_000, n_outer=1024, n_inner=256, seed=0, device=CPU, **KW)
    assert b["lower"] - 3 * b["lower_se"] <= BG_ATM <= b["upper"] + 3 * b["upper_se"], b
    assert b["width"] < 0.1, b
    assert b["upper"] >= b["lower"] - 3 * (b["lower_se"] + b["upper_se"])
    assert b["kind"] == "max_call" and b["n_dates"] == 9


def test_single_asset_no_dividend_is_european():
    """q = 0 call: never exercise early, so the bracket pins the BS price."""
    b = maa.max_call_bracket([100.0], 100.0, maturity=1.0, rate=0.05, vols=[0.2], dividend=0.0,
                             n_dates=6, n_fit=50_000, n_lower=100_000, n_outer=1024,
                             n_inner=256, seed=2, device=CPU)
    euro = bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0).item()
    assert b["lower"] - 3 * b["lower_se"] <= euro <= b["upper"] + 3 * b["upper_se"], b


def test_lower_dominates_european_max_call():
    b = maa.max_call_bracket([100.0, 100.0], 100.0, vols=[0.2, 0.2], n_fit=50_000,
                             n_lower=100_000, n_outer=512, n_inner=128, seed=3, device=CPU, **KW)
    euro, se = rainbow_price([100.0, 100.0], 100.0, 3.0, 0.05, [0.2, 0.2], np.eye(2), gen(9),
                             dividends=0.10, n_paths=200_000, return_stderr=True)
    assert b["lower"] > euro.item() - 3 * (b["lower_se"] + se.item())
    # with q = 10% the early-exercise premium is large and must show
    assert b["lower"] > euro.item() + 1.0


def test_correlation_lowers_the_max_call():
    vals = []
    for rho in (0.0, 0.6):
        b = maa.max_call_bracket([100.0, 100.0], 100.0, vols=[0.2, 0.2],
                                 corr=[[1.0, rho], [rho, 1.0]], n_fit=30_000, n_lower=50_000,
                                 n_outer=512, n_inner=128, seed=4, device=CPU, **KW)
        vals.append(0.5 * (b["lower"] + b["upper"]))
    assert vals[1] < vals[0] - 1.0


def test_min_put_worth_more_than_single_puts():
    kw = dict(maturity=1.0, rate=0.05, dividend=0.0, n_dates=9, kind="min_put", n_fit=30_000,
              n_lower=50_000, n_outer=512, n_inner=128, seed=6, device=CPU)
    two = maa.max_call_bracket([100.0, 100.0], 100.0, vols=[0.2, 0.2], **kw)
    one = maa.max_call_bracket([100.0], 100.0, vols=[0.2], **kw)
    # the min of two assets is stochastically smaller: a dearer put
    assert two["lower"] > one["upper"] + 1.0


def test_bad_inputs():
    with pytest.raises(ValidationError):
        maa.max_call_bracket([100.0, 100.0], 100.0, maturity=-1.0, rate=0.05, vols=[0.2, 0.2],
                             device=CPU)
    with pytest.raises(ValidationError):
        maa.max_call_bracket([100.0, 100.0], 100.0, maturity=1.0, rate=0.05, vols=[0.2, 0.2],
                             corr=[[1.0]], device=CPU)
    with pytest.raises(ValidationError, match="positive definite"):
        maa.max_call_bracket([100.0, 100.0], 100.0, maturity=1.0, rate=0.05, vols=[0.2, 0.2],
                             corr=[[1.0, 1.5], [1.5, 1.0]], device=CPU)


def test_unknown_kind_raises():
    with pytest.raises(ValidationError):
        maa.max_call_bracket([100.0], 100.0, maturity=1.0, rate=0.05, vols=[0.2], kind="nope",
                             device=CPU)


def test_d1_min_put_overlaps_the_certified_gbm_bermudan():
    """Cross-machinery oracle: the d = 1 min-put is the standard Bermudan
    put, so its bracket overlaps the grid engine's certificate on the same
    date grid."""
    from optionslab_tpu_torch.models.american import american_price_interval

    b = maa.max_call_bracket([100.0], 100.0, maturity=1.0, rate=0.05, vols=[0.2], dividend=0.0,
                             n_dates=9, kind="min_put", n_fit=50_000, n_lower=100_000,
                             n_outer=1024, n_inner=256, seed=5, device="cpu")
    ref = american_price_interval(100.0, 100.0, 1.0, 0.05, 0.2, cp=-1.0, n_dates=9,
                                  method="grid", n_grid=512, n_outer=50_000, device="cpu")
    lo = max(b["lower"] - 3 * b["lower_se"], float(ref["lower"] - 3 * ref["lower_se"]))
    hi = min(b["upper"] + 3 * b["upper_se"], float(ref["upper"] + 3 * ref["upper_se"]))
    assert lo <= hi, (b, ref)
    assert b["width"] < 0.05
