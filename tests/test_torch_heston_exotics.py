"""The port's Heston/Bates exotics scan engine (``models/heston_exotics.py``)
against the JAX package's, and against the GBM closed forms in the σ_v → 0,
v0 = θ limit.

The two engines draw from different generators (a ``torch.Generator``, a
JAX key), so they agree statistically: within 5 combined standard errors
plus 0.01 (the bound of ``tests/test_heston_exotics.py``)."""

import math

import numpy as np
import pytest
import torch

import jax

from optionslab_tpu.models import heston_exotics as jx
from optionslab_tpu.models.bates import BatesParams as JBates
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu_torch.models import exotics as tex
from optionslab_tpu_torch.models import heston_exotics as hx
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
N, STEPS = 40_000, 16
KEY = jax.random.PRNGKey(7)


def _gen(seed=3):
    return torch.Generator().manual_seed(seed)


def _close(ours, ref):
    (p, s), (jp, js) = ours, ref
    tol = 5 * math.hypot(float(s), float(js)) + 0.01
    assert abs(float(p) - float(jp)) < tol, (float(p), float(jp), tol)


def test_kinds_match_reference():
    assert hx.HESTON_EXOTIC_KINDS == jx.HESTON_EXOTIC_KINDS


@pytest.mark.parametrize("kind,barrier,cp,scheme,bates", [
    ("asian_arith", 0.0, 1.0, "euler", False),
    ("lookback_float", 0.0, -1.0, "qe", False),
    ("barrier_up-and-out", 125.0, 1.0, "euler", False),
    ("barrier_down-and-in", 85.0, -1.0, "euler", True),
    ("one_touch_double_hit", (85.0, 118.0), 1.0, "qe", True),
    ("no_touch_down", 80.0, 1.0, "euler", True),
])
def test_scan_matches_reference_scan(kind, barrier, cp, scheme, bates):
    tpar = BatesParams.make() if bates else HestonParams.make()
    jpar = JBates.make() if bates else JHeston.make()
    kw = dict(cp=cp, barrier=barrier, n_paths=N, n_steps=STEPS, scheme=scheme,
              return_stderr=True)
    ours = hx.heston_exotic_price(kind, S, K, T, R, tpar, _gen(), **kw)
    assert ours[0].dtype == torch.float32 and math.isfinite(float(ours[0]))
    _close(ours, jx.heston_exotic_price(kind, S, K, T, R, jpar, KEY, **kw))


def test_structured_match_reference_scan():
    kw = dict(n_paths=N, n_steps=STEPS, return_stderr=True)
    for bates in (False, True):
        tpar = BatesParams.make() if bates else HestonParams.make()
        jpar = JBates.make() if bates else JHeston.make()
        _close(hx.heston_cliquet_price(S, T, R, tpar, _gen(1), n_periods=4, **kw),
               jx.heston_cliquet_price(S, T, R, jpar, KEY, n_periods=4, **kw))
        _close(hx.heston_autocall_price(S, T, R, tpar, _gen(2), n_obs=4, **kw),
               jx.heston_autocall_price(S, T, R, jpar, KEY, n_obs=4, **kw))
        _close(hx.heston_range_accrual_price(S, 90.0, 110.0, T, R, tpar, _gen(4), **kw),
               jx.heston_range_accrual_price(S, 90.0, 110.0, T, R, jpar, KEY, **kw))


LIM = HestonParams.make(0.04, 2.0, 0.04, 1e-7, -0.7)  # σ_v → 0, v0 = θ: GBM at σ = 0.2


def test_gbm_limit_matches_closed_forms():
    """With σ_v → 0 and v0 = θ the Euler scheme collapses to GBM (σ = 0.2),
    where the discrete geometric Asian and the range accrual have exact
    closed forms: within 4 standard errors (+1e-3 of float32 drift). (QE's
    k-weights carry ρ/σ_v, which cancels catastrophically in float32 as
    σ_v → 0: the reference tests this limit under Euler only.)"""
    kw = dict(n_paths=100_000, n_steps=STEPS, return_stderr=True)
    p, se = hx.heston_exotic_price("asian_geo", S, K, T, R, LIM, _gen(5), **kw)
    cf = float(tex.geometric_asian_closed_form(S, K, T, R, 0.2, 1.0, 0.0, STEPS))
    assert abs(float(p) - cf) < 4 * float(se) + 1e-3, (float(p), cf)
    p, se = hx.heston_range_accrual_price(S, 90.0, 110.0, T, R, LIM, _gen(6), **kw)
    cf = float(tex.range_accrual_closed_form(S, 90.0, 110.0, T, R, 0.2, n_steps=STEPS))
    assert abs(float(p) - cf) < 4 * float(se) + 1e-3, (float(p), cf)


def test_jumps_fatten_the_left_tail():
    """Negative-mean jumps make a down-and-in put dearer and a corridor
    cheaper (the reference's kernel tests, on the scan engine)."""
    kw = dict(cp=-1.0, barrier=80.0, n_paths=N, n_steps=STEPS)
    pj = hx.heston_exotic_price("barrier_down-and-in", S, K, T, R, BatesParams.make(), _gen(),
                                **kw)
    ph = hx.heston_exotic_price("barrier_down-and-in", S, K, T, R, HestonParams.make(), _gen(),
                                **kw)
    assert float(pj) > float(ph) + 0.5
    kw = dict(n_paths=N, n_steps=STEPS)
    rj = hx.heston_range_accrual_price(S, 90.0, 110.0, T, R, BatesParams.make(), _gen(), **kw)
    rh = hx.heston_range_accrual_price(S, 90.0, 110.0, T, R, HestonParams.make(), _gen(), **kw)
    assert float(rj) < float(rh) - 1.0


def test_stat_fns_and_payoff_conventions():
    """Lookback extrema include S0, a level crossed at S0 counts as hit, the
    pay-at-hit stat carries the discount at the first hit."""
    init, update = hx.exotic_stat_fns("one_touch_up_hit", 1.0, 110.0, rdt=0.01)
    s0 = torch.tensor([100.0, 120.0])
    h, dfh = init(s0)
    assert h.tolist() == [0.0, 1.0] and dfh.tolist() == [0.0, 1.0]
    h, dfh = update((h, dfh), torch.tensor([115.0, 90.0]), 2)
    assert h.tolist() == [1.0, 1.0] and dfh.tolist() == pytest.approx([math.exp(-0.03), 1.0])
    assert float(hx.exotic_payoff("one_touch_up_hit", 1.0, 0.0, 4, None, (h, dfh))[0]) \
        == pytest.approx(math.exp(-0.03))
    init, update = hx.exotic_stat_fns("lookback_fixed", -1.0, 0.0)
    st = update(init(torch.tensor([100.0])), torch.tensor([105.0]), 0)
    assert float(st) == 100.0  # fixed put: the running minimum, S0 included
    pay = hx.exotic_payoff("barrier_double-in", 1.0, 100.0, 4, torch.tensor([110.0]),
                           torch.tensor([1.0]))
    assert float(pay) == 10.0


def test_validation():
    g = _gen()
    with pytest.raises(ValidationError, match="unknown"):
        hx.heston_exotic_price("rainbow", S, K, T, R, LIM, g)
    with pytest.raises(ValidationError, match="euler|qe"):
        hx.heston_exotic_price("asian_arith", S, K, T, R, LIM, g, scheme="milstein")
    with pytest.raises(ValidationError, match="n_periods"):
        hx.heston_cliquet_price(S, T, R, LIM, g, n_periods=5, n_steps=16)
    with pytest.raises(ValidationError, match="n_obs"):
        hx.heston_autocall_price(S, T, R, LIM, g, n_obs=3, n_steps=16)
    with pytest.raises(ValidationError, match="lower < upper"):
        hx.heston_range_accrual_price(S, 110.0, 90.0, T, R, LIM, g)
    out = hx.heston_exotic_price("asian_arith", S, K, T, R, LIM, g, n_paths=1000, n_steps=4)
    assert out.shape == () and np.isfinite(float(out))
