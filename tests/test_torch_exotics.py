"""The port's exotic path against the JAX package: closed forms, the scan
engine, the kernel wrappers (prices, LR and pathwise ladders, books,
cliquet/autocall/range accrual, ``exotic_kernel_ladder``), the book façade
and the dataclasses.

* Closed forms run in float64 on both sides and agree to 1e-10.
* Wrappers run the kernel's plain version on the CPU and the JAX kernel in
  interpret mode with the ``hash`` sampler (bit-equal uniforms), one path
  block, 8 steps: their outputs agree to rtol 1e-5 (the per-row sums agree
  to float32 libm and summation order; ``test_torch_exotic_kernel.py``),
  the control-variate price to 1e-5 absolute.
* The scan engines draw from different generators (``torch.Generator``
  against ``jax.random``), so they agree statistically: within 5 combined
  standard errors.
"""

import math

import numpy as np
import pytest
import torch

import jax

from optionslab_tpu.models import books as jbooks
from optionslab_tpu.models import exotics as jex
from optionslab_tpu.ops import exotic_pallas as ep
from optionslab_tpu_torch.models import books
from optionslab_tpu_torch.models import exotics as tex
from optionslab_tpu_torch.ops import exotic_kernel as ek
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
N_STEPS = 8
RTOL = 1e-5
HASH = dict(n_paths=1, n_steps=N_STEPS, sampler="hash")


def _f(x) -> float:
    return float(np.asarray(x.detach() if isinstance(x, torch.Tensor) else x))


def _close(ours, ref, rtol=RTOL, atol=1e-7):
    assert _f(ours) == pytest.approx(_f(ref), rel=rtol, abs=atol)


def _dicts_close(ours: dict, ref: dict, rtol=RTOL, atol=1e-6):
    assert set(ours) == set(ref)
    for key, v in ref.items():
        if isinstance(v, str) or key in ("paths", "n_steps"):
            assert ours[key] == v, key
        else:
            np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                       np.asarray(v, np.float64), rtol=rtol, atol=atol,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# closed forms (float64)
# ---------------------------------------------------------------------------
CF_TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("cp,n_steps,q", [(1.0, 8, 0.0), (-1.0, 252, 0.02), (1.0, 1, 0.01)])
def test_geometric_asian_closed_form(cp, n_steps, q):
    ours = tex.geometric_asian_closed_form(S, 95.0, T, R, SIG, cp, q, n_steps)
    ref = jex.geometric_asian_closed_form(S, 95.0, T, R, SIG, cp, q, n_steps)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.item(), float(ref), **CF_TOL)


def test_geometric_asian_closed_form_gradients():
    """``torch.autograd`` of the oracle matches ``jax.grad`` of the reference's."""
    args = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (S, SIG, R, T)]
    price = tex.geometric_asian_closed_form(args[0], K, args[3], args[2], args[1], 1.0, 0.0, 16)
    grads = torch.autograd.grad(price, args)
    ref = jax.grad(lambda s, v, r, t: jex.geometric_asian_closed_form(s, K, t, r, v, 1.0, 0.0,
                                                                       16),
                   argnums=(0, 1, 2, 3))(S, SIG, R, T)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-9)


@pytest.mark.parametrize("lower,upper,n_steps", [(90.0, 110.0, 16), (50.0, 99.0, 252)])
def test_range_accrual_closed_form(lower, upper, n_steps):
    """The reference evaluates this one in float32 (its grid and drift are
    cast to float32), the port in float64: they agree to float32 rounding."""
    ours = tex.range_accrual_closed_form(S, lower, upper, T, R, SIG, 0.01, 100.0, n_steps)
    ref = jex.range_accrual_closed_form(S, lower, upper, T, R, SIG, 0.01, 100.0, n_steps)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.item(), float(ref), rtol=2e-6)


@pytest.mark.parametrize("knock", ["out", "in"])
@pytest.mark.parametrize("cp,strike", [(1.0, 100.0), (-1.0, 95.0), (1.0, 130.0)])
def test_double_barrier_closed_form(knock, cp, strike):
    ours = tex.double_barrier_closed_form(S, strike, 80.0, 125.0, T, R, SIG, cp, 0.01, knock)
    ref = jex.double_barrier_closed_form(S, strike, 80.0, 125.0, T, R, SIG, cp, 0.01, knock)
    np.testing.assert_allclose(ours.item(), float(ref), **CF_TOL)


@pytest.mark.parametrize("spot", [100.0, 79.0])
def test_double_no_touch_closed_form(spot):
    ours = tex.double_no_touch_closed_form(spot, 80.0, 125.0, T, R, SIG, 0.01)
    ref = jex.double_no_touch_closed_form(spot, 80.0, 125.0, T, R, SIG, 0.01)
    np.testing.assert_allclose(ours.item(), float(ref), **CF_TOL)


@pytest.mark.parametrize("pay", ["expiry", "hit"])
@pytest.mark.parametrize("barrier", [120.0, 85.0, 100.0])
def test_one_touch_closed_form(pay, barrier):
    ours = tex.one_touch_closed_form(S, barrier, T, R, SIG, 0.01, 1.0, pay)
    ref = jex.one_touch_closed_form(S, barrier, T, R, SIG, 0.01, 1.0, pay)
    np.testing.assert_allclose(ours.item(), float(ref), **CF_TOL)


def test_closed_form_validation():
    with pytest.raises(ValidationError):
        tex.double_barrier_closed_form(S, K, 120.0, 80.0, T, R, SIG)
    with pytest.raises(ValidationError):
        tex.double_barrier_closed_form(S, K, 80.0, 120.0, T, R, SIG, knock="side")
    with pytest.raises(ValidationError):
        tex.one_touch_closed_form(S, 120.0, T, R, SIG, pay="never")


# ---------------------------------------------------------------------------
# scan engine: statistical parity with the reference's scan engine
# ---------------------------------------------------------------------------
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


KEY = jax.random.PRNGKey(7)
N_SCAN = 40_000

SCAN_CASES = {
    "asian_arith": (lambda: tex.asian_price(S, K, T, R, SIG, _gen(), 1.0, 0.0, N_SCAN, N_STEPS,
                                            return_stderr=True),
                    lambda: jex.asian_price(S, K, T, R, SIG, KEY, 1.0, 0.0, N_SCAN, N_STEPS,
                                            return_stderr=True)),
    "asian_geo_put": (lambda: tex.asian_price(S, K, T, R, SIG, _gen(), -1.0, 0.0, N_SCAN,
                                              N_STEPS, "geometric", return_stderr=True),
                      lambda: jex.asian_price(S, K, T, R, SIG, KEY, -1.0, 0.0, N_SCAN, N_STEPS,
                                              "geometric", return_stderr=True)),
    "barrier_discrete": (lambda: tex.barrier_price(S, K, 120.0, T, R, SIG, _gen(), 1.0, 0.0,
                                                   N_SCAN, N_STEPS, "up-and-out",
                                                   return_stderr=True),
                         lambda: jex.barrier_price(S, K, 120.0, T, R, SIG, KEY, 1.0, 0.0, N_SCAN,
                                                   N_STEPS, "up-and-out", return_stderr=True)),
    "barrier_continuous_rebate": (
        lambda: tex.barrier_price(S, K, 85.0, T, R, SIG, _gen(), -1.0, 0.0, N_SCAN, N_STEPS,
                                  "down-and-in", rebate=2.0, continuous=True,
                                  return_stderr=True),
        lambda: jex.barrier_price(S, K, 85.0, T, R, SIG, KEY, -1.0, 0.0, N_SCAN, N_STEPS,
                                  "down-and-in", rebate=2.0, continuous=True,
                                  return_stderr=True)),
    "lookback_fixed_put": (lambda: tex.lookback_price(S, K, T, R, SIG, _gen(), -1.0, 0.0, N_SCAN,
                                                      N_STEPS, False, return_stderr=True),
                           lambda: jex.lookback_price(S, K, T, R, SIG, KEY, -1.0, 0.0, N_SCAN,
                                                      N_STEPS, False, return_stderr=True)),
    "autocallable": (lambda: tex.autocallable_price(S, T, R, SIG, _gen(), n_paths=N_SCAN,
                                                    n_steps=N_STEPS, return_stderr=True),
                     lambda: jex.autocallable_price(S, T, R, SIG, KEY, n_paths=N_SCAN,
                                                    n_steps=N_STEPS, return_stderr=True)),
    "cliquet": (lambda: tex.cliquet_price(S, T, R, SIG, _gen(), n_periods=4, n_steps=N_STEPS,
                                          n_paths=N_SCAN, return_stderr=True),
                lambda: jex.cliquet_price(S, T, R, SIG, KEY, n_periods=4, n_steps=N_STEPS,
                                          n_paths=N_SCAN, return_stderr=True)),
    "double_barrier_continuous": (
        lambda: tex.double_barrier_price(S, K, 80.0, 125.0, T, R, SIG, _gen(), n_paths=N_SCAN,
                                         n_steps=N_STEPS, continuous=True, return_stderr=True),
        lambda: jex.double_barrier_price(S, K, 80.0, 125.0, T, R, SIG, KEY, n_paths=N_SCAN,
                                         n_steps=N_STEPS, continuous=True, return_stderr=True)),
    "double_touch_hit": (lambda: tex.double_touch_price(S, 85.0, 120.0, T, R, SIG, _gen(),
                                                        n_paths=N_SCAN, n_steps=N_STEPS,
                                                        touch="one", pay="hit",
                                                        return_stderr=True),
                         lambda: jex.double_touch_price(S, 85.0, 120.0, T, R, SIG, KEY,
                                                        n_paths=N_SCAN, n_steps=N_STEPS,
                                                        touch="one", pay="hit",
                                                        return_stderr=True)),
    "range_accrual": (lambda: tex.range_accrual_price(S, 90.0, 110.0, T, R, SIG, _gen(),
                                                      n_paths=N_SCAN, n_steps=N_STEPS,
                                                      return_stderr=True),
                      lambda: jex.range_accrual_price(S, 90.0, 110.0, T, R, SIG, KEY,
                                                      n_paths=N_SCAN, n_steps=N_STEPS,
                                                      return_stderr=True)),
    "one_touch_down": (lambda: tex.one_touch_price(S, 88.0, T, R, SIG, _gen(), n_paths=N_SCAN,
                                                   n_steps=N_STEPS, return_stderr=True),
                       lambda: jex.one_touch_price(S, 88.0, T, R, SIG, KEY, n_paths=N_SCAN,
                                                   n_steps=N_STEPS, return_stderr=True)),
    "barrier_rebate_out": (lambda: tex.barrier_rebate_price(S, K, 120.0, T, R, SIG, _gen(),
                                                            rebate=3.0, n_paths=N_SCAN,
                                                            n_steps=N_STEPS, return_stderr=True),
                           lambda: jex.barrier_rebate_price(S, K, 120.0, T, R, SIG, KEY,
                                                            rebate=3.0, n_paths=N_SCAN,
                                                            n_steps=N_STEPS,
                                                            return_stderr=True)),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_engine_matches_reference(case):
    ours_fn, ref_fn = SCAN_CASES[case]
    (p, se), (pr, ser) = ours_fn(), ref_fn()
    assert _f(se) > 0.0 and math.isfinite(_f(p))
    assert abs(_f(p) - _f(pr)) < 5.0 * math.hypot(_f(se), _f(ser)) + 1e-4, (_f(p), _f(pr))


def test_scan_engine_is_seeded():
    a = tex.asian_price(S, K, T, R, SIG, _gen(3), n_paths=1000, n_steps=4)
    b = tex.asian_price(S, K, T, R, SIG, _gen(3), n_paths=1000, n_steps=4)
    c = tex.asian_price(S, K, T, R, SIG, _gen(4), n_paths=1000, n_steps=4)
    assert a.item() == b.item() != c.item()


def test_scan_geo_asian_against_closed_form():
    p, se = tex.asian_price(S, K, T, R, SIG, _gen(1), n_paths=200_000, n_steps=N_STEPS,
                            averaging="geometric", return_stderr=True)
    cf = tex.geometric_asian_closed_form(S, K, T, R, SIG, n_steps=N_STEPS)
    assert abs(p.item() - cf.item()) < 4 * se.item()


def test_scan_autograd_greeks_match_reference():
    """Pathwise Greeks of the scan engine by autograd against ``jax.grad``
    of the reference's scan engine (independent draws: statistical bounds
    of the reference test)."""
    kw = dict(n_paths=100_000, n_steps=N_STEPS)
    ours = tex.exotic_greeks(lambda s, v, r, t: tex.asian_price(s, K, t, r, v, _gen(2), **kw),
                             S, SIG, R, T)
    ref = jex.exotic_greeks(lambda s, v, r, t: jex.asian_price(s, K, t, r, v, KEY, **kw),
                            S, SIG, R, T)
    for key, bound in {"price": 0.1, "delta": 0.02, "vega": 1.2, "rho": 1.2,
                       "theta": 0.6}.items():
        assert abs(_f(ours[key]) - _f(ref[key])) < bound, key


def test_scan_validation():
    with pytest.raises(ValidationError):
        tex.asian_price(S, K, T, R, SIG, _gen(), averaging="harmonic")
    with pytest.raises(ValidationError):
        tex.barrier_price(S, K, 120.0, T, R, SIG, _gen(), barrier_type="sideways")
    with pytest.raises(ValidationError):
        tex.double_touch_price(S, 80.0, 120.0, T, R, SIG, _gen(), touch="no", pay="hit")
    with pytest.raises(ValidationError):
        tex.range_accrual_price(S, 110.0, 90.0, T, R, SIG, _gen())


# ---------------------------------------------------------------------------
# kernel wrappers against the JAX package's, same inputs, hash sampler
# ---------------------------------------------------------------------------
PRICE_CASES = [
    ("asian_arith", dict(cp=-1.0)),
    ("lookback_fixed", dict(strike=105.0)),
    ("barrier_down-and-out", dict(barrier=88.0, dividend=0.02)),
    ("one_touch_up_hit", dict(barrier=112.0)),
    ("no_touch_down", dict(barrier=90.0)),
    ("barrier_double-in", dict(lower=88.0, upper=118.0)),
    ("asian_geo", dict(sampler="sobol_bb_hash")),
]


@pytest.mark.parametrize("kind,kw", PRICE_CASES)
def test_exotic_price_matches_reference(kind, kw):
    kw = {**HASH, **kw}
    strike = kw.pop("strike", K)
    ours = ek.exotic_price(kind, S, strike, T, R, SIG, device="cpu", **kw)
    ref = ep.pallas_exotic_price(kind, S, strike, T, R, SIG, **kw)
    assert ours[2] == ref[2]
    assert ours[0].device.type == "cpu" and ours[0].dtype == torch.float32
    _close(ours[0], ref[0])
    # the QMC stderr is the spread of 8 replicate means that agree to ~1e-5
    # of the price: float32 summation order reaches it amplified (both packages)
    _close(ours[1], ref[1], rtol=1e-2 if kw["sampler"].startswith("sobol") else RTOL)


@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_control_variate_price_matches_reference(cp):
    kw = dict(n_paths=1, n_steps=16, sampler="hash", control_variate=True)
    ours = ek.exotic_price("asian_arith", S, K, T, R, SIG, cp, device="cpu", **kw)
    ref = ep.pallas_exotic_price("asian_arith", S, K, T, R, SIG, cp, **kw)
    assert abs(_f(ours[0]) - _f(ref[0])) < 1e-5
    _close(ours[1], ref[1])
    plain = ek.exotic_price("asian_arith", S, K, T, R, SIG, cp, n_paths=1, n_steps=16,
                            sampler="hash", device="cpu")
    assert abs(_f(ours[0]) - _f(plain[0])) < 4 * math.hypot(_f(ours[1]), _f(plain[1]))
    assert _f(ours[1]) < _f(plain[1]) / 8.0


LR_CASES = [
    ("barrier_up-and-out", dict(barrier=120.0)),
    ("one_touch_down_hit", dict(barrier=90.0)),
    ("barrier_double-out", dict(lower=80.0, upper=125.0)),
    ("asian_geo", dict(cp=-1.0)),
]


@pytest.mark.parametrize("kind,kw", LR_CASES)
def test_exotic_lr_greeks_match_reference(kind, kw):
    ours = ek.exotic_lr_greeks(kind, S, K, T, R, SIG, device="cpu", **HASH, **kw)
    ref = ep.pallas_exotic_lr_greeks(kind, S, K, T, R, SIG, **HASH, **kw)
    _dicts_close(ours, ref)


@pytest.mark.parametrize("kind,cp", [("asian_arith", 1.0), ("asian_geo", -1.0),
                                     ("lookback_float", 1.0), ("lookback_fixed", -1.0)])
def test_exotic_greeks_match_reference(kind, cp):
    ours = ek.exotic_greeks(kind, S, 105.0, T, R, SIG, cp, 0.01, device="cpu", **HASH)
    ref = ep.pallas_exotic_greeks(kind, S, 105.0, T, R, SIG, cp, 0.01, **HASH)
    _dicts_close(ours, ref)


STRUCTURED = [
    (ek.cliquet_price, ep.pallas_cliquet_price, dict(n_periods=4, local_floor=-0.03,
                                                     local_cap=0.03)),
    (ek.autocall_price, ep.pallas_autocall_price, dict(n_obs=4)),
    (ek.cliquet_lr_greeks, ep.pallas_cliquet_lr_greeks, dict(n_periods=2)),
    (ek.autocall_lr_greeks, ep.pallas_autocall_lr_greeks, dict(n_obs=2, ki_barrier=0.8)),
]


@pytest.mark.parametrize("ours_fn,ref_fn,kw", STRUCTURED)
def test_structured_wrappers_match_reference(ours_fn, ref_fn, kw):
    ours = ours_fn(S, T, R, SIG, 0.01, device="cpu", **HASH, **kw)
    ref = ref_fn(S, T, R, SIG, 0.01, **HASH, **kw)
    if isinstance(ref, dict):
        _dicts_close(ours, ref)
    else:
        assert ours[2] == ref[2]
        _close(ours[0], ref[0])
        _close(ours[1], ref[1])


def test_range_accrual_wrappers_match_reference():
    kw = dict(n_paths=1, n_steps=16, sampler="hash")
    ours = ek.range_accrual_price(S, 90.0, 110.0, T, R, SIG, device="cpu", **kw)
    ref = ep.pallas_range_accrual_price(S, 90.0, 110.0, T, R, SIG, **kw)
    _close(ours[0], ref[0])
    _close(ours[1], ref[1])
    _dicts_close(ek.range_accrual_lr_greeks(S, 90.0, 110.0, T, R, SIG, device="cpu", **kw),
                 ep.pallas_range_accrual_lr_greeks(S, 90.0, 110.0, T, R, SIG, **kw))
    cf = tex.range_accrual_closed_form(S, 90.0, 110.0, T, R, SIG, n_steps=16)
    assert abs(_f(ours[0]) - cf.item()) < 5 * _f(ours[1])


BOOK_CASES = [
    ("asian_arith", [90.0, 100.0, 110.0], {}),
    ("barrier_up-and-out", [95.0, 105.0], dict(barriers=[120.0, 131.0])),
    ("barrier_double-out", [100.0], dict(lowers=[80.0], uppers=[125.0])),
    ("one_touch_down_hit", [100.0] * 5, dict(barriers=[80.0, 84.0, 88.0, 92.0, 96.0])),
]


@pytest.mark.parametrize("kind,strikes,kw", BOOK_CASES)
def test_book_wrappers_match_reference(kind, strikes, kw):
    kw = {**kw, "n_paths": 60_000, "n_steps": N_STEPS, "sampler": "hash", "seed": 3}
    ours = ek.exotic_book_price(kind, S, strikes, T, R, SIG, device="cpu", **kw)
    ref = ep.pallas_exotic_book_price(kind, S, strikes, T, R, SIG, **kw)
    assert ours[2] == ref[2] and ours[0].shape == (len(strikes),)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=RTOL, atol=1e-7)
    _dicts_close(ek.exotic_book_lr_greeks(kind, S, strikes, T, R, SIG, device="cpu", **kw),
                 ep.pallas_exotic_book_lr_greeks(kind, S, strikes, T, R, SIG, **kw))


def test_single_contract_book_equals_scalar_path():
    kw = dict(n_paths=1, n_steps=N_STEPS, sampler="hash", seed=21, device="cpu")
    bp, bse, nb = ek.exotic_book_price("barrier_double-out", S, [K], T, R, SIG, lowers=[80.0],
                                       uppers=[125.0], **kw)
    sp, sse, ns = ek.exotic_price("barrier_double-out", S, K, T, R, SIG, lower=80.0,
                                  upper=125.0, **kw)
    assert nb == ns and sp.item() > 0.0
    np.testing.assert_allclose(bp[0].item(), sp.item(), rtol=1e-6)
    np.testing.assert_allclose(bse[0].item(), sse.item(), rtol=1e-5)


LADDER_CASES = [
    ("asian", dict(strike=100.0)),
    ("lookback", dict(strike=105.0, floating=False, cp=-1.0)),
    ("barrier", dict(strike=100.0, barrier=125.0, barrier_type="up-and-in")),
    ("double-barrier", dict(strike=100.0, lower=80.0, upper=125.0)),
    ("double-touch", dict(lower=85.0, upper=120.0, barrier_type="one", pay="hit")),
    ("one-touch", dict(barrier=90.0)),
    ("no-touch", dict(barrier=115.0)),
    ("cliquet", dict(n_steps=6)),
    ("autocallable", dict(n_steps=6)),
]


@pytest.mark.parametrize("kind,kw", LADDER_CASES)
def test_kernel_ladder_matches_reference(kind, kw):
    kw = {"n_paths": 1, "n_steps": N_STEPS, "sampler": "hash", "seed": 1, **kw}
    ours = ek.exotic_kernel_ladder(kind, S, device="cpu", **kw)
    ref = ep.exotic_kernel_ladder(kind, S, **kw)
    _dicts_close(ours, ref)
    if kind in ("cliquet", "autocallable"):
        assert ours["n_steps"] == 12 if kind == "cliquet" else 8


def test_kernel_ladder_defaults_to_philox():
    """``sampler=None`` means ``prng`` on every device (the JAX package picks
    by backend); the plain Philox twin runs on the CPU."""
    out = ek.exotic_kernel_ladder("asian", S, K, n_paths=1, n_steps=4, device="cpu")
    same = ek.exotic_kernel_ladder("asian", S, K, n_paths=1, n_steps=4, sampler="prng",
                                   device="cpu")
    assert out == same and out["greek_method"] == "pathwise"
    with pytest.raises(ValidationError):
        ek.exotic_kernel_ladder("american", S, K, device="cpu")
    with pytest.raises(ValidationError):
        ek.exotic_kernel_ladder("no-touch", S, barrier=120.0, pay="hit", device="cpu")


# ---------------------------------------------------------------------------
# ValidationError cases of tests/test_exotic_pallas.py, one for one
# ---------------------------------------------------------------------------
VALIDATION = {
    "greeks_barrier_kind": lambda: ek.exotic_greeks("barrier_up-and-out", S, K, T, R, SIG,
                                                    device="cpu"),
    "price_structured_kind": lambda: ek.exotic_price("cliquet", S, K, T, R, SIG, device="cpu"),
    "price_unknown_kind": lambda: ek.exotic_price("nope", S, K, T, R, SIG, device="cpu"),
    "qmc_needs_two_steps": lambda: ek.exotic_price("asian_arith", S, K, T, R, SIG, n_paths=1,
                                                   n_steps=1, sampler="sobol_bb_hash",
                                                   device="cpu"),
    "lr_rejects_qmc": lambda: ek.exotic_lr_greeks("barrier_up-and-out", S, K, T, R, SIG,
                                                  sampler="sobol_bb", device="cpu"),
    "greeks_reject_qmc": lambda: ek.exotic_greeks("asian_arith", S, K, T, R, SIG,
                                                  sampler="sobol_bb", device="cpu"),
    "lr_structured_kind": lambda: ek.exotic_lr_greeks("cliquet", S, K, T, R, SIG,
                                                      device="cpu"),
    "lr_unknown_kind": lambda: ek.exotic_lr_greeks("nope", S, K, T, R, SIG, device="cpu"),
    "cv_on_geo": lambda: ek.exotic_price("asian_geo", S, K, T, R, SIG, n_paths=1,
                                         control_variate=True, device="cpu"),
    "lr_on_cv_kind": lambda: ek.exotic_lr_greeks("asian_arith_cv", S, K, T, R, SIG, n_paths=1,
                                                 device="cpu"),
    "inverted_corridor": lambda: ek.range_accrual_price(S, 110.0, 90.0, T, R, SIG,
                                                        device="cpu"),
    "book_structured_kind": lambda: ek.exotic_book_price("autocall", S, [100.0], T, R, SIG,
                                                         device="cpu"),
    "book_qmc": lambda: ek.exotic_book_price("asian_arith", S, [100.0], T, R, SIG,
                                             sampler="sobol_bb_hash", device="cpu"),
    "book_missing_barriers": lambda: ek.exotic_book_price("barrier_up-and-out", S,
                                                          [95.0, 105.0], T, R, SIG,
                                                          device="cpu"),
    "book_length_mismatch": lambda: ek.exotic_book_price("barrier_up-and-out", S,
                                                         [95.0, 105.0], T, R, SIG,
                                                         barriers=[120.0], device="cpu"),
    "book_empty": lambda: ek.exotic_book_price("asian_arith", S, [], T, R, SIG, device="cpu"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors(case):
    with pytest.raises(ValidationError):
        VALIDATION[case]()


def test_degenerate_corridor_accrues_every_step():
    p, _, _ = ek.range_accrual_price(S, 1e-6, 1e9, T, R, SIG, n_paths=1, n_steps=8,
                                     sampler="hash", device="cpu")
    assert p.item() == pytest.approx(100.0 * np.exp(-0.05), rel=1e-5)


# ---------------------------------------------------------------------------
# books façade and the dataclasses
# ---------------------------------------------------------------------------
FACADE = [("asian", {}), ("asian", dict(averaging="geometric")), ("lookback", {}),
          ("lookback", dict(floating=False)), ("barrier", dict(barrier_type="down-and-in")),
          ("one-touch", dict(direction="down")), ("no-touch", {}),
          ("double-barrier", dict(knock="in")), ("double-touch", dict(touch="one"))]


@pytest.mark.parametrize("kind,kw", FACADE)
def test_facade_kernel_kind_matches_reference(kind, kw):
    assert books.facade_kernel_kind(kind, **kw) == jbooks.facade_kernel_kind(kind, **kw)


def test_book_quote_matches_reference():
    kw = dict(barriers=[110.0, 120.0], n_paths=60_000, n_steps=N_STEPS, sampler="hash", seed=2)
    for greeks in (False, True):
        ours = books.exotic_book_quote("barrier", S, [95.0, 100.0], T, R, greeks=greeks,
                                       device="cpu", **kw)
        ref = jbooks.exotic_book_quote("barrier", S, [95.0, 100.0], T, R, greeks=greeks, **kw)
        _dicts_close(ours, ref)


def test_book_quote_validation():
    with pytest.raises(ValidationError, match="needs params"):
        books.exotic_book_quote("asian", S, [K], T, R, model="heston", device="cpu")
    with pytest.raises(ValidationError):
        books.exotic_book_quote("asian", S, [K], T, R, model="sabr", device="cpu")
    with pytest.raises(ValidationError):
        books.facade_kernel_kind("barrier", barrier_type="sideways")
    with pytest.raises(ValidationError):
        books.facade_kernel_kind("rainbow")


def test_dataclass_engines():
    kw = dict(n_paths=1, n_steps=N_STEPS, seed=4, device="cpu")
    asian = tex.AsianOption(S, K, T, R, SIG, engine="pallas", **kw)
    assert asian.device == "cpu"
    p, se = asian.price(return_stderr=True)
    ref = ek.exotic_price("asian_arith", S, K, T, R, SIG, n_paths=1, n_steps=N_STEPS, seed=4,
                          device="cpu")
    assert p.item() == ref[0].item() and se.item() == ref[1].item()
    g = asian.greeks()
    assert g["paths"] == ek.PATHS_PER_BLOCK_G and math.isfinite(g["vega"].item())
    barrier = tex.BarrierOption(S, K, 120.0, T, R, SIG, engine="pallas", **kw)
    assert barrier.price().item() == ek.exotic_price(
        "barrier_up-and-out", S, K, T, R, SIG, barrier=120.0, n_paths=1, n_steps=N_STEPS,
        seed=4, device="cpu")[0].item()
    for opt in (tex.LookbackOption(S, K, T, R, SIG, engine="pallas", **kw),
                tex.AutocallableNote(S, T, R, SIG, engine="pallas", **kw),
                tex.CliquetOption(S, T, R, SIG, n_periods=4, engine="pallas", **kw)):
        assert math.isfinite(opt.price().item())
    # scan engine, and the defaults of the reference's dataclasses
    scan = tex.CliquetOption(S, T, R, SIG, n_periods=4, n_steps=8, n_paths=10_000, device="cpu")
    assert scan.engine == "scan" and math.isfinite(scan.price().item())
    assert tex.AsianOption(S, K, T, R, SIG).device == "cuda"
    g = tex.LookbackOption(S, K, T, R, SIG, n_paths=20_000, n_steps=8, device="cpu").greeks()
    assert g["delta"].item() == pytest.approx(g["price"].item() / S, rel=1e-4)
    assert math.isfinite(tex.price_barrier_option(S, K, 120.0, T, R, SIG, n_paths=5000,
                                                  device="cpu").item())
    assert math.isfinite(tex.price_asian_option(S, K, T, R, SIG, n_paths=5000,
                                                device="cpu").item())
    assert math.isfinite(tex.price_lookback_option(S, K, T, R, SIG, n_paths=5000,
                                                   device="cpu").item())


# The American Longstaff–Schwartz pricer: different generators, so the port
# and the reference agree within 4 combined standard errors; the lower-bound
# estimate sits below the CRR American and above the European.
def test_american_lsm_matches_reference():
    from optionslab_tpu_torch.models.binomial import binomial_price
    from optionslab_tpu_torch.models.black_scholes import bs_price
    from optionslab_tpu_torch.types import ContractBatch

    kw = dict(n_paths=40_000, n_dates=25)
    p, se = tex.american_lsm_price(S, K, T, R, SIG, torch.Generator().manual_seed(0), -1.0,
                                   return_stderr=True, **kw)
    rp, rse = jex.american_lsm_price(S, K, T, R, SIG, jax.random.PRNGKey(0), -1.0,
                                     return_stderr=True, **kw)
    assert p.dtype == torch.float32
    assert abs(_f(p) - _f(rp)) < 4 * math.hypot(_f(se), _f(rse))
    crr = _f(binomial_price(ContractBatch.make(S, K, T, R, SIG, "put", dtype=torch.float64),
                            american=True, n_steps=256))
    assert _f(bs_price(S, K, T, R, SIG, -1.0)) < _f(p) < crr + 4 * _f(se)
    # a call without dividends is never exercised early: the European price
    c, se_c = tex.american_lsm_price(S, K, T, R, SIG, torch.Generator().manual_seed(1), 1.0,
                                     return_stderr=True, **kw)
    assert abs(_f(c) - _f(bs_price(S, K, T, R, SIG, 1.0))) < 4 * _f(se_c)


def test_lsm_exercise_boundary_and_dataclass():
    b = tex.lsm_exercise_boundary(S, K, T, R, SIG, torch.Generator().manual_seed(2),
                                  n_paths=20_000, n_dates=10)
    rb = np.asarray(jex.lsm_exercise_boundary(S, K, T, R, SIG, jax.random.PRNGKey(2),
                                              n_paths=20_000, n_dates=10))
    assert b.shape == rb.shape == (9,)
    live = ~np.isnan(rb) & ~np.isnan(b.numpy())
    assert live[3:].all() and np.all(np.abs(b.numpy()[live] - rb[live]) < 4.0)
    assert np.all(b.numpy()[live] < K)  # a put exercises below the strike
    opt = tex.AmericanOptionLSM(S, K, T, R, SIG, n_paths=20_000, n_dates=10, device="cpu")
    assert opt.device == "cpu" and tex.AmericanOptionLSM(S, K, T, R, SIG).device == "cuda"
    assert _f(opt.price()) == pytest.approx(_f(tex.price_american_lsm(
        S, K, T, R, SIG, n_paths=20_000, n_dates=10, device="cpu")), rel=1e-6)
    assert opt.exercise_boundary().shape == (9,)
