"""The Heston/Bates exotic kernel's plain version against the JAX package's
``_heston_exotic_kernel``, the wrappers against their JAX namesakes, and the
statistical and oracle checks of ``tests/test_heston_exotics.py`` on the port.

On the CPU the port runs the plain torch version of ``csrc/heston_exotic.cu``;
the JAX kernel runs in TPU interpret mode with ``sampler="hash"`` (the JAX
``prng`` has no CPU mode) at one path block and 8 steps, its arithmetic in
float32. Both draw the same uniforms from the same counters. The CUDA kernel
itself is held to the plain version in ``test_torch_cuda.py`` and by
``chip_smoke.py``, on a card.

Tolerances, per moment, with their reasons:

* pay, pay² and the pay-at-hit / autocall DR moment: rtol 1e-5 per row.
  XLA's and torch's float32 ``log/exp/sin/cos`` differ by an ulp on some
  inputs and the sums run in another order; measured ≤ 3e-7. No row here is
  decided by a path that sits on a barrier within an ulp (an indicator that
  flips between the two libms would move a row by one lane's payoff): the
  inputs were checked for that, every kind at one block × 8 steps.
* D1, DG, DV (signed: they cancel inside a row): rtol 1e-5 of the moment's
  largest row; measured ≤ 3e-7.
* SR and TS, the rate and maturity scores: rtol 1e-5 of the largest row plus
  LR_LANE_TOL = 0.1 of the row's largest lane term. Each step's score
  divides by √v⁺, and a variance near 0 is the difference of O(θ) terms, so
  its relative error is unbounded: an ulp of libm upstream moves the score of
  a lane that grazes v = 0 by a fraction of itself (measured on the Asian
  and the autocall: ≤ 41 of 16384 four-lane groups off, each by ≤ 1.04e-2
  of the row's largest lane term).
* Wrappers: price, stderr and the zo₀/v0-score Greeks to rtol 1e-5 (float32
  rounding of the reductions); rho and theta, which carry SR and TS, to 1e-2
  of max(|value|, price) for the reason above.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.models.bates import BatesParams as JBates
from optionslab_tpu.models.books import exotic_book_quote as j_book_quote
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu.ops import heston_pallas as hp
from optionslab_tpu.utils.exceptions import ValidationError as JValidationError
from optionslab_tpu_torch.models import exotics as tex
from optionslab_tpu_torch.models import heston_exotics as scan
from optionslab_tpu_torch.models.bates import BatesParams
from optionslab_tpu_torch.models.books import exotic_book_quote
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.ops import heston_exotic_kernel as hx
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, K, T, R, Q = 100.0, 100.0, 1.0, 0.05, 0.01
N_STEPS = 8
SEED = 3
RTOL = 1e-5
LR_LANE_TOL = 0.1
CPU = "cpu"
PAR, JPAR = HestonParams.make(), JHeston.make()
BPAR, JBPAR = BatesParams.make(), JBates.make()
BAND = (85.0, 118.0)
STRUCTURED_SLOTS = {  # A..E of the structured kinds, as their wrappers set them
    "cliquet": [-0.03, 0.03, 0.0, 1e9, 100.0],
    "autocall": [0.0, math.log(0.9), math.log(0.8), 2.0, 100.0],
    "range_accrual": [math.log(0.9), math.log(1.1), 0.0, 0.0, 100.0],
}


def _barrier(kind):
    return 120.0 if "up" in kind else (85.0 if "down" in kind else 0.0)


def _vectors(kind, scheme="euler", bates=False, n_steps=N_STEPS):
    """(JAX float32 vector, port float32 vector) of one launch; the port's
    must equal the reference's bit for bit."""
    jp, _ = hp._exotic_params(S, K, T, R, JBPAR if bates else JPAR, Q, _barrier(kind), n_steps,
                              scheme)
    tp, _ = hx._exotic_params(S, K, T, R, BPAR if bates else PAR, Q, _barrier(kind), n_steps,
                              scheme)
    if "double" in kind:
        hp._set_double_band(jp, S, *BAND)
        hx._set_double_band(tp, S, *BAND)
    if kind in STRUCTURED_SLOTS:
        jp[hp._HX_A:hp._HX_DYN] = tp[hx._HX_A:hx._HX_DYN] = STRUCTURED_SLOTS[kind]
    jp, tp = np.asarray(jp, np.float32), np.asarray(tp, np.float32)
    np.testing.assert_array_equal(tp.view(np.uint32), jp.view(np.uint32))
    return jp, tp


def _period(kind):
    return 4 if kind in ("cliquet", "autocall") else 1


def _jax_rows(jp, book=None, **kw) -> np.ndarray:
    outs = hp._launch_exotic(jnp.asarray([SEED, 0], jnp.int32), jnp.asarray(jp), book,
                             n_steps=N_STEPS, n_blocks=1, sampler=kw.pop("sampler", "hash"),
                             **kw)
    return np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs])


def _port_rows(tp, book=None, **kw):
    """(per-row sums, each row's largest |lane term|) of the plain version,
    float64 numpy (n_mom, ROWS)."""
    params = torch.tensor(tp)
    book_t = params[list(hx._BOOK_SLOTS)].reshape(1, 7) if book is None else torch.tensor(book)
    terms = hx._exotic_block_plain(SEED, torch.tensor([[[0]]], dtype=torch.int32), params,
                                   book_t, n_steps=N_STEPS, sampler=kw.pop("sampler", "hash"),
                                   **kw)
    rows = np.stack([t.double().sum(dim=(0, 2)).numpy() for t in terms])
    lane_max = np.stack([t.double().abs().amax(dim=(0, 2)).numpy() for t in terms])
    return rows, lane_max


def assert_rows_close(ours, ref, lane_max):
    """The module docstring's per-moment tolerances."""
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    diff = np.abs(ours - ref)
    big = np.abs(ref).max(axis=1)
    for m in range(len(ref)):
        if m in (0, 1):
            bound = RTOL * np.abs(ref[m])
        elif m in (5, 6):  # SR, TS
            bound = RTOL * big[m] + LR_LANE_TOL * lane_max[m]
        else:
            bound = np.full(ref.shape[1], RTOL * big[m])
        assert np.all(diff[m] <= bound + 1e-12), (m, (diff[m] / np.maximum(bound, 1e-30)).max())


# ---------------------------------------------------------------------------
# geometry, layout, parameter vectors
# ---------------------------------------------------------------------------
def test_kinds_layout_and_geometry():
    assert hx.HESTON_EXOTIC_KINDS == hp.HESTON_EXOTIC_KINDS
    assert (hx.ROWS, hx.LANES, hx.PATHS_PER_BLOCK) == (hp.ROWS, hp.LANES, hp.PATHS_PER_BLOCK)
    assert (hx._HX_S0, hx._HX_K, hx._HX_LOGB, hx._HX_E, hx._HX_DYN) == (
        hp._HX_S0, hp._HX_K, hp._HX_LOGB, hp._HX_E, hp._HX_DYN)
    assert [hx.n_params(s, j) for s in ("euler", "qe") for j in (False, True)] == [19, 25, 23, 29]


@pytest.mark.parametrize("scheme", ["euler", "qe"])
@pytest.mark.parametrize("bates", [False, True])
def test_exotic_params_bitwise(scheme, bates):
    """The float32 vector, thresholds p0, p0(1+λdt), p0(1+λdt+½(λdt)²), the
    compensated drift, log(B/S0) and the QE constants included, equals the
    reference's bit for bit (a threshold off by an ulp moves a jump count)."""
    for kind in ("barrier_up-and-out", "barrier_down-and-in", "barrier_double-out", "asian_arith"):
        _vectors(kind, scheme, bates)
    _, tp = _vectors("autocall", scheme, bates, n_steps=252)
    assert len(tp) == hx.n_params(scheme, bates)
    spot, rate, t = 101.3, 0.031, 0.73
    np.testing.assert_array_equal(
        hx._lr_scalars(spot, t, rate, BPAR if bates else PAR, 16),
        hp._lr_scalars(spot, t, rate, JBPAR if bates else JPAR, 16))


def test_structured_params_match_reference_wrappers():
    """The slots each structured wrapper of the reference writes."""
    jp, _ = hp._exotic_params(S, 0.0, T, R, JPAR, Q, 0.0, 12, "euler")
    jp[hp._HX_A] = math.log(max(0.95, 1e-9))
    jp[hp._HX_B] = math.log(max(0.75, 1e-9))
    jp[hp._HX_C] = math.log(max(0.6, 1e-9))
    jp[hp._HX_D] = 100.0 * 0.07 / 3
    jp[hp._HX_E] = 100.0
    tp, _ = hx._autocall_params(S, T, R, PAR, Q, 100.0, 0.95, 0.75, 0.6, 0.07, 3, 12, "euler")
    np.testing.assert_array_equal(np.float32(tp), np.float32(jp))
    jp, _ = hp._exotic_params(S, 0.0, T, R, JPAR, Q, 0.0, 12, "qe")
    jp[hp._HX_A] = math.log(90.0 / S)
    jp[hp._HX_B] = math.log(110.0 / S)
    jp[hp._HX_E] = 50.0
    tp, _ = hx._range_params(S, 90.0, 110.0, T, R, PAR, Q, 50.0, 12, "qe")
    np.testing.assert_array_equal(np.float32(tp), np.float32(jp))


# ---------------------------------------------------------------------------
# the kernel row for row against the JAX kernel in interpret mode
# ---------------------------------------------------------------------------
PUTS = ("asian_geo", "lookback_fixed", "barrier_down-and-in", "barrier_double-out")


@pytest.mark.parametrize("kind", hp.HESTON_EXOTIC_KINDS)
def test_rows_match_reference(kind):
    """Every kind, Euler, with lr (all 7 or 8 moments) and without (pay and
    pay² of the same paths); puts for a few kinds whose payoff takes cp."""
    jp, tp = _vectors(kind)
    kw = dict(kind=kind, cp=-1.0 if kind in PUTS else 1.0, period=_period(kind))
    ref = _jax_rows(jp, scheme="euler", lr=True, **kw)
    ours, lane_max = _port_rows(tp, scheme="euler", lr=True, jumps=False, **kw)
    assert len(ref) == hx._n_moments(kind, True)
    assert_rows_close(ours, ref, lane_max)
    price, lane_p = _port_rows(tp, scheme="euler", lr=False, jumps=False, **kw)
    assert_rows_close(price, ref[:2], lane_p)


@pytest.mark.parametrize("kind", ["asian_geo", "lookback_float", "barrier_up-and-in",
                                  "no_touch_double", "one_touch_down_hit", "cliquet"])
def test_qe_rows_match_reference(kind):
    jp, tp = _vectors(kind, "qe")
    kw = dict(kind=kind, cp=1.0, period=_period(kind), scheme="qe", lr=False)
    ours, lane_max = _port_rows(tp, jumps=False, **kw)
    assert_rows_close(ours, _jax_rows(jp, **kw), lane_max)


@pytest.mark.parametrize("kind,scheme,lr,cp", [
    ("asian_arith", "euler", True, 1.0), ("barrier_down-and-in", "euler", False, -1.0),
    ("autocall", "euler", True, 1.0), ("one_touch_down", "qe", False, 1.0)])
def test_jump_rows_match_reference(kind, scheme, lr, cp):
    """Bates: the count thresholds, the size normal and, with lr, the Poisson
    dt-score in TS."""
    jp, tp = _vectors(kind, scheme, bates=True)
    kw = dict(kind=kind, cp=cp, period=_period(kind), scheme=scheme, lr=lr)
    ours, lane_max = _port_rows(tp, jumps=True, **kw)
    assert_rows_close(ours, _jax_rows(jp, jumps=True, **kw), lane_max)


@pytest.mark.parametrize("kind", ["barrier_up-and-out"])
def test_bridge_rows_match_reference(kind):
    """sobol_bb: the two-pass bridge over both streams, with this kernel's
    own scramble salt (the Asian through its wrapper below)."""
    jp, tp = _vectors(kind)
    kw = dict(kind=kind, cp=1.0, period=1, scheme="euler", lr=False, sampler="sobol_bb")
    ours, lane_max = _port_rows(tp, jumps=False, **kw)
    assert_rows_close(ours, _jax_rows(jp, **kw), lane_max)


@pytest.mark.parametrize("nc,kind,lr", [(2, "barrier_up-and-out", True), (8, "asian_arith", False),
                                        (8, "barrier_double-in", True)])
def test_book_rows_match_reference(nc, kind, lr):
    """Books: rows interleave contracts (contract = row % nc), 7 slots each."""
    strikes = np.linspace(90.0, 110.0, nc).tolist()
    kw_b = dict(barriers=np.linspace(115.0, 135.0, nc).tolist()) if "up" in kind else {}
    if "double" in kind:
        kw_b = dict(lowers=np.linspace(80.0, 88.0, nc).tolist(),
                    uppers=np.linspace(112.0, 125.0, nc).tolist())
    book, _, nc_pad, *_ = hx._heston_book_vec(kind, S, strikes, **{
        "barriers": None, "lowers": None, "uppers": None, **kw_b})
    jbook, jnc, jnc_pad, *_ = hp._heston_book_vec(kind, S, strikes, **{
        "barriers": None, "lowers": None, "uppers": None, **kw_b})
    assert nc_pad == jnc_pad == nc
    book = np.asarray(book, np.float32)
    np.testing.assert_array_equal(book.ravel(), np.asarray(jbook, np.float32))
    jp, tp = _vectors(kind)
    kw = dict(kind=kind, cp=1.0, period=1, scheme="euler", lr=lr)
    ref = _jax_rows(jp, jnp.asarray(jbook), n_contracts=nc, **kw)
    ours, lane_max = _port_rows(tp, book, jumps=False, **kw)
    assert_rows_close(ours, ref, lane_max)


def test_plain_moments_shape_and_dtype():
    _, tp = _vectors("one_touch_up_hit")
    params = torch.tensor(tp)
    out = hx._heston_exotic_plain(SEED, 0, params, params[list(hx._BOOK_SLOTS)].reshape(1, 7),
                                  kind="one_touch_up_hit", n_steps=4, n_blocks=2, cp=1.0, lr=True)
    assert out.dtype == torch.float32 and out.shape == (8, hx.ROWS)


# ---------------------------------------------------------------------------
# the wrappers against their JAX namesakes
# ---------------------------------------------------------------------------
LR_KEYS = ("price", "std_error", "delta", "gamma", "vega_v0", "vega")


def _dict_close(ours, ref):
    assert set(ours) == set(ref) and ours["paths"] == ref["paths"]
    for key, v in ref.items():
        if key in ("paths", "delta_convention"):
            assert ours[key] == v
            continue
        o, r = np.asarray(ours[key], np.float64), np.asarray(v, np.float64)
        scale = np.maximum(np.abs(r), np.abs(np.asarray(ref["price"], np.float64)))
        rtol = RTOL if key in LR_KEYS else 1e-2
        assert np.all(np.abs(o - r) <= rtol * scale + 1e-6), (key, o, r)


def _triple_close(ours, ref):
    (p, se, n), (jp_, jse, jn) = ours, ref
    assert n == jn and p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(jp_), rtol=RTOL)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-4)


COMMON = dict(n_paths=1, n_steps=N_STEPS, seed=SEED, sampler="hash")


@pytest.mark.parametrize("name,args,kw,bates", [
    ("exotic_price", ("barrier_up-and-in", S, K, T, R), dict(barrier=120.0, cp=-1.0), False),
    ("exotic_price", ("barrier_up-and-in", S, K, T, R), dict(barrier=120.0, cp=-1.0), True),
    ("exotic_price", ("one_touch_double_hit", S, K, T, R), dict(lower=85.0, upper=118.0,
                                                                 scheme="qe"), True),
    ("exotic_price", ("asian_arith", S, K, T, R), dict(sampler="sobol_bb"), False),
    ("cliquet_price", (S, T, R), dict(n_periods=4, scheme="qe"), False),
    ("cliquet_price", (S, T, R), dict(n_periods=4), True),
    ("autocall_price", (S, T, R), dict(n_obs=4), True),
    ("range_accrual_price", (S, 90.0, 110.0, T, R), {}, False),
])
def test_price_wrappers_match_reference(name, args, kw, bates):
    jfn, fn = getattr(hp, f"pallas_heston_{name}"), getattr(hx, f"heston_kernel_{name}")
    ref = jfn(*args, JBPAR if bates else JPAR, **{**COMMON, **kw})
    _triple_close(fn(*args, BPAR if bates else PAR, **{**COMMON, **kw}, device=CPU), ref)


@pytest.mark.parametrize("name,args,kw", [
    ("exotic_lr_greeks", ("barrier_down-and-out", S, K, T, R), dict(barrier=85.0)),
    ("exotic_lr_greeks", ("one_touch_up_hit", S, K, T, R), dict(barrier=115.0)),
    ("cliquet_lr_greeks", (S, T, R), dict(n_periods=4)),
    ("autocall_lr_greeks", (S, T, R), dict(n_obs=4)),
    ("range_accrual_lr_greeks", (S, 90.0, 110.0, T, R), {}),
])
def test_lr_wrappers_match_reference(name, args, kw):
    jfn, fn = getattr(hp, f"pallas_heston_{name}"), getattr(hx, f"heston_kernel_{name}")
    bates = name.startswith("exotic")  # the jump branch through the LR wrappers too
    ref = jfn(*args, JBPAR if bates else JPAR, **{**COMMON, **kw})
    _dict_close(fn(*args, BPAR if bates else PAR, **{**COMMON, **kw}, device=CPU), ref)


def test_book_wrappers_match_reference():
    kw = dict(barriers=[120.0, 130.0, 140.0], n_paths=60_000, n_steps=N_STEPS, seed=SEED,
              sampler="hash")
    ref = hp.pallas_heston_exotic_book_price("barrier_up-and-out", S, [95.0, 100.0, 105.0], T,
                                             R, JBPAR, scheme="qe", **kw)
    ours = hx.heston_kernel_exotic_book_price("barrier_up-and-out", S, [95.0, 100.0, 105.0], T,
                                              R, BPAR, scheme="qe", device=CPU, **kw)
    assert ours[0].shape == (3,)
    _triple_close(ours, ref)
    ref = hp.pallas_heston_exotic_book_lr_greeks("one_touch_up", S, [K, K], T, R, JPAR,
                                                 **{**kw, "barriers": [115.0, 125.0]})
    ours = hx.heston_kernel_exotic_book_lr_greeks("one_touch_up", S, [K, K], T, R, PAR,
                                                  device=CPU, **{**kw, "barriers": [115.0, 125.0]})
    _dict_close(ours, ref)


def test_single_contract_barrier_book_carries_levels():
    """A book of one contract prices as its single-contract call (the
    reference's regression ebd58f5/357196e: the levels must reach the
    launch), for a barrier and a double band."""
    for kind, kw_b, kw_s in (("barrier_up-and-out", dict(barriers=[125.0]), dict(barrier=125.0)),
                             ("barrier_double-out", dict(lowers=[80.0], uppers=[125.0]),
                              dict(lower=80.0, upper=125.0))):
        common = dict(n_paths=1, n_steps=6, sampler="hash", seed=31, device=CPU)
        bp, bse, nb = hx.heston_kernel_exotic_book_price(kind, S, [K], T, R, PAR, **kw_b,
                                                          **common)
        sp, sse, ns = hx.heston_kernel_exotic_price(kind, S, K, T, R, PAR, **kw_s, **common)
        assert nb == ns and float(sp) > 0.0, kind
        np.testing.assert_allclose(float(bp[0]), float(sp), rtol=1e-6, err_msg=kind)
        np.testing.assert_allclose(float(bse[0]), float(sse), rtol=1e-5, err_msg=kind)


def test_single_contract_touch_book_lr_carries_barrier():
    common = dict(n_paths=1, n_steps=6, sampler="hash", seed=37, device=CPU)
    g = hx.heston_kernel_exotic_book_lr_greeks("one_touch_up", S, [K], T, R, PAR,
                                               barriers=[120.0], **common)
    gs = hx.heston_kernel_exotic_lr_greeks("one_touch_up", S, K, T, R, PAR, barrier=120.0,
                                           **common)
    assert 0.0 < float(gs["price"]) < math.exp(-R * T)
    for key in ("price", "delta", "vega_v0", "rho", "theta"):
        np.testing.assert_allclose(float(g[key][0]), float(gs[key]), rtol=2e-5, atol=1e-7,
                                   err_msg=key)


VALIDATION = [  # the reference's ValidationError cases, one for one
    ("exotic_price", ("nope", S, K, T, R), {}),
    ("exotic_price", ("cliquet", S, K, T, R), {}),
    ("exotic_lr_greeks", ("autocall", S, K, T, R), {}),
    ("exotic_lr_greeks", ("nope", S, K, T, R), {}),
    ("exotic_lr_greeks", ("asian_arith", S, K, T, R), dict(sampler="sobol_bb")),
    ("exotic_price", ("asian_arith", S, K, T, R), dict(sampler="sobol_bb", scheme="qe")),
    ("exotic_price", ("asian_arith", S, K, T, R), dict(sampler="sobol")),
    ("exotic_price", ("asian_arith", S, K, T, R), dict(sampler="sobol_bb", n_steps=1)),
    ("exotic_price", ("barrier_double-out", S, K, T, R), dict(lower=120.0, upper=80.0)),
    ("autocall_price", (S, T, R), dict(n_obs=5, n_steps=16)),
    ("cliquet_lr_greeks", (S, T, R), dict(n_periods=5, n_steps=16)),
    ("autocall_lr_greeks", (S, T, R), dict(sampler="sobol_bb")),
    ("range_accrual_price", (S, 110.0, 90.0, T, R), {}),
    ("range_accrual_lr_greeks", (S, 90.0, 110.0, T, R), dict(sampler="sobol_bb")),
    ("exotic_book_price", ("cliquet", S, [100.0], T, R), {}),
    ("exotic_book_price", ("asian_arith", S, [100.0], T, R), dict(sampler="sobol_bb")),
    ("exotic_book_price", ("one_touch_up", S, [100.0, 100.0], T, R), {}),
    ("exotic_book_price", ("barrier_double-out", S, [100.0], T, R), dict(lowers=[90.0])),
    ("exotic_book_lr_greeks", ("asian_arith", S, list(range(90, 219)), T, R), {}),
]


@pytest.mark.parametrize("name,args,kw", VALIDATION)
def test_validation_matches_reference(name, args, kw):
    with pytest.raises(JValidationError):
        getattr(hp, f"pallas_heston_{name}")(*args, JPAR, n_paths=1, **kw)
    with pytest.raises(ValidationError):
        getattr(hx, f"heston_kernel_{name}")(*args, PAR, n_paths=1, device=CPU, **kw)


def test_port_only_validation_and_dispatch():
    _, tp = _vectors("asian_arith")
    params = torch.tensor(tp)
    book = params[list(hx._BOOK_SLOTS)].reshape(1, 7)
    kw = dict(kind="asian_arith", n_steps=4, n_blocks=1, cp=1.0)
    with pytest.raises(ValidationError, match="samplers"):
        hx._heston_exotic_plain(0, 0, params, book, sampler="halton", **kw)
    with pytest.raises(ValidationError, match="lr needs"):
        hx._heston_exotic_plain(0, 0, params, book, scheme="qe", lr=True, **kw)
    with pytest.raises(ValidationError, match="euler|qe"):
        hx.heston_kernel_exotic_price("asian_arith", S, K, T, R, PAR, scheme="milstein",
                                      n_paths=1, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        hx._heston_exotic_cuda(0, 0, params, book, **kw)
    with pytest.raises(ValueError, match="device"):
        hx._dispatch(hx._heston_exotic_cuda, hx._heston_exotic_plain, torch.device("meta"), 0, 0,
                     params, book, **kw)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without a card")
def test_cuda_default_raises_without_a_card():
    """The entry points default to the card and never fall back to the CPU."""
    calls = []
    plain = hx._heston_exotic_plain
    try:
        hx._heston_exotic_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
        with pytest.raises((RuntimeError, AssertionError)):
            hx.heston_kernel_exotic_price("asian_arith", S, K, T, R, PAR, n_paths=1)
    finally:
        hx._heston_exotic_plain = plain
    assert calls == []


def test_book_quote_qe_greeks_raises():
    """The reference's books.py:97 runs the Euler LR ladder when asked for
    greeks under scheme='qe'; the port refuses."""
    kw = dict(model="heston", n_paths=1, n_steps=4, scheme="qe", greeks=True)
    ref = j_book_quote("asian", S, [K], T, R, params=JPAR, sampler="hash", **kw)
    assert "delta" in ref  # silently the Euler ladder
    with pytest.raises(ValidationError, match="scheme"):
        exotic_book_quote("asian", S, [K], T, R, params=PAR, device=CPU, **kw)
    out = exotic_book_quote("barrier", S, [95.0, 105.0], T, R, model="bates", params=BPAR,
                            barriers=[125.0, 130.0], n_paths=1, n_steps=4, scheme="qe",
                            sampler="hash", device=CPU)
    assert out["model"] == "bates" and len(out["price"]) == 2


# ---------------------------------------------------------------------------
# the statistical and oracle checks of tests/test_heston_exotics.py (one or
# two path blocks, 16 steps, hash)
# ---------------------------------------------------------------------------
N16 = dict(n_steps=16, sampler="hash", device=CPU)


@pytest.mark.parametrize("kind,cp,bates,scheme", [
    ("asian_arith", 1.0, False, "euler"), ("barrier_up-and-out", 1.0, False, "qe"),
    ("barrier_down-and-in", -1.0, True, "euler"), ("one_touch_down", 1.0, True, "euler")])
def test_kernel_matches_scan_engine(kind, cp, bates, scheme):
    """The kernel's plain version against the scan engine (independent
    draws): within 5 combined standard errors + 0.01 (the reference's bound)."""
    par = BPAR if bates else PAR
    pk, sk, _ = hx.heston_kernel_exotic_price(kind, S, K, T, R, par, cp=cp,
                                              barrier=_barrier(kind), n_paths=1, scheme=scheme,
                                              **N16)
    ps, ss = scan.heston_exotic_price(kind, S, K, T, R, par, torch.Generator().manual_seed(5),
                                      cp=cp, barrier=_barrier(kind), n_paths=100_000,
                                      n_steps=16, scheme=scheme, return_stderr=True)
    assert abs(float(pk) - float(ps)) < 5 * math.hypot(float(sk), float(ss)) + 0.01


def test_structured_kernel_matches_scan_engine():
    gen = torch.Generator()
    for fn, sfn, kw in ((hx.heston_kernel_cliquet_price, scan.heston_cliquet_price,
                         dict(n_periods=4)),
                        (hx.heston_kernel_autocall_price, scan.heston_autocall_price,
                         dict(n_obs=4))):
        pk, sk, _ = fn(S, T, R, BPAR, n_paths=1, **kw, **N16)
        ps, ss = sfn(S, T, R, BPAR, gen.manual_seed(9), n_paths=100_000, n_steps=16,
                     return_stderr=True, **kw)
        assert abs(float(pk) - float(ps)) < 5 * math.hypot(float(sk), float(ss)) + 0.02


LIM = HestonParams.make(0.04, 2.0, 0.04, 1e-7, -0.7)  # σ_v → 0, v0 = θ: GBM at σ = 0.2


def test_gbm_limit_matches_closed_forms():
    """σ_v → 0, v0 = θ: the Euler kernel is GBM (σ = 0.2): the geometric
    Asian and the range accrual against their exact discrete closed forms
    within 4 standard errors + 1e-3."""
    p, se, _ = hx.heston_kernel_exotic_price("asian_geo", S, K, T, R, LIM, n_paths=1, **N16)
    cf = float(tex.geometric_asian_closed_form(S, K, T, R, 0.2, 1.0, 0.0, 16))
    assert abs(float(p) - cf) < 4 * float(se) + 1e-3, (float(p), cf)
    p, se, _ = hx.heston_kernel_range_accrual_price(S, 90.0, 110.0, T, R, LIM, n_paths=1, **N16)
    cf = float(tex.range_accrual_closed_form(S, 90.0, 110.0, T, R, 0.2, n_steps=16))
    assert abs(float(p) - cf) < 4 * float(se) + 0.05, (float(p), cf)


def test_lr_ladder_vs_crn_fd():
    """The Asian LR ladder against central finite differences of the kernel
    itself on common random numbers (the hash counters do not depend on the
    inputs), at 131072 paths: the reference's bounds at 250k (delta 0.02,
    rho 5% + 0.5) scaled by √(250000/131072); the maturity score's theta
    against a CRN difference in T (the reference's 0.2 at 500k, scaled)."""
    g = hx.heston_kernel_exotic_lr_greeks("asian_arith", S, K, T, R, PAR, n_paths=1, **N16)

    def price(s=S, rr=R, t=T):
        return float(hx.heston_kernel_exotic_price("asian_arith", s, K, t, rr, PAR, n_paths=1,
                                                   **N16)[0])

    scale = math.sqrt(250_000 / 131_072)
    assert abs(float(g["price"]) - price()) < 1e-6  # the same paths
    fd_delta = (price(s=S + 0.5) - price(s=S - 0.5)) / 1.0
    fd_rho = (price(rr=R + 0.002) - price(rr=R - 0.002)) / 0.004
    fd_theta = -(price(t=T + 0.01) - price(t=T - 0.01)) / 0.02
    assert abs(float(g["delta"]) - fd_delta) < 0.02 * scale
    assert abs(float(g["rho"]) - fd_rho) < (0.05 * abs(fd_rho) + 0.5) * scale
    assert abs(float(g["theta"]) - fd_theta) < 0.2 * math.sqrt(500_000 / 131_072)
    assert float(g["vega"]) == pytest.approx(2.0 * 0.2 * float(g["vega_v0"]), rel=1e-6)


def test_jumps_fatten_the_left_tail():
    pj, _, _ = hx.heston_kernel_exotic_price("barrier_down-and-in", S, K, T, R, BPAR, cp=-1.0,
                                             barrier=80.0, n_paths=1, **N16)
    ph, _, _ = hx.heston_kernel_exotic_price("barrier_down-and-in", S, K, T, R, PAR, cp=-1.0,
                                             barrier=80.0, n_paths=1, **N16)
    assert float(pj) > float(ph) + 0.5


def test_book_matches_singles():
    strikes = [90.0, 100.0, 110.0]
    bp, bse, _ = hx.heston_kernel_exotic_book_price("asian_arith", S, strikes, T, R, PAR,
                                                    n_paths=30_000, n_steps=6, sampler="hash",
                                                    seed=3, device=CPU)
    for i, k in enumerate(strikes):
        sp, sse, _ = hx.heston_kernel_exotic_price("asian_arith", S, k, T, R, PAR, n_paths=1,
                                                   n_steps=6, sampler="hash", seed=11,
                                                   device=CPU)
        assert abs(float(bp[i]) - float(sp)) < 5 * math.hypot(float(bse[i]), float(sse)) + 1e-3
    assert float(bp[0]) > float(bp[1]) > float(bp[2])


def test_bridge_qmc_matches_plain_mc():
    ph, sh, _ = hx.heston_kernel_exotic_price("asian_arith", S, K, T, R, PAR, n_paths=1, **N16)
    pq, sq, _ = hx.heston_kernel_exotic_price("asian_arith", S, K, T, R, PAR, n_paths=1,
                                              **{**N16, "sampler": "sobol_bb"})
    assert abs(float(ph) - float(pq)) < 6 * float(sh) and float(sq) > 0.0
