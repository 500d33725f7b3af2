"""The SLV kernel's plain version against the JAX package's ``_slv_kernel``,
the pricer against ``SLVKernelPricer``, and the ``ValidationError`` cases of
``tests/test_slv_pallas.py``.

On the CPU the port runs the plain torch version of ``csrc/slv_mc.cu``; the
JAX kernel runs in TPU interpret mode with ``sampler="hash"`` (the JAX
``prng`` has no CPU mode) at one path block and 8 steps. The two
calibrations draw from different generators, so both kernels replay the JAX
pricer's own leverage table, cast once to float32, and the port's pricer is
built on it with ``SLVKernelPricer.from_numpy``. The CUDA kernel itself is
held to the plain version in ``test_torch_cuda.py`` and by
``chip_smoke.py``, on a card.

Tolerances, per moment, with their reasons:

* pay, pay² and the DR moment: rtol 1e-5 per row (XLA's and torch's float32
  libm differ by an ulp on some inputs; measured ≤ 5.4e-7);
* D1, DG, DX, DV and the lookback boundary moments (signed: they cancel
  inside a row): rtol 1e-5 of the moment's largest row (measured ≤ 4.9e-7);
* SR, the rate score: 1e-5 of its largest row plus LR_LANE_TOL = 0.1 of the
  row's largest lane term. Each step's score divides by √v⁺, and a variance
  near 0 is the difference of O(θ) terms: an ulp of libm upstream moves a
  grazing lane's score by a fraction of itself (measured ≤ 2.9e-3 of the
  largest row);
* the pricer's price and stderr to rtol 1e-5; the sticky-strike delta and
  gamma and the v0-vega to 1e-4 of max(|value|, 1e-2·price); rho, which
  carries SR, to 1e-2 of max(|value|, price).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu.models.local_vol import DupireLocalVol as JDupire
from optionslab_tpu.models.local_vol import sample_smile_iv_fn as j_smile
from optionslab_tpu.ops import slv_pallas as js
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.models.local_vol import DupireLocalVol, LocalVolSurface
from optionslab_tpu_torch.models.local_vol import sample_smile_iv_fn
from optionslab_tpu_torch.ops import slv_kernel as sk
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
SEED = 3
RTOL = 1e-5
LR_LANE_TOL = 0.1
CPU = "cpu"
BAND = (85.0, 118.0)
SLOTS = {"cliquet": (-0.03, 0.03, 0.0, 1e9, 100.0),  # A..E as the wrappers set them
         "autocall": (0.0, math.log(0.9), math.log(0.8), 2.0, 100.0),
         "range_accrual": (math.log(0.9), math.log(1.1), 0.0, 0.0, 100.0)}


@pytest.fixture(scope="module")
def jpricer():
    return js.SLVKernelPricer(JDupire(j_smile(), S, R), JPAR, T, mixing=1.0, n_steps=N_STEPS,
                              n_cal_paths=65_536)


@pytest.fixture(scope="module")
def pricer(jpricer):
    """The port's pricer on the JAX pricer's fitted leverage table."""
    return sk.SLVKernelPricer.from_numpy(jpricer.rows, jpricer.fit_residual, PAR, S, R, 0.0, T,
                                         mixing=1.0, device=CPU)


@pytest.fixture(scope="module")
def tdup():
    return DupireLocalVol(sample_smile_iv_fn(), S, R, device=CPU)


def _barrier(kind):
    return 120.0 if "up" in kind else 85.0


def _period(kind):
    return 4 if kind in ("cliquet", "autocall") else 1


def _vectors(jpricer, pricer, kind):
    """(JAX float32 vector, port vector): equal bit for bit."""
    if kind in SLOTS:
        jh, th = jpricer._head.copy(), pricer._head.copy()
        jh[js._S_A:js._S_E + 1] = th[sk._S_A:sk._S_E + 1] = SLOTS[kind]
        jp = np.concatenate([jh, jpricer.rows.ravel()])
        tp = pricer._vector(th)
    else:
        jp = jpricer._params_vec(kind, 100.0, _barrier(kind), *BAND)
        tp = pricer._params_vec(kind, 100.0, _barrier(kind), *BAND)
    jp = np.asarray(jp, np.float32)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), jp.view(np.uint32))
    return jp, tp


def assert_rows_close(ours, ref, lane_max):
    """The module docstring's per-moment tolerances."""
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    diff = np.abs(ours - ref)
    big = np.abs(ref).max(axis=1)
    for m in range(len(ref)):
        if m in (0, 1):
            bound = RTOL * np.abs(ref[m])
        elif m == 6:  # SR
            bound = RTOL * big[m] + LR_LANE_TOL * lane_max[m]
        else:
            bound = np.full(ref.shape[1], RTOL * big[m])
        assert np.all(diff[m] <= bound + 1e-12), (m, (diff[m] / np.maximum(bound, 1e-30)).max())


CASES = ([(k, lr, 1.0) for k in sk.KINDS + sk.STRUCTURED_KINDS for lr in (False, True)]
         + [(k, True, -1.0) for k in ("european", "asian_geo", "lookback_float",
                                      "lookback_fixed", "barrier_up-and-in")])


@pytest.fixture(scope="module")
def reference_sums(jpricer, pricer):
    """Per-row sums of the JAX kernel, one interpret run per (kind, cp), with
    ``lr``: Σpay and Σpay² come first and from the same paths with ``lr`` on
    or off."""
    cache = {}

    def get(kind, cp):
        if (kind, cp) not in cache:
            jp, _ = _vectors(jpricer, pricer, kind)
            outs = js._launch(jnp.asarray([SEED, 0], jnp.int32), jnp.asarray(jp), kind=kind,
                              n_steps=N_STEPS, n_blocks=1, cp=cp, sampler="hash", lr=True,
                              period=_period(kind))
            cache[kind, cp] = np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs])
        return cache[kind, cp]

    return get


@pytest.mark.parametrize("kind,lr,cp", CASES)
def test_plain_matches_reference_kernel(jpricer, pricer, reference_sums, kind, lr, cp):
    _, tp = _vectors(jpricer, pricer, kind)
    ref = reference_sums(kind, cp)[:sk._n_moments(kind, lr)]
    terms = sk._slv_block_plain(SEED, torch.tensor([[[0]]], dtype=torch.int32), tp, kind=kind,
                                n_steps=N_STEPS, cp=cp, period=_period(kind), sampler="hash",
                                lr=lr)
    ours = np.stack([t.double().sum(dim=(0, 2)).numpy() for t in terms])
    lane_max = np.stack([t.double().abs().amax(dim=(0, 2)).numpy() for t in terms])
    assert_rows_close(ours, ref, lane_max)
    rows = sk._slv_plain(SEED, 0, tp, kind=kind, n_steps=N_STEPS, n_blocks=1, cp=cp,
                         period=_period(kind), sampler="hash", lr=lr)
    assert rows.dtype == torch.float32 and rows.shape == (sk._n_moments(kind, lr), sk.ROWS)
    np.testing.assert_allclose(rows.double().numpy(), ours, rtol=1e-6, atol=1e-6)


def test_prng_plain_is_finite_and_differs_from_hash(pricer):
    tp = pricer._params_vec("barrier_up-and-out", 100.0, 120.0)
    kw = dict(kind="barrier_up-and-out", n_steps=N_STEPS, n_blocks=1, cp=1.0, lr=True)
    a = sk._slv_plain(SEED, 0, tp, sampler="prng", **kw)
    b = sk._slv_plain(SEED, 0, tp, sampler="hash", **kw)
    assert torch.isfinite(a).all() and not torch.equal(a, b)


@pytest.mark.parametrize("kind", ["european", "lookback_fixed", "autocall", "one_touch_up_hit",
                                  "cliquet"])
def test_combine_lr_matches_reference(jpricer, pricer, kind):
    rng = np.random.default_rng(5)
    tiles = [rng.normal(1.0, 0.5, (sk.ROWS, 128)).astype(np.float32)
             for _ in range(sk._n_moments(kind, True))]
    n = 2 * sk.PATHS_PER_BLOCK
    ref = jpricer._combine_lr([jnp.asarray(t) for t in tiles], n, kind)
    ours = pricer._combine_lr(torch.tensor(np.stack([t.sum(axis=1) for t in tiles])), n, kind)
    assert set(ours) == set(ref)
    for key in ("price", "std_error", "delta", "gamma", "vega_v0", "vega", "rho"):
        assert float(ours[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    for key in ("paths", "fit_residual", "delta_convention", "vega_convention"):
        assert ours[key] == ref[key], key


@pytest.mark.parametrize("kind,cp", [("european", 1.0), ("barrier_up-and-out", 1.0),
                                     ("no_touch_double", 1.0), ("one_touch_down_hit", 1.0),
                                     ("asian_arith", -1.0)])
def test_pricer_price_matches_reference(jpricer, pricer, kind, cp):
    kw = dict(cp=cp, barrier=_barrier(kind), n_paths=1, seed=SEED, sampler="hash",
              lower=BAND[0], upper=BAND[1])
    jp, jse, jn = jpricer.price(kind, 100.0, **kw)
    p, se, n = pricer.price(kind, 100.0, **kw)
    assert n == jn == sk.PATHS_PER_BLOCK and p.dtype == torch.float32
    assert float(p) == pytest.approx(float(jp), rel=1e-5)
    assert float(se) == pytest.approx(float(jse), rel=1e-4)


def _same_ladder(ours, ref):
    assert set(ours) == set(ref)
    price = abs(float(ref["price"]))
    for key in ("price", "std_error", "delta", "gamma", "vega_v0", "vega", "rho"):
        rel = 1e-2 if key == "rho" else 1e-4
        floor = price if key == "rho" else 1e-2 * price
        assert abs(float(ours[key]) - float(ref[key])) <= rel * max(abs(float(ref[key])),
                                                                   floor), key
    assert ours["delta_convention"] == ref["delta_convention"]


@pytest.mark.parametrize("kind", ["barrier_up-and-out", "lookback_float", "one_touch_up_hit"])
def test_pricer_greeks_match_reference(jpricer, pricer, kind):
    kw = dict(barrier=_barrier(kind), n_paths=1, seed=SEED, sampler="hash")
    _same_ladder(pricer.greeks(kind, 100.0, **kw), jpricer.greeks(kind, 100.0, **kw))


@pytest.mark.parametrize("name,greeks", [("cliquet", False), ("cliquet", True),
                                         ("autocall", False), ("autocall", True),
                                         ("range_accrual", False), ("range_accrual", True)])
def test_structured_match_reference(jpricer, pricer, name, greeks):
    kw = dict(n_paths=1, seed=SEED, sampler="hash", greeks=greeks)
    if name == "cliquet":
        kw["n_periods"] = 4
    elif name == "autocall":
        kw["n_obs"] = 4
    args = (90.0, 110.0) if name == "range_accrual" else ()
    ref = getattr(jpricer, name)(*args, **kw)
    ours = getattr(pricer, name)(*args, **kw)
    if greeks:
        _same_ladder(ours, ref)
    else:
        assert ours[2] == ref[2]
        assert float(ours[0]) == pytest.approx(float(ref[0]), rel=1e-5)
        assert float(ours[1]) == pytest.approx(float(ref[1]), rel=1e-4)


def test_fit_leverage_polys_matches_reference(jpricer):
    rng = np.random.default_rng(6)
    x_rows = np.sort(rng.normal(0.0, 0.2, (N_STEPS, 31)), axis=1)
    x_rows[0] = 1e-6 * np.linspace(-1, 1, 31)  # the first step's point-like cloud
    l_rows = 1.0 + 0.3 * np.tanh(x_rows) + 0.01 * rng.normal(size=(N_STEPS, 31))
    rows, resid = sk.fit_leverage_polys(torch.tensor(x_rows), torch.tensor(l_rows))
    ref, ref_resid = js.fit_leverage_polys(x_rows, l_rows)
    np.testing.assert_allclose(rows, ref, rtol=1e-9, atol=1e-12)
    assert resid == pytest.approx(ref_resid, rel=1e-9)


def test_calibrating_pricer_runs_on_the_port_surface(tdup, jpricer):
    """The port's own calibration (another generator than the reference's):
    a table of the same shape whose European price agrees statistically."""
    pr = sk.SLVKernelPricer(tdup, PAR, T, mixing=1.0, n_steps=N_STEPS, n_cal_paths=65_536)
    assert pr.rows.shape == (N_STEPS, 9) and pr.device.type == "cpu"
    assert pr.x_rows.shape == (N_STEPS, 31) and pr.fit_residual < 0.1
    p, se, _ = pr.price("european", 100.0, n_paths=1, sampler="hash")
    q, qe, _ = jpricer.price("european", 100.0, n_paths=1, sampler="hash")
    assert abs(float(p) - float(q)) < 5 * math.hypot(float(se), float(qe)) + 0.05
    one = sk.slv_kernel_exotic_price(tdup, PAR, "european", 100.0, T, n_paths=1,
                                     n_steps=N_STEPS, sampler="hash")
    assert len(one) == 4 and math.isfinite(float(one[0]))


def test_touch_complement_and_in_out_are_exact(pricer):
    kw = dict(n_paths=1, seed=SEED, sampler="hash", barrier=120.0)
    one, _, _ = pricer.price("one_touch_up", 0.0, **kw)
    no, _, _ = pricer.price("no_touch_up", 0.0, **kw)
    assert float(one + no) == pytest.approx(math.exp(-R * T), rel=1e-6)
    van, _, _ = pricer.price("european", 100.0, **kw)
    p_in, _, _ = pricer.price("barrier_up-and-in", 100.0, **kw)
    p_out, _, _ = pricer.price("barrier_up-and-out", 100.0, **kw)
    assert float(p_in + p_out) == pytest.approx(float(van), rel=1e-5)


class TestValidation:
    """The ``ValidationError`` cases of ``tests/test_slv_pallas.py``."""

    def test_bad_kind(self, pricer):
        with pytest.raises(ValidationError):
            pricer.price("cliquet", 100.0)

    def test_bad_sampler(self, pricer):
        with pytest.raises(ValidationError):
            pricer.price("european", 100.0, sampler="sobol_bb")

    def test_greeks_reject_mixing_zero(self, jpricer):
        pr = sk.SLVKernelPricer.from_numpy(jpricer.rows, 0.0, PAR, S, R, 0.0, T, mixing=0.0,
                                           device=CPU)
        with pytest.raises(ValidationError):
            pr.greeks("european", 100.0)

    def test_missing_barrier(self, pricer):
        with pytest.raises(ValidationError):
            pricer.price("barrier_up-and-out", 100.0, barrier=0.0)

    def test_double_band(self, pricer):
        with pytest.raises(ValidationError):
            pricer.price("barrier_double-out", 100.0, lower=BAND[1], upper=BAND[0])
        with pytest.raises(ValidationError):
            pricer.price("one_touch_double", 100.0)

    def test_structured_periods_and_band(self, pricer):
        with pytest.raises(ValidationError):
            pricer.cliquet(n_periods=3)  # 8 % 3 != 0
        with pytest.raises(ValidationError):
            pricer.autocall(n_obs=5)
        with pytest.raises(ValidationError):
            pricer.range_accrual(110.0, 90.0)

    def test_kinds_tuple_matches_reference(self):
        assert sk.KINDS == js.KINDS and sk.STRUCTURED_KINDS == js.STRUCTURED_KINDS

    def test_cuda_wrapper_rejects_cpu_tensors(self, pricer):
        with pytest.raises(ValueError):
            sk._slv_cuda(0, 0, pricer._params_vec("european", 100.0, 0.0), kind="european",
                         n_steps=N_STEPS, n_blocks=1, cp=1.0)


def test_flat_surface_mixing_zero_is_black_scholes():
    from optionslab_tpu_torch.models.black_scholes import bs_price

    flat = LocalVolSurface(torch.linspace(-3.0, 3.0, 11), torch.linspace(0.01, 2.0, 9),
                           torch.full((9, 11), 0.2), S, R, device=CPU)
    pr = sk.SLVKernelPricer(flat, HestonParams.make(0.04, 2.0, 0.04, 0.3, -0.7), T, mixing=0.0,
                            n_steps=16, n_cal_paths=8_192)
    p, se, _ = pr.price("european", 100.0, n_paths=4 * sk.PATHS_PER_BLOCK, sampler="hash")
    assert abs(float(p) - bs_price(S, 100.0, T, R, 0.2, 1.0).item()) < 4 * float(se) + 0.02
