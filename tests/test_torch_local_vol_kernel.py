"""The local-vol kernel's plain version against the JAX package's
``_lv_kernel``, the pricer against ``LocalVolKernelPricer``, and the
``ValidationError`` cases of ``tests/test_local_vol_pallas.py``.

On the CPU the port runs the plain torch version of ``csrc/local_vol_mc.cu``;
the JAX kernel runs in TPU interpret mode with ``sampler="hash"`` (and the
``sobol_bb`` bridge on hash residuals) at one path block and 8 steps, on the
JAX pricer's own σ-polynomial table cast once to float32, so both draw the
same uniforms from the same counters through the same table. The CUDA kernel
itself is held to the plain version in ``test_torch_cuda.py`` and by
``chip_smoke.py``, on a card.

Tolerances: pay, pay² and the pay-at-hit cash per row to rtol 1e-5; the
signed moments (Σpay·z₁, Σpay·(z₁²−1), Σpay·vscore, the lookback boundary
moments) to 1e-5 of the moment's largest row. XLA's and torch's float32
``log/exp/sin/cos`` differ by an ulp on some inputs and the sums run in
another order (measured ≤ 5e-7); no row here is decided by a path that sits
on a barrier within an ulp. The σ fits of the two packages' surfaces (which
agree to 1.2e-7) are compared by their polynomials' values on each step's
band, not by their coefficients.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.models.local_vol import DupireLocalVol as JDupire
from optionslab_tpu.models.local_vol import sample_smile_iv_fn as j_smile
from optionslab_tpu.ops import local_vol_pallas as jl
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.models.local_vol import DupireLocalVol, LocalVolSurface
from optionslab_tpu_torch.models.local_vol import sample_smile_iv_fn
from optionslab_tpu_torch.ops import local_vol_kernel as lk
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, R, T = 100.0, 0.05, 1.0
N_STEPS = 8
SEED = 3
RTOL = 1e-5
CPU = "cpu"
BAND = (85.0, 118.0)


@pytest.fixture(scope="module")
def jdup():
    return JDupire(j_smile(), S, R)


@pytest.fixture(scope="module")
def tdup():
    return DupireLocalVol(sample_smile_iv_fn(), S, R, device=CPU)


@pytest.fixture(scope="module")
def jpricer(jdup):
    return jl.LocalVolKernelPricer(jdup, T, n_steps=N_STEPS)


@pytest.fixture(scope="module")
def pricer(jpricer):
    """The port's pricer on the JAX pricer's fitted table."""
    return lk.LocalVolKernelPricer.from_numpy(jpricer.rows, jpricer.fit_residual, S, R, 0.0, T,
                                              device=CPU)


def _flat(vol=0.2):
    surf = LocalVolSurface(torch.linspace(-3.0, 3.0, 11), torch.linspace(0.01, 2.0, 9),
                           torch.full((9, 11), vol), S, R, device=CPU)
    return type("Flat", (), {"surface": surf, "spot": S, "rate": R, "dividend": 0.0})()


def _barrier(payoff):
    return 120.0 if "up" in payoff else 85.0


def _vectors(jpricer, pricer, payoff):
    """(JAX float32 vector, port vector): equal bit for bit."""
    jp = np.asarray(jpricer._params(100.0, payoff, _barrier(payoff), *BAND), np.float32)
    tp = pricer._params(100.0, payoff, _barrier(payoff), *BAND)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), jp.view(np.uint32))
    return jp, tp


def assert_rows_close(ours, ref):
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    diff = np.abs(ours - ref)
    for m in range(len(ref)):
        scale = np.abs(ref[m]) if m < 2 else np.abs(ref[m]).max()
        assert np.all(diff[m] <= RTOL * scale + 1e-12), (m, diff[m].max(), scale)


CASES = ([(p, False, "hash", 1.0) for p in lk.PAYOFFS]
         + [(p, True, "hash", 1.0) for p in lk.PAYOFFS]
         # the bridge reparameterises the normals whatever the payoff: one
         # payoff per statistic family it feeds (8 s each in interpret mode)
         + [(p, False, "sobol_bb", 1.0) for p in ("asian", "barrier_up-and-out",
                                                  "one_touch_up_hit")]
         + [(p, True, "hash", -1.0) for p in ("european", "asian", "lookback_float",
                                               "lookback_fixed", "barrier_down-and-in")])


@pytest.fixture(scope="module")
def reference_sums(jpricer):
    """Per-row sums of the JAX kernel, one interpret run per (payoff, sampler,
    cp): with greeks wherever the sampler allows them, since Σpay and Σpay²
    come first and from the same paths with greeks on or off."""
    cache = {}

    def get(payoff, sampler, cp):
        key = (payoff, sampler, cp)
        if key not in cache:
            jp = np.asarray(jpricer._params(100.0, payoff, _barrier(payoff), *BAND), np.float32)
            outs = jl._launch(jnp.asarray([SEED, 0], jnp.int32), jnp.asarray(jp),
                              n_steps=N_STEPS, n_blocks=1, cp=cp, payoff=payoff,
                              sampler=sampler, greeks=sampler == "hash")
            cache[key] = np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs])
        return cache[key]

    return get


@pytest.mark.parametrize("payoff,greeks,sampler,cp", CASES)
def test_plain_matches_reference_kernel(jpricer, pricer, reference_sums, payoff, greeks, sampler,
                                        cp):
    _, tp = _vectors(jpricer, pricer, payoff)
    n_mom = lk._n_moments(payoff, greeks)
    ref = reference_sums(payoff, sampler, cp)[:n_mom]
    ours = lk._lv_plain(SEED, 0, tp, n_steps=N_STEPS, n_blocks=1, cp=cp, payoff=payoff,
                        sampler=sampler, greeks=greeks)
    assert ours.dtype == torch.float32 and ours.shape == (n_mom, lk.ROWS)
    assert_rows_close(ours.double().numpy(), ref)


def test_sobol_bb_hash_is_sobol_bb(pricer):
    tp = pricer._params(100.0, "asian", 0.0)
    kw = dict(n_steps=N_STEPS, n_blocks=1, cp=1.0, payoff="asian")
    assert torch.equal(lk._lv_plain(SEED, 0, tp, sampler="sobol_bb", **kw),
                       lk._lv_plain(SEED, 0, tp, sampler="sobol_bb_hash", **kw))


def test_plain_block_offset_and_chunking(pricer):
    """Two blocks from block0 = 5 are the sums of the blocks one at a time."""
    tp = pricer._params(100.0, "barrier_up-and-out", 120.0)
    kw = dict(n_steps=N_STEPS, cp=1.0, payoff="barrier_up-and-out", sampler="prng")
    both = lk._lv_plain(SEED, 5, tp, n_blocks=2, **kw).double()
    one = lk._lv_plain(SEED, 5, tp, n_blocks=1, **kw).double() \
        + lk._lv_plain(SEED, 6, tp, n_blocks=1, **kw).double()
    np.testing.assert_allclose(both.numpy(), one.numpy(), rtol=1e-6)


@pytest.mark.parametrize("payoff", ["european", "lookback_float", "lookback_fixed",
                                    "one_touch_up_hit"])
def test_combine_greeks_matches_reference(jpricer, pricer, payoff):
    rng = np.random.default_rng(4)
    tiles = [rng.normal(1.0, 0.5, (lk.ROWS, 128)).astype(np.float32)
             for _ in range(lk._n_moments(payoff, True))]
    n = 4 * lk.PATHS_PER_BLOCK
    ref = jpricer._combine_greeks([jnp.asarray(t) for t in tiles], n, payoff)
    ours = pricer._combine_greeks(torch.tensor(np.stack([t.sum(axis=1) for t in tiles])), n,
                                  payoff)
    assert set(ours) == set(ref)
    for key in ("price", "std_error", "delta", "gamma", "vega"):
        assert float(ours[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    assert ours["paths"] == ref["paths"] and ours["fit_residual"] == ref["fit_residual"]


@pytest.mark.parametrize("payoff,sampler", [("european", "hash"), ("barrier_up-and-out", "hash"),
                                            ("one_touch_double_hit", "hash"),
                                            ("range_accrual", "hash"),
                                            ("asian", "sobol_bb")])
def test_pricer_price_matches_reference(jpricer, pricer, payoff, sampler):
    kw = dict(cp=1.0, payoff=payoff, barrier=_barrier(payoff), n_paths=1, seed=SEED,
              sampler=sampler, lower=BAND[0], upper=BAND[1])
    jp, jse, jn = jpricer.price(100.0, **kw)
    p, se, n = pricer.price(100.0, **kw)
    assert n == jn == lk.PATHS_PER_BLOCK and p.dtype == torch.float32
    assert float(p) == pytest.approx(float(jp), rel=1e-5)
    assert float(se) == pytest.approx(float(jse), rel=1e-4)


@pytest.mark.parametrize("payoff,cp", [("european", 1.0), ("lookback_float", -1.0),
                                       ("barrier_double-out", 1.0), ("no_touch_down", 1.0)])
def test_pricer_greeks_match_reference(jpricer, pricer, payoff, cp):
    kw = dict(cp=cp, payoff=payoff, barrier=_barrier(payoff), n_paths=1, seed=SEED,
              sampler="hash", lower=BAND[0], upper=BAND[1])
    ref = jpricer.greeks(100.0, **kw)
    ours = pricer.greeks(100.0, **kw)
    assert set(ours) == set(ref)
    for key in ("price", "std_error", "delta", "gamma", "vega"):
        scale = max(abs(float(ref[key])), 1e-2 * abs(float(ref["price"])))
        assert abs(float(ours[key]) - float(ref[key])) <= 1e-4 * scale, key


def test_fit_sigma_polys_matches_reference(jpricer, tdup):
    rows, resid = lk.fit_sigma_polys(tdup.surface, S, R, 0.0, T, N_STEPS)
    ref = jpricer.rows
    np.testing.assert_allclose(rows[:, :2], ref[:, :2], rtol=1e-6, atol=1e-7)
    for i in range(N_STEPS):
        x = np.linspace(ref[i, 0], ref[i, 1], 21)
        np.testing.assert_allclose(np.polyval(rows[i, 2:], x), np.polyval(ref[i, 2:], x),
                                   rtol=1e-5)
    assert resid == pytest.approx(jpricer.fit_residual, rel=1e-3)
    ours = lk.LocalVolKernelPricer(tdup, T, n_steps=N_STEPS)
    assert ours.device.type == "cpu" and ours.rows.shape == (N_STEPS, 9)


def test_one_shot_matches_reference(jdup, tdup):
    ref = jl.pallas_local_vol_price(jdup, 100.0, T, n_paths=1, n_steps=N_STEPS, seed=SEED,
                                    sampler="hash")
    ours = lk.local_vol_kernel_price(tdup, 100.0, T, n_paths=1, n_steps=N_STEPS, seed=SEED,
                                     sampler="hash")
    assert ours[2] == ref[2]
    assert float(ours[0]) == pytest.approx(float(ref[0]), rel=1e-4)
    assert ours[3] == pytest.approx(ref[3], rel=1e-3)


def test_flat_surface_european_matches_black_scholes():
    pr = lk.LocalVolKernelPricer(_flat(), T, n_steps=16)
    for cp, k in ((1.0, 100.0), (-1.0, 90.0)):
        p, se, _ = pr.price(k, cp=cp, n_paths=4 * lk.PATHS_PER_BLOCK, sampler="hash")
        assert abs(float(p) - bs_price(S, k, T, R, 0.2, cp).item()) < 4 * float(se) + 2e-3
    assert pr.fit_residual < 1e-5


def test_in_out_and_touch_parity_are_exact_per_path(pricer):
    kw = dict(n_paths=1, seed=SEED, sampler="hash", barrier=120.0)
    van, _, _ = pricer.price(100.0, **kw)
    p_in, _, _ = pricer.price(100.0, payoff="barrier_up-and-in", **kw)
    p_out, _, _ = pricer.price(100.0, payoff="barrier_up-and-out", **kw)
    assert float(p_in + p_out) == pytest.approx(float(van), rel=1e-5)
    one, _, _ = pricer.price(0.0, payoff="one_touch_up", **kw)
    no, _, _ = pricer.price(0.0, payoff="no_touch_up", **kw)
    assert float(one + no) == pytest.approx(math.exp(-R * T), rel=1e-6)


def test_greeks_are_finite_for_every_payoff(pricer):
    for payoff in lk.PAYOFFS:
        g = pricer.greeks(100.0, payoff=payoff, barrier=_barrier(payoff), lower=BAND[0],
                          upper=BAND[1], n_paths=1, sampler="prng")
        assert all(math.isfinite(float(g[k])) for k in ("price", "delta", "gamma", "vega")), \
            payoff


class TestValidation:
    """The ``ValidationError`` cases of ``tests/test_local_vol_pallas.py``."""

    def test_bad_payoff(self):
        with pytest.raises(ValidationError):
            lk.local_vol_kernel_price(_flat(), 100.0, T, payoff="lookback", device=CPU)

    def test_bad_barrier_level(self):
        pr = lk.LocalVolKernelPricer(_flat(), T, n_steps=4)
        with pytest.raises(ValidationError):
            pr.price(100.0, payoff="barrier_up-and-out", barrier=0.0)

    def test_qmc_rejects_greeks_and_single_step(self):
        pr = lk.LocalVolKernelPricer(_flat(), T, n_steps=8)
        with pytest.raises(ValidationError):
            pr.greeks(100.0, n_paths=1, sampler="sobol_bb")
        pr1 = lk.LocalVolKernelPricer(_flat(), T, n_steps=1)
        with pytest.raises(ValidationError):
            pr1.price(100.0, n_paths=1, sampler="sobol_bb")

    def test_double_and_touch_levels(self):
        pr = lk.LocalVolKernelPricer(_flat(), T, n_steps=4)
        with pytest.raises(ValidationError):
            pr.price(100.0, 1.0, "barrier_double-out", lower=BAND[1], upper=BAND[0])
        with pytest.raises(ValidationError):
            pr.price(100.0, 1.0, "one_touch_up", barrier=0.0)

    def test_band_validation(self):
        pr = lk.LocalVolKernelPricer(_flat(), T, n_steps=8)
        with pytest.raises(ValidationError):
            pr.price(0.0, payoff="range_accrual", lower=110.0, upper=90.0)

    def test_unknown_sampler(self):
        pr = lk.LocalVolKernelPricer(_flat(), T, n_steps=4)
        with pytest.raises(ValidationError):
            pr.price(100.0, n_paths=1, sampler="halton")

    def test_cuda_wrapper_rejects_cpu_tensors(self, pricer):
        with pytest.raises(ValueError):
            lk._lv_cuda(0, 0, pricer._params(100.0, "european", 0.0), n_steps=N_STEPS,
                        n_blocks=1, cp=1.0, payoff="european")
