"""The GBM kernel module of the port against the JAX package.

On the CPU the port runs the kernel's plain torch version; the JAX kernel
runs in TPU interpret mode. With the `hash` and `sobol` samplers both draw
the same uniforms from the same counters, so per-row moment sums agree up to
float32 transcendental and summation-order error. The CUDA kernel itself is
held to the plain version in ``test_torch_cuda.py``, on a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from optionslab_tpu.ops import gbm_pallas as gp
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch.models.black_scholes import bs_greeks
from optionslab_tpu_torch.ops import gbm_kernel as gk
from optionslab_tpu_torch.types import FIELDS, ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError

# per-row sums: rtol on Σpay, Σpay², Σ1{ex}·S_T; the signed Σ1{ex}·S_T·z
# against the scale Σ1{ex}·S_T (f32 transcendentals and summation order)
MOMENT_RTOL = 1e-5
# combined price/Greeks against pallas_mc_price_greeks
COMBINED_RTOL = 1e-4
# the sobol replication stderr is the spread of 8 group means that agree to
# ~4e-5 of the price, so f32 summation-order noise (~1e-7) in the group sums
# reaches it amplified ~1000x: both packages carry that error
QMC_SE_RTOL = 1e-2
OUT_KEYS = ("price", "std_error", "delta", "gamma", "vega", "rho", "theta", "dual_delta",
            "dividend_rho")


def _jax_book(c: int):
    """A book of c mixed calls and puts (the JAX batch, float32).

    Every contract ends in the money on >= ~14% of paths. A row that almost
    never pays is left out on purpose: there one path that lands within an
    ulp of the strike (where XLA's and torch's float32 exp/log/cos differ)
    dominates the row's sums, and no rtol speaks to that.
    """
    if c == 1:
        return JBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call", dtype=jnp.float32)
    i = np.arange(c)
    return JBatch.make(np.linspace(90.0, 110.0, c), 100.0 + 5.0 * np.sin(i),
                       np.linspace(0.5, 2.0, c), 0.03, np.linspace(0.2, 0.35, c),
                       np.where(i % 2 == 0, 1.0, -1.0), 0.01, dtype=jnp.float32)


def _port(jb) -> ContractBatch:
    return ContractBatch.from_numpy({k: np.asarray(getattr(jb, k)) for k in FIELDS})


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [1, 3, 8, 20, 32, 300, 1000])
def test_geometry_matches_reference(c):
    jb = _jax_book(c)
    _, _, jparams, jc, jreps, jrows, jpad = gp._prepare(jb)
    _, _, params, tc, reps, rows, pad = gk._prepare(_port(jb))
    assert (tc, reps, rows, pad) == (jc, jreps, jrows, jpad)
    assert gk._lanes_for(rows) == gp._lanes_for(jrows)
    for n_paths in (1_000, 1_000_000, 123_456_789):
        ref = gp.pallas_paths_per_launch(jb, n_paths)
        assert gk.gbm_paths_per_launch(_port(jb), n_paths) == ref
        lanes = gk._lanes_for(rows)
        assert gk._n_blocks(n_paths, lanes, reps) * 4 * lanes * reps == ref
    # the kernel inputs are the reference's, bit for bit
    for p, jp in zip(params, jparams):
        assert p.shape == (rows,)
        np.testing.assert_array_equal(_np(p), np.asarray(jp).ravel())


def test_constants_match_reference():
    assert (gk.SUBLANES, gk.TARGET_ROWS, gk._VMEM_ELEMS_PER_BUF) == (
        gp.SUBLANES, gp.TARGET_ROWS, gp._VMEM_ELEMS_PER_BUF)
    for rows in (8, 64, 136, 256, 304, 1024, 4096):
        assert gk._lanes_for(rows) == gp._lanes_for(rows)


@pytest.mark.parametrize("n_blocks,active_rows", [(1, 256), (954, 256), (977, 1024),
                                                  (4, 256), (3, 100_000)])
def test_chunking_covers_every_block(n_blocks, active_rows):
    n_chunks, per_chunk = gk._chunking(n_blocks, active_rows)
    assert n_chunks >= 1 and per_chunk >= 1
    assert (n_chunks - 1) * per_chunk < n_blocks <= n_chunks * per_chunk


# ---------------------------------------------------------------------------
# per-row moment sums: plain version vs the JAX kernel in interpret mode
# ---------------------------------------------------------------------------
CASES = {  # name: (contracts, n_paths, block0)
    "1x1M": (1, 1_000_000, 0),
    "3x2blocks": (3, 500_000, 0),
    "32x2blocks": (32, 65_536, 0),  # reps = 8: replicated-scramble QMC layout
    "300padded": (300, 6_144, 0),  # 300 contracts on 304 rows
    "8xblock0=5": (8, 65_536, 5),
}


def _moments_both(case, sampler, greeks, seed=3):
    c, n_paths, block0 = CASES[case]
    jb = _jax_book(c)
    _, _, jparams, _, reps, rows, _ = gp._prepare(jb)
    lanes = gp._lanes_for(rows)
    n_blocks = gk._n_blocks(n_paths, lanes, reps)
    seed_arr = jnp.asarray([seed, block0], jnp.int32)
    jouts = gp._launch(seed_arr, *jparams, n_blocks=n_blocks, rows=rows, lanes=lanes,
                       interpret=pltpu.InterpretParams(), sampler=sampler, reps=reps,
                       greeks=greeks)
    ref = np.stack([np.asarray(o, np.float64).sum(axis=1) for o in jouts])
    _, _, params, _, _, _, _ = gk._prepare(_port(jb))
    ours = gk._gbm_moments_plain(seed, block0, params, n_blocks=n_blocks, rows=rows,
                                 active_rows=c * reps, lanes=lanes, sampler=sampler, reps=reps,
                                 greeks=greeks)
    return _np(ours).astype(np.float64), ref, c * reps


@pytest.mark.parametrize("greeks", [True, False])
@pytest.mark.parametrize("sampler", ["hash", "sobol"])
@pytest.mark.parametrize("case", list(CASES))
def test_moments_match_jax_kernel(case, sampler, greeks):
    ours, ref, active = _moments_both(case, sampler, greeks)
    assert ours.shape == (4 if greeks else 2, ref.shape[1])
    assert np.all(ours[:, active:] == 0.0)  # padded rows are skipped
    ours, ref = ours[:, :active], ref[:, :active]
    np.testing.assert_array_less(np.abs(ours[:3] - ref[:3]), MOMENT_RTOL * np.abs(ref[:3]) + 1e-30)
    if greeks:
        np.testing.assert_array_less(np.abs(ours[3] - ref[3]), MOMENT_RTOL * ref[2] + 1e-30)


# ---------------------------------------------------------------------------
# combined outputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sampler,c,n_paths", [("hash", 1, 1_000_000), ("sobol", 1, 1_000_000),
                                               ("hash", 20, 100_000), ("sobol", 32, 65_536)])
def test_combined_matches_pallas_mc_price_greeks(sampler, c, n_paths):
    jb = _jax_book(c)
    ref = gp.pallas_mc_price_greeks(jb, n_paths=n_paths, seed=5, sampler=sampler)
    out = gk.gbm_mc_price_greeks(_port(jb), n_paths=n_paths, seed=5, sampler=sampler)
    replication_se = sampler == "sobol" and gk._geometry(c)[0] % 8 == 0
    for k in OUT_KEYS:
        assert out[k].dtype == torch.float32 and tuple(out[k].shape) == tuple(ref[k].shape)
        rtol = QMC_SE_RTOL if (k == "std_error" and replication_se) else COMBINED_RTOL
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]), rtol=rtol, err_msg=k)


def test_price_only_matches_reference_and_greeks_path():
    jb = _jax_book(3)
    jp, jse = gp.pallas_mc_price_only(jb, n_paths=200_000, seed=2, sampler="hash")
    p, se = gk.gbm_mc_price_only(_port(jb), n_paths=200_000, seed=2, sampler="hash")
    np.testing.assert_allclose(_np(p), np.asarray(jp), rtol=COMBINED_RTOL)
    np.testing.assert_allclose(_np(se), np.asarray(jse), rtol=COMBINED_RTOL)
    full = gk.gbm_mc_price_greeks(_port(jb), n_paths=200_000, seed=2, sampler="hash")
    np.testing.assert_array_equal(_np(p), _np(full["price"]))
    np.testing.assert_array_equal(_np(se), _np(full["std_error"]))


def test_price_only_sobol_quotes_replication_stderr():
    b = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call")
    p, se = gk.gbm_mc_price_only(b, n_paths=500_000, seed=0, sampler="sobol")
    assert 0.0 < float(se) < 5e-3
    assert abs(float(p) - 10.450583572185565) < 5e-3


def test_expired_contract_override():
    b = ContractBatch.make([110.0, 90.0], 100.0, [0.0, 1.0], 0.05, 0.2, "call")
    out = gk.gbm_mc_price_greeks(b, n_paths=10_000, seed=0, sampler="hash")
    assert float(out["price"][0]) == pytest.approx(10.0)
    assert float(out["std_error"][0]) == 0.0
    assert float(out["std_error"][1]) > 0.0
    p, se = gk.gbm_mc_price_only(b, n_paths=10_000, seed=0, sampler="hash")
    assert float(p[0]) == pytest.approx(10.0) and float(se[0]) == 0.0
    # the combiner alone, on zero moments, as the reference's test does
    bb, flat, _, c, reps, rows, _ = gk._prepare(b)
    zero = gk._combine(bb, flat, torch.zeros((4, rows)), c, reps, 1000, torch.float32)
    assert float(zero["price"][0]) == pytest.approx(10.0)


def test_put_book_matches_bs():
    spots = torch.tensor([90.0, 100.0, 110.0])
    b = ContractBatch.make(spots, 100.0, 0.5, 0.03, 0.25, "put")
    out = gk.gbm_mc_price_greeks(b, n_paths=500_000, seed=1, sampler="sobol")
    ex = bs_greeks(spots, 100.0, 0.5, 0.03, 0.25, -1.0, 0.0)
    np.testing.assert_allclose(_np(out["price"]), _np(ex["price"]), atol=5e-3)
    np.testing.assert_allclose(_np(out["delta"]), _np(ex["delta"]), atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_prng_within_4_stderr_of_bs(seed):
    spots = torch.tensor([85.0, 100.0, 115.0, 100.0])
    cp = torch.tensor([1.0, 1.0, -1.0, -1.0])
    b = ContractBatch.make(spots, 100.0, 1.0, 0.05, 0.2, cp)
    out = gk.gbm_mc_price_greeks(b, n_paths=400_000, seed=seed)  # default sampler: prng
    ex = bs_greeks(spots, 100.0, 1.0, 0.05, 0.2, cp)
    z = (out["price"] - ex["price"]) / out["std_error"]
    assert torch.all(z.abs() < 4.0), z
    np.testing.assert_allclose(_np(out["delta"]), _np(ex["delta"]), atol=5e-3)


def test_sampler_validation():
    b = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2)
    with pytest.raises(ValidationError):
        gk.gbm_mc_price_greeks(b, n_paths=1000, sampler="halton")


# ---------------------------------------------------------------------------
# autograd: the backward returns the kernel's own Greeks
# ---------------------------------------------------------------------------
def _leaf_batch(spot, strike=100.0):
    def leaf(x):
        return torch.tensor(x, dtype=torch.float32, requires_grad=True)

    return ContractBatch(leaf(spot), leaf(strike), leaf(1.0), leaf(0.05), leaf(0.2),
                         leaf(0.0), torch.tensor(1.0))


@pytest.mark.parametrize("sampler", ["sobol", "prng"])
def test_direct_call_matches_greeks_price(sampler):
    b = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call")
    p = gk.gbm_mc_price(b, 100_000, 0, sampler)
    ref = gk.gbm_mc_price_greeks(b, n_paths=100_000, seed=0, sampler=sampler)
    np.testing.assert_array_equal(_np(p), _np(ref["price"]))


def test_grad_matches_kernel_greeks():
    b = _leaf_batch(100.0)
    price = gk.gbm_mc_price(b, 200_000, 0, "sobol")
    g = torch.autograd.grad(price, [b.spot, b.vol, b.strike, b.rate, b.maturity, b.dividend])
    out = gk.gbm_mc_price_greeks(b, n_paths=200_000, seed=0, sampler="sobol")
    for grad, key, sign in zip(g, ("delta", "vega", "dual_delta", "rho", "theta",
                                   "dividend_rho"), (1, 1, 1, 1, -1, 1)):
        np.testing.assert_allclose(_np(grad), sign * _np(out[key]), rtol=1e-6, err_msg=key)


def test_grad_sums_over_broadcast_fields():
    """Scalar strike shared across a 3-contract book: d(sum price)/dK is the
    SUM of per-contract dual-deltas, with scalar shape."""
    b = _leaf_batch([90.0, 100.0, 110.0])
    assert b.strike.shape == ()
    price = gk.gbm_mc_price(b, 100_000, 0, "sobol")
    g_spot, g_strike = torch.autograd.grad(price.sum(), [b.spot, b.strike])
    out = gk.gbm_mc_price_greeks(b, n_paths=100_000, seed=0, sampler="sobol")
    assert g_strike.shape == () and g_spot.shape == (3,)
    np.testing.assert_allclose(g_strike.item(), float(out["dual_delta"].sum()), rtol=1e-5)
    np.testing.assert_allclose(_np(g_spot), _np(out["delta"]), rtol=1e-5)


def test_grad_matches_jax_custom_vjp():
    jb = _jax_book(1)
    jg = jax.grad(lambda bb: gp.pallas_mc_price(bb, 200_000, 0, "sobol"))(jb)
    b = _leaf_batch(100.0)
    tg = torch.autograd.grad(gk.gbm_mc_price(b, 200_000, 0, "sobol"),
                             [b.spot, b.strike, b.maturity, b.rate, b.vol, b.dividend])
    for grad, k in zip(tg, ("spot", "strike", "maturity", "rate", "vol", "dividend")):
        np.testing.assert_allclose(float(grad), float(getattr(jg, k)), rtol=COMBINED_RTOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(gk, "_gbm_moments_plain",
                        lambda *a, **kw: calls.append(1) or torch.zeros((4, 256)))
    b = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2)
    gk.gbm_mc_price_greeks(b, n_paths=1000, sampler="hash")
    assert calls == [1]


def test_kernel_wrapper_refuses_cpu_tensors():
    _, _, params, c, reps, rows, _ = gk._prepare(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2))
    before = gk._gbm_moments_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        gk._gbm_moments_cuda(0, 0, params, n_blocks=1, rows=rows, active_rows=c * reps,
                             lanes=gk._lanes_for(rows), sampler="hash", reps=reps, greeks=True)
    assert gk._gbm_moments_cuda.launches == before
