"""The Heston kernels' plain versions against the JAX package's kernels, the
wrappers against their JAX namesakes, and the statistical and oracle checks
of ``tests/test_heston_pallas.py`` on the port.

On the CPU the port runs the plain torch versions of ``csrc/heston_mc.cu``,
``csrc/heston_qe.cu`` and ``csrc/heston_chain.cu``; the JAX kernels run in
TPU interpret mode with ``sampler="hash"`` (the JAX ``prng`` has no CPU
mode) at one path block and 8 steps. Both draw the same uniforms from the
same counters. The CUDA kernels themselves are held to the plain versions in
``test_torch_cuda.py`` and by ``chip_smoke.py``, on a card.

Tolerances, per moment, with their reasons:

* pay, pay², Σ1{ex}·S_T (and the QE ladder's bumped Σpay): rtol 1e-5 per
  row. XLA's and torch's float32 ``log/exp/sin/cos`` differ by an ulp on some
  inputs and the sums run in another order; measured ≤ 2.4e-7.
* The pathwise sensitivity moments Σ1{ex}·S·∂x/∂p (Euler vega and ladder,
  chain): per row within rtol 1e-5 of the moment's largest row plus 1e-2 of
  the row's largest lane term. The recursion multiplies each step's ∂v by
  1/(2√v⁺), up to 5e5 near v = 0, so an ulp of libm difference in a path
  that grazes zero variance moves that lane's term by up to ~1e-3 of itself
  (measured: ~20 of 32768 lanes, ≤ 1.5e-3); a row holds at most a few such
  lanes.
* The chain kernel's output is the reference's ``_fold8`` tile: rows are
  compared in the 8 groups ``row % 8`` summed over the lanes.
* Wrappers: the combined moments to rtol 1e-5 (float32 rounding of sums),
  sensitivities to 1e-2 of their scale for the reason above, QE finite
  differences to 0.1 absolute (an f32 moment difference over a bump of 1e-3
  of the parameter).
"""

import math

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from optionslab_tpu.models.heston import HestonParams as JHestonParams
from optionslab_tpu.models.heston import heston_price as j_heston_price
from optionslab_tpu.ops import heston_pallas as hp
from optionslab_tpu.ops import kernel_rng as jrng
from optionslab_tpu.types import ContractBatch as JContractBatch
from optionslab_tpu_torch.models.heston import HestonParams, HestonPricer, heston_price
from optionslab_tpu_torch.ops import heston_kernel as hk
from optionslab_tpu_torch.ops import kernel_rng as trng
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


S, K, T, R, Q = 100.0, 100.0, 1.0, 0.05, 0.01
N_STEPS = 8
SEED = 3
RTOL = 1e-5
LANE_TOL = 1e-2
PAR_ARGS = (0.04, 2.0, 0.04, 0.3, -0.7)
JPAR = JHestonParams.make(*PAR_ARGS)
PAR = HestonParams.make(*PAR_ARGS, device="cpu")
CPU = "cpu"


def _rows(outs) -> np.ndarray:
    return np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs])


def _lane_max(terms) -> np.ndarray:
    """(n_mom, ROWS): each row's largest |lane term| (one lane = one pair)."""
    return np.stack([t.double().abs().amax(dim=(0, 2)).numpy() for t in terms])


def assert_rows_close(ours, ref, n_plain=3, lane_max=None):
    """Moments below ``n_plain`` to RTOL per row; the sensitivity moments
    (from ``n_plain`` on) to RTOL of their largest row plus LANE_TOL of the
    row's largest lane term (module docstring)."""
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    diff = np.abs(ours - ref)
    scale = np.abs(ref)
    assert np.all(diff[:n_plain] <= RTOL * scale[:n_plain]), (diff / scale).max(axis=-1)
    if ours.shape[0] > n_plain:
        big = np.abs(ref[n_plain:]).max(axis=-1, keepdims=True)
        bound = RTOL * big + LANE_TOL * lane_max[n_plain:]
        assert np.all(diff[n_plain:] <= bound), (diff[n_plain:] / big).max(axis=-1)


def _seed():
    return jnp.asarray([SEED, 0], jnp.int32)


def _block():
    return hk._block_ids(0, 0, 1, CPU)


# ---------------------------------------------------------------------------
# the sampler of the QE kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block,step,n_steps", [(0, 0, 8), (3, 5, 8), (7, 251, 252),
                                                (40000, 3, 64)])
def test_draw_uniform_hash_bitwise(block, step, n_steps):
    ours = trng.draw_uniform("hash", SEED, torch.tensor([[[block]]], dtype=torch.int32), step,
                             n_steps, 128, 512)[0].numpy()
    ref = np.asarray(jrng.draw_uniform("hash", jnp.int32(SEED), jnp.int32(block),
                                       jnp.int32(step), n_steps, (128, 512)))
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_draw_uniform_philox_stream_1():
    block = torch.tensor([[[5]]], dtype=torch.int32)
    u = trng.draw_uniform("prng", 11, block, 2, 8, 128, 512)
    row = torch.arange(128, dtype=torch.int32).reshape(1, -1, 1)
    col = torch.arange(512, dtype=torch.int32).reshape(1, 1, -1)
    u_stream0, _ = trng.philox_uniform_pair(row, col, 11, block, 2)
    assert u.shape == (1, 128, 512) and u.dtype == torch.float32
    assert not torch.equal(u, u_stream0)
    assert torch.equal(u, trng.philox_uniform(row, col, 11, block, 2))
    assert stats.kstest(u.flatten().double().numpy(), "uniform").pvalue > 1e-3
    assert abs(np.corrcoef(u.flatten().numpy(), u_stream0.flatten().numpy())[0, 1]) < 0.01
    with pytest.raises(ValueError, match="sampler"):
        trng.draw_uniform("sobol", 0, block, 0, 8, 128, 512)


# ---------------------------------------------------------------------------
# the kernels row for row against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("mode", hk.MODES)
def test_euler_rows_match_reference(mode, cp):
    strike = 105.0 if cp > 0 else 95.0
    _, p = hp._params_vec(S, strike, T, R, JPAR, Q, N_STEPS)
    ref = _rows(hp._launch(_seed(), jnp.asarray(p, jnp.float32), n_steps=N_STEPS, n_blocks=1,
                           cp=cp, sampler="hash", vega=mode == "vega",
                           ladder=mode == "ladder"))
    _, tp = hk._params_vec(S, strike, T, R, PAR, Q, N_STEPS)
    np.testing.assert_array_equal(tp, p)
    params = torch.tensor(tp)
    ours = hk._heston_mc_plain(SEED, 0, params, n_steps=N_STEPS, n_blocks=1, cp=cp,
                               sampler="hash", mode=mode)
    assert ours.dtype == torch.float32 and ours.shape == (hk._N_MOM[mode], hk.ROWS)
    terms = hk._euler_block_plain(SEED, _block(), params, n_steps=N_STEPS, cp=cp,
                                  sampler="hash", mode=mode)
    assert_rows_close(ours.double().numpy(), ref, lane_max=_lane_max(terms))


def test_bridge_qmc_rows_match_reference():
    _, p = hp._params_vec(S, K, T, R, JPAR, Q, N_STEPS)
    ref = _rows(hp._launch(_seed(), jnp.asarray(p, jnp.float32), n_steps=N_STEPS, n_blocks=1,
                           cp=1.0, sampler="sobol_bb"))
    ours = hk._heston_mc_plain(SEED, 0, torch.tensor(p), n_steps=N_STEPS, n_blocks=1, cp=1.0,
                               sampler="sobol_bb", mode="price")
    assert_rows_close(ours.double().numpy(), ref)


@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_qe_rows_match_reference(cp):
    _, p = hp._params_vec_qe(S, K, T, R, JPAR, Q, N_STEPS)
    ref = _rows(hp._launch(_seed(), jnp.asarray(p, jnp.float32), n_steps=N_STEPS, n_blocks=1,
                           cp=cp, sampler="hash", scheme="qe"))
    _, tp = hk._params_vec_qe(S, K, T, R, PAR, Q, N_STEPS)
    np.testing.assert_array_equal(tp, p[:13])  # the reference pads to 14
    ours = hk._heston_qe_plain(SEED, 0, torch.tensor(tp), n_steps=N_STEPS, n_blocks=1, cp=cp,
                               sampler="hash")
    assert ours.shape == (3, hk.ROWS)
    assert_rows_close(ours.double().numpy(), ref)


@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_qe_ladder_rows_match_reference(cp):
    _, p, hs = hp._params_vec_qe_ladder(S, K, T, R, JPAR, Q, N_STEPS)
    ref = _rows(hp._launch(_seed(), jnp.asarray(p, jnp.float32), n_steps=N_STEPS, n_blocks=1,
                           cp=cp, sampler="hash", scheme="qe", ladder=True))
    _, tp, ths = hk._params_vec_qe_ladder(S, K, T, R, PAR, Q, N_STEPS)
    np.testing.assert_array_equal(tp, p)
    np.testing.assert_allclose(ths, hs, rtol=1e-7)  # the reference keeps them in float32
    ours = hk._heston_qe_ladder_plain(SEED, 0, torch.tensor(tp), n_steps=N_STEPS, n_blocks=1,
                                      cp=cp, sampler="hash")
    assert ours.shape == (9, hk.ROWS)
    assert_rows_close(ours.double().numpy(), ref, n_plain=9)


# a 5-quote chain: mixed signs, two expiries shared by several quotes
CHAIN = ([90.0, 100.0, 110.0, 95.0, 105.0], [0.5, 0.5, 0.5, 1.0, 1.0],
         [-1.0, 1.0, 1.0, -1.0, 1.0])
PVEC = np.asarray(PAR_ARGS, np.float32)


def _jax_chain_tiles(max_dt=0.125, pvec=PVEC, seed=SEED):
    strikes, mats, cps = CHAIN
    dts, steps = hp._chain_grid(mats, max_dt)
    outs = hp._chain_launch_from_pvec(jnp.asarray(pvec), jnp.asarray(dts, jnp.float32), S, R, Q,
                                      n_blocks=1, quote_steps=steps, cps=tuple(cps),
                                      sampler="hash", seed=seed,
                                      strikes=jnp.asarray(strikes, jnp.float32))
    return np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs]).reshape(-1, 7, 8)


def test_chain_rows_match_reference():
    strikes, mats, cps = CHAIN
    plan = hk.chain_plan(strikes, mats, cps, 0.125, CPU)
    dts, steps = hp._chain_grid(mats, 0.125)
    assert plan.quote_steps == steps and plan.n_steps == len(dts) == 8
    assert plan.exp_ptr.tolist() == [0, 0, 0, 0, 3, 3, 3, 3, 5]
    head = hk._chain_head(torch.tensor(PVEC), S, R, Q)
    ours = hk._heston_chain_plain(SEED, 0, head, plan, n_blocks=1, sampler="hash")
    assert ours.shape == (5, 7, hk.ROWS)
    ref = _jax_chain_tiles()
    groups = ours.double().numpy().reshape(5, 7, hk.ROWS // 8, 8).sum(axis=2)
    terms = hk._chain_block_plain(SEED, _block(), head, plan, sampler="hash")
    lanes = _lane_max(terms).reshape(5, 7, hk.ROWS // 8, 8).max(axis=2)
    for q in range(5):
        assert_rows_close(groups[q], ref[q], n_plain=2, lane_max=lanes[q])


# ---------------------------------------------------------------------------
# the wrappers against their JAX namesakes
# ---------------------------------------------------------------------------
def _close(ours, ref, key, scale=None, rtol=RTOL):
    o, r = float(ours[key]), float(ref[key])
    s = abs(r) if scale is None else scale
    assert abs(o - r) <= rtol * s + 1e-7, (key, o, r)


@pytest.mark.parametrize("kw", [dict(), dict(cp=-1.0), dict(vega=False), dict(ladder=True),
                                dict(ladder=True, cp=-1.0)])
def test_greeks_wrapper_matches_reference(kw):
    args = (S, 102.0, T, R)
    ref = hp.pallas_heston_greeks(*args, JPAR, dividend=Q, n_paths=1, n_steps=N_STEPS,
                                  seed=SEED, sampler="hash", **kw)
    ours = hk.heston_kernel_greeks(*args, PAR, dividend=Q, n_paths=1, n_steps=N_STEPS,
                                   seed=SEED, sampler="hash", device=CPU, **kw)
    assert set(ours) == set(ref) and ours["paths"] == ref["paths"]
    assert ours["price"].dtype == torch.float32
    for key in ("price", "std_error", "delta", "rho"):
        _close(ours, ref, key)
    # sensitivities: against the price scale (the sums cancel)
    for key in set(ours) - {"price", "std_error", "delta", "rho", "paths"}:
        _close(ours, ref, key, scale=max(abs(float(ref[key])), float(ref["price"])),
               rtol=LANE_TOL)


def test_qe_ladder_wrapper_matches_reference():
    ref = hp.pallas_heston_greeks(S, K, T, R, JPAR, n_paths=1, n_steps=N_STEPS, seed=SEED,
                                  sampler="hash", scheme="qe", ladder=True)
    ours = hk.heston_kernel_greeks(S, K, T, R, PAR, n_paths=1, n_steps=N_STEPS, seed=SEED,
                                   sampler="hash", scheme="qe", ladder=True, device=CPU)
    assert set(ours) == set(ref) and ours["paths"] == ref["paths"]
    for key in ("price", "std_error", "delta", "rho"):
        _close(ours, ref, key)
    for key in ("vega_v0", "vega", "d_kappa", "d_theta", "d_sigma", "d_rho", "theta"):
        assert abs(float(ours[key]) - float(ref[key])) < 0.1, key


@pytest.mark.parametrize("kw", [dict(), dict(scheme="qe"), dict(sampler="sobol_bb"),
                                dict(scheme="qe", cp=-1.0)])
def test_price_wrapper_matches_reference(kw):
    kw = {"sampler": "hash", **kw}
    p, se, n = hp.pallas_heston_price(S, K, T, R, JPAR, n_paths=1, n_steps=N_STEPS, seed=SEED,
                                      **kw)
    tp, tse, tn = hk.heston_kernel_price(S, K, T, R, PAR, n_paths=1, n_steps=N_STEPS,
                                         seed=SEED, device=CPU, **kw)
    assert tn == n
    assert abs(float(tp) - float(p)) <= RTOL * float(p)
    assert abs(float(tse) - float(se)) <= 1e-3 * float(se)


def test_chain_ladder_and_pricer_match_reference():
    strikes, mats, cps = CHAIN
    kw = dict(n_paths=1, max_dt=0.125, seed=SEED, sampler="hash")
    jp, jse, jg = hp.pallas_heston_chain_ladder(strikes, mats, cps, S, R, JPAR, dividend=Q, **kw)
    tp, tse, tg = hk.heston_chain_ladder(strikes, mats, cps, S, R, PAR, dividend=Q, device=CPU,
                                         **kw)
    assert tp.shape == (5,) and tg.shape == (5, 5) and tg.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL)
    np.testing.assert_allclose(tse.numpy(), np.asarray(jse), rtol=1e-3)
    jg = np.asarray(jg)
    scale = np.maximum(np.abs(jg), np.abs(jg).max(axis=1, keepdims=True))
    assert np.all(np.abs(tg.numpy() - jg) <= LANE_TOL * scale)

    pricer = hk.make_chain_pricer(strikes, mats, cps, S, R, Q, device=CPU, **kw)
    jpricer = hp.make_chain_pricer(strikes, mats, cps, S, R, Q, **kw)
    pvec = torch.tensor(PVEC, requires_grad=True)
    prices = pricer(pvec)
    np.testing.assert_allclose(prices.detach().numpy(), np.asarray(jpricer(jnp.asarray(PVEC))),
                               rtol=RTOL)
    ct = torch.tensor([1.0, -2.0, 0.5, 3.0, 1.0])
    (g,) = torch.autograd.grad(prices, pvec, ct)
    jgrad = np.asarray(jax.grad(lambda v: jnp.vdot(jpricer(v), jnp.asarray(ct.numpy())))(
        jnp.asarray(PVEC)))
    assert np.all(np.abs(g.numpy() - jgrad) <= LANE_TOL * np.abs(jgrad).max())


def test_pricer_grad_is_the_kernel_moments():
    """grad of pricer(pvec).sum() is Σ_q of the kernel's gradient moments, and
    the backward launches nothing."""
    strikes, mats, cps = CHAIN
    kw = dict(n_paths=1, max_dt=0.125, seed=SEED, sampler="hash", device=CPU)
    _, _, grads = hk.heston_chain_ladder(strikes, mats, cps, S, R, PAR, dividend=Q, **kw)
    pricer = hk.make_chain_pricer(strikes, mats, cps, S, R, Q, **kw)
    pvec = torch.tensor(PVEC, requires_grad=True)
    calls = []
    plain = hk._heston_chain_plain
    try:
        hk._heston_chain_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
        total = pricer(pvec).sum()
        (g,) = torch.autograd.grad(total, pvec)
    finally:
        hk._heston_chain_plain = plain
    assert len(calls) == 1
    torch.testing.assert_close(g, grads.sum(dim=0))


VALIDATION = [  # the reference's ValidationError cases (heston_pallas.py:768-779, :1020-1024)
    (hk.heston_kernel_price, dict(sampler="sobol_bb", scheme="qe"), "Euler scheme only"),
    (hk.heston_kernel_greeks, dict(sampler="sobol_bb", ladder=True), "price/delta/rho only"),
    (hk.heston_kernel_greeks, dict(sampler="sobol_bb"), "price/delta/rho only"),
    (hk.heston_kernel_price, dict(sampler="sobol_bb", n_steps=1), "n_steps >= 2"),
    (hk.heston_kernel_greeks, dict(scheme="qe", ladder=False), "require ladder=True"),
]


@pytest.mark.parametrize("fn,kw,match", VALIDATION)
def test_validation_matches_reference(fn, kw, match):
    kw = {"n_steps": N_STEPS, **kw}
    jfn = {hk.heston_kernel_price: hp.pallas_heston_price,
           hk.heston_kernel_greeks: hp.pallas_heston_greeks}[fn]
    from optionslab_tpu.utils.exceptions import ValidationError as JValidationError

    with pytest.raises(JValidationError):
        jfn(S, K, T, R, JPAR, n_paths=1, **kw)
    with pytest.raises(ValidationError, match=match):
        fn(S, K, T, R, PAR, n_paths=1, device=CPU, **kw)


def test_port_only_validation():
    with pytest.raises(ValidationError, match="sampler"):
        hk.heston_kernel_price(S, K, T, R, PAR, n_paths=1, sampler="sobol", device=CPU)
    with pytest.raises(ValidationError, match="euler|qe"):
        hk.heston_kernel_price(S, K, T, R, PAR, n_paths=1, scheme="milstein", device=CPU)
    with pytest.raises(ValidationError, match="prng/hash"):
        hk.heston_chain_ladder([100.0], [1.0], [1.0], S, R, PAR, sampler="sobol_bb", device=CPU)
    with pytest.raises(ValidationError, match="equal"):
        hk.chain_plan([100.0, 90.0], [1.0], [1.0], 0.1, CPU)


def test_geometry_and_dispatch():
    assert (hk.ROWS, hk.LANES, hk.LADDER_LANES) == (hp.ROWS, hp.LANES, hp.LADDER_LANES)
    assert hk.PATHS_PER_BLOCK == hp.PATHS_PER_BLOCK
    assert hk.LADDER_PATHS_PER_BLOCK == hp.LADDER_PATHS_PER_BLOCK
    for mats, max_dt in (([0.25, 1.0, 0.25, 2.0], 0.02), ([0.0, 0.5], 0.1), ([1.0], 1.0)):
        dts, steps = hk._chain_grid(mats, max_dt)
        jdts, jsteps = hp._chain_grid(mats, max_dt)
        np.testing.assert_array_equal(dts, jdts)
        assert steps == jsteps
    _, p = hk._params_vec(S, K, T, R, PAR, Q, 4)
    kw = dict(n_steps=4, n_blocks=1, cp=1.0, sampler="hash")
    with pytest.raises(ValueError, match="CUDA"):
        hk._heston_mc_cuda(0, 0, torch.tensor(p), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        hk._heston_qe_cuda(0, 0, torch.tensor(p[:13]), **kw)
    with pytest.raises(ValueError, match="device"):
        hk._dispatch(hk._heston_mc_cuda, hk._heston_mc_plain, torch.device("meta"), 0, 0,
                     torch.tensor(p), **kw)


# ---------------------------------------------------------------------------
# the statistical and oracle checks of tests/test_heston_pallas.py
# ---------------------------------------------------------------------------
N25 = 25


def _lewis64(**over):
    vals = dict(zip(("v0", "kappa", "theta", "sigma", "rho"), PAR_ARGS))
    vals.update(over)
    return HestonParams.make(**vals, dtype=torch.float64)


def _lewis_grad(**at):
    """∂ Lewis price / ∂(v0, κ, θ, σ, ρ, T, r, S) by autograd, float64."""
    names = ("v0", "kappa", "theta", "sigma", "rho")
    x = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in zip(names + ("T", "r", "S"), PAR_ARGS + (T, R, S))}
    par = HestonParams(*(x[k] for k in names))
    price = heston_price(ContractBatch(x["S"], torch.tensor(K, dtype=torch.float64), x["T"],
                                       x["r"], torch.tensor(0.2, dtype=torch.float64),
                                       torch.tensor(0.0, dtype=torch.float64),
                                       torch.tensor(1.0, dtype=torch.float64)), par)
    return dict(zip(x, torch.autograd.grad(price, list(x.values())))), price.item()


@pytest.fixture(scope="module")
def kernel_out():
    return hk.heston_kernel_greeks(S, K, T, R, PAR, 1.0, n_paths=1, n_steps=N25, seed=0,
                                   sampler="hash", device=CPU)


@pytest.fixture(scope="module")
def lewis_ad():
    return _lewis_grad()


@pytest.mark.parametrize("key,bound", [("price", None), ("delta", 0.01), ("rho", 0.6),
                                       ("vega_v0", None)])
def test_kernel_against_lewis(kernel_out, lewis_ad, key, bound):
    """Price within Euler bias (25 steps: a few cents) + 5·stderr of Lewis;
    delta, rho and v0-vega against autograd of Lewis (the reference's
    bounds: test_heston_pallas.py:37, :61-62, :95)."""
    grads, exact = lewis_ad
    got = float(kernel_out[key])
    if key == "price":
        assert abs(got - exact) < 5 * float(kernel_out["std_error"]) + 0.05
    elif key == "vega_v0":
        dv0 = float(grads["v0"])
        assert abs(got - dv0) < 0.06 * abs(dv0) + 1.0
        np.testing.assert_allclose(float(kernel_out["vega"]), 2.0 * math.sqrt(0.04) * got,
                                   rtol=1e-6)
    else:
        assert abs(got - float(grads["S" if key == "delta" else "r"])) < bound


def test_put_parity_consistency(kernel_out):
    put = hk.heston_kernel_greeks(S, K, T, R, PAR, -1.0, n_paths=1, n_steps=N25, seed=0,
                                  sampler="hash", device=CPU)
    lhs = float(kernel_out["price"]) - float(put["price"])
    assert abs(lhs - (S - K * math.exp(-R * T))) < 0.05
    assert abs((float(kernel_out["delta"]) - float(put["delta"])) - 1.0) < 5e-3


def test_price_wrapper_consistent(kernel_out):
    p, _, n = hk.heston_kernel_price(S, K, T, R, PAR, 1.0, n_paths=1, n_steps=N25, seed=0,
                                     sampler="hash", device=CPU)
    assert float(p) == float(kernel_out["price"]) and n == kernel_out["paths"]


def test_price_matches_scan_engine(kernel_out):
    from optionslab_tpu_torch.models.heston import heston_mc_price

    gen = torch.Generator().manual_seed(3)
    scan = float(heston_mc_price(ContractBatch.make(S, K, T, R, 0.2, "call"), PAR, gen,
                                 n_paths=200_000, n_steps=N25))
    assert abs(float(kernel_out["price"]) - scan) < 5 * float(kernel_out["std_error"]) + 0.05


def test_full_ladder_matches_lewis_ad(lewis_ad):
    """The Euler ladder at 32 steps on 131072 paths against autograd of Lewis
    (the reference's slow test at 262144 paths × 64 steps, cut for the
    CPU; bounds widened from test_heston_pallas.py:187-190 by √2 for the
    halved paths plus the Euler bias of 32 vs 64 steps)."""
    out = hk.heston_kernel_greeks(S, K, T, R, PAR, n_paths=131072, n_steps=32, seed=0,
                                  sampler="hash", ladder=True, device=CPU)
    g, _ = lewis_ad
    checks = [("vega_v0", g["v0"], 1.2), ("d_kappa", g["kappa"], 0.05),
              ("d_theta", g["theta"], 1.8), ("d_sigma", g["sigma"], 0.18),
              ("d_rho", g["rho"], 0.12), ("theta", -g["T"], 0.22), ("rho", g["r"], 0.9)]
    for key, exact, atol in checks:
        assert abs(float(out[key]) - float(exact)) < atol, (key, float(out[key]), float(exact))


def test_qe_unbiased_at_coarse_steps(lewis_ad):
    """QE at 16 steps within MC noise of Lewis, where Euler is biased."""
    _, exact = lewis_ad
    pq, seq, _ = hk.heston_kernel_price(S, K, T, R, PAR, n_paths=131072, n_steps=16, seed=0,
                                        sampler="hash", scheme="qe", device=CPU)
    assert abs(float(pq) - exact) < 4 * float(seq) + 0.01, (float(pq), exact, float(seq))


def test_qe_ladder_matches_lewis_ad(lewis_ad):
    """The CRN-bump QE ladder at 16 steps against autograd of Lewis
    (test_heston_pallas.py:392, its bounds)."""
    out = hk.heston_kernel_greeks(S, K, T, R, PAR, n_paths=1, n_steps=16, seed=0,
                                  sampler="hash", scheme="qe", ladder=True, device=CPU)
    g, _ = lewis_ad
    exact = {"vega_v0": g["v0"], "d_kappa": g["kappa"], "d_theta": g["theta"],
             "d_sigma": g["sigma"], "d_rho": g["rho"], "delta": g["S"], "rho": g["r"],
             "theta": -g["T"]}
    tols = {"vega_v0": 1.5, "d_kappa": 0.05, "d_theta": 2.0, "d_sigma": 0.05, "d_rho": 0.02,
            "delta": 0.01, "rho": 0.25, "theta": 0.05}
    for k, tol in tols.items():
        assert abs(float(out[k]) - float(exact[k])) < tol, (k, float(out[k]), float(exact[k]))


def test_chain_against_lewis_and_single_ladder():
    """Chain prices and gradients against Lewis and its autograd
    (test_heston_pallas.py:223, its sizes and bounds), and the chain
    against the single-contract ladder (:278)."""
    strikes, mats, cps = [95.0, 105.0, 100.0], [0.5, 0.5, 1.0], [-1.0, 1.0, 1.0]
    prices, ses, grads = hk.heston_chain_ladder(strikes, mats, cps, S, R, PAR, n_paths=131072,
                                                max_dt=1.0 / 16, sampler="hash", device=CPU)
    for q in range(3):
        pv = torch.tensor(PAR_ARGS, dtype=torch.float64, requires_grad=True)
        par = HestonParams(*pv.unbind())
        ex = heston_price(ContractBatch.make(S, strikes[q], mats[q], R, 0.2,
                                             "call" if cps[q] > 0 else "put",
                                             dtype=torch.float64), par)
        (gex,) = torch.autograd.grad(ex, pv)
        assert abs(float(prices[q]) - ex.item()) < 5 * float(ses[q]) + 0.06, q
        gex = gex.numpy()
        tol = np.maximum(0.12, 0.03 * np.abs(gex)) + 0.12 * np.abs(gex)
        assert np.all(np.abs(grads[q].numpy() - gex) <= tol), (q, grads[q], gex)
    p1, s1, g1 = hk.heston_chain_ladder([100.0], [1.0], [1.0], S, R, PAR, n_paths=131072,
                                        max_dt=1.0 / 16, sampler="hash", device=CPU)
    single = hk.heston_kernel_greeks(S, 100.0, 1.0, R, PAR, n_paths=131072, n_steps=16, seed=7,
                                     sampler="hash", ladder=True, device=CPU)
    assert abs(float(p1[0]) - float(single["price"])) < 5 * float(s1[0]) + 0.05
    for idx, key, atol in [(0, "vega_v0", 1.5), (1, "d_kappa", 0.05), (2, "d_theta", 2.0),
                           (3, "d_sigma", 0.25), (4, "d_rho", 0.15)]:
        assert abs(float(g1[0][idx]) - float(single[key])) < atol, key


def test_kernel_calibration_recovers_params():
    """calibrate_heston_mc on the chain kernel's own prices at known
    parameters (one path block, dt = 1/4): the fixed seed makes the loss
    surface deterministic with its minimum at the generating parameters,
    so Adam through the in-kernel gradients must walk back to them. (The
    Lewis-priced version at full size runs in chip_smoke.py.)"""
    from optionslab_tpu_torch.models.heston import calibrate_heston_mc

    strikes, mats, cps = [90.0, 100.0, 110.0, 95.0, 105.0], [0.5, 0.5, 0.5, 1.0, 1.0], \
        [-1.0, 1.0, 1.0, -1.0, 1.0]
    gen = HestonParams.make(0.04, 2.0, 0.05, 0.3, -0.7)
    kw = dict(n_paths=1, max_dt=0.25, sampler="hash", device=CPU)
    market, _, _ = hk.heston_chain_ladder(strikes, mats, cps, S, R, gen, **kw)
    fit, loss = calibrate_heston_mc(market, strikes, mats, cps, S, R,
                                    init=HestonParams.make(0.045, 1.8, 0.045, 0.32, -0.65),
                                    n_steps=60, learning_rate=0.02, **kw)
    assert loss < 5e-5, loss
    assert abs(float(fit.v0) - 0.04) < 0.004
    assert abs(float(fit.theta) - 0.05) < 0.004
    assert abs(float(fit.kappa) - 2.0) < 0.25
    assert abs(float(fit.rho) + 0.7) < 0.15
    assert abs(float(fit.sigma) - 0.3) < 0.1


def test_hash_deterministic_seed_sensitive():
    kw = dict(n_paths=1, n_steps=5, sampler="hash", device=CPU)
    p0, _, _ = hk.heston_kernel_price(S, K, T, R, PAR, seed=3, **kw)
    p1, _, _ = hk.heston_kernel_price(S, K, T, R, PAR, seed=3, **kw)
    p2, _, _ = hk.heston_kernel_price(S, K, T, R, PAR, seed=4, **kw)
    assert float(p0) == float(p1) != float(p2)


DEGEN = HestonParams.make(0.04, 2.0, 0.04, 1e-6, -0.5)


def test_bridge_qmc_degenerate_is_black_scholes():
    """σ_v ≈ 0, θ = v0: the Euler scheme is exact per step, so Black–Scholes
    is an exact oracle; bridge QMC sits well inside the MC noise."""
    from optionslab_tpu_torch.models.black_scholes import bs_price

    exact = float(bs_price(S, K, T, R, 0.2, 1.0, 0.0))
    p_q, _, _ = hk.heston_kernel_price(S, K, T, R, DEGEN, n_paths=1, n_steps=8, seed=0,
                                       sampler="sobol_bb", device=CPU)
    _, se_h, _ = hk.heston_kernel_price(S, K, T, R, DEGEN, n_paths=1, n_steps=8, seed=0,
                                        sampler="hash", device=CPU)
    assert abs(float(p_q) - exact) < 0.5 * float(se_h)


def test_bridge_qmc_smile_point_matches_plain_mc():
    p_q, se_q, _ = hk.heston_kernel_price(S, K, T, R, PAR, n_paths=1, n_steps=8, seed=0,
                                          sampler="sobol_bb", device=CPU)
    p_h, se_h, _ = hk.heston_kernel_price(S, K, T, R, PAR, n_paths=1, n_steps=8, seed=1,
                                          sampler="hash", device=CPU)
    assert abs(float(p_q) - float(p_h)) < 5 * math.hypot(float(se_q), float(se_h))


def test_pricer_pallas_engine_runs_the_kernel_path():
    pricer = HestonPricer(*PAR_ARGS, device=CPU)
    p = pricer.price_monte_carlo(S, K, T, R, n_paths=1, n_steps=N25, engine="pallas")
    ref, _, _ = hk.heston_kernel_price(S, K, T, R, PAR, n_paths=1, n_steps=N25, device=CPU)
    assert float(p) == float(ref)
    exact = float(j_heston_price(JContractBatch.make(S, K, T, R, 0.2, "call"), JPAR))
    assert abs(float(p) - exact) < 0.15
