"""The multi-asset kernel's plain version against the JAX package's
``_ma_kernel``, the wrappers against ``pallas_multi_asset_price`` and
``pallas_multi_asset_greeks``, the exact oracles and the ``ValidationError``
cases of ``tests/test_multi_asset_pallas.py``.

On the CPU the port runs the plain torch version of
``csrc/multi_asset_mc.cu``; the JAX kernel runs in TPU interpret mode with
``sampler="hash"`` or ``"sobol"`` (the JAX ``prng`` has no CPU mode) at one
path block (131,072 paths). Each JAX launch runs once per case, with ``lr``
on; the port's ``lr``-off twin is held to its first two moments. The CUDA
kernel itself is held to the plain version in ``test_torch_cuda.py`` and by
``chip_smoke.py``, on a card.

Tolerances, with their reasons:

* per-row sums of every moment to rtol 1e-5 of that moment's largest row
  (XLA's and torch's float32 libm differ by an ulp on some inputs; measured
  ≤ 1.3e-6, the spread's LR moments);
* the wrappers' price and stderr to rtol 1e-5 (measured ≤ 1.9e-6), a
  ``sobol`` stderr also to 1e-5 of the price: it is the spread of 8
  replicate means, which cancel (measured 6.2e-5 of itself, 2e-8 of the
  price);
* the delta, vega, gamma, theta and rho entries to 1e-4 of the entry's
  scale max(|value|, 1e-2·price): their moments are signed and cancel over
  the rows (measured ≤ 1.2e-5, the spread's rho, which Margrabe makes 0).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.ops import multi_asset_pallas as jm
from optionslab_tpu_torch.models.multi_asset import geometric_basket_closed_form, margrabe_price
from optionslab_tpu_torch.ops import multi_asset_kernel as mk
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPOTS = [100.0, 95.0, 105.0, 98.0]
VOLS = [0.2, 0.25, 0.3, 0.22]
CORR = np.array([[1.0, 0.5, 0.3, 0.2], [0.5, 1.0, 0.4, 0.1], [0.3, 0.4, 1.0, 0.25],
                 [0.2, 0.1, 0.25, 1.0]])
WEIGHTS = {2: [0.6, 0.4], 3: [0.4, 0.3, 0.3], 4: [0.3, 0.3, 0.2, 0.2]}  # each sums to 1
K, T, R = 100.0, 1.0, 0.05
SEED, BLOCK0 = 3, 1
RTOL = 1e-5
CPU = "cpu"


def market(d):
    return SPOTS[:d], WEIGHTS[d], VOLS[:d], CORR[:d, :d]


def _vec(d, kind, n_steps, lr):
    spots, w, vols, corr = market(d)
    return mk._params_vec(spots, w, K, T, R, vols, corr, 0.0, n_steps, lr=lr,
                          cv=kind == "basket_cv")[2]


def _jax_sums(d, kind, n_steps, sampler, lr, cp):
    outs = jm._launch(np.asarray([SEED, BLOCK0], np.int32), jnp.asarray(_vec(d, kind, n_steps, lr)),
                      d=d, kind=kind, n_steps=n_steps, n_blocks=1, cp=cp, sampler=sampler, lr=lr)
    return np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs])


def _plain_sums(d, kind, n_steps, sampler, lr, cp):
    return mk._ma_plain(SEED, BLOCK0, torch.tensor(_vec(d, kind, n_steps, lr)), d=d, kind=kind,
                        n_steps=n_steps, n_blocks=1, cp=cp, sampler=sampler,
                        lr=lr).double().numpy()


def _assert_rows_close(got, ref, tag):
    scale = np.maximum(np.abs(ref), np.abs(ref).max(axis=1, keepdims=True))
    rel = np.abs(got - ref) / np.maximum(scale, 1e-30)
    assert rel.max() < RTOL, (tag, rel.max(axis=1))


# (d, kind, n_steps, sampler, cp): every kind × d ∈ {2, 3, 4} (spread d = 2),
# cp = −1 on three kinds, sobol on two terminal kinds, the Asian at 8 steps
PARITY = ([(d, kind, 8 if kind == "basket_asian" else 1, "hash", 1.0)
           for d in (2, 3, 4)
           for kind in ("basket", "basket_geo", "rainbow_best", "rainbow_worst", "basket_asian",
                        "basket_cv")]
          + [(2, "spread", 1, "hash", 1.0), (2, "spread", 1, "hash", -1.0),
             (3, "basket", 1, "hash", -1.0), (2, "rainbow_worst", 1, "hash", -1.0),
             (2, "basket_asian", 8, "hash", -1.0),
             (3, "basket_geo", 1, "sobol", 1.0), (2, "rainbow_best", 1, "sobol", 1.0)])


@pytest.mark.parametrize("d,kind,n_steps,sampler,cp", PARITY,
                         ids=[f"{k}-d{d}-{s}-cp{cp:+.0f}" for d, k, _, s, cp in PARITY])
def test_plain_matches_jax_kernel(d, kind, n_steps, sampler, cp):
    """Per-row sums of every moment with ``lr`` (basket_cv: none), and the
    ``lr``-off twin's pay and pay² against the same JAX launch."""
    lr = kind != "basket_cv"
    ref = _jax_sums(d, kind, n_steps, sampler, lr, cp)
    got = _plain_sums(d, kind, n_steps, sampler, lr, cp)
    assert got.shape == ref.shape == (mk._n_out(d, lr), mk.ROWS)
    _assert_rows_close(got, ref, "lr")
    if lr:
        _assert_rows_close(_plain_sums(d, kind, n_steps, sampler, False, cp), ref[:2], "twin")


@pytest.mark.parametrize("d,lr,cv", [(2, False, False), (3, True, False), (4, True, False),
                                     (3, False, True), (4, False, True)])
def test_params_vec_bit_for_bit(d, lr, cv):
    spots, w, vols, corr = market(d)
    args = (spots, w, K, 1.5, R, vols, corr, [0.01, 0.02, 0.0, 0.03][:d], 12)
    if d == 2:  # the default weights
        args = (spots, None) + args[2:]
    dp, tp, port = mk._params_vec(*args, lr=lr, cv=cv)
    dj, tj, ref = jm._params_vec(*args, lr=lr, cv=cv)
    assert (dp, tp) == (dj, tj) and port.dtype == ref.dtype == np.float32
    assert port.shape == (mk._n_params(d, "basket_cv" if cv else "basket", lr),)
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))


PRICE_CASES = {
    "basket": dict(kind="basket", n_steps=1, sampler="hash"),
    "basket_cv": dict(kind="basket", n_steps=1, sampler="hash", control_variate=True),
    "basket_geo_sobol": dict(kind="basket_geo", n_steps=1, sampler="sobol"),
    "basket_asian_put": dict(kind="basket_asian", n_steps=8, sampler="hash", cp=-1.0),
}


@pytest.mark.parametrize("case", sorted(PRICE_CASES))
def test_price_matches_jax(case):
    kw = dict(PRICE_CASES[case])
    kind = kw.pop("kind")
    spots, w, vols, corr = market(3)
    args = (kind, spots, K, T, R, vols, corr)
    p, se, n = mk.multi_asset_kernel_price(*args, weights=w, n_paths=1, seed=SEED, **kw,
                                           device=CPU)
    pj, sej, nj = jm.pallas_multi_asset_price(*args, weights=w, n_paths=1, seed=SEED, **kw)
    assert n == nj == mk.PATHS_PER_BLOCK
    assert p.dtype == torch.float32 and p.device.type == "cpu"
    np.testing.assert_allclose(float(p), float(pj), rtol=RTOL)
    # a sobol stderr is the spread of 8 replicate means, each good to RTOL of the price
    np.testing.assert_allclose(float(se), float(sej), rtol=RTOL, atol=RTOL * float(pj))


GREEK_CASES = {
    "basket_d3": (3, "basket", 1, "hash", 1.0),
    "basket_asian_d3": (3, "basket_asian", 8, "hash", 1.0),
    "rainbow_worst_put_d2": (2, "rainbow_worst", 1, "hash", -1.0),
    "spread_d2": (2, "spread", 1, "hash", 1.0),
    "basket_geo_sobol_d3": (3, "basket_geo", 1, "sobol", 1.0),
    "rainbow_best_d4": (4, "rainbow_best", 1, "hash", 1.0),
}


@pytest.mark.parametrize("case", sorted(GREEK_CASES))
def test_greeks_match_jax(case):
    d, kind, n_steps, sampler, cp = GREEK_CASES[case]
    spots, w, vols, corr = market(d)
    strike = 0.0 if kind == "spread" else K
    args = (kind, spots, strike, T, R, vols, corr)
    kw = dict(weights=w, cp=cp, n_paths=1, n_steps=n_steps, seed=SEED, sampler=sampler)
    out = mk.multi_asset_kernel_greeks(*args, **kw, device=CPU)
    ref = jm.pallas_multi_asset_greeks(*args, **kw)
    assert set(out) == set(ref) and out["paths"] == ref["paths"]
    price = float(ref["price"])
    for key in ("price", "std_error"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=RTOL, err_msg=key)
    for key, shape in (("delta", (d,)), ("vega", (d,)), ("gamma", (d, d)), ("theta", ()),
                       ("rho", ())):
        got, want = np.asarray(out[key], np.float64), np.asarray(ref[key], np.float64)
        assert got.shape == shape
        scale = np.maximum(np.abs(want), 1e-2 * price)
        assert (np.abs(got - want) / scale).max() < 1e-4, (key, got, want)
    np.testing.assert_array_equal(out["gamma"].numpy(), out["gamma"].numpy().T)


# ---------------------------------------------------------------------------
# The exact oracles of tests/test_multi_asset_pallas.py, on the port alone
# ---------------------------------------------------------------------------
SP3, V3, C3 = SPOTS[:3], VOLS[:3], CORR[:3, :3]
W3 = [0.4, 0.3, 0.3]  # the reference tests' weights (they sum to 1: the CV's regime)
KW = dict(n_paths=1, seed=0, sampler="hash", device=CPU)


@pytest.mark.parametrize("n_steps", [1, 4])
def test_geometric_basket_matches_closed_form(n_steps):
    """n_steps does not bias terminal payoffs (exact increments)."""
    p, se, n = mk.multi_asset_kernel_price("basket_geo", SP3, K, T, R, V3, C3, weights=W3,
                                           n_steps=n_steps, **KW)
    exact = geometric_basket_closed_form(SP3, W3, K, T, R, V3, C3).item()
    assert n >= 100_000
    assert abs(p.item() - exact) < 5 * se.item() + 1e-3


def test_spread_k0_matches_margrabe():
    p, se, _ = mk.multi_asset_kernel_price("spread", [100.0, 95.0], 0.0, T, R, [0.2, 0.25],
                                           [[1.0, 0.6], [0.6, 1.0]], **KW)
    exact = margrabe_price(100.0, 95.0, T, 0.2, 0.25, 0.6).item()
    assert abs(p.item() - exact) < 5 * se.item() + 1e-3


def test_cv_unbiased_and_tighter():
    args = ("basket", SP3, K, T, R, V3, C3)
    p_cv, se_cv, _ = mk.multi_asset_kernel_price(*args, weights=W3, control_variate=True, **KW)
    p_pl, se_pl, _ = mk.multi_asset_kernel_price(*args, weights=W3, **KW)
    assert abs(p_cv.item() - p_pl.item()) < 4 * math.hypot(se_cv.item(), se_pl.item())
    assert se_cv.item() < se_pl.item() / 4.0


def test_sobol_well_inside_mc_noise():
    """The price route's sobol stderr is the 8-replicate randomized-QMC one:
    smaller than the hash run's plain-MC stderr, and the QMC error well
    inside one plain-MC stderr."""
    exact = geometric_basket_closed_form(SP3, W3, K, T, R, V3, C3).item()
    p_q, se_q, _ = mk.multi_asset_kernel_price("basket_geo", SP3, K, T, R, V3, C3, weights=W3,
                                               n_paths=1, seed=0, sampler="sobol", device=CPU)
    _, se_h, _ = mk.multi_asset_kernel_price("basket_geo", SP3, K, T, R, V3, C3, weights=W3,
                                             **KW)
    assert abs(p_q.item() - exact) < 0.5 * se_h.item()
    assert 0.0 < se_q.item() < se_h.item()


def test_geo_basket_ladder_matches_closed_form_autograd():
    """The LR delta and vega of the geometric basket against autograd of its
    closed form (the reference test's bounds at one block)."""
    out = mk.multi_asset_kernel_greeks("basket_geo", SP3, K, T, R, V3, C3, weights=W3, **KW)
    s = torch.tensor(SP3, dtype=torch.float64, requires_grad=True)
    v = torch.tensor(V3, dtype=torch.float64, requires_grad=True)
    d_s, d_v = torch.autograd.grad(geometric_basket_closed_form(s, W3, K, T, R, v, C3), (s, v))
    np.testing.assert_allclose(out["delta"].numpy(), d_s.numpy(), atol=0.02)
    np.testing.assert_allclose(out["vega"].numpy(), d_v.numpy(), atol=1.6)


# ---------------------------------------------------------------------------
# ValidationError cases (tests/test_multi_asset_pallas.py), one for one
# ---------------------------------------------------------------------------
def test_bad_kind():
    with pytest.raises(ValidationError):
        mk.multi_asset_kernel_price("nope", SP3, K, T, R, V3, C3, device=CPU)


def test_spread_needs_two_assets():
    with pytest.raises(ValidationError):
        mk.multi_asset_kernel_price("spread", SP3, K, T, R, V3, C3, device=CPU)


def test_too_many_assets():
    with pytest.raises(ValidationError):
        mk.multi_asset_kernel_price("basket", [100.0] * 5, K, T, R, [0.2] * 5, np.eye(5),
                                    device=CPU)


def test_seed_changes_estimate():
    a, _, _ = mk.multi_asset_kernel_price("basket", SP3, K, T, R, V3, C3, n_paths=1, seed=0,
                                          sampler="hash", device=CPU)
    b, _, _ = mk.multi_asset_kernel_price("basket", SP3, K, T, R, V3, C3, n_paths=1, seed=5,
                                          sampler="hash", device=CPU)
    assert a.item() != b.item()


def test_qmc_rejects_multistep():
    with pytest.raises(ValidationError):
        mk.multi_asset_kernel_price("basket_asian", SP3, K, T, R, V3, C3, weights=W3, n_paths=1,
                                    n_steps=4, sampler="sobol", device=CPU)


def test_cv_validation():
    with pytest.raises(ValidationError):
        mk.multi_asset_kernel_price("rainbow_best", SP3, K, T, R, V3, C3, n_paths=1,
                                    control_variate=True, device=CPU)
    with pytest.raises(ValidationError):
        mk.multi_asset_kernel_greeks("basket_cv", SP3, K, T, R, V3, C3, n_paths=1, device=CPU)


def test_non_positive_definite_corr_raises():
    """The reference lets numpy's LinAlgError through here; the port raises
    ValidationError."""
    bad = [[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]]
    with pytest.raises(ValidationError, match="positive definite"):
        mk.multi_asset_kernel_price("basket", SP3, K, T, R, V3, bad, n_paths=1, device=CPU)
    with pytest.raises(ValidationError, match="positive definite"):
        mk.multi_asset_kernel_greeks("basket", SP3, K, T, R, V3, bad, n_paths=1, device=CPU)
    with pytest.raises(np.linalg.LinAlgError):
        jm._params_vec(SP3, None, K, T, R, V3, bad, 0.0, 1)


@pytest.mark.parametrize("kw", [dict(sampler="sobol_bb"), dict(n_steps=0),
                                dict(kind="basket_cv", lr=True)])
def test_plain_launch_rejects(kw):
    args = dict(d=3, kind="basket", n_steps=1, n_blocks=1, cp=1.0, sampler="hash", lr=False)
    args.update(kw)
    with pytest.raises(ValidationError):
        mk._ma_plain(0, 0, torch.zeros(64), **args)


def test_cpu_params_never_reach_the_kernel_wrapper():
    with pytest.raises(ValueError, match="CUDA"):
        mk._ma_cuda(0, 0, torch.tensor(_vec(3, "basket", 1, False)), d=3, kind="basket",
                    n_steps=1, n_blocks=1, cp=1.0)
