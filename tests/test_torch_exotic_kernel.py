"""The exotic kernels' plain versions against the JAX package's kernels.

On the CPU the port runs the plain torch versions of ``csrc/exotic_mc.cu``
and ``csrc/exotic_greeks.cu``; the JAX kernels run in TPU interpret mode.
With the ``hash`` and ``sobol_bb_hash`` samplers both draw the same
uniforms from the same counters, so the per-row moment sums (the JAX
(128, 128) tiles summed over their lanes) agree up to float32
transcendental and summation-order error. The CUDA kernels themselves are
held to the plain versions in ``test_torch_cuda.py``, on a card.

Tolerances:

* rtol 1e-5 on every row sum. The signed score moments (D1, DG, DZ, D2,
  DR, and the Greeks kernel's P0/G1/G2 of puts) cancel inside a row, so
  they are held to rtol 1e-5 of the moment's largest row instead of their
  own row.
* Kinds with an indicator (barriers, touches, range accrual, autocall, pay
  at hit) and the Greeks kernel's in-the-money and extremum switches may
  have at most 2 of the 128 rows off, each by at most one lane's largest
  term (four paths): a path whose spot lands within an ulp of a barrier or
  strike can fall on either side between XLA's and torch's float32 libm.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.ops import exotic_pallas as ep
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


S, K, T, R, SIG, Q = 100.0, 100.0, 1.0, 0.05, 0.2, 0.01
N_STEPS = 8
SEED = 3
RTOL = 1e-5
MAX_OFF_ROWS = 2
SMOOTH = ("asian_arith", "asian_geo", "asian_arith_cv", "lookback_float", "lookback_fixed",
          "cliquet")
PERIOD = {"cliquet": 2, "autocall": 2}


def _params(kind: str, strike: float = K) -> list:
    barrier = 115.0 if "up" in kind else 88.0
    p, _ = ek._base_params(S, strike, T, R, SIG, Q, barrier, N_STEPS)
    if "double" in kind:
        p[ek._P_A], p[ek._P_B] = 88.0, 115.0
    if kind == "cliquet":
        p[ek._P_A:] = [-0.03, 0.03, 0.0, 1e9, 100.0]
    if kind == "autocall":
        p[ek._P_A:] = [100.0, 80.0, 70.0, 2.0, 100.0]
    if kind == "range_accrual":
        p[ek._P_A], p[ek._P_B], p[ek._P_E] = 90.0, 110.0, 100.0
    return p


def _single_book(p) -> torch.Tensor:
    return torch.tensor([[p[j] for j in ek._BOOK_SLOTS]], dtype=torch.float32)


def _jax_sums(outs) -> np.ndarray:
    return np.stack([np.asarray(o, np.float64).sum(axis=1) for o in outs])


def _lane_max(terms) -> np.ndarray:
    """(n_mom, ROWS): each row's largest |lane term| (one lane = 4 paths)."""
    return np.stack([t.double().abs().amax(dim=(0, 2)).numpy() for t in terms])


def assert_rows_close(ours, ref, lane_max=None):
    """Row sums within RTOL; with ``lane_max``, up to MAX_OFF_ROWS rows may
    be off by at most one lane's largest term (see the module docstring)."""
    assert ours.shape == ref.shape
    scale = np.abs(ref)
    scale[2:] = np.maximum(scale[2:], np.abs(ref[2:]).max(axis=1, keepdims=True))
    diff = np.abs(ours - ref)
    bad = diff > RTOL * scale
    off_rows = np.flatnonzero(bad.any(axis=0))
    if lane_max is None:
        assert off_rows.size == 0, (off_rows, (diff / scale).max(axis=1))
        return
    assert off_rows.size <= MAX_OFF_ROWS, (off_rows, (diff / scale).max(axis=1))
    assert np.all(diff[bad] <= lane_max[bad] + RTOL * scale[bad])


@functools.lru_cache(maxsize=None)
def _jax_price_sums(kind, sampler, lr, p, book, nc, cp) -> np.ndarray:
    """Row sums of the JAX price kernel; its Σpay and Σpay² do not depend on
    ``lr``, so an ``lr=False`` case reads them from the ``lr=True`` launch
    (one interpret-mode compile per kind instead of two)."""
    lr_launch = lr or (not sampler.startswith("sobol") and kind != "asian_arith_cv")
    kw = dict(kind=kind, n_steps=N_STEPS, n_blocks=1, cp=cp, period=PERIOD.get(kind, 1),
              sampler=sampler, lr=lr_launch)
    if lr_launch != lr:
        return _jax_price_sums(kind, sampler, True, p, book, nc, cp)[:2]
    jbook = None if book is None else jnp.asarray(book, jnp.float32)
    return _jax_sums(ep._launch(jnp.asarray([SEED, 0], jnp.int32), jnp.asarray(p, jnp.float32),
                                jbook, n_contracts=nc, **kw))


def _price_case(kind, sampler, lr, book=None, nc=1, p=None, cp=1.0):
    p = _params(kind) if p is None else p
    kw = dict(kind=kind, n_steps=N_STEPS, n_blocks=1, cp=cp, period=PERIOD.get(kind, 1),
              sampler=sampler, lr=lr)
    ref = _jax_price_sums(kind, sampler, lr, tuple(p),
                          None if book is None else tuple(book.numpy().ravel().tolist()), nc, cp)
    params = torch.tensor(np.asarray(p, np.float32))
    book_t = _single_book(p) if book is None else book
    ours = ek._exotic_moments_plain(SEED, 0, params, book_t, **kw)
    assert ours.dtype == torch.float32 and ours.shape == (ek._n_moments(kind, lr), ek.ROWS)
    lane_max = None
    if kind not in SMOOTH:
        block = ek._block_ids(0, 0, 1, "cpu")
        lane_max = _lane_max(ek._exotic_block_plain(
            SEED, block, params, book_t, **{k: v for k, v in kw.items() if k != "n_blocks"}))
    assert_rows_close(ours.double().numpy(), ref, lane_max)
    return ours


@pytest.mark.parametrize("kind,lr", [(k, lr) for lr in (False, True) for k in ek.PAYOFF_KINDS
                                     if not (lr and k == "asian_arith_cv")])  # CV: no LR
def test_price_kernel_rows_match_reference(kind, lr):
    _price_case(kind, "hash", lr)


@pytest.mark.parametrize("kind", ["asian_geo", "asian_arith_cv", "barrier_up-and-out"])
def test_bridge_qmc_rows_match_reference(kind):
    _price_case(kind, "sobol_bb_hash", False)


@pytest.mark.parametrize("kind,cp", [("asian_arith", -1.0), ("lookback_float", -1.0),
                                     ("barrier_down-and-in", -1.0)])
def test_puts_match_reference(kind, cp):
    _price_case(kind, "hash", True, cp=cp)


BOOKS = [  # kind, nc, lr
    ("asian_arith", 8, False),
    ("asian_arith", 2, True),
    ("barrier_up-and-out", 8, True),
    ("barrier_double-out", 2, False),
    ("one_touch_up_hit", 8, True),
    ("barrier_double-out", 1, True),
]


@pytest.mark.parametrize("kind,nc,lr", BOOKS)
def test_book_rows_match_reference(kind, nc, lr):
    """Contract j of a book rides the rows r with r % nc == j."""
    strikes = list(np.linspace(92.0, 108.0, nc))
    barriers = list(np.linspace(112.0, 130.0, nc))
    lowers = list(np.linspace(80.0, 90.0, nc))
    uppers = list(np.linspace(115.0, 125.0, nc))
    p, _ = ek._base_params(S, strikes[0], T, R, SIG, Q, barriers[0], N_STEPS)
    if "double" not in kind:
        lowers = uppers = [0.0] * nc
    else:  # a one-contract book rides the parameter vector (the reference's scalar path)
        p[ek._P_A], p[ek._P_B] = lowers[0], uppers[0]
    book = torch.tensor(ek._book_table(strikes, barriers, lowers, uppers, nc), dtype=torch.float32)
    jbook = ep._book_smem(strikes, barriers, lowers, uppers, [0.0] * nc, [0.0] * nc, [0.0] * nc,
                          nc)
    np.testing.assert_array_equal(book.numpy().ravel(), jbook)
    ours = _price_case(kind, "hash", lr, book=book, nc=nc, p=p)
    if nc > 1:  # contracts differ: their row groups' sums differ
        groups = ours[0].double().reshape(ek.ROWS // nc, nc).sum(dim=0)
        assert len(set(groups.tolist())) == nc


@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("kind", ek.GREEK_KINDS)
def test_greeks_kernel_rows_match_reference(kind, cp):
    p = _params(kind, strike=105.0)
    kw = dict(kind=kind, n_steps=N_STEPS, n_blocks=1, cp=cp, sampler="hash")
    ref = _jax_sums(ep._launch_greeks(jnp.asarray([SEED, 0], jnp.int32),
                                      jnp.asarray(p, jnp.float32), **kw))
    params = torch.tensor(np.asarray(p, np.float32))
    ours = ek._exotic_greeks_plain(SEED, 0, params, **kw)
    assert ours.shape == (5, ek.ROWS)
    terms = ek._greeks_block_plain(SEED, ek._block_ids(0, 0, 1, "cpu"), params, kind=kind,
                                   n_steps=N_STEPS, cp=cp, sampler="hash")
    assert_rows_close(ours.double().numpy(), ref, _lane_max(terms))
    if kind == "asian_geo":
        assert torch.all(ours[4] == 0)  # G2 is substituted on the host


# ---------------------------------------------------------------------------
# the port's own geometry and launch plumbing
# ---------------------------------------------------------------------------
def test_geometry_is_the_reference_counter_space():
    assert (ek.ROWS, ek.LANES, ek.LANES_G) == (ep.ROWS, ep.LANES, ep.LANES_G)
    assert ek.PAYOFF_KINDS == ep.PAYOFF_KINDS and len(ek.PAYOFF_KINDS) == 23
    assert ek.GREEK_KINDS == ep.GREEK_KINDS
    assert ek.N_PARAMS == ep.N_PARAMS == 14
    assert ek.PATHS_PER_BLOCK == ep.PATHS_PER_BLOCK
    for args in [(100.0, 95.0, 0.5, 0.03, 0.25, 0.01, 120.0, 64), (80.0, 0.0, 0.0, 0.0, 0.1, 0.0,
                                                                     0.0, 1)]:
        assert ek._base_params(*args) == ep._base_params(*args)


@pytest.mark.parametrize("n_blocks", [1, 16, 31, 62, 489, 5000])
def test_chunking_covers_every_block(n_blocks):
    n_chunks, per_chunk = ek._chunking(n_blocks)
    assert 1 <= n_chunks * ek.ROWS <= max(ek._TARGET_CTAS, ek.ROWS)
    assert (n_chunks - 1) * per_chunk < n_blocks <= n_chunks * per_chunk


@pytest.mark.parametrize("n_steps", [2, 8, 64, 252])
def test_bridge_plan_arrays(n_steps):
    ints, floats = ek._bridge_plan_arrays(n_steps)
    bounds, constructs = ek.bridge_plan(n_steps, 8)
    n_seg, n_con = ints[0], ints[10]
    assert n_seg == len(bounds) - 1 and list(ints[1:2 + n_seg]) == bounds
    assert n_con == len(constructs)
    for j, (m, a, b) in enumerate(constructs):
        assert (bounds[ints[11 + j]], bounds[ints[18 + j]], bounds[ints[25 + j]]) == (m, a, b)
        assert floats[1 + j] == np.float32((m - a) / (b - a))
    for j in range(n_seg):
        assert floats[15 + j] == np.float32(1.0 / (bounds[j + 1] - bounds[j]))


def test_kernel_codes_cover_every_kind():
    codes = {(kind, cp): ek._kernel_codes(kind, cp) for kind in ek.PAYOFF_KINDS
             for cp in (1.0, -1.0)}
    # each kind (and each lookback direction) has its own (family, mode)
    assert len(set(codes.values())) == len(ek.PAYOFF_KINDS) + 2
    assert codes[("lookback_float", 1.0)] != codes[("lookback_float", -1.0)]


def test_plain_version_chunks_blocks():
    """Block steps of the plain version's loop are invisible in its sums."""
    p = _params("asian_arith")
    params, book = torch.tensor(np.asarray(p, np.float32)), _single_book(p)
    kw = dict(kind="asian_arith", n_steps=4, n_blocks=3, cp=1.0, sampler="prng")
    whole = ek._exotic_moments_plain(1, 5, params, book, **kw)
    old = ek._PLAIN_CHUNK_ELEMS
    try:
        ek._PLAIN_CHUNK_ELEMS = ek.ROWS * ek.LANES  # one block per step
        stepped = ek._exotic_moments_plain(1, 5, params, book, **kw)
    finally:
        ek._PLAIN_CHUNK_ELEMS = old
    torch.testing.assert_close(whole, stepped, rtol=1e-6, atol=0)


def test_dispatch_by_device():
    p = _params("asian_geo")
    params, book = torch.tensor(np.asarray(p, np.float32)), _single_book(p)
    kw = dict(kind="asian_geo", n_steps=2, n_blocks=1, cp=1.0, sampler="hash")
    torch.testing.assert_close(ek._exotic_moments(0, 0, params, book, **kw),
                               ek._exotic_moments_plain(0, 0, params, book, **kw))
    with pytest.raises(ValueError, match="CUDA"):
        ek._exotic_moments_cuda(0, 0, params, book, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ek._exotic_greeks_cuda(0, 0, params, kind="asian_geo", n_steps=2, n_blocks=1, cp=1.0)
    with pytest.raises(ValueError, match="device"):
        ek._exotic_moments(0, 0, params.to("meta"), book, **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="nope"), "unknown"),
    (dict(sampler="sobol"), "sampler"),
    (dict(n_steps=0), "n_steps"),
    (dict(sampler="sobol_bb", n_steps=1), "n_steps >= 2"),
    (dict(sampler="sobol_bb_hash", lr=True), "LR"),
])
def test_launch_checks(kw, match):
    p = _params("asian_arith")
    params, book = torch.tensor(np.asarray(p, np.float32)), _single_book(p)
    args = dict(kind="asian_arith", n_steps=4, n_blocks=1, cp=1.0, sampler="hash", lr=False)
    with pytest.raises(ValidationError, match=match):
        ek._exotic_moments_plain(0, 0, params, book, **{**args, **kw})


def test_greeks_launch_checks():
    params = torch.tensor(np.asarray(_params("asian_arith"), np.float32))
    with pytest.raises(ValidationError, match="in-kernel Greeks"):
        ek._exotic_greeks_plain(0, 0, params, kind="barrier_up-and-out", n_steps=4, n_blocks=1,
                                cp=1.0)
    with pytest.raises(ValidationError, match="prng/hash"):
        ek._exotic_greeks_plain(0, 0, params, kind="asian_arith", n_steps=4, n_blocks=1,
                                cp=1.0, sampler="sobol_bb")
