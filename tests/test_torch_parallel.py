"""``parallel/`` of the port against the JAX package's, on the CPU.

The reference runs on its 8 forced host devices (``tests/conftest.py``),
its kernels in TPU interpret mode with ``sampler="hash"``; the port runs on
a CPU mesh, ``[torch.device("cpu")] * 8``, where every shard's launch is
the kernel's plain version. The same (seed, global block) path set goes
through both, so a sharded route of the port agrees with the reference's
sharded call to float32 association and libm, at the reference's own
sharded-vs-unsharded tolerances (``tests/test_sharded_pallas.py``,
``test_heston_pallas.py``, ``test_local_vol_pallas.py``,
``test_multi_asset_pallas.py``, ``test_slv_pallas.py``), stated at each
assertion.

The tensor engine draws its normals from Philox where the reference folds
the block into a threefry key, so its moments are held on the reference's
own normals: directly (``_block_moments``) and by replacing the port's
``_block_normals`` with the reference's draws (the book routes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optionslab_tpu import parallel as jpar
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu.models.local_vol import LocalVolSurface as JSurface
from optionslab_tpu.models.monte_carlo import MCConfig as JMCConfig
from optionslab_tpu.ops import gbm_pallas as jgp
from optionslab_tpu.ops import local_vol_pallas as jlv
from optionslab_tpu.ops import slv_pallas as jslv
from optionslab_tpu.parallel import sharded_mc as jsm
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch import parallel as tpar
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.models.monte_carlo import MCConfig
from optionslab_tpu_torch.ops import exotic_kernel as ek
from optionslab_tpu_torch.ops import gbm_kernel as gk
from optionslab_tpu_torch.ops import local_vol_kernel as lk
from optionslab_tpu_torch.ops import slv_kernel as sk
from optionslab_tpu_torch.parallel import sharded_mc as tsm
from optionslab_tpu_torch.parallel import sharded_risk as tsr
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


CPU8 = [torch.device("cpu")] * 8
KEY = jax.random.PRNGKey(0)
BS_ATM_CALL = 10.450583572185565
F64 = torch.float64
S, K, T, R = 100.0, 100.0, 1.0, 0.05
PAR, JPAR = HestonParams.make(0.04, 2.0, 0.04, 0.3, -0.7), JHeston.make(0.04, 2.0, 0.04, 0.3, -0.7)


def tmesh(n, book=1):
    return tpar.make_mesh(n, book=book, devices=CPU8)


def jmesh(n, book=1):
    return jpar.make_mesh(n, book=book)


def _fields(n=6):
    """A mixed book: calls and puts, several maturities, a dividend."""
    return {"spot": np.linspace(80.0, 120.0, n), "strike": np.full(n, 100.0),
            "maturity": np.resize([1.0, 0.5, 2.0], n), "rate": np.full(n, 0.05),
            "vol": np.resize([0.2, 0.3], n), "dividend": np.resize([0.0, 0.01, 0.02], n),
            "cp": np.resize([1.0, -1.0], n)}


def _books(n=6, dtype=np.float64):
    f = {k: v.astype(dtype) for k, v in _fields(n).items()}
    return (JBatch(**{k: jnp.asarray(v) for k, v in f.items()}),
            ContractBatch(**{k: torch.tensor(v) for k, v in f.items()}))


def _atm(dtype=F64):
    return ContractBatch.make(S, K, T, R, 0.2, "call", dtype=dtype, device="cpu")


def _f(x):
    return float(np.asarray(x))


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,book", [(8, 1), (8, 2), (8, 4), (4, 2), (1, 1)])
def test_mesh_shape_matches_reference(eight_devices, n, book):
    port, ref = tmesh(n, book), jmesh(n, book)
    assert port.shape == dict(ref.shape)
    assert port.axis_names == tuple(ref.axis_names)
    assert port.size == n


def test_mesh_errors(eight_devices, monkeypatch):
    with pytest.raises(ValueError):
        jmesh(6, 4)
    with pytest.raises(ValueError):
        tmesh(6, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()


def test_shard_and_unshard():
    mesh = tmesh(8, book=2)
    x = torch.arange(12.0)
    pieces = tpar.shard(x, tpar.path_sharding(mesh))
    assert [p.tolist() for p in pieces] == [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0], [6.0, 7.0, 8.0],
                                            [9.0, 10.0, 11.0]]
    assert torch.equal(tpar.unshard(pieces), x)
    assert len(tpar.shard(x, tpar.book_sharding(mesh))) == 2
    assert len(tpar.shard(x, tpar.replicated(mesh))) == 8
    with pytest.raises(ValueError):
        tpar.shard(torch.arange(10.0), tpar.path_sharding(mesh))


# ---------------------------------------------------------------------------
# The tensor engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_steps,antithetic", [(1, True), (3, True), (2, False)])
def test_block_moments_on_reference_normals(n_steps, antithetic):
    """The port's block moments from the reference's own normals (fold_in of
    the block id) against ``_block_moments``, float64: rtol 1e-12 of each
    moment's largest contract (the gamma weights cancel inside a sum)."""
    jb, tb = _books()
    jcfg = JMCConfig(n_paths=8000, n_steps=n_steps, antithetic=antithetic, dtype=jnp.float64)
    tcfg = MCConfig(n_paths=8000, n_steps=n_steps, antithetic=antithetic, dtype=F64)
    half = tsm.PATH_BLOCK // 2 if antithetic else tsm.PATH_BLOCK
    for g in (0, 5):
        z = jax.random.normal(jax.random.fold_in(KEY, g), (half, n_steps), dtype=jnp.float64)
        ref = jsm._block_moments(jb, KEY, g, jcfg)
        port = tsm._block_moments(tb, torch.tensor(np.asarray(z)), tcfg)
        for r, p in zip(ref, port):
            r = np.asarray(r)
            np.testing.assert_allclose(p.numpy(), r, rtol=0, atol=1e-12 * np.abs(r).max())
        # the same block among others of a chunk: the moments do not depend on the chunk
        zz = torch.from_numpy(np.stack([np.asarray(z)] * 3))
        for one, many in zip(port, tsm._block_moments(tb, zz, tcfg)):
            assert torch.equal(many[:, 1], one)
    moms = [np.asarray(m) for m in ref]
    for r, p in zip(jsm._combine(jb, [jnp.asarray(m) for m in moms], jcfg),
                    tsm._combine(tb, [torch.tensor(m) for m in moms], tcfg)):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_sharded_mc_price_bit_identical_on_any_mesh(dtype):
    """Fixed global blocks, fixed op shapes and one reduction order: the
    same (seed, n_paths) gives the same bits on 1, 2, 4 and 8 shards."""
    cfg = MCConfig(n_paths=16_000, dtype=dtype)
    res = [tsm.sharded_mc_price(_atm(dtype), 3, cfg, tmesh(n)) for n in (1, 2, 4, 8)]
    for r in res[1:]:
        assert torch.equal(r.price, res[0].price)
        assert torch.equal(r.std_error, res[0].std_error)
    assert res[0].n_paths == 16_000
    assert abs(float(res[0].price) - BS_ATM_CALL) < 4 * float(res[0].std_error)


def test_sharded_mc_price_accuracy():
    """8 shards at 160,000 paths: within 3 stderr of Black–Scholes (the
    reference test's bound)."""
    res = tpar.sharded_mc_price(_atm(), 0, MCConfig(n_paths=160_000, dtype=F64), tmesh(8))
    assert abs(float(res.price) - BS_ATM_CALL) < 3 * float(res.std_error)


def test_invalid_path_split_raises():
    cfg = MCConfig(n_paths=1004, dtype=F64)
    with pytest.raises(ValueError):
        tpar.sharded_mc_price(_atm(), 0, cfg, tmesh(8))
    with pytest.raises(ValueError):
        jpar.sharded_mc_price(JBatch.make(S, K, T, R, 0.2, "call", dtype=jnp.float64), KEY,
                              JMCConfig(n_paths=1004, dtype=jnp.float64), jmesh(8))


@pytest.fixture
def reference_normals(monkeypatch):
    """The port's engine on the reference's draws: block g's normals are
    ``jax.random.normal(fold_in(PRNGKey(seed), g))``."""
    monkeypatch.setattr(tsm, "CHUNK_BLOCKS", 4)

    def normals(seed, blocks, n_steps, antithetic, dtype, device):
        half = tsm.PATH_BLOCK // 2 if antithetic else tsm.PATH_BLOCK
        key = jax.random.PRNGKey(seed)
        z = [np.asarray(jax.random.normal(jax.random.fold_in(key, int(g)), (half, n_steps),
                                          dtype=jnp.float64)) for g in blocks]
        return torch.tensor(np.stack(z), dtype=dtype, device=device)

    monkeypatch.setattr(tsm, "_block_normals", normals)


def _reference_ladder(jb, cfg, n_blocks):
    """The reference's book Greeks on one device: ``jax.grad`` of its own
    ``_block_moments`` and ``_combine`` over the global blocks — what its
    ``sharded_book_greeks`` differentiates, without the ``shard_map`` (whose
    gradient takes ≈24 s to compile here)."""
    def total(b):
        moms = jax.lax.map(lambda g: jsm._block_moments(b, KEY, g, cfg), jnp.arange(n_blocks))
        price, se, gamma = jsm._combine(b, [m.sum(0) for m in moms], cfg)
        return price.sum(), (price, se, gamma)

    g, (price, se, gamma) = jax.jit(jax.grad(total, has_aux=True))(jb)
    return {"price": price, "std_error": se, "delta": g.spot, "gamma": gamma, "vega": g.vol,
            "rho": g.rate, "theta": -g.maturity, "dual_delta": g.strike,
            "dividend_rho": g.dividend}


def test_book_price_and_greeks_on_reference_normals(eight_devices, reference_normals):
    """``sharded_book_price`` on a 2 x 4 mesh (a 6-contract book padded to
    the book axis) against the reference's on the same normals, float64:
    prices rtol 1e-12, stderr 1e-10; ``sharded_book_greeks`` against the
    reference's engine under ``jax.grad``: 1e-9 of each Greek's largest
    contract."""
    jb, tb = _books()
    jcfg = JMCConfig(n_paths=8000, n_steps=2, dtype=jnp.float64)
    tcfg = MCConfig(n_paths=8000, n_steps=2, dtype=F64)
    ref = jpar.sharded_book_price(jb, KEY, jcfg, jmesh(8, 2), return_result=True)
    port = tpar.sharded_book_price(tb, 0, tcfg, tmesh(8, 2), return_result=True)
    np.testing.assert_allclose(port.price.numpy(), np.asarray(ref.price), rtol=1e-12)
    np.testing.assert_allclose(port.std_error.numpy(), np.asarray(ref.std_error), rtol=1e-10)
    assert port.n_paths == int(ref.n_paths)
    jg = _reference_ladder(jb, jcfg, 8)
    tg = tpar.sharded_book_greeks(tb, 0, tcfg, tmesh(8, 2))
    assert set(tg) == set(jg)
    for k, v in jg.items():
        v = np.asarray(v)
        np.testing.assert_allclose(tg[k].numpy(), v, rtol=0, atol=1e-9 * np.abs(v).max(),
                                   err_msg=k)


def test_book_topology_invariance():
    """Book axes of 2 and 4 over the same path axis: the same bits."""
    _jb, tb = _books()
    cfg = MCConfig(n_paths=8000, dtype=F64)
    p2 = tpar.sharded_book_price(tb, 0, cfg, tmesh(8, 2))
    p4 = tpar.sharded_book_price(tb, 0, cfg, tmesh(8, 4))
    assert p2.shape == (6,) and torch.equal(p2, p4)
    with pytest.raises(ValueError):
        tpar.sharded_book_price(ContractBatch.make(torch.full((2, 3), 100.0), K, T, R, 0.2),
                                0, cfg, tmesh(8, 2))


# ---------------------------------------------------------------------------
# The kernel routes
# ---------------------------------------------------------------------------
@pytest.fixture
def tiny_tiles(monkeypatch):
    """Both packages' GBM kernel tiles cut from 256 rows to 8, as the
    reference's sharded tests run (the same geometry on both sides)."""
    monkeypatch.setattr(jgp, "TARGET_ROWS", 8)
    monkeypatch.setattr(gk, "TARGET_ROWS", 8)


def test_sharded_gbm_against_reference(eight_devices, tiny_tiles):
    """``sharded_pallas_greeks`` with ``hash`` on 8 shards against the
    reference's on its 8 devices: price rtol 2e-5, delta 2e-4, vega 2e-3;
    and on one shard equal to the unsharded kernel route bit for bit."""
    jb = JBatch.make(S, K, T, R, 0.2, "call")
    tb = ContractBatch.make(S, K, T, R, 0.2, "call", device="cpu")
    ref = jpar.sharded_pallas_greeks(jb, jmesh(8), n_paths=500_000, seed=0, sampler="hash")
    port = tpar.sharded_pallas_greeks(tb, tmesh(8), n_paths=500_000, seed=0, sampler="hash")
    assert port["n_paths"] == int(ref["n_paths"]) == 8 * 65_536
    for k, rtol in (("price", 2e-5), ("delta", 2e-4), ("vega", 2e-3)):
        np.testing.assert_allclose(float(port[k]), _f(ref[k]), rtol=rtol, err_msg=k)
    one = tpar.sharded_pallas_greeks(tb, tmesh(1), n_paths=port["n_paths"], seed=0,
                                     sampler="hash")
    flat = gk.gbm_mc_price_greeks(tb, n_paths=port["n_paths"], seed=0, sampler="hash")
    for k, v in flat.items():
        assert torch.equal(one[k], v), k
    for k, rtol in (("price", 2e-5), ("delta", 2e-4), ("vega", 2e-3)):
        np.testing.assert_allclose(float(port[k]), float(flat[k]), rtol=rtol, err_msg=k)


def test_sharded_gbm_book_on_a_2d_mesh(tiny_tiles):
    """A 3-contract put book on a (book 2, paths 4) mesh: the same path set
    as 8 shards of one axis, within the association tolerances."""
    tb = ContractBatch.make(torch.tensor([90.0, 100.0, 110.0]), K, 0.5, 0.03, 0.25, "put",
                            device="cpu")
    a = tpar.sharded_pallas_greeks(tb, tmesh(8, 2), n_paths=400_000, sampler="hash")
    b = tpar.sharded_pallas_greeks(tb, tmesh(8), n_paths=400_000, sampler="hash")
    assert a["n_paths"] == b["n_paths"]
    np.testing.assert_allclose(a["price"].numpy(), b["price"].numpy(), rtol=2e-5)
    np.testing.assert_allclose(a["delta"].numpy(), b["delta"].numpy(), rtol=2e-4)


def test_sharded_exotic_against_reference(eight_devices):
    """Asian price and the pathwise Greeks on 4 shards, ``hash``, 4 steps:
    price rtol 2e-5, stderr 1e-4, the Greeks 3e-5; one shard equals the
    unsharded route."""
    args = ("asian_arith", S, K, T, R, 0.2)
    p_t, se_t, n_t = tpar.sharded_exotic_price(*args, tmesh(4), n_paths=1, n_steps=4,
                                               sampler="hash")
    p_j, se_j, n_j = jpar.sharded_exotic_price(*args, jmesh(4), n_paths=1, n_steps=4,
                                               sampler="hash")
    assert n_t == n_j == 4 * ek.PATHS_PER_BLOCK
    np.testing.assert_allclose(float(p_t), _f(p_j), rtol=2e-5)
    np.testing.assert_allclose(float(se_t), _f(se_j), rtol=1e-4)
    g_t = tpar.sharded_exotic_greeks("lookback_float", S, 0.0, T, R, 0.2, tmesh(4), n_paths=1,
                                     n_steps=4, sampler="hash")
    g_j = jpar.sharded_exotic_greeks("lookback_float", S, 0.0, T, R, 0.2, jmesh(4), n_paths=1,
                                     n_steps=4, sampler="hash")
    assert g_t["paths"] == g_j["paths"]
    for k in ("price", "delta", "vega", "rho", "theta"):
        np.testing.assert_allclose(float(g_t[k]), _f(g_j[k]), rtol=3e-5, err_msg=k)
    one = tpar.sharded_exotic_price(*args, tmesh(1), n_paths=n_t, n_steps=4, sampler="hash")
    flat = ek.exotic_price(*args, n_paths=n_t, n_steps=4, sampler="hash", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(one[:2], flat[:2])) and one[2] == flat[2]


def test_sharded_exotic_hit_kinds_match_unsharded():
    """Pay-at-hit one-touches are discounted in the kernel: the sharded
    route keeps host df = 1, as the unsharded one does (the reference's
    sharded route discounts them a second time)."""
    kw = dict(barrier=115.0, n_paths=1, n_steps=4, sampler="hash")
    p_s, _se, n_s = tpar.sharded_exotic_price("one_touch_up_hit", S, K, T, R, 0.2, tmesh(2),
                                              **kw)
    p_u, _se_u, _n = ek.exotic_price("one_touch_up_hit", S, K, T, R, 0.2, device="cpu",
                                     **{**kw, "n_paths": n_s})
    np.testing.assert_allclose(float(p_s), float(p_u), rtol=2e-5)


def test_sharded_exotic_refusals(eight_devices):
    mesh = tmesh(2)
    for call in (lambda: tpar.sharded_exotic_price("cliquet", S, 0.0, T, R, 0.2, mesh),
                 lambda: tpar.sharded_exotic_price("nope", S, 0.0, T, R, 0.2, mesh),
                 lambda: tpar.sharded_exotic_price("asian_arith_cv", S, K, T, R, 0.2, mesh),
                 lambda: tpar.sharded_exotic_price("barrier_double-out", S, K, T, R, 0.2, mesh,
                                                   lower=130.0, upper=80.0),
                 lambda: tpar.sharded_exotic_greeks("barrier_up-and-out", S, K, T, R, 0.2,
                                                    mesh),
                 lambda: tpar.sharded_exotic_greeks("asian_arith", S, K, T, R, 0.2, mesh,
                                                    sampler="sobol_bb")):
        with pytest.raises(ValidationError):
            call()


MA = dict(spots=[100.0, 95.0, 105.0], strike=K, maturity=T, rate=R, vols=[0.2, 0.25, 0.3],
          corr=[[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]])
MA_W = [0.4, 0.3, 0.3]


def test_sharded_multi_asset_against_reference(eight_devices):
    """The basket with and without the geometric control variate (rtol 3e-5)
    and its LR ladder at 2 steps (price/theta/rho 5e-5, the per-asset
    vectors and the gamma matrix 5e-4) on 4 shards, ``hash``."""
    args = tuple(MA.values())
    for cv in (False, True):
        p_t, _se, n_t = tpar.sharded_multi_asset_price("basket", *args, tmesh(4), weights=MA_W,
                                                       n_paths=1, sampler="hash",
                                                       control_variate=cv)
        p_j, _se_j, n_j = jpar.sharded_multi_asset_price("basket", *args, jmesh(4),
                                                         weights=MA_W, n_paths=1,
                                                         sampler="hash", control_variate=cv)
        assert n_t == n_j
        np.testing.assert_allclose(float(p_t), _f(p_j), rtol=3e-5, err_msg=f"cv={cv}")
    g_t = tpar.sharded_multi_asset_greeks("basket", *args, tmesh(4), weights=MA_W, n_paths=1,
                                          n_steps=2, sampler="hash")
    g_j = jpar.sharded_multi_asset_greeks("basket", *args, jmesh(4), weights=MA_W, n_paths=1,
                                          n_steps=2, sampler="hash")
    assert g_t["paths"] == g_j["paths"]
    for k in ("price", "theta", "rho"):
        np.testing.assert_allclose(float(g_t[k]), _f(g_j[k]), rtol=5e-5, err_msg=k)
    for k in ("delta", "vega", "gamma"):
        np.testing.assert_allclose(np.asarray(g_t[k]), np.asarray(g_j[k]), rtol=5e-4,
                                   err_msg=k)
    mesh = tmesh(2)
    for call in (lambda: tpar.sharded_multi_asset_price("rainbow_best", *args, mesh,
                                                        control_variate=True),
                 lambda: tpar.sharded_multi_asset_price("nope", *args, mesh),
                 lambda: tpar.sharded_multi_asset_greeks("basket_cv", *args, mesh),
                 lambda: tpar.sharded_multi_asset_price("spread", *args, mesh)):
        with pytest.raises(ValidationError):
            call()


def test_sharded_heston_against_reference(eight_devices):
    """Euler price/delta/rho/v0-vega (rtol 3e-5) and the QE price (3e-5) on
    4 shards, ``hash``, the reference's step counts; the QE ladder on 2
    shards, its price and delta 3e-4 and the finite-difference entries
    within 0.1 (the reference's bounds)."""
    base = (S, K, T, R)
    e_t = tpar.sharded_heston_greeks(*base, PAR, tmesh(4), n_paths=1, n_steps=5, sampler="hash")
    e_j = jpar.sharded_heston_greeks(*base, JPAR, jmesh(4), n_paths=1, n_steps=5,
                                     sampler="hash")
    assert e_t["paths"] == e_j["paths"]
    for k in ("price", "delta", "rho", "vega_v0"):
        np.testing.assert_allclose(float(e_t[k]), _f(e_j[k]), rtol=3e-5, err_msg=k)
    q_t = tpar.sharded_heston_greeks(*base, PAR, tmesh(4), n_paths=1, n_steps=4, sampler="hash",
                                     vega=False, scheme="qe")
    q_j = jpar.sharded_heston_greeks(*base, JPAR, jmesh(4), n_paths=1, n_steps=4,
                                     sampler="hash", vega=False, scheme="qe")
    np.testing.assert_allclose(float(q_t["price"]), _f(q_j["price"]), rtol=3e-5)
    l_t = tpar.sharded_heston_greeks(*base, PAR, tmesh(2), n_paths=1, n_steps=4, sampler="hash",
                                     scheme="qe", ladder=True)
    l_j = jpar.sharded_heston_greeks(*base, JPAR, jmesh(2), n_paths=1, n_steps=4,
                                     sampler="hash", scheme="qe", ladder=True)
    for k in ("price", "delta"):
        np.testing.assert_allclose(float(l_t[k]), _f(l_j[k]), rtol=3e-4, err_msg=k)
    for k in ("d_theta", "d_sigma", "theta"):
        assert abs(float(l_t[k]) - _f(l_j[k])) < 0.1, k
    with pytest.raises(ValidationError):
        tpar.sharded_heston_greeks(*base, PAR, tmesh(2), scheme="qe")


def test_sharded_heston_ladder_against_reference(eight_devices):
    """The Euler ladder's 9 moment tiles on 2 shards: price, delta, rho and
    v0-vega rtol 2e-4 (the reference's bound); the κ/θ/σ/ρ sensitivities and
    theta to 1e-2 of max(|value|, price), the port's parity bound for them
    (``test_torch_heston_kernel.py``: the recursion's 1/(2√v⁺) turns an ulp
    of libm in a lane that grazes v = 0 into a fraction of that lane)."""
    l_t = tpar.sharded_heston_greeks(S, K, T, R, PAR, tmesh(2), n_paths=1, n_steps=4,
                                     sampler="hash", ladder=True)
    l_j = jpar.sharded_heston_greeks(S, K, T, R, JPAR, jmesh(2), n_paths=1, n_steps=4,
                                     sampler="hash", ladder=True)
    for k in ("price", "delta", "rho", "vega_v0"):
        np.testing.assert_allclose(float(l_t[k]), _f(l_j[k]), rtol=2e-4, err_msg=k)
    price = _f(l_j["price"])
    for k in ("d_kappa", "d_theta", "d_sigma", "d_rho", "theta"):
        assert abs(float(l_t[k]) - _f(l_j[k])) <= 1e-2 * max(abs(_f(l_j[k])), price), k


def test_sharded_heston_exotic_against_reference(eight_devices):
    """The Asian price (rtol 2e-5, stderr 1e-4) and the barrier LR ladder
    (5e-5, atol 1e-7) on 4 shards, ``hash``, 4 steps; the structured and
    QMC refusals."""
    args = ("asian_arith", S, K, T, R)
    p_t, se_t, n_t = tpar.sharded_heston_exotic_price(*args, PAR, tmesh(4), n_paths=1,
                                                      n_steps=4, sampler="hash")
    p_j, se_j, n_j = jpar.sharded_heston_exotic_price(*args, JPAR, jmesh(4), n_paths=1,
                                                      n_steps=4, sampler="hash")
    assert n_t == n_j
    np.testing.assert_allclose(float(p_t), _f(p_j), rtol=2e-5)
    np.testing.assert_allclose(float(se_t), _f(se_j), rtol=1e-4)
    kw = dict(barrier=130.0, n_paths=1, n_steps=4, sampler="hash")
    g_t = tpar.sharded_heston_exotic_greeks("barrier_up-and-out", S, K, T, R, PAR, tmesh(4),
                                            **kw)
    g_j = jpar.sharded_heston_exotic_greeks("barrier_up-and-out", S, K, T, R, JPAR, jmesh(4),
                                            **kw)
    assert g_t["paths"] == g_j["paths"]
    for k in ("price", "delta", "gamma", "vega_v0", "rho"):
        np.testing.assert_allclose(float(g_t[k]), _f(g_j[k]), rtol=5e-5, atol=1e-7, err_msg=k)
    mesh = tmesh(2)
    for call in (lambda: tpar.sharded_heston_exotic_price("cliquet", S, 0.0, T, R, PAR, mesh),
                 lambda: tpar.sharded_heston_exotic_price("range_accrual", S, 0.0, T, R, PAR,
                                                          mesh),
                 lambda: tpar.sharded_heston_exotic_greeks("asian_arith", S, K, T, R, PAR,
                                                           mesh, sampler="sobol_bb")):
        with pytest.raises(ValidationError):
            call()


@pytest.fixture(scope="module")
def jflat():
    """The reference tests' flat 20% surface."""
    return JSurface(jnp.linspace(-3.0, 3.0, 11), jnp.linspace(0.01, 2.0, 9),
                    jnp.full((9, 11), 0.2), S, R)


def test_sharded_local_vol_against_reference(eight_devices, jflat):
    """A flat-surface pricer at 4 steps (the reference's), the port's built
    on the reference's fitted table: the price (rtol 3e-5) and the LR ladder
    (5e-4) on 4 shards, ``hash``."""
    jp = jlv.LocalVolKernelPricer(type("Flat", (), {"surface": jflat, "spot": S, "rate": R,
                                                    "dividend": 0.0})(), T, n_steps=4)
    tp = lk.LocalVolKernelPricer.from_numpy(jp.rows, jp.fit_residual, S, R, 0.0, T,
                                            device="cpu")
    p_t, _se, n_t = tpar.sharded_local_vol_price(tp, K, tmesh(4), n_paths=1, sampler="hash")
    p_j, _se_j, n_j = jpar.sharded_local_vol_price(jp, K, jmesh(4), n_paths=1, sampler="hash")
    assert n_t == n_j
    np.testing.assert_allclose(float(p_t), _f(p_j), rtol=3e-5)
    g_t = tpar.sharded_local_vol_greeks(tp, K, tmesh(4), n_paths=1, sampler="hash")
    g_j = jpar.sharded_local_vol_greeks(jp, K, jmesh(4), n_paths=1, sampler="hash")
    for k in ("price", "delta", "gamma", "vega"):
        np.testing.assert_allclose(float(g_t[k]), _f(g_j[k]), rtol=5e-4, err_msg=k)
    with pytest.raises(ValidationError):
        tpar.sharded_local_vol_price(tp, K, tmesh(2), payoff="nope")


def test_sharded_slv_against_reference(eight_devices, jflat):
    """The SLV replay on the reference's calibrated leverage (4 steps,
    16,384 particles, its test's pricer): the price rtol 2e-5 and the LR
    ladder's price, delta, gamma and v0-vega 5e-5 (atol 1e-7) on 4 shards,
    ``hash``; rho, which carries the rate score, to 1e-2 of the price (an
    ulp of libm moves a grazing lane's score: ``test_torch_slv_kernel.py``);
    the sampler and mixing refusals."""
    jp = jslv.SLVKernelPricer(jflat, JPAR, 1.0, mixing=1.0, n_steps=4, n_cal_paths=16_384)
    tp = sk.SLVKernelPricer.from_numpy(jp.rows, jp.fit_residual, PAR, S, R, 0.0, T, mixing=1.0,
                                       device="cpu")
    p_t, _se, n_t = tpar.sharded_slv_price(tp, "asian_arith", K, tmesh(4), n_paths=1,
                                           sampler="hash")
    p_j, _se_j, n_j = jpar.sharded_slv_price(jp, "asian_arith", K, jmesh(4), n_paths=1,
                                             sampler="hash")
    assert n_t == n_j == 4 * sk.PATHS_PER_BLOCK
    np.testing.assert_allclose(float(p_t), _f(p_j), rtol=2e-5)
    kw = dict(barrier=130.0, n_paths=1, sampler="hash")
    g_t = tpar.sharded_slv_greeks(tp, "barrier_up-and-out", K, tmesh(4), **kw)
    g_j = jpar.sharded_slv_greeks(jp, "barrier_up-and-out", K, jmesh(4), **kw)
    assert g_t["paths"] == g_j["paths"]
    for k in ("price", "delta", "gamma", "vega_v0"):
        np.testing.assert_allclose(float(g_t[k]), _f(g_j[k]), rtol=5e-5, atol=1e-7, err_msg=k)
    assert abs(float(g_t["rho"]) - _f(g_j["rho"])) < 1e-2 * float(g_t["price"])
    with pytest.raises(ValidationError):
        tpar.sharded_slv_price(tp, "asian_arith", K, tmesh(2), sampler="sobol_bb")
    tp0 = sk.SLVKernelPricer.from_numpy(jp.rows, 0.0, PAR, S, R, 0.0, T, mixing=0.0,
                                        device="cpu")
    with pytest.raises(ValidationError):
        tpar.sharded_slv_greeks(tp0, "asian_arith", K, tmesh(2))


# ---------------------------------------------------------------------------
# Sharded risk
# ---------------------------------------------------------------------------
def test_sharded_historical_var_es(eight_devices):
    """Exact against a global sort and the reference's sharded call (1e-6),
    from a tensor and from pieces placed by ``shard``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from optionslab_tpu_torch.risk import historical_es, historical_var

    pnl = np.random.default_rng(3).normal(0.0, 2.0, 80_000).astype(np.float32)
    mesh = tmesh(8)
    var, es = tpar.sharded_historical_var_es(torch.from_numpy(pnl), 0.95, mesh)
    pieces = tpar.shard(torch.from_numpy(pnl), tpar.path_sharding(mesh))
    var2, es2 = tpar.sharded_historical_var_es(pieces, 0.95, mesh)
    assert float(var2) == float(var) and float(es2) == float(es)
    m = tsr._tail_count(0.95, pnl.size)
    srt = np.sort(pnl)
    assert abs(float(var) - (-srt[m - 1])) < 1e-6
    assert abs(float(es) - (-srt[:m].astype(np.float64).mean())) < 1e-5 * abs(float(es))
    jm = jmesh(8)
    sharded = jax.device_put(jnp.asarray(pnl), NamedSharding(jm, P(jpar.PATH_AXIS)))
    var_j, es_j = jpar.sharded_historical_var_es(sharded, 0.95, jm)
    assert abs(float(var) - _f(var_j)) < 1e-6
    assert abs(float(es) - _f(es_j)) < 1e-6 * abs(float(es))
    tpnl = torch.from_numpy(pnl)
    assert abs(float(var) - float(historical_var(tpnl, 0.95))) < 0.05
    assert abs(float(es) - float(historical_es(tpnl, 0.95))) < 0.05


def test_sharded_mc_var():
    """400,000 paths on 8 shards: VaR within 0.5 of the closed form (the
    reference test's bound), ES beyond it; a split that does not divide
    raises."""
    from optionslab_tpu_torch.risk import lognormal_var

    var, es = tpar.sharded_mc_var(100.0, 0.05, 0.2, 0, tmesh(8), 0.95, 1.0, 400_000)
    cf = float(lognormal_var(torch.tensor(100.0, dtype=F64), 0.05, 0.2, 0.95, 1.0))
    assert abs(float(var) - cf) < 0.5
    assert float(es) > float(var)
    with pytest.raises(ValueError):
        tpar.sharded_mc_var(100.0, 0.05, 0.2, 0, tmesh(8), n_paths=1001)


# ---------------------------------------------------------------------------
# The data-parallel PINN step
# ---------------------------------------------------------------------------
def test_pinn_step_against_reference(eight_devices):
    """One data-parallel step on 8 shards from the reference's seed-0
    initial parameters: the loss against the reference's loss function
    (float32, rtol 1e-6) and the parameters after one Adam step against
    ``optax.adam`` on the reference's gradient, within 1e-6 of each leaf's
    scale plus 1e-5 of the learning rate (the port's Adam forms the bias
    corrections 1 − βᵗ in float64, optax in float32, where 1 − 0.999 rounds
    to 9.9998713e-4: the first step moves a weight by lr·(1 ± 6.4e-6)); 8
    shards against one on the same quotes within 1e-6."""
    import optax

    from optionslab_tpu.surface import pinn as jpinn
    from optionslab_tpu.surface.nn_core import flatten_params, init_mlp
    from optionslab_tpu_torch.surface import dryrun_train_step_sharded
    from optionslab_tpu_torch.surface.nn_core import params_from_numpy

    with jax.enable_x64(False):
        jparams = init_mlp(jax.random.PRNGKey(0), [2, 16, 16, 1])
        n = 16 * 8
        k_obs = jnp.linspace(-0.5, 0.5, n, dtype=jnp.float32)
        t_obs = jnp.full((n,), 0.5, jnp.float32)
        w_obs = jnp.full((n,), 0.02, jnp.float32)

        def loss_fn(p):
            kk = jnp.linspace(-0.5, 0.5, 32)
            tt = jnp.full((32,), 0.5)
            return (jnp.mean((jpinn._w_fn(p, k_obs, t_obs) - w_obs) ** 2)
                    + jpinn.calendar_penalty(p, kk, tt) + jpinn.butterfly_penalty(p, kk, tt)
                    + jpinn.wing_penalty(p, kk, tt))

        loss_j, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
        opt = optax.adam(1e-3)
        upd, _ = opt.update(grads, opt.init(jparams))
        after_j = flatten_params(optax.apply_updates(jparams, upd))
        start = params_from_numpy(flatten_params(jparams), "cpu")
    loss_t, after_t = dryrun_train_step_sharded(8, devices=CPU8, params=start)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for i, layer in enumerate(after_t):
        for k, v in layer.items():
            ref = np.asarray(after_j[f"layer{i}_{k}"])
            np.testing.assert_allclose(v.numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max() + 1e-5 * 1e-3, err_msg=k)
    loss_1, after_1 = dryrun_train_step_sharded(1, devices=CPU8, params=start, n_quotes=n)
    assert abs(float(loss_1) - float(loss_t)) <= 1e-6 * float(loss_t)
    for a, b in zip(after_1, after_t):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)
