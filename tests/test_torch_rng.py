"""The port's quasi-random sequences (``ops/rng.py``) and the exotic kernels'
sampler twins (``ops/kernel_rng.py``: ``draw_normals``, ``sobol_nd``,
``bridge_plan``) against the JAX package, and the CUDA direction table
against the port's own."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.ops import exotic_pallas as ep
from optionslab_tpu.ops import kernel_rng as jkr
from optionslab_tpu.ops import rng as jrng
from optionslab_tpu_torch.ops import kernel_rng as tkr
from optionslab_tpu_torch.ops import rng as trng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG_CUH = Path(__file__).resolve().parent.parent / "optionslab_tpu_torch" / "csrc" / "rng.cuh"


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def test_direction_matrix_bitwise():
    ours, ref = trng._direction_matrix(), jrng._direction_matrix()
    assert ours.dtype == ref.dtype == np.uint32
    assert ours.shape == ref.shape == (trng.MAX_SOBOL_DIM, 30)
    np.testing.assert_array_equal(ours, ref)


def test_cuda_direction_table_is_the_port_table():
    """``kSobolV8`` in ``csrc/rng.cuh`` is ``_direction_matrix()[:8]``."""
    text = RNG_CUH.read_text()
    body = text[text.index("kSobolV8[8][30]"):]
    body = body[:body.index("};")]
    words = [int(w, 16) for w in re.findall(r"0x([0-9A-Fa-f]+)u", body)]
    assert np.array_equal(np.asarray(words, np.uint32).reshape(8, 30),
                          trng._direction_matrix()[:8])
    assert tkr.V8 == ep._V8


@pytest.mark.parametrize("n,dim,skip", [(1000, 1, 0), (4096, 8, 0), (777, 65, 12345)])
def test_sobol_sequence_matches_reference(n, dim, skip):
    ours = trng.sobol_sequence(n, dim, skip=skip).numpy()
    ref = np.asarray(jrng.sobol_sequence(n, dim, skip=skip))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


def test_sobol_scramble_is_a_digital_shift():
    gen = torch.Generator().manual_seed(5)
    plain = trng.sobol_sequence(512, 4, dtype=torch.float64)
    shifted = trng.sobol_sequence(512, 4, generator=gen, dtype=torch.float64)
    to_int = lambda u: (u.double() * (1 << 30) - 0.5).round().long()  # noqa: E731
    xor = to_int(plain) ^ to_int(shifted)
    assert torch.all(xor == xor[0])  # one shift per dimension
    assert torch.all(xor[0] != 0)
    with pytest.raises(ValueError):
        trng.sobol_sequence(4, trng.MAX_SOBOL_DIM + 1)


@pytest.mark.parametrize("dim,skip,dtype", [(3, 0, torch.float32), (20, 1000, torch.float64)])
def test_halton_sequence_matches_reference(dim, skip, dtype):
    ours = trng.halton_sequence(500, dim, skip=skip, dtype=dtype).numpy()
    ref = np.asarray(jrng.halton_sequence(500, dim, skip=skip,
                                          dtype=jnp.float32 if dtype == torch.float32
                                          else jnp.float64))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7 if dtype == torch.float32 else 1e-15)


@pytest.mark.parametrize("engine,dim", [("sobol", 6), ("halton", 6), ("sobol", 80)])
def test_qmc_normals_match_reference(engine, dim):
    ours = trng.qmc_normals(256, dim, engine=engine).numpy()
    ref = np.asarray(jrng.qmc_normals(256, dim, engine=engine))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_antithetic_normals_mirror():
    gen = torch.Generator().manual_seed(0)
    z = trng.antithetic_normals(gen, 10_000)
    assert z.shape == (10_000,) and z.dtype == torch.float32
    assert torch.equal(z[5000:], -z[:5000])
    assert abs(z[:5000].mean().item()) < 0.06 and abs(z[:5000].std().item() - 1.0) < 0.03


# ---------------------------------------------------------------------------
# the exotic kernels' in-kernel samplers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,lanes", [(128, 512), (128, 256)])
@pytest.mark.parametrize("block,step,n_steps,seed", [(0, 0, 8, 3), (5, 63, 64, 11),
                                                     (40_000, 251, 252, -7)])
def test_draw_normals_hash_matches_reference(rows, lanes, block, step, n_steps, seed):
    """The uniforms are bit-equal; after Box–Muller, XLA's and torch's
    float32 log/cos/sin may differ by an ulp or two."""
    z1, z2 = tkr.draw_normals("hash", seed, torch.tensor([[[block]]], dtype=torch.int32), step,
                              n_steps, rows, lanes)
    r1, r2 = jkr.draw_normals("hash", jnp.int32(seed), jnp.int32(block), step, n_steps,
                              (rows, lanes))
    for ours, ref in ((z1[0], r1), (z2[0], r2)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-6, atol=2e-6)


def test_draw_normals_prng_counters():
    """``prng`` is Philox stream 0 at counter (row, col, step, 0), keyed by
    (seed, salt ^ block): steps and blocks give independent draws."""
    block = torch.tensor([[[3]], [[4]]], dtype=torch.int32)
    z1, z2 = tkr.draw_normals("prng", 9, block, 5, 8, 4, 8)
    x = tkr.philox4x32_10(2, 7, 5, 0, 9, 3 ^ tkr.PHILOX_BLOCK_SALT)
    u1 = (int(x[0]) >> 8) * tkr.INV_2_24 + tkr.INV_2_25
    u2 = (int(x[1]) >> 8) * tkr.INV_2_24 + tkr.INV_2_25
    r = np.sqrt(-2.0 * np.log(np.float32(u1)))
    assert z1[0, 2, 7].item() == pytest.approx(r * np.cos(2 * np.pi * u2), rel=1e-5, abs=1e-6)
    assert z2[0, 2, 7].item() == pytest.approx(r * np.sin(2 * np.pi * u2), rel=1e-5, abs=1e-6)
    other_step = tkr.draw_normals("prng", 9, block, 6, 8, 4, 8)[0]
    assert not torch.equal(z1, other_step) and not torch.equal(z1[0], z1[1])
    with pytest.raises(ValueError):
        tkr.draw_normals("sobol", 9, block, 0, 8, 4, 8)


def test_draw_normals_prng_are_normal():
    z1, z2 = tkr.draw_normals("prng", 1, torch.zeros((1, 1, 1), dtype=torch.int32), 0, 1,
                              128, 512)
    z = torch.cat([z1.flatten(), z2.flatten()]).double()
    assert abs(z.mean().item()) < 6 / z.numel() ** 0.5
    assert abs(z.var().item() - 1.0) < 0.02
    assert abs(np.corrcoef(z1.flatten().numpy(), z2.flatten().numpy())[0, 1]) < 0.01


@pytest.mark.parametrize("n_dim", [1, 4, 8])
def test_sobol_nd_bitwise(n_dim):
    rng = np.random.default_rng(n_dim)
    idx = (np.arange(1 << 16, dtype=np.int64) * 37 + 1).astype(np.int32)
    scr = [rng.integers(0, 1 << 30, idx.shape).astype(np.int32) for _ in range(n_dim)]
    ours = tkr.sobol_nd(torch.from_numpy(idx), [torch.from_numpy(s) for s in scr], n_dim)
    ref = ep._sobol_nd(jnp.asarray(idx), [jnp.asarray(s) for s in scr], n_dim)
    assert len(ours) == n_dim
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(_bits(o.numpy()), _bits(r))


@pytest.mark.parametrize("n_steps", [2, 3, 8, 13, 64, 252])
@pytest.mark.parametrize("levels", [2, 8])
def test_bridge_plan_matches_reference(n_steps, levels):
    assert tkr.bridge_plan(n_steps, levels) == ep._bridge_plan(n_steps, levels)
