"""The port's sampler twins bit for bit against the JAX package's in-kernel
samplers, and Philox against Random123's known-answer vectors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from optionslab_tpu.ops import gbm_pallas as gp
from optionslab_tpu.ops import kernel_rng as jrng
from optionslab_tpu_torch.ops import kernel_rng as trng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 1 << 20


def _counters() -> np.ndarray:
    """2^20 int32 counters that run through the int32 wrap (2^31 - 1 → -2^31)."""
    c = np.arange(N, dtype=np.int64) * 4099 + (1 << 31) - (1 << 30)
    return c.astype(np.uint32).view(np.int32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def test_counters_wrap():
    c = _counters()
    assert c.min() < 0 < c.max()


def test_fmix32_bitwise():
    c = _counters()
    ours = trng.fmix32(torch.from_numpy(c)).numpy()
    ref = np.asarray(jrng.fmix32(jnp.asarray(c, jnp.int32)))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))


@pytest.mark.parametrize("seed", [0, 3, -1, -(1 << 31), (1 << 31) - 1, 123456789])
def test_hash_uniform_bitwise(seed):
    c = _counters()
    ours = trng.hash_uniform(torch.from_numpy(c), seed).numpy()
    ref = np.asarray(jrng.hash_uniform(jnp.asarray(c, jnp.int32), jnp.int32(seed)))
    assert ours.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    assert 0.0 < ours.min() and ours.max() < 1.0


def test_sobol_pair_bitwise():
    rng = np.random.default_rng(0)
    idx = (np.arange(N, dtype=np.int64) + 1 + (1 << 24)).astype(np.int32)
    s1 = rng.integers(0, 1 << 30, N).astype(np.int32)
    s2 = rng.integers(0, 1 << 30, N).astype(np.int32)
    ours = trng.sobol_pair(*map(torch.from_numpy, (idx, s1, s2)))
    ref = gp._sobol_pair(*(jnp.asarray(a, jnp.int32) for a in (idx, s1, s2)))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(_bits(o.numpy()), _bits(r))


def test_direction_numbers_match_reference():
    assert trng.V1 == gp._V1 and trng.V2 == gp._V2


@pytest.mark.parametrize("ctr,key,expected", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ctr, key, expected):
    out = trng.philox4x32_10(*ctr, *key)
    assert tuple(int(v) for v in out) == expected


def test_philox_vectorized_matches_scalar():
    rows = torch.arange(8, dtype=torch.int32).reshape(-1, 1)
    cols = torch.arange(16, dtype=torch.int32).reshape(1, -1)
    out = trng.philox4x32_10(rows, cols, 0, 0, 0xDEADBEEF, 5)
    for r, c in [(0, 0), (3, 7), (7, 15)]:
        one = trng.philox4x32_10(r, c, 0, 0, 0xDEADBEEF, 5)
        assert [int(w[r, c]) for w in out] == [int(v) for v in one]


def test_philox_uniforms_are_uniform():
    row = torch.arange(256, dtype=torch.int32).reshape(1, -1, 1)
    col = torch.arange(1024, dtype=torch.int32).reshape(1, 1, -1)
    u1, u2 = trng.philox_uniform_pair(row, col, 11, torch.tensor([[[3]]], dtype=torch.int32))
    for u in (u1, u2):
        assert u.dtype == torch.float32 and 0.0 < u.min() and u.max() < 1.0
        # 262144 draws: mean 1/2 within 6 sigma, variance 1/12 within 1%
        assert abs(u.double().mean().item() - 0.5) < 6 * (1 / 12 / u.numel()) ** 0.5
        assert abs(u.double().var().item() - 1 / 12) < 1e-2 / 12
    assert abs(np.corrcoef(u1.flatten().numpy(), u2.flatten().numpy())[0, 1]) < 0.01


def test_wrap32():
    assert trng.wrap32(1 << 31) == -(1 << 31)
    assert trng.wrap32(3 * -1640531535) == np.int32(np.int64(3 * -1640531535).astype(np.int32))


@pytest.mark.parametrize("seed,block,step,n_steps", [(3, 0, 0, 8), (-7, 3, 5, 8),
                                                     (123456789, 7, 251, 252), (0, 40000, 3, 64)])
def test_draw_jump_hash_bitwise(seed, block, step, n_steps):
    """The Bates jump draw: the count uniform and the size normal's two
    uniforms bit for bit (the counters and salts of the reference); the
    normal itself within 4 ulps, because XLA's and torch's float32 log and
    cos on the CPU differ by an ulp on some inputs (on the card the kernel
    and its plain version share CUDA's libm)."""
    blk = torch.tensor([[[block]]], dtype=torch.int32)
    u, z = trng.draw_jump("hash", seed, blk, step, n_steps, 128, 512)
    ju, jz = jrng.draw_jump("hash", jnp.int32(seed), jnp.int32(block), jnp.int32(step), n_steps,
                            (128, 512))
    assert u.shape == z.shape == (1, 128, 512) and u.dtype == z.dtype == torch.float32
    np.testing.assert_array_equal(_bits(u[0].numpy()), _bits(ju))
    lane = np.arange(128 * 512, dtype=np.int64).reshape(128, 512)
    base = ((block * n_steps + step) * 2) * 128 * 512
    salted = int(np.int32(seed) ^ np.int32(trng.JUMP_SIZE_SALT))
    for off in (128 * 512, 0):  # u1, u2 of the Box–Muller
        ctr = (base + off + lane).astype(np.uint32).view(np.int32)
        np.testing.assert_array_equal(
            _bits(trng.hash_uniform(torch.from_numpy(ctr), salted).numpy()),
            _bits(jrng.hash_uniform(jnp.asarray(ctr), jnp.int32(salted))))
    ulps = np.abs(z[0].numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jz).view(np.int32).astype(np.int64))
    assert np.all(np.sign(z[0].numpy()) == np.sign(np.asarray(jz))) and ulps.max() <= 4


def test_draw_jump_philox_stream_2():
    """``prng``: words 0–2 of one Philox call at counter (row, col, step, 2),
    independent of the normals' stream 0 and the QE uniform's stream 1."""
    block = torch.tensor([[[5]]], dtype=torch.int32)
    u, z = trng.draw_jump("prng", 11, block, 2, 8, 128, 512)
    row = torch.arange(128, dtype=torch.int32).reshape(1, -1, 1)
    col = torch.arange(512, dtype=torch.int32).reshape(1, 1, -1)
    x = trng.philox4x32_10(row, col, 2, 2, 11, 5 ^ trng.PHILOX_BLOCK_SALT)
    assert torch.equal(u, (x[0] >> 8).to(torch.float32) * trng.INV_2_24 + trng.INV_2_25)
    u0, _ = trng.philox_uniform_pair(row, col, 11, block, 2)
    u1 = trng.philox_uniform(row, col, 11, block, 2)
    for other in (u0, u1):
        assert abs(np.corrcoef(u.flatten().numpy(), other.flatten().numpy())[0, 1]) < 0.01
    assert 0.0 < u.min() and u.max() < 1.0
    # 65536 normals: mean 0 and variance 1 within 6 sigma
    assert abs(z.double().mean().item()) < 6 / 256
    assert abs(z.double().var().item() - 1.0) < 6 * (2 / z.numel()) ** 0.5
    with pytest.raises(ValueError, match="sampler"):
        trng.draw_jump("sobol", 0, block, 0, 8, 128, 512)
