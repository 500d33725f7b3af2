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
