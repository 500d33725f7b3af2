"""Plain-tensor twins of the in-kernel samplers of ``csrc/rng.cuh``.

The CUDA kernel draws its uniforms with 32-bit unsigned integer arithmetic.
These functions compute the same bits with torch integer ops, so the plain
version of each kernel (and the tests) reproduce the kernel's path set:

* :func:`fmix32` and :func:`hash_uniform` — the counter-based murmur3 stream
  of ``optionslab_tpu.ops.kernel_rng`` (int32 that wraps, with the logical
  shifts written as arithmetic shift plus mask, bit for bit as there);
* :func:`sobol_pair` — the scrambled 2-D Sobol points of
  ``optionslab_tpu.ops.gbm_pallas._sobol_pair`` (30-bit direction numbers);
* :func:`philox4x32_10` — Random123's Philox4x32-10 on uint32 values held
  in int64 tensors. It stands in for the TPU's hardware generator, which has
  no counterpart on the card.
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586
INV_2_24 = 1.0 / (1 << 24)
INV_2_25 = 1.0 / (1 << 25)

_QMC_BITS = 30
_INV_2_30 = 1.0 / (1 << _QMC_BITS)
# 30-bit direction numbers for the first two Sobol dimensions (dim 1 = van
# der Corput; dim 2: s=1, a=0, m=[1] with v_k = v_{k-1} ^ (v_{k-1} >> 1)).
V1 = tuple(1 << (_QMC_BITS - 1 - k) for k in range(_QMC_BITS))
_v2 = [1 << (_QMC_BITS - 1)]
for _k in range(1, _QMC_BITS):
    _v2.append(_v2[-1] ^ (_v2[-1] >> 1))
V2 = tuple(_v2)

GOLDEN = -1640531535  # 0x9E3779B1 as int32 (Knuth's multiplicative hash)
HASH_SALT = 0x632BE5AB
GROUP_SALT = 0x3C6EF372

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_BLOCK_SALT = 0x9E3779B9
_U32 = 0xFFFFFFFF


def wrap32(x: int) -> int:
    """A Python int reduced to the int32 it wraps to."""
    return ((int(x) + (1 << 31)) & _U32) - (1 << 31)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int32 (logical shifts as arithmetic shift + mask)."""
    h = h ^ ((h >> 16) & 0x0000FFFF)
    h = h * -2048144789  # 0x85ebca6b
    h = h ^ ((h >> 13) & 0x0007FFFF)
    h = h * -1028477387  # 0xc2b2ae35
    h = h ^ ((h >> 16) & 0x0000FFFF)
    return h


def _bits24_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """24 random bits → float32 uniform strictly inside (0, 1)."""
    return bits.to(torch.float32) * INV_2_24 + INV_2_25


def hash_uniform(counter: torch.Tensor, seed) -> torch.Tensor:
    """Counter-based uniform in (0,1): double murmur3 mix, 24 mantissa bits.

    ``counter`` is an int32 tensor, ``seed`` a Python int.
    """
    h = fmix32(counter ^ wrap32(int(seed) * GOLDEN))
    h = fmix32(h + HASH_SALT)
    return _bits24_to_uniform((h >> 8) & 0x00FFFFFF)


def sobol_pair(idx: torch.Tensor, scramble1, scramble2):
    """2-D scrambled-Sobol uniforms for int32 point indices ``idx``: Gray-code
    XOR of the direction numbers, then a seed-derived digital shift."""
    gray = idx ^ (idx >> 1)
    x1 = torch.zeros_like(idx)
    x2 = torch.zeros_like(idx)
    for k in range(_QMC_BITS):
        bit = (gray >> k) & 1
        x1 = x1 ^ (bit * V1[k])
        x2 = x2 ^ (bit * V2[k])
    x1 = x1 ^ scramble1
    x2 = x2 ^ scramble2
    u1 = x1.to(torch.float32) * _INV_2_30 + 0.5 * _INV_2_30
    u2 = x2.to(torch.float32) * _INV_2_30 + 0.5 * _INV_2_30
    return u1, u2


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of the 64-bit product of uint32 ``a`` (in
    int64) and the constant ``m``, split into 16-bit halves so no int64
    product overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    p_hi = a_hi * m  # < 2**48
    p_lo = a_lo * m  # < 2**48
    mid = p_hi + (p_lo >> 16)  # the product >> 16, < 2**49
    hi = mid >> 16
    lo = ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) on uint32 values held in int64
    tensors (or Python ints); returns the four output words the same way."""
    c = [torch.as_tensor(x, dtype=torch.int64) & _U32 for x in (c0, c1, c2, c3)]
    k0 = torch.as_tensor(k0, dtype=torch.int64) & _U32
    k1 = torch.as_tensor(k1, dtype=torch.int64) & _U32
    for _ in range(10):
        hi0, lo0 = _mulhilo(c[0], _PHILOX_M0)
        hi1, lo1 = _mulhilo(c[2], _PHILOX_M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _PHILOX_W0) & _U32
        k1 = (k1 + _PHILOX_W1) & _U32
    return c


def philox_uniform_pair(row: torch.Tensor, col: torch.Tensor, seed: int, block: torch.Tensor):
    """(u1, u2) of the kernel's ``prng`` sampler: Philox keyed by
    ``(seed, PHILOX_BLOCK_SALT ^ block)`` at counter ``(row, col, 0, 0)``,
    24 bits per uniform from output words 0 and 1."""
    key1 = (block.to(torch.int64) & _U32) ^ PHILOX_BLOCK_SALT
    x = philox4x32_10(row, col, 0, 0, int(seed) & _U32, key1)
    return _bits24_to_uniform(x[0] >> 8), _bits24_to_uniform(x[1] >> 8)
