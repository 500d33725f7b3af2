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
  no counterpart on the card;
* :func:`draw_normals` — the per-step Box–Muller pair of the path kernels
  (``optionslab_tpu.ops.kernel_rng.draw_normals``), for ``hash`` bit for bit
  with the reference's uniforms, and for ``prng`` on Philox;
* :func:`draw_uniform` — the per-step uniform of the Heston QE kernels
  (``optionslab_tpu.ops.kernel_rng.draw_uniform``), on its own hash salt and
  Philox stream;
* :func:`draw_jump` — the per-step compound-Poisson draw of the Bates kernel
  (``optionslab_tpu.ops.kernel_rng.draw_jump``): a count uniform and a size
  normal, on hash salts and a Philox stream of their own;
* :func:`sobol_nd` and :func:`bridge_plan` — the up-to-8-dimensional
  scrambled Sobol points and the Brownian-bridge plan of the exotic kernel's
  ``sobol_bb`` sampler (``optionslab_tpu.ops.exotic_pallas._sobol_nd`` and
  ``_bridge_plan``).

Philox streams of the path kernels. The TPU seeds its generator once per
path block and then draws sequentially; a counter-based generator needs the
step in its counter instead. Every Philox draw is keyed by
``(seed, PHILOX_BLOCK_SALT ^ block)`` and its counter is
``(row, col, step, stream)``:

* stream 0 — the Box–Muller pair of :func:`draw_normals` (and, at step 0,
  the terminal GBM kernel's single pair);
* stream 1 — the uniform of :func:`draw_uniform` (the Heston QE kernels);
* stream 2 — the count uniform and the two size uniforms of
  :func:`draw_jump` (the Bates kernel), output words 0, 1 and 2,

so that no two draws of one lane ever share a counter.
"""

from __future__ import annotations

from collections import deque

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


def philox_uniform_pair(row: torch.Tensor, col: torch.Tensor, seed: int, block: torch.Tensor,
                        step=0):
    """(u1, u2) of the kernels' ``prng`` sampler: Philox keyed by
    ``(seed, PHILOX_BLOCK_SALT ^ block)`` at counter ``(row, col, step, 0)``,
    24 bits per uniform from output words 0 and 1."""
    key1 = (block.to(torch.int64) & _U32) ^ PHILOX_BLOCK_SALT
    x = philox4x32_10(row, col, step, 0, int(seed) & _U32, key1)
    return _bits24_to_uniform(x[0] >> 8), _bits24_to_uniform(x[1] >> 8)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's and CUDA's sqrtf are.

    torch's CPU float32 sqrt is off by an ulp on some inputs; the float64
    root rounded once to float32 is exact (53 >= 2·24 + 2 bits).
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def box_muller(u1: torch.Tensor, u2: torch.Tensor):
    """(r·cos θ, r·sin θ) with r = sqrt(-2 log u1), θ = 2π·u2, in float32."""
    radius = sqrt_rn(-2.0 * torch.log(u1))
    theta = TWO_PI * u2
    return radius * torch.cos(theta), radius * torch.sin(theta)


def draw_normals(sampler: str, seed: int, block: torch.Tensor, step: int, n_steps: int,
                 rows: int, lanes: int):
    """One Box–Muller pair (z_cos, z_sin) per lane for path blocks ``block``
    (int32 of shape (nb, 1, 1)) at time step ``step``: tensors of shape
    (nb, rows, lanes) on ``block``'s device.

    ``hash`` draws the counters of ``optionslab_tpu.ops.kernel_rng``
    (unique per block, step, draw and lane); ``prng`` draws Philox stream 0
    at counter ``(row, col, step, 0)`` (module docstring).
    """
    dev = block.device
    row = torch.arange(rows, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    col = torch.arange(lanes, dtype=torch.int32, device=dev).reshape(1, 1, -1)
    if sampler == "hash":
        lane_id = row * lanes + col
        base = ((block * wrap32(n_steps) + wrap32(step)) * 2) * wrap32(rows * lanes)
        u1 = hash_uniform(base + lane_id, seed)
        u2 = hash_uniform(base + wrap32(rows * lanes) + lane_id, seed)
    elif sampler == "prng":
        u1, u2 = philox_uniform_pair(row, col, seed, block, step)
    else:
        raise ValueError(f"draw_normals: unknown sampler {sampler!r}")
    return box_muller(u1, u2)


UNIFORM_SALT = 0x27220A95  # seed salt of the hash stream of draw_uniform


def philox_uniform(row: torch.Tensor, col: torch.Tensor, seed: int, block: torch.Tensor,
                   step=0):
    """The ``prng`` sampler's uniform of :func:`draw_uniform`: Philox keyed
    by ``(seed, PHILOX_BLOCK_SALT ^ block)`` at counter ``(row, col, step,
    1)`` (stream 1), 24 bits of output word 0."""
    key1 = (block.to(torch.int64) & _U32) ^ PHILOX_BLOCK_SALT
    x = philox4x32_10(row, col, step, 1, int(seed) & _U32, key1)
    return _bits24_to_uniform(x[0] >> 8)


def draw_uniform(sampler: str, seed: int, block: torch.Tensor, step: int, n_steps: int,
                 rows: int, lanes: int) -> torch.Tensor:
    """One (0,1) uniform per lane for path blocks ``block`` (int32 of shape
    (nb, 1, 1)) at time step ``step``, on a stream disjoint from
    :func:`draw_normals`: the Andersen-QE variance transition's uniform.

    ``hash`` draws the counters of ``optionslab_tpu.ops.kernel_rng.
    draw_uniform``, ``(block·n_steps + step)·(rows·lanes) + lane`` (no
    factor 2) with the seed salted by :data:`UNIFORM_SALT`; ``prng`` draws
    Philox stream 1 at counter ``(row, col, step, 1)``.
    """
    dev = block.device
    row = torch.arange(rows, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    col = torch.arange(lanes, dtype=torch.int32, device=dev).reshape(1, 1, -1)
    if sampler == "hash":
        base = (block * wrap32(n_steps) + wrap32(step)) * wrap32(rows * lanes)
        return hash_uniform(base + (row * lanes + col), wrap32(seed) ^ UNIFORM_SALT)
    if sampler == "prng":
        return philox_uniform(row, col, seed, block, step)
    raise ValueError(f"draw_uniform: unknown sampler {sampler!r}")


JUMP_COUNT_SALT = 0x11C98F2D  # seed salt of draw_jump's count uniform (hash)
JUMP_SIZE_SALT = 0x5BD1E995  # seed salt of its two size uniforms (hash)


def draw_jump(sampler: str, seed: int, block: torch.Tensor, step: int, n_steps: int,
              rows: int, lanes: int):
    """``(u_count, z_size)`` per lane for path blocks ``block`` (int32 of
    shape (nb, 1, 1)) at time step ``step``: the uniform that sets the
    step's inverse-CDF jump count and the standard normal of the jump sizes'
    sum, on streams disjoint from :func:`draw_normals` and
    :func:`draw_uniform`.

    ``hash`` draws the counters of ``optionslab_tpu.ops.kernel_rng.
    draw_jump``: ``u`` at ``base + lane`` with the seed salted by
    :data:`JUMP_COUNT_SALT`, ``u1`` at ``base + rows·lanes + lane`` and
    ``u2`` at ``base + lane`` with :data:`JUMP_SIZE_SALT`, ``base =
    ((block·n_steps + step)·2)·rows·lanes``; ``prng`` takes output words 0,
    1 and 2 of one Philox call on stream 2, counter ``(row, col, step, 2)``.
    Then ``z = √(−2 ln u1)·cos(2π u2)``.
    """
    dev = block.device
    row = torch.arange(rows, dtype=torch.int32, device=dev).reshape(1, -1, 1)
    col = torch.arange(lanes, dtype=torch.int32, device=dev).reshape(1, 1, -1)
    if sampler == "hash":
        lane_id = row * lanes + col
        base = ((block * wrap32(n_steps) + wrap32(step)) * 2) * wrap32(rows * lanes)
        u = hash_uniform(base + lane_id, wrap32(seed) ^ JUMP_COUNT_SALT)
        u1 = hash_uniform(base + wrap32(rows * lanes) + lane_id, wrap32(seed) ^ JUMP_SIZE_SALT)
        u2 = hash_uniform(base + lane_id, wrap32(seed) ^ JUMP_SIZE_SALT)
    elif sampler == "prng":
        key1 = (block.to(torch.int64) & _U32) ^ PHILOX_BLOCK_SALT
        x = philox4x32_10(row, col, step, 2, int(seed) & _U32, key1)
        u, u1, u2 = (_bits24_to_uniform(w >> 8) for w in x[:3])
    else:
        raise ValueError(f"draw_jump: unknown sampler {sampler!r}")
    return u, sqrt_rn(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def _sobol_v8() -> tuple:
    from .rng import _direction_matrix

    return tuple(tuple(int(x) for x in row) for row in _direction_matrix()[:8])


V8 = _sobol_v8()  # 30-bit direction numbers of the first 8 Joe–Kuo dimensions


def sobol_nd(idx: torch.Tensor, scrambles, n_dim: int) -> list:
    """``n_dim`` <= 8 scrambled-Sobol uniforms for int32 point indices ``idx``:
    the Gray-code XOR of :data:`V8`, then one digital shift per dimension."""
    gray = idx ^ (idx >> 1)
    xs = [torch.zeros_like(idx) for _ in range(n_dim)]
    for k in range(_QMC_BITS):
        bit = (gray >> k) & 1
        for d in range(n_dim):
            xs[d] = xs[d] ^ (bit * V8[d][k])
    return [(x ^ s).to(torch.float32) * _INV_2_30 + 0.5 * _INV_2_30
            for x, s in zip(xs, scrambles)]


def bridge_plan(n_steps: int, max_levels: int):
    """Dyadic-bisection plan of the bridge coordinates: the sorted segment
    bounds (0 and ``n_steps`` included) and the constructs ``[(mid, lo, hi)]``
    in breadth-first order, at most ``max_levels - 1`` of them."""
    bounds = [0, n_steps]
    constructs = []
    q = deque([(0, n_steps)])
    while len(constructs) < max_levels - 1 and q:
        a, b = q.popleft()
        if b - a < 2:
            continue
        m = (a + b) // 2
        constructs.append((m, a, b))
        bounds.append(m)
        q.append((a, m))
        q.append((m, b))
    return sorted(bounds), constructs
