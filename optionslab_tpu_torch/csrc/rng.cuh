// In-kernel samplers shared by the port's CUDA kernels.
//
// Every function here has a plain-tensor twin in ops/kernel_rng.py that
// computes the same bits; the tests hold the twins to the JAX package's
// samplers bit for bit. All hash and counter arithmetic is uint32_t: the JAX
// reference uses int32 that wraps, and its "arithmetic shift + mask" is a
// plain logical shift here.
#pragma once

#include <cstdint>

namespace optionslab {

constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv2_24 = 1.0f / 16777216.0f;     // 2^-24
constexpr float kInv2_25 = 1.0f / 33554432.0f;     // 2^-25
constexpr float kInv2_30 = 1.0f / 1073741824.0f;   // 2^-30
constexpr float kHalfInv2_30 = 0.5f / 1073741824.0f;

constexpr uint32_t kGolden = 0x9E3779B1u;     // int32 -1640531535
constexpr uint32_t kHashSalt = 0x632BE5ABu;
constexpr uint32_t kGroupSalt = 0x3C6EF372u;
constexpr uint32_t kPhiloxBlockSalt = 0x9E3779B9u;

// murmur3 32-bit finalizer.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// 24 random bits -> float uniform strictly inside (0, 1).
__device__ __forceinline__ float bits24_to_uniform(uint32_t bits24) {
  return static_cast<float>(bits24) * kInv2_24 + kInv2_25;
}

// Counter-based uniform: double murmur3 mix, 24 mantissa bits.
__device__ __forceinline__ float hash_uniform(uint32_t counter, uint32_t seed) {
  uint32_t h = fmix32(counter ^ (seed * kGolden));
  h = fmix32(h + kHashSalt);
  return bits24_to_uniform(h >> 8);
}

// 2-D scrambled Sobol point `idx`: Gray-code XOR of the 30-bit direction
// numbers, then the digital shifts s1, s2. Dimension 1 (van der Corput) is
// the bit reversal of the Gray code's low 30 bits; dimension 2 has
// v_0 = 2^29, v_k = v_{k-1} ^ (v_{k-1} >> 1).
__device__ __forceinline__ void sobol_pair(uint32_t idx, uint32_t s1, uint32_t s2,
                                           float* u1, float* u2) {
  const uint32_t gray = idx ^ (idx >> 1);
  const uint32_t x1 = __brev(gray) >> 2;
  uint32_t x2 = 0u;
  uint32_t v = 1u << 29;
#pragma unroll
  for (int k = 0; k < 30; ++k) {
    x2 ^= ((gray >> k) & 1u) * v;
    v ^= v >> 1;
  }
  *u1 = static_cast<float>(x1 ^ s1) * kInv2_30 + kHalfInv2_30;
  *u2 = static_cast<float>(x2 ^ s2) * kInv2_30 + kHalfInv2_30;
}

// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Box–Muller: (r·cos θ, r·sin θ), r = sqrt(-2 log u1), θ = 2π·u2. Precise libm
// (the library is built without --use_fast_math), as in the plain versions.
__device__ __forceinline__ void box_muller(float u1, float u2, float* z_cos, float* z_sin) {
  const float radius = sqrtf(-2.0f * logf(u1));
  float sin_t, cos_t;
  sincosf(kTwoPi * u2, &sin_t, &cos_t);
  *z_cos = radius * cos_t;
  *z_sin = radius * sin_t;
}

// The path kernels' per-step normal pair, `hash` sampler: the counters of the
// JAX package's kernel_rng.draw_normals on a (rows, lanes) path block, unique
// per (block, step, draw, lane); uint32 arithmetic wraps as the int32 there.
__device__ __forceinline__ void draw_normals_hash(uint32_t seed, uint32_t block, uint32_t step,
                                                  uint32_t n_steps, uint32_t row, uint32_t col,
                                                  uint32_t rows, uint32_t lanes, float* z1,
                                                  float* z2) {
  const uint32_t tile = rows * lanes;
  const uint32_t base = ((block * n_steps + step) * 2u) * tile;
  const uint32_t lane_id = row * lanes + col;
  box_muller(hash_uniform(base + lane_id, seed), hash_uniform(base + tile + lane_id, seed), z1,
             z2);
}

// The path kernels' per-step normal pair, `prng` sampler: Philox keyed by
// (seed, salt ^ block) at counter (row, col, step, stream 0); stream 1 is the
// Heston QE uniform below, stream 2 the Bates jump draw.
__device__ __forceinline__ void draw_normals_philox(uint32_t seed, uint32_t block, uint32_t step,
                                                    uint32_t row, uint32_t col, float* z1,
                                                    float* z2) {
  const uint4 x = philox4x32_10(make_uint4(row, col, step, 0u),
                                make_uint2(seed, kPhiloxBlockSalt ^ block));
  box_muller(bits24_to_uniform(x.x >> 8), bits24_to_uniform(x.y >> 8), z1, z2);
}

constexpr uint32_t kUniformSalt = 0x27220A95u;

constexpr uint32_t kJumpCountSalt = 0x11C98F2Du;
constexpr uint32_t kJumpSizeSalt = 0x5BD1E995u;

// √(−2 ln u1)·cos(2π u2): the jump draws' normal (cosf, as torch.cos).
__device__ __forceinline__ float jump_normal(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

// The per-step Bates jump draw (count uniform u, size normal z), `hash`
// sampler: the counters of the JAX package's kernel_rng.draw_jump, u at
// base + lane (seed ^ kJumpCountSalt), the normal's uniforms at base + tile +
// lane and base + lane (seed ^ kJumpSizeSalt).
__device__ __forceinline__ void draw_jump_hash(uint32_t seed, uint32_t block, uint32_t step,
                                               uint32_t n_steps, uint32_t row, uint32_t col,
                                               uint32_t rows, uint32_t lanes, float* u, float* z) {
  const uint32_t tile = rows * lanes;
  const uint32_t base = ((block * n_steps + step) * 2u) * tile;
  const uint32_t lane_id = row * lanes + col;
  *u = hash_uniform(base + lane_id, seed ^ kJumpCountSalt);
  *z = jump_normal(hash_uniform(base + tile + lane_id, seed ^ kJumpSizeSalt),
                   hash_uniform(base + lane_id, seed ^ kJumpSizeSalt));
}

// The same draw, `prng` sampler: words 0, 1, 2 of Philox stream 2 at counter
// (row, col, step, 2).
__device__ __forceinline__ void draw_jump_philox(uint32_t seed, uint32_t block, uint32_t step,
                                                 uint32_t row, uint32_t col, float* u, float* z) {
  const uint4 x = philox4x32_10(make_uint4(row, col, step, 2u),
                                make_uint2(seed, kPhiloxBlockSalt ^ block));
  *u = bits24_to_uniform(x.x >> 8);
  *z = jump_normal(bits24_to_uniform(x.y >> 8), bits24_to_uniform(x.z >> 8));
}

// The per-step uniform of the Heston QE kernels, `hash` sampler: the counters
// of the JAX package's kernel_rng.draw_uniform, (block*n_steps + step) *
// (rows*lanes) + lane (no factor 2), with the seed salted by kUniformSalt.
__device__ __forceinline__ float draw_uniform_hash(uint32_t seed, uint32_t block, uint32_t step,
                                                   uint32_t n_steps, uint32_t row, uint32_t col,
                                                   uint32_t rows, uint32_t lanes) {
  const uint32_t base = (block * n_steps + step) * (rows * lanes);
  return hash_uniform(base + row * lanes + col, seed ^ kUniformSalt);
}

// The same uniform, `prng` sampler: Philox stream 1 at counter (row, col, step, 1).
__device__ __forceinline__ float draw_uniform_philox(uint32_t seed, uint32_t block, uint32_t step,
                                                     uint32_t row, uint32_t col) {
  const uint4 x = philox4x32_10(make_uint4(row, col, step, 1u),
                                make_uint2(seed, kPhiloxBlockSalt ^ block));
  return bits24_to_uniform(x.x >> 8);
}

namespace {
// 30-bit direction numbers of the first 8 Sobol dimensions (Joe–Kuo D6; the
// rows of ops/rng.py::_direction_matrix()[:8], checked by the CPU tests).
__constant__ uint32_t kSobolV8[8][30] = {
    {0x20000000u, 0x10000000u, 0x08000000u, 0x04000000u, 0x02000000u, 0x01000000u,
     0x00800000u, 0x00400000u, 0x00200000u, 0x00100000u, 0x00080000u, 0x00040000u,
     0x00020000u, 0x00010000u, 0x00008000u, 0x00004000u, 0x00002000u, 0x00001000u,
     0x00000800u, 0x00000400u, 0x00000200u, 0x00000100u, 0x00000080u, 0x00000040u,
     0x00000020u, 0x00000010u, 0x00000008u, 0x00000004u, 0x00000002u, 0x00000001u},
    {0x20000000u, 0x30000000u, 0x28000000u, 0x3C000000u, 0x22000000u, 0x33000000u,
     0x2A800000u, 0x3FC00000u, 0x20200000u, 0x30300000u, 0x28280000u, 0x3C3C0000u,
     0x22220000u, 0x33330000u, 0x2AAA8000u, 0x3FFFC000u, 0x20002000u, 0x30003000u,
     0x28002800u, 0x3C003C00u, 0x22002200u, 0x33003300u, 0x2A802A80u, 0x3FC03FC0u,
     0x20202020u, 0x30303030u, 0x28282828u, 0x3C3C3C3Cu, 0x22222222u, 0x33333333u},
    {0x20000000u, 0x30000000u, 0x18000000u, 0x24000000u, 0x3A000000u, 0x17000000u,
     0x23800000u, 0x31400000u, 0x1A200000u, 0x27300000u, 0x3B980000u, 0x15640000u,
     0x201A0000u, 0x30270000u, 0x183B8000u, 0x24154000u, 0x3A202000u, 0x17303000u,
     0x23981800u, 0x31642400u, 0x1A1A3A00u, 0x27271700u, 0x3BBBA380u, 0x15557140u,
     0x20003A20u, 0x30001730u, 0x18002398u, 0x24003164u, 0x3A001A1Au, 0x17002727u},
    {0x20000000u, 0x30000000u, 0x08000000u, 0x14000000u, 0x3E000000u, 0x1D000000u,
     0x28800000u, 0x24C00000u, 0x36200000u, 0x09500000u, 0x16780000u, 0x39B40000u,
     0x1E020000u, 0x2D030000u, 0x20808000u, 0x30C14000u, 0x0823E000u, 0x1451D000u,
     0x3EFA8800u, 0x1D764C00u, 0x28216200u, 0x24539500u, 0x36F9E780u, 0x0976DB40u,
     0x16200020u, 0x39500030u, 0x1E780008u, 0x2DB40014u, 0x2002003Eu, 0x3003001Du},
    {0x20000000u, 0x10000000u, 0x08000000u, 0x2C000000u, 0x3E000000u, 0x37000000u,
     0x1E800000u, 0x27400000u, 0x16A00000u, 0x0BF00000u, 0x28580000u, 0x3C2C0000u,
     0x36A20000u, 0x1BF10000u, 0x20588000u, 0x102EC000u, 0x08A1E000u, 0x2CF27000u,
     0x3ED96800u, 0x376CB400u, 0x1E008A00u, 0x2702CF00u, 0x1683ED80u, 0x0B4376C0u,
     0x28A1E020u, 0x3CF27010u, 0x36D96808u, 0x1B6CB42Cu, 0x20008A3Eu, 0x1002CF37u},
    {0x20000000u, 0x10000000u, 0x18000000u, 0x0C000000u, 0x32000000u, 0x09000000u,
     0x15800000u, 0x3EC00000u, 0x38200000u, 0x1C100000u, 0x2A180000u, 0x050C0000u,
     0x27B20000u, 0x37C90000u, 0x2DB58000u, 0x22EEC000u, 0x12002000u, 0x19001000u,
     0x0D801800u, 0x32C00C00u, 0x0A203200u, 0x15100900u, 0x3F981580u, 0x3BCC3EC0u,
     0x1F923820u, 0x2BD91C10u, 0x07ADAA18u, 0x27E2C50Cu, 0x35B207B2u, 0x2EC927C9u},
    {0x20000000u, 0x30000000u, 0x28000000u, 0x34000000u, 0x16000000u, 0x25000000u,
     0x0F800000u, 0x38C00000u, 0x2FA00000u, 0x08F00000u, 0x07880000u, 0x3CC40000u,
     0x119E0000u, 0x19E10000u, 0x1E118000u, 0x2119C000u, 0x319E2000u, 0x29E13000u,
     0x3611A800u, 0x1519F400u, 0x279E3600u, 0x0CE11500u, 0x3991A780u, 0x2DD9CCC0u,
     0x083E19A0u, 0x04111DF0u, 0x3E19A008u, 0x111DF004u, 0x19A0083Eu, 0x1DF00411u},
    {0x20000000u, 0x10000000u, 0x28000000u, 0x14000000u, 0x22000000u, 0x09000000u,
     0x04800000u, 0x0B400000u, 0x1DA00000u, 0x27900000u, 0x02080000u, 0x19040000u,
     0x2C8A0000u, 0x1F450000u, 0x3FA88000u, 0x2E924000u, 0x06892000u, 0x1246D000u,
     0x312D6800u, 0x38DCE400u, 0x3DA00200u, 0x37900100u, 0x2A080280u, 0x0D040140u,
     0x0E8A0220u, 0x16450090u, 0x3B288048u, 0x25D240B4u, 0x1B2921DAu, 0x35D6D279u},
};
}  // namespace

// 8-D scrambled Sobol point `idx` (int32, as in the reference): Gray-code XOR
// of the direction numbers, then the digital shift scr[d] per dimension.
__device__ __forceinline__ void sobol_nd(int32_t idx, const uint32_t* scr, float* u) {
  const uint32_t gray = static_cast<uint32_t>(idx ^ (idx >> 1));
  uint32_t x[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 30; ++k) {
    const uint32_t bit = (gray >> k) & 1u;
#pragma unroll
    for (int d = 0; d < 8; ++d) x[d] ^= bit * kSobolV8[d][k];
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    u[d] = __fadd_rn(__fmul_rn(static_cast<float>(x[d] ^ scr[d]), kInv2_30), kHalfInv2_30);
  }
}

}  // namespace optionslab
