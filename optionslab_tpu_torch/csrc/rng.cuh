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

}  // namespace optionslab
