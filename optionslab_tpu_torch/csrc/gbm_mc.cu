// Fused GBM Monte Carlo on Hopper: terminal simulation + payoff/Greek moments.
//
// Replaces the TPU kernel optionslab_tpu/ops/gbm_pallas.py::_gbm_kernel.
// For every contract row it sums, over all simulated paths,
//   Σpay, Σpay², Σ1{ex}·S_T and Σ1{ex}·S_T·z      (price-only: the first two)
// from which ops/gbm_kernel.py::_combine builds price, stderr and the Greek
// ladder. One exact terminal GBM step; Box–Muller gives a cos and a sin
// normal per uniform pair, and ± antithetics make 4 paths per pair.
//
// What bounds it: transcendental and integer ALU throughput. Each uniform
// pair costs the sampler (2×2 murmur mixes, or 10 Philox rounds, or a
// 30-step Gray-code XOR), one logf/sqrtf/sincosf, two expf and two divides;
// device memory is nearly idle: the inputs are O(rows) and the outputs
// O(rows·chunks) floats.
//
// What the design does about it:
//  * Nothing per path touches memory. One thread owns one logical (row, col)
//    lane of the reference's counter space and loops over a chunk of path
//    blocks, keeping the moments in registers; the per-row parameters and
//    the shared factor S0·e^{drift} are loaded and computed once per thread.
//  * The counter space is the reference's logical geometry (rows, lanes,
//    reps, block), so the `hash` and `sobol` path sets are the JAX kernel's
//    own; `prng` is Philox4x32-10 keyed by (seed, salt ^ global block).
//  * Reductions run in a fixed order with no float atomics — warp shuffles,
//    then shared memory, into a (moment, row, chunk) partials buffer that a
//    second pass sums per row — so a result depends only on the seed and the
//    geometry, never on the card or the scheduling.
//  * Built without --use_fast_math: precise logf/sqrtf/sincosf/expf keep each
//    path bitwise equal to the plain torch version on the card.
//  * `greeks` and the sampler are template parameters (6 instances); seed,
//    market parameters and n_blocks are runtime arguments.
//
// C interface for ctypes: pointers and the stream are void*, and each entry
// point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kMask30 = (1u << 30) - 1u;

enum Sampler : int { kPrng = 0, kHash = 1, kSobol = 2 };

struct GbmArgs {
  const float* s0;        // (rows,) spot
  const float* k;         // (rows,) strike
  const float* cp;        // (rows,) +1 call / -1 put
  const float* a;         // (rows,) (r - q - σ²/2)·T
  const float* s;         // (rows,) σ·√T
  const int32_t* rep_id;  // (rows,) replica index of the row
  const int32_t* cid;     // (rows,) contract index of the row
  uint32_t seed;
  uint32_t block0;        // global id of this launch's first path block
  int n_blocks;
  int blocks_per_chunk;
  int n_chunks;
  int rows;               // padded row count: the counter stride
  int active_rows;        // c·reps: rows past this are padding, skipped
  int lanes;
  int reps;
  float* partials;        // (n_mom, active_rows, n_chunks)
};

template <bool kGreeks>
__device__ __forceinline__ void accumulate(float* acc, float z, float st, float k, float cp) {
  const float x = cp * (st - k);
  const float pay = fmaxf(x, 0.0f);
  acc[0] += pay;
  acc[1] += pay * pay;
  if (kGreeks) {
    const float ind_st = x > 0.0f ? st : 0.0f;
    acc[2] += ind_st;
    acc[3] += ind_st * z;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// grid.x = active_rows · n_chunks; one CUDA block sums one row over one
// chunk of path blocks; its threads stride over the row's lanes.
template <int kSampler, bool kGreeks>
__global__ void __launch_bounds__(kThreads) gbm_mc_kernel(GbmArgs p) {
  constexpr int kMom = kGreeks ? 4 : 2;
  const int row = blockIdx.x / p.n_chunks;
  const int chunk = blockIdx.x - row * p.n_chunks;
  const int b_begin = chunk * p.blocks_per_chunk;
  const int b_end = min(p.n_blocks, b_begin + p.blocks_per_chunk);

  const float k = p.k[row];
  const float cp = p.cp[row];
  const float s = p.s[row];
  const float base = p.s0[row] * expf(p.a[row]);  // S0·e^{drift}, shared by 4 branches

  const uint32_t urow = static_cast<uint32_t>(row);
  const uint32_t ulanes = static_cast<uint32_t>(p.lanes);
  const uint32_t row_lanes = static_cast<uint32_t>(p.rows) * ulanes;

  // sobol: replicas of one contract take disjoint chunks of one net; each
  // contract (and each of 8 replicate groups when reps % 8 == 0) gets its
  // own seed-derived digital scramble
  uint32_t s1 = 0u, s2 = 0u, idx_stride = 0u, idx_row = 0u;
  if (kSampler == kSobol) {
    const uint32_t rep = static_cast<uint32_t>(p.rep_id[row]);
    const uint32_t cid = static_cast<uint32_t>(p.cid[row]);
    const uint32_t salted = p.seed * kGolden;
    uint32_t h;
    if (p.reps % 8 == 0) {
      idx_stride = static_cast<uint32_t>(p.reps / 8) * ulanes;
      idx_row = (rep >> 3) * ulanes;
      h = fmix32((cid + (rep & 7u) * kGroupSalt) ^ salted);
    } else {
      idx_stride = static_cast<uint32_t>(p.reps) * ulanes;
      idx_row = rep * ulanes;
      h = fmix32(cid ^ salted);
    }
    s1 = h & kMask30;
    s2 = fmix32(h + kHashSalt) & kMask30;
  }

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = b_begin; b < b_end; ++b) {
    const uint32_t block = p.block0 + static_cast<uint32_t>(b);
    for (int col = threadIdx.x; col < p.lanes; col += kThreads) {
      const uint32_t ucol = static_cast<uint32_t>(col);
      float u1, u2;
      if (kSampler == kHash) {
        const uint32_t ctr = block * (2u * row_lanes) + urow * ulanes + ucol;
        u1 = hash_uniform(ctr, p.seed);
        u2 = hash_uniform(ctr + row_lanes, p.seed);
      } else if (kSampler == kSobol) {
        sobol_pair(block * idx_stride + idx_row + ucol + 1u, s1, s2, &u1, &u2);
      } else {
        const uint4 x = philox4x32_10(make_uint4(urow, ucol, 0u, 0u),
                                      make_uint2(p.seed, kPhiloxBlockSalt ^ block));
        u1 = bits24_to_uniform(x.x >> 8);
        u2 = bits24_to_uniform(x.y >> 8);
      }
      const float radius = sqrtf(-2.0f * logf(u1));
      const float theta = kTwoPi * u2;
      float sin_t, cos_t;
      sincosf(theta, &sin_t, &cos_t);
      const float z_cos = radius * cos_t;
      const float z_sin = radius * sin_t;
      // the antithetic shares the exponential: e^{-s·z} = 1/e^{s·z}
      const float grow_cos = expf(s * z_cos);
      const float grow_sin = expf(s * z_sin);
      accumulate<kGreeks>(acc, z_cos, base * grow_cos, k, cp);
      accumulate<kGreeks>(acc, -z_cos, base / grow_cos, k, cp);
      accumulate<kGreeks>(acc, z_sin, base * grow_sin, k, cp);
      accumulate<kGreeks>(acc, -z_sin, base / grow_sin, k, cp);
    }
  }

  __shared__ float warp_sums[kMom][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kMom; ++m) {
    const float v = warp_sum(acc[m]);
    if (lane == 0) warp_sums[m][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMom) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sums[threadIdx.x][w];
    p.partials[(static_cast<size_t>(threadIdx.x) * p.active_rows + row) * p.n_chunks + chunk] = t;
  }
}

// Second pass: out[m, r] = Σ_chunk partials[m, r, chunk] in chunk order;
// padded rows (r >= active_rows) get 0.
__global__ void gbm_mc_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out,
                                     int n_mom, int rows, int active_rows, int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_mom * rows) return;
  const int m = i / rows;
  const int r = i - m * rows;
  float t = 0.0f;
  if (r < active_rows) {
    const float* src = partials + (static_cast<size_t>(m) * active_rows + r) * n_chunks;
    for (int c = 0; c < n_chunks; ++c) t += src[c];
  }
  out[i] = t;
}

template <int kSampler>
void launch_moments(const GbmArgs& args, bool greeks, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(args.active_rows) * static_cast<unsigned>(args.n_chunks);
  if (greeks) {
    gbm_mc_kernel<kSampler, true><<<grid, kThreads, 0, stream>>>(args);
  } else {
    gbm_mc_kernel<kSampler, false><<<grid, kThreads, 0, stream>>>(args);
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom = greeks ? 4 : 2, rows) float32,
// with `partials` (n_mom, active_rows, n_chunks) float32 as scratch.
extern "C" int gbm_mc_moments(const void* s0, const void* k, const void* cp, const void* a,
                              const void* s, const void* rep_id, const void* cid,
                              uint32_t seed, uint32_t block0, int n_blocks,
                              int blocks_per_chunk, int n_chunks, int rows, int active_rows,
                              int lanes, int reps, int sampler, int greeks,
                              void* partials, void* out, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || active_rows < 1 ||
      active_rows > rows || lanes < 1 || reps < 1 || sampler < kPrng || sampler > kSobol) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GbmArgs args;
  args.s0 = static_cast<const float*>(s0);
  args.k = static_cast<const float*>(k);
  args.cp = static_cast<const float*>(cp);
  args.a = static_cast<const float*>(a);
  args.s = static_cast<const float*>(s);
  args.rep_id = static_cast<const int32_t*>(rep_id);
  args.cid = static_cast<const int32_t*>(cid);
  args.seed = seed;
  args.block0 = block0;
  args.n_blocks = n_blocks;
  args.blocks_per_chunk = blocks_per_chunk;
  args.n_chunks = n_chunks;
  args.rows = rows;
  args.active_rows = active_rows;
  args.lanes = lanes;
  args.reps = reps;
  args.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sampler) {
    case kPrng: launch_moments<kPrng>(args, greeks != 0, st); break;
    case kHash: launch_moments<kHash>(args, greeks != 0, st); break;
    default: launch_moments<kSobol>(args, greeks != 0, st); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_mom = greeks ? 4 : 2;
  const int total = n_mom * rows;
  gbm_mc_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      args.partials, static_cast<float*>(out), n_mom, rows, active_rows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gbm_mc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
