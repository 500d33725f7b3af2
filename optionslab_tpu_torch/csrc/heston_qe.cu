// Heston European Monte Carlo on Hopper, Andersen (2008) quadratic-exponential
// scheme: the price, and the full ladder by common-random-number bumps.
//
// Replaces two TPU kernels of optionslab_tpu/ops/heston_pallas.py, as two
// instances of one template:
//  * _heston_qe_kernel (kSets = 1, the (128, 512) counter space): one
//    antithetic pair per lane (−z_v, −z_x, 1 − u); per-row Σpay, Σpay² and
//    Σ1{ex}·S_T;
//  * _heston_qe_ladder_kernel (kSets = 7, (128, 256)): seven path systems —
//    the base and bumps of v0, κ, θ, σ, ρ and T — on the same draws (28 carried
//    floats per lane); per-row Σpay, Σpay², Σ1{ex}·S_T of the base and Σpay of
//    each bumped system, from which ops/heston_kernel.py takes forward
//    differences.
// The QE step itself (heston_qe.cuh) is shared with heston_exotic.cu.
//
// What bounds it: instruction issue. Per lane, step and path system: three
// sqrtf, a logf, five divides and ~40 FP32 operations, twice (the pair); per
// lane and step one Box–Muller and one uniform (a second Philox or hash
// draw). The ladder instance does seven times the path work on one draw.
// ops/sass_bound.py counts the step loop by pipe (1 + 6·kSets MUFU.RSQ per
// trip): with `prng` a step issues 519 instructions (278 FP32) for the price
// and 2544 (1631 FP32, 142 MUFU) for the ladder. Device memory is idle:
// 2 + 11·kSets floats in. `-Xptxas -v` (sm_90a, CUDA 12.9): 62 registers for
// the price; 158 for the ladder, which then runs one CUDA block of 256
// threads per SM and stays well short of its issue bound (PERF.md; fewer
// registers, e.g. the sets in an outer loop over replayed draws, are left
// for tuning).
//
// What the design does about it: one thread owns one lane's pairs in
// registers through the time loop; the per-set constants sit in shared
// memory, loaded once per CUDA block; the counter space is the reference's
// (`hash` reproduces the JAX path set; `prng` is Philox stream 0 for the
// normals and stream 1 for the uniform); fixed-order reduction (reduce.cuh);
// precise libm and no FMA contraction, so each path is bitwise the plain
// torch version's. Templates: kSets (1, 7) × sampler (2).
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "heston_qe.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr int kThreads = 256;
constexpr int kConsts = 11;  // mu_dt, emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4, v0

enum Sampler : int { kPrng = 0, kHash = 1 };

struct QeArgs {
  const float* params;  // (2 + 11·kSets,): S0, K, then the constant sets
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps;
  float cp;
  float* partials;  // (2 + kSets, 128, n_chunks)
};

using heston::mul;
using heston::qe_advance;
using heston::sub;

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, its threads striding over the row's lanes.
template <int kSets, int kS>
__global__ void __launch_bounds__(kThreads) heston_qe_kernel(QeArgs a) {
  constexpr int kLanes = kSets == 1 ? 512 : 256;
  constexpr int kMom = 2 + kSets;
  constexpr int kP = 2 + kConsts * kSets;
  __shared__ float sp[kP];
  for (int j = threadIdx.x; j < kP; j += kThreads) sp[j] = a.params[j];
  __syncthreads();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const float s0 = sp[0], strike = sp[1], cp = a.cp;
  const uint32_t urow = static_cast<uint32_t>(row);

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
  for (int blk = b_begin; blk < b_end; ++blk) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(blk);
    for (int col = threadIdx.x; col < kLanes; col += kThreads) {
      const uint32_t ucol = static_cast<uint32_t>(col);
      float x[kSets][2], v[kSets][2];
#pragma unroll
      for (int s = 0; s < kSets; ++s) {
        x[s][0] = x[s][1] = 0.0f;
        v[s][0] = v[s][1] = sp[2 + kConsts * s + 10];
      }
#pragma unroll 1  // one step per trip: the loop body is what the bound counts
      for (int i = 0; i < a.n_steps; ++i) {
        const uint32_t ui = static_cast<uint32_t>(i);
        float zv, zx, u;
        if (kS == kPrng) {
          draw_normals_philox(a.seed, block, ui, urow, ucol, &zv, &zx);
          u = draw_uniform_philox(a.seed, block, ui, urow, ucol);
        } else {
          const uint32_t n = static_cast<uint32_t>(a.n_steps);
          draw_normals_hash(a.seed, block, ui, n, urow, ucol, kRows, kLanes, &zv, &zx);
          u = draw_uniform_hash(a.seed, block, ui, n, urow, ucol, kRows, kLanes);
        }
        const float u_b = sub(1.0f, u);
#pragma unroll
        for (int s = 0; s < kSets; ++s) {
          const float* c = sp + 2 + kConsts * s;
          qe_advance(c, x[s][0], v[s][0], zv, zx, u);
          qe_advance(c, x[s][1], v[s][1], -zv, -zx, u_b);
        }
      }
#pragma unroll
      for (int s = 0; s < kSets; ++s) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float st = mul(s0, expf(x[s][b]));
          const float d = mul(cp, sub(st, strike));
          const float pay = fmaxf(d, 0.0f);
          if (s == 0) {
            acc[0] += pay;
            acc[1] += mul(pay, pay);
            acc[2] += d > 0.0f ? st : 0.0f;
          } else {
            acc[2 + s] += pay;
          }
        }
      }
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int kSets>
void launch_sets(const QeArgs& a, int sampler, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  if (sampler == kPrng) {
    heston_qe_kernel<kSets, kPrng><<<grid, kThreads, 0, stream>>>(a);
  } else {
    heston_qe_kernel<kSets, kHash><<<grid, kThreads, 0, stream>>>(a);
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (2 + n_sets, 128) float32, with `partials`
// (2 + n_sets, 128, n_chunks) as scratch. n_sets = 1: the QE price kernel;
// n_sets = 7: the QE ladder kernel.
extern "C" int heston_qe_moments(const void* params, uint32_t seed, uint32_t block0,
                                 int n_blocks, int blocks_per_chunk, int n_chunks, int n_steps,
                                 float cp, int n_sets, int sampler, void* partials, void* out,
                                 int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 ||
      (n_sets != 1 && n_sets != 7) || sampler < kPrng || sampler > kHash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  QeArgs a;
  a.params = static_cast<const float*>(params);
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.cp = cp;
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_sets == 1) {
    launch_sets<1>(a, sampler, st);
  } else {
    launch_sets<7>(a, sampler, st);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (2 + n_sets) * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), 2 + n_sets, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
