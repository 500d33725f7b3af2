// Heston European Monte Carlo on Hopper, Andersen (2008) quadratic-exponential
// scheme: the price, and the full ladder by common-random-number bumps.
//
// Replaces two TPU kernels of optionslab_tpu/ops/heston_pallas.py:
//  * _heston_qe_kernel → heston_qe_kernel<1, sampler> on the (128, 512)
//    counter space: one antithetic pair per lane (−z_v, −z_x, 1 − u);
//    per-row Σpay, Σpay² and Σ1{ex}·S_T;
//  * _heston_qe_ladder_kernel → heston_qe_ladder_kernel<sampler> on the
//    (128, 256) counter space: seven path systems — the base and bumps of
//    v0, κ, θ, σ, ρ and T — on the same draws; per-row Σpay, Σpay²,
//    Σ1{ex}·S_T of the base and Σpay of each bumped system, from which
//    ops/heston_kernel.py takes forward differences.
// The QE step itself (heston_qe.cuh) is shared with heston_exotic.cu.
//
// What bounds them: instruction issue. Per lane, step and path system: three
// sqrtf, a logf, five divides and ~40 FP32 operations, twice (the pair); per
// lane and step one Box–Muller and one uniform (a second Philox or hash
// draw). With `prng`, ops/sass_bound.py counts 519 instructions per
// lane-step for the price; for the ladder 2572 of the function
// (sass_bound.nest_counts: 7 trips of the advance loop — one system pair —
// plus one of the drawing chunk loop, plus 7 payoff epilogues per lane),
// 2696 with the split's own bookkeeping (its shared loads and stores, the
// barrier, both loops' addresses and control). Device memory is idle:
// 2 + 11·sets floats in, (2 + sets) · 128 · chunks out.
//
// What the designs do about it:
//  * the price kernel: one thread owns one lane's pair in registers through
//    the time loop (62 registers, four CUDA blocks of 256 threads per SM);
//    the constants sit in shared memory, loaded once per CUDA block;
//  * the ladder kernel: one thread carrying all seven systems of a lane
//    (28 floats through the loop) needed 158 registers, one CUDA block per
//    SM, two warps per scheduler to hide the divides' and roots' latency
//    (each behind its own guarded slow path, across which nothing is
//    scheduled), and reached 0.44 of its bound. Here the systems are split
//    over warps: warp s of a 224-thread CUDA block carries system s (one
//    pair, its 11 constants in registers) on 32 lanes of a row: 54–56
//    registers, five CUDA blocks (35 warps) per SM, ≈0.83 of the bound.
//    Every K = 7 steps the block's threads draw the (z_v, z_x, u) of its 32
//    lanes × 7 steps — one draw each, warp s step i0 + s; in the tail chunk
//    the warps past the last step draw nothing — into a double buffer in
//    shared memory, meet at one barrier, and each warp advances its system
//    7 steps reading them (the mate branch negates the normals and takes
//    1 − u: exact). A work unit is one 32-lane slice of a path block's row;
//    a CUDA block sums one row over a chunk of units (ladder_plan: one unit
//    each at the path's shape, so the ≈200 waves end together), each warp
//    its own system's moments (set 0 three, the others one), with no
//    cross-warp step and no float atomics;
//  * the counter space is the reference's (`hash` reproduces the JAX path
//    set; `prng` is Philox stream 0 for the normals and stream 1 for the
//    uniform); fixed-order reductions (reduce.cuh); precise libm and no FMA
//    contraction, so each path is bitwise the plain torch version's.
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
  const float* params;  // (2 + 11·sets,): S0, K, then the constant sets
  uint32_t seed;
  uint32_t block0;
  int n_blocks;
  int units_per_chunk;  // path blocks (price) or 32-lane units (ladder, ladder_plan) per chunk
  int n_chunks;
  int n_steps;
  float cp;
  float* partials;  // (2 + sets, 128, n_chunks)
};

using heston::mul;
using heston::qe_advance;
using heston::sub;

// The price kernel (instantiated with kSets = 1). grid.x = 128 rows ×
// n_chunks; one CUDA block sums one row over one chunk of path blocks, its
// threads striding over the row's lanes.
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
  const int b_begin = chunk * a.units_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.units_per_chunk);
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

constexpr int kLadderSets = 7;     // the ladder: base + bumps of v0, κ, θ, σ, ρ, T
constexpr int kLadderLanes = 256;  // its (128, 256) counter space
constexpr int kGroup = 32;         // lanes of a row per work unit: one warp's width
constexpr int kGroups = kLadderLanes / kGroup;
constexpr int kLadderThreads = 32 * kLadderSets;  // warp s carries path system s
constexpr int kChunk = kLadderSets;               // steps per barrier: one draw per thread
// chunks of a row at most: at the path's 128 path blocks one unit per CUDA
// block, ≈200 waves of five blocks per SM that end together (4096 blocks,
// 6.2 waves, idled ≈10% of the card in the last one)
constexpr int kLadderChunks = 1024;

// (n_chunks, units_per_chunk) of a ladder launch over n_blocks path blocks:
// n_blocks · kGroups units spread evenly over at most kLadderChunks chunks.
void ladder_plan(int n_blocks, int* n_chunks, int* units_per_chunk) {
  const long long n_units = static_cast<long long>(n_blocks) * kGroups;
  const long long chunks = n_units < kLadderChunks ? n_units : kLadderChunks;
  const long long per = (n_units + chunks - 1) / chunks;
  *units_per_chunk = static_cast<int>(per);
  *n_chunks = static_cast<int>((n_units + per - 1) / per);
}

// The ladder kernel. grid.x = 128 rows × n_chunks; one CUDA block sums one
// row over a chunk of work units (unit = block·8 + g: lanes 32g..32g+31 of
// path block block0 + block). Warp s advances system s; every thread draws
// one (step, lane) of each K-step chunk for all seven.
template <int kS>
__global__ void __launch_bounds__(kLadderThreads) heston_qe_ladder_kernel(QeArgs a) {
  __shared__ float draws[2][3][kChunk][kGroup];  // buffer, (z_v, z_x, u), step, lane
  const int set = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float c[kConsts];
#pragma unroll
  for (int j = 0; j < kConsts; ++j) c[j] = a.params[2 + kConsts * set + j];
  const float s0 = a.params[0], strike = a.params[1], cp = a.cp;
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int u_begin = chunk * a.units_per_chunk;
  const int u_end = min(a.n_blocks * kGroups, u_begin + a.units_per_chunk);
  const uint32_t urow = static_cast<uint32_t>(row);
  const uint32_t n = static_cast<uint32_t>(a.n_steps);

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  int buf = 0;
  for (int unit = u_begin; unit < u_end; ++unit) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(unit / kGroups);
    const uint32_t col = static_cast<uint32_t>((unit % kGroups) * kGroup + lane);
    float xa = 0.0f, xb = 0.0f, va = c[10], vb = c[10];
#pragma unroll 1
    for (int i0 = 0; i0 < a.n_steps; i0 += kChunk) {
      // this thread's draw: step i0 + set of lane col; in the tail chunk the
      // warps past the last step draw nothing (`set` is warp-uniform)
      if (i0 + set < a.n_steps) {
        const uint32_t ui = static_cast<uint32_t>(i0 + set);
        float zv, zx, u;
        if (kS == kPrng) {
          draw_normals_philox(a.seed, block, ui, urow, col, &zv, &zx);
          u = draw_uniform_philox(a.seed, block, ui, urow, col);
        } else {
          draw_normals_hash(a.seed, block, ui, n, urow, col, kRows, kLadderLanes, &zv, &zx);
          u = draw_uniform_hash(a.seed, block, ui, n, urow, col, kRows, kLadderLanes);
        }
        draws[buf][0][set][lane] = zv;
        draws[buf][1][set][lane] = zx;
        draws[buf][2][set][lane] = u;
      }
      // one barrier per chunk, reached by every thread: with two buffers, a
      // warp that writes buffer b again has passed the next barrier, so
      // every warp is done reading it
      __syncthreads();
      const int n_k = min(kChunk, a.n_steps - i0);
#pragma unroll 1  // one step of this warp's system pair per trip
      for (int k = 0; k < n_k; ++k) {
        const float zvk = draws[buf][0][k][lane];
        const float zxk = draws[buf][1][k][lane];
        const float uk = draws[buf][2][k][lane];
        qe_advance(c, xa, va, zvk, zxk, uk);
        qe_advance(c, xb, vb, -zvk, -zxk, sub(1.0f, uk));
      }
      buf ^= 1;
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float st = mul(s0, expf(b == 0 ? xa : xb));
      const float d = mul(cp, sub(st, strike));
      const float pay = fmaxf(d, 0.0f);
      acc0 += pay;
      if (set == 0) {  // warp-uniform
        acc1 += mul(pay, pay);
        acc2 += d > 0.0f ? st : 0.0f;
      }
    }
  }
  // moment m of the row: set 0 owns m = 0, 1, 2, set s > 0 owns m = 2 + s
  const float m0 = warp_sum(acc0);
  float m1 = 0.0f, m2 = 0.0f;
  if (set == 0) {
    m1 = warp_sum(acc1);
    m2 = warp_sum(acc2);
  }
  if (lane == 0) {
    float* out = a.partials + static_cast<size_t>(row) * a.n_chunks + chunk;
    const size_t stride = static_cast<size_t>(kRows) * a.n_chunks;  // one moment
    if (set == 0) {
      out[0] = m0;
      out[stride] = m1;
      out[2 * stride] = m2;
    } else {
      out[(2 + set) * stride] = m0;
    }
  }
}

void launch(const QeArgs& a, int n_sets, int sampler, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  if (n_sets == 1) {
    if (sampler == kPrng) {
      heston_qe_kernel<1, kPrng><<<grid, kThreads, 0, stream>>>(a);
    } else {
      heston_qe_kernel<1, kHash><<<grid, kThreads, 0, stream>>>(a);
    }
  } else if (sampler == kPrng) {
    heston_qe_ladder_kernel<kPrng><<<grid, kLadderThreads, 0, stream>>>(a);
  } else {
    heston_qe_ladder_kernel<kHash><<<grid, kLadderThreads, 0, stream>>>(a);
  }
}

}  // namespace
}  // namespace optionslab

// The QE ladder's launch plan for n_blocks path blocks: the n_chunks and
// units_per_chunk that heston_qe_moments takes with n_sets = 7.
extern "C" int heston_qe_ladder_plan(int n_blocks, int* n_chunks, int* units_per_chunk) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  optionslab::ladder_plan(n_blocks, n_chunks, units_per_chunk);
  return 0;
}

// Per-row moment sums into `out` (2 + n_sets, 128) float32, with `partials`
// (2 + n_sets, 128, n_chunks) as scratch. n_sets = 1: the QE price kernel,
// n_chunks chunks of units_per_chunk path blocks; n_sets = 7: the QE ladder
// kernel, on the plan of heston_qe_ladder_plan.
extern "C" int heston_qe_moments(const void* params, uint32_t seed, uint32_t block0,
                                 int n_blocks, int units_per_chunk, int n_chunks, int n_steps,
                                 float cp, int n_sets, int sampler, void* partials, void* out,
                                 int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || units_per_chunk < 1 || n_chunks < 1 || n_steps < 1 ||
      (n_sets != 1 && n_sets != kLadderSets) || sampler < kPrng || sampler > kHash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_units = static_cast<long long>(n_blocks) * (n_sets == 1 ? 1 : kGroups);
  if (static_cast<long long>(units_per_chunk) * n_chunks < n_units) {
    return static_cast<int>(cudaErrorInvalidValue);  // the chunks would skip units
  }
  QeArgs a;
  a.params = static_cast<const float*>(params);
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.units_per_chunk = units_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.cp = cp;
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch(a, n_sets, sampler, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (2 + n_sets) * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), 2 + n_sets, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and resident CUDA blocks per SM of the QE kernel
// (n_sets 1 or 7) for `sampler`, as the card schedules it.
extern "C" int heston_qe_occupancy(int n_sets, int sampler, int device, int* registers,
                                   int* blocks_per_sm) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((n_sets != 1 && n_sets != kLadderSets) || sampler < kPrng || sampler > kHash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn;
  int threads;
  if (n_sets == 1) {
    fn = sampler == kPrng ? reinterpret_cast<const void*>(heston_qe_kernel<1, kPrng>)
                          : reinterpret_cast<const void*>(heston_qe_kernel<1, kHash>);
    threads = kThreads;
  } else {
    fn = sampler == kPrng ? reinterpret_cast<const void*>(heston_qe_ladder_kernel<kPrng>)
                          : reinterpret_cast<const void*>(heston_qe_ladder_kernel<kHash>);
    threads = kLadderThreads;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, 0));
}
