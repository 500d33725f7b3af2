// A whole Heston option chain on Hopper: every quote's price and its gradient
// in (v0, κ, θ, σ, ρ), in one launch — the engine under kernel-speed
// calibration.
//
// Replaces the TPU kernel
// optionslab_tpu/ops/heston_pallas.py::_heston_chain_kernel. Every lane of the
// reference's (128, 512) counter space simulates one antithetic pair by
// full-truncation Euler on a variable-dt grid whose step boundaries hit every
// expiry, carrying the pathwise sensitivities (∂x, ∂v) for v0, κ, θ, σ and ∂x
// for ρ (18 floats per lane beside the 4 states). At the end of step i it
// folds in the quotes that expire there: per quote Σpay, Σpay² and
// Σ1{ex}·S_t·∂x_t/∂p for the five parameters.
//
// The TPU kernel unrolls one branch per quote because the expiry steps and
// the signs are compile-time constants there. Here they are runtime arrays: a
// per-step CSR list of the quotes that expire at its end, strikes, signs and
// the (dt, √dt) grid in device memory, so one compiled kernel serves every
// chain. Q × 7 accumulators do not fit in registers, so at an expiry step
// each warp sums the quote's 7 terms by shuffles and lane 0 adds them into
// the warp's own shared-memory slot (Q · 7 · 8 floats per CUDA block); at the
// end the block sums its 8 warp slots in order into the (quote, moment, row,
// chunk) partial, and a second pass sums the chunks. Every add happens in a
// fixed order: no atomics, deterministic.
//
// What bounds it: instruction issue in the step loop, as heston_mc.cu's
// ladder: one Box–Muller, two sqrtf(v⁺) and the nine sensitivities of both
// branches; with `prng` a step issues 371 instructions (245 FP32, 79 INT32;
// ops/sass_bound.py). The expiry work (an expf, 7 warp sums per quote) runs
// on a few steps only and sits behind a branch the hot-loop count leaves
// out. Device memory: the grid and the quotes are read once per step from
// the L1-resident arrays. `-Xptxas -v` (sm_90a, CUDA 12.9): 64 registers,
// no spills.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "heston_euler.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr int kLanes = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNs = 9;  // (dx, dv) for v0, κ, θ, σ, then dx for ρ

enum Sampler : int { kPrng = 0, kHash = 1 };

struct ChainArgs {
  const float* head;      // (9,): S0, mu, kappa, theta, sigma_v, rho, srho, v0, crho
  const float* dt;        // (n_steps,)
  const float* sqrt_dt;   // (n_steps,)
  const float* strikes;   // (Q,)
  const float* cps;       // (Q,)
  const int* exp_ptr;     // (n_steps + 1,): quotes expiring at the end of step i are
  const int* exp_quote;   //   exp_quote[exp_ptr[i] .. exp_ptr[i + 1])
  int n_quotes;
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps;
  float* partials;  // (Q·7, 128, n_chunks)
};

using heston::add;
using heston::mul;
using heston::sub;

struct Ctx {
  float s0, mu, kappa, theta, sigma_v, rho, srho, v0, crho;
};

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks. Every thread runs the same number of lanes and steps, so each
// warp reaches every expiry step together.
template <int kS>
__global__ void __launch_bounds__(kThreads) heston_chain_kernel(ChainArgs a) {
  extern __shared__ float warp_acc[];  // [quote·7 + moment][warp]
  const int n_acc = 7 * a.n_quotes;
  for (int j = threadIdx.x; j < n_acc * kWarps; j += kThreads) warp_acc[j] = 0.0f;
  __syncthreads();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* h = a.head;
  const Ctx c{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8]};
  const uint32_t urow = static_cast<uint32_t>(row);

  for (int blk = b_begin; blk < b_end; ++blk) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(blk);
    for (int col = threadIdx.x; col < kLanes; col += kThreads) {
      const uint32_t ucol = static_cast<uint32_t>(col);
      float xa = 0.0f, va = c.v0, xb = 0.0f, vb = c.v0;
      float sa[kNs], sb[kNs];
#pragma unroll
      for (int j = 0; j < kNs; ++j) sa[j] = sb[j] = (j == 1) ? 1.0f : 0.0f;
#pragma unroll 1  // one step per trip: the loop body is what the bound counts
      for (int i = 0; i < a.n_steps; ++i) {
        const uint32_t ui = static_cast<uint32_t>(i);
        float zv, zo;
        if (kS == kPrng) {
          draw_normals_philox(a.seed, block, ui, urow, ucol, &zv, &zo);
        } else {
          draw_normals_hash(a.seed, block, ui, static_cast<uint32_t>(a.n_steps), urow, ucol,
                            kRows, kLanes, &zv, &zo);
        }
        const float dt = a.dt[i];
        const heston::StepCoeffs sc{mul(c.mu, dt), dt, a.sqrt_dt[i], c.kappa, c.theta,
                                    c.sigma_v, c.crho, 0.0f};
        const float zx = add(mul(c.rho, zv), mul(c.srho, zo));
        heston::euler_step<kNs>(sc, xa, va, sa, zv, zo, zx);
        heston::euler_step<kNs>(sc, xb, vb, sb, -zv, -zo, -zx);
        const int e_end = a.exp_ptr[i + 1];
        for (int e = a.exp_ptr[i]; e < e_end; ++e) {
          const int q = a.exp_quote[e];
          const float strike = a.strikes[q], cpq = a.cps[q];
          float t[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const float st = mul(c.s0, expf(b == 0 ? xa : xb));
            const float dd = mul(cpq, sub(st, strike));
            const float pay = fmaxf(dd, 0.0f);
            const float ind_st = dd > 0.0f ? st : 0.0f;
            const float* s = b == 0 ? sa : sb;
            t[0] = add(t[0], pay);
            t[1] = add(t[1], mul(pay, pay));
#pragma unroll
            for (int k = 0; k < 5; ++k) t[2 + k] = add(t[2 + k], mul(ind_st, s[2 * k]));
          }
#pragma unroll
          for (int m = 0; m < 7; ++m) {
            const float w = warp_sum(t[m]);
            if (lane == 0) warp_acc[(7 * q + m) * kWarps + warp] += w;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n_acc; j += kThreads) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_acc[j * kWarps + w];
    a.partials[(static_cast<size_t>(j) * kRows + row) * a.n_chunks + chunk] = sum;
  }
}

}  // namespace
}  // namespace optionslab

// Per-row sums into `out` (Q, 7, 128) float32, with `partials` (Q·7, 128,
// n_chunks) as scratch. Shared memory per CUDA block: Q · 7 · 8 floats
// (up to 1037 quotes).
extern "C" int heston_chain_moments(const void* head, const void* dt, const void* sqrt_dt,
                                    const void* strikes, const void* cps, const void* exp_ptr,
                                    const void* exp_quote, int n_quotes, uint32_t seed,
                                    uint32_t block0, int n_blocks, int blocks_per_chunk,
                                    int n_chunks, int n_steps, int sampler, void* partials,
                                    void* out, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_quotes) * 7 * kWarps * sizeof(float);
  if (n_quotes < 1 || smem > 232448 || n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 ||
      n_steps < 1 || sampler < kPrng || sampler > kHash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainArgs a;
  a.head = static_cast<const float*>(head);
  a.dt = static_cast<const float*>(dt);
  a.sqrt_dt = static_cast<const float*>(sqrt_dt);
  a.strikes = static_cast<const float*>(strikes);
  a.cps = static_cast<const float*>(cps);
  a.exp_ptr = static_cast<const int*>(exp_ptr);
  a.exp_quote = static_cast<const int*>(exp_quote);
  a.n_quotes = n_quotes;
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(n_chunks);
  const int smem_i = static_cast<int>(smem);
  if (sampler == kPrng) {
    err = cudaFuncSetAttribute(heston_chain_kernel<kPrng>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_i);
    if (err != cudaSuccess) return static_cast<int>(err);
    heston_chain_kernel<kPrng><<<grid, kThreads, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(heston_chain_kernel<kHash>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_i);
    if (err != cudaSuccess) return static_cast<int>(err);
    heston_chain_kernel<kHash><<<grid, kThreads, smem, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = 7 * n_quotes * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), 7 * n_quotes, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
