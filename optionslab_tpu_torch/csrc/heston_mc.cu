// Heston European Monte Carlo on Hopper, full-truncation Euler: price,
// v0-vega or the full six-parameter pathwise ladder, in one pass.
//
// Replaces the TPU kernel optionslab_tpu/ops/heston_pallas.py::_heston_kernel.
// Every lane of the reference's counter space ((128, 512), or (128, 256) in
// ladder mode) simulates one antithetic pair of (log-spot, variance) paths
// through all n_steps and, in vega/ladder mode, carries the forward
// sensitivities (∂x/∂p, ∂v/∂p) of the Euler recursion for p = v0 (vega), and
// for v0, κ, θ, σ, ρ (∂x only) and T in ladder mode: 4 states plus 2 × 11
// sensitivities per lane. For every row it returns Σpay, Σpay², Σ1{ex}·S_T
// and Σ1{ex}·S_T·∂x_T/∂p per carried p; ops/heston_kernel.py turns them into
// price, stderr, delta, rho and the ladder.
//
// What bounds it: instruction issue. Per lane and step: one Box–Muller
// (logf, sqrtf, sincosf), two sqrtf(v⁺) (one per branch), the sampler's
// integer work (4 murmur mixes for `hash`, 10 Philox rounds for `prng`), the
// two branches' state updates and, in vega and ladder mode, their
// sensitivities and one divide (1/(2√v⁺)) each. ops/sass_bound.py counts the
// step loop from the built SASS (three MUFU.RSQ per trip; the `sobol_bb`
// instance's pre-pass and replay loops, one and three, each once per step:
// 313 instructions a step, bridge.cuh); with `prng` one
// step issues 195 instructions in price mode (97 FP32, 65 INT32), 255 in
// vega mode and 403 in ladder mode (294 FP32), and chip_smoke.py prints the
// counts beside the kernel's time. Device memory is idle: 12 floats in,
// O(moments · rows · chunks) floats out. `-Xptxas -v` (sm_90a, CUDA 12.9):
// 38 / 43 / 78 registers for price / vega / ladder with `prng`, no spills;
// `sobol_bb` a few more and a small spill (its bridge arrays; the verify
// skill notes list every instance).
//
// What the design does about it:
//  * Nothing per step touches memory: one thread owns one (block, row, col)
//    lane at a time and keeps its pair, its sensitivities (26 floats in
//    ladder mode) and its moment sums in registers through the time loop.
//  * The counter space is the reference's, so `hash` and `sobol_bb` paths are
//    the JAX kernel's own; `prng` is Philox stream 0 at (row, col, step, 0).
//  * Fixed-order reduction (reduce.cuh): no float atomics.
//  * Precise libm, every product that feeds a path value rounded on its own
//    (__fmul_rn/__fadd_rn, never an FMA) in the reference's association
//    order, so each path is bitwise the plain torch version's.
//  * Templates: mode (3) × sampler (3), 7 instances (`sobol_bb` is price
//    only); cp, n_steps, the bridge plan and every market and model scalar
//    are runtime arguments.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "bridge.cuh"
#include "heston_euler.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr int kThreads = 256;

enum Mode : int { kPrice = 0, kVega = 1, kLadder = 2 };
enum Sampler : int { kPrng = 0, kHash = 1, kSobolBB = 2 };

struct EulerArgs {
  const float* params;  // (12,)
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps;
  float cp;
  bridge::Plan plan;
  float* partials;  // (n_mom, 128, n_chunks)
};

struct Ctx {
  float s0, strike, rho, srho, v0, cp;
  heston::StepCoeffs step;
};

using heston::add;
using heston::mul;
using heston::quo;
using heston::sub;

template <int M>
__host__ __device__ constexpr int n_sens() {
  return M == kLadder ? 11 : (M == kVega ? 2 : 0);
}
template <int M>
__host__ __device__ constexpr int n_moments() {
  return M == kLadder ? 9 : (M == kVega ? 4 : 3);
}
template <int M>
__host__ __device__ constexpr int lanes_of() {
  return M == kLadder ? 256 : 512;
}

// The pair of one (block, row, col) lane through all steps; adds the lane's
// moment terms into acc.
template <int M, int kS>
__device__ __forceinline__ void simulate_lane(const Ctx& c, const EulerArgs& a, uint32_t block,
                                              uint32_t row, uint32_t col, float* acc) {
  constexpr int kNs = n_sens<M>();
  constexpr int kS1 = kNs > 0 ? kNs : 1;
  constexpr uint32_t kLanes = lanes_of<M>();
  float xa = 0.0f, va = c.v0, xb = 0.0f, vb = c.v0;
  float sa[kS1], sb[kS1];
#pragma unroll
  for (int j = 0; j < kS1; ++j) sa[j] = sb[j] = (j == 1) ? 1.0f : 0.0f;  // ∂v/∂v0 = 1

  auto draw = [&](int i, float* zv, float* zo) {
    if (kS == kPrng) {
      draw_normals_philox(a.seed, block, static_cast<uint32_t>(i), row, col, zv, zo);
    } else {  // hash, and the QMC residuals
      draw_normals_hash(a.seed, block, static_cast<uint32_t>(i),
                        static_cast<uint32_t>(a.n_steps), row, col, kRows, kLanes, zv, zo);
    }
  };
  auto step = [&](int, float zva, float zoa, float zvb, float zob) {
    const float zxa = add(mul(c.rho, zva), mul(c.srho, zoa));
    const float zxb = add(mul(c.rho, zvb), mul(c.srho, zob));
    heston::euler_step<kNs>(c.step, xa, va, sa, zva, zoa, zxa);
    heston::euler_step<kNs>(c.step, xb, vb, sb, zvb, zob, zxb);
  };

  if constexpr (kS == kSobolBB) {
    float cv[9], co[9];
    bridge::targets_pair(a.plan, a.seed, kHashSalt, block, row, col, kRows, kLanes, cv, co);
    bridge::replay(a.plan, cv, co, draw, step);
  } else {
#pragma unroll 1  // one step per trip: the loop body is what the bound counts
    for (int i = 0; i < a.n_steps; ++i) {
      float zv, zo;
      draw(i, &zv, &zo);
      step(i, zv, zo, -zv, -zo);
    }
  }

#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const float st = mul(c.s0, expf(b == 0 ? xa : xb));
    const float d = mul(c.cp, sub(st, c.strike));
    const float pay = fmaxf(d, 0.0f);
    const float ind_st = d > 0.0f ? st : 0.0f;
    acc[0] += pay;
    acc[1] += mul(pay, pay);
    acc[2] += ind_st;
#pragma unroll
    for (int k = 0; k < n_moments<M>() - 3; ++k) {
      // the dx slots of the moments beyond pay/pay²/m1: v0, κ, θ, σ, ρ, T
      const int slot = k < 5 ? 2 * k : 9;
      acc[3 + k] += mul(ind_st, b == 0 ? sa[slot] : sb[slot]);
    }
  }
}

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, its threads striding over the row's lanes.
template <int M, int kS>
__global__ void __launch_bounds__(kThreads) heston_mc_kernel(EulerArgs a) {
  constexpr int kMom = n_moments<M>();
  constexpr int kLanes = lanes_of<M>();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);

  const float* p = a.params;
  Ctx c;
  c.s0 = p[0];
  c.strike = p[1];
  c.rho = p[8];
  c.srho = p[9];
  c.v0 = p[10];
  c.cp = a.cp;
  c.step = heston::StepCoeffs{p[2], p[3], p[4], p[5], p[6], p[7],
                              quo(c.rho, fmaxf(c.srho, 1e-4f)), quo(1.0f, p[11])};

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
  for (int b = b_begin; b < b_end; ++b) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(b);
    for (int col = threadIdx.x; col < kLanes; col += kThreads) {
      simulate_lane<M, kS>(c, a, block, static_cast<uint32_t>(row), static_cast<uint32_t>(col),
                           acc);
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int M>
void launch_mode(const EulerArgs& a, int sampler, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  if (sampler == kPrng) {
    heston_mc_kernel<M, kPrng><<<grid, kThreads, 0, stream>>>(a);
  } else if (sampler == kHash) {
    heston_mc_kernel<M, kHash><<<grid, kThreads, 0, stream>>>(a);
  } else if constexpr (M == kPrice) {  // bridge QMC is price/delta/rho only
    heston_mc_kernel<M, kSobolBB><<<grid, kThreads, 0, stream>>>(a);
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom, 128) float32, with `partials`
// (n_mom, 128, n_chunks) float32 as scratch; n_mom is 3, 4 or 9 for mode
// price, vega or ladder. `plan_i` (32 ints) and `plan_f` (23 floats) are host
// arrays: the sobol_bb bridge plan (zeros otherwise).
extern "C" int heston_mc_moments(const void* params, uint32_t seed, uint32_t block0,
                                 int n_blocks, int blocks_per_chunk, int n_chunks, int n_steps,
                                 float cp, int mode, int sampler, const int* plan_i,
                                 const float* plan_f, void* partials, void* out, int device,
                                 void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 || mode < kPrice ||
      mode > kLadder || sampler < kPrng || sampler > kSobolBB ||
      (sampler == kSobolBB && (mode != kPrice || n_steps < 2)) || plan_i[0] > 8 ||
      plan_i[10] > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EulerArgs a;
  a.params = static_cast<const float*>(params);
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.cp = cp;
  a.plan = bridge::load_plan(plan_i, plan_f);
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int n_mom = 3;
  switch (mode) {
    case kPrice: launch_mode<kPrice>(a, sampler, st); break;
    case kVega: launch_mode<kVega>(a, sampler, st); n_mom = 4; break;
    default: launch_mode<kLadder>(a, sampler, st); n_mom = 9; break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
