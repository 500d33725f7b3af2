// Stochastic-local-vol (SLV) Monte Carlo on Hopper: Heston variance with a
// calibrated Dupire leverage, 20 path kinds, the cliquet, autocall and range
// accrual, and one-pass likelihood-ratio Greek ladders.
//
// Replaces the TPU kernel optionslab_tpu/ops/slv_pallas.py::_slv_kernel.
// Every lane of the reference's (128, 512) counter space carries one
// antithetic pair of (log-spot, variance) paths, (zv, zo) and (−zv, −zo),
// through full-truncation Euler with the leverage L = max(Horner6(clip(x,
// x_lo_i, x_hi_i)), 1e-4) from step i's row [x_lo, x_hi, c6..c0] of the
// host-fitted table (ops/slv_kernel.py::fit_leverage_polys):
//   x += μdt − ½(L√v⁺)²dt + L√v⁺√dt·(ρzv + √(1−ρ²)zo),
//   v += κ(θ − v⁺)dt + ησ√v⁺√dt·zv,
// and each path's running statistic in relative-log space. With `lr` it
// carries zv₀, zo₀ of step 0 and each branch's Σ rate score
// zo·dt·1{v>0}/(√(1−ρ²)·L·max(√v⁺, 1e-6)·√dt). For every row it returns Σpay,
// Σpay² and, with `lr`, ΣD1, ΣDG, ΣDX, ΣDV, ΣSR (+ΣDR for the autocall and
// the pay-at-hit touches, +ΣB0, ΣB1 for the lookbacks); ops/slv_kernel.py
// turns them into price, stderr and the Greek ladder.
//
// What bounds it: instruction issue. Per lane and step: one Box–Muller
// (logf, sqrtf, sincosf), one sqrtf(v⁺) per branch (three MUFU.RSQ per trip),
// the sampler's integer work (4 murmur mixes for `hash`, 10 Philox rounds for
// `prng`), two degree-6 Horner evaluations, the two Euler updates, the
// statistic updates (an expf per branch for the arithmetic Asian, the
// cliquet and the discounted kinds) and, with `lr`, a divide per branch.
// ops/sass_bound.py counts the step loop from the built SASS and
// chip_smoke.py prints the counts beside the kernel's time. Device memory is
// idle: 19 + 9·n_steps floats in, O(moments · rows · chunks) floats out.
//
// What the design does about it:
//  * The step table is staged in shared memory once per CUDA block; the step
//    index is warp-uniform, so every coefficient read is a broadcast.
//  * Nothing per step touches global memory: one thread owns one (block,
//    row, col) lane at a time and keeps its pair, statistics, scores and
//    moment sums in registers through the whole time loop.
//  * Its own Euler step (the x-step's volatility is L·√v⁺, the score divides
//    by L), not heston_euler.cuh's, whose kernels it would otherwise move;
//    the Heston exotic kernel's statistics and payoffs (exotic_stats.cuh).
//  * The counter space is the reference's, so the `hash` path set is the JAX
//    kernel's own; `prng` is Philox keyed by (seed, salt ^ block) at counter
//    (row, col, step, 0).
//  * Fixed-order reduction (reduce.cuh): no float atomics.
//  * Precise libm, every product that feeds a path value rounded on its own
//    (__fmul_rn/__fadd_rn, never an FMA) in the reference's association order,
//    so each path is bitwise the plain torch version's.
//  * Templates: statistic family (9) × lr × sampler (prng, hash), 36
//    instances. cp, the period, the barrier side and payoff, n_steps and every
//    market and model scalar are runtime arguments: no tick recompiles.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "exotic_stats.cuh"
#include "fp.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr uint32_t kLanes = 512;
constexpr int kThreads = 256;
// S0, K, log(B/S0), 1/n, r·dt, dt, √dt, μ·dt, κ, θ, ησ, ρ, √(1−ρ²), v0, A..E
constexpr int kScalars = 19;
constexpr int kDegree = 6;
constexpr int kRow = kDegree + 3;  // x_lo, x_hi, c6..c0
constexpr int kMaxSteps = 6000;

enum Sampler : int { kPrng = 0, kHash = 1 };

using namespace stats;  // the Heston exotic kernel's families, then the European
using fp::add;
using fp::mul;
using fp::quo;
using fp::sub;

struct SlvArgs {
  const float* __restrict__ params;  // 19 scalars, then the (n_steps, 9) step table
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps, period, mode;
  float cp;
  float* partials;  // (n_mom, 128, n_chunks)
};

struct Ctx {
  float s0, k, log_b, inv_n, rdt, dt, sqrt_dt, mu_dt, kappa, theta, sigma_v, rho, srho, v0;
  float a, b, c, d, e, cp;
  int mode, period, n_steps;
  const float* table;  // shared memory
  // LR constants: max(√(1−ρ²), 1e-4), 1/max(v0, 1e-8), the step-0 v0-score heads
  float srho_g, inv_v0, half_inv_v0, a_head, b_head;
};

template <int F, bool kLr>
__host__ __device__ constexpr int n_moments() {
  return kLr ? (F == kLookback ? 9 : ((F == kHitAt || F == kAutocall) ? 8 : 7)) : 2;
}

// the leverage of step i at x: Horner over the step's coefficients at x
// clamped to the step's band, highest degree first (unfloored)
__device__ __forceinline__ float horner(const float* r, float x) {
  const float xc = fminf(fmaxf(x, r[0]), r[1]);
  float acc = r[2];
#pragma unroll
  for (int j = 1; j <= kDegree; ++j) acc = add(mul(acc, xc), r[2 + j]);
  return acc;
}

// One full-truncation Euler step of one branch with the leverage of step i;
// with kLr the step's rate score, gated where v⁺ = 0.
template <bool kLr>
__device__ __forceinline__ void advance(const Ctx& c, float& x, float& v, float zv, float zo,
                                        int i, float* ds) {
  const float ind_v = v > 0.0f ? 1.0f : 0.0f;
  const float vp = mul(v, ind_v);
  const float sq = sqrtf(vp);
  const float lev = fmaxf(horner(c.table + i * kRow, x), 1e-4f);
  const float sig = mul(lev, sq);  // the instantaneous vol of x
  const float zx = add(mul(c.rho, zv), mul(c.srho, zo));
  const float x_new = add(sub(add(x, c.mu_dt), mul(mul(mul(0.5f, sig), sig), c.dt)),
                          mul(mul(sig, c.sqrt_dt), zx));
  const float v_new = add(add(v, mul(mul(c.kappa, sub(c.theta, vp)), c.dt)),
                          mul(mul(mul(c.sigma_v, sq), c.sqrt_dt), zv));
  if (kLr) {
    *ds = quo(mul(mul(zo, c.dt), ind_v),
              mul(mul(mul(c.srho_g, lev), fmaxf(sq, 1e-6f)), c.sqrt_dt));
  }
  x = x_new;
  v = v_new;
}

// The pair of one (block, row, col) lane through all steps; adds the lane's
// moment terms into acc.
template <int F, bool kLr, int kS>
__device__ __forceinline__ void simulate_lane(const Ctx& c, const SlvArgs& a, uint32_t block,
                                              uint32_t row, uint32_t col, float* acc) {
  float xa = 0.0f, xb = 0.0f, va = c.v0, vb = c.v0;
  float sta[4], stb[4];
  init_stat<F>(c, sta);
  init_stat<F>(c, stb);
  float zv0 = 0.0f, zo0 = 0.0f, sra = 0.0f, srb = 0.0f;
  const uint32_t n = static_cast<uint32_t>(c.n_steps);

#pragma unroll 1  // one step per trip: the loop body is what the bound counts
  for (int i = 0; i < c.n_steps; ++i) {
    float zv, zo;
    if (kS == kPrng) {
      draw_normals_philox(a.seed, block, static_cast<uint32_t>(i), row, col, &zv, &zo);
    } else {
      draw_normals_hash(a.seed, block, static_cast<uint32_t>(i), n, row, col, kRows, kLanes, &zv,
                        &zo);
    }
    float dsa = 0.0f, dsb = 0.0f;
    advance<kLr>(c, xa, va, zv, zo, i, &dsa);
    advance<kLr>(c, xb, vb, -zv, -zo, i, &dsb);
    update_stat<F, kLr>(c, sta, xa, i);
    update_stat<F, kLr>(c, stb, xb, i);
    if (kLr) {
      if (i == 0) {
        zv0 = zv;
        zo0 = zo;
      }
      sra = add(sra, dsa);
      srb = add(srb, dsb);
    }
  }

  const float df_t = expf(mul(-c.rdt, static_cast<float>(c.n_steps)));
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const float x = br == 0 ? xa : xb;
    const float* st = br == 0 ? sta : stb;
    const float p = payoff<F>(c, st, x, df_t);
    acc[0] += p;
    acc[1] += mul(p, p);
    if constexpr (kLr) {
      const float zvs = br == 0 ? zv0 : -zv0;
      const float zos = br == 0 ? zo0 : -zo0;
      const float zxs = add(mul(c.rho, zvs), mul(c.srho, zos));
      // score_v0 = −zv₀·a − zo₀·(b − ρa)/√(1−ρ²) − 1/v0, a = ∂zv₀/∂v0, b = ∂zx₀/∂v0
      const float a_t = sub(c.a_head, mul(zvs, c.half_inv_v0));
      const float b_t = sub(c.b_head, mul(zxs, c.half_inv_v0));
      const float sc_v =
          sub(sub(mul(-zvs, a_t), quo(mul(zos, sub(b_t, mul(c.rho, a_t))), c.srho_g)), c.inv_v0);
      acc[2] += mul(p, zos);
      acc[3] += mul(p, sub(mul(zos, zos), 1.0f));
      acc[4] += mul(mul(p, zos), zvs);
      acc[5] += mul(p, sc_v);
      acc[6] += mul(p, br == 0 ? sra : srb);
      if constexpr (F == kHitAt) acc[7] += st[2];
      if constexpr (F == kAutocall) {  // DR: the carried legs, then the redemption's
        const float t_total = mul(c.dt, static_cast<float>(c.n_steps));
        acc[7] += sub(st[3], mul(mul(mul(st[0], t_total), df_t), autocall_final(c, st, x)));
      }
      if constexpr (F == kLookback) {
        const float f0 = lookback_start_term(c, st[0]);
        acc[7] += f0;
        acc[8] += mul(f0, zos);
      }
    }
  }
}

__device__ Ctx make_ctx(const SlvArgs& a, const float* table) {
  const float* p = a.params;
  Ctx c;
  c.s0 = p[0];
  c.k = p[1];
  c.log_b = p[2];
  c.inv_n = p[3];
  c.rdt = p[4];
  c.dt = p[5];
  c.sqrt_dt = p[6];
  c.mu_dt = p[7];
  c.kappa = p[8];
  c.theta = p[9];
  c.sigma_v = p[10];
  c.rho = p[11];
  c.srho = p[12];
  c.v0 = p[13];
  c.a = p[14];
  c.b = p[15];
  c.c = p[16];
  c.d = p[17];
  c.e = p[18];
  c.cp = a.cp;
  c.mode = a.mode;
  c.period = a.period;
  c.n_steps = a.n_steps;
  c.table = table;
  c.srho_g = fmaxf(c.srho, 1e-4f);
  const float v0g = fmaxf(c.v0, 1e-8f);
  c.inv_v0 = quo(1.0f, v0g);
  c.half_inv_v0 = mul(0.5f, c.inv_v0);
  c.a_head = quo(sub(mul(c.kappa, c.dt), 1.0f), mul(fmaxf(c.sigma_v, 1e-4f), sqrtf(mul(v0g, c.dt))));
  const float l0 = fmaxf(horner(table, 0.0f), 1e-4f);  // the start-state leverage
  c.b_head = quo(mul(l0, c.sqrt_dt), mul(2.0f, sqrtf(v0g)));
  return c;
}

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, its threads striding over the row's 512 lanes.
template <int F, bool kLr, int kS>
__global__ void __launch_bounds__(kThreads) slv_kernel(SlvArgs a) {
  extern __shared__ float table[];  // the (n_steps, 9) step table
  for (int j = threadIdx.x; j < a.n_steps * kRow; j += kThreads) {
    table[j] = a.params[kScalars + j];
  }
  __syncthreads();
  constexpr int kMom = n_moments<F, kLr>();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const Ctx c = make_ctx(a, table);

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
  for (int b = b_begin; b < b_end; ++b) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(b);
    for (int col = threadIdx.x; col < static_cast<int>(kLanes); col += kThreads) {
      simulate_lane<F, kLr, kS>(c, a, block, static_cast<uint32_t>(row),
                                static_cast<uint32_t>(col), acc);
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int F, bool kLr, int kS>
cudaError_t go(const SlvArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.n_steps) * kRow * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slv_kernel<F, kLr, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  slv_kernel<F, kLr, kS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_f(const SlvArgs& a, int sampler, bool lr, cudaStream_t st) {
  if (lr) return sampler == kPrng ? go<F, true, kPrng>(a, st) : go<F, true, kHash>(a, st);
  return sampler == kPrng ? go<F, false, kPrng>(a, st) : go<F, false, kHash>(a, st);
}

cudaError_t launch(const SlvArgs& a, int family, int sampler, bool lr, cudaStream_t st) {
  switch (family) {
    case kAsianArith: return launch_f<kAsianArith>(a, sampler, lr, st);
    case kAsianGeo: return launch_f<kAsianGeo>(a, sampler, lr, st);
    case kLookback: return launch_f<kLookback>(a, sampler, lr, st);
    case kHit: return launch_f<kHit>(a, sampler, lr, st);
    case kHitAt: return launch_f<kHitAt>(a, sampler, lr, st);
    case kCliquet: return launch_f<kCliquet>(a, sampler, lr, st);
    case kAutocall: return launch_f<kAutocall>(a, sampler, lr, st);
    case kRange: return launch_f<kRange>(a, sampler, lr, st);
    default: return launch_f<kEuro>(a, sampler, lr, st);
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom, 128) float32, with `partials`
// (n_mom, 128, n_chunks) float32 as scratch; n_mom is 2 without lr, and with
// lr 9 for the lookback family, 8 for the autocall and pay-at-hit families, 7
// otherwise. `params` holds 19 + 9·n_steps floats.
extern "C" int slv_moments(const void* params, uint32_t seed, uint32_t block0, int n_blocks,
                           int blocks_per_chunk, int n_chunks, int n_steps, int period, float cp,
                           int family, int mode, int sampler, int lr, int n_mom, void* partials,
                           void* out, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 ||
      n_steps > kMaxSteps || period < 1 || family < kAsianArith || family > kEuro ||
      sampler < kPrng || sampler > kHash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the caller sized `partials` and `out` for n_mom moments
  const int expected =
      lr ? (family == kLookback ? 9 : ((family == kHitAt || family == kAutocall) ? 8 : 7)) : 2;
  if (n_mom != expected) return static_cast<int>(cudaErrorInvalidValue);
  SlvArgs a;
  a.params = static_cast<const float*>(params);
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.period = period;
  a.mode = mode;
  a.cp = cp;
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch(a, family, sampler, lr != 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
