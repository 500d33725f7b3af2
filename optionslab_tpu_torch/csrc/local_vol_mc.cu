// Local-volatility (Dupire) Monte Carlo on Hopper: 20 payoffs, the hybrid
// bridge-QMC sampler and a one-pass likelihood-ratio delta/gamma/vega.
//
// Replaces the TPU kernel optionslab_tpu/ops/local_vol_pallas.py::_lv_kernel.
// Every lane of the reference's (128, 512) counter space carries four
// antithetic log-Euler paths (z1, −z1, z2, −z2) through all n_steps:
// x += μdt − ½σ²dt + σ√dt·z with σ = max(Horner6(clip(x, x_lo_i, x_hi_i)), 1e-4)
// from step i's row [x_lo, x_hi, c6..c0] of the host-fitted table
// (ops/local_vol_kernel.py::fit_sigma_polys), and each path's running
// statistic (Asian spot sum, range counter, extremum of x, barrier/touch
// flags, the discounted pay-at-hit cash). For every row it returns Σpay, Σpay²
// and, with `greeks`, Σpay·z1, Σpay·(z1²−1), Σpay·vscore (+Σb0, Σb0·z1 for the
// lookbacks); ops/local_vol_kernel.py turns them into price, stderr and the
// sticky-strike delta/gamma and parallel-shift vega.
//
// What bounds it: instruction issue. Per lane and step: one Box–Muller (logf,
// sqrtf, sincosf: the one MUFU.RSQ of the trip), the sampler's integer work
// (4 murmur mixes for `hash`, 10 Philox rounds for `prng`), four degree-6
// Horner evaluations (σ has no root), the four path updates and the
// statistic updates (an expf per path for the Asian, one per step for the
// pay-at-hit discount), and with `greeks` a divide by σ per path.
// ops/sass_bound.py counts the step loop from the built SASS and
// chip_smoke.py prints the counts beside the kernel's time. Device memory is
// idle: 8 + 9·n_steps floats in, O(moments · rows · chunks) floats out.
//
// What the design does about it:
//  * The step table is staged in shared memory once per CUDA block; the step
//    index is warp-uniform, so every coefficient read is a broadcast.
//  * Nothing per step touches global memory: one thread owns one (block,
//    row, col) lane at a time and keeps its four paths, statistics, scores and
//    moment sums in registers through the whole time loop.
//  * The counter space is the reference's, so the `hash` path set and the
//    `sobol_bb` bridge (8 dyadic levels, hash residuals, the exotic GBM
//    kernel's construction in bridge.cuh with the scramble salt 0x632BE5AB)
//    are the JAX kernel's own; `prng` is Philox keyed by (seed, salt ^
//    block) at counter (row, col, step, 0).
//  * Fixed-order reduction (reduce.cuh): no float atomics.
//  * Precise libm, every product that feeds a path value rounded on its own
//    (__fmul_rn/__fadd_rn, never an FMA) in the reference's association order,
//    Horner included, so each path is bitwise the plain torch version's; near
//    a barrier one ulp would flip an indicator.
//  * Templates: statistic family (6) × greeks × sampler (prng, hash, bridge;
//    the bridge without greeks), 30 instances. cp, the barrier side and
//    in/out, one-/no-touch, n_steps, the bridge plan and every market scalar
//    are runtime arguments: no tick recompiles.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "bridge.cuh"
#include "exotic_stats.cuh"
#include "fp.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr uint32_t kLanes = 512;
constexpr int kThreads = 256;
constexpr int kScalars = 8;  // S0, K, μ·dt, dt, √dt, barrier/lower, upper, r·dt
constexpr int kDegree = 6;
constexpr int kRow = kDegree + 3;  // x_lo, x_hi, c6..c0
constexpr int kMaxSteps = 6000;    // 9·6000 floats of shared memory

// kHit: barriers and touches paid at expiry; kHitAt: one-touches paid at the
// first hit (their discounting runs in the step loop)
enum Family : int { kEuro = 0, kAsian, kRange, kLookback, kHit, kHitAt };
enum Sampler : int { kPrng = 0, kHash = 1, kBridge = 2 };
// barrier/touch families: mode = side | payoff << 2 (exotic_stats.cuh);
// lookback: bit 0 floating strike, bit 1 running minimum
using fp::add;
using fp::ind;
using fp::mul;
using fp::quo;
using fp::sub;
using stats::hit_now;
using stats::kKnockIn;
using stats::kNoTouch;
using stats::kOneTouch;
using stats::lookback_start_term;

struct LvArgs {
  const float* __restrict__ params;  // 8 scalars, then the (n_steps, 9) step table
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps, mode;
  float cp;
  bridge::Plan plan;
  float* partials;  // (n_mom, 128, n_chunks)
};

struct Ctx {
  float s0, k, mu_dt, dt, sqdt;
  float log_b, a, b;  // the barrier; the band of a double barrier or the range
  float rdt, cp, inv_n;
  int mode, n_steps;
  const float* table;  // shared memory
};

template <int F, bool kGreeks>
__host__ __device__ constexpr int n_moments() {
  return kGreeks ? (F == kLookback ? 7 : 5) : 2;
}

// σ of step i at x: Horner over the step's coefficients at x clamped to the
// step's band, highest degree first, floored at 1e-4
__device__ __forceinline__ float sigma(const Ctx& c, float x, int i) {
  const float* r = c.table + i * kRow;
  const float xc = fminf(fmaxf(x, r[0]), r[1]);
  float acc = r[2];
#pragma unroll
  for (int j = 1; j <= kDegree; ++j) acc = add(mul(acc, xc), r[2 + j]);
  return fmaxf(acc, 1e-4f);
}

// statistics at x0 = 0 (S0 included: a level already crossed counts as hit)
template <int F>
__device__ __forceinline__ void init_stat(const Ctx& c, float* st) {
  st[0] = st[1] = 0.0f;
  if (F == kHit || F == kHitAt) st[0] = st[1] = hit_now(c, 0.0f);  // (hit, pv at the hit)
}

template <int F>
__device__ __forceinline__ void update_stat(const Ctx& c, float* st, float x, int i) {
  if (F == kAsian) {
    st[0] = add(st[0], mul(c.s0, expf(x)));
  } else if (F == kRange) {  // corridor [lower, upper] in relative log space
    st[0] = add(st[0], ind(x >= c.a && x <= c.b));
  } else if (F == kLookback) {
    st[0] = (c.mode & 2) ? fminf(st[0], x) : fmaxf(st[0], x);
  } else if (F == kHit) {
    st[0] = fmaxf(st[0], hit_now(c, x));
  } else if (F == kHitAt) {
    const float now = hit_now(c, x);
    const float df_i = expf(mul(-c.rdt, static_cast<float>(i + 1)));
    st[1] = add(st[1], mul(mul(sub(1.0f, st[0]), now), df_i));
    st[0] = fmaxf(st[0], now);
  }
}

template <int F>
__device__ __forceinline__ float payoff(const Ctx& c, const float* st, float x) {
  if (F == kAsian) {
    return fmaxf(mul(c.cp, sub(mul(st[0], c.inv_n), c.k)), 0.0f);
  } else if (F == kRange) {  // accrual fraction on unit notional
    return mul(st[0], c.inv_n);
  } else if (F == kLookback) {
    const float ext = mul(c.s0, expf(st[0]));
    if (c.mode & 1) {
      const float s_t = mul(c.s0, expf(x));
      return c.cp > 0.0f ? sub(s_t, ext) : sub(ext, s_t);
    }
    return fmaxf(mul(c.cp, sub(ext, c.k)), 0.0f);
  } else if (F == kHit) {
    const int pay = c.mode >> 2;
    if (pay == kOneTouch) return st[0];
    if (pay == kNoTouch) return sub(1.0f, st[0]);
    const float vanilla = fmaxf(mul(c.cp, sub(mul(c.s0, expf(x)), c.k)), 0.0f);
    return mul(vanilla, pay == kKnockIn ? st[0] : sub(1.0f, st[0]));
  } else if (F == kHitAt) {
    return st[1];  // discounted at the hit in the kernel
  } else {  // kEuro
    return fmaxf(mul(c.cp, sub(mul(c.s0, expf(x)), c.k)), 0.0f);
  }
}

// The four paths of one (block, row, col) lane through all steps; adds the
// lane's moment terms into acc.
template <int F, bool kGreeks, int kS>
__device__ __forceinline__ void simulate_lane(const Ctx& c, const LvArgs& a, uint32_t block,
                                              uint32_t row, uint32_t col, float* acc) {
  float x[4], st[4][2], gvs[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    x[b] = 0.0f;
    gvs[b] = 0.0f;
    init_stat<F>(c, st[b]);
  }
  float gz1 = 0.0f, gz2 = 0.0f;

  auto draw = [&](int i, float* z1, float* z2) {
    if (kS == kPrng) {
      draw_normals_philox(a.seed, block, static_cast<uint32_t>(i), row, col, z1, z2);
    } else {  // hash, and the bridge's residuals
      draw_normals_hash(a.seed, block, static_cast<uint32_t>(i),
                        static_cast<uint32_t>(c.n_steps), row, col, kRows, kLanes, z1, z2);
    }
  };
  auto step = [&](int i, float z0, float z1, float z2, float z3) {  // the four paths' normals
    const float zs[4] = {z0, z1, z2, z3};
    if (kGreeks && i == 0) {
      gz1 = z0;
      gz2 = z2;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float sig = sigma(c, x[b], i);
      const float z = zs[b];
      if (kGreeks) gvs[b] = sub(add(gvs[b], quo(sub(mul(z, z), 1.0f), sig)), mul(z, c.sqdt));
      x[b] = add(sub(add(x[b], c.mu_dt), mul(mul(mul(0.5f, sig), sig), c.dt)),
                 mul(mul(sig, c.sqdt), z));
      update_stat<F>(c, st[b], x[b], i);
    }
  };

  if constexpr (kS == kBridge) {  // both residual streams pinned to the one stream's targets
    float csum[9];
    bridge::targets(a.plan, a.seed, kHashSalt, block, row, col, kRows, kLanes, csum);
    bridge::replay(a.plan, csum, csum, draw,
                   [&](int i, float z1a, float z2a, float z1b, float z2b) {
                     step(i, z1a, z1b, z2a, z2b);
                   });
  } else {
#pragma unroll 1  // one step per trip: the loop body is what the bound counts
    for (int i = 0; i < c.n_steps; ++i) {
      float z1, z2;
      draw(i, &z1, &z2);
      step(i, z1, -z1, z2, -z2);
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float p = payoff<F>(c, st[b], x[b]);
    acc[0] += p;
    acc[1] += mul(p, p);
    if constexpr (kGreeks) {
      const float z1b = b < 2 ? gz1 : gz2;
      const float zs1 = (b & 1) ? -z1b : z1b;  // the path's first-step normal
      acc[2] += mul(p, zs1);
      acc[3] += mul(p, sub(mul(z1b, z1b), 1.0f));
      acc[4] += mul(p, gvs[b]);
      if constexpr (F == kLookback) {
        const float f0 = lookback_start_term(c, st[b][0]);
        acc[5] += f0;
        acc[6] += mul(f0, zs1);
      }
    }
  }
}

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, its threads striding over the row's 512 lanes.
template <int F, bool kGreeks, int kS>
__global__ void __launch_bounds__(kThreads) local_vol_kernel(LvArgs a) {
  extern __shared__ float table[];  // the (n_steps, 9) step table
  for (int j = threadIdx.x; j < a.n_steps * kRow; j += kThreads) {
    table[j] = a.params[kScalars + j];
  }
  __syncthreads();
  constexpr int kMom = n_moments<F, kGreeks>();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const float* p = a.params;
  const Ctx c{p[0], p[1], p[2], p[3], p[4], p[5], p[5], p[6], p[7], a.cp,
              static_cast<float>(1.0 / static_cast<double>(a.n_steps)), a.mode, a.n_steps,
              table};

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
  for (int b = b_begin; b < b_end; ++b) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(b);
    for (int col = threadIdx.x; col < static_cast<int>(kLanes); col += kThreads) {
      simulate_lane<F, kGreeks, kS>(c, a, block, static_cast<uint32_t>(row),
                                    static_cast<uint32_t>(col), acc);
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int F, bool kGreeks, int kS>
cudaError_t go(const LvArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.n_steps) * kRow * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(local_vol_kernel<F, kGreeks, kS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  local_vol_kernel<F, kGreeks, kS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_f(const LvArgs& a, int sampler, bool greeks, cudaStream_t st) {
  if (greeks) return sampler == kPrng ? go<F, true, kPrng>(a, st) : go<F, true, kHash>(a, st);
  if (sampler == kPrng) return go<F, false, kPrng>(a, st);
  if (sampler == kHash) return go<F, false, kHash>(a, st);
  return go<F, false, kBridge>(a, st);
}

cudaError_t launch(const LvArgs& a, int family, int sampler, bool greeks, cudaStream_t st) {
  switch (family) {
    case kEuro: return launch_f<kEuro>(a, sampler, greeks, st);
    case kAsian: return launch_f<kAsian>(a, sampler, greeks, st);
    case kRange: return launch_f<kRange>(a, sampler, greeks, st);
    case kLookback: return launch_f<kLookback>(a, sampler, greeks, st);
    case kHit: return launch_f<kHit>(a, sampler, greeks, st);
    default: return launch_f<kHitAt>(a, sampler, greeks, st);
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom, 128) float32, with `partials`
// (n_mom, 128, n_chunks) float32 as scratch; n_mom is 2 without greeks, 7
// with greeks for the lookback family, 5 otherwise. `params` holds 8 + 9·n_steps
// floats. `plan_i` (32 ints) and `plan_f` (23 floats) are host arrays: the
// sobol_bb bridge plan (zeros otherwise).
extern "C" int local_vol_moments(const void* params, uint32_t seed, uint32_t block0, int n_blocks,
                                 int blocks_per_chunk, int n_chunks, int n_steps, float cp,
                                 int family, int mode, int sampler, int greeks, int n_mom,
                                 const int* plan_i, const float* plan_f, void* partials, void* out,
                                 int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 ||
      n_steps > kMaxSteps || family < kEuro || family > kHitAt || sampler < kPrng ||
      sampler > kBridge || (sampler == kBridge && (greeks || n_steps < 2)) || plan_i[0] > 8 ||
      plan_i[10] > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the caller sized `partials` and `out` for n_mom moments
  const int expected = greeks ? (family == kLookback ? 7 : 5) : 2;
  if (n_mom != expected) return static_cast<int>(cudaErrorInvalidValue);
  LvArgs a;
  a.params = static_cast<const float*>(params);
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.mode = mode;
  a.cp = cp;
  a.plan = bridge::load_plan(plan_i, plan_f);
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch(a, family, sampler, greeks != 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
