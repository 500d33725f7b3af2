// Path-dependent GBM Monte Carlo on Hopper: 23 payoff kinds, likelihood-ratio
// score moments, contract books and the hybrid bridge-QMC sampler.
//
// Replaces the TPU kernel optionslab_tpu/ops/exotic_pallas.py::_exotic_kernel.
// Every lane simulates four antithetic paths (Box–Muller cos/sin × ±) through
// all n_steps, carrying each path's running payoff statistic (sum, log-sum,
// extremum, barrier/touch state, cliquet or autocall state) and, with `lr`,
// the score accumulators (z₁ at step 0, Σz, Σ(z²−1)) per draw stream. For
// every row it returns Σpay, Σpay² and, with `lr`, ΣD1, ΣDG, ΣDZ, ΣD2 (+ΣDR)
// over all its paths; ops/exotic_kernel.py turns them into price, stderr and
// the LR Greek ladder.
//
// What bounds it: instruction issue, then the INT32 pipe. Per lane and step:
// one Box–Muller (logf, sqrtf, sincosf: precise polynomials on the FP32
// pipe, one MUFU.RSQ), two expf of the path update (one per draw stream; the
// antithetic divides by it), the sampler's integer work (4 murmur mixes for
// `hash`, 10 Philox rounds for `prng`), and the statistic update
// (comparisons, a few adds; an expf per branch for the discounted kinds and
// under QMC). ops/sass_bound.py counts the step loop's instructions by pipe
// from the built SASS, and chip_smoke.py prints them beside the kernel's
// time. Device memory is idle: the inputs are 14 + 7·nc floats and the
// outputs O(moments · rows · chunks) floats.
//
// What the design does about it:
//  * Nothing per step touches memory. One thread owns one logical (block,
//    row, col) lane of the reference's (128, 512) counter space at a time and
//    keeps its four paths, their statistics, the scores and the moment sums
//    in registers through the whole time loop.
//  * The counter space is the reference's geometry, so the `hash` and
//    `sobol_bb` path sets are the JAX kernel's own; `prng` is Philox keyed by
//    (seed, salt ^ block) at counter (row, col, step, 0).
//  * Fixed-order reduction (reduce.cuh): no float atomics, and a chunk count
//    that depends only on the geometry.
//  * Precise libm (no --use_fast_math), and every product that feeds a sum
//    of a path value is rounded on its own (__fmul_rn/__fadd_rn: never
//    contracted into an FMA), so each path is bitwise the plain torch
//    version's; near a barrier one ulp would flip an indicator.
//  * Templates: payoff family (9) × lr × sampler (3), 43 instances; the kind
//    within a family, cp, n_steps, period, the bridge plan and every market
//    scalar are runtime arguments, so no market tick recompiles anything.
//    Pay-at-hit touches are a family of their own, so the other barrier
//    kinds' step loop carries no discounting.
//
// C interface for ctypes: pointers and the stream are void*, and the entry
// point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <cstdint>

#include "bridge.cuh"
#include "fp.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr int kLanes = 512;
constexpr int kThreads = 256;
constexpr int kBookSlots = 7;  // K, BARRIER, A, B, C, D, E

// kHit: barriers and touches paid at expiry; kHitAt: touches paid at the
// first hit (their discounting runs in the step loop)
enum Family : int {
  kAsianArith = 0, kAsianGeo, kAsianCv, kLookback, kHit, kHitAt, kCliquet, kAutocall, kRange
};
enum Sampler : int { kPrng = 0, kHash = 1, kSobolBB = 2 };
// barrier/touch families: mode = side | payoff << 2
enum Side : int { kUp = 0, kDown = 1, kDouble = 2 };
enum HitPayoff : int { kKnockOut = 0, kKnockIn = 1, kOneTouch = 2, kNoTouch = 3 };
// lookback family: mode bit 0 floating strike, bit 1 running minimum

struct ExoticArgs {
  const float* params;  // (14,)
  const float* book;    // (nc, 7); contract of a row = row % nc
  int nc;
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps, period, mode;
  float cp;
  bridge::Plan plan;
  float* partials;  // (n_mom, 128, n_chunks)
};

using fp::add;
using fp::ind;
using fp::mul;
using fp::quo;
using fp::sub;

struct Ctx {
  float s0, inv_s0, drift_dt, vsd, inv_n, growth, rdt, dt;
  float k, barrier, a, b, c, d, e, cp;
  int mode, period, n_steps;
};

template <int F, bool kLr>
__host__ __device__ constexpr int n_moments() {
  return kLr ? ((F == kHitAt || F == kAutocall) ? 7 : 6) : 2;
}

__device__ __forceinline__ float hit_now(const Ctx& c, float s) {
  const int side = c.mode & 3;
  if (side == kDouble) return ind(s <= c.a || s >= c.b);
  return ind(side == kUp ? s >= c.barrier : s <= c.barrier);
}

// statistics seeded from the price-space start S0
template <int F>
__device__ __forceinline__ void init_stat(const Ctx& c, float* st) {
  st[0] = st[1] = st[2] = st[3] = 0.0f;
  if (F == kAsianArith || F == kAsianCv || F == kLookback || F == kCliquet) st[0] = c.s0;
  if (F == kAutocall) st[0] = 1.0f;  // (alive, knocked in, pv, ∂pv/∂r)
  if (F == kHit || F == kHitAt) st[0] = st[1] = hit_now(c, c.s0);  // (hit, pv at hit, ∂pv/∂r)
}

template <int F, bool kLr>
__device__ __forceinline__ void update_stat(const Ctx& c, float* st, float s, int i) {
  if (F == kAsianArith || F == kAsianGeo) {
    st[0] = add(st[0], s);
  } else if (F == kAsianCv) {
    st[0] = add(st[0], s);
    st[1] = add(st[1], logf(mul(s, c.inv_s0)));
  } else if (F == kLookback) {
    st[0] = (c.mode & 2) ? fminf(st[0], s) : fmaxf(st[0], s);
  } else if (F == kHit) {
    st[0] = fmaxf(st[0], hit_now(c, s));
  } else if (F == kHitAt) {
    const float now = hit_now(c, s);
    const float newly = mul(sub(1.0f, st[0]), now);
    const float steps = static_cast<float>(i + 1);
    const float df_i = expf(mul(-c.rdt, steps));
    st[1] = add(st[1], mul(newly, df_i));
    if (kLr) st[2] = sub(st[2], mul(mul(mul(steps, c.dt), newly), df_i));
    st[0] = fmaxf(st[0], now);
  } else if (F == kCliquet) {
    const float is_end = ind((i + 1) % c.period == 0);
    const float capped = fminf(fmaxf(sub(quo(s, st[0]), 1.0f), c.a), c.b);
    st[1] = add(st[1], mul(is_end, capped));
    st[0] = add(st[0], mul(is_end, sub(s, st[0])));
  } else if (F == kAutocall) {
    st[1] = fmaxf(st[1], ind(s <= c.c));
    const float is_obs = ind((i + 1) % c.period == 0);
    const float df_i = expf(mul(-c.rdt, static_cast<float>(i + 1)));
    const float called = mul(mul(st[0], is_obs), ind(s >= c.a));
    const float couponed = mul(mul(st[0], is_obs), ind(s >= c.b));
    const float cash = add(mul(c.d, couponed), mul(c.e, called));
    st[2] = add(st[2], mul(df_i, cash));
    st[0] = mul(st[0], sub(1.0f, called));
    if (kLr) {
      const float t_i = mul(c.dt, static_cast<float>(i + 1));
      st[3] = sub(st[3], mul(mul(t_i, df_i), cash));
    }
  } else {  // kRange
    st[0] = add(st[0], ind(s >= c.a && s <= c.b));
  }
}

template <int F>
__device__ __forceinline__ float payoff(const Ctx& c, const float* st, float s_t) {
  if (F == kAsianArith || F == kAsianCv) {
    const float avg = mul(sub(st[0], c.s0), c.inv_n);
    const float pay = fmaxf(mul(c.cp, sub(avg, c.k)), 0.0f);
    if (F == kAsianArith) return pay;
    const float geo_avg = mul(c.s0, expf(mul(st[1], c.inv_n)));
    return sub(pay, fmaxf(mul(c.cp, sub(geo_avg, c.k)), 0.0f));
  } else if (F == kAsianGeo) {
    const float avg = mul(c.s0, expf(mul(st[0], c.inv_n)));
    return fmaxf(mul(c.cp, sub(avg, c.k)), 0.0f);
  } else if (F == kLookback) {
    if (c.mode & 1) return c.cp > 0.0f ? sub(s_t, st[0]) : sub(st[0], s_t);
    return fmaxf(mul(c.cp, sub(st[0], c.k)), 0.0f);
  } else if (F == kHitAt) {
    return st[1];
  } else if (F == kHit) {
    const int pay = c.mode >> 2;
    if (pay == kOneTouch) return st[0];
    if (pay == kNoTouch) return sub(1.0f, st[0]);
    const float vanilla = fmaxf(mul(c.cp, sub(s_t, c.k)), 0.0f);
    return mul(vanilla, pay == kKnockIn ? st[0] : sub(1.0f, st[0]));
  } else if (F == kCliquet) {
    return mul(c.e, fminf(fmaxf(st[1], c.c), c.d));
  } else if (F == kAutocall) {
    const float df_t = expf(mul(-c.rdt, static_cast<float>(c.n_steps)));
    const float loss = fmaxf(sub(1.0f, quo(s_t, c.s0)), 0.0f);
    const float final_pay = mul(c.e, sub(1.0f, mul(st[1], loss)));
    return add(st[2], mul(mul(st[0], df_t), final_pay));
  } else {  // kRange
    return mul(mul(c.e, st[0]), c.inv_n);
  }
}

// The four paths of one (block, row, col) lane through all steps; adds the
// lane's moment terms into acc.
template <int F, bool kLr, int kS>
__device__ __forceinline__ void simulate_lane(const Ctx& c, const ExoticArgs& a, uint32_t block,
                                              uint32_t row, uint32_t col, float* acc) {
  constexpr bool kQmc = kS == kSobolBB;
  constexpr bool kLog = kQmc || F == kAsianGeo;  // relative log-spots, additive updates
  float x[4], st[4][4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    x[b] = kLog ? 0.0f : c.s0;
    init_stat<F>(c, st[b]);
  }
  float zf1 = 0.0f, zf2 = 0.0f, sz1 = 0.0f, sz2 = 0.0f, szz1 = 0.0f, szz2 = 0.0f;

  auto draw = [&](int i, float* z1, float* z2) {
    if (kS == kPrng) {
      draw_normals_philox(a.seed, block, static_cast<uint32_t>(i), row, col, z1, z2);
    } else {  // hash, and the QMC residuals
      draw_normals_hash(a.seed, block, static_cast<uint32_t>(i),
                        static_cast<uint32_t>(c.n_steps), row, col, kRows, kLanes, z1, z2);
    }
  };
  auto step = [&](int i, float z0, float z1, float z2, float z3) {  // the four paths' normals
    if (kQmc) {  // conditional-law residuals pinned to the bridge targets
      x[0] = add(add(x[0], c.drift_dt), mul(c.vsd, z0));
      x[1] = add(add(x[1], c.drift_dt), mul(c.vsd, z1));
      x[2] = add(add(x[2], c.drift_dt), mul(c.vsd, z2));
      x[3] = add(add(x[3], c.drift_dt), mul(c.vsd, z3));
    } else if (kLog) {  // z1 = −z0, z3 = −z2
      x[0] = add(add(x[0], c.drift_dt), mul(c.vsd, z0));
      x[1] = sub(add(x[1], c.drift_dt), mul(c.vsd, z0));
      x[2] = add(add(x[2], c.drift_dt), mul(c.vsd, z2));
      x[3] = sub(add(x[3], c.drift_dt), mul(c.vsd, z2));
    } else {  // the antithetic shares the exponential: e^{-s·z} = 1/e^{s·z}
      const float w1 = expf(mul(c.vsd, z0));
      const float w2 = expf(mul(c.vsd, z2));
      x[0] = mul(x[0], mul(c.growth, w1));
      x[1] = quo(mul(x[1], c.growth), w1);
      x[2] = mul(x[2], mul(c.growth, w2));
      x[3] = quo(mul(x[3], c.growth), w2);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float s = (kQmc && F != kAsianGeo) ? mul(c.s0, expf(x[b])) : x[b];
      update_stat<F, kLr>(c, st[b], s, i);
    }
    if (kLr) {  // never with the bridge
      if (i == 0) {
        zf1 = z0;
        zf2 = z2;
      }
      sz1 = add(sz1, z0);
      sz2 = add(sz2, z2);
      szz1 = sub(add(szz1, mul(z0, z0)), 1.0f);
      szz2 = sub(add(szz2, mul(z2, z2)), 1.0f);
    }
  };

  if constexpr (kQmc) {  // both residual streams pinned to the one stream's targets
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

  const float zf[4] = {zf1, -zf1, zf2, -zf2};
  const float sz[4] = {sz1, -sz1, sz2, -sz2};
  const float szz[4] = {szz1, szz1, szz2, szz2};
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float s_t = kLog ? mul(c.s0, expf(x[b])) : x[b];
    const float p = payoff<F>(c, st[b], s_t);
    acc[0] += p;
    acc[1] += p * p;
    if constexpr (kLr) {
      acc[2] += mul(p, zf[b]);
      acc[3] += mul(p, sub(mul(zf[b], zf[b]), 1.0f));
      acc[4] += mul(p, sz[b]);
      acc[5] += mul(p, szz[b]);
      if constexpr (F == kHitAt) acc[6] += st[b][2];
      if constexpr (F == kAutocall) {  // explicit ∂pv/∂r: coupons, then the final redemption
        const float df_t = expf(mul(-c.rdt, static_cast<float>(c.n_steps)));
        const float loss = fmaxf(sub(1.0f, quo(x[b], c.s0)), 0.0f);
        const float final_pay = mul(c.e, sub(1.0f, mul(st[b][1], loss)));
        const float t_end = mul(c.dt, static_cast<float>(c.n_steps));
        acc[6] += sub(st[b][3], mul(mul(mul(t_end, df_t), st[b][0]), final_pay));
      }
    }
  }
}

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, its threads striding over the row's 512 lanes.
template <int F, bool kLr, int kS>
__global__ void __launch_bounds__(kThreads) exotic_mc_kernel(ExoticArgs a) {
  constexpr int kMom = n_moments<F, kLr>();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);

  Ctx c;
  const float* p = a.params;
  c.s0 = p[0];
  c.inv_s0 = quo(1.0f, c.s0);
  c.drift_dt = p[2];
  c.vsd = p[3];
  c.inv_n = p[5];
  c.growth = p[6];
  c.rdt = p[7];
  c.dt = mul(p[8], p[8]);
  const float* bk = a.book + (row % a.nc) * kBookSlots;
  c.k = bk[0];
  c.barrier = bk[1];
  c.a = bk[2];
  c.b = bk[3];
  c.c = bk[4];
  c.d = bk[5];
  c.e = bk[6];
  c.cp = a.cp;
  c.mode = a.mode;
  c.period = a.period;
  c.n_steps = a.n_steps;

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
  for (int b = b_begin; b < b_end; ++b) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(b);
    for (int col = threadIdx.x; col < kLanes; col += kThreads) {
      simulate_lane<F, kLr, kS>(c, a, block, static_cast<uint32_t>(row),
                                static_cast<uint32_t>(col), acc);
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int F, int kS>
void launch_fs(const ExoticArgs& a, bool lr, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  if constexpr (kS != kSobolBB && F != kAsianCv) {  // the only families and samplers with lr
    if (lr) {
      exotic_mc_kernel<F, true, kS><<<grid, kThreads, 0, stream>>>(a);
      return;
    }
  }
  exotic_mc_kernel<F, false, kS><<<grid, kThreads, 0, stream>>>(a);
}

template <int F>
void launch_f(const ExoticArgs& a, int sampler, bool lr, cudaStream_t stream) {
  switch (sampler) {
    case kPrng: launch_fs<F, kPrng>(a, lr, stream); break;
    case kHash: launch_fs<F, kHash>(a, lr, stream); break;
    default: launch_fs<F, kSobolBB>(a, lr, stream); break;
  }
}

void launch(const ExoticArgs& a, int family, int sampler, bool lr, cudaStream_t stream) {
  switch (family) {
    case kAsianArith: launch_f<kAsianArith>(a, sampler, lr, stream); break;
    case kAsianGeo: launch_f<kAsianGeo>(a, sampler, lr, stream); break;
    case kAsianCv: launch_f<kAsianCv>(a, sampler, lr, stream); break;
    case kLookback: launch_f<kLookback>(a, sampler, lr, stream); break;
    case kHit: launch_f<kHit>(a, sampler, lr, stream); break;
    case kHitAt: launch_f<kHitAt>(a, sampler, lr, stream); break;
    case kCliquet: launch_f<kCliquet>(a, sampler, lr, stream); break;
    case kAutocall: launch_f<kAutocall>(a, sampler, lr, stream); break;
    default: launch_f<kRange>(a, sampler, lr, stream); break;
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom, 128) float32, with `partials`
// (n_mom, 128, n_chunks) float32 as scratch. `plan_i` (32 ints) and `plan_f`
// (23 floats) are host arrays: the sobol_bb bridge plan (zeros otherwise).
extern "C" int exotic_mc_moments(const void* params, const void* book, int nc, uint32_t seed,
                                 uint32_t block0, int n_blocks, int blocks_per_chunk,
                                 int n_chunks, int n_steps, int period, float cp, int family,
                                 int mode, int sampler, int lr, int n_mom, const int* plan_i,
                                 const float* plan_f, void* partials, void* out, int device,
                                 void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 || period < 1 ||
      nc < 1 || nc > kRows || kRows % nc != 0 || family < kAsianArith || family > kRange ||
      sampler < kPrng || sampler > kSobolBB || plan_i[0] > 8 || plan_i[10] > 7 ||
      (lr && (sampler == kSobolBB || family == kAsianCv))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the caller sized `partials` and `out` for n_mom moments
  const int expected = lr ? ((family == kHitAt || family == kAutocall) ? 7 : 6) : 2;
  if (n_mom != expected) return static_cast<int>(cudaErrorInvalidValue);
  ExoticArgs a;
  a.params = static_cast<const float*>(params);
  a.book = static_cast<const float*>(book);
  a.nc = nc;
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.period = period;
  a.mode = mode;
  a.cp = cp;
  a.plan = bridge::load_plan(plan_i, plan_f);
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch(a, family, sampler, lr != 0, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
