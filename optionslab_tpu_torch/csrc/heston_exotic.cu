// Path-dependent payoffs under Heston and Bates on Hopper: 22 payoff kinds,
// Euler or Andersen QE, compound-Poisson jumps, one-pass likelihood-ratio
// Greek ladders and contract books.
//
// Replaces the TPU kernel
// optionslab_tpu/ops/heston_pallas.py::_heston_exotic_kernel. Every lane of
// the reference's (128, 512) counter space simulates one antithetic pair of
// (log-spot, variance) paths through all n_steps, carrying each path's
// running payoff statistic in relative-log space (Asian sum of e^x or of x,
// extremum of x, barrier/touch state, cliquet, autocall or range-accrual
// state) and, with `lr`, the joint-density scores: zv₀ and zo₀ of step 0 and
// each branch's Σ rate score and Σ maturity score. For every row it returns
// Σpay, Σpay² and, with `lr`, ΣD1, ΣDG, ΣDV, ΣSR, ΣTS (+ΣDR for the autocall
// and the pay-at-hit touches); ops/heston_exotic_kernel.py turns them into
// price, stderr and the Greek ladder.
//
// What bounds it: instruction issue. Per lane and step: one Box–Muller
// (logf, sqrtf, sincosf), two sqrtf(v⁺) of the Euler step (QE: three roots,
// a logf and five divides per branch, and a second draw), the sampler's
// integer work (4 murmur mixes for `hash`, 10 Philox rounds for `prng`), the
// statistic update (an expf per branch for the arithmetic Asian, the cliquet
// and the discounted kinds) and, with `lr`, the two branches' scores (a
// sqrtf, four divides each); with jumps one more draw (a Philox call or three
// hash uniforms, a logf, a cosf and a sqrtf). ops/sass_bound.py counts the
// step loop from the built SASS (three MUFU.RSQ per Euler trip) and
// chip_smoke.py prints the counts beside the kernel's time. Device memory is
// idle: at most 29 + 7·nc floats in, O(moments · rows · chunks) floats out.
//
// What the design does about it:
//  * Nothing per step touches memory. One thread owns one (block, row, col)
//    lane at a time and keeps its pair, the statistics, the scores and the
//    moment sums in registers through the whole time loop.
//  * The counter space is the reference's, so the `hash` and `sobol_bb` path
//    sets are the JAX kernel's own; `prng` is Philox keyed by (seed, salt ^
//    block): the normals on stream 0, the QE uniform on stream 1, the jump
//    draw on stream 2.
//  * The Euler step is heston_euler.cuh's (the European kernels'), the QE
//    step heston_qe.cuh's, the bridge bridge.cuh's, the statistics and
//    payoffs exotic_stats.cuh's (the SLV kernel's too).
//  * Fixed-order reduction (reduce.cuh): no float atomics.
//  * Precise libm, every product that feeds a path value rounded on its own
//    (__fmul_rn/__fadd_rn, never an FMA) in the reference's association
//    order, so each path is bitwise the plain torch version's; near a barrier
//    one ulp would flip an indicator.
//  * Templates: payoff family (8) × lr × scheme × sampler, 56 instances (lr
//    is Euler with prng/hash only; QE takes prng/hash; `sobol_bb` is the
//    Euler price). The kind within a family, cp, n_steps, the period, the
//    jumps (a grid-uniform branch), the bridge plan, the book and every
//    market and model scalar are runtime arguments: no tick recompiles.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "bridge.cuh"
#include "exotic_stats.cuh"
#include "heston_euler.cuh"
#include "heston_qe.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr uint32_t kLanes = 512;
constexpr int kThreads = 256;
constexpr int kBookSlots = 7;  // K, log(B/S0), A, B, C, D, E
constexpr int kHead = 12;      // S0, K, log(B/S0), 1/n, r·dt, dt, √dt, A, B, C, D, E

enum Scheme : int { kEuler = 0, kQe = 1 };
enum Sampler : int { kPrng = 0, kHash = 1, kSobolBB = 2 };

using namespace stats;  // the families, their statistics and payoffs
using heston::add;
using heston::mul;
using heston::quo;
using heston::sub;

struct HxArgs {
  const float* __restrict__ params;  // head, scheme tail[, jump tail]
  const float* __restrict__ book;    // (nc, 7); contract of a row = row % nc
  int nc;
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps, period, mode, jumps;
  float cp;
  bridge::Plan plan;
  float* partials;  // (n_mom, 128, n_chunks)
};

struct Ctx {
  float s0, inv_n, rdt, dt, sqrt_dt, cp;
  float k, log_b, a, b, c, d, e;  // the row's contract
  int mode, period, n_steps;
  heston::StepCoeffs step;  // Euler: drift = μ·dt, dt, √dt, κ, θ, σ_v
  float rho, srho, v0;
  float qe[10];  // QE: mu_dt, emkd, c1, s2_v, s2_0, k0..k4
  bool jumps;
  float thr0, thr1, thr2, mu_j, sigma_j, lam;
  // LR constants: max(√(1−ρ²), 1e-4), μ·dt/dt, 2·dt, and the step-0 v0-score terms
  float srho_g, mu_over_dt, two_dt, inv_v0, half_inv_v0, a_head, b_head;
};

template <int F, bool kLr>
__host__ __device__ constexpr int n_moments() {
  return kLr ? ((F == kHitAt || F == kAutocall) ? 8 : 7) : 2;
}

// One branch's step scores at fixed endpoints, gated where v⁺ = 0: the rate
// score ds = zo·dt/(√(v⁺dt)·√(1−ρ²)) and the maturity score ts =
// zv·κ(θ−v⁺)/(σ√(v⁺dt)) + zo·[(μ − v⁺/2) − ρκ(θ−v⁺)/σ]/(√(1−ρ²)√(v⁺dt)) +
// (zv² + zo² − 2)/(2dt).
__device__ __forceinline__ void lr_scores(const Ctx& c, float v, float zv, float zo, float* ds,
                                          float* ts) {
  const float ind_v = v > 0.0f ? 1.0f : 0.0f;
  const float vp = mul(v, ind_v);
  const float sq = sqrtf(vp);
  const float inv_sqvdt = quo(ind_v, mul(fmaxf(sq, 1e-6f), c.sqrt_dt));
  *ds = quo(mul(mul(zo, c.dt), inv_sqvdt), c.srho_g);
  const float kth = mul(c.step.kappa, sub(c.step.theta, vp));
  const float t1 = mul(quo(mul(zv, kth), c.step.sigma_v), inv_sqvdt);
  const float drift = sub(sub(c.mu_over_dt, mul(0.5f, vp)), quo(mul(c.rho, kth), c.step.sigma_v));
  const float t2 = quo(mul(mul(zo, drift), inv_sqvdt), c.srho_g);
  const float t3 = quo(mul(ind_v, sub(add(mul(zv, zv), mul(zo, zo)), 2.0f)), c.two_dt);
  *ts = add(add(t1, t2), t3);
}

// The pair of one (block, row, col) lane through all steps; adds the lane's
// moment terms into acc.
template <int F, bool kLr, int kSch, int kS>
__device__ __forceinline__ void simulate_lane(const Ctx& c, const HxArgs& a, uint32_t block,
                                              uint32_t row, uint32_t col, float* acc) {
  constexpr bool kHashDraws = kS != kPrng;  // hash, and the QMC residuals
  float xa = 0.0f, xb = 0.0f, va = c.v0, vb = c.v0;
  float sta[4], stb[4];
  init_stat<F>(c, sta);
  init_stat<F>(c, stb);
  float zv0 = 0.0f, zo0 = 0.0f, sra = 0.0f, srb = 0.0f, tta = 0.0f, ttb = 0.0f;
  const uint32_t n = static_cast<uint32_t>(c.n_steps);

  auto draw = [&](int i, float* zv, float* zo) {
    if (kHashDraws) {
      draw_normals_hash(a.seed, block, static_cast<uint32_t>(i), n, row, col, kRows, kLanes, zv,
                        zo);
    } else {
      draw_normals_philox(a.seed, block, static_cast<uint32_t>(i), row, col, zv, zo);
    }
  };
  auto step = [&](int i, float zva, float zoa, float zvb, float zob) {
    const uint32_t ui = static_cast<uint32_t>(i);
    float dsa = 0.0f, dsb = 0.0f, tsa = 0.0f, tsb = 0.0f;
    if constexpr (kSch == kQe) {  // the spot shock is the independent normal zo
      const float u = kHashDraws ? draw_uniform_hash(a.seed, block, ui, n, row, col, kRows, kLanes)
                                 : draw_uniform_philox(a.seed, block, ui, row, col);
      heston::qe_advance(c.qe, xa, va, zva, zoa, u);
      heston::qe_advance(c.qe, xb, vb, zvb, zob, sub(1.0f, u));
    } else {
      if constexpr (kLr) {
        lr_scores(c, va, zva, zoa, &dsa, &tsa);
        lr_scores(c, vb, zvb, zob, &dsb, &tsb);
      }
      const float zxa = add(mul(c.rho, zva), mul(c.srho, zoa));
      const float zxb = add(mul(c.rho, zvb), mul(c.srho, zob));
      heston::euler_step<0>(c.step, xa, va, nullptr, zva, zoa, zxa);
      heston::euler_step<0>(c.step, xb, vb, nullptr, zvb, zob, zxb);
    }
    if (c.jumps) {  // the count shared by the pair, the size normal mirrored
      float uj, zj;
      if (kHashDraws) {
        draw_jump_hash(a.seed, block, ui, n, row, col, kRows, kLanes, &uj, &zj);
      } else {
        draw_jump_philox(a.seed, block, ui, row, col, &uj, &zj);
      }
      const float n_j = add(add(ind(uj > c.thr0), ind(uj > c.thr1)), ind(uj > c.thr2));
      const float jm = mul(n_j, c.mu_j);
      const float jz = mul(mul(c.sigma_j, sqrtf(n_j)), zj);
      xa = add(add(xa, jm), jz);
      xb = sub(add(xb, jm), jz);
      if constexpr (kLr) {  // the Poisson dt-score n/dt − λ
        const float tj = sub(quo(n_j, c.dt), c.lam);
        tsa = add(tsa, tj);
        tsb = add(tsb, tj);
      }
    }
    update_stat<F, kLr>(c, sta, xa, i);
    update_stat<F, kLr>(c, stb, xb, i);
    if constexpr (kLr) {
      if (i == 0) {
        zv0 = zva;
        zo0 = zoa;
      }
      sra = add(sra, dsa);
      srb = add(srb, dsb);
      tta = add(tta, tsa);
      ttb = add(ttb, tsb);
    }
  };

  if constexpr (kS == kSobolBB) {
    float cv[9], co[9];
    bridge::targets_pair(a.plan, a.seed, bridge::kHestonExoticSalt, block, row, col, kRows,
                         kLanes, cv, co);
    bridge::replay(a.plan, cv, co, draw, step);
  } else {
#pragma unroll 1  // one step per trip: the loop body is what the bound counts
    for (int i = 0; i < c.n_steps; ++i) {
      float zv, zo;
      draw(i, &zv, &zo);
      step(i, zv, zo, -zv, -zo);
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
      acc[4] += mul(p, sc_v);
      acc[5] += mul(p, br == 0 ? sra : srb);
      acc[6] += mul(p, br == 0 ? tta : ttb);
      if constexpr (F == kHitAt) acc[7] += st[2];
      if constexpr (F == kAutocall) {  // DR: the carried legs, then the redemption's
        const float t_total = mul(c.dt, static_cast<float>(c.n_steps));
        acc[7] += sub(st[3], mul(mul(mul(st[0], t_total), df_t), autocall_final(c, st, x)));
      }
    }
  }
}

template <int kSch>
__device__ Ctx make_ctx(const HxArgs& a, int row) {
  const float* p = a.params;
  Ctx c;
  c.s0 = p[0];
  c.inv_n = p[3];
  c.rdt = p[4];
  c.dt = p[5];
  c.sqrt_dt = p[6];
  c.cp = a.cp;
  const float* bk = a.book + (row % a.nc) * kBookSlots;
  c.k = bk[0];
  c.log_b = bk[1];
  c.a = bk[2];
  c.b = bk[3];
  c.c = bk[4];
  c.d = bk[5];
  c.e = bk[6];
  c.mode = a.mode;
  c.period = a.period;
  c.n_steps = a.n_steps;
  const float* dyn = p + kHead;
  int jb;
  if (kSch == kEuler) {  // mu_dt, kappa, theta, sigma_v, rho, srho, v0
    c.step = heston::StepCoeffs{dyn[0], c.dt, c.sqrt_dt, dyn[1], dyn[2], dyn[3], 0.0f, 0.0f};
    c.rho = dyn[4];
    c.srho = dyn[5];
    c.v0 = dyn[6];
    jb = kHead + 7;
  } else {  // mu_dt, emkd, c1, s2_v, s2_0, k0..k4, v0
#pragma unroll
    for (int j = 0; j < 10; ++j) c.qe[j] = dyn[j];
    c.v0 = dyn[10];
    c.rho = c.srho = 0.0f;  // the correlation is folded into the k-weights
    jb = kHead + 11;
  }
  c.jumps = a.jumps != 0;
  if (c.jumps) {
    c.thr0 = p[jb];
    c.thr1 = p[jb + 1];
    c.thr2 = p[jb + 2];
    c.mu_j = p[jb + 3];
    c.sigma_j = p[jb + 4];
    c.lam = p[jb + 5];
  }
  if (kSch == kEuler) {
    c.srho_g = fmaxf(c.srho, 1e-4f);
    c.mu_over_dt = quo(c.step.drift, c.dt);
    c.two_dt = mul(2.0f, c.dt);
    const float v0g = fmaxf(c.v0, 1e-8f);
    c.inv_v0 = quo(1.0f, v0g);
    c.half_inv_v0 = mul(0.5f, c.inv_v0);
    c.a_head = quo(sub(mul(c.step.kappa, c.dt), 1.0f), mul(c.step.sigma_v, sqrtf(mul(v0g, c.dt))));
    c.b_head = quo(c.sqrt_dt, mul(2.0f, sqrtf(v0g)));
  }
  return c;
}

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, its threads striding over the row's 512 lanes.
template <int F, bool kLr, int kSch, int kS>
__global__ void __launch_bounds__(kThreads) heston_exotic_kernel(HxArgs a) {
  constexpr int kMom = n_moments<F, kLr>();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const Ctx c = make_ctx<kSch>(a, row);

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
  for (int b = b_begin; b < b_end; ++b) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(b);
    for (int col = threadIdx.x; col < static_cast<int>(kLanes); col += kThreads) {
      simulate_lane<F, kLr, kSch, kS>(c, a, block, static_cast<uint32_t>(row),
                                      static_cast<uint32_t>(col), acc);
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int F, bool kLr, int kSch, int kS>
void go(const HxArgs& a, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  heston_exotic_kernel<F, kLr, kSch, kS><<<grid, kThreads, 0, stream>>>(a);
}

template <int F>
void launch_f(const HxArgs& a, int scheme, int sampler, bool lr, cudaStream_t st) {
  if (scheme == kQe) {
    if (sampler == kPrng) go<F, false, kQe, kPrng>(a, st);
    else go<F, false, kQe, kHash>(a, st);
  } else if (lr) {
    if (sampler == kPrng) go<F, true, kEuler, kPrng>(a, st);
    else go<F, true, kEuler, kHash>(a, st);
  } else if (sampler == kPrng) {
    go<F, false, kEuler, kPrng>(a, st);
  } else if (sampler == kHash) {
    go<F, false, kEuler, kHash>(a, st);
  } else {
    go<F, false, kEuler, kSobolBB>(a, st);
  }
}

void launch(const HxArgs& a, int family, int scheme, int sampler, bool lr, cudaStream_t st) {
  switch (family) {
    case kAsianArith: launch_f<kAsianArith>(a, scheme, sampler, lr, st); break;
    case kAsianGeo: launch_f<kAsianGeo>(a, scheme, sampler, lr, st); break;
    case kLookback: launch_f<kLookback>(a, scheme, sampler, lr, st); break;
    case kHit: launch_f<kHit>(a, scheme, sampler, lr, st); break;
    case kHitAt: launch_f<kHitAt>(a, scheme, sampler, lr, st); break;
    case kCliquet: launch_f<kCliquet>(a, scheme, sampler, lr, st); break;
    case kAutocall: launch_f<kAutocall>(a, scheme, sampler, lr, st); break;
    default: launch_f<kRange>(a, scheme, sampler, lr, st); break;
  }
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom, 128) float32, with `partials`
// (n_mom, 128, n_chunks) float32 as scratch; n_mom is 2 without lr, 8 with
// lr for the autocall and pay-at-hit families, 7 otherwise. `params` holds
// 12 + (7 Euler | 11 QE) + (6 if jumps) floats. `plan_i` (32 ints) and
// `plan_f` (23 floats) are host arrays: the sobol_bb bridge plan (zeros
// otherwise).
extern "C" int heston_exotic_moments(const void* params, const void* book, int nc, uint32_t seed,
                                     uint32_t block0, int n_blocks, int blocks_per_chunk,
                                     int n_chunks, int n_steps, int period, float cp, int family,
                                     int mode, int scheme, int jumps, int sampler, int lr,
                                     int n_mom, const int* plan_i, const float* plan_f,
                                     void* partials, void* out, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 || period < 1 ||
      nc < 1 || nc > kRows || kRows % nc != 0 || family < kAsianArith || family > kRange ||
      scheme < kEuler || scheme > kQe || sampler < kPrng || sampler > kSobolBB ||
      (scheme == kQe && sampler == kSobolBB) ||
      (lr && (scheme != kEuler || sampler == kSobolBB)) ||
      (sampler == kSobolBB && n_steps < 2) || plan_i[0] > 8 || plan_i[10] > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the caller sized `partials` and `out` for n_mom moments
  const int expected = lr ? ((family == kHitAt || family == kAutocall) ? 8 : 7) : 2;
  if (n_mom != expected) return static_cast<int>(cudaErrorInvalidValue);
  HxArgs a;
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
  a.jumps = jumps;
  a.cp = cp;
  a.plan = bridge::load_plan(plan_i, plan_f);
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch(a, family, scheme, sampler, lr != 0, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
