// Correlated multi-asset GBM Monte Carlo on Hopper: baskets, rainbows,
// spreads and the basket Asian on d = 2–4 assets, with a one-pass
// likelihood-ratio Greek ladder per asset.
//
// Replaces the TPU kernel optionslab_tpu/ops/multi_asset_pallas.py::_ma_kernel.
// Every lane of the reference's (128, 256) counter space carries four
// antithetic systems of d log-spots through all n_steps. Per step, asset i
// draws one Box–Muller pair (z_cos, z_sin) at draw index k·d + i; the lower
// Cholesky factor correlates each stream once, shock_i = Σ_{j≤i} L_ij·z_j;
// branches A/B add ±σ_i√dt·shock_i of the cos stream, C/D of the sin stream.
// With `lr` each stream also carries g = L⁻ᵀz (first step kept), a_i =
// Σ_k g_k,i·shock_k,i, b_i = Σ_k g_k,i and q = Σ_k |z_k|². The payoff is
// taken after the step loop; for every row the kernel returns Σpay, Σpay²
// and, with `lr`, the moments of the delta, vega, gamma (i ≤ j), theta and
// rho scores; ops/multi_asset_kernel.py::_combine_lr assembles the ladder.
//
// What bounds it: instruction issue. Per lane and step: d Box–Mullers (logf,
// sqrtf, sincosf: d MUFU.RSQ a trip), the sampler's integer work (4 murmur
// mixes or 10 Philox rounds per pair), the d(d+1)/2 Cholesky products per
// stream, with `lr` d² more per stream for g and the carries, the 4·d path
// updates, and for the basket Asian 4·d expf for the basket levels. At
// n_steps = 1 the epilogue (4·d expf, the payoff, the LR moments) is as
// large as the step. Device memory is idle: ≤ 59 floats in, O(moments ·
// rows · chunks) floats out.
//
// What the design does about it:
//  * The parameter vector (S0, drift·dt, σ√dt, w per asset; L; K; g0; L⁻¹,
//    1/σ, √dt, 1/(2T), c1) is staged in shared memory once per CUDA block;
//    every read is a warp-wide broadcast and loop-invariant. The terminal
//    instances also stage the epilogue's lane invariants w_i·S0_i and
//    log S0_i there (the same rounded product and libm call a lane would
//    take), which spares the geometric basket 12 logf a lane.
//  * One thread owns one (block, row, col) lane at a time and keeps its four
//    path systems, LR carries and moment sums in registers; it carries the
//    same lane of each path block of its chunk in turn, one at a time.
//  * Occupancy is set per instance (kBlocksPerSm, __launch_bounds__).
//  * The launch plan (ma_plan, a function of n_blocks and n_steps only, so a
//    sum's order depends on the geometry alone): a launch of many steps
//    takes the other path kernels' plan (≤ 32 chunks a row, ≥ 4096 CUDA
//    blocks once there are 32 path blocks); a short launch, whose lane work
//    is about as small as a CUDA block's fixed costs (the parameter load
//    and its barrier, the block reduction: ≈ 22 % of a one-step lane),
//    gives each thread up to kShortLanes path blocks while ≥ kShortChunks
//    chunks a row are left (896 CUDA blocks: a full wave at the most blocks
//    per SM of any instance, 6 on 132 SMs), so those costs are paid once
//    for several lanes.
//  * Each row's chunks are summed in chunk order, in float64, by a second
//    kernel (reduce.cuh): no float atomics, no state across launches.
//    Measured on the H100 and not taken: the row sum in the same launch,
//    each row's CUDA blocks one thread block cluster (slower at every
//    one-step shape, +25 % at 4 path blocks, +23 % at 31), and the pass as
//    a programmatic dependent launch (within 1 % at 4 and 31 path blocks).
//  * The counter space is the reference's, so the `hash` path set and the
//    `sobol` point set are the JAX kernel's own; `prng` is Philox keyed by
//    (seed, salt ^ block) at counter (row, col, k·d + i, 0).
//  * Precise libm, every product that feeds a path value rounded on its own
//    (fp.cuh, never an FMA) in the reference's association order, so each
//    path is bitwise the plain torch version's.
//  * Templates: d (3) × family (terminal, basket Asian) × lr × sampler
//    (prng, hash, and sobol for the terminal family): 30 instances. The
//    terminal payoff kind (a switch after the step loop), cp, n_steps, the
//    plan and every market scalar are runtime arguments.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "bridge.cuh"
#include "fp.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr uint32_t kLanes = 256;
constexpr int kThreads = 256;  // one thread per lane of a row
constexpr int kMaxParams = 64;
constexpr int kInvariants = kMaxParams;  // w_i·S0_i at +i, log S0_i at +4 + i
constexpr int kLongChunks = 32;          // ops/exotic_kernel.py::_chunking's chunks a row
constexpr int kShortSteps = 8;           // launches of at most this many steps are short
constexpr int kShortLanes = 4;           // path blocks a thread carries in a short launch
constexpr int kShortChunks = 7;          // chunks a row a short launch keeps while it coarsens

// ops/multi_asset_kernel.py::KINDS
enum Kind : int {
  kBasket = 0, kBasketGeo, kRainbowBest, kRainbowWorst, kSpread, kBasketAsian, kBasketCv
};
enum Sampler : int { kPrng = 0, kHash = 1, kSobol = 2 };
using fp::add;
using fp::mul;
using fp::sub;

struct MaArgs {
  const float* __restrict__ params;  // the _params_vec layout below
  int n_params;
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps, kind;
  float cp;
  float* partials;  // (n_mom, 128, n_chunks)
};

// CUDA blocks of kThreads per SM each instance is compiled for
// (__launch_bounds__), by [d - 2][basket Asian][lr][sampler: prng, hash,
// sobol]. Without a bound the allocation drifts by up to ±40 registers with
// small changes around the step and can lose a block per SM; with one that
// is too tight it spills. The entries hold every instance at the blocks per
// SM the kernel reached when it compiled without bounds, and depart from it
// in four, each measured in turns on the H100: the d = 3 terminal `hash`
// price and the d = 2 basket Asian `prng` price run one block fewer, where
// the old count spills (no slower); the d = 3 basket Asian ladders run 3
// (80 registers, 40–60 bytes spilled in the epilogue only, once per lane),
// 3.5 % faster at 64 steps than at 2. The basket Asian has no sobol
// instance.
constexpr int kBlocksPerSm[3][2][2][3] = {
    {{{6, 6, 6}, {3, 3, 3}}, {{5, 5, 1}, {3, 3, 1}}},
    {{{4, 4, 5}, {2, 2, 2}}, {{4, 4, 1}, {3, 3, 1}}},
    {{{2, 4, 4}, {1, 1, 1}}, {{3, 3, 1}, {1, 1, 1}}}};

template <int D, bool kLr>
__host__ __device__ constexpr int n_moments() {
  return kLr ? 2 + 2 * D + D * (D + 1) / 2 + 2 : 2;
}

// Offsets of ops/multi_asset_kernel.py::_params_vec: per asset i [s0, drift·dt,
// σ√dt, w] at 4i; L row-major; K; g0 (basket_cv only); with lr (never with
// basket_cv): L⁻¹ row-major, 1/σ_i, √dt, 1/(2T), c1_i.
template <int D>
struct Param {
  const float* p;
  __device__ float s0(int i) const { return p[4 * i]; }
  __device__ float drift(int i) const { return p[4 * i + 1]; }
  __device__ float sig(int i) const { return p[4 * i + 2]; }
  __device__ float w(int i) const { return p[4 * i + 3]; }
  __device__ float l(int i, int j) const { return p[4 * D + i * D + j]; }
  __device__ float strike() const { return p[4 * D + D * D]; }
  __device__ float g0() const { return p[4 * D + D * D + 1]; }
  __device__ float linv(int i, int j) const { return p[4 * D + D * D + 1 + i * D + j]; }
  __device__ float inv_sig(int i) const { return p[4 * D + 2 * D * D + 1 + i]; }
  __device__ float sqdt() const { return p[4 * D + 2 * D * D + 1 + D]; }
  __device__ float c0() const { return p[4 * D + 2 * D * D + 2 + D]; }
  __device__ float c1(int i) const { return p[4 * D + 2 * D * D + 3 + D + i]; }
  __device__ float ws0(int i) const { return p[kInvariants + i]; }       // w_i·S0_i
  __device__ float log_s0(int i) const { return p[kInvariants + 4 + i]; }  // log S0_i
};

// Σ_i (w_i·S0_i)·e^{x_i}, left to right: after the terminal step loop with
// the block's staged invariant, in the basket Asian's step loop with the
// product formed in place (the same bits; 0.6 % faster at 252 steps than
// the staged one, measured in turns on the H100)
template <int D, bool kStep>
__device__ __forceinline__ float basket_level(const Param<D>& q, const float* x) {
  float lvl = mul(kStep ? mul(q.w(0), q.s0(0)) : q.ws0(0), expf(x[0]));
#pragma unroll
  for (int i = 1; i < D; ++i) {
    lvl = add(lvl, mul(kStep ? mul(q.w(i), q.s0(i)) : q.ws0(i), expf(x[i])));
  }
  return lvl;
}

// The terminal kinds' payoff of one branch (a switch on the runtime kind,
// after the step loop).
template <int D>
__device__ __forceinline__ float terminal_payoff(const Param<D>& q, int kind, float cp,
                                                 const float* x) {
  float lvl;
  if (kind == kBasketGeo) {
    float lg = mul(q.w(0), add(q.log_s0(0), x[0]));
#pragma unroll
    for (int i = 1; i < D; ++i) lg = add(lg, mul(q.w(i), add(q.log_s0(i), x[i])));
    lvl = expf(lg);
  } else if (kind == kRainbowBest || kind == kRainbowWorst) {
    lvl = mul(q.s0(0), expf(x[0]));
#pragma unroll
    for (int i = 1; i < D; ++i) {
      const float si = mul(q.s0(i), expf(x[i]));
      lvl = kind == kRainbowBest ? fmaxf(lvl, si) : fminf(lvl, si);
    }
  } else if (kind == kSpread) {
    lvl = sub(mul(q.s0(0), expf(x[0])), mul(q.s0(1), expf(x[1])));
  } else {  // basket, basket_cv
    lvl = basket_level<D, false>(q, x);
  }
  float pay = fmaxf(mul(cp, sub(lvl, q.strike())), 0.0f);
  if (kind == kBasketCv) {  // minus the geometric basket on the same path
    float glog = mul(q.w(0), x[0]);
#pragma unroll
    for (int i = 1; i < D; ++i) glog = add(glog, mul(q.w(i), x[i]));
    pay = sub(pay, fmaxf(mul(cp, sub(mul(q.g0(), expf(glog)), q.strike())), 0.0f));
  }
  return pay;
}

// The four branches of one (block, row, col) lane through all steps; adds
// the lane's moment terms into acc.
template <int D, bool kAsian, bool kLr, int kS>
__device__ __forceinline__ void simulate_lane(const Param<D>& q, const MaArgs& a, uint32_t block,
                                              uint32_t row, uint32_t col, float* acc) {
  float x[4][D], asian[4];
  float g1[2][D], va[2][D], vb[2][D], vq[2];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    asian[b] = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) x[b][i] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    vq[t] = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) g1[t][i] = va[t][i] = vb[t][i] = 0.0f;
  }
  float sob[2][D];
  if constexpr (kS == kSobol) {  // one 2d-dim point per path, Box–Muller on (2i, 2i+1)
    float u[8];
    bridge::lane_point(a.seed, kHashSalt, block, row, col, kRows, kLanes, u);
#pragma unroll
    for (int i = 0; i < D; ++i) box_muller(u[2 * i], u[2 * i + 1], &sob[0][i], &sob[1][i]);
  }
  const uint32_t n_draws = static_cast<uint32_t>(a.n_steps) * D;

#pragma unroll 1  // one step per trip: the loop body is what the bound counts
  for (int k = 0; k < a.n_steps; ++k) {
    float z[2][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const uint32_t draw = static_cast<uint32_t>(k) * D + i;
      if constexpr (kS == kSobol) {
        z[0][i] = sob[0][i];
        z[1][i] = sob[1][i];
      } else if constexpr (kS == kPrng) {
        draw_normals_philox(a.seed, block, draw, row, col, &z[0][i], &z[1][i]);
      } else {
        draw_normals_hash(a.seed, block, draw, n_draws, row, col, kRows, kLanes, &z[0][i],
                          &z[1][i]);
      }
    }
    float sh[2][D];  // the correlated pre-σ shocks, once per stream
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = mul(q.l(i, 0), z[t][0]);
#pragma unroll
        for (int j = 1; j <= i; ++j) s = add(s, mul(q.l(i, j), z[t][j]));
        sh[t][i] = s;
      }
    }
    if constexpr (kLr) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int i = 0; i < D; ++i) {  // g_i = (L⁻ᵀz)_i = Σ_j L⁻¹_ji·z_j
          float g = mul(q.linv(0, i), z[t][0]);
#pragma unroll
          for (int j = 1; j < D; ++j) g = add(g, mul(q.linv(j, i), z[t][j]));
          if (k == 0) g1[t][i] = g;
          va[t][i] = add(va[t][i], mul(g, sh[t][i]));
          vb[t][i] = add(vb[t][i], g);
        }
        float qs = mul(z[t][0], z[t][0]);
#pragma unroll
        for (int i = 1; i < D; ++i) qs = add(qs, mul(z[t][i], z[t][i]));
        vq[t] = add(vq[t], qs);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float m = mul(q.sig(i), sh[t][i]);  // the branch sign is exact: ±m
        x[2 * t][i] = add(add(x[2 * t][i], q.drift(i)), m);
        x[2 * t + 1][i] = add(add(x[2 * t + 1][i], q.drift(i)), -m);
      }
    }
    if constexpr (kAsian) {
#pragma unroll
      for (int b = 0; b < 4; ++b) asian[b] = add(asian[b], basket_level<D, true>(q, x[b]));
    }
  }

  const float nf = static_cast<float>(a.n_steps);
  const float ndf = static_cast<float>(a.n_steps * D);
  const float inv_n = static_cast<float>(1.0 / static_cast<double>(a.n_steps));
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float pay = kAsian ? fmaxf(mul(a.cp, sub(mul(asian[b], inv_n), q.strike())), 0.0f)
                             : terminal_payoff<D>(q, a.kind, a.cp, x[b]);
    acc[0] += pay;
    acc[1] += mul(pay, pay);
    if constexpr (kLr) {
      const int t = b >> 1;
      const bool neg = b & 1;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        acc[2 + i] += mul(pay, neg ? -g1[t][i] : g1[t][i]);
        const float sv = mul(q.inv_sig(i), sub(va[t][i], nf));
        const float vv = mul(q.sqdt(), vb[t][i]);
        acc[2 + D + i] += mul(pay, neg ? add(sv, vv) : sub(sv, vv));
      }
      int m = 2 + 2 * D;
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = i; j < D; ++j) acc[m++] += mul(pay, mul(g1[t][i], g1[t][j]));
      }
      float sr = mul(vb[t][0], q.inv_sig(0));
      float sth = mul(q.c1(0), vb[t][0]);
#pragma unroll
      for (int i = 1; i < D; ++i) {
        sr = add(sr, mul(vb[t][i], q.inv_sig(i)));
        sth = add(sth, mul(q.c1(i), vb[t][i]));
      }
      if (neg) {  // every term carries the branch sign
        sr = -sr;
        sth = -sth;
      }
      acc[m] += mul(pay, add(mul(q.c0(), sub(vq[t], ndf)), sth));
      acc[m + 1] += mul(pay, mul(q.sqdt(), sr));
    }
  }
}

// grid.x = 128 rows × n_chunks; one CUDA block sums one row over one chunk of
// path blocks, thread c carrying lane c of each.
template <int D, bool kAsian, bool kLr, int kS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm[D - 2][kAsian][kLr][kS])
    multi_asset_kernel(MaArgs a) {
  __shared__ float sp[kMaxParams + 8];
  for (int j = threadIdx.x; j < a.n_params; j += kThreads) sp[j] = a.params[j];
  if (!kAsian && threadIdx.x < D) {  // the terminal epilogue's invariants, as a lane forms them
    const float s0 = a.params[4 * threadIdx.x], w = a.params[4 * threadIdx.x + 3];
    sp[kInvariants + threadIdx.x] = mul(w, s0);
    sp[kInvariants + 4 + threadIdx.x] = logf(s0);
  }
  __syncthreads();
  constexpr int kMom = n_moments<D, kLr>();
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const Param<D> q{sp};

  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.0f;
#pragma unroll 1  // one lane at a time: no second lane's state in registers
  for (int b = b_begin; b < b_end; ++b) {
    simulate_lane<D, kAsian, kLr, kS>(q, a, a.block0 + static_cast<uint32_t>(b),
                                      static_cast<uint32_t>(row), threadIdx.x, acc);
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

// (n_chunks, blocks_per_chunk) of a launch over n_blocks path blocks of
// n_steps steps.
void ma_plan(int n_blocks, int n_steps, int* n_chunks, int* blocks_per_chunk) {
  int chunks = n_blocks < kLongChunks ? n_blocks : kLongChunks;
  if (n_steps <= kShortSteps) {  // up to kShortLanes path blocks a thread, ≥ kShortChunks a row
    int lanes = n_blocks / kShortChunks;
    lanes = lanes < 1 ? 1 : lanes < kShortLanes ? lanes : kShortLanes;
    chunks = (n_blocks + lanes - 1) / lanes;
  }
  const int per = (n_blocks + chunks - 1) / chunks;
  *blocks_per_chunk = per;
  *n_chunks = (n_blocks + per - 1) / per;
}

template <int D, bool kAsian, bool kLr>
const void* pick(int sampler) {
  if (sampler == kPrng) return reinterpret_cast<const void*>(multi_asset_kernel<D, kAsian, kLr, kPrng>);
  if (sampler == kHash) return reinterpret_cast<const void*>(multi_asset_kernel<D, kAsian, kLr, kHash>);
  if constexpr (!kAsian) return reinterpret_cast<const void*>(multi_asset_kernel<D, false, kLr, kSobol>);
  return nullptr;  // sobol is terminal-only
}

// The instance for (d, basket Asian or terminal family, lr, sampler), or null.
const void* instance(int d, bool asian, bool lr, int sampler) {
  if (sampler < kPrng || sampler > kSobol) return nullptr;
  switch (d) {
    case 2:
      if (asian) return lr ? pick<2, true, true>(sampler) : pick<2, true, false>(sampler);
      return lr ? pick<2, false, true>(sampler) : pick<2, false, false>(sampler);
    case 3:
      if (asian) return lr ? pick<3, true, true>(sampler) : pick<3, true, false>(sampler);
      return lr ? pick<3, false, true>(sampler) : pick<3, false, false>(sampler);
    case 4:
      if (asian) return lr ? pick<4, true, true>(sampler) : pick<4, true, false>(sampler);
      return lr ? pick<4, false, true>(sampler) : pick<4, false, false>(sampler);
    default:
      return nullptr;
  }
}

}  // namespace
}  // namespace optionslab

// The launch plan of n_blocks path blocks of n_steps steps: the n_chunks and
// blocks_per_chunk that multi_asset_moments takes.
extern "C" int multi_asset_plan(int n_blocks, int n_steps, int* n_chunks, int* blocks_per_chunk) {
  using namespace optionslab;
  if (n_blocks < 1 || n_steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  ma_plan(n_blocks, n_steps, n_chunks, blocks_per_chunk);
  return 0;
}

// Per-row moment sums into `out` (n_mom, 128) float32 of n_blocks path
// blocks from block0, n_chunks chunks of blocks_per_chunk a row (the plan of
// multi_asset_plan, or any that covers every path block once), with
// `partials` (n_mom, 128, n_chunks) float32 as scratch; n_mom is 2 without
// lr and 2 + 2d + d(d+1)/2 + 2 with it. `params` holds n_params floats in
// the layout of ops/multi_asset_kernel.py::_params_vec.
extern "C" int multi_asset_moments(const void* params, int n_params, uint32_t seed,
                                   uint32_t block0, int n_blocks, int blocks_per_chunk,
                                   int n_chunks, int d, int kind, int n_steps, float cp,
                                   int sampler, int lr, int n_mom, void* partials, void* out,
                                   int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int expected_params = 4 * d + d * d + 1 + (kind == kBasketCv) + (lr ? d * d + 2 * d + 2 : 0);
  const int expected_mom = lr ? 2 + 2 * d + d * (d + 1) / 2 + 2 : 2;
  const void* fn = instance(d, kind == kBasketAsian, lr != 0, sampler);
  if (fn == nullptr || n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 ||
      // every chunk holds a path block and every path block is in a chunk
      static_cast<long long>(blocks_per_chunk) * (n_chunks - 1) >= n_blocks ||
      static_cast<long long>(blocks_per_chunk) * n_chunks < n_blocks || kind < kBasket ||
      kind > kBasketCv || (sampler == kSobol && n_steps != 1) || (kind == kSpread && d != 2) ||
      (kind == kBasketCv && lr) || n_params != expected_params || n_params > kMaxParams ||
      n_mom != expected_mom) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MaArgs a;
  a.params = static_cast<const float*>(params);
  a.n_params = n_params;
  a.seed = seed;
  a.block0 = block0;
  a.n_blocks = n_blocks;
  a.blocks_per_chunk = blocks_per_chunk;
  a.n_chunks = n_chunks;
  a.n_steps = n_steps;
  a.kind = kind;
  a.cp = cp;
  a.partials = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&a};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(kRows) * static_cast<unsigned>(n_chunks)),
                         dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local memory bytes per thread (spills and stack) and
// resident CUDA blocks per SM of the instance for (d, basket Asian or
// terminal family, lr, sampler), as the card schedules it.
extern "C" int multi_asset_occupancy(int d, int asian, int lr, int sampler, int device,
                                     int* registers, int* local_bytes, int* blocks_per_sm) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = instance(d, asian != 0, lr != 0, sampler);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0));
}
