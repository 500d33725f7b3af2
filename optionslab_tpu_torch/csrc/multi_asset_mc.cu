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
//    every read is a warp-wide broadcast and loop-invariant.
//  * One thread owns one (block, row, col) lane at a time and keeps its four
//    path systems, LR carries and moment sums in registers.
//  * The counter space is the reference's, so the `hash` path set and the
//    `sobol` point set are the JAX kernel's own; `prng` is Philox keyed by
//    (seed, salt ^ block) at counter (row, col, k·d + i, 0).
//  * Fixed-order reduction (reduce.cuh): no float atomics.
//  * Precise libm, every product that feeds a path value rounded on its own
//    (fp.cuh, never an FMA) in the reference's association order, so each
//    path is bitwise the plain torch version's.
//  * Templates: d (3) × family (terminal, basket Asian) × lr × sampler
//    (prng, hash, and sobol for the terminal family): 30 instances. The
//    terminal payoff kind (a switch after the step loop), cp, n_steps and
//    every market scalar are runtime arguments.
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
};

// Σ_i (w_i·S0_i)·e^{x_i}, left to right
template <int D>
__device__ __forceinline__ float basket_level(const Param<D>& q, const float* x) {
  float lvl = mul(mul(q.w(0), q.s0(0)), expf(x[0]));
#pragma unroll
  for (int i = 1; i < D; ++i) lvl = add(lvl, mul(mul(q.w(i), q.s0(i)), expf(x[i])));
  return lvl;
}

// The terminal kinds' payoff of one branch (a switch on the runtime kind,
// after the step loop).
template <int D>
__device__ __forceinline__ float terminal_payoff(const Param<D>& q, int kind, float cp,
                                                 const float* x) {
  float lvl;
  if (kind == kBasketGeo) {
    float lg = mul(q.w(0), add(logf(q.s0(0)), x[0]));
#pragma unroll
    for (int i = 1; i < D; ++i) lg = add(lg, mul(q.w(i), add(logf(q.s0(i)), x[i])));
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
    lvl = basket_level<D>(q, x);
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
      for (int b = 0; b < 4; ++b) asian[b] = add(asian[b], basket_level<D>(q, x[b]));
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
// path blocks, thread c owning lane c of the row.
template <int D, bool kAsian, bool kLr, int kS>
__global__ void __launch_bounds__(kThreads) multi_asset_kernel(MaArgs a) {
  __shared__ float sp[kMaxParams];
  for (int j = threadIdx.x; j < a.n_params; j += kThreads) sp[j] = a.params[j];
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
  for (int b = b_begin; b < b_end; ++b) {
    simulate_lane<D, kAsian, kLr, kS>(q, a, a.block0 + static_cast<uint32_t>(b),
                                      static_cast<uint32_t>(row), threadIdx.x, acc);
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int D, bool kAsian, bool kLr, int kS>
cudaError_t go(const MaArgs& a, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  multi_asset_kernel<D, kAsian, kLr, kS><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool kAsian, bool kLr>
cudaError_t by_sampler(const MaArgs& a, int sampler, cudaStream_t st) {
  if (sampler == kPrng) return go<D, kAsian, kLr, kPrng>(a, st);
  if (sampler == kHash) return go<D, kAsian, kLr, kHash>(a, st);
  if constexpr (!kAsian) return go<D, false, kLr, kSobol>(a, st);
  return cudaErrorInvalidValue;  // sobol is terminal-only
}

template <int D>
cudaError_t by_family(const MaArgs& a, int sampler, bool lr, cudaStream_t st) {
  if (a.kind == kBasketAsian) {
    return lr ? by_sampler<D, true, true>(a, sampler, st) : by_sampler<D, true, false>(a, sampler, st);
  }
  return lr ? by_sampler<D, false, true>(a, sampler, st)
            : by_sampler<D, false, false>(a, sampler, st);
}

}  // namespace
}  // namespace optionslab

// Per-row moment sums into `out` (n_mom, 128) float32, with `partials`
// (n_mom, 128, n_chunks) float32 as scratch; n_mom is 2 without lr and
// 2 + 2d + d(d+1)/2 + 2 with it. `params` holds n_params floats in the
// layout of ops/multi_asset_kernel.py::_params_vec.
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
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 || d < 2 || d > 4 ||
      kind < kBasket || kind > kBasketCv || sampler < kPrng || sampler > kSobol ||
      (sampler == kSobol && (n_steps != 1 || kind == kBasketAsian)) ||
      (kind == kSpread && d != 2) || (kind == kBasketCv && lr) || n_params != expected_params ||
      n_params > kMaxParams || n_mom != expected_mom) {
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
  const bool with_lr = lr != 0;
  switch (d) {
    case 2: err = by_family<2>(a, sampler, with_lr, st); break;
    case 3: err = by_family<3>(a, sampler, with_lr, st); break;
    default: err = by_family<4>(a, sampler, with_lr, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_mom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), n_mom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
