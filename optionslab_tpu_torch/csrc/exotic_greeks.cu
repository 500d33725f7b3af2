// Pathwise Greek ladder of Asian and lookback options on Hopper, one pass.
//
// Replaces the TPU kernel
// optionslab_tpu/ops/exotic_pallas.py::_exotic_greeks_kernel. Every lane of
// the reference's (128, 256) counter space simulates four antithetic GBM
// paths and carries, per path, the spot (log-spot for the geometric Asian),
// the shared Brownian values W of the two draw streams and three payoff
// auxiliaries (Asian: Σ S, Σ S·W, Σ S·t/T; lookback: the extremum and W and
// t/T at it). For every row it returns Σpay, Σpay², ΣP0, ΣG1 and ΣG2, from
// which ops/exotic_kernel.py::_combine_greeks builds price, stderr, delta,
// vega, rho, theta and dividend-rho by the chain rules of the pathwise
// method.
//
// What bounds it: instruction issue, as in exotic_mc.cu: per lane and step
// one Box–Muller (logf, sqrtf, sincosf), two expf (none for the geometric
// Asian) and the sampler's integer work, plus ~10 FP32 adds/multiplies per
// path for the auxiliaries (ops/sass_bound.py counts them from the SASS).
// Device memory is idle: 14 floats in, O(5 · rows · chunks) floats out.
//
// What the design does about it: one thread owns one (block, row, col) lane
// at a time and keeps all of its state in registers through the time loop;
// the counter space is the reference's, so `hash` paths are the JAX kernel's
// own and `prng` is Philox at counter (row, col, step, 0); the reduction is
// the fixed-order one of reduce.cuh; products that feed sums are rounded on
// their own (__fmul_rn/__fadd_rn) and libm is precise, so each path is bitwise
// the plain torch version's. Templates: kind (4) × sampler (2); cp, n_steps and
// the market scalars are runtime arguments.
//
// C interface for ctypes, as exotic_mc.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "fp.cuh"
#include "reduce.cuh"
#include "rng.cuh"

namespace optionslab {
namespace {

constexpr int kRows = 128;
constexpr int kLanes = 256;
constexpr int kThreads = 256;
constexpr int kMom = 5;

enum Kind : int { kAsianArith = 0, kAsianGeo = 1, kLookbackFloat = 2, kLookbackFixed = 3 };
enum Sampler : int { kPrng = 0, kHash = 1 };

struct GreeksArgs {
  const float* params;  // (14,)
  uint32_t seed;
  uint32_t block0;
  int n_blocks, blocks_per_chunk, n_chunks;
  int n_steps;
  float cp;
  float* partials;  // (5, 128, n_chunks)
};

using fp::add;
using fp::mul;
using fp::quo;
using fp::sub;

template <int kKind, int kS>
__global__ void __launch_bounds__(kThreads) exotic_greeks_kernel(GreeksArgs a) {
  constexpr bool kAsian = kKind == kAsianArith || kKind == kAsianGeo;
  const int row = blockIdx.x / a.n_chunks;
  const int chunk = blockIdx.x - row * a.n_chunks;
  const int b_begin = chunk * a.blocks_per_chunk;
  const int b_end = min(a.n_blocks, b_begin + a.blocks_per_chunk);
  const float* p = a.params;
  const float s0 = p[0], strike = p[1], drift_dt = p[2], vsd = p[3], inv_n = p[5];
  const float growth = p[6], sqdt = p[8], cp = a.cp;
  // float call / fixed put track the running minimum
  const bool minimum = (kKind == kLookbackFloat) == (cp > 0.0f);
  const uint32_t urow = static_cast<uint32_t>(row);

  float acc[kMom] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int blk = b_begin; blk < b_end; ++blk) {
    const uint32_t block = a.block0 + static_cast<uint32_t>(blk);
    for (int col = threadIdx.x; col < kLanes; col += kThreads) {
      const uint32_t ucol = static_cast<uint32_t>(col);
      const float x0 = kKind == kAsianGeo ? 0.0f : s0;  // geo: relative log-spot
      float x[4] = {x0, x0, x0, x0};
      float w1 = 0.0f, w2 = 0.0f;
      float aux[4][3];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        aux[b][0] = kAsian ? 0.0f : x0;
        aux[b][1] = aux[b][2] = 0.0f;
      }
#pragma unroll 1  // one step per trip: the loop body is what the bound counts
      for (int i = 0; i < a.n_steps; ++i) {
        float z1, z2;
        if (kS == kPrng) {
          draw_normals_philox(a.seed, block, static_cast<uint32_t>(i), urow, ucol, &z1, &z2);
        } else {
          draw_normals_hash(a.seed, block, static_cast<uint32_t>(i),
                            static_cast<uint32_t>(a.n_steps), urow, ucol, kRows, kLanes, &z1,
                            &z2);
        }
        w1 = add(w1, mul(sqdt, z1));
        w2 = add(w2, mul(sqdt, z2));
        if (kKind == kAsianGeo) {
          x[0] = add(add(x[0], drift_dt), mul(vsd, z1));
          x[1] = sub(add(x[1], drift_dt), mul(vsd, z1));
          x[2] = add(add(x[2], drift_dt), mul(vsd, z2));
          x[3] = sub(add(x[3], drift_dt), mul(vsd, z2));
        } else {
          const float e1 = expf(mul(vsd, z1));
          const float e2 = expf(mul(vsd, z2));
          x[0] = mul(x[0], mul(growth, e1));
          x[1] = quo(mul(x[1], growth), e1);
          x[2] = mul(x[2], mul(growth, e2));
          x[3] = quo(mul(x[3], growth), e2);
        }
        const float frac = mul(static_cast<float>(i + 1), inv_n);  // t_{i+1}/T
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float w = b < 2 ? w1 : w2;
          const float wb = (b & 1) ? -w : w;
          if (kKind == kAsianArith) {
            aux[b][0] = add(aux[b][0], x[b]);
            aux[b][1] = add(aux[b][1], mul(x[b], wb));
            aux[b][2] = add(aux[b][2], mul(x[b], frac));
          } else if (kKind == kAsianGeo) {
            aux[b][0] = add(aux[b][0], x[b]);
            aux[b][1] = add(aux[b][1], wb);
          } else {  // extremum, and W and t/T where it was reached
            const bool better = minimum ? x[b] < aux[b][0] : x[b] > aux[b][0];
            if (better) {
              aux[b][0] = x[b];
              aux[b][1] = wb;
              aux[b][2] = frac;
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float w = b < 2 ? w1 : w2;
        const float wb = (b & 1) ? -w : w;
        float pay, p0, g1, g2;
        if (kKind == kAsianArith || kKind == kAsianGeo) {
          const float avg = kKind == kAsianArith ? mul(aux[b][0], inv_n)
                                                 : mul(s0, expf(mul(aux[b][0], inv_n)));
          pay = fmaxf(mul(cp, sub(avg, strike)), 0.0f);
          const float cpi = mul(cp, pay > 0.0f ? 1.0f : 0.0f);
          p0 = mul(cpi, avg);
          if (kKind == kAsianArith) {
            g1 = mul(mul(cpi, aux[b][1]), inv_n);
            g2 = mul(mul(cpi, aux[b][2]), inv_n);
          } else {
            g1 = mul(mul(mul(cpi, avg), aux[b][1]), inv_n);
            g2 = 0.0f;  // the host substitutes (n+1)/(2n) · P0
          }
        } else if (kKind == kLookbackFixed) {
          const float m = aux[b][0];
          pay = fmaxf(mul(cp, sub(m, strike)), 0.0f);
          const float cpi = mul(cp, pay > 0.0f ? 1.0f : 0.0f);
          p0 = mul(cpi, m);
          g1 = mul(mul(cpi, m), aux[b][1]);
          g2 = mul(mul(cpi, m), aux[b][2]);
        } else {  // floating lookback, homogeneous of degree 1 in the spot
          const float m = aux[b][0];
          pay = mul(cp, sub(x[b], m));
          p0 = pay;
          g1 = mul(cp, sub(mul(x[b], wb), mul(m, aux[b][1])));
          g2 = mul(cp, sub(x[b], mul(m, aux[b][2])));
        }
        acc[0] += pay;
        acc[1] += pay * pay;
        acc[2] += p0;
        acc[3] += g1;
        acc[4] += g2;
      }
    }
  }
  store_block_moments<kMom, kThreads>(acc, a.partials, kRows, row, a.n_chunks, chunk);
}

template <int kKind>
void launch_kind(const GreeksArgs& a, int sampler, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(kRows) * static_cast<unsigned>(a.n_chunks);
  if (sampler == kPrng) {
    exotic_greeks_kernel<kKind, kPrng><<<grid, kThreads, 0, stream>>>(a);
  } else {
    exotic_greeks_kernel<kKind, kHash><<<grid, kThreads, 0, stream>>>(a);
  }
}

}  // namespace
}  // namespace optionslab

// Per-row sums of pay, pay², P0, G1, G2 into `out` (5, 128) float32, with
// `partials` (5, 128, n_chunks) float32 as scratch. `kind` indexes
// (asian_arith, asian_geo, lookback_float, lookback_fixed).
extern "C" int exotic_greeks_moments(const void* params, uint32_t seed, uint32_t block0,
                                     int n_blocks, int blocks_per_chunk, int n_chunks,
                                     int n_steps, float cp, int kind, int sampler,
                                     void* partials, void* out, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || blocks_per_chunk < 1 || n_chunks < 1 || n_steps < 1 ||
      kind < kAsianArith || kind > kLookbackFixed || sampler < kPrng || sampler > kHash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GreeksArgs a;
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
  switch (kind) {
    case kAsianArith: launch_kind<kAsianArith>(a, sampler, st); break;
    case kAsianGeo: launch_kind<kAsianGeo>(a, sampler, st); break;
    case kLookbackFloat: launch_kind<kLookbackFloat>(a, sampler, st); break;
    default: launch_kind<kLookbackFixed>(a, sampler, st); break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = kMom * kRows;
  reduce_rows_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.partials, static_cast<float*>(out), kMom, kRows, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
