// The `sobol_bb` sampler, hybrid bridge QMC, shared by the kernels that take
// it: the GBM exotic kernel (exotic_mc.cu) and the local-vol kernel
// (local_vol_mc.cu) pin one z-sum stream at up to 8 dyadic levels; the
// Heston kernels (heston_mc.cu, heston_exotic.cu) pin the variance stream z_v
// and the orthogonal spot stream z_o at up to 4 levels each. The twins are
// ops/exotic_kernel.py::_bridge_offsets (one stream) and
// ops/heston_kernel.py::_bridge_offsets (two); the plan's host layout is
// ops/exotic_kernel.py::_bridge_plan_arrays.
//
// One scrambled 8-D Sobol point per lane (8 independently scrambled replicate
// groups, row & 7) gives the pinned z-sums at the plan's sorted bounds. Each
// bridge segment then runs in two passes over the same counters: pass 1 sums
// the segment's hash residuals, pass 2 replays them shifted by constant
// offsets so that each antithetic branch hits the shared targets. Both passes
// are loops of one step per trip, which ops/sass_bound.py counts separately.
#pragma once

#include <cstdint>

#include "fp.cuh"
#include "rng.cuh"

namespace optionslab {
namespace bridge {

using fp::add;
using fp::mul;
using fp::sub;

constexpr uint32_t kHestonExoticSalt = 0x2C9277B5u;  // the others scramble with kHashSalt

struct Plan {  // exotic_kernel._bridge_plan_arrays(n_steps, levels)
  int n_seg;
  int bounds[9];
  int n_con;
  int con_mid[7], con_lo[7], con_hi[7];  // indices into bounds
  float sqrt_n;
  float con_frac[7], con_sd[7];
  float seg_inv[8];
};

// The plan from its host arrays: 32 ints and 23 floats.
inline Plan load_plan(const int* plan_i, const float* plan_f) {
  Plan pl;
  pl.n_seg = plan_i[0];
  for (int j = 0; j < 9; ++j) pl.bounds[j] = plan_i[1 + j];
  pl.n_con = plan_i[10];
  for (int j = 0; j < 7; ++j) {
    pl.con_mid[j] = plan_i[11 + j];
    pl.con_lo[j] = plan_i[18 + j];
    pl.con_hi[j] = plan_i[25 + j];
    pl.con_frac[j] = plan_f[1 + j];
    pl.con_sd[j] = plan_f[8 + j];
  }
  pl.sqrt_n = plan_f[0];
  for (int j = 0; j < 8; ++j) pl.seg_inv[j] = plan_f[15 + j];
  return pl;
}

// The scrambled 8-D Sobol point u of lane (row, col) of path block `block`
// in a (rows, lanes) counter space; `salt` seeds the scrambles' hash chain.
__device__ __forceinline__ void lane_point(uint32_t seed, uint32_t salt, uint32_t block,
                                           uint32_t row, uint32_t col, uint32_t rows,
                                           uint32_t lanes, float* u) {
  constexpr uint32_t kMask30 = (1u << 30) - 1u;
  const int32_t idx =
      static_cast<int32_t>(block * ((rows / 8u) * lanes) + (row >> 3) * lanes + col + 1u);
  uint32_t h = fmix32((seed + (row & 7u) * kGroupSalt) * kGolden + salt);
  uint32_t scr[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    scr[d] = h & kMask30;
    h = fmix32(h + 0x9E3779B9u);
  }
  sobol_nd(idx, scr, u);
}

// The z-sums of kN streams pinned at the sorted bounds (c[s], 9 each) from
// their normals g[s]: g[s][0] at the end, g[s][j + 1] at the plan's j-th
// conditional midpoint.
template <int kN>
__device__ __forceinline__ void pin(const Plan& pl, const float* const (&g)[kN],
                                    float* const (&c)[kN]) {
#pragma unroll
  for (int s = 0; s < kN; ++s) c[s][0] = 0.0f;
#pragma unroll
  for (int s = 0; s < kN; ++s) c[s][pl.n_seg] = mul(pl.sqrt_n, g[s][0]);
  for (int j = 0; j < pl.n_con; ++j) {
    float lo[kN];
#pragma unroll
    for (int s = 0; s < kN; ++s) lo[s] = c[s][pl.con_lo[j]];
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      c[s][pl.con_mid[j]] =
          add(add(lo[s], mul(sub(c[s][pl.con_hi[j]], lo[s]), pl.con_frac[j])),
              mul(pl.con_sd[j], g[s][j + 1]));
    }
  }
}

// One stream at up to 8 levels (the GBM exotic and local-vol kernels): the
// point's 4 Box–Muller pairs in order.
__device__ __forceinline__ void targets(const Plan& pl, uint32_t seed, uint32_t salt,
                                        uint32_t block, uint32_t row, uint32_t col, uint32_t rows,
                                        uint32_t lanes, float* csum) {
  float u[8], g[8];
  lane_point(seed, salt, block, row, col, rows, lanes, u);
#pragma unroll
  for (int q = 0; q < 4; ++q) box_muller(u[2 * q], u[2 * q + 1], &g[2 * q], &g[2 * q + 1]);
  pin<1>(pl, {g}, {csum});
}

// Two streams at up to 4 levels each (the Heston kernels): pair k's first
// normal is level k of z_v, its second level k of z_o.
__device__ __forceinline__ void targets_pair(const Plan& pl, uint32_t seed, uint32_t salt,
                                             uint32_t block, uint32_t row, uint32_t col,
                                             uint32_t rows, uint32_t lanes, float* cv,
                                             float* co) {
  float u[8], gv[4], go[4];
  lane_point(seed, salt, block, row, col, rows, lanes, u);
#pragma unroll
  for (int k = 0; k < 4; ++k) box_muller(u[2 * k], u[2 * k + 1], &gv[k], &go[k]);
  pin<2>(pl, {gv, go}, {cv, co});
}

// The two passes of every segment: draw(i, &z1, &z2) gives step i's residual
// pair, step(i, z1a, z2a, z1b, z2b) advances the branch (z1, z2) pinned to
// (c1, c2) and its antithetic (−z1, −z2); the one-stream kernels pass the
// same targets twice.
template <class Draw, class Step>
__device__ __forceinline__ void replay(const Plan& pl, const float* c1, const float* c2,
                                       Draw draw, Step step) {
  for (int j = 0; j < pl.n_seg; ++j) {
    float s1 = 0.0f, s2 = 0.0f, z1, z2;
#pragma unroll 1  // pass 1: one Box–Muller per trip
    for (int i = pl.bounds[j]; i < pl.bounds[j + 1]; ++i) {
      draw(i, &z1, &z2);
      s1 = add(s1, z1);
      s2 = add(s2, z2);
    }
    const float t1 = sub(c1[j + 1], c1[j]), t2 = sub(c2[j + 1], c2[j]);
    const float inv = pl.seg_inv[j];
    const float o1p = mul(sub(t1, s1), inv), o2p = mul(sub(t2, s2), inv);
    const float o1m = mul(add(t1, s1), inv), o2m = mul(add(t2, s2), inv);
#pragma unroll 1  // pass 2: the replay, one step per trip
    for (int i = pl.bounds[j]; i < pl.bounds[j + 1]; ++i) {
      draw(i, &z1, &z2);
      step(i, add(z1, o1p), add(z2, o2p), add(-z1, o1m), add(-z2, o2m));
    }
  }
}

}  // namespace bridge
}  // namespace optionslab
