// The `sobol_bb` sampler of the Heston kernels (heston_mc.cu, heston_exotic.cu):
// hybrid bridge QMC over both Brownian streams. The twin is
// ops/heston_kernel.py::_bridge_offsets.
//
// One scrambled 8-D Sobol point per lane (8 independently scrambled replicate
// groups, row & 7) pins up to 4 dyadic z-sum coordinates of the variance
// stream z_v and 4 of the orthogonal spot stream z_o (dimension pair k: level
// k of each). Each bridge segment then runs in two passes over the same
// counters: pass 1 sums the segment's hash residuals, pass 2 replays them
// shifted by constant offsets so that each antithetic branch hits the shared
// targets. Both passes are loops of one step per trip, which
// ops/sass_bound.py counts separately.
#pragma once

#include <cstdint>

#include "heston_euler.cuh"
#include "rng.cuh"

namespace optionslab {
namespace heston {

constexpr uint32_t kExoticQmcSalt = 0x2C9277B5u;

struct BridgePlan {  // exotic_kernel._bridge_plan_arrays(n_steps, 4)
  int n_seg;
  int bounds[9];
  int n_con;
  int con_mid[7], con_lo[7], con_hi[7];  // indices into bounds
  float sqrt_n;
  float con_frac[7], con_sd[7];
  float seg_inv[8];
};

// The plan from its host arrays: 32 ints and 23 floats.
inline BridgePlan load_plan(const int* plan_i, const float* plan_f) {
  BridgePlan pl;
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

// The z-sums of both streams pinned at the sorted bridge bounds, cv and co
// (9 each), of lane (row, col) of path block `block` in a (rows, lanes)
// counter space; `salt` seeds the scrambles' hash chain (kHashSalt for the
// European kernel, kExoticQmcSalt for the exotic one).
__device__ __forceinline__ void bridge_targets(const BridgePlan& pl, uint32_t seed, uint32_t salt,
                                               uint32_t block, uint32_t row, uint32_t col,
                                               uint32_t rows, uint32_t lanes, float* cv,
                                               float* co) {
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
  float u[8], gv[4], go[4];
  sobol_nd(idx, scr, u);
#pragma unroll
  for (int k = 0; k < 4; ++k) box_muller(u[2 * k], u[2 * k + 1], &gv[k], &go[k]);
  cv[0] = co[0] = 0.0f;
  cv[pl.n_seg] = mul(pl.sqrt_n, gv[0]);
  co[pl.n_seg] = mul(pl.sqrt_n, go[0]);
  for (int j = 0; j < pl.n_con; ++j) {
    const float lv = cv[pl.con_lo[j]], lo = co[pl.con_lo[j]];
    cv[pl.con_mid[j]] = add(add(lv, mul(sub(cv[pl.con_hi[j]], lv), pl.con_frac[j])),
                            mul(pl.con_sd[j], gv[j + 1]));
    co[pl.con_mid[j]] = add(add(lo, mul(sub(co[pl.con_hi[j]], lo), pl.con_frac[j])),
                            mul(pl.con_sd[j], go[j + 1]));
  }
}

// The two passes of every segment: draw(i, &zv, &zo) gives step i's residual
// pair, step(i, zva, zoa, zvb, zob) advances both branches.
template <class Draw, class Step>
__device__ __forceinline__ void bridge_replay(const BridgePlan& pl, const float* cv,
                                              const float* co, Draw draw, Step step) {
  for (int j = 0; j < pl.n_seg; ++j) {
    float sv = 0.0f, so = 0.0f, zv, zo;
#pragma unroll 1  // pass 1: one Box–Muller per trip
    for (int i = pl.bounds[j]; i < pl.bounds[j + 1]; ++i) {
      draw(i, &zv, &zo);
      sv = add(sv, zv);
      so = add(so, zo);
    }
    const float tv = sub(cv[j + 1], cv[j]), to = sub(co[j + 1], co[j]);
    const float inv = pl.seg_inv[j];
    const float ovp = mul(sub(tv, sv), inv), oop = mul(sub(to, so), inv);
    const float ovm = mul(add(tv, sv), inv), oom = mul(add(to, so), inv);
#pragma unroll 1  // pass 2: the replay, one step per trip
    for (int i = pl.bounds[j]; i < pl.bounds[j + 1]; ++i) {
      draw(i, &zv, &zo);
      step(i, add(zv, ovp), add(zo, oop), add(-zv, ovm), add(-zo, oom));
    }
  }
}

}  // namespace heston
}  // namespace optionslab
