// One full-truncation Euler step of a Heston branch and the forward
// sensitivities it carries, shared by heston_mc.cu (price, vega, ladder) and
// heston_chain.cu. The twin is ops/heston_kernel.py::_euler_step.
//
// kNs slots of (∂x, ∂v) per parameter: 0 (price); 2 (v0); 9 (v0, κ, θ, σ,
// then ∂x for ρ: the chain); 11 (the same plus (∂x, ∂v) for T with dt = T/n:
// the ladder). Each is the exact pathwise derivative of the recursion:
// d√v⁺ = 1{v>0}·dv/(2√v⁺); κ, θ and σ enter dv explicitly; ρ only the spot
// shock; T every dt and √dt. Every product is rounded on its own in the
// reference's association order (no FMA contraction), so a path is bitwise
// its plain twin's.
#pragma once

#include "fp.cuh"

namespace optionslab {
namespace heston {

using fp::add;
using fp::mul;
using fp::quo;
using fp::sub;

struct StepCoeffs {
  float drift;  // (r − q)·dt
  float dt, sqrt_dt, kappa, theta, sigma_v;
  float crho;   // ρ/√(1−ρ²)
  float inv_t;  // 1/T (ladder only)
};

// (∂x, ∂v) of one parameter through one step; ex_dv is the step's explicit
// derivative of the variance update (none for v0)
__device__ __forceinline__ void prop(const StepCoeffs& c, float ind, float inv2sq, float sv,
                                     float sx, float ex_dv, bool has_ex, float& dx, float& dv) {
  const float dsq = mul(inv2sq, dv);
  const float dx_n = add(sub(dx, mul(mul(mul(0.5f, ind), dv), c.dt)), mul(mul(dsq, c.sqrt_dt), sx));
  float dv_n = add(sub(dv, mul(mul(mul(c.kappa, ind), dv), c.dt)),
                   mul(mul(mul(c.sigma_v, dsq), c.sqrt_dt), sv));
  if (has_ex) dv_n = add(dv_n, ex_dv);
  dx = dx_n;
  dv = dv_n;
}

// One step of one branch: shocks (sv, so) and the spot shock sx.
template <int kNs>
__device__ __forceinline__ void euler_step(const StepCoeffs& c, float& x, float& v, float* s,
                                           float sv, float so, float sx) {
  const float ind = v > 0.0f ? 1.0f : 0.0f;  // full truncation: v⁺ = max(v, 0)
  const float vp = mul(v, ind);
  const float sq = sqrtf(vp);
  const float x_new =
      add(sub(add(x, c.drift), mul(mul(0.5f, vp), c.dt)), mul(mul(sq, c.sqrt_dt), sx));
  const float v_new = add(add(v, mul(mul(c.kappa, sub(c.theta, vp)), c.dt)),
                          mul(mul(mul(c.sigma_v, sq), c.sqrt_dt), sv));
  if constexpr (kNs > 0) {
    const float inv2sq = quo(ind, mul(2.0f, fmaxf(sq, 1e-6f)));  // guarded at the origin
    prop(c, ind, inv2sq, sv, sx, 0.0f, false, s[0], s[1]);
    if constexpr (kNs >= 9) {
      const float sq_sdt = mul(sq, c.sqrt_dt);
      prop(c, ind, inv2sq, sv, sx, mul(sub(c.theta, vp), c.dt), true, s[2], s[3]);  // kappa
      prop(c, ind, inv2sq, sv, sx, mul(c.kappa, c.dt), true, s[4], s[5]);           // theta
      prop(c, ind, inv2sq, sv, sx, mul(sq_sdt, sv), true, s[6], s[7]);              // sigma
      s[8] = add(s[8], mul(sq_sdt, sub(sv, mul(c.crho, so))));  // rho: the spot shock only
      if constexpr (kNs == 11) {  // T: every dt and √dt rescales (fixed step count)
        const float dvm = s[10];
        const float dsqm = add(mul(mul(inv2sq, dvm), c.sqrt_dt), mul(sq_sdt, mul(0.5f, c.inv_t)));
        s[9] = add(sub(add(s[9], mul(c.drift, c.inv_t)),
                       mul(0.5f, add(mul(mul(ind, dvm), c.dt), mul(mul(vp, c.dt), c.inv_t)))),
                   mul(dsqm, sx));
        s[10] = add(sub(add(dvm, mul(mul(mul(c.kappa, sub(c.theta, vp)), c.dt), c.inv_t)),
                        mul(mul(mul(c.kappa, ind), dvm), c.dt)),
                    mul(mul(c.sigma_v, dsqm), sv));
      }
    }
  }
  x = x_new;
  v = v_new;
}

}  // namespace heston
}  // namespace optionslab
