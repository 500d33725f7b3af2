// One Andersen (2008) quadratic-exponential step of a Heston path, shared by
// heston_qe.cu (the QE price and ladder kernels) and heston_exotic.cu. The
// twin is ops/heston_kernel.py::_qe_advance.
//
// The variance step samples the moment-matched law: both the quadratic
// (ψ ≤ 1.5) and the exponential branch are computed and one is selected,
// with the reference's 1e-30 / 1e-10 / 1 − 1e-7 guards. The spot step folds
// the correlation into the k-weights (Andersen eq. 33, γ1 = γ2 = 1/2), so
// its shock zx is the independent normal. Every product is rounded on its
// own in the reference's association order, so a path is bitwise its plain
// twin's.
#pragma once

#include "heston_euler.cuh"  // the rounded arithmetic helpers

namespace optionslab {
namespace heston {

constexpr float kQePMax = static_cast<float>(1.0 - 1e-7);

// c: mu_dt, emkd, c1, s2_v, s2_0, k0, k1, k2, k3, k4 (the first ten of the
// eleven per-set constants; the eleventh, v0, seeds the path).
__device__ __forceinline__ void qe_advance(const float* c, float& x, float& v, float zv, float zx,
                                           float u) {
  const float m = add(c[2], mul(c[1], v));
  const float s2 = add(mul(c[3], v), c[4]);
  const float psi = quo(s2, fmaxf(mul(m, m), 1e-30f));
  // quadratic branch (ψ ≤ 1.5)
  const float inv_psi = quo(2.0f, fmaxf(psi, 1e-10f));
  const float b2 = fmaxf(
      add(sub(inv_psi, 1.0f), sqrtf(fmaxf(mul(inv_psi, sub(inv_psi, 1.0f)), 0.0f))), 0.0f);
  const float a = quo(m, add(1.0f, b2));
  const float root = add(sqrtf(b2), zv);
  const float v_quad = mul(a, mul(root, root));
  // exponential branch (ψ > 1.5)
  const float p_mass = fminf(fmaxf(quo(sub(psi, 1.0f), add(psi, 1.0f)), 0.0f), kQePMax);
  const float beta = quo(sub(1.0f, p_mass), fmaxf(m, 1e-30f));
  const float v_log =
      quo(logf(quo(sub(1.0f, p_mass), fmaxf(sub(1.0f, u), 1e-30f))), fmaxf(beta, 1e-30f));
  const float v_exp = u <= p_mass ? 0.0f : v_log;
  const float v_new = psi <= 1.5f ? v_quad : v_exp;
  x = add(add(add(add(add(x, c[0]), c[5]), mul(c[6], v)), mul(c[7], v_new)),
          mul(sqrtf(fmaxf(add(mul(c[8], v), mul(c[9], v_new)), 0.0f)), zx));
  v = v_new;
}

}  // namespace heston
}  // namespace optionslab
