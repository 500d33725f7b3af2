// Running path statistics and payoffs in relative log space x = log(S/S0),
// shared by the Heston/Bates exotic kernel (heston_exotic.cu) and the SLV
// kernel (slv_mc.cu); the local-vol kernel (local_vol_mc.cu) takes the
// barrier test and the lookbacks' start-state term. Their twins are
// ops/heston_exotic_kernel.py's and ops/slv_kernel.py's statistic and payoff
// functions.
//
// Templated on the kernel's context, which carries s0, k, log_b, a..e,
// inv_n, rdt, dt, cp, mode and period: the payoff family is a template
// parameter, the kind within it (barrier side, in/out, one-/no-touch,
// floating/fixed and max/min lookback) runs on `mode`.
#pragma once

#include "fp.cuh"

namespace optionslab {
namespace stats {

using fp::add;
using fp::ind;
using fp::mul;
using fp::sub;

// kHit: barriers and touches paid at expiry; kHitAt: touches paid at the
// first hit (discounted in the step loop); kEuro: no statistic (SLV only)
enum Family : int {
  kAsianArith = 0, kAsianGeo, kLookback, kHit, kHitAt, kCliquet, kAutocall, kRange, kEuro
};
// barrier/touch families: mode = side | payoff << 2; lookback: bit 0
// floating strike, bit 1 running minimum
enum Side : int { kUp = 0, kDown = 1, kDouble = 2 };
enum HitPayoff : int { kKnockOut = 0, kKnockIn = 1, kOneTouch = 2, kNoTouch = 3 };

// 1 where x lies at or beyond the level (either level of a double band)
template <class Ctx>
__device__ __forceinline__ float hit_now(const Ctx& c, float x) {
  const int side = c.mode & 3;
  if (side == kDouble) return ind(x <= c.a || x >= c.b);
  return ind(side == kUp ? x >= c.log_b : x <= c.log_b);
}

// statistics at x0 = 0 (S0 included: a level already crossed counts as hit)
template <int F, class Ctx>
__device__ __forceinline__ void init_stat(const Ctx& c, float* st) {
  st[0] = st[1] = st[2] = st[3] = 0.0f;
  if (F == kAutocall) st[0] = 1.0f;                                 // (alive, ki, pv, dr)
  if (F == kHit || F == kHitAt) st[0] = st[1] = hit_now(c, 0.0f);  // (hit, pv at hit, dr)
}

template <int F, bool kLr, class Ctx>
__device__ __forceinline__ void update_stat(const Ctx& c, float* st, float x, int i) {
  if (F == kAsianArith) {
    st[0] = add(st[0], expf(x));  // relative prices
  } else if (F == kAsianGeo) {
    st[0] = add(st[0], x);
  } else if (F == kLookback) {
    st[0] = (c.mode & 2) ? fminf(st[0], x) : fmaxf(st[0], x);
  } else if (F == kHit) {
    st[0] = fmaxf(st[0], hit_now(c, x));
  } else if (F == kHitAt) {
    const float now = hit_now(c, x);
    const float newly = mul(sub(1.0f, st[0]), now);
    const float steps = static_cast<float>(i + 1);
    const float df_i = expf(mul(-c.rdt, steps));
    st[1] = add(st[1], mul(newly, df_i));
    if (kLr) st[2] = sub(st[2], mul(mul(mul(steps, c.dt), newly), df_i));
    st[0] = fmaxf(st[0], now);
  } else if (F == kCliquet) {  // (period-start x, capped-return sum)
    const float is_end = ind((i + 1) % c.period == 0);
    const float capped = fminf(fmaxf(sub(expf(sub(x, st[0])), 1.0f), c.a), c.b);
    st[1] = add(st[1], mul(is_end, capped));
    st[0] = add(st[0], mul(is_end, sub(x, st[0])));
  } else if (F == kAutocall) {
    st[1] = fmaxf(st[1], ind(x <= c.c));
    const float is_obs = ind((i + 1) % c.period == 0);
    const float steps = static_cast<float>(i + 1);
    const float df_i = expf(mul(-c.rdt, steps));
    const float called = mul(mul(st[0], is_obs), ind(x >= c.a));
    const float couponed = mul(mul(st[0], is_obs), ind(x >= c.b));
    const float cash = add(mul(c.d, couponed), mul(c.e, called));
    st[2] = add(st[2], mul(df_i, cash));
    st[0] = mul(st[0], sub(1.0f, called));
    if (kLr) st[3] = sub(st[3], mul(mul(mul(steps, c.dt), df_i), cash));
  } else if (F == kRange) {  // corridor [A, B] in relative log space
    st[0] = add(st[0], ind(x >= c.a && x <= c.b));
  }  // kEuro: no statistic
}

// the autocall's final redemption at expiry (undiscounted)
template <class Ctx>
__device__ __forceinline__ float autocall_final(const Ctx& c, const float* st, float x) {
  const float loss = fmaxf(sub(1.0f, expf(x)), 0.0f);
  return mul(c.e, sub(1.0f, mul(st[1], loss)));
}

template <int F, class Ctx>
__device__ __forceinline__ float payoff(const Ctx& c, const float* st, float x, float df_t) {
  if (F == kAsianArith) {
    return fmaxf(mul(c.cp, sub(mul(mul(c.s0, st[0]), c.inv_n), c.k)), 0.0f);
  } else if (F == kAsianGeo) {
    return fmaxf(mul(c.cp, sub(mul(c.s0, expf(mul(st[0], c.inv_n))), c.k)), 0.0f);
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
  } else if (F == kCliquet) {
    return mul(c.e, fminf(fmaxf(st[1], c.c), c.d));
  } else if (F == kAutocall) {  // discounted in the kernel
    return add(st[2], mul(mul(st[0], df_t), autocall_final(c, st, x)));
  } else if (F == kRange) {
    return mul(mul(c.e, st[0]), c.inv_n);
  } else {  // kEuro
    return fmaxf(mul(c.cp, sub(mul(c.s0, expf(x)), c.k)), 0.0f);
  }
}

// ∂pay/∂x0 of a lookback whose extremum `ext` (of x) was attained at t = 0:
// the floating call pays S_T − min, the put max − S_T; the fixed strike pays
// where S0 is in the money
template <class Ctx>
__device__ __forceinline__ float lookback_start_term(const Ctx& c, float ext) {
  const float at0 = ind(ext == 0.0f);
  if (c.mode & 1) return c.cp > 0.0f ? -at0 : at0;
  return mul(mul(c.cp, at0), ind(mul(c.cp, sub(c.s0, c.k)) > 0.0f));
}

}  // namespace stats
}  // namespace optionslab
