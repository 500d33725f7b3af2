// The warp-partitioned tridiagonal solve: one system of n unknowns shared by
// the 32 lanes of a warp (theta_pde.cu's jump-table loop, lv_pde.cu's
// local-vol loop). Thomas's algorithm walks n dependent nodes; split over the
// lanes, a solve's chain is about 2⌈n/32⌉ nodes and a few shuffle stages.
//
// The partition. P = 32 lanes, m = rows_per_lane(n) = max(2, ⌈n/32⌉) rows a
// lane, P and m set by n alone: lane p holds rows p·m … p·m + m − 1. Rows
// from n on are padding (a = c = d = 0, b = 1), and a_0 and c_{n−1} are taken
// as 0. A lane's first m − 1 rows are its interior, its last row its
// separator y_p. The matrices of every caller are diagonally dominant (the
// θ-scheme's I − θ·dt·L, Howard's identity rows u = ψ, the local-vol steps):
// so are the interior blocks and the reduced system, and no pivot is guarded
// or exchanged.
//
// The factors (the matrix's part: form_local, then form_reduced).
//   Forward over the interior, i = 0 … m − 2:
//     piv = b_0 (i = 0), b_i − a_i·γ_{i−1};  ρ_i = 1/piv;  ℓ_i = a_i·ρ_i;
//     (each 1/x here is the correctly rounded reciprocal, __frcp_rn: the
//     division 1/x's bits, which torch's ones/x gives);
//     γ_i = c_i·ρ_i;  α_0 = ℓ_0, α_i = −(ℓ_i·α_{i−1}).
//   Backward, i = m − 3 … 0 (α'_{m−2} = α_{m−2}, γ'_{m−2} = γ_{m−2}):
//     α'_i = α_i − γ_i·α'_{i+1};  γ'_i = −(γ_i·γ'_{i+1}).
//   Interior row i is then x_i = δ'_i − α'_i·y_{p−1} − γ'_i·y_p.
//   The separators' reduced system A·y_{p−1} + B·y_p + C·y_{p+1} = D, with a,
//   b, c the separator row's and ⁺ lane p + 1's:
//     A = −(a·α'_{m−2});  B = (b − a·γ'_{m−2}) − c·α'_0⁺;  C = −(c·γ'_0⁺).
//   Cyclic reduction over the lanes at strides s = 1, 2, 4, 8, 16 (⁻, ⁺:
//   lanes p ∓ s): k1 = A/B⁻;  k2 = C/B⁺;  A ← −(A⁻·k1);
//   B ← (B − C⁻·k1) − A⁺·k2;  C ← −(C⁺·k2).  Then r_B = 1/B.
// A solve on them (solve: the right-hand side's pass):
//   δ_0 = d_0·ρ_0, δ_i = d_i·ρ_i − ℓ_i·δ_{i−1};  δ'_i = δ_i − γ_i·δ'_{i+1}
//   (δ'_{m−2} = δ_{m−2});  D = (d_{m−1} − a·δ_{m−2}) − c·δ'_0⁺;  at each stride
//   D ← (D − D⁻·k1) − D⁺·k2;  y = D·r_B;  x_i = (δ'_i − α'_i·y⁻) − γ'_i·y
//   (y⁻ lane p − 1's separator), x_{m−1} = y.
// Every product, difference and quotient is rounded on its own (the __*_rn
// intrinsics, never contracted into an FMA) in exactly this order, and a
// shuffle from past the warp's end gives the lane its own value (its factor
// is ±0 there), so the plain torch model (ops/tridiag.py warp_factors,
// warp_solve_rhs) reproduces a kernel's solve bit for bit, float32 and
// float64.
//
// Storage. A lane's rows are a store: Regs<T, K> holds them in registers (K a
// compile-time capacity, every loop over the rows unrolled to K with its
// index known at compile time: an array indexed at run time would spill to
// local memory), Mem<T> in shared or device memory, row i of lane p at
// p + 32·i of a plane (the lanes of a warp read one row's 32 words: no bank
// conflict). K = 0 means memory, and its loops run over m at run time.
//
// With K > 0 the passes have no branch: every one of the K rows is computed
// and selections keep the m real rows' values (a branch on m, or on a row's
// place in the grid, cut the unrolled code into pieces the compiler could
// not schedule across, and a lane-dependent one split the warp: ≈60 cycles
// a row on the card). The rows past m are identity rows (a = c = 0, b = 1)
// and a plane of a factor set in memory has K rows, so those rows read and
// write in bounds. A quotient whose numerator may be zero (k1 and k2 on the
// lanes past the reduction's ends) is tri::quotient: the division's slow
// path took ≈500 cycles a stage.
#pragma once

#include <cuda_runtime.h>

#include "tridiag.cuh"

namespace optionslab {
namespace wtri {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 5;  // the reduced system's strides 1, 2, 4, 8, 16
// a lane's scalar factors: the separator's a and c, r_B, k1 and k2 a stage
enum Scalar { kSa = 0, kSc = 1, kRb = 2, kK1 = 3, kK2 = kK1 + kStages, kScalars = kK2 + kStages };
constexpr int kPlanes = 5;  // ρ, ℓ, γ, α', γ': a value a row

__host__ __device__ constexpr int rows_per_lane(int n) {
  return n <= 2 * kLanes ? 2 : (n + kLanes - 1) / kLanes;
}

// Values of one factor set of a warp in memory: kPlanes planes of `rows`
// rows and the scalars, 32 lanes each.
__host__ __device__ constexpr int factor_values(int rows) {
  return (kPlanes * rows + kScalars) * kLanes;
}

// The register capacity K of a kernel instance for n unknowns of `size`
// bytes: 8 or 16 rows a lane in float32, 8 in float64, else 0 (the rows in
// memory). ops/tridiag.py warp_capacity is the same rule.
__host__ __device__ constexpr int register_rows(int n, int size) {
  return rows_per_lane(n) <= 8 ? 8 : (size == 4 && rows_per_lane(n) <= 16 ? 16 : 0);
}


template <typename T, int K>
struct Regs {
  T v[K + 1];  // a spare entry: a neighbour one past the last row indexes in bounds
  __device__ __forceinline__ T get(int i) const { return v[i]; }
  __device__ __forceinline__ void set(int i, T x) { v[i] = x; }
};

template <typename T>
struct Mem {
  T* p;  // this lane's row 0
  __device__ __forceinline__ T get(int i) const { return p[i * kLanes]; }
  __device__ __forceinline__ void set(int i, T x) const { p[i * kLanes] = x; }
};

// A lane's factors: the five row planes and the scalars.
template <class S, class Sc>
struct Factors {
  S rho, ell, gam, alf, gaf;
  Sc s;
};

template <typename T, int K>
using RegFactors = Factors<Regs<T, K>, Regs<T, kScalars>>;
template <typename T>
using MemFactors = Factors<Mem<T>, Mem<T>>;

// The factors of a warp at `base` (factor_values(rows) values), this lane's.
template <typename T>
__device__ __forceinline__ MemFactors<T> mem_factors(T* base, int rows) {
  T* p = base + (threadIdx.x & (kLanes - 1));
  const int plane = rows * kLanes;
  return {{p}, {p + plane}, {p + 2 * plane}, {p + 3 * plane}, {p + 4 * plane}, {p + 5 * plane}};
}

// f(i) for rows i = lo … hi − 1 in order: unrolled to K with i known at
// compile time (K > 0), or a loop at run time (K = 0).
template <int K, typename F>
__device__ __forceinline__ void rows_up(int lo, int hi, F&& f) {
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i >= lo && i < hi) f(i);
    }
  } else {
    for (int i = lo; i < hi; ++i) f(i);
  }
}

// f(i) for rows i = hi − 1 down to lo.
template <int K, typename F>
__device__ __forceinline__ void rows_down(int hi, int lo, F&& f) {
  if constexpr (K > 0) {
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      if (i >= lo && i < hi) f(i);
    }
  } else {
    for (int i = hi - 1; i >= lo; --i) f(i);
  }
}

// Row m − 1 of a store (a run-time index into registers, without spilling).
template <int K, typename T, class S>
__device__ __forceinline__ T last_row(int m, const S& s) {
  if constexpr (K > 0) {
    T r = s.get(0);
#pragma unroll
    for (int i = 1; i < K; ++i) r = i < m ? s.get(i) : r;
    return r;
  } else {
    return s.get(m - 1);
  }
}

// What form_reduced needs of a lane's block: α'_0, γ'_0, α'_{m−2}, γ'_{m−2}
// and the separator row's a, b, c.
template <typename T>
struct Edge {
  T alf0, gaf0, alf1, gaf1, sa, sb, sc;
};

// The factors of a lane's block from its rows a(i), b(i), c(i), i < m: the
// forward and backward passes over its interior into f's planes. Returns the
// block's edge. One lane's work: no shuffle.
template <int K, typename T, class F, class GA, class GB, class GC>
__device__ __forceinline__ Edge<T> form_local(int m, const GA& a, const GB& b, const GC& c,
                                              F& f) {
  using A = tri::Arith<T>;
  Edge<T> e;
  T gam = T(0), alf = T(0);
  if constexpr (K > 0) {  // every row, the real ones kept by selections
    // both passes on registers, the factors stored after them (a store in
    // memory read back by the backward pass would put its latency on the
    // chain)
    T rr[K], ll[K], gg[K], aa[K], ga[K];
    e = {T(0), T(0), T(0), T(0), T(0), T(1), T(0)};
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T ai = a(i), bi = b(i), ci = c(i);
      const T piv = i == 0 ? bi : A::sub(bi, A::mul(ai, gam));
      rr[i] = A::rcp(piv);
      ll[i] = A::mul(ai, rr[i]);
      gam = A::mul(ci, rr[i]);
      alf = i == 0 ? ll[i] : -A::mul(ll[i], alf);
      gg[i] = gam;
      aa[i] = alf;
      ga[i] = gam;
      const bool last = i == m - 2, sep = i == m - 1;
      e.alf1 = last ? alf : e.alf1;
      e.gaf1 = last ? gam : e.gaf1;
      e.sa = sep ? ai : e.sa;
      e.sb = sep ? bi : e.sb;
      e.sc = sep ? ci : e.sc;
    }
    T af = e.alf1, gf = e.gaf1;
#pragma unroll
    for (int i = K - 2; i >= 0; --i) {
      const bool on = i <= m - 3;
      const T a_new = A::sub(aa[i], A::mul(gg[i], af));
      const T g_new = -A::mul(gg[i], gf);
      af = on ? a_new : af;
      gf = on ? g_new : gf;
      aa[i] = on ? a_new : aa[i];
      ga[i] = on ? g_new : ga[i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      f.rho.set(i, rr[i]);
      f.ell.set(i, ll[i]);
      f.gam.set(i, gg[i]);
      f.alf.set(i, aa[i]);
      f.gaf.set(i, ga[i]);
    }
    e.alf0 = af;
    e.gaf0 = gf;
    return e;
  }
  rows_up<K>(0, m, [&](int i) {
    const T ai = a(i), bi = b(i), ci = c(i);
    if (i < m - 1) {
      const T piv = i == 0 ? bi : A::sub(bi, A::mul(ai, gam));
      const T r = A::rcp(piv);
      const T l = A::mul(ai, r);
      gam = A::mul(ci, r);
      alf = i == 0 ? l : -A::mul(l, alf);
      f.rho.set(i, r);
      f.ell.set(i, l);
      f.gam.set(i, gam);
      f.alf.set(i, alf);
      f.gaf.set(i, gam);
    } else {
      e.sa = ai;
      e.sb = bi;
      e.sc = ci;
    }
  });
  e.alf1 = alf;
  e.gaf1 = gam;
  rows_down<K>(m - 2, 0, [&](int i) {
    const T g = f.gam.get(i);
    alf = A::sub(f.alf.get(i), A::mul(g, alf));
    gam = -A::mul(g, gam);
    f.alf.set(i, alf);
    f.gaf.set(i, gam);
  });
  e.alf0 = alf;
  e.gaf0 = gam;
  return e;
}

// The reduced system's factors from every lane's edge: the separator's row,
// then the kStages strides of cyclic reduction, then r_B. All 32 lanes call
// it.
template <typename T, class F>
__device__ __forceinline__ void form_reduced(const Edge<T>& e, F& f) {
  using A = tri::Arith<T>;
  const T alf_next = __shfl_down_sync(kFull, e.alf0, 1);
  const T gaf_next = __shfl_down_sync(kFull, e.gaf0, 1);
  T ra = -A::mul(e.sa, e.alf1);
  T rb = A::sub(A::sub(e.sb, A::mul(e.sa, e.gaf1)), A::mul(e.sc, alf_next));
  T rc = -A::mul(e.sc, gaf_next);
  f.s.set(kSa, e.sa);
  f.s.set(kSc, e.sc);
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int s = 1 << st;
    const T au = __shfl_up_sync(kFull, ra, s), bu = __shfl_up_sync(kFull, rb, s);
    const T cu = __shfl_up_sync(kFull, rc, s);
    const T ad = __shfl_down_sync(kFull, ra, s), bd = __shfl_down_sync(kFull, rb, s);
    const T cd = __shfl_down_sync(kFull, rc, s);
    const T k1 = tri::quotient(ra, bu);
    const T k2 = tri::quotient(rc, bd);
    ra = -A::mul(au, k1);
    rb = A::sub(A::sub(rb, A::mul(cu, k1)), A::mul(ad, k2));
    rc = -A::mul(cd, k2);
    f.s.set(kK1 + st, k1);
    f.s.set(kK2 + st, k2);
  }
  f.s.set(kRb, A::rcp(rb));
}

// One solve on the factors f: the right-hand side d(i), i < m, the solution
// into x (which may be d's store: each row is read before it is written).
// All 32 lanes call it.
template <int K, typename T, class F, class D, class X>
__device__ __forceinline__ void solve(int m, const F& f, const D& d, X& x) {
  using A = tri::Arith<T>;
  T e = T(0), d_last = T(0);
  if constexpr (K > 0) {  // every row, the real ones kept by selections
    T e_last = T(0);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T di = d(i);
      const T q = A::mul(di, f.rho.get(i));
      e = i == 0 ? q : A::sub(q, A::mul(f.ell.get(i), e));
      x.set(i, e);
      e_last = i == m - 2 ? e : e_last;
      d_last = i == m - 1 ? di : d_last;
    }
    e = e_last;
#pragma unroll
    for (int i = K - 2; i >= 0; --i) {
      const T x_old = x.get(i);
      const T cand = A::sub(x_old, A::mul(f.gam.get(i), e));
      const bool on = i <= m - 3;
      e = on ? cand : e;
      x.set(i, on ? cand : x_old);
    }
    const T e_next = __shfl_down_sync(kFull, e, 1);
    T dd = A::sub(A::sub(d_last, A::mul(f.s.get(kSa), e_last)), A::mul(f.s.get(kSc), e_next));
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      const int s = 1 << st;
      const T du = __shfl_up_sync(kFull, dd, s);
      const T dn = __shfl_down_sync(kFull, dd, s);
      dd = A::sub(A::sub(dd, A::mul(du, f.s.get(kK1 + st))), A::mul(dn, f.s.get(kK2 + st)));
    }
    const T y = A::mul(dd, f.s.get(kRb));
    const T y_left = __shfl_up_sync(kFull, y, 1);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const T x_old = x.get(i);
      const T xi = A::sub(A::sub(x_old, A::mul(f.alf.get(i), y_left)), A::mul(f.gaf.get(i), y));
      x.set(i, i < m - 1 ? xi : (i == m - 1 ? y : x_old));
    }
    return;
  }
  rows_up<K>(0, m, [&](int i) {
    const T di = d(i);
    if (i < m - 1) {
      const T q = A::mul(di, f.rho.get(i));
      e = i == 0 ? q : A::sub(q, A::mul(f.ell.get(i), e));
      x.set(i, e);
    } else {
      d_last = di;
    }
  });
  const T e_last = e;
  rows_down<K>(m - 2, 0, [&](int i) {
    e = A::sub(x.get(i), A::mul(f.gam.get(i), e));
    x.set(i, e);
  });
  const T e_next = __shfl_down_sync(kFull, e, 1);
  T dd = A::sub(A::sub(d_last, A::mul(f.s.get(kSa), e_last)), A::mul(f.s.get(kSc), e_next));
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int s = 1 << st;
    const T du = __shfl_up_sync(kFull, dd, s);
    const T dn = __shfl_down_sync(kFull, dd, s);
    dd = A::sub(A::sub(dd, A::mul(du, f.s.get(kK1 + st))), A::mul(dn, f.s.get(kK2 + st)));
  }
  const T y = A::mul(dd, f.s.get(kRb));
  const T y_left = __shfl_up_sync(kFull, y, 1);
  rows_up<K>(0, m, [&](int i) {
    if (i < m - 1) {
      x.set(i, A::sub(A::sub(x.get(i), A::mul(f.alf.get(i), y_left)), A::mul(f.gaf.get(i), y)));
    } else {
      x.set(i, y);
    }
  });
}

// Copies factors (the planes' rows, K or the m − 1 interior ones, and the
// scalars).
template <int K, typename T, class F, class G>
__device__ __forceinline__ void copy_factors(int m, const F& from, G& to) {
  rows_up<K>(0, K > 0 ? K : m - 1, [&](int i) {
    to.rho.set(i, from.rho.get(i));
    to.ell.set(i, from.ell.get(i));
    to.gam.set(i, from.gam.get(i));
    to.alf.set(i, from.alf.get(i));
    to.gaf.set(i, from.gaf.get(i));
  });
#pragma unroll
  for (int j = 0; j < kScalars; ++j) to.s.set(j, from.s.get(j));
}

}  // namespace wtri
}  // namespace optionslab
