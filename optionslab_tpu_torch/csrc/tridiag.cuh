// The Thomas algorithm on systems held in shared memory, shared by the
// batched tridiagonal solve (tridiag.cu), the θ-scheme time loop
// (theta_pde.cu) and the Douglas ADI loops (heston_adi.cu).
//
// Two solves. Where a system's matrix changes from one solve to the next,
// two lanes walk it (forward_split): the pivots' chain and the right-hand
// side's a node behind. Where it does not, its pivots are formed once into
// tables (form_tables: den_j, c'_j and the reciprocal RN(1/den_j)) and each
// solve runs only the right-hand side's chain, one lane a system
// (rhs_chain), each quotient by den_j as three dependent operations on the
// reciprocal (fast_quotient) where they round as the division does.
//
// Arithmetic. Each product, difference and quotient is rounded on its own
// (the __*_rn intrinsics are never contracted into an FMA), in the plain
// torch version's order (ops/tridiag.py _tridiag_plain), with its pivot
// guard: a pivot below 1e-30 in magnitude becomes sign·1e-30 + 1e-30. So a
// kernel that solves through these functions equals the plain loop bit for
// bit, in float32 and in float64.
//
// Layout. Two lanes walk one system (forward_split). Node j of a system
// sits at column[j * pitch] of its tile's planes, the column being the
// system's place in the tile: the lanes of a warp read neighbouring words
// of one row, so no load has a bank conflict. Each plane has kPad rows of
// padding at both ends.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace optionslab {
namespace tri {

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  static __device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
  static __device__ __forceinline__ float mag(float a) { return fabsf(a); }
  // torch.maximum on the card (::max of two floats) without NaNs
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static constexpr float kTiny = 1e-30f;
  // fast_quotient's range (powers of two): see there
  static constexpr float kDenLo = 0x1p-125f, kDenHi = 0x1p125f;
  static constexpr float kNumLo = 0x1p-100f, kNumHi = 0x1p126f;
  static constexpr float kQuoLo = 0x1p-124f, kQuoHi = 0x1p125f;
  // flagged_quotient's scaling, and its least scaled q0
  static constexpr float kScale = 0x1p64f, kUnscale = 0x1p-64f, kScaledLo = 0x1p-61f;
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  static __device__ __forceinline__ double mag(double a) { return fabs(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static constexpr double kTiny = 1e-30;
  static constexpr double kDenLo = 0x1p-1021, kDenHi = 0x1p1021;
  static constexpr double kNumLo = 0x1p-960, kNumHi = 0x1p1022;
  static constexpr double kQuoLo = 0x1p-1020, kQuoHi = 0x1p1021;
  static constexpr double kScale = 0x1p512, kUnscale = 0x1p-512, kScaledLo = 0x1p-509;
};

// The pivot's guard: a pivot below 1e-30 in magnitude becomes
// sign·1e-30 + 1e-30, that is 2e-30, +0 or 1e-30 (each sum exact).
template <typename T>
__device__ __forceinline__ T guard_pivot(T den) {
  using A = Arith<T>;
  const T guarded = den > T(0) ? T(2) * A::kTiny : (den < T(0) ? T(0) : A::kTiny);
  return A::mag(den) < A::kTiny ? guarded : den;
}

// num / den rounded as the quotient intrinsic rounds it. The intrinsic
// checks its operands' range first and sends a zero numerator down its slow
// path; here a zero numerator divides 1 instead and the quotient is scaled
// by the zero: num·(1/den) is the zero of sign sign(num) xor sign(den) that
// num/den is (NaN for den = 0 or NaN, as num/den), and x·1 is x. The PDEs
// divide zeros at every node where the value or an exercise row is zero.
template <typename T>
__device__ __forceinline__ T quotient(T num, T den) {
  using A = Arith<T>;
  const bool zero = num == T(0);
  return A::mul(A::quo(zero ? T(1) : num, den), zero ? num : T(1));
}

// The reciprocal table's entry for a pivot den: RN(1/den) where
// fast_quotient may divide by den, else NaN, which sends every quotient by
// den down tri::quotient: a pivot the guard replaced (by 2e-30, 1e-30 or 0)
// and one outside [kDenLo, kDenHi], whose reciprocal could leave the normal
// range.
template <typename T>
__device__ __forceinline__ T table_rcp(T den, bool guarded) {
  using A = Arith<T>;
  const T m = A::mag(den);
  return !guarded && m >= A::kDenLo && m <= A::kDenHi ? A::rcp(den) : A::nan();
}

// num / den by its table's reciprocal y = RN(1/den) in three dependent
// operations: q0 = RN(num·y), the residual num − den·q0 (exact, one FMA) and
// Markstein's correction RN(q0 + residual·y) (one FMA): the correctly rounded
// quotient, the division's own bits, wherever nothing leaves the normal
// range. The range check runs beside the chain and sets `bad` where num lies
// outside [kNumLo, kNumHi] or q0 outside [kQuoLo, kQuoHi], NaN and infinity
// included (a NaN reciprocal makes q0 NaN); the caller sends such a node back
// through flagged_quotient (not tri::quotient, whose zero trick holds only
// for a guarded pivot: 0·(1/den) is NaN where 1/den overflows, as for a
// subnormal den, and the card's division check found it). A zero numerator
// stays on the fast path: q0 is then the zero of the quotient's sign, which
// the correction would lose (+0 plus −0 is +0). (Flagging −0 by its bits in
// place of this selection measured 1.8× slower on the card.)
template <typename T>
__device__ __forceinline__ T fast_quotient(T num, T den, T y, bool& bad) {
  using A = Arith<T>;
  const T q0 = A::mul(num, y);
  const T q = A::fma(A::fma(-den, q0, num), y, q0);
  const T an = A::mag(num);
  const T aq = A::mag(q0);
  const bool zero = num == T(0);
  bad |= !(an <= A::kNumHi && aq <= A::kQuoHi && (zero || (an >= A::kNumLo && aq >= A::kQuoLo)));
  return zero ? q0 : q;
}

// num / den for a node fast_quotient flagged. Where num is small (a wing of
// the grid decaying to zero) but the quotient normal, the same three
// operations on num·kScale (exact: a power of two) give the correctly rounded
// quotient of that, and times kUnscale (exact, the quotient being normal)
// num/den's; a zero, subnormal, infinite or NaN quotient, a divisor without a
// reciprocal and a numerator too large to scale take the division itself.
template <typename T>
__device__ __forceinline__ T flagged_quotient(T num, T den, T y) {
  using A = Arith<T>;
  const T ns = A::mul(num, A::kScale);
  const T q0 = A::mul(ns, y);
  const T q = A::fma(A::fma(-den, q0, ns), y, q0);
  const T an = A::mag(ns);
  const T aq = A::mag(q0);
  const bool ok = an >= A::kNumLo && an <= A::kNumHi && aq >= A::kScaledLo && aq <= A::kQuoHi;
  return ok ? A::mul(q, A::kUnscale) : A::quo(num, den);
}

// One node of the back substitution.
template <typename T>
__device__ __forceinline__ T back_node(T c, T d, T x_next) {
  return Arith<T>::sub(d, Arith<T>::mul(c, x_next));
}

template <typename T>
__device__ __forceinline__ T ld_shared(unsigned addr);
template <>
__device__ __forceinline__ float ld_shared<float>(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
template <>
__device__ __forceinline__ double ld_shared<double>(unsigned addr) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_shared(unsigned addr, double v) {
  asm volatile("st.shared.f64 [%0], %1;" ::"r"(addr), "d"(v) : "memory");
}

// One system's column of a tile in shared memory: node j at byte address
// addr + j·stride of the shared window. The solve reads and writes its
// columns by ld.shared / st.shared on these 32-bit addresses: through a
// generic pointer, sm_90 code recomputes the window's base (a long-latency
// read of the cluster CTA id) before each store, and that wait sat on the
// chain.
template <typename T>
struct Col {
  unsigned addr;
  unsigned stride;
  __device__ __forceinline__ T operator[](int j) const { return ld_shared<T>(addr + j * stride); }
  __device__ __forceinline__ void put(int j, T v) const { st_shared(addr + j * stride, v); }
  // the column seen from node j, walking dir = ±1 node a step (a step
  // towards node 0 wraps the unsigned stride: the addresses are modular)
  __device__ __forceinline__ Col walk(int j, int dir) const {
    return Col{addr + j * stride, static_cast<unsigned>(dir) * stride};
  }
};

// 16 bytes of shared memory as T values: ld.shared / st.shared .v4.f32 or
// .v2.f64 at a 16-byte aligned byte address of the shared window.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(unsigned a, float* v) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(a)
                 : "memory");
  }
  static __device__ __forceinline__ void store(unsigned a, const float* v) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(v[0]), "f"(v[1]),
                 "f"(v[2]), "f"(v[3])
                 : "memory");
  }
};
template <>
struct Vec16<double> {
  static constexpr int kN = 2;
  static __device__ __forceinline__ void load(unsigned a, double* v) {
    asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];" : "=d"(v[0]), "=d"(v[1]) : "r"(a) : "memory");
  }
  static __device__ __forceinline__ void store(unsigned a, const double* v) {
    asm volatile("st.shared.v2.f64 [%0], {%1, %2};" ::"r"(a), "d"(v[0]), "d"(v[1]) : "memory");
  }
};

// Nodes [i0, i0 + U) of a shared-memory row (node j at row0 + j·sizeof(T))
// walked from node `first` in direction kDir, as a lane's registers v[q] =
// node i0 + q, loaded (or stored) by 16-byte vectors: the group's lowest
// node, first + i0 (kDir = 1) or first − i0 − U + 1, on a 16-byte boundary.
template <typename T, int kDir, int U>
__device__ __forceinline__ unsigned group_addr(unsigned row0, int first, int i0) {
  const int low = kDir > 0 ? first + i0 : first - i0 - U + 1;
  return row0 + static_cast<unsigned>(low * static_cast<int>(sizeof(T)));
}
template <typename T, int kDir, int U>
__device__ __forceinline__ void group_load(unsigned row0, int first, int i0, T (&v)[U]) {
  constexpr int V = Vec16<T>::kN;
  const unsigned a = group_addr<T, kDir, U>(row0, first, i0);
#pragma unroll
  for (int k = 0; k < U / V; ++k) {
    T w[V];
    Vec16<T>::load(a + k * 16, w);
#pragma unroll
    for (int e = 0; e < V; ++e) v[kDir > 0 ? k * V + e : U - 1 - (k * V + e)] = w[e];
  }
}
template <typename T, int kDir, int U>
__device__ __forceinline__ void group_store(unsigned row0, int first, int i0, const T (&v)[U]) {
  constexpr int V = Vec16<T>::kN;
  const unsigned a = group_addr<T, kDir, U>(row0, first, i0);
#pragma unroll
  for (int k = 0; k < U / V; ++k) {
    T w[V];
#pragma unroll
    for (int e = 0; e < V; ++e) w[e] = v[kDir > 0 ? k * V + e : U - 1 - (k * V + e)];
    Vec16<T>::store(a + k * 16, w);
  }
}

// Nodes of an FMA chain whose operands a lane loads together, before the
// chain (theta_pde.cu's reverse sweeps, and tridiag.cu's probe of them).
template <typename T>
constexpr int kWalk = sizeof(T) == 4 ? 16 : 8;

// A chain's view of a row from its first node, kDir = ±1 node a step known
// at compile time (node i of a group at an immediate offset from the group's
// first address): P the row's place, a byte address of the shared window
// (unsigned) or a pointer to device memory (T*).
template <typename T, int kDir, typename P>
struct Walk {
  P at;
  __device__ __forceinline__ T operator[](int i) const {
    if constexpr (std::is_pointer_v<P>) {
      return at[i * kDir];
    } else {
      return ld_shared<T>(at + static_cast<unsigned>(i * kDir * static_cast<int>(sizeof(T))));
    }
  }
  __device__ __forceinline__ void put(int i, T v) const {
    if constexpr (std::is_pointer_v<P>) {
      at[i * kDir] = v;
    } else {
      st_shared(at + static_cast<unsigned>(i * kDir * static_cast<int>(sizeof(T))), v);
    }
  }
};

// Up to U nodes [i0, i0 + m) of a chain, its operands loaded first (each
// load predicated), then the chain: acc_i = fma(x_i, acc_{i−1}, y_i),
// y_i ← acc_i·r_i (kScale) or acc_i. Returns acc.
template <typename T, bool kScale, int U, typename X, typename Y>
__device__ __forceinline__ T walk_nodes(int i0, int m, T acc, const X& x, const X& r, const Y& y) {
  using A = Arith<T>;
  T rx[U], rr[U], ry[U];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (q < m) {
      rx[q] = x[i0 + q];
      if (kScale) rr[q] = r[i0 + q];
      ry[q] = y[i0 + q];
    }
  }
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (q < m) {
      acc = A::fma(rx[q], acc, ry[q]);
      y.put(i0 + q, kScale ? A::mul(acc, rr[q]) : acc);
    }
  }
  return acc;
}

// One chain of a run on rows of the shared route's tile (each row's node 0
// 16-byte aligned; x0, r0, y0 the rows' node-0 addresses), `len` nodes from
// node `first` walking kDir: acc_i = fma(x_i, acc_{i−1}, y_i) from acc_{−1} =
// 0, y_i ← acc_i·r_i (kScale: the Uᵀ sweep, z·r) or acc_i (the Lᵀ sweep, λ).
// The nodes up to the first 16-byte boundary in the walk's direction (at
// most 3), then whole groups of kWalk<T> nodes, each group's operands
// loaded by 16-byte vectors before its chain and its outputs stored by
// vectors after it, then the last nodes. Returns the last acc.
template <typename T, bool kScale, int kDir>
__device__ __forceinline__ T vec_walk(int len, int first, unsigned x0, unsigned r0,
                                      unsigned y0) {
  using A = Arith<T>;
  using W = Walk<T, kDir, unsigned>;
  constexpr int U = kWalk<T>;
  constexpr int V = Vec16<T>::kN;
  const unsigned from = static_cast<unsigned>(first * static_cast<int>(sizeof(T)));
  const W x{x0 + from}, r{r0 + from}, y{y0 + from};
  const int lead = min(kDir > 0 ? (V - first % V) % V : (first + 1) % V, len);
  T acc = walk_nodes<T, kScale, V>(0, lead, T(0), x, r, y);
  const int start = first + kDir * lead;  // the groups' first node
  const int full = (len - lead) / U;
  for (int g = 0; g < full; ++g) {
    T rx[U], rr[U], ry[U];
    group_load<T, kDir, U>(x0, start, g * U, rx);
    if (kScale) group_load<T, kDir, U>(r0, start, g * U, rr);
    group_load<T, kDir, U>(y0, start, g * U, ry);
#pragma unroll
    for (int q = 0; q < U; ++q) {
      acc = A::fma(rx[q], acc, ry[q]);
      ry[q] = kScale ? A::mul(acc, rr[q]) : acc;
    }
    group_store<T, kDir, U>(y0, start, g * U, ry);
  }
  const int done = lead + full * U;
  return walk_nodes<T, kScale, U>(done, len - done, acc, x, r, y);
}

template <typename T>
__device__ __forceinline__ Col<T> col(const void* node0, int column, int pitch) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(node0));
  return Col<T>{a + static_cast<unsigned>(column * sizeof(T)),
                static_cast<unsigned>(pitch * sizeof(T))};
}

// Node j of a lane's system: lower, diagonal, upper and right-hand side
// from their columns of a tile.
template <typename T>
struct Row {
  Col<T> col[4];
  __device__ __forceinline__ void operator()(int j, T& a, T& b, T& c, T& d) const {
    a = col[0][j];
    b = col[1][j];
    c = col[2][j];
    d = col[3][j];
  }
};

// Nodes whose operands a lane reads together before it computes them, so
// the chain does not wait on each shared-memory load.
constexpr int kUnroll = 8;
// Rows of padding before node 0 and after node n − 1 of each plane of a
// tile: the steps of a whole group of kUnroll that fall off the system read
// and write there, so no step takes a branch or a selection for the ends.
// The operands' padding holds lower 0, diagonal 1, upper 1 and right-hand
// side 0 before the system (the partner's step to node −1 then leaves its
// carry d'_{−1} = +0, the plain loop's start) and 1 after it (1 = 1·1: no
// zero to divide).
constexpr int kPad = kUnroll;
// The partner of pivot lane s (s < kPair) is lane s + kPair: a warp solves
// at most kPair systems at once.
constexpr int kPair = 16;

// The forward elimination of system s = lane % kPair, split over two lanes
// of the warp. Pivot lane s runs the pivots' chain: den_j = b_j − a_j·c'_{j−1}
// with its guard, then c'_j = c_j / den_j. Its partner, lane s + kPair, runs
// the right-hand side's chain a node behind: d'_j = (d_j − a_j·d'_{j−1}) /
// den_j, den_j passed over by a shuffle. The plain loop computes a node's two
// quotients one after the other; here they overlap, and each is the plain
// loop's value, rounded the same way.
//
// Runs steps [j0, j1) of the n + 1 an elimination takes, j0 a multiple of
// kUnroll, in whole groups of kUnroll (so up to kUnroll − 1 steps past j1):
// at step j the pivot lane is at node j and its partner at node j − 1, the
// steps off the system on the padding. load(j, a, b, c, d) reads node j's
// lower, diagonal, upper and right-hand side (a lane without a system
// reads another system's column); each lane puts its quotient, c' or d', at
// out[node] (a lane without a system at a dump slot). x (the lane's last
// quotient) and den (the pivot from the step before) carry over between
// calls: start them at 0 and 1. All 32 lanes of the warp call it.
//
// The guard is taken only where a pivot is below 1e-30: the group's
// quotients go ahead on the unguarded pivots (the same values wherever the
// guard does nothing) and one warp-wide vote a group, off the chain, sends a
// rare group back to be done again with the guard on every pivot (the
// identity but where a pivot is tiny).
//
// With kKeepDen the pivot lane also puts its (guarded) pivot den_j at
// dens[node]: a later solve that restarts at a node (theta_pde.cu's Howard
// sweeps) reads its carries there.
template <typename T, typename Load, bool kKeepDen = false>
__device__ __forceinline__ void forward_split(int j0, int j1, const Load& load, Col<T> out,
                                              T& x, T& den, Col<T> dens = Col<T>{0u, 0u}) {
  using A = Arith<T>;
  const bool pivot = (threadIdx.x & 31) < kPair;
  const int lag = pivot ? 0 : 1;
  for (int i0 = j0; i0 < j1; i0 += kUnroll) {
    T ra[kUnroll], rb[kUnroll], rc[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      T a, b, c, d;
      load(i0 + q - lag, a, b, c, d);
      ra[q] = a;
      rb[q] = pivot ? b : d;
      rc[q] = c;
    }
    const T x0 = x, den0 = den;
    T rr[kUnroll], ru[kUnroll];
    bool tiny = false;
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const T u = A::sub(rb[q], A::mul(ra[q], x));  // the pivot, or d'_j's numerator
      tiny |= pivot && A::mag(u) < A::kTiny;
      const T next = __shfl_up_sync(0xffffffffu, u, kPair);
      x = quotient(pivot ? rc[q] : u, pivot ? u : den);
      den = next;
      rr[q] = x;
      ru[q] = u;
    }
    if (__any_sync(0xffffffffu, tiny)) {
      x = x0;
      den = den0;
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        T u = A::sub(rb[q], A::mul(ra[q], x));
        u = pivot ? guard_pivot(u) : u;
        const T next = __shfl_up_sync(0xffffffffu, u, kPair);
        x = quotient(pivot ? rc[q] : u, pivot ? u : den);
        den = next;
        rr[q] = x;
        ru[q] = u;
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (kKeepDen && pivot) dens.put(i0 + q, ru[q]);
      out.put(i0 + q - lag, rr[q]);
    }
  }
}

// Back substitution over the n nodes: x[j] = d'_j − c'_j·x_{j+1}; x may be
// ds. The last group's steps past node 0 fall on the padding.
template <typename T>
__device__ __forceinline__ void back_sweep(int n, Col<T> cs, Col<T> ds, Col<T> x) {
  T x_next = T(0);
  for (int i1 = n - 1; i1 >= 0; i1 -= kUnroll) {
    T rc[kUnroll], rd[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      rc[q] = cs[i1 - q];
      rd[q] = ds[i1 - q];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      x_next = back_node(rc[q], rd[q], x_next);
      x.put(i1 - q, x_next);
    }
  }
}

// The tables of a matrix that does not change, one lane a system:
// den_j = guard(b_j − a_j·c'_{j−1}) and c'_j = c_j / den_j (forward_split's
// pivot chain, bit for bit) and rcp_j = table_rcp(den_j); then the padding
// after node n − 1 that rhs_chain reads (den 1, reciprocal 1).
template <typename T>
__device__ void form_tables(int n, Col<T> lo, Col<T> di, Col<T> up, Col<T> den, Col<T> cs,
                            Col<T> rcp) {
  using A = Arith<T>;
  T c = T(0);
  for (int j = 0; j < n; ++j) {
    const T u = A::sub(di[j], A::mul(lo[j], c));
    const T g = guard_pivot(u);
    c = quotient(up[j], g);
    den.put(j, g);
    cs.put(j, c);
    rcp.put(j, table_rcp(g, A::mag(u) < A::kTiny));
  }
  for (int j = n; j < n + kPad; ++j) {
    den.put(j, T(1));
    rcp.put(j, T(1));
  }
}

// Nodes of the right-hand side's chain a group holds, one vote each: 16 in
// float32 (a vote every 8 nodes cost ≈10 cycles a node on the card), 8 in
// float64, whose registers hold half as many.
template <typename T>
constexpr int kRhsGroup = sizeof(T) == 4 ? 16 : kUnroll;

// U nodes of the right-hand side's chain on a matrix's tables, from
// prev = d'_{j−1}: d'_j = (d_j − a_j·d'_{j−1}) / den_j by fast_quotient;
// where a lane of the warp needs it (one vote for the group, off the chain),
// the whole group again by flagged_quotient. All 32 lanes call it. Returns
// the group's last d'.
template <typename T, int U>
__device__ __forceinline__ T rhs_group(const T (&a)[U], const T (&d)[U], const T (&den)[U],
                                       const T (&y)[U], T prev, T (&out)[U]) {
  using A = Arith<T>;
  const T start = prev;
  bool bad = false;
#pragma unroll
  for (int q = 0; q < U; ++q) {
    prev = fast_quotient(A::sub(d[q], A::mul(a[q], prev)), den[q], y[q], bad);
    out[q] = prev;
  }
  if (__any_sync(0xffffffffu, bad)) {
    prev = start;
#pragma unroll
    for (int q = 0; q < U; ++q) {
      prev = flagged_quotient(A::sub(d[q], A::mul(a[q], prev)), den[q], y[q]);
      out[q] = prev;
    }
  }
  return prev;
}

// Nodes [i0, i0 + U) of rhs_chain: the group's operands, its chain, its d'.
// Without kCheck the chain is fast_quotient's three operations alone, no
// range check and no vote (see rhs_chain).
template <typename T, int U, bool kCheck>
__device__ __forceinline__ T rhs_nodes(int i0, T prev, Col<T> lo, Col<T> rhs, Col<T> den,
                                       Col<T> rcp, Col<T> out) {
  T ra[U], rd[U], rn[U], ry[U], rq[U];
#pragma unroll
  for (int q = 0; q < U; ++q) {
    ra[q] = lo[i0 + q];
    rd[q] = rhs[i0 + q];
    rn[q] = den[i0 + q];
    ry[q] = rcp[i0 + q];
  }
  if constexpr (kCheck) {
    prev = rhs_group<T, U>(ra, rd, rn, ry, prev, rq);
#pragma unroll
    for (int q = 0; q < U; ++q) out.put(i0 + q, rq[q]);
  } else {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      bool unused = false;
      prev = fast_quotient(Arith<T>::sub(rd[q], Arith<T>::mul(ra[q], prev)), rn[q], ry[q], unused);
      out.put(i0 + q, prev);
    }
  }
  return prev;
}

// The solve's forward half on tables formed once (form_tables): the
// right-hand side's chain alone, d'_j for nodes [0, n) of the lane's system
// into out, in groups of kRhsGroup while a group's steps past n − 1 stay
// on the padding, then in groups of kUnroll (those steps read lower 0,
// right-hand side 1, den 1 and reciprocal 1 there, and write there). lo, den
// and rcp may be one column that every lane reads. All 32 lanes of the warp
// call it; a lane without a system reads another's columns and writes to a
// dump column. With j0 the chain starts at node j0 from prev = d'_{j0−1}
// (j0 the same on every lane).
//
// Without kCheck: no range check and no vote, so no comparison sits between
// a node's dependent operations (a warp issues in order, and on the card
// those comparisons doubled a node's time). For a caller that then holds
// every node to the division's bits (rhs_node_holds, a block's other threads
// at once) and runs the checked chain again from a sweep's first node that
// does not hold.
template <typename T, bool kCheck = true>
__device__ __forceinline__ void rhs_chain(int n, Col<T> lo, Col<T> rhs, Col<T> den, Col<T> rcp,
                                          Col<T> out, int j0 = 0, T prev = T(0)) {
  constexpr int kGroup = kRhsGroup<T>;
  int i0 = j0;
  for (; i0 + kGroup <= n + kPad; i0 += kGroup) {
    prev = rhs_nodes<T, kGroup, kCheck>(i0, prev, lo, rhs, den, rcp, out);
  }
  for (; i0 < n; i0 += kUnroll) {
    prev = rhs_nodes<T, kUnroll, kCheck>(i0, prev, lo, rhs, den, rcp, out);
  }
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// Whether node j of an unchecked chain holds the division's bits given the
// d'_{j−1} the chain stored (0 at node 0): where fast_quotient's check lets
// its numerator d_j − a_j·d'_{j−1} and q0 pass, its three operations are the
// division's; where it flags them, the stored value is held to
// flagged_quotient's, which is the division's. A chain whose every node
// holds is, by induction from d'_{−1} = 0, the checked chain bit for bit.
template <typename T>
__device__ __forceinline__ bool rhs_node_holds(T a, T d, T den, T y, T prev, T stored) {
  using A = Arith<T>;
  const T num = A::sub(d, A::mul(a, prev));
  bool bad = false;
  fast_quotient(num, den, y, bad);
  return !bad || same_bits(flagged_quotient(num, den, y), stored);
}

// One lane a system over a block's warps: system s runs on warp
// s % warps, lane s / warps, so a tile of a few systems spreads over the
// warps. The lane's system (it may be past the tile's last).
__device__ __forceinline__ int spread_system(int warps) {
  return (threadIdx.x & 31) * warps + (threadIdx.x >> 5);
}

// The padding's values of the operands (lower, diagonal, upper, right-hand
// side) before node 0 and after node n − 1.
template <typename T>
__device__ __forceinline__ T pad_value(int operand, bool after) {
  return operand == 0 ? T(0) : (operand == 3 && !after ? T(0) : T(1));
}

// Bytes of shared memory a tile keeps for the dump slots of the lanes
// without a system.
constexpr int kDumpBytes = 32 * 8;

// The dump column of this lane (stride 0: every node on one slot), at
// `base` (kDumpBytes of shared memory).
template <typename T>
__device__ __forceinline__ Col<T> dump_col(const void* base) {
  return Col<T>{static_cast<unsigned>(__cvta_generic_to_shared(base)) + (threadIdx.x & 31) * 8,
                0u};
}

// Shared memory a CUDA block may use on sm_90 (227 KB); above 48 KB only
// after cudaFuncSetAttribute.
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 48 * 1024;

// Lets `kernel` take `bytes` of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// cp.async: sizeof(T) bytes from global to shared memory without a trip
// through registers (tridiag.cu's chunks, theta_pde.cu's history rows,
// heston_adi.cu's history). A thread's copies land by groups: commit closes
// a group, cp_async_wait<N> waits until at most N of the thread's groups
// are still in flight, cp_async_wait_all until none is.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(saddr), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tri
}  // namespace optionslab
