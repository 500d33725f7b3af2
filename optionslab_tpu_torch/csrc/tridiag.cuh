// The Thomas algorithm on systems held in shared memory, shared by the
// batched tridiagonal solve (tridiag.cu) and the θ-scheme time loop
// (theta_pde.cu).
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
  static __device__ __forceinline__ float mag(float a) { return fabsf(a); }
  // torch.maximum on the card (::max of two floats) without NaNs
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static constexpr float kTiny = 1e-30f;
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double mag(double a) { return fabs(a); }
  static __device__ __forceinline__ double max(double a, double b) { return fmax(a, b); }
  static constexpr double kTiny = 1e-30;
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
};

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
// The guard is taken only where a pivot is below 1e-30: the quotient goes
// ahead on the unguarded pivot (the same value wherever the guard does
// nothing) and a warp-wide vote, off the chain, sends the rare step back
// to be done again with it.
template <typename T, typename Load>
__device__ __forceinline__ void forward_split(int j0, int j1, const Load& load, Col<T> out,
                                              T& x, T& den) {
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
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      T u = A::sub(rb[q], A::mul(ra[q], x));  // the pivot, or d'_j's numerator
      const bool tiny = __any_sync(0xffffffffu, pivot && A::mag(u) < A::kTiny);
      T next = __shfl_up_sync(0xffffffffu, u, kPair);
      T r = quotient(pivot ? rc[q] : u, pivot ? u : den);
      if (tiny) {
        u = pivot ? guard_pivot(u) : u;
        next = __shfl_up_sync(0xffffffffu, u, kPair);
        r = quotient(pivot ? rc[q] : u, pivot ? u : den);
      }
      den = next;
      x = r;
      out.put(i0 + q - lag, r);
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

}  // namespace tri
}  // namespace optionslab
