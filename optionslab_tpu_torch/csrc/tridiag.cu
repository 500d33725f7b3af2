// Batched tridiagonal solve (the Thomas algorithm), one thread per system.
//
// Replaces optionslab_tpu/ops/tridiag.py:15 tridiag_solve, a lax.scan that
// XLA compiles into one loop on the device (no Pallas kernel). Every PDE of
// the port runs on it: the Crank–Nicolson book, the Howard American sweeps,
// the local-vol PDEs, the Heston and SLV ADI sweeps and the dividend PDE.
//
// What bounds it. A system of n unknowns is a 2n-long chain of dependent
// steps (forward elimination, then back substitution); the batch is at most
// a few hundred systems, far too few threads to fill the card, and the
// bytes (each input read once, the solution written once) are a few hundred
// kilobytes. So the kernel is bound by the latency of its chain, and its
// design only makes each step cheap: one thread walks one system, loading
// the operands of kChunk steps together before it computes them (one
// memory latency a chunk, not a step: the chain would otherwise wait on
// every load); the scratch c' and d' (allocated by the wrapper) is laid out
// [step][system] so a warp's stores coalesce, and is read back in chunks
// the same way; each input is read through its own batch and element
// strides, so a broadcast coefficient (stride 0) or the ADI v-sweep's
// transposed right-hand side needs no copy.
//
// Arithmetic. Each product, difference and quotient is rounded on its own
// (the __*_rn intrinsics are never contracted into an FMA), in the plain
// torch version's order, with its pivot guard: a pivot below 1e-30 in
// magnitude becomes sign·1e-30 + 1e-30. So the kernel equals the plain
// version bit for bit, in float32 and in float64.
#include <cuda_runtime.h>

#include <cstdint>

namespace optionslab {
namespace {

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float mag(float a) { return fabsf(a); }
  static constexpr float kTiny = 1e-30f;
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double mag(double a) { return fabs(a); }
  static constexpr double kTiny = 1e-30;
};

// An operand: base pointer and its strides, in elements, along the batch
// axis and the system axis.
struct Operand {
  const void* ptr;
  int64_t sb;
  int64_t se;
};

// One node of the forward elimination: the pivot with its guard, then c'
// and d'. The solve and the chain probe below share it.
template <typename T>
__device__ __forceinline__ void forward_node(T a, T b, T c, T d, T& c_prev, T& d_prev) {
  using A = Arith<T>;
  T den = A::sub(b, A::mul(a, c_prev));
  if (A::mag(den) < A::kTiny) {
    const T sign = den > T(0) ? T(1) : (den < T(0) ? T(-1) : T(0));
    den = A::add(A::mul(sign, A::kTiny), A::kTiny);
  }
  c_prev = A::quo(c, den);
  d_prev = A::quo(A::sub(d, A::mul(a, d_prev)), den);
}

// One node of the back substitution.
template <typename T>
__device__ __forceinline__ T back_node(T c, T d, T x_next) {
  return Arith<T>::sub(d, Arith<T>::mul(c, x_next));
}

constexpr int kThreads = 128;
// Steps whose operands are loaded together before any of them is computed:
// one memory latency is paid per chunk, not per step.
constexpr int kChunk = 8;

template <typename T>
__global__ void tridiag_kernel(Operand lo, Operand di, Operand up, Operand rhs,
                               T* __restrict__ x, int64_t xsb, int64_t xse,
                               T* __restrict__ cs, T* __restrict__ ds, int batch, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T* __restrict__ lo_p = static_cast<const T*>(lo.ptr) + b * lo.sb;
  const T* __restrict__ di_p = static_cast<const T*>(di.ptr) + b * di.sb;
  const T* __restrict__ up_p = static_cast<const T*>(up.ptr) + b * up.sb;
  const T* __restrict__ rhs_p = static_cast<const T*>(rhs.ptr) + b * rhs.sb;
  T c_prev = T(0);
  T d_prev = T(0);
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    T ra[kChunk], rb[kChunk], rc[kChunk], rd[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i0 + j;
      if (i < n) {
        ra[j] = __ldg(lo_p + i * lo.se);
        rb[j] = __ldg(di_p + i * di.se);
        rc[j] = __ldg(up_p + i * up.se);
        rd[j] = __ldg(rhs_p + i * rhs.se);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i0 + j;
      if (i < n) {
        forward_node(ra[j], rb[j], rc[j], rd[j], c_prev, d_prev);
        const int64_t at = static_cast<int64_t>(i) * batch + b;
        cs[at] = c_prev;
        ds[at] = d_prev;
      }
    }
  }
  T* __restrict__ x_p = x + b * xsb;
  T x_next = T(0);
  for (int i1 = n - 1; i1 >= 0; i1 -= kChunk) {
    T rc[kChunk], rd[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i1 - j;
      if (i >= 0) {
        const int64_t at = static_cast<int64_t>(i) * batch + b;
        rc[j] = cs[at];
        rd[j] = ds[at];
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i1 - j;
      if (i >= 0) {
        x_next = back_node(rc[j], rd[j], x_next);
        x_p[i * xse] = x_next;
      }
    }
  }
}

// The dependent chain alone, for the solve's latency bound: one thread runs
// n_nodes forward and n_nodes back nodes of the solve's own arithmetic on
// operands held in registers, with no memory access inside either loop. Its
// time over n_nodes is what one node of a system's chain costs on the card
// however fast the memory is (each precise quotient is a multi-instruction
// sequence, so a flat count per operation would undercount it).
template <typename T>
__global__ void tridiag_chain_kernel(const T* __restrict__ abcd, T* __restrict__ out,
                                     int n_nodes) {
  const T a = abcd[0], b = abcd[1], c = abcd[2], d = abcd[3];
  T c_prev = T(0);
  T d_prev = T(0);
  for (int i = 0; i < n_nodes; ++i) forward_node(a, b, c, d, c_prev, d_prev);
  T x = T(0);
  for (int i = 0; i < n_nodes; ++i) x = back_node(c_prev, d_prev, x);
  out[0] = x;
}

}  // namespace
}  // namespace optionslab

// dtype: 0 float32, 1 float64. strides: 10 int64 values, (batch, element)
// for lower, diag, upper, rhs and the solution x. cs/ds: scratch of batch·n
// elements each. Returns a cudaError_t code (0 on success).
extern "C" int tridiag_solve_launch(const void* lo, const void* di, const void* up,
                                    const void* rhs, void* x, const int64_t* strides,
                                    void* cs, void* ds, int batch, int n, int dtype,
                                    int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operand o_lo{lo, strides[0], strides[1]};
  const Operand o_di{di, strides[2], strides[3]};
  const Operand o_up{up, strides[4], strides[5]};
  const Operand o_rhs{rhs, strides[6], strides[7]};
  const int blocks = (batch + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tridiag_kernel<float><<<blocks, kThreads, 0, st>>>(
        o_lo, o_di, o_up, o_rhs, static_cast<float*>(x), strides[8], strides[9],
        static_cast<float*>(cs), static_cast<float*>(ds), batch, n);
  } else {
    tridiag_kernel<double><<<blocks, kThreads, 0, st>>>(
        o_lo, o_di, o_up, o_rhs, static_cast<double*>(x), strides[8], strides[9],
        static_cast<double*>(cs), static_cast<double*>(ds), batch, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chain probe: one block of one thread. abcd: the four operands (lower,
// diag, upper, rhs) of every node; out: one element. Returns a cudaError_t.
extern "C" int tridiag_chain_launch(const void* abcd, void* out, int n_nodes, int dtype,
                                    int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tridiag_chain_kernel<float><<<1, 1, 0, st>>>(static_cast<const float*>(abcd),
                                                 static_cast<float*>(out), n_nodes);
  } else {
    tridiag_chain_kernel<double><<<1, 1, 0, st>>>(static_cast<const double*>(abcd),
                                                  static_cast<double*>(out), n_nodes);
  }
  return static_cast<int>(cudaGetLastError());
}
