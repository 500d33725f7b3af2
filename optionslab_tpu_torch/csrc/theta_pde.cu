// The θ-scheme time loop of the Crank–Nicolson book in one launch:
// n_time steps of a European, a projected American or a Howard (policy
// iteration) American step for a book of contracts, each on its own grid.
//
// Replaces the reference's device loops optionslab_tpu/models/fdm.py:162
// (the lax.scan over time steps of _cn_single) and :101 (the fori_loop of
// _howard_lcp_solve's 8 policy sweeps). Without it the port steps on the
// host: ≈20–55 small torch launches a step around each tridiagonal solve.
//
// What bounds it. The dependent chain: each step solves each contract's
// system once (European, projection) or once a Howard sweep, a chain of n
// pivots and n back-substitution nodes (≈85 cycles a node in float32 by
// tridiag.cu's chain probe), so a contract takes n × its solves of those,
// while the contracts' chains run side by side. The node-parallel work
// around each solve (the explicit step, the exercise residual, the
// projection) is a few operations a node spread over the block's threads.
//
// What the design does about it. It takes the host's issue out and keeps
// every contract on chip for the whole loop:
// - one CUDA block owns a tile of `systems` contracts (a power of two up to
//   16, picked by the wrapper so that the book's chains all run at once);
//   v, the right-hand side, the exercise set, c' and d' live in shared
//   memory from the first step to the last;
// - each step the block's threads form the explicit right-hand side in
//   parallel over the nodes, two lanes of warp 0 a contract run the
//   shared-memory Thomas solve of tridiag.cuh (the functions the
//   tridiagonal kernel runs), then the threads re-select Howard's exercise
//   rows;
// - a Howard step stops sweeping once no contract of the block changes its
//   exercise set: every later sweep would solve the same system again and
//   give the same values, so the result is the 8-sweep loop's bit for bit.
//
// Bit for bit with the plain loop (ops/theta_pde.py _theta_plain, which
// models/fdm.py _cn_book runs on the CPU and differentiates on the card):
// the explicit step is v + w·((a·v₋ + b·v) + c·v₊) and the residual
// ((lo·v₋ + di·v) + up·v₊) − rhs, each operation rounded on its own in that
// order; the masked operands are selections; the end values come from the
// wrapper's table, computed by torch, so no exp here can differ from
// torch's.
#include <cuda_runtime.h>

#include <cstdint>

#include "tridiag.cuh"

namespace optionslab {
namespace {

constexpr int kThreads = 128;
constexpr int kHowardSweeps = 8;
enum Mode { kEuropean = 0, kProjection = 1, kHoward = 2 };

// The shared-memory tile of one block: twelve node-major planes (node j of
// contract s at [j * pitch + s]): the implicit side's lower, diagonal and
// upper, the right-hand side, v, ψ, c', d', and the system the solve sees
// (lower, diagonal, upper and right-hand side with Howard's exercise rows
// replaced by v = ψ), each with tri::kPad rows of padding at both ends;
// the contracts' a, b, c and w; the exercise set, one byte a node; then
// (8-byte aligned) the dump slots.
struct ThetaTile {
  int pitch;
  int64_t plane;  // (n + 2·kPad) × pitch
  int64_t dump;   // byte offset of the dump slots
  int64_t bytes;

  __host__ __device__ ThetaTile(int n, int systems, int size) {
    pitch = systems | 1;
    plane = static_cast<int64_t>(n + 2 * tri::kPad) * pitch;
    dump = ((12 * plane + 4 * systems) * size + plane + 7) / 8 * 8;
    bytes = dump + tri::kDumpBytes;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    theta_pde_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                     const T* __restrict__ up, const T* __restrict__ coef,
                     const T* __restrict__ psi, const T* __restrict__ v0,
                     const T* __restrict__ ends, T* __restrict__ out, int* __restrict__ solves,
                     int batch, int n, int n_time, int mode, int systems) {
  using A = tri::Arith<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ThetaTile tile(n, systems, sizeof(T));
  const int p = tile.pitch;
  const int64_t pad = tri::kPad * p;  // node 0 of each plane
  T* s_lo = reinterpret_cast<T*>(smem_raw) + pad;
  T* s_di = s_lo + tile.plane;
  T* s_up = s_di + tile.plane;
  T* s_rhs = s_up + tile.plane;
  T* s_v = s_rhs + tile.plane;
  T* s_psi = s_v + tile.plane;
  T* s_cs = s_psi + tile.plane;
  T* s_ds = s_cs + tile.plane;
  T* const solve[4] = {s_ds + tile.plane, s_ds + 2 * tile.plane, s_ds + 3 * tile.plane,
                       s_ds + 4 * tile.plane};  // the system the solve sees
  T* s_coef = solve[3] + tile.plane - pad;     // a, b, c, w: `systems` each
  unsigned char* s_m = reinterpret_cast<unsigned char*>(s_coef + 4 * systems) + pad;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * systems;
  const int rows = min(systems, batch - b0);
  const int cells = rows * n;
  for (int e = tid; e < cells; e += kThreads) {  // coalesced along each contract's row
    const int s = e / n;
    const int j = e - s * n;
    const int64_t g = static_cast<int64_t>(b0 + s) * n + j;
    const int t = j * p + s;
    s_lo[t] = solve[0][t] = lo[g];
    s_di[t] = solve[1][t] = di[g];
    s_up[t] = solve[2][t] = up[g];
    s_v[t] = v0[g];
    s_psi[t] = psi[g];
  }
  for (int e = tid; e < 4 * rows; e += kThreads) {
    const int q = e / rows;
    const int s = e - q * rows;
    s_coef[q * systems + s] = coef[static_cast<int64_t>(q) * batch + b0 + s];
  }
  for (int e = tid; e < pad; e += kThreads) {  // the padding: see tri::kPad
    for (int o = 0; o < 4; ++o) {
      solve[o][e - pad] = tri::pad_value<T>(o, false);
      solve[o][n * p + e] = tri::pad_value<T>(o, true);
    }
  }
  __syncthreads();

  const T* s_a = s_coef;
  const T* s_b = s_coef + systems;
  const T* s_c = s_coef + 2 * systems;
  const T* s_w = s_coef + 3 * systems;
  // the solve: warp 0, pivot lane s and its partner s + 16 on contract s; a
  // lane without a contract reads contract 0's column and writes to its dump
  // slot
  const bool live = tid < 32 && tid % tri::kPair < rows;
  const int sys = live ? tid % tri::kPair : 0;
  tri::Row<T> row;
  for (int o = 0; o < 4; ++o) row.col[o] = tri::col<T>(solve[o], sys, p);
  const tri::Col<T> cs = tri::col<T>(s_cs, sys, p);
  const tri::Col<T> ds = tri::col<T>(s_ds, sys, p);
  const tri::Col<T> vs = tri::col<T>(s_v, sys, p);
  const tri::Col<T> quotients =
      live ? (tid < tri::kPair ? cs : ds) : tri::dump_col<T>(smem_raw + tile.dump);
  const int sweeps = mode == kHoward ? kHowardSweeps : 1;
  int n_solves = 0;
  for (int k = 0; k < n_time; ++k) {
    // the explicit step, the ends from the table
    for (int e = tid; e < cells; e += kThreads) {
      const int j = e / rows;
      const int s = e - j * rows;
      const int t = j * p + s;
      T r;
      if (j == 0 || j == n - 1) {
        r = ends[(static_cast<int64_t>(b0 + s) * n_time + k) * 2 + (j == 0 ? 0 : 1)];
      } else {
        const T vc = s_v[t];
        const T lap = A::add(A::add(A::mul(s_a[s], s_v[t - p]), A::mul(s_b[s], vc)),
                             A::mul(s_c[s], s_v[t + p]));
        r = A::add(vc, A::mul(s_w[s], lap));
      }
      s_rhs[t] = solve[3][t] = r;
      if (mode == kHoward) {  // no exercise row yet this step
        s_m[t] = 0;
        solve[0][t] = s_lo[t];
        solve[1][t] = s_di[t];
        solve[2][t] = s_up[t];
      }
    }
    __syncthreads();
    for (int sweep = 0; sweep < sweeps; ++sweep) {
      if (tid < 32) {
        T x_last = T(0);
        T den = T(1);
        tri::forward_split(0, n + 1, row, quotients, x_last, den);
        __syncwarp();
        if (tid < tri::kPair && live) tri::back_sweep(n, cs, ds, vs);
      }
      ++n_solves;
      __syncthreads();
      if (sweep + 1 == sweeps) break;
      // Howard: the rows where exercising beats continuing
      int changed = 0;
      for (int e = tid; e < cells; e += kThreads) {
        const int j = e / rows;
        if (j == 0 || j == n - 1) continue;
        const int t = j * p + (e - j * rows);
        const T vc = s_v[t];
        const T res = A::sub(A::add(A::add(A::mul(s_lo[t], s_v[t - p]), A::mul(s_di[t], vc)),
                                    A::mul(s_up[t], s_v[t + p])),
                             s_rhs[t]);
        const unsigned char m = res > A::sub(vc, s_psi[t]);
        changed |= m != s_m[t];
        s_m[t] = m;
        solve[0][t] = m ? T(0) : s_lo[t];
        solve[1][t] = m ? T(1) : s_di[t];
        solve[2][t] = m ? T(0) : s_up[t];
        solve[3][t] = m ? s_psi[t] : s_rhs[t];
      }
      if (!__syncthreads_or(changed)) break;  // a fixed point: the rest repeat this sweep
    }
    if (mode != kEuropean) {
      for (int e = tid; e < cells; e += kThreads) {
        const int j = e / rows;
        const int t = j * p + (e - j * rows);
        s_v[t] = A::max(s_v[t], s_psi[t]);
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < cells; e += kThreads) {
    const int s = e / n;
    const int j = e - s * n;
    out[static_cast<int64_t>(b0 + s) * n + j] = s_v[j * p + s];
  }
  if (tid == 0) solves[blockIdx.x] = n_solves;
}

template <typename T>
cudaError_t launch(const void* lo, const void* di, const void* up, const void* coef,
                   const void* psi, const void* v0, const void* ends, void* out, int* solves,
                   int batch, int n, int n_time, int mode, int systems, cudaStream_t st) {
  const ThetaTile tile(n, systems, sizeof(T));
  if (tile.bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(theta_pde_kernel<T>, static_cast<int>(tile.bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + systems - 1) / systems;
  theta_pde_kernel<T><<<blocks, kThreads, static_cast<size_t>(tile.bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(coef), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<const T*>(ends), static_cast<T*>(out), solves, batch, n, n_time, mode,
      systems);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optionslab

// All arrays contiguous, of one dtype (0 float32, 1 float64): lo, di, up,
// psi, v0 and out (batch, n); coef (4, batch): the explicit operator's a, b,
// c and the explicit weight w = (1 − θ)·dt; ends (batch, n_time, 2): the
// right-hand side's first and last value at each step. mode: 0 European,
// 1 projection, 2 Howard. systems: contracts per CUDA block, 1 to 16 (the
// wrapper's plan; the tile must fit in 227 KB of shared memory). solves:
// one int a block, the solves each of its contracts ran. Returns a
// cudaError_t code (0 on success).
extern "C" int theta_pde_launch(const void* lo, const void* di, const void* up,
                                const void* coef, const void* psi, const void* v0,
                                const void* ends, void* out, void* solves, int batch, int n,
                                int n_time, int mode, int systems, int dtype, int device,
                                void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kEuropean || mode > kHoward || systems < 1 ||
      systems > tri::kPair || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(solves);
  err = dtype == 0 ? launch<float>(lo, di, up, coef, psi, v0, ends, out, s, batch, n, n_time,
                                   mode, systems, st)
                   : launch<double>(lo, di, up, coef, psi, v0, ends, out, s, batch, n, n_time,
                                    mode, systems, st);
  return static_cast<int>(err);
}
