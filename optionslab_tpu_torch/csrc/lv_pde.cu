// The local-vol implicit time loop in one launch: n_time θ = 1 steps of one
// contract's log-spot grid whose diagonals change every step (σ(S, t) read
// at each step's time), European, projected American, or Bermudan
// (projection at the end of every date block but the last, each date's
// continuation slice written out). One CUDA block a contract.
//
// Replaces the reference's device loops optionslab_tpu/models/local_vol.py
// :197 (the lax.scan of _lv_solve) and optionslab_tpu/models/
// local_vol_american.py:85-125 (the nested scans of lv_bermudan_slices).
// Without it the port steps on the host: σ(S, t) rebuilt and ≈96 small
// torch launches a step around each tridiagonal solve. The caller forms
// every step's diagonals and end values first, as one table, by the
// per-step loop's own elementwise torch operations (models/local_vol.py
// _lv_tables), so no exp, log or interpolation here can differ from
// torch's.
//
// What bounds it. The dependent chain: each step's matrix is new, so each
// step forms its pivots again, n nodes of tridiag.cuh's two-lane solve (the
// pivots' chain and the right-hand side's a node behind), then the back
// substitution; one contract has nothing to run beside it.
//
// What the design does about it. The solve is forward_split on warp 0, its
// operands in shared memory with tri::kPad rows of padding (no branch for
// the ends on the chain); the next step's three diagonals and end values
// land in a second buffer by cp.async while a step solves, so the chain
// never waits on device memory; the projection and the slices' writes are
// node-parallel over the block's threads.
//
// Bit for bit with the plain loop (ops/lv_pde.py _lv_plain): the solve is
// tridiag.cuh's, whose operations round as the plain Thomas solve's
// (ops/tridiag.py _tridiag_plain) do, and the clamp is torch.maximum's.
#include <cuda_runtime.h>

#include <cstdint>

#include "tridiag.cuh"

namespace optionslab {
namespace {

constexpr int kLvThreads = 128;
enum LvMode { kLvEuropean = 0, kLvProjection = 1, kLvBermudan = 2 };

// The shared-memory tile of one block: eleven planes of n nodes with
// tri::kPad rows of padding at both ends (two buffers of the step's lower,
// diagonal and upper; the right-hand side; v; ψ; c' and d'), the two
// buffers' end values, then (8-byte aligned) the dump slots.
struct LvTile {
  int64_t plane;  // n + 2·kPad
  int64_t ends;   // element offset of the end values
  int64_t dump;   // byte offset of the dump slots
  int64_t bytes;

  __host__ __device__ LvTile(int n, int size) {
    plane = n + 2 * tri::kPad;
    ends = 11 * plane;
    dump = ((11 * plane + 4) * size + 7) / 8 * 8;
    bytes = dump + tri::kDumpBytes;
  }
};

// Step k's diagonals and end values into one buffer, by the block's threads.
template <typename T>
__device__ __forceinline__ void stage(const T* lo, const T* di, const T* up, const T* ends,
                                      int64_t k, int n, T* d_lo, T* d_di, T* d_up, T* d_ends) {
  const int64_t row = k * n;
  for (int j = threadIdx.x; j < n; j += kLvThreads) {
    tri::cp_async(d_lo + j, lo + row + j);
    tri::cp_async(d_di + j, di + row + j);
    tri::cp_async(d_up + j, up + row + j);
  }
  if (threadIdx.x < 2) tri::cp_async(d_ends + threadIdx.x, ends + 2 * k + threadIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(kLvThreads)
    lv_pde_kernel(const T* __restrict__ lo, const T* __restrict__ di, const T* __restrict__ up,
                  const T* __restrict__ ends, const T* __restrict__ psi,
                  const T* __restrict__ v0, T* __restrict__ out, T* __restrict__ conts, int n,
                  int n_time, int mode, int spd) {
  using A = tri::Arith<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LvTile tile(n, sizeof(T));
  T* const node0 = reinterpret_cast<T*>(smem_raw) + tri::kPad;  // node 0 of plane 0
  T* buf[2][3];
  for (int q = 0; q < 2; ++q) {
    for (int o = 0; o < 3; ++o) buf[q][o] = node0 + (3 * q + o) * tile.plane;
  }
  T* s_rhs = node0 + 6 * tile.plane;
  T* s_v = node0 + 7 * tile.plane;
  T* s_psi = node0 + 8 * tile.plane;
  T* s_cs = node0 + 9 * tile.plane;
  T* s_ds = node0 + 10 * tile.plane;
  T* s_ends = reinterpret_cast<T*>(smem_raw) + tile.ends;  // [buffer · 2 + end]
  const void* dump = smem_raw + tile.dump;

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  lo += b * n_time * n;
  di += b * n_time * n;
  up += b * n_time * n;
  ends += b * n_time * 2;
  for (int e = tid; e < tri::kPad; e += kLvThreads) {  // the padding: see tri::kPad
    for (int q = 0; q < 2; ++q) {
      for (int o = 0; o < 3; ++o) {
        buf[q][o][e - tri::kPad] = tri::pad_value<T>(o, false);
        buf[q][o][n + e] = tri::pad_value<T>(o, true);
      }
    }
    s_rhs[e - tri::kPad] = tri::pad_value<T>(3, false);
    s_rhs[n + e] = tri::pad_value<T>(3, true);
  }
  for (int j = tid; j < n; j += kLvThreads) {
    const T v = v0[b * n + j];
    s_v[j] = v;
    s_rhs[j] = v;
    s_psi[j] = psi[b * n + j];
  }
  if (n_time > 0) stage(lo, di, up, ends, 0, n, buf[0][0], buf[0][1], buf[0][2], s_ends);
  tri::cp_async_commit();

  // the solve: warp 0, pivot lane 0 and its partner, lane 16; the other
  // lanes read the system's columns and write to their dump slots
  const bool pivot_lane = tid < tri::kPair;
  const bool live = tid < 32 && tid % tri::kPair == 0;
  const tri::Col<T> cs = tri::col<T>(s_cs, 0, 1);
  const tri::Col<T> ds = tri::col<T>(s_ds, 0, 1);
  const tri::Col<T> quotients = live ? (pivot_lane ? cs : ds) : tri::dump_col<T>(dump);
  const int n_dates = mode == kLvBermudan ? n_time / spd : 0;
  for (int k = 0; k < n_time; ++k) {
    const int cur = k & 1;
    if (k + 1 < n_time) {
      const int nxt = cur ^ 1;
      stage(lo, di, up, ends, k + 1, n, buf[nxt][0], buf[nxt][1], buf[nxt][2],
            s_ends + 2 * nxt);
    }
    tri::cp_async_commit();  // an empty group past the last step keeps the count
    tri::cp_async_wait<1>();  // step k's group has landed (this thread's copies)
    __syncthreads();
    if (tid < 32) {
      if (tid == 0) {
        s_rhs[0] = s_ends[2 * cur];
        s_rhs[n - 1] = s_ends[2 * cur + 1];
      }
      __syncwarp();
      const tri::Row<T> row{{tri::col<T>(buf[cur][0], 0, 1), tri::col<T>(buf[cur][1], 0, 1),
                             tri::col<T>(buf[cur][2], 0, 1), tri::col<T>(s_rhs, 0, 1)}};
      T x = T(0), den = T(1);
      tri::forward_split<T, tri::Row<T>>(0, n + 1, row, quotients, x, den);
      __syncwarp();
      if (tid == 0) tri::back_sweep(n, cs, ds, tri::col<T>(s_v, 0, 1));
    }
    __syncthreads();
    // the clamp (every step, or a Bermudan date's, after its slice is
    // written), and the next step's right-hand side
    const bool date = mode == kLvBermudan && (k + 1) % spd == 0 && k + 1 < n_time;
    for (int j = tid; j < n; j += kLvThreads) {
      T v = s_v[j];
      if (date) conts[(b * (n_dates - 1) + (k + 1) / spd - 1) * n + j] = v;
      if (mode == kLvProjection || date) v = A::max(v, s_psi[j]);
      s_v[j] = v;
      s_rhs[j] = v;
    }
    __syncthreads();
  }
  for (int j = tid; j < n; j += kLvThreads) out[b * n + j] = s_v[j];
}

template <typename T>
cudaError_t launch(const void* lo, const void* di, const void* up, const void* ends,
                   const void* psi, const void* v0, void* out, void* conts, int batch, int n,
                   int n_time, int mode, int spd, cudaStream_t st) {
  const LvTile tile(n, sizeof(T));
  if (tile.bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(lv_pde_kernel<T>, static_cast<int>(tile.bytes));
  if (err != cudaSuccess) return err;
  lv_pde_kernel<T><<<batch, kLvThreads, static_cast<size_t>(tile.bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(ends), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<T*>(out), static_cast<T*>(conts), n, n_time, mode, spd);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optionslab

// All arrays contiguous, of one dtype (0 float32, 1 float64): lo, di, up
// (batch, n_time, n) each step's diagonals; ends (batch, n_time, 2) the
// right-hand side's first and last value at each step; psi, v0 and out
// (batch, n). mode: 0 European, 1 projection after every step, 2 Bermudan
// (spd steps a date; n_time a multiple of spd): conts (batch, n_time/spd −
// 1, n), each date's slice before its projection, in the loop's order
// (null when there is none). Returns a cudaError_t code (0 on success).
extern "C" int lv_pde_launch(const void* lo, const void* di, const void* up, const void* ends,
                             const void* psi, const void* v0, void* out, void* conts, int batch,
                             int n, int n_time, int mode, int spd, int dtype, int device,
                             void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kLvEuropean || mode > kLvBermudan || spd < 1 ||
      (mode == kLvBermudan && (n_time % spd != 0 || (n_time / spd > 1 && conts == nullptr))) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch<float>(lo, di, up, ends, psi, v0, out, conts, batch, n, n_time, mode,
                                   spd, st)
                   : launch<double>(lo, di, up, ends, psi, v0, out, conts, batch, n, n_time,
                                    mode, spd, st);
  return static_cast<int>(err);
}
