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
// What bounds it. The dependent chain of one contract's solves: n_time
// systems of n unknowns (201 or 401 at the defaults), one a step, each on a
// matrix of its own.
//
// What the design does about it. Every step's matrix is known before the
// loop starts, so its factors never wait on a solution:
// - the solve is warp_tridiag.cuh's, one system over a warp's 32 lanes (a
//   solve's chain ≈ 2⌈n/32⌉ nodes and seven shuffle stages); warp 0, the
//   consumer, runs each step's right-hand side's pass alone, its rows of v
//   (and ψ) in its registers;
// - six of the block's other warps, the producers, form the steps' factors
//   ahead (step k on the producer k mod 6), reading the step's diagonals
//   from the table and writing the factors and the step's two end values
//   into a ring of slots in shared memory; warp 4, which would share the
//   consumer's scheduler, idles;
// - a slot is handed over by flags in shared memory, not a barrier: a
//   producer marks it ready (ready[s] = k + 1) and the consumer marks a step
//   done once it has read its slot, which frees the slot for step k + ring;
// - the projection and the Bermudan slices are the consumer's, row by row in
//   its registers.
// Grids too long for the registers (K = 0) keep the ring and v in a
// device-memory workspace, the same code on memory.
//
// Bit for bit with the plain loop (ops/lv_pde.py _lv_plain): the solve is
// ops/tridiag.py warp_solve's, operation for operation, and the clamp is
// torch.maximum's.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tridiag.cuh"
#include "warp_tridiag.cuh"

namespace optionslab {
namespace {

// a block: the consumer (warp 0), warp kIdle, which leaves at once (warps
// share an SM's four schedulers by index mod 4: the consumer keeps one to
// itself), and kProducers producers
constexpr int kLvWarps = 8;
constexpr int kIdle = 4;
constexpr int kProducers = kLvWarps - 2;
constexpr int kMaxRing = 2 * kProducers;
// the flags: ready[kMaxRing], then done; 16 bytes aligned
constexpr int kFlagBytes = ((kMaxRing + 1) * 4 + 15) / 16 * 16;
enum LvMode { kLvEuropean = 0, kLvProjection = 1, kLvBermudan = 2 };

// Values of a slot: a step's factors (planes of `rows` rows: K where the
// rows are in registers, else m), then its two end values.
__host__ __device__ constexpr int slot_values(int rows) { return wtri::factor_values(rows) + 2; }

template <typename T, int K>
__global__ void __launch_bounds__(kLvWarps * 32)
    lv_pde_kernel(const T* __restrict__ lo, const T* __restrict__ di, const T* __restrict__ up,
                  const T* __restrict__ ends, const T* __restrict__ psi,
                  const T* __restrict__ v0, T* __restrict__ out, T* __restrict__ conts,
                  T* __restrict__ work, int n, int n_time, int mode, int spd, int ring) {
  using A = tri::Arith<T>;
  using Rows = std::conditional_t<(K > 0), wtri::Regs<T, K>, wtri::Mem<T>>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  volatile int* ready = reinterpret_cast<volatile int*>(smem_raw);
  volatile int* done = ready + kMaxRing;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.x;
  const int m = wtri::rows_per_lane(n);
  const int rows = K > 0 ? K : m;  // a plane's rows
  const int fv = wtri::factor_values(rows);
  const int sv = slot_values(rows);
  T* slots;
  if constexpr (K > 0) {
    slots = reinterpret_cast<T*>(smem_raw + kFlagBytes);
  } else {
    slots = work + b * (static_cast<int64_t>(ring) * sv + m * wtri::kLanes);
  }
  if (threadIdx.x <= kMaxRing) ready[threadIdx.x] = 0;  // every ready flag, and done
  __syncthreads();
  const int g0 = lane * m;

  if (warp == kIdle) return;
  if (warp > 0) {
    // a producer: the factors of steps p, p + kProducers, …
    const int producer = warp - 1 - (warp > kIdle);
    for (int k = producer; k < n_time; k += kProducers) {
      const int s = k % ring;
      if (k >= ring) {
        while (*done < k - ring + 1) __nanosleep(64);  // step k − ring has left the slot
      }
      __threadfence_block();
      T* slot = slots + static_cast<int64_t>(s) * sv;
      wtri::MemFactors<T> fs = wtri::mem_factors(slot, rows);
      const int64_t row = (b * n_time + k) * n;
      // the step's rows (padding past n, and the rows past m where K > m:
      // a = c = 0, b = 1; a_0 and c_{n−1} taken as 0)
      const auto ga = [&](int i) {
        const int g = g0 + i;
        return i < m && g > 0 && g < n ? lo[row + g] : T(0);
      };
      const auto gb = [&](int i) {
        const int g = g0 + i;
        return i < m && g < n ? di[row + g] : T(1);
      };
      const auto gc = [&](int i) {
        const int g = g0 + i;
        return i < m && g < n - 1 ? up[row + g] : T(0);
      };
      if constexpr (K > 0) {
        wtri::RegFactors<T, K> f;
        const wtri::Edge<T> e = wtri::form_local<K, T>(m, ga, gb, gc, f);
        wtri::form_reduced(e, f);
        wtri::copy_factors<K, T>(m, f, fs);
      } else {
        const wtri::Edge<T> e = wtri::form_local<0, T>(m, ga, gb, gc, fs);
        wtri::form_reduced(e, fs);
      }
      if (lane < 2) slot[fv + lane] = ends[(b * n_time + k) * 2 + lane];
      __threadfence_block();
      __syncwarp();
      if (lane == 0) ready[s] = k + 1;
    }
    return;
  }

  // the consumer
  Rows v{}, ps{};
  if constexpr (K == 0) v = Rows{slots + static_cast<int64_t>(ring) * sv + lane};
  wtri::rows_up<K>(0, m, [&](int i) {
    const int g = g0 + i;
    v.set(i, g < n ? v0[b * n + g] : T(0));
    if constexpr (K > 0) ps.set(i, g < n ? psi[b * n + g] : T(0));
  });
  const auto psi_at = [&](int i) -> T {
    if constexpr (K > 0) {
      return ps.get(i);
    } else {
      return psi[b * n + g0 + i];
    }
  };
  const int n_dates = mode == kLvBermudan ? n_time / spd : 0;
  for (int k = 0; k < n_time; ++k) {
    const int s = k % ring;
    while (ready[s] != k + 1) {
    }
    __threadfence_block();
    T* slot = slots + static_cast<int64_t>(s) * sv;
    const wtri::MemFactors<T> fs = wtri::mem_factors(slot, rows);
    const T e0 = slot[fv], e1 = slot[fv + 1];
    // the slot's factors into registers at once (K > 0: loads a pass reads
    // as it goes would put their latency on the chain), then the
    // right-hand side, v with the step's end values (padding 0)
    std::conditional_t<(K > 0), wtri::RegFactors<T, K>, wtri::MemFactors<T>> f;
    if constexpr (K > 0) {
      wtri::copy_factors<K, T>(m, fs, f);
    } else {
      f = fs;
    }
    wtri::solve<K, T>(
        m, f,
        [&](int i) {
          const int g = g0 + i;
          return g == 0 ? e0 : (g == n - 1 ? e1 : (i < m && g < n ? v.get(i) : T(0)));
        },
        v);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) *done = k + 1;
    // the clamp (every step, or a Bermudan date's, after its slice is
    // written)
    const bool date = mode == kLvBermudan && (k + 1) % spd == 0 && k + 1 < n_time;
    if (mode == kLvProjection || date) {
      wtri::rows_up<K>(0, m, [&](int i) {
        const int g = g0 + i;
        if (g < n) {
          const T x = v.get(i);
          if (date) conts[(b * (n_dates - 1) + (k + 1) / spd - 1) * n + g] = x;
          v.set(i, A::max(x, psi_at(i)));
        }
      });
    }
  }
  wtri::rows_up<K>(0, m, [&](int i) {
    if (g0 + i < n) out[b * n + g0 + i] = v.get(i);
  });
}

// Shared memory of a block: the flags, and (K > 0) the ring.
template <typename T, int K>
int64_t lv_smem(int n, int ring) {
  return kFlagBytes + (K > 0 ? static_cast<int64_t>(ring) * slot_values(K) * sizeof(T) : 0);
}

template <typename T, int K>
cudaError_t launch_rows(const void* lo, const void* di, const void* up, const void* ends,
                        const void* psi, const void* v0, void* out, void* conts, void* work,
                        int batch, int n, int n_time, int mode, int spd, int ring,
                        cudaStream_t st) {
  const int64_t bytes = lv_smem<T, K>(n, ring);
  if (bytes > tri::kMaxSmem || (K == 0 && work == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(lv_pde_kernel<T, K>, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  lv_pde_kernel<T, K><<<batch, kLvWarps * 32, static_cast<size_t>(bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(ends), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<T*>(out), static_cast<T*>(conts), static_cast<T*>(work), n, n_time, mode, spd,
      ring);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* lo, const void* di, const void* up, const void* ends,
                   const void* psi, const void* v0, void* out, void* conts, void* work, int batch,
                   int n, int n_time, int mode, int spd, int ring, cudaStream_t st) {
  switch (wtri::register_rows(n, sizeof(T))) {
    case 8:
      return launch_rows<T, 8>(lo, di, up, ends, psi, v0, out, conts, work, batch, n, n_time,
                               mode, spd, ring, st);
    case 16:
      if constexpr (sizeof(T) == 4) {
        return launch_rows<T, 16>(lo, di, up, ends, psi, v0, out, conts, work, batch, n, n_time,
                                  mode, spd, ring, st);
      }
      return cudaErrorInvalidValue;
    default:
      return launch_rows<T, 0>(lo, di, up, ends, psi, v0, out, conts, work, batch, n, n_time,
                               mode, spd, ring, st);
  }
}

}  // namespace
}  // namespace optionslab

// All arrays contiguous, of one dtype (0 float32, 1 float64): lo, di, up
// (batch, n_time, n) each step's diagonals; ends (batch, n_time, 2) the
// right-hand side's first and last value at each step; psi, v0 and out
// (batch, n). mode: 0 European, 1 projection after every step, 2 Bermudan
// (spd steps a date; n_time a multiple of spd): conts (batch, n_time/spd −
// 1, n), each date's slice before its projection, in the loop's order
// (null when there is none). ring: slots of the factor ring, 1 to 12 (the
// wrapper's plan, ops/lv_pde.py lv_plan); work: null where the rows fit in
// registers, else (batch, ring · slot + 32·m) values of device memory.
// Returns a cudaError_t code (0 on success).
extern "C" int lv_pde_launch(const void* lo, const void* di, const void* up, const void* ends,
                             const void* psi, const void* v0, void* out, void* conts, void* work,
                             int batch, int n, int n_time, int mode, int spd, int ring, int dtype,
                             int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kLvEuropean || mode > kLvBermudan || spd < 1 ||
      ring < 1 || ring > kMaxRing ||
      (mode == kLvBermudan && (n_time % spd != 0 || (n_time / spd > 1 && conts == nullptr))) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch<float>(lo, di, up, ends, psi, v0, out, conts, work, batch, n, n_time,
                                   mode, spd, ring, st)
                   : launch<double>(lo, di, up, ends, psi, v0, out, conts, work, batch, n,
                                    n_time, mode, spd, ring, st);
  return static_cast<int>(err);
}
