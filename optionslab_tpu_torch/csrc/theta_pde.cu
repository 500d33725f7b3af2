// The θ-scheme time loop of the Crank–Nicolson book in one launch:
// n_time steps of a European, a projected American or a Howard (policy
// iteration) American step for a book of contracts, each on its own grid;
// optionally a jump table applied after a few steps (a cash dividend's drop
// of the spot), and the history its reverse reads. Then the reverse of the
// loop in one more launch (theta_pde_adjoint_kernel, below).
//
// Replaces the reference's device loops optionslab_tpu/models/fdm.py:162
// (the lax.scan over time steps of _cn_single) and :101 (the fori_loop of
// _howard_lcp_solve's 8 policy sweeps), and optionslab_tpu/models/
// dividends.py:137 (the lax.scan of _fdm_div_single, its jump condition
// jnp.interp at the ex-date steps). Without it the port steps on the host:
// ≈20–55 small torch launches a step around each tridiagonal solve.
//
// What bounds it. The dependent chain: each step solves each contract's
// system once (European, projection) or once a Howard sweep. The matrix of
// every European and projection solve, and of the first Howard sweep of
// every step, never changes, so its pivots are formed once a launch and
// such a solve is the right-hand side's chain on reciprocals and the back
// substitution (tridiag.cu's right-hand-side probe times a node of the
// two); a later Howard sweep re-forms the pivots from the first row whose
// exercise flag changed (the pivot probe's node) and substitutes back over
// all n nodes. The contracts' chains run side by side; the node-parallel
// work around each solve (the explicit step, the exercise residual, the
// projection) is a few operations a node spread over the block's threads.
//
// What the design does about it. It takes the host's issue out and keeps
// every contract on chip for the whole loop:
// - one CUDA block owns a tile of `systems` contracts (a power of two up to
//   16, picked by the wrapper so that the book's chains all run at once);
//   v, the right-hand side, the exercise set, the working c', d' and pivots
//   and the tables of the unexercised matrix (den, c', RN(1/den)) live in
//   shared memory from the first step to the last;
// - the tables are formed once (tri::form_tables); a solve on them is
//   tri::rhs_chain, one lane a contract over as many of the block's warps
//   as the tile has contracts, each quotient three dependent operations on
//   the table's reciprocal where they round as the division does;
// - a later Howard sweep is tridiag.cuh's two-lane solve (warp 0) restarted
//   at the first row whose exercise flag changed since the sweep before (at
//   the group of tri::kUnroll rows that holds the tile's first): Thomas's
//   forward values at a row depend only on the rows above it, so the rows
//   before keep the sweep before's c', den and d' (the first later sweep
//   takes the tables'); the back substitution runs over all n nodes;
// - each step the block's threads form the explicit right-hand side in
//   parallel over the nodes and re-select Howard's exercise rows;
// - a Howard step stops sweeping once no contract of the block changes its
//   exercise set: every later sweep would solve the same system again and
//   give the same values, so the result is the 8-sweep loop's bit for bit.
//
// Bit for bit with the plain loop (ops/theta_pde.py _theta_plain, which
// models/fdm.py _cn_book runs on the CPU and differentiates on the card):
// the explicit step is v + w·((a·v₋ + b·v) + c·v₊) and the residual
// ((lo·v₋ + di·v) + up·v₊) − rhs, each operation rounded on its own in that
// order; the masked operands are selections; every quotient is the
// division's own (tri::fast_quotient, tri::flagged_quotient or
// tri::quotient); the end values come
// from the wrapper's table, computed by torch, so no exp here can differ
// from torch's.
#include <cuda_runtime.h>

#include <cstdint>

#include "tridiag.cuh"

namespace optionslab {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHowardSweeps = 8;
enum Mode { kEuropean = 0, kProjection = 1, kHoward = 2 };

// The shared-memory tile of one block: twelve node-major planes (node j of
// contract s at [j * pitch + s]): the implicit side's lower, diagonal and
// upper, the right-hand side, v, ψ, the working c', d' and pivots, and the
// tables of the unexercised matrix (den, c', RN(1/den)), each with
// tri::kPad rows of padding at both ends; the contracts' a, b, c and w; the
// exercise set, one byte a node (padded alike); then (8-byte aligned) each
// contract's first changed row, and the dump slots.
struct ThetaTile {
  int pitch;
  int64_t plane;  // (n + 2·kPad) × pitch
  int64_t first;  // byte offset of the first changed rows
  int64_t dump;   // byte offset of the dump slots
  int64_t bytes;

  __host__ __device__ ThetaTile(int n, int systems, int size) {
    pitch = systems | 1;
    plane = static_cast<int64_t>(n + 2 * tri::kPad) * pitch;
    first = ((12 * plane + 4 * systems) * size + plane + 7) / 8 * 8;
    dump = first + (4 * systems + 7) / 8 * 8;
    bytes = dump + tri::kDumpBytes;
  }
};

inline __device__ unsigned char ld_shared_u8(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return static_cast<unsigned char>(v);
}

// Node j of the system a Howard sweep solves (tri::forward_split's load):
// the unexercised row, or v = ψ where the row is exercised.
template <typename T>
struct HowardRow {
  tri::Col<T> lo, di, up, rhs, psi;
  unsigned mask, mask_stride;  // the exercise set's column: byte address, pitch
  __device__ __forceinline__ void operator()(int j, T& a, T& b, T& c, T& d) const {
    const bool ex = ld_shared_u8(mask + j * mask_stride) != 0;
    const T l = lo[j], g = di[j], u = up[j], r = rhs[j], p = psi[j];
    a = ex ? T(0) : l;
    b = ex ? T(1) : g;
    c = ex ? T(0) : u;
    d = ex ? p : r;
  }
};

// The history and the jump table are optional (null pointers): hist_u
// (batch, n_time, n) each step's solution before the clamp, hist_m the same
// shape, one byte a node, Howard's exercise set of the step's last solve;
// jump_at (n_time) the jump after each step (−1 none), jump_index and
// jump_weight (batch, n_jumps, n) its gather table (see Jumps in
// ops/theta_pde.py).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    theta_pde_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                     const T* __restrict__ up, const T* __restrict__ coef,
                     const T* __restrict__ psi, const T* __restrict__ v0,
                     const T* __restrict__ ends, T* __restrict__ out, int* __restrict__ counts,
                     T* __restrict__ hist_u, unsigned char* __restrict__ hist_m,
                     const int* __restrict__ jump_at, const int* __restrict__ jump_index,
                     const T* __restrict__ jump_weight, int n_jumps, int batch, int n,
                     int n_time, int mode, int systems) {
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
  T* s_cs = s_psi + tile.plane;  // the working c', d' and pivots
  T* s_ds = s_cs + tile.plane;
  T* s_dn = s_ds + tile.plane;
  T* t_den = s_dn + tile.plane;  // the tables of the unexercised matrix
  T* t_cs = t_den + tile.plane;
  T* t_rcp = t_cs + tile.plane;
  T* s_coef = t_rcp + tile.plane - pad;  // a, b, c, w: `systems` each
  unsigned char* s_m = reinterpret_cast<unsigned char*>(s_coef + 4 * systems) + pad;
  int* s_first = reinterpret_cast<int*>(smem_raw + tile.first);
  const void* dump = smem_raw + tile.dump;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * systems;
  const int rows = min(systems, batch - b0);
  const int cells = rows * n;
  for (int e = tid; e < cells; e += kThreads) {  // coalesced along each contract's row
    const int s = e / n;
    const int j = e - s * n;
    const int64_t g = static_cast<int64_t>(b0 + s) * n + j;
    const int t = j * p + s;
    s_lo[t] = lo[g];
    s_di[t] = di[g];
    s_up[t] = up[g];
    s_v[t] = v0[g];
    s_psi[t] = psi[g];
  }
  for (int e = tid; e < 4 * rows; e += kThreads) {
    const int q = e / rows;
    const int s = e - q * rows;
    s_coef[q * systems + s] = coef[static_cast<int64_t>(q) * batch + b0 + s];
  }
  T* const operands[4] = {s_lo, s_di, s_up, s_rhs};
  for (int e = tid; e < pad; e += kThreads) {  // the padding: see tri::kPad
    for (int o = 0; o < 4; ++o) {
      operands[o][e - pad] = tri::pad_value<T>(o, false);
      operands[o][n * p + e] = tri::pad_value<T>(o, true);
    }
    s_m[e - pad] = 0;
    s_m[n * p + e] = 0;
  }
  if (tid < systems) s_first[tid] = n;
  __syncthreads();

  const T* s_a = s_coef;
  const T* s_b = s_coef + systems;
  const T* s_c = s_coef + 2 * systems;
  const T* s_w = s_coef + 3 * systems;
  // the solves on the tables: one lane a contract over the warps; a warp
  // with a contract runs whole (the chain's vote), its lanes without one on
  // the warp's first contract, writing to their dump slots
  const int warp = tid >> 5;
  const int t_sys = tri::spread_system(kWarps);
  const bool t_live = t_sys < rows;
  const bool t_warp = warp < rows;
  const int ts = t_live ? t_sys : (t_warp ? warp : 0);
  const tri::Col<T> t_lo = tri::col<T>(s_lo, ts, p);
  const tri::Col<T> t_rhs = tri::col<T>(s_rhs, ts, p);
  const tri::Col<T> t_dn = tri::col<T>(t_den, ts, p);
  const tri::Col<T> t_c = tri::col<T>(t_cs, ts, p);
  const tri::Col<T> t_y = tri::col<T>(t_rcp, ts, p);
  const tri::Col<T> t_x = tri::col<T>(s_v, ts, p);
  const tri::Col<T> t_ds = t_live ? tri::col<T>(s_ds, ts, p) : tri::dump_col<T>(dump);
  if (t_live) {
    tri::form_tables(n, t_lo, tri::col<T>(s_di, ts, p), tri::col<T>(s_up, ts, p), t_dn, t_c,
                     t_y);
  }
  // Howard's later sweeps: warp 0, pivot lane s and its partner s + 16 on
  // contract s; a lane without a contract reads contract 0's column and
  // writes to its dump slot
  const bool live = tid < 32 && tid % tri::kPair < rows;
  const int sys = live ? tid % tri::kPair : 0;
  HowardRow<T> row{tri::col<T>(s_lo, sys, p),
                   tri::col<T>(s_di, sys, p),
                   tri::col<T>(s_up, sys, p),
                   tri::col<T>(s_rhs, sys, p),
                   tri::col<T>(s_psi, sys, p),
                   static_cast<unsigned>(__cvta_generic_to_shared(s_m + sys)),
                   static_cast<unsigned>(p)};
  const tri::Col<T> cs = tri::col<T>(s_cs, sys, p);
  const tri::Col<T> ds = tri::col<T>(s_ds, sys, p);
  const tri::Col<T> dn = tri::col<T>(s_dn, sys, p);
  const tri::Col<T> vs = tri::col<T>(s_v, sys, p);
  const bool pivot_lane = tid < tri::kPair;
  const tri::Col<T> quotients = live ? (pivot_lane ? cs : ds) : tri::dump_col<T>(dump);
  const tri::Col<T> dens = live && pivot_lane ? dn : tri::dump_col<T>(dump);
  const int sweeps = mode == kHoward ? kHowardSweeps : 1;
  int n_solves = 0;
  int n_pivots = n;  // the tables' chain
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
      s_rhs[t] = r;
      if (mode == kHoward) s_m[t] = 0;  // no exercise row yet this step
    }
    __syncthreads();
    // the unexercised matrix: its tables
    if (t_warp) {
      tri::rhs_chain(n, t_lo, t_rhs, t_dn, t_y, t_ds);
      if (t_live) tri::back_sweep(n, t_c, t_ds, t_x);
    }
    ++n_solves;
    __syncthreads();
    for (int sweep = 1; sweep < sweeps; ++sweep) {
      // Howard: the rows where exercising beats continuing, and each
      // contract's first row that changed
      int changed = 0;
      for (int e = tid; e < cells; e += kThreads) {
        const int j = e / rows;
        const int s = e - j * rows;
        const int t = j * p + s;
        if (sweep == 1) {  // the sweep before ran on the tables
          s_cs[t] = t_cs[t];
          s_dn[t] = t_den[t];
        }
        if (j == 0 || j == n - 1) continue;
        const T vc = s_v[t];
        const T res = A::sub(A::add(A::add(A::mul(s_lo[t], s_v[t - p]), A::mul(s_di[t], vc)),
                                    A::mul(s_up[t], s_v[t + p])),
                             s_rhs[t]);
        const unsigned char m = res > A::sub(vc, s_psi[t]);
        if (m != s_m[t]) {
          changed = 1;
          atomicMin(s_first + s, j);
        }
        s_m[t] = m;
      }
      if (!__syncthreads_or(changed)) break;  // a fixed point: the rest repeat this sweep
      if (tid < 32) {
        int j0 = n;
        for (int s = 0; s < rows; ++s) j0 = min(j0, s_first[s]);
        __syncwarp();
        if (tid < rows) s_first[tid] = n;
        j0 &= ~(tri::kUnroll - 1);  // forward_split starts at a group
        // the carries at row j0 − 1 from the sweep before (start values at 0)
        T x = j0 == 0 ? T(0) : (pivot_lane ? cs[j0 - 1] : ds[j0 - 2]);
        T den = j0 == 0 ? T(1) : dn[j0 - 1];
        tri::forward_split<T, HowardRow<T>, true>(j0, n + 1, row, quotients, x, den, dens);
        __syncwarp();
        if (pivot_lane && live) tri::back_sweep(n, cs, ds, vs);
        n_pivots += n - j0;
      }
      ++n_solves;
      __syncthreads();
    }
    // the history the reverse reads (the solution before the clamp, and
    // the exercise set the step's last solve ran on: after a fixed point
    // the set the sweep before left, after the eighth sweep the seventh's),
    // then the clamp; along each contract's row
    if (hist_u != nullptr || mode != kEuropean) {
      for (int e = tid; e < cells; e += kThreads) {
        const int s = e / n;
        const int j = e - s * n;
        const int t = j * p + s;
        const T u = s_v[t];
        if (hist_u != nullptr) {
          const int64_t h = (static_cast<int64_t>(b0 + s) * n_time + k) * n + j;
          hist_u[h] = u;
          if (mode == kHoward) hist_m[h] = s_m[t];
        }
        if (mode != kEuropean) s_v[t] = A::max(u, s_psi[t]);
      }
      __syncthreads();
    }
    // a jump: each node from the table (models/slv.py _interp's
    // f0 + ((x − x0)/dx)·(f1 − f0), the quotient the table's weight) into
    // the right-hand side's plane, free until the next step; then clamped
    // again in the American modes
    const int jump = jump_at == nullptr ? -1 : jump_at[k];
    if (jump >= 0) {
      for (int e = tid; e < cells; e += kThreads) {
        const int s = e / n;
        const int j = e - s * n;
        const int64_t g = (static_cast<int64_t>(b0 + s) * n_jumps + jump) * n + j;
        const int code = jump_index[g];
        T f;
        if (code >= 0) {
          const T f0 = s_v[code * p + s];
          f = A::add(f0, A::mul(jump_weight[g], A::sub(s_v[(code + 1) * p + s], f0)));
        } else {
          f = s_v[(-1 - code) * p + s];
        }
        s_rhs[j * p + s] = f;
      }
      __syncthreads();
      for (int e = tid; e < cells; e += kThreads) {
        const int s = e / n;
        const int t = (e - s * n) * p + s;
        s_v[t] = mode != kEuropean ? A::max(s_rhs[t], s_psi[t]) : s_rhs[t];
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < cells; e += kThreads) {
    const int s = e / n;
    const int j = e - s * n;
    out[static_cast<int64_t>(b0 + s) * n + j] = s_v[j * p + s];
  }
  if (tid == 0) {
    counts[blockIdx.x] = n_solves;
    counts[gridDim.x + blockIdx.x] = n_pivots;
  }
}

template <typename T>
cudaError_t launch(const void* lo, const void* di, const void* up, const void* coef,
                   const void* psi, const void* v0, const void* ends, void* out, int* counts,
                   void* hist_u, void* hist_m, const int* jump_at, const int* jump_index,
                   const void* jump_weight, int n_jumps, int batch, int n, int n_time, int mode,
                   int systems, cudaStream_t st) {
  const ThetaTile tile(n, systems, sizeof(T));
  if (tile.bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(theta_pde_kernel<T>, static_cast<int>(tile.bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + systems - 1) / systems;
  theta_pde_kernel<T><<<blocks, kThreads, static_cast<size_t>(tile.bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(coef), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<const T*>(ends), static_cast<T*>(out), counts, static_cast<T*>(hist_u),
      static_cast<unsigned char*>(hist_m), jump_at, jump_index,
      static_cast<const T*>(jump_weight), n_jumps, batch, n, n_time, mode, systems);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The reverse of the loop (theta_pde_adjoint_kernel)
//
// Replaces the reverse mode of the reference's loop (optionslab_tpu/models/
// fdm.py:162 and :101), which jax.grad runs in greeks_from_fn. Without it
// the port's backward reran the plain loop under autograd: one tridiagonal
// launch a solve each way and ≈30 small launches around each.
//
// The recursion, from the last step to the first, over the forward's
// history (each step's solution u before the clamp; Howard's exercise set
// of the step's last solve), ḡ the gradient of the step's output:
//   1. the clamp v = max(u, ψ) (projection, Howard): ḡ to u where u > ψ, to
//      ψ where u < ψ, half to each at a tie (torch.maximum's derivative; on
//      every exercised Howard row u = ψ exactly);
//   2. the adjoint solve Aᵀλ = ḡ on the step's matrix A = LU (L: the pivots
//      den on its diagonal and lo below; U: 1 and c' above), Uᵀ then Lᵀ on
//      the pivots and c' formed once (per step in Howard mode, whose matrix
//      has each exercised row replaced by v = ψ: there λ goes to ψ and
//      nothing to lo, di or up); lo, di, up take −λ_j·u_{j−1}, −λ_j·u_j,
//      −λ_j·u_{j+1};
//   3. the right-hand side v + w·((a·v₋ + b·v) + c·v₊) with its ends: rows 0
//      and n − 1 send λ to the step's end values, the interior rows to the
//      step's input v (the new ḡ) and to a, b, c and w.
//
// What bounds it. The chains: each step each contract's Uᵀ sweep (a forward
// chain of products and differences) and Lᵀ sweep (a back chain with a
// quotient), n nodes of a forward and a back node, and in Howard mode the
// step's pivots beside the Uᵀ sweep; the contracts run side by side, one
// thread each. What the design does: one CUDA block a tile of contracts (the
// forward's plan), the diagonals, the chains' working planes and the
// accumulators of lo, di, up and ψ in shared memory for the launch, written
// once at the end; the step's solution and input read from the history in
// global memory, neighbouring threads on neighbouring nodes; the node work
// spread over the block's threads; the shares of a, b, c and w reduced each
// step over 32 nodes at a time by a fixed butterfly into one slot per
// contract and chunk, the slots summed in chunk order at the end: fixed-order
// sums, no atomics. The tile is eleven planes, against the forward's twelve
// and their padding, so the reverse takes every grid the forward takes. A
// simple kernel: its chains divide (no reciprocal tables) and one thread
// runs a contract's chains.
constexpr int kAdjointPlanes = 11;
constexpr int kChunk = 32;  // the nodes of a share reduction, a warp's lanes

// The shared-memory tile of the reverse kernel: eleven node-major planes
// (node j of contract s at [j * pitch + s]): lo, di, up, the gradient ḡ
// (then z, then λ), the right-hand side's share of λ, the pivots and c' of
// the step's matrix, and the accumulators of lo, di, up and ψ; the
// contracts' a, b, c and w; the shares of a, b, c and w, four slots a
// contract and chunk of kChunk nodes; the exercise set, one byte a node.
struct AdjointTile {
  int pitch;
  int chunks;     // ⌈n / kChunk⌉
  int64_t plane;  // n × pitch
  int64_t bytes;

  __host__ __device__ AdjointTile(int n, int systems, int size) {
    pitch = systems | 1;
    chunks = (n + kChunk - 1) / kChunk;
    plane = static_cast<int64_t>(n) * pitch;
    bytes = ((kAdjointPlanes * plane + 4 * systems + 4LL * systems * chunks) * size + plane + 7) /
            8 * 8;
  }
};

// den_j and c'_j of one contract's step matrix, exercised rows (mask may
// be null: none) replaced by the identity row: the plain solve's pivots,
// guard and quotient (tri::guard_pivot, tri::quotient).
template <typename T>
__device__ void adjoint_tables(int n, int p, const T* lo, const T* di, const T* up,
                               const unsigned char* mask, T* den, T* cs) {
  using A = tri::Arith<T>;
  T c = T(0);
  for (int j = 0; j < n; ++j) {
    const int t = j * p;
    const bool ex = mask != nullptr && mask[t] != 0;
    const T g = tri::guard_pivot(A::sub(ex ? T(1) : di[t], A::mul(ex ? T(0) : lo[t], c)));
    c = tri::quotient(ex ? T(0) : up[t], g);
    den[t] = g;
    cs[t] = c;
  }
}

// The sum of a warp's 32 values by a fixed butterfly; lane 0's sum is the
// one kept (each lane's adds run in an order fixed by its lane number).
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  using A = tri::Arith<T>;
  for (int d = 16; d > 0; d >>= 1) x = A::add(x, __shfl_xor_sync(0xffffffffu, x, d));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    theta_pde_adjoint_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                             const T* __restrict__ up, const T* __restrict__ coef,
                             const T* __restrict__ psi, const T* __restrict__ v0,
                             const T* __restrict__ hist_u,
                             const unsigned char* __restrict__ hist_m,
                             const T* __restrict__ g_out, T* __restrict__ g_grid,
                             T* __restrict__ g_coef, T* __restrict__ g_ends, int batch, int n,
                             int n_time, int mode, int systems) {
  using A = tri::Arith<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const AdjointTile tile(n, systems, sizeof(T));
  const int p = tile.pitch;
  const int chunks = tile.chunks;
  T* planes[kAdjointPlanes];
  for (int i = 0; i < kAdjointPlanes; ++i) {
    planes[i] = reinterpret_cast<T*>(smem_raw) + i * tile.plane;
  }
  T* s_lo = planes[0];
  T* s_di = planes[1];
  T* s_up = planes[2];
  T* s_g = planes[3];   // ḡ, then z = U⁻ᵀḡ, then λ
  T* s_gi = planes[4];  // the right-hand side's interior share of λ
  T* s_den = planes[5];
  T* s_cs = planes[6];
  T* acc = planes[7];  // lo, di, up, ψ: a plane each
  T* s_coef = reinterpret_cast<T*>(smem_raw) + kAdjointPlanes * tile.plane;
  T* s_part = s_coef + 4 * systems;  // [contract][chunk][a, b, c, w]
  unsigned char* s_m = reinterpret_cast<unsigned char*>(s_part + 4 * systems * chunks);
  const int64_t pl = tile.plane;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * systems;
  const int rows = min(systems, batch - b0);
  const int cells = rows * n;
  const bool howard = mode == kHoward;
  for (int e = tid; e < cells; e += kThreads) {  // along each contract's row
    const int s = e / n;
    const int j = e - s * n;
    const int64_t g = static_cast<int64_t>(b0 + s) * n + j;
    const int t = j * p + s;
    s_lo[t] = lo[g];
    s_di[t] = di[g];
    s_up[t] = up[g];
    s_g[t] = g_out[g];
    for (int q = 0; q < 4; ++q) acc[q * pl + t] = T(0);
    s_m[t] = 0;
  }
  for (int e = tid; e < 4 * rows; e += kThreads) {
    const int q = e / rows;
    const int s = e - q * rows;
    s_coef[q * systems + s] = coef[static_cast<int64_t>(q) * batch + b0 + s];
  }
  for (int e = tid; e < 4 * rows * chunks; e += kThreads) s_part[e] = T(0);
  __syncthreads();
  // the chains: contract `sys` on one thread, the contracts spread over the
  // warps
  const int sys = tri::spread_system(kWarps);
  const bool chain = sys < rows;
  if (chain && !howard) adjoint_tables(n, p, s_lo + sys, s_di + sys, s_up + sys,
                                       static_cast<const unsigned char*>(nullptr), s_den + sys,
                                       s_cs + sys);
  for (int k = n_time - 1; k >= 0; --k) {
    // the clamp's adjoint on the step's solution from the history
    for (int e = tid; e < cells; e += kThreads) {
      const int s = e / n;
      const int j = e - s * n;
      const int t = j * p + s;
      const int64_t h = (static_cast<int64_t>(b0 + s) * n_time + k) * n + j;
      if (mode != kEuropean) {
        const T u = hist_u[h];
        const T pv = psi[static_cast<int64_t>(b0 + s) * n + j];
        const T gv = s_g[t];
        const T half = A::mul(gv, T(0.5));
        const T gu = u < pv ? T(0) : (u == pv ? half : gv);
        const T gp = u > pv ? T(0) : (u == pv ? half : gv);
        acc[3 * pl + t] = A::add(acc[3 * pl + t], gp);
        s_g[t] = gu;
      }
      if (howard) s_m[t] = hist_m[h];
    }
    __syncthreads();
    // the adjoint solve: Uᵀz = ḡ, then Lᵀλ = z, on the step's pivots and c'
    if (chain) {
      const int s = sys;
      if (howard) adjoint_tables(n, p, s_lo + s, s_di + s, s_up + s, s_m + s, s_den + s,
                                 s_cs + s);
      T z = s_g[s];
      for (int j = 1; j < n; ++j) {
        const int t = j * p + s;
        z = A::sub(s_g[t], A::mul(s_cs[t - p], z));
        s_g[t] = z;
      }
      T lam = A::quo(z, s_den[(n - 1) * p + s]);
      s_g[(n - 1) * p + s] = lam;
      for (int j = n - 2; j >= 0; --j) {
        const int t = j * p + s;
        const T l1 = howard && s_m[t + p] ? T(0) : s_lo[t + p];
        lam = A::quo(A::sub(s_g[t], A::mul(l1, lam)), s_den[t]);
        s_g[t] = lam;
      }
    }
    __syncthreads();
    // λ to ψ (exercised rows), to lo, di, up, to the ends, and the right-hand
    // side's interior share to a, b, c, w: a warp a chunk of one contract's
    // nodes, so the shares reduce over the warp
    for (int q = warp; q < rows * chunks; q += kWarps) {
      const int s = q / chunks;
      const int j = (q - s * chunks) * kChunk + lane;
      T sa = T(0), sb = T(0), sc = T(0), sw = T(0);
      if (j < n) {
        const int t = j * p + s;
        const int64_t row = static_cast<int64_t>(b0 + s) * n;
        const int64_t h = (static_cast<int64_t>(b0 + s) * n_time + k) * n + j;
        T lam = s_g[t];
        if (howard && s_m[t]) {
          acc[3 * pl + t] = A::add(acc[3 * pl + t], lam);
          lam = T(0);
        } else {
          const T ul = j > 0 ? hist_u[h - 1] : T(0);
          const T ur = j < n - 1 ? hist_u[h + 1] : T(0);
          acc[t] = A::sub(acc[t], A::mul(lam, ul));
          acc[pl + t] = A::sub(acc[pl + t], A::mul(lam, hist_u[h]));
          acc[2 * pl + t] = A::sub(acc[2 * pl + t], A::mul(lam, ur));
        }
        T gi = T(0);
        if (j == 0 || j == n - 1) {
          g_ends[(static_cast<int64_t>(b0 + s) * n_time + k) * 2 + (j == 0 ? 0 : 1)] = lam;
        } else {
          gi = lam;
          // the step's input: v0, or the step before's solution, clamped
          // to ψ outside the European mode
          T vin[3];
          for (int d = 0; d < 3; ++d) {
            const int jj = j - 1 + d;
            if (k == 0) {
              vin[d] = v0[row + jj];
            } else {
              vin[d] = hist_u[h - n - 1 + d];
              if (mode != kEuropean) vin[d] = A::max(vin[d], psi[row + jj]);
            }
          }
          const T lap =
              A::add(A::add(A::mul(s_coef[s], vin[0]), A::mul(s_coef[systems + s], vin[1])),
                     A::mul(s_coef[2 * systems + s], vin[2]));
          const T gw = A::mul(s_coef[3 * systems + s], gi);
          sa = A::mul(gw, vin[0]);
          sb = A::mul(gw, vin[1]);
          sc = A::mul(gw, vin[2]);
          sw = A::mul(gi, lap);
        }
        s_gi[t] = gi;
      }
      sa = warp_sum(sa);
      sb = warp_sum(sb);
      sc = warp_sum(sc);
      sw = warp_sum(sw);
      if (lane == 0) {
        T* part = s_part + 4 * q;
        part[0] = A::add(part[0], sa);
        part[1] = A::add(part[1], sb);
        part[2] = A::add(part[2], sc);
        part[3] = A::add(part[3], sw);
      }
    }
    __syncthreads();
    // the gradient of the step's input: gi + b·w·gi + a·w·gi₊ + c·w·gi₋
    for (int e = tid; e < cells; e += kThreads) {
      const int s = e / n;
      const int j = e - s * n;
      const int t = j * p + s;
      const T w = s_coef[3 * systems + s];
      const T gi = s_gi[t];
      const T right = j < n - 1 ? A::mul(s_coef[s], A::mul(w, s_gi[t + p])) : T(0);
      const T left = j > 0 ? A::mul(s_coef[2 * systems + s], A::mul(w, s_gi[t - p])) : T(0);
      s_g[t] = A::add(A::add(A::add(gi, A::mul(s_coef[systems + s], A::mul(w, gi))), right),
                      left);
    }
    __syncthreads();
  }
  const int64_t bn = static_cast<int64_t>(batch) * n;
  for (int e = tid; e < cells; e += kThreads) {
    const int s = e / n;
    const int j = e - s * n;
    const int t = j * p + s;
    const int64_t g = static_cast<int64_t>(b0 + s) * n + j;
    for (int q = 0; q < 4; ++q) g_grid[q * bn + g] = acc[q * pl + t];
    g_grid[4 * bn + g] = s_g[t];
  }
  if (chain) {  // a, b, c, w: each contract's chunk slots summed in chunk order
    for (int q = 0; q < 4; ++q) {
      T sum = T(0);
      for (int c = 0; c < chunks; ++c) sum = A::add(sum, s_part[4 * (sys * chunks + c) + q]);
      g_coef[static_cast<int64_t>(q) * batch + b0 + sys] = sum;
    }
  }
}

template <typename T>
cudaError_t launch_adjoint(const void* lo, const void* di, const void* up, const void* coef,
                           const void* psi, const void* v0, const void* hist_u,
                           const void* hist_m, const void* g_out, void* g_grid, void* g_coef,
                           void* g_ends, int batch, int n, int n_time, int mode, int systems,
                           cudaStream_t st) {
  const AdjointTile tile(n, systems, sizeof(T));
  if (tile.bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(theta_pde_adjoint_kernel<T>, static_cast<int>(tile.bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + systems - 1) / systems;
  theta_pde_adjoint_kernel<T><<<blocks, kThreads, static_cast<size_t>(tile.bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(coef), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<const T*>(hist_u), static_cast<const unsigned char*>(hist_m),
      static_cast<const T*>(g_out), static_cast<T*>(g_grid), static_cast<T*>(g_coef),
      static_cast<T*>(g_ends), batch, n, n_time, mode, systems);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optionslab

// All arrays contiguous, of one dtype (0 float32, 1 float64): lo, di, up,
// psi, v0 and out (batch, n); coef (4, batch): the explicit operator's a, b,
// c and the explicit weight w = (1 − θ)·dt; ends (batch, n_time, 2): the
// right-hand side's first and last value at each step. mode: 0 European,
// 1 projection, 2 Howard. systems: contracts per CUDA block, 1 to 16 (the
// wrapper's plan; the tile must fit in 227 KB of shared memory). counts:
// two ints a block, (2, blocks): the solves each of its contracts ran, then
// the pivot nodes its chains formed (the tables' n and, for each later
// Howard sweep, the rows from its restart on). hist_u, hist_m (may be
// null): the history, (batch, n_time, n), hist_m one byte a node and read
// only in Howard mode. jump_at (n_time ints, may be null), jump_index (int)
// and jump_weight (batch, n_jumps, n): the jump table. Returns a
// cudaError_t code (0 on success).
extern "C" int theta_pde_launch(const void* lo, const void* di, const void* up,
                                const void* coef, const void* psi, const void* v0,
                                const void* ends, void* out, void* counts, void* hist_u,
                                void* hist_m, const void* jump_at, const void* jump_index,
                                const void* jump_weight, int n_jumps, int batch, int n,
                                int n_time, int mode, int systems, int dtype, int device,
                                void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kEuropean || mode > kHoward || systems < 1 ||
      systems > tri::kPair || (dtype != 0 && dtype != 1) ||
      (hist_u != nullptr && mode == kHoward && hist_m == nullptr) ||
      (jump_at != nullptr && (n_jumps < 1 || jump_index == nullptr || jump_weight == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(counts);
  const int* at = static_cast<const int*>(jump_at);
  const int* idx = static_cast<const int*>(jump_index);
  err = dtype == 0 ? launch<float>(lo, di, up, coef, psi, v0, ends, out, s, hist_u, hist_m, at,
                                   idx, jump_weight, n_jumps, batch, n, n_time, mode, systems, st)
                   : launch<double>(lo, di, up, coef, psi, v0, ends, out, s, hist_u, hist_m, at,
                                    idx, jump_weight, n_jumps, batch, n, n_time, mode, systems,
                                    st);
  return static_cast<int>(err);
}

// The reverse of the loop: lo, di, up, psi, v0 and g (batch, n): the
// forward's operands and the gradient of its output; coef (4, batch);
// hist_u (batch, n_time, n) each step's solution before the clamp, hist_m
// (the same, one byte a node; Howard mode only, else may be null) the
// exercise set of each step's last solve. Writes g_grid (5, batch, n): the
// gradients of lo, di, up, psi and v0; g_coef (4, batch): of a, b, c, w;
// g_ends (batch, n_time, 2). mode and systems as theta_pde_launch's (the
// plan of adjoint_tile_bytes in ops/theta_pde.py). Returns a cudaError_t
// code (0 on success).
extern "C" int theta_pde_adjoint_launch(const void* lo, const void* di, const void* up,
                                        const void* coef, const void* psi, const void* v0,
                                        const void* hist_u, const void* hist_m, const void* g,
                                        void* g_grid, void* g_coef, void* g_ends, int batch,
                                        int n, int n_time, int mode, int systems, int dtype,
                                        int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kEuropean || mode > kHoward || systems < 1 ||
      systems > tri::kPair || (dtype != 0 && dtype != 1) ||
      (mode == kHoward && hist_m == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_adjoint<float>(lo, di, up, coef, psi, v0, hist_u, hist_m, g, g_grid, g_coef,
                                    g_ends, batch, n, n_time, mode, systems, st)
            : launch_adjoint<double>(lo, di, up, coef, psi, v0, hist_u, hist_m, g, g_grid,
                                     g_coef, g_ends, batch, n, n_time, mode, systems, st);
  return static_cast<int>(err);
}
