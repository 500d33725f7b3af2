// The θ-scheme time loop of the Crank–Nicolson book in one launch:
// n_time steps of a European, a projected American or a Howard (policy
// iteration) American step for a book of contracts, each on its own grid,
// and the history its reverse reads. Then the reverse of the loop in one
// more launch (theta_pde_adjoint_kernel, below), and the loop with a jump
// table (theta_jump_kernel, at the end: the cash-dividend PDE).
//
// Replaces the reference's device loops optionslab_tpu/models/fdm.py:162
// (the lax.scan over time steps of _cn_single) and :101 (the fori_loop of
// _howard_lcp_solve's 8 policy sweeps). Without it the port steps on the
// host: ≈20–55 small torch launches a step around each tridiagonal solve.
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
#include <type_traits>

#include "tridiag.cuh"
#include "warp_tridiag.cuh"

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

// The history is optional (null pointers): hist_u (batch, n_time, n) each
// step's solution before the clamp, hist_m the same shape, one byte a node,
// Howard's exercise set of the step's last solve.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    theta_pde_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                     const T* __restrict__ up, const T* __restrict__ coef,
                     const T* __restrict__ psi, const T* __restrict__ v0,
                     const T* __restrict__ ends, T* __restrict__ out, int* __restrict__ counts,
                     T* __restrict__ hist_u, unsigned char* __restrict__ hist_m, int batch, int n,
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
                   void* hist_u, void* hist_m, int batch, int n, int n_time, int mode,
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
      static_cast<unsigned char*>(hist_m), batch, n, n_time, mode, systems);
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
//   2. the adjoint solve Aᵀλ = ḡ on the step's matrix A (Howard: each
//      exercised row replaced by v = ψ; there λ goes to ψ and nothing to lo,
//      di or up); lo, di, up take −λ_j·u_{j−1}, −λ_j·u_j, −λ_j·u_{j+1};
//   3. the right-hand side v + w·((a·v₋ + b·v) + c·v₊) with its ends: rows 0
//      and n − 1 send λ to the step's end values, the interior rows to the
//      step's input v (the new ḡ) and to a, b, c and w.
//
// The solve by runs. An exercised row e of A is an identity row, so λ_e
// appears only in its own equation of Aᵀλ = ḡ,
//   λ_e = ḡ_e − up_{e−1}·λ_{e−1} − lo_{e+1}·λ_{e+1}
// (a term whose row is exercised too is absent), and the system splits into
// independent runs of continuation rows, each a principal submatrix of the
// unexercised matrix. A run that starts at row 0 has the leading pivots of
// that matrix's LU factorization from row 0, and a run that ends at row
// n − 1 the trailing pivots of its UL factorization from row n − 1; both
// sets of tables are formed once a launch. Only a run that touches neither
// end (never seen on fdm_price's exercise sets: a put's exercise rows are a
// block at the grid's low end, a call's at its high end) forms its own
// pivots, with the division. Rows 0 and n − 1 are Dirichlet identity rows
// in every caller; the kernel does not rely on it: they join the run beside
// them, which the tables cover. European and projection steps are the
// one-run case, on the LU tables.
//
// What bounds it. The chains: each step each run is a forward chain
// (Uᵀz = ḡ, z_j = fma(−c'_{j−1}, z_{j−1}, ḡ_j)) and a back chain (Lᵀλ = z,
// λ_j = fma(−m_j, λ_{j+1}, z_j·r_j), with r_j = RN(1/den_j) and m_j =
// RN(lo_{j+1}·r_j) from the tables), one dependent FMA a node each: tridiag.cu's
// FMA probe times such a node. The contracts and their runs run side by side.
// A run that touches both ends (every European and projection step) could be
// solved twisted, its upper part on the LU tables and its lower part on the
// UL tables sweeping towards a middle row side by side and then back
// outwards: about half the nodes, which is what the bound counts
// (chip_smoke.py theta_reverse_bound). This kernel sweeps every run one way.
// The node work around the chains (the clamp, λ to the accumulators and to
// a, b, c and w, the step's input) is a few operations a node over the
// block's threads.
//
// What the design does about it:
// - the tables (−c', r, −m of the LU factorization; the mirror of the UL)
//   are formed once a launch, the LU's and the UL's on two lanes of
//   different warps side by side, so neither chain holds a quotient, a
//   range check or a vote;
// - every plane is contract-major, each contract's row an odd number of 16
//   bytes (lanes of a warp on several contracts' rows hit different banks),
//   so a chain's step is one element and its direction a template argument:
//   tri::vec_walk loads each group of kWalk<T> nodes by 16-byte vectors at
//   immediate offsets before the group's chain and stores its outputs by
//   vectors after it. On the card a scalar load a node, with a stride known
//   only at run time, cost ≈23 cycles a node (each address a dependent add);
//   issuing the next group's loads during a chain made the chain wait for
//   them too (the loads share the six scoreboards);
// - Howard's runs are found from the step's exercise set by a warp's ballots
//   in the phase before the step's chains (find_runs), and each run goes to a
//   lane of its own, spread over the warps;
// - one CUDA block a tile of `systems` contracts (the forward's plan), each
//   contract's node work on a fixed set of the block's threads: the
//   diagonals, ψ, the chains' planes and the accumulators of lo, di, up and
//   ψ stay in shared memory for the launch, and each thread's shares of a,
//   b, c and w in its registers, summed over the threads in a fixed order at
//   the end (no atomics);
// - the step's data land a step ahead: each step's solution, its input and
//   its exercise set come into a ring of shared-memory rows by cp.async
//   while the steps before them run, and the clamp's adjoint of step k − 1
//   runs in the phase that forms the gradient of step k's input: three
//   barriers a step;
// - a grid whose tile does not fit in shared memory takes the same kernel
//   with its tables in a device-memory workspace and its history read from
//   the history itself (kDevice): every grid the forward takes.
//
// Arithmetic. The reverse has never been bitwise the plain reverse, which
// solves by Thomas on the transposed diagonals: it is held to a tolerance
// (THETA_REVERSE_RTOL in chip_smoke.py and tests/test_torch_cuda.py). So the
// chains round by FMA and by the tables' reciprocals, not as the division
// does; the forward's and the ADI reverse's bitwise rules do not apply. The
// order of every operation is fixed, so two launches agree bit for bit.
constexpr int kAdjointPlanes = 10;      // lo, di, up, ψ, ḡ, gi, and lo, di, up, ψ's accumulators
constexpr int kAdjointTablePlanes = 9;  // the shared route's tables and history ring
constexpr int kWorkRows = 7;            // the device route's workspace rows a contract
constexpr int kRing = 3;                // history rows in flight: u_k, u_{k−1}, u_{k−2}

// The planes of the reverse's tile, node j of contract s at [s * ld + j].
enum AdjointPlane {
  kLo = 0, kDi, kUp, kPsi,
  kG,    // ḡ, then z·r on a run's rows, then λ
  kGi,   // the right-hand side's interior share of λ (a Howard step's own pivots' −m before)
  kAcc,  // lo, di, up, ψ: four planes
  kTab = kAcc + 4,  // the shared route: the workspace rows below, then the ring
  kRingPlane = kTab + 6,
};
// Rows of the tables (planes kTab + row on the shared route, a contract's
// workspace rows on the device route): −c', r, −m of the LU factorization,
// the UL's alike; then the −m of a run that forms its own pivots (the gi
// plane on the shared route).
enum WorkRow { kRowLU = 0, kRowUL = 3, kRowPivots = 6 };

// The shared-memory tile of one block of the reverse: the planes (ten, and
// on the shared route nine more: the two factorizations' tables and kRing
// history rows), the contracts' a, b, c and w, each thread's shares of a,
// b, c and w; then (8-byte aligned) each contract's count of runs and its
// runs (first and last row, at most ⌈n / 2⌉); then on the shared route two
// exercise-set rows a contract, each the 4-byte words that hold the set's n
// bytes.
struct AdjointTile {
  int ld;  // a contract's row of a plane: n rounded up to an odd number of 16 bytes
  int max_runs;
  int mask_stride;  // bytes of a contract's exercise-set row
  int64_t plane;    // systems × ld
  int64_t runs;     // byte offsets: the runs' counts, the runs, the exercise sets
  int64_t run_list;
  int64_t masks;
  int64_t bytes;

  __host__ __device__ AdjointTile(int n, int systems, int size, bool device) {
    const int per16 = 16 / size;
    ld = ((n + per16 - 1) / per16 | 1) * per16;
    max_runs = (n + 1) / 2;
    mask_stride = (n + 6) / 4 * 4;
    plane = static_cast<int64_t>(systems) * ld;
    const int planes = kAdjointPlanes + (device ? 0 : kAdjointTablePlanes);
    runs = ((planes * plane + 4 * systems + 4 * kThreads) * size + 7) / 8 * 8;
    run_list = runs + (4 * systems + 7) / 8 * 8;
    masks = run_list + 8LL * systems * max_runs;
    bytes = (masks + (device ? 0 : 2LL * systems * mask_stride) + 7) / 8 * 8;
  }
};

// A contract's row of the device route's workspace: node i at ptr + i·step
// (step may be negative: a walk towards row 0); on the shared route a row is
// a tri::Col.
template <typename T>
struct GCol {
  T* ptr;
  int step;
  __device__ __forceinline__ T operator[](int i) const { return ptr[i * step]; }
  __device__ __forceinline__ void put(int i, T v) const { ptr[i * step] = v; }
  // the row seen from node j, walking dir = ±1 node a step
  __device__ __forceinline__ GCol walk(int j, int dir) const {
    return GCol{ptr + j * step, dir * step};
  }
};

// A chain of a run, `len` nodes from node `first` walking kDir, y a row of
// the tile: on the shared route tri::vec_walk; on the device route (x and r rows
// of its workspace) the same chain in groups of tri::kWalk<T> nodes, each
// group's operands loaded before its chain.
template <typename T, bool kScale, int kDir, typename Tab>
__device__ __forceinline__ void run_walk(int len, int first, const Tab& x, const Tab& r,
                                         const tri::Col<T>& y) {
  if constexpr (std::is_same_v<Tab, tri::Col<T>>) {
    tri::vec_walk<T, kScale, kDir>(len, first, x.addr, r.addr, y.addr);
  } else {
    constexpr int U = tri::kWalk<T>;
    const tri::Walk<T, kDir, T*> xw{x.ptr + first}, rw{r.ptr + first};
    const tri::Walk<T, kDir, unsigned> yw{y.addr + first * y.stride};
    T acc = T(0);
    for (int i0 = 0; i0 < len; i0 += U) {
      acc = tri::walk_nodes<T, kScale, U>(i0, min(U, len - i0), acc, xw, rw, yw);
    }
  }
}

// The tables of a factorization, walking the rows from their node 0:
// den_j = guard(di_j − lo_j·c'_{j−1}) (tri::guard_pivot), c'_j = up_j / den_j
// (the division), and at node j: −c'_{j−1} (0 at node 0), r_j = RN(1/den_j)
// and −m_j = −RN(lo_{j+1}·r_j) (0 at the last node). On rows walked from
// row n − 1 with lo and up swapped: the UL factorization's mirror.
template <typename T, typename X>
__device__ void form_factors(int n, tri::Col<T> lo, tri::Col<T> di, tri::Col<T> up, X zt, X rt,
                             X mt) {
  using A = tri::Arith<T>;
  T c = T(0);
  for (int j = 0; j < n; ++j) {
    const T den = tri::guard_pivot(A::sub(di[j], A::mul(lo[j], c)));
    const T r = A::rcp(den);
    zt.put(j, -c);
    rt.put(j, r);
    mt.put(j, j + 1 < n ? -A::mul(lo[j + 1], r) : T(0));
    c = tri::quotient(up[j], den);
  }
}

// The Uᵀ sweep of a run that touches neither end, on pivots it forms as it
// goes (form_factors' recursion from the run's first row, whose lower
// neighbour is exercised): y_i ← z_i·r_i and m_i ← −m_i, for the Lᵀ sweep.
template <typename T, typename X>
__device__ void pivot_walk(int len, tri::Col<T> lo, tri::Col<T> di, tri::Col<T> up,
                           tri::Col<T> y, X m) {
  using A = tri::Arith<T>;
  T c = T(0), z = T(0);
  for (int i = 0; i < len; ++i) {
    const T den = tri::guard_pivot(A::sub(di[i], A::mul(lo[i], c)));
    const T r = A::rcp(den);
    z = A::fma(-c, z, y[i]);
    y.put(i, A::mul(z, r));
    m.put(i, -A::mul(lo[i + 1], r));
    c = tri::quotient(up[i], den);
  }
}

// A contract's runs of continuation rows in an exercise set (ex: a byte a
// row), by one warp: 32 rows a ballot, each run's first and last row at its
// place in the list (runs in row order). All 32 lanes call it; lane 0
// writes the count.
__device__ void find_runs(int n, const unsigned char* ex, int* count, int2* runs) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int firsts = 0, lasts = 0;
#pragma unroll 2
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int j = c0 + lane;
    const bool in = j < n;
    const bool cont = in && ex[j] == 0;
    const bool first = cont && (j == 0 || ex[j - 1] != 0);
    const bool last = cont && (j == n - 1 || ex[j + 1] != 0);
    const unsigned bf = __ballot_sync(0xffffffffu, first);
    const unsigned bl = __ballot_sync(0xffffffffu, last);
    if (first) runs[firsts + __popc(bf & below)].x = j;
    if (last) runs[lasts + __popc(bl & below)].y = j;
    firsts += __popc(bf);
    lasts += __popc(bl);
  }
  if (lane == 0) *count = firsts;
}

// kDevice: the device route (the tables in `work`, (batch, kWorkRows, n);
// the history read where it lies), else `work` is null.
template <typename T, bool kDevice>
__global__ void __launch_bounds__(kThreads)
    theta_pde_adjoint_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                             const T* __restrict__ up, const T* __restrict__ coef,
                             const T* __restrict__ psi, const T* __restrict__ v0,
                             const T* __restrict__ hist_u,
                             const unsigned char* __restrict__ hist_m,
                             const T* __restrict__ g_out, T* __restrict__ g_grid,
                             T* __restrict__ g_coef, T* __restrict__ g_ends, T* __restrict__ work,
                             int batch, int n, int n_time, int mode, int systems) {
  using A = tri::Arith<T>;
  using Tab = std::conditional_t<kDevice, GCol<T>, tri::Col<T>>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const AdjointTile tile(n, systems, sizeof(T), kDevice);
  const int ld = tile.ld;
  const int pl = static_cast<int>(tile.plane);
  T* const base = reinterpret_cast<T*>(smem_raw);
  T* const s_lo = base + kLo * pl;
  T* const s_di = base + kDi * pl;
  T* const s_up = base + kUp * pl;
  T* const s_psi = base + kPsi * pl;
  T* const s_g = base + kG * pl;
  T* const s_gi = base + kGi * pl;
  T* const s_acc = base + kAcc * pl;  // lo, di, up, ψ: a plane each
  T* const s_coef = base + (kAdjointPlanes + (kDevice ? 0 : kAdjointTablePlanes)) * pl;
  T* const s_part = s_coef + 4 * systems;  // each thread's shares of a, b, c, w
  int* const s_nruns = reinterpret_cast<int*>(smem_raw + tile.runs);
  int2* const s_runs = reinterpret_cast<int2*>(smem_raw + tile.run_list);
  unsigned char* const s_sets = smem_raw + tile.masks;
  const unsigned sbase = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * systems;
  const int rows = min(systems, batch - b0);
  const bool howard = mode == kHoward;
  const bool clamp = mode != kEuropean;
  const int last = n_time - 1;
  // the node work: contract `mine` on threads [mine·span, (mine + 1)·span),
  // thread `first` of them on nodes first, first + span, ...
  const int span = kThreads / systems;
  const int mine = tid / span;
  const int first = tid - mine * span;
  const bool owner = mine < rows;

  // plane `plane`'s row of contract s
  constexpr int kSize = static_cast<int>(sizeof(T));
  auto col = [&](int plane, int s) {
    return tri::Col<T>{sbase + static_cast<unsigned>((plane * pl + s * ld) * kSize),
                       static_cast<unsigned>(kSize)};
  };
  // a table's row of contract s (WorkRow)
  auto table = [&](int row, int s) -> Tab {
    if constexpr (kDevice) {
      return GCol<T>{work + (static_cast<int64_t>(b0 + s) * kWorkRows + row) * n, 1};
    } else {
      return col(row == kRowPivots ? kGi : kTab + row, s);
    }
  };
  auto ring = [](int i) { return (i + kRing) % kRing; };  // step i's history row (i ≥ −1)
  auto hist_row = [&](int i, int s) {  // the solution of step i, v0 for i = −1
    return i >= 0 ? hist_u + (static_cast<int64_t>(b0 + s) * n_time + i) * n
                  : v0 + static_cast<int64_t>(b0 + s) * n;
  };
  // where the node work reads the solution of step i (v0 for i = −1)
  auto u_row = [&](int i, int s) -> const T* {
    if constexpr (kDevice) {
      return hist_row(i, s);
    } else {
      return base + (kRingPlane + ring(i)) * pl + s * ld;
    }
  };
  // the exercise set of step i's last solve, contract s; a ring row holds the
  // row's bytes at their offset within hist_m's 4-byte words
  auto set_row = [&](int i, int s) {
    return hist_m + (static_cast<int64_t>(b0 + s) * n_time + i) * n;
  };
  auto head_of = [](const unsigned char* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  };
  auto set_of = [&](int i, int s) -> const unsigned char* {
    if constexpr (kDevice) {
      return set_row(i, s);
    } else {
      return s_sets + (i % 2 * systems + s) * tile.mask_stride + head_of(set_row(i, s));
    }
  };
  // cp.async of step i's solution (v0 for i = −1) into its ring row, and of
  // step i's exercise set: the 4-byte words that lie inside the row by
  // cp.async, the bytes of a word the row only shares (its first and last)
  // one by one, so no byte outside the row is read
  auto stage_u = [&](int i) {
    if (owner) {
      T* const dst = base + (kRingPlane + ring(i)) * pl + mine * ld;
      const T* const src = hist_row(i, mine);
      for (int j = first; j < n; j += span) tri::cp_async(dst + j, src + j);
    }
  };
  auto stage_set = [&](int i) {
    if (owner) {
      const unsigned char* const row = set_row(i, mine);
      const int head = head_of(row);
      const unsigned char* const src = row - head;  // 4-byte aligned
      unsigned char* const dst = s_sets + (i % 2 * systems + mine) * tile.mask_stride;
      const int end = head + n;
      for (int w = first; w < (end + 3) / 4; w += span) {
        const int b = 4 * w;
        if (b >= head && b + 4 <= end) {
          tri::cp_async(reinterpret_cast<unsigned*>(dst) + w,
                        reinterpret_cast<const unsigned*>(src) + w);
        } else {
          for (int e = max(b, head); e < min(b + 4, end); ++e) dst[e] = src[e];
        }
      }
    }
  };

  if (owner) {
    const int64_t row = static_cast<int64_t>(b0 + mine) * n;
    for (int j = first; j < n; j += span) {
      const int t = mine * ld + j;
      s_lo[t] = lo[row + j];
      s_di[t] = di[row + j];
      s_up[t] = up[row + j];
      s_psi[t] = psi[row + j];
      s_g[t] = g_out[row + j];
      for (int q = 0; q < 4; ++q) s_acc[q * pl + t] = T(0);
    }
  }
  for (int e = tid; e < 4 * rows; e += kThreads) {
    const int q = e / rows;
    const int s = e - q * rows;
    s_coef[q * systems + s] = coef[static_cast<int64_t>(q) * batch + b0 + s];
  }
  if (!howard && tid < rows) {  // one run, the whole system
    s_nruns[tid] = 1;
    s_runs[tid * tile.max_runs] = make_int2(0, n - 1);
  }
  if constexpr (!kDevice) {
    if (n_time > 0) {
      for (int i = last; i >= max(last - 2, -1); --i) stage_u(i);
      if (howard) {
        for (int i = last; i >= max(last - 1, 0); --i) stage_set(i);
      }
      tri::cp_async_commit();
      tri::cp_async_wait_all();
    }
  }
  __syncthreads();
  const T* const s_a = s_coef;
  const T* const s_b = s_coef + systems;
  const T* const s_c = s_coef + 2 * systems;
  const T* const s_w = s_coef + 3 * systems;
  T share[4] = {T(0), T(0), T(0), T(0)};  // this thread's shares of a, b, c, w

  // the chains' jobs: job q is run q / systems of contract q % systems, on
  // warp q % kWarps, lane q / kWarps (then q + kThreads): the contracts' and
  // the runs' chains side by side on different warps
  const int job0 = tri::spread_system(kWarps);
  {  // the tables, once: the LU factorization's on job (s, 0), the UL's on (s, 1)
    const int s = job0 % systems;
    const int r = job0 / systems;
    if (s < rows && r < (howard ? 2 : 1)) {
      const tri::Col<T> l = col(kLo, s), d = col(kDi, s), u = col(kUp, s);
      const bool ul = r == 1;
      const int row = ul ? kRowUL : kRowLU;
      const int from = ul ? n - 1 : 0;
      const int dir = ul ? -1 : 1;
      form_factors(n, (ul ? u : l).walk(from, dir), d.walk(from, dir), (ul ? l : u).walk(from, dir),
                   table(row, s).walk(from, dir), table(row + 1, s).walk(from, dir),
                   table(row + 2, s).walk(from, dir));
    }
  }
  // the clamp's adjoint of the last step, and its runs
  if (n_time > 0 && clamp && owner) {
    const T* const u = u_row(last, mine);
    for (int j = first; j < n; j += span) {
      const int t = mine * ld + j;
      const T uv = u[j];
      const T pv = s_psi[t];
      const T gv = s_g[t];
      const T half = A::mul(gv, T(0.5));
      s_acc[3 * pl + t] = A::add(s_acc[3 * pl + t], uv > pv ? T(0) : (uv == pv ? half : gv));
      s_g[t] = uv < pv ? T(0) : (uv == pv ? half : gv);
    }
  }
  if (n_time > 0 && howard) {
    for (int s = warp; s < rows; s += kWarps) {
      find_runs(n, set_of(last, s), s_nruns + s, s_runs + s * tile.max_runs);
    }
  }
  __syncthreads();

  for (int k = last; k >= 0; --k) {
    // A. the adjoint solve, run by run: Uᵀ then Lᵀ
    int most = 1;
    if (howard) {
      most = 0;
      for (int s = 0; s < rows; ++s) most = max(most, s_nruns[s]);
    }
    for (int q = job0; q < systems * most; q += kThreads) {
      const int s = q % systems;
      const int r = q / systems;
      if (s >= rows || r >= s_nruns[s]) continue;
      const int2 run = s_runs[s * tile.max_runs + r];
      const int len = run.y - run.x + 1;
      const tri::Col<T> g = col(kG, s);
      if (run.x > 0 && run.y < n - 1) {  // a run that forms its own pivots
        const Tab m = table(kRowPivots, s);
        pivot_walk(len, col(kLo, s).walk(run.x, 1), col(kDi, s).walk(run.x, 1),
                   col(kUp, s).walk(run.x, 1), g.walk(run.x, 1), m.walk(run.x, 1));
        run_walk<T, false, -1>(len, run.y, m, m, g);
      } else if (run.x == 0) {  // on the LU tables, from row 0
        run_walk<T, true, 1>(len, 0, table(kRowLU, s), table(kRowLU + 1, s), g);
        run_walk<T, false, -1>(len, run.y, table(kRowLU + 2, s), table(kRowLU + 2, s), g);
      } else {  // on the UL tables, from row n − 1
        run_walk<T, true, -1>(len, n - 1, table(kRowUL, s), table(kRowUL + 1, s), g);
        run_walk<T, false, 1>(len, run.x, table(kRowUL + 2, s), table(kRowUL + 2, s), g);
      }
    }
    __syncthreads();
    // B. λ to ψ (exercised rows: their own equation), to lo, di, up, to the
    // ends, and the right-hand side's interior share to this thread's shares
    // of a, b, c, w
    if (owner) {
      const int s = mine;
      const unsigned char* const ex = howard ? set_of(k, s) : nullptr;
      const T* const u = u_row(k, s);
      const T* const vin = u_row(k - 1, s);
      const bool clamped = k > 0 && clamp;  // the step's input is the clamped solution
      for (int j = first; j < n; j += span) {
        const int t = s * ld + j;
        T lam = s_g[t];
        T gi = T(0);
        if (howard && ex[j]) {
          if (j > 0 && !ex[j - 1]) lam = A::sub(lam, A::mul(s_up[t - 1], s_g[t - 1]));
          if (j < n - 1 && !ex[j + 1]) lam = A::sub(lam, A::mul(s_lo[t + 1], s_g[t + 1]));
          s_acc[3 * pl + t] = A::add(s_acc[3 * pl + t], lam);
          lam = T(0);
        } else {
          const T ul = j > 0 ? u[j - 1] : T(0);
          const T ur = j < n - 1 ? u[j + 1] : T(0);
          s_acc[t] = A::sub(s_acc[t], A::mul(lam, ul));
          s_acc[pl + t] = A::sub(s_acc[pl + t], A::mul(lam, u[j]));
          s_acc[2 * pl + t] = A::sub(s_acc[2 * pl + t], A::mul(lam, ur));
          if (j > 0 && j < n - 1) {
            gi = lam;
            T v[3];
            for (int d = 0; d < 3; ++d) {
              v[d] = vin[j - 1 + d];
              if (clamped) v[d] = A::max(v[d], s_psi[t - 1 + d]);
            }
            const T lap = A::add(A::add(A::mul(s_a[s], v[0]), A::mul(s_b[s], v[1])),
                                 A::mul(s_c[s], v[2]));
            const T gw = A::mul(s_w[s], gi);
            share[0] = A::add(share[0], A::mul(gw, v[0]));
            share[1] = A::add(share[1], A::mul(gw, v[1]));
            share[2] = A::add(share[2], A::mul(gw, v[2]));
            share[3] = A::add(share[3], A::mul(gi, lap));
          }
        }
        if (j == 0 || j == n - 1) {
          g_ends[(static_cast<int64_t>(b0 + s) * n_time + k) * 2 + (j == 0 ? 0 : 1)] = lam;
        }
        s_gi[t] = gi;
      }
    }
    if constexpr (!kDevice) tri::cp_async_wait_all();  // step k − 1's set, k − 2's solution
    __syncthreads();
    // C. the gradient of the step's input, gi + b·w·gi + a·w·gi₊ + c·w·gi₋,
    // and the clamp's adjoint of step k − 1 on it
    if (owner) {
      const int s = mine;
      const T* const u = u_row(k - 1, s);
      const T w = s_w[s];
      for (int j = first; j < n; j += span) {
        const int t = s * ld + j;
        const T gi = s_gi[t];
        const T right = j < n - 1 ? A::mul(s_a[s], A::mul(w, s_gi[t + 1])) : T(0);
        const T left = j > 0 ? A::mul(s_c[s], A::mul(w, s_gi[t - 1])) : T(0);
        T gv = A::add(A::add(A::add(gi, A::mul(s_b[s], A::mul(w, gi))), right), left);
        if (k > 0 && clamp) {
          const T uv = u[j];
          const T pv = s_psi[t];
          const T half = A::mul(gv, T(0.5));
          s_acc[3 * pl + t] = A::add(s_acc[3 * pl + t], uv > pv ? T(0) : (uv == pv ? half : gv));
          gv = uv < pv ? T(0) : (uv == pv ? half : gv);
        }
        s_g[t] = gv;
      }
    }
    if constexpr (!kDevice) {  // into the rows step k's phases B and C no longer read
      if (k >= 2) stage_u(k - 3);
      if (howard && k >= 2) stage_set(k - 2);
      tri::cp_async_commit();
    }
    if (howard && k > 0) {
      for (int s = warp; s < rows; s += kWarps) {
        find_runs(n, set_of(k - 1, s), s_nruns + s, s_runs + s * tile.max_runs);
      }
    }
    __syncthreads();
  }
  for (int q = 0; q < 4; ++q) s_part[q * kThreads + tid] = share[q];
  if (owner) {
    const int64_t row = static_cast<int64_t>(b0 + mine) * n;
    const int64_t bn = static_cast<int64_t>(batch) * n;
    for (int j = first; j < n; j += span) {
      const int t = mine * ld + j;
      for (int q = 0; q < 4; ++q) g_grid[q * bn + row + j] = s_acc[q * pl + t];
      g_grid[4 * bn + row + j] = s_g[t];
    }
  }
  __syncthreads();
  // a, b, c, w: each contract's threads' shares summed in thread order
  if (tid < 4 * rows) {
    const int q = tid / rows;
    const int s = tid - q * rows;
    const T* const part = s_part + q * kThreads + s * span;
    T sum = T(0);
    for (int i = 0; i < span; ++i) sum = A::add(sum, part[i]);
    g_coef[static_cast<int64_t>(q) * batch + b0 + s] = sum;
  }
}

template <typename T, bool kDevice>
cudaError_t launch_adjoint_route(const void* lo, const void* di, const void* up,
                                 const void* coef, const void* psi, const void* v0,
                                 const void* hist_u, const void* hist_m, const void* g_out,
                                 void* g_grid, void* g_coef, void* g_ends, void* work, int batch,
                                 int n, int n_time, int mode, int systems, cudaStream_t st) {
  const AdjointTile tile(n, systems, sizeof(T), kDevice);
  if (tile.bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      tri::allow_smem(theta_pde_adjoint_kernel<T, kDevice>, static_cast<int>(tile.bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + systems - 1) / systems;
  theta_pde_adjoint_kernel<T, kDevice><<<blocks, kThreads, static_cast<size_t>(tile.bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(coef), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<const T*>(hist_u), static_cast<const unsigned char*>(hist_m),
      static_cast<const T*>(g_out), static_cast<T*>(g_grid), static_cast<T*>(g_coef),
      static_cast<T*>(g_ends), static_cast<T*>(work), batch, n, n_time, mode, systems);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_adjoint(const void* lo, const void* di, const void* up, const void* coef,
                           const void* psi, const void* v0, const void* hist_u,
                           const void* hist_m, const void* g_out, void* g_grid, void* g_coef,
                           void* g_ends, void* work, int batch, int n, int n_time, int mode,
                           int systems, cudaStream_t st) {
  return work != nullptr
             ? launch_adjoint_route<T, true>(lo, di, up, coef, psi, v0, hist_u, hist_m, g_out,
                                             g_grid, g_coef, g_ends, work, batch, n, n_time,
                                             mode, systems, st)
             : launch_adjoint_route<T, false>(lo, di, up, coef, psi, v0, hist_u, hist_m, g_out,
                                              g_grid, g_coef, g_ends, work, batch, n, n_time,
                                              mode, systems, st);
}


// ---------------------------------------------------------------------------
// The loop with a jump table (theta_jump_kernel): the cash-dividend PDE
//
// Replaces optionslab_tpu/models/dividends.py:137 (the lax.scan of
// _fdm_div_single, its jump condition jnp.interp at the ex-date steps): the
// θ-scheme step of theta_pde_kernel, European, projected or Howard, for one
// contract on one grid, and after a few steps a jump table (a cash
// dividend's drop of the spot), clamped again in the American modes. It
// takes no gradient and keeps no history.
//
// What bounds it. One contract's chain: each step solves one system of n
// (401 at the defaults) unknowns once, or once a Howard sweep; a later sweep
// solves a matrix whose exercised rows changed.
//
// What the design does about it: one warp a contract, its system split over
// the 32 lanes by warp_tridiag.cuh (a solve's chain ≈ 2⌈n/32⌉ nodes and seven
// shuffle stages):
// - the unexercised matrix's factors are formed once a launch; a European,
//   projection or first Howard solve is the right-hand side's pass alone;
// - a lane's rows, v, the right-hand side, ψ and (K > 0) the factors the
//   next solve takes live in its registers from the first step to the last;
//   the explicit step and Howard's residual take their two neighbours by
//   shuffles;
// - a later Howard sweep re-forms, in those registers, the factors of the
//   blocks that hold a changed exercise row (the others keep theirs), then
//   the reduced system's; the unexercised matrix's factors are kept in
//   shared memory and loaded again after a step that swept; a step stops
//   sweeping at its fixed point (no lane's set changed: one vote), which
//   leaves the 8-sweep loop's values bit for bit;
// - an ex-date step puts v in shared memory and each lane gathers its rows
//   from the jump table (models/slv.py _interp's f0 + w·(f1 − f0));
// - contracts of a book are warps of a block, each on its own: no barrier.
// Grids too long for the registers (K = 0) keep the rows and both factor
// sets in a device-memory workspace, the same code on memory.
//
// Bit for bit with the plain loop with its jump table (ops/theta_pde.py
// _theta_plain with jumps, which solves by ops/tridiag.py warp_solve).
constexpr int kJumpWarps = 4;  // contracts a CUDA block, a warp each

// Values of a warp's area, its planes of `rows` rows (K where the rows are
// in registers, else m): the
// unexercised a, b, c and the jump's gather row (four planes), the
// unexercised matrix's factors; with the rows in memory (K = 0) also v, the
// right-hand side, ψ and the exercise set (0 or 1) and the current factors.
__host__ __device__ constexpr int64_t jump_area(int rows, bool regs) {
  return (regs ? 4 : 8) * static_cast<int64_t>(rows) * wtri::kLanes +
         (regs ? 1 : 2) * static_cast<int64_t>(wtri::factor_values(rows));
}

template <typename T, int K>
__global__ void __launch_bounds__(kJumpWarps * 32)
    theta_jump_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                      const T* __restrict__ up, const T* __restrict__ coef,
                      const T* __restrict__ psi, const T* __restrict__ v0,
                      const T* __restrict__ ends, T* __restrict__ out, int* __restrict__ counts,
                      const int* __restrict__ jump_at, const int* __restrict__ jump_index,
                      const T* __restrict__ jump_weight, T* __restrict__ work, int n_jumps,
                      int batch, int n, int n_time, int mode) {
  using A = tri::Arith<T>;
  using Rows = std::conditional_t<(K > 0), wtri::Regs<T, K>, wtri::Mem<T>>;
  using Cur = std::conditional_t<(K > 0), wtri::RegFactors<T, K>, wtri::MemFactors<T>>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // each warp on its own: the block has no barrier
  const int m = wtri::rows_per_lane(n);
  const int rows = K > 0 ? K : m;  // a plane's rows
  const int plane = rows * wtri::kLanes;
  const int64_t area_values = jump_area(rows, K > 0);
  T* area;
  if constexpr (K > 0) {
    area = reinterpret_cast<T*>(smem_raw) + warp * area_values;
  } else {
    area = work + b * area_values;
  }
  const wtri::Mem<T> sa{area + lane}, sb{area + plane + lane}, sc{area + 2 * plane + lane};
  T* const gather = area + 3 * plane;  // the jump's row: node g at [g]
  // the unexercised matrix's factors, kept; `cur` the factors the next solve
  // takes (Howard's later sweeps re-form their changed blocks there)
  wtri::MemFactors<T> keep = wtri::mem_factors(area + 4 * plane, rows);
  Rows v{}, d{}, ps{};
  Cur cur{};
  unsigned bits = 0;    // the exercise set, K > 0: bit i for row i
  wtri::Mem<T> mask{};  // K = 0: a plane of 0 and 1
  if constexpr (K == 0) {
    T* rest = area + 4 * plane + wtri::factor_values(rows);
    v = Rows{rest + lane};
    d = Rows{rest + plane + lane};
    ps = Rows{rest + 2 * plane + lane};
    mask = wtri::Mem<T>{rest + 3 * plane + lane};
    cur = wtri::mem_factors(rest + 4 * plane, rows);
  }
  const auto ex_get = [&](int i) -> bool {
    if constexpr (K > 0) {
      return (bits >> i) & 1u;
    } else {
      return mask.get(i) != T(0);
    }
  };
  const auto ex_set = [&](int i, bool x) {
    if constexpr (K > 0) {
      bits = x ? bits | (1u << i) : bits & ~(1u << i);
    } else {
      mask.set(i, x ? T(1) : T(0));
    }
  };

  // the lane's rows (padding past n, and the rows past m where K > m: a = c
  // = 0, b = 1, ψ = v = 0; a_0 and c_{n−1} taken as 0), the unexercised
  // matrix's factors
  const int g0 = lane * m;
  const int64_t row0 = static_cast<int64_t>(b) * n;
  wtri::rows_up<K>(0, rows, [&](int i) {
    const int g = g0 + i;
    const bool in = i < m && g < n;
    sa.set(i, in && g > 0 ? lo[row0 + g] : T(0));
    sb.set(i, in ? di[row0 + g] : T(1));
    sc.set(i, in && g < n - 1 ? up[row0 + g] : T(0));
    ps.set(i, in ? psi[row0 + g] : T(0));
    v.set(i, in ? v0[row0 + g] : T(0));
  });
  const T ca = coef[b], cb = coef[batch + b], cc = coef[2 * batch + b], w = coef[3 * batch + b];
  const wtri::Edge<T> base_edge = wtri::form_local<K, T>(
      m, [&](int i) { return sa.get(i); }, [&](int i) { return sb.get(i); },
      [&](int i) { return sc.get(i); }, cur);
  wtri::form_reduced(base_edge, cur);
  wtri::copy_factors<K, T>(m, cur, keep);
  wtri::Edge<T> cur_edge = base_edge;
  bool swept = false;  // a later Howard sweep changed `cur` this step

  const int64_t e_row = static_cast<int64_t>(b) * n_time * 2;
  T e0 = T(0), e1 = T(0);
  int jump_next = -1;
  if (n_time > 0) {
    e0 = ends[e_row];
    e1 = ends[e_row + 1];
    if (jump_at != nullptr) jump_next = jump_at[0];
  }
  const int sweeps = mode == kHoward ? kHowardSweeps : 1;
  int solves = 0, reformed = 0;
  for (int k = 0; k < n_time; ++k) {
    const T end0 = e0, end1 = e1;
    const int jump = jump_next;
    if (k + 1 < n_time) {  // the next step's end values and jump, off the chain
      e0 = ends[e_row + 2 * (k + 1)];
      e1 = ends[e_row + 2 * (k + 1) + 1];
      if (jump_at != nullptr) jump_next = jump_at[k + 1];
    }
    // the explicit step: v + w·((a·v₋ + b·v) + c·v₊), the ends from the table
    {
      const T v_left = __shfl_up_sync(wtri::kFull, wtri::last_row<K, T>(m, v), 1);
      const T v_right = __shfl_down_sync(wtri::kFull, v.get(0), 1);
      T prev = v_left;
      wtri::rows_up<K>(0, rows, [&](int i) {  // with K > 0 no branch: selections
        const int g = g0 + i;
        const T vc = v.get(i);
        const T vn = i + 1 < m ? v.get(i + 1) : v_right;
        const T r = A::add(vc, A::mul(w, A::add(A::add(A::mul(ca, prev), A::mul(cb, vc)),
                                                 A::mul(cc, vn))));
        d.set(i, g == 0 ? end0 : (g == n - 1 ? end1 : (i < m && g < n ? r : T(0))));
        prev = vc;
      });
    }
    // the unexercised matrix: its factors
    if (swept) {
      wtri::copy_factors<K, T>(m, keep, cur);
      cur_edge = base_edge;
      swept = false;
    }
    wtri::solve<K, T>(m, cur, [&](int i) { return d.get(i); }, v);
    ++solves;
    if (mode == kHoward) wtri::rows_up<K>(0, m, [&](int i) { ex_set(i, false); });
    for (int sweep = 1; sweep < sweeps; ++sweep) {
      // Howard: the rows where exercising beats continuing,
      // ((lo·v₋ + di·v) + up·v₊) − rhs > v − ψ, on the interior
      const T v_left = __shfl_up_sync(wtri::kFull, wtri::last_row<K, T>(m, v), 1);
      const T v_right = __shfl_down_sync(wtri::kFull, v.get(0), 1);
      bool changed = false;
      T prev = v_left;
      wtri::rows_up<K>(0, rows, [&](int i) {  // with K > 0 no branch: selections
        const int g = g0 + i;
        const T vc = v.get(i);
        const T vn = i + 1 < m ? v.get(i + 1) : v_right;
        const T res = A::sub(A::add(A::add(A::mul(sa.get(i), prev), A::mul(sb.get(i), vc)),
                                    A::mul(sc.get(i), vn)),
                             d.get(i));
        const bool ex = i < m && g > 0 && g < n - 1 && res > A::sub(vc, ps.get(i));
        changed |= ex != ex_get(i);
        ex_set(i, ex);
        prev = vc;
      });
      if (!__any_sync(wtri::kFull, changed)) break;  // a fixed point: the rest repeat this solve
      // the factors of the blocks whose rows changed (exercised rows u = ψ;
      // the others keep theirs), then the reduced system's
      if (changed) {
        cur_edge = wtri::form_local<K, T>(
            m, [&](int i) { return ex_get(i) ? T(0) : sa.get(i); },
            [&](int i) { return ex_get(i) ? T(1) : sb.get(i); },
            [&](int i) { return ex_get(i) ? T(0) : sc.get(i); }, cur);
        reformed += m - 1;
      }
      wtri::form_reduced(cur_edge, cur);
      wtri::solve<K, T>(m, cur, [&](int i) { return ex_get(i) ? ps.get(i) : d.get(i); }, v);
      swept = true;
      ++solves;
    }
    if (mode != kEuropean) {
      wtri::rows_up<K>(0, m, [&](int i) { v.set(i, A::max(v.get(i), ps.get(i))); });
    }
    // a jump: each node from the table (models/slv.py _interp's
    // f0 + ((x − x0)/dx)·(f1 − f0), the quotient the table's weight) on the
    // values after the step's clamp; then clamped again in the American modes
    if (jump >= 0) {
      wtri::rows_up<K>(0, m, [&](int i) {
        if (g0 + i < n) gather[g0 + i] = v.get(i);
      });
      __syncwarp();
      wtri::rows_up<K>(0, m, [&](int i) {
        const int g = g0 + i;
        if (g < n) {
          const int64_t t = (static_cast<int64_t>(b) * n_jumps + jump) * n + g;
          const int code = jump_index[t];
          T f;
          if (code >= 0) {
            const T f0 = gather[code];
            f = A::add(f0, A::mul(jump_weight[t], A::sub(gather[code + 1], f0)));
          } else {
            f = gather[-1 - code];
          }
          v.set(i, mode != kEuropean ? A::max(f, ps.get(i)) : f);
        }
      });
      __syncwarp();
    }
  }
  wtri::rows_up<K>(0, m, [&](int i) {
    if (g0 + i < n) out[row0 + g0 + i] = v.get(i);
  });
  reformed = __reduce_add_sync(wtri::kFull, reformed);
  if (lane == 0) {
    counts[b] = solves;
    counts[batch + b] = reformed;
  }
}

template <typename T, int K>
cudaError_t launch_jump_rows(const void* lo, const void* di, const void* up, const void* coef,
                             const void* psi, const void* v0, const void* ends, void* out,
                             int* counts, const int* jump_at, const int* jump_index,
                             const void* jump_weight, void* work, int n_jumps, int batch, int n,
                             int n_time, int mode, int warps, cudaStream_t st) {
  const int64_t bytes =
      K > 0 ? warps * jump_area(K, true) * static_cast<int64_t>(sizeof(T)) : 0;
  if (bytes > tri::kMaxSmem || (K == 0 && work == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(theta_jump_kernel<T, K>, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + warps - 1) / warps;
  theta_jump_kernel<T, K><<<blocks, warps * 32, static_cast<size_t>(bytes), st>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(coef), static_cast<const T*>(psi), static_cast<const T*>(v0),
      static_cast<const T*>(ends), static_cast<T*>(out), counts, jump_at, jump_index,
      static_cast<const T*>(jump_weight), static_cast<T*>(work), n_jumps, batch, n, n_time, mode);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_jump(const void* lo, const void* di, const void* up, const void* coef,
                        const void* psi, const void* v0, const void* ends, void* out, int* counts,
                        const int* jump_at, const int* jump_index, const void* jump_weight,
                        void* work, int n_jumps, int batch, int n, int n_time, int mode,
                        int warps, cudaStream_t st) {
  switch (wtri::register_rows(n, sizeof(T))) {
    case 8:
      return launch_jump_rows<T, 8>(lo, di, up, coef, psi, v0, ends, out, counts, jump_at,
                                    jump_index, jump_weight, work, n_jumps, batch, n, n_time,
                                    mode, warps, st);
    case 16:
      if constexpr (sizeof(T) == 4) {
        return launch_jump_rows<T, 16>(lo, di, up, coef, psi, v0, ends, out, counts, jump_at,
                                       jump_index, jump_weight, work, n_jumps, batch, n, n_time,
                                       mode, warps, st);
      }
      return cudaErrorInvalidValue;
    default:
      return launch_jump_rows<T, 0>(lo, di, up, coef, psi, v0, ends, out, counts, jump_at,
                                    jump_index, jump_weight, work, n_jumps, batch, n, n_time,
                                    mode, warps, st);
  }
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
// only in Howard mode. Returns a cudaError_t code (0 on success).
extern "C" int theta_pde_launch(const void* lo, const void* di, const void* up,
                                const void* coef, const void* psi, const void* v0,
                                const void* ends, void* out, void* counts, void* hist_u,
                                void* hist_m, int batch, int n, int n_time, int mode,
                                int systems, int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kEuropean || mode > kHoward || systems < 1 ||
      systems > tri::kPair || (dtype != 0 && dtype != 1) ||
      (hist_u != nullptr && mode == kHoward && hist_m == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(counts);
  err = dtype == 0 ? launch<float>(lo, di, up, coef, psi, v0, ends, out, s, hist_u, hist_m, batch,
                                   n, n_time, mode, systems, st)
                   : launch<double>(lo, di, up, coef, psi, v0, ends, out, s, hist_u, hist_m,
                                    batch, n, n_time, mode, systems, st);
  return static_cast<int>(err);
}

extern "C" int theta_pde_adjoint_launch(const void* lo, const void* di, const void* up,
                                        const void* coef, const void* psi, const void* v0,
                                        const void* hist_u, const void* hist_m, const void* g,
                                        void* g_grid, void* g_coef, void* g_ends, void* work,
                                        int batch, int n, int n_time, int mode, int systems,
                                        int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kEuropean || mode > kHoward || systems < 1 ||
      systems > tri::kPair || (systems & (systems - 1)) != 0 || (dtype != 0 && dtype != 1) ||
      (mode == kHoward && hist_m == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_adjoint<float>(lo, di, up, coef, psi, v0, hist_u, hist_m, g, g_grid, g_coef,
                                    g_ends, work, batch, n, n_time, mode, systems, st)
            : launch_adjoint<double>(lo, di, up, coef, psi, v0, hist_u, hist_m, g, g_grid,
                                     g_coef, g_ends, work, batch, n, n_time, mode, systems, st);
  return static_cast<int>(err);
}

// The loop with a jump table: lo, di, up, psi, v0, coef, ends, out as
// theta_pde_launch's; mode 0 European, 1 projection, 2 Howard. counts: (2,
// batch) ints, the solves each contract ran, then the rows whose factors its
// later Howard sweeps re-formed. jump_at (n_time ints, may be null: no jump)
// the jump after each step (−1 none); jump_index (int) and jump_weight
// (batch, n_jumps, n) its gather table (see Jumps in ops/theta_pde.py).
// work: null where the rows fit in registers (ops/tridiag.py
// warp_capacity), else (batch, jump_area) values of device memory. warps:
// contracts a CUDA block, 1 to 4. Returns a cudaError_t code (0 on success).
extern "C" int theta_jump_launch(const void* lo, const void* di, const void* up,
                                 const void* coef, const void* psi, const void* v0,
                                 const void* ends, void* out, void* counts, const void* jump_at,
                                 const void* jump_index, const void* jump_weight, void* work,
                                 int n_jumps, int batch, int n, int n_time, int mode, int warps,
                                 int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 3 || n_time < 0 || mode < kEuropean || mode > kHoward || warps < 1 ||
      warps > kJumpWarps || (dtype != 0 && dtype != 1) ||
      (jump_at != nullptr && (n_jumps < 1 || jump_index == nullptr || jump_weight == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* s = static_cast<int*>(counts);
  const int* at = static_cast<const int*>(jump_at);
  const int* idx = static_cast<const int*>(jump_index);
  err = dtype == 0 ? launch_jump<float>(lo, di, up, coef, psi, v0, ends, out, s, at, idx,
                                        jump_weight, work, n_jumps, batch, n, n_time, mode, warps,
                                        st)
                   : launch_jump<double>(lo, di, up, coef, psi, v0, ends, out, s, at, idx,
                                         jump_weight, work, n_jumps, batch, n, n_time, mode,
                                         warps, st);
  return static_cast<int>(err);
}
