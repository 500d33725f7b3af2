// Batched tridiagonal solve (the Thomas algorithm), each system staged in
// shared memory.
//
// Replaces optionslab_tpu/ops/tridiag.py:15 tridiag_solve, a lax.scan that
// XLA compiles into one loop on the device (no Pallas kernel). Every PDE of
// the port that steps on the host runs on it: the Howard sweeps of the
// dividend PDE, the local-vol PDEs, the Heston and SLV ADI sweeps, and the
// reverse pass of the θ-scheme time loop (theta_pde.cu solves through the
// same functions, tridiag.cuh).
//
// Beside the solve: the chain probes that time a node of the PDE kernels'
// chains (the pivots' here, the right-hand side's on tables formed once in
// tridiag_rhs_chain_kernel, the θ-scheme reverse's FMA sweeps in
// tridiag_fma_chain_kernel, the warp-partitioned solve's nodes and shuffle
// stages in tridiag_warp_probe_kernel) and the division check that holds
// the fast quotient of tridiag.cuh to the division intrinsic.
//
// What bounds it. A system of n unknowns is a chain of n dependent pivots
// (den_j = b_j − a_j·c'_{j−1}, c'_j = c_j / den_j, each precise quotient a
// multi-instruction sequence) and then n back-substitution nodes; the
// right-hand side's quotients d'_j form a second chain of the same length
// that can run beside the first. The chain probe below times a pivot and a
// back node at ≈85 cycles in float32 (≈165 in float64). The bytes (each
// input read once, the solution written once) are a few hundred kilobytes,
// ≈100× less time. So the least time is one system's chain, and the design
// keeps everything else off it:
// - one warp per CUDA block owns a tile of `systems` systems (a power of
//   two up to 16, picked by the wrapper so that a batch of ~100–256 systems
//   spreads over as many SMs); lane s runs system s's pivots and lane
//   s + 16 its right-hand side a node behind (tri::forward_split), so a
//   node's two quotients, one after the other in the plain loop, overlap;
// - the warp stages node-chunks of all four operands into shared memory by
//   cp.async copies of 4 or 8 bytes, neighbouring lanes on neighbouring
//   addresses along whichever axis of the operand has stride 1 (TMA does
//   not fit: a 2-D tensor map needs global strides that are multiples of
//   16 bytes, and a 201-node float32 row is 804); kStages chunks are in
//   flight (commit_group / wait_group) while the chain runs on an earlier
//   one;
// - an operand with batch stride 0 (the ADI column sweep's shared
//   coefficient row) is staged once per block, not once per system; each
//   operand is read through its own strides, so a transposed right-hand
//   side needs no copy;
// - c' and d' stay in shared memory (over the staged upper diagonal and
//   right-hand side where those are per-system), so the back substitution
//   reads no global memory, and the solution goes out through shared
//   memory in coalesced stores;
// - the chain takes no branch but the quotient's own: the ends of a system
//   fall on padding rows, the pivot's guard is taken only where a warp vote
//   finds a pivot below 1e-30, and a zero numerator skips the quotient's
//   slow path (tri::quotient).
#include <cuda_runtime.h>

#include <cstdint>

#include "tridiag.cuh"

namespace optionslab {
namespace {

// An operand: base pointer and its strides, in elements, along the batch
// axis and the system axis.
struct Operand {
  const void* ptr;
  int64_t sb;
  int64_t se;
};

constexpr int kWarp = 32;
// Nodes per staged chunk, and the chunks in flight ahead of the chain.
constexpr int kChunk = 32;
constexpr int kStages = 2;

// The shared-memory tile of one block: a plane per operand, node-major
// (node j of system s at [j * pitch + s], a broadcast operand's one row at
// [j]), each with tri::kPad rows of padding at both ends, then c' and d'
// where they cannot take the upper diagonal's and the right-hand side's
// planes, then the dump slots (tri::kDumpBytes). Host and device carve it
// alike.
struct Tile {
  int pitch;         // systems | 1: an odd pitch, so a node-major copy has no bank conflict
  int64_t node0[6];  // element offsets of node 0: lower, diag, upper, rhs, c', d'
  int step[4];       // row pitch of each operand (1 for a broadcast row)
  int64_t elements;  // the planes, before the dump slots

  __host__ __device__ Tile(const Operand* ops, int n, int systems) {
    pitch = systems | 1;
    const int64_t rows = n + 2 * tri::kPad;
    int64_t at = 0;
    for (int o = 0; o < 4; ++o) {
      step[o] = ops[o].sb == 0 ? 1 : pitch;
      node0[o] = at + tri::kPad * step[o];
      at += rows * step[o];
    }
    for (int o = 4; o < 6; ++o) {
      if (step[o - 2] == pitch) {
        node0[o] = node0[o - 2];
      } else {
        node0[o] = at + tri::kPad * pitch;
        at += rows * pitch;
      }
    }
    elements = at;
  }
};

// Copies nodes [j0, j0 + len) (len ≤ kChunk = the warp's width) of `rows`
// systems from global memory (system s at g + s·sb + j·se) into the tile
// (at t + j·step + s), neighbouring lanes on neighbouring global addresses:
// a lane a node, system after system, or a lane a system, node after node,
// where the batch axis is the one of stride 1.
template <typename T>
__device__ __forceinline__ void stage(const T* g, int64_t sb, int64_t se, T* t, int step,
                                      int rows, int j0, int len, int lane) {
  if (se != 1 && sb == 1) {
    if (lane < rows) {
      for (int j = j0; j < j0 + len; ++j) tri::cp_async(t + j * step + lane, g + lane + j * se);
    }
  } else if (lane < len) {
    const int j = j0 + lane;
    for (int s = 0; s < rows; ++s) tri::cp_async(t + j * step + s, g + s * sb + j * se);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarp) tridiag_kernel(Operand lo, Operand di, Operand up,
                                                        Operand rhs, T* __restrict__ x,
                                                        int64_t xsb, int64_t xse, int batch,
                                                        int n, int systems) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Operand ops[4] = {lo, di, up, rhs};
  const Tile tile(ops, n, systems);
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * systems;
  const int rows = min(systems, batch - b0);
  const T* base[4];
  for (int o = 0; o < 4; ++o) {
    base[o] = static_cast<const T*>(ops[o].ptr) + b0 * ops[o].sb;
  }

  const int n_chunks = (n + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int k) {
    if (k < n_chunks) {
      const int j0 = k * kChunk;
      const int len = min(kChunk, n - j0);
      for (int o = 0; o < 4; ++o) {
        stage(base[o], ops[o].sb, ops[o].se, smem + tile.node0[o], tile.step[o],
              ops[o].sb == 0 ? 1 : rows, j0, len, lane);
      }
    }
    tri::cp_async_commit();  // an empty group past the end keeps the count
  };
  for (int k = 0; k < kStages; ++k) stage_chunk(k);
  for (int o = 0; o < 4; ++o) {  // the padding, seen after the first wait's __syncwarp
    T* node0 = smem + tile.node0[o];
    const int width = tri::kPad * tile.step[o];
    for (int e = lane; e < width; e += kWarp) {
      node0[e - width] = tri::pad_value<T>(o, false);
      node0[n * tile.step[o] + e] = tri::pad_value<T>(o, true);
    }
  }

  // this lane's system (pivot lanes and partners); a lane without one reads
  // system 0's column and writes to its dump slot
  const bool live = lane % tri::kPair < rows;
  const int sys = live ? lane % tri::kPair : 0;
  tri::Row<T> row;
  for (int o = 0; o < 4; ++o) {
    row.col[o] = tri::col<T>(smem + tile.node0[o], tile.step[o] == 1 ? 0 : sys, tile.step[o]);
  }
  const tri::Col<T> cs = tri::col<T>(smem + tile.node0[4], sys, tile.pitch);
  const tri::Col<T> ds = tri::col<T>(smem + tile.node0[5], sys, tile.pitch);
  const tri::Col<T> quotients =
      live ? (lane < tri::kPair ? cs : ds) : tri::dump_col<T>(smem + tile.elements);
  T x_last = T(0);
  T den = T(1);
  for (int k = 0; k < n_chunks; ++k) {
    stage_chunk(k + kStages);
    tri::cp_async_wait<kStages>();  // chunk k has landed (this lane's copies)
    __syncwarp();              // and every lane's
    // the partners' last node a step after the pivots'
    const int j1 = k + 1 == n_chunks ? n + 1 : (k + 1) * kChunk;
    tri::forward_split(k * kChunk, j1, row, quotients, x_last, den);
  }
  __syncwarp();
  if (lane < tri::kPair && live) tri::back_sweep(n, cs, ds, ds);  // the solution over d'
  __syncwarp();

  const T* xs = smem + tile.node0[5];
  T* x0 = x + b0 * xsb;
  if (xse != 1 && xsb == 1) {
    if (lane < rows) {
      for (int j = 0; j < n; ++j) x0[lane + j * xse] = xs[j * tile.pitch + lane];
    }
  } else {
    for (int s = 0; s < rows; ++s) {
      for (int j = lane; j < n; j += kWarp) x0[s * xsb + j * xse] = xs[j * tile.pitch + s];
    }
  }
}

// The dependent chain alone, for the solve's latency bound: one thread runs
// n_nodes pivots (den_j = b − a·c'_{j−1}, c'_j = c / den_j, the guard only
// where a pivot needs it, as in forward_split) and n_nodes back nodes of the
// solve's own arithmetic on operands held in registers, with no memory
// access inside either loop. The right-hand side's quotients form a chain
// of the same length beside the pivots' (forward_split runs the two at
// once), so its time over n_nodes is the least a node of one system can
// cost on the card however fast the memory is (each precise quotient is a
// multi-instruction sequence, so a flat count per operation would
// undercount it).
template <typename T>
__global__ void tridiag_chain_kernel(const T* __restrict__ abcd, T* __restrict__ out,
                                     int n_nodes) {
  using A = tri::Arith<T>;
  const T a = abcd[0], b = abcd[1], c = abcd[2], d = abcd[3];
  T c_prev = T(0);
  for (int i = 0; i < n_nodes; ++i) {
    const T den = A::sub(b, A::mul(a, c_prev));
    c_prev = A::quo(c, den);
    if (A::mag(den) < A::kTiny) c_prev = A::quo(c, tri::guard_pivot(den));
  }
  T x = T(0);
  for (int i = 0; i < n_nodes; ++i) x = tri::back_node(c_prev, d, x);
  out[0] = x;
}

// The right-hand side's chain alone, for the bound of a solve on tables
// formed once (rhs_chain: theta_pde.cu, heston_adi.cu): a lane runs
// n_nodes nodes of d'_j = (d − a·d'_{j−1}) / den on the table's reciprocal
// (tri::rhs_group in the solve's groups, its range check and vote
// included; n_nodes a multiple of 16) and n_back back nodes, operands in
// registers. Its time over n_nodes = n_back is a node's least cost on a
// matrix whose pivots are formed once, as the pivot probe's is on one whose
// pivots are not; with n_nodes = 0 it times the back node alone, the cost
// of a row that a restarted Howard sweep only substitutes back. One warp,
// every lane on the same operands (the group's vote needs the warp whole);
// lane 0 writes.
template <typename T>
__global__ void tridiag_rhs_chain_kernel(const T* __restrict__ abcd, T* __restrict__ out,
                                         int n_nodes, int n_back) {
  constexpr int kGroup = tri::kRhsGroup<T>;
  const T a = abcd[0], b = abcd[1], c = abcd[2], d = abcd[3];
  T ra[kGroup], rd[kGroup], rb[kGroup], ry[kGroup], rq[kGroup];
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    ra[q] = a;
    rd[q] = d;
    rb[q] = b;
    ry[q] = tri::table_rcp(b, false);
  }
  T prev = T(0);
  for (int i = 0; i < n_nodes; i += kGroup) {
    prev = tri::rhs_group<T, kGroup>(ra, rd, rb, ry, prev, rq);
  }
  T x = T(0);
  for (int i = 0; i < n_back; ++i) x = tri::back_node(c, prev, x);
  if (threadIdx.x == 0) out[0] = x;
}

// The FMA chain alone, for the bound of theta_pde.cu's reverse sweeps: one
// thread runs n_nodes nodes of acc = fma(m, acc, d), m and d of each node
// read from shared memory and each node's value stored back, as a lane of
// the reverse runs a node of its Lᵀ sweep (its Uᵀ sweep adds a product off
// the chain). Two schedules of the loads: kAhead false, the reverse's own
// walk (tri::vec_walk) over a row of kFmaRow nodes again and again, each
// pass a chain from 0 on the values the pass before stored, each group's
// operands by 16-byte vectors just before its chain (m = −a·2⁻²⁰, exact:
// the passes compound, and so small an m keeps the row within 1 ± 2⁻⁸ over
// 4,096 passes, where m = −a would overflow it); kAhead true, one chain
// in groups of tri::kWalk<T> nodes on two groups' rows, the next group's
// scalar loads issued while a group's chain runs. The faster one's time over
// n_nodes is the least a node of those sweeps costs on the card. n_nodes a
// multiple of kFmaRow.
constexpr int kFmaRow = 32;

template <typename T, bool kAhead>
__global__ void tridiag_fma_chain_kernel(const T* __restrict__ abcd, T* __restrict__ out,
                                         int n_nodes) {
  using A = tri::Arith<T>;
  constexpr int U = tri::kWalk<T>;
  static_assert(kFmaRow % (2 * U) == 0, "a row holds two groups");
  __shared__ __align__(16) T s_m[kFmaRow];
  __shared__ __align__(16) T s_d[kFmaRow];
  __shared__ __align__(16) T s_y[kFmaRow];
  for (int q = 0; q < kFmaRow; ++q) {
    s_m[q] = kAhead ? -abcd[0] : -abcd[0] * T(0x1p-20);
    s_d[q] = abcd[3];
    s_y[q] = abcd[3];
  }
  const tri::Col<T> m = tri::col<T>(s_m, 0, 1);
  const tri::Col<T> d = tri::col<T>(s_d, 0, 1);
  const tri::Col<T> y = tri::col<T>(s_y, 0, 1);
  T acc = T(0);
  if constexpr (kAhead) {
    T m0[U], d0[U], m1[U], d1[U];
    auto load = [&](T (&rm)[U], T (&rd)[U], int at) {
#pragma unroll
      for (int q = 0; q < U; ++q) {
        rm[q] = m[at + q];
        rd[q] = d[at + q];
      }
    };
    load(m0, d0, 0);
    for (int i = 0; i < n_nodes; i += 2 * U) {
      load(m1, d1, U);
#pragma unroll
      for (int q = 0; q < U; ++q) {
        acc = A::fma(m0[q], acc, d0[q]);
        y.put(q, acc);
      }
      load(m0, d0, 0);
#pragma unroll
      for (int q = 0; q < U; ++q) {
        acc = A::fma(m1[q], acc, d1[q]);
        y.put(U + q, acc);
      }
    }
  } else {
    for (int i = 0; i < n_nodes; i += kFmaRow) {
      acc = tri::vec_walk<T, false, 1>(kFmaRow, 0, m.addr, m.addr, y.addr);
    }
  }
  out[0] = acc;
}

// The warp-partitioned solve's probes (warp_tridiag.cuh), one warp, each
// lane a chain of n_nodes dependent steps on values in registers:
// kind 0, a node of the right-hand side's pass, e ← q − ℓ·e (a product and a
// difference; q = d·ρ, ℓ = a·ρ, ρ = 1/b);
// kind 1, a stage of its cyclic reduction, D ← (D − D⁻·k1) − D⁺·k2 at the
// strides 1, 2, 4, 8, 16 in turn (two shuffles, two products, two
// differences; k1 = k2 = a − a, zeros the compiler cannot see, from
// D = d + lane);
// kind 2, a stage of the reduced system's factors, k1 = A/B⁻, k2 = C/B⁺,
// A ← −(A⁻·k1), B ← (B − C⁻·k1) − A⁺·k2, C ← −(C⁺·k2) (six shuffles, two
// quotients by tri::quotient as the kernels take them; from A = a, B = b,
// C = c).
// Lane 0's last value goes to out[0].
template <typename T>
__global__ void tridiag_warp_probe_kernel(const T* __restrict__ abcd, T* __restrict__ out,
                                          int n_nodes, int kind) {
  using A = tri::Arith<T>;
  constexpr unsigned kFull = 0xffffffffu;
  const T a = abcd[0], b = abcd[1], c = abcd[2], d = abcd[3];
  const int lane = threadIdx.x;
  T acc;
  if (kind == 0) {
    const T rho = A::quo(T(1), b);
    const T ell = A::mul(a, rho), q = A::mul(d, rho);
    T e = T(0);
    for (int i = 0; i < n_nodes; ++i) e = A::sub(q, A::mul(ell, e));
    acc = e;
  } else if (kind == 1) {
    const T k = A::sub(a, a);
    T dd = A::add(d, T(lane));
    for (int i = 0; i < n_nodes; ++i) {
      const int s = 1 << (i % 5);
      const T du = __shfl_up_sync(kFull, dd, s);
      const T dn = __shfl_down_sync(kFull, dd, s);
      dd = A::sub(A::sub(dd, A::mul(du, k)), A::mul(dn, k));
    }
    acc = dd;
  } else {
    T ra = a, rb = b, rc = c;
    for (int i = 0; i < n_nodes; ++i) {
      const int s = 1 << (i % 5);
      const T au = __shfl_up_sync(kFull, ra, s), bu = __shfl_up_sync(kFull, rb, s);
      const T cu = __shfl_up_sync(kFull, rc, s);
      const T ad = __shfl_down_sync(kFull, ra, s), bd = __shfl_down_sync(kFull, rb, s);
      const T cd = __shfl_down_sync(kFull, rc, s);
      const T k1 = tri::quotient(ra, bu);
      const T k2 = tri::quotient(rc, bd);
      ra = -A::mul(au, k1);
      rb = A::sub(A::sub(rb, A::mul(cu, k1)), A::mul(ad, k2));
      rc = -A::mul(cd, k2);
    }
    acc = rb;
  }
  if (lane == 0) out[0] = acc;
}

__device__ __forceinline__ unsigned long long bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned long long bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

// The division check: out[i] = num[i] / den[i] by the route rhs_chain takes
// (fast_quotient on table_rcp(den); a pair it flags by flagged_quotient; one
// pair a thread, no vote). Every pair whose quotient differs in its bits from
// the division intrinsic's (two NaNs agree) adds one to counts[0] and puts
// its index in counts[2] if lower; counts[1] counts the pairs on the fast
// path.
template <typename T>
__global__ void tridiag_div_check_kernel(const T* __restrict__ num, const T* __restrict__ den,
                                         T* __restrict__ out, unsigned long long* counts,
                                         int64_t n) {
  using A = tri::Arith<T>;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T a = num[i], b = den[i];
    bool bad = false;
    const T y = tri::table_rcp(b, false);
    const T ieee = A::quo(a, b);
    T q = tri::fast_quotient(a, b, y, bad);
    if (bad) q = tri::flagged_quotient(a, b, y);
    out[i] = q;
    const bool same = (q != q && ieee != ieee) || bits(q) == bits(ieee);
    if (!same) {
      atomicAdd(counts, 1ULL);
      atomicMin(counts + 2, static_cast<unsigned long long>(i));
    }
    const unsigned fast = __ballot_sync(__activemask(), !bad);
    if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) atomicAdd(counts + 1, __popc(fast));
  }
}

template <typename T>
cudaError_t launch_solve(const Operand* ops, void* x, const int64_t* strides, int batch, int n,
                         int systems, cudaStream_t st) {
  const Tile tile(ops, n, systems);
  const int64_t bytes = tile.elements * static_cast<int64_t>(sizeof(T)) + tri::kDumpBytes;
  if (bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(tridiag_kernel<T>, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int blocks = (batch + systems - 1) / systems;
  tridiag_kernel<T><<<blocks, kWarp, static_cast<size_t>(bytes), st>>>(
      ops[0], ops[1], ops[2], ops[3], static_cast<T*>(x), strides[8], strides[9], batch, n,
      systems);
  return cudaGetLastError();
}

}  // namespace
}  // namespace optionslab

// dtype: 0 float32, 1 float64. strides: 10 int64 values, (batch, element)
// for lower, diag, upper, rhs and the solution x. systems: systems per CUDA
// block, 1 to 16 (the wrapper's plan; the tile must fit in 227 KB of
// shared memory). Returns a cudaError_t code (0 on success).
extern "C" int tridiag_solve_launch(const void* lo, const void* di, const void* up,
                                    const void* rhs, void* x, const int64_t* strides, int batch,
                                    int n, int systems, int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || n < 1 || systems < 1 || systems > tri::kPair || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operand ops[4] = {{lo, strides[0], strides[1]},
                          {di, strides[2], strides[3]},
                          {up, strides[4], strides[5]},
                          {rhs, strides[6], strides[7]}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_solve<float>(ops, x, strides, batch, n, systems, st)
                   : launch_solve<double>(ops, x, strides, batch, n, systems, st);
  return static_cast<int>(err);
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

// The right-hand side's chain probe: one block of one warp, n_nodes forward
// nodes (a multiple of 16, or 0) and n_back back nodes. abcd: lower, den,
// upper, rhs. Returns a cudaError_t.
extern "C" int tridiag_rhs_chain_launch(const void* abcd, void* out, int n_nodes, int n_back,
                                        int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes < 0 || n_nodes % 16 != 0 || n_back < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tridiag_rhs_chain_kernel<float><<<1, 32, 0, st>>>(static_cast<const float*>(abcd),
                                                     static_cast<float*>(out), n_nodes,
                                                     n_back);
  } else {
    tridiag_rhs_chain_kernel<double><<<1, 32, 0, st>>>(static_cast<const double*>(abcd),
                                                      static_cast<double*>(out), n_nodes,
                                                      n_back);
  }
  return static_cast<int>(cudaGetLastError());
}

// The FMA chain probe: one block of one thread, n_nodes nodes (a multiple
// of 32); ahead 0 the reverse's own walk, 1 the next group's loads during a
// group's chain. abcd: lower (m is its negation), den,
// upper, rhs (d). Returns a cudaError_t.
extern "C" int tridiag_fma_chain_launch(const void* abcd, void* out, int n_nodes, int ahead,
                                        int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes < 32 || n_nodes % 32 != 0 || (ahead != 0 && ahead != 1) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(abcd);
  const double* ad = static_cast<const double*>(abcd);
  float* of = static_cast<float*>(out);
  double* od = static_cast<double*>(out);
  if (dtype == 0 && ahead) {
    tridiag_fma_chain_kernel<float, true><<<1, 1, 0, st>>>(af, of, n_nodes);
  } else if (dtype == 0) {
    tridiag_fma_chain_kernel<float, false><<<1, 1, 0, st>>>(af, of, n_nodes);
  } else if (ahead) {
    tridiag_fma_chain_kernel<double, true><<<1, 1, 0, st>>>(ad, od, n_nodes);
  } else {
    tridiag_fma_chain_kernel<double, false><<<1, 1, 0, st>>>(ad, od, n_nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

// The division check over n pairs (num, den) of one dtype: out the routine's
// quotients; counts three uint64 (mismatches, fast-path pairs, first
// mismatch), set by the caller to 0, 0 and 2^64 − 1. Returns a cudaError_t.
extern "C" int tridiag_div_check_launch(const void* num, const void* den, void* out,
                                        void* counts, int64_t n, int dtype, int device,
                                        void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  auto* c = static_cast<unsigned long long*>(counts);
  if (dtype == 0) {
    tridiag_div_check_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(num), static_cast<const float*>(den), static_cast<float*>(out),
        c, n);
  } else {
    tridiag_div_check_kernel<double><<<blocks, threads, 0, st>>>(
        static_cast<const double*>(num), static_cast<const double*>(den),
        static_cast<double*>(out), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The warp-partitioned solve's probes: one block of one warp, n_nodes steps
// of kind 0 (a node of the right-hand side's pass), 1 (a stage of its
// reduction) or 2 (a stage of the reduced system's factors). abcd: lower,
// diagonal, upper, rhs. Returns a cudaError_t.
extern "C" int tridiag_warp_probe_launch(const void* abcd, void* out, int n_nodes, int kind,
                                         int dtype, int device, void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes < 1 || kind < 0 || kind > 2 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tridiag_warp_probe_kernel<float><<<1, 32, 0, st>>>(static_cast<const float*>(abcd),
                                                       static_cast<float*>(out), n_nodes, kind);
  } else {
    tridiag_warp_probe_kernel<double><<<1, 32, 0, st>>>(static_cast<const double*>(abcd),
                                                        static_cast<double*>(out), n_nodes, kind);
  }
  return static_cast<int>(cudaGetLastError());
}
