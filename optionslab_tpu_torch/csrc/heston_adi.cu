// The Douglas ADI time loop of the Heston and SLV PDEs in one launch, and the
// reverse of the Heston loop in one more.
//
// Replaces the reference's device loops optionslab_tpu/models/heston_fdm.py
// :200 _heston_adi, :219 _adi_solve_grid, :331 _heston_adi_bermudan and
// :403 _slv_adi_bermudan (each a lax.scan over the step at :160-177, no
// Pallas kernel), and the reverse mode of :219 (jax.checkpoint + scan).
// Without it the port steps on the host: ≈55 small torch launches and two
// tridiagonal launches a step.
//
// heston_adi_kernel runs a whole loop: European, American (the projection
// max(V, intrinsic) after every step), Bermudan (the projection at the end of
// each date block but the last, the continuation slice written before it) or
// SLV Bermudan (the x-operator and the mixed coefficient built every step
// from the leverage row in force). heston_adi_adjoint_kernel runs the
// reverse recursion of the European or American loop over the grids the
// forward kept (each step's input grid, y1 and new grid before the
// projection: no step is computed twice) and accumulates the gradient of
// every operand of the loop.
//
// What bounds them. The dependent chain: a step is an x-sweep (n_v systems
// of n_x nodes) and then a v-sweep (n_x systems of n_v nodes), each a chain
// of n nodes however many systems run beside each other. Where a sweep's
// matrix never changes (the v-sweep, the Heston x-sweeps, every adjoint
// sweep) its tables are formed once and a solve is the right-hand side's
// chain and the back substitution (tridiag.cu's right-hand-side probe); the
// SLV x-sweep re-forms its pivots every step (the pivot probe). The bytes
// (three 81 KB grids a step at 101 × 201) stay on chip.
//
// What the design does about it. Two routes of each loop, chosen by the
// wrapper from the grid's shape (ops/heston_adi.py cluster_plan and
// adjoint_cluster_plan):
// - heston_adi_cluster_kernel, where one thread-block cluster of 2–16 CTAs
//   holds the grid: V, y1, the stencils and the Heston x-sweeps' tables live
//   in the CTAs' shared memory in bands (a CTA's rows for the x-sweeps, its
//   columns for the v-sweeps); each phase writes its output straight into
//   the shared memory of the CTA that reads it next (st.shared::cluster):
//   y1 to its columns' owners, the new grid to its rows' owners and their
//   halo rows; one cluster barrier ends each phase; every sweep on fixed
//   tables runs tri::rhs_chain, one lane a system, each quotient three
//   dependent operations on a reciprocal formed once; the SLV x-sweep runs
//   tridiag.cuh's two-lane solve;
// - heston_adi_kernel, for a grid no cluster can hold: one cooperative
//   launch, the grid in global memory (L2), two grid-wide barriers a step;
//   phase X a warp a variance row (its right-hand side from three rows of
//   V, then its sweep), phase V a warp a spot column; the tables of every
//   fixed sweep formed once (solve_fixed: the right-hand side's chain);
// - the reverse, heston_adi_adjoint_kernel: the same bands in one cluster
//   (or, for a grid no cluster holds, in one cooperative launch whose moves
//   go through global memory and a grid barrier); phase V' splits the
//   gradient at the projection and solves each column's adjoint system,
//   phase X' each row's and forms the parts of the previous grid's gradient,
//   which go to the columns' owners; every adjoint sweep on tables formed
//   once, one lane a system, its chain unchecked (no comparison between a
//   node's dependent operations: they doubled a node's time) and every node
//   then held to the division's bits by the CTA's other warps beside the
//   back substitution; every accumulator in its owner's shared memory for
//   the whole launch, written to global memory once; the history of the
//   step before loaded by cp.async while a step runs.
//
// Bit for bit with the plain loop (ops/heston_adi.py _adi_plain): every
// product, sum and quotient is rounded on its own (tri::Arith, never an
// FMA), in the plain loop's order; the solves are tridiag.cuh's; every
// operand that needs a transcendental (the boundary table, the stencils, the
// leverage rows) is computed by torch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tridiag.cuh"

namespace optionslab {
namespace {

namespace cg = cooperative_groups;
using A = tri::Arith<float>;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDumpFloats = tri::kDumpBytes / 4;
enum Mode { kEuropean = 0, kAmerican = 1, kBermudan = 2 };

// Shared memory of a CUDA block of the cooperative forward kernel, in floats
// (ops/heston_adi.py smem_bytes): four block-wide v-sweep planes (the lower
// diagonal and the tables den, c', RN(1/den)), then per warp six solve
// planes (lower,
// diagonal, upper, right-hand side, c', d'), five x-rows of n_x + 2 (node c
// at c + 1, zeros beyond the grid), three v-columns of n_v + 2 and the dump
// slots of the lanes without a system.
struct Layout {
  int plane, vplane, row, col;
  int64_t per_warp, floats;

  __host__ __device__ Layout(int n_v, int n_x) {
    vplane = (n_v + 2 * tri::kPad + 3) / 4 * 4;
    plane = (n_v > n_x ? n_v : n_x) + 2 * tri::kPad;
    row = n_x + 2;
    col = n_v + 2;
    per_warp = (6LL * plane + 5LL * row + 3LL * col + 3) / 4 * 4 + kDumpFloats;
    floats = 4LL * vplane + kWarps * per_warp;
  }
};

// A warp's tile: node 0 of each solve plane, the rows and columns.
struct Tile {
  float* lo;
  float* di;
  float* up;
  float* rhs;
  float* cs;
  float* ds;
  float* r[5];
  float* c[3];
  const void* dump;
};

__device__ Tile warp_tile(float* smem, const Layout& L, int warp) {
  float* base = smem + 4 * L.vplane + warp * L.per_warp;
  Tile t;
  float* planes[6];
  for (int o = 0; o < 6; ++o) planes[o] = base + o * L.plane + tri::kPad;
  t.lo = planes[0];
  t.di = planes[1];
  t.up = planes[2];
  t.rhs = planes[3];
  t.cs = planes[4];
  t.ds = planes[5];
  float* rows = base + 6 * L.plane;
  for (int q = 0; q < 5; ++q) t.r[q] = rows + q * L.row;
  float* cols = rows + 5 * L.row;
  for (int q = 0; q < 3; ++q) t.c[q] = cols + q * L.col;
  t.dump = base + L.per_warp - kDumpFloats;
  return t;
}

// The padding of operand plane o (0 lower, 1 diagonal, 2 upper, 3 right-hand
// side) of an n-node system: see tri::kPad. Lanes 0..kPad−1.
__device__ __forceinline__ void pad(float* node0, int o, int n, int lane) {
  if (lane < tri::kPad) {
    node0[lane - tri::kPad] = tri::pad_value<float>(o, false);
    node0[n + lane] = tri::pad_value<float>(o, true);
  }
}

// Global buffers the kernels write are read and written at L2 (.cg): another
// SM wrote them before the last grid barrier.
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ void st(float* p, float v) { __stcg(p, v); }

// The warp's Thomas solve of one n-node system, its operands at node 0 of
// lo, di, up and rhs (padded); the solution lands in t.ds. All 32 lanes.
__device__ void solve(const float* lo, const float* di, const float* up, const float* rhs,
                      const Tile& t, int n) {
  const int lane = threadIdx.x & 31;
  tri::Row<float> row;
  row.col[0] = tri::col<float>(lo, 0, 1);
  row.col[1] = tri::col<float>(di, 0, 1);
  row.col[2] = tri::col<float>(up, 0, 1);
  row.col[3] = tri::col<float>(rhs, 0, 1);
  const tri::Col<float> cs = tri::col<float>(t.cs, 0, 1);
  const tri::Col<float> ds = tri::col<float>(t.ds, 0, 1);
  // pivot lane 0 and its partner lane 16; the others write to their dump slots
  const tri::Col<float> out = lane % tri::kPair == 0 ? (lane == 0 ? cs : ds)
                                                     : tri::dump_col<float>(t.dump);
  float x_last = 0.0f;
  float den = 1.0f;
  tri::forward_split(0, n + 1, row, out, x_last, den);
  __syncwarp();
  if (lane == 0) tri::back_sweep(n, cs, ds, ds);
  __syncwarp();
}

// The solve on tables formed once (tri::form_tables: den, c' and RN(1/den)):
// the right-hand side's chain (tri::rhs_chain, lane 0's system; the other
// lanes walk its columns and write to their dump slots), then lane 0's back
// substitution; the solution lands in t.ds. lo, den, rcp and rhs are padded
// after node n − 1 (lower 0, den 1, reciprocal 1, right-hand side 1). All 32
// lanes call it.
__device__ void solve_fixed(const float* lo, const float* den, const float* rcp, const float* cs,
                            const float* rhs, const Tile& t, int n) {
  const int lane = threadIdx.x & 31;
  const tri::Col<float> x = tri::col<float>(t.ds, 0, 1);
  tri::rhs_chain(n, tri::col<float>(lo, 0, 1), tri::col<float>(rhs, 0, 1),
                 tri::col<float>(den, 0, 1), tri::col<float>(rcp, 0, 1),
                 lane == 0 ? x : tri::dump_col<float>(t.dump));
  __syncwarp();
  if (lane == 0) tri::back_sweep(n, tri::col<float>(cs, 0, 1), x, x);
  __syncwarp();
}

// A fixed-order sum over the warp's lanes (every lane gets the same value).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = A::add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The forward loop
// ---------------------------------------------------------------------------

struct AdiArgs {
  const float* a1;  // x-stencil and x-sweep tables, (n_v, n_x); null under SLV
  const float* b1;
  const float* c1;
  const float* lo1;
  const float* di1;
  const float* up1;
  const float* a2;  // v-stencil and v-sweep rows, (n_v)
  const float* b2;
  const float* c2;
  const float* lo2;
  const float* di2;
  const float* up2;
  const float* mc;      // (n_v − 2) mixed coefficient; null under SLV
  const float* scal;    // dt, 4·dx·dξ; under SLV also ρσ, r − q, 2·dx, dx·dx, r/2
  const float* bounds;  // (n_t, 2)
  const float* intr;    // (n_v, n_x)
  const float* start;   // (n_v, n_x)
  const float* lev;     // SLV: (n_rows, n_x) leverage rows
  const int* rows;      // SLV: (n_t) the row in force each step
  const float* v;       // SLV: (n_v) variance nodes
  const float* w;       // SLV: (n_v − 2) v/g'
  float* out;           // (n_v, n_x)
  float* cont;          // Bermudan: (n_dates + 1, n_v, n_x), entries 0 and n_dates left alone
  float* vbuf;          // history: (n_t, n_v, n_x) each step's input grid; else 2 grids
  float* y1buf;         // history: (n_t, n_v, n_x); else 1 grid
  float* y2buf;         // history: (n_t, n_v, n_x) each new grid before the projection
  float* xpiv;          // Heston: (3, n_v, n_x) the x-sweeps' tables den, c', RN(1/den)
  int n_v, n_x, n_t, mode, spd, slv, history, n_dates;
};

__device__ __forceinline__ int64_t cells(const AdiArgs& a) {
  return static_cast<int64_t>(a.n_v) * a.n_x;
}

// V_k, the input grid of step k, and V_{k+1}, its output.
__device__ __forceinline__ const float* grid_in(const AdiArgs& a, int k) {
  return k == 0 ? a.start : a.vbuf + (a.history ? k : (k & 1)) * cells(a);
}
__device__ __forceinline__ float* grid_out(const AdiArgs& a, int k) {
  return k + 1 == a.n_t ? a.out : a.vbuf + (a.history ? k + 1 : ((k + 1) & 1)) * cells(a);
}

__device__ __forceinline__ bool projects(int mode, int k, int spd, int n_t) {
  return mode == kAmerican || (mode == kBermudan && (k + 1) % spd == 0 && k + 1 < n_t);
}

// num / den for a den fixed for the launch, y = RN(1/den) formed once
// (tri::table_rcp): tri::fast_quotient where its check allows, else
// tri::flagged_quotient; the division's bits either way.
__device__ __forceinline__ float quo_fixed(float num, float den, float y) {
  bool bad = false;
  const float q = tri::fast_quotient(num, den, y, bad);
  return bad ? tri::flagged_quotient(num, den, y) : q;
}

// Node (r, c)'s x-stencil and x-sweep coefficients under frozen leverage, in
// ops/heston_adi.py x_operator's order: conv = ((r − q) − (L²/2)·v)/(2·dx),
// diff = (L²/2)·v/(dx·dx), identity rows at the pinned ends. With kFixed the
// two quotients go by quo_fixed on the reciprocals y4 of 2·dx and y5 of
// dx·dx.
template <bool kFixed = false>
__device__ __forceinline__ void slv_x(const float* sc, float lev_c, float v_r, bool edge,
                                      float dt, float& a1, float& b1, float& c1, float& lo,
                                      float& di, float& up, float y4 = 0.0f, float y5 = 0.0f) {
  if (edge) {
    a1 = b1 = c1 = 0.0f;
  } else {
    const float hv = A::mul(A::mul(0.5f, A::mul(lev_c, lev_c)), v_r);
    const float conv = kFixed ? quo_fixed(A::sub(sc[3], hv), sc[4], y4)
                              : A::quo(A::sub(sc[3], hv), sc[4]);
    const float diff = kFixed ? quo_fixed(hv, sc[5], y5) : A::quo(hv, sc[5]);
    a1 = A::sub(diff, conv);
    c1 = A::add(diff, conv);
    b1 = A::sub(A::mul(-2.0f, diff), sc[6]);
  }
  const float ntd = A::mul(-0.5f, dt);
  lo = A::mul(ntd, a1);
  up = A::mul(ntd, c1);
  di = edge ? 1.0f : A::sub(1.0f, A::mul(A::mul(0.5f, dt), b1));
}

// Stages rows r − 1, r, r + 1 of the grid g into t.r[0..2] (zeros beyond).
__device__ void stage_rows(const float* g, int r, int n_v, int n_x, const Tile& t, int lane) {
  for (int q = 0; q < 3; ++q) {
    const int rr = r - 1 + q;
    const bool in = rr >= 0 && rr < n_v;
    for (int c = lane; c < n_x; c += 32) t.r[q][c + 1] = in ? ld(g + rr * n_x + c) : 0.0f;
    if (lane == 0) t.r[q][0] = t.r[q][n_x + 1] = 0.0f;
  }
}

// Phase X of step k for variance row r: the right-hand side and the x-sweep.
__device__ void forward_row(const AdiArgs& a, const Tile& t, int k, int r, const float* g,
                            float* y1) {
  const int lane = threadIdx.x & 31;
  const int n_v = a.n_v, n_x = a.n_x;
  const float* sc = a.scal;
  const float dt = sc[0], den = sc[1];
  const float td = A::mul(0.5f, dt);
  stage_rows(g, r, n_v, n_x, t, lane);
  __syncwarp();
  const float blo = a.bounds[2 * k], bhi = a.bounds[2 * k + 1];
  const float a2r = a.a2[r], b2r = a.b2[r], c2r = a.c2[r];
  const bool mid_row = r >= 1 && r <= n_v - 2;
  const float* lev = a.slv ? a.lev + static_cast<int64_t>(a.rows[k]) * n_x : nullptr;
  const float coef_r = mid_row ? (a.slv ? a.w[r - 1] : a.mc[r - 1]) : 0.0f;
  const float v_r = a.slv ? a.v[r] : 0.0f;
  const float* v0 = t.r[0];
  const float* v1 = t.r[1];
  const float* v2 = t.r[2];
  for (int c = lane; c < n_x; c += 32) {
    const bool edge = c == 0 || c == n_x - 1;
    float a1, b1, c1;
    if (a.slv) {  // the sweep matrix of this step's leverage row
      slv_x(sc, lev[c], v_r, edge, dt, a1, b1, c1, t.lo[c], t.di[c], t.up[c]);
    } else {  // the matrix of every step: its lower diagonal and its tables
      const int64_t e = static_cast<int64_t>(r) * n_x + c;
      a1 = a.a1[e];
      b1 = a.b1[e];
      c1 = a.c1[e];
      t.lo[c] = a.lo1[e];
      t.di[c] = ld(a.xpiv + e);                  // den
      t.cs[c] = ld(a.xpiv + cells(a) + e);       // c'
      t.up[c] = ld(a.xpiv + 2 * cells(a) + e);   // RN(1/den)
    }
    float rhs = c == 0 ? blo : bhi;
    if (!edge) {
      const float vc = v1[c + 1];
      const float a1v = A::add(A::add(A::mul(a1, v1[c]), A::mul(b1, vc)), A::mul(c1, v1[c + 2]));
      const float a2v =
          A::add(A::add(A::mul(a2r, v0[c + 1]), A::mul(b2r, vc)), A::mul(c2r, v2[c + 1]));
      float a0v = 0.0f;
      if (mid_row) {
        const float num = A::add(A::sub(A::sub(v2[c + 2], v2[c]), v0[c + 2]), v0[c]);
        const float coef = a.slv ? A::mul(A::mul(sc[2], lev[c]), coef_r) : coef_r;
        a0v = A::mul(coef, A::quo(num, den));
      }
      const float y0 = A::add(vc, A::mul(dt, A::add(A::add(a0v, a1v), a2v)));
      rhs = A::sub(y0, A::mul(td, a1v));
    }
    t.rhs[c] = rhs;
  }
  pad(t.lo, 0, n_x, lane);
  pad(t.di, 1, n_x, lane);
  pad(t.up, 2, n_x, lane);
  pad(t.rhs, 3, n_x, lane);
  __syncwarp();
  if (a.slv) {
    solve(t.lo, t.di, t.up, t.rhs, t, n_x);
  } else {
    solve_fixed(t.lo, t.di, t.up, t.cs, t.rhs, t, n_x);
  }
  for (int c = lane; c < n_x; c += 32) st(y1 + static_cast<int64_t>(r) * n_x + c, t.ds[c]);
  __syncwarp();
}

// Phase V of step k for spot column c: the v-sweep (none on the pinned
// columns), then the new grid, pinned, recorded and projected.
__device__ void forward_col(const AdiArgs& a, const Tile& t, const float* const* vs, int k,
                            int c,
                            const float* g, const float* y1, float* g_out) {
  const int lane = threadIdx.x & 31;
  const int n_v = a.n_v, n_x = a.n_x;
  const bool edge = c == 0 || c == n_x - 1;
  if (!edge) {
    const float td = A::mul(0.5f, a.scal[0]);
    float* vc = t.c[0];
    for (int r = lane; r < n_v; r += 32) vc[r + 1] = ld(g + r * n_x + c);
    if (lane == 0) vc[0] = vc[n_v + 1] = 0.0f;
    __syncwarp();
    for (int r = lane; r < n_v; r += 32) {
      const float a2v = A::add(A::add(A::mul(a.a2[r], vc[r]), A::mul(a.b2[r], vc[r + 1])),
                               A::mul(a.c2[r], vc[r + 2]));
      t.rhs[r] = A::sub(ld(y1 + r * n_x + c), A::mul(td, a2v));
    }
    pad(t.rhs, 3, n_v, lane);
    __syncwarp();
    solve_fixed(vs[0], vs[1], vs[3], vs[2], t.rhs, t, n_v);
  }
  const float pin = a.bounds[2 * k + (c == 0 ? 0 : 1)];
  const bool proj = projects(a.mode, k, a.spd, a.n_t);
  const bool record = proj && a.mode == kBermudan;
  const int64_t n = cells(a);
  for (int r = lane; r < n_v; r += 32) {
    const int64_t e = static_cast<int64_t>(r) * n_x + c;
    float vp = edge ? pin : t.ds[r];
    if (a.history) st(a.y2buf + k * n + e, vp);
    if (record) st(a.cont + (a.n_dates - 1 - k / a.spd) * n + e, vp);
    if (proj) vp = A::max(vp, a.intr[e]);
    st(g_out + e, vp);
  }
  __syncwarp();
}

// The v-sweep's lower diagonal and tables (den, c', RN(1/den)) into the
// block's four planes, padded; warp 0 of the block, whose solve planes hold
// the diagonal and the upper diagonal meanwhile.
__device__ void stage_v_tables(float* smem, const Layout& L, const Tile& t, const AdiArgs& a) {
  const int lane = threadIdx.x & 31;
  float* vlo = smem + tri::kPad;
  for (int r = lane; r < a.n_v; r += 32) {
    vlo[r] = a.lo2[r];
    t.di[r] = a.di2[r];
    t.up[r] = a.up2[r];
  }
  pad(vlo, 0, a.n_v, lane);
  __syncwarp();
  if (lane == 0) {
    tri::form_tables(a.n_v, tri::col<float>(vlo, 0, 1), tri::col<float>(t.di, 0, 1),
                     tri::col<float>(t.up, 0, 1), tri::col<float>(vlo + L.vplane, 0, 1),
                     tri::col<float>(vlo + 2 * L.vplane, 0, 1),
                     tri::col<float>(vlo + 3 * L.vplane, 0, 1));
  }
  __syncwarp();
}

// The tables of variance row r's x-sweep into xpiv (3, n_v, n_x): den, c'
// and RN(1/den). One warp.
__device__ void x_tables(const AdiArgs& a, int r, const Tile& t) {
  const int lane = threadIdx.x & 31;
  const int n_x = a.n_x;
  const int64_t row0 = static_cast<int64_t>(r) * n_x;
  for (int c = lane; c < n_x; c += 32) {
    t.lo[c] = a.lo1[row0 + c];
    t.di[c] = a.di1[row0 + c];
    t.up[c] = a.up1[row0 + c];
  }
  __syncwarp();
  if (lane == 0) {
    tri::form_tables(n_x, tri::col<float>(t.lo, 0, 1), tri::col<float>(t.di, 0, 1),
                     tri::col<float>(t.up, 0, 1), tri::col<float>(t.rhs, 0, 1),
                     tri::col<float>(t.cs, 0, 1), tri::col<float>(t.ds, 0, 1));
  }
  __syncwarp();
  for (int c = lane; c < n_x; c += 32) {
    st(a.xpiv + row0 + c, t.rhs[c]);
    st(a.xpiv + cells(a) + row0 + c, t.cs[c]);
    st(a.xpiv + 2 * cells(a) + row0 + c, t.ds[c]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) heston_adi_kernel(AdiArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.n_v, a.n_x);
  const int warp = threadIdx.x >> 5;
  const Tile t = warp_tile(smem, L, warp);
  const float* vs[4] = {smem + tri::kPad, smem + L.vplane + tri::kPad,
                        smem + 2 * L.vplane + tri::kPad, smem + 3 * L.vplane + tri::kPad};
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  // the tables of the sweeps whose matrix is the same every step: the
  // v-sweep's a CUDA block, the Heston x-sweeps' a warp a row (each warp
  // reads back only its own rows)
  if (warp == 0) stage_v_tables(smem, L, t, a);
  if (!a.slv) {
    for (int r = gw; r < a.n_v; r += nw) x_tables(a, r, t);
  }
  if (a.history) {  // V_0 beside the other steps' inputs, for the reverse
    const int64_t n = cells(a);
    for (int64_t e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
      st(a.vbuf + e, a.start[e]);
    }
  }
  __syncthreads();
  for (int k = 0; k < a.n_t; ++k) {
    const float* g = grid_in(a, k);
    float* y1 = a.y1buf + (a.history ? k * cells(a) : 0);
    for (int r = gw; r < a.n_v; r += nw) forward_row(a, t, k, r, g, y1);
    grid.sync();
    float* g_out = grid_out(a, k);
    for (int c = gw; c < a.n_x; c += nw) forward_col(a, t, vs, k, c, g, y1, g_out);
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The forward loop in one thread-block cluster
// ---------------------------------------------------------------------------

constexpr int kClusterWarps = 16;
constexpr int kClusterThreads = 32 * kClusterWarps;
constexpr int kMaxCluster = 16;
// The solves run on one warp of each of the SM's four schedulers (a second
// warp on a scheduler would share its issue with the first chain's); the
// other warps only form right-hand sides and move results.
constexpr int kChainWarps = 4;
// systems a phase of one CTA may hold: one lane each over the chain warps
// (two under SLV's x-sweep)
constexpr int kMaxBand = 32 * kChainWarps;
constexpr int kMaxSlvBand = tri::kPair * kChainWarps;
// the reverse kernel's warps beside its chain warps: they check the chains
constexpr int kCheckWarps = kClusterWarps - kChainWarps;

// The bands of a cluster of `ctas` CTAs: CTA k owns variance rows
// [k·rows, (k + 1)·rows) for the x-sweeps and spot columns
// [k·cols, (k + 1)·cols) for the v-sweeps (cols a multiple of 4), clipped to
// the grid, and holds in its shared memory, in floats (ops/heston_adi.py
// cluster_bytes):
//   vrow   (rows + 2) × wx, wx = ctas·cols + 4: V on its rows and a halo row
//          on each side (zero beyond the grid), node c at c + 4 (zeros
//          before, and room after for the last band's columns past the
//          grid), so each band's columns start on 16 bytes;
//   vcol   cols × (n_v + 2): V on its columns, node r at r + 1;
//   y1col  n_v × cols: y1 on its columns, row r at r·cols, written there by
//          each row's owner;
//   icol   cols × n_v: the exercise value on its columns;
//   x      seven node-major planes of the x-sweeps (node c of row i at
//          c·px + i, px = rows | 1, tri::kPad rows of padding at both ends):
//          the Heston stencil a1, b1, c1, the sweep's lower diagonal and its
//          tables den, c', RN(1/den); under SLV planes 3–6 are the step's
//          lower, diagonal, upper and c';
//   xs     the x-sweeps' right-hand side and d' (the solution over it);
//   v      the v-sweep's lower diagonal and its tables den, c', RN(1/den)
//          (n_v + 2·kPad each), then its stencil a2, b2, c2 (n_v each);
//   vs     the v-sweeps' right-hand side and d', node-major (pc = cols | 1);
//   peers  each CTA's shared memory in the cluster's window (mapa, once);
//   dump   the lanes' dump slots.
// The moves between CTAs are 16-byte stores, four columns a lane.
struct ClusterLayout {
  int rows, cols, px, pc, wx;
  int64_t xplane, vplane, vtab, vrow, vcol, y1col, icol, x, xs, v, vs, peers, dump, floats;

  __host__ __device__ ClusterLayout(int n_v, int n_x, int ctas) {
    rows = (n_v + ctas - 1) / ctas;
    cols = ((n_x + ctas - 1) / ctas + 3) / 4 * 4;
    px = rows | 1;
    pc = cols | 1;
    wx = ctas * cols + 4;
    xplane = static_cast<int64_t>(n_x + 2 * tri::kPad) * px;
    vplane = static_cast<int64_t>(n_v + 2 * tri::kPad) * pc;
    vtab = n_v + 2 * tri::kPad;
    vrow = 0;
    vcol = vrow + (rows + 2LL) * wx;
    y1col = vcol + static_cast<int64_t>(cols) * (n_v + 2);
    icol = y1col + static_cast<int64_t>(cols) * n_v;
    x = icol + static_cast<int64_t>(cols) * n_v;
    xs = x + 7 * xplane;
    v = xs + 2 * xplane;
    vs = v + 4 * vtab + 3LL * n_v;
    peers = vs + 2 * vplane;
    dump = (peers + kMaxCluster + 1) / 2 * 2;
    floats = dump + kDumpFloats;
  }
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// One barrier of every thread of the cluster: the shared-memory stores
// before it (local and remote) are seen by every CTA after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The address of this CTA's shared memory byte 0 in CTA `rank`'s window.
__device__ __forceinline__ unsigned map_peer(const void* smem0, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem0))), "r"(rank));
  return addr;
}

// The four floats at `offset` floats (a multiple of 4) into the shared memory
// of the CTA whose window starts at `peer` = v.
__device__ __forceinline__ void st_remote4(unsigned peer, int64_t offset, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                   peer + static_cast<unsigned>(offset) * 4u),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The whole loop in one cluster of `ctas` CTAs, the grid in their shared
// memory: each step, phase X (the CTA's rows: their right-hand sides, then
// their x-sweeps, one lane a row on the tables, or two under SLV), y1 sent
// to the columns' owners; one cluster barrier; phase V (the CTA's columns:
// their right-hand sides, their v-sweeps on the tables, one lane a column),
// the new grid pinned, recorded, projected and sent to the rows' owners and
// their halos; one cluster barrier. The history and the continuation slices
// go to global memory beside the chain.
__global__ void __launch_bounds__(kClusterThreads)
    heston_adi_cluster_kernel(AdiArgs a, int ctas) {
  extern __shared__ __align__(16) float smem[];
  const int n_v = a.n_v, n_x = a.n_x;
  const int64_t n = cells(a);
  const ClusterLayout L(n_v, n_x, ctas);
  const int rank = static_cast<int>(cluster_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r0 = rank * L.rows;
  const int nr = max(0, min(L.rows, n_v - r0));
  const int c0 = rank * L.cols;
  const int nc = max(0, min(L.cols, n_x - c0));
  const int wx = L.wx;  // a vrow row
  const int hv = n_v + 2;  // a vcol column
  const int px = L.px, pc = L.pc;
  float* vrow = smem + L.vrow;
  float* vcol = smem + L.vcol;
  float* y1col = smem + L.y1col;
  float* icol = smem + L.icol;
  float* xp[7];
  for (int o = 0; o < 7; ++o) xp[o] = smem + L.x + o * L.xplane + tri::kPad * px;
  float* xrhs = smem + L.xs + tri::kPad * px;
  float* xds = xrhs + L.xplane;
  float* vlo = smem + L.v + tri::kPad;
  float* vden = vlo + L.vtab;
  float* vcs = vden + L.vtab;
  float* vrcp = vcs + L.vtab;
  float* va2 = smem + L.v + 4 * L.vtab;
  float* vb2 = va2 + n_v;
  float* vc2 = vb2 + n_v;
  float* vrhs = smem + L.vs + tri::kPad * pc;
  float* vds = vrhs + L.vplane;
  const void* dump = smem + L.dump;
  unsigned* peers = reinterpret_cast<unsigned*>(smem + L.peers);
  if (tid < ctas) peers[tid] = map_peer(smem, tid);

  // the grid at t = 0, the exercise value, the stencils; the Heston
  // x-sweep's diagonal and upper diagonal and the v-sweep's wait in the
  // solve planes until their tables are formed
  for (int e = tid; e < (L.rows + 2) * wx; e += kClusterThreads) {
    const int i = e / wx;
    const int r = r0 - 1 + i;
    const int c = e - i * wx - 4;
    const bool in = i <= nr + 1 && r >= 0 && r < n_v && c >= 0 && c < n_x;
    vrow[e] = in ? a.start[static_cast<int64_t>(r) * n_x + c] : 0.0f;
  }
  for (int e = tid; e < L.cols * hv; e += kClusterThreads) {
    const int jc = e / hv;
    const int r = e - jc * hv - 1;
    const bool in = jc < nc && r >= 0 && r < n_v;
    vcol[e] = in ? a.start[static_cast<int64_t>(r) * n_x + c0 + jc] : 0.0f;
  }
  for (int e = tid; e < nc * n_v; e += kClusterThreads) {
    const int jc = e / n_v;
    const int64_t g = static_cast<int64_t>(e - jc * n_v) * n_x + c0 + jc;
    icol[e] = a.intr[g];
    if (a.history) st(a.vbuf + g, a.start[g]);  // V_0 beside the other steps' inputs
  }
  if (!a.slv) {
    for (int e = tid; e < nr * n_x; e += kClusterThreads) {
      const int i = e / n_x;
      const int c = e - i * n_x;
      const int64_t g = static_cast<int64_t>(r0 + i) * n_x + c;
      const int t = c * px + i;
      xp[0][t] = a.a1[g];
      xp[1][t] = a.b1[g];
      xp[2][t] = a.c1[g];
      xp[3][t] = a.lo1[g];
      xrhs[t] = a.di1[g];
      xds[t] = a.up1[g];
    }
  }
  for (int r = tid; r < n_v; r += kClusterThreads) {
    vlo[r] = a.lo2[r];
    vrhs[r * pc] = a.di2[r];
    vds[r * pc] = a.up2[r];
    va2[r] = a.a2[r];
    vb2[r] = a.b2[r];
    vc2[r] = a.c2[r];
  }
  // the padding (tri::kPad): the x-sweeps' lower 0, diagonal and upper 1
  // (SLV), right-hand sides 0 before and 1 after; the v-sweep's lower 0
  for (int e = tid; e < tri::kPad * px; e += kClusterThreads) {
    const int after = n_x * px + e;
    const int before = e - tri::kPad * px;
    xp[3][before] = xp[3][after] = 0.0f;
    xp[4][before] = xp[4][after] = xp[5][before] = xp[5][after] = 1.0f;
    xrhs[before] = 0.0f;
    xrhs[after] = 1.0f;
  }
  for (int e = tid; e < tri::kPad * pc; e += kClusterThreads) {
    vrhs[e - tri::kPad * pc] = 0.0f;
    vrhs[n_v * pc + e] = 1.0f;
  }
  if (tid < tri::kPad) vlo[tid - tri::kPad] = vlo[n_v + tid] = 0.0f;
  __syncthreads();
  // the tables of the sweeps whose matrix is the same every step: the
  // Heston x-sweeps, one lane a row; the v-sweep, the block's last lane
  const int sys = warp < kChainWarps ? tri::spread_system(kChainWarps) : kMaxBand;
  if (!a.slv && sys < nr) {
    tri::form_tables(n_x, tri::col<float>(xp[3], sys, px), tri::col<float>(xrhs, sys, px),
                     tri::col<float>(xds, sys, px), tri::col<float>(xp[4], sys, px),
                     tri::col<float>(xp[5], sys, px), tri::col<float>(xp[6], sys, px));
  }
  if (tid == kClusterThreads - 1) {
    tri::form_tables(n_v, tri::col<float>(vlo, 0, 1), tri::col<float>(vrhs, 0, pc),
                     tri::col<float>(vds, 0, pc), tri::col<float>(vden, 0, 1),
                     tri::col<float>(vcs, 0, 1), tri::col<float>(vrcp, 0, 1));
  }
  __syncthreads();
  cluster_barrier();  // every CTA's memory is set before any CTA writes to it

  // the lanes of the solves: one a system over the chain warps on the
  // tables; a warp with a system runs whole, its lanes without one on the
  // warp's first system, writing to their dump slots. SLV's x-sweep: pivot
  // lane l < 16 and its partner l + 16 on system (l % 16)·kChainWarps + warp
  const bool x_warp = warp < kChainWarps && warp < nr;
  const int xs_ = sys < nr ? sys : (x_warp ? warp : 0);
  const bool v_warp = warp < kChainWarps && warp < nc;
  const int vs_ = sys < nc ? sys : (v_warp ? warp : 0);
  const int lane = tid & 31;
  const bool pivot = lane < tri::kPair;
  const int pair = warp < kChainWarps ? (lane % tri::kPair) * kChainWarps + warp : kMaxBand;
  const bool pair_live = pair < nr;
  const int ps = pair_live ? pair : (x_warp ? warp : 0);
  const tri::Col<float> x_out = sys < nr ? tri::col<float>(xds, xs_, px)
                                         : tri::dump_col<float>(dump);
  const tri::Col<float> v_out = sys < nc ? tri::col<float>(vds, vs_, pc)
                                         : tri::dump_col<float>(dump);
  tri::Row<float> slv_row;
  slv_row.col[0] = tri::col<float>(xp[3], ps, px);
  slv_row.col[1] = tri::col<float>(xp[4], ps, px);
  slv_row.col[2] = tri::col<float>(xp[5], ps, px);
  slv_row.col[3] = tri::col<float>(xrhs, ps, px);
  const tri::Col<float> slv_out =
      pair_live ? tri::col<float>(pivot ? xp[6] : xds, ps, px) : tri::dump_col<float>(dump);

  const float* sc = a.scal;
  const float dt = sc[0], den = sc[1];
  const float td = A::mul(0.5f, dt);
  // the reciprocals of the formation's fixed divisors
  const float y_den = tri::table_rcp(den, false);
  const float y4 = a.slv ? tri::table_rcp(sc[4], false) : 0.0f;
  const float y5 = a.slv ? tri::table_rcp(sc[5], false) : 0.0f;
  for (int k = 0; k < a.n_t; ++k) {
    // phase X: the rows' right-hand sides (and under SLV their matrices)
    const float blo = a.bounds[2 * k], bhi = a.bounds[2 * k + 1];
    const float* lev = a.slv ? a.lev + static_cast<int64_t>(a.rows[k]) * n_x : nullptr;
    const int x_chunks = (n_x + 31) / 32;
    for (int e = warp; e < nr * x_chunks; e += kClusterWarps) {  // a warp 32 nodes of a row
      const int i = e / x_chunks;
      const int c = (e - i * x_chunks) * 32 + lane;
      if (c < n_x) {
        const int r = r0 + i;
        const int t = c * px + i;
        const float* v0 = vrow + i * wx;
        const float* v1 = v0 + wx;
        const float* v2 = v1 + wx;
        const bool edge = c == 0 || c == n_x - 1;
        const bool mid_row = r >= 1 && r <= n_v - 2;
        float a1, b1, c1;
        if (a.slv) {
          slv_x<true>(sc, lev[c], a.v[r], edge, dt, a1, b1, c1, xp[3][t], xp[4][t], xp[5][t],
                      y4, y5);
        } else {
          a1 = xp[0][t];
          b1 = xp[1][t];
          c1 = xp[2][t];
        }
        float rhs = c == 0 ? blo : bhi;
        if (!edge) {
          const float vc = v1[c + 4];
          const float a1v =
              A::add(A::add(A::mul(a1, v1[c + 3]), A::mul(b1, vc)), A::mul(c1, v1[c + 5]));
          const float a2v = A::add(A::add(A::mul(va2[r], v0[c + 4]), A::mul(vb2[r], vc)),
                                   A::mul(vc2[r], v2[c + 4]));
          float a0v = 0.0f;
          if (mid_row) {
            const float num = A::add(A::sub(A::sub(v2[c + 5], v2[c + 3]), v0[c + 5]), v0[c + 3]);
            const float coef_r = a.slv ? a.w[r - 1] : a.mc[r - 1];
            const float coef = a.slv ? A::mul(A::mul(sc[2], lev[c]), coef_r) : coef_r;
            a0v = A::mul(coef, quo_fixed(num, den, y_den));
          }
          const float y0 = A::add(vc, A::mul(dt, A::add(A::add(a0v, a1v), a2v)));
          rhs = A::sub(y0, A::mul(td, a1v));
        }
        xrhs[t] = rhs;
      }
    }
    __syncthreads();
    // the x-sweeps
    if (a.slv) {
      if (x_warp) {
        float x_last = 0.0f;
        float d_prev = 1.0f;
        tri::forward_split(0, n_x + 1, slv_row, slv_out, x_last, d_prev);
        __syncwarp();
        if (pivot && pair_live) {
          tri::back_sweep(n_x, tri::col<float>(xp[6], ps, px), tri::col<float>(xds, ps, px),
                          tri::col<float>(xds, ps, px));
        }
      }
    } else if (x_warp) {
      tri::rhs_chain(n_x, tri::col<float>(xp[3], xs_, px), tri::col<float>(xrhs, xs_, px),
                     tri::col<float>(xp[4], xs_, px), tri::col<float>(xp[6], xs_, px), x_out);
      if (sys < nr) tri::back_sweep(n_x, tri::col<float>(xp[5], xs_, px), x_out, x_out);
    }
    __syncthreads();
    // y1 to the owners of its columns, four columns a lane: item
    // (row i, owner d, columns 4q..4q + 3 of d's band)
    const int quads = L.cols / 4;
    for (int e = tid; e < nr * ctas * quads; e += kClusterThreads) {
      const int id = e / quads;
      const int jc = (e - id * quads) * 4;
      const int d = id / nr;
      const int i = id - d * nr;
      float y[4];
      for (int q = 0; q < 4; ++q) {
        const int c = d * L.cols + jc + q;
        y[q] = c < n_x ? xds[c * px + i] : 0.0f;
        if (a.history && c < n_x) {
          st(a.y1buf + k * n + static_cast<int64_t>(r0 + i) * n_x + c, y[q]);
        }
      }
      st_remote4(peers[d], L.y1col + static_cast<int64_t>(r0 + i) * L.cols + jc,
                 make_float4(y[0], y[1], y[2], y[3]));
    }
    cluster_barrier();

    // phase V: the columns' right-hand sides
    for (int e = tid; e < n_v * nc; e += kClusterThreads) {
      const int r = e / nc;
      const int jc = e - r * nc;
      const float* vc = vcol + jc * hv;
      const float a2v = A::add(A::add(A::mul(va2[r], vc[r]), A::mul(vb2[r], vc[r + 1])),
                               A::mul(vc2[r], vc[r + 2]));
      vrhs[r * pc + jc] = A::sub(y1col[r * L.cols + jc], A::mul(td, a2v));
    }
    __syncthreads();
    // the v-sweeps (the pinned columns' too: their values are not kept)
    if (v_warp) {
      tri::rhs_chain(n_v, tri::col<float>(vlo, 0, 1), tri::col<float>(vrhs, vs_, pc),
                     tri::col<float>(vden, 0, 1), tri::col<float>(vrcp, 0, 1), v_out);
      if (sys < nc) tri::back_sweep(n_v, tri::col<float>(vcs, 0, 1), v_out, v_out);
    }
    __syncthreads();
    // the new grid, pinned, recorded and projected
    const bool proj = projects(a.mode, k, a.spd, a.n_t);
    const bool record = proj && a.mode == kBermudan;
    for (int e = tid; e < n_v * nc; e += kClusterThreads) {
      const int r = e / nc;
      const int jc = e - r * nc;
      const int c = c0 + jc;
      const int64_t g = static_cast<int64_t>(r) * n_x + c;
      float vp = c == 0 ? blo : (c == n_x - 1 ? bhi : vds[r * pc + jc]);
      if (a.history) st(a.y2buf + k * n + g, vp);
      if (record) st(a.cont + (a.n_dates - 1 - k / a.spd) * n + g, vp);
      if (proj) vp = A::max(vp, icol[jc * n_v + r]);
      vcol[jc * hv + r + 1] = vp;
      if (k + 1 == a.n_t) {
        st(a.out + g, vp);
      } else if (a.history) {
        st(a.vbuf + (k + 1) * n + g, vp);
      }
    }
    __syncthreads();
    // its columns of each CTA's rows and halo rows to that CTA, four columns
    // a lane (the band's columns past the grid are vcol's zeros)
    if (k + 1 < a.n_t) {
      for (int e = tid; e < ctas * (L.rows + 2) * quads; e += kClusterThreads) {
        const int dl = e / quads;
        const int jc = (e - dl * quads) * 4;
        const int d = dl / (L.rows + 2);
        const int li = dl - d * (L.rows + 2);
        const int r = d * L.rows - 1 + li;
        if (r < 0 || r >= n_v) continue;
        const float* vc = vcol + jc * hv + r + 1;
        st_remote4(peers[d], L.vrow + static_cast<int64_t>(li) * wx + c0 + jc + 4,
                   make_float4(vc[0], vc[hv], vc[2 * hv], vc[3 * hv]));
      }
    }
    cluster_barrier();  // also: no CTA exits while another may write to it
  }
}

// ---------------------------------------------------------------------------
// The reverse loop
// ---------------------------------------------------------------------------

struct AdjointArgs {
  const float* a1;  // the forward's operands, as in AdiArgs
  const float* b1;
  const float* c1;
  const float* lo1;
  const float* di1;
  const float* up1;
  const float* a2;
  const float* b2;
  const float* c2;
  const float* lo2;
  const float* di2;
  const float* up2;
  const float* mc;
  const float* scal;
  const float* intr;
  const float* vin;   // (n_t, n_v, n_x) each step's input grid
  const float* y1h;   // (n_t, n_v, n_x) each step's x-sweep solution
  const float* vph;   // (n_t, n_v, n_x) each step's new grid before the projection
  const float* gout;  // (n_v, n_x) the gradient of the final grid
  float* g_a1;        // (n_v, n_x) gradients of the x tables
  float* g_b1;
  float* g_c1;
  float* g_lo1;
  float* g_di1;
  float* g_up1;
  float* p_a2;  // (n_v) a row's sums over its columns and the steps
  float* p_b2;
  float* p_c2;
  float* p_lo2;  // (n_x, n_v) a column's terms summed over the steps
  float* p_di2;
  float* p_up2;
  float* p_mc;   // (n_v)
  float* p_dts;  // (n_v) Σ g_y0 · s, a row's
  float* p_td1;  // (n_v) Σ g_y0 · a1v, a row's
  float* p_td2;  // (n_v) Σ λ2 · a2v, a row's
  float* p_b1;   // (n_t, n_v, 2) λ1 at the pinned ends, by step and row
  float* p_bv;   // (n_t, 2) the new grid's pinned columns, by step
  float* g_intr;   // (n_v, n_x)
  float* g_start;  // (n_v, n_x)
  float* stage;    // cooperative route: (blocks, recv floats) the moves; else null
  int n_v, n_x, n_t, american, blocks;
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

// Sums a row of the reverse kernel keeps over its columns (and the steps):
// Σ λ1·s, Σ λ1·a1v, Σ g_a2v·V at r − 1, r, r + 1, Σ g_s·core, Σ λ2·a2v.
constexpr int kRowSums = 7;

// The planes of one CTA of the reverse kernel (ops/heston_adi.py
// adjoint_layout), in floats, each starting on 16 bytes. CTA b owns variance
// rows [b·rows, (b + 1)·rows) (phase X') and spot columns [b·cols,
// (b + 1)·cols) (phase V', cols a multiple of 4), clipped to the grid.
// The row band, row i of a plane at i·w (w ≥ n_x + 2·kPad, node c at kPad + c):
//   xlo, xden, xcs, xrcp  the adjoint x-sweeps' lower diagonal (up1[c − 1])
//                and tables, formed once;
//   xd, xlam1    the x-sweeps' forward halves d' and their solutions λ1 (on
//                the cooperative route one plane: d', then λ1 over it);
//   vrow         V_k on the rows and a halo row each side, bufs buffers of
//                (rows + 2) × hx (node c at c + 1, zeros beyond the grid);
//   y1row        y1_k on the rows, bufs buffers of rows × hx;
//   ga1          the gradient of a1v, rows × hx;
//   racc         six accumulators a node: g_a1, g_b1, g_c1, g_lo1, g_di1, g_up1;
//   rsum, rpart  kRowSums sums a row over the steps, and a step's by chunk
//                of 32 columns.
// The column band:
//   vlo, vden, vcs, vrcp  the adjoint v-sweep's lower diagonal (up2[r − 1])
//                and tables (n_v + 2·kPad each); vst its stencil a2, b2, c2
//                and the mixed coefficient by row (0 on the edge rows);
//   pcol         the new grid before the projection on the columns, bufs
//                buffers of cols × hv (node r of column jc at jc·hv + r + 1,
//                zeros beyond); icol the exercise value (jc·n_v + r);
//   vrhs, vd, vds  the v-sweeps' right-hand sides, forward halves d' and
//                solutions λ2, node-major (node r of column jc at r·pc + jc,
//                pc = cols | 1; vd over vds on the cooperative route);
//   gedge        the pinned columns' gradient; cacc four accumulators a node
//                (p_lo2, p_di2, p_up2, g_intr; jc·n_v + r);
//   first        a sweep's first node, by system, whose quotient the check
//                found off the division's bits (ints, max(rows, cols)).
// The moves, written by other CTAs (the cooperative route copies them in
// from global memory, the same layout a block):
//   xlam2        λ2 on the band's rows (the x-sweeps' right-hand sides);
//   rl, ga2      the row-local part of V_k's gradient and the gradient of
//                a2v on the columns, n_v × cols; gn the mixed stencil's
//                numerator's, n_v × (cols + 8), column jc at jc + 4 (a halo
//                column each side).
// Then each CTA's window address (the cluster route) and the dump slots.
// A warp walks each plane along its contiguous axis (a row's columns, or a
// column band's row), so no shared-memory load has a bank conflict.
struct AdjointLayout {
  int rows, cols, w, hx, hv, vt, pc, gw, xch, bufs;
  int xlo, xden, xcs, xrcp, xd, xlam1, vrow, y1row, ga1, racc, rsum, rpart;
  int vlo, vden, vcs, vrcp, vst, pcol, icol, vrhs, vd, vds, gedge, cacc, first;
  int recv, xlam2, rl, ga2, gn, recv_end, peers, dump, floats;

  static __host__ __device__ int take(int& at, int n) {
    const int o = at;
    at += round4(n);
    return o;
  }

  // bufs: two history buffers on the cluster route, one on the cooperative
  // (whose blocks' bands are narrower and whose moves go through L2)
  __host__ __device__ AdjointLayout(int n_v, int n_x, int blocks, bool cluster) {
    rows = (n_v + blocks - 1) / blocks;
    cols = ((n_x + blocks - 1) / blocks + 3) / 4 * 4;
    bufs = cluster ? 2 : 1;
    w = round4(n_x + 2 * tri::kPad);
    hx = round4(n_x + 2);
    hv = n_v + 2;
    vt = round4(n_v + 2 * tri::kPad);
    pc = cols | 1;
    gw = cols + 8;
    xch = (n_x + 31) / 32;
    const int rw = rows * w;
    int at = 0;
    xlo = take(at, rw);
    xden = take(at, rw);
    xcs = take(at, rw);
    xrcp = take(at, rw);
    xd = cluster ? take(at, rw) : at;
    xlam1 = take(at, rw);
    vrow = take(at, bufs * (rows + 2) * hx);
    y1row = take(at, bufs * rows * hx);
    ga1 = take(at, rows * hx);
    racc = take(at, 6 * rows * n_x);
    rsum = take(at, kRowSums * rows);
    rpart = take(at, kRowSums * rows * xch);
    vlo = take(at, vt);
    vden = take(at, vt);
    vcs = take(at, vt);
    vrcp = take(at, vt);
    vst = take(at, 4 * n_v);
    pcol = take(at, bufs * cols * hv);
    icol = take(at, cols * n_v);
    vrhs = take(at, vt * pc);
    vd = cluster ? take(at, vt * pc) : at;
    vds = take(at, vt * pc);
    gedge = take(at, 2 * n_v);
    cacc = take(at, 4 * cols * n_v);
    first = take(at, rows > cols ? rows : cols);
    recv = at;
    xlam2 = take(at, rw);
    rl = take(at, n_v * cols);
    ga2 = take(at, n_v * cols);
    gn = take(at, n_v * gw);
    recv_end = at;
    peers = take(at, kMaxCluster);
    dump = take(at, kDumpFloats);
    floats = at;
  }
};

// Barrier 1 of the CTA's threads, by parts: the chain warps arrive when
// their forward halves are stored and go on to the back substitution; the
// other warps wait there and then check the halves.
__device__ __forceinline__ void bar_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// floor(a / b) for 0 ≤ a < 2^20 and 1 ≤ b < 2^20 by a product with inv =
// 1/b formed once: (a + ½)·inv lies at least ½/b from every integer, far
// beyond its rounding error, so the product's floor is the quotient's.
__device__ __forceinline__ int div_small(int a, float inv) {
  return __float2int_rd(__fmul_rn(static_cast<float>(a) + 0.5f, inv));
}

// Eight fixed-order warp sums in nine shuffles: lane l ends with the sum of
// v[(l >> 2) & 7] over the warp's 32 lanes (a halving butterfly: at each
// step a lane keeps half of its values and adds its partner's half; the last
// two steps add pairs). Every lane that ends with a value holds its bits.
__device__ __forceinline__ float warp_sum8(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  float h4[4], h2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float keep = b4 ? v[4 + j] : v[j];
    const float send = b4 ? v[j] : v[4 + j];
    h4[j] = A::add(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float keep = b3 ? h4[2 + j] : h4[j];
    const float send = b3 ? h4[j] : h4[2 + j];
    h2[j] = A::add(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  float h = A::add(b2 ? h2[1] : h2[0], __shfl_xor_sync(0xffffffffu, b2 ? h2[0] : h2[1], 4));
  h = A::add(h, __shfl_xor_sync(0xffffffffu, h, 2));
  return A::add(h, __shfl_xor_sync(0xffffffffu, h, 1));
}

// The value of `v` at this lane and the next three (a quad of columns to one
// 16-byte store). All 32 lanes call it.
__device__ __forceinline__ void quad(float v, float (&out)[4]) {
  out[0] = v;
  out[1] = __shfl_down_sync(0xffffffffu, v, 1);
  out[2] = __shfl_down_sync(0xffffffffu, v, 2);
  out[3] = __shfl_down_sync(0xffffffffu, v, 3);
}

// The reverse recursion of the European or American loop in bands, one CTA
// a band of rows and a band of columns (AdjointLayout), every accumulator in
// the CTA's shared memory for the whole launch, each owned by one thread a
// phase (no atomics): a node's sum runs over the steps in order, a row's over
// fixed chunks in order. Each step k, from the gradient g of V_{k+1}:
//   phase V' (the CTA's columns): g assembled from step k + 1's moves (the
//     row-local part, A2ᵀ·g_a2v and the mixed stencil's transpose, the plain
//     reverse's order), split at the projection, the pinned columns' share
//     of the bounds summed; the adjoint v-sweeps λ2 = T2⁻ᵀ·g on the tables,
//     one lane a column; the v-sweep's gradients; λ2 sent to its rows'
//     owners by 16-byte stores;
//   phase X' (the CTA's rows): the adjoint x-sweeps λ1 = T1⁻ᵀ·λ2 on the
//     tables, one lane a row; the predictor's and the stencils' gradients;
//     g_a2v and the mixed stencil's gradient, then the row-local part of
//     V_k's gradient, sent to the columns' owners (the mixed one with a halo
//     column each side).
// A sweep: the chain warps run the right-hand side's chains unchecked
// (tri::rhs_chain<float, false>) and arrive at barrier 1; the other warps wait
// there, then hold each node to the division's bits (tri::rhs_node_holds)
// while the chain warps substitute back; a sweep with a node off them (where
// a quotient was subnormal, say) runs again on the checked chain from its
// first such node. So every λ has the bits of tri::rhs_chain's solve.
// A move and its barrier: kCluster, a st.shared::cluster store into the
// reader's shared memory and one cluster barrier a phase; else a store to
// the reader's block of a.stage, one grid barrier, and the reader copies its
// block in. The history of step k − 1 loads by 4-byte cp.async while step
// k's x-sweeps run (kCluster: two buffers), or after step k's last read of
// it (one buffer).
template <bool kCluster>
__global__ void __launch_bounds__(kClusterThreads, 1) heston_adi_adjoint_kernel(AdjointArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n_v = a.n_v, n_x = a.n_x, blocks = a.blocks;
  const int64_t n = static_cast<int64_t>(n_v) * n_x;
  const AdjointLayout L(n_v, n_x, blocks, kCluster);
  const int rank = kCluster ? static_cast<int>(cluster_rank()) : static_cast<int>(blockIdx.x);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int R = L.rows, C = L.cols, w = L.w, hx = L.hx, hv = L.hv, pc = L.pc, gw = L.gw;
  const int xch = L.xch;
  const int r0 = rank * R;
  const int nr = max(0, min(R, n_v - r0));
  const int c0 = rank * C;
  const int nc = max(0, min(C, n_x - c0));
  // the column band's nodes: a warp RPW rows at a time, G lanes a row
  // (at least a quad), jc = jl, jl + G, ...
  int G = 4;
  while (G < nc && G < 32) G <<= 1;
  const int RPW = 32 / G;
  const int jl = lane & (G - 1);
  float* xlo = smem + L.xlo + tri::kPad;
  float* xden = smem + L.xden + tri::kPad;
  float* xcs = smem + L.xcs + tri::kPad;
  float* xrcp = smem + L.xrcp + tri::kPad;
  float* xd = smem + L.xd + tri::kPad;
  float* xlam1 = smem + L.xlam1 + tri::kPad;
  float* xlam2 = smem + L.xlam2 + tri::kPad;
  float* ga1 = smem + L.ga1;
  float* racc = smem + L.racc;
  float* rsum = smem + L.rsum;
  float* rpart = smem + L.rpart;
  float* vlo = smem + L.vlo + tri::kPad;
  float* vden = smem + L.vden + tri::kPad;
  float* vcs = smem + L.vcs + tri::kPad;
  float* vrcp = smem + L.vrcp + tri::kPad;
  float* va2 = smem + L.vst;
  float* vb2 = va2 + n_v;
  float* vc2 = vb2 + n_v;
  float* vmc = vc2 + n_v;
  float* icol = smem + L.icol;
  float* vrhs = smem + L.vrhs + tri::kPad * pc;
  float* vd = smem + L.vd + tri::kPad * pc;
  float* vds = smem + L.vds + tri::kPad * pc;
  float* gedge = smem + L.gedge;
  float* cacc = smem + L.cacc;
  int* first = reinterpret_cast<int*>(smem + L.first);
  const float* rl = smem + L.rl;
  const float* ga2 = smem + L.ga2;
  const float* gn = smem + L.gn;
  const void* dump = smem + L.dump;
  unsigned* peers = reinterpret_cast<unsigned*>(smem + L.peers);
  const int rplane = R * n_x;  // a racc plane
  const int cplane = C * n_v;  // a cacc plane
  const int span = L.recv_end - L.recv;  // a block of a.stage

  for (int e = tid; e < L.floats; e += kClusterThreads) smem[e] = 0.0f;
  __syncthreads();
  if (kCluster && tid < blocks) peers[tid] = map_peer(smem, tid);

  // four floats at `offset` into CTA d's layout
  auto put4 = [&](int d, int offset, const float (&v)[4]) {
    const float4 q = make_float4(v[0], v[1], v[2], v[3]);
    if constexpr (kCluster) {
      st_remote4(peers[d], offset, q);
    } else {
      __stcg(reinterpret_cast<float4*>(a.stage + d * span + (offset - L.recv)), q);
    }
  };
  // the barrier after a phase's moves; the cooperative route then copies in
  // its block's part [lo, hi) of the moves
  auto exchange = [&](int lo, int hi) {
    if constexpr (kCluster) {
      cluster_barrier();
    } else {
      cg::this_grid().sync();
      const float4* src = reinterpret_cast<const float4*>(a.stage + rank * span + (lo - L.recv));
      float4* dst = reinterpret_cast<float4*>(smem + lo);
      for (int e = tid; e < (hi - lo) / 4; e += kClusterThreads) dst[e] = __ldcg(src + e);
      __syncthreads();
    }
  };
  // step k's history into buffer `buf`, a warp a row (warps [w0, w0 + nw)):
  // V_k on the rows and their halo rows, y1_k on the rows, the new grid on
  // the columns
  auto issue = [&](int k, int buf, int w0, int nw) {
    const float* vk = a.vin + k * n;
    const float* yk = a.y1h + k * n;
    const float* pk = a.vph + k * n;
    float* vr = smem + L.vrow + buf * (R + 2) * hx;
    float* yr = smem + L.y1row + buf * R * hx;
    float* pcb = smem + L.pcol + buf * C * hv;
    const int halo_rows = nr > 0 ? nr + 2 : 0;
    for (int q = warp - w0; q < halo_rows + nr; q += nw) {
      const bool y1 = q >= halo_rows;
      const int r = y1 ? r0 + q - halo_rows : r0 - 1 + q;
      if (r < 0 || r >= n_v) continue;
      const float* src = (y1 ? yk : vk) + static_cast<int64_t>(r) * n_x;
      float* dst = y1 ? yr + (q - halo_rows) * hx + 1 : vr + q * hx + 1;
      for (int c = lane; c < n_x; c += 32) tri::cp_async(dst + c, src + c);
    }
    for (int r = warp - w0; r < n_v; r += nw) {
      const float* src = pk + static_cast<int64_t>(r) * n_x + c0;
      for (int jc = lane; jc < nc; jc += 32) tri::cp_async(pcb + jc * hv + r + 1, src + jc);
    }
    tri::cp_async_commit();
  };
  // the gradient of V_k at (r, c0 + jc) from step k's moves, in the plain
  // reverse's order
  auto assemble = [&](int r, int jc) {
    const int e = r * C + jc;
    float vt = A::add(A::mul(vb2[r], ga2[e]), r + 1 < n_v ? A::mul(va2[r + 1], ga2[e + C]) : 0.0f);
    vt = A::add(vt, r > 0 ? A::mul(vc2[r - 1], ga2[e - C]) : 0.0f);
    const float* up = gn + (r - 1) * gw + jc + 4;
    const float* dn = gn + (r + 1) * gw + jc + 4;
    const float ul = r > 0 ? up[-1] : 0.0f, ur = r > 0 ? up[1] : 0.0f;
    const float dl = r + 1 < n_v ? dn[-1] : 0.0f, dr = r + 1 < n_v ? dn[1] : 0.0f;
    const float mt = A::add(A::sub(A::sub(ul, ur), dl), dr);
    return A::add(A::add(rl[e], vt), mt);
  };

  // the operands of the adjoint systems (_TridiagSolve.backward's lower ←
  // upper[c − 1], upper ← lower[c + 1]); the diagonal and the upper wait in
  // xlam1 and xlam2 (vrhs and vds) until the tables are formed
  for (int i = warp; i < nr; i += kClusterWarps) {
    const float* up1 = a.up1 + static_cast<int64_t>(r0 + i) * n_x;
    const float* di1 = a.di1 + static_cast<int64_t>(r0 + i) * n_x;
    const float* lo1 = a.lo1 + static_cast<int64_t>(r0 + i) * n_x;
    for (int c = lane; c < n_x; c += 32) {
      xlo[i * w + c] = c > 0 ? up1[c - 1] : 0.0f;
      xlam1[i * w + c] = di1[c];
      xlam2[i * w + c] = c + 1 < n_x ? lo1[c + 1] : 0.0f;
    }
  }
  for (int r = tid; r < n_v; r += kClusterThreads) {
    vlo[r] = r > 0 ? a.up2[r - 1] : 0.0f;
    vrhs[r * pc] = a.di2[r];
    vds[r * pc] = r + 1 < n_v ? a.lo2[r + 1] : 0.0f;
    va2[r] = a.a2[r];
    vb2[r] = a.b2[r];
    vc2[r] = a.c2[r];
    vmc[r] = r >= 1 && r <= n_v - 2 ? a.mc[r - 1] : 0.0f;
  }
  for (int r = warp; r < n_v; r += kClusterWarps) {
    for (int jc = lane; jc < nc; jc += 32) {
      icol[jc * n_v + r] = a.intr[static_cast<int64_t>(r) * n_x + c0 + jc];
    }
  }
  __syncthreads();
  const int sys = warp < kChainWarps ? tri::spread_system(kChainWarps) : kMaxBand;
  if (sys < nr) {
    tri::form_tables(n_x, tri::col<float>(xlo, sys * w, 1), tri::col<float>(xlam1, sys * w, 1),
                     tri::col<float>(xlam2, sys * w, 1), tri::col<float>(xden, sys * w, 1),
                     tri::col<float>(xcs, sys * w, 1), tri::col<float>(xrcp, sys * w, 1));
  }
  if (tid == kClusterThreads - 1) {
    tri::form_tables(n_v, tri::col<float>(vlo, 0, 1), tri::col<float>(vrhs, 0, pc),
                     tri::col<float>(vds, 0, pc), tri::col<float>(vden, 0, 1),
                     tri::col<float>(vcs, 0, 1), tri::col<float>(vrcp, 0, 1));
  }
  __syncthreads();
  // the staging planes back to zero: a right-hand side's padding is 0
  for (int e = tid; e < R * w; e += kClusterThreads) {
    smem[L.xlam1 + e] = 0.0f;
    smem[L.xlam2 + e] = 0.0f;
  }
  for (int e = tid; e < L.vt * pc; e += kClusterThreads) {
    smem[L.vrhs + e] = 0.0f;
    smem[L.vds + e] = 0.0f;
  }
  issue(a.n_t - 1, (a.n_t - 1) % L.bufs, 0, kClusterWarps);
  __syncthreads();
  if constexpr (kCluster) cluster_barrier();  // every CTA is set before any CTA writes to it

  // the lanes of the solves, as in heston_adi_cluster_kernel
  const bool x_warp = warp < kChainWarps && warp < nr;
  const int xs_ = sys < nr ? sys : (x_warp ? warp : 0);
  const bool v_warp = warp < kChainWarps && warp < nc;
  const int vs_ = sys < nc ? sys : (v_warp ? warp : 0);
  const tri::Col<float> x_out = sys < nr ? tri::col<float>(xd, xs_ * w, 1)
                                         : tri::dump_col<float>(dump);
  const tri::Col<float> v_out = sys < nc ? tri::col<float>(vd, vs_, pc)
                                         : tri::dump_col<float>(dump);
  // a step's row sums into the rows' slots, chunk by chunk in order: the
  // lanes of the warps beside the chains (from `t0` of them)
  auto add_row_sums = [&](int t0, int stride) {
    for (int t = t0; t < kRowSums * nr; t += stride) {
      float s = 0.0f;
      for (int ch = 0; ch < xch; ++ch) s = A::add(s, rpart[t * xch + ch]);
      rsum[t] = A::add(rsum[t], s);
    }
  };

  const float dt = a.scal[0], den = a.scal[1];
  const float td = A::mul(0.5f, dt);
  const float y_den = tri::table_rcp(den, false);
  const float inv_r = 1.0f / R, inv_c = 1.0f / C;  // a band's owner: div_small
  const float inv_xch = 1.0f / xch;
  for (int k = a.n_t - 1; k >= 0; --k) {
    const int buf = k % L.bufs;
    tri::cp_async_wait_all();
    __syncthreads();
    const float* pcb = smem + L.pcol + buf * C * hv;
    for (int jc = tid; jc < nc; jc += kClusterThreads) first[jc] = n_v;

    // phase V': g on the columns, split at the projection
    for (int rb = warp * RPW; rb < n_v; rb += kClusterWarps * RPW) {
      const int r = rb + lane / G;
      for (int jc = jl; jc < nc && r < n_v; jc += G) {
        const int c = c0 + jc;
        float g = k + 1 == a.n_t ? a.gout[static_cast<int64_t>(r) * n_x + c] : assemble(r, jc);
        if (a.american) {  // torch.maximum's derivative: a tie gives half to each side
          const float vp = pcb[jc * hv + r + 1];
          const float it = icol[jc * n_v + r];
          const float split = vp == it ? A::mul(g, 0.5f) : g;
          float* gi = cacc + 3 * cplane + jc * n_v + r;
          if (!(vp > it)) *gi = A::add(*gi, split);
          g = vp < it ? 0.0f : split;
        }
        const bool edge = c == 0 || c == n_x - 1;
        vrhs[r * pc + jc] = edge ? 0.0f : g;
        if (edge) gedge[(c == 0 ? 0 : n_v) + r] = g;
      }
    }
    __syncthreads();
    // the adjoint v-sweeps: the chains' forward halves unchecked into vd;
    // then the chain warps substitute back into vds while the other warps
    // hold every node of vd to the division's bits (before the chains they
    // sum the pinned columns' share of the bounds and step k + 1's rows); a
    // sweep off them runs again from its first such node on the checked
    // chain
    bool miss = false;
    if (warp < kChainWarps) {
      if (v_warp) {
        tri::rhs_chain<float, false>(n_v, tri::col<float>(vlo, 0, 1), tri::col<float>(vrhs, vs_, pc),
                                 tri::col<float>(vden, 0, 1), tri::col<float>(vrcp, 0, 1), v_out);
      }
      bar_arrive(kClusterThreads);
      if (kCluster && v_warp && sys < nc) {
        tri::back_sweep(n_v, tri::col<float>(vcs, 0, 1), v_out, tri::col<float>(vds, vs_, pc));
      }
    } else {
      const int end = warp - kChainWarps;  // warps 4 and 5: the pinned columns
      if (end < 2 && (end == 0 ? c0 == 0 && nc > 0 : c0 <= n_x - 1 && n_x - 1 < c0 + nc)) {
        float part = 0.0f;
        for (int r = lane; r < n_v; r += 32) part = A::add(part, gedge[end * n_v + r]);
        part = warp_sum(part);
        if (lane == 0) a.p_bv[2 * k + end] = part;
      }
      if (k + 1 < a.n_t && warp >= kChainWarps + 2) {
        add_row_sums(tid - 32 * (kChainWarps + 2), kClusterThreads - 32 * (kChainWarps + 2));
      }
      bar_sync(kClusterThreads);
      for (int rb = (warp - kChainWarps) * RPW; rb < n_v; rb += kCheckWarps * RPW) {
        const int r = rb + lane / G;
        for (int jc = jl; jc < nc && r < n_v; jc += G) {
          const float* d = vd + r * pc + jc;
          if (!tri::rhs_node_holds(vlo[r], vrhs[r * pc + jc], vden[r], vrcp[r],
                                   r > 0 ? d[-pc] : 0.0f, d[0])) {
            atomicMin(first + jc, r);
            miss = true;
          }
        }
      }
    }
    if (__syncthreads_or(miss)) {
      if (v_warp) {
        const int j1 = __reduce_min_sync(0xffffffffu, sys < nc ? first[sys] : n_v);
        const tri::Col<float> d = tri::col<float>(vd, vs_, pc);
        if (j1 < n_v) {
          tri::rhs_chain(n_v, tri::col<float>(vlo, 0, 1), tri::col<float>(vrhs, vs_, pc),
                         tri::col<float>(vden, 0, 1), tri::col<float>(vrcp, 0, 1), v_out, j1,
                         j1 > 0 ? d[j1 - 1] : 0.0f);
          if (kCluster && sys < nc) {
            tri::back_sweep(n_v, tri::col<float>(vcs, 0, 1), v_out, tri::col<float>(vds, vs_, pc));
          }
        }
      }
      __syncthreads();
    }
    if (!kCluster) {  // one plane: the back substitution after the check
      if (v_warp && sys < nc) {
        tri::back_sweep(n_v, tri::col<float>(vcs, 0, 1), v_out, tri::col<float>(vds, vs_, pc));
      }
      __syncthreads();
    }
    // the v-sweep's gradients; λ2 to its rows' owners, a quad of columns a
    // 16-byte store
    for (int i = tid; i < nr; i += kClusterThreads) first[i] = n_x;
    for (int rb = warp * RPW; rb < n_v; rb += kClusterWarps * RPW) {
      const int r = rb + lane / G;
      for (int j0 = 0; j0 < nc; j0 += G) {
        const int jc = j0 + jl;
        const int c = c0 + jc;
        const bool live = r < n_v && jc < nc;
        float l = 0.0f;
        if (live && c != 0 && c != n_x - 1) {
          l = vds[r * pc + jc];
          const float* vp = pcb + jc * hv + r;  // the new grid at r − 1, r, r + 1
          float* acc = cacc + jc * n_v + r;
          acc[0] = A::add(acc[0], A::mul(-l, vp[0]));
          acc[cplane] = A::add(acc[cplane], A::mul(-l, vp[1]));
          acc[2 * cplane] = A::add(acc[2 * cplane], A::mul(-l, vp[2]));
        }
        float lq[4];
        quad(l, lq);
        if (live && (jc & 3) == 0) {
          const int d = div_small(r, inv_r);
          put4(d, L.xlam2 + (r - d * R) * w + tri::kPad + c, lq);
        }
      }
    }
    exchange(L.recv, L.rl);

    // phase X': the adjoint x-sweeps, run and checked as the v-sweeps;
    // before the check the other warps load step k − 1's history into the
    // buffer step k + 1 used
    miss = false;
    if (warp < kChainWarps) {
      if (x_warp) {
        tri::rhs_chain<float, false>(n_x, tri::col<float>(xlo, xs_ * w, 1),
                                 tri::col<float>(xlam2, xs_ * w, 1),
                                 tri::col<float>(xden, xs_ * w, 1),
                                 tri::col<float>(xrcp, xs_ * w, 1), x_out);
      }
      bar_arrive(kClusterThreads);
      if (kCluster && x_warp && sys < nr) {
        tri::back_sweep(n_x, tri::col<float>(xcs, xs_ * w, 1), x_out,
                        tri::col<float>(xlam1, xs_ * w, 1));
      }
    } else {
      if (L.bufs == 2 && k > 0) issue(k - 1, (k - 1) & 1, kChainWarps, kCheckWarps);
      bar_sync(kClusterThreads);
      for (int t = warp - kChainWarps; t < nr * xch; t += kCheckWarps) {
        const int i = div_small(t, inv_xch);
        const int c = (t - i * xch) * 32 + lane;
        const int e = i * w + c;
        if (c < n_x && !tri::rhs_node_holds(xlo[e], xlam2[e], xden[e], xrcp[e],
                                            c > 0 ? xd[e - 1] : 0.0f, xd[e])) {
          atomicMin(first + i, c);
          miss = true;
        }
      }
    }
    if (__syncthreads_or(miss)) {
      if (x_warp) {
        const int j1 = __reduce_min_sync(0xffffffffu, sys < nr ? first[sys] : n_x);
        const tri::Col<float> d = tri::col<float>(xd, xs_ * w, 1);
        if (j1 < n_x) {
          tri::rhs_chain(n_x, tri::col<float>(xlo, xs_ * w, 1),
                         tri::col<float>(xlam2, xs_ * w, 1), tri::col<float>(xden, xs_ * w, 1),
                         tri::col<float>(xrcp, xs_ * w, 1), x_out, j1,
                         j1 > 0 ? d[j1 - 1] : 0.0f);
          if (kCluster && sys < nr) {
            tri::back_sweep(n_x, tri::col<float>(xcs, xs_ * w, 1), x_out,
                            tri::col<float>(xlam1, xs_ * w, 1));
          }
        }
      }
      __syncthreads();
    }
    if (!kCluster) {
      if (x_warp && sys < nr) {
        tri::back_sweep(n_x, tri::col<float>(xcs, xs_ * w, 1), x_out,
                        tri::col<float>(xlam1, xs_ * w, 1));
      }
      __syncthreads();
    }
    // the predictor's and the stencils' gradients; a warp 32 columns of a
    // row; g_a2v and the mixed gradient to the columns' owners
    const float* vrb = smem + L.vrow + buf * (R + 2) * hx;
    const float* y1b = smem + L.y1row + buf * R * hx;
    for (int i = 0; i < nr; ++i) {
     for (int ch = (warp - i * xch) & (kClusterWarps - 1); ch < xch; ch += kClusterWarps) {
      const int c = ch * 32 + lane;
      const int r = r0 + i;
      const bool mid_row = r >= 1 && r <= n_v - 2;
      float sums[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float g2 = 0.0f, gnv = 0.0f;
      if (c < n_x) {
        const float* v0 = vrb + i * hx + c + 1;  // node c of rows r − 1, r, r + 1
        const float* v1 = v0 + hx;
        const float* v2 = v1 + hx;
        const float* y1 = y1b + i * hx + c + 1;
        const float lam = xlam1[i * w + c];
        float* acc = racc + i * n_x + c;
        acc[3 * rplane] = A::add(acc[3 * rplane], A::mul(-lam, y1[-1]));
        acc[4 * rplane] = A::add(acc[4 * rplane], A::mul(-lam, y1[0]));
        acc[5 * rplane] = A::add(acc[5 * rplane], A::mul(-lam, y1[1]));
        if (c == 0 || c == n_x - 1) {
          a.p_b1[(static_cast<int64_t>(k) * n_v + r) * 2 + (c == 0 ? 0 : 1)] = lam;
          ga1[i * hx + c + 1] = 0.0f;
        } else {
          const int64_t e = static_cast<int64_t>(r) * n_x + c;
          const float vc = v1[0];
          const float a1v =
              A::add(A::add(A::mul(__ldg(a.a1 + e), v1[-1]), A::mul(__ldg(a.b1 + e), vc)),
                     A::mul(__ldg(a.c1 + e), v1[1]));
          const float a2v =
              A::add(A::add(A::mul(va2[r], v0[0]), A::mul(vb2[r], vc)), A::mul(vc2[r], v2[0]));
          float core = 0.0f, a0v = 0.0f, mc = 0.0f;
          if (mid_row) {
            mc = vmc[r];
            core = quo_fixed(A::add(A::sub(A::sub(v2[1], v2[-1]), v0[1]), v0[-1]), den, y_den);
            a0v = A::mul(mc, core);
          }
          const float s = A::add(A::add(a0v, a1v), a2v);
          const float lam2 = xlam2[i * w + c];
          sums[0] = A::mul(lam, s);
          sums[1] = A::mul(lam, a1v);
          sums[6] = A::mul(lam2, a2v);
          const float gs = A::mul(dt, lam);
          const float g1 = A::add(gs, A::mul(-lam, td));
          g2 = A::add(gs, A::mul(-lam2, td));
          ga1[i * hx + c + 1] = g1;
          acc[0] = A::add(acc[0], A::mul(g1, v1[-1]));
          acc[rplane] = A::add(acc[rplane], A::mul(g1, vc));
          acc[2 * rplane] = A::add(acc[2 * rplane], A::mul(g1, v1[1]));
          sums[2] = A::mul(g2, v0[0]);
          sums[3] = A::mul(g2, vc);
          sums[4] = A::mul(g2, v2[0]);
          if (mid_row) {
            sums[5] = A::mul(gs, core);
            gnv = quo_fixed(A::mul(gs, mc), den, y_den);
          }
        }
      }
      const float s = warp_sum8(sums);  // lanes 4j: the sum of sums[j]
      if ((lane & 3) == 0 && (lane >> 2) < kRowSums) {
        rpart[(i * kRowSums + (lane >> 2)) * xch + ch] = s;
      }
      float q2[4], qn[4];
      quad(g2, q2);
      quad(gnv, qn);
      if (c < n_x && (c & 3) == 0) {
        const int d = div_small(c, inv_c);
        const int jc = c - d * C;
        put4(d, L.ga2 + r * C + jc, q2);
        put4(d, L.gn + r * gw + jc + 4, qn);
        if (jc == 0 && d > 0) put4(d - 1, L.gn + r * gw + C + 4, qn);
        if (jc == C - 4 && d + 1 < blocks) put4(d + 1, L.gn + r * gw, qn);
      }
     }
    }
    __syncthreads();
    if (L.bufs == 1 && k > 0) issue(k - 1, 0, 0, kClusterWarps);  // the buffer's last reads are done
    // the row-local part of V_k's gradient: g_y0 + A1ᵀ·g_a1v
    for (int i = 0; i < nr; ++i) {
     for (int ch = (warp - i * xch) & (kClusterWarps - 1); ch < xch; ch += kClusterWarps) {
      const int c = ch * 32 + lane;
      const int r = r0 + i;
      float out = 0.0f;
      if (c < n_x) {
        const int64_t e = static_cast<int64_t>(r) * n_x + c;
        const float* g1 = ga1 + i * hx + c + 1;  // node c
        const bool edge = c == 0 || c == n_x - 1;
        const float xr = c + 1 < n_x ? A::mul(__ldg(a.a1 + e + 1), g1[1]) : 0.0f;
        const float xl = c > 0 ? A::mul(__ldg(a.c1 + e - 1), g1[-1]) : 0.0f;
        const float xt = A::add(A::add(A::mul(__ldg(a.b1 + e), g1[0]), xr), xl);
        out = A::add(edge ? 0.0f : xlam1[i * w + c], xt);
      }
      float q[4];
      quad(out, q);
      if (c < n_x && (c & 3) == 0) {
        const int d = div_small(c, inv_c);
        put4(d, L.rl + r * C + c - d * C, q);
      }
     }
    }
    exchange(L.rl, L.recv_end);
  }

  // the last step's row sums, the gradient of V_0, every slot to global memory
  add_row_sums(tid, kClusterThreads);
  for (int r = warp; r < n_v; r += kClusterWarps) {
    for (int jc = lane; jc < nc; jc += 32) {
      a.g_start[static_cast<int64_t>(r) * n_x + c0 + jc] = assemble(r, jc);
    }
  }
  __syncthreads();
  float* const rout[6] = {a.g_a1, a.g_b1, a.g_c1, a.g_lo1, a.g_di1, a.g_up1};
  for (int e = tid; e < nr * n_x; e += kClusterThreads) {
    const int64_t g = static_cast<int64_t>(r0) * n_x + e;
    for (int j = 0; j < 6; ++j) rout[j][g] = racc[j * rplane + e];
  }
  float* const sout[kRowSums] = {a.p_dts, a.p_td1, a.p_a2, a.p_b2, a.p_c2, a.p_mc, a.p_td2};
  for (int t = tid; t < kRowSums * nr; t += kClusterThreads) {
    sout[t % kRowSums][r0 + t / kRowSums] = rsum[t];
  }
  float* const cout[3] = {a.p_lo2, a.p_di2, a.p_up2};
  for (int e = tid; e < nc * n_v; e += kClusterThreads) {
    const int jc = e / n_v;
    const int r = e - jc * n_v;
    const int64_t slot = static_cast<int64_t>(c0) * n_v + e;
    for (int j = 0; j < 3; ++j) cout[j][slot] = cacc[j * cplane + e];
    a.g_intr[static_cast<int64_t>(r) * n_x + c0 + jc] = cacc[3 * cplane + e];
  }
}

// One launch of `kernel` as one cluster of `ctas` CTAs of kClusterThreads
// threads and `bytes` of shared memory each, refused unless the card can
// hold it (non-portable above 8 CTAs).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int ctas, int64_t bytes, cudaStream_t st,
                           Args... args) {
  cudaError_t err = tri::allow_smem(kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch of the forward cluster kernel on the wrapper's plan
// (cluster_plan).
cudaError_t launch_forward_cluster(const AdiArgs& args, int ctas, cudaStream_t st) {
  const ClusterLayout L(args.n_v, args.n_x, ctas);
  const int64_t bytes = L.floats * static_cast<int64_t>(sizeof(float));
  if (ctas < 2 || ctas > kMaxCluster || bytes > tri::kMaxSmem || L.rows > kMaxBand ||
      L.cols > kMaxBand || (args.slv && L.rows > kMaxSlvBand)) {
    return cudaErrorInvalidValue;
  }
  return launch_cluster(heston_adi_cluster_kernel, ctas, bytes, st, args, ctas);
}

// One cooperative launch of the forward kernel: a warp a system, as many
// CUDA blocks as the larger sweep has systems over kWarps, capped at what
// fits on the card at once (the grid barriers need every block resident).
cudaError_t launch_forward_coop(const AdiArgs& args, int device, cudaStream_t st) {
  const Layout L(args.n_v, args.n_x);
  const int64_t bytes = L.floats * static_cast<int64_t>(sizeof(float));
  if (bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(heston_adi_kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, heston_adi_kernel, kThreads,
                                                      static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  const int want = ((args.n_v > args.n_x ? args.n_v : args.n_x) + kWarps - 1) / kWarps;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  AdiArgs a = args;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(heston_adi_kernel), dim3(blocks),
                                    dim3(kThreads), params, static_cast<size_t>(bytes), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch of the reverse kernel: one cluster of `ctas` CTAs (the
// wrapper's plan, adjoint_cluster_plan), or with ctas 0 one cooperative
// launch of args.blocks blocks (one an SM: the wrapper's count), each refused
// unless its bands fit and the card holds every block at once.
cudaError_t launch_adjoint(AdjointArgs args, int ctas, int device, cudaStream_t st) {
  const bool cluster = ctas != 0;
  if (cluster) args.blocks = ctas;
  const AdjointLayout L(args.n_v, args.n_x, args.blocks, cluster);
  const int64_t bytes = L.floats * static_cast<int64_t>(sizeof(float));
  if (args.blocks < (cluster ? 2 : 1) || (cluster && ctas > kMaxCluster) ||
      bytes > tri::kMaxSmem || L.rows > kMaxBand || L.cols > kMaxBand ||
      (!cluster && !args.stage)) {
    return cudaErrorInvalidValue;
  }
  if (cluster) return launch_cluster(heston_adi_adjoint_kernel<true>, ctas, bytes, st, args);
  auto kernel = heston_adi_adjoint_kernel<false>;
  cudaError_t err = tri::allow_smem(kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kClusterThreads,
                                                      static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  if (args.blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(args.blocks),
                                    dim3(kClusterThreads), params, static_cast<size_t>(bytes), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
T* ptr(const int64_t* ptrs, int i) {
  return reinterpret_cast<T*>(static_cast<intptr_t>(ptrs[i]));
}

}  // namespace
}  // namespace optionslab

// ptrs: 27 device pointers in AdiArgs' order (0 where unused); dims: n_v,
// n_x, n_t, mode (0 European, 1 American, 2 Bermudan), steps a date, SLV
// (0/1), history (0/1), the route: the CTAs of one cluster (2 to 16, the
// wrapper's plan) or 0 for the cooperative kernel. Every array float32 and
// contiguous. Returns a cudaError_t code (0 on success).
extern "C" int heston_adi_launch(const int64_t* ptrs, const int* dims, int device,
                                 void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  AdiArgs a;
  const float** in[] = {&a.a1, &a.b1, &a.c1, &a.lo1, &a.di1, &a.up1, &a.a2, &a.b2, &a.c2,
                        &a.lo2, &a.di2, &a.up2, &a.mc, &a.scal, &a.bounds, &a.intr, &a.start,
                        &a.lev};
  for (int i = 0; i < 18; ++i) *in[i] = ptr<const float>(ptrs, i);
  a.rows = ptr<const int>(ptrs, 18);
  a.v = ptr<const float>(ptrs, 19);
  a.w = ptr<const float>(ptrs, 20);
  a.out = ptr<float>(ptrs, 21);
  a.cont = ptr<float>(ptrs, 22);
  a.vbuf = ptr<float>(ptrs, 23);
  a.y1buf = ptr<float>(ptrs, 24);
  a.y2buf = ptr<float>(ptrs, 25);
  a.xpiv = ptr<float>(ptrs, 26);
  a.n_v = dims[0];
  a.n_x = dims[1];
  a.n_t = dims[2];
  a.mode = dims[3];
  a.spd = dims[4];
  a.slv = dims[5];
  a.history = dims[6];
  const bool shapes = a.n_v >= 3 && a.n_x >= 3 && a.n_t >= 1 && a.mode >= kEuropean &&
                      a.mode <= kBermudan && a.spd >= 1 && a.n_t % a.spd == 0;
  const bool x_side = a.slv ? a.mode == kBermudan && a.lev && a.rows && a.v && a.w
                            : a.a1 && a.mc && a.xpiv;
  const bool ok = shapes && x_side && (a.mode != kBermudan || a.cont) &&
                  (!a.history || a.y2buf) && a.out && a.vbuf && a.y1buf && a.start && a.intr &&
                  a.bounds && a.scal && a.lo2;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.n_dates = a.n_t / a.spd;
  const int ctas = dims[7];
  if (ctas != 0) {
    return static_cast<int>(launch_forward_cluster(a, ctas, static_cast<cudaStream_t>(stream)));
  }
  return static_cast<int>(launch_forward_coop(a, device, static_cast<cudaStream_t>(stream)));
}

// ptrs: 40 device pointers in AdjointArgs' order (the last, the cooperative
// route's staging buffer, 0 on the cluster route); dims: n_v, n_x, n_t,
// American (0/1), the route: the CTAs of one cluster (2 to 16, the wrapper's
// plan) or 0 for the cooperative kernel, and that kernel's blocks. The
// gradient buffers, the slots and the staging buffer zero on entry. Returns a
// cudaError_t code (0 on success).
extern "C" int heston_adi_adjoint_launch(const int64_t* ptrs, const int* dims, int device,
                                         void* stream) {
  using namespace optionslab;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  AdjointArgs a;
  const float** in[] = {&a.a1, &a.b1, &a.c1, &a.lo1, &a.di1, &a.up1, &a.a2, &a.b2, &a.c2,
                        &a.lo2, &a.di2, &a.up2, &a.mc, &a.scal, &a.intr, &a.vin, &a.y1h,
                        &a.vph, &a.gout};
  constexpr int kIn = sizeof(in) / sizeof(in[0]);
  for (int i = 0; i < kIn; ++i) *in[i] = ptr<const float>(ptrs, i);
  float** out[] = {&a.g_a1, &a.g_b1, &a.g_c1, &a.g_lo1, &a.g_di1, &a.g_up1, &a.p_a2, &a.p_b2,
                   &a.p_c2, &a.p_lo2, &a.p_di2, &a.p_up2, &a.p_mc, &a.p_dts, &a.p_td1,
                   &a.p_td2, &a.p_b1, &a.p_bv, &a.g_intr, &a.g_start};
  constexpr int kOut = sizeof(out) / sizeof(out[0]);
  bool ok = true;
  for (int i = 0; i < kIn; ++i) ok = ok && *in[i];
  for (int i = 0; i < kOut; ++i) {
    *out[i] = ptr<float>(ptrs, kIn + i);
    ok = ok && *out[i];
  }
  a.stage = ptr<float>(ptrs, kIn + kOut);
  a.n_v = dims[0];
  a.n_x = dims[1];
  a.n_t = dims[2];
  a.american = dims[3];
  a.blocks = dims[5];
  if (!ok || a.n_v < 3 || a.n_x < 3 || a.n_t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_adjoint(a, dims[4], device, static_cast<cudaStream_t>(stream)));
}
