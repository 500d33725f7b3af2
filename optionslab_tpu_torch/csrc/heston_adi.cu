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
// sweep) its pivots are formed once and a solve is the right-hand side's
// chain and the back substitution (tridiag.cu's right-hand-side probe); the
// SLV x-sweep re-forms its pivots every step (the pivot probe). The bytes
// (three 81 KB grids a step at 101 × 201) stay on chip.
//
// What the design does about it. Two routes of the forward loop, chosen by
// the wrapper from the grid's shape (ops/heston_adi.py cluster_plan):
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
//   V, then its sweep), phase V a warp a spot column; the pivots of every
//   fixed sweep formed once (solve_on_pivots: the right-hand side's chain
//   on one lane);
// - the reverse (heston_adi_adjoint_kernel, one cooperative launch): phase
//   V' splits the gradient at the projection and solves each column's
//   adjoint system, phase X' each row's, and forms the row-local part of the
//   previous grid's gradient; the next phase V' adds the v-stencil's and the
//   mixed stencil's transposes from its column. Every accumulator belongs to
//   one warp (a row's, a column's or a step's slot), so the sums run in a
//   fixed order and the wrapper sums the slots.
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

// Shared memory of a CUDA block, in floats (ops/heston_adi.py smem_bytes):
// three block-wide v-sweep planes, then per warp six solve planes (lower,
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
    floats = 3LL * vplane + kWarps * per_warp;
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
  float* base = smem + 3 * L.vplane + warp * L.per_warp;
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
__device__ __forceinline__ void acc(float* p, float v) { st(p, A::add(ld(p), v)); }

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

// The pivots of one system, formed once where its matrix never changes:
// den_j = guard(b_j − a_j·c'_{j−1}) and c'_j = c_j / den_j, the pivot lane's
// chain of tri::forward_split (the guard taken wherever it changes nothing).
// Lane 0; all lanes call it.
__device__ void pivots(const float* lo, const float* di, const float* up, float* den, float* cs,
                       int n) {
  if ((threadIdx.x & 31) == 0) {
    float c = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float u = tri::guard_pivot(A::sub(di[j], A::mul(lo[j], c)));
      c = tri::quotient(up[j], u);
      den[j] = u;
      cs[j] = c;
    }
  }
  __syncwarp();
}

// The solve on pivots formed once: the right-hand side's chain alone,
// d'_j = (d_j − a_j·d'_{j−1}) / den_j (the partner lane's chain of
// tri::forward_split, without the vote and the shuffle that carry the
// pivots), then the back substitution; the solution lands in t.ds. lo, den
// and rhs are padded after node n − 1 (lower 0, den 1, right-hand side 1).
// Lane 0; all lanes call it.
__device__ void solve_on_pivots(const float* lo, const float* den, const float* cs,
                                const float* rhs, const Tile& t, int n) {
  if ((threadIdx.x & 31) == 0) {
    const tri::Col<float> a = tri::col<float>(lo, 0, 1);
    const tri::Col<float> dn = tri::col<float>(den, 0, 1);
    const tri::Col<float> d = tri::col<float>(rhs, 0, 1);
    const tri::Col<float> x = tri::col<float>(t.ds, 0, 1);
    float prev = 0.0f;
    for (int i0 = 0; i0 < n; i0 += tri::kUnroll) {
      float ra[tri::kUnroll], rd[tri::kUnroll], rn[tri::kUnroll];
#pragma unroll
      for (int q = 0; q < tri::kUnroll; ++q) {
        ra[q] = a[i0 + q];
        rd[q] = d[i0 + q];
        rn[q] = dn[i0 + q];
      }
#pragma unroll
      for (int q = 0; q < tri::kUnroll; ++q) {
        prev = tri::quotient(A::sub(rd[q], A::mul(ra[q], prev)), rn[q]);
        x.put(i0 + q, prev);
      }
    }
    tri::back_sweep(n, tri::col<float>(cs, 0, 1), x, x);
  }
  __syncwarp();
}

// The pivots of variance row r's x-sweep (with ``transposed`` of its adjoint,
// _TridiagSolve.backward's lower ← upper[c − 1], upper ← lower[c + 1]) into
// den_out and cs_out, (n_v, n_x) each. One warp.
__device__ void x_pivots(const float* lo, const float* di, const float* up, bool transposed,
                         int r, int n_x, const Tile& t, float* den_out, float* cs_out) {
  const int lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(r) * n_x;
  for (int c = lane; c < n_x; c += 32) {
    t.lo[c] = transposed ? (c > 0 ? up[row0 + c - 1] : 0.0f) : lo[row0 + c];
    t.di[c] = di[row0 + c];
    t.up[c] = transposed ? (c + 1 < n_x ? lo[row0 + c + 1] : 0.0f) : up[row0 + c];
  }
  __syncwarp();
  pivots(t.lo, t.di, t.up, t.rhs, t.cs, n_x);
  for (int c = lane; c < n_x; c += 32) {
    st(den_out + row0 + c, t.rhs[c]);
    st(cs_out + row0 + c, t.cs[c]);
  }
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
  float* xpiv;          // Heston: (2, n_v, n_x) the x-sweeps' pivots den and c'
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
    } else {  // the matrix of every step: its lower diagonal and the pivots
      const int64_t e = static_cast<int64_t>(r) * n_x + c;
      a1 = a.a1[e];
      b1 = a.b1[e];
      c1 = a.c1[e];
      t.lo[c] = a.lo1[e];
      t.di[c] = a.xpiv[e];
      t.cs[c] = a.xpiv[cells(a) + e];
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
    solve_on_pivots(t.lo, t.di, t.cs, t.rhs, t, n_x);
  }
  for (int c = lane; c < n_x; c += 32) st(y1 + static_cast<int64_t>(r) * n_x + c, t.ds[c]);
  __syncwarp();
}

// Phase V of step k for spot column c: the v-sweep (none on the pinned
// columns), then the new grid, pinned, recorded and projected.
__device__ void forward_col(const AdiArgs& a, const Tile& t, const float* vs[3], int k, int c,
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
    solve_on_pivots(vs[0], vs[1], vs[2], t.rhs, t, n_v);
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

// The v-sweep's lower diagonal and pivots (with ``transposed`` its adjoint's)
// into the block's three planes, padded; warp 0 of the block, whose solve
// planes hold the diagonal and the upper diagonal meanwhile.
__device__ void stage_v_pivots(float* smem, const Layout& L, const Tile& t, const float* lo,
                               const float* di, const float* up, bool transposed, int n_v) {
  const int lane = threadIdx.x & 31;
  float* vlo = smem + tri::kPad;
  float* vden = vlo + L.vplane;
  float* vcs = vden + L.vplane;
  for (int r = lane; r < n_v; r += 32) {
    vlo[r] = transposed ? (r > 0 ? up[r - 1] : 0.0f) : lo[r];
    t.di[r] = di[r];
    t.up[r] = transposed ? (r + 1 < n_v ? lo[r + 1] : 0.0f) : up[r];
  }
  pad(vlo, 0, n_v, lane);
  pad(vden, 1, n_v, lane);
  __syncwarp();
  pivots(vlo, t.di, t.up, vden, vcs, n_v);
}

__global__ void __launch_bounds__(kThreads) heston_adi_kernel(AdiArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.n_v, a.n_x);
  const int warp = threadIdx.x >> 5;
  const Tile t = warp_tile(smem, L, warp);
  const float* vs[3] = {smem + tri::kPad, smem + L.vplane + tri::kPad,
                        smem + 2 * L.vplane + tri::kPad};
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  // the pivots of the sweeps whose matrix is the same every step: the
  // v-sweep's a CUDA block, the Heston x-sweeps' a warp a row (each warp
  // reads back only its own rows)
  if (warp == 0) stage_v_pivots(smem, L, t, a.lo2, a.di2, a.up2, false, a.n_v);
  if (!a.slv) {
    for (int r = gw; r < a.n_v; r += nw) {
      x_pivots(a.lo1, a.di1, a.up1, false, r, a.n_x, t, a.xpiv, a.xpiv + cells(a));
    }
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
  float* p_td2;  // (n_x) Σ λ2 · a2v, a column's
  float* p_b1;   // (n_t, n_v, 2) λ1 at the pinned ends, by step and row
  float* p_bv;   // (n_t, 2) the new grid's pinned columns, by step
  float* g_intr;   // (n_v, n_x)
  float* g_start;  // (n_v, n_x)
  float* w_gy1;    // work, (n_v, n_x) each: λ2 (the gradient of y1)
  float* w_ga2p;   // −θ·dt·λ2
  float* w_rl;     // the row-local part of the previous grid's gradient
  float* w_ga2;    // the gradient of a2v
  float* w_gn;     // the gradient of the mixed stencil's numerator
  float* xpiv;     // (2, n_v, n_x) the adjoint x-sweeps' pivots den and c'
  int n_v, n_x, n_t, american;
};

// The gradient of V_k at (r, c) from step k's parts: the row-local part,
// A2ᵀ·g_a2v and the mixed stencil's transpose, in the plain reverse's order.
__device__ float assemble(const AdjointArgs& a, int r, int c) {
  const int n_v = a.n_v, n_x = a.n_x;
  const int64_t e = static_cast<int64_t>(r) * n_x + c;
  float vt = A::add(A::mul(a.b2[r], ld(a.w_ga2 + e)),
                    r + 1 < n_v ? A::mul(a.a2[r + 1], ld(a.w_ga2 + e + n_x)) : 0.0f);
  vt = A::add(vt, r > 0 ? A::mul(a.c2[r - 1], ld(a.w_ga2 + e - n_x)) : 0.0f);
  auto gn = [&](int rr, int cc) {
    return rr >= 0 && rr < n_v && cc >= 0 && cc < n_x ? ld(a.w_gn + rr * n_x + cc) : 0.0f;
  };
  const float mt = A::add(A::sub(A::sub(gn(r - 1, c - 1), gn(r - 1, c + 1)), gn(r + 1, c - 1)),
                          gn(r + 1, c + 1));
  return A::add(A::add(ld(a.w_rl + e), vt), mt);
}

// Phase V' of step k for column c: the projection's split, the pinned
// columns' share of the bounds, the column's adjoint v-solve.
__device__ void adjoint_col(const AdjointArgs& a, const Tile& t, const float* vs[3], int k,
                            int c) {
  const int lane = threadIdx.x & 31;
  const int n_v = a.n_v, n_x = a.n_x;
  const int64_t n = static_cast<int64_t>(n_v) * n_x;
  const bool edge = c == 0 || c == n_x - 1;
  const float* vk = a.vin + k * n;
  const float* vpk = a.vph + k * n;
  float part = 0.0f;
  for (int r = lane; r < n_v; r += 32) {
    const int64_t e = static_cast<int64_t>(r) * n_x + c;
    float g = k + 1 == a.n_t ? a.gout[e] : assemble(a, r, c);
    const float vp = vpk[e];
    if (a.american) {  // torch.maximum's derivative: a tie gives half to each side
      const float it = a.intr[e];
      const float split = vp == it ? A::mul(g, 0.5f) : g;
      if (!(vp > it)) acc(a.g_intr + e, split);
      g = vp < it ? 0.0f : split;
    }
    if (edge) {
      part = A::add(part, g);
    } else {
      t.rhs[r] = g;
      t.c[0][r + 1] = vk[e];
      t.c[1][r + 1] = vp;
    }
  }
  if (edge) {
    part = warp_sum(part);
    if (lane == 0) a.p_bv[2 * k + (c == 0 ? 0 : 1)] = part;
    __syncwarp();
    return;
  }
  if (lane == 0) t.c[0][0] = t.c[0][n_v + 1] = t.c[1][0] = t.c[1][n_v + 1] = 0.0f;
  pad(t.rhs, 3, n_v, lane);
  __syncwarp();
  solve_on_pivots(vs[0], vs[1], vs[2], t.rhs, t, n_v);
  const float td = A::mul(0.5f, a.scal[0]);
  const float* vc = t.c[0];
  const float* yc = t.c[1];
  float part_td = 0.0f;
  for (int r = lane; r < n_v; r += 32) {
    const int64_t e = static_cast<int64_t>(r) * n_x + c;
    const float lam = t.ds[r];
    const int64_t slot = static_cast<int64_t>(c) * n_v + r;
    acc(a.p_lo2 + slot, A::mul(-lam, yc[r]));
    acc(a.p_di2 + slot, A::mul(-lam, yc[r + 1]));
    acc(a.p_up2 + slot, A::mul(-lam, yc[r + 2]));
    const float a2v = A::add(A::add(A::mul(a.a2[r], vc[r]), A::mul(a.b2[r], vc[r + 1])),
                             A::mul(a.c2[r], vc[r + 2]));
    part_td = A::add(part_td, A::mul(lam, a2v));
    st(a.w_gy1 + e, lam);
    st(a.w_ga2p + e, A::mul(-lam, td));
  }
  part_td = warp_sum(part_td);
  if (lane == 0) acc(a.p_td2 + c, part_td);
  __syncwarp();
}

// Phase X' of step k for row r: the row's adjoint x-solve, the predictor's
// and the stencils' gradients, the row-local part of V_k's gradient.
__device__ void adjoint_row(const AdjointArgs& a, const Tile& t, int k, int r) {
  const int lane = threadIdx.x & 31;
  const int n_v = a.n_v, n_x = a.n_x;
  const int64_t n = static_cast<int64_t>(n_v) * n_x;
  const int64_t row0 = static_cast<int64_t>(r) * n_x;
  const float* vk = a.vin + k * n;
  const float* y1k = a.y1h + k * n + row0;
  const float dt = a.scal[0], den = a.scal[1];
  const float td = A::mul(0.5f, dt);
  stage_rows(vk, r, n_v, n_x, t, lane);
  float* y1 = t.r[3];
  float* ga1 = t.r[4];
  const int64_t n_piv = static_cast<int64_t>(n_v) * n_x;
  for (int c = lane; c < n_x; c += 32) {
    y1[c + 1] = y1k[c];
    const bool edge = c == 0 || c == n_x - 1;
    t.lo[c] = c > 0 ? a.up1[row0 + c - 1] : 0.0f;  // the transposed system's lower
    t.di[c] = a.xpiv[row0 + c];
    t.cs[c] = a.xpiv[n_piv + row0 + c];
    t.rhs[c] = edge ? 0.0f : ld(a.w_gy1 + row0 + c);
  }
  if (lane == 0) y1[0] = y1[n_x + 1] = ga1[0] = ga1[n_x + 1] = 0.0f;
  pad(t.lo, 0, n_x, lane);
  pad(t.di, 1, n_x, lane);
  pad(t.rhs, 3, n_x, lane);
  __syncwarp();
  solve_on_pivots(t.lo, t.di, t.cs, t.rhs, t, n_x);
  const bool mid_row = r >= 1 && r <= n_v - 2;
  const float mc = mid_row ? a.mc[r - 1] : 0.0f;
  const float a2r = a.a2[r], b2r = a.b2[r], c2r = a.c2[r];
  const float* v0 = t.r[0];
  const float* v1 = t.r[1];
  const float* v2 = t.r[2];
  float s_dts = 0.0f, s_td1 = 0.0f, s_a2 = 0.0f, s_b2 = 0.0f, s_c2 = 0.0f, s_mc = 0.0f;
  for (int c = lane; c < n_x; c += 32) {
    const int64_t e = row0 + c;
    const float lam = t.ds[c];
    acc(a.g_lo1 + e, A::mul(-lam, y1[c]));
    acc(a.g_di1 + e, A::mul(-lam, y1[c + 1]));
    acc(a.g_up1 + e, A::mul(-lam, y1[c + 2]));
    if (c == 0 || c == n_x - 1) {
      a.p_b1[(static_cast<int64_t>(k) * n_v + r) * 2 + (c == 0 ? 0 : 1)] = lam;
      ga1[c + 1] = 0.0f;
      st(a.w_ga2 + e, 0.0f);
      continue;
    }
    const float vc = v1[c + 1];
    const float a1v =
        A::add(A::add(A::mul(a.a1[e], v1[c]), A::mul(a.b1[e], vc)), A::mul(a.c1[e], v1[c + 2]));
    const float a2v =
        A::add(A::add(A::mul(a2r, v0[c + 1]), A::mul(b2r, vc)), A::mul(c2r, v2[c + 1]));
    float core = 0.0f, a0v = 0.0f;
    if (mid_row) {
      core = A::quo(A::add(A::sub(A::sub(v2[c + 2], v2[c]), v0[c + 2]), v0[c]), den);
      a0v = A::mul(mc, core);
    }
    const float s = A::add(A::add(a0v, a1v), a2v);
    s_dts = A::add(s_dts, A::mul(lam, s));
    s_td1 = A::add(s_td1, A::mul(lam, a1v));
    const float gs = A::mul(dt, lam);
    const float g1 = A::add(gs, A::mul(-lam, td));
    const float g2 = A::add(gs, ld(a.w_ga2p + e));
    ga1[c + 1] = g1;
    st(a.w_ga2 + e, g2);
    acc(a.g_a1 + e, A::mul(g1, v1[c]));
    acc(a.g_b1 + e, A::mul(g1, vc));
    acc(a.g_c1 + e, A::mul(g1, v1[c + 2]));
    s_a2 = A::add(s_a2, A::mul(g2, v0[c + 1]));
    s_b2 = A::add(s_b2, A::mul(g2, vc));
    s_c2 = A::add(s_c2, A::mul(g2, v2[c + 1]));
    if (mid_row) {
      s_mc = A::add(s_mc, A::mul(gs, core));
      st(a.w_gn + e, A::quo(A::mul(gs, mc), den));
    }
  }
  __syncwarp();
  // the row-local part: g_y0 + A1ᵀ·g_a1v
  for (int c = lane; c < n_x; c += 32) {
    const int64_t e = row0 + c;
    const bool edge = c == 0 || c == n_x - 1;
    const float xr = c + 1 < n_x ? A::mul(a.a1[e + 1], ga1[c + 2]) : 0.0f;
    const float xl = c > 0 ? A::mul(a.c1[e - 1], ga1[c]) : 0.0f;
    const float xt = A::add(A::add(A::mul(a.b1[e], ga1[c + 1]), xr), xl);
    st(a.w_rl + e, A::add(edge ? 0.0f : t.ds[c], xt));
  }
  const float sums[6] = {warp_sum(s_dts), warp_sum(s_td1), warp_sum(s_a2), warp_sum(s_b2),
                         warp_sum(s_c2), warp_sum(s_mc)};
  if (lane == 0) {
    acc(a.p_dts + r, sums[0]);
    acc(a.p_td1 + r, sums[1]);
    acc(a.p_a2 + r, sums[2]);
    acc(a.p_b2 + r, sums[3]);
    acc(a.p_c2 + r, sums[4]);
    if (mid_row) acc(a.p_mc + r, sums[5]);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) heston_adi_adjoint_kernel(AdjointArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.n_v, a.n_x);
  const int warp = threadIdx.x >> 5;
  const Tile t = warp_tile(smem, L, warp);
  const float* vs[3] = {smem + tri::kPad, smem + L.vplane + tri::kPad,
                        smem + 2 * L.vplane + tri::kPad};
  const int64_t n = static_cast<int64_t>(a.n_v) * a.n_x;
  const int gw = blockIdx.x * kWarps + warp;
  const int nw = gridDim.x * kWarps;
  // the adjoint systems' pivots, formed once (see heston_adi_kernel)
  if (warp == 0) stage_v_pivots(smem, L, t, a.lo2, a.di2, a.up2, true, a.n_v);
  for (int r = gw; r < a.n_v; r += nw) {
    x_pivots(a.lo1, a.di1, a.up1, true, r, a.n_x, t, a.xpiv, a.xpiv + n);
  }
  __syncthreads();
  for (int k = a.n_t - 1; k >= 0; --k) {
    for (int c = gw; c < a.n_x; c += nw) adjoint_col(a, t, vs, k, c);
    grid.sync();
    for (int r = gw; r < a.n_v; r += nw) adjoint_row(a, t, k, r);
    grid.sync();
  }
  for (int64_t e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    const int r = static_cast<int>(e / a.n_x);
    st(a.g_start + e, assemble(a, r, static_cast<int>(e - static_cast<int64_t>(r) * a.n_x)));
  }
}

// One launch of the cluster kernel: one cluster of `ctas` CTAs (the
// wrapper's plan, cluster_plan), refused unless the card can hold it.
cudaError_t launch_cluster(const AdiArgs& args, int ctas, cudaStream_t st) {
  const ClusterLayout L(args.n_v, args.n_x, ctas);
  const int64_t bytes = L.floats * static_cast<int64_t>(sizeof(float));
  if (ctas < 2 || ctas > kMaxCluster || bytes > tri::kMaxSmem || L.rows > kMaxBand ||
      L.cols > kMaxBand || (args.slv && L.rows > kMaxSlvBand)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = tri::allow_smem(heston_adi_cluster_kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(heston_adi_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  err = cudaOccupancyMaxActiveClusters(&clusters, heston_adi_cluster_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, heston_adi_cluster_kernel, args, ctas);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One cooperative launch of `kernel`: a warp a system, as many CUDA blocks
// as the larger sweep has systems over kWarps, capped at what fits on the
// card at once (the grid barriers need every block resident).
template <typename Args>
cudaError_t launch(void (*kernel)(Args), Args args, int n_v, int n_x, int device,
                   cudaStream_t st) {
  const Layout L(n_v, n_x);
  const int64_t bytes = L.floats * static_cast<int64_t>(sizeof(float));
  if (bytes > tri::kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = tri::allow_smem(kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      static_cast<size_t>(bytes));
  if (err != cudaSuccess) return err;
  const int want = ((n_v > n_x ? n_v : n_x) + kWarps - 1) / kWarps;
  const int blocks = want < per_sm * sms ? want : per_sm * sms;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(kThreads), params, static_cast<size_t>(bytes), st);
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
    return static_cast<int>(launch_cluster(a, ctas, static_cast<cudaStream_t>(stream)));
  }
  return static_cast<int>(launch(heston_adi_kernel, a, a.n_v, a.n_x, device,
                                 static_cast<cudaStream_t>(stream)));
}

// ptrs: 45 device pointers in AdjointArgs' order; dims: n_v, n_x, n_t,
// American (0/1). The gradient buffers and slots zero on entry. Returns a
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
                   &a.p_td2, &a.p_b1, &a.p_bv, &a.g_intr, &a.g_start, &a.w_gy1, &a.w_ga2p,
                   &a.w_rl, &a.w_ga2, &a.w_gn, &a.xpiv};
  constexpr int kOut = sizeof(out) / sizeof(out[0]);
  bool ok = true;
  for (int i = 0; i < kIn; ++i) ok = ok && *in[i];
  for (int i = 0; i < kOut; ++i) {
    *out[i] = ptr<float>(ptrs, kIn + i);
    ok = ok && *out[i];
  }
  a.n_v = dims[0];
  a.n_x = dims[1];
  a.n_t = dims[2];
  a.american = dims[3];
  if (!ok || a.n_v < 3 || a.n_x < 3 || a.n_t < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch(heston_adi_adjoint_kernel, a, a.n_v, a.n_x, device,
                                 static_cast<cudaStream_t>(stream)));
}
