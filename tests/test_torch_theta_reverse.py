"""The reverse of the θ-scheme loop (``optionslab_tpu_torch/ops/theta_pde.py``)
on the CPU.

* The plain reverse (``_theta_reverse_plain``, the recursion written out step
  by step over the forward's history) against autograd through the plain
  loop, for every operand, European, projection and Howard, on 8 contracts
  × 41 nodes × 24 steps: within 1e-12 of each gradient's largest entry in
  float64 and 2e-5 in float32 (the same operations; the sums over nodes and
  steps in another order).
* ``fdm_price``'s gradient through the loop's ``autograd.Function`` (whose
  first-order backward is that reverse on the CPU) against ``jax.grad`` of
  the reference ``fdm_price`` in S, K, T, r, σ and q, in the three modes:
  float64 within 1e-8 of the largest derivative (``test_torch_theta_pde.py``'s
  bound; measured ≤ 2e-14), float32 within 1e-4 (both packages in float32,
  the reference with x64 off, its grid and its loop rounding in their own
  order; measured ≤ 7.2e-6).
* A Howard step that has not reached its fixed point after its 8 sweeps: the
  set the eighth solve ran on differs from the set its residuals then pick;
  the forward keeps the first, and the reverse on it is autograd's, on the
  other not.
* A projection tie (u = ψ exactly): the gradient splits half and half, as
  ``torch.maximum``'s derivative does.
* A second derivative (a graph of the gradient) runs the plain loop again
  under autograd and never the reverse; a first derivative runs the reverse
  and never the plain loop again (counted through wrappers of both).
* The algebra the reverse kernel (``csrc/theta_pde.cu``) solves each step's
  adjoint system by, written out in torch: on hand-built exercise sets the
  runs of continuation rows solved apart, a run that touches row 0 on the
  whole matrix's LU tables and one that touches row n − 1 on its UL tables
  (each formed once), any other run on pivots of its own, each exercised
  row from its own equation; against the plain reverse's solve on the
  masked transposed diagonals within THETA_REVERSE_RTOL (the kernel's
  tolerance on the card).
* The reverse kernel's plan gives every grid the forward takes a route.
"""

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.models import fdm as tf
from optionslab_tpu_torch.ops import theta_pde as tp
from optionslab_tpu_torch.ops.theta_cases import (THETA_REVERSE_RTOL, exercise_sets,
                                                  short_howard_step)
from optionslab_tpu_torch.ops.tridiag import _neighbours, _solve
from optionslab_tpu_torch.types import ContractBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = ("spot", "strike", "maturity", "rate", "vol", "dividend")
MODES = {"european": tp.EUROPEAN, "projection": tp.PROJECTION, "howard": tp.HOWARD}
PLAIN_RTOL = {torch.float64: 1e-12, torch.float32: 2e-5}
JAX_RTOL = {torch.float64: 1e-8, torch.float32: 1e-4}


def _book(n=8, seed=5):
    rng = np.random.default_rng(seed)
    return {"spot": rng.uniform(80, 120, n), "strike": rng.uniform(80, 120, n),
            "maturity": rng.uniform(0.2, 2.0, n), "rate": rng.uniform(0.0, 0.08, n),
            "vol": rng.uniform(0.1, 0.5, n), "dividend": rng.uniform(0.0, 0.04, n),
            "cp": np.where(np.arange(n) % 2 == 0, 1.0, -1.0)}


def _args(book, dtype):
    return [torch.tensor(book[k], dtype=dtype) for k in FIELDS + ("cp",)]


def _gap(got, want) -> float:
    """The largest difference of two gradient lists, each relative to its
    reference gradient's largest entry."""
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
               for g, w in zip(got, want))


def _autograd(ops, mode, g):
    """Autograd through the plain loop, ψ and the initial values distinct
    leaves: the gradients of the ten operands."""
    leaves = [o.detach().clone().requires_grad_(True) for o in ops]
    out = tp._theta_plain(*leaves, mode)
    grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    return [torch.zeros_like(x) if gr is None else gr for gr, x in zip(grads, leaves)], out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_reverse_matches_autograd(mode, dtype):
    _, ops = tf._cn_operands(*_args(_book(), dtype), 41, 24, 0.5, mode != "european")
    g = torch.tensor(np.random.default_rng(1).normal(size=(8, 41)), dtype=dtype)
    want, out = _autograd(ops, MODES[mode], g)
    v, hist_u, hist_m = tp._theta_plain(*ops, MODES[mode], history=True)
    assert torch.equal(v, out.detach()) and hist_u.shape == (8, 24, 41)
    assert (hist_m is None) == (mode != "howard")
    got = tp._theta_reverse_plain(*ops, MODES[mode], hist_u, hist_m, g)
    assert [x.shape for x in got] == [x.shape for x in want]
    assert _gap(got, want) < PLAIN_RTOL[dtype]


def test_function_gives_psi_and_the_initial_values_each_their_part():
    """``_cn_operands`` passes one tensor as ψ and as the initial values: the
    Function's gradient of it is the sum of both parts, as autograd's of the
    plain loop."""
    args = _args(_book(4, seed=2), torch.float64)
    strike = args[1].requires_grad_(True)
    grads = []
    for loop in (tp.theta_loop, tp._theta_plain):
        x, ops = tf._cn_operands(args[0], strike, *args[2:], 21, 12, 0.5, True)
        assert ops[-3] is ops[-2]
        price = tf._read_price(loop(*ops, tp.HOWARD), x, args[0])
        grads.append(torch.autograd.grad(price.sum(), strike)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-12, atol=1e-14)


@pytest.fixture(scope="module")
def jax_fdm_grads():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from optionslab_tpu.models.fdm import fdm_price
    from optionslab_tpu.types import ContractBatch as JBatch

    book = _book(6)
    out = {}
    for dtype, x64 in ((torch.float64, True), (torch.float32, False)):
        with jax.enable_x64(x64):
            jdt = jnp.float64 if x64 else jnp.float32
            cp = jnp.asarray(book["cp"], jdt)
            for mode in MODES:
                def total(*fields, mode=mode):
                    return fdm_price(JBatch(*fields, cp), 41, 20, american=mode != "european",
                                     american_method="projection" if mode == "projection"
                                     else "policy").sum()

                grads = jax.grad(total, argnums=tuple(range(6)))(
                    *(jnp.asarray(book[f], jdt) for f in FIELDS))
                out[dtype, mode] = [np.asarray(g) for g in grads]
    return book, out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gradient_matches_jax_grad(jax_fdm_grads, mode, dtype):
    book, ref = jax_fdm_grads
    args = _args(book, dtype)
    leaves = [a.requires_grad_(True) for a in args[:6]]
    price = tf.fdm_price(ContractBatch(*leaves, args[6]), 41, 20, american=mode != "european",
                         american_method="projection" if mode == "projection" else "policy")
    grads = torch.autograd.grad(price.sum(), leaves)
    for name, got, want in zip(FIELDS, grads, ref[dtype, mode]):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL[dtype],
                                   atol=JAX_RTOL[dtype] * np.abs(want).max(), err_msg=name)


def test_howard_reverse_reads_the_set_of_the_last_solve():
    ops = short_howard_step()
    lo, di, up, psi, ends = ops[0], ops[1], ops[2], ops[7], ops[9]
    rhs = tp.set_ends(ops[8], ends[:, 0, 0], ends[:, 0, 1])
    u, used = tp._howard(lo, di, up, rhs, psi)
    after = ((tp.tridiag_apply(lo, di, up, u) - rhs) > (u - psi))
    after[:, 0] = after[:, -1] = False
    assert int(used.sum()) != int(after.sum())  # not at the fixed point after 8 sweeps
    v, hist_u, hist_m = tp._theta_plain(*ops, tp.HOWARD, history=True)
    assert torch.equal(hist_m[:, 0], used) and torch.equal(hist_u[:, 0], u)
    g = torch.tensor(np.random.default_rng(2).normal(size=(1, 41)))
    want, _ = _autograd(ops, tp.HOWARD, g)
    assert _gap(tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, hist_m, g), want) < 1e-12
    # the set recomputed from the final values gives another gradient
    wrong = tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, after[:, None], g)
    assert _gap(wrong, want) > 1e-3


def test_projection_tie_splits_half_and_half():
    """The identity step (lo = up = 0, di = 1, w = 0) from v0 = ψ: every
    interior node's solution equals ψ exactly, where the clamp's gradient
    goes half to the solution (hence the initial values) and half to ψ."""
    n = 9
    one = torch.ones((2, n), dtype=torch.float64)
    zero = torch.zeros((2, 1), dtype=torch.float64)
    psi = torch.linspace(1.0, 2.0, n, dtype=torch.float64).expand(2, n).contiguous()
    ends = torch.zeros((2, 1, 2), dtype=torch.float64)
    ops = [0.0 * one, one, 0.0 * one, zero, zero, zero, zero, psi, psi.clone(), ends]
    g = torch.tensor(np.random.default_rng(4).normal(size=(2, n)))
    v, hist_u, _ = tp._theta_plain(*ops, tp.PROJECTION, history=True)
    assert torch.equal(hist_u[:, 0, 1:-1], psi[:, 1:-1])  # the ties
    got = tp._theta_reverse_plain(*ops, tp.PROJECTION, hist_u, None, g)
    want, _ = _autograd(ops, tp.PROJECTION, g)
    assert _gap(got, want) < 1e-15
    torch.testing.assert_close(got[7][:, 1:-1], g[:, 1:-1] / 2, rtol=0, atol=0)
    torch.testing.assert_close(got[8][:, 1:-1], g[:, 1:-1] / 2, rtol=0, atol=0)


def test_second_derivative_runs_the_recompute_and_the_first_the_reverse(monkeypatch):
    """Vomma through the Function equals double autograd through the plain
    loop; the first derivative ran the reverse once and the plain loop not
    again, the second the plain loop again (the graph it differentiates)
    and the reverse not."""
    calls = {"reverse": 0, "plain": 0}
    reverse, plain = tp._theta_reverse_plain, tp._theta_plain

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tp, "_theta_reverse_plain", counted("reverse", reverse))
    monkeypatch.setattr(tp, "_theta_plain", counted("plain", plain))
    args = _args(_book(4, seed=2), torch.float64)
    vol = args[4].requires_grad_(True)
    x, ops = tf._cn_operands(*args[:4], vol, *args[5:], 21, 10, 0.5, True)
    price = tf._read_price(tp.theta_loop(*ops, tp.HOWARD), x, args[0])
    assert calls == {"reverse": 0, "plain": 1}  # the forward
    torch.autograd.grad(price.sum(), vol, retain_graph=True)
    assert calls == {"reverse": 1, "plain": 1}
    (vega,) = torch.autograd.grad(price.sum(), vol, create_graph=True)
    assert calls == {"reverse": 1, "plain": 2}
    vomma = torch.autograd.grad(vega.sum(), vol)[0]
    x, ops = tf._cn_operands(*args[:4], vol, *args[5:], 21, 10, 0.5, True)
    price = tf._read_price(plain(*ops, tp.HOWARD), x, args[0])
    (vega_p,) = torch.autograd.grad(price.sum(), vol, create_graph=True)
    torch.testing.assert_close(vomma, torch.autograd.grad(vega_p.sum(), vol)[0], rtol=1e-10,
                               atol=1e-12)
    torch.testing.assert_close(vega, vega_p, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_reverse_tile_fits_every_grid_the_forward_takes(itemsize):
    """Every grid the forward takes with one contract a block gets a route
    of the reverse kernel whose tile fits in a block's shared memory, at
    every batch: the shared route while one contract's whole tile (tables,
    shares and history rows) fits, the device route beyond; so every grid
    that ``fdm_price`` prices on the card also takes a first-order gradient.
    ``fdm_price``'s defaults take the shared route."""
    from optionslab_tpu_torch.ops import tridiag as tt

    longest = 3
    while tp.tile_bytes(longest + 1, 1, itemsize) <= tt.SMEM_LIMIT:
        longest += 1
    assert longest == {4: 4722, 8: 2377}[itemsize]
    assert tp.adjoint_plan(256, 201, itemsize, 132) == (2, False)
    routes = set()
    for n in (*range(3, 200), *range(200, longest + 1, 37), longest):
        for batch in (1, 256, 4096):
            systems, device = tp.adjoint_plan(batch, n, itemsize, 132)
            assert tp.adjoint_tile_bytes(n, systems, itemsize, device) <= tt.SMEM_LIMIT
            assert device == (tp.adjoint_tile_bytes(n, 1, itemsize) > tt.SMEM_LIMIT)
            routes.add(device)
    assert routes == {False, True}
    runs = 8 * ((longest + 1) // 2)  # up to ⌈n / 2⌉ runs of two ints, after a count
    row = (-(-longest // (16 // itemsize)) | 1) * (16 // itemsize)  # odd 16-byte units
    assert row == tp.adjoint_row(longest, itemsize) and row * itemsize % 32 == 16
    values = 10 * row + 4 + 4 * 128  # ten rows, a, b, c, w, the threads' shares
    assert tp.adjoint_tile_bytes(longest, 1, itemsize, True) == \
        -(-(values * itemsize) // 8) * 8 + 8 + runs


def _factors(lo, di, up):
    """The kernel's tables of one contract's columns (``form_factors``): at
    node j, −c'_{j−1}, r_j = 1/den_j and −m_j = −lo_{j+1}·r_j, den_j the
    pivot with the solve's guard."""
    n = di.shape[0]
    z, r, m = (torch.zeros_like(di) for _ in range(3))
    c = torch.zeros((), dtype=di.dtype)
    for j in range(n):
        den = di[j] - lo[j] * c
        den = torch.where(den.abs() < 1e-30, torch.sign(den) * 1e-30 + 1e-30, den)
        z[j], r[j] = -c, 1 / den
        m[j] = -lo[j + 1] * r[j] if j + 1 < n else 0.0
        c = up[j] / den
    return z, r, m


def _solve_by_runs(lo, di, up, ex, g):
    """λ of Aᵀλ = g for one contract, A with the rows ``ex`` exercised
    (identity rows), the kernel's way: the runs of continuation rows apart,
    each a forward sweep z_j = g_j − c'_{j−1}·z_{j−1} and a back sweep
    λ_j = z_j·r_j − m_j·λ_{j+1} on tables (the whole matrix's LU tables for a
    run at row 0, its UL tables mirrored for a run at row n − 1, its own
    pivots for any other); then each exercised row from its own equation."""
    n = g.shape[0]
    lu = _factors(lo, di, up)
    ul = [t.flip(0) for t in _factors(up.flip(0), di.flip(0), lo.flip(0))]
    cont = [j for j in range(n) if not ex[j]]
    runs = [[j] for j in cont[:1]]
    for j in cont[1:]:
        if j == runs[-1][-1] + 1:
            runs[-1].append(j)
        else:
            runs.append([j])
    lam = g.clone()
    for run in runs:
        a, b = run[0], run[-1]
        if a == 0:
            (z, r, m), order = lu, run
        elif b == n - 1:
            (z, r, m), order = ul, run[::-1]
        else:
            z, r, m = (torch.zeros_like(g) for _ in range(3))
            z[a:b + 1], r[a:b + 1], m[a:b + 1] = _factors(lo[a:b + 1], di[a:b + 1], up[a:b + 1])
            order = run
        y, acc = torch.zeros_like(g), 0.0
        for j in order:
            acc = z[j] * acc + g[j]
            y[j] = acc * r[j]
        acc = 0.0
        for j in order[::-1]:
            acc = m[j] * acc + y[j]
            lam[j] = acc
    for e in np.flatnonzero(ex):
        if e > 0 and not ex[e - 1]:
            lam[e] = lam[e] - up[e - 1] * lam[e - 1]
        if e < n - 1 and not ex[e + 1]:
            lam[e] = lam[e] - lo[e + 1] * lam[e + 1]
    return lam


SETS = [*exercise_sets(41), "short of the fixed point"]


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_adjoint_solve_by_runs_matches_the_plain_solve(name, dtype):
    """The kernel's way of solving a step's masked adjoint system against
    the plain reverse's solve on the masked transposed diagonals, on
    ``fdm_price``'s American operands (three contracts, 41 nodes) with each
    hand-built exercise set, and on the Howard step whose eight sweeps stop
    short of their fixed point with the set its last solve ran on."""
    if name == "short of the fixed point":
        ops = short_howard_step(dtype)
        lo, di, up, psi, ends = ops[0], ops[1], ops[2], ops[7], ops[9]
        rhs = tp.set_ends(ops[8], ends[:, 0, 0], ends[:, 0, 1])
        _, ex = tp._howard(lo, di, up, rhs, psi)
    else:
        _, ops = tf._cn_operands(*_args(_book(3), dtype), 41, 4, 0.5, True)
        lo, di, up = ops[:3]
        ex = torch.tensor(exercise_sets(41)[name]).expand(lo.shape)
    g = torch.tensor(np.random.default_rng(6).normal(size=tuple(lo.shape)), dtype=dtype)
    lo_m, di_m, up_m = (torch.where(ex, 0.0, lo), torch.where(ex, 1.0, di),
                        torch.where(ex, 0.0, up))
    lo_t, _ = _neighbours(up_m)
    _, up_t = _neighbours(lo_m)
    want = _solve(lo_t, di_m, up_t, g)
    got = torch.stack([_solve_by_runs(lo[b], di[b], up[b], ex[b].numpy(), g[b])
                       for b in range(lo.shape[0])])
    assert _gap([got], [want]) < THETA_REVERSE_RTOL[dtype]
