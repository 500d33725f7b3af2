"""The cash-dividend and local-vol PDE loops on the CPU: one loop call each
(``ops/theta_pde.py`` with a jump table, ``ops/lv_pde.py``) on tables formed
at once, against the host loops they replaced, kept here step by step.

The host loops take the solve as an argument: the loops with a jump table
and the local-vol loops solve by the warp-partitioned solve
(``ops/tridiag.py`` ``warp_solve``, the kernels' ``csrc/warp_tridiag.cuh``),
the dividend PDE without a dividend by Thomas (``fdm_price``'s loop).

* The dividend PDE (``models/dividends.py``): the per-step end values as one
  table and the jump condition as ``models/slv._interp``'s gather table;
  ``fdm_price_discrete_dividends`` bit for bit the host loop, European and
  American, with one and two dividends and none, float32 at 31 × 24, the
  European at 61 × 60 and the American at 41 × 30 (the host's Howard loop
  costs seconds); the loop with its jump table within ``LOOP_RTOL`` of the
  host loop on Thomas's solve; with one dividend against the reference
  ``fdm_price_discrete_dividends`` (a European call and an American put) to
  ``test_torch_dividends.py``'s 2e-5 relative (which holds two). The gather
  table applied by ``apply_jump`` equals ``_interp`` bit for bit, beyond
  the ends and at tied nodes too.
* The local-vol loops (``models/local_vol.py`` ``_lv_solve``,
  ``models/local_vol_american.py`` ``lv_bermudan_slices``): the step tables
  of ``_lv_tables`` equal the per-step diagonals and ends bit for bit (the
  Bermudan put's low end floored at intrinsic, ``_lv_solve``'s not); the
  plain loop ``_lv_plain`` through the public functions bit for bit the host
  loops, European, American and Bermudan, and within ``LOOP_RTOL`` of the
  host loops on Thomas's solve; their agreement with the
  reference is held by ``test_torch_local_vol.py`` (1e-5) and
  ``test_torch_local_vol_american.py``.
"""

import math

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.models import dividends as dv
from optionslab_tpu_torch.models import local_vol as lv
from optionslab_tpu_torch.models import local_vol_american as lva
from optionslab_tpu_torch.models.fdm import _grid, _read_price
from optionslab_tpu_torch.models.slv import _interp, _interp_table
from optionslab_tpu_torch.ops import lv_pde
from optionslab_tpu_torch.ops import theta_pde as tp
from optionslab_tpu_torch.ops.tridiag import tridiag_solve, warp_solve
from optionslab_tpu_torch.utils.config import EPS_TIME

# the loops on the warp-partitioned solve against the host loops on Thomas's,
# relative to the largest value: each solve within 128 ε of the largest |x|
# (tests/test_torch_warp_solve.py), and the stable implicit steps carry no
# more than a few solves' rounding forward (measured ≤ 1.8e-6 in float32, a
# Bermudan slice at 101 × 48)
LOOP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The host loops the loop calls replaced, step by step
# ---------------------------------------------------------------------------

def _div_host_loop(spot, strike, maturity, rate, vol, div_amounts, *, cp, n_space, n_time,
                   american, div_steps, solve=tridiag_solve):
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).reshape(1)  # noqa: E731
    spot, strike, maturity, rate, vol = map(f32, (spot, strike, maturity, rate, vol))
    t = torch.clamp_min(maturity, EPS_TIME)
    x, dx = _grid(spot, vol, maturity, n_space, 7.0, strike)
    s_nodes = torch.exp(x)
    dt = t / n_time
    sig2 = vol * vol
    mu = rate - 0.5 * sig2
    theta_s = 0.5
    a = 0.5 * sig2 / dx**2 - 0.5 * mu / dx
    b = -sig2 / dx**2 - rate
    c = 0.5 * sig2 / dx**2 + 0.5 * mu / dx
    intrinsic = torch.clamp_min(cp * (s_nodes - strike), 0.0)
    ones = torch.ones_like(s_nodes)
    edge = torch.zeros_like(s_nodes, dtype=torch.bool)
    edge[:, 0] = edge[:, -1] = True
    lo = torch.where(edge, 0.0, -theta_s * dt * a * ones)
    di = torch.where(edge, 1.0, 1.0 - theta_s * dt * b * ones)
    up = torch.where(edge, 0.0, -theta_s * dt * c * ones)
    amounts = [float(d) for d in div_amounts]
    div_at = dict(zip(div_steps, amounts))
    div_t = [t - dt * (k + 1.0) for k in div_steps]
    w = (1.0 - theta_s) * dt
    v = intrinsic
    ends = []
    for k in range(n_time):
        tau = (k + 1.0) * dt
        rhs = v + w * (a * torch.roll(v, 1, dims=1) + b * v + c * torch.roll(v, -1, dims=1))
        t_now = t - tau
        rem = 0.0
        for td, amt in zip(div_t, amounts):
            rem = rem + torch.where(td > t_now, amt * torch.exp(-rate * (td - t_now)), 0.0)
        low = (0.0 if cp > 0 else strike * torch.exp(-rate * tau) - (s_nodes[:, 0] - rem)) + \
            torch.zeros_like(tau)
        high = (s_nodes[:, -1] - rem - strike * torch.exp(-rate * tau) if cp > 0 else 0.0) + \
            torch.zeros_like(tau)
        if american:
            low = torch.maximum(low, intrinsic[:, 0])
            high = torch.maximum(high, intrinsic[:, -1])
        ends.append(torch.cat([torch.clamp_min(low, 0.0), torch.clamp_min(high, 0.0)]))
        rhs = torch.cat([torch.clamp_min(low, 0.0)[:, None], rhs[:, 1:-1],
                         torch.clamp_min(high, 0.0)[:, None]], dim=1)
        if american:
            v = torch.maximum(tp._howard(lo, di, up, rhs, intrinsic, solve)[0], intrinsic)
        else:
            v = solve(lo, di, up, rhs)
        d = div_at.get(k, 0.0)
        if d > 0.0:
            s_shift = torch.clamp_min(s_nodes[0] - d, s_nodes[0, 0])
            v = _interp(s_shift, s_nodes[0], v[0])[None, :]
            if american:
                v = torch.maximum(v, intrinsic)
    return _read_price(v, x, spot)[0], torch.stack(ends)[None]


def _lv_host_steps(k_grid, t_grid, vol_grid, spot, rate, dividend, strike, maturity, cp,
                   n_space, n_time, bermudan):
    """The per-step diagonals and ends of ``_lv_solve`` (``bermudan`` False)
    and ``lv_bermudan_slices`` (True), as their loops formed them."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)  # noqa: E731
    strike, cp = f32(strike), f32(cp)
    t_total = torch.clamp_min(f32(maturity), EPS_TIME)
    sigma_at = lv._sigma_at(k_grid, t_grid, vol_grid, spot, rate, dividend)
    atm_vol = sigma_at(f32(spot), 0.5 * t_total)
    half = 6.0 * torch.clamp_min(atm_vol, 0.1) * torch.sqrt(t_total)
    x = math.log(spot) + torch.linspace(-1.0, 1.0, n_space, dtype=torch.float32) * half
    dx = x[1] - x[0]
    s_nodes = torch.exp(x)
    dt = t_total / n_time
    intrinsic = torch.clamp_min(cp * (s_nodes - strike), 0.0)
    edge = torch.zeros(n_space, dtype=torch.bool)
    edge[0] = edge[-1] = True
    out = []
    for i in range(n_time):
        tau = t_total - (float(i) + 0.5) * dt
        sig = sigma_at(s_nodes, torch.clamp_min(tau, 1e-4))
        sig2 = sig * sig
        mu = rate - dividend - 0.5 * sig2
        a = 0.5 * sig2 / dx**2 - 0.5 * mu / dx
        b = -sig2 / dx**2 - rate
        c = 0.5 * sig2 / dx**2 + 0.5 * mu / dx
        lo = torch.where(edge, 0.0, -dt * a)
        di = torch.where(edge, 1.0, 1.0 - dt * b)
        up = torch.where(edge, 0.0, -dt * c)
        tau_exp = (float(i) + 1.0) * dt
        if bermudan:
            vlo = torch.where(cp > 0, 0.0, torch.maximum(strike * torch.exp(-rate * tau_exp)
                                                         - s_nodes[0], intrinsic[0]))
            vhi = torch.where(cp > 0, s_nodes[-1] * torch.exp(-dividend * tau_exp)
                              - strike * torch.exp(-rate * tau_exp), 0.0)
        else:
            df_exp = strike * torch.exp(-rate * tau_exp)
            vlo = torch.where(cp > 0, 0.0, df_exp - s_nodes[0])
            vhi = torch.where(cp > 0, s_nodes[-1] * torch.exp(-dividend * tau_exp) - df_exp, 0.0)
        out.append((lo, di, up, torch.stack([torch.clamp_min(vlo, 0.0),
                                             torch.clamp_min(vhi, 0.0)])))
    return x, intrinsic, [torch.stack(z) for z in zip(*out)]


def _lv_host_loop(steps, intrinsic, mode, spd, solve=warp_solve):
    """The loops of ``_lv_solve`` (European, American) and
    ``lv_bermudan_slices`` on their per-step operands: (v, slices)."""
    lo, di, up, ends = steps
    v, conts = intrinsic, []
    for i in range(lo.shape[0]):
        rhs = torch.cat([ends[i, 0].reshape(1), v[1:-1], ends[i, 1].reshape(1)])
        v = solve(lo[i][None], di[i][None], up[i][None], rhs[None])[0]
        if mode == "american":
            v = torch.maximum(v, intrinsic)
        elif mode == "bermudan" and (i + 1) % spd == 0 and i + 1 < lo.shape[0]:
            conts.append(v)
            v = torch.maximum(v, intrinsic)
    return v, conts


# ---------------------------------------------------------------------------
# The dividend PDE
# ---------------------------------------------------------------------------

DIV_CASES = {"none": [], "one": [(0.3, 2.0)], "two": [(0.3, 2.0), (0.8, 2.5)]}


@pytest.mark.parametrize("shape", [(31, 24), (61, 60)])
@pytest.mark.parametrize("divs", DIV_CASES)
@pytest.mark.parametrize("american", [False, True])
def test_dividend_loop_equals_the_host_loop(american, divs, shape):
    n_space, n_time = shape
    if american and n_space > 31:
        n_space, n_time = 41, 30  # the host's Howard loop: 8 sweeps a step
    dvs = DIV_CASES[divs]
    steps = dv._div_steps([t for t, _ in dvs], 1.0, n_time)
    amounts = np.asarray([d for _, d in dvs], np.float32)
    cp, strike = (1.0, 95.0) if divs != "one" else (-1.0, 105.0)
    solve = tridiag_solve if divs == "none" else warp_solve  # no dividend: no jump table
    want, want_ends = _div_host_loop(100.0, strike, 1.0, 0.05, 0.2, amounts, cp=cp,
                                     n_space=n_space, n_time=n_time, american=american,
                                     div_steps=steps, solve=solve)
    _, _, ops, jumps = dv._fdm_div_operands(100.0, strike, 1.0, 0.05, 0.2, amounts, cp=cp,
                                            n_space=n_space, n_time=n_time, american=american,
                                            div_steps=steps, device=torch.device("cpu"))
    assert torch.equal(ops[-1], want_ends)
    assert (jumps.steps if jumps else ()) == tuple(k for k, d in zip(steps, amounts) if d > 0)
    got = dv.fdm_price_discrete_dividends(100.0, strike, 1.0, 0.05, 0.2, dvs, cp, american,
                                          n_space, n_time, device="cpu")
    assert got == float(want)


@pytest.mark.parametrize("american", [False, True])
def test_dividend_loop_within_tolerance_of_the_thomas_loop(american):
    """The loop with its jump table (the warp-partitioned solve) against the
    host loop on Thomas's solve: two dividends, a put, 41 × 30."""
    dvs = DIV_CASES["two"]
    steps = dv._div_steps([t for t, _ in dvs], 1.0, 30)
    amounts = np.asarray([d for _, d in dvs], np.float32)
    want = _div_host_loop(100.0, 105.0, 1.0, 0.05, 0.2, amounts, cp=-1.0, n_space=41, n_time=30,
                          american=american, div_steps=steps)[0]
    got = dv.fdm_price_discrete_dividends(100.0, 105.0, 1.0, 0.05, 0.2, dvs, -1.0, american, 41,
                                          30, device="cpu")
    assert abs(got - float(want)) <= LOOP_RTOL * float(want)


ONE_DIV_CASES = [(1.0, 95.0, False), (-1.0, 105.0, True)]


@pytest.fixture(scope="module")
def jax_div_prices():
    jax = pytest.importorskip("jax")
    from optionslab_tpu.models import dividends as jd

    with jax.enable_x64(False):
        return {case: jd.fdm_price_discrete_dividends(
            100.0, case[1], 1.0, 0.05, 0.2, DIV_CASES["one"], case[0], case[2], 41, 40)
            for case in ONE_DIV_CASES}


@pytest.mark.parametrize("case", ONE_DIV_CASES)
def test_one_dividend_matches_reference(jax_div_prices, case):
    cp, strike, american = case
    got = dv.fdm_price_discrete_dividends(100.0, strike, 1.0, 0.05, 0.2, DIV_CASES["one"], cp,
                                          american, 41, 40, device="cpu")
    assert got == pytest.approx(jax_div_prices[case], rel=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_table_equals_interp(dtype):
    rng = np.random.default_rng(7)
    xp = torch.tensor(np.sort(rng.uniform(0.0, 10.0, 33)), dtype=dtype)
    xp[5] = xp[4]  # a tie of nodes
    fp = torch.tensor(rng.normal(size=33), dtype=dtype)
    x = torch.cat([torch.tensor(rng.uniform(-2.0, 12.0, 200), dtype=dtype), xp,
                   xp[4:5], xp[:1] - 1.0, xp[-1:] + 1.0])
    code, weight = _interp_table(x, xp)
    assert code.dtype == torch.int32 and bool((code >= -33).all() and (code <= 31).all())
    got = tp.apply_jump(fp[None].expand(1, 33), code[None], weight[None])
    assert torch.equal(got[0], _interp(x, xp, fp))


def test_theta_loop_with_a_jump_table_takes_no_gradient():
    steps = dv._div_steps([0.3], 1.0, 20)
    _, _, ops, jumps = dv._fdm_div_operands(100.0, 95.0, 1.0, 0.05, 0.2, [2.0], cp=1.0,
                                            n_space=21, n_time=20, american=False,
                                            div_steps=steps, device=torch.device("cpu"))
    ops = list(ops)
    ops[0] = ops[0].clone().requires_grad_(True)
    with pytest.raises(ValueError, match="takes no gradient"):
        tp.theta_loop(*ops, tp.EUROPEAN, jumps=jumps)
    with torch.no_grad():
        assert tp.theta_loop(*ops, tp.EUROPEAN, jumps=jumps).shape == (1, 21)


# ---------------------------------------------------------------------------
# The local-vol loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smile():
    dup = lv.DupireLocalVol(lv.sample_smile_iv_fn(), 100.0, 0.05, n_k=41, n_t=20, device="cpu")
    s = dup.surface
    return s.k_grid, s.t_grid, s.grid


@pytest.mark.parametrize("bermudan", [False, True])
@pytest.mark.parametrize("cp,strike", [(1.0, 105.0), (-1.0, 110.0)])
def test_step_tables_equal_the_per_step_ones(smile, bermudan, cp, strike):
    args = (*smile, 100.0, 0.05, 0.01, strike, 1.3, cp, 61, 37)
    x, intrinsic, lo, di, up, ends = lv._lv_tables(*args, bermudan)
    hx, h_intr, (h_lo, h_di, h_up, h_ends) = _lv_host_steps(*args, bermudan)
    for got, want in ((x, hx), (intrinsic, h_intr), (lo, h_lo), (di, h_di), (up, h_up),
                      (ends, h_ends)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("cp,strike", [(1.0, 100.0), (-1.0, 110.0)])
def test_lv_solve_equals_the_host_loop(smile, american, cp, strike):
    args = (*smile, 100.0, 0.05, 0.0, strike, 1.0, cp, 101, 50)
    _, intrinsic, steps = _lv_host_steps(*args, False)
    want, _ = _lv_host_loop(steps, intrinsic, "american" if american else "european", 1)
    got = lv._lv_solve(*args[:9], n_space=101, n_time=50, american=american)
    assert torch.equal(got, want[50])


@pytest.mark.parametrize("mode", ["european", "american", "bermudan"])
def test_lv_loops_within_tolerance_of_the_thomas_loop(smile, mode):
    """The plain loop (the warp-partitioned solve) against the host loop on
    Thomas's solve, every node and every Bermudan slice, a put at 101 × 48."""
    args = (*smile, 100.0, 0.05, 0.01, 110.0, 1.0, -1.0, 101, 48)
    _, intrinsic, steps = _lv_host_steps(*args, mode == "bermudan")
    want, want_conts = _lv_host_loop(steps, intrinsic, mode, 8, tridiag_solve)
    got, conts = lv_pde._lv_plain(*(t[None] for t in (*steps[:3], steps[3], intrinsic,
                                                      intrinsic)),
                                  {"european": lv_pde.EUROPEAN, "american": lv_pde.PROJECTION,
                                   "bermudan": lv_pde.BERMUDAN}[mode], 8)
    scale = float(want.abs().max())
    assert float((got[0] - want).abs().max()) <= LOOP_RTOL * scale
    for i, slice_ in enumerate(want_conts):
        assert float((conts[0, i] - slice_).abs().max()) <= LOOP_RTOL * scale


@pytest.mark.parametrize("n_dates", [1, 2, 5])
def test_bermudan_slices_equal_the_host_loop(smile, n_dates):
    spd, n_space = 4, 81
    args = (*smile, 100.0, 0.05, 0.01, 100.0, 1.0, -1.0, n_space, n_dates * spd)
    hx, intrinsic, steps = _lv_host_steps(*args, True)
    want, conts = _lv_host_loop(steps, intrinsic, "bermudan", spd)
    price0, cont_all, x = lva.lv_bermudan_slices(*args[:9], n_dates, spd, n_space)
    zero = torch.zeros((1, n_space))
    want_all = torch.cat([zero, torch.stack(conts[::-1]), zero]) if conts else \
        torch.cat([zero, zero])
    assert torch.equal(price0, want[n_space // 2]) and torch.equal(x, hx)
    assert cont_all.shape == (n_dates + 1, n_space) and torch.equal(cont_all, want_all)


def test_lv_loop_checks_and_dispatches(smile):
    _, intrinsic, lo, di, up, ends = lv._lv_tables(*smile, 100.0, 0.05, 0.0, 100.0, 1.0, 1.0,
                                                   21, 12, False)
    ops = [t[None] for t in (lo, di, up, ends, intrinsic, intrinsic)]
    v, conts = lv_pde.lv_loop(*ops, lv_pde.BERMUDAN, 4)
    assert v.shape == (1, 21) and conts.shape == (1, 2, 21)
    with pytest.raises(ValueError, match="bad local-vol loop"):
        lv_pde.lv_loop(*ops, lv_pde.BERMUDAN, 5)  # 12 steps are no whole number of dates
    with pytest.raises(ValueError, match="no local-vol time loop for device meta"):
        lv_pde.lv_loop(*(t.to("meta") for t in ops), lv_pde.EUROPEAN)
    with pytest.raises(ValueError, match="CUDA"):  # the kernel's entry never runs the loop
        lv_pde._lv_cuda(*ops, lv_pde.EUROPEAN)
