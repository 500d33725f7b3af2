"""The warp-partitioned tridiagonal solve's plain model
(``optionslab_tpu_torch/ops/tridiag.py`` ``warp_factors``/``warp_solve_rhs``,
the operation order of ``csrc/warp_tridiag.cuh``), on the CPU.

The partition (32 lanes, ⌈n/32⌉ rows a lane, a reduced system of the
lanes' separators solved by cyclic reduction) rounds otherwise than Thomas's
algorithm, so it is held to a tolerance, the only one it has: on every case
below its solution is within ``WARP_RTOL``·ε·max|x| of the plain Thomas solve
(``_tridiag_plain``) and of a float64 dense solve (``numpy.linalg.solve``) of
the same matrix, system by system, float32 and float64 (ε the dtype's). Why
128: both eliminations are backward stable on a diagonally dominant matrix,
so each is within a small multiple of κ·ε of the exact solution; the
measured gaps are at most 18 ε in float32 (the local-vol step at 401 nodes
against Thomas) and 75 ε in float64 (there the float64 dense solve's own
error, against which Thomas is as far).

The cases: the dividend PDE's θ matrix at 401 nodes and at the extreme grids
(σ 0.05 and 1.0 × T 0.02 and 5); the local-vol step tables at 201 and 401
nodes; seeded diagonally dominant systems at n = 3, 31, 33, 64, 65 and 401
(one row a lane and padding, two rows a lane, three); Howard's systems with
identity rows u = ψ: a lane's whole block, a run across a block boundary,
the first and the last interior rows, a block's first and last rows. The
card holds the kernels to this model bit for bit (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.models import dividends as dv
from optionslab_tpu_torch.models import local_vol as lv
from optionslab_tpu_torch.ops import tridiag as tt

WARP_RTOL = 128  # in units of the dtype's ε, of the largest |x| of a system
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(lo, di, up, rhs):
    """The float64 dense solve of each system (numpy, partial pivoting)."""
    out = []
    for b in range(lo.shape[0]):
        mat = np.diag(di[b]) + np.diag(lo[b, 1:], -1) + np.diag(up[b, :-1], 1)
        out.append(np.linalg.solve(mat, rhs[b]))
    return np.array(out)


def _check(lo, di, up, rhs, dtype):
    """The partitioned solve against Thomas and the dense solve, on (B, n)
    float64 arrays rounded to ``dtype``."""
    ops = [torch.as_tensor(np.ascontiguousarray(a)).to(dtype) for a in (lo, di, up, rhs)]
    got = tt.warp_solve(*ops).double().numpy()
    thomas = tt._tridiag_plain(*ops).double().numpy()
    dense = _dense(*(o.double().numpy() for o in ops))
    tol = WARP_RTOL * torch.finfo(dtype).eps * np.abs(dense).max(1, keepdims=True)
    assert np.isfinite(got).all()
    assert (np.abs(got - thomas) <= tol).all()
    assert (np.abs(got - dense) <= tol).all()


def _div_matrix(vol=0.2, maturity=1.0, n=401):
    _, _, ops, _ = dv._fdm_div_operands(100.0, 100.0, maturity, 0.05, vol, [2.0], cp=-1.0,
                                        n_space=n, n_time=400, american=True, div_steps=(0,),
                                        device=CPU)
    return [o.double().numpy() for o in ops[:3]]


def _rhs(batch, n, seed):
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(batch, n))
    out[0] = 50.0 * np.linspace(0.0, 1.0, n) ** 2  # a payoff's scale and shape
    return out


DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vol,maturity", [(0.2, 1.0), (0.05, 0.02), (0.05, 5.0), (1.0, 0.02),
                                          (1.0, 5.0)])
def test_dividend_theta_matrix(vol, maturity, dtype):
    lo, di, up = (np.repeat(a, 3, 0) for a in _div_matrix(vol, maturity))
    _check(lo, di, up, _rhs(3, 401, 1), dtype)


@pytest.fixture(scope="module")
def smile():
    dup = lv.DupireLocalVol(lv.sample_smile_iv_fn(), 100.0, 0.05, n_k=41, n_t=20, device="cpu")
    s = dup.surface
    return s.k_grid, s.t_grid, s.grid


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [201, 401])
def test_local_vol_step_tables(smile, n, dtype):
    _, intr, lo, di, up, _ = lv._lv_tables(*smile, 100.0, 0.05, 0.0, 100.0, 1.0, -1.0, n, 200,
                                           False)
    steps = [0, 100, 199]  # the last step's σ at expiry, the first's at the start
    rhs = np.concatenate([intr[None].double().numpy(), _rhs(2, n, n)])
    _check(*(t[steps].double().numpy() for t in (lo, di, up)), rhs, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 31, 33, 64, 65, 401])
def test_seeded_systems(n, dtype):
    rng = np.random.default_rng(n)
    lo, up = rng.uniform(-1.0, 1.0, (2, 4, n))
    di = 2.5 + rng.uniform(0.0, 1.0, (4, n))
    assert tt.warp_rows(n) == max(2, -(-n // 32))
    _check(lo, di, up, rng.normal(size=(4, n)), dtype)


# Howard's exercised rows (identity rows u = ψ) on the 401-node θ matrix, 13
# rows a lane: lane 1's whole block (rows 13–25), a run across the boundary
# of lanes 1 and 2, the first interior rows (a put's exercise region), the
# last ones (a call's), a block's first row and another's last row alone
EXERCISED = {"block": [(13, 26)], "across": [(20, 33)], "first": [(1, 40)],
             "last": [(300, 400)], "block ends": [(26, 27), (38, 39)]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(EXERCISED))
def test_howard_identity_rows(case, dtype):
    lo, di, up = (np.repeat(a, 2, 0) for a in _div_matrix())
    rhs = _rhs(2, 401, 3)
    psi = np.maximum(100.0 - np.exp(np.linspace(3.0, 6.0, 401)), 0.0)
    for start, stop in EXERCISED[case]:
        lo[:, start:stop], di[:, start:stop], up[:, start:stop] = 0.0, 1.0, 0.0
        rhs[:, start:stop] = psi[start:stop]
    _check(lo, di, up, rhs, dtype)


def test_factors_serve_every_right_hand_side():
    """The factors depend on the matrix alone: a solve on formed factors is
    the whole solve, bit for bit, for each right-hand side."""
    lo, di, up = (torch.tensor(a) for a in _div_matrix(n=201))
    factors = tt.warp_factors(lo, di, up)
    assert factors["m"] == 7 and len(factors["rho"]) == 6 and len(factors["k1"]) == 5
    for seed in (0, 1):
        rhs = torch.tensor(_rhs(1, 201, seed))
        assert torch.equal(tt.warp_solve_rhs(factors, rhs), tt.warp_solve(lo, di, up, rhs))


def test_register_capacity_and_factor_sizes():
    """The kernels' plan (``wtri::register_rows``, ``factor_values``): 8 rows a
    lane in registers up to 256 nodes, 16 in float32 up to 512, else memory."""
    assert [tt.warp_capacity(n, 4) for n in (3, 256, 257, 401, 512, 513)] == [8, 8, 16, 16, 16,
                                                                              0]
    assert [tt.warp_capacity(n, 8) for n in (201, 256, 257, 401)] == [8, 8, 0, 0]
    assert tt.warp_factor_values(13) == (5 * 13 + 13) * 32
