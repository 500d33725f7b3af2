"""The PDE kernels' plans and arithmetic on the CPU, without a card.

* The quotient of the solves on tables formed once (``csrc/tridiag.cuh``
  ``fast_quotient``: the reciprocal RN(1/den), q0 = RN(num·y), the exact
  residual by one FMA and Markstein's correction by another), modelled in
  exact rationals rounded once to float32 and float64, equals IEEE division
  (numpy's and Python's) on seeded pairs over the exponent range and on an
  edge list, wherever the kernel's range check keeps the pair on the fast
  path (a zero numerator's quotient taken as q0, the zero of its sign), and
  so does the flagged pairs' route (``flagged_quotient``: the same operations on a
  numerator scaled by a power of two where its own check allows); the checks
  flag every pair where the correction alone would differ.
* A Howard sweep restarted at the group of rows that holds the first changed
  exercise flag (``csrc/theta_pde.cu``), the rows before it kept from the
  sweep before, equals the full Thomas solve of the plain loop bit for bit,
  modelled with the plain solve's own float32 and float64 operations on
  ``fdm_price``'s default American put (and a call with a dividend, whose
  exercise rows lie at the top of the grid) over a few steps.
* The ADI forward kernel's cluster plan fits 227 KB a CTA and at most 16 CTAs
  at every grid the package and ``chip_smoke.py`` use and sends a larger grid
  to the cooperative kernel; so does the reverse kernel's, whose bands hold
  every accumulator (two grids of the step fit go to its cooperative route,
  one block an SM); the θ-scheme tile counts the tables, and the systems plan
  still halves until it fits.
"""

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.models import fdm
from optionslab_tpu_torch.ops import heston_adi as ha
from optionslab_tpu_torch.ops import theta_pde as tp
from optionslab_tpu_torch.ops import tridiag as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The quotient on a reciprocal
# ---------------------------------------------------------------------------

# precision, least and largest exponent, and the kernel's range check
# (tri::Arith: kDenLo/Hi, kNumLo/Hi, kQuoLo/Hi)
FORMATS = {
    "float32": dict(np=np.float32, p=24, emin=-126, emax=127, den=(2.0 ** -125, 2.0 ** 125),
                    num=(2.0 ** -100, 2.0 ** 126), quo=(2.0 ** -124, 2.0 ** 125),
                    scale=(2.0 ** 64, 2.0 ** -61)),
    "float64": dict(np=np.float64, p=53, emin=-1022, emax=1023, den=(2.0 ** -1021, 2.0 ** 1021),
                    num=(2.0 ** -960, 2.0 ** 1022), quo=(2.0 ** -1020, 2.0 ** 1021),
                    scale=(2.0 ** 512, 2.0 ** -509)),
}


def round_once(x: Fraction, f: dict) -> float:
    """x rounded to nearest, ties to even, in the format ``f`` (subnormals
    and overflow included), as a Python float."""
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    e = max(e, f["emin"])
    ulp = Fraction(2) ** (e - f["p"] + 1)
    m, rem = divmod(x, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and m % 2 == 1):
        m += 1
    value = m * ulp
    if value >= Fraction(2) ** (f["emax"] + 1):
        return sign * math.inf
    return math.copysign(float(value), sign)


def fast_route(a, b, f: dict):
    """(quotient, path) of the solves' route on ``table_rcp(b)``:
    ``fast_quotient`` where its check allows ("fast"), else
    ``flagged_quotient``: the same operations on a·kScale and the result
    times 1/kScale where its check allows ("scaled"), else the division."""
    t = f["np"]
    a, b = t(a), t(b)
    y = t(1) / b if f["den"][0] <= abs(b) <= f["den"][1] else t(math.nan)
    q0 = a * y
    an, aq = abs(a), abs(q0)
    if an <= f["num"][1] and aq <= f["quo"][1] and (
            a == 0 or (an >= f["num"][0] and aq >= f["quo"][0])):
        return (q0 if a == 0 else correction(a, b, y, q0, f)), "fast"
    scale, least = f["scale"]
    a_s = a * t(scale)
    q0 = a_s * y
    an, aq = abs(a_s), abs(q0)
    if f["num"][0] <= an <= f["num"][1] and least <= aq <= f["quo"][1]:
        return correction(a_s, b, y, q0, f) * t(1 / scale), "scaled"
    return a / b, "division"


def fma(x, y, z, f: dict):
    """x·y + z rounded once, an exact zero signed as IEEE rounding to
    nearest signs it (−0 only where x·y and z are both −0)."""
    exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
    if exact != 0:
        return f["np"](round_once(exact, f))
    product_negative = (math.copysign(1.0, x) < 0) != (math.copysign(1.0, y) < 0)
    both = (x == 0 or y == 0) and z == 0 and product_negative and math.copysign(1.0, z) < 0
    return f["np"](-0.0 if both else 0.0)


def correction(a, b, y, q0, f: dict):
    """Markstein's correction: the residual a − b·q0 and q0 + residual·y,
    each an FMA rounded once."""
    return fma(fma(-b, q0, a, f), y, q0, f)


def bits(x, f: dict) -> int:
    return int(np.asarray(x, dtype=f["np"]).view(np.uint32 if f["p"] == 24 else np.uint64))


def edges(f: dict) -> list:
    fi = np.finfo(f["np"])
    tiny = float(fi.tiny)
    ones = [(2.0 - 2.0 ** (1 - f["p"])) * 2.0 ** e for e in (f["emin"] + 2, -40, -1, 0, 1, 40)]
    vals = [0.0, tiny * 2.0 ** (1 - f["p"]), tiny * (1 - 2.0 ** (1 - f["p"])), tiny,
            float(fi.max), float(fi.max) / 2, math.inf, math.nan, 2e-30, 1e-30, 1.0, 3.0, *ones]
    return vals + [-v for v in vals]


def seeded_pairs(f: dict, n: int, seed: int = 0):
    """n pairs a kind: any finite exponent each; a moderate divisor; an
    all-ones significand divisor; quotients at the ends of the range."""
    rng = np.random.default_rng(seed)
    lo, hi = f["emin"], f["emax"]
    sig = lambda k: rng.uniform(1.0, 2.0, k) * rng.choice([-1.0, 1.0], k)  # noqa: E731
    t = f["np"]
    with np.errstate(over="ignore"):
        pairs = [(sig(n) * 2.0 ** rng.integers(lo - f["p"] + 1, hi + 1, n),
                  sig(n) * 2.0 ** rng.integers(lo - f["p"] + 1, hi + 1, n)),
                 (sig(n) * 2.0 ** rng.integers(lo, hi + 1, n),
                  sig(n) * 2.0 ** rng.integers(-20, 21, n)),
                 (sig(n) * 2.0 ** rng.integers(-40, 41, n),
                  (2.0 - 2.0 ** (1 - f["p"])) * 2.0 ** rng.integers(lo, hi, n)
                  * rng.choice([-1.0, 1.0], n))]
        e_den = rng.integers(-60, 61, n)
        off = rng.choice(np.r_[hi - 1:hi + 2, lo - f["p"] - 1:lo + 3], n)
        pairs.append((sig(n) * 2.0 ** np.clip(e_den + off, lo, hi), sig(n) * 2.0 ** e_den))
    return [(t(a), t(b)) for x, y in pairs for a, b in zip(x.astype(t), y.astype(t))]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_quotient_on_a_reciprocal_equals_division_where_checked(fmt):
    f = FORMATS[fmt]
    t = f["np"]
    ordinary = seeded_pairs(f, 600)
    edge = [(t(a), t(b)) for a in edges(f) for b in edges(f)]
    paths = {"fast": 0, "scaled": 0, "division": 0}
    wrong_unchecked = 0
    with np.errstate(all="ignore"):
        for a, b in ordinary + edge:
            want = a / b
            got, path = fast_route(a, b, f)
            paths[path] += 1
            if path != "division":
                assert bits(got, f) == bits(want, f), (a, b, got, want, path)
            elif math.isfinite(a) and math.isfinite(b) and b != 0 and math.isfinite(want):
                # the correction alone, outside the checked ranges
                y = t(1) / b
                alone = correction(a, b, y, a * y, f) if math.isfinite(a * y) else None
                wrong_unchecked += alone is None or bits(alone, f) != bits(want, f)
    # the fast path takes most ordinary pairs, the scaled path some of the
    # rest, and the checks are not idle
    assert paths["fast"] >= 0.6 * len(ordinary) and paths["scaled"] > 0
    assert wrong_unchecked > 0


# ---------------------------------------------------------------------------
# Howard's restarted sweeps
# ---------------------------------------------------------------------------

GROUP = 8  # tri::kUnroll: a restart starts at a group of rows


def _guard(den):
    return torch.where(den.abs() < 1e-30, torch.sign(den) * 1e-30 + 1e-30, den)


def _forward(lo, di, up, rhs, j0, cs, dn, ds):
    """Thomas's forward values from row j0 on, in place over (B, n) c', den
    and d' whose rows before j0 hold the sweep before's: the plain solve's
    operations (ops/tridiag.py _tridiag_plain)."""
    n = di.shape[-1]
    zero = torch.zeros_like(di[:, 0])
    for j in range(j0, n):
        c_prev, d_prev = (cs[:, j - 1], ds[:, j - 1]) if j else (zero, zero)
        den = _guard(di[:, j] - lo[:, j] * c_prev)
        dn[:, j] = den
        cs[:, j] = up[:, j] / den
        ds[:, j] = (rhs[:, j] - lo[:, j] * d_prev) / den


def _back(cs, ds):
    n = cs.shape[-1]
    xs = torch.empty_like(ds)
    x = torch.zeros_like(ds[:, 0])
    for j in range(n - 1, -1, -1):
        x = ds[:, j] - cs[:, j] * x
        xs[:, j] = x
    return xs


def _howard_restarted(lo, di, up, rhs, psi, tables):
    """The kernel's Howard step: the first sweep on the unexercised matrix's
    tables (c', den), each later one restarted at the group that holds the
    tile's first row whose exercise flag changed."""
    cs0, dn0 = tables
    cs, dn, ds = cs0.clone(), dn0.clone(), torch.empty_like(rhs)
    _forward(lo, di, up, rhs, 0, cs.clone(), dn.clone(), ds)  # d' on the tables
    v = _back(cs0, ds)
    m = torch.zeros_like(rhs, dtype=torch.bool)
    interior = torch.ones_like(m)
    interior[:, [0, -1]] = False
    restarts = []
    for _ in range(tp.HOWARD_SWEEPS - 1):
        m_new = ((tt.tridiag_apply(lo, di, up, v) - rhs) > (v - psi)) & interior
        changed = (m_new != m).any(dim=0)
        if not changed.any():
            break
        j0 = int(changed.nonzero()[0]) // GROUP * GROUP
        restarts.append(j0)
        m = m_new
        _forward(torch.where(m, 0.0, lo), torch.where(m, 1.0, di), torch.where(m, 0.0, up),
                 torch.where(m, psi, rhs), j0, cs, dn, ds)
        v = _back(cs, ds)
    return torch.maximum(v, psi), restarts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restarted_howard_sweeps_equal_the_full_solve(dtype):
    # fdm_price's default put (S = K = 100, T = 1, r = 0.05, σ = 0.2) and a
    # call on a 6 % dividend, at fdm_price's 201 nodes and 200 steps
    args = [torch.tensor(v, dtype=dtype) for v in ((100.0, 100.0), (100.0, 100.0), (1.0, 1.0),
                                                   (0.05, 0.05), (0.2, 0.2), (0.0, 0.06),
                                                   (-1.0, 1.0))]
    _, (lo, di, up, a, b, c, w, psi, v, ends) = fdm._cn_operands(*args, 201, 200, 0.5, True)
    lo, di, up, psi, v = (t.expand(2, 201).clone() for t in (lo, di, up, psi, v))
    n = 201
    cs0, dn0, ds = (torch.zeros_like(lo) for _ in range(3))
    _forward(lo, di, up, torch.zeros_like(lo), 0, cs0, dn0, ds)
    want, got = v, v
    restarts = []
    for k in range(4):
        ends_k = ends[:, k:k + 1]
        want = tp._theta_plain(lo, di, up, a, b, c, w, psi, want, ends_k, tp.HOWARD)
        rhs = got + w * (a * torch.roll(got, 1, dims=1) + b * got
                         + c * torch.roll(got, -1, dims=1))
        rhs = tp.set_ends(rhs, ends_k[:, 0, 0], ends_k[:, 0, 1])
        got, r = _howard_restarted(lo, di, up, rhs, psi, (cs0, dn0))
        restarts += r
        assert torch.equal(got, want), k
    assert restarts and max(restarts) > 0 and min(restarts) < n  # the restarts did skip rows


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

# (n_x, n_v): the CPU tests' grid, the defaults of heston_fdm_price and of
# the SLV bracket, chip_smoke.py's step-fit grids
ADI_GRIDS = [(41, 21), (201, 101), (161, 81), (101, 101), (201, 51), (401, 101), (201, 201),
             (301, 61)]


# grids whose reverse bands (every accumulator and two history buffers) no
# cluster of 16 CTAs holds: the reverse takes its cooperative route there
ADI_REVERSE_COOP = [(401, 101), (201, 201)]
H100_SMS = 132


@pytest.mark.parametrize("n_x,n_v,kernel", [pytest.param(*g, "forward", id=f"{g[0]}-{g[1]}")
                                            for g in ADI_GRIDS]
                         + [pytest.param(*g, "reverse", id=f"{g[0]}-{g[1]}-reverse")
                            for g in ADI_GRIDS])
def test_adi_cluster_plan_fits_the_package_grids(n_x, n_v, kernel):
    if kernel == "reverse":
        ctas = ha.adjoint_cluster_plan(n_v, n_x)
        if (n_x, n_v) in ADI_REVERSE_COOP:
            assert ctas == 0
            assert ha.adjoint_bytes(n_v, n_x, ha.MAX_CLUSTER, True) > ha.SMEM_LIMIT
            assert ha.adjoint_bytes(n_v, n_x, H100_SMS, False) <= ha.SMEM_LIMIT
            return
        assert ha.adjoint_bytes(n_v, n_x, ctas, True) <= ha.SMEM_LIMIT
        limit = ha.MAX_BAND
    else:
        ctas = ha.cluster_plan(n_v, n_x)
        assert ha.cluster_bytes(n_v, n_x, ctas) <= ha.SMEM_LIMIT == 227 * 1024
        limit = 64
    assert 2 <= ctas <= ha.MAX_CLUSTER
    rows, cols = -(-n_v // ctas), -(-n_x // ctas)
    assert rows * ctas >= n_v and cols * ctas >= n_x and rows <= limit and cols <= 128


def test_adi_cluster_layout_and_the_cooperative_route():
    # 201 x 101 on 13 CTAs: 8 rows and 16 columns a CTA; in floats V's rows
    # with their halos (13 bands of 16 columns and 4 zeros a row), V, y1 and
    # the exercise value on the columns, nine x-sweep planes of 217 nodes x
    # 9, the v-sweep's four tables of 117 and stencil of 101, two v-sweep
    # planes of 117 x 17, 16 window addresses, then 64 dump floats
    assert ha.cluster_plan(101, 201) == 13
    floats = (10 * 212 + 16 * 103 + 2 * 16 * 101 + 9 * 217 * 9 + 4 * 117 + 3 * 101
              + 2 * 117 * 17 + 16)
    assert ha.cluster_bytes(101, 201, 13) == 4 * (floats + 64)
    # a grid no cluster of 16 holds goes to the cooperative kernel, which does
    assert ha.cluster_plan(201, 1001) == 0
    assert ha.smem_bytes(201, 1001) <= ha.SMEM_LIMIT
    assert ha.cluster_bytes(201, 1001, ha.MAX_CLUSTER) > ha.SMEM_LIMIT
    with pytest.raises(ValueError, match="CUDA"):  # the wrapper's route runs on the card
        ops = ha.AdiOps(None, None, None, None, None, None, None, torch.zeros(1, 2),
                        torch.zeros(3, 3))
        ha._adi_cuda(ops, torch.zeros(3, 3), ha.EUROPEAN)


def test_adi_adjoint_layout_and_the_cooperative_route():
    # 201 x 101 on 13 CTAs: 8 rows and 16 columns a CTA; in floats, the row
    # band: the x tables (lower, den, c', 1/den), the forward halves d' and
    # λ1, six planes of 8 rows of 220 (201 nodes and 8 of padding each side,
    # to 4), V's rows with their halos and y1's, two buffers of 10 and 8 rows
    # of 204, the gradient of a1v (8 x 204), six accumulators a node (6 x 8 x
    # 201), seven sums a row and a step's by chunk of 32 columns (56,
    # 7 x 8 x 7); the column band: the v tables (4 x 120), its stencil and
    # the mixed coefficient (4 x 101), the new grid on the columns (2
    # buffers of 16 x 103), the exercise value (16 x 101), the v-sweeps'
    # right-hand sides, forward halves and solutions (3 x 120 x 17), the
    # pinned columns' gradient (202, to 204), four accumulators a node
    # (4 x 16 x 101), the first node off the division's bits a system (16);
    # the moves: λ2 on the rows (8 x 220), the row-local part and g_a2v on
    # the columns (2 x 101 x 16), the mixed gradient with its halo columns
    # (101 x 24); 16 window addresses, 64 dump floats
    assert ha.adjoint_cluster_plan(101, 201) == 13
    layout = ha.adjoint_layout(101, 201, 13, True)
    assert (layout["rows"], layout["cols"]) == (8, 16)
    rows = 6 * 8 * 220 + 2 * 10 * 204 + 2 * 8 * 204 + 8 * 204 + 6 * 8 * 201 + 56 + 7 * 8 * 7
    cols = 4 * 120 + 4 * 101 + 2 * 16 * 103 + 16 * 101 + 3 * 120 * 17 + 204 + 4 * 16 * 101 + 16
    moves = 8 * 220 + 2 * 101 * 16 + 101 * 24
    assert layout["recv"] == moves
    assert layout["floats"] == rows + cols + moves + 16 + 64
    assert ha.adjoint_bytes(101, 201, 13, True) == 4 * layout["floats"] <= ha.SMEM_LIMIT
    # the package's test grid takes a cluster of 3
    assert ha.adjoint_cluster_plan(21, 41) == 3
    # 1001 x 201: no cluster holds it; the cooperative route's 132 blocks of
    # 2 rows and 8 columns, one history buffer and the forward halves over
    # the solutions, do
    assert ha.adjoint_cluster_plan(201, 1001) == 0
    coop = ha.adjoint_layout(201, 1001, H100_SMS, False)
    assert (coop["rows"], coop["cols"]) == (2, 8)
    assert 4 * coop["floats"] <= ha.SMEM_LIMIT < ha.adjoint_bytes(201, 1001, H100_SMS, True)
    with pytest.raises(ValueError, match="CUDA"):  # the wrapper's route runs on the card
        ops = ha.AdiOps(None, None, None, None, None, None, None, torch.zeros(1, 2),
                        torch.zeros(3, 3))
        ha._adi_adjoint_cuda(ops, torch.zeros(3, 3), None, None, False)


def test_theta_tile_counts_the_tables_and_the_plan_halves():
    # float32, 201 nodes, 2 contracts (pitch 3): twelve planes of 217 x 3 (the
    # three diagonals, the right-hand side, v, ψ, the working c', d' and
    # pivots, and the tables den, c', RN(1/den)), 4 x 2 coefficients, 651 mask
    # bytes (8-aligned), two first-changed rows (8 bytes), the dump slots
    assert tp.tile_bytes(201, 2, 4) == 31_936 + 8 + 256
    assert (12 * 651 + 8) * 4 + 651 <= 31_936 < (12 * 651 + 8) * 4 + 651 + 8
    # float64 at 401 nodes: 16 contracts need 0.7 MB, 4 fit in 227 KB
    assert tt.plan_systems(10_000, 132, lambda k: tp.tile_bytes(401, k, 8)) == 4
    assert tt.plan_systems(10_000, 132, lambda k: tp.tile_bytes(2001, k, 8)) == 1
    with pytest.raises(ValueError, match="shared memory"):
        tt.plan_systems(1, 132, lambda k: tp.tile_bytes(4000, k, 8))
