"""The cases the θ-scheme reverse kernel (``csrc/theta_pde.cu``
``theta_pde_adjoint_kernel``) is held on, one definition for ``chip_smoke.py``
and the tests: its tolerance against the plain reverse, the hand-built
exercise sets that split a Howard step's adjoint system into runs, and a
Howard step whose 8 sweeps stop short of their fixed point.
"""

import numpy as np
import torch

# the reverse kernel against the plain reverse (theta_pde._theta_reverse_plain),
# each gradient relative to its largest entry: the adjoint solve by runs on
# FMA chains and reciprocal tables against the plain reverse's Thomas solve
# on the transposed diagonals, the sums over nodes and steps in another order
THETA_REVERSE_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def exercise_sets(n: int) -> dict[str, np.ndarray]:
    """Exercise sets of n ≥ 41 rows by hand, each (n,) bool (rows 0 and
    n − 1 never exercised, as the forward's): none; a block at the low end
    (a put's); a block at the high end (a call's); both ends, which leaves
    one run that touches neither end; one such run between two exercised
    blocks, with a run at each end; two runs, one at each end; every
    interior row. The reverse runs a run that touches row 0 on its LU
    tables, one that touches row n − 1 on its UL tables, and forms the
    pivots of any other."""
    spans = {"none": [], "low block": [(1, 12)], "high block": [(n - 13, n - 2)],
             "both ends": [(1, 8), (n - 9, n - 2)],
             "interior run": [(5, 10), (n - 16, n - 11)], "two runs": [(15, n - 16)],
             "every interior row": [(1, n - 2)]}
    sets = {}
    for name, blocks in spans.items():
        m = np.zeros(n, bool)
        for a, b in blocks:
            m[a:b + 1] = True
        sets[name] = m
    return sets


def short_howard_step(dtype=torch.float64, device=None) -> list[torch.Tensor]:
    """``theta_loop``'s operands (lo, di, up, a, b, c, w, ψ, v0, ends) of one
    Howard step whose sweeps release one exercised row a sweep (strong
    coupling, ψ = 1, the right-hand side 0.99 inside), so 8 sweeps stop short
    of the fixed point; a = b = c = w = 0, so the right-hand side is the
    initial values with the ends' table."""
    n, k = 41, 100.0
    lo = torch.full((1, n), -k, dtype=dtype, device=device)
    up = lo.clone()
    di = torch.full((1, n), 1 + 2 * k, dtype=dtype, device=device)
    for t, end in ((lo, 0.0), (up, 0.0), (di, 1.0)):
        t[:, 0] = t[:, -1] = end
    psi = torch.ones((1, n), dtype=dtype, device=device)
    v0 = torch.full((1, n), 0.99, dtype=dtype, device=device)
    zero = torch.zeros((1, 1), dtype=dtype, device=device)
    ends = torch.tensor([[[0.0, 1.5]]], dtype=dtype, device=device)
    return [lo, di, up, zero, zero, zero, zero, psi, v0, ends]
