"""The port's discrete-dividend engines (``optionslab_tpu_torch/models/
dividends.py``) against ``optionslab_tpu.models.dividends``.

* The PDE: both packages run the same float32 θ-scheme and jump condition
  on a 41 × 40 grid (the reference with x64 off, else it forms parts of the
  grid in float64): European and American, calls and puts, with two cash
  dividends, to 2e-5 relative. Strikes sit off the spot: at S = K the log
  strike falls on a cell edge of the 1-D grid, where the two packages may
  round its mid-cell shift to different sides.
* The Monte Carlo draws from different generators: each price agrees with
  the reference's within 4 combined standard errors; both hold exact parity.
* Then the oracles of ``tests/test_dividends.py`` at 101 × 100 (tolerances
  as there or looser for the coarser grid, stated per test).
"""

import math

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.models import dividends as jd
from optionslab_tpu_torch.models import dividends as td
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, T, R, SIG = 100.0, 1.0, 0.05, 0.2
DIVS = [(0.3, 2.0), (0.8, 2.5)]


def _bs(cp):
    return float(bs_price(torch.tensor(S), 100.0, T, R, SIG, cp, 0.0))


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("cp,strike", [(1.0, 95.0), (-1.0, 105.0)])
def test_pde_matches_reference(cp, strike, american):
    with jax.enable_x64(False):
        want = jd.fdm_price_discrete_dividends(S, strike, T, R, SIG, DIVS, cp, american, 41, 40)
    got = td.fdm_price_discrete_dividends(S, strike, T, R, SIG, DIVS, cp, american, 41, 40,
                                          device="cpu")
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=2e-5)


@pytest.mark.parametrize("cp", [1.0, -1.0])
def test_mc_matches_reference(cp):
    want, want_se = jd.mc_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, cp, 20_000, 0)
    got, se = td.mc_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, cp, 20_000, 0,
                                             device="cpu")
    assert abs(got - want) < 4 * math.hypot(se, want_se)
    assert se == pytest.approx(want_se, rel=0.05)


def test_no_dividends_matches_black_scholes():
    for cp in (1.0, -1.0):
        got = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, [], cp=cp, n_space=101,
                                              n_time=100, device="cpu")
        assert abs(got - _bs(cp)) < 0.02, (cp, got)  # 0.01 at 301 × 200
    p, se = td.mc_price_discrete_dividends(S, 100.0, T, R, SIG, [], n_paths=65_536,
                                           device="cpu")
    assert abs(p - _bs(1.0)) < 3 * se + 1e-3


def test_parity_and_dividend_direction():
    c = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, 1.0, n_space=101, n_time=100,
                                        device="cpu")
    p = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, -1.0, n_space=101,
                                        n_time=100, device="cpu")
    assert td.dividend_parity_gap(c, p, S, 100.0, T, R, DIVS) < 0.02
    assert c < _bs(1.0) - 1.0 and p > _bs(-1.0) + 1.0
    mc_c, _ = td.mc_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, 1.0, 65_536, 1,
                                             device="cpu")
    mc_p, _ = td.mc_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, -1.0, 65_536, 1,
                                             device="cpu")
    # the same paths cancel the optionality; the gap is the MC error of E[S_T]
    assert td.dividend_parity_gap(mc_c, mc_p, S, 100.0, T, R, DIVS) < 0.024
    for cp, pde in ((1.0, c), (-1.0, p)):
        mc, se = td.mc_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, cp, 131_072, 2,
                                                device="cpu")
        assert abs(pde - mc) < 3 * se + 0.04, (cp, pde, mc, se)


def test_american_exercise_oracles():
    kw = dict(n_space=41, n_time=40, device="cpu")
    am0 = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, [], 1.0, True, **kw)
    eu0 = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, [], 1.0, False, **kw)
    assert abs(am0 - eu0) < 0.01  # Merton: no early exercise without dividends
    big = [(0.5, 8.0)]
    am = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, big, 1.0, True, **kw)
    eu = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, big, 1.0, False, **kw)
    assert eu + 0.1 < am < _bs(1.0) + 0.05
    am_p = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, -1.0, True, **kw)
    eu_p = td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, -1.0, False, **kw)
    assert am_p > eu_p


def test_bad_inputs():
    with pytest.raises(ValidationError):
        td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, [(1.5, 1.0)], device="cpu")
    with pytest.raises(ValidationError):
        td.fdm_price_discrete_dividends(S, 100.0, T, R, SIG, [(0.5, -1.0)], device="cpu")
    with pytest.raises(ValidationError):
        td.mc_price_discrete_dividends(S, 100.0, T, R, SIG, DIVS, n_paths=11, device="cpu")
    assert td._check_divs([(0.8, 1.0), (0.2, 2.0)], 1.0)[0].tolist() == [0.2, 0.8]
    assert np.isclose(td.dividend_parity_gap(10.0, 5.0, S, 100.0, T, R, []),
                      abs(5.0 - (S - 100.0 * np.exp(-R * T))))
