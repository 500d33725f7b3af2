"""The port's multi-asset scan engine and closed forms against the JAX
package's ``models/multi_asset.py``, and the oracle tests of
``tests/test_multi_asset.py``.

The closed forms compute in float64 here and in float32 in the reference
(its explicit casts), so they agree at float32 rounding (rtol 2e-6, plus
1e-6 of the strike where the Black formula's two terms cancel: the
out-of-the-money geometric basket's 1.5e-5 on a price of 4.2); autograd of
the geometric-basket formula agrees with ``jax.grad`` to rtol 1e-5. The scan engines draw from a ``torch.Generator`` where the
reference draws from a JAX key: they agree within 5 × combined stderr +
2e-3, the reference's own bound for engine parity.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from optionslab_tpu.models import multi_asset as jma
from optionslab_tpu_torch.models import multi_asset as ma
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


KEY = jax.random.PRNGKey(11)
CORR2 = np.array([[1.0, 0.5], [0.5, 1.0]], np.float32)
CORR3 = np.array([[1.0, 0.3, 0.2], [0.3, 1.0, 0.4], [0.2, 0.4, 1.0]], np.float32)
SPOTS3 = np.array([100.0, 90.0, 110.0], np.float32)
VOLS3 = np.array([0.2, 0.25, 0.3], np.float32)
W3 = np.array([0.5, 0.3, 0.2], np.float32)
N = 100_000


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _close(port, ref, bound=None):
    (p, se), (pj, sej) = port, ref
    tol = 5 * math.hypot(float(se), float(sej)) + 2e-3 if bound is None else bound
    assert abs(float(p) - float(pj)) < tol, (float(p), float(pj), tol)


# ---------------------------------------------------------------------------
# closed forms against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cp,strike,divs", [(1.0, 100.0, 0.0), (-1.0, 95.0, 0.0),
                                            (1.0, 110.0, [0.01, 0.02, 0.0])])
def test_geometric_basket_closed_form_matches_jax(cp, strike, divs):
    args = (SPOTS3, W3, strike, 1.3, 0.04, VOLS3, CORR3, cp, divs)
    got = ma.geometric_basket_closed_form(*args)
    assert got.dtype == torch.float64
    # the reference's float32 rounding of the Black formula's two terms,
    # each of the order of the strike
    np.testing.assert_allclose(got.item(), float(jma.geometric_basket_closed_form(*args)),
                               rtol=2e-6, atol=1e-6 * strike)


def test_geometric_basket_autograd_matches_jax_grad():
    def jf(s, v, t, r):
        return jma.geometric_basket_closed_form(s, W3, 100.0, t, r, v, CORR3)

    s = torch.tensor(SPOTS3, dtype=torch.float64, requires_grad=True)
    v = torch.tensor(VOLS3, dtype=torch.float64, requires_grad=True)
    t = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    r = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    grads = torch.autograd.grad(ma.geometric_basket_closed_form(s, W3, 100.0, t, r, v, CORR3),
                                (s, v, t, r))
    ref = jax.grad(jf, argnums=(0, 1, 2, 3))(jnp.asarray(SPOTS3), jnp.asarray(VOLS3),
                                             jnp.float32(1.0), jnp.float32(0.05))
    for g, gj in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("rho,divs", [(0.6, (0.0, 0.0)), (-0.3, (0.02, 0.01))])
def test_margrabe_and_kirk_match_jax(rho, divs):
    m = ma.margrabe_price(100.0, 95.0, 1.2, 0.2, 0.25, rho, *divs)
    np.testing.assert_allclose(m.item(), float(jma.margrabe_price(
        jnp.float32(100.0), jnp.float32(95.0), jnp.float32(1.2), jnp.float32(0.2),
        jnp.float32(0.25), jnp.float32(rho), *map(jnp.float32, divs))), rtol=2e-6)
    k = ma.kirk_spread_approx(100.0, 95.0, 5.0, 1.2, 0.05, 0.2, 0.25, rho, *divs)
    np.testing.assert_allclose(k.item(), float(jma.kirk_spread_approx(
        *map(jnp.float32, (100.0, 95.0, 5.0, 1.2, 0.05, 0.2, 0.25, rho) + divs))), rtol=2e-6)
    # Kirk reduces to Margrabe at K = 0 (rate drops out)
    np.testing.assert_allclose(
        ma.kirk_spread_approx(100.0, 95.0, 0.0, 1.2, 0.05, 0.2, 0.25, rho, *divs).item(),
        m.item(), rtol=1e-12)


# ---------------------------------------------------------------------------
# scan engines against the reference, statistically
# ---------------------------------------------------------------------------
def test_basket_price_matches_jax():
    for kind in ("arithmetic", "geometric"):
        port = ma.basket_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, CORR3, gen(1), n_paths=N,
                               kind=kind, return_stderr=True)
        ref = jma.basket_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, CORR3, KEY, n_paths=N,
                               kind=kind, return_stderr=True)
        _close(port, ref)


@pytest.mark.parametrize("flavor,cp", [("best_of", 1.0), ("worst_of", -1.0)])
def test_rainbow_price_matches_jax(flavor, cp):
    port = ma.rainbow_price(SPOTS3, 100.0, 1.0, 0.05, VOLS3, CORR3, gen(2), cp=cp, n_paths=N,
                            flavor=flavor, return_stderr=True)
    ref = jma.rainbow_price(SPOTS3, 100.0, 1.0, 0.05, VOLS3, CORR3, KEY, cp=cp, n_paths=N,
                            flavor=flavor, return_stderr=True)
    _close(port, ref)


def test_spread_and_basket_asian_match_jax():
    port = ma.spread_price(100.0, 95.0, 5.0, 1.0, 0.05, 0.25, 0.2, 0.5, gen(3), n_paths=N,
                           return_stderr=True)
    ref = jma.spread_price(100.0, 95.0, 5.0, 1.0, 0.05, 0.25, 0.2, 0.5, KEY, n_paths=N,
                           return_stderr=True)
    _close(port, ref)
    port = ma.basket_asian_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, CORR3, gen(4),
                                 n_paths=50_000, n_steps=8, return_stderr=True)
    ref = jma.basket_asian_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, CORR3, KEY,
                                 n_paths=50_000, n_steps=8, return_stderr=True)
    _close(port, ref)


def test_multi_asset_terminal_law():
    """Terminal log-returns have the correlated GBM mean and covariance."""
    d = 3
    s_t = ma.multi_asset_terminal(SPOTS3, VOLS3, CORR3, 0.05, 0.01, 2.0, gen(5), 200_000)
    assert s_t.shape == (d, 200_000) and s_t.dtype == torch.float32
    x = torch.log(s_t.double() / torch.tensor(SPOTS3, dtype=torch.float64)[:, None])
    mu = (0.05 - 0.01 - 0.5 * VOLS3.astype(np.float64) ** 2) * 2.0
    np.testing.assert_allclose(x.mean(dim=1).numpy(), mu, atol=1e-4)
    cov = np.cov(x.numpy())
    want = CORR3 * np.outer(VOLS3, VOLS3) * 2.0
    np.testing.assert_allclose(cov, want, atol=2e-3)


def test_ad_greeks_match_jax_ad():
    """Pathwise delta/vega vectors by autograd against jax.grad of the
    reference engine (different draws: within their MC noise)."""
    w = np.array([0.6, 0.4], np.float32)
    spots = np.array([100.0, 95.0], np.float32)
    vols = np.array([0.2, 0.25], np.float32)
    g = ma.multi_asset_greeks(
        lambda s, v: ma.basket_price(s, w, 100.0, 1.0, 0.05, v, CORR2, gen(6), n_paths=N),
        spots, vols)
    gj = jma.multi_asset_greeks(
        lambda s, v: jma.basket_price(s, w, 100.0, 1.0, 0.05, v, CORR2, KEY, n_paths=N),
        spots, vols)
    assert g["delta"].shape == (2,) and g["vega"].shape == (2,)
    np.testing.assert_allclose(g["delta"].numpy(), np.asarray(gj["delta"]), atol=0.01)
    np.testing.assert_allclose(g["vega"].numpy(), np.asarray(gj["vega"]), atol=1.0)
    assert abs(g["price"].item() - float(gj["price"])) < 0.1


# ---------------------------------------------------------------------------
# the oracle tests of tests/test_multi_asset.py
# ---------------------------------------------------------------------------
def test_spread_matches_margrabe_at_zero_strike():
    p, se = ma.spread_price(100.0, 95.0, 0.0, 1.0, 0.05, 0.25, 0.2, 0.5, gen(7),
                            n_paths=400_000, return_stderr=True)
    exact = ma.margrabe_price(100.0, 95.0, 1.0, 0.25, 0.2, 0.5).item()
    assert abs(p.item() - exact) < 4 * se.item() + 1e-3


def test_margrabe_rate_invariance():
    """The exchange option has no rate dependence: the MC price agrees across
    rates on the same draws."""
    p1 = ma.spread_price(100.0, 100.0, 0.0, 1.0, 0.01, 0.3, 0.2, -0.3, gen(8), n_paths=200_000)
    p2 = ma.spread_price(100.0, 100.0, 0.0, 1.0, 0.10, 0.3, 0.2, -0.3, gen(8), n_paths=200_000)
    assert abs(p1.item() - p2.item()) < 0.05


def test_geometric_basket_matches_closed_form():
    p, se = ma.basket_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, CORR3, gen(9), n_paths=400_000,
                            kind="geometric", return_stderr=True)
    cf = ma.geometric_basket_closed_form(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, CORR3).item()
    assert abs(p.item() - cf) < 4 * se.item() + 1e-3


def test_kirk_close_to_mc_spread():
    p = ma.spread_price(100.0, 95.0, 5.0, 1.0, 0.05, 0.25, 0.2, 0.5, gen(10), n_paths=400_000)
    kirk = ma.kirk_spread_approx(100.0, 95.0, 5.0, 1.0, 0.05, 0.25, 0.2, 0.5).item()
    assert abs(p.item() - kirk) < 0.05  # Kirk is approximate


def test_degenerate_single_asset_reduces_to_bs():
    """A weight-1 basket of one asset (d = 2 with a zero weight) is the
    vanilla."""
    p, se = ma.basket_price([100.0, 50.0], [1.0, 0.0], 100.0, 1.0, 0.05, [0.2, 0.4], CORR2,
                            gen(11), n_paths=400_000, return_stderr=True)
    exact = bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0).item()
    assert abs(p.item() - exact) < 4 * se.item() + 1e-3


def test_rainbow_ordering():
    best = ma.rainbow_price([100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.2], CORR2, gen(12),
                            n_paths=100_000, flavor="best_of")
    worst = ma.rainbow_price([100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.2], CORR2, gen(12),
                             n_paths=100_000, flavor="worst_of")
    single = bs_price(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0).item()
    assert worst.item() < single < best.item()


def test_perfect_correlation_collapses():
    """rho = 1, equal vols: best-of = worst-of = vanilla (the 1e-6 jitter
    makes the singular corr factorable)."""
    corr = [[1.0, 1.0], [1.0, 1.0]]
    kw = dict(n_paths=200_000)
    best = ma.rainbow_price([100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.2], corr, gen(13),
                            flavor="best_of", **kw)
    worst = ma.rainbow_price([100.0, 100.0], 100.0, 1.0, 0.05, [0.2, 0.2], corr, gen(13),
                             flavor="worst_of", **kw)
    assert abs(best.item() - worst.item()) < 2e-2


def test_basket_asian_below_terminal_basket():
    args = ([100.0, 100.0], [0.5, 0.5], 100.0, 1.0, 0.05, [0.2, 0.3], CORR2)
    asian = ma.basket_asian_price(*args, gen(14), n_paths=100_000, n_steps=16)
    term = ma.basket_price(*args, gen(14), n_paths=100_000)
    assert 0.0 < asian.item() < term.item()  # averaging lowers the effective vol


def test_ad_greeks_ordering():
    w = [0.6, 0.4]
    g = ma.multi_asset_greeks(
        lambda s, v: ma.basket_price(s, w, 100.0, 1.0, 0.05, v, CORR2, gen(15), n_paths=N),
        [100.0, 95.0], [0.2, 0.25])
    assert g["delta"][0].item() > g["delta"][1].item() > 0  # the weights' order
    assert torch.all(g["vega"] > 0)
    assert 0 < g["delta"][0].item() < 0.61


def test_validation():
    with pytest.raises(ValidationError):
        ma.basket_price(np.ones(2), np.ones(2), 100.0, 1.0, 0.05, np.full(2, 0.2), np.eye(3),
                        gen(), n_paths=1000)
    with pytest.raises(ValidationError):
        ma.rainbow_price(np.ones(2), 100.0, 1.0, 0.05, np.full(2, 0.2), CORR2, gen(),
                         n_paths=1000, flavor="median_of")
    with pytest.raises(ValidationError):
        ma.basket_price(np.ones(2), np.ones(2), 100.0, 1.0, 0.05, np.full(2, 0.2), CORR2,
                        gen(), n_paths=1000, kind="harmonic")


def test_non_positive_definite_corr_raises():
    """The reference returns NaN prices here; the port raises."""
    bad = [[1.0, 0.9, -0.9], [0.9, 1.0, 0.9], [-0.9, 0.9, 1.0]]
    for fn in (lambda: ma.basket_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, bad, gen(),
                                       n_paths=1000),
               lambda: ma.basket_asian_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, bad, gen(),
                                             n_paths=1000, n_steps=2)):
        with pytest.raises(ValidationError, match="positive definite"):
            fn()
    ref = jma.basket_price(SPOTS3, W3, 100.0, 1.0, 0.05, VOLS3, np.asarray(bad, np.float32),
                           KEY, n_paths=1000)
    assert not np.isfinite(float(ref))
