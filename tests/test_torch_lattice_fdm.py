"""The port's CRR/Leisen–Reimer lattice and θ-scheme PDE against
``optionslab_tpu.models.binomial`` and ``optionslab_tpu.models.fdm``.

A numpy-seeded book of calls and puts (dividends included) goes through both
packages: each reference runs once per case (module fixtures). Float64 to
1e-9 relative; float32 prices to 5e-5 relative, and (Leisen–Reimer
American) the Greeks to 2e-3
relative plus 2e-5 of the book's largest value of that Greek (gamma and
theta are differences of nodes, which magnify float32 rounding: 1.6e-3 on a
deep in-the-money American put's gamma; a contract exercised at once has a
vega that is float32 noise around 0). Under the tests' x64 flag the JAX PDE forms its
grid in float64 even for float32 contracts, so its float32 parity is 1e-4.
Leisen–Reimer's theta is held to the reference's own nodes read at S0 (the
reference reads them at its off-centre middle node). Then the oracle checks
of ``tests/test_lattice_fdm.py`` at 64 steps and a 41 × 40 grid, and
Leisen–Reimer's theta against Black–Scholes away from the money.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import binomial as jb
from optionslab_tpu.models import fdm as jf
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch.models import binomial as tb
from optionslab_tpu_torch.models import fdm as tf
from optionslab_tpu_torch.models.black_scholes import bs_greeks, bs_price
from optionslab_tpu_torch.types import FIELDS, ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATM = (100.0, 100.0, 1.0, 0.05, 0.2)
BS_CALL = 10.450583572185565
BS_PUT = 5.573526022256971


def _book(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return {"spot": rng.uniform(80, 120, n), "strike": rng.uniform(80, 120, n),
            "maturity": rng.uniform(0.2, 2.0, n), "rate": rng.uniform(0.0, 0.08, n),
            "vol": rng.uniform(0.1, 0.5, n), "dividend": rng.uniform(0.0, 0.04, n),
            "cp": np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)}


BOOK = _book()
DTYPES = {"f64": np.float64, "f32": np.float32}


def _batches(dtype):
    fields = {k: v.astype(DTYPES[dtype]) for k, v in BOOK.items()}
    return (JBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
            ContractBatch(**{k: torch.tensor(v) for k, v in fields.items()}))


LATTICE = {  # name: (american, n_steps, method, richardson)
    "crr_eu_rich": (False, 64, "crr", True),
    "crr_am": (True, 64, "crr", False),
    "lr_am": (True, 65, "leisen-reimer", False),
}


def _theta_at_spot(jbatch, american, n_steps, method, gamma, price):
    """The reference's own step-2 nodes read at S0 through the quadratic
    that passes through them: the port's theta where the middle node is off
    S0 (Leisen–Reimer), which the reference reads at the node instead."""
    b = jbatch.broadcast()
    solve = jax.vmap(lambda *a: jb._crr_solve(*a, american, n_steps, method))
    _, (_, v2, (lu, ld), dt) = solve(b.spot, b.strike, b.maturity, b.rate, b.vol, b.dividend,
                                     b.cp)
    v2, lu, ld, dt = (np.asarray(x, np.float64) for x in (v2, lu, ld, dt))
    spot = np.asarray(b.spot, np.float64)
    s_ud, s_dd = spot * np.exp(lu + ld), spot * np.exp(2 * ld)
    d_dn = (v2[:, 1] - v2[:, 0]) / (s_ud - s_dd)
    v_later = v2[:, 1] + (spot - s_ud) * (d_dn + 0.5 * gamma * (spot - s_dd))
    return (v_later - price) / (2.0 * dt)


@pytest.fixture(scope="module")
def lattice_ref():
    out = {}
    for dtype in DTYPES:
        jbatch, _ = _batches(dtype)
        for name, (am, n, method, rich) in LATTICE.items():
            price = np.asarray(jb.binomial_price(jbatch, am, n, rich, method))
            greeks = None
            if dtype == "f64" or name == "lr_am":  # float32 Greeks: one case
                greeks = {k: np.asarray(v) for k, v in
                          jb.binomial_greeks(jbatch, am, n, method).items()}
                if method == "leisen-reimer":
                    greeks["theta"] = _theta_at_spot(jbatch, am, n, method, greeks["gamma"],
                                                     greeks["price"]).astype(DTYPES[dtype])
            out[dtype, name] = price, greeks
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LATTICE))
def test_binomial_matches_reference(lattice_ref, case, dtype):
    am, n, method, rich = LATTICE[case]
    _, tbatch = _batches(dtype)
    ref_price, ref_greeks = lattice_ref[dtype, case]
    price = tb.binomial_price(tbatch, am, n, rich, method).numpy()
    assert price.dtype == DTYPES[dtype]
    np.testing.assert_allclose(price, ref_price, rtol=1e-9 if dtype == "f64" else 5e-5)
    if ref_greeks is None:
        return
    greeks = {k: v.numpy() for k, v in tb.binomial_greeks(tbatch, am, n, method).items()}
    assert set(greeks) == set(ref_greeks)
    if dtype == "f64":
        for k, v in ref_greeks.items():
            np.testing.assert_allclose(greeks[k], v, rtol=1e-9, atol=1e-11, err_msg=k)
    else:
        for k, v in ref_greeks.items():
            np.testing.assert_allclose(greeks[k], v, rtol=2e-3, atol=2e-5 * np.abs(v).max(),
                                       err_msg=k)


FDM = {  # name: (n_space, n_time, american, scheme, american_method)
    "cn_eu": (41, 40, False, "crank-nicolson", "policy"),
    "cn_am_policy": (41, 40, True, "crank-nicolson", "policy"),
    "implicit_am_projection": (41, 40, True, "implicit", "projection"),
}


@pytest.fixture(scope="module")
def fdm_ref():
    out = {}
    for dtype in DTYPES:
        jbatch, _ = _batches(dtype)
        for name, args in FDM.items():
            out[dtype, name] = np.asarray(jf.fdm_price(jbatch, *args))
        out[dtype, "explicit"] = np.asarray(jf.explicit_fdm_price(jbatch, 41, 300, True))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(FDM) + ["explicit"])
def test_fdm_matches_reference(fdm_ref, case, dtype):
    _, tbatch = _batches(dtype)
    if case == "explicit":
        ours = tf.explicit_fdm_price(tbatch, 41, 300, True).numpy()
    else:
        ours = tf.fdm_price(tbatch, *FDM[case]).numpy()
    assert ours.dtype == DTYPES[dtype]
    np.testing.assert_allclose(ours, fdm_ref[dtype, case], rtol=1e-9 if dtype == "f64" else 1e-4)


def _batch(option_type="call", **kw):
    p = dict(zip(("S", "K", "T", "r", "sig"), ATM), q=0.0)
    p.update(kw)
    return ContractBatch.make(p["S"], p["K"], p["T"], p["r"], p["sig"], option_type, p["q"],
                              dtype=torch.float64)


class TestBinomialOracles:
    def test_european_within_crr_error_and_parity(self):
        c = float(tb.binomial_price(_batch("call"), n_steps=64))
        p = float(tb.binomial_price(_batch("put"), n_steps=64))
        assert abs(c - BS_CALL) < 0.05 and abs(p - BS_PUT) < 0.05
        assert abs((c - p) - (100 - 100 * np.exp(-0.05))) < 1e-9

    def test_american(self):
        am = float(tb.binomial_price(_batch("put"), american=True, n_steps=64))
        eu = float(tb.binomial_price(_batch("put"), n_steps=64))
        assert am - eu > 0.1
        am_c = float(tb.binomial_price(_batch("call"), american=True, n_steps=64))
        assert am_c == pytest.approx(float(tb.binomial_price(_batch("call"), n_steps=64)),
                                     abs=1e-9)

    def test_greeks_vs_bs(self):
        g = tb.binomial_greeks(_batch(), n_steps=65, method="leisen-reimer")
        ex = bs_greeks(*[torch.tensor(v, dtype=torch.float64) for v in ATM], 1.0, 0.0)
        for k, tol in (("delta", 1e-3), ("gamma", 1e-3), ("vega", 0.05), ("rho", 0.05),
                       ("theta", 0.05), ("dual_delta", 1e-3)):
            assert abs(float(g[k]) - float(ex[k])) < tol, k

    def test_leisen_reimer_theta_off_the_money(self):
        """Leisen–Reimer's step-2 middle node is off S0 away from the money;
        read at the node (the reference) the book's theta is 13.8 off."""
        book = ContractBatch(**{k: torch.tensor(v) for k, v in BOOK.items()})
        g = tb.binomial_greeks(book, n_steps=65, method="leisen-reimer")
        ex = bs_greeks(book.spot, book.strike, book.maturity, book.rate, book.vol, book.cp,
                       book.dividend)
        assert float((g["theta"] - ex["theta"]).abs().max()) < 0.1

    def test_leisen_reimer_beats_crr(self):
        lr = float(tb.binomial_price(_batch(), n_steps=65, method="leisen-reimer"))
        crr = float(tb.binomial_price(_batch(), n_steps=65))
        assert abs(lr - BS_CALL) < 1e-3 and abs(lr - BS_CALL) * 20 < abs(crr - BS_CALL)

    def test_book_expired_and_adapter(self):
        spots = torch.linspace(80.0, 120.0, 5, dtype=torch.float64)
        p = tb.binomial_price(ContractBatch.make(spots, 100.0, 1.0, 0.05, 0.2,
                                                 dtype=torch.float64), n_steps=64)
        assert p.shape == (5,) and bool((p.diff() > 0).all())
        assert float(tb.binomial_price(_batch(T=0.0, S=111.0), n_steps=64)) == pytest.approx(11.0)
        tree = tb.BinomialTree(n_steps=64, method="leisen-reimer", device="cpu")
        assert tree.n_steps == 65 and abs(float(tree.price(*ATM)) - BS_CALL) < 1e-3
        assert set(tree.calculate_all(*ATM)) >= {"delta", "gamma", "vega"}
        for bad in (dict(n_steps=2), dict(method="trinomial")):
            with pytest.raises(ValidationError):
                tb.BinomialTree(device="cpu", **bad)


class TestFDMOracles:
    def test_cn_call_put_and_sweep(self):
        spots = torch.tensor([70.0, 100.0, 130.0], dtype=torch.float64)
        for cp in (1.0, -1.0):
            b = ContractBatch.make(spots, 100.0, 1.0, 0.05, 0.2, cp, dtype=torch.float64)
            exact = bs_price(spots, 100.0, 1.0, 0.05, 0.2, cp, 0.0)
            np.testing.assert_allclose(tf.fdm_price(b, 41, 40).numpy(), exact.numpy(), atol=0.1)

    def test_american_put_near_the_binomial(self):
        cn = float(tf.fdm_price(_batch("put"), 41, 40, american=True))
        bi = float(tb.binomial_price(_batch("put"), american=True, n_steps=512))
        assert abs(cn - bi) < 0.05
        assert cn > float(tf.fdm_price(_batch("put"), 41, 40)) + 0.1

    def test_explicit_and_solvers(self):
        n = tf.explicit_fdm_stable_steps(0.2, 1.0, 41)
        assert n == jf.explicit_fdm_stable_steps(0.2, 1.0, 41)
        p = float(tf.ExplicitFDMSolver(n_space=41, n_time=max(n, 100), device="cpu")
                  .price(*ATM))
        assert abs(p - BS_CALL) < 0.2
        cn = tf.CrankNicolsonSolver(n_space=41, n_time=40, device="cpu").price(*ATM)
        assert cn.device.type == "cpu" and abs(float(cn) - BS_CALL) < 0.1

    def test_bad_inputs_raise(self):
        for kw in (dict(scheme="magic"), dict(american_method="magic")):
            with pytest.raises(ValidationError):
                tf.fdm_price(_batch(), 41, 10, **kw)
        with pytest.raises(ValidationError):
            tf.fdm_price(_batch(), 40, 10)


def test_field_names_cover_the_batch():
    assert set(BOOK) == set(FIELDS)
