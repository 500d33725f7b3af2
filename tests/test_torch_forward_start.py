"""The port's forward-start engines (``optionslab_tpu_torch/models/
forward_start.py``) against ``optionslab_tpu.models.forward_start``.

* The characteristic-function prices, Heston and Bates, calls and puts, on a
  strike array: float64 to 1e-10 relative, float32 to 1e-5 (the reference
  prices in float64 under this suite's x64 flag whatever its parameters'
  dtype; the puts, priced by parity from the calls, also to 5e-5 absolute,
  5e-7 of the spot); the forward smile to 1e-6 in float64.
* The Monte Carlo draws from a different generator: each price agrees with
  the reference's within 4 combined standard errors, Heston and Bates.
* Then the oracles of ``tests/test_forward_start.py`` on the port alone:
  t1 → 0 (and t1 = 0) is the vanilla Heston price, the semi-analytic price
  against its Monte Carlo (κ* = κ − ρσ < 0 included), parity, homogeneity
  and the autograd delta V/S, the forward smile's shape.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import forward_start as jfs
from optionslab_tpu.models.bates import BatesParams as JBates
from optionslab_tpu.models.heston import HestonParams as JParams
from optionslab_tpu_torch.models import forward_start as tfs
from optionslab_tpu_torch.models.bates import BatesParams
from optionslab_tpu_torch.models.heston import HestonParams, heston_price
from optionslab_tpu_torch.types import ContractBatch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HP = (0.04, 2.0, 0.05, 0.3, -0.7)
JUMPS = (0.5, -0.1, 0.15)
KS = np.array([0.85, 0.95, 1.0, 1.1])
F64 = torch.float64


def _params(bates: bool, pkg: str, dtype):
    vals = HP + (JUMPS if bates else ())
    if pkg == "jax":
        cls = JBates if bates else JParams
        return cls.make(*vals, dtype=dtype)
    cls = BatesParams if bates else HestonParams
    return cls.make(*vals, dtype=dtype)


@pytest.mark.parametrize("bates", [False, True])
@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("dtype,rtol,atol", [("float64", 1e-10, 0.0), ("float32", 1e-5, 5e-5)])
def test_cf_price_matches_reference(bates, cp, dtype, rtol, atol):
    want = np.asarray(jfs.forward_start_price(100.0, KS, 0.5, 1.5, 0.03,
                                              _params(bates, "jax", getattr(jnp, dtype)),
                                              0.01, cp))
    got = tfs.forward_start_price(100.0, KS, 0.5, 1.5, 0.03,
                                  _params(bates, "torch", getattr(torch, dtype)), 0.01, cp,
                                  device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == KS.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_forward_smile_matches_reference():
    want = np.asarray(jfs.forward_smile_iv(KS, 0.5, 1.5, _params(False, "jax", jnp.float64),
                                           rate=0.05))
    got = tfs.forward_smile_iv(KS, 0.5, 1.5, _params(False, "torch", F64), rate=0.05,
                               device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("bates", [False, True])
def test_mc_matches_reference(bates):
    want = [float(a) for a in jfs.forward_start_mc_price(
        100.0, 1.0, 0.5, 1.0, 0.03, _params(bates, "jax", jnp.float32), jax.random.PRNGKey(0),
        n_paths=20_000, n_steps=40)]
    got = [float(a) for a in tfs.forward_start_mc_price(
        100.0, 1.0, 0.5, 1.0, 0.03, _params(bates, "torch", torch.float32),
        torch.Generator().manual_seed(0), n_paths=20_000, n_steps=40)]
    assert abs(got[0] - want[0]) < 4 * math.hypot(got[1], want[1]), (got, want)
    assert got[1] == pytest.approx(want[1], rel=0.1)


@pytest.mark.parametrize("t1", [1e-6, 0.0])
def test_t1_to_zero_is_vanilla(t1):
    hp = _params(False, "torch", F64)
    fs = float(tfs.forward_start_price(100.0, 1.0, t1, 1.0, 0.05, hp, device="cpu"))
    van = float(heston_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, dtype=F64), hp))
    assert np.isfinite(fs) and abs(fs - van) < 1e-4


@pytest.mark.parametrize("par", [HP, (0.04, 0.5, 0.8, 0.8, 0.8)])  # kappa* > 0 and < 0
def test_cf_price_matches_its_monte_carlo(par):
    hp = HestonParams.make(*par, dtype=F64)
    sa = float(tfs.forward_start_price(100.0, 1.0, 0.5, 1.5, 0.05, hp, device="cpu"))
    mc, se = tfs.forward_start_mc_price(100.0, 1.0, 0.5, 1.5, 0.05, hp,
                                        torch.Generator().manual_seed(2), n_paths=100_000,
                                        n_steps=150)
    assert abs(sa - float(mc)) < 3.5 * float(se) + 0.05, (sa, float(mc), float(se))


def test_parity_homogeneity_and_delta():
    hp = _params(False, "torch", F64)
    c, p = (float(tfs.forward_start_price(100.0, 1.0, 0.5, 1.5, 0.05, hp, option_type=cp,
                                          device="cpu")) for cp in (1.0, -1.0))
    assert abs((c - p) - (100.0 - 100.0 * np.exp(-0.05))) < 1e-8
    v1 = float(tfs.forward_start_price(100.0, 1.05, 0.5, 1.5, 0.05, hp, device="cpu"))
    v2 = float(tfs.forward_start_price(200.0, 1.05, 0.5, 1.5, 0.05, hp, device="cpu"))
    assert abs(v2 - 2.0 * v1) < 1e-9
    s = torch.tensor(100.0, dtype=F64, requires_grad=True)
    v = tfs.forward_start_price(s, 1.0, 0.5, 1.5, 0.05, hp, device="cpu")
    (g,) = torch.autograd.grad(v, s)
    assert abs(float(g) - float(v.detach()) / 100.0) < 1e-9


def test_forward_smile_shape():
    hp = _params(False, "torch", F64)
    iv = tfs.forward_smile_iv(np.array([0.85, 0.95, 1.0, 1.05, 1.15]), 0.5, 1.5, hp, rate=0.05,
                              device="cpu").numpy()
    assert np.all(np.isfinite(iv)) and np.all(iv > 0.05) and iv[0] > iv[-1]
    atm = float(tfs.forward_smile_iv(np.array([1.0]), 1.0, 2.0, hp, device="cpu")[0])
    assert 0.8 * np.sqrt(0.05) < atm < 1.1 * np.sqrt(0.05)
