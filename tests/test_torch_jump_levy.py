"""The port's Merton/Kou jump diffusions and VG/NIG Lévy models against
``optionslab_tpu.models.jump_diffusion`` and ``optionslab_tpu.models.levy``.

Deterministic prices (the Merton series, the VG and NIG Lewis integrals)
run on one numpy-seeded book through both packages: float64 to 1e-9
relative, float32 to 5e-5 relative (the JAX Lewis rule forms its nodes in
float64 under the tests' x64 flag). The Monte Carlo prices draw from
different generators: each is held to its closed form, and to the
reference's own Monte Carlo price, within 4 standard errors; a Monte Carlo
function that returns no stderr gets one from 8 independent replicates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optionslab_tpu.models import jump_diffusion as jj
from optionslab_tpu.models import levy as jl
from optionslab_tpu.types import ContractBatch as JBatch
from optionslab_tpu_torch.models import jump_diffusion as tj
from optionslab_tpu_torch.models import levy as tl
from optionslab_tpu_torch.models.black_scholes import bs_price
from optionslab_tpu_torch.models.iv import implied_vol
from optionslab_tpu_torch.types import ContractBatch
from optionslab_tpu_torch.utils.exceptions import ValidationError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _book(n=5, seed=11):
    rng = np.random.default_rng(seed)
    return {"spot": rng.uniform(80, 120, n), "strike": rng.uniform(80, 120, n),
            "maturity": rng.uniform(0.25, 2.0, n), "rate": rng.uniform(0.0, 0.08, n),
            "vol": rng.uniform(0.1, 0.4, n), "dividend": rng.uniform(0.0, 0.04, n),
            "cp": np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0)}


BOOK = _book()
DTYPES = {"f64": np.float64, "f32": np.float32}
MERTON = (0.7, -0.1, 0.25)
KOU = (0.8, 0.4, 10.0, 5.0)


def _batches(dtype, book=BOOK):
    fields = {k: np.asarray(v, DTYPES[dtype]) for k, v in book.items()}
    return (JBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
            ContractBatch(**{k: torch.tensor(v) for k, v in fields.items()}))


def _params(model, dtype):
    if model == "vg":
        jp = jl.VGParams.make(sigma=0.22, nu=0.3, theta=-0.15, dtype=DTYPES[dtype])
        return jp, tl.VGParams.from_numpy({k: np.asarray(getattr(jp, k))
                                           for k in ("sigma", "nu", "theta")})
    jp = jl.NIGParams.make(alpha=9.0, beta=-2.5, delta=0.35, dtype=DTYPES[dtype])
    return jp, tl.NIGParams.from_numpy({k: np.asarray(getattr(jp, k))
                                        for k in ("alpha", "beta", "delta")})


@pytest.fixture(scope="module")
def closed_form_ref():
    out = {}
    for dtype in DTYPES:
        jbatch, _ = _batches(dtype)
        out[dtype, "merton"] = np.asarray(jj.merton_price(jbatch, *MERTON))
        for model, fn in (("vg", jl.vg_price), ("nig", jl.nig_price)):
            out[dtype, model] = np.asarray(fn(jbatch, _params(model, dtype)[0]))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("model", ["merton", "vg", "nig"])
def test_closed_forms_match_reference(closed_form_ref, model, dtype):
    _, tbatch = _batches(dtype)
    if model == "merton":
        ours = tj.merton_price(tbatch, *MERTON)
    else:
        ours = (tl.vg_price if model == "vg" else tl.nig_price)(tbatch, _params(model, dtype)[1])
    assert ours.dtype == torch.float64 if dtype == "f64" else torch.float32
    np.testing.assert_allclose(ours.numpy(), closed_form_ref[dtype, model],
                               rtol=1e-9 if dtype == "f64" else 5e-5)


def _replicates(fn, n_rep=8, seed=0):
    """(mean, stderr of the mean) of ``fn(generator)`` over independent seeds."""
    runs = torch.stack([fn(torch.Generator().manual_seed(seed + i)) for i in range(n_rep)])
    return runs.mean(0), runs.std(0, correction=1) / np.sqrt(n_rep)


@pytest.fixture(scope="module")
def mc_ref():
    jbatch, _ = _batches("f32")
    key = jax.random.PRNGKey(5)
    return {"merton": np.asarray(jj.merton_mc_price(jbatch, *MERTON, key, n_paths=262_144)),
            "kou": np.asarray(jj.kou_mc_price(jbatch, *KOU, key, n_paths=262_144))}


@pytest.mark.parametrize("model", ["merton", "kou"])
def test_jump_mc_matches_series_and_reference(mc_ref, model):
    _, tbatch = _batches("f32")
    if model == "merton":
        mean, se = _replicates(lambda g: tj.merton_mc_price(tbatch, *MERTON, g, n_paths=32_768))
        series = tj.merton_price(_batches("f64")[1], *MERTON).numpy()
        assert np.all(np.abs(mean.numpy() - series) < 4 * se.numpy() + 1e-4)
    else:
        mean, se = _replicates(lambda g: tj.kou_mc_price(tbatch, *KOU, g, n_paths=32_768))
    assert mean.dtype == torch.float32 and mean.shape == (5,)
    # the reference ran the same total path count: its stderr ≈ ours
    assert np.all(np.abs(mean.numpy() - mc_ref[model]) < 4 * np.sqrt(2) * se.numpy() + 1e-4)


def test_jump_mc_put_call_parity():
    spot, strike, t, r, q = 100.0, 105.0, 1.0, 0.03, 0.01
    for fn, args in ((tj.merton_mc_price, MERTON), (tj.kou_mc_price, KOU)):
        calls = ContractBatch.make(spot, strike, t, r, 0.2, "call", q)
        puts = ContractBatch.make(spot, strike, t, r, 0.2, "put", q)
        c, se_c = _replicates(lambda g: fn(calls, *args, g, n_paths=32_768))
        p, se_p = _replicates(lambda g: fn(puts, *args, g, n_paths=32_768), seed=100)
        fwd = spot * np.exp(-q * t) - strike * np.exp(-r * t)
        assert abs(float(c - p) - fwd) < 4 * float(torch.hypot(se_c, se_p))


def test_zero_intensity_is_black_scholes():
    b = ContractBatch.make(100.0, torch.tensor([90.0, 100.0, 115.0]), 1.0, 0.05, 0.2, "put",
                           dtype=torch.float64)
    bs = bs_price(b.spot, b.strike, b.maturity, b.rate, b.vol, b.cp, b.dividend)
    np.testing.assert_allclose(tj.merton_price(b, 0.0, -0.1, 0.2).numpy(), bs.numpy(), rtol=1e-12)
    mean, se = _replicates(lambda g: tj.kou_mc_price(b, 0.0, 0.4, 10.0, 5.0, g, n_paths=32_768))
    assert np.all(np.abs(mean.numpy() - bs.numpy()) < 4 * se.numpy())


def test_merton_tail_mass_and_simulated_path():
    lam, t = 5.0, 2.0  # λT = 10: the 40-term series still holds all but 1e-12 of the mass
    w = np.exp(-lam * t) * np.cumprod(np.r_[1.0, lam * t / np.arange(1, 40)])
    assert 1.0 - w.sum() < 1e-12
    path = tj.merton_simulate_path(100.0, 1.0, 0.05, 0.2, *MERTON,
                                   torch.Generator().manual_seed(0), n_steps=16)
    assert path.shape == (17,) and float(path[0]) == pytest.approx(100.0)
    assert bool(torch.isfinite(path).all() and (path > 0).all())


@pytest.mark.parametrize("model", ["vg", "nig"])
def test_levy_mc_matches_lewis_and_reference(model):
    jbatch, tbatch = _batches("f32")
    jp, tp = _params(model, "f32")
    price_fn, mc_fn = ((tl.vg_price, tl.vg_mc_price) if model == "vg"
                       else (tl.nig_price, tl.nig_mc_price))
    jmc = jl.vg_mc_price if model == "vg" else jl.nig_mc_price
    m, se = mc_fn(tbatch, tp, torch.Generator().manual_seed(1), n_paths=200_000)
    rm, rse = (np.asarray(x) for x in jmc(jbatch, jp, jax.random.PRNGKey(2), n_paths=200_000))
    lewis = price_fn(_batches("f64")[1], _params(model, "f64")[1]).numpy()
    assert m.dtype == torch.float32 and se.shape == (5,)
    assert np.all(np.abs(m.numpy() - lewis) < 4 * se.numpy() + 1e-3)
    assert np.all(np.abs(m.numpy() - rm) < 4 * np.hypot(se.numpy(), rse) + 1e-3)


def test_gamma_sampler_moments():
    g = torch.Generator().manual_seed(3)
    for k in (0.3, 5.0):
        x = tl._gamma(g, torch.full((200_000,), k, dtype=torch.float32))
        assert abs(float(x.mean()) - k) < 4 * np.sqrt(k / 200_000)
        assert abs(float(x.var()) / k - 1.0) < 0.03


class TestLevyIdentities:
    def test_bs_limits(self):
        b = ContractBatch.make(100.0, torch.tensor([80.0, 100.0, 120.0]), 1.0, 0.05, 0.2, "call",
                               dtype=torch.float64)
        bs = bs_price(100.0, b.strike, 1.0, 0.05, 0.2, 1.0).numpy()
        vg = tl.VGParams.make(sigma=0.2, nu=1e-5, theta=0.0, dtype=torch.float64)
        nig = tl.NIGParams.make(alpha=1000.0, beta=0.0, delta=40.0, dtype=torch.float64)
        np.testing.assert_allclose(tl.vg_price(b, vg).numpy(), bs, atol=1e-4)
        np.testing.assert_allclose(tl.nig_price(b, nig).numpy(), bs, atol=1e-4)

    def test_parity_skew_and_autograd_delta(self):
        p = tl.VGParams.make(sigma=0.2, nu=0.3, theta=-0.2, dtype=torch.float64)

        def price(s, k, cp):
            return tl.vg_price(ContractBatch.make(s, k, 1.0, 0.05, 0.2, cp, dtype=torch.float64), p)

        assert abs(float(price(100.0, 100.0, 1.0) - price(100.0, 100.0, -1.0))
                   - (100.0 - 100.0 * np.exp(-0.05))) < 1e-10
        iv_atm = float(implied_vol(price(100.0, 100.0, 1.0), 100.0, 100.0, 1.0, 0.05, 1.0))
        iv_put = float(implied_vol(price(100.0, 80.0, -1.0), 100.0, 80.0, 1.0, 0.05, -1.0))
        assert iv_put > iv_atm + 0.01
        s = torch.tensor(100.0, dtype=torch.float64, requires_grad=True)
        (delta,) = torch.autograd.grad(price(s, 100.0, 1.0), s)
        fd = float(price(100.0 + 1e-4, 100.0, 1.0) - price(100.0 - 1e-4, 100.0, 1.0)) / 2e-4
        assert abs(float(delta) - fd) < 1e-6 and 0.4 < float(delta) < 0.9

    def test_validation(self):
        with pytest.raises(ValidationError):
            tl.VGParams.make(sigma=0.5, nu=3.0, theta=0.5).validate()
        with pytest.raises(ValidationError):
            tl.NIGParams.make(alpha=2.0, beta=2.5, delta=0.3).validate()
        tl.VGParams.make().validate()
        tl.NIGParams.make().validate()


def test_adapters():
    m = tj.MertonJumpDiffusion(0.5, -0.1, 0.2, device="cpu")
    assert m.kappa == pytest.approx(jj.MertonJumpDiffusion(0.5, -0.1, 0.2).kappa, rel=1e-6)
    ref = float(jj.MertonJumpDiffusion(0.5, -0.1, 0.2).price(100.0, 100.0, 1.0, 0.05, 0.2))
    assert float(m.price(100.0, 100.0, 1.0, 0.05, 0.2)) == pytest.approx(ref, rel=1e-5)
    mc = m.price_monte_carlo(100.0, 100.0, 1.0, 0.05, 0.2, n_paths=20_000)
    assert mc.device.type == "cpu" and abs(float(mc) - ref) < 0.5
    assert m.simulate_path(100.0, 1.0, 0.05, 0.2, n_steps=8).shape == (9,)
    k = tj.KouJumpDiffusion(device="cpu")
    assert k.kappa == pytest.approx(jj.KouJumpDiffusion().kappa, rel=1e-6)
    assert k.price_monte_carlo(100.0, 100.0, 1.0, 0.05, 0.2, n_paths=20_000).shape == ()
    for bad in (lambda: tj.MertonJumpDiffusion(lam=-1.0), lambda: tj.KouJumpDiffusion(eta1=0.5),
                lambda: tj.KouJumpDiffusion(p_up=1.5)):
        with pytest.raises(ValidationError):
            bad()
