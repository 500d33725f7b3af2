"""The port's CUDA kernel on a card, against its plain torch version.

Imports torch and the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX). Without a
card every test here skips: a CUDA kernel has no CPU mode.
"""

import pytest
import torch

from optionslab_tpu_torch import ContractBatch, MCMethod, MonteCarloPricer, bs_price
from optionslab_tpu_torch.ops import gbm_kernel as gk

# per-row sums: the kernel and the plain version draw bit-equal paths with
# CUDA's libm on the card; summation order is the only difference
MOMENT_RTOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _book(n, device):
    return ContractBatch.make(torch.linspace(85.0, 115.0, n), 100.0, torch.linspace(0.5, 2.0, n),
                              0.04, 0.25, torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0), 0.01,
                              device=device)


# (contracts, paths): padded rows; one contract replicated onto 256 rows with
# 2 path blocks per chunk; a 1024-contract book (reps = 1, 256 lanes) with 8
SHAPES = [(300, 30_000), (1, 20_000_000), (1024, 30_000)]


@pytest.mark.parametrize("greeks", [True, False])
@pytest.mark.parametrize("sampler", ["prng", "hash", "sobol"])
@pytest.mark.parametrize("c_book,n_paths", SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, sampler, greeks, c_book, n_paths):
    _, _, params, c, reps, rows, _ = gk._prepare(_book(c_book, cuda_device))
    lanes = gk._lanes_for(rows)
    kw = dict(n_blocks=gk._n_blocks(n_paths, lanes, reps), rows=rows, active_rows=c * reps,
              lanes=lanes, sampler=sampler, reps=reps, greeks=greeks)
    before = gk._gbm_moments_cuda.launches
    kern = gk._gbm_moments_cuda(7, 3, params, **kw)
    plain = gk._gbm_moments_plain(7, 3, params, **kw)
    assert gk._gbm_moments_cuda.launches == before + 1
    assert kern.shape == plain.shape == ((4 if greeks else 2), rows)
    assert torch.all(kern[:, c * reps:] == 0)
    k64, p64 = kern.double(), plain.double()
    assert torch.all((k64[:3] - p64[:3]).abs() <= MOMENT_RTOL * p64[:3].abs())
    if greeks:
        assert torch.all((k64[3] - p64[3]).abs() <= MOMENT_RTOL * p64[2].abs())


def test_pricer_on_card_routes_through_kernel(cuda_device):
    pricer = MonteCarloPricer(n_paths=4_000_000, method=MCMethod.KERNEL, seed=2,
                              device=cuda_device)
    before = gk._gbm_moments_cuda.launches
    out = pricer.greeks([95.0, 105.0], 100.0, 1.0, 0.05, 0.2, "put")
    assert gk._gbm_moments_cuda.launches == before + 1
    assert out["price"].device == cuda_device
    bs = bs_price(torch.tensor([95.0, 105.0], device=cuda_device), 100.0, 1.0, 0.05, 0.2, -1.0)
    assert torch.all((out["price"] - bs).abs() < 4 * out["std_error"])


def test_autograd_on_card(cuda_device):
    spot = torch.tensor([90.0, 110.0], device=cuda_device, requires_grad=True)
    strike = torch.tensor(100.0, device=cuda_device, requires_grad=True)

    def t(x):
        return torch.tensor(x, device=cuda_device)

    b = ContractBatch(spot, strike, t(1.0), t(0.05), t(0.2), t(0.0), t(1.0))
    g_spot, g_strike = torch.autograd.grad(gk.gbm_mc_price(b, 1_000_000, 0).sum(),
                                           [spot, strike])
    out = gk.gbm_mc_price_greeks(b, n_paths=1_000_000, seed=0)
    torch.testing.assert_close(g_spot, out["delta"])
    assert g_strike.shape == ()
    torch.testing.assert_close(g_strike, out["dual_delta"].sum())


def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    _, _, params, c, reps, rows, _ = gk._prepare(_book(8, cuda_device))
    kw = dict(n_blocks=1, rows=rows, active_rows=c * reps, lanes=gk._lanes_for(rows),
              sampler="hash", reps=reps, greeks=True)
    bad = (params[0].double(),) + params[1:]
    with pytest.raises(ValueError, match="contiguous"):
        gk._gbm_moments_cuda(0, 0, bad, **kw)
    with pytest.raises(ValueError, match="sampler"):
        gk._gbm_moments_cuda(0, 0, params, **{**kw, "sampler": "halton"})
