"""The port's CUDA kernels on a card, against their plain torch versions.

Imports torch and the port only, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX). Without a
card every test here skips: a CUDA kernel has no CPU mode.
"""

import math

import numpy as np
import pytest
import torch

from optionslab_tpu_torch import ContractBatch, MCMethod, MonteCarloPricer, bs_price
from optionslab_tpu_torch.models import exotics as tex
from optionslab_tpu_torch.ops import exotic_kernel as ek
from optionslab_tpu_torch.ops import gbm_kernel as gk
from optionslab_tpu_torch.ops.theta_cases import (THETA_REVERSE_RTOL, exercise_sets,
                                                  short_howard_step)

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


# ---------------------------------------------------------------------------
# the exotic kernels (csrc/exotic_mc.cu, csrc/exotic_greeks.cu)
# ---------------------------------------------------------------------------
def _exotic_params(kind, n_steps, device, strike=100.0):
    p, _ = ek._base_params(100.0, strike, 1.0, 0.05, 0.2, 0.01, 115.0 if "up" in kind else 88.0,
                           n_steps)
    if "double" in kind:
        p[ek._P_A], p[ek._P_B] = 88.0, 115.0
    if kind == "cliquet":
        p[ek._P_A:] = [-0.03, 0.03, 0.0, 1e9, 100.0]
    if kind == "autocall":
        p[ek._P_A:] = [100.0, 80.0, 70.0, 2.0, 100.0]
    if kind == "range_accrual":
        p[ek._P_A], p[ek._P_B], p[ek._P_E] = 90.0, 110.0, 100.0
    params = torch.tensor(p, dtype=torch.float32, device=device)
    return params, params[list(ek._BOOK_SLOTS)].reshape(1, 7).contiguous()


def _assert_sums_close(kern, plain, rtol=MOMENT_RTOL):
    """Row sums within ``rtol``; the signed moments (index 2 on) against
    their largest row, since they cancel inside a row."""
    assert kern.shape == plain.shape and torch.isfinite(kern).all()
    k64, p64 = kern.double(), plain.double()
    scale = p64.abs()
    scale[2:] = torch.maximum(scale[2:], scale[2:].amax(dim=1, keepdim=True))
    assert torch.all((k64 - p64).abs() <= rtol * scale)


# 70 path blocks: 24 chunks of 3, so each CUDA block sums several path blocks
EXOTIC_CASES = [(k, lr, "prng") for k in ("asian_arith", "asian_geo", "lookback_float",
                                          "barrier_up-and-out", "cliquet", "autocall",
                                          "range_accrual", "one_touch_double_hit")
                for lr in (False, True)] + [
    ("asian_arith_cv", False, "prng"), ("lookback_fixed", True, "hash"),
    ("no_touch_down", True, "hash"), ("asian_geo", False, "sobol_bb"),
    ("barrier_double-in", False, "sobol_bb")]


@pytest.mark.parametrize("kind,lr,sampler", EXOTIC_CASES)
def test_exotic_kernel_matches_plain_on_card(cuda_device, kind, lr, sampler):
    params, book = _exotic_params(kind, 12, cuda_device)
    kw = dict(kind=kind, n_steps=12, n_blocks=70, cp=1.0, sampler=sampler, lr=lr,
              period=3 if kind in ("cliquet", "autocall") else 1)
    before = ek._exotic_moments_cuda.launches
    kern = ek._exotic_moments_cuda(5, 2, params, book, **kw)
    assert ek._exotic_moments_cuda.launches == before + 1
    _assert_sums_close(kern, ek._exotic_moments_plain(5, 2, params, book, **kw))


@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("kind", ek.GREEK_KINDS)
def test_greeks_kernel_matches_plain_on_card(cuda_device, kind, cp):
    params, _ = _exotic_params(kind, 12, cuda_device, strike=105.0)
    kw = dict(kind=kind, n_steps=12, n_blocks=70, cp=cp, sampler="prng")
    before = ek._exotic_greeks_cuda.launches
    kern = ek._exotic_greeks_cuda(5, 2, params, **kw)
    assert ek._exotic_greeks_cuda.launches == before + 1
    _assert_sums_close(kern, ek._exotic_greeks_plain(5, 2, params, **kw))


def test_book_128_contracts_on_card(cuda_device):
    """128 contracts x 1e6 paths x 64 steps: 489 path blocks, one row each."""
    strikes = torch.linspace(80.0, 120.0, 128).tolist()
    p, _ = ek._base_params(100.0, strikes[0], 1.0, 0.05, 0.2, 0.0, 0.0, 64)
    params = torch.tensor(p, dtype=torch.float32, device=cuda_device)
    book = torch.tensor(ek._book_table(strikes, [0.0] * 128, [0.0] * 128, [0.0] * 128, 128),
                        dtype=torch.float32, device=cuda_device)
    n_blocks = ek._n_blocks(1_000_000, 4 * ek.LANES)
    assert n_blocks == 489
    kw = dict(kind="asian_arith", n_steps=64, n_blocks=n_blocks, cp=1.0, sampler="prng")
    _assert_sums_close(ek._exotic_moments_cuda(0, 0, params, book, **kw),
                       ek._exotic_moments_plain(0, 0, params, book, **kw))
    prices, ses, n = ek.exotic_book_price("asian_arith", 100.0, strikes, 1.0, 0.05, 0.2,
                                          n_paths=1_000_000, device=cuda_device)
    assert n == 489 * 4 * ek.LANES and prices.shape == (128,)
    assert torch.all(prices[1:] <= prices[:-1] + 3 * ses[1:])  # calls fall with the strike


def test_pallas_engine_classes_on_card(cuda_device):
    before = ek._exotic_moments_cuda.launches, ek._exotic_greeks_cuda.launches
    kw = dict(n_paths=2_000_000, n_steps=32, device="cuda", engine="pallas")
    p, se = tex.AsianOption(100.0, 100.0, 1.0, 0.05, 0.2, averaging="geometric",
                            **kw).price(return_stderr=True)
    cf = tex.geometric_asian_closed_form(100.0, 100.0, 1.0, 0.05, 0.2, n_steps=32)
    assert p.device.type == "cuda" and abs(p.item() - cf.item()) < 4 * se.item()
    g = tex.LookbackOption(100.0, 100.0, 1.0, 0.05, 0.2, **kw).greeks()
    assert g["delta"].item() == pytest.approx(g["price"].item() / 100.0, rel=1e-4)
    for opt in (tex.BarrierOption(100.0, 100.0, 120.0, 1.0, 0.05, 0.2, **kw),
                tex.AutocallableNote(100.0, 1.0, 0.05, 0.2, **{**kw, "n_steps": 252}),
                tex.CliquetOption(100.0, 1.0, 0.05, 0.2, **{**kw, "n_steps": 252})):
        assert torch.isfinite(opt.price())
    assert ek._exotic_moments_cuda.launches == before[0] + 4
    assert ek._exotic_greeks_cuda.launches == before[1] + 1


def test_exotic_wrappers_reject_cpu_tensors(cuda_device):
    params, book = _exotic_params("asian_arith", 4, "cpu")
    kw = dict(kind="asian_arith", n_steps=4, n_blocks=1, cp=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ek._exotic_moments_cuda(0, 0, params, book, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        ek._exotic_greeks_cuda(0, 0, params, **kw)
    gparams, gbook = _exotic_params("asian_arith", 4, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ek._exotic_moments_cuda(0, 0, gparams.double(), gbook, **kw)
    with pytest.raises(ValueError, match="power-of-two"):
        ek._exotic_moments_cuda(0, 0, gparams, gbook.expand(3, 7).contiguous(), **kw)


# ---------------------------------------------------------------------------
# the Heston kernels (csrc/heston_mc.cu, heston_qe.cu, heston_chain.cu)
# ---------------------------------------------------------------------------
def _heston_params():
    from optionslab_tpu_torch.models.heston import HestonParams

    return HestonParams.make(0.04, 2.0, 0.04, 0.3, -0.7)


def _heston_close(kern, plain, n_plain):
    """Row sums within rtol 1e-5; the signed sensitivity moments (from
    ``n_plain`` on) against their largest row."""
    assert kern.shape == plain.shape and torch.isfinite(kern).all()
    k64, p64 = kern.double(), plain.double()
    scale = p64.abs()
    scale[n_plain:] = torch.maximum(scale[n_plain:], scale[n_plain:].amax(dim=-1, keepdim=True))
    assert torch.all((k64 - p64).abs() <= MOMENT_RTOL * scale)


# 70 path blocks: 24 chunks of 3, so each CUDA block sums several path blocks
@pytest.mark.parametrize("mode,sampler,cp", [(m, s, cp) for m in ("price", "vega", "ladder")
                                             for s in ("prng", "hash") for cp in (1.0, -1.0)]
                         + [("price", "sobol_bb", 1.0)])
def test_heston_mc_kernel_matches_plain_on_card(cuda_device, mode, sampler, cp):
    from optionslab_tpu_torch.ops import heston_kernel as hk

    _, p = hk._params_vec(100.0, 105.0 if cp > 0 else 95.0, 1.0, 0.05, _heston_params(), 0.01,
                          12)
    params = torch.tensor(p, device=cuda_device)
    kw = dict(n_steps=12, n_blocks=70, cp=cp, sampler=sampler, mode=mode)
    before = hk._heston_mc_cuda.launches
    kern = hk._heston_mc_cuda(5, 2, params, **kw)
    assert hk._heston_mc_cuda.launches == before + 1
    _heston_close(kern, hk._heston_mc_plain(5, 2, params, **kw), 3)


# the QE ladder draws in chunks of K = 7 steps: 1, K − 1, K + 1, 12 and 32
# steps. Its work unit is 32 lanes of a path block's row: 1 and 70 path
# blocks (8 and 560 units a row) give one unit to each CUDA block, 257 (2056
# units) gives 686 chunks of 3 and a last one of 1, so a CUDA block carries
# several units through its double buffer. The price kernel: 70 path blocks
# are 24 chunks of 3, 257 are 29 chunks of 9 and a last one of 5.
@pytest.mark.parametrize("cp", [1.0, -1.0])
@pytest.mark.parametrize("n_blocks", [1, 70, 257])
@pytest.mark.parametrize("n_steps", [1, 6, 8, 12, 32])
@pytest.mark.parametrize("ladder", [False, True])
@pytest.mark.parametrize("sampler", ["prng", "hash"])
def test_heston_qe_kernels_match_plain_on_card(cuda_device, ladder, sampler, n_steps, n_blocks,
                                               cp):
    from optionslab_tpu_torch.ops import heston_kernel as hk

    if ladder:
        _, p, _ = hk._params_vec_qe_ladder(100.0, 100.0, 1.0, 0.05, _heston_params(), 0.0,
                                           n_steps)
        kfn, pfn = hk._heston_qe_ladder_cuda, hk._heston_qe_ladder_plain
    else:
        _, p = hk._params_vec_qe(100.0, 100.0, 1.0, 0.05, _heston_params(), 0.0, n_steps)
        kfn, pfn = hk._heston_qe_cuda, hk._heston_qe_plain
    params = torch.tensor(p, device=cuda_device)
    kw = dict(n_steps=n_steps, n_blocks=n_blocks, cp=cp, sampler=sampler)
    before = kfn.launches
    kern = kfn(5, 3, params, **kw).clone()  # an odd block0
    assert kfn.launches == before + 1
    _heston_close(kern, pfn(5, 3, params, **kw), 9)
    # a fixed-order reduction, no atomics: a second launch repeats every bit
    assert torch.equal(kfn(5, 3, params, **kw), kern)


@pytest.mark.parametrize("n_blocks", [1, 3, 70, 128, 257, 4099])
def test_qe_ladder_plan_covers_every_lane_once(cuda_device, n_blocks):
    """The QE ladder kernel's launch plan (``heston_qe_ladder_plan``): CUDA
    block (row, chunk), for every row, takes units chunk·per .. min(n_units,
    (chunk + 1)·per) − 1, unit u being lanes 32·(u % 8) .. 32·(u % 8) + 31
    of path block u // 8, and its seven warps carry the seven path systems
    of each. So every (block, row, lane, set) is carried exactly once when
    every (block, lane) is."""
    import ctypes

    import numpy as np

    from optionslab_tpu_torch.ops import _build
    from optionslab_tpu_torch.ops import heston_kernel as hk

    n_chunks, per = ctypes.c_int(), ctypes.c_int()
    lib = _build.load_library()
    assert lib.heston_qe_ladder_plan(n_blocks, ctypes.byref(n_chunks), ctypes.byref(per)) == 0
    n_chunks, per, n_units = n_chunks.value, per.value, n_blocks * 8
    assert 1 <= n_chunks <= 1024 and per * (n_chunks - 1) < n_units <= per * n_chunks
    seen = np.zeros((n_blocks, hk.LADDER_LANES), np.int32)
    for chunk in range(n_chunks):
        for unit in range(chunk * per, min(n_units, (chunk + 1) * per)):
            block, g = divmod(unit, 8)
            seen[block, 32 * g:32 * (g + 1)] += 1
    assert (seen == 1).all()
    assert lib.heston_qe_ladder_plan(0, ctypes.byref(ctypes.c_int()),
                                     ctypes.byref(ctypes.c_int())) != 0


@pytest.mark.parametrize("sampler", ["prng", "hash"])
def test_heston_chain_kernel_matches_plain_on_card(cuda_device, sampler):
    from optionslab_tpu_torch.ops import heston_kernel as hk

    plan = hk.chain_plan([90.0, 100.0, 110.0, 95.0, 105.0, 100.0], [0.5, 0.5, 0.5, 1.0, 1.0, 0.25],
                         [-1.0, 1.0, 1.0, -1.0, 1.0, 1.0], 0.05, cuda_device)
    head = hk._chain_head(torch.tensor([0.04, 2.0, 0.04, 0.3, -0.7], device=cuda_device), 100.0,
                          0.05, 0.01)
    kw = dict(n_blocks=70, sampler=sampler)
    before = hk._heston_chain_cuda.launches
    kern = hk._heston_chain_cuda(5, 2, head, plan, **kw)
    assert hk._heston_chain_cuda.launches == before + 1
    plain = hk._heston_chain_plain(5, 2, head, plan, **kw)
    for q in range(plan.n_quotes):
        _heston_close(kern[q], plain[q], 2)


def test_heston_entry_points_on_card(cuda_device):
    from optionslab_tpu_torch.models.heston import HestonPricer, calibrate_heston_mc
    from optionslab_tpu_torch.ops import heston_kernel as hk

    par = _heston_params()
    p, se, _ = hk.heston_kernel_price(100.0, 100.0, 1.0, 0.05, par, n_paths=2_000_000,
                                      n_steps=64, device=cuda_device)
    lewis = HestonPricer(device=cuda_device).price(100.0, 100.0, 1.0, 0.05)
    assert p.device.type == "cuda" and abs(p.item() - lewis.item()) < 4 * se.item() + 0.03
    before = hk._heston_chain_cuda.launches
    strikes, mats, cps = [95.0, 105.0], [0.5, 1.0], [-1.0, 1.0]
    market, _, _ = hk.heston_chain_ladder(strikes, mats, cps, 100.0, 0.05, par, n_paths=262_144,
                                          max_dt=0.05, device=cuda_device)
    calibrate_heston_mc(market, strikes, mats, cps, 100.0, 0.05, n_steps=10, n_paths=262_144,
                        max_dt=0.05, device=cuda_device)
    assert hk._heston_chain_cuda.launches == before + 1 + 10 + 2


def test_heston_wrappers_reject_cpu_tensors(cuda_device):
    from optionslab_tpu_torch.ops import heston_kernel as hk

    _, p = hk._params_vec(100.0, 100.0, 1.0, 0.05, _heston_params(), 0.0, 4)
    kw = dict(n_steps=4, n_blocks=1, cp=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        hk._heston_mc_cuda(0, 0, torch.tensor(p), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        hk._heston_mc_cuda(0, 0, torch.tensor(p, device=cuda_device).double(), **kw)


# ---------------------------------------------------------------------------
# the Heston/Bates exotic kernel (csrc/heston_exotic.cu)
# ---------------------------------------------------------------------------
def _hx_inputs(kind, device, scheme="euler", jumps=False, n_steps=12):
    from optionslab_tpu_torch.models.bates import BatesParams
    from optionslab_tpu_torch.ops import heston_exotic_kernel as hx

    par = BatesParams.make() if jumps else _heston_params()
    p, _ = hx._exotic_params(100.0, 100.0, 1.0, 0.05, par, 0.01,
                             115.0 if "up" in kind else 88.0, n_steps, scheme)
    if "double" in kind:
        hx._set_double_band(p, 100.0, 88.0, 115.0)
    slots = {"cliquet": [-0.03, 0.03, 0.0, 1e9, 100.0],
             "autocall": [0.0, -0.105, -0.223, 2.0, 100.0],
             "range_accrual": [-0.105, 0.095, 0.0, 0.0, 100.0]}
    if kind in slots:
        p[hx._HX_A:hx._HX_DYN] = slots[kind]
    params = torch.tensor(p, dtype=torch.float32, device=device)
    return params, params[list(hx._BOOK_SLOTS)].reshape(1, 7).contiguous()


HX_CASES = [(k, lr, "prng", "euler", False) for k in
            ("asian_arith", "lookback_fixed", "barrier_down-and-in", "one_touch_double_hit",
             "cliquet", "autocall", "range_accrual") for lr in (False, True)] + [
    ("no_touch_up", True, "hash", "euler", False), ("asian_geo", False, "sobol_bb", "euler", False),
    ("barrier_up-and-out", False, "prng", "qe", False), ("autocall", False, "hash", "qe", True),
    ("asian_arith", True, "prng", "euler", True), ("barrier_double-out", False, "sobol_bb",
                                                   "euler", True)]


@pytest.mark.parametrize("kind,lr,sampler,scheme,jumps", HX_CASES)
def test_heston_exotic_kernel_matches_plain_on_card(cuda_device, kind, lr, sampler, scheme,
                                                    jumps):
    from optionslab_tpu_torch.ops import heston_exotic_kernel as hx

    params, book = _hx_inputs(kind, cuda_device, scheme, jumps)
    kw = dict(kind=kind, n_steps=12, n_blocks=70, cp=-1.0 if "down" in kind else 1.0,
              period=3 if kind in ("cliquet", "autocall") else 1, sampler=sampler,
              scheme=scheme, lr=lr, jumps=jumps)
    before = hx._heston_exotic_cuda.launches
    kern = hx._heston_exotic_cuda(5, 2, params, book, **kw)
    assert hx._heston_exotic_cuda.launches == before + 1
    _assert_sums_close(kern, hx._heston_exotic_plain(5, 2, params, book, **kw))


@pytest.mark.parametrize("nc,lr", [(8, True), (128, False)])
def test_heston_exotic_books_on_card(cuda_device, nc, lr):
    from optionslab_tpu_torch.ops import heston_exotic_kernel as hx

    strikes = torch.linspace(85.0, 115.0, nc).tolist()
    table, *_ = hx._heston_book_vec("barrier_up-and-out", 100.0, strikes,
                                    torch.linspace(115.0, 140.0, nc).tolist(), None, None)
    params, _ = _hx_inputs("barrier_up-and-out", cuda_device)
    book = torch.tensor(table, dtype=torch.float32, device=cuda_device)
    kw = dict(kind="barrier_up-and-out", n_steps=12, n_blocks=40, cp=1.0, lr=lr)
    _assert_sums_close(hx._heston_exotic_cuda(0, 0, params, book, **kw),
                       hx._heston_exotic_plain(0, 0, params, book, **kw))


def test_heston_exotic_entry_points_on_card(cuda_device):
    """The wrappers route through the kernel: a far up-and-out is the vanilla
    (Lewis), and one-touch + no-touch = df on the same paths."""
    from optionslab_tpu_torch.models.heston import HestonPricer
    from optionslab_tpu_torch.ops import heston_exotic_kernel as hx

    par = _heston_params()
    before = hx._heston_exotic_cuda.launches
    p, se, _ = hx.heston_kernel_exotic_price("barrier_up-and-out", 100.0, 100.0, 1.0, 0.05, par,
                                             barrier=1e6, n_paths=2_000_000, device=cuda_device)
    lewis = HestonPricer(device=cuda_device).price(100.0, 100.0, 1.0, 0.05)
    assert p.device.type == "cuda" and abs(p.item() - lewis.item()) < 4 * se.item() + 0.05
    kw = dict(barrier=115.0, n_paths=1_000_000, seed=4, device=cuda_device)
    one, _, _ = hx.heston_kernel_exotic_price("one_touch_up", 100.0, 0.0, 1.0, 0.05, par, **kw)
    no, _, _ = hx.heston_kernel_exotic_price("no_touch_up", 100.0, 0.0, 1.0, 0.05, par, **kw)
    assert abs(one.item() + no.item() - math.exp(-0.05)) < 1e-5
    g = hx.heston_kernel_autocall_lr_greeks(100.0, 1.0, 0.05, par, n_paths=1_000_000,
                                            device=cuda_device)
    assert all(torch.isfinite(g[k]) for k in ("price", "delta", "vega", "rho", "theta"))
    assert hx._heston_exotic_cuda.launches == before + 4


def test_heston_exotic_wrappers_reject_cpu_tensors(cuda_device):
    from optionslab_tpu_torch.ops import heston_exotic_kernel as hx

    params, book = _hx_inputs("asian_arith", "cpu", n_steps=4)
    kw = dict(kind="asian_arith", n_steps=4, n_blocks=1, cp=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        hx._heston_exotic_cuda(0, 0, params, book, **kw)
    gparams, gbook = _hx_inputs("asian_arith", cuda_device, n_steps=4)
    with pytest.raises(ValueError, match="contiguous"):
        hx._heston_exotic_cuda(0, 0, gparams.double(), gbook, **kw)
    with pytest.raises(ValueError, match="contiguous"):  # a Bates vector without jumps=True
        hx._heston_exotic_cuda(0, 0, torch.cat([gparams, gparams[:6]]), gbook, **kw)
    with pytest.raises(ValueError, match="power-of-two"):
        hx._heston_exotic_cuda(0, 0, gparams, gbook.expand(3, 7).contiguous(), **kw)


# ---------------------------------------------------------------------------
# The local-vol and SLV kernels (csrc/local_vol_mc.cu, csrc/slv_mc.cu)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smile_dupire():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from optionslab_tpu_torch.models.local_vol import DupireLocalVol, sample_smile_iv_fn

    return DupireLocalVol(sample_smile_iv_fn(), 100.0, 0.05, device="cuda")


@pytest.fixture(scope="module")
def slv_pricer(smile_dupire):
    from optionslab_tpu_torch.models.heston import HestonParams
    from optionslab_tpu_torch.ops import slv_kernel as sk

    return sk.SLVKernelPricer(smile_dupire, HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7,
                                                              device="cuda"),
                              1.0, n_steps=12, n_cal_paths=65_536)


def _levels(kind):
    return 120.0 if "up" in kind else 85.0


@pytest.mark.parametrize("payoff", ["european", "asian", "range_accrual", "lookback_float",
                                    "lookback_fixed", "barrier_up-and-in",
                                    "barrier_double-out", "no_touch_down", "one_touch_up_hit"])
@pytest.mark.parametrize("greeks,sampler", [(False, "hash"), (False, "sobol_bb"),
                                            (True, "prng")])
def test_local_vol_kernel_matches_plain_on_card(cuda_device, smile_dupire, payoff, greeks,
                                                sampler):
    from optionslab_tpu_torch.ops import local_vol_kernel as lk

    pricer = lk.LocalVolKernelPricer(smile_dupire, 1.0, n_steps=12)
    params = pricer._params(100.0, payoff, _levels(payoff), 85.0, 118.0)
    kw = dict(n_steps=12, n_blocks=70, cp=-1.0 if "lookback" in payoff else 1.0, payoff=payoff,
              sampler=sampler, greeks=greeks)
    before = lk._lv_cuda.launches
    kern = lk._lv_cuda(5, 2, params, **kw)
    assert lk._lv_cuda.launches == before + 1
    _assert_sums_close(kern, lk._lv_plain(5, 2, params, **kw))


@pytest.mark.parametrize("kind", ["european", "asian_arith", "asian_geo", "lookback_fixed",
                                  "barrier_down-and-out", "one_touch_double", "one_touch_down_hit",
                                  "cliquet", "autocall", "range_accrual"])
@pytest.mark.parametrize("lr,sampler", [(False, "hash"), (True, "prng")])
def test_slv_kernel_matches_plain_on_card(cuda_device, slv_pricer, kind, lr, sampler):
    import numpy as np

    from optionslab_tpu_torch.ops import slv_kernel as sk

    if kind in sk.STRUCTURED_KINDS:
        head = slv_pricer._head.copy()
        head[sk._S_A:sk._S_E + 1] = {"cliquet": (-0.03, 0.03, 0.0, 1e9, 100.0),
                                     "autocall": (0.0, np.log(0.9), np.log(0.8), 2.0, 100.0),
                                     "range_accrual": (np.log(0.9), np.log(1.1), 0.0, 0.0,
                                                       100.0)}[kind]
        params = slv_pricer._vector(head)
    else:
        params = slv_pricer._params_vec(kind, 100.0, _levels(kind), 85.0, 118.0)
    kw = dict(kind=kind, n_steps=12, n_blocks=70, cp=1.0, sampler=sampler, lr=lr,
              period=3 if kind in ("cliquet", "autocall") else 1)
    before = sk._slv_cuda.launches
    kern = sk._slv_cuda(5, 2, params, **kw)
    assert sk._slv_cuda.launches == before + 1
    _assert_sums_close(kern, sk._slv_plain(5, 2, params, **kw))


def test_local_vol_entry_points_on_card(cuda_device, smile_dupire):
    """The pricer routes through the kernel: in + out = vanilla on the same
    paths, the vanilla against the PDE, finite Greeks."""
    from optionslab_tpu_torch.ops import local_vol_kernel as lk

    pricer = lk.LocalVolKernelPricer(smile_dupire, 1.0, n_steps=50)
    assert pricer.device.type == "cuda"
    before = lk._lv_cuda.launches
    kw = dict(n_paths=2_000_000, seed=3, barrier=125.0)
    van, se, _ = pricer.price(100.0, **kw)
    p_in, _, _ = pricer.price(100.0, payoff="barrier_up-and-in", **kw)
    p_out, _, _ = pricer.price(100.0, payoff="barrier_up-and-out", **kw)
    assert van.device.type == "cuda" and abs((p_in + p_out - van).item()) < 1e-5 * van.item()
    pde = smile_dupire.to("cpu")._solve(100.0, 1.0, 1.0, n_space=101, n_time=100).item()
    assert abs(van.item() - pde) < 4 * se.item() + 0.05
    g = pricer.greeks(100.0, payoff="lookback_float", n_paths=1_000_000)
    assert all(math.isfinite(float(g[k])) for k in ("price", "delta", "gamma", "vega"))
    assert lk._lv_cuda.launches == before + 4


def test_slv_entry_points_on_card(cuda_device, smile_dupire, slv_pricer):
    """The SLV pricer routes through the kernel; one-touch + no-touch = df;
    the calibration is bit for bit repeatable on the card."""
    from optionslab_tpu_torch.models.slv import slv_calibrate_leverage
    from optionslab_tpu_torch.ops import slv_kernel as sk

    before = sk._slv_cuda.launches
    kw = dict(barrier=115.0, n_paths=1_000_000, seed=4)
    one, _, _ = slv_pricer.price("one_touch_up", 0.0, **kw)
    no, _, _ = slv_pricer.price("no_touch_up", 0.0, **kw)
    assert abs(one.item() + no.item() - math.exp(-0.05)) < 1e-5
    g = slv_pricer.autocall(n_obs=4, n_paths=1_000_000, greeks=True)
    assert all(math.isfinite(float(g[k])) for k in ("price", "delta", "vega_v0", "rho"))
    assert sk._slv_cuda.launches == before + 3
    surf = smile_dupire.surface  # one seed, one table, on the card too
    again = slv_calibrate_leverage(100.0, 1.0, 0.05, slv_pricer.params,
                                   torch.Generator("cuda").manual_seed(0), surf.k_grid,
                                   surf.t_grid, surf.grid, n_paths=65_536, n_steps=12)
    assert torch.equal(again[0], slv_pricer.x_rows) and torch.equal(again[1], slv_pricer.l_rows)


def test_pricers_on_a_carried_surface_launch_their_kernels(cuda_device, smile_dupire):
    """A surface carried across from numpy with no device lies on the card,
    and both pricers built on it with no device launch their kernels."""
    from optionslab_tpu_torch.models.heston import HestonParams
    from optionslab_tpu_torch.models.local_vol import LocalVolSurface
    from optionslab_tpu_torch.ops import local_vol_kernel as lk
    from optionslab_tpu_torch.ops import slv_kernel as sk

    s = smile_dupire.surface
    surf = LocalVolSurface.from_numpy(s.k_grid.cpu().numpy(), s.t_grid.cpu().numpy(),
                                      s.grid.cpu().numpy(), 100.0, 0.05)
    assert surf.device.type == "cuda"
    lv_before, slv_before = lk._lv_cuda.launches, sk._slv_cuda.launches
    lv = lk.LocalVolKernelPricer(surf, 1.0, n_steps=12)
    slv = sk.SLVKernelPricer(surf, HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7, device="cuda"),
                             1.0, n_steps=12, n_cal_paths=16_384)
    assert lv.device.type == "cuda" and slv.device.type == "cuda"
    p, _, _ = lv.price(100.0, n_paths=lk.PATHS_PER_BLOCK)
    q, _, _ = slv.price("european", 100.0, n_paths=sk.PATHS_PER_BLOCK)
    assert p.device.type == "cuda" and q.device.type == "cuda"
    assert math.isfinite(p.item()) and math.isfinite(q.item())
    assert lk._lv_cuda.launches == lv_before + 1 and sk._slv_cuda.launches == slv_before + 1


def test_local_vol_and_slv_wrappers_reject_cpu_tensors(cuda_device, slv_pricer):
    from optionslab_tpu_torch.ops import local_vol_kernel as lk
    from optionslab_tpu_torch.ops import slv_kernel as sk

    cpu = torch.zeros(8 + 9 * 4)
    with pytest.raises(ValueError, match="CUDA"):
        lk._lv_cuda(0, 0, cpu, n_steps=4, n_blocks=1, cp=1.0, payoff="european")
    with pytest.raises(ValueError, match="contiguous"):
        lk._lv_cuda(0, 0, cpu.to(cuda_device), n_steps=5, n_blocks=1, cp=1.0, payoff="european")
    with pytest.raises(ValueError, match="contiguous"):
        sk._slv_cuda(0, 0, slv_pricer._params_vec("european", 100.0, 0.0).double(),
                     kind="european", n_steps=12, n_blocks=1, cp=1.0)


# ---------------------------------------------------------------------------
# The multi-asset kernel (csrc/multi_asset_mc.cu)
# ---------------------------------------------------------------------------
MA_RTOL = 1e-6  # per row: the paths are bitwise, the sums' order differs
MA_SPOTS = [100.0, 95.0, 105.0, 98.0]
MA_VOLS = [0.2, 0.25, 0.3, 0.22]
MA_CORR = [[1.0, 0.5, 0.3, 0.2], [0.5, 1.0, 0.4, 0.1], [0.3, 0.4, 1.0, 0.25],
           [0.2, 0.1, 0.25, 1.0]]


def _ma_vec(d, kind, n_steps, lr, device):
    from optionslab_tpu_torch.ops import multi_asset_kernel as mk

    corr = [row[:d] for row in MA_CORR[:d]]
    p = mk._params_vec(MA_SPOTS[:d], None, 100.0, 1.0, 0.05, MA_VOLS[:d], corr, 0.0, n_steps,
                       lr=lr, cv=kind == "basket_cv")[2]
    return torch.tensor(p, device=device)


# (d, kind, n_steps) × (sampler, lr); sobol is terminal-only, basket_cv has no lr
MA_CASES = [(d, kind, n_steps, sampler, lr and kind != "basket_cv")
            for d, kind, n_steps in ((2, "spread", 1), (3, "basket", 1), (4, "rainbow_worst", 1),
                                     (3, "basket_asian", 6), (4, "basket_cv", 1),
                                     (2, "basket_geo", 1))
            for sampler, lr in (("hash", False), ("prng", True), ("sobol", True))
            if sampler != "sobol" or n_steps == 1]


@pytest.mark.parametrize("d,kind,n_steps,sampler,lr", MA_CASES)
def test_multi_asset_kernel_matches_plain_on_card(cuda_device, d, kind, n_steps, sampler, lr):
    from optionslab_tpu_torch.ops import multi_asset_kernel as mk

    params = _ma_vec(d, kind, n_steps, lr, cuda_device)
    kw = dict(d=d, kind=kind, n_steps=n_steps, n_blocks=3, cp=-1.0 if d == 4 else 1.0,
              sampler=sampler, lr=lr)
    before = mk._ma_cuda.launches
    kern = mk._ma_cuda(5, 2, params, **kw).clone()
    assert mk._ma_cuda.launches == before + 1
    _assert_sums_close(kern, mk._ma_plain(5, 2, params, **kw), MA_RTOL)
    assert torch.equal(mk._ma_cuda(5, 2, params, **kw), kern)


# the launch plan's edges: one to thirteen path blocks (one a thread: 896
# CUDA blocks need seven chunks a row), 14 (seven chunks of two), 31 and 32
# (several a thread), 33 and 257; 1, 2 and 6 steps (short launches), each on
# three instances (d = 2, 3, 4; lr and price-only; prng and hash) and, at one
# step, sobol
MA_PLAN_BLOCKS = (1, 2, 4, 8, 9, 13, 14, 31, 32, 33, 257)
MA_PLAN_KERNELS = [(3, "basket_geo", "prng", True), (2, "basket", "hash", False),
                   (4, "rainbow_best", "prng", True), (3, "basket_geo", "sobol", False)]
MA_PLAN_CASES = [(nb, m, *k) for nb in MA_PLAN_BLOCKS for m in (1, 2, 6) for k in MA_PLAN_KERNELS
                 if k[2] != "sobol" or m == 1]


@pytest.mark.parametrize("n_blocks,n_steps,d,kind,sampler,lr", MA_PLAN_CASES)
def test_multi_asset_plan_edges_match_plain_on_card(cuda_device, n_blocks, n_steps, d, kind,
                                                    sampler, lr):
    """Per row within MA_RTOL of the plain version, and two launches
    bitwise equal."""
    from optionslab_tpu_torch.ops import multi_asset_kernel as mk

    params = _ma_vec(d, kind, n_steps, lr, cuda_device)
    kw = dict(d=d, kind=kind, n_steps=n_steps, n_blocks=n_blocks, cp=1.0, sampler=sampler, lr=lr)
    kern = mk._ma_cuda(5, 2, params, **kw).clone()
    _assert_sums_close(kern, mk._ma_plain(5, 2, params, **kw), MA_RTOL)
    assert torch.equal(mk._ma_cuda(5, 2, params, **kw), kern)


@pytest.mark.parametrize("n_blocks,n_steps,plan", [
    (4, 1, (4, 1)), (13, 1, (13, 1)), (14, 1, (7, 2)), (20, 8, (10, 2)), (21, 2, (7, 3)),
    (31, 1, (8, 4)), (257, 6, (65, 4)), (31, 9, None), (257, 64, None)])
def test_multi_asset_plan_covers_every_block_once(cuda_device, n_blocks, n_steps, plan):
    """The kernel source's launch plan (``multi_asset_plan``): every chunk
    holds a path block and the chunks reach n_blocks; a short launch (≤ 8
    steps) gives a thread up to 4 path blocks while ≥ 7 chunks a row are
    left; a long one (``plan`` None) takes the other path kernels' plan."""
    import ctypes

    from optionslab_tpu_torch.ops import _build
    from optionslab_tpu_torch.ops import multi_asset_kernel as mk

    n_chunks, per = mk._plan(n_blocks, n_steps)
    assert per * (n_chunks - 1) < n_blocks <= per * n_chunks
    assert (n_chunks, per) == (plan or ek._chunking(n_blocks))
    assert _build.load_library().multi_asset_plan(0, 1, ctypes.byref(ctypes.c_int()),
                                                  ctypes.byref(ctypes.c_int())) != 0


def test_multi_asset_entry_points_on_card(cuda_device):
    from optionslab_tpu_torch.models.multi_asset import geometric_basket_closed_form
    from optionslab_tpu_torch.ops import multi_asset_kernel as mk

    args = ("basket_geo", MA_SPOTS[:3], 100.0, 1.0, 0.05, MA_VOLS[:3],
            [row[:3] for row in MA_CORR[:3]])
    before = mk._ma_cuda.launches
    p, se, n = mk.multi_asset_kernel_price(*args, n_paths=4_000_000)
    g = mk.multi_asset_kernel_greeks(*args, n_paths=1_000_000)
    cv, cv_se, _ = mk.multi_asset_kernel_price("basket", *args[1:], n_paths=1_000_000,
                                               control_variate=True)
    assert mk._ma_cuda.launches == before + 3
    assert p.device.type == "cuda" and n >= 4_000_000
    spots, strike, t, r, vols, corr = args[1:]
    exact = geometric_basket_closed_form(spots, [1.0 / 3] * 3, strike, t, r, vols, corr).item()
    assert abs(p.item() - exact) < 5 * se.item()
    assert abs(g["price"].item() - exact) < 5 * g["std_error"].item()
    assert g["gamma"].shape == (3, 3) and math.isfinite(g["theta"]) and math.isfinite(cv.item())


def test_multi_asset_wrapper_rejects_bad_tensors(cuda_device):
    from optionslab_tpu_torch.ops import multi_asset_kernel as mk

    kw = dict(d=3, kind="basket", n_steps=1, n_blocks=1, cp=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        mk._ma_cuda(0, 0, _ma_vec(3, "basket", 1, False, "cpu"), **kw)
    with pytest.raises(ValueError, match="contiguous"):  # an lr vector without lr=True
        mk._ma_cuda(0, 0, _ma_vec(3, "basket", 1, True, cuda_device), **kw)


# The pricers that have no kernel run their tensor loops on the card.
def test_fdm_price_runs_on_card(cuda_device):
    from optionslab_tpu_torch.models.fdm import fdm_price

    book = _book(8, cuda_device)
    eu = fdm_price(book, 101, 100)
    am = fdm_price(book, 101, 100, american=True)
    assert eu.device.type == "cuda" and am.device.type == "cuda"
    exact = bs_price(book.spot, book.strike, book.maturity, book.rate, book.vol, book.cp,
                     book.dividend)
    assert (eu - exact).abs().max().item() < 0.02
    assert bool((am >= eu - 1e-4).all())


def _book_fields(n, device):
    """The fields of ``_book(n)`` as (n,) tensors: spot, strike, maturity,
    rate, vol, dividend, cp."""
    book = _book(n, device)
    return torch.broadcast_tensors(*(getattr(book, f) for f in (
        "spot", "strike", "maturity", "rate", "vol", "dividend", "cp")))


THETA_CASES = [(mode, theta, dtype) for mode in ("european", "projection", "howard")
               for theta in (0.5, 1.0) for dtype in (torch.float32, torch.float64)]


@pytest.mark.parametrize("mode,theta,dtype", THETA_CASES)
def test_theta_kernel_equals_plain_loop_on_card(cuda_device, mode, theta, dtype):
    """300 contracts (4 to a CUDA block, the last block ragged) at 41 x 20;
    Howard's later sweeps restart at the first changed row, and the blocks
    count the pivot nodes they form."""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp

    args = [t.to(dtype) for t in _book_fields(300, cuda_device)]
    _, ops = fdm._cn_operands(*args, 41, 20, theta, mode != "european")
    code = {"european": tp.EUROPEAN, "projection": tp.PROJECTION, "howard": tp.HOWARD}[mode]
    before = tp._theta_cuda.launches
    got, solves, pivots = tp._theta_cuda(*ops, code, count_solves=True)
    assert tp._theta_cuda.launches == before + 1
    want = tp._theta_plain(*ops, code)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    if code == tp.HOWARD:  # the first sweep of each step on the tables, then restarts
        assert bool((solves >= 20).all()) and bool((pivots >= 41).all())
        assert bool((pivots < 41 + (solves - 20) * 41 + 1).all())
    else:  # every solve on the tables, formed once
        assert bool((solves == 20).all()) and bool((pivots == 41).all())


def test_fdm_price_is_one_time_loop_launch_on_card(cuda_device):
    from optionslab_tpu_torch.models.fdm import fdm_price
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    book = _book(16, cuda_device)
    for kw in ({}, {"american": True}, {"american": True, "american_method": "projection"}):
        before = tp._theta_cuda.launches, tridiag._tridiag_cuda.launches
        fdm_price(book, 101, 50, **kw)
        torch.cuda.synchronize()
        assert (tp._theta_cuda.launches, tridiag._tridiag_cuda.launches) == (before[0] + 1,
                                                                             before[1])


@pytest.mark.parametrize("american", [False, True])
def test_fdm_gradient_on_card_equals_autograd_of_the_plain_loop(cuda_device, american):
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp

    fields = [t.double() for t in _book_fields(4, cuda_device)]
    grads = []
    for loop in (tp.theta_loop, tp._theta_plain):
        leaves = [t.clone().requires_grad_(True) for t in fields[:6]]
        args = leaves + fields[6:]
        x, ops = fdm._cn_operands(*args, 41, 20, 0.5, american)
        price = fdm._read_price(loop(*ops, tp.HOWARD if american else tp.EUROPEAN), x, leaves[0])
        grads.append(torch.autograd.grad(price.sum(), leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


THETA_CODES = ("european", "projection", "howard")


def _grad_gap(got, want) -> float:
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("mode", THETA_CODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theta_reverse_kernel_matches_plain_reverse_on_card(cuda_device, mode, dtype):
    """300 contracts at 41 x 20: the forward with its history is one launch,
    bit for bit the plain loop's (values, solutions, Howard's exercise sets);
    the reverse kernel's gradients of all ten operands within
    THETA_REVERSE_RTOL of the plain reverse on the same history, one launch
    and no tridiagonal launch, a second launch bit for bit the first."""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    code = THETA_CODES.index(mode)
    args = [t.to(dtype) for t in _book_fields(300, cuda_device)]
    _, ops = fdm._cn_operands(*args, 41, 20, 0.5, mode != "european")
    before = tp._theta_cuda.launches
    out, hist_u, hist_m = tp._theta_cuda(*ops, code, history=True)
    assert tp._theta_cuda.launches == before + 1
    want = tp._theta_plain(*ops, code, history=True)
    assert torch.equal(out, want[0]) and torch.equal(hist_u, want[1])
    assert (hist_m is None) == (want[2] is None)
    assert hist_m is None or torch.equal(hist_m, want[2])
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    g = torch.randn(out.shape, generator=gen, device=cuda_device, dtype=dtype)
    before = tp._theta_adjoint_cuda.launches, tridiag._tridiag_cuda.launches
    got = tp._theta_adjoint_cuda(*ops, code, hist_u, hist_m, g)
    again = tp._theta_adjoint_cuda(*ops, code, hist_u, hist_m, g)
    torch.cuda.synchronize()
    assert (tp._theta_adjoint_cuda.launches, tridiag._tridiag_cuda.launches) == (before[0] + 2,
                                                                                before[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = tp._theta_reverse_plain(*ops, code, hist_u, hist_m, g)
    assert _grad_gap(got, plain) < THETA_REVERSE_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theta_reverse_kernel_at_the_forwards_longest_grid(cuda_device, dtype):
    """Two contracts on the longest grid the forward takes with one contract
    a block (4,722 nodes in float32, 2,377 in float64), Howard, 4 steps: the
    reverse kernel launches, and is as close to the float64 plain reverse on
    the same history as the plain reverse of its own dtype, within twice
    that one's gap or THETA_REVERSE_RTOL. (On so long a grid float32's own
    rounding reaches ≈1e-3 of a gradient's largest entry, the plain reverse
    as much as the kernel.)"""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    size = torch.finfo(dtype).bits // 8
    n = 3
    while tp.tile_bytes(n + 1, 1, size) <= tridiag.SMEM_LIMIT:
        n += 1
    args = [t.to(dtype) for t in _book_fields(2, cuda_device)]
    _, ops = fdm._cn_operands(*args, n, 4, 0.5, True)
    out, hist_u, hist_m = tp._theta_cuda(*ops, tp.HOWARD, history=True)
    g = torch.ones_like(out)
    before = tp._theta_adjoint_cuda.launches
    got = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
    torch.cuda.synchronize()
    assert tp._theta_adjoint_cuda.launches == before + 1
    plain = tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, hist_m, g)
    exact = tp._theta_reverse_plain(*(o.double() for o in ops), tp.HOWARD, hist_u.double(),
                                    hist_m, g.double())
    own = _grad_gap(plain, exact)
    assert _grad_gap(got, exact) < max(2 * own, THETA_REVERSE_RTOL[dtype])


# the hand-built exercise sets (ops/theta_cases.py), all of
# them mixed in blocks over 300 contracts, and the Howard step that stops
# short of its fixed point with the set its last solve ran on
REVERSE_SETS = (*exercise_sets(41), "mixed", "short of the fixed point")


def _set_history(sets, names, steps, device):
    """Howard's history of exercise sets, (len(names), steps, n): contract b
    on ``sets[names[b]]`` at every step."""
    rows = torch.tensor(np.stack([sets[nm] for nm in names]), device=device)
    return rows[:, None].expand(len(names), steps, rows.shape[1]).contiguous()


@pytest.mark.parametrize("name", REVERSE_SETS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theta_reverse_kernel_on_hand_built_exercise_sets(cuda_device, name, dtype):
    """The reverse kernel on exercise sets built by hand (passed as the
    history's sets; the solutions a forward's, American operands, 41 nodes
    x 3 steps): each run of continuation rows on the LU tables, the UL
    tables or pivots of its own, each exercised row from its own equation.
    Within THETA_REVERSE_RTOL of the plain reverse on the same history, a
    second launch bit for bit the first."""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp

    n, steps = 41, 3
    sets = exercise_sets(n)
    if name == "short of the fixed point":
        ops = short_howard_step(dtype, cuda_device)
        _, hist_u, hist_m = tp._theta_cuda(*ops, tp.HOWARD, history=True)
    else:
        names = [name] * 4 if name != "mixed" else [list(sets)[b % len(sets)] for b in range(300)]
        args = [t.to(dtype) for t in _book_fields(len(names), cuda_device)]
        _, ops = fdm._cn_operands(*args, n, steps, 0.5, True)
        _, hist_u, _ = tp._theta_cuda(*ops, tp.HOWARD, history=True)
        hist_m = _set_history(sets, names, steps, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    g = torch.randn(hist_u[:, 0].shape, generator=gen, device=cuda_device, dtype=dtype)
    got = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
    again = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, hist_m, g)
    assert _grad_gap(got, plain) < THETA_REVERSE_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theta_reverse_kernel_reads_a_misaligned_set_view_exactly(cuda_device, dtype):
    """The exercise sets as a view whose rows start off 4-byte words (a
    contiguous slice along the batch, n·n_time odd) and whose last row ends
    at its storage's end: the kernel reads each row's bytes and nothing
    around them, bit for bit its launch on a fresh copy of the same sets."""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp

    n, steps = 41, 3
    sets = exercise_sets(n)
    names = [list(sets)[b % len(sets)] for b in range(2 * len(sets))]
    args = [t.to(dtype) for t in _book_fields(len(names), cuda_device)]
    _, ops = fdm._cn_operands(*args, n, steps, 0.5, True)
    _, hist_u, _ = tp._theta_cuda(*ops, tp.HOWARD, history=True)
    fresh = _set_history(sets, names, steps, cuda_device)
    store = torch.empty(len(names) * steps * n + 1, dtype=torch.bool, device=cuda_device)
    view = store[1:].view(fresh.shape)
    view.copy_(fresh)
    assert view.is_contiguous() and view.data_ptr() % 4 != 0
    g = torch.ones_like(hist_u[:, 0])
    got = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, view, g)
    want = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, fresh, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theta_reverse_kernel_on_hand_built_sets_at_the_longest_grid(cuda_device, dtype):
    """The device route: one contract on each hand-built exercise set at the
    longest grid the forward takes, 2 steps, held to the float64 plain
    reverse on the same history as closely as the plain reverse of its own
    dtype (as at the longest grid above), two launches bit for bit."""
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    size = torch.finfo(dtype).bits // 8
    n = 3
    while tp.tile_bytes(n + 1, 1, size) <= tridiag.SMEM_LIMIT:
        n += 1
    sets = exercise_sets(n)
    assert tp.adjoint_plan(len(sets), n, size, tridiag.sm_count(cuda_device.index))[1]
    args = [t.to(dtype) for t in _book_fields(len(sets), cuda_device)]
    _, ops = fdm._cn_operands(*args, n, 2, 0.5, True)
    _, hist_u, _ = tp._theta_cuda(*ops, tp.HOWARD, history=True)
    hist_m = _set_history(sets, list(sets), 2, cuda_device)
    g = torch.ones_like(hist_u[:, 0])
    got = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
    again = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, hist_m, g)
    exact = tp._theta_reverse_plain(*(o.double() for o in ops), tp.HOWARD, hist_u.double(),
                                    hist_m, g.double())
    own = _grad_gap(plain, exact)
    assert _grad_gap(got, exact) < max(2 * own, THETA_REVERSE_RTOL[dtype])


@pytest.mark.parametrize("american", [False, True])
def test_fdm_gradient_on_card_is_one_forward_and_one_reverse_launch(cuda_device, american):
    """The first-order gradient: one forward launch with its history and one
    reverse launch, no tridiagonal launch; a second derivative (a graph of
    the gradient) runs the plain loop again under autograd instead, with no
    reverse launch."""
    from optionslab_tpu_torch.models.fdm import fdm_price
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    fields = [t.double() for t in _book_fields(16, cuda_device)]

    def counts():
        torch.cuda.synchronize()
        return (tp._theta_cuda.launches, tp._theta_adjoint_cuda.launches,
                tridiag._tridiag_cuda.launches)

    leaves = [t.clone().requires_grad_(True) for t in fields[:6]]
    before = counts()
    price = fdm_price(ContractBatch(*leaves, fields[6]), 41, 20, american=american)
    grads = torch.autograd.grad(price.sum(), leaves)
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    assert bool(((grads[0] * fields[6]) > 0).all())
    vol = fields[4].clone().requires_grad_(True)  # the loop's operands move with σ
    price = fdm_price(ContractBatch(*fields[:4], vol, *fields[5:]), 41, 20, american=american)
    mid = counts()
    (vega,) = torch.autograd.grad(price.sum(), vol, create_graph=True)
    torch.autograd.grad(vega.sum(), vol)
    end = counts()
    assert mid[1] == end[1] == before[1] + 1 and end[2] > mid[2]


@pytest.mark.parametrize("american", [False, True])
@pytest.mark.parametrize("divs", [[(0.3, 2.0)], [(0.3, 2.0), (0.8, 2.5)]])
def test_dividend_pde_is_one_theta_launch_on_card(cuda_device, american, divs):
    """The dividend PDE's loop with its jump table: the jump-table kernel bit
    for bit its plain loop (the warp-partitioned solve) at 101 x 100; the
    public call one launch of it and none of the θ-scheme or tridiagonal
    kernels."""
    from optionslab_tpu_torch.models import dividends as dv
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    steps = dv._div_steps([t for t, _ in divs], 1.0, 100)
    for cp in (1.0, -1.0):
        _, _, ops, jumps = dv._fdm_div_operands(
            100.0, 95.0, 1.0, 0.05, 0.2, [d for _, d in divs], cp=cp, n_space=101, n_time=100,
            american=american, div_steps=steps, device=cuda_device)
        mode = tp.HOWARD if american else tp.EUROPEAN
        got = tp._theta_jumps_cuda(*ops, mode, jumps)
        want = tp._theta_plain(*ops, mode, jumps=jumps)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        before = (tp._theta_jumps_cuda.launches, tp._theta_cuda.launches,
                  tridiag._tridiag_cuda.launches)
        price = dv.fdm_price_discrete_dividends(100.0, 95.0, 1.0, 0.05, 0.2, divs, cp, american,
                                                101, 100, device="cuda")
        torch.cuda.synchronize()
        assert (tp._theta_jumps_cuda.launches, tp._theta_cuda.launches,
                tridiag._tridiag_cuda.launches) == (before[0] + 1, before[1], before[2])
        assert math.isfinite(price) and price > 0.0


def _div_loop_operands(device, n_space, n_time, mode, dtype, cp=-1.0):
    from optionslab_tpu_torch.models import dividends as dv
    from optionslab_tpu_torch.ops import theta_pde as tp

    divs = [(0.3, 2.0), (0.8, 2.5)]
    steps = dv._div_steps([t for t, _ in divs], 1.0, n_time)
    _, _, ops, jumps = dv._fdm_div_operands(
        100.0, 105.0, 1.0, 0.05, 0.2, [d for _, d in divs], cp=cp, n_space=n_space,
        n_time=n_time, american=mode != tp.EUROPEAN, div_steps=steps, device=device)
    return [o.to(dtype) for o in ops], tp.Jumps(jumps.steps, jumps.index, jumps.weight.to(dtype))


@pytest.mark.parametrize("mode", ["european", "projection", "howard"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jump_kernel_every_mode_bitwise_on_card(cuda_device, mode, dtype):
    """The jump-table kernel bit for bit its plain loop in every mode and both
    dtypes at 401 x 60 (float32: 16 rows a lane in registers; float64: the
    rows in device memory), a put with two dividends."""
    from optionslab_tpu_torch.ops import theta_pde as tp

    code = {"european": tp.EUROPEAN, "projection": tp.PROJECTION, "howard": tp.HOWARD}[mode]
    ops, jumps = _div_loop_operands(cuda_device, 401, 60, code, dtype)
    got, solves, _ = tp._theta_jumps_cuda(*ops, code, jumps, count_solves=True)
    want = tp._theta_plain(*ops, code, jumps=jumps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(solves[0]) >= 60 and (int(solves[0]) == 60) == (code != tp.HOWARD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_jump_kernel_at_the_largest_old_grid_on_card(cuda_device, dtype):
    """The longest grid the θ-scheme kernel's jump-table mode took (one
    contract's tile in shared memory: 4,722 nodes float32, 2,377 float64)
    runs, Howard, bit for bit its plain loop; a grid longer still too."""
    from optionslab_tpu_torch.ops import theta_pde as tp
    from optionslab_tpu_torch.ops import tridiag

    size = torch.finfo(dtype).bits // 8
    n = 3
    while tp.tile_bytes(n + 1, 1, size) <= tridiag.SMEM_LIMIT:
        n += 1
    for n_space in (n - (n + 1) % 2, n + 200 + (n + 1) % 2):
        ops, jumps = _div_loop_operands(cuda_device, n_space, 8, tp.HOWARD, dtype)
        got = tp._theta_jumps_cuda(*ops, tp.HOWARD, jumps)
        want = tp._theta_plain(*ops, tp.HOWARD, jumps=jumps)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["european", "projection", "bermudan"])
def test_lv_kernel_equals_plain_loop_on_card(smile_dupire, mode):
    """The local-vol loop on the smile's step tables, a call and a put as a
    book of two, 101 nodes x 48 steps (Bermudan: 6 dates of 8): bit for bit
    the plain loop, continuation slices included, in one launch."""
    from optionslab_tpu_torch.models import local_vol as lv
    from optionslab_tpu_torch.ops import lv_pde

    s = smile_dupire.surface
    code = ("european", "projection", "bermudan").index(mode)
    tabs = [lv._lv_tables(s.k_grid, s.t_grid, s.grid, 100.0, 0.05, 0.01, strike, 1.0, cp, 101,
                          48, mode == "bermudan")[1:] for strike, cp in ((105.0, 1.0),
                                                                         (95.0, -1.0))]
    intr, lo, di, up, ends = (torch.stack(parts) for parts in zip(*tabs))
    ops = (lo, di, up, ends, intr, intr)
    before = lv_pde._lv_cuda.launches
    got = lv_pde._lv_cuda(*ops, code, 8)
    assert lv_pde._lv_cuda.launches == before + 1
    want = lv_pde._lv_plain(*ops, code, 8)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    assert got[1] is None or (got[1].shape == (2, 5, 101) and torch.equal(got[1], want[1]))


def _lv_operands(dupire, n, n_time, mode, contracts, dtype):
    from optionslab_tpu_torch.models import local_vol as lv

    s = dupire.surface
    tabs = [lv._lv_tables(s.k_grid, s.t_grid, s.grid, 100.0, 0.05, 0.01, strike, 1.0, cp, n,
                          n_time, mode == "bermudan")[1:] for strike, cp in contracts]
    intr, lo, di, up, ends = (torch.stack(parts).to(dtype) for parts in zip(*tabs))
    return lo, di, up, ends, intr, intr


@pytest.mark.parametrize("mode", ["european", "projection", "bermudan"])
def test_lv_kernel_float64_bitwise_on_card(smile_dupire, mode):
    """The local-vol loop in float64, a call and a put at 201 x 48 (8 rows
    a lane in registers) and a put at 401 x 48 (the rows in device memory):
    bit for bit the plain loop, slices included."""
    from optionslab_tpu_torch.ops import lv_pde

    code = ("european", "projection", "bermudan").index(mode)
    for n, contracts in ((201, ((105.0, 1.0), (95.0, -1.0))), (401, ((95.0, -1.0),))):
        ops = _lv_operands(smile_dupire, n, 48, mode, contracts, torch.float64)
        got = lv_pde._lv_cuda(*ops, code, 8)
        want = lv_pde._lv_plain(*ops, code, 8)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert got[1] is None or torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lv_kernel_at_the_largest_old_grid_on_card(smile_dupire, dtype):
    """The longest grid the local-vol kernel took before (its tile in one
    block's shared memory: 5,260 nodes float32, 2,625 float64) runs, a
    Bermudan put of 4 dates x 4 steps, bit for bit the plain loop."""
    from optionslab_tpu_torch.ops import lv_pde
    from optionslab_tpu_torch.ops import tridiag

    size = torch.finfo(dtype).bits // 8
    n = 3
    while -(-(11 * (n + 1 + 16) + 4) * size // 8) * 8 + 256 <= tridiag.SMEM_LIMIT:
        n += 1
    assert n >= (5000 if size == 4 else 2500)
    ops = _lv_operands(smile_dupire, n, 16, "bermudan", ((95.0, -1.0),), dtype)
    got = lv_pde._lv_cuda(*ops, lv_pde.BERMUDAN, 4)
    want = lv_pde._lv_plain(*ops, lv_pde.BERMUDAN, 4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_lv_book_rows_equal_each_contract_alone_on_card(smile_dupire):
    """A book of three local-vol contracts in one launch (a CUDA block each):
    each row bit for bit that contract launched alone, Bermudan slices too."""
    from optionslab_tpu_torch.ops import lv_pde

    contracts = ((105.0, 1.0), (95.0, -1.0), (100.0, -1.0))
    ops = _lv_operands(smile_dupire, 201, 48, "bermudan", contracts, torch.float32)
    book = lv_pde._lv_cuda(*ops, lv_pde.BERMUDAN, 8)
    for i in range(3):
        alone = lv_pde._lv_cuda(*(o[i:i + 1] for o in ops), lv_pde.BERMUDAN, 8)
        torch.cuda.synchronize()
        assert torch.equal(book[0][i:i + 1], alone[0]) and torch.equal(book[1][i:i + 1],
                                                                         alone[1])


def test_local_vol_pdes_are_one_launch_on_card(smile_dupire):
    """``DupireLocalVol.price`` (European and the American PDE) and
    ``lv_bermudan_slices``: one launch of the local-vol loop each, no
    tridiagonal launch."""
    from optionslab_tpu_torch.models.local_vol import _lv_solve
    from optionslab_tpu_torch.models.local_vol_american import lv_bermudan_slices
    from optionslab_tpu_torch.ops import lv_pde, tridiag

    s = smile_dupire.surface
    grids = (s.k_grid, s.t_grid, s.grid)
    calls = (lambda: smile_dupire.price(100.0, 100.0, 1.0),
             lambda: _lv_solve(*grids, 100.0, 0.05, 0.0, 100.0, 1.0, -1.0, american=True),
             lambda: lv_bermudan_slices(*grids, 100.0, 0.05, 0.0, 100.0, 1.0, -1.0, 5, 4, 201))
    for call in calls:
        before = lv_pde._lv_cuda.launches, tridiag._tridiag_cuda.launches
        out = call()
        torch.cuda.synchronize()
        assert (lv_pde._lv_cuda.launches, tridiag._tridiag_cuda.launches) == (before[0] + 1,
                                                                             before[1])
        assert bool(torch.isfinite(out if isinstance(out, torch.Tensor) else out[1]).all())


def test_american_price_interval_runs_on_card(cuda_device):
    from optionslab_tpu_torch.models.american import american_price_interval

    out = american_price_interval(100.0, 100.0, 1.0, 0.05, 0.2, -1.0, n_dates=9, n_grid=128,
                                  n_outer=8192, device="cuda")
    assert all(v.device.type == "cuda" for v in out.values())
    assert 5.9 < out["lower"].item() <= out["upper"].item() < 6.2
    assert out["width"].item() < 0.01


def test_local_vol_american_bracket_runs_on_card(cuda_device):
    from optionslab_tpu_torch.models.local_vol import DupireLocalVol, sample_smile_iv_fn
    from optionslab_tpu_torch.models.local_vol_american import local_vol_american_bracket

    dup = DupireLocalVol(sample_smile_iv_fn(), 100.0, 0.05, device="cuda")
    out = local_vol_american_bracket(dup, 100.0, 1.0, n_dates=9, n_sub=4, n_outer=1024,
                                     n_inner=256, n_space=101, steps_per_date=4, device="cuda")
    assert all(isinstance(v, (float, int)) for v in out.values())
    assert out["lower"] > 6.3 and out["width"] < 0.05


def test_heston_adi_runs_on_card_through_the_tridiagonal_kernel(cuda_device):
    """The whole Douglas loop is one launch of the ADI kernel, whose sweeps
    run the tridiagonal kernel's device functions (``tridiag.cuh``): no
    launch of the tridiagonal kernel itself."""
    from optionslab_tpu_torch.models.heston import HestonParams, heston_price
    from optionslab_tpu_torch.models.heston_fdm import heston_fdm_price
    from optionslab_tpu_torch.ops import heston_adi, tridiag

    par = HestonParams.make(0.04, 2.0, 0.05, 0.3, -0.7)  # on the CPU: moved to the card
    before = tridiag._tridiag_cuda.launches, heston_adi._adi_cuda.launches
    pde = heston_fdm_price(100.0, 100.0, 1.0, 0.05, par, n_x=101, n_v=51, n_t=50)
    assert (tridiag._tridiag_cuda.launches, heston_adi._adi_cuda.launches) == (before[0],
                                                                               before[1] + 1)
    assert pde.device.type == "cuda"
    lw = heston_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, device=cuda_device),
                      par.to(device=cuda_device))
    assert abs(pde.item() / lw.item() - 1.0) < 5e-3


def test_slice_brackets_run_on_card(cuda_device):
    from optionslab_tpu_torch.models.heston import HestonParams
    from optionslab_tpu_torch.models.heston_american import heston_american_bracket
    from optionslab_tpu_torch.models.rbergomi import RBergomiParams
    from optionslab_tpu_torch.models.rbergomi_american import rbergomi_american_bracket

    b = heston_american_bracket(100.0, 100.0, 1.0, 0.05, HestonParams.make(), n_dates=8,
                                method="adi", n_x=101, n_v=51, steps_per_date=4,
                                n_outer=1024, n_inner=512)
    assert b["method"] == "adi" and abs(b["adi_bermudan"] - b["lower"]) < 0.05
    assert b["width"] < 0.02
    r = rbergomi_american_bracket(100.0, 105.0, 0.5, 0.06, RBergomiParams(), n_dates=6,
                                  n_fit=16_384, n_lower=32_768, n_outer=256, n_inner=256)
    assert r["lower"] <= r["upper"] + 3 * (r["lower_se"] + r["upper_se"])


def test_one_shard_mesh_equals_the_unsharded_kernel_on_card(cuda_device):
    """A one-device mesh launches the GBM kernel once at block offset 0: the
    unsharded call's bits. Two shards of the same card launch it twice, at
    offsets 0 and n/2, and agree within the association tolerances."""
    from optionslab_tpu_torch.parallel import make_mesh, sharded_pallas_greeks

    book = _book(4, cuda_device)
    flat = gk.gbm_mc_price_greeks(book, n_paths=2_000_000, seed=5)
    before = gk._gbm_moments_cuda.launches
    one = sharded_pallas_greeks(book, make_mesh(1, devices=[cuda_device]), n_paths=2_000_000,
                                seed=5)
    assert gk._gbm_moments_cuda.launches == before + 1
    for k, v in flat.items():
        assert torch.equal(one[k], v), k
    two = sharded_pallas_greeks(book, make_mesh(2, devices=[cuda_device] * 2),
                                n_paths=one["n_paths"], seed=5)
    assert gk._gbm_moments_cuda.launches == before + 3
    assert two["price"].device == cuda_device
    torch.testing.assert_close(two["price"], flat["price"], rtol=2e-5, atol=0)
    torch.testing.assert_close(two["delta"], flat["delta"], rtol=2e-4, atol=0)


def test_sharded_mc_price_two_shards_bit_identical_on_card(cuda_device):
    """The tensor engine on a 2-shard mesh of one card: the same bits as one
    shard, on the card."""
    from optionslab_tpu_torch.models.monte_carlo import MCConfig
    from optionslab_tpu_torch.parallel import make_mesh, sharded_mc_price

    book = _book(8, cuda_device)
    cfg = MCConfig(n_paths=200_000)
    one = sharded_mc_price(book, 1, cfg, make_mesh(1, devices=[cuda_device]))
    two = sharded_mc_price(book, 1, cfg, make_mesh(2, devices=[cuda_device] * 2))
    assert one.price.device == cuda_device
    assert torch.equal(one.price, two.price) and torch.equal(one.std_error, two.std_error)
    bs = bs_price(book.spot, book.strike, book.maturity, book.rate, book.vol, book.cp,
                  book.dividend)
    assert torch.all((one.price - bs).abs() < 5 * one.std_error)


def _adi_case(kind, device, n_x=41, n_v=21):
    """(ops, slv, mode, steps a date) of the ADI loop, by default at the CPU
    tests' grid."""
    import numpy as np

    from optionslab_tpu_torch.models import heston_fdm as hf
    from optionslab_tpu_torch.models.heston import HestonParams
    from optionslab_tpu_torch.ops import heston_adi as ha

    par = HestonParams.make(0.04, 2.0, 0.05, 0.3, -0.7, device=device)
    if kind == "slv":
        rng = np.random.default_rng(3)
        x_rows = torch.tensor(np.sort(rng.uniform(-1, 1, (8, 9)), axis=1), dtype=torch.float32)
        l_rows = 1.0 + 0.3 * torch.sin(2.0 * x_rows)
        ops, slv, _, _ = hf._slv_setup(100.0, 100.0, 1.0, 0.03, 0.0, -1.0, par, 0.7, x_rows,
                                       l_rows, n_x, n_v, 4, 4, device)
        return ops, slv, ha.BERMUDAN, 4
    american = kind != "european"
    ops, _ = hf._adi_setup(100.0, 100.0, 1.0, 0.05, 0.0, -1.0 if american else 1.0, par, n_x,
                           n_v, 16, american, device)
    mode = {"european": ha.EUROPEAN, "american": ha.AMERICAN, "bermudan": ha.BERMUDAN}[kind]
    return ops, None, mode, 4 if kind == "bermudan" else 1


@pytest.mark.parametrize("kind", ["european", "american", "bermudan", "slv"])
def test_heston_adi_kernel_equals_plain_loop_on_card(cuda_device, kind):
    """At 41 x 21 the plan takes a cluster of 3 CTAs."""
    from optionslab_tpu_torch.ops import heston_adi as ha

    ops, slv, mode, spd = _adi_case(kind, cuda_device)
    history = kind in ("european", "american")
    assert ha.cluster_plan(21, 41) == 3
    before = ha._adi_cuda.launches
    got = ha._adi_cuda(ops, ops.intrinsic, mode, spd, slv, history)
    assert ha._adi_cuda.launches == before + 1
    want = ha._adi_plain(ops, ops.intrinsic, mode, spd, slv, history)
    assert torch.equal(got[0], want[0])
    if mode == ha.BERMUDAN:
        assert torch.equal(got[1], want[1])
    for g, w in zip(got[2] or (), want[2] or ()):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["european", "american"])
def test_heston_adi_adjoint_matches_plain_reverse_on_card(cuda_device, kind):
    from optionslab_tpu_torch.ops import heston_adi as ha

    ops, _, mode, _ = _adi_case(kind, cuda_device)
    g = torch.linspace(-1.0, 1.0, ops.intrinsic.numel(), device=cuda_device).view(21, 41)
    _, _, hist = ha._adi_cuda(ops, ops.intrinsic, mode, history=True)
    before = ha._adi_adjoint_cuda.launches
    got = ha._adi_adjoint_cuda(ops, ops.intrinsic, hist, g, kind == "american")
    assert ha._adi_adjoint_cuda.launches == before + 1
    want = ha._adi_reverse_plain(ops, ops.intrinsic, hist, g, kind == "american")
    for name, a, b in zip(ha._INPUTS, got, want):
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 1e-5 * b.abs().max().clamp_min(1e-30), name


@pytest.mark.parametrize("kind", ["european", "american"])
def test_heston_adi_adjoint_on_both_routes_is_repeatable_on_card(cuda_device, kind):
    """The reverse kernel on a cluster at 41 x 21 and on the cooperative
    route at 1001 x 201 (no cluster holds its bands): one launch, the plain
    reverse's gradients within 1e-5 of each one's largest entry, and a second
    launch bit for bit the first."""
    from optionslab_tpu_torch.ops import heston_adi as ha

    for n_x, n_v in ((41, 21), (1001, 201)):
        ops, _, mode, _ = _adi_case(kind, cuda_device, n_x, n_v)
        ctas, blocks = ha._adjoint_route(n_v, n_x, cuda_device)
        assert (ctas == 0) == (n_x == 1001) and blocks >= 1
        g = torch.linspace(-1.0, 1.0, n_v * n_x, device=cuda_device).view(n_v, n_x)
        _, _, hist = ha._adi_cuda(ops, ops.intrinsic, mode, history=True)
        before = ha._adi_adjoint_cuda.launches
        got = ha._adi_adjoint_cuda(ops, ops.intrinsic, hist, g, kind == "american")
        again = ha._adi_adjoint_cuda(ops, ops.intrinsic, hist, g, kind == "american")
        assert ha._adi_adjoint_cuda.launches == before + 2
        want = ha._adi_reverse_plain(ops, ops.intrinsic, hist, g, kind == "american")
        for name, a, b, c in zip(ha._INPUTS, got, want, again):
            assert torch.equal(a, c), name
            assert (a - b).abs().max() <= 1e-5 * b.abs().max().clamp_min(1e-30), name


def test_heston_fdm_greeks_on_card_one_reverse_launch(cuda_device):
    from optionslab_tpu_torch.models.heston import HestonParams
    from optionslab_tpu_torch.models.heston_fdm import heston_fdm_greeks
    from optionslab_tpu_torch.ops import heston_adi as ha
    from optionslab_tpu_torch.ops import tridiag

    args = (100.0, 105.0, 0.7, 0.03, HestonParams.make(), 0.01, "put", True, 41, 21, 16)
    before = (ha._adi_cuda.launches, ha._adi_adjoint_cuda.launches,
              tridiag._tridiag_cuda.launches)
    card = heston_fdm_greeks(*args, device="cuda")
    assert (ha._adi_cuda.launches, ha._adi_adjoint_cuda.launches,
            tridiag._tridiag_cuda.launches) == (before[0] + 2, before[1] + 1, before[2])
    cpu = heston_fdm_greeks(*args, device="cpu")  # the plain loop and reverse, float32
    for k, v in cpu.items():
        rel = 1e-3 if k == "vomma_v0" else 1e-4  # tests/test_torch_heston_fdm.py's bounds
        assert card[k] == pytest.approx(v, rel=rel, abs=1e-5), k


def test_heston_adi_wrappers_reject_bad_inputs_on_card(cuda_device):
    from optionslab_tpu_torch.ops import heston_adi as ha

    ops, _, _, _ = _adi_case("european", cuda_device)
    with pytest.raises(ValueError, match="float32 tensors"):
        ha._adi_cuda(ops, ops.intrinsic.double(), ha.EUROPEAN)
    with pytest.raises(ValueError, match="float32 tensors"):
        ha._adi_cuda(ops._replace(bounds=ops.bounds.cpu()), ops.intrinsic, ha.EUROPEAN)
    with pytest.raises(ValueError, match="Bermudan mode only"):
        slv_ops, slv, _, _ = _adi_case("slv", cuda_device)
        ha._adi_cuda(slv_ops, slv_ops.intrinsic, ha.AMERICAN, 1, slv)


@pytest.mark.parametrize("kind", ["european", "american", "bermudan", "slv"])
def test_heston_adi_takes_the_cooperative_route_beyond_a_cluster_on_card(cuda_device, kind):
    """1001 x 201: no cluster of 16 CTAs holds it, so the plan is the
    cooperative kernel, bitwise the plain loop (the history or the
    continuation slices too)."""
    from optionslab_tpu_torch.ops import heston_adi as ha

    ops, slv, mode, spd = _adi_case(kind, cuda_device, 1001, 201)
    history = kind in ("european", "american")
    assert ha.cluster_plan(201, 1001) == 0
    got = ha._adi_cuda(ops, ops.intrinsic, mode, spd, slv, history)
    want = ha._adi_plain(ops, ops.intrinsic, mode, spd, slv, history)
    assert torch.equal(got[0], want[0])
    if mode == ha.BERMUDAN:
        assert torch.equal(got[1], want[1])
    for g, w in zip(got[2] or (), want[2] or ()):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quotient_on_a_reciprocal_equals_division_on_card(cuda_device, dtype):
    """The solves' fast quotient (and its slow path where flagged) against
    the division intrinsic and torch's division, bitwise, on 2^20 random bit
    patterns of each operand: every exponent, zeros, subnormals, infinities
    and NaNs."""
    from optionslab_tpu_torch.ops import _build

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    info = torch.iinfo(ints)
    num, den = (torch.randint(info.min, info.max, (1 << 20,), generator=gen, dtype=ints,
                              device=cuda_device).view(dtype) for _ in range(2))
    out = torch.empty_like(num)
    counts = torch.tensor([0, 0, -1], dtype=torch.int64, device=cuda_device)
    err = _build.load_library().tridiag_div_check_launch(
        num.data_ptr(), den.data_ptr(), out.data_ptr(), counts.data_ptr(), num.numel(),
        0 if dtype == torch.float32 else 1, 0, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = num / den
    torch.cuda.synchronize()
    bad, fast, _ = counts.tolist()
    assert bad == 0 and fast > num.numel() // 4
    assert bool(((out.view(ints) == want.view(ints)) | (out.isnan() & want.isnan())).all())
