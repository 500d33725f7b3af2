#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``optionslab_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):

1. device   — a CUDA card is required; prints its name and power limit;
2. build    — compiles ``optionslab_tpu_torch/csrc/*.cu`` with nvcc (one
              process per source, all started together);
3. parity   — every kernel against its plain torch version on the card,
              per-row moment sums: the GBM kernel for every sampler with
              and without Greeks at small shapes and at its main path's
              shapes; the exotic price kernel for every payoff kind with
              and without LR scores under ``hash`` and ``prng``, bridge QMC,
              books of 2, 8 and 128 contracts; the exotic Greeks kernel for
              its four kinds and both signs; both exotic kernels at the
              exotic path's own shapes with ``prng``; the four Heston
              kernels (Euler price/vega/ladder, QE, QE ladder, chain) for
              every mode and sampler at small shapes and at the Heston
              path's shapes, the QE ladder also at the edges of its 7-step
              draw chunks (1, 6, 8 and 32 steps on 1 and 70 blocks, both
              samplers and signs) within 1e-6 per row and bitwise equal
              over two launches; the Heston exotic kernel for all 22 kinds with
              and without LR under ``hash`` and ``prng`` (both signs where
              the payoff takes one), QE, Bates jumps under both schemes,
              bridge QMC, books of 2, 8 and 128 contracts, and at the
              Heston exotic path's shapes;
4. main     — the GBM path at full size through ``MonteCarloPricer``: 1e9
              paths on one contract, a 1024-contract book at 1e6 paths each,
              and the price-only sibling, checked against Black–Scholes;
5. server   — ``PricingServer`` on the card answering ``/mc`` over a socket;
6. exotic   — the exotic path through its entry points at the JAX
              package's bench sizes (Asian 4M x 252, pathwise Greeks
              8M x 252, barrier LR ladder 16M x 64, an 8-strike book 1M x 64
              per contract, autocall/cliquet/range accrual), against closed
              forms, Black–Scholes and the scan engine, with warm wall times;
7. exotic server — ``/exotic`` and ``/book/exotic`` over a socket;
8. heston   — the Heston European path through its entry points: Euler
              price, v0-vega and full ladder at 8,388,608 x 252, QE price
              and QE ladder at 8,388,608 x 32, bridge QMC at 4,194,304 x 64,
              a 40-quote chain at 1,048,576 paths, ``calibrate_heston_mc``
              (200 Adam steps, exactly 202 chain launches), the
              ``HestonPricer`` kernel engine, and ``/price`` with
              ``model: "heston"``; against Lewis and autograd of Lewis;
9. heston exotic — the Heston/Bates exotic path through its entry points
              at the JAX package's bench sizes (Asian and barrier LR
              8,388,608 x 64, 8-strike books 1,000,000 x 64 per contract,
              Bates barrier 8,388,608 x 64 and Bates QE Asian x 16,
              autocall/cliquet/range accrual 4,194,304 x 252 price and LR,
              bridge QMC 4,194,304 x 64), against the exact in/out and
              touch/no-touch identities, Lewis, Bates, the GBM closed forms,
              the scan engine and CRN finite differences, with warm wall
              times; then ``/exotic``, ``/book/exotic`` and ``/price`` bates
              over a socket;
10. smile   — the local-vol kernel (20 payoffs × greeks × hash/prng × cp,
              bridge QMC) and the SLV kernel (23 kinds × lr × hash/prng × cp)
              against their plain versions at small shapes and at their
              paths' shapes; then the local-vol path at the JAX package's
              bench size (``LocalVolKernelPricer`` 8,126,464 x 100 on the
              sample smile) against Black–Scholes on a flat surface, the
              Dupire PDE, the scan engine, the in/out and touch identities,
              the GBM exotic kernel and CRN finite differences; the SLV path
              (the 262,144-particle calibration on the card, the barrier
              8,126,464 x 64) against the PDE and the LV kernel at mixing 0,
              0.5 and 1, the replay scan on the same rows, finite
              differences and the structured scans; then ``/exotic`` lv and
              slv over a socket;
11. multi-asset — the multi-asset kernel (every kind × lr × d = 2, 3, 4 ×
              hash/prng × cp, sobol on the terminal kinds, basket_cv) against
              its plain version per row within 1e-6 and bitwise equal over
              two launches, at 2 blocks, at the edges of its launch plan and
              at the path's shapes; then the path at the JAX package's bench shapes
              (3 assets: the basket Asian 4,063,232 x 252 against the scan
              engine, its LR ladder at x 64 against CRN finite differences of
              the kernel price, the geometric basket's price and ladder at
              x 1 against its closed form and autograd, spread K = 0 against
              Margrabe, sobol against the prng error bar, the geometric
              control variate against plain), then ``/basket`` over a socket;
12. launches — each kernel's launch count over its path's phases (the counts
              are set to 0 just before a path and read just after it);
13. timing  — device ms by CUDA events of each kernel and its plain
              version at its path's shapes, beside the least time the card
              could take (from the kernel's SASS, ``ops/sass_bound.py``);
              the multi-asset one-step launches (4,063,232 x 1 LR, price
              and sobol, /basket's default 524,288 x 1) on the device alone
              by a CUDA graph of calls, beside an empty launch; the QE
              ladder's and every multi-asset instance's registers and CUDA
              blocks per SM and their issue shares; and the SASS digests
              of the QE instances it shares a source or a header with,
              beside the ones it was split from;
14. pricers — the pricers that have no kernel, once each on the card at the
              reference's default sizes, against their oracles: the
              CRR/Leisen–Reimer lattice (1024 contracts x 512 steps,
              European and American; the Greeks of 64), the Crank–Nicolson
              PDE (256 contracts at 201 x 200, European and Howard
              American, one θ-scheme launch a call, and one gradient),
              implied vol (1024 round trips), Merton/Kou and
              VG/NIG (1,048,576 paths against the series, parity and the
              Lewis prices), SABR calibration, the variance-swap closed forms
              against the CIR Monte Carlo, the bridge-QMC geometric Asian,
              the certified GBM American brackets (grid, closed form) and
              grid Greeks against CRR@2001, and the local-vol bracket on the
              sample smile and a flat surface; each call's warm wall time
              and CUDA kernel count, and none of the eleven kernels
              launched; then ``/price`` binomial|vg|nig|merton, ``/iv``,
              ``/varswap`` and ``/american`` over a socket;
15. tridiag — the batched tridiagonal kernel (``csrc/tridiag.cu``) against
              its plain version, bitwise, at the slice's shapes (the ADI's
              101 x 201 row sweep and 201 x 101 column sweep on shared
              coefficients and a transposed right-hand side, the dividend
              PDE's 1 x 401, the Crank–Nicolson book's 256 x 201) in float32
              and float64, one launch a solve; its adjoint backward against
              autograd of the plain loop; device ms beside
              ``torch.linalg.solve`` on the dense matrix and beside the
              bound, the larger of the bytes and the dependent chain timed
              by the chain probe (run before the pricers; every PDE of the
              pricers and of the slice that steps on the host then solves
              through it, one launch a solve: 400 for one ADI price);
16. slice   — the Heston ADI (201 x 101 x 200) against Lewis, the
              frozen-variance 1-D PDE and autograd of Lewis (the Greek
              ladder); the ADI-slice American bracket at 50 dates holding its
              PDE value; Bates at λ = 0 equal to Heston and above it with
              jumps; SLV at mixing 0 on a flat smile against the GBM
              certificate; the dividend PDE (401 x 400) against Black–Scholes,
              parity and its Monte Carlo; forward start against vanilla and
              its Monte Carlo; rough Bergomi at η → 0 against Black–Scholes,
              E[v] = ξ0, the GBM closed form and scan, the American against
              the GBM certificate; each call's warm wall and CUDA kernel
              count, none of the eleven Monte Carlo kernels launched; then
              ``/american`` heston|bates|slv|rbergomi and ``/exotic``
              rbergomi over a socket;
17. theta   — the θ-scheme time-loop kernel (``csrc/theta_pde.cu``) against
              the plain loop of ``fdm_price`` on the card at its defaults
              (256 contracts x 201 nodes x 200 steps): European, projection
              and Howard, θ = 0.5 and 1, float32 and float64, bitwise, one
              launch; the gradient of its ``autograd.Function`` against
              autograd through the plain loop; device ms beside the bound,
              the longest chain of solves that ran (run before the pricers,
              after the tridiagonal phase; ``fdm_price`` then prices through
              it, one launch a call and no tridiagonal launch).

18. risk    — the risk engine (``greeks``, ``risk``) on the card: ``/xva``'s
              handler at its defaults (65,536 paths x 24 dates, 8 substeps a
              date on AMC) for bs, heston, bates, slv and rbergomi, and at its
              caps: the closed-form engine at 1,048,576 x 120 on 16 trades
              over two correlated underlyings with a collateral threshold and
              a margin period of risk (and the route on one underlying), the
              Heston AMC engine at 524,288 x 120 x 8 on a vanilla, an Asian
              and a barrier; the long call's EE* flat at Black–Scholes and
              its flat-hazard CVA within 4 stderr, perfect netting, the Euler
              allocations summing to the CVA, the CVA Greeks, wrong-way risk,
              the AMC in + out barriers against the vanilla; ``greeks_fdm``
              on 256 contracts (201 x 100, European against Black–Scholes,
              American against the 2048-step lattice), which launches the
              θ-scheme and tridiagonal kernels; VaR/ES, component ES, option
              VaR, stress and sensitivity on a frame without pandas, the
              portfolio's Greeks against the sum of ``bs_greeks``; each call's
              warm wall ms and CUDA kernel count, none of the eleven Monte
              Carlo kernels launched; then ``/xva`` for every model over a
              socket and two 400s.
19. surface — the chain-to-surface slice with ``pandas`` unimportable: the
              CBOE file whole, filtered, every 7th quote held out, through
              ``calibrate_chain`` from the mids (6 bins, 400 steps, eSSVI)
              against the reference tests' oracles (SSVI rmse, arbitrage,
              held-out vols); an 8,192-quote synthetic chain at the defaults;
              the Dupire surface of that fit (121 x 60): its PDE against
              Black–Scholes at the surface's vol (200 tridiagonal launches a
              price) and the local-vol kernel 8,126,464 x 100 on it (one
              launch a call); ``calibrate_model_to_chain`` heston, bates,
              heston-mc (exactly 202 chain launches) and rbergomi at their
              defaults; ``mc_convergence_study`` and ``validate_pricer``;
              each call's warm wall and CUDA kernels (the Adam loops counted
              from one- and two-step loops); then ``/calibrate`` through its
              handler and over a socket, and a 400; no other Monte Carlo
              kernel launched.

The last three lines are a JSON object of kernel measurements (the eleven
ported Pallas kernels, the tridiagonal kernel and the θ-scheme kernel), the
card's name and power limit, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import pathlib
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from optionslab_tpu_torch import ContractBatch, MCMethod, MonteCarloPricer, PricingServer
from optionslab_tpu_torch.models import exotics as tex
from optionslab_tpu_torch.models import heston as hmodel
from optionslab_tpu_torch.models import heston_exotics as hscan
from optionslab_tpu_torch.models import local_vol as lvm
from optionslab_tpu_torch.models import multi_asset as mam
from optionslab_tpu_torch.models import slv as slvm
from optionslab_tpu_torch.models.bates import BatesParams, bates_price
from optionslab_tpu_torch.models.black_scholes import bs_greeks
from optionslab_tpu_torch.ops import _build, sass_bound
from optionslab_tpu_torch.ops import exotic_kernel as ek
from optionslab_tpu_torch.ops import gbm_kernel as gk
from optionslab_tpu_torch.ops import heston_exotic_kernel as hx
from optionslab_tpu_torch.ops import heston_kernel as hk
from optionslab_tpu_torch.ops import local_vol_kernel as lk
from optionslab_tpu_torch.ops import multi_asset_kernel as mk
from optionslab_tpu_torch.ops import slv_kernel as sk
from optionslab_tpu_torch.ops import theta_pde as tp
from optionslab_tpu_torch.ops import tridiag as tri

BS_ATM_CALL = 10.450583572185565  # S=K=100, T=1, r=0.05, σ=0.2
# absolute Greek bounds of the reference's kernel test (tests/test_gbm_pallas_host.py)
GREEK_BOUNDS = {"delta": 1e-3, "gamma": 1e-4, "vega": 0.05, "rho": 0.1, "dual_delta": 1e-3}
# kernel vs plain on per-row sums: on the card both draw bit-equal paths with
# CUDA's libm, so summation order is the only difference (float32 sums of up
# to ~1e3 terms per thread, then fixed-order partials: ~1e-6 relative at most)
RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def sync_time(fn, iters: int) -> float:
    """Mean wall ms of ``fn(i)`` over ``iters`` calls, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def event_time(fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time(fn, iters: int = 20, reps: int = 5) -> list[float]:
    """Device ms per call of ``fn()``, for each of ``reps`` replays of a CUDA
    graph of ``iters`` calls between two CUDA events: the host issues
    nothing between the events, so a launch shorter than the host's issue
    time (tens of µs a call) is read on the device alone."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def book_batch(n: int, device) -> ContractBatch:
    """n contracts: spots 80–120, strike 100, alternating call/put."""
    spots = torch.linspace(80.0, 120.0, n)
    cp = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0)
    return ContractBatch.make(spots, 100.0, 1.0, 0.05, 0.2, cp, device=device)


def moments_inputs(batch: ContractBatch, n_paths: int, sampler: str, greeks: bool):
    _b, _flat, params, c, reps, rows, _pad = gk._prepare(batch)
    lanes = gk._lanes_for(rows)
    kw = dict(n_blocks=gk._n_blocks(n_paths, lanes, reps), rows=rows, active_rows=c * reps,
              lanes=lanes, sampler=sampler, reps=reps, greeks=greeks)
    return params, kw


def parity_cases(dev) -> list:
    """(name, batch, n_paths, samplers) for the parity phase: two small shapes
    for every sampler, and the shapes the main path launches (phases 4–5)
    with its ``prng`` sampler, where each thread sums many path blocks."""
    single = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "call", device=dev)
    n = 64
    book = ContractBatch.make(torch.linspace(80.0, 120.0, n), 100.0,
                              torch.linspace(0.25, 2.0, n), 0.03, torch.linspace(0.15, 0.35, n),
                              torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0), 0.01,
                              device=dev)
    every = ("hash", "sobol", "prng")
    return [("1x1M", single, 1_000_000, every), ("64x64k", book, 65_536, every),
            ("1x1e9", single, 1_000_000_000, ("prng",)),
            ("1024x1e6", book_batch(1024, dev), 1_000_000, ("prng",)),
            ("1x1e8", single, 100_000_000, ("prng",))]  # a /mc request


def phase_parity(dev) -> float:
    """Kernel vs plain per-row sums; returns the largest absolute difference."""
    worst_abs = 0.0
    for name, batch, n_paths, samplers in parity_cases(dev):
        for sampler in samplers:
            for greeks in (True, False):
                params, kw = moments_inputs(batch, n_paths, sampler, greeks)
                kern = gk._gbm_moments_cuda(7, 0, params, **kw)
                plain = gk._gbm_moments_plain(7, 0, params, **kw)
                torch.cuda.synchronize()
                k64, p64 = kern.double(), plain.double()
                diff = (k64 - p64).abs()
                rel = diff[:3] / p64[:3].abs().clamp_min(1e-30)
                bad = (diff[:3] > RTOL * p64[:3].abs()).sum().item()
                if greeks:  # the signed Σ1{ex}·S_T·z, against the scale Σ1{ex}·S_T
                    bad += (diff[3] > RTOL * p64[2].abs()).sum().item()
                exact_rows = (kern == plain).all(dim=0).sum().item()
                worst_abs = max(worst_abs, diff.max().item())
                n_chunks, per_chunk = gk._chunking(kw["n_blocks"], kw["active_rows"])
                log("parity", f"{sampler:5s} greeks={greeks!s:5s} {name:8s} "
                              f"rows={kw['rows']} lanes={kw['lanes']} blocks={kw['n_blocks']} "
                              f"chunks={n_chunks}x{per_chunk} max_rel={rel.max().item():.3e} "
                              f"max_abs={diff.max().item():.3e} bitwise_rows={exact_rows} "
                              f"violations={bad}")
                if bad or not torch.isfinite(kern).all():
                    raise AssertionError(f"kernel disagrees with plain: {sampler} {greeks} {name}")
    return worst_abs


def check_single(out: dict, tag: str) -> None:
    price, se = out["price"].item(), out["std_error"].item()
    if not (math.isfinite(price) and abs(price - BS_ATM_CALL) < 4 * se):
        raise AssertionError(f"{tag}: price {price} vs BS {BS_ATM_CALL} (4·se = {4 * se})")
    ex = bs_greeks(100.0, 100.0, 1.0, 0.05, 0.2, 1.0, 0.0)
    for k, bound in GREEK_BOUNDS.items():
        err = abs(out[k].item() - ex[k].item())
        if not err < bound:
            raise AssertionError(f"{tag}: {k} {out[k].item()} vs BS {ex[k].item()}")
    log("main", f"{tag}: price={price:.7f} se={se:.3e} z={(price - BS_ATM_CALL) / se:+.2f} "
                + " ".join(f"{k}={out[k].item():.6f}" for k in GREEK_BOUNDS))


def phase_main(dev, card: str) -> dict:
    calls = 0
    n_big = 1_000_000_000
    single = MonteCarloPricer(n_paths=n_big, method=MCMethod.KERNEL, seed=0, device=dev)
    out = single.greeks(100.0, 100.0, 1.0, 0.05, 0.2, "call")
    calls += 1
    check_single(out, "1 contract x 1e9 paths, Greeks")
    actual = gk.gbm_paths_per_launch(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2), n_big)

    n_book = 1024
    spots = torch.linspace(80.0, 120.0, n_book)
    cp = torch.where(torch.arange(n_book) % 2 == 0, 1.0, -1.0)
    book = MonteCarloPricer(n_paths=1_000_000, method=MCMethod.KERNEL, seed=0, device=dev)
    bout = book.greeks(spots, 100.0, 1.0, 0.05, 0.2, cp)
    calls += 1
    ex = bs_greeks(spots.to(dev), 100.0, 1.0, 0.05, 0.2, cp.to(dev))
    z = ((bout["price"] - ex["price"]) / bout["std_error"]).double()
    if not (torch.isfinite(z).all() and z.abs().max().item() < 4.0):
        raise AssertionError(f"book: max |price - BS| / se = {z.abs().max().item()}")
    for k in ("delta", "gamma", "vega", "rho", "theta", "dual_delta", "dividend_rho"):
        if bout[k].shape != (n_book,) or not torch.isfinite(bout[k]).all():
            raise AssertionError(f"book: {k} not finite of shape ({n_book},)")
    log("main", f"book 1024 x 1e6 paths: max|z|={z.abs().max().item():.3f} "
                f"mean z={z.mean().item():+.4f} rms z={z.pow(2).mean().sqrt().item():.4f}")

    batch = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, device=dev)
    price, se = gk.gbm_mc_price_only(batch, n_paths=n_big, seed=0)
    calls += 1
    if not abs(price.item() - BS_ATM_CALL) < 4 * se.item():
        raise AssertionError(f"price-only: {price.item()} vs BS (4·se = {4 * se.item()})")
    if abs(price.item() - out["price"].item()) > 1e-5 * BS_ATM_CALL:
        raise AssertionError("price-only and Greek-path prices differ beyond f32 order")
    log("main", f"price-only 1e9: price={price.item():.7f} se={se.item():.3e}")

    iters = 5
    seeds = MonteCarloPricer(n_paths=n_big, method=MCMethod.KERNEL, device=dev)

    def greeks_run(i):
        seeds.seed = 100 + i
        seeds.greeks(100.0, 100.0, 1.0, 0.05, 0.2, "call")

    def book_run(i):
        book.seed = 200 + i
        book.greeks(spots, 100.0, 1.0, 0.05, 0.2, cp)

    greeks_ms = sync_time(greeks_run, iters)
    price_only_ms = sync_time(lambda i: gk.gbm_mc_price_only(batch, n_big, 300 + i), iters)
    book_ms = sync_time(book_run, iters)
    calls += 3 * iters
    timings = {"greeks_1e9_ms": greeks_ms, "price_only_1e9_ms": price_only_ms,
               "book_1024x1e6_ms": book_ms, "paths_per_launch": actual,
               "greeks_paths_per_s": actual / (greeks_ms / 1e3),
               "price_only_paths_per_s": actual / (price_only_ms / 1e3)}
    log("main", f"warm wall, mean of {iters} [{card}]: 1e9 Greeks {greeks_ms:.3f} ms "
                f"({timings['greeks_paths_per_s']:.4e} paths/s); 1e9 price-only "
                f"{price_only_ms:.3f} ms ({timings['price_only_paths_per_s']:.4e} paths/s); "
                f"book 1024x1e6 {book_ms:.3f} ms")
    return {"calls": calls, **timings}


def _request(url: str, body: dict | None = None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def phase_server(dev) -> int:
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        status, health = _request(base + "/health")
        if status != 200 or health["device_name"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"/health: {status} {health}")
        status, price = _request(base + "/price", {"model": "bs"})
        if status != 200 or abs(price["price"] - BS_ATM_CALL) > 1e-3:
            raise AssertionError(f"/price: {status} {price}")
        status, greeks = _request(base + "/greeks", {})
        ex = bs_greeks(100.0, 100.0, 1.0, 0.05, 0.2)
        if status != 200 or any(abs(greeks[k] - ex[k].item()) > 1e-4 for k in GREEK_BOUNDS):
            raise AssertionError(f"/greeks: {status} {greeks}")
        requests = [
            {"seed": 1, "n_paths": 100_000_000},
            {"seed": 2, "n_paths": 100_000_000, "spot": 95.0, "maturity": 0.5, "vol": 0.25,
             "option_type": "put"},
            {"seed": 3, "n_paths": 100_000_000, "spot": 110.0, "maturity": 2.0, "rate": 0.03,
             "vol": 0.3, "dividend": 0.01},
        ]
        for body in requests:
            status, mc = _request(base + "/mc", body)
            p = {"spot": 100.0, "strike": 100.0, "maturity": 1.0, "rate": 0.05, "vol": 0.2,
                 "dividend": 0.0, "option_type": "call", **body}
            cp = 1.0 if p["option_type"] == "call" else -1.0
            ex = bs_greeks(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"], cp,
                           p["dividend"])
            ok = (status == 200 and abs(mc["price"] - ex["price"].item()) < 4 * mc["std_error"]
                  and abs(mc["delta"] - ex["delta"].item()) < GREEK_BOUNDS["delta"]
                  and all(math.isfinite(v) for v in mc.values()))
            if not ok:
                raise AssertionError(f"/mc {body}: {status} {mc}")
            log("server", f"/mc seed={body['seed']}: price={mc['price']:.6f} "
                          f"BS={ex['price'].item():.6f} se={mc['std_error']:.3e} "
                          f"delta={mc['delta']:.5f}")
        log("server", f"/health {health}; /price and /greeks match BS")
    finally:
        server.stop()
    return len(requests)


def phase_timing(dev) -> dict:
    """Device ms of the GBM kernel at its path's two shapes, and of its plain
    version at the book shape (1024 contracts x 1e6 paths; prng, Greeks).
    Not counted as main path."""
    out = {}
    for tag, batch, n_paths in (("1x1e9", ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2,
                                                             device=dev), 1_000_000_000),
                                ("1024x1e6", book_batch(1024, dev), 1_000_000)):
        params, kw = moments_inputs(batch, n_paths, "prng", True)
        gk._gbm_moments_cuda(0, 0, params, **kw)
        ms = event_time(lambda: gk._gbm_moments_cuda(0, 0, params, **kw), 10)
        # terminal: a trip of the lane loop is a whole lane
        out[tag] = {"ms": ms, "trips": kw["n_blocks"] * kw["active_rows"] * kw["lanes"],
                    "bytes": 4 * (7 + 4) * kw["rows"], "steps": 1}
    gk._gbm_moments_plain(0, 0, params, **kw)
    out["1024x1e6"]["plain_ms"] = event_time(lambda: gk._gbm_moments_plain(0, 0, params, **kw), 2)
    return out


# ---------------------------------------------------------------------------
# the exotic path (csrc/exotic_mc.cu, csrc/exotic_greeks.cu)
# ---------------------------------------------------------------------------
S0, STRIKE, T, RATE, VOL = 100.0, 100.0, 1.0, 0.05, 0.2
ASIAN = (4_000_000, 252)  # the JAX package's bench.py sizes: paths, steps
GREEKS = (8_000_000, 252)
BARRIER_LR = (16_000_000, 64)
BOOK = (1_000_000, 64)  # per contract
BOOK_STRIKES = [80.0, 85.0, 90.0, 95.0, 100.0, 105.0, 110.0, 115.0]


def exotic_inputs(kind: str, n_steps: int, dev, strike: float = STRIKE, barrier=None):
    """(params, one-contract book) of a launch, with every kind's slots set."""
    if barrier is None:
        barrier = 115.0 if "up" in kind else 88.0
    p, _ = ek._base_params(S0, strike, T, RATE, VOL, 0.01, barrier, n_steps)
    if "double" in kind:
        p[ek._P_A], p[ek._P_B] = 88.0, 115.0
    if kind == "cliquet":
        p[ek._P_A:] = [-0.03, 0.03, 0.0, 1e9, 100.0]
    if kind == "autocall":
        p[ek._P_A:] = [100.0, 80.0, 70.0, 2.0, 100.0]
    if kind == "range_accrual":
        p[ek._P_A], p[ek._P_B], p[ek._P_E] = 90.0, 110.0, 100.0
    params = torch.tensor(p, dtype=torch.float32, device=dev)
    return params, params[list(ek._BOOK_SLOTS)].reshape(1, 7).contiguous()


def compare_sums(kern: torch.Tensor, plain: torch.Tensor, tag: str, n_plain: int = 2,
                 rtol: float = RTOL) -> float:
    """Per-row sums within ``rtol``; the signed moments (index ``n_plain`` on:
    LR scores, pathwise P0/G1/G2, Heston sensitivities) against their largest
    row, since they cancel inside a row. Returns the largest absolute
    difference."""
    k64, p64 = kern.double(), plain.double()
    diff = (k64 - p64).abs()
    scale = p64.abs()
    scale[n_plain:] = torch.maximum(scale[n_plain:], scale[n_plain:].amax(dim=1, keepdim=True))
    bad = (diff > rtol * scale).sum().item()
    rel = (diff / scale.clamp_min(1e-30)).max().item()
    exact = (kern == plain).all(dim=0).sum().item()
    log("parity", f"{tag}: max_rel={rel:.3e} max_abs={diff.max().item():.3e} "
                  f"bitwise_rows={exact} violations={bad}")
    if bad or not torch.isfinite(kern).all():
        raise AssertionError(f"kernel disagrees with plain: {tag}")
    return diff.max().item()


def exotic_parity_cases(dev):
    """(tag, kwargs of _exotic_moments_*) of the price kernel's parity phase."""
    cases = []
    for kind in ek.PAYOFF_KINDS:
        period = 3 if kind in ("cliquet", "autocall") else 1
        for sampler in ("hash", "prng"):
            for lr in (False, True):
                if lr and kind == "asian_arith_cv":
                    continue
                params, book = exotic_inputs(kind, 12, dev)
                cases.append((f"{kind} {sampler} lr={lr} 2x12",
                              dict(params=params, book=book, kind=kind, n_steps=12, n_blocks=2,
                                   cp=1.0, period=period, sampler=sampler, lr=lr)))
    for kind in ("asian_geo", "asian_arith_cv", "barrier_up-and-out"):
        params, book = exotic_inputs(kind, 16, dev)
        cases.append((f"{kind} sobol_bb_hash 2x16",
                      dict(params=params, book=book, kind=kind, n_steps=16, n_blocks=2, cp=1.0,
                           sampler="sobol_bb_hash")))
    for nc, kind, lr in ((2, "barrier_up-and-out", True), (8, "asian_arith", True),
                         (128, "one_touch_up_hit", False)):
        strikes = torch.linspace(90.0, 110.0, nc).tolist()
        barriers = torch.linspace(110.0, 130.0, nc).tolist()
        params, _ = exotic_inputs(kind, 12, dev)
        book = torch.tensor(ek._book_table(strikes, barriers, [0.0] * nc, [0.0] * nc, nc),
                            dtype=torch.float32, device=dev)
        cases.append((f"book nc={nc} {kind} prng lr={lr} 3x12",
                      dict(params=params, book=book, kind=kind, n_steps=12, n_blocks=3, cp=1.0,
                           sampler="prng", lr=lr)))
    # the exotic path's own shapes (many path blocks per thread), prng
    for kind, (n_paths, n_steps), lr in (("asian_arith", ASIAN, False),
                                         ("barrier_up-and-out", BARRIER_LR, True)):
        params, book = exotic_inputs(kind, n_steps, dev, barrier=1e6 if lr else None)
        cases.append((f"{kind} prng lr={lr} {n_paths}x{n_steps}",
                      dict(params=params, book=book, kind=kind, n_steps=n_steps,
                           n_blocks=ek._n_blocks(n_paths, ek.PATHS_PER_BLOCK), cp=1.0,
                           sampler="prng", lr=lr)))
    params, _ = exotic_inputs("asian_arith", BOOK[1], dev)
    nc = len(BOOK_STRIKES)
    book = torch.tensor(ek._book_table(BOOK_STRIKES, [0.0] * nc, [0.0] * nc, [0.0] * nc, nc),
                        dtype=torch.float32, device=dev)
    cases.append((f"book nc={nc} asian_arith prng {BOOK[0]}x{BOOK[1]}",
                  dict(params=params, book=book, kind="asian_arith", n_steps=BOOK[1],
                       n_blocks=ek._n_blocks(BOOK[0], (ek.ROWS // nc) * ek.LANES * 4), cp=1.0,
                       sampler="prng")))
    return cases


def phase_exotic_parity(dev) -> tuple[float, float]:
    """Both exotic kernels against their plain versions; returns the largest
    absolute difference of each."""
    worst_mc = 0.0
    for tag, kw in exotic_parity_cases(dev):
        params, book = kw.pop("params"), kw.pop("book")
        kern = ek._exotic_moments_cuda(7, 1, params, book, **kw)
        plain = ek._exotic_moments_plain(7, 1, params, book, **kw)
        torch.cuda.synchronize()
        worst_mc = max(worst_mc, compare_sums(kern, plain, f"exotic_mc {tag}"))
    worst_g = 0.0
    cases = [(kind, cp, sampler, 2, 12) for kind in ek.GREEK_KINDS for cp in (1.0, -1.0)
             for sampler in ("hash", "prng")]
    cases.append(("asian_geo", 1.0, "prng", ek._n_blocks(GREEKS[0], ek.PATHS_PER_BLOCK_G),
                  GREEKS[1]))
    for kind, cp, sampler, n_blocks, n_steps in cases:
        params, _ = exotic_inputs(kind, n_steps, dev, strike=105.0)
        kw = dict(kind=kind, n_steps=n_steps, n_blocks=n_blocks, cp=cp, sampler=sampler)
        kern = ek._exotic_greeks_cuda(7, 1, params, **kw)
        plain = ek._exotic_greeks_plain(7, 1, params, **kw)
        torch.cuda.synchronize()
        worst_g = max(worst_g, compare_sums(
            kern, plain, f"exotic_greeks {kind} cp={cp:+.0f} {sampler} {n_blocks}x{n_steps}"))
    return worst_mc, worst_g


def timed(fn, iters: int = 3):
    """(result of a first call, mean warm wall ms of ``iters`` more calls)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / iters * 1e3


def phase_exotic_main(dev, card: str) -> dict:
    """The exotic path through its entry points, against oracles. Returns
    the number of calls routed to each kernel."""
    calls = {"mc": 0, "greeks": 0}
    rows = []

    def record(tag, n_paths, n_steps, ms):
        rows.append(f"{tag} {ms:.3f} ms ({n_paths * n_steps / (ms / 1e3):.4e} path-steps/s)")

    # geometric Asian against its exact discrete closed form
    n, m = ASIAN
    (p, se, paths), ms = timed(lambda: ek.exotic_price("asian_geo", S0, STRIKE, T, RATE, VOL,
                                                       n_paths=n, n_steps=m, device=dev))
    calls["mc"] += 4
    cf = tex.geometric_asian_closed_form(S0, STRIKE, T, RATE, VOL, n_steps=m).item()
    if not abs(p.item() - cf) < 4 * se.item():
        raise AssertionError(f"asian_geo {p.item()} vs closed form {cf} (4·se {4 * se.item()})")
    log("exotic", f"asian_geo {paths}x{m}: price={p.item():.6f} cf={cf:.6f} se={se.item():.3e}")
    record(f"asian_geo {n}x{m}", paths, m, ms)

    # arithmetic Asian, plain and with the geometric control variate
    (pl, se_pl, _), ms = timed(lambda: ek.exotic_price("asian_arith", S0, STRIKE, T, RATE, VOL,
                                                       n_paths=n, n_steps=m, seed=1,
                                                       device=dev))
    record(f"asian_arith {n}x{m}", paths, m, ms)
    (cv, se_cv, _), ms = timed(lambda: ek.exotic_price("asian_arith", S0, STRIKE, T, RATE, VOL,
                                                       n_paths=n, n_steps=m, seed=2,
                                                       control_variate=True, device=dev))
    record(f"asian_arith CV {n}x{m}", paths, m, ms)
    calls["mc"] += 8
    if not (abs(cv.item() - pl.item()) < 4 * math.hypot(se_cv.item(), se_pl.item())
            and se_cv.item() < se_pl.item() / 8):
        raise AssertionError(f"CV {cv.item()}±{se_cv.item()} vs plain {pl.item()}±{se_pl.item()}")
    log("exotic", f"asian_arith: plain={pl.item():.6f}±{se_pl.item():.2e} "
                  f"CV={cv.item():.6f}±{se_cv.item():.2e} (se ratio {se_pl.item() / se_cv.item():.1f})")

    # pathwise Greeks of the geometric Asian against autograd of the closed form
    n, m = GREEKS
    g, ms = timed(lambda: ek.exotic_greeks("asian_geo", S0, STRIKE, T, RATE, VOL, n_paths=n,
                                           n_steps=m, device=dev))
    calls["greeks"] += 4
    record(f"greeks asian_geo {n}x{m}", g["paths"], m, ms)
    args = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in (S0, VOL, RATE, T)]
    price = tex.geometric_asian_closed_form(args[0], STRIKE, args[3], args[2], args[1], 1.0, 0.0,
                                            m)
    ad = dict(zip(("delta", "vega", "rho", "theta"), torch.autograd.grad(price, args)))
    ad["theta"] = -ad["theta"]
    bounds = {"delta": 0.01, "vega": 0.6, "rho": 0.6, "theta": 0.3}  # tests/test_exotic_pallas.py
    if not abs(g["price"].item() - price.item()) < 5 * g["std_error"].item() + 1e-3 or any(
            not abs(g[k].item() - ad[k].item()) < b for k, b in bounds.items()):
        raise AssertionError(f"asian_geo Greeks {g} vs closed-form AD {ad}")
    log("exotic", "asian_geo pathwise vs AD of closed form: " + " ".join(
        f"{k}={g[k].item():.5f}/{ad[k].item():.5f}" for k in bounds))

    # LR ladder of an unreachable up-and-out (a vanilla) against Black–Scholes
    n, m = BARRIER_LR
    lr, ms = timed(lambda: ek.exotic_lr_greeks("barrier_up-and-out", S0, STRIKE, T, RATE, VOL,
                                               barrier=1e6, n_paths=n, n_steps=m, device=dev))
    calls["mc"] += 4
    record(f"barrier LR {n}x{m}", lr["paths"], m, ms)
    bs = bs_greeks(S0, STRIKE, T, RATE, VOL, 1.0, 0.0)
    bounds = {"price": 0.08, "delta": 0.02, "gamma": 0.01, "vega": 2.0, "rho": 2.0, "theta": 1.0}
    if any(not abs(lr[k].item() - bs[k].item()) < b for k, b in bounds.items()):
        raise AssertionError(f"far-barrier LR ladder {lr} vs BS {bs}")
    log("exotic", "far up-and-out LR vs BS: " + " ".join(
        f"{k}={lr[k].item():.5f}/{bs[k].item():.5f}" for k in bounds))

    # range accrual against its exact closed form
    n, m = ASIAN
    (ra, se_ra, paths), ms = timed(lambda: ek.range_accrual_price(S0, 90.0, 110.0, T, RATE, VOL,
                                                                  n_paths=n, n_steps=m,
                                                                  device=dev))
    calls["mc"] += 4
    record(f"range_accrual {n}x{m}", paths, m, ms)
    cf = tex.range_accrual_closed_form(S0, 90.0, 110.0, T, RATE, VOL, n_steps=m).item()
    if not abs(ra.item() - cf) < 4 * se_ra.item():
        raise AssertionError(f"range accrual {ra.item()} vs closed form {cf}")
    log("exotic", f"range_accrual: price={ra.item():.6f} cf={cf:.6f} se={se_ra.item():.2e}")

    # autocall and cliquet against the scan engine
    gen = torch.Generator(device=dev)
    for name, kernel_fn, scan_fn in (
            ("autocall", lambda: ek.autocall_price(S0, T, RATE, VOL, n_paths=1_000_000,
                                                   n_steps=252, device=dev),
             lambda: tex.autocallable_price(S0, T, RATE, VOL, gen.manual_seed(3),
                                            n_paths=200_000, n_steps=252, return_stderr=True)),
            ("cliquet", lambda: ek.cliquet_price(S0, T, RATE, VOL, n_paths=1_000_000,
                                                 n_steps=252, device=dev),
             lambda: tex.cliquet_price(S0, T, RATE, VOL, gen.manual_seed(4), n_paths=200_000,
                                       n_steps=252, return_stderr=True))):
        (kp, kse, paths), ms = timed(kernel_fn)
        calls["mc"] += 4
        record(f"{name} 1000000x252", paths, 252, ms)
        sp, sse = scan_fn()
        z = (kp.item() - sp.item()) / math.hypot(kse.item(), sse.item())
        if not (math.isfinite(kp.item()) and abs(z) < 5):
            raise AssertionError(f"{name}: kernel {kp.item()} vs scan {sp.item()} (z={z:.2f})")
        log("exotic", f"{name}: kernel={kp.item():.5f}±{kse.item():.2e} "
                      f"scan={sp.item():.5f}±{sse.item():.2e} z={z:+.2f}")

    # an 8-strike Asian book against its single-contract siblings
    n, m = BOOK
    (bp, bse, bn), ms = timed(lambda: ek.exotic_book_price("asian_arith", S0, BOOK_STRIKES, T,
                                                           RATE, VOL, n_paths=n, n_steps=m,
                                                           device=dev))
    calls["mc"] += 4
    record(f"book 8x{n}x{m}", bn * len(BOOK_STRIKES), m, ms)
    zs = []
    for j, k in enumerate(BOOK_STRIKES):
        sp, sse, _ = ek.exotic_price("asian_arith", S0, k, T, RATE, VOL, n_paths=n, n_steps=m,
                                     seed=100 + j, device=dev)
        calls["mc"] += 1
        zs.append((bp[j].item() - sp.item()) / math.hypot(bse[j].item(), sse.item()))
    if not all(abs(z) < 5 for z in zs):
        raise AssertionError(f"book vs single contracts: z = {zs}")
    log("exotic", f"book of 8 vs singles: max|z|={max(abs(z) for z in zs):.2f}")
    log("exotic", f"warm wall, mean of 3 [{card}]: " + "; ".join(rows))
    return calls


def phase_exotic_server(dev) -> dict:
    """``/exotic`` and ``/book/exotic`` on the card over a socket."""
    calls = {"mc": 0, "greeks": 0}
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}/exotic"
    big = {"n_paths": 4_000_000, "n_steps": 64}
    try:
        for body, route in (({"kind": "asian", "greeks": True, **big}, "greeks"),
                            ({"kind": "barrier", "greeks": True, "barrier": 130.0, **big}, "mc"),
                            ({"kind": "autocallable", "greeks": True, **big}, "mc")):
            status, out = _request(base, body)
            calls[route] += 1
            if status != 200 or not all(math.isfinite(out[k]) for k in
                                        ("price", "std_error", "delta", "vega", "rho")):
                raise AssertionError(f"/exotic {body}: {status} {out}")
            log("exotic server", f"/exotic {body['kind']} greeks: price={out['price']:.5f} "
                                 f"delta={out['delta']:.5f} vega={out['vega']:.4f} "
                                 f"({out['greek_method']})")
        status, out = _request(base, {"kind": "double-barrier", "lower": 80.0, "upper": 125.0,
                                      **big})
        calls["mc"] += 1
        cf = out.get("closed_form_continuous")
        if status != 200 or cf is None or not out["price"] >= cf - 4 * out["std_error"]:
            raise AssertionError(f"/exotic double-barrier: {status} {out}")
        log("exotic server", f"/exotic double-barrier: discrete={out['price']:.5f} "
                             f"continuous cf={cf:.5f} (discrete monitoring knocks out less)")
        status, out = _request(base, {"kind": "one-touch", "pay": "hit", "barrier": 115.0, **big})
        calls["mc"] += 1
        hit_cf = tex.one_touch_closed_form(S0, 115.0, T, RATE, VOL, pay="hit").item()
        if status != 200 or not 0.0 < out["price"] <= hit_cf + 4 * out["std_error"]:
            raise AssertionError(f"/exotic one-touch at hit: {status} {out}")
        log("exotic server", f"/exotic one-touch pay-at-hit: {out['price']:.5f} "
                             f"(continuous cf {hit_cf:.5f})")
        status, out = _request(base.replace("/exotic", "/book/exotic"),
                               {"kind": "barrier", "strikes": [95.0, 100.0, 105.0],
                                "barriers": [120.0, 125.0, 130.0], "greeks": True,
                                "n_paths": 1_000_000})
        calls["mc"] += 1
        if status != 200 or len(out["delta"]) != 3 or not all(
                math.isfinite(x) for x in out["price"] + out["delta"]):
            raise AssertionError(f"/book/exotic: {status} {out}")
        log("exotic server", f"/book/exotic barrier x3 greeks: prices={out['price']} "
                             f"deltas={out['delta']}")
    finally:
        server.stop()
    return calls


def event_pair(kernel_fn, plain_fn, iters: int = 5) -> tuple[float, float]:
    """Device ms of the kernel (mean of ``iters`` after a warm-up) and of its
    plain version (one warm call)."""
    kernel_fn()
    ms = event_time(kernel_fn, iters)
    plain_fn()
    plain_ms = event_time(plain_fn, 1)
    return ms, plain_ms


def load_sass() -> dict:
    return sass_bound.parse_functions(
        sass_bound.dump_sass(_build.library_path(), _build.cuda_tool("cuobjdump")))


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    return float(out.stdout.strip()) * 1e6


def nest(*levels, **kw) -> dict:
    """The keyword arguments of :func:`sass_bound.nest_counts` for a
    kernel's lane-step: its loop ``levels`` ((roots per trip, trips per
    lane-step), innermost first), and ``tail`` or ``bookkeeping``."""
    return {"levels": levels, **kw}


def kernel_bound(funcs: dict, name_parts: tuple, spec: dict, t: dict, tag: str):
    """(bound ms, bound_by) of a launch: the larger of its bytes over the HBM
    rate and the busiest pipe of its ``t["trips"]`` lane-steps, each counted
    from the SASS by :func:`sass_bound.nest_counts` with ``spec``
    (:func:`nest`) over the lane's ``t["steps"]``. Where ``t["pin"]``
    gives (issued in the step, issued on the epilogue per lane) of an
    earlier build of the same function, the issue count is the smaller of
    the two: what a build issues above it is its own code, not the
    function's."""
    fn = sass_bound.find_function(funcs, *name_parts)
    counts = sass_bound.nest_counts(fn, n_steps=t["steps"], **spec)
    if t.get("pin"):
        step, tail = t["pin"]
        pinned = step + tail / t["steps"]
        took = min(pinned, counts["issue"])
        log("bound", f"{tag}: this build issues {counts['issue']:.2f} per trip, the pinned count "
                     f"of the function {pinned:.2f}; the bound takes {took:.2f}")
        counts = {**counts, "issue": took}
    trips, n_bytes = t["trips"], t["bytes"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    ops_ms, pipe = sass_bound.bound_ms(counts, trips, n_sm, clock)
    per_pipe = sass_bound.pipe_ms(counts, trips, n_sm, clock)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log("bound", f"{tag}: per trip fp32={counts['fp32']:.1f} int={counts['int']:.1f} "
                 f"mufu={counts['mufu']:.1f} issued={counts['issue']:.1f} (unroll "
                 f"{counts['unroll']}" + (f", epilogue {counts['tail_issue']} per pass"
                                          if "tail_issue" in counts else "")
        + f"); {trips:.4e} trips on {n_sm} SMs at {clock / 1e6:.0f} "
                 f"MHz -> ms by pipe " + " ".join(f"{p}={v:.4f}" for p, v in per_pipe.items())
        + f"; bound {ops_ms:.4f} ms ({pipe}); bytes {bytes_ms:.2e} ms")
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def exotic_timing(dev) -> dict:
    """Device ms of both exotic kernels and their plain versions at the
    exotic path's shapes (prng). Not counted as main path."""
    out = {}
    for tag, kind, (n_paths, n_steps), lr in (("asian_arith 4Mx252", "asian_arith", ASIAN, False),
                                              ("barrier LR 16Mx64", "barrier_up-and-out",
                                               BARRIER_LR, True)):
        params, book = exotic_inputs(kind, n_steps, dev, barrier=1e6 if lr else None)
        kw = dict(kind=kind, n_steps=n_steps, n_blocks=ek._n_blocks(n_paths, ek.PATHS_PER_BLOCK),
                  cp=1.0, sampler="prng", lr=lr)
        ms, plain_ms = event_pair(lambda: ek._exotic_moments_cuda(0, 0, params, book, **kw),
                                  lambda: ek._exotic_moments_plain(0, 0, params, book, **kw))
        out[tag] = {"ms": ms, "plain_ms": plain_ms,
                    "trips": kw["n_blocks"] * ek.ROWS * ek.LANES * n_steps,
                    "bytes": 4 * (ek.N_PARAMS + 7 + ek._n_moments(kind, lr) * ek.ROWS),
                    "steps": n_steps}
    params, _ = exotic_inputs("asian_geo", GREEKS[1], dev)
    kw = dict(kind="asian_geo", n_steps=GREEKS[1], cp=1.0, sampler="prng",
              n_blocks=ek._n_blocks(GREEKS[0], ek.PATHS_PER_BLOCK_G))
    ms, plain_ms = event_pair(lambda: ek._exotic_greeks_cuda(0, 0, params, **kw),
                              lambda: ek._exotic_greeks_plain(0, 0, params, **kw))
    out["greeks asian_geo 8Mx252"] = {"ms": ms, "plain_ms": plain_ms,
                                      "trips": kw["n_blocks"] * ek.ROWS * ek.LANES_G * GREEKS[1],
                                      "bytes": 4 * (ek.N_PARAMS + 5 * ek.ROWS),
                                      "steps": GREEKS[1]}
    return out


# ---------------------------------------------------------------------------
# the Heston European path (csrc/heston_mc.cu, heston_qe.cu, heston_chain.cu)
# ---------------------------------------------------------------------------
H_PARAMS = (0.04, 2.0, 0.04, 0.3, -0.7)  # HestonParams.make() of the JAX bench.py
H_EULER = (8_388_608, 252)  # bench.py:138 (price) and :154 (vega ladder)
H_QE = (8_388_608, 32)
# the QE ladder kernel draws in chunks of K = 7 steps: 1, K − 1, K + 1 and
# the path's 32 steps. Its work unit is 32 lanes of a path block's row: on 1
# and 70 path blocks each CUDA block carries one unit, on 257 (2056 units a
# row: 686 chunks of 3, the last of 1) several, through its double buffer
H_QE_EDGE_STEPS = (1, 6, 8, 32)
H_QE_EDGE_BLOCKS = (1, 70, 257)
QE_LADDER_RTOL = 1e-6  # per row: the paths are bitwise, the sums' order differs
H_QMC = (4_194_304, 64)
H_CHAIN_PATHS, H_CHAIN_DT = 1_048_576, 0.02
H_CHAIN_T = (0.25, 0.5, 1.0, 1.5, 2.0)
H_CHAIN_K = (80.0, 85.0, 90.0, 95.0, 100.0, 105.0, 110.0, 115.0)
H_CALIB_GEN = (0.04, 2.0, 0.05, 0.3, -0.7)  # tests/test_heston_pallas.py:311
H_CALIB_INIT = (0.05, 1.5, 0.04, 0.4, -0.5)
H_CALIB_STEPS = 200
# the calibration's grid: at the chain's dt = 0.02 the Euler bias of the short
# expiries moves the fitted kappa outside the reference test's bound; the
# kernel-priced loss at dt = 0.01 recovers it (PERF.md)
H_CALIB_DT = 0.01
H_NAMES = ("v0", "kappa", "theta", "sigma", "rho")


def check(ok: bool, msg: str) -> None:
    """Fail the run with ``msg`` unless ``ok``."""
    if not ok:
        raise AssertionError(msg)


def heston_chain_quotes():
    """The 5-expiry × 8-strike chain: calls above the forward, puts below."""
    strikes, mats, cps = [], [], []
    for t in H_CHAIN_T:
        fwd = S0 * math.exp(RATE * t)
        for k in H_CHAIN_K:
            strikes.append(k)
            mats.append(t)
            cps.append(1.0 if k >= fwd else -1.0)
    return strikes, mats, cps


def heston_parity_cases(dev):
    """(tag, kernel fn, plain fn, args, kwargs) of the Heston parity phase:
    every mode and sampler at small shapes, then each kernel at its path's
    shapes (prng)."""
    par = hmodel.HestonParams.make(*H_PARAMS)
    cases = []

    def euler(n_steps, strike=105.0):
        return torch.tensor(hk._params_vec(S0, strike, T, RATE, par, 0.01, n_steps)[1], device=dev)

    def qe(n_steps, ladder):
        if ladder:
            return torch.tensor(hk._params_vec_qe_ladder(S0, STRIKE, T, RATE, par, 0.01,
                                                         n_steps)[1], device=dev)
        return torch.tensor(hk._params_vec_qe(S0, STRIKE, T, RATE, par, 0.01, n_steps)[1],
                            device=dev)

    for mode in hk.MODES:
        for sampler in ("hash", "prng") + (("sobol_bb",) if mode == "price" else ()):
            for cp in (1.0, -1.0):
                cases.append((f"heston_mc {mode} {sampler} cp={cp:+.0f} 3x12", hk._heston_mc_cuda,
                              hk._heston_mc_plain, (euler(12, 105.0 if cp > 0 else 95.0),),
                              dict(n_steps=12, n_blocks=3, cp=cp, sampler=sampler, mode=mode)))
    for sampler in ("hash", "prng"):
        for cp in (1.0, -1.0):
            kw = dict(n_steps=12, n_blocks=3, cp=cp, sampler=sampler)
            cases.append((f"heston_qe {sampler} cp={cp:+.0f} 3x12", hk._heston_qe_cuda,
                          hk._heston_qe_plain, (qe(12, False),), kw))
            cases.append((f"heston_qe_ladder {sampler} cp={cp:+.0f} 3x12",
                          hk._heston_qe_ladder_cuda, hk._heston_qe_ladder_plain,
                          (qe(12, True),), kw))
        plan = hk.chain_plan([90.0, 100.0, 110.0, 95.0, 105.0], [0.5, 0.5, 0.5, 1.0, 1.0],
                             [-1.0, 1.0, 1.0, -1.0, 1.0], 0.1, dev)
        cases.append((f"heston_chain {sampler} 5 quotes 3x15", hk._heston_chain_cuda,
                      hk._heston_chain_plain, (chain_head(dev), plan),
                      dict(n_blocks=3, sampler=sampler)))
    # the path's own shapes
    for mode in hk.MODES:
        n, m = H_EULER
        nb = hk._n_blocks(n, hk.LADDER_PATHS_PER_BLOCK if mode == "ladder" else hk.PATHS_PER_BLOCK)
        cases.append((f"heston_mc {mode} prng {n}x{m}", hk._heston_mc_cuda, hk._heston_mc_plain,
                      (euler(m, STRIKE),), dict(n_steps=m, n_blocks=nb, cp=1.0, sampler="prng",
                                                mode=mode)))
    n, m = H_QMC
    cases.append((f"heston_mc price sobol_bb {n}x{m}", hk._heston_mc_cuda, hk._heston_mc_plain,
                  (euler(m, STRIKE),), dict(n_steps=m, n_blocks=hk._n_blocks(n, hk.PATHS_PER_BLOCK),
                                            cp=1.0, sampler="sobol_bb", mode="price")))
    n, m = H_QE
    cases.append((f"heston_qe prng {n}x{m}", hk._heston_qe_cuda, hk._heston_qe_plain,
                   (qe(m, False),), dict(n_steps=m, n_blocks=hk._n_blocks(n, hk.PATHS_PER_BLOCK),
                                         cp=1.0, sampler="prng")))
    cases.append((f"heston_qe_ladder prng {n}x{m}", hk._heston_qe_ladder_cuda,
                  hk._heston_qe_ladder_plain, (qe(m, True),),
                  dict(n_steps=m, n_blocks=hk._n_blocks(n, hk.LADDER_PATHS_PER_BLOCK), cp=1.0,
                       sampler="prng")))
    strikes, mats, cps = heston_chain_quotes()
    plan = hk.chain_plan(strikes, mats, cps, H_CHAIN_DT, dev)
    cases.append((f"heston_chain prng 40 quotes {H_CHAIN_PATHS}x{plan.n_steps}",
                  hk._heston_chain_cuda, hk._heston_chain_plain, (chain_head(dev), plan),
                  dict(n_blocks=hk._n_blocks(H_CHAIN_PATHS, hk.PATHS_PER_BLOCK), sampler="prng")))
    return cases


def qe_ladder_edge_cases(dev):
    """(tag, kernel fn, plain fn, args, kwargs) of the QE ladder at the edges
    of its draw chunks (not timed)."""
    par = hmodel.HestonParams.make(*H_PARAMS)
    cases = []
    for n_steps in H_QE_EDGE_STEPS:
        p = torch.tensor(hk._params_vec_qe_ladder(S0, STRIKE, T, RATE, par, 0.01, n_steps)[1],
                         device=dev)
        for nb in H_QE_EDGE_BLOCKS:
            for sampler in ("hash", "prng"):
                for cp in (1.0, -1.0):
                    cases.append((f"heston_qe_ladder edge {sampler} cp={cp:+.0f} {nb}x{n_steps}",
                                  hk._heston_qe_ladder_cuda, hk._heston_qe_ladder_plain, (p,),
                                  dict(n_steps=n_steps, n_blocks=nb, cp=cp, sampler=sampler)))
    return cases


def chain_head(dev) -> torch.Tensor:
    return hk._chain_head(torch.tensor(H_PARAMS, device=dev), S0, RATE, 0.01)


def phase_heston_parity(dev) -> dict:
    """Kernels 4–7 against their plain versions (block0 = 1: odd); the
    largest absolute difference of each. The QE ladder runs twice per case
    and must repeat its rows bit for bit."""
    worst = {"mc": 0.0, "qe": 0.0, "qe_ladder": 0.0, "chain": 0.0}
    for tag, kfn, pfn, args, kw in heston_parity_cases(dev) + qe_ladder_edge_cases(dev):
        kern = kfn(7, 1, *args, **kw)
        plain = pfn(7, 1, *args, **kw)
        torch.cuda.synchronize()
        key = tag.split()[0].replace("heston_", "")
        if kern.dim() == 3:  # the chain: (Q, 7, ROWS), pay and pay² per row, 5 gradients
            err = max(compare_sums(kern[q], plain[q], f"{tag} q{q}") for q in range(len(kern)))
        elif key == "qe_ladder":  # all nine moments own-row
            err = compare_sums(kern, plain, tag, n_plain=9, rtol=QE_LADDER_RTOL)
            check(torch.equal(kfn(7, 1, *args, **kw), kern), f"{tag}: two launches differ")
        else:  # Euler: pay, pay², m1, then the sensitivities; QE: all own-row
            err = compare_sums(kern, plain, tag, n_plain=3)
        worst[key] = max(worst[key], err)
    return worst


def lewis_ad(dev, strike=STRIKE, t=T, cp=1.0, params=H_PARAMS):
    """(price, {v0, kappa, theta, sigma, rho, T, r, S: ∂price}) by autograd of
    the port's Lewis pricer, float64 on the card."""
    f64 = torch.float64
    x = {k: torch.tensor(v, dtype=f64, device=dev, requires_grad=True)
         for k, v in zip(H_NAMES + ("T", "r", "S"), tuple(params) + (t, RATE, S0))}
    par = hmodel.HestonParams(*(x[k] for k in H_NAMES))

    def c(v):
        return torch.tensor(v, dtype=f64, device=dev)

    price = hmodel.heston_price(ContractBatch(x["S"], c(strike), x["T"], x["r"], c(0.2),
                                              c(0.0), c(cp)), par)
    grads = torch.autograd.grad(price, list(x.values()))
    return price.item(), {k: g.item() for k, g in zip(x, grads)}


def euler_bias(dev, n_steps: int, exact: float, pay_sd: float, n_scan: int = 4_194_304) -> float:
    """|scan engine − Lewis| at ``n_steps`` plus 4 of the scan's standard
    errors (payoff sd ``pay_sd`` over √n_scan): the Euler discretization
    bias the tolerance of a kernel price at that step count allows."""
    gen = torch.Generator(device=dev).manual_seed(11)
    scan = hmodel.heston_mc_price(ContractBatch.make(S0, STRIKE, T, RATE, 0.2, device=dev),
                                  hmodel.HestonParams.make(*H_PARAMS, device=dev), gen,
                                  n_paths=n_scan, n_steps=n_steps).item()
    bias = abs(scan - exact) + 4 * pay_sd / math.sqrt(n_scan)
    log("heston", f"scan engine at {n_steps} steps: {scan:.6f} vs Lewis {exact:.6f} "
                  f"(Euler bias allowance {bias:.5f})")
    return bias


def heston_greek_stderrs(dev) -> dict:
    """Standard errors of the Euler and QE ladders' Greeks at the path's
    shapes, from the 128 independent row groups of one launch of each kernel
    (another seed than the main path's). Not counted as main path."""
    par = hmodel.HestonParams.make(*H_PARAMS)
    n, m = H_EULER
    df = math.exp(-RATE * T)
    _, p = hk._params_vec(S0, STRIKE, T, RATE, par, 0.0, m)
    nb = hk._n_blocks(n, hk.LADDER_PATHS_PER_BLOCK)
    rows = hk._heston_mc_cuda(99, 0, torch.tensor(p, device=dev), n_steps=m, n_blocks=nb, cp=1.0,
                              mode="ladder").double()
    n_row = nb * hk.LADDER_PATHS_PER_BLOCK / hk.ROWS
    out = {}
    for k, key in enumerate(("vega_v0", "d_kappa", "d_theta", "d_sigma", "d_rho", "theta")):
        out[("euler", key)] = (df * rows[3 + k] / n_row).std().item() / math.sqrt(hk.ROWS)
    out[("euler", "rho")] = T * df * (rows[2] / n_row).std().item() / math.sqrt(hk.ROWS)
    n, m = H_QE
    _, p, hs = hk._params_vec_qe_ladder(S0, STRIKE, T, RATE, par, 0.0, m)
    nb = hk._n_blocks(n, hk.LADDER_PATHS_PER_BLOCK)
    rows = hk._heston_qe_ladder_cuda(99, 0, torch.tensor(p, device=dev), n_steps=m, n_blocks=nb,
                                     cp=1.0).double()
    n_row = nb * hk.LADDER_PATHS_PER_BLOCK / hk.ROWS
    keys = ("vega_v0", "d_kappa", "d_theta", "d_sigma", "d_rho", "theta")
    for k, (key, h) in enumerate(zip(keys, hs)):
        out[("qe", key)] = df * ((rows[3 + k] - rows[0]) / (h * n_row)).std().item() \
            / math.sqrt(hk.ROWS)
    out[("qe", "delta")] = df * (rows[2] / n_row).std().item() / S0 / math.sqrt(hk.ROWS)
    out[("qe", "rho")] = T * df * (rows[2] / n_row).std().item() / math.sqrt(hk.ROWS)
    log("heston", "ladder Greek stderrs from 128 row groups: " + " ".join(
        f"{s}:{k}={v:.2e}" for (s, k), v in out.items()))
    return out


def phase_heston_main(dev, card: str, greek_se: dict) -> dict:
    """The Heston European path through its entry points at full width,
    against Lewis and autograd of Lewis. Returns the wrapper calls routed to
    each kernel and the warm wall times."""
    calls = {"mc": 0, "qe": 0, "qe_ladder": 0, "chain": 0}
    walls = []
    par = hmodel.HestonParams.make(*H_PARAMS, device=dev)
    exact, ad = lewis_ad(dev)

    def record(tag, n_paths, n_steps, ms):
        walls.append(f"{tag} {ms:.3f} ms ({n_paths * n_steps / (ms / 1e3):.4e} path-steps/s)")

    # Euler price, 8,388,608 × 252
    n, m = H_EULER
    (p, se, paths), ms = timed(lambda: hk.heston_kernel_price(S0, STRIKE, T, RATE, par,
                                                             n_paths=n, n_steps=m, device=dev))
    calls["mc"] += 4
    record(f"heston_kernel_price euler {n}x{m}", paths, m, ms)
    p, se = p.item(), se.item()
    pay_sd = se * math.sqrt(paths)  # discounted payoff sd
    bias252 = euler_bias(dev, m, exact, pay_sd)
    tol = 4 * se + bias252
    log("heston", f"euler price {paths}x{m}: {p:.6f} se={se:.3e} Lewis={exact:.6f} "
                  f"|err|={abs(p - exact):.2e} tol={tol:.2e}")
    check(abs(p - exact) < tol, f"Heston Euler price {p} vs Lewis {exact} (tol {tol})")

    # v0-vega ladder, 8,388,608 × 252: delta, rho, vega against autograd of Lewis
    g, ms = timed(lambda: hk.heston_kernel_greeks(S0, STRIKE, T, RATE, par, n_paths=n,
                                                   n_steps=m, device=dev))
    calls["mc"] += 4
    record(f"heston_kernel_greeks vega {n}x{m}", g["paths"], m, ms)
    errs = {"delta": (g["delta"].item(), ad["S"], 0.01), "rho": (g["rho"].item(), ad["r"], 0.6),
            "vega_v0": (g["vega_v0"].item(), ad["v0"], 0.06 * abs(ad["v0"]) + 1.0)}
    log("heston", "vega ladder vs AD of Lewis (test_heston_pallas.py bounds): " + " ".join(
        f"{k}={v:.5f}/{e:.5f}" for k, (v, e, _b) in errs.items()))
    for k, (v, e, b) in errs.items():
        check(abs(v - e) < b, f"Heston vega ladder {k} {v} vs AD {e} (bound {b})")

    # full Euler ladder, 8,388,608 × 252 on 128 ladder blocks
    lad, ms = timed(lambda: hk.heston_kernel_greeks(S0, STRIKE, T, RATE, par, n_paths=n,
                                                     n_steps=m, ladder=True, device=dev))
    calls["mc"] += 4
    record(f"heston_kernel_greeks ladder {n}x{m}", lad["paths"], m, ms)
    # the reference test's bounds (262144 paths) scaled to this run's stderr,
    # and never below 5 of the Greek's own standard errors
    scale = math.sqrt(2 * 131072 / lad["paths"])
    bounds = {"vega_v0": ("v0", 0.8), "d_kappa": ("kappa", 0.03), "d_theta": ("theta", 1.2),
              "d_sigma": ("sigma", 0.12), "d_rho": ("rho", 0.08), "theta": ("T", 0.15),
              "rho": ("r", 0.6)}
    rows = []
    for key, (name, b) in bounds.items():
        exact_k = -ad[name] if key == "theta" else ad[name]
        got = lad[key].item()
        bound = max(b * scale, 5 * greek_se[("euler", key)])
        rows.append(f"{key}={got:.5f}/{exact_k:.5f} (bound {bound:.4f})")
        check(abs(got - exact_k) < bound, f"Heston ladder {key} {got} vs AD {exact_k}")
    log("heston", "full ladder vs AD of Lewis, bounds max(test_heston_pallas.py:187 × "
                  f"{scale:.4f}, 5·se): " + " ".join(rows))

    # QE price and QE ladder, 8,388,608 × 32
    n, m = H_QE
    (pq, seq, paths), ms = timed(lambda: hk.heston_kernel_price(S0, STRIKE, T, RATE, par,
                                                               n_paths=n, n_steps=m, scheme="qe",
                                                               device=dev))
    calls["qe"] += 4
    record(f"heston_kernel_price qe {n}x{m}", paths, m, ms)
    log("heston", f"QE price {paths}x{m}: {pq.item():.6f} se={seq.item():.3e} Lewis={exact:.6f}")
    check(abs(pq.item() - exact) < 4 * seq.item() + 0.01, "Heston QE price vs Lewis")
    ql, ms = timed(lambda: hk.heston_kernel_greeks(S0, STRIKE, T, RATE, par, n_paths=n,
                                                    n_steps=m, scheme="qe", ladder=True,
                                                    device=dev))
    calls["qe_ladder"] += 4
    record(f"heston_kernel_greeks qe ladder {n}x{m}", ql["paths"], m, ms)
    scale = math.sqrt(131072 / ql["paths"])
    qbounds = {"vega_v0": ("v0", 1.5), "d_kappa": ("kappa", 0.05), "d_theta": ("theta", 2.0),
               "d_sigma": ("sigma", 0.05), "d_rho": ("rho", 0.02), "delta": ("S", 0.01),
               "rho": ("r", 0.25), "theta": ("T", 0.05)}
    rows = []
    for key, (name, b) in qbounds.items():
        exact_k = -ad[name] if key == "theta" else ad[name]
        got = ql[key].item()
        bound = max(b * scale, 5 * greek_se[("qe", key)])
        rows.append(f"{key}={got:.5f}/{exact_k:.5f} (bound {bound:.4f})")
        check(abs(got - exact_k) < bound, f"Heston QE ladder {key} {got} vs AD {exact_k}")
    log("heston", f"QE ladder vs AD of Lewis, bounds max(test_heston_pallas.py:414 × {scale:.4f}, "
                  "5·se): " + " ".join(rows))

    # bridge QMC, 4,194,304 × 64
    n, m = H_QMC
    (pb, seb, paths), ms = timed(lambda: hk.heston_kernel_price(S0, STRIKE, T, RATE, par,
                                                               n_paths=n, n_steps=m,
                                                               sampler="sobol_bb", device=dev))
    calls["mc"] += 4
    record(f"heston_kernel_price sobol_bb {n}x{m}", paths, m, ms)
    tol = 4 * seb.item() + euler_bias(dev, m, exact, pay_sd)
    log("heston", f"sobol_bb {paths}x{m}: {pb.item():.6f} RQMC se={seb.item():.3e} "
                  f"Lewis={exact:.6f} tol={tol:.2e}")
    check(abs(pb.item() - exact) < tol, "Heston bridge-QMC price vs Lewis")

    # the 40-quote chain: prices against Lewis, gradients against its autograd
    strikes, mats, cps = heston_chain_quotes()
    (cp_, cse, cg), ms = timed(lambda: hk.heston_chain_ladder(
        strikes, mats, cps, S0, RATE, par, n_paths=H_CHAIN_PATHS, max_dt=H_CHAIN_DT, device=dev))
    calls["chain"] += 4
    plan = hk.chain_plan(strikes, mats, cps, H_CHAIN_DT, dev)
    record(f"heston_chain_ladder 40 quotes {H_CHAIN_PATHS}x{plan.n_steps}",
           hk._n_blocks(H_CHAIN_PATHS, hk.PATHS_PER_BLOCK) * hk.PATHS_PER_BLOCK, plan.n_steps, ms)
    pv = torch.tensor(H_PARAMS, dtype=torch.float64, device=dev, requires_grad=True)
    lew = hmodel.heston_price(ContractBatch.make(S0, torch.tensor(strikes, dtype=torch.float64),
                                                 torch.tensor(mats, dtype=torch.float64), RATE,
                                                 0.2, torch.tensor(cps, dtype=torch.float64),
                                                 device=dev, dtype=torch.float64),
                              hmodel.HestonParams(*pv.unbind()))
    jac = torch.stack([torch.autograd.grad(lew[q], pv, retain_graph=True)[0]
                       for q in range(len(strikes))]).cpu().numpy()
    lew = lew.detach().cpu().numpy()
    price_err = (cp_.cpu().numpy() - lew) / cse.cpu().numpy()
    # Euler at dt = 0.02: the reference's 0.06 allowance at dt = 1/16 (weak order 1) scaled
    bias = 0.06 * H_CHAIN_DT * 16
    bad_p = [q for q in range(len(strikes))
             if not abs(cp_[q].item() - lew[q]) < 5 * cse[q].item() + bias]
    gscale = math.sqrt(131072 / H_CHAIN_PATHS)
    gtol = (np.maximum(0.12 * gscale, 0.03 * np.abs(jac)) + 0.12 * np.abs(jac))
    gerr = np.abs(cg.cpu().numpy() - jac)
    log("heston", f"chain 40 quotes: max|price − Lewis|/se={np.abs(price_err).max():.2f} "
                  f"max|price − Lewis|={np.abs(cp_.cpu().numpy() - lew).max():.4f} "
                  f"(bound 5·se + {bias:.3f}); grads max err/tol={float((gerr / gtol).max()):.3f}")
    check(not bad_p, f"Heston chain prices vs Lewis at quotes {bad_p}")
    check(bool(np.all(gerr <= gtol)), "Heston chain gradients vs autograd of Lewis")

    # kernel-speed calibration on that chain's Lewis prices
    gen = hmodel.HestonParams.make(*H_CALIB_GEN, dtype=torch.float64, device=dev)
    market = hmodel.heston_price(ContractBatch.make(
        S0, torch.tensor(strikes, dtype=torch.float64), torch.tensor(mats, dtype=torch.float64),
        RATE, 0.2, torch.tensor(cps, dtype=torch.float64), device=dev, dtype=torch.float64), gen)
    before = hk._heston_chain_cuda.launches
    t0 = time.perf_counter()
    fit, loss = hmodel.calibrate_heston_mc(
        market.float(), strikes, mats, cps, S0, RATE,
        init=hmodel.HestonParams.make(*H_CALIB_INIT, device=dev), n_steps=H_CALIB_STEPS,
        learning_rate=0.06, n_paths=H_CHAIN_PATHS, max_dt=H_CALIB_DT, device=dev)
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    launches = hk._heston_chain_cuda.launches - before
    calls["chain"] += H_CALIB_STEPS + 2
    walls.append(f"calibrate_heston_mc {H_CALIB_STEPS} Adam steps {calib_ms:.1f} ms")
    got = {k: getattr(fit, k).item() for k in H_NAMES}
    cbounds = {"v0": 0.004, "kappa": 0.25, "theta": 0.004, "rho": 0.15, "sigma": 0.1}
    log("heston", f"calibrate_heston_mc (dt {H_CALIB_DT}, {calib_ms:.1f} ms): loss={loss:.3e} "
                  f"launches={launches} " + " ".join(
        f"{k}={got[k]:.5f}/{v:.5f}" for k, v in zip(H_NAMES, H_CALIB_GEN)))
    check(loss < 5e-5, f"calibrate_heston_mc loss {loss}")
    check(launches == H_CALIB_STEPS + 2,
          f"calibrate_heston_mc made {launches} chain launches, not {H_CALIB_STEPS + 2}")
    for k, v in zip(H_NAMES, H_CALIB_GEN):
        check(abs(got[k] - v) < cbounds[k], f"calibrate_heston_mc {k}={got[k]} vs {v}")

    # the object façade's kernel engine
    pricer = hmodel.HestonPricer(*H_PARAMS, device=dev)
    pp, ms = timed(lambda: pricer.price_monte_carlo(S0, STRIKE, T, RATE, n_paths=H_EULER[0],
                                                    n_steps=H_EULER[1], seed=5,
                                                    engine="pallas"))
    calls["mc"] += 4
    record("HestonPricer.price_monte_carlo(engine='pallas')", H_EULER[0], H_EULER[1], ms)
    check(abs(pp.item() - exact) < 4 * se + bias252,
          f"HestonPricer pallas engine {pp.item()} vs Lewis {exact}")
    log("heston", f"warm wall, mean of 3 [{card}]: " + "; ".join(walls))
    return calls


def phase_heston_server(dev) -> None:
    """``/price`` with ``model: "heston"`` served on the card."""
    server = PricingServer(port=0, device=dev).start()
    try:
        body = {"model": "heston", "heston_params": dict(zip(H_NAMES, H_PARAMS)),
                "strike": 105.0}
        status, out = _request(f"http://127.0.0.1:{server.port}/price", body)
        ref = hmodel.heston_price(ContractBatch.make(S0, 105.0, T, RATE, 0.2, device=dev),
                                  hmodel.HestonParams.make(*H_PARAMS, device=dev)).item()
        check(status == 200 and out["price"] == ref, f"/price heston: {status} {out} vs {ref}")
        log("heston server", f"/price heston K=105: {out['price']:.6f} (Lewis on the card)")
    finally:
        server.stop()


def heston_timing(dev) -> dict:
    """Device ms of kernels 4–7 and their plain versions at the Heston path's
    shapes (prng). Not counted as main path."""
    out = {}
    for tag, kfn, pfn, args, kw in heston_parity_cases(dev):
        if "3x1" in tag or "5 quotes" in tag:
            continue
        ms, plain_ms = event_pair(lambda: kfn(0, 0, *args, **kw), lambda: pfn(0, 0, *args, **kw))
        nb = kw["n_blocks"]
        if "chain" in tag:
            plan = args[1]
            trips = nb * hk.ROWS * hk.LANES * plan.n_steps
            n_bytes = 4 * (9 + 2 * plan.n_steps + 3 * plan.n_quotes + 7 * plan.n_quotes * hk.ROWS)
        else:
            lanes = hk.LADDER_LANES if ("ladder" in tag) else hk.LANES
            trips = nb * hk.ROWS * lanes * kw["n_steps"]
            n_mom = 9 if "ladder" in tag else (4 if "vega" in tag else 3)
            n_bytes = 4 * (args[0].numel() + n_mom * hk.ROWS)
        out[tag] = {"ms": ms, "plain_ms": plain_ms, "trips": trips, "bytes": n_bytes,
                    "steps": plan.n_steps if "chain" in tag else kw["n_steps"]}
    return out


# mangled-name parts and the lane-step's loops: MUFU.RSQ per step trip (the
# Box–Muller root and one sqrtf(v⁺) per branch; QE: three roots per path
# system and branch)
HESTON_SASS = {"heston_mc price": (("heston_mc_kernelILi0ELi0E",), nest((3, 1))),
               "heston_mc vega": (("heston_mc_kernelILi1ELi0E",), nest((3, 1))),
               "heston_mc ladder": (("heston_mc_kernelILi2ELi0E",), nest((3, 1))),
               # two passes per bridge segment: a Box–Muller per pre-pass trip, three
               # roots per replay trip
               "heston_mc price sobol_bb": (("heston_mc_kernelILi0ELi2E",), nest(((1, 3), 1))),
               "heston_qe prng": (("heston_qe_kernelILi1ELi0E",), nest((7, 1))),
               # per lane-step 7 trips of the advance loop (one system pair, 6 roots),
               # 1 of the chunk loop that draws (1 root), and per lane 7 payoff
               # epilogues (one per system); less the split's own bookkeeping (the
               # shared-memory moves, the barrier, both loops' addresses and control),
               # so the bound is the function's, not this layout's
               "heston_qe_ladder": (("heston_qe_ladder_kernelILi0E",),
                                    nest((6, 7), (1, 1), tail=7, bookkeeping=False)),
               "heston_chain": (("heston_chain_kernelILi0E",), nest((3, 1)))}
# SASS digests (sass_bound.digest) of the QE instances that share heston_qe.cu
# or heston_qe.cuh with the QE ladder, as built from the tree before the
# ladder was split (nvcc 12.9, sm_90a): (function count, SHA-256)
QE_SASS_PINS = {
    ("heston_qe_kernelILi1E",):
        (2, "aece293e5209e0b07bfc07dcb087723baa0223637e0fa157c33b70c81bf02e42"),
    ("heston_exotic_kernel", "ELb0ELi1ELi"):
        (16, "2544d00a657d915dd6680f55d93b7c2ea85f79e94ff10e27fb00736449009238")}


# ---------------------------------------------------------------------------
# the Heston/Bates exotic path (csrc/heston_exotic.cu)
# ---------------------------------------------------------------------------
HX_MAIN = (8_388_608, 64)  # bench.py:195 (Asian) and :211 (barrier LR ladder)
HX_BOOK = (1_000_000, 64)  # bench.py:284, paths per contract
HX_BOOK_K = [80.0, 85.0, 90.0, 95.0, 100.0, 105.0, 110.0, 115.0]
HX_BATES_QE = (8_388_608, 16)
HX_STRUCT = (4_194_304, 252)
HX_QMC = (4_194_304, 64)
HX_SCAN = 1_048_576  # the scan engine's paths
HX_BATES = dict(lam=0.5, mu_j=-0.1, sigma_j=0.15)
# the kinds whose payoff takes the sign cp
HX_CP_KINDS = ("asian_arith", "asian_geo", "lookback_float", "lookback_fixed",
               "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out",
               "barrier_down-and-in", "barrier_double-out", "barrier_double-in")
HX_SLOTS = {"cliquet": [-0.03, 0.03, 0.0, 1e9, 100.0],  # A..E as the wrappers set them
            "autocall": [0.0, math.log(0.8), math.log(0.7), 2.0, 100.0],
            "range_accrual": [math.log(0.9), math.log(1.1), 0.0, 0.0, 100.0]}


def hx_params(bates: bool = False, dev=None, **over):
    vals = dict(zip(H_NAMES, H_PARAMS), **over)
    if bates:
        return BatesParams.make(**vals, **HX_BATES, device=dev)
    return hmodel.HestonParams.make(**vals, device=dev)


def hx_inputs(kind: str, n_steps: int, dev, scheme: str = "euler", bates: bool = False):
    """(params, one-contract book) of a launch, with every kind's slots set."""
    barrier = 115.0 if "up" in kind else (88.0 if "down" in kind else 0.0)
    p, _ = hx._exotic_params(S0, STRIKE, T, RATE, hx_params(bates), 0.01, barrier, n_steps, scheme)
    if "double" in kind:
        hx._set_double_band(p, S0, 88.0, 115.0)
    if kind in HX_SLOTS:
        p[hx._HX_A:hx._HX_DYN] = HX_SLOTS[kind]
    params = torch.tensor(p, dtype=torch.float32, device=dev)
    return params, params[list(hx._BOOK_SLOTS)].reshape(1, 7).contiguous()


def hx_parity_cases(dev) -> list:
    """(tag, params, book, kwargs) of the Heston exotic parity phase: every
    kind × lr × hash/prng × cp (Euler), QE price of every non-structured kind,
    jumps under both schemes, bridge QMC, books, then the path's shapes."""
    cases = []

    def add(tag, kind, n_steps, n_blocks, dev_, scheme="euler", bates=False, book=None, **kw):
        params, one = hx_inputs(kind, n_steps, dev_, scheme, bates)
        kw = dict(kind=kind, n_steps=n_steps, n_blocks=n_blocks, scheme=scheme, jumps=bates,
                  period=kw.pop("period", 3 if kind in ("cliquet", "autocall") else 1), **kw)
        cases.append((tag, params, one if book is None else book, kw))

    for kind in hx.HESTON_EXOTIC_KINDS:
        for sampler in ("hash", "prng"):
            for lr in (False, True):
                for cp in ((1.0, -1.0) if kind in HX_CP_KINDS else (1.0,)):
                    add(f"{kind} {sampler} lr={lr} cp={cp:+.0f} 3x12", kind, 12, 3, dev, cp=cp,
                        sampler=sampler, lr=lr)
    for j, kind in enumerate(k for k in hx.HESTON_EXOTIC_KINDS if k not in hx.STRUCTURED):
        sampler = ("hash", "prng")[j % 2]
        add(f"{kind} qe {sampler} 3x12", kind, 12, 3, dev, "qe", cp=1.0, sampler=sampler)
    for kind, scheme, sampler, lr, cp in (("asian_arith", "euler", "prng", True, 1.0),
                                          ("barrier_down-and-in", "euler", "hash", False, -1.0),
                                          ("autocall", "qe", "prng", False, 1.0),
                                          ("one_touch_down_hit", "qe", "hash", False, 1.0),
                                          ("range_accrual", "euler", "hash", True, 1.0)):
        add(f"{kind} bates {scheme} {sampler} lr={lr} 3x12", kind, 12, 3, dev, scheme, True,
            cp=cp, sampler=sampler, lr=lr)
    for kind, bates in (("asian_arith", False), ("barrier_up-and-out", False), ("cliquet", False),
                        ("one_touch_double_hit", True)):
        add(f"{kind} sobol_bb bates={bates} 3x12", kind, 12, 3, dev, bates=bates, cp=1.0,
            sampler="sobol_bb")
    for nc, kind in ((2, "barrier_up-and-out"), (8, "asian_arith"), (128, "one_touch_up_hit")):
        strikes = torch.linspace(90.0, 110.0, nc).tolist()
        barriers = torch.linspace(110.0, 130.0, nc).tolist()
        table, *_ = hx._heston_book_vec(kind, S0, strikes, barriers, None, None)
        book = torch.tensor(table, dtype=torch.float32, device=dev)
        for lr in (False, True):
            add(f"book nc={nc} {kind} prng lr={lr} 3x12", kind, 12, 3, dev, book=book, cp=1.0,
                sampler="prng", lr=lr)
    # the path's own shapes (many path blocks per thread), prng
    nb_main = hx._n_blocks(HX_MAIN[0], hx.PATHS_PER_BLOCK)
    add(f"asian_arith prng {HX_MAIN[0]}x{HX_MAIN[1]}", "asian_arith", HX_MAIN[1], nb_main, dev,
        cp=1.0, sampler="prng")
    add(f"barrier_up-and-out prng lr {HX_MAIN[0]}x{HX_MAIN[1]}", "barrier_up-and-out",
        HX_MAIN[1], nb_main, dev, cp=1.0, sampler="prng", lr=True)
    add(f"barrier_down-and-in bates prng {HX_MAIN[0]}x{HX_MAIN[1]}", "barrier_down-and-in",
        HX_MAIN[1], nb_main, dev, bates=True, cp=-1.0, sampler="prng")
    add(f"asian_arith bates qe prng {HX_BATES_QE[0]}x{HX_BATES_QE[1]}", "asian_arith",
        HX_BATES_QE[1], hx._n_blocks(HX_BATES_QE[0], hx.PATHS_PER_BLOCK), dev, "qe", True, cp=1.0,
        sampler="prng")
    nb_s = hx._n_blocks(HX_STRUCT[0], hx.PATHS_PER_BLOCK)
    for kind, period in (("autocall", 63), ("cliquet", 21)):
        for lr in (False, True):
            add(f"{kind} prng lr={lr} {HX_STRUCT[0]}x{HX_STRUCT[1]}", kind, HX_STRUCT[1], nb_s, dev,
                cp=1.0, sampler="prng", lr=lr, period=period)
    add(f"asian_arith sobol_bb {HX_QMC[0]}x{HX_QMC[1]}", "asian_arith", HX_QMC[1],
        hx._n_blocks(HX_QMC[0], hx.PATHS_PER_BLOCK), dev, cp=1.0, sampler="sobol_bb")
    nc = len(HX_BOOK_K)
    table, *_ = hx._heston_book_vec("asian_arith", S0, HX_BOOK_K, None, None, None)
    add(f"book nc={nc} asian_arith prng {HX_BOOK[0]}x{HX_BOOK[1]}", "asian_arith", HX_BOOK[1],
        hx._n_blocks(HX_BOOK[0], (hx.ROWS // nc) * hx.LANES * 2), dev,
        book=torch.tensor(table, dtype=torch.float32, device=dev), cp=1.0, sampler="prng")
    return cases


def phase_hx_parity(dev) -> float:
    """The Heston exotic kernel against its plain version; returns the
    largest absolute difference."""
    worst = 0.0
    for tag, params, book, kw in hx_parity_cases(dev):
        kern = hx._heston_exotic_cuda(7, 1, params, book, **kw)
        plain = hx._heston_exotic_plain(7, 1, params, book, **kw)
        torch.cuda.synchronize()
        worst = max(worst, compare_sums(kern, plain, f"heston_exotic {tag}"))
    return worst


def hx_lr_runs():
    """(tag, wrapper, args, kwargs, n_paths, n_steps) of the LR workloads of
    the path, whose Greeks are checked against CRN finite differences."""
    n, m = HX_MAIN
    ns, ms = HX_STRUCT
    return [("barrier LR", "exotic", ("barrier_up-and-out", S0, STRIKE, T, RATE),
             dict(barrier=120.0), n, m),
            ("autocall LR", "autocall", (S0, T, RATE), {}, ns, ms),
            ("cliquet LR", "cliquet", (S0, T, RATE), {}, ns, ms),
            ("range accrual LR", "range_accrual", (S0, 90.0, 110.0, T, RATE), {}, ns, ms)]


def hx_lr_stderrs(dev) -> dict:
    """Standard errors of the LR Greeks at the path's shapes from the 128
    independent row groups of one launch each (another seed than the main
    path's). Not counted as main path."""
    par = hx_params()
    out = {}
    for tag, name, args, kw, n_paths, n_steps in hx_lr_runs():
        if name == "exotic":
            p, t = hx._exotic_params(*args[1:], par, 0.0, kw["barrier"], n_steps, "euler")
            kind, period = args[0], 1
        elif name == "autocall":
            p, t = hx._autocall_params(*args, par, 0.0, 100.0, 1.0, 0.8, 0.7, 0.08, 4, n_steps,
                                       "euler")
            kind, period = name, n_steps // 4
        elif name == "cliquet":
            p, t = hx._cliquet_params(*args, par, 0.0, -0.05, 0.05, 0.0, 1e9, 100.0, 12, n_steps,
                                      "euler")
            kind, period = name, n_steps // 12
        else:
            p, t = hx._range_params(*args, par, 0.0, 100.0, n_steps, "euler")
            kind, period = name, 1
        nb = hx._n_blocks(n_paths, hx.PATHS_PER_BLOCK)
        params = torch.tensor(p, dtype=torch.float32, device=dev)
        rows = hx._heston_exotic_cuda(99, 0, params, params[list(hx._BOOK_SLOTS)].reshape(1, 7),
                                      kind=kind, n_steps=n_steps, n_blocks=nb, cp=1.0,
                                      period=period, lr=True).double()
        n_row = nb * hx.LANES * 2
        g = hx._combine_exotic_lr(list(rows / n_row), n_row,
                                  hx._lr_scalars(S0, t, RATE, par, n_steps), n_steps,
                                  discounted=kind == "autocall")
        for key in ("delta", "rho", "theta", "vega_v0"):
            out[(tag, key)] = g[key].double().std().item() / math.sqrt(hx.ROWS)
    log("heston exotic", "LR Greek stderrs from 128 row groups: " + " ".join(
        f"{t}:{k}={v:.2e}" for (t, k), v in out.items()))
    return out


def phase_hx_main(dev, card: str, lr_se: dict) -> int:
    """The Heston/Bates exotic path through its entry points at the JAX
    package's bench sizes, against exact identities, closed forms, the scan
    engine and CRN finite differences. Returns the number of calls routed
    to the kernel."""
    calls = [0]
    walls = []
    par, bpar = hx_params(dev=dev), hx_params(True, dev)
    df = math.exp(-RATE * T)

    def k(fn, *a, **kw):
        calls[0] += 1
        return fn(*a, device=dev, **kw)

    def record(tag, n_paths, n_steps, ms):
        walls.append(f"{tag} {ms:.3f} ms ({n_paths * n_steps / (ms / 1e3):.4e} path-steps/s)")

    def scan_check(tag, got, se, scan_p, scan_se, extra=0.01):
        tol = 5 * math.hypot(se, scan_se) + extra
        log("heston exotic", f"{tag}: kernel={got:.6f}±{se:.2e} scan={scan_p:.6f}±{scan_se:.2e} "
                             f"|diff|={abs(got - scan_p):.2e} tol={tol:.2e}")
        check(abs(got - scan_p) < tol, f"{tag}: kernel {got} vs scan engine {scan_p}")

    gen = torch.Generator(device=dev)
    n, m = HX_MAIN
    # the Asian price, 8,388,608 × 64, against the scan engine
    (pa, sea, paths), ms = timed(lambda: k(hx.heston_kernel_exotic_price, "asian_arith", S0,
                                           STRIKE, T, RATE, par, n_paths=n, n_steps=m))
    record(f"asian_arith {n}x{m}", paths, m, ms)
    sp, sse = hscan.heston_exotic_price("asian_arith", S0, STRIKE, T, RATE, par, gen.manual_seed(1),
                                        n_paths=HX_SCAN, n_steps=m, return_stderr=True)
    scan_check(f"asian_arith {paths}x{m}", pa.item(), sea.item(), sp.item(), sse.item())

    # the LR ladders against CRN finite differences of the kernel
    # the reference tests' bounds and their path counts (tests/test_heston_exotics.py)
    fd_bounds = {"barrier LR": (500_000, {"delta": (0.02, 0.0), "rho": (1.0, 0.0)}),
                 "autocall LR": (250_000, {"rho": (0.3, 0.08), "theta": (0.3, 0.12)}),
                 "cliquet LR": (250_000, {"rho": (0.3, 0.08)}),
                 "range accrual LR": (400_000, {"delta": (0.025, 0.0)})}
    for tag, name, args, kw, n_paths, n_steps in hx_lr_runs():
        price_fn = getattr(hx, f"heston_kernel_{name}_price")
        lr_fn = getattr(hx, f"heston_kernel_{name}_lr_greeks")
        g, ms = timed(lambda: k(lr_fn, *args, par, n_paths=n_paths, n_steps=n_steps, **kw))
        record(f"{tag} {n_paths}x{n_steps}", g["paths"], n_steps, ms)

        def price(s=S0, r=RATE, t=T):
            a = list(args)
            if tag == "barrier LR":
                a[1], a[3], a[4] = s, t, r
            elif tag == "range accrual LR":
                a[0], a[3], a[4] = s, t, r
            else:
                a[0], a[1], a[2] = s, t, r
            return k(price_fn, *a, par, n_paths=n_paths, n_steps=n_steps, **kw)[0].item()

        p0 = price()
        check(abs(g["price"].item() - p0) < 1e-5 * abs(p0) + 1e-6,
              f"{tag}: LR price {g['price'].item()} differs from the price launch {p0}")
        fd = {"delta": lambda: (price(s=S0 + 0.5) - price(s=S0 - 0.5)) / 1.0,
              "rho": lambda: (price(r=RATE + 0.002) - price(r=RATE - 0.002)) / 0.004,
              "theta": lambda: -(price(t=T + 0.01) - price(t=T - 0.01)) / 0.02}
        ref_paths, bounds = fd_bounds[tag]
        scale = math.sqrt(ref_paths / g["paths"])
        rows = []
        for key, (absb, relb) in bounds.items():
            want = fd[key]()
            bound = max((absb + relb * abs(want)) * scale, 5 * lr_se[(tag, key)])
            got = g[key].item()
            rows.append(f"{key}={got:.5f}/{want:.5f} (bound {bound:.4f})")
            check(abs(got - want) < bound, f"{tag} {key}: LR {got} vs CRN FD {want}")
        log("heston exotic", f"{tag} {g['paths']}x{n_steps} vs CRN FD, bounds max(reference "
                             f"bound × {scale:.4f}, 5·se): " + " ".join(rows))

    # exact pathwise identities on one seed: in + out = vanilla, one + no touch = df
    kw = dict(n_paths=n, n_steps=m, seed=3)
    (van, sev, _), ms = timed(lambda: k(hx.heston_kernel_exotic_price, "barrier_up-and-out", S0,
                                        STRIKE, T, RATE, par, barrier=1e6, **kw))
    record(f"vanilla (far up-and-out) {n}x{m}", n, m, ms)
    p_in = k(hx.heston_kernel_exotic_price, "barrier_up-and-in", S0, STRIKE, T, RATE, par,
             barrier=120.0, **kw)[0].item()
    p_out = k(hx.heston_kernel_exotic_price, "barrier_up-and-out", S0, STRIKE, T, RATE, par,
              barrier=120.0, **kw)[0].item()
    one = k(hx.heston_kernel_exotic_price, "one_touch_up", S0, 0.0, T, RATE, par, barrier=120.0,
            **kw)[0].item()
    no = k(hx.heston_kernel_exotic_price, "no_touch_up", S0, 0.0, T, RATE, par, barrier=120.0,
           **kw)[0].item()
    log("heston exotic", f"identities: in+out={p_in + p_out:.7f} vanilla={van.item():.7f}; "
                         f"one+no touch={one + no:.8f} df={df:.8f}")
    check(abs(p_in + p_out - van.item()) < 1e-5 * van.item(), "up-and-in + up-and-out != vanilla")
    check(abs(one + no - df) < 1e-6, "one-touch + no-touch != df")
    # the far-barrier vanilla against Lewis within 4σ + the Euler bias at 64 steps
    exact, _ = lewis_ad(dev)
    bias = euler_bias(dev, m, exact, sev.item() * math.sqrt(n))
    log("heston exotic", f"vanilla {van.item():.6f}±{sev.item():.2e} Lewis={exact:.6f} "
                         f"tol={4 * sev.item() + bias:.2e}")
    check(abs(van.item() - exact) < 4 * sev.item() + bias, "far-barrier vanilla vs Lewis")

    # Bates: the down-and-in put at B = 80, its identity and the Bates CF
    put = dict(cp=-1.0, **kw)
    (pdi, sedi, _), ms = timed(lambda: k(hx.heston_kernel_exotic_price, "barrier_down-and-in", S0,
                                         STRIKE, T, RATE, bpar, barrier=80.0, **put))
    record(f"bates down-and-in put {n}x{m}", n, m, ms)
    pdo = k(hx.heston_kernel_exotic_price, "barrier_down-and-out", S0, STRIKE, T, RATE, bpar,
            barrier=80.0, **put)[0].item()
    bvan, bse, _ = k(hx.heston_kernel_exotic_price, "barrier_up-and-out", S0, STRIKE, T, RATE,
                     bpar, barrier=1e6, **put)
    bexact = bates_price(ContractBatch.make(S0, STRIKE, T, RATE, 0.2, "put", device=dev,
                                            dtype=torch.float64),
                         hx_params(True, dev).to(dtype=torch.float64)).item()
    hdi = k(hx.heston_kernel_exotic_price, "barrier_down-and-in", S0, STRIKE, T, RATE, par,
            barrier=80.0, **put)[0].item()
    log("heston exotic", f"bates down-and-in put {pdi.item():.6f}±{sedi.item():.2e} (heston "
                         f"{hdi:.6f}); in+out={pdi.item() + pdo:.7f} vanilla={bvan.item():.7f}; "
                         f"vanilla vs bates_price {bexact:.6f} tol={4 * bse.item() + 0.05:.3f}")
    check(abs(pdi.item() + pdo - bvan.item()) < 1e-5 * bvan.item(), "Bates in + out != vanilla")
    check(abs(bvan.item() - bexact) < 4 * bse.item() + 0.05, "Bates vanilla vs bates_price")
    check(pdi.item() > hdi + 0.5, "negative-mean jumps must raise the down-and-in put")

    # Bates QE Asian, 8,388,608 × 16, against the scan engine
    nq, mq = HX_BATES_QE
    (pq, seq, paths), ms = timed(lambda: k(hx.heston_kernel_exotic_price, "asian_arith", S0,
                                           STRIKE, T, RATE, bpar, n_paths=nq, n_steps=mq,
                                           scheme="qe"))
    record(f"bates qe asian_arith {nq}x{mq}", paths, mq, ms)
    sp, sse = hscan.heston_exotic_price("asian_arith", S0, STRIKE, T, RATE, bpar,
                                        gen.manual_seed(2), n_paths=HX_SCAN, n_steps=mq,
                                        scheme="qe", return_stderr=True)
    scan_check(f"bates qe asian_arith {paths}x{mq}", pq.item(), seq.item(), sp.item(), sse.item())

    # the GBM limit: σ_v → 0, v0 = θ (Euler), against the closed forms at σ = 0.2
    lim = hx_params(dev=dev, sigma=1e-7)
    pg, seg, _ = k(hx.heston_kernel_exotic_price, "asian_geo", S0, STRIKE, T, RATE, lim, **kw)
    cf = tex.geometric_asian_closed_form(S0, STRIKE, T, RATE, 0.2, n_steps=m).item()
    pr, ser, _ = k(hx.heston_kernel_range_accrual_price, S0, 90.0, 110.0, T, RATE, lim, **kw)
    cfr = tex.range_accrual_closed_form(S0, 90.0, 110.0, T, RATE, 0.2, n_steps=m).item()
    log("heston exotic", f"GBM limit: asian_geo {pg.item():.6f}±{seg.item():.2e} cf={cf:.6f}; "
                         f"range accrual {pr.item():.6f}±{ser.item():.2e} cf={cfr:.6f}")
    check(abs(pg.item() - cf) < 4 * seg.item() + 1e-3, "GBM-limit asian_geo vs closed form")
    # the reference's bound for the range accrual (tests/test_heston_exotics.py:454)
    check(abs(pr.item() - cfr) < 4 * ser.item() + 0.05, "GBM-limit range accrual vs closed form")

    # the structured products, 4,194,304 × 252, against the scan engine
    ns, ms_ = HX_STRUCT
    for tag, fn, sfn, args in (
            ("autocall", hx.heston_kernel_autocall_price, hscan.heston_autocall_price,
             (S0, T, RATE)),
            ("cliquet", hx.heston_kernel_cliquet_price, hscan.heston_cliquet_price, (S0, T, RATE)),
            ("range_accrual", hx.heston_kernel_range_accrual_price,
             hscan.heston_range_accrual_price, (S0, 90.0, 110.0, T, RATE))):
        (pk, sk, paths), ms = timed(lambda: k(fn, *args, par, n_paths=ns, n_steps=ms_))
        record(f"{tag} {ns}x{ms_}", paths, ms_, ms)
        sp, sse = sfn(*args, par, gen.manual_seed(3), n_paths=HX_SCAN, n_steps=ms_,
                      return_stderr=True)
        scan_check(f"{tag} {paths}x{ms_}", pk.item(), sk.item(), sp.item(), sse.item(),
                   0.02 if tag == "autocall" else 0.01)

    # bridge QMC, 4,194,304 × 64, against the prng Asian of the same scheme
    nb_, mb = HX_QMC
    (pb, seb, paths), ms = timed(lambda: k(hx.heston_kernel_exotic_price, "asian_arith", S0,
                                           STRIKE, T, RATE, par, n_paths=nb_, n_steps=mb,
                                           sampler="sobol_bb"))
    record(f"sobol_bb asian_arith {nb_}x{mb}", paths, mb, ms)
    log("heston exotic", f"sobol_bb asian {pb.item():.6f} RQMC se={seb.item():.2e} vs prng "
                         f"{pa.item():.6f}±{sea.item():.2e}")
    check(abs(pb.item() - pa.item()) < 5 * math.hypot(seb.item(), sea.item()),
          "bridge-QMC Asian vs the prng Asian")

    # books: 8 Asian strikes, then the barrier book's LR ladder, each contract
    # against its single-contract call
    nbk, mbk = HX_BOOK
    for greeks in (False, True):
        kind = "barrier_up-and-out" if greeks else "asian_arith"
        bkw = dict(barriers=[130.0] * len(HX_BOOK_K)) if greeks else {}
        if greeks:
            out, ms = timed(lambda: k(hx.heston_kernel_exotic_book_lr_greeks, kind, S0, HX_BOOK_K,
                                      T, RATE, par, n_paths=nbk, n_steps=mbk, **bkw))
            bp, bse, bn = out["price"], out["std_error"], out["paths"]
            check(all(torch.isfinite(out[g]).all() for g in ("delta", "gamma", "vega", "rho",
                                                               "theta")), "book LR not finite")
        else:
            (bp, bse, bn), ms = timed(lambda: k(hx.heston_kernel_exotic_book_price, kind, S0,
                                                HX_BOOK_K, T, RATE, par, n_paths=nbk,
                                                n_steps=mbk))
        record(f"book 8 {kind} greeks={greeks} {nbk}x{mbk}", bn * len(HX_BOOK_K), mbk, ms)
        zs = []
        for j, strike in enumerate(HX_BOOK_K):
            sp_, sse_, _ = k(hx.heston_kernel_exotic_price, kind, S0, strike, T, RATE, par,
                             barrier=130.0 if greeks else 0.0, n_paths=nbk, n_steps=mbk,
                             seed=100 + j)
            zs.append((bp[j].item() - sp_.item()) / math.hypot(bse[j].item(), sse_.item()))
        log("heston exotic", f"book of 8 {kind} greeks={greeks} vs singles: "
                             f"max|z|={max(abs(z) for z in zs):.2f}")
        check(all(abs(z) < 5 for z in zs), f"book {kind} vs single contracts: z = {zs}")
    log("heston exotic", f"warm wall, mean of 3 [{card}]: " + "; ".join(walls))
    return calls[0]


def phase_hx_server(dev) -> int:
    """``/exotic`` heston|heston-qe|bates, ``/book/exotic`` heston|bates and
    ``/price`` bates over a socket. Returns the requests routed to the
    kernel."""
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    big = {"n_paths": 4_000_000, "n_steps": 64}
    routed = 0
    try:
        for body in ({"model": "heston", "kind": "barrier", "greeks": True, "barrier": 130.0},
                     {"model": "heston-qe", "kind": "asian"},
                     {"model": "bates", "kind": "barrier", "barrier_type": "down-and-in",
                      "barrier": 80.0, "option_type": "put"},
                     {"model": "bates", "kind": "autocallable", "greeks": True}):
            status, out = _request(base + "/exotic", {**body, **big})
            routed += 1
            keys = ("price", "std_error") + (("delta", "vega", "rho") if body.get("greeks") else ())
            check(status == 200 and all(math.isfinite(out[k_]) for k_ in keys),
                  f"/exotic {body}: {status} {out}")
            log("heston server", f"/exotic {body['model']} {out['kind']}: price={out['price']:.5f} "
                                 f"se={out['std_error']:.2e} scheme={out['scheme']}")
        for model in ("heston", "bates"):
            body = {"model": model, "kind": "barrier", "strikes": [95.0, 100.0, 105.0],
                    "barriers": [120.0, 125.0, 130.0], "greeks": model == "heston",
                    "n_paths": 1_000_000}
            status, out = _request(base + "/book/exotic", body)
            routed += 1
            check(status == 200 and len(out["price"]) == 3 and all(
                math.isfinite(x) for x in out["price"]), f"/book/exotic {model}: {status} {out}")
            log("heston server", f"/book/exotic {model} barrier x3: prices={out['price']}")
        body = {"model": "bates", "bates_params": {"lam": 0.8}, "strike": 95.0}
        status, out = _request(base + "/price", body)
        ref = bates_price(ContractBatch.make(S0, 95.0, T, RATE, 0.2, device=dev),
                          BatesParams.make(lam=0.8, device=dev)).item()
        check(status == 200 and out["price"] == ref, f"/price bates: {status} {out} vs {ref}")
        log("heston server", f"/price bates K=95: {out['price']:.6f} (Lewis on the card)")
    finally:
        server.stop()
    return routed


def hx_timing(dev) -> dict:
    """Device ms of the Heston exotic kernel and its plain version at the
    path's price, LR and bridge shapes (prng; the bridge draws hash). Not
    counted as main path."""
    out = {}
    n, m = HX_MAIN
    for tag, kind, lr, sampler, shape in (
            (f"asian_arith {n}x{m}", "asian_arith", False, "prng", HX_MAIN),
            (f"barrier LR {n}x{m}", "barrier_up-and-out", True, "prng", HX_MAIN),
            (f"asian_arith sobol_bb {HX_QMC[0]}x{HX_QMC[1]}", "asian_arith", False, "sobol_bb",
             HX_QMC)):
        params, book = hx_inputs(kind, shape[1], dev)
        kw = dict(kind=kind, n_steps=shape[1], n_blocks=hx._n_blocks(shape[0], hx.PATHS_PER_BLOCK),
                  cp=1.0, sampler=sampler, lr=lr)
        ms, plain_ms = event_pair(lambda: hx._heston_exotic_cuda(0, 0, params, book, **kw),
                                  lambda: hx._heston_exotic_plain(0, 0, params, book, **kw))
        out[tag] = {"ms": ms, "plain_ms": plain_ms,
                    "trips": kw["n_blocks"] * hx.ROWS * hx.LANES * shape[1],
                    "bytes": 4 * (params.numel() + 7 + hx._n_moments(kind, lr) * hx.ROWS),
                    "steps": shape[1]}
    return out


# mangled-name parts and MUFU.RSQ per step trip (the Box–Muller root and one
# sqrtf(v⁺) per branch; the bridge: a pre-pass and a replay loop per step)
HX_SASS = {"asian_arith 8": (("heston_exotic_kernelILi0ELb0ELi0ELi0E",), nest((3, 1))),
           "barrier LR": (("heston_exotic_kernelILi3ELb1ELi0ELi0E",), nest((3, 1))),
           "asian_arith sobol_bb": (("heston_exotic_kernelILi0ELb0ELi0ELi2E",),
                                    nest(((1, 3), 1)))}


# ---------------------------------------------------------------------------
# the smile path: local vol and SLV (csrc/local_vol_mc.cu, csrc/slv_mc.cu)
# ---------------------------------------------------------------------------
LV_MAIN = (8_000_000, 100)  # bench.py:297: 31 blocks, 8,126,464 paths
SLV_MAIN = (8_000_000, 64)  # bench.py:313: 62 blocks, 8,126,464 paths
SLV_PARAMS = (0.04, 2.0, 0.04, 0.5, -0.7)  # the bench's HestonParams.make
SLV_CAL = 262_144  # the calibration's particles (SLVKernelPricer's default)
SMILE_SCAN = 1_048_576  # the scan engines' paths
# the rho oracle's regime: σ_v = 0.3 (Feller holds), as the reference test, at
# the path's 64 steps (the reference's 16 steps leave the gated score a bias
# of ≈1.2 in ρ, inside its bound at 131,072 paths but not at 8M)
SLV_RHO_STEPS = 64
LV_CP_PAYOFFS = ("european", "asian", "lookback_float", "lookback_fixed",
                 "barrier_up-and-out", "barrier_up-and-in", "barrier_down-and-out",
                 "barrier_down-and-in", "barrier_double-out", "barrier_double-in")
SLV_CP_KINDS = ("european", "asian_arith", "asian_geo") + LV_CP_PAYOFFS[2:]
SLV_SLOTS = {"cliquet": (-0.03, 0.03, 0.0, 1e9, 100.0),
             "autocall": (0.0, math.log(0.9), math.log(0.8), 2.0, 100.0),
             "range_accrual": (math.log(0.9), math.log(1.1), 0.0, 0.0, 100.0)}


def smile_dupire(dev, flat: bool = False):
    iv = (lambda k, t: 0.2 + 0.0 * k) if flat else lvm.sample_smile_iv_fn()
    return lvm.DupireLocalVol(iv, S0, RATE, device=dev)


def slv_params(dev, **over):
    return hmodel.HestonParams.make(**dict(zip(H_NAMES, SLV_PARAMS), **over), device=dev)


def _level(kind):
    return 120.0 if "up" in kind else 85.0


def lv_parity_cases(dev) -> list:
    """(tag, params, kwargs) of the local-vol parity phase."""
    pricer = lk.LocalVolKernelPricer(smile_dupire(dev), T, n_steps=12)
    cases = []
    for payoff in lk.PAYOFFS:
        p = pricer._params(STRIKE, payoff, _level(payoff), 85.0, 118.0)
        for sampler in ("hash", "prng"):
            for greeks in (False, True):
                for cp in ((1.0, -1.0) if payoff in LV_CP_PAYOFFS else (1.0,)):
                    cases.append((f"{payoff} {sampler} greeks={greeks} cp={cp:+.0f} 3x12", p,
                                  dict(n_steps=12, n_blocks=3, cp=cp, payoff=payoff,
                                       sampler=sampler, greeks=greeks)))
        cases.append((f"{payoff} sobol_bb 3x12", p, dict(n_steps=12, n_blocks=3, cp=1.0,
                                                          payoff=payoff, sampler="sobol_bb")))
    main = lk.LocalVolKernelPricer(smile_dupire(dev), T, n_steps=LV_MAIN[1])
    nb = lk._n_blocks(LV_MAIN[0], lk.PATHS_PER_BLOCK)
    for payoff, greeks, sampler in (("european", False, "prng"), ("barrier_up-and-out", True, "prng"),
                                    ("asian", False, "sobol_bb")):
        cases.append((f"{payoff} {sampler} greeks={greeks} {LV_MAIN[0]}x{LV_MAIN[1]}",
                       main._params(STRIKE, payoff, 125.0),
                       dict(n_steps=LV_MAIN[1], n_blocks=nb, cp=1.0, payoff=payoff,
                            sampler=sampler, greeks=greeks)))
    return cases


def slv_vector(pricer, kind):
    if kind in SLV_SLOTS:
        head = pricer._head.copy()
        head[sk._S_A:sk._S_E + 1] = SLV_SLOTS[kind]
        return pricer._vector(head)
    return pricer._params_vec(kind, STRIKE, _level(kind), 85.0, 118.0)


def slv_parity_cases(dev) -> list:
    """(tag, params, kwargs) of the SLV parity phase (each pricer calibrates
    on the card; the kernel and its plain version replay the same table)."""
    small = sk.SLVKernelPricer(smile_dupire(dev), slv_params(dev), T, n_steps=12,
                               n_cal_paths=65_536)
    cases = []
    for kind in sk.KINDS + sk.STRUCTURED_KINDS:
        p = slv_vector(small, kind)
        for sampler in ("hash", "prng"):
            for lr in (False, True):
                for cp in ((1.0, -1.0) if kind in SLV_CP_KINDS else (1.0,)):
                    cases.append((f"{kind} {sampler} lr={lr} cp={cp:+.0f} 3x12", p,
                                  dict(kind=kind, n_steps=12, n_blocks=3, cp=cp, sampler=sampler,
                                       lr=lr, period=3 if kind in ("cliquet", "autocall") else 1)))
    main = sk.SLVKernelPricer(smile_dupire(dev), slv_params(dev), T, n_steps=SLV_MAIN[1],
                              n_cal_paths=65_536)
    nb = sk._n_blocks(SLV_MAIN[0], sk.PATHS_PER_BLOCK)
    for kind, lr in (("barrier_up-and-out", False), ("barrier_up-and-out", True),
                     ("autocall", True)):
        cases.append((f"{kind} prng lr={lr} {SLV_MAIN[0]}x{SLV_MAIN[1]}", slv_vector(main, kind),
                      dict(kind=kind, n_steps=SLV_MAIN[1], n_blocks=nb, cp=1.0, sampler="prng",
                           lr=lr, period=16 if kind == "autocall" else 1)))
    return cases


def phase_smile_parity(dev) -> tuple[float, float]:
    """Both smile kernels against their plain versions; returns their largest
    absolute differences."""
    worst_lv = worst_slv = 0.0
    for tag, p, kw in lv_parity_cases(dev):
        kern, plain = lk._lv_cuda(7, 1, p, **kw), lk._lv_plain(7, 1, p, **kw)
        torch.cuda.synchronize()
        worst_lv = max(worst_lv, compare_sums(kern, plain, f"local_vol {tag}"))
    for tag, p, kw in slv_parity_cases(dev):
        kern, plain = sk._slv_cuda(7, 1, p, **kw), sk._slv_plain(7, 1, p, **kw)
        torch.cuda.synchronize()
        worst_slv = max(worst_slv, compare_sums(kern, plain, f"slv {tag}"))
    return worst_lv, worst_slv


def _row_se(combine, outs, n_row, keys) -> dict:
    """Standard errors of a ladder's entries from the 128 independent row
    groups of one launch."""
    per = [combine(outs[:, r:r + 1], n_row) for r in range(outs.shape[1])]
    return {k: float(np.std([float(g[k]) for g in per], ddof=1)) / math.sqrt(len(per))
            for k in keys}


def smile_greek_stderrs(dev) -> dict:
    """Row-group standard errors of the Greeks checked below, each from one
    launch at the path's shape (another seed than the main path's). Not
    counted as main path."""
    out = {}
    lv_n, lv_m = LV_MAIN
    nb = lk._n_blocks(lv_n, lk.PATHS_PER_BLOCK)
    for tag, dup, payoff in (("flat", smile_dupire(dev, flat=True), "european"),
                             ("smile asian", smile_dupire(dev), "asian"),
                             ("smile barrier", smile_dupire(dev), "barrier_up-and-out")):
        pr = lk.LocalVolKernelPricer(dup, T, n_steps=lv_m)
        outs = lk._lv_cuda(99, 0, pr._params(STRIKE, payoff, 120.0), n_steps=lv_m, n_blocks=nb,
                           cp=1.0, payoff=payoff, greeks=True).double()
        se = _row_se(lambda o, n: pr._combine_greeks(o, n, payoff), outs,
                     nb * lk.LANES * 4, ("delta", "gamma", "vega"))
        out.update({(f"lv {tag}", k): v for k, v in se.items()})
    s_n, s_m = SLV_MAIN
    nb = sk._n_blocks(s_n, sk.PATHS_PER_BLOCK)
    pr = sk.SLVKernelPricer(smile_dupire(dev), slv_params(dev), T, n_steps=s_m,
                            n_cal_paths=65_536)
    rho_pr = sk.SLVKernelPricer(smile_dupire(dev), slv_params(dev, sigma=0.3), T,
                                n_steps=SLV_RHO_STEPS, n_cal_paths=65_536)
    for tag, kind, pr_, m_ in (("barrier_up-and-out", "barrier_up-and-out", pr, s_m),
                               ("asian_arith", "asian_arith", pr, s_m),
                               ("rho", "european", rho_pr, SLV_RHO_STEPS)):
        outs = sk._slv_cuda(99, 0, slv_vector(pr_, kind), kind=kind, n_steps=m_, n_blocks=nb,
                            cp=1.0, lr=True).double()
        se = _row_se(lambda o, n, pr_=pr_, kind=kind: pr_._combine_lr(o, n, kind), outs,
                     nb * sk.LANES * 2, ("delta", "vega_v0", "rho"))
        out.update({(f"slv {tag}", k): v for k, v in se.items()})
    log("smile", "Greek stderrs from 128 row groups: " + " ".join(
        f"{t}:{k}={v:.2e}" for (t, k), v in out.items()))
    return out


def fd_check(tag: str, got: float, want: float, ref_bound: float, ref_paths: int, paths: int,
             se: float) -> str:
    """LR Greek against its CRN finite difference, within max(the
    reference test's bound scaled by √(paths ratio), 5·se)."""
    bound = max(ref_bound * math.sqrt(ref_paths / paths), 5 * se)
    check(abs(got - want) < bound, f"{tag}: LR {got} vs CRN FD {want} (bound {bound})")
    return f"{tag}={got:.5f}/{want:.5f} (bound {bound:.4f})"


def route_counter(calls: dict, name: str):
    """A caller of entry points that counts its calls in ``calls[name]``:
    each is one launch of that kernel."""
    def k(fn, *a, **kw):
        calls[name] += 1
        return fn(*a, **kw)

    return k


def phase_lv_main(dev, card: str, se: dict, calls: dict) -> None:
    """The local-vol path through ``LocalVolKernelPricer`` at the JAX
    package's bench size, against its oracles; ``calls["lv"]`` counts the
    calls routed to the kernel."""
    k = route_counter(calls, "lv")
    walls = []

    n, m = LV_MAIN
    df = math.exp(-RATE * T)
    dup = smile_dupire(dev)
    t0 = time.perf_counter()
    pricer = lk.LocalVolKernelPricer(dup, T, n_steps=m)
    fit_ms = (time.perf_counter() - t0) * 1e3
    (p, se_p, paths), ms = timed(lambda: k(pricer.price, STRIKE, n_paths=n))
    walls.append(f"price european {paths}x{m} {ms:.3f} ms ({paths * m / (ms / 1e3):.4e} "
                 f"path-steps/s); Dupire build + table fit {fit_ms:.1f} ms")
    # the vanilla against the local-vol PDE (201 x 200), on the CPU
    pde = dup.to("cpu").price(S0, STRIKE, T).item()
    log("smile", f"LV european {p.item():.6f}±{se_p.item():.2e} ({paths} x {m}, fit residual "
                 f"{pricer.fit_residual:.2e}) vs PDE {pde:.6f}")
    check(abs(p.item() - pde) < 4 * se_p.item() + 0.03, "LV european vs the Dupire PDE")
    # a flat surface against Black–Scholes, price and Greeks
    flat = lk.LocalVolKernelPricer(smile_dupire(dev, flat=True), T, n_steps=m)
    g = k(flat.greeks, STRIKE, n_paths=n)
    bs = bs_greeks(S0, STRIKE, T, RATE, VOL, 1.0, 0.0)
    rows = [fd_check("flat delta", g["delta"], bs["delta"].item(), 0.02, 262_144, g["paths"],
                     se[("lv flat", "delta")]),
            fd_check("flat gamma", g["gamma"], bs["gamma"].item(), 0.004, 262_144, g["paths"],
                     se[("lv flat", "gamma")]),
            fd_check("flat vega", g["vega"], bs["vega"].item(), 2.5, 262_144, g["paths"],
                     se[("lv flat", "vega")])]
    check(abs(g["price"].item() - BS_ATM_CALL) < 4 * g["std_error"].item() + 2e-3,
          "flat LV price vs Black–Scholes")
    log("smile", f"flat LV {g['price'].item():.6f}±{g['std_error'].item():.2e} vs BS "
                 f"{BS_ATM_CALL:.6f}; Greeks vs BS: " + " ".join(rows))
    # the Asian against the scan engine (the bilinear surface itself)
    (pa, sea, _), ms = timed(lambda: k(pricer.price, STRIKE, payoff="asian", n_paths=n))
    walls.append(f"asian {paths}x{m} {ms:.3f} ms")
    sp, sse = lvm.local_vol_mc_price(dup, STRIKE, T, payoff="asian", n_paths=SMILE_SCAN,
                                     n_steps=m, seed=5)
    tol = 5 * math.hypot(sea.item(), sse.item()) + 5e-3  # the reference test's allowance
    log("smile", f"LV asian {pa.item():.6f}±{sea.item():.2e} vs scan {sp.item():.6f}±"
                 f"{sse.item():.2e} tol {tol:.2e}")
    check(abs(pa.item() - sp.item()) < tol, "LV asian vs the scan engine")
    # exact identities on one seed
    kw = dict(n_paths=n, seed=3, barrier=125.0)
    van = k(pricer.price, STRIKE, **kw)[0].item()
    p_in = k(pricer.price, STRIKE, payoff="barrier_up-and-in", **kw)[0].item()
    (p_out, se_out, _), ms = timed(lambda: k(pricer.price, STRIKE, payoff="barrier_up-and-out",
                                             **kw))
    walls.append(f"barrier_up-and-out {paths}x{m} {ms:.3f} ms")
    one = k(pricer.price, 0.0, payoff="one_touch_up", **kw)[0].item()
    no = k(pricer.price, 0.0, payoff="no_touch_up", **kw)[0].item()
    log("smile", f"LV identities: in+out={p_in + p_out.item():.7f} vanilla={van:.7f}; "
                 f"one+no touch={one + no:.8f} df={df:.8f}")
    check(abs(p_in + p_out.item() - van) < 1e-5 * van, "LV in + out != vanilla")
    check(abs(one + no - df) < 1e-6, "LV one-touch + no-touch != df")
    # flat barrier and lookback against the GBM exotic kernel at the same steps
    for payoff, kind, bkw in (("barrier_up-and-out", "barrier_up-and-out", dict(barrier=125.0)),
                              ("lookback_float", "lookback_float", {})):
        fp, fse, _ = k(flat.price, STRIKE, payoff=payoff, n_paths=n, **bkw)
        gp, gse, _ = ek.exotic_price(kind, S0, STRIKE, T, RATE, VOL, n_paths=n, n_steps=m,
                                     seed=11, device=dev, **bkw)
        log("smile", f"flat LV {payoff} {fp.item():.6f}±{fse.item():.2e} vs GBM exotic kernel "
                     f"{gp.item():.6f}±{gse.item():.2e}")
        check(abs(fp.item() - gp.item()) < 5 * math.hypot(fse.item(), gse.item()),
              f"flat LV {payoff} vs the GBM exotic kernel")
    # the smile's sticky-strike delta (table refitted at the bumped spot from
    # the same physical surface) and the c0-shift vega, against CRN FD
    rows = []
    for tag, payoff, bkw in (("smile asian", "asian", {}),
                             ("smile barrier", "barrier_up-and-out", dict(barrier=120.0))):
        g = k(pricer.greeks, STRIKE, payoff=payoff, n_paths=n, **bkw)

        def bumped(h):
            view = type("Bumped", (), {"surface": dup.surface, "spot": S0 + h, "rate": RATE,
                                       "dividend": 0.0})()
            pr = lk.LocalVolKernelPricer(view, T, n_steps=m)
            return k(pr.price, STRIKE, payoff=payoff, n_paths=n, **bkw)[0].item()

        fd = (bumped(0.5) - bumped(-0.5)) / 1.0
        rows.append(fd_check(f"{tag} delta", g["delta"], fd, 0.03, 262_144, g["paths"],
                             se[(f"lv {tag}", "delta")]))
        if payoff == "asian":
            eps = 2e-3
            shifted = []
            for sgn in (1.0, -1.0):
                rows_b = pricer.rows.copy()
                rows_b[:, -1] += sgn * eps
                pr = lk.LocalVolKernelPricer.from_numpy(rows_b, pricer.fit_residual, S0, RATE,
                                                        0.0, T, device=dev)
                shifted.append(k(pr.price, STRIKE, payoff=payoff, n_paths=n)[0].item())
            fd_v = (shifted[0] - shifted[1]) / (2 * eps)
            rows.append(fd_check(f"{tag} vega", g["vega"], fd_v, 0.08 * abs(fd_v) + 1.5,
                                 262_144, g["paths"], se[(f"lv {tag}", "vega")]))
    log("smile", f"LV smile Greeks vs CRN FD ({n} paths x {m}), bounds max(reference bound x "
                 f"sqrt(paths ratio), 5 se): " + " ".join(rows))
    # bridge QMC: the randomized-QMC stderr below the prng one
    (pq, seq, _), ms = timed(lambda: k(pricer.price, STRIKE, n_paths=n, sampler="sobol_bb"))
    walls.append(f"european sobol_bb {paths}x{m} {ms:.3f} ms")
    log("smile", f"LV sobol_bb {pq.item():.6f} RQMC se {seq.item():.2e} vs prng "
                 f"{p.item():.6f}±{se_p.item():.2e}")
    check(seq.item() < se_p.item(), "LV sobol_bb stderr not below prng")
    check(abs(pq.item() - p.item()) < 5 * math.hypot(seq.item(), se_p.item()),
          "LV sobol_bb vs prng")
    log("smile", f"LV warm wall, mean of 3 [{card}]: " + "; ".join(walls))


def phase_slv_main(dev, card: str, se: dict, calls: dict) -> None:
    """The SLV path at the JAX package's bench size: the 262,144-particle
    calibration on the card, then the barrier 8,126,464 x 64, against its
    oracles; ``calls["slv"]`` (and ``calls["lv"]`` for the LV vanilla it is
    held to) count the calls routed to the kernels."""
    k, k_lv = route_counter(calls, "slv"), route_counter(calls, "lv")
    walls = []

    n, m = SLV_MAIN
    dup = smile_dupire(dev)
    par = slv_params(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pricer = sk.SLVKernelPricer(dup, par, T, mixing=1.0, n_steps=m)
    torch.cuda.synchronize()
    cal_ms = (time.perf_counter() - t0) * 1e3
    kw = dict(barrier=125.0, n_paths=n)
    (pb, seb, paths), ms = timed(lambda: k(pricer.price, "barrier_up-and-out", STRIKE, **kw))
    walls.append(f"calibration {SLV_CAL} particles x {m} + fit {cal_ms:.1f} ms; barrier "
                 f"{paths}x{m} {ms:.3f} ms ({paths * m / (ms / 1e3):.4e} path-steps/s)")
    log("smile", f"SLV barrier_up-and-out {pb.item():.6f}±{seb.item():.2e} (fit residual "
                 f"{pricer.fit_residual:.2e})")
    # the same rows replayed by the scan engine
    rp, rse = slvm.slv_replay_price("barrier_up-and-out", S0, STRIKE, T, RATE, par,
                                    torch.Generator(device=dev).manual_seed(7), pricer.x_rows,
                                    pricer.l_rows, barrier=125.0, n_paths=SMILE_SCAN, n_steps=m,
                                    return_stderr=True)
    tol = 5 * math.hypot(seb.item(), rse.item()) + 0.02
    log("smile", f"SLV barrier vs replay scan {rp.item():.6f}±{rse.item():.2e} tol {tol:.2e}")
    check(abs(pb.item() - rp.item()) < tol, "SLV kernel vs slv_replay_price on the same rows")
    # vanillas pinned to the smile at every mixing; mixing moves the barrier
    pde = dup.to("cpu").price(S0, STRIKE, T).item()
    lv_p, lv_se, _ = k_lv(lk.LocalVolKernelPricer(dup, T, n_steps=m).price, STRIKE, n_paths=n)
    barriers = {}
    for mixing in (0.0, 0.5, 1.0):
        pr = pricer if mixing == 1.0 else sk.SLVKernelPricer(dup, par, T, mixing=mixing,
                                                             n_steps=m)
        pe, pse, _ = k(pr.price, "european", STRIKE, n_paths=n, seed=1)
        barriers[mixing] = k(pr.price, "barrier_up-and-out", STRIKE, **kw)[:2]
        tol = 5 * pse.item() + 0.05
        log("smile", f"SLV mixing {mixing}: european {pe.item():.6f}±{pse.item():.2e} vs PDE "
                     f"{pde:.6f} and LV kernel {lv_p.item():.6f} (tol {tol:.3f}); barrier "
                     f"{barriers[mixing][0].item():.6f}")
        check(abs(pe.item() - pde) < tol, f"SLV european at mixing {mixing} vs the PDE")
        check(abs(pe.item() - lv_p.item()) < tol + 5 * lv_se.item(),
              f"SLV european at mixing {mixing} vs the LV kernel")
    (b1, s1), (b0, s0) = barriers[1.0], barriers[0.0]
    check(b1.item() - b0.item() > 8 * math.hypot(s1.item(), s0.item()),
          "mixing does not move the barrier")
    # the LR ladder against CRN finite differences on frozen leverage
    rows = []
    for kind in ("barrier_up-and-out", "asian_arith"):
        bkw = dict(barrier=125.0) if kind.startswith("barrier") else {}
        g = k(pricer.greeks, kind, STRIKE, n_paths=n, **bkw)
        check(abs(g["price"].item() - k(pricer.price, kind, STRIKE, n_paths=n, **bkw)[0].item())
              < 1e-5 * g["price"].item() + 1e-6, f"SLV {kind}: LR price != price launch")

        def bumped_spot(h):
            rows_b, _ = sk.fit_leverage_polys(pricer.x_rows - math.log((S0 + h) / S0),
                                              pricer.l_rows)
            pr = sk.SLVKernelPricer.from_numpy(rows_b, 0.0, par, S0 + h, RATE, 0.0, T, device=dev)
            return k(pr.price, kind, STRIKE, n_paths=n, **bkw)[0].item()

        fd = bumped_spot(0.5) - bumped_spot(-0.5)
        rows.append(fd_check(f"{kind} delta", g["delta"], fd, 0.035, 131_072, g["paths"],
                             se[(f"slv {kind}", "delta")]))
        if kind == "asian_arith":
            vals = []
            for sgn in (1.0, -1.0):
                pr = sk.SLVKernelPricer.from_numpy(pricer.rows, 0.0,
                                                   slv_params(dev, v0=0.04 + sgn * 0.004), S0,
                                                   RATE, 0.0, T, device=dev)
                vals.append(k(pr.price, kind, STRIKE, n_paths=n)[0].item())
            fd_v = (vals[0] - vals[1]) / 0.008
            rows.append(fd_check(f"{kind} vega_v0", g["vega_v0"], fd_v, 0.12 * abs(fd_v) + 1.0,
                                 131_072, g["paths"], se[(f"slv {kind}", "vega_v0")]))
    # rho with σ_v = 0.3 (Feller holds), as the reference test
    par3 = slv_params(dev, sigma=0.3)
    base = sk.SLVKernelPricer(dup, par3, T, mixing=1.0, n_steps=SLV_RHO_STEPS)
    g = k(base.greeks, "european", STRIKE, n_paths=n)
    vals = []
    for sgn in (1.0, -1.0):
        pr = sk.SLVKernelPricer.from_numpy(base.rows, 0.0, par3, S0, RATE + sgn * 1e-3, 0.0, T,
                                           device=dev)
        vals.append(k(pr.price, "european", STRIKE, n_paths=n)[0].item())
    fd_r = (vals[0] - vals[1]) / 2e-3
    rows.append(fd_check(f"european rho (σ_v 0.3, {SLV_RHO_STEPS} steps)", g["rho"], fd_r,
                         0.06 * abs(fd_r) + 0.5, 131_072, g["paths"], se[("slv rho", "rho")]))
    log("smile", f"SLV LR vs CRN FD ({n} paths), bounds max(reference bound x sqrt(paths "
                 f"ratio), 5 se): " + " ".join(rows))
    # the structured products, price and LR, against the scan engines
    gen = torch.Generator(device=dev)
    # the reference tests' allowances (tests/test_slv_pallas.py)
    for name, skw, args, extra in (("cliquet", dict(n_periods=4), (), 0.05),
                                   ("autocall", dict(n_obs=4), (), 0.1),
                                   ("range_accrual", {}, (90.0, 110.0), 0.2)):
        (pk, pse, paths_s), ms = timed(lambda: k(getattr(pricer, name), *args, n_paths=n, **skw))
        walls.append(f"{name} {paths_s}x{m} {ms:.3f} ms")
        g = k(getattr(pricer, name), *args, n_paths=n, greeks=True, **skw)
        check(abs(g["price"].item() - pk.item()) < 1e-5 * abs(pk.item()) + 1e-6,
              f"SLV {name}: LR price != price launch")
        check(all(math.isfinite(float(g[key])) for key in ("delta", "gamma", "vega_v0", "rho")),
              f"SLV {name} LR ladder not finite")
        scan_args = (S0, 90.0, 110.0, T, RATE) if name == "range_accrual" else (S0, T, RATE)
        sp, sse = getattr(slvm, f"slv_{name}_price")(
            *scan_args, par, gen.manual_seed(9), dup.surface.k_grid, dup.surface.t_grid,
            dup.surface.grid, n_paths=SMILE_SCAN, n_steps=m, return_stderr=True, **skw)
        tol = 5 * math.hypot(pse.item(), sse.item()) + extra
        log("smile", f"SLV {name} {pk.item():.6f}±{pse.item():.2e} vs scan {sp.item():.6f}±"
                     f"{sse.item():.2e} (tol {tol:.3f}); LR delta {g['delta']:.5f} vega_v0 "
                     f"{g['vega_v0']:.5f} rho {g['rho']:.5f}")
        check(abs(pk.item() - sp.item()) < tol, f"SLV {name} vs the scan engine")
    log("smile", f"SLV warm wall, mean of 3 [{card}]: " + "; ".join(walls))


def phase_smile_server(dev) -> tuple[int, int]:
    """``/exotic`` lv and slv over a socket. Returns the requests routed to
    the local-vol and the SLV kernel."""
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    routed = [0, 0]
    try:
        for body, route in (({"model": "lv", "kind": "barrier", "barrier": 125.0}, 0),
                            ({"model": "lv", "kind": "asian", "greeks": True}, 0),
                            ({"model": "lv", "kind": "cliquet", "n_paths": 262_144}, None),
                            ({"model": "slv", "kind": "autocallable", "greeks": True}, 1),
                            ({"model": "slv", "kind": "barrier", "greeks": True,
                              "barrier": 125.0}, 1),
                            ({"model": "slv", "kind": "asian", "n_paths": 262_144}, None)):
            status, out = _request(base + "/exotic", {"n_paths": 2_000_000, "n_steps": 64,
                                                      **body})
            if route is not None:
                routed[route] += 1
            check(status == 200 and math.isfinite(out["price"]) and out["std_error"] > 0,
                  f"/exotic {body}: {status} {out}")
            log("smile server", f"/exotic {body['model']} {out['kind']}: "
                                f"price={out['price']:.5f} se={out['std_error']:.2e} "
                                f"engine={out.get('engine', 'scan')}")
    finally:
        server.stop()
    return routed[0], routed[1]


def smile_timing(dev) -> dict:
    """Device ms of both smile kernels and their plain versions at the
    paths' shapes (prng). Not counted as main path."""
    out = {}
    n, m = LV_MAIN
    pricer = lk.LocalVolKernelPricer(smile_dupire(dev), T, n_steps=m)
    for tag, payoff, greeks in ((f"local_vol european {n}x{m}", "european", False),
                                (f"local_vol barrier greeks {n}x{m}", "barrier_up-and-out",
                                 True)):
        p = pricer._params(STRIKE, payoff, 125.0)
        kw = dict(n_steps=m, n_blocks=lk._n_blocks(n, lk.PATHS_PER_BLOCK), cp=1.0, payoff=payoff,
                  sampler="prng", greeks=greeks)
        ms, plain_ms = event_pair(lambda: lk._lv_cuda(0, 0, p, **kw),
                                  lambda: lk._lv_plain(0, 0, p, **kw))
        out[tag] = {"ms": ms, "plain_ms": plain_ms,
                    "trips": kw["n_blocks"] * lk.ROWS * lk.LANES * m,
                    "bytes": 4 * (p.numel() + lk._n_moments(payoff, greeks) * lk.ROWS),
                    "steps": m}
    n, m = SLV_MAIN
    spr = sk.SLVKernelPricer(smile_dupire(dev), slv_params(dev), T, n_steps=m,
                             n_cal_paths=65_536)
    for tag, lr in ((f"slv barrier {n}x{m}", False), (f"slv barrier LR {n}x{m}", True)):
        p = slv_vector(spr, "barrier_up-and-out")
        kw = dict(kind="barrier_up-and-out", n_steps=m, n_blocks=sk._n_blocks(n, sk.PATHS_PER_BLOCK),
                  cp=1.0, sampler="prng", lr=lr)
        ms, plain_ms = event_pair(lambda: sk._slv_cuda(0, 0, p, **kw),
                                  lambda: sk._slv_plain(0, 0, p, **kw))
        out[tag] = {"ms": ms, "plain_ms": plain_ms,
                    "trips": kw["n_blocks"] * sk.ROWS * sk.LANES * m,
                    "bytes": 4 * (p.numel() + sk._n_moments("barrier_up-and-out", lr) * sk.ROWS),
                    "steps": m}
    return out


# mangled-name parts and MUFU.RSQ per step trip: the Box–Muller root (local
# vol: σ has no root); SLV: and one sqrtf(v⁺) per branch
SMILE_SASS = {"local_vol european": (("local_vol_kernelILi0ELb0ELi0E",), nest((1, 1))),
              "local_vol barrier greeks": (("local_vol_kernelILi4ELb1ELi0E",), nest((1, 1))),
              "slv barrier LR": (("slv_kernelILi3ELb1ELi0E",), nest((3, 1))),
              "slv barrier": (("slv_kernelILi3ELb0ELi0E",), nest((3, 1)))}


# ---------------------------------------------------------------------------
# the multi-asset path (csrc/multi_asset_mc.cu)
# ---------------------------------------------------------------------------
# the JAX package's bench.py:366-404: 3 assets, basket Asian 4M x 252 (price)
# and 4M x 64 (the full LR ladder); the terminal kinds at 4M x 1
MA_SPOTS = [100.0, 95.0, 105.0]
MA_VOLS = [0.2, 0.25, 0.3]
MA_CORR = [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]
MA_W = [0.4, 0.3, 0.3]
MA_PRICE = (4_000_000, 252)  # 31 blocks: 4,063,232 paths
MA_LADDER = (4_000_000, 64)
MA_TERMINAL = (4_000_000, 1)
MA_SCAN = 1_048_576  # the scan engine's paths
MA_REF_PATHS = mk.PATHS_PER_BLOCK  # the reference tests' one block (n_paths=4)
MA_RTOL = 1e-6  # kernel vs plain per row: the paths are bitwise, the sums' order differs
# the launch plan's edges (path blocks, steps): 1, 8 and 13 chunks of one
# path block a row (the most a short launch leaves at one a thread), 7 of 2,
# 8 of 4, 9 of 4 with a last chunk of 1, 65 of 4
MA_PLAN_EDGES = ((1, 1), (8, 2), (13, 1), (14, 1), (31, 6), (33, 1), (257, 2))
MA_ARGS = (MA_SPOTS, STRIKE, T, RATE, MA_VOLS, MA_CORR)
MA_D4 = ([100.0, 95.0, 105.0, 98.0], [0.2, 0.25, 0.3, 0.22],
         [[1.0, 0.5, 0.3, 0.2], [0.5, 1.0, 0.4, 0.1], [0.3, 0.4, 1.0, 0.25],
          [0.2, 0.1, 0.25, 1.0]], [0.3, 0.3, 0.2, 0.2])


def ma_vector(d, kind, n_steps, lr, dev, strike=STRIKE):
    spots, vols, corr, w = MA_D4
    if d == 3:
        spots, vols, corr, w = MA_SPOTS, MA_VOLS, MA_CORR, MA_W
    corr = [row[:d] for row in corr[:d]]
    p = mk._params_vec(spots[:d], w[:d] if d > 2 else None, strike, T, RATE, vols[:d], corr,
                       0.0, n_steps, lr=lr, cv=kind == "basket_cv")[2]
    return torch.tensor(p, device=dev)


def ma_parity_cases(dev) -> list:
    """(tag, params, kwargs) of the multi-asset parity phase: every kind ×
    lr × d ∈ {2, 3, 4} × hash/prng × cp ±1 at 2 blocks (the Asian at 6
    steps), sobol on the terminal kinds, basket_cv, the launch plan's edges
    and the path's shapes."""
    cases = []
    for d in (2, 3, 4):
        for kind in mk.KINDS:
            if kind == "spread" and d != 2:
                continue
            n_steps = 6 if kind == "basket_asian" else 1
            samplers = ("hash", "prng") if kind == "basket_asian" else ("hash", "prng", "sobol")
            for lr in ((False,) if kind == "basket_cv" else (False, True)):
                p = ma_vector(d, kind, n_steps, lr, dev, 0.0 if kind == "spread" else STRIKE)
                for sampler in samplers:
                    for cp in (1.0, -1.0):
                        cases.append((f"{kind} d={d} {sampler} lr={lr} cp={cp:+.0f} 2x{n_steps}",
                                      p, dict(d=d, kind=kind, n_steps=n_steps, n_blocks=2,
                                              cp=cp, sampler=sampler, lr=lr)))
    for nb, m in MA_PLAN_EDGES:
        p = ma_vector(3, "basket_geo", m, True, dev)
        cases.append((f"basket_geo d=3 prng lr=True {nb} blocks x{m}", p,
                      dict(d=3, kind="basket_geo", n_steps=m, n_blocks=nb, cp=1.0,
                           sampler="prng", lr=True)))
    for kind, (n, m), lr, sampler in (("basket_asian", MA_PRICE, False, "prng"),
                                      ("basket_asian", MA_LADDER, True, "prng"),
                                      ("basket_geo", MA_TERMINAL, True, "prng"),
                                      ("basket_geo", MA_TERMINAL, True, "sobol"),
                                      ("basket_cv", MA_TERMINAL, False, "prng")):
        cases.append((f"{kind} d=3 {sampler} lr={lr} {n}x{m}", ma_vector(3, kind, m, lr, dev),
                      dict(d=3, kind=kind, n_steps=m, n_blocks=mk._n_blocks(n, mk.PATHS_PER_BLOCK),
                           cp=1.0, sampler=sampler, lr=lr)))
    return cases


def phase_ma_parity(dev) -> float:
    """The multi-asset kernel against its plain version, per row within
    MA_RTOL; returns the largest absolute difference."""
    worst = 0.0
    for tag, p, kw in ma_parity_cases(dev):
        kern, plain = mk._ma_cuda(7, 1, p, **kw).clone(), mk._ma_plain(7, 1, p, **kw)
        torch.cuda.synchronize()
        worst = max(worst, compare_sums(kern, plain, f"multi_asset {tag}", rtol=MA_RTOL))
        check(torch.equal(mk._ma_cuda(7, 1, p, **kw), kern),
              f"multi_asset {tag}: two launches differ")
    return worst


def ma_ladder(outs, n, n_steps):
    return mk._combine_lr(outs, n, 3, T, RATE, MA_SPOTS, MA_VOLS, MA_CORR, n_steps)


def ma_greek_stderrs(dev) -> dict:
    """Row-group standard errors of the ladders checked below, from one
    launch at each path shape (another seed than the main path's). Not
    counted as main path."""
    out = {}
    for tag, kind, (n, m) in (("asian", "basket_asian", MA_LADDER),
                              ("geo", "basket_geo", MA_TERMINAL)):
        nb = mk._n_blocks(n, mk.PATHS_PER_BLOCK)
        outs = mk._ma_cuda(99, 0, ma_vector(3, kind, m, True, dev), d=3, kind=kind, n_steps=m,
                           n_blocks=nb, cp=1.0, lr=True).double()
        n_row = nb * mk.LANES * 4
        per = [ma_ladder(outs[:, r:r + 1], n_row, m) for r in range(mk.ROWS)]
        for key in ("delta", "vega", "gamma", "theta", "rho"):
            vals = np.stack([np.asarray(g[key], np.float64) for g in per])
            out[(tag, key)] = vals.std(axis=0, ddof=1) / math.sqrt(len(per))
    log("multi_asset", "Greek stderrs from 128 row groups: " + " ".join(
        f"{t}:{k}={sci(v)}"
        for (t, k), v in out.items()))
    return out


SCI = {"float_kind": lambda x: f"{x:.3e}"}


def sci(x) -> str:
    """An array on one line, in scientific notation."""
    return np.array2string(np.asarray(x, np.float64).ravel(), formatter=SCI,
                           max_line_width=1 << 20)


def ma_fd_check(tag, got, want, ref_bound, se, paths) -> str:
    """Entries of an LR Greek against their oracle, within max(the reference
    test's bound scaled by √(paths ratio), 5·se) entrywise."""
    got, want, se = (np.asarray(x, np.float64) for x in (got, want, se))
    bound = np.maximum(ref_bound * math.sqrt(MA_REF_PATHS / paths), 5 * se)
    check(bool(np.all(np.abs(got - want) < bound)),
          f"multi_asset {tag}: LR {got} vs {want} (bound {bound})")
    return f"{tag}={sci(got)}/{sci(want)} (bound {sci(bound)})"


def phase_ma_main(dev, card: str, se: dict, calls: dict) -> None:
    """The multi-asset path through ``multi_asset_kernel_price`` and
    ``multi_asset_kernel_greeks`` at the JAX package's bench shapes, against
    its oracles; ``calls["ma"]`` counts the calls routed to the kernel."""
    k = route_counter(calls, "ma")
    kw = dict(weights=MA_W, device=dev)
    walls = []
    # the basket Asian 4M x 252 against the scan engine
    n, m = MA_PRICE
    (p, se_p, paths), ms = timed(lambda: k(mk.multi_asset_kernel_price, "basket_asian", *MA_ARGS,
                                           n_paths=n, n_steps=m, **kw))
    walls.append(f"basket_asian {paths}x{m} {ms:.3f} ms ({paths * m * 3 / (ms / 1e3):.4e} "
                 f"asset-steps/s)")
    gen = torch.Generator(device=dev).manual_seed(5)
    sp, sse = mam.basket_asian_price(MA_SPOTS, MA_W, STRIKE, T, RATE, MA_VOLS, MA_CORR, gen,
                                     n_paths=MA_SCAN, n_steps=m, return_stderr=True)
    tol = 5 * math.hypot(se_p.item(), sse.item()) + 2e-3
    log("multi_asset", f"basket_asian {p.item():.6f}±{se_p.item():.2e} ({paths} x {m}) vs scan "
                       f"{sp.item():.6f}±{sse.item():.2e} (tol {tol:.2e})")
    check(abs(p.item() - sp.item()) < tol, "basket_asian vs the scan engine")

    # the basket Asian ladder 4M x 64 against CRN finite differences of the
    # kernel price (same seed: the same normals)
    n, m = MA_LADDER
    g, ms = timed(lambda: k(mk.multi_asset_kernel_greeks, "basket_asian", *MA_ARGS, n_paths=n,
                            n_steps=m, seed=1, **kw))
    walls.append(f"basket_asian LR ladder {g['paths']}x{m} {ms:.3f} ms")

    def price(spots=MA_SPOTS, vols=MA_VOLS, t=T, r=RATE):
        return k(mk.multi_asset_kernel_price, "basket_asian", spots, STRIKE, t, r, vols,
                 MA_CORR, n_paths=n, n_steps=m, seed=1, **kw)[0].item()

    def bump(vec, i, h):
        out = list(vec)
        out[i] += h
        return out

    fd_delta = [(price(spots=bump(MA_SPOTS, i, 0.5)) - price(spots=bump(MA_SPOTS, i, -0.5)))
                for i in range(3)]
    fd_vega = [(price(vols=bump(MA_VOLS, i, 1e-3)) - price(vols=bump(MA_VOLS, i, -1e-3))) / 2e-3
               for i in range(3)]
    fd_theta = -(price(t=T + 1e-2) - price(t=T - 1e-2)) / 2e-2
    fd_rho = (price(r=RATE + 1e-2) - price(r=RATE - 1e-2)) / 2e-2
    pg = g["paths"]
    rows = [ma_fd_check("asian delta", g["delta"], fd_delta, 0.02, se[("asian", "delta")], pg),
            ma_fd_check("asian vega", g["vega"], fd_vega,
                        0.12 * np.abs(fd_vega) + 1.0, se[("asian", "vega")], pg),
            ma_fd_check("asian theta", g["theta"], fd_theta, 0.15, se[("asian", "theta")], pg),
            ma_fd_check("asian rho", g["rho"], fd_rho, 0.5, se[("asian", "rho")], pg)]
    log("multi_asset", f"basket_asian ladder vs CRN FD ({pg} paths x {m}), bounds max(reference "
                       f"bound x sqrt(paths ratio), 5 se): " + " ".join(rows))

    # the terminal kinds at 4M x 1
    n, m = MA_TERMINAL
    (pg_, se_g, _), ms = timed(lambda: k(mk.multi_asset_kernel_price, "basket_geo", *MA_ARGS,
                                         n_paths=n, **kw))
    walls.append(f"basket_geo {paths}x1 {ms:.3f} ms")
    s64 = torch.tensor(MA_SPOTS, dtype=torch.float64, requires_grad=True)
    v64 = torch.tensor(MA_VOLS, dtype=torch.float64, requires_grad=True)
    t64 = torch.tensor(T, dtype=torch.float64, requires_grad=True)
    r64 = torch.tensor(RATE, dtype=torch.float64, requires_grad=True)
    exact = mam.geometric_basket_closed_form(s64, MA_W, STRIKE, t64, r64, v64, MA_CORR)
    d_s, d_v, d_t, d_r = torch.autograd.grad(exact, (s64, v64, t64, r64), create_graph=True)
    hess = torch.stack([torch.autograd.grad(d_s[i], s64, retain_graph=True)[0]
                        for i in range(3)])
    log("multi_asset", f"basket_geo {pg_.item():.6f}±{se_g.item():.2e} vs closed form "
                       f"{exact.item():.6f}")
    check(abs(pg_.item() - exact.item()) < 5 * se_g.item(), "basket_geo vs its closed form")
    gl, ms = timed(lambda: k(mk.multi_asset_kernel_greeks, "basket_geo", *MA_ARGS, n_paths=n,
                             **kw))
    walls.append(f"basket_geo LR ladder {gl['paths']}x1 {ms:.3f} ms")
    pl = gl["paths"]
    rows = [ma_fd_check("geo delta", gl["delta"], d_s.detach(), 0.02, se[("geo", "delta")], pl),
            ma_fd_check("geo vega", gl["vega"], d_v.detach(), 1.6, se[("geo", "vega")], pl),
            ma_fd_check("geo gamma", gl["gamma"], hess.detach(), 1e-3, se[("geo", "gamma")], pl),
            ma_fd_check("geo theta", gl["theta"], -d_t.item(), 0.15, se[("geo", "theta")], pl),
            ma_fd_check("geo rho", gl["rho"], d_r.item(), 0.4, se[("geo", "rho")], pl)]
    check(bool(torch.equal(gl["gamma"], gl["gamma"].T)), "basket_geo gamma not symmetric")
    log("multi_asset", f"basket_geo ladder vs autograd of the closed form ({pl} paths), bounds "
                       f"max(reference bound x sqrt(paths ratio), 5 se): " + " ".join(rows))
    # spread K = 0 against Margrabe
    ps, se_s, _ = k(mk.multi_asset_kernel_price, "spread", [100.0, 95.0], 0.0, T, RATE,
                    [0.2, 0.25], [[1.0, 0.6], [0.6, 1.0]], n_paths=n, device=dev)
    marg = mam.margrabe_price(100.0, 95.0, T, 0.2, 0.25, 0.6).item()
    log("multi_asset", f"spread K=0 {ps.item():.6f}±{se_s.item():.2e} vs Margrabe {marg:.6f}")
    check(abs(ps.item() - marg) < 5 * se_s.item(), "spread K=0 vs Margrabe")
    # sobol: the pure QMC terminal law well inside the prng stderr
    (pq, se_q, _), ms = timed(lambda: k(mk.multi_asset_kernel_price, "basket_geo", *MA_ARGS,
                                        n_paths=n, sampler="sobol", **kw))
    walls.append(f"basket_geo sobol {paths}x1 {ms:.3f} ms")
    log("multi_asset", f"basket_geo sobol {pq.item():.6f} (RQMC se {se_q.item():.2e}) vs closed "
                       f"form {exact.item():.6f}, prng se {se_g.item():.2e}")
    check(abs(pq.item() - exact.item()) < 0.5 * se_g.item(), "sobol not well inside prng noise")
    check(se_q.item() < se_g.item(), "sobol RQMC stderr not below the prng stderr")
    # the geometric control variate: unbiased against plain, and tighter
    p_pl, se_pl, _ = k(mk.multi_asset_kernel_price, "basket", *MA_ARGS, n_paths=n, **kw)
    (p_cv, se_cv, _), ms = timed(lambda: k(mk.multi_asset_kernel_price, "basket", *MA_ARGS,
                                           n_paths=n, control_variate=True, **kw))
    walls.append(f"basket CV {paths}x1 {ms:.3f} ms")
    log("multi_asset", f"basket CV {p_cv.item():.6f}±{se_cv.item():.2e} vs plain "
                       f"{p_pl.item():.6f}±{se_pl.item():.2e} "
                       f"({se_pl.item() / se_cv.item():.1f}x tighter)")
    check(abs(p_cv.item() - p_pl.item()) < 4 * math.hypot(se_cv.item(), se_pl.item()),
          "basket CV vs plain")
    check(se_cv.item() < se_pl.item() / 4.0, "basket CV not 4x tighter")
    log("multi_asset", f"warm wall, mean of 3 [{card}]: " + "; ".join(walls))


def phase_ma_server(dev) -> int:
    """``/basket`` over a socket; returns the requests routed to the
    kernel."""
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    routed = 0
    try:
        for body in ({}, {"control_variate": True}, {"kind": "basket_geo", "sampler": "sobol"},
                     {"kind": "basket_asian", "n_steps": 64, "greeks": True},
                     {"kind": "spread", "spots": [100.0, 95.0], "vols": [0.2, 0.25],
                      "strike": 0.0, "greeks": True}):
            status, out = _request(base + "/basket", {"n_paths": 4_000_000, **body})
            routed += 1
            check(status == 200 and math.isfinite(out["price"]) and out["std_error"] > 0,
                  f"/basket {body}: {status} {out}")
            log("multi_asset server", f"/basket {out['kind']} {out['sampler']}: "
                                      f"price={out['price']:.5f} se={out['std_error']:.2e} "
                                      f"paths={out['paths']}"
                + (f" delta={np.round(out['delta'], 4).tolist()}" if "delta" in out else "")
                + (f" [{out['stderr_note']}]" if "stderr_note" in out else ""))
    finally:
        server.stop()
    return routed


# the short launches, timed on the device alone (graph_time): the terminal
# LR ladder, the price-only basket and sobol at 4,063,232 x 1, and /basket's
# default request (500,000 paths: 4 path blocks, 524,288 paths)
MA_BASKET_DEFAULT = 500_000
# the x 1 LR launch's bound before its epilogue's lane invariants were staged: 876
# issued per lane, 549 in the step and 327 on the epilogue's shortest path
MA_876_BOUND_MS = 0.0266
# the basket Asian instances' issue (in the step, on the epilogue per lane) as
# the build of the QE ladder redesign counted it (its bounds 4.2477 ms x 252,
# 1.2950 ms for the ladder x 64; 4.2467 and 1.2884 without the epilogue): the
# same function; the d = 3 ladders' occupancy cap (3 CUDA blocks per SM) adds
# spill and address code above it, which the bound does not count
MA_ASIAN_PINS = {"ILi3ELb1ELb0ELi0E": (555, 32), "ILi3ELb1ELb1ELi0E": (663, 218)}
# d = 2 basket price (prng) at path blocks where a short launch coarsens: the
# plan against one path block a thread
MA_PLAN_SWEEP = (16, 24)


def ma_launch(p, kw: dict, plan: tuple) -> torch.Tensor:
    """One launch of the multi-asset kernel with an explicit (n_chunks,
    blocks_per_chunk) plan, as ``mk._ma_cuda`` makes it."""
    n_chunks, per = plan
    n_out = mk._n_out(kw["d"], kw["lr"])
    partials = torch.empty((n_out, mk.ROWS, n_chunks), dtype=torch.float32, device=p.device)
    out = torch.empty((n_out, mk.ROWS), dtype=torch.float32, device=p.device)
    err = _build.load_library().multi_asset_moments(
        p.data_ptr(), p.numel(), 0, 0, kw["n_blocks"], per, n_chunks, kw["d"],
        mk._KIND_ID[kw["kind"]], kw["n_steps"], 1.0, mk._SAMPLER_ID[kw["sampler"]], int(kw["lr"]),
        n_out, partials.data_ptr(), out.data_ptr(), p.device.index, mk._stream(p.device))
    check(err == 0, f"multi_asset_moments returned {err}")
    return out


def in_turns(fns: dict) -> dict:
    """Device-only ms (graph_time means) of each of ``fns``, timed in turns
    a, b, b, a (…): {name: [ms, ms]}."""
    order = list(fns) + list(fns)[::-1]
    out = {name: [] for name in fns}
    for name in order:
        reads = graph_time(fns[name])
        out[name].append(sum(reads) / len(reads))
    return out


def kernel_launches(fns: list, calls: int) -> dict:
    """CUDA kernels the profiler sees in ``calls`` calls of each of ``fns``
    (one profiler session), by name."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    out = {"multi_asset_kernel": 0, "reduce_rows_kernel": 0}
    for e in prof.key_averages():
        for name in out:
            if name in e.key:
                out[name] += e.count
    return out


def ma_timing(dev) -> dict:
    """Device ms of the multi-asset kernel and its plain version at the
    path's shapes (prng unless named): the 252- and 64-step launches by
    CUDA events, the one-step launches by the graph timer (also logged back
    to back) with the profiler's count of their CUDA launches, and the
    short plan against one path block a thread. Not counted as main
    path."""
    out, one_step = {}, []
    # tag, kind, (paths, steps), lr, sampler, mangled-name part (D, Asian, lr, sampler) of
    # the instance whose bound is counted: the sobol instance draws before its step loop,
    # which then holds no Box–Muller for sass_bound to find, so its bound is not counted
    for tag, kind, (n, m), lr, sampler, name in (
            (f"basket_asian {MA_PRICE[0]}x{MA_PRICE[1]}", "basket_asian", MA_PRICE, False, "prng",
             "ILi3ELb1ELb0ELi0E"),
            (f"basket_asian LR {MA_LADDER[0]}x{MA_LADDER[1]}", "basket_asian", MA_LADDER, True,
             "prng", "ILi3ELb1ELb1ELi0E"),
            (f"basket_geo LR {MA_TERMINAL[0]}x1", "basket_geo", MA_TERMINAL, True, "prng",
             "ILi3ELb0ELb1ELi0E"),
            (f"basket {MA_TERMINAL[0]}x1", "basket", MA_TERMINAL, False, "prng",
             "ILi3ELb0ELb0ELi0E"),
            (f"basket_geo sobol {MA_TERMINAL[0]}x1", "basket_geo", MA_TERMINAL, False, "sobol",
             None),
            (f"basket_geo LR {MA_BASKET_DEFAULT}x1", "basket_geo", (MA_BASKET_DEFAULT, 1), True,
             "prng", "ILi3ELb0ELb1ELi0E"),
            (f"basket {MA_BASKET_DEFAULT}x1", "basket", (MA_BASKET_DEFAULT, 1), False, "prng",
             "ILi3ELb0ELb0ELi0E")):
        p = ma_vector(3, kind, m, lr, dev)
        kw = dict(d=3, kind=kind, n_steps=m, n_blocks=mk._n_blocks(n, mk.PATHS_PER_BLOCK),
                  cp=1.0, sampler=sampler, lr=lr)
        kernel = lambda p=p, kw=kw: mk._ma_cuda(0, 0, p, **kw)  # noqa: E731
        ms, plain_ms = event_pair(kernel, lambda: mk._ma_plain(0, 0, p, **kw))
        t = {"ms": ms, "plain_ms": plain_ms, "trips": kw["n_blocks"] * mk.ROWS * mk.LANES * m,
             "bytes": 4 * (p.numel() + mk._n_out(3, lr) * mk.ROWS), "steps": m,
             "sass": name and (f"multi_asset_kernel{name}",), "pin": MA_ASIAN_PINS.get(name)}
        if m == 1:
            plan = mk._plan(kw["n_blocks"], m)
            one_step.append(kernel)
            reads = graph_time(kernel)
            t.update(ms=sum(reads) / len(reads), back_to_back_ms=ms)
            log("timing", f"multi_asset {tag} {sampler}: device-only (a CUDA graph of 20 calls, "
                          f"5 replays) {' '.join(f'{x:.5f}' for x in reads)} ms; back to back "
                          f"{ms:.5f} ms; plan (chunks, blocks a chunk) {plan}")
        out[f"multi_asset {tag}"] = t
    seen = kernel_launches(one_step, 5)
    want = {"multi_asset_kernel": 5 * len(one_step), "reduce_rows_kernel": 5 * len(one_step)}
    check(seen == want, f"multi_asset one-step rows: 5 calls each ran {seen}, want {want}")
    log("timing", f"multi_asset one-step rows: 5 calls of each of the {len(one_step)} ran {seen} "
                  f"(profiler): the kernel and its row-sum pass a call")
    for nb in MA_PLAN_SWEEP:
        p = ma_vector(2, "basket", 1, False, dev)
        kw = dict(d=2, kind="basket", n_steps=1, n_blocks=nb, lr=False, sampler="prng")
        plan = mk._plan(nb, 1)
        turns = in_turns({"plan": lambda: ma_launch(p, kw, plan),
                          "one a thread": lambda: ma_launch(p, kw, (nb, 1))})
        log("timing", f"multi_asset basket d=2 prng {nb} blocks x1: the plan {plan} against one "
                      f"path block a thread ({nb}, 1), in turns, device-only ms: "
                      + "; ".join(f"{w} {' '.join(f'{x:.5f}' for x in v)}"
                                  for w, v in turns.items()))
    empty = graph_time(lambda: torch.cuda._sleep(0), 40)
    log("timing", f"an empty launch on the same stream, device-only: "
                  f"{' '.join(f'{x:.5f}' for x in empty)} ms")
    return out


def ma_report(funcs: dict, ma_t: dict) -> None:
    """Registers, local memory and CUDA blocks per SM of every multi-asset
    instance; the x 1 LR launch's issue count and share against this
    build's count and the earlier one's; the basket Asian launches' shares
    against this build's count and the pinned one."""
    lib = _build.load_library()
    for d in (2, 3, 4):
        for asian, family in ((0, "terminal"), (1, "basket_asian")):
            for lr in (0, 1):
                for sampler in range(2 if asian else 3):
                    regs, local, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
                    err = lib.multi_asset_occupancy(d, asian, lr, sampler, 0, ctypes.byref(regs),
                                                    ctypes.byref(local), ctypes.byref(ctas))
                    check(err == 0, f"multi_asset_occupancy returned {err}")
                    log("multi_asset", f"d={d} {family} lr={bool(lr)} {mk.SAMPLERS[sampler]}: "
                                       f"{regs.value} registers, {local.value} local bytes, "
                                       f"{ctas.value} CUDA blocks of 256 threads per SM")
    t = ma_t[f"multi_asset basket_geo LR {MA_TERMINAL[0]}x1"]
    fn = sass_bound.find_function(funcs, *t["sass"])
    lane = sass_bound.nest_counts(fn, n_steps=1, **_MA_NEST)
    log("multi_asset", f"basket_geo LR {MA_TERMINAL[0]}x1: {lane['issue']:.1f} issued per lane "
                       f"({lane['issue'] - lane['tail_issue']:.1f} in the step, "
                       f"{lane['tail_issue']} on the epilogue's shortest path); device-only "
                       f"{t['ms']:.5f} ms: share {t['bound_ms'] / t['ms']:.3f} of this count's "
                       f"{t['bound_ms']:.5f} ms bound, {MA_876_BOUND_MS / t['ms']:.3f} of the "
                       f"earlier count's {MA_876_BOUND_MS} ms (876 per lane)")
    for tag in (f"basket_asian {MA_PRICE[0]}x{MA_PRICE[1]}",
                f"basket_asian LR {MA_LADDER[0]}x{MA_LADDER[1]}"):
        t = ma_t[f"multi_asset {tag}"]
        own = sass_bound.nest_counts(sass_bound.find_function(funcs, *t["sass"]),
                                     n_steps=t["steps"], **_MA_NEST)["issue"]
        step, tail = t["pin"]
        pinned = step + tail / t["steps"]
        log("multi_asset", f"{tag}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms: share "
                           f"{t['bound_ms'] / t['ms']:.3f} at the pinned {pinned:.2f} issued per "
                           f"lane-step ({step} + {tail}/{t['steps']}), "
                           f"{t['bound_ms'] * own / min(own, pinned) / t['ms']:.3f} at this "
                           f"build's {own:.2f}")


# the step loop with d = 3 Box–Mullers (3 MUFU.RSQ) a trip, and once per
# lane the epilogue after it (payoff and moments, counted along its shortest
# path over the payoff kinds): at n_steps = 1 it is as large as the one step
_MA_NEST = nest((3, 1), tail=1)


def qe_ladder_report(funcs: dict, t: dict) -> None:
    """Registers, CUDA blocks per SM and issue share of the QE ladder kernel,
    and the SASS digests of the QE instances beside their pins."""
    lib = _build.load_library()
    for name, sampler in (("prng", 0), ("hash", 1)):
        regs, ctas = ctypes.c_int(), ctypes.c_int()
        err = lib.heston_qe_occupancy(7, sampler, 0, ctypes.byref(regs), ctypes.byref(ctas))
        check(err == 0, f"heston_qe_occupancy returned {err}")
        log("qe ladder", f"heston_qe_ladder_kernel {name}: {regs.value} registers, "
                         f"{ctas.value} CUDA blocks of 224 threads per SM")
    parts, spec = HESTON_SASS["heston_qe_ladder"]
    fn = sass_bound.find_function(funcs, *parts)
    own = sass_bound.nest_counts(fn, n_steps=t["steps"], **{**spec, "bookkeeping": True})
    fun = sass_bound.nest_counts(fn, n_steps=t["steps"], **spec)
    share = t["bound_ms"] / t["ms"]
    log("qe ladder", f"prng {H_QE[0]}x{H_QE[1]}: {fun['issue']:.4f} instructions per lane-step "
                     f"for the function ({own['issue']:.4f} with the split's bookkeeping); "
                     f"{t['ms']:.4f} ms against a bound of {t['bound_ms']:.4f} ms: issue share "
                     f"{share:.3f} ({share * own['issue'] / fun['issue']:.3f} against the "
                     f"kernel's own count)")
    for parts, (n_pin, pin) in QE_SASS_PINS.items():
        n, got = sass_bound.digest(funcs, *parts)
        log("sass", f"{' '.join(parts)}: {n} functions, digest {got[:16]}; pinned {n_pin}, "
                    f"{pin[:16]}: {'the same code' if (n, got) == (n_pin, pin) else 'DIFFERENT'}")


def h_timing(h_t: dict, prefix: str) -> dict:
    (tag,) = [t for t in h_t if t.startswith(prefix)]
    return h_t[tag]


def heston_sass_key(tag: str):
    for key in sorted(HESTON_SASS, key=len, reverse=True):
        if tag.startswith(key):
            return key
    raise KeyError(tag)


# ---------------------------------------------------------------------------
# The pricers that have no kernel: lattice, PDE, IV, jumps, Lévy, SABR,
# variance swaps, QMC exotics and the certified American brackets
# ---------------------------------------------------------------------------
PR_BOOK = 1024  # binomial_price and implied_volatility_vectorized
PR_GREEKS_BOOK = 64  # binomial_greeks
PR_FDM_BOOK = 256  # fdm_price at 201 x 200
PR_PATHS = 1_048_576  # the jump and Lévy Monte Carlo, the integrated variance
PR_REPLICATES = 16  # the Monte Carlo prices that return no stderr


def pricer_book(n: int, dev, seed: int = 9, dtype=torch.float32) -> ContractBatch:
    """n contracts drawn from a seeded numpy generator, alternating call/put."""
    rng = np.random.default_rng(seed)
    fields = {"spot": rng.uniform(80.0, 120.0, n), "strike": rng.uniform(85.0, 115.0, n),
              "maturity": rng.uniform(0.25, 2.0, n), "rate": rng.uniform(0.01, 0.06, n),
              "vol": rng.uniform(0.15, 0.45, n), "dividend": rng.uniform(0.0, 0.03, n),
              "cp": np.where(np.arange(n) % 2 == 0, 1.0, -1.0)}
    return ContractBatch(**{k: torch.tensor(v, dtype=dtype, device=dev)
                            for k, v in fields.items()})


def cuda_kernels(fn, sessions: int = 1) -> int:
    """CUDA kernels the profiler sees in one call of ``fn`` (memcpy and
    memset not counted); 0 when the profiler sees no device activity. The
    profiler now and then drops a few dozen records of a session, which only
    lowers a count: with ``sessions`` > 1, the most that one session saw."""
    counts = []
    for _ in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.key.startswith(("Memcpy", "Memset"))))
    return max(counts)


def linear_kernels(fn_of_steps, full: int, base: int = 1) -> int:
    """Kernels of ``fn_of_steps(full)`` from calls at ``base`` and ``base +
    1`` steps: these loops issue the same launches every step (time step,
    exercise date, Adam step), so the count is a + b·steps; the profiler
    spends about 0.2 ms of host time per kernel it reports, minutes at a
    million. Each short call is counted over two sessions: a dropped record
    would be multiplied by the steps."""
    lo, hi = (cuda_kernels(lambda n=n: fn_of_steps(n), 2) for n in (base, base + 1))
    return lo + (full - base) * (hi - lo)


def date_step_kernels(fn, n_dates: int, steps: int) -> int:
    """Kernels of ``fn(n_dates, steps)``, a date loop that runs ``steps``
    solver steps a date, from calls at (2, 1), (2, 2) and (3, 1) dates and
    steps: the count is c0 + dates·(m + steps·s), each short call counted
    over two sessions."""
    c21, c22, c31 = (cuda_kernels(lambda a=a, b=b: fn(a, b), 2)
                     for a, b in ((2, 1), (2, 2), (3, 1)))
    s = (c22 - c21) // 2
    m = c31 - c21 - s
    return c21 + (n_dates - 2) * m + (n_dates * steps - 2) * s


def pricer_replicates(fn, dev, seed: int = 100):
    """(mean, stderr of the mean) of ``fn(generator)`` over PR_REPLICATES
    independently seeded generators on ``dev``."""
    runs = torch.stack([fn(torch.Generator(device=dev).manual_seed(seed + i))
                        for i in range(PR_REPLICATES)])
    return runs.mean(0), runs.std(0, correction=1) / math.sqrt(PR_REPLICATES)


def on_card(*xs) -> None:
    for x in xs:
        check(x.device.type == "cuda", f"a pricer answered on {x.device}, not the card")


def make_recorder(phase: str, card: str, stats: dict, spent: dict):
    """``record(name, fn, kernels=None, iters=1, warm=None)`` for a phase:
    runs ``fn`` once (the result), then ``iters`` warm timed calls; with
    ``warm`` (a short call of the same loops), runs that, then times the one
    call of ``fn``. Logs the warm wall ms and the CUDA kernel count
    (``kernels()`` or one profiled call), keeps them in ``stats`` and adds the
    wall of each part to ``spent``."""

    def record(name, fn, kernels=None, iters: int = 1, warm=None):
        t0 = time.perf_counter()
        if warm is None:
            out, ms = timed(fn, iters)
        else:
            warm()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        t2 = time.perf_counter()
        n = cuda_kernels(fn) if kernels is None else kernels()
        spent["kernel counts"] += time.perf_counter() - t2
        spent["timed calls"] += ms * iters / 1e3
        spent["first calls and warm-ups"] += t2 - t0 - ms * iters / 1e3
        stats[name] = (ms, n)
        log(phase, f"{name}: warm wall {ms:.1f} ms, {n} CUDA kernels "
                   f"{'(profiler saw none: not measured) ' if n == 0 else ''}[{card}]")
        return out

    return record


def phase_pricers(dev, card: str) -> dict:
    """Each pricer without a kernel once on the card at the reference's
    default sizes, against its oracle; prints each call's warm wall time and
    CUDA kernel count. Returns {call: (warm ms, kernels)}."""
    from optionslab_tpu_torch.models import american as am
    from optionslab_tpu_torch.models import binomial as bn
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.models import iv as ivm
    from optionslab_tpu_torch.models import jump_diffusion as jd
    from optionslab_tpu_torch.models import levy
    from optionslab_tpu_torch.models import local_vol_american as lva
    from optionslab_tpu_torch.models import qmc_exotics as qmc
    from optionslab_tpu_torch.models import sabr
    from optionslab_tpu_torch.models import var_swap as vs
    from optionslab_tpu_torch.models.black_scholes import bs_price

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on: the LSM regressions "
                                                      "need full float32")
    t_phase = time.perf_counter()
    log("pricers", f"book sizes {PR_BOOK}, {PR_GREEKS_BOOK}, {PR_FDM_BOOK} contracts: no cut")
    stats = {}
    spent = {"timed calls": 0.0, "first calls and warm-ups": 0.0, "kernel counts": 0.0}

    record = make_recorder("pricers", card, stats, spent)

    book = pricer_book(PR_BOOK, dev)
    s, k, t, r, v, q, cp = (getattr(book, f) for f in ("spot", "strike", "maturity", "rate",
                                                       "vol", "dividend", "cp"))
    bs = bs_price(s, k, t, r, v, cp, q)

    # the lattice: 1024 contracts x 512 steps, European and American
    eu = record("binomial_price european 1024x512", lambda: bn.binomial_price(book), iters=3)
    amer = record("binomial_price american 1024x512",
                  lambda: bn.binomial_price(book, american=True), iters=3)
    on_card(eu, amer)
    crr_tol = s * v * torch.sqrt(t) / 512  # the CRR oscillation, O(Sσ√T/N)
    err = (eu - bs).abs()
    check(bool((err < crr_tol).all()), f"binomial European off Black–Scholes by "
                                       f"{err.max().item():.2e} > S·σ·√T/N")
    check(bool((amer >= eu - 1e-4).all()), "binomial American below European")
    log("pricers", f"binomial: max |CRR − BS| {err.max().item():.2e} (bound S·σ·√T/512); "
                   f"American − European in [{(amer - eu).min().item():.2e}, "
                   f"{(amer - eu).max().item():.3f}]")

    # the lattice Greeks: both methods' node Greeks (delta, gamma, theta;
    # Leisen–Reimer's theta read at S0, off its middle node) and
    # Leisen–Reimer's autograd Greeks (vega, rho, the strike derivative).
    # Autograd of the CRR price carries its O(1/N) oscillation in σ (vega 8%
    # off at 512 steps), so CRR is not held on those.
    gbook = pricer_book(PR_GREEKS_BOOK, dev, seed=10)
    ex = bs_greeks(gbook.spot, gbook.strike, gbook.maturity, gbook.rate, gbook.vol, gbook.cp,
                   gbook.dividend)
    worst = {}
    for method, n_steps, tols in (
            ("crr", 512, (("delta", 2e-3), ("gamma", 2e-4), ("theta", 0.05))),
            ("leisen-reimer", 513, (("delta", 2e-3), ("gamma", 2e-4), ("theta", 0.05),
                                    ("vega", 0.05), ("rho", 0.05), ("dual_delta", 2e-3)))):
        g = record(f"binomial_greeks {method} 64x{n_steps}",
                   lambda: bn.binomial_greeks(gbook, n_steps=n_steps, method=method), iters=3)
        on_card(g["vega"])
        for key, tol in tols:
            worst[f"{method} {key}"] = gap = (g[key] - ex[key]).abs().max().item()
            check(gap < tol, f"binomial_greeks {method} {key} off bs_greeks by {gap:.3e}")
    log("pricers", "binomial_greeks vs bs_greeks, max abs: "
                   + ", ".join(f"{key} {val:.2e}" for key, val in worst.items()))

    # the PDE: 256 contracts at 201 x 200, European, and American (Howard);
    # the whole time loop is one launch of the θ-scheme kernel
    fbook = pricer_book(PR_FDM_BOOK, dev, seed=11)
    f_bs = bs_price(fbook.spot, fbook.strike, fbook.maturity, fbook.rate, fbook.vol, fbook.cp,
                    fbook.dividend)
    f_eu = record("fdm_price european 256x201x200", lambda: fdm.fdm_price(fbook), iters=3)
    f_am = record("fdm_price american 256x201x200",
                  lambda: fdm.fdm_price(fbook, american=True), iters=3)
    for american in (False, True):
        got = loop_launches(lambda a=american: fdm.fdm_price(fbook, american=a))
        check(got == (1, 0), f"fdm_price american={american}: {got} (θ-scheme, tridiag) "
                             f"launches, not (1, 0)")
    # one gradient: the backward runs the plain loop on the card under
    # autograd, one tridiagonal launch a solve each way
    def fdm_grad(n_time=200):
        leaves = [getattr(fbook, f).detach().requires_grad_(True) for f in FDM_FIELDS[:6]]
        price = fdm.fdm_price(ContractBatch(*leaves, fbook.cp), n_time=n_time)
        return torch.autograd.grad(price.sum(), leaves)

    grads = record("fdm_price european gradient 256x201x200", fdm_grad,
                   lambda: linear_kernels(fdm_grad, 200), warm=lambda: fdm_grad(2))
    check(all(bool(torch.isfinite(g).all()) for g in grads), "fdm_price gradient not finite")
    check(bool(((grads[0] * fbook.cp) > 0).all()), "fdm_price delta has the wrong sign")
    crr_am = bn.binomial_price(fbook, american=True, n_steps=2048)
    on_card(f_eu, f_am, crr_am)
    e_eu, e_am = (f_eu - f_bs).abs().max().item(), (f_am - crr_am).abs().max().item()
    check(e_eu < 0.02, f"fdm European off Black–Scholes by {e_eu:.3e}")
    check(e_am < 0.03, f"fdm American off the 2048-step binomial American by {e_am:.3e}")
    log("pricers", f"fdm: max |CN − BS| {e_eu:.2e}; max |CN American − CRR@2048| {e_am:.2e}")

    # implied vol: 1024 Black–Scholes prices round trip
    ivs = record("implied_volatility_vectorized 1024",
                 lambda: ivm.implied_volatility_vectorized(bs, s, k, t, r, cp, q), iters=3)
    on_card(ivs)
    vega = bs_greeks(s, k, t, r, v, cp, q)["vega"]
    live = vega > 1.0  # prices that pin the vol in float32
    iv_err = (ivs - v).abs()[live].max().item()
    rt_err = (bs_price(s, k, t, r, ivs, cp, q) - bs).abs().max().item()
    check(bool(torch.isfinite(ivs).all()) and iv_err < 1e-3 and rt_err < 2e-4,
          f"IV round trip: vol off by {iv_err:.2e}, price by {rt_err:.2e}")
    log("pricers", f"iv: max |σ̂ − σ| {iv_err:.2e} on {int(live.sum())} quotes with vega > 1, "
                   f"max price round trip {rt_err:.2e}")

    # jumps: the Merton series at λ = 0 is Black–Scholes; the Monte Carlo
    # prices at 1,048,576 paths against the series and put–call parity
    m0 = record("merton_price 1024 lam=0", lambda: jd.merton_price(book, 0.0, -0.1, 0.2), iters=3)
    rel = ((m0 - bs).abs() / bs.clamp_min(1e-3)).max().item()
    check(rel < 1e-5, f"merton_price at λ = 0 off Black–Scholes by {rel:.2e} relative")
    jbook = ContractBatch.make(100.0, torch.tensor([90.0, 100.0, 110.0] * 2), 1.0, 0.03, 0.2,
                               torch.tensor([1.0] * 3 + [-1.0] * 3), 0.01, device=dev)
    merton, kou = (0.7, -0.1, 0.25), (0.8, 0.4, 10.0, 5.0)
    fwd = (100.0 * math.exp(-0.01) - jbook.strike[:3] * math.exp(-0.03))
    series = jd.merton_price(jbook, *merton)
    for name, fn, args in (("merton_mc_price", jd.merton_mc_price, merton),
                           ("kou_mc_price", jd.kou_mc_price, kou)):
        gen = torch.Generator(device=dev).manual_seed(1)
        record(f"{name} 6x{PR_PATHS}", lambda: fn(jbook, *args, gen, n_paths=PR_PATHS), iters=3)
        mean, se = pricer_replicates(lambda g_: fn(jbook, *args, g_, n_paths=PR_PATHS), dev)
        on_card(mean)
        parity = (mean[:3] - mean[3:]) - fwd
        p_se = torch.hypot(se[:3], se[3:])
        check(bool((parity.abs() < 4 * p_se).all()), f"{name} put–call parity off by "
                                                     f"{parity.abs().max().item():.2e}")
        msg = f"{name}: parity gaps / se {(parity / p_se).abs().max().item():.2f}"
        if name == "merton_mc_price":
            z = ((mean - series) / se).abs().max().item()
            check(z < 4.0, f"merton_mc_price off the series by {z:.2f} stderrs")
            msg += f"; |MC − series| / se at most {z:.2f}"
        log("pricers", msg + f" ({PR_REPLICATES} replicates of {PR_PATHS} paths)")

    # Lévy: the Lewis prices against their Monte Carlo at 1,048,576 paths
    lbook = ContractBatch.make(100.0, torch.tensor([80.0, 100.0, 120.0]), 1.0, 0.05, 0.2,
                               torch.tensor([-1.0, 1.0, 1.0]), device=dev)
    for name, price_fn, mc_fn, params in (
            ("vg", levy.vg_price, levy.vg_mc_price, levy.VGParams.make(device=dev)),
            ("nig", levy.nig_price, levy.nig_mc_price, levy.NIGParams.make(device=dev))):
        lewis = record(f"{name}_price 3 strikes", lambda: price_fn(lbook, params), iters=3)
        gen = torch.Generator(device=dev).manual_seed(2)
        m, se = record(f"{name}_mc_price 3x{PR_PATHS}",
                       lambda: mc_fn(lbook, params, gen, n_paths=PR_PATHS), iters=3)
        on_card(lewis, m)
        z = ((m - lewis).abs() - 1e-3).clamp_min(0.0) / se
        check(bool((z < 4.0).all()), f"{name} Lewis off its Monte Carlo: {m} vs {lewis}")
        log("pricers", f"{name}: Lewis {[round(x, 5) for x in lewis.tolist()]}, |MC − Lewis| / "
                       f"se {((m - lewis).abs() / se).max().item():.2f}")

    # SABR: recover the parameters of a 15-strike smile
    truth = sabr.SABRParams.make(0.3, 0.5, -0.4, 0.6, device=dev)
    strikes = torch.linspace(70.0, 130.0, 15, device=dev)
    vols = sabr.sabr_smile(100.0, strikes, 1.0, truth)
    fit, loss = record("calibrate_sabr 15 strikes 400 Adam steps",
                       lambda: sabr.calibrate_sabr(100.0, strikes, 1.0, vols),
                       lambda: linear_kernels(lambda n: sabr.calibrate_sabr(
                           100.0, strikes, 1.0, vols, n_steps=n), 400))
    on_card(fit.alpha)
    errs = {k_: abs(getattr(fit, k_).item() - getattr(truth, k_).item())
            for k_ in ("alpha", "rho", "nu")}
    check(loss < 1e-8 and errs["alpha"] < 2e-3 and errs["rho"] < 0.02 and errs["nu"] < 0.02,
          f"calibrate_sabr: loss {loss:.2e}, errors {errs}")
    log("pricers", f"sabr: loss {loss:.2e}, |fit − truth| {errs}")

    # variance swaps: the closed forms against the CIR Monte Carlo
    hp = hmodel.HestonParams.make(0.04, 2.0, 0.05, 0.3, -0.7, device=dev)
    kv = record("heston_expected_variance", lambda: vs.heston_expected_variance(hp, 1.0),
                iters=3)
    kvol = record("heston_vol_swap_strike", lambda: vs.heston_vol_swap_strike(hp, 1.0), iters=3)
    gen = torch.Generator(device=dev).manual_seed(3)
    m, se, rm, rse = record(f"heston_integrated_variance_mc {PR_PATHS}x252",
                            lambda: vs.heston_integrated_variance_mc(hp, 1.0, gen,
                                                                     n_paths=PR_PATHS))
    on_card(kv, kvol, m)
    # + 5e-5: the Euler scheme's O(Δt) bias at 252 steps
    check(abs(m.item() - kv.item()) < 4 * se.item() + 5e-5,
          f"E[I/T]: MC {m.item():.6f} ± {se.item():.1e} vs closed form {kv.item():.6f}")
    check(abs(rm.item() - kvol.item()) < 4 * rse.item() + 5e-5,
          f"E[√(I/T)]: MC {rm.item():.6f} ± {rse.item():.1e} vs closed form {kvol.item():.6f}")
    log("pricers", f"varswap: K_var {kv.item():.6f} (MC {m.item():.6f} ± {se.item():.1e}), "
                   f"K_vol {kvol.item():.6f} (MC {rm.item():.6f} ± {rse.item():.1e})")

    # QMC: the geometric Asian under bridge Sobol, 65,536 x 64
    gen = torch.Generator(device=dev).manual_seed(4)
    p, se = record("qmc_asian_price geometric 65536x64",
                   lambda: qmc.qmc_asian_price(100.0, 100.0, 1.0, 0.05, 0.2, gen,
                                               averaging="geometric", return_stderr=True),
                   iters=3)
    on_card(p)
    cf = tex.geometric_asian_closed_form(100.0, 100.0, 1.0, 0.05, 0.2, n_steps=64).item()
    check(abs(p.item() - cf) < min(4 * se.item(), 0.01),
          f"QMC geometric Asian {p.item():.5f} vs closed form {cf:.5f}")
    log("pricers", f"qmc geometric Asian {p.item():.6f} vs closed form {cf:.6f} "
                   f"(plain-MC se {se.item():.1e})")

    # the certified GBM American brackets at the defaults, against CRR@2001;
    # widths held at 50x (grid) and 1.45x (closed form) their chip-run
    # widths, 2.0e-5 and 0.1730 (NVIDIA H100 80GB HBM3, 700.00 W)
    put = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "put", dtype=torch.float64, device=dev)
    crr = bn.binomial_price(put, american=True, n_steps=2001).item()
    for method, max_width in (("grid", 1e-3), ("closed_form", 0.25)):
        out = record(f"american_price_interval {method}",
                     lambda: am.american_price_interval(100.0, 100.0, 1.0, 0.05, 0.2,
                                                        method=method, device=dev),
                     lambda: linear_kernels(lambda n: am.american_price_interval(
                         100.0, 100.0, 1.0, 0.05, 0.2, method=method, n_dates=n,
                         device=dev), 50, base=2))
        on_card(*out.values())
        lo = out["lower"].item() - 3 * out["lower_se"].item()
        hi = out["upper"].item() + 3 * out["upper_se"].item()
        check(lo <= crr <= hi + 0.02 and 5.9 < lo and hi < 6.6,
              f"american {method} [{lo:.5f}, {hi:.5f}] does not bracket CRR@2001 {crr:.5f}")
        width = out["width"].item()
        check(width < max_width, f"american {method} width {width:.3e} >= {max_width}")
        log("pricers", f"american {method}: [{out['lower'].item():.6f}, "
                       f"{out['upper'].item():.6f}] ± ({out['lower_se'].item():.1e}, "
                       f"{out['upper_se'].item():.1e}), width {width:.6f} (< {max_width}), "
                       f"CRR@2001 {crr:.6f}")
    gg = record("american_grid_greeks", lambda: am.american_grid_greeks(
        100.0, 100.0, 1.0, 0.05, 0.2, device=dev), lambda: linear_kernels(
            lambda n: am.american_grid_greeks(100.0, 100.0, 1.0, 0.05, 0.2, n_dates=n,
                                              device=dev), 500, base=2))
    bg = bn.binomial_greeks(put, american=True, n_steps=2001)
    gaps = {k_: abs(gg[k_] - bg[k_].item()) for k_ in ("delta", "gamma", "theta", "vega", "rho")}
    for k_, tol in (("delta", 2e-3), ("gamma", 2e-4), ("theta", 2e-2), ("vega", 0.2),
                    ("rho", 0.2)):
        check(gaps[k_] < tol, f"american_grid_greeks {k_} off the lattice by {gaps[k_]:.2e}")
    check(abs(gg["price"] - (6.09040 - 0.59 / 500)) < 2e-3,
          f"american_grid_greeks price {gg['price']:.5f}")
    log("pricers", f"american grid Greeks vs CRR@2001: {gaps}")

    # the local-vol bracket at the defaults, on the sample smile and a flat
    # surface; the flat bracket overlaps the GBM grid bracket
    smile, flat = smile_dupire(dev), smile_dupire(dev, flat=True)
    brackets = {}
    for name, dup in (("smile", smile), ("flat", flat)):
        brackets[name] = record(
            f"local_vol_american_bracket {name}",
            lambda: lva.local_vol_american_bracket(dup, 100.0, 1.0, device=dev),
            lambda: date_step_kernels(lambda n, k: lva.local_vol_american_bracket(
                dup, 100.0, 1.0, n_dates=n, steps_per_date=k, device=dev), 25, 8),
            warm=lambda: lva.local_vol_american_bracket(dup, 100.0, 1.0, n_dates=2,
                                                        device=dev))
        b = brackets[name]
        check(b["width"] < 0.05 and b["lower"] <= b["upper"] + 3 * b["upper_se"],
              f"local-vol bracket {name}: {b}")
        log("pricers", f"local-vol {name}: [{b['lower']:.5f}, {b['upper']:.5f}] ± "
                       f"({b['lower_se']:.1e}, {b['upper_se']:.1e}), PDE {b['lv_bermudan']:.5f}")
    b = brackets["flat"]
    g25 = am.american_price_interval(100.0, 100.0, 1.0, 0.05, 0.2, n_dates=25, device=dev)
    check(g25["lower"].item() - 3 * g25["lower_se"].item() < b["upper"] + 3 * b["upper_se"]
          and b["lower"] - 3 * b["lower_se"] < g25["upper"].item() + 3 * g25["upper_se"].item(),
          f"flat local-vol bracket {b} misses the GBM grid bracket {g25}")
    am_pde = float(smile._solve(100.0, 1.0, -1.0, american=True))
    b = brackets["smile"]
    check(b["lower"] - 3 * b["lower_se"] - 0.01 < am_pde
          < b["continuous_upper"] + 3 * b["upper_se"] + 0.01,
          f"smile bracket {b} misses the local-vol PDE American {am_pde:.5f}")
    log("pricers", f"flat bracket overlaps the GBM grid bracket [{g25['lower'].item():.5f}, "
                   f"{g25['upper'].item():.5f}]; smile holds the LV-PDE American {am_pde:.5f}")
    wall = time.perf_counter() - t_phase
    log("pricers", f"phase wall {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in spent.items())
        + f", oracles and the rest {wall - sum(spent.values()):.1f} s")
    return stats


def phase_pricers_server(dev) -> None:
    """Each new route once over a socket, against the port's own functions."""
    from optionslab_tpu_torch.models import binomial as bn

    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        atm = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "put", device=dev)
        for body in ({"model": "binomial", "american": True, "option_type": "put"},
                     {"model": "vg"}, {"model": "nig"}, {"model": "merton"}):
            status, out = _request(base + "/price", body)
            check(status == 200 and math.isfinite(out["price"]) and out["price"] > 0,
                  f"/price {body}: {status} {out}")
            if body["model"] == "binomial":
                want = bn.binomial_price(atm, american=True).item()
                check(abs(out["price"] - want) < 1e-6 * want, f"/price binomial {out} vs {want}")
        status, out = _request(base + "/iv", {"price": BS_ATM_CALL})
        check(status == 200 and abs(out["implied_vol"] - 0.2) < 1e-4, f"/iv: {status} {out}")
        try:
            _request(base + "/iv", {"price": 150.0})
            check(False, "/iv above the no-arbitrage bound answered 200")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"/iv above the no-arbitrage bound answered {e.code}")
        for body in ({}, {"model": "slv", "n_paths": 65_536, "n_steps": 64}):
            status, out = _request(base + "/varswap", body)
            check(status == 200 and 0.0 < out["variance_strike"] < 0.1
                  and 0.0 < out["vol_strike"] < 0.4, f"/varswap {body}: {status} {out}")
        for body in ({"model": "bs", "option_type": "put"},
                     {"model": "lv", "option_type": "put", "n_dates": 10, "n_outer": 2048,
                      "n_inner": 512}):
            status, out = _request(base + "/american", body)
            check(status == 200 and out["lower"] <= out["upper"] + 3 * out["upper_se"]
                  and out["width"] < 0.05, f"/american {body}: {status} {out}")
        try:
            _request(base + "/american", {"model": "vg", "option_type": "put"})
            check(False, "/american vg answered 200")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"/american vg answered {e.code}")
        log("pricers", "/price binomial|vg|nig|merton, /iv, /varswap heston|slv and /american "
                       "bs|lv answered on the card; /american vg and a bad /iv price: 400")
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The tridiagonal kernel (csrc/tridiag.cu) and the slice that runs on it: the
# Heston/SLV ADI, discrete dividends, forward-start, rough Bergomi and the
# stochastic-vol American brackets
# ---------------------------------------------------------------------------
# (batch, n, column sweep): the ADI's row sweep (n_v rows of n_x) and column
# sweep (n_x columns of n_v: the coefficients one (1, n_v) row read with batch
# stride 0, the right-hand side a transposed view), the dividend PDE, the
# Crank–Nicolson book of phase_pricers
TRI_SHAPES = ((101, 201, False), (201, 101, True), (1, 401, False), (256, 201, False))
TRI_ADJOINT_RTOL = 1e-10  # float64: the adjoint solve against autograd of the loop
# torch.linalg.solve (LU with partial pivoting) on the dense matrix against the
# kernel, relative to max |x|: a few hundred roundings on well-conditioned systems
TRI_LIBRARY_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
TRI_CHAIN_NODES = 1 << 16  # the chain probe's length; timed at this and twice it
FP64_FLOPS = 34e12  # H100 SXM data sheet, float64 outside the tensor cores
FP32_FLOPS = 67e12  # the same, float32
SL_HESTON = (0.04, 2.0, 0.05, 0.3, -0.7)  # tests/test_heston_fdm.py:19
SL_ADI = (201, 101, 200)  # heston_fdm_price's defaults
SL_BATES_KW = dict(n_dates=12, n_sub=2, n_fit=30_000, n_lower=40_000, n_outer=192, n_inner=384,
                   use_cv=True)  # tests/test_heston_american.py:191
SL_DIVS = [(0.3, 2.0), (0.8, 2.5)]  # tests/test_dividends.py:19
SL_DIV_MC = 524_288
SL_FS_MC = (200_000, 300)  # tests/test_forward_start.py:48
SL_RB = (100_000, 256)  # rbergomi_price's defaults
SL_RB_EV = (250_000, 128)  # tests/test_rbergomi.py:38, antithetic pairs
SL_RB_EXOTIC = (60_000, 16)  # tests/test_rbergomi.py:257


def tri_system(batch: int, n: int, dtype, dev, seed: int = 0, column: bool = False):
    """A seeded diagonally dominant batch of systems, (batch, n) each; with
    ``column`` the ADI's column-sweep layout: the coefficients one (1, n)
    row shared by every system, the right-hand side a transposed view."""
    rng = np.random.default_rng(seed)
    lo, up = rng.uniform(-1.0, 1.0, (2, batch, n))
    di = 2.5 + rng.uniform(0.0, 1.0, (batch, n))
    rhs = rng.normal(size=(batch, n))
    ops = [torch.tensor(a, dtype=dtype, device=dev) for a in (lo, di, up, rhs)]
    if column:
        ops = [o[:1] for o in ops[:3]] + [ops[3].T.contiguous().T]
    return ops


def tri_chain_node_ms(dtype, dev) -> float:
    """Device ms of one node of a system's dependent chain (a forward and a
    back node of the solve's own arithmetic, operands in registers), from the
    chain probe of ``csrc/tridiag.cu`` by CUDA events: the difference of
    runs of TRI_CHAIN_NODES and twice as many nodes, so the launch drops
    out."""
    abcd = torch.tensor([0.5, 3.0, -0.5, 1.0], dtype=dtype, device=dev)
    out = torch.empty(1, dtype=dtype, device=dev)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(n_nodes):
        err = lib.tridiag_chain_launch(abcd.data_ptr(), out.data_ptr(), n_nodes,
                                       0 if dtype == torch.float32 else 1, dev.index or 0,
                                       stream)
        check(err == 0, f"tridiag_chain_launch failed: {_build.error_string(err)}")

    run(TRI_CHAIN_NODES)
    one, two = (min(event_time(lambda k=k: run(k), 1) for _ in range(3))
                for k in (TRI_CHAIN_NODES, 2 * TRI_CHAIN_NODES))
    check(bool(torch.isfinite(out).all()), "the tridiag chain probe gave a non-finite value")
    return (two - one) / TRI_CHAIN_NODES


def tri_bound(ops, dtype, node_ms: float) -> tuple[float, str, float, float]:
    """(bound ms, what binds, flops, chain ms): the largest of each operand
    read once and the solution written once at the card's memory rate; 8
    float operations a node (forward: two products, two differences, two
    quotients; back: one product, one difference) at its peak rate for the
    dtype; and a system's 2n-long dependent chain, n nodes at ``node_ms``
    each (the systems run side by side). The chain and the throughput count
    are both the solve's operations: ``bound_by`` is "operations" where
    either binds."""
    size = torch.finfo(dtype).bits // 8
    batch, n = torch.broadcast_shapes(*(o.shape for o in ops))
    nbytes = (sum(o.numel() for o in ops) + batch * n) * size
    flops = 8.0 * batch * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS) * 1e3
    chain = n * node_ms
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", flops, chain


def tri_dense(ops) -> torch.Tensor:
    """The (.., n, n) matrix of the diagonals (lower, diag, upper)."""
    lo, di, up = ops[:3]
    return (torch.diag_embed(di) + torch.diag_embed(lo[..., 1:], offset=-1)
            + torch.diag_embed(up[..., :-1], offset=1))


def tri_solves(fn) -> int:
    """Launches of the tridiagonal kernel in one call of ``fn``."""
    before = tri._tridiag_cuda.launches
    fn()
    torch.cuda.synchronize()
    return tri._tridiag_cuda.launches - before


def loop_launches(fn) -> tuple[int, int]:
    """(θ-scheme, tridiagonal) kernel launches in one call of ``fn``."""
    before = tp._theta_cuda.launches
    solves = tri_solves(fn)
    return tp._theta_cuda.launches - before, solves


def phase_tridiag(dev, card: str) -> tuple[float, dict, dict]:
    """The tridiagonal kernel against its plain version at the slice's
    shapes, float32 and float64: bitwise equal, one launch a solve; its
    adjoint against autograd through the plain loop; device ms of kernel
    and plain version by CUDA events (the kernel inside a CUDA graph of 20
    calls, the host's issue left out) beside the bound and beside
    ``torch.linalg.solve`` on the dense matrix (built outside the timed
    region; the library call that computes the same x). Returns (largest
    absolute difference, {shape tag: timing}, {dtype: chain ms a node})."""
    worst, timing = 0.0, {}
    clock = sm_clock_hz()
    node_ms = {}
    for dtype in (torch.float32, torch.float64):
        node_ms[dtype] = tri_chain_node_ms(dtype, dev)
        log("tridiag", f"dependent chain, {str(dtype)[6:]}: {node_ms[dtype] * 1e6:.2f} ns a "
                       f"node (a forward and a back node; {node_ms[dtype] * 1e-3 * clock:.1f} "
                       f"cycles at the {clock / 1e9:.3f} GHz maximum SM clock), by the chain "
                       f"probe [{card}]")
    for batch, n, column in TRI_SHAPES:
        for dtype in (torch.float32, torch.float64):
            ops = tri_system(batch, n, dtype, dev, seed=batch + n, column=column)
            before = tri._tridiag_cuda.launches
            kern = tri.tridiag_solve(*ops)
            check(tri._tridiag_cuda.launches == before + 1,
                  f"tridiag {batch}x{n}: {tri._tridiag_cuda.launches - before} launches")
            plain = tri._tridiag_plain(*ops)
            torch.cuda.synchronize()
            diff = (kern - plain).abs().max().item()
            worst = max(worst, diff)
            check(torch.equal(kern, plain), f"tridiag {batch}x{n} {dtype}: kernel differs from "
                                            f"the plain version by {diff:.3e}")
            tag = f"{batch}x{n}{' column' if column else ''} {str(dtype)[6:]}"
            ms = min(graph_time(lambda: tri.tridiag_solve(*ops)))
            plain_ms = event_time(lambda: tri._tridiag_plain(*ops), 3)
            dense, rhs = tri_dense(ops), ops[3][..., None]
            lib_x = torch.linalg.solve(dense, rhs)[..., 0]
            lib_ms = event_time(lambda: torch.linalg.solve(dense, rhs), 3)
            lib_gap = ((lib_x - kern).abs().max() / kern.abs().max()).item()
            check(lib_gap < TRI_LIBRARY_RTOL[dtype], f"tridiag {tag}: torch.linalg.solve off "
                                                     f"the kernel by {lib_gap:.2e} relative")
            bound, by, _, chain = tri_bound(ops, dtype, node_ms[dtype])
            timing[tag] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bound, "bound_by": by, "chain_ms": chain,
                           "launches_per_call": 1}
            log("tridiag", f"{tag}: bitwise equal; device ms by CUDA events [{card}]: kernel "
                           f"{ms:.4f} (a graph of 20 calls), plain torch {plain_ms:.3f}, "
                           f"torch.linalg.solve on the dense matrix {lib_ms:.4f} ({lib_gap:.1e} "
                           f"off the kernel), bound {bound:.5f} ({by}; the dependent chain "
                           f"{chain:.5f})")
    ops = [o.requires_grad_(True) for o in tri_system(101, 201, torch.float64, dev, seed=7)]
    before = tri._tridiag_cuda.launches
    got = torch.autograd.grad((tri.tridiag_solve(*ops) ** 2).sum(), ops)
    check(tri._tridiag_cuda.launches == before + 2, "tridiag backward: not one adjoint launch")
    want = torch.autograd.grad((tri._tridiag_plain(*ops) ** 2).sum(), ops)
    rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
    check(rel < TRI_ADJOINT_RTOL, f"tridiag adjoint off autograd of the loop by {rel:.2e}")
    log("tridiag", f"adjoint (101x201 float64): one launch forward, one back; max relative "
                   f"difference to autograd of the plain loop {rel:.2e} (< {TRI_ADJOINT_RTOL})")
    return worst, timing, node_ms


# the θ-scheme kernel (csrc/theta_pde.cu) at fdm_price's defaults on
# phase_pricers' book: contracts, nodes, steps
THETA_SHAPE = (PR_FDM_BOOK, 201, 200)
THETA_MODES = {"european": tp.EUROPEAN, "projection": tp.PROJECTION, "howard": tp.HOWARD}
THETA_GRAD_RTOL = 1e-10  # float64: the Function's gradient against autograd of the loop
FDM_FIELDS = ("spot", "strike", "maturity", "rate", "vol", "dividend", "cp")


def theta_bound(ops, dtype, node_ms: float, solves: torch.Tensor) -> tuple[float, str, float]:
    """(bound ms, what binds, chain ms) of one θ-scheme launch: each input
    read once and the values written once at the card's memory rate; the
    float operations of the solves that ran (8 a node), the explicit step
    (7 a node a step) and Howard's residuals (7 a node, at least one solve a
    step without one) at the card's peak rate for the dtype; and the longest
    dependent chain, the most solves a CUDA block ran × n nodes ×
    ``node_ms`` (the contracts run side by side)."""
    size = torch.finfo(dtype).bits // 8
    batch, n = ops[-2].shape
    n_time = ops[-1].shape[1]
    nbytes = (sum(o.numel() for o in ops) + batch * n) * size
    systems = tri.plan_systems(batch, tri.sm_count(ops[-2].device.index),
                               lambda k: tp.tile_bytes(n, k, size))
    rows = torch.full_like(solves, systems)
    rows[-1] = batch - systems * (solves.numel() - 1)
    contract_solves = int((solves * rows).sum().item())
    flops = 8.0 * n * contract_solves + 7.0 * n * (contract_solves - batch * n_time)
    flops += 7.0 * n * batch * n_time
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS) * 1e3
    chain = int(solves.max().item()) * n * node_ms
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", chain


def phase_theta(dev, card: str, node_ms: dict) -> tuple[float, dict]:
    """The θ-scheme kernel against the plain loop of ``fdm._cn_book`` on the
    card at fdm_price's defaults: European, projection and Howard, θ = 0.5
    and 1, float32 and float64, bitwise, one launch; the Function's gradient
    against autograd through the plain loop (European and Howard, float64);
    device ms of kernel and plain loop by CUDA events beside the bound, the
    longest chain of solves that ran (``node_ms`` from the chain probe).
    Returns (largest absolute difference, {tag: timing})."""
    from optionslab_tpu_torch.models import fdm

    book = pricer_book(THETA_SHAPE[0], dev, seed=11)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        args = [getattr(book, f).to(dtype) for f in FDM_FIELDS]
        for theta in (0.5, 1.0):
            for name, mode in THETA_MODES.items():
                _, ops = fdm._cn_operands(*args, *THETA_SHAPE[1:], theta, mode != tp.EUROPEAN)
                before = tp._theta_cuda.launches
                kern, solves = tp._theta_cuda(*ops, mode, count_solves=True)
                check(tp._theta_cuda.launches == before + 1, "θ-scheme: not one launch")
                plain = tp._theta_plain(*ops, mode)
                torch.cuda.synchronize()
                diff = (kern - plain).abs().max().item()
                worst = max(worst, diff)
                tag = f"{name} θ={theta} {str(dtype)[6:]}"
                check(torch.equal(kern, plain), f"θ-scheme {tag}: kernel differs from the plain "
                                                f"loop by {diff:.3e}")
                if theta != 0.5:
                    continue
                ms = event_time(lambda: tp._theta_cuda(*ops, mode), 3)
                plain_ms = event_time(lambda: tp._theta_plain(*ops, mode), 1)
                bound, by, chain = theta_bound(ops, dtype, node_ms[dtype], solves)
                timing[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                               "bound_by": by, "chain_ms": chain,
                               "max_solves": int(solves.max().item())}
                log("theta", f"{tag} {'x'.join(map(str, THETA_SHAPE))}: bitwise equal; device "
                             f"ms by CUDA events [{card}]: kernel {ms:.4f}, plain loop "
                             f"{plain_ms:.3f}, bound {bound:.4f} ({by}; the longest chain "
                             f"{int(solves.max().item())} solves of {THETA_SHAPE[1]} nodes "
                             f"{chain:.4f}; mean solves a contract "
                             f"{solves.float().mean().item():.1f})")
    log("theta", "every mode, θ and dtype bitwise equal to the plain loop")
    names = FDM_FIELDS[:6]
    for american in (False, True):
        grads = []
        for loop in (tp.theta_loop, tp._theta_plain):
            leaves = [getattr(book, f).double().requires_grad_(True) for f in names]
            x, ops = fdm._cn_operands(*leaves, book.cp.double(), *THETA_SHAPE[1:], 0.5,
                                      american)
            mode = tp.HOWARD if american else tp.EUROPEAN
            price = fdm._read_price(loop(*ops, mode), x, leaves[0])
            grads.append(torch.autograd.grad(price.sum(), leaves))
        rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
                  for g, w in zip(*grads))
        check(rel < THETA_GRAD_RTOL, f"θ-scheme gradient (american={american}) off autograd "
                                     f"of the plain loop by {rel:.2e}")
        log("theta", f"gradient in S, K, T, r, σ, q (american={american}, float64): max "
                     f"relative difference to autograd of the plain loop {rel:.2e}")
    return worst, timing


def lewis_greeks_put(dev) -> dict:
    """Autograd of the port's Lewis price of the ATM put under
    HestonParams.make(): the European oracle of ``heston_fdm_greeks``
    (tests/test_heston_fdm.py:169)."""
    names = ("spot", "v0", "kappa", "theta", "sigma", "rho", "rate", "maturity")
    x = {k: torch.tensor(v, device=dev, requires_grad=True)
         for k, v in zip(names, (100.0, 0.04, 2.0, 0.04, 0.3, -0.7, 0.05, 1.0))}
    one = torch.ones((), device=dev)
    batch = ContractBatch(spot=x["spot"], strike=100.0 * one, maturity=x["maturity"],
                          rate=x["rate"], vol=0.2 * one, dividend=0.0 * one, cp=-one)
    price = hmodel.heston_price(batch, hmodel.HestonParams(x["v0"], x["kappa"], x["theta"],
                                                           x["sigma"], x["rho"]))
    grads = torch.autograd.grad(price, list(x.values()), create_graph=True)
    (gamma,) = torch.autograd.grad(grads[0], x["spot"])
    keys = ("delta", "vega_v0", "d_kappa", "d_theta", "d_sigma", "d_rho", "rho_rate", "theta_cal")
    out = {k: g.item() for k, g in zip(keys, grads)}
    out["theta_cal"] = -out["theta_cal"]
    out["gamma"] = gamma.item()
    return out


def phase_slice(dev, card: str) -> dict:
    """The slice once on the card at the reference's defaults, against the
    reference tests' oracles; prints each call's warm wall ms and CUDA
    kernel count. Returns {call: (warm ms, kernels)}."""
    from optionslab_tpu_torch.models import american as am
    from optionslab_tpu_torch.models import dividends as dv
    from optionslab_tpu_torch.models import fdm
    from optionslab_tpu_torch.models import forward_start as fs
    from optionslab_tpu_torch.models import heston_american as ha
    from optionslab_tpu_torch.models import heston_fdm as hf
    from optionslab_tpu_torch.models import rbergomi as rb
    from optionslab_tpu_torch.models import rbergomi_american as rba
    from optionslab_tpu_torch.models import slv_american as sa
    from optionslab_tpu_torch.models.black_scholes import bs_price

    t_phase = time.perf_counter()
    stats = {}
    spent = {"timed calls": 0.0, "first calls and warm-ups": 0.0, "kernel counts": 0.0}
    record = make_recorder("slice", card, stats, spent)
    n_x, n_v, n_t = SL_ADI
    hp = hmodel.HestonParams.make(*SL_HESTON, device=dev)

    def adi(cp, strike, american=False, params=hp, steps=n_t):
        return hf.heston_fdm_price(100.0, strike, 1.0, 0.05, params, option_type=cp,
                                   american=american, n_x=n_x, n_v=n_v, n_t=steps, device=dev)

    # the Heston ADI at 201 x 101 x 200: the European against Lewis (2e-3
    # relative, tests/test_heston_fdm.py:25), the American above it
    gaps = {}
    for cp, strike in (("call", 90.0), ("call", 110.0), ("put", 100.0), ("call", 100.0)):
        if (cp, strike) == ("call", 100.0):
            pde = record(f"heston_fdm_price european {n_x}x{n_v}x{n_t}", lambda: adi("call", 100.0),
                         lambda: linear_kernels(lambda k: adi("call", 100.0, steps=k), n_t))
        else:
            pde = adi(cp, strike)
        on_card(pde)
        lw = hmodel.heston_price(ContractBatch.make(100.0, strike, 1.0, 0.05, 0.2, cp,
                                                    device=dev), hp)
        gaps[f"{cp} {strike:g}"] = gap = abs(pde.item() / lw.item() - 1.0)
        check(gap < 2e-3, f"heston_fdm_price {cp} K={strike} off Lewis by {gap:.2e} relative")
    # the Douglas step: one row sweep and one column sweep, one launch each
    got = tri_solves(lambda: adi("put", 100.0, american=True))
    check(got == 2 * n_t, f"heston_fdm_price: {got} tridiag launches, not {2 * n_t}")
    am_put = record(f"heston_fdm_price american {n_x}x{n_v}x{n_t}",
                    lambda: adi("put", 100.0, american=True),
                    lambda: linear_kernels(lambda k: adi("put", 100.0, True, steps=k), n_t))
    eu_put = adi("put", 100.0)
    check(am_put.item() >= eu_put.item() - 1e-4, "Heston ADI American below European")
    frozen = hmodel.HestonParams.make(0.04, 2.0, 0.04, 1e-3, 0.0, device=dev)
    put = ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, "put", device=dev)
    fz = {}
    for american in (False, True):
        fz[american] = (adi("put", 100.0, american, frozen).item(),
                        fdm.fdm_price(put, american=american).item())
        check(abs(fz[american][0] - fz[american][1]) < 0.02,
              f"frozen-variance ADI {fz[american]} off the 1-D PDE (american={american})")
    log("slice", f"heston ADI vs Lewis, relative: {gaps}; American put {am_put.item():.5f} >= "
                 f"European {eu_put.item():.5f}; frozen variance vs 1-D PDE (ADI, 1-D): "
                 f"European {fz[False]}, American {fz[True]}")

    # the Greek ladder at the defaults against autograd of Lewis (1.5% of
    # max(|ref|, 1), gamma 5%: tests/test_heston_fdm.py:169-196)
    hp0 = hmodel.HestonParams.make(device=dev)
    g = record(f"heston_fdm_greeks european {n_x}x{n_v}x{n_t}",
               lambda: hf.heston_fdm_greeks(100.0, 100.0, 1.0, 0.05, hp0, option_type="put",
                                            device=dev),
               lambda: linear_kernels(lambda k: hf.heston_fdm_greeks(
                   100.0, 100.0, 1.0, 0.05, hp0, option_type="put", n_t=k, device=dev), n_t))
    ref = lewis_greeks_put(dev)
    for k, rv in ref.items():
        tol = 0.05 * abs(rv) if k == "gamma" else 0.015 * max(abs(rv), 1.0)
        check(abs(g[k] - rv) < tol, f"heston_fdm_greeks {k} {g[k]:.5f} vs Lewis {rv:.5f}")
    log("slice", "heston_fdm_greeks vs autograd of Lewis: " + ", ".join(
        f"{k} {g[k]:.4f}/{rv:.4f}" for k, rv in ref.items()))

    # the ADI-slice bracket at 50 dates: it holds its own PDE value within
    # 3 stderr and the PDE's grid error (tests/test_heston_american.py:128)
    def adi_bracket(n_dates=50, spd=8):
        return ha.heston_american_bracket(100.0, 100.0, 1.0, 0.05, hp0, n_dates=n_dates,
                                          steps_per_date=spd, method="adi", device=dev)

    b = record("heston_american_bracket adi 50 dates", adi_bracket,
               lambda: date_step_kernels(adi_bracket, 50, 8), warm=lambda: adi_bracket(2))
    lo, hi = b["lower"] - 3 * b["lower_se"], b["upper"] + 3 * b["upper_se"]
    inside = lo <= b["adi_bermudan"] <= hi
    check(lo - 0.03 <= b["adi_bermudan"] <= hi + 0.03 and b["width"] < 0.01,
          f"ADI bracket {b} does not hold its PDE value")
    log("slice", f"heston ADI bracket 50 dates: [{b['lower']:.5f}, {b['upper']:.5f}] ± "
                 f"({b['lower_se']:.1e}, {b['upper_se']:.1e}), width {b['width']:.2e}; PDE "
                 f"{b['adi_bermudan']:.5f} {'inside' if inside else 'outside'} ±3 se")

    # Bates LSM: at lam = 0 Heston's bracket to the digit; jumps add value
    bates = lambda lam: BatesParams.make(0.04, 2.0, 0.04, 0.3, -0.7, lam=lam,  # noqa: E731
                                         device=dev)
    rh = ha.heston_american_bracket(100.0, 100.0, 1.0, 0.05, hp0, device=dev, **SL_BATES_KW)
    r0 = ha.heston_american_bracket(100.0, 100.0, 1.0, 0.05, bates(0.0), device=dev,
                                    **SL_BATES_KW)
    rj = record("heston_american_bracket bates lsm 12 dates",
                lambda: ha.heston_american_bracket(100.0, 100.0, 1.0, 0.05, bates(0.5),
                                                   device=dev, **SL_BATES_KW),
                lambda: linear_kernels(lambda k: ha.heston_american_bracket(
                    100.0, 100.0, 1.0, 0.05, bates(0.5), device=dev,
                    **{**SL_BATES_KW, "n_dates": k}), 12, base=2))
    d0 = max(abs(rh[k] - r0[k]) for k in ("lower", "upper"))
    check(d0 <= 1e-6, f"Bates at lam = 0 off Heston by {d0:.2e}")
    check(rj["lower"] > rh["upper"], f"Bates bracket {rj} not above Heston's {rh}")
    log("slice", f"bates lam=0 - heston: {d0:.1e}; with jumps [{rj['lower']:.4f}, "
                 f"{rj['upper']:.4f}] above heston [{rh['lower']:.4f}, {rh['upper']:.4f}]")

    # SLV on a flat smile at mixing 0 (exact constant-vol law) overlaps the
    # GBM grid certificate at 25 dates (tests/test_slv_american.py:141)
    flat = smile_dupire(dev, flat=True)
    slvp = hmodel.HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7, device=dev)

    def slv_bracket(n_dates=25, spd=8):
        return sa.slv_american_bracket(flat, slvp, 100.0, 1.0, mixing=0.0, n_dates=n_dates,
                                       steps_per_date=spd)

    bs_ = record("slv_american_bracket flat mixing 0", slv_bracket,
                 lambda: date_step_kernels(slv_bracket, 25, 8), warm=lambda: slv_bracket(2))
    gb = am.american_price_interval(100.0, 100.0, 1.0, 0.05, 0.2, n_dates=25, device=dev)
    tol = 4 * (bs_["lower_se"] + bs_["upper_se"] + gb["lower_se"].item()
               + gb["upper_se"].item()) + 2e-3
    check(bs_["lower"] - tol < gb["upper"].item() and gb["lower"].item() < bs_["upper"] + tol,
          f"SLV flat bracket {bs_} misses the GBM certificate {gb}")
    log("slice", f"slv flat mixing 0: [{bs_['lower']:.5f}, {bs_['upper']:.5f}] vs GBM grid "
                 f"[{gb['lower'].item():.5f}, {gb['upper'].item():.5f}], overlap within "
                 f"{tol:.1e}")

    # cash dividends at 401 x 400 (tests/test_dividends.py)
    def div_pde(cp, divs=SL_DIVS, american=False, n_time=400):
        return dv.fdm_price_discrete_dividends(100.0, 100.0, 1.0, 0.05, 0.2, divs, cp=cp,
                                               american=american, n_time=n_time, device=dev)

    bs_c = bs_price(torch.tensor(100.0, device=dev), 100.0, 1.0, 0.05, 0.2, 1.0).item()
    c0 = record("fdm_price_discrete_dividends european 401x400", lambda: div_pde(1.0, []),
                lambda: linear_kernels(lambda k: div_pde(1.0, [], n_time=k), 400, base=10))
    check(abs(c0 - bs_c) < 0.01, f"dividend PDE without dividends {c0:.5f} vs BS {bs_c:.5f}")
    c, p = div_pde(1.0), div_pde(-1.0)
    gap = dv.dividend_parity_gap(c, p, 100.0, 100.0, 1.0, 0.05, SL_DIVS)
    check(gap < 0.02, f"dividend PDE parity gap {gap:.2e}")
    def div_mc(cp):
        return dv.mc_price_discrete_dividends(100.0, 100.0, 1.0, 0.05, 0.2, SL_DIVS, cp=cp,
                                              n_paths=SL_DIV_MC, seed=2, device=dev)

    mcs = {1.0: record(f"mc_price_discrete_dividends {SL_DIV_MC}", lambda: div_mc(1.0)),
           -1.0: div_mc(-1.0)}
    z = {}
    for cp, pde in ((1.0, c), (-1.0, p)):
        mc, se = mcs[cp]
        z[cp] = (pde - mc) / se
        check(abs(pde - mc) < 3 * se + 0.03, f"dividend PDE {pde:.5f} vs MC {mc:.5f} ± {se:.1e}")
    am_p = record("fdm_price_discrete_dividends american put 401x400",
                  lambda: div_pde(-1.0, american=True),
                  lambda: linear_kernels(lambda k: div_pde(-1.0, american=True, n_time=k), 400,
                                         base=10))
    check(am_p > p, f"American put {am_p:.5f} not above the European {p:.5f}")
    log("slice", f"dividends: no-div {c0:.5f} vs BS {bs_c:.5f}; parity gap {gap:.1e}; (PDE − "
                 f"MC)/se call {z[1.0]:.2f}, put {z[-1.0]:.2f}; American put {am_p:.5f} > "
                 f"{p:.5f}")

    # forward start: t1 -> 0 is vanilla (1e-4); against its Monte Carlo with
    # correlation (3.5 se + 0.01, tests/test_forward_start.py:48)
    hp64 = hmodel.HestonParams.make(*SL_HESTON, dtype=torch.float64, device=dev)
    v0 = fs.forward_start_price(100.0, 1.0, 1e-6, 1.0, 0.05, hp64, device=dev).item()
    van = hmodel.heston_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2,
                                                 dtype=torch.float64, device=dev), hp64).item()
    check(abs(v0 - van) < 1e-4, f"forward start at t1 -> 0 {v0:.6f} vs vanilla {van:.6f}")
    record("forward_start_price 3 strikes", lambda: fs.forward_start_price(
        100.0, [0.9, 1.0, 1.1], 0.5, 1.5, 0.05, hp64, device=dev), iters=3)

    def fs_mc(k, n_steps=SL_FS_MC[1]):
        gen = torch.Generator(device=dev).manual_seed(0)
        return fs.forward_start_mc_price(100.0, k, 0.5, 1.5, 0.05, hp64, gen,
                                         n_paths=SL_FS_MC[0], n_steps=n_steps)

    record(f"forward_start_mc_price {SL_FS_MC[0]}x{SL_FS_MC[1]}", lambda: fs_mc(1.0),
           lambda: linear_kernels(lambda n: fs_mc(1.0, n), SL_FS_MC[1], base=2))
    zs = []
    for k in (0.9, 1.0, 1.1):
        sa_ = fs.forward_start_price(100.0, k, 0.5, 1.5, 0.05, hp64, device=dev).item()
        mc, se = (x.item() for x in fs_mc(k))
        zs.append((sa_ - mc) / se)
        check(abs(sa_ - mc) < 3.5 * se + 0.01,
              f"forward start k={k}: {sa_:.5f} vs MC {mc:.5f} ± {se:.1e}")
    log("slice", f"forward start: t1->0 {v0:.6f} vs vanilla {van:.6f}; (CF − MC)/se "
                 + ", ".join(f"{x:.2f}" for x in zs))

    # rough Bergomi at eta -> 0: Black–Scholes (3 se + 0.01), E[v] = xi0
    # (4%), the discrete geometric Asian's closed form and the GBM barrier
    # scan (5 combined se), the American against the GBM certificate
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = rb.RBergomiParams(hurst=0.1, eta=1e-6, rho=-0.9, xi0=0.04)
    ks = torch.tensor([90.0, 100.0, 110.0], device=dev)
    pr, se = record(f"rbergomi_price 3 strikes {SL_RB[0]}x{SL_RB[1]}", lambda: rb.rbergomi_price(
        100.0, ks, 1.0, 0.05, p0, gen, n_paths=SL_RB[0], n_steps=SL_RB[1]), iters=3)
    on_card(pr)
    bsv = bs_price(torch.tensor(100.0, device=dev), ks, 1.0, 0.05, 0.2, 1.0)
    check(bool(((pr - bsv).abs() < 3 * se + 0.01).all()), f"rbergomi at eta->0 {pr} vs BS {bsv}")
    rp = rb.RBergomiParams(0.1, 1.9, -0.9, 0.04)
    n_ev = SL_RB_EV[1]
    z_, _ = rb._draw(gen, 2 * SL_RB_EV[0], n_ev)
    vt = rb._matmul_t(z_, rb._factor(n_ev, rp.hurst, 1.0, dev))[:, :n_ev]
    ev = rb.rbergomi_variance_grid(rp, vt, rb._t_grid(1.0, n_ev, dev)[None, :]).mean(0)
    ev_err = (ev / rp.xi0 - 1.0).abs().max().item()
    check(ev_err < 0.04, f"E[v_t]/xi0 − 1 up to {ev_err:.3f}")
    pe = rb.RBergomiParams(hurst=0.1, eta=0.0, rho=-0.9, xi0=0.04)
    n_p, n_s = SL_RB_EXOTIC
    ga, gsa = record(f"rbergomi_exotic_price asian_geo {n_p}x{n_s}", lambda: rb.
                     rbergomi_exotic_price("asian_geo", 100.0, 100.0, 1.0, 0.05, pe, gen,
                                           n_paths=n_p, n_steps=n_s, return_stderr=True),
                     iters=3)
    cf = tex.geometric_asian_closed_form(100.0, 100.0, 1.0, 0.05, 0.2, n_steps=n_s).item()
    check(abs(ga.item() - cf) < 5 * gsa.item(), f"rbergomi asian_geo {ga.item():.5f} vs {cf:.5f}")
    pb, sb = rb.rbergomi_exotic_price("barrier_up-and-out", 100.0, 100.0, 1.0, 0.05, pe, gen,
                                      barrier=120.0, n_paths=n_p, n_steps=n_s, return_stderr=True)
    pgb, sgb = tex.barrier_price(100.0, 100.0, 120.0, 1.0, 0.05, 0.2, gen, n_paths=n_p,
                                 n_steps=n_s, return_stderr=True)
    check(abs(pb.item() - pgb.item()) < 5 * math.hypot(sb.item(), sgb.item()),
          f"rbergomi barrier {pb.item():.5f} vs GBM scan {pgb.item():.5f}")
    pa = rb.RBergomiParams(hurst=0.3, eta=1e-6, rho=-0.5, xi0=0.04)

    def rb_bracket(n_dates=25):
        return rba.rbergomi_american_bracket(100.0, 105.0, 0.5, 0.06, pa, n_dates=n_dates,
                                             device=dev)

    br = record("rbergomi_american_bracket eta->0 25 dates", rb_bracket,
                lambda: linear_kernels(rb_bracket, 25, base=2))
    gr = am.american_price_interval(100.0, 105.0, 0.5, 0.06, 0.2, n_dates=25, device=dev)
    check(br["lower"] - 3 * br["lower_se"] <= gr["upper"].item() + 3 * gr["upper_se"].item() + 1e-3
          and br["upper"] + 3 * br["upper_se"] >= gr["lower"].item() - 3 * gr["lower_se"].item()
          - 1e-3 and br["width"] < 0.12, f"rbergomi eta->0 bracket {br} vs GBM {gr}")
    rr = record("rbergomi_american_bracket rough 25 dates", lambda: rba.rbergomi_american_bracket(
        100.0, 105.0, 0.5, 0.06, rp, device=dev))
    check(rr["lower"] <= rr["upper"] + 3 * (rr["lower_se"] + rr["upper_se"])
          and rr["upper"] + 3 * rr["upper_se"] >= 5.0, f"rough bracket {rr}")
    log("slice", f"rbergomi eta->0 vs BS: {((pr - bsv) / se).abs().max().item():.2f} se; "
                 f"max |E[v]/xi0 − 1| {ev_err:.4f}; asian_geo {ga.item():.5f} vs closed form "
                 f"{cf:.5f}; barrier {pb.item():.5f} vs GBM scan {pgb.item():.5f}; American "
                 f"eta->0 [{br['lower']:.4f}, {br['upper']:.4f}] vs GBM [{gr['lower'].item():.4f},"
                 f" {gr['upper'].item():.4f}]; rough [{rr['lower']:.4f}, {rr['upper']:.4f}]")
    wall = time.perf_counter() - t_phase
    log("slice", f"phase wall {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in spent.items())
        + f", oracles and the rest {wall - sum(spent.values()):.1f} s")
    return stats


def phase_slice_server(dev) -> None:
    """The slice's routes once over a socket at the server's defaults."""
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for model in ("heston", "bates", "slv", "rbergomi"):
            t0 = time.perf_counter()
            status, out = _request(base + "/american", {"model": model, "option_type": "put"})
            check(status == 200 and out["lower"] <= out["upper"] + 3 * (
                out["upper_se"] + out["lower_se"]) and 4.0 < out["lower"] < 8.0,
                f"/american {model}: {status} {out}")
            log("slice", f"/american {model}: [{out['lower']:.4f}, {out['upper']:.4f}] in "
                         f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        for body in ({"kind": "asian"}, {"kind": "cliquet"}):
            status, out = _request(base + "/exotic", {"model": "rbergomi", **body})
            check(status == 200 and out["dynamics"] == "rough-bergomi"
                  and math.isfinite(out["price"]), f"/exotic rbergomi {body}: {status} {out}")
        log("slice", "/american heston|bates|slv|rbergomi and /exotic rbergomi answered on the "
                     "card")
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The risk engine: the autograd Greeks, VaR/ES, stress, the portfolio, the
# exposure engines and CVA/DVA/FVA, and /xva
# ---------------------------------------------------------------------------
RK_XVA = (65_536, 24, 8)  # /xva's defaults: paths, dates, AMC substeps a date
RK_BS_CAP = (1_048_576, 120)  # /xva's caps on the closed-form engine
RK_AMC_CAP = (524_288, 120, 8)  # and on the AMC engine
RK_FDM_BOOK = 256  # greeks_fdm at fdm_price_fn's defaults, 201 x 100
RK_HAZARD, RK_RECOVERY = 0.02, 0.4
RK_MPOR = 10.0 / 252.0
RK_CORR = [[1.0, 0.5], [0.5, 1.0]]
# the capped netting set: (quantity, strike, maturity, type) per underlying,
# underlying A at 100 (vol 0.2) and B at 50 (vol 0.3)
RK_BOOK = {"A": (100.0, 0.2, [(2.0, 100.0, 1.0, "call"), (-1.0, 95.0, 0.5, "put"),
                              (-1.5, 110.0, 0.75, "call"), (1.0, 90.0, 1.0, "put"),
                              (1.0, 105.0, 0.25, "call"), (-0.5, 100.0, 0.75, "put"),
                              (-0.8, 100.0, 1.0, "forward"), (3.0, 120.0, 1.0, "call")]),
           "B": (50.0, 0.3, [(2.0, 50.0, 1.0, "call"), (1.0, 45.0, 0.5, "put"),
                             (-1.0, 55.0, 0.75, "call"), (-2.0, 50.0, 1.0, "put"),
                             (1.0, 60.0, 0.25, "call"), (1.5, 40.0, 1.0, "put"),
                             (1.0, 50.0, 0.5, "forward"), (-1.0, 48.0, 0.9, "call")])}
RK_AMC_BOOK = [{"kind": "vanilla"}, {"kind": "asian_arith", "quantity": 2.0},
               {"kind": "barrier_up-and-out", "barrier": 130.0, "quantity": -1.0}]
XVA_MODELS = ("bs", "heston", "bates", "slv", "rbergomi")


def rk_book():
    from optionslab_tpu_torch.risk import Position

    return [Position(q, s0, k, t, RATE, vol, kind, underlying=u)
            for u, (s0, vol, legs) in RK_BOOK.items() for q, k, t, kind in legs]


def rk_xva_body(model: str) -> dict:
    """/xva at its defaults for ``model`` (RK_XVA's paths and dates, the
    route's own defaults): the default position, a long 1-year ATM call;
    "bs" runs the closed-form engine, the others AMC."""
    return {"paths": RK_XVA[0], "dates": RK_XVA[1], **({} if model == "bs" else {"model": model})}


class RiskFrame(dict):
    """A market frame without pandas: columns, copy, item get/set."""

    @property
    def columns(self):
        return list(self)

    def copy(self):
        return RiskFrame(self)


def within_se(got, want, se, k: float = 4.0, extra: float = 0.0) -> float:
    """The largest |got − want| in standard errors; fails above ``k`` (plus
    ``extra`` absolute)."""
    got, want, se = (np.asarray(x, np.float64) for x in (got, want, se))
    gap = np.abs(got - want)
    check(bool(np.all(gap <= k * se + extra)), f"{gap} vs {k} x {se} + {extra}")
    return float(np.max(gap / np.maximum(se, 1e-30)))


def phase_risk(dev, card: str) -> dict:
    """The risk engine on the card: /xva's calls at its defaults for every
    model and at its two caps, ``greeks_fdm`` on 256 contracts (European and
    American), VaR/ES, stress, sensitivity and the portfolio, against the
    reference tests' oracles; prints each call's warm wall ms and CUDA
    kernel count. Returns {call: (warm ms, kernels)}."""
    from optionslab_tpu_torch import greeks as gr
    from optionslab_tpu_torch import risk as rk
    from optionslab_tpu_torch.models import binomial as bn
    from optionslab_tpu_torch.models.black_scholes import bs_price
    from optionslab_tpu_torch.server import handle_xva

    t_phase = time.perf_counter()
    stats = {}
    spent = {"timed calls": 0.0, "first calls and warm-ups": 0.0, "kernel counts": 0.0}
    record = make_recorder("risk", card, stats, spent)
    v0 = bs_price(100.0, 100.0, 1.0, RATE, 0.2, 1.0, 0.0).item()
    paths, n_dates, n_sub = RK_XVA

    # /xva at its defaults, every model (the handler the route calls)
    for model in XVA_MODELS:
        body = rk_xva_body(model)
        out = record(f"/xva {model} {paths}x{n_dates}" + (f"x{n_sub}" if model != "bs" else ""),
                     lambda body=body: handle_xva(body, dev),
                     None if model == "bs" else lambda model=model: linear_kernels(
                         lambda k: rk.amc_exposure_profile(
                             [rk.ExoticPosition()], n_dates=n_dates, n_sub=k, n_paths=paths,
                             device=dev, **rk.amc_dynamics_kwargs(model, spot=100.0, rate=RATE,
                                                                  vol=0.2, device=dev)), n_sub))
        check(len(out["ee"]) == n_dates and all(math.isfinite(x) for x in out["ee"] + out["pfe"])
              and out["cva"] > 0, f"/xva {model}: {out}")
        if model == "bs":
            ee_d = np.asarray(out["ee_discounted"])
            check(bool(np.all(np.abs(ee_d - v0) < 0.05 * v0)), f"/xva bs EE* {ee_d} vs {v0}")

    # the closed-form engine: the long call's EE* flat at Black–Scholes and
    # its flat-hazard CVA, perfect netting, the Euler allocations
    call = rk.Position(1.0, 100.0, 100.0, 1.0, RATE, 0.2, "call")
    prof = rk.exposure_profile([call], n_paths=paths, n_dates=n_dates, device=dev)
    df = np.exp(-RATE * prof.dates)
    z_ee = within_se(prof.ee_discounted, v0, df * prof.ee_stderr)
    scale = (1.0 - RK_RECOVERY) * (1.0 - math.exp(-RK_HAZARD))
    cva = rk.cva_dva(prof, RK_HAZARD, RK_RECOVERY)["cva"]
    z_cva = within_se(cva, scale * v0, scale * float(np.max(df * prof.ee_stderr)))
    netted = rk.exposure_profile([call, rk.Position(-1.0, 100.0, 100.0, 1.0, RATE, 0.2)],
                                 n_paths=paths, n_dates=n_dates, device=dev)
    check(float(np.max(netted.ee)) == 0.0, f"perfect netting left EE {netted.ee}")
    book = rk_book()
    alloc = record(f"cva_allocation euler 16 trades {paths}x{n_dates}",
                   lambda: rk.cva_allocation(book, RK_HAZARD, RK_RECOVERY, corr=RK_CORR,
                                             n_paths=paths, n_dates=n_dates, device=dev))
    gap = abs(sum(alloc["allocations"]) - alloc["total_cva"])
    check(gap <= 1e-9 * abs(alloc["total_cva"]), f"Euler allocations off the CVA by {gap}")
    g = record(f"cva_greeks long call {paths}x{n_dates}",
               lambda: rk.cva_greeks([call], RK_HAZARD, RK_RECOVERY, n_paths=paths,
                                     n_dates=n_dates, device=dev))
    bsg = bs_greeks(100.0, 100.0, 1.0, RATE, 0.2, 1.0, 0.0)
    check(abs(g["cva_delta"]["UND"] / (scale * bsg["delta"].item()) - 1.0) < 0.03
          and abs(g["cva_vega"]["UND"] / (scale * bsg["vega"].item()) - 1.0) < 0.05,
          f"cva_greeks {g} vs the scaled Black–Scholes Greeks")
    wwr = rk.cva_wwr([rk.Position(1.0, 100.0, 100.0, 1.0, RATE, 0.2, "put")], RK_HAZARD,
                     wwr_beta=3.0, n_paths=paths, n_dates=n_dates, device=dev)
    check(wwr["wwr_ratio"] > 1.1, f"the put book is not wrong-way: {wwr}")
    log("risk", f"long call EE* vs BS within {z_ee:.2f} se, CVA {cva:.5f} vs "
                f"{scale * v0:.5f} within {z_cva:.2f} se; netting EE 0; 16-trade Euler "
                f"allocations sum to {alloc['total_cva']:.6f} (gap {gap:.1e}); CVA delta "
                f"{g['cva_delta']['UND']:.5f}, vega {g['cva_vega']['UND']:.5f}; WWR put ratio "
                f"{wwr['wwr_ratio']:.3f}")

    # the closed-form engine at the caps: two correlated underlyings, calls,
    # puts and forwards, a collateral threshold and a margin period of risk
    bp, bd = RK_BS_CAP
    rep = record(f"xva_report 16 trades 2 underlyings {bp}x{bd}",
                 lambda: rk.xva_report(book, hazard_rate=RK_HAZARD, own_hazard_rate=0.01,
                                       funding_spread=0.01, n_paths=bp, n_dates=bd,
                                       corr=RK_CORR, collateral_threshold=1.0, mpor=RK_MPOR,
                                       device=dev))
    check(rep["n_paths"] == bp and len(rep["ee"]) == bd
          and all(math.isfinite(x) for x in rep["ee"] + rep["pfe"] + [rep["cva"], rep["fva"]]),
          f"xva_report at the cap: {rep['epe']}, {rep['cva']}")
    cap_body = {"positions": [{"quantity": q, "strike": k, "maturity": t, "option_type": kind}
                              for q, k, t, kind in RK_BOOK["A"][2] * 2],
                "dates": bd, "paths": bp, "collateral_threshold": 1.0, "mpor": RK_MPOR}
    out = record(f"/xva bs 16 trades {bp}x{bd}", lambda: handle_xva(cap_body, dev))
    check(out["n_paths"] == bp and len(out["ee"]) == bd and out["cva"] >= 0.0,
          f"/xva bs at the cap: {out['epe']}")

    # AMC: in + out barrier profiles add up to the vanilla's (GBM), and the
    # Heston engine at the caps
    pair = [rk.ExoticPosition(kind=f"barrier_up-and-{k}", barrier=120.0) for k in ("in", "out")]
    amc = rk.amc_exposure_profile(pair, n_paths=paths, n_dates=n_dates, n_sub=n_sub, device=dev)
    z_bar = within_se(amc.ee, prof.ee, np.hypot(amc.ee_stderr, prof.ee_stderr))
    ap, ad, asub = RK_AMC_CAP
    amc_body = {"positions": RK_AMC_BOOK, "model": "heston", "dates": ad, "paths": ap}
    amc_book = [rk.ExoticPosition(**{**p}) for p in RK_AMC_BOOK]
    out = record(f"/xva heston AMC 3 trades {ap}x{ad}x{asub}", lambda: handle_xva(amc_body, dev),
                 lambda: linear_kernels(lambda k: rk.amc_exposure_profile(
                     amc_book, n_dates=ad, n_sub=k, n_paths=ap, device=dev,
                     heston_params=hmodel.HestonParams.make(device=dev)), asub))
    check(len(out["ee"]) == ad and all(math.isfinite(x) and x >= 0 for x in out["ee"])
          and out["epe"] > 0, f"/xva heston AMC at the cap: {out['epe']}")
    log("risk", f"AMC barrier in + out vs the vanilla's EE within {z_bar:.2f} se; capped "
                f"closed-form EPE {rep['epe']:.4f} CVA {rep['cva']:.5f} FVA {rep['fva']:.5f}; "
                f"capped Heston AMC EPE {out['epe']:.4f} CVA {out['cva']:.5f}")

    # greeks_fdm on 256 contracts at 201 x 100: the European within the
    # reference test's bounds of Black–Scholes, the American against the
    # 2048-step lattice
    book256 = pricer_book(RK_FDM_BOOK, dev, seed=21)
    args = (book256.spot, book256.strike, book256.maturity, book256.rate, book256.vol)
    n_call = int((book256.cp > 0).sum())
    calls = [x[book256.cp > 0] for x in args + (book256.dividend,)]
    puts = [x[book256.cp < 0] for x in args + (book256.dividend,)]
    gf = record(f"greeks_fdm european {n_call} calls 201x100",
                lambda: gr.greeks_fdm(*calls[:5], "call", calls[5]),
                lambda: linear_kernels(lambda k: gr.greeks_from_fn(
                    gr.fdm_price_fn(1.0, n_time=k), *calls, second_order=False), 100))
    ex = bs_greeks(*calls[:5], 1.0, calls[5])
    d_err = (gf["delta"] - ex["delta"]).abs().max().item()
    v_err = (gf["vega"] - ex["vega"]).abs().max().item()
    check(d_err < 5e-3 and v_err < 0.5, f"greeks_fdm vs BS: delta {d_err}, vega {v_err}")
    ga = record(f"greeks_fdm american {RK_FDM_BOOK - n_call} puts 201x100",
                lambda: gr.greeks_fdm(*puts[:5], "put", puts[5], american=True),
                lambda: linear_kernels(lambda k: gr.greeks_from_fn(
                    gr.fdm_price_fn(-1.0, n_time=k, american=True), *puts,
                    second_order=False), 100))
    lat = bn.binomial_greeks(ContractBatch(*puts[:5], puts[5], -torch.ones_like(puts[0])),
                             american=True, n_steps=2048)
    a_err = (ga["delta"] - lat["delta"]).abs().max().item()
    check(a_err < 1e-2 and bool((ga["price"] >= bs_price(*puts[:5], -1.0, puts[5]) - 1e-3).all()),
          f"American greeks_fdm delta off the lattice by {a_err}")
    on_card(gf["delta"], ga["delta"])
    log("risk", f"greeks_fdm vs BS: max |delta| {d_err:.2e}, |vega| {v_err:.3f}; American "
                f"delta vs CRR@2048 {a_err:.2e}")

    # VaR/ES, stress, sensitivity and the portfolio, on the card
    gen = torch.Generator(device=dev).manual_seed(5)
    pnl = torch.randn(1_048_576, generator=gen, device=dev, dtype=torch.float64)
    var, es = rk.historical_var(pnl, 0.99).item(), rk.historical_es(pnl, 0.99).item()
    check(abs(var - 2.3263) < 0.01 and abs(es - 2.6652) < 0.01, f"VaR {var}, ES {es}")
    comp = rk.component_es(torch.randn((1_048_576, 4), generator=gen, device=dev), 0.975)
    check(abs(comp["components"].sum().item() - comp["total_es"].item()) < 1e-4,
          f"component ES {comp}")
    opt_var = rk.option_var(lambda s: bs_price(s, 100.0, 0.5, 0.03, 0.25, 1.0, 0.0), 100.0, 0.05,
                            0.25, torch.Generator(device=dev).manual_seed(6), 0.99,
                            n_paths=1_048_576)
    on_card(pnl, opt_var)
    market = RiskFrame(underlying_price=book256.spot, strike=book256.strike,
                       maturity=book256.maturity, historical_volatility=book256.vol)

    def price_frame(f):
        return bs_price(f["underlying_price"], f["strike"], f["maturity"], RATE,
                        f["historical_volatility"], book256.cp, 0.0)

    rows = rk.StressTester(price_frame).run_scenarios(
        market, [rk.StressScenario("crash", "underlying_price", -0.2),
                 rk.StressScenario("vol", "historical_volatility", 0.1, relative=False)])
    rows = rows if isinstance(rows, list) else rows.to_dict("records")
    check(len(rows) == 2 and all(math.isfinite(r["es95"]) for r in rows), f"stress {rows}")
    sens = rk.SensitivityAnalysis(price_frame).compute_all(market)
    cf = bs_greeks(book256.spot, book256.strike, book256.maturity, RATE, book256.vol,
                   book256.cp, 0.0)
    s_err = float(np.max(np.abs(sens["delta"] - cf["delta"].cpu().numpy())))
    check(s_err < 2e-3, f"FD delta off the closed form by {s_err}")
    pf = rk.OptionsPortfolio(device=dev)
    qty = np.where(np.arange(RK_FDM_BOOK) % 3 == 0, -1.0, 2.0)
    for i in range(RK_FDM_BOOK):
        pf.add_position(rk.Position(qty[i], *(float(x[i]) for x in args),
                                    "call" if book256.cp[i] > 0 else "put",
                                    float(book256.dividend[i])))
    agg = record(f"portfolio aggregate_greeks {RK_FDM_BOOK} positions", pf.aggregate_greeks)
    cfq = bs_greeks(*args, book256.cp, book256.dividend)
    worst = 0.0
    for k in ("price", "delta", "gamma", "vega", "theta", "rho", "vanna", "vomma", "charm"):
        want = float((torch.as_tensor(qty, device=dev, dtype=torch.float32) * cfq[k]).sum())
        rel = abs(agg[k] - want) / max(abs(want), 1.0)
        worst = max(worst, rel)
        check(rel < 1e-4, f"portfolio {k} {agg[k]} vs the sum of bs_greeks {want}")
    log("risk", f"historical VaR/ES 99% of N(0,1) {var:.4f}/{es:.4f}; option VaR "
                f"{opt_var.item():.4f}; stress worst {min(r['worst_pnl'] for r in rows):.3f}; "
                f"FD delta vs closed form {s_err:.1e}; portfolio Greeks vs the sum of "
                f"bs_greeks {worst:.1e} relative")
    wall = time.perf_counter() - t_phase
    log("risk", f"phase wall {wall:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in spent.items())
        + f", oracles and the rest {wall - sum(spent.values()):.1f} s")
    return stats


def phase_risk_server(dev) -> None:
    """/xva over a socket at its defaults for every model, two 400s, and the
    404's list of routes."""
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for model in XVA_MODELS:
            t0 = time.perf_counter()
            status, out = _request(base + "/xva", rk_xva_body(model))
            check(status == 200 and len(out["ee"]) == RK_XVA[1] and out["cva"] > 0,
                  f"/xva {model}: {status} {out}")
            log("risk", f"/xva {model}: {out.get('engine', 'closed form')} EPE "
                        f"{out['epe']:.4f} CVA {out['cva']:.5f} in "
                        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
        for body in ({"model": "garch"}, {"model": "bates", "heston_params": {"v0": 0.05}}):
            try:
                _request(base + "/xva", body)
                check(False, f"/xva {body} answered 200")
            except urllib.error.HTTPError as e:
                check(e.code == 400, f"/xva {body} answered {e.code}")
        try:
            _request(base + "/nope")
            check(False, "an unknown route answered 200")
        except urllib.error.HTTPError as e:
            check(e.code == 404 and "/xva" in json.loads(e.read())["endpoints"],
                  f"the 404 does not list /xva: {e.code}")
    finally:
        server.stop()



# ---------------------------------------------------------------------------
# the chain-to-surface slice: the SVI/SSVI/eSSVI surfaces, the chain data
# layer without pandas, chain calibration and /calibrate
# ---------------------------------------------------------------------------
SF_CBOE = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "cboe_spx_quotedata.csv"
SF_SPOT, SF_RATE = 5123.41, 0.043  # the CBOE file's header and the reference tests' rate
SF_SYNTH = 8192  # quotes of the SPX-sized synthetic chain
SF_SYNTH_NOISE = 0.004  # its vol noise (generate_synthetic_chain's default)
SF_PDE = ((100.0, 1.0), (90.0, 0.5), (110.0, 1.5))  # tests/test_chain_calibration.py:103
SF_PDE_TOL = 4e-3
SF_LV_MC = LV_MAIN  # the local-vol kernel's bench shape: 31 blocks, 8,126,464 paths x 100
# iv_rmse bounds: tests/test_chain_calibration.py:201, :211 and :228; rough
# Bergomi has no reference test, so its bound is this slice's own
SF_MODEL_BOUNDS = {"heston": 0.012, "bates": 0.015, "heston-mc": 0.2, "rbergomi": 0.04}
SF_KERNELS = {"gbm_mc": gk._gbm_moments_cuda, "exotic_mc": ek._exotic_moments_cuda,
              "exotic_greeks": ek._exotic_greeks_cuda, "heston_mc": hk._heston_mc_cuda,
              "heston_qe": hk._heston_qe_cuda, "heston_qe_ladder": hk._heston_qe_ladder_cuda,
              "heston_chain": hk._heston_chain_cuda, "heston_exotic": hx._heston_exotic_cuda,
              "local_vol_mc": lk._lv_cuda, "slv_mc": sk._slv_cuda,
              "multi_asset_mc": mk._ma_cuda, "tridiag": tri._tridiag_cuda,
              "theta_pde": tp._theta_cuda}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    return {name: fn.launches for name, fn in SF_KERNELS.items()}


def _loss_key(fn):
    """The user loss inside the Adam loop's wrappers (their closures): its
    code, which a closure made anew each call shares, and whether it is a
    module-level function."""
    while getattr(fn, "__closure__", None):
        inner = [c.cell_contents for c in fn.__closure__ if callable(c.cell_contents)]
        if not inner:
            break
        fn = inner[0]
    return getattr(fn, "__code__", fn), "<locals>" not in getattr(fn, "__qualname__", "<locals>")


SF_STEP_KERNELS: dict = {}  # kernels an Adam step, by the code of a module-level loss


def adam_kernels(fn) -> int:
    """CUDA kernels of ``fn()``, a call made of Adam loops
    (``ops/optim._adam_loop``) and the work around them: profiled with every
    loop cut to one step, then with the loops of one loss at two steps, for
    each loss; the count is the first profile plus, per loop, its steps less
    one times its loss's kernels a step (each profile the most of two
    sessions). A module-level loss (the SVI, SSVI and eSSVI losses) keeps
    its kernels a step for later calls: they do not depend on the quotes."""
    from optionslab_tpu_torch.ops import optim

    real = optim._adam_loop
    state = {"twice": None, "loops": []}

    def cut(loss_fn, x0, n_steps, learning_rate, clip, project=None):
        key = _loss_key(loss_fn)
        state["loops"].append((key, int(n_steps)))
        return real(loss_fn, x0, 2 if key == state["twice"] else 1, learning_rate, clip,
                    project)

    def run():
        state["loops"] = []
        fn()

    optim._adam_loop = cut
    try:
        base = cuda_kernels(run, 2)
        loops = list(state["loops"])
        total = base
        for key in {k for k, _ in loops}:
            mine = [n for k, n in loops if k == key]
            per_step = SF_STEP_KERNELS.get(key)
            if per_step is None:
                state["twice"] = key
                per_step = (cuda_kernels(run, 2) - base) / len(mine)
                if key[1]:
                    SF_STEP_KERNELS[key] = per_step
            total += sum(n - 1 for n in mine) * per_step
    finally:
        optim._adam_loop = real
    return int(round(total))


def warm_call(name: str, fn, warm, kernels, stats: dict, card: str):
    """``warm()``, then one timed call of ``fn`` (its result), then its CUDA
    kernel count; returns (result, the kernels' launches in that call)."""
    warm()
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    n = kernels()
    stats[name] = (ms, n)
    log("surface", f"{name}: warm wall {ms:.1f} ms, {n} CUDA kernels"
                   f"{' (profiler saw none: not measured)' if n == 0 else ''}, kernel launches "
                   f"{launched or 'none'} [{card}]")
    return out, launched


def vendor_chain(dev):
    """The CBOE file whole, filtered as ``tests/test_real_chain_workflow.py:
    122-130``, every 7th quote held out: (held table, used dataset)."""
    from optionslab_tpu_torch.data import OptionChainDataset, OptionChainLoader

    ch = (OptionChainLoader.from_cboe(SF_CBOE, rate=SF_RATE, device=dev)
          .filter_liquidity(max_spread_pct=0.5).filter_moneyness(0.85, 1.2))
    rows = np.arange(len(ch))
    return ch.table.take(rows % 7 == 0), OptionChainDataset(ch.table.take(rows % 7 != 0), dev)


def phase_surface(dev, card: str) -> dict:
    """The chain-to-surface slice on the card at full width, with no pandas:
    the vendor chain's eSSVI calibration and its held-out vols, an SPX-sized
    synthetic chain through ``calibrate_chain`` at its defaults, the Dupire
    surface of that fit (its PDE and the local-vol kernel against
    Black–Scholes), the four dynamic-model fits at their defaults,
    ``mc_convergence_study`` and ``validate_pricer``. Returns
    {"stats": {call: (ms, kernels)}, "chain": heston_chain launches,
    "lv": local-vol kernel calls}."""
    from optionslab_tpu_torch.data import ColumnTable, generate_synthetic_chain
    from optionslab_tpu_torch.models import validation as mval
    from optionslab_tpu_torch.models.black_scholes import bs_price
    from optionslab_tpu_torch.surface import chain_calibration as cc

    t_phase = time.perf_counter()
    stats, lv_calls = {}, 0

    # the vendor chain: tests/test_real_chain_workflow.py:122-157
    held, used = vendor_chain(dev)
    check(isinstance(used.df, ColumnTable), "without pandas .df must be the column table")
    kw = dict(n_expiry_bins=6, from_prices=True, n_steps=400, essvi=True)
    res, _ = warm_call(
        f"calibrate_chain CBOE {len(used)} quotes, 6 bins, 400 steps, eSSVI",
        lambda: cc.calibrate_chain(used, **kw),
        lambda: cc.calibrate_chain(used, **{**kw, "n_steps": 5, "essvi": False}),
        lambda: adam_kernels(lambda: cc.calibrate_chain(used, **kw)), stats, card)
    t = np.asarray(held["time_to_maturity"], np.float64)
    k = np.log(np.asarray(held["strike_price"], np.float64) / (SF_SPOT * np.exp(SF_RATE * t)))
    iv_fn = cc.svi_surface_iv_fn(res)
    fitted = iv_fn(torch.tensor(k, dtype=torch.float32, device=dev),
                   torch.tensor(t, dtype=torch.float32, device=dev))
    on_card(fitted, res.svi_params[0].a, res.essvi.theta)
    err = np.abs(fitted.cpu().numpy() - np.asarray(held["implied_volatility"], np.float64))
    rep = res.report
    check(res.ssvi_rmse_vol < 0.01, f"vendor SSVI rmse {res.ssvi_rmse_vol}")
    check(rep["arbitrage_free"] and rep["ssvi_butterfly_free"]
          and rep["calendar_violation_rate"] == 0.0, f"vendor report {rep}")
    check(res.essvi_rmse_vol <= res.ssvi_rmse_vol + 1e-4 and rep["essvi_arbitrage_free"],
          f"vendor eSSVI {res.essvi_rmse_vol} vs SSVI {res.ssvi_rmse_vol}, {rep}")
    check(np.median(err) < 0.008 and np.quantile(err, 0.9) < 0.02,
          f"held-out IV error median {np.median(err)}, p90 {np.quantile(err, 0.9)}")
    log("surface", f"CBOE: {len(used)} quotes used, {len(held)} held out; slice rmse "
                   f"{np.array2string(res.svi_rmse_vol, precision=5)}, SSVI "
                   f"{res.ssvi_rmse_vol:.5f}, eSSVI {res.essvi_rmse_vol:.5f}; held-out IV "
                   f"error median {np.median(err):.5f}, p90 {np.quantile(err, 0.9):.5f}")

    # an SPX-sized synthetic chain through calibrate_chain at its defaults
    chain = generate_synthetic_chain(n_rows=SF_SYNTH, seed=0, noise=SF_SYNTH_NOISE, device=dev)
    check(isinstance(chain, ColumnTable), "without pandas the synthetic chain is a table")
    synth, _ = warm_call(
        f"calibrate_chain synthetic {SF_SYNTH} quotes, defaults (6 bins, 600 steps)",
        lambda: cc.calibrate_chain(chain, device=dev),
        lambda: cc.calibrate_chain(chain, n_steps=5, device=dev),
        lambda: adam_kernels(lambda: cc.calibrate_chain(chain, device=dev)), stats, card)
    check(len(synth.svi_params) == 6 and bool(np.all(synth.svi_rmse_vol < 2.5 * SF_SYNTH_NOISE)),
          f"synthetic slice rmse {synth.svi_rmse_vol}")
    check(bool(np.all(np.diff(synth.thetas) > 0)) and synth.report["arbitrage_free"],
          f"synthetic thetas {synth.thetas}, report {synth.report}")
    log("surface", f"synthetic: slice rmse {np.array2string(synth.svi_rmse_vol, precision=5)} "
                   f"(noise {SF_SYNTH_NOISE}), SSVI {synth.ssvi_rmse_vol:.5f}, thetas "
                   f"{np.array2string(synth.thetas, precision=5)}")

    # the Dupire surface of that fit at local_vol_from_chain's defaults
    (lv, _), _ = warm_call("local_vol_from_chain 121 x 60",
                           lambda: cc.local_vol_from_chain(None, result=synth),
                           lambda: cc.local_vol_from_chain(None, result=synth, n_k=11, n_t=6),
                           lambda: cuda_kernels(lambda: cc.local_vol_from_chain(
                               None, result=synth)), stats, card)
    on_card(lv.surface.grid)
    check(bool(torch.isfinite(lv.surface.grid).all()), "non-finite local vol")
    surf_iv = cc.svi_surface_iv_fn(synth)
    bs_at = {}
    for strike, mat in SF_PDE:
        kf = math.log(strike / (synth.spot * math.exp(synth.rate * mat)))
        vol = float(surf_iv(kf, mat))
        bs_at[(strike, mat)] = float(bs_price(synth.spot, strike, mat, synth.rate, vol, 1.0))
        pde, launched = warm_call(f"DupireLocalVol.price K={strike} T={mat} (201 x 200)",
                                  lambda s=strike, m=mat: lv.price(synth.spot, s, m),
                                  lambda: None, lambda s=strike, m=mat: linear_kernels(
                                      lambda n: lv._solve(s, m, 1.0, n_time=n), 200),
                                  stats, card)
        check(launched.get("tridiag", 0) == 200, f"the PDE made {launched} launches, not 200 "
                                                 "tridiagonal solves")
        gap = abs(float(pde) / bs_at[(strike, mat)] - 1.0)
        check(gap < SF_PDE_TOL, f"PDE K={strike} T={mat}: {float(pde)} vs BS "
                                f"{bs_at[(strike, mat)]} ({gap})")
    pricer = lk.LocalVolKernelPricer(lv, 1.0, n_steps=SF_LV_MC[1])
    (p, se, paths), launched = warm_call(
        f"LocalVolKernelPricer.price on the chain's surface {SF_LV_MC[0]} x {SF_LV_MC[1]}",
        lambda: pricer.price(100.0, n_paths=SF_LV_MC[0]),
        lambda: pricer.price(100.0, n_paths=SF_LV_MC[0], seed=1),
        lambda: cuda_kernels(lambda: pricer.price(100.0, n_paths=SF_LV_MC[0])), stats, card)
    lv_calls += 3  # the warm-up, the timed call and the profiled one
    check(launched == {"local_vol_mc": 1}, f"the LV price made launches {launched}")
    want = bs_at[(100.0, 1.0)]
    check(abs(float(p) - want) < 4 * float(se) + SF_PDE_TOL * want,
          f"LV kernel {float(p)} ± {float(se)} vs BS at the surface vol {want}")
    log("surface", f"LV kernel on the chain's surface: {float(p):.5f} ± {float(se):.5f} "
                   f"({paths} paths) vs BS at the surface vol {want:.5f}")

    # the dynamic-model fits at their defaults
    for model, bound in SF_MODEL_BOUNDS.items():
        out, launched = warm_call(
            f"calibrate_model_to_chain {model} (defaults)",
            lambda m=model: cc.calibrate_model_to_chain(chain, m, device=dev),
            lambda m=model: cc.calibrate_model_to_chain(chain, m, n_steps=2, device=dev),
            lambda m=model: adam_kernels(lambda: cc.calibrate_model_to_chain(chain, m,
                                                                             device=dev)),
            stats, card)
        if model == "heston-mc":
            check(launched == {"heston_chain": 202},
                  f"heston-mc fit made launches {launched}, not 202 chain launches")
        else:
            check("heston_chain" not in launched, f"{model} launched the chain kernel")
        check(math.isfinite(out["loss"]) and out["iv_rmse"] < bound,
              f"{model}: iv_rmse {out['iv_rmse']} (bound {bound}), {out}")
        log("surface", f"{model}: {out['n_quotes']} quotes, iv_rmse {out['iv_rmse']:.5f} "
                       f"(bound {bound}), params {out['params']}")

    # models/validation at their defaults
    mc, _ = warm_call("mc_convergence_study (defaults)",
                      lambda: mval.mc_convergence_study(device=dev),
                      lambda: mval.mc_convergence_study(path_counts=(1000, 2000), device=dev),
                      lambda: cuda_kernels(lambda: mval.mc_convergence_study(device=dev)),
                      stats, card)
    check(mc["converged"] and abs(mc["stderr_slope"] + 0.5) < 0.15, f"MC study {mc}")

    def bs_fn(s, k_, t_, r, sig, cp, q):
        return bs_price(*(torch.tensor(x, dtype=torch.float64, device=dev)
                          for x in (s, k_, t_, r, sig)), cp, q)

    audit, _ = warm_call("validate_pricer(bs_price) (defaults)",
                         lambda: mval.validate_pricer(bs_fn), lambda: None,
                         lambda: cuda_kernels(lambda: mval.validate_pricer(bs_fn)), stats, card)
    check(audit["passed"], f"validate_pricer {audit}")
    log("surface", f"MC study slope {mc['stderr_slope']:.4f}; validate_pricer parity max "
                   f"error {audit['parity']['max_error']:.3e}; phase "
                   f"{time.perf_counter() - t_phase:.1f} s")
    return {"stats": stats, "lv": lv_calls,
            "body": {c: np.asarray(chain[c], np.float64).tolist() for c in
                     ("underlying_price", "strike_price", "time_to_maturity",
                      "implied_volatility")} | {"risk_free_rate": float(synth.rate)}}


def phase_surface_server(dev, body: dict, card: str) -> None:
    """/calibrate at its defaults on the synthetic chain's columns: through
    the handler, then over a socket; a 400 for a bad body."""
    from optionslab_tpu_torch.server import handle_calibrate

    stats = {}
    out, _ = warm_call(f"/calibrate handler {len(body['strike_price'])} quotes (defaults: 4 "
                       "bins, 400 steps)", lambda: handle_calibrate(body, dev),
                       lambda: handle_calibrate({**body, "n_steps": 5}, dev),
                       lambda: adam_kernels(lambda: handle_calibrate(body, dev)), stats, card)
    check(len(out["svi_params"]) == 4 and max(out["svi_rmse_vol"]) < 2.5 * SF_SYNTH_NOISE
          and out["report"]["arbitrage_free"], f"/calibrate handler: {out}")
    server = PricingServer(port=0, device=dev).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        t0 = time.perf_counter()
        status, got = _request(base + "/calibrate", body)
        ms = (time.perf_counter() - t0) * 1e3
        check(status == 200 and got["n_quotes"] == out["n_quotes"]
              and got["report"]["arbitrage_free"], f"/calibrate: {status} {got}")
        log("surface", f"/calibrate over a socket: {ms:.0f} ms, slice rmse "
                       f"{got['svi_rmse_vol']} [{card}]")
        bad = {k: v for k, v in body.items() if k != "implied_volatility"}
        try:
            _request(base + "/calibrate", bad)
            check(False, "/calibrate without implied_volatility answered 200")
        except urllib.error.HTTPError as e:
            check(e.code == 400 and "ValidationError" in json.loads(e.read())["error"],
                  f"/calibrate bad body answered {e.code}")
    finally:
        server.stop()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    log("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    _build.load_library()
    n_src = len(list(_build.CSRC.glob("*.cu")))
    log("build", f"{_build.LIB_NAME} ready in {_build.build_seconds():.1f} s "
                 f"({n_src} sources, one nvcc each, in parallel)")

    gbm_err = phase_parity(dev)
    mc_err, greeks_err = phase_exotic_parity(dev)
    h_err = phase_heston_parity(dev)
    hx_err = phase_hx_parity(dev)
    lv_err, slv_err = phase_smile_parity(dev)
    ma_err = phase_ma_parity(dev)
    tri_err, tri_t, node_ms = phase_tridiag(dev, card)
    theta_err, theta_t = phase_theta(dev, card, node_ms)

    # the GBM path: counts set to 0 just before it, read just after it
    gk._gbm_moments_cuda.launches = 0
    main_stats = phase_main(dev, card)
    n_mc = phase_server(dev)
    gbm_launches = gk._gbm_moments_cuda.launches
    expected = main_stats["calls"] + n_mc
    log("launches", f"gbm_mc launched {gbm_launches} times for {expected} kernel-route calls")
    if gbm_launches < expected:
        raise AssertionError(f"GBM path launched its kernel {gbm_launches} < {expected} times")

    # the exotic path
    ek._exotic_moments_cuda.launches = 0
    ek._exotic_greeks_cuda.launches = 0
    calls = phase_exotic_main(dev, card)
    served = phase_exotic_server(dev)
    mc_launches = ek._exotic_moments_cuda.launches
    greeks_launches = ek._exotic_greeks_cuda.launches
    for name, n, want in (("exotic_mc", mc_launches, calls["mc"] + served["mc"]),
                          ("exotic_greeks", greeks_launches, calls["greeks"] + served["greeks"])):
        log("launches", f"{name} launched {n} times for {want} kernel-route calls")
        if n < want or n == 0:
            raise AssertionError(f"exotic path launched {name} {n} < {want} times")

    # the Heston European path
    h_fns = {"mc": hk._heston_mc_cuda, "qe": hk._heston_qe_cuda,
             "qe_ladder": hk._heston_qe_ladder_cuda, "chain": hk._heston_chain_cuda}
    h_se = heston_greek_stderrs(dev)
    for fn in h_fns.values():
        fn.launches = 0
    h_calls = phase_heston_main(dev, card, h_se)
    phase_heston_server(dev)
    h_launches = {key: fn.launches for key, fn in h_fns.items()}
    for key, n in h_launches.items():
        log("launches", f"heston_{key} launched {n} times for {h_calls[key]} kernel-route calls")
        check(n == h_calls[key] and n > 0, f"Heston path launched heston_{key} {n} times, "
                                           f"not {h_calls[key]}")

    # the Heston/Bates exotic path
    hx_se = hx_lr_stderrs(dev)
    hx._heston_exotic_cuda.launches = 0
    hx_calls = phase_hx_main(dev, card, hx_se) + phase_hx_server(dev)
    hx_launches = hx._heston_exotic_cuda.launches
    log("launches", f"heston_exotic launched {hx_launches} times for {hx_calls} kernel-route calls")
    check(hx_launches == hx_calls and hx_launches > 0,
          f"Heston exotic path launched its kernel {hx_launches} times, not {hx_calls}")

    # the smile path: local vol, then SLV
    smile_se = smile_greek_stderrs(dev)
    smile_calls = {"lv": 0, "slv": 0}
    lk._lv_cuda.launches = 0
    sk._slv_cuda.launches = 0
    phase_lv_main(dev, card, smile_se, smile_calls)
    phase_slv_main(dev, card, smile_se, smile_calls)
    lv_served, slv_served = phase_smile_server(dev)
    lv_launches, slv_launches = lk._lv_cuda.launches, sk._slv_cuda.launches
    for name, n_l, want in (("local_vol_mc", lv_launches, smile_calls["lv"] + lv_served),
                            ("slv_mc", slv_launches, smile_calls["slv"] + slv_served)):
        log("launches", f"{name} launched {n_l} times for {want} kernel-route calls")
        check(n_l == want and n_l > 0, f"smile path launched {name} {n_l} times, not {want}")

    # the multi-asset path
    ma_se = ma_greek_stderrs(dev)
    ma_calls = {"ma": 0}
    mk._ma_cuda.launches = 0
    phase_ma_main(dev, card, ma_se, ma_calls)
    ma_served = phase_ma_server(dev)
    ma_launches, ma_want = mk._ma_cuda.launches, ma_calls["ma"] + ma_served
    log("launches", f"multi_asset_mc launched {ma_launches} times for {ma_want} kernel-route calls")
    check(ma_launches == ma_want and ma_launches > 0,
          f"multi-asset path launched its kernel {ma_launches} times, not {ma_want}")

    funcs = load_sass()
    gbm_t = phase_timing(dev)
    for tag, t in gbm_t.items():
        t["bound_ms"], t["bound_by"] = kernel_bound(funcs, ("gbm_mc_kernelILi0ELb1E",),
                                                    nest((1, 1)), t, f"gbm_mc {tag}")
    ex_t = exotic_timing(dev)
    names = {"asian_arith 4Mx252": ("exotic_mc_kernelILi0ELb0ELi0E",),
             "barrier LR 16Mx64": ("exotic_mc_kernelILi4ELb1ELi0E",),
             "greeks asian_geo 8Mx252": ("exotic_greeks_kernelILi1ELi0E",)}
    for tag, t in ex_t.items():
        t["bound_ms"], t["bound_by"] = kernel_bound(funcs, names[tag], nest((1, 1)), t, tag)
    h_t = heston_timing(dev)
    for tag, t in h_t.items():
        t["bound_ms"], t["bound_by"] = kernel_bound(funcs, *HESTON_SASS[heston_sass_key(tag)], t,
                                                    tag)
    qe_ladder_report(funcs, h_timing(h_t, "heston_qe_ladder prng"))
    hx_t = hx_timing(dev)
    for tag, t in hx_t.items():
        (key,) = [k_ for k_ in HX_SASS if tag.startswith(k_)]
        t["bound_ms"], t["bound_by"] = kernel_bound(funcs, *HX_SASS[key], t,
                                                    f"heston_exotic {tag}")
    smile_t = smile_timing(dev)
    for tag, t in smile_t.items():
        key = next(k_ for k_ in sorted(SMILE_SASS, key=len, reverse=True)
                   if tag.startswith(k_))
        t["bound_ms"], t["bound_by"] = kernel_bound(funcs, *SMILE_SASS[key], t, tag)
    ma_t = ma_timing(dev)
    for tag, t in ma_t.items():
        t["bound_ms"], t["bound_by"] = (kernel_bound(funcs, t["sass"], _MA_NEST, t, tag)
                                        if t["sass"] else (float("nan"), "not counted"))
    ma_report(funcs, ma_t)
    # the pricers without a kernel: they launch none of the eleven kernels
    kernel_fns = (gk._gbm_moments_cuda, ek._exotic_moments_cuda, ek._exotic_greeks_cuda,
                  hk._heston_mc_cuda, hk._heston_qe_cuda, hk._heston_qe_ladder_cuda,
                  hk._heston_chain_cuda, hx._heston_exotic_cuda, lk._lv_cuda, sk._slv_cuda,
                  mk._ma_cuda)
    before = [fn.launches for fn in kernel_fns]
    # the PDE path: every solve of the pricers and of the slice is one launch
    # of the tridiagonal kernel
    tri._tridiag_cuda.launches = 0
    tp._theta_cuda.launches = 0
    phase_pricers(dev, card)
    phase_pricers_server(dev)
    check([fn.launches for fn in kernel_fns] == before,
          "the pricers without a kernel launched one of the eleven kernels")
    phase_slice(dev, card)
    phase_slice_server(dev)
    check([fn.launches for fn in kernel_fns] == before,
          "the slice launched one of the eleven Monte Carlo kernels")
    pde_before = (tri._tridiag_cuda.launches, tp._theta_cuda.launches)
    phase_risk(dev, card)
    phase_risk_server(dev)
    check([fn.launches for fn in kernel_fns] == before,
          "the risk engine launched one of the eleven Monte Carlo kernels")
    risk_tri = tri._tridiag_cuda.launches - pde_before[0]
    risk_theta = tp._theta_cuda.launches - pde_before[1]
    log("launches", f"the risk engine's share: tridiag {risk_tri}, theta_pde {risk_theta}")
    check(risk_theta > 0, "greeks_fdm never launched the θ-scheme kernel")
    # the chain-to-surface slice, with pandas unimportable (the card's machine
    # has none): heston_chain, local_vol_mc and tridiag launch, nothing else
    # of the Monte Carlo kernels
    had_pandas = sys.modules.get("pandas", False)
    sys.modules["pandas"] = None
    try:
        sf_before = launch_counts()
        surf = phase_surface(dev, card)
        phase_surface_server(dev, surf["body"], card)
    finally:
        if had_pandas is False:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = had_pandas
    sf_after = launch_counts()
    sf_launches = {k: sf_after[k] - sf_before[k] for k in sf_after}
    log("launches", f"the surface slice's share: {sf_launches}")
    check(sf_launches["heston_chain"] >= 202, "the heston-mc fit never ran its 202 launches")
    check(sf_launches["local_vol_mc"] == surf["lv"],
          f"local_vol_mc launched {sf_launches['local_vol_mc']} times for {surf['lv']} calls")
    check(sf_launches["tridiag"] > 0, "the chain's Dupire PDE never launched tridiag")
    check(all(n == 0 for k, n in sf_launches.items()
              if k not in ("heston_chain", "local_vol_mc", "tridiag")),
          f"the surface slice launched another kernel: {sf_launches}")
    tri_launches = tri._tridiag_cuda.launches
    log("launches", f"tridiag launched {tri_launches} times over the pricers, the slice and "
                    "the risk engine")
    check(tri_launches > 0, "the PDE path never launched the tridiagonal kernel")
    theta_launches = tp._theta_cuda.launches
    log("launches", f"theta_pde launched {theta_launches} times over the pricers, the slice and "
                    "the risk engine")
    check(theta_launches > 0, "the PDE path never launched the θ-scheme kernel")
    for tag, t in (list(gbm_t.items()) + list(ex_t.items()) + list(h_t.items())
                   + [(f"heston_exotic {k_}", v) for k_, v in hx_t.items()]
                   + list(smile_t.items()) + list(ma_t.items())):
        sampler = "hash residuals" if "sobol_bb" in tag else "sobol" if "sobol" in tag else "prng"
        how = "a CUDA graph of calls" if "back_to_back_ms" in t else "CUDA events"
        log("timing", f"{tag} {sampler}, device ms by {how} [{card}]: kernel {t['ms']:.4f}, "
                      f"plain torch {t.get('plain_ms', float('nan')):.3f}, bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']})")

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": f"optionslab_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("gbm_mc_kernel", "gbm_mc.cu", "optionslab_tpu/ops/gbm_pallas.py:104",
              gbm_launches, gbm_err, gbm_t["1024x1e6"]),
        entry("exotic_mc_kernel", "exotic_mc.cu", "optionslab_tpu/ops/exotic_pallas.py:150",
              mc_launches, mc_err, ex_t["asian_arith 4Mx252"]),
        entry("exotic_greeks_kernel", "exotic_greeks.cu",
              "optionslab_tpu/ops/exotic_pallas.py:1315", greeks_launches, greeks_err,
              ex_t["greeks asian_geo 8Mx252"]),
        entry("heston_mc_kernel", "heston_mc.cu", "optionslab_tpu/ops/heston_pallas.py:59",
              h_launches["mc"], h_err["mc"], h_timing(h_t, "heston_mc price prng")),
        entry("heston_qe_kernel", "heston_qe.cu", "optionslab_tpu/ops/heston_pallas.py:280",
              h_launches["qe"], h_err["qe"], h_timing(h_t, "heston_qe prng")),
        entry("heston_qe_ladder_kernel", "heston_qe.cu",
              "optionslab_tpu/ops/heston_pallas.py:365", h_launches["qe_ladder"],
              h_err["qe_ladder"], h_timing(h_t, "heston_qe_ladder prng")),
        entry("heston_chain_kernel", "heston_chain.cu", "optionslab_tpu/ops/heston_pallas.py:469",
              h_launches["chain"] + sf_launches["heston_chain"], h_err["chain"],
              h_timing(h_t, "heston_chain prng 40")),
        entry("heston_exotic_kernel", "heston_exotic.cu",
              "optionslab_tpu/ops/heston_pallas.py:1079", hx_launches, hx_err,
              hx_t[f"asian_arith {HX_MAIN[0]}x{HX_MAIN[1]}"]),
        entry("local_vol_mc_kernel", "local_vol_mc.cu",
              "optionslab_tpu/ops/local_vol_pallas.py:64",
              lv_launches + sf_launches["local_vol_mc"], lv_err,
              smile_t[f"local_vol european {LV_MAIN[0]}x{LV_MAIN[1]}"]),
        entry("slv_mc_kernel", "slv_mc.cu", "optionslab_tpu/ops/slv_pallas.py:106", slv_launches,
              slv_err, smile_t[f"slv barrier {SLV_MAIN[0]}x{SLV_MAIN[1]}"]),
        entry("multi_asset_mc_kernel", "multi_asset_mc.cu",
              "optionslab_tpu/ops/multi_asset_pallas.py:58", ma_launches, ma_err,
              ma_t[f"multi_asset basket_asian {MA_PRICE[0]}x{MA_PRICE[1]}"]),
        {**entry("tridiag_kernel", "tridiag.cu",
                 "optionslab_tpu/ops/tridiag.py:15 (lax.scan, no Pallas kernel)", tri_launches,
                 tri_err, tri_t["101x201 float32"]),
         "library_ms": tri_t["101x201 float32"]["library_ms"],
         "chain_ms": tri_t["101x201 float32"]["chain_ms"]},
        {**entry("theta_pde_kernel", "theta_pde.cu",
                 "optionslab_tpu/models/fdm.py:162 (lax.scan) and :101 (fori_loop), no Pallas "
                 "kernel", theta_launches, theta_err, theta_t["howard θ=0.5 float32"]),
         "chain_ms": theta_t["howard θ=0.5 float32"]["chain_ms"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
