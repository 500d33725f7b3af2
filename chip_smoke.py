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
15. tridiag — the three chain probes of ``csrc/tridiag.cu`` (a node of the
              pivots' chain; a node of the right-hand side's chain on a
              reciprocal formed once; the second probe with no forward node,
              a back node alone; a dependent FMA on shared-memory operands,
              the θ-scheme reverse's node), each bitwise its plain loop; the
              division check: the fast quotient of ``tridiag.cuh`` against
              the division intrinsic and torch's division on 2^24 seeded
              pairs a dtype over the exponent range and every pair of an
              edge list (zeros, subnormal quotients, the ends of the range,
              infinities, NaN, the pivot guard's 2e-30 and 1e-30, all-ones
              significands), bitwise; then
              the batched tridiagonal kernel (``csrc/tridiag.cu``) against
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
              through it, one launch a solve);
16. slice   — the Heston ADI (201 x 101 x 200, one launch of the ADI kernel
              a price and no tridiagonal launch; the Greeks two and one
              launch of its reverse kernel) against Lewis, the
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
              the longest chain of a CUDA block (its pivot nodes at the pivot
              probe's node, its solves on the tables at the right-hand-side
              probe's, the rows a restarted Howard sweep keeps at a back
              node's), beside the old count (run before the pricers,
              after the tridiagonal phase; ``fdm_price`` then prices through
              it, one launch a call and no tridiagonal launch); then
              ``fdm_price``'s grid built on the card against the CPU's, bit
              for bit, at S0 = K (41, 81 and 201 nodes, float32 and
              float64), and the 41 x 40 American put on the card against
              the CPU's plain loop;
17a. adi    — the Douglas ADI kernel (``csrc/heston_adi.cu``) bit for bit
              against its plain loop (``ops/heston_adi.py``) in its four
              modes: European and American at 41 x 21 x 16 and 201 x 101 x
              200 (the grid and the history its reverse reads), Bermudan at
              50 and 25 dates x 8 steps (the continuation slices), SLV
              161 x 81 at 25 x 8 on seeded leverage rows, each on the
              thread-block cluster the plan takes there, and the four modes
              at 1001 x 201 x 16, where the plan takes the cooperative
              kernel; its reverse kernel's gradients of every input of
              ``_AdiLoop`` against the plain reverse and autograd through the
              plain loop, European and American, on the cluster of its own
              plan at 41 x 21 x 16 and 201 x 101 x 200 and on its
              cooperative route at 1001 x 201 x 16, one launch each and a
              second launch bit for bit the first; device ms of each kernel
              and plain version beside the chain bound, recounted and old;
              the forward's and the reverse's step fits on the cluster route
              (run after the θ-scheme phase, before the pricers);
17b. loops  — the θ-scheme reverse kernel (``theta_pde_adjoint_kernel``)
              at ``fdm_price``'s defaults, European, projection and Howard,
              float32 and float64: the forward with its history bit for bit
              the plain loop's, the ten gradients against the plain reverse
              within a stated bound, one launch and no tridiagonal launch,
              two launches bitwise; the same on hand-built exercise sets
              (each run of continuation rows on the LU tables, the UL
              tables or pivots of its own) and at the forward's longest
              grids on the device route; ``fdm_price``'s gradient one forward and
              one reverse launch, delta's sign, rho and dividend rho against
              central differences; the jump-table kernel
              (``theta_jump_kernel``, a warp a contract, each solve split
              over its lanes) on the dividend PDE (401 x 400, European,
              projection and Howard, float32 and float64, bit for bit its
              plain loop on the warp-partitioned solve; the public call one
              launch; the parity gap); the local-vol loop kernel
              (``csrc/lv_pde.cu``, the same solve, the steps' factors formed
              ahead by producer warps) bit for bit its plain loop for
              ``_lv_solve`` (201 x 200, European and American) and
              ``lv_bermudan_slices`` (401 x 25 dates x 8), float32 and
              float64, one launch a call and no tridiagonal launch, the flat
              surface against Black–Scholes; each kernel's device ms beside
              its plain loop's, its chain bound and the old count (run after
              the θ-scheme phase, before the pricers);

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
              American against the 2048-step lattice), one θ-scheme launch
              and one of its reverse a call; VaR/ES, component ES, option
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
              Black–Scholes at the surface's vol (one launch of the
              local-vol loop a price) and the local-vol kernel 8,126,464 x
              100 on it (one launch a call); ``calibrate_model_to_chain``
              heston, bates, heston-mc (exactly 202 chain launches) and
              rbergomi at their defaults; ``mc_convergence_study`` and
              ``validate_pricer``; each call's warm wall and CUDA kernels
              (the Adam loops counted from one- and two-step loops); then
              ``/calibrate`` through its handler and over a socket, and a
              400; no other Monte Carlo kernel launched.
20. learned — the learned surfaces, the pricing surrogate and ``optimize/``
              at the models' defaults, with ``pandas`` unimportable: on the
              CBOE chain (every 7th quote held out) ``MLPModel`` (held-out
              IV rmse below the constant predictor's, MC-dropout bands,
              input gradients), ``PINNVolatilityModel`` (the reference
              tests' fit and audit bounds) and a 4-member ensemble with its
              member selection, ``KernelRidgeModel``, the quote
              interpolator (rbf exact at the OTM smile's quotes, its
              ModelError on duplicate quotes; idw, nearest), the forests'
              DependencyError without scikit-learn, ``torch.export`` (loaded
              on the card and on the host) and ``.onnx`` exports held to the
              live MLP over batch sizes; ``MonteCarloMLSurrogate`` at its
              defaults (the reference's R² envelope, conformal coverage, its
              ``.onnx`` parity) and ``fit_to_pricer`` on one GBM kernel
              book launch of labels, each label within its error bound of
              ``bs_greeks``; a TPE study with a resume against Sobol, a
              surrogate study, and ``make_calibration_objective`` around
              ``calibrate_heston_mc`` (exactly Σ(n_steps + 2) chain
              launches); each fit's warm wall and CUDA kernels (counted
              from one- and two-epoch loops, ``cut_kernels``); gbm_mc and
              heston_chain launch, nothing else.
21. cli     — the command line: every subcommand through
              ``optionslab_tpu_torch.cli.main`` in process at the reference's
              defaults on the card, with ``pandas`` unimportable: ``price``
              bs against Black–Scholes, fdm (one θ-scheme launch), the
              American put above the European, heston against Lewis;
              ``greeks --model heston|heston-qe`` against Lewis and ``mc
              --method pallas`` at 100,000 and 1e9 paths against
              Black–Scholes within 4 stderr; the ``iv`` round trip; ``exotic
              --cv`` against the plain Asian, the double kinds against their
              BGK-shifted closed forms, the pathwise ladder, the heston, lv
              and slv kernels; ``basket --engine kernel --kind geometric``
              against its closed form; ``varswap``'s LV and SLV strikes
              against the replication; ``var``; ``calibrate`` svi and
              heston-mc, ``surface``, ``bench-harness``; ``export`` (the
              ``.pt2`` reloaded on the card against the live model); the
              backtest's CUDA kernels equal at 253 and 1,009 prices;
              ``american`` bs and heston; ``xva``; ``book --model heston
              --greeks``; ``plot`` and ``report`` (a ``DependencyError``
              naming matplotlib in under a second where it is missing);
              ``info``; ``serve`` as a process answering ``/health`` and
              ``/price``. Each call's warm wall ms (a fit's first call) and
              CUDA kernels, and each kernel's launches.
22. parallel — ``parallel/`` on meshes of this card repeated 1, 2 and 4
              times (one card: the walls are the shard loop's host cost and
              the kernels, not an interconnect): every kernel route at its
              path's shape (GBM 1 x 1e9 and the 1024 x 1e6 book on a 2 x 2
              mesh, the exotic Asian and pathwise Greeks, the basket Asian
              and its ladder, Heston Euler, QE and the QE ladder, the Heston
              exotic Asian and barrier LR, local vol and SLV price and
              Greeks), one shard bit for bit the unsharded call, 2 and 4
              within the reference's sharded bounds, one launch a shard;
              ``sharded_mc_price`` 16 x 1e7 bit-identical on 1, 2 and 4
              shards; ``sharded_book_greeks`` 256 x 1e6 on 2 x 2 against
              ``mc_greeks`` on the same normals; VaR/ES of 8,388,608 samples
              equal to a global sort, Monte Carlo VaR against the closed
              form; the data-parallel PINN step on 4 shards against 1; each
              route's warm wall beside the unsharded call.

The last three lines are a JSON object of kernel measurements (the eleven
ported Pallas kernels, the tridiagonal, θ-scheme and ADI kernels, and the
chain probes and division check of ``csrc/tridiag.cu``), the
card's name and power limit, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import pathlib
import socket
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
from optionslab_tpu_torch.ops import heston_adi as ha
from optionslab_tpu_torch.ops import heston_exotic_kernel as hx
from optionslab_tpu_torch.ops import heston_kernel as hk
from optionslab_tpu_torch.ops import local_vol_kernel as lk
from optionslab_tpu_torch.ops import lv_pde as lvp
from optionslab_tpu_torch.ops import multi_asset_kernel as mk
from optionslab_tpu_torch.ops import slv_kernel as sk
from optionslab_tpu_torch.ops import theta_pde as tp
from optionslab_tpu_torch.ops.theta_cases import (THETA_REVERSE_RTOL, exercise_sets,
                                                  short_howard_step)
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


def clock_phases() -> None:
    """Wraps every ``phase_*`` function of this script so that it logs its
    seconds, and the seconds since this call, as it returns: where the run's
    1,200 s go (the host-bound phases vary most between machines)."""
    start = time.perf_counter()

    def clocked(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                now = time.perf_counter()
                log("clock", f"{name} {now - t0:.1f} s, {now - start:.1f} s since the start")
        return run

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = clocked(name, fn)


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


def kernel_launches(fns: list, calls: int, sessions: int = 3) -> dict:
    """CUDA kernels the profiler sees in ``calls`` calls of each of ``fns``
    in one profiler session, by name: for each name the most that one of
    ``sessions`` sessions saw. The profiler's CUDA records are not all
    delivered in every session: a run whose earlier phases had opened
    profiler sessions of thousands of launches saw 17 and 18 of these 25
    launches in one session (NVIDIA H100 80GB HBM3), and ``cuda_kernels``
    sees a few dozen go missing now and then. A lost record only lowers a
    count, so the most of a few sessions is the count; a launch too many or
    one missing in every session still shows."""
    out = {"multi_asset_kernel": 0, "reduce_rows_kernel": 0}
    for _ in range(sessions):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        seen = dict.fromkeys(out, 0)
        for e in prof.key_averages():
            for name in seen:
                if name in e.key:
                    seen[name] += e.count
        out = {name: max(out[name], seen[name]) for name in out}
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


def aten_ops(fn) -> int:
    """aten operators one call of ``fn`` dispatches, from the profiler's host
    records: an exact count, where the CUDA records of ``cuda_kernels`` gain
    or lose a few dozen a session."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))


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
    # one gradient: one forward launch with its history and one launch of
    # the reverse kernel, no tridiagonal launch
    def fdm_grad(n_time=200):
        leaves = [getattr(fbook, f).detach().requires_grad_(True) for f in FDM_FIELDS[:6]]
        price = fdm.fdm_price(ContractBatch(*leaves, fbook.cp), n_time=n_time)
        return torch.autograd.grad(price.sum(), leaves)

    grads = record("fdm_price european gradient 256x201x200", fdm_grad, iters=3)
    before = tp._theta_adjoint_cuda.launches
    got = loop_launches(fdm_grad)
    check(got == (1, 0) and tp._theta_adjoint_cuda.launches == before + 1,
          f"fdm_price gradient: {got} (θ-scheme, tridiag) launches and "
          f"{tp._theta_adjoint_cuda.launches - before} reverse launches, not (1, 0) and 1")
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


PROBE_CHECK_NODES = 512  # the probes against their plain loops (≈3,000 torch launches each)
WARP_PROBES = ("muladd", "stage", "fstage")  # tridiag_warp_probe_launch's kinds 0, 1, 2
PROBE_ABCD = (0.5, 3.0, -0.5, 1.0)  # lower, diagonal (the rhs probe's den), upper, rhs
FMA_ROW = 32  # the FMA probe's row for the reverse's walk (csrc/tridiag.cu kFmaRow)
DIV_PAIRS = 1 << 24  # the division check's seeded pairs a dtype


def probe_run(kind: str, dtype, dev, n_nodes: int, out: torch.Tensor) -> None:
    """One launch of a chain probe of ``csrc/tridiag.cu`` over ``n_nodes``
    nodes and as many back nodes: "pivot" the pivots' chain, "rhs" the
    right-hand side's chain on a reciprocal formed once; "back" the
    right-hand side's probe with no forward node, ``n_nodes`` back nodes;
    "fma" ``n_nodes`` nodes of a dependent FMA chain on shared-memory
    operands, no back node, by the θ-scheme reverse's own walk over a row of
    FMA_ROW nodes again and again (each pass a chain from 0 on the values
    the pass before stored); "fma ahead" one chain of ``n_nodes`` nodes,
    the next group's loads issued during a group's; the warp-partitioned
    solve's probe (csrc/tridiag.cu tridiag_warp_probe_kernel, one warp):
    "muladd" ``n_nodes`` nodes of its right-hand side's pass, "stage"
    ``n_nodes`` stages of its cyclic reduction, "fstage" ``n_nodes`` stages
    of the reduced system's factors."""
    key = (dtype, dev)
    if key not in probe_run.abcd:  # made once: a graph capture copies nothing
        probe_run.abcd[key] = torch.tensor(PROBE_ABCD, dtype=dtype, device=dev)
    abcd = probe_run.abcd[key]
    lib = _build.load_library()
    tail = (0 if dtype == torch.float32 else 1, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    if kind == "pivot":
        name = "tridiag_chain_launch"
        err = lib.tridiag_chain_launch(abcd.data_ptr(), out.data_ptr(), n_nodes, *tail)
    elif kind in WARP_PROBES:
        name = "tridiag_warp_probe_launch"
        err = lib.tridiag_warp_probe_launch(abcd.data_ptr(), out.data_ptr(), n_nodes,
                                            WARP_PROBES.index(kind), *tail)
    elif kind.startswith("fma"):
        name = "tridiag_fma_chain_launch"
        err = lib.tridiag_fma_chain_launch(abcd.data_ptr(), out.data_ptr(), n_nodes,
                                           int(kind == "fma ahead"), *tail)
    else:
        name = "tridiag_rhs_chain_launch"
        err = lib.tridiag_rhs_chain_launch(abcd.data_ptr(), out.data_ptr(),
                                           0 if kind == "back" else n_nodes, n_nodes, *tail)
    check(err == 0, f"{name} ({kind}) failed: {_build.error_string(err)}")
    probe_run.launches[{"back": "rhs", "fma ahead": "fma"}.get(
        kind, "warp" if kind in WARP_PROBES else kind)] += 1


probe_run.launches = {"pivot": 0, "rhs": 0, "fma": 0, "warp": 0}
probe_run.abcd = {}


def probe_plain(kind: str, dtype, dev, n_nodes: int) -> torch.Tensor:
    """The probe's chain as a plain torch loop on the card: the same
    roundings one torch op at a time (the pivot's guard as the solve's; the
    FMA probe's product m·prev is exact, m being a power of two, so one
    rounding of the sum is the FMA's)."""
    a, b, c, d = (torch.tensor(v, dtype=dtype, device=dev) for v in PROBE_ABCD)
    prev = torch.zeros((), dtype=dtype, device=dev)
    if kind in WARP_PROBES:  # one warp: (1, 32) rows, shuffles as tri._shfl_up/_shfl_down
        if kind == "muladd":
            rho = torch.ones_like(b) / b
            ell, q = a * rho, d * rho
            for _ in range(n_nodes):
                prev = q - ell * prev
            return prev
        lanes = torch.arange(32, dtype=dtype, device=dev)[None]
        if kind == "stage":
            k = a - a
            dd = d + lanes
            for i in range(n_nodes):
                s_ = 1 << (i % 5)
                dd = (dd - tri._shfl_up(dd, s_) * k) - tri._shfl_down(dd, s_) * k
            return dd[0, 0]
        ra, rb, rc = (x + 0.0 * lanes for x in (a, b, c))
        for i in range(n_nodes):
            s_ = 1 << (i % 5)
            k1 = ra / tri._shfl_up(rb, s_)
            k2 = rc / tri._shfl_down(rb, s_)
            ra, rb, rc = (-(tri._shfl_up(ra, s_) * k1),
                          (rb - tri._shfl_up(rc, s_) * k1) - tri._shfl_down(ra, s_) * k2,
                          -(tri._shfl_down(rc, s_) * k2))
        return rb[0, 0]
    if kind == "fma ahead":
        for _ in range(n_nodes):
            prev = -a * prev + d
        return prev
    if kind == "fma":  # m = −a·2⁻²⁰ (csrc/tridiag.cu tridiag_fma_chain_kernel)
        row, m = [d] * FMA_ROW, -a * 2.0 ** -20
        for _ in range(n_nodes // FMA_ROW):
            prev = torch.zeros((), dtype=dtype, device=dev)
            for i in range(FMA_ROW):
                prev = row[i] = m * prev + row[i]
        return prev
    for _ in range(n_nodes):
        if kind == "pivot":
            den = b - a * prev
            den = torch.where(den.abs() < 1e-30, torch.sign(den) * 1e-30 + 1e-30, den)
            prev = c / den
        else:
            prev = (d - a * prev) / b
    x = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(n_nodes):
        x = (d - prev * x) if kind == "pivot" else (prev - c * x)
    return x


def tri_chain_node_ms(kind: str, dtype, dev) -> float:
    """Device ms of one node of a dependent chain (a forward and a back node,
    operands in registers; "back": a back node alone), from chain probe
    ``kind`` by CUDA events: the difference of runs of TRI_CHAIN_NODES and
    twice as many nodes, so the launch drops out."""
    out = torch.empty(1, dtype=dtype, device=dev)
    probe_run(kind, dtype, dev, TRI_CHAIN_NODES, out)
    one, two = (min(event_time(lambda k=k: probe_run(kind, dtype, dev, k, out), 1)
                    for _ in range(3))
                for k in (TRI_CHAIN_NODES, 2 * TRI_CHAIN_NODES))
    check(bool(torch.isfinite(out).all()), f"the {kind} chain probe gave a non-finite value")
    return (two - one) / TRI_CHAIN_NODES


def probe_check(kind: str, dtype, dev) -> dict:
    """The probe at PROBE_CHECK_NODES nodes against its plain loop, bitwise;
    device ms of both by CUDA events, and the bound of that work: 8 float
    operations a node at the card's peak rate (the FMA probe 2, the
    partitioned solve's node 2 a lane, its stage 4 a lane and its factors'
    stage 8 a lane, 32 lanes; its bytes: five values)."""
    out = torch.empty(1, dtype=dtype, device=dev)
    probe_run(kind, dtype, dev, PROBE_CHECK_NODES, out)
    plain = probe_plain(kind, dtype, dev, PROBE_CHECK_NODES)
    torch.cuda.synchronize()
    check(torch.equal(out[0], plain), f"the {kind} probe ({str(dtype)[6:]}) {out.item()!r} != "
                                      f"its plain loop {plain.item()!r}")
    ms = min(graph_time(lambda: probe_run(kind, dtype, dev, PROBE_CHECK_NODES, out)))
    plain_ms = event_time(lambda: probe_plain(kind, dtype, dev, PROBE_CHECK_NODES), 1)
    peak = FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS
    per_node = {"muladd": 64.0, "stage": 128.0, "fstage": 256.0}.get(
        kind, 2.0 if kind.startswith("fma") else 8.0)
    t_ops = per_node * PROBE_CHECK_NODES / peak * 1e3
    t_bytes = 5 * (torch.finfo(dtype).bits // 8) / HBM_BYTES_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
            "err": (out[0] - plain).abs().item()}


def float_bits(sign, exp, mant, dtype) -> torch.Tensor:
    """Floats of ``dtype`` from int64 sign (0/1), biased exponent and
    significand fields."""
    if dtype == torch.float32:
        bits = sign * (1 << 31) + exp * (1 << 23) + mant
        return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(dtype)
    return (sign * -(1 << 63) + exp * (1 << 52) + mant).view(dtype)


def div_edges(dtype) -> list[float]:
    """The division check's edge values: zeros, the subnormal and normal
    ends, infinities, NaN, the pivot guard's 2e-30 and 1e-30, ones and
    all-ones significands."""
    fi = torch.finfo(dtype)
    p, emin = (23, -126) if dtype == torch.float32 else (52, -1022)
    ones = [(2.0 - 2.0 ** -p) * 2.0 ** e for e in (emin + 2, -40, -1, 0, 1, 40)]
    vals = [0.0, fi.smallest_normal * 2.0 ** -p, fi.smallest_normal * (1 - 2.0 ** -p),
            fi.smallest_normal, fi.max, fi.max / 2, math.inf, math.nan, 2e-30, 1e-30, 1.0, 3.0,
            *ones]
    return vals + [-v for v in vals]


def div_pairs(dtype, dev, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """DIV_PAIRS seeded (numerator, divisor) pairs over the exponent range, a
    quarter each: every bit pattern (zeros, subnormals, infinities and NaNs
    among them); divisors of moderate size; divisors with an all-ones
    significand; quotients at the top of the range and below its bottom;
    then every pair of ``div_edges``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mant_bits, ebits = (23, 8) if dtype == torch.float32 else (52, 11)
    bias, top = (1 << (ebits - 1)) - 1, (1 << ebits) - 1
    q = DIV_PAIRS // 4

    def ints(lo, hi, n=q):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int64)

    def rand(exp):
        return float_bits(ints(0, 2), exp, ints(0, 1 << mant_bits), dtype)

    nums, dens = [rand(ints(0, top + 1))], [rand(ints(0, top + 1))]
    nums.append(rand(ints(0, top + 1)))
    dens.append(rand(ints(bias - 20, bias + 21)))
    nums.append(rand(ints(bias - 40, bias + 41)))
    dens.append(float_bits(ints(0, 2), ints(1, top), torch.full((q,), (1 << mant_bits) - 1,
                                                                device=dev), dtype))
    e_den = ints(bias - 60, bias + 61)
    offsets = torch.tensor([bias - 1, bias, bias + 1] + list(range(-bias - mant_bits - 2,
                                                                   -bias + 3)), device=dev)
    off = offsets[ints(0, len(offsets))]
    nums.append(rand((e_den + off).clamp(1, top - 1)))
    dens.append(rand(e_den))
    edges = torch.tensor(div_edges(dtype), dtype=dtype, device=dev)
    nums.append(edges.repeat_interleave(len(edges)))
    dens.append(edges.repeat(len(edges)))
    return torch.cat(nums), torch.cat(dens)


def div_check(dtype, dev, card: str) -> dict:
    """The fast quotient of ``tridiag.cuh`` (fast_quotient on table_rcp, a
    flagged pair through tri::quotient) against the division intrinsic on
    the card over ``div_pairs``: every pair bitwise (two NaNs agree), and
    against torch's division (the plain version and the library call);
    device ms of the check kernel and of torch's division beside the bytes'
    bound."""
    num, den = div_pairs(dtype, dev)
    n = num.numel()
    out = torch.empty_like(num)
    counts = torch.tensor([0, 0, -1], dtype=torch.int64, device=dev)
    lib = _build.load_library()
    code = 0 if dtype == torch.float32 else 1

    def run():
        counts.copy_(torch.tensor([0, 0, -1], dtype=torch.int64, device=dev))
        err = lib.tridiag_div_check_launch(num.data_ptr(), den.data_ptr(), out.data_ptr(),
                                           counts.data_ptr(), n, code, dev.index or 0,
                                           torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"tridiag_div_check_launch failed: {_build.error_string(err)}")
        div_check.launches += 1

    run()
    plain = num / den
    torch.cuda.synchronize()
    bad, fast, first = counts.tolist()
    check(bad == 0, f"the fast quotient ({str(dtype)[6:]}) differs from the division "
                    f"intrinsic on {bad} of {n} pairs, first {num[first].item()!r} / "
                    f"{den[first].item()!r}" if bad else "")
    agree = (out.view(torch.int32 if dtype == torch.float32 else torch.int64)
             == plain.view(torch.int32 if dtype == torch.float32 else torch.int64)) | (
        torch.isnan(out) & torch.isnan(plain))
    check(bool(agree.all()), f"the fast quotient ({str(dtype)[6:]}) differs from torch's "
                             f"division on {int((~agree).sum())} pairs")
    ms = event_time(run, 3)
    plain_ms = event_time(lambda: num / den, 3)
    size = torch.finfo(dtype).bits // 8
    bound = 3 * n * size / HBM_BYTES_PER_S * 1e3
    log("tridiag", f"division check {str(dtype)[6:]}: {n} pairs ({DIV_PAIRS} seeded over the "
                   f"exponent range and {len(div_edges(dtype)) ** 2} of the edge list), every "
                   f"one bitwise the division intrinsic's and torch's; {fast} ({fast / n:.3f}) "
                   f"on the fast path; device ms by CUDA events [{card}]: check kernel "
                   f"{ms:.4f}, torch division {plain_ms:.4f}, bound {bound:.4f} (bytes)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "err": 0.0, "pairs": n, "fast": fast}


div_check.launches = 0


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


def adi_launches(fn) -> tuple[int, int, int]:
    """(ADI forward, ADI reverse, tridiagonal) kernel launches in one call
    of ``fn``."""
    before = ha._adi_cuda.launches, ha._adi_adjoint_cuda.launches
    solves = tri_solves(fn)
    return ha._adi_cuda.launches - before[0], ha._adi_adjoint_cuda.launches - before[1], solves


def phase_tridiag(dev, card: str) -> tuple[float, dict, dict]:
    """The tridiagonal kernel against its plain version at the slice's
    shapes, float32 and float64: bitwise equal, one launch a solve; its
    adjoint against autograd through the plain loop; device ms of kernel
    and plain version by CUDA events (the kernel inside a CUDA graph of 20
    calls, the host's issue left out) beside the bound and beside
    ``torch.linalg.solve`` on the dense matrix (built outside the timed
    region; the library call that computes the same x). Before them the
    chain probes (each bitwise its plain loop) and the division check.
    Returns (largest absolute difference, {tag: timing}, {"pivot" | "rhs" |
    "back" | "fma" | "fma ahead" | "muladd" | "stage" | "fstage": {dtype:
    chain ms a node}}; "fma" the faster of the FMA probe's two load
    schedules; the last three the warp-partitioned solve's node and stages)."""
    worst, timing = 0.0, {}
    clock = sm_clock_hz()
    node_ms = {"pivot": {}, "rhs": {}, "back": {}, "fma": {}, "fma ahead": {},
               **{kind: {} for kind in WARP_PROBES}}
    for dtype in (torch.float32, torch.float64):
        for kind in ("pivot", "rhs", "fma", "fma ahead", *WARP_PROBES):
            node_ms[kind][dtype] = tri_chain_node_ms(kind, dtype, dev)
            timing[f"probe {kind} {str(dtype)[6:]}"] = probe_check(kind, dtype, dev)
        node_ms["back"][dtype] = tri_chain_node_ms("back", dtype, dev)
        # the least an FMA node costs: the faster of the two load schedules
        fma_own = node_ms["fma"][dtype]
        node_ms["fma"][dtype] = min(fma_own, node_ms["fma ahead"][dtype])
        log("tridiag", f"dependent chain, {str(dtype)[6:]}, a forward and a back node, by the "
                       f"chain probes [{card}]: pivot {node_ms['pivot'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['pivot'][dtype] * 1e-3 * clock:.1f} cycles at the "
                       f"{clock / 1e9:.3f} GHz maximum SM clock), right-hand side "
                       f"{node_ms['rhs'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['rhs'][dtype] * 1e-3 * clock:.1f} cycles); a back node alone "
                       f"{node_ms['back'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['back'][dtype] * 1e-3 * clock:.1f} cycles); an FMA node on "
                       f"shared-memory operands, loaded as the θ reverse loads them "
                       f"{fma_own * 1e6:.2f} ns ({fma_own * 1e-3 * clock:.1f} cycles), the next "
                       f"group's loads during a chain {node_ms['fma ahead'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['fma ahead'][dtype] * 1e-3 * clock:.1f} cycles); each probe "
                       f"bitwise its plain loop at {PROBE_CHECK_NODES} nodes")
        log("tridiag", f"the warp-partitioned solve's chain, {str(dtype)[6:]}, by its probe "
                       f"[{card}]: a node of the right-hand side's pass "
                       f"{node_ms['muladd'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['muladd'][dtype] * 1e-3 * clock:.1f} cycles), a stage of its "
                       f"reduction {node_ms['stage'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['stage'][dtype] * 1e-3 * clock:.1f} cycles), a stage of the "
                       f"reduced system's factors {node_ms['fstage'][dtype] * 1e6:.2f} ns "
                       f"({node_ms['fstage'][dtype] * 1e-3 * clock:.1f} cycles); each bitwise "
                       f"its plain loop at {PROBE_CHECK_NODES}")
        timing[f"division {str(dtype)[6:]}"] = div_check(dtype, dev, card)
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
            bound, by, _, chain = tri_bound(ops, dtype, node_ms["pivot"][dtype])
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


def theta_bound(ops, dtype, node_ms: dict, solves: torch.Tensor,
                pivots: torch.Tensor) -> tuple[float, str, float, float, int]:
    """(bound ms, what binds, chain ms, the old count of the chain, the block
    whose chain is longest) of one θ-scheme launch: each input read once and
    the values written once at the card's memory rate; the float operations
    of the solves that ran (8 a node), the explicit step (7 a node a step)
    and Howard's residuals (7 a node, at least one solve a step without one)
    at the card's peak rate for the dtype; and the longest dependent chain
    of a CUDA block (the contracts run side by side). A block's chain: the
    tables' n pivots, formed once with no back node (the pivot probe's node
    less a back node each); each step's first solve on them, n nodes at the
    right-hand-side probe's node; and each later Howard sweep restarted at
    row j0, its n − j0 re-formed rows at the pivot probe's node (the
    right-hand side's chain runs beside the pivots on the partner lane) and
    its j0 rows before at a back node alone. The kernel counts the solves
    and the pivot nodes (the tables' n and each later sweep's n − j0), and
    the first n_time solves are the tables'. The old count charged every
    solve n nodes at the pivot probe's node."""
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
    pivot, rhs, back = (node_ms[k][dtype] for k in ("pivot", "rhs", "back"))
    restarted = pivots.double() - n  # the later sweeps' re-formed rows
    kept = (solves.double() - n_time) * n - restarted  # their rows before j0
    blocks = n * (pivot - back) + n_time * n * rhs + restarted * pivot + kept * back
    longest = int(torch.argmax(blocks).item())
    chain = blocks[longest].item()
    old = int(solves.max().item()) * n * pivot
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", chain, old, longest


def phase_theta(dev, card: str, node_ms: dict) -> tuple[float, dict]:
    """The θ-scheme kernel against the plain loop of ``fdm._cn_book`` on the
    card at fdm_price's defaults: European, projection and Howard, θ = 0.5
    and 1, float32 and float64, bitwise, one launch; the Function's gradient
    against autograd through the plain loop (European and Howard, float64);
    device ms of kernel and plain loop by CUDA events beside the bound, the
    longest chain of a block (:func:`theta_bound`, ``node_ms`` from the chain
    probes) and the old count (every solve n nodes at the pivot probe's
    node).
    Returns (largest absolute difference, {tag: timing})."""
    from optionslab_tpu_torch.models import fdm

    t_phase = time.perf_counter()
    book = pricer_book(THETA_SHAPE[0], dev, seed=11)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        args = [getattr(book, f).to(dtype) for f in FDM_FIELDS]
        for theta in (0.5, 1.0):
            for name, mode in THETA_MODES.items():
                _, ops = fdm._cn_operands(*args, *THETA_SHAPE[1:], theta, mode != tp.EUROPEAN)
                before = tp._theta_cuda.launches
                kern, solves, pivots = tp._theta_cuda(*ops, mode, count_solves=True)
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
                bound, by, chain, old, longest = theta_bound(ops, dtype, node_ms, solves,
                                                             pivots)
                timing[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                               "bound_by": by, "chain_ms": chain, "old_chain_ms": old,
                               "max_solves": int(solves.max().item()),
                               "max_pivots": int(pivots.max().item())}
                log("theta", f"{tag} {'x'.join(map(str, THETA_SHAPE))}: bitwise equal; device "
                             f"ms by CUDA events [{card}]: kernel {ms:.4f}, plain loop "
                             f"{plain_ms:.3f}, bound {bound:.4f} ({by}; the longest chain, "
                             f"block {longest}: {int(pivots[longest].item())} pivot nodes, "
                             f"{THETA_SHAPE[1]} of them the tables', and "
                             f"{int(solves[longest].item())} solves, {THETA_SHAPE[2]} of them "
                             f"on the tables, {THETA_SHAPE[1]} nodes each, "
                             f"{chain:.4f}, {chain / ms:.2f} of the kernel; the old count, "
                             f"{int(solves.max().item())} solves at the pivot node, {old:.4f}); "
                             f"mean solves a block {solves.float().mean().item():.1f}, mean "
                             f"pivot nodes re-formed a block "
                             f"{(pivots - THETA_SHAPE[1]).float().mean().item():.1f}")
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
    log("theta", f"phase {time.perf_counter() - t_phase:.1f} s")
    return worst, timing


# fdm_price's rho and dividend rho (float64, European: the grid moves with
# neither r nor q, and the price is smooth in both) against central
# differences of step THETA_FD_STEP
THETA_FD_STEP = 1e-5
THETA_FD_RTOL = 1e-6
THETA_NAMES = ("lo", "di", "up", "a", "b", "c", "w", "psi", "v0", "ends")


def reverse_runs(hist_m, n: int) -> dict[str, torch.Tensor]:
    """The runs of continuation rows of each contract's exercise set at each
    step, from Howard's history ``hist_m`` (B, n_time, n): the runs the
    reverse kernel solves side by side. Returns (B, n_time, runs) tensors
    (runs n + 1, the unused ones of length 0): "length" each run's rows,
    "both" a run that touches row 0 and row n − 1, "interior" one that
    touches neither (the kernel forms its pivots; the others run on the
    tables formed once)."""
    cont = ~hist_m
    first = cont.clone()
    first[..., 1:] &= ~cont[..., :-1]
    ids = torch.where(cont, torch.cumsum(first, -1), 0)
    length = torch.zeros((*ids.shape[:-1], n + 1), dtype=torch.long, device=ids.device)
    length.scatter_add_(-1, ids, cont.long())
    runs = torch.arange(n + 1, device=ids.device)
    low = (runs == 1) & cont[..., :1]  # the run that holds row 0
    high = (runs == ids[..., -1:]) & cont[..., -1:]  # the run that holds row n − 1
    used = length > 0
    return {"length": length, "both": used & low & high, "interior": used & ~low & ~high}


def theta_reverse_bound(ops, dtype, node_ms: dict,
                        hist_m) -> tuple[float, str, float, float, float]:
    """(bound ms, what binds, chain ms, the first old count, the second old
    count) of one reverse launch: the operands, the history and the
    gradient read once and the ten gradients written once at the card's
    memory rate; 30 float operations a node a step (34 with Howard's
    exercise sets) at its peak rate for the dtype; and the longest
    contract's chain, the contracts side by side. A contract's chain: the
    tables once, n nodes at the pivot probe's node less a back node (the LU
    and UL factorizations side by side); each step, its slowest run of
    continuation rows (``hist_m``'s runs, :func:`reverse_runs`; without a
    set one run of all n rows), the runs side by side. A run that touches
    both ends solves twisted: its upper part on the LU tables and its lower
    part on the UL tables sweep towards a middle row side by side, that
    row's λ, then both parts substitute back outwards, 2⌈(len − 1)/2⌉ + 1
    nodes at the FMA probe's node; any other run sweeps Uᵀ and Lᵀ one after
    the other, 2·len nodes at the FMA probe's node (the pivots of only one
    end are in the tables), and a run that touches neither end forms its
    pivots, len more nodes at the pivot probe's node. The first old count,
    of the kernel that divided on its chains: n nodes a step at the
    right-hand-side probe's node after the tables, and for Howard n a step
    at the pivot probe's node; the second, of every run swept one way: 2·len
    FMA nodes of the longest run a step and every interior run's pivots."""
    size = torch.finfo(dtype).bits // 8
    batch, n = ops[-2].shape
    n_time = ops[-1].shape[1]
    howard = hist_m is not None
    grids = batch * n
    hist = batch * n_time * n
    nbytes = (6 * grids + 4 * batch + hist + 5 * grids + 4 * batch + 2 * batch * n_time) * size
    nbytes += hist if howard else 0  # the exercise sets, a byte a node
    flops = (34.0 if howard else 30.0) * hist
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS) * 1e3
    pivot, rhs, back, fma = (node_ms[k][dtype] for k in ("pivot", "rhs", "back", "fma"))
    if howard:
        runs = reverse_runs(hist_m, n)
    else:  # one run of all n rows, at every step
        length = torch.zeros((1, n_time, n + 1), dtype=torch.long)
        length[..., 1] = n
        runs = {"length": length, "both": length == n, "interior": length < 0}
    length = runs["length"].double()
    own = pivot * torch.where(runs["interior"], length, 0.0)
    swept = 2.0 * fma * length + own
    twisted = fma * (2.0 * torch.ceil((length - 1) / 2) + 1.0)
    step = torch.where(runs["both"], twisted, swept).max(-1).values
    tables = n * (pivot - back)
    chain = tables + step.sum(-1).max().item()
    old2 = tables + (2.0 * fma * runs["length"].max(-1).values.double()
                     + own.sum(-1)).sum(-1).max().item()
    old = n_time * n * pivot if howard else tables + n_time * n * rhs
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", chain, old, old2


# the hand-built exercise sets the reverse is held to the plain reverse on
# (nodes, steps, contracts a set), and a book that mixes them in blocks
REVERSE_SETS = (41, 3, 4)
REVERSE_MIXED = 300


def off_word(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of byte tensor ``t`` whose data starts one byte
    past a 4-byte word and ends at its storage's end."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


def reverse_on_sets(dev, book) -> float:
    """The reverse kernel on hand-built exercise sets against the plain
    reverse on the same history (a forward's, Howard, American operands),
    within THETA_REVERSE_RTOL, two launches bit for bit: each set of
    :func:`exercise_sets` at every step of REVERSE_SETS contracts, all of them
    mixed in blocks over REVERSE_MIXED contracts (its second launch on the
    sets in a view off 4-byte words, :func:`off_word`), and the step that
    stops short of its fixed point; float32 and float64. Returns the largest
    gap."""
    from optionslab_tpu_torch.models import fdm

    n, steps, per = REVERSE_SETS
    sets = exercise_sets(n)
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        cases = []
        for name, m in [*sets.items(), ("mixed", None)]:
            batch = per if m is not None else REVERSE_MIXED
            fields = [getattr(book, f)[:batch].to(dtype) for f in FDM_FIELDS]
            if batch > len(fields[0]):
                fields = [f.repeat(-(-batch // len(f)))[:batch] for f in fields]
            _, ops = fdm._cn_operands(*fields, n, steps, 0.5, True)
            rows = np.stack([m if m is not None else list(sets.values())[b % len(sets)]
                             for b in range(batch)])
            hist_m = torch.tensor(rows, device=dev)[:, None].expand(batch, steps, n)
            cases.append((name, ops, hist_m.contiguous()))
        cases.append(("short of the fixed point", short_howard_step(dtype, dev), None))
        for name, ops, hist_m in cases:
            _, hist_u, own = tp._theta_cuda(*ops, tp.HOWARD, history=True)
            hist_m = own if hist_m is None else hist_m
            gen = torch.Generator(device=dev).manual_seed(9)
            g = torch.randn(hist_u[:, 0].shape, generator=gen, device=dev, dtype=dtype)
            got = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
            # the mixed book's second launch on the same sets in a view that
            # starts off a 4-byte word and ends at its storage's end
            again = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u,
                                           off_word(hist_m) if name == "mixed" else hist_m, g)
            want = tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, hist_m, g)
            torch.cuda.synchronize()
            rel, _ = grad_gaps(got, want)
            worst = max(worst, rel)
            check(all(torch.equal(x, y) for x, y in zip(got, again)) and
                  rel < THETA_REVERSE_RTOL[dtype],
                  f"θ reverse on the exercise set {name!r} ({str(dtype)[6:]}): {rel:.2e} off the "
                  f"plain reverse, or two launches differ")
    log("theta-reverse", f"hand-built exercise sets ({', '.join(sets)}, mixed in blocks over "
                         f"{REVERSE_MIXED} contracts, a step short of its fixed point) at "
                         f"{n} nodes x {steps} steps, float32 and float64: within {worst:.2e} of "
                         f"the plain reverse, two launches bitwise each (the mixed book's "
                         f"second on its sets off 4-byte words)")
    return worst


def grad_gaps(got, want) -> tuple[float, float]:
    """(largest relative gap, each gradient relative to its largest entry;
    largest absolute gap) of two gradient lists."""
    rel = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-300)).item()
              for g, w in zip(got, want))
    return rel, max((g - w).abs().max().item() for g, w in zip(got, want))


def phase_theta_reverse(dev, card: str, node_ms: dict) -> tuple[float, dict]:
    """The θ-scheme reverse kernel at fdm_price's defaults (THETA_SHAPE):
    European, projection and Howard, float32 and float64; the forward with
    its history one launch, bit for bit the plain loop's (values, solutions,
    exercise sets); the reverse's ten gradients against the plain reverse on
    that history within THETA_REVERSE_RTOL, one launch and no tridiagonal
    launch, a second launch bit for bit the first; device ms of the reverse,
    the forward with its history and the plain reverse by CUDA events beside
    the bound (:func:`theta_reverse_bound`, with the old counts). Then the
    hand-built exercise sets (:func:`reverse_on_sets`), and the forward's
    longest grids on the reverse's device route, on their own and on the
    hand-built sets, against the float64 plain reverse. Then ``fdm_price``'s gradient
    through the Function (one forward and one reverse launch, no
    tridiagonal launch; its warm wall), delta's sign, and rho and dividend
    rho against central differences. Returns (largest absolute difference of
    a float32 gradient, {tag: timing})."""
    from optionslab_tpu_torch.models import fdm

    t_phase = time.perf_counter()
    book = pricer_book(THETA_SHAPE[0], dev, seed=11)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        args = [getattr(book, f).to(dtype) for f in FDM_FIELDS]
        for name, mode in THETA_MODES.items():
            _, ops = fdm._cn_operands(*args, *THETA_SHAPE[1:], 0.5, mode != tp.EUROPEAN)
            before = tp._theta_cuda.launches
            out, hist_u, hist_m = tp._theta_cuda(*ops, mode, history=True)
            check(tp._theta_cuda.launches == before + 1, "θ-scheme with history: not one launch")
            plain = tp._theta_plain(*ops, mode, history=True)
            torch.cuda.synchronize()
            tag = f"{name} {str(dtype)[6:]}"
            check(torch.equal(out, plain[0]) and torch.equal(hist_u, plain[1])
                  and (hist_m is None) == (plain[2] is None)
                  and (hist_m is None or torch.equal(hist_m, plain[2])),
                  f"θ-scheme {tag}: the forward or its history differs from the plain loop's")
            gen = torch.Generator(device=dev).manual_seed(5)
            g = torch.randn(out.shape, generator=gen, device=dev, dtype=dtype)
            before = tp._theta_adjoint_cuda.launches, tri._tridiag_cuda.launches
            got = tp._theta_adjoint_cuda(*ops, mode, hist_u, hist_m, g)
            again = tp._theta_adjoint_cuda(*ops, mode, hist_u, hist_m, g)
            torch.cuda.synchronize()
            check((tp._theta_adjoint_cuda.launches, tri._tridiag_cuda.launches)
                  == (before[0] + 2, before[1]), "θ reverse: not one launch a call, or a "
                                                 "tridiagonal launch")
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"θ reverse {tag}: two launches differ")
            want = tp._theta_reverse_plain(*ops, mode, hist_u, hist_m, g)
            torch.cuda.synchronize()
            rel, err = grad_gaps(got, want)
            each = {nm: grad_gaps([x], [y])[0] for nm, x, y in zip(THETA_NAMES, got, want)}
            check(rel < THETA_REVERSE_RTOL[dtype], f"θ reverse {tag}: {rel:.2e} off the plain "
                                                   f"reverse ({each})")
            if dtype == torch.float32:
                worst = max(worst, err)
            ms = event_time(lambda: tp._theta_adjoint_cuda(*ops, mode, hist_u, hist_m, g), 3)
            fwd_ms = event_time(lambda: tp._theta_cuda(*ops, mode, history=True), 3)
            plain_ms = event_time(lambda: tp._theta_reverse_plain(*ops, mode, hist_u, hist_m, g),
                                  1)
            bound, by, chain, old, old2 = theta_reverse_bound(ops, dtype, node_ms, hist_m)
            timing[tag] = {"ms": ms, "forward_ms": fwd_ms, "plain_ms": plain_ms,
                           "bound_ms": bound, "bound_by": by, "chain_ms": chain,
                           "old_chain_ms": old, "old_chain_2n_ms": old2, "rel": rel}
            log("theta-reverse", f"{tag} {'x'.join(map(str, THETA_SHAPE))}: the forward and "
                                 f"its history bitwise the plain loop's; the reverse within "
                                 f"{rel:.2e} of the plain reverse (largest gradient "
                                 f"{max(each, key=each.get)}), two launches bitwise; device ms "
                                 f"by CUDA events [{card}]: reverse {ms:.4f}, forward with "
                                 f"history {fwd_ms:.4f}, plain reverse {plain_ms:.3f}, bound "
                                 f"{bound:.4f} ({by}; the chain {chain:.4f}, {chain / ms:.2f} "
                                 f"of the kernel; the old counts {old:.4f} and, every run "
                                 f"swept one way, {old2:.4f})")
    reverse_on_sets(dev, book)

    for dtype in (torch.float32, torch.float64):  # the longest grid the forward takes
        size = torch.finfo(dtype).bits // 8
        n = 3
        while tp.tile_bytes(n + 1, 1, size) <= tri.SMEM_LIMIT:
            n += 1
        _, device = tp.adjoint_plan(2, n, size, tri.sm_count(dev.index))
        check(device, f"θ reverse at {n} nodes ({str(dtype)[6:]}): not the device route")
        sets = exercise_sets(n)
        for name, steps in (("its own", 4), ("hand-built", 2)):
            batch = 2 if name == "its own" else len(sets)
            args = [getattr(book, f)[:batch].to(dtype) for f in FDM_FIELDS]
            _, ops = fdm._cn_operands(*args, n, steps, 0.5, True)
            out, hist_u, hist_m = tp._theta_cuda(*ops, tp.HOWARD, history=True)
            if name == "hand-built":  # one set a contract, the same at every step
                hist_m = torch.tensor(np.stack(list(sets.values())), device=dev)[:, None]
                hist_m = hist_m.expand(batch, steps, n).contiguous()
            g = torch.ones_like(out)
            before = tp._theta_adjoint_cuda.launches
            got = tp._theta_adjoint_cuda(*ops, tp.HOWARD, hist_u, hist_m, g)
            # the float64 plain reverse on the same history, and the plain
            # reverse's own gap to it: on so long a float32 grid both reach
            # ≈1e-3
            exact = tp._theta_reverse_plain(*(o.double() for o in ops), tp.HOWARD,
                                            hist_u.double(), hist_m, g.double())
            own, _ = grad_gaps(tp._theta_reverse_plain(*ops, tp.HOWARD, hist_u, hist_m, g),
                               exact)
            torch.cuda.synchronize()
            rel, _ = grad_gaps(got, exact)
            limit = max(2 * own, THETA_REVERSE_RTOL[dtype])
            check(tp._theta_adjoint_cuda.launches == before + 1 and rel < limit,
                  f"θ reverse at the forward's longest grid ({n} nodes, {str(dtype)[6:]}, "
                  f"{name} exercise sets): {rel:.2e} off the float64 plain reverse, the plain "
                  f"reverse {own:.2e}")
            log("theta-reverse", f"the forward's longest grid, {n} nodes {str(dtype)[6:]} (the "
                                 f"device route, one contract a block), Howard on {name} "
                                 f"exercise sets, {batch} contracts x {steps} steps: one reverse "
                                 f"launch, {rel:.2e} off the float64 plain reverse on its "
                                 f"history (the plain reverse of its dtype {own:.2e}; limit "
                                 f"{limit:.1e})")

    # walls only in this phase and the two after it: the public calls' kernel
    # counts come from the pricers, slice, risk and surface phases
    def fdm_grad(fields, american):
        leaves = [x.detach().requires_grad_(True) for x in fields[:6]]
        price = fdm.fdm_price(ContractBatch(*leaves, fields[6]), american=american)
        return torch.autograd.grad(price.sum(), leaves)

    for dtype in (torch.float32, torch.float64):
        fields = [getattr(book, f).to(dtype) for f in FDM_FIELDS]
        for american in (False, True):
            before = (tp._theta_cuda.launches, tp._theta_adjoint_cuda.launches,
                      tri._tridiag_cuda.launches)
            grads, ms = timed(lambda: fdm_grad(fields, american), 3)
            after = (tp._theta_cuda.launches, tp._theta_adjoint_cuda.launches,
                     tri._tridiag_cuda.launches)
            tag = f"fdm_price {'american' if american else 'european'} gradient " \
                  f"{'x'.join(map(str, THETA_SHAPE))} {str(dtype)[6:]}"
            check(tuple(a - b for a, b in zip(after, before)) == (4, 4, 0),
                  f"{tag}: (forward, reverse, tridiag) launches {after} from {before}, not one "
                  f"forward and one reverse a call")
            check(all(bool(torch.isfinite(x).all()) for x in grads), f"{tag}: not finite")
            check(bool(((grads[0] * fields[6]) > 0).all()), f"{tag}: delta has the wrong sign")
            timing[tag] = {"wall_ms": ms}
            log("theta-reverse", f"{tag}: one forward and one reverse launch, no tridiagonal "
                                 f"launch; warm wall {ms:.1f} ms [{card}]")
            if dtype != torch.float64 or american:
                continue
            for i, name in ((3, "rho"), (5, "dividend rho")):
                def price_at(shift, i=i):
                    moved = list(fields)
                    moved[i] = fields[i] + shift
                    return fdm.fdm_price(ContractBatch(*moved))
                fd = (price_at(THETA_FD_STEP) - price_at(-THETA_FD_STEP)) / (2 * THETA_FD_STEP)
                gap = ((grads[i] - fd).abs().max() / fd.abs().max()).item()
                check(gap < THETA_FD_RTOL, f"{tag}: {name} {gap:.2e} off central differences")
                log("theta-reverse", f"{tag}: {name} within {gap:.2e} of central differences "
                                     f"(step {THETA_FD_STEP}, relative to the largest)")
    log("theta-reverse", f"phase {time.perf_counter() - t_phase:.1f} s")
    return worst, timing


def warp_chain(n: int, node_ms: dict, dtype) -> tuple[float, float]:
    """(ms of one solve's chain, ms of one factor formation's chain) of the
    warp-partitioned solve (csrc/warp_tridiag.cuh) of n unknowns, m =
    ⌈n/32⌉ rows a lane (at least 2), by the probes' nodes. A solve: the
    right-hand side's forward and backward passes, 2(m − 2) nodes at the
    "muladd" probe's node, and seven shuffle stages at its "stage" node (the
    separator's row, five of cyclic reduction, the recovery). The factors:
    the forward pass's m − 1 pivots at the pivot probe's node less a back
    node, the backward pass's m − 2 nodes at the "muladd" node, and five
    stages at the "fstage" node."""
    m = tri.warp_rows(n)
    muladd, stage, fstage = (node_ms[k][dtype] for k in ("muladd", "stage", "fstage"))
    pivot = node_ms["pivot"][dtype] - node_ms["back"][dtype]
    solve = 2 * (m - 2) * muladd + 7 * stage
    factors = (m - 1) * pivot + (m - 2) * muladd + 5 * fstage
    return solve, factors


# the dividend PDE at fdm_price_discrete_dividends' defaults: nodes, steps
DIV_SHAPE = (401, 400)


def jump_bound(ops, dtype, node_ms: dict, solves: torch.Tensor) -> tuple[float, str, float,
                                                                        float]:
    """(bound ms, what binds, chain ms, the old count of the chain) of one
    launch of the jump-table kernel: each input read once and the values
    written once at the card's memory rate; the float operations (9 a node a
    solve, 7 a node a step for the explicit step, and for each later Howard
    sweep 7 a node of residual and 12 of factors) at the card's peak rate
    for the dtype; and the longest contract's chain (the contracts run side
    by side): the unexercised matrix's factors once, each solve's chain
    (:func:`warp_chain`), and for each later Howard sweep (it runs only
    where a block's exercise rows changed, and re-forms that block) one
    more formation. The old count is row 13's Thomas count: every solve n
    nodes at the pivot probe's node."""
    size = torch.finfo(dtype).bits // 8
    batch, n = ops[-2].shape
    n_time = ops[-1].shape[1]
    nbytes = (sum(o.numel() for o in ops) + batch * n) * size
    later = (solves - n_time).double()
    flops = float((n * (9.0 * solves.double() + 7.0 * n_time + 19.0 * later)).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS) * 1e3
    solve, factors = warp_chain(n, node_ms, dtype)
    chain = float((factors + solves.double() * solve + later * factors).max())
    old = int(solves.max().item()) * n * node_ms["pivot"][dtype]
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", chain, old


def div_launches(fn) -> tuple[int, int, int]:
    """(jump-table, θ-scheme, tridiagonal) kernel launches in one call of
    ``fn``."""
    before = tp._theta_jumps_cuda.launches, tp._theta_cuda.launches
    solves = tri_solves(fn)
    return (tp._theta_jumps_cuda.launches - before[0], tp._theta_cuda.launches - before[1],
            solves)


def phase_div_loop(dev, card: str, node_ms: dict) -> tuple[float, dict]:
    """The jump-table kernel (``csrc/theta_pde.cu theta_jump_kernel``, one
    warp a contract) on the dividend PDE at its defaults (DIV_SHAPE,
    SL_DIVS): European, projection and Howard, call and put, float32, and
    the European and Howard put in float64, each bit for bit the plain loop
    with the table (the warp-partitioned solve's model); device ms of the
    kernel alone (a CUDA graph of calls) and of the plain loop by CUDA events
    beside :func:`jump_bound` and the old count; the public call one launch
    of it and none of the θ-scheme or tridiagonal kernels, its warm wall;
    the European parity gap and the American put above the European.
    Returns (largest absolute difference of kernel and plain loop, {tag:
    timing})."""
    from optionslab_tpu_torch.models import dividends as dv

    t_phase = time.perf_counter()
    steps = dv._div_steps([t for t, _ in SL_DIVS], 1.0, DIV_SHAPE[1])
    amounts = np.asarray([d for _, d in SL_DIVS], np.float32)
    worst, timing = 0.0, {}
    cases = [(mode, cp, torch.float32) for mode in (tp.EUROPEAN, tp.PROJECTION, tp.HOWARD)
             for cp in (1.0, -1.0)] + [(mode, -1.0, torch.float64)
                                       for mode in (tp.EUROPEAN, tp.HOWARD)]
    for mode, cp, dtype in cases:
        _, _, ops, jumps = dv._fdm_div_operands(
            100.0, 100.0, 1.0, 0.05, 0.2, amounts, cp=cp, n_space=DIV_SHAPE[0],
            n_time=DIV_SHAPE[1], american=mode != tp.EUROPEAN, div_steps=steps, device=dev)
        ops = [o.to(dtype) for o in ops]
        jumps = tp.Jumps(jumps.steps, jumps.index, jumps.weight.to(dtype))
        launch, kern, counts = tp._jump_launch(*ops, mode, jumps)
        before = tp._theta_jumps_cuda.launches
        launch()
        check(tp._theta_jumps_cuda.launches == before + 1, "dividend loop: not one launch")
        plain = tp._theta_plain(*ops, mode, jumps=jumps)
        torch.cuda.synchronize()
        name = {tp.EUROPEAN: "european", tp.PROJECTION: "projection", tp.HOWARD: "american"}[mode]
        tag = f"{name} {'call' if cp > 0 else 'put'} {DIV_SHAPE[0]}x{DIV_SHAPE[1]}" \
              + ("" if dtype == torch.float32 else " float64")
        diff = (kern - plain).abs().max().item()
        worst = max(worst, diff)
        check(torch.equal(kern, plain), f"dividend loop {tag}: kernel differs from the "
                                        f"plain loop by {diff:.3e}")
        solves, reformed = counts[0].clone(), counts[1].clone()
        if (cp > 0) == (mode != tp.EUROPEAN):  # time the European call and the American puts
            log("div-loop", f"{tag}: bitwise equal to the plain loop with its jump table")
            continue
        ms = min(graph_time(launch, iters=10, reps=3))
        plain_ms = event_time(lambda: tp._theta_plain(*ops, mode, jumps=jumps), 1)
        bound, by, chain, old = jump_bound(ops, dtype, node_ms, solves)
        timing[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "chain_ms": chain, "old_chain_ms": old, "solves": int(solves.max()),
                       "reformed_rows": int(reformed.max())}
        log("div-loop", f"{tag}: bitwise equal to the plain loop with its jump table; device "
                        f"ms [{card}]: kernel {ms:.4f} (a CUDA graph of calls), plain loop "
                        f"{plain_ms:.3f} (CUDA events), bound {bound:.4f} ({by}; the chain "
                        f"{chain:.4f}, {chain / ms:.2f} of the kernel; the old count "
                        f"{old:.4f}); {int(solves.max())} solves, {int(reformed.max())} rows "
                        f"re-formed")

    def div_pde(cp, american=False):
        return dv.fdm_price_discrete_dividends(100.0, 100.0, 1.0, 0.05, 0.2, SL_DIVS, cp=cp,
                                               american=american, device=dev)

    prices = {}
    for cp, american in ((1.0, False), (-1.0, False), (-1.0, True)):
        got = div_launches(lambda: div_pde(cp, american))
        check(got == (1, 0, 0), f"the dividend PDE (cp {cp}, american={american}): {got} "
                                f"(jump-table, θ-scheme, tridiag) launches, not (1, 0, 0)")
        prices[cp, american], ms = timed(lambda: div_pde(cp, american), 3)
        timing[f"wall {cp} {american}"] = {"wall_ms": ms}
        log("div-loop", f"fdm_price_discrete_dividends cp={cp} american={american} "
                        f"{DIV_SHAPE[0]}x{DIV_SHAPE[1]}: one jump-table launch, no θ-scheme or "
                        f"tridiagonal launch; warm wall {ms:.2f} ms [{card}]")
    gap = dv.dividend_parity_gap(prices[1.0, False], prices[-1.0, False], 100.0, 100.0, 1.0,
                                 0.05, SL_DIVS)
    check(gap < 0.02, f"dividend PDE parity gap {gap:.2e}")
    check(prices[-1.0, True] > prices[-1.0, False], "the American put is not above the European")
    log("div-loop", f"parity gap {gap:.2e} (< 0.02); American put {prices[-1.0, True]:.5f} > "
                    f"European {prices[-1.0, False]:.5f}; phase "
                    f"{time.perf_counter() - t_phase:.1f} s")
    return worst, timing


# the local-vol loop: _lv_solve at DupireLocalVol.price's defaults (nodes,
# steps) and lv_bermudan_slices at local_vol_american_bracket's (nodes,
# dates, steps a date)
LV_PDE = (201, 200)
LV_BERMUDAN = (401, 25, 8)


def lv_bound(lo, node_ms: dict, n_conts: int) -> tuple[float, str, float, float]:
    """(bound ms, what binds, chain ms, the old count) of one local-vol loop
    launch: the step tables, ψ and v read once, v and the slices written once
    at the card's memory rate; 21 float operations a node a step (the
    factors and the solve) at the peak rate for the dtype; and the chain of
    the contract's solves: every step's factors are formed ahead by the
    producer warps, so only the first step's formation and then each step's
    solve (:func:`warp_chain`) lie on it. The old count (every step's Thomas
    solve, n nodes at the pivot probe's node) beside it."""
    batch, n_time, n = lo.shape
    dtype = lo.dtype
    size = torch.finfo(dtype).bits // 8
    nbytes = (4 * batch * n_time * n + 2 * batch * n_time + 3 * batch * n
              + n_conts * batch * n) * size
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 21.0 * batch * n_time * n / (FP64_FLOPS if size == 8 else FP32_FLOPS) * 1e3
    solve, factors = warp_chain(n, node_ms, dtype)
    chain = factors + n_time * solve
    old = n_time * n * node_ms["pivot"][dtype]
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", chain, old


def lv_launches(fn) -> tuple[int, int]:
    """(local-vol loop, tridiagonal) kernel launches in one call of ``fn``."""
    before = lvp._lv_cuda.launches
    solves = tri_solves(fn)
    return lvp._lv_cuda.launches - before, solves


def phase_lv_loop(dev, card: str, node_ms: dict) -> tuple[float, dict]:
    """The local-vol loop kernel (``csrc/lv_pde.cu``, a block a contract:
    the solving warp and six warps forming the steps' factors ahead) on
    the sample smile: ``_lv_solve``'s European call and American put at
    LV_PDE and ``lv_bermudan_slices``' put at LV_BERMUDAN, float32, and the
    three in float64, each bit for bit the plain loop on the same step
    tables (the slices too), one launch; device ms of the kernel alone (a
    CUDA graph of calls) and of the plain loop by CUDA events beside
    :func:`lv_bound` and the old count; then ``DupireLocalVol.price``, the
    American PDE and the bracket's slices one launch each and no
    tridiagonal launch, their warm walls, and the PDE on a flat surface
    against Black–Scholes. Returns (largest absolute difference, {tag:
    timing})."""
    from optionslab_tpu_torch.models import local_vol_american as lva
    from optionslab_tpu_torch.models.black_scholes import bs_price

    t_phase = time.perf_counter()
    dup = smile_dupire(dev)
    s = dup.surface
    grids = (s.k_grid, s.t_grid, s.grid)
    n_b, dates, spd = LV_BERMUDAN
    cases = (("european call", (100.0, 1.0, 1.0, *LV_PDE, False), lvp.EUROPEAN, 1),
             ("american put", (100.0, 1.0, -1.0, *LV_PDE, False), lvp.PROJECTION, 1),
             ("bermudan put", (100.0, 1.0, -1.0, n_b, dates * spd, True), lvp.BERMUDAN, spd))
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for name, args, mode, steps in cases:
            _, intr, lo, di, up, ends = lvm._lv_tables(*grids, S0, RATE, 0.0, *args)
            ops = [t[None].to(dtype) for t in (lo, di, up, ends, intr, intr)]
            launch, out, conts = lvp._lv_launch(*ops, mode, steps)
            before = lvp._lv_cuda.launches
            launch()
            check(lvp._lv_cuda.launches == before + 1, "local-vol loop: not one launch")
            plain = lvp._lv_plain(*ops, mode, steps)
            torch.cuda.synchronize()
            tag = f"{name} {lo.shape[1]}x{lo.shape[0]}" + \
                ("" if dtype == torch.float32 else " float64")
            worst = max(worst, (out - plain[0]).abs().max().item())
            check(torch.equal(out, plain[0]) and (conts is None) == (plain[1] is None)
                  and (conts is None or torch.equal(conts, plain[1])),
                  f"local-vol loop {tag}: kernel differs from the plain loop")
            ms = min(graph_time(launch, iters=10, reps=3))
            plain_ms = event_time(lambda: lvp._lv_plain(*ops, mode, steps), 1)
            n_conts = dates - 1 if mode == lvp.BERMUDAN else 0
            bound, by, chain, old = lv_bound(ops[0], node_ms, n_conts)
            timing[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                           "chain_ms": chain, "old_chain_ms": old}
            log("lv-loop", f"{tag}: bitwise equal to the plain loop"
                           f"{' (slices too)' if n_conts else ''}; device ms [{card}]: kernel "
                           f"{ms:.4f} (a CUDA graph of calls), plain loop {plain_ms:.3f} (CUDA "
                           f"events), bound {bound:.4f} ({by}; the chain {chain:.4f}, "
                           f"{chain / ms:.2f} of the kernel; the old count {old:.4f})")
    calls = (("DupireLocalVol.price european call 201x200", lambda: dup.price(S0, 100.0, 1.0)),
             ("_lv_solve american put 201x200",
              lambda: lvm._lv_solve(*grids, S0, RATE, 0.0, 100.0, 1.0, -1.0, american=True)),
             (f"lv_bermudan_slices put {n_b}x{dates}x{spd}",
              lambda: lva.lv_bermudan_slices(*grids, S0, RATE, 0.0, 100.0, 1.0, -1.0, dates, spd,
                                             n_b)[1]))
    for name, fn in calls:
        got = lv_launches(fn)
        check(got == (1, 0), f"{name}: {got} (local-vol loop, tridiag) launches, not (1, 0)")
        out, ms = timed(fn, 3)
        on_card(out)
        check(bool(torch.isfinite(out).all()), f"{name}: not finite")
        timing[name] = {"wall_ms": ms}
        log("lv-loop", f"{name}: one local-vol loop launch, no tridiagonal launch; warm wall "
                       f"{ms:.2f} ms [{card}]")
    flat = smile_dupire(dev, flat=True)
    got = flat.price(S0, 100.0, 1.0).item()
    want = bs_price(torch.tensor(S0, device=dev), 100.0, 1.0, RATE, 0.2, 1.0).item()
    check(abs(got - want) < 0.02, f"the local-vol PDE on a flat surface {got:.5f} vs "
                                  f"Black–Scholes {want:.5f}")
    log("lv-loop", f"flat 0.2 surface: the PDE {got:.5f} vs Black–Scholes {want:.5f} (< 0.02, "
                   f"tests/test_torch_local_vol.py); phase {time.perf_counter() - t_phase:.1f} s")
    return worst, timing


# the Douglas ADI kernels (csrc/heston_adi.cu): the CPU tests' grid, then
# the defaults of heston_fdm_price/_greeks, of the ADI bracket
# (heston_american_bracket: 50 dates x 8 steps), of /american heston (25 x
# 8) and of slv_american_bracket (161 x 81, 25 dates x 8 steps, 25 x 4
# leverage rows of 31 bins)
ADI_SMALL = (41, 21, 16)
ADI_BERMUDAN = ((50, 8), (25, 8))
ADI_SLV = (161, 81, 25, 8, 100, 31)
# the reverse kernel against the plain reverse and autograd of the plain
# loop, relative to each gradient's largest entry: the same float32 terms
# summed in other orders (warp trees and per-slot sums over 200 steps
# against torch's reductions)
ADI_GRAD_RTOL = 1e-4
ADI_NAMES = ha._INPUTS


def adi_leverage(n_rows: int, n_bins: int, seed: int = 5):
    """Smooth positive leverage rows by relative log-spot from a numpy seed."""
    rng = np.random.default_rng(seed)
    x_rows = np.sort(rng.uniform(-1.5, 1.5, (n_rows, n_bins)), axis=1).astype(np.float32)
    l_rows = 1.0 + 0.3 * np.sin(2.0 * x_rows + rng.uniform(0, 3, (n_rows, 1)))
    return torch.tensor(x_rows), torch.tensor(l_rows.astype(np.float32))


def adi_cases(dev):
    """(tag, ops, slv, mode, steps a date) of the forward kernel's checks."""
    from optionslab_tpu_torch.models import heston_fdm as hf

    hp = hmodel.HestonParams.make(*SL_HESTON, device=dev)
    cases = []
    for n_x, n_v, n_t in (ADI_SMALL, SL_ADI):
        for cp, mode in ((1.0, ha.EUROPEAN), (-1.0, ha.AMERICAN)):
            ops, _ = hf._adi_setup(100.0, 100.0, 1.0, 0.05, 0.0, cp, hp, n_x, n_v, n_t,
                                   mode == ha.AMERICAN, dev)
            cases.append((f"{'european' if cp > 0 else 'american'} {n_x}x{n_v}x{n_t}", ops,
                          None, mode, 1))
    for n_x, n_v, (n_dates, spd) in ((41, 21, (4, 4)), *((201, 101, b) for b in ADI_BERMUDAN)):
        ops, _ = hf._adi_setup(100.0, 100.0, 1.0, 0.05, 0.0, -1.0, hp, n_x, n_v, n_dates * spd,
                               True, dev)
        cases.append((f"bermudan {n_x}x{n_v} {n_dates}x{spd}", ops, None, ha.BERMUDAN, spd))
    slvp = hmodel.HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7, device=dev)
    n_x, n_v, n_dates, spd, n_rows, n_bins = ADI_SLV
    for nx_, nv_, nd_, sp_, rows_ in ((41, 21, 4, 4, 8), (n_x, n_v, n_dates, spd, n_rows)):
        x_rows, l_rows = adi_leverage(rows_, n_bins)
        ops, slv, _, _ = hf._slv_setup(100.0, 100.0, 1.0, 0.03, 0.0, -1.0, slvp, 0.7, x_rows,
                                       l_rows, nx_, nv_, nd_, sp_, dev)
        cases.append((f"slv {nx_}x{nv_} {nd_}x{sp_}", ops, slv, ha.BERMUDAN, sp_))
    return cases


def adi_bound(n_x: int, n_v: int, n_t: int, node_ms: dict, slv: bool = False,
              reverse: bool = False):
    """(bound ms, what binds, chain ms, the old count of the chain) of one
    loop: the bytes (the operands and the start read once, the grid written
    once; the reverse also reads the three grids a step it kept and writes a
    gradient of each operand) at the card's memory rate; the float
    operations (≈40 a node a step forward, the stencils, the predictor and
    two solves of 8; ≈70 in reverse) at its float32 peak; and the dependent
    chain, a step's x-sweep and v-sweep one after the other: (n_x + n_v)
    nodes a step at the right-hand-side probe's node (every sweep on tables
    formed once; the SLV x-sweep's n_x at the pivot probe's), and the tables'
    one-time formation, n_x + n_v pivots (n_v under SLV) with no back node:
    the pivot probe's node less a back node alone. The old count charged
    every node of every step the pivot probe's node."""
    pivot, rhs, back = (node_ms[k][torch.float32] for k in ("pivot", "rhs", "back"))
    cells = n_x * n_v
    nbytes = 4 * (cells * (10 + 3 * n_t if reverse else 9) + n_t * 2 + 6 * n_v)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (70.0 if reverse else 40.0) * cells * n_t / FP32_FLOPS * 1e3
    if slv:
        chain = n_t * (n_x * pivot + n_v * rhs) + n_v * (pivot - back)
    else:
        chain = n_t * (n_x + n_v) * rhs + (n_x + n_v) * (pivot - back)
    old = n_t * (n_x + n_v) * pivot
    bound = max(t_bytes, t_ops, chain)
    return bound, "bytes" if t_bytes >= bound else "operations", chain, old


# grids (n_x, n_v) of the step-cost fit, ADI_FIT_STEPS European steps each
ADI_FIT_GRIDS = ((201, 101), (101, 101), (201, 51), (401, 101), (201, 201), (301, 61))
ADI_FIT_STEPS = 50
# a grid (n_x, n_v, steps) that no cluster holds: the cooperative route
ADI_COOP = (1001, 201, 16)


def step_fit(points) -> tuple[float, float, float, float]:
    """(c0, cx, cv, largest residual) of t = c0 + cx·n_x + cv·n_v fitted by
    least squares to (n_x, n_v, µs a step) points."""
    rows = np.array([(1.0, n_x, n_v) for n_x, n_v, _ in points])
    times = np.array([t for _, _, t in points])
    (c0, cx, cv), *_ = np.linalg.lstsq(rows, times, rcond=None)
    worst = float(np.abs(rows @ np.array([c0, cx, cv]) - times).max())
    return float(c0), float(cx), float(cv), worst


def fit_line(what: str, points, card: str, node_ms: dict) -> dict:
    """Logs a step fit (:func:`step_fit`) beside the chain probes' nodes and
    returns {c0, cx, cv} in µs."""
    c0, cx, cv, worst = step_fit(points)
    clock = sm_clock_hz()
    log("adi", f"{what}, µs by CUDA events on (n_x, n_v) = "
               f"{tuple((n_x, n_v) for n_x, n_v, _ in points)} [{card}]: "
               + ", ".join(f"{t:.2f}" for _, _, t in points)
               + f"; fit {c0:.2f} + {cx:.4f}·n_x + {cv:.4f}·n_v (largest residual "
               f"{worst:.2f}): a node {cx * 1e-6 * clock:.0f} cycles in the x phase, "
               f"{cv * 1e-6 * clock:.0f} in the v phase, against the chain probes' "
               f"{node_ms['rhs'][torch.float32] * 1e-3 * clock:.1f} (right-hand side) and "
               f"{node_ms['pivot'][torch.float32] * 1e-3 * clock:.1f} (pivot)")
    return {"c0": c0, "cx": cx, "cv": cv}


def adi_fit_ops(dev, n_x: int, n_v: int):
    """The European loop's operands of a step-fit grid, ADI_FIT_STEPS steps."""
    from optionslab_tpu_torch.models import heston_fdm as hf

    hp = hmodel.HestonParams.make(*SL_HESTON, device=dev)
    return hf._adi_setup(100.0, 100.0, 1.0, 0.05, 0.0, 1.0, hp, n_x, n_v, ADI_FIT_STEPS, False,
                         dev)[0]


def adi_step_fit(dev, card: str, node_ms: dict) -> dict:
    """Where a forward step's time goes: device µs a step (CUDA events) of
    the European loop on ADI_FIT_GRIDS (each a cluster by the plan), fitted
    by least squares to t = c0 + cx·n_x + cv·n_v. cx and cv are a node's
    cost in the x- and v-sweep phases (the solve and the node-parallel work
    around it), c0 the rest (the barriers, a phase's fixed staging); set
    beside the chain probes' nodes. Returns {c0, cx, cv} in µs."""
    points = []
    for n_x, n_v in ADI_FIT_GRIDS:
        ops = adi_fit_ops(dev, n_x, n_v)
        check(ha.cluster_plan(n_v, n_x) > 0, f"the plan puts {n_x} x {n_v} in no cluster")
        ha._adi_cuda(ops, ops.intrinsic, ha.EUROPEAN)
        ms = event_time(lambda: ha._adi_cuda(ops, ops.intrinsic, ha.EUROPEAN), 5)
        points.append((n_x, n_v, ms / ADI_FIT_STEPS * 1e3))
    return fit_line("a forward step on the cluster route", points, card, node_ms)


def adi_reverse_fit_inputs(dev):
    """(n_x, n_v, ops, history, weight) of the reverse step fit: the
    European loop's history on each grid of ADI_FIT_GRIDS that the reverse
    plan puts in a cluster (its bands hold every accumulator: not 401 x 101
    nor 201 x 201, which take the cooperative route)."""
    for n_x, n_v in ADI_FIT_GRIDS:
        if not ha.adjoint_cluster_plan(n_v, n_x):
            continue
        ops = adi_fit_ops(dev, n_x, n_v)
        _, _, hist = ha._adi_cuda(ops, ops.intrinsic, ha.EUROPEAN, history=True)
        weight = torch.tensor(np.random.default_rng(n_x + n_v).normal(size=(n_v, n_x)),
                              dtype=torch.float32, device=dev)
        yield n_x, n_v, ops, hist, weight


def adi_reverse_step_fit(dev, card: str, node_ms: dict) -> dict:
    """Where a reverse step's time goes: device µs a step (CUDA events) of
    the reverse kernel on the cluster route over adi_reverse_fit_inputs,
    fitted as :func:`adi_step_fit` fits the forward. Returns {c0, cx, cv}."""
    points = []
    for n_x, n_v, ops, hist, weight in adi_reverse_fit_inputs(dev):
        def run():
            ha._adi_adjoint_cuda(ops, ops.intrinsic, hist, weight, False)
        run()
        points.append((n_x, n_v, event_time(run, 5) / ADI_FIT_STEPS * 1e3))
    return fit_line("a reverse step on the cluster route", points, card, node_ms)


def adi_grad_gap(got, want) -> float:
    """The largest difference of two lists of gradients, each relative to
    the largest entry of its reference gradient."""
    return max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def adi_coop_cases(dev):
    """(tag, ops, slv, mode, steps a date) of the forward kernel's four modes
    at ADI_COOP's grid, which takes the cooperative route by the plan."""
    from optionslab_tpu_torch.models import heston_fdm as hf

    hp = hmodel.HestonParams.make(*SL_HESTON, device=dev)
    n_x, n_v, n_t = ADI_COOP
    cases = []
    for cp, mode in ((1.0, ha.EUROPEAN), (-1.0, ha.AMERICAN)):
        ops, _ = hf._adi_setup(100.0, 100.0, 1.0, 0.05, 0.0, cp, hp, n_x, n_v, n_t,
                               mode == ha.AMERICAN, dev)
        cases.append((f"{'european' if cp > 0 else 'american'} {n_x}x{n_v}x{n_t}", ops, None,
                      mode, 1))
    ops, _ = hf._adi_setup(100.0, 100.0, 1.0, 0.05, 0.0, -1.0, hp, n_x, n_v, n_t, True, dev)
    cases.append((f"bermudan {n_x}x{n_v} 4x4", ops, None, ha.BERMUDAN, 4))
    x_rows, l_rows = adi_leverage(8, ADI_SLV[5])
    slvp = hmodel.HestonParams.make(0.04, 2.0, 0.04, 0.5, -0.7, device=dev)
    ops, slv, _, _ = hf._slv_setup(100.0, 100.0, 1.0, 0.03, 0.0, -1.0, slvp, 0.7, x_rows,
                                   l_rows, n_x, n_v, 4, 4, dev)
    cases.append((f"slv {n_x}x{n_v} 4x4", ops, slv, ha.BERMUDAN, 4))
    return cases


def phase_heston_adi(dev, card: str, node_ms: dict) -> tuple[float, dict, dict]:
    """The ADI kernels against their plain versions on the card: the forward
    kernel bit for bit against the plain loop (the grid, the continuation
    slices and the history the reverse reads) in its four modes at the CPU
    tests' grid and at the defaults, where the plan takes a cluster, and at
    ADI_COOP, where it takes the cooperative kernel; one launch a loop; the
    reverse kernel's gradients of every input of ``_AdiLoop`` against the plain
    reverse and autograd through the plain loop (European and American, on
    the cluster of ``adjoint_cluster_plan`` at the small and default grids and
    on the cooperative route at ADI_COOP; one launch, a second launch bit for
    bit the first); device ms by CUDA events of each kernel, route and plain
    version beside the chain bound (recounted, and the old count); the
    forward's and the reverse's step fits. Returns (largest forward
    difference, {tag: timing}, {"rel": largest relative gradient gap, "abs":
    largest absolute difference to the plain reverse})."""
    t_phase = time.perf_counter()
    worst, timing = 0.0, {}
    for tag, ops, slv, mode, spd in adi_cases(dev) + adi_coop_cases(dev):
        start = ops.intrinsic
        history = slv is None and mode != ha.BERMUDAN
        n_t, (n_v, n_x) = ops.bounds.shape[0], start.shape
        plan = ha.cluster_plan(n_v, n_x)
        check((plan == 0) == (n_x == ADI_COOP[0]),
              f"heston_adi {tag}: the plan is {plan} CTAs")
        plain = ha._adi_plain(ops, start, mode, spd, slv, history)
        before = ha._adi_cuda.launches
        kern = ha._adi_cuda(ops, start, mode, spd, slv, history)
        check(ha._adi_cuda.launches == before + 1, f"heston_adi {tag}: not one launch")
        torch.cuda.synchronize()
        pairs = [(kern[0], plain[0])] + ([(kern[1], plain[1])] if mode == ha.BERMUDAN else [])
        if history:
            pairs += list(zip(kern[2], plain[2]))
        name = f"a cluster of {plan}" if plan else "the cooperative kernel"
        for k_, p_ in pairs:
            diff = (k_ - p_).abs().max().item()
            worst = max(worst, diff)
            check(torch.equal(k_, p_), f"heston_adi {tag} ({name}): the kernel differs from "
                                       f"the plain loop by {diff:.3e}")
        log("adi", f"{tag} ({name} by the plan): bitwise equal ({len(pairs)} arrays)")
        if n_x == 41:
            continue
        plain_ms = event_time(lambda: ha._adi_plain(ops, start, mode, spd, slv), 1)
        bound, by, chain, old = adi_bound(n_x, n_v, n_t, node_ms, slv=slv is not None)
        ms = event_time(lambda: ha._adi_cuda(ops, start, mode, spd, slv), 5)
        timing[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                       "chain_ms": chain, "old_chain_ms": old, "ctas": plan}
        log("adi", f"{tag} ({name}): device ms by CUDA events [{card}]: kernel {ms:.4f}, plain "
                   f"loop {plain_ms:.3f}; bound {bound:.4f} ({by}; the chain {chain:.4f}, "
                   f"{chain / ms:.2f} of the kernel; the old count {n_t} x ({n_x} + {n_v}) "
                   f"pivot nodes {old:.4f}); {ms / n_t * 1e3:.2f} us a step")
    log("adi", "every mode bitwise equal to the plain loop on the route of its plan")
    timing["fit"] = adi_step_fit(dev, card, node_ms)

    gap = {"rel": 0.0, "abs": 0.0}
    for tag, ops, slv, mode, spd in adi_cases(dev) + adi_coop_cases(dev):
        if mode == ha.BERMUDAN:
            continue
        start, american = ops.intrinsic, mode == ha.AMERICAN
        n_t, (n_v, n_x) = ops.bounds.shape[0], start.shape
        ctas, blocks = ha._adjoint_route(n_v, n_x, dev)
        check((ctas == 0) == (n_x == ADI_COOP[0]),
              f"heston_adi adjoint {tag}: the route is {ctas} CTAs")
        name = f"a cluster of {ctas}" if ctas else f"the cooperative kernel on {blocks} blocks"
        weight = torch.tensor(np.random.default_rng(n_x).normal(size=(n_v, n_x)),
                              dtype=torch.float32, device=dev)
        _, _, hist = ha._adi_cuda(ops, start, mode, history=True)
        before = ha._adi_adjoint_cuda.launches
        got = ha._adi_adjoint_cuda(ops, start, hist, weight, american)
        check(ha._adi_adjoint_cuda.launches == before + 1, f"heston_adi adjoint {tag}: not one "
                                                           "launch")
        again = ha._adi_adjoint_cuda(ops, start, hist, weight, american)
        torch.cuda.synchronize()
        check(all(torch.equal(g_, a_) for g_, a_ in zip(got, again)),
              f"heston_adi adjoint {tag} ({name}): two launches differ")
        plain = []  # timed on its one call: host-issued, ≈10 s at the defaults
        plain_ms = event_time(lambda: plain.append(
            ha._adi_reverse_plain(ops, start, hist, weight, american)), 1)
        plain = plain[0]
        leaves = [x.detach().clone().requires_grad_(True) for x in (
            *ops.x_stencil, *ops.x_sweep, *ops.v_stencil, *ops.v_sweep, ops.mixed, ops.dt,
            ops.bounds, ops.intrinsic, start)]
        grid = ha._adi_plain(*ha._ops_of(ops.den, leaves), mode)[0]
        auto = torch.autograd.grad((grid * weight).sum(), leaves, allow_unused=True)
        auto = [torch.zeros_like(x) if g_ is None else g_ for g_, x in zip(auto, leaves)]
        g_plain, g_auto = adi_grad_gap(got, plain), adi_grad_gap(got, auto)
        gap["rel"] = max(gap["rel"], g_plain, g_auto)
        gap["abs"] = max([gap["abs"]] + [(g_ - w_).abs().max().item()
                                         for g_, w_ in zip(got, plain)])
        each = {k_: adi_grad_gap([g_], [w_]) for k_, g_, w_ in zip(ADI_NAMES, got, auto)}
        check(g_plain < ADI_GRAD_RTOL and g_auto < ADI_GRAD_RTOL,
              f"heston_adi adjoint {tag}: {g_plain:.2e} off the plain reverse, {g_auto:.2e} off "
              f"autograd of the plain loop ({each})")
        log("adi", f"adjoint {tag} ({name} by the plan): one launch, two launches bitwise "
                   f"equal; largest relative gap to the plain reverse {g_plain:.2e}, to autograd "
                   f"of the plain loop {g_auto:.2e} (< {ADI_GRAD_RTOL}); by input vs autograd: "
                   + ", ".join(f"{k_} {v_:.1e}" for k_, v_ in each.items()))
        if n_x == 41:
            continue
        ms = event_time(lambda: ha._adi_adjoint_cuda(ops, start, hist, weight, american), 5)
        bound, by, chain, old = adi_bound(n_x, n_v, n_t, node_ms, reverse=True)
        timing[f"adjoint {tag}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                    "bound_by": by, "chain_ms": chain, "old_chain_ms": old,
                                    "ctas": ctas}
        log("adi", f"adjoint {tag} ({name}): device ms by CUDA events [{card}]: kernel "
                   f"{ms:.4f}, plain "
                   f"reverse {plain_ms:.3f}, bound {bound:.4f} ({by}; the chain {chain:.4f}, "
                   f"{chain / ms:.2f} of the kernel; the old count {old:.4f}, "
                   f"{old / ms:.2f}); {ms / n_t * 1e3:.2f} us a step")
    timing["adjoint fit"] = adi_reverse_step_fit(dev, card, node_ms)
    log("adi", f"phase {time.perf_counter() - t_phase:.1f} s")
    return worst, timing, gap


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
    # the Douglas loop: one launch of the ADI kernel a solve, no tridiagonal one
    got = adi_launches(lambda: adi("put", 100.0, american=True))
    check(got == (1, 0, 0), f"heston_fdm_price: (ADI, adjoint, tridiag) launches {got}, not "
                            f"(1, 0, 0)")
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
    got = adi_launches(lambda: hf.heston_fdm_greeks(100.0, 100.0, 1.0, 0.05, hp0,
                                                    option_type="put", device=dev))
    check(got == (2, 1, 0), f"heston_fdm_greeks: (ADI, adjoint, tridiag) launches {got}, not "
                            f"(2, 1, 0)")
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
    got = adi_launches(lambda: adi_bracket(2))
    check(got == (1, 0, 0), f"the ADI bracket: (ADI, adjoint, tridiag) launches {got}")
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
    got = adi_launches(lambda: slv_bracket(2))
    check(got == (1, 0, 0), f"the SLV bracket: (ADI, adjoint, tridiag) launches {got}")
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
    c0 = record("fdm_price_discrete_dividends european 401x400", lambda: div_pde(1.0, []))
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
                  lambda: div_pde(-1.0, american=True))
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
RK_FDM_2ND = 16  # the PDE's second-order Greeks, the first 16 calls of that book
# gamma and vomma of the PDE (float32, 201 x 100) against Black–Scholes: ≈4x
# the gaps a CPU run of the same calls shows (3.4e-4 and 0.37)
RK_FDM_2ND_TOLS = {"gamma": 1.5e-3, "vomma": 1.5}
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
    # each call one θ-scheme launch forward and one of its reverse kernel
    gf = record(f"greeks_fdm european {n_call} calls 201x100",
                lambda: gr.greeks_fdm(*calls[:5], "call", calls[5]))
    ex = bs_greeks(*calls[:5], 1.0, calls[5])
    d_err = (gf["delta"] - ex["delta"]).abs().max().item()
    v_err = (gf["vega"] - ex["vega"]).abs().max().item()
    check(d_err < 5e-3 and v_err < 0.5, f"greeks_fdm vs BS: delta {d_err}, vega {v_err}")
    ga = record(f"greeks_fdm american {RK_FDM_BOOK - n_call} puts 201x100",
                lambda: gr.greeks_fdm(*puts[:5], "put", puts[5], american=True))
    for name, fn in (("european", lambda: gr.greeks_fdm(*calls[:5], "call", calls[5])),
                     ("american", lambda: gr.greeks_fdm(*puts[:5], "put", puts[5],
                                                        american=True))):
        before = tp._theta_adjoint_cuda.launches
        got = loop_launches(fn)
        check(got == (1, 0) and tp._theta_adjoint_cuda.launches == before + 1,
              f"greeks_fdm {name}: {got} (θ-scheme, tridiag) launches and "
              f"{tp._theta_adjoint_cuda.launches - before} reverse launches, not (1, 0) and 1")
    lat = bn.binomial_greeks(ContractBatch(*puts[:5], puts[5], -torch.ones_like(puts[0])),
                             american=True, n_steps=2048)
    a_err = (ga["delta"] - lat["delta"]).abs().max().item()
    check(a_err < 1e-2 and bool((ga["price"] >= bs_price(*puts[:5], -1.0, puts[5]) - 1e-3).all()),
          f"American greeks_fdm delta off the lattice by {a_err}")
    on_card(gf["delta"], ga["delta"])
    log("risk", f"greeks_fdm vs BS: max |delta| {d_err:.2e}, |vega| {v_err:.3f}; American "
                f"delta vs CRR@2048 {a_err:.2e}")
    # the PDE's second-order Greeks: the first gradient is asked for with a
    # graph, so the θ-scheme Function's backward reruns the plain loop under
    # autograd (a tridiagonal launch a solve each way; vomma differentiates
    # it); vanna and charm differentiate delta, which reads the loop's values
    # directly, through a first-order backward: one reverse launch a call
    book2 = [x[:RK_FDM_2ND] for x in calls]

    def fdm_second():
        return gr.greeks_from_fn(gr.fdm_price_fn(1.0), *book2, second_order=True)

    before = tp._theta_adjoint_cuda.launches, tri._tridiag_cuda.launches
    fdm_second()
    torch.cuda.synchronize()
    check(tp._theta_adjoint_cuda.launches == before[0] + 1
          and tri._tridiag_cuda.launches > before[1],
          f"the second-order PDE Greeks ran {tp._theta_adjoint_cuda.launches - before[0]} "
          f"reverse launches and {tri._tridiag_cuda.launches - before[1]} tridiagonal ones, "
          f"not one and the recompute's")
    g2 = record(f"greeks_from_fn fdm second order {RK_FDM_2ND} calls 201x100", fdm_second)
    ex2 = bs_greeks(*book2[:5], 1.0, book2[5])
    g_err = {k: (g2[k] - ex2[k]).abs().max().item() for k in RK_FDM_2ND_TOLS}
    check(all(g_err[k] < tol for k, tol in RK_FDM_2ND_TOLS.items()),
          f"second-order PDE Greeks vs BS: {g_err} (bounds {RK_FDM_2ND_TOLS})")
    log("risk", f"second-order PDE Greeks vs BS, max abs: {g_err} (bounds {RK_FDM_2ND_TOLS}); "
                f"the recompute's tridiagonal launches and one reverse launch a call")

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
              "theta_pde": tp._theta_cuda, "theta_pde_adjoint": tp._theta_adjoint_cuda,
              "theta_jump": tp._theta_jumps_cuda, "lv_pde": lvp._lv_cuda,
              "heston_adi": ha._adi_cuda,
              "heston_adi_adjoint": ha._adi_adjoint_cuda}


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


def warm_call(name: str, fn, warm, kernels, stats: dict, card: str, phase: str = "surface"):
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
    log(phase, f"{name}: warm wall {ms:.1f} ms, {n} CUDA kernels"
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
                                  lambda: None, lambda s=strike, m=mat: cuda_kernels(
                                      lambda: lv.price(synth.spot, s, m)), stats, card)
        check(launched == {"lv_pde": 1}, f"the PDE made launches {launched}, not one of the "
                                         "local-vol loop")
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


# ---------------------------------------------------------------------------
# the learned surfaces, the pricing surrogate and optimize/
# ---------------------------------------------------------------------------
LN_HV = 0.2  # the CBOE file carries no historical vol: one number for the underlying,
# so that no quote's own implied vol leaks into its features
LN_ENSEMBLE = 4
LN_SURROGATE_N = 50_000  # MonteCarloMLSurrogate.fit's default
LN_PRICER_N = 20_000  # fit_to_pricer's default
LN_LABEL_PATHS = 1_048_576  # the label launch's paths a contract
LN_LABEL_FLOOR = 1e-6  # float32 resolution of the O(1) labels (price/K, delta, gamma·K)
LN_POISSON = 25.0  # expected in-the-money paths below which a label is a Poisson count
LN_QUAD = (10.0, 20_001)  # the error model's range and nodes in the Box–Muller normal
LN_R2 = {"r2_delta": 0.99, "r2_price": 0.95}  # tests/test_ml_vs_mc.py:138
LN_COVERAGE = 0.85  # tests/test_ml_vs_mc.py:60
LN_STUDY_TRIALS = 40
LN_FIT_TRIALS = 3
LN_BATCHES = (1, 7, 64, 1000)  # the exports' validation batch sizes
LN_ONNX_ATOL = 2e-5  # onnx_emit.export_surface_model_onnx's parity bound
LN_SURROGATE_ONNX_ATOL = 2e-4  # MonteCarloMLSurrogate.export_onnx's


def learned_frame(table):
    """The 7 engineered features of a chain table, its historical vol set to
    ``LN_HV``."""
    from optionslab_tpu_torch.surface import engineer_features

    t = table.copy()
    t["historical_volatility"] = LN_HV
    return engineer_features(t)


def cut_kernels(fn, owner, attr: str, tracked: bool = False) -> int:
    """CUDA kernels of ``fn()``, a call made of training loops
    ``owner.attr(..., epochs=E, ...)`` and the work around them: profiled
    with every loop cut to one epoch, then with each loop in turn at two;
    each loop adds (E − 1) times its epoch's kernels. With ``tracked`` (the
    PINN's loop, which tracks its best iterate from ``track_from`` on) the
    cut epochs are untracked, and one more profile with one tracked epoch
    gives the tracking's kernels, added (E − track_from) times. Each profile
    the most of two sessions."""
    real = getattr(owner, attr)
    state = {"mode": None, "loops": []}

    def cut(*args, **kw):
        i = len(state["loops"])
        state["loops"].append((kw["epochs"], kw.get("track_from")))
        mode = state["mode"][1] if state["mode"] and state["mode"][0] == i else None
        epochs = 2 if mode else 1
        if tracked:
            kw["track_from"] = 1 if mode == "tracked" else epochs
        return real(*args, **{**kw, "epochs": epochs})

    def run():
        state["loops"] = []
        fn()

    setattr(owner, attr, cut)
    try:
        base = cuda_kernels(run, 2)
        total = base
        for i, (epochs, track_from) in enumerate(list(state["loops"])):
            state["mode"] = (i, "untracked")
            per_epoch = cuda_kernels(run, 2) - base
            total += (epochs - 1) * per_epoch
            if tracked:
                state["mode"] = (i, "tracked")
                total += (epochs - track_from) * (cuda_kernels(run, 2) - base - per_epoch)
    finally:
        setattr(owner, attr, real)
    return total


def label_error_model(b: ContractBatch, n_paths: int, chunk: int = 256):
    """The GBM kernel's label estimators (price/K, delta, gamma·K, each a mean
    over ``n_paths`` branches of one Box–Muller normal z, in antithetic
    pairs z, −z) at each contract of ``b``: (3, n) exact standard errors, the
    expected number of in-the-money branches (n,) and the mean |term| a
    branch adds given in the money (3, n), divided by ``n_paths``. The
    moments are Gaussian integrals, by the trapezoid rule on the card in
    float64."""
    lim, nodes = LN_QUAD
    z = torch.linspace(-lim, lim, nodes, dtype=torch.float64, device=b.spot.device)
    w = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi) * (2.0 * lim / (nodes - 1))
    w[0] *= 0.5
    w[-1] *= 0.5
    se, lam, per = [], [], []
    for lo in range(0, len(b.spot), chunk):
        s0, k, t, r, v, q, cp = (getattr(b, f)[lo:lo + chunk].double()[:, None]
                                 for f in FDM_FIELDS)
        drift, sd, df = (r - q - 0.5 * v * v) * t, v * torch.sqrt(t), torch.exp(-r * t)

        def terms(zz):
            st = s0 * torch.exp(drift + sd * zz)
            x = cp * (st - k)
            ind = torch.where(x > 0, st, 0.0)
            return torch.stack([df * torch.clamp_min(x, 0.0) / k, df * cp * ind / s0,
                                df * cp * (ind * zz / sd - ind) / s0**2 * k]), x > 0

        g, itm = terms(z)
        g_anti, _ = terms(-z)
        mean = (g * w).sum(-1)
        var_pair = 0.5 * ((g * g * w).sum(-1) + (g * g_anti * w).sum(-1)) - mean**2
        p_itm = (itm * w).sum(-1)
        se.append(torch.sqrt(torch.clamp_min(var_pair, 0.0) / (n_paths / 2)))
        lam.append(n_paths * p_itm)
        per.append((g.abs() * w).sum(-1) / torch.clamp_min(p_itm, 1e-300) / n_paths)
    return torch.cat(se, 1), torch.cat(lam), torch.cat(per, 1)


class FixedTrial:
    """A study trial whose suggestions are given: one objective call again."""

    def __init__(self, params: dict):
        self.params = params

    def suggest_float(self, name, *args, **kwargs):
        return self.params[name]

    suggest_int = suggest_categorical = suggest_float

    def report(self, value, step):
        pass

    def should_prune(self) -> bool:
        return False


def fitted(model, method: str, *args, **kwargs):
    getattr(model, method)(*args, **kwargs)
    return model


def phase_learned(dev, card: str) -> dict:
    """The learned surfaces, the pricing surrogate and ``optimize/`` at their
    defaults: MLP, PINN (one fit and a 4-member ensemble), kernel ridge and
    the quote interpolator on the CBOE chain (every 7th quote held out), the
    forests' missing-dependency error, ``torch.export`` and ``.onnx`` exports
    held to the live MLP; the surrogate on closed-form labels and on one GBM
    kernel book launch of labels; a TPE study with a resume, a surrogate
    study and a study around ``calibrate_heston_mc``. Returns {"stats":
    {fit: (ms, kernels)}, "gbm": GBM kernel calls, "chain": the calibration
    study's chain launches}."""
    import tempfile

    from optionslab_tpu_torch import optimize as opt
    from optionslab_tpu_torch.models import surrogate as sg
    from optionslab_tpu_torch.models.black_scholes import bs_price
    from optionslab_tpu_torch.surface import (
        GradientBoostingVolatilityModel,
        KernelRidgeModel,
        MLPModel,
        PINNVolatilityModel,
        RandomForestVolatilityModel,
        VolatilitySurfaceGenerator,
        XGBVolatilityModel,
    )
    from optionslab_tpu_torch.surface import mlp as smlp
    from optionslab_tpu_torch.surface import pinn as spinn
    from optionslab_tpu_torch.surface.base import TARGET_COLUMN
    from optionslab_tpu_torch.utils.exceptions import DependencyError, ModelError

    t_phase = time.perf_counter()
    stats, calls = {}, {"gbm": 0}
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 matrix products are on")
    held, used = vendor_chain(dev)
    train, test = learned_frame(used.table), learned_frame(held)
    y_test = np.asarray(test[TARGET_COLUMN], np.float64)
    const_rmse = float(np.sqrt(np.mean((y_test - np.mean(train[TARGET_COLUMN])) ** 2)))
    n_q = f"CBOE {len(train)} quotes"

    def record(name, fn, warm, kernels):
        return warm_call(name, fn, warm, kernels, stats, card, phase="learned")[0]

    # the MLP at its defaults: (64, 32), 300 epochs, batch 64
    mlp = record(f"MLPModel.train {n_q}, (64, 32), 300 epochs, batch 64",
                 lambda: fitted(MLPModel(device=dev), "train", train),
                 lambda: MLPModel(epochs=2, device=dev).train(train),
                 lambda: cut_kernels(lambda: MLPModel(device=dev).train(train), smlp,
                                     "train_mlp"))
    mlp_rmse = mlp.evaluate(test)["rmse"]
    check(mlp_rmse < const_rmse, f"MLP held-out rmse {mlp_rmse} vs the constant's {const_rmse}")
    mean, std = mlp.predict_with_uncertainty(test, mc_samples=32)
    check(mean.shape == (len(test),) and bool(np.all(std >= 0)) and std.max() > 0,
          f"MC dropout: mean {mean.shape}, std max {std.max()}")
    grads = mlp.input_gradients(test)
    check(grads.shape == (len(test), 7) and bool(np.all(np.isfinite(grads))),
          f"input gradients {grads.shape}")
    log("learned", f"MLP held-out IV rmse {mlp_rmse:.5f} (the constant predictor's "
                   f"{const_rmse:.5f}); MC-dropout std median {np.median(std):.5f}")

    # the PINN at its defaults: (64, 64), 1200 epochs, 512 collocation points, medium
    pinn = record(f"PINNVolatilityModel.train {n_q}, (64, 64), 1200 epochs, 512 collocation",
                  lambda: fitted(PINNVolatilityModel(device=dev), "train", train),
                  lambda: PINNVolatilityModel(epochs=3, device=dev).train(train),
                  lambda: cut_kernels(lambda: PINNVolatilityModel(device=dev).train(train),
                                      spinn, "_train_pinn_core", tracked=True))
    fit_rmse, pinn_held = pinn.evaluate(train)["rmse"], pinn.evaluate(test)["rmse"]
    audit = pinn.check_arbitrage(n_k=41, n_t=9)
    check(fit_rmse < 0.012, f"PINN rmse {fit_rmse} (tests/test_surface_models.py:163)")
    check(audit["calendar_violation_rate"] <= 0.05 and audit["butterfly_violation_rate"] <= 0.10,
          f"PINN audit {audit}")
    ens = record(f"PINNVolatilityModel.train {n_q}, {LN_ENSEMBLE}-member ensemble",
                 lambda: fitted(PINNVolatilityModel(device=dev), "train", train,
                                n_seeds=LN_ENSEMBLE),
                 lambda: PINNVolatilityModel(epochs=3, device=dev).train(train,
                                                                         n_seeds=LN_ENSEMBLE),
                 lambda: cut_kernels(lambda: PINNVolatilityModel(device=dev).train(
                     train, n_seeds=LN_ENSEMBLE), spinn, "_train_pinn_core", tracked=True))
    sel = ens.ensemble_selection
    i = sel["index"]
    check(ens.ensemble_best_losses.shape == (LN_ENSEMBLE,)
          and i == spinn.select_ensemble_member(sel["rmse"], sel["max_violation"]),
          f"ensemble selection {sel}")
    check(all(torch.equal(v, ens.ensemble_params[j][k][i]) for j, layer in enumerate(ens.params)
              for k, v in layer.items()), "the kept params are not the selected member's")
    band = ens.iv_band(np.asarray(test["log_moneyness"]), np.asarray(test["time_to_maturity"]))
    check(bool(np.all(band["lo"] <= band["mean"] + 1e-7) and np.all(band["mean"] <= band["hi"] + 1e-7))
          and band["std"].max() > 0 and bool(np.all(band["hi"] - band["lo"] < 0.2)),
          f"ensemble band: spread max {np.max(band['hi'] - band['lo'])}")
    ens_audit = ens.check_arbitrage(n_k=41, n_t=9)
    log("learned", f"PINN rmse {fit_rmse:.5f} (held out {pinn_held:.5f}), audit {audit}; "
                   f"ensemble member {i} of rmse {np.array2string(sel['rmse'], precision=5)}, "
                   f"worst violation {np.array2string(sel['max_violation'], precision=3)}, "
                   f"loss argmin {sel['loss_argmin']}, audit {ens_audit}")

    # kernel ridge at its defaults, with a save/load round trip
    kr = record(f"KernelRidgeModel.train {n_q} (gamma 1, alpha 1e-3)",
                lambda: fitted(KernelRidgeModel(device=dev), "train", train),
                lambda: KernelRidgeModel(device=dev).train(train),
                lambda: cuda_kernels(lambda: KernelRidgeModel(device=dev).train(train)))
    kr_held = kr.evaluate(test)["rmse"]
    with tempfile.TemporaryDirectory() as tmp:
        kr.save_model(f"{tmp}/kr")
        again = KernelRidgeModel(device=dev).load_model(f"{tmp}/kr")
        check(np.allclose(again.predict_volatility(test), kr.predict_volatility(test), rtol=1e-5),
              "kernel ridge save/load changed its predictions")
    kr_r2 = kr.evaluate(train)["r2"]
    check(kr_r2 > 0.5 and kr_held < const_rmse,  # tests/test_surface_models.py:275
          f"kernel ridge r2 {kr_r2}, held-out rmse {kr_held}")
    log("learned", f"kernel ridge r2 {kr_r2:.5f}, held-out rmse {kr_held:.5f}")

    # the quote interpolator: rbf, idw, nearest
    k_, t_, v_ = (np.asarray(used.table[c], np.float64)
                  for c in ("strike_price", "time_to_maturity", "implied_volatility"))
    fwd = np.asarray(used.table["underlying_price"], np.float64) * np.exp(SF_RATE * t_)
    call = np.asarray(used.table["option_type"]) == "call"
    otm = np.where(call, k_ >= fwd, k_ < fwd)  # one quote a (strike, expiry): the OTM smile
    hk_, ht_, hv_ = (np.asarray(held[c], np.float64)
                     for c in ("strike_price", "time_to_maturity", "implied_volatility"))
    try:
        VolatilitySurfaceGenerator(k_, t_, v_, method="rbf", device=dev)
        check(False, "the rbf fit on duplicate (strike, expiry) quotes did not raise")
    except ModelError as e:
        log("learned", f"rbf on all {len(k_)} quotes (a call and a put at each strike): {e}")
    t0 = time.perf_counter()
    rbf = VolatilitySurfaceGenerator(k_[otm], t_[otm], v_[otm], method="rbf", device=dev)
    at_quotes = np.abs(rbf.get_surface_batch(k_[otm], t_[otm]) - v_[otm]).max()
    torch.cuda.synchronize()
    rbf_ms = (time.perf_counter() - t0) * 1e3
    check(at_quotes <= 1e-3, f"rbf off the quotes by {at_quotes} (tests/test_surface_models.py:287)")
    gen_rmse = {"rbf": float(np.sqrt(np.mean((rbf.get_surface_batch(hk_, ht_) - hv_) ** 2)))}
    for method in ("idw", "nearest"):
        gen = VolatilitySurfaceGenerator(k_, t_, v_, method=method, device=dev)
        out = gen.get_surface_batch(hk_, ht_)
        check(bool(np.all((out >= v_.min() - 1e-6) & (out <= v_.max() + 1e-6))),
              f"{method} left the quotes' range")
        gen_rmse[method] = float(np.sqrt(np.mean((out - hv_) ** 2)))
        grid = gen.generate_surface(np.linspace(k_.min(), k_.max(), 41),
                                    np.linspace(t_.min(), t_.max(), 9))
        check(grid is gen.generate_surface(np.linspace(k_.min(), k_.max(), 41),
                                           np.linspace(t_.min(), t_.max(), 9))
              and grid.shape == (9, 41), f"{method} grid cache")
    log("learned", f"rbf on the {int(otm.sum())}-quote OTM smile: fit and evaluation "
                   f"{rbf_ms:.1f} ms, max error at the quotes {at_quotes:.2e}; held-out rmse "
                   f"{gen_rmse} [{card}]")

    # the forests: scikit-learn is no dependency of the port
    had = sys.modules.get("sklearn", False)
    sys.modules["sklearn"] = None
    try:
        for cls in (RandomForestVolatilityModel, GradientBoostingVolatilityModel,
                    XGBVolatilityModel):
            try:
                cls().train(train)
                check(False, f"{cls.__name__} trained without scikit-learn")
            except DependencyError:
                pass
    finally:
        if had is False:
            del sys.modules["sklearn"]
        else:
            sys.modules["sklearn"] = had

    # the exports, held to the live MLP across batch sizes
    raw = np.concatenate([mlp.scaler.inverse_transform(mlp._features_matrix(f))
                          for f in (train, test)]).astype(np.float32)
    rng = np.random.default_rng(0)
    batches = [raw[rng.integers(0, len(raw), b)] for b in LN_BATCHES]
    fn = opt.export.surface_forward(mlp)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = opt.export_surface_model(mlp, f"{tmp}/mlp.pt2")
        export_ms = (time.perf_counter() - t0) * 1e3
        for where in (dev, torch.device("cpu")):
            engine = opt.InferenceEngine(res.path, device=where)
            rep = opt.ExportValidator().validate_batch_sizes(fn, engine, batches, device=dev)
            check(rep.passed, f"torch.export artifact on {where}: {rep.summary()}")
            log("learned", f"torch.export (exported on the card) loaded on {where}: "
                           f"{rep.summary()}")
        bench = opt.InferenceEngine(res.path, device=dev).benchmark(batches[-1], iters=50)
        t0 = time.perf_counter()
        manifest = opt.export_surface_model_onnx(mlp, f"{tmp}/mlp.onnx")
        onnx_ms = (time.perf_counter() - t0) * 1e3
        runtime = opt.OnnxLiteRuntime(f"{tmp}/mlp.onnx")
        with torch.no_grad():
            onnx_err = max(float(np.abs(runtime.predict(x) - fn(torch.as_tensor(
                x, device=dev)).cpu().numpy()).max()) for x in batches)
        check(manifest["roundtrip_max_abs_err"] <= LN_ONNX_ATOL and onnx_err <= LN_ONNX_ATOL,
              f".onnx parity {manifest['roundtrip_max_abs_err']}, {onnx_err}")
    log("learned", f"export_surface_model {export_ms:.0f} ms ({res.n_bytes} bytes), its "
                   f"program on the card {len(batches[-1])} rows p50 {bench['p50_ms']:.3f} ms, "
                   f"p95 {bench['p95_ms']:.3f} ms; export_surface_model_onnx {onnx_ms:.0f} ms, "
                   f"max error {onnx_err:.2e} over batches {LN_BATCHES} [{card}]")

    # the surrogate on closed-form labels at its defaults
    sur = record(f"MonteCarloMLSurrogate.fit {LN_SURROGATE_N} samples, (128, 128), 300 epochs, "
                 "batch 1024",
                 lambda: fitted(sg.MonteCarloMLSurrogate(device=dev), "fit", LN_SURROGATE_N),
                 lambda: sg.MonteCarloMLSurrogate(epochs=2, device=dev).fit(LN_SURROGATE_N),
                 lambda: cut_kernels(lambda: sg.MonteCarloMLSurrogate(device=dev).fit(
                     LN_SURROGATE_N), sg, "_train_multi"))
    score = sur.score()
    check(all(score[k] > v for k, v in LN_R2.items()), f"surrogate scores {score}")
    p = sg.sample_contracts(4_000, seed=77)
    band = sur.predict(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"], "call", 0.0,
                       return_uncertainty=True)
    truth = bs_price(*(torch.as_tensor(p[k], device=dev)
                       for k in ("spot", "strike", "maturity", "rate", "vol")), 1.0, 0.0)
    truth = truth.cpu().numpy()
    coverage = float(np.mean((band["price_lo"] <= truth) & (truth <= band["price_hi"])))
    check(coverage >= LN_COVERAGE, f"conformal coverage {coverage}")
    with tempfile.TemporaryDirectory() as tmp:
        sur_onnx = sur.export_onnx(f"{tmp}/surrogate.onnx")
    check(sur_onnx["roundtrip_max_abs_err"] <= LN_SURROGATE_ONNX_ATOL, f"surrogate .onnx {sur_onnx}")
    log("learned", f"surrogate R² {score}, conformal coverage {coverage:.4f} (≥ {LN_COVERAGE}), "
                   f".onnx max error {sur_onnx['roundtrip_max_abs_err']:.2e}")

    # the surrogate on the GBM kernel's book Greeks: one launch of labels
    last = {}

    def book(p):
        return ContractBatch(**{k: torch.as_tensor(p[k], device=dev) for k in FDM_FIELDS})

    def gbm_labels(p):
        b = book(p)
        out = gk.gbm_mc_price_greeks(b, n_paths=LN_LABEL_PATHS, seed=0)
        calls["gbm"] += 1
        last.update(p=p, out=out)
        return torch.stack([out["price"] / b.strike, out["delta"], out["gamma"] * b.strike], 1)

    sur2 = record(f"MonteCarloMLSurrogate.fit_to_pricer {LN_PRICER_N} contracts, GBM kernel "
                  f"labels at {LN_LABEL_PATHS} paths a contract",
                  lambda: fitted(sg.MonteCarloMLSurrogate(device=dev), "fit_to_pricer",
                                 gbm_labels, LN_PRICER_N),
                  lambda: sg.MonteCarloMLSurrogate(epochs=2, device=dev).fit_to_pricer(
                      gbm_labels, LN_PRICER_N),
                  lambda: cut_kernels(lambda: sg.MonteCarloMLSurrogate(device=dev).fit_to_pricer(
                      gbm_labels, LN_PRICER_N), sg, "_train_multi"))
    b = book(last["p"])
    ref = bs_greeks(*(getattr(b, k).double() for k in FDM_FIELDS[:5]), b.cp.double(),
                    b.dividend.double())
    strike = b.strike.double()
    out = last["out"]
    label = torch.stack([out["price"].double() / strike, out["delta"].double(),
                         out["gamma"].double() * strike])
    want = torch.stack([ref["price"] / strike, ref["delta"], ref["gamma"] * strike])
    n_branch = gk.gbm_paths_per_launch(b, LN_LABEL_PATHS)
    se, lam, per_branch = label_error_model(b, n_branch)
    normal = lam >= LN_POISSON
    bound = torch.where(normal, 5.0 * se,
                        (lam + 5.0 * torch.sqrt(lam) + 5.0) * per_branch) + LN_LABEL_FLOOR
    z = (label - want).abs() / bound
    check(bool((z <= 1.0).all()), f"labels off bs_greeks by up to {z.amax(1).tolist()} of "
                                  "their bounds")
    se_ratio = (out["std_error"].double() / strike / se[0])[normal]
    score2 = sur2.score()
    check(all(score2[k] > v for k, v in LN_R2.items()), f"surrogate on GBM labels: {score2}")
    log("learned", f"GBM labels: {len(strike)} contracts x {n_branch} paths; |label - "
                   f"bs_greeks| / bound at most {np.array2string(z.amax(1).cpu().numpy(), precision=3)}"
                   f" (price/K, delta, gamma·K; bound 5 stderr + {LN_LABEL_FLOOR} where "
                   f"{LN_POISSON:.0f}+ in-the-money paths are expected, for "
                   f"{float(normal.double().mean()):.4f} of them, else a Poisson count's); the "
                   "kernel's price stderr over the exact one: "
                   f"median {float(se_ratio.median()):.4f}, range {float(se_ratio.min()):.4f}-"
                   f"{float(se_ratio.max()):.4f}; R² on BS labels {score2}")

    # the studies: TPE with a resume, the surrogate's, and one around calibrate_heston_mc
    def basin(trial, seed):  # tests/test_optimization.py:166
        x = trial.suggest_float("x", 0.0, 1.0)
        y = trial.suggest_float("y", 0.0, 1.0)
        return (x - 0.73) ** 2 + (y - 0.31) ** 2

    with tempfile.TemporaryDirectory() as tmp:
        url = f"sqlite:///{tmp}/studies.db"
        t0 = time.perf_counter()
        whole = opt.StudyManager("tpe", url, sampler="tpe").optimize(
            basin, n_trials=LN_STUDY_TRIALS, catch_exceptions=False)
        study_ms = (time.perf_counter() - t0) * 1e3
        half = opt.StudyManager("tpe_resumed", url, sampler="tpe")
        half.optimize(basin, n_trials=LN_STUDY_TRIALS // 2, catch_exceptions=False)
        resumed = opt.StudyManager("tpe_resumed", url, sampler="tpe")
        check(resumed.resumed and len(resumed.trials) == LN_STUDY_TRIALS // 2, "no resume")
        resumed.optimize(basin, n_trials=LN_STUDY_TRIALS // 2, catch_exceptions=False)
        check([t.params for t in resumed.trials]
              == [t.params for t in opt.StudyManager("tpe", url, sampler="tpe").trials],
              "the resumed TPE study drew other trials than the whole one")
        sobol = opt.StudyManager("sobol", url, sampler="sobol").optimize(
            basin, n_trials=LN_STUDY_TRIALS, catch_exceptions=False)
        tail = resumed.trials[-10:]
        near = sum(abs(t.params["x"] - 0.73) < 0.2 and abs(t.params["y"] - 0.31) < 0.2
                   for t in tail)
        check(whole.n_complete == LN_STUDY_TRIALS and whole.best_value <= sobol.best_value
              and near >= 5, f"TPE best {whole.best_value} vs Sobol {sobol.best_value}, "
                             f"{near} of the last 10 near the basin")
        log("learned", f"TPE study {LN_STUDY_TRIALS} trials {study_ms:.0f} ms, best "
                       f"{whole.best_value:.2e} (Sobol {sobol.best_value:.2e}), resumed at "
                       f"{LN_STUDY_TRIALS // 2} with the same trials")

        mgr, objective = opt.create_surrogate_optimizer("surrogate", url, device=dev)
        t0 = time.perf_counter()
        res = mgr.optimize(objective, n_trials=LN_FIT_TRIALS, catch_exceptions=False)
        torch.cuda.synchronize()
        sur_ms = (time.perf_counter() - t0) * 1e3
        check(res.n_complete == LN_FIT_TRIALS and math.isfinite(res.best_value),
              f"surrogate study {res}")
        n_sur = sum(cut_kernels(lambda t=t: objective(FixedTrial(t.params), t.seed), sg,
                                "_train_multi") for t in mgr.trials)
        stats[f"surrogate study, {LN_FIT_TRIALS} trials"] = (sur_ms, n_sur)
        log("learned", f"create_surrogate_optimizer {LN_FIT_TRIALS} trials "
                       f"{[t.params for t in mgr.trials]}: warm wall {sur_ms:.1f} ms, {n_sur} "
                       f"CUDA kernels, best price-head rmse {res.best_value:.5f} [{card}]")

        strikes, mats, cps = heston_chain_quotes()
        gen_p = hmodel.HestonParams.make(*H_CALIB_GEN, dtype=torch.float64, device=dev)
        market = hmodel.heston_price(ContractBatch.make(
            S0, torch.tensor(strikes, dtype=torch.float64), torch.tensor(mats, dtype=torch.float64),
            RATE, 0.2, torch.tensor(cps, dtype=torch.float64), device=dev, dtype=torch.float64),
            gen_p).float()

        def calibrate(market_prices, quotes, learning_rate, n_steps):
            return hmodel.calibrate_heston_mc(
                market_prices, *quotes, S0, RATE,
                init=hmodel.HestonParams.make(*H_CALIB_INIT, device=dev), n_steps=n_steps,
                learning_rate=learning_rate, n_paths=H_CHAIN_PATHS, max_dt=H_CALIB_DT,
                device=dev)

        objective = opt.make_calibration_objective(calibrate, market, (strikes, mats, cps))
        mgr = opt.StudyManager("heston_calibration", url)
        before = hk._heston_chain_cuda.launches
        t0 = time.perf_counter()
        res = mgr.optimize(objective, n_trials=LN_FIT_TRIALS, catch_exceptions=False)
        torch.cuda.synchronize()
        cal_ms = (time.perf_counter() - t0) * 1e3
        chain = hk._heston_chain_cuda.launches - before
        want = sum(t.params["n_steps"] + 2 for t in mgr.trials)
        check(chain == want, f"the calibration study made {chain} chain launches, not {want}")
        check(res.n_complete == LN_FIT_TRIALS and math.isfinite(res.best_value),
              f"calibration study {res}")
        n_cal = sum(adam_kernels(lambda t=t: objective(FixedTrial(t.params), t.seed))
                    for t in mgr.trials)
        stats[f"calibration study, {LN_FIT_TRIALS} trials"] = (cal_ms, n_cal)
        log("learned", f"make_calibration_objective around calibrate_heston_mc (40 quotes, "
                       f"{H_CHAIN_PATHS} paths, dt {H_CALIB_DT}), {LN_FIT_TRIALS} trials "
                       f"{[t.params for t in mgr.trials]}: warm wall {cal_ms:.1f} ms, {n_cal} "
                       f"CUDA kernels, {chain} chain launches (Σ(n_steps + 2) = {want}), best "
                       f"loss {res.best_value:.3e} [{card}]")
    log("learned", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"stats": stats, "gbm": calls["gbm"], "chain": chain}



CLI_BGK = 0.5826  # Broadie–Glasserman–Kou: a discretely monitored barrier ≈ the continuous one
#                   shifted outward by e^{0.5826·σ·√(T/m)}
CLI_BACKTEST_LENGTHS = (253, 1009)  # the price series the no-loop check runs at
CLI_PROFILER_NOISE = 128  # CUDA records a profiler session gains or loses, at most (+17 and
#                           −16 seen); a loop over the 756 extra days would add ≥ 756 kernels


def cli_json(argv) -> dict:
    """One in-process run of the port's command line: its printed JSON."""
    import contextlib
    import io

    from optionslab_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        check(cli.main(argv) == 0, f"cli {' '.join(argv)} did not return 0")
    return json.loads(buf.getvalue())


def phase_cli(dev, card: str) -> dict:
    """Every subcommand of the port's command line in process through
    ``optionslab_tpu_torch.cli.main`` at the reference's defaults, on the
    card, against its oracles: BS, the kernels' Monte Carlo against their
    closed forms within 4 stderr, the BGK-shifted double-barrier closed
    forms, the geometric basket, the IV round trip, the variance-swap
    replications, VaR, the calibrations, the harness, the ``.pt2``
    artifact reloaded against the live model, the backtest's aten ops and
    CUDA kernels at two series lengths, the American brackets, XVA, a Heston book, the
    plot and report guards and a served ``/price``. Each call's warm wall
    ms (a fit's first-call wall) and CUDA kernels (calls under ≈2 s), and
    the launches of each kernel. Returns {"stats": {name: (ms, kernels)},
    "launched": {kernel: launches}}."""
    import tempfile

    from optionslab_tpu_torch import optimize as topt
    from optionslab_tpu_torch.backtest import BacktestEngine
    from optionslab_tpu_torch.models.exotics import (
        double_barrier_closed_form,
        double_no_touch_closed_form,
    )
    from optionslab_tpu_torch.models.heston import HestonParams, heston_price
    from optionslab_tpu_torch.models.multi_asset import geometric_basket_closed_form
    from optionslab_tpu_torch.optimize.export import InferenceEngine, surface_forward
    from optionslab_tpu_torch.utils.exceptions import DependencyError

    d = ["--device", str(dev)]
    stats, before = {}, launch_counts()
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="cli_"))

    def run(name, argv, warm: bool = True, kernels: bool = True):
        """The JSON of ``argv``: with ``warm``, after one untimed call; its
        wall ms and kernel launches logged, and its CUDA kernels for a
        short call."""
        if warm:
            cli_json(d + argv)
        torch.cuda.synchronize()
        b = launch_counts()
        t0 = time.perf_counter()
        res = cli_json(d + argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        a = launch_counts()
        launched = {k: a[k] - b[k] for k in a if a[k] != b[k]}
        n = cuda_kernels(lambda: cli_json(d + argv)) if kernels and ms < 2000 else None
        stats[name] = (ms, n)
        log("cli", f"{name}: {'warm' if warm else 'first-call'} wall {ms:.1f} ms, "
                   f"{'not profiled' if n is None else f'{n} CUDA kernels'}, kernel launches "
                   f"{launched or 'none'} [{card}]")
        return res, launched

    info, _ = run("info", ["info"], kernels=False)
    check(info["backend"] == "cuda" and info["device_kind"] == torch.cuda.get_device_name(0)
          and info["cuda"] == torch.version.cuda, f"info names another device: {info}")

    # price, greeks, mc, iv
    bs, _ = run("price bs", ["price", "--model", "bs"])
    check(abs(bs["price"] - BS_ATM_CALL) < 1e-5 * BS_ATM_CALL, f"cli price bs {bs['price']}")
    fdm, launched = run("price fdm", ["price", "--model", "fdm"])
    check(abs(fdm["price"] - BS_ATM_CALL) < 2e-3 and launched.get("theta_pde") == 1,
          f"cli price fdm {fdm['price']}, launches {launched}")
    fdm_am, _ = run("price fdm --american --type put", ["price", "--model", "fdm", "--american",
                                                        "--type", "put"])
    check(fdm_am["price"] > cli_json(d + ["price", "--type", "put"])["price"],
          "the American put is not above the European")
    hp, _ = run("price heston", ["price", "--model", "heston"])
    lewis = float(heston_price(ContractBatch.make(100.0, 100.0, 1.0, 0.05, 0.2, device=dev),
                               HestonParams.make(device=dev)))
    check(abs(hp["price"] - lewis) < 1e-4 * lewis, "cli price heston is not Lewis")
    for model, key in (("heston", "heston_mc"), ("heston-qe", "heston_qe_ladder")):
        g, launched = run(f"greeks {model}", ["greeks", "--model", model])
        check(abs(g["price"] - lewis) < 4.0 * g["std_error"] and launched.get(key, 0) >= 1,
              f"cli greeks {model}: {g['price']} ± {g['std_error']} vs Lewis {lewis}, "
              f"launches {launched}")
    for paths in ("100000", "1000000000"):
        m, launched = run(f"mc pallas {paths}", ["mc", "--method", "pallas", "--n-paths", paths])
        check(abs(m["price"] - BS_ATM_CALL) < 4.0 * m["std_error"]
              and launched.get("gbm_mc", 0) >= 1,
              f"cli mc pallas {paths}: {m['price']} ± {m['std_error']}, launches {launched}")
    m, _ = run("mc xla", ["mc"])
    check(abs(m["price"] - BS_ATM_CALL) < 4.0 * m["std_error"], f"cli mc xla {m}")
    iv, _ = run("iv", ["iv", "--price", repr(bs["price"])])
    check(abs(iv["implied_vol"] - 0.2) < 1e-4, f"cli iv round trip {iv}")

    # exotic: the Asian control variate against plain, the double kinds
    # against their BGK-shifted closed forms, the kernel ladders, the models
    cv, launched = run("exotic --cv", ["exotic", "--cv"])
    plain, _ = run("exotic asian (scan)", ["exotic", "--kind", "asian"])
    check(abs(cv["price"] - plain["price"]) < 4.0 * math.hypot(cv["std_error"],
                                                               plain["std_error"])
          and launched.get("exotic_mc", 0) >= 1, f"cli exotic --cv {cv} vs plain {plain}")
    shift = math.exp(CLI_BGK * 0.2 * math.sqrt(1.0 / 64))
    for argv in (["--kind", "double-barrier"], ["--kind", "double-barrier", "--knock", "in"],
                 ["--kind", "double-touch"], ["--kind", "double-touch", "--touch", "one"]):
        o, _ = run(f"exotic {' '.join(argv)}", ["exotic", *argv])
        lo, hi = o["band"][0] / shift, o["band"][1] * shift
        if o["kind"].startswith("barrier"):
            cf = float(double_barrier_closed_form(100.0, 100.0, lo, hi, 1.0, 0.05, 0.2, 1.0,
                                                  knock=o["kind"].rsplit("-", 1)[1]))
        else:
            dnt = float(double_no_touch_closed_form(100.0, lo, hi, 1.0, 0.05, 0.2))
            cf = dnt if o["kind"].startswith("no") else math.exp(-0.05) - dnt
        # BGK's own error is O(1/m): 1% of the price on top of 4 stderr
        check(abs(o["price"] - cf) < 4.0 * o["std_error"] + 0.01 * abs(cf),
              f"cli exotic {o['kind']}: {o['price']} ± {o['std_error']} vs BGK {cf}")
    g, launched = run("exotic asian --greeks", ["exotic", "--kind", "asian", "--greeks"])
    check(launched.get("exotic_greeks", 0) >= 1 and 0.0 < g["delta"] < 1.0,
          f"cli exotic asian --greeks {g}, launches {launched}")
    for model, key in (("heston", "heston_exotic"), ("lv", "local_vol_mc"),
                       ("slv", "slv_mc")):
        argv = ["exotic", "--model", model, "--kind", "autocallable" if model == "slv"
                else "barrier"]
        o, launched = run(f"exotic --model {model}", argv)
        check(launched.get(key, 0) >= 1 and math.isfinite(o["price"]) and o["price"] > 0,
              f"cli exotic --model {model}: {o}, launches {launched}")

    # basket: the geometric basket on the multi-asset kernel against its closed form
    gb, launched = run("basket kernel geometric", ["basket", "--engine", "kernel", "--kind",
                                                   "geometric"])
    cf = float(geometric_basket_closed_form([100.0, 95.0, 105.0], [1 / 3] * 3, 100.0, 1.0, 0.05,
                                            [0.2, 0.25, 0.3], [[1.0, 0.4, 0.4], [0.4, 1.0, 0.4],
                                                               [0.4, 0.4, 1.0]]))
    check(abs(gb["price"] - cf) < 4.0 * gb["std_error"] and abs(gb["closed_form"] - cf) < 1e-4
          and launched.get("multi_asset_mc", 0) >= 1, f"cli basket geometric {gb} vs {cf}")
    run("basket xla", ["basket"])

    # the variance swap, VaR
    vs, _ = run("varswap", ["varswap"])
    # the LV Monte Carlo strike against the replication of its smile: the
    # Dupire grid and 64 Euler steps leave 0.29% on the CPU, 11 stderr
    check(abs(vs["local_vol_variance_strike"] / vs["smile_replication_variance_strike"] - 1.0)
          < 0.01 and abs(vs["slv_variance_strike_mixing1"] / vs["local_vol_variance_strike"]
                         - 1.0) < 0.01
          and abs(vs["flat_smile_variance_strike"] - vs["flat_smile_vol_check"]) < 1e-3,
          f"cli varswap replications disagree: {vs}")
    var, _ = run("var", ["var"])
    check(abs(var["parametric_var"] - (1.6448536269514722 * 0.2e6 - 0.05)) < 1.0,
          f"cli var parametric {var}")

    # the fits: first-call walls
    cal, _ = run("calibrate svi", ["calibrate"], warm=False, kernels=False)
    check(max(cal["svi_rmse_vol"]) < 0.009, f"cli calibrate svi rmse {cal['svi_rmse_vol']}")
    hmc, launched = run("calibrate heston-mc", ["calibrate", "--model", "heston-mc"], warm=False,
                        kernels=False)
    check(launched.get("heston_chain", 0) >= 3 and hmc["iv_rmse"] < 0.05,
          f"cli calibrate heston-mc {hmc}, launches {launched}")
    srf, _ = run("surface", ["surface"], warm=False, kernels=False)
    check(srf["rmse_bps"] < 50.0 and srf["butterfly_free"], f"cli surface {srf}")
    bh, _ = run("bench-harness", ["bench-harness"], warm=False, kernels=False)
    check({r["model"] for r in bh["table"]} == {"svi", "sabr", "kernel_ridge"}
          and all(r["convergence_pct"] == 100.0 for r in bh["table"]), f"cli bench-harness {bh}")

    # export: the .pt2 reloaded on the card against the live model's forward
    live = {}
    real_export = topt.export_surface_model

    def keep(model, path, *a, **k):
        live["model"] = model
        return real_export(model, path, *a, **k)

    topt.export_surface_model = keep
    try:
        pt2 = out_dir / "surface_mlp.pt2"
        ex, _ = run("export", ["export", "--out", str(pt2)], warm=False, kernels=False)
    finally:
        topt.export_surface_model = real_export
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(64, 7)), dtype=torch.float32,
                        device=dev)
    want = surface_forward(live["model"])(x).detach().cpu().numpy().ravel()
    got = np.asarray(InferenceEngine(pt2, device=dev).predict(x)).ravel()
    check(ex["export"]["path"] == str(pt2) and np.max(np.abs(got - want)) < 1e-5,
          f"cli export: the .pt2 on the card differs from the live model by "
          f"{np.max(np.abs(got - want))}")

    # backtest: one chain of kernels whatever the series' length
    bt, _ = run("backtest", ["backtest"])
    check(bt["n_rebalances"] == 252 and all(math.isfinite(v) for v in bt.values()),
          f"cli backtest {bt}")
    eng, rng = BacktestEngine(device=dev), np.random.default_rng(0)
    ops, counts = [], []
    for n in CLI_BACKTEST_LENGTHS:
        prices = 100.0 * np.exp(np.cumsum(0.2 * np.sqrt(1 / 252) * rng.standard_normal(n)))

        def call(p=prices):
            return eng.run_delta_hedge(p, strike=100.0, maturity=1.0, sigma=0.2)

        call()
        ops.append(aten_ops(call))
        counts.append(cuda_kernels(call, 3))
    log("cli", f"backtest at {CLI_BACKTEST_LENGTHS} prices: {ops} aten ops, {counts} CUDA "
               f"kernels [{card}]")
    check(ops[0] == ops[1] > 0, f"the backtest's aten ops grow with the series: {ops}")
    check(min(counts) > 0 and abs(counts[1] - counts[0]) <= CLI_PROFILER_NOISE,
          f"the backtest's CUDA kernels grow with the series: {counts}")

    # the American brackets
    am, _ = run("american bs", ["american"], warm=False, kernels=False)
    check(abs(am["lower"] - BS_ATM_CALL) < 0.02 and am["lower"] <= am["upper"] + 1e-6,
          f"cli american bs (a call: no early exercise) {am}")
    ah, launched = run("american heston", ["american", "--type", "put", "--model", "heston"],
                       warm=False, kernels=False)
    check(ah["lower"] - 3 * ah["lower_se"] <= ah["upper"] + 3 * ah["upper_se"]
          and ah["width"] < 0.05 and launched.get("heston_adi", 0) == 1
          and "tridiag" not in launched, f"cli american heston {ah}, launches {launched}")

    # XVA and a Heston book
    xva, _ = run("xva", ["xva"])
    check(xva["cva"] > 0.0 and abs(xva["ee"][0] - BS_ATM_CALL) < 0.5, f"cli xva {xva}")
    book, launched = run("book heston --greeks", ["book", "--model", "heston", "--greeks"])
    check(book["n_contracts"] == 3 and book["price"][0] > book["price"][1] > book["price"][2] > 0
          and launched.get("heston_exotic") == 1, f"cli book {book}, launches {launched}")

    # plot and report: DependencyError at once without matplotlib
    for name, argv in (("plot", ["plot", "--what", "smiles", "--out", str(out_dir / "s.png")]),
                       ("report", ["report", "--out", str(out_dir / "r.html")])):
        t0 = time.perf_counter()
        try:
            cli_json(d + argv)
            written = pathlib.Path(argv[-1]).exists()
            log("cli", f"{name}: matplotlib present, wrote {argv[-1]} ({written}) [{card}]")
            check(written, f"cli {name} wrote nothing")
        except DependencyError as e:
            s = time.perf_counter() - t0
            log("cli", f"{name}: DependencyError in {s * 1e3:.1f} ms: {e} [{card}]")
            check("matplotlib" in str(e) and s < 1.0, f"cli {name} raised late or wrongly: {e}")

    # serve: a real process on the card
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "optionslab_tpu_torch.cli", *d, "serve",
                             "--port", str(port)], stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        t0, url = time.perf_counter(), f"http://127.0.0.1:{port}"
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError("cli serve died: " + proc.stderr.read().decode()[-2000:])
                check(time.perf_counter() - t0 < 120, "cli serve never answered /health")
                time.sleep(0.2)
        up = time.perf_counter() - t0
        req = urllib.request.Request(url + "/price", data=json.dumps({"model": "bs"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            served = json.loads(r.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
    log("cli", f"serve: /health after {up:.1f} s ({health['device_name']}), /price "
               f"{served['price']} [{card}]")
    check(health["device"] == str(dev) and abs(served["price"] - BS_ATM_CALL) < 1e-4,
          f"cli serve: {health}, {served}")

    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    log("launches", f"the command line's share: {launched}")
    return {"stats": stats, "launched": launched}


def fdm_grid_check(dev) -> None:
    """``fdm_price``'s grid built on the card against the one built on the
    CPU, bit for bit, at S0 = K for 41, 81 and 201 nodes in float32 and
    float64 (the mid-cell shift's tie, broken as the reference breaks it;
    ``tests/test_torch_fdm_grid.py`` holds the CPU grid to the reference's),
    and the 41 x 40 American put at S0 = K priced by the θ-scheme kernel
    against the CPU's plain loop on the same grid (rtol 1e-5)."""
    from optionslab_tpu_torch.models import fdm as fdm_mod

    for dtype in (torch.float32, torch.float64):
        for n in (41, 81, 201):
            args = [torch.tensor([v], dtype=dtype) for v in (S0, VOL, T, STRIKE)]
            x_cpu, dx_cpu = fdm_mod._grid(args[0], args[1], args[2], n, 6.0, args[3])
            x_dev, dx_dev = fdm_mod._grid(*(a.to(dev) for a in args[:3]), n, 6.0,
                                          args[3].to(dev))
            check(torch.equal(x_dev.cpu(), x_cpu) and torch.equal(dx_dev.cpu(), dx_cpu),
                  f"fdm grid {n} {dtype}: the card's differs from the CPU's")
    put = lambda d: ContractBatch.make(S0, STRIKE, T, RATE, VOL, "put", device=d)  # noqa: E731
    on_card = fdm_mod.fdm_price(put(dev), n_space=41, n_time=40, american=True).item()
    on_cpu = fdm_mod.fdm_price(put("cpu"), n_space=41, n_time=40, american=True).item()
    check(abs(on_card - on_cpu) <= 1e-5 * on_cpu,
          f"fdm 41 x 40 American put: card {on_card} vs CPU {on_cpu}")
    log("theta", f"fdm grid at S0 = K equal on the card and the CPU (41/81/201 nodes, float32 "
                 f"and float64); 41 x 40 American put {on_card:.6f} on the card, {on_cpu:.6f} "
                 "on the CPU")


# ---------------------------------------------------------------------------
# parallel/: every sharded route on meshes of this card repeated 1, 2 and 4
# times (one card: the numbers are the shard loop's host cost and the
# kernels' own time, not an interconnect's)
# ---------------------------------------------------------------------------
PL_SHARDS = (1, 2, 4)
PL_GBM_PATHS = 1_000_000_000
PL_BOOK = (1024, 1_000_000)
PL_MC = (16, 10_000_000)  # sharded_mc_price: contracts x paths
PL_MC_GREEKS = (256, 1_000_000)  # sharded_book_greeks on a 2 x 2 mesh
PL_VAR_SAMPLES = 8_388_608
PL_MC_VAR_PATHS = 10_000_000
PL_MC_VAR_TOL = 0.5  # tests/test_parallel.py: |VaR − closed form| < 0.5
# the reference's sharded-vs-unsharded bounds, (rtol, atol) per key
# (tests/test_sharded_pallas.py, test_heston_pallas.py, test_local_vol_pallas.py,
# test_multi_asset_pallas.py, test_slv_pallas.py)
PL_GBM_TOLS = {"price": (2e-5, 0.0), "delta": (2e-4, 0.0), "vega": (2e-3, 0.0)}
# tests/test_parallel.py:103: sharded_book_greeks vs the unsharded mc_greeks
PL_BOOK_GREEK_TOLS = {"delta": 0.02, "gamma": 0.004, "vega": 1.2, "rho": 1.2, "theta": 0.6,
                      "dual_delta": 0.02}
PL_PINN_TOL = 1e-6


def pl_flat(out) -> dict:
    """A route's result as {key: float64 CPU tensor}: the (price, stderr,
    paths) tuples and the ladder dicts alike (strings dropped)."""
    items = dict(zip(("price", "std_error", "paths"), out)) if isinstance(out, tuple) else out
    flat = {}
    for key, v in items.items():
        if isinstance(v, torch.Tensor):
            flat[key] = v.detach().to("cpu", torch.float64).reshape(-1)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            flat[key] = torch.tensor([float(v)], dtype=torch.float64)
    return flat


def pl_paths(n_paths: int, per_block: int) -> int:
    """``n_paths`` rounded up to whole blocks of ``per_block`` paths, a
    multiple of 4 of them: every mesh of 1, 2 or 4 shards then integrates
    the same path set as the unsharded call."""
    return -(-math.ceil(n_paths / per_block) // 4) * 4 * per_block


def pl_price_se(out: dict) -> tuple:
    return out["price"], out["std_error"]


def pl_mesh(dev, n: int, book: int = 1):
    from optionslab_tpu_torch.parallel import make_mesh

    return make_mesh(n, book=book, devices=[dev] * n)


def pl_route(tag: str, kernel, unsharded, sharded, tols: dict, dev) -> dict:
    """One sharded route at its main path's shape on meshes of 1, 2 and 4
    shards of the card: each call launches ``kernel`` once a shard; one
    shard equals ``unsharded()`` bit for bit; 2 and 4 shards within
    ``tols``. Returns {label: warm wall ms}."""
    want, ms_u = timed(unsharded, iters=1)
    want = pl_flat(want)
    walls = {"unsharded": ms_u}
    for n in PL_SHARDS:
        mesh = pl_mesh(dev, n)
        before = kernel.launches
        got, walls[f"{n} shards"] = timed(lambda mesh=mesh: sharded(mesh), iters=1)
        got = pl_flat(got)
        check(kernel.launches - before == 2 * n,  # two calls
              f"{tag}: {n} shards launched the kernel {kernel.launches - before} times in "
              "two calls")
        check(set(want) <= set(got), f"{tag}: keys {sorted(got)} lack some of {sorted(want)}")
        if n == 1:
            diff = [key for key in want if not torch.equal(got[key], want[key])]
            check(not diff, f"{tag}: one shard differs from the unsharded call in {diff}")
            continue
        worst = []
        for key, w in want.items():
            rel = float(((got[key] - w).abs() / w.abs().clamp_min(1e-30)).max())
            worst.append(f"{key} {rel:.2e}")
            if key in tols:
                rtol, atol = tols[key]
                ok = bool(torch.all((got[key] - w).abs() <= rtol * w.abs() + atol))
                check(ok, f"{tag}: {n} shards' {key} {got[key].tolist()[:4]} vs unsharded "
                          f"{w.tolist()[:4]} outside rtol {rtol}, atol {atol}")
        log("parallel", f"{tag} {n} shards vs unsharded, relative: {', '.join(worst)}")
    return walls


def phase_parallel(dev, card: str) -> dict:
    """``parallel/`` on the card: every kernel route sharded over meshes of
    cuda:0 repeated 1, 2 and 4 times at its main path's shape (1 shard bit
    for bit the unsharded call, 2 and 4 within the reference's bounds, one
    launch a shard), the GBM 1024-contract book on a 2 x 2 mesh, the tensor
    engine bit-identical on 1, 2 and 4 shards at 16 x 1e7 and its Greeks on
    256 x 1e6 against ``mc_greeks`` on the same normals, VaR/ES against a
    global sort and the closed form, and the data-parallel PINN step on 4
    shards against 1. Returns {route: walls}."""
    from optionslab_tpu_torch import parallel as par
    from optionslab_tpu_torch.models import monte_carlo as mcm
    from optionslab_tpu_torch.parallel import sharded_mc as psm
    from optionslab_tpu_torch.risk import lognormal_var
    from optionslab_tpu_torch.surface import dryrun_train_step_sharded

    t_phase = time.perf_counter()
    walls = {}
    one = ContractBatch.make(S0, STRIKE, T, RATE, VOL, "call", device=dev)
    gbm = lambda b, n: lambda: gk.gbm_mc_price_greeks(b, n_paths=n)  # noqa: E731
    n_gbm = pl_paths(PL_GBM_PATHS, gk.gbm_paths_per_launch(one, 1))
    walls["gbm 1x1e9"] = pl_route(
        f"gbm_mc 1x{n_gbm}", gk._gbm_moments_cuda, gbm(one, n_gbm),
        lambda mesh: par.sharded_pallas_greeks(one, mesh, n_paths=n_gbm), PL_GBM_TOLS, dev)
    out = par.sharded_pallas_greeks(one, pl_mesh(dev, 4), n_paths=n_gbm)
    err = abs(out["price"].item() - BS_ATM_CALL)
    log("parallel", f"gbm 4 shards {out['price'].item():.6f}±{out['std_error'].item():.2e} "
                    f"({out['n_paths']} paths) vs Black–Scholes {BS_ATM_CALL} (|err| {err:.2e})")
    check(err < 4 * out["std_error"].item(), "sharded GBM price vs Black–Scholes")
    # the 1024-contract book on a (book 2, paths 2) mesh
    c, n = PL_BOOK
    book = book_batch(c, dev)
    n = pl_paths(n, gk.gbm_paths_per_launch(book, 1))
    flat = gk.gbm_mc_price_greeks(book, n_paths=n)
    before = gk._gbm_moments_cuda.launches
    (bk, ms) = timed(lambda: par.sharded_pallas_greeks(book, pl_mesh(dev, 4, book=2),
                                                       n_paths=n), iters=1)
    # two calls of 4 shards
    check(gk._gbm_moments_cuda.launches - before == 8, "the 2 x 2 book launched != 4 a call")
    for key, (rtol, atol) in PL_GBM_TOLS.items():
        check(bool(torch.all((bk[key] - flat[key]).abs() <= rtol * flat[key].abs() + atol)),
              f"2 x 2 book {key} outside rtol {rtol} of the unsharded call")
    bs = bs_greeks(book.spot, book.strike, book.maturity, book.rate, book.vol, book.cp,
                   book.dividend)["price"]
    z = ((bk["price"] - bs).abs() / bk["std_error"]).max().item()
    check(z < 5.0, f"2 x 2 book: worst |price − BS| = {z:.2f} stderr")
    walls["gbm book 2x2"] = {"2x2": ms}
    log("parallel", f"gbm book {c}x{bk['n_paths']} on 2 x 2: {ms:.2f} ms warm, worst "
                    f"|price − BS| {z:.2f} stderr")

    # the exotic kernels at the exotic path's shapes
    n, m = ASIAN
    ex_args = ("asian_arith", S0, STRIKE, T, RATE, VOL)
    n_ex = pl_paths(n, ek.PATHS_PER_BLOCK)
    walls["exotic asian"] = pl_route(
        f"exotic_mc asian_arith {n_ex}x{m}", ek._exotic_moments_cuda,
        lambda: ek.exotic_price(*ex_args, n_paths=n_ex, n_steps=m, device=dev),
        lambda mesh: par.sharded_exotic_price(*ex_args, mesh, n_paths=n_ex, n_steps=m),
        {"price": (2e-5, 0.0), "std_error": (1e-4, 0.0)}, dev)
    n, m = GREEKS
    n_g = pl_paths(n, ek.PATHS_PER_BLOCK_G)
    g_args = ("asian_geo", S0, STRIKE, T, RATE, VOL)
    walls["exotic greeks"] = pl_route(
        f"exotic_greeks asian_geo {n_g}x{m}", ek._exotic_greeks_cuda,
        lambda: ek.exotic_greeks(*g_args, n_paths=n_g, n_steps=m, device=dev),
        lambda mesh: par.sharded_exotic_greeks(*g_args, mesh, n_paths=n_g, n_steps=m),
        {key: (3e-5, 0.0) for key in ("price", "delta", "vega", "rho", "theta")}, dev)

    # multi-asset: the basket Asian and its ladder
    n, m = MA_PRICE
    n_ma = pl_paths(n, mk.PATHS_PER_BLOCK)
    walls["multi_asset basket_asian"] = pl_route(
        f"multi_asset_mc basket_asian {n_ma}x{m}", mk._ma_cuda,
        lambda: mk.multi_asset_kernel_price("basket_asian", *MA_ARGS, weights=MA_W,
                                            n_paths=n_ma, n_steps=m, device=dev),
        lambda mesh: par.sharded_multi_asset_price("basket_asian", *MA_ARGS, mesh,
                                                   weights=MA_W, n_paths=n_ma, n_steps=m),
        {"price": (3e-5, 0.0)}, dev)
    n, m = MA_LADDER
    n_ml = pl_paths(n, mk.PATHS_PER_BLOCK)
    walls["multi_asset ladder"] = pl_route(
        f"multi_asset_mc basket_asian LR {n_ml}x{m}", mk._ma_cuda,
        lambda: mk.multi_asset_kernel_greeks("basket_asian", *MA_ARGS, weights=MA_W,
                                             n_paths=n_ml, n_steps=m, device=dev),
        lambda mesh: par.sharded_multi_asset_greeks("basket_asian", *MA_ARGS, mesh,
                                                    weights=MA_W, n_paths=n_ml, n_steps=m),
        {**{key: (5e-5, 0.0) for key in ("price", "theta", "rho")},
         **{key: (5e-4, 0.0) for key in ("delta", "vega", "gamma")}}, dev)

    # Heston: Euler price + v0-vega, QE price, QE ladder
    hp = hx_params(dev=dev)
    n, m = H_EULER
    n_h = pl_paths(n, hk.PATHS_PER_BLOCK)
    walls["heston euler"] = pl_route(
        f"heston_mc vega {n_h}x{m}", hk._heston_mc_cuda,
        lambda: hk.heston_kernel_greeks(S0, STRIKE, T, RATE, hp, n_paths=n_h, n_steps=m,
                                        device=dev),
        lambda mesh: par.sharded_heston_greeks(S0, STRIKE, T, RATE, hp, mesh, n_paths=n_h,
                                               n_steps=m),
        {key: (3e-5, 0.0) for key in ("price", "delta", "rho", "vega_v0")}, dev)
    n, m = H_QE
    walls["heston qe"] = pl_route(
        f"heston_qe {n_h}x{m}", hk._heston_qe_cuda,
        lambda: hk.heston_kernel_price(S0, STRIKE, T, RATE, hp, n_paths=n_h, n_steps=m,
                                       scheme="qe", device=dev)[:2],
        lambda mesh: pl_price_se(par.sharded_heston_greeks(
            S0, STRIKE, T, RATE, hp, mesh, n_paths=n_h, n_steps=m, scheme="qe", vega=False)),
        {"price": (3e-5, 0.0)}, dev)
    n_hl = pl_paths(n, hk.LADDER_PATHS_PER_BLOCK)
    walls["heston qe ladder"] = pl_route(
        f"heston_qe_ladder {n_hl}x{m}", hk._heston_qe_ladder_cuda,
        lambda: hk.heston_kernel_greeks(S0, STRIKE, T, RATE, hp, n_paths=n_hl, n_steps=m,
                                        scheme="qe", ladder=True, device=dev),
        lambda mesh: par.sharded_heston_greeks(S0, STRIKE, T, RATE, hp, mesh, n_paths=n_hl,
                                               n_steps=m, scheme="qe", ladder=True),
        {"price": (3e-4, 0.0), "delta": (3e-4, 0.0),
         **{key: (0.0, 0.1) for key in ("d_theta", "d_sigma", "theta")}}, dev)

    # the Heston exotic kernel: the Asian price and the barrier LR ladder
    n, m = HX_MAIN
    n_hx = pl_paths(n, hx.PATHS_PER_BLOCK)
    hx_args = ("asian_arith", S0, STRIKE, T, RATE, hp)
    walls["heston_exotic asian"] = pl_route(
        f"heston_exotic asian_arith {n_hx}x{m}", hx._heston_exotic_cuda,
        lambda: hx.heston_kernel_exotic_price(*hx_args, n_paths=n_hx, n_steps=m, device=dev),
        lambda mesh: par.sharded_heston_exotic_price(*hx_args, mesh, n_paths=n_hx, n_steps=m),
        {"price": (2e-5, 0.0), "std_error": (1e-4, 0.0)}, dev)
    bar_args = ("barrier_up-and-out", S0, STRIKE, T, RATE, hp)
    walls["heston_exotic barrier LR"] = pl_route(
        f"heston_exotic barrier LR {n_hx}x{m}", hx._heston_exotic_cuda,
        lambda: hx.heston_kernel_exotic_lr_greeks(*bar_args, barrier=130.0, n_paths=n_hx,
                                                  n_steps=m, device=dev),
        lambda mesh: par.sharded_heston_exotic_greeks(*bar_args, mesh, barrier=130.0,
                                                      n_paths=n_hx, n_steps=m),
        {key: (5e-5, 1e-7) for key in ("price", "delta", "gamma", "vega_v0", "rho")}, dev)

    # the smile kernels on the sample smile
    n, m = LV_MAIN
    lv = lk.LocalVolKernelPricer(smile_dupire(dev), T, n_steps=m)
    n_lv = pl_paths(n, lk.PATHS_PER_BLOCK)
    walls["local_vol price"] = pl_route(
        f"local_vol_mc european {n_lv}x{m}", lk._lv_cuda,
        lambda: lv.price(STRIKE, n_paths=n_lv),
        lambda mesh: par.sharded_local_vol_price(lv, STRIKE, mesh, n_paths=n_lv),
        {"price": (3e-5, 0.0)}, dev)
    walls["local_vol greeks"] = pl_route(
        f"local_vol_mc european greeks {n_lv}x{m}", lk._lv_cuda,
        lambda: lv.greeks(STRIKE, n_paths=n_lv),
        lambda mesh: par.sharded_local_vol_greeks(lv, STRIKE, mesh, n_paths=n_lv),
        {key: (5e-4, 0.0) for key in ("price", "delta", "gamma", "vega")}, dev)
    n, m = SLV_MAIN
    slv = sk.SLVKernelPricer(smile_dupire(dev), slv_params(dev), T, n_steps=m,
                             n_cal_paths=65_536)
    n_slv = pl_paths(n, sk.PATHS_PER_BLOCK)
    walls["slv price"] = pl_route(
        f"slv_mc barrier {n_slv}x{m}", sk._slv_cuda,
        lambda: slv.price("barrier_up-and-out", STRIKE, barrier=120.0, n_paths=n_slv),
        lambda mesh: par.sharded_slv_price(slv, "barrier_up-and-out", STRIKE, mesh,
                                           barrier=120.0, n_paths=n_slv),
        {"price": (2e-5, 0.0)}, dev)
    walls["slv greeks"] = pl_route(
        f"slv_mc barrier LR {n_slv}x{m}", sk._slv_cuda,
        lambda: slv.greeks("barrier_up-and-out", STRIKE, barrier=120.0, n_paths=n_slv),
        lambda mesh: par.sharded_slv_greeks(slv, "barrier_up-and-out", STRIKE, mesh,
                                            barrier=120.0, n_paths=n_slv),
        {key: (5e-5, 1e-7) for key in ("price", "delta", "gamma", "vega_v0", "rho")}, dev)

    # the tensor engine: bit-identical on 1, 2 and 4 shards
    c, n = PL_MC
    mc_book = ContractBatch.make(torch.linspace(80.0, 120.0, c), STRIKE, T, RATE, VOL,
                                 torch.where(torch.arange(c) % 2 == 0, 1.0, -1.0), device=dev)
    cfg = mcm.MCConfig(n_paths=n)
    res, mc_walls = {}, {}
    for shards in PL_SHARDS:
        res[shards], mc_walls[f"{shards} shards"] = timed(
            lambda s=shards: par.sharded_mc_price(mc_book, 7, cfg, pl_mesh(dev, s)), iters=1)
    for shards in PL_SHARDS[1:]:
        check(torch.equal(res[shards].price, res[1].price)
              and torch.equal(res[shards].std_error, res[1].std_error),
              f"sharded_mc_price on {shards} shards is not bit-identical to 1 shard")
    bs = bs_greeks(mc_book.spot, mc_book.strike, mc_book.maturity, mc_book.rate, mc_book.vol,
                   mc_book.cp, mc_book.dividend)["price"]
    z = ((res[1].price - bs).abs() / res[1].std_error).max().item()
    check(z < 5.0, f"sharded_mc_price: worst |price − BS| = {z:.2f} stderr")
    walls[f"sharded_mc_price {c}x{n}"] = mc_walls
    log("parallel", f"sharded_mc_price {c} x {n}: bit-identical on {PL_SHARDS} shards, worst "
                    f"|price − BS| {z:.2f} stderr")
    # its Greeks on a 2 x 2 mesh against mc_greeks on the same normals
    c, n = PL_MC_GREEKS
    g_book = book_batch(c, dev)
    cfg = mcm.MCConfig(n_paths=n)
    g_s, ms_s = timed(lambda: par.sharded_book_greeks(g_book, 11, cfg, pl_mesh(dev, 4, 2)),
                      iters=1)
    half = psm._block_normals(11, torch.arange(n // psm.PATH_BLOCK), 1, True, cfg.dtype, dev)
    z_all = half.reshape(-1, 1)
    real = mcm.draw_normals
    mcm.draw_normals = lambda gen, cfg_: torch.cat([z_all, -z_all])
    try:
        g_u, ms_u = timed(lambda: mcm.mc_greeks(g_book, torch.Generator(device=dev), cfg),
                          iters=1)
    finally:
        mcm.draw_normals = real
    worst = {}
    for key, tol in PL_BOOK_GREEK_TOLS.items():
        worst[key] = (g_s[key] - g_u[key]).abs().max().item()
        check(worst[key] < tol, f"sharded_book_greeks {key} off mc_greeks by {worst[key]:.3e}")
    dp = (g_s["price"] - g_u["price"]).abs().max().item()
    check(dp < 5 * g_s["std_error"].max().item(), "sharded_book_greeks price vs mc_greeks")
    walls[f"sharded_book_greeks {c}x{n}"] = {"2x2": ms_s, "mc_greeks": ms_u}
    log("parallel", f"sharded_book_greeks {c} x {n} on 2 x 2 vs mc_greeks on the same normals: "
                    + ", ".join(f"{k_} {v:.2e}" for k_, v in worst.items()) + f", price {dp:.2e}")

    # VaR/ES: exact against a global sort; Monte Carlo VaR against the closed form
    gen = torch.Generator(device=dev).manual_seed(3)
    pnl = torch.randn(PL_VAR_SAMPLES, generator=gen, device=dev) * 2.0
    (var, es), ms_v = timed(lambda: par.sharded_historical_var_es(pnl, 0.95, pl_mesh(dev, 4)),
                            iters=1)
    m_tail = -(-PL_VAR_SAMPLES * 5 // 100)
    tail = torch.sort(pnl).values[:m_tail]
    check(var.item() == -tail[-1].item() and es.item() == -tail.mean().item(),
          f"sharded VaR/ES {var.item()}, {es.item()} != the global sort's "
          f"{-tail[-1].item()}, {-tail.mean().item()}")
    (mvar, mes), ms_mv = timed(lambda: par.sharded_mc_var(100.0, 0.05, 0.2, 0, pl_mesh(dev, 4),
                                                          n_paths=PL_MC_VAR_PATHS), iters=1)
    cf = float(lognormal_var(torch.tensor(100.0, device=dev), 0.05, 0.2))
    check(abs(mvar.item() - cf) < PL_MC_VAR_TOL and mes.item() > mvar.item(),
          f"sharded_mc_var {mvar.item():.4f} vs closed form {cf:.4f}")
    walls["var/es"] = {"historical 4 shards": ms_v, "mc_var 4 shards": ms_mv}
    log("parallel", f"VaR/ES of {PL_VAR_SAMPLES} samples on 4 shards = the global sort "
                    f"({var.item():.6f}, {es.item():.6f}); MC VaR {PL_MC_VAR_PATHS} paths "
                    f"{mvar.item():.4f} vs closed form {cf:.4f}, ES {mes.item():.4f}")

    # the data-parallel PINN step: 4 shards against 1 on the same 64 quotes
    (loss4, p4), ms_p = timed(lambda: dryrun_train_step_sharded(4, devices=[dev] * 4), iters=1)
    loss1, p1 = dryrun_train_step_sharded(1, devices=[dev], n_quotes=64)
    d_par = max((a[k_] - b[k_]).abs().max().item() for a, b in zip(p4, p1) for k_ in a)
    check(math.isfinite(loss4.item()) and abs(loss4.item() - loss1.item()) <= PL_PINN_TOL
          and d_par <= PL_PINN_TOL, f"PINN step: 4 shards {loss4.item()} vs 1 {loss1.item()}, "
                                    f"params {d_par:.2e}")
    walls["pinn step"] = {"4 shards": ms_p}
    log("parallel", f"PINN step on 4 shards: loss {loss4.item():.8f} (1 shard "
                    f"{loss1.item():.8f}), params within {d_par:.2e}")
    for route, w in walls.items():
        log("parallel", f"wall ms [{card}] {route}: "
                        + ", ".join(f"{k_} {v:.2f}" for k_, v in w.items()))
    log("parallel", f"phase {time.perf_counter() - t_phase:.1f} s (one card: the shards "
                    "share it, so the walls measure the shard loop's host cost and the kernels, "
                    "not an interconnect)")
    return walls


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    clock_phases()
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
    rev_err, rev_t = phase_theta_reverse(dev, card, node_ms)
    div_err, div_t = phase_div_loop(dev, card, node_ms)
    lvl_err, lvl_t = phase_lv_loop(dev, card, node_ms)
    adi_err, adi_t, adi_grad = phase_heston_adi(dev, card, node_ms)
    fdm_grid_check(dev)

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
    tp._theta_jumps_cuda.launches = 0
    tp._theta_adjoint_cuda.launches = 0
    lvp._lv_cuda.launches = 0
    ha._adi_cuda.launches = 0
    ha._adi_adjoint_cuda.launches = 0
    phase_pricers(dev, card)
    phase_pricers_server(dev)
    check([fn.launches for fn in kernel_fns] == before,
          "the pricers without a kernel launched one of the eleven kernels")
    phase_slice(dev, card)
    phase_slice_server(dev)
    check([fn.launches for fn in kernel_fns] == before,
          "the slice launched one of the eleven Monte Carlo kernels")
    check(tp._theta_jumps_cuda.launches > 0, "the dividend PDE never launched the jump-table "
                                             "kernel")
    check(lvp._lv_cuda.launches > 0, "the local-vol bracket never launched the local-vol loop")
    pde_before = (tri._tridiag_cuda.launches, tp._theta_cuda.launches,
                  tp._theta_adjoint_cuda.launches)
    phase_risk(dev, card)
    phase_risk_server(dev)
    check([fn.launches for fn in kernel_fns] == before,
          "the risk engine launched one of the eleven Monte Carlo kernels")
    risk_tri = tri._tridiag_cuda.launches - pde_before[0]
    risk_theta = tp._theta_cuda.launches - pde_before[1]
    risk_rev = tp._theta_adjoint_cuda.launches - pde_before[2]
    log("launches", f"the risk engine's share: tridiag {risk_tri}, theta_pde {risk_theta}, "
                    f"theta_pde_adjoint {risk_rev}")
    check(risk_theta > 0 and risk_rev > 0 and risk_tri > 0,
          "greeks_fdm never launched the θ-scheme kernel or its reverse, or the second-order "
          "PDE Greeks never ran the recompute")
    # the chain-to-surface slice, with pandas unimportable (the card's machine
    # has none): heston_chain, local_vol_mc and lv_pde launch, nothing else
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
    # the learned surfaces, the surrogate and optimize/, with pandas and
    # scikit-learn unimportable: gbm_mc (the surrogate's labels) and
    # heston_chain (the calibration study) launch, nothing else
    sys.modules["pandas"] = None
    try:
        ln = phase_learned(dev, card)
    finally:
        if had_pandas is False:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = had_pandas
    ln_after = launch_counts()
    ln_launches = {k: ln_after[k] - sf_after[k] for k in ln_after}
    # the command line: every subcommand through cli.main, pandas unimportable
    sys.modules["pandas"] = None
    try:
        cl = phase_cli(dev, card)["launched"]
    finally:
        if had_pandas is False:
            del sys.modules["pandas"]
        else:
            sys.modules["pandas"] = had_pandas
    check(all(cl[k] > 0 for k in cl if k not in ("heston_qe", "tridiag", "heston_adi_adjoint",
                                                  "theta_pde_adjoint", "theta_jump", "lv_pde")),
          f"the command line never launched a kernel of its path: {cl}")
    # parallel/: every kernel route sharded over meshes of this card
    pl_before = launch_counts()
    phase_parallel(dev, card)
    pl_after = launch_counts()
    pl = {k: pl_after[k] - pl_before[k] for k in pl_after}
    log("launches", f"the parallel slice's share: {pl}")
    off_path = ("heston_chain", "tridiag", "theta_pde", "theta_pde_adjoint", "theta_jump",
                "lv_pde",
                "heston_adi", "heston_adi_adjoint")
    check(all(pl[k] > 0 for k in pl if k not in off_path),
          f"the parallel slice never launched a kernel of its path: {pl}")
    check(all(pl[k] == 0 for k in off_path),
          f"the parallel slice launched a kernel off its path: {pl}")
    log("launches", f"the learned slice's share: {ln_launches}")
    check(ln_launches["gbm_mc"] == ln["gbm"],
          f"gbm_mc launched {ln_launches['gbm_mc']} times for {ln['gbm']} label calls")
    check(ln_launches["heston_chain"] >= ln["chain"] > 0,
          "the calibration study never launched the chain kernel")
    check(all(n == 0 for k, n in ln_launches.items() if k not in ("gbm_mc", "heston_chain")),
          f"the learned slice launched another kernel: {ln_launches}")
    log("launches", f"the surface slice's share: {sf_launches}")
    check(sf_launches["heston_chain"] >= 202, "the heston-mc fit never ran its 202 launches")
    check(sf_launches["local_vol_mc"] == surf["lv"],
          f"local_vol_mc launched {sf_launches['local_vol_mc']} times for {surf['lv']} calls")
    check(sf_launches["lv_pde"] > 0, "the chain's Dupire PDE never launched the local-vol "
                                     "loop")
    check(all(n == 0 for k, n in sf_launches.items()
              if k not in ("heston_chain", "local_vol_mc", "lv_pde")),
          f"the surface slice launched another kernel: {sf_launches}")
    tri_launches = tri._tridiag_cuda.launches
    log("launches", f"tridiag launched {tri_launches} times over the pricers, the slice, "
                    "the risk engine, the surface slice and the command line")
    check(tri_launches > 0, "the PDE path never launched the tridiagonal kernel")
    theta_launches = tp._theta_cuda.launches
    log("launches", f"theta_pde launched {theta_launches} times over the pricers, the slice, "
                    "the risk engine and the command line")
    check(theta_launches > 0, "the PDE path never launched the θ-scheme kernel")
    rev_launches, jump_launches = tp._theta_adjoint_cuda.launches, tp._theta_jumps_cuda.launches
    lv_loop_launches = lvp._lv_cuda.launches
    log("launches", f"theta_pde_adjoint launched {rev_launches} times, theta_jump "
                    f"{jump_launches}, lv_pde {lv_loop_launches}, over the same paths")
    check(min(rev_launches, jump_launches, lv_loop_launches) > 0,
          "the PDE path never launched the θ reverse, the jump table or the local-vol loop")
    adi_launched = (ha._adi_cuda.launches, ha._adi_adjoint_cuda.launches)
    log("launches", f"heston_adi launched {adi_launched[0]} times, heston_adi_adjoint "
                    f"{adi_launched[1]}, over the slice, its routes and the command line")
    check(min(adi_launched) > 0, f"the Heston PDE path never launched an ADI kernel: "
                                 f"{adi_launched}")
    for tag, t in (list(gbm_t.items()) + list(ex_t.items()) + list(h_t.items())
                   + [(f"heston_exotic {k_}", v) for k_, v in hx_t.items()]
                   + list(smile_t.items()) + list(ma_t.items())):
        sampler = "hash residuals" if "sobol_bb" in tag else "sobol" if "sobol" in tag else "prng"
        how = "a CUDA graph of calls" if "back_to_back_ms" in t else "CUDA events"
        log("timing", f"{tag} {sampler}, device ms by {how} [{card}]: kernel {t['ms']:.4f}, "
                      f"plain torch {t.get('plain_ms', float('nan')):.3f}, bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']})")

    adi_tag = "european {}x{}x{}".format(*SL_ADI)

    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": f"optionslab_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("gbm_mc_kernel", "gbm_mc.cu", "optionslab_tpu/ops/gbm_pallas.py:104",
              gbm_launches + ln_launches["gbm_mc"] + cl["gbm_mc"] + pl["gbm_mc"], gbm_err,
              gbm_t["1024x1e6"]),
        entry("exotic_mc_kernel", "exotic_mc.cu", "optionslab_tpu/ops/exotic_pallas.py:150",
              mc_launches + cl["exotic_mc"] + pl["exotic_mc"], mc_err,
              ex_t["asian_arith 4Mx252"]),
        entry("exotic_greeks_kernel", "exotic_greeks.cu",
              "optionslab_tpu/ops/exotic_pallas.py:1315",
              greeks_launches + cl["exotic_greeks"] + pl["exotic_greeks"],
              greeks_err,
              ex_t["greeks asian_geo 8Mx252"]),
        entry("heston_mc_kernel", "heston_mc.cu", "optionslab_tpu/ops/heston_pallas.py:59",
              h_launches["mc"] + cl["heston_mc"] + pl["heston_mc"], h_err["mc"],
              h_timing(h_t, "heston_mc price prng")),
        entry("heston_qe_kernel", "heston_qe.cu", "optionslab_tpu/ops/heston_pallas.py:280",
              h_launches["qe"] + cl["heston_qe"] + pl["heston_qe"], h_err["qe"],
              h_timing(h_t, "heston_qe prng")),
        entry("heston_qe_ladder_kernel", "heston_qe.cu",
              "optionslab_tpu/ops/heston_pallas.py:365", h_launches["qe_ladder"]
              + cl["heston_qe_ladder"] + pl["heston_qe_ladder"],
              h_err["qe_ladder"], h_timing(h_t, "heston_qe_ladder prng")),
        entry("heston_chain_kernel", "heston_chain.cu", "optionslab_tpu/ops/heston_pallas.py:469",
              h_launches["chain"] + sf_launches["heston_chain"] + ln_launches["heston_chain"]
              + cl["heston_chain"],
              h_err["chain"],
              h_timing(h_t, "heston_chain prng 40")),
        entry("heston_exotic_kernel", "heston_exotic.cu",
              "optionslab_tpu/ops/heston_pallas.py:1079",
              hx_launches + cl["heston_exotic"] + pl["heston_exotic"], hx_err,
              hx_t[f"asian_arith {HX_MAIN[0]}x{HX_MAIN[1]}"]),
        entry("local_vol_mc_kernel", "local_vol_mc.cu",
              "optionslab_tpu/ops/local_vol_pallas.py:64",
              lv_launches + sf_launches["local_vol_mc"] + cl["local_vol_mc"]
              + pl["local_vol_mc"], lv_err,
              smile_t[f"local_vol european {LV_MAIN[0]}x{LV_MAIN[1]}"]),
        entry("slv_mc_kernel", "slv_mc.cu", "optionslab_tpu/ops/slv_pallas.py:106",
              slv_launches + cl["slv_mc"] + pl["slv_mc"], slv_err,
              smile_t[f"slv barrier {SLV_MAIN[0]}x{SLV_MAIN[1]}"]),
        entry("multi_asset_mc_kernel", "multi_asset_mc.cu",
              "optionslab_tpu/ops/multi_asset_pallas.py:58",
              ma_launches + cl["multi_asset_mc"] + pl["multi_asset_mc"],
              ma_err,
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
        {**entry("theta_pde_adjoint_kernel", "theta_pde.cu",
                 "optionslab_tpu/models/fdm.py:162 and :101 (the reverse mode jax.grad runs), "
                 "no Pallas kernel", rev_launches, rev_err, rev_t["howard float32"]),
         "chain_ms": rev_t["howard float32"]["chain_ms"],
         "old_chain_ms": rev_t["howard float32"]["old_chain_ms"],
         "old_chain_2n_ms": rev_t["howard float32"]["old_chain_2n_ms"]},
        {**entry("theta_jump_kernel", "theta_pde.cu",
                 "optionslab_tpu/models/dividends.py:137 (lax.scan of _fdm_div_single), no "
                 "Pallas kernel", jump_launches, div_err, div_t["american put 401x400"]),
         "chain_ms": div_t["american put 401x400"]["chain_ms"],
         "old_chain_ms": div_t["american put 401x400"]["old_chain_ms"]},
        {**entry("lv_pde_kernel", "lv_pde.cu",
                 "optionslab_tpu/models/local_vol.py:197 and local_vol_american.py:85-125 "
                 "(lax.scan), no Pallas kernel", lv_loop_launches, lvl_err,
                 lvl_t["european call 201x200"]),
         "chain_ms": lvl_t["european call 201x200"]["chain_ms"],
         "old_chain_ms": lvl_t["european call 201x200"]["old_chain_ms"]},
        {**entry("heston_adi_kernel", "heston_adi.cu",
                 "optionslab_tpu/models/heston_fdm.py:200, :219, :331, :403 (lax.scan over the "
                 "step at :160-177), no Pallas kernel", adi_launched[0], adi_err,
                 adi_t[adi_tag]), "chain_ms": adi_t[adi_tag]["chain_ms"]},
        {**entry("heston_adi_adjoint_kernel", "heston_adi.cu",
                 "optionslab_tpu/models/heston_fdm.py:219 (reverse mode of the "
                 "jax.checkpoint scan), no Pallas kernel", adi_launched[1], adi_grad["abs"],
                 adi_t["adjoint " + adi_tag]), "chain_ms": adi_t["adjoint " + adi_tag]["chain_ms"]},
        # the measurement kernels of tridiag.cu: on no path, so their launches
        # are the run's (all in the tridiagonal phase)
        *(entry(name, "tridiag.cu", "none: a chain probe of the PDE kernels' bound, no TPU "
                "kernel", probe_run.launches[kind], tri_t[f"probe {kind} float32"]["err"],
                tri_t[f"probe {kind} float32"])
          for name, kind in (("tridiag_chain_kernel", "pivot"),
                             ("tridiag_rhs_chain_kernel", "rhs"),
                             ("tridiag_fma_chain_kernel", "fma"))),
        {**entry("tridiag_warp_probe_kernel", "tridiag.cu", "none: the probe of the "
                 "warp-partitioned solve's chain, no TPU kernel", probe_run.launches["warp"],
                 max(tri_t[f"probe {k} float32"]["err"] for k in WARP_PROBES),
                 tri_t["probe muladd float32"])},
        {**entry("tridiag_div_check_kernel", "tridiag.cu", "none: the check of the PDE kernels' "
                 "quotient on reciprocals, no TPU kernel", div_check.launches,
                 tri_t["division float32"]["err"], tri_t["division float32"]),
         "library_ms": tri_t["division float32"]["library_ms"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
