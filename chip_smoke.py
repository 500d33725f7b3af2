#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``optionslab_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the exit code is
nonzero and no result line is printed):

1. device   — a CUDA card is required; prints its name and power limit;
2. build    — compiles ``optionslab_tpu_torch/csrc/*.cu`` with nvcc;
3. parity   — the GBM kernel against its plain torch version on the card,
              per-row moment sums, for every sampler with and without Greeks
              at small shapes, and at the main path's shapes with ``prng``;
4. main     — the main path at full size through ``MonteCarloPricer``:
              1e9 paths on one contract, a 1024-contract book at 1e6 paths
              each, and the price-only sibling, checked against
              Black–Scholes, with warm wall times;
5. server   — ``PricingServer`` on the card answering over a real socket;
6. launches — the kernel's launch count over phases 4–5.

The last two lines are a JSON object of kernel measurements and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import time
import urllib.request

import torch

from optionslab_tpu_torch import ContractBatch, MCMethod, MonteCarloPricer, PricingServer
from optionslab_tpu_torch.models.black_scholes import bs_greeks
from optionslab_tpu_torch.ops import _build
from optionslab_tpu_torch.ops import gbm_kernel as gk

BS_ATM_CALL = 10.450583572185565  # S=K=100, T=1, r=0.05, σ=0.2
# absolute Greek bounds of the reference's kernel test (tests/test_gbm_pallas_host.py)
GREEK_BOUNDS = {"delta": 1e-3, "gamma": 1e-4, "vega": 0.05, "rho": 0.1, "dual_delta": 1e-3}
RTOL = 1e-5  # kernel vs plain on per-row sums: summation order is the only difference


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


def phase_timing(dev) -> tuple[float, float]:
    """Device ms of the kernel and of the plain version at the book shape
    (1024 contracts x 1e6 paths, prng, Greeks). Not counted as main path."""
    params, kw = moments_inputs(book_batch(1024, dev), 1_000_000, "prng", True)
    gk._gbm_moments_cuda(0, 0, params, **kw)
    ms = event_time(lambda: gk._gbm_moments_cuda(0, 0, params, **kw), 10)
    gk._gbm_moments_plain(0, 0, params, **kw)
    plain_ms = event_time(lambda: gk._gbm_moments_plain(0, 0, params, **kw), 2)
    return ms, plain_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    card = card_line()
    log("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    _build.load_library()
    log("build", f"libgbm_kernels.so ready in {_build.build_seconds():.1f} s")

    max_abs_err = phase_parity(dev)

    gk._gbm_moments_cuda.launches = 0
    main_stats = phase_main(dev, card)
    n_mc = phase_server(dev)
    launches = gk._gbm_moments_cuda.launches
    expected = main_stats["calls"] + n_mc
    log("launches", f"gbm_mc launched {launches} times for {expected} kernel-route calls")
    if launches < expected:
        raise AssertionError(f"main path launched the kernel {launches} < {expected} times")

    ms, plain_ms = phase_timing(dev)
    log("timing", f"book 1024x1e6 prng Greeks, device ms by CUDA events [{card}]: "
                  f"kernel {ms:.3f}, plain torch {plain_ms:.3f}")

    print(json.dumps({"kernels": [{
        "name": "gbm_mc_kernel",
        "route": "cuda",
        "source": "optionslab_tpu_torch/csrc/gbm_mc.cu",
        "replaces": "optionslab_tpu/ops/gbm_pallas.py:104",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
