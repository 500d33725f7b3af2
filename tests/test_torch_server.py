"""The port's pricing server over a real socket, on the CPU, and a scan
that keeps JAX out of the port."""

import json
import math
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from optionslab_tpu_torch.server import PricingServer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT_PKG = Path(__file__).resolve().parent.parent / "optionslab_tpu_torch"


@pytest.fixture(scope="module")
def base_url():
    server = PricingServer(port=0, device="cpu").start()
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_health(base_url):
    status, out = _call(base_url + "/health")
    assert status == 200
    assert out["status"] == "ok" and out["device"] == "cpu" and out["device_name"] == "cpu"


def test_price_and_batch_price(base_url):
    status, out = _call(base_url + "/price", {"model": "bs"})
    assert status == 200 and out["price"] == pytest.approx(10.4506, abs=1e-3)
    status, out = _call(base_url + "/batch/price",
                        {"spot": [100.0, 100.0], "option_type": "put"})
    assert status == 200 and out["price"] == pytest.approx([5.5735] * 2, abs=1e-3)


@pytest.mark.parametrize("body", [{}, {"heston_params": {"v0": 0.09, "rho": -0.3},
                                       "strike": 110.0, "option_type": "put"}])
def test_price_heston_is_the_ports_lewis_price(base_url, body):
    from optionslab_tpu_torch.models.heston import HestonParams, heston_price
    from optionslab_tpu_torch.types import ContractBatch

    status, out = _call(base_url + "/price", {"model": "heston", **body})
    assert status == 200 and out["model"] == "heston"
    b = ContractBatch.make(100.0, body.get("strike", 100.0), 1.0, 0.05, 0.2,
                           body.get("option_type", "call"))
    params = HestonParams.make(**body.get("heston_params", {}))
    assert out["price"] == heston_price(b, params).item()


def test_price_unported_model_is_400(base_url):
    """Every model of the JAX package's /price is ported: an unknown model
    answers 400 with the list of the models served."""
    status, out = _call(base_url + "/price", {"model": "sabr"})
    assert status == 400 and "'merton'" in out["error"] and "'binomial'" in out["error"]


@pytest.mark.parametrize("body", [{}, {"bates_params": {"lam": 1.2, "mu_j": -0.2, "v0": 0.06},
                                       "strike": 90.0, "option_type": "put"}])
def test_price_bates_is_the_ports_lewis_price(base_url, body):
    """/price bates answers the port's Lewis price of the Bates CF, which
    agrees with the JAX package's handler to float32 rounding."""
    from optionslab_tpu.server import handle_price
    from optionslab_tpu_torch.models.bates import BatesParams, bates_price
    from optionslab_tpu_torch.types import ContractBatch

    status, out = _call(base_url + "/price", {"model": "bates", **body})
    assert status == 200 and out["model"] == "bates"
    b = ContractBatch.make(100.0, body.get("strike", 100.0), 1.0, 0.05, 0.2,
                           body.get("option_type", "call"))
    assert out["price"] == bates_price(b, BatesParams.make(**body.get("bates_params", {}))).item()
    assert out["price"] == pytest.approx(handle_price({"model": "bates", **body})["price"],
                                         rel=1e-5)


def test_greeks(base_url):
    status, out = _call(base_url + "/greeks", {"option_type": "put"})
    assert status == 200
    assert out["price"] == pytest.approx(5.5735, abs=1e-3)
    assert out["delta"] == pytest.approx(-0.3632, abs=1e-3)


@pytest.mark.parametrize("method", ["pallas", "xla"])
def test_mc(base_url, method):
    body = {"n_paths": 200_000, "seed": 3, "method": method}
    status, out = _call(base_url + "/mc", body)
    assert status == 200
    assert set(out) >= {"price", "std_error", "delta", "gamma", "vega", "rho", "theta"}
    assert abs(out["price"] - 10.450583572185565) < 4 * out["std_error"]
    assert out["delta"] == pytest.approx(0.6368, abs=0.01)
    # same request, same numbers
    assert _call(base_url + "/mc", body)[1] == out


def test_mc_bad_method_is_400(base_url):
    status, out = _call(base_url + "/mc", {"method": "qmc", "n_paths": 1000})
    assert status == 400


def test_metrics_count_requests(base_url):
    _call(base_url + "/greeks", {})
    status, out = _call(base_url + "/metrics")
    assert status == 200 and out["/greeks"]["count"] >= 1


# /basket against the JAX package's handler (its kernel draws with `hash` or
# `sobol` off the TPU), one path block: the same keys, prices and stderrs to
# rtol 1e-5 (a sobol stderr: 1e-5 of the price), Greeks to 1e-4 of
# max(|value|, 1e-2·price)
BASKET_BODIES = {
    "price": {},
    "cv_put": {"control_variate": True, "option_type": "put", "strike": 105.0},
    "sobol_geo": {"kind": "basket_geo", "sampler": "sobol", "weights": [0.4, 0.3, 0.3]},
    "greeks": {"greeks": True, "rho": 0.2},
    "greeks_sobol_spread": {"greeks": True, "kind": "spread", "spots": [100.0, 95.0],
                            "vols": [0.2, 0.25], "strike": 0.0, "sampler": "sobol"},
    "asian": {"kind": "basket_asian", "n_steps": 8,
              "corr": [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]},
}


@pytest.mark.parametrize("case", sorted(BASKET_BODIES))
def test_basket_matches_reference(base_url, case):
    from optionslab_tpu.server import handle_basket

    body = {"n_paths": 1, "seed": 4, "sampler": "hash", **BASKET_BODIES[case]}
    status, out = _call(base_url + "/basket", body)
    assert status == 200, out
    ref = handle_basket(dict(body))
    assert set(out) == set(ref)
    for key in ("kind", "sampler", "paths", "control_variate"):
        assert out.get(key) == ref.get(key), key
    np.testing.assert_allclose(out["price"], ref["price"], rtol=1e-5)
    # the sobol stderr is the spread of 8 replicate means, each good to 1e-5 of the price
    np.testing.assert_allclose(out["std_error"], ref["std_error"], rtol=1e-5,
                               atol=1e-5 * ref["price"])
    for key in ("delta", "vega", "gamma", "theta", "rho"):
        if key in ref:
            want = np.asarray(ref[key])
            scale = np.maximum(np.abs(want), 1e-2 * ref["price"])
            assert (np.abs(np.asarray(out[key]) - want) / scale).max() < 1e-4, key
    if body["sampler"] == "sobol":  # the error bar labelled for what it is
        note = out["stderr_note"]
        assert ("plain-MC" in note) == bool(body.get("greeks")), note


@pytest.mark.parametrize("body,names", [({"kind": "nope"}, "unknown kind"),
                                        ({"kind": "spread"}, "2 assets"),
                                        ({"kind": "basket_asian", "n_steps": 4,
                                          "sampler": "sobol"}, "terminal-only"),
                                        ({"rho": -0.9}, "positive definite")])
def test_basket_bad_requests_are_400(base_url, body, names):
    status, out = _call(base_url + "/basket", {"n_paths": 1, **body})
    assert status == 400 and names in out["error"], out


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/calibrate"),
                                         ("POST", "/health")])
def test_unknown_route_is_404(base_url, method, path):
    status, out = _call(base_url + path, {} if method == "POST" else None)
    assert status == 404
    assert {"/mc", "/exotic", "/book/exotic", "/basket", "/iv", "/varswap",
            "/american", "/xva"} <= set(out["endpoints"])


# /exotic and /book/exotic against the JAX package's handlers. Off the TPU the
# reference's kernel routes draw with the `hash` sampler, which the port's
# requests name; both run one path block of 8 steps.
KERNEL_BODIES = {
    "asian_greeks": {"kind": "asian", "greeks": True},
    "barrier_greeks": {"kind": "barrier", "greeks": True, "barrier": 125.0},
    "autocallable_greeks": {"kind": "autocallable", "greeks": True, "n_steps": 6},
    "double_barrier": {"kind": "double-barrier", "lower": 80.0, "upper": 125.0},
    "double_barrier_rebate": {"kind": "double-barrier", "lower": 80.0, "upper": 125.0,
                              "rebate": 1.5, "knock": "in"},
    "double_touch_hit": {"kind": "double-touch", "touch": "one", "pay": "hit",
                         "lower": 85.0, "upper": 118.0},
    "one_touch_hit": {"kind": "one-touch", "pay": "hit", "barrier": 115.0},
    "no_touch": {"kind": "no-touch", "barrier": 88.0},
    "barrier_rebate": {"kind": "barrier", "barrier": 125.0, "rebate": 2.0},
    "asian_cv": {"kind": "asian", "control_variate": True, "n_steps": 16},
}


def _same_answer(ours: dict, ref: dict, rtol=1e-5):
    assert set(ours) == set(ref)
    for key, v in ref.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert ours[key] == pytest.approx(v, rel=rtol, abs=1e-6), key
        elif isinstance(v, list) and v and isinstance(v[0], float):
            assert ours[key] == pytest.approx(v, rel=rtol, abs=1e-6), key
        else:
            assert ours[key] == v, key


@pytest.mark.parametrize("case", sorted(KERNEL_BODIES))
def test_exotic_kernel_routes_match_reference(base_url, case):
    from optionslab_tpu.server import handle_exotic

    body = {"n_paths": 1, "n_steps": 8, "seed": 2, **KERNEL_BODIES[case]}
    status, out = _call(base_url + "/exotic", {**body, "sampler": "hash"})
    assert status == 200, out
    _same_answer(out, handle_exotic(dict(body)))
    if case == "double_barrier":
        assert out["closed_form_continuous"] > 0.0


@pytest.mark.parametrize("body", [{"kind": "asian"}, {"kind": "lookback", "floating": False},
                                  {"kind": "barrier", "barrier_type": "down-and-out",
                                   "barrier": 90.0},
                                  {"kind": "cliquet"}])
def test_exotic_scan_routes_match_reference(base_url, body):
    """The scan engines draw from different generators: same keys, prices
    within 5 combined standard errors."""
    from optionslab_tpu.server import handle_exotic

    status, out = _call(base_url + "/exotic", {**body, "n_paths": 20_000})
    ref = handle_exotic({**body, "n_paths": 20_000})
    assert status == 200 and set(out) == set(ref) and out["kind"] == ref["kind"]
    assert abs(out["price"] - ref["price"]) < 5 * (out["std_error"] ** 2
                                                   + ref["std_error"] ** 2) ** 0.5


@pytest.mark.parametrize("greeks", [False, True])
def test_book_exotic_matches_reference(base_url, greeks):
    from optionslab_tpu.server import handle_book

    body = {"kind": "asian", "strikes": [90.0, 100.0, 110.0], "n_paths": 60_000,
            "n_steps": 8, "greeks": greeks, "type": "put"}
    status, out = _call(base_url + "/book/exotic", {**body, "sampler": "hash"})
    assert status == 200, out
    _same_answer(out, handle_book(dict(body)))
    assert len(out["price"]) == 3 and out["n_contracts"] == 3


@pytest.mark.parametrize("path,body,names", [
    ("/exotic", {"kind": "american"}, "autocallable"),
    ("/exotic", {"kind": "asian", "model": "sabr"}, "'rbergomi'"),
    ("/exotic", {"kind": "range-accrual", "model": "rbergomi"}, "supports"),
    ("/book/exotic", {"kind": "asian", "model": "slv"}, "'bates'"),
    ("/exotic", {"kind": "no-touch", "pay": "hit"}, "no-touch"),
    ("/exotic", {"kind": "asian", "model": "heston-qe", "greeks": True}, "drop -qe"),
    ("/exotic", {"kind": "american", "model": "bates"}, "supports"),
    ("/exotic", {"kind": "no-touch", "pay": "hit", "model": "heston"}, "no-touch"),
])
def test_exotic_unported_is_400(base_url, path, body, names):
    status, out = _call(base_url + path, body)
    assert status == 400 and names in out["error"]


# /exotic and /book/exotic under Heston and Bates against the JAX package's
# handlers (its kernel routes draw with `hash` off the TPU), one path block of
# 8 steps. Prices and the price-like Greeks to rtol 1e-5; the LR rho and
# theta carry the rate and maturity scores, which divide by √v⁺ per step: an
# ulp of XLA-vs-torch libm on a path that grazes v = 0 moves that lane's term
# by up to ~1e-3 of the moment (tests/test_torch_heston_exotic_kernel.py),
# hence 1e-2 there.
HESTON_BODIES = {
    "heston_asian": {"model": "heston", "kind": "asian"},
    "heston_qe_barrier": {"model": "heston-qe", "kind": "barrier", "barrier": 125.0,
                          "option_type": "put", "strike": 105.0},
    "bates_down_in_put": {"model": "bates", "kind": "barrier", "barrier_type": "down-and-in",
                          "barrier": 85.0, "option_type": "put"},
    "bates_qe_double_touch_hit": {"model": "bates-qe", "kind": "double-touch", "touch": "one",
                                  "pay": "hit", "lower": 85.0, "upper": 118.0},
    "heston_one_touch_greeks": {"model": "heston", "kind": "one-touch", "barrier": 115.0,
                                "greeks": True},
    "bates_asian_greeks": {"model": "bates", "kind": "asian", "greeks": True, "lam": 0.8},
    "heston_autocall_greeks": {"model": "heston", "kind": "autocallable", "greeks": True},
    "heston_cliquet": {"model": "heston", "kind": "cliquet", "v0": 0.05, "rho_sv": -0.5},
}


def _same_heston_answer(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for key, v in ref.items():
        rtol = 1e-2 if key in ("rho", "theta") else 1e-5
        if isinstance(v, float) or (isinstance(v, list) and v and isinstance(v[0], float)):
            assert ours[key] == pytest.approx(v, rel=rtol, abs=1e-5), key
        else:
            assert ours[key] == v, key


@pytest.mark.parametrize("case", sorted(HESTON_BODIES))
def test_exotic_heston_routes_match_reference(base_url, case):
    from optionslab_tpu.server import handle_exotic

    body = {"n_paths": 1, "n_steps": 8, "seed": 2, **HESTON_BODIES[case]}
    status, out = _call(base_url + "/exotic", {**body, "sampler": "hash"})
    assert status == 200, out
    _same_heston_answer(out, handle_exotic(dict(body)))
    assert out["dynamics"] == ("bates" if body["model"].startswith("bates") else "heston")


@pytest.mark.parametrize("model,greeks", [("heston", False), ("heston", True), ("bates", False)])
def test_book_exotic_heston_matches_reference(base_url, model, greeks):
    from optionslab_tpu.server import handle_book

    body = {"kind": "barrier", "model": model, "strikes": [95.0, 105.0],
            "barriers": [125.0, 130.0], "n_paths": 60_000, "n_steps": 8, "greeks": greeks}
    status, out = _call(base_url + "/book/exotic", {**body, "sampler": "hash"})
    assert status == 200, out
    _same_heston_answer(out, handle_book(dict(body)))
    assert out["model"] == model and len(out["price"]) == 2


# /exotic under Dupire local vol against the JAX package's handler (its kernel
# routes draw with `hash` off the TPU), one path block of 8 steps: the two
# packages' Dupire grids agree to 1.2e-7 and their σ tables' polynomials to
# 7e-9 (tests/test_torch_local_vol_kernel.py), so prices and Greeks agree to
# rtol 1e-5. The reference's range-accrual Greeks answer multiplies "paths"
# and "fit_residual" by the notional with the prices; the port scales the
# prices and Greeks only.
LV_BODIES = {
    "lv_barrier": {"kind": "barrier", "barrier": 125.0},
    "lv_asian_greeks": {"kind": "asian", "greeks": True},
    "lv_lookback_put": {"kind": "lookback", "option_type": "put"},
    "lv_range_accrual": {"kind": "range-accrual", "notional": 50.0},
    "lv_range_accrual_greeks": {"kind": "range-accrual", "greeks": True},
    "lv_double_touch_hit": {"kind": "double-touch", "touch": "one", "pay": "hit",
                            "lower": 85.0, "upper": 118.0},
    "lv_european": {"kind": "european", "strike": 105.0, "vol": 0.25},
}


@pytest.mark.parametrize("case", sorted(LV_BODIES))
def test_exotic_lv_kernel_routes_match_reference(base_url, case):
    from optionslab_tpu.server import handle_exotic

    body = {"model": "lv", "n_paths": 1, "n_steps": 8, "seed": 2, **LV_BODIES[case]}
    status, out = _call(base_url + "/exotic", {**body, "sampler": "hash"})
    assert status == 200, out
    ref = handle_exotic(dict(body))
    if case == "lv_range_accrual_greeks":
        assert out["paths"] == ref["paths"] / 100.0
        ref["paths"], ref["fit_residual"] = out["paths"], ref["fit_residual"] / 100.0
    assert out["engine"] == "kernel" and out["dynamics"] == "dupire-local-vol"
    _same_answer(out, ref)


# the SLV routes calibrate their own leverage (another generator than the
# reference's): the same keys and strings, prices within 5 combined standard
# errors plus 1% of the price (the two calibrations' difference)
SLV_BODIES = {
    "slv_autocall": {"kind": "autocallable"},
    "slv_cliquet_greeks": {"kind": "cliquet", "greeks": True, "mixing": 0.5},
    "slv_range_accrual": {"kind": "range-accrual"},
    "slv_barrier_greeks": {"kind": "barrier", "greeks": True, "barrier": 125.0},
    "slv_asian_scan": {"kind": "asian", "n_paths": 16_384},
    "slv_double_barrier_scan": {"kind": "double-barrier", "n_paths": 16_384, "mixing": 0.3},
}


@pytest.mark.parametrize("case", sorted(SLV_BODIES))
def test_exotic_slv_routes_match_reference(base_url, case):
    from optionslab_tpu.server import handle_exotic

    body = {"model": "slv", "n_paths": 1, "n_steps": 8, "seed": 2, **SLV_BODIES[case]}
    status, out = _call(base_url + "/exotic", {**body, "sampler": "hash"})
    assert status == 200, out
    ref = handle_exotic(dict(body))
    assert set(out) == set(ref)
    for key, v in ref.items():
        if isinstance(v, str):
            assert out[key] == v, key
    tol = 5 * (out["std_error"] ** 2 + ref["std_error"] ** 2) ** 0.5 + 0.01 * abs(ref["price"])
    assert abs(out["price"] - ref["price"]) < tol
    assert all(math.isfinite(out[k]) for k in out if isinstance(out[k], float))


@pytest.mark.parametrize("kind", ["cliquet", "autocallable"])
def test_exotic_lv_structured_routes_match_reference(base_url, kind):
    """The pure-LV autocallable and cliquet run the SLV scan at mixing 0."""
    from optionslab_tpu.server import handle_exotic

    body = {"model": "lv", "kind": kind, "n_paths": 16_384, "n_steps": 8}
    status, out = _call(base_url + "/exotic", body)
    ref = handle_exotic(dict(body))
    assert status == 200 and set(out) == set(ref) and out["engine"] == "slv-scan-mixing0"
    assert abs(out["price"] - ref["price"]) < 5 * (out["std_error"] ** 2
                                                   + ref["std_error"] ** 2) ** 0.5


@pytest.mark.parametrize("model,body,names", [
    ("lv", {"kind": "no-touch", "pay": "hit"}, "no-touch"),
    ("lv", {"kind": "american"}, "supports"),
    ("slv", {"kind": "european"}, "supports"),
    ("slv", {"kind": "barrier", "sampler": "sobol_bb", "greeks": True}, "prng|hash"),
])
def test_exotic_smile_bad_requests_are_400(base_url, model, body, names):
    status, out = _call(base_url + "/exotic", {"model": model, "n_steps": 4, **body})
    assert status == 400 and names in out["error"]


# /price binomial|vg|nig|merton, /iv, /varswap and /american against the JAX
# package's handlers: the deterministic answers to float32 rounding (rtol
# 1e-5), the Monte Carlo brackets and SLV strikes within 4 combined stderrs.
PRICE_BODIES = {
    "binomial_am_put": {"model": "binomial", "american": True, "option_type": "put",
                        "n_steps": 64},
    "binomial_eu": {"model": "binomial", "n_steps": 65, "strike": 110.0},
    "vg": {"model": "vg", "vg_params": {"nu": 0.3}, "strike": 90.0},
    "nig_put": {"model": "nig", "option_type": "put", "nig_params": {"beta": -2.0}},
    "merton": {"model": "merton", "merton_params": {"lam": 0.3, "sigma_j": 0.25}},
}


@pytest.mark.parametrize("case", sorted(PRICE_BODIES))
def test_price_models_match_reference(base_url, case):
    from optionslab_tpu.server import handle_price

    body = PRICE_BODIES[case]
    status, out = _call(base_url + "/price", body)
    assert status == 200, out
    _same_answer(out, handle_price(dict(body)))


@pytest.mark.parametrize("body", [{"price": 10.0}, {"price": 3.2, "option_type": "put",
                                                   "strike": 95.0, "dividend": 0.01}])
def test_iv_matches_reference(base_url, body):
    from optionslab_tpu.server import handle_iv

    status, out = _call(base_url + "/iv", body)
    assert status == 200, out
    assert out["implied_vol"] == pytest.approx(handle_iv(dict(body))["implied_vol"], abs=1e-5)


@pytest.mark.parametrize("body", [{"price": 0.0}, {"price": 150.0}, {"price": 5.0,
                                                                      "maturity": 0.0}, {}])
def test_iv_bad_price_is_400(base_url, body):
    status, out = _call(base_url + "/iv", body)
    assert status == 400 and out["error"]


def test_varswap_heston_matches_reference(base_url):
    from optionslab_tpu.server import handle_varswap

    body = {"maturity": 2.0, "heston_params": {"v0": 0.06, "sigma": 0.5}}
    status, out = _call(base_url + "/varswap", body)
    assert status == 200, out
    _same_answer(out, handle_varswap(dict(body)))


def test_varswap_slv_matches_reference(base_url):
    from optionslab_tpu.server import handle_varswap

    body = {"model": "slv", "n_paths": 8192, "n_steps": 8, "mixing": 0.5}
    status, out = _call(base_url + "/varswap", body)
    ref = handle_varswap(dict(body))
    assert status == 200 and set(out) == set(ref) and out["mixing"] == 0.5
    for k in ("variance", "vol"):
        comb = math.hypot(out[f"{k}_stderr"], ref[f"{k}_stderr"])
        assert abs(out[f"{k}_strike"] - ref[f"{k}_strike"]) < 4 * comb, k


@pytest.mark.parametrize("body", [
    {"model": "bs", "option_type": "put", "n_dates": 9, "n_grid": 128, "n_outer": 8192},
    {"model": "LV", "option_type": "put", "n_dates": 5, "n_outer": 512, "n_inner": 128},
])
def test_american_matches_reference(base_url, body):
    from optionslab_tpu.server import handle_american

    status, out = _call(base_url + "/american", body)
    ref = handle_american(dict(body))
    assert status == 200 and set(out) == set(ref), out
    for k in ("lower", "upper"):
        comb = math.hypot(out[f"{k}_se"], ref[f"{k}_se"])
        assert abs(out[k] - ref[k]) < 4 * comb + 1e-9, (k, out, ref)
    assert out["lower"] <= out["upper"] + 3 * out["upper_se"]


# The stochastic-vol brackets against the JAX package's /american handler at
# small sizes (its defaults otherwise: heston runs the ADI slices at 201 x 101,
# slv the SLV ADI at 161 x 81 on 131,072 calibration particles): the answer
# keys equal, each bound within 4 combined stderrs plus 1% of the price (the
# two draw different paths, and each bracket's own bias differs at 3 dates).
AMERICAN_BODIES = {
    "heston": {"n_dates": 3, "n_outer": 256, "n_inner": 64},
    "bates": {"n_dates": 3, "n_fit": 8_000, "n_lower": 16_000, "n_outer": 128, "n_inner": 64},
    "slv": {"n_dates": 3, "n_outer": 256, "n_inner": 64, "mixing": 0.5},
    "rbergomi": {"n_dates": 3, "n_fit": 8_192, "n_lower": 16_384, "n_outer": 128,
                 "n_inner": 64},
}


@pytest.mark.parametrize("model", sorted(AMERICAN_BODIES))
def test_american_stochastic_vol_matches_reference(base_url, model):
    from optionslab_tpu.server import handle_american

    body = {"model": model, "option_type": "put", **AMERICAN_BODIES[model]}
    status, out = _call(base_url + "/american", body)
    ref = handle_american(dict(body))
    assert status == 200 and set(out) == set(ref), out
    for k in ("n_dates", "pad", "method", "mixing"):
        if k in ref:
            assert out[k] == pytest.approx(ref[k]), k
    for k in ("lower", "upper"):
        comb = math.hypot(out[f"{k}_se"], ref[f"{k}_se"])
        assert abs(out[k] - ref[k]) < 4 * comb + 0.01 * ref[k], (k, out, ref)
    assert out["lower"] <= out["upper"] + 3 * (out["upper_se"] + out["lower_se"])


@pytest.mark.parametrize("body", [
    {"model": "vg", "option_type": "put"},
    {"model": "heston", "option_type": "call", "n_dates": 2},
])
def test_american_bad_requests_are_400(base_url, body):
    """An unknown model names the six served; a call bracket is refused."""
    status, out = _call(base_url + "/american", body)
    assert status == 400
    if body["model"] == "vg":
        assert all(f"'{m}'" in out["error"] for m in ("bs", "heston", "bates", "lv", "slv",
                                                        "rbergomi"))


# /exotic rbergomi against the JAX package's handler: different generators,
# so each price within 5 combined stderrs plus 1%.
RBERGOMI_BODIES = {
    "asian": {"kind": "asian"},
    "barrier": {"kind": "barrier", "barrier_type": "down-and-in", "barrier": 90.0},
    "touch_hit": {"kind": "one-touch", "pay": "hit", "barrier": 110.0},
    "double_touch": {"kind": "double-touch", "touch": "no", "lower": 85.0, "upper": 120.0},
    "cliquet": {"kind": "cliquet", "n_periods": 4},
    "autocallable": {"kind": "autocallable"},
}


@pytest.mark.parametrize("case", sorted(RBERGOMI_BODIES))
def test_exotic_rbergomi_matches_reference(base_url, case):
    from optionslab_tpu.server import handle_exotic

    body = {"model": "rbergomi", "n_paths": 8_192, "n_steps": 8, "seed": 3,
            **RBERGOMI_BODIES[case]}
    status, out = _call(base_url + "/exotic", body)
    ref = handle_exotic(dict(body))
    assert status == 200 and set(out) == set(ref), out
    assert out["kind"] == ref["kind"] and out["dynamics"] == "rough-bergomi"
    tol = 5 * math.hypot(out["std_error"], ref["std_error"]) + 0.01 * abs(ref["price"])
    assert abs(out["price"] - ref["price"]) < tol, (out, ref)


# /xva against the JAX package's handler (tests/test_server.py's XVA cases):
# the same answer keys, the exact oracles, and each profile's EPE and CVA
# within 5% of the reference's (the two draw different paths).
XVA_BODIES = {
    "bs": {"positions": [{"quantity": 1.0, "strike": 100.0, "maturity": 1.0,
                          "option_type": "call"}], "hazard": 0.03, "recovery": 0.4,
           "dates": 8, "paths": 16384, "own_hazard": 0.01, "funding_spread": 0.01},
    "amc_barrier": {"positions": [{"kind": "barrier_up-and-out", "barrier": 120.0},
                                  {"kind": "vanilla", "quantity": -0.2}],
                    "paths": 16384, "dates": 8},
    "heston_no_kind": {"positions": [{"option_type": "put"}], "model": "heston",
                       "paths": 16384, "dates": 4},
    "rbergomi": {"positions": [{"kind": "vanilla", "option_type": "put"}], "model": "rbergomi",
                 "rbergomi_params": {"hurst": 0.1, "eta": 1.9, "rho": -0.9, "xi0": 0.04},
                 "paths": 16384, "dates": 6},
}


@pytest.mark.parametrize("case", sorted(XVA_BODIES))
def test_xva_matches_reference(base_url, case):
    from optionslab_tpu.server import handle_xva

    body = XVA_BODIES[case]
    status, out = _call(base_url + "/xva", body)
    ref = handle_xva(dict(body))
    assert status == 200 and set(out) == set(ref), (out, ref)
    assert out.get("engine") == ref.get("engine") and len(out["ee"]) == len(ref["ee"])
    for k in ("epe", "cva"):
        assert out[k] == pytest.approx(ref[k], rel=0.05), (k, out[k], ref[k])
    if case == "bs":  # the martingale oracle and the flat-hazard CVA
        v0 = 10.450583572185565
        assert np.all(np.abs(np.asarray(out["ee_discounted"]) - v0) < 0.05 * v0)
        assert out["cva"] == pytest.approx(0.6 * v0 * (1.0 - np.exp(-0.03)), rel=0.1)


def test_xva_collateral_caps_and_vol_precedence(base_url):
    base = {"positions": [{"quantity": 1.0}], "dates": 6, "paths": 8192}
    _, un = _call(base_url + "/xva", base)
    _, coll = _call(base_url + "/xva", {**base, "collateral_threshold": 0.0, "mpor": 0.0})
    assert coll["epe"] < 1e-5 < un["epe"]
    status, capped = _call(base_url + "/xva", {"positions": [{"quantity": 1.0}], "dates": 500,
                                               "paths": 256})
    assert status == 200 and len(capped["dates"]) == 120
    status, capped = _call(base_url + "/xva", {"positions": [{"quantity": 1.0}], "dates": 1,
                                               "paths": 10**9})
    assert status == 200 and capped["n_paths"] == 1_048_576
    lo = _call(base_url + "/xva", {"positions": [{"kind": "vanilla", "vol": 0.1}],
                                   "paths": 8192, "dates": 4})[1]
    hi = _call(base_url + "/xva", {"positions": [{"kind": "vanilla", "vol": 0.4}],
                                   "paths": 8192, "dates": 4})[1]
    assert hi["epe"] > 1.5 * lo["epe"]


@pytest.mark.parametrize("body", [
    {"positions": [{"kind": "vanilla"}], "model": "garch"},
    {"positions": [{"option_type": "put"}], "model": "garch"},
    {"positions": [{"kind": "vanilla"}], "model": "bates", "heston_params": {"v0": 0.05}},
    {"positions": [{"kind": "vanilla"}], "model": "heston", "mixing": 0.5},
])
def test_xva_bad_requests_are_400(base_url, body):
    """An unknown model never falls through to the closed-form engine, and
    an override the model cannot consume is refused."""
    status, out = _call(base_url + "/xva", body)
    assert status == 400 and "error" in out


def test_port_package_never_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+optionslab_tpu\b|"
                         r"from\s+optionslab_tpu\b)", re.M)
    files = sorted(PORT_PKG.rglob("*.py"))
    assert len(files) >= 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_port_import_loads_no_jax():
    code = ("import sys, optionslab_tpu_torch, optionslab_tpu_torch.server; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'optionslab_tpu.'))"
            " or m == 'optionslab_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=PORT_PKG.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
