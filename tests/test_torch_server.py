"""The port's pricing server over a real socket, on the CPU, and a scan
that keeps JAX out of the port."""

import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from optionslab_tpu_torch.server import PricingServer

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


def test_price_unported_model_is_400(base_url):
    status, out = _call(base_url + "/price", {"model": "heston"})
    assert status == 400 and "not yet ported" in out["error"]


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


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/exotic"),
                                         ("POST", "/health")])
def test_unknown_route_is_404(base_url, method, path):
    status, out = _call(base_url + path, {} if method == "POST" else None)
    assert status == 404
    assert "/mc" in out["endpoints"]


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
