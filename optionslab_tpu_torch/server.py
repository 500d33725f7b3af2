"""HTTP pricing server over the port, on one device.

Endpoints (POST, JSON body, JSON response), with the request bodies of
``optionslab_tpu.server``:

  /price        {"model": "bs", contract fields...}   (other models: 400,
                not yet ported)
  /batch/price  the same; fields may be lists
  /greeks       {contract fields...}                → full BS Greek ladder
  /mc           {"n_paths": N, "seed": s, "method": "pallas|xla",
                 contract fields...}                → MC price, stderr and
                Greeks; "pallas" (the default) runs the fused GBM kernel
  /health  (GET) → status, device name and device count
  /metrics (GET) → per-endpoint request-latency count/p50/p95/max (ms)

Any other path answers 404 with the list of routes the port has.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .models.black_scholes import bs_greeks, bs_price
from .models.monte_carlo import MCConfig, mc_greeks, mc_price_result
from .ops.gbm_kernel import gbm_mc_price_greeks
from .types import ContractBatch
from .utils.config import DEFAULT_DTYPE, as_tensors
from .utils.exceptions import ValidationError
from .utils.logging import get_logger
from .utils.timing import Timer, get_timings

logger = get_logger(__name__)

_DEFAULTS = {"spot": 100.0, "strike": 100.0, "maturity": 1.0, "rate": 0.05,
             "vol": 0.2, "dividend": 0.0, "option_type": "call"}


def _contract(body: dict):
    p = {**_DEFAULTS, **body}
    cp = 1.0 if str(p["option_type"]).lower().startswith("c") else -1.0
    return p, cp


def _to_jsonable(x):
    arr = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return arr.item() if arr.ndim == 0 else arr.tolist()


def _bs_args(p: dict, cp: float, device) -> list[torch.Tensor]:
    return as_tensors(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"], cp,
                      p["dividend"], dtype=DEFAULT_DTYPE, device=device)


def _batch(p: dict, device) -> ContractBatch:
    return ContractBatch.make(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"],
                              p["option_type"], p["dividend"], device=device)


def handle_price(body: dict, device) -> dict:
    p, cp = _contract(body)
    model = body.get("model", "bs")
    if model != "bs":
        raise ValidationError(f"model {model!r} is not yet ported; available: ['bs']")
    return {"model": model, "price": _to_jsonable(bs_price(*_bs_args(p, cp, device)))}


def handle_greeks(body: dict, device) -> dict:
    p, cp = _contract(body)
    return {k: _to_jsonable(v) for k, v in bs_greeks(*_bs_args(p, cp, device)).items()}


def handle_mc(body: dict, device) -> dict:
    p, _ = _contract(body)
    n_paths = int(body.get("n_paths", 1_000_000))
    seed = int(body.get("seed", 0))
    batch = _batch(p, device)
    method = body.get("method", "pallas")
    if method == "pallas":
        out = gbm_mc_price_greeks(batch, n_paths=n_paths, seed=seed)
        return {k: _to_jsonable(v) for k, v in out.items()}
    if method != "xla":
        raise ValidationError(f"unknown method {method!r}; available: ['pallas', 'xla']")
    cfg = MCConfig(n_paths=n_paths)
    gen = torch.Generator(device=device)
    res = mc_price_result(batch, gen.manual_seed(seed), cfg)
    g = mc_greeks(batch, gen.manual_seed(seed), cfg)
    return {"price": _to_jsonable(res.price), "std_error": _to_jsonable(res.std_error),
            **{k: _to_jsonable(v) for k, v in g.items() if k != "price"}}


ROUTES = {
    "/price": handle_price,
    "/greeks": handle_greeks,
    "/mc": handle_mc,
    "/batch/price": handle_price,  # same handler — fields may be lists
}


def _health(device: torch.device) -> dict:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"status": "ok", "device": str(device), "device_name": name,
            "device_count": count}


def _metrics() -> dict:
    out = {}
    for label, ms in get_timings().items():
        if not label.startswith("http:"):
            continue
        s = sorted(ms)
        n = len(s)
        out[label[5:]] = {
            "count": n,
            "p50_ms": round(s[n // 2], 3),
            "p95_ms": round(s[min(n - 1, int(0.95 * n))], 3),
            "max_ms": round(s[-1], 3),
        }
    return out


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _unknown(self):
        self._send(404, {"error": f"unknown path {self.path}",
                         "endpoints": sorted(ROUTES) + ["/health", "/metrics"]})

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._send(200, _health(self.server.device))
        elif self.path == "/metrics":
            self._send(200, _metrics())
        else:
            self._unknown()

    def do_POST(self):  # noqa: N802
        handler = ROUTES.get(self.path)
        if handler is None:
            self._unknown()
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            with Timer(f"http:{self.path}"):
                payload = handler(body, self.server.device)
        except (ValueError, KeyError, TypeError) as e:  # bad input (ValidationError too)
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        except Exception as e:  # keep serving; the traceback goes to the log
            logger.exception("request to %s failed", self.path)
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, payload)

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)


class PricingServer:
    """Embeddable server: ``PricingServer(port, device=...).start()`` /
    ``.stop()``. ``port=0`` picks a free port (read it from ``.port``)."""

    def __init__(self, port: int = 8777, host: str = "127.0.0.1", warm: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.device = self.device
        self.port = self.httpd.server_address[1]
        self._thread = None
        if warm:
            self.warmup()

    def warmup(self):
        """Run the closed-form routes once on the device before serving."""
        handle_price({"model": "bs"}, self.device)
        handle_greeks({}, self.device)

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("pricing server on port %d (%s)", self.port, self.device)
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self):  # pragma: no cover - blocking entry
        logger.info("pricing server on port %d (%s, blocking)", self.port, self.device)
        self.httpd.serve_forever()


def main(argv=None):  # pragma: no cover - CLI entry
    ap = argparse.ArgumentParser(description="optionslab_tpu_torch pricing server")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    PricingServer(args.port, args.host, device=args.device).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
