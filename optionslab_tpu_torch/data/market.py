"""Live market data: TTL cache, rate limiting, retry with backoff.

The port of ``optionslab_tpu/data/market.py``:
  - a TTL cache (300 s default), 500 ms rate limiting and retry with
    exponential backoff and a failure counter, each with an injectable clock
    and sleep;
  - :class:`MarketDataClient`: quote / chain / expiries / risk-free-rate
    fetchers behind the cache (and a parquet disk cache), which raise
    ``DependencyError`` when yfinance is not installed;
  - :func:`calibrate_model_to_market`: Adam on a user objective with box
    bounds by clipping.
"""

from __future__ import annotations

import functools
import pathlib
import time
from typing import Callable

import numpy as np

from ..utils.config import YFINANCE_AVAILABLE
from ..utils.exceptions import DataError, DependencyError
from ..utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_TTL_SECONDS = 300.0
DEFAULT_MIN_INTERVAL = 0.5


class TTLCache:
    """Time-to-live cache (reference: ``market_data.py:35-58``)."""

    def __init__(self, ttl: float = DEFAULT_TTL_SECONDS, clock: Callable = time.monotonic):
        self.ttl = ttl
        self._clock = clock
        self._store: dict = {}

    def get(self, key):
        hit = self._store.get(key)
        if hit is None:
            return None
        value, stamp = hit
        if self._clock() - stamp > self.ttl:
            del self._store[key]
            return None
        return value

    def put(self, key, value):
        self._store[key] = (value, self._clock())

    def clear(self):
        self._store.clear()

    def __len__(self):
        return len(self._store)


class RateLimiter:
    """Minimum interval between calls (reference: ``market_data.py:73``)."""

    def __init__(self, min_interval: float = DEFAULT_MIN_INTERVAL,
                 clock: Callable = time.monotonic, sleep: Callable = time.sleep):
        self.min_interval = min_interval
        self._clock = clock
        self._sleep = sleep
        self._last = -float("inf")

    def wait(self):
        now = self._clock()
        delta = now - self._last
        if delta < self.min_interval:
            self._sleep(self.min_interval - delta)
        self._last = self._clock()


def retry_with_backoff(fn: Callable = None, *, retries: int = 3, base_delay: float = 0.5,
                       max_delay: float = 8.0, sleep: Callable = time.sleep,
                       exceptions=(Exception,)):
    """Exponential-backoff retry decorator with a failure counter
    (reference: ``safe_yfinance_call``, ``market_data.py:102``)."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            delay = base_delay
            failures = 0
            while True:
                try:
                    return f(*args, **kwargs)
                except exceptions as e:
                    failures += 1
                    wrapper.failure_count += 1
                    if failures > retries:
                        raise DataError(
                            f"{f.__name__} failed after {retries} retries: {e}") from e
                    logger.warning("%s failed (%s); retrying in %.1fs",
                                   f.__name__, e, delay)
                    sleep(delay)
                    delay = min(delay * 2.0, max_delay)

        wrapper.failure_count = 0
        return wrapper

    return deco(fn) if fn is not None else deco


class MarketDataClient:
    """Cached, rate-limited, retrying fetcher façade. All network fetchers
    are yfinance-gated; cache/limiter work with any injected fetch fn."""

    def __init__(self, ttl: float = DEFAULT_TTL_SECONDS,
                 min_interval: float = DEFAULT_MIN_INTERVAL,
                 cache_dir: str | None = None):
        self.cache = TTLCache(ttl)
        self.limiter = RateLimiter(min_interval)
        self.cache_dir = pathlib.Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def fetch(self, key, fetch_fn: Callable):
        """Generic cached fetch: memory TTL cache → parquet disk cache →
        rate-limited network call."""
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        if self.cache_dir:
            path = self.cache_dir / f"{key}.parquet"
            if path.exists():
                import pandas as pd

                value = pd.read_parquet(path)
                self.cache.put(key, value)
                return value
        self.limiter.wait()
        value = retry_with_backoff(fetch_fn)()
        self.cache.put(key, value)
        if self.cache_dir is not None and hasattr(value, "to_parquet"):
            value.to_parquet(self.cache_dir / f"{key}.parquet")
        return value

    # -- yfinance-backed fetchers (network) ---------------------------------
    def _require_yf(self):
        if not YFINANCE_AVAILABLE:
            raise DependencyError("yfinance is not installed in this environment")
        import yfinance  # pragma: no cover

        return yfinance

    def get_quote(self, ticker: str):  # pragma: no cover - network
        yf = self._require_yf()
        return self.fetch(f"quote_{ticker}",
                          lambda: yf.Ticker(ticker).history(period="1d"))

    def get_expiries(self, ticker: str):  # pragma: no cover - network
        yf = self._require_yf()
        return self.fetch(f"expiries_{ticker}", lambda: yf.Ticker(ticker).options)

    def get_option_chain(self, ticker: str, expiry: str):  # pragma: no cover - network
        yf = self._require_yf()

        def _get():
            chain = yf.Ticker(ticker).option_chain(expiry)
            import pandas as pd

            calls = chain.calls.assign(option_type="call")
            puts = chain.puts.assign(option_type="put")
            return pd.concat([calls, puts], ignore_index=True)

        return self.fetch(f"chain_{ticker}_{expiry}", _get)

    def get_risk_free_rate(self) -> float:  # pragma: no cover - network
        """13-week T-bill yield from ^IRX (reference:
        ``src/utils/market_data.py:205``)."""
        yf = self._require_yf()
        hist = self.fetch("irx", lambda: yf.Ticker("^IRX").history(period="5d"))
        return float(hist["Close"].iloc[-1]) / 100.0


def fetch_option_chain(ticker: str, expiry: str | None = None):  # pragma: no cover
    client = MarketDataClient()
    if expiry is None:
        expiry = client.get_expiries(ticker)[0]
    return client.get_option_chain(ticker, expiry)


def calibrate_model_to_market(objective_fn, x0, bounds=None, n_steps: int = 300,
                              learning_rate: float = 0.05, device=None):
    """Generic market-calibration wrapper: plain Adam (no gradient clip) on a
    differentiable torch objective of a float32 vector, each iterate clipped
    into the box ``bounds = (lo, hi)``, on ``x0``'s device (``device``, by
    default the card, for numbers and arrays). Returns (best x as numpy, its
    objective): the iterate whose loss is reported (the reference pairs the
    iterate after that step's update with the loss before it)."""
    import torch

    from ..ops.optim import _adam_loop
    from ..utils.config import input_device

    if device is None:
        device = input_device(x0)
    x = torch.as_tensor(x0, dtype=torch.float32, device=device)
    project = None
    if bounds is not None:
        lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=device) for b in bounds)

        def project(xb):
            return torch.clamp(xb, lo, hi)

    best_x, best, _ = _adam_loop(lambda xb: objective_fn(xb[0]).reshape(1), x[None], n_steps,
                                 learning_rate, None, project)
    return best_x[0].cpu().numpy(), float(best[0])
