"""Option-chain loading, standardization, filtering, and model-input prep.

The port of ``optionslab_tpu/data/loader.py``, without pandas on its path:

* :class:`OptionChainDataset` takes any frame-like chain (a pandas
  DataFrame, a column table, or a mapping of column name to 1-D array) and
  holds it as one column table of numpy arrays (``data/_table.py``); ``.df``
  is a pandas DataFrame where pandas is installed and the table otherwise.
  Column standardization across vendor formats, liquidity and moneyness
  filters, log-moneyness and the 7-feature model input are host numpy; the
  IV backfill inverts every missing row in ONE ``models.iv.implied_vol``
  call, float64, on the chain's device (default the card).
* The CBOE ``quotedata`` and OptionMetrics ``opprcd`` parsers read their
  files with ``csv`` and their dates with ``datetime``; time to maturity is
  whole calendar days / 365. Parquet needs pandas (``DependencyError``
  without it); yfinance raises ``DependencyError`` when it is absent.
"""

from __future__ import annotations

import csv
import datetime as _dt

import numpy as np
import torch

from ..models.iv import implied_vol
from ..surface.features import engineer_features
from ..utils.config import YFINANCE_AVAILABLE
from ..utils.exceptions import DataError, DependencyError
from ..utils.validation import check_required_columns
from ._table import ColumnTable, as_table, to_frame

# vendor column name → canonical name
COLUMN_ALIASES = {
    "spot": "underlying_price",
    "underlying": "underlying_price",
    "underlyingprice": "underlying_price",
    "stock_price": "underlying_price",
    "s": "underlying_price",
    "strike": "strike_price",
    "k": "strike_price",
    "ttm": "time_to_maturity",
    "maturity": "time_to_maturity",
    "t": "time_to_maturity",
    "tau": "time_to_maturity",
    "rate": "risk_free_rate",
    "r": "risk_free_rate",
    "iv": "implied_volatility",
    "impliedvolatility": "implied_volatility",
    "impl_volatility": "implied_volatility",
    "vol": "implied_volatility",
    "hist_vol": "historical_volatility",
    "hv": "historical_volatility",
    "type": "option_type",
    "cp_flag": "option_type",
    "right": "option_type",
    "price": "option_price",
    "mid": "option_price",
    "lastprice": "option_price",
    "volume": "volume",
    "openinterest": "open_interest",
    "open_int": "open_interest",
}

REQUIRED = ["underlying_price", "strike_price", "time_to_maturity", "risk_free_rate"]


def _option_types(col) -> np.ndarray:
    """'call'/'put' from the first letter of each entry, NaN otherwise."""
    names = {"c": "call", "p": "put"}
    return np.array([names.get(str(v).lower()[:1], np.nan) for v in np.asarray(col)],
                    dtype=object)


def standardize_columns(df):
    """Lower/snake-case names, map vendor aliases to canonical columns.
    Returns the frame type the data layer returns (``.df``'s rule)."""
    return to_frame(_standardize(as_table(df)))


def _standardize(table: ColumnTable) -> ColumnTable:
    renames = {}
    for col in table.columns:
        key = str(col).strip().lower().replace(" ", "_")
        renames[col] = COLUMN_ALIASES.get(key, COLUMN_ALIASES.get(key.replace("_", ""), key))
    out = table.rename(renames)
    if "option_type" in out:
        out["option_type"] = _option_types(out["option_type"])
    return out


class OptionChainDataset:
    """A standardized chain with filter / backfill / feature-prep methods.

    ``df`` is any frame-like chain; the backfill runs on ``device``."""

    def __init__(self, df, device="cuda"):
        self.table = _standardize(as_table(df))
        self.device = torch.device(device)
        check_required_columns(self.table, REQUIRED)

    @property
    def df(self):
        """The chain as a pandas DataFrame, or as the column table when
        pandas is not installed."""
        return to_frame(self.table)

    def __len__(self):
        return len(self.table)

    def _with(self, table: ColumnTable) -> "OptionChainDataset":
        return OptionChainDataset(table, self.device)

    # -- filters --------------------------------------------------------------
    def filter_liquidity(self, min_volume: int = 0, min_open_interest: int = 0,
                         max_spread_pct: float | None = None) -> "OptionChainDataset":
        t = self.table
        if min_volume and "volume" in t:
            t = t.take(np.asarray(t["volume"], np.float64) >= min_volume)
        if min_open_interest and "open_interest" in t:
            t = t.take(np.asarray(t["open_interest"], np.float64) >= min_open_interest)
        if max_spread_pct is not None and {"bid", "ask"} <= set(t.columns):
            bid = np.asarray(t["bid"], np.float64)
            ask = np.asarray(t["ask"], np.float64)
            mid = (bid + ask) / 2
            spread = (ask - bid) / np.maximum(mid, 1e-12)
            t = t.take(spread <= max_spread_pct)
        return self._with(t)

    def filter_moneyness(self, lo: float = 0.7, hi: float = 1.3) -> "OptionChainDataset":
        m = (np.asarray(self.table["underlying_price"], np.float64)
             / np.asarray(self.table["strike_price"], np.float64))
        return self._with(self.table.take((m >= lo) & (m <= hi)))

    def filter_maturity(self, min_ttm: float = 0.01, max_ttm: float = 3.0) -> "OptionChainDataset":
        t = np.asarray(self.table["time_to_maturity"], np.float64)
        return self._with(self.table.take((t >= min_ttm) & (t <= max_ttm)))

    # -- enrichment ---------------------------------------------------------
    def backfill_implied_vol(self, drop_failed: bool = True,
                             device=None) -> "OptionChainDataset":
        """Invert option_price → implied_volatility for rows missing IV: the
        whole chain in ONE vectorized Newton call (``models.iv.implied_vol``),
        float64, on ``device`` (default the chain's)."""
        t = self.table.copy()
        if "option_price" not in t:
            raise DataError("backfill_implied_vol needs an option_price column")
        need = (np.isnan(np.asarray(t["implied_volatility"], np.float64))
                if "implied_volatility" in t else np.ones(len(t), dtype=bool))
        if need.any():
            dev = torch.device(device) if device is not None else self.device
            sub = t.take(need)
            types = sub.get("option_type")
            cp = (np.ones(len(sub)) if types is None else
                  np.where(np.char.startswith(np.asarray(types).astype(str), "c"), 1.0, -1.0))
            div = sub["dividend_yield"] if "dividend_yield" in sub else 0.0

            def f64(x):
                return torch.as_tensor(np.asarray(x, np.float64), device=dev)

            iv = implied_vol(f64(sub["option_price"]), f64(sub["underlying_price"]),
                             f64(sub["strike_price"]), f64(sub["time_to_maturity"]),
                             f64(sub["risk_free_rate"]), f64(cp), f64(div)).cpu().numpy()
            col = (np.asarray(t["implied_volatility"], np.float64).copy()
                   if "implied_volatility" in t else np.full(len(t), np.nan))
            col[need] = iv
            t["implied_volatility"] = col
        if drop_failed:
            t = t.take(np.isfinite(np.asarray(t["implied_volatility"], np.float64)))
        return self._with(t)

    def with_log_moneyness(self) -> "OptionChainDataset":
        t = self.table.copy()
        t["log_moneyness"] = np.log(np.asarray(t["underlying_price"], np.float64)
                                    / np.asarray(t["strike_price"], np.float64))
        return self._with(t)

    def to_model_input(self):
        """The 7-feature frame for the surface models (``.df``'s type)."""
        t = self.table.copy()
        if "historical_volatility" not in t:
            t["historical_volatility"] = t.get("implied_volatility", 0.2)
        return to_frame(engineer_features(t))


# ---------------------------------------------------------------------------
# Vendor files
# ---------------------------------------------------------------------------
_DATE_FORMATS = ("%Y%m%d", "%Y-%m-%d", "%Y/%m/%d", "%m/%d/%Y", "%b %d %Y", "%a %b %d %Y",
                 "%B %d %Y", "%A %B %d %Y", "%b %d, %Y", "%B %d, %Y", "%d-%b-%Y",
                 "%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M")


def _parse_date(value) -> _dt.datetime:
    """A date-like value (YYYYMMDD, ISO, US and month-name spellings, a
    ``date``/``datetime`` or ``numpy.datetime64``) as a ``datetime``."""
    if isinstance(value, _dt.datetime):
        return value
    if isinstance(value, _dt.date):
        return _dt.datetime(value.year, value.month, value.day)
    if isinstance(value, np.datetime64):
        return value.astype("datetime64[us]").astype(_dt.datetime)
    if hasattr(value, "to_pydatetime"):  # a pandas Timestamp
        return value.to_pydatetime()
    text = " ".join(str(value).strip().split())
    for fmt in _DATE_FORMATS:
        try:
            return _dt.datetime.strptime(text, fmt)
        except ValueError:
            pass
    try:
        return _dt.datetime.fromisoformat(text)
    except ValueError:
        raise ValueError(f"unparsable date {value!r}") from None


def _ttm_years(dates, exdates) -> np.ndarray:
    """Calendar-day year fractions between two date-like columns (YYYYMMDD
    ints or strings and ISO or US strings: both real-vendor conventions)."""
    d0 = [_parse_date(v) for v in np.asarray(dates, dtype=object)]
    d1 = [_parse_date(v) for v in np.asarray(exdates, dtype=object)]
    return np.array([(b - a).days for a, b in zip(d0, d1)], np.float64) / 365.0


def _to_numeric(values) -> np.ndarray:
    """Numbers of a text column, NaN where one does not parse; int64 when
    every entry is an integer (as pandas reads it)."""
    vals = np.asarray(values, dtype=object)
    try:
        return np.array([int(str(v).strip()) for v in vals], np.int64)
    except ValueError:
        pass
    out = np.empty(len(vals), np.float64)
    for i, v in enumerate(vals):
        try:
            out[i] = float(str(v).strip())
        except ValueError:
            out[i] = np.nan
    return out


def _read_csv(lines) -> ColumnTable:
    """A table of a CSV body: header names de-duplicated as pandas does
    (the second ``x`` becomes ``x.1``), numeric columns parsed."""
    rows = [r for r in csv.reader(lines) if r]
    if not rows:
        raise DataError("empty CSV body")
    header, body = rows[0], rows[1:]
    seen: dict = {}
    names = []
    for h in header:
        name = h
        if h in seen:
            seen[h] += 1
            name = f"{h}.{seen[h]}"
        else:
            seen[h] = 0
        names.append(name)
    cols = {}
    for j, name in enumerate(names):
        raw = np.array([r[j] if j < len(r) else "" for r in body], dtype=object)
        num = _to_numeric(raw)
        text_left = num.dtype.kind == "f" and np.isnan(num).all() and any(
            str(v).strip() for v in raw)
        cols[name] = raw if text_left else num
    return ColumnTable(cols)


def parse_optionmetrics(df, spot=None, rate: float = 0.0):
    """Standardize an OptionMetrics ``opprcd``-style frame (real conventions:
    ``strike_price`` ×1000, ``cp_flag`` C/P, ``best_bid``/``best_offer``,
    ``date``/``exdate`` as YYYYMMDD, ``impl_volatility``). ``spot`` comes from
    the security file in the real product, so it is a parameter here (scalar
    or per-row array); likewise ``rate``. Returns a canonical-columns frame
    (``.df``'s rule) for :class:`OptionChainDataset`."""
    return to_frame(_parse_optionmetrics(as_table(df), spot, rate))


def _parse_optionmetrics(t: ColumnTable, spot, rate) -> ColumnTable:
    out = ColumnTable()
    # opprcd ALWAYS stores strikes in thousandths of a dollar
    out["strike_price"] = np.asarray(t["strike_price"], np.float64) / 1000.0
    out["option_type"] = np.array(
        [{"C": "call", "P": "put"}.get(str(v).upper()[:1], np.nan) for v in t["cp_flag"]],
        dtype=object)
    bid = np.asarray(t["best_bid"], np.float64)
    ask = np.asarray(t["best_offer"], np.float64)
    out["bid"], out["ask"] = bid, ask
    out["option_price"] = 0.5 * (bid + ask)
    out["time_to_maturity"] = _ttm_years(t["date"], t["exdate"])
    if "impl_volatility" in t:
        out["implied_volatility"] = np.asarray(t["impl_volatility"], np.float64)
    for c in ("volume", "open_interest"):
        if c in t:
            out[c] = t[c]
    if spot is None:
        raise DataError("OptionMetrics option files carry no underlying "
                        "price; pass spot= (from the security file)")
    out["underlying_price"] = np.broadcast_to(np.asarray(spot, np.float64), (len(out),))
    out["risk_free_rate"] = float(rate)
    return out


def parse_cboe_quotedata(path, rate: float = 0.0, as_of=None):
    """Parse a CBOE ``quotedata``-style CSV: two header lines (underlying
    description + last price, then the retrieval timestamp) followed by
    side-by-side calls/puts rows sharing an expiration and strike. Real
    layout: ``Expiration Date,Calls,Last Sale,Net,Bid,Ask,Volume,IV,
    Delta,Gamma,Open Interest,Strike,Puts,...(same 10 for puts)``.
    Returns a LONG-format canonical frame (one row per option; ``.df``'s
    rule)."""
    return to_frame(_parse_cboe(path, rate, as_of))


def _parse_cboe(path, rate, as_of) -> ColumnTable:
    with open(path, newline="") as f:
        header1 = f.readline()
        header2 = f.readline()  # retrieval timestamp, e.g. "Apr 17 2026 @ 15:45 ET"
        body = _read_csv(f)
    # "SPX (S&P 500 INDEX),5123.41,+12.3": the last price is field 2
    try:
        spot = float(header1.split(",")[1])
    except (IndexError, ValueError) as e:
        raise DataError(f"cannot parse underlying price from CBOE header {header1!r}") from e
    if as_of is None:
        try:
            as_of = _parse_date(header2.split("@")[0].strip())
        except (ValueError, IndexError) as e:
            # never "now": a stale file would get every TTM from the parse-time clock
            raise DataError(
                f"cannot parse the as-of date from CBOE header line 2 {header2!r}; "
                "pass as_of= explicitly") from e
    else:
        as_of = _parse_date(as_of)
    body = body.rename({c: str(c).strip().lower().replace(" ", "_") for c in body.columns})
    ttm = _ttm_years([as_of] * len(body), body["expiration_date"])
    col_map = {"last_sale": "last", "bid": "bid", "ask": "ask", "volume": "volume",
               "iv": "implied_volatility", "open_interest": "open_interest"}
    strike = _to_numeric(body["strike"]).astype(np.float64)
    parts = []
    for side, suffix in (("call", ""), ("put", ".1")):
        part = ColumnTable({"strike_price": strike, "time_to_maturity": ttm,
                            "option_type": np.full(len(body), side, dtype=object)})
        for src, dst in col_map.items():
            if src + suffix in body:
                part[dst] = _to_numeric(body[src + suffix])
        part["option_price"] = 0.5 * (np.asarray(part["bid"], np.float64)
                                      + np.asarray(part["ask"], np.float64))
        parts.append(part)
    out = ColumnTable({c: np.concatenate([p[c] for p in parts]) for c in parts[0].columns})
    out["underlying_price"] = spot
    out["risk_free_rate"] = float(rate)
    return out


def _csv_table(path, read_kwargs: dict) -> ColumnTable:
    """A CSV file as a table; with reader options, through pandas'
    ``read_csv`` (which then must be installed)."""
    if read_kwargs:
        try:
            import pandas as pd
        except ImportError as e:
            raise DependencyError("read_csv options need pandas") from e
        return as_table(pd.read_csv(path, **read_kwargs))
    with open(path, newline="") as f:
        return _read_csv(f)


class OptionChainLoader:
    """Loaders returning an :class:`OptionChainDataset` on ``device``."""

    @staticmethod
    def from_csv(path, device="cuda", **read_kwargs) -> OptionChainDataset:
        return OptionChainDataset(_csv_table(path, read_kwargs), device)

    @staticmethod
    def from_optionmetrics(path, spot=None, rate: float = 0.0, device="cuda",
                           **read_kwargs) -> OptionChainDataset:
        return OptionChainDataset(_parse_optionmetrics(_csv_table(path, read_kwargs), spot,
                                                       rate), device)

    @staticmethod
    def from_cboe(path, rate: float = 0.0, as_of=None, device="cuda") -> OptionChainDataset:
        return OptionChainDataset(_parse_cboe(path, rate, as_of), device)

    @staticmethod
    def from_parquet(path, device="cuda", **read_kwargs) -> OptionChainDataset:
        try:
            import pandas as pd
        except ImportError as e:
            raise DependencyError("parquet files need pandas; use from_csv, from_cboe, "
                                  "from_optionmetrics or from_synthetic") from e
        return OptionChainDataset(pd.read_parquet(path, **read_kwargs), device)

    @staticmethod
    def from_synthetic(n_rows: int = 500, spot: float = 100.0, seed: int = 0, device="cuda",
                       **kwargs) -> OptionChainDataset:
        from .synthetic import generate_synthetic_chain

        return OptionChainDataset(generate_synthetic_chain(n_rows=n_rows, spot=spot, seed=seed,
                                                           device=device, **kwargs), device)

    @staticmethod
    def from_yfinance(ticker: str, device="cuda", **kwargs) -> OptionChainDataset:
        if not YFINANCE_AVAILABLE:
            raise DependencyError(
                "yfinance is not installed; use from_csv/from_parquet/from_synthetic")
        from .market import fetch_option_chain  # pragma: no cover

        return OptionChainDataset(fetch_option_chain(ticker, **kwargs), device)


def load_option_data(source="synthetic", **kwargs) -> OptionChainDataset:
    """One-call loader: ``source`` is csv, parquet, synthetic, yfinance, cboe
    or optionmetrics; ``kwargs`` go to its loader (``device`` among them)."""
    loaders = {
        "csv": OptionChainLoader.from_csv,
        "parquet": OptionChainLoader.from_parquet,
        "synthetic": OptionChainLoader.from_synthetic,
        "yfinance": OptionChainLoader.from_yfinance,
        "cboe": OptionChainLoader.from_cboe,
        "optionmetrics": OptionChainLoader.from_optionmetrics,
    }
    if source not in loaders:
        raise DataError(f"unknown source {source!r}; choose {list(loaders)}")
    return loaders[source](**kwargs)
