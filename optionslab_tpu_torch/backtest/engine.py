"""Delta-hedge backtesting engine.

The port of ``optionslab_tpu/backtest/engine.py``: sell an option,
delta-hedge it with stock at a daily or weekly rebalance, track daily and
cumulative P&L, settle at expiry; Sharpe ratio, max drawdown, win rate; the
realized-vs-implied vol comparison; yfinance history input (gated).

The reference scans the days with the hedge, cash and portfolio value as
its carry. Every carried quantity has a closed form over the whole series,
so the port runs no loop over days: one batched ``bs_greeks`` gives each
day's delta and option value (each depends only on that day's price and
time to maturity); the hedge is the delta of the last rebalance day,
``H_i = delta[k·⌊i/k⌋]``; the trade ``H_i − H_{i−1}`` is zero off the
rebalance days; and the cash follows the linear recurrence
``cash_i = g·(cash_{i−1} − c_i)`` with ``g = e^{r·dt}`` and ``c_i`` the
trade's cost with ``tx_cost``, whose solution is
``cash_i = g^i·(cash_0 − Σ_{j≤i} g^{1−j}·c_j)``: a cumulative sum. The
whole engine runs in float64 (the reference in float32), so a backtest
launches the same kernels whatever the series' length, and a sweep over
strikes × sigmas is the same call with a leading batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data._table import ColumnTable, to_frame
from ..models.black_scholes import bs_greeks
from ..utils.config import YFINANCE_AVAILABLE
from ..utils.exceptions import DataError, DependencyError, ValidationError

__all__ = ["BacktestEngine", "BacktestResult", "realized_vol", "realized_vs_implied",
           "run_delta_hedge_backtest"]


@dataclasses.dataclass
class BacktestResult:
    daily_pnl: np.ndarray
    cumulative_pnl: np.ndarray
    total_pnl: float
    sharpe: float
    max_drawdown: float
    win_rate: float
    option_premium: float
    final_settlement: float
    n_rebalances: int

    def summary(self) -> dict:
        return {
            "total_pnl": self.total_pnl,
            "sharpe": self.sharpe,
            "max_drawdown": self.max_drawdown,
            "win_rate": self.win_rate,
            "option_premium": self.option_premium,
            "final_settlement": self.final_settlement,
            "n_rebalances": self.n_rebalances,
        }


def _delta_hedge(prices: torch.Tensor, strike: torch.Tensor, rate: float, sigma: torch.Tensor,
                 maturity: float, cp: float, rebalance_every: int = 1, tx_cost: float = 0.0):
    """Short option + delta hedge over the price path ``prices`` (n,), for a
    batch of (strike, sigma) of one shape B: day 0 sells the option at its
    BS value and buys delta shares, each rebalance day adjusts the hedge,
    the last day settles intrinsic. Returns (daily P&L (B..., n − 1),
    premium (B...), settlement)."""
    n = prices.shape[0]
    dt = maturity / (n - 1)
    days = torch.arange(n, dtype=prices.dtype, device=prices.device)
    ttm = torch.clamp_min(maturity - days * dt, 1e-6)
    g = bs_greeks(prices, strike[..., None], ttm, rate, sigma[..., None], cp, 0.0)
    delta, value = g["delta"], g["price"]
    prem = value[..., 0]
    hedge = delta[..., (torch.arange(n, device=prices.device) // rebalance_every)
                  * rebalance_every]
    traded = torch.diff(hedge, dim=-1)
    cost = traded * prices[1:] + traded.abs() * prices[1:] * tx_cost
    cash0 = prem - delta[..., 0] * prices[0] - delta[..., 0].abs() * prices[0] * tx_cost
    growth = torch.exp(rate * dt * days[1:])  # g^j, j = 1..n-1
    cash = growth * (cash0[..., None] - torch.cumsum(cost * (growth[0] / growth), dim=-1))
    cash = torch.cat([cash0[..., None], cash], dim=-1)
    port = hedge * prices + cash - value
    settle = torch.clamp_min(cp * (prices[-1] - strike), 0.0)
    return torch.diff(port, dim=-1), prem, settle


class BacktestEngine:
    """Delta-hedge backtests on historical (or synthetic) price series, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, rate: float = 0.03, tx_cost: float = 0.0, device="cuda"):
        self.rate = rate
        self.tx_cost = tx_cost
        self.device = torch.device(device)

    # -- data ---------------------------------------------------------------
    @staticmethod
    def fetch_history(ticker: str, period: str = "1y"):
        """yfinance close series (network-gated; offline users pass arrays
        directly to run_delta_hedge)."""
        if not YFINANCE_AVAILABLE:
            raise DependencyError(
                "yfinance is not installed; pass a price array instead")
        import yfinance as yf  # pragma: no cover

        return yf.Ticker(ticker).history(period=period)["Close"].to_numpy()

    def _prices(self, prices) -> torch.Tensor:
        if isinstance(prices, torch.Tensor):
            prices = prices.detach().cpu().numpy()
        return torch.as_tensor(np.asarray(prices, np.float64), device=self.device)

    # -- core ---------------------------------------------------------------
    def run_delta_hedge(self, prices, strike=None, maturity=None, sigma=None,
                        option_type: str = "call", rebalance_every: int = 1) -> BacktestResult:
        host = np.asarray(prices.detach().cpu() if isinstance(prices, torch.Tensor) else prices,
                          np.float64)
        if host.ndim != 1 or host.size < 10:
            raise DataError("need a 1-D price series with >= 10 observations")
        if np.any(~np.isfinite(host)) or np.any(host <= 0):
            raise DataError("prices must be positive and finite")
        strike = float(strike if strike is not None else host[0])
        maturity = float(maturity if maturity is not None else (host.size - 1) / 252.0)
        if sigma is None:
            sigma = float(realized_vol(host).mean())
        cp = 1.0 if option_type == "call" else -1.0
        if maturity <= 0:
            raise ValidationError("maturity must be positive")

        p = self._prices(host)
        daily, prem, settle = _delta_hedge(
            p, torch.tensor(strike, dtype=p.dtype, device=p.device), self.rate,
            torch.tensor(float(sigma), dtype=p.dtype, device=p.device), maturity, cp,
            rebalance_every=rebalance_every, tx_cost=self.tx_cost)
        daily = daily.cpu().numpy()
        cum = np.cumsum(daily)
        std = daily.std(ddof=1)
        sharpe = float(daily.mean() / std * np.sqrt(252.0)) if std > 0 else 0.0
        peak = np.maximum.accumulate(cum)
        max_dd = float((peak - cum).max()) if cum.size else 0.0
        return BacktestResult(
            daily_pnl=daily,
            cumulative_pnl=cum,
            total_pnl=float(cum[-1]),
            sharpe=sharpe,
            max_drawdown=max_dd,
            win_rate=float((daily > 0).mean()),
            option_premium=float(prem),
            final_settlement=float(settle),
            n_rebalances=int(np.ceil((host.size - 1) / rebalance_every)),
        )

    def run_delta_hedge_sweep(self, prices, strikes, sigmas, maturity, option_type="call"):
        """Parameter sweep as one batched call: the (n_strikes, n_sigmas)
        total P&L grid, daily rebalance and no transaction cost, as the
        reference's."""
        p = self._prices(prices)
        cp = 1.0 if option_type == "call" else -1.0
        k = torch.as_tensor(np.asarray(strikes, np.float64), device=p.device)
        s = torch.as_tensor(np.asarray(sigmas, np.float64), device=p.device)
        daily, _, _ = _delta_hedge(p, k[:, None], self.rate, s[None, :], float(maturity), cp)
        return daily.sum(dim=-1).cpu().numpy()


def realized_vol(prices, window: int = 20) -> np.ndarray:
    """Annualized rolling realized vol (reference: ``:267-293``)."""
    prices = np.asarray(prices, np.float64)
    rets = np.diff(np.log(prices))
    out = np.full(rets.size, np.nan)
    if rets.size >= window:
        out[window - 1:] = (np.lib.stride_tricks.sliding_window_view(rets, window)
                            .std(axis=1, ddof=1) * np.sqrt(252.0))
    # fill leading window with first valid estimate
    first = out[window - 1] if rets.size >= window else rets.std(ddof=1) * np.sqrt(252.0)
    out[: window - 1] = first
    return out


def realized_vs_implied(prices, implied_vol: float, window: int = 20):
    """Rolling realized vol beside a quoted implied vol: a pandas DataFrame
    where pandas is installed, else the column table."""
    rv = realized_vol(prices, window)
    return to_frame(ColumnTable({
        "realized_vol": rv,
        "implied_vol": float(implied_vol),
        "spread": implied_vol - rv,
    }))


def run_delta_hedge_backtest(prices, strike=None, maturity=None, sigma=None,
                             option_type="call", rate=0.03, rebalance_every=1,
                             tx_cost=0.0, device="cuda") -> BacktestResult:
    """Module-level convenience (reference: ``backtest_engine.py:296``)."""
    return BacktestEngine(rate=rate, tx_cost=tx_cost, device=device).run_delta_hedge(
        prices, strike, maturity, sigma, option_type, rebalance_every)
