"""Options portfolio: positions, aggregate Greeks, scenario P&L grids.

The port of ``optionslab_tpu/risk/portfolio.py``: ``Position`` (quantity
and contract, an optional functional pricer), aggregate Greeks (NaN
tolerant), per-underlying attribution, the position report, the spot × vol
scenario P&L grid, the delta-hedge ratio and vega maturity buckets.

The book's Black–Scholes positions get their full Greek ladders from one
autograd pass over one batched price (``greeks.greeks_from_fn``); a position
with its own ``price_fn`` is differentiated on its own. The scenario grid is
one broadcast revaluation over the (spot, vol) mesh. The book's tensors live
on ``device`` in ``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..greeks.unified import contractwise, greeks_from_fn
from ..models.black_scholes import bs_price
from ..utils.config import DEFAULT_DTYPE
from ..utils.exceptions import ValidationError
from ..utils.validation import check_option_type
from ._frames import report


@dataclasses.dataclass
class Position:
    quantity: float
    spot: float
    strike: float
    maturity: float
    rate: float
    vol: float
    option_type: str = "call"
    dividend: float = 0.0
    underlying: str = "UND"
    price_fn: Optional[object] = None  # functional pricer; default BS

    def cp(self) -> float:
        return float(check_option_type(self.option_type))


class OptionsPortfolio:
    def __init__(self, device="cuda", dtype=DEFAULT_DTYPE):
        self.positions: list[Position] = []
        self.device = device
        self.dtype = dtype

    def add_position(self, position: Position):
        if position.maturity < 0 or position.vol < 0:
            raise ValidationError("position maturity/vol must be non-negative")
        self.positions.append(position)

    def __len__(self):
        return len(self.positions)

    # -- batched greeks -----------------------------------------------------
    def _arrays(self):
        p = self.positions

        def t(values):
            return torch.tensor(values, dtype=self.dtype, device=self.device)

        return (t([x.spot for x in p]), t([x.strike for x in p]), t([x.maturity for x in p]),
                t([x.rate for x in p]), t([x.vol for x in p]), t([x.dividend for x in p]),
                t([x.cp() for x in p]), t([x.quantity for x in p]))

    def position_greeks(self) -> dict:
        """Per-position Greek ladders from one autograd pass (custom
        price_fn positions are evaluated individually)."""
        if not self.positions:
            raise ValidationError("portfolio is empty")
        s, k, t, r, sig, q, cp, qty = self._arrays()

        def fn(s_, k_, t_, r_, sig_, q_):
            return bs_price(s_, k_, t_, r_, sig_, cp, q_)

        g = greeks_from_fn(contractwise(fn), s, k, t, r, sig, q, second_order=True)
        for i, pos in enumerate(self.positions):
            if pos.price_fn is not None:
                gi = greeks_from_fn(pos.price_fn, *(torch.tensor(v, dtype=self.dtype,
                                                                 device=self.device)
                                                    for v in (pos.spot, pos.strike, pos.maturity,
                                                              pos.rate, pos.vol, pos.dividend)),
                                    second_order=True)
                for key in g:
                    g[key][i] = gi[key]
        return g

    def aggregate_greeks(self) -> dict:
        """Quantity-weighted portfolio totals; NaN-tolerant like the
        reference."""
        g = self.position_greeks()
        qty = self._arrays()[-1]
        return {key: float(torch.nansum(qty * v)) for key, v in g.items()}

    def greeks_by_underlying(self) -> dict:
        """Per-underlying attribution."""
        g = self.position_greeks()
        qty = self._arrays()[-1].cpu().numpy()
        unds = [p.underlying for p in self.positions]
        out: dict = {}
        for key, v in g.items():
            arr = v.cpu().numpy() * qty
            per = {}
            for u, val in zip(unds, arr):
                per[u] = per.get(u, 0.0) + (0.0 if np.isnan(val) else float(val))
            out[key] = per
        return out

    def position_report(self):
        """The per-position report: a DataFrame when pandas is installed,
        else its list of row dicts."""
        g = {k: v.cpu().numpy() for k, v in self.position_greeks().items()}
        rows = []
        for i, p in enumerate(self.positions):
            rows.append({
                "underlying": p.underlying,
                "type": p.option_type,
                "quantity": p.quantity,
                "strike": p.strike,
                "maturity": p.maturity,
                "price": float(g["price"][i]),
                "delta": float(g["delta"][i]) * p.quantity,
                "gamma": float(g["gamma"][i]) * p.quantity,
                "vega": float(g["vega"][i]) * p.quantity,
                "theta": float(g["theta"][i]) * p.quantity,
                "value": float(g["price"][i]) * p.quantity,
            })
        return report(rows)

    # -- scenarios ----------------------------------------------------------
    def scenario_pnl(self, spot_shifts, vol_shifts) -> np.ndarray:
        """(n_spot, n_vol) P&L grid from one broadcast revaluation. Shifts
        are relative (e.g. ±0.1)."""
        s, k, t, r, sig, q, cp, qty = self._arrays()
        ds = torch.as_tensor(np.asarray(spot_shifts), dtype=self.dtype,
                             device=self.device)[:, None, None]
        dv = torch.as_tensor(np.asarray(vol_shifts), dtype=self.dtype,
                             device=self.device)[None, :, None]
        base = torch.sum(qty * bs_price(s, k, t, r, sig, cp, q))
        vals = bs_price(s[None, None, :] * (1.0 + ds), k, t, r, sig[None, None, :] * (1.0 + dv),
                        cp, q)
        return (torch.sum(qty * vals, dim=-1) - base).cpu().numpy()

    def delta_hedge_ratio(self) -> float:
        """Shares of underlying to neutralize book delta."""
        return -self.aggregate_greeks()["delta"]

    def vega_buckets(self, edges=(0.25, 0.5, 1.0, 2.0)) -> dict:
        """Vega aggregated into maturity buckets."""
        g = self.position_greeks()
        qty = self._arrays()[-1].cpu().numpy()
        mats = np.asarray([p.maturity for p in self.positions])
        vega = g["vega"].cpu().numpy() * qty
        edges = [0.0, *edges, np.inf]
        out = {}
        for lo, hi in zip(edges[:-1], edges[1:]):
            mask = (mats >= lo) & (mats < hi)
            label = f"[{lo:.2f}, {hi if np.isfinite(hi) else 'inf'})"
            out[label] = float(vega[mask].sum()) if mask.any() else 0.0
        return out
