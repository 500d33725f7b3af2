"""Pricers: the Black–Scholes closed form (the oracle), Monte Carlo, the GBM
exotics (closed forms, scan engine, kernel façade) and contract books."""

from .black_scholes import BlackScholesPricer, bs_greeks, bs_greeks_ad, bs_price, bs_vega
from .books import exotic_book_quote, facade_kernel_kind
from .exotics import (
    AsianOption,
    AutocallableNote,
    BarrierOption,
    CliquetOption,
    LookbackOption,
    double_barrier_closed_form,
    double_no_touch_closed_form,
    geometric_asian_closed_form,
    one_touch_closed_form,
    range_accrual_closed_form,
)
from .monte_carlo import (
    MCConfig,
    MCMethod,
    MCResult,
    MonteCarloPricer,
    gbm_paths,
    gbm_terminal,
    mc_greeks,
    mc_price,
    mc_price_control_variate,
    mc_price_result,
)

__all__ = [
    "AsianOption",
    "AutocallableNote",
    "BarrierOption",
    "CliquetOption",
    "LookbackOption",
    "double_barrier_closed_form",
    "double_no_touch_closed_form",
    "exotic_book_quote",
    "facade_kernel_kind",
    "geometric_asian_closed_form",
    "one_touch_closed_form",
    "range_accrual_closed_form",
    "BlackScholesPricer",
    "bs_greeks",
    "bs_greeks_ad",
    "bs_price",
    "bs_vega",
    "MCConfig",
    "MCMethod",
    "MCResult",
    "MonteCarloPricer",
    "gbm_paths",
    "gbm_terminal",
    "mc_greeks",
    "mc_price",
    "mc_price_control_variate",
    "mc_price_result",
]
