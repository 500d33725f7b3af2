"""Pricers: the Black–Scholes closed form (the oracle) and Monte Carlo."""

from .black_scholes import BlackScholesPricer, bs_greeks, bs_greeks_ad, bs_price, bs_vega
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
