"""Black–Scholes–Merton closed form: prices and the full Greek ladder.

The oracle for every Monte Carlo path of the port. Each Greek comes in two
flavours, closed form and ``torch.autograd`` of the price, and the tests hold
them to each other and to ``optionslab_tpu.models.black_scholes``.
``cp ∈ {+1,-1}`` makes call/put a data axis; the degenerate regions (T<=0,
sigma<=0) are selected with ``torch.where`` masks.
"""

from __future__ import annotations

import torch

from ..ops.math import d1_d2, norm_cdf, norm_pdf
from ..types import ContractBatch
from ..utils.config import EPS_TIME, EPS_VOL, as_tensors


def bs_price(spot, strike, maturity, rate, vol, cp=1.0, dividend=0.0):
    """European option price. ``cp``: +1 call, -1 put. Broadcasts all args.

    Degenerate cases: T<=0 → intrinsic; vol<=0 → discounted intrinsic on the
    forward (the deterministic limit).
    """
    spot, strike, maturity, rate, vol, cp, dividend = torch.broadcast_tensors(
        *as_tensors(spot, strike, maturity, rate, vol, cp, dividend))
    d1, d2 = d1_d2(spot, strike, maturity, rate, vol, dividend)
    df_r = torch.exp(-rate * maturity)
    df_q = torch.exp(-dividend * maturity)
    live = cp * (spot * df_q * norm_cdf(cp * d1) - strike * df_r * norm_cdf(cp * d2))

    expired = torch.clamp_min(cp * (spot - strike), 0.0)
    deterministic = torch.clamp_min(cp * (spot * df_q - strike * df_r), 0.0)

    out = torch.where(vol <= EPS_VOL, deterministic, live)
    return torch.where(maturity <= EPS_TIME, expired, out)


def bs_vega(spot, strike, maturity, rate, vol, dividend=0.0):
    """∂price/∂vol (same for calls and puts)."""
    spot, strike, maturity, rate, vol, dividend = torch.broadcast_tensors(
        *as_tensors(spot, strike, maturity, rate, vol, dividend))
    d1, _ = d1_d2(spot, strike, maturity, rate, vol, dividend)
    t = torch.clamp_min(maturity, EPS_TIME)
    vega = spot * torch.exp(-dividend * t) * norm_pdf(d1) * torch.sqrt(t)
    return torch.where((maturity <= EPS_TIME) | (vol <= EPS_VOL), 0.0, vega)


def bs_greeks(spot, strike, maturity, rate, vol, cp=1.0, dividend=0.0) -> dict:
    """Closed-form Greeks dict: price, delta, gamma, vega, theta, rho,
    dual_delta, and second-order vanna / charm / vomma / speed.

    Theta is ∂price/∂t (calendar time, = -∂price/∂T), rho is ∂price/∂r, vega
    per unit vol (not per 1%).
    """
    spot, strike, maturity, rate, vol, cp, dividend = torch.broadcast_tensors(
        *as_tensors(spot, strike, maturity, rate, vol, cp, dividend))
    t = torch.clamp_min(maturity, EPS_TIME)
    v = torch.clamp_min(vol, EPS_VOL)
    sqrt_t = torch.sqrt(t)
    d1, d2 = d1_d2(spot, strike, maturity, rate, vol, dividend)
    df_r = torch.exp(-rate * t)
    df_q = torch.exp(-dividend * t)
    pdf1 = norm_pdf(d1)
    cdf_cp_d1 = norm_cdf(cp * d1)
    cdf_cp_d2 = norm_cdf(cp * d2)

    delta = cp * df_q * cdf_cp_d1
    gamma = df_q * pdf1 / (spot * v * sqrt_t)
    vega = spot * df_q * pdf1 * sqrt_t
    theta = (
        -spot * df_q * pdf1 * v / (2.0 * sqrt_t)
        - cp * rate * strike * df_r * cdf_cp_d2
        + cp * dividend * spot * df_q * cdf_cp_d1
    )
    rho = cp * strike * t * df_r * cdf_cp_d2
    dual_delta = -cp * df_r * cdf_cp_d2
    vanna = -df_q * pdf1 * d2 / v
    charm = cp * dividend * df_q * cdf_cp_d1 - df_q * pdf1 * (
        2.0 * (rate - dividend) * t - d2 * v * sqrt_t
    ) / (2.0 * t * v * sqrt_t)
    vomma = vega * d1 * d2 / v
    speed = -gamma / spot * (d1 / (v * sqrt_t) + 1.0)

    degenerate = (maturity <= EPS_TIME) | (vol <= EPS_VOL)
    itm = (cp * (spot - strike)) > 0
    z = torch.zeros_like(spot)
    return {
        "price": bs_price(spot, strike, maturity, rate, vol, cp, dividend),
        "delta": torch.where(degenerate, torch.where(itm, cp, z), delta),
        "gamma": torch.where(degenerate, z, gamma),
        "vega": torch.where(degenerate, z, vega),
        "theta": torch.where(degenerate, z, theta),
        "rho": torch.where(degenerate, z, rho),
        "dual_delta": torch.where(degenerate, z, dual_delta),
        "vanna": torch.where(degenerate, z, vanna),
        "charm": torch.where(degenerate, z, charm),
        "vomma": torch.where(degenerate, z, vomma),
        "speed": torch.where(degenerate, z, speed),
    }


def bs_greeks_ad(spot, strike, maturity, rate, vol, cp=1.0, dividend=0.0) -> dict:
    """Greeks via ``torch.autograd`` of :func:`bs_price` — the AD oracle that
    machine-checks the closed forms."""
    spot, strike, maturity, rate, vol, cp, dividend = torch.broadcast_tensors(
        *as_tensors(spot, strike, maturity, rate, vol, cp, dividend))
    args = [x.detach().clone().requires_grad_(True)
            for x in (spot, strike, maturity, rate, vol, dividend)]
    S, K, T, r, sig, q = args
    with torch.enable_grad():
        total = bs_price(S, K, T, r, sig, cp, q).sum()
        dS, dK, dT, dr, dsig, dq = torch.autograd.grad(total, args, create_graph=True)
        (gamma,) = torch.autograd.grad(dS.sum(), S)
    return {
        "delta": dS.detach(),
        "gamma": gamma.detach(),
        "vega": dsig.detach(),
        "theta": -dT.detach(),  # calendar-time convention
        "rho": dr.detach(),
        "dual_delta": dK.detach(),
    }


# -- batch protocol ----------------------------------------------------------
def price(batch: ContractBatch) -> torch.Tensor:
    """Pricing-protocol entry: ContractBatch → prices."""
    return bs_price(batch.spot, batch.strike, batch.maturity, batch.rate, batch.vol,
                    batch.cp, batch.dividend)


def greeks(batch: ContractBatch) -> dict:
    return bs_greeks(batch.spot, batch.strike, batch.maturity, batch.rate, batch.vol,
                     batch.cp, batch.dividend)


class BlackScholesPricer:
    """Object-style adapter over :func:`bs_price` (scalar protocol)."""

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        cp = 1.0 if str(option_type).lower() in ("call", "c", "1") else -1.0
        return bs_price(S, K, T, r, sigma, cp, q)
