"""Tree-Greeks entry point matching the reference's ``compute_greeks``.

The port of ``optionslab_tpu/greeks/tree.py``: price, delta, gamma and theta
from the CRR lattice's nodes and vega, rho, the dividend rho and the strike
derivative by autograd of the price, all from one solve
(``models.binomial.binomial_greeks``); ``second_order=True`` adds vanna,
charm and vomma by autograd through the lattice.
"""

from __future__ import annotations

from ..models.binomial import binomial_greeks, binomial_price
from ..types import ContractBatch
from ..utils.config import input_device, resolve_dtype
from ..utils.validation import check_option_type
from .unified import _cp, contractwise, greeks_from_fn


def compute_greeks(S, K, T, r, sigma, option_type="call", q=0.0,
                   american: bool = False, n_steps: int = 512,
                   second_order: bool = False) -> dict:
    """Full Greek ladder from the CRR lattice, on the device of the tensor
    arguments (the card when they are numbers)."""
    cp = float(check_option_type(option_type))
    batch = ContractBatch.make(S, K, T, r, sigma, option_type, q,
                               dtype=resolve_dtype(S, K, T, r, sigma, q),
                               device=input_device(S, K, T, r, sigma, q))
    out = dict(binomial_greeks(batch, american=american, n_steps=n_steps))
    if second_order:
        def price_fn(s, k, t, r_, sig, q_):
            return binomial_price(ContractBatch(s, k, t, r_, sig, q_, _cp(cp, s)),
                                  american=american, n_steps=n_steps)

        ad = greeks_from_fn(contractwise(price_fn), batch.spot, batch.strike, batch.maturity,
                            batch.rate, batch.vol, batch.dividend, second_order=True)
        for k_ in ("vanna", "charm", "vomma"):
            out[k_] = ad[k_]
    return out
