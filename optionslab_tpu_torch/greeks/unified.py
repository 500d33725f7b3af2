"""Unified Greeks engine: one protocol, autograd first, finite differences
as the cross-check oracle.

The port of ``optionslab_tpu/greeks/unified.py``. The engine takes a
function ``price_fn(S, K, T, r, sigma, q) -> price`` and differentiates it
with ``torch.autograd``: one reverse sweep gives every first-order Greek,
and the second-order Greeks (gamma, vanna, vomma, charm) come from a second
reverse sweep over the first gradient (reverse over reverse; the reference
takes ``jacfwd`` of ``grad``, but the port's kernels' ``autograd.Function``s
have no forward mode).

The second sweep differentiates the SUM of the first gradient, which is the
diagonal of the reference's Jacobian only when ``price_fn`` prices each
contract on its own. Every adapter of this module does, and says so with
:func:`contractwise`; for any other ``price_fn`` with more than one contract
the engine takes the diagonal exactly, one second sweep per contract.

:func:`compute_greeks_unified` falls back to the finite-difference engine
only when the pricer returns no autograd graph (a numpy black box, or a
tensor computed without grad); it catches no exception, so a failed kernel
build or launch is never hidden behind a fallback.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import torch

from ..types import ContractBatch
from ..utils.config import as_tensors, input_device, resolve_dtype
from ..utils.validation import check_option_type

__all__ = ["PricerProtocol", "contractwise", "greeks_from_fn", "greeks_batch", "greeks_fd",
           "bs_price_fn", "heston_price_fn", "sabr_price_fn", "fdm_price_fn",
           "merton_price_fn", "bates_price_fn", "compute_greeks_unified", "greeks_heston",
           "greeks_sabr", "greeks_fdm"]


@runtime_checkable
class PricerProtocol(Protocol):
    def price(self, S, K, T, r, sigma, option_type="call", q=0.0): ...


def contractwise(fn: Callable) -> Callable:
    """Mark ``price_fn`` as pricing each contract independently of the
    others, so the second-order Greeks take one second sweep in all."""
    fn.contractwise = True
    return fn


def _inputs(*args) -> list[torch.Tensor]:
    """The arguments as tensors of one floating dtype on one device (the
    card unless a tensor argument says otherwise), broadcast to one shape."""
    ts = as_tensors(*args, dtype=resolve_dtype(*args), device=input_device(*args))
    return list(torch.broadcast_tensors(*ts))


def _grad(y, xs):
    """d(sum y)/dx for each x, zeros where y does not depend on x."""
    if not y.requires_grad:
        return [torch.zeros_like(x) for x in xs]
    gs = torch.autograd.grad(y.sum(), xs, retain_graph=True, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, xs)]


def _second_order(g_s, g_sig, spot, vol, maturity, coupled: bool) -> dict:
    """gamma, vanna, charm and vomma: the diagonals of the Jacobians of the
    first gradients dP/dS and dP/dσ."""
    if not coupled:
        gamma, vanna, dcharm = _grad(g_s, (spot, vol, maturity))
        (vomma,) = _grad(g_sig, (vol,))
    else:
        n = spot.numel()
        rows = [[] for _ in range(4)]
        for i in range(n):
            a = _grad(g_s.reshape(-1)[i], (spot, vol, maturity))
            b = _grad(g_sig.reshape(-1)[i], (vol,))
            for out, d in zip(rows, a + b):
                out.append(d.reshape(-1)[i])
        gamma, vanna, dcharm, vomma = (torch.stack(r).reshape(spot.shape) for r in rows)
    return {"gamma": gamma, "vanna": vanna, "vomma": vomma, "charm": -dcharm}


class _NoGraph(Exception):
    """The pricer returned no autograd graph."""


def _greeks_ad(price_fn: Callable, args, second_order: bool) -> dict:
    leaves = [x.detach().clone(memory_format=torch.contiguous_format).requires_grad_(True)
              for x in _inputs(*args)]
    spot, strike, maturity, rate, vol, dividend = leaves
    with torch.enable_grad():
        price = price_fn(*leaves)
        if not (isinstance(price, torch.Tensor) and price.requires_grad):
            raise _NoGraph
        if not second_order:
            grads = _grad(price, leaves)
            out = {}
        else:
            gs = torch.autograd.grad(price.sum(), leaves, create_graph=True, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(gs, leaves)]
            coupled = spot.numel() > 1 and not getattr(price_fn, "contractwise", False)
            out = _second_order(grads[0], grads[4], spot, vol, maturity, coupled)
    d_s, d_k, d_t, d_r, d_sig, d_q = grads
    out = {"price": price, "delta": d_s, "dual_delta": d_k,
           "theta": -d_t,  # calendar-time convention (matches reference)
           "rho": d_r, "vega": d_sig, "dividend_rho": d_q, **out}
    return {k: v.detach() for k, v in out.items()}


def greeks_from_fn(price_fn: Callable, spot, strike, maturity, rate, vol, dividend=0.0,
                   second_order: bool = True) -> dict:
    """All Greeks of ``price_fn(S, K, T, r, sigma, q) -> price`` by autograd.

    Inputs broadcast; outputs have the broadcast shape. One reverse sweep
    gives every first-order Greek; second order adds gamma, vanna, vomma and
    charm (−d delta/dT) from reverse sweeps over the first gradient.
    """
    try:
        return _greeks_ad(price_fn, (spot, strike, maturity, rate, vol, dividend), second_order)
    except _NoGraph:
        raise TypeError("price_fn returned no autograd graph: it must compute its price "
                        "with torch operations on the tensors it is given") from None


def greeks_batch(price_fn: Callable, batch: ContractBatch, second_order: bool = True) -> dict:
    """Protocol entry for ContractBatch pricers: ``price_fn(batch) -> price``."""
    b = batch.broadcast()

    def fn(s, k, t, r, sig, q):
        return price_fn(ContractBatch(s, k, t, r, sig, q, b.cp.to(s.dtype)))

    return greeks_from_fn(fn, b.spot, b.strike, b.maturity, b.rate, b.vol, b.dividend,
                          second_order=second_order)


# ---------------------------------------------------------------------------
# Finite-difference oracle (kept for validation, not production)
# ---------------------------------------------------------------------------
def greeks_fd(price_fn: Callable, spot, strike, maturity, rate, vol, dividend=0.0) -> dict:
    """Central-difference Greeks with the reference's steps: h_S = 1%·S,
    h_σ = 0.01, h_r = 1e-4, h_T = 1/365. ``price_fn`` may return tensors,
    arrays or numbers."""
    spot, strike, maturity, rate, vol, dividend = _inputs(spot, strike, maturity, rate, vol,
                                                          dividend)
    h_s = 0.01 * spot
    h_sig = 0.01
    h_r = 1e-4
    h_t = 1.0 / 365.0

    def p(s=None, k=None, t=None, r=None, sig=None, q=None):
        out = price_fn(
            spot if s is None else s, strike if k is None else k,
            maturity if t is None else t, rate if r is None else r,
            vol if sig is None else sig, dividend if q is None else q,
        )
        if isinstance(out, torch.Tensor):
            out = out.detach()
        return torch.as_tensor(out, dtype=spot.dtype, device=spot.device)

    base = p()
    up, dn = p(s=spot + h_s), p(s=spot - h_s)
    delta = (up - dn) / (2 * h_s)
    gamma = (up - 2 * base + dn) / (h_s * h_s)
    vega = (p(sig=vol + h_sig) - p(sig=vol - h_sig)) / (2 * h_sig)
    rho = (p(r=rate + h_r) - p(r=rate - h_r)) / (2 * h_r)
    theta = -(p(t=maturity + h_t) - p(t=maturity - h_t)) / (2 * h_t)
    vanna = (
        p(s=spot + h_s, sig=vol + h_sig) - p(s=spot + h_s, sig=vol - h_sig)
        - p(s=spot - h_s, sig=vol + h_sig) + p(s=spot - h_s, sig=vol - h_sig)
    ) / (4 * h_s * h_sig)
    vomma = (p(sig=vol + h_sig) - 2 * base + p(sig=vol - h_sig)) / (h_sig * h_sig)
    return {"price": base, "delta": delta, "gamma": gamma, "vega": vega,
            "rho": rho, "theta": theta, "vanna": vanna, "vomma": vomma}


# ---------------------------------------------------------------------------
# Adapters: functional price_fn per model family
# ---------------------------------------------------------------------------
def _params_like(params, x: torch.Tensor, **replace):
    """A parameter dataclass with every field a tensor of ``x``'s dtype and
    device, then ``replace`` applied."""
    fields = {f.name: torch.as_tensor(getattr(params, f.name), dtype=x.dtype, device=x.device)
              for f in dataclasses.fields(params)}
    return dataclasses.replace(params, **{**fields, **replace})


def _cp(cp, s: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cp, dtype=s.dtype, device=s.device).expand(s.shape)


def bs_price_fn(cp=1.0) -> Callable:
    from ..models.black_scholes import bs_price

    return contractwise(lambda s, k, t, r, sig, q: bs_price(s, k, t, r, sig, cp, q))


def heston_price_fn(params, cp=1.0) -> Callable:
    """σ is mapped to v0 = σ² like the reference's HestonAdapter, so vega is
    a total-vol sensitivity."""
    from ..models.heston import heston_price

    def fn(s, k, t, r, sig, q):
        p = _params_like(params, s, v0=sig**2)
        return heston_price(ContractBatch(s, k, t, r, sig, q, _cp(cp, s)), p)

    return contractwise(fn)


def sabr_price_fn(params, cp=1.0) -> Callable:
    from ..models.sabr import sabr_price

    def fn(s, k, t, r, sig, q):
        fwd = s * torch.exp((r - q) * t)
        del sig
        return sabr_price(fwd, k, t, r, _params_like(params, s), cp)

    return contractwise(fn)


def fdm_price_fn(cp=1.0, n_space: int = 201, n_time: int = 100, american: bool = False) -> Callable:
    from ..models.fdm import fdm_price

    def fn(s, k, t, r, sig, q):
        return fdm_price(ContractBatch(s, k, t, r, sig, q, _cp(cp, s)),
                         n_space=n_space, n_time=n_time, american=american)

    return contractwise(fn)


def merton_price_fn(lam, mu_j, sigma_j, cp=1.0) -> Callable:
    from ..models.jump_diffusion import merton_price

    def fn(s, k, t, r, sig, q):
        return merton_price(ContractBatch(s, k, t, r, sig, q, _cp(cp, s)), lam, mu_j, sigma_j)

    return contractwise(fn)


def bates_price_fn(params, cp=1.0) -> Callable:
    """σ maps to v0 = σ² (same convention as the Heston adapter)."""
    from ..models.bates import bates_price

    def fn(s, k, t, r, sig, q):
        p = _params_like(params, s, v0=sig**2)
        return bates_price(ContractBatch(s, k, t, r, sig, q, _cp(cp, s)), p)

    return contractwise(fn)


# ---------------------------------------------------------------------------
# Reference-signature entry point: works with object pricers too
# ---------------------------------------------------------------------------
def compute_greeks_unified(pricer, S, K, T, r, sigma, option_type="call", q=0.0,
                           second_order: bool = False) -> dict:
    """Greeks for any pricer: a functional ``price_fn`` or an object with
    ``.price(S, K, T, r, sigma, option_type, q)``.

    Autograd runs when the pricer's price carries a graph. A pricer that
    returns none — it answers with numpy arrays or numbers, or with a tensor
    computed without grad — gets the finite-difference engine, called with
    plain tensors.
    """
    cp = float(check_option_type(option_type))

    if callable(pricer) and not hasattr(pricer, "price"):
        fn = pricer
    else:
        def fn(s, k, t, r_, sig, q_):
            return pricer.price(s, k, t, r_, sig, "call" if cp > 0 else "put", q_)

    plain = _inputs(S, K, T, r, sigma, q)
    if not isinstance(fn(*plain), torch.Tensor):
        return greeks_fd(fn, *plain)
    try:
        return _greeks_ad(fn, plain, second_order)
    except _NoGraph:
        return greeks_fd(fn, *plain)


def greeks_heston(params, S, K, T, r, sigma, option_type="call", q=0.0) -> dict:
    cp = float(check_option_type(option_type))
    return greeks_from_fn(heston_price_fn(params, cp), S, K, T, r, sigma, q,
                          second_order=False)


def greeks_sabr(params, S, K, T, r, option_type="call", q=0.0) -> dict:
    cp = float(check_option_type(option_type))
    return greeks_from_fn(sabr_price_fn(params, cp), S, K, T, r, 0.0, q,
                          second_order=False)


def greeks_fdm(S, K, T, r, sigma, option_type="call", q=0.0, american=False) -> dict:
    cp = float(check_option_type(option_type))
    return greeks_from_fn(fdm_price_fn(cp, american=american), S, K, T, r, sigma, q,
                          second_order=False)
