"""CRR / Leisen–Reimer binomial lattice: backward induction over a whole book.

The port of ``optionslab_tpu/models/binomial.py``. The book's lattices are
one ``(book, nodes)`` tensor of fixed width ``n_steps + 1`` (node validity is
positional, as in the reference), and the induction is a Python loop of
tensor ops over the steps: every contract steps back together, with no host
synchronisation. Delta/gamma/theta come from the nodes captured at steps 2,
1 and 0 (Leisen–Reimer's theta read at S0, not at its off-centre middle
node: a deliberate difference from the reference); vega, rho and the
dividend rho by ``torch.autograd`` through the induction.
"""

from __future__ import annotations

import torch

from ..types import ContractBatch
from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError


def _peizer_pratt(z, n):
    """Peizer–Pratt method-2 inversion of the Leisen–Reimer tree, with the
    small-u series for 1 − exp(−u) (the plain form cancels in float32)."""
    denom = n + 1.0 / 3.0 + 0.1 / (n + 1.0)
    u = ((z / denom) ** 2) * (n + 1.0 / 6.0)
    series = u * (1.0 - 0.5 * u + u * u / 6.0)
    inner = torch.where(u < 1e-2, series, -torch.expm1(-u))
    return 0.5 + torch.sign(z) * 0.5 * torch.sqrt(torch.clamp_min(inner, 0.0))


def _exp_small(x):
    """exp(x) with a 5-term Taylor branch for |x| < 0.03 (the per-step
    lattice factors), as in the reference."""
    series = 1.0 + x * (1.0 + x * (0.5 + x * (1.0 / 6.0 + x / 24.0)))
    return torch.where(torch.abs(x) < 0.03, series, torch.exp(x))


def _crr_solve(spot, strike, maturity, rate, vol, dividend, cp, american: bool,
               n_steps: int, method: str = "crr"):
    """A book of lattices: every argument is a (B,) tensor. Returns (price
    (B,), node captures for the Greeks).

    Row b holds contract b's value vector of length ``n_steps + 1``, index j
    the node with j up-moves; node spots are exact cumulative products, never
    exp(j·log u). ``method="leisen-reimer"`` uses the Peizer–Pratt lattice
    (odd ``n_steps``).
    """
    dtype = spot.dtype
    col = lambda x: x[:, None]  # noqa: E731
    t = torch.clamp_min(maturity, EPS_TIME)
    dt = t / n_steps
    sqrt_dt = torch.sqrt(dt)
    disc = _exp_small(-rate * dt)
    growth = _exp_small((rate - dividend) * dt)
    if method == "leisen-reimer":
        sig_sqrt_t = torch.clamp_min(vol, 1e-8) * torch.sqrt(t)
        d1 = (torch.log(spot / strike) + (rate - dividend + 0.5 * vol * vol) * t) / sig_sqrt_t
        d2 = d1 - sig_sqrt_t
        n_f = float(n_steps)
        p = torch.clamp(_peizer_pratt(d2, n_f), 1e-9, 1.0 - 1e-9)
        p_star = torch.clamp(_peizer_pratt(d1, n_f), 1e-9, 1.0 - 1e-9)
        u = growth * p_star / p
        d = (growth - p * u) / (1.0 - p)
    else:
        u_log = vol * sqrt_dt
        u = _exp_small(u_log)
        d = _exp_small(-u_log)
        p = torch.clamp((growth - d) / torch.clamp_min(u - d, 1e-12), 0.0, 1.0)
    lu = torch.log(u)
    ld = torch.log(torch.clamp_min(d, 1e-12))
    d_safe = torch.clamp_min(d, 1e-12)

    n_book = spot.shape[0]
    ratio = (u / d_safe)[:, None].expand(n_book, n_steps)
    ones = torch.ones((n_book, 1), dtype=dtype, device=spot.device)
    up_over_down = torch.cumprod(torch.cat([ones, ratio], dim=1), dim=1)  # (u/d)^j
    d_pow_n = torch.cumprod(d[:, None].expand(n_book, n_steps), dim=1)[:, -1]
    s_row = col(spot * d_pow_n) * up_over_down  # S0·d^n·(u/d)^j

    strike_c, cp_c, disc_c, p_c = col(strike), col(cp), col(disc), col(p)
    inv_d = col(1.0 / d_safe)
    v = torch.clamp_min(cp_c * (s_row - strike_c), 0.0)

    def step_back(v, s_row):
        s_row = s_row * inv_d
        cont = disc_c * (p_c * torch.roll(v, -1, dims=1) + (1.0 - p_c) * v)
        if american:
            cont = torch.maximum(cont, torch.clamp_min(cp_c * (s_row - strike_c), 0.0))
        return cont, s_row

    for _ in range(max(n_steps - 2, 0)):
        v, s_row = step_back(v, s_row)
    v2 = v  # step 2 (nodes 0..2), or the terminal row if n_steps <= 2
    if n_steps >= 2:
        v, s_row = step_back(v, s_row)
    v1 = v
    if n_steps >= 1:
        v, s_row = step_back(v, s_row)
    return v[:, 0], (v1, v2, (lu, ld), dt)


def _lattice_greeks(spot, v1, v2, u_log, dt, price, centred: bool = True):
    """Delta/gamma/theta from the captured nodes.

    Theta compares the value at S0 two steps on with the price. CRR's
    middle node at step 2 sits at S0 (``centred``); Leisen–Reimer's sits at
    S0·u·d, so there the value at S0 is read off the quadratic through the
    three step-2 nodes (the reference takes the node's value as is, which
    puts its Leisen–Reimer theta far off).
    """
    lu, ld = u_log
    s_u = spot * torch.exp(lu)
    s_d = spot * torch.exp(ld)
    delta = (v1[:, 1] - v1[:, 0]) / torch.clamp_min(s_u - s_d, 1e-12)
    s_uu = spot * torch.exp(2 * lu)
    s_dd = spot * torch.exp(2 * ld)
    s_ud = spot * torch.exp(lu + ld)
    d_up = (v2[:, 2] - v2[:, 1]) / torch.clamp_min(s_uu - s_ud, 1e-12)
    d_dn = (v2[:, 1] - v2[:, 0]) / torch.clamp_min(s_ud - s_dd, 1e-12)
    gamma = (d_up - d_dn) / torch.clamp_min(0.5 * (s_uu - s_dd), 1e-12)
    v_later = v2[:, 1]
    if not centred:
        v_later = v_later + (spot - s_ud) * (d_dn + 0.5 * gamma * (spot - s_dd))
    theta = (v_later - price) / torch.clamp_min(2.0 * dt, 1e-12)
    return delta, gamma, theta


def _flat_args(batch: ContractBatch):
    b = batch.broadcast()
    return b.shape, [f.reshape(-1) for f in (b.spot, b.strike, b.maturity, b.rate, b.vol,
                                              b.dividend, b.cp)]


def binomial_price(batch: ContractBatch, american: bool = False, n_steps: int = 512,
                   richardson: bool = False, method: str = "crr") -> torch.Tensor:
    """Whole-book lattice prices on the batch's device.

    ``richardson=True`` averages the N and N+1 step lattices (N+2 for
    Leisen–Reimer, which needs odd counts), cancelling CRR's even/odd
    oscillation.
    """
    shape, (s, k, t, r, sig, q, cp) = _flat_args(batch)
    prices = _crr_solve(s, k, t, r, sig, q, cp, american, n_steps, method)[0]
    if richardson:
        partner = n_steps + (2 if method == "leisen-reimer" else 1)
        prices = 0.5 * (prices + _crr_solve(s, k, t, r, sig, q, cp, american, partner,
                                            method)[0])
    intrinsic = torch.clamp_min(cp * (s - k), 0.0)
    return torch.where(t <= EPS_TIME, intrinsic, prices).reshape(shape)


def binomial_greeks(batch: ContractBatch, american: bool = False, n_steps: int = 512,
                    method: str = "crr") -> dict:
    """Price and the Greek ladder from one lattice per contract: delta,
    gamma and theta from the nodes; vega, rho, the dividend rho and the
    strike derivative (``dual_delta``) by autograd of the price."""
    shape, (s, k, t, r, sig, q, cp) = _flat_args(batch)
    leaves = [x.detach().clone().requires_grad_(True) for x in (k, r, sig, q)]
    with torch.enable_grad():
        price, (v1, v2, u_log, dt) = _crr_solve(s, leaves[0], t, leaves[1], leaves[2],
                                                leaves[3], cp, american, n_steps, method)
        dual_delta, rho, vega, div_rho = torch.autograd.grad(price.sum(), leaves)
    price = price.detach()
    v1, v2, dt = v1.detach(), v2.detach(), dt.detach()
    u_log = tuple(x.detach() for x in u_log)
    delta, gamma, theta = _lattice_greeks(s, v1, v2, u_log, dt, price,
                                          centred=method != "leisen-reimer")
    out = {"price": price, "delta": delta, "gamma": gamma, "theta": theta, "vega": vega,
           "rho": rho, "dual_delta": dual_delta, "dividend_rho": div_rho}
    return {name: v.reshape(shape) for name, v in out.items()}


class BinomialTree:
    """Object adapter with the reference's ``BinomialTree`` methods; scalar
    or array inputs priced on ``device``."""

    def __init__(self, n_steps: int = 512, american: bool = False, method: str = "crr",
                 device="cuda"):
        if n_steps < 3:
            raise ValidationError(f"n_steps must be >= 3, got {n_steps}")
        if method not in ("crr", "leisen-reimer"):
            raise ValidationError(f"method must be crr|leisen-reimer, got {method!r}")
        if method == "leisen-reimer" and n_steps % 2 == 0:
            n_steps += 1  # LR requires odd step counts
        self.n_steps = n_steps
        self.american = american
        self.method = method
        self.device = device

    def _batch(self, S, K, T, r, sigma, option_type, q):
        return ContractBatch.make(S, K, T, r, sigma, option_type, q, device=self.device)

    def _greeks(self, S, K, T, r, sigma, option_type, q):
        return binomial_greeks(self._batch(S, K, T, r, sigma, option_type, q),
                               american=self.american, n_steps=self.n_steps, method=self.method)

    def price(self, S, K, T, r, sigma, option_type="call", q=0.0):
        return binomial_price(self._batch(S, K, T, r, sigma, option_type, q),
                              american=self.american, n_steps=self.n_steps, method=self.method)

    def delta(self, S, K, T, r, sigma, option_type="call", q=0.0):
        return self._greeks(S, K, T, r, sigma, option_type, q)["delta"]

    def gamma(self, S, K, T, r, sigma, option_type="call", q=0.0):
        return self._greeks(S, K, T, r, sigma, option_type, q)["gamma"]

    def calculate_all(self, S, K, T, r, sigma, option_type="call", q=0.0):
        return self._greeks(S, K, T, r, sigma, option_type, q)
