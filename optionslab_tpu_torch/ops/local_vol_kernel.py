"""Local-volatility (Dupire) Monte Carlo in one kernel pass: 20 payoffs and a
one-pass likelihood-ratio delta/gamma/vega.

The port of ``optionslab_tpu/ops/local_vol_pallas.py``. One CUDA source,
``csrc/local_vol_mc.cu`` (the port of ``_lv_kernel``). The host fits, for
every time step, σ(·, t_i) of a Dupire surface by a density-weighted
degree-6 polynomial in x = log(S/S0) over that step's reachable band
(:func:`fit_sigma_polys`); in the kernel each step's σ is then a Horner
evaluation of the step's row ``[x_lo, x_hi, c6..c0]`` at x clamped to the
band. Every lane of the reference's (128, 512) counter space carries four
antithetic log-Euler paths (z₁, −z₁, z₂, −z₂), x += μdt − ½σ²dt + σ√dt·z,
and the payoff's running statistic (Asian sum, range counter, extremum of
x, barrier/touch flags, the discounted pay-at-hit cash). It returns per-row
sums of pay, pay² and, with ``greeks``, Σpay·z₁, Σpay·(z₁²−1), Σpay·vscore
(+ the lookback boundary moments b₀, b₁).

Geometry. ``ROWS × LANES`` lanes per path block, four paths each: the
reference's counter space, so the ``hash`` path set and the ``sobol_bb``
bridge (8 dyadic levels, hash residuals, the scramble salt ``0x632BE5AB``,
the GBM exotic kernel's construction) are the reference's own; ``prng`` is
Philox keyed by ``(seed, salt ^ block)`` at counter ``(row, col, step, 0)``.

Dispatch. CUDA tensors go through :func:`_lv_cuda` (it counts its launches
in ``.launches`` and raises if it cannot build or launch), CPU tensors
through :func:`_lv_plain`, the same sums from the same counters with the same
float32 operations in the same order. The pricer runs on its ``device``
(default: the surface's).

Names. ``pallas_local_vol_price`` → :func:`local_vol_kernel_price`;
:class:`LocalVolKernelPricer` and :func:`fit_sigma_polys` keep theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.config import EPS_TIME
from ..utils.exceptions import ValidationError
from . import _build
from .exotic_kernel import (
    _bridge_offsets,
    _bridge_plan_arrays,
    _check_tensor,
    _chunking,
    _launch_checked,
    _mean_stderr,
    _n_blocks,
)
from .heston_exotic_kernel import _kernel_codes as _exotic_codes
from .heston_kernel import _count, _dispatch, _require_cuda, _stream, _sum_blocks
from .kernel_rng import draw_normals

ROWS = 128
LANES = 512
PATHS_PER_BLOCK = 4 * ROWS * LANES  # four antithetic paths per lane
DEGREE = 6  # polynomial degree of the per-step σ(x) fit
MAX_STEPS = 6000  # the step table is staged in shared memory (36 bytes a step)

# scalar params before the per-step table; each step row is [x_lo_i, x_hi_i,
# c_deg, ..., c_0]. Single barrier/touch kinds use _P_BARRIER; double kinds
# and the range accrual put (lower, upper) in relative-log space into
# (_P_BARRIER, _P_BARRIER2). _P_RDT = r·dt (pay-at-hit discounting).
(_P_S0, _P_K, _P_MU_DT, _P_DT, _P_SQDT, _P_BARRIER, _P_BARRIER2, _P_RDT) = range(8)
_N_SCALARS = 8
_ROW = DEGREE + 3

PAYOFFS = ("european", "asian", "range_accrual",
           "barrier_up-and-out", "barrier_up-and-in",
           "barrier_down-and-out", "barrier_down-and-in",
           "lookback_float", "lookback_fixed",
           "one_touch_up", "one_touch_down", "no_touch_up", "no_touch_down",
           # double kinds take (lower, upper) via the lower/upper kwargs
           "barrier_double-out", "barrier_double-in",
           "one_touch_double", "no_touch_double",
           # pay-at-hit one-touches (first-hit discounting in the kernel)
           "one_touch_up_hit", "one_touch_down_hit", "one_touch_double_hit")
SAMPLERS = ("prng", "hash", "sobol_bb", "sobol_bb_hash")


def _is_qmc(sampler: str) -> bool:
    return sampler.startswith("sobol_bb")


def _n_moments(payoff: str, greeks: bool) -> int:
    return (7 if payoff.startswith("lookback") else 5) if greeks else 2


def _check_launch(payoff: str, sampler: str, greeks: bool, n_steps: int) -> None:
    """The reference launcher's ``ValidationError`` cases (``_launch``)."""
    if payoff not in PAYOFFS:
        raise ValidationError(f"payoff must be one of {PAYOFFS}, got {payoff!r}")
    if sampler not in SAMPLERS:
        raise ValidationError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValidationError(f"n_steps must be in [1, {MAX_STEPS}], got {n_steps}")
    if _is_qmc(sampler):
        if n_steps < 2:
            raise ValidationError("bridge QMC needs n_steps >= 2 (terminal + midpoint "
                                  "coordinates)")
        if greeks:
            raise ValidationError("LR scores assume iid normals; the bridge-QMC samplers "
                                  "correlate increments — use prng/hash for LR Greeks")


# ---------------------------------------------------------------------------
# The kernel: plain version
# ---------------------------------------------------------------------------
def _horner(row, x):
    """The step row's polynomial at x clamped to its band, in the reference's
    order (highest degree first), floored at 1e-4."""
    xc = torch.clamp(x, row[0], row[1])
    acc = row[2] * torch.ones_like(xc)
    for j in range(1, DEGREE + 1):
        acc = acc * xc + row[2 + j]
    return torch.clamp_min(acc, 1e-4)


def _lv_block_plain(seed, block, p, *, n_steps, cp, payoff, sampler, greeks):
    """Per-lane moment terms (each (nb, ROWS, LANES) float32, the lane's four
    paths summed) of path blocks ``block``: a line-by-line twin of the
    reference's ``_lv_kernel`` body."""
    nb = block.shape[0]
    shape = (nb, ROWS, LANES)
    s0, strike, mu_dt, dt, sqdt, b1, b2, rdt = (p[j] for j in range(_N_SCALARS))
    table = p[_N_SCALARS:].reshape(n_steps, _ROW)
    zero = torch.zeros(shape, dtype=torch.float32, device=p.device)
    qmc = _is_qmc(sampler)
    residual = "hash" if (qmc or sampler == "hash") else "prng"
    touch = "touch" in payoff
    barrier = payoff.startswith("barrier") or touch
    double = "double" in payoff
    hit_pay = payoff.endswith("_hit")
    lookback = payoff.startswith("lookback")
    up = "up" in payoff
    lb_min = (payoff == "lookback_float") == (cp > 0)

    def f(b):
        return b.to(torch.float32)

    def now(x):
        if double:
            return f((x <= b1) | (x >= b2))
        return f(x >= b1) if up else f(x <= b1)

    xs = [zero] * 4  # log(S/S0) per antithetic path
    if barrier:
        h0 = now(torch.zeros((), device=p.device)) + zero
        aux = [(h0, h0) if hit_pay else h0] * 4  # (hit, pv = df at the first hit)
    else:
        aux = [zero] * 4  # Asian sums, range counters or the extremum of x (x0 = 0)
    gz1 = [zero, zero]  # the first step's normals per stream
    gvs = [zero] * 4  # per-path vega scores

    def body(i, offs):
        nonlocal xs, aux, gz1, gvs
        z1, z2 = draw_normals(residual, seed, block, i, n_steps, ROWS, LANES)
        if offs is None:
            zs = (z1, -z1, z2, -z2)
        else:  # conditional-law residuals pinned to the bridge targets
            oc_p, oc_m, os_p, os_m = offs
            zs = (z1 + oc_p, -z1 + oc_m, z2 + os_p, -z2 + os_m)
        if greeks and i == 0:
            gz1 = [z1, z2]
        row = table[i]
        new_xs, new_gvs = [], []
        for x, z, g in zip(xs, zs, gvs):
            sig = _horner(row, x)
            new_xs.append(x + mu_dt - 0.5 * sig * sig * dt + sig * sqdt * z)
            if greeks:
                new_gvs.append(g + (z * z - 1.0) / sig - z * sqdt)
        xs = new_xs
        if greeks:
            gvs = new_gvs
        if payoff == "asian":
            aux = [a + s0 * torch.exp(x) for a, x in zip(aux, xs)]
        elif payoff == "range_accrual":
            aux = [a + f((x >= b1) & (x <= b2)) for a, x in zip(aux, xs)]
        elif lookback:
            ext = torch.minimum if lb_min else torch.maximum
            aux = [ext(a, x) for a, x in zip(aux, xs)]
        elif hit_pay:
            df_i = torch.exp(-rdt * float(i + 1))
            aux = [(torch.maximum(h, now(x)), pv + (1.0 - h) * now(x) * df_i)
                   for (h, pv), x in zip(aux, xs)]
        elif barrier:
            aux = [torch.maximum(h, now(x)) for h, x in zip(aux, xs)]

    if qmc:
        for a, b, offs in _bridge_offsets(seed, block, n_steps, "hash", zero):
            for i in range(a, b):
                body(i, offs)
    else:
        for i in range(n_steps):
            body(i, None)

    moms = [zero] * _n_moments(payoff, greeks)
    inv_n = 1.0 / n_steps
    for br in range(4):
        x, a = xs[br], aux[br]
        if payoff == "asian":
            pay = torch.clamp_min(cp * (a * inv_n - strike), 0.0)
        elif payoff == "lookback_float":
            ext_s, s_t = s0 * torch.exp(a), s0 * torch.exp(x)
            pay = (s_t - ext_s) if cp > 0 else (ext_s - s_t)
        elif payoff == "lookback_fixed":
            pay = torch.clamp_min(cp * (s0 * torch.exp(a) - strike), 0.0)
        elif payoff == "range_accrual":
            pay = a * inv_n  # accrual fraction on unit notional
        elif hit_pay:
            pay = a[1]  # discounted at the hit in the kernel (host df = 1)
        elif touch:
            pay = a if payoff.startswith("one") else (1.0 - a)
        elif barrier:
            vanilla = torch.clamp_min(cp * (s0 * torch.exp(x) - strike), 0.0)
            pay = vanilla * (a if payoff.endswith("in") else (1.0 - a))
        else:
            pay = torch.clamp_min(cp * (s0 * torch.exp(x) - strike), 0.0)
        terms = [pay, pay * pay]
        if greeks:
            z1b = gz1[br // 2]  # the path's first-step normal is ±(its stream's)
            zs1 = -z1b if br % 2 else z1b
            terms += [pay * zs1, pay * (z1b * z1b - 1.0), pay * gvs[br]]
            if lookback:  # the extremum includes S0: ∂pay/∂x0 where it is attained at t = 0
                at0 = f(a == 0.0)
                if payoff == "lookback_fixed":
                    f0 = cp * at0 * f(cp * (s0 - strike) > 0.0)
                else:  # float: the call pays S_T − min (−), the put max − S_T (+)
                    f0 = -at0 if cp > 0 else at0
                terms += [f0, f0 * zs1]
        moms = [m + t for m, t in zip(moms, terms)]
    return moms


def _lv_plain(seed: int, block0: int, params: torch.Tensor, *, n_steps: int, n_blocks: int,
              cp: float, payoff: str, sampler: str = "prng", greeks: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel: per-row sums ``(n_mom, ROWS)``
    float32 of ``n_blocks`` path blocks from ``block0``. Runs on any
    device."""
    _check_launch(payoff, sampler, greeks, n_steps)
    return _sum_blocks(
        lambda blk: _lv_block_plain(seed, blk, params, n_steps=n_steps, cp=float(cp),
                                    payoff=payoff, sampler=sampler, greeks=greeks),
        n_blocks, block0, LANES, (_n_moments(payoff, greeks),), params.device)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------
_SAMPLER_ID = {"prng": 0, "hash": 1, "sobol_bb": 2, "sobol_bb_hash": 2}
# statistic families of csrc/local_vol_mc.cu (a template parameter each)
(_F_EURO, _F_ASIAN, _F_RANGE, _F_LOOKBACK, _F_HIT, _F_HIT_AT) = range(6)


def _kernel_codes(payoff: str, cp: float) -> tuple[int, int]:
    """(family, mode) of a payoff: the family is a template parameter of the
    kernel, the mode a runtime argument, the Heston exotic kernel's
    (lookback: bit 0 floating, bit 1 running minimum; barrier/touch: side |
    payoff << 2; pay-at-hit: side)."""
    fixed = {"european": _F_EURO, "asian": _F_ASIAN, "range_accrual": _F_RANGE}
    if payoff in fixed:
        return fixed[payoff], 0
    family = (_F_LOOKBACK if payoff.startswith("lookback")
              else _F_HIT_AT if payoff.endswith("_hit") else _F_HIT)
    return family, _exotic_codes(payoff, cp)[1]


def _lv_cuda(seed: int, block0: int, params: torch.Tensor, *, n_steps: int, n_blocks: int,
             cp: float, payoff: str, sampler: str = "prng", greeks: bool = False) -> torch.Tensor:
    """The kernel: per-row sums ``(n_mom, ROWS)`` float32 on the card.
    Launches on PyTorch's current stream and does not synchronize.
    ``_lv_cuda.launches`` counts its launches."""
    _check_launch(payoff, sampler, greeks, n_steps)
    dev = params.device
    _require_cuda("_lv_cuda", dev)
    _check_tensor("params", params, dev, (_N_SCALARS + _ROW * n_steps,))
    if n_blocks < 1:
        raise ValueError(f"n_blocks must be positive, got {n_blocks}")
    n_chunks, per_chunk = _chunking(n_blocks)
    family, mode = _kernel_codes(payoff, cp)
    plan_i, plan_f = (_bridge_plan_arrays(n_steps) if _is_qmc(sampler)
                      else (np.zeros(32, np.int32), np.zeros(23, np.float32)))
    lib = _build.load_library()
    n_mom = _n_moments(payoff, greeks)
    partials = torch.empty((n_mom, ROWS, n_chunks), dtype=torch.float32, device=dev)
    out = torch.empty((n_mom, ROWS), dtype=torch.float32, device=dev)
    err = lib.local_vol_moments(
        params.data_ptr(), int(seed) & 0xFFFFFFFF, int(block0) & 0xFFFFFFFF, n_blocks,
        per_chunk, n_chunks, n_steps, float(cp), family, mode, _SAMPLER_ID[sampler],
        int(greeks), n_mom, plan_i.ctypes.data, plan_f.ctypes.data, partials.data_ptr(),
        out.data_ptr(), dev.index, _stream(dev))
    _launch_checked("local_vol_moments", err)
    _count(_lv_cuda)
    return out


_lv_cuda.launches = 0


# ---------------------------------------------------------------------------
# Host side: the σ-polynomial table, parameters, moments → price / Greeks
# ---------------------------------------------------------------------------
def fit_sigma_polys(sigma_fn, spot, rate, dividend, maturity, n_steps: int, n_fit: int = 41):
    """Per-step least-squares polynomial fits of σ(x = log(S/S0), t_i) over
    that step's reachable band (drift centre ± 4 ATM stddevs + 0.05).

    ``sigma_fn(s, t) -> vol`` takes float32 tensors (e.g. a
    :class:`~optionslab_tpu_torch.models.local_vol.LocalVolSurface`; it is
    called on its ``device``). Two batched surface evaluations, then float64
    ``np.polyfit`` per step weighted by the path density. Returns (rows
    float64 (n_steps, DEGREE+3) of [x_lo, x_hi, c_deg..c_0], the worst
    per-step density-weighted rms fit residual in vols)."""
    dev = getattr(sigma_fn, "device", None)
    t_total = max(float(maturity), EPS_TIME)
    dt = t_total / n_steps
    times = np.arange(n_steps) * dt

    def call(s, t):
        out = sigma_fn(torch.as_tensor(np.asarray(s, np.float32), device=dev),
                       torch.as_tensor(np.asarray(t, np.float32), device=dev))
        return out.detach().cpu().numpy().astype(np.float64)

    atms = call(np.full(n_steps, float(spot)), times).ravel()
    centers = (float(rate) - float(dividend) - 0.5 * atms**2) * times
    halves = 4.0 * atms * np.sqrt(times) + 0.05
    xg = centers[:, None] + np.linspace(-1.0, 1.0, n_fit) * halves[:, None]
    sg = float(spot) * np.exp(xg)
    tg = np.broadcast_to(times[:, None], xg.shape)
    vols = call(sg.ravel(), tg.ravel()).reshape(xg.shape)
    rows = np.empty((n_steps, _ROW), np.float64)
    resid = 0.0
    for i in range(n_steps):
        # density-weighted: the fit is tight where the paths are, indifferent
        # to the bilinear surface's wing kinks
        sd = max(atms[i] * math.sqrt(times[i]), 0.02)
        dens = np.exp(-0.5 * ((xg[i] - centers[i]) / sd) ** 2)
        c = np.polyfit(xg[i], vols[i], DEGREE, w=np.sqrt(dens))
        rows[i] = np.concatenate([[xg[i, 0], xg[i, -1]], c])
        err = np.polyval(c, xg[i]) - vols[i]
        resid = max(resid, float(np.sqrt((dens * err**2).sum() / dens.sum())))
    return rows, resid


class LocalVolKernelPricer:
    """Fit once, price many: the per-step σ-polynomial table is fitted at
    construction, then every ``price``/``greeks`` call is one kernel launch.
    :func:`local_vol_kernel_price` is the one-shot convenience."""

    PAYOFFS = PAYOFFS

    def __init__(self, dupire, maturity, n_steps: int = 100, device=None):
        surface = getattr(dupire, "surface", dupire)
        rows, resid = fit_sigma_polys(surface, float(dupire.spot), float(dupire.rate),
                                      float(dupire.dividend), max(float(maturity), EPS_TIME),
                                      int(n_steps))
        self._setup(rows, resid, dupire.spot, dupire.rate, dupire.dividend, maturity,
                    device if device is not None else getattr(surface, "device", "cuda"))

    @classmethod
    def from_numpy(cls, rows, fit_residual, spot, rate, dividend, maturity,
                   device="cuda") -> "LocalVolKernelPricer":
        """A pricer on a fitted step table (float64 (n_steps, 9), e.g. the JAX
        package's ``LocalVolKernelPricer.rows``) instead of fitting one."""
        out = object.__new__(cls)
        out._setup(np.asarray(rows, np.float64), float(fit_residual), spot, rate, dividend,
                   maturity, device)
        return out

    def _setup(self, rows, resid, spot, rate, dividend, maturity, device):
        self.spot = float(spot)
        self.rate = float(rate)
        self.dividend = float(dividend)
        self.t_total = max(float(maturity), EPS_TIME)
        self.rows, self.fit_residual = rows, resid
        self.n_steps = rows.shape[0]
        self.device = torch.device(device)
        dt = self.t_total / self.n_steps
        self._head = np.asarray([self.spot, 0.0, (self.rate - self.dividend) * dt, dt,
                                 math.sqrt(dt), 0.0, 0.0, self.rate * dt], np.float64)

    def _params(self, strike, payoff, barrier, lower=0.0, upper=0.0) -> torch.Tensor:
        if payoff not in PAYOFFS:
            raise ValidationError(f"payoff must be one of {PAYOFFS}, got {payoff!r}")
        head = self._head.copy()
        head[_P_K] = float(strike)
        if "double" in payoff or payoff == "range_accrual":
            if not 0.0 < float(lower) < float(upper):
                raise ValidationError("double/range kinds need 0 < lower < upper")
            head[_P_BARRIER] = math.log(float(lower) / self.spot)
            head[_P_BARRIER2] = math.log(float(upper) / self.spot)
        elif payoff.startswith("barrier") or "touch" in payoff:
            if float(barrier) <= 0.0:
                raise ValidationError("barrier level must be positive")
            head[_P_BARRIER] = math.log(float(barrier) / self.spot)
        vec = np.concatenate([head, self.rows.ravel()]).astype(np.float32)
        return torch.tensor(vec, device=self.device)

    def _df(self, payoff: str) -> float:
        return 1.0 if payoff.endswith("_hit") else math.exp(-self.rate * self.t_total)

    def _launch(self, p, *, seed, **kw) -> torch.Tensor:
        return _dispatch(_lv_cuda, _lv_plain, self.device, seed, 0, p, n_steps=self.n_steps, **kw)

    def price(self, strike, cp: float = 1.0, payoff: str = "european", barrier: float = 0.0,
              n_paths: int = 1_000_000, seed: int = 0, sampler: str = "prng",
              lower: float = 0.0, upper: float = 0.0):
        """(price, stderr, actual_paths) of one contract on the fitted table,
        price and stderr float32 tensors on the pricer's device. Barriers
        monitor discretely at every step; ``sampler="sobol_bb"`` is the
        8-level hybrid bridge QMC (``n_steps >= 2``) with the 8-replicate
        randomized-QMC stderr."""
        p = self._params(strike, payoff, barrier, lower, upper)
        n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
        pay, pay2 = self._launch(p, seed=seed, n_blocks=n_blocks, cp=float(cp), payoff=payoff,
                                 sampler=sampler)
        n = n_blocks * PATHS_PER_BLOCK
        price, se = _mean_stderr(pay, pay2, n, self._df(payoff), sampler)
        return price, se, n

    def greeks(self, strike, cp: float = 1.0, payoff: str = "european", barrier: float = 0.0,
               n_paths: int = 1_000_000, seed: int = 0, sampler: str = "prng",
               lower: float = 0.0, upper: float = 0.0) -> dict:
        """Price + stderr + likelihood-ratio delta/gamma/vega in the same
        kernel pass, for any payoff.

        delta and gamma are sticky-strike (the surface σ(S, t) fixed in
        physical spot): a spot bump shifts the initial log-state, and only the
        first transition density depends on it; its score carries the
        σ'(x₀) terms (delta exact; gamma drops the second-order σ'/σ'' terms,
        O(dt·skew)). ``vega`` is the parallel shift ∂price/∂ε of σ + ε."""
        p = self._params(strike, payoff, barrier, lower, upper)
        n_blocks = _n_blocks(n_paths, PATHS_PER_BLOCK)
        outs = self._launch(p, seed=seed, n_blocks=n_blocks, cp=float(cp), payoff=payoff,
                            sampler=sampler, greeks=True)
        return self._combine_greeks(outs, n_blocks * PATHS_PER_BLOCK, payoff)

    def _combine_greeks(self, outs: torch.Tensor, n: int, payoff: str) -> dict:
        """Per-row moment sums → the ladder dict (price and stderr float32
        tensors, the Greeks Python floats)."""
        df = self._df(payoff)
        price, se = _mean_stderr(outs[0], outs[1], n, df, "prng")
        # σ and its x-slope at the common start state x = 0, step 0
        c0 = self.rows[0]
        x0c = float(np.clip(0.0, c0[0], c0[1]))
        sig0 = max(float(np.polyval(c0[2:], x0c)), 1e-4)
        dsig0 = float(np.polyval(np.polyder(c0[2:]), x0c))
        sqdt = math.sqrt(self.t_total / self.n_steps)
        m = outs.double().sum(dim=1).cpu().numpy() / n
        m_d, m_g, m_v = m[2], m[3], m[4]
        # first-step score with the σ'(x0) terms of the transition density:
        # z1/(σ0√dt) + (σ0'/σ0)(z1²−1) − σ0'√dt·z1, on the same moments
        delta = (df / self.spot) * (m_d / (sig0 * sqdt) + dsig0 / sig0 * m_g
                                    - dsig0 * sqdt * m_d)
        gamma = df * m_g / (self.spot * sig0 * sqdt) ** 2 - delta / self.spot
        if payoff.startswith("lookback"):
            # the boundary terms of the extremum's start-state dependence
            delta = delta + df * m[5]
            gamma = gamma + 2.0 * df * m[6] / (self.spot * sig0 * sqdt)
        return {"price": price, "std_error": se, "delta": float(delta), "gamma": float(gamma),
                "vega": float(df * m_v), "paths": n, "fit_residual": self.fit_residual}


def local_vol_kernel_price(dupire, strike, maturity, cp: float = 1.0, payoff: str = "european",
                           n_paths: int = 1_000_000, n_steps: int = 100, seed: int = 0,
                           sampler: str = "prng", device=None):
    """One-shot price under a Dupire surface on the kernel: fits the table,
    then one launch. ``dupire`` is a
    :class:`~optionslab_tpu_torch.models.local_vol.DupireLocalVol` (or
    anything with ``.surface``, ``.spot``, ``.rate``, ``.dividend``). Returns
    (price, stderr, actual_paths, fit_residual); check the fit residual
    (vols) before trusting the price."""
    pricer = LocalVolKernelPricer(dupire, maturity, n_steps, device=device)
    price, se, n = pricer.price(strike, cp=cp, payoff=payoff, n_paths=n_paths, seed=seed,
                                sampler=sampler)
    return price, se, n, pricer.fit_residual
