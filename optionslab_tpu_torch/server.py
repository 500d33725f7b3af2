"""HTTP pricing server over the port, on one device.

Endpoints (POST, JSON body, JSON response), with the request bodies of
``optionslab_tpu.server``:

  /price        {"model": "bs|binomial|heston|bates|vg|nig|merton", contract
                fields...}; "binomial" runs the CRR lattice ("american",
                "n_steps"); "heston", "bates", "vg" and "nig" price by the
                Lewis integral with the optional "heston_params" {v0, kappa,
                theta, sigma, rho}, "bates_params" (the same plus lam, mu_j,
                sigma_j), "vg_params" {sigma, nu, theta} or "nig_params"
                {alpha, beta, delta}; "merton" by its Poisson series with
                "merton_params" {lam, mu_j, sigma_j}
  /batch/price  the same; fields may be lists
  /greeks       {contract fields...}                → full BS Greek ladder
  /iv           {"price": P, contract fields...}    → the implied vol; a
                price outside the no-arbitrage bounds answers 400
  /varswap      {"maturity", "heston_params", "model": "heston|slv"}  → fair
                variance and volatility swap strikes: the Heston closed forms,
                or ("slv", with "mixing", "n_paths", "n_steps", "seed") both
                strikes and their stderrs from one SLV simulation on the
                sample smile
  /american     {"model": "bs|heston|bates|lv|slv|rbergomi", "option_type":
                "put", "n_dates", contract fields, optional n_fit/n_lower/
                n_outer/n_inner/n_grid}             → certified [lower, upper]
                Bermudan bracket: "bs" the GBM grid engine; "heston" the ADI
                slices' bracket ("heston_params"), "bates" the LSM bracket
                with the European control variate ("bates_params"); "lv" the
                Dupire local-vol bracket and "slv" the SLV bracket ("mixing",
                "heston_params") on the sample smile at base vol "vol";
                "rbergomi" the rough-Bergomi bracket ("rbergomi_params");
                n_dates capped at 50 but for "bs"
  /mc           {"n_paths": N, "seed": s, "method": "pallas|xla",
                 contract fields...}                → MC price, stderr and
                Greeks; "pallas" (the default) runs the fused GBM kernel
  /exotic       {"kind": "asian|barrier|lookback|cliquet|one-touch|no-touch|
                 double-barrier|double-touch|autocallable", "greeks": bool,
                 ...}                               → GBM exotics ("model"
                "bs"): ``greeks`` runs the kernel Greek ladders; the
                digital, double and rebate kinds run the exotic kernel; the
                rest the scan engine. "model": "heston|heston-qe|bates|
                bates-qe" runs the Heston exotic kernel (Euler or QE, Bates
                jumps) with the dynamics from the body (v0, kappa, theta,
                sigma_v, rho_sv; lam, mu_j, sigma_j); ``greeks`` the one-pass
                LR ladder (Euler). "model": "lv" prices under a Dupire
                surface built from the sample smile at base vol "vol": the
                local-vol kernel (european/asian/barrier/lookback/touches/
                doubles/range-accrual; ``greeks`` the sticky-strike LR
                ladder), the SLV scan at mixing 0 for autocallable/cliquet.
                "model": "slv" adds Heston dynamics with the body's "mixing":
                the SLV kernel for autocallable/cliquet/range-accrual and for
                ``greeks``, the SLV scan engine otherwise. "american" and the
                other models: 400, not yet ported. An optional "sampler"
                picks the kernel's sampler (default "prng")
  /book/exotic  {"kind": ..., "strikes": [...], "barriers"/"lowers"/
                 "uppers": [...], "greeks": bool}   → a same-kind book in
                one kernel launch, "model" "bs" (the exotic kernel) or
                "heston"|"bates" (the Heston exotic kernel; dynamics and
                "scheme" from the body)
  /basket       {"kind": "basket|basket_geo|rainbow_best|rainbow_worst|
                 spread|basket_asian", "spots", "vols", "corr" or "rho",
                 "weights", "control_variate": bool, "greeks": bool, ...}
                                                    → the multi-asset kernel:
                price (``control_variate`` adds the geometric control
                variate to an arithmetic basket) or, with ``greeks``, the
                per-asset LR ladder; "sampler" prng (default), hash or sobol
                (terminal kinds, the error bar labelled by "stderr_note")
  /xva          {"positions": [{quantity, strike, maturity, option_type,
                 optional kind/barrier/vol}, ...], "spot", "rate", "vol",
                 "hazard", "recovery", optional own_hazard/funding_spread/
                 quantile/dates/paths/collateral_threshold/mpor/seed}
                                                    → the exposure profile
                (EE, PFE, EPE, ...) and CVA (+ DVA, FVA) of a netting set:
                the closed-form GBM engine, or with any position "kind" or a
                "model" heston|bates|slv|rbergomi the AMC regression engine
                ("heston_params"/"bates_params"/"rbergomi_params"/"mixing");
                dates capped at 120, paths at 1,048,576 (AMC 524,288)
  /calibrate    {"underlying_price", "strike_price", "time_to_maturity",
                 "implied_volatility": [...], optional "risk_free_rate",
                 "n_expiry_bins" (4), "n_steps" (400)}
                                                    → per-expiry SVI slices,
                SSVI and the no-arbitrage report of the quote snapshot
                (``surface.calibrate_chain``)
  /health  (GET) → status, device name and device count
  /metrics (GET) → per-endpoint request-latency count/p50/p95/max (ms)

Any other path answers 404 with the list of routes the port has.
"""

from __future__ import annotations

import argparse
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .models.american import american_price_interval
from .models.bates import BatesParams, bates_price
from .models.binomial import binomial_price
from .models.black_scholes import bs_greeks, bs_price
from .models.books import exotic_book_quote
from .models.heston import HestonParams, heston_price
from .models.heston_american import heston_american_bracket
from .models.iv import implied_volatility
from .models.jump_diffusion import MertonJumpDiffusion
from .models.levy import NIGParams, VGParams, nig_price, vg_price
from .models.local_vol import (
    DupireLocalVol,
    local_vol_autocall_price,
    local_vol_cliquet_price,
    sample_smile_iv_fn,
)
from .models.local_vol_american import local_vol_american_bracket
from .models.rbergomi import (
    RBergomiParams,
    rbergomi_autocall_price,
    rbergomi_cliquet_price,
    rbergomi_exotic_price,
)
from .models.rbergomi_american import rbergomi_american_bracket
from .models.slv import SLVModel, slv_swap_strikes
from .models.slv_american import slv_american_bracket
from .models.var_swap import heston_expected_variance, heston_vol_swap_strike
from .models.exotics import (
    AsianOption,
    BarrierOption,
    CliquetOption,
    LookbackOption,
    double_barrier_closed_form,
    double_no_touch_closed_form,
)
from .models.monte_carlo import MCConfig, mc_greeks, mc_price_result
from .ops.exotic_kernel import exotic_kernel_ladder, exotic_price
from .ops.gbm_kernel import gbm_mc_price_greeks
from .ops.local_vol_kernel import LocalVolKernelPricer
from .ops.multi_asset_kernel import KINDS as BASKET_KINDS
from .ops.multi_asset_kernel import multi_asset_kernel_greeks, multi_asset_kernel_price
from .ops.slv_kernel import SLVKernelPricer
from .ops.heston_exotic_kernel import (
    heston_kernel_autocall_lr_greeks,
    heston_kernel_autocall_price,
    heston_kernel_cliquet_lr_greeks,
    heston_kernel_cliquet_price,
    heston_kernel_exotic_lr_greeks,
    heston_kernel_exotic_price,
)
from .risk import (ExoticPosition, Position, amc_dynamics_kwargs, amc_exposure_profile,
                   cva_dva, xva_report)
from .surface.chain_calibration import calibrate_chain
from .types import ContractBatch
from .utils.config import DEFAULT_DTYPE, as_tensors
from .utils.exceptions import ValidationError
from .utils.logging import get_logger
from .utils.timing import Timer, get_timings

logger = get_logger(__name__)

_DEFAULTS = {"spot": 100.0, "strike": 100.0, "maturity": 1.0, "rate": 0.05,
             "vol": 0.2, "dividend": 0.0, "option_type": "call"}


def _contract(body: dict):
    p = {**_DEFAULTS, **body}
    cp = 1.0 if str(p["option_type"]).lower().startswith("c") else -1.0
    return p, cp


def _to_jsonable(x):
    arr = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return arr.item() if arr.ndim == 0 else arr.tolist()


def _bs_args(p: dict, cp: float, device) -> list[torch.Tensor]:
    return as_tensors(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"], cp,
                      p["dividend"], dtype=DEFAULT_DTYPE, device=device)


def _batch(p: dict, device) -> ContractBatch:
    return ContractBatch.make(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"],
                              p["option_type"], p["dividend"], device=device)


PRICE_MODELS = ("bs", "binomial", "heston", "bates", "vg", "nig", "merton")


def handle_price(body: dict, device) -> dict:
    p, cp = _contract(body)
    model = body.get("model", "bs")
    if model == "bs":
        out = bs_price(*_bs_args(p, cp, device))
    elif model == "binomial":
        out = binomial_price(_batch(p, device), american=bool(body.get("american", False)),
                             n_steps=int(body.get("n_steps", 512)))
    elif model == "heston":
        params = HestonParams.make(**body.get("heston_params", {}), device=device)
        out = heston_price(_batch(p, device), params)
    elif model == "bates":
        params = BatesParams.make(**body.get("bates_params", {}), device=device)
        out = bates_price(_batch(p, device), params)
    elif model == "vg":
        out = vg_price(_batch(p, device), VGParams.make(**body.get("vg_params", {}),
                                                        device=device))
    elif model == "nig":
        out = nig_price(_batch(p, device), NIGParams.make(**body.get("nig_params", {}),
                                                          device=device))
    elif model == "merton":
        jd = MertonJumpDiffusion(**body.get("merton_params", {}), device=device)
        out = jd.price(p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"],
                       p["option_type"], p["dividend"])
    else:
        raise ValidationError(f"unknown model {model!r}; available: {list(PRICE_MODELS)}")
    return {"model": model, "price": _to_jsonable(out)}


def handle_iv(body: dict, device) -> dict:
    p, _ = _contract(body)
    iv = implied_volatility(float(body["price"]), p["spot"], p["strike"], p["maturity"],
                            p["rate"], p["option_type"], p["dividend"], device=device)
    return {"implied_vol": _to_jsonable(iv)}


def handle_varswap(body: dict, device) -> dict:
    """Fair variance and volatility swap strikes, with the request body and
    answer keys of the JAX package's ``/varswap``: the Heston closed forms
    (default), or with ``model`` "slv" both strikes from one SLV simulation
    on the sample smile at ``mixing``."""
    params = HestonParams.make(**body.get("heston_params", {}), device=device)
    t = float(body.get("maturity", 1.0))
    if str(body.get("model", "heston")).lower() == "slv":
        dup = DupireLocalVol(sample_smile_iv_fn(base_vol=float(body.get("vol", 0.2)), skew=-0.06,
                                                smile=0.03),
                             float(body.get("spot", 100.0)), float(body.get("rate", 0.03)),
                             k_range=(-2.5, 2.5), n_k=201, device=device)
        mixing = float(body.get("mixing", 1.0))
        gen = torch.Generator(device=device).manual_seed(int(body.get("seed", 0)))
        kv, sv, kvol, svol = slv_swap_strikes(
            dup.spot, t, dup.rate, params, gen, dup.surface.k_grid, dup.surface.t_grid,
            dup.surface.grid, mixing=mixing,
            n_paths=min(int(body.get("n_paths", 65_536)), 1_000_000),
            n_steps=min(int(body.get("n_steps", 64)), 256))
        return {"model": "slv", "mixing": mixing, "variance_strike": _to_jsonable(kv),
                "variance_stderr": _to_jsonable(sv), "vol_strike": _to_jsonable(kvol),
                "vol_stderr": _to_jsonable(svol)}
    return {"variance_strike": _to_jsonable(heston_expected_variance(params, t)),
            "vol_strike": _to_jsonable(heston_vol_swap_strike(params, t))}


AMERICAN_MODELS = ("bs", "heston", "bates", "lv", "slv", "rbergomi")


def handle_american(body: dict, device) -> dict:
    """The certified Bermudan bracket, with the request body, defaults, caps
    and answer keys of the JAX package's ``/american``: ``model`` "bs" the
    GBM grid engine, "heston" the ADI slices' bracket, "bates" the LSM
    bracket with the European control variate, "lv" and "slv" the smile
    brackets on the sample smile, "rbergomi" the rough-Bergomi bracket; the
    MC and grid sizes from the body, each capped at 1,000,000, and n_dates
    at 50 but for "bs"."""
    model = _check_model({"model": str(body.get("model", "bs")).lower()}, "/american",
                         AMERICAN_MODELS)
    p, cp = _contract(body)
    n_dates = int(body.get("n_dates", 25))
    sizes = {k: min(int(body[k]), 1_000_000)
             for k in ("n_fit", "n_lower", "n_outer", "n_inner", "n_grid") if k in body}
    kw = {k: v for k, v in sizes.items() if k != "n_grid"}
    if model in ("heston", "bates"):
        if model == "bates":
            par = BatesParams.make(**body.get("bates_params", {}), device=device)
            # the ADI grid is diffusion-only: jumps certify by LSM and the dual
            kw.update(method="lsm", use_cv=True)
        else:
            par = HestonParams.make(**body.get("heston_params", {}), device=device)
            kw.update(method="adi")
        out = heston_american_bracket(p["spot"], p["strike"], p["maturity"], p["rate"], par,
                                      cp=cp, n_dates=min(n_dates, 50), device=device, **kw)
    elif model in ("lv", "slv"):
        dup = DupireLocalVol(sample_smile_iv_fn(base_vol=p["vol"]), p["spot"], p["rate"],
                             device=device)
        if model == "lv":
            kw = {k: v for k, v in sizes.items() if k in ("n_outer", "n_inner")}
            out = local_vol_american_bracket(dup, p["strike"], p["maturity"], cp=cp,
                                             n_dates=min(n_dates, 50), device=device, **kw)
        else:
            par = HestonParams.make(**body.get("heston_params", {}), device=device)
            out = slv_american_bracket(dup, par, p["strike"], p["maturity"], cp=cp,
                                       mixing=float(body.get("mixing", 1.0)),
                                       n_dates=min(n_dates, 50), **kw)
    elif model == "rbergomi":
        par = RBergomiParams(**body.get("rbergomi_params", {}))
        out = rbergomi_american_bracket(p["spot"], p["strike"], p["maturity"], p["rate"], par,
                                        cp=cp, n_dates=min(n_dates, 50), device=device, **kw)
    else:
        out = american_price_interval(p["spot"], p["strike"], p["maturity"], p["rate"],
                                      p["vol"], cp=cp, n_dates=n_dates, method="grid",
                                      device=device, **sizes)
    return {k: _to_jsonable(v) for k, v in out.items()}


def handle_greeks(body: dict, device) -> dict:
    p, cp = _contract(body)
    return {k: _to_jsonable(v) for k, v in bs_greeks(*_bs_args(p, cp, device)).items()}


def handle_mc(body: dict, device) -> dict:
    p, _ = _contract(body)
    n_paths = int(body.get("n_paths", 1_000_000))
    seed = int(body.get("seed", 0))
    batch = _batch(p, device)
    method = body.get("method", "pallas")
    if method == "pallas":
        out = gbm_mc_price_greeks(batch, n_paths=n_paths, seed=seed)
        return {k: _to_jsonable(v) for k, v in out.items()}
    if method != "xla":
        raise ValidationError(f"unknown method {method!r}; available: ['pallas', 'xla']")
    cfg = MCConfig(n_paths=n_paths)
    gen = torch.Generator(device=device)
    res = mc_price_result(batch, gen.manual_seed(seed), cfg)
    g = mc_greeks(batch, gen.manual_seed(seed), cfg)
    return {"price": _to_jsonable(res.price), "std_error": _to_jsonable(res.std_error),
            **{k: _to_jsonable(v) for k, v in g.items() if k != "price"}}


EXOTIC_KINDS = ("asian", "barrier", "lookback", "cliquet", "one-touch", "no-touch",
                "double-barrier", "double-touch", "autocallable")


EXOTIC_MODELS = ("bs", "heston", "heston-qe", "bates", "bates-qe", "lv", "slv", "rbergomi")


def _check_model(body: dict, route: str, models) -> str:
    model = str(body.get("model", "bs"))
    if model not in models:
        raise ValidationError(f"{route} model {model!r} is not yet ported; available: "
                              f"{list(models)}")
    return model


def _dynamics(body: dict, model: str, device):
    """HestonParams, or BatesParams for a "bates" model, from the body keys
    v0, kappa, theta, sigma_v, rho_sv (+ lam, mu_j, sigma_j)."""
    heston = (float(body.get("v0", 0.04)), float(body.get("kappa", 2.0)),
              float(body.get("theta", 0.04)), float(body.get("sigma_v", 0.3)),
              float(body.get("rho_sv", -0.7)))
    if model.startswith("bates"):
        return BatesParams.make(*heston, lam=float(body.get("lam", 0.5)),
                                mu_j=float(body.get("mu_j", -0.1)),
                                sigma_j=float(body.get("sigma_j", 0.15)), device=device)
    return HestonParams.make(*heston, device=device)


def handle_exotic(body: dict, device) -> dict:
    """Exotics, with the request bodies and answer keys of the JAX package's
    ``/exotic``: GBM (``model`` "bs") or Heston/Bates."""
    model = _check_model(body, "/exotic", EXOTIC_MODELS)
    p, cp = _contract(body)
    if model == "lv":
        return _exotic_lv(body, p, cp, device)
    if model == "slv":
        return _exotic_slv(body, p, cp, device)
    if model == "rbergomi":
        return _exotic_rbergomi(body, p, cp, device)
    if model != "bs":
        return _exotic_heston(body, p, cp, model, device)
    kind = body.get("kind", "asian")
    if kind not in EXOTIC_KINDS:
        raise ValidationError(f"/exotic kind {kind!r} is not yet ported; available: "
                              f"{list(EXOTIC_KINDS)}")
    n_paths = int(body.get("n_paths", 100_000))
    n_steps = int(body.get("n_steps", 64))
    seed = int(body.get("seed", 0))
    sampler = body.get("sampler")
    kw = dict(n_paths=n_paths, n_steps=n_steps, seed=seed,
              sampler="prng" if sampler is None else str(sampler), device=device)
    common = (p["spot"], p["strike"], p["maturity"], p["rate"], p["vol"])
    if body.get("greeks"):
        btype = body.get("barrier_type", "up-and-out")
        if kind == "double-barrier":
            btype = body.get("knock", "out")
        elif kind == "double-touch":
            btype = body.get("touch", "no")
        return exotic_kernel_ladder(
            kind, *common, cp, p["dividend"], barrier=float(body.get("barrier", 120.0)),
            barrier_type=btype, lower=float(body.get("lower", 0.0)),
            upper=float(body.get("upper", 0.0)),
            averaging=body.get("averaging", "arithmetic"),
            floating=bool(body.get("floating", True)), pay=str(body.get("pay", "expiry")),
            **{**kw, "sampler": sampler})
    if kind in ("double-barrier", "double-touch"):
        return _exotic_double(body, p, cp, kind, common, kw)
    if kind in ("one-touch", "no-touch"):
        barrier = float(body.get("barrier", 120.0))
        pay = str(body.get("pay", "expiry"))
        if pay == "hit" and kind == "no-touch":
            raise ValidationError("a no-touch pays at expiry by definition")
        side = "up" if barrier >= p["spot"] else "down"
        kname = f"{kind.replace('-', '_')}_{side}" + ("_hit" if pay == "hit" else "")
        pr, se, n = exotic_price(kname, *common, barrier=barrier, **kw)
        return {"kind": kname, "price": _to_jsonable(pr), "std_error": _to_jsonable(se),
                "paths": int(n),
                "pays": "unit cash at the first hit" if pay == "hit" else "unit cash at expiry"}
    if kind == "barrier" and float(body.get("rebate", 0.0)):
        barrier = float(body.get("barrier", 120.0))
        btype = body.get("barrier_type", "up-and-out")
        rebate = float(body["rebate"])
        pr, se, n = exotic_price(f"barrier_{btype}", *common, cp, p["dividend"],
                                 barrier=barrier, **kw)
        side = "up" if barrier >= p["spot"] else "down"
        out_leg = btype.endswith("out")
        leg_kind = f"one_touch_{side}_hit" if out_leg else f"no_touch_{side}"
        leg, se_l, _ = exotic_price(leg_kind, *common, cp, p["dividend"], barrier=barrier, **kw)
        return {"kind": f"barrier_{btype}", "price": float(pr) + rebate * float(leg),
                "std_error": float(np.hypot(float(se), rebate * float(se_l))), "paths": int(n),
                "rebate": rebate,
                "rebate_pays": "at first hit" if out_leg else "at expiry if never knocked in"}
    if kind == "asian" and body.get("control_variate"):
        pr, se, n = exotic_price("asian_arith", *common, cp, p["dividend"],
                                 control_variate=True, **kw)
        return {"kind": kind, "price": _to_jsonable(pr), "std_error": _to_jsonable(se),
                "paths": int(n), "control_variate": "geometric"}
    if kind == "autocallable":
        raise ValidationError("/exotic prices an autocallable with greeks: true (the kernel "
                              "LR ladder); the price-only branch has no autocallable")
    scan = dict(n_paths=n_paths, device=str(device))
    if kind == "asian":
        opt = AsianOption(*common, option_type=p["option_type"],
                          averaging=body.get("averaging", "arithmetic"), **scan)
    elif kind == "barrier":
        opt = BarrierOption(p["spot"], p["strike"], float(body.get("barrier", 120.0)),
                            p["maturity"], p["rate"], p["vol"], option_type=p["option_type"],
                            barrier_type=body.get("barrier_type", "up-and-out"),
                            continuous=bool(body.get("continuous", False)), **scan)
    elif kind == "lookback":
        opt = LookbackOption(*common, option_type=p["option_type"],
                             floating=bool(body.get("floating", True)), **scan)
    else:  # cliquet
        opt = CliquetOption(p["spot"], p["maturity"], p["rate"], p["vol"], **scan)
    price, se = opt.price(return_stderr=True)
    return {"kind": kind, "price": _to_jsonable(price), "std_error": _to_jsonable(se)}


def _exotic_double(body: dict, p: dict, cp: float, kind: str, common: tuple, kw: dict) -> dict:
    """Double barriers and double touches on the exotic kernel, with the
    continuously monitored closed form beside the discretely monitored price."""
    lower = float(body.get("lower", 90.0))
    upper = float(body.get("upper", 110.0))
    pay = str(body.get("pay", "expiry"))
    rebate = float(body.get("rebate", 0.0))
    if kind == "double-barrier":
        knock = body.get("knock", "out")
        kname = f"barrier_double-{knock}"
        cf = double_barrier_closed_form(p["spot"], p["strike"], lower, upper, p["maturity"],
                                        p["rate"], p["vol"], cp, p["dividend"], knock=knock)
    else:
        touch = body.get("touch", "no")
        if pay == "hit" and touch != "one":
            raise ValidationError("a no-touch pays at expiry by definition")
        kname = "one_touch_double_hit" if pay == "hit" else f"{touch}_touch_double"
        dnt = double_no_touch_closed_form(p["spot"], lower, upper, p["maturity"], p["rate"],
                                          p["vol"], p["dividend"])
        cf = dnt if touch == "no" else math.exp(-p["rate"] * p["maturity"]) - float(dnt)
        if pay == "hit":
            cf = None
    pr, se, n = exotic_price(kname, *common, cp, p["dividend"], lower=lower, upper=upper, **kw)
    extra = {}
    if kind == "double-barrier" and rebate:
        leg_kind = "one_touch_double_hit" if kname.endswith("out") else "no_touch_double"
        leg, se_l, _ = exotic_price(leg_kind, *common, cp, p["dividend"], lower=lower,
                                    upper=upper, **kw)
        pr = float(pr) + rebate * float(leg)
        se = float(np.hypot(float(se), rebate * float(se_l)))
        extra = {"rebate": rebate, "rebate_pays": ("at first hit" if kname.endswith("out")
                                                   else "at expiry if never knocked in")}
    return {"kind": kname, "price": _to_jsonable(pr), "std_error": _to_jsonable(se),
            "paths": int(n), "band": [lower, upper], **extra,
            "closed_form_continuous": None if cf is None else _to_jsonable(cf)}


def _exotic_heston(body: dict, p: dict, cp: float, model: str, device) -> dict:
    """``model`` heston[-qe] | bates[-qe]: exotics under stochastic vol (and
    compound-Poisson jumps) on the Heston exotic kernel, with the body and
    answer keys of the JAX package's ``_exotic_heston``; ``greeks`` adds the
    one-pass joint-density LR ladder (Euler)."""
    kind = body.get("kind", "asian")
    par = _dynamics(body, model, device)
    scheme = "qe" if model.endswith("-qe") else "euler"
    sampler = body.get("sampler")
    kw = dict(n_paths=int(body.get("n_paths", 100_000)), n_steps=int(body.get("n_steps", 64)),
              seed=int(body.get("seed", 0)), sampler="prng" if sampler is None else str(sampler),
              device=device)
    base = {"model": model, "scheme": scheme,
            "dynamics": "bates" if model.startswith("bates") else "heston"}
    greeks = bool(body.get("greeks"))
    if greeks and scheme != "euler":
        raise ValidationError("greeks under heston use the Euler LR ladder; drop -qe")
    ladder = {"greek_method": "lr-joint-density", "vega_convention": "2*sqrt(v0)*vega_v0"}
    if kind in ("autocallable", "cliquet"):
        if kind == "autocallable":
            skw = dict(n_obs=int(body.get("n_obs", 4)),
                       coupon_rate=float(body.get("coupon_rate", 0.08)))
        else:
            skw = dict(n_periods=int(body.get("n_periods", 4)),
                       local_floor=float(body.get("local_floor", -0.05)),
                       local_cap=float(body.get("local_cap", 0.05)))
        args = (p["spot"], p["maturity"], p["rate"], par)
        if greeks:
            fn = (heston_kernel_autocall_lr_greeks if kind == "autocallable"
                  else heston_kernel_cliquet_lr_greeks)
            res = {k: _to_jsonable(v) for k, v in fn(*args, **skw, **kw).items()}
            return {**res, **base, "kind": kind, **ladder}
        fn = heston_kernel_autocall_price if kind == "autocallable" else heston_kernel_cliquet_price
        pr, se, n = fn(*args, scheme=scheme, **skw, **kw)
        return {**base, "kind": kind, "price": _to_jsonable(pr), "std_error": _to_jsonable(se),
                "paths": int(n)}
    barrier = float(body.get("barrier", 120.0))
    pay = str(body.get("pay", "expiry"))
    band = {}
    if kind in ("one-touch", "no-touch"):
        if pay == "hit" and kind == "no-touch":
            raise ValidationError("a no-touch pays at expiry by definition")
        side = "up" if barrier >= p["spot"] else "down"
        kname = f"{kind.replace('-', '_')}_{side}" + ("_hit" if pay == "hit" else "")
    elif kind == "double-barrier":
        kname = f"barrier_double-{body.get('knock', 'out')}"
        band = dict(lower=float(body.get("lower", 90.0)), upper=float(body.get("upper", 110.0)))
    elif kind == "double-touch":
        if pay == "hit":
            if body.get("touch", "no") != "one":
                raise ValidationError("a no-touch pays at expiry by definition")
            kname = "one_touch_double_hit"
        else:
            kname = f"{body.get('touch', 'no')}_touch_double"
        band = dict(lower=float(body.get("lower", 90.0)), upper=float(body.get("upper", 110.0)))
    elif kind == "asian":
        kname = "asian_arith"
    elif kind == "lookback":
        kname = "lookback_float"
    elif kind == "barrier":
        kname = f"barrier_{body.get('barrier_type', 'up-and-out')}"
    else:
        raise ValidationError(f"model={model} supports asian/barrier/lookback/one-touch/no-touch/"
                              f"double-barrier/double-touch/autocallable/cliquet, not {kind!r}")
    args = (kname, p["spot"], p["strike"], p["maturity"], p["rate"], par, cp)
    if greeks:
        out = heston_kernel_exotic_lr_greeks(*args, barrier=barrier, **band, **kw)
        res = {k: _to_jsonable(v) for k, v in out.items()}
        return {**res, **base, "kind": kname, **ladder}
    pr, se, n = heston_kernel_exotic_price(*args, barrier=barrier, scheme=scheme, **band, **kw)
    return {**base, "kind": kname, "price": _to_jsonable(pr), "std_error": _to_jsonable(se),
            "paths": int(n)}


def _exotic_rbergomi(body: dict, p: dict, cp: float, device) -> dict:
    """``model`` rbergomi: exotics under rough volatility on the exact
    Volterra law, with the body and answer keys of the JAX package's
    ``_exotic_rbergomi`` (hurst, eta, rho_sv, xi0; "seed", "n_steps")."""
    kind = body.get("kind", "asian")
    n_paths = int(body.get("n_paths", 100_000))
    n_steps = int(body.get("n_steps", 64))
    par = RBergomiParams(hurst=float(body.get("hurst", 0.1)), eta=float(body.get("eta", 1.9)),
                         rho=float(body.get("rho_sv", -0.9)), xi0=float(body.get("xi0", 0.04)))
    gen = torch.Generator(device=device).manual_seed(int(body.get("seed", 0)))
    base = {"model": "rbergomi", "dynamics": "rough-bergomi"}
    if kind in ("autocallable", "cliquet"):
        if kind == "autocallable":
            pr, se = rbergomi_autocall_price(p["spot"], p["maturity"], p["rate"], par, gen,
                                             n_obs=int(body.get("n_obs", 4)), n_paths=n_paths,
                                             n_steps=n_steps, return_stderr=True)
        else:
            pr, se = rbergomi_cliquet_price(p["spot"], p["maturity"], p["rate"], par, gen,
                                            n_periods=int(body.get("n_periods", 8)),
                                            n_paths=n_paths, n_steps=n_steps,
                                            return_stderr=True)
        return {**base, "kind": kind, "price": _to_jsonable(pr), "std_error": _to_jsonable(se)}
    kind_map = {"asian": "asian_arith", "lookback": "lookback_float",
                "barrier": f"barrier_{body.get('barrier_type', 'up-and-out')}"}
    kname, barrier, band = _smile_kind(body, p, kind, "rbergomi", kind_map)
    if band is not None:  # the double kinds take (lower, upper)
        barrier = band
    pr, se = rbergomi_exotic_price(kname, p["spot"], p["strike"], p["maturity"], p["rate"], par,
                                   gen, cp, barrier=barrier, n_paths=n_paths, n_steps=n_steps,
                                   return_stderr=True)
    return {**base, "kind": kname, "price": _to_jsonable(pr), "std_error": _to_jsonable(se)}


def _smile_kind(body: dict, p: dict, kind: str, model: str, kind_map: dict):
    """(kind name, barrier, band) of a non-structured ``/exotic`` kind of the
    lv, slv and rbergomi models; the band (lower, upper) of the double kinds
    and the range accrual (lv only), else None."""
    barrier = float(body.get("barrier", 120.0))
    pay = str(body.get("pay", "expiry"))
    band = (float(body.get("lower", 90.0)), float(body.get("upper", 110.0)))
    if kind in ("one-touch", "no-touch"):
        if pay == "hit" and kind == "no-touch":
            raise ValidationError("a no-touch pays at expiry by definition")
        side = "up" if barrier >= p["spot"] else "down"
        return f"{kind.replace('-', '_')}_{side}" + ("_hit" if pay == "hit" else ""), barrier, None
    if kind == "double-barrier":
        return f"barrier_double-{body.get('knock', 'out')}", barrier, band
    if kind == "double-touch":
        if pay == "hit":
            if body.get("touch", "no") != "one":
                raise ValidationError("a no-touch pays at expiry by definition")
            return "one_touch_double_hit", barrier, band
        return f"{body.get('touch', 'no')}_touch_double", barrier, band
    if kind == "range-accrual" and model == "lv":
        return "range_accrual", barrier, band
    if kind in kind_map:
        return kind_map[kind], barrier, None
    raise ValidationError(f"model={model} supports {'/'.join(kind_map)}/one-touch/no-touch/"
                          f"double-barrier/double-touch/range-accrual/cliquet/autocallable, "
                          f"not {kind!r}")


def _exotic_lv(body: dict, p: dict, cp: float, device) -> dict:
    """``model`` lv: smile-consistent exotics under the Dupire local vol of
    the sample smile at base vol ``vol``, with the body and answer keys of
    the JAX package's ``_exotic_lv``: the local-vol kernel (``greeks``: the
    one-pass LR ladder, sticky-strike delta/gamma, parallel-shift vega); the
    autocallable and cliquet by the SLV scan at mixing 0 (pure local vol)."""
    kind = body.get("kind", "asian")
    seed = int(body.get("seed", 0))
    n_paths = int(body.get("n_paths", 100_000))
    n_steps = int(body.get("n_steps", 64))
    dup = DupireLocalVol(sample_smile_iv_fn(base_vol=float(p["vol"])), p["spot"], p["rate"],
                         device=device)
    base = {"model": "lv", "dynamics": "dupire-local-vol"}
    if kind in ("autocallable", "cliquet"):
        kw = dict(n_paths=n_paths, n_steps=n_steps, seed=seed, return_stderr=True)
        if kind == "autocallable":
            pr, se = local_vol_autocall_price(dup, p["maturity"], n_obs=int(body.get("n_obs", 4)),
                                              **kw)
        else:
            pr, se = local_vol_cliquet_price(dup, p["maturity"],
                                             n_periods=int(body.get("n_periods", 8)), **kw)
        return {**base, "kind": kind, "engine": "slv-scan-mixing0", "price": _to_jsonable(pr),
                "std_error": _to_jsonable(se)}
    kname, barrier, band = _smile_kind(body, p, kind, "lv", {
        "european": "european", "asian": "asian", "lookback": "lookback_float",
        "barrier": f"barrier_{body.get('barrier_type', 'up-and-out')}"})
    band = {} if band is None else dict(lower=band[0], upper=band[1])
    pricer = LocalVolKernelPricer(dup, p["maturity"], n_steps=n_steps)
    sampler = body.get("sampler")
    kw = dict(cp=cp, payoff=kname, barrier=barrier, n_paths=n_paths, seed=seed,
              sampler="prng" if sampler is None else str(sampler), **band)
    base.update(kind=kname, engine="kernel")
    # the LV pricer quotes the range accrual on unit notional; the wire
    # convention is notional 100 (the GBM and Heston routes')
    scale = float(body.get("notional", 100.0)) if kname == "range_accrual" else 1.0
    if body.get("greeks"):
        out = pricer.greeks(p["strike"], **kw)
        res = {k: _to_jsonable(scale * v if k in ("price", "std_error", "delta", "gamma", "vega")
                               else v) for k, v in out.items()}
        return {**res, **base, "greek_method": "lr-sticky-strike",
                "vega_convention": "parallel surface shift"}
    pr, se, n = pricer.price(p["strike"], **kw)
    return {**base, "price": _to_jsonable(scale * pr), "std_error": _to_jsonable(scale * se),
            "paths": int(n), "fit_residual": float(pricer.fit_residual)}


def _exotic_slv(body: dict, p: dict, cp: float, device) -> dict:
    """``model`` slv: Heston dynamics × the Dupire leverage of the sample
    smile, ``mixing`` in [0, 1], with the body and answer keys of the JAX
    package's ``_exotic_slv``: the SLV kernel for the structured kinds and
    for ``greeks`` (the one-pass LR ladder), the SLV scan engine (calibrate
    and price in one particle loop) for the other prices."""
    kind = body.get("kind", "asian")
    seed = int(body.get("seed", 0))
    n_paths = int(body.get("n_paths", 100_000))
    n_steps = int(body.get("n_steps", 64))
    dup = DupireLocalVol(sample_smile_iv_fn(base_vol=float(p["vol"])), p["spot"], p["rate"],
                         device=device)
    par = HestonParams.make(float(body.get("v0", 0.04)), float(body.get("kappa", 2.0)),
                            float(body.get("theta", 0.04)), float(body.get("sigma_v", 0.5)),
                            float(body.get("rho_sv", -0.7)), device=device)
    mixing = float(body.get("mixing", 1.0))
    sampler = body.get("sampler")
    kw = dict(n_paths=n_paths, seed=seed, sampler="prng" if sampler is None else str(sampler))
    base = {"model": "slv", "dynamics": "heston-x-dupire-leverage", "mixing": mixing}

    def jsonable(out):
        return {k: v if isinstance(v, (str, int)) else _to_jsonable(v) for k, v in out.items()}

    if kind in ("autocallable", "cliquet", "range-accrual"):
        pricer = SLVKernelPricer(dup, par, p["maturity"], mixing=mixing, n_steps=n_steps)
        if kind == "range-accrual":
            fn = pricer.range_accrual
            skw = dict(lower=float(body.get("lower", 90.0)), upper=float(body.get("upper", 110.0)),
                       notional=float(body.get("notional", 100.0)))
        elif kind == "autocallable":
            fn, skw = pricer.autocall, dict(n_obs=int(body.get("n_obs", 4)))
        else:
            fn, skw = pricer.cliquet, dict(n_periods=int(body.get("n_periods", 8)))
        base.update(kind=kind, engine="kernel")
        if body.get("greeks"):
            return {**jsonable(fn(**skw, **kw, greeks=True)), **base,
                    "greek_method": "lr-joint-density"}
        pr, se, n = fn(**skw, **kw)
        return {**base, "price": _to_jsonable(pr), "std_error": _to_jsonable(se), "paths": int(n)}
    kname, barrier, band = _smile_kind(body, p, kind, "slv", {
        "asian": "asian_arith", "lookback": "lookback_float",
        "barrier": f"barrier_{body.get('barrier_type', 'up-and-out')}"})
    if body.get("greeks"):
        pricer = SLVKernelPricer(dup, par, p["maturity"], mixing=mixing, n_steps=n_steps)
        bkw = dict(barrier=barrier) if band is None else dict(lower=band[0], upper=band[1])
        out = pricer.greeks(kname, p["strike"], cp=cp, **bkw, **kw)
        return {**jsonable(out), **base, "kind": kname, "greek_method": "lr-joint-density"}
    gen = torch.Generator(device=device).manual_seed(seed)
    pr, se = SLVModel(dup, par, mixing=mixing).price(
        kname, p["strike"], p["maturity"], gen, cp=cp,
        barrier=barrier if band is None else band, n_paths=n_paths, n_steps=n_steps,
        return_stderr=True)
    return {**base, "kind": kname, "price": _to_jsonable(pr), "std_error": _to_jsonable(se)}


def handle_book(body: dict, device) -> dict:
    """A same-kind contract book in one kernel launch, with the request body
    of the JAX package's ``/book/exotic`` (``model`` bs|heston|bates)."""
    model = _check_model(body, "/book/exotic", ("bs", "heston", "bates"))
    params = None if model == "bs" else _dynamics(body, model, device)

    def lst(name):
        v = body.get(name)
        return [float(x) for x in v] if v else None

    sampler = body.get("sampler")
    return exotic_book_quote(
        str(body.get("kind", "asian")), float(body.get("spot", 100.0)),
        [float(s) for s in body.get("strikes", [100.0])], float(body.get("maturity", 1.0)),
        float(body.get("rate", 0.05)), vol=float(body.get("vol", 0.2)), model=model,
        params=params, cp=1.0 if str(body.get("type", "call")).startswith("c") else -1.0,
        dividend=float(body.get("dividend", 0.0)), barriers=lst("barriers"),
        lowers=lst("lowers"), uppers=lst("uppers"), greeks=bool(body.get("greeks", False)),
        n_paths=int(body.get("n_paths", 200_000)), n_steps=int(body.get("n_steps", 64)),
        seed=int(body.get("seed", 0)), sampler=None if sampler is None else str(sampler),
        scheme=str(body.get("scheme", "euler")),
        barrier_type=str(body.get("barrier_type", "up-and-out")),
        averaging=str(body.get("averaging", "arithmetic")),
        floating=bool(body.get("floating", True)), knock=str(body.get("knock", "out")),
        touch=str(body.get("touch", "no")), direction=str(body.get("direction", "up")),
        device=device)


def handle_basket(body: dict, device) -> dict:
    """The multi-asset kernel over the wire, with the request body and
    answer keys of the JAX package's ``/basket``: a price (any kind, the
    geometric control variate with ``control_variate``) or the full
    per-asset LR ladder (``greeks``). ``rho`` builds an equicorrelation
    matrix when ``corr`` is absent; ``n_paths`` is capped at 4,000,000."""
    spots = [float(x) for x in body.get("spots", [100.0, 95.0, 105.0])]
    vols = [float(x) for x in body.get("vols", [0.2, 0.25, 0.3])]
    d = len(spots)
    corr = body.get("corr")
    if corr is None:
        corr = np.full((d, d), float(body.get("rho", 0.4)))
        np.fill_diagonal(corr, 1.0)
    kind = str(body.get("kind", "basket"))
    if kind not in BASKET_KINDS:
        raise ValidationError(f"unknown kind {kind!r}; choose {BASKET_KINDS}")
    cp = 1.0 if str(body.get("option_type", "call")).lower().startswith("c") else -1.0
    kw = dict(weights=body.get("weights"), cp=cp,
              n_paths=min(int(body.get("n_paths", 500_000)), 4_000_000),
              n_steps=int(body.get("n_steps", 1)), seed=int(body.get("seed", 0)),
              sampler=str(body.get("sampler", "prng")), device=device)
    args = (kind, spots, float(body.get("strike", 100.0)), float(body.get("maturity", 1.0)),
            float(body.get("rate", 0.05)), vols, corr)
    greeks = bool(body.get("greeks"))
    if greeks:
        out = {k: _to_jsonable(v) for k, v in multi_asset_kernel_greeks(*args, **kw).items()}
    else:
        cv = bool(body.get("control_variate"))
        p, se, n = multi_asset_kernel_price(*args, **kw, control_variate=cv)
        out = {"price": float(p), "std_error": float(se), "paths": int(n)}
        if cv:
            out["control_variate"] = "geometric"
    out.update(kind=kind, sampler=kw["sampler"])
    if kw["sampler"] == "sobol":
        out["stderr_note"] = (
            "QMC: std_error uses the plain-MC formula and is indicative only" if greeks else
            "randomized QMC: std_error is the std of 8 independently scrambled replicates' "
            "means over sqrt(8)")
    return out


def handle_xva(body: dict, device) -> dict:
    """Counterparty exposure + CVA for a netting set, with the request body,
    caps and answer keys of the JAX package's ``/xva``: {"positions":
    [{quantity, strike, maturity, option_type}, ...], "spot", "rate",
    "vol", optional hazard/recovery/own_hazard/funding_spread/quantile/
    dates/paths/collateral_threshold/mpor/seed}; dates capped at 120, paths
    at 1,048,576 on the closed-form engine.

    Any position with a "kind", or any "model" but "bs", routes the whole
    set through the AMC engine (paths capped at 524,288): "model"
    bs|heston|bates|slv|rbergomi picks the exposure dynamics, with
    "heston_params"/"bates_params"/"rbergomi_params"/"mixing" overriding the
    defaults (an override the model cannot consume is a 400). Vol
    precedence there: a position's own "vol" wins; a top-level "vol" sets
    the GBM dynamics only when no position carries one."""
    spot = float(body.get("spot", 100.0))
    rate = float(body.get("rate", 0.05))
    vol = float(body.get("vol", 0.2))
    specs = body.get("positions") or [{}]
    model = str(body.get("model", "bs")).lower()
    if any("kind" in s_ for s_ in specs) or model != "bs":
        book = [ExoticPosition(kind=str(s_.get("kind", "vanilla")),
                               quantity=float(s_.get("quantity", 1.0)),
                               strike=float(s_.get("strike", 100.0)),
                               maturity=float(s_.get("maturity", 1.0)),
                               option_type=str(s_.get("option_type", "call")),
                               barrier=float(s_.get("barrier", 0.0)),
                               vol=float(s_.get("vol", vol)))
                for s_ in specs]
        dyn = amc_dynamics_kwargs(model, spot=spot, rate=rate, vol=vol,
                                  heston_params=body.get("heston_params"),
                                  bates_params=body.get("bates_params"),
                                  rbergomi_params=body.get("rbergomi_params"),
                                  mixing=body.get("mixing", 1.0), device=device)
        prof = amc_exposure_profile(
            book, spot=spot, rate=rate,
            vol=(float(body["vol"]) if "vol" in body and not any("vol" in s_ for s_ in specs)
                 else None),
            n_dates=min(int(body.get("dates", 24)), 120),
            n_paths=min(int(body.get("paths", 65536)), 524_288),
            quantile=float(body.get("quantile", 0.95)), seed=int(body.get("seed", 0)),
            device=device, **dyn)
        out = cva_dva(prof, hazard_rate=float(body.get("hazard", 0.02)),
                      recovery=float(body.get("recovery", 0.4)))
        return {"engine": "amc", "model": model, "dates": [float(t) for t in prof.dates],
                "ee": [float(x) for x in prof.ee], "pfe": [float(x) for x in prof.pfe],
                "epe": prof.epe, "max_pfe": prof.max_pfe,
                **{k: _to_jsonable(v) for k, v in out.items()}}
    book = [Position(quantity=float(s.get("quantity", 1.0)), spot=spot,
                     strike=float(s.get("strike", 100.0)),
                     maturity=float(s.get("maturity", 1.0)), rate=rate,
                     vol=float(s.get("vol", vol)), option_type=str(s.get("option_type", "call")))
            for s in specs]
    thr = body.get("collateral_threshold")
    out = xva_report(
        book, hazard_rate=float(body.get("hazard", 0.02)),
        recovery=float(body.get("recovery", 0.4)),
        funding_spread=float(body["funding_spread"]) if "funding_spread" in body else None,
        own_hazard_rate=float(body["own_hazard"]) if "own_hazard" in body else None,
        n_dates=min(int(body.get("dates", 24)), 120),
        n_paths=min(int(body.get("paths", 65536)), 1_048_576),
        quantile=float(body.get("quantile", 0.95)),
        collateral_threshold=None if thr is None else float(thr),
        mpor=float(body.get("mpor", 0.0)), seed=int(body.get("seed", 0)), device=device)
    return {k: _to_jsonable(v) for k, v in out.items()}


QUOTE_COLUMNS = ("underlying_price", "strike_price", "time_to_maturity", "implied_volatility")


def handle_calibrate(body: dict, device) -> dict:
    """SVI slices, SSVI and the arbitrage report of a quote snapshot passed
    inline as columns (``calibrate_chain``): the four quote columns as lists
    of one length, an optional ``risk_free_rate`` (a number or a list),
    ``n_expiry_bins`` (4) and ``n_steps`` (400). The chain is a column table:
    no pandas."""
    cols = {}
    for name in QUOTE_COLUMNS:
        if name not in body:
            raise ValidationError(f"/calibrate needs the column {name!r}")
        try:
            col = np.asarray(body[name], np.float64)
        except (TypeError, ValueError):
            raise ValidationError(f"/calibrate column {name!r} is not numeric") from None
        if col.ndim != 1:
            raise ValidationError(f"/calibrate column {name!r} must be a list of numbers")
        cols[name] = col
    if len({len(c) for c in cols.values()}) != 1:
        raise ValidationError("/calibrate columns differ in length: "
                              f"{ {k: len(c) for k, c in cols.items()} }")
    if "risk_free_rate" in body:
        try:
            rate = np.asarray(body["risk_free_rate"], np.float64)
        except (TypeError, ValueError):
            raise ValidationError("/calibrate risk_free_rate is not numeric") from None
        cols["risk_free_rate"] = np.broadcast_to(rate, cols["strike_price"].shape).copy()
    res = calibrate_chain(cols, n_expiry_bins=int(body.get("n_expiry_bins", 4)),
                          n_steps=int(body.get("n_steps", 400)), device=device)
    return res.to_dict()


ROUTES = {
    "/basket": handle_basket,
    "/price": handle_price,
    "/greeks": handle_greeks,
    "/mc": handle_mc,
    "/exotic": handle_exotic,
    "/batch/price": handle_price,  # same handler — fields may be lists
    "/book/exotic": handle_book,
    "/iv": handle_iv,
    "/varswap": handle_varswap,
    "/american": handle_american,
    "/xva": handle_xva,
    "/calibrate": handle_calibrate,
}


def _health(device: torch.device) -> dict:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {"status": "ok", "device": str(device), "device_name": name,
            "device_count": count}


def _metrics() -> dict:
    out = {}
    for label, ms in get_timings().items():
        if not label.startswith("http:"):
            continue
        s = sorted(ms)
        n = len(s)
        out[label[5:]] = {
            "count": n,
            "p50_ms": round(s[n // 2], 3),
            "p95_ms": round(s[min(n - 1, int(0.95 * n))], 3),
            "max_ms": round(s[-1], 3),
        }
    return out


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload: dict):
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _unknown(self):
        self._send(404, {"error": f"unknown path {self.path}",
                         "endpoints": sorted(ROUTES) + ["/health", "/metrics"]})

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._send(200, _health(self.server.device))
        elif self.path == "/metrics":
            self._send(200, _metrics())
        else:
            self._unknown()

    def do_POST(self):  # noqa: N802
        handler = ROUTES.get(self.path)
        if handler is None:
            self._unknown()
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            with Timer(f"http:{self.path}"):
                payload = handler(body, self.server.device)
        except (ValueError, KeyError, TypeError) as e:  # bad input (ValidationError too)
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
            return
        except Exception as e:  # keep serving; the traceback goes to the log
            logger.exception("request to %s failed", self.path)
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, payload)

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)


class PricingServer:
    """Embeddable server: ``PricingServer(port, device=...).start()`` /
    ``.stop()``. ``port=0`` picks a free port (read it from ``.port``)."""

    def __init__(self, port: int = 8777, host: str = "127.0.0.1", warm: bool = True,
                 device="cuda"):
        self.device = torch.device(device)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.device = self.device
        self.port = self.httpd.server_address[1]
        self._thread = None
        if warm:
            self.warmup()

    def warmup(self):
        """Run the closed-form routes once on the device before serving."""
        handle_price({"model": "bs"}, self.device)
        handle_greeks({}, self.device)

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        logger.info("pricing server on port %d (%s)", self.port, self.device)
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self):  # pragma: no cover - blocking entry
        logger.info("pricing server on port %d (%s, blocking)", self.port, self.device)
        self.httpd.serve_forever()


def main(argv=None):  # pragma: no cover - CLI entry
    ap = argparse.ArgumentParser(description="optionslab_tpu_torch pricing server")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    PricingServer(args.port, args.host, device=args.device).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
