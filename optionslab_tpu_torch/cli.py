"""Command line of the port: every capability constructible and runnable
through one uniform entry point, with the subcommands, flags, defaults and
JSON keys of ``optionslab_tpu.cli``.

Usage:
    python -m optionslab_tpu_torch.cli price --model bs --spot 100 --strike 100
    python -m optionslab_tpu_torch.cli greeks --spot 100 --vol 0.25
    python -m optionslab_tpu_torch.cli mc --n-paths 1000000 --method pallas
    python -m optionslab_tpu_torch.cli iv --price 10.45
    python -m optionslab_tpu_torch.cli exotic --kind asian
    python -m optionslab_tpu_torch.cli american --type put
    python -m optionslab_tpu_torch.cli basket --kind geometric --rho 0.4
    python -m optionslab_tpu_torch.cli surface --model svi
    python -m optionslab_tpu_torch.cli var --value 1e6
    python -m optionslab_tpu_torch.cli backtest
    python -m optionslab_tpu_torch.cli bench-harness
    python -m optionslab_tpu_torch.cli serve --port 8777
    python -m optionslab_tpu_torch.cli --device cpu info

Every subcommand runs on ``--device`` (``cuda`` unless the caller asks for
``cpu``), with no fallback when there is no card. Where the JAX package
picks a kernel sampler by its backend, the port picks ``prng`` on the card
and ``hash`` on the CPU; its PRNG keys are ``torch.Generator``s on the
device, seeded with ``--seed``. ``export`` writes a ``torch.export``
artifact (``.pt2``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch


def _common_contract_args(p):
    p.add_argument("--spot", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=100.0)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--rate", type=float, default=0.05)
    p.add_argument("--vol", type=float, default=0.2)
    p.add_argument("--dividend", type=float, default=0.0)
    p.add_argument("--type", dest="option_type", default="call", choices=["call", "put"])


def _sampler(args) -> str:
    """The kernels' sampler: ``prng`` on the card, ``hash`` on the CPU."""
    return "prng" if args.device.type == "cuda" else "hash"


def _generator(args, seed: int) -> torch.Generator:
    return torch.Generator(device=args.device).manual_seed(seed)


def _cp(args) -> float:
    return 1.0 if str(args.option_type).lower().startswith("c") else -1.0


def _num(v):
    """A result value as JSON takes it: strings, booleans and integers as
    they are, other numbers and 0-d tensors as floats, arrays and tensors
    as lists."""
    if isinstance(v, (str, bool, int)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if np.ndim(v) > 0:
        return np.asarray(v, np.float64).tolist()
    return float(v)


def _nums(out: dict) -> dict:
    return {k: _num(v) for k, v in out.items()}


def cmd_info(args) -> dict:
    from .utils.config import default_device_kind

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "backend": args.device.type,
        "devices": ([f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(n)]
                    or ["cpu"]),
        "device_kind": default_device_kind(),
        "cuda": torch.version.cuda,
    }


def cmd_price(args) -> dict:
    from .types import ContractBatch

    dev = args.device
    batch = ContractBatch.make(args.spot, args.strike, args.maturity, args.rate,
                               args.vol, args.option_type, args.dividend, device=dev)
    out = {"model": args.model}
    if args.model == "bs":
        from .models import bs_price
        from .utils.config import DEFAULT_DTYPE, as_tensors

        out["price"] = float(bs_price(*as_tensors(
            args.spot, args.strike, args.maturity, args.rate, args.vol,
            1.0 if args.option_type == "call" else -1.0, args.dividend,
            dtype=DEFAULT_DTYPE, device=dev)))
    elif args.model == "binomial":
        from .models import binomial_price

        out["price"] = float(binomial_price(batch, american=args.american, n_steps=args.steps))
    elif args.model == "fdm":
        from .models import fdm_price

        out["price"] = float(fdm_price(batch, american=args.american))
    elif args.model == "heston":
        from .models import HestonParams, heston_fdm_price, heston_price

        if args.american:
            out["price"] = float(heston_fdm_price(
                args.spot, args.strike, args.maturity, args.rate,
                HestonParams.make(device=dev), dividend=args.dividend,
                option_type=args.option_type, american=True, device=dev))
        else:
            out["price"] = float(heston_price(batch, HestonParams.make(device=dev)))
    elif args.model == "bates":
        from .models import BatesParams, bates_price

        out["price"] = float(bates_price(batch, BatesParams.make(device=dev)))
    elif args.model == "vg":
        from .models import VGParams, vg_price

        out["price"] = float(vg_price(batch, VGParams.make(device=dev)))
    elif args.model == "nig":
        from .models import NIGParams, nig_price

        out["price"] = float(nig_price(batch, NIGParams.make(device=dev)))
    elif args.model == "merton":
        from .models import MertonJumpDiffusion

        out["price"] = float(MertonJumpDiffusion(device=dev).price(
            args.spot, args.strike, args.maturity, args.rate, args.vol,
            args.option_type, args.dividend))
    return out


def cmd_greeks(args) -> dict:
    from .models import bs_greeks
    from .utils.config import DEFAULT_DTYPE, as_tensors

    cp = 1.0 if args.option_type == "call" else -1.0
    model = getattr(args, "model", "bs")
    if model.startswith("heston"):
        # kernel ladder: Euler = exact pathwise sensitivities of the
        # scheme; heston-qe = CRN-bump ladder on Andersen-QE
        # (near-unbiased at coarse steps)
        from .models import HestonParams
        from .ops.heston_kernel import heston_kernel_greeks

        par = HestonParams.make(args.v0, args.kappa, args.theta,
                                args.sigma_v, args.rho_sv, device=args.device)
        scheme = "qe" if model == "heston-qe" else "euler"
        out = heston_kernel_greeks(
            args.spot, args.strike, args.maturity, args.rate, par, cp,
            args.dividend, n_paths=args.n_paths, n_steps=args.n_steps,
            seed=args.seed, ladder=True, scheme=scheme, device=args.device)
        res = {k: float(v) for k, v in out.items()}
        res.update(model=model, scheme=scheme,
                   greek_method=("crn-bump-fd" if scheme == "qe"
                                 else "pathwise-in-scheme"))
        return res
    g = bs_greeks(*as_tensors(args.spot, args.strike, args.maturity, args.rate, args.vol, cp,
                              args.dividend, dtype=DEFAULT_DTYPE, device=args.device))
    return {k: float(v) for k, v in g.items()}


def cmd_mc(args) -> dict:
    from .types import ContractBatch

    batch = ContractBatch.make(args.spot, args.strike, args.maturity, args.rate,
                               args.vol, args.option_type, args.dividend, device=args.device)
    if args.method == "pallas":
        from .ops.gbm_kernel import gbm_mc_price_greeks

        out = gbm_mc_price_greeks(batch, n_paths=args.n_paths, seed=args.seed,
                                  sampler=args.sampler)
        return {k: float(v) for k, v in out.items()}
    from .models import MCConfig, MCMethod, mc_greeks, mc_price_result

    cfg = MCConfig(n_paths=args.n_paths, method=MCMethod(args.method))
    res = mc_price_result(batch, _generator(args, args.seed), cfg)
    g = mc_greeks(batch, _generator(args, args.seed), cfg)
    return {"price": float(res.price), "std_error": float(res.std_error),
            **{k: float(v) for k, v in g.items() if k != "price"}}


def cmd_iv(args) -> dict:
    from .models import implied_volatility

    iv = implied_volatility(args.price, args.spot, args.strike, args.maturity,
                            args.rate, args.option_type, args.dividend, device=args.device)
    return {"implied_vol": float(iv)}


def cmd_exotic(args) -> dict:
    if getattr(args, "model", "bs").startswith(("heston", "bates")):
        return _exotic_heston(args)
    if getattr(args, "model", "bs") == "rbergomi":
        return _exotic_rbergomi(args)
    if getattr(args, "model", "bs") == "slv":
        return _exotic_slv(args)
    if getattr(args, "model", "bs") == "lv":
        return _exotic_lv(args)
    if getattr(args, "greeks", False):
        return _exotic_kernel_greeks(args)
    from .ops.exotic_kernel import exotic_price

    dev = args.device
    kw = dict(n_paths=args.n_paths, n_steps=getattr(args, "n_steps", 64), seed=args.seed,
              sampler=_sampler(args), device=dev)
    if getattr(args, "cv", False):
        # Kemna–Vorst geometric CV at kernel speed (asian only)
        from .utils.exceptions import ValidationError

        if args.kind != "asian":
            raise SystemExit("--cv applies to --kind asian")
        try:
            p, se, n = exotic_price(
                "asian_arith", args.spot, args.strike, args.maturity,
                args.rate, args.vol, _cp(args), control_variate=True, **kw)
        except ValidationError as e:
            raise SystemExit(str(e)) from e
        return {"kind": "asian", "price": float(p), "std_error": float(se),
                "paths": int(n), "control_variate": "geometric"}
    from .models import (
        AmericanOptionLSM,
        AsianOption,
        AutocallableNote,
        BarrierOption,
        CliquetOption,
        LookbackOption,
    )

    if args.kind == "range-accrual":
        from .ops.exotic_kernel import range_accrual_price

        p, se, n = range_accrual_price(
            args.spot, args.lower, args.upper, args.maturity, args.rate,
            args.vol, **kw)
        return {"kind": "range_accrual", "price": float(p),
                "std_error": float(se), "paths": int(n),
                "corridor": [args.lower, args.upper]}
    if args.kind in ("double-barrier", "double-touch"):
        # two-sided band at kernel speed; exact continuous-monitoring
        # closed form (image series) reported alongside for reference
        from .models.exotics import double_barrier_closed_form, double_no_touch_closed_form

        cp = _cp(args)
        if args.kind == "double-barrier":
            kname = f"barrier_double-{args.knock}"
            cf = double_barrier_closed_form(
                args.spot, args.strike, args.lower, args.upper,
                args.maturity, args.rate, args.vol, cp, args.dividend,
                knock=args.knock)
        else:
            if args.pay == "hit" and args.touch != "one":
                raise SystemExit("a no-touch pays at expiry by definition")
            kname = ("one_touch_double_hit" if args.pay == "hit"
                     else f"{args.touch}_touch_double")
            dnt = double_no_touch_closed_form(
                args.spot, args.lower, args.upper, args.maturity, args.rate,
                args.vol, args.dividend)
            cf = (float(dnt) if args.touch == "no"
                  else math.exp(-args.rate * args.maturity) - float(dnt))
            if args.pay == "hit":
                cf = None  # no closed form for the first-EXIT-time leg
        p, se, n = exotic_price(
            kname, args.spot, args.strike, args.maturity, args.rate,
            args.vol, cp, args.dividend, lower=args.lower, upper=args.upper,
            **kw)
        extra = {}
        if args.kind == "double-barrier" and args.rebate:
            # KO: rebate at first band exit; KI: rebate at expiry if never
            # knocked in — legs share the kernel's path set (same seed), so
            # the composition is consistent
            leg_kind = "one_touch_double_hit" if args.knock == "out" else "no_touch_double"
            leg, se_l, _ = exotic_price(
                leg_kind, args.spot, args.strike, args.maturity, args.rate, args.vol, cp,
                args.dividend, lower=args.lower, upper=args.upper, **kw)
            p = float(p) + args.rebate * float(leg)
            se = float(np.hypot(float(se), args.rebate * float(se_l)))
            extra = {"rebate": args.rebate,
                     "rebate_pays": ("at first hit" if args.knock == "out"
                                     else "at expiry if never knocked in")}
        return {"kind": kname, "price": float(p), "std_error": float(se),
                "paths": int(n), "band": [args.lower, args.upper], **extra,
                "closed_form_continuous": (None if cf is None
                                           else float(cf)),
                "note": "MC monitors discretely at n_steps; the closed "
                        "form is continuous monitoring (BGK-shift the "
                        "band to reconcile)"}
    if args.kind in ("one-touch", "no-touch"):
        # digital barrier at kernel speed; direction inferred from the
        # barrier's side of the spot. --pay hit: cash AT the first hit
        # (American binary), discounted in-kernel; exact continuous-
        # monitoring closed form reported alongside.
        from .models.exotics import one_touch_closed_form

        if args.pay == "hit" and args.kind == "no-touch":
            raise SystemExit("a no-touch pays at expiry by definition")
        side = "up" if args.barrier >= args.spot else "down"
        kname = f"{args.kind.replace('-', '_')}_{side}"
        if args.pay == "hit":
            kname += "_hit"
        p, se, n = exotic_price(
            kname, args.spot, args.strike, args.maturity, args.rate,
            args.vol, barrier=args.barrier, **kw)
        if args.kind == "one-touch":
            cf = float(one_touch_closed_form(
                args.spot, args.barrier, args.maturity, args.rate,
                args.vol, args.dividend, pay=args.pay))
        else:
            cf = math.exp(-args.rate * args.maturity) - float(
                one_touch_closed_form(args.spot, args.barrier,
                                      args.maturity, args.rate, args.vol,
                                      args.dividend, pay="expiry"))
        return {"kind": kname, "price": float(p), "std_error": float(se),
                "paths": int(n),
                "pays": ("unit cash at the first hit" if args.pay == "hit"
                         else "unit cash at expiry"),
                "closed_form_continuous": cf,
                "note": "MC monitors discretely at n_steps; the closed "
                        "form is continuous monitoring (BGK-shift the "
                        "barrier to reconcile)"}

    if args.kind == "barrier" and args.rebate:
        # market-standard rebate legs on the kernel's shared path set:
        # knock-out pays at the first hit, knock-in at expiry if never in
        cp = _cp(args)
        p, se, n = exotic_price(
            f"barrier_{args.barrier_type}", args.spot, args.strike,
            args.maturity, args.rate, args.vol, cp, args.dividend, barrier=args.barrier, **kw)
        side = "up" if args.barrier >= args.spot else "down"
        out = args.barrier_type.endswith("out")
        leg_kind = (f"one_touch_{side}_hit" if out else f"no_touch_{side}")
        leg, se_l, _ = exotic_price(
            leg_kind, args.spot, args.strike, args.maturity, args.rate,
            args.vol, cp, args.dividend, barrier=args.barrier, **kw)
        return {"kind": f"barrier_{args.barrier_type}",
                "price": float(p) + args.rebate * float(leg),
                "std_error": float(np.hypot(float(se), args.rebate * float(se_l))),
                "paths": int(n), "rebate": args.rebate,
                "rebate_pays": ("at first hit" if out
                                else "at expiry if never knocked in")}
    common = (args.spot, args.strike, args.maturity, args.rate, args.vol)
    scan = dict(n_paths=args.n_paths, device=str(dev))
    if args.kind == "asian":
        opt = AsianOption(*common, option_type=args.option_type, **scan)
    elif args.kind == "barrier":
        opt = BarrierOption(args.spot, args.strike, args.barrier, args.maturity,
                            args.rate, args.vol, option_type=args.option_type,
                            barrier_type=args.barrier_type, **scan)
    elif args.kind == "lookback":
        opt = LookbackOption(*common, option_type=args.option_type, **scan)
    elif args.kind == "american":
        opt = AmericanOptionLSM(*common, option_type=args.option_type, **scan)
    elif args.kind == "autocallable":
        opt = AutocallableNote(args.spot, args.maturity, args.rate, args.vol, **scan)
    else:
        opt = CliquetOption(args.spot, args.maturity, args.rate, args.vol, **scan)
    price, se = opt.price(return_stderr=True)
    return {"kind": args.kind, "price": float(price), "std_error": float(se)}


def _exotic_heston(args) -> dict:
    """--model heston[-qe] | bates[-qe]: exotics priced under stochastic
    vol (optionally + compound-Poisson jumps) on the Heston exotic kernel
    (``ops.heston_exotic_kernel``); --greeks adds the one-pass joint-density
    LR ladder (Euler scheme)."""
    from .models import BatesParams, HestonParams
    from .ops.heston_exotic_kernel import (
        heston_kernel_autocall_lr_greeks,
        heston_kernel_autocall_price,
        heston_kernel_cliquet_lr_greeks,
        heston_kernel_cliquet_price,
        heston_kernel_exotic_lr_greeks,
        heston_kernel_exotic_price,
        heston_kernel_range_accrual_lr_greeks,
        heston_kernel_range_accrual_price,
    )
    from .utils.exceptions import ValidationError

    dev = args.device
    if args.model.startswith("bates"):
        par = BatesParams.make(args.v0, args.kappa, args.theta, args.sigma_v,
                               args.rho_sv, lam=args.lam, mu_j=args.mu_j,
                               sigma_j=args.sigma_j, device=dev)
    else:
        par = HestonParams.make(args.v0, args.kappa, args.theta,
                                args.sigma_v, args.rho_sv, device=dev)
    scheme = "qe" if args.model.endswith("-qe") else "euler"
    cp = _cp(args)
    kw = dict(n_paths=args.n_paths, n_steps=getattr(args, "n_steps", 64),
              seed=args.seed, sampler=_sampler(args), device=dev)
    base = {"model": args.model, "scheme": scheme,
            "dynamics": ("bates" if args.model.startswith("bates")
                         else "heston")}
    greeks = getattr(args, "greeks", False)
    if greeks and scheme != "euler":
        raise SystemExit("--greeks under heston uses the Euler LR ladder; "
                         "drop -qe")
    try:
        if args.kind in ("autocallable", "cliquet"):
            skw = (dict(n_obs=getattr(args, "n_obs", 4))
                   if args.kind == "autocallable"
                   else dict(n_periods=getattr(args, "n_periods", 8)))
            if greeks:
                fn = (heston_kernel_autocall_lr_greeks
                      if args.kind == "autocallable"
                      else heston_kernel_cliquet_lr_greeks)
                out = fn(args.spot, args.maturity, args.rate, par, **skw, **kw)
                res = _nums(out)
                res.update(base, kind=args.kind,
                           greek_method="lr-joint-density",
                           vega_convention="2*sqrt(v0)*vega_v0")
                return res
            fn = (heston_kernel_autocall_price if args.kind == "autocallable"
                  else heston_kernel_cliquet_price)
            p, se, n = fn(args.spot, args.maturity, args.rate, par,
                          scheme=scheme, **skw, **kw)
            return {**base, "kind": args.kind, "price": float(p),
                    "std_error": float(se), "paths": int(n)}
        if args.kind in ("one-touch", "no-touch"):
            if getattr(args, "pay", "expiry") == "hit" \
                    and args.kind == "no-touch":
                raise SystemExit("a no-touch pays at expiry by definition")
            side = "up" if args.barrier >= args.spot else "down"
            kname = f"{args.kind.replace('-', '_')}_{side}"
            if getattr(args, "pay", "expiry") == "hit":
                kname += "_hit"
        elif args.kind == "double-barrier":
            kname = f"barrier_double-{args.knock}"
        elif args.kind == "double-touch":
            if getattr(args, "pay", "expiry") == "hit":
                if args.touch != "one":
                    raise SystemExit(
                        "a no-touch pays at expiry by definition")
                kname = "one_touch_double_hit"
            else:
                kname = f"{args.touch}_touch_double"
        elif args.kind == "asian":
            kname = "asian_arith"
        elif args.kind == "lookback":
            kname = "lookback_float"
        elif args.kind == "barrier":
            kname = f"barrier_{args.barrier_type}"
        elif args.kind == "range-accrual":
            if greeks:
                out = heston_kernel_range_accrual_lr_greeks(
                    args.spot, args.lower, args.upper, args.maturity,
                    args.rate, par, **kw)
                res = _nums(out)
                res.update(base, kind="range_accrual",
                           greek_method="lr-joint-density")
                return res
            p, se, n = heston_kernel_range_accrual_price(
                args.spot, args.lower, args.upper, args.maturity,
                args.rate, par, scheme=scheme, **kw)
            return {**base, "kind": "range_accrual", "price": float(p),
                    "std_error": float(se), "paths": int(n),
                    "corridor": [args.lower, args.upper]}
        else:
            raise SystemExit(
                f"--model {args.model} supports asian/barrier/lookback/"
                f"one-touch/no-touch/autocallable/cliquet/range-accrual, "
                f"not {args.kind!r}")
        band = (dict(lower=args.lower, upper=args.upper)
                if "double" in kname else {})
        if greeks:
            out = heston_kernel_exotic_lr_greeks(
                kname, args.spot, args.strike, args.maturity, args.rate,
                par, cp, barrier=args.barrier, **band, **kw)
            res = {k: float(v) for k, v in out.items()}
            res.update(base, kind=kname, greek_method="lr-joint-density",
                       vega_convention="2*sqrt(v0)*vega_v0")
            return res
        p, se, n = heston_kernel_exotic_price(
            kname, args.spot, args.strike, args.maturity, args.rate, par,
            cp, barrier=args.barrier, scheme=scheme, **band, **kw)
        return {**base, "kind": kname, "price": float(p),
                "std_error": float(se), "paths": int(n)}
    except ValidationError as e:
        raise SystemExit(str(e)) from e


def _exotic_rbergomi(args) -> dict:
    """--model rbergomi: exotics under ROUGH volatility (exact Volterra
    law, ``models/rbergomi.rbergomi_exotic_price``)."""
    from .models import RBergomiParams, rbergomi_exotic_price
    from .utils.exceptions import ValidationError

    par = RBergomiParams(hurst=args.hurst, eta=args.eta, rho=args.rho_sv,
                         xi0=args.xi0)
    cp = _cp(args)
    if args.kind in ("autocallable", "cliquet"):
        from .models import rbergomi_autocall_price, rbergomi_cliquet_price

        n_steps = getattr(args, "n_steps", 64)
        try:
            if args.kind == "autocallable":
                p, se = rbergomi_autocall_price(
                    args.spot, args.maturity, args.rate, par,
                    _generator(args, args.seed),
                    n_obs=getattr(args, "n_obs", 4),
                    n_paths=args.n_paths, n_steps=n_steps,
                    return_stderr=True)
            else:
                p, se = rbergomi_cliquet_price(
                    args.spot, args.maturity, args.rate, par,
                    _generator(args, args.seed),
                    n_periods=getattr(args, "n_periods", 8),
                    n_paths=args.n_paths, n_steps=n_steps,
                    return_stderr=True)
        except ValidationError as e:
            raise SystemExit(str(e)) from e
        return {"model": "rbergomi", "dynamics": "rough-bergomi",
                "kind": args.kind, "price": float(p),
                "std_error": float(se), "hurst": args.hurst,
                "eta": args.eta}
    kind_map = {"asian": "asian_arith", "lookback": "lookback_float",
                "barrier": f"barrier_{args.barrier_type}"}
    barrier = args.barrier
    if args.kind in ("one-touch", "no-touch"):
        if getattr(args, "pay", "expiry") == "hit" \
                and args.kind == "no-touch":
            raise SystemExit("a no-touch pays at expiry by definition")
        side = "up" if args.barrier >= args.spot else "down"
        kname = f"{args.kind.replace('-', '_')}_{side}"
        if getattr(args, "pay", "expiry") == "hit":
            kname += "_hit"
    elif args.kind == "double-barrier":
        kname = f"barrier_double-{args.knock}"
        barrier = (args.lower, args.upper)
    elif args.kind == "double-touch":
        kname = ("one_touch_double_hit"
                 if getattr(args, "pay", "expiry") == "hit"
                 else f"{args.touch}_touch_double")
        barrier = (args.lower, args.upper)
    elif args.kind in kind_map:
        kname = kind_map[args.kind]
    else:
        raise SystemExit("--model rbergomi supports asian/barrier/lookback/"
                         "one-touch/no-touch/double-barrier/double-touch/"
                         f"cliquet/autocallable, not {args.kind!r}")
    try:
        p, se = rbergomi_exotic_price(
            kname, args.spot, args.strike, args.maturity, args.rate, par,
            _generator(args, args.seed), cp, barrier=barrier,
            n_paths=args.n_paths, n_steps=getattr(args, "n_steps", 64),
            return_stderr=True)
    except ValidationError as e:
        raise SystemExit(str(e)) from e
    return {"model": "rbergomi", "dynamics": "rough-bergomi",
            "kind": kname, "price": float(p), "std_error": float(se),
            "hurst": args.hurst, "eta": args.eta}


def _sample_dupire(args):
    from .models.local_vol import DupireLocalVol, sample_smile_iv_fn

    return DupireLocalVol(sample_smile_iv_fn(base_vol=args.vol), args.spot, args.rate,
                          device=args.device)


def _exotic_lv(args) -> dict:
    """--model lv: smile-consistent exotics under the calibrated Dupire
    local vol on the local-vol kernel (``ops/local_vol_kernel``). --greeks
    adds the one-pass LR ladder (sticky-strike delta/gamma, parallel-
    shift vega)."""
    from .ops.local_vol_kernel import LocalVolKernelPricer
    from .utils.exceptions import ValidationError

    cp = _cp(args)
    if args.kind in ("autocallable", "cliquet"):
        # pure-LV structured kinds: the SLV engine at mixing=0 (exact —
        # the Gyongy leverage absorbs the eta=0 variance path)
        from .models import local_vol_autocall_price, local_vol_cliquet_price

        dup = _sample_dupire(args)
        try:
            if args.kind == "autocallable":
                p, se = local_vol_autocall_price(
                    dup, args.maturity, n_obs=getattr(args, "n_obs", 4),
                    n_paths=args.n_paths,
                    n_steps=getattr(args, "n_steps", 64), seed=args.seed,
                    return_stderr=True)
            else:
                p, se = local_vol_cliquet_price(
                    dup, args.maturity,
                    n_periods=getattr(args, "n_periods", 8),
                    n_paths=args.n_paths,
                    n_steps=getattr(args, "n_steps", 64), seed=args.seed,
                    return_stderr=True)
        except ValidationError as e:
            raise SystemExit(str(e)) from e
        return {"model": "lv", "dynamics": "dupire-local-vol",
                "kind": args.kind, "engine": "slv-scan-mixing0",
                "price": float(p), "std_error": float(se),
                "note": "pure LV flattens forward smiles; use --model "
                        "slv --mixing for the stochastic-vol "
                        "interpolation"}
    kind_map = {"asian": "asian", "lookback": "lookback_float",
                "barrier": f"barrier_{args.barrier_type}",
                "european": "european"}
    barrier, band = args.barrier, {}
    hit_sfx = "_hit" if getattr(args, "pay", "expiry") == "hit" else ""
    if hit_sfx and (args.kind == "no-touch"
                    or (args.kind == "double-touch"
                        and args.touch != "one")):
        raise SystemExit("a no-touch pays at expiry by definition")
    if args.kind in ("one-touch", "no-touch"):
        side = "up" if args.barrier >= args.spot else "down"
        kname = f"{args.kind.replace('-', '_')}_{side}{hit_sfx}"
    elif args.kind == "double-barrier":
        kname = f"barrier_double-{args.knock}"
        band = dict(lower=args.lower, upper=args.upper)
    elif args.kind == "double-touch":
        kname = (f"one_touch_double{hit_sfx}" if hit_sfx
                 else f"{args.touch}_touch_double")
        band = dict(lower=args.lower, upper=args.upper)
    elif args.kind == "range-accrual":
        kname = "range_accrual"
        band = dict(lower=args.lower, upper=args.upper)
    elif args.kind in kind_map:
        kname = kind_map[args.kind]
    else:
        raise SystemExit("--model lv supports european/asian/barrier/"
                         "lookback/one-touch/no-touch/double-barrier/"
                         "double-touch/range-accrual/cliquet/autocallable, "
                         f"not {args.kind!r}")
    dup = _sample_dupire(args)
    base = {"model": "lv", "dynamics": "dupire-local-vol", "kind": kname,
            "engine": "kernel"}
    # the LV pricer quotes range accrual on UNIT notional; the CLI
    # convention is notional 100 (matches the GBM/Heston routes)
    scale = 100.0 if kname == "range_accrual" else 1.0
    try:
        pricer = LocalVolKernelPricer(dup, args.maturity,
                                      n_steps=getattr(args, "n_steps", 64))
        kw = dict(cp=cp, payoff=kname, barrier=barrier, n_paths=args.n_paths,
                  seed=args.seed, sampler=_sampler(args), **band)
        if getattr(args, "greeks", False):
            out = pricer.greeks(args.strike, **kw)
            res = {k: scale * float(v) for k, v in out.items()}
            res.update(base, greek_method="lr-sticky-strike",
                       vega_convention="parallel surface shift")
            return res
        p, se, n = pricer.price(args.strike, **kw)
    except ValidationError as e:
        raise SystemExit(str(e)) from e
    return {**base, "price": scale * float(p),
            "std_error": scale * float(se),
            "paths": int(n), "fit_residual": float(pricer.fit_residual)}


def _exotic_slv(args) -> dict:
    """--model slv: stochastic LOCAL vol — Heston dynamics with a Dupire
    leverage calibrated on the fly (``models/slv.py``). Vanillas reprice
    the smile at every ``--mixing``; the knob marks forward-smile exotics
    between pure local vol (0) and full Heston vol-of-vol (1)."""
    from .models import HestonParams, SLVModel
    from .ops.slv_kernel import SLVKernelPricer
    from .utils.exceptions import ValidationError

    dup = _sample_dupire(args)
    par = HestonParams.make(args.v0, args.kappa, args.theta, args.sigma_v,
                            args.rho_sv, device=args.device)
    cp = _cp(args)
    kind_map = {"asian": "asian_arith", "lookback": "lookback_float",
                "barrier": f"barrier_{args.barrier_type}",
                "european": "european"}
    if args.kind in ("autocallable", "cliquet", "range-accrual"):
        # structured kinds go straight to the replay kernel (price or
        # the frozen-fixings LR ladder)
        base = {"model": "slv", "dynamics": "heston-x-dupire-leverage",
                "kind": args.kind, "mixing": args.mixing,
                "engine": "kernel"}
        try:
            pricer = SLVKernelPricer(dup, par, args.maturity,
                                     mixing=args.mixing,
                                     n_steps=getattr(args, "n_steps", 64))
            if args.kind == "range-accrual":
                kw = dict(lower=args.lower, upper=args.upper)
                fn = pricer.range_accrual
            elif args.kind == "autocallable":
                kw = dict(n_obs=getattr(args, "n_obs", 4))
                fn = pricer.autocall
            else:
                kw = dict(n_periods=getattr(args, "n_periods", 8))
                fn = pricer.cliquet
            if getattr(args, "greeks", False):
                out = fn(**kw, n_paths=args.n_paths, seed=args.seed,
                         sampler=_sampler(args), greeks=True)
                res = {k: (v if isinstance(v, (str, int)) else _num(v))
                       for k, v in out.items()}
                res.update(base, greek_method="lr-joint-density")
                return res
            p, se, n = fn(**kw, n_paths=args.n_paths, seed=args.seed,
                          sampler=_sampler(args))
        except ValidationError as e:
            raise SystemExit(str(e)) from e
        return {**base, "price": float(p), "std_error": float(se),
                "paths": int(n)}
    barrier = args.barrier
    hit_sfx = "_hit" if getattr(args, "pay", "expiry") == "hit" else ""
    if hit_sfx and (args.kind == "no-touch"
                    or (args.kind == "double-touch"
                        and args.touch != "one")):
        raise SystemExit("a no-touch pays at expiry by definition")
    if args.kind in ("one-touch", "no-touch"):
        side = "up" if args.barrier >= args.spot else "down"
        kname = f"{args.kind.replace('-', '_')}_{side}{hit_sfx}"
    elif args.kind == "double-barrier":
        kname = f"barrier_double-{args.knock}"
        barrier = (args.lower, args.upper)
    elif args.kind == "double-touch":
        kname = (f"one_touch_double{hit_sfx}" if hit_sfx
                 else f"{args.touch}_touch_double")
        barrier = (args.lower, args.upper)
    elif args.kind in kind_map:
        kname = kind_map[args.kind]
    else:
        raise SystemExit("--model slv supports asian/barrier/lookback/"
                         "one-touch/no-touch/double-barrier/double-touch/"
                         "range-accrual/cliquet/autocallable, "
                         f"not {args.kind!r}")
    base = {"model": "slv", "dynamics": "heston-x-dupire-leverage",
            "kind": kname, "mixing": args.mixing,
            "note": "vanillas reprice the smile at every mixing (Gyongy); "
                    "exotics interpolate pure-LV (0) to full Heston (1)"}
    try:
        if getattr(args, "greeks", False):
            # the replay kernel: one-pass LR ladder (sticky-strike
            # delta/gamma, frozen-leverage v0-vega/rho)
            pricer = SLVKernelPricer(dup, par, args.maturity,
                                     mixing=args.mixing,
                                     n_steps=getattr(args, "n_steps", 64))
            band = (dict(lower=args.lower, upper=args.upper)
                    if "double" in kname else {})
            out = pricer.greeks(kname, args.strike, cp=cp,
                                barrier=args.barrier, n_paths=args.n_paths,
                                seed=args.seed, sampler=_sampler(args), **band)
            res = {k: (v if isinstance(v, (str, int)) else _num(v))
                   for k, v in out.items()}
            res.update(base, greek_method="lr-joint-density",
                       engine="kernel")
            return res
        slv = SLVModel(dup, par, mixing=args.mixing)
        p, se = slv.price(kname, args.strike, args.maturity,
                          _generator(args, args.seed), cp=cp,
                          barrier=barrier, n_paths=args.n_paths,
                          n_steps=getattr(args, "n_steps", 64),
                          return_stderr=True)
    except ValidationError as e:
        raise SystemExit(str(e)) from e
    return {**base, "price": float(p), "std_error": float(se)}


def _exotic_kernel_greeks(args) -> dict:
    """--greeks: the fused-kernel Greek ladders (dispatch lives in
    ``ops.exotic_kernel.exotic_kernel_ladder``; pathwise for asian/
    lookback, likelihood-ratio for barrier/cliquet/autocall)."""
    from .ops.exotic_kernel import exotic_kernel_ladder
    from .utils.exceptions import ValidationError

    btype = args.barrier_type
    if args.kind == "double-barrier":
        btype = getattr(args, "knock", "out")
    elif args.kind == "double-touch":
        btype = getattr(args, "touch", "no")
    try:
        return _nums(exotic_kernel_ladder(
            args.kind, args.spot, args.strike, args.maturity, args.rate,
            args.vol, _cp(args), getattr(args, "dividend", 0.0),
            barrier=args.barrier, barrier_type=btype,
            lower=getattr(args, "lower", 0.0),
            upper=getattr(args, "upper", 0.0),
            pay=getattr(args, "pay", "expiry"),
            n_paths=args.n_paths, n_steps=getattr(args, "n_steps", 64),
            seed=args.seed, sampler=_sampler(args), device=args.device))
    except ValidationError as e:
        raise SystemExit(str(e)) from e


def cmd_american(args) -> dict:
    cp = _cp(args)
    dev = args.device
    n_dates = args.n_dates if args.n_dates <= 50 else 25
    if args.model == "maxcall":
        from .models.multi_asset_american import max_call_bracket

        spots = [float(x) for x in str(args.spots).split(",")]
        vols = [float(x) for x in str(args.vols).split(",")]
        out = max_call_bracket(
            spots, args.strike, args.maturity, args.rate, vols,
            dividend=args.dividend, n_dates=min(args.n_dates, 50),
            kind="min_put" if cp < 0 else "max_call",
            n_fit=50_000, n_lower=100_000, n_outer=1024, n_inner=256, device=dev)
        return _nums(out)
    if args.model == "lv":
        from .models import local_vol_american_bracket

        out = local_vol_american_bracket(_sample_dupire(args), args.strike, args.maturity,
                                         cp=cp, n_dates=n_dates, device=dev)
        return _nums(out)
    if args.model == "slv":
        from .models import HestonParams
        from .models.slv_american import slv_american_bracket

        par = HestonParams.make(args.v0, args.kappa, args.theta,
                                args.sigma_v, args.rho_sv, device=dev)
        out = slv_american_bracket(
            _sample_dupire(args), par, args.strike, args.maturity, cp=cp,
            mixing=getattr(args, "mixing", 1.0), n_dates=n_dates)
        return _nums(out)
    if args.model == "rbergomi":
        from .models import RBergomiParams
        from .models.rbergomi_american import rbergomi_american_bracket
        from .utils.exceptions import ValidationError

        par = RBergomiParams(hurst=args.hurst, eta=args.eta,
                             rho=args.rho_sv, xi0=args.xi0)
        try:
            out = rbergomi_american_bracket(
                args.spot, args.strike, args.maturity, args.rate, par,
                cp=cp, n_dates=n_dates, device=dev)
        except ValidationError as e:
            raise SystemExit(str(e)) from e
        return _nums(out)
    if args.model in ("heston", "bates"):
        from .models import BatesParams, HestonParams
        from .models.heston_american import heston_american_bracket

        if args.model == "bates":
            par = BatesParams.make(args.v0, args.kappa, args.theta,
                                   args.sigma_v, args.rho_sv, lam=args.lam,
                                   mu_j=args.mu_j, sigma_j=args.sigma_j, device=dev)
        else:
            par = HestonParams.make(v0=args.v0, kappa=args.kappa,
                                    theta=args.theta, sigma=args.sigma_v,
                                    rho=args.rho_sv, device=dev)
        out = heston_american_bracket(
            args.spot, args.strike, args.maturity, args.rate, par, cp=cp,
            n_dates=n_dates,
            # the ADI grid is diffusion-only: Bates certifies via LSM+dual
            method="lsm" if args.model == "bates" else "adi",
            use_cv=args.model == "bates", device=dev)
        return _nums(out)
    from .models import american_price_interval

    out = american_price_interval(args.spot, args.strike, args.maturity,
                                  args.rate, args.vol, cp=cp,
                                  n_outer=args.n_paths,
                                  n_dates=args.n_dates, method="grid", device=dev)
    return {k: float(v) for k, v in out.items()}


def cmd_basket(args) -> dict:
    from .models import basket_price, geometric_basket_closed_form

    spots = np.asarray([float(x) for x in args.spots.split(",")], np.float32)
    vols = np.asarray([float(x) for x in args.vols.split(",")], np.float32)
    d = spots.shape[0]
    w = np.full(d, 1.0 / d, np.float32)
    corr = np.full((d, d), args.rho, np.float32)
    np.fill_diagonal(corr, 1.0)
    cp = _cp(args)
    if args.engine == "kernel":
        from .utils.exceptions import ValidationError

        kind = "basket_geo" if args.kind == "geometric" else "basket"
        try:
            return _basket_kernel(args, kind, spots, vols, corr, w, cp)
        except ValidationError as e:
            raise SystemExit(str(e)) from e
    if args.greeks or args.sampler != "prng":
        raise SystemExit("--greeks / --sampler need --engine kernel")
    p, se = basket_price(spots, w, args.strike, args.maturity, args.rate,
                         vols, corr, _generator(args, args.seed), cp,
                         n_paths=args.n_paths, kind=args.kind,
                         return_stderr=True)
    out = {"price": float(p), "std_error": float(se), "kind": args.kind}
    if args.kind == "geometric":
        out["closed_form"] = float(geometric_basket_closed_form(
            spots, w, args.strike, args.maturity, args.rate, vols, corr, cp))
    return out


def _basket_kernel(args, kind, spots, vols, corr, w, cp) -> dict:
    from .models import geometric_basket_closed_form
    from .ops.multi_asset_kernel import multi_asset_kernel_greeks, multi_asset_kernel_price

    kw = dict(weights=w, cp=cp, n_paths=args.n_paths, seed=args.seed, sampler=args.sampler,
              device=args.device)
    if args.greeks:
        g = multi_asset_kernel_greeks(kind, spots, args.strike, args.maturity, args.rate,
                                      vols, corr, **kw)
        out = {k: _num(v) for k, v in g.items() if k != "paths"}
        out.update(kind=args.kind, engine="kernel", sampler=args.sampler,
                   paths=int(g["paths"]))
    else:
        p, se, n = multi_asset_kernel_price(kind, spots, args.strike, args.maturity,
                                            args.rate, vols, corr, **kw)
        out = {"price": float(p), "std_error": float(se), "kind": args.kind,
               "engine": "kernel", "sampler": args.sampler, "paths": int(n)}
    if args.sampler == "sobol":
        out["stderr_note"] = ("QMC: std_error uses the plain-MC formula "
                              "and is indicative only")
    if args.kind == "geometric":
        out["closed_form"] = float(geometric_basket_closed_form(
            spots, w, args.strike, args.maturity, args.rate, vols, corr, cp))
    return out


def cmd_surface(args) -> dict:
    from .data.synthetic import generate_synthetic_smile

    k, vols = generate_synthetic_smile(n_strikes=25, maturity=0.5, noise=0.003, seed=1)
    if args.model == "svi":
        from .surface import SVIModel

        m = SVIModel(device=args.device)
        loss = m.calibrate(k, vols, 0.5)
        fitted = m.smile(k, 0.5).cpu().numpy()
        return {"model": "svi", "loss": float(loss),
                "rmse_bps": float(np.sqrt(np.mean((fitted - vols) ** 2)) * 1e4),
                "butterfly_free": bool(m.is_butterfly_free())}
    from .benchmarks import VolSurfaceBenchmark

    bench = VolSurfaceBenchmark(models=[args.model], device=args.device).run(
        k, vols, 0.5, n_trials=1)
    return bench.records()[0]


def _load_chain(args):
    from .data.loader import load_option_data

    kw = {}
    if args.source == "synthetic":
        kw = {"n_rows": args.n_rows, "seed": args.seed}
    elif args.source in ("csv", "parquet", "cboe", "optionmetrics"):
        if not args.path:
            raise SystemExit(f"--path is required for {args.source} sources")
        kw = {"path": args.path}
        if args.source in ("cboe", "optionmetrics"):
            kw["rate"] = getattr(args, "chain_rate", 0.0)
        if args.source == "optionmetrics":
            kw["spot"] = getattr(args, "chain_spot", 0.0) or None
    elif args.source == "yfinance":
        kw = {"ticker": args.ticker}
    return load_option_data(args.source, **kw, device=args.device)


def cmd_calibrate(args) -> dict:
    """Chain snapshot -> SVI/SSVI surface (default) or a dynamic model
    fitted to the quotes: heston/bates (Lewis-CF Adam), heston-mc (the
    Heston chain kernel: whole chain + all five parameter gradients per
    Adam step in one launch), or rbergomi (rough vol: all four params incl.
    the Hurst exponent by autograd through the Volterra covariance on a CRN
    Monte Carlo chain)."""
    chain = _load_chain(args)
    if args.model in ("heston", "heston-mc", "bates", "rbergomi"):
        from .surface.chain_calibration import calibrate_model_to_chain

        return calibrate_model_to_chain(chain, args.model,
                                        from_prices=args.from_prices,
                                        n_steps=args.steps,
                                        mc_paths=args.mc_paths, device=args.device)
    from .surface.chain_calibration import calibrate_chain

    res = calibrate_chain(chain, n_expiry_bins=args.bins,
                          from_prices=args.from_prices, n_steps=args.steps,
                          essvi=getattr(args, "essvi", False), device=args.device)
    return res.to_dict()


def cmd_plot(args) -> dict:
    from .utils import plotting

    plotting._plt()  # no matplotlib: DependencyError before any fit
    if args.what in ("smiles", "ssvi-surface"):
        from .surface.chain_calibration import calibrate_chain

        chain = _load_chain(args)
        res = calibrate_chain(chain, n_expiry_bins=args.bins,
                              from_prices=args.from_prices, n_steps=args.steps,
                              device=args.device)
        if args.what == "smiles":
            plotting.plot_smile_fits(chain, res, path=args.out)
        else:
            plotting.plot_ssvi_surface(res, path=args.out)
    elif args.what == "boundary":
        plotting.plot_exercise_boundary(
            spot=args.spot, strike=args.strike, maturity=args.maturity,
            rate=args.rate, vol=args.vol,
            cp=-1.0 if args.option_type == "put" else 1.0,
            seed=args.seed, path=args.out, device=args.device)
    else:  # generator surface from scattered chain quotes
        from .data._table import as_table
        from .surface.generator import VolatilitySurfaceGenerator

        t = as_table(_load_chain(args))
        gen = VolatilitySurfaceGenerator(
            np.log(np.asarray(t["strike_price"], np.float64)
                   / np.asarray(t["underlying_price"], np.float64)),
            np.asarray(t["time_to_maturity"]),
            np.asarray(t["implied_volatility"]), device=args.device)
        gen.plot_surface(path=args.out)
    return {"written": args.out, "plot": args.what}


def cmd_varswap(args) -> dict:
    """Fair variance/vol swap strikes: model-free replication + Heston
    closed forms + MC under the calibrated Dupire local vol (the LV MC
    strike must agree with the replication of the same smile — printed
    side by side as a live consistency check)."""
    from .models import (
        heston_expected_variance,
        heston_vol_swap_strike,
        heston_vol_swap_strike_brockhaus_long,
        local_vol_swap_strikes,
        slv_swap_strikes,
        variance_swap_strike_from_iv,
        vix_style_index,
    )
    from .models.heston import HestonParams
    from .models.local_vol import DupireLocalVol, sample_smile_iv_fn

    dev = args.device

    def on(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    p = HestonParams.make(v0=args.v0, kappa=args.kappa, theta=args.theta,
                          sigma=args.sigma_v, rho=args.rho, device=dev)
    kv = float(heston_expected_variance(p, args.maturity))
    ks = on(np.exp(np.linspace(-2.0, 2.0, 800)) * args.spot)
    flat = float(variance_swap_strike_from_iv(
        args.spot, ks, torch.full_like(ks, args.vol), args.maturity, args.rate))
    # LV section uses a MILD (wing-arb-free) smile and a grid spanning the
    # replication strip: the default steep sample smile violates butterfly
    # arbitrage beyond |k| ~ 1 (quadratic IV growth), where no LV model
    # can — or should — match the replication of the raw quotes
    iv_fn = sample_smile_iv_fn(base_vol=args.vol, skew=-0.06, smile=0.03)
    dup = DupireLocalVol(iv_fn, args.spot, args.rate, k_range=(-2.5, 2.5),
                         n_k=201, device=dev)
    # both strikes are functionals of the same paths: ONE simulation
    lv_kv, lv_se, lv_kvol, _ = local_vol_swap_strikes(
        dup, args.maturity, n_paths=100_000, n_steps=64)
    fwd = args.spot * np.exp(args.rate * args.maturity)
    kss = on(np.exp(np.linspace(-2.5, 2.5, 1600)) * args.spot)
    smile_rep = float(variance_swap_strike_from_iv(
        args.spot, kss, iv_fn(torch.log(kss / fwd), args.maturity),
        args.maturity, args.rate))
    # SLV at full vol-of-vol on the SAME surface: Gyongy makes the log
    # contract — hence K_var — mixing-invariant, so this must agree with
    # the LV strike and the replication above, while the VOL swap's
    # convexity discount grows with mixing — both strikes from ONE
    # simulation per mixing
    g = (dup.surface.k_grid, dup.surface.t_grid, dup.surface.grid)
    slv_kv, slv_se, slv_kvol, _ = slv_swap_strikes(
        args.spot, args.maturity, args.rate, p, _generator(args, 0),
        *g, mixing=1.0, n_paths=65_536, n_steps=64)
    return {
        "heston_variance_strike": kv,
        "heston_vol_strike_exact": float(heston_vol_swap_strike(p, args.maturity)),
        "heston_vol_strike_brockhaus_long": float(
            heston_vol_swap_strike_brockhaus_long(p, args.maturity)),
        "flat_smile_variance_strike": flat,
        "flat_smile_vol_check": args.vol**2,
        "local_vol_variance_strike": float(lv_kv),
        "local_vol_variance_stderr": float(lv_se),
        "local_vol_vol_strike": float(lv_kvol),
        "smile_replication_variance_strike": smile_rep,
        "slv_variance_strike_mixing1": float(slv_kv),
        "slv_variance_stderr": float(slv_se),
        "slv_vol_strike_mixing1": float(slv_kvol),
        "slv_vol_swap_note": (
            "K_var is Gyongy-pinned across mixing; the vol-swap strike's "
            "convexity discount grows with mixing (compare "
            "local_vol_vol_strike = the mixing~0 value)"),
        "vix_style_index_flat": float(vix_style_index(
            args.spot, ks, torch.full_like(ks, args.vol), 30 / 365, args.rate)),
    }


def cmd_var(args) -> dict:
    from .risk import VaRAnalyzer

    a = VaRAnalyzer(confidence=args.confidence, seed=0, device=args.device)
    return {
        "parametric_var": a.parametric(args.mu, args.sigma * args.value),
        "lognormal_var": a.parametric_lognormal(args.value, args.mu, args.sigma),
        "monte_carlo_var": a.monte_carlo(args.value, args.mu, args.sigma),
    }


def cmd_report(args) -> dict:
    """One self-contained HTML desk report: smile fits, surface, arb
    report, exercise boundary, VaR, exposure/CVA — the upstream
    dashboard's content as a single artifact."""
    from .utils import plotting
    from .utils.report import build_report

    plotting._plt()  # no matplotlib: DependencyError before the chain loads
    chain = _load_chain(args)
    return build_report(chain, out_path=args.out, n_expiry_bins=args.bins,
                        n_steps=args.steps, essvi=not args.no_essvi,
                        include_boundary=not args.no_boundary,
                        include_xva=not args.no_xva, seed=args.seed, device=args.device)


def cmd_book(args) -> dict:
    """Quote a same-kind contract BOOK (mixed strikes/barriers/bands) in
    ONE kernel launch under GBM or Heston/Bates dynamics — N contracts
    interleave the kernel row axis, so the book costs one launch instead
    of N. Reference analog: ``MonteCarloPricerUni.price_batch``
    (``src/pricing_models/monte_carlo_unified.py:562``)."""
    from .models.books import exotic_book_quote

    params = None
    model = args.model
    if model == "bates":
        from .models import BatesParams

        params = BatesParams.make(args.v0, args.kappa, args.theta,
                                  args.sigma_v, args.rho_sv, lam=args.lam,
                                  mu_j=args.mu_j, sigma_j=args.sigma_j, device=args.device)
    elif model == "heston":
        from .models import HestonParams

        params = HestonParams.make(args.v0, args.kappa, args.theta,
                                   args.sigma_v, args.rho_sv, device=args.device)
    return _nums(exotic_book_quote(
        args.kind, args.spot, args.strikes, args.maturity, args.rate,
        vol=args.vol, model=model, params=params,
        cp=1.0 if args.option_type.startswith("c") else -1.0,
        dividend=args.dividend, barriers=args.barriers or None,
        lowers=args.lowers or None, uppers=args.uppers or None,
        greeks=args.greeks, n_paths=args.n_paths, n_steps=args.n_steps,
        seed=args.seed, sampler=_sampler(args), scheme=args.scheme,
        barrier_type=args.barrier_type, averaging=args.averaging,
        floating=not args.fixed_lookback, knock=args.knock,
        touch=args.touch, direction=args.direction, device=args.device))


def cmd_export(args) -> dict:
    """Train the MLP surface model on a chain snapshot and write a
    deployable artifact: ``torch.export`` (``.pt2``), plus a real
    ``.onnx`` twin with ``--onnx``. ``--trials N`` runs the hyperparameter
    study first and exports the retrained best config."""
    import dataclasses

    from .surface import MLPModel

    chain = _load_chain(args).to_model_input()
    if args.trials > 0:
        from .optimize import optimize_and_export

        res = optimize_and_export(chain, args.out, n_trials=args.trials,
                                  storage=args.storage,
                                  final_epochs=args.epochs,
                                  emit_onnx=args.onnx, device=args.device)
        d = {"best_params": dict(res["study"].best_params),
             "final_metrics": res["final_metrics"],
             "export": dataclasses.asdict(res["export"])}
        if args.onnx:
            d["onnx"] = res["onnx"]
        return d
    from .optimize import export_surface_model

    model = MLPModel(epochs=args.epochs, seed=args.seed, device=args.device)
    metrics = model.train(chain)
    d = {"final_metrics": metrics,
         "export": dataclasses.asdict(export_surface_model(model, args.out))}
    if args.onnx:
        from .optimize import export_surface_model_onnx

        onnx_path = (args.out[:-len(".pt2")] if args.out.endswith(".pt2")
                     else args.out) + ".onnx"
        d["onnx"] = export_surface_model_onnx(model, onnx_path)
    return d


def cmd_xva(args) -> dict:
    """Counterparty exposure profile (EE/EPE/PFE) + CVA/DVA for a simple
    netting set: one option position vs the counterparty.
    ``--exotic-kind``: the position is PATH-DEPENDENT and the profile
    comes from the AMC (regression-revaluation) engine instead of the
    closed-form one. ``--model heston|bates|slv|rbergomi`` prices the
    exposure under default-parameter stochastic-vol / jump / smile /
    rough dynamics (implies the AMC engine; vanilla kind unless
    ``--exotic-kind`` says otherwise)."""
    kind = getattr(args, "exotic_kind", "")
    model = getattr(args, "model", "bs")
    if model != "bs" and not kind:
        kind = "vanilla"  # dynamics choice implies the AMC engine
    if kind:
        from .risk import ExoticPosition, amc_dynamics_kwargs, amc_exposure_profile, cva_dva

        dyn = amc_dynamics_kwargs(model, spot=args.spot, rate=args.rate,
                                  vol=args.vol, mixing=args.mixing, device=args.device)
        prof = amc_exposure_profile(
            [ExoticPosition(kind=kind, quantity=args.quantity,
                            strike=args.strike, maturity=args.maturity,
                            option_type=args.option_type,
                            barrier=args.barrier, vol=args.vol)],
            spot=args.spot, rate=args.rate, n_dates=args.dates,
            n_paths=args.paths, quantile=args.quantile, seed=args.seed,
            vol=args.vol, device=args.device, **dyn)
        out = cva_dva(prof, hazard_rate=args.hazard, recovery=args.recovery)
        return {"engine": "amc", "kind": kind, "model": model,
                "dates": _num(prof.dates), "ee": _num(prof.ee), "pfe": _num(prof.pfe),
                "epe": _num(prof.epe), "max_pfe": _num(prof.max_pfe), **_nums(out)}
    from .risk import Position, xva_report

    pos = Position(quantity=args.quantity, spot=args.spot,
                   strike=args.strike, maturity=args.maturity,
                   rate=args.rate, vol=args.vol,
                   option_type=args.option_type)
    return _nums(xva_report(
        [pos], hazard_rate=args.hazard, recovery=args.recovery,
        own_hazard_rate=args.own_hazard if args.own_hazard > 0 else None,
        funding_spread=(args.funding_spread
                        if args.funding_spread > 0 else None),
        n_dates=args.dates, n_paths=args.paths, quantile=args.quantile,
        collateral_threshold=(args.collateral_threshold
                              if args.collateral_threshold >= 0 else None),
        mpor=args.mpor, seed=args.seed, device=args.device))


def cmd_backtest(args) -> dict:
    from .backtest import BacktestEngine

    rng = np.random.default_rng(args.seed)
    dt = 1 / 252
    z = rng.standard_normal(252)
    prices = 100 * np.exp(np.cumsum((0.05 - 0.5 * args.vol**2) * dt
                                    + args.vol * np.sqrt(dt) * z))
    prices = np.concatenate([[100.0], prices])
    res = BacktestEngine(rate=0.03, device=args.device).run_delta_hedge(
        prices, strike=100.0, maturity=1.0, sigma=args.hedge_vol)
    return res.summary()


def cmd_serve(args) -> dict:  # pragma: no cover - blocking
    from .server import PricingServer

    PricingServer(args.port, args.host, device=args.device).serve_forever()
    return {}


def cmd_bench_harness(args) -> dict:
    from .benchmarks import VolSurfaceBenchmark
    from .data.synthetic import generate_synthetic_smile

    k, vols = generate_synthetic_smile(n_strikes=21, maturity=0.5, noise=0.002, seed=0)
    models = args.models.split(",") if args.models else ["svi", "sabr", "kernel_ridge"]
    bench = VolSurfaceBenchmark(models=models, device=args.device).run(
        k, vols, 0.5, n_trials=args.trials)
    return {"table": bench.records(), "best": bench.best_model()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="optionslab_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device every subcommand runs on (cuda unless cpu is asked "
                        "for; no fallback when there is no card)")
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info")

    pp = sub.add_parser("price")
    _common_contract_args(pp)
    pp.add_argument("--model", default="bs",
                    choices=["bs", "binomial", "fdm", "heston", "bates",
                             "vg", "nig", "merton"])
    pp.add_argument("--american", action="store_true")
    pp.add_argument("--steps", type=int, default=512)

    pg = sub.add_parser("greeks")
    _common_contract_args(pg)
    pg.add_argument("--model", default="bs",
                    choices=["bs", "heston", "heston-qe"],
                    help="heston[-qe]: full kernel parameter ladder "
                         "(v0/kappa/theta/sigma/rho + calendar theta)")
    pg.add_argument("--n-paths", type=int, default=200_000)
    pg.add_argument("--n-steps", type=int, default=32)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--v0", type=float, default=0.04)
    pg.add_argument("--kappa", type=float, default=2.0)
    pg.add_argument("--theta", type=float, default=0.04)
    pg.add_argument("--sigma-v", type=float, default=0.3)
    pg.add_argument("--rho-sv", type=float, default=-0.7)

    pm = sub.add_parser("mc")
    _common_contract_args(pm)
    pm.add_argument("--n-paths", type=int, default=100_000)
    pm.add_argument("--method", default="xla", choices=["xla", "qmc", "pallas"],
                    help="xla: torch tensor ops; qmc: scrambled Sobol; pallas: the GBM "
                         "kernel (csrc/gbm_mc.cu)")
    pm.add_argument("--sampler", default="prng", choices=["prng", "sobol"])
    pm.add_argument("--seed", type=int, default=0)

    pi = sub.add_parser("iv")
    _common_contract_args(pi)
    pi.add_argument("--price", type=float, required=True)

    pe = sub.add_parser("exotic")
    _common_contract_args(pe)
    pe.add_argument("--kind", default="asian",
                    choices=["asian", "barrier", "lookback", "american",
                             "autocallable", "cliquet", "one-touch",
                             "no-touch", "range-accrual", "double-barrier",
                             "double-touch"])
    pe.add_argument("--lower", type=float, default=90.0,
                    help="range-accrual corridor / double-barrier band "
                         "lower bound")
    pe.add_argument("--upper", type=float, default=110.0,
                    help="range-accrual corridor / double-barrier band "
                         "upper bound")
    pe.add_argument("--knock", default="out", choices=["out", "in"],
                    help="double-barrier knock direction")
    pe.add_argument("--touch", default="no", choices=["one", "no"],
                    help="double-touch digital flavor")
    pe.add_argument("--barrier", type=float, default=120.0)
    pe.add_argument("--barrier-type", default="up-and-out")
    pe.add_argument("--pay", default="expiry", choices=["expiry", "hit"],
                    help="one-touch/double-touch payment convention: cash "
                         "at expiry (default) or AT the first hit (the "
                         "market-standard American binary)")
    pe.add_argument("--rebate", type=float, default=0.0,
                    help="barrier/double-barrier rebate: knock-out pays "
                         "this AT the first hit; knock-in pays it at "
                         "expiry if never knocked in")
    pe.add_argument("--n-paths", type=int, default=100_000)
    pe.add_argument("--seed", type=int, default=0)
    pe.add_argument("--n-steps", type=int, default=64)
    pe.add_argument("--cv", action="store_true",
                    help="Kemna-Vorst geometric control variate at kernel "
                         "speed (asian only; ~24x lower stderr)")
    pe.add_argument("--greeks", action="store_true",
                    help="fused-kernel Greek ladder (pathwise for asian/"
                         "lookback, likelihood-ratio for barrier/cliquet/"
                         "autocallable)")
    pe.add_argument("--model", default="bs",
                    choices=["bs", "heston", "heston-qe", "bates",
                             "bates-qe", "rbergomi", "lv", "slv"],
                    help="heston[-qe] / bates[-qe]: price under stochastic "
                         "vol (+ jumps for bates) via the fused exotic "
                         "kernel; --greeks adds the joint-density LR "
                         "ladder (euler only); lv: smile-consistent Dupire "
                         "local vol on the fused kernel (sticky-strike LR "
                         "greeks); slv: Heston x Dupire "
                         "leverage (see --mixing)")
    pe.add_argument("--mixing", type=float, default=1.0,
                    help="slv vol-of-vol mixing in [0, 1]: 0 = pure local "
                         "vol, 1 = full Heston (vanillas reprice either "
                         "way)")
    pe.add_argument("--lam", type=float, default=0.5,
                    help="bates jump intensity /yr")
    pe.add_argument("--mu-j", type=float, default=-0.1)
    pe.add_argument("--sigma-j", type=float, default=0.15)
    pe.add_argument("--hurst", type=float, default=0.1,
                    help="rbergomi roughness H in (0, 0.5]")
    pe.add_argument("--eta", type=float, default=1.9,
                    help="rbergomi vol-of-vol")
    pe.add_argument("--xi0", type=float, default=0.04,
                    help="rbergomi flat forward variance")
    pe.add_argument("--v0", type=float, default=0.04)
    pe.add_argument("--kappa", type=float, default=2.0)
    pe.add_argument("--theta", type=float, default=0.04)
    pe.add_argument("--sigma-v", type=float, default=0.3)
    pe.add_argument("--rho-sv", type=float, default=-0.7)
    pe.add_argument("--n-obs", type=int, default=4,
                    help="autocallable observation dates (heston model)")
    pe.add_argument("--n-periods", type=int, default=8,
                    help="cliquet reset periods (heston model)")

    pa = sub.add_parser("american")
    _common_contract_args(pa)
    pa.add_argument("--n-paths", type=int, default=16_384)
    pa.add_argument("--n-dates", type=int, default=200)
    # --model heston/lv: certified bracket under stochastic/local vol
    # (PDE-surface dual, puts only; lv uses the sample smile at --vol
    # ATM); n-dates above 50 is clamped to the PDE-friendly 25
    pa.add_argument("--model",
                    choices=["bs", "heston", "bates", "lv", "slv",
                             "rbergomi", "maxcall"],
                    default="bs")
    # --model rbergomi: certified bracket under ROUGH vol (puts only;
    # non-Markovian dual via the causal Volterra factorization)
    pa.add_argument("--hurst", type=float, default=0.1,
                    help="rbergomi roughness H in (0, 0.5]")
    pa.add_argument("--eta", type=float, default=1.9,
                    help="rbergomi vol-of-vol")
    pa.add_argument("--xi0", type=float, default=0.04,
                    help="rbergomi flat forward variance")
    pa.add_argument("--mixing", type=float, default=1.0,
                    help="slv vol-of-vol mixing in [0, 1]")
    # --model maxcall: certified Bermudan max-call bracket on d assets
    # (--dividend comes from the common contract args; the Broadie-
    # Glasserman benchmark uses --dividend 0.10 --maturity 3 --n-dates 9)
    pa.add_argument("--spots", default="100,100")
    pa.add_argument("--vols", default="0.2,0.2")
    pa.add_argument("--v0", type=float, default=0.04)
    pa.add_argument("--kappa", type=float, default=2.0)
    pa.add_argument("--theta", type=float, default=0.04)
    pa.add_argument("--sigma-v", type=float, default=0.3)
    pa.add_argument("--rho-sv", type=float, default=-0.7)
    pa.add_argument("--lam", type=float, default=0.5,
                    help="bates jump intensity /yr (certifies via LSM+dual)")
    pa.add_argument("--mu-j", type=float, default=-0.1)
    pa.add_argument("--sigma-j", type=float, default=0.15)

    pk = sub.add_parser("basket")
    pk.add_argument("--spots", default="100,95,105")
    pk.add_argument("--vols", default="0.2,0.25,0.3")
    pk.add_argument("--strike", type=float, default=100.0)
    pk.add_argument("--maturity", type=float, default=1.0)
    pk.add_argument("--rate", type=float, default=0.05)
    pk.add_argument("--rho", type=float, default=0.4)
    pk.add_argument("--option-type", default="call")
    pk.add_argument("--kind", default="arithmetic",
                    choices=["arithmetic", "geometric"])
    pk.add_argument("--n-paths", type=int, default=200_000)
    pk.add_argument("--seed", type=int, default=0)
    pk.add_argument("--engine", default="xla", choices=["xla", "kernel"],
                    help="kernel = the multi-asset kernel "
                         "(enables --greeks ladder and --sampler sobol)")
    pk.add_argument("--sampler", default="prng",
                    choices=["prng", "hash", "sobol"])
    pk.add_argument("--greeks", action="store_true",
                    help="full per-asset LR ladder (kernel engine only)")

    ps = sub.add_parser("surface")
    ps.add_argument("--model", default="svi")

    def _chain_args(sp):
        sp.add_argument("--source", default="synthetic",
                        choices=["synthetic", "csv", "parquet", "yfinance",
                                 "cboe", "optionmetrics"])
        sp.add_argument("--path", default="")
        sp.add_argument("--ticker", default="SPY")
        sp.add_argument("--n-rows", type=int, default=600)
        sp.add_argument("--bins", type=int, default=5)
        sp.add_argument("--steps", type=int, default=600)
        sp.add_argument("--from-prices", action="store_true")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--chain-rate", type=float, default=0.0,
                        help="risk-free rate for cboe/optionmetrics files "
                             "(they carry none)")
        sp.add_argument("--chain-spot", type=float, default=0.0,
                        help="underlying price for optionmetrics files "
                             "(lives in the separate security file)")

    pc = sub.add_parser("calibrate")
    _chain_args(pc)
    pc.add_argument("--model", default="svi",
                    choices=["svi", "heston", "heston-mc", "bates",
                             "rbergomi"])
    pc.add_argument("--mc-paths", type=int, default=1_000_000,
                    help="paths per kernel launch for --model heston-mc")
    pc.add_argument("--essvi", action="store_true",
                    help="also fit an eSSVI surface (per-expiry rho/psi, "
                         "joint no-arb-penalized fit in one loop)")

    pl = sub.add_parser("plot")
    pl.add_argument("--what", default="smiles",
                    choices=["smiles", "ssvi-surface", "rbf-surface",
                             "boundary"])
    pl.add_argument("--out", default="plot.png")
    _chain_args(pl)
    pl.add_argument("--spot", type=float, default=100.0)
    pl.add_argument("--strike", type=float, default=100.0)
    pl.add_argument("--maturity", type=float, default=1.0)
    pl.add_argument("--rate", type=float, default=0.05)
    pl.add_argument("--vol", type=float, default=0.2)
    pl.add_argument("--option-type", default="put")

    pw = sub.add_parser("varswap")
    pw.add_argument("--spot", type=float, default=100.0)
    pw.add_argument("--vol", type=float, default=0.2)
    pw.add_argument("--maturity", type=float, default=1.0)
    pw.add_argument("--rate", type=float, default=0.03)
    pw.add_argument("--v0", type=float, default=0.04)
    pw.add_argument("--kappa", type=float, default=2.0)
    pw.add_argument("--theta", type=float, default=0.05)
    pw.add_argument("--sigma-v", type=float, default=0.3)
    pw.add_argument("--rho", type=float, default=-0.7)

    pv = sub.add_parser("var")
    pv.add_argument("--value", type=float, default=1e6)
    pv.add_argument("--mu", type=float, default=0.05)
    pv.add_argument("--sigma", type=float, default=0.2)
    pv.add_argument("--confidence", type=float, default=0.95)

    pr = sub.add_parser("report")
    _chain_args(pr)
    pr.add_argument("--out", default="report.html")
    pr.add_argument("--no-essvi", action="store_true")
    pr.add_argument("--no-boundary", action="store_true")
    pr.add_argument("--no-xva", action="store_true")

    px = sub.add_parser("xva")
    px.add_argument("--exotic-kind", default="",
                    help="path-dependent position kind (AMC engine): "
                         "asian_arith, lookback_float/fixed, "
                         "barrier_{up,down}-and-{in,out}")
    px.add_argument("--model", default="bs",
                    choices=["bs", "heston", "bates", "slv", "rbergomi"],
                    help="AMC exposure dynamics (alone it implies a "
                         "vanilla AMC position; combine with "
                         "--exotic-kind for path-dependent books); "
                         "default-parameter smile models — use the HTTP "
                         "/xva route to pass explicit params")
    px.add_argument("--mixing", type=float, default=1.0,
                    help="SLV mixing fraction (model=slv)")
    px.add_argument("--barrier", type=float, default=120.0)
    px.add_argument("--spot", type=float, default=100.0)
    px.add_argument("--strike", type=float, default=100.0)
    px.add_argument("--maturity", type=float, default=1.0)
    px.add_argument("--rate", type=float, default=0.05)
    px.add_argument("--vol", type=float, default=0.2)
    px.add_argument("--quantity", type=float, default=1.0)
    px.add_argument("--option-type", default="call",
                    choices=["call", "put", "forward"])
    px.add_argument("--hazard", type=float, default=0.02)
    px.add_argument("--funding-spread", type=float, default=0.0,
                    help="flat funding spread over OIS: adds FCA/FBA/FVA")
    px.add_argument("--own-hazard", type=float, default=0.0)
    px.add_argument("--recovery", type=float, default=0.4)
    px.add_argument("--quantile", type=float, default=0.95)
    px.add_argument("--dates", type=int, default=24)
    px.add_argument("--paths", type=int, default=65536)
    px.add_argument("--collateral-threshold", type=float, default=-1.0,
                    help="received-collateral threshold; negative disables")
    px.add_argument("--mpor", type=float, default=0.0,
                    help="margin period of risk in years")
    px.add_argument("--seed", type=int, default=0)

    pb = sub.add_parser("backtest")
    pb.add_argument("--vol", type=float, default=0.2)
    pb.add_argument("--hedge-vol", type=float, default=0.2)
    pb.add_argument("--seed", type=int, default=0)

    ph = sub.add_parser("bench-harness")
    ph.add_argument("--models", default="")
    ph.add_argument("--trials", type=int, default=1)

    psv = sub.add_parser("serve")
    psv.add_argument("--port", type=int, default=8777)
    psv.add_argument("--host", default="127.0.0.1")

    pb = sub.add_parser("book")
    pb.add_argument("--kind", default="asian",
                    choices=["asian", "lookback", "barrier", "one-touch",
                             "no-touch", "double-barrier", "double-touch"])
    pb.add_argument("--strikes", type=float, nargs="+",
                    default=[90.0, 100.0, 110.0])
    pb.add_argument("--barriers", type=float, nargs="*", default=[])
    pb.add_argument("--lowers", type=float, nargs="*", default=[])
    pb.add_argument("--uppers", type=float, nargs="*", default=[])
    pb.add_argument("--spot", type=float, default=100.0)
    pb.add_argument("--maturity", type=float, default=1.0)
    pb.add_argument("--rate", type=float, default=0.05)
    pb.add_argument("--vol", type=float, default=0.2)
    pb.add_argument("--dividend", type=float, default=0.0)
    pb.add_argument("--type", dest="option_type", default="call",
                    choices=["call", "put"])
    pb.add_argument("--model", default="bs",
                    choices=["bs", "heston", "bates"])
    pb.add_argument("--greeks", action="store_true",
                    help="per-contract LR Greek ladder in the same launch")
    pb.add_argument("--barrier-type", default="up-and-out",
                    choices=["up-and-out", "up-and-in", "down-and-out",
                             "down-and-in"])
    pb.add_argument("--averaging", default="arithmetic",
                    choices=["arithmetic", "geometric"])
    pb.add_argument("--fixed-lookback", action="store_true")
    pb.add_argument("--knock", default="out", choices=["out", "in"])
    pb.add_argument("--touch", default="no", choices=["one", "no"])
    pb.add_argument("--direction", default="up", choices=["up", "down"])
    pb.add_argument("--scheme", default="euler", choices=["euler", "qe"])
    pb.add_argument("--n-paths", type=int, default=200_000)
    pb.add_argument("--n-steps", type=int, default=64)
    pb.add_argument("--seed", type=int, default=0)
    pb.add_argument("--v0", type=float, default=0.04)
    pb.add_argument("--kappa", type=float, default=2.0)
    pb.add_argument("--theta", type=float, default=0.04)
    pb.add_argument("--sigma-v", type=float, default=0.3)
    pb.add_argument("--rho-sv", type=float, default=-0.7)
    pb.add_argument("--lam", type=float, default=0.5)
    pb.add_argument("--mu-j", type=float, default=-0.1)
    pb.add_argument("--sigma-j", type=float, default=0.15)

    pexp = sub.add_parser("export")
    _chain_args(pexp)
    pexp.add_argument("--out", default="surface_mlp.pt2",
                      help="torch.export artifact path (a .json sidecar rides "
                           "along; --onnx adds a .onnx twin)")
    pexp.add_argument("--onnx", action="store_true",
                      help="also emit a parity-checked real .onnx artifact")
    pexp.add_argument("--trials", type=int, default=0,
                      help="run an N-trial hyperparameter study before the "
                           "final fit (0 = default config)")
    pexp.add_argument("--epochs", type=int, default=300)
    pexp.add_argument("--storage", default="sqlite:///optionslab_studies.db")
    return p


COMMANDS = {
    "info": cmd_info,
    "price": cmd_price,
    "greeks": cmd_greeks,
    "mc": cmd_mc,
    "iv": cmd_iv,
    "exotic": cmd_exotic,
    "american": cmd_american,
    "basket": cmd_basket,
    "surface": cmd_surface,
    "calibrate": cmd_calibrate,
    "plot": cmd_plot,
    "var": cmd_var,
    "varswap": cmd_varswap,
    "xva": cmd_xva,
    "report": cmd_report,
    "export": cmd_export,
    "book": cmd_book,
    "backtest": cmd_backtest,
    "bench-harness": cmd_bench_harness,
    "serve": cmd_serve,
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.device = torch.device(args.device)
    out = COMMANDS[args.command](args)
    print(json.dumps(out, indent=2, default=_num))
    return 0


if __name__ == "__main__":
    sys.exit(main())
