"""Contract-book façade: one kernel launch quotes a same-kind book.

The port of ``optionslab_tpu/models/books.py``: N contracts (mixed strikes /
barriers / bands) interleave the rows of one kernel launch, under GBM
(``model="bs"``, the exotic kernel) or Heston/Bates (``model="heston"|
"bates"``, the Heston exotic kernel). The one façade → kernel mapping shared
by the HTTP ``/book/exotic`` route and any CLI.
"""

from __future__ import annotations

from ..ops.exotic_kernel import exotic_book_lr_greeks, exotic_book_price
from ..ops.heston_exotic_kernel import (
    heston_kernel_exotic_book_lr_greeks,
    heston_kernel_exotic_book_price,
)
from ..utils.exceptions import ValidationError

FACADE_BOOK_KINDS = ("asian", "lookback", "barrier", "one-touch", "no-touch",
                     "double-barrier", "double-touch")


def facade_kernel_kind(kind: str, *, barrier_type: str = "up-and-out",
                       averaging: str = "arithmetic", floating: bool = True,
                       knock: str = "out", touch: str = "no", direction: str = "up") -> str:
    """Map a façade kind name (CLI/HTTP vocabulary) to a kernel payoff kind."""
    if kind == "asian":
        return "asian_arith" if averaging.startswith("arith") else "asian_geo"
    if kind == "lookback":
        return "lookback_float" if floating else "lookback_fixed"
    if kind == "barrier":
        if barrier_type not in ("up-and-out", "up-and-in", "down-and-out", "down-and-in"):
            raise ValidationError(f"unknown barrier_type {barrier_type!r}")
        return f"barrier_{barrier_type}"
    if kind in ("one-touch", "no-touch"):
        if direction not in ("up", "down"):
            raise ValidationError("touch direction must be up|down")
        return f"{'one' if kind.startswith('one') else 'no'}_touch_{direction}"
    if kind in ("double-barrier", "double_barrier"):
        return f"barrier_double-{'in' if knock == 'in' else 'out'}"
    if kind in ("double-touch", "double_touch"):
        return "one_touch_double" if touch == "one" else "no_touch_double"
    raise ValidationError(f"book kinds are {FACADE_BOOK_KINDS}: got {kind!r}")


def exotic_book_quote(kind: str, spot, strikes, maturity, rate, vol: float = 0.2,
                      model: str = "bs", params=None, cp: float = 1.0, dividend: float = 0.0,
                      barriers=None, lowers=None, uppers=None, greeks: bool = False,
                      n_paths: int = 200_000, n_steps: int = 64, seed: int = 0,
                      sampler: str | None = None, scheme: str = "euler",
                      barrier_type: str = "up-and-out", averaging: str = "arithmetic",
                      floating: bool = True, knock: str = "out", touch: str = "no",
                      direction: str = "up", device="cuda") -> dict:
    """Quote a same-kind book in ONE kernel launch: under GBM at ``vol``
    (``model="bs"``) or under ``params`` (a HestonParams / BatesParams) with
    ``model="heston"|"bates"`` and ``scheme`` euler|qe. ``greeks=True``
    returns the per-contract LR ladder (the Euler scheme: ``scheme="qe"``
    with ``greeks=True`` raises, where the reference silently runs Euler).
    ``n_paths`` is per contract; ``sampler=None`` means ``"prng"``. Every
    metric is a list with one entry per contract."""
    if model not in ("bs", "heston", "bates"):
        raise ValidationError(f"book models are bs|heston|bates: got {model!r}")
    k = facade_kernel_kind(kind, barrier_type=barrier_type, averaging=averaging,
                           floating=floating, knock=knock, touch=touch, direction=direction)
    kw = dict(cp=cp, dividend=dividend, barriers=barriers, lowers=lowers, uppers=uppers,
              n_paths=n_paths, n_steps=n_steps, seed=seed,
              sampler="prng" if sampler is None else sampler, device=device)
    if model == "bs":
        if greeks:
            out = dict(exotic_book_lr_greeks(k, spot, strikes, maturity, rate, vol, **kw))
        else:
            prices, ses, n = exotic_book_price(k, spot, strikes, maturity, rate, vol, **kw)
            out = {"price": prices, "std_error": ses, "paths": n}
    else:
        if params is None:
            raise ValidationError(f"model={model!r} needs params (HestonParams/BatesParams)")
        if greeks:
            if scheme != "euler":
                raise ValidationError("book greeks are the Euler LR ladder: scheme must be "
                                      f"'euler', got {scheme!r}")
            out = dict(heston_kernel_exotic_book_lr_greeks(k, spot, strikes, maturity, rate,
                                                           params, **kw))
        else:
            prices, ses, n = heston_kernel_exotic_book_price(k, spot, strikes, maturity, rate,
                                                             params, scheme=scheme, **kw)
            out = {"price": prices, "std_error": ses, "paths": n}
    result = {"kind": k, "model": model, "n_contracts": len(strikes),
              "strikes": [float(s) for s in strikes],
              "greek_method": "likelihood-ratio" if greeks else None}
    for key, v in out.items():
        result[key] = int(v) if key == "paths" else [float(x) for x in v.tolist()]
    return result
