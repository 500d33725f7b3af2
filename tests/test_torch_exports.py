"""The port's export lists against the reference's.

Every name of each reference ``__all__`` (the top level, ``models``, ``ops``,
``utils``, ``greeks``, ``risk``, ``surface``, ``data`` and ``optimize``) is on the port, except the names below,
which belong to modules not yet ported (ROADMAP Queue 1) or which the port
does not need.
Each later slice removes from these lists what it ports.
"""

import importlib

import pytest

NOT_YET = {
    "": set(),
    "models": set(),
    "surface": set(),
    "optimize": set(),
    "data": set(),
    "ops": set(),
    "utils": {
        # TPU-only: the port has no TPU probe and no XLA compilation cache
        "tpu_available", "enable_compilation_cache",
    },
    "greeks": set(),
    "risk": set(),
}


@pytest.mark.parametrize("sub", sorted(NOT_YET))
def test_port_exports_the_reference_names(sub):
    suffix = f".{sub}" if sub else ""
    ref = importlib.import_module("optionslab_tpu" + suffix)
    port = importlib.import_module("optionslab_tpu_torch" + suffix)
    missing = sorted(n for n in ref.__all__ if not hasattr(port, n))
    assert missing == sorted(NOT_YET[sub] & set(ref.__all__))
    assert NOT_YET[sub] <= set(ref.__all__)  # the list names no stale entry
    assert [n for n in port.__all__ if not hasattr(port, n)] == []


def test_reference_imports_work_on_the_port():
    from optionslab_tpu_torch import CrankNicolsonSolver
    from optionslab_tpu_torch.models import MonteCarloPricer, MonteCarloPricerUni, asian_price
    from optionslab_tpu_torch.models.exotics import asian_price as defined

    assert MonteCarloPricerUni is MonteCarloPricer and asian_price is defined
    assert CrankNicolsonSolver().device == "cuda"
