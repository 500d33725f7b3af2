"""The port's utilities (``optionslab_tpu_torch/utils``) against
``optionslab_tpu.utils``, on the CPU: the config constants and dtype
resolution, logging setup, the column check, the timers, profiling and the
npz pytree checkpoint in both directions (a directory the reference's npz
branch wrote restores in the port, and the other way round)."""

import io
import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from optionslab_tpu import utils as ju
from optionslab_tpu.models.heston import HestonParams as JHeston
from optionslab_tpu.utils import config as jconfig
from optionslab_tpu_torch import utils as tu
from optionslab_tpu_torch.models.heston import HestonParams
from optionslab_tpu_torch.utils import config as tconfig
from optionslab_tpu_torch.utils.exceptions import DataError, ModelError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_config_matches_reference():
    for name in ("DATA_DIR", "MODEL_DIR", "DEFAULT_SEED", "DEFAULT_BATCH_SIZE", "DEFAULT_EPOCHS",
                 "EPS_TIME", "EPS_VOL", "SKLEARN_AVAILABLE", "SCIPY_AVAILABLE",
                 "PANDAS_AVAILABLE", "YFINANCE_AVAILABLE", "OPTUNA_AVAILABLE", "ONNX_AVAILABLE"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert tu.resolve_dtype(1.0, 2) == torch.float32
    assert tu.resolve_dtype(np.ones(2), torch.ones(2)) == torch.float64
    assert tu.resolve_dtype(torch.ones(2, dtype=torch.float16), None) == torch.float16
    assert tu.resolve_dtype(3, default=torch.float64) == torch.float64
    assert tconfig.default_device_kind() == (torch.cuda.get_device_name(0)
                                             if torch.cuda.is_available() else "cpu")


def test_setup_logging_and_required_columns():
    root = logging.getLogger()
    saved, level = root.handlers[:], root.level
    try:
        root.handlers.clear()
        stream = io.StringIO()
        tu.setup_logging(logging.WARNING, stream=stream)
        tu.setup_logging(logging.INFO)  # idempotent: one handler, new level
        assert len(root.handlers) == 1 and root.level == logging.INFO
        tu.get_logger("optionslab").info("hello")
        assert "INFO optionslab: hello" in stream.getvalue()
    finally:
        root.handlers[:] = saved
        root.setLevel(level)
    df = pd.DataFrame({"a": [1.0], "b": [2.0]})
    tu.check_required_columns(df, ["a", "b"])
    for pkg in (tu, ju):
        with pytest.raises(pkg.DataError, match="'c'"):
            pkg.check_required_columns(df, ["a", "c"])

    class Frame:
        columns = ("a",)

    with pytest.raises(DataError):
        tu.check_required_columns(Frame(), ["a", "b"])


def test_timed_and_benchmark_fn():
    tu.reset_timings()
    calls = []

    @tu.timed("unit")
    def f(x):
        calls.append(x)
        return torch.ones(3) * x

    assert float(f(2.0)[0]) == 2.0 and calls == [2.0]
    f(3.0)
    assert len(tu.get_timings()["unit"]) == 2

    @tu.timed()
    def g():
        return None

    g()
    assert len(tu.get_timings()[f"{g.__module__}.{g.__qualname__}"]) == 1
    out = tu.benchmark_fn(lambda n: torch.arange(n).sum(), 100, warmup=0, iters=7)
    ref = ju.benchmark_fn(lambda n: jnp.arange(n).sum(), 100, warmup=0, iters=7)
    assert set(out) == set(ref) and out["iters"] == 7
    assert out["min_ms"] <= out["p50_ms"] <= out["p95_ms"] and out["mean_ms"] > 0
    tu.reset_timings()
    assert tu.get_timings() == {}


def test_profiling_on_the_cpu(tmp_path):
    @tu.annotate("decorated_region")
    def work(x):
        return (x @ x).sum()

    with tu.trace(str(tmp_path / "tr")) as d:
        with tu.annotate("ctx_region"):
            work(torch.ones(8, 8))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("trace.") and files[0].endswith(".json")
    names = {e.get("name") for e in json.load(open(os.path.join(d, files[0])))["traceEvents"]}
    assert {"ctx_region", "decorated_region"} <= names
    stats = tu.device_memory_stats()
    if torch.cuda.is_available():
        assert all(set(v) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
                   for v in stats.values())
    else:
        assert stats == {"cpu": None}


TREE = {"z": np.arange(3.0), "a": [np.float32(2.5), (np.ones((2, 2), np.int32), None)],
        "m": {"y": np.array(7.0), "b": np.zeros(4)}}


def _reference_npz(monkeypatch, tree, path):
    """The reference's npz branch (orbax is made unimportable)."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    assert ju.save_pytree(tree, path) == "npz"


def test_checkpoint_reads_the_reference_npz(tmp_path, monkeypatch):
    _reference_npz(monkeypatch, TREE, tmp_path / "ref")
    like = {"a": [0.0, (0, None)], "m": {"b": 0, "y": 0}, "z": torch.zeros(3)}
    got = tu.restore_pytree(tmp_path / "ref", like=like)
    assert list(got) == ["a", "m", "z"]
    np.testing.assert_array_equal(got["z"].numpy(), TREE["z"])
    assert got["a"][0].dtype == torch.float32 and float(got["a"][0]) == 2.5
    assert got["a"][1][0].dtype == torch.int32 and got["a"][1][1] is None
    assert float(got["m"]["y"]) == 7.0 and got["m"]["b"].shape == (4,)
    # fitted Heston parameters cross from the reference into the port
    jp = JHeston.make(0.05, 1.5, 0.045, 0.4, -0.6, dtype=jnp.float64)
    _reference_npz(monkeypatch, jp, tmp_path / "heston")
    hp = tu.restore_pytree(tmp_path / "heston", like=HestonParams.make())
    assert isinstance(hp, HestonParams)
    for k in ("v0", "kappa", "theta", "sigma", "rho"):
        assert hp.__dict__[k].dtype == torch.float64
        assert float(hp.__dict__[k]) == float(getattr(jp, k)), k
    with pytest.raises(ModelError):
        tu.restore_pytree(tmp_path / "heston")
    with pytest.raises(ModelError):
        tu.restore_pytree(tmp_path / "heston", like={"only": 0})
    with pytest.raises(ModelError):
        tu.restore_pytree(tmp_path / "missing", like=TREE)


def test_checkpoint_written_by_the_port_reads_in_the_reference(tmp_path):
    params = HestonParams.make(0.05, 1.5, 0.045, 0.4, -0.6, dtype=torch.float64)
    tree = {"params": params, "steps": torch.tensor(12), "hist": [torch.ones(2), None]}
    assert tu.save_pytree(tree, tmp_path / "port") == "npz"
    back = tu.restore_pytree(tmp_path / "port", like=tree)
    assert torch.equal(back["params"].rho, params.rho) and back["hist"][1] is None
    like = {"params": JHeston.make(), "steps": 0, "hist": [jnp.zeros(2), None]}
    ref = ju.restore_pytree(tmp_path / "port", like=like)
    assert float(ref["params"].kappa) == 1.5 and int(ref["steps"]) == 12
    np.testing.assert_array_equal(np.asarray(ref["hist"][0]), np.ones(2))
