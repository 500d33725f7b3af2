"""The port's ``optimize/`` (reproducibility, ``.onnx`` emission, the
``torch.export`` artifacts, the search engine, spaces, objectives and the
optimize-and-export pipeline) against ``optionslab_tpu.optimize`` on the
CPU.

The pure-Python parts are the reference's: trial seeds, folds, data hashes,
TPE suggestions on a given history and the random sampler's draws are
identical; the ``.onnx`` graph and initializers parse back equal to the
reference's. The Sobol sampler's scramble is drawn by a torch generator, so
its draws differ from the reference's and the study lifecycle is held to the
reference tests' oracles. ``torch.export`` stands in for StableHLO: a CPU
round trip here, parity across batch sizes at the reference validator's
tolerances. Two reference defects are not copied (``mean`` without
``scale``; Gemm attributes the runtime does not execute).
"""

import json
import sqlite3

import jax
import numpy as np
import pytest
import torch

from optionslab_tpu.data.synthetic import generate_synthetic_chain as j_chain
from optionslab_tpu.optimize import onnx_emit as jonnx
from optionslab_tpu.optimize import reproducibility as jrep
from optionslab_tpu.optimize import search as jsearch
from optionslab_tpu.surface import engineer_features as j_features
from optionslab_tpu.surface import nn_core as jnn
from optionslab_tpu_torch import optimize as topt
from optionslab_tpu_torch.data import ColumnTable
from optionslab_tpu_torch.optimize import onnx_emit as tonnx
from optionslab_tpu_torch.optimize import reproducibility as trep
from optionslab_tpu_torch.optimize import search as tsearch
from optionslab_tpu_torch.surface import KernelRidgeModel, MLPModel
from optionslab_tpu_torch.surface import nn_core as tnn
from optionslab_tpu_torch.utils.exceptions import ModelError, ValidationError

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(tmp_path, name="studies.db"):
    return f"sqlite:///{tmp_path / name}"


@pytest.fixture(scope="module")
def table():
    return ColumnTable.from_frame(j_features(j_chain(n_rows=120, seed=5)))


@pytest.fixture(scope="module")
def small_mlp(table):
    m = MLPModel(hidden_layers=(8,), epochs=5, seed=1, device=CPU)
    m.train(table)
    return m


# ---------------------------------------------------------------------------
# reproducibility
# ---------------------------------------------------------------------------
def test_seeds_folds_and_hashes_are_the_references():
    for args in ((42, 7, "s"), (0, 0, ""), (3, 99, "study")):
        assert trep.get_trial_seed(*args) == jrep.get_trial_seed(*args)
    for (a, b), (c, d) in zip(trep.seeded_kfold(50, 3, 9), jrep.seeded_kfold(50, 3, 9)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    x = np.arange(10)
    assert trep.compute_data_hash(x) == jrep.compute_data_hash(x)
    assert trep.compute_data_hash(x) != trep.compute_data_hash(x + 1)
    assert len({trep.get_trial_seed(42, i, "a") for i in range(100)}) == 100


def test_trial_key_global_seed_and_fingerprint(monkeypatch):
    g = trep.trial_key(42, 3, "s", device=CPU)
    assert isinstance(g, torch.Generator) and g.initial_seed() == trep.get_trial_seed(42, 3, "s")
    monkeypatch.setattr(torch, "use_deterministic_algorithms", lambda *a, **k: None)
    trep.set_global_seed(7)
    a = (np.random.rand(3), torch.rand(3))
    trep.set_global_seed(7)
    np.testing.assert_array_equal(a[0], np.random.rand(3))
    assert torch.equal(a[1], torch.rand(3))
    fp = trep.environment_fingerprint()
    assert {"python", "torch", "cuda", "numpy", "git_commit", "device"} <= set(fp)
    assert "jax" not in fp


# ---------------------------------------------------------------------------
# onnx_emit
# ---------------------------------------------------------------------------
def test_wire_format_round_trip():
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0, np.float32(0.5),
                np.asarray([1.0, -2.0, 3.5], np.float32)):
        name, back = tonnx._parse_tensor(tonnx._tensor_proto("w", np.asarray(arr)))
        assert name == "w"
        np.testing.assert_array_equal(back, np.asarray(arr))


@pytest.mark.parametrize("kw", [
    dict(layernorm=False), dict(layernorm=True),
    dict(layernorm=False, mean=[1.0, -2.0, 0.5], scale=[2.0, 0.5, 3.0]),
    dict(layernorm=True, out_scale=[2.0, 3.0], out_mean=[0.1, -0.1]),
    dict(layernorm=False, activation="tanh"), dict(layernorm=False, activation="relu"),
], ids=["plain", "layernorm", "scaler", "affine", "tanh", "relu"])
def test_onnx_graph_is_the_references(tmp_path, kw):
    """The port's file parses back to the reference's nodes, initializers,
    inputs, outputs and metadata (only the producer name differs), and the
    lite runtime matches the port's forward to 3e-5."""
    ref = jnn.init_mlp(jax.random.PRNGKey(3), [3, 8, 2])
    port = tnn.params_from_numpy(jnn.flatten_params(ref), CPU)
    kw = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in kw.items()}
    manifest = tonnx.export_mlp_onnx(port, tmp_path / "port.onnx", metadata={"model": "X"}, **kw)
    jonnx.export_mlp_onnx(ref, tmp_path / "ref.onnx", metadata={"model": "X"}, **kw)
    mine, theirs = (tonnx.OnnxLiteRuntime(tmp_path / "port.onnx"),
                    jonnx.OnnxLiteRuntime(tmp_path / "ref.onnx"))
    assert mine.nodes == theirs.nodes and mine.metadata == theirs.metadata
    assert (mine.input_names, mine.output_names) == (theirs.input_names, theirs.output_names)
    assert mine.tensors.keys() == theirs.tensors.keys()
    for k in mine.tensors:
        np.testing.assert_array_equal(mine.tensors[k], theirs.tensors[k])
    assert b"optionslab_tpu_torch" in (tmp_path / "port.onnx").read_bytes()
    x = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    act = {"tanh": torch.tanh, "relu": torch.relu}.get(kw.get("activation"), tnn.gelu_tanh)
    xs = (x - kw["mean"]) / kw["scale"] if "mean" in kw else x
    native = tnn.apply_mlp(port, torch.as_tensor(xs), layernorm=kw["layernorm"],
                           activation=act).numpy()
    if "out_scale" in kw:
        native = native * kw["out_scale"] + kw["out_mean"]
    np.testing.assert_allclose(mine.predict(x), native, atol=3e-5, rtol=1e-4)
    assert manifest["opset"] == 17 and manifest["input_shape"] == [None, 3]
    assert json.loads((tmp_path / "port.onnx.json").read_text())["model"] == "X"


def test_onnx_mean_without_scale_raises(tmp_path):
    """The reference fails inside numpy on ``mean`` without ``scale``; the
    port refuses with ValidationError, either way round."""
    params = tnn.init_mlp(tnn.make_generator(0, CPU), [2, 3, 1])
    for kw in (dict(mean=np.zeros(2, np.float32)), dict(scale=np.ones(2, np.float32))):
        with pytest.raises(ValidationError):
            tonnx.export_mlp_onnx(params, tmp_path / "x.onnx", **kw)
    with pytest.raises(ValidationError):
        tonnx.export_mlp_onnx(params, tmp_path / "x.onnx", activation="swish")
    with pytest.raises(ValidationError):
        tonnx.export_mlp_onnx([], tmp_path / "e.onnx")


@pytest.mark.parametrize("attrs", [
    [tonnx._attr_float("alpha", 2.0)], [tonnx._attr_float("beta", 0.5)],
    [tonnx._attr_int("transA", 1)], [tonnx._attr_int("transB", 1)],
], ids=["alpha", "beta", "transA", "transB"])
def test_onnx_runtime_refuses_gemm_attributes_it_does_not_execute(tmp_path, attrs):
    """The reference's runtime ignores them and computes A @ B + C; the
    port's raises ModelError. Default-valued attributes run."""
    def graph(attrs):
        g = tonnx.OnnxGraphBuilder()
        g.set_input("x", (None, 2))
        w = g.initializer("w", np.eye(2, dtype=np.float32))
        b = g.initializer("b", np.zeros(2, np.float32))
        h = g.node("Gemm", ["x", w, b], "h", attrs=attrs)
        g._nodes.append(tonnx._node("Identity", [h], ["y"]))
        g.set_output("y", (None, 2))
        return g.serialize()

    (tmp_path / "bad.onnx").write_bytes(graph(attrs))
    with pytest.raises(ModelError, match="Gemm"):
        tonnx.OnnxLiteRuntime(tmp_path / "bad.onnx").predict(np.ones((1, 2), np.float32))
    (tmp_path / "ok.onnx").write_bytes(graph([tonnx._attr_float("alpha", 1.0),
                                              tonnx._attr_int("transB", 0)]))
    np.testing.assert_array_equal(
        tonnx.OnnxLiteRuntime(tmp_path / "ok.onnx").predict(np.ones((1, 2), np.float32)),
        np.ones((1, 2), np.float32))


def test_surface_model_onnx_round_trip(small_mlp, table, tmp_path):
    manifest = topt.export_surface_model_onnx(small_mlp, tmp_path / "mlp.onnx")
    assert manifest["roundtrip_max_abs_err"] <= 2e-5
    rows = table.take(np.arange(10))
    raw = small_mlp.scaler.inverse_transform(small_mlp._features_matrix(rows)).astype(np.float32)
    np.testing.assert_allclose(topt.OnnxLiteRuntime(tmp_path / "mlp.onnx").predict(raw).ravel(),
                               small_mlp.predict_volatility(rows), rtol=1e-4, atol=2e-5)
    with pytest.raises(ModelError):
        topt.export_surface_model_onnx(MLPModel(device=CPU), tmp_path / "x.onnx")
    with pytest.raises(ModelError):
        topt.OnnxLiteRuntime(tmp_path / "missing.onnx")


# ---------------------------------------------------------------------------
# torch.export artifacts
# ---------------------------------------------------------------------------
def test_exporter_round_trip_polymorphism_and_validation(tmp_path):
    w = torch.ones(4, 2)

    def fn(x):
        return torch.tanh(x @ w) * 3.0

    res = topt.ModelExporter.export(fn, np.zeros((8, 4), np.float32), tmp_path / "m.pt2")
    assert res.n_bytes > 0 and res.input_dtype == "float32"
    meta = json.loads((tmp_path / "m.pt2.json").read_text())
    assert set(meta) == {"format", "input_shape", "input_dtype", "batch_polymorphic", "created"}
    assert meta["format"] == "torch.export"
    engine = topt.InferenceEngine(tmp_path / "m.pt2", device=CPU)
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    report = topt.ExportValidator().validate_batch_sizes(fn, engine, [x, x[:1], x[:3]])
    assert report.passed and report.batch_sizes == [16, 1, 3], report.summary()
    assert engine.predict_batch(np.tile(x, (3, 1)), chunk_size=7).shape == (48, 2)
    assert engine.benchmark(x, iters=3)["p50_ms"] > 0
    with pytest.raises(ValidationError):
        engine.predict(np.ones((2, 5), np.float32))
    with pytest.raises(ValidationError):
        engine.predict(np.ones((2, 4), np.float64))
    with pytest.raises(ModelError):
        topt.InferenceEngine(tmp_path / "missing.pt2", device=CPU)


def test_export_surface_model_matches_the_live_model(small_mlp, table, tmp_path):
    res = topt.export_surface_model(small_mlp, tmp_path / "mlp.pt2")
    engine = topt.InferenceEngine(res.path, device=CPU)
    rows = table.take(np.arange(10))
    raw = small_mlp.scaler.inverse_transform(small_mlp._features_matrix(rows)).astype(np.float32)
    np.testing.assert_allclose(engine.predict(raw).ravel(), small_mlp.predict_volatility(rows),
                               rtol=1e-4, atol=1e-5)
    assert engine.metadata["model"] == "MLPModel"
    assert engine.metadata["features"] == small_mlp.feature_columns
    with pytest.raises(ModelError):
        topt.export_surface_model(MLPModel(device=CPU), tmp_path / "x.pt2")


# ---------------------------------------------------------------------------
# the search engine
# ---------------------------------------------------------------------------
class _History:
    """A study's trial history, for samplers of both packages."""

    def __init__(self, trials, direction="minimize"):
        self.trials, self.direction = trials, direction


@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_tpe_suggestions_are_the_references(direction):
    """On the same history (unit coordinates and values), the port's TPE
    draws the reference's numbers exactly."""
    rng = np.random.default_rng(3)
    units = rng.uniform(size=(14, 2))
    values = (units[:, 0] - 0.7) ** 2 + (units[:, 1] - 0.3) ** 2
    draws = {}
    for pkg in (tsearch, jsearch):
        trials = [pkg.FrozenTrial(i, {}, float(v), "COMPLETE", 0,
                                  unit={"x": float(u[0]), "y": float(u[1])})
                  for i, (u, v) in enumerate(zip(units, values))]
        sampler = pkg.TPESampler(seed=42)
        sampler.attach(_History(trials, direction))
        draws[pkg] = [sampler.draw(n, name) for n in range(14, 20) for name in ("x", "y")]
    assert draws[tsearch] == draws[jsearch]
    assert [tsearch.RandomSampler(7).draw(i, "x") for i in range(5)] == \
        [jsearch.RandomSampler(7).draw(i, "x") for i in range(5)]


def test_sobol_sampler_covers_the_box():
    s = tsearch.SobolSampler(seed=1)
    draws = [s.draw(i, "x") for i in range(64)]
    hist, _ = np.histogram(draws, bins=8, range=(0, 1))
    assert (hist > 0).all()
    assert s.draw(3, "y") != s.draw(3, "x")


def _basin(trial, seed):  # tests/test_optimization.py:166
    x = trial.suggest_float("x", 0.0, 1.0)
    y = trial.suggest_float("y", 0.0, 1.0)
    return (x - 0.73) ** 2 + (y - 0.31) ** 2


def test_tpe_beats_sobol_and_resumes(tmp_path):
    """The reference tests' oracles: TPE's best at 40 trials at least
    Sobol's, ≥ 5 of its last 10 trials near the basin; a study resumed at 20
    trials draws the same 40 as a whole one."""
    url = _db(tmp_path)
    r_tpe = tsearch.StudyManager("tpe", url, sampler="tpe").optimize(_basin, n_trials=40)
    r_sobol = tsearch.StudyManager("sobol", url, sampler="sobol").optimize(_basin, n_trials=40)
    assert r_tpe.best_value <= r_sobol.best_value
    tail = tsearch.StudyManager("tpe", url, sampler="tpe").trials[-10:]
    assert sum(abs(t.params["x"] - 0.73) < 0.2 and abs(t.params["y"] - 0.31) < 0.2
               for t in tail) >= 5
    half = tsearch.StudyManager("half", url, sampler="tpe")
    half.optimize(_basin, n_trials=20)
    resumed = tsearch.StudyManager("half", url, sampler="tpe")
    assert resumed.resumed and len(resumed.trials) == 20
    assert all(set(t.unit) == {"x", "y"} for t in resumed.trials)
    assert resumed.optimize(_basin, n_trials=20).n_trials == 40
    assert [t.params for t in resumed.trials] == \
        [t.params for t in tsearch.StudyManager("tpe", url, sampler="tpe").trials]


def test_study_lifecycle(tmp_path):
    """The reference tests' study oracles: the store, the best of a
    quadratic, failures counted, pruning, maximize, JSON, duplicate names."""
    url = _db(tmp_path)
    res = topt.StudyManager("quadratic", url).optimize(
        lambda t, s: (t.suggest_float("x", -5.0, 5.0) - 2.0) ** 2, n_trials=40)
    assert (tmp_path / "studies.db").exists() and res.n_complete == 40
    assert res.best_value < 1.0
    with sqlite3.connect(tmp_path / "studies.db") as c:
        assert c.execute("SELECT COUNT(*) FROM trials WHERE study='quadratic'").fetchone()[0] == 40

    def flaky(trial, seed):
        x = trial.suggest_float("x", 0.0, 1.0)
        if x < 0.5:
            raise RuntimeError("numerical explosion")
        return x

    res = topt.StudyManager("flaky", url).optimize(flaky, n_trials=20)
    assert res.n_failed > 0 and res.n_complete + res.n_failed == 20
    with pytest.raises(RuntimeError):
        topt.StudyManager("strict", url).optimize(flaky, n_trials=20, catch_exceptions=False)

    def pruned(trial, seed):
        x = trial.suggest_float("x", 0.0, 1.0)
        for step in range(3):
            trial.report(x, step)
            if trial.should_prune():
                raise topt.TrialPruned()
        return x

    res = topt.StudyManager("pruned", url, pruner=topt.MedianPruner(3, 0)).optimize(
        pruned, n_trials=30)
    assert res.n_pruned > 0 and res.n_complete + res.n_pruned == 30
    res = topt.StudyManager("maxi", url, direction="maximize").optimize(
        lambda t, s: t.suggest_float("x", 0.0, 1.0), n_trials=30)
    assert res.best_value > 0.8
    payload = res.to_json(tmp_path / "result.json")
    assert "torch" in res.metadata and "best_params" in payload
    with pytest.raises(ValidationError):
        topt.StudyManager("maxi", url, load_if_exists=False)
    with pytest.raises(ValidationError):
        topt.StudyManager("bad", url, sampler="gp-ucb")
    with pytest.raises(ValidationError):
        topt.StudyManager("bad", "postgres://x")


# ---------------------------------------------------------------------------
# spaces, objectives, wrappers
# ---------------------------------------------------------------------------
class _Fixed:
    def __init__(self, params):
        self.params, self.reports = params, []

    def suggest_float(self, name, *a, **k):
        return self.params[name]

    suggest_int = suggest_categorical = suggest_float

    def report(self, value, step):
        self.reports.append((step, value))

    def should_prune(self):
        return False


def test_spaces():
    from optionslab_tpu.optimize import spaces as jspaces

    for name in ("MLPSearchSpace", "GradientBoostingSearchSpace", "KernelRidgeSearchSpace",
                 "SurrogateSearchSpace"):
        space = getattr(topt, name)()
        assert space.get_default_params() == getattr(jspaces, name)().get_default_params()
        space.validate(space.get_default_params())
    trial = _Fixed({"n_layers": 2, "width": 32, "dropout_rate": 0.2, "learning_rate": 1e-3,
                    "batch_size": 64})
    assert topt.MLPSearchSpace().suggest(trial)["hidden_layers"] == (32, 32)
    with pytest.raises(ValidationError):
        topt.MLPSearchSpace().validate({"hidden_layers": (), "dropout_rate": 0.1})
    with pytest.raises(ValidationError):
        topt.KernelRidgeSearchSpace().validate({"gamma": -1.0, "alpha": 1e-3})


def test_objectives_run_without_pandas(table):
    assert topt.get_metric("rmse")(np.zeros(2), np.ones(2)) == 1.0
    with pytest.raises(ValidationError):
        topt.get_metric("r2")
    objective = topt.make_surface_model_objective(KernelRidgeModel, topt.KernelRidgeSearchSpace(),
                                                  table, n_folds=2, device=CPU)
    trial = _Fixed({"gamma": 0.5, "alpha": 1e-3})
    score = objective(trial, 11)
    assert 0 < score < 0.1 and [s for s, _ in trial.reports] == [0, 1]
    objective = topt.make_surrogate_objective(topt.SurrogateSearchSpace(), n_train=1_000,
                                              n_eval=200, device=CPU)
    assert objective(_Fixed({"n_layers": 1, "width": 64, "learning_rate": 1e-3,
                             "epochs": 2}), 5) > 0
    calls = []

    def builder(market, batch, learning_rate, n_steps):
        calls.append((market, batch, learning_rate, n_steps))
        return None, 0.5

    objective = topt.make_calibration_objective(builder, "m", "b")
    assert objective(_Fixed({"learning_rate": 0.01, "n_steps": 60}), 0) == 0.5
    assert calls == [("m", "b", 0.01, 60)]


def test_optimize_and_export(table, tmp_path):
    out = topt.optimize_and_export(table, tmp_path / "best.pt2", n_trials=2,
                                   storage=_db(tmp_path), final_epochs=5, emit_onnx=True,
                                   device=CPU)
    assert out["study"].n_trials == 2 and (tmp_path / "best.onnx").exists()
    assert out["onnx"]["roundtrip_max_abs_err"] <= 2e-5
    x = np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32)
    iv = topt.OnnxLiteRuntime(tmp_path / "best.onnx").predict(x)
    assert iv.shape == (4, 1) and np.all(np.isfinite(iv))
    np.testing.assert_allclose(topt.InferenceEngine(tmp_path / "best.pt2", device=CPU).predict(x),
                               iv, atol=2e-5)
    manager, objective = topt.create_mlp_optimizer(table, "mlp", _db(tmp_path), device=CPU)
    assert isinstance(manager, topt.StudyManager) and callable(objective)
