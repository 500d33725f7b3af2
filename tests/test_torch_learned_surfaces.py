"""The port's learned surfaces (``optionslab_tpu_torch/surface``: the MLP core,
the MLP, the PINN, kernel ridge, the quote interpolator, the forests and grid
search) against ``optionslab_tpu.surface`` on the same inputs, on the CPU.

Randomness differs by design (torch generators in place of JAX keys), so the
deterministic functions are compared on weights carried across
(``nn_core.params_from_numpy(flatten_params(...))``): the forward to 1e-5,
one clipped AdamW step and one cosine-scheduled PINN step to 1e-6 relative,
the PINN's w, derivatives, g and penalties to 1e-5 relative, the kernel
predictors to 1e-4; the folds are identical. Whole small fits are held to
the reference tests' own oracles. The reference's float32 functions stay
float32 under the session's x64.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import torch.nn.functional as F

from optionslab_tpu.data.synthetic import generate_synthetic_chain as j_chain
from optionslab_tpu.data.synthetic import generate_synthetic_surface
from optionslab_tpu.surface import engineer_features as j_features
from optionslab_tpu.surface import generator as jgen
from optionslab_tpu.surface import grid_search as jgrid
from optionslab_tpu.surface import kernel_ridge as jkr
from optionslab_tpu.surface import mlp as jmlp
from optionslab_tpu.surface import nn_core as jnn
from optionslab_tpu.surface import pinn as jpinn
from optionslab_tpu_torch.data import ColumnTable
from optionslab_tpu_torch.surface import forest as tforest
from optionslab_tpu_torch.surface import generator as tgen
from optionslab_tpu_torch.surface import grid_search as tgrid
from optionslab_tpu_torch.surface import kernel_ridge as tkr
from optionslab_tpu_torch.surface import mlp as tmlp
from optionslab_tpu_torch.surface import nn_core as tnn
from optionslab_tpu_torch.surface import pinn as tpinn
from optionslab_tpu_torch.surface.base import TARGET_COLUMN
from optionslab_tpu_torch.utils.exceptions import (DataError, DependencyError, ModelError,
                                                   ValidationError)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes on a
    few cores, where torch's thread pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _num(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carried(ref_params):
    """The port's params from the reference's (CPU)."""
    return tnn.params_from_numpy(jnn.flatten_params(ref_params), CPU)


def _close_leaves(port, ref):
    """Leaf by leaf to 1e-6 relative of the leaf's scale (its largest
    magnitude): Adam's first steps scale each entry to ±lr, so an entry
    whose gradient is near zero may move by a few float32 ulps of the
    gradient's rounding."""
    for a, b in zip(tnn.leaves(port), tnn.leaves(ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(_num(a), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def _ref_params(sizes, seed=0, ln_noise=False):
    """Reference params, float32; with ``ln_noise`` LayerNorm scales and
    biases away from 1 and 0 so that they matter."""
    params = jnn.init_mlp(jax.random.PRNGKey(seed), sizes)
    if ln_noise:
        rng = np.random.default_rng(seed)
        for layer in params:
            n = layer["b"].shape[0]
            layer["ln_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
            layer["ln_bias"] = jnp.asarray(rng.normal(0, 0.1, n), jnp.float32)
            layer["b"] = jnp.asarray(rng.normal(0, 0.1, n), jnp.float32)
    return params


@pytest.fixture(scope="module")
def chain():
    """400 synthetic quotes with the 7 features: a pandas frame for the
    reference and a column table for the port."""
    df = j_features(j_chain(n_rows=400, seed=3))
    return df, ColumnTable.from_frame(df)


# ---------------------------------------------------------------------------
# nn_core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layernorm", [False, True])
def test_apply_mlp_matches_reference_on_carried_weights(layernorm):
    """1e-5: GELU in its tanh form, LayerNorm with the population variance."""
    ref = _ref_params([7, 16, 16, 1], seed=1, ln_noise=True)
    x = np.random.default_rng(2).normal(size=(64, 7)).astype(np.float32)
    want = np.asarray(jnn.apply_mlp(ref, jnp.asarray(x), layernorm=layernorm))
    got = tnn.apply_mlp(_carried(ref), torch.as_tensor(x), layernorm=layernorm)
    np.testing.assert_allclose(_num(got), want, rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; torch's F.gelu
    default (erf) differs by more than 1e-4, the port's forms agree to 1e-6."""
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = torch.as_tensor(x)
    np.testing.assert_allclose(_num(tnn.gelu_tanh(t)), want, atol=1e-6)
    np.testing.assert_allclose(_num(tnn.gelu_tanh_ops(t)), want, atol=1e-6)
    assert np.abs(_num(F.gelu(t)) - want).max() > 1e-4


def test_gelu_ops_third_derivative_is_finite():
    """The PINN differentiates its GELU three times: the elementary-op form
    stays finite where torch's fused GELU gives NaN (|x| ≈ 20, float32)."""
    x = torch.tensor([-20.0, -9.0, 0.0, 9.0, 20.0], requires_grad=True)
    d1, = torch.autograd.grad(tnn.gelu_tanh_ops(x).sum(), x, create_graph=True)
    d2, = torch.autograd.grad(d1.sum(), x, create_graph=True)
    d3, = torch.autograd.grad(d2.sum(), x)
    assert bool(torch.isfinite(d3).all())


def test_layernorm_uses_the_population_variance():
    """Width 3, where n and n − 1 differ by a third: the reference's h.var
    is the population variance with 1e-6 inside the square root."""
    ref = _ref_params([2, 3, 1], seed=4, ln_noise=True)
    x = np.random.default_rng(5).normal(size=(16, 2)).astype(np.float32)
    want = np.asarray(jnn.apply_mlp(ref, jnp.asarray(x), layernorm=True))
    np.testing.assert_allclose(_num(tnn.apply_mlp(_carried(ref), torch.as_tensor(x))), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_clipped_adamw_steps_match_optax(scale):
    """Two steps of optax.chain(clip_by_global_norm(1), adamw(1e-3, wd))
    against ClippedAdamW on the same gradients: 1e-6 relative
    (``_close_leaves``). The global norm is below the clip in one case,
    above it in the other."""
    ref = _ref_params([4, 8, 2], seed=6, ln_noise=True)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * scale, jnp.float32),
                          ref) for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=1e-5))
    state = opt.init(ref)
    p_ref = ref
    for g in grads:
        u, state = opt.update(g, state, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
    port = _carried(ref)
    t_opt = tnn.ClippedAdamW(port, 1e-3, weight_decay=1e-5, max_norm=1.0)
    for g in grads:
        t_opt.step([torch.tensor(np.asarray(v)) for v in tnn.leaves(g)])
    _close_leaves(port, p_ref)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(3e-3, 50, alpha=0.02)
    mine = tnn.cosine_decay_schedule(3e-3, 50, alpha=0.02)
    for c in (0, 1, 17, 49, 50, 80):
        assert mine(c) == pytest.approx(float(sched(c)), rel=1e-6)


def test_flatten_round_trip_and_generator_init():
    params = tnn.init_mlp(tnn.make_generator(0, CPU), [3, 5, 1])
    back = tnn.params_from_numpy(tnn.flatten_params(params), CPU)
    assert set(tnn.flatten_params(params)) == {f"layer{i}_{k}" for i in range(2)
                                              for k in ("w", "b", "ln_scale", "ln_bias")}
    for a, b in zip(tnn.leaves(params), tnn.leaves(back)):
        assert torch.equal(a, b)
    # He initialisation: std √(2/fan_in), zero biases, unit LayerNorm scales
    big = tnn.init_mlp(tnn.make_generator(1, CPU), [400, 300])[0]
    assert float(big["w"].std()) == pytest.approx(np.sqrt(2 / 400), rel=0.02)
    assert float(big["b"].abs().max()) == 0.0 and float(big["ln_scale"].min()) == 1.0


def test_mc_dropout_without_dropout_is_the_forward():
    ref = _ref_params([3, 8, 1], seed=8)
    p = _carried(ref)
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(10, 3)).astype(np.float32))
    mean, std = tnn.mc_dropout_predict(p, x, tnn.make_generator(0, CPU), n_samples=4,
                                       dropout_rate=0.0)
    np.testing.assert_allclose(_num(mean), _num(tnn.apply_mlp(p, x)), rtol=1e-6)
    assert float(std.max()) < 1e-6
    mean, std = tnn.mc_dropout_predict(p, x, tnn.make_generator(0, CPU), n_samples=16,
                                       dropout_rate=0.3)
    assert mean.shape == (10, 1) and float(std.min()) >= 0 and float(std.max()) > 0


def test_train_mlp_fast_path_is_deterministic_and_keeps_the_best_iterate():
    x = np.random.default_rng(10).normal(size=(120, 3)).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.1 * x[:, 1]
    params = tnn.init_mlp(tnn.make_generator(0, CPU), [3, 8, 1])
    runs = [tnn.train_mlp(params, x, y, generator=tnn.make_generator(1, CPU), epochs=12,
                          batch_size=32, layernorm=False) for _ in range(2)]
    for a, b in zip(tnn.leaves(runs[0][0]), tnn.leaves(runs[1][0])):
        assert torch.equal(a, b)
    hist = runs[0][1]
    assert len(hist["val_loss"]) == 12
    assert hist["best_val_loss"] == pytest.approx(min(hist["val_loss"]), rel=1e-6)


def test_train_mlp_early_stopping_path_stops_after_patience():
    x = np.random.default_rng(11).normal(size=(80, 2)).astype(np.float32)
    y = np.zeros(80, np.float32)
    params = tnn.init_mlp(tnn.make_generator(0, CPU), [2, 4, 1])
    _, hist = tnn.train_mlp(params, x, y, lambda p, xb: 1e3 * (p[0]["w"] ** 2).sum(),
                            generator=tnn.make_generator(0, CPU), epochs=200, patience=3,
                            learning_rate=0.5, batch_size=16, layernorm=False)
    assert len(hist["val_loss"]) < 200
    assert hist["best_epoch"] + 3 >= len(hist["val_loss"]) - 1


def test_full_fp32_is_required(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(ModelError):
        tnn.require_full_fp32()


# ---------------------------------------------------------------------------
# MLPModel
# ---------------------------------------------------------------------------
def test_mlp_smoothness_penalty_matches_reference():
    ref = _ref_params([7, 16, 16, 1], seed=12)
    x = np.random.default_rng(13).normal(size=(32, 7)).astype(np.float32)
    grads = jax.vmap(jax.grad(lambda xx: jnn.apply_mlp(ref, xx[None, :],
                                                       layernorm=False).sum()))(jnp.asarray(x))
    want = 0.3 * float(jnp.mean(grads**2))
    got = float(tmlp.smoothness_penalty(_carried(ref), torch.as_tensor(x), 0.3, False).detach())
    assert got == pytest.approx(want, rel=1e-5)


def _ref_mlp(df, hidden=(16,), seed=14):
    """A reference MLPModel with initialised (untrained) weights and a
    fitted scaler: no jit training needed to compare the deterministic
    parts."""
    m = jmlp.MLPModel(hidden_layers=hidden, seed=seed)
    m._features_matrix(df, fit_scaler=True)
    m.params = _ref_params([7, *hidden, 1], seed=seed)
    m.is_trained = True
    return m


def test_mlp_predictions_and_input_gradients_match_reference(chain, tmp_path):
    df, table = chain
    ref = _ref_mlp(df)
    ref.save_model(tmp_path / "ref")
    port = tmlp.MLPModel(device=CPU).load_model(tmp_path / "ref")
    np.testing.assert_allclose(port.predict_volatility(table), ref.predict_volatility(df),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.input_gradients(table.take(np.arange(20))),
                               ref.input_gradients(df.head(20)), rtol=1e-4, atol=1e-6)


def test_mlp_saved_by_the_port_loads_in_the_reference(chain, tmp_path):
    df, table = chain
    m = tmlp.MLPModel(hidden_layers=(8,), epochs=5, seed=2, device=CPU)
    m.train(table)
    m.save_model(tmp_path / "port")
    ref = jmlp.MLPModel().load_model(tmp_path / "port")
    np.testing.assert_allclose(ref.predict_volatility(df), m.predict_volatility(table),
                               rtol=1e-5, atol=1e-6)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["__class__"] == "MLPModel" and meta["layernorm"] is False


def test_mlp_fit_beats_the_constant(chain):
    """tests/test_surface_models.py:98's oracle: rmse below the target's std
    and r2 above 0.5 (a small, fast fit: (16, 16) on 256 quotes, 30 epochs
    of batch 16 at a learning rate of 1e-2)."""
    _, table = chain
    table = table.take(np.arange(256))
    m = tmlp.MLPModel(hidden_layers=(16, 16), epochs=30, batch_size=16, learning_rate=1e-2,
                      seed=1, device=CPU)
    metrics = m.train(table)
    assert metrics["rmse"] < float(np.std(table[TARGET_COLUMN]))
    assert metrics["r2"] > 0.5
    mean, std = m.predict_with_uncertainty(table.take(np.arange(32)), mc_samples=16)
    assert mean.shape == (32,) and np.all(std >= 0) and std.max() > 0
    assert m.input_gradients(table.take(np.arange(8))).shape == (8, 7)


def test_mlp_with_smoothness_trains_and_predict_before_train_raises(chain):
    _, table = chain
    with pytest.raises(ModelError):
        tmlp.MLPModel(device=CPU).predict_volatility(table)
    m = tmlp.MLPModel(hidden_layers=(8,), epochs=4, smoothness_weight=0.01, device=CPU)
    m.train(table)
    assert np.isfinite(m.predict_volatility(table)).all()


# ---------------------------------------------------------------------------
# PINN
# ---------------------------------------------------------------------------
K_PTS = np.linspace(-0.6, 0.5, 23).astype(np.float32)
T_PTS = np.linspace(0.05, 2.0, 23).astype(np.float32)


@pytest.fixture(scope="module")
def pinn_params():
    ref = _ref_params([2, 16, 16, 1], seed=15)
    ref[-1]["b"] = ref[-1]["b"].at[0].set(-3.0)  # w ≈ softplus(−3) ≈ 0.05
    return ref


def test_pinn_w_derivatives_g_and_penalties_match_reference(pinn_params):
    """1e-5 relative: w, ∂w/∂k, ∂²w/∂k², ∂w/∂T, Gatheral's g and the three
    penalties, per point by autograd of the summed output."""
    ref, port = pinn_params, _carried(pinn_params)
    k, t = jnp.asarray(K_PTS), jnp.asarray(T_PTS)
    tk, tt = torch.as_tensor(K_PTS), torch.as_tensor(T_PTS)
    w, dwdk, d2wdk2, dwdt = tpinn._w_derivs(port, tk, tt)

    def w_fn(a, b):
        return jpinn._w_fn(ref, a, b)

    want_w = np.asarray(jax.jit(jpinn._w_fn)(ref, k, t))
    want_dk = np.asarray(jax.jit(jax.vmap(jax.grad(w_fn)))(k, t))
    want_d2 = np.asarray(jax.jit(jax.vmap(jax.grad(jax.grad(w_fn))))(k, t))
    want_dt = np.asarray(jax.jit(jax.vmap(jax.grad(w_fn, argnums=1)))(k, t))
    for got, want in ((w, want_w), (dwdk, want_dk), (d2wdk2, want_d2), (dwdt, want_dt)):
        np.testing.assert_allclose(_num(got), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_num(tpinn._g_fn(port, tk, tt)),
                               np.asarray(jax.jit(jpinn._g_fn)(ref, k, t)), rtol=1e-5, atol=1e-6)
    for name in ("calendar_penalty", "butterfly_penalty", "wing_penalty"):
        got = float(getattr(tpinn, name)(port, tk, tt).detach())
        want = float(jax.jit(getattr(jpinn, name))(ref, k, t))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-9), name


def _loss_inputs(df):
    k = np.asarray(df["log_moneyness"], np.float32)
    t = np.asarray(df["time_to_maturity"], np.float32)
    iv = np.asarray(df[TARGET_COLUMN], np.float32)
    return k, t, iv


def test_pinn_cosine_scheduled_steps_match_reference(chain, pinn_params):
    """Two annealed, cosine-scheduled clipped-AdamW steps (counts 0 and 1)
    on the reference's own collocation draws: the loss and fit to 1e-5
    relative, the params after each step to 1e-6 relative
    (``_close_leaves``)."""
    df, _ = chain
    k, t, iv = _loss_inputs(df.head(60))
    ranges = (-0.9, 0.7, 0.02, 2.5)
    lam_w = (1.0, 1.0, 0.1)
    n_col, epochs = 64, 40
    j_ranges = tuple(jnp.float32(v) for v in ranges)
    j_lam_w = tuple(jnp.float32(v) for v in lam_w)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(optax.cosine_decay_schedule(3e-3, epochs, alpha=0.02),
                                  weight_decay=1e-6))
    p_ref, state = pinn_params, opt.init(pinn_params)
    port = _carried(pinn_params)
    t_opt = tnn.ClippedAdamW(port, tnn.cosine_decay_schedule(3e-3, epochs, alpha=0.02),
                             weight_decay=1e-6, max_norm=1.0)
    key = jax.random.PRNGKey(3)
    loss_grad = jax.jit(jax.value_and_grad(jpinn._pinn_loss, has_aux=True),
                        static_argnums=8)
    for e, lam in ((0, 0.25), (1, 1.0)):
        ck = jax.random.fold_in(key, 100 + e)
        (loss, fit), g = loss_grad(p_ref, ck, jnp.float32(lam), jnp.asarray(k), jnp.asarray(t),
                                   jnp.asarray(iv), j_lam_w, j_ranges, n_col)
        u, state = opt.update(g, state, p_ref)
        p_ref = optax.apply_updates(p_ref, u)
        kk = jax.random.uniform(ck, (n_col,), jnp.float32, j_ranges[0], j_ranges[1])
        tt = jax.random.uniform(jax.random.fold_in(ck, 1), (n_col,), jnp.float32,
                                j_ranges[2], j_ranges[3])
        live = [{n: v.detach().requires_grad_(True) for n, v in layer.items()} for layer in port]
        t_loss, t_fit = tpinn._pinn_loss(live, torch.tensor(np.asarray(kk)),
                                         torch.tensor(np.asarray(tt)), lam,
                                         torch.as_tensor(k), torch.as_tensor(t),
                                         torch.as_tensor(iv), lam_w)
        assert float(t_loss.detach()) == pytest.approx(float(loss), rel=1e-5)
        assert float(t_fit.detach()) == pytest.approx(float(fit), rel=1e-5)
        t_opt.step(torch.autograd.grad(t_loss, tnn.leaves(live), allow_unused=True,
                                       materialize_grads=True))
        _close_leaves(port, p_ref)


def test_member_selection_stats_match_reference():
    """The reference test's two hand-built members (a clean one and one with
    calendar arbitrage): the quote RMSE and the worst audit violation."""
    def linear_net(w_t, b):
        return [{"w": jnp.asarray([[1.0, 0.0], [0.0, 1.0]], jnp.float32),
                 "b": jnp.zeros(2, jnp.float32)},
                {"w": jnp.asarray([[0.0], [w_t]], jnp.float32),
                 "b": jnp.asarray([b], jnp.float32)}]

    members = [linear_net(0.04, 0.0), linear_net(-0.4, 0.5)]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    k_obs = np.linspace(-0.2, 0.2, 16).astype(np.float32)
    t_obs = np.full(16, 0.5, np.float32)
    iv = np.full(16, 0.2, np.float32)
    ranges = (-0.5, 0.5, 0.05, 2.0)
    rmse, viol = jpinn._member_selection_stats(stack, jnp.asarray(k_obs), jnp.asarray(t_obs),
                                               jnp.asarray(iv),
                                               tuple(jnp.float32(v) for v in ranges))
    port = [{n: torch.as_tensor(np.stack([np.asarray(m[i][n]) for m in members]))
             for n in members[0][i]} for i in range(2)]
    t_rmse, t_viol = tpinn._member_selection_stats(port, torch.as_tensor(k_obs),
                                                   torch.as_tensor(t_obs), torch.as_tensor(iv),
                                                   ranges)
    np.testing.assert_allclose(_num(t_rmse), np.asarray(rmse), rtol=1e-5)
    np.testing.assert_allclose(_num(t_viol), np.asarray(viol), rtol=1e-5, atol=1e-7)
    assert float(t_viol[1]) > 0.05 and float(t_viol[0]) < float(t_viol[1])


@pytest.mark.parametrize("rmse,viol,want", [
    ([0.02, 0.011], [1e-2, 0.0], 1),
    ([0.03, 0.01, 0.02], [0.0, 1e-9, 0.0], 1),
    ([0.05, 0.01], [1e-3, 1e-2], 1),
    ([np.nan, 0.02], [np.nan, 0.0], 1),
    ([0.02, np.nan], [0.0, np.nan], 0),
    ([np.nan, 0.02], [0.0, 0.0], 1),
    ([0.01, 0.02], [np.nan, 1e-9], 1),
])
def test_select_ensemble_member_matches_reference(rmse, viol, want):
    """Arbitrage-clean first, then the quote RMSE; a NaN member ranks last."""
    assert tpinn.select_ensemble_member(rmse, viol) == want
    assert jpinn.select_ensemble_member(rmse, viol) == want


def test_pinn_ensemble_member_zero_is_the_plain_fit_and_band(chain):
    """The batched fit's member 0 draws the plain fit's init and collocation
    stream (the same generator): identical loss trajectories. The reference
    test's ensemble oracle: the kept member is the selected one, the band is
    ordered, positive and narrower than 0.2 (60 epochs of (16, 16))."""
    df, table = chain
    small = table.take(np.arange(200))
    plain = tpinn.PINNVolatilityModel(hidden_layers=(16, 16), epochs=60, n_collocation=64,
                                      seed=0, device=CPU)
    plain.train(small)
    ens = tpinn.PINNVolatilityModel(hidden_layers=(16, 16), epochs=60, n_collocation=64,
                                    seed=0, device=CPU)
    metrics = ens.train(small, n_seeds=3)
    sel = ens.ensemble_selection
    member0 = [{n: v[0] for n, v in layer.items()} for layer in ens.ensemble_params]
    assert ens.ensemble_best_losses.shape == (3,) and "ensemble_loss_spread" in metrics
    assert metrics["ensemble_selected"] == sel["index"]
    assert sel["rmse"].shape == (3,) and sel["max_violation"].shape == (3,)
    i = sel["index"]
    for a, b in zip(tnn.leaves(ens.params), tnn.leaves(ens.ensemble_params)):
        assert torch.equal(a, b[i])
    for a, b in zip(tnn.leaves(member0), tnn.leaves(plain.params)):
        np.testing.assert_allclose(_num(a), _num(b), rtol=1e-5, atol=1e-7)
    band = ens.iv_band(np.linspace(-0.2, 0.2, 9), np.full(9, 0.5))
    assert np.all(band["lo"] <= band["mean"] + 1e-7) and np.all(band["mean"] <= band["hi"] + 1e-7)
    assert np.all(band["std"] >= 0) and band["std"].max() > 0
    assert np.all(band["hi"] - band["lo"] < 0.2)


def test_pinn_checks_save_load_and_presets(chain, pinn_params, tmp_path):
    df, table = chain
    with pytest.raises(ValidationError):
        tpinn.PINNVolatilityModel(preset="ultra", device=CPU)
    with pytest.raises(ModelError):
        tpinn.PINNVolatilityModel(device=CPU).iv_band(np.zeros(3), np.full(3, 0.5))
    ref = jpinn.PINNVolatilityModel(hidden_layers=(16, 16))
    ref.params, ref.is_trained = pinn_params, True
    ref._k_range, ref._t_range = (-0.9, 0.7), (0.02, 2.5)
    ref.save_model(tmp_path / "ref")
    port = tpinn.PINNVolatilityModel(device=CPU).load_model(tmp_path / "ref")
    np.testing.assert_allclose(port.predict_volatility(table), ref.predict_volatility(df),
                               rtol=1e-5)
    assert port.check_arbitrage(n_k=21, n_t=5) == ref.check_arbitrage(n_k=21, n_t=5)
    port.save_model(tmp_path / "port")
    back = jpinn.PINNVolatilityModel().load_model(tmp_path / "port")
    np.testing.assert_allclose(back.predict_volatility(df), port.predict_volatility(table),
                               rtol=1e-5)
    fn = port.export_forward()
    x = torch.as_tensor(np.stack([K_PTS, T_PTS], 1))
    np.testing.assert_allclose(_num(fn(x)).ravel(), port._iv(K_PTS, T_PTS), rtol=1e-6)


def test_numeric_arbitrage_checkers_match_reference():
    k = np.linspace(-0.5, 0.5, 21)
    for w in (0.04 + 0.1 * k**2, 0.04 + 2.5 * np.abs(k)):
        assert tpinn.check_butterfly_arbitrage(k, w) == jpinn.check_butterfly_arbitrage(k, w)
    grid = np.array([[0.04, 0.04], [0.03, 0.05]])
    assert tpinn.check_calendar_arbitrage(grid) == jpinn.check_calendar_arbitrage(grid) == 0.5


# ---------------------------------------------------------------------------
# kernel ridge and the quote interpolator
# ---------------------------------------------------------------------------
def test_kernel_ridge_predictions_match_reference(chain, tmp_path):
    """Fit on the same 200 quotes: predictions (not dual coefficients) to
    1e-4; saves load across both packages."""
    df, table = chain
    ref = jkr.KernelRidgeModel(gamma=0.5, alpha=1e-3)
    ref.train(df.head(200))
    port = tkr.KernelRidgeModel(gamma=0.5, alpha=1e-3, device=CPU)
    metrics = port.train(table.take(np.arange(200)))
    assert metrics["r2"] > 0.5  # tests/test_surface_models.py:275
    np.testing.assert_allclose(port.predict_volatility(table), ref.predict_volatility(df),
                               atol=1e-4)
    ref.save_model(tmp_path / "ref")
    np.testing.assert_allclose(tkr.KernelRidgeModel(device=CPU).load_model(
        tmp_path / "ref").predict_volatility(table), ref.predict_volatility(df), atol=1e-5)
    port.save_model(tmp_path / "port")
    np.testing.assert_allclose(jkr.KernelRidgeModel().load_model(
        tmp_path / "port").predict_volatility(df), port.predict_volatility(table), atol=1e-5)
    assert tkr.SVRModel is tkr.KernelRidgeModel


def test_kernel_ridge_raises_where_the_reference_returns_nan(chain):
    """Duplicate rows make the float32 kernel matrix singular at a tiny
    ridge: XLA's Cholesky gives NaN, the port raises ModelError."""
    df, table = chain
    dup = pd.concat([df.head(40), df.head(40)], ignore_index=True)
    ref = jkr.KernelRidgeModel(gamma=0.5, alpha=1e-9)
    ref.train(dup)
    assert np.isnan(ref.predict_volatility(dup)).all()
    with pytest.raises(ModelError, match="KernelRidgeModel fit"):
        tkr.KernelRidgeModel(gamma=0.5, alpha=1e-9, device=CPU).train(ColumnTable.from_frame(dup))


@pytest.fixture(scope="module")
def surface_quotes():
    k, t, iv = generate_synthetic_surface(11, 4)
    kk, tt = np.meshgrid(k, t)
    return kk.ravel(), tt.ravel(), iv.ravel()


@pytest.mark.parametrize("method", ["rbf", "idw", "nearest"])
def test_generator_matches_reference(surface_quotes, method):
    """1e-4 on the quotes and off them; rbf exact at the quotes
    (tests/test_surface_models.py:287)."""
    k, t, iv = surface_quotes
    ref = jgen.VolatilitySurfaceGenerator(k, t, iv, method=method)
    port = tgen.VolatilitySurfaceGenerator(k, t, iv, method=method, device=CPU)
    rng = np.random.default_rng(16)  # off the grid's midpoints: no nearest-quote ties
    qk = rng.uniform(k.min(), k.max(), 13)
    qt = rng.uniform(t.min(), t.max(), 13)
    np.testing.assert_allclose(port.get_surface_batch(qk, qt), ref.get_surface_batch(qk, qt),
                               atol=1e-4)
    np.testing.assert_allclose(port.generate_surface(np.sort(qk[:5]), np.sort(qt[:3])),
                               ref.generate_surface(np.sort(qk[:5]), np.sort(qt[:3])), atol=1e-4)
    assert port.get_volatility(0.0, 0.5) == pytest.approx(ref.get_volatility(0.0, 0.5), abs=1e-4)
    if method == "rbf":
        np.testing.assert_allclose(port.get_surface_batch(k, t), iv, atol=1e-3)


def test_generator_cache_validation_and_duplicates(surface_quotes, tmp_path):
    k, t, iv = surface_quotes
    gen = tgen.VolatilitySurfaceGenerator(k, t, iv, method="idw", device=CPU)
    g1 = gen.generate_surface(np.linspace(-0.3, 0.3, 9), np.linspace(0.2, 1.5, 5))
    assert gen.generate_surface(np.linspace(-0.3, 0.3, 9), np.linspace(0.2, 1.5, 5)) is g1
    assert g1.shape == (5, 9)
    gen.clear_cache()
    assert gen.generate_surface(np.linspace(-0.3, 0.3, 9), np.linspace(0.2, 1.5, 5)) is not g1
    with pytest.raises(DataError):
        tgen.VolatilitySurfaceGenerator([0.1, 0.2], [0.5, 0.5], [0.2, 0.2], device=CPU)
    with pytest.raises(ValidationError):
        tgen.VolatilitySurfaceGenerator(k, t, iv, method="spline", device=CPU)
    # two quotes at one point: the reference's fit is NaN, the port raises
    kd, td, vd = np.r_[k, k[:3]], np.r_[t, t[:3]], np.r_[iv, iv[:3] + 0.01]
    assert np.isnan(jgen.VolatilitySurfaceGenerator(kd, td, vd).get_volatility(0.0, 0.5))
    with pytest.raises(ModelError, match="rbf fit"):
        tgen.VolatilitySurfaceGenerator(kd, td, vd, device=CPU)
    pytest.importorskip("matplotlib")
    gen.plot_surface(path=tmp_path / "surface.png")
    assert (tmp_path / "surface.png").stat().st_size > 1000


# ---------------------------------------------------------------------------
# forests and grid search
# ---------------------------------------------------------------------------
def test_forests_train_without_pandas_and_round_trip(chain, tmp_path):
    pytest.importorskip("sklearn")
    _, table = chain
    m = tforest.RandomForestVolatilityModel(n_estimators=10, max_depth=6)
    assert m.train(table)["r2"] > 0.5
    imp = m.feature_importances()
    assert set(imp) == set(m.feature_columns) and abs(sum(imp.values()) - 1.0) < 1e-6
    m.save_model(tmp_path / "rf")
    again = tforest.RandomForestVolatilityModel().load_model(tmp_path / "rf")
    np.testing.assert_allclose(again.predict_volatility(table), m.predict_volatility(table))
    assert tforest.GradientBoostingVolatilityModel(max_iter=30).train(table)["r2"] > 0.5
    assert tforest.XGBVolatilityModel is tforest.GradientBoostingVolatilityModel


@pytest.mark.parametrize("cls", [tforest.RandomForestVolatilityModel,
                                 tforest.GradientBoostingVolatilityModel])
def test_forests_raise_dependency_error_without_sklearn(chain, monkeypatch, cls):
    _, table = chain
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(DependencyError):
        cls().train(table)


def test_kfold_indices_are_the_reference_folds():
    for n, k, seed in ((10, 3, 0), (101, 5, 7)):
        got = list(tgrid._kfold_indices(n, k, seed))
        want = list(jgrid._kfold_indices(n, k, seed))
        assert len(got) == len(want) == k
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_tune_model_and_nested_cv_match_reference(chain):
    """Kernel ridge is deterministic: the port's grid search on the column
    table (no pandas) scores as the reference's on the DataFrame (1e-5)."""
    df, table = chain
    grid = {"gamma": [0.3, 1.0], "alpha": [1e-3]}
    small_df, small = df.head(150).reset_index(drop=True), table.take(np.arange(150))
    best, score, results = tgrid.tune_model(tkr.KernelRidgeModel, small, grid, n_folds=2,
                                            device=CPU)
    r_best, r_score, r_results = jgrid.tune_model(jkr.KernelRidgeModel, small_df, grid,
                                                  n_folds=2)
    assert best == r_best and len(results) == 2 and score < 0.1
    assert score == pytest.approx(r_score, rel=1e-4)
    outer = tgrid.nested_cross_validate(tkr.KernelRidgeModel, small, grid, outer_folds=2,
                                        inner_folds=2, device=CPU)
    r_outer = jgrid.nested_cross_validate(jkr.KernelRidgeModel, small_df, grid, outer_folds=2,
                                          inner_folds=2)
    assert [o["params"] for o in outer] == [o["params"] for o in r_outer]
    np.testing.assert_allclose([o["rmse"] for o in outer], [o["rmse"] for o in r_outer],
                               rtol=1e-4)
