"""The training numerics modes (``--precision``) against the JAX package's,
on the CPU.

The JAX package builds its models with ``_model_kwargs_for_precision``:
``highest`` f32, ``high`` and ``default`` a matmul precision (no effect on
a CPU), ``bf16`` a bf16 compute dtype at ``precision=None``.  The port
builds them with the same mapping and runs a protocol inside
``utils/device.py::numerics`` (TF32 on the card).

Tolerances, from bf16's unit roundoff ``U = 2**-8`` (a bf16 value carries
8 significant bits):

- *bf16 forward*, port against JAX at the same weights and inputs:
  ``max |port - jax_bf16| <= 2 max |jax_bf16 - jax_f32|``.  Both round
  the same ops to bf16 (a relative error of ``U`` each) and reduce them in
  different orders (oneDNN's and XLA's convolutions and GEMMs, f32
  accumulation in both), so the two bf16 results differ from each other
  by about as much as either differs from the f32 result; the bound is
  scale-free, which matters where a classifier's sum cancels.  Since that
  bound admits an f32 result, the test also pins that the port's logits
  are bf16 values (its classifier ran in bf16), returned as f32 tensors.
- *bf16 steps*: ten train steps at dropout 0 from the same weights, each
  step's loss within ``4 U`` of JAX's (the loss is ~ln 4 at these sizes,
  so about 1.2% of it; Adam at lr 1e-3 moves the weights little in ten
  steps, so the forward's rounding dominates).
- *CPU no-op*: ``high`` and ``default`` are bitwise the port's ``highest``
  (no tolerance).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synthetic import make_loader
from torch_port_cases import (
    BASELINES,
    jax_baseline,
    jax_variables,
    labelled_pool,
    port_baseline,
    trials,
)

from eegnetreplication_tpu.config import DEFAULT_TRAINING as JAX_DEFAULT
from eegnetreplication_tpu.models import get_model as jax_get_model
from eegnetreplication_tpu.training import protocols as jax_protocols
from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.models import EEGNet, get_model
from eegnetreplication_tpu_torch.ops.fused_eegnet import fold_index
from eegnetreplication_tpu_torch.resil import inject, preempt
from eegnetreplication_tpu_torch.training import permutation, protocols, steps
from eegnetreplication_tpu_torch.training.checkpoint import from_jax_variables
from eegnetreplication_tpu_torch.utils import device as device_lib
from eegnetreplication_tpu_torch.utils import flops

U = 2.0 ** -8                 # bf16 unit roundoff
FWD_TOL = 2.0                 # of JAX's own bf16-vs-f32 deviation
STEP_TOL = 4 * U              # absolute, on a loss of ~ln 4
C, T, F1, D = 8, 64, 4, 2
MODES = ("highest", "high", "default", "bf16")
CFG = DEFAULT_TRAINING.replace(batch_size=16)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    preempt.clear()
    yield
    preempt.clear()
    inject.disarm_all()


def port_loader(**kw):
    jax_loader = make_loader(**kw)

    def loader(subject, mode):
        ds = jax_loader(subject, mode)
        return BCICI2ADataset(X=ds.X, y=ds.y)

    return loader


# --- the mapping ------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_the_mode_mapping_is_the_jax_mapping(mode):
    got = protocols._model_kwargs_for_precision(CFG.replace(precision=mode))
    want = jax_protocols._model_kwargs_for_precision(
        JAX_DEFAULT.replace(precision=mode))
    assert got.keys() == want.keys()
    assert got.get("precision", "highest") == want.get("precision",
                                                        "highest")
    if "dtype" in want:
        assert (got["dtype"], want["dtype"]) == (torch.bfloat16,
                                                 jnp.bfloat16)


def test_an_unknown_mode_raises_in_both():
    with pytest.raises(ValueError) as port_err:
        protocols._model_kwargs_for_precision(CFG.replace(precision="fp8"))
    with pytest.raises(ValueError) as jax_err:
        jax_protocols._model_kwargs_for_precision(
            JAX_DEFAULT.replace(precision="fp8"))
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="'highest', 'high', 'default', "
                                         "or 'bf16'"):
        with device_lib.numerics("fp8"):
            pass


# --- the bf16 forward -------------------------------------------------------

def _assert_bf16_logits(got: torch.Tensor, want: np.ndarray,
                        want_f32: np.ndarray) -> None:
    assert got.dtype == torch.float32
    got = got.detach().numpy()
    bound = FWD_TOL * np.abs(want - want_f32).max()
    assert np.abs(got - want).max() <= bound, (
        np.abs(got - want).max(), bound)
    as_bf16 = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, as_bf16)


def _jax_apply(jmodel, params, stats, x, train):
    variables = {"params": params, "batch_stats": stats}
    if train:
        out, _ = jax.jit(functools.partial(
            jmodel.apply, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        return np.asarray(out)
    return np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("impl", ["lax", "banded"])
def test_eegnet_bf16_forward_matches_jax(impl, train):
    params, stats = jax_variables(C, T, F1, D, seed=3)
    x = trials(16, C, T, seed=4)
    jmodels = [jax_get_model("eegnet", n_channels=C, n_times=T, F1=F1, D=D,
                             dropout_rate=0.0, conv_impl=impl, **kw)
               for kw in ({"dtype": jnp.bfloat16, "precision": None}, {})]
    want, want_f32 = (_jax_apply(m, params, stats, x, train)
                      for m in jmodels)
    model = EEGNet(C, T, F1=F1, D=D, dropout_rate=0.0, conv_impl=impl,
                   dtype=torch.bfloat16, precision=None, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats))
    model.train(train)
    _assert_bf16_logits(model(torch.from_numpy(x)), want, want_f32)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype != torch.bfloat16 for b in model.buffers())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_bf16_forward_matches_jax(name, train):
    c, t = BASELINES[name]
    _, params, stats = jax_baseline(name, c, t, seed=1)
    x = np.random.RandomState(2).randn(8, c, t).astype(np.float32)
    want, want_f32 = (
        _jax_apply(jax_get_model(name, n_channels=c, n_times=t,
                                 dropout_rate=0.0, **kw),
                   params, stats, x, train)
        for kw in ({"dtype": jnp.bfloat16, "precision": None}, {}))
    model = port_baseline(name, params, stats, c, t, dropout_rate=0.0,
                          dtype=torch.bfloat16, precision=None)
    model.train(train)
    _assert_bf16_logits(model(torch.from_numpy(x)), want, want_f32)


def test_the_bf16_batch_norm_statistics_stay_f32():
    params, stats = jax_variables(C, T, F1, D, seed=5)
    model = EEGNet(C, T, F1=F1, D=D, dropout_rate=0.0, dtype=torch.bfloat16,
                   precision=None, device="cpu")
    model.load_state_dict(from_jax_variables(params, stats))
    model.train()
    model(torch.from_numpy(trials(16, C, T, seed=6)))
    running = {k: v for k, v in model.state_dict().items()
               if "running" in k}
    assert running and all(v.dtype == torch.float32
                           for v in running.values())


# --- the CPU no-op of high and default -------------------------------------

def _steps(mode, n=6, model_name="eegnet"):
    """``n`` train steps of a model built for ``mode`` inside its numerics
    scope: the losses and the final state."""
    kw = protocols._model_kwargs_for_precision(CFG.replace(precision=mode))
    c, t = (C, T) if model_name == "eegnet" else BASELINES[model_name]
    x, y = labelled_pool(64, c, t, seed=9)
    model = get_model(model_name, n_channels=c, n_times=t, dropout_rate=0.5,
                      device="cpu", **kw)
    init = model.fresh(torch.Generator().manual_seed(0))
    state = steps.TrainState.create(
        steps.StateLayout.of(model),
        {k: v[None] for k, v in init.state_dict().items()
         if not k.endswith("num_batches_tracked")})
    gen = torch.Generator().manual_seed(1)
    losses = []
    with device_lib.numerics(mode):
        for s in range(n):
            idx = np.arange(s * 16, s * 16 + 16) % len(x)
            state, loss, _ = steps.train_step(
                model, state, torch.from_numpy(x[idx])[None],
                torch.from_numpy(y[idx])[None], torch.ones(1, 16),
                learning_rate=1e-3, adam_eps=1e-7, generator=gen)
            losses.append(loss)
        xv = torch.from_numpy(x[:16])[None]
        logits = steps.eval_forward(model, state, xv,
                                    fold_index(1, 16, "cpu"))
        plain = model.stacked(state.param_views(), state.stat_views(), xv,
                              train=False)[0]
    return torch.cat(losses), state, logits, plain


@pytest.mark.parametrize("model_name", ["eegnet", "shallow_convnet"])
@pytest.mark.parametrize("mode", ["high", "default"])
def test_high_and_default_are_bitwise_highest_on_the_cpu(mode, model_name):
    losses, state, logits, plain = _steps(mode, model_name=model_name)
    ref_losses, ref_state, ref_logits, ref_plain = _steps(
        "highest", model_name=model_name)
    assert torch.equal(losses, ref_losses)
    # Only "highest" evaluates an EEGNet's block 1 on K1-stacked's path
    # (the JAX gate); the plain forward it leaves agrees to f32 rounding.
    assert torch.equal(logits, ref_plain) and torch.equal(plain, ref_plain)
    torch.testing.assert_close(ref_logits, ref_plain, rtol=1e-5, atol=1e-5)
    for field in ("params", "stats", "mu", "nu", "count"):
        assert torch.equal(getattr(state, field), getattr(ref_state, field))


# --- ten bf16 steps against JAX ---------------------------------------------

N_STEPS, BATCH = 10, 16


@pytest.mark.parametrize("impl", ["lax", "banded"])
def test_ten_bf16_steps_track_the_jax_steps(impl):
    x, y = labelled_pool(96, C, T, seed=11)
    params, stats = jax_variables(C, T, F1, D, seed=13, perturb_bn=False)
    jmodel = jax_get_model("eegnet", n_channels=C, n_times=T, F1=F1, D=D,
                           dropout_rate=0.0, conv_impl=impl,
                           dtype=jnp.bfloat16, precision=None)
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    jstate = jax_steps.TrainState.create(
        {"params": params, "batch_stats": stats}, tx)
    jstep = jax.jit(functools.partial(jax_steps.train_step, jmodel, tx))
    model = EEGNet(C, T, F1=F1, D=D, dropout_rate=0.0, conv_impl=impl,
                   dtype=torch.bfloat16, precision=None, device="cpu")
    state = steps.TrainState.create(
        steps.StateLayout.of(model),
        {k: v[None] for k, v in from_jax_variables(params, stats).items()})
    rng = np.random.RandomState(12)
    key = jax.random.PRNGKey(0)
    got, want = [], []
    with device_lib.numerics("bf16"):
        for _ in range(N_STEPS):
            idx = rng.randint(0, len(x), BATCH)
            w = np.ones(BATCH, np.float32)
            jstate, jloss = jstep(jstate, jnp.asarray(x[idx]),
                                  jnp.asarray(y[idx]), jnp.asarray(w), key)
            state, loss, _ = steps.train_step(
                model, state, torch.from_numpy(x[idx])[None],
                torch.from_numpy(y[idx])[None], torch.from_numpy(w)[None],
                learning_rate=1e-3, adam_eps=1e-7)
            got.append(float(loss[0]))
            want.append(float(jloss))
    np.testing.assert_allclose(got, want, rtol=0, atol=STEP_TOL)
    for field in ("params", "stats", "mu", "nu"):
        assert getattr(state, field).dtype == torch.float32, field
    assert state.mu.abs().sum() > 0 and state.nu.abs().sum() > 0
    # The JAX state is f32 as well: parameters, statistics and moments.
    for leaf in jax.tree_util.tree_leaves((jstate.params,
                                           jstate.batch_stats)):
        assert leaf.dtype == jnp.float32


# --- the protocol -----------------------------------------------------------

@pytest.mark.parametrize("mode", ["default", "bf16"])
def test_the_protocol_trains_and_learns(tmp_path, mode):
    """As the JAX package's ``TestPrecisionModes``: finite and above
    chance on an easy separable task."""
    loader = port_loader(n_trials=32, n_channels=6, n_times=64,
                         class_sep=1.5)
    result = protocols.within_subject_training(
        epochs=25, config=CFG.replace(precision=mode), loader=loader,
        subjects=(1,), paths=Paths.from_root(tmp_path), seed=0,
        save_models=False, device="cpu")
    assert np.isfinite(result.avg_test_acc)
    assert result.avg_test_acc > 40.0
    assert result.folds.best_state.params.dtype == torch.float32


@pytest.mark.parametrize("mode", ["bf16", "high"])
def test_a_resume_under_another_mode_is_a_different_run(tmp_path, mode):
    loader = port_loader(n_trials=24, n_channels=4, n_times=64)
    kw = dict(epochs=6, loader=loader, subjects=(1,),
              paths=Paths.from_root(tmp_path), seed=0, save_models=False,
              device="cpu", checkpoint_every=2)
    with pytest.raises(RuntimeError, match="injected crash"), \
            inject.scoped(inject.FaultSpec("train.chunk", after=0)):
        protocols.within_subject_training(config=CFG, **kw)
    with pytest.raises(ValueError, match="different run"):
        protocols.within_subject_training(
            config=CFG.replace(precision=mode), resume=True, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_only_highest_takes_the_fused_eval(mode, monkeypatch):
    kw = protocols._model_kwargs_for_precision(CFG.replace(precision=mode))
    model = EEGNet(C, T, F1=F1, D=D, device="cpu", **kw)
    assert steps.supports_fused_eval(model) == (mode == "highest")
    fused = []
    real = steps.fused_eval_forward_stacked
    monkeypatch.setattr(steps, "fused_eval_forward_stacked",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    state = steps.TrainState.create(
        steps.StateLayout.of(model),
        {k: v[None] for k, v in model.state_dict().items()})
    x = torch.from_numpy(trials(8, C, T, seed=2))[None]
    logits = steps.eval_forward(model, state, x, fold_index(1, 8, "cpu"))
    assert logits.dtype == torch.float32
    assert len(fused) == (mode == "highest")
    plain = model.stacked(state.param_views(), state.stat_views(), x,
                          train=False)[0]
    if mode != "highest":
        assert torch.equal(logits, plain)


# --- the numerics scope -----------------------------------------------------

def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("mode", MODES)
def test_the_scope_sets_and_restores_both_tf32_flags(mode):
    device_lib.resolve_device("cpu")
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark,
                     torch.are_deterministic_algorithms_enabled())
    assert _flags() == (False, False)
    tf32 = mode != "highest"
    with device_lib.numerics(mode):
        assert _flags() == (tf32, tf32)
        # selecting a device inside the scope keeps the scope's flags
        device_lib.resolve_device("cpu")
        assert _flags() == (tf32, tf32)
        with device_lib.numerics("highest"):
            assert _flags() == (False, False)
        assert _flags() == (tf32, tf32)
    assert _flags() == (False, False)
    with pytest.raises(RuntimeError, match="boom"):
        with device_lib.numerics(mode):
            raise RuntimeError("boom")
    assert _flags() == (False, False)
    assert not torch.backends.cuda.matmul.\
        allow_bf16_reduced_precision_reduction
    assert deterministic == (torch.backends.cudnn.deterministic,
                             torch.backends.cudnn.benchmark,
                             torch.are_deterministic_algorithms_enabled())


def test_a_protocol_runs_inside_its_scope(tmp_path, monkeypatch):
    seen = []
    real = protocols.run_folds

    def spy(*a, **k):
        seen.append(_flags())
        return real(*a, **k)

    monkeypatch.setattr(protocols, "run_folds", spy)
    loader = port_loader(n_trials=24, n_channels=4, n_times=64)
    for mode in MODES:
        protocols.within_subject_training(
            epochs=1, config=CFG.replace(precision=mode), loader=loader,
            subjects=(1,), paths=Paths.from_root(tmp_path), seed=0,
            save_models=False, device="cpu")
    assert seen == [(False, False)] + [(True, True)] * 3
    assert _flags() == (False, False)


# --- the MFU denominator ----------------------------------------------------

@pytest.mark.parametrize("card, mode, peak, label", [
    ("NVIDIA H100 80GB HBM3", "highest", 66.9e12, "H100 SXM FP32 peak"),
    ("NVIDIA H100 80GB HBM3", "high", 494.7e12, "H100 SXM TF32 peak"),
    ("NVIDIA H100 80GB HBM3", "default", 494.7e12, "H100 SXM TF32 peak"),
    ("NVIDIA H100 80GB HBM3", "bf16", 989.4e12, "H100 SXM BF16 peak"),
    ("NVIDIA H100 PCIe", "highest", 51.2e12, "H100 PCIe FP32 peak"),
    ("NVIDIA H100 PCIe", "high", 378e12, "H100 PCIe TF32 peak"),
    ("NVIDIA H100 PCIe", "default", 378e12, "H100 PCIe TF32 peak"),
    ("NVIDIA H100 PCIe", "bf16", 756e12, "H100 PCIe BF16 peak"),
    ("NVIDIA A100-SXM4-40GB", "bf16", None, "no BF16 peak known"),
])
def test_the_mfu_peak_is_the_modes_arithmetic(card, mode, peak, label,
                                              monkeypatch):
    monkeypatch.delenv("EEGTPU_PEAK_FLOPS", raising=False)
    got, got_label = flops.assumed_peak_flops(card, mode)
    assert got == peak
    assert got_label.startswith(label)
    assert flops.mfu(1e12, card, mode) == (None if peak is None
                                           else 1e12 / peak)


# --- the permutation test ---------------------------------------------------

def test_the_permutation_test_builds_its_model_in_the_mode(monkeypatch):
    built, scopes = [], []
    real_get = permutation.get_model
    real_epoch = permutation.FoldTrainer.run_epoch

    def get(*a, **k):
        model = real_get(*a, **k)
        built.append(model)
        return model

    def epoch(self):
        scopes.append(_flags())
        return real_epoch(self)

    monkeypatch.setattr(permutation, "get_model", get)
    monkeypatch.setattr(permutation.FoldTrainer, "run_epoch", epoch)
    x, y = labelled_pool(48, 4, 64, seed=3)
    result = permutation.permutation_test(
        x, y, n_permutations=2, epochs=1, device="cpu",
        config=CFG.replace(precision="bf16"))
    (model,) = built
    assert (model.dtype, model.precision) == (torch.bfloat16, None)
    assert not steps.supports_fused_eval(model)
    assert scopes == [(True, True)]
    assert np.isfinite(result.real_accuracy)
