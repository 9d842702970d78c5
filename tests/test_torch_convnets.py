"""The port's ShallowConvNet and DeepConvNet against the JAX package's.

Small sizes (``torch_port_cases.BASELINES``: C=6, T=60 for Shallow, T=96
for Deep), weights drawn by the JAX ``model.init`` and carried across with
``from_jax_variables``, inputs drawn with numpy from a seed:

- the eval forward (atol/rtol 1e-5), the training forward at dropout 0
  and its new BatchNorm statistics (1e-5), and the gradient of a seeded
  cotangent against ``jax.grad`` (1e-4), single and fold-stacked;
- the JAX length errors, word for word, and the ``bn_mode="torch"``
  refusal (a ``TypeError`` in both packages);
- 60 train steps against the JAX ``train_step`` at dropout 0, batch losses
  and raw gradient norms within 2e-3 (as ``test_torch_train_step.py``
  holds EEGNet);
- three folds of a ShallowConvNet through the port's ``FoldTrainer``
  against ``jax.vmap(make_fold_trainer)``, fed the JAX initial states and
  shuffle slots: per-epoch losses within 2e-3, accuracies to one trial
  (the trainer reads the architecture only through the train step and the
  eval forward held above, so one baseline keeps the file's time down);
- the closed-form FLOP counts (``utils/flops.py``) within 1% of the JAX
  package's XLA cost-model counts, at the product width and at the
  parity size.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_cases import (
    BASELINES,
    jax_baseline,
    labelled_pool,
    port_baseline,
)

from eegnetreplication_tpu.models import get_model as jax_get_model
from eegnetreplication_tpu.training import loop as jax_loop
from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu_torch.models import (
    DeepConvNet,
    ShallowConvNet,
    get_model,
)
from eegnetreplication_tpu_torch.training import loop, steps
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    from_jax_variables_stacked,
)

NAMES = sorted(BASELINES)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
TRAIN_TOL = 2e-3


def _variables(params, stats):
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax_apply(name):
    c, t = BASELINES[name]
    jmodel, params, stats = jax_baseline(name, c, t, seed=1)
    x = np.random.RandomState(2).randn(7, c, t).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        _variables(params, stats), jnp.asarray(x)))
    got = port_baseline(name, params, stats, c, t)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_training_forward_and_statistics_match_jax(name):
    c, t = BASELINES[name]
    jmodel, params, stats = jax_baseline(name, c, t, seed=3)
    x = np.random.RandomState(4).randn(8, c, t).astype(np.float32)
    logits, upd = jax.jit(functools.partial(
        jmodel.apply, train=True, mutable=["batch_stats"]))(
        _variables(params, stats), jnp.asarray(x))
    port = port_baseline(name, params, stats, c, t, dropout_rate=0.0)
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               atol=FWD_TOL, rtol=FWD_TOL)
    want = from_jax_variables(params, jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"]))
    for key, value in port.state_dict().items():
        if "running" in key:
            torch.testing.assert_close(value, want[key], atol=FWD_TOL,
                                       rtol=FWD_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_grad(name):
    c, t = BASELINES[name]
    jmodel, params, stats = jax_baseline(name, c, t, seed=5)
    rng = np.random.RandomState(6)
    x = rng.randn(8, c, t).astype(np.float32)
    cot = rng.randn(8, 4).astype(np.float32)

    def loss(p):
        out, _ = jmodel.apply(_variables(p, stats), jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot)

    jgrads = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jax.grad(loss))(params))
    want = from_jax_variables(jgrads, stats)
    port = port_baseline(name, params, stats, c, t, dropout_rate=0.0)
    port.train()
    (port(torch.from_numpy(x)) * torch.from_numpy(cot)).sum().backward()
    for key, param in port.named_parameters():
        torch.testing.assert_close(param.grad, want[key], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_stacked_sets_equal_each_model_alone(name):
    """G weight sets on G batches give each set's own forward (eval and
    train), and each set's own statistics."""
    c, t = BASELINES[name]
    sets = [jax_baseline(name, c, t, seed=s)[1:] for s in (7, 8, 9)]
    x = torch.from_numpy(np.random.RandomState(10).randn(
        3, 5, c, t).astype(np.float32))
    sds = [from_jax_variables(p, s) for p, s in sets]
    stacked = {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}
    model = get_model(name, n_channels=c, n_times=t, dropout_rate=0.0,
                      device="cpu")
    for train in (False, True):
        logits, new = model.stacked(stacked, stacked, x, train=train)
        for g, sd in enumerate(sds):
            alone = port_baseline(name, *sets[g], c, t, dropout_rate=0.0)
            alone.train(train)
            torch.testing.assert_close(logits[g], alone(x[g]), atol=1e-6,
                                       rtol=1e-5)
            for key, value in new.items():
                torch.testing.assert_close(value[g], alone.state_dict()[key],
                                           atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name, t", [("shallow_convnet", 46),
                                     ("deep_convnet", 75)])
def test_length_errors_are_the_jax_errors(name, t):
    jmodel = jax_get_model(name, n_channels=4, n_times=t)
    with pytest.raises(ValueError) as want:
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, t)))
    with pytest.raises(ValueError) as got:
        get_model(name, n_channels=4, n_times=t, device="cpu")
    assert str(got.value) == str(want.value)
    ok = get_model(name, n_channels=4, n_times=t + 40, device="cpu")
    with pytest.raises(ValueError) as got:
        ok(torch.zeros(1, 4, t))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", NAMES)
def test_torch_batch_norm_is_refused_as_in_jax(name):
    with pytest.raises(TypeError):
        jax_get_model(name, bn_mode="torch")
    with pytest.raises(TypeError, match="bn_mode"):
        get_model(name, bn_mode="torch", device="cpu")


def test_init_draws_like_the_jax_init():
    """Kernels within U(+-1/sqrt(fan_in)) and spread over it, dense bias 0,
    BatchNorm at the identity, no max-norm; one seed, one model."""
    for cls in (ShallowConvNet, DeepConvNet):
        a = cls(device="cpu", generator=torch.Generator().manual_seed(0))
        b = cls(device="cpu", generator=torch.Generator().manual_seed(0))
        assert cls.MAXNORM_LIMITS == {}
        for key, value in a.state_dict().items():
            assert torch.equal(value, b.state_dict()[key]), key
        for module in a.modules():
            if isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)):
                bound = 1.0 / math.sqrt(module.weight[0].numel())
                w = module.weight.detach()
                assert float(w.abs().max()) <= bound
                assert float(w.abs().max()) > 0.9 * bound
        assert torch.equal(a.classifier.bias, torch.zeros(4))


# --- 60 train steps ----------------------------------------------------------

N_STEPS, BATCH = 60, 16


@pytest.mark.parametrize("name", NAMES)
def test_sixty_steps_track_the_jax_train_step(name):
    c, t = BASELINES[name]
    x, y = labelled_pool(96, c, t, seed=11)
    rng = np.random.RandomState(12)
    jmodel, params, stats = jax_baseline(name, c, t, seed=13,
                                         perturb_bn=False)
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    jstate = jax_steps.TrainState.create(_variables(params, stats), tx)
    jstep = jax.jit(functools.partial(jax_steps.train_step, jmodel, tx,
                                      return_grad_norm=True))
    model = port_baseline(name, params, stats, c, t, dropout_rate=0.0)
    state = steps.TrainState.create(
        steps.StateLayout.of(model),
        {k: v[None] for k, v in from_jax_variables(params, stats).items()})
    key = jax.random.PRNGKey(0)
    got, want = [], []
    for s in range(N_STEPS):
        idx = rng.randint(0, len(x), BATCH)
        w = (np.arange(BATCH) < (BATCH if s % 5 else 9)).astype(np.float32)
        jstate, jloss, jgn = jstep(jstate, jnp.asarray(x[idx]),
                                   jnp.asarray(y[idx]), jnp.asarray(w), key)
        state, loss, gn = steps.train_step(
            model, state, torch.from_numpy(x[idx])[None],
            torch.from_numpy(y[idx])[None], torch.from_numpy(w)[None],
            learning_rate=1e-3, adam_eps=1e-7)
        got.append((float(loss[0]), float(gn[0])))
        want.append((float(jloss), float(jgn)))
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL, atol=TRAIN_TOL)
    assert got[-5:, 0].mean() < got[:5, 0].mean()


# --- the fold trainer -------------------------------------------------------

EPOCHS = 2


def _folds(n):
    perm = np.random.RandomState(14).permutation(n)
    return [(perm[0:40], perm[40:50], perm[50:70]),
            (perm[70:104], perm[104:113], perm[113:130]),
            (perm[10:30], perm[130:150], perm[30:52])]


@pytest.fixture(scope="module")
def fold_runs():
    name = "shallow_convnet"
    c, t = BASELINES[name]
    x, y = labelled_pool(150, c, t, seed=15)
    folds = _folds(len(x))
    pads = [max(len(f[i]) for f in folds) for i in range(3)]
    jmodel = jax_get_model(name, n_channels=c, n_times=t, dropout_rate=0.0)
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    specs = [jax_loop.make_fold_spec(*f, train_pad=pads[0], val_pad=pads[1],
                                     test_pad=pads[2]) for f in folds]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *specs)
    states = jax_loop.init_fold_states(jmodel, tx, len(folds), (c, t),
                                       seed=0)
    keys = jax.random.split(jax.random.PRNGKey(1), len(folds))
    trainer = jax_loop.make_fold_trainer(
        jmodel, tx, batch_size=BATCH, epochs=EPOCHS, train_pad=pads[0],
        val_pad=pads[1], test_pad=pads[2])
    want = jax.jit(jax.vmap(trainer, in_axes=(None, None, 0, 0, 0)))(
        jnp.asarray(x), jnp.asarray(y, jnp.int32), stacked, states, keys)

    n_slots = math.ceil(pads[0] / BATCH) * BATCH
    slots = []
    for e in range(EPOCHS):
        picked, weights = [], []
        for g, spec in enumerate(specs):
            shuffle_key, _ = jax.random.split(
                jax.random.split(keys[g], EPOCHS)[e])
            p, w = jax_loop._shuffled_slots(shuffle_key, spec.train_idx,
                                            spec.train_n, n_slots)
            picked.append(np.asarray(p))
            weights.append(np.asarray(w))
        slots.append((torch.from_numpy(np.stack(picked)).long(),
                      torch.from_numpy(np.stack(weights))))

    template = get_model(name, n_channels=c, n_times=t, dropout_rate=0.0,
                         device="cpu")
    init = steps.TrainState.create(
        steps.StateLayout.of(template),
        from_jax_variables_stacked(
            jax.tree_util.tree_map(np.asarray, states.params),
            jax.tree_util.tree_map(np.asarray, states.batch_stats)))
    spec = loop.make_fold_spec(folds, train_pad=pads[0], val_pad=pads[1],
                               test_pad=pads[2])
    port = loop.FoldTrainer(
        template, torch.from_numpy(x), torch.from_numpy(y), spec, init,
        batch_size=BATCH, learning_rate=1e-3, adam_eps=1e-7,
        slot_source=lambda epoch: slots[epoch])
    for _ in range(EPOCHS):
        port.run_epoch()
    return want, port.result(), folds


def test_fold_trainer_losses_track_jax(fold_runs):
    want, got, _ = fold_runs
    for series in ("train_losses", "val_losses", "grad_norms",
                   "min_val_loss"):
        np.testing.assert_allclose(getattr(got, series).numpy(),
                                   np.asarray(getattr(want, series)),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=series)


def test_fold_trainer_accuracies_agree_to_one_trial(fold_runs):
    want, got, folds = fold_runs
    for series, which in (("val_accuracies", 1), ("best_val_acc", 1),
                          ("test_accuracy", 2)):
        w = np.asarray(getattr(want, series))
        g = getattr(got, series).numpy()
        step = np.array([100.0 / len(f[which]) for f in folds])
        if g.ndim == 2:
            step = step[:, None]
        assert np.all(np.abs(g - w) <= step + 1e-3), (series, g, w)


# --- FLOPs ---------------------------------------------------------------------

FLOPS_TOL = 0.01
# The JAX package's XLA cost-model counts at the product width (22 x 257),
# batch 64, JAX_PLATFORMS=cpu.
FLOPS_ANCHORS = {
    ("shallow_convnet", "train_step"): 4_071_996_928,
    ("shallow_convnet", "eval_step"): 1_468_634_624,
    ("shallow_convnet", "eval_forward"): 1_468_631_296,
    ("deep_convnet", "train_step"): 3_347_993_856,
    ("deep_convnet", "eval_step"): 1_133_769_216,
    ("deep_convnet", "eval_forward"): 1_133_766_016,
}


def _port_flops(name, what, model, batch):
    from eegnetreplication_tpu_torch.utils import flops

    return {"train_step": flops.train_step_flops,
            "eval_step": flops.eval_step_flops,
            "eval_forward": flops.eval_forward_flops}[what](model, batch)


@pytest.mark.parametrize("name, what", sorted(FLOPS_ANCHORS))
def test_flops_at_the_product_width_are_within_1pct_of_jax(name, what):
    got = _port_flops(name, what, get_model(name, device="cpu"), 64)
    want = FLOPS_ANCHORS[(name, what)]
    assert abs(got / want - 1) <= FLOPS_TOL, (name, what, got, want)


@pytest.mark.parametrize("name", NAMES)
def test_flops_at_a_small_size_are_within_1pct_of_jax(name):
    """The JAX package's counts measured here, at the parity size and
    batch 16."""
    from eegnetreplication_tpu.utils import flops as jax_flops

    c, t = BASELINES[name]
    jmodel = jax_get_model(name, n_channels=c, n_times=t)
    tx = jax_steps.make_optimizer()
    want = {"train_step": jax_flops.train_step_flops(jmodel, tx, 16, (c, t)),
            "eval_step": jax_flops.eval_step_flops(jmodel, tx, 16, (c, t)),
            "eval_forward": jax_flops.eval_forward_flops(jmodel, 16, (c, t))}
    model = get_model(name, n_channels=c, n_times=t, device="cpu")
    for what, count in want.items():
        got = _port_flops(name, what, model, 16)
        assert abs(got / count - 1) <= FLOPS_TOL, (what, got, count)
