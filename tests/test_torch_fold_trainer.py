"""The port's fold trainer against the JAX package's ``make_fold_trainer``.

Three folds of ragged sizes (C=8, T=64, batch 16, dropout 0, 3 epochs)
run through ``jax.vmap(make_fold_trainer(...))`` and through the port's
:class:`FoldTrainer`, which is handed the JAX initial states (carried across
with ``from_jax_variables_stacked``) and, as its slot source, the exact
shuffle slots the JAX trainer draws from its keys (``loop._shuffled_slots``).
Per-epoch train and validation losses agree within 2e-3; validation
accuracies, best validation accuracy and test accuracy agree exactly or by
at most one trial, where a logit near-tie can flip an argmax.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.models import EEGNet as JaxEEGNet
from eegnetreplication_tpu.training import loop as jax_loop
from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.training import loop, steps
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables_stacked,
)

C, T, BATCH, EPOCHS = 8, 64, 16, 3
TOL = 2e-3


def _pool_and_folds():
    rng = np.random.RandomState(7)
    n = 150
    y = rng.randint(0, 4, n)
    x = (0.7 * rng.randn(n, C, T)).astype(np.float32)
    t = np.arange(T) / 64.0
    for k in range(4):
        x[y == k] += np.sin(2 * np.pi * (4 + 4 * k) * t).astype(np.float32)
    perm = rng.permutation(n)
    # ragged folds: the last fold's train set needs one batch fewer
    folds = [(perm[0:40], perm[40:50], perm[50:70]),
             (perm[70:108], perm[108:117], perm[117:135]),
             (perm[10:30], perm[135:150], perm[30:52])]
    return x, y, folds


@pytest.fixture(scope="module")
def runs():
    x, y, folds = _pool_and_folds()
    pads = [max(len(f[i]) for f in folds) for i in range(3)]
    model = JaxEEGNet(n_channels=C, n_times=T, dropout_rate=0.0)
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    specs = [jax_loop.make_fold_spec(*f, train_pad=pads[0], val_pad=pads[1],
                                     test_pad=pads[2]) for f in folds]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *specs)
    states = jax_loop.init_fold_states(model, tx, len(folds), (C, T), seed=0)
    keys = jax.random.split(jax.random.PRNGKey(1), len(folds))
    trainer = jax_loop.make_fold_trainer(
        model, tx, batch_size=BATCH, epochs=EPOCHS, train_pad=pads[0],
        val_pad=pads[1], test_pad=pads[2])
    want = jax.jit(jax.vmap(trainer, in_axes=(None, None, 0, 0, 0)))(
        jnp.asarray(x), jnp.asarray(y, jnp.int32), stacked, states, keys)

    # The JAX trainer's shuffle slots, epoch by epoch, as the port's source.
    n_slots = math.ceil(pads[0] / BATCH) * BATCH
    slots = []
    for e in range(EPOCHS):
        picked, weights = [], []
        for g, spec in enumerate(specs):
            epoch_key = jax.random.split(keys[g], EPOCHS)[e]
            shuffle_key, _ = jax.random.split(epoch_key)
            p, w = jax_loop._shuffled_slots(shuffle_key, spec.train_idx,
                                            spec.train_n, n_slots)
            picked.append(np.asarray(p))
            weights.append(np.asarray(w))
        slots.append((torch.from_numpy(np.stack(picked)).long(),
                      torch.from_numpy(np.stack(weights))))

    template = EEGNet(C, T, dropout_rate=0.0, device="cpu")
    init = steps.TrainState.create(
        steps.StateLayout.of(template),
        from_jax_variables_stacked(
            jax.tree_util.tree_map(np.asarray, states.params),
            jax.tree_util.tree_map(np.asarray, states.batch_stats)))
    spec = loop.make_fold_spec(folds, train_pad=pads[0], val_pad=pads[1],
                               test_pad=pads[2])
    trainer = loop.FoldTrainer(
        template, torch.from_numpy(x), torch.from_numpy(y), spec, init,
        batch_size=BATCH, learning_rate=1e-3, adam_eps=1e-7,
        slot_source=lambda epoch: slots[epoch])
    for _ in range(EPOCHS):
        trainer.run_epoch()
    return want, trainer.result(), folds


@pytest.mark.parametrize("series", ["train_losses", "val_losses",
                                    "grad_norms"])
def test_per_epoch_losses_agree(runs, series):
    want, got, _ = runs
    np.testing.assert_allclose(getattr(got, series).numpy(),
                               np.asarray(getattr(want, series)),
                               rtol=TOL, atol=TOL)


def _one_trial(folds, which):
    """One trial of each fold's set, in percent."""
    return np.array([100.0 / len(f[which]) for f in folds])


@pytest.mark.parametrize("series, which", [("val_accuracies", 1),
                                           ("best_val_acc", 1),
                                           ("test_accuracy", 2)])
def test_accuracies_agree_to_one_trial(runs, series, which):
    want, got, folds = runs
    w = np.asarray(getattr(want, series))
    g = getattr(got, series).numpy()
    step = _one_trial(folds, which)
    if g.ndim == 2:
        step = step[:, None]
    # equal, or one argmax flipped on a logit near-tie
    assert np.all(np.abs(g - w) <= step + 1e-3), (g, w)


def test_min_val_loss_and_best_state_agree(runs):
    want, got, _ = runs
    np.testing.assert_allclose(got.min_val_loss.numpy(),
                               np.asarray(want.min_val_loss),
                               rtol=TOL, atol=TOL)
    best = from_jax_variables_stacked(
        jax.tree_util.tree_map(np.asarray, want.best_state.params),
        jax.tree_util.tree_map(np.asarray, want.best_state.batch_stats))
    sd = got.best_state.stacked_state_dict()
    for name in ("spatial.weight", "classifier.weight",
                 "block_2.2.running_var"):
        torch.testing.assert_close(sd[name], best[name], rtol=TOL, atol=TOL)


def test_default_slots_follow_the_jax_layout():
    """The port's own shuffle: the first n slots a permutation of the real
    indices, the rest wrapping around at weight 0."""
    gen = torch.Generator().manual_seed(0)
    idx = torch.tensor([5, 9, 2, 7, 0, 0])
    picked, w = loop.shuffled_slots(gen, idx, 4, 10)
    assert sorted(picked[:4].tolist()) == [2, 5, 7, 9]
    assert picked[4:].tolist() == (picked[:4].tolist() * 2)[:6]
    assert w.tolist() == [1.0] * 4 + [0.0] * 6
    empty, w0 = loop.shuffled_slots(gen, idx, 0, 3)
    assert w0.tolist() == [0.0] * 3 and empty.tolist() == [5, 5, 5]


def test_linear_slots_match_jax():
    idx = np.array([[3, 4, 5, 0], [6, 7, 0, 0]])
    n = np.array([3, 2])
    got, w = loop.linear_slots(torch.from_numpy(idx), torch.from_numpy(n), 6)
    for g in range(2):
        jg, jw = jax_loop._linear_slots(jnp.asarray(idx[g]), n[g], 6)
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(jg))
        np.testing.assert_array_equal(w[g].numpy(), np.asarray(jw))
