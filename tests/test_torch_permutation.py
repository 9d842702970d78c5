"""The port's permutation test against the JAX package's ``permutation_test``.

One JAX run (EEGNet, C=8, T=64, 80 trials, 3 permutations, 3 epochs,
batch 16, dropout 0) is recorded at its ``jax.jit`` call: its label pools,
initial state, run key and results.  The port's ``permutation_test`` then
draws the JAX initial state and the shuffle slots the JAX trainer draws
from that key (its ``init_fold_states`` and the trainer's
``keyed_slot_source`` patched to hand them over), and must give:

- the same label pools, bit for bit (``RandomState(seed + 12345)``
  permuting the train and validation labels in place, the test labels
  untouched);
- each run's per-epoch train and validation losses within 2e-3, and its
  accuracies to one trial;
- the p-value of the estimator ``(1 + #(perm >= real)) / (1 + N)``, equal
  to the JAX p-value where the accuracies are equal.

With its own draws, runs that read the same labels train identically (one
initial state and one shuffle for every run).
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch_port_cases import labelled_pool

from eegnetreplication_tpu.config import DEFAULT_TRAINING as JAX_TRAINING
from eegnetreplication_tpu.training import loop as jax_loop
from eegnetreplication_tpu.training import permutation as jax_perm
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
from eegnetreplication_tpu_torch.data.splits import (
    inner_train_val_split,
    kfold_indices,
)
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.training import loop, permutation, steps
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
)

C, T, N, PERMS, EPOCHS, BATCH, SEED = 8, 64, 80, 3, 3, 16, 4
TOL = 2e-3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX permutation test, with what its one program was given."""
    x, y = labelled_pool(N, C, T, seed=17)
    seen = {}

    def jit(fn):
        def call(*args):
            seen["args"] = args
            seen["out"] = jax.jit(fn)(*args)
            return seen["out"]
        return call

    proxy = SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                               if not k.startswith("__")})
    proxy.jit = jit
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_perm, "jax", proxy)
    try:
        result = jax_perm.permutation_test(
            x, y, n_permutations=PERMS, epochs=EPOCHS, seed=SEED,
            config=JAX_TRAINING.replace(dropout_within_subject=0.0,
                                        batch_size=BATCH))
    finally:
        mp.undo()
    return x, y, result, seen


def _jax_slots(seen):
    """The shuffle slots every JAX run reads (one key for all)."""
    _, _, spec, _, key = seen["args"]
    n_slots = math.ceil(spec.train_idx.shape[0] / BATCH) * BATCH
    runs = PERMS + 1
    slots = []
    for epoch_key in jax.random.split(key, EPOCHS):
        shuffle_key, _ = jax.random.split(epoch_key)
        p, w = jax_loop._shuffled_slots(shuffle_key, spec.train_idx,
                                        spec.train_n, n_slots)
        slots.append((torch.from_numpy(np.array(p)).long()
                      .expand(runs, -1),
                      torch.from_numpy(np.array(w)).expand(runs, -1)))
    return slots


@pytest.fixture(scope="module")
def port_run(jax_run):
    x, y, _, seen = jax_run
    state = seen["args"][3]
    model = EEGNet(C, T, dropout_rate=0.0, device="cpu")
    sd = from_jax_variables(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats))
    init = steps.TrainState.create(steps.StateLayout.of(model),
                                   {k: v[None] for k, v in sd.items()})
    slots = _jax_slots(seen)
    mp = pytest.MonkeyPatch()
    mp.setattr(permutation, "init_fold_states", lambda *a: init)
    mp.setattr(loop, "keyed_slot_source",
               lambda *a: (lambda epoch: slots[epoch]))
    try:
        return permutation.permutation_test(
            x, y, n_permutations=PERMS, epochs=EPOCHS, seed=SEED,
            device="cpu", config=DEFAULT_TRAINING.replace(
                dropout_within_subject=0.0, batch_size=BATCH))
    finally:
        mp.undo()


def test_label_pools_equal_the_jax_pools(jax_run):
    x, y, _, seen = jax_run
    train_val, _ = kfold_indices(N, 4, 42)[0]
    tr, va = inner_train_val_split(train_val)
    pools = permutation.label_pools(y, tr, va, PERMS, SEED)
    np.testing.assert_array_equal(pools, np.asarray(seen["args"][1]))
    test = np.setdiff1d(np.arange(N), np.concatenate([tr, va]))
    assert (pools[:, test] == y[test]).all()
    assert not (pools[1:, tr] == y[tr]).all()


@pytest.mark.parametrize("series", ["train_losses", "val_losses"])
def test_per_run_losses_track_the_jax_runs(jax_run, port_run, series):
    want = np.asarray(getattr(jax_run[3]["out"], series))
    got = getattr(port_run.folds, series).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_accuracies_and_p_value_match_jax(jax_run, port_run):
    _, _, want, _ = jax_run
    one_trial = 100.0 / (N // 4)
    assert abs(port_run.real_accuracy - want.real_accuracy) <= one_trial
    assert np.all(np.abs(port_run.permuted_accuracies
                         - want.permuted_accuracies) <= one_trial + 1e-3)
    assert port_run.p_value == permutation.p_value(
        port_run.real_accuracy, port_run.permuted_accuracies)
    if (port_run.real_accuracy == want.real_accuracy and np.array_equal(
            port_run.permuted_accuracies, want.permuted_accuracies)):
        assert port_run.p_value == want.p_value


def test_p_value_is_the_estimator():
    assert permutation.p_value(80.0, np.array([20.0, 85.0, 80.0, 30.0])) \
        == pytest.approx(3 / 5)
    assert permutation.p_value(90.0, np.zeros(49)) == pytest.approx(1 / 50)
    rng = np.random.RandomState(0)
    for _ in range(5):
        perm = rng.choice([20.0, 40.0, 60.0], size=9)
        real = float(rng.choice([20.0, 40.0, 60.0]))
        assert permutation.p_value(real, perm) == pytest.approx(
            (1 + np.sum(perm >= real)) / (1 + len(perm)))


def test_runs_share_one_init_and_one_shuffle(monkeypatch):
    """Two runs that read the same labels train bit for bit alike."""
    x, y = labelled_pool(N, C, T, seed=18)
    real = permutation.label_pools

    def twin_pools(y, tr, va, n, seed):
        pools = real(y, tr, va, n, seed)
        pools[1] = pools[0]
        return pools

    monkeypatch.setattr(permutation, "label_pools", twin_pools)
    result = permutation.permutation_test(
        x, y, n_permutations=2, epochs=2, seed=1, device="cpu",
        config=DEFAULT_TRAINING.replace(dropout_within_subject=0.0,
                                        batch_size=BATCH))
    folds = result.folds
    assert torch.equal(folds.train_losses[0], folds.train_losses[1])
    assert torch.equal(folds.best_state.params[0],
                       folds.best_state.params[1])
    assert result.permuted_accuracies[0] == result.real_accuracy
    assert not torch.equal(folds.train_losses[0], folds.train_losses[2])
