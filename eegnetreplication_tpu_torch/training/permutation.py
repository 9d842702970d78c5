"""Label-permutation significance test of a trained accuracy.

The counterpart of ``eegnetreplication_tpu/training/permutation.py`` (the
reference's notebook test: train on shuffled labels many times and place
the real accuracy in that null distribution).  The real run and all N
permuted runs train together as the fold axis of one
:class:`~eegnetreplication_tpu_torch.training.loop.FoldTrainer`: they share
the pool of trials, the split, the initial weights and the batch order,
and each reads its own row of a ``(N + 1, n)`` label pool.

The label pools are the JAX package's: row 0 real, and row ``p`` with the
train and validation labels permuted in place by ``RandomState(seed +
12345)`` (the test labels stay real, so a permuted run's test accuracy
measures what label-free structure the model can use).  The split is fold
0 of the protocol's seeded KFold with the reference's inner 80/20
train/validation split.  Dropout masks are drawn per run from the
trainer's generator, so at p > 0 the runs' masks differ (the JAX package
reuses one key); at p = 0 the runs differ by their labels alone.  The
model is built in ``config.precision``'s numerics mode and trains inside
its scope (``training/protocols.py::_model_kwargs_for_precision``, as the
JAX package builds it).

Under a mesh (``mesh=``) the runs are sharded over its fold axis, as the
JAX package shards them (``shard_over_fold_axis``): the label pools are
padded to a multiple of the axis by repeating row 0, each rank trains its
block of runs (its dropout generator seeded ``seed + 2 +`` its first run),
and the test accuracies are gathered to the first rank, which returns the
result; every other rank returns ``None``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, TrainingConfig
from eegnetreplication_tpu_torch.data.splits import (
    inner_train_val_split,
    kfold_indices,
)
from eegnetreplication_tpu_torch.models import get_model
from eegnetreplication_tpu_torch.parallel import shardspec
from eegnetreplication_tpu_torch.parallel.mesh import DATA_AXIS
from eegnetreplication_tpu_torch.training.loop import (
    FoldResult,
    FoldTrainer,
    dropout_seed,
    init_fold_states,
    make_fold_spec,
    mesh_data_sharding,
)
from eegnetreplication_tpu_torch.training.steps import TrainState
from eegnetreplication_tpu_torch.utils.device import numerics, resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger


@dataclass
class PermutationResult:
    real_accuracy: float
    permuted_accuracies: np.ndarray  # (n_permutations,)
    p_value: float
    folds: FoldResult | None = None  # every run's per-epoch record

    @property
    def mean_permuted(self) -> float:
        return float(np.mean(self.permuted_accuracies))


def label_pools(y: np.ndarray, train_ids: np.ndarray, val_ids: np.ndarray,
                n_permutations: int, seed: int) -> np.ndarray:
    """``(n_permutations + 1, n)`` labels: row 0 ``y``, row ``p`` with the
    train and validation entries permuted in place (the JAX package's
    draws, in its order)."""
    rng = np.random.RandomState(seed + 12345)
    pools = np.tile(np.asarray(y, np.int64), (n_permutations + 1, 1))
    tv = np.concatenate([train_ids, val_ids])
    for p in range(1, n_permutations + 1):
        pools[p, tv] = pools[p, rng.permutation(tv)]
    return pools


def p_value(real: float, permuted: np.ndarray) -> float:
    """The permutation-test estimator ``(1 + #(perm >= real)) / (1 + N)``."""
    permuted = np.asarray(permuted)
    return float((1 + np.sum(permuted >= real)) / (1 + len(permuted)))


def permutation_test(X: np.ndarray, y: np.ndarray, *,
                     n_permutations: int = 50, epochs: int = 100,
                     config: TrainingConfig = DEFAULT_TRAINING,
                     model_name: str = "eegnet", seed: int = 0,
                     device: torch.device | str | None = None,
                     mesh=None) -> PermutationResult | None:
    """Run the permutation test on one dataset ``X (n, C, T)``, ``y (n,)``
    on ``device`` (the card unless ``EEGTPU_PLATFORM=cpu``).

    Every run starts from one initial state drawn from ``seed`` and sees
    the batches of one keyed shuffle (``seed + 1``, every run keyed as
    fold 0).  ``mesh`` shards the runs over its ranks (module docstring).
    """
    X = np.asarray(X, np.float32)
    n = len(y)
    train_val, test_ids = kfold_indices(n, config.kfold_splits,
                                        config.kfold_seed)[0]
    train_ids, val_ids = inner_train_val_split(train_val)
    pools = label_pools(y, train_ids, val_ids, n_permutations, seed)
    real_runs = n_permutations + 1
    padded = shardspec.padded_folds(real_runs, mesh)
    pools = np.concatenate([pools, np.repeat(pools[:1], padded - real_runs,
                                             axis=0)])
    lo, hi = shardspec.fold_block(padded, mesh)
    pools = pools[lo:hi]
    runs = hi - lo
    device = resolve_device(device)
    data = mesh_data_sharding(mesh, config.batch_size)

    from eegnetreplication_tpu_torch.training.protocols import (
        _model_kwargs_for_precision,
    )

    model = get_model(model_name, n_channels=X.shape[1], n_times=X.shape[2],
                      dropout_rate=config.dropout_within_subject,
                      device="cpu", **_model_kwargs_for_precision(config),
                      **({"bn_axis_name": DATA_AXIS} if data else {}))
    spec = make_fold_spec([(train_ids, val_ids, test_ids)] * runs,
                          train_pad=len(train_ids), val_pad=len(val_ids),
                          test_pad=len(test_ids))
    init_state = init_fold_states(model, 1,
                                  torch.Generator().manual_seed(seed))
    init = TrainState(init_state.layout, *(
        getattr(init_state, f).expand(runs, *getattr(init_state, f).shape[1:])
        .contiguous() for f in ("params", "stats", "mu", "nu", "count")))
    trainer = FoldTrainer(
        model, torch.from_numpy(X).to(device),
        torch.from_numpy(pools).to(device), spec, init,
        batch_size=config.batch_size, learning_rate=config.learning_rate,
        adam_eps=config.adam_eps, maxnorm_mode=config.maxnorm_mode,
        shuffle_seed=seed + 1, fold_ids=[0] * runs, data_group=data,
        dropout_generator=torch.Generator(device=device).manual_seed(
            dropout_seed(seed, lo, data.index if data else 0)))
    logger.info("Permutation test: %d runs x %d epochs as the fold axis of "
                "one trainer on %s", runs, epochs, device)
    with numerics(config.precision):
        for _ in range(epochs):
            trainer.run_epoch()
        result = trainer.result()
    accs = result.test_accuracy.numpy()
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        gathered = [None] * mesh.size if mesh.is_lead else None
        dist.gather_object(accs, gathered, dst=mesh.ranks[0])
        if not mesh.is_lead:
            return None
        per_line = mesh.size // mesh.axis_size("fold")
        accs = np.concatenate(gathered[::per_line])[:real_runs]
        result = None
    real = float(accs[0])
    permuted = accs[1:]
    pv = p_value(real, permuted)
    logger.info("Real %.2f%% vs mean permuted %.2f%% (p = %.4f)", real,
                float(np.mean(permuted)), pv)
    return PermutationResult(real_accuracy=real,
                             permuted_accuracies=permuted, p_value=pv,
                             folds=result)
