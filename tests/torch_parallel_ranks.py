"""Rank bodies of the port's mesh tests.

A rank process imports only the port: this module imports no JAX and
nothing of the JAX package (the test modules do, and a spawned rank would
import the module of its function).  Run it in a child process; it forks
its ranks (``parallel/launch.py``):

    python tests/torch_parallel_ranks.py protocol|permutation <in.npz> <out.npz>

``protocol`` runs ``within_subject_training`` over a ``(fold, data)`` mesh
of ranks (``mesh`` in ``in.npz``) on the subjects' pools stored there
(``X/<subject>/<mode>``, ``y/<subject>/<mode>``), at its batch size,
dropout and epochs, on the CPU.  Given ``init/<name>`` (every real fold's
initial state, stacked) and ``slots_idx``/``slots_w`` (``(epochs, folds,
slots)``: every fold's shuffle slots), it trains from those instead of its
own draws, as the JAX run it is compared with did.  Rank 0 writes the
folds' test accuracies, minimum validation losses and per-epoch losses to
``out.npz``.

``permutation`` runs ``permutation_test`` on ``X``/``y`` with its runs
sharded over a ``(fold, data)`` mesh; rank 0 writes the real and permuted
accuracies and the p-value.
"""

import os
import sys

import numpy as np
import torch

from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.parallel import launch
from eegnetreplication_tpu_torch.parallel.mesh import make_mesh
from eegnetreplication_tpu_torch.training import loop, protocols, steps
from eegnetreplication_tpu_torch.training.permutation import permutation_test


def _patch_inputs(inp: dict) -> None:
    """Train from the given initial states and shuffle slots."""
    names = [k[len("init/"):] for k in inp if k.startswith("init/")]
    if names:
        def init_fold_states(model, n_folds, generator):
            layout = steps.StateLayout.of(model)
            stacked = {k: torch.from_numpy(inp[f"init/{k}"][:n_folds])
                       for k in names}
            return steps.TrainState.create(layout, stacked)

        protocols.init_fold_states = init_fold_states
    if "slots_idx" in inp:
        def keyed_slot_source(spec, n_slots, seed, fold_ids):
            ids = list(fold_ids)

            def source(epoch):
                return (torch.from_numpy(inp["slots_idx"][epoch][ids]),
                        torch.from_numpy(inp["slots_w"][epoch][ids]))

            return source

        loop.keyed_slot_source = keyed_slot_source


def protocol_body(in_path: str, out_path: str) -> int:
    inp = dict(np.load(in_path))
    _patch_inputs(inp)
    n_fold, n_data = (int(v) for v in inp["mesh"])
    batch, epochs = (int(v) for v in inp["run"])
    config = DEFAULT_TRAINING.replace(
        batch_size=batch, dropout_within_subject=float(inp["dropout"]))
    subjects = tuple(int(s) for s in inp["subjects"])

    def loader(subject, mode):
        return BCICI2ADataset(X=inp[f"X/{subject}/{mode}"],
                              y=inp[f"y/{subject}/{mode}"])

    mesh = make_mesh(n_fold=n_fold, n_data=n_data)
    result = protocols.within_subject_training(
        epochs, config=config, loader=loader, subjects=subjects,
        paths=Paths.from_root(os.path.dirname(out_path)),
        save_models=False, device="cpu", checkpoint_every=0, mesh=mesh)
    if result is not None:
        folds = result.folds
        np.savez(out_path, fold_test_acc=result.fold_test_acc,
                 min_val_loss=result.fold_min_val_loss,
                 train_losses=folds.train_losses.numpy(),
                 val_losses=folds.val_losses.numpy())
    return 0


def permutation_body(in_path: str, out_path: str) -> int:
    inp = dict(np.load(in_path))
    n_fold, n_data = (int(v) for v in inp["mesh"])
    n_perm, epochs = (int(v) for v in inp["run"])
    config = DEFAULT_TRAINING.replace(
        batch_size=int(inp["batch"]),
        dropout_within_subject=float(inp["dropout"]))
    result = permutation_test(
        inp["X"], inp["y"], n_permutations=n_perm, epochs=epochs,
        config=config, device="cpu",
        mesh=make_mesh(n_fold=n_fold, n_data=n_data))
    if result is not None:
        np.savez(out_path, real=np.array(result.real_accuracy),
                 permuted=result.permuted_accuracies,
                 p_value=np.array(result.p_value))
    return 0


BODIES = {"protocol": protocol_body, "permutation": permutation_body}


def main(argv) -> int:
    what, in_path, out_path = argv
    torch.set_num_threads(1)
    mesh = np.load(in_path)["mesh"]
    return launch.launch(BODIES[what], int(np.prod(mesh)),
                         (in_path, out_path))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
