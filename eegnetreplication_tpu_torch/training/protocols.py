"""The within-subject and cross-subject protocols on the card.

The counterpart of ``eegnetreplication_tpu/training/protocols.py`` (the
reference's ``train.py:30-291``).  Every fold is an index set over one pool
that lives on the device, and the folds of a group train together
(``training/loop.py``):

- Within-subject: per subject, the Train and Eval sessions concatenated
  (``train.py:58-59``); ``KFold(4, shuffle=True, random_state=42)`` over
  them and the inner 80/20 split of the train-val ids (``data/splits.py``),
  in the reference's fold order; dropout 0.5; per subject, the mean test
  accuracy of its folds and the best fold by ``argmax`` of the best
  validation accuracy (the first maximum, ``train.py:126-128``), saved as
  ``subject_XX_best_model.pth`` and ``.npz`` (a baseline, the ``.npz``
  only, as in the JAX package).
- Cross-subject: per fold, ``RandomState(42 + fold_count)`` permutes the
  non-test subjects into 5 train and the rest validation
  (``train.py:199-202``); training and validation read the *Train session*
  of those subjects, the test the held-out subject's *Eval session*
  (``train.py:188, 258``); dropout 0.25; the global best fold by ``argmin``
  of the minimum validation loss (the first minimum, ``train.py:269-271``),
  saved as ``cross_subject_best_model.pth`` and ``.npz``.

Any registered model trains (``models/registry.py``: EEGNet, EEGNet-wide,
ShallowConvNet, DeepConvNet); only EEGNet's validation and test passes
launch K1-stacked, and only in the ``"highest"`` numerics mode.

*Spans.*  The set-up records its layers (``obs/trace.py::layer``):
``setup.pool`` (:func:`build_pool`), ``setup.folds`` (the fold lists),
``setup.build`` (:meth:`FoldSetup.build`, around ``setup.init_states`` and
``setup.digest``) and ``setup.trainer`` (:meth:`FoldSetup.trainer`).

*Numerics.*  ``config.precision`` builds the model with the JAX package's
kwargs for the mode (:func:`_model_kwargs_for_precision`) and runs the
protocol inside ``utils/device.py::numerics`` (TF32 on the card under
``"high"``, ``"default"`` and ``"bf16"``).  The run signature carries the
mode, so a snapshot of another mode is a different run.

:func:`run_folds` is the machinery both share, with the JAX package's
semantics (``_run_folds``):

- *Groups.* ``fold_batch=N`` trains at most N folds at once, group after
  group, and concatenates the results; 0 or ``None`` is one group.  A
  fold's initial weights and batch order depend only on ``(seed, global
  fold index, epoch)``: the protocol draws every fold's initial state and
  slices it, and the shuffles are keyed.  Dropout masks are drawn per group
  on the device's generator, so at p > 0 another grouping draws other
  masks; at p = 0 a grouped run equals one group per fold, to f32 rounding.
  A device fault in a group (``resil/retry.py::is_device_fault``: out of
  memory or a CUDA runtime error) halves the group size and retrains that
  group; the size that then completes is recorded for this card.
- *Chunks.* ``checkpoint_every=N`` trains N epochs at a time and hands the
  trainer's carry to the snapshot writer (``training/async_ckpt.py``) at
  each chunk boundary; ``None`` chunks runs of more than
  :data:`AUTO_CHUNK_THRESHOLD` epochs at :func:`_auto_chunk_size`.  The
  reference-cadence epoch lines are logged at each chunk boundary.
- *Resume.* ``resume=True`` continues from the run snapshot whose
  signature matches this run's (protocol, model, subjects, epochs, folds,
  seed, update rules, pool geometry and content, and the port's carry
  layout); a snapshot of the same geometry over other data starts fresh
  with a warning, any other mismatch raises.  A completed run deletes its
  snapshots.

Seeds: ``seed`` draws the folds' initial weights, ``seed + 1`` keys the
epoch shuffles (on CPU generators, so the card and the CPU train on the
same weights and batches), ``seed + 2 + first fold`` the dropout masks of
a group on the training device.  Wall times are training only, on the host
clock, each chunk ended by a synchronize; the test pass is logged apart.

Inside a run journal (``obs/journal.py``) the machinery emits the JAX
package's events: ``train_setup``, ``fold_group``, ``device_fault`` and
``retry``, one ``epoch`` per trained epoch (fold means read from the
history each chunk already copies to the host), and the metrics
``fold_epochs_total``, ``chunk_wall_s``, ``device_fault_retries`` and
``fault_retry_wall_s``.  It probes the chaos sites ``train.step``,
``train.chunk``, ``train.hang`` and ``host.preempt``
(``resil/inject.py``), and beats the liveness heartbeat ``step`` at each
chunk boundary, right after the stop check, beside the trainer's beat per
epoch (``training/loop.py``).

**The mesh** (``mesh=``, a ``parallel/mesh.py::Mesh`` of rank processes;
``train --meshFold/--meshData``).  Every rank loads the pool and builds
the whole fold set, padded to a multiple of the fold axis by repeating
fold 0 (its index sets, initial state and shuffles; the padding is dropped
after training, and a run snapshot's signature carries ``padded_folds``).
The initial states are drawn for every fold from the one generator, as in
a single process, and each rank keeps its block of ``padded / meshFold``
folds (``parallel/shardspec.py::fold_block``), whose dropout generator is
seeded ``seed + 2 + first fold``: a rank's block trains bit for bit as the
same block does as a ``fold_batch`` group in one process.  Groups and
their OOM halving apply within a rank's block.  Under ``meshData`` every
batch is also split over the data axis (``training/loop.py``).  At each
chunk boundary every rank makes the same collectives, in order: one
``all_reduce`` agrees on a stop request and a device fault (so every rank
stops, or halves its group, at the same chunk), then the chunk's carries
are gathered to the first rank, which alone writes the run snapshot (the
whole padded fold set, every rank's dropout generator beside it).  The
per-epoch stop check is off under a mesh: a stop waits for the chunk
boundary.  A resumed carry is read by the first rank and broadcast, and
each rank keeps its block.  The folds' results are gathered to the first
rank (over gloo, as pickled host tensors), which alone journals, logs the
summary, saves the models and returns the result; every other rank
returns ``None``.
"""

from __future__ import annotations

import functools
import hashlib
import json
import math
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from eegnetreplication_tpu_torch.config import (
    DEFAULT_TRAINING,
    Paths,
    TrainingConfig,
)
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.data.splits import (
    cross_subject_fold_subjects,
    inner_train_val_split,
    kfold_indices,
)
from torch import nn

from eegnetreplication_tpu_torch.models import EEGNet, get_model
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace as obs_trace
from eegnetreplication_tpu_torch.resil import heartbeat, inject, preempt
from eegnetreplication_tpu_torch.resil import retry as resil_retry
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training import orbax_io
from eegnetreplication_tpu_torch.training.async_ckpt import SnapshotWriter
from eegnetreplication_tpu_torch.parallel import shardspec
from eegnetreplication_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FOLD_AXIS,
    MODEL_AXIS,
    Mesh,
)
from eegnetreplication_tpu_torch.training.loop import (
    HISTORY,
    FoldResult,
    FoldSpec,
    FoldTrainer,
    dropout_seed,
    init_fold_states,
    make_fold_spec,
    mesh_data_sharding,
)
from eegnetreplication_tpu_torch.training.steps import TrainState
from eegnetreplication_tpu_torch.utils.device import (
    check_precision,
    numerics,
    resolve_device,
)
from eegnetreplication_tpu_torch.utils.logging import logger

LoadFn = Callable[[int, str], BCICI2ADataset]

# Auto-chunking (checkpoint_every=None).  The JAX package chunks long runs
# to dodge XLA's compile time on long scans; PyTorch compiles nothing, so
# on the card chunks serve resumability only.  The rule is kept as it is so
# the CLI's flags mean what they mean in the JAX package.
AUTO_CHUNK_THRESHOLD = 100
AUTO_CHUNK_EPOCHS = 50

# Cross-subject fold-group size on a CUDA card when the caller gives none:
# the fastest size of chip_smoke.py's group-size sweep (PERF.md §5).  The
# JAX package's 15 was measured on a TPU v5e and does not carry over.
CS_CARD_FOLD_BATCH = 90

# Names the layout of the carry a run snapshot holds
# (``FoldTrainer.carry``): a snapshot with another layout, the JAX
# package's included, is never resumed into this one.
CARRY_LAYOUT = "torch-fold-trainer/1"


def _auto_chunk_size(epochs: int) -> int:
    """Chunk length of auto-chunked runs: a divisor of ``epochs`` near
    :data:`AUTO_CHUNK_EPOCHS` where one exists (in 25..100), else
    :data:`AUTO_CHUNK_EPOCHS` with a shorter last chunk."""
    for size in sorted(range(25, 101),
                       key=lambda s: abs(s - AUTO_CHUNK_EPOCHS)):
        if epochs % size == 0:
            return size
    return AUTO_CHUNK_EPOCHS


def _default_loader(subject: int, mode: str) -> BCICI2ADataset:
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset

    return load_subject_dataset(subject=subject, mode=mode)


@dataclass
class ProtocolResult:
    per_subject_test_acc: list[float]
    avg_test_acc: float
    best_states: list[dict]         # per subject (within) or one (cross)
    fold_test_acc: np.ndarray       # every fold's test accuracy
    # Training wall on the host clock: the epochs this process trained,
    # each chunk ended by a synchronize, the test pass excluded, and the
    # wall of group attempts that ran out of memory included (broken out
    # in fault_retry_wall_s).  Basis of epoch_throughput.
    wall_seconds: float
    epochs: int
    subjects: tuple[int, ...] = tuple(range(1, 10))
    # Fold-epochs this process trained (a resumed run trains fewer);
    # None means every fold's every epoch.
    fold_epochs_trained: float | None = None
    # The group size the run started with (None: one group).
    fold_batch: int | None = None
    fold_min_val_loss: np.ndarray | None = None
    fault_retry_wall_s: float = 0.0
    folds: FoldResult | None = None  # every fold's per-epoch record

    @property
    def epoch_throughput(self) -> float:
        """Fold-epochs trained per second."""
        trained = (self.fold_epochs_trained
                   if self.fold_epochs_trained is not None
                   else len(self.fold_test_acc) * self.epochs)
        return trained / max(self.wall_seconds, 1e-9)


def build_pool(datasets: list[BCICI2ADataset]
                ) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Concatenate datasets into one pool; return per-dataset global
    indices."""
    with obs_trace.layer("setup.pool"):
        offsets, cursor = [], 0
        for d in datasets:
            offsets.append(np.arange(cursor, cursor + len(d)))
            cursor += len(d)
        pool_x = np.concatenate([d.X for d in datasets]).astype(np.float32)
        pool_y = np.concatenate([d.y for d in datasets]).astype(np.int64)
        return pool_x, pool_y, offsets


def within_subject_folds(offsets: list[np.ndarray],
                         config: TrainingConfig = DEFAULT_TRAINING
                         ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The ``(train, val, test)`` pool indices of every fold, subjects in
    order and ``config.kfold_splits`` folds each (the reference's order)."""
    with obs_trace.layer("setup.folds"):
        folds = []
        for g in offsets:
            for train_val_ids, test_ids in kfold_indices(
                    len(g), config.kfold_splits, config.kfold_seed):
                train_ids, val_ids = inner_train_val_split(train_val_ids)
                folds.append((g[train_ids], g[val_ids], g[test_ids]))
        return folds


def cross_subject_folds(train_off: list[np.ndarray],
                        eval_off: list[np.ndarray],
                        subjects: tuple[int, ...],
                        config: TrainingConfig = DEFAULT_TRAINING
                        ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The ``(train, val, test)`` pool indices of every cross-subject fold:
    per test subject in order, ``config.cs_repeats_per_subject`` folds, the
    k-th of all drawing its train and validation subjects from
    ``RandomState(42 + k)``; ``train_off[i]``/``eval_off[i]`` are subject
    ``subjects[i]``'s Train and Eval session indices in the pool."""
    with obs_trace.layer("setup.folds"):
        index = {s: i for i, s in enumerate(subjects)}
        folds, fold_count = [], 0
        for s in subjects:
            for _ in range(config.cs_repeats_per_subject):
                fold_count += 1
                tr_subj, va_subj = cross_subject_fold_subjects(
                    s, fold_count, subjects=tuple(subjects),
                    n_train=config.cs_train_subjects)
                folds.append((
                    np.concatenate([train_off[index[t]] for t in tr_subj]),
                    np.concatenate([train_off[index[v]] for v in va_subj]),
                    eval_off[index[s]]))
        return folds


def cross_subject_summary(fold_test: np.ndarray, min_val_loss: np.ndarray,
                          n_subjects: int, repeats: int
                          ) -> tuple[list[float], float, float, int]:
    """``(per-subject mean test accuracy, mean over folds, standard error
    over folds, best fold)``: the best fold is the first minimum of the
    minimum validation loss (``train.py:263-271``)."""
    fold_test = np.asarray(fold_test)
    per_subject = [float(np.mean(fold_test[i * repeats:(i + 1) * repeats]))
                   for i in range(n_subjects)]
    avg_all = float(np.mean(fold_test))
    std_err = float(np.std(fold_test) / np.sqrt(len(fold_test)))
    return per_subject, avg_all, std_err, int(np.argmin(min_val_loss))


def _check_ckpt_format(ckpt_format: str) -> None:
    """Reject an unknown format when the protocol starts, not at save time
    after the whole run trained (the JAX package's check)."""
    if ckpt_format not in ("npz", "orbax"):
        raise ValueError(
            f"Unknown ckpt_format {ckpt_format!r}; expected 'npz' or 'orbax'")


def save_model(state_dict: dict, model: nn.Module, model_name: str,
               path: Path, ckpt_format: str = "npz") -> None:
    """The native artifact beside ``path`` with the geometry the loaders
    read (``ckpt_format`` ``"npz"``: one ``.npz`` file; ``"orbax"``: an
    Orbax checkpoint directory ``.orbax``), and for an EEGNet the
    reference's ``.pth`` at ``path`` (the JAX ``_save_model``: the
    reference has no baseline to load a ``.pth``)."""
    _check_ckpt_format(ckpt_format)
    if isinstance(model, EEGNet):
        ckpt_lib.save_pth(path, state_dict)
    metadata = {"model": model_name, **model.metadata()}
    if ckpt_format == "orbax":
        orbax_io.save_orbax_checkpoint(path.with_suffix(".orbax"),
                                       state_dict, metadata=metadata)
    else:
        ckpt_lib.save_checkpoint(path.with_suffix(".npz"), state_dict,
                                 metadata=metadata)


# --------------------------------------------------------------------------
# The shared machinery: groups, chunks, resume
# --------------------------------------------------------------------------

@dataclass
class FoldSetup:
    """What every group of one protocol run shares: the model template, the
    pool on the device, every fold's spec (padded to the protocol's largest
    fold) and initial state on the CPU, and the pool's content digest."""

    model: nn.Module
    pool_x: torch.Tensor
    pool_y: torch.Tensor
    spec: FoldSpec
    init: TrainState
    config: TrainingConfig
    seed: int
    pool_sha1: str
    # Under a mesh: the real fold count (the rest repeat fold 0), each
    # fold's shuffle key index, and this rank's data-axis group.
    n_real: int | None = None
    fold_ids: list | None = None
    data_group: object = None

    @classmethod
    def build(cls, model: nn.Module, folds, pool_x: np.ndarray,
              pool_y: np.ndarray, *, config: TrainingConfig, seed: int,
              device: torch.device, mesh: Mesh | None = None
              ) -> "FoldSetup":
        with obs_trace.layer("setup.build"):
            n_real = len(folds)
            padded = shardspec.padded_folds(n_real, mesh)
            spec = make_fold_spec(
                list(folds) + [folds[0]] * (padded - n_real),
                train_pad=max(len(f[0]) for f in folds),
                val_pad=max(len(f[1]) for f in folds),
                test_pad=max(len(f[2]) for f in folds))
            with obs_trace.layer("setup.init_states"):
                init = init_fold_states(model, n_real,
                                        torch.Generator().manual_seed(seed))
            if padded != n_real:
                pick = torch.tensor(list(range(n_real))
                                    + [0] * (padded - n_real))
                init = TrainState(init.layout, *(getattr(init, f)[pick]
                                                 for f in _STATE_FIELDS))
            with obs_trace.layer("setup.digest"):
                digest = _pool_digest(pool_x, pool_y)
            return cls(model, torch.from_numpy(pool_x).to(device),
                       torch.from_numpy(pool_y).to(device), spec, init,
                       config, seed, digest, n_real,
                       list(range(n_real)) + [0] * (padded - n_real),
                       mesh_data_sharding(mesh, config.batch_size))

    @property
    def n_folds(self) -> int:
        return self.spec.n_folds

    @property
    def device(self) -> torch.device:
        return self.pool_x.device

    def trainer(self, lo: int, hi: int) -> FoldTrainer:
        """The :class:`FoldTrainer` of folds ``lo`` to ``hi - 1``."""
        cfg = self.config
        ids = (range(lo, hi) if self.fold_ids is None
               else self.fold_ids[lo:hi])
        data = self.data_group
        with obs_trace.layer("setup.trainer"):
            return FoldTrainer(
                self.model, self.pool_x, self.pool_y,
                self.spec.folds(lo, hi), self.init.folds(lo, hi),
                batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
                adam_eps=cfg.adam_eps, maxnorm_mode=cfg.maxnorm_mode,
                shuffle_seed=self.seed + 1, fold_ids=ids, data_group=data,
                dropout_generator=torch.Generator(
                    device=self.device).manual_seed(dropout_seed(
                        self.seed, lo,
                        data.index if data is not None else 0)))


_STATE_FIELDS = ("params", "stats", "mu", "nu", "count")


class MeshDeviceFault(RuntimeError):
    """Raised in every rank of a mesh when any rank's chunk hit a device
    fault (a CUDA error or out of memory), so that all of them halve their
    fold group together."""


class _MeshRun:
    """The collectives of a fold-sharded run at its safe points (module
    docstring), over the default gloo group: every rank of the mesh makes
    each of them, in the same order."""

    def __init__(self, mesh: Mesh):
        import torch.distributed as dist

        self.dist = dist
        self.mesh = mesh
        self.lead = mesh.is_lead
        self.lead_rank = mesh.ranks[0]
        self.n_fold = mesh.axis_size(FOLD_AXIS)
        # The ranks that hold a fold block's carry: data and model index 0.
        per_line = mesh.axis_size(DATA_AXIS) * mesh.axis_size(MODEL_AXIS)
        self.carriers = [mesh.ranks[f * per_line]
                         for f in range(self.n_fold)]

    def agree(self, stop: bool, fault: bool) -> tuple[bool, bool]:
        flags = torch.tensor([float(stop), float(fault)])
        self.dist.all_reduce(flags, op=self.dist.ReduceOp.MAX)
        return bool(flags[0]), bool(flags[1])

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` on the first rank (in rank order), else
        ``None``."""
        out = ([None] * self.dist.get_world_size() if self.lead else None)
        self.dist.gather_object(obj, out, dst=self.lead_rank)
        return out

    def broadcast(self, obj):
        """The first rank's ``obj`` on every rank."""
        box = [obj]
        self.dist.broadcast_object_list(box, src=self.lead_rank)
        return box[0]

    def join_carry(self, carries: list[dict]) -> dict[str, torch.Tensor]:
        """The run snapshot's carry from every rank's: fold-major entries
        from each fold block's carrier in fold order, the dropout
        generators of every rank stacked in rank order."""
        out = {name: torch.cat([carries[r][name] for r in self.carriers])
               for name in carries[0] if name != "rng/dropout"}
        out["rng/dropout"] = torch.stack([c["rng/dropout"]
                                          for c in carries])
        return out

    def own_carry(self, carry, block: int) -> dict:
        """This rank's part of a snapshot's carry (host arrays)."""
        f = self.mesh.axis_index(FOLD_AXIS)
        out = {name: value[f * block:(f + 1) * block]
               for name, value in carry.items() if name != "rng/dropout"}
        out["rng/dropout"] = carry["rng/dropout"][self.mesh.rank]
        return out


def _host_carry(carry: dict) -> dict[str, torch.Tensor]:
    return {name: t.detach().cpu() for name, t in carry.items()}


def _stop_point(mesh_run: _MeshRun | None, **ctx) -> None:
    """A safe point's stop check; under a mesh, agreed by every rank."""
    if mesh_run is None:
        preempt.check(**ctx)
        return
    inject.fire("host.preempt", **ctx)
    stop, _ = mesh_run.agree(preempt.requested(), False)
    if stop and not preempt.requested():
        preempt.request("another rank of the mesh stopped")
    preempt.raise_if_requested(**ctx)


def _pool_digest(pool_x: np.ndarray, pool_y: np.ndarray) -> str:
    """Short sha1 of the pool's bytes: a resumed carry continues over the
    same data, not merely same-shaped data."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(pool_x).tobytes())
    h.update(np.ascontiguousarray(pool_y).tobytes())
    return h.hexdigest()[:12]


def _clear_run_snapshots(checkpoint_path) -> None:
    """Delete a completed run's snapshot and every file beside it that
    shares its name: ``.g*`` group snapshots (from any grouping),
    ``.gen*`` generations and ``*.corrupt`` quarantined ones."""
    if checkpoint_path is None:
        return
    cp = Path(checkpoint_path)
    cp.unlink(missing_ok=True)
    for pattern in (".g*", "*.corrupt"):
        for stale in cp.parent.glob(cp.name + pattern):
            stale.unlink(missing_ok=True)


def _log_epoch_cadence(per_epoch, lo: int, hi: int, total_epochs: int,
                       n_folds: int) -> None:
    """The reference's epoch lines (epoch 1, every 50th, the last;
    ``model.py:185-187``) for epochs ``lo+1..hi``, as the mean over the
    folds with the span of their validation accuracies.  ``per_epoch``
    holds ``(train_losses, val_losses, val_accuracies, ...)`` as ``(G,
    hi - lo)`` host arrays."""
    tl, vl, va = (np.asarray(a) for a in per_epoch[:3])
    for e in range(lo + 1, hi + 1):
        if not (e == 1 or e % 50 == 0 or e == total_epochs):
            continue
        i = e - lo - 1
        logger.info(
            "Epoch: %d/%d.. Train Loss: %.3f.. Val Loss: %.3f.. "
            "Val Acc: %.2f%%.. (mean of %d folds; val-acc span "
            "%.2f-%.2f%%)",
            e, total_epochs, float(np.mean(tl[:, i])),
            float(np.mean(vl[:, i])), float(np.mean(va[:, i])), n_folds,
            float(np.min(va[:, i])), float(np.max(va[:, i])))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_kind(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def _fold_batch_limit_path() -> Path:
    """Per-user record of the fold-group size that completed after a
    halving, per card name (in the temporary directory)."""
    uid = os.getuid() if hasattr(os, "getuid") else "u"
    return Path(tempfile.gettempdir()) / f"eegtpu_torch_fold_batch.{uid}.json"


# A recorded limit older than this is ignored: one transient fault must not
# shrink every later run on this card for good.
_FOLD_BATCH_LIMIT_TTL_S = 30 * 24 * 3600.0


def _record_fold_batch_limit(limit: int, device: torch.device) -> None:
    """Remember a group size that completed a group after halving, keyed by
    the card's name (the latest proven value wins).  Best effort."""
    try:
        path = _fold_batch_limit_path()
        data = json.loads(path.read_text()) if path.exists() else {}
        data[_device_kind(device)] = {"limit": int(limit), "t": time.time()}
        path.write_text(json.dumps(data))
    except (OSError, ValueError) as exc:
        logger.warning("Could not record the fold-group limit: %s", exc)


def _known_fold_batch_limit(device: torch.device) -> int | None:
    """The recorded group size for this card, or None."""
    try:
        rec = json.loads(_fold_batch_limit_path().read_text()).get(
            _device_kind(device))
    except (OSError, ValueError, AttributeError):
        return None
    if (isinstance(rec, dict) and isinstance(rec.get("limit"), int)
            and rec["limit"] > 0
            and time.time() - rec.get("t", 0) < _FOLD_BATCH_LIMIT_TTL_S):
        return rec["limit"]
    return None


def _effective_fold_batch(fold_batch: int | None, n_folds: int
                          ) -> int | None:
    """The grouping :func:`run_folds` uses: None (one group) for 0, None,
    or a size that holds every fold."""
    if not fold_batch or n_folds <= fold_batch:
        return None
    return fold_batch


def _cs_auto_fold_batch(n_folds: int, fold_batch: int | None,
                        device: torch.device) -> int | None:
    """The cross-subject group size: 0 means one group, an explicit value
    passes, and ``None`` on a CUDA card takes :data:`CS_CARD_FOLD_BATCH`
    (or the smaller size recorded after a halving on this card) when the
    protocol has more folds."""
    if fold_batch == 0:
        return None
    if fold_batch is not None:
        return fold_batch
    if device.type == "cuda":
        batch = min(CS_CARD_FOLD_BATCH,
                    _known_fold_batch_limit(device) or CS_CARD_FOLD_BATCH)
        if n_folds > batch:
            logger.info("Auto fold batching: %d folds per group on %s "
                        "(--maxFoldsPerProgram overrides, 0 forces one "
                        "group)", batch, _device_kind(device))
            return batch
    return None


def _log_throughput(model, config, fold_epochs: float, wall: float,
                    train_pad: int, val_pad: int, detail: str,
                    device: torch.device) -> None:
    """Log fold-epochs/s, the achieved GFLOP/s and, on the card, the MFU.

    ``fold_epochs`` is the count this process trained (a resumed run's wall
    covers only the rest).  The FLOPs of a fold-epoch are counted from the
    shapes (``utils/flops.py``); the MFU is against the card's dense peak
    for the arithmetic of ``config.precision`` (FP32, TF32 or BF16), and a
    card without a known peak gets GFLOP/s only."""
    from eegnetreplication_tpu_torch.utils.flops import (
        assumed_peak_flops,
        fold_epoch_flops,
    )

    rate = fold_epochs / max(wall, 1e-9)
    flops_per_s = rate * fold_epoch_flops(
        model, batch_size=config.batch_size, train_pad=train_pad,
        val_pad=val_pad)
    extra = f", {flops_per_s / 1e9:.2f} GFLOP/s"
    if device.type == "cuda":
        peak, label = assumed_peak_flops(_device_kind(device),
                                         config.precision)
        if peak is not None:
            extra += f" = {100 * flops_per_s / peak:.4f}% MFU ({label})"
    logger.info("Throughput: %.2f fold-epochs/s (%s in %.1fs)%s", rate,
                detail, wall, extra)


def _resume_carry(path: Path, signature: dict
                  ) -> tuple[dict[str, np.ndarray], int] | None:
    """The carry to continue from, or None to train from scratch (the
    decisions of the JAX package's ``_run_folds``)."""
    stored = ckpt_lib.read_snapshot_signature(path)
    if stored is None:
        if ckpt_lib.any_snapshot_generation(path):
            logger.warning("Resume: snapshot %s is unreadable — training "
                           "from scratch", path)
        else:
            logger.warning(
                "--resume requested but no snapshot at %s; training from "
                "scratch (check the model/protocol names match the "
                "stopped run)", path)
        return None

    def geometry(sig):
        return {k: v for k, v in sig.items() if k != "pool_sha1"}

    if (geometry(stored) == geometry(signature)
            and stored.get("pool_sha1") != signature["pool_sha1"]):
        logger.warning(
            "Resume: snapshot %s matches this run's geometry but not its "
            "data content (pool digest %s vs %s) — training from scratch",
            path, stored.get("pool_sha1"), signature["pool_sha1"])
        return None
    return ckpt_lib.load_run_snapshot(path, signature)


def _journal_epochs(jr, per_epoch, lo: int, hi: int, total_epochs: int,
                    n_folds: int) -> None:
    """One ``epoch`` event per epoch ``lo+1..hi``: the fold means of the
    training loss, validation loss and accuracy and gradient norm, from the
    host copy of the chunk's history (no further wait for the device)."""
    if not jr.active:
        return
    tl, vl, va, gn = (np.asarray(a) for a in per_epoch)
    for e in range(lo + 1, hi + 1):
        i = e - lo - 1
        train_loss = float(np.mean(tl[:, i]))
        val_loss = float(np.mean(vl[:, i]))
        val_acc = float(np.mean(va[:, i]))
        grad_norm = float(np.mean(gn[:, i]))
        jr.event("epoch", epoch=e, total_epochs=total_epochs,
                 train_loss=round(train_loss, 6),
                 val_loss=round(val_loss, 6), val_acc=round(val_acc, 4),
                 grad_norm=round(grad_norm, 6), n_folds=n_folds)
        jr.scalar("train/loss", train_loss, e)
        jr.scalar("val/loss", val_loss, e)
        jr.scalar("val/accuracy", val_acc, e)
        jr.scalar("train/grad_norm", grad_norm, e)


def _train_group(setup: FoldSetup, lo: int, hi: int, *, epochs: int,
                 every: int, path: Path | None, resume: bool,
                 signature: dict, mesh_run: _MeshRun | None = None
                 ) -> tuple[FoldResult, float, float]:
    """Folds ``lo..hi-1`` through every epoch in chunks of ``every`` (0:
    one pass); returns ``(result, training wall, fold-epochs trained)``.

    Each chunk probes the ``train.step`` chaos site before its first epoch
    (once per dispatch of the group, as the JAX package probes each
    compiled program's dispatch); a chunked run probes ``train.chunk`` and
    ``train.hang`` after each chunk.  Under a mesh (``mesh_run``) ``lo``
    and ``hi`` are this rank's, only the first rank reads and writes
    ``path``, and each chunk boundary is agreed (module docstring)."""
    n = hi - lo
    jr = obs_journal.current()
    trainer = setup.trainer(lo, hi)
    if mesh_run is not None:
        trainer.stop_at_epochs = False   # stops wait for the boundary
    lead = mesh_run is None or mesh_run.lead
    cfg = setup.config
    signature = dict(signature, epochs=epochs, n_folds=n, padded_folds=n,
                     seed=setup.seed, maxnorm_mode=cfg.maxnorm_mode,
                     precision=cfg.precision, bn_mode=cfg.bn_mode,
                     n_pool=int(setup.pool_x.shape[0]),
                     train_pad=int(setup.spec.train_idx.shape[1]),
                     val_pad=int(setup.spec.val_idx.shape[1]),
                     pool_sha1=setup.pool_sha1, carry_layout=CARRY_LAYOUT)
    if mesh_run is not None:
        signature.update(padded_folds=n * mesh_run.n_fold,
                         mesh_shape=dict(mesh_run.mesh.shape))
    start = 0
    if resume and path is not None:
        resumed = _resume_carry(path, signature) if lead else None
        if mesh_run is not None:
            resumed = mesh_run.broadcast(resumed)
        if resumed is not None:
            carry = (resumed[0] if mesh_run is None
                     else mesh_run.own_carry(resumed[0], n))
            trainer.restore(carry)
            start = resumed[1]
            logger.info("Resuming from %s at epoch %d", path, start)
    if every and epochs % every:
        logger.info("epochs (%d) is not a multiple of the %d-epoch chunk: "
                    "the last chunk is %d epochs", epochs, every,
                    epochs % every)
    if not every:
        _stop_point(mesh_run, n_folds=n, what="fused_dispatch")
    writer = (SnapshotWriter(path, signature)
              if every and path is not None and lead else None)
    step = every or epochs
    wall = 0.0
    try:
        for chunk_no, e0 in enumerate(range(start, epochs, step), 1):
            e1 = min(e0 + step, epochs)
            t0 = time.perf_counter()
            fault = None
            try:
                inject.fire("train.step", n_folds=n, epoch=e0)
                for _ in range(e0, e1):
                    trainer.run_epoch()
                _sync(setup.device)
            except Exception as exc:  # noqa: BLE001 — agreed below
                if mesh_run is None or not resil_retry.is_device_fault(exc):
                    raise
                fault = exc
            stop = False
            if mesh_run is not None:
                if every:
                    inject.fire("host.preempt", chunk=chunk_no,
                                epochs_done=e1, n_folds=n)
                stop, any_fault = mesh_run.agree(
                    bool(every) and preempt.requested(), fault is not None)
                if any_fault:
                    raise fault or MeshDeviceFault(
                        "another rank of the mesh hit a device fault "
                        "(CUDA error or out of memory) in this chunk")
            chunk_s = time.perf_counter() - t0
            wall += chunk_s
            jr.metrics.observe("chunk_wall_s", chunk_s)
            if chunk_no == 1:
                jr.sample_device_memory()
            per_epoch = [t.cpu().numpy() for t in trainer.history_tensors(e0)]
            _log_epoch_cadence(per_epoch, e0, e1, epochs, n)
            _journal_epochs(jr, per_epoch, e0, e1, epochs, n)
            if every and path is not None:
                carry = trainer.carry()
                if mesh_run is not None:
                    carries = mesh_run.gather(_host_carry(carry))
                    carry = mesh_run.join_carry(carries) if lead else None
                if writer is not None:
                    writer.submit(carry, epochs_done=e1)
                    logger.info("Checkpoint %d/%d epochs -> %s (async)", e1,
                                epochs, path)
            if every:
                # The chunk boundary is the safe point: the snapshot is
                # submitted, and the writer commits it before a Preempted
                # leaves this function.
                if mesh_run is None:
                    preempt.check(chunk=chunk_no, epochs_done=e1, n_folds=n)
                elif stop:
                    if not preempt.requested():
                        preempt.request("another rank of the mesh stopped")
                    preempt.raise_if_requested(chunk=chunk_no,
                                               epochs_done=e1, n_folds=n)
                # The chunk boundary's liveness beat: a run that stops
                # reaching boundaries goes silent here.
                heartbeat.beat("step", epochs_done=e1, n_folds=n)
                inject.fire("train.chunk", chunk=chunk_no, n_folds=n)
                inject.fire("train.hang", chunk=chunk_no, n_folds=n)
    except BaseException:
        if writer is not None:
            writer.close(raise_errors=False)
        raise
    if writer is not None:
        writer.close()
    t0 = time.perf_counter()
    result = trainer.result()
    logger.info("Test-set evaluation: %.2fs (excluded from training "
                "throughput)", time.perf_counter() - t0)
    trained = float(n * (epochs - start))
    jr.metrics.inc("fold_epochs_total", trained)
    _log_throughput(setup.model, cfg, trained, wall,
                    int(setup.spec.train_idx.shape[1]),
                    int(setup.spec.val_idx.shape[1]),
                    f"{n} folds x {epochs - start} epochs", setup.device)
    return result, wall, trained


def _concat(results: list[FoldResult]) -> FoldResult:
    def cat(tensors):
        return torch.cat(list(tensors), dim=0)

    best = [r.best_state for r in results]
    return FoldResult(
        best_state=TrainState(best[0].layout,
                              *(cat(getattr(b, f) for b in best)
                                for f in _STATE_FIELDS)),
        **{f: cat(getattr(r, f) for r in results)
           for f in ("best_val_acc", "min_val_loss", *HISTORY,
                     "test_accuracy")})


def _first_folds(result: FoldResult, n: int) -> FoldResult:
    """Folds ``0..n-1`` of ``result`` (the padding dropped)."""
    best = result.best_state
    return FoldResult(
        best_state=TrainState(best.layout, *(getattr(best, f)[:n]
                                             for f in _STATE_FIELDS)),
        **{f: getattr(result, f)[:n]
           for f in ("best_val_acc", "min_val_loss", *HISTORY,
                     "test_accuracy")})


def _group_resume(path: Path | None, resume: bool, gi: int, lo: int,
                  hi: int) -> bool:
    """Whether group ``gi`` (folds ``lo..hi-1``) resumes from its
    snapshot at ``path``."""
    if not (resume and path is not None
            and ckpt_lib.any_snapshot_generation(path)):
        return False
    stored = ckpt_lib.read_snapshot_signature(path)
    if stored is None:
        logger.warning("Resume: snapshot %s is unreadable — training group "
                       "%d fresh", path, gi)
        return False
    if stored.get("fold_range") != [lo, hi] or stored.get("fold_group") != gi:
        logger.warning(
            "Resume: snapshot %s is from a different fold grouping (folds "
            "%s, this group trains %s) — training group %d fresh", path,
            stored.get("fold_range"), [lo, hi], gi)
        return False
    return True


def run_folds(setup: FoldSetup, *, epochs: int,
              fold_batch: int | None = None,
              checkpoint_every: int | None = None,
              checkpoint_path: Path | None = None, resume: bool = False,
              signature: dict | None = None, mesh: Mesh | None = None
              ) -> tuple[FoldResult, float, float, float] | None:
    """Train every fold of ``setup``; returns ``(results, wall,
    fold-epochs trained, wall of halved-away attempts)``.

    See the module docstring for groups, chunks, resume and the mesh.
    Journals ``train_setup`` once, ``fold_group`` per group, and
    ``device_fault`` with a ``retry`` per halving.  Under a mesh every
    rank trains its fold block, and the first rank returns every real
    fold's results (the wall the longest rank's, the fold-epochs the real
    folds'); the other ranks return ``None``.
    """
    if fold_batch is not None and fold_batch < 0:
        raise ValueError(f"fold_batch must be >= 0, got {fold_batch}")
    if checkpoint_every is not None and checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}")
    mesh_run = (_MeshRun(mesh) if mesh is not None and mesh.size > 1
                else None)
    lead = mesh_run is None or mesh_run.lead
    blo, bhi = shardspec.fold_block(setup.n_folds, mesh)
    n_block = bhi - blo
    every = checkpoint_every
    if every is None:
        every = (_auto_chunk_size(epochs) if epochs > AUTO_CHUNK_THRESHOLD
                 else 0)
        if every:
            logger.info("Auto-chunking %d epochs into %d-epoch chunks "
                        "(resumable with --resume); pass "
                        "checkpoint_every=0 for one pass", epochs, every)
    if resume and not every:
        raise ValueError(
            "resume requires a chunked run (checkpoint_every > 0, or the "
            f"auto default with epochs > {AUTO_CHUNK_THRESHOLD}); this run "
            "is one pass")
    fold_batch = _effective_fold_batch(fold_batch, n_block)
    signature = dict(signature or {})
    kw = dict(epochs=epochs, every=every, mesh_run=mesh_run)
    logger.info("Training %d folds for %d epochs on %s, %s", n_block, epochs,
                setup.device, f"{fold_batch} folds a group" if fold_batch
                else "all folds per step")
    jr = obs_journal.current()
    # An epoch's real and padded training slots, from host values.
    spec, batch = setup.spec, setup.config.batch_size
    train_pad = int(spec.train_idx.shape[1])
    real_train = int(spec.train_n[blo:bhi].sum())
    jr.event("train_setup", protocol=signature.get("protocol", "adhoc"),
             n_folds=n_block, epochs=epochs, train_pad=train_pad,
             val_pad=int(spec.val_idx.shape[1]),
             test_pad=int(spec.test_idx.shape[1]),
             real_train_samples=real_train,
             padded_train_slots=(n_block * math.ceil(train_pad / batch)
                                 * batch - real_train),
             fold_batch=fold_batch,
             **({"mesh_shape": dict(mesh.shape), "fold_block": [blo, bhi]}
                if mesh_run is not None else {}))

    if not fold_batch:
        result, wall, trained = _train_group(
            setup, blo, bhi, path=checkpoint_path, resume=resume,
            signature=signature, **kw)
        if lead:
            _clear_run_snapshots(checkpoint_path)
        return _mesh_results(setup, mesh_run, result, wall, trained, 0.0)

    n_groups = -(-n_block // fold_batch)
    if (lead and resume and checkpoint_path is not None
            and ckpt_lib.any_snapshot_generation(checkpoint_path)
            and not any(ckpt_lib.any_snapshot_generation(
                f"{checkpoint_path}.g{g}") for g in range(n_groups))):
        logger.warning(
            "Resume: found an ungrouped run snapshot at %s but this run "
            "trains in %d-fold groups and no group snapshots exist — "
            "training restarts from epoch 0 (fold_batch=0 would resume it "
            "as one group)", checkpoint_path, fold_batch)
    results, wall, trained, fault_wall = [], 0.0, 0.0, 0.0
    gi, lo, cur, halved, attempt = 0, blo, fold_batch, False, 1
    while lo < bhi:
        hi = min(lo + cur, bhi)
        logger.info("Training fold group %d: folds %d-%d of %d", gi, lo,
                    hi - 1, setup.n_folds)
        jr.event("fold_group", group=gi, fold_lo=lo, fold_hi=hi,
                 n_folds=setup.n_folds, fold_batch=cur)
        gpath = (None if checkpoint_path is None
                 else Path(f"{checkpoint_path}.g{gi}"))
        # Under a mesh a group's range is the block's own, the same in
        # every rank, and the first rank decides whether it resumes.
        rlo, rhi = lo - blo, hi - blo
        gsig = dict(signature, fold_group=gi,
                    fold_range=[rlo, rhi] if mesh_run else [lo, hi])
        gresume = (_group_resume(gpath, resume, gi, *gsig["fold_range"])
                   if lead else False)
        if mesh_run is not None:
            gresume = mesh_run.broadcast(gresume)
        t_attempt = time.perf_counter()
        try:
            r, w, fe = _train_group(setup, lo, hi, path=gpath,
                                    resume=gresume, signature=gsig, **kw)
        except Exception as exc:  # noqa: BLE001 — classified below
            # Only a device fault is worth a smaller group; anything else
            # (an injected train.chunk crash, a stop request) propagates.
            if cur <= 1 or not resil_retry.is_device_fault(exc):
                raise
            elapsed = time.perf_counter() - t_attempt
            wall += elapsed
            fault_wall += elapsed
            cur = max(1, cur // 2)
            halved = True
            jr.event("device_fault",
                     error=f"{type(exc).__name__}: {exc}"[:300],
                     fold_lo=lo, fold_hi=hi, retry_fold_batch=cur,
                     elapsed_s=round(elapsed, 3))
            resil_retry.journal_retry(
                site="train.step", attempt=attempt, max_attempts=0, exc=exc,
                fold_lo=lo, fold_hi=hi, retry_fold_batch=cur)
            attempt += 1
            jr.metrics.inc("device_fault_retries")
            jr.metrics.inc("fault_retry_wall_s", elapsed)
            logger.warning(
                "Device fault training folds %d-%d (%s: %.160s) — halving "
                "the fold group to %d and retrying from fold %d", lo, hi - 1,
                type(exc).__name__, exc, cur, lo)
            del exc
            if setup.device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        results.append(r)
        wall += w
        trained += fe
        lo, gi, attempt = hi, gi + 1, 1
        if halved:
            if lead:
                _record_fold_batch_limit(cur, setup.device)
            halved = False
    if lead:
        _clear_run_snapshots(checkpoint_path)
    _log_throughput(setup.model, setup.config, trained, wall, train_pad,
                    int(spec.val_idx.shape[1]),
                    f"{n_block} folds x {epochs} epochs in "
                    f"{len(results)} groups", setup.device)
    return _mesh_results(setup, mesh_run, _concat(results), wall, trained,
                         fault_wall)


def _mesh_results(setup: FoldSetup, mesh_run: _MeshRun | None,
                  result: FoldResult, wall: float, trained: float,
                  fault_wall: float
                  ) -> tuple[FoldResult, float, float, float] | None:
    """A single process's results as they are; under a mesh every fold
    block's results gathered to the first rank in fold order, the padding
    dropped (``None`` on the other ranks)."""
    n_real = setup.n_real if setup.n_real is not None else setup.n_folds
    if mesh_run is None:
        return _first_folds(result, n_real), wall, trained, fault_wall
    rows = mesh_run.gather((result, wall, trained, fault_wall))
    if not mesh_run.lead:
        return None
    blocks = [rows[r] for r in mesh_run.carriers]
    joined = _concat([b[0] for b in blocks])
    trained = sum(b[2] for b in blocks) * n_real / setup.n_folds
    return (_first_folds(joined, n_real), max(r[1] for r in rows), trained,
            max(r[3] for r in rows))


# --------------------------------------------------------------------------
# The protocols
# --------------------------------------------------------------------------

def _model_kwargs_for_precision(config: TrainingConfig) -> dict:
    """Model kwargs for the config's numerics mode, the JAX package's
    (``protocols.py::_model_kwargs_for_precision``) with torch's bf16."""
    precision = check_precision(config.precision)
    if precision == "highest":
        return {}  # the models' parity default
    if precision == "high":
        return {"precision": "high"}
    if precision == "default":
        return {"precision": None}
    return {"precision": None, "dtype": torch.bfloat16}


def _in_numerics(protocol):
    """``protocol`` run inside the numerics scope of its ``config``'s
    precision (``utils/device.py::numerics``)."""
    @functools.wraps(protocol)
    def run(*args, config: TrainingConfig = DEFAULT_TRAINING, **kw):
        with numerics(config.precision):
            return protocol(*args, config=config, **kw)

    return run


def _protocol_model(model_name: str, pool_x: np.ndarray, dropout: float,
                    config: TrainingConfig, mesh: Mesh | None = None
                    ) -> nn.Module:
    """The registry's model for a protocol, in the config's numerics mode
    (:func:`_model_kwargs_for_precision`).  ``bn_mode`` "torch" goes to
    the constructor, which only EEGNet's takes (a baseline's raises
    ``TypeError``, as the JAX package's does); "flax" is every model's
    default.  A mesh with a data axis wider than 1 syncs the BatchNorms
    over it (``bn_axis_name="data"``, the JAX ``_model_kwargs_for_mesh``).
    """
    bn = {} if config.bn_mode == "flax" else {"bn_mode": config.bn_mode}
    if mesh_data_sharding(mesh, config.batch_size) is not None:
        bn["bn_axis_name"] = DATA_AXIS
    return get_model(model_name, n_channels=pool_x.shape[1],
                     n_times=pool_x.shape[2], dropout_rate=dropout,
                     device="cpu", **_model_kwargs_for_precision(config),
                     **bn)


def within_subject_trainer(pool_x: np.ndarray, pool_y: np.ndarray,
                           offsets: list[np.ndarray], *,
                           config: TrainingConfig = DEFAULT_TRAINING,
                           seed: int = 0,
                           device: torch.device | str | None = None,
                           model_name: str = "eegnet"
                           ) -> tuple[FoldTrainer, nn.Module, list]:
    """One :class:`FoldTrainer` of every within-subject fold over a pool
    (:func:`build_pool`) on ``device``; returns ``(trainer, model
    template, folds)``."""
    model = _protocol_model(model_name, pool_x,
                            config.dropout_within_subject, config)
    folds = within_subject_folds(offsets, config)
    setup = FoldSetup.build(model, folds, pool_x, pool_y, config=config,
                            seed=seed, device=resolve_device(device))
    return setup.trainer(0, len(folds)), model, folds


def cross_subject_setup(loader: LoadFn, subjects: tuple[int, ...], *,
                        config: TrainingConfig = DEFAULT_TRAINING,
                        seed: int = 0,
                        device: torch.device | str | None = None,
                        model_name: str = "eegnet", mesh: Mesh | None = None
                        ) -> tuple[FoldSetup, list]:
    """The cross-subject pool (every subject's Train session, then every
    subject's Eval session), its folds and their :class:`FoldSetup`."""
    n_subjects = len(subjects)
    if n_subjects < config.cs_train_subjects + 2:
        raise ValueError(
            f"Cross-subject training needs at least "
            f"{config.cs_train_subjects + 2} subjects "
            f"({config.cs_train_subjects} train + 1 val + 1 test); "
            f"got {n_subjects}.")
    logger.info("Loading data for all subjects...")
    train_sets = [loader(s, "Train") for s in subjects]
    eval_sets = [loader(s, "Eval") for s in subjects]
    pool_x, pool_y, offsets = build_pool(train_sets + eval_sets)
    model = _protocol_model(model_name, pool_x,
                            config.dropout_cross_subject, config, mesh)
    folds = cross_subject_folds(offsets[:n_subjects], offsets[n_subjects:],
                                tuple(subjects), config)
    return FoldSetup.build(model, folds, pool_x, pool_y, config=config,
                           seed=seed, device=resolve_device(device),
                           mesh=mesh), folds


@_in_numerics
def within_subject_training(epochs: int | None = None, *,
                            config: TrainingConfig = DEFAULT_TRAINING,
                            loader: LoadFn = _default_loader,
                            subjects: tuple[int, ...] = tuple(range(1, 10)),
                            seed: int = 0, paths: Paths | None = None,
                            model_name: str = "eegnet",
                            save_models: bool = True,
                            device: torch.device | str | None = None,
                            fold_batch: int | None = None,
                            checkpoint_every: int | None = None,
                            resume: bool = False, mesh: Mesh | None = None,
                            ckpt_format: str = "npz"
                            ) -> ProtocolResult | None:
    """Within-subject protocol: per subject, 4-fold CV over both sessions,
    on ``device`` (the card unless ``EEGTPU_PLATFORM=cpu``), through
    :func:`run_folds`, in the numerics scope of ``config.precision``;
    under ``mesh`` sharded over its ranks (``None`` on every rank but the
    first; module docstring)."""
    _check_ckpt_format(ckpt_format)
    epochs = epochs if epochs is not None else config.epochs
    paths = paths or Paths.from_here()
    device = resolve_device(device)
    mesh_data_sharding(mesh, config.batch_size)
    datasets = []
    for s in subjects:
        logger.info("Loading Subject %d", s)
        datasets.append(loader(s, "Train").concat(loader(s, "Eval")))
    pool_x, pool_y, offsets = build_pool(datasets)
    model = _protocol_model(model_name, pool_x,
                            config.dropout_within_subject, config, mesh)
    folds = within_subject_folds(offsets, config)
    setup = FoldSetup.build(model, folds, pool_x, pool_y, config=config,
                            seed=seed, device=device, mesh=mesh)
    ran = run_folds(
        setup, epochs=epochs, fold_batch=fold_batch,
        checkpoint_every=checkpoint_every,
        checkpoint_path=paths.models / f"within_subject_{model_name}.run.npz",
        resume=resume,
        signature={"protocol": "within_subject", "model": model_name,
                   "subjects": list(subjects)}, mesh=mesh)
    if ran is None:
        return None
    results, wall, trained, fault_wall = ran

    fold_test = results.test_accuracy.numpy()
    fold_best_val = results.best_val_acc.numpy()
    k = config.kfold_splits
    per_subject_test_acc, best_states = [], []
    for i, s in enumerate(subjects):
        per_subject_test_acc.append(float(np.mean(fold_test[i * k:(i + 1) * k])))
        best_fold = i * k + int(np.argmax(fold_best_val[i * k:(i + 1) * k]))
        best_states.append(results.best_state.state_dict(best_fold))
        logger.info("Subject %d - Average Test Accuracy: %.2f%%", s,
                    per_subject_test_acc[-1])
        if save_models:
            paths.models.mkdir(parents=True, exist_ok=True)
            save_model(best_states[-1], model, model_name,
                       paths.models / f"subject_{s:02d}_best_model.pth",
                       ckpt_format)

    avg = float(np.mean(per_subject_test_acc))
    logger.info("Overall Average Test Accuracy across all subjects: %.2f%%",
                avg)
    return ProtocolResult(
        per_subject_test_acc, avg, best_states, fold_test, wall, epochs,
        tuple(subjects), fold_epochs_trained=trained,
        fold_batch=_effective_fold_batch(fold_batch, len(folds)),
        fold_min_val_loss=results.min_val_loss.numpy(),
        fault_retry_wall_s=fault_wall, folds=results)


@_in_numerics
def cross_subject_training(epochs: int | None = None, *,
                           config: TrainingConfig = DEFAULT_TRAINING,
                           loader: LoadFn = _default_loader,
                           subjects: tuple[int, ...] = tuple(range(1, 10)),
                           seed: int = 0, paths: Paths | None = None,
                           model_name: str = "eegnet",
                           save_models: bool = True,
                           device: torch.device | str | None = None,
                           fold_batch: int | None = None,
                           checkpoint_every: int | None = None,
                           resume: bool = False, mesh: Mesh | None = None,
                           ckpt_format: str = "npz"
                           ) -> ProtocolResult | None:
    """Cross-subject protocol: per held-out subject,
    ``config.cs_repeats_per_subject`` folds of 5 train and the rest
    validation subjects, on ``device``, through :func:`run_folds` in groups
    of ``fold_batch`` folds (default: :func:`_cs_auto_fold_batch`, of a
    rank's block under ``mesh``; ``None`` on every rank but the first), in
    the numerics scope of ``config.precision``."""
    _check_ckpt_format(ckpt_format)
    epochs = epochs if epochs is not None else config.epochs
    paths = paths or Paths.from_here()
    device = resolve_device(device)
    mesh_data_sharding(mesh, config.batch_size)
    setup, folds = cross_subject_setup(loader, tuple(subjects), config=config,
                                       seed=seed, device=device,
                                       model_name=model_name, mesh=mesh)
    lo, hi = shardspec.fold_block(setup.n_folds, mesh)
    fold_batch = _cs_auto_fold_batch(hi - lo, fold_batch, device)
    ran = run_folds(
        setup, epochs=epochs, fold_batch=fold_batch,
        checkpoint_every=checkpoint_every,
        checkpoint_path=paths.models / f"cross_subject_{model_name}.run.npz",
        resume=resume,
        signature={"protocol": "cross_subject", "model": model_name,
                   "subjects": list(subjects)}, mesh=mesh)
    if ran is None:
        return None
    results, wall, trained, fault_wall = ran

    fold_test = results.test_accuracy.numpy()
    min_val_loss = results.min_val_loss.numpy()
    per_subject, avg_all, std_err, best_fold = cross_subject_summary(
        fold_test, min_val_loss, len(subjects),
        config.cs_repeats_per_subject)
    for s, acc in zip(subjects, per_subject):
        logger.info("Subject %d - Average Test Accuracy: %.2f%%", s, acc)
    logger.info("Overall Average Test Accuracy: %.2f%% +- %.2f%%", avg_all,
                std_err)
    best_state = results.best_state.state_dict(best_fold)
    if save_models:
        paths.models.mkdir(parents=True, exist_ok=True)
        save_model(best_state, setup.model, model_name,
                   paths.models / "cross_subject_best_model.pth",
                   ckpt_format)
    return ProtocolResult(
        per_subject, avg_all, [best_state], fold_test, wall, epochs,
        tuple(subjects), fold_epochs_trained=trained,
        fold_batch=_effective_fold_batch(fold_batch, len(folds)),
        fold_min_val_loss=min_val_loss, fault_retry_wall_s=fault_wall,
        folds=results)
