"""Fold training: every fold of a protocol advances together on the card.

The counterpart of ``eegnetreplication_tpu/training/loop.py``.  The JAX
package compiles a whole run into one ``lax.scan`` and ``vmap``s it over the
folds; PyTorch runs eagerly, so here the epoch and step loops are Python,
and the fold axis is a leading tensor axis: one train step, and one
validation or test batch, is one pass for all G folds (``training/steps.py``).

- The data pool lives on the device once, ``(N_pool, C, T)``; a fold is an
  index set into it (:class:`FoldSpec`), and a batch is an index gather.
- Each epoch's shuffle comes from a *slot source*: by default
  :func:`keyed_slot_source`, which draws fold ``f``'s permutation at epoch
  ``e`` on a CPU ``torch.Generator`` seeded from ``(seed, f, e)`` alone (so
  the card and the CPU see the same batch order, and a fold's batches do
  not depend on which folds train beside it or on where a run resumed); a
  test can hand in the JAX package's ``_shuffled_slots`` instead.  The
  first ``n`` slots are the real indices in random order, the rest wrap
  around (``slot % n``) at loss weight 0.
- Dropout masks come from one generator on the training device for all G
  folds, so at p > 0 they depend on the grouping; its state travels in the
  carry, so a resumed run draws the masks the unbroken one would.
- Nothing waits for the device inside an epoch: losses, accuracies and the
  best-by-validation snapshot stay on the device, and the run syncs once,
  when :meth:`FoldTrainer.result` copies them out.
- Best-by-validation uses strict ``>`` (ties keep the earlier epoch, like
  the reference's ``model.py:180``); the test pass evaluates the best state.
- Under :func:`debug_nans` (the ``--debugNans`` flag) each train step's
  backward runs in autograd's anomaly mode with NaN checks, and after each
  step every fold's loss, parameters and BatchNorm statistics must be
  finite, or the step raises ``FloatingPointError`` naming the epoch, the
  step, the fold and the tensor.  It waits for the device once per step
  (and anomaly mode once per backward node), so it is a debugging mode.
- Each epoch beats the liveness heartbeat (``resil/heartbeat.py``, the
  process-default emitter, which writes ``EEGTPU_HEARTBEAT_FILE`` when a
  supervisor sets it): a trainer's first epoch beats ``compile`` before it
  starts (on the card it pays cuDNN's and cuBLAS's handles, lazy module
  loading and the first use's ``nvcc`` build of the kernels, as the JAX
  package's first dispatch of a program pays its compile) and every epoch
  beats ``step`` when its work is queued.  A beat reads the host's clock
  only, never the device, so it measures the host's progress: the host
  runs ahead of the card, and a wedged kernel stops the beats only once
  the launch queue fills or something waits for the device (an
  allocation, the chunk boundary's synchronize).  A watchdog therefore
  sees a stalled host, or a stalled card within about one chunk, never a
  single slow kernel.
- *Data parallelism* (``data_group``, this rank's line along the mesh's
  data axis): every batch, train, validation and test alike, is the same
  global batch in each rank of the line, and each rank keeps its
  contiguous part (the JAX loop's ``_shard_slice``); the steps sum over
  the group (``training/steps.py``), so the line trains one set of folds
  as one process would, and each rank draws its own dropout stream
  (:func:`dropout_seed`).  The batch size must split evenly
  (:func:`mesh_data_sharding`).
- Each epoch records its layers (``obs/trace.py::layer``): ``train.epoch``
  around ``train.slot_source`` (the slot source's call),
  ``train.slot_copy`` (the slots' copy to the device), the train steps'
  own ``train.step`` spans (``training/steps.py``) and ``train.validate``
  (the validation batches and the best-state update).
- :meth:`FoldTrainer.carry` is everything a run needs to continue (the
  current and best states, best accuracy, minimum validation loss, the
  per-epoch history and the dropout generator's state), by name;
  :meth:`FoldTrainer.restore` takes it back.  Running E epochs as chunks
  with a carry and restore in between equals E epochs unbroken, bit for
  bit on the CPU.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from torch import nn

from eegnetreplication_tpu_torch.obs import trace as obs_trace
from eegnetreplication_tpu_torch.ops.fused_eegnet import fold_index
from eegnetreplication_tpu_torch.parallel.mesh import DATA_AXIS, local_batch
from eegnetreplication_tpu_torch.resil import heartbeat, preempt
from eegnetreplication_tpu_torch.training import steps as steps_lib
from eegnetreplication_tpu_torch.training.steps import TrainState

# epoch -> (pool indices, loss weights), each (G, train_steps * batch_size)
SlotSource = Callable[[int], tuple[torch.Tensor, torch.Tensor]]
# The per-epoch series of a run, in FoldResult's order.
HISTORY = ("train_losses", "val_losses", "val_accuracies", "grad_norms")
STATE_FIELDS = ("params", "stats", "mu", "nu", "count")

_DEBUG_NANS = contextvars.ContextVar("eegtpu_torch_debug_nans", default=False)


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Check every train step for non-finite values inside the block (the
    port's counterpart of ``jax_debug_nans``; see the module docstring)."""
    token = _DEBUG_NANS.set(enabled)
    try:
        yield
    finally:
        _DEBUG_NANS.reset(token)


@dataclass
class FoldSpec:
    """Index sets of G folds over one data pool, padded to static lengths
    (the padding's content is unused); ``*_n`` are the real counts."""

    train_idx: torch.Tensor   # (G, Ntr_pad) int64
    train_n: torch.Tensor     # (G,) int64
    val_idx: torch.Tensor     # (G, Nva_pad)
    val_n: torch.Tensor
    test_idx: torch.Tensor    # (G, Nte_pad)
    test_n: torch.Tensor

    @property
    def n_folds(self) -> int:
        return self.train_idx.shape[0]

    def to(self, device) -> "FoldSpec":
        return FoldSpec(*(getattr(self, f).to(device) for f in _SPEC_FIELDS))

    def folds(self, lo: int, hi: int) -> "FoldSpec":
        """Folds ``lo`` to ``hi - 1``, at the same padded lengths."""
        return FoldSpec(*(getattr(self, f)[lo:hi] for f in _SPEC_FIELDS))


_SPEC_FIELDS = ("train_idx", "train_n", "val_idx", "val_n", "test_idx",
                "test_n")


@dataclass
class FoldResult:
    """Outcome of G folds' runs (cf. the reference's ``model.py:189``),
    on the CPU."""

    best_state: TrainState          # best-by-validation-accuracy snapshot
    best_val_acc: torch.Tensor      # (G,) percentage
    min_val_loss: torch.Tensor      # (G,)
    train_losses: torch.Tensor      # (G, epochs)
    val_losses: torch.Tensor        # (G, epochs)
    val_accuracies: torch.Tensor    # (G, epochs) percentage
    grad_norms: torch.Tensor        # (G, epochs) mean raw gradient norm
    test_accuracy: torch.Tensor     # (G,) percentage, best state on test


def pad_indices(idx: np.ndarray, pad_to: int) -> np.ndarray:
    """Pad an index vector to a static length (padding content unused)."""
    out = np.zeros(pad_to, dtype=np.int64)
    out[: len(idx)] = idx
    return out


def make_fold_spec(folds, *, train_pad: int, val_pad: int, test_pad: int,
                   device=None) -> FoldSpec:
    """Stack ragged ``(train, val, test)`` index triples into a
    :class:`FoldSpec` of tensors on ``device``."""
    def stack(which, pad):
        return torch.from_numpy(np.stack(
            [pad_indices(np.asarray(f[which]), pad) for f in folds]))

    def counts(which):
        return torch.tensor([len(f[which]) for f in folds],
                            dtype=torch.int64)

    spec = FoldSpec(stack(0, train_pad), counts(0), stack(1, val_pad),
                    counts(1), stack(2, test_pad), counts(2))
    return spec if device is None else spec.to(device)


def shuffled_slots(generator: torch.Generator, idx: torch.Tensor, n: int,
                   n_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One fold's epoch shuffle with wrap-around padding, on the CPU.

    Returns ``(pool_indices, weights)`` of length ``n_slots``: the first
    ``n`` slots are the ``n`` real entries of ``idx`` in random order; later
    slots repeat them (``slot % n``) with weight 0.
    """
    slots = torch.arange(n_slots)
    if n > 0:
        order = torch.randperm(n, generator=generator)
        picked = idx[order[slots % n]]
    else:
        picked = idx[torch.zeros_like(slots)]
    return picked, (slots < n).to(torch.float32)


def shuffle_key(seed: int, fold: int, epoch: int) -> int:
    """The 64-bit seed of fold ``fold``'s shuffle at ``epoch`` (global
    fold index, 0-based epoch), mixed from the three by numpy's
    ``SeedSequence``."""
    words = np.random.SeedSequence([seed & (2 ** 64 - 1), fold, epoch])
    return int(words.generate_state(1, np.uint64)[0])


def keyed_slot_source(spec: FoldSpec, n_slots: int, seed: int,
                      fold_ids: Iterable[int]) -> SlotSource:
    """The default slot source: at each epoch, fold ``g``'s
    :func:`shuffled_slots` from a CPU generator seeded with
    ``shuffle_key(seed, fold_ids[g], epoch)``."""
    train_idx = spec.train_idx.cpu()
    train_n = [int(n) for n in spec.train_n.cpu()]
    fold_ids = [int(f) for f in fold_ids]
    if len(fold_ids) != len(train_n):
        raise ValueError(f"{len(fold_ids)} fold ids for {len(train_n)} folds")

    def source(epoch: int) -> tuple[torch.Tensor, torch.Tensor]:
        picked, weights = zip(*(
            shuffled_slots(torch.Generator().manual_seed(
                shuffle_key(seed, fold, epoch)), train_idx[g], train_n[g],
                n_slots)
            for g, fold in enumerate(fold_ids)))
        return torch.stack(picked), torch.stack(weights)

    return source


def linear_slots(idx: torch.Tensor, n: torch.Tensor, n_slots: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Validation/test slot layout of G folds: slot ``s`` reads
    ``idx[s % n]`` with weight ``s < n``; ``(G, n_slots)`` each."""
    slots = torch.arange(n_slots, device=idx.device)[None, :]
    nn_ = n[:, None]
    pos = torch.where(nn_ > 0, slots % torch.clamp(nn_, min=1),
                      torch.zeros_like(slots))
    return torch.gather(idx, 1, pos), (slots < nn_).to(torch.float32)


def n_steps(pad: int, batch_size: int, at_least: int = 0) -> int:
    return max(at_least, math.ceil(pad / batch_size))


def mesh_data_sharding(mesh, batch_size: int):
    """This rank's data-axis group under ``mesh`` (``None`` for a
    1-wide axis or no mesh), after the JAX package's check that the
    batch splits evenly."""
    n_data = mesh.axis_size(DATA_AXIS) if mesh is not None else 1
    if n_data <= 1:
        return None
    if batch_size % n_data:
        raise ValueError(
            f"batch_size {batch_size} is not divisible by the mesh data "
            f"axis ({n_data}); pick batch_size % meshData == 0")
    return mesh.group(DATA_AXIS)


def dropout_seed(seed: int, first_fold: int, data_rank: int = 0) -> int:
    """The dropout generator's seed of a fold group: ``seed + 2 +
    first_fold`` (data rank 0, and every single-process run), and for data
    rank ``k > 0`` a 63-bit value mixed from the three by ``SeedSequence``:
    a distinct stream per data rank, the counterpart of the JAX step's
    ``fold_in(rng, axis_index("data"))``."""
    base = seed + 2 + first_fold
    if data_rank == 0:
        return base
    words = np.random.SeedSequence([base & (2 ** 64 - 1), data_rank])
    return int(words.generate_state(1, np.uint64)[0] >> np.uint64(1))


class FoldTrainer:
    """G folds trained together over one pool on one device.

    ``model`` is a template of any registered architecture giving the
    geometry and the training hyperparameters (``bn_mode``,
    ``dropout_rate``).  Per epoch (:meth:`run_epoch`): ``ceil(train_pad /
    B)`` train steps, then ``max(1, ceil(val_pad / B))`` validation
    batches, each (for an EEGNet) one launch of the stacked K1 kernel for
    all folds; then the best-by-validation update.  :meth:`test` evaluates
    the best state in ``max(1, ceil(test_pad / B))`` batches.

    ``pool_y`` is ``(N_pool,)``, or ``(G, N_pool)`` for a label pool per
    fold (the permutation test's runs share the trials, not the labels).

    ``shuffle_seed`` and ``fold_ids`` (the folds' global indices in the
    protocol, default ``0..G-1``) key the default shuffles
    (:func:`keyed_slot_source`); ``dropout_generator`` (default: one on the
    pool's device seeded 0) draws the dropout masks.  ``data_group``
    splits every batch over a mesh's data axis (module docstring).
    """

    def __init__(self, model: nn.Module, pool_x: torch.Tensor,
                 pool_y: torch.Tensor, spec: FoldSpec,
                 init_state: TrainState, *, batch_size: int,
                 learning_rate: float, adam_eps: float,
                 maxnorm_mode: str = "reference",
                 slot_source: SlotSource | None = None,
                 shuffle_seed: int = 0,
                 fold_ids: Iterable[int] | None = None,
                 dropout_generator: torch.Generator | None = None,
                 data_group=None):
        device = pool_x.device
        self.data_group = (data_group if data_group is not None
                           and data_group.active else None)
        self.model = model
        self.pool_x, self.pool_y = pool_x, pool_y.long()
        self.spec = spec.to(device)
        self.batch_size = batch_size
        if dropout_generator is None:
            dropout_generator = torch.Generator(device=device).manual_seed(0)
        self.dropout_generator = dropout_generator
        self.step_kw = dict(learning_rate=learning_rate, adam_eps=adam_eps,
                            maxnorm_mode=maxnorm_mode,
                            generator=dropout_generator,
                            data_group=self.data_group)
        g = spec.n_folds
        self.train_steps = n_steps(spec.train_idx.shape[1], batch_size)
        self.val_steps = n_steps(spec.val_idx.shape[1], batch_size, 1)
        self.test_steps = n_steps(spec.test_idx.shape[1], batch_size, 1)
        self.fold_ids = list(range(g) if fold_ids is None else fold_ids)
        if slot_source is None:
            slot_source = keyed_slot_source(
                spec, self.train_steps * batch_size, shuffle_seed,
                self.fold_ids)
        self.slot_source = slot_source
        shards = self.data_group.size if self.data_group else 1
        self.fold_idx = fold_index(g, batch_size // shards, device)

        def real_batches(n):
            return torch.clamp(torch.ceil(n / batch_size), min=1.0)

        self.real_train_batches = real_batches(self.spec.train_n.double()
                                               ).float()
        self.real_val_batches = real_batches(self.spec.val_n.double()
                                             ).float()
        self.val_gather, self.val_w = linear_slots(
            self.spec.val_idx, self.spec.val_n,
            self.val_steps * batch_size)
        # Whether each validation batch holds a real slot: the global
        # batch's, whatever part of it this rank holds.
        self.val_real = self.val_w.reshape(
            g, self.val_steps, batch_size).sum(-1) > 0
        self.state = init_state.to(device)
        self.best = self.state
        self.best_acc = torch.zeros(g, device=device)
        self.min_val_loss = torch.full((g,), math.inf, device=device)
        self.history: list[tuple[torch.Tensor, ...]] = []
        self._beaten = False   # the first epoch beats "compile"
        # A stop request raises at the next epoch; a mesh's ranks turn this
        # off and stop together at a chunk boundary instead.
        self.stop_at_epochs = True

    def _batch(self, gather: torch.Tensor, weights: torch.Tensor, step: int):
        b = self.batch_size
        idx = local_batch(gather[:, step * b:(step + 1) * b],
                          self.data_group)
        return (self.pool_x[idx], fold_labels(self.pool_y, idx),
                local_batch(weights[:, step * b:(step + 1) * b],
                            self.data_group))

    def run_epoch(self) -> None:
        """Train every fold one epoch, validate, keep the best state."""
        if self.stop_at_epochs:
            preempt.raise_if_requested(what="epoch", epoch=len(self.history))
        n_folds = self.spec.n_folds
        if not self._beaten:
            heartbeat.beat("compile", epochs_done=len(self.history),
                           n_folds=n_folds)
            self._beaten = True
        with obs_trace.layer("train.epoch"):
            with obs_trace.layer("train.slot_source"):
                gather, weights = self.slot_source(len(self.history))
            device = self.pool_x.device
            with obs_trace.layer("train.slot_copy"):
                gather = gather.to(device, torch.int64)
                weights = weights.to(device, torch.float32)
            loss_sum = torch.zeros(self.spec.n_folds, device=device)
            gnorm_sum = torch.zeros_like(loss_sum)
            checked = _DEBUG_NANS.get()
            for step in range(self.train_steps):
                x, y, w = self._batch(gather, weights, step)
                if checked:
                    self.state, loss, gnorm = self._checked_step(step, x, y,
                                                                 w)
                else:
                    self.state, loss, gnorm = steps_lib.train_step(
                        self.model, self.state, x, y, w, **self.step_kw)
                loss_sum = loss_sum + loss
                gnorm_sum = gnorm_sum + gnorm
            # epoch_train_loss = running_loss / len(train_loader)
            # (model.py:171)
            train_loss = loss_sum / self.real_train_batches
            grad_norm = gnorm_sum / self.real_train_batches

            with obs_trace.layer("train.validate"):
                val_loss_sum = torch.zeros_like(loss_sum)
                correct = torch.zeros_like(loss_sum)
                with torch.no_grad():
                    for step in range(self.val_steps):
                        x, y, w = self._batch(self.val_gather, self.val_w,
                                              step)
                        loss, hits = steps_lib.eval_step(
                            self.model, self.state, x, y, w, self.fold_idx,
                            self.data_group)
                        val_loss_sum = val_loss_sum + torch.where(
                            self.val_real[:, step], loss,
                            torch.zeros_like(loss))
                        correct = correct + hits
                val_loss = val_loss_sum / self.real_val_batches
                val_acc = 100.0 * correct / torch.clamp(self.spec.val_n,
                                                        min=1)

                improved = val_acc > self.best_acc   # strict >, model.py:180
                self.best = self.state.select(improved, self.best)
                self.best_acc = torch.maximum(self.best_acc, val_acc)
                self.min_val_loss = torch.minimum(self.min_val_loss,
                                                  val_loss)
            self.history.append((train_loss, val_loss, val_acc, grad_norm))
        heartbeat.beat("step", epochs_done=len(self.history),
                       n_folds=n_folds)

    def _checked_step(self, step: int, x, y, w):
        """One train step under :func:`debug_nans`."""
        where = f"epoch {self.epoch + 1}, step {step + 1}"
        try:
            with torch.autograd.set_detect_anomaly(True, check_nan=True):
                state, loss, gnorm = steps_lib.train_step(
                    self.model, self.state, x, y, w, **self.step_kw)
        except RuntimeError as exc:
            if "nan values" not in str(exc):
                raise
            raise FloatingPointError(
                f"--debugNans: {where}: the backward pass produced a NaN "
                f"({exc})") from exc
        finite = (torch.isfinite(loss) & torch.isfinite(state.params).all(1)
                  & torch.isfinite(state.stats).all(1))
        if not bool(finite.all()):                 # the step's one sync
            g = int(torch.nonzero(~finite)[0, 0])
            named = [("loss", loss[g:g + 1])]
            named += [(f"params[{k}]", v[g])
                      for k, v in state.param_views().items()]
            named += [(f"stats[{k}]", v[g])
                      for k, v in state.stat_views().items()]
            tensor = next(n for n, v in named
                          if not bool(torch.isfinite(v).all()))
            raise FloatingPointError(
                f"--debugNans: {where}: fold {self.fold_ids[g]} has a "
                f"non-finite {tensor} after the step")
        return state, loss, gnorm

    def test(self) -> torch.Tensor:
        """Test accuracy (percentage, ``(G,)``) of the best states."""
        return evaluate_pool(self.model, self.best, self.pool_x, self.pool_y,
                             self.spec.test_idx, self.spec.test_n,
                             self.batch_size, self.fold_idx, self.data_group)

    @property
    def epoch(self) -> int:
        """Epochs trained so far."""
        return len(self.history)

    def history_tensors(self, lo: int = 0) -> tuple[torch.Tensor, ...]:
        """``(train_losses, val_losses, val_accuracies, grad_norms)`` of
        epochs ``lo`` on, each ``(G, epochs)`` on the device."""
        if len(self.history) <= lo:
            empty = torch.zeros((self.spec.n_folds, 0),
                                device=self.pool_x.device)
            return (empty,) * len(HISTORY)
        return tuple(torch.stack(series, dim=1)
                     for series in zip(*self.history[lo:]))

    def result(self) -> FoldResult:
        """Run the test pass and copy everything to the CPU (the run's one
        wait for the device)."""
        test_acc = self.test()
        per_epoch = [series.cpu() for series in self.history_tensors()]
        return FoldResult(
            best_state=self.best.to("cpu"),
            best_val_acc=self.best_acc.cpu(),
            min_val_loss=self.min_val_loss.cpu(),
            train_losses=per_epoch[0], val_losses=per_epoch[1],
            val_accuracies=per_epoch[2], grad_norms=per_epoch[3],
            test_accuracy=test_acc.cpu())

    def carry(self) -> dict[str, torch.Tensor]:
        """Everything the run needs to continue, by name, on the device
        (the generator state on the CPU): ``{state,best}/<field>``,
        ``best_acc``, ``min_val_loss``, ``history/<series>`` and
        ``rng/dropout``.  Nothing here waits for the device."""
        out: dict[str, torch.Tensor] = {}
        for prefix, state in (("state", self.state), ("best", self.best)):
            for field in STATE_FIELDS:
                out[f"{prefix}/{field}"] = getattr(state, field)
        out["best_acc"] = self.best_acc
        out["min_val_loss"] = self.min_val_loss
        for name, series in zip(HISTORY, self.history_tensors()):
            out[f"history/{name}"] = series
        out["rng/dropout"] = self.dropout_generator.get_state()
        return out

    def restore(self, carry: Mapping[str, np.ndarray | torch.Tensor]
                ) -> None:
        """Continue from a :meth:`carry` (host arrays or tensors): every
        entry must be there with the shape and type this trainer's own
        carry has, else ``ValueError``."""
        device = self.pool_x.device
        own = self.carry()
        missing = sorted(set(own) - set(carry))
        if missing:
            raise ValueError(f"carry lacks {missing}")
        got = {}
        for name, like in own.items():
            value = carry[name]
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(np.ascontiguousarray(value))
            shape_ok = (value.shape == like.shape if not name.startswith(
                "history/") else value.shape[:1] == like.shape[:1]
                and value.ndim == 2)
            if value.dtype != like.dtype or not shape_ok:
                raise ValueError(
                    f"carry entry {name!r} is {value.dtype} "
                    f"{tuple(value.shape)}; this trainer's is {like.dtype} "
                    f"{tuple(like.shape)}")
            got[name] = value
        epochs = {got[f"history/{n}"].shape[1] for n in HISTORY}
        if len(epochs) != 1:
            raise ValueError(f"carry history lengths differ: {epochs}")
        layout = self.state.layout
        self.state, self.best = (
            TrainState(layout, *(got[f"{prefix}/{f}"].to(device)
                                 for f in STATE_FIELDS))
            for prefix in ("state", "best"))
        self.best_acc = got["best_acc"].to(device)
        self.min_val_loss = got["min_val_loss"].to(device)
        series = [got[f"history/{n}"].to(device) for n in HISTORY]
        self.history = [tuple(s[:, e] for s in series)
                        for e in range(epochs.pop())]
        self.dropout_generator.set_state(got["rng/dropout"].cpu())


def fold_labels(pool_y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The labels of ``(G, B)`` pool indices: from one shared label pool
    ``(N,)`` or from each fold's own row of ``(G, N)``."""
    if pool_y.ndim == 1:
        return pool_y[idx]
    return torch.gather(pool_y, 1, idx)


def evaluate_pool(model: nn.Module, state: TrainState, pool_x: torch.Tensor,
                  pool_y: torch.Tensor, idx: torch.Tensor, n: torch.Tensor,
                  batch_size: int, fold_idx: torch.Tensor | None = None,
                  data_group=None) -> torch.Tensor:
    """Accuracy (percentage, ``(G,)``) of every fold's ``state`` on its
    ``pool[idx[:n]]`` (the reference's ``evaluate_model``); with
    ``data_group`` each rank evaluates its part of every batch and the
    counts are summed over the group."""
    steps = n_steps(idx.shape[1], batch_size, 1)
    gather, weights = linear_slots(idx, n, steps * batch_size)
    if fold_idx is None:
        shards = data_group.size if data_group is not None else 1
        fold_idx = fold_index(idx.shape[0], batch_size // shards,
                              pool_x.device)
    correct = torch.zeros(idx.shape[0], device=pool_x.device)
    with torch.no_grad():
        for step in range(steps):
            sl = slice(step * batch_size, (step + 1) * batch_size)
            bi = local_batch(gather[:, sl], data_group)
            _, hits = steps_lib.eval_step(
                model, state, pool_x[bi], fold_labels(pool_y, bi).long(),
                local_batch(weights[:, sl], data_group), fold_idx,
                data_group)
            correct = correct + hits
    return 100.0 * correct / torch.clamp(n, min=1)


def init_fold_states(model: nn.Module, n_folds: int,
                     generator: torch.Generator) -> TrainState:
    """``n_folds`` independent initial states, stacked.

    Each fold draws a fresh model of ``model``'s architecture and geometry
    (``model.fresh``) from ``generator`` (a CPU generator, so one seed
    gives the same weights on any device), like the reference's fresh
    ``EEGNet()`` per fold (``train.py:92``).
    """
    dicts = [model.fresh(generator).state_dict() for _ in range(n_folds)]
    stacked = {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}
    return TrainState.create(steps_lib.StateLayout.of(model), stacked)
