"""Optimizer, loss and the train/eval steps of G folds at once.

The counterpart of ``eegnetreplication_tpu/training/steps.py``.  The JAX
package writes one fold's step and ``vmap``s it over the folds; here every
function takes the folds stacked along a leading G axis, so one step of a
protocol is one forward, one backward and one optimizer update for all of
its folds.

A fold's state lives in flat ``(G, P)`` and ``(G, Q)`` tensors (parameters;
BatchNorm running statistics) described by a :class:`StateLayout`, whose
views under the ``state_dict`` names feed the model's ``stacked`` forward
(any registered model: EEGNet's
:func:`~eegnetreplication_tpu_torch.models.eegnet.stacked_forward`, or
ShallowConvNet's and DeepConvNet's, ``models/convnets.py``).  So the
gradient of the summed loss is each fold's gradient side by side (the
folds share nothing), and Adam is a handful of operations on one tensor.

- Adam is written out (b1 0.9, b2 0.999, eps 1e-7, ``m_hat / (sqrt(v_hat)
  + eps)``, optax's ``adam``): ``torch.optim.Adam`` keeps one step count
  per tensor, and a fold whose batch holds no real sample must keep its own
  count, moments, parameters and statistics unchanged.
- "Max-norm" is selectable (quirk Q1): ``"reference"`` clamps the
  *gradients* of ``spatial.weight`` (+-1.0) and ``classifier.weight``
  (+-0.25); ``"paper"`` projects the updated weights' L2 norms.  The limits
  are the model's ``MAXNORM_LIMITS`` (none for the baselines).
- :func:`weighted_cross_entropy` is the mean over slots with weight > 0,
  ``sum(ce * w) / max(sum(w), 1)``.
- :func:`eval_step` runs an EEGNet's block 1 of every fold in one launch
  of the stacked K1 kernel (``ops/fused_eegnet.py::block1_stacked``); a
  baseline runs its plain stacked eval forward, as the JAX package has no
  fused eval for it.
- *Data parallelism.*  Given ``data_group`` (this rank's line along the
  mesh's data axis, ``parallel/mesh.py::AxisGroup``) each rank holds its
  contiguous part of every batch, and the steps compute the whole batch's
  result, as the JAX steps do under ``shard_map`` with ``data_axis``: the
  loss is the local weighted sum over the *group's* weight sum, the model
  syncs its BatchNorm statistics over the group (when its
  ``bn_axis_name`` is ``"data"``), one ``all_reduce`` sums the flat
  gradient and the loss, a fold steps when the group's batch holds a real
  sample, and eval sums its loss and correct count over the group.  The
  dropout generator is the caller's: one stream for each data rank
  (``training/loop.py::dropout_seed``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn

from eegnetreplication_tpu_torch.models.eegnet import MAXNORM_LIMITS, EEGNet
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    fused_eval_forward_stacked,
)

ADAM_B1 = 0.9
ADAM_B2 = 0.999
MAXNORM_MODES = ("reference", "paper")


@dataclass(frozen=True)
class FlatLayout:
    """Where each named tensor sits in a flat ``(G, N)`` vector."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Name -> ``(G, *shape)`` view of ``flat``."""
        out, at = {}, 0
        for name, shape in zip(self.names, self.shapes):
            n = _numel(shape)
            out[name] = flat[:, at:at + n].reshape(flat.shape[0], *shape)
            at += n
        return out

    def flatten(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Stacked ``(G, *shape)`` tensors -> one contiguous ``(G, N)``."""
        parts = [tensors[name].reshape(tensors[name].shape[0], -1)
                 for name in self.names]
        return torch.cat(parts, dim=1).contiguous()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclass(frozen=True)
class StateLayout:
    """The parameter and running-statistics layouts of one model
    geometry, in ``state_dict`` names and order."""

    params: FlatLayout
    stats: FlatLayout

    @classmethod
    def of(cls, model: nn.Module) -> "StateLayout":
        named = list(model.named_parameters())
        stats = [(k, v) for k, v in model.named_buffers()
                 if not k.endswith("num_batches_tracked")]
        return cls(
            FlatLayout(tuple(k for k, _ in named),
                       tuple(tuple(v.shape) for _, v in named)),
            FlatLayout(tuple(k for k, _ in stats),
                       tuple(tuple(v.shape) for _, v in stats)))


@dataclass
class TrainState:
    """G folds' training state: parameters, BatchNorm statistics and Adam's
    moments as flat ``(G, N)`` tensors, and Adam's step count per fold."""

    layout: StateLayout
    params: torch.Tensor    # (G, P)
    stats: torch.Tensor     # (G, Q)
    mu: torch.Tensor        # (G, P) first moment
    nu: torch.Tensor        # (G, P) second moment
    count: torch.Tensor     # (G,) int32 Adam steps taken

    @classmethod
    def create(cls, layout: StateLayout,
               stacked: Mapping[str, torch.Tensor]) -> "TrainState":
        """A fresh state (zero moments, count 0) from a stacked
        ``state_dict`` (every tensor with a leading G axis)."""
        params = layout.params.flatten(stacked).to(torch.float32)
        stats = layout.stats.flatten(stacked).to(torch.float32)
        return cls(layout, params, stats, torch.zeros_like(params),
                   torch.zeros_like(params),
                   torch.zeros(params.shape[0], dtype=torch.int32,
                               device=params.device))

    @property
    def n_folds(self) -> int:
        return self.params.shape[0]

    def param_views(self) -> dict[str, torch.Tensor]:
        return self.layout.params.views(self.params)

    def stat_views(self) -> dict[str, torch.Tensor]:
        return self.layout.stats.views(self.stats)

    def stacked_state_dict(self) -> dict[str, torch.Tensor]:
        """The ``state_dict`` with a leading G axis (``num_batches_tracked``
        0, as the JAX package's weights carry no such counter)."""
        sd = {**self.param_views(), **self.stat_views()}
        for name in list(self.layout.stats.names):
            if name.endswith("running_mean"):
                prefix = name[: -len("running_mean")]
                sd[prefix + "num_batches_tracked"] = torch.zeros(
                    self.n_folds, dtype=torch.int64, device=self.params.device)
        return sd

    def state_dict(self, fold: int) -> dict[str, torch.Tensor]:
        """One fold's ``state_dict``, contiguous CPU copies."""
        return {k: v[fold].detach().cpu().contiguous()
                for k, v in self.stacked_state_dict().items()}

    def select(self, keep_new: torch.Tensor, old: "TrainState"
               ) -> "TrainState":
        """Fold ``g`` from ``self`` where ``keep_new[g]``, else from
        ``old``."""
        k = keep_new[:, None]
        return TrainState(
            self.layout, torch.where(k, self.params, old.params),
            torch.where(k, self.stats, old.stats),
            torch.where(k, self.mu, old.mu), torch.where(k, self.nu, old.nu),
            torch.where(keep_new, self.count, old.count))

    def folds(self, lo: int, hi: int) -> "TrainState":
        """Folds ``lo`` to ``hi - 1`` (views)."""
        return TrainState(self.layout, self.params[lo:hi],
                          self.stats[lo:hi], self.mu[lo:hi], self.nu[lo:hi],
                          self.count[lo:hi])

    def to(self, device) -> "TrainState":
        return TrainState(self.layout, self.params.to(device),
                          self.stats.to(device), self.mu.to(device),
                          self.nu.to(device), self.count.to(device))


def clamp_reference_maxnorm(grads: Mapping[str, torch.Tensor],
                            limits: Mapping[str, float] = MAXNORM_LIMITS
                            ) -> dict[str, torch.Tensor]:
    """Quirk-Q1 "reference" mode: clamp the named weights' *gradients*
    elementwise to +-limit (the reference's ``register_hook`` fires on the
    gradient); biases and BatchNorm are untouched."""
    return {k: torch.clamp(g, -limits[k], limits[k]) if k in limits else g
            for k, g in grads.items()}


def project_paper_maxnorm(params: Mapping[str, torch.Tensor],
                          limits: Mapping[str, float] = MAXNORM_LIMITS
                          ) -> dict[str, torch.Tensor]:
    """True max-norm (Lawhern et al.): rescale each spatial filter's L2
    norm, and each classifier unit's incoming weights, to at most its
    limit.  The JAX package norms a flax HWIO kernel over all axes but the
    last and a Dense ``(in, out)`` kernel over axis 0; in torch's layouts
    that is a conv ``(out, in/g, kh, kw)`` over its last three dims and a
    Linear ``(out, in)`` over its last dim (a leading G axis is kept)."""
    out = dict(params)
    for name, limit in limits.items():
        w = params[name]
        dims = (-3, -2, -1) if name != "classifier.weight" else (-1,)
        norms = torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))
        scale = torch.clamp(limit / torch.clamp(norms, min=1e-12), max=1.0)
        out[name] = w * scale
    return out


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weights: torch.Tensor,
                           weight_sum: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Softmax cross-entropy averaged over the slots with weight > 0:
    ``(..., B, K)`` logits -> ``(...)``, ``sum(ce * w) / max(sum(w), 1)``
    (torch's ``CrossEntropyLoss()`` on the real samples of a padded
    batch).  ``weight_sum`` replaces the denominator's ``sum(w)``: the
    data group's sum, for a rank's part of a batch."""
    ce = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if weight_sum is None:
        weight_sum = torch.sum(weights, dim=-1)
    return torch.sum(ce * weights, dim=-1) / torch.clamp(weight_sum,
                                                         min=1.0)


def bn_group_of(model: nn.Module, data_group):
    """The group ``model``'s training BatchNorms sync over: the data
    group when the model names the data axis (``bn_axis_name``)."""
    if data_group is None or not data_group.active:
        return None
    if getattr(model, "bn_axis_name", None) != data_group.axis:
        raise ValueError(
            f"the mesh data axis is {data_group.size}-wide but the model "
            f"was built with bn_axis_name="
            f"{getattr(model, 'bn_axis_name', None)!r}; pass "
            f"bn_axis_name={data_group.axis!r} for synced BatchNorm under "
            "DP")
    return data_group


def adam_update(state: TrainState, grads: torch.Tensor, learning_rate: float,
                eps: float) -> TrainState:
    """One Adam step of every fold (optax ``adam(lr, b1, b2, eps)``)."""
    mu = ADAM_B1 * state.mu + (1.0 - ADAM_B1) * grads
    nu = ADAM_B2 * state.nu + (1.0 - ADAM_B2) * grads * grads
    count = state.count + 1
    t = count.to(torch.float32)[:, None]
    mu_hat = mu / (1.0 - torch.pow(ADAM_B1, t))
    nu_hat = nu / (1.0 - torch.pow(ADAM_B2, t))
    params = state.params - learning_rate * (mu_hat / (torch.sqrt(nu_hat)
                                                       + eps))
    return TrainState(state.layout, params, state.stats, mu, nu, count)


def train_step(model: nn.Module, state: TrainState, x: torch.Tensor,
               y: torch.Tensor, w: torch.Tensor, *, learning_rate: float,
               adam_eps: float, maxnorm_mode: str = "reference",
               generator: torch.Generator | None = None, data_group=None,
               optimizer_update=None
               ) -> tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One optimization step of every fold on its own padded batch.

    ``x`` ``(G, B, C, T)``, ``y`` ``(G, B)``, ``w`` ``(G, B)`` loss weights
    (0 marks a wrap-around padding slot).  ``model`` gives the geometry,
    the forward (its ``stacked``) and the training hyperparameters
    (``bn_mode``, ``dropout_rate``, momentum, eps, the conv schedule);
    dropout masks come from ``generator``.  Returns ``(new_state,
    loss, grad_norm)``, the last two ``(G,)``: each fold's batch loss and
    the global norm of its raw (pre-clamp) gradient.  A fold whose batch
    holds no real sample keeps its parameters, statistics, moments and step
    count, and reports 0 for both.  With ``data_group`` the batch is this
    rank's part and the step is the whole batch's (module docstring).
    ``optimizer_update(state, grads) -> state`` replaces the Adam update
    (the ZeRO step's sliced one, ``parallel/dp.py``).  Nothing here waits
    for the device.
    """
    if maxnorm_mode not in MAXNORM_MODES:
        raise ValueError(f"maxnorm_mode must be 'reference' or 'paper'; "
                         f"got {maxnorm_mode!r}")
    layout = state.layout
    bn_group = bn_group_of(model, data_group)
    w_sum = torch.sum(w, dim=1)
    if bn_group is not None:
        w_sum = data_group.sum(w_sum)
    params = state.params.detach().requires_grad_(True)
    with torch.enable_grad():
        logits, new_stats = model.stacked(
            layout.params.views(params), state.stat_views(), x, train=True,
            sample_weights=w, generator=generator, bn_group=bn_group)
        loss = weighted_cross_entropy(logits, y, w, w_sum)
        (grads,) = torch.autograd.grad(loss.sum(), params)
    with torch.no_grad():
        if bn_group is not None:
            # The loss is normalized by the group's weight sum, so the sums
            # of the ranks' gradients and losses are the whole batch's:
            # one all_reduce of the flat gradient with the loss beside it.
            summed = data_group.sum(torch.cat([grads, loss[:, None]], 1))
            grads, loss = summed[:, :-1], summed[:, -1]
        grad_norm = torch.sqrt(torch.sum(grads * grads, dim=1))
        if maxnorm_mode == "reference":
            grads = layout.params.flatten(clamp_reference_maxnorm(
                layout.params.views(grads), model.MAXNORM_LIMITS))
        if optimizer_update is None:
            new = adam_update(state, grads, learning_rate, adam_eps)
        else:
            new = optimizer_update(state, grads)
        if maxnorm_mode == "paper":
            new.params = layout.params.flatten(project_paper_maxnorm(
                new.param_views(), model.MAXNORM_LIMITS))
        new.stats = layout.stats.flatten(new_stats)
        has_real = w_sum > 0
        zero = torch.zeros_like(loss)
        return (new.select(has_real, state),
                torch.where(has_real, loss.detach(), zero),
                torch.where(has_real, grad_norm, zero))


def supports_fused_eval(model: nn.Module) -> bool:
    """Whether ``model``'s eval forward has the fused block 1 (K1): EEGNet
    only, as in the JAX package."""
    return isinstance(model, EEGNet)


def eval_forward(model: nn.Module, state: TrainState, x: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits ``(G, B, n_classes)`` of every fold on its batch of
    ``x`` ``(G, B, C, T)``: an EEGNet's block 1 in one stacked K1 launch
    (``idx`` is :func:`~eegnetreplication_tpu_torch.ops.fused_eegnet.
    fold_index`), any other model's plain stacked eval forward."""
    if not supports_fused_eval(model):
        return model.stacked(state.param_views(), state.stat_views(), x,
                             train=False)[0]
    return fused_eval_forward_stacked(state.param_views(), state.stat_views(),
                                      x, idx, model.bn_epsilon,
                                      conv_impl=model.conv_impl)


def eval_step(model: nn.Module, state: TrainState, x: torch.Tensor,
              y: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
              data_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode ``(loss, weighted correct count)`` per fold, ``(G,)``
    each; the prediction is the first maximum of the logits.  With
    ``data_group`` the batch is this rank's part and both are the whole
    batch's, summed over the group (one ``all_reduce``)."""
    logits = eval_forward(model, state, x, idx)
    active = data_group is not None and data_group.active
    w_sum = torch.sum(w, dim=-1)
    if active:
        w_sum = data_group.sum(w_sum)
    loss = weighted_cross_entropy(logits, y, w, w_sum)
    correct = torch.sum((torch.argmax(logits, dim=-1) == y) * w, dim=-1)
    if active:
        loss, correct = data_group.sum(torch.stack([loss, correct]))
    return loss, correct
