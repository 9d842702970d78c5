"""Within-fold data parallelism: the train and eval steps over a mesh's
data axis, with the Adam moments optionally partitioned over its model
axis.

The counterpart of ``eegnetreplication_tpu/parallel/dp.py``.  There one
``shard_map`` program runs on every device; here every rank of the mesh
calls the step with the same *global* batch ``x (G, B, C, T)`` and keeps
its contiguous part of ``B`` (the JAX ``P("data")`` in-spec).  Then, as
the JAX step does:

- the loss is the local weighted sum over the *global* weight sum, and
  BatchNorm statistics are the whole batch's (the model must be built
  with ``bn_axis_name="data"``, as the JAX model with ``bn_axis_name``):
  the step equals the same global batch on one process;
- one ``all_reduce`` over ``data`` sums the flat gradient with the loss
  beside it (``training/steps.py::train_step`` with a data group);
- max-norm is applied as in the single step;
- with a :class:`~eegnetreplication_tpu_torch.parallel.shardspec.
  StateShardSpec` over a model axis wider than 1, each model rank keeps
  only its slices of Adam's two moments (ZeRO: pre-cut them with
  :func:`~eegnetreplication_tpu_torch.parallel.shardspec.shard_state`),
  updates only its slices of the parameters, and one ``all_gather`` over
  ``model`` rebuilds the update.  The arithmetic is elementwise and the
  same, so the sharded step is bitwise the replicated one.

The dropout generator is the caller's, one per data rank (the JAX step's
``fold_in(rng, axis_index("data"))``).
"""

from __future__ import annotations

import torch

from eegnetreplication_tpu_torch.ops.fused_eegnet import fold_index
from eegnetreplication_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    local_batch,
)
from eegnetreplication_tpu_torch.training import steps as steps_lib
from eegnetreplication_tpu_torch.training.steps import (
    ADAM_B1,
    ADAM_B2,
    TrainState,
)


def _check_model(model, data_axis: str) -> None:
    if getattr(model, "bn_axis_name", None) != data_axis:
        raise ValueError(
            f"model.bn_axis_name={getattr(model, 'bn_axis_name', None)!r} "
            f"must equal the mesh data axis {data_axis!r} for synced "
            "BatchNorm under DP")


def zero_adam_update(spec, model_group, learning_rate: float, eps: float):
    """The ZeRO optimizer update for ``train_step``: Adam on this model
    rank's slices of the gradient, the moments and the parameters, then
    one ``all_gather`` of the update slices over ``model_group``."""
    def update(state: TrainState, grads: torch.Tensor) -> TrainState:
        g = spec.slice_flat(grads, model_group.index)
        mu = ADAM_B1 * state.mu + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * state.nu + (1.0 - ADAM_B2) * g * g
        count = state.count + 1
        t = count.to(torch.float32)[:, None]
        mu_hat = mu / (1.0 - torch.pow(ADAM_B1, t))
        nu_hat = nu / (1.0 - torch.pow(ADAM_B2, t))
        step = learning_rate * (mu_hat / (torch.sqrt(nu_hat) + eps))
        full = spec.join_flat(model_group.all_gather(step))
        return TrainState(state.layout, state.params - full, state.stats,
                          mu, nu, count)

    return update


def make_dp_train_step(model, mesh: Mesh, *, learning_rate: float,
                       adam_eps: float, maxnorm_mode: str = "reference",
                       data_axis: str = DATA_AXIS, spec=None):
    """A data-parallel train step over ``mesh``'s data axis.

    Returns ``step(state, x, y, w, generator=None) -> (state, loss)``:
    ``x`` ``(G, B, C, T)``, ``y`` and ``w`` ``(G, B)`` are the global
    batch (every rank passes the same), ``state`` is replicated, or with a
    sharded ``spec`` carries this rank's moment slices
    (:func:`~eegnetreplication_tpu_torch.parallel.shardspec.shard_state`)
    and returns them so.  The loss is the global batch's, ``(G,)``.
    """
    _check_model(model, data_axis)
    n_model = spec.n_model if spec is not None else 1
    model_axis = spec.model_axis if spec is not None else None
    if n_model > 1 and mesh.axis_size(model_axis) != n_model:
        raise ValueError(
            f"spec was built for a {n_model}-wide {model_axis!r} axis but "
            f"the mesh carries {dict(mesh.shape)}")
    data = mesh.group(data_axis)
    update = (zero_adam_update(spec, mesh.group(model_axis), learning_rate,
                               adam_eps) if n_model > 1 else None)

    def step(state: TrainState, x, y, w, generator=None):
        new, loss, _ = steps_lib.train_step(
            model, state, local_batch(x, data), local_batch(y, data),
            local_batch(w, data), learning_rate=learning_rate,
            adam_eps=adam_eps, maxnorm_mode=maxnorm_mode,
            generator=generator, data_group=data, optimizer_update=update)
        return new, loss

    return step


def make_dp_eval_step(model, mesh: Mesh, *, data_axis: str = DATA_AXIS):
    """Batch-sharded eval: ``eval(state, x, y, w) -> (loss_sum,
    n_correct)``, each ``(G,)`` and summed over the data axis (the JAX
    step's ``psum`` of the local sums)."""
    data = mesh.group(data_axis)

    def evaluate(state: TrainState, x, y, w):
        x, y, w = (local_batch(t, data) for t in (x, y, w))
        idx = fold_index(x.shape[0], x.shape[1], x.device)
        with torch.no_grad():
            logits = steps_lib.eval_forward(model, state, x, idx)
            ce = torch.logsumexp(logits, dim=-1) - torch.gather(
                logits, -1, y.long().unsqueeze(-1)).squeeze(-1)
            loss_sum = torch.sum(ce * w, dim=-1)
            correct = torch.sum((torch.argmax(logits, dim=-1) == y) * w,
                                dim=-1)
            loss_sum, correct = data.sum(torch.stack([loss_sum, correct]))
        return loss_sum, correct

    return evaluate
