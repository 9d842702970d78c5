"""Which rank holds which part of a training state or a fold-stacked tree.

The counterpart of ``eegnetreplication_tpu/parallel/shardspec.py``.  There
a spec tree names a ``PartitionSpec`` per leaf and ``jax.device_put``
commits each leaf to its devices.  Here each rank is a process that
already holds whatever it computed, so placing is keeping: a rank keeps
its own block of a fold-stacked tree and its own slice of the optimizer
moments, and nothing is committed anywhere.

- :func:`state_shard_spec` maps every leaf of a ``TrainState`` to a spec
  over the mesh's ``model`` axis: parameters and BatchNorm statistics
  replicated (every data rank consumes them whole each step), each Adam
  moment leaf partitioned along one dimension (ZeRO; the step pays one
  ``all_gather`` of the update, ``parallel/dp.py``).  The port's state is
  flat ``(G, P)`` tensors (``training/steps.py``); the spec tree names the
  per-leaf views of them, under the ``state_dict`` names.
- The dimension is chosen by the JAX rule (:func:`model_leaf_spec`: the
  largest dimension divisible by ``n_model``, ties to the later one)
  applied to the leaf's *JAX layout*, then mapped through the port's
  layout permutation: the port's conv kernels are OIHW where flax's are
  HWIO and its classifier ``(out, in)`` where flax's Dense is ``(in,
  out)``, so the rule applied to the port's own shapes could pick another
  logical axis.
- :func:`fold_stacked_spec_tree`, :func:`fold_mapped_specs`: the fold
  axis's contract.  A rank slices every fold-major argument to its block
  of folds (:func:`fold_block`) and shares the rest; no collective
  crosses the fold axis.
- :func:`place_fold_stacked`, :func:`shard_state` and :func:`replicate`
  are the JAX package's placement calls: a rank keeps its fold block, its
  moment slices, and (every rank) the whole data pool.

A spec is a tuple in the ``PartitionSpec`` convention: an axis name or
``None`` per dimension, trailing ``None`` trimmed; ``()`` is replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

from eegnetreplication_tpu_torch.parallel.mesh import (
    FOLD_AXIS,
    MODEL_AXIS,
    Mesh,
)

Spec = tuple


def model_axis_size(mesh: Mesh | None, model_axis: str = MODEL_AXIS) -> int:
    """The mesh's model-axis width (1 for no mesh / no such axis)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(model_axis, 1))


def _trim(axes: list) -> Spec:
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def model_leaf_dim(shape, n_model: int, start: int = 0) -> int | None:
    """The JAX rule: the largest dimension of ``shape`` (from ``start``)
    divisible by ``n_model``, ties to the later one; ``None`` when none
    is, or under a singleton model axis."""
    best_dim, best_size = None, 0
    if n_model > 1:
        for dim in range(start, len(shape)):
            if shape[dim] % n_model == 0 and shape[dim] >= best_size:
                best_dim, best_size = dim, shape[dim]
    return best_dim


def model_leaf_spec(shape, n_model: int, *, model_axis: str = MODEL_AXIS,
                    leading_fold: bool = False) -> Spec:
    """The spec sharding a leaf of ``shape`` over the model axis when
    possible (:func:`model_leaf_dim`); ``leading_fold`` reserves dim 0 for
    the fold axis.  A scalar is replicated."""
    shape = tuple(shape)
    if leading_fold and not shape:
        return ()
    start = 1 if leading_fold else 0
    axes: list = [FOLD_AXIS] if leading_fold else []
    axes += [None] * (len(shape) - start)
    best = model_leaf_dim(shape, n_model, start)
    if best is not None:
        axes[best] = model_axis
    return _trim(axes)


def _kinds(names) -> dict[str, str]:
    """Parameter name -> ``"conv"``, ``"dense"`` or ``"bn"`` (the
    checkpoint converters' table of the three architectures)."""
    from eegnetreplication_tpu_torch.training.checkpoint import _layers

    prefixes = {n.rsplit(".", 1)[0] for n in names}
    by_prefix = {prefix: kind for _, prefix, kind in _layers(prefixes)}
    return {n: by_prefix[n.rsplit(".", 1)[0]] for n in names}


def jax_layout(name: str, shape, kind: str) -> tuple[tuple, tuple]:
    """``(flax shape, perm)`` of a port parameter: ``perm[i]`` is the flax
    dimension that port dimension ``i`` holds.  Conv weights are OIHW
    against flax's HWIO, the classifier ``(out, in)`` against Dense's
    ``(in, out)``; vectors are alike."""
    shape = tuple(shape)
    if kind == "conv" and name.endswith(".weight"):
        perm = (3, 2, 0, 1)
    elif kind == "dense" and name.endswith(".weight"):
        perm = (1, 0)
    else:
        perm = tuple(range(len(shape)))
    flax = [0] * len(shape)
    for i, j in enumerate(perm):
        flax[j] = shape[i]
    return tuple(flax), perm


@dataclass(frozen=True)
class StateShardSpec:
    """Spec trees for one ``TrainState`` under a mesh.

    ``state`` maps each field (``params``, ``stats``, ``mu``, ``nu``,
    ``count``) to ``{name: spec}`` in the port's layouts (parameters and
    statistics replicated, the moments on the model axis); ``update`` maps
    each parameter to the port dimension its gradient and update are
    sliced and gathered along (``None``: replicated), which is by
    construction the dimension its moments carry; ``jax_dims`` is the same
    choice in flax's layout, for comparison with the JAX package."""

    state: Mapping[str, Any]
    update: Mapping[str, int | None]
    jax_dims: Mapping[str, int | None]
    shapes: Mapping[str, tuple]
    n_model: int
    model_axis: str = MODEL_AXIS

    @property
    def sharded(self) -> bool:
        return self.n_model > 1

    def local_shape(self, name: str) -> tuple:
        shape = list(self.shapes[name])
        dim = self.update[name]
        if dim is not None and self.sharded:
            shape[dim] //= self.n_model
        return tuple(shape)

    def slice_flat(self, flat: torch.Tensor, index: int) -> torch.Tensor:
        """Model rank ``index``'s slices of a flat ``(G, P)`` parameter
        vector (parameters, gradients or moments), as one ``(G, P_local)``
        tensor in layout order."""
        parts, at = [], 0
        g = flat.shape[0]
        for name, shape in self.shapes.items():
            n = 1
            for d in shape:
                n *= d
            view = flat[:, at:at + n].reshape(g, *shape)
            at += n
            dim = self.update[name]
            if dim is not None and self.sharded:
                chunk = shape[dim] // self.n_model
                view = view.narrow(dim + 1, index * chunk, chunk)
            parts.append(view.reshape(g, -1))
        return torch.cat(parts, dim=1)

    def join_flat(self, blocks: list[torch.Tensor]) -> torch.Tensor:
        """The full ``(G, P)`` vector from every model rank's
        :meth:`slice_flat` block, in rank order (the tiled
        ``all_gather``)."""
        g = blocks[0].shape[0]
        parts, at = [], 0
        for name, shape in self.shapes.items():
            local = self.local_shape(name)
            n = 1
            for d in local:
                n *= d
            views = [b[:, at:at + n].reshape(g, *local) for b in blocks]
            at += n
            dim = self.update[name]
            if dim is None or not self.sharded:
                parts.append(views[0].reshape(g, -1))
            else:
                parts.append(torch.cat(views, dim=dim + 1).reshape(g, -1))
        return torch.cat(parts, dim=1)


def state_shard_spec(state, mesh: Mesh | None, *,
                     model_axis: str = MODEL_AXIS) -> StateShardSpec:
    """The per-leaf spec tree of a ``TrainState``: parameters and BatchNorm
    statistics replicated, each moment leaf on the model axis along the
    JAX rule's dimension (module docstring)."""
    n_model = model_axis_size(mesh, model_axis)
    layout = state.layout
    shapes = dict(zip(layout.params.names, layout.params.shapes))
    kinds = _kinds(shapes)
    update, jax_dims, moment = {}, {}, {}
    for name, shape in shapes.items():
        flax_shape, perm = jax_layout(name, shape, kinds[name])
        j = model_leaf_dim(flax_shape, n_model)
        jax_dims[name] = j
        update[name] = None if j is None else perm.index(j)
        axes: list = [None] * len(shape)
        if update[name] is not None:
            axes[update[name]] = model_axis
        moment[name] = _trim(axes)
    replicated = {name: () for name in shapes}
    tree = {"params": replicated,
            "stats": {name: () for name in layout.stats.names},
            "mu": moment, "nu": dict(moment), "count": ()}
    return StateShardSpec(tree, update, jax_dims, shapes, n_model,
                          model_axis)


def fold_stacked_spec_tree(tree: Mapping[str, Any], *, n_model: int = 1,
                           model_axis: str = MODEL_AXIS) -> dict:
    """Spec tree of a fold-stacked mapping: every leaf's leading dimension
    on the fold axis, the rest optionally over the model axis."""
    return {name: model_leaf_spec(tuple(leaf.shape), n_model,
                                  model_axis=model_axis, leading_fold=True)
            for name, leaf in tree.items()}


def fold_mapped_specs(mapped: tuple[bool, ...],
                      fold_axis: str = FOLD_AXIS) -> tuple[Spec, ...]:
    """Per positional argument of a fold-sharded runner: ``(fold,)`` for
    an argument a rank slices to its fold block, ``()`` for one every rank
    holds whole."""
    return tuple((fold_axis,) if m else () for m in mapped)


def padded_folds(n_folds: int, mesh: Mesh | None,
                 fold_axis: str = FOLD_AXIS) -> int:
    """``n_folds`` rounded up to a multiple of the fold axis (the padding
    repeats fold 0 and is dropped after training)."""
    n = 1 if mesh is None else mesh.axis_size(fold_axis)
    return n * -(-max(n_folds, 1) // n)


def fold_block(n_padded: int, mesh: Mesh | None,
               fold_axis: str = FOLD_AXIS) -> tuple[int, int]:
    """``(lo, hi)``: the folds ``lo..hi-1`` this rank trains out of
    ``n_padded`` (a multiple of the fold axis)."""
    if mesh is None:
        return 0, n_padded
    n = mesh.axis_size(fold_axis)
    if n_padded % n:
        raise ValueError(f"{n_padded} folds do not split evenly over a "
                         f"{n}-wide fold axis; pad them first")
    block = n_padded // n
    lo = mesh.axis_index(fold_axis) * block
    return lo, lo + block


def place_fold_stacked(tree, mesh: Mesh | None,
                       fold_axis: str = FOLD_AXIS):
    """This rank's fold block of a fold-stacked tree: a tensor, an object
    with ``folds(lo, hi)`` (``TrainState``, ``FoldSpec``), or a tuple,
    list or dict of them."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_fold_stacked(t, mesh, fold_axis)
                          for t in tree)
    if isinstance(tree, Mapping):
        return {k: place_fold_stacked(v, mesh, fold_axis)
                for k, v in tree.items()}
    n = tree.n_folds if hasattr(tree, "folds") else tree.shape[0]
    lo, hi = fold_block(n, mesh, fold_axis)
    return tree.folds(lo, hi) if hasattr(tree, "folds") else tree[lo:hi]


def replicate(tree, mesh: Mesh | None):
    """Every rank holds the whole tree (the shared data pool): as is."""
    del mesh
    return tree


def shard_state(state, mesh: Mesh | None,
                spec: StateShardSpec | None = None):
    """``state`` with its Adam moments cut to this rank's model slices
    (:meth:`StateShardSpec.slice_flat`): 1/``n_model`` of the moment
    elements per model rank when every leaf has a divisible dimension.
    Parameters, statistics and the step count stay whole."""
    from eegnetreplication_tpu_torch.training.steps import TrainState

    if spec is None:
        spec = state_shard_spec(state, mesh)
    if not spec.sharded:
        return state
    index = mesh.axis_index(spec.model_axis)
    return TrainState(state.layout, state.params, state.stats,
                      spec.slice_flat(state.mu, index).contiguous(),
                      spec.slice_flat(state.nu, index).contiguous(),
                      state.count)

