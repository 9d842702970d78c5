"""The named (fold, data, model) mesh over rank processes.

The counterpart of ``eegnetreplication_tpu/parallel/mesh.py``.  The JAX
package runs one process that sees every device and lays a
``jax.sharding.Mesh`` over them; ``shard_map`` then runs one program per
device and ``psum``/``all_gather`` cross the named axes.  The port runs
**one process per mesh position** (a *rank*), started by
:mod:`~eegnetreplication_tpu_torch.parallel.launch`, and a collective over
an axis is a ``torch.distributed`` call that every rank of that axis's
line makes, in the same order.

Axis convention (the JAX package's, in its order):

- ``"fold"``: independent training runs (folds, permutation runs).  No
  collective crosses it, so it has no process group.
- ``"data"``: batch shards within one run: gradients, the loss and the
  BatchNorm statistics are summed over it every step.
- ``"model"``: state shards within one run: Adam's moments live
  partitioned over it (ZeRO), and one ``all_gather`` a step rebuilds the
  parameter update.  It is the minor axis.

Rank ``r`` sits at ``(fold, data, model) = unravel(r, shape)``, row-major
as the JAX mesh's device array, so the ranks of a data or model line are
neighbours.

**Ranks on one card.**  Every rank runs on ``cuda:{local_rank %
device_count}`` (``utils/device.py::rank_device``): on a machine with one
H100 all ranks share ``cuda:0``.  NCCL refuses two ranks on one device,
so the collectives go over **gloo** (``init_process_group("gloo", ...)``
with an explicit timeout).  Gloo takes CUDA tensors for the collectives
the port uses and stages them through host memory itself; the tensors on
either side stay where the caller has them.  ``torch.distributed``'s
``init_device_mesh`` is not used: it picks NCCL for CUDA.

:class:`Mesh` is the port's own small object: the named shape, this
rank's coordinate on each axis, and one gloo group (:class:`AxisGroup`)
per line along ``data`` and along ``model``.  ``dist.new_group`` must be
called by every rank for every group in the same order, so
:func:`make_mesh` builds every line's group in every rank and keeps its
own.  Without an initialized process group the world is this process
alone, and a 1 x 1 x 1 mesh needs no ``torch.distributed`` at all.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist

FOLD_AXIS = "fold"
DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (FOLD_AXIS, DATA_AXIS, MODEL_AXIS)

# A rank blocked in a collective is freed after this long (seconds), so a
# rank that dies or hangs cannot block the others for good.
DEFAULT_TIMEOUT_S = 300.0
TIMEOUT_ENV = "EEGTPU_MESH_TIMEOUT_S"


def collective_timeout_s() -> float:
    """The gloo timeout: ``EEGTPU_MESH_TIMEOUT_S`` or
    :data:`DEFAULT_TIMEOUT_S`."""
    return float(os.environ.get(TIMEOUT_ENV) or DEFAULT_TIMEOUT_S)


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is the ``all_reduce(SUM)`` of
    the gradient (the transpose of ``psum`` under ``shard_map``): a plain
    ``dist.all_reduce`` would give the right sums and silently wrong
    gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


@dataclass
class AxisGroup:
    """This rank's line along one mesh axis: its ``size``, this rank's
    ``index`` on it, the global ``ranks`` of the line in axis order and
    the gloo group over them (``None`` for a line of one rank, where
    every collective is the identity)."""

    axis: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: object = None

    @property
    def active(self) -> bool:
        return self.size > 1

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the line (a new tensor; no gradient)."""
        if not self.active:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def sum_differentiable(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the line, differentiable: its backward
        sums the gradient over the line."""
        if not self.active:
            return t
        return _SumOverGroup.apply(t, self.group)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (same shape on all), in axis order."""
        if not self.active:
            return [t]
        t = t.detach().contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src_index: int = 0) -> torch.Tensor:
        """``t`` of the line's rank ``src_index``, in place on the others."""
        if not self.active:
            return t
        dist.broadcast(t, src=self.ranks[src_index], group=self.group)
        return t


def local_batch(t: torch.Tensor, group: AxisGroup | None,
                dim: int = 1) -> torch.Tensor:
    """This data rank's contiguous part of the batch dimension ``dim``
    (the JAX loop's ``_shard_slice``); the whole of ``t`` without an
    active group."""
    if group is None or not group.active:
        return t
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.index * n, n)


def _solo(axis: str) -> AxisGroup:
    return AxisGroup(axis, 1, 0, (0,), None)


@dataclass
class Mesh:
    """A named ``(fold, data, model)`` mesh of rank processes.

    ``shape`` is ordered as :data:`AXES` (``dict(mesh.shape)`` reads as
    the JAX mesh's); ``rank`` is this process's global rank, ``coords``
    its position on each axis, ``ranks`` the mesh's global ranks in
    row-major order, and :meth:`group` its :class:`AxisGroup` along
    ``data`` or ``model``."""

    shape: dict[str, int]
    rank: int
    coords: dict[str, int]
    ranks: tuple[int, ...]
    groups: dict[str, AxisGroup] = field(default_factory=dict)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return AXES

    @property
    def size(self) -> int:
        return mesh_size(self)

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, axis: str) -> AxisGroup:
        """This rank's line along ``axis`` (``data`` or ``model``)."""
        if axis == FOLD_AXIS:
            raise ValueError("no collective crosses the fold axis; it has "
                             "no group")
        return self.groups[axis]

    @property
    def is_lead(self) -> bool:
        """Whether this rank is the mesh's first (the one that writes)."""
        return self.rank == self.ranks[0]


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the initialized process group, or
    ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _unravel(i: int, shape: Sequence[int]) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(i % n)
        i //= n
    return tuple(reversed(out))


def make_mesh(n_fold: int | None = None, n_data: int = 1,
              devices: Sequence[int] | None = None,
              n_model: int = 1) -> Mesh:
    """Build a named (fold, data, model) mesh over the world's ranks.

    ``devices`` are the global ranks the mesh covers (default: every rank
    of the world, in order).  With defaults every rank goes to the fold
    axis.  A shape whose product is not the number of ranks raises
    ``ValueError``, as the JAX ``make_mesh`` does for its devices.  Every
    rank of the world must make the same call: each line's gloo group is
    built in every rank, in the same order.
    """
    rank, world_size = world()
    devices = list(range(world_size) if devices is None else devices)
    n_dev = len(devices)
    if n_fold is None:
        n_fold = n_dev // (n_data * n_model)
    if n_fold * n_data * n_model != n_dev or min(n_fold, n_data,
                                                  n_model) < 1:
        raise ValueError(
            f"mesh shape ({n_fold} fold x {n_data} data x {n_model} model) "
            f"!= {n_dev} devices")
    if any(not 0 <= d < world_size for d in devices) or len(
            set(devices)) != n_dev:
        raise ValueError(f"mesh devices {devices} are not distinct ranks of "
                         f"a world of {world_size}")
    dims = (n_fold, n_data, n_model)
    shape = dict(zip(AXES, dims))
    at = devices.index(rank) if rank in devices else None
    coords = dict(zip(AXES, _unravel(at, dims))) if at is not None else {}
    mesh = Mesh(shape, rank, coords, tuple(devices))
    for ax_i, axis in ((1, DATA_AXIS), (2, MODEL_AXIS)):
        mesh.groups[axis] = _solo(axis)
        if dims[ax_i] == 1:
            continue
        # Every line along the axis, in the same order in every rank.
        lines: dict[tuple, list[int]] = {}
        for pos, dev in enumerate(devices):
            c = list(_unravel(pos, dims))
            c[ax_i] = 0
            lines.setdefault(tuple(c), []).append(dev)
        for line in lines.values():
            group = dist.new_group(
                ranks=line, backend="gloo",
                timeout=timedelta(seconds=collective_timeout_s()))
            if rank in line:
                mesh.groups[axis] = AxisGroup(axis, len(line),
                                              line.index(rank), tuple(line),
                                              group)
    return mesh


def make_hybrid_mesh(n_data_per_host: int = 1,
                     n_model_per_host: int = 1) -> Mesh:
    """Multi-host mesh: the fold axis spans the hosts, data and model stay
    within a host.  A "host" is a block of ``LOCAL_WORLD_SIZE``
    consecutive ranks (the launcher's ranks on one machine); the data x
    model lines must divide it, as the JAX package requires of a host's
    local devices."""
    _, world_size = world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or world_size)
    n_proc = max(1, world_size // max(local, 1))
    if n_proc == 1:
        return make_mesh(n_data=n_data_per_host, n_model=n_model_per_host)
    if local % (n_data_per_host * n_model_per_host):
        raise ValueError(
            f"mesh shape: data x model axes ({n_data_per_host} x "
            f"{n_model_per_host}) must divide the {local} local devices "
            "per host")
    # Ranks are host-major, so every data x model line lies in one host.
    return make_mesh(n_data=n_data_per_host, n_model=n_model_per_host)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Join the world: ``init_process_group("gloo")`` with an explicit
    timeout, the JAX signature kept for a caller that starts its own
    ranks.

    ``coordinator_address`` is ``host:port`` (a TCP store on the first
    rank) or ``file://<path>`` (a ``FileStore``); the arguments default to
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    """
    if dist.is_initialized():
        return
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("WORLD_SIZE", 1))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("RANK", 0))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                               f":{os.environ['MASTER_PORT']}")
    timeout = timedelta(seconds=collective_timeout_s())
    if coordinator_address.startswith("file://"):
        store = dist.FileStore(coordinator_address[len("file://"):],
                               num_processes)
        dist.init_process_group("gloo", store=store, rank=process_id,
                                world_size=num_processes, timeout=timeout)
    else:
        dist.init_process_group("gloo",
                                init_method=f"tcp://{coordinator_address}",
                                rank=process_id, world_size=num_processes,
                                timeout=timeout)


def mesh_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape.values())
