"""Orbax checkpoint directories, read and written without JAX.

The counterpart of ``eegnetreplication_tpu/training/orbax_io.py``.  The JAX
package writes a model through Orbax's ``StandardCheckpointer``: one
directory holding ``_METADATA`` (the tree's keys), ``_CHECKPOINT_METADATA``,
one zarr v2 array per leaf, and the ``metadata.json`` twin of the ``.npz``
record, written after the directory's commit.  The card's machine has no
Orbax, tensorstore or zstd module, so the port reads and writes that
layout itself:

- **Reading** takes both of Orbax's layouts: the arrays inside an OCDBT
  key-value store (Orbax's default, read by ``training/ocdbt.py``) or as
  plain files (``use_ocdbt: false``).  A zarr v2 array is read over any
  chunk grid, with its ``fill_value`` where a chunk is absent, in order
  ``C``, compressor ``zstd`` (``utils/zstd.py``) or none; any other
  compressor, a filter, or zarr v3 raises.  The tree is rebuilt from
  ``_METADATA``'s keys (a leaf ``('params', 'classifier', 'kernel')`` is
  the array ``params.classifier.kernel``) and carried into the port's
  ``state_dict`` by ``checkpoint.from_jax_variables``.
- **Writing** produces Orbax's ``use_ocdbt: false`` layout, which every
  Orbax reader takes: ``_METADATA`` and ``_CHECKPOINT_METADATA`` as Orbax
  writes them, and per leaf a ``.zarray`` and one chunk compressed as a
  zstd frame of raw blocks.  The directory is written beside ``path``
  under a temporary name and renamed into place (an existing checkpoint
  there is replaced, as Orbax's ``force=True``); ``metadata.json`` is
  written after the rename, so its absence marks a save that died in
  between and loading raises.
- A resumable save adds the Adam state as optax's positional leaves
  (``opt/0`` the step count, then the first moments, then the second, in
  the flax parameter tree's order) and ``step`` as an int64 scalar, so
  the JAX ``load_orbax_train_state(path, optax.adam(...))`` restores it.
  The port's form of that state, ``opt_state``, is ``{"count": int,
  "mu": {name: tensor}, "nu": {name: tensor}}`` over the ``state_dict``'s
  parameter names: one fold of ``training/steps.py::TrainState``.
- Background saves keep the JAX module's contract: the arrays are copied
  to the host before the call returns, at most :data:`MAX_ASYNC_PENDING`
  saves are in flight (a slot is reserved under the lock; the oldest
  save is drained first when none is free), a failed entry stays pending
  and its error is raised in aggregate, and :func:`wait_for_async_saves`
  is a drain hook of ``resil/preempt.py``, so a SIGTERM commits pending
  saves before ``run_end``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training.ocdbt import OcdbtStore
from eegnetreplication_tpu_torch.utils import zstd

_METADATA_FILE = "metadata.json"
_TREE_FILE = "_METADATA"
_CHECKPOINT_FILE = "_CHECKPOINT_METADATA"
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_ZSTD = {"id": "zstd", "level": 1}
# The dtypes the JAX package's checkpoints hold (f32 weights and moments,
# int32 Adam counts, int64 steps) and their plain kin.
_DTYPES = {"<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1", "<u2",
           "<u4", "<u8", "|b1"}

# (writer, committed path, metadata) per in-flight background save; the
# metadata twin is written only after the directory commit.  Guarded by
# _ASYNC_LOCK, as in the JAX module.
_ASYNC_PENDING: list[tuple[Any, Path, dict]] = []
_ASYNC_LOCK = threading.Lock()
_ASYNC_COND = threading.Condition(_ASYNC_LOCK)
# Slots claimed by saves still being issued (their host copy is taken
# outside the lock).
_ASYNC_RESERVED = 0
# Hard bound on in-flight background saves: a caller outrunning the disk
# drains the OLDEST entry before a new one is admitted.
MAX_ASYNC_PENDING = 4
_TMP_IDS = itertools.count()


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------

class _FileStore:
    """The keys of Orbax's ``use_ocdbt: false`` layout: plain files."""

    def __init__(self, root: Path):
        self.root = root

    def read(self, key: str) -> bytes:
        try:
            return (self.root / key).read_bytes()
        except FileNotFoundError:
            raise KeyError(key) from None


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise ValueError(f"zarr fill_value {value!r} is not readable")
        return named[value]
    return value


def _read_zarr(store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise ValueError(f"array {name}: no {name}/.zarray (is this a zarr "
                         "v3 checkpoint?)") from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"array {name}: zarr_format "
                         f"{meta.get('zarr_format')} (only 2 is read)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"array {name}: order {meta['order']!r} (only C)")
    if meta.get("filters"):
        raise ValueError(f"array {name}: filters {meta['filters']} are not "
                         "read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"array {name}: compressor {comp.get('id')!r} "
                         "(zstd or none are read)")
    if meta["dtype"] not in _DTYPES:
        raise ValueError(f"array {name}: dtype {meta['dtype']!r} is not one "
                         "this reader takes")
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"array {name}: chunks {list(chunks)} do not fit "
                         f"shape {list(shape)}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value")), dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in itertools.product(*(range(g) for g in grid)):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        try:
            raw = store.read(key)
        except KeyError:
            continue
        if comp is not None:
            raw = zstd.decompress(raw)
        if len(raw) != chunk_bytes:
            raise ValueError(f"array {name}: chunk {key} holds {len(raw)} "
                             f"bytes, {chunk_bytes} expected")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def read_tree(path: str | Path) -> dict:
    """The nested dict of numpy arrays an Orbax ``StandardCheckpointer``
    directory holds, under its ``_METADATA`` keys."""
    path = Path(path)
    meta = json.loads((path / _TREE_FILE).read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays are not read")
    ocdbt = meta.get("use_ocdbt", (path / "manifest.ocdbt").exists())
    store = OcdbtStore(path) if ocdbt else _FileStore(path)
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        if any(k in ("", ".", "..") or "/" in k for k in keys):
            raise ValueError(f"{path}: leaf key {keys} is not an array name")
        kind = entry.get("value_metadata", {}).get("value_type")
        if kind not in ("jax.Array", "np.ndarray"):
            raise ValueError(f"{path}: leaf {keys} has value type {kind!r}; "
                             "only arrays are read")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _read_zarr(store, ".".join(keys))
    return tree


def _restore(path: Path) -> tuple[dict, dict]:
    """``(tree, metadata)``: ``metadata.json`` is checked first, before any
    array is read, as in the JAX module."""
    meta_file = path / _METADATA_FILE
    if not meta_file.exists():
        raise FileNotFoundError(
            f"{path} has no {_METADATA_FILE}: the save was interrupted "
            "after the state commit (or this is not an "
            "eegnetreplication_tpu checkpoint). Re-save it, or for an "
            "async save call wait_for_async_saves() first.")
    metadata = json.loads(meta_file.read_text())
    return read_tree(path), metadata


def load_orbax_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """Load an Orbax checkpoint directory as ``(state_dict, metadata)``."""
    tree, metadata = _restore(Path(path).absolute())
    return (ckpt_lib.from_jax_variables(tree["params"], tree["batch_stats"]),
            metadata)


def _leaf_paths(tree: Mapping) -> list[tuple[str, ...]]:
    """A nested dict's leaf paths in ``jax.tree_util.tree_leaves`` order
    (sorted keys at every level)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            out += [(key,) + sub for sub in _leaf_paths(value)]
        else:
            out.append((key,))
    return out


def _get(tree: Mapping, keys: tuple[str, ...]):
    for k in keys:
        tree = tree[k]
    return tree


def _put(tree: dict, keys: tuple[str, ...], value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _moments_state_dict(moments: Mapping, batch_stats: Mapping) -> dict:
    """Moments in flax names and layouts -> ``{state_dict name: tensor}``
    over the parameters (the layouts convert as the parameters do)."""
    sd = ckpt_lib.from_jax_variables(moments, batch_stats)
    return {k: v for k, v in sd.items() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}


def load_orbax_train_state(path: str | Path
                           ) -> tuple[dict, dict, int, dict]:
    """Restore a resumable save as ``(state_dict, opt_state, step,
    metadata)``; the twin of the JAX ``load_orbax_train_state`` (whose
    ``tx.init(params)`` structure is optax's Adam: the count, then the
    moments in the parameter tree's order)."""
    tree, metadata = _restore(Path(path).absolute())
    if "opt" not in tree:
        raise ValueError(
            f"{path} is not resumable: saved without opt_state")
    params, batch_stats = tree["params"], tree["batch_stats"]
    order = _leaf_paths(params)
    opt = tree["opt"]
    if len(opt) != 1 + 2 * len(order):
        raise ValueError(
            f"{path}: {len(opt)} optimizer leaves, Adam over "
            f"{len(order)} parameters has {1 + 2 * len(order)}")
    mu: dict = {}
    nu: dict = {}
    for i, keys in enumerate(order):
        _put(mu, keys, opt[str(1 + i)])
        _put(nu, keys, opt[str(1 + len(order) + i)])
    opt_state = {"count": int(opt["0"]),
                 "mu": _moments_state_dict(mu, batch_stats),
                 "nu": _moments_state_dict(nu, batch_stats)}
    step = int(tree.get("step", 0))
    return (ckpt_lib.from_jax_variables(params, batch_stats), opt_state,
            step, metadata)


# --------------------------------------------------------------------------
# Writing
# --------------------------------------------------------------------------

def _state_leaves(state_dict: Mapping, opt_state: Mapping | None,
                  step: int | None) -> dict[tuple[str, ...], np.ndarray]:
    """The checkpoint's leaves as host arrays (copies) by key path: the
    JAX module's ``_state_dict``."""
    params, batch_stats = ckpt_lib.to_jax_variables(state_dict)
    leaves: dict[tuple[str, ...], np.ndarray] = {}
    for name, tree in (("params", params), ("batch_stats", batch_stats)):
        for keys in _leaf_paths(tree):
            leaves[(name,) + keys] = np.array(_get(tree, keys), copy=True)
    if opt_state is not None:
        moments = []
        for part in ("mu", "nu"):
            sd = dict(state_dict)
            sd.update(opt_state[part])
            flax_moments, _ = ckpt_lib.to_jax_variables(sd)
            moments += [_get(flax_moments, keys)
                        for keys in _leaf_paths(params)]
        opt = [np.asarray(int(opt_state["count"]), np.int32)] + moments
        for i, leaf in enumerate(opt):
            leaves[("opt", str(i))] = np.array(leaf, copy=True)
    if step is not None:
        leaves[("step",)] = np.asarray(step, np.int64)
    return leaves


def _zarray(arr: np.ndarray) -> bytes:
    meta = {"chunks": [max(1, d) for d in arr.shape], "compressor": _ZSTD,
            "dimension_separator": ".", "dtype": arr.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":")).encode()


def _write_dir(path: Path, leaves: dict[tuple[str, ...], np.ndarray]
               ) -> None:
    """Write the checkpoint directory under a temporary name beside
    ``path``, then rename it into place."""
    t0 = time.time_ns()
    tmp = path.with_name(f".{path.name}.orbax-tmp-{os.getpid()}-"
                         f"{next(_TMP_IDS)}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        tree_meta = {}
        for keys in sorted(leaves):
            arr = leaves[keys]
            name = ".".join(keys)
            (tmp / name).mkdir()
            (tmp / name / ".zarray").write_bytes(_zarray(arr))
            if arr.size:
                chunk = ".".join("0" * arr.ndim) if arr.ndim else "0"
                (tmp / name / chunk).write_bytes(
                    zstd.compress(arr.tobytes(order="C")))
            tree_meta[str(keys)] = {
                "key_metadata": [{"key": k, "key_type": 2} for k in keys],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
        (tmp / _TREE_FILE).write_text(json.dumps({
            "tree_metadata": tree_meta, "use_ocdbt": False,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}))
        (tmp / _CHECKPOINT_FILE).write_text(json.dumps({
            "item_handlers": _HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": t0,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if path.exists():
            old = tmp.with_name(tmp.name + "-old")
            path.replace(old)
            tmp.replace(path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            tmp.replace(path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


class _BackgroundWrite:
    """One background directory write: a thread, and its error."""

    def __init__(self, path: Path, leaves: dict):
        self.error: BaseException | None = None
        self.thread = threading.Thread(
            target=self._run, args=(path, leaves),
            name=f"orbax-save-{path.name}")
        self.thread.start()

    def _run(self, path: Path, leaves: dict) -> None:
        try:
            _write_dir(path, leaves)
        except BaseException as exc:  # noqa: BLE001 — raised by wait()
            self.error = exc

    def wait(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise self.error


def _pending_count() -> int:
    with _ASYNC_LOCK:
        return len(_ASYNC_PENDING)


def _commit_entry(writer: _BackgroundWrite | None, path: Path,
                  metadata: dict) -> None:
    """Wait out one background save and write its metadata twin.  On
    failure the entry's remaining work rides on the exception as
    ``pending_entry``: a failed write keeps its writer (no metadata twin
    is forged over a missing commit), a failed metadata write retries
    only the metadata."""
    if writer is not None:
        try:
            writer.wait()
        except Exception as exc:
            exc.pending_entry = (writer, path, metadata)
            raise
    try:
        (path / _METADATA_FILE).write_text(json.dumps(metadata))
    except Exception as exc:
        exc.pending_entry = (None, path, metadata)
        raise


def wait_for_async_saves() -> None:
    """Block until every ``background=True`` save has committed, oldest
    first, writing each one's ``metadata.json``.  Every entry is attempted
    even when one fails; failed entries stay pending and their errors are
    raised together."""
    failures: list[tuple[tuple, Exception]] = []
    while True:
        with _ASYNC_COND:
            if not _ASYNC_PENDING:
                if _ASYNC_RESERVED:
                    _ASYNC_COND.wait(timeout=0.1)
                    continue
                break
            writer, path, metadata = _ASYNC_PENDING.pop(0)
        try:
            _commit_entry(writer, path, metadata)
        except Exception as exc:  # noqa: BLE001 — aggregate, keep going
            failures.append((getattr(exc, "pending_entry",
                                     (None, path, metadata)), exc))
    if failures:
        with _ASYNC_LOCK:
            _ASYNC_PENDING.extend(entry for entry, _ in failures)
        raise RuntimeError(
            "async checkpoint save(s) failed (still pending for retry): "
            + "; ".join(f"{e[1]}: {type(exc).__name__}: {exc}"
                        for e, exc in failures))


def save_orbax_checkpoint(path: str | Path, state_dict: Mapping,
                          metadata: dict | None = None, *,
                          opt_state: Mapping | None = None,
                          step: int | None = None,
                          background: bool = False) -> Path:
    """Write an Orbax checkpoint directory of a model's ``state_dict``;
    the API twin of ``checkpoint.save_checkpoint``.

    ``background=True`` returns once the arrays are on the host; call
    :func:`wait_for_async_saves` before exiting or reading it back.
    """
    global _ASYNC_RESERVED
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    if not background:
        _write_dir(path, _state_leaves(state_dict, opt_state, step))
        (path / _METADATA_FILE).write_text(json.dumps(metadata or {}))
        return path
    while True:
        with _ASYNC_COND:
            if len(_ASYNC_PENDING) + _ASYNC_RESERVED < MAX_ASYNC_PENDING:
                _ASYNC_RESERVED += 1
                break
            if not _ASYNC_PENDING:
                _ASYNC_COND.wait(timeout=0.1)
                continue
            old = _ASYNC_PENDING.pop(0)
        try:
            _commit_entry(*old)
        except Exception as exc:  # noqa: BLE001 — re-pend and surface
            with _ASYNC_COND:
                _ASYNC_PENDING.insert(0, getattr(
                    exc, "pending_entry", (None, old[1], old[2])))
                _ASYNC_COND.notify_all()
            raise
    try:
        writer = _BackgroundWrite(
            path, _state_leaves(state_dict, opt_state, step))
    except BaseException:
        with _ASYNC_COND:
            _ASYNC_RESERVED -= 1
            _ASYNC_COND.notify_all()
        raise
    with _ASYNC_COND:
        _ASYNC_RESERVED -= 1
        _ASYNC_PENDING.append((writer, path, dict(metadata or {})))
        _ASYNC_COND.notify_all()
    from eegnetreplication_tpu_torch.resil import preempt

    preempt.add_drain_hook(wait_for_async_saves)
    return path
