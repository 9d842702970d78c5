"""Checkpoints: the native ``.npz`` format and the reference's ``.pth``.

The counterpart of ``eegnetreplication_tpu/training/checkpoint.py``, on
files either package can read:

- The native ``.npz`` holds the flax-layout tree (``params/<layer>/...``,
  ``batch_stats/<layer>/...``, NHWC kernels), a JSON ``__metadata__``
  record with the model geometry, and the ``__sha256__`` content digest
  (:mod:`~eegnetreplication_tpu_torch.resil.integrity`), verified on load.
  A file whose digest does not match is moved aside to ``*.corrupt`` and
  :class:`~eegnetreplication_tpu_torch.resil.integrity.IntegrityError`
  raised, as in the JAX package.
- The ``.pth`` is the reference's bare NCHW ``state_dict``, which is the
  port's :class:`~eegnetreplication_tpu_torch.models.EEGNet` layout as is
  (EEGNet only: the reference has no other model, and the protocols write
  no ``.pth`` for the baselines, as in the JAX package).

:func:`from_jax_variables` carries the JAX package's parameter tree (numpy
arrays in flax names and layouts) of any registered model (EEGNet,
ShallowConvNet, DeepConvNet) into the port's ``state_dict`` — the
counterpart of ``to_torch_state_dict``, classifier permutation included:
flax flattens NHWC ``(1, T', F)``, torch NCHW ``(F, 1, T')``.
:func:`to_jax_variables` is its inverse, and
:func:`from_jax_variables_stacked` carries a fold-stacked tree (every leaf
with a leading fold axis, what the JAX protocols' ``init_fold_states``
give) into a stacked ``state_dict``.

Run snapshots (:func:`save_run_snapshot`, :func:`load_run_snapshot`) hold a
chunked run's carry between chunks with the JAX package's durability
contract: a same-directory temp file renamed into place, the sha256
digest, and keep-N generations (``snap.npz`` newest, ``snap.npz.gen1`` the
one before, ...; ``EEGTPU_SNAPSHOT_KEEP``, default 2).  A generation that
fails integrity is quarantined to ``*.corrupt`` and the next one answers.
The carry is the port's own (``training/loop.py::FoldTrainer.carry``),
stored under its names (``carry/<name>``); a stored signature that differs
from the run's raises, so a snapshot of another run, the JAX package's
included, is never poured into this one.  Orbax directories are not
ported.

Every staged write probes the ``checkpoint.write`` chaos site (and the
snapshot writer's thread ``checkpoint.write_async``) between the temp file
and the rename, where the JAX package probes them; a quarantine journals
``checkpoint_quarantine`` and counts ``checkpoints_quarantined``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import inject, integrity
from eegnetreplication_tpu_torch.utils.logging import logger

SEP = "/"
CARRY_PREFIX = "carry" + SEP

# Run-snapshot generations kept by rotation, the newest included: one
# fallback survives any single corrupt write.
DEFAULT_SNAPSHOT_KEEP = 2

# EEGNet's flax module name -> (torch prefix, kind): the reference's layer
# names.  kind is "conv", "bn" or "dense".
_EEGNET_LAYERS = [
    ("temporal_conv", "temporal.0", "conv"),
    ("temporal_bn", "temporal.1", "bn"),
    ("spatial_conv", "spatial", "conv"),
    ("spatial_bn", "aggregation.0", "bn"),
    ("separable_depthwise", "block_2.0", "conv"),
    ("separable_pointwise", "block_2.1", "conv"),
    ("block2_bn", "block_2.2", "bn"),
    ("classifier", "classifier", "dense"),
]


def _layers(names) -> list[tuple[str, str, str]]:
    """The ``(flax name, torch prefix, kind)`` list of the architecture
    whose layers are ``names`` (flax module names or torch prefixes).
    EEGNet keeps the reference's torch names; ShallowConvNet (``bn``) and
    DeepConvNet (``bn_0``, ``conv_1``, ...) use the flax names in torch
    too (``models/convnets.py``)."""
    names = set(names)
    if "temporal_bn" in names or "temporal.1" in names:
        return _EEGNET_LAYERS
    if "bn" in names:
        inner = [("bn", "bn", "bn")]
    elif "bn_0" in names:
        inner = [("bn_0", "bn_0", "bn")]
        i = 1
        while f"conv_{i}" in names:
            inner += [(f"conv_{i}", f"conv_{i}", "conv"),
                      (f"bn_{i}", f"bn_{i}", "bn")]
            i += 1
    else:
        raise ValueError(
            f"Unrecognized model variables: layers {sorted(names)} are none "
            "of EEGNet, ShallowConvNet or DeepConvNet")
    return ([("temporal_conv", "temporal_conv", "conv"),
             ("spatial_conv", "spatial_conv", "conv")] + inner
            + [("classifier", "classifier", "dense")])


def _classifier_features(layers, widths: Mapping[str, int]) -> int:
    """F, the feature width the classifier's fan-in is flattened over: the
    width of the last BatchNorm (EEGNet's F2, ShallowConvNet's spatial
    filters, DeepConvNet's last block)."""
    last_bn = [f for f, _, kind in layers if kind == "bn"][-1]
    return int(widths[last_bn])


def _classifier_nhwc_to_nchw(kernel: np.ndarray, f2: int,
                             t_prime: int) -> np.ndarray:
    """(T'*F2, n_cls) flax kernel -> (n_cls, F2*T') torch weight."""
    n_cls = kernel.shape[1]
    k = kernel.reshape(t_prime, f2, n_cls)          # [w, f, cls]
    return np.transpose(k, (2, 1, 0)).reshape(n_cls, f2 * t_prime)


def _classifier_nchw_to_nhwc(weight: np.ndarray, f2: int,
                             t_prime: int) -> np.ndarray:
    """(n_cls, F2*T') torch weight -> (T'*F2, n_cls) flax kernel."""
    n_cls = weight.shape[0]
    w = weight.reshape(n_cls, f2, t_prime)          # [cls, f, w]
    return np.transpose(w, (2, 1, 0)).reshape(t_prime * f2, n_cls)


def _conv_nhwc_to_nchw(kernel: np.ndarray) -> np.ndarray:
    """Flax (kh, kw, in/g, out) -> torch (out, in/g, kh, kw)."""
    return np.transpose(kernel, (3, 2, 0, 1))


def _conv_nchw_to_nhwc(weight: np.ndarray) -> np.ndarray:
    return np.transpose(weight, (2, 3, 1, 0))


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a))


def from_jax_variables(params: Mapping, batch_stats: Mapping
                       ) -> dict[str, torch.Tensor]:
    """The JAX package's model variables as the port's ``state_dict``.

    ``params``/``batch_stats`` are nested dicts of arrays in flax names and
    layouts (what ``model.init`` or ``load_checkpoint`` give, as numpy), of
    an EEGNet, a ShallowConvNet or a DeepConvNet (told apart by their layer
    names).  The classifier's feature width and T' come from the shapes.
    Returns CPU tensors, BatchNorm ``num_batches_tracked`` included, ready
    for ``load_state_dict``.
    """
    layers = _layers(params)
    widths = {f: np.shape(params[f]["scale"])[0]
              for f, _, kind in layers if kind == "bn"}
    f2 = _classifier_features(layers, widths)
    t_prime = int(np.shape(params["classifier"]["kernel"])[0]) // f2
    sd: dict[str, torch.Tensor] = {}
    for flax_name, prefix, kind in layers:
        if kind == "bn":
            sd[f"{prefix}.weight"] = _tensor(_numpy(params[flax_name]["scale"]))
            sd[f"{prefix}.bias"] = _tensor(_numpy(params[flax_name]["bias"]))
            sd[f"{prefix}.running_mean"] = _tensor(
                _numpy(batch_stats[flax_name]["mean"]))
            sd[f"{prefix}.running_var"] = _tensor(
                _numpy(batch_stats[flax_name]["var"]))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
        elif kind == "conv":
            sd[f"{prefix}.weight"] = _tensor(_conv_nhwc_to_nchw(
                _numpy(params[flax_name]["kernel"])))
        else:
            sd[f"{prefix}.weight"] = _tensor(_classifier_nhwc_to_nchw(
                _numpy(params[flax_name]["kernel"]), f2, t_prime))
            sd[f"{prefix}.bias"] = _tensor(_numpy(params[flax_name]["bias"]))
    return sd


def from_jax_variables_stacked(params: Mapping, batch_stats: Mapping
                               ) -> dict[str, torch.Tensor]:
    """A fold-stacked JAX model tree as a stacked ``state_dict``: every
    leaf's leading axis is the fold, and each fold is carried across as
    :func:`from_jax_variables` does."""
    def fold(tree, g):
        return {k: fold(v, g) if isinstance(v, Mapping) else _numpy(v)[g]
                for k, v in tree.items()}

    n = int(np.shape(params["classifier"]["bias"])[0])
    per_fold = [from_jax_variables(fold(params, g), fold(batch_stats, g))
                for g in range(n)]
    return {k: torch.stack([sd[k] for sd in per_fold]) for k in per_fold[0]}


def to_jax_variables(state_dict: Mapping) -> tuple[dict, dict]:
    """The port's ``state_dict`` (any registered architecture) as JAX
    ``(params, batch_stats)``: nested dicts of contiguous numpy arrays in
    flax names and layouts."""
    def arr(key):
        return _numpy(state_dict[key])

    layers = _layers({k.rsplit(".", 1)[0] for k in state_dict})
    widths = {f: arr(f"{t}.weight").shape[0]
              for f, t, kind in layers if kind == "bn"}
    f2 = _classifier_features(layers, widths)
    params: dict = {}
    batch_stats: dict = {}
    for flax_name, prefix, kind in layers:
        if kind == "bn":
            params[flax_name] = {"scale": arr(f"{prefix}.weight"),
                                 "bias": arr(f"{prefix}.bias")}
            batch_stats[flax_name] = {"mean": arr(f"{prefix}.running_mean"),
                                      "var": arr(f"{prefix}.running_var")}
        elif kind == "conv":
            params[flax_name] = {"kernel": np.ascontiguousarray(
                _conv_nchw_to_nhwc(arr(f"{prefix}.weight")))}
        else:
            weight = arr(f"{prefix}.weight")
            params[flax_name] = {
                "kernel": np.ascontiguousarray(_classifier_nchw_to_nhwc(
                    weight, f2, weight.shape[1] // f2)),
                "bias": arr(f"{prefix}.bias")}
    return params, batch_stats


def flatten_variables(params: Mapping, batch_stats: Mapping
                      ) -> dict[str, np.ndarray]:
    """``{"params/<layer>/<leaf>": array, "batch_stats/...": array}`` — the
    JAX package's flat checkpoint keys."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key in sorted(node):
            value = node[key]
            if isinstance(value, Mapping):
                walk(value, prefix + key + SEP)
            else:
                flat[prefix + key] = np.asarray(value)

    walk(params, "params" + SEP)
    walk(batch_stats, "batch_stats" + SEP)
    return flat


def _unflatten(flat: Mapping[str, np.ndarray], prefix: str) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split(SEP)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def quarantine_artifact(path: Path, error: BaseException | str) -> Path:
    """Move a corrupt artifact aside as ``<name>[.N].corrupt``.  Best
    effort: a failed rename must not mask the corruption itself."""
    target = path.with_name(path.name + ".corrupt")
    n = 1
    while target.exists():
        n += 1
        target = path.with_name(f"{path.name}.{n}.corrupt")
    try:
        path.replace(target)
    except OSError as exc:
        logger.warning("Could not quarantine corrupt checkpoint %s: %s",
                       path, exc)
        return path
    logger.warning("Checkpoint %s failed integrity (%s) — quarantined to %s",
                   path, str(error)[:200], target)
    jr = obs_journal.current()
    jr.event("checkpoint_quarantine", path=str(path),
             quarantined_to=str(target), error=str(error)[:300])
    jr.metrics.inc("checkpoints_quarantined")
    return target


def _read_verified(path: Path) -> dict[str, np.ndarray]:
    """Read a checkpoint and check its content digest.

    An unreadable container raises IntegrityError and stays where it is
    (it may be any user file); a digest mismatch, which proves a damaged
    framework checkpoint, is quarantined first.
    """
    try:
        with np.load(path, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except Exception as exc:  # noqa: BLE001 — any unreadable shape
        raise integrity.IntegrityError(
            f"{path}: unreadable checkpoint ({exc})") from exc
    try:
        integrity.verify(flat, what=str(path))
    except integrity.IntegrityError:
        quarantine_artifact(path, "content digest mismatch")
        raise
    flat.pop(integrity.DIGEST_KEY, None)
    return flat


def save_checkpoint(path: str | Path, state_dict: Mapping,
                    metadata: dict | None = None) -> Path:
    """Save a model's weights as a native ``.npz`` the JAX package loads.

    Written atomically (same-directory temp file, then rename), stamped
    with the sha256 content digest.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = flatten_variables(*to_jax_variables(state_dict))
    flat["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    integrity.stamp(flat)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    inject.fire("checkpoint.write", path=tmp, what="checkpoint")
    tmp.replace(path)
    return path


def load_checkpoint(path: str | Path
                    ) -> tuple[dict[str, torch.Tensor], dict]:
    """Load a native ``.npz`` as ``(state_dict, metadata)`` after verifying
    its content digest."""
    flat = _read_verified(Path(path))
    metadata = json.loads(bytes(flat.pop("__metadata__")).decode())
    params = _unflatten(flat, "params" + SEP)
    batch_stats = _unflatten(flat, "batch_stats" + SEP)
    return from_jax_variables(params, batch_stats), metadata


def save_pth(path: str | Path, state_dict: Mapping) -> Path:
    """Save a reference-loadable ``.pth`` (a bare CPU ``state_dict``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu().contiguous()
                for k, v in state_dict.items()}, path)
    return path


def snapshot_keep() -> int:
    """The keep-N rotation depth (``EEGTPU_SNAPSHOT_KEEP``, at least 1)."""
    try:
        return max(1, int(os.environ.get("EEGTPU_SNAPSHOT_KEEP",
                                         DEFAULT_SNAPSHOT_KEEP)))
    except ValueError:
        return DEFAULT_SNAPSHOT_KEEP


def _generation_path(path: Path, gen: int) -> Path:
    """``snap.npz`` -> ``snap.npz.gen<gen>`` (gen >= 1)."""
    return path.with_name(f"{path.name}.gen{gen}")


def _generations(path: Path) -> list[Path]:
    """The ``.genN`` files of ``path``, oldest last (holes allowed: a
    quarantined generation leaves one)."""
    gens = []
    for cand in path.parent.glob(path.name + ".gen*"):
        suffix = cand.name[len(path.name) + len(".gen"):]
        if suffix.isdigit():
            gens.append((int(suffix), cand))
    return [cand for _, cand in sorted(gens)]


def rotate_generations(path: Path, keep: int) -> None:
    """Shift ``path`` into the ``.gen*`` chain before a new write replaces
    it: gen(keep-1) dropped, ..., gen1 -> gen2, path -> gen1.  ``keep``
    counts generations including the one about to land; 1 keeps none."""
    if keep <= 1 or not path.exists():
        return
    _generation_path(path, keep - 1).unlink(missing_ok=True)
    for gen in range(keep - 2, 0, -1):
        src = _generation_path(path, gen)
        if src.exists():
            src.replace(_generation_path(path, gen + 1))
    path.replace(_generation_path(path, 1))


def any_snapshot_generation(path: str | Path) -> bool:
    """True when ``path`` or any of its ``.genN`` generations exists (a
    crash between rotation and rename leaves only ``.gen1``)."""
    path = Path(path)
    return path.exists() or bool(_generations(path))


def resolve_snapshot(path: str | Path, *, quarantine: bool = True
                     ) -> tuple[Path, dict[str, np.ndarray]] | None:
    """The newest generation of ``path`` whose content passes integrity, as
    ``(file, flat arrays)``, or ``None``.  Every candidate that cannot be
    read or whose digest mismatches is quarantined on the way.

    ``quarantine=False`` is for a reader that does not own the chain (a
    cell front reading a live cell's spool): it skips such a candidate and
    moves nothing.  The owner may be rotating the chain as it reads, and
    a file renamed away after the listing would otherwise be "moved
    aside" by its old name, which by then can hold the owner's next,
    valid snapshot."""
    path = Path(path)
    for cand in [path] + _generations(path):
        if not cand.exists():
            continue
        try:
            with np.load(cand, allow_pickle=False) as data:
                flat = {k: data[k] for k in data.files}
            integrity.verify(flat, what=str(cand))
        except Exception as exc:  # noqa: BLE001 — any unreadable shape
            if quarantine:
                quarantine_artifact(cand, exc)
            continue
        return cand, flat
    return None


def save_run_snapshot(path: str | Path, carry: Mapping[str, np.ndarray],
                      epochs_done: int, signature: dict, *,
                      keep: int | None = None,
                      _async_site: bool = False) -> Path:
    """Persist a chunked run's carry (host arrays by name) after
    ``epochs_done`` epochs, stamped with ``signature`` and the digest;
    rotation happens just before the atomic rename.  ``_async_site`` (the
    snapshot writer's thread) also probes ``checkpoint.write_async``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {CARRY_PREFIX + name: np.asarray(arr)
            for name, arr in carry.items()}
    flat["__epochs_done__"] = np.asarray(epochs_done, np.int64)
    flat["__signature__"] = np.frombuffer(
        json.dumps(signature, sort_keys=True).encode(), dtype=np.uint8)
    integrity.stamp(flat)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
    inject.fire("checkpoint.write", path=tmp, what="run_snapshot",
                epochs_done=epochs_done)
    if _async_site:
        inject.fire("checkpoint.write_async", path=tmp, what="run_snapshot",
                    epochs_done=epochs_done)
    rotate_generations(path, keep if keep is not None else snapshot_keep())
    tmp.replace(path)
    return path


def read_snapshot_signature(path: str | Path) -> dict | None:
    """The stored run signature of the newest valid generation, or ``None``
    when none exists or it carries no signature."""
    resolved = resolve_snapshot(path)
    if resolved is None or "__signature__" not in resolved[1]:
        return None
    try:
        return json.loads(bytes(resolved[1]["__signature__"]).decode())
    except ValueError:
        return None


def load_run_snapshot(path: str | Path, signature: dict
                      ) -> tuple[dict[str, np.ndarray], int]:
    """Restore a run snapshot as ``(carry, epochs_done)``.

    Resolves the newest valid generation (see :func:`resolve_snapshot`);
    raises ``FileNotFoundError`` when none survives and ``ValueError`` when
    its stored signature is not ``signature``.
    """
    resolved = resolve_snapshot(path)
    if resolved is None:
        raise FileNotFoundError(
            f"No valid run snapshot at {path} (all generations corrupt or "
            "missing)")
    resolved_path, flat = resolved
    if resolved_path != Path(path):
        logger.warning("Resume: snapshot %s was corrupt — falling back to "
                       "previous generation %s", path, resolved_path)
    stored = (json.loads(bytes(flat["__signature__"]).decode())
              if "__signature__" in flat else None)
    if stored != signature:
        raise ValueError(
            f"Snapshot {path} belongs to a different run: {stored} != "
            f"{signature}. Delete it or rerun without --resume.")
    carry = {k[len(CARRY_PREFIX):]: v for k, v in flat.items()
             if k.startswith(CARRY_PREFIX)}
    return carry, int(flat["__epochs_done__"])


def load_pth_auto(path: str | Path
                  ) -> tuple[dict[str, torch.Tensor], dict]:
    """Load a reference ``.pth``, inferring the EEGNet geometry from shapes.

    F1/F2/C come from the conv weights, T' from the classifier fan-in;
    ``n_times`` is reported as ``T'*32 + 1``, the pipeline's inclusive
    window (both 256 and 257 give the same T').  Returns
    ``(state_dict, metadata)``.
    """
    # weights_only: an untrusted pickle must not run code.
    sd = torch.load(Path(path), map_location="cpu", weights_only=True)
    f1 = int(sd["temporal.0.weight"].shape[0])
    f2 = int(sd["spatial.weight"].shape[0])
    n_channels = int(sd["spatial.weight"].shape[2])
    fan_in = int(sd["classifier.weight"].shape[1])
    if f2 <= 0 or fan_in % f2:
        raise ValueError(
            f"Unrecognized EEGNet .pth geometry: classifier fan-in {fan_in} "
            f"is not a multiple of F2={f2}")
    if f1 <= 0 or f2 % f1:
        raise ValueError(
            f"Unrecognized EEGNet .pth geometry: F2={f2} is not a multiple "
            f"of F1={f1} (depth multiplier D must be integral)")
    t_prime = fan_in // f2
    meta = {"model": "eegnet", "n_channels": n_channels,
            "n_times": t_prime * 32 + 1, "F1": f1, "D": f2 // f1}
    return sd, meta
