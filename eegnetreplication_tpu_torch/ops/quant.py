"""Per-channel symmetric int8 weights for serving, and the int8 forward.

The counterpart of ``eegnetreplication_tpu/ops/quant.py``.  EEGNet's
convolution and dense kernels are quantized to int8 with one fp32 scale per
output channel (symmetric, no zero point: ``w ~= q * scale`` with ``q`` in
``[-127, 127]``); BatchNorm parameters, statistics and biases stay fp32.
The quantizer, the flat form and the ``.npz`` format are copies of the JAX
package's numpy code on the same flax-layout trees (what
``training/checkpoint.py::to_jax_variables`` gives), so both packages make
the same ``q`` and ``scale`` arrays bit for bit, the same
:func:`qparams_digest`, and files either one writes load in the other.

The int8 forward (:func:`quantized_eval_forward`) follows the JAX
package's specialized EEGNet schedule (``_quantized_eegnet_logits``) on
weights dequantized once, when the engine is built
(:func:`fold_quantized_eegnet`):

- block 1 folds both BatchNorms into ``(S, W, A, B)`` from the dequantized
  kernels and runs through the hand-written kernel K1
  (``ops/fused_eegnet.py::block1``; the plain version
  :func:`quantized_eval_forward_reference` runs ``block1_reference``);
- block 2's depthwise taps, then the pointwise matmul with block 2's
  BatchNorm folded into it, ELU;
- AvgPool(8), the flatten and the classifier as one matmul whose rows
  spread each classifier weight over its 8 pooled inputs.

A tree stacked along a leading tenant axis (``ops/stacked.py``) folds to
stacked operands with the same leading axis; ``ops/stacked.py`` serves a
mixed-tenant batch from it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from eegnetreplication_tpu_torch.resil import integrity

# Symmetric signed-int8 range; -128 is left out so the grid is symmetric.
QMAX = 127

_Q_KEYS = frozenset(("q", "scale"))

# Parameter leaves that get quantized: every conv/dense weight is a flax
# "kernel"; biases and BatchNorm leaves keep fp32.
QUANTIZED_LEAF = "kernel"


def is_qleaf(node: Any) -> bool:
    """True for a quantized-tensor node (``{"q": int8, "scale": f32}``)."""
    return (isinstance(node, Mapping) and set(node.keys()) == _Q_KEYS
            and getattr(node["q"], "dtype", None) == np.int8)


def quantize_tensor(w: np.ndarray, axis: int = -1, *,
                    tenant_axis: int | None = None) -> dict[str, np.ndarray]:
    """Per-channel symmetric int8 quantization of one weight tensor.

    ``axis`` is the output-channel axis (last for a flax kernel); each
    output channel gets the scale ``amax / 127``, and an all-zero channel
    keeps scale 1.0.  ``tenant_axis`` keeps a stacked tree's tenant axis
    unreduced too, so each tenant quantizes as it would alone.
    """
    w = np.asarray(w, np.float32)
    keep = {axis % w.ndim}
    if tenant_axis is not None:
        keep.add(tenant_axis % w.ndim)
    reduce_axes = tuple(i for i in range(w.ndim) if i not in keep)
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / QMAX, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -QMAX, QMAX).astype(np.int8)
    return {"q": q, "scale": scale}


def dequantize_tensor(qleaf: Mapping[str, Any]) -> np.ndarray:
    """``q * scale`` as fp32."""
    return np.asarray(qleaf["q"], np.float32) * np.asarray(qleaf["scale"])


def quantize_params(params: Any, *, stacked: bool = False) -> dict:
    """The params tree with every ``kernel`` leaf replaced by a quantized
    node; every other leaf passes through as an fp32 numpy array.
    ``stacked=True`` quantizes per tenant and channel along the leading
    axis of an ``ops/stacked.py::stack_trees`` result."""
    tenant_axis = 0 if stacked else None

    def walk(node):
        if hasattr(node, "items"):
            return {k: (quantize_tensor(v, tenant_axis=tenant_axis)
                        if k == QUANTIZED_LEAF and hasattr(v, "shape")
                        else walk(v))
                    for k, v in node.items()}
        return np.asarray(node)

    return walk(params)


def dequantize_params(qparams: Any) -> dict:
    """The fp32 tree back from a quantized one (numpy leaves)."""
    def walk(node):
        if is_qleaf(node):
            return dequantize_tensor(node)
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        return np.asarray(node)

    return walk(qparams)


def quantization_error(params: Any, qparams: Any) -> dict[str, dict]:
    """Per quantized layer: the realized ``max_abs_err`` of the round trip
    beside its bound ``scale / 2``, and the relative Frobenius error."""
    out: dict[str, dict] = {}

    def walk(p, q, path):
        if is_qleaf(q):
            w = np.asarray(p, np.float32)
            err = np.abs(w - dequantize_tensor(q))
            out["/".join(path)] = {
                "max_abs_err": float(err.max()) if err.size else 0.0,
                "bound": float(np.max(q["scale"]) / 2.0),
                "rel_fro": float(np.linalg.norm(w - dequantize_tensor(q))
                                 / max(np.linalg.norm(w), 1e-12)),
            }
            return
        if hasattr(q, "items"):
            for k in q:
                walk(p[k], q[k], path + (str(k),))

    walk(params, qparams, ())
    return out


# ---------------------------------------------------------------------------
# Flat form and npz persistence (the JAX package's format).
# ---------------------------------------------------------------------------

_SEP = "/"
_Q_SUFFIX = ".q"
_SCALE_SUFFIX = ".scale"


def flatten_qparams(qparams: Any, prefix: str = "qparams/"
                    ) -> dict[str, np.ndarray]:
    """``{key: ndarray}``: a quantized node flattens to ``<path>.q`` (int8)
    and ``<path>.scale`` (f32), an fp32 leaf keeps its plain path."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, path: str):
        if is_qleaf(node):
            flat[path + _Q_SUFFIX] = np.asarray(node["q"])
            flat[path + _SCALE_SUFFIX] = np.asarray(node["scale"])
            return
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(v, path + _SEP + str(k) if path else str(k))
            return
        flat[path] = np.asarray(node)

    for k, v in qparams.items():
        walk(v, prefix + str(k))
    return flat


def unflatten_qparams(flat: Mapping[str, np.ndarray],
                      prefix: str = "qparams/") -> dict:
    """Inverse of :func:`flatten_qparams`; keys outside ``prefix`` are
    ignored."""
    tree: dict = {}
    for key in sorted(flat):
        if not key.startswith(prefix):
            continue
        path = key[len(prefix):]
        if path.endswith(_Q_SUFFIX):
            parts, leaf = path[: -len(_Q_SUFFIX)].split(_SEP), "q"
        elif path.endswith(_SCALE_SUFFIX):
            parts, leaf = path[: -len(_SCALE_SUFFIX)].split(_SEP), "scale"
        else:
            parts, leaf = path.split(_SEP), None
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if leaf is None:
            node[parts[-1]] = np.asarray(flat[key])
        else:
            node.setdefault(parts[-1], {})[leaf] = np.asarray(flat[key])
    return tree


def qparams_digest(qparams: Any) -> str:
    """sha256 content digest of the quantized tree's flat form: the
    identity of what an int8 engine multiplies by."""
    return integrity.content_digest(flatten_qparams(qparams))


def save_quantized(path: str | Path, qparams: Any,
                   metadata: dict | None = None) -> Path:
    """Write a quantized tree as an integrity-stamped npz (temp file, then
    rename)."""
    flat = flatten_qparams(qparams)
    if metadata:
        flat["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    integrity.stamp(flat)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:  # a handle: np.savez must not append .npz
        np.savez(fh, **flat)
    tmp.replace(path)
    return path


def load_quantized(path: str | Path) -> tuple[dict, dict]:
    """``(qparams, metadata)`` from a :func:`save_quantized` file; raises
    :class:`~eegnetreplication_tpu_torch.resil.integrity.IntegrityError`
    on a digest mismatch."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    integrity.verify(flat, what=f"quantized checkpoint {path}")
    metadata = {}
    if "__metadata__" in flat:
        metadata = json.loads(bytes(flat.pop("__metadata__")).decode())
    flat.pop(integrity.DIGEST_KEY, None)
    return unflatten_qparams(flat), metadata


# ---------------------------------------------------------------------------
# The int8 forward.
# ---------------------------------------------------------------------------

def fold_quantized_eegnet(qparams: Mapping, batch_stats: Mapping,
                          eps: float = 1e-5, *,
                          device: torch.device | str = "cpu"
                          ) -> dict[str, torch.Tensor]:
    """Dequantize a quantized EEGNet tree once and fold it into the int8
    forward's operands, on ``device``.

    Returns ``S`` ``(F2, C)``, ``W`` ``(F2, 32)``, ``A`` and ``B`` ``(F2,)``
    (block 1 for K1), ``dw`` ``(F2, 16)`` depthwise taps, ``pw`` ``(F2,
    F2)`` the pointwise matrix (output, input) with block 2's BatchNorm
    scale folded in, ``shift`` ``(F2,)``, ``cls`` ``(K, F2 * 8 * T'')`` the
    classifier spread over AvgPool(8)'s inputs, ``bias`` ``(K,)``.  A
    stacked tree (every leaf with a leading tenant axis) gives the same
    operands with that axis in front.  Each step is the JAX schedule's.
    """
    def deq(name):
        return torch.from_numpy(dequantize_tensor(
            qparams[name]["kernel"])).to(device)

    def leaf(tree, name, key):
        return torch.from_numpy(np.asarray(tree[name][key], np.float32)
                                ).to(device)

    def bn_affine(name):
        scale = leaf(qparams, name, "scale") / torch.sqrt(
            leaf(batch_stats, name, "var") + eps)
        shift = leaf(qparams, name, "bias") \
            - leaf(batch_stats, name, "mean") * scale
        return scale, shift

    w_t = deq("temporal_conv")            # ([G,] 1, K, 1, F1)
    w_s = deq("spatial_conv")             # ([G,] C, 1, 1, F2)
    f1, f2 = w_t.shape[-1], w_s.shape[-1]
    group = torch.arange(f2, device=w_t.device) // (f2 // f1)
    a1, b1 = bn_affine("temporal_bn")
    a2, b2 = bn_affine("spatial_bn")
    S = w_s[..., :, 0, 0, :].transpose(-1, -2)             # (F2, C)
    W = w_t[..., 0, :, 0, :].transpose(-1, -2)[..., group, :]  # (F2, K)
    A = a2 * a1[..., group]
    B = a2 * (b1[..., group] * torch.sum(S, dim=-1)) + b2
    dw = deq("separable_depthwise")[..., 0, :, 0, :].transpose(-1, -2)
    s2, shift = bn_affine("block2_bn")
    w_pw = deq("separable_pointwise")[..., 0, 0, :, :]     # (in, out)
    pw = (w_pw * s2[..., None, :]).transpose(-1, -2)       # (out, in)
    w_c = deq("classifier")                                # (t8*F2, K)
    n_cls = w_c.shape[-1]
    t8 = w_c.shape[-2] // f2
    w_full = torch.repeat_interleave(
        w_c.reshape(*w_c.shape[:-2], t8, f2, n_cls), 8, dim=-3) / 8.0
    cls = w_full.permute(*range(w_full.dim() - 3), -1, -2, -3).reshape(
        *w_full.shape[:-3], n_cls, f2 * t8 * 8)            # (K, f * t)
    return {"S": S.contiguous(), "W": W.contiguous(), "A": A.contiguous(),
            "B": B.contiguous(), "dw": dw.contiguous(), "pw": pw.contiguous(),
            "shift": shift.contiguous(), "cls": cls.contiguous(),
            "bias": leaf(qparams, "classifier", "bias").contiguous()}


def _elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def quantized_block2(h: torch.Tensor, pack: Mapping[str, torch.Tensor],
                     tenant_idx: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Block 2 and the classifier of the int8 schedule on block 1's output
    ``h`` ``(N, F2, T')``.  With ``tenant_idx`` the operands are stacked
    and each trial takes its tenant's: the depthwise taps as one grouped
    convolution over ``N * F2`` channels, the matmuls batched."""
    n, f2, tp = h.shape
    hp = F.pad(h, (7, 8))
    cls, bias = pack["cls"], pack["bias"]
    t_used = cls.shape[-1] // f2
    if tenant_idx is None:
        acc = F.conv1d(hp, pack["dw"][:, None, :], groups=f2)
        h3 = torch.matmul(pack["pw"], acc) + pack["shift"][:, None]
        flat = _elu(h3)[..., :t_used].reshape(n, f2 * t_used)
        return torch.addmm(bias, flat, cls.t())
    idx = tenant_idx.long()
    acc = F.conv1d(hp.reshape(1, n * f2, tp + 15),
                   pack["dw"][idx].reshape(n * f2, 1, -1),
                   groups=n * f2).reshape(n, f2, tp)
    h3 = torch.bmm(pack["pw"][idx], acc) + pack["shift"][idx][:, :, None]
    flat = _elu(h3)[..., :t_used].reshape(n, f2 * t_used, 1)
    return torch.baddbmm(bias[idx][:, :, None], cls[idx], flat)[..., 0]


def quantized_eval_forward(pack: Mapping[str, torch.Tensor],
                           x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits of one int8 EEGNet on ``x`` ``(N, C, T)``: block 1
    through K1 (its plain version for a CPU ``x``), then
    :func:`quantized_block2`."""
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1

    h = block1(x, pack["S"], pack["W"], pack["A"], pack["B"])
    return quantized_block2(h, pack)


def quantized_eval_forward_reference(pack: Mapping[str, torch.Tensor],
                                     x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`quantized_eval_forward`: block 1 through
    ``block1_reference``."""
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_reference

    h = block1_reference(x, pack["S"], pack["W"], pack["A"], pack["B"])
    return quantized_block2(h, pack)
