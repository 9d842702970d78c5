"""Tenant-stacked weights: one forward for a batch that mixes N models.

The counterpart of ``eegnetreplication_tpu/ops/stacked.py``.  The
within-subject protocol trains nine EEGNets of one architecture; their
weight trees are *congruent* (same structure, shapes and dtypes), so they
stack into one tree with a leading tenant axis (:func:`stack_trees`).  A
coalesced serving batch then mixes tenants, each trial carrying its
tenant's index, and runs in a few launches whatever the number of
tenants:

- block 1 is ONE launch of K1's stacked form
  (``ops/fused_eegnet.py::block1_stacked``), which takes G folded weight
  sets and an int32 set index per trial;
- block 2 and the classifier run on per-trial gathered weights: the
  depthwise taps as one grouped convolution over ``N * F2`` channels, the
  pointwise matmul and the classifier batched (``bmm``), BatchNorm in the
  single-model engine's op order.

The int8 form (:func:`stacked_quantized_eval_forward`) takes a tree
quantized per tenant and channel (``ops/quant.py``), so a stacked tenant
is the same quantization it would be alone.

Trees that do not stack raise :class:`IncongruentTrees`, a ``ValueError``
subclass of its own: the zoo serves per-model engines for exactly that
case and for no other error (``serve/registry.py``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    _elu,
    block1_stacked,
    block1_stacked_reference,
    fold_block1_params,
)
from eegnetreplication_tpu_torch.ops.quant import quantized_block2


class IncongruentTrees(ValueError):
    """Weight trees that cannot stack (another structure, shape or
    dtype).  Raised before anything is launched."""


def tree_leaves_with_paths(tree: Any, prefix: str = ""
                           ) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in sorted-key order (mapping nodes only)."""
    if hasattr(tree, "items"):
        out: list[tuple[str, Any]] = []
        for k in sorted(tree, key=str):
            out.extend(tree_leaves_with_paths(
                tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _signature(leaf) -> tuple[tuple[int, ...], str]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr.shape, str(arr.dtype)


def congruent(trees: list[Any]) -> tuple[bool, str]:
    """Whether every tree has the same structure, leaf shapes and dtypes;
    returns ``(ok, reason)``."""
    if not trees:
        return False, "no trees"
    ref_sig = [(p, *_signature(v)) for p, v in tree_leaves_with_paths(trees[0])]
    for i, tree in enumerate(trees[1:], 1):
        sig = [(p, *_signature(v)) for p, v in tree_leaves_with_paths(tree)]
        if sig != ref_sig:
            got = {p for p, _, _ in sig}
            want = {p for p, _, _ in ref_sig}
            if got != want:
                return False, (f"tree {i} structure differs "
                               f"(missing {sorted(want - got)[:3]}, "
                               f"extra {sorted(got - want)[:3]})")
            for (p, s, d), (_, rs, rd) in zip(sig, ref_sig):
                if (s, d) != (rs, rd):
                    return False, (f"tree {i} leaf {p}: {s}/{d} vs "
                                   f"reference {rs}/{rd}")
            return False, f"tree {i} differs from reference"
    return True, "ok"


def stack_trees(trees: list[Any]) -> dict:
    """Stack N congruent trees along a new leading tenant axis (numpy or
    torch leaves); raises :class:`IncongruentTrees` otherwise."""
    ok, reason = congruent(trees)
    if not ok:
        raise IncongruentTrees(f"param trees are not stackable: {reason}")

    def walk(nodes):
        first = nodes[0]
        if hasattr(first, "items"):
            return {k: walk([n[k] for n in nodes]) for k in first}
        if isinstance(first, torch.Tensor):
            return torch.stack(list(nodes))
        return np.stack([np.asarray(n) for n in nodes])

    return walk(list(trees))


def tenant_slice(stacked: Any, z: int) -> dict:
    """Tenant ``z``'s tree back out of a stacked one (a view per leaf)."""
    def walk(node):
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        return node[z] if isinstance(node, torch.Tensor) \
            else np.asarray(node)[z]

    return walk(stacked)


def gather_tree(stacked: Any, tenant_idx) -> dict:
    """Per-trial tree: every leaf indexed by the ``(N,)`` tenant vector."""
    def walk(node):
        if hasattr(node, "items"):
            return {k: walk(v) for k, v in node.items()}
        return node[tenant_idx]

    return walk(stacked)


def fold_stacked_eegnet(stacked_state: Mapping[str, torch.Tensor],
                        eps: float = 1e-5) -> dict[str, torch.Tensor]:
    """The fp32 stacked forward's operands from a stacked ``state_dict``
    (every tensor with a leading tenant axis): block 1 folded per tenant
    (``S, W, A, B``), the depthwise taps ``(G, F2, 16)``, the pointwise
    matrix ``(G, F2, F2)``, block 2's BatchNorm, the classifier."""
    S, W, A, B = fold_block1_params(stacked_state, eps)
    g, f2 = S.shape[0], S.shape[1]
    return {
        "S": S, "W": W, "A": A, "B": B,
        "dw": stacked_state["block_2.0.weight"].reshape(g, f2, -1)
        .contiguous(),
        "pw": stacked_state["block_2.1.weight"].reshape(g, f2, f2)
        .contiguous(),
        "mean": stacked_state["block_2.2.running_mean"],
        "inv": 1.0 / torch.sqrt(stacked_state["block_2.2.running_var"]
                                + eps),
        "scale": stacked_state["block_2.2.weight"],
        "shift": stacked_state["block_2.2.bias"],
        "cls": stacked_state["classifier.weight"],
        "bias": stacked_state["classifier.bias"],
    }


def _stacked_block2(h: torch.Tensor, pack: Mapping[str, torch.Tensor],
                    idx: torch.Tensor) -> torch.Tensor:
    """fp32 block 2 and the classifier on per-trial weights, in the order
    of ``ops/fused_eegnet.py::fused_eval_forward``: depthwise, pointwise,
    BatchNorm as ``(h - mean) * inv * scale + shift``, ELU, AvgPool(8),
    the flatten and the classifier."""
    n, f2, tp = h.shape
    idx = idx.long()
    h = F.conv1d(F.pad(h, (7, 8)).reshape(1, n * f2, tp + 15),
                 pack["dw"][idx].reshape(n * f2, 1, -1),
                 groups=n * f2).reshape(n, f2, tp)
    h = torch.bmm(pack["pw"][idx], h)

    def per(name):
        return pack[name][idx][:, :, None]

    h = (h - per("mean")) * per("inv") * per("scale") + per("shift")
    h = F.avg_pool1d(_elu(h), 8).reshape(n, -1, 1)
    return torch.baddbmm(pack["bias"][idx][:, :, None], pack["cls"][idx],
                         h)[..., 0]


def stacked_eval_forward(pack: Mapping[str, torch.Tensor], x: torch.Tensor,
                         tenant_idx: torch.Tensor, *,
                         idx_checked: bool = False) -> torch.Tensor:
    """fp32 logits of a mixed-tenant batch: trial ``n`` of ``x`` ``(N, C,
    T)`` through tenant ``tenant_idx[n]`` (int32 ``(N,)``) of a
    :func:`fold_stacked_eegnet` pack.  Block 1 is one launch of
    ``block1_stacked`` (its plain version for a CPU ``x``);
    ``idx_checked`` passes on to it."""
    h = block1_stacked(x, pack["S"], pack["W"], pack["A"], pack["B"],
                       tenant_idx, idx_checked=idx_checked)
    return _stacked_block2(h, pack, tenant_idx)


def stacked_eval_forward_reference(pack, x, tenant_idx) -> torch.Tensor:
    """The plain version of :func:`stacked_eval_forward` (block 1 through
    ``block1_stacked_reference``)."""
    h = block1_stacked_reference(x, pack["S"], pack["W"], pack["A"],
                                 pack["B"], tenant_idx)
    return _stacked_block2(h, pack, tenant_idx)


def stacked_quantized_eval_forward(pack: Mapping[str, torch.Tensor],
                                   x: torch.Tensor,
                                   tenant_idx: torch.Tensor, *,
                                   idx_checked: bool = False
                                   ) -> torch.Tensor:
    """int8 logits of a mixed-tenant batch from a stacked
    ``ops/quant.py::fold_quantized_eegnet`` pack: one ``block1_stacked``
    launch, then the int8 block 2 on per-trial gathered operands."""
    h = block1_stacked(x, pack["S"], pack["W"], pack["A"], pack["B"],
                       tenant_idx, idx_checked=idx_checked)
    return quantized_block2(h, pack, tenant_idx)


def stacked_quantized_eval_forward_reference(pack, x, tenant_idx
                                             ) -> torch.Tensor:
    """The plain version of :func:`stacked_quantized_eval_forward`."""
    h = block1_stacked_reference(x, pack["S"], pack["W"], pack["A"],
                                 pack["B"], tenant_idx)
    return quantized_block2(h, pack, tenant_idx)
