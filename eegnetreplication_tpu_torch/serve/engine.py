"""Inference engine: one checkpoint load, bucketed forwards on the card.

The fp32 counterpart of ``eegnetreplication_tpu/serve/engine.py``.  The
engine loads a checkpoint once (native ``.npz`` or reference ``.pth``),
folds block 1's weights once, and serves ``infer`` over a fixed ladder of
padded batch **buckets** (default 1/8/32/128), so an online batcher only
ever produces a handful of shapes.  Each bucket chunk is one forward: the
hand-written block-1 kernel (``ops/fused_eegnet.py::block1``, one launch)
followed by block 2 and the classifier as torch ops.

PyTorch runs eagerly, so there is no compile to warm; :meth:`warmup` runs
each bucket once so the kernel library is built and loaded, cuDNN picks
its algorithms and the caching allocator holds the buffers before the
first request arrives.

Padding rows repeat the last real trial and are dropped after the argmax:
eval-mode EEGNet is row-independent, so padding never changes a real
trial's prediction.  ``infer`` is thread-safe: a lock serializes dispatch.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    fold_block1_params,
    fused_eval_forward,
)
from eegnetreplication_tpu_torch.resil import integrity
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

DEFAULT_BUCKETS = (1, 8, 32, 128)

# BCI-IV-2a class labels, index-aligned with the model's logits.
CLASS_NAMES = ("left hand", "right hand", "feet", "tongue")


def bucket_ladder(max_batch: int,
                  base: tuple[int, ...] = DEFAULT_BUCKETS) -> tuple[int, ...]:
    """The default ladder capped at (and including) ``max_batch``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    return tuple(sorted({b for b in base if b < max_batch} | {max_batch}))


def load_model_from_checkpoint(path: str | Path, *,
                               device: torch.device | str | None = None
                               ) -> EEGNet:
    """An eval-mode EEGNet on ``device`` from a native ``.npz`` or a
    reference ``.pth``.  Native content integrity is verified by the
    loader."""
    path = Path(path)
    if path.suffix == ".pth":
        state_dict, meta = ckpt_lib.load_pth_auto(path)
    elif path.is_dir():
        raise ValueError(
            f"{path}: Orbax checkpoint directories are not ported to the "
            "torch package yet; export a native .npz or a .pth")
    else:
        state_dict, meta = ckpt_lib.load_checkpoint(path)
    if meta.get("model", "eegnet") != "eegnet":
        raise ValueError(
            f"{path}: a {meta['model']!r} checkpoint; the torch port serves "
            "EEGNet only")
    kwargs = {k: meta[k] for k in ("n_channels", "n_times", "F1", "D")
              if k in meta}
    model = EEGNet(**kwargs, device=device)
    model.load_state_dict(state_dict)
    return model


def variables_digest(params: Mapping, batch_stats: Mapping) -> str:
    """sha256 content digest of the served variables, over the flax-layout
    flat dict (``params/temporal_conv/kernel``, ...) — equal to the JAX
    package's ``variables_digest`` for the same weights, so ``/healthz``
    and ``/predict`` name the same model from either server."""
    return integrity.content_digest(
        ckpt_lib.flatten_variables(params, batch_stats))


class InferenceEngine:
    """A loaded model served over a ladder of padded batch buckets.

    ``infer(trials)`` pads each chunk to the smallest bucket that fits
    (chunking by the largest bucket first), runs the fused forward, and
    returns int64 class predictions for the real rows only.
    """

    def __init__(self, model: EEGNet,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                 device: torch.device | str | None = None):
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(
                f"buckets must be strictly increasing positive ints, got "
                f"{buckets!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(int(b) for b in buckets)
        self.precision = "fp32"
        self.digest = variables_digest(
            *ckpt_lib.to_jax_variables(self.model.state_dict()))
        with torch.inference_mode():
            self._block1 = fold_block1_params(self.model.state_dict(),
                                              self.model.bn_epsilon)
        self._lock = threading.Lock()
        self._warmed = False

    @classmethod
    def from_checkpoint(cls, path: str | Path,
                        buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                        device: torch.device | str | None = None
                        ) -> "InferenceEngine":
        """Load ``path`` and run every bucket once before the engine is
        handed out."""
        device = resolve_device(device)
        engine = cls(load_model_from_checkpoint(path, device=device),
                     buckets, device=device)
        engine.warmup()
        return engine

    @property
    def geometry(self) -> tuple[int, int]:
        """(n_channels, n_times) the engine accepts."""
        return self.model.n_channels, self.model.n_times

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (the largest bucket for oversize chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of one ``(n, C, T)`` batch already on the engine's device
        (no padding, no lock)."""
        with torch.inference_mode():
            return fused_eval_forward(self.model, x, self._block1)

    def warmup(self) -> dict[int, float]:
        """Run the forward once per bucket; returns bucket -> seconds.
        Idempotent."""
        walls: dict[int, float] = {}
        with self._lock:
            if self._warmed:
                return walls
            c, t = self.geometry
            for b in self.buckets:
                t0 = time.perf_counter()
                x = torch.zeros((b, c, t), device=self.device)
                self.forward(x).argmax(-1).cpu()
                walls[b] = time.perf_counter() - t0
            self._warmed = True
        logger.info("Engine warm on %s: buckets %s in %.2fs total (%s)",
                    self.device, self.buckets, sum(walls.values()),
                    self.digest[:12])
        return walls

    def infer(self, trials: np.ndarray) -> np.ndarray:
        """Class predictions for ``(n, C, T)`` trials (thread-safe)."""
        x = np.asarray(trials, np.float32)
        if x.ndim == 2:
            x = x[None]
        c, t = self.geometry
        if x.ndim != 3 or x.shape[1:] != (c, t):
            raise ValueError(
                f"expected trials shaped (n, {c}, {t}), got {x.shape}")
        n = len(x)
        if n == 0:
            return np.zeros(0, np.int64)
        out = np.empty(n, np.int64)
        top = self.buckets[-1]
        with self._lock:
            for start in range(0, n, top):
                chunk = x[start:start + top]
                k = len(chunk)
                b = self.bucket_for(k)
                if k < b:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], b - k, axis=0)])
                xt = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                    self.device)
                preds = self.forward(xt).argmax(-1).cpu().numpy()
                out[start:start + k] = preds[:k]
        return out
