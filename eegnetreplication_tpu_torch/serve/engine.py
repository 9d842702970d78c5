"""Inference engine: one checkpoint load, bucketed forwards on the card.

The counterpart of ``eegnetreplication_tpu/serve/engine.py``.  The engine
loads a checkpoint once (native ``.npz`` or reference ``.pth``), folds
block 1's weights once, and serves ``infer`` over a fixed ladder of padded
batch **buckets** (default 1/8/32/128), so an online batcher only ever
produces a handful of shapes.  Each bucket chunk is one forward: the
hand-written block-1 kernel (``ops/fused_eegnet.py::block1``, one launch)
followed by block 2 and the classifier as torch ops.

``precision="int8"`` serves per-channel int8 weights (``ops/quant.py``),
dequantized and folded once at build; block 1 still runs through K1.  An
int8 engine serves only after :func:`run_quant_gate` found its argmax
equal to the fp32 engine's on the gate set (:func:`default_gate_set`) for
at least :data:`QUANT_AGREEMENT_FLOOR` of every subject's trials;
:func:`build_gated_engine` is the one way the server and the ``predict``
CLI get an engine, so they reach the same verdict.

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
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.ops import quant
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    fold_block1_params,
    fused_eval_forward,
)
from eegnetreplication_tpu_torch.resil import integrity
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

DEFAULT_BUCKETS = (1, 8, 32, 128)

# Engine weight precisions: fp32 is the reference; int8 serves per-channel
# quantized kernels (ops/quant.py) behind the equivalence gate.
PRECISIONS = ("fp32", "int8")

# Minimum per-subject int8-vs-fp32 argmax agreement for an int8 engine to
# serve; below it serving keeps fp32.
QUANT_AGREEMENT_FLOOR = 0.99

# Gate-set size when no processed Eval session is on disk (seeded
# synthetic trials, so the CLI and the server reach the same verdict).
QUANT_GATE_N = 256

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
            "torch package (ROADMAP.md queue A.1.iv: Orbax's "
            "StandardCheckpointer writes tensorstore's format, which needs "
            "JAX, and the card's machine has none); export a native .npz "
            "or a .pth")
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


def model_digest(model: EEGNet) -> str:
    """:func:`variables_digest` of a model's weights."""
    return variables_digest(*ckpt_lib.to_jax_variables(model.state_dict()))


class InferenceEngine:
    """A loaded model served over a ladder of padded batch buckets.

    ``infer(trials)`` pads each chunk to the smallest bucket that fits
    (chunking by the largest bucket first), runs the fused forward, and
    returns int64 class predictions for the real rows only.
    """

    def __init__(self, model: EEGNet,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                 device: torch.device | str | None = None,
                 precision: str = "fp32", digest: str | None = None):
        _check_buckets(buckets)
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(int(b) for b in buckets)
        self.precision = precision
        params, batch_stats = ckpt_lib.to_jax_variables(
            self.model.state_dict())
        # The fp32 variables digest at both precisions: int8 is an encoding
        # of the same weights, named apart by quantized_digest.
        self.digest = digest or variables_digest(params, batch_stats)
        self.quantized_digest: str | None = None
        with torch.inference_mode():
            if precision == "int8":
                self.qparams = quant.quantize_params(params)
                self.quantized_digest = quant.qparams_digest(self.qparams)
                self._qpack = quant.fold_quantized_eegnet(
                    self.qparams, batch_stats, self.model.bn_epsilon,
                    device=self.device)
            else:
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
            if self.precision == "int8":
                return quant.quantized_eval_forward(self._qpack, x)
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
        logger.info("Engine warm on %s: buckets %s in %.2fs total (%s, %s)",
                    self.device, self.buckets, sum(walls.values()),
                    self.precision, self.digest[:12])
        return walls

    def infer(self, trials: np.ndarray) -> np.ndarray:
        """Class predictions for ``(n, C, T)`` trials (thread-safe)."""
        return self._infer_chunks(_as_trials(trials, self.geometry))

    def _infer_chunks(self, x: np.ndarray,
                      extra: np.ndarray | None = None) -> np.ndarray:
        """Argmax of ``forward`` over bucket chunks of ``x``; ``extra`` (a
        per-trial vector, the stacked engine's tenant index) is chunked
        and padded beside it and passed on as a second argument."""
        n = len(x)
        if n == 0:
            return np.zeros(0, np.int64)
        out = np.empty(n, np.int64)
        top = self.buckets[-1]
        with self._lock:
            for start in range(0, n, top):
                chunks = [x[start:start + top]]
                if extra is not None:
                    chunks.append(extra[start:start + top])
                k = len(chunks[0])
                b = self.bucket_for(k)
                # Padding repeats the last real row (and its tenant).
                args = [torch.from_numpy(np.ascontiguousarray(
                    np.concatenate([c, np.repeat(c[-1:], b - k, axis=0)])
                    if k < b else c)).to(self.device) for c in chunks]
                preds = self.forward(*args).argmax(-1).cpu().numpy()
                out[start:start + k] = preds[:k]
        return out


def _check_buckets(buckets) -> None:
    if not buckets or list(buckets) != sorted(set(buckets)) \
            or buckets[0] < 1:
        raise ValueError(
            f"buckets must be strictly increasing positive ints, got "
            f"{buckets!r}")


def _as_trials(trials, geometry: tuple[int, int]) -> np.ndarray:
    """``trials`` as float32 ``(n, C, T)`` (one ``(C, T)`` trial gains the
    leading axis); raises on another geometry."""
    x = np.asarray(trials, np.float32)
    if x.ndim == 2:
        x = x[None]
    c, t = geometry
    if x.ndim != 3 or x.shape[1:] != (c, t):
        raise ValueError(
            f"expected trials shaped (n, {c}, {t}), got {x.shape}")
    return x


# ---------------------------------------------------------------------------
# The int8 equivalence gate.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuantGateResult:
    """Outcome of one fp32-vs-int8 argmax equivalence check."""

    outcome: str                      # "pass" | "refused"
    agreement: float                  # overall fraction of agreeing trials
    per_subject: dict[str, float] = field(default_factory=dict)
    floor: float = QUANT_AGREEMENT_FLOOR
    n_trials: int = 0
    gate_source: str = "synthetic"    # "bci_iv_2a_eval" or "synthetic"

    @property
    def passed(self) -> bool:
        return self.outcome == "pass"


def default_gate_set(n_channels: int, n_times: int, *,
                     n_synthetic: int = QUANT_GATE_N
                     ) -> tuple[str, list[tuple[str, np.ndarray]]]:
    """The gate set: every processed BCI-IV-2a Eval session on disk of
    this geometry (one entry per subject), else ``n_synthetic`` seeded
    synthetic trials, the same bytes as the JAX package's."""
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset

    subjects: list[tuple[str, np.ndarray]] = []
    for subject in range(1, 10):
        try:
            ds = load_subject_dataset(subject=subject, mode="Eval")
        except FileNotFoundError:
            continue
        x = np.asarray(ds.X, np.float32)
        if x.ndim == 3 and x.shape[1:] == (n_channels, n_times):
            subjects.append((f"A{subject:02d}E", x))
    if subjects:
        return "bci_iv_2a_eval", subjects
    rng = np.random.RandomState(20260804)
    return "synthetic", [("synthetic", rng.randn(
        n_synthetic, n_channels, n_times).astype(np.float32))]


def run_quant_gate(reference: InferenceEngine, candidate: InferenceEngine,
                   gate_set: list[tuple[str, np.ndarray]] | None = None, *,
                   floor: float = QUANT_AGREEMENT_FLOOR,
                   journal=None) -> QuantGateResult:
    """The check an int8 engine must pass before it serves: both engines'
    argmax over every gate subject; any subject below ``floor`` refuses.
    The verdict is journaled as a ``quant_gate`` event either way."""
    journal = journal if journal is not None else obs_journal.current()
    source = "caller"
    if gate_set is None:
        source, gate_set = default_gate_set(*reference.geometry)
    per_subject: dict[str, float] = {}
    agree_total = n_total = 0
    for subject, x in gate_set:
        ref = reference.infer(x)
        got = candidate.infer(x)
        per_subject[subject] = float(np.mean(ref == got))
        agree_total += int(np.sum(ref == got))
        n_total += len(x)
    agreement = agree_total / max(n_total, 1)
    outcome = "pass" if (n_total and
                         min(per_subject.values()) >= floor) else "refused"
    result = QuantGateResult(outcome=outcome, agreement=agreement,
                             per_subject=per_subject, floor=floor,
                             n_trials=n_total, gate_source=source)
    journal.event("quant_gate", precision=candidate.precision,
                  outcome=outcome, agreement=round(agreement, 6),
                  per_subject={k: round(v, 6)
                               for k, v in per_subject.items()},
                  floor=floor, n_trials=n_total, gate_source=source,
                  digest=candidate.digest,
                  quantized_digest=candidate.quantized_digest)
    journal.metrics.set("quant_gate_agreement", agreement)
    (logger.info if outcome == "pass" else logger.warning)(
        "Quant gate %s: int8 vs fp32 argmax agreement %.4f over %d trials "
        "(%s, floor %.3f)", outcome.upper(), agreement, n_total, source,
        floor)
    return result


def build_gated_engine(model: EEGNet,
                       buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                       precision: str = "fp32",
                       floor: float = QUANT_AGREEMENT_FLOOR,
                       gate_set: list[tuple[str, np.ndarray]] | None = None,
                       warm: bool = True, journal=None,
                       device: torch.device | str | None = None
                       ) -> tuple[InferenceEngine, QuantGateResult | None]:
    """The engine at ``precision``, the one way the server and the
    ``predict`` CLI get one.  fp32 returns directly; int8 builds the fp32
    engine beside it, runs :func:`run_quant_gate` and returns the int8
    engine on a pass, else the fp32 one."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    fp32 = InferenceEngine(model, buckets, device=device)
    if precision == "fp32":
        if warm:
            fp32.warmup()
        return fp32, None
    int8 = InferenceEngine(model, buckets, device=fp32.device,
                           precision="int8", digest=fp32.digest)
    gate = run_quant_gate(fp32, int8, gate_set, floor=floor,
                          journal=journal)
    chosen = int8 if gate.passed else fp32
    if not gate.passed:
        logger.warning("int8 engine refused by the quant gate "
                       "(agreement %.4f < floor %.3f on %s); serving fp32",
                       min(gate.per_subject.values(), default=0.0),
                       gate.floor, gate.gate_source)
    if warm:
        chosen.warmup()
    return chosen, gate
