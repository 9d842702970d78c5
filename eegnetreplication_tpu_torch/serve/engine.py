"""Inference engine: one checkpoint load, bucketed forwards on the card.

The counterpart of ``eegnetreplication_tpu/serve/engine.py``.  The engine
loads a checkpoint once (native ``.npz``, Orbax directory or reference
``.pth``), folds
block 1's weights once, and serves ``infer`` over a fixed ladder of padded
batch **buckets** (default 1/8/32/128), so an online batcher only ever
produces a handful of shapes.  Each bucket chunk is one forward: the
hand-written block-1 kernel (``ops/fused_eegnet.py::block1``, one launch)
followed by block 2 and the classifier as torch ops, then the argmax.

On the card each bucket's forward is one captured CUDA graph, the
counterpart of the JAX engine's one compiled program per bucket.
:meth:`InferenceEngine.warmup` runs each bucket once eagerly on the
engine's side stream (the cuDNN and cuBLAS handles, their workspaces and
the kernel libraries come up there) and then captures
``argmax(forward(static_x))`` into a ``torch.cuda.CUDAGraph`` with static
input and output tensors and a private memory pool, journaling
``compile_begin``/``compile``/``compile_end`` per bucket as the JAX engine
does.  ``infer`` copies each padded chunk into its bucket's static input,
replays, and copies the predictions out, all under the engine lock, so a
replay never overwrites a buffer another thread still reads.  A capture
or a replay that fails raises: a warmed engine on the card never runs its
forward eagerly.  An engine never warmed (the quant gate's fp32
reference) and a CPU engine run eagerly.  Graph replays count the
kernels they hold (``block1.launches``; the capture counts none) and
:data:`BucketGraph.replays`.

``precision="int8"`` serves per-channel int8 weights (``ops/quant.py``),
dequantized and folded once at build; block 1 still runs through K1.  An
int8 engine serves only after :func:`run_quant_gate` found its argmax
equal to the fp32 engine's on the gate set (:func:`default_gate_set`) for
at least :data:`QUANT_AGREEMENT_FLOOR` of every subject's trials;
:func:`build_gated_engine` is the one way the server and the ``predict``
CLI get an engine, so they reach the same verdict.

Any registered model serves.  Only EEGNet has the fused block 1: a
ShallowConvNet or DeepConvNet engine runs the model's plain eval forward
(at int8, on its kernels dequantized once at build, the JAX package's
generic dequantize-then-apply path), each bucket still one captured graph
on the card, and launches no hand kernel.

Padding rows repeat the last real trial and are dropped after the argmax:
an eval-mode model is row-independent, so padding never changes a real
trial's prediction.  ``infer`` is thread-safe: a lock serializes dispatch.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from eegnetreplication_tpu_torch.models import EEGNet, get_model
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.ops import quant
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    block1,
    block1_stacked,
    fold_block1_params,
    fused_eval_forward,
)
from eegnetreplication_tpu_torch.resil import integrity
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training import orbax_io
from eegnetreplication_tpu_torch.training.steps import supports_fused_eval
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.flops import eval_forward_flops
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
                               ) -> nn.Module:
    """An eval-mode model on ``device`` from a native ``.npz``, an Orbax
    checkpoint directory or a reference ``.pth``: the registry's model for
    the checkpoint's ``meta["model"]`` (EEGNet when absent, as in the JAX
    package).  Native content integrity is verified by the loader."""
    path = Path(path)
    if path.suffix == ".pth":
        state_dict, meta = ckpt_lib.load_pth_auto(path)
    elif path.is_dir():
        state_dict, meta = orbax_io.load_orbax_checkpoint(path)
    else:
        state_dict, meta = ckpt_lib.load_checkpoint(path)
    kwargs = {k: meta[k] for k in ("n_channels", "n_times", "F1", "D")
              if k in meta}
    name = meta.get("model", "eegnet")
    if name != "eegnet":
        model = get_model(name, device=device, **{
            k: v for k, v in kwargs.items() if k in ("n_channels",
                                                     "n_times")})
    else:
        model = EEGNet(**kwargs, device=device)
    model.load_state_dict(state_dict)
    return model.eval()


def variables_digest(params: Mapping, batch_stats: Mapping) -> str:
    """sha256 content digest of the served variables, over the flax-layout
    flat dict (``params/temporal_conv/kernel``, ...) — equal to the JAX
    package's ``variables_digest`` for the same weights, so ``/healthz``
    and ``/predict`` name the same model from either server."""
    return integrity.content_digest(
        ckpt_lib.flatten_variables(params, batch_stats))


def model_digest(model: nn.Module) -> str:
    """:func:`variables_digest` of a model's weights."""
    return variables_digest(*ckpt_lib.to_jax_variables(model.state_dict()))


# The hand-written kernels a captured forward may hold; a replay counts
# each one's captured launches (ops/fused_eegnet.py::count_launch).
_GRAPH_KERNELS = (block1, block1_stacked)


class BucketGraph:
    """One bucket's captured forward: the CUDA graph, its static inputs,
    its static logits and predictions, the kernel launches one replay
    runs, and what the capture cost."""

    # Graph replays in this process, every engine's (read by /healthz).
    replays = 0

    __slots__ = ("graph", "inputs", "logits", "preds", "launches",
                 "capture_s", "pool_bytes")

    def __init__(self, graph, inputs, logits, preds, launches, capture_s,
                 pool_bytes):
        self.graph = graph
        self.inputs = inputs
        self.logits = logits
        self.preds = preds
        self.launches = launches     # ((kernel wrapper, count), ...)
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes

    def replay(self, *arrays) -> None:
        """Copy ``arrays`` into the static inputs and replay (caller holds
        the engine lock)."""
        for static, a in zip(self.inputs, arrays):
            static.copy_(torch.as_tensor(a))
        self.graph.replay()
        for fn, n in self.launches:
            fn.launches += n
        BucketGraph.replays += 1

    def stats(self) -> dict:
        return {"capture_s": round(self.capture_s, 6),
                "pool_bytes": int(self.pool_bytes),
                "kernels": {fn.__name__: n for fn, n in self.launches}}


def _end_failed_capture(graph) -> None:
    """End a capture whose forward raised, so the stream leaves capture
    mode; the capture's own error is the one that propagates."""
    try:
        graph.capture_end()
    except Exception:  # noqa: BLE001 — the forward's error is reported
        pass


class InferenceEngine:
    """A loaded model served over a ladder of padded batch buckets.

    ``infer(trials)`` pads each chunk to the smallest bucket that fits
    (chunking by the largest bucket first), runs the bucket's forward (its
    graph on the card once warm), and returns int64 class predictions for
    the real rows only.
    """

    # The JAX engine's program names: serve_forward[_int8]_b{bucket}.
    WHAT_PREFIX = "serve_forward"

    def __init__(self, model: nn.Module,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                 device: torch.device | str | None = None,
                 precision: str = "fp32", digest: str | None = None,
                 journal=None):
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
        self._fused = supports_fused_eval(self.model)
        self._plain = self.model
        with torch.inference_mode():
            if precision == "int8":
                self.qparams = quant.quantize_params(params)
                self.quantized_digest = quant.qparams_digest(self.qparams)
                if self._fused:
                    self._qpack = quant.fold_quantized_eegnet(
                        self.qparams, batch_stats, self.model.bn_epsilon,
                        device=self.device)
                else:
                    self._plain = dequantized_model(self.model, self.qparams,
                                                    batch_stats)
            elif self._fused:
                self._block1 = fold_block1_params(self.model.state_dict(),
                                                  self.model.bn_epsilon)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._lock = threading.Lock()
        self._warmed = False
        self._graphs: dict[int, BucketGraph] = {}
        self._stream = None          # the capture stream, made at warmup

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
            if not self._fused:
                return self._plain(x)
            if self.precision == "int8":
                return quant.quantized_eval_forward(self._qpack, x)
            return fused_eval_forward(self.model, x, self._block1)

    def _static_inputs(self, b: int) -> tuple[torch.Tensor, ...]:
        """A bucket's input tensors, zeroed (the graph's static inputs)."""
        c, t = self.geometry
        return (torch.zeros((b, c, t), device=self.device),)

    def _graph_forward(self, *args) -> torch.Tensor:
        """The forward a graph captures (no host wait inside)."""
        return self.forward(*args)

    def warmup(self) -> dict[int, float]:
        """Warm every bucket; returns bucket -> seconds.  On the card: an
        eager run on the capture stream, then the capture of the bucket's
        graph (a capture error raises).  On the CPU: one eager run.
        Journals ``compile_begin``/``compile``/``compile_end`` and
        observes ``compile_seconds`` per bucket.  Idempotent."""
        walls: dict[int, float] = {}
        with self._lock:
            if self._warmed:
                return walls
            tag = "" if self.precision == "fp32" else f"_{self.precision}"
            for b in self.buckets:
                what = f"{self.WHAT_PREFIX}{tag}_b{b}"
                self._journal.event("compile_begin", what=what)
                t0 = time.perf_counter()
                graph = None
                if self.device.type == "cuda":
                    try:
                        graph = self._graphs[b] = self._capture(b)
                    except BaseException:
                        self._graphs.clear()   # no half-graphed ladder
                        raise
                else:
                    with torch.inference_mode():
                        self.forward(*self._static_inputs(b)).argmax(-1)
                wall = time.perf_counter() - t0
                walls[b] = wall
                self._journal.event(
                    "compile", what=what, cache_hit=None, cache_dir=None,
                    elapsed_s=round(wall, 3),
                    flops=eval_forward_flops(self.model, b),
                    bytes_accessed=None,
                    **(graph.stats() if graph is not None else {}))
                self._journal.event("compile_end", what=what,
                                    elapsed_s=round(wall, 3),
                                    includes_execution=True, cache_hit=None)
                self._journal.metrics.observe("compile_seconds", wall,
                                              what=what)
            self._warmed = True
        logger.info("Engine warm on %s: buckets %s in %.2fs total (%s, %s%s)",
                    self.device, self.buckets, sum(walls.values()),
                    self.precision, self.digest[:12],
                    ", CUDA graphs" if self._graphs else "")
        return walls

    def _capture(self, b: int) -> BucketGraph:
        """Bucket ``b``'s graph: an eager run on the engine's capture
        stream, then the capture in ``thread_local`` mode, so the other
        threads' launches, copies and syncs (the batcher replaying the
        live engine, session pushes) go on meanwhile."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        inputs = self._static_inputs(b)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream), \
                torch.inference_mode():
            self._graph_forward(*inputs).argmax(-1)
            stream.synchronize()
            before = [fn.captured for fn in _GRAPH_KERNELS]
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                logits = self._graph_forward(*inputs)
                preds = logits.argmax(-1)
            except BaseException:
                _end_failed_capture(graph)
                raise
            graph.capture_end()
            capture_s = time.perf_counter() - t0
        torch.cuda.current_stream(dev).wait_stream(stream)
        launches = tuple((fn, fn.captured - n)
                         for fn, n in zip(_GRAPH_KERNELS, before)
                         if fn.captured != n)
        return BucketGraph(graph, inputs, logits, preds, launches, capture_s,
                           torch.cuda.memory_reserved(dev) - reserved)

    def graph_stats(self) -> dict[int, dict]:
        """Per bucket: the capture's wall, the bytes its memory pool
        reserved and the kernels one replay launches (empty on the CPU or
        before warmup)."""
        return {b: g.stats() for b, g in self._graphs.items()}

    def graph_logits(self, *args: torch.Tensor) -> torch.Tensor:
        """Logits of one full bucket through its graph: ``args`` are the
        forward's inputs on the card, their length a bucket (a copy)."""
        with self._lock:
            g = self._graphs[len(args[0])]
            g.replay(*args)
            return g.logits.clone()

    def infer(self, trials: np.ndarray) -> np.ndarray:
        """Class predictions for ``(n, C, T)`` trials (thread-safe)."""
        return self._infer_chunks(_as_trials(trials, self.geometry))

    def _run_bucket(self, b: int, arrays: list[np.ndarray]) -> np.ndarray:
        """Predictions of one padded chunk (``b`` rows): its graph's replay
        once warm on the card, else the eager forward.  Caller holds the
        lock."""
        g = self._graphs.get(b)
        if g is not None:
            g.replay(*arrays)
            return g.preds.cpu().numpy()
        args = [torch.from_numpy(a).to(self.device) for a in arrays]
        with torch.inference_mode():
            return self.forward(*args).argmax(-1).cpu().numpy()

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
                # The engine-forward span (a child of the batcher's batch
                # span) carries the padding picture.
                with trace.span("engine.forward", journal=self._journal,
                                bucket=b, n_real=k, padded=b - k,
                                precision=self.precision):
                    # Padding repeats the last real row (and its tenant).
                    arrays = [np.ascontiguousarray(
                        np.concatenate([c, np.repeat(c[-1:], b - k, axis=0)])
                        if k < b else c) for c in chunks]
                    preds = self._run_bucket(b, arrays)
                out[start:start + k] = preds[:k]
                self._journal.metrics.observe("bucket_fill", k / b,
                                              bucket=str(b))
        return out


def dequantized_model(model: nn.Module, qparams: Mapping,
                      batch_stats: Mapping) -> nn.Module:
    """A copy of ``model`` holding its int8 kernels dequantized (the JAX
    package's int8 path for a model without a specialized schedule)."""
    plain = copy.deepcopy(model)
    plain.load_state_dict(ckpt_lib.from_jax_variables(
        quant.dequantize_params(qparams), batch_stats))
    return plain.eval()


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


def build_gated_engine(model: nn.Module,
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
    fp32 = InferenceEngine(model, buckets, device=device, journal=journal)
    if precision == "fp32":
        if warm:
            fp32.warmup()
        return fp32, None
    int8 = InferenceEngine(model, buckets, device=fp32.device,
                           precision="int8", digest=fp32.digest,
                           journal=journal)
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
