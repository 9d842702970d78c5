"""Tenant-stacked serving engine and the stacked equivalence gate.

The counterpart of ``eegnetreplication_tpu/serve/zoo.py``.  The zoo
(``serve/registry.py::ModelZoo``) holds N models of one architecture (the
within-subject protocol's nine per-subject EEGNets); a
:class:`StackedEngine` serves a coalesced batch that mixes them with one
``block1_stacked`` launch per bucket chunk (``ops/stacked.py``), however
many tenants the batch holds.

On the card each bucket of a warm stacked engine is one captured CUDA
graph, as for the single-model engine, with a static tenant-index input
beside the static trials; the graph launches K1-stacked without its
device-side range check (``idx_checked``), since :meth:`StackedEngine.
infer` checks the tenant range on the host first.

A stack of baselines (ShallowConvNet, DeepConvNet) has no fused block 1:
each trial runs the model's plain stacked eval forward on its tenant's
gathered weights (one weight set per trial, the counterpart of the JAX
package's ``vmap`` over trials), int8 on kernels dequantized once.

A stacked engine serves only after :func:`run_stack_gate` found, for
every tenant, its argmax equal to that tenant's own fp32 engine on the
gate set: all of them at fp32 (:data:`STACK_FLOOR_FP32`), the quant floor
at int8.  A refusal is journaled and the zoo serves per-model engines.

:func:`parse_zoo_spec` and :func:`resolve_model_id` are the one
addressing path of ``serve --zoo`` and ``predict --zoo --model``, so both
resolve an id to the same checkpoint.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.ops import quant
from eegnetreplication_tpu_torch.ops import stacked as ops_stacked
from eegnetreplication_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    PRECISIONS,
    QUANT_AGREEMENT_FLOOR,
    InferenceEngine,
    _as_trials,
    _check_buckets,
    default_gate_set,
    variables_digest,
)
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training.steps import supports_fused_eval
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

# Per-tenant agreement floors of the stack gate: a stacked fp32 tenant
# computes what its own engine does, so every trial must agree; a stacked
# int8 tenant is held to the quant gate's floor.
STACK_FLOOR_FP32 = 1.0
STACK_FLOOR_INT8 = QUANT_AGREEMENT_FLOOR


def parse_zoo_spec(spec) -> dict[str, Path]:
    """``{model_id: checkpoint_path}`` from a mapping, a comma-separated
    ``id=path,id=path`` string, or a directory whose ``*.npz`` / ``*.pth``
    files become tenants keyed by file stem.  The order (insertion, or
    sorted names for a directory) is each tenant's index in the stack."""
    if hasattr(spec, "items"):
        out = {str(k): Path(v) for k, v in spec.items()}
    else:
        text = str(spec)
        p = Path(text)
        if "=" not in text and p.is_dir():
            out = {f.stem: f for f in sorted(
                list(p.glob("*.npz")) + list(p.glob("*.pth")))}
            if not out:
                raise ValueError(f"zoo directory {p} holds no .npz/.pth "
                                 "checkpoints")
        else:
            out = {}
            for part in text.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise ValueError(
                        f"zoo spec entry {part!r} is not id=path "
                        "(or pass a checkpoint directory)")
                mid, _, path = part.partition("=")
                mid = mid.strip()
                if not mid or not path.strip():
                    raise ValueError(f"zoo spec entry {part!r} has an "
                                     "empty id or path")
                if mid in out:
                    raise ValueError(f"duplicate zoo model id {mid!r}")
                out[mid] = Path(path.strip())
    if not out:
        raise ValueError("zoo spec names no models")
    return out


def looks_like_digest(spec: str) -> bool:
    """Whether a model spec reads as a variables-digest prefix (8 or more
    hex characters) rather than a tenant id."""
    return (len(spec) >= 8
            and all(ch in "0123456789abcdef" for ch in spec.lower()))


def resolve_model_id(tenant_ids: list[str], spec: str | None,
                     default_id: str,
                     digests: dict[str, str | None]) -> str:
    """``None``, ``""`` and ``"default"`` are the default tenant; an exact
    tenant id wins next, then a variables-digest prefix that matches one
    tenant whose digest is known.  Raises ``KeyError`` otherwise."""
    if spec is None or spec == "" or spec == "default":
        return default_id
    spec = str(spec)
    if spec in tenant_ids:
        return spec
    if looks_like_digest(spec):
        matches = [mid for mid in tenant_ids
                   if digests.get(mid) is not None
                   and digests[mid].startswith(spec.lower())]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise KeyError(f"digest prefix {spec!r} is ambiguous: "
                           f"{matches}")
    raise KeyError(f"unknown model {spec!r}; zoo tenants: {tenant_ids}")


class StackedEngine(InferenceEngine):
    """N congruent models behind one bucketed forward:
    ``infer(trials, tenant_idx)``.

    ``members`` are ``(model_id, model)`` pairs of one architecture;
    their ``state_dict``s stack along a tenant axis
    (:class:`~eegnetreplication_tpu_torch.ops.stacked.IncongruentTrees` if
    they cannot, before anything launches).  For EEGNets each bucket chunk
    is one ``block1_stacked`` launch and block 2 on per-trial gathered
    weights; a baseline's chunk is its stacked eval forward on per-trial
    gathered weights.  At int8 the stack is quantized per tenant and
    channel.
    """

    WHAT_PREFIX = "zoo_forward"

    def __init__(self, members: list[tuple[str, object]],
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                 precision: str = "fp32",
                 device: torch.device | str | None = None, journal=None):
        if not members:
            raise ValueError("a stacked engine needs at least one tenant")
        _check_buckets(buckets)
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.device = resolve_device(device)
        self.model = members[0][1]
        for mid, m in members[1:]:
            if (m.n_channels, m.n_times) != self.geometry:
                raise ops_stacked.IncongruentTrees(
                    f"tenant {mid!r} geometry ({m.n_channels}, "
                    f"{m.n_times}) != stack geometry {self.geometry}")
        states = [{k: v.detach().to(self.device)
                   for k, v in m.state_dict().items()} for _, m in members]
        stacked_state = ops_stacked.stack_trees(states)
        self.members = list(members)
        self.tenant_ids = [mid for mid, _ in members]
        self.buckets = tuple(int(b) for b in buckets)
        self.precision = precision
        trees = [ckpt_lib.to_jax_variables(s) for s in states]
        self.tenant_digests = {mid: variables_digest(*tree)
                               for mid, tree in zip(self.tenant_ids, trees)}
        stacked_params = ops_stacked.stack_trees([p for p, _ in trees])
        stacked_stats = ops_stacked.stack_trees([b for _, b in trees])
        # The digest of the whole stack (what /healthz shows); each
        # tenant's fp32 digest stays in tenant_digests.
        self.digest = variables_digest(stacked_params, stacked_stats)
        self.quantized_digest = None
        eps = self.model.bn_epsilon
        self._fused = supports_fused_eval(self.model)
        with torch.inference_mode():
            if precision == "int8":
                self.qparams = quant.quantize_params(stacked_params,
                                                     stacked=True)
                self.quantized_digest = quant.qparams_digest(self.qparams)
                if self._fused:
                    self._pack = quant.fold_quantized_eegnet(
                        self.qparams, stacked_stats, eps, device=self.device)
                else:
                    stacked_state = {
                        k: v.to(self.device)
                        for k, v in ckpt_lib.from_jax_variables_stacked(
                            quant.dequantize_params(self.qparams),
                            stacked_stats).items()}
            elif self._fused:
                self._pack = ops_stacked.fold_stacked_eegnet(stacked_state,
                                                             eps)
            if not self._fused:
                self._pack = {k: v for k, v in stacked_state.items()
                              if not k.endswith("num_batches_tracked")}
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._lock = threading.Lock()
        self._warmed = False
        self._graphs = {}
        self._stream = None

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_ids)

    def forward(self, x: torch.Tensor,
                tenant_idx: torch.Tensor | None = None, *,
                idx_checked: bool = False) -> torch.Tensor:
        """Logits of ``(n, C, T)`` trials on the engine's device, trial
        ``i`` through tenant ``tenant_idx[i]`` (int32; all tenant 0 when
        ``None``).  ``idx_checked``: the caller checked the range."""
        if tenant_idx is None:
            tenant_idx = torch.zeros(len(x), dtype=torch.int32,
                                     device=x.device)
        with torch.inference_mode():
            if not self._fused:
                # one weight set per trial: G = n sets of a batch of one
                per_trial = ops_stacked.gather_tree(self._pack,
                                                    tenant_idx.long())
                return self.model.stacked(per_trial, per_trial, x[:, None],
                                          train=False)[0][:, 0]
            if self.precision == "int8":
                return ops_stacked.stacked_quantized_eval_forward(
                    self._pack, x, tenant_idx, idx_checked=idx_checked)
            return ops_stacked.stacked_eval_forward(
                self._pack, x, tenant_idx, idx_checked=idx_checked)

    def _static_inputs(self, b: int) -> tuple[torch.Tensor, ...]:
        c, t = self.geometry
        return (torch.zeros((b, c, t), device=self.device),
                torch.zeros(b, dtype=torch.int32, device=self.device))

    def _graph_forward(self, x: torch.Tensor,
                       tenant_idx: torch.Tensor) -> torch.Tensor:
        # Every index a replay sees passed infer's host check.
        return self.forward(x, tenant_idx, idx_checked=True)

    def infer(self, trials: np.ndarray,
              tenant_idx: np.ndarray | int = 0) -> np.ndarray:
        """Class predictions for ``(n, C, T)`` trials whose row ``i``
        belongs to tenant ``tenant_idx[i]`` (a scalar broadcasts).  Padding
        repeats the last real row and its tenant; thread-safe."""
        x = _as_trials(trials, self.geometry)
        n = len(x)
        tid = np.broadcast_to(np.asarray(tenant_idx, np.int32), (n,)) \
            .astype(np.int32, copy=True)
        if n and (tid.min() < 0 or tid.max() >= self.n_tenants):
            raise ValueError(
                f"tenant index out of range [0, {self.n_tenants}): "
                f"{sorted(set(tid.tolist()))[:8]}")
        return self._infer_chunks(x, tid)


@dataclass(frozen=True)
class StackGateResult:
    """Outcome of one stacked-vs-unstacked per-tenant equivalence check."""

    outcome: str                      # "pass" | "refused"
    agreement: float                  # overall fraction of agreeing trials
    per_tenant: dict[str, float] = field(default_factory=dict)
    floor: float = STACK_FLOOR_FP32
    n_trials: int = 0
    precision: str = "fp32"
    gate_source: str = "synthetic"

    @property
    def passed(self) -> bool:
        return self.outcome == "pass"


def run_stack_gate(references: dict[str, InferenceEngine],
                   candidate: StackedEngine,
                   gate_set: list[tuple[str, np.ndarray]] | None = None, *,
                   floor: float | None = None,
                   journal=None) -> StackGateResult:
    """The check a stacked engine must pass before it serves.
    ``references`` maps each tenant id to its own fp32 engine; each
    tenant's gate trials run through both, and ANY tenant below the floor
    refuses the whole stack.  Journaled as a ``stack_gate`` event."""
    journal = journal if journal is not None else obs_journal.current()
    if floor is None:
        floor = (STACK_FLOOR_INT8 if candidate.precision == "int8"
                 else STACK_FLOOR_FP32)
    source = "caller"
    if gate_set is None:
        source, gate_set = default_gate_set(*candidate.geometry)
    per_tenant: dict[str, float] = {}
    agree_total = n_total = 0
    for z, mid in enumerate(candidate.tenant_ids):
        agree = n = 0
        for _, x in gate_set:
            ref = references[mid].infer(x)
            got = candidate.infer(x, np.full(len(x), z, np.int32))
            agree += int(np.sum(ref == got))
            n += len(x)
        per_tenant[mid] = agree / max(n, 1)
        agree_total += agree
        n_total += n
    agreement = agree_total / max(n_total, 1)
    outcome = "pass" if (n_total and
                         min(per_tenant.values()) >= floor) else "refused"
    result = StackGateResult(outcome=outcome, agreement=agreement,
                             per_tenant=per_tenant, floor=floor,
                             n_trials=n_total,
                             precision=candidate.precision,
                             gate_source=source)
    journal.event("stack_gate", precision=candidate.precision,
                  outcome=outcome, agreement=round(agreement, 6),
                  per_tenant={k: round(v, 6) for k, v in
                              per_tenant.items()},
                  floor=floor, n_trials=n_total, gate_source=source,
                  n_tenants=candidate.n_tenants,
                  digest=candidate.digest,
                  quantized_digest=candidate.quantized_digest)
    journal.metrics.set("stack_gate_agreement", agreement)
    (logger.info if outcome == "pass" else logger.warning)(
        "Stack gate %s: %s stacked vs unstacked fp32 argmax agreement "
        "%.4f over %d trials x %d tenants (%s, floor %.3f)",
        outcome.upper(), candidate.precision, agreement, n_total,
        candidate.n_tenants, source, floor)
    return result


def build_stacked_engine(members: list[tuple[str, object]],
                         buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                         precision: str = "fp32",
                         gate_set: list[tuple[str, np.ndarray]] | None
                         = None,
                         floor: float | None = None, warm: bool = True,
                         journal=None,
                         device: torch.device | str | None = None
                         ) -> tuple[StackedEngine | None, StackGateResult]:
    """Stack ``members`` (``(model_id, model)`` pairs), gate the stack
    per tenant against each tenant's own fp32 engine, warm it on a pass.
    Returns ``(engine, gate)``, ``engine`` ``None`` on a refusal.  Trees
    that cannot stack raise ``IncongruentTrees``; any other error
    propagates as it is."""
    t0 = time.perf_counter()
    candidate = StackedEngine(members, buckets, precision=precision,
                              device=device, journal=journal)
    references = {mid: InferenceEngine(model, buckets,
                                       device=candidate.device)
                  for mid, model in members}
    gate = run_stack_gate(references, candidate, gate_set, floor=floor,
                          journal=journal)
    if not gate.passed:
        logger.warning(
            "Stacked %s engine refused by the stack gate (min per-tenant "
            "agreement %.4f < floor %.3f); serving per-model engines",
            precision, min(gate.per_tenant.values(), default=0.0),
            gate.floor)
        return None, gate
    if warm:
        candidate.warmup()
    logger.info("Stacked %s engine over %d tenants ready in %.2fs "
                "(buckets %s)", precision, candidate.n_tenants,
                time.perf_counter() - t0, candidate.buckets)
    return candidate, gate
