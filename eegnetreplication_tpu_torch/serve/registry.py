"""Model registry and zoo: hot reload without a dropped request, N tenants.

The counterpart of ``eegnetreplication_tpu/serve/registry.py``.
:class:`ModelRegistry` holds the live engine behind a lock; ``reload``
builds the incoming engine entirely off to the side (checkpoint load with
its content digest verified, the quant gate at int8, the warmup of every
bucket) and only then swaps the reference.  A request that took the old
engine finishes on it, so a swap under load drops nothing.  A reload of a
corrupt or missing checkpoint raises and leaves the current engine serving.
Each swap is journaled as a ``model_swap`` event with both digests.
``retune`` moves the live engine onto a new bucket ladder the same way
(the ladder tuner's primitive): same weights, no gate, the new engine's
graphs captured off the hot path before the swap; a reload lands on the
ladder in force.

:class:`ModelZoo` serves N tenants from one process.  Requests address a
tenant by id, by a variables-digest prefix, or not at all (the default).
Each tenant's model stays resident; per-model engines materialize on
demand and evict least-recently-used past ``max_programs``
(``model_load`` / ``model_evict``).  When the tenants stack, one
:class:`~eegnetreplication_tpu_torch.serve.zoo.StackedEngine` serves every
mixed-tenant batch, gated per tenant; ``reload`` of one tenant builds and
gates the new stack off to the side and swaps it in (``zoo_restack``).
Online adaptation registers a tenant's candidate as a non-serving shadow
(``register_shadow``, ``shadow_infer``, ``shadow_digest``,
``drop_shadow``): a bucket-1 fp32 engine outside the stack, the LRU budget
and request addressing.

One departure from the JAX zoo: its restack turns ANY exception into
per-model serving.  Here only trees that cannot stack
(:class:`~eegnetreplication_tpu_torch.ops.stacked.IncongruentTrees`) do;
any other error (a K1 build or launch failure among them) is journaled and
raised, so a kernel fault cannot hide behind per-model serving.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.ops.stacked import IncongruentTrees
from eegnetreplication_tpu_torch.serve.engine import (
    DEFAULT_BUCKETS,
    QUANT_AGREEMENT_FLOOR,
    InferenceEngine,
    QuantGateResult,
    build_gated_engine,
    load_model_from_checkpoint,
    model_digest,
)
from eegnetreplication_tpu_torch.serve.zoo import (
    StackedEngine,
    build_stacked_engine,
    parse_zoo_spec,
    resolve_model_id,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger


class ModelRegistry:
    """Holds the live engine: ``load`` once at startup, ``reload`` to swap.

    ``precision="int8"`` builds every engine through the quant gate
    (``serve/engine.py::build_gated_engine``); ``serving_precision`` says
    which precision answers.
    """

    def __init__(self, buckets: tuple[int, ...] = DEFAULT_BUCKETS, *,
                 precision: str = "fp32",
                 quant_floor: float = QUANT_AGREEMENT_FLOOR,
                 gate_set=None, journal=None,
                 device: torch.device | str | None = None):
        self.buckets = tuple(buckets)
        self.precision = precision          # requested
        self.quant_floor = float(quant_floor)
        self._gate_set = gate_set           # None: default_gate_set
        self.device = resolve_device(device)
        self.last_gate: QuantGateResult | None = None
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._lock = threading.Lock()
        self._engine: InferenceEngine | None = None
        self._swaps = 0
        self._retunes = 0
        # Two reloads (or retunes) must not interleave their builds and
        # swaps.
        self._reload_lock = threading.Lock()

    @property
    def engine(self) -> InferenceEngine:
        with self._lock:
            if self._engine is None:
                raise RuntimeError("registry has no model loaded yet")
            return self._engine

    @property
    def swaps(self) -> int:
        with self._lock:
            return self._swaps

    @property
    def retunes(self) -> int:
        with self._lock:
            return self._retunes

    @property
    def active_buckets(self) -> tuple[int, ...]:
        """The live ladder (what the tuner reads)."""
        return self.engine.buckets

    @property
    def serving_precision(self) -> str:
        """The precision answering requests (fp32 when the quant gate
        refused int8)."""
        return self.engine.precision

    @property
    def geometry(self) -> tuple[int, int]:
        return self.engine.geometry

    @property
    def digest(self) -> str:
        return self.engine.digest

    def _build(self, checkpoint: str | Path, buckets: tuple[int, ...],
               warm: bool) -> InferenceEngine:
        model = load_model_from_checkpoint(checkpoint, device=self.device)
        engine, gate = build_gated_engine(
            model, buckets, precision=self.precision,
            floor=self.quant_floor, gate_set=self._gate_set, warm=warm,
            journal=self._journal, device=self.device)
        self.last_gate = gate
        return engine

    def load(self, checkpoint: str | Path, *, warm: bool = True
             ) -> InferenceEngine:
        """Initial load (no swap event); returns the live engine."""
        engine = self._build(checkpoint, self.buckets, warm)
        with self._lock:
            self._engine = engine
        logger.info("Registry serving %s (digest %s, %s)", checkpoint,
                    engine.digest[:12], engine.precision)
        return engine

    def reload(self, checkpoint: str | Path, *, warm: bool = True
               ) -> InferenceEngine:
        """Build and warm an engine from ``checkpoint``, then swap it in.
        Raises (``IntegrityError``, ``FileNotFoundError``, a geometry
        ``ValueError``, ...) without touching the current engine."""
        with self._reload_lock:
            t0 = time.perf_counter()
            with self._lock:
                buckets = (self._engine.buckets if self._engine is not None
                           else self.buckets)
            engine = self._build(checkpoint, buckets, warm)
            with self._lock:
                # Requests already validated against the live geometry
                # must stay servable after the swap.
                if (self._engine is not None
                        and engine.geometry != self._engine.geometry):
                    raise ValueError(
                        f"hot-reload geometry mismatch: serving "
                        f"{self._engine.geometry}, checkpoint {checkpoint} "
                        f"is {engine.geometry}; restart the service to "
                        "change model geometry")
                old, self._engine = self._engine, engine
                self._swaps += 1
            wall = time.perf_counter() - t0
            self._journal.event(
                "model_swap", checkpoint=str(checkpoint),
                digest=engine.digest,
                previous_digest=old.digest if old is not None else None,
                precision=engine.precision, elapsed_s=round(wall, 3))
            self._journal.metrics.inc("model_swaps")
            logger.info("Model swapped in %.2fs: %s -> %s", wall,
                        old.digest[:12] if old is not None else "none",
                        engine.digest[:12])
            return engine

    def retune(self, buckets: tuple[int, ...], *, warm: bool = True
               ) -> InferenceEngine:
        """Swap the live engine onto a new bucket ladder: same weights,
        precision and digest.  The new engine is built and its graphs
        captured off the hot path, then the reference swaps under the
        lock; a capture error raises with the old engine serving.  No
        gate re-runs (the ladder changes the padding, not the numerics).
        The caller journals ``ladder_retune``."""
        with self._reload_lock:
            current = self.engine
            engine = InferenceEngine(
                current.model, tuple(buckets), device=current.device,
                precision=current.precision, digest=current.digest,
                journal=self._journal)
            if warm:
                engine.warmup()
            with self._lock:
                self._engine = engine
                self._retunes += 1
            return engine

    def infer(self, trials: np.ndarray) -> np.ndarray:
        """One batch through the CURRENT engine: the reference is taken
        under the lock and the forward runs outside it, so a swap landing
        mid-forward leaves this batch on the old engine."""
        return self.engine.infer(trials)


class _ZooEntry:
    """One tenant: checkpoint, loaded model, resident engine."""

    __slots__ = ("model_id", "checkpoint", "model", "digest", "engine",
                 "serving_precision", "last_used", "loads", "evictions")

    def __init__(self, model_id: str, checkpoint: Path):
        self.model_id = model_id
        self.checkpoint = Path(checkpoint)
        self.model = None            # set on first load
        self.digest: str | None = None
        self.engine: InferenceEngine | None = None   # resident when set
        self.serving_precision: str | None = None
        self.last_used = 0.0         # monotonic; the LRU key
        self.loads = 0
        self.evictions = 0


class ModelZoo:
    """N addressable tenants, one hot path.

    Every tenant's model stays resident (an EEGNet is tens of KB); per-model
    engines are the budgeted resource: each holds ``len(buckets)`` warm
    bucket programs, and past ``max_programs`` (0: no limit) the least
    recently used engine evicts.  With ``stack=True`` and congruent
    tenants one gated :class:`StackedEngine` serves every batch and
    per-model engines exist only when the stack is refused or off.
    """

    def __init__(self, checkpoints, *, default: str | None = None,
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 precision: str = "fp32",
                 quant_floor: float = QUANT_AGREEMENT_FLOOR,
                 gate_set=None, max_programs: int = 0, stack: bool = True,
                 warm: bool = True, journal=None,
                 device: torch.device | str | None = None):
        mapping = parse_zoo_spec(checkpoints)
        self.tenant_ids: list[str] = list(mapping)
        self.default_id = str(default) if default is not None \
            else self.tenant_ids[0]
        if self.default_id not in mapping:
            raise ValueError(f"default model {self.default_id!r} is not a "
                             f"zoo tenant (have {self.tenant_ids})")
        self.buckets = tuple(buckets)
        self.precision = precision          # requested
        self.quant_floor = float(quant_floor)
        self._gate_set = gate_set
        self.max_programs = int(max_programs)
        self.stack_requested = bool(stack)
        self.device = resolve_device(device)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._entries = {mid: _ZooEntry(mid, path)
                         for mid, path in mapping.items()}
        self._lock = threading.Lock()         # entries and LRU bookkeeping
        self._build_lock = threading.Lock()   # serializes engine builds
        self._reload_lock = threading.Lock()  # serializes reload/restack
        self._stacked = None                  # the one-launch hot path
        # Non-serving shadow candidates (online adaptation): tenant id ->
        # (engine, digest), outside tenant_ids, the stack and the LRU
        # budget, so no request can address one.
        self._shadows: dict[str, tuple[InferenceEngine, str]] = {}
        self.last_stack_gate = None
        self.last_gate: QuantGateResult | None = None
        self._swaps = 0
        self._restacks = 0
        self._retunes = 0
        if self.stack_requested:
            with self._build_lock:
                for entry in self._entries.values():
                    self._load_model(entry)
            self._restack(self._members(), reason="initial", warm=warm)
        if self._stacked is None:
            # Per-model serving: the default tenant is built now so the
            # first request is not answered cold.
            self.materialize(self.default_id, warm=warm)

    # -- addressing --------------------------------------------------------
    @property
    def n_tenants(self) -> int:
        return len(self.tenant_ids)

    def tenant_index(self, model_id: str) -> int:
        try:
            return self.tenant_ids.index(model_id)
        except ValueError:
            raise KeyError(f"unknown model {model_id!r}; zoo tenants: "
                           f"{self.tenant_ids}") from None

    def checkpoint_for(self, model_id: str) -> Path:
        return self._entries[model_id].checkpoint

    def digest_for(self, model_id: str) -> str | None:
        """The digest of the weights answering this tenant now: the live
        stack's slice while it serves, else the tenant's own."""
        stacked = self._stacked
        if stacked is not None and model_id in stacked.tenant_digests:
            return stacked.tenant_digests[model_id]
        return self._entries[model_id].digest

    def resolve(self, spec: str | None) -> str:
        """A request's model spec -> tenant id (the resolver the predict
        CLI shares)."""
        return resolve_model_id(
            self.tenant_ids, spec, self.default_id,
            {mid: self._entries[mid].digest for mid in self.tenant_ids})

    # -- the program budget ------------------------------------------------
    def _resident_programs_locked(self) -> int:
        return sum(len(e.engine.buckets) for e in self._entries.values()
                   if e.engine is not None)

    def _evict_over_budget_locked(self) -> None:
        """Drop least-recently-used engines until within ``max_programs``;
        the most recently used one always stays."""
        if self.max_programs <= 0:
            return
        while self._resident_programs_locked() > self.max_programs:
            resident = sorted(
                (e for e in self._entries.values() if e.engine is not None),
                key=lambda e: e.last_used)
            if len(resident) <= 1:
                return
            victim = resident[0]
            freed = len(victim.engine.buckets)
            victim.engine = None
            victim.evictions += 1
            self._journal.event("model_evict", model=victim.model_id,
                                reason="program_budget",
                                freed_programs=freed,
                                resident_programs=
                                self._resident_programs_locked())
            self._journal.metrics.inc("zoo_evictions")
            logger.info("Zoo evicted %s (LRU, freed %d programs)",
                        victim.model_id, freed)

    # -- loading -----------------------------------------------------------
    def _load_model(self, entry: _ZooEntry) -> None:
        """Load a tenant's model once (caller holds ``_build_lock``).
        Every tenant must share one geometry: requests are validated
        against one (C, T)."""
        if entry.model is not None:
            return
        model = load_model_from_checkpoint(entry.checkpoint,
                                           device=self.device)
        self._check_geometry(model, entry.model_id)
        entry.model = model
        entry.digest = model_digest(model)

    def _check_geometry(self, model, model_id: str) -> None:
        for other in self._entries.values():
            if other.model is not None and other.model_id != model_id and \
                    (other.model.n_channels, other.model.n_times) != \
                    (model.n_channels, model.n_times):
                raise ValueError(
                    f"zoo tenants must share one geometry: {model_id} is "
                    f"({model.n_channels}, {model.n_times}) but "
                    f"{other.model_id} is ({other.model.n_channels}, "
                    f"{other.model.n_times}); serve mixed geometries from "
                    "separate processes")

    def materialize(self, model_id: str,
                    warm: bool = False) -> InferenceEngine:
        """The tenant's own engine, built on demand (gated at the
        requested precision), evicting past the program budget."""
        entry = self._entries[model_id]
        with self._lock:
            entry.last_used = time.monotonic()
            engine = entry.engine
        if engine is None:
            with self._build_lock:
                with self._lock:
                    engine = entry.engine
                if engine is None:
                    engine = self._build_entry_engine(entry, warm)
        if warm:
            engine.warmup()   # a no-op once warm
        return engine

    def _build_entry_engine(self, entry: _ZooEntry,
                            warm: bool) -> InferenceEngine:
        t0 = time.perf_counter()
        self._load_model(entry)
        engine, gate = build_gated_engine(
            entry.model, self.buckets, precision=self.precision,
            floor=self.quant_floor, gate_set=self._gate_set, warm=warm,
            journal=self._journal, device=self.device)
        self.last_gate = gate
        entry.serving_precision = engine.precision
        with self._lock:
            entry.engine = engine
            entry.last_used = time.monotonic()
            entry.loads += 1
            self._evict_over_budget_locked()
            resident = self._resident_programs_locked()
        self._journal.event(
            "model_load", model=entry.model_id, digest=engine.digest,
            precision=engine.precision, checkpoint=str(entry.checkpoint),
            resident_programs=resident,
            elapsed_s=round(time.perf_counter() - t0, 3))
        self._journal.metrics.inc("zoo_loads")
        return engine

    # -- stacking ----------------------------------------------------------
    def _members(self, replace: tuple[str, object] | None = None
                 ) -> list[tuple[str, object]]:
        """``(model_id, model)`` of every tenant in stack order, with
        ``replace`` standing in for its tenant."""
        return [(mid, replace[1] if replace and replace[0] == mid
                 else self._entries[mid].model) for mid in self.tenant_ids]

    def _restack(self, members, reason: str, warm: bool = True,
                 on_pass=None) -> bool:
        """Build and gate a stacked engine over ``members`` off the hot
        path; on a pass run ``on_pass`` (the reload's entry update) and
        swap the stack in.  Trees that cannot stack, or a gate refusal,
        leave per-model serving (a stale stack is demoted); any other
        error is journaled and raised.  Returns whether the stack
        passed."""
        t0 = time.perf_counter()
        try:
            stacked, gate = build_stacked_engine(
                members, self.buckets, precision=self.precision,
                gate_set=self._gate_set,
                floor=(self.quant_floor if self.precision == "int8"
                       else None),
                warm=warm, journal=self._journal, device=self.device)
        except IncongruentTrees as exc:
            logger.warning("Zoo cannot stack (%s); serving per-model "
                           "engines", exc)
            self._journal.event(
                "zoo_restack", n_tenants=self.n_tenants,
                outcome="unstackable", reason=reason,
                error=f"{type(exc).__name__}: {exc}"[:200],
                demoted_stale_stack=self._demote_stale(),
                elapsed_s=round(time.perf_counter() - t0, 3))
            return False
        except Exception as exc:
            self._journal.event(
                "zoo_restack", n_tenants=self.n_tenants, outcome="error",
                reason=reason, error=f"{type(exc).__name__}: {exc}"[:200],
                demoted_stale_stack=False,
                elapsed_s=round(time.perf_counter() - t0, 3))
            raise
        self.last_stack_gate = gate
        demoted = False
        if stacked is not None:
            if on_pass is not None:
                on_pass()
            self._stacked = stacked   # an atomic reference swap
            with self._lock:
                self._restacks += 1
        else:
            demoted = self._demote_stale()
        outcome = "pass" if stacked is not None else "refused"
        self._journal.event(
            "zoo_restack", n_tenants=self.n_tenants, outcome=outcome,
            reason=reason, precision=self.precision,
            agreement=round(gate.agreement, 6),
            digest=(stacked.digest if stacked is not None else None),
            demoted_stale_stack=demoted,
            elapsed_s=round(time.perf_counter() - t0, 3))
        self._journal.metrics.inc("zoo_restacks", outcome=outcome)
        return stacked is not None

    def _demote_stale(self) -> bool:
        """Drop the live stack (per-model serving from here on); returns
        whether there was one."""
        if self._stacked is None:
            return False
        self._stacked = None
        logger.warning("Zoo demoted the stacked engine; serving per-model "
                       "until a restack passes")
        return True

    @property
    def stacked(self):
        """The live stacked engine, or ``None`` when serving per-model."""
        return self._stacked

    # -- the registry's surface --------------------------------------------
    @property
    def engine(self) -> InferenceEngine:
        """The live engine: the stacked one, else the default tenant's."""
        stacked = self._stacked
        if stacked is not None:
            return stacked
        return self.materialize(self.default_id)

    @property
    def geometry(self) -> tuple[int, int]:
        stacked = self._stacked
        if stacked is not None:
            return stacked.geometry
        entry = self._entries[self.default_id]
        if entry.model is None:
            with self._build_lock:
                self._load_model(entry)
        return entry.model.n_channels, entry.model.n_times

    @property
    def digest(self) -> str | None:
        """The stack's digest while it serves, else the default
        tenant's."""
        stacked = self._stacked
        if stacked is not None:
            return stacked.digest
        return self._entries[self.default_id].digest

    @property
    def serving_precision(self) -> str:
        stacked = self._stacked
        if stacked is not None:
            return stacked.precision
        return self._entries[self.default_id].serving_precision \
            or self.precision

    @property
    def swaps(self) -> int:
        with self._lock:
            return self._swaps

    @property
    def restacks(self) -> int:
        with self._lock:
            return self._restacks

    @property
    def retunes(self) -> int:
        with self._lock:
            return self._retunes

    @property
    def active_buckets(self) -> tuple[int, ...]:
        """The live ladder: the stack's while it serves, else the zoo's."""
        stacked = self._stacked
        if stacked is not None:
            return stacked.buckets
        return self.buckets

    # -- the hot path ------------------------------------------------------
    def infer(self, trials: np.ndarray,
              tenant_idx: np.ndarray | int = 0) -> np.ndarray:
        """A mixed-tenant batch -> predictions: one stacked forward when
        the stack serves, else one per tenant in the batch."""
        x = np.asarray(trials, np.float32)
        if x.ndim == 2:
            x = x[None]
        tid = np.broadcast_to(np.asarray(tenant_idx, np.int32),
                              (len(x),)).astype(np.int32, copy=False)
        stacked = self._stacked
        if stacked is not None:
            if len(x):
                now = time.monotonic()
                with self._lock:
                    for z in np.unique(tid):
                        self._entries[self.tenant_ids[int(z)]].last_used \
                            = now
            return stacked.infer(x, tid)
        out = np.empty(len(x), np.int64)
        for z in np.unique(tid):
            engine = self.materialize(self.tenant_ids[int(z)])
            mask = tid == z
            out[mask] = engine.infer(x[mask])
        return out

    # -- mutation ----------------------------------------------------------
    def reload(self, model_id: str, checkpoint: str | Path, *,
               warm: bool = True) -> str:
        """Swap ONE tenant's weights.  The checkpoint is loaded (digest
        verified, geometry checked) and, when stacking, the new stack is
        built and gated before anything changes, so a failure leaves
        serving as it was.  Returns the tenant's new digest."""
        with self._reload_lock:
            entry = self._entries[self.resolve(model_id)]
            t0 = time.perf_counter()
            model = load_model_from_checkpoint(checkpoint,
                                               device=self.device)
            if (model.n_channels, model.n_times) != self.geometry:
                raise ValueError(
                    f"hot-reload geometry mismatch: serving "
                    f"{self.geometry}, checkpoint {checkpoint} is "
                    f"{(model.n_channels, model.n_times)}; restart the "
                    "service to change model geometry")
            new_digest = model_digest(model)
            old_digest = entry.digest
            engine = None
            if not self.stack_requested or self._stacked is None:
                # Per-model serving: the tenant's engine is rebuilt (and
                # gated) off to the side before the swap.
                engine, gate = build_gated_engine(
                    model, self.buckets, precision=self.precision,
                    floor=self.quant_floor, gate_set=self._gate_set,
                    warm=warm, journal=self._journal, device=self.device)
                self.last_gate = gate

            def swap_entry():
                with self._lock:
                    entry.model, entry.digest = model, new_digest
                    entry.checkpoint = Path(checkpoint)
                    entry.engine = engine
                    if engine is not None:
                        entry.serving_precision = engine.precision
                        entry.last_used = time.monotonic()
                        self._evict_over_budget_locked()
                    self._swaps += 1

            with self._build_lock:
                if engine is None:
                    members = self._members((entry.model_id, model))
                    if not self._restack(members,
                                         reason=f"reload:{entry.model_id}",
                                         warm=warm, on_pass=swap_entry):
                        swap_entry()   # refused: per-model, new weights
                else:
                    swap_entry()
                    if self.stack_requested:
                        self._restack(self._members(),
                                      reason=f"reload:{entry.model_id}",
                                      warm=warm)
            self._journal.event(
                "model_swap", checkpoint=str(checkpoint),
                model=entry.model_id, digest=new_digest,
                previous_digest=old_digest, precision=self.precision,
                elapsed_s=round(time.perf_counter() - t0, 3))
            self._journal.metrics.inc("model_swaps")
            return new_digest

    # -- shadows (online adaptation) ---------------------------------------
    def register_shadow(self, model_id: str, checkpoint: str | Path) -> str:
        """Load an adaptation candidate as a non-serving shadow of
        ``model_id``: integrity-verified and geometry-gated like a reload
        (a corrupt candidate raises here and never sees traffic), an fp32
        engine on bucket 1 only (the tee scores one window at a time).  On
        the card that bucket is one captured graph, captured as a retune
        captures (its own stream, ``thread_local`` mode, after an eager
        run there), so serving goes on meanwhile.  Returns the shadow's
        digest."""
        resolved = self.resolve(model_id)
        model = load_model_from_checkpoint(checkpoint, device=self.device)
        if (model.n_channels, model.n_times) != self.geometry:
            raise ValueError(
                f"shadow geometry mismatch: serving {self.geometry}, "
                f"candidate {checkpoint} is "
                f"{(model.n_channels, model.n_times)}")
        digest = model_digest(model)
        engine = InferenceEngine(model, (1,), device=self.device,
                                 precision="fp32", digest=digest,
                                 journal=self._journal)
        engine.warmup()
        with self._lock:
            self._shadows[resolved] = (engine, digest)
        self._journal.event("model_load", model=resolved, digest=digest,
                            shadow=True, checkpoint=str(checkpoint))
        self._journal.metrics.inc("zoo_shadow_loads")
        logger.info("Zoo shadow registered for %s: %s", resolved,
                    digest[:12])
        return digest

    def shadow_infer(self, model_id: str, trials: np.ndarray) -> np.ndarray:
        """Predictions of the tenant's shadow engine (``KeyError`` when
        none is registered)."""
        with self._lock:
            engine, _ = self._shadows[self.resolve(model_id)]
        return engine.infer(trials)

    def shadow_digest(self, model_id: str) -> str | None:
        with self._lock:
            entry = self._shadows.get(self.resolve(model_id))
            return None if entry is None else entry[1]

    def drop_shadow(self, model_id: str) -> bool:
        """Retire the tenant's shadow (no-op when none is registered)."""
        with self._lock:
            return self._shadows.pop(self.resolve(model_id), None) \
                is not None

    def retune(self, buckets: tuple[int, ...], *, warm: bool = True):
        """Adopt a new bucket ladder (the tuner's primitive): the stacked
        engine is rebuilt on it and its graphs captured off the hot path
        (same weights, no re-gate), then swapped in; resident per-model
        engines retire and rebuild lazily on the new ladder.  A capture
        error raises with the old ladder serving."""
        with self._reload_lock:
            # An in-flight materialize() captured the old ladder: it lands
            # before the ladder moves and the old engines retire.
            with self._build_lock:
                stacked = self._stacked
                engine = None
                if stacked is not None:
                    engine = StackedEngine(
                        stacked.members, tuple(buckets),
                        precision=stacked.precision, device=self.device,
                        journal=self._journal)
                    if warm:
                        engine.warmup()
                self.buckets = tuple(int(b) for b in buckets)
                if engine is not None:
                    self._stacked = engine
                with self._lock:
                    for entry in self._entries.values():
                        entry.engine = None    # old-ladder engines retire
                    self._retunes += 1
            if self._stacked is None:
                # Per-model serving: the default engine comes up on the
                # new ladder now, so the swap shows at once.
                self.materialize(self.default_id, warm=warm)
            return self.engine

    # -- observability -----------------------------------------------------
    def snapshot(self) -> dict:
        """The /healthz ``zoo`` payload: per-tenant identity, precision,
        residency and recency, and the stacked engine's state."""
        now = time.monotonic()
        stacked = self._stacked
        with self._lock:
            tenants = []
            for mid in self.tenant_ids:
                e = self._entries[mid]
                tenants.append({
                    "model": mid,
                    "digest": (stacked.tenant_digests.get(mid, e.digest)
                               if stacked is not None else e.digest),
                    "precision": (stacked.precision if stacked is not None
                                  else e.serving_precision),
                    "resident": stacked is not None or e.engine is not None,
                    "engine_resident": e.engine is not None,
                    "last_used_age_s": (round(now - e.last_used, 3)
                                        if e.last_used else None),
                    "loads": e.loads,
                    "evictions": e.evictions,
                    "default": mid == self.default_id})
            return {
                "n_tenants": self.n_tenants,
                "default": self.default_id,
                "stacked": (None if stacked is None else {
                    "precision": stacked.precision,
                    "digest": stacked.digest,
                    "buckets": list(stacked.buckets),
                    "n_tenants": stacked.n_tenants}),
                "resident_programs": self._resident_programs_locked(),
                "max_programs": self.max_programs,
                "restacks": self._restacks,
                "shadows": [{"model": mid, "digest": digest}
                            for mid, (_, digest) in self._shadows.items()],
                "tenants": tenants}
