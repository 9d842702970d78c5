"""Online inference HTTP service: ``python -m eegnetreplication_tpu_torch.serve``.

The serving core of ``eegnetreplication_tpu/serve/service.py`` on the
torch engine (stdlib ``http.server`` + threads):

- ``POST /predict`` — trials as JSON (``{"trials": [[[...]]]}``) or raw
  ``-trials.npz`` bytes (an ``X`` array); returns predictions, the class
  names and the serving ``model_digest``.  Bad geometry or an unparsable
  body answers 400, a full queue 429.  A deadline (``X-Deadline-Ms``
  header or ``deadline_ms`` JSON field) is enforced at dequeue and at
  response time; both answer 504.  Under ``--zoo`` the request names its
  model (``X-Model`` header or ``"model"`` JSON field: a tenant id, a
  digest prefix, or none for the default); an unknown model answers 404.
- ``POST /reload`` — ``{"checkpoint": path}``: the new model is loaded,
  gated and warmed off to the side and swapped in with no request
  dropped; 200 with the new digest, or 400 with the old model still
  serving.  Under ``--zoo``, ``{"model": id, "checkpoint": path}``
  swaps one tenant and restacks (``zoo_restack``).
- ``GET /healthz`` — the JAX server's fields (``status``, ``degraded``,
  ``slo``, ``latency_ms`` p50/p95/p99 from the live histogram,
  ``circuit``, ``worker_heartbeat``, ``checkpoint``, ``model_digest``,
  ``variables_digest``, ``geometry``, the active ``buckets``,
  ``max_batch``, ``max_wait_ms``, ``precision`` as served and
  ``requested_precision``, ``ladder_retunes``, the queue depths,
  ``sessions``, ``admission``, the zoo's state, ``model_swaps``), plus the
  coalesced forwards dispatched (``batches``), the CUDA graph replays
  (``graph_replays``) and the hand-written kernels' launch counts
  (``kernel_launches``: ``block1``, ``block1_stacked`` and
  ``ems_stream``; a replay counts the kernels its graph holds).  It
  answers 503 (``status: degraded``) while the circuit breaker is open,
  the batcher worker's heartbeat is stale or an SLO is breached.
- ``GET /metrics`` — the run's metrics registry: the JSON snapshot, or the
  Prometheus text when the ``Accept`` header asks for ``text/plain``.
- ``POST /profile`` — ``{"seconds": s}``: one bounded ``torch.profiler``
  window (at most :data:`PROFILE_MAX_S`) on a thread of its own; 202 at
  once with the window's ``log_dir``, 409 while one runs, and a
  ``profile_window`` journal event when it closes.
- Streaming sessions (``serve/sessions/``), the JAX service's routes:
  ``POST /session/open`` (``{"session", "hop", "deadline_ms",
  "ems_init_block_size", ...}``; re-opening a live or restored id returns
  its acked cursor), ``POST /session/<id>/samples`` (raw little-endian
  f32 ``(C, n)`` bytes, channel-major, or ``{"samples": [[...]]}``): the
  chunk goes through the session's EMS carry (one K2s launch on the card)
  and every window it completes through the batcher, answered in the same
  reply; ``POST /session/<id>/label`` (recorded, journaled, and with
  ``--adapt`` fed to the adaptation loop),
  ``/close``, ``/import``, ``/discard``, ``GET /session/<id>/state`` and
  ``/export``.  Windows classify under the zoo's default tenant.  A window
  past its deadline is decided ``expired`` with ``pred = -1`` and the
  stream goes on.  ``--sessionsDir`` holds the stamped snapshots (every
  ``--sessionSnapshotEvery`` decided windows, at every close and at the
  drain; ``--sessionsMirror`` writes each twice), ``--resume`` restores
  them before the listener binds.

- Online adaptation (``--adapt``, zoo serving; a lone ``--checkpoint``
  becomes a one-tenant zoo): each decided window of a session is captured
  for replay, the client's labels pair with it, ``--adaptTriggerLabels``
  fresh labels start a background fine-tune (``adapt/``), the candidate
  serves as a non-serving shadow on sampled live traffic (the zoo's
  bucket-1 shadow engine) and is promoted through the zoo's zero-drop
  reload when the gate's floors clear.  ``GET /adapt/status`` reports the
  loop, ``POST /adapt/rollback`` (``{"model": id?}``) restores the
  pre-promotion weights (409 with nothing to roll back); both answer 404
  without ``--adapt``.  An armed ``session.drift`` chaos site turns each
  pushed chunk into ``x*scale + offset`` before the EMS carry sees it.

The control plane is the JAX server's: each dispatch probes the
``serve.forward`` and ``serve.degrade`` chaos sites under the shared retry
policy (:data:`SERVE_RETRY`), and a :class:`CircuitBreaker` sees the
outcome after the retry (``--breakerThreshold`` consecutive failures open
it: fast 503s until a half-open probe succeeds after ``--breakerResetS``);
``--tuneEveryS`` runs the :class:`LadderTuner` (a retune captures the new
ladder's graphs off the hot path); ``--admissionTargetMs`` the adaptive
admission (bulk 429 ``shed``); ``--traceSample`` head-samples traces
(``X-Trace-Id`` from a client is kept); ``--slo``/``--sloWindowS`` the
SLO monitor; ``--probeIntervalS`` an in-process :class:`Prober` that
posts known-answer canaries (``X-Probe``) to this server's ``/predict``
and evaluates ``--probeSlo`` from the client's side.  A probe runs the
real path but counts in ``probe_requests_total`` (``/healthz``
``probes``), never in ``requests_total``, the request SLO, the admission
limit or the tuner's observations.

``--precision int8`` serves int8 weights behind the quant gate (fp32 if
it refuses).  The run writes the JAX service's journal (``serve_start``,
``request``, ``compile*``, ``quant_gate``, ``stack_gate``,
``zoo_restack``, ``model_load``, ``model_evict``, ``model_swap``,
``ladder_retune``, ``circuit_state``, ``admission_change``, ``shed``,
``span``, ``slo_breach``, ``slo_recovered``, ``profile_window``,
``heartbeat``, ``probe``, the session and adaptation events,
``serve_end``) under ``--metricsDir``.  SIGTERM/SIGINT stop the listener,
drain the queue, snapshot the sessions and exit 75
(``resil/preempt.py``).  Every reply probes the ``replica.network``
chaos site: a ``truncate`` firing sends half the body under the full
``Content-Length`` and closes the connection, the half-answered socket a
fleet router must fail over.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.adapt import (
    AdaptationController,
    PromotionGate,
)
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import probe as obs_probe
from eegnetreplication_tpu_torch.obs import slo as obs_slo
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.obs.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    to_prometheus_text,
    wants_prometheus,
)
from eegnetreplication_tpu_torch.obs.probe import PROBE_HEADER
from eegnetreplication_tpu_torch.ops.ems_kernel import ems_stream
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    block1,
    block1_stacked,
)
from eegnetreplication_tpu_torch.resil import heartbeat as hb
from eegnetreplication_tpu_torch.resil import inject, preempt, stackdump
from eegnetreplication_tpu_torch.resil import retry as resil_retry
from eegnetreplication_tpu_torch.resil.breaker import CircuitBreaker
from eegnetreplication_tpu_torch.resil.integrity import IntegrityError
from eegnetreplication_tpu_torch.serve.admission import AdmissionController
from eegnetreplication_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Rejected,
    Shed,
)
from eegnetreplication_tpu_torch.serve.engine import (
    CLASS_NAMES,
    DEFAULT_BUCKETS,
    PRECISIONS,
    QUANT_AGREEMENT_FLOOR,
    BucketGraph,
    InferenceEngine,
)
from eegnetreplication_tpu_torch.serve.registry import (
    ModelRegistry,
    ModelZoo,
)
from eegnetreplication_tpu_torch.serve.sessions.session import (
    STATUS_ERROR,
    STATUS_EXPIRED,
    STATUS_OK,
    LabelConflict,
    WindowDecision,
)
from eegnetreplication_tpu_torch.serve.sessions.store import (
    SessionExists,
    SessionStore,
)
from eegnetreplication_tpu_torch.serve.tuner import LadderTuner
from eegnetreplication_tpu_torch.utils.device import (
    resolve_device,
    select_device,
)
from eegnetreplication_tpu_torch.utils.logging import logger

# How long a handler waits for its request's forward before answering 500.
REQUEST_TIMEOUT_S = 30.0
# How long stop() waits for in-flight handler threads after the drain.
HANDLER_DRAIN_S = 15.0
# How long a connection waits, after its last reply, for its client to
# close it first (JsonRequestHandler.handle).
CLIENT_CLOSE_WAIT_S = 2.0

# A device hiccup is worth two spaced re-runs of the same small batch;
# anything deterministic fails the batch at once.
SERVE_RETRY = resil_retry.RetryPolicy(max_attempts=3, base_delay_s=0.05,
                                      max_delay_s=1.0)

# POST /profile: the window when the body names none, and the cap.
DEFAULT_PROFILE_S = 2.0
PROFILE_MAX_S = 60.0

# /healthz's worker-liveness budgets: the batcher worker beats every poll,
# so seconds of silence while idle mean it is gone or wedged; a beat
# parked in serve_forward gets a forward-plus-retry allowance.
SERVE_WATCHDOG_THRESHOLDS = {"serve_idle": 10.0, "serve_forward": 60.0}

# The client headers a routing tier (the fleet's router) carries verbatim
# to the serving process on every dispatch and every failover retry: the
# deadline, the admission class and the zoo tenant.  The trace headers
# ride the trace context instead (trace.headers() per attempt).
PASSTHROUGH_HEADERS = ("X-Model", "X-Deadline-Ms", "X-Priority")


def make_infer_fn(registry, breaker: CircuitBreaker | None = None,
                  chaos_tag: str | None = None):
    """The batcher's inference callable: the chaos sites, the retry and
    the registry, with each dispatch's outcome fed to ``breaker``.

    ``serve.forward`` fires per attempt (so ``times=1`` faults one attempt
    and the retry answers) and ``serve.degrade`` beside it (carrying
    ``chaos_tag`` for ``if_tag=``).  The breaker sees the outcome after
    the retry: a blip the retry absorbed is a success.  A tenant-aware
    batcher passes the per-trial tenant vector as a second argument.
    """
    def dispatch(x: np.ndarray, tenants=None) -> np.ndarray:
        inject.fire("serve.forward", n_trials=len(x))
        inject.fire("serve.degrade", n_trials=len(x), tag=chaos_tag)
        if tenants is None:
            return registry.infer(x)
        return registry.infer(x, tenants)

    def infer_fn(x: np.ndarray, tenants=None) -> np.ndarray:
        try:
            out = resil_retry.call(lambda: dispatch(x, tenants),
                                   policy=SERVE_RETRY,
                                   site="serve.forward")
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        if breaker is not None:
            breaker.record_success()
        return out

    return infer_fn


class ServeApp:
    """The assembled service: registry (or zoo) + batcher + HTTP listener.

    Construction loads, gates and warms the model(s), so the listener
    never accepts a request it would answer cold; ``start`` binds the
    socket and journals ``serve_start``, ``stop(drain=True)`` stops
    accepting, drains the queue and journals ``serve_end``.
    """

    def __init__(self, checkpoint: str | Path | None = None, *,
                 host: str = "127.0.0.1",
                 port: int = 0, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, max_queue_trials: int = 512,
                 device: torch.device | str | None = None,
                 precision: str = "fp32",
                 quant_floor: float = QUANT_AGREEMENT_FLOOR,
                 gate_set=None, zoo=None, default_model: str | None = None,
                 max_programs: int = 0, stack: bool = True,
                 sessions_dir: str | Path | None = None,
                 sessions_mirror: str | Path | None = None,
                 session_snapshot_every: int = 50, resume: bool = False,
                 journal=None, breaker_threshold: int = 5,
                 breaker_reset_s: float = 30.0,
                 watchdog_thresholds: dict | None = None,
                 tune_every_s: float = 0.0,
                 trace_sample: float = trace.DEFAULT_SAMPLE_RATE,
                 slo_spec: str | None = None,
                 slo_window_s: float = obs_slo.DEFAULT_WINDOW_S,
                 slo_interval_s: float = 1.0,
                 admission_target_ms: float = 0.0,
                 chaos_tag: str | None = None,
                 adapt: bool = False,
                 adapt_dir: str | Path | None = None,
                 adapt_trigger_labels: int = 16,
                 adapt_steps: int = 60, adapt_lr: float = 1e-3,
                 adapt_batch: int = 32, adapt_sample_every: int = 1,
                 adapt_min_shadow: int = 12, adapt_min_labeled: int = 8,
                 adapt_accuracy_floor: float = 0.55,
                 adapt_agreement_floor: float = 0.0):
        self.journal = journal if journal is not None \
            else obs_journal.current()
        device = resolve_device(device)
        if zoo is not None:
            self.registry = ModelZoo(
                zoo, default=default_model, buckets=tuple(buckets),
                precision=precision, quant_floor=quant_floor,
                gate_set=gate_set, max_programs=max_programs, stack=stack,
                journal=self.journal, device=device)
            self.zoo: ModelZoo | None = self.registry
            self.checkpoint = str(
                self.registry.checkpoint_for(self.registry.default_id))
        else:
            if checkpoint is None:
                raise ValueError("ServeApp needs a checkpoint or a zoo")
            self.zoo = None
            self.checkpoint = str(checkpoint)
            self.registry = ModelRegistry(
                tuple(buckets), precision=precision,
                quant_floor=quant_floor, gate_set=gate_set,
                journal=self.journal, device=device)
            self.registry.load(checkpoint)
        # Streaming sessions: durable when sessions_dir is given (the CLI
        # always passes one), in memory otherwise.  --resume restores the
        # newest valid snapshot generation before the listener binds, so a
        # resuming client's first read already sees its acked cursor.
        self.sessions_dir = Path(sessions_dir) if sessions_dir else None
        self.sessions_mirror = (Path(sessions_mirror) if sessions_mirror
                                else None)
        self.sessions = SessionStore(
            self.sessions_dir / "sessions.npz" if self.sessions_dir
            else None,
            mirror=(self.sessions_mirror / "sessions.npz"
                    if self.sessions_mirror else None),
            snapshot_every_windows=session_snapshot_every,
            journal=self.journal, device=device)
        if resume:
            self.sessions.restore()
        # Online adaptation (opt-in) needs the zoo: the candidate registers
        # as a non-serving shadow and promotion rides the zoo's reload (the
        # CLI wraps a lone --checkpoint into a one-tenant zoo).
        self.adapt: AdaptationController | None = None
        self.adapt_warmup_s = None
        if adapt:
            if self.zoo is None:
                raise ValueError(
                    "online adaptation requires zoo serving (pass zoo=, "
                    "or let the CLI wrap --checkpoint into a one-tenant "
                    "zoo)")
            adapt_root = (Path(adapt_dir) if adapt_dir
                          else (self.sessions_dir / "adapt"
                                if self.sessions_dir
                                else Path(tempfile.mkdtemp(
                                    prefix="eegtpu_adapt_"))))
            self.adapt = AdaptationController(
                self.zoo, adapt_root,
                trigger_labels=adapt_trigger_labels,
                sample_every=adapt_sample_every,
                gate=PromotionGate(
                    min_samples=adapt_min_shadow,
                    min_labeled=adapt_min_labeled,
                    accuracy_floor=adapt_accuracy_floor,
                    agreement_floor=adapt_agreement_floor),
                learning_rate=adapt_lr, steps=adapt_steps,
                batch_size=adapt_batch, journal=self.journal)
            # The training path's first use on the card, before the
            # listener binds (see AdaptationWorker.warmup).
            self.adapt_warmup_s = self.adapt.worker.warmup(
                self.zoo.checkpoint_for(self.zoo.default_id))
        # Liveness: the worker's heartbeat (in process, plus the
        # EEGTPU_HEARTBEAT_FILE file when one is configured) feeds
        # /healthz's staleness check; the breaker guards serve.forward.
        self.heartbeat = hb.Heartbeat(
            os.environ.get(hb.HEARTBEAT_FILE_ENV) or None)
        self.watchdog = hb.Watchdog(
            dict(SERVE_WATCHDOG_THRESHOLDS, **(watchdog_thresholds or {})))
        self.breaker = CircuitBreaker(
            failure_threshold=breaker_threshold,
            reset_after_s=breaker_reset_s, site="serve.forward",
            journal=self.journal)
        self.chaos_tag = chaos_tag
        # Adaptive admission between one full bucket and the hard queue
        # bound (target 0: the static bound alone).
        max_batch = buckets[-1]
        self.admission = (AdmissionController(
            target_wait_ms=admission_target_ms,
            min_limit=min(max_batch, max_queue_trials),
            max_limit=max_queue_trials, journal=self.journal)
            if admission_target_ms and admission_target_ms > 0 else None)
        self.batcher = MicroBatcher(
            make_infer_fn(self.registry, self.breaker, chaos_tag=chaos_tag),
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            max_queue_trials=max_queue_trials, journal=self.journal,
            heartbeat=self.heartbeat, admission=self.admission,
            tenant_aware=self.zoo is not None)
        # The ladder tuner (0: off) retunes off the hot path.
        self.tuner = (LadderTuner(self.registry, self.batcher,
                                  journal=self.journal,
                                  interval_s=tune_every_s)
                      if tune_every_s and tune_every_s > 0 else None)
        # Head-based sampling rate for requests without an X-Trace-Id.
        self.trace_sample = float(trace_sample)
        self.slo = (obs_slo.SLOMonitor(
            self.journal.metrics, slo_spec, window_s=slo_window_s,
            interval_s=slo_interval_s, journal=self.journal)
            if slo_spec else None)
        self._host, self._port = host, int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._listener: threading.Thread | None = None
        self._stopped = False
        # Request and session counts for serve_end, and the in-flight
        # handlers stop() waits for (all under _stats_lock).
        self._stats_lock = threading.Lock()
        self._idle = threading.Condition(self._stats_lock)
        self._inflight = 0
        self._n_requests = 0
        self._n_rejected = 0
        self._n_shed = 0
        self._n_errors = 0
        self._n_expired = 0
        self._n_circuit_open = 0
        self._n_probes = 0
        self._n_sessions_opened = 0
        self._n_session_windows = 0
        self._n_windows_expired = 0
        # POST /profile: one bounded window at a time, off the hot path.
        self._profile_lock = threading.Lock()
        self._profiling = False
        self._t_start = time.perf_counter()

    @property
    def ladder_retunes(self) -> int:
        """Applied retunes: the tuner's count (wait-only proposals skip
        the engine rebuild) when it runs, else the registry's."""
        if self.tuner is not None:
            return self.tuner.retunes
        return self.registry.retunes

    @property
    def engine(self) -> InferenceEngine:
        """The live engine (the stacked one under a stacking zoo)."""
        return self.registry.engine

    # -- lifecycle --------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ServeApp":
        app = self

        class Handler(_ServeHandler):
            pass

        Handler.app = app
        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._listener = threading.Thread(target=self._httpd.serve_forever,
                                          name="serve-http", daemon=True)
        self._listener.start()
        if self.tuner is not None:
            self.tuner.start()
        if self.slo is not None:
            self.slo.start()
        gate = self.registry.last_gate
        self.journal.event(
            "serve_start", checkpoint=self.checkpoint,
            buckets=list(self.buckets), max_batch=self.batcher.max_batch,
            max_wait_ms=self.batcher.max_wait_s * 1000.0,
            max_queue_trials=self.batcher.max_queue_trials,
            digest=self.registry.digest,
            precision=self.registry.serving_precision,
            requested_precision=self.registry.precision,
            trace_sample=self.trace_sample,
            slo=([o.name for o in self.slo.objectives]
                 if self.slo is not None else None),
            admission_target_ms=(self.admission.target_wait_ms
                                 if self.admission else None),
            ladder_tuning=self.tuner is not None,
            quant_agreement=(round(gate.agreement, 6) if gate else None),
            tenants=(list(self.zoo.tenant_ids)
                     if self.zoo is not None else None),
            stacked=(self.zoo.stacked is not None
                     if self.zoo is not None else None),
            adaptation=self.adapt is not None,
            adapt_warmup_s=(round(self.adapt_warmup_s, 3)
                            if self.adapt_warmup_s is not None else None),
            host=self.address[0], port=self.address[1])
        logger.info("Serving %s at %s (buckets %s, %s on %s)",
                    self.checkpoint, self.url, self.buckets,
                    self.registry.serving_precision, self.registry.device)
        return self

    @property
    def buckets(self) -> tuple[int, ...]:
        """The active ladder (a retune moves it)."""
        return tuple(self.registry.active_buckets)

    def record_request(self, n_trials: int, latency_ms: float, status: str,
                       *, probe: bool = False,
                       model: str | None = None) -> None:
        """Journal one ``request`` event and count it: ``ok``,
        ``rejected``, ``shed``, ``expired``, ``circuit_open``, or an error
        (``error``, ``bad_request``, ``bad_model``).  ``requests_total``
        and the ok latency histogram feed ``/metrics``, ``/healthz`` and
        the SLO monitor; an anomalous outcome flushes the request's
        buffered trace spans.  A probe (``X-Probe``) journals with
        ``probe=True`` and counts in ``probe_requests_total`` only, so the
        request SLO and the latency tails see user traffic alone."""
        if probe:
            with self._stats_lock:
                self._n_probes += 1
            self.journal.event("request", n_trials=int(n_trials),
                               latency_ms=round(latency_ms, 3),
                               status=status, probe=True)
            self.journal.metrics.inc("probe_requests_total", status=status)
            trace.flush_if_anomalous(status, journal=self.journal)
            return
        with self._stats_lock:
            self._n_requests += 1
            if status == "rejected":
                self._n_rejected += 1
            elif status == "shed":
                self._n_shed += 1
            elif status == "expired":
                self._n_expired += 1
            elif status == "circuit_open":
                self._n_circuit_open += 1
            elif status != "ok":
                self._n_errors += 1
        self.journal.event("request", n_trials=int(n_trials),
                           latency_ms=round(latency_ms, 3), status=status,
                           model=model)
        self.journal.metrics.inc("requests_total", status=status)
        if status == "ok":
            self.journal.metrics.observe("request_latency_ms", latency_ms)
        trace.flush_if_anomalous(status, journal=self.journal)

    def stop(self, drain: bool = True) -> None:
        """Stop the listener, drain (default) or fail queued requests, and
        wait for in-flight handler threads.  Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        if self.tuner is not None:
            self.tuner.stop()     # no retune mid-drain
        if self.slo is not None:
            self.slo.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.batcher.close(drain=drain)
        if self.adapt is not None:
            self.adapt.close()
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=HANDLER_DRAIN_S):
                logger.warning("%d in-flight request handler(s) did not "
                               "finish within %.1fs", self._inflight,
                               HANDLER_DRAIN_S)
            n_req, n_rej, n_shed = (self._n_requests, self._n_rejected,
                                    self._n_shed)
            n_err, n_exp, n_open = (self._n_errors, self._n_expired,
                                    self._n_circuit_open)
            n_sess, n_win, n_wexp = (self._n_sessions_opened,
                                     self._n_session_windows,
                                     self._n_windows_expired)
            n_probes = self._n_probes
        # The final session snapshot lands after the handler wait: every
        # in-flight ingest has recorded its decisions, so it is the whole
        # durable state a --resume restores.  A background periodic
        # snapshot finishes first, so the drain's write comes last.
        self.sessions.drain_background()
        self.sessions.snapshot()
        self.sessions.detach()
        self.journal.event(
            "serve_end", n_requests=n_req, rejected=n_rej, shed=n_shed,
            admission_changes=(self.admission.n_changes
                               if self.admission else 0),
            errors=n_err, expired=n_exp, circuit_open=n_open,
            breaker_trips=self.breaker.trips, sessions=n_sess,
            session_windows=n_win, windows_expired=n_wexp,
            session_snapshots=self.sessions.snapshots,
            wall_s=round(time.perf_counter() - self._t_start, 3),
            batches=self.batcher.batches, model_swaps=self.registry.swaps,
            ladder_retunes=self.ladder_retunes,
            slo_breaches=(self.slo.breach_events
                          if self.slo is not None else 0),
            graph_replays=BucketGraph.replays,
            n_tenants=(self.zoo.n_tenants if self.zoo is not None
                       else None),
            zoo_restacks=(self.zoo.restacks if self.zoo is not None
                          else None),
            probes=n_probes, precision=self.registry.serving_precision,
            kernel_launches={"block1": block1.launches,
                             "block1_stacked": block1_stacked.launches,
                             "ems_stream": ems_stream.launches})
        logger.info("Serve drained and stopped: %d requests (%d rejected, "
                    "%d errors, %d expired, %d refused by the open "
                    "circuit), %d forwards, %d model swap(s), %d breaker "
                    "trip(s)", n_req, n_rej, n_err, n_exp, n_open,
                    self.batcher.batches, self.registry.swaps,
                    self.breaker.trips)

    # -- on-demand profiling (POST /profile) --------------------------------
    def start_profile(self, seconds: float,
                      log_dir: str | None = None) -> dict | None:
        """Start one bounded ``torch.profiler`` window (at most
        :data:`PROFILE_MAX_S`) on a thread of its own; the handler answers
        at once.  Returns the window's descriptor, or ``None`` while one
        is running (one at a time)."""
        seconds = min(float(seconds), PROFILE_MAX_S)
        if seconds <= 0:
            raise ValueError(f"profile window must be > 0 s, got {seconds}")
        with self._profile_lock:
            if self._profiling:
                return None
            self._profiling = True
        base = self.journal.dir if self.journal.dir is not None \
            else Path(tempfile.gettempdir())
        target = Path(log_dir) if log_dir else \
            Path(base) / f"profile_{int(time.time() * 1000.0)}"
        threading.Thread(target=self._profile_window,
                         args=(seconds, target),
                         name="eegtpu-profile", daemon=True).start()
        return {"seconds": seconds, "log_dir": str(target)}

    def _profile_window(self, seconds: float, log_dir: Path) -> None:
        from eegnetreplication_tpu_torch.utils import profiling

        t0 = time.perf_counter()
        status, error, path = "ok", None, None
        try:
            with profiling.trace(str(log_dir)) as path:
                time.sleep(seconds)
        except Exception as exc:  # noqa: BLE001 — profiling is advisory
            status, error = "error", f"{type(exc).__name__}: {exc}"
            logger.warning("Profiling window failed: %s", error)
        finally:
            with self._profile_lock:
                self._profiling = False
        self.journal.event("profile_window",
                           dur_s=round(time.perf_counter() - t0, 3),
                           log_dir=str(log_dir), status=status,
                           requested_s=seconds, error=error,
                           trace=(str(path) if path else None))
        self.journal.metrics.inc("profile_windows", status=status)

    # -- streaming sessions (called from handler threads) ------------------
    def decide_windows(self, session, ready) -> list[WindowDecision]:
        """Route freshly completed windows through the shared batcher and
        record one decision per window, in window order.

        Every window is submitted before any result is awaited, so a burst
        of windows from one chunk (the seeding push releases many)
        coalesces into few forwards.  A session's per-window deadline
        starts at submit and is enforced at batcher dequeue (the forward
        never runs for a window already late) and at the response.  An
        expired or failed window records ``pred = -1`` and the stream goes
        on.  Windows classify under the zoo's default tenant.  With
        adaptation on, each ``ok`` window is captured for replay and teed
        to an active shadow.  Caller holds ``session.lock``.
        """
        tenant = (self.zoo.tenant_index(self.zoo.default_id)
                  if self.zoo is not None else 0)
        submitted = []
        for index, start, win in ready:
            t0 = time.perf_counter()
            deadline = (None if session.deadline_ms is None
                        else time.monotonic() + session.deadline_ms / 1000.0)
            try:
                fut = self.batcher.submit(win[None], deadline=deadline,
                                          priority=True, tenant=tenant)
            except Rejected:
                fut = None
            submitted.append((index, start, win, t0, deadline, fut))
        decisions = []
        for index, start, win, t0, deadline, fut in submitted:
            status, pred = STATUS_ERROR, -1
            if fut is not None:
                try:
                    preds = fut.result(timeout=REQUEST_TIMEOUT_S)
                    if deadline is not None and time.monotonic() > deadline:
                        status = STATUS_EXPIRED   # answered, but too late
                    else:
                        status, pred = STATUS_OK, int(preds[0])
                except DeadlineExceeded:
                    status = STATUS_EXPIRED
                except Exception:  # noqa: BLE001 — recorded, not raised
                    status = STATUS_ERROR
            latency_ms = (time.perf_counter() - t0) * 1000.0
            # One span per window under the push's trace: submit, the
            # coalesced forward, the decision.
            trace.emit_span(trace.current(), "session.window",
                            dur_s=latency_ms / 1000.0, journal=self.journal,
                            session=session.session_id, window=index,
                            status=status)
            if status in (STATUS_EXPIRED, STATUS_ERROR):
                trace.flush(journal=self.journal)
            decision = WindowDecision(index=index, start=start, pred=pred,
                                      status=status, latency_ms=latency_ms)
            session.record(decision)
            decisions.append(decision)
            self.journal.event("session_window", session=session.session_id,
                               window=index, start=start, status=status,
                               pred=pred, latency_ms=round(latency_ms, 3))
            self.journal.metrics.inc("session_windows", status=status)
            if status == STATUS_OK:
                self.journal.metrics.observe("window_latency_ms", latency_ms)
            elif status == STATUS_EXPIRED:
                self.journal.event("window_expired",
                                   session=session.session_id, window=index,
                                   deadline_ms=session.deadline_ms,
                                   latency_ms=round(latency_ms, 3))
            with self._stats_lock:
                self._n_session_windows += 1
                if status == STATUS_EXPIRED:
                    self._n_windows_expired += 1
            if self.adapt is not None and status == STATUS_OK:
                # The standardized window the model classified (a
                # fine-tune trains on the serving distribution); both
                # hooks are O(1) enqueues off the hot path.
                self.adapt.observe_window(
                    self.zoo.default_id, session.session_id, index, win,
                    pred)
        return decisions

    def count_session_opened(self) -> None:
        with self._stats_lock:
            self._n_sessions_opened += 1

    def begin_request(self) -> None:
        with self._idle:
            self._inflight += 1

    def end_request(self) -> None:
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    def healthz(self) -> tuple[int, dict]:
        """The /healthz code and body.  503 while the breaker is open, the
        worker's heartbeat is stale or an SLO is breached.  Identity reads
        never build an engine."""
        zoo = self.zoo
        c, t = self.registry.geometry
        digest = self.registry.digest
        snap = zoo.snapshot() if zoo is not None else None
        circuit = self.breaker.state
        verdict = self.watchdog.check_beat(self.heartbeat.last())
        degraded = []
        if circuit == "open":
            degraded.append("circuit_open")
        if verdict.stale:
            degraded.append("worker_heartbeat_stale")
        slo_state = None
        if self.slo is not None:
            if self.slo.interval_s <= 0:
                self.slo.evaluate()   # no ticker: the probe evaluates
            slo_state = self.slo.state()
            degraded.extend(f"slo:{name}" for name in self.slo.breached)
        q = self.journal.metrics.quantile
        return (503 if degraded else 200), {
            "status": "degraded" if degraded else "ok",
            "degraded": degraded,
            "slo": slo_state,
            "latency_ms": {"p50": q("request_latency_ms", 0.50),
                           "p95": q("request_latency_ms", 0.95),
                           "p99": q("request_latency_ms", 0.99)},
            "circuit": circuit,
            "worker_heartbeat": {"phase": verdict.phase,
                                 "age_s": round(verdict.age_s, 3),
                                 "threshold_s": verdict.threshold_s,
                                 "stale": verdict.stale},
            "checkpoint": self.checkpoint,
            "model_digest": digest,
            "variables_digest": digest,
            "geometry": {"n_channels": c, "n_times": t},
            "buckets": list(self.buckets),
            "max_batch": self.batcher.max_batch,
            "max_wait_ms": round(self.batcher.max_wait_s * 1000.0, 3),
            "precision": self.registry.serving_precision,
            "requested_precision": self.registry.precision,
            "ladder_retunes": self.ladder_retunes,
            "queue_depth_trials": self.batcher.queue_depth,
            "queue_depth_requests": self.batcher.queue_depth_requests,
            "sessions": len(self.sessions),
            "admission": (self.admission.snapshot()
                          if self.admission is not None else None),
            "zoo": snap,
            "tenants": snap["tenants"] if snap else None,
            "model_swaps": self.registry.swaps,
            "batches": self.batcher.batches,
            "stacked": zoo.stacked is not None if zoo is not None else None,
            "zoo_restacks": zoo.restacks if zoo is not None else None,
            "graph_replays": BucketGraph.replays,
            "probes": self._n_probes,
            "kernel_launches": {"block1": block1.launches,
                                "block1_stacked": block1_stacked.launches,
                                "ems_stream": ems_stream.launches},
        }


class JsonRequestHandler(BaseHTTPRequestHandler):
    """The HTTP plumbing the serving handlers share (one server's and the
    fleet's router): kept-alive JSON replies with an explicit
    Content-Length, body reads, debug-level access logging and the
    ``/metrics`` negotiation.  Subclasses provide the routes."""

    protocol_version = "HTTP/1.1"
    # TCP_NODELAY on each connection: a reply goes out as two writes
    # (headers, body), and on a kept-alive connection Nagle's algorithm
    # would hold the body until the client's delayed ACK of the headers.
    # The reply bytes are the same.
    disable_nagle_algorithm = True
    # Set by a handler that cut its reply short on purpose: the connection
    # closes at once instead of waiting for the client.
    close_at_once = False

    def handle(self) -> None:
        """Serve the connection's requests, then let the client close it
        first (up to :data:`CLIENT_CLOSE_WAIT_S`).  The side that closes a
        TCP connection first holds its 4-tuple in TIME_WAIT for a minute.
        Held by the client, it keeps that client port from being handed
        out for this server again.  Held here, a later connection that
        draws the same client port meets it, and a network stack that
        neither takes that SYN as a new connection nor lets the client's
        RST end the TIME_WAIT (gVisor's netstack does neither) drops the
        SYN until the minute is out: the client's connect times out on an
        idle server.  A client that asked ``Connection: close`` closes
        as soon as it has read the reply's Content-Length."""
        super().handle()
        if self.close_at_once:
            return
        try:
            self.connection.settimeout(CLIENT_CLOSE_WAIT_S)
            while self.connection.recv(65536):
                pass
        except OSError:
            pass

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        logger.debug("serve http: " + fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        self._reply_bytes(code, json.dumps(payload).encode())

    def _reply_bytes(self, code: int, body: bytes,
                     content_type: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length else b""

    def _reply_metrics(self, journal) -> None:
        """``GET /metrics``: the JSON snapshot, or the Prometheus text when
        the Accept header names ``text/plain`` (or OpenMetrics)."""
        snapshot = journal.metrics.snapshot(run_id=journal.run_id)
        if wants_prometheus(self.headers.get("Accept")):
            self._reply_bytes(200, to_prometheus_text(snapshot).encode(),
                              content_type=PROMETHEUS_CONTENT_TYPE)
            return
        self._reply(200, snapshot)


class _ServeHandler(JsonRequestHandler):
    """One request; instances live on the ThreadingHTTPServer's threads."""

    app: ServeApp = None  # bound by ServeApp.start()

    def _reply_bytes(self, code: int, body: bytes,
                     content_type: str = "application/json") -> None:
        """Every reply probes the ``replica.network`` chaos site: a
        ``truncate`` firing sends the first half of the body under a
        Content-Length that claims all of it, then closes the
        connection."""
        try:
            inject.fire("replica.network", status=code, n_bytes=len(body),
                        tag=self.app.chaos_tag if self.app else None)
        except inject.ResponseTruncated:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body[: len(body) // 2])
            self.close_connection = self.close_at_once = True
            return
        super()._reply_bytes(code, body, content_type)

    def _parse_predict_body(self, body: bytes
                            ) -> tuple[np.ndarray, object, object]:
        """One decode of a /predict body -> (trials, deadline_ms-or-None,
        model-spec-or-None).  npz bodies carry the deadline and the model
        in headers only."""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == "application/json":
            payload = json.loads(body.decode())
            if not isinstance(payload, dict) or "trials" not in payload:
                raise ValueError('JSON body must be {"trials": [...]}')
            return (np.asarray(payload["trials"], np.float32),
                    payload.get("deadline_ms"), payload.get("model"))
        with np.load(io.BytesIO(body)) as data:
            if "X" in getattr(data, "files", ()):
                return np.asarray(data["X"], np.float32), None, None
            raise ValueError("npz body carries no 'X' trials array")

    def _deadline_ms(self, payload_deadline) -> float | None:
        """The ``X-Deadline-Ms`` header, else the JSON ``deadline_ms``."""
        raw = self.headers.get("X-Deadline-Ms")
        if raw is None:
            raw = payload_deadline
        if raw is None:
            return None
        ms = float(raw)
        if not math.isfinite(ms) or ms <= 0:
            raise ValueError(f"deadline must be a finite number of ms > 0, "
                             f"got {ms}")
        return ms

    def do_GET(self):  # noqa: N802 — stdlib naming
        if self.path == "/healthz":
            self._reply(*self.app.healthz())
            return
        if self.path == "/metrics":
            self._reply_metrics(self.app.journal)
            return
        if self.path == "/adapt/status":
            if self.app.adapt is None:
                self._reply(404, {"error": "adaptation not enabled; "
                                           "start with --adapt"})
                return
            self._reply(200, self.app.adapt.status())
            return
        parts = self.path.strip("/").split("/")
        if len(parts) == 3 and parts[0] == "session" \
                and parts[2] in ("state", "export"):
            app = self.app
            app.begin_request()
            try:
                if parts[2] == "state":
                    self._session_state(app, parts[1])
                else:
                    self._session_export(app, parts[1])
            finally:
                app.end_request()
            return
        self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib naming
        app = self.app
        app.begin_request()
        try:
            with obs_journal.bound(app.journal):
                self._route_post(app)
        finally:
            app.end_request()

    def _route_post(self, app: ServeApp) -> None:
        if self.path == "/predict":
            self._predict(app)
            return
        if self.path == "/reload":
            self._reload(app)
            return
        if self.path == "/profile":
            self._profile(app)
            return
        parts = self.path.strip("/").split("/")
        if parts == ["adapt", "rollback"]:
            self._adapt_rollback(app)
            return
        if parts[0] == "session":
            if len(parts) == 2 and parts[1] == "open":
                self._session_open(app)
                return
            if len(parts) == 2 and parts[1] == "import":
                self._session_import(app)
                return
            route = {"samples": self._session_samples,
                     "label": self._session_label,
                     "close": self._session_close,
                     "discard": self._session_discard}
            if len(parts) == 3 and parts[2] in route:
                route[parts[2]](app, parts[1])
                return
        self._read_body()
        self._reply(404, {"error": f"unknown path {self.path}"})

    def _predict(self, app: ServeApp) -> None:
        # The trace: the client's (X-Trace-Id) or a new one, head-sampled;
        # the replica.request span parents everything the request touches.
        ctx = trace.maybe_start(self.headers, app.trace_sample)
        with trace.use(ctx), trace.span("replica.request",
                                        journal=app.journal,
                                        route="/predict"):
            self._predict_traced(app)

    def _predict_traced(self, app: ServeApp) -> None:
        t0 = time.perf_counter()

        def ms() -> float:
            return (time.perf_counter() - t0) * 1000.0

        # A canary (X-Probe) takes the whole real path, but its outcome is
        # counted apart and its queue residency is left out of the
        # admission and tuner observations: it measures, never steers.
        is_probe = self.headers.get(PROBE_HEADER) is not None

        # The circuit first: under an open breaker the request neither
        # parses nor queues.  allow() claims a probe slot when half-open;
        # it is released on every path where no forward runs.
        if not app.breaker.allow():
            self._read_body()
            app.record_request(0, ms(), "circuit_open", probe=is_probe)
            self._reply(503, {
                "error": "circuit open: serve.forward is failing; retry "
                         "after the cooldown",
                "circuit": app.breaker.state})
            return
        probe_open = True
        try:
            try:
                with trace.span("http.parse", journal=app.journal):
                    x, payload_deadline, payload_model = \
                        self._parse_predict_body(self._read_body())
                deadline_ms = self._deadline_ms(payload_deadline)
                if x.ndim == 2:
                    x = x[None]
                c, t = app.registry.geometry
                if x.ndim != 3 or x.shape[1:] != (c, t):
                    raise ValueError(
                        f"expected trials shaped (n, {c}, {t}), got "
                        f"{tuple(x.shape)}")
            except Exception as exc:  # noqa: BLE001 — client error
                app.record_request(0, ms(), "bad_request", probe=is_probe)
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            # The X-Model header wins, else the JSON "model" field; none
            # means the default tenant.  An unknown model is 404.
            model_spec = self.headers.get("X-Model")
            if model_spec is None:
                model_spec = payload_model
            model_id, tenant = None, 0
            if app.zoo is not None:
                try:
                    model_id = app.zoo.resolve(model_spec)
                    tenant = app.zoo.tenant_index(model_id)
                except KeyError as exc:
                    app.record_request(len(x), ms(), "bad_model",
                                       probe=is_probe)
                    self._reply(404, {"error": str(exc.args[0]),
                                      "tenants": app.zoo.tenant_ids})
                    return
            elif model_spec not in (None, "", "default"):
                app.record_request(len(x), ms(), "bad_model", probe=is_probe)
                self._reply(404, {
                    "error": f"model {model_spec!r} requested but no model "
                             "zoo is configured (single-model server; "
                             "start with --zoo)"})
                return
            deadline = (None if deadline_ms is None
                        else time.monotonic() + deadline_ms / 1000.0)
            # X-Priority traffic passes the adaptive limit (bulk sheds
            # first).
            priority = (self.headers.get("X-Priority") or "").lower() \
                in ("high", "control", "session")
            try:
                fut = app.batcher.submit(x, deadline=deadline,
                                         priority=priority, tenant=tenant,
                                         exempt=is_probe)
                # Enqueued: the future's resolution owns the probe slot
                # now (a request dropped before its forward never reaches
                # the breaker through infer_fn).
                probe_open = False
                fut.add_done_callback(self._reconcile_probe)
                preds = fut.result(timeout=REQUEST_TIMEOUT_S)
            except DeadlineExceeded as exc:
                app.record_request(len(x), ms(), "expired", probe=is_probe)
                self._reply(504, {"error": str(exc),
                                  "deadline_ms": deadline_ms})
                return
            except Shed as exc:
                app.record_request(len(x), ms(), "shed", probe=is_probe)
                self._reply(429, {"error": str(exc), "shed": True})
                return
            except Rejected as exc:
                app.record_request(len(x), ms(), "rejected", probe=is_probe)
                self._reply(429, {"error": str(exc)})
                return
            except Exception as exc:  # noqa: BLE001 — inference/timeout
                app.record_request(len(x), ms(), "error", probe=is_probe)
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
        finally:
            if probe_open:
                app.breaker.cancel_probe()
        latency_ms = ms()
        if deadline is not None and time.monotonic() > deadline:
            app.record_request(len(x), latency_ms, "expired", probe=is_probe)
            self._reply(504, {"error": "response ready after the request "
                                       "deadline expired",
                              "deadline_ms": deadline_ms,
                              "latency_ms": round(latency_ms, 3)})
            return
        app.record_request(len(x), latency_ms, "ok", probe=is_probe,
                           model=model_id)
        if app.adapt is not None and model_id is not None and not is_probe:
            # The shadow's tee of bulk traffic: sampled, never blocking.
            app.adapt.tee_predictions(model_id, x, preds)
        reply = {
            "predictions": [int(p) for p in preds],
            "class_names": list(CLASS_NAMES), "n": len(x),
            "latency_ms": round(latency_ms, 3),
            "model_digest": (app.zoo.digest_for(model_id)
                             if app.zoo is not None
                             else app.registry.digest)}
        if model_id is not None:
            reply["model"] = model_id
        self._reply(200, reply)

    def _reconcile_probe(self, fut) -> None:
        """Release the breaker's probe slot when the request was dropped
        before any forward (expired at dequeue, refused at shutdown)."""
        if fut.cancelled():
            self.app.breaker.cancel_probe()
            return
        if isinstance(fut.exception(), (DeadlineExceeded, Rejected)):
            self.app.breaker.cancel_probe()

    def _profile(self, app: ServeApp) -> None:
        """``POST /profile``: 202 with the window's descriptor, 409 while
        one runs, 400 for a bad body."""
        try:
            payload = json.loads(self._read_body().decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            seconds = float(payload.get("seconds", DEFAULT_PROFILE_S))
            if not math.isfinite(seconds) or seconds <= 0:
                raise ValueError(
                    f"seconds must be a finite number > 0, got {seconds}")
            log_dir = payload.get("log_dir")
            if log_dir is not None and not isinstance(log_dir, str):
                raise ValueError("log_dir must be a string path")
        except Exception as exc:  # noqa: BLE001 — client error
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        started = app.start_profile(seconds, log_dir=log_dir)
        if started is None:
            self._reply(409, {"error": "a profile window is already "
                                       "running; retry after it closes"})
            return
        self._reply(202, {"status": "started", "max_s": PROFILE_MAX_S,
                          **started})

    def _reload(self, app: ServeApp) -> None:
        """``POST /reload``: 200 with the new digest, or 400 with the old
        model still serving."""
        try:
            payload = json.loads(self._read_body().decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            if app.zoo is not None:
                # One tenant's weights ("model" defaults to the default
                # tenant; no checkpoint re-pushes that tenant's own file).
                model_id = app.zoo.resolve(payload.get("model"))
                checkpoint = (payload.get("checkpoint")
                              or app.zoo.checkpoint_for(model_id))
                digest = app.zoo.reload(model_id, checkpoint)
                if model_id == app.zoo.default_id:
                    app.checkpoint = str(checkpoint)
                self._reply(200, {
                    "status": "ok", "model": model_id,
                    "checkpoint": str(checkpoint), "model_digest": digest,
                    "stacked": app.zoo.stacked is not None,
                    "zoo_restacks": app.zoo.restacks,
                    "model_swaps": app.registry.swaps})
                return
            checkpoint = payload.get("checkpoint") or app.checkpoint
            engine = app.registry.reload(checkpoint)
        except Exception as exc:  # noqa: BLE001 — reload must not kill serving
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        app.checkpoint = str(checkpoint)
        self._reply(200, {"status": "ok", "checkpoint": str(checkpoint),
                          "model_digest": engine.digest,
                          "model_swaps": app.registry.swaps})


    # -- streaming session routes ------------------------------------------
    def _session_json(self, session, **extra) -> dict:
        return {"session": session.session_id, "acked": session.acked,
                "windows": session.windows_decided,
                "expired": session.n_expired,
                "seeded": session.ems.seeded,
                "window": session.window, "hop": session.hop,
                "deadline_ms": session.deadline_ms, **extra}

    def _session_open(self, app: ServeApp) -> None:
        try:
            payload = json.loads(self._read_body().decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            sid = payload.get("session") or os.urandom(6).hex()
            c, t = app.registry.geometry
            window = int(payload.get("window", t))
            if window != t:
                raise ValueError(
                    f"window must equal the model's input length ({t}), "
                    f"got {window}")
            hop = int(payload.get("hop", max(1, t // 4)))
            deadline_ms = payload.get("deadline_ms")
            session, resumed = app.sessions.open(
                sid, n_channels=c, window=window, hop=hop,
                deadline_ms=(None if deadline_ms is None
                             else float(deadline_ms)),
                ems_factor_new=float(payload.get("ems_factor_new", 1e-3)),
                ems_init_block_size=int(
                    payload.get("ems_init_block_size", 1000)),
                ems_eps=float(payload.get("ems_eps", 1e-10)))
        except Exception as exc:  # noqa: BLE001 — client error
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        if not resumed:
            app.count_session_opened()
            app.journal.event("session_start", session=session.session_id,
                              hop=session.hop, window=session.window,
                              deadline_ms=session.deadline_ms,
                              n_channels=session.n_channels)
            app.journal.metrics.inc("sessions_opened")
        # Re-opening a restored (or live) session returns its acked cursor
        # unchanged: this reply is the resume handshake, and the client
        # replays its stream from sample ``acked``.
        self._reply(200, self._session_json(
            session, resumed=resumed, n_channels=session.n_channels,
            class_names=list(CLASS_NAMES)))

    def _get_session(self, app: ServeApp, sid: str):
        try:
            return app.sessions.get(sid)
        except KeyError:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return None

    def _parse_samples(self, session, body: bytes) -> np.ndarray:
        """A ``(C, n)`` chunk from raw little-endian float32 bytes
        (channel-major) or ``{"samples": [[...]]}`` JSON."""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        c = session.n_channels
        if ctype == "application/json":
            payload = json.loads(body.decode())
            if not isinstance(payload, dict) or "samples" not in payload:
                raise ValueError('JSON body must be {"samples": [[...]]}')
            x = np.asarray(payload["samples"], np.float32)
        else:
            if len(body) % (4 * c):
                raise ValueError(
                    f"raw body length {len(body)} is not a whole number of "
                    f"float32 ({c}, n) samples")
            x = np.frombuffer(body, np.dtype("<f4")).reshape(c, -1)
        if x.ndim != 2 or x.shape[0] != c:
            raise ValueError(
                f"expected a ({c}, n) chunk, got {tuple(x.shape)}")
        return x

    def _session_samples(self, app: ServeApp, sid: str) -> None:
        body = self._read_body()
        session = self._get_session(app, sid)
        if session is None:
            return
        ctx = trace.maybe_start(self.headers, app.trace_sample)
        with trace.use(ctx), trace.span("session.samples",
                                        journal=app.journal, session=sid):
            try:
                with trace.span("http.parse", journal=app.journal):
                    chunk = self._parse_samples(session, body)
            except Exception as exc:  # noqa: BLE001 — client error
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            # An armed session.drift turns the chunk into x*scale + offset
            # before the EMS carry (K2s on the card) sees it; fire()
            # journals the fault_injected event.
            try:
                inject.fire("session.drift", session=sid,
                            n_samples=int(chunk.shape[1]))
            except inject.DriftInjected as drift:
                chunk = chunk * drift.scale + drift.offset
            # One lock across ingest and decide: two pushes of one session
            # must not interleave their windows.
            with session.lock:
                ready = session.ingest(chunk)
                decisions = app.decide_windows(session, ready)
                reply = self._session_json(
                    session, decisions=[d.as_json() for d in decisions])
        app.sessions.maybe_snapshot()
        self._reply(200, reply)

    def _session_label(self, app: ServeApp, sid: str) -> None:
        """``POST /session/<id>/label`` — ``{"window": i, "label": c}``:
        the true class of a decided window, recorded in the session's
        durable state and journaled (``session_label``).  Unknown session
        or undecided window 404, a malformed body 400, a conflicting
        duplicate or a window without an ``ok`` decision 409, an exact
        duplicate 200 with ``fresh: false``.  With ``--adapt`` the label
        also pairs with the captured window for the adaptation loop
        (``paired``); labels persist with the session either way."""
        body = self._read_body()
        session = self._get_session(app, sid)
        if session is None:
            return
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            if "window" not in payload or "label" not in payload:
                raise ValueError('body must carry {"window": i, "label": c}')
            window = int(payload["window"])
            label = int(payload["label"])
            if not 0 <= label < len(CLASS_NAMES):
                raise ValueError(
                    f"label must be in [0, {len(CLASS_NAMES) - 1}], "
                    f"got {label}")
        except Exception as exc:  # noqa: BLE001 — client error
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        with session.lock:
            try:
                fresh = session.label(window, label)
            except LabelConflict as exc:
                self._reply(409, {"error": str(exc)})
                return
            except KeyError as exc:
                self._reply(404, {"error": str(exc.args[0])})
                return
            except ValueError as exc:
                self._reply(400, {"error": str(exc)})
                return
            live_pred = None
            rel = window - session.preds_offset
            if 0 <= rel < len(session.decisions):
                decision = session.decisions[rel]
                if decision.status == STATUS_OK:
                    live_pred = int(decision.pred)
            n_labels = len(session.labels)
        if fresh:
            app.journal.event("session_label", session=sid, window=window,
                              label=label, live_pred=live_pred)
            app.journal.metrics.inc("session_labels")
        paired = False
        if app.adapt is not None:
            paired = app.adapt.on_label(app.zoo.default_id, sid, window,
                                        label, live_pred=live_pred)
        self._reply(200, {"session": sid, "window": window, "label": label,
                          "fresh": fresh, "paired": paired,
                          "labels": n_labels})

    def _adapt_rollback(self, app: ServeApp) -> None:
        """``POST /adapt/rollback`` — ``{"model": id?}``: the tenant's
        pre-promotion weights back through the zero-drop reload; 409 when
        nothing was promoted, 404 for an unknown tenant or without
        ``--adapt``, 400 for a bad body or a failed reload."""
        body = self._read_body()
        if app.adapt is None:
            self._reply(404, {"error": "adaptation not enabled; start "
                                       "with --adapt"})
            return
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
            model = payload.get("model")
        except Exception as exc:  # noqa: BLE001 — client error
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        try:
            result = app.adapt.rollback(model)
        except LookupError as exc:
            if isinstance(exc, KeyError):
                self._reply(404, {"error": str(exc.args[0])})
            else:
                self._reply(409, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — a reload must not 500
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {"status": "ok", **result,
                          "model_swaps": app.registry.swaps})

    def _session_state(self, app: ServeApp, sid: str) -> None:
        session = self._get_session(app, sid)
        if session is None:
            return
        with session.lock:
            tail = [d.as_json() for d in session.decisions[-16:]]
            reply = self._session_json(session, decisions_tail=tail,
                                       model_digest=app.registry.digest)
        self._reply(200, reply)

    def _session_export(self, app: ServeApp, sid: str) -> None:
        """One session as a stamped single-session npz (the migration wire
        format).  A GET: the session stays live here until ``/discard``."""
        try:
            data = app.sessions.export_session(sid)
        except KeyError:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return
        self._reply_bytes(200, data, content_type="application/octet-stream")

    def _session_import(self, app: ServeApp) -> None:
        """Re-materialize an exported session here: a corrupt or tampered
        payload 400, an id already open 409, both with every live session
        untouched."""
        try:
            session = app.sessions.import_session(self._read_body())
        except SessionExists as exc:
            self._reply(409, {"error": str(exc)})
            return
        except IntegrityError as exc:
            self._reply(400, {"error": f"IntegrityError: {exc}"})
            return
        except Exception as exc:  # noqa: BLE001 — client error
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, self._session_json(
            session, imported=True, n_channels=session.n_channels))

    def _session_discard(self, app: ServeApp, sid: str) -> None:
        """Drop a session without deciding its buffered windows (the
        source of a migration, once the target imported it); the removal
        is persisted and scrubbed from the snapshot generations."""
        self._read_body()
        session = app.sessions.take(sid)
        if session is None:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return
        with session.lock:
            reply = self._session_json(session, discarded=True)
            app.journal.event("session_end", session=session.session_id,
                              windows=session.windows_decided,
                              expired=session.n_expired,
                              acked=session.acked, reason="migrated")
        app.sessions.snapshot()
        app.sessions.compact_departed(sid)
        self._reply(200, reply)

    def _session_close(self, app: ServeApp, sid: str) -> None:
        # Claim the session atomically: of two racing closes one drains
        # and journals, the other gets a clean 404.
        self._read_body()
        session = app.sessions.take(sid)
        if session is None:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return
        with session.lock:
            ready = session.finish()
            app.decide_windows(session, ready)
            preds = [int(p) for p in session.preds()]
            reply = self._session_json(session, preds=preds,
                                       preds_offset=session.preds_offset,
                                       class_names=list(CLASS_NAMES))
            app.journal.event("session_end", session=session.session_id,
                              windows=session.windows_decided,
                              expired=session.n_expired,
                              acked=session.acked)
            app.journal.metrics.inc("sessions_closed")
        # Persist the smaller table, and scrub the closed stream from the
        # generation chain, so no restart resurrects it.
        app.sessions.snapshot()
        app.sessions.compact_departed(sid)
        self._reply(200, reply)


def serve_until_preempted(app: ServeApp, poll_s: float = 0.2,
                          before_stop=None) -> None:
    """Block until a graceful-stop request, then drain and stop
    (``before_stop`` runs first: the prober stops before the listener
    closes, so no canary meets a draining server)."""
    try:
        while not preempt.requested():
            inject.fire("host.preempt")
            time.sleep(poll_s)
    finally:
        logger.info("Stop requested — draining the request queue")
        if before_stop is not None:
            before_stop()
        app.stop(drain=True)


def main(argv=None) -> int:
    stackdump.install()
    device = select_device()
    parser = argparse.ArgumentParser(
        description="Online EEG inference service (torch port: bucketed "
                    "engine on the card as captured CUDA graphs, dynamic "
                    "micro-batching, model hot-reload, the serving "
                    "control plane).")
    parser.add_argument("--checkpoint", default=None,
                        help=".npz (native) or .pth (reference format).  "
                             "Required unless --zoo is given.")
    parser.add_argument("--zoo", default=None,
                        help="Multi-tenant model zoo: 'id=path,id=path' "
                             "pairs or a directory of checkpoints (each "
                             "*.npz/*.pth becomes a tenant keyed by file "
                             "stem).  Requests then address a model via "
                             "the X-Model header / 'model' JSON field; "
                             "same-architecture tenants serve through ONE "
                             "stacked forward per bucket.")
    parser.add_argument("--defaultModel", default=None,
                        help="The tenant answering requests that name no "
                             "model (default: the zoo's first entry).")
    parser.add_argument("--maxPrograms", type=int, default=0,
                        help="Budget of resident per-model engines in "
                             "bucket programs (each costs one per bucket); "
                             "LRU tenants evict past it.  0 = unbounded.  "
                             "The stacked engine is exempt.")
    parser.add_argument("--noStack", action="store_true",
                        help="Serve the zoo through per-model engines "
                             "only (skip the stacked forward).")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8790,
                        help="Listen port (0 = ephemeral).")
    parser.add_argument("--buckets", default=None,
                        help="Comma-separated padded-batch ladder "
                             f"(default {','.join(map(str, DEFAULT_BUCKETS))}).")
    parser.add_argument("--maxWaitMs", type=float, default=5.0,
                        help="Micro-batch coalescing window from the first "
                             "queued request.")
    parser.add_argument("--maxQueue", type=int, default=512,
                        help="Queue bound in trials; beyond it requests "
                             "are rejected with 429.")
    parser.add_argument("--precision", choices=list(PRECISIONS),
                        default="fp32",
                        help="Engine weight precision.  int8 runs the "
                             "mandatory fp32-argmax equivalence gate at "
                             "load and falls back to fp32 on refusal.")
    parser.add_argument("--quantFloor", type=float,
                        default=QUANT_AGREEMENT_FLOOR,
                        help="Minimum per-subject int8-vs-fp32 argmax "
                             "agreement for the quantized engine to "
                             "serve.")
    parser.add_argument("--tuneEveryS", type=float, default=0.0,
                        help="Ladder self-tuning interval in seconds "
                             "(0 = off): observe bucket occupancy and "
                             "arrival rate, retune the ladder (its graphs "
                             "captured off the hot path).")
    parser.add_argument("--traceSample", type=float,
                        default=trace.DEFAULT_SAMPLE_RATE,
                        help="Head-based trace sampling rate for requests "
                             "arriving without an X-Trace-Id header "
                             "(0 = off, 1 = every request).  Errors, "
                             "expired deadlines and circuit refusals "
                             "always flush their buffered spans.")
    parser.add_argument("--admissionTargetMs", type=float, default=0.0,
                        help="Adaptive overload control: AIMD the "
                             "admitted queue depth so queue-wait p95 "
                             "tracks this target (0 = the static queue "
                             "bound alone).  Bulk /predict sheds first "
                             "(429); X-Priority and session traffic meet "
                             "only the --maxQueue bound.")
    parser.add_argument("--chaos", type=str, default=None,
                        help="Fault-injection plan armed for this serving "
                             "process (the train CLI's syntax), e.g. "
                             "'serve.forward:times=1' or "
                             "'serve.degrade:slow=0.25:times=0'.")
    parser.add_argument("--chaosTag", type=str, default=None,
                        help="Tag carried to the serve.degrade site so an "
                             "if_tag= spec targets exactly this server.")
    parser.add_argument("--slo", type=str, default=None,
                        help="SLO spec evaluated over a sliding window of "
                             "live metrics, e.g. 'p95_latency_ms<50,"
                             "error_rate<0.01,availability>0.999'.  A "
                             "breach journals slo_breach and degrades "
                             "/healthz until it recovers.")
    parser.add_argument("--sloWindowS", type=float,
                        default=obs_slo.DEFAULT_WINDOW_S,
                        help="SLO evaluation window in seconds.")
    parser.add_argument("--breakerThreshold", type=int, default=5,
                        help="Consecutive serve.forward failures (after "
                             "the retry) that open the circuit breaker "
                             "(fast 503s until a half-open probe "
                             "succeeds).")
    parser.add_argument("--breakerResetS", type=float, default=30.0,
                        help="Open-circuit cooldown before half-open "
                             "probe requests are admitted.")
    parser.add_argument("--metricsDir", type=str, default=None,
                        help="Run-journal root (default reports/obs).")
    parser.add_argument("--sessionsDir", type=str, default=None,
                        help="Durable session-snapshot directory (default "
                             "checkpoints/serve_sessions under the data "
                             "root).  Must be stable across restarts: it "
                             "is what --resume restores from.")
    parser.add_argument("--sessionSnapshotEvery", type=int, default=50,
                        help="Snapshot session state every N decided "
                             "windows (plus at every close and at the "
                             "SIGTERM drain).")
    parser.add_argument("--sessionsMirror", type=str, default=None,
                        help="Second directory every session snapshot is "
                             "also written to.")
    parser.add_argument("--probeIntervalS", type=float, default=0.0,
                        help="Black-box self-probing interval in seconds "
                             "(0 = off): POST a known-answer canary to "
                             "this server's own /predict on a jittered "
                             "cadence, journal probe events, and evaluate "
                             "the outside-in --probeSlo.  Probes carry "
                             "X-Probe and stay out of the admission/"
                             "tuner statistics and the server-side SLO.")
    parser.add_argument("--probeSlo", type=str,
                        default=obs_probe.DEFAULT_PROBE_SLO,
                        help="SLO spec evaluated over the prober's own "
                             "sliding window of client-vantage outcomes "
                             "(availability / error_rate / pNN_latency_"
                             "ms).")
    parser.add_argument("--adapt", action="store_true",
                        help="Closed-loop online adaptation: accumulate "
                             "POST /session/<id>/label ground truth, "
                             "fine-tune the tenant off the hot path, "
                             "score the candidate as a non-serving "
                             "shadow on sampled live traffic, and "
                             "promote through the zero-drop reload only "
                             "when the gate floors clear.  A single "
                             "--checkpoint is auto-wrapped into a "
                             "one-tenant zoo.")
    parser.add_argument("--adaptDir", type=str, default=None,
                        help="Candidate/promoted checkpoint directory "
                             "(default: <sessionsDir>/adapt).")
    parser.add_argument("--adaptTriggerLabels", type=int, default=16,
                        help="Fresh labels that trigger a fine-tune.")
    parser.add_argument("--adaptSteps", type=int, default=60,
                        help="Fine-tune optimization steps per "
                             "candidate.")
    parser.add_argument("--adaptLr", type=float, default=1e-3,
                        help="Fine-tune learning rate (the reference "
                             "Adam).")
    parser.add_argument("--adaptSampleEvery", type=int, default=1,
                        help="Tee every Nth live window to the shadow "
                             "(labeled windows are always teed).")
    parser.add_argument("--adaptMinShadow", type=int, default=12,
                        help="Minimum shadow forwards before the "
                             "promotion gate decides.")
    parser.add_argument("--adaptMinLabeled", type=int, default=8,
                        help="Minimum ground-truth shadow evals before "
                             "the promotion gate decides.")
    parser.add_argument("--adaptAccuracyFloor", type=float, default=0.55,
                        help="Labeled-accuracy floor the candidate must "
                             "clear to promote (refused below it).")
    parser.add_argument("--adaptAgreementFloor", type=float, default=0.0,
                        help="Live-agreement floor (0 disables: after a "
                             "real drift the live model is the wrong "
                             "reference).")
    parser.add_argument("--resume", action="store_true",
                        help="Restore streaming sessions from the newest "
                             "valid snapshot generation in --sessionsDir; "
                             "clients then replay from their acked "
                             "cursor.")
    args = parser.parse_args(argv)

    if bool(args.checkpoint) == bool(args.zoo):
        parser.error("exactly one of --checkpoint or --zoo is required")
    zoo_spec = None
    if args.zoo:
        from eegnetreplication_tpu_torch.serve.zoo import parse_zoo_spec

        try:
            zoo_spec = parse_zoo_spec(args.zoo)
            if args.defaultModel and args.defaultModel not in zoo_spec:
                raise ValueError(
                    f"--defaultModel {args.defaultModel!r} is not a zoo "
                    f"tenant (have {list(zoo_spec)})")
        except ValueError as exc:
            parser.error(f"--zoo: {exc}")
    if args.adapt:
        if zoo_spec is None:
            # Adaptation needs the zoo's shadow and per-tenant reload; a
            # lone checkpoint becomes a one-tenant zoo whose default tenant
            # answers as before.
            zoo_spec = {"default": args.checkpoint}
            args.checkpoint = None
        try:
            PromotionGate(min_samples=args.adaptMinShadow,
                          min_labeled=args.adaptMinLabeled,
                          accuracy_floor=args.adaptAccuracyFloor,
                          agreement_floor=args.adaptAgreementFloor)
            if args.adaptTriggerLabels < 1:
                raise ValueError(
                    f"--adaptTriggerLabels must be >= 1, got "
                    f"{args.adaptTriggerLabels}")
            if args.adaptSampleEvery < 1:
                raise ValueError(
                    f"--adaptSampleEvery must be >= 1, got "
                    f"{args.adaptSampleEvery}")
            if args.adaptSteps < 1:
                raise ValueError(
                    f"--adaptSteps must be >= 1, got {args.adaptSteps}")
        except ValueError as exc:
            parser.error(f"--adapt: {exc}")
    try:
        buckets = (tuple(sorted({int(b) for b in args.buckets.split(",")}))
                   if args.buckets else DEFAULT_BUCKETS)
        if not buckets or buckets[0] < 1:
            raise ValueError("buckets must be positive integers")
    except ValueError as exc:
        parser.error(f"--buckets: {exc}")
    if args.slo:
        try:
            obs_slo.parse_slo_spec(args.slo)
        except ValueError as exc:
            parser.error(f"--slo: {exc}")
    if args.probeSlo:
        try:
            obs_slo.parse_slo_spec(args.probeSlo)
        except ValueError as exc:
            parser.error(f"--probeSlo: {exc}")
    chaos_specs = []
    if args.chaos:
        try:
            chaos_specs = inject.parse_plan(args.chaos)
        except (ValueError, OSError) as exc:
            parser.error(f"--chaos: {exc}")

    from eegnetreplication_tpu_torch.config import Paths

    paths = Paths.from_here()
    metrics_dir = (Path(args.metricsDir) if args.metricsDir
                   else paths.reports / "obs")
    sessions_dir = (Path(args.sessionsDir) if args.sessionsDir
                    else paths.checkpoints / "serve_sessions")
    with obs_journal.run(metrics_dir, config=vars(args)) as journal, \
            preempt.guard(), inject.scoped(*chaos_specs):
        app = ServeApp(args.checkpoint, host=args.host, port=args.port,
                       buckets=buckets, max_wait_ms=args.maxWaitMs,
                       max_queue_trials=args.maxQueue, device=device,
                       precision=args.precision,
                       quant_floor=args.quantFloor, zoo=zoo_spec,
                       default_model=args.defaultModel,
                       max_programs=args.maxPrograms,
                       stack=not args.noStack, sessions_dir=sessions_dir,
                       sessions_mirror=args.sessionsMirror,
                       session_snapshot_every=args.sessionSnapshotEvery,
                       resume=args.resume, journal=journal,
                       breaker_threshold=args.breakerThreshold,
                       breaker_reset_s=args.breakerResetS,
                       tune_every_s=args.tuneEveryS,
                       trace_sample=args.traceSample, slo_spec=args.slo,
                       slo_window_s=args.sloWindowS,
                       admission_target_ms=args.admissionTargetMs,
                       chaos_tag=args.chaosTag, adapt=args.adapt,
                       adapt_dir=args.adaptDir,
                       adapt_trigger_labels=args.adaptTriggerLabels,
                       adapt_steps=args.adaptSteps, adapt_lr=args.adaptLr,
                       adapt_sample_every=args.adaptSampleEvery,
                       adapt_min_shadow=args.adaptMinShadow,
                       adapt_min_labeled=args.adaptMinLabeled,
                       adapt_accuracy_floor=args.adaptAccuracyFloor,
                       adapt_agreement_floor=args.adaptAgreementFloor)
        app.start()
        print(f"serving at {app.url}", flush=True)
        # Self-probing: canaries through this server's own front door,
        # journaled into the same run.
        prober = None
        if args.probeIntervalS > 0:
            prober = obs_probe.Prober(
                app.url, interval_s=args.probeIntervalS,
                slo=args.probeSlo or None, journal=journal).start()
        serve_until_preempted(
            app, before_stop=prober.stop if prober is not None else None)
    # A SIGTERM-drained server exits EX_PREEMPTED ("relaunch me"); a clean
    # 0 means the service ended on purpose.
    return preempt.EX_PREEMPTED if preempt.requested() else 0


if __name__ == "__main__":
    raise SystemExit(main())
