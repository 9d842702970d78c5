"""Fleet service wiring: router HTTP process + supervised replica fleet.

``python -m eegnetreplication_tpu_torch.serve.fleet --checkpoint m.npz
--replicas 4`` spawns N single-process serving replicas (each its own
``python -m eegnetreplication_tpu_torch.serve`` child with a private port and
heartbeat file) under a
:class:`~eegnetreplication_tpu_torch.resil.supervise.MultiSupervisor` — a
crashed replica is relaunched and rejoins membership automatically — and
binds the router endpoint in front of them:

- ``POST /predict`` — least-loaded dispatch with failover (see
  :mod:`~eegnetreplication_tpu_torch.serve.fleet.router`); the replica's
  response passes through unchanged, plus a ``routed_to`` field is NOT
  injected (bytes pass through verbatim — the replica already reports
  which digest answered).
- ``POST /reload`` — rolling canary reload of the whole fleet
  (:mod:`~eegnetreplication_tpu_torch.serve.fleet.canary`); synchronous, one
  at a time (a concurrent reload answers 409).
- ``GET /healthz`` — fleet membership snapshot: per-replica state,
  digest, queue depth, circuit state; 503 when no replica is live.
- ``GET /metrics`` — the router run's metrics-registry snapshot.

The router process journals every membership/dispatch/canary decision as
``fleet_*`` events into its own obs run; each replica keeps its own
single-process serving journal.  The router runs no model and touches no
card; its replicas inherit its environment, so they run on ``cuda:0``
unless the caller set ``EEGTPU_PLATFORM=cpu`` (a host without CUDA stops
``main`` before any replica starts).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import socket
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from pathlib import Path

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.obs.stats import percentile
from eegnetreplication_tpu_torch.resil import preempt, stackdump, supervise
from eegnetreplication_tpu_torch.serve.admission import ArrivalWindow
from eegnetreplication_tpu_torch.serve.service import (
    PASSTHROUGH_HEADERS,
    JsonRequestHandler,
)
from eegnetreplication_tpu_torch.serve.fleet import membership as ms
from eegnetreplication_tpu_torch.serve.fleet.autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
)
from eegnetreplication_tpu_torch.serve.fleet.canary import RollingReload
from eegnetreplication_tpu_torch.serve.fleet.outlier import OutlierEjector
from eegnetreplication_tpu_torch.serve.sessions import store as session_store
from eegnetreplication_tpu_torch.serve.fleet.router import (
    AllReplicasBusy,
    FleetRouter,
    HedgePolicy,
    NoLiveReplicas,
)
from eegnetreplication_tpu_torch.utils.logging import logger


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (bind-probe; the usual small race is
    acceptable for spawning local replicas)."""
    with socket.socket() as sock:
        sock.bind((host, 0))
        return sock.getsockname()[1]


def replica_specs(urls: list[str], *,
                  heartbeat_files: list[Path | None] | None = None,
                  journal=None) -> list[ms.Replica]:
    """Replicas (r0, r1, ...) for a list of base URLs."""
    hbs = heartbeat_files or [None] * len(urls)
    return [ms.Replica(f"r{i}", url, heartbeat_file=hb, journal=journal)
            for i, (url, hb) in enumerate(zip(urls, hbs))]


class FleetApp:
    """The assembled fleet endpoint: membership + router + HTTP listener."""

    def __init__(self, replicas: list[ms.Replica], checkpoint: str, *,
                 host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.25, predict_timeout_s: float = 60.0,
                 shadow_n: int = 16, agree_floor: float = 0.0,
                 trace_sample: float = trace.DEFAULT_SAMPLE_RATE,
                 outlier_k: float = 0.0, outlier_cooldown_s: float = 5.0,
                 hedge_budget: float = 0.0,
                 on_checkpoint_change=None, journal=None):
        self.journal = journal if journal is not None \
            else obs_journal.current()
        self.checkpoint = str(checkpoint)
        # Called with the new checkpoint after a reload converges, so the
        # process that SPAWNS replicas (the supervisor wiring) can update
        # its launch commands — without this, a replica crash after a
        # converged roll would be relaunched on the OLD weights and
        # silently rejoin rotation serving them.
        self._on_checkpoint_change = on_checkpoint_change
        self.membership = ms.FleetMembership(replicas, poll_s=poll_s,
                                             journal=self.journal)
        # Gray-failure defenses (both opt-in, 0 = off): the latency-
        # outlier ejector and the hedged-dispatch policy.
        self.outlier = (OutlierEjector(
            self.membership, k=outlier_k, cooldown_s=outlier_cooldown_s,
            journal=self.journal) if outlier_k and outlier_k > 0 else None)
        hedge = (HedgePolicy(budget_fraction=hedge_budget)
                 if hedge_budget and hedge_budget > 0 else None)
        self.router = FleetRouter(self.membership,
                                  predict_timeout_s=predict_timeout_s,
                                  journal=self.journal,
                                  outlier=self.outlier, hedge=hedge)
        self.shadow_n = int(shadow_n)
        self.agree_floor = float(agree_floor)
        # The router is the TRACE EDGE: the head-based sampling decision
        # for the whole request tree is made here and propagated to the
        # replica over the X-Trace-Id/X-Parent-Span headers.
        self.trace_sample = float(trace_sample)
        self._host, self._port = host, int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._listener: threading.Thread | None = None
        self._stopped = False
        # Session stickiness: a streaming session's state lives in ONE
        # replica's store, so every /session/* request for an id must
        # land on the replica that opened it.  A sticky replica that is
        # down answers 503 until the supervisor relaunches it on the
        # same port (with --resume when the fleet serves sessions) and
        # membership rejoins it — the client's replay-from-acked
        # handshake covers the gap, exactly like a single-process
        # restart.
        self._session_lock = threading.Lock()
        self._session_affinity: dict[str, str] = {}
        # One lock per session id, held across an open's pick+forward+
        # assign: two concurrent opens of the same id must not land on
        # two replicas (last-writer-wins affinity would orphan a live
        # session on the loser).
        self._session_open_locks: dict[str, threading.Lock] = {}
        self._reload_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._counts = {"ok": 0, "rejected": 0, "no_replicas": 0,
                        "bad_request": 0, "error": 0}
        self._inflight = 0
        self._idle = threading.Condition(self._stats_lock)
        self._t_start = time.perf_counter()
        # Rolling load windows for the autoscaler: offered load (every
        # recorded request, shed/bounced included) and completed
        # throughput + latency over the same trailing window.
        self._window_s = 5.0
        self.arrivals = ArrivalWindow(window_s=self._window_s)
        self._ok_window: list[tuple[float, float]] = []  # (t, latency_ms)
        # Bound by the --autoscale wiring; surfaces on /healthz when set.
        self.autoscaler = None

    # -- lifecycle --------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("fleet server not started")
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "FleetApp":
        self.membership.start()
        app = self

        class Handler(_FleetHandler):
            pass

        Handler.app = app
        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._listener = threading.Thread(target=self._httpd.serve_forever,
                                          name="fleet-http", daemon=True)
        self._listener.start()
        self.journal.event(
            "fleet_start", checkpoint=self.checkpoint,
            replicas=[{"replica": r.replica_id, "url": r.url}
                      for r in self.membership.replicas],
            host=self.address[0], port=self.address[1])
        logger.info("Fleet router at %s over %d replicas", self.url,
                    len(self.membership.replicas))
        return self

    def stop(self, handler_timeout_s: float = 30.0) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.router.wait_idle()
        # Wait for in-flight handler THREADS, not just router dispatches:
        # a handler past dispatch still journals its 'request' event, and
        # fleet_end/run_end must land after every one of those lines.
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=handler_timeout_s):
                logger.warning("%d in-flight fleet handler(s) did not "
                               "finish within %.1fs", self._inflight,
                               handler_timeout_s)
            counts = dict(self._counts)
        self.membership.close()
        self.router.close()
        self.journal.event(
            "fleet_end", n_requests=sum(counts.values()), **counts,
            failovers=self.router.n_failovers,
            hedges_fired=self.router.n_hedges,
            hedges_won=self.router.n_hedge_wins,
            replica_ejections=(self.outlier.n_ejected
                               if self.outlier else 0),
            replica_readmissions=(self.outlier.n_readmitted
                                  if self.outlier else 0),
            wall_s=round(time.perf_counter() - self._t_start, 3))
        logger.info("Fleet stopped: %s (%d failovers)", counts,
                    self.router.n_failovers)

    # -- request accounting ------------------------------------------------
    def begin_request(self) -> None:
        with self._idle:
            self._inflight += 1

    def end_request(self) -> None:
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    def record(self, status: str, n_trials: int, latency_ms: float,
               replica: str | None) -> None:
        self.arrivals.record(1)
        now = time.monotonic()
        with self._stats_lock:
            self._counts[status] = self._counts.get(status, 0) + 1
            if status == "ok":
                self._ok_window.append((now, latency_ms))
                horizon = now - self._window_s
                while self._ok_window and self._ok_window[0][0] < horizon:
                    self._ok_window.pop(0)
        self.journal.event("request", n_trials=n_trials,
                           latency_ms=round(latency_ms, 3), status=status,
                           replica=replica)
        self.journal.metrics.inc("requests_total", status=status)
        if status == "ok":
            self.journal.metrics.observe("request_latency_ms", latency_ms)
        # Anomaly tail-capture mirrors the replica rule; a fleet with NO
        # live replica is the anomaly most worth a trace of all.
        if status == "no_replicas":
            trace.flush(journal=self.journal)
        else:
            trace.flush_if_anomalous(status, journal=self.journal)

    def window_stats(self) -> dict:
        """The autoscaler's measured-load view: offered arrivals/s,
        completed ok/s, and rolling ok-latency p95 over the trailing
        window (``p95_ms`` is None while the window is empty)."""
        now = time.monotonic()
        with self._stats_lock:
            horizon = now - self._window_s
            while self._ok_window and self._ok_window[0][0] < horizon:
                self._ok_window.pop(0)
            latencies = [lat for _, lat in self._ok_window]
        return {"arrival_rps": self.arrivals.rate(),
                "ok_rps": len(latencies) / self._window_s,
                "p95_ms": (percentile(latencies, 0.95)
                           if latencies else None)}

    # -- session stickiness ------------------------------------------------
    def session_replica(self, sid: str) -> ms.Replica | None:
        with self._session_lock:
            replica_id = self._session_affinity.get(sid)
        if replica_id is None:
            return None
        try:
            return self.membership.by_id(replica_id)
        except KeyError:
            return None

    def assign_session(self, sid: str, replica_id: str) -> None:
        with self._session_lock:
            self._session_affinity[sid] = replica_id

    def session_open_lock(self, sid: str) -> threading.Lock:
        with self._session_lock:
            lock = self._session_open_locks.get(sid)
            if lock is None:
                lock = self._session_open_locks[sid] = threading.Lock()
            return lock

    def drop_session(self, sid: str) -> None:
        with self._session_lock:
            self._session_affinity.pop(sid, None)
            self._session_open_locks.pop(sid, None)

    def pick_session_replica(self) -> ms.Replica | None:
        """Least-loaded live replica for a new session (fewest sticky
        sessions first, then the dispatch load key)."""
        candidates = self.membership.dispatchable()
        if not candidates:
            return None
        with self._session_lock:
            counts = {r.replica_id: 0 for r in candidates}
            for rid in self._session_affinity.values():
                if rid in counts:
                    counts[rid] += 1
        return min(candidates,
                   key=lambda r: (counts[r.replica_id], r.load))

    # -- rolling reload ----------------------------------------------------
    def rolling_reload(self, checkpoint: str, *,
                       shadow_n: int | None = None,
                       agree_floor: float | None = None) -> dict:
        """One rolling canary reload (serialized; raises RuntimeError when
        one is already running)."""
        if not self._reload_lock.acquire(blocking=False):
            raise RuntimeError("a rolling reload is already in progress")
        try:
            reload_ = RollingReload(
                self.router, checkpoint,
                previous_checkpoint=self.checkpoint,
                shadow_n=self.shadow_n if shadow_n is None else shadow_n,
                agree_floor=(self.agree_floor if agree_floor is None
                             else agree_floor),
                journal=self.journal)
            result = reload_.run()
            if result["status"] in ("converged", "partial"):
                self.checkpoint = str(checkpoint)
                if self._on_checkpoint_change is not None:
                    try:
                        self._on_checkpoint_change(str(checkpoint))
                    except Exception as exc:  # noqa: BLE001 — reload stands
                        logger.warning("on_checkpoint_change hook failed: "
                                       "%s", exc)
            return result
        finally:
            self._reload_lock.release()


class _FleetHandler(JsonRequestHandler):
    """Router endpoint handler (instances on ThreadingHTTPServer threads;
    journaling goes through ``self.app.journal`` explicitly — handler
    threads do not inherit contextvars).  Plumbing (_reply/_read_body/
    logging) is the shared serve-layer base."""

    app: FleetApp = None  # bound by FleetApp.start()

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        logger.debug("fleet http: " + fmt, *args)

    def do_GET(self):  # noqa: N802 — stdlib naming
        app = self.app
        if self.path == "/healthz":
            snapshot = app.membership.snapshot()
            n_live = sum(1 for r in snapshot if r["state"] == ms.LIVE)
            digests = sorted({r["digest"] for r in snapshot
                              if r["state"] == ms.LIVE and r["digest"]})
            # Aggregate per-replica SLO state (mirrored from each
            # replica's /healthz by the membership poll): which members
            # are currently breaching which objectives.  A breaching
            # replica answers 503 and is drained by membership, so the
            # aggregate also explains WHY a member left rotation.
            slo_breached = {r["replica"]: r["slo_breached"]
                            for r in snapshot if r.get("slo_breached")}
            with app._session_lock:
                n_sessions = len(app._session_affinity)
            self._reply(200 if n_live else 503, {
                "status": "ok" if n_live else "no_live_replicas",
                "n_replicas": len(snapshot), "n_live": n_live,
                "sessions": n_sessions,
                "checkpoint": app.checkpoint,
                "serving_digests": digests,
                "slo": {"replicas_breached": slo_breached,
                        "any_breached": bool(slo_breached)},
                # Gray-failure defenses: the ejector's per-replica rolling
                # latency view + who is currently degraded, and how often
                # hedged dispatch fired/won (null/zero when disabled).
                "outlier": (app.outlier.snapshot()
                            if app.outlier is not None else None),
                "hedges": {"fired": app.router.n_hedges,
                           "won": app.router.n_hedge_wins},
                "scale": (app.autoscaler.snapshot()
                          if app.autoscaler is not None else None),
                "replicas": snapshot})
            return
        if self.path == "/metrics":
            self._reply_metrics(app.journal)
            return
        parts = self.path.strip("/").split("/")
        if len(parts) == 3 and parts[0] == "session" \
                and parts[2] in ("state", "export"):
            # Bracketed like do_POST: stop() must wait for this forward
            # or closing the pooled clients mid-flight would fail it with
            # an OSError that marks a healthy replica unreachable.
            app.begin_request()
            try:
                self._session_forward(parts[1], "GET", self.path)
            finally:
                app.end_request()
            return
        self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib naming
        # In-flight bracketing covers everything that journals, so
        # FleetApp.stop() can hold fleet_end (and the run context's
        # run_end) until these threads finish — a straggler 'request'
        # event after the terminal record would break the completed-
        # stream contract (same hardening as ServeApp.stop).
        app = self.app
        app.begin_request()
        try:
            if self.path == "/predict":
                self._predict()
                return
            if self.path == "/reload":
                self._reload()
                return
            parts = self.path.strip("/").split("/")
            if parts[0] == "session":
                if len(parts) == 2 and parts[1] == "open":
                    self._session_open()
                    return
                if len(parts) == 2 and parts[1] == "import":
                    self._session_import()
                    return
                if len(parts) == 3 and parts[2] in ("samples", "label",
                                                    "close", "discard"):
                    # label rides the same sticky-replica forward as the
                    # sample stream: the replica holding the session's
                    # decision history (and its adaptation buffer) must
                    # be the one that pairs the ground truth.
                    self._session_forward(parts[1], "POST", self.path,
                                          body=self._read_body(),
                                          drop=parts[2] in ("close",
                                                            "discard"))
                    return
            self._reply(404, {"error": f"unknown path {self.path}"})
        finally:
            app.end_request()

    # -- session forwarding (sticky replica affinity) ----------------------
    def _forward_headers(self) -> dict:
        headers = {**trace.headers()}
        for name in ("Content-Type",) + PASSTHROUGH_HEADERS:
            if self.headers.get(name):
                headers[name] = self.headers[name]
        return headers

    def _forward_to(self, replica: ms.Replica, method: str, path: str,
                    body: bytes | None = None) -> tuple[int, bytes] | None:
        import http.client as _http

        try:
            return replica.client.request(method, path, body=body,
                                          headers=self._forward_headers())
        except (OSError, _http.HTTPException) as exc:
            self.app.membership.mark_unreachable(
                replica, f"session forward: {type(exc).__name__}")
            self._reply(503, {"error": f"replica {replica.replica_id} "
                                       f"unreachable: "
                                       f"{type(exc).__name__}"})
            return None

    def _session_forward(self, sid: str, method: str, path: str,
                         body: bytes | None = None,
                         drop: bool = False) -> None:
        app = self.app
        replica = app.session_replica(sid)
        if replica is None:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return
        if replica.state not in ms.DISPATCHABLE:
            # Down (crashed, draining): the supervisor relaunches it with
            # --resume on the same port; the client's resume handshake
            # rides out the 503s until then.
            self._reply(503, {"error": f"session {sid!r} replica "
                                       f"{replica.replica_id} is "
                                       f"{replica.state}; retry"})
            return
        result = self._forward_to(replica, method, path, body)
        if result is None:
            return
        status, data = result
        if status == 200 and drop:
            app.drop_session(sid)
        self._reply_bytes(status, data)

    def _session_open(self) -> None:
        app = self.app
        body = self._read_body()
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as exc:
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        sid = payload.get("session")
        if not sid:
            # Name anonymous sessions HERE: stickiness needs the id
            # before the replica assigns one.
            import os as _os

            sid = payload["session"] = _os.urandom(6).hex()
            body = json.dumps(payload).encode()
        sid = str(sid)
        with app.session_open_lock(sid):
            # Affinity is resolved UNDER the per-sid lock: two racing
            # opens of the same id must serialize, or both would pick a
            # (possibly different) replica and the losing replica would
            # hold a live orphan copy forever.
            replica = app.session_replica(sid)
            if replica is None or replica.state not in ms.DISPATCHABLE:
                if replica is not None:
                    # Known session on a down replica: opening it
                    # elsewhere would fork the stream — hold the line
                    # with 503 until the relaunch rejoins.
                    self._reply(503, {"error": f"session {sid!r} replica "
                                               f"{replica.replica_id} is "
                                               f"{replica.state}; retry"})
                    return
                replica = app.pick_session_replica()
                if replica is None:
                    self._reply(503, {"error": "no live replicas for "
                                               "sessions"})
                    return
            result = self._forward_to(replica, "POST", "/session/open",
                                      body)
            if result is None:
                return
            status, data = result
            if status == 200:
                app.assign_session(sid, replica.replica_id)
        self._reply_bytes(status, data)

    def _session_import(self) -> None:
        app = self.app
        body = self._read_body()
        # Imports must be idempotent per session id: the cells front
        # retries an import whose RESPONSE was lost after the fleet
        # committed it, and expects the second attempt to hit the same
        # store (409 SessionExists = "the stream is there").  Peek the id
        # so a repeat routes to the replica that already holds it instead
        # of forking the session onto a fresh least-loaded pick.
        sid = session_store.peek_session_id(body)
        lock = (app.session_open_lock(sid) if sid
                else contextlib.nullcontext())
        with lock:
            replica = app.session_replica(sid) if sid else None
            if replica is not None and replica.state not in ms.DISPATCHABLE:
                self._reply(503, {"error": f"session {sid!r} replica "
                                           f"{replica.replica_id} is "
                                           f"{replica.state}; retry"})
                return
            if replica is None:
                replica = app.pick_session_replica()
            if replica is None:
                self._reply(503, {"error": "no live replicas for sessions"})
                return
            result = self._forward_to(replica, "POST", "/session/import",
                                      body)
            if result is None:
                return
            status, data = result
            if status == 200:
                try:
                    sid = json.loads(data.decode()).get("session") or sid
                except (ValueError, UnicodeDecodeError):
                    pass
                if sid:
                    app.assign_session(str(sid), replica.replica_id)
        self._reply_bytes(status, data)

    def _predict(self) -> None:
        # The trace is born HERE (or inherited from an upstream edge):
        # the router's sampling verdict rides the dispatch headers to the
        # replica, so one decision governs the whole cross-process tree.
        app = self.app
        ctx = trace.maybe_start(self.headers, app.trace_sample)
        with trace.use(ctx), trace.span("router.request",
                                        journal=app.journal,
                                        route="/predict"):
            self._predict_traced()

    def _predict_traced(self) -> None:
        app = self.app
        t0 = time.perf_counter()
        body = self._read_body()
        content_type = (self.headers.get("Content-Type")
                        or "application/json").split(";")[0].strip()
        # The single-sourced passthrough set: X-Deadline-Ms (deadline
        # enforcement), X-Priority (two-class admission — without it a
        # control-class client behind the router would be shed as bulk),
        # X-Model (zoo addressing — a stripped header would silently
        # serve the default tenant's answers with a 200).
        passthrough = {h: self.headers[h] for h in PASSTHROUGH_HEADERS
                       if self.headers.get(h)}
        try:
            status, data, replica_id = app.router.dispatch(
                body, content_type, headers=passthrough)
        except AllReplicasBusy as exc:
            app.record("rejected", 0, (time.perf_counter() - t0) * 1000.0,
                       None)
            self._reply(429, {"error": str(exc)})
            return
        except NoLiveReplicas as exc:
            app.record("no_replicas", 0,
                       (time.perf_counter() - t0) * 1000.0, None)
            self._reply(503, {"error": str(exc)})
            return
        latency_ms = (time.perf_counter() - t0) * 1000.0
        # n_trials for the request event comes from the replica's reply,
        # but parsing is bounded: re-decoding a huge prediction body on
        # the router hot path just for one count is not worth it — large
        # responses journal n_trials=0 (the replica's own journal has the
        # exact figure).
        n_trials = 0
        if status == 200 and len(data) <= 16384:
            try:
                n_trials = int(json.loads(data.decode()).get("n", 0))
            except (ValueError, UnicodeDecodeError):
                n_trials = 0
        label = ("ok" if status == 200 else
                 "rejected" if status == 429 else
                 "bad_request" if 400 <= status < 500 else "error")
        app.record(label, n_trials, latency_ms, replica_id)
        self._reply_bytes(status, data)

    def _reload(self) -> None:
        app = self.app
        try:
            payload = json.loads(self._read_body().decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            self._reply(400, {"error": "reload body must be JSON"})
            return
        checkpoint = payload.get("checkpoint") or app.checkpoint
        kwargs = {}
        try:
            if "shadow_n" in payload:
                kwargs["shadow_n"] = int(payload["shadow_n"])
            if "agree_floor" in payload:
                kwargs["agree_floor"] = float(payload["agree_floor"])
        except (TypeError, ValueError) as exc:
            # A malformed knob is the client's error, answered as one —
            # not an unhandled exception that drops the connection.
            self._reply(400, {"error": f"bad reload parameter: {exc}"})
            return
        try:
            result = app.rolling_reload(str(checkpoint), **kwargs)
        except RuntimeError as exc:
            self._reply(409, {"error": str(exc)})
            return
        self._reply(200 if result["status"] in ("converged", "partial")
                    else 409, result)


def update_child_checkpoints(sup: supervise.MultiSupervisor,
                             checkpoint: str) -> None:
    """Point every supervised replica's launch command at ``checkpoint``
    so a crash-relaunch after a converged rolling reload comes back on
    the weights the fleet actually serves, not the ones it was born
    with."""
    for child in sup.children.values():
        cmd = child.spec.cmd
        if "--checkpoint" in cmd:
            cmd[cmd.index("--checkpoint") + 1] = str(checkpoint)


def build_replica_spec(i: int, checkpoint: str, *, run_dir: Path,
                       host: str = "127.0.0.1", port: int | None = None,
                       serve_args: list[str] | None = None,
                       extra_args: list[str] | None = None
                       ) -> tuple[supervise.ChildSpec, str, Path]:
    """One replica's (child spec, url, heartbeat file) — the single
    command template both boot-time spawning and elastic scale-up use."""
    run_dir = Path(run_dir)
    if port is None:
        port = free_port(host)
    hb_file = run_dir / f"replica{i}.heartbeat.json"
    cmd = [sys.executable, "-m", "eegnetreplication_tpu_torch.serve",
           "--checkpoint", str(checkpoint), "--host", host,
           "--port", str(port),
           "--metricsDir", str(run_dir / "replica_obs")]
    cmd += list(serve_args or [])
    cmd += list(extra_args or [])
    spec = supervise.ChildSpec(name=f"r{i}", cmd=cmd,
                               heartbeat_file=hb_file)
    return spec, f"http://{host}:{port}", hb_file


def spawn_replica_fleet(checkpoint: str, n: int, *, run_dir: Path,
                        host: str = "127.0.0.1",
                        serve_args: list[str] | None = None,
                        per_replica_args: dict[str, list[str]] | None = None,
                        policy: supervise.SupervisorPolicy | None = None,
                        journal=None) -> tuple[supervise.MultiSupervisor,
                                               list[ms.Replica]]:
    """Child specs + supervisor + Replica handles for ``n`` local replicas.

    Each replica is ``python -m eegnetreplication_tpu_torch.serve`` on its own
    port with its own heartbeat file (under ``run_dir``) and its own obs
    run.  The caller runs ``supervisor.run()`` (usually on a thread) and
    starts membership; a SIGKILLed replica is relaunched on the same port
    and rejoins automatically.
    """
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    specs, urls, hbs = [], [], []
    for i in range(n):
        # Per-replica extras (keyed by child name): how a gray drill arms
        # --chaos on exactly one member while its siblings stay clean.
        spec, url, hb_file = build_replica_spec(
            i, checkpoint, run_dir=run_dir, host=host,
            serve_args=serve_args,
            extra_args=(per_replica_args or {}).get(f"r{i}"))
        specs.append(spec)
        urls.append(url)
        hbs.append(hb_file)
    policy = policy or supervise.SupervisorPolicy(
        grace_s=10.0, poll_s=0.25,
        # Serving replicas have no snapshot to resume; the flag is
        # accepted by serve main but appending it is noise.
        resume_arg=None,
        thresholds={"startup": 300.0})
    sup = supervise.MultiSupervisor(specs, policy=policy, journal=journal)
    replicas = replica_specs(urls, heartbeat_files=hbs, journal=journal)
    return sup, replicas


class ReplicaScaler:
    """The autoscaler's action seam over a spawned fleet: ``spawn()``
    builds a fresh child from the same command template, registers it
    with the running :class:`~eegnetreplication_tpu_torch.resil.supervise.MultiSupervisor`
    (launched by the supervision loop's next poll) and joins it to
    membership as JOINING; ``retire(replica)`` tears down exactly that
    child and removes the member.  Indices are never reused within one
    scaler: a retired ``r3`` stays retired, the next spawn is ``r4`` —
    journal streams must never conflate two incarnations of a name."""

    def __init__(self, sup: supervise.MultiSupervisor,
                 membership: ms.FleetMembership, *, checkpoint: str,
                 run_dir: Path, host: str = "127.0.0.1",
                 serve_args: list[str] | None = None, journal=None):
        self.sup = sup
        self.membership = membership
        self.checkpoint = str(checkpoint)
        self.run_dir = Path(run_dir)
        self.host = host
        self.serve_args = list(serve_args or [])
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._lock = threading.Lock()
        indices = [int(r.replica_id[1:]) for r in membership.replicas
                   if r.replica_id.startswith("r")
                   and r.replica_id[1:].isdigit()]
        self._next_index = (max(indices) + 1) if indices else 0

    def set_checkpoint(self, checkpoint: str) -> None:
        """Post-reload hook: future spawns come up on the weights the
        fleet actually serves (existing children are repointed by
        :func:`update_child_checkpoints`)."""
        self.checkpoint = str(checkpoint)

    def _claim_index(self) -> int:
        with self._lock:
            while True:
                i = self._next_index
                self._next_index += 1
                name = f"r{i}"
                if name not in self.sup.children and not any(
                        r.replica_id == name
                        for r in self.membership.replicas):
                    return i

    def spawn(self) -> ms.Replica:
        i = self._claim_index()
        spec, url, hb_file = build_replica_spec(
            i, self.checkpoint, run_dir=self.run_dir, host=self.host,
            serve_args=self.serve_args)
        replica = ms.Replica(spec.name, url, heartbeat_file=hb_file,
                             journal=self._journal)
        # Supervisor first, then membership: a member without a child
        # would poll OUT forever, a child without a member just serves
        # unrouted until the next line lands.
        self.sup.add_child(spec)
        self.membership.add_replica(replica)
        return replica

    def retire(self, replica: ms.Replica) -> bool:
        # Membership first, then supervisor — the mirror of spawn's
        # ordering: the member must journal its out/"retired" transition
        # while the process is still up, or the health poller wins the
        # race and records the kill as an anonymous "unreachable" death,
        # breaking the journal's down -> drained -> retired drain proof.
        self.membership.remove_replica(replica)
        return self.sup.retire_child(replica.replica_id,
                                     wait_s=self.sup.policy.grace_s + 15.0)


def main(argv=None) -> int:
    from eegnetreplication_tpu_torch.utils.device import platform_device

    stackdump.install()
    # The router runs no model: this only refuses a host without CUDA
    # (unless EEGTPU_PLATFORM=cpu) before any replica is spawned.  The
    # replicas inherit the caller's environment, platform included.
    platform_device()
    parser = argparse.ArgumentParser(
        prog="python -m eegnetreplication_tpu_torch.serve.fleet",
        description="Multi-replica EEG inference fleet: supervised serving "
                    "replicas behind a least-loaded router with "
                    "health-gated membership and rolling canary reload.")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--replicas", type=int, default=2,
                        help="Number of local replica processes to spawn.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8791,
                        help="Router listen port (0 = ephemeral).")
    parser.add_argument("--pollS", type=float, default=0.25,
                        help="Membership health-poll cadence.")
    parser.add_argument("--shadowN", type=int, default=16,
                        help="Captured live requests replayed in the "
                             "canary shadow compare.")
    parser.add_argument("--agreeFloor", type=float, default=0.0,
                        help="Minimum canary/reference agreement fraction "
                             "(0 disables the agreement gate; the "
                             "canary-must-answer gate always applies).")
    parser.add_argument("--maxWaitMs", type=float, default=5.0)
    parser.add_argument("--maxQueue", type=int, default=512)
    parser.add_argument("--buckets", default=None)
    parser.add_argument("--outlierK", type=float, default=0.0,
                        help="Latency-outlier ejection: eject a replica "
                             "whose rolling p95 exceeds K x the fleet "
                             "median latency (0 = off).  Ejected "
                             "replicas drain, cool down, and re-admit "
                             "through half-open probe dispatches.")
    parser.add_argument("--outlierCooldownS", type=float, default=5.0,
                        help="Cooldown before an ejected replica gets "
                             "its first re-admission probe.")
    parser.add_argument("--hedgeBudget", type=float, default=0.0,
                        help="Hedged dispatch: after a p95-derived "
                             "delay, fire one speculative attempt at a "
                             "sibling, first response wins.  The value "
                             "is the HARD cap on extra dispatches as a "
                             "fraction of total (e.g. 0.05; 0 = off).")
    parser.add_argument("--admissionTargetMs", type=float, default=0.0,
                        help="Forwarded to every replica: adaptive AIMD "
                             "admission targeting this queue-wait "
                             "(0 = static queue cliff).")
    parser.add_argument("--traceSample", type=float,
                        default=trace.DEFAULT_SAMPLE_RATE,
                        help="Head-based trace sampling rate at the "
                             "router edge; replicas inherit the verdict "
                             "via X-Trace-Id/X-Parent-Span headers.")
    parser.add_argument("--slo", type=str, default=None,
                        help="Per-replica SLO spec (forwarded to every "
                             "replica's --slo); breaches degrade replica "
                             "healthz and surface in the fleet's "
                             "aggregate /healthz.")
    parser.add_argument("--sessionsDir", type=str, default=None,
                        help="Root for per-replica durable session "
                             "snapshots (<root>/r<i>); enables streaming "
                             "sessions through the fleet front (sticky "
                             "replica affinity) and makes replica "
                             "relaunches resume their sessions.  This "
                             "root doubles as the cell's snapshot spool "
                             "when the fleet runs as one cell.")
    parser.add_argument("--sessionSnapshotEvery", type=int, default=16,
                        help="Forwarded to every replica with "
                             "--sessionsDir: snapshot cadence in decided "
                             "windows — the staleness bound for both a "
                             "replica relaunch and a cross-cell "
                             "failover.")
    parser.add_argument("--resume", action="store_true",
                        help="Restore replica sessions from --sessionsDir "
                             "snapshots at startup (forwarded to every "
                             "replica's first launch).  The supervisor "
                             "appends this on a relaunch of a "
                             "session-serving fleet — e.g. when the whole "
                             "fleet runs as one cell under eegtpu-cells — "
                             "so the flag must parse even without "
                             "--sessionsDir (a no-op then).")
    parser.add_argument("--autoscale", action="store_true",
                        help="SLO-driven elastic fleet: a control loop "
                             "grows the fleet (supervised spawn, health-"
                             "gated join) when measured utilization "
                             "climbs and drain-safely retires replicas "
                             "when it falls.  --replicas becomes the "
                             "STARTING size.")
    parser.add_argument("--autoscaleMin", type=int, default=1,
                        help="Floor on the elastic fleet size.")
    parser.add_argument("--autoscaleMax", type=int, default=4,
                        help="Ceiling on the elastic fleet size.")
    parser.add_argument("--autoscaleIntervalS", type=float, default=0.5,
                        help="Autoscaler control-loop cadence.")
    parser.add_argument("--autoscaleUpAt", type=float, default=0.85,
                        help="Utilization above this scales up (the "
                             "hysteresis band's top edge).")
    parser.add_argument("--autoscaleDownAt", type=float, default=0.40,
                        help="Utilization below this may scale down (the "
                             "band's bottom edge).")
    parser.add_argument("--autoscaleUpCooldownS", type=float, default=2.0,
                        help="Minimum spacing between scale-up decisions.")
    parser.add_argument("--autoscaleDownCooldownS", type=float,
                        default=6.0,
                        help="Minimum spacing between scale-down "
                             "decisions.")
    parser.add_argument("--autoscaleDrainTimeoutS", type=float,
                        default=20.0,
                        help="Quiesce budget for a draining replica "
                             "before a forced (journaled) retirement.")
    parser.add_argument("--autoscaleTargetP95Ms", type=float, default=0.0,
                        help="Optional latency up-signal: rolling ok-p95 "
                             "above this (while busy) scales up (0 = "
                             "utilization/backlog signals only).")
    parser.add_argument("--metricsDir", type=str, default=None)
    parser.add_argument("--startupTimeoutS", type=float, default=300.0)
    args = parser.parse_args(argv)
    if args.replicas < 1:
        parser.error("--replicas must be >= 1")
    if args.autoscale:
        if not 1 <= args.autoscaleMin <= args.autoscaleMax:
            parser.error("need 1 <= --autoscaleMin <= --autoscaleMax")
        if not args.autoscaleMin <= args.replicas <= args.autoscaleMax:
            parser.error("--replicas must start inside "
                         "[--autoscaleMin, --autoscaleMax]")
        if args.sessionsDir:
            # Sticky session state lives in ONE replica's store; retiring
            # it would strand its sessions.  Elastic session fleets need
            # migration-on-drain (the cells tier has it) — not wired yet.
            parser.error("--autoscale does not support --sessionsDir yet")
    if args.slo:
        # Validate HERE, not in each replica: a malformed spec forwarded
        # blind would argparse-exit every child and spin the supervisor's
        # relaunch loop until the startup timeout gives up.
        from eegnetreplication_tpu_torch.obs import slo as obs_slo

        try:
            obs_slo.parse_slo_spec(args.slo)
        except ValueError as exc:
            parser.error(f"--slo: {exc}")

    from eegnetreplication_tpu_torch.config import Paths

    metrics_dir = (Path(args.metricsDir) if args.metricsDir
                   else Paths.from_here().reports / "obs")
    serve_args = ["--maxWaitMs", str(args.maxWaitMs),
                  "--maxQueue", str(args.maxQueue),
                  # Replicas inherit the edge's sampling verdict via the
                  # propagated headers for ROUTED traffic; forwarding the
                  # rate governs their own head sampling of direct
                  # (headerless) requests — without it, --traceSample 0
                  # would still leave every replica sampling at its own
                  # default.
                  "--traceSample", str(args.traceSample)]
    if args.buckets:
        serve_args += ["--buckets", args.buckets]
    if args.slo:
        serve_args += ["--slo", args.slo]
    if args.admissionTargetMs > 0:
        serve_args += ["--admissionTargetMs", str(args.admissionTargetMs)]
    per_replica_args = None
    policy = None
    if args.sessionsDir:
        sessions_root = Path(args.sessionsDir)
        per_replica_args = {
            f"r{i}": ["--sessionsDir", str(sessions_root / f"r{i}"),
                      "--sessionSnapshotEvery",
                      str(args.sessionSnapshotEvery)]
                     + (["--resume"] if args.resume else [])
            for i in range(args.replicas)}
        # Session-serving replicas DO have state to resume: a relaunch
        # restores its own snapshot generation before rebinding.
        policy = supervise.SupervisorPolicy(
            grace_s=10.0, poll_s=0.25, resume_arg="--resume",
            thresholds={"startup": 300.0})
    with obs_journal.run(metrics_dir, config=vars(args),
                         role="fleet") as journal, preempt.guard():
        sup, replicas = spawn_replica_fleet(
            args.checkpoint, args.replicas, run_dir=journal.dir,
            host=args.host, serve_args=serve_args,
            per_replica_args=per_replica_args, policy=policy,
            journal=journal)
        sup_thread = threading.Thread(target=sup.run, name="fleet-supervisor",
                                      daemon=True)
        sup_thread.start()
        app = FleetApp(replicas, args.checkpoint, host=args.host,
                       port=args.port, poll_s=args.pollS,
                       shadow_n=args.shadowN, agree_floor=args.agreeFloor,
                       trace_sample=args.traceSample,
                       outlier_k=args.outlierK,
                       outlier_cooldown_s=args.outlierCooldownS,
                       hedge_budget=args.hedgeBudget,
                       on_checkpoint_change=lambda ck:
                       update_child_checkpoints(sup, ck),
                       journal=journal)
        app.membership.start()
        if not app.membership.wait_live(args.replicas,
                                        timeout_s=args.startupTimeoutS):
            live = len(app.membership.dispatchable())
            logger.warning("Only %d/%d replicas live after %.0fs — "
                           "serving with what we have", live, args.replicas,
                           args.startupTimeoutS)
        app.start()
        autoscaler = None
        if args.autoscale:
            scaler = ReplicaScaler(sup, app.membership,
                                   checkpoint=args.checkpoint,
                                   run_dir=journal.dir, host=args.host,
                                   serve_args=serve_args, journal=journal)

            # A rolling reload must also retarget FUTURE spawns, or the
            # next scale-up resurrects the superseded checkpoint.
            def _on_ck(ck, _scaler=scaler, _sup=sup):
                _scaler.set_checkpoint(ck)
                update_child_checkpoints(_sup, ck)

            app._on_checkpoint_change = _on_ck
            autoscaler = Autoscaler(
                app.membership, scaler, app.window_stats,
                policy=AutoscalerPolicy(
                    min_replicas=args.autoscaleMin,
                    max_replicas=args.autoscaleMax,
                    interval_s=args.autoscaleIntervalS,
                    up_threshold=args.autoscaleUpAt,
                    down_threshold=args.autoscaleDownAt,
                    up_cooldown_s=args.autoscaleUpCooldownS,
                    down_cooldown_s=args.autoscaleDownCooldownS,
                    drain_timeout_s=args.autoscaleDrainTimeoutS,
                    target_p95_ms=args.autoscaleTargetP95Ms),
                journal=journal)
            app.autoscaler = autoscaler
            autoscaler.start()
        print(f"fleet serving at {app.url} "
              f"({len(app.membership.dispatchable())} live)", flush=True)
        try:
            while not preempt.requested():
                time.sleep(0.2)
        finally:
            logger.info("Fleet stop requested — draining")
            if autoscaler is not None:
                autoscaler.close()
            app.stop()
            sup.stop()
            sup_thread.join(timeout=60.0)
    return preempt.EX_PREEMPTED if preempt.requested() else 0


if __name__ == "__main__":
    raise SystemExit(main())
