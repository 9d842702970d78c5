"""CellFront: the thin tier that turns N independent cells into a service.

The front owns three things and deliberately nothing else (it holds no
model, no batcher, no session state — a front restart loses only routing
tables that rebuild from traffic):

- **Bulk routing** — ``POST /predict`` dispatches least-loaded over the
  live cells through the same
  :class:`~eegnetreplication_tpu_torch.serve.fleet.router.FleetRouter` the
  fleet tier uses (per-cell circuit breakers, transport failover,
  optional latency-outlier ejection one level up), forwarding the
  full client header set — ``X-Model``, ``X-Deadline-Ms``,
  ``X-Priority`` and the ``X-Trace-*`` propagation — on every dispatch
  AND every failover retry.
- **Session affinity** — ``/session/*`` routes stick each session to one
  cell (chosen least-loaded at open).  Affinity is what makes sessions
  migratable: it is a table the front can rewrite, not an address the
  client holds.
- **Session portability** — the session store's contract (sha256-stamped snapshots
  + byte-exact chunk-resumable EMS) exploited above the fleet:

  * **Planned migration** (``POST /cell/<id>/drain``): the cell is
    pinned ``draining`` (no new bulk or sessions), then per session —
    under that session's affinity lock, so the stream is quiesced at its
    decided frontier — the front GETs the source's
    ``/session/<sid>/export``, POSTs it to the target's
    ``/session/import`` (integrity-verified there), flips affinity, and
    discards the source copy.  The client never notices: its next
    ``/samples`` lands on the new cell at exactly the position it left
    off, so a drain costs zero window expirations.
  * **Unplanned failover**: a cell marked ``failed`` (dark healthz,
    dead-connection dispatch) triggers the membership transition hook —
    every session with affinity there is re-materialized on a survivor
    from the failed cell's snapshot spool on shared storage, journaled
    ``session_failover``.  The spool is periodic, so the restored acked
    cursor trails the client; the front therefore answers the next
    ``/samples`` with ``409 {"resume": true}`` and the client replays
    from the acked cursor it reads back via the existing
    open/state handshake — the same replay-from-acked protocol a
    single-cell SIGKILL restart already exercises, now cross-cell.

Every membership change is a ``cell_member`` event; every migration a
``session_migrate``; every failover a ``session_failover`` — the chaos
drill (``cell.failover`` leg) pins ``cell_member failed`` strictly before
``session_failover`` from the journal alone.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import ThreadingHTTPServer

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.serve.cells import membership as cms
from eegnetreplication_tpu_torch.serve.fleet.outlier import OutlierEjector
from eegnetreplication_tpu_torch.serve.fleet.router import (
    AllReplicasBusy,
    FleetRouter,
    NoLiveReplicas,
)
from eegnetreplication_tpu_torch.serve.service import (
    PASSTHROUGH_HEADERS,
    JsonRequestHandler,
)
from eegnetreplication_tpu_torch.serve.sessions import store as session_store
from eegnetreplication_tpu_torch.utils.logging import logger


class MigrationError(RuntimeError):
    """A planned migration step failed (export/import refused); the
    session stays where it was — drain reports it, nothing is lost."""


class CellFront:
    """The assembled front tier: cell membership + router + affinity."""

    def __init__(self, cells: list[cms.CellMember], *,
                 host: str = "127.0.0.1", port: int = 0,
                 poll_s: float = 0.25, predict_timeout_s: float = 60.0,
                 trace_sample: float = trace.DEFAULT_SAMPLE_RATE,
                 outlier_k: float = 0.0, outlier_cooldown_s: float = 5.0,
                 journal=None):
        self.journal = journal if journal is not None \
            else obs_journal.current()
        self.membership = cms.CellMembership(cells, poll_s=poll_s,
                                             journal=self.journal)
        self.membership.on_transition = self._on_cell_transition
        self.outlier = (OutlierEjector(
            self.membership, k=outlier_k, cooldown_s=outlier_cooldown_s,
            journal=self.journal) if outlier_k and outlier_k > 0 else None)
        self.router = FleetRouter(self.membership,
                                  predict_timeout_s=predict_timeout_s,
                                  journal=self.journal, outlier=self.outlier)
        self.trace_sample = float(trace_sample)
        # Session routing state: affinity (sid -> cell_id), the resync
        # set (sessions whose cell failed over — the next /samples gets
        # 409 until the client re-reads its acked cursor), and one lock
        # per session serializing its forwards against its migrations.
        self._table_lock = threading.Lock()
        self._affinity: dict[str, str] = {}
        self._needs_resync: set[str] = set()
        self._session_locks: dict[str, threading.Lock] = {}
        self.sessions_migrated = 0
        self.sessions_failed_over = 0
        # Front-tier HA (serve/cells/ha.py): an HAController makes this
        # front one half of an active/standby pair — ``None`` keeps the
        # single-front behaviour exactly (is_leader is then always
        # true).  An attached RollingUpgrade serves POST /cells/upgrade.
        self.ha = None
        self.upgrader = None
        self._host, self._port = host, int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._listener: threading.Thread | None = None
        self._stopped = False
        self._stats_lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._inflight = 0
        self._idle = threading.Condition(self._stats_lock)
        self._t_start = time.perf_counter()

    # -- lifecycle --------------------------------------------------------
    @property
    def cells(self) -> list[cms.CellMember]:
        return self.membership.replicas

    @property
    def address(self) -> tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("cell front not started")
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "CellFront":
        self.membership.start()
        front = self

        class Handler(_CellFrontHandler):
            pass

        Handler.front = front
        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._listener = threading.Thread(target=self._httpd.serve_forever,
                                          name="cells-http", daemon=True)
        self._listener.start()
        self.journal.event(
            "cell_front_start",
            cells=[{"cell": c.cell_id, "url": c.url,
                    "spool": str(c.spool) if c.spool else None}
                   for c in self.cells],
            host=self.address[0], port=self.address[1])
        logger.info("Cell front at %s over %d cells", self.url,
                    len(self.cells))
        return self

    def stop(self, handler_timeout_s: float = 30.0) -> None:
        if self._stopped:
            return
        self._stopped = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.router.wait_idle()
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=handler_timeout_s):
                logger.warning("%d in-flight cell-front handler(s) did not "
                               "finish within %.1fs", self._inflight,
                               handler_timeout_s)
            counts = dict(self._counts)
        self.membership.close()
        self.router.close()
        self.journal.event(
            "cell_front_end", n_requests=sum(counts.values()), **counts,
            failovers=self.router.n_failovers,
            sessions_migrated=self.sessions_migrated,
            sessions_failed_over=self.sessions_failed_over,
            wall_s=round(time.perf_counter() - self._t_start, 3))
        logger.info("Cell front stopped: %s (%d bulk failovers, %d session "
                    "migrations, %d session failovers)", counts,
                    self.router.n_failovers, self.sessions_migrated,
                    self.sessions_failed_over)

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
               cell: str | None) -> None:
        with self._stats_lock:
            self._counts[status] = self._counts.get(status, 0) + 1
        self.journal.event("request", n_trials=n_trials,
                           latency_ms=round(latency_ms, 3), status=status,
                           cell=cell)
        self.journal.metrics.inc("requests_total", status=status)
        if status == "ok":
            self.journal.metrics.observe("request_latency_ms", latency_ms)
        if status == "no_cells":
            trace.flush(journal=self.journal)
        else:
            trace.flush_if_anomalous(status, journal=self.journal)

    # -- HA role -----------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        """Single fronts are always leader; an HA front serves traffic
        only while its controller holds the fencing lease."""
        return self.ha is None or self.ha.role == "active"

    def _wal_append(self, op: str, sid: str, cell_id: str | None = None,
                    resync: bool = False) -> None:
        """Append one affinity mutation to the HA WAL — called UNDER the
        table lock so WAL order is exactly table-mutation order.  Gated
        on the live leader check: a standby installing a replay writes
        the table directly and must never echo records back, and a
        fenced ex-active must not extend the log the new leader owns."""
        ha = self.ha
        if ha is None or ha.role != "active":
            return
        try:
            ha.wal.append(op, sid, cell_id, resync=resync)
        except OSError as exc:
            logger.warning("Affinity WAL append (%s %s) failed: %s", op,
                           sid, exc)

    def _install_affinity(self, affinity: dict[str, str],
                          resync: set[str]) -> None:
        """Replace the whole routing table (the standby's WAL replay)."""
        with self._table_lock:
            self._affinity = dict(affinity)
            self._needs_resync = set(resync)

    # -- affinity ----------------------------------------------------------
    def _session_lock(self, sid: str) -> threading.Lock:
        with self._table_lock:
            lock = self._session_locks.get(sid)
            if lock is None:
                lock = self._session_locks[sid] = threading.Lock()
            return lock

    def cell_of(self, sid: str) -> cms.CellMember | None:
        with self._table_lock:
            cell_id = self._affinity.get(sid)
        if cell_id is None:
            return None
        return self.membership.by_id(cell_id)

    def _affinity_count(self, cell_id: str) -> int:
        with self._table_lock:
            return sum(1 for c in self._affinity.values() if c == cell_id)

    def _sessions_on(self, cell_id: str) -> list[str]:
        with self._table_lock:
            return sorted(s for s, c in self._affinity.items()
                          if c == cell_id)

    def pick_session_cell(self, exclude: set[str] = frozenset()
                          ) -> cms.CellMember | None:
        """Least-loaded live cell for a new (or failing-over) session:
        fewest stuck sessions first, then the bulk load key."""
        candidates = [c for c in self.membership.dispatchable()
                      if c.replica_id not in exclude]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda c: (self._affinity_count(c.cell_id), c.load))

    # -- cell transitions --------------------------------------------------
    def _on_cell_transition(self, cell, previous, state, reason) -> None:
        """Membership hook: a cell entering ``failed`` triggers session
        failover for everything stuck to it.  Runs on a background
        thread — the hook fires from the health poller AND from dispatch
        threads (dead-connection pulls), and neither may block on N
        import round-trips.  Leader-gated: the standby polls cell health
        too (so its view is warm at takeover) but must not consume
        spools or move sessions — promotion re-runs this scan."""
        if state != cms.FAILED or not self.is_leader:
            return
        sids = self._sessions_on(cell.cell_id)
        if not sids:
            return
        threading.Thread(target=self._failover_cell_sessions,
                         args=(cell,), name=f"failover-{cell.cell_id}",
                         daemon=True).start()

    def _failover_cell_sessions(self, cell: cms.CellMember) -> None:
        for sid in self._sessions_on(cell.cell_id):
            try:
                self.failover_session(sid, cell)
            except Exception as exc:  # noqa: BLE001 — per-session containment
                logger.warning("Session %s failover off %s failed: %s",
                               sid, cell.cell_id, exc)

    # -- unplanned failover ------------------------------------------------
    def failover_session(self, sid: str, from_cell: cms.CellMember) -> bool:
        """Move ``sid`` off a failed cell onto a survivor, restoring its
        state from the failed cell's snapshot spool when one holds it.
        Idempotent (racing triggers — the transition hook and a lazy
        ``/samples`` touch — are serialized on the session lock and the
        loser sees the affinity already moved).  Returns whether the
        session now has a live home."""
        with self._session_lock(sid):
            with self._table_lock:
                if self._affinity.get(sid) != from_cell.cell_id:
                    return True  # already moved by a racing trigger
            target = self.pick_session_cell(exclude={from_cell.cell_id})
            if target is None:
                return False  # no survivor; the client keeps retrying
            data = None
            if from_cell.spool is not None:
                try:
                    data = session_store.read_spooled_session(
                        from_cell.spool, sid)
                except Exception as exc:  # noqa: BLE001 — spool best-effort
                    # Journaled, not just logged: a spool-read failure is
                    # the precursor to a session restarting from zero —
                    # drills and event_summary assert on it.
                    self.journal.event(
                        "session_failover", session=sid,
                        from_cell=from_cell.cell_id,
                        to_cell=target.cell_id, action="spool_error",
                        reason=f"{type(exc).__name__}: {exc}"[:200])
                    logger.warning("Reading spool %s for session %s "
                                   "failed: %s", from_cell.spool, sid, exc)
            mirror = getattr(from_cell, "mirror", None)
            if data is None and mirror is not None:
                # Replicated spool: the primary copy is missing, torn, or
                # quarantined — the write-both mirror answers, and the
                # fallback is journaled.
                try:
                    data = session_store.read_spooled_session(mirror, sid)
                except Exception as exc:  # noqa: BLE001 — same containment
                    self.journal.event(
                        "spool_mirror", action="error", session=sid,
                        cell=from_cell.cell_id,
                        reason=f"{type(exc).__name__}: {exc}"[:200])
                else:
                    if data is not None:
                        self.journal.event("spool_mirror",
                                           action="restored", session=sid,
                                           cell=from_cell.cell_id)
                        self.journal.metrics.inc("spool_mirror_restores")
            restored, acked = False, None
            if data is not None:
                try:
                    status, body = target.client.request(
                        "POST", "/session/import", body=data,
                        headers={"Content-Type":
                                 "application/octet-stream"})
                except OSError as exc:
                    logger.warning("Session %s import on %s failed: %s",
                                   sid, target.cell_id, exc)
                    return False  # target dark too; a later trigger retries
                if status in (200, 409):
                    # 409 = the target already holds it (an earlier
                    # half-completed failover): the stream is there.
                    restored = True
                    try:
                        acked = json.loads(body.decode()).get("acked")
                    except (ValueError, UnicodeDecodeError):
                        acked = None
            with self._table_lock:
                self._affinity[sid] = target.cell_id
                self._needs_resync.add(sid)
                self.sessions_failed_over += 1
                self._wal_append("flip", sid, target.cell_id, resync=True)
            self.journal.event("session_failover", session=sid,
                               from_cell=from_cell.cell_id,
                               to_cell=target.cell_id,
                               restored=restored, acked=acked)
            self.journal.metrics.inc("session_failovers")
            logger.warning("Session %s failed over %s -> %s (restored=%s, "
                           "acked=%s)", sid, from_cell.cell_id,
                           target.cell_id, restored, acked)
            return True

    # -- planned migration -------------------------------------------------
    def migrate_session(self, sid: str, source: cms.CellMember,
                        target: cms.CellMember) -> None:
        """Export → import → flip affinity → discard, under the session's
        lock so the stream is quiesced at its decided frontier (no
        ``/samples`` can be in flight).  The export is read-only and the
        source copy is only discarded after the target confirmed the
        import, so any failure leaves the session serving where it was."""
        with self._session_lock(sid):
            with self._table_lock:
                if self._affinity.get(sid) != source.cell_id:
                    return  # moved already (racing drain/failover)
            status, data = source.client.request(
                "GET", f"/session/{sid}/export")
            if status != 200:
                raise MigrationError(
                    f"export of {sid!r} from {source.cell_id} answered "
                    f"{status}")
            status, body = target.client.request(
                "POST", "/session/import", body=data,
                headers={"Content-Type": "application/octet-stream"})
            if status not in (200, 409):
                raise MigrationError(
                    f"import of {sid!r} on {target.cell_id} answered "
                    f"{status}: {body[:200]!r}")
            with self._table_lock:
                self._affinity[sid] = target.cell_id
                # No resync: the export captured the client's exact
                # position (the stream was quiesced under our lock).
                self._needs_resync.discard(sid)
                self._wal_append("flip", sid, target.cell_id)
            try:
                source.client.request("POST", f"/session/{sid}/discard",
                                      body=b"")
            except OSError as exc:
                # Best-effort: the source copy is now shadowed by the
                # affinity flip; a restart there resurrects a session no
                # request will ever reach.
                logger.warning("Discard of migrated session %s on %s "
                               "failed: %s", sid, source.cell_id, exc)
            with self._table_lock:
                self.sessions_migrated += 1
            self.journal.event("session_migrate", session=sid,
                               from_cell=source.cell_id,
                               to_cell=target.cell_id)
            self.journal.metrics.inc("session_migrations")
            logger.info("Session %s migrated %s -> %s", sid,
                        source.cell_id, target.cell_id)

    def drain_cell(self, cell: cms.CellMember,
                   to: cms.CellMember | None = None) -> dict:
        """Planned drain: pin the cell out of rotation, then migrate
        every stuck session to ``to`` (or per-session least-loaded)."""
        if cell.state == cms.FAILED:
            raise MigrationError(
                f"cell {cell.cell_id} is failed; failover (not drain) "
                "owns its sessions")
        cell.pinned = True
        self.membership.set_state(cell, cms.DRAINING, "drain requested")
        migrated, failed = [], []
        for sid in self._sessions_on(cell.cell_id):
            target = to if to is not None else self.pick_session_cell(
                exclude={cell.cell_id})
            if target is None:
                failed.append(sid)
                continue
            try:
                self.migrate_session(sid, cell, target)
                migrated.append(sid)
            except (MigrationError, OSError) as exc:
                logger.warning("Migration of %s off %s failed: %s", sid,
                               cell.cell_id, exc)
                failed.append(sid)
        return {"cell": cell.cell_id, "state": cell.state,
                "migrated": migrated, "failed": failed}

    def undrain_cell(self, cell: cms.CellMember) -> None:
        """Release an operator drain; the next healthy poll re-LIVEs it.

        FAILED is also a legal source: a rolling upgrade retires the
        drained cell's process, and the kill flips the pinned cell
        DRAINING -> FAILED (dead connection / dark healthz) — a state
        the pinned poller then never leaves on its own."""
        cell.pinned = False
        self.membership.set_state(cell, cms.JOINING, "undrained",
                                  only_from=(cms.DRAINING, cms.FAILED))

    # -- resync handshake --------------------------------------------------
    def needs_resync(self, sid: str) -> bool:
        with self._table_lock:
            return sid in self._needs_resync

    def clear_resync(self, sid: str) -> None:
        with self._table_lock:
            self._needs_resync.discard(sid)

    def drop_session(self, sid: str) -> None:
        with self._table_lock:
            self._affinity.pop(sid, None)
            self._needs_resync.discard(sid)
            self._session_locks.pop(sid, None)
            self._wal_append("drop", sid)


class _CellFrontHandler(JsonRequestHandler):
    """The front's HTTP surface (instances on ThreadingHTTPServer
    threads; journaling goes through ``self.front.journal``)."""

    front: CellFront = None  # bound by CellFront.start()

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        logger.debug("cells http: " + fmt, *args)

    # -- helpers -----------------------------------------------------------
    def _passthrough(self) -> dict:
        headers = {h: self.headers[h] for h in PASSTHROUGH_HEADERS
                   if self.headers.get(h)}
        ctype = self.headers.get("Content-Type")
        if ctype:
            headers["Content-Type"] = ctype
        return headers

    def _forward(self, cell: cms.CellMember, method: str, path: str,
                 body: bytes | None = None) -> tuple[int, bytes] | None:
        """One forwarded round-trip to a specific cell (session routes —
        sticky, no failover here; the caller owns recovery).  Replies
        503 and returns ``None`` on a transport failure, after pulling
        the dead cell so the membership/failover machinery reacts before
        the client's next retry."""
        import http.client as _http

        try:
            return cell.client.request(
                method, path, body=body,
                headers={**self._passthrough(), **trace.headers()})
        except (OSError, _http.HTTPException) as exc:
            self.front.membership.mark_unreachable(
                cell, f"session forward: {type(exc).__name__}")
            self._reply(503, {"error": f"cell {cell.cell_id} unreachable: "
                                       f"{type(exc).__name__}",
                              "cell": cell.cell_id})
            return None

    # -- routes ------------------------------------------------------------
    def do_GET(self):  # noqa: N802 — stdlib naming
        front = self.front
        if self.path == "/healthz":
            snapshot = self.front.membership.snapshot()
            n_live = sum(1 for c in snapshot if c["state"] == cms.LIVE)
            with front._table_lock:
                n_sessions = len(front._affinity)
            # A standby/fenced front answers 200: its healthz is how
            # clients DISCOVER the pair's roles and the leader hint —
            # only the leader's health couples to cell liveness.
            healthy = bool(n_live) or not front.is_leader
            self._reply(200 if healthy else 503, {
                "status": "ok" if n_live else "no_live_cells",
                "role": ("active" if front.ha is None
                         else front.ha.role),
                "leader": (front.ha.leader_hint()
                           if front.ha is not None else None),
                "n_cells": len(snapshot), "n_live": n_live,
                "sessions": n_sessions,
                "sessions_migrated": front.sessions_migrated,
                "sessions_failed_over": front.sessions_failed_over,
                "outlier": (front.outlier.snapshot()
                            if front.outlier is not None else None),
                "cells": snapshot})
            return
        if self.path == "/metrics":
            self._reply_metrics(front.journal)
            return
        parts = self.path.strip("/").split("/")
        if len(parts) == 3 and parts[0] == "session" and parts[2] == "state":
            if not self._leader_gate():
                return
            # Bracketed like do_POST: stop() must wait for this forward
            # or closing the pooled clients mid-flight would fail it with
            # an OSError that marks a healthy cell unreachable.
            front.begin_request()
            try:
                self._session_route(parts[1], "GET",
                                    f"/session/{parts[1]}/state",
                                    clear_resync=True)
            finally:
                front.end_request()
            return
        self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib naming
        front = self.front
        if not self._leader_gate():
            return
        front.begin_request()
        try:
            parts = self.path.strip("/").split("/")
            if self.path == "/predict":
                self._predict()
            elif self.path == "/session/open":
                self._session_open()
            elif self.path == "/cells/upgrade":
                self._upgrade()
            elif len(parts) == 3 and parts[0] == "session" \
                    and parts[2] == "samples":
                self._session_samples(parts[1])
            elif len(parts) == 3 and parts[0] == "session" \
                    and parts[2] == "close":
                self._session_route(parts[1], "POST",
                                    f"/session/{parts[1]}/close",
                                    body=self._read_body(), drop=True)
            elif len(parts) == 3 and parts[0] == "cell" \
                    and parts[2] == "drain":
                self._drain(parts[1])
            elif len(parts) == 3 and parts[0] == "cell" \
                    and parts[2] == "undrain":
                self._undrain(parts[1])
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})
        finally:
            front.end_request()

    def _leader_gate(self) -> bool:
        """Non-leader fronts serve NOTHING but discovery: every serving
        and operator route answers 503 with the advertised leader URL so
        the client's next attempt lands on the right half of the pair.
        The body is drained first — an unread body desyncs keep-alive
        clients."""
        front = self.front
        if front.is_leader:
            return True
        self._read_body()
        ha = front.ha
        self._reply(503, {"error": f"front {ha.owner!r} is {ha.role}, "
                                   "not the leader",
                          "role": ha.role, "leader": ha.leader_hint()})
        return False

    # -- bulk --------------------------------------------------------------
    def _predict(self) -> None:
        front = self.front
        ctx = trace.maybe_start(self.headers, front.trace_sample)
        with trace.use(ctx), trace.span("cells.request",
                                        journal=front.journal,
                                        route="/predict"):
            self._predict_traced()

    def _predict_traced(self) -> None:
        front = self.front
        t0 = time.perf_counter()
        body = self._read_body()
        content_type = (self.headers.get("Content-Type")
                        or "application/json").split(";")[0].strip()
        passthrough = {h: self.headers[h] for h in PASSTHROUGH_HEADERS
                       if self.headers.get(h)}
        try:
            status, data, cell_id = front.router.dispatch(
                body, content_type, headers=passthrough)
        except AllReplicasBusy as exc:
            front.record("rejected", 0,
                         (time.perf_counter() - t0) * 1000.0, None)
            self._reply(429, {"error": str(exc)})
            return
        except NoLiveReplicas:
            front.record("no_cells", 0,
                         (time.perf_counter() - t0) * 1000.0, None)
            self._reply(503, {"error": "no live cells"})
            return
        latency_ms = (time.perf_counter() - t0) * 1000.0
        # Bounded n_trials parse, same contract as the fleet front: huge
        # reply bodies journal n_trials=0 (the cell's own journal has the
        # exact figure) rather than pay a full re-decode on the hot path.
        n_trials = 0
        if status == 200 and len(data) <= 16384:
            try:
                n_trials = int(json.loads(data.decode()).get("n", 0))
            except (ValueError, UnicodeDecodeError):
                n_trials = 0
        label = ("ok" if status == 200 else
                 "rejected" if status == 429 else
                 "bad_request" if 400 <= status < 500 else "error")
        front.record(label, n_trials, latency_ms, cell_id)
        self._reply_bytes(status, data)

    # -- sessions ----------------------------------------------------------
    def _live_cell_for(self, sid: str) -> cms.CellMember | None:
        """The cell ``sid`` should reach right now, running lazy failover
        when its home is failed.  Replies and returns ``None`` when the
        session cannot be served this instant."""
        front = self.front
        cell = front.cell_of(sid)
        if cell is None:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return None
        if cell.state == cms.FAILED:
            # Lazy trigger: the transition hook normally got here first,
            # but a request racing the poller must not wait for it.
            front.failover_session(sid, cell)
            cell = front.cell_of(sid)
            if cell is None or cell.state == cms.FAILED:
                self._reply(503, {"error": f"session {sid!r} has no live "
                                           "cell yet; retry"})
                return None
        return cell

    def _relocked_cell(self, sid: str) -> cms.CellMember | None:
        """Re-resolve ``sid``'s cell — caller HOLDS the session lock.

        A drain or failover may have moved the session while the caller
        waited for the lock; forwarding to the stale pre-lock handle
        would re-plant the stream on a drained source (or a corpse).
        A failed cell cannot be failed over inline here (failover takes
        this same lock), so it answers a retryable 503 and the client's
        next attempt runs the pre-lock failover path.  Replies and
        returns ``None`` when the session cannot be served."""
        front = self.front
        cell = front.cell_of(sid)
        if cell is None:
            self._reply(404, {"error": f"unknown session {sid!r}"})
            return None
        if cell.state == cms.FAILED:
            self._reply(503, {"error": f"session {sid!r} cell "
                                       f"{cell.cell_id} failed; retry"})
            return None
        return cell

    def _session_route(self, sid: str, method: str, path: str,
                       body: bytes | None = None, drop: bool = False,
                       clear_resync: bool = False) -> None:
        front = self.front
        if self._live_cell_for(sid) is None:  # pre-lock failover trigger
            return
        with front._session_lock(sid):
            cell = self._relocked_cell(sid)
            if cell is None:
                return
            result = self._forward(cell, method, path, body)
        if result is None:
            return
        status, data = result
        if status == 200:
            if drop:
                front.drop_session(sid)
            if clear_resync:
                # The client has (re)read its cursor: the replay-from-
                # acked handshake is complete.
                front.clear_resync(sid)
        self._reply_bytes(status, data)

    def _session_open(self) -> None:
        front = self.front
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
            # The front names anonymous sessions itself: affinity needs
            # the id BEFORE the cell assigns one.
            sid = payload["session"] = os.urandom(6).hex()
            body = json.dumps(payload).encode()
        sid = str(sid)
        cell = front.cell_of(sid)
        if cell is not None and cell.state == cms.FAILED:
            # Pre-lock only: failover takes the session lock itself.
            front.failover_session(sid, cell)
        with front._session_lock(sid):
            # Re-resolve UNDER the lock: an open racing a drain must see
            # the flipped affinity (forwarding to the stale pre-lock
            # handle would re-create the stream from zero on the drained
            # source and flip affinity back, orphaning the migrated
            # copy).
            cell = front.cell_of(sid)
            if cell is not None and cell.state == cms.FAILED:
                self._reply(503, {"error": f"session {sid!r} cell "
                                           f"{cell.cell_id} failed; "
                                           "retry"})
                return
            if cell is None:
                cell = front.pick_session_cell()
                if cell is None:
                    self._reply(503, {"error": "no live cells for "
                                               "sessions"})
                    return
            result = self._forward(cell, "POST", "/session/open", body)
            if result is None:
                return
            status, data = result
            if status == 200:
                with front._table_lock:
                    front._affinity[sid] = cell.cell_id
                    front._wal_append("assign", sid, cell.cell_id)
                front.clear_resync(sid)
                try:
                    reply = json.loads(data.decode())
                    reply["cell"] = cell.cell_id
                    data = json.dumps(reply).encode()
                except (ValueError, UnicodeDecodeError):
                    pass
        self._reply_bytes(status, data)

    def _session_samples(self, sid: str) -> None:
        front = self.front
        ctx = trace.maybe_start(self.headers, front.trace_sample)
        with trace.use(ctx), trace.span("cells.samples",
                                        journal=front.journal, session=sid):
            if self._live_cell_for(sid) is None:  # pre-lock failover
                return
            with front._session_lock(sid):
                cell = self._relocked_cell(sid)
                if cell is None:
                    return
                if front.needs_resync(sid):
                    # The replay-from-acked handshake: this session
                    # moved cells through a STALE spool snapshot —
                    # blindly forwarding the client's next chunk would
                    # splice a gap into the stream.  The client re-reads
                    # its cursor (GET /session/<sid>/state or re-open)
                    # and replays.  Checked UNDER the lock: a failover
                    # that latched while we waited must not be bypassed.
                    self._reply(409, {
                        "error": f"session {sid!r} failed over to "
                                 f"{cell.cell_id}; replay from the "
                                 "acked cursor", "resume": True,
                        "cell": cell.cell_id})
                    return
                result = self._forward(
                    cell, "POST", f"/session/{sid}/samples",
                    self._read_body())
            if result is None:
                return
            self._reply_bytes(*result)

    # -- operator routes ---------------------------------------------------
    def _cell_by_id(self, cell_id: str) -> cms.CellMember | None:
        try:
            return self.front.membership.by_id(cell_id)
        except KeyError:
            self._reply(404, {"error": f"unknown cell {cell_id!r}"})
            return None

    def _drain(self, cell_id: str) -> None:
        front = self.front
        cell = self._cell_by_id(cell_id)
        if cell is None:
            return
        try:
            payload = json.loads(self._read_body().decode() or "{}")
        except (ValueError, UnicodeDecodeError):
            self._reply(400, {"error": "drain body must be JSON"})
            return
        to = None
        if payload.get("to"):
            to = self._cell_by_id(str(payload["to"]))
            if to is None:
                return
            if to.cell_id == cell.cell_id:
                self._reply(400, {"error": "cannot drain a cell into "
                                           "itself"})
                return
        try:
            result = front.drain_cell(cell, to=to)
        except MigrationError as exc:
            self._reply(409, {"error": str(exc)})
            return
        self._reply(200 if not result["failed"] else 207, result)

    def _undrain(self, cell_id: str) -> None:
        self._read_body()  # unread bodies desync keep-alive clients
        cell = self._cell_by_id(cell_id)
        if cell is None:
            return
        self.front.undrain_cell(cell)
        self._reply(200, {"cell": cell.cell_id, "state": cell.state})

    def _upgrade(self) -> None:
        """POST /cells/upgrade: front-orchestrated rolling upgrade.
        Blocks until the loop finishes (strictly serialized, so wall is
        cells x drain+relaunch) and replies the terminal status —
        ``rolled_back`` is a 200: the rollback SUCCEEDING is the safe
        outcome the operator asked this orchestrator to guarantee."""
        front = self.front
        body = self._read_body()
        if front.upgrader is None:
            self._reply(501, {"error": "no upgrader wired: this front "
                                       "does not supervise its cells"})
            return
        try:
            payload = json.loads(body.decode() or "{}")
            if not isinstance(payload, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as exc:
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        serve_args = payload.get("serveArgs")
        if serve_args is not None and (
                not isinstance(serve_args, list)
                or not all(isinstance(a, str) for a in serve_args)):
            self._reply(400, {"error": "serveArgs must be a list of "
                                       "strings"})
            return
        from eegnetreplication_tpu_torch.serve.cells.ha import (
            UpgradeInProgress,
        )
        try:
            result = front.upgrader.run(
                checkpoint=payload.get("checkpoint"),
                serve_args=serve_args,
                live_timeout_s=payload.get("liveTimeoutS"))
        except UpgradeInProgress as exc:
            self._reply(409, {"error": str(exc)})
            return
        self._reply(200, result)
