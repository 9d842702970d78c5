"""Health-gated fleet membership: who may receive traffic right now.

A replica is not a URL — it is a process that can be warming up, serving,
degraded (open breaker, wedged batcher worker), or dead, and the router
must never learn that the hard way on a client's request.  The membership
poller owns that knowledge: every ``poll_s`` it hits each replica's
``GET /healthz`` (which carries ``variables_digest`` and live queue
depths) and, when the replica runs
under a supervisor, cross-checks its heartbeat file through the shared
:class:`~eegnetreplication_tpu_torch.resil.heartbeat.Watchdog`.  State machine:

- ``joining`` — spawned but never healthy yet (engine warmup); not
  dispatched to, not an error.
- ``live`` — healthy; eligible for least-loaded dispatch.
- ``draining`` — answered degraded (503) or its heartbeat file went
  stale: no NEW dispatches, existing ones finish; a healthy poll brings
  it straight back.
- ``out`` — unreachable for ``fail_threshold`` consecutive polls (or a
  dispatch hit a dead-connection error): presumed crashed.  The
  supervisor restarts it; the first healthy poll rejoins it
  automatically.
- ``canary`` — parked out of normal rotation by the rolling-reload
  controller while it serves shadow traffic.
- ``degraded`` — ejected by the latency-outlier detector
  (:mod:`~eegnetreplication_tpu_torch.serve.fleet.outlier`): alive and passing
  every health poll, but its tail latency marks it a gray failure.  No
  NEW dispatches (in-flight ones drain normally); after the cooldown the
  ejector re-admits it through half-open probe dispatches.  The health
  poller leaves this state alone (the ejector owns re-admission — a
  healthy-looking ``/healthz`` is exactly what a gray replica shows).

Every transition is journaled as a ``fleet_member`` event, so the fleet's
membership history reads from one stream.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import heartbeat as hb
from eegnetreplication_tpu_torch.resil.breaker import CircuitBreaker
from eegnetreplication_tpu_torch.utils.logging import logger

JOINING = "joining"
LIVE = "live"
DRAINING = "draining"
OUT = "out"
CANARY = "canary"
DEGRADED = "degraded"

# States the router may pick a dispatch target from.  DEGRADED is not
# here: an ejected replica only sees traffic through the outlier
# ejector's explicit probe slots.
DISPATCHABLE = (LIVE,)


class ReplicaClient:
    """Pooled keep-alive HTTP client for one replica.

    The router dispatches thousands of small requests per second; paying a
    TCP connect per request (urllib) would put the connect cost on the
    serving hot path.  Connections are pooled per replica and reused
    (the serve handler speaks HTTP/1.1 with Content-Length, so keep-alive
    is safe); any transport error closes the connection rather than
    returning it.
    """

    def __init__(self, url: str, *, timeout_s: float = 30.0,
                 pool_size: int = 16):
        parts = urllib.parse.urlsplit(url)
        if parts.scheme != "http" or parts.hostname is None:
            raise ValueError(f"replica url must be http://host:port, "
                             f"got {url!r}")
        self.url = url.rstrip("/")
        self.host = parts.hostname
        self.port = parts.port or 80
        self.timeout_s = float(timeout_s)
        self.pool_size = int(pool_size)
        self._idle: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def request(self, method: str, path: str, body: bytes | None = None,
                headers: dict | None = None,
                timeout_s: float | None = None) -> tuple[int, bytes]:
        """One round-trip; returns ``(status, body)``.  Raises ``OSError``
        (or ``http.client.HTTPException``) on transport failure — the
        router's failover signal, distinct from an HTTP error status."""
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        with self._lock:
            conn = self._idle.pop() if self._idle else None
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=timeout)
        else:
            conn.timeout = timeout
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
        except BaseException:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            with self._lock:
                if len(self._idle) < self.pool_size:
                    self._idle.append(conn)
                    conn = None
            if conn is not None:
                conn.close()
        return resp.status, data

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class Replica:
    """One fleet member: identity, client, breaker, and polled health."""

    def __init__(self, replica_id: str, url: str, *,
                 heartbeat_file: str | Path | None = None,
                 breaker: CircuitBreaker | None = None, journal=None):
        self.replica_id = replica_id
        self.url = url.rstrip("/")
        self.client = ReplicaClient(self.url)
        self.heartbeat_file = Path(heartbeat_file) if heartbeat_file else None
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            site=f"fleet.{replica_id}", journal=journal)
        self.state = JOINING
        # Pinned by an administrative drain (the autoscaler's scale-down):
        # the health poller must NOT re-LIVE a pinned replica however
        # healthy it looks.
        self.pinned = False
        self.digest: str | None = None
        self.precision: str | None = None   # from the last health poll
        self.buckets: tuple[int, ...] | None = None  # active ladder
        self.n_tenants: int | None = None   # zoo tenant count (None =
        self.stacked: bool | None = None    # single-model replica)
        self.slo_breached: list[str] = []   # breached SLO objectives
        self.queue_depth = 0          # requests, from the last health poll
        self.health_failures = 0      # consecutive unreachable polls
        self.last_poll_t = 0.0
        self._inflight = 0
        self._lock = threading.Lock()

    # -- router-side load accounting --------------------------------------
    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def done(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def load(self) -> int:
        """Least-loaded dispatch key: requests the router has in flight to
        this replica plus the queue depth its last health poll reported."""
        with self._lock:
            return self._inflight + self.queue_depth

    def snapshot(self) -> dict:
        return {"replica": self.replica_id, "url": self.url,
                "state": self.state, "pinned": self.pinned,
                "digest": self.digest,
                "precision": self.precision,
                "buckets": list(self.buckets) if self.buckets else None,
                "n_tenants": self.n_tenants, "stacked": self.stacked,
                "slo_breached": list(self.slo_breached),
                "queue_depth": self.queue_depth, "inflight": self.inflight,
                "circuit": self.breaker.state}


class FleetMembership:
    """Polls every replica's health; owns the membership state machine.

    The state machine is deliberately member-kind-agnostic: the JAX
    package's cells tier subclasses it to run whole CELLS as members,
    overriding the three class attrs so its transitions journal as
    ``cell_member`` events keyed by ``cell`` instead of
    ``fleet_member``/``replica``.
    """

    MEMBER_EVENT = "fleet_member"      # journal event per transition
    MEMBER_KEY = "replica"             # the event's identity key
    TRANSITION_METRIC = "fleet_member_transitions"

    def __init__(self, replicas: list[Replica], *, poll_s: float = 0.25,
                 fail_threshold: int = 2, health_timeout_s: float = 2.0,
                 watchdog: hb.Watchdog | None = None, journal=None):
        if not replicas:
            raise ValueError("fleet needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas = list(replicas)
        self.poll_s = float(poll_s)
        self.fail_threshold = int(fail_threshold)
        self.health_timeout_s = float(health_timeout_s)
        self.watchdog = watchdog if watchdog is not None else hb.Watchdog()
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._state_lock = threading.Lock()
        # Optional transition hook ``(member, previous, state, reason)``,
        # called AFTER the transition is journaled (so anything the hook
        # journals — e.g. the cell front's session failovers — is pinned
        # to land after its membership event).  Exceptions are contained:
        # a hook failure must not wedge the poller or a dispatch path.
        self.on_transition = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # One slot per replica so poll_once's wall is bounded by the
        # slowest member, not their sum (see poll_once); add_replica
        # swaps in a bigger pool when the fleet outgrows this one.
        self._pool_workers = max(2, len(self.replicas))
        self._poll_pool = ThreadPoolExecutor(
            max_workers=self._pool_workers,
            thread_name_prefix="fleet-health")

    # -- queries -----------------------------------------------------------
    def dispatchable(self) -> list[Replica]:
        return [r for r in self.replicas if r.state in DISPATCHABLE]

    def live_with_digest(self, digest: str) -> list[Replica]:
        return [r for r in self.replicas
                if r.state == LIVE and r.digest == digest]

    def by_id(self, replica_id: str) -> Replica:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        raise KeyError(replica_id)

    def snapshot(self) -> list[dict]:
        return [r.snapshot() for r in self.replicas]

    # -- dynamic membership (the autoscaler's seam) ------------------------
    def add_replica(self, replica: Replica) -> None:
        """Join one replica to a live membership (thread-safe).  It starts
        JOINING and goes LIVE through the same health gate as a boot-time
        member — the autoscaler never shortcuts the join path.

        Readers (``dispatchable``/``poll_once``/``snapshot``) iterate
        ``self.replicas`` without the state lock, so membership changes
        REPLACE the list atomically instead of mutating it in place.
        """
        with self._state_lock:
            if any(r.replica_id == replica.replica_id
                   for r in self.replicas):
                raise ValueError(
                    f"duplicate replica id: {replica.replica_id!r}")
            self.replicas = self.replicas + [replica]
            if len(self.replicas) > self._pool_workers:
                old = self._poll_pool
                self._pool_workers = max(2, len(self.replicas))
                self._poll_pool = ThreadPoolExecutor(
                    max_workers=self._pool_workers,
                    thread_name_prefix="fleet-health")
                old.shutdown(wait=False)
        logger.info("Fleet membership: added %s (%s)", replica.replica_id,
                    replica.url)

    def remove_replica(self, replica: Replica) -> None:
        """Remove one retired replica (thread-safe; idempotent).  Journals
        a final OUT transition so the membership stream records why the
        member disappeared, then closes its connection pool."""
        self.set_state(replica, OUT, "retired")
        with self._state_lock:
            self.replicas = [r for r in self.replicas
                             if r.replica_id != replica.replica_id]
        replica.client.close()

    # -- transitions -------------------------------------------------------
    def set_state(self, replica: Replica, state: str, reason: str, *,
                  only_from: tuple[str, ...] | None = None) -> bool:
        """Transition one replica (journaled; no-op when unchanged).

        ``only_from`` makes the transition conditional, validated UNDER
        the state lock: the health poller computes its verdicts outside
        the lock, and without the guard a replica elected canary in that
        window would be flipped straight back to LIVE — returning
        unverified weights to rotation mid-reload.  Returns whether the
        transition happened.
        """
        with self._state_lock:
            previous = replica.state
            if previous == state:
                return False
            if only_from is not None and previous not in only_from:
                return False
            replica.state = state
        if state == OUT:
            # The process behind those pooled connections is gone; a
            # relaunch reuses the port, and a stale keep-alive connection
            # to the DEAD process must not greet the NEW one with a
            # spurious reset-failover right after it rejoins.
            replica.client.close()
        self._journal.event(self.MEMBER_EVENT,
                            **{self.MEMBER_KEY: replica.replica_id},
                            state=state, previous=previous, reason=reason)
        self._journal.metrics.inc(self.TRANSITION_METRIC, state=state)
        log = logger.warning if state in (DRAINING, OUT) else logger.info
        log("%s %s: %s -> %s (%s)", self.MEMBER_EVENT, replica.replica_id,
            previous, state, reason)
        if self.on_transition is not None:
            try:
                self.on_transition(replica, previous, state, reason)
            except Exception as exc:  # noqa: BLE001 — hook must not wedge
                logger.warning("Membership transition hook failed for %s "
                               "(%s -> %s): %s", replica.replica_id,
                               previous, state, exc)
        return True

    def mark_unreachable(self, replica: Replica, reason: str) -> None:
        """A dispatch hit a dead connection: don't wait for the poller's
        fail_threshold — the process is gone, pull it now.  The next
        healthy poll (post-restart) rejoins it."""
        self.set_state(replica, OUT, reason,
                       only_from=(LIVE, DRAINING, DEGRADED))

    # -- polling -----------------------------------------------------------
    def poll_once(self) -> None:
        """Poll every replica CONCURRENTLY: a single wedged member
        (accepts TCP, never answers) must cost the fleet's health view
        one ``health_timeout_s``, not one per sibling behind it."""
        replicas = self.replicas  # atomic ref: the list is swapped, never
        if len(replicas) == 1:    # mutated, by add/remove_replica
            self._poll_replica(replicas[0])
            return
        try:
            list(self._poll_pool.map(self._poll_replica, replicas))
        except RuntimeError:
            # add_replica swapped in a bigger pool mid-poll and retired
            # this one; the next cadence tick polls everyone again.
            pass

    def _poll_replica(self, replica: Replica) -> None:
        replica.last_poll_t = time.time()
        try:
            status, data = replica.client.request(
                "GET", "/healthz", timeout_s=self.health_timeout_s)
        except (OSError, http.client.HTTPException) as exc:
            replica.health_failures += 1
            if replica.health_failures >= self.fail_threshold:
                self.set_state(replica, OUT,
                               f"unreachable: {type(exc).__name__}",
                               only_from=(LIVE, DRAINING, CANARY, DEGRADED))
            return
        replica.health_failures = 0
        try:
            payload = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError):
            payload = {}
        replica.digest = payload.get("variables_digest") \
            or payload.get("model_digest") or replica.digest
        # Each replica's active ladder + serving precision ride on its
        # /healthz (a LadderTuner retune or quant-gate fallback shows up
        # at the next poll) and surface in the fleet /healthz snapshot.
        replica.precision = payload.get("precision") or replica.precision
        buckets = payload.get("buckets")
        if isinstance(buckets, list) and buckets:
            try:
                replica.buckets = tuple(int(b) for b in buckets)
            except (TypeError, ValueError):
                pass  # malformed advert must not poison the whole poll
        # A multi-tenant replica adverts its zoo on /healthz; the tenant
        # count and stacked-engine state mirror into the snapshot the
        # fleet /healthz aggregates (single-model replicas stay None).
        zoo = payload.get("zoo")
        if isinstance(zoo, dict):
            n = zoo.get("n_tenants")
            replica.n_tenants = n if isinstance(n, int) else None
            replica.stacked = zoo.get("stacked") is not None
        else:
            # The advert stopped carrying a zoo (replica restarted as a
            # single-model server): stale tenant state must not linger
            # in the fleet snapshot.
            replica.n_tenants = None
            replica.stacked = None
        depth = payload.get("queue_depth_requests")
        if isinstance(depth, int):
            replica.queue_depth = depth
        # Per-replica SLO state rides /healthz too: the fleet endpoint
        # aggregates which members are breaching which objectives.
        slo = payload.get("slo")
        if isinstance(slo, dict):
            breached = slo.get("breached")
            replica.slo_breached = ([str(b) for b in breached]
                                    if isinstance(breached, list) else [])
        if replica.state in (CANARY, DEGRADED):
            # The rolling-reload controller owns CANARY; the outlier
            # ejector owns DEGRADED — a gray replica passes this very
            # health poll, so re-LIVE-ing it here would undo the
            # ejection every poll_s.
            return
        # The heartbeat verdict is computed FIRST and gates the rejoin:
        # checking it only after re-LIVE-ing a healthy-healthz replica
        # would flap live <-> draining every poll while the worker stays
        # wedged, spamming fleet_member events.
        stale = None
        if replica.heartbeat_file is not None:
            verdict = self.watchdog.check_file(replica.heartbeat_file)
            if verdict.stale:
                stale = (f"heartbeat_stale:{verdict.phase}:"
                         f"{verdict.age_s:.1f}s")
        # only_from excludes CANARY on every poller-side transition: the
        # early return above is a race window (the rolling-reload
        # controller can elect a canary between it and here), and a
        # canary flipped back to LIVE mid-shadow would put unverified
        # weights in rotation.  The guard re-validates under the lock.
        if status == 200 and stale is None:
            if replica.pinned:
                # An administrative drain (autoscale scale-down) holds:
                # the replica is healthy ON PURPOSE while its in-flight
                # work quiesces, and re-LIVE-ing it here would hand it
                # new dispatches mid-retirement.
                return
            reason = {JOINING: "joined", OUT: "rejoined",
                      DRAINING: "recovered"}.get(replica.state, "healthy")
            self.set_state(replica, LIVE, reason,
                           only_from=(JOINING, OUT, DRAINING))
        else:
            if status != 200:
                degraded = payload.get("degraded") or ["degraded"]
                reason = ",".join(map(str, degraded))
            else:
                reason = stale
            self.set_state(replica, DRAINING, reason, only_from=(LIVE,))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 — poller must survive
                logger.warning("Fleet membership poll failed: %s", exc)
            self._stop.wait(self.poll_s)

    def start(self) -> "FleetMembership":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="fleet-membership",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._poll_pool.shutdown(wait=False)
        for replica in self.replicas:
            replica.client.close()

    def wait_live(self, n: int, timeout_s: float = 120.0) -> bool:
        """Block until at least ``n`` replicas are live (startup helper)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.dispatchable()) >= n:
                return True
            if self._thread is None:
                self.poll_once()
            time.sleep(min(self.poll_s, 0.1))
        return len(self.dispatchable()) >= n
