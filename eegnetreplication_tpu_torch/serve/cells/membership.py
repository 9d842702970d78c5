"""Cell-level membership: which CELLS may receive traffic right now.

One fleet is one blast radius — a cell is the blast-radius boundary: a
full serving deployment (a :class:`~eegnetreplication_tpu_torch.serve.fleet.service.FleetApp`
with supervised replicas, or a single
:class:`~eegnetreplication_tpu_torch.serve.service.ServeApp` — anything that
speaks the serve HTTP protocol) that can fail, drain, or upgrade without
taking its siblings with it.  This module runs the fleet's membership state
machine one level up: a :class:`CellMember` is a
:class:`~eegnetreplication_tpu_torch.serve.fleet.membership.Replica` whose URL
is a whole cell's front door, and :class:`CellMembership` reuses the
same poll loop, state lock, and transition journaling — with cell
semantics:

- ``joining`` — spawned but never healthy yet.
- ``live`` — healthy; eligible for least-loaded bulk dispatch and new
  session placement.
- ``degraded`` — the cell answers but is unhealthy: its ``/healthz`` is
  503 (no live replicas, breaker open) or its AGGREGATE SLO state is
  breached (the replica-level ``slo.breached`` advert, mirrored upward
  through the fleet's ``any_breached``).  No NEW bulk dispatches or
  session placements; existing sessions stay sticky (the cell is alive)
  until an operator drains it.
- ``draining`` — parked by ``POST /cell/<id>/drain`` (planned
  migration): the state is PINNED — unlike a replica-level drain, a
  healthy poll must not silently undo an operator's decision; only
  ``/cell/<id>/undrain`` releases it.
- ``failed`` — the cell's health endpoint went dark (connection refused/
  reset/timeout for ``fail_threshold`` consecutive polls, or a dispatch
  hit a dead connection): the whole cell is presumed gone.  Bulk traffic
  fails over instantly (the router retries on a sibling); the cell
  front's transition hook fails its sessions over to survivors from the
  cell's snapshot spool.  The first healthy poll rejoins it.

Every transition journals a ``cell_member`` event (``cell=`` identity
key) — the cells analog of ``fleet_member``, and the event the chaos
drill pins BEFORE ``session_failover``.

Every outbound request to a cell — health polls and dispatches alike —
probes the ``cell.partition`` chaos site (default action ``refuse=`` →
``ConnectionRefusedError``), so an entire cell's death is deterministically
drillable in-process: arm ``cell.partition:if_tag=<cell_id>:times=0`` and
that one cell goes dark from the front's point of view while its process
is still running.
"""

from __future__ import annotations

import http.client
import json
import time
from pathlib import Path

from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.serve.fleet import membership as ms

JOINING = ms.JOINING
LIVE = ms.LIVE
DRAINING = ms.DRAINING
DEGRADED = ms.DEGRADED
FAILED = "failed"

# States the cell router may pick a bulk-dispatch target (or a new
# session's home) from — mirrors the replica-level DISPATCHABLE.
DISPATCHABLE = (LIVE,)


class _PartitionableClient(ms.ReplicaClient):
    """The cell front's client seam: every request probes the
    ``cell.partition`` site first, tagged with the cell id, so an armed
    ``if_tag=`` spec makes exactly one cell refuse connections — the
    in-process reproduction of a cell crash or network partition."""

    def __init__(self, url: str, cell_id: str, **kwargs):
        super().__init__(url, **kwargs)
        self.cell_id = cell_id

    def request(self, method, path, body=None, headers=None,
                timeout_s=None):
        inject.fire("cell.partition", tag=self.cell_id, path=path)
        return super().request(method, path, body=body, headers=headers,
                               timeout_s=timeout_s)


class CellMember(ms.Replica):
    """One cell: identity, client, breaker (the replica breaker one level
    up), polled aggregate health, and its session-snapshot spool on
    shared storage (what unplanned failover restores from)."""

    def __init__(self, cell_id: str, url: str, *,
                 spool: str | Path | None = None,
                 mirror: str | Path | None = None, journal=None):
        super().__init__(cell_id, url, journal=journal)
        self.client = _PartitionableClient(self.url, cell_id)
        self.spool = Path(spool) if spool is not None else None
        # Replicated spool: where the cell's SessionStore
        # mirrors its snapshots — failover's fallback when the primary
        # copy is missing or quarantined.
        self.mirror = Path(mirror) if mirror is not None else None
        self.n_live: int | None = None      # fleet cells: live replicas
        self.n_sessions: int | None = None  # advertised open sessions
        self.slo_any_breached = False
        # An operator drain is pinned: the poller must not re-LIVE it.
        self.pinned = False
        # Which authority degraded this cell: the poller recovers only
        # its OWN degradations — an outlier-ejected cell (the fleet's
        # pattern one level up) passes health polls by definition, and
        # re-LIVE-ing it here would undo the ejection every poll_s.
        self.poller_degraded = False

    @property
    def cell_id(self) -> str:
        return self.replica_id

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap.update(cell=self.cell_id, n_live=self.n_live,
                    n_sessions=self.n_sessions,
                    slo_any_breached=self.slo_any_breached,
                    pinned=self.pinned,
                    spool=str(self.spool) if self.spool else None,
                    mirror=str(self.mirror) if self.mirror else None)
        return snap


class CellMembership(ms.FleetMembership):
    """The fleet membership poller, re-targeted at whole cells."""

    MEMBER_EVENT = "cell_member"
    MEMBER_KEY = "cell"
    TRANSITION_METRIC = "cell_member_transitions"

    def set_state(self, cell, state, reason, *, only_from=None) -> bool:
        changed = super().set_state(cell, state, reason,
                                    only_from=only_from)
        if changed and state == FAILED:
            # The base class flushes pooled connections on OUT; cells
            # fail into FAILED instead, with the same stale-keep-alive
            # hazard when the cell relaunches on its port.
            cell.client.close()
        return changed

    def mark_unreachable(self, cell: CellMember, reason: str) -> None:
        """A dispatch hit a dead connection: the whole cell is presumed
        gone — don't wait for the poller.  (The transition hook then
        fails its sessions over.)"""
        self.set_state(cell, FAILED, reason,
                       only_from=(LIVE, DEGRADED, DRAINING))

    def _poll_replica(self, cell: CellMember) -> None:
        cell.last_poll_t = time.time()
        try:
            status, data = cell.client.request(
                "GET", "/healthz", timeout_s=self.health_timeout_s)
        except (OSError, http.client.HTTPException) as exc:
            cell.health_failures += 1
            if cell.health_failures >= self.fail_threshold:
                self.set_state(cell, FAILED,
                               f"unreachable: {type(exc).__name__}",
                               only_from=(LIVE, DEGRADED, DRAINING))
            return
        cell.health_failures = 0
        try:
            payload = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError):
            payload = {}
        # A cell is either a fleet front (serving_digests, n_live) or a
        # single serve process (variables_digest); accept both adverts.
        digests = payload.get("serving_digests")
        cell.digest = ((digests[0] if isinstance(digests, list) and digests
                        else None) or payload.get("variables_digest")
                       or cell.digest)
        n_live = payload.get("n_live")
        cell.n_live = n_live if isinstance(n_live, int) else None
        sessions = payload.get("sessions")
        cell.n_sessions = sessions if isinstance(sessions, int) else None
        depth = payload.get("queue_depth_requests")
        if isinstance(depth, int):
            cell.queue_depth = depth
        # Aggregate SLO state, mirrored UP the same way replicas mirror
        # it into the fleet /healthz: a fleet cell adverts any_breached
        # over its members; a single-process cell adverts its own
        # breached list (which also 503s its healthz).
        slo = payload.get("slo")
        breached = []
        if isinstance(slo, dict):
            breached = slo.get("breached") \
                or list((slo.get("replicas_breached") or {}))
        cell.slo_any_breached = bool(
            (isinstance(slo, dict) and slo.get("any_breached")) or breached)
        cell.slo_breached = ([str(b) for b in breached]
                             if isinstance(breached, list) else [])
        if cell.pinned:
            # Operator-pinned (drain/undrain owns this state): the
            # poller only keeps the health view fresh.
            return
        if status == 200 and not cell.slo_any_breached:
            reason = {JOINING: "joined", FAILED: "rejoined",
                      DEGRADED: "recovered",
                      DRAINING: "recovered"}.get(cell.state, "healthy")
            allowed = [JOINING, FAILED, DRAINING]
            if cell.poller_degraded:
                allowed.append(DEGRADED)
            if self.set_state(cell, LIVE, reason,
                              only_from=tuple(allowed)):
                cell.poller_degraded = False
        else:
            reason = ("slo_breached:" + ",".join(cell.slo_breached)
                      if status == 200 else
                      ",".join(map(str, payload.get("degraded")
                                   or [payload.get("status") or "degraded"])))
            if self.set_state(cell, DEGRADED, reason, only_from=(LIVE,)):
                cell.poller_degraded = True
