"""Front-tier HA: fencing lease + affinity WAL + rolling cell upgrades.

The CellFront made cells replaceable but was itself the last
single process in the serving path whose death costs state: its affinity
table (session -> cell) existed only in memory.  This module removes
that SPOF with two fronts over shared storage and three small pieces:

- :class:`FencingLease` — an atomic lease FILE (``tmp + os.replace``)
  holding ``{owner, url, token, t}``.  The token is bumped on every
  takeover (never on renew), so it is a fencing epoch: an old active
  that wakes from a GC/IO stall re-reads the file, sees a higher token,
  and self-fences instead of split-brain serving.  Liveness is wall
  clock with a TTL — the standby may promote only after the active's
  last renew is older than ``ttl_s``, and the active renews every
  ``ttl_s/3``, so a healthy active can never be usurped.  Every write
  probes the ``front.lease`` chaos site first (default: raise) — arming
  it makes renews fail and drives the active through its self-fence
  path deterministically.
- :class:`AffinityWAL` — a JSONL write-ahead log of every affinity
  mutation (``assign``/``flip``/``drop``), size-rotated like the run
  journal.  The ACTIVE appends under the front's table lock (so WAL
  order == table order); the STANDBY tails it by cheap full replay
  whenever the chain fingerprint changes, rebuilding the EXACT table —
  including the resync set — without replaying any traffic.  A torn
  final record (the active died mid-append) is ignored; the table is
  exact up to the last durable record, and anything newer is covered by
  the resync/replay-from-acked handshake the client already speaks.
- :class:`HAController` — the role machine (``active`` / ``standby`` /
  ``fenced``) wiring both into a front.  On promotion it replays the
  WAL, journals ``affinity_replay`` + ``front_lease action=takeover``
  (strictly BEFORE the first request the new active serves — the chaos
  drill pins that order), then re-runs the front's failover scan so
  sessions homed on cells that died during the leaderless gap
  re-materialize from their spools.

Split-brain argument: (1) clients only get served by a front whose
``is_leader`` is true; (2) a front is leader only while its renews
succeed against a lease file carrying ITS token; (3) a takeover bumps
the token atomically, so at most one owner's renews can succeed per
epoch; (4) an active that cannot read/renew within ``ttl_s`` fences
itself BEFORE the standby's earliest legal promotion time.  Affinity
writes from a fenced front are impossible because the WAL append is
gated on the live role check under the same table lock.

On top of the HA pair, :class:`RollingUpgrade` gives the front the
``POST /cells/upgrade`` orchestration: per cell, strictly serialized —
drain (live ``session_migrate`` at the quiesced frontier) -> retire +
relaunch the cell's supervised children with the new args/checkpoint ->
health-gate the rejoin (reusing the canary shadow-compare when the
model digest changed) -> undrain — with abort-and-rollback when the
upgraded cell never comes back, every step a ``cell_upgrade`` event.

The upgrader never drains the last cell the front would dispatch to: a
cell is drained only once another cell is dispatchable, it is retired
only once the requests in flight on it have answered, and an undrained
cell counts as back only once it is dispatchable again.  Dispatchable means ``live`` with
the front router's breaker for it ``closed``: a cell killed earlier can
rejoin ``live`` while its breaker still serves its cooldown (longer than
a relaunch), and the router skips an open breaker.  The upgrader waits
the cooldown out, claims the half-open probe slot as the router does
and probes the cell's ``/healthz``, so the circuit closes on evidence.
The JAX package's upgrader waits for ``live`` only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import breaker as cb
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.serve.cells import membership as cms
from eegnetreplication_tpu_torch.utils.logging import logger

ACTIVE = "active"
STANDBY = "standby"
FENCED = "fenced"


class UpgradeInProgress(RuntimeError):
    """A rolling upgrade is already running (the HTTP layer's 409);
    upgrades are strictly serialized by design."""


class FencingLease:
    """Atomic lease file with a monotonically-bumped fencing token.

    Shared storage is the arbiter: ``os.replace`` of a whole-file JSON
    record is the only write primitive, so readers never see a torn
    lease (an unparseable file reads as *no lease*, which only ever
    delays a takeover — it cannot forge one).
    """

    def __init__(self, path: str | Path, *, owner: str,
                 url: str | None = None, ttl_s: float = 3.0):
        self.path = Path(path)
        self.owner = str(owner)
        self.url = url
        self.ttl_s = float(ttl_s)
        self.token = 0  # the token this process last wrote / held

    # -- reads -------------------------------------------------------------
    def read(self) -> dict | None:
        """The current lease record, or ``None`` for absent/torn/alien."""
        try:
            rec = json.loads(self.path.read_text())
        except (OSError, ValueError, UnicodeDecodeError):
            return None
        if not isinstance(rec, dict) or not isinstance(rec.get("token"),
                                                       int):
            return None
        return rec

    def expired(self, rec: dict | None = None) -> bool:
        rec = rec if rec is not None else self.read()
        if rec is None:
            return True
        t = rec.get("t")
        return (not isinstance(t, (int, float))
                or (time.time() - t) > self.ttl_s)

    # -- writes ------------------------------------------------------------
    def _write(self, token: int) -> None:
        # The chaos seam: an armed ``front.lease`` makes this raise, so
        # renews fail and the active walks its self-fence path.
        inject.fire("front.lease", owner=self.owner, token=token)
        rec = {"owner": self.owner, "url": self.url, "token": int(token),
               "t": time.time()}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(self.path.suffix + f".{self.owner}.tmp")
        tmp.write_text(json.dumps(rec))
        os.replace(tmp, self.path)
        self.token = int(token)

    def try_acquire(self) -> bool:
        """Take the lease iff it is free, expired, or already ours.

        The token is ALWAYS bumped by an acquisition (even re-acquiring
        our own stale lease after a restart: the process lost its
        in-memory table, so this is a new fencing epoch)."""
        rec = self.read()
        if rec is not None and rec.get("owner") != self.owner \
                and not self.expired(rec):
            return False
        base = rec.get("token", 0) if rec is not None else self.token
        try:
            self._write(int(base) + 1)
        except OSError:
            return False
        return True

    def renew(self) -> str:
        """Refresh ``t`` without bumping the token.

        Returns ``"ok"``, ``"lost"`` (another owner/higher token holds
        the file — fence NOW), or ``"error"`` (the write failed; the
        caller fences once its last good renew is older than the TTL)."""
        rec = self.read()
        if rec is not None and (rec.get("owner") != self.owner
                                or rec.get("token", 0) > self.token):
            return "lost"
        try:
            self._write(self.token)
        except OSError:
            return "error"
        return "ok"

    def release(self) -> None:
        """Graceful handoff: delete the file so the peer acquires
        immediately (token continuity comes from the peer reading the
        last record first is NOT required — an absent lease acquires at
        ``self.token + 1`` only via its own last-read, so release keeps
        monotonicity by leaving takeover to ``try_acquire``)."""
        rec = self.read()
        if rec is not None and rec.get("owner") == self.owner:
            try:
                self.path.unlink(missing_ok=True)
            except OSError:
                pass


class AffinityWAL:
    """Durable, size-rotated JSONL log of affinity mutations.

    One record per line: ``{"op": "assign"|"flip"|"drop", "session": sid,
    "cell": cell_id|null, "resync": bool}``.  Appends flush immediately
    (a takeover reads what a dead active managed to write — buffering
    would widen the resync window for no benefit).

    Rotation follows the run journal's size trigger and ``.1``/``.2``
    archive shifting, with one WAL-specific twist: unlike a telemetry
    journal, dropping old records would drop live routing state (a
    session ASSIGNED a million mutations ago is still routed by that
    record), so the fresh live file opens with a ``snapshot`` marker
    followed by the COMPACTED current table.  Replay resets at the
    marker, which makes the archives pure debugging history — any
    truncation of them is harmless by construction.
    """

    def __init__(self, path: str | Path, *,
                 max_bytes: int = 4 * 1024 * 1024, keep: int = 2):
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._fh = None
        self.appended = 0
        # The writer's authoritative fold, mirrored on every append —
        # what rotation compacts into the fresh live file.
        self._state: dict[str, str] = {}
        self._resync: set[str] = set()

    @staticmethod
    def _apply(rec: dict, affinity: dict, resync: set) -> bool:
        """Fold one record; returns whether it was a valid mutation."""
        if rec.get("op") == "snapshot":
            affinity.clear()
            resync.clear()
            return False
        sid = rec.get("session")
        if not isinstance(sid, str):
            return False
        op = rec.get("op")
        if op in ("assign", "flip") and isinstance(rec.get("cell"), str):
            affinity[sid] = rec["cell"]
            if rec.get("resync"):
                resync.add(sid)
            else:
                resync.discard(sid)
            return True
        if op == "drop":
            affinity.pop(sid, None)
            resync.discard(sid)
            return True
        return False

    # -- write side --------------------------------------------------------
    def append(self, op: str, session: str, cell: str | None = None, *,
               resync: bool = False) -> None:
        rec = {"op": op, "session": session, "cell": cell,
               "resync": bool(resync)}
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            if self._fh is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                # A writer re-opening an existing WAL (front restart
                # with the same ha_dir) seeds its fold from disk so the
                # next rotation compacts the real table.
                if self.path.exists() and not self._state:
                    aff, rs, _ = self.replay()
                    self._state, self._resync = aff, rs
                self._fh = open(self.path, "a", encoding="utf-8")
                # A predecessor that died mid-append left a torn final
                # line WITHOUT a newline; start clean so our first
                # record is not spliced into (and lost with) it.
                if self._fh.tell() > 0:
                    with open(self.path, "rb") as check:
                        check.seek(-1, os.SEEK_END)
                        if check.read(1) != b"\n":
                            self._fh.write("\n")
                            self._fh.flush()
            self._fh.write(line)
            self._fh.flush()
            self._apply(rec, self._state, self._resync)
            self.appended += 1
            if self._fh.tell() >= self.max_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._fh = None
        for i in range(self.keep - 1, 0, -1):
            src = self.path.with_suffix(self.path.suffix + f".{i}")
            if src.exists():
                os.replace(src,
                           self.path.with_suffix(self.path.suffix
                                                 + f".{i + 1}"))
        if self.path.exists():
            os.replace(self.path,
                       self.path.with_suffix(self.path.suffix + ".1"))
        # Fresh live file = snapshot marker + compacted table, staged
        # then atomically replaced, so a crash mid-compaction leaves
        # either the old archives (exact) or the full new base (exact).
        lines = [json.dumps({"op": "snapshot",
                             "n_sessions": len(self._state)},
                            separators=(",", ":"))]
        for sid in sorted(self._state):
            lines.append(json.dumps(
                {"op": "assign", "session": sid,
                 "cell": self._state[sid],
                 "resync": sid in self._resync},
                separators=(",", ":")))
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text("\n".join(lines) + "\n", encoding="utf-8")
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- read side ---------------------------------------------------------
    def chain(self) -> list[Path]:
        """Every chain file oldest-first (``.N`` … ``.1``, then live)."""
        rotated = []
        for p in self.path.parent.glob(self.path.name + ".*"):
            suffix = p.name[len(self.path.name) + 1:]
            if suffix.isdigit():
                rotated.append((int(suffix), p))
        out = [p for _, p in sorted(rotated, reverse=True)]
        if self.path.exists():
            out.append(self.path)
        return out

    def fingerprint(self) -> tuple:
        """Cheap chain identity for the standby's change detection."""
        out = []
        for p in self.chain():
            try:
                out.append((p.name, p.stat().st_size))
            except OSError:
                continue
        return tuple(out)

    def replay(self) -> tuple[dict[str, str], set[str], int]:
        """Fold the whole chain into ``(affinity, resync_set,
        n_records)``.  An undecodable line — the torn tail a mid-append
        death leaves — is skipped: the table is exact over every durable
        record, and the lost mutation is covered by the client-side
        resync handshake.  A ``snapshot`` marker (rotation compaction)
        resets the fold — everything before it is redundant history."""
        affinity: dict[str, str] = {}
        resync: set[str] = set()
        n = 0
        for path in self.chain():
            try:
                text = path.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            for raw in text.splitlines():
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except ValueError:
                    continue  # torn tail / garbled record: skip, stay exact
                if isinstance(rec, dict) \
                        and self._apply(rec, affinity, resync):
                    n += 1
        return affinity, resync, n


class HAController:
    """The active/standby role machine for one CellFront.

    Wires a :class:`FencingLease` and an :class:`AffinityWAL` under a
    shared ``ha_dir`` into the front: while ACTIVE it renews the lease
    every ``ttl_s/3`` and self-fences on loss; while STANDBY it tails
    the WAL (exact table, no traffic replay) and promotes only after
    lease expiry; FENCED serves nothing but keeps answering the leader
    hint so clients route away."""

    def __init__(self, front, ha_dir: str | Path, *, owner: str,
                 url: str | None = None, ttl_s: float = 3.0,
                 poll_s: float | None = None, journal=None):
        self.front = front
        self.owner = str(owner)
        ha_dir = Path(ha_dir)
        self.lease = FencingLease(ha_dir / "lease.json", owner=owner,
                                  url=url, ttl_s=ttl_s)
        self.wal = AffinityWAL(ha_dir / "affinity.wal")
        self.role = STANDBY
        self.poll_s = (float(poll_s) if poll_s is not None
                       else max(0.05, float(ttl_s) / 6.0))
        self._journal = journal if journal is not None else front.journal
        if self._journal is None:
            self._journal = obs_journal.current()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_renew_ok = time.monotonic()
        self._fingerprint: tuple | None = None
        self.takeovers = 0
        front.ha = self

    # -- public surface ----------------------------------------------------
    def leader_hint(self) -> str | None:
        """The advertised leader URL from the lease file (may be stale
        by up to one TTL — clients health-check before following)."""
        rec = self.lease.read()
        url = (rec or {}).get("url")
        return url if isinstance(url, str) and url else None

    def start(self) -> "HAController":
        if self.lease.url is None:
            self.lease.url = self.front.url
        if self.lease.try_acquire():
            self._become_active("acquire")
        else:
            rec = self.lease.read() or {}
            self._journal.event("front_lease", action="standby",
                               owner=self.owner,
                               token=rec.get("token", 0),
                               leader=rec.get("owner"))
            logger.info("Front %s standing by behind leader %s",
                        self.owner, rec.get("owner"))
        self._thread = threading.Thread(target=self._run,
                                        name=f"ha-{self.owner}",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self, release: bool = True) -> None:
        """Stop the role thread; ``release=True`` deletes our lease so
        the peer promotes immediately (a crash test passes ``False`` to
        leave the lease to expire naturally)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if release and self.role == ACTIVE:
            self.lease.release()
            self._journal.event("front_lease", action="release",
                               owner=self.owner, token=self.lease.token)
        self.wal.close()

    # -- role machine ------------------------------------------------------
    def _become_active(self, action: str) -> None:
        self.role = ACTIVE
        self._last_renew_ok = time.monotonic()
        self._journal.event("front_lease", action=action, owner=self.owner,
                           token=self.lease.token)
        self._journal.metrics.inc("front_lease_transitions", action=action)
        logger.info("Front %s is ACTIVE (lease token %d, %s)", self.owner,
                    self.lease.token, action)

    def _fence(self, reason: str) -> None:
        self.role = FENCED
        self._journal.event("front_lease", action="fenced",
                           owner=self.owner, token=self.lease.token,
                           reason=reason)
        self._journal.metrics.inc("front_lease_transitions",
                                  action="fenced")
        logger.warning("Front %s FENCED: %s", self.owner, reason)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                if self.role == ACTIVE:
                    self._tick_active()
                elif self.role == STANDBY:
                    self._tick_standby()
                # FENCED: stay put; the hint keeps routing clients away.
            except Exception as exc:  # noqa: BLE001 — the loop must live
                logger.warning("HA tick (%s, role=%s) failed: %s",
                               self.owner, self.role, exc)

    def _tick_active(self) -> None:
        status = self.lease.renew()
        now = time.monotonic()
        if status == "ok":
            self._last_renew_ok = now
        elif status == "lost":
            self._fence("lease owned by another front")
        elif now - self._last_renew_ok > self.lease.ttl_s:
            # Write failures tolerated up to one TTL: past that, the
            # standby's promotion clock may have run out — stop serving
            # BEFORE it can legally take over.
            self._fence("lease renew failing past TTL")

    def _tick_standby(self) -> None:
        fp = self.wal.fingerprint()
        if fp != self._fingerprint:
            affinity, resync, _ = self.wal.replay()
            self.front._install_affinity(affinity, resync)
            self._fingerprint = fp
        rec = self.lease.read()
        if (rec is None or self.lease.expired(rec)) \
                and self.lease.try_acquire():
            self._promote()

    def _promote(self) -> None:
        """Lease is ours: final exact replay, THEN the takeover event,
        THEN traffic — the journal pins that order — then the front's
        failover scan for cells that died while nobody was leader."""
        affinity, resync, n = self.wal.replay()
        self.front._install_affinity(affinity, resync)
        self._fingerprint = self.wal.fingerprint()
        self._journal.event("affinity_replay", n_records=n,
                           n_sessions=len(affinity),
                           n_resync=len(resync))
        self._journal.metrics.inc("affinity_replays")
        self.takeovers += 1
        self.role = ACTIVE
        self._last_renew_ok = time.monotonic()
        self._journal.event("front_lease", action="takeover",
                           owner=self.owner, token=self.lease.token,
                           n_sessions=len(affinity))
        self._journal.metrics.inc("front_lease_transitions",
                                  action="takeover")
        logger.warning("Front %s promoted to ACTIVE (token %d, %d "
                       "session(s) replayed)", self.owner,
                       self.lease.token, len(affinity))
        for cell in list(self.front.cells):
            if cell.state == cms.FAILED \
                    and self.front._sessions_on(cell.cell_id):
                self.front._failover_cell_sessions(cell)


class RollingUpgrade:
    """Front-orchestrated rolling upgrade of supervised cells.

    Per cell, strictly serialized (one cell of capacity out at a time):
    ``drain -> relaunch -> live -> undrain``, each step a journaled
    ``cell_upgrade`` event.  A cell that never comes back healthy within
    ``live_timeout_s`` is rolled back to its previous spec (journaled
    ``timeout`` + ``rollback``) and the loop aborts — later cells keep
    their old version, which is the safe half-upgraded state.  When the
    relaunch changed the model digest, the rejoin is additionally gated
    by the canary-style shadow compare (recent bulk bodies dispatched to
    the upgraded cell AND a reference sibling; argmax agreement below
    ``agree_floor`` rolls back)."""

    def __init__(self, front, supervisor, spec_factory, *, journal=None,
                 live_timeout_s: float = 300.0,
                 drain_timeout_s: float = 120.0, shadow_n: int = 8,
                 agree_floor: float = 0.8, poll_s: float = 0.25):
        self.front = front
        self.supervisor = supervisor
        # spec_factory(cell_id, checkpoint, serve_args) -> ChildSpec;
        # checkpoint/serve_args None = keep the current values.
        self.spec_factory = spec_factory
        self._journal = journal if journal is not None else front.journal
        self.live_timeout_s = float(live_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.shadow_n = int(shadow_n)
        self.agree_floor = float(agree_floor)
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        # cell_id -> {"checkpoint", "serve_args"}: what each cell runs
        # NOW (the rollback target).
        self._current: dict[str, dict] = {}

    def set_current(self, cell_id: str, checkpoint, serve_args) -> None:
        self._current[cell_id] = {"checkpoint": checkpoint,
                                  "serve_args": list(serve_args or [])}

    def _event(self, cell_id: str, action: str, **fields) -> None:
        self._journal.event("cell_upgrade", cell=cell_id, action=action,
                           **fields)
        self._journal.metrics.inc("cell_upgrade_steps", action=action)

    # -- orchestration -----------------------------------------------------
    def run(self, checkpoint=None, serve_args=None,
            live_timeout_s=None) -> dict:
        if not self._lock.acquire(blocking=False):
            raise UpgradeInProgress("a rolling upgrade is already running")
        try:
            return self._run_serialized(
                checkpoint, serve_args,
                float(live_timeout_s) if live_timeout_s else
                self.live_timeout_s)
        finally:
            self._lock.release()

    def _run_serialized(self, checkpoint, serve_args,
                        live_timeout_s) -> dict:
        upgraded, result = [], {"status": "ok"}
        for cell in sorted(self.front.cells, key=lambda c: c.cell_id):
            outcome = self._upgrade_cell(cell, checkpoint, serve_args,
                                         live_timeout_s)
            if outcome is None:
                upgraded.append(cell.cell_id)
                continue
            result = {"status": outcome, "failed_cell": cell.cell_id}
            break
        result["upgraded"] = upgraded
        result["cells"] = [c.cell_id for c in self.front.cells]
        return result

    def _upgrade_cell(self, cell, checkpoint, serve_args,
                      live_timeout_s) -> str | None:
        """One cell through the state machine; ``None`` = success,
        otherwise the terminal status string."""
        cell_id = cell.cell_id
        old = dict(self._current.get(cell_id)
                   or {"checkpoint": None, "serve_args": None})
        old_digest = cell.digest
        others = [c for c in self.front.cells if c is not cell]
        if others and not self._wait_dispatchable(others, live_timeout_s):
            self._event(cell_id, "abort",
                        reason="no other cell dispatchable within "
                               f"{live_timeout_s:g}s")
            return "aborted"
        self._event(cell_id, "drain",
                    n_sessions=len(self.front._sessions_on(cell_id)))
        try:
            drained = self.front.drain_cell(cell)
        except Exception as exc:  # noqa: BLE001 — abort leaves it serving
            self._event(cell_id, "abort",
                        reason=f"drain: {type(exc).__name__}: {exc}"[:200])
            self.front.undrain_cell(cell)
            return "aborted"
        if drained["failed"]:
            self._event(cell_id, "abort",
                        reason=f"drain left {len(drained['failed'])} "
                               "session(s) stuck")
            self.front.undrain_cell(cell)
            return "aborted"
        self._wait_idle(cell, self.drain_timeout_s)
        self._event(cell_id, "relaunch",
                    checkpoint=str(checkpoint) if checkpoint else None)
        self._relaunch(cell_id, checkpoint or old.get("checkpoint"),
                       serve_args if serve_args is not None
                       else old.get("serve_args"))
        if not self._wait_healthy(cell, live_timeout_s):
            self._event(cell_id, "timeout",
                        waited_s=round(live_timeout_s, 3))
            return self._rollback(cell, cell_id, old)
        self._event(cell_id, "live", digest=cell.digest)
        if cell.digest and old_digest and cell.digest != old_digest:
            agree = self._shadow_compare(cell)
            if agree is not None:
                self._event(cell_id, "shadow", agree=round(agree, 4),
                            floor=self.agree_floor)
                if agree < self.agree_floor:
                    return self._rollback(cell, cell_id, old)
        self.front.undrain_cell(cell)
        if not self._wait_state(cell, cms.LIVE, live_timeout_s):
            self._event(cell_id, "timeout", waited_s=round(live_timeout_s,
                                                           3))
            return self._rollback(cell, cell_id, old)
        self._event(cell_id, "undrain", digest=cell.digest)
        if not self._wait_dispatchable([cell], live_timeout_s):
            self._event(cell_id, "timeout", waited_s=round(live_timeout_s,
                                                           3))
            return self._rollback(cell, cell_id, old)
        self._current[cell_id] = {
            "checkpoint": checkpoint or old.get("checkpoint"),
            "serve_args": (serve_args if serve_args is not None
                           else old.get("serve_args"))}
        return None

    def _relaunch(self, cell_id: str, checkpoint, serve_args) -> None:
        self.supervisor.retire_child(cell_id)
        self.supervisor.add_child(
            self.spec_factory(cell_id, checkpoint, serve_args))

    def _rollback(self, cell, cell_id: str, old: dict) -> str:
        """Relaunch the previous spec and wait it back; the cell returns
        on the OLD digest with zero session loss (its sessions were
        migrated off before the relaunch)."""
        self._relaunch(cell_id, old.get("checkpoint"),
                       old.get("serve_args"))
        back = self._wait_healthy(cell, self.live_timeout_s)
        if back:
            self.front.undrain_cell(cell)
            if self._wait_state(cell, cms.LIVE, self.live_timeout_s):
                self._wait_dispatchable([cell], self.live_timeout_s)
        self._event(cell_id, "rollback", recovered=back,
                    digest=cell.digest)
        self._journal.metrics.inc("cell_upgrade_rollbacks")
        logger.warning("Upgrade of cell %s rolled back (recovered=%s)",
                       cell_id, back)
        return "rolled_back"

    # -- gates -------------------------------------------------------------
    def _wait_healthy(self, cell, timeout_s: float) -> bool:
        """Direct healthz probe (the cell is pinned draining, so the
        membership poller keeps health fresh but will not re-LIVE it —
        the upgrade owns the state transition)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                status, data = cell.client.request("GET", "/healthz",
                                                   timeout_s=5.0)
            except Exception:  # noqa: BLE001 — relaunching: expected dark
                time.sleep(self.poll_s)
                continue
            if status == 200:
                try:
                    payload = json.loads(data.decode())
                except (ValueError, UnicodeDecodeError):
                    payload = {}
                digests = payload.get("serving_digests")
                cell.digest = ((digests[0] if isinstance(digests, list)
                                and digests else None)
                               or payload.get("variables_digest")
                               or cell.digest)
                return True
            time.sleep(self.poll_s)
        return False

    def _wait_state(self, cell, state: str, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cell.state == state:
                return True
            time.sleep(self.poll_s)
        return False

    def _wait_dispatchable(self, cells, timeout_s: float) -> bool:
        """Wait until the front would dispatch to one of ``cells``: live
        with a closed breaker.  A half-open breaker that no request is
        probing is probed here (its slot claimed with ``allow()``, as the
        router claims it); an open one is waited out."""
        deadline = time.monotonic() + timeout_s
        while True:
            for cell in cells:
                if cell.state != cms.LIVE:
                    continue
                state = cell.breaker.state
                if state == cb.HALF_OPEN and cell.breaker.allow():
                    self._probe(cell)
                    state = cell.breaker.state
                if state == cb.CLOSED:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(self.poll_s)

    def _wait_idle(self, cell, timeout_s: float) -> bool:
        """Wait until the drained cell has no request in flight.  The
        router picked it for them before the drain; a retire under them
        would leave their failover only the cells they did not try, and
        a request that found a sibling's half-open slot taken has tried
        it."""
        deadline = time.monotonic() + timeout_s
        while cell.inflight and time.monotonic() < deadline:
            time.sleep(min(self.poll_s, 0.01))
        return not cell.inflight

    def _probe(self, cell) -> None:
        """One ``/healthz`` through the front's client, its outcome
        recorded on the cell's breaker (a 200 closes a half-open one)."""
        try:
            status, _ = cell.client.request("GET", "/healthz",
                                            timeout_s=5.0)
        except Exception:  # noqa: BLE001 — any transport failure counts
            status = None
        if status == 200:
            cell.breaker.record_success()
        else:
            cell.breaker.record_failure()

    def _shadow_compare(self, canary_cell) -> float | None:
        """Canary-style shadow compare over recent bulk bodies: the
        upgraded cell vs a live sibling; ``None`` when no reference or
        no traffic to replay (nothing to gate on)."""
        reference = next((c for c in self.front.cells
                          if c.cell_id != canary_cell.cell_id
                          and c.state == cms.LIVE), None)
        bodies = self.front.router.recent_bodies(self.shadow_n)
        if reference is None or not bodies:
            return None
        agrees = []
        for body, content_type in bodies:
            try:
                # dispatch_to answers (status, body), as the fleet
                # canary's shadow compare reads it.
                _, ref_data = self.front.router.dispatch_to(
                    reference, body, content_type)
                _, can_data = self.front.router.dispatch_to(
                    canary_cell, body, content_type)
                ref = _predictions(ref_data)
                can = _predictions(can_data)
            except Exception as exc:  # noqa: BLE001 — advisory gate
                logger.warning("Upgrade shadow compare failed: %s", exc)
                continue
            if not ref or len(ref) != len(can):
                continue
            agree = sum(1 for a, b in zip(ref, can) if a == b) / len(ref)
            agrees.append(agree)
            self._journal.event("fleet_shadow",
                               replica=canary_cell.cell_id,
                               reference=reference.cell_id,
                               n_trials=len(ref),
                               agree=round(agree, 4))
        return sum(agrees) / len(agrees) if agrees else None


def _predictions(data: bytes) -> list[int]:
    try:
        payload = json.loads(data.decode())
    except (ValueError, UnicodeDecodeError):
        return []
    preds = payload.get("predictions")
    return [int(p) for p in preds] if isinstance(preds, list) else []
