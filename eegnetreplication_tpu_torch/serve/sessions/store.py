"""Session store: crash-consistent snapshots of every live stream.

The port's copy of ``eegnetreplication_tpu/serve/sessions/store.py``.  The
``sessions.npz`` format, its keys and its digest are the JAX package's, so a
snapshot or an export written by either package restores in the other.
Restored and imported sessions put their EMS carry on the store's device.

Per-session state (EMS carry, window buffer, decision record) dies with
the process unless something writes it down — and a supervisor restart,
the exact recovery path the resilience stack exists for, would then
silently corrupt or drop a live decoding stream.  The store persists ALL
live sessions into one flat npz under the same contracts as training
checkpoints:

- sha256 content digest embedded and verified
  (:mod:`~eegnetreplication_tpu_torch.resil.integrity`);
- atomic same-directory tmp + rename (a crash mid-write can only damage
  the staged file);
- keep-N generation rotation with quarantine-and-fallback on a corrupt
  newest generation
  (:func:`~eegnetreplication_tpu_torch.training.checkpoint.rotate_generations` /
  :func:`~eegnetreplication_tpu_torch.training.checkpoint.resolve_snapshot` —
  the same machinery, not a reimplementation);
- the ``session.snapshot`` / ``session.restore`` chaos sites, so the
  whole corrupt-write -> quarantine -> previous-generation path is
  deterministically drillable.

Snapshots happen periodically (every ``snapshot_every_windows`` decided
windows, amortized across sessions), at every session close, and at the
SIGTERM drain (the store registers a :mod:`~eegnetreplication_tpu_torch.resil.preempt`
drain hook).  ``restore()`` runs once at startup under ``--resume``:
clients then read their last-acked sample cursor from
``GET /session/<id>/state`` and replay from there — the chunking-invariant
EMS carrier turns the replayed suffix into byte-identical windows, so
every window decided ``ok`` after the resume carries the prediction an
uninterrupted run would have produced.  (Degraded ``expired``/``error``
statuses are timing statements about the load at delivery, not about the
signal: a window that expired just before the crash may heal to ``ok``
when the replay re-decides it.)
"""

from __future__ import annotations

import io
import json
import re
import threading
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import inject, integrity, preempt
from eegnetreplication_tpu_torch.resil import retry as resil_retry
from eegnetreplication_tpu_torch.serve.sessions.session import StreamSession
from eegnetreplication_tpu_torch.training.checkpoint import (
    resolve_snapshot,
    rotate_generations,
    snapshot_keep,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device
from eegnetreplication_tpu_torch.utils.logging import logger

# Session ids travel in URL paths and become npz key prefixes; constrain
# them so neither layer needs escaping.
_SESSION_ID_RE = re.compile(r"^[A-Za-z0-9_-]{1,64}$")

# Restoring at startup is worth a couple of spaced re-reads (the
# session.restore chaos site injects exactly this transient shape), but a
# deterministic failure must fall through fast — the serving process is
# mid-boot.
RESTORE_RETRY = resil_retry.RetryPolicy(max_attempts=3, base_delay_s=0.05,
                                        max_delay_s=1.0)


def valid_session_id(session_id: str) -> bool:
    return bool(_SESSION_ID_RE.match(session_id or ""))


class SessionExists(ValueError):
    """An imported session id is already open in this store (the HTTP
    layer answers 409 — importing over a live stream would silently fork
    its decision record)."""


def _session_flat(session_id: str, state: dict[str, np.ndarray]
                  ) -> dict[str, np.ndarray]:
    """One session's state under the SAME key layout the full-store
    snapshot uses (``s/<sid>/<key>`` + ``__meta__``) — a single-session
    export is a one-session store snapshot, not a second format."""
    flat = {f"s/{session_id}/{k}": v for k, v in state.items()}
    flat["__meta__"] = np.frombuffer(json.dumps(
        {"sessions": [session_id]}).encode(), dtype=np.uint8)
    return flat


def pack_session(session_id: str, state: dict[str, np.ndarray]) -> bytes:
    """Serialize one session's state arrays into a stamped npz byte
    string (the migration wire format)."""
    flat = integrity.stamp(_session_flat(session_id, state))
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def unpack_session(data: bytes) -> tuple[str, dict[str, np.ndarray]]:
    """Parse and integrity-verify a single-session npz byte string;
    returns ``(session_id, state_arrays)``.

    Raises :class:`~eegnetreplication_tpu_torch.resil.integrity.IntegrityError`
    on ANY corruption or tampering — including bytes so damaged the zip
    no longer parses, and exports missing their digest (unlike training
    checkpoints there are no pre-integrity legacy session exports, so an
    unstamped payload is refused rather than trusted).
    """
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as npz:
            flat = {k: npz[k] for k in npz.files}
    except Exception as exc:  # noqa: BLE001 — any parse failure is corruption
        raise integrity.IntegrityError(
            f"session import is not a readable npz: "
            f"{type(exc).__name__}: {exc}") from exc
    if integrity.stored_digest(flat) is None:
        raise integrity.IntegrityError(
            "session import carries no content digest")
    integrity.verify(flat, what="session import")
    flat.pop(integrity.DIGEST_KEY, None)
    try:
        meta = json.loads(bytes(flat.pop("__meta__")).decode())
        sessions = meta["sessions"]
    except (KeyError, ValueError, UnicodeDecodeError) as exc:
        raise integrity.IntegrityError(
            f"session import metadata unreadable: {exc}") from exc
    if len(sessions) != 1:
        raise integrity.IntegrityError(
            f"session import must hold exactly one session, got "
            f"{sessions!r}")
    sid = str(sessions[0])
    if not valid_session_id(sid):
        raise integrity.IntegrityError(
            f"session import names an invalid session id {sid!r}")
    prefix = f"s/{sid}/"
    state = {k[len(prefix):]: v for k, v in flat.items()
             if k.startswith(prefix)}
    if not state:
        raise integrity.IntegrityError(
            f"session import holds no state for its own id {sid!r}")
    return sid, state


def peek_session_id(data: bytes) -> str | None:
    """Best-effort session id of a packed export WITHOUT verifying it —
    only the ``__meta__`` zip entry is decompressed.

    Routing tiers (the fleet front) need the id BEFORE choosing where to
    forward an import: a repeated import of one session must land on the
    replica that already holds it (409) rather than fork the stream onto
    a fresh least-loaded pick.  Returns ``None`` for anything unreadable
    — the serving store's :func:`unpack_session` is the integrity
    authority and will refuse the payload with a proper error.
    """
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as npz:
            meta = json.loads(bytes(npz["__meta__"]).decode())
        sessions = meta["sessions"]
        if len(sessions) == 1 and valid_session_id(str(sessions[0])):
            return str(sessions[0])
    except Exception:  # noqa: BLE001 — peek is advisory, never the gate
        pass
    return None


SNAPSHOT_NAME = "sessions.npz"
# A spool read that found no session while the chain changed under it
# lists the chain again, at most this many times in all.
SPOOL_READ_ATTEMPTS = 3


def _spool_chain(spool: Path) -> list[Path]:
    """Every file of the snapshot chains ``spool`` names: a snapshot file
    and its ``.gen*`` generations, or, for a directory, those of every
    ``sessions.npz`` below it.  A chain whose newest file is missing still
    counts: a snapshot in progress has rotated it to ``.gen1`` and not yet
    renamed the new one into place."""
    if spool.suffix == ".npz" or spool.is_file():
        name, found = spool.name, spool.parent.glob(spool.name + "*")
    elif spool.is_dir():
        name, found = SNAPSHOT_NAME, spool.rglob(SNAPSHOT_NAME + "*")
    else:
        return []
    chain = re.compile(re.escape(name) + r"(\.gen\d+)?")
    return sorted(p for p in found if chain.fullmatch(p.name))


def _chain_fingerprint(files: list[Path]) -> tuple:
    """What a rotation changes in a chain: each file's inode, size and
    modification time (``None`` once it is gone)."""
    out = []
    for path in files:
        try:
            st = path.stat()
        except FileNotFoundError:
            out.append((str(path), None))
            continue
        out.append((str(path), st.st_ino, st.st_size, st.st_mtime_ns))
    return tuple(out)


def read_spooled_session(spool: str | Path, session_id: str) -> bytes | None:
    """Extract ``session_id`` from a dead cell's snapshot spool as a
    stamped single-session export, or ``None`` when no valid generation
    holds it.

    ``spool`` is either a store snapshot file (``.../sessions.npz``) or a
    directory searched recursively for ``sessions.npz`` spools (a
    fleet-shaped cell keeps one spool per replica).  Resolution walks the
    same generation chain restores use — a corrupt newest generation is
    skipped and the previous one answers.

    The cell may still be alive and snapshotting (a partition, not a
    crash), so the read expects the chain to rotate under it: a spool
    whose newest file is absent while a ``.gen*`` exists is read through
    its generations, nothing is quarantined (the cell owns its chain), and
    a read that found no session while the chain changed is made again
    (:data:`SPOOL_READ_ATTEMPTS`).
    """
    spool = Path(spool)
    prefix = f"s/{session_id}/"
    for _ in range(SPOOL_READ_ATTEMPTS):
        chain = _spool_chain(spool)
        before = _chain_fingerprint(chain)
        bases = sorted({p.with_name(re.sub(r"\.gen\d+$", "", p.name))
                        for p in chain})
        for path in bases:
            resolved = resolve_snapshot(path, quarantine=False)
            if resolved is None:
                continue
            state = {k[len(prefix):]: v for k, v in resolved[1].items()
                     if k.startswith(prefix)}
            if state:
                return pack_session(session_id, state)
        if _chain_fingerprint(_spool_chain(spool)) == before:
            return None        # a settled chain without the session
    return None


class SessionStore:
    """Live sessions + their durable snapshot chain.

    ``path`` names the snapshot file (``<dir>/sessions.npz``); ``None``
    runs the store in-memory only (sessions work, nothing survives a
    restart — test/bench convenience, never the served default).
    ``device`` is where every session's EMS carry lives (``None`` selects
    one through ``utils/device.py``).
    """

    def __init__(self, path: str | Path | None, *, keep: int | None = None,
                 mirror: str | Path | None = None,
                 snapshot_every_windows: int = 50, journal=None,
                 device: torch.device | str | None = None):
        self.path = Path(path) if path is not None else None
        self.device = resolve_device(device)
        # Replicated spool: every snapshot is ALSO written (same stamped
        # bytes, same atomic discipline) to this second path — ideally a
        # different disk/share — so failover survives the primary copy
        # being corrupt or missing.  Mirror failures never fail the
        # primary write; they journal a ``spool_mirror`` event instead.
        self.mirror = Path(mirror) if mirror is not None else None
        self.keep = keep
        self.snapshot_every_windows = max(1, int(snapshot_every_windows))
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._lock = threading.Lock()          # the session table
        self._snap_lock = threading.Lock()     # serializes snapshot writes
        # At most ONE periodic background snapshot in flight: a second
        # threshold crossing while one runs is simply absorbed by it (the
        # write captures the then-current state) or by the next trigger.
        self._async_snap = threading.Semaphore(1)
        self._sessions: dict[str, StreamSession] = {}
        self._windows_at_last_snap = 0
        self.snapshots = 0
        self.restored: list[str] = []
        # Graceful-stop drain: a preempted process flushes session state
        # even when the stop unwinds past ServeApp.stop (hooks are
        # idempotent — an orderly stop just re-flushes cheaply).
        preempt.add_drain_hook(self.snapshot)

    # -- session table ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._sessions)

    def get(self, session_id: str) -> StreamSession:
        with self._lock:
            return self._sessions[session_id]  # KeyError -> 404 upstream

    def open(self, session_id: str, **session_kwargs
             ) -> tuple[StreamSession, bool]:
        """Create (or re-attach to) a session; returns ``(session,
        resumed)``.  Opening an id that already exists — typically one
        restored from a snapshot — re-attaches WITHOUT touching its
        state, so a client's post-restart open is how it learns its
        resume cursor."""
        if not valid_session_id(session_id):
            raise ValueError(
                f"invalid session id {session_id!r} (want 1-64 chars of "
                "[A-Za-z0-9_-])")
        with self._lock:
            existing = self._sessions.get(session_id)
            if existing is not None:
                return existing, True
            session = StreamSession(session_id, device=self.device,
                                    **session_kwargs)
            self._sessions[session_id] = session
            return session, False

    # -- migration (single-session export/import) -------------------------
    def export_session(self, session_id: str) -> bytes:
        """One live session as a stamped single-session npz (the
        migration wire format).  The session's lock is held across the
        serialization, so the export captures a quiesced decided-frontier
        state — the same rollback contract as the full snapshot: any
        produced-but-undecided window is re-extracted from the buffered
        samples after the import.  Raises ``KeyError`` for an unknown id
        (the HTTP layer's 404)."""
        session = self.get(session_id)
        with session.lock:
            state = session.state_arrays()
        return pack_session(session_id, state)

    def import_session(self, data: bytes) -> StreamSession:
        """Re-materialize an exported session in THIS store.

        The payload is integrity-verified BEFORE any state changes: a
        corrupt or tampered export raises
        :class:`~eegnetreplication_tpu_torch.resil.integrity.IntegrityError`
        and the store — including any live session under the same id —
        is left untouched.  An id already open here raises
        :class:`SessionExists` (the HTTP layer's 409): importing over a
        live stream would fork its decision record.  The imported
        session is journaled as a ``session_resume`` (it IS one: the
        client's next open/state read returns the acked cursor) and
        persisted immediately, so a crash right after the import cannot
        lose the migrated stream.
        """
        session_id, state = unpack_session(data)
        session = StreamSession.from_state(session_id, state,
                                           device=self.device)
        with self._lock:
            if session_id in self._sessions:
                raise SessionExists(
                    f"session {session_id!r} is already open in this store")
            self._sessions[session_id] = session
        self._journal.event("session_resume", session=session_id,
                            acked=session.acked,
                            windows=session.windows_decided,
                            snapshot="import")
        self._journal.metrics.inc("session_imports")
        self.snapshot()
        logger.info("Session %s imported: acked %d samples, %d window(s) "
                    "decided", session_id, session.acked,
                    session.windows_decided)
        return session

    def take(self, session_id: str) -> StreamSession | None:
        """Atomically claim a session out of the table (``None`` when it
        is already gone) — the winner of racing closes gets the session,
        the loser gets a clean miss instead of a KeyError."""
        with self._lock:
            return self._sessions.pop(session_id, None)

    def close(self, session_id: str) -> StreamSession | None:
        """Remove a session from the table (its terminal summary is the
        caller's to journal) and persist the now-smaller table so a
        restart does not resurrect the closed stream."""
        session = self.take(session_id)
        self.snapshot()
        self.compact_departed(session_id)
        return session

    def compact_departed(self, session_id: str) -> int:
        """Scrub a departed session from every retained ``.gen*``
        snapshot generation; returns the number of generations rewritten
        or removed.

        close()/discard/migrate shrink the NEWEST snapshot, but the
        generation fallback chain still holds the departed stream — so a
        corrupt newest generation would resurrect a closed session on
        restore, and a cell-spool read (:func:`read_spooled_session`)
        could fail a MIGRATED session over to a second cell, forking the
        stream the migration just moved.  Each generation is rewritten
        in place (re-stamped digest, same atomic tmp+replace discipline
        as the snapshot itself); a generation left holding no sessions
        is unlinked.  Keep-guard: a session still open in this store is
        never scrubbed — its generations ARE its crash fallback.
        """
        if self.path is None:
            return 0
        with self._lock:
            if session_id in self._sessions:
                return 0  # keep-guard: still open here
        prefix = f"s/{session_id}/"
        gen_re = re.compile(re.escape(self.path.name) + r"\.gen\d+$")
        compacted = 0
        with self._snap_lock:
            for gen in sorted(self.path.parent.glob(
                    self.path.name + ".gen*")):
                if not gen_re.fullmatch(gen.name):
                    continue  # quarantined corpses, tmp files
                try:
                    with np.load(gen, allow_pickle=False) as npz:
                        flat = {k: npz[k] for k in npz.files}
                    meta = json.loads(bytes(flat["__meta__"]).decode())
                    sessions = list(meta["sessions"])
                except Exception:  # noqa: BLE001 — corrupt gens are
                    continue       # resolve_snapshot's to quarantine
                if session_id not in sessions:
                    continue
                # Keep-guard at the generation level too: scrub ONLY the
                # departed id; co-resident open sessions keep their
                # fallback state byte-for-byte.
                flat = {k: v for k, v in flat.items()
                        if not k.startswith(prefix)}
                sessions.remove(session_id)
                if not sessions:
                    gen.unlink(missing_ok=True)
                    compacted += 1
                    continue
                flat.pop(integrity.DIGEST_KEY, None)
                flat["__meta__"] = np.frombuffer(json.dumps(
                    {"sessions": sessions}).encode(), dtype=np.uint8)
                integrity.stamp(flat)
                tmp = gen.with_suffix(gen.suffix + ".tmp")
                with open(tmp, "wb") as fh:
                    np.savez(fh, **flat)
                tmp.replace(gen)
                compacted += 1
        if compacted:
            self._journal.metrics.inc("session_generations_compacted",
                                      compacted)
            logger.debug("Compacted departed session %s out of %d "
                         "snapshot generation(s)", session_id, compacted)
        return compacted

    # -- durability -------------------------------------------------------
    def _flatten(self) -> tuple[dict[str, np.ndarray], int, int]:
        """One flat mapping over every live session (each under its
        session lock, so no ingest can interleave with its serialization).
        """
        flat: dict[str, np.ndarray] = {}
        total_windows = 0
        with self._lock:
            sessions = dict(self._sessions)
        for sid in sorted(sessions):
            session = sessions[sid]
            with session.lock:
                state = session.state_arrays()
                total_windows += session.windows_decided
            for key, value in state.items():
                flat[f"s/{sid}/{key}"] = value
        flat["__meta__"] = np.frombuffer(json.dumps(
            {"sessions": sorted(sessions)}).encode(), dtype=np.uint8)
        return flat, total_windows, len(sessions)

    def snapshot(self) -> Path | None:
        """Persist every live session (stamped, atomic, rotated); returns
        the snapshot path or ``None`` for an in-memory store.  Safe to
        call from any thread and idempotent — the drain hook, the
        periodic trigger, and close() all land here."""
        if self.path is None:
            return None
        with self._snap_lock:
            flat, total_windows, n_sessions = self._flatten()
            integrity.stamp(flat)
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(self.path.suffix + ".tmp")
            with open(tmp, "wb") as fh:
                np.savez(fh, **flat)
            # The chaos site garbles the STAGED bytes — the exact shape of
            # a crash mid-tmp.replace — so the drill proves restore falls
            # back through the generation chain.
            inject.fire("session.snapshot", path=tmp,
                        n_sessions=n_sessions)
            rotate_generations(
                self.path, self.keep if self.keep is not None
                else snapshot_keep())
            tmp.replace(self.path)
            self.snapshots += 1
            self._windows_at_last_snap = total_windows
            if self.mirror is not None:
                self._write_mirror(flat, n_sessions)
            # Journal INSIDE the write lock: a background periodic
            # snapshot racing the drain snapshot must emit its event
            # before the drain's (and so always before serve_end).
            self._journal.event("session_snapshot", path=str(self.path),
                                n_sessions=n_sessions,
                                n_windows=total_windows)
            self._journal.metrics.inc("session_snapshots")
            logger.debug("Session snapshot: %d session(s), %d decided "
                         "window(s) -> %s", n_sessions, total_windows,
                         self.path)
        return self.path

    def _write_mirror(self, flat: dict, n_sessions: int) -> None:
        """Write-both half of the replicated spool: the SAME stamped
        flat mapping the primary just persisted, atomic tmp+replace,
        under the snapshot lock.  Fires the ``spool.mirror`` chaos site
        (default: corrupt the staged bytes) so drills can prove the
        mirror's own generation-chain fallback.  Failure is contained —
        the primary snapshot already landed."""
        try:
            self.mirror.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.mirror.with_suffix(self.mirror.suffix + ".tmp")
            with open(tmp, "wb") as fh:
                np.savez(fh, **flat)
            inject.fire("spool.mirror", path=tmp, n_sessions=n_sessions)
            rotate_generations(
                self.mirror, self.keep if self.keep is not None
                else snapshot_keep())
            tmp.replace(self.mirror)
            self._journal.metrics.inc("session_mirror_writes")
        except Exception as exc:  # noqa: BLE001 — mirror is best-effort
            self._journal.event("spool_mirror", action="write_failed",
                                path=str(self.mirror),
                                reason=f"{type(exc).__name__}: {exc}"[:200])
            logger.warning("Session mirror write to %s failed: %s",
                           self.mirror, exc)

    def maybe_snapshot(self) -> bool:
        """Kick off a BACKGROUND snapshot when ``snapshot_every_windows``
        new windows have been decided since the last one (called from the
        ``/samples`` handler).  Asynchronous on purpose: the serialize +
        sha256 + npz write must never sit on a streaming client's reply
        path, and ``_flatten`` takes every session's lock — a slow
        session must not couple into another session's real-time
        latency.  Returns whether a snapshot was scheduled."""
        if self.path is None:
            return False
        with self._lock:
            total = sum(s.windows_decided for s in self._sessions.values())
        if total - self._windows_at_last_snap < self.snapshot_every_windows:
            return False
        if not self._async_snap.acquire(blocking=False):
            return False  # one already in flight; it captures this state

        def _run():
            try:
                self.snapshot()
            except Exception as exc:  # noqa: BLE001 — periodic, retried
                logger.warning("Background session snapshot failed: %s",
                               exc)
            finally:
                self._async_snap.release()

        threading.Thread(target=_run, name="session-snapshot",
                         daemon=True).start()
        return True

    def drain_background(self, timeout: float = 30.0) -> None:
        """Wait for any in-flight background snapshot (shutdown path: the
        drain snapshot and its journal event must come LAST)."""
        if self._async_snap.acquire(timeout=timeout):
            self._async_snap.release()
        else:
            logger.warning("Background session snapshot still running "
                           "after %.1fs", timeout)

    def restore(self) -> list[str]:
        """Load the newest valid snapshot generation (quarantining corrupt
        ones and falling back — :func:`resolve_snapshot`); returns the
        restored session ids.  Missing snapshot = clean start."""
        if self.path is None:
            return []

        def _resolve():
            inject.fire("session.restore", path=self.path)
            return resolve_snapshot(self.path)

        try:
            resolved = resil_retry.call(_resolve, policy=RESTORE_RETRY,
                                        site="session.restore")
        except FileNotFoundError:
            return []
        except Exception as exc:  # noqa: BLE001 — boot must not die on this
            logger.warning("Session restore failed (%s); starting with no "
                           "sessions", exc)
            return []
        if resolved is None:
            return []
        resolved_path, flat = resolved
        flat.pop(integrity.DIGEST_KEY, None)
        meta = json.loads(bytes(flat.pop("__meta__")).decode())
        restored = []
        for sid in meta.get("sessions", []):
            prefix = f"s/{sid}/"
            state = {k[len(prefix):]: v for k, v in flat.items()
                     if k.startswith(prefix)}
            session = StreamSession.from_state(sid, state,
                                               device=self.device)
            with self._lock:
                self._sessions[sid] = session
            restored.append(sid)
            self._journal.event("session_resume", session=sid,
                                acked=session.acked,
                                windows=session.windows_decided,
                                snapshot=str(resolved_path))
            self._journal.metrics.inc("session_resumes")
            logger.info("Session %s restored from %s: acked %d samples, "
                        "%d window(s) decided", sid, resolved_path,
                        session.acked, session.windows_decided)
        self.restored = restored
        with self._lock:
            self._windows_at_last_snap = sum(
                s.windows_decided for s in self._sessions.values())
        return restored

    def detach(self) -> None:
        """Unregister the drain hook (ServeApp.stop after its final
        snapshot; test teardown)."""
        preempt.remove_drain_hook(self.snapshot)
