"""Journal aggregation: many ``events.jsonl`` streams, one rolling
:class:`FleetState`.

The port's copy of ``eegnetreplication_tpu/obs/agg.py``.  Every process
journals on its own (a supervisor, each train child it launches, a
server), each under ``<dir>/<run_id>/events.jsonl``; this module reads
them live, for the console (``obs/top.py``):

- :func:`discover_runs` resolves metricsDir roots into run directories at
  any nesting depth (a supervised run's children may journal under their
  own ``--metricsDir`` beside or below the supervisor's);
- :class:`JournalTailer` reads one journal incrementally: a byte cursor per
  file, a torn final line held back until its newline lands, and a live
  file that shrank below the cursor (a rotation) drains the sealed
  ``events.jsonl.1`` from the old cursor before restarting at offset 0;
- :class:`FleetState` folds the tailed events into a rolling view per run
  (role, status, rps and latency quantiles from ``request`` and ``span``
  events, breaker and SLO state, per-tenant traffic, training
  fold-epochs/s, ``checkpoint_write`` stalls, probes, adaptation);
- :class:`Aggregator` wires the three together and journals one
  ``agg_snapshot`` event per poll.

It reads journals of either package, never writes to a tailed run, and
never raises on a crashed one: an unparseable line is counted and
skipped.  The fold keeps the JAX package's fleet, cell, lease and upgrade
fields, so a journal of a tier the port does not have yet reads the same.
"""

from __future__ import annotations

import json
import numbers
import time
from collections import deque
from pathlib import Path

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs.stats import percentile

DEFAULT_WINDOW_S = 60.0

# Span families worth a live tail estimate (the full set is unbounded —
# per-request span names would grow the snapshot without bound).
_SPAN_CAP = 4096


def discover_runs(paths: list[str | Path]) -> list[Path]:
    """Resolve CLI args into run directories (dirs holding an
    ``events.jsonl`` or its rotated segments), at any nesting depth.

    An argument that is itself a run dir is taken as-is; any other
    directory is treated as a metricsDir root and walked recursively —
    fleet runs nest replicas one level down (``replica_obs/<run_id>``)
    and cells runs nest members TWO levels down
    (``c0_obs/<cell_run>/replica_obs/<replica_run>``), so a fixed-depth
    glob cannot be correct.  Order is deterministic: argument order, then
    sorted path order within each root.
    """
    runs: list[Path] = []
    seen: set[Path] = set()
    for arg in paths:
        p = Path(arg)
        if _is_run_dir(p):
            candidates = [p]
        elif p.is_dir():
            found = {f.parent for f in p.rglob("events.jsonl*")
                     if _is_journal_name(f.name)}
            candidates = sorted(found)
        else:
            candidates = []
        for c in candidates:
            if c not in seen:
                seen.add(c)
                runs.append(c)
    return runs


def _is_journal_name(name: str) -> bool:
    if name == "events.jsonl":
        return True
    suffix = name[len("events.jsonl"):]
    return suffix.startswith(".") and suffix[1:].isdigit()


def _is_run_dir(p: Path) -> bool:
    if (p / "events.jsonl").exists():
        return True
    return p.is_dir() and any(_is_journal_name(f.name)
                              for f in p.glob("events.jsonl.*"))


class JournalTailer:
    """Incremental reader of one run directory's event stream.

    ``poll()`` returns the events appended since the last call.  The byte
    cursor only advances past COMPLETE lines: a run killed mid-write (or
    simply racing our read) leaves a torn tail that is re-read on the
    next poll once its newline lands, so no event is ever lost or
    half-parsed.  A complete-but-unparseable line (disk corruption) is
    counted in ``dropped`` and skipped — one bad line must not wedge the
    whole fleet view.

    Rotation awareness: the journal seals ``events.jsonl`` into
    ``events.jsonl.1`` when it rolls, so the live file *shrinking* below
    our cursor means the unread bytes moved to ``.1``; we drain that
    sealed segment from the old cursor, then restart the live file at
    offset 0.  (Two rotations between polls would lose the middle
    segment — at the default 64 MiB rotation size that requires a poll
    gap measured in minutes under full write load.)
    """

    def __init__(self, run_dir: str | Path, *, cursor: int = 0):
        self.run_dir = Path(run_dir)
        self.path = self.run_dir / "events.jsonl"
        self.cursor = int(cursor)
        self.dropped = 0

    def poll(self) -> list[dict]:
        events: list[dict] = []
        try:
            size = self.path.stat().st_size
        except OSError:
            return events
        if size < self.cursor:
            sealed = Path(f"{self.path}.1")
            try:
                with open(sealed, "rb") as fh:
                    fh.seek(self.cursor)
                    events.extend(self._parse(fh.read(), sealed=True))
            except OSError:
                pass  # segment already shifted away: that tail is gone
            self.cursor = 0
        try:
            with open(self.path, "rb") as fh:
                fh.seek(self.cursor)
                chunk = fh.read()
        except OSError:
            return events
        events.extend(self._parse(chunk, sealed=False))
        return events

    def _parse(self, chunk: bytes, *, sealed: bool) -> list[dict]:
        out: list[dict] = []
        end = chunk.rfind(b"\n")
        if end < 0:
            # No complete line: hold the cursor (live file) — the torn
            # tail will be re-read whole once its newline lands.  A torn
            # tail in a SEALED segment can never complete: count it.
            if sealed and chunk.strip():
                self.dropped += 1
            return out
        if not sealed:
            self.cursor += end + 1
        for line in chunk[:end].split(b"\n"):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                self.dropped += 1
                continue
            if isinstance(ev, dict) and isinstance(ev.get("event"), str):
                out.append(ev)
            else:
                self.dropped += 1
        return out


def _num(value) -> float | None:
    return float(value) if isinstance(value, numbers.Real) else None


class _RunView:
    """The rolling fold of ONE run's event stream (internal to
    :class:`FleetState`)."""

    def __init__(self, run_dir: Path, window_s: float, clock):
        self.dir = str(run_dir)
        self._window_s = float(window_s)
        self._clock = clock
        self.run_id: str | None = None
        self.role = "run"
        self.status = "live"
        self.platform: str | None = None
        self.n_events = 0
        self.last_t: float | None = None
        self.total_requests = 0
        self._requests: deque = deque()   # (t, status, latency_ms, model)
        self._epochs: deque = deque()     # (t, n_folds)
        self._probes: deque = deque()     # (t, status, latency_ms)
        self._spans: dict[str, deque] = {}
        self.members: dict[str, dict] = {}
        self.circuit: str | None = None
        self.ejected: set[str] = set()
        self.slo_breached: set[str] = set()
        self.ckpt_writes = 0
        self.ckpt_ms = 0.0
        self.ckpt_blocked_ms = 0.0
        # Elastic-fleet autoscaler (fleet_scale events): latest declared
        # target vs the n_live the decision saw, plus decision counters.
        self.scale_target: int | None = None
        self.scale_actual: int | None = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_forced = 0
        # Closed-loop adaptation (adaptation_*/shadow_eval/promotion):
        # rolling shadow agreement plus lifetime decision counters.
        self.adapt_candidates = 0
        self._shadow: deque = deque()     # (t, agree)
        self.promotions = 0
        self.promotion_refusals = 0
        self.adapt_rollbacks = 0
        # Front-tier HA (front_lease/affinity_replay events): who holds
        # the fencing lease at what token, plus role-churn counters.
        self.lease_owner: str | None = None
        self.lease_token: int | None = None
        self.lease_role: str | None = None
        self.lease_takeovers = 0
        self.lease_fenced = 0
        self.affinity_replays = 0
        # Rolling upgrades (cell_upgrade) + replicated spool
        # (spool_mirror) activity.
        self.upgrading_cell: str | None = None
        self.cells_upgraded = 0
        self.upgrade_rollbacks = 0
        self.mirror_restores = 0

    # -- folding ----------------------------------------------------------
    def fold(self, events: list[dict]) -> None:
        for ev in events:
            self.n_events += 1
            t = _num(ev.get("t"))
            if t is not None:
                self.last_t = t
            kind = ev["event"]
            handler = getattr(self, f"_on_{kind}", None)
            if handler is not None:
                handler(ev, t)
        self._prune()

    def _on_run_start(self, ev, t):
        self.run_id = ev.get("run_id")
        self.platform = ev.get("platform")

    def _on_run_end(self, ev, t):
        self.status = str(ev.get("status", "ok"))

    def _on_serve_start(self, ev, t):
        self.role = "serve"

    def _on_train_setup(self, ev, t):
        self.role = "train"

    def _on_fleet_start(self, ev, t):
        self.role = "fleet"

    def _on_cell_front_start(self, ev, t):
        self.role = "cells"

    def _on_supervisor_start(self, ev, t):
        self.role = "supervisor"

    def _on_request(self, ev, t):
        self.total_requests += 1
        if t is not None:
            self._requests.append((t, ev.get("status"),
                                   _num(ev.get("latency_ms")),
                                   ev.get("model")))

    def _on_span(self, ev, t):
        name, dur = ev.get("name"), _num(ev.get("dur_ms"))
        if t is None or not isinstance(name, str) or dur is None:
            return
        dq = self._spans.setdefault(name, deque(maxlen=_SPAN_CAP))
        dq.append((t, dur))

    def _on_fleet_member(self, ev, t):
        replica = ev.get("replica")
        if replica is not None:
            self.members[str(replica)] = {"kind": "replica",
                                          "state": ev.get("state")}

    def _on_cell_member(self, ev, t):
        cell = ev.get("cell")
        if cell is not None:
            self.members[str(cell)] = {"kind": "cell",
                                       "state": ev.get("state")}

    def _on_fleet_scale(self, ev, t):
        target, actual = _num(ev.get("target")), _num(ev.get("n_live"))
        if target is not None:
            self.scale_target = int(target)
        if actual is not None:
            self.scale_actual = int(actual)
        action = ev.get("action")
        if action == "up":
            self.scale_ups += 1
        elif action == "down":
            self.scale_downs += 1
        elif action == "forced":
            self.scale_forced += 1

    def _on_circuit_state(self, ev, t):
        self.circuit = ev.get("state")

    def _on_replica_ejected(self, ev, t):
        self.ejected.add(str(ev.get("replica")))

    def _on_replica_readmitted(self, ev, t):
        self.ejected.discard(str(ev.get("replica")))

    def _on_slo_breach(self, ev, t):
        self.slo_breached.add(str(ev.get("objective")))

    def _on_slo_recovered(self, ev, t):
        self.slo_breached.discard(str(ev.get("objective")))

    def _on_epoch(self, ev, t):
        if t is not None:
            n_folds = _num(ev.get("n_folds")) or 1.0
            self._epochs.append((t, n_folds))

    def _on_checkpoint_write(self, ev, t):
        self.ckpt_writes += 1
        self.ckpt_ms += _num(ev.get("dur_ms")) or 0.0
        if not ev.get("drain"):
            self.ckpt_blocked_ms += _num(ev.get("blocked_ms")) or 0.0

    def _on_adaptation_candidate(self, ev, t):
        self.adapt_candidates += 1

    def _on_shadow_eval(self, ev, t):
        agree = _num(ev.get("agree"))
        if t is not None and agree is not None:
            self._shadow.append((t, agree))

    def _on_promotion(self, ev, t):
        action = ev.get("action")
        if action == "promote":
            self.promotions += 1
        elif action == "refused":
            self.promotion_refusals += 1
        elif action == "rollback":
            self.adapt_rollbacks += 1

    def _on_front_lease(self, ev, t):
        action = ev.get("action")
        self.lease_owner = ev.get("owner")
        token = _num(ev.get("token"))
        if token is not None:
            self.lease_token = int(token)
        self.lease_role = {"acquire": "active", "takeover": "active",
                           "standby": "standby", "fenced": "fenced",
                           "release": "released"}.get(action,
                                                      self.lease_role)
        if action == "takeover":
            self.lease_takeovers += 1
        elif action == "fenced":
            self.lease_fenced += 1

    def _on_affinity_replay(self, ev, t):
        self.affinity_replays += 1

    def _on_cell_upgrade(self, ev, t):
        action = ev.get("action")
        if action == "drain":
            self.upgrading_cell = str(ev.get("cell"))
        elif action == "undrain":
            self.cells_upgraded += 1
            self.upgrading_cell = None
        elif action == "rollback":
            self.upgrade_rollbacks += 1
            self.upgrading_cell = None

    def _on_spool_mirror(self, ev, t):
        if ev.get("action") == "restored":
            self.mirror_restores += 1

    def _on_probe(self, ev, t):
        if t is not None:
            self._probes.append((t, ev.get("status"),
                                 _num(ev.get("latency_ms"))))

    def _prune(self) -> None:
        horizon = self._clock() - self._window_s
        for dq in (self._requests, self._epochs, self._probes,
                   self._shadow, *self._spans.values()):
            while dq and dq[0][0] < horizon:
                dq.popleft()

    # -- reading ----------------------------------------------------------
    def _rate(self, dq: deque) -> float:
        if not dq:
            return 0.0
        elapsed = max(1e-9, min(self._window_s, self._clock() - dq[0][0]))
        return len(dq) / elapsed

    def snapshot(self) -> dict:
        self._prune()
        out = {"dir": self.dir, "run_id": self.run_id, "role": self.role,
               "status": self.status, "platform": self.platform,
               "n_events": self.n_events, "last_t": self.last_t,
               "total_requests": self.total_requests,
               "window_requests": len(self._requests),
               "rps": round(self._rate(self._requests), 3)}
        ok_lat = [lat for _, status, lat, _ in self._requests
                  if status == "ok" and lat is not None]
        if ok_lat:
            out["p50_ms"] = round(percentile(ok_lat, 0.50), 3)
            out["p95_ms"] = round(percentile(ok_lat, 0.95), 3)
        errors = sum(1 for _, status, _, _ in self._requests
                     if status not in ("ok", None))
        out["window_non_ok"] = errors
        tenants: dict[str, int] = {}
        for _, _, _, model in self._requests:
            if model is not None:
                tenants[str(model)] = tenants.get(str(model), 0) + 1
        if tenants:
            out["tenants"] = dict(sorted(tenants.items()))
        if self.members:
            out["members"] = {k: dict(v)
                              for k, v in sorted(self.members.items())}
        if self.circuit is not None:
            out["circuit"] = self.circuit
        if self.ejected:
            out["ejected"] = sorted(self.ejected)
        if self.slo_breached:
            out["slo_breached"] = sorted(self.slo_breached)
        if self._epochs:
            # fold-epochs/s: each epoch event covers n_folds folds.
            elapsed = max(1e-9, min(self._window_s,
                                    self._clock() - self._epochs[0][0]))
            out["fold_epochs_per_s"] = round(
                sum(n for _, n in self._epochs) / elapsed, 3)
        if self.ckpt_writes:
            out["ckpt"] = {"writes": self.ckpt_writes,
                           "ms": round(self.ckpt_ms, 3),
                           "blocked_ms": round(self.ckpt_blocked_ms, 3)}
        if self.scale_target is not None:
            out["scale"] = {"target": self.scale_target,
                            "actual": self.scale_actual,
                            "ups": self.scale_ups,
                            "downs": self.scale_downs,
                            "forced": self.scale_forced}
        if self.lease_owner is not None:
            out["lease"] = {"owner": self.lease_owner,
                            "token": self.lease_token,
                            "role": self.lease_role,
                            "takeovers": self.lease_takeovers,
                            "fenced": self.lease_fenced,
                            "replays": self.affinity_replays}
        if (self.cells_upgraded or self.upgrade_rollbacks
                or self.upgrading_cell):
            out["upgrade"] = {"done": self.cells_upgraded,
                              "rollbacks": self.upgrade_rollbacks,
                              "draining": self.upgrading_cell}
        if self.mirror_restores:
            out["mirror_restores"] = self.mirror_restores
        if (self.adapt_candidates or self.promotions
                or self.promotion_refusals or self.adapt_rollbacks
                or self._shadow):
            adapt = {"candidates": self.adapt_candidates,
                     "promotions": self.promotions,
                     "refusals": self.promotion_refusals,
                     "rollbacks": self.adapt_rollbacks}
            if self._shadow:
                agrees = [a for _, a in self._shadow]
                adapt["shadow_window"] = len(agrees)
                adapt["shadow_agreement"] = round(
                    sum(agrees) / len(agrees), 4)
            out["adapt"] = adapt
        if self._probes:
            probe_ok = [lat for _, status, lat in self._probes
                        if status == "ok" and lat is not None]
            out["probes"] = {
                "window": len(self._probes),
                "failures": sum(1 for _, status, _ in self._probes
                                if status != "ok")}
            if probe_ok:
                out["probes"]["p95_ms"] = round(
                    percentile(probe_ok, 0.95), 3)
        spans = {}
        for name, dq in sorted(self._spans.items()):
            durs = [d for _, d in dq]
            if durs:
                spans[name] = {"n": len(durs),
                               "p95_ms": round(percentile(durs, 0.95), 3)}
        if spans:
            out["spans"] = spans
        return out


class FleetState:
    """Rolling fold of MANY runs' event streams into one fleet view."""

    def __init__(self, *, window_s: float = DEFAULT_WINDOW_S,
                 clock=time.time):
        self.window_s = float(window_s)
        self._clock = clock
        self._runs: dict[str, _RunView] = {}

    def fold(self, run_dir: str | Path, events: list[dict]) -> None:
        key = str(run_dir)
        view = self._runs.get(key)
        if view is None:
            view = self._runs[key] = _RunView(Path(run_dir), self.window_s,
                                              self._clock)
        view.fold(events)

    def snapshot(self) -> dict:
        runs = [view.snapshot() for _, view in sorted(self._runs.items())]
        members: dict[str, dict] = {}
        breached: set[str] = set()
        for r in runs:
            for member, info in (r.get("members") or {}).items():
                members[member] = info
            breached.update(r.get("slo_breached") or ())
        return {"t": self._clock(),
                "window_s": self.window_s,
                "n_runs": len(runs),
                "n_members": len(members),
                "members": dict(sorted(members.items())),
                "rps": round(sum(r.get("rps", 0.0) for r in runs), 3),
                "slo_breached": sorted(breached),
                "runs": runs}


class Aggregator:
    """Discovery + tailing + folding, one ``poll()`` at a time.

    ``cursors`` seeds the per-journal byte cursors (as returned by
    :meth:`cursors`), so a restarted aggregator resumes where it left
    off instead of re-folding history into fresh rolling windows.
    ``poll()`` journals one ``agg_snapshot`` event into the ACTIVE run
    journal (a no-op outside a run context) — the aggregator's cadence
    and fleet size are themselves observable.
    """

    def __init__(self, roots: list[str | Path], *,
                 window_s: float = DEFAULT_WINDOW_S, journal=None,
                 clock=time.time):
        self.roots = [str(r) for r in roots]
        self.window_s = float(window_s)
        self.state = FleetState(window_s=window_s, clock=clock)
        self._journal = journal
        self._tailers: dict[str, JournalTailer] = {}
        self._seed_cursors: dict[str, int] = {}

    def seed_cursors(self, cursors: dict[str, int]) -> None:
        """Byte offsets (from a prior :meth:`cursors`) applied to run
        dirs as they are (re)discovered."""
        self._seed_cursors.update({str(k): int(v)
                                   for k, v in cursors.items()})

    def cursors(self) -> dict[str, int]:
        return {key: t.cursor for key, t in sorted(self._tailers.items())}

    @property
    def dropped_lines(self) -> int:
        return sum(t.dropped for t in self._tailers.values())

    def poll(self) -> dict:
        for run_dir in discover_runs(self.roots):
            key = str(run_dir)
            tailer = self._tailers.get(key)
            if tailer is None:
                tailer = self._tailers[key] = JournalTailer(
                    run_dir, cursor=self._seed_cursors.pop(key, 0))
            events = tailer.poll()
            if events:
                self.state.fold(run_dir, events)
        snap = self.state.snapshot()
        snap["dropped_lines"] = self.dropped_lines
        journal = self._journal if self._journal is not None \
            else obs_journal.current()
        journal.event("agg_snapshot", n_runs=snap["n_runs"],
                      n_members=snap["n_members"], window_s=self.window_s)
        return snap
