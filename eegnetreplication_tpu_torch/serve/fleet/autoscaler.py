"""SLO-driven elastic fleet: the autoscaling control plane.

The graceful-degradation chain so far ends at *shedding*: hedges absorb a
slow replica, AIMD admission sheds bulk load at saturation — but the
fleet never gets bigger.  A replica's cold start (CUDA context, kernel
load, bucket-graph capture) takes seconds, so the right response to
sustained overload is capacity, not refusals.  This module closes that loop: hedge → shed → **scale**.

:class:`Autoscaler` is a control loop in the router process.  Every
``interval_s`` it reads three measured signals:

- **arrival rate** — offered load at the router edge, from the
  :class:`~eegnetreplication_tpu_torch.serve.admission.ArrivalWindow` the fleet
  app records every request into (shed/bounced traffic counts: offered
  load is exactly what completions cannot show);
- **per-replica capacity** — a high-water estimate of measured completed
  throughput per live replica, decayed slowly while the fleet is busy so
  a stale estimate re-learns (the same measure-don't-configure stance as
  the AIMD admission controller);
- **membership truth** — the roster from
  :class:`~eegnetreplication_tpu_torch.serve.fleet.membership.FleetMembership`.
  A JOINING or OUT member still counts toward the capacity commitment
  (the supervisor is bringing it up/back), so a replica SIGKILLed
  mid-scale-up is *replaced*, never double-counted.  The journal is
  advisory, never authoritative: a restarted autoscaler resyncs from
  membership alone (adopting in-flight joins and half-finished drains).

The decision mirrors the AIMD admission pattern: utilization =
arrival / (roster × capacity) against a **hysteresis band**
(``up_threshold`` / ``down_threshold``; inside it the fleet holds), a
**max-step guard** (at most ``max_step`` replicas per decision), and
separate **up/down cooldowns** so bursty arrivals cannot flap the fleet.
Before capacity has ever been measured, a backlog signal (mean load per
live replica) and the optional p95-vs-SLO signal stand in for it.

Scale-up spawns through a scaler seam
(:class:`~eegnetreplication_tpu_torch.serve.fleet.service.ReplicaScaler`:
supervisor ``add_child`` + membership ``add_replica``); the new replica
goes LIVE only through the normal health gate.  Scale-down is
**provably drain-safe**: the victim is pinned (the health poller must
not re-LIVE it), moved to DRAINING (no new dispatches), its in-flight
work and queue are polled to zero, and only then is it retired — the
journal shows ``down`` → ``drained`` (with the quiesce proof) before
the retirement, or ``down`` → ``forced`` when the drain timed out, so
zero-request-loss is checkable post-hoc from the event stream alone.

Every decision journals a ``fleet_scale`` event carrying its FULL input
snapshot (arrival, throughput, p95, capacity, utilization, members), so
any scaling action is explainable after the fact.  Chaos: the
``fleet.scale`` inject site fires with ``tag="spawn"`` before each
launch and ``tag="drain"`` inside the quiesce wait.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.serve.fleet import membership as ms
from eegnetreplication_tpu_torch.utils.logging import logger


@dataclass
class AutoscalerPolicy:
    """Control-loop knobs: band, step, cooldowns, drain/join budgets."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 0.5          # control-loop cadence
    # The hysteresis band on utilization = arrival / (roster * capacity):
    # above up_threshold the fleet grows, below down_threshold it may
    # shrink, inside the band it holds.  A shrink must also PROJECT below
    # up_threshold after removal, or the controller would flap.
    up_threshold: float = 0.85
    down_threshold: float = 0.40
    # Backlog escape hatch (works before capacity is ever measured): mean
    # router-side load per live replica (in-flight + advertised queue)
    # above this forces a scale-up signal.
    backlog_high: float = 4.0
    # Optional latency signal: rolling p95 above this is an up signal
    # (0 = disabled).  Secondary to utilization on purpose — a cold
    # start's graph captures would otherwise trigger spurious growth.
    target_p95_ms: float = 0.0
    max_step: int = 1                # replicas added/removed per decision
    up_cooldown_s: float = 2.0
    down_cooldown_s: float = 6.0
    drain_timeout_s: float = 20.0    # quiesce budget before a forced retire
    join_timeout_s: float = 120.0    # stillborn: JOINING longer than this
    capacity_decay: float = 0.05     # high-water relearn rate while busy

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")
        if not 0.0 < self.down_threshold < self.up_threshold:
            raise ValueError(
                f"need 0 < down_threshold < up_threshold, got "
                f"{self.down_threshold}/{self.up_threshold}")
        if self.max_step < 1:
            raise ValueError(f"max_step must be >= 1, got {self.max_step}")
        if self.interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {self.interval_s}")


class Autoscaler:
    """The fleet's elastic control loop (runs on its own thread).

    ``scaler`` is the action seam: ``spawn() -> Replica`` registers a new
    supervised child + membership entry, ``retire(replica)`` tears both
    down.  ``stats_fn() -> {"arrival_rps", "ok_rps", "p95_ms"}`` supplies
    the measured load windows (the fleet app's
    :meth:`~eegnetreplication_tpu_torch.serve.fleet.service.FleetApp.window_stats`
    in production, scripted windows in a drill).
    """

    def __init__(self, membership: ms.FleetMembership, scaler, stats_fn, *,
                 policy: AutoscalerPolicy | None = None, journal=None,
                 clock=time.monotonic, sleep=time.sleep):
        self.membership = membership
        self.scaler = scaler
        self.stats_fn = stats_fn
        self.policy = policy or AutoscalerPolicy()
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._clock = clock
        self._sleep = sleep
        self._capacity_rps = 0.0
        self._next_up_at = 0.0
        self._next_down_at = 0.0
        # Autoscaler-spawned replicas that have not gone LIVE yet, keyed
        # by id -> spawn instant: past join_timeout_s they are stillborn
        # and reaped (the supervisor's crash-loop breaker catches a
        # BOUNCING child; this catches one that comes up but never serves).
        self._pending_joins: dict[str, float] = {}
        # Half-finished drains adopted from a previous incarnation's
        # membership state (pinned replicas found at resync).
        self._adopted_drains: list[ms.Replica] = []
        self.n_ups = 0
        self.n_downs = 0
        self.n_forced = 0
        self.n_spawn_failures = 0
        self.last_target: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._resync()

    # -- journal -----------------------------------------------------------
    def _emit(self, action: str, reason: str, target: int, n_live: int,
              **extra) -> None:
        """Every ``fleet_scale`` event flows through this one call site so
        the required keys are always literal kwargs."""
        self._journal.event("fleet_scale", action=action, reason=reason,
                            target=target, n_live=n_live, **extra)
        self._journal.metrics.set("fleet_target_replicas", target)
        self.last_target = target

    def _snap(self, stats: dict, util: float | None,
              load_per: float) -> dict:
        """The decision's full input snapshot, journaled with it."""
        return {
            "arrival_rps": round(float(stats.get("arrival_rps") or 0.0), 3),
            "ok_rps": round(float(stats.get("ok_rps") or 0.0), 3),
            "p95_ms": (round(float(stats["p95_ms"]), 3)
                       if stats.get("p95_ms") is not None else None),
            "capacity_rps": round(self._capacity_rps, 3),
            "utilization": round(util, 4) if util is not None else None,
            "load_per_replica": round(load_per, 3),
            "members": {r.replica_id: r.state
                        for r in self.membership.replicas},
        }

    # -- membership-truth bookkeeping --------------------------------------
    def _roster(self) -> list[ms.Replica]:
        """The capacity commitment: every member not being drained away.
        JOINING and OUT members count — the supervisor is bringing them
        up or back, and spawning a sibling on top would double-count the
        capacity already committed."""
        return [r for r in self.membership.replicas if not r.pinned]

    def _resync(self) -> None:
        """Derive ALL state from membership truth (the journal is
        advisory): adopt in-flight joins and half-finished drains, so an
        autoscaler restarted mid-decision continues instead of acting on
        a stale picture."""
        now = self._clock()
        roster = self._roster()
        live = self.membership.dispatchable()
        self._pending_joins = {r.replica_id: now for r in roster
                               if r.state == ms.JOINING}
        self._adopted_drains = [r for r in self.membership.replicas
                                if r.pinned]
        self._emit("resync", "membership_truth", len(roster), len(live),
                   pending_joins=sorted(self._pending_joins),
                   adopted_drains=[r.replica_id
                                   for r in self._adopted_drains],
                   members={r.replica_id: r.state
                            for r in self.membership.replicas})

    # -- the control loop --------------------------------------------------
    def tick(self) -> None:
        """One control-loop iteration (public so tests and drills can
        drive the loop deterministically)."""
        self._finish_adopted_drains()
        self._reap_stillborn()
        stats = self.stats_fn() or {}
        roster = self._roster()
        live = self.membership.dispatchable()
        n, n_live = len(roster), len(live)
        arrival = float(stats.get("arrival_rps") or 0.0)
        ok_rps = float(stats.get("ok_rps") or 0.0)
        p95 = stats.get("p95_ms")
        load_per = (sum(r.load for r in live) / n_live) if n_live else 0.0
        busy = load_per >= 1.0
        # Capacity: high-water measured per-live-replica throughput.  Only
        # a BUSY fleet's throughput reflects capacity (an idle fleet
        # completes exactly what arrives), so the estimate rises any time
        # and decays only under load.
        per = ok_rps / n_live if n_live else 0.0
        if per > self._capacity_rps:
            self._capacity_rps = per
        elif busy and self._capacity_rps > 0.0:
            self._capacity_rps = max(
                per, self._capacity_rps * (1.0 - self.policy.capacity_decay))
        util = (arrival / (n * self._capacity_rps)
                if n and self._capacity_rps > 0.0 else None)
        now = self._clock()

        up_reason = None
        if util is not None and util > self.policy.up_threshold:
            up_reason = (f"utilization {util:.2f} > "
                         f"{self.policy.up_threshold}")
        elif load_per > self.policy.backlog_high:
            up_reason = (f"backlog {load_per:.1f} > "
                         f"{self.policy.backlog_high}")
        elif self.policy.target_p95_ms > 0 and p95 is not None \
                and float(p95) > self.policy.target_p95_ms and busy:
            up_reason = (f"p95 {float(p95):.0f}ms > "
                         f"{self.policy.target_p95_ms:.0f}ms")
        if up_reason is not None:
            if n >= self.policy.max_replicas or now < self._next_up_at:
                return  # at the ceiling, or cooling down: hold
            target = min(self.policy.max_replicas, n + self.policy.max_step)
            self._scale_up(target, n_live, up_reason,
                           self._snap(stats, util, load_per))
            return

        # Scale-down: below the band AND projected post-removal
        # utilization still clear of the up threshold (anti-flap), with
        # idle (arrival ~ 0, no backlog) standing in while capacity is
        # still unmeasured.
        n_after = n - self.policy.max_step
        util_after = (arrival / (n_after * self._capacity_rps)
                      if n_after > 0 and self._capacity_rps > 0.0 else 0.0)
        idle = arrival <= 0.01 and load_per <= 0.01
        down_ok = (util is not None and util < self.policy.down_threshold
                   and util_after < self.policy.up_threshold
                   and load_per < 1.0) or (util is None and idle)
        if down_ok and n > self.policy.min_replicas \
                and n_live > 1 and now >= self._next_down_at:
            target = max(self.policy.min_replicas,
                         n - self.policy.max_step)
            reason = ("idle" if util is None
                      else f"utilization {util:.2f} < "
                           f"{self.policy.down_threshold}")
            self._scale_down(target, n_live, reason,
                             self._snap(stats, util, load_per))

    # -- actions -----------------------------------------------------------
    def _scale_up(self, target: int, n_live: int, reason: str,
                  snap: dict) -> None:
        n_new = target - len(self._roster())
        self._emit("up", reason, target, n_live, **snap)
        self._journal.metrics.inc("fleet_scale_ups")
        self.n_ups += 1
        logger.warning("Autoscaler: scale up to %d (%s)", target, reason)
        # Cooldowns start at the DECISION (spawn failures included): a
        # failing spawn path must retry at the cooldown cadence, never in
        # a hot loop.
        now = self._clock()
        self._next_up_at = now + self.policy.up_cooldown_s
        self._next_down_at = now + self.policy.down_cooldown_s
        for _ in range(n_new):
            try:
                inject.fire("fleet.scale", tag="spawn", target=target)
                replica = self.scaler.spawn()
            except Exception as exc:  # noqa: BLE001 — journal, hold, retry
                self.n_spawn_failures += 1
                self._emit("up_failed",
                           f"{type(exc).__name__}: {exc}"[:200],
                           target, n_live)
                self._journal.metrics.inc("fleet_scale_failures")
                logger.warning("Autoscaler: spawn failed: %s", exc)
                return
            self._pending_joins[replica.replica_id] = self._clock()

    def _scale_down(self, target: int, n_live: int, reason: str,
                    snap: dict) -> None:
        live = [r for r in self.membership.dispatchable() if not r.pinned]
        if not live:
            return
        # Victim: the least-loaded live replica; ties prefer the highest
        # index so elastic members retire before the boot-time core.
        victim = min(live, key=lambda r: (r.load, -_replica_index(r)))
        self._emit("down", reason, target, n_live,
                   replica=victim.replica_id, **snap)
        self._journal.metrics.inc("fleet_scale_downs")
        self.n_downs += 1
        logger.warning("Autoscaler: scale down to %d — draining %s (%s)",
                       target, victim.replica_id, reason)
        self._next_down_at = self._clock() + self.policy.down_cooldown_s
        victim.pinned = True
        if not self.membership.set_state(victim, ms.DRAINING,
                                         "autoscale_drain",
                                         only_from=(ms.LIVE,)):
            # Lost a race (crashed/ejected since selection): unpin and
            # let the next tick look again — membership truth moved.
            victim.pinned = False
            self._emit("down_aborted", "lost_transition_race", target,
                       len(self.membership.dispatchable()),
                       replica=victim.replica_id)
            return
        self._finish_drain(victim, target)

    def _finish_drain(self, victim: ms.Replica, target: int) -> None:
        """Wait for the pinned DRAINING victim to quiesce, then retire it
        — journaling the quiesce proof, or the forced timeout verdict."""
        t0 = self._clock()
        deadline = t0 + self.policy.drain_timeout_s
        drained = False
        try:
            while True:
                inject.fire("fleet.scale", tag="drain",
                            replica=victim.replica_id)
                if victim.inflight == 0 and victim.queue_depth == 0:
                    drained = True
                    break
                if self._clock() >= deadline:
                    break
                self._sleep(min(0.05, self.policy.interval_s))
        except Exception as exc:  # noqa: BLE001 — a faulting drain path
            # still ends in a journaled forced retirement, never a
            # replica pinned DRAINING forever.
            logger.warning("Autoscaler: drain wait for %s failed: %s",
                           victim.replica_id, exc)
        waited_s = round(self._clock() - t0, 3)
        n_live = len(self.membership.dispatchable())
        if drained:
            self._emit("drained", "quiesced", target, n_live,
                       replica=victim.replica_id, inflight=0,
                       queue_depth=0, waited_s=waited_s)
            logger.info("Autoscaler: %s drained in %.2fs — retiring",
                        victim.replica_id, waited_s)
        else:
            self.n_forced += 1
            self._emit("forced", "drain_timeout", target, n_live,
                       replica=victim.replica_id,
                       inflight=victim.inflight,
                       queue_depth=victim.queue_depth, waited_s=waited_s)
            self._journal.metrics.inc("fleet_forced_retires")
            logger.warning("Autoscaler: %s did not quiesce in %.1fs — "
                           "forced retirement", victim.replica_id,
                           waited_s)
        self.scaler.retire(victim)

    def _finish_adopted_drains(self) -> None:
        if not self._adopted_drains:
            return
        drains, self._adopted_drains = self._adopted_drains, []
        for victim in drains:
            target = len(self._roster())
            logger.warning("Autoscaler: resuming adopted drain of %s",
                           victim.replica_id)
            self._finish_drain(victim, target)

    def _reap_stillborn(self) -> None:
        now = self._clock()
        for rid, t0 in list(self._pending_joins.items()):
            try:
                replica = self.membership.by_id(rid)
            except KeyError:
                self._pending_joins.pop(rid, None)
                continue
            if replica.state != ms.JOINING:
                self._pending_joins.pop(rid, None)  # made it (or crashed
                continue                            # post-join: supervised)
            if now - t0 <= self.policy.join_timeout_s:
                continue
            self._pending_joins.pop(rid, None)
            roster = self._roster()
            self._emit("up_failed", "stillborn", len(roster) - 1,
                       len(self.membership.dispatchable()), replica=rid,
                       joining_s=round(now - t0, 1))
            self._journal.metrics.inc("fleet_scale_failures")
            logger.warning("Autoscaler: %s never went live in %.0fs — "
                           "reaping the stillborn replica", rid,
                           self.policy.join_timeout_s)
            self.scaler.retire(replica)

    # -- lifecycle ---------------------------------------------------------
    def snapshot(self) -> dict:
        return {"target": self.last_target,
                "actual": len(self._roster()),
                "live": len(self.membership.dispatchable()),
                "capacity_rps": round(self._capacity_rps, 3),
                "ups": self.n_ups, "downs": self.n_downs,
                "forced": self.n_forced,
                "spawn_failures": self.n_spawn_failures}

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — the loop survives
                logger.warning("Autoscaler tick failed: %s", exc)
            self._stop.wait(self.policy.interval_s)

    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="fleet-autoscaler",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # Generous: a close mid-drain waits the drain out rather than
            # abandoning a pinned replica.
            self._thread.join(timeout=self.policy.drain_timeout_s + 10.0)
            self._thread = None


def _replica_index(replica: ms.Replica) -> int:
    """Numeric suffix of an ``r<i>`` id (victim tie-break); -1 for
    foreign naming schemes."""
    rid = replica.replica_id
    if rid.startswith("r") and rid[1:].isdigit():
        return int(rid[1:])
    return -1
