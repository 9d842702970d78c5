"""The port's autoscaler against the JAX package's, on the CPU.

- Control-law twin runs (``tests/test_autoscale.py``'s scenarios): real
  ``FleetMembership`` state machines with no poller, a scripted scaler
  seam and a fake clock (``clock=``, ``sleep=``) drive both packages'
  ``Autoscaler.tick``: a scale-up on utilization with its cooldown and
  ceiling, a failed spawn journaled and retried at the cooldown, a
  drain-safe scale-down (``down``, then ``drained``, then the member's
  ``out``/``retired``, in journal order), an adopted drain timing out into
  a forced retirement, a stillborn join reaped, the anti-flap guard, the
  floor, and the ``fleet.scale`` chaos site failing a spawn.  Same
  decisions, same ``fleet_scale`` and ``fleet_member`` journal.
- Dynamic membership: ``add_replica`` joins through the health gate,
  ``remove_replica`` journals ``retired`` once, a pinned drain is exempt
  from the poller's verdicts but not from death.
- ``ReplicaScaler`` over a running ``MultiSupervisor`` (its ``popen=``
  seam starts a beating stand-in for each replica): a spawn claims the
  next index, adds a supervised child and a JOINING member; a retire
  journals the member's ``retired`` out before the child's ``retired``
  exit; indices are never reused.
"""

import subprocess
import sys
import threading
import time

import pytest
from torch_port_cases import (
    FakeClock,
    fleet_packages,
    journal_sequence,
    journal_views,
)

PKGS = fleet_packages()
DEAD_URL = "http://127.0.0.1:9/"
SCALE_EVENTS = ("fleet_scale", "fleet_member", "fault_injected")


def _replica(pkg, rid, jr, state=None):
    r = pkg.ms.Replica(rid, DEAD_URL, journal=jr)
    r.state = state or pkg.ms.LIVE
    return r


class ScriptedScaler:
    """The autoscaler's action seam without processes: spawn adds a
    JOINING member, retire removes it, both on the real membership."""

    def __init__(self, pkg, membership, jr, fail_spawns=0):
        self.pkg, self.membership, self.jr = pkg, membership, jr
        self.fail_spawns = fail_spawns
        self.next_i = len(membership.replicas)
        self.retired = []

    def spawn(self):
        if self.fail_spawns > 0:
            self.fail_spawns -= 1
            raise RuntimeError("spawn boom")
        replica = self.pkg.ms.Replica(f"r{self.next_i}", DEAD_URL,
                                      journal=self.jr)
        self.next_i += 1
        self.membership.add_replica(replica)
        return replica

    def retire(self, replica):
        self.membership.remove_replica(replica)
        self.retired.append(replica.replica_id)
        return True


def _autoscaler(pkg, jr, n, stats, clock, **policy):
    replicas = [_replica(pkg, f"r{i}", jr) for i in range(n)]
    membership = pkg.ms.FleetMembership(replicas, poll_s=60.0, journal=jr)
    scaler = ScriptedScaler(pkg, membership, jr)
    policy.setdefault("min_replicas", 1)
    policy.setdefault("max_replicas", 3)
    policy.setdefault("interval_s", 0.05)
    policy.setdefault("up_cooldown_s", 2.0)
    policy.setdefault("down_cooldown_s", 2.0)
    a = pkg.autoscaler.Autoscaler(
        membership, scaler, lambda: dict(stats),
        policy=pkg.autoscaler.AutoscalerPolicy(**policy), journal=jr,
        clock=clock, sleep=clock.sleep)
    return a, membership, scaler


def _ids(membership):
    return [r.replica_id for r in membership.replicas]


def up_with_cooldown_and_ceiling(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 100.0, "ok_rps": 10.0, "p95_ms": None}
    a, mem, _ = _autoscaler(pkg, jr, 1, stats, clock)
    out = []
    for t in (0.0, 0.0, 2.5, 5.0):
        clock.t = t
        a.tick()
        out.append((_ids(mem), a.n_ups))
    out.append(a.snapshot())
    mem.close()
    return out


def spawn_failure_retries_at_the_cooldown(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 100.0, "ok_rps": 10.0, "p95_ms": None}
    a, mem, scaler = _autoscaler(pkg, jr, 1, stats, clock, max_replicas=2)
    scaler.fail_spawns = 1
    out = []
    for t in (0.0, 0.0, 2.5):
        clock.t = t
        a.tick()
        out.append((_ids(mem), a.n_ups, a.n_spawn_failures))
    mem.close()
    return out


def chaos_site_fails_the_spawn(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 100.0, "ok_rps": 10.0, "p95_ms": None}
    a, mem, _ = _autoscaler(pkg, jr, 1, stats, clock, max_replicas=2)
    with pkg.journal.bound(jr), pkg.inject.scoped(pkg.inject.FaultSpec(
            site="fleet.scale", times=1, if_tag="spawn")):
        out = []
        for t in (0.0, 2.5):
            clock.t = t
            a.tick()
            out.append((_ids(mem), a.n_spawn_failures))
    mem.close()
    return out


def down_drains_in_order(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 2.0, "ok_rps": 40.0, "p95_ms": None}
    a, mem, scaler = _autoscaler(pkg, jr, 2, stats, clock)
    a.tick()
    out = [(_ids(mem), a.n_downs, a.n_forced, list(scaler.retired))]
    a.tick()
    out.append(a.n_downs)
    mem.close()
    return out


def adopted_drain_is_forced(pkg, jr):
    clock = FakeClock(0.0)
    replicas = [_replica(pkg, f"r{i}", jr) for i in range(2)]
    mem = pkg.ms.FleetMembership(replicas, poll_s=60.0, journal=jr)
    wedged = mem.by_id("r1")
    wedged.pinned, wedged.state = True, pkg.ms.DRAINING
    wedged.begin()
    scaler = ScriptedScaler(pkg, mem, jr)
    a = pkg.autoscaler.Autoscaler(
        mem, scaler, lambda: {"arrival_rps": 0.0, "ok_rps": 0.0,
                              "p95_ms": None},
        policy=pkg.autoscaler.AutoscalerPolicy(
            min_replicas=1, max_replicas=3, interval_s=0.05,
            drain_timeout_s=1.0),
        journal=jr, clock=clock, sleep=clock.sleep)
    a.tick()
    out = (a.n_forced, scaler.retired, clock.t >= 1.0,
           [r.pinned for r in mem.replicas])
    mem.close()
    return out


def stillborn_join_is_reaped(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 100.0, "ok_rps": 10.0, "p95_ms": None}
    a, mem, scaler = _autoscaler(pkg, jr, 1, stats, clock,
                                 join_timeout_s=5.0)
    a.tick()
    out = [_ids(mem)]
    stats.update(arrival_rps=0.0, ok_rps=0.0)
    clock.t = 10.0
    a.tick()
    out += [_ids(mem), scaler.retired]
    mem.close()
    return out


def anti_flap_guard(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 8.8, "ok_rps": 20.0, "p95_ms": None}
    a, mem, _ = _autoscaler(pkg, jr, 2, stats, clock, up_threshold=0.5,
                            down_threshold=0.45)
    a.tick()
    out = [(a.n_downs, len(mem.replicas))]
    stats["arrival_rps"] = 4.0
    a.tick()
    out.append((a.n_downs, len(mem.replicas)))
    mem.close()
    return out


def idle_fleet_keeps_its_floor(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 0.0, "ok_rps": 0.0, "p95_ms": None}
    a, mem, _ = _autoscaler(pkg, jr, 1, stats, clock)
    for _ in range(5):
        a.tick()
        clock.t += 5.0
    out = (a.n_downs, len(mem.replicas))
    mem.close()
    return out


def p95_signal_scales_a_busy_fleet(pkg, jr):
    clock = FakeClock(0.0)
    stats = {"arrival_rps": 1.0, "ok_rps": 10.0, "p95_ms": 900.0}
    a, mem, _ = _autoscaler(pkg, jr, 1, stats, clock, target_p95_ms=200.0)
    mem.replicas[0].queue_depth = 2
    a.tick()
    out = (_ids(mem), a.n_ups)
    mem.close()
    return out


SCENARIOS = {
    "up_with_cooldown_and_ceiling": (up_with_cooldown_and_ceiling, None),
    "spawn_failure_retries_at_the_cooldown": (
        spawn_failure_retries_at_the_cooldown,
        [(["r0"], 1, 1), (["r0"], 1, 1), (["r0", "r1"], 2, 1)]),
    "chaos_site_fails_the_spawn": (
        chaos_site_fails_the_spawn, [(["r0"], 1), (["r0", "r1"], 1)]),
    "down_drains_in_order": (down_drains_in_order,
                             [(["r0"], 1, 0, ["r1"]), 1]),
    "adopted_drain_is_forced": (adopted_drain_is_forced,
                                (1, ["r1"], True, [False])),
    "stillborn_join_is_reaped": (stillborn_join_is_reaped,
                                 [["r0", "r1"], ["r0"], ["r1"]]),
    "anti_flap_guard": (anti_flap_guard, [(0, 2), (1, 1)]),
    "idle_fleet_keeps_its_floor": (idle_fleet_keeps_its_floor, (0, 1)),
    "p95_signal_scales_a_busy_fleet": (p95_signal_scales_a_busy_fleet,
                                       (["r0", "r1"], 1)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_autoscaler_decides_as_jax(name, tmp_path):
    scenario, expected = SCENARIOS[name]
    out = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            decisions = scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        out[key] = (decisions, journal_sequence(events, SCALE_EVENTS),
                    {k: v for k, v in pkg.schema.event_summary(
                        events).items() if "scale" in k})
    assert out["port"] == out["jax"]
    decisions, sequence, _ = out["port"]
    if expected is not None:
        assert decisions == expected
    if name == "up_with_cooldown_and_ceiling":
        assert [d[1] for d in decisions[:4]] == [1, 1, 2, 2]
        assert decisions[3][0] == ["r0", "r1", "r2"]
    if name == "down_drains_in_order":
        kinds = [(item[0], dict(item[2]).get("action"),
                  dict(item[2]).get("reason")) for item in sequence]
        down = kinds.index(("fleet_scale", "'down'",
                            "utilization 0.05 < 0.4"))
        drained = kinds.index(("fleet_scale", "'drained'", "quiesced"))
        retired = kinds.index(("fleet_member", None, "retired"))
        assert down < drained < retired


def test_policy_validation_equals_jax():
    for kw in ({"min_replicas": 3, "max_replicas": 2},
               {"up_threshold": 0.3, "down_threshold": 0.4},
               {"interval_s": 0.0}, {"max_step": 0}):
        for key in ("port", "jax"):
            with pytest.raises(ValueError):
                PKGS[key].autoscaler.AutoscalerPolicy(**kw)
    import dataclasses

    assert dataclasses.asdict(PKGS["port"].autoscaler.AutoscalerPolicy()) \
        == dataclasses.asdict(PKGS["jax"].autoscaler.AutoscalerPolicy())


# -- dynamic membership -------------------------------------------------------

def dynamic_membership(pkg, jr):
    replicas = [_replica(pkg, f"r{i}", jr) for i in range(2)]
    mem = pkg.ms.FleetMembership(replicas, poll_s=60.0, journal=jr)
    fresh = pkg.ms.Replica("r2", DEAD_URL, journal=jr)
    mem.add_replica(fresh)
    out = [fresh.state, fresh in mem.dispatchable(), _ids(mem)]
    try:
        mem.add_replica(pkg.ms.Replica("r2", DEAD_URL, journal=jr))
    except ValueError:
        out.append("duplicate refused")
    r1 = mem.by_id("r1")
    mem.remove_replica(r1)
    mem.remove_replica(r1)
    out.append(_ids(mem))
    victim = mem.by_id("r0")
    victim.pinned, victim.state = True, pkg.ms.DRAINING
    victim.client.request = lambda *a, **k: (200, b"{}")
    mem.poll_once()
    out.append(victim.state)
    victim.pinned = False
    mem.poll_once()
    out.append(victim.state)
    victim.pinned, victim.state = True, pkg.ms.DRAINING
    del victim.client.request          # the URL is dead: a corpse
    mem.fail_threshold = 1
    mem.poll_once()
    out.append(victim.state)
    mem.close()
    return out


def test_dynamic_membership_as_jax(tmp_path):
    out = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            decisions = dynamic_membership(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        out[key] = (decisions, journal_views(journal_sequence(
            events, ("fleet_member",))))
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["joining", False, ["r0", "r1", "r2"],
                              "duplicate refused", ["r0", "r2"],
                              "draining", "live", "out"]


# -- ReplicaScaler over a running MultiSupervisor -----------------------------

STAND_IN = ("import signal, sys, time\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            "time.sleep(60)\n")


def scaler_over_a_supervisor(pkg, jr, work):
    fleet = pkg.fleet
    launched = []

    def popen(cmd, env):
        launched.append(cmd[cmd.index("-m") + 1].replace("_torch", ""))
        return subprocess.Popen([sys.executable, "-c", STAND_IN], env=env)

    sup, replicas = fleet.spawn_replica_fleet("m.npz", 1, run_dir=work,
                                              journal=jr)
    sup._popen = popen
    sup.policy.poll_s = 0.05
    mem = pkg.ms.FleetMembership(replicas, poll_s=60.0, journal=jr)
    scaler = fleet.ReplicaScaler(sup, mem, checkpoint="m.npz",
                                 run_dir=work, journal=jr)
    box = []
    th = threading.Thread(target=lambda: box.append(sup.run()), daemon=True)
    th.start()
    r1 = scaler.spawn()
    deadline = time.monotonic() + 20
    while (sup.children["r1"].state != "running"
           and time.monotonic() < deadline):
        time.sleep(0.02)
    out = [r1.replica_id, r1.state, sorted(sup.children)]
    out.append(scaler.retire(r1))
    scaler.set_checkpoint("n.npz")
    r2 = scaler.spawn()
    cmd = sup.children[r2.replica_id].spec.cmd
    out += [r2.replica_id, _ids(mem), cmd[cmd.index("--checkpoint") + 1]]
    sup.stop()
    th.join(timeout=30)
    out += [box, sorted(set(launched))]
    mem.close()
    return out


def test_replica_scaler_as_jax(tmp_path):
    out = {}
    for key, pkg in PKGS.items():
        work = tmp_path / key
        with pkg.journal.run(work / "obs", config={}) as jr:
            decisions = scaler_over_a_supervisor(pkg, jr, work)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        order = [(e["event"], e.get("replica") or e.get("child"),
                  e.get("reason") or e.get("classification"))
                 for e in events
                 if e["event"] in ("fleet_member", "supervisor_exit")
                 and (e.get("replica") or e.get("child")) == "r1"]
        out[key] = (decisions, order)
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["r1", "joining", ["r0", "r1"], True, "r2",
                              ["r0", "r2"], "n.npz", [0],
                              ["eegnetreplication_tpu.serve"]]
    assert out["port"][1] == [("fleet_member", "r1", "retired"),
                              ("supervisor_exit", "r1", "retired")]
