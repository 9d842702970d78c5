"""The port's HA front pair and rolling cell upgrades against the JAX
package's, on the CPU.

- Twin runs over both packages' ``serve/cells/ha.py``: the fencing lease
  (a token bumped on every acquisition and never on a renew, a fresh
  lease blocking another owner, an expired one taken with the next token,
  a lost lease detected on renew, a torn lease read as none, release of
  one's own lease only); the affinity WAL (replay equal to the writer's
  fold, size rotation compacting exactly, a torn tail skipped and sealed,
  a reopened writer seeding its fold, the fingerprint); a standby that
  tails the WAL and then promotes with the exact table, ``affinity_replay``
  journaled before ``front_lease(takeover)``; an armed ``front.lease``
  driving the active to ``fenced`` (its routes answer 503 with the leader
  hint, and the standby cannot acquire); a rolling upgrade over scripted
  cells that converges, and one rolled back below the shadow floor.
- ``obs.agg`` and ``event_summary`` fold the HA events of a cells run tree
  as the JAX package's do.
"""

import json
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
from torch_port_cases import (
    VOLATILE_FIELDS,
    FakeCell,
    cells_packages,
    journal_sequence,
    journal_views,
)

PKGS = cells_packages()
HA_EVENTS = ("front_lease", "affinity_replay", "cell_upgrade",
             "session_migrate", "fleet_shadow")
HA_VOLATILE = VOLATILE_FIELDS | {"cells", "spool", "reason"}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")


class _ThreeValueDispatch:
    """The JAX upgrader's shadow compare unpacks three values from the
    router's ``dispatch_to``, which answers two (status, body): the
    ValueError is caught per body, so its shadow gate never runs.  The
    port reads the two values.  A twin run of the gate gives the JAX
    reference a ``dispatch_to`` with a third value, so that both run the
    gate as designed; ``test_the_jax_upgrader_skips_its_shadow_gate``
    pins the defect."""

    def __init__(self, monkeypatch):
        router = PKGS["jax"].router.FleetRouter
        real = router.dispatch_to

        def three(self, replica, body, content_type="application/json",
                  timeout_s=None):
            status, data = real(self, replica, body, content_type,
                                timeout_s)
            return status, data, replica.replica_id

        monkeypatch.setattr(router, "dispatch_to", three)


def twin(scenario, tmp_path, kinds=HA_EVENTS):
    """Run ``scenario(pkg, journal, root)`` under both packages; the
    port's decisions and journal must equal the JAX package's."""
    out = {}
    for key, pkg in PKGS.items():
        root = tmp_path / key
        with pkg.journal.run(root / "obs", config={}) as jr:
            decisions = scenario(pkg, jr, root)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        out[key] = (decisions, journal_sequence(events, kinds,
                                                volatile=HA_VOLATILE))
    assert out["port"][0] == out["jax"][0]
    views = {k: journal_views(v[1], member_keys=("cell",))
             for k, v in out.items()}
    assert views["port"] == views["jax"]
    return out["port"]


def _wait(predicate, timeout_s=10.0, poll_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(poll_s)
    return predicate()


# -- the fencing lease ----------------------------------------------------------

def lease_tokens_and_owners(pkg, jr, root):
    lease = root / "lease.json"
    a = pkg.ha.FencingLease(lease, owner="f0", ttl_s=5.0)
    b = pkg.ha.FencingLease(lease, owner="f1", ttl_s=5.0)
    out = [a.try_acquire(), a.token, a.try_acquire(), a.token,
           b.try_acquire(), b.token]
    b.release()                 # not b's: a no-op
    out.append(a.read()["owner"])
    a.release()
    out.append(a.read())
    return out


def lease_expiry_takeover_and_loss(pkg, jr, root):
    lease = root / "lease.json"
    a = pkg.ha.FencingLease(lease, owner="f0", ttl_s=0.05)
    b = pkg.ha.FencingLease(lease, owner="f1", ttl_s=0.05)
    out = [a.try_acquire(), a.renew(), a.token]
    time.sleep(0.1)
    out += [b.try_acquire(), b.token, a.renew()]
    return out


def torn_lease_reads_as_none(pkg, jr, root):
    path = root / "lease.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text('{"owner": "f0", "tok')
    lease = pkg.ha.FencingLease(path, owner="f1", ttl_s=5.0)
    return [lease.read(), lease.expired(), lease.try_acquire(), lease.token]


# -- the affinity WAL -----------------------------------------------------------

def _mutate(wal, n=0):
    wal.append("assign", "s1", "c0")
    wal.append("assign", "s2", "c1")
    wal.append("flip", "s2", "c0", resync=True)
    wal.append("assign", "s3", "c1")
    wal.append("drop", "s3")
    for i in range(n):
        wal.append("assign", f"bulk{i:04d}", f"c{i % 3}")


def _replayed(pkg, path):
    affinity, resync, n = pkg.ha.AffinityWAL(path).replay()
    return affinity, sorted(resync), n


def wal_replay_equals_the_writer(pkg, jr, root):
    wal = pkg.ha.AffinityWAL(root / "affinity.wal")
    fp0 = wal.fingerprint()
    _mutate(wal)
    fp1 = wal.fingerprint()
    wal.close()
    return _replayed(pkg, root / "affinity.wal"), fp0 != fp1, len(fp1)


def wal_rotation_compacts_exactly(pkg, jr, root):
    path = root / "affinity.wal"
    wal = pkg.ha.AffinityWAL(path, max_bytes=2048)
    _mutate(wal, n=200)
    writer = (dict(wal._state), sorted(wal._resync))
    wal.close()
    first = json.loads(path.read_text().splitlines()[0])
    affinity, resync, _ = _replayed(pkg, path)
    return (writer == (affinity, resync), first["op"],
            [p.name for p in wal.chain()], len(affinity))


def wal_torn_tail_skipped_and_sealed(pkg, jr, root):
    path = root / "affinity.wal"
    wal = pkg.ha.AffinityWAL(path)
    wal.append("assign", "s1", "c0")
    wal.append("assign", "s2", "c1")
    wal.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"op":"assign","session":"s3","ce')
    out = [_replayed(pkg, path)]
    successor = pkg.ha.AffinityWAL(path)
    successor.append("assign", "s4", "c0")
    successor.close()
    out.append(_replayed(pkg, path))
    return out


def wal_reopened_writer_seeds_its_fold(pkg, jr, root):
    path = root / "affinity.wal"
    wal = pkg.ha.AffinityWAL(path)
    _mutate(wal)
    wal.close()
    reopened = pkg.ha.AffinityWAL(path, max_bytes=1)
    reopened.append("assign", "s9", "c2")   # rotates
    reopened.close()
    return _replayed(pkg, path)


# -- the active/standby pair ------------------------------------------------------

def _placeholder_front(pkg, jr):
    # The membership poller never runs (the front is not started), so an
    # unreachable placeholder cell is inert.
    return pkg.front.CellFront([pkg.cms.CellMember(
        "c0", "http://127.0.0.1:1", journal=jr)], port=0, poll_s=60.0,
        journal=jr)


def standby_tails_then_promotes(pkg, jr, root):
    ha_dir = root / "ha"
    f1 = _placeholder_front(pkg, jr)
    ha1 = pkg.ha.HAController(f1, ha_dir, owner="f1", url="http://f1",
                              ttl_s=0.5, poll_s=0.05, journal=jr).start()
    out = [ha1.role, ha1.leader_hint()]
    try:
        with f1._table_lock:
            f1._affinity["s1"] = "c0"
            f1._wal_append("assign", "s1", "c0")
            f1._affinity["s2"] = "c1"
            f1._wal_append("assign", "s2", "c1")
            f1._affinity["s2"] = "c0"
            f1._needs_resync.add("s2")
            f1._wal_append("flip", "s2", "c0", resync=True)
        f2 = _placeholder_front(pkg, jr)
        ha2 = pkg.ha.HAController(f2, ha_dir, owner="f2", url="http://f2",
                                  ttl_s=0.5, poll_s=0.05,
                                  journal=jr).start()
        try:
            out.append(ha2.role)
            out.append(_wait(lambda: f2._affinity == {"s1": "c0",
                                                      "s2": "c0"}))
            out.append(sorted(f2._needs_resync))
            f2._wal_append("assign", "sX", "c9")     # never echoed
            out.append(ha2.wal.appended)
            ha1.close(release=False)                 # a crash
            out.append((ha1.lease.expired(), ha2.role))
            out.append(_wait(lambda: ha2.role == "active"))
            out.append((f2._affinity, sorted(f2._needs_resync),
                        ha2.lease.token - ha1.lease.token, f2.is_leader))
        finally:
            ha2.close()
    finally:
        ha1.close(release=False)
    return out


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "{}")


def _post(url, data=b"{}"):
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "{}")


def armed_lease_fences_the_active(pkg, jr, root):
    ha_dir = root / "ha"
    fake = FakeCell()
    front = pkg.front.CellFront([pkg.cms.CellMember("c0", fake.url,
                                                    journal=jr)],
                                port=0, poll_s=60.0, journal=jr)
    front.membership.poll_once()
    front.start()
    ha = pkg.ha.HAController(front, ha_dir, owner="f0", ttl_s=0.3,
                             poll_s=0.05, journal=jr).start()
    try:
        out = [ha.role, _post(front.url + "/predict")[0]]
        plan = pkg.inject.parse_plan("front.lease:times=0")
        with pkg.inject.scoped(*plan):
            out.append(_wait(lambda: ha.role == "fenced"))
            status, body = _post(front.url + "/predict")
            out.append((status, body.get("role"),
                        body.get("leader") == front.url))
            status, health = _get(front.url + "/healthz")
            out.append((status, health["role"]))
            # Left armed, the peer cannot acquire the expired lease.
            time.sleep(0.4)
            peer = pkg.ha.FencingLease(ha_dir / "lease.json", owner="f1",
                                       ttl_s=0.3)
            out.append(peer.try_acquire())
        return out
    finally:
        ha.close(release=False)
        front.stop()
        fake.stop()


# -- rolling upgrades ---------------------------------------------------------------

class FakeSupervisor:
    """``retire_child`` stops a scripted cell and ``add_child`` starts a
    new one on the same port from the spec the upgrader built: digest and
    predictions follow the checkpoint (``bad.npz`` disagrees)."""

    def __init__(self, fakes: dict):
        self.fakes = fakes
        self.calls: list = []

    def retire_child(self, name):
        self.calls.append(("retire", name))
        self.fakes[name].stop()

    def add_child(self, spec):
        name, checkpoint = spec
        self.calls.append(("add", name, checkpoint))
        port = self.fakes[name].port
        cell = FakeCell(port=port, digest=f"d-{checkpoint}")
        if checkpoint == "bad.npz":
            cell.predictions = [3, 3, 3]
        self.fakes[name] = cell


def _upgrade(pkg, jr, checkpoint):
    fakes = {"c0": FakeCell(digest="d-old.npz"),
             "c1": FakeCell(digest="d-old.npz")}
    sup = FakeSupervisor(fakes)
    front = pkg.front.CellFront(
        [pkg.cms.CellMember(cid, f.url, journal=jr)
         for cid, f in fakes.items()], port=0, poll_s=0.05, journal=jr)
    front.membership.poll_once()
    front.start()
    try:
        _post(front.url + "/session/open", json.dumps(
            {"session": "s1"}).encode())
        for _ in range(4):
            _post(front.url + "/predict", json.dumps(
                {"trials": []}).encode())
        front.upgrader = pkg.ha.RollingUpgrade(
            front, sup, lambda cid, ckpt, args: (cid, ckpt), journal=jr,
            live_timeout_s=10.0, poll_s=0.05)
        for cid in fakes:
            front.upgrader.set_current(cid, "old.npz", [])
        status, result = _post(front.url + "/cells/upgrade", json.dumps(
            {"checkpoint": checkpoint}).encode())
        _wait(lambda: all(c.state == "live" for c in front.cells))
        return (status, result, sup.calls,
                sorted((c.cell_id, c.state, c.digest) for c in front.cells),
                front.cell_of("s1") is not None)
    finally:
        front.stop()
        for f in fakes.values():
            f.stop()


def upgrade_converges(pkg, jr, root):
    return _upgrade(pkg, jr, "new.npz")


def upgrade_rolled_back_below_the_floor(pkg, jr, root):
    return _upgrade(pkg, jr, "bad.npz")


SCENARIOS = {
    "lease_tokens_and_owners": lease_tokens_and_owners,
    "lease_expiry_takeover_and_loss": lease_expiry_takeover_and_loss,
    "torn_lease_reads_as_none": torn_lease_reads_as_none,
    "wal_replay_equals_the_writer": wal_replay_equals_the_writer,
    "wal_rotation_compacts_exactly": wal_rotation_compacts_exactly,
    "wal_torn_tail_skipped_and_sealed": wal_torn_tail_skipped_and_sealed,
    "wal_reopened_writer_seeds_its_fold": wal_reopened_writer_seeds_its_fold,
    "standby_tails_then_promotes": standby_tails_then_promotes,
    "armed_lease_fences_the_active": armed_lease_fences_the_active,
    "upgrade_converges": upgrade_converges,
    "upgrade_rolled_back_below_the_floor":
        upgrade_rolled_back_below_the_floor,
}

EXPECTED = {
    "lease_tokens_and_owners": [True, 1, True, 2, False, 0, "f0", None],
    "lease_expiry_takeover_and_loss": [True, "ok", 1, True, 2, "lost"],
    "torn_lease_reads_as_none": [None, True, True, 1],
    "wal_replay_equals_the_writer": (({"s1": "c0", "s2": "c0"}, ["s2"], 5),
                                     True, 1),
    "wal_torn_tail_skipped_and_sealed": [
        ({"s1": "c0", "s2": "c1"}, [], 2),
        ({"s1": "c0", "s2": "c1", "s4": "c0"}, [], 3)],
    "wal_reopened_writer_seeds_its_fold": (
        {"s1": "c0", "s2": "c0", "s9": "c2"}, ["s2"], 9),
    "standby_tails_then_promotes": [
        "active", "http://f1", "standby", True, ["s2"], 0,
        (False, "standby"), True,
        ({"s1": "c0", "s2": "c0"}, ["s2"], 1, True)],
    "armed_lease_fences_the_active": [
        "active", 200, True, (503, "fenced", True), (200, "fenced"),
        False],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_decides_as_jax(name, tmp_path, monkeypatch):
    if name.startswith("upgrade"):
        _ThreeValueDispatch(monkeypatch)
    decisions, journal = twin(SCENARIOS[name], tmp_path)
    if name in EXPECTED:
        assert decisions == EXPECTED[name]
    kinds = [(e[0], dict(e[2]).get("action")) for e in journal]
    if name == "wal_rotation_compacts_exactly":
        exact, first, chain, n = decisions
        assert exact and first == "snapshot" and n == 202
        assert chain[-2:] == ["affinity.wal.1", "affinity.wal"]
    if name == "standby_tails_then_promotes":
        assert ("front_lease", "'acquire'") in kinds
        assert ("front_lease", "'standby'") in kinds
        assert kinds.index(("affinity_replay", None)) \
            < kinds.index(("front_lease", "'takeover'"))
        replay = dict(next(e for e in journal
                           if e[0] == "affinity_replay")[2])
        assert (replay["n_sessions"], replay["n_resync"]) == ("2", "1")
    if name == "armed_lease_fences_the_active":
        assert kinds == [("front_lease", "'acquire'"),
                         ("front_lease", "'fenced'")]
    if name in ("upgrade_converges", "upgrade_rolled_back_below_the_floor"):
        status, result, calls, cells, session_kept = decisions
        assert status == 200 and session_kept
        steps = [(dict(e[2])["cell"], dict(e[2])["action"])
                 for e in journal if e[0] == "cell_upgrade"]
        if name == "upgrade_converges":
            assert result["status"] == "ok"
            assert result["upgraded"] == ["c0", "c1"]
            assert steps == [(c, f"'{a}'") for c in ("'c0'", "'c1'")
                             for a in ("drain", "relaunch", "live",
                                       "shadow", "undrain")]
            assert cells == [("c0", "live", "d-new.npz"),
                             ("c1", "live", "d-new.npz")]
        else:
            assert result["status"] == "rolled_back"
            assert result["failed_cell"] == "c0"
            assert steps == [("'c0'", f"'{a}'") for a in (
                "drain", "relaunch", "live", "shadow", "rollback")]
            assert cells == [("c0", "live", "d-old.npz"),
                             ("c1", "live", "d-old.npz")]
            assert calls[-1] == ("add", "c0", "old.npz")


def test_the_jax_upgrader_skips_its_shadow_gate(tmp_path):
    """The defect the port does not copy: unpatched, the JAX upgrader's
    shadow compare fails on every body, so a checkpoint that disagrees
    with every answer converges there and is rolled back by the port."""
    got = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            got[key] = _upgrade(pkg, jr, "bad.npz")[1]["status"]
    assert got == {"jax": "ok", "port": "rolled_back"}


# -- the observability fold ------------------------------------------------------------

_T0 = 1700000000.0
_RUN_START = {"event": "run_start", "schema_version": 1, "git_sha": "0" * 8,
              "platform": "cpu", "device_kind": "cpu", "n_devices": 1,
              "config": {}}


def _write_run(run_dir, events):
    run_dir.mkdir(parents=True)
    lines = [json.dumps({"t": _T0 + i, "run_id": run_dir.name, **ev})
             for i, ev in enumerate(events)]
    (run_dir / "events.jsonl").write_text("\n".join(lines) + "\n")


def _populate(root: Path):
    # The front's journal at depth 1; a cell's replica journal at the
    # cells run's depth three (c0_obs/<cell run>/replica_obs/<run>).
    _write_run(root / "f1_obs" / "run_front", [
        _RUN_START | {"run_id": "run_front"},
        {"event": "front_lease", "action": "standby", "owner": "f1",
         "token": 1},
        {"event": "affinity_replay", "n_records": 3, "n_sessions": 2,
         "n_resync": 1},
        {"event": "front_lease", "action": "takeover", "owner": "f1",
         "token": 2},
        {"event": "spool_mirror", "action": "restored", "session": "s1",
         "cell": "c0"},
        {"event": "session_failover", "session": "s9", "from_cell": "c0",
         "to_cell": "c1", "action": "spool_error"},
    ])
    _write_run(root / "c0_obs" / "run_cell" / "replica_obs"
               / "run_replica", [
        _RUN_START | {"run_id": "run_replica"},
        {"event": "cell_upgrade", "cell": "c0", "action": "drain"},
        {"event": "cell_upgrade", "cell": "c0", "action": "undrain"},
        {"event": "cell_upgrade", "cell": "c1", "action": "drain"},
        {"event": "cell_upgrade", "cell": "c1", "action": "rollback",
         "recovered": 1, "digest": "abc"},
    ])


def test_agg_and_event_summary_fold_the_ha_events_as_jax(tmp_path):
    _populate(tmp_path)
    snaps, summaries = {}, {}
    for key, pkg in PKGS.items():
        snap = pkg.agg.Aggregator([tmp_path]).poll()
        snaps[key] = {r["run_id"]: {k: r.get(k) for k in (
            "lease", "mirror_restores", "upgrade")} for r in snap["runs"]}
        events = []
        for path in sorted(tmp_path.rglob("events.jsonl")):
            events.extend(pkg.schema.read_events(path, complete=False))
        summaries[key] = pkg.schema.event_summary(events)
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["run_front"]["lease"] == {
        "owner": "f1", "token": 2, "role": "active", "takeovers": 1,
        "fenced": 0, "replays": 1}
    assert snaps["port"]["run_replica"]["upgrade"] == {
        "done": 1, "rollbacks": 1, "draining": None}
    keys = ("lease_takeovers", "front_fenced", "affinity_replays",
            "cells_upgraded", "upgrade_rollbacks", "mirror_restores",
            "spool_errors")
    assert {k: summaries["port"][k] for k in keys} \
        == {k: summaries["jax"][k] for k in keys} \
        == {"lease_takeovers": 1, "front_fenced": 0, "affinity_replays": 1,
            "cells_upgraded": 1, "upgrade_rollbacks": 1,
            "mirror_restores": 1, "spool_errors": 1}
