"""The port's gray-failure defenses against the JAX package's, on the CPU.

- ``OutlierEjector`` twin runs on a fake clock (``clock=``), latencies fed
  directly as ``tests/test_gray.py`` feeds them: ejection at ``k`` times
  the fleet median, the median resisting the outlier, the ``floor_ms``
  noise floor, the ``max_eject_fraction`` cap, the cooldown, probe and
  readmission cycle, a slow probe restarting the cooldown, a
  pre-ejection straggler that cannot short-circuit readmission, and
  ``event_summary``'s gray fields.  Same decisions, same
  ``replica_ejected``/``replica_readmitted``/``fleet_member`` journal.
- Ejection drains: a request in flight on an ejected replica completes.
- ``HedgePolicy`` through ``FleetRouter`` over scripted replicas: a slow
  primary hedged to a sibling whose answer wins, a fast primary never
  hedged, the hard budget capping hedges, no hedge below
  ``min_samples``, and the policy's validation.  Same decisions and the
  same ``hedge`` events (the primary's delay is ten times the hedge delay,
  so no decision rests on a close race).
- ``replica.network``: the ``truncate`` action and its ``if_tag``, and a
  port server armed with it, behind the router beside a sibling: the cut
  reply is a transport failure, journaled ``fleet_retry``, and the request
  is answered by the sibling.
"""

import json
import threading
import time

import pytest
from torch_port_cases import (
    FakeClock,
    FakeReplica,
    fleet_packages,
    jax_variables,
    journal_sequence,
    journal_views,
    trials,
)

PKGS = fleet_packages()
GRAY_EVENTS = ("replica_ejected", "replica_readmitted", "fleet_member",
               "hedge", "fleet_retry")


def twin(scenario, tmp_path, kinds=GRAY_EVENTS):
    out = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            decisions = scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        out[key] = (decisions, journal_views(journal_sequence(events,
                                                              kinds)),
                    pkg.schema.event_summary(events))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    return out["port"]


def _member_fleet(pkg, n, jr, **kw):
    replicas = [pkg.ms.Replica(f"r{i}", f"http://127.0.0.1:{9000 + i}",
                               journal=jr) for i in range(n)]
    membership = pkg.ms.FleetMembership(replicas, journal=jr)
    for r in replicas:
        r.state = pkg.ms.LIVE
    kw.setdefault("k", 3.0)
    kw.setdefault("min_samples", 4)
    kw.setdefault("floor_ms", 1.0)
    kw.setdefault("check_interval_s", 0.0)
    return replicas, pkg.outlier.OutlierEjector(membership, journal=jr,
                                                **kw)


def _feed(ejector, replica, latencies):
    for lat in latencies:
        ejector.observe(replica, lat)


def _slow_middle(ejector, replicas, slow=100.0):
    _feed(ejector, replicas[0], [10.0] * 8)
    _feed(ejector, replicas[2], [12.0] * 8)
    _feed(ejector, replicas[1], [slow] * 8)


def _states(replicas):
    return [r.state for r in replicas]


def ejected_at_k_times_the_median(pkg, jr):
    replicas, ej = _member_fleet(pkg, 3, jr)
    _slow_middle(ej, replicas)
    return (_states(replicas), ej.n_ejected,
            [r.replica_id for r in ej.membership.dispatchable()],
            ej.snapshot())


def under_k_stays_live(pkg, jr):
    replicas, ej = _member_fleet(pkg, 3, jr)
    _slow_middle(ej, replicas, slow=25.0)
    return _states(replicas), ej.n_ejected


def floor_suppresses_noise(pkg, jr):
    replicas, ej = _member_fleet(pkg, 2, jr, floor_ms=5.0)
    _feed(ej, replicas[0], [0.5] * 8)
    _feed(ej, replicas[1], [4.0] * 8)
    return _states(replicas)


def eject_fraction_cap(pkg, jr):
    replicas, ej = _member_fleet(pkg, 4, jr, max_eject_fraction=0.25)
    _feed(ej, replicas[0], [10.0] * 8)
    _feed(ej, replicas[3], [10.0] * 8)
    _feed(ej, replicas[1], [200.0] * 8)
    _feed(ej, replicas[2], [300.0] * 8)
    return _states(replicas), ej.n_ejected


def cooldown_probe_readmit(pkg, jr):
    clock = FakeClock()
    replicas, ej = _member_fleet(pkg, 3, jr, cooldown_s=5.0, clock=clock)
    _slow_middle(ej, replicas)
    out = [_states(replicas), ej.claim_probe(set())]
    clock.t += 5.1
    probe = ej.claim_probe(set())
    out += [probe.replica_id, ej.claim_probe(set())]
    ej.observe(replicas[1], 12.0)
    out += [_states(replicas), ej.n_readmitted]
    return out


def slow_probe_restarts_the_cooldown(pkg, jr):
    clock = FakeClock()
    replicas, ej = _member_fleet(pkg, 3, jr, cooldown_s=5.0, clock=clock)
    _slow_middle(ej, replicas)
    clock.t += 5.1
    out = [ej.claim_probe(set()).replica_id]
    ej.observe(replicas[1], 90.0)
    out += [_states(replicas), ej.claim_probe(set())]
    clock.t += 5.1
    out.append(ej.claim_probe(set()).replica_id)
    ej.observe(replicas[1], 11.0)
    out.append(_states(replicas))
    return out


def straggler_cannot_readmit(pkg, jr):
    clock = FakeClock()
    replicas, ej = _member_fleet(pkg, 3, jr, cooldown_s=5.0, clock=clock)
    _slow_middle(ej, replicas)
    out = []
    ej.observe(replicas[1], 2.0)
    out.append(replicas[1].state)
    clock.t += 5.1
    ej.observe(replicas[1], 2.0)
    out.append(replicas[1].state)
    ej.observe(replicas[1], 400.0)
    out.append(ej.claim_probe(set()).replica_id)
    ej.observe(replicas[1], 9.0)
    out += [replicas[1].state, ej.n_readmitted]
    return out


def forget_and_cancel(pkg, jr):
    clock = FakeClock()
    replicas, ej = _member_fleet(pkg, 3, jr, cooldown_s=1.0, clock=clock)
    _slow_middle(ej, replicas)
    clock.t += 1.5
    probe = ej.claim_probe(set())
    ej.cancel_probe(probe)
    again = ej.claim_probe(set())
    ej.forget(replicas[1])
    return (probe.replica_id, again.replica_id, ej.snapshot(),
            _states(replicas))


OUTLIER_SCENARIOS = {
    "ejected_at_k_times_the_median": ejected_at_k_times_the_median,
    "under_k_stays_live": under_k_stays_live,
    "floor_suppresses_noise": floor_suppresses_noise,
    "eject_fraction_cap": eject_fraction_cap,
    "cooldown_probe_readmit": cooldown_probe_readmit,
    "slow_probe_restarts_the_cooldown": slow_probe_restarts_the_cooldown,
    "straggler_cannot_readmit": straggler_cannot_readmit,
    "forget_and_cancel": forget_and_cancel,
}

EXPECTED = {
    "under_k_stays_live": (["live"] * 3, 0),
    "floor_suppresses_noise": ["live", "live"],
    "eject_fraction_cap": (["live", "degraded", "live", "live"], 1),
    "cooldown_probe_readmit": [["live", "degraded", "live"], None, "r1",
                               None, ["live"] * 3, 1],
    "slow_probe_restarts_the_cooldown": [
        "r1", ["live", "degraded", "live"], None, "r1", ["live"] * 3],
    "straggler_cannot_readmit": ["degraded", "degraded", "r1", "live", 1],
}


@pytest.mark.parametrize("name", sorted(OUTLIER_SCENARIOS))
def test_the_ejector_decides_as_jax(name, tmp_path):
    decisions, _, summary = twin(OUTLIER_SCENARIOS[name], tmp_path)
    if name in EXPECTED:
        assert decisions == EXPECTED[name]
    if name == "ejected_at_k_times_the_median":
        assert decisions[:3] == (["live", "degraded", "live"], 1,
                                 ["r0", "r2"])
    if name == "cooldown_probe_readmit":
        assert summary["replica_ejections"] == 1
        assert summary["replica_readmissions"] == 1


def ejected_in_flight_request_completes(pkg, jr):
    slow, fast = FakeReplica(), FakeReplica()
    slow.predict_delay = 0.4
    try:
        replicas = [pkg.ms.Replica("r0", slow.url, journal=jr),
                    pkg.ms.Replica("r1", fast.url, journal=jr)]
        membership = pkg.ms.FleetMembership(replicas, journal=jr)
        router = pkg.router.FleetRouter(membership, journal=jr)
        fast.queue_depth = 50
        membership.poll_once()
        result = {}
        th = threading.Thread(
            target=lambda: result.setdefault("out", router.dispatch(b"{}")),
            daemon=True)
        th.start()
        deadline = time.monotonic() + 5.0
        while replicas[0].inflight != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        inflight = replicas[0].inflight
        moved = membership.set_state(replicas[0], pkg.ms.DEGRADED,
                                     "latency_outlier",
                                     only_from=(pkg.ms.LIVE,))
        th.join(timeout=10.0)
        return (inflight, moved, result["out"][::2], replicas[0].state,
                replicas[0].inflight)
    finally:
        slow.stop()
        fast.stop()


def test_an_ejection_drains_and_never_drops(tmp_path):
    decisions, _, _ = twin(ejected_in_flight_request_completes, tmp_path)
    assert decisions == (1, True, (200, "r0"), "degraded", 0)


# -- hedging ------------------------------------------------------------------

def _hedged(pkg, fakes, jr, **policy):
    replicas = [pkg.ms.Replica(f"r{i}", f.url, journal=jr)
                for i, f in enumerate(fakes)]
    membership = pkg.ms.FleetMembership(replicas, journal=jr)
    router = pkg.router.FleetRouter(
        membership, journal=jr, hedge=pkg.router.HedgePolicy(**policy))
    membership.poll_once()
    return membership, router


def _warm(router, n):
    for _ in range(n):
        assert router.dispatch(b"{}")[0] == 200
    return router.n_hedges, router.n_hedge_wins


def slow_primary_hedge_wins(pkg, jr):
    slow, fast = FakeReplica(), FakeReplica()
    try:
        membership, router = _hedged(pkg, [slow, fast], jr, quantile=0.9,
                                     budget_fraction=0.5, min_samples=8,
                                     min_delay_ms=50.0, max_delay_ms=50.0)
        before = _warm(router, 12)
        slow.predict_delay = 0.5
        slow.queue_depth, fast.queue_depth = 0, 10
        membership.poll_once()
        status, _, replica_id = router.dispatch(b"{}")
        router.close()
        return (status, replica_id, router.n_hedges - before[0],
                router.n_hedge_wins - before[1])
    finally:
        slow.stop()
        fast.stop()


def fast_primary_never_hedges(pkg, jr):
    a, b = FakeReplica(), FakeReplica()
    try:
        _, router = _hedged(pkg, [a, b], jr, budget_fraction=0.5,
                            min_samples=8, min_delay_ms=500.0,
                            max_delay_ms=800.0)
        _warm(router, 30)
        router.close()
        return router.n_hedges
    finally:
        a.stop()
        b.stop()


def budget_caps_hedges(pkg, jr):
    slow, fast = FakeReplica(), FakeReplica()
    try:
        membership, router = _hedged(pkg, [slow, fast], jr, quantile=0.9,
                                     budget_fraction=0.05, min_samples=8,
                                     min_delay_ms=30.0, max_delay_ms=30.0)
        before = _warm(router, 20)
        slow.predict_delay = 0.3
        slow.queue_depth, fast.queue_depth = 0, 10
        membership.poll_once()
        statuses = [router.dispatch(b"{}")[0] for _ in range(5)]
        router.close()
        return statuses, router.n_hedges - before[0], router.n_dispatched
    finally:
        slow.stop()
        fast.stop()


def cold_window_never_hedges(pkg, jr):
    slow, fast = FakeReplica(), FakeReplica()
    slow.predict_delay = 0.2
    fast.queue_depth = 10
    try:
        _, router = _hedged(pkg, [slow, fast], jr, budget_fraction=0.5,
                            min_samples=50, max_delay_ms=10.0)
        status = router.dispatch(b"{}")[0]
        router.close()
        return status, router.n_hedges
    finally:
        slow.stop()
        fast.stop()


HEDGE_SCENARIOS = {
    "slow_primary_hedge_wins": (slow_primary_hedge_wins, (200, "r1", 1, 1)),
    "fast_primary_never_hedges": (fast_primary_never_hedges, 0),
    "budget_caps_hedges": (budget_caps_hedges, ([200] * 5, 1, 25)),
    "cold_window_never_hedges": (cold_window_never_hedges, (200, 0)),
}


@pytest.mark.parametrize("name", sorted(HEDGE_SCENARIOS))
def test_hedging_decides_as_jax(name, tmp_path):
    scenario, expected = HEDGE_SCENARIOS[name]
    out = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            decisions = scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        hedges = [(e["primary"], e["hedge"], e["winner"]) for e in events
                  if e["event"] == "hedge"]
        out[key] = (decisions, hedges[-1:] if expected else hedges)
    assert out["port"] == out["jax"]
    assert out["port"][0] == expected


@pytest.mark.parametrize("kw", [{"quantile": 1.0}, {"quantile": 0.0},
                                {"budget_fraction": 0.0},
                                {"budget_fraction": 0.6}])
def test_hedge_policy_refuses_what_jax_refuses(kw):
    for key in ("port", "jax"):
        with pytest.raises(ValueError):
            PKGS[key].router.HedgePolicy(**kw)
    assert PKGS["port"].router.HedgePolicy() == PKGS["port"].router \
        .HedgePolicy(**{f: getattr(PKGS["jax"].router.HedgePolicy(), f)
                        for f in ("quantile", "budget_fraction",
                                  "min_delay_ms", "max_delay_ms",
                                  "min_samples", "window")})


# -- replica.network ----------------------------------------------------------

def test_truncate_fires_as_jax():
    out = {}
    for key in ("port", "jax"):
        inject = PKGS[key].inject
        seen = []
        with inject.scoped(inject.FaultSpec(site="replica.network", times=0,
                                            every=2, if_tag="r1")):
            for tag in ("r0", "r1", "r1", "r1", "r1"):
                try:
                    inject.fire("replica.network", tag=tag)
                    seen.append("ok")
                except inject.ResponseTruncated:
                    seen.append("cut")
        out[key] = seen
        (spec,) = inject.parse_plan("replica.network:times=1:if_tag=r1")
        assert spec.action is None and inject._DEFAULTS[
            "replica.network"][0] == "truncate"
    assert out["port"] == out["jax"] == ["ok", "cut", "ok", "cut", "ok"]


C, T, F1, D = 4, 64, 4, 2
META = {"model": "eegnet", "n_channels": C, "n_times": T, "F1": F1, "D": D}


def test_a_truncated_reply_fails_over_to_the_sibling(tmp_path):
    from eegnetreplication_tpu_torch.resil import inject
    from eegnetreplication_tpu_torch.serve.service import ServeApp
    from eegnetreplication_tpu_torch.training.checkpoint import (
        from_jax_variables,
        save_checkpoint,
    )

    port = PKGS["port"]
    params, bs = jax_variables(C, T, F1, D, seed=51)
    ckpt = save_checkpoint(tmp_path / "m.npz", from_jax_variables(params, bs),
                           metadata=dict(META))
    body = json.dumps({"trials": trials(2, C, T, seed=52).tolist()}).encode()
    sibling = FakeReplica()
    with port.journal.run(tmp_path / "replica", config={}) as rj:
        app = ServeApp(ckpt, port=0, device="cpu", buckets=(1, 8),
                       chaos_tag="r0", journal=rj).start()
        try:
            with port.journal.run(tmp_path / "router", config={}) as jr:
                replicas = [port.ms.Replica("r0", app.url, journal=jr),
                            port.ms.Replica("r1", sibling.url, journal=jr)]
                membership = port.ms.FleetMembership(replicas, journal=jr)
                router = port.router.FleetRouter(membership, journal=jr)
                sibling.queue_depth = 10
                membership.poll_once()
                assert [r.state for r in replicas] == ["live", "live"]
                with inject.scoped(inject.FaultSpec(
                        site="replica.network", times=1, if_tag="r0")):
                    status, data, replica_id = router.dispatch(body)
                direct = router.dispatch(body)
        finally:
            app.stop()
            sibling.stop()
    assert (status, replica_id) == (200, "r1")
    assert json.loads(data)["predictions"] == sibling.predictions
    assert direct[0] == 200 and direct[2] == "r0"
    assert replicas[0].state == "live"         # a cut reply is not a death
    events = port.schema.read_events(jr.events_path)
    retries = [e for e in events if e["event"] == "fleet_retry"]
    assert [e["replica"] for e in retries] == ["r0"]
    assert retries[0]["reason"].startswith("IncompleteRead")
    served = port.schema.read_events(rj.events_path)
    fired = [e for e in served if e["event"] == "fault_injected"]
    assert [(e["site"], e["action"], e["tag"]) for e in fired] \
        == [("replica.network", "truncate", "r0")]
