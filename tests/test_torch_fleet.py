"""The port's replica fleet against the JAX package's, on the CPU.

- Twin runs: each scenario drives one package's ``FleetMembership``,
  ``FleetRouter``, ``RollingReload`` and ``FleetApp`` over the same
  scripted replicas (``torch_port_cases.FakeReplica``) and returns its
  decisions; the port must return the JAX package's decisions and write
  the same journal (event names, key sets and every field that does not
  vary between runs, in order).  The scenarios are those of
  ``tests/test_fleet.py``: the membership state machine (join, drain on
  degraded, out on unreachable, rejoin, a stale heartbeat without
  flapping), least-loaded dispatch, failover off a dead replica, 429 and
  503, the per-replica breaker, the rolling reload (converged, a corrupt
  push, a shadow disagreement rolled back, an unverifiable digest), trace
  propagation and the retry span, the fleet endpoint's routes (session
  stickiness and import included), and the supervised launch commands.
- The fleet parser has the JAX parser's 31 flags, names and defaults (and
  the same AST count of ``add_argument``), refuses the same bad settings,
  and a host without CUDA stops it before a replica is spawned unless
  ``EEGTPU_PLATFORM=cpu``.
- One fleet CLI run on the CPU: ``python -m
  eegnetreplication_tpu_torch.serve.fleet --replicas 2`` over a checkpoint
  the JAX package wrote answers ``/predict`` with the JAX engine's
  predictions, rolls a second JAX checkpoint through ``/reload``, and
  drains on SIGTERM (exit 75) with a complete journal.
"""

import argparse
import ast
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from torch_port_cases import (
    FakeReplica,
    child_env,
    fleet_packages,
    jax_model,
    jax_variables,
    journal_sequence,
    journal_views,
    trials,
)

REPO = Path(__file__).resolve().parents[1]
PKGS = fleet_packages()
FLEET_EVENTS = ("fleet_start", "fleet_member", "fleet_retry",
                "fleet_canary", "fleet_shadow", "fleet_reload", "fleet_end",
                "circuit_state", "span", "request")


def twin(scenario, tmp_path, kinds=FLEET_EVENTS):
    """Run ``scenario(pkg, journal)`` under both packages; the port's
    decisions and journal sequence must equal the JAX package's."""
    out = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            decisions = scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        out[key] = (decisions, journal_sequence(events, kinds))
    assert out["port"][0] == out["jax"][0]
    assert journal_views(out["port"][1]) == journal_views(out["jax"][1])
    return out["port"]


def _fleet(pkg, fakes, jr, **membership_kw):
    replicas = [pkg.ms.Replica(f"r{i}", fake.url, journal=jr)
                for i, fake in enumerate(fakes)]
    membership = pkg.ms.FleetMembership(replicas, journal=jr,
                                        **membership_kw)
    return replicas, membership, pkg.router.FleetRouter(membership,
                                                        journal=jr)


def _stopping(*fakes):
    class _Ctx:
        def __enter__(self):
            return fakes

        def __exit__(self, *exc):
            for f in fakes:
                f.stop()
    return _Ctx()


# -- membership ---------------------------------------------------------------

def join_drain_recover(pkg, jr):
    with _stopping(FakeReplica()) as (fake,):
        (r,), membership, _ = _fleet(pkg, [fake], jr)
        states = [r.state]
        membership.poll_once()
        states.append((r.state, r.digest))
        fake.degraded = ["circuit_open"]
        membership.poll_once()
        states.append((r.state, len(membership.dispatchable())))
        fake.degraded = []
        membership.poll_once()
        states.append(r.state)
        return states


def snapshot_mirrors_the_replica(pkg, jr):
    with _stopping(FakeReplica()) as (fake,):
        fake.precision, fake.buckets = "int8", (1, 4, 8, 64)
        fake.slo_breached = ["p95_latency_ms<50"]
        fake.zoo = {"n_tenants": 3, "stacked": {"n": 3}}
        _, membership, _ = _fleet(pkg, [fake], jr)
        membership.poll_once()
        snaps = [membership.snapshot()]
        fake.buckets, fake.slo_breached, fake.zoo = (1, 4, 8, 128), [], None
        membership.poll_once()
        snaps.append(membership.snapshot())
        for snap in snaps:
            for row in snap:
                row.pop("url")
        return snaps


def unreachable_out_and_rejoin(pkg, jr):
    fake = FakeReplica()
    port = fake.port
    (r,), membership, _ = _fleet(pkg, [fake], jr, fail_threshold=2)
    membership.poll_once()
    states = [r.state]
    fake.stop()
    membership.poll_once()
    states.append(r.state)
    membership.poll_once()
    states.append(r.state)
    with _stopping(FakeReplica(port=port)):
        membership.poll_once()
        states.append(r.state)
    return states


def stale_heartbeat_drains_without_flapping(pkg, jr):
    hb_file = Path(jr.dir) / "hb.json"

    def beat(age_s):
        hb_file.write_text(json.dumps(
            {"phase": "serve_idle", "beat": 3, "t": time.time() - age_s,
             "pid": os.getpid()}))

    with _stopping(FakeReplica()) as (fake,):
        beat(0.0)
        replica = pkg.ms.Replica("r0", fake.url, heartbeat_file=hb_file,
                                 journal=jr)
        membership = pkg.ms.FleetMembership([replica], journal=jr)
        states = []
        for age in (0.0, 3600.0, 3600.0, 3600.0, 0.0):
            beat(age)
            membership.poll_once()
            states.append(replica.state)
        return states


# -- the router ---------------------------------------------------------------

def least_loaded_dispatch(pkg, jr):
    with _stopping(FakeReplica(), FakeReplica()) as (busy, idle):
        busy.queue_depth = 50
        _, membership, router = _fleet(pkg, [busy, idle], jr)
        membership.poll_once()
        picks = [router.dispatch(b"{}")[::2] for _ in range(5)]
        return picks, busy.predict_count(), idle.predict_count()


def dead_replica_fails_over(pkg, jr):
    with _stopping(FakeReplica()) as (healthy,):
        dying = FakeReplica()
        replicas, membership, router = _fleet(pkg, [dying, healthy], jr)
        membership.poll_once()
        healthy.queue_depth = 10
        membership.poll_once()
        dying.stop()
        picks = [router.dispatch(b"{}")[::2] for _ in range(6)]
        return picks, replicas[0].state, router.n_failovers


def busy_is_429_and_no_live_is_503(pkg, jr):
    with _stopping(FakeReplica()) as (fake,):
        replicas, membership, router = _fleet(pkg, [fake], jr)
        membership.poll_once()
        fake.predict_status = 429
        out = []
        for _ in range(2):
            try:
                router.dispatch(b"{}")
            except (pkg.router.AllReplicasBusy,
                    pkg.router.NoLiveReplicas) as exc:
                out.append(type(exc).__name__)
            membership.set_state(replicas[0], pkg.ms.OUT, "test")
        return out


def breaker_trips_on_5xx(pkg, jr):
    with _stopping(FakeReplica(), FakeReplica()) as (broken, healthy):
        replicas = [
            pkg.ms.Replica("r0", broken.url, journal=jr,
                           breaker=pkg.breaker.CircuitBreaker(
                               failure_threshold=3, site="fleet.r0",
                               journal=jr)),
            pkg.ms.Replica("r1", healthy.url, journal=jr)]
        membership = pkg.ms.FleetMembership(replicas, journal=jr)
        router = pkg.router.FleetRouter(membership, journal=jr)
        healthy.queue_depth = 10
        membership.poll_once()
        broken.predict_status = 500
        picks = [router.dispatch(b"{}")[::2] for _ in range(6)]
        return (picks, replicas[0].breaker.state, broken.predict_count(),
                router.n_failovers)


# -- the rolling reload -------------------------------------------------------

def _seeded_reload(pkg, jr, fakes, checkpoint, **kw):
    _, membership, router = _fleet(pkg, fakes, jr)
    membership.poll_once()
    for _ in range(4):
        assert router.dispatch(b"{}")[0] == 200
    result = pkg.canary.RollingReload(router, checkpoint,
                                      previous_checkpoint="old.npz",
                                      journal=jr, **kw).run()
    result.pop("wall_s", None)
    membership.poll_once()
    return (result, [f.digest for f in fakes],
            [f.reload_checkpoints() for f in fakes],
            len(membership.dispatchable()))


def reload_converges(pkg, jr):
    with _stopping(*[FakeReplica() for _ in range(3)]) as fakes:
        return _seeded_reload(pkg, jr, fakes, "new.npz", shadow_n=3)


def corrupt_push_changes_nothing(pkg, jr):
    with _stopping(*[FakeReplica() for _ in range(3)]) as fakes:
        for f in fakes:
            f.reload_fn = lambda ck: (400, "IntegrityError: sha mismatch")
        return _seeded_reload(pkg, jr, fakes, "corrupt.npz")


def shadow_disagreement_rolls_back(pkg, jr):
    with _stopping(*[FakeReplica() for _ in range(3)]) as fakes:
        def scripted(fake):
            def fn(ck):
                if ck == "new.npz":
                    fake.predictions = [3, 3, 3]
                    return 200, "d-new"
                fake.predictions = [0, 1, 2]
                return 200, "d-old"
            return fn

        for f in fakes:
            f.reload_fn = scripted(f)
        return _seeded_reload(pkg, jr, fakes, "new.npz", shadow_n=3,
                              agree_floor=0.9)


def unverifiable_digest_aborts(pkg, jr):
    with _stopping(FakeReplica(), FakeReplica()) as fakes:
        for f in fakes:
            f.healthz_digest = "d-old"
        return _seeded_reload(pkg, jr, list(fakes), "new.npz")


# -- tracing ------------------------------------------------------------------

def dispatch_and_retry_spans(pkg, jr):
    trace = pkg.trace
    with _stopping(FakeReplica()) as (healthy,):
        dying = FakeReplica()
        _, membership, router = _fleet(pkg, [dying, healthy], jr)
        healthy.queue_depth = 10
        membership.poll_once()
        router.dispatch(b"{}")                       # untraced
        untraced = "X-Trace-Id" in dying.headers_log[-1]
        dying.stop()
        ctx = trace.TraceContext(trace.new_trace_id(), sampled=True)
        with trace.use(ctx):
            status, _, replica_id = router.dispatch(b"{}")
        spans = [e for e in pkg.schema.read_events(jr.events_path,
                                                   complete=False)
                 if e["event"] == "span"]
        by_name = {s["name"]: s for s in spans}
        sent = healthy.headers_log[-1]
        tree = trace.build_traces(spans)[ctx.trace_id]
        return (untraced, status, replica_id,
                sent["X-Trace-Id"] == ctx.trace_id,
                sent["X-Parent-Span"] == by_name["router.retry"]["span_id"],
                by_name["router.retry"]["parent_span_id"]
                == by_name["router.dispatch"]["span_id"],
                [s["name"] for s in tree.roots],
                {k: [c["name"] for c in v] for k, v in tree.children.items()
                 if k == by_name["router.dispatch"]["span_id"]}
                == {by_name["router.dispatch"]["span_id"]: ["router.retry"]})


# -- the fleet endpoint -------------------------------------------------------

def _http(url, path, payload=None, headers=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def fleet_endpoint_routes(pkg, jr):
    with _stopping(FakeReplica(), FakeReplica()) as fakes:
        replicas = pkg.fleet.replica_specs([f.url for f in fakes],
                                           journal=jr)
        app = pkg.fleet.FleetApp(replicas, "old.npz", port=0, poll_s=0.05,
                                 shadow_n=2, trace_sample=1.0, journal=jr)
        app.membership.poll_once()
        app.start()
        try:
            out = []
            code, health = _http(app.url, "/healthz")
            out.append((code, health["n_live"], health["serving_digests"],
                        [r["state"] for r in health["replicas"]]))
            out.append(_http(app.url, "/predict", {"trials": []},
                             headers={"X-Model": "s01",
                                      "X-Priority": "control"}))
            sent = [h for f in fakes for h in f.headers_log][-1]
            out.append((sent.get("X-Model"), sent.get("X-Priority")))
            code, opened = _http(app.url, "/session/open",
                                 {"session": "s1"})
            home = [i for i, f in enumerate(fakes) if "s1" in f.sessions]
            out.append((code, opened, home))
            for _ in range(3):
                out.append(_http(app.url, "/session/s1/samples", raw=b"x"))
            out.append(_http(app.url, "/session/s1/state"))
            out.append(_http(app.url, "/session/open", {"session": "s2"}))
            out.append([sorted(f.sessions) for f in fakes])
            out.append(_http(app.url, "/session/import", {"session": "s1"}))
            out.append(_http(app.url, "/session/s1/close", raw=b""))
            out.append(_http(app.url, "/session/s1/samples", raw=b"x"))
            out.append(_http(app.url, "/reload", {"checkpoint": "new.npz"})[0])
            # The released canary rejoins at the poller's next tick.
            out.append(app.membership.wait_live(2, timeout_s=10))
            out.append(_http(app.url, "/reload", {"shadow_n": "x"})[0])
            code, metrics = _http(app.url, "/metrics")
            out.append((code, sorted(metrics)))
            out.append(_http(app.url, "/nowhere")[0])
        finally:
            app.stop()
        return out


def launch_commands_follow_the_reload(pkg, jr):
    fleet = pkg.fleet
    sup, replicas = fleet.spawn_replica_fleet(
        "old.npz", 3, run_dir=Path(jr.dir) / "fleet", journal=jr,
        serve_args=["--maxWaitMs", "5"],
        per_replica_args={"r1": ["--chaosTag", "r1"]})
    fleet.update_child_checkpoints(sup, "new.npz")
    cmds = [child.spec.cmd for child in sup.children.values()]
    module = cmds[0][cmds[0].index("-m") + 1]
    scaler = fleet.ReplicaScaler(sup, pkg.ms.FleetMembership(replicas),
                                 checkpoint="new.npz",
                                 run_dir=Path(jr.dir) / "fleet",
                                 journal=jr)
    spec, url, hb_file = fleet.build_replica_spec(
        scaler._claim_index(), "new.npz", run_dir=Path(jr.dir), port=1234)
    policy = sup.policy
    return (module.replace("_torch", ""),
            [c[c.index("--checkpoint") + 1] for c in cmds],
            ["--chaosTag" in c for c in cmds],
            [c[c.index("-m") + 2:] for c in cmds][0][:2],
            [r.replica_id for r in replicas], spec.name, url,
            hb_file.name, policy.resume_arg, policy.thresholds,
            policy.grace_s)


SCENARIOS = {
    "join_drain_recover": join_drain_recover,
    "snapshot_mirrors_the_replica": snapshot_mirrors_the_replica,
    "unreachable_out_and_rejoin": unreachable_out_and_rejoin,
    "stale_heartbeat_drains_without_flapping":
        stale_heartbeat_drains_without_flapping,
    "least_loaded_dispatch": least_loaded_dispatch,
    "dead_replica_fails_over": dead_replica_fails_over,
    "busy_is_429_and_no_live_is_503": busy_is_429_and_no_live_is_503,
    "breaker_trips_on_5xx": breaker_trips_on_5xx,
    "reload_converges": reload_converges,
    "corrupt_push_changes_nothing": corrupt_push_changes_nothing,
    "shadow_disagreement_rolls_back": shadow_disagreement_rolls_back,
    "unverifiable_digest_aborts": unverifiable_digest_aborts,
    "dispatch_and_retry_spans": dispatch_and_retry_spans,
    "fleet_endpoint_routes": fleet_endpoint_routes,
    "launch_commands_follow_the_reload": launch_commands_follow_the_reload,
}

# What each scenario must decide, beyond agreeing with the JAX package.
EXPECTED = {
    "join_drain_recover": ["joining", ("live", "d-old"), ("draining", 0),
                           "live"],
    "unreachable_out_and_rejoin": ["live", "live", "out", "live"],
    "stale_heartbeat_drains_without_flapping":
        ["live", "draining", "draining", "draining", "live"],
    "least_loaded_dispatch": ([(200, "r1")] * 5, 0, 5),
    "busy_is_429_and_no_live_is_503": ["AllReplicasBusy", "NoLiveReplicas"],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_decides_as_jax(name, tmp_path):
    decisions, _ = twin(SCENARIOS[name], tmp_path)
    if name in EXPECTED:
        assert decisions == EXPECTED[name]
    if name == "dead_replica_fails_over":
        picks, state, failovers = decisions
        assert picks == [(200, "r1")] * 6 and state == "out"
        assert failovers >= 1
    if name == "reload_converges":
        result, digests, _, n_live = decisions
        assert result["status"] == "converged"
        assert digests == ["d-new"] * 3 and n_live == 3
    if name == "corrupt_push_changes_nothing":
        result, digests, pushes, n_live = decisions
        assert (result["status"], result["stage"]) == ("failed",
                                                       "canary_reload")
        assert digests == ["d-old"] * 3 and n_live == 3
        assert sum(len(p) for p in pushes) == 1
    if name == "shadow_disagreement_rolls_back":
        result, digests, pushes, _ = decisions
        assert result["stage"] == "shadow" and digests == ["d-old"] * 3
        assert sorted(c for p in pushes for c in p) == ["new.npz", "old.npz"]
    if name == "dispatch_and_retry_spans":
        assert decisions == (False, 200, "r1", True, True, True,
                             ["router.dispatch"], True)
    if name == "launch_commands_follow_the_reload":
        assert decisions[0] == "eegnetreplication_tpu.serve"
        assert decisions[1] == ["new.npz"] * 3


def test_the_port_replica_command_is_the_port_server(tmp_path):
    from eegnetreplication_tpu_torch.serve.fleet import service as fleet

    spec, _, _ = fleet.build_replica_spec(0, "m.npz", run_dir=tmp_path,
                                          port=1)
    assert spec.cmd[1:3] == ["-m", "eegnetreplication_tpu_torch.serve"]
    assert all("eegnetreplication_tpu." not in part for part in spec.cmd)


def test_event_summary_reads_the_fleet_journal_as_jax(tmp_path):
    def scenario(pkg, jr):
        with _stopping(FakeReplica(), FakeReplica()) as fakes:
            _seeded_reload(pkg, jr, list(fakes), "new.npz", shadow_n=2)
        return None

    summaries = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        summaries[key] = {k: v for k, v in pkg.schema.event_summary(
            events).items() if k.startswith("fleet_")}
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["fleet_reload_status"] == "converged"
    assert summaries["port"]["fleet_shadow_agree"] == 1.0


# -- the CLI --------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen["parser"]


def _ast_flags(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    (main,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return sorted(call.args[0].value for call in ast.walk(main)
                  if isinstance(call, ast.Call)
                  and getattr(call.func, "attr", "") == "add_argument")


def test_fleet_has_the_jax_fleets_31_flags(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    port = _parser_of(PKGS["port"].fleet.main, monkeypatch)
    ref = _parser_of(PKGS["jax"].fleet.main, monkeypatch)

    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings
                      if o.startswith("--") and o != "--help")

    assert flags(port) == flags(ref)
    assert len(flags(port)) == 31
    argv = ["--checkpoint", "m.npz"]
    assert vars(port.parse_args(argv)) == vars(ref.parse_args(argv))
    scaled = argv + ["--autoscale", "--autoscaleMax", "3", "--hedgeBudget",
                     "0.05", "--outlierK", "3"]
    assert vars(port.parse_args(scaled)) == vars(ref.parse_args(scaled))
    src = REPO / "eegnetreplication_tpu_torch/serve/fleet/service.py"
    jax_src = REPO / "eegnetreplication_tpu/serve/fleet/service.py"
    assert _ast_flags(src) == _ast_flags(jax_src)
    assert len(_ast_flags(src)) == 31


@pytest.mark.parametrize("argv", [
    ["--replicas", "0"],
    ["--autoscale", "--autoscaleMin", "3", "--autoscaleMax", "2"],
    ["--autoscale", "--replicas", "5", "--autoscaleMax", "4"],
    ["--autoscale", "--sessionsDir", "s"],
    ["--slo", "latency<5"],
])
def test_bad_fleet_settings_stop_the_cli_as_jax(argv, monkeypatch, capsys):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    errors = []
    for key in ("port", "jax"):
        with pytest.raises(SystemExit) as exit_:
            PKGS[key].fleet.main(["--checkpoint", "m.npz", *argv])
        assert exit_.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ", 1)[1] == \
        errors[1].split("error: ", 1)[1]


def test_the_fleet_refuses_a_host_without_cuda(monkeypatch, tmp_path):
    """No CPU fallback: without ``EEGTPU_PLATFORM=cpu`` a host with no
    CUDA stops the router before it spawns a replica."""
    import torch

    monkeypatch.delenv("EEGTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        PKGS["port"].fleet.main(["--checkpoint", "m.npz", "--metricsDir",
                                 str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_startup_reports_each_step_of_a_process_start():
    """``utils/startup.py`` (where a replica's start goes): one JSON line
    with every step's seconds; on the CPU the card's steps are skipped."""
    launched = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.utils.startup",
         "--launched", repr(launched)], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=child_env(EEGTPU_PLATFORM="cpu", EEGTPU_NO_LOG_FILE="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert row["device"] == "cpu"
    assert list(row["steps_s"]) == ["interpreter", "import_torch",
                                    "platform_device", "select_device_pins"]
    assert all(v >= 0 for v in row["steps_s"].values())
    assert abs(row["total_s"] - sum(row["steps_s"].values())) < 1e-9


C, T, F1, D = 4, 64, 4, 2
META = {"model": "eegnet", "n_channels": C, "n_times": T, "F1": F1, "D": D}


def _wait_for_line(path: Path, needle: str, proc, timeout_s: float) -> str:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        text = path.read_text() if path.exists() else ""
        for line in text.splitlines():
            if needle in line:
                return line
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    raise AssertionError(f"no {needle!r} in {path}: "
                         f"{(path.read_text() if path.exists() else '')[-3000:]}")


def test_fleet_cli_serves_the_jax_engines_predictions(tmp_path):
    from eegnetreplication_tpu.serve import engine as jax_engine
    from eegnetreplication_tpu.training import checkpoint as jax_ckpt

    variables = {}
    for name, seed in (("a", 31), ("b", 32)):
        params, bs = jax_variables(C, T, F1, D, seed=seed)
        variables[name] = (params, bs, jax_ckpt.save_checkpoint(
            tmp_path / f"{name}.npz", params, bs, metadata=dict(META)))
    x = trials(9, C, T, seed=33)
    log = tmp_path / "fleet.log"
    env = child_env(EEGTPU_PLATFORM="cpu", EEGTPU_NO_LOG_FILE="1",
                    EEGTPU_DATA_ROOT=str(tmp_path))
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "eegnetreplication_tpu_torch.serve.fleet",
             "--checkpoint", str(variables["a"][2]), "--replicas", "2",
             "--port", "0", "--pollS", "0.1", "--buckets", "1,8",
             "--metricsDir", str(tmp_path / "obs")],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        line = _wait_for_line(log, "fleet serving at", proc, 150)
        url = line.split("fleet serving at ", 1)[1].split()[0]
        code, health = _http(url, "/healthz")
        assert code == 200 and health["n_live"] == 2
        params, bs, _ = variables["a"]
        digest = jax_engine.variables_digest(params, bs)
        assert health["serving_digests"] == [digest]
        code, body = _http(url, "/predict", {"trials": x.tolist()})
        want = jax_engine.InferenceEngine(jax_model(C, T, F1, D), params,
                                          bs).infer(x)
        assert code == 200 and body["predictions"] == want.tolist()
        assert body["model_digest"] == digest
        code, result = _http(url, "/reload",
                             {"checkpoint": str(variables["b"][2])})
        params, bs, _ = variables["b"]
        assert code == 200 and result["status"] == "converged"
        assert result["new_digest"] == jax_engine.variables_digest(params,
                                                                   bs)
        code, body = _http(url, "/predict", {"trials": x.tolist()})
        want = jax_engine.InferenceEngine(jax_model(C, T, F1, D), params,
                                          bs).infer(x)
        assert code == 200 and body["predictions"] == want.tolist()
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 75, log.read_text()[-3000:]
    schema = PKGS["port"].schema
    (run_dir,) = [d for d in (tmp_path / "obs").iterdir()
                  if (d / "events.jsonl").exists()
                  and '"role": "fleet"' in (d / "events.jsonl").read_text()]
    events = schema.read_events(run_dir / "events.jsonl")
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert {"fleet_start", "fleet_canary", "fleet_shadow", "fleet_reload",
            "fleet_end", "supervisor_start", "supervisor_end"} <= set(kinds)
    end = [e for e in events if e["event"] == "supervisor_end"][-1]
    assert end["status"] == "stopped"
    # Both replicas ran the port's server and ended their journals.
    replica_runs = [d for d in (run_dir / "replica_obs").iterdir()]
    assert len(replica_runs) == 2
    for d in replica_runs:
        rows = schema.read_events(d / "events.jsonl")
        assert rows[-1]["event"] == "run_end"
