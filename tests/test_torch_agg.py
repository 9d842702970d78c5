"""The port's journal aggregation, console and ``event_summary`` against
the JAX package's, on the CPU.

Seeded journal trees (a supervisor run, two child train runs, one live
with a torn last line, a serve run with ``request`` and ``span`` events
and a rotated ``events.jsonl.1``, and a cells topology nested three levels
deep) go through both packages' ``discover_runs``, ``JournalTailer``
(appends between polls, the torn line completed, a rotation drained),
``FleetState`` and ``Aggregator`` with one injected clock: the runs, the
events, the cursors, the snapshots and the ``agg_snapshot`` events are
equal.  ``obs.top --json`` and ``--once`` print the same bytes.
``event_summary`` is equal on the JAX ``TestSupervisionEventSummary``
events, on the seeded trees and on real journals of a port CPU train run
and a port CPU serve run.
"""

import functools
import io
import json
import sys
import time
import urllib.request
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
from torch_port_cases import jax_variables, trials, write_processed_tree

from eegnetreplication_tpu.obs import agg as jax_agg
from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu.obs import top as jax_top
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.obs import agg, schema, top
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.serve import service
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    save_checkpoint,
)

T0 = 1_800_000_000.0
NOW = T0 + 100.0


class Recorder:
    """A journal that keeps its events."""

    def __init__(self):
        self.events = []

    def event(self, name, **fields):
        self.events.append(dict(fields, event=name))
        return {}


def _line(ev) -> str:
    return json.dumps(ev) + "\n"


def _write(path: Path, events, torn: str | None = None):
    path.parent.mkdir(parents=True, exist_ok=True)
    text = "".join(_line(e) for e in events)
    if torn is not None:
        text += torn
    path.write_text(text)


def _start(run_id, t, **extra):
    return dict({"event": "run_start", "t": t, "run_id": run_id,
                 "schema_version": 1, "git_sha": "abc", "platform": "cpu",
                 "device_kind": "cpu", "n_devices": 1, "config": {}},
                **extra)


def _supervisor(rng, run_id):
    ev = [_start(run_id, T0, role="supervisor"),
          {"event": "supervisor_start", "t": T0 + 0.1, "run_id": run_id,
           "cmd": ["python", "-m", "train"], "grace_s": 5.0}]
    t = T0 + 0.2
    for attempt, kind in enumerate(("preempted", "hang", "completed"), 1):
        ev.append({"event": "supervisor_launch", "t": t, "run_id": run_id,
                   "attempt": attempt, "cmd": ["python"], "pid": 100 + attempt,
                   "resume": attempt > 1})
        t += float(rng.uniform(5, 15))
        if kind == "hang":
            ev.append({"event": "supervisor_hang", "t": t, "run_id": run_id,
                       "attempt": attempt, "age_s": 20.6,
                       "threshold_s": 20.0, "phase": "step"})
            ev.append({"event": "supervisor_escalate", "t": t + 5,
                       "run_id": run_id, "attempt": attempt,
                       "signal": "SIGKILL", "grace_s": 5.0})
        ev.append({"event": "supervisor_exit", "t": t + 5.1,
                   "run_id": run_id, "attempt": attempt,
                   "exit_code": {"preempted": 75, "hang": -9,
                                 "completed": 0}[kind],
                   "classification": kind})
        if kind != "completed":
            ev.append({"event": "supervisor_restart", "t": t + 5.2,
                       "run_id": run_id, "attempt": attempt, "reason": kind,
                       "delay_s": 0.0, "resume": True})
        t += 6.0
    ev.append({"event": "supervisor_end", "t": t, "run_id": run_id,
               "status": "completed", "exit_code": 0})
    return ev


def _train(rng, run_id, t, epochs, status):
    ev = [_start(run_id, t),
          {"event": "train_setup", "t": t + 0.5, "run_id": run_id,
           "protocol": "within_subject", "n_folds": 36, "epochs": 500,
           "train_pad": 352, "real_train_samples": 12456,
           "padded_train_slots": 216}]
    for e in range(1, epochs + 1):
        t += float(rng.uniform(0.1, 0.4))
        ev.append({"event": "epoch", "t": t, "run_id": run_id, "epoch": e,
                   "total_epochs": 500,
                   "train_loss": float(rng.uniform(0.5, 1.5)),
                   "val_loss": float(rng.uniform(0.5, 1.5)),
                   "val_acc": float(rng.uniform(25, 90)),
                   "grad_norm": float(rng.uniform(0.1, 2)), "n_folds": 36})
        if e % 5 == 0:
            ev.append({"event": "checkpoint_write", "t": t,
                       "run_id": run_id, "dur_ms": float(rng.uniform(5, 50)),
                       "async": True, "overlapped_ms": 10.0,
                       "blocked_ms": float(rng.uniform(0, 2)),
                       "generation": e // 5, "drain": e == epochs})
    if status is not None:
        ev.append({"event": "run_end", "t": t + 0.1, "run_id": run_id,
                   "status": status, "wall_s": t - T0})
    return ev


def _serve(rng, run_id, n):
    ev = [_start(run_id, T0),
          {"event": "serve_start", "t": T0 + 1, "run_id": run_id,
           "checkpoint": "m.npz", "buckets": [1, 8], "max_batch": 8,
           "max_wait_ms": 5.0, "tenants": ["a", "b"]}]
    statuses = ["ok"] * 6 + ["rejected", "expired", "shed", "error"]
    for i in range(n):
        t = T0 + 2 + 97.0 * i / n
        ev.append({"event": "request", "t": t, "run_id": run_id,
                   "n_trials": int(rng.integers(1, 64)),
                   "latency_ms": float(rng.lognormal(2, 0.5)),
                   "status": statuses[int(rng.integers(len(statuses)))],
                   "model": ["a", "b"][int(rng.integers(2))]})
        if i % 3 == 0:
            ev.append({"event": "span", "t": t, "run_id": run_id,
                       "name": ["queue", "forward"][i % 2],
                       "trace_id": f"{i:032x}", "span_id": f"{i:016x}",
                       "start": t, "dur_ms": float(rng.uniform(0.1, 9))})
        if i == n // 2:
            ev.append({"event": "circuit_state", "t": t, "run_id": run_id,
                       "state": "open", "previous": "closed",
                       "reason": "failure_threshold"})
            ev.append({"event": "slo_breach", "t": t, "run_id": run_id,
                       "objective": "p95_latency_ms<20", "value": 31.0,
                       "threshold": 20.0})
            ev.append({"event": "probe", "t": t, "run_id": run_id,
                       "status": "ok", "latency_ms": 7.5, "url": "u"})
            ev.append({"event": "shadow_eval", "t": t, "run_id": run_id,
                       "model": "a", "digest": "d", "n_trials": 4,
                       "agree": 0.75})
            ev.append({"event": "promotion", "t": t, "run_id": run_id,
                       "model": "a", "action": "promote", "digest": "d"})
    return ev


def _cells(root: Path, rng):
    """A cells topology three levels deep: front, cell, replica."""
    front = root / "cells" / "front1"
    _write(front / "events.jsonl", [
        _start("front1", T0),
        {"event": "cell_front_start", "t": T0 + 1, "run_id": "front1",
         "cells": ["c0"]},
        {"event": "cell_member", "t": T0 + 2, "run_id": "front1",
         "cell": "c0", "state": "live", "previous": "joining",
         "reason": "ok"}])
    cell = front / "c0_obs" / "cell1"
    _write(cell / "events.jsonl", [
        _start("cell1", T0),
        {"event": "fleet_start", "t": T0 + 1, "run_id": "cell1",
         "replicas": ["r0", "r1"], "checkpoint": "m.npz"},
        {"event": "fleet_member", "t": T0 + 2, "run_id": "cell1",
         "replica": "r0", "state": "live", "previous": "joining",
         "reason": "ok"},
        {"event": "fleet_scale", "t": T0 + 3, "run_id": "cell1",
         "action": "up", "target": 2, "n_live": 1, "reason": "load"}])
    replica = cell / "replica_obs" / "rep1"
    _write(replica / "events.jsonl", _serve(rng, "rep1", 12))


def _tree(root: Path, seed: int) -> dict:
    """Write the seeded tree; returns {name: (run dir, all events, text
    held back for the second poll)}."""
    rng = np.random.default_rng(seed)
    out = {}
    sup = _supervisor(rng, "sup1")
    _write(root / "obs" / "sup1" / "events.jsonl", sup[:-3])
    out["sup"] = (root / "obs" / "sup1", sup, "".join(map(_line, sup[-3:])))
    done = _train(rng, "child1", T0 + 1, 10, "preempted")
    _write(root / "obs" / "children" / "child1" / "events.jsonl", done)
    out["child1"] = (root / "obs" / "children" / "child1", done, "")
    live = _train(rng, "child2", T0 + 60, 30, None)
    whole = _line(live[-1])
    cut = len(whole) // 2
    _write(root / "obs" / "children" / "child2" / "events.jsonl", live[:-1],
           torn=whole[:cut])
    more = _train(rng, "child2", T0 + 90, 5, "ok")[2:]
    out["child2"] = (root / "obs" / "children" / "child2", live + more,
                     whole[cut:] + "".join(map(_line, more)))
    serve = _serve(rng, "serve1", 60)
    sealed, rest = serve[:40], serve[40:]
    _write(root / "serve" / "serve1" / "events.jsonl.1", sealed)
    _write(root / "serve" / "serve1" / "events.jsonl", rest)
    out["serve1"] = (root / "serve" / "serve1", serve, "")
    _cells(root, rng)
    return out


def _clock():
    return NOW


def _both(fn_name, *args, **kwargs):
    return (getattr(jax_agg, fn_name)(*args, **kwargs),
            getattr(agg, fn_name)(*args, **kwargs))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_discover_runs_equals_jax(tmp_path, seed):
    runs = _tree(tmp_path, seed)
    for roots in ([tmp_path], [tmp_path / "obs", tmp_path / "serve"],
                  [runs["sup"][0], tmp_path / "cells"],
                  [tmp_path / "missing"]):
        ref, got = _both("discover_runs", roots)
        assert got == ref
    ref, got = _both("discover_runs", [tmp_path])
    assert len(got) == 7   # 4 runs, 3 cells levels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tailers_read_as_jax_across_appends_torn_lines_and_rotation(
        tmp_path, seed):
    runs = _tree(tmp_path, seed)
    for name, (run_dir, events, held) in runs.items():
        ref = jax_agg.JournalTailer(run_dir)
        got = agg.JournalTailer(run_dir)
        first = (ref.poll(), got.poll())
        assert first[1] == first[0]
        assert (got.cursor, got.dropped) == (ref.cursor, ref.dropped)
        with open(run_dir / "events.jsonl", "a") as fh:
            fh.write(held + "not json\n")
        second = (ref.poll(), got.poll())
        assert second[1] == second[0]
        assert (got.cursor, got.dropped) == (ref.cursor, ref.dropped) \
            and got.dropped == 1
        if name != "serve1":
            assert first[1] + second[1] == events
    # A rotation between polls: the live file is sealed as .1 with lines
    # the tailers have not read, and a shorter live file starts.
    run_dir = runs["serve1"][0]
    ref = jax_agg.JournalTailer(run_dir)
    got = agg.JournalTailer(run_dir)
    ref.poll(), got.poll()
    live = run_dir / "events.jsonl"
    extra = _serve(np.random.default_rng(seed + 10), "serve1", 6)[2:]
    with open(live, "a") as fh:
        fh.write("".join(map(_line, extra)))
    (run_dir / "events.jsonl.1").rename(run_dir / "events.jsonl.2")
    live.rename(run_dir / "events.jsonl.1")
    _write(live, extra[:1])
    drained = (ref.poll(), got.poll())
    assert drained[1] == drained[0] == extra + extra[:1]
    assert got.cursor == ref.cursor


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [30.0, agg.DEFAULT_WINDOW_S])
def test_aggregator_snapshots_equal_jax(tmp_path, seed, window):
    assert (agg.DEFAULT_WINDOW_S, agg._SPAN_CAP) \
        == (jax_agg.DEFAULT_WINDOW_S, jax_agg._SPAN_CAP)
    runs = _tree(tmp_path, seed)
    recs = Recorder(), Recorder()
    ref = jax_agg.Aggregator([tmp_path], window_s=window, journal=recs[0],
                             clock=_clock)
    got = agg.Aggregator([tmp_path], window_s=window, journal=recs[1],
                         clock=_clock)
    assert got.poll() == ref.poll()
    for run_dir, _, held in runs.values():
        with open(run_dir / "events.jsonl", "a") as fh:
            fh.write(held)
    snap = got.poll()
    assert snap == ref.poll()
    assert got.cursors() == ref.cursors()
    assert recs[1].events == recs[0].events
    assert [e["event"] for e in recs[1].events] == ["agg_snapshot"] * 2
    # serve1's run_start and serve_start sit in its sealed segment, which
    # a tailer starting on the live file never reads: both packages leave
    # its id unknown and its role "run".
    roles = {Path(r["dir"]).name: r["role"] for r in snap["runs"]}
    assert roles["sup1"] == "supervisor" and roles["child2"] == "train"
    assert roles["rep1"] == "serve" and roles["cell1"] == "fleet"
    assert roles["serve1"] == "run" and roles["front1"] == "cells"
    child2 = next(r for r in snap["runs"] if r["run_id"] == "child2")
    assert child2["fold_epochs_per_s"] > 0 and child2["status"] == "ok"
    # A restarted aggregator resumes from the cursors it was given.
    again = agg.Aggregator([tmp_path], window_s=window, journal=Recorder(),
                           clock=_clock)
    again.seed_cursors(got.cursors())
    assert again.poll()["runs"] == []


def _console(module, agg_module, argv, monkeypatch):
    monkeypatch.setattr(module, "Aggregator",
                        functools.partial(agg_module.Aggregator,
                                          clock=_clock))
    out = io.StringIO()
    with redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("mode", ["--json", "--once"])
def test_top_prints_what_the_jax_console_prints(tmp_path, monkeypatch, mode):
    _tree(tmp_path, 3)
    monkeypatch.setattr(time, "localtime", lambda *a: time.gmtime(NOW))
    argv = [mode, "--window", "45", str(tmp_path)]
    ref = _console(jax_top, jax_agg, argv, monkeypatch)
    got = _console(top, agg, argv, monkeypatch)
    assert got == ref
    if mode == "--json":
        snap = json.loads(got)
        assert snap["n_runs"] == 7 and snap["window_s"] == 45.0
    else:
        assert "supervisor" in got and "train" in got


def test_top_refuses_a_missing_path(tmp_path, capsys):
    assert top.main(["--json", str(tmp_path / "nope")]) == 1
    assert "No such path" in capsys.readouterr().err


# --- event_summary ------------------------------------------------------------

def _summary_base(run_id="s1"):
    return [_start(run_id, 1.0)]


SUMMARY_CASES = {
    "supervisor_fields": _summary_base() + [
        {"event": "supervisor_start", "t": 2.0, "run_id": "s1",
         "cmd": ["x"]},
        {"event": "supervisor_hang", "t": 3.0, "run_id": "s1",
         "attempt": 1, "age_s": 9.0, "threshold_s": 3.0, "phase": "step"},
        {"event": "supervisor_restart", "t": 4.0, "run_id": "s1",
         "attempt": 1, "reason": "hang", "delay_s": 0.0, "resume": True},
        {"event": "supervisor_end", "t": 5.0, "run_id": "s1",
         "status": "completed"},
        {"event": "run_end", "t": 6.0, "run_id": "s1", "status": "ok",
         "wall_s": 5.0}],
    "serving_expired_and_breaker_fields": _summary_base() + [
        {"event": "request", "run_id": "s1", "n_trials": 1,
         "latency_ms": 1.0, "t": 2.0, "status": "ok"},
        {"event": "request", "run_id": "s1", "n_trials": 1,
         "latency_ms": 1.0, "t": 3.0, "status": "expired"},
        {"event": "request", "run_id": "s1", "n_trials": 1,
         "latency_ms": 1.0, "t": 4.0, "status": "circuit_open"},
        {"event": "circuit_state", "t": 5.0, "run_id": "s1",
         "state": "open", "previous": "closed",
         "reason": "failure_threshold"},
        {"event": "circuit_state", "t": 6.0, "run_id": "s1",
         "state": "half_open", "previous": "open",
         "reason": "cooldown_elapsed"},
        {"event": "run_end", "t": 7.0, "run_id": "s1", "status": "ok",
         "wall_s": 6.0}],
    "giveup": _summary_base() + [
        {"event": "supervisor_start", "t": 2.0, "run_id": "s1",
         "cmd": ["x"]},
        {"event": "supervisor_giveup", "t": 3.0, "run_id": "s1",
         "restarts": 5, "window_s": 600.0},
        {"event": "supervisor_end", "t": 4.0, "run_id": "s1",
         "status": "crash_loop"}],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_event_summary_equals_jax_on_the_jax_cases(case):
    events = SUMMARY_CASES[case]
    assert schema.event_summary(events) == jax_schema.event_summary(events)
    if case == "supervisor_fields":
        s = schema.event_summary(events)
        assert (s["supervisor_restarts"], s["hang_detections"],
                s["supervisor_status"]) == (1, 1, "completed")


@pytest.mark.parametrize("seed", [0, 1])
def test_event_summary_equals_jax_on_the_seeded_trees(tmp_path, seed):
    runs = _tree(tmp_path, seed)
    for run_dir in agg.discover_runs([tmp_path]):
        events = jax_schema.read_events(run_dir / "events.jsonl",
                                        complete=False, lenient_tail=True)
        assert schema.event_summary(events) \
            == jax_schema.event_summary(events)
    sup = schema.event_summary(runs["sup"][1])
    assert (sup["supervisor_restarts"], sup["supervisor_status"]) \
        == (2, "completed")


def test_event_summary_equals_jax_on_a_port_train_run(tmp_path, monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    write_processed_tree(tmp_path)
    assert train_cli.main(["--subjects", "1,2", "--epochs", "2",
                           "--checkpointEvery", "1", "--metricsDir",
                           str(tmp_path / "m")]) == 0
    (run,) = (tmp_path / "m").iterdir()
    events = schema.read_events(run / "events.jsonl")
    got = schema.event_summary(events)
    assert got == jax_schema.event_summary(events)
    assert got["status"] == "ok" and got["n_epoch_events"] == 2
    assert got["checkpoint_writes"] == 2
    recs = Recorder(), Recorder()
    snaps = [pkg.Aggregator([tmp_path / "m"], journal=rec,
                            clock=lambda: events[-1]["t"]).poll()
             for pkg, rec in zip((jax_agg, agg), recs)]
    assert snaps[1] == snaps[0] and snaps[1]["runs"][0]["role"] == "train"


def test_event_summary_equals_jax_on_a_port_serve_run(tmp_path):
    c, t = 8, 64
    params, bs = jax_variables(c, t, 8, 2, seed=43)
    checkpoint = save_checkpoint(
        tmp_path / "m.npz", from_jax_variables(params, bs),
        metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                  "F1": 8, "D": 2})
    with obs_journal.run(tmp_path / "obs", config={}) as journal:
        app = service.ServeApp(checkpoint, port=0, device="cpu",
                               journal=journal, buckets=(1, 8),
                               trace_sample=1.0).start()
        try:
            for n in (1, 3, 8):
                body = json.dumps({"trials": trials(n, c, t, seed=n)
                                   .tolist()}).encode()
                req = urllib.request.Request(
                    app.url + "/predict", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    assert resp.status == 200
        finally:
            app.stop()
    events = schema.read_events(journal.events_path)
    got = schema.event_summary(events)
    assert got == jax_schema.event_summary(events)
    assert got["n_requests"] == 3 and got["trace_spans"] > 0
    snaps = [pkg.Aggregator([tmp_path / "obs"], journal=Recorder(),
                            clock=lambda: events[-1]["t"]).poll()
             for pkg in (jax_agg, agg)]
    assert snaps[1] == snaps[0] and snaps[1]["runs"][0]["role"] == "serve"
