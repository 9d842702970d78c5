"""The port's run journal, metrics and chaos-plan grammar against the JAX
package's.

- The port's ``EVENT_REQUIRED`` holds exactly the JAX table's rows for the
  ten training events, the serving events, the session events (with
  ``spool_mirror``), the control plane's, ``probe``, the adaptation
  events, the eight ``supervisor_*`` events and ``agg_snapshot``, the
  fleet's and the cell tier's.
- A journal written by ``python -m eegnetreplication_tpu_torch.train
  --metricsDir ...`` passes the JAX ``validate_events`` with no
  ``_schema_error``; ``scripts/obs_report.py::summarize_run`` reads it with
  the event counts of the port's ``read_events``; its ``metrics.json``
  passes the JAX ``validate_metrics``.
- ``parse_plan`` gives the JAX ``parse_plan``'s ``FaultSpec`` fields for a
  table of plans, and refuses every JAX site the port lacks.
- The journal's contract: invalid events are written flagged, an
  unwritable journal drops events and never the run, rotated segments
  read back in order (by both packages), a thread journals under
  ``bound``; the registry refuses mixed kinds; the device-fault
  classifier.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch_port_cases import child_env, write_processed_tree

from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu.resil import inject as jax_inject
from eegnetreplication_tpu_torch import obs
from eegnetreplication_tpu_torch.obs import journal, schema
from eegnetreplication_tpu_torch.obs.metrics import MetricsRegistry
from eegnetreplication_tpu_torch.resil import inject, retry

REPO = Path(__file__).resolve().parents[1]
TRAINING_EVENTS = ("run_start", "train_setup", "fold_group", "epoch",
                   "device_fault", "checkpoint_write", "checkpoint_quarantine",
                   "fault_injected", "retry", "run_end")
SERVING_EVENTS = ("serve_start", "request", "model_swap", "serve_end",
                  "quant_gate", "model_load", "model_evict", "zoo_restack",
                  "stack_gate")
SESSION_EVENTS = ("session_start", "session_window", "window_expired",
                  "session_snapshot", "session_resume", "session_end",
                  "session_label", "spool_mirror")
CONTROL_EVENTS = ("compile_begin", "compile_end", "compile", "ladder_retune",
                  "heartbeat", "circuit_state", "admission_change", "shed",
                  "span", "slo_breach", "slo_recovered", "profile_window",
                  "probe")
ADAPT_EVENTS = ("adaptation_start", "adaptation_candidate", "shadow_eval",
                "promotion")
SUPERVISION_EVENTS = ("supervisor_start", "supervisor_launch",
                      "supervisor_exit", "supervisor_hang",
                      "supervisor_escalate", "supervisor_restart",
                      "supervisor_giveup", "supervisor_end", "agg_snapshot")
FLEET_EVENTS = ("fleet_start", "fleet_member", "fleet_retry", "fleet_canary",
                "fleet_shadow", "fleet_reload", "fleet_scale", "fleet_end",
                "replica_ejected", "replica_readmitted", "hedge")
CELL_EVENTS = ("cell_front_start", "cell_member", "session_migrate",
               "session_failover", "cell_front_end", "front_lease",
               "affinity_replay", "cell_upgrade")


def test_event_table_equals_the_jax_rows():
    events = TRAINING_EVENTS + SERVING_EVENTS + SESSION_EVENTS \
        + CONTROL_EVENTS + ADAPT_EVENTS + SUPERVISION_EVENTS + FLEET_EVENTS \
        + CELL_EVENTS
    assert set(schema.EVENT_REQUIRED) == set(events)
    for name in events:
        assert schema.EVENT_REQUIRED[name] == jax_schema.EVENT_REQUIRED[name]
    assert schema.EVENT_BASE_REQUIRED == jax_schema.EVENT_BASE_REQUIRED
    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One CLI run on the CPU: 2 subjects, 2 epochs in chunks of 1 (so the
    snapshot writer journals too); its run directory."""
    root = tmp_path_factory.mktemp("cli")
    write_processed_tree(root)
    env = child_env(EEGTPU_PLATFORM="cpu", EEGTPU_DATA_ROOT=str(root),
                    EEGTPU_NO_LOG_FILE="1")
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--metricsDir", str(root / "m"), "--epochs", "2", "--subjects",
         "1,2", "--checkpointEvery", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (run_dir,) = (root / "m").iterdir()
    return run_dir


def test_cli_journal_passes_the_jax_schema(cli_run):
    events = jax_schema.read_events(cli_run / "events.jsonl")
    assert not [e for e in events if "_schema_error" in e]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("epoch") == 2 and kinds.count("train_setup") == 1
    assert kinds.count("checkpoint_write") == 2
    assert events[-1]["status"] == "ok"
    start = events[0]
    assert start["platform"] == "cpu" and start["mesh_shape"] is None
    assert start["training_type"] == "Within-Subject"
    assert start["subjects"] == [1, 2] and start["epochs"] == 2
    epochs = [e for e in events if e["event"] == "epoch"]
    assert [e["epoch"] for e in epochs] == [1, 2]
    assert all(e["n_folds"] == 8 and e["total_epochs"] == 2 for e in epochs)


def test_obs_report_reads_the_port_journal(cli_run):
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "scripts" / "obs_report.py")
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    row = obs_report.summarize_run(cli_run)
    events = schema.read_events(cli_run / "events.jsonl")
    assert "error" not in row and "schema_drift" not in row
    assert row["status"] == "ok" and row["protocol"] == "within_subject"
    assert row["n_events"] == len(events)
    assert row["n_epoch_events"] == sum(e["event"] == "epoch"
                                        for e in events)
    assert row["checkpoint_writes"] == sum(e["event"] == "checkpoint_write"
                                           for e in events)
    assert row["fold_epochs_total"] == 16.0
    assert row["epoch_throughput"] > 0


def test_metrics_pass_the_jax_validator(cli_run):
    record = json.loads((cli_run / "metrics.json").read_text())
    jax_schema.validate_metrics(record)
    assert schema.read_metrics(cli_run / "metrics.json") == record
    for section, name in (("counters", "fold_epochs_total"),
                          ("gauges", "epoch_throughput"),
                          ("gauges", "wall_seconds_training"),
                          ("gauges", "avg_test_acc"),
                          ("histograms", "chunk_wall_s"),
                          ("histograms", "ckpt_write_s")):
        assert record[section][name], name


PLANS = [
    "train.step:if_folds_over=4:times=0",
    "train.chunk:after=2",
    "train.hang:after=1:sleep=0.5",
    "checkpoint.write:action=corrupt,host.preempt:after=2",
    "checkpoint.write_async:every=2:times=0",
    "train.step:exc=RuntimeError:message=boom {hit}",
    "host.preempt:if_tag=a:slow=0.1:action=slow",
]


@pytest.mark.parametrize("plan", PLANS + ["@file"])
def test_parse_plan_matches_the_jax_grammar(plan, tmp_path):
    if plan == "@file":
        path = tmp_path / "plan.json"
        path.write_text(json.dumps([{"site": "train.chunk", "after": 1},
                                    {"site": "host.preempt", "times": 2}]))
        plan = f"@{path}"
    port, ref = inject.parse_plan(plan), jax_inject.parse_plan(plan)
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        got = dataclasses.asdict(p)
        assert got == {k: getattr(j, k) for k in got}
        assert all(getattr(j, f.name) is None
                   for f in dataclasses.fields(j) if f.name not in got)


def test_the_port_sites_are_the_jax_sites_split_in_two():
    """No site is left unported: the port's sites are all the JAX
    package's, and no part of them is refused."""
    assert set(inject.SITES) == set(jax_inject.SITES)
    assert len(inject.SITES) == len(set(inject.SITES)) == 21
    assert not hasattr(inject, "UNPORTED_SITES")


@pytest.mark.parametrize("site", ["session.drift", "adapt.train",
                                  "adapt.promote", "replica.network",
                                  "fleet.scale", "cell.partition",
                                  "front.lease", "fetch.download"])
def test_the_adaptation_sites_parse_as_in_jax(site):
    """The sites the adaptation, fleet, cell and fetch slices ported: the
    JAX fields and defaults."""
    plan = f"{site}:after=1:times=2"
    (port,), (ref,) = inject.parse_plan(plan), jax_inject.parse_plan(plan)
    got = dataclasses.asdict(port)
    assert got == {k: getattr(ref, k) for k in got}
    assert site in inject.SITES
    assert inject._DEFAULTS[site] == jax_inject._DEFAULTS[site]


def test_parse_plan_rejects_typos():
    with pytest.raises(ValueError, match="Unknown fault-injection site"):
        inject.parse_plan("train.stpe:times=1")
    with pytest.raises(ValueError, match="Unknown chaos plan option"):
        inject.parse_plan("train.step:tmies=1")
    with pytest.raises(ValueError, match="must be an integer"):
        inject.parse_plan("train.step:after=x")
    with pytest.raises(ValueError, match="non-negative finite"):
        inject.parse_plan("train.hang:sleep=nan")


# --- the journal's contract -------------------------------------------------

def test_an_invalid_event_is_written_flagged(tmp_path):
    with obs.run(tmp_path) as jr:
        jr.event("epoch", epoch=1)         # required keys missing
    events = schema.read_events(jr.events_path)
    (bad,) = [e for e in events if e["event"] == "epoch"]
    assert "missing required keys" in bad["_schema_error"]
    jax_schema.validate_events(events)      # readers pass flagged events


def test_an_unwritable_journal_drops_events_not_the_run(tmp_path):
    jr = journal.RunJournal(tmp_path)
    jr.events_path = tmp_path / "missing" / "events.jsonl"
    assert jr.event("fold_group", group=0, fold_lo=0, fold_hi=1)
    jr.run_end()                            # and no raise either


def test_a_failed_run_closes_with_status_error(tmp_path):
    with pytest.raises(ValueError):
        with obs.run(tmp_path) as jr:
            raise ValueError("boom")
    end = schema.read_events(jr.events_path)[-1]
    assert end["status"] == "error" and "boom" in end["error"]


def test_rotated_segments_read_back_in_order(tmp_path):
    jr = journal.RunJournal(tmp_path, rotate_bytes=400, rotate_keep=50)
    jr.run_start()
    for i in range(20):
        jr.event("fold_group", group=i, fold_lo=i, fold_hi=i + 1)
    jr.run_end()
    assert schema.rotated_segments(jr.events_path)
    for read in (schema.read_events, jax_schema.read_events):
        groups = [e["group"] for e in read(jr.events_path)
                  if e["event"] == "fold_group"]
        assert groups == list(range(20))


def test_a_thread_journals_under_bound(tmp_path):
    with obs.run(tmp_path) as jr:
        def work(bind):
            with journal.bound(jr if bind else None):
                journal.current().event("fold_group", group=int(bind),
                                        fold_lo=0, fold_hi=1)

        for bind in (False, True):
            t = threading.Thread(target=work, args=(bind,))
            t.start()
            t.join()
    groups = [e["group"] for e in schema.read_events(jr.events_path)
              if e["event"] == "fold_group"]
    assert groups == [1]
    assert not journal.current().active


def test_registry_kinds_and_values():
    reg = MetricsRegistry()
    reg.inc("n", 2, site="a")
    reg.inc("n", site="a")
    reg.set("g", 5.0)
    reg.observe("h", 1.0)
    reg.observe("h", 3.0)
    assert reg.get("n", site="a") == 3.0 and reg.get("g") == 5.0
    with pytest.raises(ValueError, match="different kind"):
        reg.set("n", 1.0)
    with pytest.raises(ValueError, match="cannot decrease"):
        reg.inc("n", -1)
    snap = jax_schema.validate_metrics(reg.snapshot("r"))
    assert snap["histograms"]["h"][0]["mean"] == 2.0


def test_device_memory_gauge_needs_a_card(tmp_path, monkeypatch):
    jr = journal.RunJournal(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 1234)
    jr.sample_device_memory()
    assert jr.metrics.get("hbm_bytes_in_use", device="0") == 1234.0


@pytest.mark.parametrize("exc, kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), retry.DEVICE_FAULT),
    (RuntimeError("CUDA error: an illegal memory access"), retry.DEVICE_FAULT),
    (RuntimeError("CUDNN_STATUS_EXECUTION_FAILED"), retry.DEVICE_FAULT),
    (RuntimeError("injected crash after chunk 1"), retry.FATAL),
    (ValueError("out of memory"), retry.FATAL),
    (ConnectionError("reset"), retry.TRANSIENT),
    (FileNotFoundError("x"), retry.FATAL),
])
def test_classify(exc, kind):
    assert retry.classify(exc) == kind


def test_platform_follows_the_selected_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "H")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("EEGTPU_PLATFORM", raising=False)
    assert journal._device_info() == {"platform": "gpu", "device_kind": "H",
                                      "n_devices": 1}
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    assert journal._device_info()["platform"] == "cpu"
