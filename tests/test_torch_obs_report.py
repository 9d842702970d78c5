"""The port's run and trace reports and its ``BENCH_*.json`` envelope
against the JAX package's, on the CPU.

- ``python -m eegnetreplication_tpu_torch.obs.report`` against
  ``scripts/obs_report.py`` (loaded by path): the ``--json`` lines, the
  table and the exit code are equal on seeded journal trees (a
  supervisor and its children, one live with a torn last line, a serve
  run with a rotated segment, a cells topology three levels deep, the HA
  pair's events), on a real port train run's journal and on an
  unreadable run.
- ``python -m eegnetreplication_tpu_torch.obs.trace_report`` against
  ``scripts/trace_report.py``: ``--json``, the table and waterfall,
  ``--trace``, ``--chrome`` and ``--require-cross-process`` are equal on
  seeded router and replica journals.
- ``write_json_artifact`` and ``validate_bench`` accept and refuse the
  records the JAX ones do, and write the same bytes; the registry's
  ``flush`` writes the bytes its own temp-file writer wrote before it went
  through ``write_json_artifact``.
"""

import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
from test_torch_agg import _tree
from test_torch_ha import _populate
from test_torch_trace_reader import write_seeded_journals
from torch_port_cases import child_env, write_processed_tree

from eegnetreplication_tpu.obs import metrics as jax_metrics
from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu_torch import obs
from eegnetreplication_tpu_torch.obs import metrics, report, schema
from eegnetreplication_tpu_torch.obs import trace_report

REPO = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_REPORT = _script("obs_report")
JAX_TRACE_REPORT = _script("trace_report")


def _run(main, argv):
    """``main(argv)``'s exit code, stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(port_main, jax_main, argv):
    got = _run(port_main, argv)
    assert got == _run(jax_main, argv)
    return got


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """The journal of one port train CLI run on the CPU (2 subjects, 2
    epochs in chunks of 1)."""
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
    return root / "m"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["json", "table"])
def test_report_equals_the_jax_script_on_seeded_trees(tmp_path, seed, mode):
    _tree(tmp_path / "agg", seed)
    _populate(tmp_path / "ha")
    argv = [str(tmp_path / "agg"), str(tmp_path / "ha")]
    rc, out, _ = _both(report.main, JAX_REPORT.main,
                       argv + (["--json"] if mode == "json" else []))
    assert rc == 0
    if mode == "json":
        rows = [json.loads(line) for line in out.splitlines()]
        dirs = {Path(r["dir"]).relative_to(tmp_path).as_posix()
                for r in rows}
        # the cells topology: front, cell and replica, three levels deep
        assert {"agg/cells/front1", "agg/cells/front1/c0_obs/cell1",
                "agg/cells/front1/c0_obs/cell1/replica_obs/rep1"} <= dirs
        assert len(rows) == len(report.discover_runs(argv)) >= 8


def test_report_equals_the_jax_script_on_a_port_train_run(train_run):
    for argv in ([str(train_run)], [str(train_run), "--json"]):
        rc, out, _ = _both(report.main, JAX_REPORT.main, argv)
        assert rc == 0
    (row,) = [json.loads(line) for line in out.splitlines()]
    assert row["status"] == "ok" and row["protocol"] == "within_subject"
    assert row["fold_epochs_total"] == 16.0


def test_report_flags_an_unreadable_run_as_jax_does(tmp_path):
    write_seeded_journals(tmp_path / "obs", 0)     # "broken" is not JSON
    (tmp_path / "obs" / "broken" / "metrics.json").write_text("{}")
    for argv in ([str(tmp_path / "obs")], [str(tmp_path / "obs"), "--json"]):
        rc, _, _ = _both(report.main, JAX_REPORT.main, argv)
        assert rc == 2
    rc, _, err = _both(report.main, JAX_REPORT.main,
                       [str(tmp_path / "missing")])
    assert rc == 1 and "No run directories" in err


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_report_equals_the_jax_script(tmp_path, seed):
    write_seeded_journals(tmp_path / "obs", seed)
    root = str(tmp_path / "obs")
    rc, out, _ = _both(trace_report.main, JAX_TRACE_REPORT.main,
                       [root, "--json"])
    assert rc == 0
    summaries = [json.loads(line) for line in out.splitlines()]
    assert any(s["cross_process"] for s in summaries)
    slowest = summaries[-1]["trace_id"]
    for extra in ([], ["--trace", slowest], ["--trace", "nope"],
                  ["--require-cross-process"]):
        rc, out, _ = _both(trace_report.main, JAX_TRACE_REPORT.main,
                           [root] + extra)
        assert rc == (1 if extra[1:] == ["nope"] else 0)
    chrome = {}
    for key, main in (("port", trace_report.main),
                      ("jax", JAX_TRACE_REPORT.main)):
        path = tmp_path / f"{key}.json"
        rc, out, _ = _run(main, [root, "--chrome", str(path)])
        assert rc == 0 and f"wrote {path}" in out
        chrome[key] = path.read_bytes()
    assert chrome["port"] == chrome["jax"]


def test_trace_report_requires_a_cross_process_trace(tmp_path):
    router = tmp_path / "obs"
    jr = write_seeded_journals(router, 0)[0]     # the router's journal only
    argv = [str(jr.events_path), "--require-cross-process"]
    rc, _, err = _both(trace_report.main, JAX_TRACE_REPORT.main, argv)
    assert rc == 1 and "REQUIRE-CROSS-PROCESS FAIL" in err
    rc, _, _ = _both(trace_report.main, JAX_TRACE_REPORT.main,
                     [str(tmp_path / "empty")])
    assert rc == 1


# name: (record, validate_bench accepts it, write_json_artifact writes it)
BENCH_RECORDS = {
    "minimal": ({"platform": "gpu"}, False, True),
    "stamped": ({"platform": "gpu", "utc": "2026-10-18T00:00:00Z",
                 "schema_version": 7, "value": 1.5}, True, True),
    "card": ({"platform": "gpu", "device": "NVIDIA H100 80GB HBM3",
              "power_limit": "700.00 W", "value": 385.9}, False, True),
    "no_platform": ({"value": 1.0, "utc": "x", "schema_version": 1},
                    False, False),
    "not_a_dict": ([("platform", "gpu")], False, False),
}


@pytest.mark.parametrize("name", sorted(BENCH_RECORDS))
def test_bench_envelope_equals_jax(tmp_path, monkeypatch, name):
    record, validates, writes = BENCH_RECORDS[name]
    for mod in (schema, jax_schema):
        monkeypatch.setattr(mod, "utc_now", lambda: "2026-10-18T01:02:03Z")
    written = {}
    for key, mod in (("port", schema), ("jax", jax_schema)):
        if validates:
            assert mod.validate_bench(record) is record
        else:
            with pytest.raises(mod.SchemaError):
                mod.validate_bench(record)
        path = tmp_path / key / "BENCH_X.json"
        if writes:
            assert mod.write_json_artifact(path, record, indent=1) == path
            written[key] = path.read_bytes()
            assert mod.validate_bench(json.loads(written[key]))
        elif isinstance(record, dict):
            with pytest.raises(mod.SchemaError):
                mod.write_json_artifact(path, record)
            assert not path.exists()
        assert not list(path.parent.glob("*.tmp"))
    if writes:
        assert written["port"] == written["jax"]
        back = json.loads(written["port"])
        assert back["schema_version"] == record.get("schema_version", 1)
        assert back["utc"] == record.get("utc", "2026-10-18T01:02:03Z")
    assert schema.BENCH_REQUIRED == jax_schema.BENCH_REQUIRED
    assert obs.write_json_artifact is schema.write_json_artifact
    assert obs.validate_bench is schema.validate_bench


def test_write_json_artifact_refuses_an_unknown_kind(tmp_path):
    for mod in (schema, jax_schema):
        with pytest.raises(ValueError, match="unknown artifact kind"):
            mod.write_json_artifact(tmp_path / "x.json", {"platform": "gpu"},
                                    kind="trace")
        with pytest.raises(mod.SchemaError):
            mod.write_json_artifact(tmp_path / "m.json", {"platform": "gpu"},
                                    kind="metrics")


def _fill(reg):
    reg.inc("requests_total", 3, status="ok")
    reg.inc("requests_total", status="error")
    reg.set("queue_depth", 2.5)
    for v in (0.4, 3.0, 12.0, 250.0):
        reg.observe("latency_ms", v, route="/predict")


def test_metrics_flush_writes_the_bytes_it_wrote_before(tmp_path,
                                                        monkeypatch):
    for mod in (schema, jax_schema):
        monkeypatch.setattr(mod, "utc_now", lambda: "2026-10-18T01:02:03Z")
    reg = metrics.MetricsRegistry()
    _fill(reg)
    path = reg.flush(tmp_path / "port" / "metrics.json", run_id="r1")
    # What the registry's own writer wrote: the validated snapshot, indent 1.
    before = json.dumps(schema.validate_metrics(reg.snapshot("r1")),
                        indent=1)
    assert path.read_text() == before
    assert not list(path.parent.glob("*.tmp"))
    ref = jax_metrics.MetricsRegistry()
    _fill(ref)
    jax_path = ref.flush(tmp_path / "jax" / "metrics.json", run_id="r1")
    assert path.read_bytes() == jax_path.read_bytes()
