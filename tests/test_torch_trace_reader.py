"""The port's trace reader against the JAX package's, on the CPU.

- Seeded multi-process journals (a router and replicas, each its own run
  directory): ``read_spans``, ``build_traces`` (spans, children, roots,
  cross-trace links, processes, durations, cross-process completeness)
  and ``chrome_trace_events`` give the JAX reader's output, over journal
  files, run directories and a root alike, with a killed member's torn
  last line and an unreadable journal skipped.
- A live fleet on the CPU: the port's ``FleetApp`` over two in-process
  port servers, every request sampled.  Each trace stitched from the three
  journals has the router's ``router.request`` as its one root and the
  serving replica's ``replica.request`` parented on the router's
  ``router.dispatch`` from another process, and the JAX reader stitches
  the same trees.
"""

import dataclasses
import json
import random
import urllib.request

import pytest
from torch_port_cases import (
    fleet_packages,
    jax_variables,
    trials,
)

PKGS = fleet_packages()
SPAN_NAMES = ("router.request", "router.dispatch", "router.retry",
              "replica.request", "http.parse", "queue.wait",
              "batch.forward", "engine.forward", "batch.scatter")


def _hex(rng, n):
    return "".join(rng.choice("0123456789abcdef") for _ in range(n))


def write_seeded_journals(root, seed: int, n_traces: int = 6):
    """A router journal and two replica journals of sampled request trees,
    drawn from ``seed``: dispatch, an occasional failover retry, the
    replica's spans parented across processes, a shared batch forward
    linking the traces it served, one orphan, and a torn last line."""
    rng = random.Random(seed)
    journal = PKGS["port"].journal
    router = journal.RunJournal(root, run_id="router")
    replicas = [journal.RunJournal(root, run_id=f"replica{i}")
                for i in range(2)]
    t = 1_700_000_000.0
    batch_traces = []
    for _ in range(n_traces):
        trace_id = _hex(rng, 32)
        t += rng.uniform(0.01, 0.2)

        def span(jr, name, parent, start, dur, **attrs):
            span_id = _hex(rng, 16)
            fields = dict(name=name, trace_id=trace_id, span_id=span_id,
                          start=round(start, 6), dur_ms=round(dur, 3),
                          status="ok", **attrs)
            if parent is not None:
                fields["parent_span_id"] = parent
            jr.event("span", **fields)
            return span_id

        root_id = span(router, "router.request", None, t, 9.0,
                       route="/predict")
        dispatch = span(router, "router.dispatch", root_id, t + 0.0005,
                        8.0, replica="r0", attempts=1)
        parent = dispatch
        target = replicas[rng.randrange(2)]
        if rng.random() < 0.4:
            parent = span(router, "router.retry", dispatch, t + 0.002, 5.0,
                          replica="r1", attempt=1)
        req = span(target, "replica.request", parent, t + 0.003, 4.0)
        span(target, "http.parse", req, t + 0.0031, 0.2)
        span(target, "queue.wait", req, t + 0.0034, rng.uniform(0.1, 2))
        batch_traces.append((trace_id, target))
        if rng.random() < 0.3:
            span(target, "engine.forward", _hex(rng, 16), t + 0.004, 0.5)
    # One shared forward under the first trace, linking the others it
    # carried, and a span pointing at another trace's span.
    first_trace, target = batch_traces[0]
    target.event("span", name="batch.forward", trace_id=first_trace,
                 span_id=_hex(rng, 16), start=t + 0.01, dur_ms=1.5,
                 status="ok",
                 link_traces=[tid for tid, _ in batch_traces[1:4]])
    for jr in (router, *replicas):
        jr.run_end(status="ok")
    with open(replicas[1].events_path, "a") as f:
        f.write('{"event": "span", "name": "torn')
    bad = root / "broken"
    bad.mkdir()
    (bad / "events.jsonl").write_text("not json\n{}\n")
    return [router, *replicas]


def _tree_fields(tree):
    return {**dataclasses.asdict(tree), "processes": tree.processes,
            "span_names": sorted(tree.span_names),
            "duration_ms": tree.duration_ms,
            "complete": tree.cross_process_complete()}


def _read_all(pkg, paths):
    spans = pkg.trace.read_spans(paths)
    trees = pkg.trace.build_traces(spans)
    return (spans, {k: _tree_fields(v) for k, v in trees.items()},
            pkg.trace.chrome_trace_events(trees))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("how", ["root", "run_dirs", "files"])
def test_reader_equals_jax_on_seeded_journals(seed, how, tmp_path):
    journals = write_seeded_journals(tmp_path, seed)
    paths = {"root": [tmp_path],
             "run_dirs": [jr.dir for jr in journals],
             "files": [jr.events_path for jr in journals]}[how]
    port, ref = (_read_all(PKGS[k], paths) for k in ("port", "jax"))
    assert port == ref
    spans, trees, chrome = port
    assert {s["run_id"] for s in spans} == {"router", "replica0",
                                            "replica1"}
    assert all(t["complete"] for t in trees.values())
    assert any(t["linked"] for t in trees.values())
    assert json.loads(json.dumps(chrome)) == chrome


C, T, F1, D = 4, 64, 4, 2
META = {"model": "eegnet", "n_channels": C, "n_times": T, "F1": F1, "D": D}


def test_live_fleet_traces_parent_router_to_replica(tmp_path):
    from eegnetreplication_tpu_torch.serve import fleet as port_fleet
    from eegnetreplication_tpu_torch.serve.service import ServeApp
    from eegnetreplication_tpu_torch.training.checkpoint import (
        from_jax_variables,
        save_checkpoint,
    )

    port = PKGS["port"]
    params, bs = jax_variables(C, T, F1, D, seed=41)
    ckpt = save_checkpoint(tmp_path / "m.npz", from_jax_variables(params, bs),
                           metadata=dict(META))
    apps, journals = [], []
    try:
        for i in range(2):
            jr = port.journal.RunJournal(tmp_path / "obs", run_id=f"r{i}")
            journals.append(jr)
            apps.append(ServeApp(ckpt, port=0, device="cpu", buckets=(1, 8),
                                 trace_sample=1.0, journal=jr).start())
        with port.journal.run(tmp_path / "obs", run_id="router",
                              config={}) as jr:
            replicas = port.fleet.replica_specs([a.url for a in apps],
                                                journal=jr)
            app = port_fleet.FleetApp(replicas, str(ckpt), port=0,
                                      poll_s=0.05, trace_sample=1.0,
                                      journal=jr)
            app.membership.poll_once()
            app.start()
            try:
                for n in (1, 3, 2, 5):
                    req = urllib.request.Request(
                        app.url + "/predict",
                        data=json.dumps({"trials": trials(
                            n, C, T, seed=n).tolist()}).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=30) as resp:
                        assert resp.status == 200
            finally:
                app.stop()
    finally:
        for a, j in zip(apps, journals):
            a.stop()
            j.run_end(status="ok")
    port_out, jax_out = (_read_all(PKGS[k], [tmp_path / "obs"])
                         for k in ("port", "jax"))
    assert port_out == jax_out
    spans, trees, _ = port_out
    assert len(trees) == 4
    by_id = {s["span_id"]: s for s in spans}
    for tree in trees.values():
        assert [r["name"] for r in tree["roots"]] == ["router.request"]
        assert tree["complete"]
        (req,) = [s for s in tree["spans"] if s["name"] == "replica.request"]
        parent = by_id[req["parent_span_id"]]
        assert parent["name"] == "router.dispatch"
        assert parent["run_id"] == "router" and req["run_id"] in ("r0", "r1")
        # Every span but the root hangs off a span of the same trace.
        ids = {s["span_id"] for s in tree["spans"]}
        assert all(s.get("parent_span_id") in ids for s in tree["spans"]
                   if s["name"] != "router.request")
