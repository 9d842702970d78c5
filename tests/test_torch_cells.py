"""The port's cell tier against the JAX package's, on the CPU.

- Twin runs: each scenario drives one package's ``CellMembership`` and
  ``CellFront`` over the same scripted cells
  (``torch_port_cases.FakeCell``) and returns its decisions; the port must
  return the JAX package's decisions and write the same journal (event
  names, key sets and every field that does not vary between runs, in
  order per cell).  The scenarios are those of ``tests/test_cells.py``: a
  dark cell failed and rejoined, an aggregate-SLO breach and a 503
  degrading a cell, ``cell.partition:if_tag=c1`` failing exactly one
  cell, least-loaded ``/predict`` with the pinned header set on a
  dispatch and on a failover retry, 503 with no live cell, sticky
  affinity and an anonymous open, drain migration and a tampered import
  refused, a killed cell failing its session over from the spool (with
  the 409 resync handshake), from the mirror when the spool is corrupt,
  and reopened from zero without a spool; ``event_summary`` and
  ``obs.agg`` over the journals.
- The cells parser has the JAX parser's 17 flags, names and defaults (and
  the same AST count of ``add_argument``), refuses the same bad settings,
  and a host without CUDA stops it before a cell is spawned unless
  ``EEGTPU_PLATFORM=cpu``; its spawned cells are the port's processes.
- One CLI run on the CPU: ``python -m eegnetreplication_tpu_torch.serve.cells
  --cells 2`` over a checkpoint the JAX package wrote answers ``/predict``
  with the JAX engine's predictions, drains a live session across cells,
  and exits 75 on SIGTERM with a complete journal.
"""

import argparse
import ast
import json
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
    VOLATILE_FIELDS,
    FakeCell,
    cells_packages,
    child_env,
    jax_model,
    jax_variables,
    journal_sequence,
    journal_views,
    session_state,
    tamper_payload_array,
    trials,
)

REPO = Path(__file__).resolve().parents[1]
PKGS = cells_packages()
CELL_EVENTS = ("cell_front_start", "cell_member", "session_migrate",
               "session_failover", "cell_front_end", "fleet_retry",
               "fault_injected", "spool_mirror", "circuit_state",
               "request")
# Paths and URLs of the scripted cells differ between the two runs.
CELL_VOLATILE = VOLATILE_FIELDS | {"cells", "spool", "path",
                                   "quarantined_to"}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")


def twin(scenario, tmp_path, kinds=CELL_EVENTS):
    """Run ``scenario(pkg, journal)`` under both packages; the port's
    decisions and journal must equal the JAX package's."""
    out = {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key, config={}) as jr:
            decisions = scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        out[key] = (decisions, journal_sequence(events, kinds,
                                                volatile=CELL_VOLATILE))
    assert out["port"][0] == out["jax"][0]
    views = {k: journal_views(v[1], member_keys=("cell", "replica"))
             for k, v in out.items()}
    assert views["port"] == views["jax"]
    return out["port"]


def _members(pkg, fakes, jr, spools=None, mirrors=None):
    spools = spools or [None] * len(fakes)
    mirrors = mirrors or [None] * len(fakes)
    return [pkg.cms.CellMember(f"c{i}", fake.url, spool=spool,
                               mirror=mirror, journal=jr)
            for i, (fake, spool, mirror)
            in enumerate(zip(fakes, spools, mirrors))]


def _front(pkg, fakes, jr, spools=None, mirrors=None, **kw):
    front = pkg.front.CellFront(_members(pkg, fakes, jr, spools, mirrors),
                                port=0, poll_s=60.0, journal=jr, **kw)
    front.membership.poll_once()
    front.start()
    return front


def _http(url, data=None, ctype="application/json", headers=None):
    """``(status, JSON body)`` of a GET (``data`` None) or a POST."""
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": ctype, **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode() or "{}")


def _wait(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


class _Stopping:
    def __init__(self, *fakes):
        self.fakes = fakes

    def __enter__(self):
        return self.fakes

    def __exit__(self, *exc):
        for f in self.fakes:
            f.stop()


# -- cell membership ------------------------------------------------------------

def dark_cell_fails_and_rejoins(pkg, jr):
    fake0, fake1 = FakeCell(), FakeCell()
    membership = pkg.cms.CellMembership(_members(pkg, [fake0, fake1], jr),
                                        journal=jr)
    try:
        membership.poll_once()
        states = [[c.state for c in membership.replicas]]
        port = fake0.port
        fake0.stop()
        membership.poll_once()
        states.append(membership.by_id("c0").state)
        membership.poll_once()
        states.append((membership.by_id("c0").state,
                       [c.cell_id for c in membership.dispatchable()]))
        with _Stopping(FakeCell(port=port)):
            membership.poll_once()
            states.append(membership.by_id("c0").state)
        return states
    finally:
        fake1.stop()
        membership.close()


def slo_breach_and_503_degrade(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        membership = pkg.cms.CellMembership(
            _members(pkg, [fake0, fake1], jr), journal=jr)
        try:
            membership.poll_once()
            cell = membership.by_id("c0")
            fake0.slo_any_breached = True
            membership.poll_once()
            states = [(cell.state, cell.slo_any_breached,
                       [c.cell_id for c in membership.dispatchable()])]
            fake0.slo_any_breached = False
            membership.poll_once()
            states.append(cell.state)
            fake0.degraded = ["circuit_open"]
            membership.poll_once()
            states.append(cell.state)
            fake0.degraded = []
            membership.poll_once()
            states.append(cell.state)
            return states
        finally:
            membership.close()


def partition_fails_one_tagged_cell(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        membership = pkg.cms.CellMembership(
            _members(pkg, [fake0, fake1], jr), journal=jr)
        try:
            membership.poll_once()
            plan = pkg.inject.parse_plan("cell.partition:if_tag=c1:times=0")
            with pkg.inject.scoped(*plan):
                membership.poll_once()
                membership.poll_once()
                states = [(c.cell_id, c.state) for c in membership.replicas]
            membership.poll_once()
            states.append(membership.by_id("c1").state)
            return states
        finally:
            membership.close()


# -- the front: bulk routing ----------------------------------------------------

PINNED_HEADERS = {
    "X-Model": "subject3",
    "X-Deadline-Ms": "750",
    "X-Priority": "high",
    "X-Trace-Id": "0123456789abcdef",
    "X-Trace-Sampled": "1",
}


def _sent_pinned(fake) -> dict:
    sent = [h for p, h in fake.headers_log if p == "/predict"][0]
    return {k: sent.get(k) for k in PINNED_HEADERS}


def predict_forwards_pinned_headers(pkg, jr):
    with _Stopping(FakeCell()) as (fake,):
        front = _front(pkg, [fake], jr)
        try:
            status, _ = _http(front.url + "/predict",
                              json.dumps({"trials": []}).encode(),
                              headers=PINNED_HEADERS)
            return status, _sent_pinned(fake)
        finally:
            front.stop()


def failover_retry_forwards_pinned_headers(pkg, jr):
    fake0, fake1 = FakeCell(), FakeCell()
    with _Stopping(fake1):
        front = _front(pkg, [fake0, fake1], jr)
        try:
            fake0.stop()  # c0, the first least-loaded pick, dies on contact
            status, _ = _http(front.url + "/predict",
                              json.dumps({"trials": []}).encode(),
                              headers=PINNED_HEADERS)
            return (status, _sent_pinned(fake1),
                    front.membership.by_id("c0").state)
        finally:
            front.stop()


def predict_routes_least_loaded(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        fake0.queue_depth = 50
        front = _front(pkg, [fake0, fake1], jr)
        try:
            front.membership.poll_once()
            answers = [_http(front.url + "/predict",
                             json.dumps({"trials": []}).encode())
                       for _ in range(3)]
            return answers, len(fake0.posts("/predict")), \
                len(fake1.posts("/predict"))
        finally:
            front.stop()


def no_live_cell_is_503(pkg, jr):
    with _Stopping(FakeCell()) as (fake,):
        front = _front(pkg, [fake], jr)
        try:
            fake.degraded = ["wedged"]
            front.membership.poll_once()
            return _http(front.url + "/predict", b"{}")
        finally:
            front.stop()


# -- the front: sessions --------------------------------------------------------

def sticky_affinity_and_close(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        front = _front(pkg, [fake0, fake1], jr)
        try:
            _, opened = _http(front.url + "/session/open",
                              json.dumps({"session": "s1"}).encode())
            home = opened["cell"]
            codes = [_http(front.url + "/session/s1/samples", b"{}")[0]
                     for _ in range(3)]
            fakes = {"c0": fake0, "c1": fake1}
            counts = {cid: len(f.posts("/samples"))
                      for cid, f in fakes.items()}
            closed = _http(front.url + "/session/s1/close", b"{}")[0]
            after = _http(front.url + "/session/s1/samples", b"{}")[0]
            return home, codes, counts, closed, front.cell_of("s1"), after
        finally:
            front.stop()


def anonymous_open_gets_a_front_id(pkg, jr):
    with _Stopping(FakeCell()) as (fake,):
        front = _front(pkg, [fake], jr)
        try:
            status, opened = _http(front.url + "/session/open", b"{}")
            sid = opened["session"]
            return (status, len(sid), sid != "anon",
                    front.cell_of(sid).cell_id == opened["cell"])
        finally:
            front.stop()


def drain_migrates_and_undrains(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        front = _front(pkg, [fake0, fake1], jr)
        try:
            _, opened = _http(front.url + "/session/open",
                              json.dumps({"session": "s1"}).encode())
            fakes = {"c0": fake0, "c1": fake1}
            home = opened["cell"]
            target = "c1" if home == "c0" else "c0"
            status, result = _http(f"{front.url}/cell/{home}/drain", b"{}")
            out = [home, status, result, len(fakes[target].imports),
                   len(fakes[home].posts("/discard"))]
            out.append(_http(front.url + "/session/s1/samples", b"{}")[0])
            out.append((len(fakes[target].posts("/samples")),
                        len(fakes[home].posts("/samples"))))
            out.append(front.membership.by_id(home).state)
            front.membership.poll_once()   # the drain is pinned
            out.append(front.membership.by_id(home).state)
            out.append(_http(f"{front.url}/cell/{home}/undrain", b"{}"))
            front.membership.poll_once()
            out.append(front.membership.by_id(home).state)
            return out
        finally:
            front.stop()


def tampered_import_refused(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        front = _front(pkg, [fake0, fake1], jr)
        try:
            _, opened = _http(front.url + "/session/open",
                              json.dumps({"session": "s1"}).encode())
            fakes = {"c0": fake0, "c1": fake1}
            home = opened["cell"]
            good = pkg.store.pack_session("s1", session_state("s1"))
            fakes[home].export_payload = tamper_payload_array(
                good, "s/s1/buf.npy")
            status, result = _http(f"{front.url}/cell/{home}/drain", b"{}")
            return (home, status, result, front.cell_of("s1").cell_id,
                    len(fakes[home].posts("/discard")))
        finally:
            front.stop()


def _spool(pkg, root: Path, sid="s1", mirror=None) -> Path:
    """A cell's spool holding ``sid`` at acked 160, written by the
    package's own session store (and its mirror, if given)."""
    kw = {"device": "cpu"} if pkg.name == "port" else {}
    store = pkg.store.SessionStore(
        root / "r0" / "sessions.npz",
        mirror=(mirror / "r0" / "sessions.npz") if mirror else None, **kw)
    store._sessions[sid] = pkg.session.StreamSession.from_state(
        sid, session_state(sid), **kw)
    store.snapshot()
    store.detach()
    return root


def _until_code(url, want, data=b"{}", timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    code = None
    while time.monotonic() < deadline:
        code = _http(url, data)[0]
        if code == want:
            break
        time.sleep(0.05)
    return code


def _killed_home(pkg, jr, spools, mirrors=None):
    """Open s1 on c0 of two cells, then kill c0; the front and the
    survivor."""
    fake0, fake1 = FakeCell(), FakeCell()
    front = _front(pkg, [fake0, fake1], jr, spools=spools, mirrors=mirrors)
    fake1.queue_depth = 99   # pin the session's home to c0
    front.membership.poll_once()
    _, opened = _http(front.url + "/session/open",
                      json.dumps({"session": "s1"}).encode())
    fake1.queue_depth = 0
    fake0.stop()
    return front, fake1, opened["cell"]


def failover_from_the_spool(pkg, jr):
    spool = _spool(pkg, Path(jr.dir) / "c0_spool")
    front, fake1, home = _killed_home(pkg, jr, [spool, None])
    try:
        # First touch meets the dead cell: 503 while the front reacts.
        first = _http(front.url + "/session/s1/samples", b"{}")[0]
        state_now = front.membership.by_id("c0").state
        latch = _until_code(front.url + "/session/s1/samples", 409)
        state = _http(front.url + "/session/s1/state")
        after = _http(front.url + "/session/s1/samples", b"{}")[0]
        return (home, first, state_now, latch, len(fake1.imports), state,
                after, len(fake1.posts("/samples")))
    finally:
        front.stop()
        fake1.stop()


def failover_from_the_mirror(pkg, jr):
    root = Path(jr.dir)
    spool = _spool(pkg, root / "c0_spool", mirror=root / "c0_mirror")
    primary = spool / "r0" / "sessions.npz"
    primary.write_bytes(primary.read_bytes()[:200])   # a torn primary
    front, fake1, home = _killed_home(pkg, jr, [spool, None],
                                      [root / "c0_mirror", None])
    try:
        first = _http(front.url + "/session/s1/samples", b"{}")[0]
        latch = _until_code(front.url + "/session/s1/samples", 409)
        state = _http(front.url + "/session/s1/state")
        return home, first, latch, len(fake1.imports), state
    finally:
        front.stop()
        fake1.stop()


def failover_without_a_spool_reopens(pkg, jr):
    front, fake1, home = _killed_home(pkg, jr, None)
    try:
        front.membership.poll_once()
        front.membership.poll_once()
        failed = front.membership.by_id("c0").state
        moved = _wait(lambda: front.cell_of("s1").cell_id == "c1")
        state = _http(front.url + "/session/s1/state")[0]
        reopened = _http(front.url + "/session/open",
                         json.dumps({"session": "s1"}).encode())
        after = _http(front.url + "/session/s1/samples", b"{}")[0]
        return home, failed, moved, len(fake1.imports), state, reopened, \
            after
    finally:
        front.stop()
        fake1.stop()


def healthz_reports_cells_and_sessions(pkg, jr):
    with _Stopping(FakeCell(), FakeCell()) as (fake0, fake1):
        front = _front(pkg, [fake0, fake1], jr)
        try:
            _http(front.url + "/session/open",
                  json.dumps({"session": "s1"}).encode())
            status, health = _http(front.url + "/healthz")
            return (status, health["role"], health["leader"],
                    health["n_cells"], health["n_live"], health["sessions"],
                    sorted(c["cell"] for c in health["cells"]))
        finally:
            front.stop()


SCENARIOS = {
    "dark_cell_fails_and_rejoins": dark_cell_fails_and_rejoins,
    "slo_breach_and_503_degrade": slo_breach_and_503_degrade,
    "partition_fails_one_tagged_cell": partition_fails_one_tagged_cell,
    "predict_forwards_pinned_headers": predict_forwards_pinned_headers,
    "failover_retry_forwards_pinned_headers":
        failover_retry_forwards_pinned_headers,
    "predict_routes_least_loaded": predict_routes_least_loaded,
    "no_live_cell_is_503": no_live_cell_is_503,
    "sticky_affinity_and_close": sticky_affinity_and_close,
    "anonymous_open_gets_a_front_id": anonymous_open_gets_a_front_id,
    "drain_migrates_and_undrains": drain_migrates_and_undrains,
    "tampered_import_refused": tampered_import_refused,
    "failover_from_the_spool": failover_from_the_spool,
    "failover_from_the_mirror": failover_from_the_mirror,
    "failover_without_a_spool_reopens": failover_without_a_spool_reopens,
    "healthz_reports_cells_and_sessions":
        healthz_reports_cells_and_sessions,
}

# What each scenario must decide, beyond agreeing with the JAX package.
EXPECTED = {
    "dark_cell_fails_and_rejoins": [["live", "live"], "live",
                                    ("failed", ["c1"]), "live"],
    "slo_breach_and_503_degrade": [("degraded", True, ["c1"]), "live",
                                   "degraded", "live"],
    "partition_fails_one_tagged_cell": [("c0", "live"), ("c1", "failed"),
                                        "live"],
    "predict_forwards_pinned_headers": (200, PINNED_HEADERS),
    "failover_retry_forwards_pinned_headers": (200, PINNED_HEADERS,
                                               "failed"),
    "no_live_cell_is_503": (503, {"error": "no live cells"}),
    "anonymous_open_gets_a_front_id": (200, 12, True, True),
    "healthz_reports_cells_and_sessions": (200, "active", None, 2, 2, 1,
                                           ["c0", "c1"]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_decides_as_jax(name, tmp_path):
    decisions, journal = twin(SCENARIOS[name], tmp_path)
    if name in EXPECTED:
        assert decisions == EXPECTED[name]
    if name == "predict_routes_least_loaded":
        answers, to_busy, to_idle = decisions
        assert [a[0] for a in answers] == [200] * 3
        assert (to_busy, to_idle) == (0, 3)
    if name == "sticky_affinity_and_close":
        home, codes, counts, closed, cell, after = decisions
        assert codes == [200] * 3 and counts[home] == 3
        assert sum(counts.values()) == 3
        assert (closed, cell, after) == (200, None, 404)
    if name == "drain_migrates_and_undrains":
        (home, status, result, imports, discards, after, pushes,
         pinned, still, undrain, live) = decisions
        assert status == 200 and result["migrated"] == ["s1"]
        assert imports == 1 and discards == 1 and after == 200
        assert pushes == (1, 0)
        assert (pinned, still, live) == ("draining", "draining", "live")
        assert undrain[0] == 200
        migrations = [dict(e[2]) for e in journal
                      if e[0] == "session_migrate"]
        assert len(migrations) == 1
    if name == "tampered_import_refused":
        home, status, result, cell, discards = decisions
        assert status == 207 and result["failed"] == ["s1"]
        assert cell == home and discards == 0
        assert not [e for e in journal if e[0] == "session_migrate"]
    if name in ("failover_from_the_spool", "failover_from_the_mirror"):
        home, first, *_ = decisions
        assert (home, first) == ("c0", 503)
        kinds = [e[0] for e in journal]
        failed_at = min(i for i, e in enumerate(journal)
                        if e[0] == "cell_member"
                        and dict(e[2])["state"] == "'failed'")
        assert failed_at < kinds.index("session_failover")
        failover = dict(next(e for e in journal
                             if e[0] == "session_failover")[2])
        assert (failover["restored"], failover["acked"]) == ("True", "160")
    if name == "failover_from_the_spool":
        _, _, state_now, latch, imports, state, after, pushes = decisions
        assert (state_now, latch, imports, after, pushes) == (
            "failed", 409, 1, 200, 1)
        assert state[0] == 200 and state[1]["acked"] == 160
    if name == "failover_from_the_mirror":
        _, _, latch, imports, state = decisions
        assert (latch, imports) == (409, 1)
        assert state[0] == 200 and state[1]["acked"] == 160
        assert any(e[0] == "spool_mirror" for e in journal)
    if name == "failover_without_a_spool_reopens":
        home, failed, moved, imports, state, reopened, after = decisions
        assert (home, failed, moved, imports, state) == ("c0", "failed",
                                                         True, 0, 404)
        assert reopened[0] == 200 and reopened[1]["acked"] == 0
        assert reopened[1]["cell"] == "c1" and after == 200


def test_event_summary_and_agg_read_a_cells_journal_as_jax(tmp_path):
    def scenario(pkg, jr):
        drain_migrates_and_undrains(pkg, jr)
        failover_from_the_spool(pkg, jr)

    summaries, folds = {}, {}
    for key, pkg in PKGS.items():
        with pkg.journal.run(tmp_path / key / "f0_obs", config={}) as jr:
            scenario(pkg, jr)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        summary = pkg.schema.event_summary(events)
        summaries[key] = {k: summary.get(k) for k in (
            "cells", "cell_member_transitions", "cells_failed",
            "session_migrations", "session_failovers", "spool_errors")}
        snap = pkg.agg.Aggregator([tmp_path / key]).poll()
        (run,) = snap["runs"]
        folds[key] = {k: v for k, v in run.items()
                      if k in ("cells", "role", "status", "sessions")}
    assert summaries["port"] == summaries["jax"]
    assert summaries["port"]["cells"] == 2
    assert summaries["port"]["session_migrations"] == 1
    assert summaries["port"]["session_failovers"] == 1
    assert folds["port"] == folds["jax"]


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


def test_cells_have_the_jax_cell_tiers_17_flags(monkeypatch):
    port = _parser_of(PKGS["port"].cells.main, monkeypatch)
    ref = _parser_of(PKGS["jax"].cells.main, monkeypatch)

    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings
                      if o.startswith("--") and o != "--help")

    assert flags(port) == flags(ref)
    assert len(flags(port)) == 17
    for argv in (["--checkpoint", "m.npz"],
                 ["--attachCells", "c0|http://h:1|/s", "--ha", "d",
                  "--haOwner", "f1", "--haTtlS", "2", "--replicasPerCell",
                  "2", "--outlierK", "3"]):
        assert vars(port.parse_args(argv)) == vars(ref.parse_args(argv))
    src = REPO / "eegnetreplication_tpu_torch/serve/cells/service.py"
    jax_src = REPO / "eegnetreplication_tpu/serve/cells/service.py"
    assert _ast_flags(src) == _ast_flags(jax_src)
    assert len(_ast_flags(src)) == 17


@pytest.mark.parametrize("argv", [
    ["--checkpoint", "m.npz", "--cells", "0"],
    ["--checkpoint", "m.npz", "--replicasPerCell", "0"],
    ["--cells", "2"],
    ["--attachCells", "c0|http://h:1"],
    ["--checkpoint", "m.npz", "--slo", "latency<5"],
])
def test_bad_cell_settings_stop_the_cli_as_jax(argv, capsys):
    errors = []
    for key in ("port", "jax"):
        with pytest.raises(SystemExit) as exit_:
            PKGS[key].cells.main(argv)
        assert exit_.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ", 1)[1] == \
        errors[1].split("error: ", 1)[1]


def test_the_cells_refuse_a_host_without_cuda(monkeypatch, tmp_path):
    """No CPU fallback: without ``EEGTPU_PLATFORM=cpu`` a host with no
    CUDA stops the front before it spawns a cell."""
    import torch

    monkeypatch.delenv("EEGTPU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        PKGS["port"].cells.main(["--checkpoint", "m.npz", "--metricsDir",
                                 str(tmp_path / "obs"), "--cellsDir",
                                 str(tmp_path / "cells")])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("replicas_per_cell", [1, 2])
def test_a_spawned_cell_is_a_port_process(replicas_per_cell, tmp_path,
                                          monkeypatch):
    monkeypatch.delenv("EEGTPU_PLATFORM", raising=False)
    factory = PKGS["port"].cells.make_spec_factory(
        run_dir=tmp_path, cells_dir=tmp_path / "cells",
        replicas_per_cell=replicas_per_cell, mirror=True)
    spec_fn, spool, mirror = factory("c0", 1234)
    spec = spec_fn("m.npz", ["--traceSample", "0.1"])
    module = ("eegnetreplication_tpu_torch.serve" if replicas_per_cell == 1
              else "eegnetreplication_tpu_torch.serve.fleet")
    assert spec.cmd[1:3] == ["-m", module]
    assert all("eegnetreplication_tpu." not in part for part in spec.cmd)
    assert spool == tmp_path / "cells" / "c0" / "sessions"
    assert spec.env is None or "EEGTPU_PLATFORM" not in spec.env
    jax_spec, _, _ = PKGS["jax"].cells.make_spec_factory(
        run_dir=tmp_path, cells_dir=tmp_path / "cells",
        replicas_per_cell=replicas_per_cell, mirror=True)("c0", 1234)
    jax_cmd = jax_spec("m.npz", ["--traceSample", "0.1"]).cmd
    assert spec.cmd[3:] == jax_cmd[3:]


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


def test_cells_cli_serves_and_drains_as_jax(tmp_path):
    from eegnetreplication_tpu.serve import engine as jax_engine
    from eegnetreplication_tpu.training import checkpoint as jax_ckpt

    params, bs = jax_variables(C, T, F1, D, seed=41)
    ckpt = jax_ckpt.save_checkpoint(tmp_path / "a.npz", params, bs,
                                    metadata=dict(META))
    x = trials(9, C, T, seed=43)
    log = tmp_path / "cells.log"
    env = child_env(EEGTPU_PLATFORM="cpu", EEGTPU_NO_LOG_FILE="1",
                    EEGTPU_DATA_ROOT=str(tmp_path))
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "eegnetreplication_tpu_torch.serve.cells",
             "--checkpoint", str(ckpt), "--cells", "2", "--port", "0",
             "--pollS", "0.1", "--cellsDir", str(tmp_path / "cells"),
             "--sessionSnapshotEvery", "2",
             "--metricsDir", str(tmp_path / "obs")],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        line = _wait_for_line(log, "cells serving at", proc, 150)
        url = line.split("cells serving at ", 1)[1].split()[0]
        code, health = _http(url + "/healthz")
        assert code == 200 and health["n_live"] == 2
        digest = jax_engine.variables_digest(params, bs)
        assert {c["digest"] for c in health["cells"]} == {digest}
        code, body = _http(url + "/predict",
                           json.dumps({"trials": x.tolist()}).encode())
        want = jax_engine.InferenceEngine(jax_model(C, T, F1, D), params,
                                          bs).infer(x)
        assert code == 200 and body["predictions"] == want.tolist()
        # A live session drained across cells continues where it was.
        code, opened = _http(url + "/session/open", json.dumps(
            {"session": "s1", "window": T, "hop": 16,
             "ems_init_block_size": 32}).encode())
        assert code == 200
        stream = np.random.RandomState(44).randn(C, 400).astype(np.float32)
        decisions = []
        for pos in range(0, 400, 40):
            if pos == 200:
                code, drained = _http(
                    f"{url}/cell/{opened['cell']}/drain", b"{}")
                assert code == 200 and drained["migrated"] == ["s1"]
            code, reply = _http(
                f"{url}/session/s1/samples",
                stream[:, pos:pos + 40].astype("<f4").tobytes(),
                ctype="application/octet-stream")
            assert code == 200
            decisions.extend(reply["decisions"])
        assert [d["window"] for d in decisions] == list(
            range((400 - T) // 16 + 1))
        assert all(d["status"] == "ok" for d in decisions)
        code, closed = _http(url + "/session/s1/close", b"{}")
        assert code == 200 and closed["preds"] == [d["pred"]
                                                   for d in decisions]
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=90)
    assert code == 75, log.read_text()[-3000:]
    schema = PKGS["port"].schema
    (run_dir,) = [d for d in (tmp_path / "obs").iterdir()
                  if (d / "events.jsonl").exists()]
    events = schema.read_events(run_dir / "events.jsonl")
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert {"cell_front_start", "cell_member", "session_migrate",
            "cell_front_end", "supervisor_start",
            "supervisor_end"} <= set(kinds)
    # Both cells ran the port's server and ended their journals.
    for cell in ("c0", "c1"):
        (cell_run,) = list((run_dir / f"{cell}_obs").iterdir())
        rows = schema.read_events(cell_run / "events.jsonl")
        assert rows[-1]["event"] == "run_end"
