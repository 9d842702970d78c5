"""The port's contract linter (``eegnetreplication_tpu_torch/analysis``)
against the JAX package's (``eegnetreplication_tpu/analysis``).

- **Whole-tree gate.**  The port's CLI over the checkout (the port's
  package and ``chip_smoke.py``) with the port's baseline gives 0 new
  findings and 0 stale baseline entries, in under 10 s, and its ``--json``
  record has the JAX record's keys.
- **Same findings as the JAX linter.**  For the five passes both linters
  share (journal-events, inject-sites, spawn-args, lock-discipline,
  single-source), the port's findings over the port's package equal, in
  ``(rule, file, line, symbol, message)``, those of the JAX linter
  configured for the port as ``tests/test_torch_lint.py::port_lint``
  configures it.
- **Fixture parity.**  Every per-rule fixture of ``tests/test_lint.py``
  for those passes (its baseline, suppression and contract cases too) is
  run as that file runs it, against the JAX linter; the tree it builds is
  then written once under each package's name, and both linters give the
  same findings (the package name substituted).  Its CLI cases (exit
  codes, the pass subset, the usage errors) give the same exit codes and
  messages through both CLIs.  The one wording the port changes: the
  header-set message names the dropped-``X-Model`` fault without the JAX
  history's change number.
- **``jit-purity`` over CUDA graph captures.**  Bad and good fixtures of
  each root (a ``capture_begin``/``capture_end`` window, a
  ``torch.cuda.graph`` body, ``make_graphed_callables``), the one-level
  callee, ``self._graph_forward`` resolved as a method and as an assigned
  function, aliased clock imports, and device RNG left alone.  A copy of
  the package with ``logger.info`` inside ``serve/engine.py``'s
  ``_graph_forward``, inside ``_capture``'s window, or inside the zoo's
  ``StackedEngine._graph_forward`` gives exactly one ``jit-impure``; with
  the ``self.<name>`` resolution cut out, the ``_graph_forward`` mutation
  gives none.
"""

import inspect
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import test_lint as jax_fixtures
from test_torch_lint import port_lint  # noqa: F401 — the fixture
from torch_port_cases import child_env  # noqa: F401 — one torch thread

from eegnetreplication_tpu.analysis import cli as jax_cli
from eegnetreplication_tpu.analysis.runner import run_all as jax_run_all
from eegnetreplication_tpu_torch.analysis import cli, core, jit_purity
from eegnetreplication_tpu_torch.analysis.core import (
    Contracts,
    Project,
    apply_baseline,
    load_baseline,
)
from eegnetreplication_tpu_torch.analysis.runner import PASSES, run_all

REPO = Path(__file__).resolve().parents[1]
PORT = "eegnetreplication_tpu_torch"
JAX = "eegnetreplication_tpu"
SHARED = ("journal-events", "inject-sites", "spawn-args", "lock-discipline",
          "single-source")
BASELINE = REPO / core.BASELINE_REL


def to_port(text: str) -> str:
    """The JAX package's name replaced by the port's in a path or text."""
    return re.sub(rf"\b{JAX}(?!_torch)", PORT, text)


def rows(findings, rename=False):
    """Comparable findings; ``rename`` moves JAX names to the port's and
    drops the change number from the header-set message's history."""
    out = []
    for f in findings:
        row = (f.rule, f.file, f.line, f.symbol, f.message, f.severity)
        if rename:
            row = tuple(to_port(x) if isinstance(x, str) else x
                        for x in row)
            row = row[:4] + (re.sub(r"the PR-\d+ dropped", "the dropped",
                                    row[4]),) + row[5:]
        out.append(row)
    return sorted(out)


# --- the gate ---------------------------------------------------------------

def test_the_checkout_lints_clean_under_the_ports_baseline(capsys):
    t0 = time.monotonic()
    rc = cli.main(["--root", str(REPO), "--json"])
    wall = time.monotonic() - t0
    record = json.loads(capsys.readouterr().out)
    assert rc == 0, [f for f in record["findings"] if not f["baselined"]]
    assert record["counts"]["new"] == 0
    assert record["counts"]["stale_baseline"] == 0
    assert record["passes"] == list(PASSES) and len(PASSES) == 6
    assert wall < 10.0, f"lint took {wall:.1f}s (budget 10s)"
    jax_rc = jax_cli.main(["--root", str(REPO), "--json",
                           "--passes", "single-source"])
    jax_record = json.loads(capsys.readouterr().out)
    assert jax_rc == 0
    assert set(record) == set(jax_record)
    assert record["schema_version"] == jax_record["schema_version"] == 1
    for f in record["findings"]:
        assert set(f) == {"rule", "file", "line", "symbol", "message",
                          "severity", "baselined"}
    # Exceptions only, each justified, all keyed to the port's schema.
    baseline = load_baseline(BASELINE)
    assert len(baseline) == 12
    for entry in baseline.values():
        assert entry.get("why"), entry
        assert entry["file"] == f"{PORT}/obs/schema.py"
    jax_entries = json.loads((REPO / "lint_baseline.json").read_text())
    assert sorted((e["rule"], e["symbol"], e["why"])
                  for e in jax_entries["findings"]) \
        == sorted((e["rule"], e["symbol"], e["why"])
                  for e in baseline.values())


def test_the_linter_scans_the_package_and_the_smoke():
    project = Project.scan(REPO)
    rels = {sf.rel for sf in project.files}
    assert "chip_smoke.py" in rels
    assert f"{PORT}/serve/engine.py" in rels
    assert not any(r.startswith((f"{JAX}/", "tests/", "scripts/"))
                   for r in rels)
    assert core.DEFAULT_ROOTS == (PORT, "chip_smoke.py")
    assert (core.SCHEMA_REL, core.INJECT_REL, core.SERVICE_REL) == (
        f"{PORT}/obs/schema.py", f"{PORT}/resil/inject.py",
        f"{PORT}/serve/service.py")


def test_the_same_findings_as_the_jax_linter(port_lint):  # noqa: F811
    project = Project.scan(REPO, roots=(PORT,))
    ours = run_all(REPO, passes=SHARED, project=project,
                   contracts=Contracts.from_project(project))
    theirs = port_lint(REPO)
    assert rows(ours) == rows(theirs)
    assert len(ours) == 12   # the baselined unsummarized events


# --- fixture parity ---------------------------------------------------------

# tests/test_lint.py's classes whose fixtures drive the shared passes.
FIXTURE_CLASSES = ("TestJournalEventsPass", "TestInjectSitesPass",
                   "TestSpawnArgsPass", "TestLockDisciplinePass",
                   "TestSingleSourcePass", "TestBaselineAndCli")
# Cases that drive a CLI (compared below) or no tree of their own.
CLI_CASES = ("test_cli_exit_codes_and_outputs",
             "test_pass_subset_does_not_stale_other_passes_entries",
             "test_empty_passes_selection_is_a_usage_error",
             "test_malformed_baseline_is_a_usage_error",
             "test_baseline_and_no_baseline_conflict",
             "test_missing_explicit_baseline_is_a_usage_error",
             "test_default_root_refuses_non_checkout")


def _fixture_cases():
    cases = []
    for cls_name in FIXTURE_CLASSES:
        cls = getattr(jax_fixtures, cls_name)
        for name, fn in sorted(vars(cls).items()):
            if not name.startswith("test_") or name in CLI_CASES:
                continue
            params = [None]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    params = list(mark.args[1])
            cases += [pytest.param(cls_name, name, p,
                                   id=f"{name}" + (f"-{i}" if p else ""))
                      for i, p in enumerate(params)]
    return cases


def _snapshot(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_text()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _write(root: Path, tree: dict, rename: bool) -> Path:
    for rel, text in tree.items():
        path = root / (to_port(rel) if rename else rel)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(to_port(text) if rename else text)
    return root


@pytest.mark.parametrize("cls_name, name, param", _fixture_cases())
def test_every_shared_fixture_gives_the_same_findings(cls_name, name, param,
                                                      tmp_path, monkeypatch):
    """The JAX fixture runs as ``tests/test_lint.py`` runs it; each tree it
    builds is then linted under both names."""
    trees = []
    build = jax_fixtures.make_project

    def recording(root, *args, **kw):
        out = build(root, *args, **kw)
        trees.append(_snapshot(root))
        return out

    monkeypatch.setattr(jax_fixtures, "make_project", recording)
    case = getattr(getattr(jax_fixtures, cls_name)(), name)
    work = tmp_path / "fixture"
    work.mkdir()
    args = {"tmp_path": work}
    if param is not None:
        (extra,) = [p for p in inspect.signature(case).parameters
                    if p != "tmp_path"]
        args[extra] = param
    case(**args)
    assert trees, f"{name} built no tree"
    for i, tree in enumerate(trees):
        jax_root = _write(tmp_path / f"jax{i}", tree, rename=False)
        port_root = _write(tmp_path / f"port{i}", tree, rename=True)
        theirs = jax_run_all(jax_root, passes=SHARED)
        ours = run_all(port_root, passes=SHARED,
                       project=Project.scan(port_root,
                                            roots=(PORT, "scripts")))
        assert rows(ours) == rows(theirs, rename=True), (name, i)


def test_fixture_parity_covers_every_shared_fixture():
    names = {c.values[1] for c in _fixture_cases()}
    assert len(names) >= 30
    assert {"test_unknown_literal_flag_in_cmd_list_caught",
            "test_hand_spelled_header_dict_caught",
            "test_suppression_comment_silences_line",
            "test_baseline_grandfathers_and_stale_fails",
            "test_non_literal_contract_reported_once"} <= names


CLEAN_MOD = jax_fixtures.TestBaselineAndCli.CLEAN_MOD
BAD_MOD = CLEAN_MOD + 'def g(jr):\n    jr.event("odd_one")\n'
ODD_ONE = {"rule": "journal-event-unknown", "file": f"{JAX}/mod.py",
           "symbol": "odd_one", "why": "fixture"}


def _cli_tree(root: Path, mod: str, pkg: str) -> None:
    skeleton = {f"{JAX}/obs/schema.py": jax_fixtures.SCHEMA_SRC,
                f"{JAX}/resil/inject.py": jax_fixtures.INJECT_SRC,
                f"{JAX}/serve/service.py": jax_fixtures.SERVICE_SRC,
                f"{JAX}/mod.py": mod,
                "BENCH_NOTES.md": jax_fixtures.BENCH_NOTES_SRC}
    _write(root, skeleton, rename=pkg == PORT)


def _baseline_at(root: Path, pkg: str, content) -> Path:
    """Write a baseline where ``pkg``'s CLI reads it by default."""
    path = root / ("lint_baseline.json" if pkg == JAX else core.BASELINE_REL)
    path.parent.mkdir(parents=True, exist_ok=True)
    text = content if isinstance(content, str) else json.dumps(content)
    path.write_text(to_port(text) if pkg == PORT else text)
    return path


def _run_cli(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as exc:
        rc = exc.code
    out, err = capsys.readouterr()
    return rc, out, err


def _cli_story(pkg, main, root: Path, capsys, monkeypatch) -> list:
    """tests/test_lint.py's CLI cases on one package: what each returns."""
    r = str(root)
    story = []

    def step(argv, keep=lambda out, err: None):
        rc, out, err = _run_cli(main, argv, capsys)
        story.append((rc, keep(out, err)))

    counts = lambda out, err: json.loads(out)["counts"]  # noqa: E731
    _cli_tree(root, BAD_MOD, pkg)
    step(["--root", r], lambda out, err: "journal-event-unknown" in out)
    _baseline_at(root, pkg, {"findings": [ODD_ONE]})
    step(["--root", r])
    step(["--root", r, "--passes", "spawn-args", "--json"], counts)
    _cli_tree(root, CLEAN_MOD, pkg)
    step(["--root", r, "--json"], counts)
    step(["--root", r, "--passes", " , "],
         lambda out, err: "selected no passes" in err)
    step(["--root", r, "--no-baseline", "--baseline", r + "/b.json"],
         lambda out, err: "not allowed with" in err)
    step(["--root", r, "--baseline", r + "/typo.json"],
         lambda out, err: "does not exist" in err)
    for bad, marker in (({"findings": [{"file": "x", "why": "no rule"}]},
                         "needs 'rule' and 'symbol'"),
                        ("{not json", "not valid JSON"),
                        ([{"rule": "x", "symbol": "y"}], "'findings' list")):
        _baseline_at(root, pkg, bad)
        step(["--root", r], lambda out, err, m=marker: m in err)
    module = jax_cli if pkg == JAX else cli
    monkeypatch.setattr(module, "_default_root", lambda: root / "bare")
    (root / "bare" / pkg).mkdir(parents=True)
    step([], lambda out, err: "pyproject.toml" in err)
    return story


def test_both_clis_give_the_same_exit_codes(tmp_path, capsys, monkeypatch):
    jax = _cli_story(JAX, jax_cli.main, tmp_path / "jax", capsys,
                     monkeypatch)
    port = _cli_story(PORT, cli.main, tmp_path / "port", capsys,
                      monkeypatch)
    assert [rc for rc, _ in jax] == [1, 0, 0, 1, 2, 2, 2, 2, 2, 2, 2]
    assert port == jax
    assert all(kept is not False for _, kept in port)


# --- jit-purity over captures -----------------------------------------------

def _purity(tmp_path, src, extra=None):
    files = {f"{PORT}/mod.py": src, **(extra or {})}
    _write(tmp_path, files, rename=False)
    project = Project.scan(tmp_path)
    return [f for f in jit_purity.check(project, Contracts())]


CAPTURE_HEAD = (
    "import time\n"
    "import torch\n"
    "from eegnetreplication_tpu_torch.utils.logging import logger\n")

CAPTURES = {
    # a window with a wall clock
    "window_clock": (
        CAPTURE_HEAD
        + "def capture(model, x):\n"
          "    g = torch.cuda.CUDAGraph()\n"
          "    t0 = time.time()\n"
          "    g.capture_begin()\n"
          "    y = model(x) * time.time()\n"
          "    g.capture_end()\n"
          "    return g, y, time.time() - t0\n",
        [("capture:capture", "time.time", 8)]),
    # a torch.cuda.graph body that logs
    "graph_body_logger": (
        CAPTURE_HEAD
        + "def capture(model, x):\n"
          "    g = torch.cuda.CUDAGraph()\n"
          "    with torch.cuda.graph(g):\n"
          "        logger.info('captured')\n"
          "        y = model(x)\n"
          "    logger.info('done')\n"
          "    return g, y\n",
        [("capture:capture", "logger.info", 7)]),
    # one level of same-file callee, and no second level
    "callee": (
        CAPTURE_HEAD
        + "import random\n"
          "def deeper(x):\n"
          "    return x * random.random()\n"
          "def helper(x):\n"
          "    print('in the graph')\n"
          "    return deeper(x)\n"
          "def capture(x):\n"
          "    g = torch.cuda.CUDAGraph()\n"
          "    with torch.cuda.graph(g):\n"
          "        y = helper(x)\n"
          "    return g, y\n",
        [("capture:helper", "print(...)", 8)]),
    # self._graph_forward as a method of the class
    "self_method": (
        CAPTURE_HEAD
        + "class Engine:\n"
          "    def _graph_forward(self, x):\n"
          "        self.journal.event('forward', n=1)\n"
          "        return x\n"
          "    def _capture(self, x):\n"
          "        g = torch.cuda.CUDAGraph()\n"
          "        g.capture_begin(capture_error_mode='thread_local')\n"
          "        y = self._graph_forward(x)\n"
          "        g.capture_end()\n"
          "        return g, y\n",
        [("_capture:_graph_forward", "journal .event", 6)]),
    # self._graph_forward as a same-file function assigned to it
    "self_assigned": (
        CAPTURE_HEAD
        + "def _forward(x):\n"
          "    return x + time.perf_counter()\n"
          "class Engine:\n"
          "    def __init__(self):\n"
          "        self._graph_forward = _forward\n"
          "    def warm(self, x):\n"
          "        g = torch.cuda.CUDAGraph()\n"
          "        with torch.cuda.graph(g):\n"
          "            y = self._graph_forward(x)\n"
          "        return g, y\n",
        [("warm:_forward", "time.perf_counter", 5)]),
    # import time as t; from time import perf_counter; numpy's RNG
    "aliases": (
        "import time as t\n"
        "import numpy as np\n"
        "import torch\n"
        "from time import perf_counter\n"
        "def capture(x):\n"
        "    g = torch.cuda.CUDAGraph()\n"
        "    g.capture_begin()\n"
        "    a = x + t.time()\n"
        "    b = x + perf_counter()\n"
        "    c = x + np.random.rand()\n"
        "    g.capture_end()\n"
        "    return a, b, c\n",
        [("capture:capture", "time.time", 8),
         ("capture:capture", "time.perf_counter", 9),
         ("capture:capture", "numpy.random.rand", 10)]),
    # make_graphed_callables' callable, a metrics chain inside it
    "graphed_callable": (
        CAPTURE_HEAD
        + "def step(x):\n"
          "    REG.metrics.inc('steps')\n"
          "    return x * 2\n"
          "def build(x):\n"
          "    return torch.cuda.make_graphed_callables(step, (x,))\n",
        [("step:step", "metrics-registry", 5)]),
    # pure captures: device RNG, side effects outside, no capture at all
    "pure": (
        CAPTURE_HEAD
        + "from torch import rand\n"
          "class Engine:\n"
          "    def _graph_forward(self, x):\n"
          "        return x + torch.rand(x.shape) + rand(3).sum()\n"
          "    def _capture(self, x):\n"
          "        g = torch.cuda.CUDAGraph()\n"
          "        t0 = time.perf_counter()\n"
          "        logger.info('capturing')\n"
          "        g.capture_begin(pool=None)\n"
          "        y = self._graph_forward(x) + torch.randn(1)\n"
          "        g.capture_end()\n"
          "        logger.info('captured in %.3f', time.perf_counter() - t0)\n"
          "        return g, y\n"
          "def eager(x):\n"
          "    logger.info('not captured')\n"
          "    return x + time.time()\n"
          "def failed(g):\n"
          "    g.capture_end()\n"
          "    logger.info('no window without a begin')\n",
        []),
}


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_jit_purity_over_captures(name, tmp_path):
    src, want = CAPTURES[name]
    got = sorted((f.symbol, f.line, f.message)
                 for f in _purity(tmp_path, src))
    assert [(s, ln) for s, ln, _ in got] == [(s, ln) for s, _, ln in want]
    for (_, _, message), (_, what, _) in zip(got, want):
        assert what in message, message
        assert "CUDA-graph-captured" in message
    assert all(f.rule == "jit-impure" for f in _purity(tmp_path, src))


def test_an_override_in_a_subclass_elsewhere_is_reached(tmp_path):
    """``self._graph_forward`` in the base's capture reaches a subclass's
    override in another file; a class that does not derive is not."""
    base = (CAPTURE_HEAD
            + "class Engine:\n"
              "    def _graph_forward(self, x):\n"
              "        return x\n"
              "    def _capture(self, x):\n"
              "        g = torch.cuda.CUDAGraph()\n"
              "        g.capture_begin()\n"
              "        y = self._graph_forward(x)\n"
              "        g.capture_end()\n"
              "        return y\n")
    other = ("import time\n"
             f"from {PORT}.mod import Engine\n"
             "class Stacked(Engine):\n"
             "    def _graph_forward(self, x):\n"
             "        return x * time.monotonic()\n"
             "class Unrelated:\n"
             "    def _graph_forward(self, x):\n"
             "        return x * time.monotonic()\n")
    found = _purity(tmp_path, base, {f"{PORT}/zoo.py": other})
    assert [(f.file, f.line, f.symbol) for f in found] == [
        (f"{PORT}/zoo.py", 5, "_capture:_graph_forward")]


ENGINE_MUTATIONS = {
    "graph_forward": (
        "serve/engine.py",
        '        """The forward a graph captures (no host wait inside)."""\n',
        '        """The forward a graph captures (no host wait inside)."""\n'
        '        logger.info("forward")\n',
        "_capture:_graph_forward"),
    "capture_window": (
        "serve/engine.py",
        "                logits = self._graph_forward(*inputs)\n",
        "                logits = self._graph_forward(*inputs)\n"
        '                logger.info("captured")\n',
        "_capture:_capture"),
    "stacked_override": (
        "serve/zoo.py",
        "        # Every index a replay sees passed infer's host check.\n",
        "        # Every index a replay sees passed infer's host check.\n"
        '        logger.info("stacked forward")\n',
        "_capture:_graph_forward"),
}


def _mutated_tree(tmp_path, rel, old, new) -> Path:
    shutil.copytree(REPO / PORT, tmp_path / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "csrc"))
    path = tmp_path / PORT / rel
    text = path.read_text()
    assert text.count(old) == 1, (rel, old)
    path.write_text(text.replace(old, new))
    return tmp_path


@pytest.mark.parametrize("name", sorted(ENGINE_MUTATIONS))
def test_a_logger_inside_the_engines_capture_is_one_finding(name, tmp_path,
                                                             monkeypatch):
    rel, old, new, symbol = ENGINE_MUTATIONS[name]
    root = _mutated_tree(tmp_path, rel, old, new)
    found = run_all(root, passes=("jit-purity",))
    assert [(f.rule, f.file, f.symbol) for f in found] == [
        ("jit-impure", f"{PORT}/{rel}", symbol)]
    assert found[0].message.startswith("logging call ")
    assert "logger.info() inside CUDA-graph-captured" in found[0].message
    if name != "capture_window":
        # The finding comes through the self.<name> resolution: cut it and
        # the mutated forward goes unseen.
        monkeypatch.setattr(jit_purity._Index, "self_targets",
                            lambda *a: [])
        assert run_all(root, passes=("jit-purity",)) == []


def test_the_real_captures_are_pure_and_found():
    """The engine's ``_capture`` holds the one capture window of the
    package, and the pass reaches both graphed forwards from it."""
    project = Project.scan(REPO)
    index = jit_purity._Index(project)
    roots = [(sf.rel, label) for sf in project.python_files()
             for _, label, _ in jit_purity._collect_roots(sf, index)]
    assert roots == [(f"{PORT}/serve/engine.py", "_capture")]
    engine = project.by_rel[f"{PORT}/serve/engine.py"]
    (cls,) = [n for n in engine.nodes()
              if getattr(n, "name", None) == "InferenceEngine"]
    targets = {(sf.rel, fn.lineno) for sf, fn in
               index.self_targets(engine, cls, "_graph_forward")}
    assert {rel for rel, _ in targets} == {f"{PORT}/serve/engine.py",
                                          f"{PORT}/serve/zoo.py"}
    assert jit_purity.check(project, Contracts.from_project(project)) == []
