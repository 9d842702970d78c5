"""The port's supervisor against the JAX package's, on the CPU.

- Scripted children (tiny Python scripts, as the JAX ``TestSupervisor``
  drives its own) run under the JAX ``Supervisor`` and the port's with the
  same policy and a seeded backoff: exit 0; 75 then ``--resume``; a hang
  whose child ignores SIGTERM (escalation to SIGKILL, relaunch); the
  crash-loop breaker (exit 70); a fatal exit 2 (exit 64); transient exits
  with the seeded backoff (the exact delays slept); a stop request that is
  forwarded and ends supervision.  Both journals hold the same events
  with the same ``attempt``, ``classification``, ``resume``, ``delay_s``
  and ``signal`` (times and pids differ).
- ``_parse_thresholds`` accepts and refuses the same strings, and both
  parsers have the same flags and defaults.
- Through the CLIs: ``python -m eegnetreplication_tpu_torch.resil.supervise
  -- python -m eegnetreplication_tpu_torch.train`` on a tiny tree with
  ``host.preempt:after=0:times=1`` re-armed in every launch gives the
  unbroken run's weights bit for bit, each surviving child journal ends
  with ``run_end``, and ``event_summary`` of the supervisor's journal
  counts its restarts; a hang (``train.hang``, the watchdog's ``step``
  budget, SIGTERM then SIGKILL) resumes to the same bits; a child that
  cannot reach the card (no ``EEGTPU_PLATFORM=cpu`` on a host without
  CUDA) is not hidden: the breaker ends it with exit 70.
"""

import json
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch_port_cases import child_env, write_processed_tree

from eegnetreplication_tpu import obs as jax_obs
from eegnetreplication_tpu.resil import preempt as jax_preempt
from eegnetreplication_tpu.resil import retry as jax_retry
from eegnetreplication_tpu.resil import supervise as jax_supervise
from eegnetreplication_tpu_torch import obs
from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.resil import preempt, retry, supervise
from eegnetreplication_tpu_torch.training import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
COMPARED = ("event", "attempt", "classification", "resume", "delay_s",
            "signal", "exit_code", "status", "reason", "phase", "restarts")

BEATING_HANG = (
    "import json, os, signal, sys, time\n"
    "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
    "hb = os.environ['EEGTPU_HEARTBEAT_FILE']\n"
    "tmp = hb + '.tmp'\n"
    "open(tmp, 'w').write(json.dumps(\n"
    "    {'phase': 'step', 'beat': 1, 't': time.time(),\n"
    "     'pid': os.getpid()}))\n"
    "os.replace(tmp, hb)\n"
    "if '--resume' in sys.argv:\n"
    "    sys.exit(0)\n"
    "time.sleep(60)\n")

# name -> (child script, policy options, the supervisor's exit code)
CASES = {
    "completed": ("import sys; sys.exit(0)\n", {}, 0),
    "preempted_then_resume": (
        "import sys\nsys.exit(0 if '--resume' in sys.argv else 75)\n", {},
        0),
    "hang_escalates_and_relaunches": (
        BEATING_HANG, {"grace_s": 0.4,
                       "thresholds": {"step": 0.3, "startup": 20.0}}, 0),
    "crash_loop_gives_up": ("import sys; sys.exit(1)\n",
                            {"max_restarts": 2, "restart_window_s": 60.0},
                            supervise.EX_CRASH_LOOP),
    "fatal_never_restarts": ("import sys; sys.exit(2)\n", {},
                             supervise.EX_FATAL),
    "transient_seeded_backoff": ("import sys; sys.exit(1)\n",
                                 {"max_restarts": 3, "seeded": True},
                                 supervise.EX_CRASH_LOOP),
    "stop_request_forwards": (
        "import signal, sys, time\n"
        "signal.signal(signal.SIGTERM, lambda *a: sys.exit(75))\n"
        "time.sleep(60)\n", {"poll_s": 0.5, "stop": True},
        preempt.EX_PREEMPTED),
}


@pytest.fixture(autouse=True)
def _clean():
    preempt.clear()
    jax_preempt.clear()
    yield
    preempt.clear()
    jax_preempt.clear()


def _policy(pkg, options):
    """The same policy for either package: fast polls, a short grace, no
    backoff unless the case seeds one (then base 0.5 s, jitter 0.25)."""
    opts = dict(options)
    opts.pop("stop", None)
    retry_mod = jax_retry if pkg is jax_supervise else retry
    if opts.pop("seeded", False):
        backoff = retry_mod.RetryPolicy(
            max_attempts=1_000_000, base_delay_s=0.5, multiplier=2.0,
            max_delay_s=60.0, jitter=0.25, rng=random.Random(7))
    else:
        backoff = retry_mod.RetryPolicy(max_attempts=1_000_000,
                                        base_delay_s=0.0, jitter=0.0)
    opts.setdefault("poll_s", 0.05)
    opts.setdefault("grace_s", 1.0)
    return pkg.SupervisorPolicy(backoff=backoff, **opts)


def _supervise(pkg, script: Path, options, tmp_path):
    """Run ``script`` under ``pkg``'s supervisor; returns (exit code, the
    journal's events, the backoff sleeps)."""
    run = jax_obs.run if pkg is jax_supervise else obs.run
    stop = (jax_preempt if pkg is jax_supervise else preempt).request
    slept = []
    seeded = options.get("seeded", False)

    def sleep(seconds):
        # A seeded case records its backoff sleeps (the large ones) and
        # skips them; poll and grace sleeps stay real.
        if seeded and seconds >= 0.25:
            slept.append(seconds)
        else:
            time.sleep(seconds)

    name = "jax" if pkg is jax_supervise else "port"
    with run(tmp_path / name / "obs") as jr:
        sup = pkg.Supervisor([sys.executable, str(script)],
                             policy=_policy(pkg, options),
                             heartbeat_file=tmp_path / name / "hb.json",
                             journal=jr, sleep=sleep)
        if options.get("stop"):
            stop("test-stop")
        code = sup.run()
    return code, schema.read_events(jr.events_path), slept


def _decisions(events):
    return [{k: e[k] for k in COMPARED if k in e} for e in events
            if e["event"].startswith("supervisor_")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervisor_decisions_equal_the_jax_supervisor(case, tmp_path):
    body, options, want = CASES[case]
    script = tmp_path / "child.py"
    script.write_text(body)
    got = {}
    for pkg in (jax_supervise, supervise):
        code, events, slept = _supervise(pkg, script, options, tmp_path)
        assert code == want, (pkg.__name__, events)
        assert not [e for e in events if "_schema_error" in e]
        got[pkg] = (_decisions(events), slept)
        preempt.clear()
        jax_preempt.clear()
    assert got[supervise] == got[jax_supervise]
    decisions, slept = got[supervise]
    kinds = [d["event"] for d in decisions]
    assert kinds[0] == "supervisor_start" and kinds[-1] == "supervisor_end"
    if case == "transient_seeded_backoff":
        twin = retry.RetryPolicy(max_attempts=1_000_000, base_delay_s=0.5,
                                 multiplier=2.0, max_delay_s=60.0,
                                 jitter=0.25, rng=random.Random(7))
        expected = [twin.delay(n) for n in (1, 2, 3)]
        assert slept == expected
        assert [d["delay_s"] for d in decisions
                if d["event"] == "supervisor_restart"] \
            == [round(d, 3) for d in expected]
    if case == "hang_escalates_and_relaunches":
        assert "supervisor_escalate" in kinds
        assert [d["classification"] for d in decisions
                if d["event"] == "supervisor_exit"] == ["hang", "completed"]


THRESHOLD_SPECS = [["step=60"], ["step=60,compile=10"], [" step = 1.5 "],
                   [""], ["a=1,,b=2"], ["step=1", "step=2"], ["step"],
                   ["step=x"], ["="], ["serve_forward=5,startup=inf"]]


@pytest.mark.parametrize("specs", THRESHOLD_SPECS,
                         ids=[repr(s) for s in THRESHOLD_SPECS])
def test_parse_thresholds_accepts_and_refuses_as_jax(specs):
    def outcome(fn):
        try:
            return fn(specs)
        except ValueError as exc:
            return ("refused", str(exc))

    assert outcome(supervise._parse_thresholds) \
        == outcome(jax_supervise._parse_thresholds)


def test_parser_has_the_jax_flags_and_defaults():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.nargs) for a in parser._actions}

    assert flags(supervise.build_parser()) \
        == flags(jax_supervise.build_parser())
    assert len([a for a in supervise.build_parser()._actions
                if a.option_strings and a.dest != "help"]) == 10
    args = supervise.build_parser().parse_args(["--", "x"])
    assert (args.graceS, args.pollS, args.maxRestarts, args.restartWindowS,
            args.resumeArg, args.backoffBaseS) == (30.0, 0.5, 5, 600.0,
                                                   "--resume", 1.0)


def test_classify_exit_equals_jax():
    for code in (0, 1, 2, 64, 70, 75, -9, 137):
        for hang in (False, True):
            assert supervise.classify_exit(code, hang_killed=hang) \
                == jax_supervise.classify_exit(code, hang_killed=hang)
    assert (supervise.EX_CRASH_LOOP, supervise.EX_FATAL) == (70, 64)


# --- Through the CLIs ---------------------------------------------------------

TRAIN = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--subjects", "1,2", "--epochs", "4", "--checkpointEvery", "1"]
MODELS = [f"subject_{s:02d}_best_model.npz" for s in (1, 2)]


def _tree(root: Path) -> dict:
    write_processed_tree(root)
    return child_env(EEGTPU_PLATFORM="cpu", EEGTPU_DATA_ROOT=str(root),
                     EEGTPU_NO_LOG_FILE="1")


def _supervised(root: Path, env, sup_args, child_args):
    cmd = [sys.executable, "-m", "eegnetreplication_tpu_torch.resil."
           "supervise", "--metricsDir", str(root / "sup"), *sup_args, "--",
           *TRAIN, "--metricsDir", str(root / "child"), *child_args]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def _same_weights(a: Path, b: Path):
    for name in MODELS:
        wa, _ = ckpt.load_checkpoint(a / "models" / name)
        wb, _ = ckpt.load_checkpoint(b / "models" / name)
        assert wa.keys() == wb.keys()
        for k in wa:
            assert torch.equal(wa[k], wb[k]), (name, k)


def _supervisor_events(root: Path):
    (run,) = (root / "sup").iterdir()
    return schema.read_events(run / "events.jsonl")


def _child_journals(root: Path):
    return [schema.read_events(r / "events.jsonl", complete=False,
                               lenient_tail=True)
            for r in sorted((root / "child").iterdir())]


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    root = tmp_path_factory.mktemp("unbroken")
    env = _tree(root)
    out = subprocess.run(TRAIN + ["--metricsDir", str(root / "child")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return root


def test_supervised_preempted_train_equals_an_unbroken_run(unbroken,
                                                           tmp_path):
    """The port's counterpart of the JAX ``TestSupervisedResumeRegression``:
    the re-armed ``host.preempt:after=0:times=1`` stops every child at its
    first chunk boundary, so each launch trains one 1-epoch chunk."""
    env = _tree(tmp_path)
    out = _supervised(tmp_path, env, ["--pollS", "0.1"],
                      ["--chaos", "host.preempt:after=0:times=1"])
    assert out.returncode == 0, out.stderr[-3000:]
    events = _supervisor_events(tmp_path)
    exits = [e["classification"] for e in events
             if e["event"] == "supervisor_exit"]
    assert exits == ["preempted"] * 4 + ["completed"]
    launches = [e for e in events if e["event"] == "supervisor_launch"]
    assert [e["cmd"].count("--resume") for e in launches] == [0, 1, 1, 1, 1]
    _same_weights(tmp_path, unbroken)
    journals = _child_journals(tmp_path)
    assert len(journals) == 5
    assert [j[-1]["status"] for j in journals] \
        == ["preempted"] * 4 + ["ok"]
    summary = schema.event_summary(events)
    assert summary["supervisor_restarts"] == 4
    assert summary["supervisor_status"] == "completed"


def test_supervised_hung_train_is_killed_and_resumes_bitwise(unbroken,
                                                             tmp_path):
    """``train.hang:after=2`` stalls the first child after its third chunk;
    the ``step`` beat goes stale, SIGTERM cannot end the sleep, SIGKILL
    does, and the relaunch (one chunk left, fewer than the plan's three)
    finishes with the unbroken run's weights."""
    env = _tree(tmp_path)
    out = _supervised(tmp_path, env,
                      ["--pollS", "0.1", "--graceS", "0.5", "--hang",
                       "step=2"],
                      ["--chaos", "train.hang:after=2:times=1:sleep=120"])
    assert out.returncode == 0, out.stderr[-3000:]
    events = _supervisor_events(tmp_path)
    kinds = [e["event"] for e in events]
    assert [e["classification"] for e in events
            if e["event"] == "supervisor_exit"] == ["hang", "completed"]
    (hang,) = [e for e in events if e["event"] == "supervisor_hang"]
    assert hang["phase"] == "step" and hang["age_s"] > hang["threshold_s"]
    assert kinds.index("supervisor_hang") < kinds.index(
        "supervisor_escalate") < kinds.index("supervisor_restart")
    _same_weights(tmp_path, unbroken)
    killed, resumed = _child_journals(tmp_path)
    assert killed[-1]["event"] != "run_end"
    assert resumed[-1]["event"] == "run_end" and resumed[-1]["status"] == "ok"
    assert [e["epoch"] for e in resumed if e["event"] == "epoch"] == [4]


def test_a_child_without_the_card_trips_the_breaker(tmp_path):
    """No quiet fallback: without ``EEGTPU_PLATFORM=cpu`` on a host with
    no CUDA the train CLI exits 1 (transient) every launch, and the
    crash-loop breaker ends supervision with exit 70."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the child would reach it")
    env = _tree(tmp_path)
    env.pop("EEGTPU_PLATFORM")
    out = _supervised(tmp_path, env,
                      ["--pollS", "0.1", "--maxRestarts", "1",
                       "--backoffBaseS", "0"], [])
    assert out.returncode == supervise.EX_CRASH_LOOP, out.stderr[-3000:]
    events = _supervisor_events(tmp_path)
    assert [(e["exit_code"], e["classification"]) for e in events
            if e["event"] == "supervisor_exit"] == [(1, "transient")] * 2
    summary = schema.event_summary(events)
    assert summary["supervisor_status"] == "crash_loop"
    assert summary["supervisor_restarts"] == 1
    assert json.dumps(events).count("supervisor_giveup") == 1
