"""The port's ``MultiSupervisor`` against the JAX package's, on the CPU.

Scripted children (tiny Python scripts, as the JAX ``TestMultiSupervisor``
drives its own) run under both packages' supervisors with the same policy
and a zero-jitter backoff: one of three beating children SIGKILLed (only
it restarts), the crash-loop breaker retiring one child while its sibling
completes, a hang detected per child (SIGTERM ignored, SIGKILL, relaunch
with ``--resume``), a child added to a running supervisor, a child
retired without touching its sibling, a retired name re-added with its
breaker history forgotten, and a stop that drains every child.  Both
return the same decisions (exit codes, attempts, states) and journal the
same ``supervisor_*`` events per child, in order, with the same
``attempt``, ``classification``, ``reason``, ``resume``, ``delay_s`` and
``signal`` (times and pids differ).

A supervisor marks a child running when it launches it, before the
child's Python has installed its SIGTERM handler.  So every scenario
kills, retires or stops a beating child only once the child's heartbeat
names its current pid: the script beats after it installs the handler,
and a SIGTERM then always meets it, under either package.  The beating
child closes each heartbeat file in a ``with`` block: a file left to the
garbage collector is closed in its finalizer, where a SIGTERM's
``SystemExit`` is printed and dropped, and the child would outlive the
stop's grace.
"""

import json
import os
import sys
import threading
import time

import pytest
from torch_port_cases import fleet_packages, journal_sequence, journal_views

PKGS = fleet_packages()
SUPERVISOR_EVENTS = ("supervisor_start", "supervisor_launch",
                     "supervisor_exit", "supervisor_hang",
                     "supervisor_escalate", "supervisor_restart",
                     "supervisor_giveup", "supervisor_end")

BEATING_CHILD = (
    "import json, os, signal, sys, time\n"
    "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
    "hb = os.environ.get('EEGTPU_HEARTBEAT_FILE')\n"
    "i = 0\n"
    "while True:\n"
    "    i += 1\n"
    "    if hb:\n"
    "        tmp = hb + '.tmp'\n"
    "        with open(tmp, 'w') as f:\n"
    "            f.write(json.dumps(\n"
    "                {'phase': 'step', 'beat': i, 't': time.time(),\n"
    "                 'pid': os.getpid()}))\n"
    "        os.replace(tmp, hb)\n"
    "    time.sleep(0.05)\n")

WEDGED_CHILD = (
    "import json, os, signal, sys, time\n"
    "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
    "hb = os.environ['EEGTPU_HEARTBEAT_FILE']\n"
    "open(hb + '.tmp', 'w').write(json.dumps(\n"
    "    {'phase': 'step', 'beat': 1, 't': time.time(),\n"
    "     'pid': os.getpid()}))\n"
    "os.replace(hb + '.tmp', hb)\n"
    "if '--resume' not in sys.argv:\n"
    "    time.sleep(60)\n"
    "sys.exit(0)\n")


def _policy(pkg, **kw):
    retry = sys.modules[pkg.supervise.__name__.rsplit(".", 1)[0]
                        + ".retry"]
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("grace_s", 2.0)
    kw.setdefault("backoff", retry.RetryPolicy(
        max_attempts=1_000_000, base_delay_s=kw.pop("base_delay_s", 0.0),
        jitter=0.0))
    return pkg.supervise.SupervisorPolicy(**kw)


def _spec(pkg, work, name, body):
    script = work / f"{name}.py"
    script.write_text(body)
    return pkg.supervise.ChildSpec(name=name,
                                   cmd=[sys.executable, str(script)],
                                   heartbeat_file=work / f"{name}.hb.json")


def _wait(predicate, timeout_s=20.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _beating(*children):
    """The children run and each one's heartbeat names its current pid
    (its SIGTERM handler is in place)."""
    for child in children:
        try:
            beat = json.loads(child.spec.heartbeat_file.read_text())
        except (OSError, ValueError):
            return False
        if child.state != "running" or beat.get("pid") != child.pid:
            return False
    return True


def _running(sup, thread_box):
    th = threading.Thread(target=lambda: thread_box.append(sup.run()),
                          daemon=True)
    th.start()
    return th


def kill_one_of_three(pkg, jr, work):
    sup = pkg.supervise.MultiSupervisor(
        [_spec(pkg, work, f"c{i}", BEATING_CHILD) for i in range(3)],
        policy=_policy(pkg, thresholds={"step": 5.0, "startup": 30.0}),
        journal=jr)
    box = []
    th = _running(sup, box)
    _wait(lambda: _beating(*sup.children.values()), what="beating")
    victim = sup.children["c1"]
    os.kill(victim.pid, 9)
    _wait(lambda: victim.attempt == 2 and _beating(victim),
          what="victim relaunch")
    attempts = {n: c.attempt for n, c in sup.children.items()}
    sup.stop()
    th.join(timeout=20.0)
    return box, attempts, {n: c.state for n, c in sup.children.items()}


def crash_loop_per_child(pkg, jr, work):
    sup = pkg.supervise.MultiSupervisor(
        [_spec(pkg, work, "looper", "import sys; sys.exit(1)\n"),
         _spec(pkg, work, "worker", "import sys; sys.exit(0)\n")],
        policy=_policy(pkg, max_restarts=2, restart_window_s=60.0),
        journal=jr)
    code = sup.run()
    return code, {n: (c.attempt, c.state) for n, c in sup.children.items()}


def hang_is_per_child(pkg, jr, work):
    sup = pkg.supervise.MultiSupervisor(
        [_spec(pkg, work, "wedge", WEDGED_CHILD),
         _spec(pkg, work, "ok", BEATING_CHILD)],
        policy=_policy(pkg, grace_s=0.4, resume_arg="--resume",
                       thresholds={"step": 0.5, "startup": 30.0}),
        journal=jr)
    box = []
    th = _running(sup, box)
    _wait(lambda: sup.children["wedge"].state == "done",
          what="wedged child killed, relaunched, completed")
    _wait(lambda: _beating(sup.children["ok"]), what="ok beating")
    ok_attempt = sup.children["ok"].attempt
    sup.stop()
    th.join(timeout=20.0)
    return box, ok_attempt, sup.children["wedge"].attempt


def add_then_retire(pkg, jr, work):
    sup = pkg.supervise.MultiSupervisor(
        [_spec(pkg, work, "c0", BEATING_CHILD)],
        policy=_policy(pkg, thresholds={"step": 5.0, "startup": 30.0}),
        journal=jr)
    box = []
    th = _running(sup, box)
    _wait(lambda: _beating(sup.children["c0"]), what="c0")
    sup.add_child(_spec(pkg, work, "c1", BEATING_CHILD))
    try:
        sup.add_child(_spec(pkg, work, "c1", BEATING_CHILD))
        duplicate = "accepted"
    except ValueError:
        duplicate = "refused"
    _wait(lambda: "c1" in sup.children
          and _beating(sup.children["c1"]), what="c1 beating")
    os.kill(sup.children["c1"].pid, 9)
    _wait(lambda: sup.children["c1"].attempt == 2
          and _beating(sup.children["c1"]), what="c1 relaunch")
    retired = sup.retire_child("c1", wait_s=20.0)
    again = sup.retire_child("c1")
    c0 = (sup.children["c0"].state, sup.children["c0"].attempt)
    sup.stop()
    th.join(timeout=20.0)
    return box, duplicate, retired, again, c0, sorted(sup.children)


def re_add_forgets_the_breaker(pkg, jr, work):
    sup = pkg.supervise.MultiSupervisor(
        [_spec(pkg, work, "anchor", BEATING_CHILD),
         _spec(pkg, work, "flaky", "import sys; sys.exit(1)\n")],
        policy=_policy(pkg, max_restarts=50, restart_window_s=60.0,
                       base_delay_s=0.25,
                       thresholds={"step": 30.0, "startup": 30.0}),
        journal=jr)
    box = []
    th = _running(sup, box)
    _wait(lambda: "flaky" in sup.children
          and sup.children["flaky"].attempt >= 2, what="flaky crashing")
    retired = sup.retire_child("flaky", wait_s=20.0)
    sup.add_child(_spec(pkg, work, "flaky", BEATING_CHILD))
    _wait(lambda: _beating(sup.children["flaky"], sup.children["anchor"]),
          what="re-added child and anchor beating")
    attempt = sup.children["flaky"].attempt
    sup.stop()
    th.join(timeout=20.0)
    return box, retired, attempt


SCENARIOS = {
    "kill_one_of_three": kill_one_of_three,
    "crash_loop_per_child": crash_loop_per_child,
    "hang_is_per_child": hang_is_per_child,
    "add_then_retire": add_then_retire,
    "re_add_forgets_the_breaker": re_add_forgets_the_breaker,
}

EXPECTED = {
    "kill_one_of_three": ([0], {"c0": 1, "c1": 2, "c2": 1},
                          {"c0": "done", "c1": "done", "c2": "done"}),
    "crash_loop_per_child": (70, {"looper": (3, "crash_loop"),
                                  "worker": (1, "done")}),
    "hang_is_per_child": ([0], 1, 2),
    "add_then_retire": ([0], "refused", True, True, ("running", 1),
                        ["c0"]),
    "re_add_forgets_the_breaker": ([0], True, 1),
}

# Journal events whose count depends on timing rather than on a decision:
# a flaky child's crash count before its retirement lands, and the
# hang's beat ages.
UNCOUNTED = {"re_add_forgets_the_breaker": ("flaky",)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_the_port_supervises_as_jax(name, tmp_path):
    out = {}
    for key, pkg in PKGS.items():
        work = tmp_path / key
        work.mkdir()
        with pkg.journal.run(work / "obs", config={}) as jr:
            decisions = SCENARIOS[name](pkg, jr, work)
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        views = journal_views(journal_sequence(events, SUPERVISOR_EVENTS))
        for child in UNCOUNTED.get(name, ()):
            # Keep what is decided: the child's last launch and its retire.
            views["members"][f"'{child}'"] = [
                item for item in views["members"][f"'{child}'"]
                if item[0] == "supervisor_exit"
                and "retired" in repr(item[2])]
            views.pop("all")
        out[key] = (decisions, views)
    assert out["port"][0] == out["jax"][0] == EXPECTED[name]
    assert out["port"][1] == out["jax"][1]


def test_the_child_spec_and_policy_fields_equal_jax():
    import dataclasses

    port, ref = PKGS["port"].supervise, PKGS["jax"].supervise
    assert [f.name for f in dataclasses.fields(port.ChildSpec)] \
        == [f.name for f in dataclasses.fields(ref.ChildSpec)]
    for attr in ("add_child", "retire_child", "stop", "run"):
        assert callable(getattr(port.MultiSupervisor, attr))
    with pytest.raises(ValueError):
        port.MultiSupervisor([])
    spec = port.ChildSpec(name="a", cmd=["true"])
    with pytest.raises(ValueError):
        port.MultiSupervisor([spec, spec])
