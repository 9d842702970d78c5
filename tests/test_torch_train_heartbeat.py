"""Training heartbeats and the ``data.read`` site of the port, on the CPU.

- A train CLI run (in process) with ``EEGTPU_HEARTBEAT_FILE`` set beats
  ``compile`` before its first epoch and ``step`` after every epoch and at
  every chunk boundary, the last ``step`` with ``epochs_done`` equal to
  the epochs trained; the beat file it leaves holds a ``step`` beat of
  this process; no beat reads the device.  Its weights equal a run without
  the variable bit for bit.
- ``--chaos data.read:times=2`` retries two reads (``retry`` events under
  ``READ_RETRY``) and trains to the same bits; ``data.read:times=3``
  spends the budget and fails the run as the JAX CLI fails: ``OSError``,
  two ``retry`` events, three firings and ``run_end`` status ``error``
  with the same message.
- The JAX ``test_data_read_retries_injected_fault`` on the port's
  ``load_trials``; ``READ_RETRY`` equals the JAX policy; a missing file is
  not retried.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch_port_cases import write_processed_tree

from eegnetreplication_tpu import train as jax_train
from eegnetreplication_tpu.data import io as jax_io
from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu.resil import inject as jax_inject
from eegnetreplication_tpu.resil import preempt as jax_preempt
from eegnetreplication_tpu_torch import obs
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.data import io as data_io
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.resil import heartbeat, inject, preempt
from eegnetreplication_tpu_torch.resil import retry
from eegnetreplication_tpu_torch.training import checkpoint as ckpt

FAST = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0, jitter=0.0)
MODELS = [f"subject_{s:02d}_best_model.npz" for s in (1, 2)]


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.delenv(heartbeat.HEARTBEAT_FILE_ENV, raising=False)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    heartbeat.reset_default()
    yield
    heartbeat.reset_default()
    inject.disarm_all()
    jax_inject.disarm_all()
    preempt.clear()
    jax_preempt.clear()


def _cli(monkeypatch, root, *argv):
    """The port's train CLI in process over ``root``'s tree; returns (exit
    code or the exception, the run's journal events)."""
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(root))
    out = root / "m"
    before = set(out.glob("*")) if out.exists() else set()
    try:
        result = train_cli.main(["--subjects", "1,2", "--metricsDir",
                                 str(out), *argv])
    except Exception as exc:  # noqa: BLE001 — the test inspects it
        result = exc
    (run,) = set(out.glob("*")) - before
    return result, obs.read_events(run / "events.jsonl", complete=False)


def _weights(root):
    return [ckpt.load_checkpoint(root / "models" / name)[0]
            for name in MODELS]


def _assert_same(a, b):
    for wa, wb in zip(a, b):
        assert wa.keys() == wb.keys()
        for k in wa:
            assert torch.equal(wa[k], wb[k]), k


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """The reference run: 3 epochs in chunks of 2, no heartbeat file."""
    mp = pytest.MonkeyPatch()
    mp.setenv("EEGTPU_PLATFORM", "cpu")
    mp.delenv(heartbeat.HEARTBEAT_FILE_ENV, raising=False)
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    heartbeat.reset_default()
    root = tmp_path_factory.mktemp("unbroken")
    write_processed_tree(root)
    try:
        rc, events = _cli(mp, root, "--epochs", "3", "--checkpointEvery", "2")
    finally:
        mp.undo()
        heartbeat.reset_default()
    assert rc == 0 and events[-1]["status"] == "ok"
    return _weights(root)


def test_train_beats_compile_then_step_and_keeps_its_bits(
        monkeypatch, tmp_path, unbroken):
    write_processed_tree(tmp_path)
    beat_file = tmp_path / "hb" / "beat.json"
    monkeypatch.setenv(heartbeat.HEARTBEAT_FILE_ENV, str(beat_file))
    heartbeat.reset_default()
    beats = []
    real_beat = heartbeat.beat

    def spy(phase="step", **ctx):
        beats.append((phase, ctx))
        return real_beat(phase, **ctx)

    monkeypatch.setattr(heartbeat, "beat", spy)
    rc, events = _cli(monkeypatch, tmp_path, "--epochs", "3",
                      "--checkpointEvery", "2")
    assert rc == 0
    phases = [p for p, _ in beats]
    assert phases[0] == "compile" and set(phases[1:]) == {"step"}
    assert beats[0][1] == {"epochs_done": 0, "n_folds": 8}
    # One beat after each of the 3 epochs, one at each of the 2 chunk
    # boundaries (epochs 2 and 3).
    steps = [ctx["epochs_done"] for p, ctx in beats if p == "step"]
    assert steps == [1, 2, 2, 3, 3]
    assert beats[-1][1] == {"epochs_done": 3, "n_folds": 8}
    got = heartbeat.read(beat_file)
    assert got is not None and got.phase == "step"
    assert got.pid == os.getpid()
    assert [e for e in events if e["event"] == "heartbeat"]
    _assert_same(_weights(tmp_path), unbroken)


def test_beats_never_read_the_device(monkeypatch, tmp_path):
    """The beat path takes the host clock only: patch every way a beat
    could wait for a tensor and run an epoch's beats."""
    calls = []
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda self: calls.append("item") or 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("sync"))
    hb = heartbeat.Heartbeat(tmp_path / "beat.json", min_write_interval_s=0)
    hb.beat("compile", epochs_done=0, n_folds=36)
    hb.beat("step", epochs_done=1, n_folds=36)
    assert calls == []
    assert heartbeat.read(tmp_path / "beat.json").phase == "step"


def test_data_read_two_faults_retry_to_the_same_bits(monkeypatch, tmp_path,
                                                     unbroken):
    write_processed_tree(tmp_path)
    rc, events = _cli(monkeypatch, tmp_path, "--epochs", "3",
                      "--checkpointEvery", "2", "--chaos",
                      "data.read:times=2")
    assert rc == 0
    retries = [e for e in events if e["event"] == "retry"]
    assert [(e["site"], e["attempt"], e["classification"])
            for e in retries] == [("data.read", 1, "transient"),
                                  ("data.read", 2, "transient")]
    assert [e["site"] for e in events
            if e["event"] == "fault_injected"] == ["data.read"] * 2
    _assert_same(_weights(tmp_path), unbroken)


def _jax_cli(monkeypatch, root, *argv):
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(root))
    out = root / "jax_m"
    monkeypatch.setattr(sys, "argv", ["train", "--subjects", "1,2",
                                      "--metricsDir", str(out), *argv])
    try:
        jax_train.main()
        result = 0
    except Exception as exc:  # noqa: BLE001 — the test inspects it
        result = exc
    (run,) = out.iterdir()
    return result, jax_schema.read_events(run / "events.jsonl",
                                          complete=False)


def test_data_read_spent_budget_fails_as_the_jax_run(monkeypatch, tmp_path):
    write_processed_tree(tmp_path)
    plan = ("--epochs", "2", "--chaos", "data.read:times=3")
    port_exc, port_events = _cli(monkeypatch, tmp_path, *plan)
    jax_exc, jax_events = _jax_cli(monkeypatch, tmp_path, *plan)
    assert type(port_exc) is type(jax_exc) is OSError
    assert str(port_exc) == str(jax_exc)

    def reading(events):
        return ([(e["site"], e["attempt"], e["max_attempts"],
                  e["classification"], e["error"]) for e in events
                 if e["event"] == "retry"],
                [(e["site"], e["hit"]) for e in events
                 if e["event"] == "fault_injected"],
                (events[-1]["event"], events[-1]["status"],
                 events[-1]["error"]))

    assert reading(port_events) == reading(jax_events)
    assert len(reading(port_events)[0]) == 2
    assert port_events[-1]["status"] == "error"


def test_data_read_retries_injected_fault(tmp_path, monkeypatch):
    """The JAX ``test_data_read_retries_injected_fault`` on the port."""
    monkeypatch.setattr(data_io, "READ_RETRY", FAST)
    ds = BCICI2ADataset(X=np.zeros((4, 2, 8), np.float32),
                        y=np.zeros(4, np.int64))
    p = data_io.save_trials(ds, tmp_path / "t.npz")
    inject.arm("data.read", times=1)
    loaded = data_io.load_trials(p)
    assert loaded.X.shape == (4, 2, 8)


def test_read_retry_policy_and_site_equal_jax():
    fields = ("max_attempts", "base_delay_s", "multiplier", "max_delay_s",
              "jitter", "retry_on")
    assert {f: getattr(data_io.READ_RETRY, f) for f in fields} \
        == {f: getattr(jax_io.READ_RETRY, f) for f in fields}
    assert "data.read" in inject.SITES
    assert "fetch.download" in inject.SITES
    assert inject._DEFAULTS["data.read"] == jax_inject._DEFAULTS["data.read"]
    (port,), (ref,) = (inject.parse_plan("data.read:after=1:times=2"),
                       jax_inject.parse_plan("data.read:after=1:times=2"))
    got = dataclasses.asdict(port)
    assert got == {k: getattr(ref, k) for k in got}


def test_missing_file_is_fatal_at_once(tmp_path, monkeypatch):
    monkeypatch.setattr(data_io, "READ_RETRY", FAST)
    with obs.run(tmp_path / "obs") as jr:
        with pytest.raises(FileNotFoundError):
            data_io.load_trials(tmp_path / "missing.npz")
    events = obs.read_events(jr.events_path)
    assert not [e for e in events if e["event"] == "retry"]
