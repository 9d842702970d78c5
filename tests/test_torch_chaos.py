"""Chaos on the port's training path, on the CPU, as the JAX package's
``tests/test_resilience.py`` drills its own.

Through the train CLI (in process, ``--chaos`` plans, the run journal):

- ``train.step:if_folds_over=4`` halves a group of 8 to 4, journals
  ``device_fault`` and ``retry``, and trains the same weights, bit for bit,
  as a run started in groups of 4 (the halved group has the same folds,
  shapes and dropout generator);
- ``train.chunk:after=1`` crashes a run in 1-epoch chunks after its second
  chunk, and ``--resume`` then equals the unbroken run (in 2-epoch chunks)
  bit for bit;
- ``checkpoint.write:action=corrupt`` garbles the newest run snapshot; the
  resume quarantines it (``checkpoint_quarantine``), takes the generation
  before, and still equals the unbroken run;
- ``host.preempt:after=1`` exits 75 with ``run_end`` status ``preempted``;
- ``--debugNans`` raises ``FloatingPointError`` on a step that makes a NaN.

And the registry's counting rules (``after``, ``times``, ``every``,
``if_folds_over``, several specs on one site), each firing journaled.
"""

import sys

import numpy as np
import pytest
import torch
from torch_port_cases import write_processed_tree

from eegnetreplication_tpu_torch import obs
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.resil import inject, preempt, retry
from eegnetreplication_tpu_torch.training import checkpoint as ckpt
from eegnetreplication_tpu_torch.training import loop, protocols

SNAP = "within_subject_eegnet.run.npz"


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    # No TensorBoard writer (importing it here drags in TensorFlow).
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    yield
    inject.disarm_all()
    preempt.clear()


def _cli(monkeypatch, root, *argv, subjects="1,2"):
    """Run the train CLI over ``root``'s tree; returns ``(exit code, the
    run's journal events)``."""
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(root))
    before = set((root / "m").glob("*")) if (root / "m").exists() else set()
    try:
        rc = train_cli.main(["--subjects", subjects, "--metricsDir",
                             str(root / "m"), *argv])
    finally:
        (run,) = set((root / "m").glob("*")) - before
        events = obs.read_events(run / "events.jsonl", complete=False)
    return rc, events


def _weights(root, subjects=(1, 2)):
    return [ckpt.load_checkpoint(root / "models"
                                 / f"subject_{s:02d}_best_model.npz")[0]
            for s in subjects]


def _assert_same_weights(a, b):
    for wa, wb in zip(a, b):
        assert wa.keys() == wb.keys()
        for k in wa:
            assert torch.equal(wa[k], wb[k]), k


def _kinds(events):
    return [e["event"] for e in events]


def test_train_step_fault_halves_a_group_of_8(monkeypatch, tmp_path):
    roots = {n: tmp_path / n for n in ("chaos", "fours")}
    for root in roots.values():
        write_processed_tree(root, subjects=(1, 2, 3))
    args = ("--epochs", "2")
    rc, events = _cli(monkeypatch, roots["chaos"], *args,
                      "--maxFoldsPerProgram", "8", "--chaos",
                      "train.step:if_folds_over=4", subjects="1,2,3")
    assert rc == 0
    (fault,) = [e for e in events if e["event"] == "device_fault"]
    assert (fault["fold_lo"], fault["fold_hi"], fault["retry_fold_batch"]) \
        == (0, 8, 4)
    assert "OutOfMemoryError" in fault["error"]
    (again,) = [e for e in events if e["event"] == "retry"]
    assert again["site"] == "train.step"
    assert again["classification"] == retry.DEVICE_FAULT
    groups = [(e["fold_lo"], e["fold_hi"]) for e in events
              if e["event"] == "fold_group"]
    assert groups == [(0, 8), (0, 4), (4, 8), (8, 12)]
    assert _kinds(events).index("fault_injected") \
        < _kinds(events).index("device_fault")
    assert events[-1]["status"] == "ok"
    rc, _ = _cli(monkeypatch, roots["fours"], *args, "--maxFoldsPerProgram",
                 "4", subjects="1,2,3")
    assert rc == 0
    _assert_same_weights(_weights(roots["chaos"], (1, 2, 3)),
                         _weights(roots["fours"], (1, 2, 3)))


def test_chunk_crash_then_resume_equals_the_unbroken_run(monkeypatch,
                                                         tmp_path):
    roots = {n: tmp_path / n for n in ("unbroken", "crashed")}
    for root in roots.values():
        write_processed_tree(root)
    assert _cli(monkeypatch, roots["unbroken"], "--epochs", "4",
                "--checkpointEvery", "2")[0] == 0
    args = ("--epochs", "4", "--checkpointEvery", "1")
    with pytest.raises(RuntimeError, match="injected crash after chunk 2"):
        _cli(monkeypatch, roots["crashed"], *args, "--chaos",
             "train.chunk:after=1")
    assert (roots["crashed"] / "models" / SNAP).exists()
    rc, events = _cli(monkeypatch, roots["crashed"], *args, "--resume")
    assert rc == 0
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [3, 4]
    _assert_same_weights(_weights(roots["crashed"]),
                         _weights(roots["unbroken"]))


def test_a_crashed_run_journals_the_firing_and_the_error(monkeypatch,
                                                         tmp_path):
    write_processed_tree(tmp_path)
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="injected crash"):
        train_cli.main(["--subjects", "1,2", "--epochs", "4",
                        "--checkpointEvery", "1", "--metricsDir",
                        str(tmp_path / "m"), "--chaos",
                        "train.chunk:after=1"])
    (run,) = (tmp_path / "m").iterdir()
    events = obs.read_events(run / "events.jsonl")
    (fired,) = [e for e in events if e["event"] == "fault_injected"]
    assert (fired["site"], fired["hit"], fired["chunk"]) \
        == ("train.chunk", 2, 2)
    assert events[-1]["status"] == "error"
    assert "injected crash after chunk 2" in events[-1]["error"]


def test_a_corrupt_snapshot_is_quarantined_and_the_one_before_resumed(
        monkeypatch, tmp_path):
    roots = {n: tmp_path / n for n in ("unbroken", "crashed")}
    for root in roots.values():
        write_processed_tree(root)
    args = ("--epochs", "4", "--checkpointEvery", "1")
    assert _cli(monkeypatch, roots["unbroken"], *args)[0] == 0
    # The second snapshot (epoch 2) is garbled, then the run dies.
    with pytest.raises(RuntimeError, match="injected crash"):
        _cli(monkeypatch, roots["crashed"], *args, "--chaos",
             "checkpoint.write:action=corrupt:after=1,train.chunk:after=1")
    models = roots["crashed"] / "models"
    assert (models / SNAP).exists() and (models / (SNAP + ".gen1")).exists()
    rc, events = _cli(monkeypatch, roots["crashed"], *args, "--resume")
    assert rc == 0
    (quarantine,) = [e for e in events
                     if e["event"] == "checkpoint_quarantine"]
    assert quarantine["path"].endswith(SNAP)
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [2, 3, 4]
    _assert_same_weights(_weights(roots["crashed"]),
                         _weights(roots["unbroken"]))
    assert not list(models.glob("*.run.npz*"))


def test_host_preempt_exits_75_with_a_preempted_journal(monkeypatch,
                                                        tmp_path):
    write_processed_tree(tmp_path)
    rc, events = _cli(monkeypatch, tmp_path, "--epochs", "4",
                      "--checkpointEvery", "1", "--chaos",
                      "host.preempt:after=1")
    assert rc == preempt.EX_PREEMPTED
    assert events[-1]["event"] == "run_end"
    assert events[-1]["status"] == "preempted"
    assert "injected host.preempt" in events[-1]["error"]
    assert [e["epoch"] for e in events if e["event"] == "epoch"] == [1, 2]
    snap = tmp_path / "models" / SNAP
    assert ckpt.load_run_snapshot(
        snap, ckpt.read_snapshot_signature(snap))[1] == 2


def test_debug_nans_raises_on_a_nan_step(monkeypatch, tmp_path):
    write_processed_tree(tmp_path, nan_in=1)
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    argv = ["--subjects", "1", "--epochs", "1", "--metricsDir",
            str(tmp_path / "m")]
    assert train_cli.main(argv) == 0        # unchecked: NaN weights, exit 0
    with pytest.raises(FloatingPointError, match="epoch 1, step 1.*NaN"):
        train_cli.main(argv + ["--debugNans"])


def _trainer():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(40, 4, 64).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 40))
    folds = [(np.arange(0, 20), np.arange(20, 30), np.arange(30, 40))] * 3
    spec = loop.make_fold_spec(folds, train_pad=20, val_pad=10, test_pad=10)
    model = protocols.get_model("eegnet", n_channels=4, n_times=64,
                                dropout_rate=0.0, device="cpu")
    init = loop.init_fold_states(model, 3, torch.Generator().manual_seed(0))
    return loop.FoldTrainer(model, x, y, spec, init, batch_size=16,
                            learning_rate=1e-3, adam_eps=1e-7,
                            fold_ids=[5, 6, 7])


def test_debug_nans_names_the_fold_and_tensor_of_a_bad_update():
    trainer = _trainer()
    trainer.state.mu[1, 0] = float("inf")       # fold 6's Adam moment
    trainer.run_epoch()                        # unchecked: no raise
    trainer = _trainer()
    trainer.state.mu[1, 0] = float("inf")
    with loop.debug_nans(), pytest.raises(
            FloatingPointError,
            match=r"epoch 1, step 1: fold 6 has a non-finite "
                  r"params\[temporal.0.weight\]"):
        trainer.run_epoch()


def test_debug_nans_leaves_a_clean_run_unchanged():
    a, b = _trainer(), _trainer()
    a.run_epoch()
    with loop.debug_nans():
        b.run_epoch()
    for name, value in a.carry().items():
        assert torch.equal(value, b.carry()[name]), name


# --- the registry ------------------------------------------------------------

def _outcomes(site, n, **ctx):
    out = []
    for _ in range(n):
        try:
            inject.fire(site, **ctx)
            out.append("ok")
        except (RuntimeError, OSError):
            out.append("raised")
    return out


def test_after_times_and_every_count_hits():
    handle = inject.arm("train.chunk", after=2, times=2)
    assert _outcomes("train.chunk", 6) == ["ok", "ok", "raised", "raised",
                                           "ok", "ok"]
    assert handle.hits == 6 and handle.fired == 2
    inject.disarm_all()
    inject.arm("train.chunk", every=2, times=0)
    assert _outcomes("train.chunk", 4) == ["raised", "ok", "raised", "ok"]


def test_if_folds_over_gates_eligibility():
    handle = inject.arm("train.step", if_folds_over=4, times=0)
    inject.fire("train.step", n_folds=3)
    assert handle.hits == 0
    with pytest.raises(torch.cuda.OutOfMemoryError) as exc:
        inject.fire("train.step", n_folds=8)
    assert retry.is_device_fault(exc.value)


def test_several_specs_on_one_site_count_the_same_hits():
    inject.arm("checkpoint.write", action="raise", exc="OSError", times=1)
    inject.arm("checkpoint.write", action="raise", exc="ValueError",
               after=1, times=1)
    with pytest.raises(OSError):
        inject.fire("checkpoint.write")
    with pytest.raises(ValueError):
        inject.fire("checkpoint.write")
    inject.fire("checkpoint.write")


def test_scoped_disarms_when_the_fault_propagates():
    with pytest.raises(RuntimeError):
        with inject.scoped(inject.FaultSpec(site="train.chunk")):
            inject.fire("train.chunk")
    assert inject.armed() == []
    inject.fire("train.chunk")


def test_corrupt_garbles_the_file_and_every_firing_is_journaled(tmp_path):
    target = tmp_path / "blob.bin"
    target.write_bytes(b"A" * 100)
    with obs.run(tmp_path / "m") as jr:
        inject.arm("checkpoint.write")
        inject.fire("checkpoint.write", path=target)
        inject.arm("train.hang", sleep=0.0)
        inject.fire("train.hang", chunk=3)
    assert target.read_bytes() != b"A" * 100
    fired = [e for e in obs.read_events(jr.events_path)
             if e["event"] == "fault_injected"]
    assert [(e["site"], e["action"]) for e in fired] == [
        ("checkpoint.write", "corrupt"), ("train.hang", "sleep")]
    assert fired[0]["path"] == str(target) and fired[1]["chunk"] == 3
    assert jr.metrics.get("faults_injected", site="train.hang") == 1.0


def test_corrupt_without_a_path_is_a_wiring_error():
    inject.arm("checkpoint.write")
    with pytest.raises(RuntimeError, match="no path="):
        inject.fire("checkpoint.write")
