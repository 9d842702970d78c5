"""The port's cross-subject protocol, its report, and the train CLI's
chunk and resume flags.

- The fold index sets, their order and their padding equal the JAX
  protocol's at 7 and 9 subjects (its ``_run_folds`` is replaced in the
  test to capture them, so nothing compiles).
- Given the same per-fold test accuracies and minimum validation losses,
  the best fold (ties included), the per-subject means, the mean and the
  standard error equal the JAX protocol's aggregation, and the report
  equals ``generate_cs_report``'s.
- ``cross_subject_training`` on a separable synthetic pool, on the CPU,
  tests above chance and writes ``cross_subject_best_model.{pth,npz}``,
  whose ``.npz`` gives the same ``variables_digest`` in both packages.
- ``python -m eegnetreplication_tpu_torch.train --trainingType
  Cross-Subject`` writes the JAX report's keys; the JAX CLI's parse-time
  errors raise; a stop at a chunk boundary exits 75 with the snapshot on
  disk, and ``--resume`` finishes with the unbroken run's models, bit for
  bit.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from synthetic import make_loader

from eegnetreplication_tpu.config import DEFAULT_TRAINING as JAX_DEFAULT
from eegnetreplication_tpu.config import Paths as JaxPaths
from eegnetreplication_tpu.serve import engine as jax_engine
from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu.training import protocols as jax_protocols
from eegnetreplication_tpu.training import report as jax_report
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.data.io import save_trials, trials_filename
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
from eegnetreplication_tpu_torch.training import checkpoint as ckpt
from eegnetreplication_tpu_torch.training import loop, protocols, report

REPO = Path(__file__).resolve().parents[1]
CFG = DEFAULT_TRAINING.replace(batch_size=16, cs_repeats_per_subject=2)
JAX_CFG = JAX_DEFAULT.replace(batch_size=16, cs_repeats_per_subject=2)


def port_loader(**kw):
    jax_loader = make_loader(**kw)

    def loader(subject, mode):
        ds = jax_loader(subject, mode)
        return BCICI2ADataset(X=ds.X, y=ds.y)

    return loader


@pytest.fixture(autouse=True)
def _no_stop_request():
    preempt.clear()
    yield
    preempt.clear()


class _Captured(Exception):
    pass


@pytest.mark.parametrize("subjects", [tuple(range(1, 8)),
                                      (9, 2, 5, 1, 7, 3, 8, 4, 6)])
def test_fold_index_sets_equal_the_jax_protocol(monkeypatch, tmp_path,
                                                subjects):
    captured = {}

    def capture(model, specs, pool_x, pool_y, **kw):
        captured["specs"] = specs
        raise _Captured

    monkeypatch.setattr(jax_protocols, "_run_folds", capture)
    kw = dict(n_trials=13, n_channels=4, n_times=64)
    with pytest.raises(_Captured):
        jax_protocols.cross_subject_training(
            epochs=1, config=JAX_CFG, loader=make_loader(**kw),
            subjects=subjects, paths=JaxPaths.from_root(tmp_path))
    setup, folds = protocols.cross_subject_setup(
        port_loader(**kw), subjects, config=CFG, device="cpu")
    specs = captured["specs"]
    assert len(folds) == len(specs) == 2 * len(subjects)
    for g, spec in enumerate(specs):
        for which, (idx, n) in enumerate(((spec.train_idx, spec.train_n),
                                          (spec.val_idx, spec.val_n),
                                          (spec.test_idx, spec.test_n))):
            np.testing.assert_array_equal(folds[g][which],
                                          np.asarray(idx)[:int(n)])
        np.testing.assert_array_equal(setup.spec.train_idx[g].numpy(),
                                      np.asarray(spec.train_idx))
        np.testing.assert_array_equal(setup.spec.val_idx[g].numpy(),
                                      np.asarray(spec.val_idx))
        np.testing.assert_array_equal(setup.spec.test_idx[g].numpy(),
                                      np.asarray(spec.test_idx))


def test_cross_subject_needs_seven_subjects(tmp_path):
    with pytest.raises(ValueError, match="at least 7 subjects"):
        protocols.cross_subject_training(
            epochs=1, config=CFG, subjects=tuple(range(1, 7)),
            loader=port_loader(n_trials=8, n_channels=4, n_times=64),
            paths=Paths.from_root(tmp_path), device="cpu")


ACC_CASES = {
    # 7 subjects x 2 repeats; a tie for the minimum validation loss at
    # folds 3 and 9 (the first wins), and one at the end.
    "tie": (np.array([50, 25, 75, 100, 62.5, 37.5, 50, 25, 12.5, 87.5,
                      50, 50, 75, 25], np.float32),
            np.array([.9, .8, .7, .3, .5, .6, .4, .8, .9, .3, .7, .6, .5,
                      .9], np.float32)),
    "last": (np.linspace(10, 90, 14).astype(np.float32),
             np.linspace(1.0, 0.2, 14).astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_selection_and_summary_equal_the_jax_protocol(monkeypatch, tmp_path,
                                                      caplog, case):
    fold_test, min_val_loss = ACC_CASES[case]
    n = len(fold_test)

    def fake_run_folds(model, specs, pool_x, pool_y, **kw):
        results = SimpleNamespace(
            test_accuracy=fold_test, min_val_loss=min_val_loss,
            best_state={"which": np.arange(n)})
        return results, 1.0, float(n), 0.0

    monkeypatch.setattr(jax_protocols, "_run_folds", fake_run_folds)
    with caplog.at_level(logging.INFO):
        want = jax_protocols.cross_subject_training(
            epochs=1, config=JAX_CFG, subjects=tuple(range(1, 8)),
            loader=make_loader(n_trials=8, n_channels=4, n_times=64),
            paths=JaxPaths.from_root(tmp_path), save_models=False)
    (record,) = [r for r in caplog.records
                 if r.msg.startswith("Overall Average Test Accuracy: ")]
    per_subject, avg_all, std_err, best = protocols.cross_subject_summary(
        fold_test, min_val_loss, 7, 2)
    assert best == int(want.best_states[0]["which"])
    assert per_subject == want.per_subject_test_acc
    assert avg_all == want.avg_test_acc
    assert (avg_all, std_err) == record.args


def test_cs_report_equals_the_jax_report(tmp_path):
    accs, avg = [61.25, 70.0, 61.25, 40.5, 55.0, 90.0, 33.3], 58.76
    port = report.generate_cs_report(None, accs, avg, epochs=7,
                                     subjects=(2, 5, 9, 1, 3, 4, 6),
                                     config=CFG,
                                     paths=Paths.from_root(tmp_path / "p"))
    jax = jax_report.generate_cs_report(
        None, accs, avg, epochs=7, subjects=(2, 5, 9, 1, 3, 4, 6),
        config=JAX_CFG, paths=JaxPaths.from_root(tmp_path / "j"))
    got, want = (json.loads(Path(p).read_text()) for p in (port, jax))
    got.pop("timestamp")
    want.pop("timestamp")
    assert got == want
    assert Path(port).with_name("latest_cross_subject_report.json").is_file()


def test_learns_above_chance_and_models_load_in_both(tmp_path):
    paths = Paths.from_root(tmp_path)
    result = protocols.cross_subject_training(
        epochs=8, config=CFG, subjects=tuple(range(1, 8)), paths=paths,
        seed=0, device="cpu",
        loader=port_loader(n_trials=32, n_channels=8, n_times=64,
                           class_sep=1.5))
    assert result.fold_test_acc.shape == (14,)
    assert np.all(np.isfinite(result.fold_min_val_loss))
    assert result.avg_test_acc > 40.0          # chance is 25%
    assert len(result.best_states) == 1
    npz = paths.models / "cross_subject_best_model.npz"
    assert npz.with_suffix(".pth").is_file()
    params, bs, meta = jax_ckpt.load_checkpoint(npz)
    assert meta == {"model": "eegnet", "n_channels": 8, "n_times": 64,
                    "F1": 8, "D": 2}
    engine = InferenceEngine.from_checkpoint(npz, device="cpu")
    assert engine.digest == jax_engine.variables_digest(params, bs)
    best = int(np.argmin(result.fold_min_val_loss))
    for name, value in result.best_states[0].items():
        assert torch.equal(value, result.folds.best_state.state_dict(best)[
            name]), name


# --- the CLI ---------------------------------------------------------------

def _write_processed_tree(root: Path, subjects):
    loader = make_loader(n_trials=16, n_channels=4, n_times=64,
                         class_sep=1.5)
    for s in subjects:
        for mode in ("Train", "Eval"):
            ds = loader(s, mode)
            save_trials(BCICI2ADataset(X=ds.X, y=ds.y),
                        root / "data" / "processed" / mode
                        / trials_filename(s, mode))


def _keys(tree):
    if isinstance(tree, dict):
        return {(k,) + rest for k, v in tree.items() for rest in
                ({()} | _keys(v))}
    if isinstance(tree, list) and tree:
        return _keys(tree[0])
    return set()


def test_cli_cross_subject_writes_the_jax_report(tmp_path):
    _write_processed_tree(tmp_path, range(1, 8))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(EEGTPU_PLATFORM="cpu", EEGTPU_DATA_ROOT=str(tmp_path),
               EEGTPU_NO_LOG_FILE="1")
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--trainingType", "Cross-Subject", "--epochs", "2",
         "--subjects", "1,2,3,4,5,6,7"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    paths = Paths.from_root(tmp_path)
    got = json.loads((paths.reports / "latest_cross_subject_report.json"
                      ).read_text())
    jax_paths = JaxPaths.from_root(tmp_path / "jax")
    jax_report.generate_cs_report(None, [50.0] * 7, 50.0, epochs=2,
                                  subjects=tuple(range(1, 8)),
                                  paths=jax_paths)
    want = json.loads((jax_paths.reports
                       / "latest_cross_subject_report.json").read_text())
    assert _keys(got) == _keys(want)
    assert got["model_parameters"]["total_folds"] == 70
    assert got["model_parameters"]["epochs"] == 2
    for ext in ("pth", "npz"):
        assert (paths.models / f"cross_subject_best_model.{ext}").is_file()
    assert not list(paths.models.glob("*.run.npz*"))


PARSE_ERRORS = {
    "negative_cadence": (["--checkpointEvery", "-1"], 2),
    "resume_one_pass": (["--resume", "--checkpointEvery", "0"], 2),
    "resume_short_auto": (["--resume", "--epochs", "100"], 2),
    "cs_six_subjects": (["--trainingType", "Cross-Subject", "--subjects",
                         "1,2,3,4,5,6"], "at least 7 subjects"),
}


@pytest.mark.parametrize("name", sorted(PARSE_ERRORS))
def test_cli_parse_time_errors(name, monkeypatch, tmp_path):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    argv, want = PARSE_ERRORS[name]
    with pytest.raises(SystemExit) as exc:
        train_cli.main(argv)
    if isinstance(want, int):
        assert exc.value.code == want
    else:
        assert want in str(exc.value.code)
    assert not (tmp_path / "models").exists()


def test_cli_cross_subject_refuses_a_host_without_cuda(monkeypatch,
                                                       tmp_path):
    monkeypatch.delenv("EEGTPU_PLATFORM", raising=False)
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        train_cli.main(["--trainingType", "Cross-Subject", "--epochs", "1"])


def test_cli_stop_and_resume_match_the_unbroken_run(monkeypatch, tmp_path):
    """The CPU rehearsal of the smoke's drill: a stop after epoch 2 of 4
    exits 75 with the epoch-2 snapshot on disk; ``--resume`` finishes with
    the models the unbroken run writes."""
    for root in ("stopped", "unbroken"):
        _write_processed_tree(tmp_path / root, (1, 2))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    argv = ["--epochs", "4", "--checkpointEvery", "2", "--subjects", "1,2"]
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path / "unbroken"))
    assert train_cli.main(argv) == 0

    run_epoch = loop.FoldTrainer.run_epoch

    def stop_after_epoch_2(self):
        run_epoch(self)
        if self.epoch == 2:
            preempt.request()

    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path / "stopped"))
    monkeypatch.setattr(loop.FoldTrainer, "run_epoch", stop_after_epoch_2)
    assert train_cli.main(argv) == preempt.EX_PREEMPTED
    models = tmp_path / "stopped" / "models"
    snap = models / "within_subject_eegnet.run.npz"
    assert ckpt.load_run_snapshot(
        snap, ckpt.read_snapshot_signature(snap))[1] == 2
    assert not (models / "subject_01_best_model.npz").exists()

    monkeypatch.setattr(loop.FoldTrainer, "run_epoch", run_epoch)
    preempt.clear()
    assert train_cli.main(argv + ["--resume"]) == 0
    assert not list(models.glob("*.run.npz*"))
    reports = [json.loads((tmp_path / r / "reports"
                           / "latest_within_subject_report.json").read_text())
               for r in ("stopped", "unbroken")]
    assert reports[0]["per_subject_results"] \
        == reports[1]["per_subject_results"]
    for s in (1, 2):
        name = f"subject_{s:02d}_best_model.npz"
        got, _ = ckpt.load_checkpoint(models / name)
        want, _ = ckpt.load_checkpoint(tmp_path / "unbroken" / "models"
                                       / name)
        for key in want:
            assert torch.equal(got[key], want[key]), key
