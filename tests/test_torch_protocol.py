"""The port's within-subject protocol, report and training CLI.

- The fold index sets equal the JAX protocol's (its ``_run_folds`` is
  stubbed to capture them, so nothing compiles).
- ``within_subject_training`` on ``tests/synthetic.py``'s separable loader,
  with ``EEGTPU_PLATFORM=cpu``, learns above chance (the bar of
  ``tests/test_protocols.py``) and writes both model files per subject.
- ``python -m eegnetreplication_tpu_torch.train --epochs 2 --subjects 1,2``
  on a synthetic processed tree writes a report with exactly the JAX
  report's keys; the trained ``.npz`` loads in the port's engine and in the
  JAX ``load_checkpoint`` with the same ``variables_digest``.
- Every flag whose machinery is not ported stops the CLI (the mesh flags
  and a ``--chaos`` plan naming ``fetch.download``, ported since, now
  train); without CUDA and without
  ``EEGTPU_PLATFORM=cpu`` it raises; a stop request exits 75.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from synthetic import make_loader
from torch_port_cases import (
    child_env,
    train_over_a_mesh,
    write_processed_tree,
)

from eegnetreplication_tpu.config import DEFAULT_TRAINING as JAX_DEFAULT
from eegnetreplication_tpu.config import Paths as JaxPaths
from eegnetreplication_tpu.serve import engine as jax_engine
from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu.training import protocols as jax_protocols
from eegnetreplication_tpu.training import report as jax_report
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
from eegnetreplication_tpu_torch.training import protocols, report

REPO = Path(__file__).resolve().parents[1]
CFG = DEFAULT_TRAINING.replace(batch_size=16)


def port_loader(**kw):
    """``tests/synthetic.py``'s loader, in the port's container."""
    jax_loader = make_loader(**kw)

    def loader(subject, mode):
        ds = jax_loader(subject, mode)
        return BCICI2ADataset(X=ds.X, y=ds.y)

    return loader


class _Captured(Exception):
    pass


def test_fold_index_sets_equal_the_jax_protocol(monkeypatch, tmp_path):
    captured = {}

    def capture(model, specs, pool_x, pool_y, **kw):
        captured["specs"] = specs
        raise _Captured

    monkeypatch.setattr(jax_protocols, "_run_folds", capture)
    kw = dict(n_trials=23, n_channels=4, n_times=64)
    with pytest.raises(_Captured):
        jax_protocols.within_subject_training(
            epochs=1, config=JAX_DEFAULT.replace(batch_size=16),
            loader=make_loader(**kw), subjects=(1, 3, 2),
            paths=JaxPaths.from_root(tmp_path))
    loader = port_loader(**kw)
    datasets = [loader(s, "Train").concat(loader(s, "Eval"))
                for s in (1, 3, 2)]
    _, _, offsets = protocols.build_pool(datasets)
    folds = protocols.within_subject_folds(offsets, CFG)
    assert len(folds) == len(captured["specs"]) == 12
    for fold, spec in zip(folds, captured["specs"]):
        for ours, idx, n in zip(fold, (spec.train_idx, spec.val_idx,
                                       spec.test_idx),
                                (spec.train_n, spec.val_n, spec.test_n)):
            np.testing.assert_array_equal(ours, np.asarray(idx)[:int(n)])


def test_learns_above_chance_and_saves_both_models(monkeypatch, tmp_path):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    paths = Paths.from_root(tmp_path)
    result = protocols.within_subject_training(
        epochs=25, config=CFG, subjects=(1, 2, 3), paths=paths, seed=0,
        loader=port_loader(n_trials=32, n_channels=6, n_times=64,
                           class_sep=1.5))
    assert len(result.per_subject_test_acc) == 3
    assert result.fold_test_acc.shape == (12,)
    assert np.all(np.isfinite(result.fold_min_val_loss))
    assert np.isclose(result.avg_test_acc,
                      np.mean(result.per_subject_test_acc))
    assert result.folds.train_losses.shape == (12, 25)
    assert result.epoch_throughput > 0
    # separable synthetic task: better than the 25% chance level
    assert result.avg_test_acc > 40.0
    for s in (1, 2, 3):
        for ext in ("pth", "npz"):
            assert (paths.models / f"subject_{s:02d}_best_model.{ext}"
                    ).is_file()


def _keys(tree):
    """Every key path of a JSON tree (list entries by their first item)."""
    if isinstance(tree, dict):
        return {(k,) + rest for k, v in tree.items() for rest in
                ({()} | _keys(v))}
    if isinstance(tree, list) and tree:
        return _keys(tree[0])
    return set()


def test_cli_report_has_the_jax_keys_and_checkpoints_load_in_both(tmp_path):
    write_processed_tree(tmp_path)
    env = child_env({k: v for k, v in os.environ.items()
                     if k != "PYTHONPATH"})
    env.update(EEGTPU_PLATFORM="cpu", EEGTPU_DATA_ROOT=str(tmp_path),
               EEGTPU_NO_LOG_FILE="1")
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--epochs", "2", "--subjects", "1,2"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    paths = Paths.from_root(tmp_path)
    got = json.loads((paths.reports / "latest_within_subject_report.json"
                      ).read_text())
    jax_paths = JaxPaths.from_root(tmp_path / "jax")
    jax_report.generate_ws_report([50.0, 75.0], 62.5, [None, None],
                                  epochs=2, subjects=(1, 2),
                                  paths=jax_paths)
    want = json.loads((jax_paths.reports
                       / "latest_within_subject_report.json").read_text())
    assert _keys(got) == _keys(want)
    assert got["model_parameters"]["epochs"] == 2
    assert [e["model_saved"] for e in got["per_subject_results"]] == [
        "subject_01_best_model.pth", "subject_02_best_model.pth"]
    for s in (1, 2):
        npz = paths.models / f"subject_{s:02d}_best_model.npz"
        assert npz.with_suffix(".pth").is_file()
        params, bs, meta = jax_ckpt.load_checkpoint(npz)
        assert meta == {"model": "eegnet", "n_channels": 4, "n_times": 64,
                        "F1": 8, "D": 2}
        engine = InferenceEngine.from_checkpoint(npz, device="cpu")
        assert engine.digest == jax_engine.variables_digest(params, bs)


def test_report_equals_the_jax_report(tmp_path):
    accs, avg = [61.25, 70.0, 61.25], 64.1666
    port = report.generate_ws_report(accs, avg, [1, 2, 3], epochs=7,
                                     subjects=(2, 5, 9), config=CFG,
                                     paths=Paths.from_root(tmp_path / "p"))
    jax = jax_report.generate_ws_report(
        accs, avg, [1, 2, 3], epochs=7, subjects=(2, 5, 9),
        config=JAX_DEFAULT.replace(batch_size=16),
        paths=JaxPaths.from_root(tmp_path / "j"))
    got, want = (json.loads(Path(p).read_text()) for p in (port, jax))
    got.pop("timestamp")
    want.pop("timestamp")
    assert got == want


UNPORTED = {
    "mesh_fold": ["--meshFold", "2"],
    "mesh_data": ["--meshData", "2"],
    "precision": ["--precision", "bf16"],
    "orbax": ["--ckptFormat", "orbax"],
    # a plan naming the dataset-download site, which training never fires
    "chaos": ["--chaos", "fetch.download:times=1"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_flags_stop_the_cli(name, capsys, tmp_path, monkeypatch):
    if name.startswith("mesh_"):
        # ported: the CLI trains under that mesh and writes its models
        train_over_a_mesh(UNPORTED[name], tmp_path)
        return
    if name in ("chaos", "precision"):
        # ported: the plan parses, as in the JAX CLI, and the run trains;
        # bf16 trains in its numerics mode and writes f32 models
        write_processed_tree(tmp_path, subjects=(1,))
        monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
        monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
        monkeypatch.chdir(tmp_path)
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
        assert train_cli.main(UNPORTED[name] + ["--epochs", "1",
                                                "--subjects", "1"]) == 0
        npz = tmp_path / "models" / "subject_01_best_model.npz"
        assert npz.is_file()
        with np.load(npz) as saved:
            assert {saved[k].dtype for k in saved.files
                    if saved[k].dtype.kind == "f"} == {np.dtype("float32")}
        assert "not ported" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as exc:
        train_cli.main(UNPORTED[name] + ["--epochs", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP" in err


OBS_FLAGS = {
    "metrics_dir": ["--metricsDir", "m"],
    "profile_dir": ["--profileDir", "p"],
    "debug_nans": ["--debugNans"],
}


@pytest.mark.parametrize("name", sorted(OBS_FLAGS))
def test_obs_flags_run_and_exit_0(name, monkeypatch, tmp_path):
    write_processed_tree(tmp_path, subjects=(1,))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    # As on the card's machine: no TensorBoard writer (importing it here
    # drags in TensorFlow), so the scalar mirror stays inert.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train_cli.main(OBS_FLAGS[name] + ["--epochs", "1", "--subjects",
                                             "1"]) == 0
    root = tmp_path / "m" if name == "metrics_dir" \
        else tmp_path / "reports" / "obs"
    (run,) = root.iterdir()
    assert (run / "events.jsonl").is_file() and (run / "metrics.json"
                                                 ).is_file()
    if name == "profile_dir":
        (trace,) = (tmp_path / "p").glob("trace-*.json")
        assert json.loads(trace.read_text())["traceEvents"]


def test_cli_refuses_a_host_without_cuda(monkeypatch, tmp_path):
    monkeypatch.delenv("EEGTPU_PLATFORM", raising=False)
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        train_cli.main(["--epochs", "1", "--subjects", "1"])


def test_generate_report_false_writes_no_report(monkeypatch, tmp_path):
    write_processed_tree(tmp_path, subjects=(1,))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    assert train_cli.main(["--epochs", "1", "--subjects", "1",
                           "--generateReport", "False"]) == 0
    assert not list((tmp_path / "reports").glob("*.json"))
    assert (tmp_path / "models" / "subject_01_best_model.npz").is_file()


def test_a_stop_request_exits_75_at_an_epoch_boundary(monkeypatch,
                                                      tmp_path):
    write_processed_tree(tmp_path, subjects=(1,))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    preempt.request()
    try:
        assert train_cli.main(["--epochs", "3", "--subjects", "1"]) \
            == preempt.EX_PREEMPTED
    finally:
        preempt.clear()
    assert not (tmp_path / "models").exists()
