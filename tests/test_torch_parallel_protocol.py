"""The protocols and the train CLI over a mesh of gloo ranks on the CPU.

- ``train --meshFold 2`` writes the JAX report's keys and the same best
  models, bit for bit, as ``--maxFoldsPerProgram`` with half the folds;
  ``--meshFold 2 --meshData 2`` trains and journals; both journals carry
  ``mesh_shape`` as the JAX CLI writes it and the ranks' start in
  ``run_start``, and a clean ``run_end``.
- ``within_subject_training`` over 3 fold ranks (8 folds padded to 9), fed
  the JAX run's initial states and shuffle slots, gives the fold
  accuracies of JAX ``within_subject_training(mesh=make_mesh(n_fold=3))``
  within 1e-3; over ``fold 2 x data 2`` at dropout 0, those of the
  unsharded run within 1e-3 (JAX ``tests/test_parallel.py``'s bar).
- ``batch_size % meshData`` is refused with the JAX message; the
  permutation test's runs shard over the fold axis (padded) and give the
  unsharded accuracies at dropout 0.
- The drills: SIGTERM to the launcher mid-run exits 75 with the snapshot
  on disk and ``--resume`` under the same mesh is the unbroken run bit for
  bit; a rank SIGKILLed mid-epoch fails the run within the gloo timeout +
  10 s, and a SIGKILLed launcher takes its ranks with it.
"""

import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
from synthetic import make_loader
from torch_port_cases import child_env, write_processed_tree

from eegnetreplication_tpu.config import DEFAULT_TRAINING as JAX_DEFAULT
from eegnetreplication_tpu.config import Paths as JaxPaths
from eegnetreplication_tpu.parallel import make_mesh as jax_make_mesh
from eegnetreplication_tpu.training import loop as jax_loop
from eegnetreplication_tpu.training import protocols as jax_protocols
from eegnetreplication_tpu.training import report as jax_report
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.training import protocols
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables_stacked,
)

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_parallel_ranks.py"
SUBJECTS = (1, 2)
N_TRIALS, C, T = 24, 4, 64


def _env(root, **extra):
    env = child_env({k: v for k, v in os.environ.items()
                     if k != "PYTHONPATH"})
    env.update(EEGTPU_PLATFORM="cpu", EEGTPU_DATA_ROOT=str(root),
               EEGTPU_NO_LOG_FILE="1", PYTHONPATH=str(REPO), **extra)
    return env


def _train(root, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--subjects", "1,2", "--metricsDir", str(root / "obs"), *args],
        cwd=REPO, env=_env(root), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _journal(root) -> list[dict]:
    (run,) = sorted((root / "obs").iterdir())
    return [json.loads(line)
            for line in (run / "events.jsonl").read_text().splitlines()]


def _models(root) -> dict[str, np.ndarray]:
    out = {}
    for s in SUBJECTS:
        with np.load(root / "models" / f"subject_{s:02d}_best_model.npz") as f:
            out.update({f"{s}/{k}": f[k] for k in f.files})
        out[f"{s}/pth"] = np.frombuffer(
            (root / "models" / f"subject_{s:02d}_best_model.pth"
             ).read_bytes(), np.uint8)
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Three CLI runs at once, each over its own copy of one tree."""
    base = tmp_path_factory.mktemp("mesh_cli")
    write_processed_tree(base / "tree", subjects=SUBJECTS)
    runs = {"fold2": ["--meshFold", "2"],
            "grouped": ["--maxFoldsPerProgram", "4"],
            "fold2_data2": ["--meshFold", "2", "--meshData", "2"]}
    procs = {}
    for name, args in runs.items():
        shutil.copytree(base / "tree", base / name)
        procs[name] = _train(base / name, "--epochs", "3",
                             "--checkpointEvery", "1", *args)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err[-3000:])
    return base


def _report_keys(tree):
    if isinstance(tree, dict):
        return {k: _report_keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree:
        return [_report_keys(tree[0])]
    return None


def test_mesh_fold_models_are_the_grouped_runs_bit_for_bit(cli_runs):
    got, want = _models(cli_runs / "fold2"), _models(cli_runs / "grouped")
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name, shape", [
    ("fold2", {"fold": 2, "data": 1, "model": 1}),
    ("fold2_data2", {"fold": 2, "data": 2, "model": 1})])
def test_mesh_runs_write_the_jax_report_and_journal(cli_runs, tmp_path, name,
                                                    shape):
    root = cli_runs / name
    got = json.loads((root / "reports" / "latest_within_subject_report.json"
                      ).read_text())
    jax_paths = JaxPaths.from_root(tmp_path)
    jax_report.generate_ws_report([50.0, 75.0], 62.5, [None, None],
                                  epochs=3, subjects=SUBJECTS,
                                  paths=jax_paths)
    want = json.loads((jax_paths.reports
                       / "latest_within_subject_report.json").read_text())
    assert _report_keys(got) == _report_keys(want)
    events = _journal(root)
    assert events[0]["event"] == "run_start"
    assert events[0]["mesh_shape"] == shape
    assert events[0]["world_size"] == math.prod(shape.values())
    assert 0 < events[0]["rank_join_s"] <= events[0]["rank_start_s"]
    assert events[-1]["event"] == "run_end" and events[-1]["status"] == "ok"
    assert set(events[-1]["kernel_launches"]) == {"block1",
                                                  "block1_stacked"}
    # only rank 0 journals: one run directory
    assert len(list((root / "obs").iterdir())) == 1


def test_batch_not_divisible_by_mesh_data_is_refused(capsys, monkeypatch,
                                                     tmp_path):
    cfg = JAX_DEFAULT.replace(batch_size=64)
    with pytest.raises(ValueError) as jax_exc:
        jax_loop._mesh_data_sharding(jax_make_mesh(
            n_fold=1, n_data=3, devices=jax.devices()[:3]), cfg.batch_size)
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--meshData", "3", "--epochs", "1"])
    assert exc.value.code == 2
    assert str(jax_exc.value) in " ".join(capsys.readouterr().err.split())
    # the protocol refuses it before it trains
    from eegnetreplication_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.Mesh({"fold": 1, "data": 3, "model": 1}, 0,
                         {"fold": 0, "data": 0, "model": 0}, (0, 1, 2))
    with pytest.raises(ValueError) as port_exc:
        protocols.within_subject_training(1, mesh=mesh, device="cpu",
                                          loader=None)
    assert str(port_exc.value) == str(jax_exc.value)


# -- the protocol against JAX's sharded run, and fold x data ----------------

def _pools():
    loader = make_loader(n_trials=N_TRIALS, n_channels=C, n_times=T)
    out = {}
    for s in SUBJECTS:
        for mode in ("Train", "Eval"):
            ds = loader(s, mode)
            out[f"X/{s}/{mode}"], out[f"y/{s}/{mode}"] = ds.X, ds.y
    return loader, out


def _ranks(tmp_path, inputs, what="protocol"):
    np.savez(tmp_path / "in.npz", **inputs)
    out = subprocess.run(
        [sys.executable, str(RANKS), what, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], cwd=REPO, env=_env(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(tmp_path / "out.npz") as f:
        return {k: f[k] for k in f.files}


def test_sharded_protocol_matches_the_jax_sharded_run(tmp_path, monkeypatch):
    epochs, batch = 3, 16
    loader, pools = _pools()
    captured = {}
    make = jax_protocols.make_multi_fold_trainer

    def capture(*a, **kw):
        trainer = make(*a, **kw)

        def run(pool_x, pool_y, stacked, states, keys):
            captured.update(stacked=stacked, states=states, keys=keys)
            return trainer(pool_x, pool_y, stacked, states, keys)

        return run

    monkeypatch.setattr(jax_protocols, "make_multi_fold_trainer", capture)
    cfg = JAX_DEFAULT.replace(batch_size=batch, dropout_within_subject=0.0)
    want = jax_protocols.within_subject_training(
        epochs, config=cfg, loader=loader, subjects=SUBJECTS,
        paths=JaxPaths.from_root(tmp_path / "j"), save_models=False,
        checkpoint_every=0,
        mesh=jax_make_mesh(n_fold=3, devices=jax.devices()[:3]))
    n_real = len(want.fold_test_acc)
    assert n_real == 8 and captured["keys"].shape[0] == 9   # padded
    stacked = jax.tree_util.tree_map(np.asarray, captured["stacked"])
    keys = np.asarray(captured["keys"])
    n_slots = math.ceil(stacked.train_idx.shape[1] / batch) * batch
    idx = np.zeros((epochs, n_real, n_slots), np.int64)
    wts = np.zeros((epochs, n_real, n_slots), np.float32)
    for g in range(n_real):
        epoch_keys = jax.random.split(keys[g], epochs)
        for e in range(epochs):
            shuffle_key, _ = jax.random.split(epoch_keys[e])
            p, w = jax_loop._shuffled_slots(
                shuffle_key, stacked.train_idx[g], stacked.train_n[g],
                n_slots)
            idx[e, g], wts[e, g] = np.asarray(p), np.asarray(w)
    states = captured["states"]
    init = from_jax_variables_stacked(
        jax.tree_util.tree_map(np.asarray, states.params),
        jax.tree_util.tree_map(np.asarray, states.batch_stats))
    got = _ranks(tmp_path, {
        **pools, "mesh": np.array([3, 1]), "run": np.array([batch, epochs]),
        "dropout": np.array(0.0), "subjects": np.array(SUBJECTS),
        "slots_idx": idx, "slots_w": wts,
        **{f"init/{k}": v.numpy()[:n_real] for k, v in init.items()
           if not k.endswith("num_batches_tracked")}})
    np.testing.assert_allclose(got["fold_test_acc"], want.fold_test_acc,
                               atol=1e-3)


def test_fold_by_data_mesh_matches_the_unsharded_run(tmp_path):
    epochs, batch = 3, 16
    loader, pools = _pools()
    got = _ranks(tmp_path, {
        **pools, "mesh": np.array([2, 2]), "run": np.array([batch, epochs]),
        "dropout": np.array(0.0), "subjects": np.array(SUBJECTS)})
    cfg = DEFAULT_TRAINING.replace(batch_size=batch,
                                   dropout_within_subject=0.0)

    def port_loader(subject, mode):
        ds = loader(subject, mode)
        return BCICI2ADataset(X=ds.X, y=ds.y)

    plain = protocols.within_subject_training(
        epochs, config=cfg, loader=port_loader, subjects=SUBJECTS,
        paths=protocols.Paths.from_root(tmp_path / "p"), save_models=False,
        device="cpu", checkpoint_every=0)
    np.testing.assert_allclose(got["fold_test_acc"], plain.fold_test_acc,
                               atol=1e-3)
    np.testing.assert_allclose(got["val_losses"],
                               plain.folds.val_losses.numpy(), atol=1e-3)


def test_permutation_runs_shard_over_the_fold_axis(tmp_path):
    """5 runs (the real one and 4 permutations) over 2 fold ranks, padded
    to 6, at dropout 0: the accuracies of the unsharded test."""
    from eegnetreplication_tpu_torch.training.permutation import (
        permutation_test,
    )

    ds = make_loader(n_trials=40, n_channels=C, n_times=T)(1, "Train")
    cfg = DEFAULT_TRAINING.replace(batch_size=16,
                                   dropout_within_subject=0.0)
    got = _ranks(tmp_path, {
        "X": ds.X, "y": ds.y, "mesh": np.array([2, 1]),
        "run": np.array([4, 2]), "batch": np.array(16),
        "dropout": np.array(0.0)}, what="permutation")
    want = permutation_test(ds.X, ds.y, n_permutations=4, epochs=2,
                            config=cfg, device="cpu")
    assert abs(float(got["real"]) - want.real_accuracy) <= 1e-3
    np.testing.assert_allclose(got["permuted"], want.permuted_accuracies,
                               atol=1e-3)
    assert float(got["p_value"]) == want.p_value


# -- drills -------------------------------------------------------------------

def _wait_for(path: Path, proc, timeout=120.0):
    t0 = time.monotonic()
    while not path.exists():
        assert proc.poll() is None, proc.stderr.read()[-3000:]
        assert time.monotonic() - t0 < timeout, f"no {path}"
        time.sleep(0.05)


def test_sigterm_exits_75_and_resume_is_the_unbroken_run(tmp_path):
    write_processed_tree(tmp_path / "tree", subjects=SUBJECTS)
    args = ["--epochs", "60", "--checkpointEvery", "2", "--meshFold", "2",
            "--meshData", "2"]
    for name in ("unbroken", "stopped"):
        shutil.copytree(tmp_path / "tree", tmp_path / name)
    unbroken = _train(tmp_path / "unbroken", *args)
    stopped = _train(tmp_path / "stopped", *args)
    snap = tmp_path / "stopped" / "models" / "within_subject_eegnet.run.npz"
    _wait_for(snap, stopped)
    stopped.send_signal(signal.SIGTERM)
    _, err = stopped.communicate(timeout=120)
    assert stopped.returncode == 75, err[-3000:]
    assert snap.exists()
    assert _journal(tmp_path / "stopped")[-1]["status"] == "preempted"
    resumed = _train(tmp_path / "stopped", *args, "--resume")
    for proc in (unbroken, resumed):
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    got, want = (_models(tmp_path / n) for n in ("stopped", "unbroken"))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert not snap.exists()


def _children(pid: int) -> list[int]:
    out = subprocess.run(["pgrep", "-P", str(pid)], capture_output=True,
                         text=True)
    return [int(p) for p in out.stdout.split()]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] not in ("Z", "X")
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("victim", ["rank", "launcher"])
def test_a_killed_process_leaves_no_rank_behind(tmp_path, victim):
    write_processed_tree(tmp_path, subjects=SUBJECTS)
    timeout_s = 20.0
    proc = subprocess.Popen(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--subjects", "1,2", "--epochs", "100000", "--checkpointEvery", "2",
         "--meshFold", "2", "--meshData", "2"], cwd=REPO,
        env=_env(tmp_path, EEGTPU_MESH_TIMEOUT_S=str(timeout_s)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    _wait_for(tmp_path / "models" / "within_subject_eegnet.run.npz", proc)
    ranks = _children(proc.pid)
    assert len(ranks) == 4
    t0 = time.monotonic()
    os.kill(ranks[1] if victim == "rank" else proc.pid, signal.SIGKILL)
    code = proc.wait(timeout=timeout_s + 10.0)
    if victim == "rank":
        assert code == 128 + signal.SIGKILL
        assert time.monotonic() - t0 < timeout_s + 10.0
    deadline = time.monotonic() + 10.0
    while any(_alive(r) for r in ranks) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [r for r in ranks if _alive(r)]
