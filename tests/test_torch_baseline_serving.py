"""Baseline checkpoints across the packages, served by the port.

ShallowConvNet and DeepConvNet at the small sizes of
``torch_port_cases.BASELINES``, weights from the JAX ``model.init`` with
BatchNorm moved off the identity:

- a checkpoint written by either package loads in the other with the same
  ``variables_digest``, and the same weights bit for bit;
- on a JAX-written baseline ``.npz``, the port's engine (every bucket) and
  its ``predict`` CLI give the JAX engine's predictions;
- ``--precision int8`` and ``--zoo`` do with a baseline what the JAX
  package does with one: serve it through the generic path (int8: the
  kernels dequantized, then the plain forward) behind the same gates.
  The quant gate's verdict and agreement, and the stack gate's verdict,
  equal the JAX gates' on the same weights and gate set, and the stacked
  engine's predictions equal the JAX stacked engine's;
- the protocols write a baseline's ``.npz`` with the JAX metadata and no
  ``.pth``; the ``train`` CLI runs both protocols for both baselines on
  the CPU and ``predict`` answers their checkpoints.
"""

import json

import numpy as np
import pytest
from torch_port_cases import (
    BASELINES,
    jax_baseline,
    port_baseline,
    write_processed_tree,
)

from eegnetreplication_tpu.serve import engine as jax_engine
from eegnetreplication_tpu.serve import zoo as jax_zoo
from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu_torch import predict as predict_cli
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.serve import engine, zoo
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training import protocols

NAMES = sorted(BASELINES)
BUCKETS = (1, 8, 32)


def _meta(name):
    c, t = BASELINES[name]
    return {"model": name, "n_channels": c, "n_times": t}


def _trials(name, n=40, seed=3):
    c, t = BASELINES[name]
    return np.random.RandomState(seed).randn(n, c, t).astype(np.float32)


@pytest.fixture(scope="module", params=NAMES)
def jax_written(request, tmp_path_factory):
    name = request.param
    c, t = BASELINES[name]
    _, params, stats = jax_baseline(name, c, t, seed=21)
    path = tmp_path_factory.mktemp(name) / f"{name}.npz"
    jax_ckpt.save_checkpoint(path, params, stats, metadata=_meta(name))
    return name, path, params, stats


def test_a_jax_checkpoint_loads_with_the_same_digest(jax_written):
    name, path, params, stats = jax_written
    sd, meta = ckpt_lib.load_checkpoint(path)
    assert meta == _meta(name)
    want = jax_engine.variables_digest(params, stats)
    assert engine.variables_digest(*ckpt_lib.to_jax_variables(sd)) == want
    model = engine.load_model_from_checkpoint(path, device="cpu")
    assert type(model).__name__ == {"shallow_convnet": "ShallowConvNet",
                                    "deep_convnet": "DeepConvNet"}[name]
    assert engine.model_digest(model) == want


@pytest.mark.parametrize("name", NAMES)
def test_a_port_checkpoint_loads_in_jax_with_the_same_digest(name,
                                                             tmp_path):
    c, t = BASELINES[name]
    _, params, stats = jax_baseline(name, c, t, seed=22)
    model = port_baseline(name, params, stats, c, t)
    path = ckpt_lib.save_checkpoint(tmp_path / "m.npz", model.state_dict(),
                                    metadata=_meta(name))
    jparams, jstats, meta = jax_ckpt.load_checkpoint(path)
    assert meta == _meta(name)
    assert jax_engine.variables_digest(jparams, jstats) \
        == engine.model_digest(model)
    flat = ckpt_lib.flatten_variables(params, stats)
    got = ckpt_lib.flatten_variables(jparams, jstats)
    assert sorted(flat) == sorted(got)
    for key in flat:
        np.testing.assert_array_equal(np.asarray(got[key]), flat[key])
    jmodel, _, _ = jax_engine.load_model_from_checkpoint(path)
    assert type(jmodel).__name__ == type(model).__name__


def test_engine_and_predict_give_the_jax_engine_predictions(jax_written,
                                                            tmp_path,
                                                            capsys):
    name, path, _, _ = jax_written
    x = _trials(name)
    want = jax_engine.InferenceEngine.from_checkpoint(
        path, BUCKETS, warm=False).infer(x)
    port = engine.InferenceEngine(
        engine.load_model_from_checkpoint(path, device="cpu"), BUCKETS,
        device="cpu")
    port.warmup()
    np.testing.assert_array_equal(port.infer(x), want)
    for b in BUCKETS:   # every bucket, padding included
        np.testing.assert_array_equal(port.infer(x[:b - 1 or 1]),
                                      want[:b - 1 or 1])
    # labelled with the JAX predictions: predict scores them all correct
    trials = tmp_path / "A01E-trials.npz"
    np.savez(trials, X=x, y=want.astype(np.int64))
    assert predict_cli.main(["--checkpoint", str(path), "--input",
                             str(trials)]) == 0
    assert capsys.readouterr().out.strip() == "accuracy: 100.00%"


def _gate_set(name):
    return [("gate", _trials(name, n=64, seed=31))]


def test_int8_serves_a_baseline_behind_the_jax_gate(jax_written):
    """The JAX package serves an int8 baseline through its generic path
    when the gate passes and keeps fp32 when it refuses; the port reaches
    the same verdict on the same weights and gate trials."""
    name, path, params, stats = jax_written
    jmodel, jp, js = jax_engine.load_model_from_checkpoint(path)
    jeng, jgate = jax_engine.build_gated_engine(
        jmodel, jp, js, BUCKETS, precision="int8",
        gate_set=_gate_set(name), warm=False)
    peng, pgate = engine.build_gated_engine(
        engine.load_model_from_checkpoint(path, device="cpu"), BUCKETS,
        precision="int8", gate_set=_gate_set(name), warm=False,
        device="cpu")
    assert pgate.outcome == jgate.outcome
    assert abs(pgate.agreement - jgate.agreement) <= 1.0 / 64
    assert peng.precision == jeng.precision
    x = _trials(name, seed=32)
    agree = np.mean(peng.infer(x) == jeng.infer(x))
    assert agree >= 1.0 - 1.0 / len(x)
    if peng.precision == "int8":
        assert peng.quantized_digest == jeng.quantized_digest


def test_the_zoo_stacks_baselines_as_the_jax_zoo_does(jax_written,
                                                      tmp_path):
    name, path, _, _ = jax_written
    c, t = BASELINES[name]
    paths = {"a": path}
    for seed, mid in ((23, "b"), (24, "c")):
        _, p, s = jax_baseline(name, c, t, seed=seed)
        paths[mid] = jax_ckpt.save_checkpoint(tmp_path / f"{mid}.npz", p, s,
                                              metadata=_meta(name))
    jmembers = [(mid, *jax_engine.load_model_from_checkpoint(p))
                for mid, p in paths.items()]
    jeng, jgate = jax_zoo.build_stacked_engine(
        jmembers, BUCKETS, gate_set=_gate_set(name), warm=False)
    pmembers = [(mid, engine.load_model_from_checkpoint(p, device="cpu"))
                for mid, p in paths.items()]
    peng, pgate = zoo.build_stacked_engine(
        pmembers, BUCKETS, gate_set=_gate_set(name), warm=False,
        device="cpu")
    assert pgate.outcome == jgate.outcome == "pass"
    assert peng.tenant_digests == jeng.tenant_digests
    x = _trials(name, seed=33)
    tid = np.random.RandomState(34).randint(0, 3, len(x)).astype(np.int32)
    np.testing.assert_array_equal(peng.infer(x, tid), jeng.infer(x, tid))


# --- the protocols and the CLIs ----------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_save_model_writes_the_npz_only(name, tmp_path):
    c, t = BASELINES[name]
    model = port_baseline(name, *jax_baseline(name, c, t, seed=25)[1:], c, t)
    protocols.save_model(model.state_dict(), model, name,
                         tmp_path / "subject_01_best_model.pth")
    assert sorted(p.name for p in tmp_path.iterdir()) \
        == ["subject_01_best_model.npz"]
    _, meta = ckpt_lib.load_checkpoint(tmp_path / "subject_01_best_model.npz")
    assert meta == _meta(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_cli_runs_both_protocols_and_predict_answers(name, tmp_path,
                                                           monkeypatch,
                                                           capsys):
    c, t = BASELINES[name]
    write_processed_tree(tmp_path, subjects=tuple(range(1, 8)), n_trials=12,
                         n_channels=c, n_times=t)
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.setitem(__import__("sys").modules,
                        "torch.utils.tensorboard", None)
    models = tmp_path / "models"
    assert train_cli.main(["--model", name, "--epochs", "1", "--subjects",
                           "1,2"]) == 0
    assert sorted(p.name for p in models.iterdir()
                  if p.suffix in (".npz", ".pth")) == [
        "subject_01_best_model.npz", "subject_02_best_model.npz"]
    report = json.loads((tmp_path / "reports"
                         / "latest_within_subject_report.json").read_text())
    assert report["per_subject_results"][0]["subject_id"] == 1
    assert train_cli.main(["--model", name, "--epochs", "1",
                           "--trainingType", "Cross-Subject",
                           "--subjects", "1,2,3,4,5,6,7"]) == 0
    cs = models / "cross_subject_best_model.npz"
    assert cs.is_file() and not cs.with_suffix(".pth").exists()
    _, meta = ckpt_lib.load_checkpoint(cs)
    assert meta == _meta(name)
    capsys.readouterr()
    for ckpt in (cs, models / "subject_01_best_model.npz"):
        assert predict_cli.main(["--checkpoint", str(ckpt), "--subject",
                                 "1"]) == 0
        assert "accuracy:" in capsys.readouterr().out


def test_a_baseline_run_snapshot_names_its_model_and_resumes_bitwise(
        tmp_path, monkeypatch):
    """A ShallowConvNet run crashed after its second 1-epoch chunk leaves
    ``within_subject_shallow_convnet.run.npz``, whose signature names the
    model (an EEGNet run never reads it), and ``--resume`` ends on the
    unbroken run's weights bit for bit."""
    from eegnetreplication_tpu_torch.resil import inject

    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setitem(__import__("sys").modules,
                        "torch.utils.tensorboard", None)
    roots = {n: tmp_path / n for n in ("unbroken", "crashed")}
    base = ["--model", "shallow_convnet", "--subjects", "1", "--epochs",
            "3"]
    try:
        for name, root in roots.items():
            write_processed_tree(root, subjects=(1,))
            monkeypatch.setenv("EEGTPU_DATA_ROOT", str(root))
            if name == "unbroken":
                assert train_cli.main(base + ["--checkpointEvery", "3"]) == 0
                continue
            with pytest.raises(RuntimeError, match="injected crash"):
                train_cli.main(base + ["--checkpointEvery", "1", "--chaos",
                                       "train.chunk:after=1"])
            snap = root / "models" / "within_subject_shallow_convnet.run.npz"
            assert ckpt_lib.read_snapshot_signature(snap)["model"] \
                == "shallow_convnet"
            assert not (root / "models"
                        / "within_subject_eegnet.run.npz").exists()
            assert train_cli.main(base + ["--checkpointEvery", "1",
                                          "--resume"]) == 0
            assert not snap.exists()
    finally:
        inject.disarm_all()
    got, _ = ckpt_lib.load_checkpoint(
        roots["crashed"] / "models" / "subject_01_best_model.npz")
    want, _ = ckpt_lib.load_checkpoint(
        roots["unbroken"] / "models" / "subject_01_best_model.npz")
    for key in want:
        assert np.array_equal(got[key].numpy(), want[key].numpy()), key
