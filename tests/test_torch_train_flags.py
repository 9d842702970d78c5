"""The train CLI's mesh and Orbax flags, in ``test_torch_protocol.py``'s
style: ``--meshFold 1 --meshData 1`` (the one card's 1 x 1 mesh) trains;
a larger mesh (``--meshFold 2``; ``--meshData 4``) trains over its rank
processes and writes its models, and ``--meshFold 0`` is a parse error;
``--ckptFormat orbax`` trains and writes Orbax directories the serving
loader reads, and a directory without its ``metadata.json`` is refused
loudly, as in the JAX package.
"""

import sys

import pytest
from torch_port_cases import train_over_a_mesh, write_processed_tree

from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.serve.engine import (
    load_model_from_checkpoint,
)


@pytest.mark.parametrize("argv", [
    ["--meshFold", "1", "--meshData", "1"], ["--meshFold", "1"],
    ["--meshData", "1"]], ids=["both", "fold", "data"])
def test_a_one_by_one_mesh_trains_and_exits_0(argv, monkeypatch, tmp_path):
    write_processed_tree(tmp_path, subjects=(1,))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train_cli.main(argv + ["--epochs", "1", "--subjects", "1"]) == 0
    assert (tmp_path / "models" / "subject_01_best_model.npz").is_file()


@pytest.mark.parametrize("argv", [
    ["--meshFold", "2"], ["--meshFold", "1", "--meshData", "4"],
    ["--meshFold", "0"]], ids=["fold2", "data4", "fold0"])
def test_a_larger_mesh_is_refused(argv, capsys, tmp_path):
    # Since the mesh was ported, a larger mesh trains over its ranks; only
    # a zero-wide axis is still a parse error.
    if argv[1] != "0":
        train_over_a_mesh(argv, tmp_path)
        return
    with pytest.raises(SystemExit) as exc:
        train_cli.main(argv + ["--epochs", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--meshFold and --meshData must be >= 1" in err
    assert "A.7" not in err and "not ported" not in err


def test_the_orbax_refusal_says_why(capsys, monkeypatch, tmp_path):
    # Since Orbax was ported, --ckptFormat orbax trains: each best model
    # is an Orbax directory (no .npz) with EEGNet's .pth beside it; an
    # unknown format is still a parse error.
    write_processed_tree(tmp_path, subjects=(1,))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train_cli.main(["--ckptFormat", "orbax", "--epochs", "1",
                           "--subjects", "1"]) == 0
    models = tmp_path / "models"
    assert (models / "subject_01_best_model.orbax" / "metadata.json").is_file()
    assert (models / "subject_01_best_model.pth").is_file()
    assert not (models / "subject_01_best_model.npz").exists()
    model = load_model_from_checkpoint(models / "subject_01_best_model.orbax",
                                       device="cpu")
    assert model.n_channels == 4 and not model.training
    assert "not ported" not in capsys.readouterr().err
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--ckptFormat", "zarr", "--epochs", "1"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_the_engine_refuses_an_orbax_directory_and_says_why(tmp_path):
    # A directory is read as an Orbax checkpoint; one without its
    # metadata.json (a save that died before the commit marker, or no
    # checkpoint at all) is refused before any array is read.
    with pytest.raises(FileNotFoundError) as exc:
        load_model_from_checkpoint(tmp_path, device="cpu")
    for why in ("metadata.json", "interrupted", "wait_for_async_saves"):
        assert why in str(exc.value), why
