"""The train CLI's mesh and Orbax flags, in ``test_torch_protocol.py``'s
style: ``--meshFold 1 --meshData 1`` (the one card's 1 x 1 mesh) trains,
a larger mesh is refused, and the Orbax refusals of the CLI and the
serving loader say why (tensorstore's format through Orbax needs JAX,
which the card's machine does not have).
"""

import sys

import pytest
from torch_port_cases import write_processed_tree

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
def test_a_larger_mesh_is_refused(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(argv + ["--epochs", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "A.5" in err and "1 x 1" in err


def test_the_orbax_refusal_says_why(capsys):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--ckptFormat", "orbax", "--epochs", "1"])
    assert exc.value.code == 2
    err = " ".join(capsys.readouterr().err.split())
    for why in ("not ported", "A.1.iv", "StandardCheckpointer",
                "tensorstore", "needs JAX"):
        assert why in err, why


def test_the_engine_refuses_an_orbax_directory_and_says_why(tmp_path):
    with pytest.raises(ValueError) as exc:
        load_model_from_checkpoint(tmp_path, device="cpu")
    for why in ("Orbax", "A.1.iv", "tensorstore", "needs JAX", ".npz"):
        assert why in str(exc.value), why
