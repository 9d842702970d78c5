"""The port's moabb / ``.fif`` data path against the JAX package's, on the
CPU, over ``tests/fake_mne.py`` (MNE is not installed here; the double is
the numpy-only slice of MNE those branches touch).

- ``preprocess_moabb_data`` over the same seeded BNCI2014-001 run tree (one
  subject, both sessions, 22 EEG + 3 EOG channels at 250 Hz, named cue
  annotations): the same files, ``-preprocessed.npz`` and ``-trials.npz``
  within 1e-4 of the JAX package's (the port's EMS tolerance on the CPU)
  with equal events, and labels equal to the cues;
- ``load_moabb_run`` and ``merge_processed`` byte-equal, their errors
  equal;
- ``build_dataset_from_fif_dir`` (Train, and Eval with ``TrueLabels``,
  each with an edge epoch that falls off the recording and drops) and
  ``data.io``'s ``.fif`` fallback byte-equal;
- ``build_dataset_from_preprocessed(src="moabb")`` reads the moabb tree;
- ``dataset --src moabb`` in both CLIs writes the same file list;
- without MNE, ``load_moabb_run`` and ``build_dataset_from_fif_dir`` raise
  the same ``ImportError`` naming MNE in both packages.
"""

import importlib.util
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from scipy.io import savemat
from torch_port_cases import write_moabb_tree

from eegnetreplication_tpu import dataset as jax_dataset
from eegnetreplication_tpu.config import Paths as JaxPaths
from eegnetreplication_tpu.data import epoching as jax_epoching
from eegnetreplication_tpu.data import io as jax_io
from eegnetreplication_tpu.data import moabb as jax_moabb
from eegnetreplication_tpu.data.preprocess import (
    ProcessedRecording as JaxProcessed,
)
from eegnetreplication_tpu_torch import dataset
from eegnetreplication_tpu_torch.config import Paths
from eegnetreplication_tpu_torch.data import epoching, io, moabb
from eegnetreplication_tpu_torch.data.preprocess import ProcessedRecording

TOL = 1e-4
CPU = torch.device("cpu")

if importlib.util.find_spec("mne") is not None:
    pytest.skip("a real MNE is installed; these fixtures write the "
                "fake_mne double's payloads", allow_module_level=True)


@pytest.fixture(scope="module")
def double():
    import fake_mne

    fake_mne.install()
    yield fake_mne
    fake_mne.uninstall()


@pytest.fixture(scope="module")
def trees(double, tmp_path_factory):
    """The same run tree preprocessed by each package (the port on the CPU,
    both with the default ``associative`` EMS)."""
    root = tmp_path_factory.mktemp("moabb")
    port = Paths.from_root(root / "port")
    jax = JaxPaths.from_root(root / "jax")
    labels = write_moabb_tree(double.write_fake_fif, port.data_moabb)
    write_moabb_tree(double.write_fake_fif, jax.data_moabb)
    saved = os.environ.pop("EEGTPU_EMS_METHOD", None)
    try:
        written = (moabb.preprocess_moabb_data(port, device=CPU),
                   jax_moabb.preprocess_moabb_data(jax))
    finally:
        if saved is not None:
            os.environ["EEGTPU_EMS_METHOD"] = saved
    return port, jax, labels, written


def _files(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*")
                  if p.is_file())


def test_the_same_files_are_written(trees):
    port, jax, _, (port_written, jax_written) = trees
    assert [p.name for p in port_written] == [p.name for p in jax_written] \
        == ["A01T-preprocessed.npz", "A01E-preprocessed.npz"]
    assert _files(port.data_moabb_processed) \
        == _files(jax.data_moabb_processed) == [
            "Eval/A01E-preprocessed.npz", "Eval/A01E-trials.npz",
            "Train/A01T-preprocessed.npz", "Train/A01T-trials.npz"]


@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_preprocess_moabb_data_matches_jax(trees, mode):
    port, jax, labels, _ = trees
    stem = f"A01{mode[0]}"
    got = io.load_trials(port.data_moabb_processed / mode
                         / f"{stem}-trials.npz")
    want = jax_io.load_trials(jax.data_moabb_processed / mode
                              / f"{stem}-trials.npz")
    assert got.X.shape == want.X.shape == (8, 22, 257)
    assert got.X.dtype == np.float32 and got.y.dtype == np.int64
    np.testing.assert_allclose(got.X, want.X, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.y, labels[stem])
    with np.load(port.data_moabb_processed / mode
                 / f"{stem}-preprocessed.npz") as a, \
            np.load(jax.data_moabb_processed / mode
                    / f"{stem}-preprocessed.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["data"].shape == b["data"].shape == (22, 2 * 5120)
        np.testing.assert_allclose(a["data"], b["data"], rtol=TOL, atol=TOL)
        for key in ("event_pos", "event_typ", "labels", "sfreq"):
            np.testing.assert_array_equal(a[key], b[key])


def test_the_moabb_source_builds_the_same_dataset(trees):
    port, jax, labels, _ = trees
    got = epoching.build_dataset_from_preprocessed("moabb", 1, "Train", port)
    want = jax_epoching.build_dataset_from_preprocessed("moabb", 1, "Train",
                                                        jax)
    np.testing.assert_allclose(got.X, want.X, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.y, labels["A01T"])


def test_load_moabb_run_is_byte_equal(trees):
    port, jax, _, _ = trees
    run = port.data_moabb / "Eval" / "A01E_run_1.fif"
    got, want = moabb.load_moabb_run(run), jax_moabb.load_moabb_run(run)
    assert got.signals.shape == (22, 10000)          # the EOG dropped
    assert got.signals.tobytes() == want.signals.tobytes()
    assert got.labels == want.labels and len(got.labels) == 22
    assert got.sfreq == want.sfreq == 250.0
    for key in ("event_pos", "event_typ", "event_durations"):
        assert getattr(got, key).tobytes() == getattr(want, key).tobytes()
    assert len(got.event_typ) == 4                  # "break" ignored
    assert moabb.MOABB_DESC_TO_CODE == jax_moabb.MOABB_DESC_TO_CODE


def _recording(cls, n, events, seed, sfreq=128.0):
    rng = np.random.RandomState(seed)
    return cls(data=rng.randn(4, n).astype(np.float32), sfreq=sfreq,
               labels=["C1", "C2", "C3", "C4"],
               event_pos=np.asarray([p for p, _ in events], np.int64),
               event_typ=np.asarray([t for _, t in events], np.int64))


def test_merge_processed_is_byte_equal():
    parts = [((100, [(10, 769), (50, 770)]), 1), ((80, [(5, 771)]), 2),
             ((60, [(0, 772)]), 3)]
    got = moabb.merge_processed([_recording(ProcessedRecording, n, e, s)
                                 for (n, e), s in parts])
    want = jax_moabb.merge_processed([_recording(JaxProcessed, n, e, s)
                                      for (n, e), s in parts])
    for key in ("data", "event_pos", "event_typ"):
        assert getattr(got, key).tobytes() == getattr(want, key).tobytes()
    assert (got.sfreq, got.labels) == (want.sfreq, want.labels)
    np.testing.assert_array_equal(got.event_pos, [10, 50, 105, 180])
    for args in ([], [_recording(ProcessedRecording, 10, [], 0),
                      _recording(ProcessedRecording, 10, [], 0, 250.0)]):
        jax_args = [_recording(JaxProcessed, 10, [], 0, r.sfreq)
                    for r in args]
        with pytest.raises(ValueError) as a:
            moabb.merge_processed(args)
        with pytest.raises(ValueError) as b:
            jax_moabb.merge_processed(jax_args)
        assert str(a.value) == str(b.value)


def _reference_fif(double, root: Path, mode: str, seed: int) -> None:
    """A reference-layout ``A01{T,E}-preprocessed.fif`` at 128 Hz: five
    cues (and a trial-start mark), the last too near the end to epoch."""
    rng = np.random.RandomState(seed)
    data = rng.randn(22, 3000).astype(np.float64)
    descs = (["768", "769", "770", "771", "772", "769"] if mode == "Train"
             else ["768"] + ["783"] * 5)
    onsets = [1.0, 2.0, 5.0, 8.0, 11.0, 22.0]
    root.mkdir(parents=True, exist_ok=True)
    double.write_fake_fif(root / f"A01{mode[0]}-preprocessed.fif", data,
                          128.0, [f"EEG{i}" for i in range(22)], onsets,
                          descs)


@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_fif_dir_and_the_loaders_fallback_are_byte_equal(double, tmp_path,
                                                         mode):
    port, jax = Paths.from_root(tmp_path), JaxPaths.from_root(tmp_path)
    fif_dir = tmp_path / "data" / "processed" / mode
    _reference_fif(double, fif_dir, mode, seed=3)
    (tmp_path / "data" / "raw" / "TrueLabels").mkdir(parents=True)
    savemat(tmp_path / "data" / "raw" / "TrueLabels" / "A01E.mat",
            {"classlabel": np.array([2, 4, 1, 3, 2])})
    got = epoching.build_dataset_from_fif_dir(fif_dir, 1, mode, port)
    want = jax_epoching.build_dataset_from_fif_dir(fif_dir, 1, mode, jax)
    assert got.X.shape == (4, 22, 257)              # the 5th epoch dropped
    assert got.X.tobytes() == want.X.tobytes()
    assert got.y.tobytes() == want.y.tobytes()
    assert list(got.y) == ([0, 1, 2, 3] if mode == "Train" else [1, 3, 0, 2])
    loaded = io.load_subject_dataset(1, mode, port)
    jax_loaded = jax_io.load_subject_dataset(1, mode, jax)
    assert loaded.X.tobytes() == jax_loaded.X.tobytes() == got.X.tobytes()
    assert loaded.y.tobytes() == jax_loaded.y.tobytes()
    with pytest.raises(ValueError, match="No .fif files"):
        epoching.build_dataset_from_fif_dir(fif_dir, 2, mode, port)


def test_dataset_cli_moabb_writes_what_jax_writes(double, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.delenv("EEGTPU_EMS_METHOD", raising=False)
    out = {}
    for key, run in (("port", lambda: dataset.main(["--src", "moabb"])),
                     ("jax", jax_dataset.main)):
        root = tmp_path / key
        write_moabb_tree(double.write_fake_fif, root / "data" / "moabb",
                         runs=1, seconds=30.0, cues=3, seed=7)
        monkeypatch.setenv("EEGTPU_DATA_ROOT", str(root))
        monkeypatch.setattr(sys, "argv", ["dataset", "--src", "moabb"])
        run()
        out[key] = _files(root / "data" / "moabb_processed")
    assert out["port"] == out["jax"] and len(out["port"]) == 4


def test_an_empty_tree_writes_nothing_in_both(tmp_path):
    assert moabb.preprocess_moabb_data(Paths.from_root(tmp_path / "p"),
                                       device=CPU) == []
    assert jax_moabb.preprocess_moabb_data(
        JaxPaths.from_root(tmp_path / "j")) == []


def test_without_mne_both_refuse_naming_mne(tmp_path):
    errors = []
    with mock.patch.dict(sys.modules, {"mne": None, "mne.io": None}):
        for fn in (moabb.load_moabb_run, jax_moabb.load_moabb_run,
                   lambda p: epoching.build_dataset_from_fif_dir(p),
                   lambda p: jax_epoching.build_dataset_from_fif_dir(p)):
            with pytest.raises(ImportError) as exc:
                fn(tmp_path / "run.fif")
            errors.append(str(exc.value))
    assert errors[0] == errors[1] and "requires MNE" in errors[0]
    assert "requires MNE" in errors[2]
    assert errors[2] == errors[3].replace(
        "eegnetreplication_tpu.dataset", "eegnetreplication_tpu_torch.dataset")
