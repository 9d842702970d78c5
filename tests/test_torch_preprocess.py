"""The port's preprocessing path against the JAX package's, on the CPU.

GDF files cross-read exactly between the packages; ``preprocess_recording``
agrees for all three EMS methods at rtol/atol 1e-3 with exact events;
epoching is byte-equal; the whole ``build_processed_tree`` on a small
synthetic competition tree gives trials within 1e-3 and equal labels, which
the port's loader and ``predict``-side reader take; and the port's
``dataset`` CLI refuses a host without CUDA.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from eegnetreplication_tpu.config import Paths as JaxPaths
from eegnetreplication_tpu.data import epoching as jax_epoching
from eegnetreplication_tpu.data import gdf as jax_gdf
from eegnetreplication_tpu.data import preprocess as jax_preprocess
from eegnetreplication_tpu.data import verify as jax_verify
from eegnetreplication_tpu.dataset import (
    build_processed_tree as jax_build_processed_tree,
)
from eegnetreplication_tpu_torch import dataset
from eegnetreplication_tpu_torch.config import Paths
from eegnetreplication_tpu_torch.data import epoching, gdf, io, preprocess
from eegnetreplication_tpu_torch.data import verify
from eegnetreplication_tpu_torch.utils import device as device_lib
from torch_port_cases import recording_with_nan, write_raw_tree

TOL = 1e-3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same small raw tree preprocessed by each package (port on the
    CPU, both with the default ``associative`` EMS)."""
    root = tmp_path_factory.mktemp("trees")
    port_paths = Paths.from_root(root / "port")
    jax_paths = JaxPaths.from_root(root / "jax")
    write_raw_tree(gdf.write_gdf, port_paths.data_raw)
    shutil.copytree(port_paths.data_raw, jax_paths.data_raw)
    saved = os.environ.pop("EEGTPU_EMS_METHOD", None)
    try:
        dataset.build_processed_tree(port_paths, device=CPU)
        jax_build_processed_tree(jax_paths)
    finally:
        if saved is not None:
            os.environ["EEGTPU_EMS_METHOD"] = saved
    return port_paths, jax_paths


# --- GDF ---------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("version", ["1.25", "2.20"])
def test_gdf_written_by_one_package_reads_the_same_in_the_other(
        tmp_path, writer, version):
    sig, pos, typ = recording_with_nan(c=5, t=1000)
    write = (gdf if writer == "port" else jax_gdf).write_gdf
    path = write(tmp_path / "r.gdf", sig, 250.0,
                 labels=[f"c{i}" for i in range(5)], event_pos=pos,
                 event_typ=typ, version=version)
    got, want = gdf.read_gdf(path), jax_gdf.read_gdf(path)
    np.testing.assert_array_equal(got.signals, want.signals)
    np.testing.assert_array_equal(got.signals, sig)   # NaN positions too
    assert got.sfreq == want.sfreq == 250.0
    assert got.labels == want.labels
    np.testing.assert_array_equal(got.event_pos, want.event_pos)
    np.testing.assert_array_equal(got.event_typ, want.event_typ)
    np.testing.assert_array_equal(got.event_durations, want.event_durations)
    assert got.version == want.version


def test_gdf_files_are_byte_equal(tmp_path):
    sig, pos, typ = recording_with_nan(c=3, t=500)
    a = gdf.write_gdf(tmp_path / "a.gdf", sig, 250.0, event_pos=pos,
                      event_typ=typ)
    b = jax_gdf.write_gdf(tmp_path / "b.gdf", sig, 250.0, event_pos=pos,
                          event_typ=typ)
    assert a.read_bytes() == b.read_bytes()


def test_gdf_rejects_what_is_not_gdf(tmp_path):
    path = tmp_path / "x.gdf"
    path.write_bytes(b"EDF 1.0" + bytes(300))
    with pytest.raises(ValueError, match="not a GDF file"):
        gdf.read_gdf(path)


# --- preprocess_recording ------------------------------------------------------

@pytest.mark.parametrize("method", ["associative", "scan", "pallas"])
def test_preprocess_recording_matches_jax(monkeypatch, method):
    sig, pos, typ = recording_with_nan()
    rec = gdf.GDFRecording(signals=sig, sfreq=250.0,
                           labels=[f"c{i}" for i in range(25)],
                           event_pos=pos, event_typ=typ)
    jax_rec = jax_gdf.GDFRecording(signals=sig, sfreq=250.0,
                                   labels=list(rec.labels), event_pos=pos,
                                   event_typ=typ)
    monkeypatch.setenv("EEGTPU_EMS_METHOD", method)
    got = preprocess.preprocess_recording(rec, device=CPU)
    want = jax_preprocess.preprocess_recording(jax_rec)
    assert got.data.shape == want.data.shape == (22, 2560)
    assert got.data.dtype == np.float32
    assert np.all(np.isfinite(got.data))
    np.testing.assert_allclose(got.data, want.data, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.event_pos, want.event_pos)
    np.testing.assert_array_equal(got.event_typ, want.event_typ)
    assert got.sfreq == want.sfreq and got.labels == want.labels


def test_preprocess_recording_refuses_an_unknown_ems_method(monkeypatch):
    sig, pos, typ = recording_with_nan(t=1000)
    rec = gdf.GDFRecording(signals=sig, sfreq=250.0, labels=[],
                           event_pos=pos, event_typ=typ)
    monkeypatch.setenv("EEGTPU_EMS_METHOD", "bogus")
    with pytest.raises(ValueError, match="Unknown EMS method"):
        preprocess.preprocess_recording(rec, device=CPU)


def test_processed_recording_bundle_reads_in_both_packages(tmp_path):
    rec = preprocess.ProcessedRecording(
        data=np.ones((22, 10), np.float32), sfreq=128.0,
        labels=["Fz"] * 22, event_pos=np.arange(3), event_typ=np.arange(3))
    path = rec.save(tmp_path / "A01T-preprocessed.npz")
    for loaded in (preprocess.ProcessedRecording.load(path),
                   jax_preprocess.ProcessedRecording.load(path)):
        np.testing.assert_array_equal(loaded.data, rec.data)
        assert loaded.sfreq == 128.0 and loaded.labels == rec.labels
        assert loaded.event_pos.dtype == np.int64


# --- epoching --------------------------------------------------------------------

def test_map_labels_is_byte_equal_and_refuses_unmapped():
    labels = np.array([769, 772, 770, 771, 769])
    got = epoching.map_labels(labels, epoching.TRAIN_CUE_TO_CLASS)
    want = jax_epoching.map_labels(labels, jax_epoching.TRAIN_CUE_TO_CLASS)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(RuntimeError, match="Not all labels"):
        epoching.map_labels(np.array([769, 999]),
                            epoching.TRAIN_CUE_TO_CLASS)


@pytest.mark.parametrize("mode", ["Train", "Eval"])
def test_extract_epochs_is_byte_equal(mode):
    rng = np.random.RandomState(8)
    data = rng.randn(22, 3000).astype(np.float32)
    pos = np.array([-100, 100, 600, 1100, 1600, 2900], np.int64)
    typ = np.array([769, 783, 771, 783, 772, 770], np.int64)
    got = epoching.extract_epochs(data, 128.0, pos, typ, mode=mode)
    want = jax_epoching.extract_epochs(data, 128.0, pos, typ, mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert epoching._window_bounds(128.0) == jax_epoching._window_bounds(128.0)


# --- the whole tree ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["Train", "Eval"])
@pytest.mark.parametrize("subject", [1, 4])
def test_build_processed_tree_matches_jax(trees, subject, mode):
    port_paths, jax_paths = trees
    stem = f"A{subject:02d}{mode[0]}"
    got = io.load_trials(port_paths.data_processed / mode
                         / f"{stem}-trials.npz")
    want = io.load_trials(jax_paths.data_processed / mode
                          / f"{stem}-trials.npz")
    assert got.X.shape == want.X.shape == (8, 22, 257)
    assert got.X.dtype == np.float32 and got.y.dtype == np.int64
    np.testing.assert_allclose(got.X, want.X, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.y, want.y)
    with np.load(port_paths.data_processed / mode
                 / f"{stem}-preprocessed.npz") as a, \
            np.load(jax_paths.data_processed / mode
                    / f"{stem}-preprocessed.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_allclose(a["data"], b["data"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(a["event_pos"], b["event_pos"])


def test_port_loader_reads_the_tree(trees):
    port_paths, _ = trees
    for mode in ("Train", "Eval"):
        d = io.load_subject_dataset(1, mode, port_paths)
        assert d.X.shape == (8, 22, 257)
    assert len(io.load_subject_dataset("all", "Train", port_paths)) == 16
    true = epoching.load_true_labels("A01E", port_paths)
    np.testing.assert_array_equal(
        io.load_subject_dataset(1, "Eval", port_paths).y, true)


def test_loader_epochs_preprocessed_bundles_when_trials_are_missing(
        trees, tmp_path):
    port_paths, _ = trees
    paths = Paths.from_root(tmp_path)
    shutil.copytree(port_paths.data_raw, paths.data_raw)
    src = port_paths.data_processed / "Eval"
    dst = paths.data_processed / "Eval"
    dst.mkdir(parents=True)
    shutil.copy(src / "A04E-preprocessed.npz", dst)
    got = io.load_subject_dataset(4, "Eval", paths)
    want = io.load_trials(src / "A04E-trials.npz")
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.y, want.y)


def test_loader_error_names_the_ports_dataset_cli(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match="python -m eegnetreplication_tpu_torch.dataset"):
        io.load_subject_dataset(1, "Train", Paths.from_root(tmp_path))


def test_verify_labels_agrees_with_jax(trees):
    port_paths, jax_paths = trees
    got = verify.verify_labels((1, 4), "both", port_paths)
    want = jax_verify.verify_labels((1, 4), "both", jax_paths)
    assert [r.stem for r in got] == [r.stem for r in want]
    for g, w in zip(got, want):
        assert (g.n_cue_events, g.n_true_labels, g.n_compared,
                g.n_mismatched, g.classes_seen, g.ok) == \
            (w.n_cue_events, w.n_true_labels, w.n_compared, w.n_mismatched,
             w.classes_seen, w.ok)


# --- the CLI ------------------------------------------------------------------------

def test_dataset_cli_raises_without_cuda(monkeypatch):
    monkeypatch.delenv(device_lib.PLATFORM_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        dataset.main(["--src", "kaggle"])


def test_dataset_cli_refuses_moabb_and_unknown_sources(monkeypatch):
    """Only an unknown source is refused; ``moabb`` reaches
    ``preprocess_moabb_data`` on the selected device."""
    from eegnetreplication_tpu_torch.data import moabb

    monkeypatch.setenv(device_lib.PLATFORM_ENV, "cpu")
    calls = []
    monkeypatch.setattr(moabb, "preprocess_moabb_data",
                        lambda **kw: calls.append(kw) or [])
    assert dataset.main(["--src", "moabb"]) == 0
    assert calls == [{"device": torch.device("cpu")}]
    with pytest.raises(ValueError, match="Unknown source"):
        dataset.main(["--src", "physionet"])


def test_dataset_cli_on_the_cpu_writes_the_tree(monkeypatch, tmp_path):
    paths = Paths.from_root(tmp_path)
    write_raw_tree(gdf.write_gdf, paths.data_raw, subjects=(2,), seconds=20,
                   n_trials=4, seed=3)
    monkeypatch.setenv(device_lib.PLATFORM_ENV, "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("EEGTPU_EMS_METHOD", "pallas")
    assert dataset.main([]) == 0
    for name in ("Train/A02T-trials.npz", "Eval/A02E-trials.npz",
                 "Train/A02T-preprocessed.npz"):
        assert (paths.data_processed / name).is_file()
    assert io.load_subject_dataset(2, "Train").X.shape == (4, 22, 257)
