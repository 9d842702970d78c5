"""The port's C++ GDF reader against the JAX package's readers, on the CPU.

The port builds ``native/gdf_reader.cc`` with ``g++`` into its own
``_build/`` at first use; this host has ``g++``, so the library is built
and run here.  On the synthetic files of ``tests/test_native_gdf.py``
(25 channels, 5 s at 250 Hz, GDF 2.20, 1.92 and 1.25, with and without
events, and one with a NaN span) the port's native reader gives arrays
equal byte for byte to the JAX native reader's, the JAX numpy reader's
and the port's numpy reader's; ``read_gdf`` serves through it (its read
count says so) and falls back to numpy, logging once, when it cannot be
built; a malformed file raises ``ValueError`` as in JAX.
"""

from pathlib import Path

import numpy as np
import pytest
from torch_port_cases import child_env  # noqa: F401 — one torch thread

from eegnetreplication_tpu.data import gdf as jax_gdf
from eegnetreplication_tpu.data import gdf_native as jax_native
from eegnetreplication_tpu_torch.data import gdf, gdf_native

FIELDS = ("signals", "event_pos", "event_typ", "event_durations")


def _make(d, version, with_events=True, nan=False):
    rng = np.random.RandomState(11)
    sig = rng.uniform(-0.99, 0.99, (25, 250 * 5)).astype(np.float32)
    if nan:
        sig[3, 500:750] = np.nan
    pos = np.array([10, 400, 900]) if with_events else None
    typ = np.array([768, 769, 783]) if with_events else None
    return gdf.write_gdf(Path(d) / f"x{version[0]}.gdf", sig, 250.0,
                         labels=[f"EEG-{i}" for i in range(25)],
                         event_pos=pos, event_typ=typ, version=version)


def _same(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    assert a.labels == b.labels
    assert a.sfreq == b.sfreq and a.version == b.version


@pytest.mark.parametrize("version, events, nan", [
    ("2.20", True, False), ("1.92", True, False), ("1.25", True, False),
    ("2.20", False, False), ("2.20", True, True)])
def test_native_reader_equals_every_reader(tmp_path, version, events, nan):
    assert gdf_native.available(), gdf_native.load_error()
    path = _make(tmp_path, version, events, nan)
    port = gdf_native.read_gdf(path)
    assert port.signals.shape == (25, 1250)
    assert len(port.event_pos) == (3 if events else 0)
    _same(port, gdf.read_gdf_python(path))
    _same(port, jax_gdf.read_gdf_python(path))
    if jax_native.ensure_built():
        _same(port, jax_native.read_gdf(path))


def test_read_gdf_serves_through_the_native_reader(tmp_path):
    path = _make(tmp_path, "2.20")
    before = gdf_native.read_gdf.reads
    rec = gdf.read_gdf(path)
    assert gdf_native.read_gdf.reads == before + 1
    _same(rec, gdf.read_gdf_python(path))
    gdf.read_gdf(path, prefer_native=False)
    assert gdf_native.read_gdf.reads == before + 1


def test_the_library_builds_into_the_ports_build_dir():
    assert gdf_native.ensure_built() and gdf_native.available()
    lib = gdf_native.library_path()
    assert lib.is_file()
    assert lib.parent == Path(gdf_native.__file__).resolve().parents[1] \
        / "_build"
    assert lib.name.startswith("libeegtpu_gdf-")
    assert gdf_native.SOURCE.name == "gdf_reader.cc"
    assert gdf_native.SOURCE.parent.name == "native"


def test_a_failed_build_falls_back_to_numpy_and_is_recorded(
        tmp_path, monkeypatch, caplog):
    path = _make(tmp_path, "2.20")
    monkeypatch.setattr(gdf_native, "_lib", None)
    monkeypatch.setattr(gdf_native, "_error", None)
    monkeypatch.setattr(gdf_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(gdf_native, "SOURCE", tmp_path / "missing.cc")
    with caplog.at_level("WARNING"):
        assert not gdf_native.available()
        assert not gdf_native.available()
        rec = gdf.read_gdf(path)
    assert "missing.cc is missing" in gdf_native.load_error()
    warned = [r for r in caplog.records
              if "Native GDF reader unavailable" in r.getMessage()]
    assert len(warned) == 1
    _same(rec, gdf.read_gdf_python(path))
    with pytest.raises(RuntimeError, match="unavailable"):
        gdf_native.read_gdf(path)


def test_native_error_reporting(tmp_path):
    bad = tmp_path / "bad.gdf"
    bad.write_bytes(b"\x00" * 512)
    with pytest.raises(ValueError):
        gdf_native.read_gdf(bad)
    with pytest.raises(ValueError):
        gdf.read_gdf_python(bad)
