"""ctypes binding for the C++ GDF reader (``native/gdf_reader.cc``).

The port's copy of ``eegnetreplication_tpu/data/gdf_native.py``.  The
library is built from the checkout's ``native/gdf_reader.cc`` with ``g++``
and the flags of ``native/Makefile`` at first use, into the port's
``_build/`` beside the CUDA kernels (``ops/build.py``), under a name keyed
by a hash of the source and the flags; never into ``native/build/``,
which belongs to the JAX package.  A build writes a temporary file and
renames it into place, so processes that build at once cannot load half a
library.

The numpy reader (:func:`~eegnetreplication_tpu_torch.data.gdf.read_gdf_python`)
stays the fallback and the behavioural spec the native path is tested
against.  A build or load failure is logged once and recorded:
:func:`available` answers ``False`` from then on and :func:`load_error`
says why.  ``read_gdf.reads`` counts the recordings the native reader
served in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.utils.logging import logger

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gdf_reader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile's CXXFLAGS, and -shared.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    """Where the reader builds to, keyed by its source and the flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + "\0".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libeegtpu_gdf-{key[:16]}.so"


def _build() -> Path:
    """The built library, compiled first if needed; raises on failure."""
    if not SOURCE.is_file():
        raise RuntimeError(f"{SOURCE} is missing")
    target = library_path()
    if target.is_file():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exited {out.returncode}: "
                           f"{out.stderr.strip()[-2000:]}")
    os.replace(tmp, target)
    return target


def ensure_built() -> bool:
    """Build the native library if missing; returns whether it is built
    (:func:`available` also loads it, and records why it cannot)."""
    try:
        _build()
    except RuntimeError:
        return False
    return True


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as exc:
            _error = f"{type(exc).__name__}: {exc}"
            logger.warning("Native GDF reader unavailable, reading GDF with "
                           "numpy: %s", _error)
            return None
        lib.gdf_open.restype = ctypes.c_void_p
        lib.gdf_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int]
        lib.gdf_info.restype = None
        lib.gdf_info.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int64)] * 2 + [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double)]
        lib.gdf_labels.restype = None
        lib.gdf_labels.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64]
        lib.gdf_signals.restype = None
        lib.gdf_signals.argtypes = [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.float32, flags="C")]
        lib.gdf_events.restype = None
        lib.gdf_events.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(np.int64, flags="C")] * 3
        lib.gdf_close.restype = None
        lib.gdf_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is loadable (building it if needed)."""
    return _load() is not None


def load_error() -> str | None:
    """Why the native reader is unavailable; ``None`` while it is not
    known to be."""
    with _lock:
        return _error


def read_gdf(path: str | Path):
    """Read a GDF file through the native parser -> :class:`GDFRecording`."""
    from eegnetreplication_tpu_torch.data.gdf import GDFRecording

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native GDF reader unavailable: {_error}")

    err = ctypes.create_string_buffer(256)
    handle = lib.gdf_open(str(path).encode(), err, len(err))
    if not handle:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    try:
        n_ch = ctypes.c_int64()
        n_samp = ctypes.c_int64()
        sfreq = ctypes.c_double()
        n_ev = ctypes.c_int64()
        version = ctypes.c_double()
        lib.gdf_info(handle, ctypes.byref(n_ch), ctypes.byref(n_samp),
                     ctypes.byref(sfreq), ctypes.byref(n_ev),
                     ctypes.byref(version))

        stride = 17
        label_buf = ctypes.create_string_buffer(stride * n_ch.value)
        lib.gdf_labels(handle, label_buf, stride)
        labels = [
            label_buf.raw[i * stride:(i + 1) * stride].split(b"\x00")[0]
            .decode(errors="replace")
            for i in range(n_ch.value)
        ]

        signals = np.empty((n_ch.value, n_samp.value), dtype=np.float32)
        lib.gdf_signals(handle, signals)

        pos = np.empty(n_ev.value, dtype=np.int64)
        typ = np.empty(n_ev.value, dtype=np.int64)
        dur = np.empty(n_ev.value, dtype=np.int64)
        if n_ev.value:
            lib.gdf_events(handle, pos, typ, dur)

        rec = GDFRecording(signals=signals, sfreq=float(sfreq.value),
                           labels=labels, event_pos=pos, event_typ=typ,
                           event_durations=dur, version=float(version.value))
    finally:
        lib.gdf_close(handle)
    with _lock:
        read_gdf.reads += 1
    return rec


read_gdf.reads = 0
