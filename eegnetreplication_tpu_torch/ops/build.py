"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it into a shared library in seconds; the wrappers call it
through :mod:`ctypes` with device pointers and PyTorch's current stream.

Libraries are built from the checkout's own sources at first use, into
``eegnetreplication_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that carries a hash of the source and the flags, so an edited source
is never served by a stale library.  A build writes a temporary file and
renames it into place, so processes that build concurrently (a server and
a CLI started together) cannot load half a library.  Every failure raises:
a missing ``nvcc``, a compile error, a library that does not load.

Nothing here runs at import time; this module imports on a host without
CUDA, and only :func:`build` and :func:`load` need the toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# Every kernel source of the port.  The C interface each one exports is
# declared next to its wrapper (``ops/fused_eegnet.py`` for block1 and
# block1_stacked, ``ops/ems_kernel.py`` for ems and ems_stream,
# ``ops/bn_spatial.py`` for bn_spatial).
SOURCES = ("block1", "block1_stacked", "ems", "ems_stream", "bn_spatial")

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas=-v",   # registers, shared memory and spills, into the log
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


@dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float
    log: str        # nvcc's output (the -Xptxas=-v report); "" when cached


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else ``$CUDA_HOME/bin``, else
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "torch port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source and flags."""
    source = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(source.read_bytes()
                         + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, BuildResult]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes started together; returns one result per name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = []
    for name in names:
        target = library_path(name)
        if target.is_file():
            results[name] = BuildResult(name, target, 0.0, "")
            continue
        tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, proc, time.perf_counter()))
    failures = []
    for name, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        results[name] = BuildResult(name, target, seconds, log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build((name,))[name].path
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
