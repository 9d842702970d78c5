"""What a run loads: neither JAX nor the JAX package, compared by whole
top-level names; the reference nothing of the port; and the entry prints
no result where it must not."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "eegnetreplication_tpu"}


def _python(code: str, cwd: Path = ROOT, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "EEGTPU_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
             **env})


def test_a_run_loads_no_jax():
    """The runner's modules imported, and a small cell run through the
    port, in a fresh process: no loaded module's top-level name is JAX's
    or the JAX package's."""
    code = (
        "import json, sys\n"
        "import portbench.run, portbench.readings\n"
        "from portbench.tests.conftest import run_small, small_cell\n"
        "run_small(small_cell('eegnet.cross90'), 5, traced=True)\n"
        "run_small(small_cell('deepconvnet.within36'), 5)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "eegnetreplication_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "portbench" / "reference").glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"eegnetreplication_tpu_torch"}
    code = ("import json, sys\n" + "".join(
        f"import portbench.reference.{p.stem}\n" for p in files
        if p.stem != "__init__")
        + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"eegnetreplication_tpu_torch"})


def _entry(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "eegnet.cross90", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _entry(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the benchmark's folder
    has no program to run."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
