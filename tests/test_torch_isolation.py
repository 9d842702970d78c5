"""The torch port stands alone: no JAX, no JAX package, no CPU fallback.

Every module of ``eegnetreplication_tpu_torch`` (and ``chip_smoke.py``)
must import in a process where ``jax``, ``flax``, ``optax`` and
``eegnetreplication_tpu`` cannot be imported, and the port's entry points
must refuse a host without CUDA unless ``EEGTPU_PLATFORM=cpu`` asks for the
CPU.
"""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch_port_cases import child_env

from eegnetreplication_tpu_torch.utils import device as device_lib

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "eegnetreplication_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "eegnetreplication_tpu")

_CHILD = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = {blocked!r}

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())
    import eegnetreplication_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    for name in ("dataset", "data.verify", "data.preprocess", "ops.ems",
                 "ops.ems_kernel", "train", "data.splits", "models.norm",
                 "training.steps", "training.loop", "training.protocols",
                 "training.report", "training.checkpoint",
                 "training.async_ckpt", "resil.preempt", "obs",
                 "obs.schema", "obs.metrics", "obs.journal", "resil.inject",
                 "resil.retry", "utils.flops", "ops.quant", "ops.stacked",
                 "serve.zoo", "serve.registry", "serve.sessions",
                 "serve.sessions.session", "serve.sessions.store",
                 "obs.stats", "obs.trace", "obs.slo", "resil.breaker",
                 "resil.heartbeat", "serve.admission", "serve.tuner",
                 "serve.batcher", "serve.service", "obs.probe", "adapt",
                 "adapt.buffer", "adapt.gate", "adapt.shadow",
                 "adapt.worker", "adapt.controller", "utils.adapt_drill",
                 "utils.predict_latency", "resil.supervise", "obs.agg",
                 "obs.top", "ops.banded", "models.convnets",
                 "models.registry", "models.csp", "models.riemann",
                 "training.permutation", "serve.fleet",
                 "serve.fleet.membership", "serve.fleet.router",
                 "serve.fleet.outlier", "serve.fleet.canary",
                 "serve.fleet.autoscaler", "serve.fleet.service",
                 "serve.fleet.__main__", "utils.startup", "serve.cells",
                 "serve.cells.membership", "serve.cells.front",
                 "serve.cells.ha", "serve.cells.service",
                 "serve.cells.__main__"):
        assert "eegnetreplication_tpu_torch." + name in names, name
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  {chip_smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("imported", len(names))

    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
    model = EEGNet(8, 64, device="cpu")
    try:
        InferenceEngine(model)
    except RuntimeError as exc:
        print("engine refused:", exc)
    else:
        raise SystemExit("engine built without CUDA and without "
                         "EEGTPU_PLATFORM=cpu")
""")


def _env(**extra):
    env = child_env({k: v for k, v in os.environ.items()
                     if k != "EEGTPU_PLATFORM"})
    env.update(EEGTPU_NO_LOG_FILE="1", CUDA_VISIBLE_DEVICES="", **extra)
    return env


def test_port_imports_without_jax_and_refuses_a_host_without_cuda():
    code = _CHILD.format(blocked=BLOCKED,
                         chip_smoke=str(REPO / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    n_modules = int(out.stdout.split("imported ", 1)[1].split()[0])
    assert n_modules >= 22
    assert "engine refused: CUDA is not available" in out.stdout


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in BLOCKED, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("value, want", [("cpu", "cpu"), ("CPU", "cpu")])
def test_select_device_honours_cpu(monkeypatch, value, want):
    monkeypatch.setenv(device_lib.PLATFORM_ENV, value)
    assert device_lib.select_device() == torch.device(want)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("value", [None, "gpu", "cuda"])
def test_select_device_raises_without_cuda(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(device_lib.PLATFORM_ENV, raising=False)
    else:
        monkeypatch.setenv(device_lib.PLATFORM_ENV, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not fall back"):
        device_lib.select_device()


def test_select_device_rejects_unknown_platforms(monkeypatch):
    monkeypatch.setenv(device_lib.PLATFORM_ENV, "tpu")
    with pytest.raises(ValueError, match="torch port runs on"):
        device_lib.select_device()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path, where):
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


_SAFE_PATH_CHILD = textwrap.dedent("""
    import importlib.util, sys
    try:
        import eegnetreplication_tpu_torch
    except ImportError:
        print("not importable before chip_smoke")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  {chip_smoke!r})
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    import eegnetreplication_tpu_torch
    print("port at", eegnetreplication_tpu_torch.__file__)
""")


def test_chip_smoke_finds_the_port_under_pythonsafepath(tmp_path):
    """Run from another directory with PYTHONSAFEPATH=1, Python leaves the
    script's directory off ``sys.path``; chip_smoke.py's import step puts
    its checkout there itself."""
    code = _SAFE_PATH_CHILD.format(chip_smoke=str(REPO / "chip_smoke.py"))
    env = {k: v for k, v in _env(PYTHONSAFEPATH="1").items()
           if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "not importable before chip_smoke" in out.stdout
    assert f"port at {PORT / '__init__.py'}" in out.stdout
