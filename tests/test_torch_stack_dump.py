"""All-thread dumps of the port's servers, and the smoke's diagnosis of a
request that timed out, on the CPU.

Every long-lived process of the port (``serve``, the supervisor, the fleet
and cell fronts) registers ``faulthandler`` on ``SIGUSR1`` first thing in
its ``main``: the signal writes every thread's stack to its stderr and the
process goes on serving and drains on SIGTERM as before.  ``chip_smoke.py``
turns a request that timed out into a diagnosis
(``resil/stackdump.py``): the kind (**request not read**: connect or send
timed out; **no reply**: the reply did not come), the owning process's
dump, a ``/healthz`` probe and the tails, then fails with
``SmokeFailure``.
"""

import contextlib
import importlib.util
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from torch_port_cases import child_env

from eegnetreplication_tpu_torch.resil import stackdump
from eegnetreplication_tpu_torch.utils.predict_latency import (
    seeded_checkpoint,
)

REPO = Path(__file__).resolve().parents[1]
START_S = 150
# A dump's thread header: the thread the signal interrupted, or another.
DUMP_HEADER = r"^(Current thread|Thread) 0x[0-9a-f]+ \(most recent call first\)"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_dump",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return seeded_checkpoint(tmp_path_factory.mktemp("dump") / "model.npz")


def _env():
    return child_env(EEGTPU_PLATFORM="cpu", EEGTPU_NO_LOG_FILE="1",
                     PYTHONUNBUFFERED="1")


def _argv(kind: str, ckpt: Path, tmp: Path) -> tuple[list, str, str]:
    """The command line of ``kind``, the line it prints before its URL,
    and the frame its own dump must show."""
    serve = [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
             "--checkpoint", str(ckpt), "--buckets", "1,8", "--port", "0"]
    if kind == "serve":
        return serve + ["--metricsDir", str(tmp / "obs")], "serving at ", \
            "serve_forever"
    if kind == "supervise":
        # The supervisor's own threads watch the child; the child serves.
        return [sys.executable, "-u", "-m",
                "eegnetreplication_tpu_torch.resil.supervise",
                "--metricsDir", str(tmp / "sup"), "--graceS", "20", "--",
                *serve, "--metricsDir", str(tmp / "obs")], "serving at ", \
            "_watch"
    if kind == "fleet":
        return [sys.executable, "-u", "-m",
                "eegnetreplication_tpu_torch.serve.fleet", "--checkpoint",
                str(ckpt), "--replicas", "1", "--buckets", "1,8",
                "--pollS", "0.1", "--metricsDir", str(tmp / "obs"),
                "--port", "0"], "fleet serving at ", "serve_forever"
    return [sys.executable, "-u", "-m",
            "eegnetreplication_tpu_torch.serve.cells", "--checkpoint",
            str(ckpt), "--cells", "1", "--pollS", "0.1", "--cellsDir",
            str(tmp / "cells"), "--metricsDir", str(tmp / "obs"), "--port",
            "0"], "cells serving at ", "serve_forever"


def _await_line(path: Path, prefix: str, proc) -> str:
    deadline = time.monotonic() + START_S
    while time.monotonic() < deadline:
        for line in path.read_text().splitlines():
            if line.startswith(prefix):
                return line[len(prefix):].split()[0]
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    raise AssertionError(f"no {prefix!r} line: {path.read_text()[-3000:]}")


def _await_dump(path: Path, offset: int, frame: str) -> str:
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with open(path, "rb") as fh:
            fh.seek(offset)
            text = fh.read().decode(errors="replace")
        if re.search(DUMP_HEADER, text, re.M) and f" in {frame}" in text:
            return text
        time.sleep(0.1)
    raise AssertionError(f"no dump with {frame!r}: {text[-3000:]}")


@pytest.mark.parametrize("kind", ["serve", "supervise", "fleet", "cells"])
def test_sigusr1_dumps_every_thread_and_the_process_serves_on(
        kind, checkpoint, tmp_path):
    argv, prefix, frame = _argv(kind, checkpoint, tmp_path)
    out, err = tmp_path / "stdout.log", tmp_path / "stderr.log"
    with open(out, "w") as fo, open(err, "w") as fe:
        # A session of its own: a failure kills the front's children too.
        proc = subprocess.Popen(argv, cwd=REPO, env=_env(), stdout=fo,
                                stderr=fe, start_new_session=True)
    try:
        url = _await_line(out, prefix, proc)
        offset = err.stat().st_size
        proc.send_signal(signal.SIGUSR1)
        _await_dump(err, offset, frame)
        assert proc.poll() is None, "SIGUSR1 ended the process"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            assert resp.status == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 75
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def test_smoke_names_no_reply_and_prints_the_hung_batcher(smoke, checkpoint,
                                                          tmp_path, capsys):
    started = smoke._spawn_cli(
        "eegnetreplication_tpu_torch.serve",
        ["--checkpoint", str(checkpoint), "--buckets", "1,8", "--metricsDir",
         str(tmp_path / "obs"), "--chaos", "serve.hang:sleep=20"],
        tmp_path, _env(), "serve_hang")
    proc = started[0]
    try:
        url = smoke._await_url(started, "serving at ", START_S)
        body = smoke._npz_body(np, np.zeros((1, 22, 257), np.float32))
        with pytest.raises(smoke.SmokeFailure, match="no reply") as failed:
            smoke._post(url + "/predict", body, "application/octet-stream",
                        timeout=3.0)
        printed = capsys.readouterr().err
        assert isinstance(failed.value, smoke.RequestTimedOut)
        assert failed.value.diagnosis.kind == stackdump.NO_REPLY
        assert any("batcher.py" in row and "fire" in row
                   for row in failed.value.diagnosis.frames(limit=8))
        assert f"pid {proc.pid} dumped its threads" in str(failed.value)
        assert "=== request timed out: no reply" in printed
        assert re.search(DUMP_HEADER, printed, re.M)
        # The batcher's worker sits in the serve.hang site's sleep.
        assert re.search(r'inject\.py", line \d+ in fire\n\s+File "[^"]*'
                         r'batcher\.py"', printed), printed[-4000:]
        assert "--- journal tail:" in printed and "serve_start" in printed
        assert proc.poll() is None
    finally:
        proc.kill()
        proc.wait()
        started[2].close()


def test_smoke_names_a_body_nobody_reads(smoke, capsys):
    """A listener that never accepts, its accept queue full (one
    connection at a backlog of 0): the kernel drops the request's SYN, so
    the 128-trial body (2.9 MB) is never read and the connect times out."""
    with socket.socket() as lsock, socket.socket() as queued:
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(0)
        queued.connect(lsock.getsockname())
        url = f"http://127.0.0.1:{lsock.getsockname()[1]}"
        body = smoke._npz_body(np, np.zeros((128, 22, 257), np.float32))
        assert len(body) > 2_800_000
        with pytest.raises(smoke.SmokeFailure,
                           match="request not read") as failed:
            smoke._post(url + "/predict", body, "application/octet-stream",
                        timeout=3.0)
    printed = capsys.readouterr().err
    assert "no process of ours owns it" in str(failed.value)
    assert re.search(r"listener :\d+: accept queue 1\n", printed), printed
    assert "/healthz on a new connection: TimeoutError at connect" \
        in str(failed.value)


def test_timeout_kinds_of_urllib():
    import urllib.error

    assert stackdump.timeout_kind(
        urllib.error.URLError(TimeoutError("timed out"))) == stackdump.NOT_READ
    assert stackdump.timeout_kind(TimeoutError("timed out")) \
        == stackdump.NO_REPLY
    assert stackdump.timeout_kind(
        urllib.error.URLError(ConnectionRefusedError())) is None
    assert stackdump.timeout_kind(urllib.error.HTTPError(
        "http://x", 500, "boom", {}, None)) is None
    assert stackdump.timeout_kind(ConnectionResetError()) is None
