"""``/predict`` latency of two or more checkouts' servers on one card, in turns.

    python -m eegnetreplication_tpu_torch.utils.predict_latency \\
        --tree . --tree _smoke_tree/parent [--rounds 2] [--n 30] [--out F]

Each ``--tree`` is the root of a checkout of this repository.  One seeded
checkpoint (the product width, 22 x 257, F1=8, D=2, perturbed BatchNorm)
is served by every tree's ``python -m eegnetreplication_tpu_torch.serve``
(started from that tree, all at once), then each server takes ``--n``
``/predict`` requests (npz bodies, one at a time: a connection each, as
``chip_smoke.py`` sends them, and then on one kept-alive HTTP/1.1
connection) at 1 and at 128 trials,
the trees in turns (A B, then B A, ...), and the median host-clock latency
of each block is printed as one JSON line, then a summary line with every
tree's medians per size.  Servers get SIGTERM at the end; their logs and
journals stay beside ``--out`` (in ``<out>.d/``).  A request that times out
(60 s) prints the diagnosis of ``resil/stackdump.py`` (the timeout's kind,
the server's all-thread dump, a ``/healthz`` probe, its journal and stderr
tails) and ends the run.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import queue
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.resil import stackdump

SIZES = (1, 128)
# A request's client timeout, as chip_smoke.py's, and how long a server
# may take to print its URL.
REQUEST_TIMEOUT_S = 60.0
START_TIMEOUT_S = 300.0
# A connection per request, then one kept-alive connection per block.
MODES = ("connection", "keepalive")


def seeded_checkpoint(path: Path, seed: int = 11) -> Path:
    """An EEGNet at the product width drawn from ``seed`` (perturbed
    BatchNorm), saved by the port's ``save_checkpoint``."""
    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )

    g = torch.Generator().manual_seed(seed)
    model = EEGNet(22, 257, device="cpu", generator=g)
    with torch.no_grad():
        for bn in (model.temporal[1], model.aggregation[0],
                   model.block_2[2]):
            n = bn.num_features
            bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
            bn.bias.copy_(0.2 * torch.randn(n, generator=g))
            bn.running_mean.copy_(0.3 * torch.randn(n, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return save_checkpoint(path, model.state_dict(), metadata={
        "model": "eegnet", "n_channels": 22, "n_times": 257, "F1": 8,
        "D": 2})


class Server:
    """A serve process started by :func:`start_server`: its URL, and the
    file its stderr goes to (where a stack dump lands)."""

    def __init__(self, proc: subprocess.Popen, url: str, stderr_path: Path):
        self.proc, self.url, self.stderr_path = proc, url, stderr_path


class Stalled(RuntimeError):
    """A request that timed out; ``diagnosis`` is what
    :func:`stackdump.diagnose` found."""

    def __init__(self, diagnosis: stackdump.Diagnosis):
        super().__init__(diagnosis.summary)
        self.diagnosis = diagnosis


def start_server(args: list, work: Path, name: str, *, cwd: Path,
                 env: dict | None = None) -> Server:
    """``python -m eegnetreplication_tpu_torch.serve <args>`` on an
    ephemeral port, started from ``cwd``, its stderr in
    ``<work>/<name>.stderr.log``; returns once it prints its URL."""
    log_path = work / f"{name}.stderr.log"
    with open(log_path, "w") as stderr:
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
             *args, "--port", "0"],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=stderr,
            text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout]
                     + [lines.put(None)], daemon=True).start()
    deadline = time.monotonic() + START_TIMEOUT_S
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"{name}: no URL in {START_TIMEOUT_S:.0f} s")
        if line is None:
            raise RuntimeError(f"{name}: the server exited {proc.wait()} "
                               "before serving:\n"
                               + log_path.read_text()[-4000:])
        if line.startswith("serving at "):
            return Server(proc, line.split("serving at ", 1)[1].strip(),
                          log_path)


def _start(tree: Path, ckpt: Path, work: Path, name: str) -> Server:
    """One tree's server."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=str(tree),
               EEGTPU_NO_LOG_FILE="1")
    return start_server(
        ["--checkpoint", str(ckpt), "--metricsDir", str(work / f"obs_{name}"),
         "--sessionsDir", str(work / f"sessions_{name}")], work, name,
        cwd=tree, env=env)


def _stalled(server: Server, url: str, kind: str,
             exc: BaseException) -> Stalled:
    """The diagnosis of a request to ``server`` that timed out, printed to
    stderr, as the exception to raise."""
    pid = server.proc.pid if server.proc.returncode is None else None
    found = stackdump.diagnose(url, kind, exc, pid=pid,
                               stderr_path=server.stderr_path)
    print(found.text, file=sys.stderr, flush=True)
    return Stalled(found)


def post(server: Server, body: bytes, headers: dict | None = None
         ) -> tuple[int, bytes]:
    """``POST /predict`` on a new connection (urllib, as ``chip_smoke.py``
    sends it): ``(status, body)``.  A timeout raises :class:`Stalled`."""
    url = server.url + "/predict"
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": "application/octet-stream", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()
    except OSError as exc:
        kind = stackdump.timeout_kind(exc)
        if kind is None:
            raise
        raise _stalled(server, url, kind, exc) from exc


class KeptAlive:
    """``/predict`` on one HTTP/1.1 connection kept open across requests
    (a client that reuses its socket, as a browser or a pooled client
    does).  A timeout while sending raises :class:`Stalled` as
    :data:`stackdump.NOT_READ`, one while awaiting or reading the reply as
    :data:`stackdump.NO_REPLY`."""

    def __init__(self, server: Server):
        parts = urllib.parse.urlsplit(server.url)
        self.conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                               timeout=REQUEST_TIMEOUT_S)

    def __call__(self, server: Server, body: bytes,
                 headers: dict | None = None) -> tuple[int, bytes]:
        url = server.url + "/predict"
        kind = stackdump.NOT_READ
        try:
            self.conn.request("POST", "/predict", body=body, headers={
                "Content-Type": "application/octet-stream",
                **(headers or {})})
            kind = stackdump.NO_REPLY
            resp = self.conn.getresponse()
            return resp.status, resp.read()
        except TimeoutError as exc:
            raise _stalled(server, url, kind, exc) from exc

    def close(self) -> None:
        self.conn.close()


def _median_ms(server: Server, body: bytes, n: int, warmup: int = 3,
               keepalive: bool = False) -> float:
    client = KeptAlive(server) if keepalive else post

    def send() -> None:
        status, _ = client(server, body)
        if status != 200:
            raise RuntimeError(f"/predict answered {status}")

    try:
        for _ in range(warmup):
            send()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            send()
            times.append((time.perf_counter() - t0) * 1000.0)
    finally:
        if keepalive:
            client.close()
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True)
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--n", type=int, default=30)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    trees = [Path(t).resolve() for t in args.tree]
    rng = np.random.RandomState(12)
    bodies = {}
    for n in SIZES:
        buf = io.BytesIO()
        np.savez(buf, X=rng.randn(n, 22, 257).astype(np.float32))
        bodies[n] = buf.getvalue()
    rows = []
    with tempfile.TemporaryDirectory(prefix="predict_latency_") as tmp:
        work = Path(args.out + ".d").resolve() if args.out else Path(tmp)
        work.mkdir(parents=True, exist_ok=True)
        ckpt = seeded_checkpoint(work / "model.npz")
        servers = {}
        try:
            for i, tree in enumerate(trees):
                servers[tree] = _start(tree, ckpt, work, f"t{i}")
            for r in range(args.rounds):
                for tree in (trees if r % 2 == 0 else trees[::-1]):
                    for mode in MODES:
                        for n in SIZES:
                            row = {"round": r, "tree": str(tree),
                                   "mode": mode, "trials": n,
                                   "median_ms": _median_ms(
                                       servers[tree], bodies[n], args.n,
                                       keepalive=mode == "keepalive")}
                            rows.append(row)
                            print(json.dumps(row), flush=True)
        finally:
            for server in servers.values():
                server.proc.send_signal(signal.SIGTERM)
            for server in servers.values():
                try:
                    server.proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    server.proc.kill()
    summary = {str(t): {f"{mode}/{n}": [
        r["median_ms"] for r in rows if r["tree"] == str(t)
        and r["trials"] == n and r["mode"] == mode]
        for mode in MODES for n in SIZES} for t in trees}
    out = {"device": (torch.cuda.get_device_name(0)
                      if torch.cuda.is_available() else "cpu"),
           "n": args.n, "medians_ms": summary}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**out, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
