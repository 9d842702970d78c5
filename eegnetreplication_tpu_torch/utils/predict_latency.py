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
journals stay beside ``--out`` (in ``<out>.d/``).
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
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import torch

SIZES = (1, 128)
# A connection per request, then one kept-alive connection per block.
MODES = ("connection", "keepalive")


def _checkpoint(path: Path) -> Path:
    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )

    g = torch.Generator().manual_seed(11)
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


def _start(tree: Path, ckpt: Path, work: Path, name: str):
    """One tree's server on an ephemeral port: ``(process, url)``."""
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=str(tree),
               EEGTPU_NO_LOG_FILE="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
         "--checkpoint", str(ckpt), "--port", "0", "--metricsDir",
         str(work / f"obs_{name}"), "--sessionsDir",
         str(work / f"sessions_{name}")],
        cwd=tree, env=env, stdout=subprocess.PIPE,
        stderr=open(work / f"{name}.stderr.log", "w"), text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout]
                     + [lines.put(None)], daemon=True).start()
    while True:
        line = lines.get(timeout=300)
        if line is None:
            raise RuntimeError(f"{tree}: the server exited before serving")
        if line.startswith("serving at "):
            return proc, line.split("serving at ", 1)[1].strip()


def _post(url: str, body: bytes) -> None:
    req = urllib.request.Request(url + "/predict", data=body, method="POST",
                                 headers={"Content-Type":
                                          "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        resp.read()


class _KeptAlive:
    """``/predict`` on one HTTP/1.1 connection kept open across requests
    (a client that reuses its socket, as a browser or a pooled client
    does)."""

    def __init__(self, url: str):
        parts = urllib.parse.urlsplit(url)
        self.conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                               timeout=60)

    def __call__(self, url: str, body: bytes) -> None:
        self.conn.request("POST", "/predict", body=body, headers={
            "Content-Type": "application/octet-stream"})
        resp = self.conn.getresponse()
        resp.read()
        if resp.status != 200:
            raise RuntimeError(f"/predict answered {resp.status}")

    def close(self) -> None:
        self.conn.close()


def _median_ms(url: str, body: bytes, n: int, warmup: int = 3,
               keepalive: bool = False) -> float:
    send = _KeptAlive(url) if keepalive else _post
    try:
        for _ in range(warmup):
            send(url, body)
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            send(url, body)
            times.append((time.perf_counter() - t0) * 1000.0)
    finally:
        if keepalive:
            send.close()
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
        ckpt = _checkpoint(work / "model.npz")
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
                                       servers[tree][1], bodies[n], args.n,
                                       keepalive=mode == "keepalive")}
                            rows.append(row)
                            print(json.dumps(row), flush=True)
        finally:
            for proc, _ in servers.values():
                proc.send_signal(signal.SIGTERM)
            for proc, _ in servers.values():
                try:
                    proc.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    proc.kill()
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
