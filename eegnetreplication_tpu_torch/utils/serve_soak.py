"""Soak of ``serve``'s start and ``/predict``: many server starts under the
smoke's traffic, every timed-out request diagnosed.

    python -m eegnetreplication_tpu_torch.utils.serve_soak \\
        [--starts 120] [--parallel 4] [--budgetS 1500] [--out DIR]

Three configurations take turns, those of ``chip_smoke.py``'s phases 5 and
12: the fp32 single model (``--checkpoint``), the int8 model (``--precision
int8``) and a zoo of nine tenants (``--zoo``, requests name a tenant in
``X-Model``), all at the product width (22 x 257, F1=8, D=2, seeded).
Each start takes the smoke's traffic: 8 concurrent requests of 4 trials
(npz and JSON bodies in turns), then 30 sequential requests at 1 trial and
30 at 128 trials with a connection each (urllib, as the smoke sends them),
then the same on one kept-alive connection (as ``predict_latency`` sends
them); then SIGTERM, which must exit 75.  ``--parallel`` servers run at
once.  A request keeps the smoke's 60 s timeout; one that times out is a
stall: its diagnosis (``resil/stackdump.py``: the kind, the TCP queues,
the server's all-thread dump, a ``/healthz`` probe, the tails) goes to
``<out>/stall_<k>.txt``, the server is killed, and the soak goes on.
``--smokeServe N`` also runs ``chip_smoke.py``'s phase 5 (``phase_serve``:
its own client, from a process that holds the card, after its phases 2-4)
N times beside the soak, each a stall if one of its requests times out.
``--budgetS`` stops starting servers once it is spent.  The last line is
one JSON object: the card's name and power limit, starts, requests,
stalls, errors, and each stall's kind and essential frames (also in
``<out>/soak.json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import json
import os
import signal
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.utils import predict_latency as pl

CONFIGS = ("fp32", "int8", "zoo")
N_TENANTS = 9
CONCURRENT, CONCURRENT_TRIALS = 8, 4
SEQUENTIAL, SIZES = 30, (1, 128)
MODES = ("connection", "keepalive")


def _card() -> str:
    """``nvidia-smi``'s name and power limit, or why there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"no nvidia-smi ({type(exc).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi exited {out.returncode}"


def _npz(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=x.astype(np.float32))
    return buf.getvalue()


class Soak:
    """The soak's models, its counts and its stalls."""

    def __init__(self, work: Path, out: Path, env: dict):
        self.work, self.out, self.env = work, out, env
        self.lock = threading.Lock()
        self.rows: list[dict] = []
        self.stalls: list[dict] = []
        zoo = work / "zoo"
        zoo.mkdir(parents=True, exist_ok=True)
        self.tenants = [f"subject_{z + 1:02d}_best_model"
                        for z in range(N_TENANTS)]
        for z, mid in enumerate(self.tenants):
            pl.seeded_checkpoint(zoo / f"{mid}.npz", seed=1200 + z)
        single = pl.seeded_checkpoint(work / "single.npz", seed=1300)
        self.args = {
            "fp32": ["--checkpoint", str(single)],
            "int8": ["--checkpoint", str(single), "--precision", "int8"],
            "zoo": ["--zoo", str(zoo)],
        }
        rng = np.random.RandomState(1400)
        x = rng.randn(128, 22, 257).astype(np.float32)
        self.concurrent = [
            (json.dumps({"trials": chunk.tolist()}).encode(),
             "application/json") if i % 2 else
            (_npz(chunk), "application/octet-stream")
            for i, chunk in enumerate(np.split(
                x[:CONCURRENT * CONCURRENT_TRIALS], CONCURRENT))]
        self.bodies = {n: _npz(x[:n]) for n in SIZES}

    def run_start(self, k: int) -> None:
        """Start ``k``: its configuration's server, the traffic, SIGTERM."""
        config = CONFIGS[k % len(CONFIGS)]
        name = f"s{k:04d}_{config}"
        row = {"start": k, "config": config, "requests": 0, "errors": [],
               "stalled": False}
        t0 = time.perf_counter()
        try:
            server = pl.start_server(
                [*self.args[config], "--metricsDir",
                 str(self.work / f"obs_{name}"), "--sessionsDir",
                 str(self.work / f"sessions_{name}")], self.work, name,
                cwd=Path.cwd(), env=self.env)
        except RuntimeError as exc:
            row["errors"].append(f"start: {exc}"[:2000])
            self.record(row)
            return
        row["start_s"] = time.perf_counter() - t0
        try:
            self._traffic(server, config, k, row)
        except pl.Stalled as exc:
            row["stalled"] = True
            self.stall(k, config, exc.diagnosis)
        except Exception as exc:  # noqa: BLE001 — counted, the soak goes on
            row["errors"].append(f"{type(exc).__name__}: {exc}"[:2000])
        finally:
            row["traffic_s"] = time.perf_counter() - t0 - row["start_s"]
            row["exit_code"] = self._stop(server, killed=row["stalled"])
            if not row["stalled"] and row["exit_code"] != 75:
                row["errors"].append(f"SIGTERM: exit {row['exit_code']}")
            self.record(row)

    def _traffic(self, server: pl.Server, config: str, k: int,
                 row: dict) -> None:
        def headers(i: int) -> dict:
            return ({"X-Model": self.tenants[(i + k) % N_TENANTS]}
                    if config == "zoo" else {})

        def check(status: int, what: str) -> None:
            if status != 200:
                raise RuntimeError(f"{what}: /predict answered {status}")

        answers: list = [None] * CONCURRENT

        def send(i: int) -> None:
            body, ctype = self.concurrent[i]
            try:
                answers[i] = pl.post(server, body,
                                     {"Content-Type": ctype, **headers(i)})
            except Exception as exc:  # noqa: BLE001 — read below
                answers[i] = exc

        threads = [threading.Thread(target=send, args=(i,), daemon=True)
                   for i in range(CONCURRENT)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(2 * pl.REQUEST_TIMEOUT_S + 30)
        row["requests"] += CONCURRENT
        for i, ans in enumerate(answers):
            if isinstance(ans, BaseException):
                raise ans
            check(ans[0] if ans is not None else -1, f"concurrent {i}")
        for mode in MODES:
            client = pl.KeptAlive(server) if mode == "keepalive" else pl.post
            try:
                for n in SIZES:
                    for i in range(SEQUENTIAL):
                        row["requests"] += 1
                        status, _ = client(server, self.bodies[n],
                                           headers(i))
                        check(status, f"{mode} {n} trials #{i}")
            finally:
                if mode == "keepalive":
                    client.close()

    def _stop(self, server: pl.Server, killed: bool) -> int:
        if killed:
            server.proc.kill()
        else:
            server.proc.send_signal(signal.SIGTERM)
        try:
            return server.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            server.proc.kill()
            return server.proc.wait()

    def stall(self, k: int, config: str, found) -> None:
        with self.lock:
            n = len(self.stalls)
            (self.out / f"stall_{n}.txt").write_text(found.text)
            self.stalls.append({"start": k, "config": config,
                                "kind": found.kind,
                                "summary": found.summary,
                                "sockets": found.sockets,
                                "frames": found.frames()})

    def record(self, row: dict) -> None:
        with self.lock:
            self.rows.append(row)
            print(json.dumps(row), flush=True)


def smoke_serve(n: int, soak: Soak, budget_s: float, t0: float) -> None:
    """``chip_smoke.py``'s phase 5 ``n`` times in this process, after its
    phases 2-4, each run a row of ``soak`` (config ``phase5``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path.cwd() / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from eegnetreplication_tpu_torch.utils.device import select_device

    dev = select_device()
    cs.phase_build()
    cs.phase_k1(torch, dev)
    cs.phase_k1_stacked(torch, dev)
    cs.phase_forward(torch, dev)
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=str(Path.cwd()))
    for i in range(n):
        if time.perf_counter() - t0 > budget_s:
            return
        row = {"start": f"phase5-{i}", "config": "phase5", "requests": 0,
               "errors": [], "stalled": False}
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="soak_phase5_") as tmp:
            try:
                row["requests"] = cs.phase_serve(torch, np, dev, Path(tmp),
                                                 env)["requests"]
            except cs.RequestTimedOut as exc:
                row["stalled"] = True
                soak.stall(row["start"], "phase5", exc.diagnosis)
            except Exception as exc:  # noqa: BLE001 — counted, goes on
                row["errors"].append(f"{type(exc).__name__}: {exc}"[:2000])
        row["traffic_s"] = time.perf_counter() - t1
        soak.record(row)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--starts", type=int, default=120)
    parser.add_argument("--parallel", type=int, default=4)
    parser.add_argument("--smokeServe", type=int, default=0,
                        help="Also run chip_smoke.py's phase 5 this many "
                             "times beside the soak.")
    parser.add_argument("--budgetS", type=float, default=1500.0,
                        help="Start no server after this many seconds.")
    parser.add_argument("--out", default=None,
                        help="Directory for soak.json and the stalls' "
                             "diagnoses (default: a temporary one).")
    args = parser.parse_args(argv)
    env = dict(os.environ, PYTHONUNBUFFERED="1", EEGTPU_NO_LOG_FILE="1")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve_soak_") as tmp:
        out = Path(args.out) if args.out else Path(tmp)
        out.mkdir(parents=True, exist_ok=True)
        soak = Soak(Path(tmp), out, env)
        next_start = [0]
        claim = threading.Lock()

        def worker() -> None:
            while True:
                with claim:
                    k = next_start[0]
                    if k >= args.starts \
                            or time.perf_counter() - t0 > args.budgetS:
                        return
                    next_start[0] += 1
                soak.run_start(k)

        workers = [threading.Thread(target=worker)
                   for _ in range(max(1, args.parallel))]
        for th in workers:
            th.start()
        try:
            if args.smokeServe:
                smoke_serve(args.smokeServe, soak, args.budgetS, t0)
        finally:
            for th in workers:
                th.join()
        rows = soak.rows
        summary = _summary(soak, args.parallel, time.perf_counter() - t0)
        (out / "soak.json").write_text(json.dumps({**summary, "rows": rows},
                                                  indent=1))
    print(json.dumps(summary), flush=True)
    return 0


def _summary(soak: Soak, parallel: int, wall_s: float) -> dict:
    rows = soak.rows
    return {
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else "cpu"),
        "card": _card(), "parallel": parallel, "wall_s": wall_s,
        "starts": len(rows), "requests": sum(r["requests"] for r in rows),
        "stalls": len(soak.stalls),
        "errors": sum(len(r["errors"]) for r in rows),
        "by_config": {c: {
            "starts": sum(r["config"] == c for r in rows),
            "requests": sum(r["requests"] for r in rows
                            if r["config"] == c),
            "stalls": sum(r["stalled"] for r in rows if r["config"] == c),
            "start_s_max": max((r["start_s"] for r in rows
                                if r["config"] == c and "start_s" in r),
                               default=None)}
            for c in dict.fromkeys(r["config"] for r in rows)},
        "error_samples": [e for r in rows for e in r["errors"]][:10],
        "stall_list": soak.stalls,
    }


if __name__ == "__main__":
    raise SystemExit(main())
