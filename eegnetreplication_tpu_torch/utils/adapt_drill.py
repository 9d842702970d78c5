"""The online-adaptation drill: drift -> labels -> fine-tune -> shadow ->
promote -> recovery -> rollback under load, against the serve CLI.

    python -m eegnetreplication_tpu_torch.utils.adapt_drill \\
        [--channels 22] [--window 257] [--out F]

The port's counterpart of ``scripts/adapt_bench.py``, which it copies and
does not import.  A synthetic cue recording stands in for a headset: window
``k`` carries class ``labels[k]`` as a class-frequency oscillation over
noise (:func:`cue_window`), so the client knows every window's true class
and posts it back.  A baseline EEGNet is trained on clean cue windows
standardized as the serving session standardizes them, on the port's
``train_step``.  It serves as the default tenant of a zoo of
``n_tenants`` (the others seeded) behind ``python -m
eegnetreplication_tpu_torch.serve --zoo``, and one session streams one
window a push.  The server's ``--chaos`` plan arms ``session.drift`` after
the clean pushes (an affine ``x*scale + offset`` on every later chunk).

Legs (:func:`run_drill`):

1. **baseline**: a server without ``--adapt``; the stream drifts and is
   not labeled (the no-adaptation control, and the latency reference).
2. **recovery**: ``--adapt --probeIntervalS``; the client labels every
   drifted window from the cue schedule until the loop promotes, then
   streams on unlabeled (the recovered accuracy).  ``adapt.promote`` is
   armed once, so the first promotion attempt fails mid-swap and the
   prior model keeps serving until the retry lands.
3. **rollback**: ``POST /adapt/rollback`` on the same server under
   ``rollback_clients`` concurrent ``/predict`` clients.

A paced ``/predict`` client runs beside the stream in the first two legs.
Differences from ``scripts/adapt_bench.py``: the serve CLI in a child
process instead of an in-process ``ServeApp``; the drift armed by the
server's ``--chaos`` plan (``after=`` the clean pushes) instead of
``inject.scoped`` around the phase; one server for recovery and rollback
(the JAX bench starts a third with a minimal gate to promote again); a
``/predict`` client during the loop; the baseline trained with the port's
step (its own initial weights: the JAX PRNG's are not comparable).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.obs.stats import percentile

HEADSET_RATE_HZ = 250.0
# Class-signature frequencies (Hz): a 64-sample window holds 1/2/4/6
# distinguishable cycles.
CLASS_FREQS = (4.0, 8.0, 16.0, 24.0)
SIGNAL_AMPLITUDE = 9.0
NOISE_STD = 4.0
DC_OFFSET = 7.5

# The JAX bench's drift and session standardizer: the slow EMS (a ~10k
# sample time constant) keeps the drift from being standardized away.
DRIFT_SCALE = 0.25
DRIFT_OFFSET = -2.0
EMS_FACTOR = 1e-4

SERVE_START_TIMEOUT_S = 300.0


# -- the cue recording --------------------------------------------------------

def cue_window(n_channels: int, window: int, k: int, label: int,
               seed: int) -> np.ndarray:
    """Window ``k`` of the cue recording: a class-frequency oscillation
    (in absolute time, so the phase runs on across windows) over noise,
    deterministic per ``(seed, k)``."""
    rng = np.random.RandomState((seed * 100003 + k) % (2 ** 31 - 1))
    x = rng.randn(n_channels, window).astype(np.float32) * NOISE_STD
    t = (np.arange(k * window, (k + 1) * window)) / HEADSET_RATE_HZ
    for c in range(n_channels):
        x[c] += (SIGNAL_AMPLITUDE * np.sin(
            2 * np.pi * CLASS_FREQS[int(label)] * t + 0.7 * c)
        ).astype(np.float32)
    return x + DC_OFFSET


def make_cue_recording(n_channels: int, window: int, labels, seed: int = 0
                       ) -> np.ndarray:
    """A ``(C, len(labels) * window)`` recording whose segment ``k`` (one
    window, hop = window) carries class ``labels[k]``."""
    return np.concatenate(
        [cue_window(n_channels, window, k, int(label), seed)
         for k, label in enumerate(labels)], axis=1)


class CueStream:
    """An endless labeled cue stream: window ``k`` and its label, made on
    demand (the loop's own pace decides how long the drifted phase runs)."""

    def __init__(self, n_channels: int, window: int, seed: int):
        self.n_channels, self.window, self.seed = n_channels, window, seed
        self._label_rng = np.random.RandomState(seed + 7919)
        self.labels: list[int] = []

    def label(self, k: int) -> int:
        while k >= len(self.labels):
            self.labels.append(int(self._label_rng.randint(0, 4)))
        return self.labels[k]

    def chunk(self, k: int) -> np.ndarray:
        return cue_window(self.n_channels, self.window, k, self.label(k),
                          self.seed)


def train_baseline_checkpoint(path: Path, n_channels: int, window: int, *,
                              steps: int, init_block: int, seed: int = 0,
                              F1: int = 8, D: int = 2,
                              device: torch.device | str | None = None
                              ) -> tuple[Path, dict]:
    """Train an EEGNet on clean cue windows standardized as the serving
    session does (the same EMS recurrence and init block) with the port's
    ``train_step`` (one fold), and save it; returns the path and the
    training record (the holdout accuracy on 48 windows)."""
    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.ops.ems import (
        raw_exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.fused_eegnet import fold_index
    from eegnetreplication_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )
    from eegnetreplication_tpu_torch.training.steps import (
        StateLayout,
        TrainState,
        eval_forward,
        train_step,
    )
    from eegnetreplication_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_train, n_eval = 160, 48
    labels = rng.randint(0, 4, size=n_train + n_eval)
    x = make_cue_recording(n_channels, window, labels, seed=seed + 1)
    std = raw_exponential_moving_standardize(
        x, init_block_size=init_block, method="scan", device=dev)
    wins = np.stack([std[:, k * window:(k + 1) * window]
                     for k in range(len(labels))]).astype(np.float32)
    xd = torch.from_numpy(wins).to(dev)
    yd = torch.from_numpy(labels.astype(np.int64)).to(dev)
    model = EEGNet(n_channels, window, F1=F1, D=D, device=dev,
                   generator=torch.Generator().manual_seed(seed))
    state = TrainState.create(
        StateLayout.of(model),
        {k: v[None] for k, v in model.state_dict().items()})
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    batch = 32
    w = torch.ones((1, batch), device=dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        idx = torch.from_numpy(rng.choice(n_train, size=batch,
                                          replace=False)).to(dev)
        state, _, _ = train_step(model, state, xd[idx][None], yd[idx][None],
                                 w, learning_rate=1e-3, adam_eps=1e-7,
                                 generator=g)
    with torch.no_grad():
        logits = eval_forward(model, state, xd[None, n_train:],
                              fold_index(1, n_eval, dev))
        acc = float((torch.argmax(logits[0], -1) == yd[n_train:])
                    .float().mean().cpu())
    wall = time.perf_counter() - t0
    save_checkpoint(path, state.state_dict(0), metadata={
        "model": "eegnet", "n_channels": n_channels, "n_times": window,
        "F1": F1, "D": D})
    return path, {"train_steps": steps, "n_train_windows": n_train,
                  "holdout_accuracy": round(acc, 4), "train_s": wall}


def drifted_windows(cue: CueStream, n_windows: int, clean_windows: int, *,
                    scale: float = DRIFT_SCALE, offset: float = DRIFT_OFFSET,
                    factor_new: float = EMS_FACTOR,
                    device: torch.device | str | None = "cpu"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The standardized windows a session of ``n_windows`` pushes decides
    when the pushes from ``clean_windows`` on are drifted, and their
    labels: ``(n, C, window)`` and ``(n,)`` int32."""
    from eegnetreplication_tpu_torch.ops.ems import (
        raw_exponential_moving_standardize,
    )

    chunks = [cue.chunk(k) if k < clean_windows
              else cue.chunk(k) * np.float32(scale) + np.float32(offset)
              for k in range(n_windows)]
    std = raw_exponential_moving_standardize(
        np.concatenate(chunks, axis=1), factor_new=factor_new,
        init_block_size=cue.window, method="scan", device=device)
    w = cue.window
    x = np.stack([std[:, k * w:(k + 1) * w] for k in range(n_windows)])
    y = np.asarray([cue.label(k) for k in range(n_windows)], np.int32)
    return x.astype(np.float32), y


# -- HTTP ---------------------------------------------------------------------

def http(url: str, data: bytes | None = None,
         ctype: str = "application/json", headers: dict | None = None,
         timeout: float = 60.0) -> tuple[int, dict]:
    """One request: ``(status, JSON reply)``; an error status returns its
    body instead of raising."""
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": ctype, **(headers or {})},
        method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode() or "{}")


def npz_body(x: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.savez(buf, X=np.asarray(x, np.float32))
    return buf.getvalue()


def accuracy(preds, labels) -> float | None:
    pairs = [(p, int(t)) for p, t in zip(preds, labels) if p >= 0]
    if not pairs:
        return None
    return float(np.mean([p == t for p, t in pairs]))


class PredictClient:
    """A paced ``/predict`` client on a thread of its own: one request
    every ``period_s``, each recorded as ``(wall start, latency ms,
    status)``."""

    def __init__(self, url: str, body: bytes, model: str,
                 period_s: float = 0.025):
        self.url, self.body, self.model = url, body, model
        self.period_s = float(period_s)
        self.records: list[tuple[float, float, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="drill-predict", daemon=True)

    def start(self) -> "PredictClient":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            t_wall, t0 = time.time(), time.perf_counter()
            try:
                status, _ = http(self.url + "/predict", self.body,
                                 "application/octet-stream",
                                 {"X-Model": self.model})
            except Exception:  # noqa: BLE001 — counted as a failure
                status = 0
            self.records.append((t_wall, (time.perf_counter() - t0) * 1e3,
                                 status))
            self._stop.wait(self.period_s)

    def stop(self) -> list[tuple[float, float, int]]:
        self._stop.set()
        self._thread.join(60)
        return self.records


def latency_summary(records, lo: float | None = None,
                    hi: float | None = None) -> dict:
    """p50/p95/max of the ok requests that started in ``[lo, hi]``
    (wall)."""
    lat = sorted(ms for t, ms, status in records if status == 200
                 and (lo is None or t >= lo) and (hi is None or t <= hi))
    return {"n": len(lat),
            "p50_ms": percentile(lat, 0.50) if lat else None,
            "p95_ms": percentile(lat, 0.95) if lat else None,
            "max_ms": lat[-1] if lat else None}


# -- the server ---------------------------------------------------------------

def start_server(args: list[str], work: Path, env: dict, name: str):
    """Start the serve CLI with ``args`` on an ephemeral port; returns
    ``(process, url)`` once it prints its ``serving at`` line."""
    stderr = open(work / f"{name}.stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
         *args, "--port", "0"],
        env=env, stdout=subprocess.PIPE, stderr=stderr, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout]
                     + [lines.put(None)], daemon=True).start()
    deadline = time.monotonic() + SERVE_START_TIMEOUT_S
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            proc.kill()
            raise RuntimeError(f"{name}: no 'serving at' line in "
                               f"{SERVE_START_TIMEOUT_S:.0f} s") from None
        if line is None:
            raise RuntimeError(
                f"{name}: the server exited {proc.wait()} before serving:\n"
                + (work / f"{name}.stderr.log").read_text()[-4000:])
        if line.startswith("serving at "):
            return proc, line.split("serving at ", 1)[1].strip()


def stop_server(proc, timeout: float = 120.0) -> int:
    """SIGTERM, then the exit code (75: drained and preempted)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def read_journal(metrics_dir: Path) -> list[dict]:
    """The events of the one run under ``metrics_dir``."""
    from eegnetreplication_tpu_torch.obs import schema

    (run_dir,) = [d for d in Path(metrics_dir).iterdir() if d.is_dir()]
    return schema.read_events(run_dir / "events.jsonl")


def journal_order(events: list[dict]) -> dict:
    """The causal chain from the journal: first indices of the drift, the
    fine-tune's start, its candidate, the first shadow eval and the
    promotion, which must come in this order."""
    def first(pred) -> int | None:
        return next((i for i, e in enumerate(events) if pred(e)), None)

    indices = {
        "session_drift": first(
            lambda e: e["event"] == "fault_injected"
            and e.get("site") == "session.drift"),
        "adaptation_start": first(
            lambda e: e["event"] == "adaptation_start"),
        "adaptation_candidate": first(
            lambda e: e["event"] == "adaptation_candidate"),
        "shadow_eval": first(lambda e: e["event"] == "shadow_eval"),
        "promotion": first(
            lambda e: e["event"] == "promotion"
            and e.get("action") == "promote"),
    }
    seq = list(indices.values())
    ok = (all(i is not None for i in seq)
          and all(a < b for a, b in zip(seq, seq[1:])))
    return {"indices": indices, "ordered": ok}


# -- the legs -----------------------------------------------------------------

def stream_leg(url: str, cue: CueStream, *, sid: str, model: str,
               clean_windows: int, max_drift_windows: int,
               post_windows: int, adapt: bool, pace_s: float = 0.05,
               deadline_s: float = 300.0,
               factor_new: float = EMS_FACTOR) -> dict:
    """One drifted session (the server arms the drift after
    ``clean_windows`` pushes).  Phase A: ``clean_windows`` clean windows,
    no labels.  Phase B: drifted, paced windows; with ``adapt`` each
    decided window is labeled from the cue schedule until ``/adapt/status``
    shows a promotion (bounded by ``max_drift_windows`` and
    ``deadline_s``), without it ``max_drift_windows`` label-free windows.
    Phase C: ``post_windows`` more, no labels."""
    window = cue.window
    status, reply = http(url + "/session/open", json.dumps(
        {"session": sid, "hop": window, "ems_factor_new": factor_new,
         "ems_init_block_size": window}).encode())
    if status != 200:
        raise RuntimeError(f"/session/open answered {status}: {reply}")
    state = {"decided": 0, "labeled": 0, "failures": 0, "pushes": 0}
    windows: list[dict] = []

    def push(label: bool) -> None:
        k = state["decided"]
        status, reply = http(f"{url}/session/{sid}/samples",
                             cue.chunk(k).astype("<f4").tobytes(),
                             "application/octet-stream")
        state["pushes"] += 1
        if status != 200:
            state["failures"] += 1
            return
        for d in reply["decisions"]:
            windows.append({"window": d["window"], "status": d["status"],
                            "latency_ms": d["latency_ms"],
                            "t": time.time()})
            if d["status"] != "ok":
                state["failures"] += 1
            elif label:
                st, _ = http(f"{url}/session/{sid}/label", json.dumps(
                    {"window": d["window"],
                     "label": cue.label(d["window"])}).encode())
                if st == 200:
                    state["labeled"] += 1
                else:
                    state["failures"] += 1
        state["decided"] += len(reply["decisions"])

    def promotions() -> int:
        _, st = http(url + "/adapt/status")
        return st["models"].get(model, {}).get("promotions", 0)

    t_start = time.time()
    for _ in range(clean_windows):
        push(label=False)
    drift_start = state["decided"]
    t_drift = time.time()
    if adapt:
        deadline = time.monotonic() + deadline_s
        while promotions() < 1:
            if (state["decided"] - drift_start >= max_drift_windows
                    or time.monotonic() > deadline):
                _, st = http(url + "/adapt/status")
                raise RuntimeError(
                    f"no promotion after {state['decided'] - drift_start} "
                    f"drifted windows: {st}")
            time.sleep(pace_s)
            push(label=True)
    else:
        for _ in range(max_drift_windows):
            time.sleep(pace_s)
            push(label=False)
    promote_seen = state["decided"]
    t_promoted = time.time()
    for _ in range(post_windows):
        push(label=False)
    status, final = http(f"{url}/session/{sid}/close", b"{}")
    if status != 200:
        raise RuntimeError(f"/session/close answered {status}: {final}")
    preds = list(final["preds"])
    truth = [cue.label(k) for k in range(len(preds))]
    return {
        "windows_decided": int(final["windows"]),
        "pushes": state["pushes"],
        "labels_posted": state["labeled"],
        "failed": state["failures"],
        "drift_start": drift_start,
        "promote_seen": promote_seen,
        "t_start": t_start, "t_drift": t_drift, "t_promoted": t_promoted,
        "pre_drift_accuracy": accuracy(preds[:drift_start],
                                       truth[:drift_start]),
        "drifted_accuracy": accuracy(preds[drift_start:promote_seen],
                                     truth[drift_start:promote_seen]),
        "recovered_accuracy": (accuracy(preds[promote_seen:],
                                        truth[promote_seen:])
                               if adapt else None),
        "preds": preds,
        "windows": windows,
    }


def rollback_under_load(url: str, body: bytes, model: str, *,
                        clients: int = 8, per_client: int = 20) -> dict:
    """``POST /adapt/rollback`` while ``clients`` threads each send
    ``per_client`` ``/predict`` requests; every request must answer 200."""
    results: list[int] = []
    lock = threading.Lock()
    started = threading.Barrier(clients + 1)

    def client() -> None:
        started.wait()
        for _ in range(per_client):
            try:
                status, _ = http(url + "/predict", body,
                                 "application/octet-stream",
                                 {"X-Model": model})
            except Exception:  # noqa: BLE001 — counted as a failure
                status = 0
            with lock:
                results.append(status)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    for th in threads:
        th.start()
    started.wait()
    time.sleep(0.05)          # land the swap mid-load
    t0 = time.perf_counter()
    status, rolled = http(url + "/adapt/rollback",
                          json.dumps({"model": model}).encode())
    wall = time.perf_counter() - t0
    for th in threads:
        th.join()
    return {"status": status, "reply": rolled, "wall_s": wall,
            "requests": len(results),
            "failed": sum(1 for s in results if s != 200)}


def write_zoo(zoo_dir: Path, baseline: Path, n_tenants: int,
              n_channels: int, window: int, F1: int, D: int,
              adapted: str = "adapted") -> list[str]:
    """The baseline as tenant ``adapted`` beside ``n_tenants - 1`` seeded
    tenants of the same geometry; returns the tenant ids."""
    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )

    zoo_dir.mkdir(parents=True, exist_ok=True)
    (zoo_dir / f"{adapted}.npz").write_bytes(Path(baseline).read_bytes())
    ids = [adapted]
    for i in range(1, n_tenants):
        model = EEGNet(n_channels, window, F1=F1, D=D, device="cpu",
                       generator=torch.Generator().manual_seed(100 + i))
        save_checkpoint(zoo_dir / f"t{i:02d}.npz", model.state_dict(),
                        metadata={"model": "eegnet",
                                  "n_channels": n_channels,
                                  "n_times": window, "F1": F1, "D": D})
        ids.append(f"t{i:02d}")
    return ids


def _counts(url: str, model: str) -> dict:
    _, h = http(url + "/healthz")
    return {"block1": h["kernel_launches"]["block1"],
            "block1_stacked": h["kernel_launches"]["block1_stacked"],
            "ems_stream": h["kernel_launches"]["ems_stream"],
            "batches": h["batches"], "graph_replays": h["graph_replays"],
            "zoo_restacks": h["zoo_restacks"], "probes": h["probes"],
            "digest": next(t["digest"] for t in h["zoo"]["tenants"]
                           if t["model"] == model)}


def run_drill(work: Path, env: dict, *, n_channels: int = 22,
              window: int = 257, F1: int = 8, D: int = 2,
              n_tenants: int = 9, baseline_steps: int = 300,
              clean_windows: int = 16, max_drift_windows: int = 400,
              baseline_drift_windows: int = 40, post_windows: int = 24,
              trigger_labels: int = 16, adapt_steps: int = 60,
              min_shadow: int = 12, min_labeled: int = 8,
              accuracy_floor: float = 0.55, probe_interval_s: float = 0.2,
              pace_s: float = 0.05, predict_period_s: float = 0.025,
              rollback_clients: int = 8, seed: int = 7,
              device: torch.device | str | None = None) -> dict:
    """The three legs against serve CLIs started with ``env``; returns
    every number and the journals' events (``events``: the adapting
    server's)."""
    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    env = dict(env, EEGTPU_DATA_ROOT=str(work), EEGTPU_NO_LOG_FILE="1",
               PYTHONUNBUFFERED="1")
    baseline, model_record = train_baseline_checkpoint(
        work / "baseline.npz", n_channels, window, steps=baseline_steps,
        init_block=window, F1=F1, D=D, device=device)
    ids = write_zoo(work / "zoo", baseline, n_tenants, n_channels, window,
                    F1, D)
    model = ids[0]
    drift = (f"session.drift:after={clean_windows}:times=0:"
             f"scale={DRIFT_SCALE}:offset={DRIFT_OFFSET}")
    common = ["--zoo", str(work / "zoo"), "--defaultModel", model,
              "--traceSample", "0"]
    body = npz_body(np.random.RandomState(3).randn(
        1, n_channels, window).astype(np.float32))
    record: dict = {"model": model_record, "tenants": ids,
                    "n_channels": n_channels, "window": window,
                    "drift": {"scale": DRIFT_SCALE, "offset": DRIFT_OFFSET,
                              "ems_factor_new": EMS_FACTOR,
                              "after_windows": clean_windows}}

    # Leg 1: no adaptation.
    proc, url = start_server(
        common + ["--chaos", drift, "--metricsDir", str(work / "obs_base"),
                  "--sessionsDir", str(work / "sessions_base")],
        work, env, "serve_baseline")
    try:
        client = PredictClient(url, body, model, predict_period_s).start()
        base = stream_leg(url, CueStream(n_channels, window, seed),
                          sid="drift_baseline", model=model,
                          clean_windows=clean_windows,
                          max_drift_windows=baseline_drift_windows,
                          post_windows=0, adapt=False, pace_s=pace_s)
        base["predict"] = latency_summary(client.stop())
    finally:
        record["baseline_rc"] = stop_server(proc)
    base["window_p95_ms"] = percentile(
        sorted(w["latency_ms"] for w in base["windows"]
               if w["status"] == "ok"), 0.95)
    record["baseline"] = base

    # Legs 2 and 3: adaptation, then the rollback.
    plan = f"{drift},adapt.promote:times=1"
    proc, url = start_server(
        common + ["--chaos", plan, "--metricsDir", str(work / "obs_adapt"),
                  "--sessionsDir", str(work / "sessions_adapt"),
                  "--adapt", "--adaptDir", str(work / "adapt"),
                  "--adaptTriggerLabels", str(trigger_labels),
                  "--adaptSteps", str(adapt_steps),
                  "--adaptMinShadow", str(min_shadow),
                  "--adaptMinLabeled", str(min_labeled),
                  "--adaptAccuracyFloor", str(accuracy_floor),
                  "--probeIntervalS", str(probe_interval_s)],
        work, env, "serve_adapt")
    try:
        record["counts_start"] = _counts(url, model)
        prior_digest = record["counts_start"]["digest"]
        client = PredictClient(url, body, model, predict_period_s).start()
        rec = stream_leg(url, CueStream(n_channels, window, seed),
                         sid="drift_adapt", model=model,
                         clean_windows=clean_windows,
                         max_drift_windows=max_drift_windows,
                         post_windows=post_windows, adapt=True,
                         pace_s=pace_s)
        predict_records = client.stop()
        _, status = http(url + "/adapt/status")
        counts_loop = _counts(url, model)
        rollback = rollback_under_load(url, body, model,
                                       clients=rollback_clients)
        counts_end = _counts(url, model)
        _, metrics = http(url + "/metrics")
        _, healthz = http(url + "/healthz")
    finally:
        record["adapt_rc"] = stop_server(proc)
    events = read_journal(work / "obs_adapt")
    record.update(recovery=rec, adapt_status=status, rollback=rollback,
                  counts_loop=counts_loop, counts_end=counts_end,
                  prior_digest=prior_digest, metrics=metrics,
                  healthz=healthz, events=events,
                  predict_records=predict_records,
                  order=journal_order(events))
    rec["window_p95_ms"] = percentile(
        sorted(w["latency_ms"] for w in rec["windows"]
               if w["status"] == "ok"), 0.95)

    def t_of(name, **match):
        return next((e["t"] for e in events if e["event"] == name
                     and all(e.get(k) == v for k, v in match.items())),
                    None)

    t_ft0, t_ft1 = t_of("adaptation_start"), t_of("adaptation_candidate")
    t_prom = t_of("promotion", action="promote")
    record["latency"] = {
        "baseline_predict": base["predict"],
        "baseline_window_p95_ms": base["window_p95_ms"],
        "before_fine_tune_predict": latency_summary(predict_records,
                                                    hi=t_ft0),
        "during_fine_tune_predict": latency_summary(predict_records,
                                                    t_ft0, t_ft1),
        "during_adaptation_predict": latency_summary(predict_records,
                                                     t_ft0, t_prom),
        "during_fine_tune_window_p95_ms": _window_p95(rec["windows"],
                                                      t_ft0, t_ft1),
        "during_adaptation_window_p95_ms": _window_p95(rec["windows"],
                                                       t_ft0, t_prom),
        "adapt_leg_window_p95_ms": rec["window_p95_ms"],
    }
    return record


def _window_p95(windows, lo, hi) -> float | None:
    lat = sorted(w["latency_ms"] for w in windows if w["status"] == "ok"
                 and lo is not None and hi is not None
                 and lo <= w["t"] <= hi + 1.0)
    return percentile(lat, 0.95) if lat else None


def expected_launches(record: dict, *, buckets=(1, 8, 32, 128)) -> dict:
    """The kernel launches the adapting server counted (its ``serve_end``,
    after the drain) beside what its journal says they must be: K2s one
    per push (the seeding push is the first); K1 one eager warm run per
    shadow registration and one replay per shadow eval, plus each
    restack's stack-gate references (one eager forward a chunk of the
    synthetic gate set, per tenant); K1-stacked one replay per coalesced
    forward and one per fine-tune's fit accuracy, plus each restack's gate
    candidate (a chunk of the gate set, per tenant) and one eager warm run
    a bucket."""
    events = record["events"]
    end = next(e for e in events if e["event"] == "serve_end")
    gates = [e for e in events if e["event"] == "stack_gate"]
    sources = sorted({e["gate_source"] for e in gates})
    if sources != ["synthetic"]:
        raise ValueError("the launch arithmetic assumes the synthetic gate "
                         f"set; got {sources}")
    gate_chunks = sum(e["n_tenants"] * math.ceil(
        e["n_trials"] / e["n_tenants"] / buckets[-1]) for e in gates)
    shadows = sum(1 for e in events if e["event"] == "model_load"
                  and e.get("shadow"))
    evals = sum(1 for e in events if e["event"] == "shadow_eval")
    fits = sum(1 for e in events if e["event"] == "adaptation_candidate")
    restacks = sum(1 for e in events if e["event"] == "zoo_restack"
                   and e["outcome"] == "pass")
    want = {
        "ems_stream": record["recovery"]["pushes"],
        "block1": gate_chunks + shadows + evals,
        "block1_stacked": (gate_chunks + restacks * len(buckets)
                           + end["batches"] + fits),
        "graph_replays": end["batches"] + evals,
    }
    got = dict(end["kernel_launches"], graph_replays=end["graph_replays"])
    return {"want": want, "got": got, "restacks": restacks,
            "stack_gates": len(gates), "shadow_registrations": shadows,
            "shadow_evals": evals, "fit_passes": fits,
            "batches": end["batches"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--channels", type=int, default=22)
    parser.add_argument("--window", type=int, default=257)
    parser.add_argument("--work", default=None,
                        help="Directory for checkpoints, journals and logs "
                             "(default: a temporary one).")
    parser.add_argument("--out", default=None,
                        help="Write the record (without the events) here.")
    args = parser.parse_args(argv)
    import tempfile

    from eegnetreplication_tpu_torch.utils.device import select_device

    device = select_device()
    work = Path(args.work or tempfile.mkdtemp(prefix="adapt_drill_"))
    record = run_drill(work, dict(os.environ), n_channels=args.channels,
                       window=args.window, device=device)
    summary = {k: v for k, v in record.items()
               if k not in ("events", "predict_records")}
    for leg in ("baseline", "recovery"):
        summary[leg] = {k: v for k, v in record[leg].items()
                        if k not in ("windows", "preds")}
    print(json.dumps(summary, default=str), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, default=str, indent=1))
    ok = (record["order"]["ordered"]
          and record["rollback"]["failed"] == 0
          and record["rollback"]["status"] == 200)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
