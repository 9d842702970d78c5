"""Online inference HTTP service: ``python -m eegnetreplication_tpu_torch.serve``.

The serving core of ``eegnetreplication_tpu/serve/service.py`` on the
torch engine (stdlib ``http.server`` + threads):

- ``POST /predict`` — trials as JSON (``{"trials": [[[...]]]}``) or raw
  ``-trials.npz`` bytes (an ``X`` array); returns predictions, the class
  names and the serving ``model_digest``.  Bad geometry or an unparsable
  body answers 400, a full queue 429.  A deadline (``X-Deadline-Ms``
  header or ``deadline_ms`` JSON field) is enforced at dequeue and at
  response time; both answer 504.
- ``GET /healthz`` — the JAX server's identity and queue fields for what
  this port has (``status``, ``checkpoint``, ``model_digest``,
  ``variables_digest``, ``geometry``, ``buckets``, ``max_batch``,
  ``max_wait_ms``, ``precision``, ``queue_depth_trials``), plus the
  coalesced forwards dispatched (``batches``) and the hand-written
  kernels' launch counts (``kernel_launches``).

SIGTERM/SIGINT stop the listener, drain the queue and exit 75
(``resil/preempt.py``).  Hot reload, the zoo, sessions, the tuner, tracing,
metrics, the circuit breaker and the chaos sites arrive with later slices.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops.fused_eegnet import block1
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Rejected,
)
from eegnetreplication_tpu_torch.serve.engine import (
    CLASS_NAMES,
    DEFAULT_BUCKETS,
    InferenceEngine,
)
from eegnetreplication_tpu_torch.utils.device import select_device
from eegnetreplication_tpu_torch.utils.logging import logger

# How long a handler waits for its request's forward before answering 500.
REQUEST_TIMEOUT_S = 30.0
# How long stop() waits for in-flight handler threads after the drain.
HANDLER_DRAIN_S = 15.0


class ServeApp:
    """The assembled service: engine + batcher + HTTP listener.

    Construction loads and warms the checkpoint, so the listener never
    accepts a request it would answer cold; ``start`` binds the socket,
    ``stop(drain=True)`` stops accepting and drains the queue.
    """

    def __init__(self, checkpoint: str | Path, *, host: str = "127.0.0.1",
                 port: int = 0, buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 max_wait_ms: float = 5.0, max_queue_trials: int = 512,
                 device: torch.device | str | None = None):
        self.checkpoint = str(checkpoint)
        self.engine = InferenceEngine.from_checkpoint(
            checkpoint, tuple(buckets), device=device)
        self.batcher = MicroBatcher(
            self.engine.infer, max_batch=buckets[-1],
            max_wait_ms=max_wait_ms, max_queue_trials=max_queue_trials)
        self._host, self._port = host, int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._listener: threading.Thread | None = None
        self._stopped = False
        self._inflight = 0
        self._idle = threading.Condition()

    # -- lifecycle --------------------------------------------------------
    @property
    def address(self) -> tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ServeApp":
        app = self

        class Handler(_ServeHandler):
            pass

        Handler.app = app
        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._listener = threading.Thread(target=self._httpd.serve_forever,
                                          name="serve-http", daemon=True)
        self._listener.start()
        logger.info("Serving %s at %s (buckets %s, %s on %s)",
                    self.checkpoint, self.url, self.engine.buckets,
                    self.engine.precision, self.engine.device)
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the listener, drain (default) or fail queued requests, and
        wait for in-flight handler threads.  Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.batcher.close(drain=drain)
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=HANDLER_DRAIN_S):
                logger.warning("%d in-flight request handler(s) did not "
                               "finish within %.1fs", self._inflight,
                               HANDLER_DRAIN_S)
        logger.info("Serve drained and stopped after %d forwards",
                    self.batcher.batches)

    def begin_request(self) -> None:
        with self._idle:
            self._inflight += 1

    def end_request(self) -> None:
        with self._idle:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.notify_all()

    def healthz(self) -> dict:
        c, t = self.engine.geometry
        return {
            "status": "ok",
            "checkpoint": self.checkpoint,
            "model_digest": self.engine.digest,
            "variables_digest": self.engine.digest,
            "geometry": {"n_channels": c, "n_times": t},
            "buckets": list(self.engine.buckets),
            "max_batch": self.batcher.max_batch,
            "max_wait_ms": round(self.batcher.max_wait_s * 1000.0, 3),
            "precision": self.engine.precision,
            "queue_depth_trials": self.batcher.queue_depth,
            "batches": self.batcher.batches,
            "kernel_launches": {"block1": block1.launches},
        }


class _ServeHandler(BaseHTTPRequestHandler):
    """One request; instances live on the ThreadingHTTPServer's threads."""

    app: ServeApp = None  # bound by ServeApp.start()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        logger.debug("serve http: " + fmt, *args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length else b""

    def _parse_predict_body(self, body: bytes) -> tuple[np.ndarray, object]:
        """One decode of a /predict body -> (trials, deadline_ms-or-None).
        npz bodies carry the deadline in the header only."""
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == "application/json":
            payload = json.loads(body.decode())
            if not isinstance(payload, dict) or "trials" not in payload:
                raise ValueError('JSON body must be {"trials": [...]}')
            return (np.asarray(payload["trials"], np.float32),
                    payload.get("deadline_ms"))
        with np.load(io.BytesIO(body)) as data:
            if "X" in getattr(data, "files", ()):
                return np.asarray(data["X"], np.float32), None
            raise ValueError("npz body carries no 'X' trials array")

    def _deadline_ms(self, payload_deadline) -> float | None:
        """The ``X-Deadline-Ms`` header, else the JSON ``deadline_ms``."""
        raw = self.headers.get("X-Deadline-Ms")
        if raw is None:
            raw = payload_deadline
        if raw is None:
            return None
        ms = float(raw)
        if not math.isfinite(ms) or ms <= 0:
            raise ValueError(f"deadline must be a finite number of ms > 0, "
                             f"got {ms}")
        return ms

    def do_GET(self):  # noqa: N802 — stdlib naming
        if self.path == "/healthz":
            self._reply(200, self.app.healthz())
            return
        self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802 — stdlib naming
        app = self.app
        app.begin_request()
        try:
            if self.path == "/predict":
                self._predict(app)
            else:
                self._read_body()
                self._reply(404, {"error": f"unknown path {self.path}"})
        finally:
            app.end_request()

    def _predict(self, app: ServeApp) -> None:
        t0 = time.perf_counter()
        try:
            x, payload_deadline = self._parse_predict_body(self._read_body())
            deadline_ms = self._deadline_ms(payload_deadline)
            if x.ndim == 2:
                x = x[None]
            c, t = app.engine.geometry
            if x.ndim != 3 or x.shape[1:] != (c, t):
                raise ValueError(
                    f"expected trials shaped (n, {c}, {t}), got "
                    f"{tuple(x.shape)}")
        except Exception as exc:  # noqa: BLE001 — client error
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        deadline = (None if deadline_ms is None
                    else time.monotonic() + deadline_ms / 1000.0)
        try:
            preds = app.batcher.submit(x, deadline=deadline).result(
                timeout=REQUEST_TIMEOUT_S)
        except DeadlineExceeded as exc:
            self._reply(504, {"error": str(exc), "deadline_ms": deadline_ms})
            return
        except Rejected as exc:
            self._reply(429, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — inference/timeout
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        latency_ms = (time.perf_counter() - t0) * 1000.0
        if deadline is not None and time.monotonic() > deadline:
            self._reply(504, {"error": "response ready after the request "
                                       "deadline expired",
                              "deadline_ms": deadline_ms,
                              "latency_ms": round(latency_ms, 3)})
            return
        self._reply(200, {
            "predictions": [int(p) for p in preds],
            "class_names": list(CLASS_NAMES), "n": len(x),
            "latency_ms": round(latency_ms, 3),
            "model_digest": app.engine.digest})


def serve_until_preempted(app: ServeApp, poll_s: float = 0.2) -> None:
    """Block until a graceful-stop request, then drain and stop."""
    try:
        while not preempt.requested():
            time.sleep(poll_s)
    finally:
        logger.info("Stop requested — draining the request queue")
        app.stop(drain=True)


def main(argv=None) -> int:
    device = select_device()
    parser = argparse.ArgumentParser(
        description="Online EEG inference service (torch port: bucketed "
                    "engine on the card, dynamic micro-batching).")
    parser.add_argument("--checkpoint", required=True,
                        help=".npz (native) or .pth (reference format).")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8790,
                        help="Listen port (0 = ephemeral).")
    parser.add_argument("--buckets", default=None,
                        help="Comma-separated padded-batch ladder "
                             f"(default {','.join(map(str, DEFAULT_BUCKETS))}).")
    parser.add_argument("--maxWaitMs", type=float, default=5.0,
                        help="Micro-batch coalescing window from the first "
                             "queued request.")
    parser.add_argument("--maxQueue", type=int, default=512,
                        help="Queue bound in trials; beyond it requests "
                             "are rejected with 429.")
    args = parser.parse_args(argv)
    try:
        buckets = (tuple(sorted({int(b) for b in args.buckets.split(",")}))
                   if args.buckets else DEFAULT_BUCKETS)
        if not buckets or buckets[0] < 1:
            raise ValueError("buckets must be positive integers")
    except ValueError as exc:
        parser.error(f"--buckets: {exc}")

    with preempt.guard():
        app = ServeApp(args.checkpoint, host=args.host, port=args.port,
                       buckets=buckets, max_wait_ms=args.maxWaitMs,
                       max_queue_trials=args.maxQueue, device=device)
        app.start()
        print(f"serving at {app.url}", flush=True)
        serve_until_preempted(app)
    # A SIGTERM-drained server exits EX_PREEMPTED ("relaunch me"); a clean
    # 0 means the service ended on purpose.
    return preempt.EX_PREEMPTED if preempt.requested() else 0


if __name__ == "__main__":
    raise SystemExit(main())
