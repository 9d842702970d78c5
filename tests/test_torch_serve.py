"""The torch port's serving path on the CPU: engine, batcher, HTTP, CLIs.

The port's engine must give the JAX ``InferenceEngine``'s predictions on
the same seeded checkpoint; bucket padding must never change one; the
batcher coalesces and answers 429 when full; the in-process server answers
``/predict`` (JSON and npz), ``/healthz`` and 400s; the ``predict`` CLI
prints the JAX CLI's stdout line; the serve CLI drains on SIGTERM and
exits 75.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_cases import (
    GEOMETRIES,
    PRODUCT,
    jax_model,
    jax_variables,
    trials,
)

from eegnetreplication_tpu.data.containers import BCICI2ADataset
from eegnetreplication_tpu.data.io import save_trials
from eegnetreplication_tpu.predict import main as jax_predict_main
from eegnetreplication_tpu.serve import engine as jax_engine
from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu_torch.predict import main as port_predict_main
from eegnetreplication_tpu_torch.serve.batcher import (
    DeadlineExceeded,
    MicroBatcher,
    Rejected,
)
from eegnetreplication_tpu_torch.serve.engine import (
    InferenceEngine,
    bucket_ladder,
)
from eegnetreplication_tpu_torch.serve.service import ServeApp

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX-written checkpoint of the product width with perturbed
    BatchNorm, plus its variables."""
    c, t, f1, d = PRODUCT
    params, bs = jax_variables(c, t, f1, d, seed=21)
    path = jax_ckpt.save_checkpoint(
        tmp_path_factory.mktemp("ckpt") / "model.npz", params, bs,
        metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                  "F1": f1, "D": d})
    return path, params, bs


@pytest.fixture(scope="module")
def port_engine(checkpoint):
    return InferenceEngine.from_checkpoint(checkpoint[0], device="cpu")


def test_predictions_equal_the_jax_engine(checkpoint, port_engine):
    path, params, bs = checkpoint
    x = trials(150, *PRODUCT[:2], seed=22)     # chunks: 128 + 22 (-> 32)
    want = jax_engine.InferenceEngine(jax_model(*PRODUCT), params,
                                      bs).infer(x)
    np.testing.assert_array_equal(port_engine.infer(x), want)
    assert port_engine.digest == jax_engine.variables_digest(params, bs)


def test_wide_predictions_equal_the_jax_engine(tmp_path):
    c, t, f1, d = GEOMETRIES["wide"]
    params, bs = jax_variables(c, t, f1, d, seed=27)
    path = jax_ckpt.save_checkpoint(
        tmp_path / "wide.npz", params, bs,
        metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                  "F1": f1, "D": d})
    engine = InferenceEngine.from_checkpoint(path, (1, 8, 32), device="cpu")
    x = trials(40, c, t, seed=28)               # chunks: 32 + 8
    want = jax_engine.InferenceEngine(jax_model(c, t, f1, d), params, bs,
                                      (1, 8, 32)).infer(x)
    np.testing.assert_array_equal(engine.infer(x), want)
    assert engine.digest == jax_engine.variables_digest(params, bs)


def test_bucket_padding_never_changes_a_prediction(port_engine):
    x = trials(37, *PRODUCT[:2], seed=23)
    with torch.no_grad():
        want = port_engine.forward(torch.from_numpy(x)).argmax(-1).numpy()
    for n in (1, 2, 7, 8, 9, 31, 37):
        np.testing.assert_array_equal(port_engine.infer(x[:n]), want[:n])
    np.testing.assert_array_equal(port_engine.infer(x[0]), want[:1])
    assert port_engine.infer(x[:0]).shape == (0,)


def test_engine_rejects_wrong_geometry_and_bad_buckets(port_engine):
    with pytest.raises(ValueError, match="expected trials"):
        port_engine.infer(np.zeros((2, 22, 256), np.float32))
    with pytest.raises(ValueError, match="strictly increasing"):
        InferenceEngine(port_engine.model, (8, 1), device="cpu")


@pytest.mark.parametrize("max_batch", [1, 7, 8, 100, 128, 256])
def test_bucket_ladder_matches_jax(max_batch):
    assert bucket_ladder(max_batch) == jax_engine.bucket_ladder(max_batch)


class _GatedInfer:
    """An infer_fn that parks the worker inside the first call until
    released, so later submissions queue up behind it."""

    def __init__(self):
        self.calls: list[int] = []
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, x):
        self.calls.append(len(x))
        self.entered.set()
        assert self.release.wait(10)
        return np.arange(len(x))


def _x(n):
    return np.zeros((n, 2, 4), np.float32)


def test_batcher_coalesces_queued_requests():
    infer = _GatedInfer()
    batcher = MicroBatcher(infer, max_batch=16, max_wait_ms=1,
                           max_queue_trials=64)
    try:
        first = batcher.submit(_x(1))
        assert infer.entered.wait(10)
        queued = [batcher.submit(_x(2)) for _ in range(3)]
        infer.release.set()
        assert first.result(10).tolist() == [0]
        assert [f.result(10).tolist() for f in queued] == \
            [[0, 1], [2, 3], [4, 5]]
        assert infer.calls == [1, 6]
        assert batcher.batches == 2
    finally:
        infer.release.set()
        batcher.close()


def test_batcher_answers_full_queue_with_rejected():
    infer = _GatedInfer()
    batcher = MicroBatcher(infer, max_batch=4, max_wait_ms=1,
                           max_queue_trials=4)
    try:
        batcher.submit(_x(1))
        assert infer.entered.wait(10)
        batcher.submit(_x(4))
        assert batcher.queue_depth == 4
        with pytest.raises(Rejected, match="queue full"):
            batcher.submit(_x(1))
    finally:
        infer.release.set()
        batcher.close()


def test_batcher_drops_expired_requests_before_the_forward():
    infer = _GatedInfer()
    batcher = MicroBatcher(infer, max_batch=8, max_wait_ms=1,
                           max_queue_trials=64)
    try:
        batcher.submit(_x(1))
        assert infer.entered.wait(10)
        late = batcher.submit(_x(3), deadline=time.monotonic() + 0.01)
        time.sleep(0.05)
        infer.release.set()
        with pytest.raises(DeadlineExceeded):
            late.result(10)
        assert infer.calls == [1]
    finally:
        infer.release.set()
        batcher.close()


def test_batcher_close_without_drain_rejects_queued():
    infer = _GatedInfer()
    batcher = MicroBatcher(infer, max_batch=8, max_wait_ms=1,
                           max_queue_trials=64)
    running = batcher.submit(_x(1))
    assert infer.entered.wait(10)
    queued = batcher.submit(_x(2))
    closer = threading.Thread(target=batcher.close, kwargs={"drain": False})
    closer.start()
    with pytest.raises(Rejected):
        queued.result(10)
    infer.release.set()
    closer.join(10)
    assert not closer.is_alive()
    assert running.result(10).tolist() == [0]
    with pytest.raises(Rejected, match="shutting down"):
        batcher.submit(_x(1))


def test_batcher_scatter_under_concurrent_submitters():
    """Many more submitting threads than cores, a short switch interval:
    every request gets back exactly its own rows."""
    def infer(x):
        return x[:, 0, 0].astype(np.int64)    # each row carries its id

    batcher = MicroBatcher(infer, max_batch=32, max_wait_ms=1,
                           max_queue_trials=4096)
    failures = []

    def client(worker):
        rng = np.random.RandomState(worker)
        for i in range(20):
            n = int(rng.randint(1, 9))
            ids = (worker * 1000 + i * 10 + np.arange(n)).astype(np.float32)
            x = np.zeros((n, 2, 4), np.float32)
            x[:, 0, 0] = ids
            got = batcher.submit(x).result(30)
            if got.tolist() != ids.astype(np.int64).tolist():
                failures.append((worker, i, got.tolist()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(w,))
                   for w in range(4 * (os.cpu_count() or 2))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    assert not failures, failures[:3]
    assert batcher.queue_depth == 0


def test_batcher_failure_fails_only_its_batch():
    def infer(x):
        if len(x) == 3:
            raise RuntimeError("bad batch")
        return np.zeros(len(x), np.int64)

    batcher = MicroBatcher(infer, max_batch=3, max_wait_ms=0,
                           max_queue_trials=8)
    try:
        with pytest.raises(RuntimeError, match="bad batch"):
            batcher.submit(_x(3)).result(10)
        assert batcher.submit(_x(2)).result(10).tolist() == [0, 0]
    finally:
        batcher.close()


def _request(url, body=None, ctype="application/json", headers=None):
    req = urllib.request.Request(url, data=body,
                                 method="POST" if body is not None else "GET",
                                 headers={"Content-Type": ctype,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


@pytest.fixture(scope="module")
def server(checkpoint):
    app = ServeApp(checkpoint[0], port=0, device="cpu").start()
    yield app
    app.stop()


def test_http_predict_json_and_npz(server, checkpoint):
    x = trials(5, *PRODUCT[:2], seed=24)
    want = server.engine.infer(x).tolist()
    status, body = _request(server.url + "/predict",
                            json.dumps({"trials": x.tolist()}).encode())
    assert status == 200 and body["predictions"] == want
    assert body["n"] == 5 and len(body["class_names"]) == 4
    assert body["model_digest"] == jax_engine.variables_digest(
        *checkpoint[1:])
    buf = io.BytesIO()
    np.savez(buf, X=x)
    status, body = _request(server.url + "/predict", buf.getvalue(),
                            "application/octet-stream")
    assert status == 200 and body["predictions"] == want


def test_http_healthz_has_the_jax_fields(server):
    status, body = _request(server.url + "/healthz")
    assert status == 200
    for key in ("status", "checkpoint", "model_digest", "variables_digest",
                "geometry", "buckets", "max_batch", "max_wait_ms",
                "precision", "queue_depth_trials"):
        assert key in body, key
    assert body["status"] == "ok" and body["precision"] == "fp32"
    assert body["geometry"] == {"n_channels": 22, "n_times": 257}
    assert body["buckets"] == [1, 8, 32, 128] and body["max_batch"] == 128
    assert body["kernel_launches"] == {"block1": 0}    # CPU: no kernel


@pytest.mark.parametrize("body, ctype, headers, code", [
    (json.dumps({"trials": np.zeros((1, 22, 256)).tolist()}).encode(),
     "application/json", {}, 400),
    (b'{"nope": 1}', "application/json", {}, 400),
    (b"not an npz", "application/octet-stream", {}, 400),
    (json.dumps({"trials": np.zeros((1, 22, 257)).tolist()}).encode(),
     "application/json", {"X-Deadline-Ms": "nan"}, 400),
], ids=["geometry", "json-shape", "npz-garbage", "deadline-nan"])
def test_http_bad_requests_answer_400(server, body, ctype, headers, code):
    status, reply = _request(server.url + "/predict", body, ctype, headers)
    assert status == code and "error" in reply


def test_http_unknown_paths_answer_404(server):
    assert _request(server.url + "/nope")[0] == 404
    assert _request(server.url + "/reload", b"{}")[0] == 404


@pytest.mark.parametrize("source", ["input", "subject"])
def test_predict_cli_prints_the_jax_line(checkpoint, tmp_path, monkeypatch,
                                         capsys, source):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path))
    x = trials(37, *PRODUCT[:2], seed=25)
    y = np.random.RandomState(26).randint(0, 4, 37)
    data = save_trials(BCICI2ADataset(X=x, y=y),
                       tmp_path / "data" / "processed" / "Eval"
                       / "A01E-trials.npz")
    argv = ["--checkpoint", str(checkpoint[0])] + (
        ["--input", str(data)] if source == "input"
        else ["--subject", "1", "--mode", "Eval"])
    assert jax_predict_main(argv) == 0
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_predict_main(argv) == 0
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line == jax_line and port_line.startswith("accuracy: ")


def test_serve_cli_drains_on_sigterm_and_exits_75(checkpoint):
    env = dict(os.environ, EEGTPU_PLATFORM="cpu", EEGTPU_NO_LOG_FILE="1",
               PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.serve",
         "--checkpoint", str(checkpoint[0]), "--port", "0",
         "--buckets", "1,8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving at http://"), line
        url = line.split("serving at ", 1)[1].strip()
        status, body = _request(url + "/healthz")
        assert status == 200 and body["buckets"] == [1, 8]
        status, body = _request(
            url + "/predict",
            json.dumps({"trials": trials(3, *PRODUCT[:2]).tolist()}).encode())
        assert status == 200 and body["n"] == 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
