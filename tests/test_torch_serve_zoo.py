"""Serving beyond one fp32 model, in process on the CPU: the zoo behind
``serve --zoo``, int8 behind its gate, hot ``/reload``, the tenant-aware
batcher and the serving journal.

``serve --zoo`` answers must equal ``predict --zoo --model`` on the same
trials; ``/reload`` must drop no request under concurrent clients and
answer 400 with the old digest still serving for a corrupt file; the
tenant-aware batcher must dequeue in the JAX batcher's order; a serving
run's journal must read back through the port's schema and the JAX
package's ``scripts/obs_report.py``.
"""

import importlib.util
import io
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from torch_port_cases import GEOMETRIES, jax_variables, trials

from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.data.io import save_trials
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.predict import main as predict_main
from eegnetreplication_tpu_torch.predict import predict_trials
from eegnetreplication_tpu_torch.serve import batcher as port_batcher
from eegnetreplication_tpu_torch.serve import service
from eegnetreplication_tpu_torch.serve.engine import (
    load_model_from_checkpoint,
)
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

REPO = Path(__file__).resolve().parents[1]
GEOMETRY = GEOMETRIES["small"]
N_TENANTS = 3


def _save(path, seed):
    c, t, f1, d = GEOMETRY
    p, b = jax_variables(c, t, f1, d, seed=seed)
    return ckpt_lib.save_checkpoint(
        path, ckpt_lib.from_jax_variables(p, b),
        metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                  "F1": f1, "D": d})


@pytest.fixture(scope="module")
def zoo_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo")
    for z in range(N_TENANTS):
        _save(d / f"subject_{z + 1:02d}_best_model.npz", 100 + z)
    return d


def _request(url, body=None, ctype="application/json", headers=None):
    req = urllib.request.Request(url, data=body, method="POST" if body
                                 is not None else "GET",
                                 headers={"Content-Type": ctype,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _npz(x) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=x)
    return buf.getvalue()


@pytest.fixture
def zoo_app(zoo_dir, tmp_path):
    with obs_journal.run(tmp_path / "obs") as journal:
        app = service.ServeApp(zoo=str(zoo_dir), port=0, buckets=(1, 8),
                               device="cpu", journal=journal).start()
        try:
            yield app
        finally:
            app.stop()


def test_zoo_answers_equal_predict_zoo_model(zoo_app, zoo_dir, tmp_path,
                                             monkeypatch, capsys):
    c, t, _, _ = GEOMETRY
    x = trials(11, c, t, seed=110)
    y = np.random.RandomState(111).randint(0, 4, 11)
    data = save_trials(BCICI2ADataset(X=x, y=y), tmp_path / "A01E-trials.npz")
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    for z in range(N_TENANTS):
        mid = f"subject_{z + 1:02d}_best_model"
        status, by_header = _request(zoo_app.url + "/predict", _npz(x),
                                     "application/octet-stream",
                                     {"X-Model": mid})
        assert status == 200 and by_header["model"] == mid
        status, by_field = _request(
            zoo_app.url + "/predict",
            json.dumps({"trials": x.tolist(), "model": mid}).encode())
        assert status == 200
        served = by_header["predictions"]
        assert by_field["predictions"] == served
        model = load_model_from_checkpoint(zoo_dir / f"{mid}.npz",
                                           device="cpu")
        assert served == predict_trials(model, x, device="cpu").tolist()
        assert predict_main(["--zoo", str(zoo_dir), "--model", mid,
                             "--input", str(data)]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        acc = 100.0 * float(np.mean(np.asarray(served) == y))
        assert line == f"accuracy: {acc:.2f}%"
        assert by_header["model_digest"] == zoo_app.zoo.digest_for(mid)


def test_zoo_healthz_and_unknown_models(zoo_app):
    status, health = _request(zoo_app.url + "/healthz")
    assert status == 200 and health["stacked"] is True
    assert [e["model"] for e in health["tenants"]] == \
        zoo_app.zoo.tenant_ids
    assert health["zoo_restacks"] == 1 and health["model_swaps"] == 0
    assert health["zoo"]["n_tenants"] == N_TENANTS
    assert health["precision"] == "fp32"
    assert health["kernel_launches"] == {"block1": 0, "block1_stacked": 0,
                                         "ems_stream": 0}
    c, t, _, _ = GEOMETRY
    status, reply = _request(zoo_app.url + "/predict", _npz(trials(1, c, t)),
                             "application/octet-stream",
                             {"X-Model": "nobody"})
    assert status == 404 and reply["tenants"] == zoo_app.zoo.tenant_ids
    status, reply = _request(zoo_app.url + "/predict", _npz(trials(2, c, t)))
    assert status == 400     # an npz body sent as JSON


def test_mixed_tenant_requests_coalesce_into_one_batch(zoo_app):
    c, t, _, _ = GEOMETRY
    x = trials(8, c, t, seed=120)
    ids = zoo_app.zoo.tenant_ids
    answers = [None] * 8

    def send(i):
        answers[i] = _request(zoo_app.url + "/predict", _npz(x[i:i + 1]),
                              "application/octet-stream",
                              {"X-Model": ids[i % N_TENANTS]})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    want = zoo_app.zoo.infer(x, np.arange(8) % N_TENANTS)
    for i, (status, reply) in enumerate(answers):
        assert status == 200 and reply["predictions"] == [int(want[i])]


def test_zoo_reload_under_concurrent_clients_drops_nothing(zoo_app,
                                                           tmp_path):
    c, t, _, _ = GEOMETRY
    x = trials(4, c, t, seed=130)
    new = _save(tmp_path / "new.npz", 200)
    corrupt = tmp_path / "corrupt.npz"
    corrupt.write_bytes(new.read_bytes()[:300])
    mid = zoo_app.zoo.tenant_ids[1]
    old_digest = zoo_app.zoo.digest_for(mid)
    status, reply = _request(zoo_app.url + "/reload", json.dumps(
        {"model": mid, "checkpoint": str(corrupt)}).encode())
    assert status == 400 and "error" in reply
    assert zoo_app.zoo.digest_for(mid) == old_digest
    failures, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            status, reply = _request(zoo_app.url + "/predict", _npz(x),
                                     "application/octet-stream",
                                     {"X-Model": mid})
            if status != 200:
                failures.append(reply)

    threads = [threading.Thread(target=client) for _ in range(8)]
    for th in threads:
        th.start()
    try:
        status, reply = _request(zoo_app.url + "/reload", json.dumps(
            {"model": mid, "checkpoint": str(new)}).encode())
    finally:
        stop.set()
        for th in threads:
            th.join(60)
    assert status == 200 and reply["stacked"] is True
    assert reply["model_digest"] != old_digest and not failures
    status, after = _request(zoo_app.url + "/predict", _npz(x),
                             "application/octet-stream", {"X-Model": mid})
    assert after["model_digest"] == reply["model_digest"]
    want = predict_trials(load_model_from_checkpoint(new, device="cpu"), x,
                          device="cpu")
    assert after["predictions"] == want.tolist()


def test_single_model_reload_and_int8_serving(zoo_dir, tmp_path):
    c, t, _, _ = GEOMETRY
    gate_set = [("A01E", trials(32, c, t, seed=140))]
    first = zoo_dir / "subject_01_best_model.npz"
    second = zoo_dir / "subject_02_best_model.npz"
    x = trials(5, c, t, seed=141)
    # the predict CLI's int8 path, outside the server's journal
    want = predict_trials(load_model_from_checkpoint(first, device="cpu"),
                          x, device="cpu", precision="int8")
    with obs_journal.run(tmp_path / "obs") as journal:
        app = service.ServeApp(first, port=0, buckets=(1, 8), device="cpu",
                               precision="int8", gate_set=gate_set,
                               journal=journal).start()
        try:
            status, health = _request(app.url + "/healthz")
            assert health["precision"] == "int8"
            assert health["requested_precision"] == "int8"
            status, served = _request(app.url + "/predict", _npz(x),
                                      "application/octet-stream")
            assert served["predictions"] == want.tolist()
            status, reply = _request(app.url + "/reload", json.dumps(
                {"checkpoint": str(tmp_path / "missing.npz")}).encode())
            assert status == 400
            assert _request(app.url + "/healthz")[1]["model_digest"] == \
                health["model_digest"]
            status, reply = _request(app.url + "/reload", json.dumps(
                {"checkpoint": str(second)}).encode())
            assert status == 200 and reply["model_swaps"] == 1
            assert reply["model_digest"] != health["model_digest"]
        finally:
            app.stop()
    events = schema.read_events(journal.events_path)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert "_schema_error" not in json.dumps(events)
    assert kinds.count("quant_gate") == 2 and kinds.count("model_swap") == 1
    start = next(e for e in events if e["event"] == "serve_start")
    assert start["precision"] == "int8"
    end = next(e for e in events if e["event"] == "serve_end")
    assert end["n_requests"] == kinds.count("request") == 1
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "scripts" / "obs_report.py")
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    row = obs_report.summarize_run(journal.dir)
    assert "error" not in row and "schema_drift" not in row
    assert row["precision"] == "int8" and row["quant_gate"] == "pass"
    assert row["n_requests"] == 1 and row["model_swaps"] == 1


def test_zoo_journal_reads_back(zoo_dir, tmp_path):
    with obs_journal.run(tmp_path / "obs") as journal:
        app = service.ServeApp(zoo=str(zoo_dir), port=0, buckets=(1, 8),
                               device="cpu", journal=journal, stack=False,
                               max_programs=2).start()
        c, t, _, _ = GEOMETRY
        for mid in app.zoo.tenant_ids:
            _request(app.url + "/predict", _npz(trials(1, c, t)),
                     "application/octet-stream", {"X-Model": mid})
        app.stop()
    events = schema.read_events(journal.events_path)
    kinds = [e["event"] for e in events]
    assert kinds.count("model_load") == N_TENANTS
    assert kinds.count("model_evict") == N_TENANTS - 1
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "scripts" / "obs_report.py")
    obs_report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs_report)
    row = obs_report.summarize_run(journal.dir)
    assert row["tenants"] == N_TENANTS and row["model_loads"] == N_TENANTS


# --- the tenant-aware batcher ---------------------------------------------

def _dequeue_order(batcher_cls, **kw):
    """Batches of (request id, tenant) the batcher makes from a scripted
    queue: a first request holds the worker while the rest queue up."""
    entered, release = threading.Event(), threading.Event()
    batches = []

    def infer_fn(x, tenants):
        batches.append([(int(v), int(z)) for v, z in zip(x[:, 0, 0],
                                                         tenants)])
        entered.set()
        release.wait(30)
        return np.zeros(len(x), np.int64)

    b = batcher_cls(infer_fn, max_batch=8, max_wait_ms=0.0,
                    max_queue_trials=64, tenant_aware=True, **kw)
    futures = [b.submit(np.full((1, 2, 4), 0, np.float32), tenant=0)]
    assert entered.wait(30)
    script = [(0, 3), (0, 3), (0, 3), (1, 2), (2, 5), (2, 1), (1, 4),
              (3, 1), (0, 1), (1, 1)]
    for rid, (tenant, n) in enumerate(script, 1):
        futures.append(b.submit(np.full((n, 2, 4), rid, np.float32),
                                tenant=tenant))
    release.set()
    for fut in futures:
        fut.result(30)
    b.close()
    return batches


def test_tenant_aware_batcher_dequeues_in_the_jax_order():
    from eegnetreplication_tpu.serve import batcher as jax_batcher

    got = _dequeue_order(port_batcher.MicroBatcher)
    want = _dequeue_order(jax_batcher.MicroBatcher)
    assert got == want and len(got) > 2


def test_single_tenant_batcher_keeps_its_contract():
    b = port_batcher.MicroBatcher(lambda x: np.arange(len(x)), max_batch=8)
    try:
        assert b.submit(np.zeros((3, 2, 4), np.float32)).result(30).tolist() \
            == [0, 1, 2]
        with pytest.raises(ValueError, match="single-tenant"):
            b.submit(np.zeros((1, 2, 4), np.float32), tenant=1)
    finally:
        b.close()


# --- the CLIs' parse errors -----------------------------------------------

@pytest.mark.parametrize("argv, message", [
    ([], "exactly one of --checkpoint or --zoo"),
    (["--checkpoint", "a.npz", "--zoo", "z"], "exactly one of"),
    (["--zoo", "a=x.npz", "--defaultModel", "b"], "not a zoo tenant"),
    (["--zoo", "nothing-here"], "--zoo: zoo spec entry"),
    (["--checkpoint", "a.npz", "--precision", "int4"], "invalid choice"),
])
def test_serve_cli_parse_errors(argv, message, capsys, monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    with pytest.raises(SystemExit) as exc:
        service.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("argv, message", [
    (["--input", "x.npz"], "exactly one of --checkpoint or --zoo"),
    (["--checkpoint", "a.npz", "--model", "m", "--input", "x.npz"],
     "--model requires --zoo"),
    (["--zoo", "ZOO", "--model", "nobody", "--input", "x.npz"],
     "--model: unknown model 'nobody'"),
])
def test_predict_cli_parse_errors_match_jax(argv, message, capsys,
                                            monkeypatch, zoo_dir):
    from eegnetreplication_tpu.predict import main as jax_predict_main

    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    argv = [str(zoo_dir) if a == "ZOO" else a for a in argv]
    errors = []
    for main in (predict_main, jax_predict_main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert message in errors[0]
    assert errors[0].split("error: ", 1)[1] == \
        errors[1].split("error: ", 1)[1]
