"""Black-box probing (``obs/probe.py``) and the batcher's ``exempt`` against
the JAX package, on the CPU at a small width (C=4, T=64, F1=4, D=2).

- ``MicroBatcher.submit(exempt=True)`` bypasses the adaptive admission
  limit and stays out of the ``queue_wait_ms``, ``batch_trials`` and
  ``batch_requests`` observations (``bucket_fill`` still counts it), and
  every terminal path (scatter, expiry, a failed forward, close) drops it
  from the exempt set: the same observation counts as the JAX batcher.
- The port's ``Prober`` against a port server: ``ok`` probe events,
  ``probe_requests_total`` and ``/healthz`` ``probes`` count them,
  ``requests_total`` and the request latency do not, and neither the
  admission nor the tuner observes them; the JAX ``Prober`` reads the
  port server the same way.  Against a dead front door both probers
  journal the same ``probe`` and ``probe:``-prefixed ``slo_breach``
  events.
- A server probed every 50 ms with no other traffic proposes no retune.
"""

import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
from torch_port_cases import jax_variables

from eegnetreplication_tpu.obs import metrics as jax_metrics
from eegnetreplication_tpu.obs import probe as jax_probe
from eegnetreplication_tpu.serve import admission as jax_admission
from eegnetreplication_tpu.serve import batcher as jax_batcher
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import metrics, probe, schema
from eegnetreplication_tpu_torch.serve import admission, batcher, service
from eegnetreplication_tpu_torch.serve.tuner import LadderTuner
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    save_checkpoint,
)

C, T, F1, D = 4, 64, 4, 2


class Recorder:
    def __init__(self, registry):
        self.metrics = registry
        self.events = []

    def event(self, event, /, **fields):
        self.events.append((event, fields))


def _hist_count(registry, name):
    snap = registry.snapshot()
    return sum(e["count"] for e in snap.get("histograms", {}).get(name, []))


# --- exempt in the batcher ------------------------------------------------------

def _exempt_run(bmod, mmod, amod):
    """The same sequence through one package's batcher: admission bypass,
    observations, and the exempt set's terminal paths."""
    rec = Recorder(mmod.MetricsRegistry())
    adm = amod.AdmissionController(target_wait_ms=1000.0, min_limit=4,
                                   max_limit=4, journal=rec)
    gate = threading.Event()
    calls = []

    def infer(x):
        calls.append(len(x))
        gate.wait(10)
        if len(x) == 3:
            raise RuntimeError("forward failed")
        return np.zeros(len(x), np.int64)

    b = bmod.MicroBatcher(infer, max_batch=4, max_wait_ms=1.0,
                          max_queue_trials=64, journal=rec, admission=adm)
    out = {}
    try:
        first = b.submit(np.zeros((4, C, T), np.float32))
        time.sleep(0.2)                       # the forward holds the gate
        probe_fut = b.submit(np.zeros((4, C, T), np.float32), exempt=True)
        shed = None
        try:
            b.submit(np.zeros((1, C, T), np.float32))
        except bmod.Shed:
            shed = "shed"
        out["bulk_over_the_limit"] = shed
        gate.set()
        first.result(10)
        probe_fut.result(10)
        out["exempt_after_scatter"] = len(b._exempt)
        # An exempt request past its deadline expires at dequeue.
        gate.clear()
        blocker = b.submit(np.zeros((4, C, T), np.float32))
        time.sleep(0.2)
        late = b.submit(np.zeros((1, C, T), np.float32), exempt=True,
                        deadline=time.monotonic() + 0.05)
        time.sleep(0.3)
        gate.set()
        blocker.result(10)
        with pytest.raises(bmod.DeadlineExceeded):
            late.result(10)
        out["exempt_after_expiry"] = len(b._exempt)
        # A failed forward (a 3-trial batch raises).
        failed = b.submit(np.zeros((3, C, T), np.float32), exempt=True)
        with pytest.raises(RuntimeError):
            failed.result(10)
        out["exempt_after_failure"] = len(b._exempt)
        # An all-probe batch and a mixed one.
        b.submit(np.zeros((2, C, T), np.float32), exempt=True).result(10)
        mixed = [b.submit(np.zeros((1, C, T), np.float32), exempt=e)
                 for e in (True, False)]
        for f in mixed:
            f.result(10)
    finally:
        gate.set()
    out["queue_wait_ms"] = _hist_count(rec.metrics, "queue_wait_ms")
    out["batch_trials"] = _hist_count(rec.metrics, "batch_trials")
    out["batch_requests"] = _hist_count(rec.metrics, "batch_requests")
    trials = rec.metrics.snapshot()["histograms"].get("batch_trials", [])
    out["batch_trials_sum"] = sum(e["sum"] for e in trials)
    # close(drain=False) fails what is queued, exempt or not.
    gate.clear()
    b.submit(np.zeros((4, C, T), np.float32))
    time.sleep(0.2)
    queued = b.submit(np.zeros((1, C, T), np.float32), exempt=True)
    closer = threading.Thread(target=b.close, kwargs={"drain": False})
    closer.start()
    time.sleep(0.2)
    gate.set()
    closer.join(10)
    with pytest.raises(bmod.Rejected):
        queued.result(10)
    out["exempt_after_close"] = len(b._exempt)
    return out


def test_exempt_requests_follow_the_jax_batcher():
    got = _exempt_run(batcher, metrics, admission)
    want = _exempt_run(jax_batcher, jax_metrics, jax_admission)
    assert got == want
    assert got["bulk_over_the_limit"] == "shed"
    assert all(got[k] == 0 for k in got if k.startswith("exempt_after"))
    # Only the user requests were observed.
    assert got["batch_trials_sum"] == 4 + 4 + 1


# --- the prober against a port server ---------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params, bs = jax_variables(C, T, F1, D, seed=13)
    return save_checkpoint(
        tmp_path_factory.mktemp("ckpt") / "model.npz",
        from_jax_variables(params, bs),
        metadata={"model": "eegnet", "n_channels": C, "n_times": T,
                  "F1": F1, "D": D})


def _serve(checkpoint, tmp_path, **kw):
    with obs_journal.run(tmp_path / "obs", config={}) as journal:
        app = service.ServeApp(checkpoint, port=0, device="cpu",
                               buckets=(1, 8), journal=journal,
                               **kw).start()
        try:
            yield app, journal
        finally:
            app.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read().decode())


def test_probes_are_counted_apart_from_user_traffic(checkpoint, tmp_path):
    n = 5
    for app, journal in _serve(checkpoint, tmp_path,
                               admission_target_ms=50.0):
        port_prober = probe.Prober(app.url, journal=journal, slo=None)
        jax_prober = jax_probe.Prober(app.url, journal=journal, slo=None)
        results = [port_prober.probe_once() for _ in range(n)]
        results += [jax_prober.probe_once() for _ in range(n)]
        assert [r["status"] for r in results] == ["ok"] * (2 * n)
        assert port_prober.state().keys() == jax_prober.state().keys()
        assert port_prober.state()["probes_sent"] == n
        snap = _get(app.url + "/metrics")
        probes = {e["labels"]["status"]: e["value"]
                  for e in snap["counters"]["probe_requests_total"]}
        assert probes == {"ok": 2.0 * n}
        assert "requests_total" not in snap["counters"]
        hists = snap["histograms"]
        for name in ("request_latency_ms", "queue_wait_ms", "batch_trials",
                     "batch_requests"):
            assert name not in hists, name
        assert sum(e["count"] for e in hists["bucket_fill"]) == 2 * n
        assert hists["probe_latency_ms"][0]["count"] == 2 * n
        health = _get(app.url + "/healthz")
        assert health["probes"] == 2 * n
        assert health["latency_ms"]["p50"] is None
        # Probes never reach the admission limit's arrival count.
        assert health["admission"]["shed"] == 0
        assert health["admission"]["arrival_trials_per_s"] == 0
    events = schema.read_events(journal.events_path)
    probe_events = [e for e in events if e["event"] == "probe"]
    assert len(probe_events) == 2 * n
    assert {e["status"] for e in probe_events} == {"ok"}
    assert all(e["url"] == app.url for e in probe_events)
    requests = [e for e in events if e["event"] == "request"]
    assert len(requests) == 2 * n and all(e["probe"] for e in requests)
    (end,) = [e for e in events if e["event"] == "serve_end"]
    assert end["probes"] == 2 * n and end["n_requests"] == 0


def _dead_url():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return f"http://127.0.0.1:{port}"


def test_a_dead_front_door_breaches_the_probe_slo_as_jax():
    url = _dead_url()
    runs = []
    for mod, mmod in ((probe, metrics), (jax_probe, jax_metrics)):
        rec = Recorder(mmod.MetricsRegistry())
        clock = [100.0]
        p = mod.Prober(url, journal=rec, timeout_s=0.5,
                       slo="availability>0.99,p95_latency_ms<1000",
                       min_samples=3, clock=lambda: clock[0])
        for _ in range(4):
            p.probe_once()
            clock[0] += 1.0
        runs.append(([(name, {k: f.get(k) for k in (
            "status", "objective", "threshold", "metric", "n_probes",
            "http_status", "url")}) for name, f in rec.events],
            p.state(), p.breached))
    assert runs[0] == runs[1]
    names = [name for name, _ in runs[0][0]]
    assert names == ["probe", "probe", "probe", "slo_breach", "probe"]
    assert runs[0][0][3][1]["objective"] == "probe:availability>0.99"
    assert runs[0][2] is True
    assert probe.PROBE_HEADER == jax_probe.PROBE_HEADER == "X-Probe"
    assert probe.DEFAULT_PROBE_SLO == jax_probe.DEFAULT_PROBE_SLO


def test_a_probed_idle_server_proposes_no_retune(checkpoint, tmp_path):
    for app, journal in _serve(checkpoint, tmp_path, tune_every_s=0.25):
        tuner = LadderTuner(app.registry, app.batcher, journal=journal)
        tuner.collect()                       # open the window
        prober = probe.Prober(app.url, interval_s=0.05, journal=journal,
                              slo=None).start()
        deadline = time.monotonic() + 30
        while prober.probes_sent < 30 and time.monotonic() < deadline:
            time.sleep(0.05)
        prober.stop()
        assert prober.probes_sent >= 30
        stats = tuner.collect()
        assert stats.dispatches == 0 and stats.trials == 0
        assert tuner.tune_once() is None
        assert app.ladder_retunes == 0
        assert _get(app.url + "/healthz")["buckets"] == [1, 8]
        # No retune while only probes arrived.  The user requests below
        # may retune the ladder at the server's next tune tick, as they
        # should, so the journal is read before them.
        probed = schema.read_events(journal.events_path, complete=False)
        assert not [e for e in probed if e["event"] == "ladder_retune"]
        # The same count of user requests would have been seen.
        body = json.dumps({"trials": np.zeros((1, C, T)).tolist()}).encode()
        for _ in range(25):
            req = urllib.request.Request(app.url + "/predict", data=body,
                                         headers={"Content-Type":
                                                  "application/json"})
            urllib.request.urlopen(req, timeout=30).read()
        assert tuner.collect().dispatches == 25
    events = schema.read_events(journal.events_path)
    assert len([e for e in events if e["event"] == "probe"]) >= 30
