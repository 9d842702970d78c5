"""The port's serving control plane against the JAX package's, on the CPU.

Under the same inputs and a fake clock, the circuit breaker's, the
adaptive admission's, the heartbeat watchdog's and the SLO monitor's
state sequences and journal events equal the JAX ones; trace headers
round-trip across the packages.  A CPU server answers ``GET /metrics``
(JSON and Prometheus text) and ``POST /profile`` (202, then a
``profile_window`` event), retries a ``serve.forward`` fault and answers,
opens its breaker under a persistent one (``/healthz`` 503, fast 503s)
and closes it after the cooldown, sheds bulk traffic under
``admission_target_ms``, writes parented spans at ``trace_sample`` 1.0
(keeping a client's trace id), degrades ``/healthz`` on an SLO breach and
on a stale worker heartbeat, and every journal it writes passes the
port's schema and the JAX one.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_port_cases import jax_variables, trials

from eegnetreplication_tpu.obs import metrics as jax_metrics
from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu.obs import slo as jax_slo
from eegnetreplication_tpu.obs import trace as jax_trace
from eegnetreplication_tpu.resil import breaker as jax_breaker
from eegnetreplication_tpu.resil import heartbeat as jax_hb
from eegnetreplication_tpu.serve import admission as jax_admission
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import metrics, schema, slo, trace
from eegnetreplication_tpu_torch.resil import breaker
from eegnetreplication_tpu_torch.resil import heartbeat as hb
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.serve import admission, service
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    save_checkpoint,
)

C, T = 22, 257


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class Recorder:
    def __init__(self, registry):
        self.metrics = registry
        self.events = []

    def event(self, event, /, **fields):
        self.events.append((event, fields))


def _breaker_run(mod, metrics_mod, seed):
    clock, rec = Clock(), Recorder(metrics_mod.MetricsRegistry())
    br = mod.CircuitBreaker(failure_threshold=3, reset_after_s=5.0,
                            half_open_probes=2, journal=rec, clock=clock)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(300):
        op = rng.randint(5)
        if op == 0:
            out.append(("allow", br.allow()))
        elif op == 1:
            br.record_success()
        elif op == 2:
            br.record_failure()
        elif op == 3:
            br.cancel_probe()
        else:
            clock.t += float(rng.choice([0.5, 2.0, 6.0]))
        out.append(br.state)
    return out, br.trips, rec.events


@pytest.mark.parametrize("seed", range(6))
def test_breaker_sequence_equals_the_jax_breaker(seed):
    got = _breaker_run(breaker, metrics, seed)
    want = _breaker_run(jax_breaker, jax_metrics, seed)
    assert got == want
    assert "open" in got[0] and got[1] > 0


def _admission_run(mod, metrics_mod, seed):
    clock, rec = Clock(), Recorder(metrics_mod.MetricsRegistry())
    ctl = mod.AdmissionController(target_wait_ms=10.0, min_limit=8,
                                  max_limit=64, journal=rec, clock=clock)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(400):
        op = rng.randint(4)
        if op == 0:
            ok = ctl.admit(int(rng.randint(0, 70)), int(rng.randint(1, 16)))
            out.append(("admit", ok))
            if not ok:
                ctl.record_shed()
        elif op == 1:
            ctl.observe_wait(float(rng.choice([0.5, 4.0, 9.0, 30.0,
                                               rng.rand() * 50])))
        else:
            clock.t += float(rng.choice([0.01, 0.1, 0.3]))
        out.append(ctl.limit)
    return out, ctl.snapshot(), ctl.n_changes, rec.events


@pytest.mark.parametrize("seed", range(6))
def test_admission_sequence_equals_the_jax_controller(seed):
    got = _admission_run(admission, metrics, seed)
    want = _admission_run(jax_admission, jax_metrics, seed)
    assert got == want
    assert got[2] > 0


@pytest.mark.parametrize("phase", ["serve_idle", "serve_forward", "step",
                                   "compile", "unknown"])
def test_watchdog_verdicts_equal_the_jax_watchdog(phase):
    thresholds = {"serve_idle": 10.0, "serve_forward": 60.0}
    port, ref = hb.Watchdog(thresholds), jax_hb.Watchdog(thresholds)
    for age in (0.0, 5.0, 10.5, 59.0, 61.0, 700.0, 2000.0):
        beat = hb.Beat(phase=phase, beat=3, t=1000.0, pid=1)
        jbeat = jax_hb.Beat(phase=phase, beat=3, t=1000.0, pid=1)
        a = port.check_beat(beat, now=1000.0 + age)
        b = ref.check_beat(jbeat, now=1000.0 + age)
        assert (a.stale, a.age_s, a.phase, a.threshold_s) == \
            (b.stale, b.age_s, b.phase, b.threshold_s)
    for since in (None, 100.0, 990.0):
        a = port.check_beat(None, now=1000.0, since=since)
        b = ref.check_beat(None, now=1000.0, since=since)
        assert (a.stale, a.age_s, a.phase) == (b.stale, b.age_s, b.phase)
    assert service.SERVE_WATCHDOG_THRESHOLDS == {"serve_idle": 10.0,
                                                 "serve_forward": 60.0}


def _slo_run(mod, metrics_mod, seed):
    clock = Clock()
    registry = metrics_mod.MetricsRegistry()
    rec = Recorder(registry)
    mon = mod.SLOMonitor(registry, "p95_latency_ms<20,error_rate<0.2,"
                         "availability>0.7", window_s=5.0, interval_s=0,
                         journal=rec, clock=clock)
    rng = np.random.RandomState(seed)
    out = []
    for step in range(60):
        bad = (step // 15) % 2 == 1
        for _ in range(int(rng.randint(0, 6))):
            status = ("error" if bad and rng.rand() < 0.5 else
                      str(rng.choice(["ok", "ok", "rejected"])))
            registry.inc("requests_total", status=status)
            if status == "ok":
                registry.observe("request_latency_ms",
                                 float(rng.gamma(2.0, 15.0 if bad else 2.0)))
        clock.t += 1.0
        mon.evaluate()
        out.append(mon.state())
    return out, mon.breach_events, rec.events


@pytest.mark.parametrize("seed", range(4))
def test_slo_monitor_sequence_equals_the_jax_monitor(seed):
    got = _slo_run(slo, metrics, seed)
    want = _slo_run(jax_slo, jax_metrics, seed)
    assert got == want
    assert got[1] > 0


def test_slo_specs_parse_as_in_jax():
    spec = "p95_latency_ms<50,error_rate<0.01,availability>0.999"
    assert [o.name for o in slo.parse_slo_spec(spec)] == \
        [o.name for o in jax_slo.parse_slo_spec(spec)]
    for bad in ("p95_latency<5", "error_rate=0.1", ""):
        with pytest.raises(ValueError):
            slo.parse_slo_spec(bad)
        with pytest.raises(ValueError):
            jax_slo.parse_slo_spec(bad)


@pytest.mark.parametrize("sampled", [True, False])
def test_trace_headers_round_trip_across_the_packages(sampled):
    ctx = trace.TraceContext(trace.new_trace_id(), trace.new_span_id(),
                             sampled)
    back = jax_trace.from_headers(trace.headers(ctx))
    assert (back.trace_id, back.span_id, back.sampled) == \
        (ctx.trace_id, ctx.span_id, ctx.sampled)
    jctx = jax_trace.TraceContext(jax_trace.new_trace_id(),
                                  jax_trace.new_span_id(), sampled)
    back = trace.from_headers(jax_trace.headers(jctx))
    assert (back.trace_id, back.span_id, back.sampled) == \
        (jctx.trace_id, jctx.span_id, jctx.sampled)
    assert trace.headers(None) == {} and trace.from_headers({}) is None
    assert (trace.TRACE_HEADER, trace.PARENT_HEADER, trace.SAMPLED_HEADER,
            trace.DEFAULT_SAMPLE_RATE, trace.ANOMALY_STATUSES) == \
        (jax_trace.TRACE_HEADER, jax_trace.PARENT_HEADER,
         jax_trace.SAMPLED_HEADER, jax_trace.DEFAULT_SAMPLE_RATE,
         jax_trace.ANOMALY_STATUSES)


def test_unsampled_spans_flush_only_on_an_anomaly():
    rec = Recorder(metrics.MetricsRegistry())
    ctx = trace.TraceContext(trace.new_trace_id(), sampled=False)
    with trace.use(ctx):
        with trace.span("outer", journal=rec):
            with trace.span("inner", journal=rec):
                pass
        assert rec.events == []
        assert trace.flush_if_anomalous("ok", journal=rec) == 0
        assert trace.flush_if_anomalous("error", journal=rec) == 2
    outer = next(f for n, f in rec.events if f["name"] == "outer")
    inner = next(f for n, f in rec.events if f["name"] == "inner")
    assert inner["parent_span_id"] == outer["span_id"]


# --- The CPU server ----------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params, bs = jax_variables(C, T, 8, 2, seed=41)
    return save_checkpoint(
        tmp_path_factory.mktemp("control") / "m.npz",
        from_jax_variables(params, bs),
        metadata={"model": "eegnet", "n_channels": C, "n_times": T,
                  "F1": 8, "D": 2})


def _request(url, body=None, headers=None, raw=False):
    req = urllib.request.Request(
        url, data=body, method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            data = resp.read()
            return resp.status, (data.decode() if raw
                                 else json.loads(data.decode())), \
                resp.headers.get("Content-Type")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode()), None


def _predict(app, x, headers=None):
    status, reply, _ = _request(app.url + "/predict", json.dumps(
        {"trials": x.tolist()}).encode(), headers)
    return status, reply


def _events(journal):
    return schema.read_events(journal.events_path, complete=False)


def _both_schemas(journal):
    """The finished run's journal under the port's schema and the JAX
    one."""
    port = schema.read_events(journal.events_path)
    ref = jax_schema.read_events(journal.events_path)
    assert len(port) == len(ref)
    assert "_schema_error" not in json.dumps(port)
    return port


def _serve(checkpoint, tmp_path, **kw):
    """A started ServeApp inside an open run journal; yields (app,
    journal) and stops both."""
    kw.setdefault("buckets", (1, 8, 32))
    with obs_journal.run(tmp_path / "obs", config={}) as journal:
        app = service.ServeApp(checkpoint, port=0, device="cpu",
                               journal=journal, **kw).start()
        try:
            yield app, journal
        finally:
            app.stop()
    _both_schemas(journal)


def test_metrics_json_and_prometheus_text(checkpoint, tmp_path):
    for app, journal in _serve(checkpoint, tmp_path):
        x = trials(3, C, T, seed=42)
        assert _predict(app, x)[0] == 200
        status, snap, ctype = _request(app.url + "/metrics")
        assert status == 200 and ctype == "application/json"
        schema.validate_metrics(snap)
        jax_schema.validate_metrics(snap)
        ok = next(e for e in snap["counters"]["requests_total"]
                  if e["labels"] == {"status": "ok"})
        assert ok["value"] == 1.0
        assert snap["histograms"]["batch_trials"][0]["count"] >= 1
        fills = {e["labels"]["bucket"] for e in
                 snap["histograms"]["bucket_fill"]}
        assert fills == {"8"}
        status, text, ctype = _request(app.url + "/metrics",
                                       headers={"Accept": "text/plain"},
                                       raw=True)
        assert status == 200 and ctype.startswith("text/plain")
        assert 'requests_total{status="ok"} 1.0' in text
        assert "# TYPE request_latency_ms histogram" in text
        assert "process_resident_memory_bytes" in text
        health = _request(app.url + "/healthz")[1]
        assert health["latency_ms"]["p50"] == pytest.approx(
            journal.metrics.quantile("request_latency_ms", 0.5))
        assert health["status"] == "ok" and health["circuit"] == "closed"
        assert health["worker_heartbeat"]["stale"] is False
        assert health["ladder_retunes"] == 0 and health["admission"] is None


def test_profile_window_answers_202_then_journals(checkpoint, tmp_path):
    for app, journal in _serve(checkpoint, tmp_path):
        status, reply, _ = _request(app.url + "/profile",
                                    json.dumps({"seconds": 0.5}).encode())
        assert status == 202 and reply["status"] == "started"
        assert reply["max_s"] == service.PROFILE_MAX_S == 60.0
        assert _request(app.url + "/profile", b"{}")[0] == 409
        assert _request(app.url + "/profile", json.dumps(
            {"seconds": -1}).encode())[0] == 400
        _predict(app, trials(2, C, T, seed=43))
        deadline = time.monotonic() + 30
        windows = []
        while not windows and time.monotonic() < deadline:
            time.sleep(0.2)
            windows = [e for e in _events(journal)
                       if e["event"] == "profile_window"]
        assert windows and windows[0]["status"] == "ok"
        assert windows[0]["log_dir"] == reply["log_dir"]
        assert (journal.dir / windows[0]["trace"].split("/")[-2]).exists()


def test_chaos_forward_fault_is_retried_and_answered(checkpoint, tmp_path):
    for app, journal in _serve(checkpoint, tmp_path):
        x = trials(4, C, T, seed=44)
        want = app.engine.infer(x).tolist()
        with inject.scoped(*inject.parse_plan("serve.forward:times=1")):
            status, reply = _predict(app, x)
        assert status == 200 and reply["predictions"] == want
        events = _events(journal)
        assert [e["site"] for e in events
                if e["event"] == "fault_injected"] == ["serve.forward"]
        retries = [e for e in events if e["event"] == "retry"]
        assert len(retries) == 1
        assert retries[0]["classification"] == "device_fault"
        assert app.breaker.state == "closed"


def test_persistent_fault_opens_the_breaker_then_closes(checkpoint,
                                                        tmp_path):
    for app, journal in _serve(checkpoint, tmp_path, breaker_threshold=2,
                               breaker_reset_s=0.5):
        x = trials(2, C, T, seed=45)
        handle = inject.arm("serve.forward", times=0)
        try:
            assert [_predict(app, x)[0] for _ in range(2)] == [500, 500]
            status, health, _ = _request(app.url + "/healthz")
            assert status == 503 and health["status"] == "degraded"
            assert health["circuit"] == "open"
            assert "circuit_open" in health["degraded"]
            t0 = time.perf_counter()
            status, reply = _predict(app, x)
            assert status == 503 and reply["circuit"] == "open"
            assert time.perf_counter() - t0 < 1.0
        finally:
            inject.disarm(handle)
        time.sleep(0.6)
        assert _predict(app, x)[0] == 200
        status, health, _ = _request(app.url + "/healthz")
        assert status == 200 and health["circuit"] == "closed"
        states = [e["state"] for e in _events(journal)
                  if e["event"] == "circuit_state"]
        assert states == ["open", "half_open", "closed"]
        statuses = [e["status"] for e in _events(journal)
                    if e["event"] == "request"]
        assert statuses == ["error", "error", "circuit_open", "ok"]


def test_admission_target_sheds_bulk_with_429(checkpoint, tmp_path):
    plan = inject.parse_plan("serve.degrade:slow=0.05:times=0")
    with inject.scoped(*plan):
        for app, journal in _serve(checkpoint, tmp_path, buckets=(1, 8),
                                   max_queue_trials=64,
                                   admission_target_ms=1.0):
            x = trials(8, C, T, seed=46)
            codes, lock = [], threading.Lock()
            stop = threading.Event()

            def client():
                while not stop.is_set():
                    status, reply = _predict(app, x)
                    with lock:
                        codes.append((status, reply.get("shed")))

            # 6 clients of 8 trials stay under the hard bound of 64: every
            # 429 is the adaptive limit's.
            threads = [threading.Thread(target=client) for _ in range(6)]
            for th in threads:
                th.start()
            time.sleep(3.0)
            stop.set()
            for th in threads:
                th.join(60)
            health = _request(app.url + "/healthz")[1]
    assert (429, True) in codes and (200, None) in codes
    assert set(codes) <= {(200, None), (429, True)}
    assert health["admission"]["shed"] > 0
    assert health["admission"]["limit_trials"] < 64
    events = schema.read_events(journal.events_path)
    assert any(e["event"] == "admission_change" and e["reason"] == "backoff"
               for e in events)
    assert any(e["event"] == "request" and e["status"] == "shed"
               for e in events)


def test_trace_sample_one_writes_parented_spans(checkpoint, tmp_path):
    client_trace = "c0ffee" * 5 + "00"
    for app, journal in _serve(checkpoint, tmp_path, trace_sample=1.0):
        assert _predict(app, trials(3, C, T, seed=47), headers={
            "X-Trace-Id": client_trace, "X-Parent-Span": "feedfacefeedface",
            "X-Trace-Sampled": "1"})[0] == 200
        assert _predict(app, trials(1, C, T, seed=48))[0] == 200
    spans = [e for e in schema.read_events(journal.events_path)
             if e["event"] == "span"]
    mine = {s["name"]: s for s in spans if s["trace_id"] == client_trace}
    assert set(mine) >= {"replica.request", "http.parse", "queue.wait",
                         "batch.forward", "engine.forward", "batch.scatter"}
    root = mine["replica.request"]
    assert root["parent_span_id"] == "feedfacefeedface"
    assert mine["http.parse"]["parent_span_id"] == root["span_id"]
    assert mine["queue.wait"]["parent_span_id"] == root["span_id"]
    assert mine["engine.forward"]["parent_span_id"] == \
        mine["batch.forward"]["span_id"]
    assert mine["engine.forward"]["bucket"] == 8
    assert mine["batch.scatter"]["link_span"] == \
        mine["batch.forward"]["span_id"]
    others = {s["trace_id"] for s in spans} - {client_trace}
    assert len(others) == 1      # the second request's own sampled trace


def test_slo_breach_degrades_healthz(checkpoint, tmp_path):
    for app, journal in _serve(checkpoint, tmp_path,
                               slo_spec="p95_latency_ms<0.001",
                               slo_interval_s=0):
        assert _request(app.url + "/healthz")[0] == 200
        assert _predict(app, trials(2, C, T, seed=49))[0] == 200
        status, health, _ = _request(app.url + "/healthz")
        assert status == 503
        assert health["degraded"] == ["slo:p95_latency_ms<0.001"]
        assert health["slo"]["breached"] == ["p95_latency_ms<0.001"]
    events = schema.read_events(journal.events_path)
    breach = [e for e in events if e["event"] == "slo_breach"]
    assert len(breach) == 1 and breach[0]["objective"] == \
        "p95_latency_ms<0.001"
    end = next(e for e in events if e["event"] == "serve_end")
    assert end["slo_breaches"] == 1


def test_stale_worker_heartbeat_degrades_healthz(checkpoint, tmp_path):
    for app, journal in _serve(
            checkpoint, tmp_path,
            watchdog_thresholds={"serve_forward": 0.2}):
        with inject.scoped(*inject.parse_plan("serve.hang:sleep=2.0")):
            result = []
            th = threading.Thread(target=lambda: result.append(
                _predict(app, trials(1, C, T, seed=50))[0]))
            th.start()
            status = 200
            while status == 200 and th.is_alive():
                time.sleep(0.1)
                status, health, _ = _request(app.url + "/healthz")
            th.join(30)
        assert status == 503
        assert "worker_heartbeat_stale" in health["degraded"]
        assert health["worker_heartbeat"]["phase"] == "serve_forward"
        assert result == [200]
        time.sleep(0.1)
        assert _request(app.url + "/healthz")[0] == 200


def test_serve_cli_takes_the_control_plane_flags(checkpoint, tmp_path,
                                                 monkeypatch):
    """The nine flags parse, and a bad --slo or --chaos stops the CLI."""
    for bad, flag in (("p95<3", "--slo"), ("nope.site", "--chaos")):
        with pytest.raises(SystemExit) as exc:
            service.main(["--checkpoint", str(checkpoint), flag, bad])
        assert exc.value.code == 2
    seen = {}

    class Stop(Exception):
        pass

    def fake_app(*args, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(service, "ServeApp", fake_app)
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    with pytest.raises(Stop):
        service.main(["--checkpoint", str(checkpoint), "--port", "0",
                      "--metricsDir", str(tmp_path / "obs"),
                      "--tuneEveryS", "2", "--traceSample", "0.5",
                      "--admissionTargetMs", "40", "--chaos",
                      "serve.degrade:slow=0.01", "--chaosTag", "r1",
                      "--slo", "error_rate<0.1", "--sloWindowS", "9",
                      "--breakerThreshold", "7", "--breakerResetS", "3"])
    assert (seen["tune_every_s"], seen["trace_sample"],
            seen["admission_target_ms"], seen["chaos_tag"],
            seen["slo_spec"], seen["slo_window_s"],
            seen["breaker_threshold"], seen["breaker_reset_s"]) == \
        (2.0, 0.5, 40.0, "r1", "error_rate<0.1", 9.0, 7, 3.0)
    assert not inject.armed()


def test_the_newly_ported_chaos_sites_parse_as_in_jax():
    from eegnetreplication_tpu.resil import inject as jax_inject

    for site in ("serve.forward", "serve.hang", "serve.degrade"):
        port, = inject.parse_plan(f"{site}:after=1:times=2")
        ref, = jax_inject.parse_plan(f"{site}:after=1:times=2")
        assert (port.site, port.after, port.times) == \
            (ref.site, ref.after, ref.times)
        assert inject._DEFAULTS[site][0] == jax_inject._DEFAULTS[site][0]
