"""The port's streaming sessions against the JAX package's, on the CPU.

Small width: C=4 channels, 64-sample windows, hop 16, an EMS seed block of
50 samples.  Everything the port computes from samples is held to the JAX
package within 1e-4 (the EMS tolerance; the two seed statistics reduce in
different orders), and to itself bit for bit:

- ``StreamSession``: window positions, and the snapshot's rollback to the
  decided frontier, equal JAX's;
- ``sessions.npz`` written by either package's ``SessionStore`` restores in
  the other's with the digest checked, an export from one imports into the
  other, and a tampered import is refused with the store untouched;
- keep-N generations: a newest generation corrupted through the
  ``session.snapshot`` site falls back to the previous one; a
  ``session.restore`` read fault is retried; the ``spool.mirror`` copy;
- over HTTP, the port's session round trip decides what the JAX
  ``ServeApp`` decides on the same checkpoint and stream (a differing
  window must have a JAX logit margin under 1e-4), and what the port's
  offline pipeline decides, exactly; ``stop()`` then ``resume=True``
  continues the stream bit for bit; an expired window degrades to
  ``pred=-1`` and the stream goes on; the label, export, import and
  discard routes.
"""

import json
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_cases import jax_model, jax_variables

from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu.resil import inject as jax_inject
from eegnetreplication_tpu.serve import sessions as jax_sessions
from eegnetreplication_tpu.serve.service import ServeApp as JaxServeApp
from eegnetreplication_tpu.serve.sessions import store as jax_store
from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.ops.ems import exponential_moving_standardize
from eegnetreplication_tpu_torch.resil import inject, integrity
from eegnetreplication_tpu_torch.serve import batcher as batcher_lib
from eegnetreplication_tpu_torch.serve import sessions as port_sessions
from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
from eegnetreplication_tpu_torch.serve.service import ServeApp
from eegnetreplication_tpu_torch.serve.sessions import (
    SessionStore,
    StreamSession,
    WindowDecision,
)
from eegnetreplication_tpu_torch.serve.sessions import store as port_store

C, T, HOP, BLOCK = 4, 64, 16, 50
F1, D = 8, 2
N = 1200                      # (1200 - 64) / 16 + 1 = 72 windows
ATOL = RTOL = 1e-4
OPEN = {"session": "s1", "hop": HOP, "ems_init_block_size": BLOCK}


@pytest.fixture(scope="module")
def recording():
    rng = np.random.RandomState(29)
    return (rng.randn(C, N) * 5.0 + 9.0).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    params, bs = jax_variables(C, T, F1, D, seed=31)
    path = jax_ckpt.save_checkpoint(
        tmp_path_factory.mktemp("ckpt") / "m.npz", params, bs,
        metadata={"model": "eegnet", "n_channels": C, "n_times": T,
                  "F1": F1, "D": D})
    return path, params, bs


def _offline_preds(ckpt, x):
    """The port's offline pipeline: one-shot ``scan`` EMS, the same
    windows, the engine's predictions."""
    std = exponential_moving_standardize(
        torch.from_numpy(x), init_block_size=BLOCK, method="scan").numpy()
    wins = np.stack([std[:, k * HOP:k * HOP + T]
                     for k in range((x.shape[1] - T) // HOP + 1)])
    return InferenceEngine.from_checkpoint(ckpt, (1, 8),
                                           device="cpu").infer(wins)


def _session(module, **kw):
    cls = module.StreamSession
    extra = {"device": "cpu"} if module is not jax_sessions else {}
    return cls("s", n_channels=C, window=T, hop=HOP,
               ems_init_block_size=BLOCK, **extra, **kw)


def _decide(session, ready, wd_cls, pred=1):
    for idx, start, _ in ready:
        session.record(wd_cls(index=idx, start=start, pred=pred,
                              status="ok", latency_ms=1.0))


# --- StreamSession -----------------------------------------------------------

def test_window_positions_and_rollback_equal_jax(recording):
    jsess, psess = _session(jax_sessions), _session(port_sessions)
    jready, pready = [], []
    for pos in range(0, 600, 33):
        jready += jsess.ingest(recording[:, pos:pos + 33])
        pready += psess.ingest(recording[:, pos:pos + 33])
    assert [(i, s) for i, s, _ in pready] == [(i, s) for i, s, _ in jready]
    assert all(s == i * HOP for i, s, _ in pready) and len(pready) > 6
    for (_, _, p), (_, _, j) in zip(pready, jready):
        np.testing.assert_allclose(p, j, atol=ATOL, rtol=RTOL)
    _decide(jsess, jready[:3], jax_sessions.WindowDecision)
    _decide(psess, pready[:3], WindowDecision)
    jstate, pstate = jsess.state_arrays(), psess.state_arrays()
    assert sorted(pstate) == sorted(jstate)
    for key in jstate:
        assert np.asarray(pstate[key]).dtype == np.asarray(jstate[key]).dtype
    jback = jax_sessions.StreamSession.from_state("s", jstate)
    pback = StreamSession.from_state("s", pstate, device="cpu")
    assert (pback.windows_decided, pback.acked) == (3, 627) == \
        (jback.windows_decided, jback.acked)
    jagain = jback.ingest(np.zeros((C, 0), np.float32))
    pagain = pback.ingest(np.zeros((C, 0), np.float32))
    assert [(i, s) for i, s, _ in pagain] == [(i, s) for i, s, _ in jagain] \
        == [(i, s) for i, s, _ in pready[3:]]
    for (_, _, a), (_, _, b) in zip(pagain, pready[3:]):
        np.testing.assert_array_equal(a, b)


def test_decision_history_and_labels_survive_a_round_trip(recording):
    session = _session(port_sessions, decision_history=5)
    ready = session.ingest(recording[:, :400])
    _decide(session, ready, WindowDecision, pred=2)
    assert session.label(len(ready) - 1, 3) is True
    assert session.label(len(ready) - 1, 3) is False
    back = StreamSession.from_state("s", session.state_arrays(),
                                    device="cpu")
    assert back.preds_offset == len(ready) - 5
    np.testing.assert_array_equal(back.preds(), session.preds())
    assert back.labels == {len(ready) - 1: 3}
    with pytest.raises(ValueError, match="out of order"):
        back.record(WindowDecision(index=0, start=0, pred=0, status="ok",
                                   latency_ms=0.0))


# --- the store and its files -------------------------------------------------

def _fill(store, x, *, jax=False, sid="a", n=700):
    kw = dict(n_channels=C, window=T, hop=HOP, ems_init_block_size=BLOCK)
    session, resumed = store.open(sid, **kw)
    assert not resumed
    wd = jax_sessions.WindowDecision if jax else WindowDecision
    _decide(session, session.ingest(x[:, :n]), wd, pred=2)
    return session


def _continue_equal(a, b, x, n=700):
    wa, wb = a.ingest(x[:, n:]), b.ingest(x[:, n:])
    assert [(i, s) for i, s, _ in wa] == [(i, s) for i, s, _ in wb]
    assert len(wa) > 0
    for (_, _, p), (_, _, q) in zip(wa, wb):
        np.testing.assert_allclose(p, q, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_sessions_npz_restores_across_packages(tmp_path, recording,
                                               direction):
    path = tmp_path / "sessions.npz"
    if direction == "jax-to-port":
        writer = jax_store.SessionStore(path)
        reader = SessionStore(path, device="cpu")
    else:
        writer = SessionStore(path, device="cpu")
        reader = jax_store.SessionStore(path)
    source = _fill(writer, recording, jax=direction == "jax-to-port")
    writer.snapshot()
    writer.detach()
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    assert integrity.stored_digest(flat) == integrity.content_digest(flat)
    assert reader.restore() == ["a"]
    restored = reader.get("a")
    assert (restored.acked, restored.windows_decided) == \
        (source.acked, source.windows_decided)
    np.testing.assert_array_equal(restored.preds(), source.preds())
    _continue_equal(source, restored, recording)
    reader.detach()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_an_export_imports_across_packages(tmp_path, recording, direction):
    jstore = jax_store.SessionStore(tmp_path / "j" / "sessions.npz")
    pstore = SessionStore(tmp_path / "p" / "sessions.npz", device="cpu")
    src, dst = (jstore, pstore) if direction == "jax-to-port" \
        else (pstore, jstore)
    source = _fill(src, recording, jax=src is jstore)
    data = src.export_session("a")
    assert port_store.peek_session_id(data) == "a"
    tampered = bytearray(data)
    tampered[len(data) // 2] ^= 0xFF
    for bad in (bytes(tampered), data[:len(data) // 2]):
        with pytest.raises(ValueError):   # IntegrityError in both packages
            dst.import_session(bad)
        assert dst.ids() == []
    imported = dst.import_session(data)
    assert imported.acked == source.acked
    with pytest.raises(ValueError, match="already open"):
        dst.import_session(data)
    _continue_equal(source, imported, recording)
    jstore.detach()
    pstore.detach()


def test_pack_and_unpack_refuse_what_is_not_one_stamped_session(recording):
    store = SessionStore(None, device="cpu")
    state = _fill(store, recording).state_arrays()
    store.detach()
    assert store.snapshot() is None and store.restore() == []
    data = port_store.pack_session("a", state)
    assert port_store.unpack_session(data)[0] == "a"
    jsid, jstate = jax_store.unpack_session(data)
    assert jsid == "a" and sorted(jstate) == sorted(state)
    with pytest.raises(integrity.IntegrityError, match="not a readable"):
        port_store.unpack_session(b"garbage")
    assert port_store.peek_session_id(b"garbage") is None
    for bad in ("", "a/b", "x" * 65, "sp ace"):
        assert not port_store.valid_session_id(bad)


def test_corrupt_newest_generation_falls_back(tmp_path, recording):
    with obs_journal.run(tmp_path / "obs", config={}) as jr:
        store = SessionStore(tmp_path / "sessions.npz", keep=2, journal=jr,
                             device="cpu")
        session = _fill(store, recording)
        store.snapshot()
        session.ingest(recording[:, 700:900])
        with inject.scoped(inject.FaultSpec(site="session.snapshot")):
            store.snapshot()
        store.detach()
        store2 = SessionStore(tmp_path / "sessions.npz", journal=jr,
                              device="cpu")
        assert store2.restore() == ["a"]
        assert store2.get("a").acked == 700
        store2.detach()
    events = schema.read_events(jr.events_path)
    kinds = {e["event"] for e in events}
    assert {"session_snapshot", "checkpoint_quarantine", "session_resume",
            "fault_injected"} <= kinds
    assert (tmp_path / "sessions.npz.corrupt").exists()
    jax_schema.validate_events(events)


def test_restore_retries_a_read_fault_and_close_is_durable(tmp_path,
                                                           recording):
    with obs_journal.run(tmp_path / "obs", config={}) as jr:
        store = SessionStore(tmp_path / "sessions.npz", journal=jr,
                             device="cpu")
        _fill(store, recording)
        _fill(store, recording, sid="b")
        store.snapshot()
        store.detach()
        store2 = SessionStore(tmp_path / "sessions.npz", journal=jr,
                              device="cpu")
        with inject.scoped(inject.FaultSpec(site="session.restore")):
            assert store2.restore() == ["a", "b"]
        store2.close("a")
        store2.detach()
        gens = sorted(p.name for p in tmp_path.glob("sessions.npz.gen*"))
        for gen in gens:
            with np.load(tmp_path / gen) as npz:
                assert not any(k.startswith("s/a/") for k in npz.files)
        store3 = SessionStore(tmp_path / "sessions.npz", device="cpu")
        assert store3.restore() == ["b"]
        store3.detach()
    retries = [e for e in schema.read_events(jr.events_path)
               if e["event"] == "retry"]
    assert retries and retries[0]["site"] == "session.restore"
    empty = SessionStore(tmp_path / "none.npz", device="cpu")
    assert empty.restore() == []
    empty.detach()


def test_the_mirror_spool_and_its_fault(tmp_path, recording):
    primary, mirror = tmp_path / "p" / "sessions.npz", \
        tmp_path / "m" / "sessions.npz"
    with obs_journal.run(tmp_path / "obs", config={}) as jr:
        store = SessionStore(primary, mirror=mirror, keep=2, journal=jr,
                             device="cpu")
        session = _fill(store, recording)
        store.snapshot()
        session.ingest(recording[:, 700:900])
        with inject.scoped(inject.FaultSpec(site="spool.mirror")):
            store.snapshot()
        store.detach()
    spooled = port_store.read_spooled_session(mirror, "a")
    assert port_store.unpack_session(spooled)[1]["ems/n_seen"] == 700
    assert port_store.read_spooled_session(primary, "a") is not None
    assert int(port_store.unpack_session(port_store.read_spooled_session(
        primary, "a"))[1]["ems/n_seen"]) == 900
    assert port_store.read_spooled_session(tmp_path / "none", "a") is None


def test_chaos_plans_arm_the_store_sites_as_jax_does():
    plan = "session.snapshot:times=1,session.restore:after=1,spool.mirror"
    port, ref = inject.parse_plan(plan), jax_inject.parse_plan(plan)
    assert [p.site for p in port] == [r.site for r in ref]
    for p, r in zip(port, ref):
        assert (p.after, p.times, p.action) == (r.after, r.times, r.action)
    # session.drift is armed now too (the adaptation slice), with the JAX
    # defaults for its magnitudes.
    (p,), (r,) = (inject.parse_plan("session.drift:times=1"),
                  jax_inject.parse_plan("session.drift:times=1"))
    assert (p.site, p.times, p.action, p.scale, p.offset) == \
        (r.site, r.times, r.action, r.scale, r.offset)
    assert inject._DEFAULTS["session.drift"][0] == "drift" \
        == jax_inject._DEFAULTS["session.drift"][0]


def test_batcher_takes_priority_traffic_under_the_hard_cliff():
    batcher = batcher_lib.MicroBatcher(
        lambda x: np.zeros(len(x), np.int64), max_batch=2, max_wait_ms=1,
        max_queue_trials=2)
    try:
        got = batcher.submit(np.zeros((2, C, T), np.float32), priority=True)
        np.testing.assert_array_equal(got.result(10), [0, 0])
    finally:
        batcher.close()


# --- HTTP ------------------------------------------------------------------

def _post(url, data, ctype="application/json"):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _post_code(url, data, ctype="application/json") -> int:
    try:
        _post(url, data, ctype)
    except urllib.error.HTTPError as exc:
        return exc.code
    return 200


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read().decode())


def _raw(x) -> bytes:
    return np.ascontiguousarray(x).astype("<f4").tobytes()


def _stream_close(url, x, sid="s1", step=130, **open_kw):
    _post(url + "/session/open",
          json.dumps(dict(OPEN, session=sid, **open_kw)).encode())
    for pos in range(0, x.shape[1], step):
        _post(f"{url}/session/{sid}/samples", _raw(x[:, pos:pos + step]),
              "application/octet-stream")
    return _post(f"{url}/session/{sid}/close", b"{}")


def test_http_round_trip_equals_the_jax_service(tmp_path, recording,
                                                checkpoint):
    ckpt, params, bs = checkpoint
    with obs_journal.run(tmp_path / "obs", config={}) as jr:
        app = ServeApp(ckpt, buckets=(1, 8), device="cpu",
                       sessions_dir=tmp_path / "p", journal=jr,
                       session_snapshot_every=16).start()
        try:
            got = _stream_close(app.url, recording)
            health = _get(app.url + "/healthz")
        finally:
            app.stop()
    japp = JaxServeApp(ckpt, buckets=(1, 8),
                       sessions_dir=tmp_path / "j").start()
    try:
        want = _stream_close(japp.url, recording)
    finally:
        japp.stop()
    preds, jpreds = np.asarray(got["preds"]), np.asarray(want["preds"])
    assert len(preds) == len(jpreds) == (N - T) // HOP + 1
    np.testing.assert_array_equal(preds, _offline_preds(ckpt, recording))
    differ = np.flatnonzero(preds != jpreds)
    if len(differ):
        from eegnetreplication_tpu.ops.ems import (
            raw_exponential_moving_standardize,
        )
        std = raw_exponential_moving_standardize(
            recording, init_block_size=BLOCK, method="scan")
        wins = np.stack([std[:, k * HOP:k * HOP + T] for k in differ])
        logits = np.asarray(jax_model(C, T, F1, D).apply(
            {"params": params, "batch_stats": bs}, wins, train=False))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] < 1e-4), (differ, top2)
    assert health["sessions"] == 0
    assert health["kernel_launches"]["ems_stream"] == 0   # the CPU
    events = schema.read_events(jr.events_path)
    summary = jax_schema.event_summary(events)
    assert summary["n_sessions"] == 1
    assert summary["session_windows"] == len(preds)
    end = [e for e in events if e["event"] == "serve_end"][0]
    assert (end["sessions"], end["session_windows"]) == (1, len(preds))
    assert end["session_snapshots"] >= 2


def test_stop_then_resume_continues_the_stream_bitwise(tmp_path, recording,
                                                       checkpoint):
    ckpt = checkpoint[0]
    cut = 530
    with obs_journal.run(tmp_path / "obs1", config={}) as jr1:
        app = ServeApp(ckpt, buckets=(1, 8), device="cpu",
                       sessions_dir=tmp_path / "s", journal=jr1).start()
        try:
            _post(app.url + "/session/open", json.dumps(OPEN).encode())
            first = _post(app.url + "/session/s1/samples",
                          _raw(recording[:, :cut]),
                          "application/octet-stream")
        finally:
            app.stop()
    with obs_journal.run(tmp_path / "obs2", config={}) as jr2:
        app2 = ServeApp(ckpt, buckets=(1, 8), device="cpu",
                        sessions_dir=tmp_path / "s", resume=True,
                        journal=jr2).start()
        try:
            state = _get(app2.url + "/session/s1/state")
            assert state["acked"] == cut and state["seeded"] is True
            reopened = _post(app2.url + "/session/open",
                             json.dumps(OPEN).encode())
            assert reopened["resumed"] is True and reopened["acked"] == cut
            _post(app2.url + "/session/s1/samples",
                  _raw(recording[:, cut:]), "application/octet-stream")
            final = _post(app2.url + "/session/s1/close", b"{}")
        finally:
            app2.stop()
    offline = _offline_preds(ckpt, recording)
    np.testing.assert_array_equal(final["preds"], offline)
    assert [d["pred"] for d in first["decisions"]] == \
        list(offline[:len(first["decisions"])])
    resumes = [e for e in schema.read_events(jr2.events_path)
               if e["event"] == "session_resume"]
    assert len(resumes) == 1 and resumes[0]["acked"] == cut


def test_an_expired_window_degrades_and_the_stream_goes_on(
        tmp_path, recording, checkpoint):
    with obs_journal.run(tmp_path / "obs", config={}) as jr:
        app = ServeApp(checkpoint[0], buckets=(1, 8), device="cpu",
                       sessions_dir=tmp_path / "s", journal=jr).start()
        try:
            _post(app.url + "/session/open", json.dumps(
                dict(OPEN, deadline_ms=0.001)).encode())
            reply = _post(app.url + "/session/s1/samples",
                          _raw(recording[:, :300]),
                          "application/octet-stream")
            assert reply["decisions"] and all(
                d["status"] == "expired" and d["pred"] == -1
                for d in reply["decisions"])
            reply = _post(app.url + "/session/s1/samples",
                          _raw(recording[:, 300:400]),
                          "application/octet-stream")
            assert reply["acked"] == 400
            final = _post(app.url + "/session/s1/close", b"{}")
            assert final["expired"] == final["windows"] > 0
        finally:
            app.stop()
    events = schema.read_events(jr.events_path)
    expired = [e for e in events if e["event"] == "window_expired"]
    assert expired and expired[0]["session"] == "s1"
    assert jax_schema.event_summary(events)["windows_expired"] == len(expired)


def test_http_errors_labels_and_migration(tmp_path, recording, checkpoint):
    ckpt = checkpoint[0]
    source = ServeApp(ckpt, buckets=(1, 8), device="cpu",
                      sessions_dir=tmp_path / "src").start()
    target = ServeApp(ckpt, buckets=(1, 8), device="cpu",
                      sessions_dir=tmp_path / "dst").start()
    try:
        url = source.url
        assert _post_code(url + "/session/open", json.dumps(
            {"session": "no/slash"}).encode()) == 400
        assert _post_code(url + "/session/open", json.dumps(
            {"session": "w", "window": T + 1}).encode()) == 400
        assert _post_code(url + "/session/nope/samples", b"") == 404
        assert _post_code(url + "/session/bogus", b"") == 404
        _post(url + "/session/open", json.dumps(OPEN).encode())
        assert _post_code(url + "/session/s1/samples", b"\x00" * 7,
                          "application/octet-stream") == 400
        reply = _post(url + "/session/s1/samples", json.dumps(
            {"samples": recording[:, :200].tolist()}).encode())
        assert reply["acked"] == 200 and len(reply["decisions"]) > 2
        label = json.dumps({"window": 1, "label": 2}).encode()
        assert _post(url + "/session/s1/label", label)["fresh"] is True
        assert _post(url + "/session/s1/label", label)["fresh"] is False
        assert _post_code(url + "/session/s1/label", json.dumps(
            {"window": 1, "label": 3}).encode()) == 409
        assert _post_code(url + "/session/s1/label", json.dumps(
            {"window": 999, "label": 0}).encode()) == 404
        assert _post_code(url + "/session/s1/label", json.dumps(
            {"window": 0, "label": 9}).encode()) == 400
        with urllib.request.urlopen(url + "/session/s1/export",
                                    timeout=60) as resp:
            data = resp.read()
        assert _post_code(target.url + "/session/import", data[:100],
                          "application/octet-stream") == 400
        imported = _post(target.url + "/session/import", data,
                         "application/octet-stream")
        assert imported["imported"] and imported["acked"] == 200
        assert _post_code(target.url + "/session/import", data,
                          "application/octet-stream") == 409
        _post(url + "/session/s1/discard", b"{}")
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(url + "/session/s1/state")
        assert err.value.code == 404
        _post(target.url + "/session/s1/samples", _raw(recording[:, 200:]),
              "application/octet-stream")
        final = _post(target.url + "/session/s1/close", b"{}")
        assert _post_code(target.url + "/session/s1/close", b"{}") == 404
    finally:
        source.stop()
        target.stop()
    np.testing.assert_array_equal(final["preds"],
                                  _offline_preds(ckpt, recording))
