"""The serve CLI's online adaptation and its 38 flags against the JAX
server, on the CPU at a small width (C=4, T=64, F1=4, D=2).

- The port's ``serve`` parser has the JAX parser's 38 flags with equal
  defaults, and refuses the same bad ``--adapt`` and ``--probeSlo``
  settings.
- ``GET /adapt/status`` and ``POST /adapt/rollback`` answer 404 without
  ``--adapt``; with it, the status has the JAX shape, a rollback with
  nothing promoted answers 409, and a label pairs with its captured
  window.  Adaptation without a zoo is refused.
- One end-to-end drill through ``utils/adapt_drill.py`` (the serve CLI in
  child processes): the journal's causal order ``fault_injected
  (session.drift)`` < ``adaptation_start`` < ``adaptation_candidate`` <
  ``shadow_eval`` < ``promotion(action=promote)``, one promotion, the
  armed ``adapt.promote`` failing the first attempt with the prior model
  serving, the rollback under 8 clients with no failed request, and the
  probes apart from ``requests_total``.  No accuracy is asserted.
"""

import argparse
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_port_cases import child_env, jax_variables

from eegnetreplication_tpu.serve import service as jax_service
from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.serve import service
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    save_checkpoint,
)
from eegnetreplication_tpu_torch.utils import adapt_drill

C, T, F1, D = 4, 64, 4, 2
META = {"model": "eegnet", "n_channels": C, "n_times": T, "F1": F1, "D": D}


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser ``main`` builds (caught at ``parse_args``)."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return seen["parser"]


def test_serve_has_the_jax_servers_38_flags(monkeypatch):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    port = _parser_of(service.main, monkeypatch)
    ref = _parser_of(jax_service.main, monkeypatch)

    def flags(parser):
        return sorted(o for a in parser._actions for o in a.option_strings
                      if o.startswith("--") and o != "--help")

    assert flags(port) == flags(ref)
    assert len(flags(port)) == 38
    assert vars(port.parse_args([])) == vars(ref.parse_args([]))
    adapt = ["--adapt", "--adaptSteps", "5", "--adaptLr", "0.01",
             "--probeIntervalS", "0.2", "--probeSlo", "availability>0.9"]
    assert vars(port.parse_args(adapt)) == vars(ref.parse_args(adapt))


@pytest.mark.parametrize("argv", [
    ["--adapt", "--adaptSteps", "0"],
    ["--adapt", "--adaptTriggerLabels", "0"],
    ["--adapt", "--adaptSampleEvery", "0"],
    ["--adapt", "--adaptAccuracyFloor", "1.5"],
    ["--adapt", "--adaptMinShadow", "0"],
    ["--probeSlo", "latency<5"],
])
def test_bad_adaptation_settings_stop_the_cli_as_jax(argv, monkeypatch,
                                                      capsys, tmp_path):
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    argv = ["--checkpoint", str(tmp_path / "x.npz"), *argv]
    errors = []
    for main in (service.main, jax_service.main):
        with pytest.raises(SystemExit) as exit_:
            main(argv)
        assert exit_.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ", 1)[1] == \
        errors[1].split("error: ", 1)[1]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    for name, seed in (("a", 21), ("b", 22)):
        params, bs = jax_variables(C, T, F1, D, seed=seed)
        out[name] = str(save_checkpoint(root / f"{name}.npz",
                                        from_jax_variables(params, bs),
                                        metadata=dict(META)))
    return out


def _request(url, data=None):
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"},
        method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def test_adaptation_needs_a_zoo(checkpoints, tmp_path):
    with pytest.raises(ValueError, match="online adaptation requires zoo "
                                         "serving"):
        service.ServeApp(checkpoints["a"], device="cpu", adapt=True,
                         sessions_dir=tmp_path)


def test_adapt_routes_answer_404_without_adapt(checkpoints, tmp_path):
    with obs_journal.run(tmp_path / "obs", config={}) as journal:
        app = service.ServeApp(checkpoints["a"], port=0, device="cpu",
                               buckets=(1, 8), journal=journal).start()
        try:
            assert _request(app.url + "/adapt/status")[0] == 404
            assert _request(app.url + "/adapt/rollback", b"{}")[0] == 404
        finally:
            app.stop()


def test_adapt_routes_and_label_pairing(checkpoints, tmp_path):
    with obs_journal.run(tmp_path / "obs", config={}) as journal:
        app = service.ServeApp(zoo=dict(checkpoints), port=0, device="cpu",
                               buckets=(1, 8), journal=journal,
                               sessions_dir=tmp_path / "sessions",
                               adapt=True).start()
        try:
            status, body = _request(app.url + "/adapt/status")
            assert status == 200
            assert set(body) == {"trigger_labels", "gate", "models"}
            assert body["trigger_labels"] == 16 and body["models"] == {}
            assert body["gate"] == {"min_samples": 12, "min_labeled": 8,
                                    "accuracy_floor": 0.55,
                                    "agreement_floor": 0.0}
            assert app.adapt.adapt_dir == tmp_path / "sessions" / "adapt"
            status, body = _request(app.url + "/adapt/rollback", b"{}")
            assert status == 409 and "no promotion" in body["error"]
            assert _request(app.url + "/adapt/rollback", json.dumps(
                {"model": "nobody"}).encode())[0] == 404
            assert _request(app.url + "/adapt/rollback", b"[1]")[0] == 400
            status, _ = _request(app.url + "/session/open", json.dumps(
                {"session": "s", "hop": T, "ems_init_block_size": T}
            ).encode())
            assert status == 200
            x = np.random.RandomState(1).randn(C, 2 * T).astype("<f4")
            req = urllib.request.Request(
                app.url + "/session/s/samples", data=x.tobytes(),
                headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                decided = json.loads(resp.read().decode())["decisions"]
            assert [d["status"] for d in decided] == ["ok", "ok"]
            status, body = _request(app.url + "/session/s/label",
                                    json.dumps({"window": 1, "label": 2}
                                               ).encode())
            assert status == 200 and body["paired"] is True
            status, body = _request(app.url + "/adapt/status")
            assert body["models"]["a"]["buffer"] == {
                "captured": 2, "labeled": 1, "paired": 1,
                "unpaired_labels": 0}
            assert body["models"]["a"]["state"] == "idle"
        finally:
            app.stop()


def test_the_drill_end_to_end_on_the_cpu(tmp_path):
    env = child_env(EEGTPU_PLATFORM="cpu")
    record = adapt_drill.run_drill(
        tmp_path, env, n_channels=C, window=T, F1=F1, D=D, n_tenants=3,
        baseline_steps=150, clean_windows=8, baseline_drift_windows=12,
        post_windows=8, trigger_labels=8, adapt_steps=60, min_shadow=6,
        min_labeled=4, probe_interval_s=0.1, device="cpu")
    assert record["baseline_rc"] == record["adapt_rc"] == 75
    events = record["events"]
    assert record["order"]["ordered"], record["order"]
    # The gate may refuse a candidate first (a later fine-tune then gets
    # its turn); adapt.promote (times=1) fails the first promotion inside
    # the swap, the retry promotes, the rollback restores.
    decisions = [e for e in events if e["event"] == "promotion"]
    assert {e["stage"] for e in decisions if e["action"] == "refused"} \
        <= {"gate"}
    promotions = [e for e in decisions if e["action"] != "refused"]
    actions = [(e["action"], e.get("stage")) for e in promotions]
    assert actions == [("error", "reload"), ("promote", None),
                       ("rollback", None)], actions
    i_err = events.index(promotions[0])
    i_ok = events.index(promotions[1])
    # The failed attempt swapped nothing: the only swap before the
    # promotion is the retry's own, from the prior digest.
    (swap,) = [e for e in events[i_err:i_ok] if e["event"] == "model_swap"]
    assert swap["previous_digest"] == record["prior_digest"]
    assert swap["digest"] == promotions[1]["digest"]
    assert promotions[1]["previous_digest"] == record["prior_digest"]
    assert promotions[2]["digest"] == record["prior_digest"]
    assert record["counts_loop"]["digest"] == promotions[1]["digest"]
    assert record["counts_end"]["digest"] == record["prior_digest"]
    faults = {e["site"] for e in events if e["event"] == "fault_injected"}
    assert faults == {"session.drift", "adapt.promote"}
    rollback = record["rollback"]
    assert rollback["status"] == 200 and rollback["failed"] == 0
    assert rollback["requests"] == 160
    recovery = record["recovery"]
    assert recovery["failed"] == 0 and recovery["labels_posted"] >= 8
    assert recovery["windows_decided"] == recovery["pushes"]
    # Probes: ok, journaled, and outside requests_total.
    # Each probe posts one fixed trial and pins the first answer: it is ok
    # while the pinned model serves, and may read "mismatch" (the
    # prober's wrong-answer signal; nothing re-pins it) only while the
    # promoted weights serve.
    # (A probe journals when its answer lands: allow a second of slack
    # around the two swaps.)
    probes = [e for e in events if e["event"] == "probe"]
    t_promoted, t_rolled = swap["t"] - 1.0, promotions[2]["t"] + 1.0
    assert probes and all(e["status"] == "ok" for e in probes
                          if not t_promoted <= e["t"] <= t_rolled)
    assert {e["status"] for e in probes} <= {"ok", "mismatch"}
    counters = record["metrics"]["counters"]
    n_user = len(record["predict_records"]) + rollback["requests"]
    assert sum(e["value"] for e in counters["requests_total"]) == n_user
    # (/metrics and /healthz were read while the prober still ran.)
    assert 0 < sum(e["value"] for e in counters["probe_requests_total"]) \
        <= record["healthz"]["probes"] <= len(probes)
    end = [e for e in events if e["event"] == "serve_end"][-1]
    assert end["n_requests"] == n_user and end["probes"] == len(probes)
    # The candidate's file was moved to its stable name before the swap.
    promoted = promotions[1]["checkpoint"]
    assert ".promoted." in promoted
