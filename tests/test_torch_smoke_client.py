"""``chip_smoke.py``'s streaming client against a lost reply, on the CPU.

Phase 19e kills the active cell front while a session streams through
it.  A push in flight then may have been ingested by its cell while its
reply never reached the client: the client's resync reads an acked
cursor past where it stood, and the windows that push decided were
delivered to nobody.  The client takes them from the state's
``decisions_tail`` (the session's record of what it decided), so its
decision stream still equals the offline pipeline, window for window.

Here one ``serve`` process of the port runs on the CPU and the reply of
one push is dropped after the server answered it; the client's stream,
and the close's, must equal the offline pipeline's, with no window
missing.  The same client without the tail (the stream a resync that
reads only the cursor leaves) misses exactly that push's window, which
shows the drop does what phase 19e's kill does.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_cases import child_env

REPO = Path(__file__).resolve().parents[1]
LOST_WINDOW = 20       # the push that decides this window loses its reply
STREAM_S = 20


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_client",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def served(smoke, tmp_path_factory):
    """One CPU ``serve`` process over a seeded checkpoint, and its
    engine in process for the offline pipeline."""
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine

    work = tmp_path_factory.mktemp("smoke_client")
    ckpt = smoke._save_seeded(torch, work / "model.npz", seed=1811)
    env = child_env(EEGTPU_PLATFORM="cpu")
    proc, url, stderr = smoke._start_server(["--checkpoint", str(ckpt)],
                                            work, env)
    try:
        yield url, InferenceEngine.from_checkpoint(ckpt, (1, 8, 32, 128),
                                                   device="cpu")
    finally:
        proc.terminate()
        proc.wait(60)
        stderr.close()


def _stream_with_a_lost_reply(smoke, url, sid, monkeypatch, tail: bool):
    """Stream one session unpaced through ``url``, dropping the reply of
    the push that decides :data:`LOST_WINDOW`; the client."""
    x = smoke.stream_recording(np, 1903, n=STREAM_S * smoke.STREAM_HZ)
    client = smoke._CellSession(np, [url], sid, x)
    status, opened = smoke._reply(url + "/session/open", "POST",
                                  client.open_body)
    assert status == 200 and opened["acked"] == 0, opened
    client._follow_leader = lambda deadline: None   # one server, no pair
    client.high = x.shape[1]                        # replay speed
    if not tail:
        def resync_cursor_only(deadline):
            status, state = smoke._reply(f"{url}/session/{sid}/state")
            assert status == 200, state
            return int(state["acked"])
        client._resync = resync_cursor_only
    reply, lost = smoke._reply, []

    def lossy(target, method="GET", body=None, *args, **kwargs):
        out = reply(target, method, body, *args, **kwargs)
        if (not lost and target.endswith("/samples") and out[0] == 200
                and LOST_WINDOW in [d["window"]
                                    for d in out[1]["decisions"]]):
            lost.append(out[1]["acked"])
            raise OSError("the front died before relaying the reply")
        return out

    monkeypatch.setattr(smoke, "_reply", lossy)
    client.run()
    monkeypatch.setattr(smoke, "_reply", reply)
    assert lost, f"no push decided window {LOST_WINDOW}"
    return client


def test_a_lost_reply_is_recovered_from_the_state_tail(smoke, served,
                                                       monkeypatch):
    url, engine = served
    client = _stream_with_a_lost_reply(smoke, url, "lost-tail",
                                       monkeypatch, tail=True)
    row = client.close(torch, engine, "cpu")
    assert client.codes.get("transport") == 1
    assert client.codes.get("resync_ahead") == 1
    assert row["windows"] == smoke.n_windows(client.pos)
    assert row["expired"] == 0


def test_without_the_tail_the_lost_window_goes_missing(smoke, served,
                                                       monkeypatch):
    url, engine = served
    client = _stream_with_a_lost_reply(smoke, url, "lost-cursor",
                                       monkeypatch, tail=False)
    with pytest.raises(smoke.SmokeFailure,
                       match=rf"never delivered \[{LOST_WINDOW}\]"):
        client.close(torch, engine, "cpu")
