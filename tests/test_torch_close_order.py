"""The port's HTTP servers let their clients close first (C.8), on the CPU.

A `serve` process that stopped answering the smoke for 60 s was idle and
healthy: one connection's SYN went unanswered while others were served.
The side that closes a TCP connection first holds its 4-tuple in
TIME_WAIT for a minute.  The stock `http.server` closes first, so the
server held (server port, client port); a later connection that drew
the same client port met that TIME_WAIT, and a user-space network
stack (gVisor's netstack) drops such a SYN when its sequence number lies
below the old connection's end (a 2.9 MB body moves it) and ignores the
client's RST there, until the minute is out.
`JsonRequestHandler.handle` now waits for the client's FIN before it
closes: the TIME_WAIT lands on the client, whose stack then never hands
that port out for this server again.

Linux itself takes such a SYN, so the stall does not show here.  What
shows on any kernel is the side that holds the TIME_WAIT, in
`/proc/net/tcp`: here every connection of a `Connection: close` client
ends with the TIME_WAIT on the client's side and none on the server's.
"""

import http.client
import io
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
from torch_port_cases import child_env

from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.serve import service
from eegnetreplication_tpu_torch.training.checkpoint import save_checkpoint

REPO = Path(__file__).resolve().parents[1]
TIME_WAIT = "06"


def _time_wait_pairs(port: int) -> set:
    """(local port, remote port) of the TIME_WAIT entries on ``port`` in
    ``/proc/net/tcp``."""
    pairs = set()
    for row in Path("/proc/net/tcp").read_text().splitlines()[1:]:
        f = row.split()
        local, remote = (int(a.rsplit(":", 1)[1], 16) for a in f[1:3])
        if f[3] == TIME_WAIT and port in (local, remote):
            pairs.add((local, remote))
    return pairs


def _new_time_waits(port: int, url: str) -> dict:
    """The TIME_WAIT entries the requests of :data:`SIZES` to ``url``
    leave on ``port``, by side (entries there before are left out)."""
    before = _time_wait_pairs(port)
    _urllib_posts(url, SIZES)
    time.sleep(0.2)
    new = _time_wait_pairs(port) - before
    return {"server": sum(local == port for local, _ in new),
            "client": sum(local != port for local, _ in new)}


def _npz(n: int) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=np.zeros((n, 22, 257), np.float32))
    return buf.getvalue()


def _urllib_posts(url: str, sizes) -> None:
    for n in sizes:
        req = urllib.request.Request(url, data=_npz(n), method="POST",
                                     headers={"Content-Type":
                                              "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
            resp.read()


class _Echo(service.JsonRequestHandler):
    def do_POST(self):  # noqa: N802 — stdlib naming
        self._reply(200, {"bytes": len(self._read_body())})


@pytest.fixture
def echo():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(10)


SIZES = [1] * 10 + [128] * 2


def test_connection_close_clients_hold_the_time_wait(echo):
    waits = _new_time_waits(echo, f"http://127.0.0.1:{echo}/")
    assert waits["server"] == 0, waits
    assert waits["client"] == len(SIZES), waits


def test_the_serve_cli_lets_its_clients_close_first(tmp_path):
    ckpt = save_checkpoint(tmp_path / "model.npz",
                           EEGNet(22, 257, device="cpu").state_dict(),
                           metadata={"model": "eegnet", "n_channels": 22,
                                     "n_times": 257, "F1": 8, "D": 2})
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
         "--checkpoint", str(ckpt), "--buckets", "1,8", "--port", "0",
         "--metricsDir", str(tmp_path / "obs")],
        cwd=REPO, env=child_env(EEGTPU_PLATFORM="cpu",
                                EEGTPU_NO_LOG_FILE="1"),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving at http://"), line
        url = line.split("serving at ", 1)[1].strip()
        waits = _new_time_waits(int(url.rsplit(":", 1)[1]),
                                url + "/predict")
        assert waits["server"] == 0, waits
        assert waits["client"] == len(SIZES), waits
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def test_a_client_that_never_closes_is_closed_after_the_wait(echo):
    """The wait is bounded: a client that asked ``Connection: close`` and
    keeps its socket open gets the server's FIN after
    ``CLIENT_CLOSE_WAIT_S``; a kept-alive client is served on."""
    with socket.create_connection(("127.0.0.1", echo), timeout=30) as sock:
        conn = http.client.HTTPConnection("127.0.0.1", echo, timeout=30)
        conn.sock = sock
        conn.request("POST", "/", b"x" * 10, {"Connection": "close"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read() == b'{"bytes": 10}'
        t0 = time.perf_counter()
        assert sock.recv(1) == b""
        waited = time.perf_counter() - t0
    assert service.CLIENT_CLOSE_WAIT_S - 0.5 < waited \
        < service.CLIENT_CLOSE_WAIT_S + 5
    kept = http.client.HTTPConnection("127.0.0.1", echo, timeout=30)
    for _ in range(3):
        kept.request("POST", "/", b"abc")
        assert kept.getresponse().read() == b'{"bytes": 3}'
    kept.close()
