"""A connection from a reused client port to an HTTP server: does it reach
the server, or does a TIME_WAIT of the earlier connection hold it off?

    python -m eegnetreplication_tpu_torch.utils.tcp_reuse_probe \\
        [--timeoutS 10] [--reps 3] [--out F]

A client connects from port Q to an HTTP server on port P, POSTs an npz
body of 1 or 128 trials (22 x 257, as ``chip_smoke.py`` sends them) with
``Connection: close``, as urllib does, reads the reply and closes.  Then it
connects at once from the same port Q again (``SO_REUSEADDR``) and times
that connect.  The side that closed the first connection first holds
(P, Q) in TIME_WAIT.  Two servers in this process, each one
``ThreadingHTTPServer``:

- ``stock``: ``http.server``'s close (the server sends its FIN first);
- ``port``: the port's ``JsonRequestHandler``, which waits for the client
  to close first (``serve/service.py``).

One JSON line a case (the second connect's ms, or what stopped it, and the
TIME_WAIT entries ``/proc/net/tcp`` lists for (P, Q) before it); the last
line: the kernel's name and release, the ephemeral port range, and by
server and size the second connects that timed out and those the client's
own stack refused at once (its TIME_WAIT holds that 4-tuple: a client
that picks its port never draws it).
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import platform
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.serve.service import JsonRequestHandler

SIZES = (1, 128)


class _Echo(JsonRequestHandler):
    def do_POST(self):  # noqa: N802 — stdlib naming
        self._reply(200, {"bytes": len(self._read_body())})


class _StockEcho(_Echo):
    # http.server's own connection handling: the server closes first.
    handle = BaseHTTPRequestHandler.handle


def _body(n: int) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=np.random.RandomState(n).randn(n, 22, 257)
             .astype(np.float32))
    return buf.getvalue()


def _post(port: int, body: bytes, src_port: int, timeout: float) -> dict:
    """One ``Connection: close`` POST from ``src_port`` (0: any): the
    connect's ms and the reply's status, or where it stopped."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    out: dict = {}
    try:
        sock.bind(("127.0.0.1", src_port))
        out["src_port"] = sock.getsockname()[1]
        sock.settimeout(timeout)
        t0 = time.perf_counter()
        try:
            sock.connect(("127.0.0.1", port))
        except OSError as exc:
            out["connect"] = (f"{type(exc).__name__} ({exc}) after "
                              f"{time.perf_counter() - t0:.1f} s")
            out["timed_out"] = isinstance(exc, TimeoutError)
            return out
        out["connect_ms"] = (time.perf_counter() - t0) * 1e3
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        conn.sock = sock
        conn.request("POST", "/", body, {
            "Connection": "close",
            "Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        resp.read()
        out["status"] = resp.status
        conn.close()
    except OSError as exc:
        out["error"] = f"{type(exc).__name__}: {exc}"
    finally:
        sock.close()
    return out


def _time_wait(p: int, q: int) -> list[str]:
    """The TIME_WAIT entries of (P, Q) in ``/proc/net/tcp``, by side."""
    try:
        rows = Path("/proc/net/tcp").read_text().splitlines()[1:]
    except OSError:
        return ["no /proc/net/tcp"]
    sides = []
    for row in rows:
        f = row.split()
        local, remote = (int(a.rsplit(":", 1)[1], 16) for a in f[1:3])
        if f[3] == "06" and {local, remote} == {p, q}:
            sides.append("server" if local == p else "client")
    return sides


def _case(handler, n: int, body: bytes, timeout: float) -> dict:
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        first = _post(port, body, 0, timeout)
        time.sleep(0.05)
        tw = _time_wait(port, first.get("src_port", -1))
        second = _post(port, body, first.get("src_port", 0), timeout)
    finally:
        httpd.shutdown()
        httpd.server_close()
    return {"trials": n, "first": first, "time_wait": tw, "second": second}


def _ephemeral_range() -> str:
    try:
        return "-".join(Path("/proc/sys/net/ipv4/ip_local_port_range")
                        .read_text().split())
    except OSError:
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--timeoutS", type=float, default=10.0)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    bodies = {n: _body(n) for n in SIZES}
    rows = []
    for rep in range(args.reps):
        for name, handler in (("stock", _StockEcho), ("port", _Echo)):
            for n in SIZES:
                row = {"server": name, "rep": rep,
                       **_case(handler, n, bodies[n], args.timeoutS)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    uname = platform.uname()
    summary = {
        "kernel": f"{uname.system} {uname.release} {uname.version}",
        "ephemeral_ports": _ephemeral_range(), "timeout_s": args.timeoutS,
        "reps": args.reps,
        **{key: {
            f"{name}/{n}": sum(
                test(r["second"]) for r in rows
                if r["server"] == name and r["trials"] == n)
            for name in ("stock", "port") for n in SIZES}
           for key, test in (
               ("second_connect_timed_out",
                lambda got: got.get("timed_out", False)),
               ("second_connect_refused_at_once",
                lambda got: "connect" in got and not got["timed_out"]))},
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({**summary, "rows": rows},
                                             indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
