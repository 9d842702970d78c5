"""All-thread stack dumps of a live process, and a client's diagnosis of a
request that timed out.

Every long-lived process of the port (``serve``, the fleet and cell fronts,
the supervisor) calls :func:`install` first thing in its ``main``.  Then

    kill -USR1 <pid>

writes every thread's Python stack to the process's stderr, and the process
goes on serving.  A client whose request to such a server timed out calls
:func:`diagnose`: it names the kind of timeout, reads the server's TCP
queues from ``/proc/net/tcp``, signals the server and waits for the dump,
probes ``/healthz`` on a new connection, and renders the server's journal
tail and stderr tail (which ends in the dump).

The two kinds of timeout:

- **request not read** (:data:`NOT_READ`): urllib's ``URLError`` wrapping a
  timeout, raised while connecting or sending.  On loopback the kernel
  completes the handshake by itself, so this is a body that filled the
  socket buffers unread: nobody accepted the connection or nobody read it.
- **no reply** (:data:`NO_REPLY`): a bare timeout while waiting for the
  reply or reading it.  The request was sent, but a small body fits in the
  socket buffers: the server-side ``unread`` bytes in the socket view say
  whether the server read it.
"""

from __future__ import annotations

import faulthandler
import http.client
import os
import re
import signal
import sys
import time
import urllib.error
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path

DUMP_SIGNAL = signal.SIGUSR1
NOT_READ = "request not read"
NO_REPLY = "no reply"

# How long diagnose() waits for the dump to land in the stderr file, the
# /healthz probe's timeout, and how much of each tail it renders.
DUMP_WAIT_S = 2.0
HEALTHZ_TIMEOUT_S = 5.0
STDERR_TAIL_LINES = 300
JOURNAL_TAIL_LINES = 20
LINE_CHARS = 400

_TCP_STATES = {1: "ESTABLISHED", 2: "SYN_SENT", 3: "SYN_RECV",
               4: "FIN_WAIT1", 5: "FIN_WAIT2", 6: "TIME_WAIT", 7: "CLOSE",
               8: "CLOSE_WAIT", 9: "LAST_ACK", 10: "LISTEN", 11: "CLOSING"}
_JOURNAL_LINE = re.compile(r"Telemetry run \S+ -> (\S.*)$")


def install() -> None:
    """Dump every thread's stack to stderr on ``SIGUSR1``; the process goes
    on.  Where stderr has no file descriptor (a caller that captured it),
    the dump goes to the process's original stderr."""
    out = sys.stderr
    try:
        out.fileno()
    except (AttributeError, ValueError, OSError):
        out = sys.__stderr__
    faulthandler.register(DUMP_SIGNAL, file=out, all_threads=True,
                          chain=False)


def timeout_kind(exc: BaseException) -> str | None:
    """:data:`NOT_READ`, :data:`NO_REPLY`, or None when ``exc`` raised by a
    urllib request is no timeout."""
    if isinstance(exc, urllib.error.HTTPError):
        return None
    if isinstance(exc, urllib.error.URLError):
        return NOT_READ if isinstance(exc.reason, TimeoutError) else None
    return NO_REPLY if isinstance(exc, TimeoutError) else None


@dataclass
class Diagnosis:
    """What :func:`diagnose` found; :attr:`text` renders all of it."""

    url: str
    kind: str
    error: str
    pid: int | None = None
    exit_code: int | None = None
    sockets: list[str] = field(default_factory=list)
    threads: list[str] = field(default_factory=list)
    healthz: str = "not probed"
    dump: str = ""
    journal_tail: list[str] = field(default_factory=list)
    stderr_tail: list[str] = field(default_factory=list)

    @property
    def summary(self) -> str:
        who = ("no process of ours owns it" if self.pid is None
               else f"pid {self.pid} exited {self.exit_code}"
               if self.exit_code is not None
               else f"pid {self.pid} dumped its threads" if self.dump
               else f"pid {self.pid} wrote no dump")
        return (f"{self.kind} from {self.url} ({self.error}); {who}; "
                f"/healthz on a new connection: {self.healthz}")

    @property
    def text(self) -> str:
        out = [f"=== request timed out: {self.summary}"]
        out += ["--- sockets of the port (/proc/net/tcp):"] + (
            self.sockets or ["(none)"])
        if self.threads:
            out += ["--- threads (tid, name, state):"] + self.threads
        if self.journal_tail:
            out += ["--- journal tail:"] + self.journal_tail
        if self.stderr_tail:
            out += [f"--- stderr tail ({len(self.stderr_tail)} lines):"] \
                + self.stderr_tail
        out.append("=== end of the diagnosis")
        return "\n".join(out)

    def frames(self, limit: int = 6) -> list[str]:
        """Each dumped thread's header and its innermost ``limit`` frames,
        one line a thread: the dump's essential frames."""
        rows, head, calls = [], None, []
        for line in self.dump.splitlines() + [""]:
            if line.startswith(("Thread 0x", "Current thread 0x")) \
                    or not line.strip():
                if head is not None:
                    rows.append(head + ": " + " <- ".join(calls[:limit]))
                head, calls = (line.split(" (")[0], []) if line.strip() \
                    else (None, [])
            elif head is not None and line.strip().startswith("File "):
                m = re.match(r'\s*File "([^"]+)", line (\d+) in (\S+)', line)
                if m:
                    calls.append(f"{Path(m[1]).name}:{m[2]} {m[3]}")
        return rows


def diagnose(url: str, kind: str, exc: BaseException, *,
             pid: int | None = None,
             stderr_path: str | Path | None = None) -> Diagnosis:
    """Diagnose a request to ``url`` that timed out (``kind``, raised as
    ``exc``) against the process ``pid`` that serves it, whose stderr goes
    to ``stderr_path``.  Sends ``pid`` :data:`DUMP_SIGNAL`: only for a
    process that called :func:`install` (the signal's default action
    kills)."""
    parts = urllib.parse.urlsplit(url)
    d = Diagnosis(url=url, kind=kind, error=f"{type(exc).__name__}: {exc}",
                  pid=pid)
    if parts.port is not None:
        d.sockets = tcp_view(parts.port)
    path = Path(stderr_path) if stderr_path is not None else None
    if pid is not None:
        d.exit_code = _exit_code(pid)
        if d.exit_code is None:
            d.threads = _threads(pid)
            offset = _size(path)
            try:
                os.kill(pid, DUMP_SIGNAL)
            except ProcessLookupError:
                pass
            else:
                if path is not None:
                    d.dump = _await_dump(path, offset)
    if parts.hostname is not None and parts.port is not None:
        d.healthz = probe_healthz(parts.hostname, parts.port)
    if path is not None:
        d.stderr_tail = _tail(path, STDERR_TAIL_LINES)
        d.journal_tail = _journal_tail(path)
    return d


def probe_healthz(host: str, port: int,
                  timeout: float = HEALTHZ_TIMEOUT_S) -> str:
    """``GET /healthz`` on a new connection: its status and time, or where
    it stopped."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    t0 = time.perf_counter()
    phase = "connect"
    try:
        conn.connect()
        phase = "send"
        conn.request("GET", "/healthz")
        phase = "reply"
        resp = conn.getresponse()
        resp.read()
        return f"{resp.status} in {(time.perf_counter() - t0) * 1e3:.1f} ms"
    except (OSError, http.client.HTTPException) as exc:
        return (f"{type(exc).__name__} at {phase} after "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        conn.close()


def tcp_view(port: int) -> list[str]:
    """The IPv4 sockets on ``port`` from ``/proc/net/tcp``: the listener's
    accept queue, and each connection's state with its unread (receive
    queue) and unsent (send queue) bytes, server side and client side
    apart.  Empty where ``/proc`` has no such file (a stack may also leave
    out its TIME_WAIT entries: gVisor's does)."""
    try:
        rows = Path("/proc/net/tcp").read_text().splitlines()[1:]
    except OSError:
        return []
    out = []
    for row in rows:
        f = row.split()
        if len(f) < 5:
            continue
        local, remote = _port_of(f[1]), _port_of(f[2])
        if port not in (local, remote):
            continue
        state = _TCP_STATES.get(int(f[3], 16), f[3])
        tx, rx = (int(v, 16) for v in f[4].split(":"))
        if state == "LISTEN":
            out.append(f"listener :{local}: accept queue {rx}")
        elif local == port:
            out.append(f"server :{local} <- :{remote} {state}: unread {rx} "
                       f"B, unsent {tx} B")
        else:
            out.append(f"client :{local} -> :{remote} {state}: unread {rx} "
                       f"B, unsent {tx} B")
    return out


def _port_of(addr: str) -> int:
    return int(addr.rsplit(":", 1)[1], 16)


def _exit_code(pid: int) -> int | None:
    """None while ``pid`` runs; its exit code once it ended (a child of
    ours is not reaped: its ``Popen`` still reads the code)."""
    try:
        res = os.waitid(os.P_PID, pid,
                        os.WEXITED | os.WNOHANG | os.WNOWAIT)
    except ChildProcessError:
        # Not our child: alive while /proc has it.
        return None if Path(f"/proc/{pid}").exists() else -1
    if res is None:
        return None
    return res.si_status if res.si_code == os.CLD_EXITED \
        else -res.si_status


def _threads(pid: int) -> list[str]:
    out = []
    for task in sorted(Path(f"/proc/{pid}/task").glob("*"),
                       key=lambda p: int(p.name) if p.name.isdigit() else 0):
        try:
            name = (task / "comm").read_text().strip()
            stat = (task / "stat").read_text()
        except OSError:
            continue
        state = stat.rsplit(")", 1)[1].split()[0]
        out.append(f"{task.name} {name} {state}")
    return out


def _size(path: Path | None) -> int:
    try:
        return path.stat().st_size if path is not None else 0
    except OSError:
        return 0


def _await_dump(path: Path, offset: int) -> str:
    """The bytes the dump added to ``path`` past ``offset``, once they stop
    growing (at most :data:`DUMP_WAIT_S`)."""
    deadline = time.monotonic() + DUMP_WAIT_S
    last, stable = offset, 0
    while time.monotonic() < deadline:
        time.sleep(0.05)
        size = _size(path)
        stable = stable + 1 if size == last and size > offset else 0
        last = size
        if stable >= 4:
            break
    try:
        with open(path, "rb") as fh:
            fh.seek(offset)
            return fh.read().decode(errors="replace")
    except OSError:
        return ""


def _tail(path: Path, n: int) -> list[str]:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - 256 * 1024))
            lines = fh.read().decode(errors="replace").splitlines()
    except OSError:
        return []
    return [ln[:LINE_CHARS] for ln in lines[-n:]]


def _journal_tail(stderr_path: Path) -> list[str]:
    """The tail of the journal the process names in its stderr (its
    ``Telemetry run <id> -> <dir>`` line)."""
    run_dir = None
    try:
        with open(stderr_path, errors="replace") as fh:
            for line in fh:
                m = _JOURNAL_LINE.search(line.rstrip("\n"))
                if m:
                    run_dir = Path(m[1])
    except OSError:
        return []
    if run_dir is None:
        return []
    return _tail(run_dir / "events.jsonl", JOURNAL_TAIL_LINES)
