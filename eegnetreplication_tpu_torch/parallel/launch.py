"""Start, watch and end the rank processes of a mesh.

The JAX package has no counterpart: one JAX process sees every device,
and ``shard_map`` runs a program per device inside it.  In the port each
mesh position is a process (``parallel/mesh.py``), so something must start
them; this module is that mechanism, and it adds nothing else.

:func:`launch` runs ``fn(*args)`` in ``world_size`` rank processes and
returns one exit code.  The calling process (the train CLI's own) is the
launcher and runs no rank: every rank, rank 0 included, is its child, so
the launcher stays free to watch them, forward signals and kill them.

- **Start.**  The ranks are forked, after ``import torch`` and before
  anything has touched CUDA, which saves every rank the import (about 8 s
  on the card's machine).  Each rank then selects its device and sets its
  own numerics pins (``utils/device.py``).  A process that has already
  initialized CUDA cannot fork a rank that uses it, so :func:`launch`
  refuses that: start the world from a fresh process (the smoke runs
  ``utils/mesh_drill.py`` and the train CLI as child processes).
- **Rendezvous.**  Through a ``FileStore`` in a fresh temporary directory
  of the launch: no port is picked, so worlds started at once (six test
  workers, two CLI runs) never collide.  Every rank calls
  ``init_process_group("gloo", ...)`` with the mesh's timeout
  (``EEGTPU_MESH_TIMEOUT_S``, default 300 s), so a rank blocked in a
  collective with a dead peer is freed by the timeout.
- **Environment.**  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE`` are set in each rank (one machine: local rank =
  rank).  :func:`rank_info` gives a rank its coordinates and the seconds
  from the launch to its joining the world.
- **Failure.**  A rank that raises exits 1 (its traceback on stderr); a
  rank that exits with any code but 0 or 75, or dies by a signal, makes
  the launcher kill every other rank (SIGKILL) at once and return that
  rank's code (``128 + signal`` for a signal).  A rank whose parent dies
  is killed by the kernel (``PR_SET_PDEATHSIG``), so no rank outlives its
  launcher, and a supervisor that kills the launcher kills the world.
- **Stop.**  SIGTERM and SIGINT to the launcher are forwarded to every
  rank.  The ranks agree on the stop at their next chunk boundary (one
  ``all_reduce`` of the flag, ``training/protocols.py``), the first rank
  writes the snapshot, and every rank exits 75; the launcher then returns
  75.  A rank that exits 75 while others run gives them the mesh timeout
  plus 10 s to follow before they are killed.
"""

from __future__ import annotations

import ctypes
import multiprocessing
import os
import shutil
import signal
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import wait as wait_sentinels
from typing import Callable

import torch

from eegnetreplication_tpu_torch.parallel import mesh as mesh_lib

EX_PREEMPTED = 75
_PR_SET_PDEATHSIG = 1
_POLL_S = 0.2


@dataclass(frozen=True)
class RankInfo:
    """What a rank knows of its world: its rank, the world's size, its
    local rank, the launch's wall-clock time and the seconds from the
    launch to its joining the world (fork or spawn, imports, the
    rendezvous)."""

    rank: int
    world_size: int
    local_rank: int
    t_launch: float
    join_s: float

    def since_launch(self) -> float:
        """Seconds from the launch to now (wall clock)."""
        return time.time() - self.t_launch


_INFO: RankInfo | None = None


def rank_info() -> RankInfo | None:
    """This process's :class:`RankInfo` inside a launched rank, else
    ``None``."""
    return _INFO


def _die_with_parent(parent_pid: int) -> None:
    """Have the kernel SIGKILL this process when its parent exits."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, int(signal.SIGKILL), 0, 0, 0)
    except (OSError, AttributeError):   # not Linux: the parent watch below
        pass
    if os.getppid() != parent_pid:   # the parent died before the prctl
        os._exit(1)


def _rank_entry(fn: Callable, rank: int, world_size: int, store_path: str,
                t_launch: float, parent_pid: int, args: tuple) -> None:
    global _INFO
    _die_with_parent(parent_pid)
    # A forked rank inherits the launcher's forwarding handlers; until the
    # rank installs its own, the default dispositions apply.
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    code = 1
    try:
        mesh_lib.initialize_distributed(f"file://{store_path}", world_size,
                                        rank)
        _INFO = RankInfo(rank, world_size, rank, t_launch,
                         time.time() - t_launch)
        result = fn(*args)
        code = int(result) if isinstance(result, int) else 0
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else (
            0 if exc.code is None else 1)
    except BaseException:  # noqa: BLE001 — a rank's failure is its code
        traceback.print_exc()
        code = 1
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        if code == 0 and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    # Skip the interpreter's teardown: a peer that failed may have left
    # gloo's threads waiting, and they must not hold this exit.
    os._exit(code)


def _exit_code(proc) -> int:
    code = proc.exitcode
    return 128 - code if code is not None and code < 0 else int(code or 0)


def launch(fn: Callable, world_size: int, args: tuple = ()) -> int:
    """Run ``fn(*args)`` in ``world_size`` forked ranks; return the
    world's exit code (see the module docstring).  ``fn`` returns an exit
    code (or ``None`` for 0)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "launch: this process has initialized CUDA, so a forked rank "
            "cannot use the card; start the world from a fresh process")
    ctx = multiprocessing.get_context("fork")
    store_dir = tempfile.mkdtemp(prefix="eegtpu_mesh_")
    store_path = os.path.join(store_dir, "store")
    grace = mesh_lib.collective_timeout_s() + 10.0
    t_launch = time.time()
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(fn, r, world_size, store_path, t_launch,
                               os.getpid(), args))
             for r in range(world_size)]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                try:
                    os.kill(p.pid, signum)
                except ProcessLookupError:
                    pass

    previous = {sig: signal.signal(sig, forward)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        for p in procs:
            p.start()
        return _watch(procs, grace)
    finally:
        for sig, prev in previous.items():
            signal.signal(sig, prev)
        _kill_all(procs)
        shutil.rmtree(store_dir, ignore_errors=True)


def _kill_all(procs) -> None:
    for p in procs:
        if p.pid is not None and p.exitcode is None:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        if p.pid is not None:
            p.join(timeout=10.0)


def _watch(procs, grace: float) -> int:
    """Wait for every rank; on a failure kill the rest.  Returns the
    world's code."""
    stopped_at: float | None = None
    while True:
        live = [p for p in procs if p.exitcode is None]
        codes = [_exit_code(p) for p in procs if p.exitcode is not None]
        failed = [c for c in codes if c not in (0, EX_PREEMPTED)]
        if failed:
            _kill_all(procs)
            return failed[0]
        if not live:
            return EX_PREEMPTED if EX_PREEMPTED in codes else 0
        if EX_PREEMPTED in codes:
            stopped_at = stopped_at or time.monotonic()
            if time.monotonic() - stopped_at > grace:
                _kill_all(procs)
                return 1
        wait_sentinels([p.sentinel for p in live], timeout=_POLL_S)
