"""A spool read that meets a snapshot mid-rotation, on the CPU.

``SessionStore.snapshot`` rotates ``sessions.npz`` to ``sessions.npz.gen1``
and only then renames the new snapshot into place: in between the chain
has no newest file.  A cell front that reads a live (partitioned) cell's
spool in that window must still find the session.

- *Deterministic*: after ``rotate_generations`` leaves only ``.gen1``, the
  port's ``read_spooled_session`` returns the session for a file spool and
  for a directory spool; the JAX package's returns ``None`` (its fault,
  pinned here; the JAX package is the reference and stays as it is).
- The read quarantines nothing: a corrupt newest file is skipped, left in
  place, and the previous generation answers.
- *Stress*: a thread snapshotting in a loop against a reader, for a few
  hundred rounds each: no read returns ``None``.  Each stress case stops
  at its own deadline of 60 s.
"""

import threading
import time

import pytest
from torch_port_cases import session_state

from eegnetreplication_tpu.serve.sessions import store as jax_store
from eegnetreplication_tpu_torch.serve.sessions import store as port_store
from eegnetreplication_tpu_torch.serve.sessions.session import StreamSession
from eegnetreplication_tpu_torch.training.checkpoint import (
    rotate_generations,
)

ROUNDS = 300
DEADLINE_S = 60.0


def _store(path, mirror=None, keep=3):
    store = port_store.SessionStore(path, mirror=mirror, keep=keep,
                                    device="cpu")
    store._sessions["s1"] = StreamSession.from_state(
        "s1", session_state("s1"), device="cpu")
    return store


def _acked(data: bytes) -> int:
    sid, state = port_store.unpack_session(data)
    assert sid == "s1"
    return StreamSession.from_state(sid, state, device="cpu").acked


@pytest.mark.parametrize("form", ["file", "directory"])
def test_a_chain_rotated_to_gen1_still_answers(tmp_path, form):
    path = tmp_path / "spool" / "r0" / "sessions.npz"
    store = _store(path)
    store.snapshot()
    store.detach()
    rotate_generations(path, 3)          # a snapshot between its two renames
    assert not path.exists()
    assert (path.parent / "sessions.npz.gen1").is_file()
    spool = path if form == "file" else tmp_path / "spool"
    data = port_store.read_spooled_session(spool, "s1")
    assert data is not None and _acked(data) == 160
    # The JAX package's reader gives up in this window (ROADMAP, "Faults
    # in the JAX package").
    assert jax_store.read_spooled_session(spool, "s1") is None
    # A session the chain does not hold is still no session.
    assert port_store.read_spooled_session(spool, "ghost") is None


def test_the_read_quarantines_nothing(tmp_path):
    path = tmp_path / "sessions.npz"
    store = _store(path)
    store.snapshot()
    store.snapshot()                     # a valid .gen1 behind the newest
    store.detach()
    torn = path.read_bytes()[:200]
    path.write_bytes(torn)
    data = port_store.read_spooled_session(path, "s1")
    assert data is not None and _acked(data) == 160
    assert path.read_bytes() == torn     # left for the cell that owns it
    assert not list(tmp_path.glob("*.corrupt"))


@pytest.mark.parametrize("form", ["file", "directory", "mirror"])
def test_reads_against_a_snapshot_loop_never_miss(tmp_path, form):
    path = tmp_path / "spool" / "r0" / "sessions.npz"
    mirror = tmp_path / "mirror" / "r0" / "sessions.npz"
    store = _store(path, mirror=mirror if form == "mirror" else None)
    store.snapshot()
    spool = {"file": path, "directory": tmp_path / "spool",
             "mirror": tmp_path / "mirror"}[form]
    stop = threading.Event()
    snapshots = [0]

    def snapshot_loop():
        while not stop.is_set():
            store.snapshot()
            snapshots[0] += 1

    writer = threading.Thread(target=snapshot_loop, daemon=True)
    writer.start()
    misses, reads = 0, 0
    deadline = time.monotonic() + DEADLINE_S
    try:
        while reads < ROUNDS and time.monotonic() < deadline:
            data = port_store.read_spooled_session(spool, "s1")
            reads += 1
            if data is None:
                misses += 1
            else:
                assert _acked(data) == 160
    finally:
        stop.set()
        writer.join(timeout=DEADLINE_S)
        store.detach()
    assert not writer.is_alive()
    assert reads == ROUNDS, f"only {reads} reads within {DEADLINE_S} s"
    assert snapshots[0] > 0
    assert misses == 0, f"{misses} of {reads} reads found no session"
    assert not list(tmp_path.rglob("*.corrupt"))


def test_the_jax_reader_misses_under_the_same_loop(tmp_path):
    """The fault the stress test guards against, shown on the reference:
    reads of a chain pinned between the two renames miss in the JAX
    reader every time."""
    path = tmp_path / "sessions.npz"
    store = _store(path)
    store.snapshot()
    store.detach()
    rotate_generations(path, 3)
    misses = sum(jax_store.read_spooled_session(path, "s1") is None
                 for _ in range(10))
    hits = sum(port_store.read_spooled_session(path, "s1") is not None
               for _ in range(10))
    assert (misses, hits) == (10, 10)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "sessions.npz.gen1"]
