"""Run snapshots written beside the training loop.

The counterpart of ``eegnetreplication_tpu/training/async_ckpt.py``.
:class:`SnapshotWriter` takes a chunk boundary's carry
(``FoldTrainer.carry``) and persists it through
:func:`~eegnetreplication_tpu_torch.training.checkpoint.save_run_snapshot`
(digest, rotation, atomic rename) on a thread of its own, so the write
overlaps the next chunk.  At most one write is in flight: a ``submit``
while the previous write still runs waits for it first, so snapshots land
in order.

The carry lives on the card, and the caching allocator may hand its memory
to the next chunk's kernels as soon as the loop drops it.  So ``submit``
copies every CUDA tensor into pinned host memory *on the current stream*
(the stream the trainer runs on: the copy is ordered before any later
kernel that could reuse the memory) and records an event there; the
thread waits on that event before it reads the host copy.  CPU tensors
are cloned.  The thread never touches a device tensor.

- A failed write raises :class:`SnapshotWriteError` at the next ``submit``
  or ``close``.
- ``close`` runs on every exit path of the chunk loop; on an exception
  path it commits the pending write without masking the exception.
- While an asynchronous writer is open it is a
  :func:`~eegnetreplication_tpu_torch.resil.preempt.add_drain_hook`, so a
  stop that unwinds past the protocol still commits the pending write.
- ``async_=False`` writes inline (the synchronous arm).

Each write leaves a record in :attr:`SnapshotWriter.records`:
``stage_s`` (the host copy's enqueue in ``submit``), ``write_s`` (the
thread's wait for the copy, serialisation and rename), ``blocked_s`` (the
time the loop then waited for the write: at the next ``submit``, or the
whole write when synchronous) and ``drain`` (waited for at ``close``, the
run's end, not a stall of the loop).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Mapping

import torch

from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.utils.logging import logger


class SnapshotWriteError(RuntimeError):
    """A snapshot write failed; the resume seed did not land."""


def _stage(carry: Mapping[str, torch.Tensor]
           ) -> tuple[dict[str, torch.Tensor], torch.cuda.Event | None]:
    """Host copies of ``carry`` and the event that marks the device-to-host
    copies done (None when nothing was on a card)."""
    host, event = {}, None
    for name, t in carry.items():
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host[name] = buf
            if event is None:
                event = torch.cuda.Event()
            stream = torch.cuda.current_stream(t.device)
        else:
            host[name] = t.detach().clone()
    if event is not None:
        event.record(stream)
    return host, event


class SnapshotWriter:
    """Ordered, at-most-one-in-flight run-snapshot writer for one path."""

    def __init__(self, path: str | Path, signature: dict, *,
                 async_: bool = True, keep: int | None = None):
        self.path = Path(path)
        self.signature = signature
        self.async_ = async_
        self.keep = keep
        self.records: list[dict] = []
        self._thread: threading.Thread | None = None
        self._pending: dict | None = None
        self._error: BaseException | None = None
        self._closed = False
        if async_:
            preempt.add_drain_hook(self._drain)

    def _write(self, host: dict, event, epochs_done: int, rec: dict) -> None:
        t0 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            ckpt_lib.save_run_snapshot(
                self.path, {k: v.numpy() for k, v in host.items()},
                epochs_done, self.signature, keep=self.keep)
        except BaseException as exc:  # noqa: BLE001 — surfaced on submit/close
            self._error = exc
            rec["ok"] = False
        finally:
            rec["write_s"] = time.perf_counter() - t0

    def _join(self, *, drain: bool) -> None:
        """Wait for the write in flight and close its record."""
        if self._thread is None:
            return
        t0 = time.perf_counter()
        self._thread.join()
        self._thread = None
        rec, self._pending = self._pending, None
        rec.update(blocked_s=time.perf_counter() - t0, drain=drain)

    def _raise_error(self) -> None:
        if self._error is not None:
            error, self._error = self._error, None
            raise SnapshotWriteError(
                f"snapshot write to {self.path} failed: "
                f"{type(error).__name__}: {error}") from error

    def submit(self, carry: Mapping[str, torch.Tensor],
               epochs_done: int) -> None:
        """Persist one chunk boundary's carry: returns once it is staged
        (asynchronous) or written (synchronous)."""
        if self._closed:
            raise SnapshotWriteError(f"writer for {self.path} is closed")
        self._join(drain=False)
        self._raise_error()
        t0 = time.perf_counter()
        host, event = _stage(carry)
        rec = {"epochs_done": epochs_done, "ok": True,
               "stage_s": time.perf_counter() - t0, "write_s": 0.0,
               "blocked_s": 0.0, "drain": False}
        self.records.append(rec)
        if not self.async_:
            self._write(host, event, epochs_done, rec)
            rec["blocked_s"] = rec["write_s"]
            self._raise_error()
            return
        self._pending = rec
        self._thread = threading.Thread(
            target=self._write, args=(host, event, epochs_done, rec),
            name="eegtpu-torch-snapshot-writer", daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        """Preemption drain hook: commit the pending write, never raise."""
        try:
            self.close(raise_errors=False)
        except Exception as exc:  # noqa: BLE001 — drain must complete
            logger.warning("Snapshot writer drain failed: %s", exc)

    def close(self, *, raise_errors: bool = True) -> None:
        """Wait for the write in flight and release the writer.
        ``raise_errors=False`` (exception paths) logs a failed write
        instead of raising it."""
        self._join(drain=True)
        if not self._closed:
            self._closed = True
            if self.async_:
                preempt.remove_drain_hook(self._drain)
        if self._error is not None and not raise_errors:
            logger.warning("Snapshot write to %s failed during shutdown: %s",
                           self.path, self._error)
            self._error = None
        self._raise_error()
