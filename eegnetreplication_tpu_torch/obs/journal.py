"""Run journal: one run's structured JSONL event stream and its metrics.

The port's copy of ``eegnetreplication_tpu/obs/journal.py``.  A training
or serving run opens a journal with :func:`run`: every event of the run
is appended as one JSON object per line to
``<metrics_dir>/<run_id>/events.jsonl`` (``run_start`` with the git sha,
the device and the config; the protocol's ``train_setup``,
``fold_group``, ``epoch``, ``device_fault`` and ``checkpoint_write``, or
the service's ``serve_start``, ``request``, ``quant_gate``,
``stack_gate``, ``zoo_restack``, ``model_load``, ``model_evict``,
``model_swap`` and ``serve_end``; ``run_end`` with the exit status), and
the run's :class:`~eegnetreplication_tpu_torch.obs.metrics.MetricsRegistry`
is flushed to ``metrics.json`` beside it at the end.

The active journal sits in a :mod:`contextvars` variable, so deep callees
reach it through :func:`current`, which outside a run returns an inert
:class:`NullJournal`.  Threads do not inherit the variable: a thread that
journals wraps its work in :func:`bound`.

Telemetry never stops a run: each event is appended and flushed on its
own (a killed run loses at most the line being written), an event that
fails the schema is written with a ``_schema_error`` field and a warning,
and an event that cannot be written is dropped with a warning.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Iterator

from eegnetreplication_tpu_torch.obs import schema
from eegnetreplication_tpu_torch.obs.metrics import (
    MetricsRegistry,
    TensorBoardMirror,
)
from eegnetreplication_tpu_torch.utils.logging import logger


def _git_sha() -> str:
    """Short git sha of the checkout, or "unknown"."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:  # noqa: BLE001 — telemetry must not require git
        return "unknown"


def _device_info() -> dict[str, Any]:
    """Platform, device kind and count as the JAX journal names them: the
    card when CUDA is up and ``EEGTPU_PLATFORM`` does not ask for the CPU,
    else the CPU."""
    try:
        import torch

        from eegnetreplication_tpu_torch.utils.device import PLATFORM_ENV

        on_cpu = os.environ.get(PLATFORM_ENV, "").strip().lower() == "cpu"
        if torch.cuda.is_available() and not on_cpu:
            return {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(0),
                    "n_devices": torch.cuda.device_count()}
        return {"platform": "cpu", "device_kind": "cpu", "n_devices": 1}
    except Exception:  # noqa: BLE001 — a broken runtime must not stop a run
        return {"platform": "unknown", "device_kind": "unknown",
                "n_devices": 0}


def _jsonable(value: Any) -> Any:
    """Best-effort conversion of config-ish values to JSON-serializable."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return _jsonable(dataclasses.asdict(value))
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def new_run_id() -> str:
    """Unique, sortable run id: UTC timestamp + random suffix."""
    return (time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            + "-" + os.urandom(3).hex())


# Size-triggered rotation of events.jsonl (events.jsonl.1 newest ... .N
# oldest); a training run stays far below it.  Rotate bytes <= 0 turns
# rotation off.
DEFAULT_ROTATE_BYTES = 64 * 1024 * 1024
DEFAULT_ROTATE_KEEP = 8


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class RunJournal:
    """One run's event stream and metrics registry (open it through
    :func:`run`)."""

    def __init__(self, metrics_dir: str | Path, run_id: str | None = None,
                 tb_dir: str | Path | None = None,
                 rotate_bytes: int | None = None,
                 rotate_keep: int | None = None):
        self.run_id = run_id or new_run_id()
        self.dir = Path(metrics_dir) / self.run_id
        self.dir.mkdir(parents=True, exist_ok=True)
        self.events_path = self.dir / "events.jsonl"
        self.metrics_path = self.dir / "metrics.json"
        self.metrics = MetricsRegistry()
        self._t0 = time.perf_counter()
        self._ended = False
        self._tb = TensorBoardMirror(tb_dir) if tb_dir else None
        self._rotate_bytes = rotate_bytes if rotate_bytes is not None \
            else _env_int("EEGTPU_JOURNAL_ROTATE_BYTES", DEFAULT_ROTATE_BYTES)
        self._rotate_keep = max(1, rotate_keep if rotate_keep is not None
                                else _env_int("EEGTPU_JOURNAL_ROTATE_KEEP",
                                              DEFAULT_ROTATE_KEEP))
        self._size = 0        # bytes in the live segment
        # The snapshot writer's thread journals too: one lock keeps every
        # line whole, and the append handle stays open between events.
        self._write_lock = threading.Lock()
        self._fh = None

    @property
    def active(self) -> bool:
        return True

    def event(self, event: str, **fields: Any) -> dict:
        """Append one event: stamps ``t`` and ``run_id``, validates, writes
        one line and flushes it."""
        record = {"event": event, "t": round(time.time(), 3),
                  "run_id": self.run_id}
        record.update({k: _jsonable(v) for k, v in fields.items()})
        try:
            schema.validate_event(record)
        except schema.SchemaError as exc:
            logger.warning("Telemetry event failed schema validation "
                           "(emitted anyway): %s", exc)
            record["_schema_error"] = str(exc)[:300]
        try:
            line = json.dumps(record)
        except (TypeError, ValueError) as exc:
            logger.warning("Telemetry event %r not JSON-serializable (%s); "
                           "emitting repr-coerced fields", event, exc)
            line = json.dumps({k: v if isinstance(v, (str, int, float, bool))
                               or v is None else repr(v)
                               for k, v in record.items()})
        try:
            with self._write_lock:
                if self._fh is None or self._fh.closed:
                    self._fh = open(self.events_path, "a")
                    try:
                        self._size = self.events_path.stat().st_size
                    except OSError:
                        self._size = 0
                self._fh.write(line + "\n")
                self._fh.flush()
                self._size += len(line) + 1
                if 0 < self._rotate_bytes <= self._size:
                    self._rotate_locked()
        except OSError as exc:
            # Drop the event, never the run; a fresh open is tried next time.
            with self._write_lock:
                self._close_locked()
            logger.warning("Telemetry event %r dropped (cannot write %s: "
                           "%s)", event, self.events_path, exc)
        return record

    def _close_locked(self) -> None:
        try:
            if self._fh is not None:
                self._fh.close()
        except OSError:
            pass
        self._fh = None

    def _rotate_locked(self) -> None:
        """Seal the live segment as ``events.jsonl.1`` after shifting the
        older ones up (caller holds ``_write_lock``); a failed rotation
        keeps appending to the live file."""
        self._close_locked()
        self._size = 0
        try:
            Path(f"{self.events_path}.{self._rotate_keep}").unlink(
                missing_ok=True)
            for i in range(self._rotate_keep - 1, 0, -1):
                src = Path(f"{self.events_path}.{i}")
                if src.exists():
                    os.replace(src, f"{self.events_path}.{i + 1}")
            os.replace(self.events_path, f"{self.events_path}.1")
        except OSError as exc:
            logger.warning("Journal rotation of %s failed: %s",
                           self.events_path, exc)

    def scalar(self, tag: str, value: float, step: int) -> None:
        """Mirror a scalar to TensorBoard when a writer is active."""
        if self._tb is not None:
            self._tb.scalar(tag, float(value), int(step))

    def run_start(self, config: Any = None, mesh_shape: dict | None = None,
                  **extra: Any) -> None:
        self.event("run_start", schema_version=schema.SCHEMA_VERSION,
                   git_sha=_git_sha(), utc=schema.utc_now(),
                   mesh_shape=mesh_shape, config=_jsonable(config) or {},
                   argv=list(sys.argv), **_device_info(), **extra)

    def run_end(self, status: str = "ok", error: str | None = None,
                **extra: Any) -> None:
        """Close the run once: ``run_end``, then ``metrics.json``."""
        if self._ended:
            return
        self._ended = True
        wall = time.perf_counter() - self._t0
        fields = dict(status=status, wall_s=round(wall, 3), **extra)
        if error:
            fields["error"] = error[:500]
        self.metrics.set("wall_seconds", round(wall, 3))
        self.event("run_end", **fields)
        with self._write_lock:
            self._close_locked()
        try:
            self.flush_metrics()
        except OSError as exc:
            logger.warning("Telemetry metrics flush to %s failed: %s",
                           self.metrics_path, exc)
        if self._tb is not None:
            self._tb.close()

    def flush_metrics(self) -> None:
        self.metrics.flush(self.metrics_path, run_id=self.run_id)

    def sample_device_memory(self) -> None:
        """Gauge ``hbm_bytes_in_use`` (the JAX name) per card from
        ``torch.cuda.memory_allocated``; nothing on a host without CUDA."""
        try:
            import torch

            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    self.metrics.set("hbm_bytes_in_use",
                                     float(torch.cuda.memory_allocated(i)),
                                     device=str(i))
        except Exception:  # noqa: BLE001 — sampling is an add-on
            pass


class NullJournal:
    """The inert journal :func:`current` returns outside a run: the same
    surface, every method a no-op (the registry is real, never flushed)."""

    run_id = "none"
    dir = None
    events_path = None

    def __init__(self):
        self.metrics = MetricsRegistry()

    @property
    def active(self) -> bool:
        return False

    def event(self, event: str, **fields: Any) -> dict:
        return {}

    def scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def run_start(self, *a: Any, **k: Any) -> None:
        pass

    def run_end(self, *a: Any, **k: Any) -> None:
        pass

    def flush_metrics(self) -> None:
        pass

    def sample_device_memory(self) -> None:
        pass


_ACTIVE: contextvars.ContextVar[RunJournal | None] = contextvars.ContextVar(
    "eegtpu_torch_obs_journal", default=None)


def current() -> RunJournal | NullJournal:
    """The active run journal, or an inert one outside a run."""
    return _ACTIVE.get() or NullJournal()


@contextlib.contextmanager
def bound(journal: RunJournal | NullJournal | None) -> Iterator[None]:
    """Make ``journal`` the active journal of this thread for the block
    (``None``: no change).  Threads do not inherit the active journal."""
    if journal is None:
        yield
        return
    token = _ACTIVE.set(journal)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def run(metrics_dir: str | Path, config: Any = None,
        mesh_shape: dict | None = None, tb_dir: str | Path | None = None,
        run_id: str | None = None, **run_start_extra: Any
        ) -> Iterator[RunJournal]:
    """Open a run: journal and metrics under ``metrics_dir/<run_id>``,
    ``run_start`` on entry and ``run_end`` (``ok``, or ``error`` with the
    exception) on exit, the journal active for the block."""
    journal = RunJournal(metrics_dir, run_id=run_id, tb_dir=tb_dir)
    journal.run_start(config=config, mesh_shape=mesh_shape,
                      **run_start_extra)
    logger.info("Telemetry run %s -> %s", journal.run_id, journal.dir)
    token = _ACTIVE.set(journal)
    try:
        yield journal
    except BaseException as exc:
        journal.run_end(status="error",
                        error=f"{type(exc).__name__}: {exc}")
        raise
    finally:
        _ACTIVE.reset(token)
        journal.run_end(status="ok")
