"""One streaming session's state: EMS carry, window slider, decisions.

The port's copy of ``eegnetreplication_tpu/serve/sessions/session.py``.
A session turns an unbounded 22-channel sample stream into a decision
stream: samples push through the chunk-resumable
:class:`~eegnetreplication_tpu_torch.ops.ems.StreamingEMS` carrier (its
carry on the serving device, each push one K2s launch there), the
standardized signal slides a ``window``-sample view forward by ``hop``
samples per decision (window ``k`` covers absolute samples
``[k*hop, k*hop + window)``), and each complete window becomes one model
input.  Everything here is deterministic and chunking-invariant: feeding
the same recording in different chunk sizes — or re-feeding a resent
suffix after a crash — produces byte-identical windows, which is what
makes the mid-stream resume contract exact rather than approximate.

The session itself does no inference; :meth:`ingest` returns the windows
that became complete and the serving layer routes them through the shared
engine/batcher, then appends one :class:`WindowDecision` per window via
:meth:`record` (in window order).  The snapshot state
(:meth:`state_arrays`) captures the carrier, the *undecided* tail of the
standardized buffer, and the decision record: a restored session's window
cursor rolls back to the last **decided** window, so windows that were
in flight (produced but never answered) when the process died are
re-extracted from the buffered standardized samples — no decision is ever
silently lost to a crash.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops.ems import StreamingEMS

# Decision status codes (int8 in the snapshot record).
STATUS_OK = "ok"
STATUS_EXPIRED = "expired"
STATUS_ERROR = "error"
_STATUS_CODES = {STATUS_OK: 0, STATUS_EXPIRED: 1, STATUS_ERROR: 2}
_CODE_STATUS = {v: k for k, v in _STATUS_CODES.items()}


class LabelConflict(ValueError):
    """A label that contradicts session state: the window expired/errored
    (there is no prediction to pair the label with), or a duplicate label
    disagrees with the one already recorded.  The HTTP layer maps this to
    409 — a client error, never a 500."""


@dataclass
class WindowDecision:
    """The outcome of one window: the class prediction (``-1`` when the
    window expired past its deadline or errored — graceful degradation,
    the stream continues), plus latency accounting."""

    index: int          # window number (start = index * hop)
    start: int          # absolute sample index of the window's first sample
    pred: int           # argmax class, or -1 for expired/error
    status: str         # "ok" | "expired" | "error"
    latency_ms: float

    def as_json(self) -> dict:
        return {"window": self.index, "start": self.start,
                "pred": int(self.pred), "status": self.status,
                "latency_ms": round(float(self.latency_ms), 3)}


# How many decided windows a session retains (memory AND snapshot).  A
# live stream is unbounded; an unbounded decision record would make every
# periodic snapshot re-serialize the whole history (O(age) per snapshot,
# O(age^2) total bytes).  The cursoring is exact regardless — only the
# tail of the RECORD is kept; at hop 64 / 250 Hz this default is ~4.5
# hours of decisions.
DEFAULT_DECISION_HISTORY = 65536


class StreamSession:
    """Streaming state for one client stream (see module docstring).

    ``lock`` serializes a session's mutations; the HTTP layer holds it
    across one ingest-infer-record cycle, the store holds it while
    snapshotting.
    """

    def __init__(self, session_id: str, *, n_channels: int, window: int,
                 hop: int, deadline_ms: float | None = None,
                 ems_factor_new: float = 1e-3,
                 ems_init_block_size: int = 1000, ems_eps: float = 1e-10,
                 decision_history: int = DEFAULT_DECISION_HISTORY,
                 device: torch.device | str | None = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if hop < 1:
            raise ValueError(f"hop must be >= 1, got {hop}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        self.session_id = str(session_id)
        self.n_channels = int(n_channels)
        self.window = int(window)
        self.hop = int(hop)
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.ems = StreamingEMS(n_channels, factor_new=ems_factor_new,
                                init_block_size=ems_init_block_size,
                                eps=ems_eps, device=device)
        self.lock = threading.Lock()
        # Standardized samples not yet consumed by a DECIDED window:
        # buf covers absolute samples [buf_start, buf_start + buf.shape[1]).
        self._buf = np.zeros((self.n_channels, 0), np.float32)
        self._buf_start = 0
        # Window cursors: produced = handed out by take_ready_windows,
        # decided = record()ed.  produced >= decided; the gap is in-flight.
        self.windows_produced = 0
        # Explicit counters (not derived from the record): the record
        # itself is a bounded tail so long streams don't grow without
        # limit — see DEFAULT_DECISION_HISTORY.
        self.windows_decided = 0
        self.n_expired = 0
        self.decision_history = max(1, int(decision_history))
        self._decisions: list[WindowDecision] = []
        # Cue-schedule labels (BCI trials know the true class per cue):
        # window index -> label, fed by POST /session/<id>/label.  Part of
        # the durable snapshot state (state_arrays), so labels survive
        # snapshot/resume and export/import migration.
        self._labels: dict[int, int] = {}

    # -- introspection ----------------------------------------------------
    @property
    def acked(self) -> int:
        """Samples durably absorbed into session state — the resume
        cursor the client restarts from (every ingested sample is either
        in the EMS carrier's seed buffer or standardized into the window
        buffer, so this is simply everything ingested)."""
        return self.ems.n_seen

    @property
    def preds_offset(self) -> int:
        """Index of the first RETAINED decision: ``windows_decided -
        len(decisions)`` (0 until the bounded history starts dropping
        its head)."""
        return self.windows_decided - len(self._decisions)

    @property
    def decisions(self) -> list[WindowDecision]:
        return list(self._decisions)

    def preds(self) -> np.ndarray:
        """The RETAINED tail of the decision stream: ``(k,)`` int64
        (``-1`` for expired/error windows), covering windows
        ``[preds_offset, windows_decided)``."""
        return np.asarray([d.pred for d in self._decisions], np.int64)

    @property
    def labels(self) -> dict[int, int]:
        """Recorded cue labels: window index -> class label (a copy)."""
        return dict(self._labels)

    # -- labeling ---------------------------------------------------------
    def label(self, window: int, label: int) -> bool:
        """Record the true class for one DECIDED window.

        Returns ``True`` when the label is new, ``False`` for an exact
        duplicate (idempotent — a retried POST must not error).  Raises
        ``KeyError`` for a window that has no decision yet (unknown from
        the labeling contract's point of view), :class:`LabelConflict`
        for a window whose decision expired/errored (no prediction exists
        to pair with) or a duplicate that disagrees, and ``ValueError``
        for non-integer input.  Caller holds ``lock``.
        """
        window = int(window)
        label = int(label)
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if label < 0:
            raise ValueError(f"label must be >= 0, got {label}")
        if window >= self.windows_decided:
            raise KeyError(
                f"window {window} has no decision yet (decided frontier "
                f"is {self.windows_decided})")
        existing = self._labels.get(window)
        if existing is not None:
            if existing != label:
                raise LabelConflict(
                    f"window {window} already labeled {existing}; "
                    f"refusing conflicting label {label}")
            return False
        # Only windows still inside the retained decision history can be
        # status-checked; older ones were decided long ago and their
        # record aged out — accept the label (the decision happened).
        rel = window - self.preds_offset
        if 0 <= rel < len(self._decisions) \
                and self._decisions[rel].status != STATUS_OK:
            raise LabelConflict(
                f"window {window} {self._decisions[rel].status} — there "
                f"is no prediction to label")
        self._labels[window] = label
        return True

    # -- streaming --------------------------------------------------------
    def ingest(self, chunk) -> list[tuple[int, int, np.ndarray]]:
        """Push one raw ``(C, n)`` chunk; return the windows that became
        complete as ``(index, start, (C, window) array)`` tuples."""
        emitted = self.ems.push(chunk)
        self._append_std(emitted)
        return self._take_ready_windows()

    def finish(self) -> list[tuple[int, int, np.ndarray]]:
        """Flush a stream that ended before the EMS seed block filled
        (standardizing the short buffer, offline-equivalently) and return
        any windows that completes.  Called on ``/session/<id>/close``."""
        self._append_std(self.ems.flush())
        return self._take_ready_windows()

    def _append_std(self, std: np.ndarray) -> None:
        if std.shape[1]:
            self._buf = np.concatenate([self._buf, std], axis=1)

    def _take_ready_windows(self) -> list[tuple[int, int, np.ndarray]]:
        out = []
        buf_end = self._buf_start + self._buf.shape[1]
        while True:
            start = self.windows_produced * self.hop
            if start + self.window > buf_end:
                break
            lo = start - self._buf_start
            out.append((self.windows_produced, start,
                        self._buf[:, lo:lo + self.window].copy()))
            self.windows_produced += 1
        return out

    def record(self, decision: WindowDecision) -> None:
        """Append one window's outcome (strictly in window order) and trim
        the standardized buffer past the decided frontier."""
        if decision.index != self.windows_decided:
            raise ValueError(
                f"decision for window {decision.index} recorded out of "
                f"order (expected {self.windows_decided})")
        self._decisions.append(decision)
        self.windows_decided += 1
        if decision.status == STATUS_EXPIRED:
            self.n_expired += 1
        if len(self._decisions) > self.decision_history:
            del self._decisions[:len(self._decisions)
                                - self.decision_history]
        # The buffer only needs to reach back to the next UNDECIDED
        # window's start: everything earlier has an answer on record.
        keep_from = self.windows_decided * self.hop
        drop = keep_from - self._buf_start
        if drop > 0:
            self._buf = self._buf[:, drop:]
            self._buf_start = keep_from

    # -- snapshot state ---------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        """The session's full durable state as a flat ndarray mapping.

        The window cursor is implicitly rolled back to the decided
        frontier (``windows_produced`` is NOT stored): a restore
        re-extracts any produced-but-undecided windows from the buffered
        standardized samples, which the trim policy in :meth:`record`
        guarantees are still present.
        """
        flat = {"ems/" + k: v for k, v in self.ems.state_arrays().items()}
        flat.update({
            "window": np.asarray(self.window, np.int64),
            "hop": np.asarray(self.hop, np.int64),
            "deadline_ms": np.asarray(
                np.nan if self.deadline_ms is None else self.deadline_ms,
                np.float64),
            "buf": self._buf,
            "buf_start": np.asarray(self._buf_start, np.int64),
            "windows_decided": np.asarray(self.windows_decided, np.int64),
            "n_expired": np.asarray(self.n_expired, np.int64),
            "decision_history": np.asarray(self.decision_history, np.int64),
            "dec_pred": np.asarray([d.pred for d in self._decisions],
                                   np.int64),
            "dec_status": np.asarray(
                [_STATUS_CODES[d.status] for d in self._decisions], np.int8),
            "dec_latency_ms": np.asarray(
                [d.latency_ms for d in self._decisions], np.float32),
            # Labels serialize sorted by window index: the byte-identical
            # round-trip the export/import migration contract requires.
            "lab_window": np.asarray(sorted(self._labels), np.int64),
            "lab_label": np.asarray(
                [self._labels[w] for w in sorted(self._labels)], np.int64),
        })
        return flat

    @classmethod
    def from_state(cls, session_id: str, flat: dict, *,
                   device: torch.device | str | None = None
                   ) -> "StreamSession":
        """Rebuild a session from :meth:`state_arrays` output (either
        package's), its carry on ``device``."""
        deadline = float(flat["deadline_ms"])
        session = cls(
            session_id,
            n_channels=int(flat["ems/n_channels"]),
            window=int(flat["window"]), hop=int(flat["hop"]),
            deadline_ms=None if np.isnan(deadline) else deadline,
            decision_history=int(flat["decision_history"]),
            device=device,
        )
        session.ems = StreamingEMS.from_state(
            {k[len("ems/"):]: v for k, v in flat.items()
             if k.startswith("ems/")}, device=device)
        session._buf = np.asarray(flat["buf"], np.float32)
        session._buf_start = int(flat["buf_start"])
        session.windows_decided = int(flat["windows_decided"])
        session.n_expired = int(flat["n_expired"])
        preds = np.asarray(flat["dec_pred"])
        statuses = np.asarray(flat["dec_status"])
        latencies = np.asarray(flat["dec_latency_ms"])
        first = session.windows_decided - len(preds)
        session._decisions = [
            WindowDecision(index=first + i, start=(first + i) * session.hop,
                           pred=int(preds[i]),
                           status=_CODE_STATUS[int(statuses[i])],
                           latency_ms=float(latencies[i]))
            for i in range(len(preds))]
        if "lab_window" in flat:
            # Pre-adaptation snapshots have no label arrays: restore to
            # an empty label table rather than failing the whole session.
            lab_w = np.asarray(flat["lab_window"], np.int64)
            lab_l = np.asarray(flat["lab_label"], np.int64)
            session._labels = {int(w): int(v)
                               for w, v in zip(lab_w, lab_l)}
        # The produced cursor restarts at the decided frontier: in-flight
        # windows at crash time are re-extracted on the next ingest.
        session.windows_produced = session.windows_decided
        return session
