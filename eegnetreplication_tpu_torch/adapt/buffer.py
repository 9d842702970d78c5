"""Labeled replay buffer: pairs cue-schedule labels with decided windows.

The port's copy of ``eegnetreplication_tpu/adapt/buffer.py`` (pure numpy
and Python: the same bounds, FIFO eviction and ``dataset``/``stats``).
The closed-loop adaptation story starts here.  A streaming BCI session
decides windows continuously; the *client* knows the ground truth for
many of them (cue-paced trials announce the intended class before the
window is even recorded) and posts it back via
``POST /session/<id>/label``.  The buffer pairs that label with the
standardized window the serving path actually classified — NOT the raw
samples: the model must be fine-tuned on exactly the tensor distribution
it will see at inference, which is the post-EMS-standardization window —
and accumulates a per-tenant labeled dataset the
:class:`~eegnetreplication_tpu_torch.adapt.worker.AdaptationWorker` fine-tunes
from, strictly off the hot path.

Two invariants keep the hot path safe:

- ``observe``/``label`` are O(1) dict operations under one lock — no
  numpy copies beyond the single window being captured.
- Both the unlabeled capture ring and the labeled set are bounded
  (FIFO eviction), so a session that never labels (or labels forever)
  cannot grow the process without bound.

Durability is deliberately split: *labels* ride the session's own
``state_arrays`` snapshot (they are tiny, and the contract says they
survive snapshot/resume and export/import), while *captured windows*
are process-local — after a restart the loop simply re-captures from
live traffic, which is cheaper than snapshotting megabytes of float32
windows nobody may ever label.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

# Per-tenant bounds.  A window is (C, T) float32 — (22, 256) is ~22 KB —
# so 512 captured windows is ~11 MB worst case per tenant; the labeled
# set holds the window too, hence the same order of bound.
DEFAULT_WINDOW_CAPACITY = 512
DEFAULT_LABELED_CAPACITY = 1024


class _TenantBuffer:
    """One tenant's capture ring + labeled set (caller holds the lock)."""

    __slots__ = ("windows", "labeled_x", "labeled_y", "captured", "paired",
                 "unpaired_labels")

    def __init__(self):
        # (session_id, window_index) -> (C, T) float32, insertion-ordered
        # so eviction drops the oldest capture first.
        self.windows: OrderedDict[tuple[str, int], np.ndarray] = OrderedDict()
        self.labeled_x: OrderedDict[tuple[str, int], np.ndarray] = \
            OrderedDict()
        self.labeled_y: dict[tuple[str, int], int] = {}
        self.captured = 0          # lifetime captures (stats)
        self.paired = 0            # lifetime label<->window pairings
        self.unpaired_labels = 0   # labels whose window was never captured


class ReplayBuffer:
    """Bounded per-tenant (window, label) pairs for online fine-tuning."""

    def __init__(self, *, window_capacity: int = DEFAULT_WINDOW_CAPACITY,
                 labeled_capacity: int = DEFAULT_LABELED_CAPACITY):
        self.window_capacity = int(window_capacity)
        self.labeled_capacity = int(labeled_capacity)
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantBuffer] = {}

    def _tenant(self, model_id: str) -> _TenantBuffer:
        buf = self._tenants.get(model_id)
        if buf is None:
            buf = self._tenants[model_id] = _TenantBuffer()
        return buf

    # -- capture (decide path) --------------------------------------------
    def observe(self, model_id: str, session_id: str, index: int,
                window: np.ndarray) -> None:
        """Capture one decided (standardized) window for possible later
        labeling.  Called from the decide path with the session lock held
        — one float32 copy, two dict ops."""
        win = np.asarray(window, np.float32).copy()
        key = (str(session_id), int(index))
        with self._lock:
            buf = self._tenant(model_id)
            buf.windows[key] = win
            buf.captured += 1
            while len(buf.windows) > self.window_capacity:
                buf.windows.popitem(last=False)

    # -- labeling (label endpoint) ----------------------------------------
    def label(self, model_id: str, session_id: str, index: int,
              label: int) -> bool:
        """Pair a client label with its captured window.

        Returns True when the pair landed in the labeled set, False when
        the window was never captured (or already evicted) — the label
        is still valid at the session layer, there is just nothing to
        train on.  Re-labeling an already-paired window overwrites the
        pair (the session layer enforces idempotence/conflicts before
        calling here)."""
        key = (str(session_id), int(index))
        with self._lock:
            buf = self._tenant(model_id)
            win = buf.windows.get(key)
            if win is None:
                if key not in buf.labeled_x:
                    buf.unpaired_labels += 1
                    return False
                # Window already promoted into the labeled set: treat a
                # re-label as an overwrite of y only.
                buf.labeled_y[key] = int(label)
                return True
            buf.labeled_x[key] = win
            buf.labeled_y[key] = int(label)
            buf.paired += 1
            while len(buf.labeled_x) > self.labeled_capacity:
                old_key, _ = buf.labeled_x.popitem(last=False)
                buf.labeled_y.pop(old_key, None)
            return True

    def window_for(self, model_id: str, session_id: str,
                   index: int) -> np.ndarray | None:
        """The captured window for (session, index), or None — the shadow
        evaluator uses this to run a labeled eval on the exact tensor."""
        key = (str(session_id), int(index))
        with self._lock:
            buf = self._tenants.get(model_id)
            if buf is None:
                return None
            win = buf.windows.get(key)
            if win is None:
                win = buf.labeled_x.get(key)
            return None if win is None else win.copy()

    # -- consumption (adaptation worker) ----------------------------------
    def n_labeled(self, model_id: str) -> int:
        with self._lock:
            buf = self._tenants.get(model_id)
            return 0 if buf is None else len(buf.labeled_x)

    def dataset(self, model_id: str) -> tuple[np.ndarray, np.ndarray]:
        """Snapshot the labeled set as (X, y) arrays — (N, C, T) float32
        and (N,) int32.  A copy: the worker trains outside the lock."""
        with self._lock:
            buf = self._tenants.get(model_id)
            if buf is None or not buf.labeled_x:
                return (np.empty((0,), np.float32), np.empty((0,), np.int32))
            keys = list(buf.labeled_x)
            x = np.stack([buf.labeled_x[k] for k in keys]).astype(np.float32)
            y = np.asarray([buf.labeled_y[k] for k in keys], np.int32)
            return x, y

    def stats(self, model_id: str) -> dict:
        with self._lock:
            buf = self._tenants.get(model_id)
            if buf is None:
                return {"captured": 0, "labeled": 0, "paired": 0,
                        "unpaired_labels": 0}
            return {"captured": buf.captured, "labeled": len(buf.labeled_x),
                    "paired": buf.paired,
                    "unpaired_labels": buf.unpaired_labels}

    def clear(self, model_id: str) -> None:
        with self._lock:
            self._tenants.pop(model_id, None)
