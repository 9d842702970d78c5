"""Self-tuning bucket ladder: adapt the captured buckets to the traffic.

The port's copy of ``eegnetreplication_tpu/serve/tuner.py``.  The engine's
ladder of padded buckets (one captured CUDA graph each on the card) and
the batcher's coalescing window are set at startup; the traffic is not.
A server that boots with ``(1, 8, 32, 128)`` and then takes steady
40-trial requests pads every forward to 128 (fill 0.31).

:class:`LadderTuner` closes the loop from what the serving path observes:
the per-bucket ``bucket_fill`` histograms (the engine, one observation per
chunk) and the ``batch_trials`` histogram (the batcher, one per forward).
:func:`propose` turns one window of them into a new ladder and
``max_wait_ms`` (a pure function, the JAX package's rules and
guardrails), and :meth:`LadderTuner.apply` realizes it:
``registry.retune`` builds the new ladder's engine and captures its graphs
off the hot path, then swaps the reference; the batcher adopts the new
cap and window live; a ``ladder_retune`` event records the decision.
Requests in flight finish on the old engine, whose graphs are freed with
it.  A retune that fails (a capture error among them) is logged as a
warning and the old ladder keeps serving; nothing is journaled, as in the
JAX tuner.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.utils.logging import logger

# Proposal guardrails: the ladder stays short (every rung is one captured
# graph held warm) and the top bucket bounded (one forward's latency
# must stay well under any sane request deadline).
MAX_RUNGS = 5
MAX_TOP_BUCKET = 512
MIN_WAIT_MS = 0.5
MAX_WAIT_MS = 50.0

# A window with fewer dispatches than this is noise, not traffic shape.
MIN_DISPATCHES = 20


@dataclass(frozen=True)
class LadderStats:
    """One observation window of batcher/engine traffic."""

    window_s: float
    dispatches: int                    # coalesced forwards in the window
    trials: float                      # total trials dispatched
    bucket_counts: dict[int, int] = field(default_factory=dict)
    bucket_fill_mean: dict[int, float] = field(default_factory=dict)

    @property
    def arrival_trials_per_s(self) -> float:
        return self.trials / max(self.window_s, 1e-9)


@dataclass(frozen=True)
class Proposal:
    """A revised ladder + coalescing window, with the evidence."""

    buckets: tuple[int, ...]
    max_wait_ms: float
    reason: str


def _next_pow2(n: float) -> int:
    return 1 << max(0, math.ceil(math.log2(max(n, 1.0))))


def propose(stats: LadderStats, buckets: tuple[int, ...],
            max_wait_ms: float, *, min_dispatches: int = MIN_DISPATCHES,
            max_top: int = MAX_TOP_BUCKET, max_rungs: int = MAX_RUNGS
            ) -> Proposal | None:
    """A revised (buckets, max_wait_ms) from one observation window, or
    ``None`` when the evidence is thin or the current config already fits.

    Deterministic rules (each journaled as the proposal's ``reason``):

    - ``top_saturated`` — the top bucket takes >= half the dispatches at
      >= 0.9 mean fill: traffic wants a bigger batch; double the top rung
      (up to ``max_top``).
    - ``top_underfilled`` — the top bucket runs <= 0.6 full: insert the
      power-of-two rung nearest the observed mean batch so those
      dispatches stop padding to the top (the occupancy lever).
    - ``wait_adapted`` — retarget the coalescing window to the time the
      observed arrival rate needs to fill ~half a top bucket, when that
      differs from the current window by >= 1.5x either way.

    Rungs beyond ``max_rungs`` are pruned least-used-first (never bucket
    1, never the top) — every rung is a warm captured graph.
    """
    if stats.dispatches < min_dispatches:
        return None
    top = buckets[-1]
    rungs = set(buckets)
    reasons = []

    top_count = stats.bucket_counts.get(top, 0)
    top_share = top_count / stats.dispatches
    top_fill = stats.bucket_fill_mean.get(top, 0.0)
    if top_share >= 0.5 and top_fill >= 0.9 and top * 2 <= max_top:
        rungs.add(top * 2)
        top = top * 2
        reasons.append("top_saturated")
    elif top_count > 0 and top_fill <= 0.6:
        mid = _next_pow2(top_fill * top)
        if 1 < mid < top and mid not in rungs:
            rungs.add(mid)
            reasons.append("top_underfilled")

    while len(rungs) > max_rungs:
        prunable = sorted(
            (b for b in rungs if b not in (1, top)),
            key=lambda b: (stats.bucket_counts.get(b, 0), b))
        if not prunable:
            break
        rungs.discard(prunable[0])

    # Coalescing window: long enough to half-fill the top bucket at the
    # observed arrival rate, never parking a lone request past MAX_WAIT.
    rate = stats.arrival_trials_per_s
    new_wait = max_wait_ms
    if rate > 0:
        target = min(MAX_WAIT_MS,
                     max(MIN_WAIT_MS, 1000.0 * (top / 2.0) / rate))
        if (target >= max_wait_ms * 1.5 or target <= max_wait_ms / 1.5):
            new_wait = round(target, 3)
            reasons.append("wait_adapted")

    new_buckets = tuple(sorted(rungs))
    if not reasons or (new_buckets == tuple(buckets)
                       and new_wait == max_wait_ms):
        return None
    return Proposal(buckets=new_buckets, max_wait_ms=new_wait,
                    reason="+".join(reasons))


class LadderTuner:
    """Observe the live batcher metrics, retune the ladder off-path.

    ``tune_once()`` is the whole loop body (collect -> propose -> apply);
    ``start()`` runs it on a background thread every ``interval_s``.
    ``apply()`` is public so benches/tests can drive a forced retune
    through the exact swap machinery the autonomous path uses.

    ``registry`` is anything with the swap surface the tuner drives —
    the single-model :class:`~eegnetreplication_tpu_torch.serve.registry.ModelRegistry`
    or the multi-tenant :class:`~eegnetreplication_tpu_torch.serve.registry.ModelZoo`
    (whose ``retune`` rebuilds the stacked engine on the new
    ladder off the hot path; occupancy is ladder-wide either way, since
    every tenant shares the one bucket ladder).
    """

    def __init__(self, registry, batcher, *, journal=None,
                 interval_s: float = 30.0,
                 min_dispatches: int = MIN_DISPATCHES,
                 max_top: int = MAX_TOP_BUCKET,
                 max_rungs: int = MAX_RUNGS):
        self.registry = registry
        self.batcher = batcher
        self.interval_s = float(interval_s)
        self.min_dispatches = int(min_dispatches)
        self.max_top = int(max_top)
        self.max_rungs = int(max_rungs)
        self._journal = journal if journal is not None \
            else obs_journal.current()
        self._prev: dict | None = None
        self._prev_t = time.perf_counter()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Applied proposals, INCLUDING wait-only ones (which skip the
        # engine rebuild and therefore never reach registry.retunes) —
        # /healthz and serve_end report this counter when tuning is on.
        self.retunes = 0

    # -- observation ------------------------------------------------------
    @staticmethod
    def _hist(snapshot: dict, name: str) -> dict[tuple, dict]:
        out = {}
        for entry in snapshot.get("histograms", {}).get(name, []):
            out[tuple(sorted(entry["labels"].items()))] = entry
        return out

    def collect(self) -> LadderStats:
        """Stats since the previous ``collect`` (histograms are
        cumulative; the window is the difference)."""
        now = time.perf_counter()
        snapshot = self._journal.metrics.snapshot()
        prev = self._prev or {}
        window_s = now - self._prev_t
        self._prev, self._prev_t = snapshot, now

        def delta(name, key, field_):
            cur = self._hist(snapshot, name).get(key)
            old = self._hist(prev, name).get(key)
            return ((cur[field_] if cur else 0.0)
                    - (old[field_] if old else 0.0))

        fills = self._hist(snapshot, "bucket_fill")
        bucket_counts: dict[int, int] = {}
        bucket_fill_mean: dict[int, float] = {}
        for key in fills:
            bucket = int(dict(key)["bucket"])
            count = delta("bucket_fill", key, "count")
            if count > 0:
                bucket_counts[bucket] = int(count)
                bucket_fill_mean[bucket] = \
                    delta("bucket_fill", key, "sum") / count
        # batch_trials is observed label-free: its one series key is the
        # empty tuple (which is falsy — test identity against None).
        bt_key = next(iter(self._hist(snapshot, "batch_trials")), None)
        dispatches = int(delta("batch_trials", bt_key, "count")) \
            if bt_key is not None else 0
        trials = delta("batch_trials", bt_key, "sum") \
            if bt_key is not None else 0.0
        return LadderStats(window_s=window_s, dispatches=dispatches,
                           trials=trials, bucket_counts=bucket_counts,
                           bucket_fill_mean=bucket_fill_mean)

    # -- actuation --------------------------------------------------------
    def apply(self, proposal: Proposal,
              stats: LadderStats | None = None) -> None:
        """Realize one proposal: warm the new ladder off the hot path,
        swap atomically, adopt the batcher window, journal the retune.

        A wait-only proposal (ladder unchanged) skips the engine rebuild
        entirely — recapturing every rung to change a coalescing window
        would burn seconds of device time for nothing; the batcher adopts
        the new window live.
        """
        old_buckets = self.registry.active_buckets
        old_precision = self.registry.serving_precision
        old_wait_ms = self.batcher.max_wait_s * 1000.0
        t0 = time.perf_counter()
        ladder_changed = tuple(proposal.buckets) != tuple(old_buckets)
        if ladder_changed:
            # The new engine's graphs are captured (each bucket journals
            # its compile events) before the swap.
            self.registry.retune(proposal.buckets)
        # max_batch follows the ladder top ONLY when the ladder actually
        # moved: a wait-only proposal must not clobber a caller-set
        # coalescing cap below the current top bucket.
        self.batcher.reconfigure(
            max_batch=proposal.buckets[-1] if ladder_changed else None,
            max_wait_ms=proposal.max_wait_ms)
        wall = time.perf_counter() - t0
        self.retunes += 1
        self._journal.event(
            "ladder_retune", old_buckets=list(old_buckets),
            new_buckets=list(proposal.buckets), reason=proposal.reason,
            old_max_wait_ms=round(old_wait_ms, 3),
            new_max_wait_ms=round(proposal.max_wait_ms, 3),
            precision=old_precision,
            dispatches=(stats.dispatches if stats else None),
            arrival_trials_per_s=(round(stats.arrival_trials_per_s, 2)
                                  if stats else None),
            top_fill=(round(stats.bucket_fill_mean.get(
                old_buckets[-1], 0.0), 4) if stats else None),
            elapsed_s=round(wall, 3))
        self._journal.metrics.inc("ladder_retunes")
        logger.info("Ladder retuned (%s) in %.2fs: %s @ %.1fms -> %s @ "
                    "%.1fms", proposal.reason, wall, old_buckets,
                    old_wait_ms, proposal.buckets, proposal.max_wait_ms)

    def tune_once(self) -> Proposal | None:
        """One loop body: collect the window, maybe retune.  Never raises
        — a tuner bug must not take serving down."""
        try:
            stats = self.collect()
            # active_buckets, not engine.buckets: the zoo's engine
            # property may synchronously BUILD an evicted default-tenant
            # engine, and a ladder read on the tune tick must stay cheap.
            current = self.registry.active_buckets
            proposal = propose(stats, current,
                               self.batcher.max_wait_s * 1000.0,
                               min_dispatches=self.min_dispatches,
                               max_top=min(self.max_top,
                                           self.batcher.max_queue_trials),
                               max_rungs=self.max_rungs)
            if proposal is not None:
                self.apply(proposal, stats)
            return proposal
        except Exception as exc:  # noqa: BLE001 — advisory subsystem
            # A failed capture raised before the swap: the old engine and
            # its graphs still serve.
            logger.warning("Ladder tune pass failed (%s: %s); serving "
                           "unaffected", type(exc).__name__, exc)
            return None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "LadderTuner":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="serve-ladder-tuner",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tune_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=120.0)
            self._thread = None
