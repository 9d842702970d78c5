"""The device's idle time while the host draws and copies an epoch's
shuffles, over the traced window: the idle gaps (``trace.Summary.gaps``)
whose start finds the host's innermost layer span of the port to be
``train.slot_source`` or ``train.slot_copy``
(``training/loop.py::FoldTrainer.run_epoch``).  The spans and the
profiler's events share ``time.time_ns()``'s clock.  Nothing without
device activity or such spans in the window, on a port without the layer
record, or where its ring dropped spans of the window."""

import bisect

NAMES = ("train.slot_source", "train.slot_copy")


def read(run):
    from eegnetreplication_tpu_torch.obs import trace

    if not hasattr(trace, "layer_spans") or not run.trace.busy:
        return None
    t0, t1 = run.trace.window
    if trace.layer_lost_since(t0):
        return None
    spans = sorted(trace.layer_spans(),
                   key=lambda s: (s.start_ns, -s.end_ns))
    if not any(s.name in NAMES and t0 <= s.start_ns <= t1 for s in spans):
        return None
    by_id = {s.span_id: s for s in spans}
    starts = [s.start_ns for s in spans]
    idle = 0
    for a, b in run.trace.gaps():
        i = bisect.bisect_right(starts, a) - 1
        span = spans[i] if i >= 0 else None
        # the latest span to start before ``a``; if it had ended, the
        # innermost span still open at ``a`` is its nearest such ancestor
        while span is not None and span.end_ns < a:
            span = by_id.get(span.parent_span_id)
        if span is not None and span.name in NAMES:
            idle += b - a
    return idle / (t1 - t0)
