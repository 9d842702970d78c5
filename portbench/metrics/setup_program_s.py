"""The protocol's set-up as the port times it: the summed durations of the
top-level ``setup.*`` layer spans (``training/protocols.py``:
``setup.pool``, ``setup.folds``, ``setup.build``, ``setup.trainer``; a
span under another ``setup.*`` span is part of it) from the last
``setup.pool`` before the traced window to the window's start.  Leaves
out what ``fold_setup_s`` adds around them: the datasets' wrapping and
the model template.  Nothing on a port without the layer record, or
where its ring dropped spans of the set-up."""

PREFIX = "setup."


def read(run):
    from eegnetreplication_tpu_torch.obs import trace

    if not hasattr(trace, "layer_spans"):
        return None
    t0 = run.trace.window[0]
    spans = trace.layer_spans()
    pools = [s.start_ns for s in spans
             if s.name == PREFIX + "pool" and s.start_ns < t0]
    if not pools or trace.layer_lost_since(max(pools)):
        return None
    first = max(pools)
    names = {s.span_id: s.name for s in spans}
    ns = [s.dur_ns for s in spans
          if s.name.startswith(PREFIX) and first <= s.start_ns < t0
          and not names.get(s.parent_span_id, "").startswith(PREFIX)]
    return sum(ns) / 1e9
