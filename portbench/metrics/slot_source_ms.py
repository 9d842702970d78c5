"""The host's time in the slot source a fold trainer draws each epoch's
shuffles from: the mean duration of the port's ``train.slot_source`` layer
spans (``training/loop.py::FoldTrainer.run_epoch``) that start in the
traced window.  Nothing on a port without the layer record, or where its
ring dropped spans of the window."""

NAME = "train.slot_source"


def read(run):
    from eegnetreplication_tpu_torch.obs import trace

    if not hasattr(trace, "layer_spans"):
        return None
    t0, t1 = run.trace.window
    if trace.layer_lost_since(t0):
        return None
    ns = [s.dur_ns for s in trace.layer_spans()
          if s.name == NAME and t0 <= s.start_ns <= t1]
    if not ns:
        return None
    return sum(ns) / len(ns) / 1e6
