"""The host's time to queue one train step: the mean duration of the
port's ``train.step`` layer spans (``training/steps.py::train_step``)
that start in the traced window.  Nothing on a port without the layer
record, or where its ring dropped spans of the window."""

NAME = "train.step"


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
