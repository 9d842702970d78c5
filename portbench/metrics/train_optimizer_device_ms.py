"""The device's time in one train step's optimizer phase (the gradient
norm, the clamp, Adam, the statistics and the fold selection): the mean
``device_ms`` (CUDA events on the step's stream, recorded while the
profiler runs) of the port's ``train.step.optimizer`` layer spans
(``training/steps.py::train_step``) that start in the traced window.
Nothing on a port without the layer record, where its ring dropped spans
of the window, or off a CUDA device."""

NAME = "train.step.optimizer"


def read(run):
    from eegnetreplication_tpu_torch.obs import trace

    if not hasattr(trace, "layer_spans"):
        return None
    t0, t1 = run.trace.window
    if trace.layer_lost_since(t0):
        return None
    ms = [s.device_ms for s in trace.layer_spans()
          if s.name == NAME and t0 <= s.start_ns <= t1
          and s.device_ms is not None]
    if not ms:
        return None
    return sum(ms) / len(ms)
