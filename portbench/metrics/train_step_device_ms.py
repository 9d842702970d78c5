"""Device time (the union of their intervals) of the operations launched
inside ``train_step`` calls, per call, in the traced window."""


def read(run):
    calls = run.trace.calls.get("portbench.train_step", 0)
    device = run.trace.device_s("portbench.train_step")
    if calls == 0 or device <= 0:
        return None
    return 1e3 * device / calls
