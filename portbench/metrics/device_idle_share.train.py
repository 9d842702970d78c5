"""One minus the union of the device's activity over the traced window."""


def read(run):
    if not run.trace.busy:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
