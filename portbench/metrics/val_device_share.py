"""Device time (the union of their intervals) of the operations launched
inside ``eval_step`` calls, over all device time in the traced window."""


def read(run):
    total = run.trace.device_s()
    if total <= 0:
        return None
    return run.trace.device_s("portbench.eval_step") / total
