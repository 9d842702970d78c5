"""Real training slots over the slots an epoch runs (``train_steps x batch``
a fold): the share of the train step's work that is not padding, counted
from the program's ``FoldSpec``."""


def read(run):
    return run.slots["real"] / run.slots["padded"]
