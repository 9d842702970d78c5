"""Training-side modules of the torch port.  This slice ports only the
checkpoint formats (``checkpoint``); the train step, fold loop and
protocols arrive with the training slice."""
