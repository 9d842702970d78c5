"""The plain reference: what the port's training protocols compute, in
float32 PyTorch with TF32 off, written from the published models and the
reference protocol, one fold at a time.

It imports neither JAX nor anything of ``eegnetreplication_tpu_torch``.
It is handed the benchmark's own data pool and the cell's configuration
and traffic files, and works out again everything the program derives
from the seed: the folds, the initial weights, each epoch's batch order
and the dropout masks.  One module per model (``eegnet.py``,
``deepconvnet.py``) holds its layers, its initial draws, its dropout
stream and its FLOP count; ``protocol.py`` the splits and batch orders;
``training.py`` the loop.
"""
