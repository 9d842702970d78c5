"""eegnetreplication_tpu_torch: the PyTorch/CUDA port of eegnetreplication_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA
Hopper card (H100).  It keeps the JAX package's module layout and names so
each module's counterpart is easy to find, and imports nothing of it: the
JAX package stays the reference the port is tested against.

Three paths are ported.  Serving: checkpoint loading (native ``.npz`` and
the reference's ``.pth``), the bucketed inference engine, the
micro-batcher, the HTTP service and the ``predict`` CLI; EEGNet's block 1
runs in a CUDA kernel written by hand (``ops/csrc/block1.cu``).
Preprocessing: the ``dataset`` CLI reads the competition's GDF files,
resamples, bandpasses and standardizes them on the card and writes the
JAX package's ``-preprocessed.npz`` and ``-trials.npz`` files; its
exponential moving standardization runs in a second hand-written kernel
(``ops/csrc/ems.cu``) when ``EEGTPU_EMS_METHOD=pallas``.  Training: the
``train`` CLI runs the within-subject and cross-subject protocols with all
folds of a group per step, chunked runs with run snapshots and
``--resume``; every validation and test batch runs block 1 of all folds in
one launch of K1's stacked form.  A training run writes the JAX package's
run journal (``obs/``) and takes its chaos plans (``resil/inject.py``).
Each kernel is the counterpart of one of the JAX package's Pallas kernels.

Like the JAX package init, this re-exports the shared ``logger``.
"""

from eegnetreplication_tpu_torch.utils.logging import logger  # noqa: F401

__version__ = "0.1.0"
