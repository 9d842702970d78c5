"""eegnetreplication_tpu_torch: the PyTorch/CUDA port of eegnetreplication_tpu.

A second package beside the JAX one, written in PyTorch for an NVIDIA
Hopper card (H100).  It keeps the JAX package's module layout and names so
each module's counterpart is easy to find, and imports nothing of it: the
JAX package stays the reference the port is tested against.

The serving path is ported: checkpoint loading (native ``.npz`` and the
reference's ``.pth``), the bucketed inference engine, the micro-batcher,
the HTTP service and the ``predict`` CLI.  EEGNet's block 1 runs in a CUDA
kernel written by hand (``ops/csrc/block1.cu``), the counterpart of the
JAX package's Pallas kernel.

Like the JAX package init, this re-exports the shared ``logger``.
"""

from eegnetreplication_tpu_torch.utils.logging import logger  # noqa: F401

__version__ = "0.1.0"
