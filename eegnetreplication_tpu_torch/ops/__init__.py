"""Kernels of the torch port: the fused EEGNet block 1 (``fused_eegnet``,
CUDA source in ``csrc/``) and the builder that compiles it (``build``)."""
