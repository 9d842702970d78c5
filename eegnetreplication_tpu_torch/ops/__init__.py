"""Kernels of the torch port: the fused EEGNet block 1 (``fused_eegnet``)
and the single-pass EMS (``ems_kernel``), CUDA sources in ``csrc/``; the
builder that compiles them (``build``); and the torch ops around them
(``dsp``, ``ems``, the int8 weights and forward ``quant``, the
tenant-stacked forward ``stacked``)."""
