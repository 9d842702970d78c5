"""Forwards through the fused BatchNorm and spatial convolution per train
step over the run: the port's counters ``bn_spatial.forwards``
(``ops/bn_spatial.py``, forwards that ran its kernels on the card) over
``train.steps`` (``training/steps.py::train_step``).  1.0 where every
train step of an f32 ``highest`` EEGNet with flax BatchNorm runs block 1's
first BatchNorm and spatial convolution through the kernels.  Nothing on a
port without either counter, or before any train step."""


def read(run):
    from eegnetreplication_tpu_torch.obs import trace

    if not hasattr(trace, "layer_counts"):
        return None
    counts = trace.layer_counts()
    steps = counts.get("train.steps", 0)
    if steps == 0 or "bn_spatial.forwards" not in counts:
        return None
    return counts["bn_spatial.forwards"] / steps
