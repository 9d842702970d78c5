"""K1-stacked launches per validation or test batch over the run: the
port's counters ``k1_stacked.launches`` (``ops/fused_eegnet.py::
block1_stacked``, launches on the card) over ``eval.steps``
(``training/steps.py::eval_step``).  1.0 where every batch of an f32
``highest`` EEGNet runs its block 1 in one K1-stacked launch.  Nothing on
a port without the counters, or before any eval step."""


def read(run):
    from eegnetreplication_tpu_torch.obs import trace

    if not hasattr(trace, "layer_counts"):
        return None
    counts = trace.layer_counts()
    evals = counts.get("eval.steps", 0)
    if evals == 0:
        return None
    return counts.get("k1_stacked.launches", 0) / evals
