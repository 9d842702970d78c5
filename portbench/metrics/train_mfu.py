"""The whole training step's share of the card's FP32 peak: the frozen FLOP
count of a fold-epoch (``reference/<model>.py``) times the traced window's
fold-epochs per second (host clock, ended by a synchronize)."""

from portbench import yardstick


def read(run):
    peak = yardstick.peaks(run.device_kind)
    if peak is None:
        return None
    rate = run.window.fold_epochs / run.window.seconds
    return 100.0 * run.fold_epoch_flops * rate / peak[0]
