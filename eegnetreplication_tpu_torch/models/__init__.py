"""Model zoo of the torch port: EEGNet (eval mode) and its wide variant."""

from eegnetreplication_tpu_torch.models.eegnet import EEGNet, eegnet_wide

__all__ = ["EEGNet", "eegnet_wide"]
