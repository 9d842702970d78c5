"""Model zoo of the torch port: EEGNet and its wide variant."""

from eegnetreplication_tpu_torch.models.eegnet import (
    MODEL_REGISTRY,
    EEGNet,
    eegnet_wide,
    get_model,
)

__all__ = ["EEGNet", "MODEL_REGISTRY", "eegnet_wide", "get_model"]
