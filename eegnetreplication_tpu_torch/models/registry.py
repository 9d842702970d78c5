"""Model registry: name -> constructor, for the CLIs and the protocols.

The counterpart of ``eegnetreplication_tpu/models/registry.py``: the
BASELINE.json config matrix (EEGNet, EEGNet-wide, ShallowConvNet,
DeepConvNet) behind one factory.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from eegnetreplication_tpu_torch.models.convnets import (
    DeepConvNet,
    ShallowConvNet,
)
from eegnetreplication_tpu_torch.models.eegnet import EEGNet, eegnet_wide

MODEL_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "eegnet": EEGNet,
    "eegnet_wide": eegnet_wide,
    "shallow_convnet": ShallowConvNet,
    "deep_convnet": DeepConvNet,
}


def get_model(name: str, **kwargs) -> nn.Module:
    """Construct a model by registry name."""
    try:
        ctor = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return ctor(**kwargs)
