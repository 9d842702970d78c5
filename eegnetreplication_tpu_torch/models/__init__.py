"""Model zoo of the torch port: EEGNet (+wide), ShallowConvNet,
DeepConvNet, the registry, and the classical CSP+LDA and tangent-space
baselines (``csp``, ``riemann``)."""

from eegnetreplication_tpu_torch.models.convnets import (  # noqa: F401
    DeepConvNet,
    ShallowConvNet,
)
from eegnetreplication_tpu_torch.models.eegnet import (  # noqa: F401
    EEGNet,
    eegnet_wide,
)
from eegnetreplication_tpu_torch.models.registry import (  # noqa: F401
    MODEL_REGISTRY,
    get_model,
)

__all__ = ["DeepConvNet", "EEGNet", "MODEL_REGISTRY", "ShallowConvNet",
           "eegnet_wide", "get_model"]
