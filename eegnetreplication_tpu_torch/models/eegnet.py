"""EEGNet (Lawhern et al. 2018) in PyTorch, eval mode.

The counterpart of ``eegnetreplication_tpu/models/eegnet.py``, in the
reference's own NCHW layout and layer names (``temporal.0/1``, ``spatial``,
``aggregation.0``, ``block_2.0/1/2``, ``classifier``), so its
``state_dict`` is the reference's ``.pth`` layout and
``training/checkpoint.py`` carries weights across from the JAX package's
flax tree.

- Block 1: temporal ``Conv(1x32, same)`` -> BN -> depthwise spatial
  ``Conv(Cx1, groups=F1)`` -> BN -> ELU -> AvgPool(1,4) -> Dropout;
- Block 2: depthwise ``1x16 same`` + pointwise ``1x1`` -> BN -> ELU ->
  AvgPool(1,8) -> Dropout -> Flatten;
- classifier: ``Linear(F2*(T//32) -> n_classes)``, logits out.

torch's ``padding="same"`` pads an even kernel (15, 16) and (7, 8), exactly
like XLA's SAME, so feature maps align sample for sample with the JAX model.

Only eval mode is ported: the JAX package's training-mode BatchNorm
(``models/norm.py``: padded slots masked out of the batch statistics) has no
stock counterpart and arrives with the training slice, so ``forward`` in
training mode raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from eegnetreplication_tpu_torch.utils.device import resolve_device


class EEGNet(nn.Module):
    """EEGNet for ``(B, C, T)`` EEG trials; returns ``(B, n_classes)`` logits.

    Defaults mirror the reference: F1=8 temporal filters, depth multiplier
    D=2, F2=F1*D pointwise filters.  Weights are drawn like torch's default
    conv/linear init (U(+-1/sqrt(fan_in)), the JAX model's init too) from
    ``generator`` when given.  The module starts (and stays) in eval mode.
    """

    def __init__(self, n_channels: int = 22, n_times: int = 257,
                 n_classes: int = 4, F1: int = 8, D: int = 2,
                 dropout_rate: float = 0.5, bn_epsilon: float = 1e-5, *,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.n_channels = int(n_channels)
        self.n_times = int(n_times)
        self.n_classes = int(n_classes)
        self.F1 = int(F1)
        self.D = int(D)
        self.bn_epsilon = float(bn_epsilon)
        f2 = self.F2
        kw = {"device": device}
        self.temporal = nn.Sequential(
            nn.Conv2d(1, self.F1, (1, 32), padding="same", bias=False, **kw),
            nn.BatchNorm2d(self.F1, eps=bn_epsilon, **kw),
        )
        self.spatial = nn.Conv2d(self.F1, f2, (self.n_channels, 1),
                                 groups=self.F1, bias=False, **kw)
        self.aggregation = nn.Sequential(
            nn.BatchNorm2d(f2, eps=bn_epsilon, **kw), nn.ELU(),
            nn.AvgPool2d((1, 4)), nn.Dropout(dropout_rate),
        )
        self.block_2 = nn.Sequential(
            nn.Conv2d(f2, f2, (1, 16), padding="same", groups=f2,
                      bias=False, **kw),
            nn.Conv2d(f2, f2, (1, 1), bias=False, **kw),
            nn.BatchNorm2d(f2, eps=bn_epsilon, **kw), nn.ELU(),
            nn.AvgPool2d((1, 8)), nn.Dropout(dropout_rate), nn.Flatten(),
        )
        self.classifier = nn.Linear(f2 * self.t_prime, self.n_classes, **kw)
        self.reset_parameters(generator)
        self.eval()

    @property
    def F2(self) -> int:
        return self.F1 * self.D

    @property
    def t_prime(self) -> int:
        """Time steps left after both pools: the classifier's fan-in is
        ``F2 * t_prime``."""
        return self.n_times // 32

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None
                         ) -> None:
        """Conv/linear weights and biases ~ U(+-1/sqrt(fan_in)); BatchNorm
        affine to identity and running statistics to (0, 1).

        Values are drawn on the generator's device (the CPU by default) and
        copied over, so one seed gives the same weights on any device.
        """
        draw_on = generator.device if generator is not None else "cpu"

        def uniform_(param, bound):
            values = torch.empty(param.shape, device=draw_on)
            param.copy_(values.uniform_(-bound, bound, generator=generator))

        for module in self.modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(module.weight[0].numel())  # fan-in
                uniform_(module.weight, bound)
                if module.bias is not None:
                    uniform_(module.bias, bound)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "EEGNet's training-mode BatchNorm is not ported yet; call "
                ".eval() (the torch port serves eval-mode EEGNet)")
        if tuple(x.shape[-2:]) != (self.n_channels, self.n_times):
            raise ValueError(
                f"Expected input (..., {self.n_channels}, {self.n_times}); "
                f"got {tuple(x.shape)}")
        x = x.to(torch.float32).unsqueeze(1)        # (B, 1, C, T)
        x = self.temporal(x)
        x = self.spatial(x)
        x = self.aggregation(x)
        x = self.block_2(x)
        return self.classifier(x)


def eegnet_wide(n_channels: int = 22, n_times: int = 257,
                dropout_rate: float = 0.25, **kw) -> EEGNet:
    """EEGNet-wide (F1=16, D=4, F2=64)."""
    return EEGNet(n_channels=n_channels, n_times=n_times, F1=16, D=4,
                  dropout_rate=dropout_rate, **kw)
