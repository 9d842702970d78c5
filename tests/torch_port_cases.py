"""Shared inputs for the torch port's parity tests (``test_torch_*.py``).

Every input is drawn with numpy from a seed and handed to both packages:
the JAX package's EEGNet variables (flax names and layouts, numpy leaves)
and the same weights carried into the port's ``EEGNet`` through
``training/checkpoint.py::from_jax_variables``.  The tree is drawn directly
rather than through ``model.init`` (which compiles): ``test_torch_model``
pins that it has exactly the structure and shapes ``model.init`` makes.
"""

from __future__ import annotations

import numpy as np

from eegnetreplication_tpu.models import EEGNet as JaxEEGNet
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.training.checkpoint import from_jax_variables

# (C, T, F1, D): the product width, an even T, the wide width, a small one.
PRODUCT = (22, 257, 8, 2)
GEOMETRIES = {
    "product": PRODUCT,
    "t256": (22, 256, 8, 2),
    "wide": (22, 257, 16, 4),
    "small": (8, 64, 8, 2),
}
N_CLASSES = 4


def jax_model(c, t, f1, d) -> JaxEEGNet:
    return JaxEEGNet(n_channels=c, n_times=t, F1=f1, D=d)


def jax_variables(c, t, f1, d, *, seed=0, perturb_bn=True):
    """``(params, batch_stats)`` of the JAX EEGNet with numpy leaves.

    Kernels and the classifier bias ~ U(+-1/sqrt(fan_in)) (the model's own
    init); BatchNorm at identity, or with ``perturb_bn`` moved off it so
    every folding path is exercised.
    """
    rng = np.random.RandomState(seed)
    f2 = f1 * d
    fan_in_cls = f2 * (t // 32)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def bn(n):
        if not perturb_bn:
            return ({"scale": np.ones(n, np.float32),
                     "bias": np.zeros(n, np.float32)},
                    {"mean": np.zeros(n, np.float32),
                     "var": np.ones(n, np.float32)})
        return ({"scale": (0.8 + 0.4 * rng.rand(n)).astype(np.float32),
                 "bias": (0.2 * rng.randn(n)).astype(np.float32)},
                {"mean": (0.3 * rng.randn(n)).astype(np.float32),
                 "var": (0.5 + rng.rand(n)).astype(np.float32)})

    params, batch_stats = {}, {}
    params["temporal_conv"] = {"kernel": uniform((1, 32, 1, f1), 32)}
    params["temporal_bn"], batch_stats["temporal_bn"] = bn(f1)
    params["spatial_conv"] = {"kernel": uniform((c, 1, 1, f2), c)}
    params["spatial_bn"], batch_stats["spatial_bn"] = bn(f2)
    params["separable_depthwise"] = {"kernel": uniform((1, 16, 1, f2), 16)}
    params["separable_pointwise"] = {"kernel": uniform((1, 1, f2, f2), f2)}
    params["block2_bn"], batch_stats["block2_bn"] = bn(f2)
    params["classifier"] = {
        "kernel": uniform((fan_in_cls, N_CLASSES), fan_in_cls),
        "bias": uniform((N_CLASSES,), fan_in_cls)}
    return params, batch_stats


def port_model(params, batch_stats, c, t, f1, d) -> EEGNet:
    """The port's eval-mode EEGNet on the CPU with the JAX weights."""
    model = EEGNet(c, t, F1=f1, D=d, device="cpu")
    model.load_state_dict(from_jax_variables(params, batch_stats))
    return model


def trials(n, c, t, seed=1) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, c, t).astype(np.float32)
