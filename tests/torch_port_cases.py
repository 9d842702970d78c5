"""Shared inputs for the torch port's parity tests (``test_torch_*.py``).

Every input is drawn with numpy from a seed and handed to both packages:
the JAX package's EEGNet variables (flax names and layouts, numpy leaves)
and the same weights carried into the port's ``EEGNet`` through
``training/checkpoint.py::from_jax_variables``.  The tree is drawn directly
rather than through ``model.init`` (which compiles): ``test_torch_model``
pins that it has exactly the structure and shapes ``model.init`` makes.

Importing this module caps torch's intra-op threads at one per process.
The tier-1 run puts six test workers on eight cores, and a full thread pool
in each port worker slows every other worker; the port's tests run at a
small size, where one thread costs them little.  Every
``tests/test_torch_*.py`` imports this module, and the CLI processes they
start get ``OMP_NUM_THREADS=1`` (:func:`child_env`).  The JAX package is
imported only where a case needs it, so ``test_torch_gpu.py`` can import
this module on the card's machine, which has no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.training.checkpoint import from_jax_variables

torch.set_num_threads(1)


def child_env(base=None, **extra) -> dict:
    """The environment of a CLI process a port test starts: ``base``
    (default ``os.environ``) with one OpenMP thread and ``extra``."""
    env = dict(os.environ if base is None else base)
    env.update(OMP_NUM_THREADS="1", **extra)
    return env

# (C, T, F1, D): the product width, an even T, the wide width, a small one.
PRODUCT = (22, 257, 8, 2)
GEOMETRIES = {
    "product": PRODUCT,
    "t256": (22, 256, 8, 2),
    "wide": (22, 257, 16, 4),
    "small": (8, 64, 8, 2),
}
N_CLASSES = 4


def jax_model(c, t, f1, d):
    from eegnetreplication_tpu.models import EEGNet as JaxEEGNet

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


# --- Preprocessing slice ---------------------------------------------------

# EMS inputs of tests/test_ems.py: name -> (shape, kwargs, seed, constant).
EMS_CASES = {
    "signal_4x3000": ((4, 3000), {}, 0, None),
    "ragged_3x700": ((3, 700), {}, 7, None),
    "single_1x500_init100": ((1, 500), {"init_block_size": 100}, 2, None),
    "short_2x50_init_past_T": ((2, 50), {}, 3, None),
    "constant_3x400": ((3, 400), {"init_block_size": 100}, 0, 5.0),
}


def ems_input(name) -> tuple[np.ndarray, dict]:
    """``(x, kwargs)`` of one EMS case, drawn with numpy from its seed."""
    shape, kwargs, seed, constant = EMS_CASES[name]
    if constant is not None:
        return np.full(shape, constant, np.float32), dict(kwargs)
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if name == "signal_4x3000":
        x = x * 5.0 + 2.0
    return x.astype(np.float32), dict(kwargs)


def numpy_ems_reference(x, factor_new=1e-3, init_block_size=1000,
                        eps=1e-10):
    """Sequential float64 evaluation of the EMS recurrences (the ground
    truth of tests/test_ems.py)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    mean = np.mean(x[..., :init_block_size], axis=-1)
    var = np.var(x[..., :init_block_size], axis=-1)
    a = factor_new
    for t in range(x.shape[-1]):
        mean = (1 - a) * mean + a * x[..., t]
        var = (1 - a) * var + a * (x[..., t] - mean) ** 2
        out[..., t] = (x[..., t] - mean) / np.sqrt(var + eps)
    return out


def write_raw_tree(write_gdf, raw, subjects=(1, 4), seconds=40,
                   n_trials=8, seed=0):
    """The small synthetic competition tree of tests/test_data_pipeline.py
    under ``raw``, written with the given package's ``write_gdf``:
    25-channel 250 Hz sessions, cues 769-772 in Train and 783 in Eval, and
    ``TrueLabels/A0sE.mat``."""
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    sfreq = 250.0
    n = int(sfreq * seconds)
    for s in subjects:
        for mode in ("Train", "Eval"):
            sig = rng.uniform(-0.5, 0.5, (25, n)).astype(np.float32)
            pos = (np.arange(n_trials) * 1100 + 300).astype(np.int64)
            if mode == "Train":
                typ = np.array([769, 770, 771, 772] * (n_trials // 4))
            else:
                typ = np.full(n_trials, 783)
            sess = "T" if mode == "Train" else "E"
            write_gdf(raw / mode / f"A{s:02d}{sess}.gdf", sig, sfreq,
                      event_pos=pos, event_typ=typ)
            if mode == "Eval":
                tl = raw / "TrueLabels"
                tl.mkdir(parents=True, exist_ok=True)
                savemat(tl / f"A{s:02d}E.mat",
                        {"classlabel": rng.randint(1, 5, n_trials)})


def recording_with_nan(c=25, t=5000, seed=5) -> tuple[np.ndarray, np.ndarray,
                                                       np.ndarray]:
    """``(signals, event_pos, event_typ)`` of a 250 Hz recording with a NaN
    span, like the competition's artifact marks."""
    rng = np.random.RandomState(seed)
    sig = (rng.randn(c, t) * 10.0 + 3.0).astype(np.float32)
    sig[2, 1000:1200] = np.nan
    pos = np.array([300, 1301, 2602, 3903], np.int64)
    typ = np.array([769, 770, 771, 772], np.int64)
    return sig, pos, typ


def write_processed_tree(root, subjects=(1, 2), n_trials=24, nan_in=None):
    """``-trials.npz`` files of ``tests/synthetic.py``'s separable subjects
    (C=4, T=64) under ``<root>/data/processed/{Train,Eval}``, what the train
    CLI reads with ``EEGTPU_DATA_ROOT=<root>``; ``nan_in=s`` puts a NaN in
    four of subject ``s``'s Train trials (from the middle on)."""
    from pathlib import Path

    from synthetic import make_loader

    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import (
        save_trials,
        trials_filename,
    )

    loader = make_loader(n_trials=n_trials, n_channels=4, n_times=64,
                         class_sep=1.5)
    for s in subjects:
        for mode in ("Train", "Eval"):
            ds = loader(s, mode)
            x = ds.X.copy()
            if s == nan_in and mode == "Train":
                x[len(x) // 2:len(x) // 2 + 4, 0, 0] = np.nan
            save_trials(BCICI2ADataset(X=x, y=ds.y),
                        Path(root) / "data" / "processed" / mode
                        / trials_filename(s, mode))
