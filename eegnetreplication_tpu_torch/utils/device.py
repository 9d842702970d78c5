"""Device selection: the counterpart of ``utils/platform.py::select_platform``.

The JAX package probes its accelerator and falls back to the CPU when the
probe fails.  The port does not fall back: its entry points run on the
card, and a host without CUDA is an error unless the caller asked for the
CPU.  ``EEGTPU_PLATFORM`` (the same variable the JAX package reads) picks:

- ``cpu``: the CPU (the tests use it);
- unset, ``gpu`` or ``cuda``: ``cuda:0``, or :class:`RuntimeError` when
  CUDA is absent.

Selecting a device also pins float32 numerics once per process: cuDNN
convolutions default to TF32 (about 1e-3 relative error), while the JAX
model computes at ``precision="highest"`` (full f32), so TF32 is switched
off for both cuDNN and cuBLAS.

Selecting the card also makes its runs repeat bit for bit, which the JAX
package promises of a resumed run ("resume WITHIN a fixed grouping
remains bit-identical"): ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before the
first cuBLAS call, ``torch.use_deterministic_algorithms(True)``, and cuDNN
deterministic with its autotuner off.  Deterministic mode's fill of fresh
allocations with NaN is turned off: the port's kernels write every output
element, so the fill would only cost a pass over each new tensor.  The
CPU path is left as it is: it already repeats, and the global flag would
change the other torch code of a process that runs on the CPU.
"""

from __future__ import annotations

import os

import torch

PLATFORM_ENV = "EEGTPU_PLATFORM"

_GPU_NAMES = ("", "gpu", "cuda")


def _pin_f32_numerics() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _pin_determinism() -> None:
    """Bitwise-repeatable runs on the card (see the module docstring)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def select_device() -> torch.device:
    """The device ``EEGTPU_PLATFORM`` names; raises instead of falling back."""
    _pin_f32_numerics()
    platform = os.environ.get(PLATFORM_ENV, "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in _GPU_NAMES:
        raise ValueError(
            f"{PLATFORM_ENV}={platform!r}: the torch port runs on 'cuda' "
            "(alias 'gpu', the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; the torch port does not "
            f"fall back to the CPU (set {PLATFORM_ENV}=cpu to run there)")
    _pin_determinism()
    return torch.device("cuda", 0)


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` selects one through
    :func:`select_device`."""
    if device is None:
        return select_device()
    _pin_f32_numerics()
    device = torch.device(device)
    if device.type == "cuda":
        _pin_determinism()
    return device
