"""Exponential moving standardization (EMS) along time.

The counterpart of ``eegnetreplication_tpu/ops/ems.py``
(``exponential_moving_standardize`` and
``raw_exponential_moving_standardize``).  Per-channel EMAs of the mean and
the variance, seeded from the statistics of the first ``init_block_size``
samples (biased variance), with ``eps`` inside the square root:

    m_t = (1 - a) m_{t-1} + a x_t
    v_t = (1 - a) v_{t-1} + a (x_t - m_t)^2
    out_t = (x_t - m_t) / sqrt(v_t + eps)

Three numerically equivalent formulations, picked by ``method``, with the
JAX package's names and default:

- ``"associative"``: both recurrences as parallel prefix scans.  Torch has
  no public associative scan, so it is a doubling (Hillis-Steele) scan over
  time: pass ``k`` adds ``c^(2^k)`` times the value ``2^k`` samples back,
  ``ceil(log2 T)`` passes;
- ``"scan"``: the sequential recurrence, one step per sample from a fresh
  carry: the carry kernel K2s on the card
  (:func:`~eegnetreplication_tpu_torch.ops.ems_kernel.ems_stream`, one
  launch, in f32), its plain per-sample loop on the CPU;
- ``"pallas"``: the single-pass kernel, K2 on the card
  (:func:`~eegnetreplication_tpu_torch.ops.ems_kernel.ems`), its plain
  version on the CPU; ``(C, T)`` inputs only.

:class:`StreamingEMS` carries the ``scan`` recurrences across the chunks of
a live stream (the JAX package's ``StreamingEMS``): any chunking gives the
bits of the one-shot ``scan`` on the same device.  ``ems_time_sharded`` is
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops.ems_kernel import (
    ems,
    ems_stream,
    f32_coefficients,
    seed_stats,
)
from eegnetreplication_tpu_torch.utils.device import resolve_device

METHODS = ("associative", "scan", "pallas")


def _linear_recurrence_doubling(inputs: torch.Tensor, c: float,
                                init: torch.Tensor) -> torch.Tensor:
    """Solve ``s_t = c s_{t-1} + inputs_t`` along the last axis with
    ``s_{-1} = init`` by a doubling scan."""
    t_total = inputs.shape[-1]
    s = inputs
    shift = 1
    while shift < t_total:
        # c^shift in float64, rounded to the tensor's dtype by the multiply.
        s = torch.cat([s[..., :shift],
                       s[..., shift:] + c ** shift * s[..., :-shift]], dim=-1)
        shift *= 2
    steps = torch.arange(1, t_total + 1, dtype=torch.float64,
                         device=inputs.device)
    decay = (c ** steps).to(inputs.dtype)      # c^(t+1)
    return decay * init[..., None] + s


def exponential_moving_standardize(
    x: torch.Tensor,
    factor_new: float = 1e-3,
    init_block_size: int = 1000,
    eps: float = 1e-10,
    method: str = "associative",
) -> torch.Tensor:
    """Exponentially-moving standardize ``x (..., T)`` along its last axis.

    ``method`` is ``"associative"`` (the default), ``"scan"`` (on the
    card one K2s launch, computed in f32 and cast back) or ``"pallas"``
    (K2; ``(C, T)`` only, computed in f32 and cast back).
    Returns a tensor of ``x``'s shape and dtype on ``x``'s device.
    """
    if method not in METHODS:
        raise ValueError(f"Unknown EMS method: {method!r}")
    if method == "pallas":
        if x.dim() != 2:
            raise ValueError(
                f"EMS method 'pallas' expects (C, T), got {tuple(x.shape)}")
        out = ems(x.to(torch.float32).contiguous(), factor_new=factor_new,
                  init_block_size=init_block_size, eps=eps)
        return out.to(x.dtype)

    if method == "scan":
        return scan_with_carry(x, factor_new, init_block_size, eps)[0]

    a, c = f32_coefficients(factor_new)
    mean0, var0 = seed_stats(x, init_block_size)

    # The mean recurrence runs on the init-mean-centred signal: the same
    # affine recurrence, exact for constant inputs in f32.
    z = x - mean0[..., None]
    means = _linear_recurrence_doubling(a * z, c, torch.zeros_like(mean0))
    dev = z - means
    variances = _linear_recurrence_doubling(a * torch.square(dev), c, var0)
    return dev / torch.sqrt(variances + eps)


def scan_with_carry(x: torch.Tensor, factor_new: float = 1e-3,
                    init_block_size: int = 1000, eps: float = 1e-10
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``"scan"`` method with its final carry: ``(out, m, v)``, ``m``
    and ``v`` shaped ``x.shape[:-1]``.  One
    :func:`~eegnetreplication_tpu_torch.ops.ems_kernel.ems_stream` call
    from a fresh carry (``m = 0``, ``v = var0``): K2s on the card, computed
    in f32 and cast back to ``x``'s dtype; the plain loop on the CPU."""
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if x.device.type == "cuda":
        rows = rows.to(torch.float32).contiguous()
    mean0, var0 = seed_stats(rows, init_block_size)
    m = torch.zeros_like(mean0)
    v = var0.clone()
    out = ems_stream(rows, mean0, m, v, factor_new, eps)
    return (out.to(x.dtype).reshape(shape), m.reshape(shape[:-1]),
            v.reshape(shape[:-1]))


class StreamingEMS:
    """Chunk-resumable EMS carrier: the JAX package's ``StreamingEMS``.

    Feed ``(C, n)`` chunks to :meth:`push` and it returns the standardized
    samples, the bits of the one-shot ``method="scan"`` over the whole
    stream on the same device however the stream was chunked (one sample
    at a time included): each chunk is one
    :func:`~eegnetreplication_tpu_torch.ops.ems_kernel.ems_stream` call
    from the carried ``(m, v)``, and a split only moves where the carry is
    stored.

    Until ``init_block_size`` samples have arrived the carrier buffers raw
    input (on the host) and emits nothing; the seeding push computes the
    seed statistics of the first block and emits the whole backlog.
    :meth:`flush` seeds a stream shorter than the block from what arrived.

    The seed mean and the carry live on ``device`` (``None`` selects one
    through ``utils/device.py``); each push copies its chunk there and the
    standardized samples back.  :meth:`state_arrays` and
    :meth:`from_state` round-trip the whole state as host numpy with the
    JAX carrier's keys and dtypes, so either package continues the
    other's stream.
    """

    def __init__(self, n_channels: int, factor_new: float = 1e-3,
                 init_block_size: int = 1000, eps: float = 1e-10, *,
                 device: torch.device | str | None = None):
        if n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {n_channels}")
        if init_block_size < 1:
            raise ValueError(
                f"init_block_size must be >= 1, got {init_block_size}")
        self.n_channels = int(n_channels)
        self.factor_new = float(factor_new)
        self.init_block_size = int(init_block_size)
        self.eps = float(eps)
        self.device = resolve_device(device)
        self.n_seen = 0
        self._buf: np.ndarray = np.zeros((self.n_channels, 0), np.float32)
        self._mean0: torch.Tensor | None = None  # seeded <=> not None
        self._m: torch.Tensor | None = None
        self._v: torch.Tensor | None = None

    # -- introspection ----------------------------------------------------
    @property
    def seeded(self) -> bool:
        return self._mean0 is not None

    @property
    def n_emitted(self) -> int:
        """Samples standardized and handed back so far."""
        return self.n_seen if self.seeded else 0

    # -- streaming --------------------------------------------------------
    def _check_chunk(self, chunk) -> np.ndarray:
        x = np.asarray(chunk, np.float32)
        if x.ndim != 2 or x.shape[0] != self.n_channels:
            raise ValueError(
                f"expected a ({self.n_channels}, n) chunk, got "
                f"{tuple(np.shape(chunk))}")
        return x

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.require(x, np.float32, ("C", "W"))).to(
            self.device)

    def _seed_and_run(self, buffered: np.ndarray, block: int) -> np.ndarray:
        x = self._to_device(buffered)
        mean0, var0 = seed_stats(x, block)
        self._mean0 = mean0
        self._m = torch.zeros_like(mean0)
        self._v = var0.contiguous()
        self._buf = np.zeros((self.n_channels, 0), np.float32)
        return self._advance(x)

    def _advance(self, x: torch.Tensor) -> np.ndarray:
        out = ems_stream(x, self._mean0, self._m, self._v, self.factor_new,
                         self.eps)
        return out.cpu().numpy()

    def push(self, chunk) -> np.ndarray:
        """Ingest a ``(C, n)`` chunk; return the ``(C, k)`` standardized
        samples this push released (``k = 0`` while the seed block is
        still filling, then the whole backlog on the seeding push, then
        ``k = n``)."""
        x = self._check_chunk(chunk)
        self.n_seen += x.shape[1]
        if self.seeded:
            if x.shape[1] == 0:
                return x
            return self._advance(self._to_device(x))
        self._buf = np.concatenate([self._buf, x], axis=1)
        if self._buf.shape[1] < self.init_block_size:
            return np.zeros((self.n_channels, 0), np.float32)
        return self._seed_and_run(self._buf, self.init_block_size)

    def flush(self) -> np.ndarray:
        """Seed from a short (< ``init_block_size``) buffered stream and
        emit it: the offline ``block = min(init_block_size, T)`` behaviour
        for a stream that ended early.  No-op when already seeded or
        nothing arrived."""
        if self.seeded or self._buf.shape[1] == 0:
            return np.zeros((self.n_channels, 0), np.float32)
        return self._seed_and_run(self._buf, self._buf.shape[1])

    # -- snapshot state ---------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        """The complete carrier state as a flat mapping of host ndarrays
        (the JAX carrier's keys and dtypes)."""
        zeros = np.zeros(self.n_channels, np.float32)

        def host(t: torch.Tensor | None) -> np.ndarray:
            return zeros if t is None else t.cpu().numpy()

        return {
            "n_channels": np.asarray(self.n_channels, np.int64),
            "factor_new": np.asarray(self.factor_new, np.float64),
            "init_block_size": np.asarray(self.init_block_size, np.int64),
            "eps": np.asarray(self.eps, np.float64),
            "n_seen": np.asarray(self.n_seen, np.int64),
            "seeded": np.asarray(self.seeded, np.bool_),
            "buf": self._buf,
            "mean0": host(self._mean0),
            "m": host(self._m),
            "v": host(self._v),
        }

    @classmethod
    def from_state(cls, flat: dict, *,
                   device: torch.device | str | None = None
                   ) -> "StreamingEMS":
        """Rebuild a carrier from :meth:`state_arrays` output (either
        package's) on ``device``; pushing the rest of the stream through
        it continues the recurrences bit for bit."""
        ems = cls(int(flat["n_channels"]), float(flat["factor_new"]),
                  int(flat["init_block_size"]), float(flat["eps"]),
                  device=device)
        ems.n_seen = int(flat["n_seen"])
        ems._buf = np.asarray(flat["buf"], np.float32)
        if bool(flat["seeded"]):
            ems._mean0, ems._m, ems._v = (
                ems._to_device(np.asarray(flat[k], np.float32))
                for k in ("mean0", "m", "v"))
        return ems


def raw_exponential_moving_standardize(
    x: np.ndarray, factor_new: float = 0.001, init_block_size: int = 1000,
    method: str = "associative", *, device: torch.device | str | None = None,
) -> np.ndarray:
    """Numpy-in/numpy-out EMS with the reference's signature
    (``dataset.py:45-70``): computes in f32 on ``device`` (``None`` selects
    one through ``utils/device.py``) and casts back to ``x``'s dtype."""
    x = np.asarray(x)
    dev = resolve_device(device)
    xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    out = exponential_moving_standardize(
        xt, factor_new=float(factor_new), init_block_size=int(init_block_size),
        method=method)
    return out.cpu().numpy().astype(x.dtype, copy=False)
