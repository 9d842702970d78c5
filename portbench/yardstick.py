"""The published peaks, and the operations and bytes of the kernels whose
share of the roofline the benchmark reads.

Peaks: NVIDIA's H100 data sheet, dense, without sparsity.  Under the
``highest`` numerics mode the port runs f32 with TF32 off, on the CUDA
cores, so its peak is the FP32 rate.  The rates assume the card's full
power limit; the result names the card's limit beside them.
"""

from __future__ import annotations

# (substring of torch.cuda.get_device_name, lower case) -> (FP32 FLOP/s,
# HBM bytes/s); the first match wins.
PEAKS = (
    ("h100 pcie", 51.2e12, 2.0e12),
    ("h100", 66.9e12, 3.35e12),
)


def peaks(device_kind: str) -> tuple[float, float] | None:
    """``(FP32 FLOP/s, bytes/s)`` of the card, or None for a card the table
    does not know."""
    kind = device_kind.lower()
    for needle, flops, bandwidth in PEAKS:
        if needle in kind:
            return flops, bandwidth
    return None


def block1_stacked(trials: int, c: int, t: int, f2: int, sets: int,
                   taps: int = 32, pool: int = 4) -> tuple[float, float]:
    """``(bytes, FLOPs)`` of one K1-stacked launch: the trials read once,
    ``sets`` weight sets (the ``(F2, C)`` mix, the taps and the affine)
    read once, an int32 set index per trial, the pooled output written
    once; the mix, the taps, the affine, ELU and the pool as the input
    needs them."""
    t_used = pool * (t // pool)
    nbytes = 4 * (trials * c * t + sets * f2 * (c + taps + 2)
                  + trials * f2 * (t // pool) + trials)
    flops = (2 * trials * f2 * c * t + 2 * trials * f2 * taps * t_used
             + 2 * trials * f2 * t_used + trials * f2 * t_used
             + trials * f2 * t_used)
    return float(nbytes), float(flops)


def bound_s(nbytes: float, flops: float, device_kind: str) -> float | None:
    """The least time the card could take: the larger of the bytes over the
    bandwidth and the operations over the FP32 peak."""
    peak = peaks(device_kind)
    if peak is None:
        return None
    return max(nbytes / peak[1], flops / peak[0])
