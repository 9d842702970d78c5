"""One percentile, shared by the port's telemetry readers.

The port's copy of ``eegnetreplication_tpu/obs/stats.py``: the adaptive
admission controller's queue-wait p95 and the tests' cross-checks of the
bucketed histogram quantiles use it, so both packages estimate the same
tail from the same sample.
"""

from __future__ import annotations

from typing import Iterable


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-quantile (``0 <= q <= 1``) of ``values`` with linear
    interpolation between closest ranks (numpy's default method).
    Sorts a copy; returns 0.0 for an empty sample."""
    data = sorted(float(v) for v in values)
    if not data:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be within [0, 1], got {q}")
    pos = q * (len(data) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(data) - 1)
    frac = pos - lo
    return data[lo] + (data[hi] - data[lo]) * frac
