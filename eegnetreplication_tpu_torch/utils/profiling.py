"""Where the serving engine's and the training loop's time goes on the card.

The counterpart of ``eegnetreplication_tpu/utils/profiling.py`` for the
torch port: :func:`trace` wraps a block in ``torch.profiler`` (CPU and
CUDA activity); :func:`engine_breakdown` splits ``InferenceEngine.infer``
at one bucket, and :func:`breakdown` any callable (``chip_smoke.py`` gives
it one training epoch), into host wall time, device busy time by kernel
name, and the device's idle share.  Run on a card:

    python -m eegnetreplication_tpu_torch.utils.profiling [--out FILE]

It serves a seeded EEGNet (product width 22x257) at each bucket of the
default ladder and prints one JSON object per bucket.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace():
    """Profile the enclosed block with ``torch.profiler`` (CPU + CUDA);
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _union_us(spans) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def engine_breakdown(engine, trials: np.ndarray, n_calls: int = 50,
                     top: int = 8) -> dict:
    """Host wall and device time of ``engine.infer(trials)``, per call."""
    for _ in range(5):
        engine.infer(trials)
    return dict(n_trials=int(len(trials)),
                **breakdown(lambda: engine.infer(trials), n_calls, top))


def breakdown(fn, n_calls: int = 1, top: int = 8) -> dict:
    """Host wall and device time of ``fn()``, per call, under the profiler
    (warm ``fn`` up first).

    Device busy time is the union of the intervals of the CUDA activity
    the profiler records (kernels and copies; cuDNN may run some on streams
    of its own, so they can overlap), and the idle share is the part of the
    host-clock wall outside it; the per-kernel times are sums.
    """
    torch.cuda.synchronize()
    with trace() as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_calls
    by_name: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    spans = []
    for e in _device_events(prof):
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / n_calls
        counts[e.name] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy_ms = _union_us(spans) / 1e3 / n_calls
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms_per_call": wall_ms,
        "device_busy_ms_per_call": busy_ms,
        "device_kernel_ms_sum_per_call": sum(by_name.values()),
        "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                              if busy_ms else None),
        "device_ops_per_call": sum(counts.values()) / n_calls,
        "top_device_ms_per_call": [
            {"name": name[:80], "ms": ms, "per_call": counts[name] / n_calls}
            for name, ms in ranked],
    }


def main(argv=None) -> int:
    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.serve.engine import (
        DEFAULT_BUCKETS,
        InferenceEngine,
    )
    from eegnetreplication_tpu_torch.utils.device import select_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--calls", type=int, default=50)
    args = parser.parse_args(argv)
    device = select_device()
    model = EEGNet(device="cpu", generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, device=device)
    engine.warmup()
    rng = np.random.RandomState(1)
    results = []
    for b in DEFAULT_BUCKETS:
        x = rng.randn(b, model.n_channels, model.n_times).astype(np.float32)
        row = dict(bucket=b, **engine_breakdown(engine, x, args.calls))
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"device": torch.cuda.get_device_name(0), "buckets": results},
            indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
