"""Where the serving engine's and the training loop's time goes on the card.

The counterpart of ``eegnetreplication_tpu/utils/profiling.py`` for the
torch port: :func:`trace` profiles a block with ``torch.profiler`` (CPU and
CUDA activity) and writes a Chrome trace (``chrome://tracing`` or
Perfetto open it) under its log directory, what ``train --profileDir``
wraps the whole training call in; :func:`engine_breakdown` splits
``InferenceEngine.infer``
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
import os
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def _profile():
    """Profile the enclosed block with ``torch.profiler`` (CPU + CUDA);
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


@contextlib.contextmanager
def trace(log_dir: str | Path | None):
    """Profile the enclosed block and write its Chrome trace to
    ``<log_dir>/trace-<pid>.json`` (a no-op when ``log_dir`` is None).
    Yields the path the trace is written to, or None."""
    if not log_dir:
        yield None
        return
    from eegnetreplication_tpu_torch.utils.logging import logger

    path = Path(log_dir) / f"trace-{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    logger.info("torch.profiler trace -> %s", path)
    prof = None
    try:
        with _profile() as prof:
            yield path
    finally:
        # Also when the block raised (a stop request, a fault): the trace
        # of what ran is what a debugging run is for.
        if prof is not None:
            prof.export_chrome_trace(str(path))
            logger.info("torch.profiler trace written to %s (%.1f MB)",
                        path, path.stat().st_size / 1e6)


def _device_events(prof):
    """The device's activity: kernels and copies, not the ranges a
    ``record_function`` (a layer span of ``obs/trace.py``) draws over them
    on the device's timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


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


def breakdown(fn, n_calls: int = 1, top: int = 8,
              names: bool = False) -> dict:
    """Host wall and device time of ``fn()``, per call, under the profiler
    (warm ``fn`` up first); with ``names``, every device activity's full
    name too (``device_names``).

    Device busy time is the union of the intervals of the CUDA activity
    the profiler records (kernels and copies; cuDNN may run some on streams
    of its own, so they can overlap), and the idle share is the part of the
    host-clock wall outside it; the per-kernel times are sums.
    """
    torch.cuda.synchronize()
    with _profile() as prof:
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
        **({"device_names": sorted(by_name)} if names else {}),
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
