"""The traced run: ``torch.profiler`` over the window, its events kept in
memory and reduced to what the per-layer readers need.

The harness puts ``record_function`` ranges, from its own code, around the
calls into each layer (``portbench.window``, ``portbench.epoch``,
``portbench.slot_source``, ``portbench.train_step``,
``portbench.eval_step``).  A device operation belongs to a range when the
runtime call that launched it (``cudaLaunchKernel`` and kin, matched by
the CUPTI correlation id) started inside that range.  Device time is the
union of the device operations' intervals inside the window, of all of
them or of a range's.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"


@dataclass
class Summary:
    """The reduced trace.  Times in nanoseconds on the profiler's clock."""

    window: tuple[int, int]
    # every device operation inside the window: (start, end, name, range)
    ops: list[tuple[int, int, str, str | None]] = field(default_factory=list)
    # how often each range was entered inside the window
    calls: dict[str, int] = field(default_factory=dict)
    # the union of the device operations' intervals
    busy: list[tuple[int, int]] = field(default_factory=list)
    # each named range's (starts, ends), sorted, innermost name first
    lookup: dict[str, tuple[list[int], list[int]]] = field(
        default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def owner(self, t: int) -> str | None:
        """The innermost harness range the host was in at ``t``."""
        for name, (starts, ends) in self.lookup.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and ends[i] >= t:
                return name
        return None

    def device_s(self, in_range: str | None = None) -> float:
        """Device time (the union of the operations' intervals: cuDNN
        runs some on streams of its own, at once) of the operations
        launched inside ``in_range``, or of all."""
        if in_range is None:
            return self.busy_s
        return sum(b - a for a, b in _union(
            (a, b) for a, b, _, r in self.ops if r == in_range)) / 1e9

    def by_name(self) -> dict[str, list[float]]:
        """Each device operation's durations in seconds, by name."""
        out: dict[str, list[float]] = defaultdict(list)
        for a, b, name, _ in self.ops:
            out[name].append((b - a) / 1e9)
        return out

    def gaps(self) -> list[tuple[int, int]]:
        """The idle intervals of the window."""
        out, at = [], self.window[0]
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events, range_names) -> Summary:
    """Reduce the profiler's raw events (``kineto_results.events()``);
    ``range_names`` are the harness's ranges, innermost first."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges: dict[str, list[tuple[int, int]]] = defaultdict(list)
    launches: dict[int, int] = {}
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name.startswith(PREFIX) or e.is_user_annotation():
                continue
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), name,
                           e.correlation_id()))
        elif name.startswith(PREFIX):
            start = e.start_ns()
            ranges[name].append((start, start + e.duration_ns()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    if not ranges.get(WINDOW):
        raise RuntimeError("the trace holds no window range")
    window = ranges[WINDOW][0]
    lookup = {}
    for name in range_names:
        spans = sorted(ranges.get(name, []))
        lookup[name] = ([a for a, _ in spans], [b for _, b in spans])
    summary = Summary(window, lookup=lookup, calls={
        name: sum(1 for a, _ in spans if window[0] <= a <= window[1])
        for name, spans in ranges.items()})
    for a, b, name, corr in device:
        a, b = max(a, window[0]), min(b, window[1])
        if b <= a:
            continue
        launched = launches.get(corr)
        summary.ops.append((a, b, name, None if launched is None
                            else summary.owner(launched)))
    summary.busy = _union([(a, b) for a, b, *_ in summary.ops])
    return summary


def breakdown(summary: Summary, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, in seconds."""
    ops = sorted(((name[:120], sum(v)) for name, v in
                  summary.by_name().items()), key=lambda kv: -kv[1])[:top]
    idle: dict[str, float] = defaultdict(float)
    for a, b in summary.gaps():
        host = summary.owner(a)
        idle[host[len(PREFIX):] if host else "outside the layers"] += (
            (b - a) / 1e9)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def profiler():
    """``torch.profiler`` of CPU and CUDA activity, events in memory."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def events(prof) -> list:
    """The raw events of a closed :func:`profiler`."""
    return prof.profiler.kineto_results.events()


def ranged(name: str, fn):
    """``fn`` inside a ``record_function`` range ``portbench.<name>``."""
    label = PREFIX + name

    def call(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return call
