"""Stitch span journals into per-trace trees:
``python -m eegnetreplication_tpu_torch.obs.trace_report``.

The port's copy of ``scripts/trace_report.py``.  A fleet or cells run
leaves one run directory a process (router or front, and each replica or
cell); every instrumented stage journaled its spans as ``span`` events
carrying a shared ``trace_id`` and cross-process ``parent_span_id`` links
(:mod:`~eegnetreplication_tpu_torch.obs.trace`).  This reads any mix of
journal roots, run dirs and files, groups the spans into traces, and
shows where a slow request spent its time:

- by default, a table (one row a trace: processes, spans, total wall) and
  the waterfall of the slowest trace, the indented span tree with each
  span's offset and duration across process boundaries;
- ``--trace ID``, the waterfall of that trace;
- ``--chrome out.json``, every trace as Chrome trace-event JSON (Perfetto,
  ``chrome://tracing``), one track a process;
- ``--json``, one summary line a trace;
- ``--require-cross-process``, exit 1 unless at least one trace links
  spans parent to child across two or more process journals.

    python -m eegnetreplication_tpu_torch.obs.trace_report reports/obs
    python -m eegnetreplication_tpu_torch.obs.trace_report routerdir replicadir --chrome t.json
    python -m eegnetreplication_tpu_torch.obs.trace_report <fleet workdir> --require-cross-process
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from eegnetreplication_tpu_torch.obs import trace


def trace_summary(tree: trace.TraceTree) -> dict:
    return {"trace_id": tree.trace_id,
            "spans": len(tree.spans),
            "processes": tree.processes,
            "roots": [s["name"] for s in tree.roots],
            "span_names": sorted(tree.span_names),
            "duration_ms": round(tree.duration_ms, 3),
            "linked_spans": len(tree.linked),
            "cross_process": tree.cross_process_complete(),
            "errors": sum(1 for s in tree.spans
                          if s.get("status") != "ok")}


def render_waterfall(tree: trace.TraceTree) -> str:
    """The indented span tree with a time-offset bar per span."""
    if not tree.spans:
        return "(empty trace)"
    t0 = min(s["start"] for s in tree.spans)
    total = max(tree.duration_ms, 1e-9)
    width = 32
    lines = [f"trace {tree.trace_id}  "
             f"({len(tree.spans)} spans, {len(tree.processes)} processes, "
             f"{tree.duration_ms:.1f} ms)"]

    def bar(start_ms: float, dur_ms: float) -> str:
        lo = int(width * start_ms / total)
        hi = max(lo + 1, int(width * (start_ms + dur_ms) / total))
        return "." * lo + "#" * (hi - lo) + "." * max(0, width - hi)

    def walk(span: dict, depth: int) -> None:
        start_ms = (span["start"] - t0) * 1000.0
        status = "" if span.get("status") == "ok" \
            else f"  !{span.get('status')}"
        lines.append(
            f"  [{bar(start_ms, span['dur_ms'])}] "
            f"{'  ' * depth}{span['name']}  "
            f"+{start_ms:.1f}ms {span['dur_ms']:.2f}ms  "
            f"({span.get('run_id', '?')}){status}")
        for child in tree.children.get(span["span_id"], []):
            walk(child, depth + 1)

    for root in tree.roots:
        walk(root, 0)
    for linked in tree.linked:
        start_ms = (linked["start"] - t0) * 1000.0
        lines.append(
            f"  [{bar(start_ms, linked['dur_ms'])}] ~ {linked['name']}  "
            f"+{start_ms:.1f}ms {linked['dur_ms']:.2f}ms  "
            f"(linked, {linked.get('run_id', '?')})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Stitch span journals into per-trace trees.")
    ap.add_argument("paths", nargs="+",
                    help="journal files, run dirs, or roots to scan "
                         "recursively for events.jsonl")
    ap.add_argument("--trace", default=None,
                    help="waterfall this trace id (default: the slowest)")
    ap.add_argument("--chrome", default=None,
                    help="write Chrome trace-event JSON (Perfetto) here")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON summary per trace")
    ap.add_argument("--require-cross-process", action="store_true",
                    help="exit 1 unless >= 1 trace stitches parent->child "
                         "across >= 2 process journals")
    args = ap.parse_args(argv)

    spans = trace.read_spans(args.paths)
    trees = trace.build_traces(spans)
    if not trees:
        print(f"No span events under {args.paths}", file=sys.stderr)
        return 1

    summaries = sorted((trace_summary(t) for t in trees.values()),
                       key=lambda s: -s["duration_ms"])
    if args.json:
        for s in summaries:
            print(json.dumps(s))
    else:
        print(f"{len(trees)} trace(s), {len(spans)} span(s)")
        for s in summaries[:20]:
            flags = ("cross-process" if s["cross_process"] else "local") \
                + (f", {s['errors']} error(s)" if s["errors"] else "")
            print(f"  {s['trace_id']}  {s['spans']:3d} spans  "
                  f"{s['duration_ms']:9.1f} ms  "
                  f"{len(s['processes'])} proc  ({flags})")
        picked = (trees.get(args.trace) if args.trace
                  else trees[summaries[0]["trace_id"]])
        if picked is None:
            print(f"unknown trace id {args.trace!r}", file=sys.stderr)
            return 1
        print()
        print(render_waterfall(picked))

    if args.chrome:
        events = trace.chrome_trace_events(trees)
        Path(args.chrome).write_text(json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}))
        print(f"wrote {args.chrome} ({len(events)} events)")

    if args.require_cross_process:
        stitched = [s for s in summaries if s["cross_process"]]
        if not stitched:
            print("REQUIRE-CROSS-PROCESS FAIL: no trace links spans "
                  "across process journals", file=sys.stderr)
            return 1
        print(f"cross-process traces: {len(stitched)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
