"""The readings that the limits of ``limits/<workload>.json`` are set from,
at the cell's own size, on the card, in one process:

    python3 -m portbench.readings --workload eegnet.cross90 \
        --seeds 12 --controlSeeds 3 --faultSeeds 3 --out readings.json

For each seed it runs the set-up and one window epoch of the cell, follows
it with the reference and records every number ``check.numbers`` computes:
``--seeds`` sound runs, ``--controlSeeds`` runs of the control (the
program's own TF32 path, ``precision="high"``, the step below the stated
``highest``), and ``--faultSeeds`` runs of each fault in ``faults.py``.
The seeds are drawn from ``--base``, which no benchmark run uses.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controlSeeds", type=int, default=3)
    parser.add_argument("--faultSeeds", type=int, default=3)
    parser.add_argument("--faults",
                        default="half_batch,altered_answer,unchanged")
    parser.add_argument("--base", type=int, default=3_000_000_000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    os.environ.pop("EEGTPU_CONV_IMPL", None)
    import torch

    from portbench import check, drive, faults, harness, spec

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    plan = [("sound", None, None)] * args.seeds
    plan += [("control", "high", None)] * args.controlSeeds
    for name in filter(None, args.faults.split(",")):
        plan += [(name, None, faults.FAULTS[name])] * args.faultSeeds
    follow_s = []

    def timed(follow):
        def run(*a, **k):
            t = time.perf_counter()
            out = follow(*a, **k)
            torch.cuda.synchronize()
            follow_s.append(time.perf_counter() - t)
            return out
        return run

    rows = []
    for i, (kind, precision, fault) in enumerate(plan):
        seed = args.base + 7919 * i
        t0 = time.perf_counter()
        with drive.patched(check, "follow", timed):
            result, values = harness.run_cell(
                cell, seed, 0.0, False, device, t0, precision=precision,
                faults=fault or contextlib.nullcontext)
        row = {"kind": kind, "seed": seed, "values": values,
               "correct": result["correct"],
               "seconds": time.perf_counter() - t0,
               "reference_s": follow_s[-1]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    summary = {}
    for kind in dict.fromkeys(r["kind"] for r in rows):
        mine = [r["values"] for r in rows if r["kind"] == kind]
        summary[kind] = {name: {"max": max(v[name] for v in mine),
                                "min": min(v[name] for v in mine)}
                         for name in mine[0]}
    out = {"workload": args.workload,
           "device": torch.cuda.get_device_name(0), "rows": rows,
           "summary": summary}
    print(json.dumps(summary, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
