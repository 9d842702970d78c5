#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card this process finds.

    python3 -m portbench.run --workload eegnet.cross90 --seed 7 \
        --seconds 20 --trace 0

The last line of standard output is the result: ``correct``, ``attempted``
(fold-epochs run in the window), ``failed`` (of those, the ones whose
training or validation loss is not finite), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``compared``: each number the
comparison computed beside its limit, which also end standard error.
Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits non-zero.
"""

import time

T0 = time.perf_counter()    # set-up starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Run as a script, Python puts this folder first on the path, where its
# modules would shadow others of the same name (``trace``): the checkout's
# root takes its place.
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that no run may load: compared whole, since the
# port's own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "eegnetreplication_tpu")


def loaded_forbidden() -> list[str]:
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unread ({exc})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    # The configuration states the schedule; the port's override of "auto"
    # must not pick another one under the benchmark.
    os.environ.pop("EEGTPU_CONV_IMPL", None)
    os.environ["EEGTPU_PLATFORM"] = "cuda"
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result, _ = harness.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 T0)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    compared = result.pop("compared")
    result["device"]["power_limit"] = power_limit()
    result["compared"] = compared
    for name, row in compared.items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
