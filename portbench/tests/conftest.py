"""Shared pieces of the benchmark's own tests, which run on the CPU:

    EEGTPU_PLATFORM=cpu python -m pytest portbench/tests -q

The card's tests carry the ``gpu`` marker and skip without a card.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("EEGTPU_PLATFORM", "cpu")
torch.set_num_threads(2)

from portbench import harness, spec  # noqa: E402

# Each cell cut to a size the CPU runs in seconds: the protocol, the model's
# widths and every rule stay; subjects, trials and the batch shrink.
SMALL = {
    "cross90": dict(subjects=7, trials_per_session=8, repeats_per_subject=1,
                    batch_size=16),
    "within36": dict(subjects=2, trials_per_session=16, batch_size=8),
}


def small_cell(name: str, root: Path = ROOT) -> spec.Cell:
    cell = spec.cell(name, root)
    traffic = name.split(".", 1)[1]
    cell.traffic = {**cell.traffic, **SMALL[traffic]}
    return cell


def run_small(cell: spec.Cell, seed: int, **kw):
    return harness.run_cell(cell, seed, 0.0, kw.pop("traced", False), "cpu",
                            time.perf_counter(), **kw)
