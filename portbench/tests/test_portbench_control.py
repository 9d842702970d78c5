"""The control, on the card: the program's own TF32 path (``precision
"high"``), the step below the ``highest`` the traffic states, reads
``correct`` false against the committed limits, where the same seeds read
true.  At the cells' own size the readings come from ``readings.py``;
this keeps the check at a size a test run holds."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import small_cell

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["eegnet.cross90", "deepconvnet.within36"])
def test_the_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = small_cell(name)
    cell.traffic = {**cell.traffic, "trials_per_session": 64,
                    "batch_size": 32}
    device = torch.device("cuda", 0)
    for seed in SEEDS:
        sound, _ = harness.run_cell(cell, seed, 0.0, False, device, 0.0)
        control, values = harness.run_cell(cell, seed, 0.0, False, device,
                                           0.0, precision="high")
        assert sound["correct"], sound["compared"]
        assert not control["correct"], values
