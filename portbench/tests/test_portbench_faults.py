"""A run with the timed path broken underneath reads ``correct`` false:
the look for a card skipped, everything else as a run does it."""

from __future__ import annotations

import pytest

from portbench import faults
from portbench.tests.conftest import run_small, small_cell


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", ["eegnet.cross90", "deepconvnet.within36"])
def test_a_fault_fails_the_comparison(name, fault):
    result, values = run_small(small_cell(name), 4242,
                               faults=faults.FAULTS[fault])
    assert not result["correct"], values


def test_a_sound_run_of_the_same_seed_passes():
    result, _ = run_small(small_cell("eegnet.cross90"), 4242)
    assert result["correct"]
