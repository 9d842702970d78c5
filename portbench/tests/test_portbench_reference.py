"""The plain reference against the port on the CPU, at a few folds and
steps: the set-up's epochs agree within the committed limits, and the
frozen FLOP counts are the port's."""

from __future__ import annotations

import pytest

from portbench import harness, spec
from portbench.reference import protocol
from portbench.reference.training import model_module
from portbench.tests.conftest import run_small, small_cell

CELLS = ["eegnet.cross90", "deepconvnet.within36"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port(name):
    cell = small_cell(name)
    result, values = run_small(cell, 2 ** 31 + 12345)
    assert result["correct"], result["compared"]
    assert values["loss"] < 1e-4 and values["grad1"] < 1e-4
    assert values["val_hits"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_layers(name):
    result, _ = run_small(small_cell(name), 77, traced=True)
    assert result["correct"]
    assert result["metrics"]["real_slot_share"]["value"] <= 1.0
    assert result["metrics"]["fold_setup_s"]["value"] > 0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("name", CELLS)
def test_frozen_flops_are_the_ports(name):
    from eegnetreplication_tpu_torch.models import get_model
    from eegnetreplication_tpu_torch.utils import flops

    cell = spec.cell(name)
    cfg = cell.config
    model = get_model(cfg["model"], n_channels=cfg["n_channels"],
                      n_times=cfg["n_times"], device="cpu",
                      **cfg["model_kwargs"])
    mod = model_module(cfg["reference"])
    assert mod.train_step_flops(cfg, 64) == flops.train_step_flops(model, 64)
    assert mod.eval_step_flops(cfg, 64) == flops.eval_step_flops(model, 64)
    assert harness.fold_epoch_flops(cell, 1440, 864) == pytest.approx(
        flops.fold_epoch_flops(model, batch_size=64, train_pad=1440,
                               val_pad=864))


def test_the_folds_are_the_protocols():
    """The reference's folds equal the port's protocol functions' over the
    same pool layouts, at the cells' full size."""
    import numpy as np

    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
    from eegnetreplication_tpu_torch.training import protocols

    for name in CELLS:
        traffic = small_cell(name).traffic
        full = {**traffic, "subjects": 9, "trials_per_session": 288,
                "repeats_per_subject": 10}
        ours = protocol.folds_of(full)
        offs = protocol.session_offsets(9, 2, 288, full["pool_layout"])
        if full["protocol"] == "cross_subject":
            theirs = protocols.cross_subject_folds(
                [o[0] for o in offs], [o[1] for o in offs],
                tuple(range(1, 10)), DEFAULT_TRAINING)
            assert len(ours) == 90
        else:
            theirs = protocols.within_subject_folds(
                [np.concatenate(o) for o in offs], DEFAULT_TRAINING)
            assert len(ours) == 36
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
