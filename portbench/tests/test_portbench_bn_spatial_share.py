"""``metrics/bn_spatial_train_share.py`` on a synthetic layer record: the
share of train steps whose forward ran the fused BatchNorm and spatial
convolution's kernels, and nothing where a counter is missing (the port
before it counted either) or no step ran."""

from __future__ import annotations

import pytest

from eegnetreplication_tpu_torch.obs import trace as port_trace
from portbench import drive, harness, spec


def _run():
    win = drive.Window(started=0.0, seconds=1e-5, epochs=2, fold_epochs=180,
                       failed=0)
    return harness.Run(cell=spec.cell("eegnet.cross90"),
                       device_kind="NVIDIA H100 80GB HBM3", n_folds=90,
                       window=win, spans={"fold_setup": 3e-6}, trace=None)


@pytest.mark.parametrize("counts, expected", [
    ({"train.steps": 46, "bn_spatial.forwards": 46}, 1.0),
    ({"train.steps": 46, "bn_spatial.forwards": 23}, 0.5),
    ({"train.steps": 46}, None),
    ({"bn_spatial.forwards": 3}, None),
    ({"train.steps": 0, "bn_spatial.forwards": 0}, None),
    ({}, None),
])
def test_bn_spatial_train_share(monkeypatch, counts, expected):
    monkeypatch.setattr(port_trace, "layer_counts", lambda: dict(counts))
    got = spec.reader("bn_spatial_train_share")(_run())
    assert got == (None if expected is None else pytest.approx(expected))


def test_a_port_without_the_layer_record_reads_nothing(monkeypatch):
    monkeypatch.delattr(port_trace, "layer_counts")
    assert spec.reader("bn_spatial_train_share")(_run()) is None


def test_the_metric_is_read_in_the_eegnet_cell_alone():
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[
        "bn_spatial_train_share"]
    assert entry["workloads"] == ["eegnet.cross90"]
    assert entry["moves"] == "fold_epochs_per_s"
    assert "bn_spatial_train_share" in {
        m["name"] for m in spec.cell("eegnet.cross90").per_layer}
    assert "bn_spatial_train_share" not in {
        m["name"] for m in spec.cell("deepconvnet.within36").per_layer}
