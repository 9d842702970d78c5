"""The readers of the port's own layer spans and counters
(``metrics/{slot_source_ms, idle_share.slot_source, train_step_host_ms,
train_*_device_ms, k1_stacked_eval_share, setup_program_s}.py``) on a
synthetic window and a synthetic layer record, the cases where they must
read nothing among them: a port without the record (as before it had
one), and a ring that dropped spans of what a reader reads."""

from __future__ import annotations

import pytest

from eegnetreplication_tpu_torch.obs import trace as port_trace
from portbench import drive, harness, spec, trace
from portbench.tests.conftest import run_small, small_cell

SPAN_READERS = ("slot_source_ms", "idle_share.slot_source",
                "train_step_host_ms", "train_forward_device_ms",
                "train_backward_device_ms", "train_optimizer_device_ms",
                "setup_program_s")
READERS = SPAN_READERS + ("k1_stacked_eval_share",)
WINDOW = (10_000, 20_000)


def _spans():
    """Two runs' set-ups (the first cut short), a warm epoch's slot
    source, then two window epochs: three train steps with device times,
    and the validation passes.  (name, id, parent, start, end, device_ms)"""
    rows = [
        ("setup.pool", 1, None, 100, 200, None),          # an earlier run
        ("setup.pool", 2, None, 1000, 1500, None),
        ("setup.folds", 3, None, 1500, 1700, None),
        ("setup.init_states", 5, 4, 1800, 2500, None),
        ("setup.digest", 6, 4, 2500, 2900, None),
        ("setup.build", 4, None, 1700, 3000, None),
        ("setup.trainer", 7, None, 3000, 3200, None),
        ("train.slot_source", 8, None, 5000, 5500, None),  # warm epoch
        ("train.epoch", 10, None, 10_000, 15_000, None),
        ("train.slot_source", 11, 10, 10_000, 11_000, None),
        ("train.slot_copy", 12, 10, 11_000, 11_200, None),
        ("train.step", 13, 10, 11_300, 12_000, None),
        ("train.step.forward", 14, 13, 11_300, 11_500, 10.0),
        ("train.step.backward", 15, 13, 11_500, 11_800, 20.0),
        ("train.step.optimizer", 16, 13, 11_800, 11_900, 0.5),
        ("train.step", 17, 10, 12_000, 13_000, None),
        ("train.step.forward", 18, 17, 12_000, 12_300, 12.0),
        ("train.step.backward", 19, 17, 12_300, 12_800, 22.0),
        ("train.step.optimizer", 20, 17, 12_800, 12_900, 0.7),
        ("train.validate", 21, 10, 13_000, 15_000, None),
        ("train.epoch", 30, None, 15_000, 20_000, None),
        ("train.slot_source", 31, 30, 15_000, 17_000, None),
        ("train.slot_copy", 32, 30, 17_000, 17_100, None),
        ("train.step", 33, 30, 17_100, 18_000, None),
        ("train.step.forward", 34, 33, 17_100, 17_400, 11.0),
        ("train.step.backward", 35, 33, 17_400, 17_800, 21.0),
        ("train.step.optimizer", 36, 33, 17_800, 17_900, 0.6),
        ("train.validate", 37, 30, 18_000, 20_000, None),
    ]
    return [port_trace.LayerSpan(*r) for r in rows]


def _summary():
    """Busy intervals whose gaps start in the first slot source (200 ns),
    the slot copy (100), the epoch after the copy ended (50: not the
    copy's), a validation pass (500) and the second slot source (1950)."""
    return trace.Summary(window=WINDOW, busy=[
        (10_200, 11_050), (11_150, 11_250), (11_300, 14_000),
        (14_500, 15_100), (17_050, 20_000)])


def _run():
    win = drive.Window(started=0.0, seconds=1e-5, epochs=2, fold_epochs=180,
                       failed=0)
    return harness.Run(cell=spec.cell("eegnet.cross90"),
                       device_kind="NVIDIA H100 80GB HBM3", n_folds=90,
                       window=win, spans={"fold_setup": 3e-6},
                       trace=_summary())


@pytest.fixture
def record(monkeypatch):
    """Install a synthetic layer record in place of the process's."""
    def install(spans=None, counts=None, dropped_start=-1):
        spans = _spans() if spans is None else spans
        counts = {} if counts is None else counts
        monkeypatch.setattr(port_trace, "layer_spans", lambda: list(spans))
        monkeypatch.setattr(port_trace, "layer_counts", lambda: dict(counts))
        monkeypatch.setattr(port_trace, "layer_lost_since",
                            lambda t: dropped_start >= t)
    install()
    return install


@pytest.mark.parametrize("name, expected", [
    ("slot_source_ms", (1000 + 2000) / 2 / 1e6),
    ("idle_share.slot_source", (200 + 100 + 1950) / 10_000),
    ("train_step_host_ms", (700 + 1000 + 900) / 3 / 1e6),
    ("train_forward_device_ms", (10.0 + 12.0 + 11.0) / 3),
    ("train_backward_device_ms", (20.0 + 22.0 + 21.0) / 3),
    ("train_optimizer_device_ms", (0.5 + 0.7 + 0.6) / 3),
    ("setup_program_s", (500 + 200 + 1300 + 200) / 1e9),
])
def test_each_span_reader(record, name, expected):
    assert spec.reader(name)(_run()) == pytest.approx(expected)


@pytest.mark.parametrize("counts, expected", [
    ({"eval.steps": 28, "k1_stacked.launches": 28}, 1.0),
    ({"eval.steps": 28, "k1_stacked.launches": 14}, 0.5),
    ({"eval.steps": 10}, 0.0),
    ({"k1_stacked.launches": 3}, None),
    ({}, None),
])
def test_k1_stacked_eval_share(record, counts, expected):
    record(counts=counts)
    got = spec.reader("k1_stacked_eval_share")(_run())
    assert got == (None if expected is None else pytest.approx(expected))


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_layer_record_reads_nothing(monkeypatch, name):
    for attr in ("layer_spans", "layer_counts", "layer_lost_since",
                 "layer_dropped", "reset_layers", "count", "layer",
                 "LayerRecord", "LayerSpan"):
        monkeypatch.delattr(port_trace, attr)
    assert spec.reader(name)(_run()) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_spans_dropped_in_what_a_reader_reads_give_nothing(record, name):
    record(dropped_start=12_500)               # inside the window
    assert spec.reader(name)(_run()) is None


@pytest.mark.parametrize("name", SPAN_READERS)
def test_spans_dropped_before_what_a_reader_reads_do_not_count(record,
                                                                name):
    record(dropped_start=500)     # the earlier run's set-up, not this one's
    assert spec.reader(name)(_run()) is not None
    record(dropped_start=2000)    # this set-up's, before the window
    value = spec.reader(name)(_run())
    assert (value is None) == (name == "setup_program_s")


def test_readers_read_nothing_where_nothing_was_recorded(record):
    record(spans=[], counts={"eval.steps": 0})
    for name in READERS:
        assert spec.reader(name)(_run()) is None, name
    # spans without device times (the CPU, or no profiler) give no device
    # metric; a window the device never used gives no idle share
    record(spans=[s._replace(device_ms=None) for s in _spans()])
    for phase in ("forward", "backward", "optimizer"):
        assert spec.reader(f"train_{phase}_device_ms")(_run()) is None
    run = _run()
    run.trace = trace.Summary(window=WINDOW)
    assert spec.reader("idle_share.slot_source")(run) is None


def test_a_traced_small_run_reads_the_program_metrics():
    """On the CPU: the host spans and counters read, the device times do
    not; the port's set-up lies inside the harness's."""
    port_trace.reset_layers()
    result, _ = run_small(small_cell("eegnet.cross90"), 3_000_000_019,
                          traced=True)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("slot_source_ms", "train_step_host_ms", "setup_program_s"):
        assert got[name] > 0, name
    assert got["setup_program_s"] <= got["fold_setup_s"]
    assert got["k1_stacked_eval_share"] == 0.0     # K1's plain version
    for phase in ("forward", "backward", "optimizer"):
        assert f"train_{phase}_device_ms" not in got
    assert "idle_share.slot_source" not in got
