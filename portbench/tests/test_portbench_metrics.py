"""The per-layer arithmetic on a recorded event list: ranges, launches
matched to device operations, the busy union, idle gaps, and each reader."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import drive, harness, spec, trace, yardstick

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
H100 = "NVIDIA H100 80GB HBM3"


class Event:
    """The accessors of a raw profiler event that ``trace.summarize``
    reads."""

    def __init__(self, name, device, start, duration, corr=0,
                 annotation=False):
        self._v = (name, device, start, duration, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def recorded():
    """A 1000 ns window: two train steps, one eval step; a kernel launched
    in each step, one in none, and a device-side annotation to skip."""
    p = trace.PREFIX
    return [
        Event(p + "window", CPU, 0, 1000),
        Event(p + "epoch", CPU, 0, 900),
        Event(p + "train_step", CPU, 10, 90),
        Event("cudaLaunchKernel", CPU, 20, 5, corr=1),
        Event(p + "train_step", CPU, 110, 90),
        Event("cudaLaunchKernel", CPU, 120, 5, corr=2),
        Event(p + "eval_step", CPU, 300, 100),
        Event("cudaLaunchKernel", CPU, 310, 5, corr=3),
        Event("cudaLaunchKernel", CPU, 450, 5, corr=4),
        Event("gemm", CUDA, 100, 200, corr=1),
        Event("gemm", CUDA, 250, 150, corr=2),        # overlaps the first
        Event("block1_stacked_kernel", CUDA, 500, 100, corr=3),
        Event("copy", CUDA, 800, 50, corr=4),
        Event(p + "train_step", CUDA, 100, 300, annotation=True),
    ]


def summary():
    return trace.summarize(recorded(), [trace.PREFIX + r
                                        for r in harness.RANGES])


def test_ranges_busy_and_gaps():
    s = summary()
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy == [(100, 400), (500, 600), (800, 850)]
    assert s.busy_s == pytest.approx(450e-9)
    assert s.calls[trace.PREFIX + "train_step"] == 2
    # the two train kernels overlap: 100-400, not 200 + 150
    assert s.device_s(trace.PREFIX + "train_step") == pytest.approx(300e-9)
    assert s.device_s(trace.PREFIX + "eval_step") == pytest.approx(100e-9)
    # launched inside the epoch but outside every step
    assert s.device_s(trace.PREFIX + "epoch") == pytest.approx(50e-9)
    assert s.device_s() == pytest.approx(450e-9)
    assert s.gaps() == [(0, 100), (400, 500), (600, 800), (850, 1000)]
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["gemm", pytest.approx(350e-9)]
    # each gap is named by the range the host was in when it began
    assert dict(b["idle_gaps"]) == pytest.approx({"epoch": 450e-9,
                                                  "eval_step": 100e-9})


def _run():
    cell = spec.cell("eegnet.cross90")
    win = drive.Window(started=0.0, seconds=2.0, epochs=2, fold_epochs=180,
                       failed=0)
    return harness.Run(cell=cell, device_kind=H100, n_folds=90, window=win,
                       spans={"fold_setup": 1.25},
                       slots={"real": 90 * 1440, "padded": 90 * 1472},
                       fold_epoch_flops=11.12e9, trace=summary())


@pytest.mark.parametrize("name, expected", [
    ("fold_setup_s", 1.25),
    ("real_slot_share", 1440 / 1472),
    ("val_device_share", 100 / 450),
    ("train_step_device_ms", 1e3 * 300e-9 / 2),
    ("train_mfu", 100 * 11.12e9 * 90 / 66.9e12),
    ("device_idle_share.train", 1 - 450 / 1000),
    ("k1_stacked_roofline.train",
     100 * max(yardstick.block1_stacked(5760, 22, 257, 16, 90)[0] / 3.35e12,
               yardstick.block1_stacked(5760, 22, 257, 16, 90)[1] / 66.9e12)
     / 100e-9),
])
def test_each_reader(name, expected):
    assert spec.reader(name)(_run()) == pytest.approx(expected)


def test_k1_bound_is_the_published_one():
    """(5760, 22, 257) over 90 weight sets: 154.2 MB, bound by bytes, at
    0.04603 ms (the port's kernel table)."""
    nbytes, flops = yardstick.block1_stacked(5760, 22, 257, 16, 90)
    bound = yardstick.bound_s(nbytes, flops, H100)
    assert bound * 1e3 == pytest.approx(0.04603, abs=5e-6)
    assert nbytes / 3.35e12 > flops / 66.9e12


def test_readers_return_nothing_without_a_card():
    run = _run()
    run.device_kind = "cpu"
    run.trace = types.SimpleNamespace(
        calls={}, busy=[], device_s=lambda *a: 0.0, by_name=dict,
        busy_s=0.0, window_s=1.0)
    for name in ("train_mfu", "k1_stacked_roofline.train", "val_device_share",
                 "train_step_device_ms", "device_idle_share.train"):
        assert spec.reader(name)(run) is None
