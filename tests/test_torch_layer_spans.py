"""The training path's layer spans and counters (``obs/trace.py``'s
in-process half): nesting, the ring's bound, the profiler gate, the shared
clock with ``torch.profiler``, and the spans one epoch and one set-up
record.

    EEGTPU_PLATFORM=cpu python -m pytest tests/test_torch_layer_spans.py

The ``gpu`` tests count K1-stacked's launches and read the spans' CUDA
events on a card (``--noconftest -m gpu``); the file imports no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.models import get_model
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.ops import fused_eegnet as fused
from eegnetreplication_tpu_torch.training import loop, protocols, steps

STEP_PHASES = ["train.step.forward", "train.step.backward",
               "train.step.optimizer"]


@pytest.fixture(autouse=True)
def fresh_layers():
    trace.reset_layers()
    yield
    trace.reset_layers()


def _names(spans):
    return [s.name for s in spans]


def _trainer(n_folds=3, n=60, c=4, t=64):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n, c, t).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, n))
    folds = [(np.arange(0, 30), np.arange(30, 40), np.arange(40, 60))] \
        * n_folds
    spec = loop.make_fold_spec(folds, train_pad=30, val_pad=10, test_pad=20)
    model = get_model("eegnet", n_channels=c, n_times=t, dropout_rate=0.25,
                      device="cpu")
    init = loop.init_fold_states(model, n_folds,
                                 torch.Generator().manual_seed(0))
    return loop.FoldTrainer(model, x, y, spec, init, batch_size=16,
                            learning_rate=1e-3, adam_eps=1e-7)


def test_spans_nest_by_parent_id_and_end_in_order():
    with trace.layer("outer"):
        with trace.layer("mid"):
            with trace.layer("inner"):
                pass
        with trace.layer("sibling"):
            pass
    with trace.layer("next"):
        pass
    spans = trace.layer_spans()
    assert _names(spans) == ["inner", "mid", "sibling", "outer", "next"]
    by = {s.name: s for s in spans}
    assert by["outer"].parent_span_id is None
    assert by["next"].parent_span_id is None
    assert by["mid"].parent_span_id == by["outer"].span_id
    assert by["sibling"].parent_span_id == by["outer"].span_id
    assert by["inner"].parent_span_id == by["mid"].span_id
    assert len({s.span_id for s in spans}) == 5
    for child, parent in (("inner", "mid"), ("mid", "outer"),
                          ("sibling", "outer")):
        assert by[parent].start_ns <= by[child].start_ns
        assert by[child].end_ns <= by[parent].end_ns
    assert by["mid"].end_ns <= by["sibling"].start_ns
    assert all(s.dur_ns >= 0 and s.device_ms is None for s in spans)


def test_a_raising_block_records_its_span_and_restores_the_parent():
    with trace.layer("outer"):
        with pytest.raises(ValueError):
            with trace.layer("fails"):
                raise ValueError("inside")
        with trace.layer("after"):
            pass
    by = {s.name: s for s in trace.layer_spans()}
    assert set(by) == {"outer", "fails", "after"}
    assert by["fails"].parent_span_id == by["outer"].span_id
    assert by["after"].parent_span_id == by["outer"].span_id


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "_LAYERS", trace.LayerRecord(capacity=4))
    for i in range(10):
        with trace.layer(f"s{i}"):
            pass
    spans = trace.layer_spans()
    assert _names(spans) == ["s6", "s7", "s8", "s9"]
    assert trace.layer_dropped() == 6
    # s5 was the newest span dropped: an interval from before its start
    # is not whole, one from s6's start on is
    assert trace.layer_lost_since(0)
    assert not trace.layer_lost_since(spans[0].start_ns)
    trace.reset_layers()
    assert trace.layer_spans() == [] and trace.layer_dropped() == 0
    assert not trace.layer_lost_since(0)


def test_the_process_ring_holds_its_bound():
    assert trace.LAYER_RING == 65_536
    for _ in range(trace.LAYER_RING + 3):
        with trace.layer("s"):
            pass
    assert len(trace.layer_spans()) == trace.LAYER_RING
    assert trace.layer_dropped() == 3


def test_counters_add_up_and_reset():
    trace.count("eval.steps")
    trace.count("eval.steps", 4)
    trace.count("k1_stacked.launches", 2)
    assert trace.layer_counts() == {"eval.steps": 5,
                                    "k1_stacked.launches": 2}
    counts = trace.layer_counts()
    counts["eval.steps"] = 0               # a copy
    assert trace.layer_counts()["eval.steps"] == 5
    trace.reset_layers()
    assert trace.layer_counts() == {}


def test_without_a_profiler_a_span_enters_no_range_and_makes_no_event(
        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    with trace.layer("train.step.forward", device=torch.device("cuda", 0)):
        with trace.layer("inner", device=torch.device("cpu")):
            pass
    assert _names(trace.layer_spans()) == ["inner", "train.step.forward"]
    # and the training path, whose device spans name the data's device
    trainer = _trainer()
    trainer.run_epoch()
    assert "train.step.forward" in _names(trace.layer_spans())


def _profiled_ranges(prof, names):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_under_the_profiler_each_span_brackets_its_range_on_one_clock():
    """The span's clock reads lie just outside the ``record_function``
    range it opens: within 1 ms at each end, on the same clock."""
    from torch.profiler import ProfilerActivity, profile

    names = [f"layer.{i}" for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with trace.layer(name, device=torch.device("cpu")):
                torch.ones(64, 64).sum()
    ranges = _profiled_ranges(prof, set(names))
    spans = {s.name: s for s in trace.layer_spans()}
    for name in names:
        assert len(ranges[name]) == 1, name
        start, end = ranges[name][0]
        s = spans[name]
        assert s.start_ns <= start <= s.start_ns + 1_000_000, name
        assert end <= s.end_ns <= end + 1_000_000, name
        assert s.device_ms is None          # not a CUDA device


def test_one_epoch_records_its_layers_and_steps():
    trainer = _trainer()
    assert (trainer.train_steps, trainer.val_steps) == (2, 1)
    trainer.run_epoch()
    spans = trace.layer_spans()
    names = _names(spans)
    by_id = {s.span_id: s for s in spans}
    assert names.count("train.epoch") == 1
    epoch = next(s for s in spans if s.name == "train.epoch")
    assert epoch.parent_span_id is None
    for name in ("train.slot_source", "train.slot_copy", "train.validate"):
        assert names.count(name) == 1, name
        span = next(s for s in spans if s.name == name)
        assert span.parent_span_id == epoch.span_id, name
    step_spans = [s for s in spans if s.name == "train.step"]
    assert len(step_spans) == trainer.train_steps
    for step in step_spans:
        assert step.parent_span_id == epoch.span_id
        children = sorted((s for s in spans
                           if s.parent_span_id == step.span_id),
                          key=lambda s: s.start_ns)
        assert _names(children) == STEP_PHASES
        for a, b in zip(children, children[1:]):
            assert a.end_ns <= b.start_ns
    order = sorted((s for s in spans if s.parent_span_id == epoch.span_id),
                   key=lambda s: s.start_ns)
    assert _names(order) == (["train.slot_source", "train.slot_copy"]
                             + ["train.step"] * trainer.train_steps
                             + ["train.validate"])
    assert all(by_id[s.parent_span_id].name == "train.step"
               for s in spans if s.name in STEP_PHASES)
    assert trace.layer_counts() == {"eval.steps": trainer.val_steps,
                                    "train.steps": trainer.train_steps}
    # no K1-stacked launch (nor BNS) on the CPU: the plain versions run
    trainer.result()
    assert trace.layer_counts() == {
        "eval.steps": trainer.val_steps + trainer.test_steps,
        "train.steps": trainer.train_steps}


def test_a_train_step_called_alone_records_its_phases():
    trainer = _trainer(n_folds=2)
    x = trainer.pool_x[:32].reshape(2, 16, 4, 64)
    y = trainer.pool_y[:32].reshape(2, 16)
    steps.train_step(trainer.model, trainer.state, x, y, torch.ones(2, 16),
                     learning_rate=1e-3, adam_eps=1e-7)
    spans = trace.layer_spans()
    assert _names(spans) == STEP_PHASES + ["train.step"]
    assert {s.parent_span_id for s in spans[:3]} == {spans[3].span_id}


def _sessions(n_subjects, n_sessions=2, n=8, c=4, t=64):
    rng = np.random.RandomState(1)
    return [[BCICI2ADataset(rng.randn(n, c, t).astype(np.float32),
                            rng.randint(0, 4, n)) for _ in range(n_sessions)]
            for _ in range(n_subjects)]


def test_the_within_subject_set_up_records_its_spans():
    sessions = _sessions(2)
    pool_x, pool_y, offsets = protocols.build_pool(
        [row[0].concat(row[1]) for row in sessions])
    folds = protocols.within_subject_folds(offsets, DEFAULT_TRAINING)
    model = get_model("eegnet", n_channels=4, n_times=64, dropout_rate=0.5,
                      device="cpu")
    setup = protocols.FoldSetup.build(model, folds, pool_x, pool_y,
                                      config=DEFAULT_TRAINING, seed=3,
                                      device=torch.device("cpu"))
    setup.trainer(0, setup.n_folds)
    spans = trace.layer_spans()
    assert _names(spans) == ["setup.pool", "setup.folds",
                             "setup.init_states", "setup.digest",
                             "setup.build", "setup.trainer"]
    by = {s.name: s for s in spans}
    for child in ("setup.init_states", "setup.digest"):
        assert by[child].parent_span_id == by["setup.build"].span_id
    for top in ("setup.pool", "setup.folds", "setup.build", "setup.trainer"):
        assert by[top].parent_span_id is None
    assert by["setup.init_states"].end_ns <= by["setup.digest"].start_ns


def test_the_cross_subject_folds_record_their_span():
    sessions = _sessions(7, n=4)
    pool_x, pool_y, offsets = protocols.build_pool(
        [row[0] for row in sessions] + [row[1] for row in sessions])
    folds = protocols.cross_subject_folds(
        offsets[:7], offsets[7:], tuple(range(1, 8)),
        DEFAULT_TRAINING.replace(cs_repeats_per_subject=1))
    assert len(folds) == 7
    assert _names(trace.layer_spans()) == ["setup.pool", "setup.folds"]


def test_the_profiling_breakdown_counts_kernels_not_span_ranges():
    """Under a profiler a span's ``record_function`` range also shows on the
    device's timeline (a user annotation); ``utils/profiling.py``'s device
    time leaves it out."""
    from types import SimpleNamespace

    from eegnetreplication_tpu_torch.utils import profiling

    cuda_t = torch.autograd.DeviceType.CUDA
    cpu_t = torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(name="gemm", device_type=cuda_t,
                              is_user_annotation=False),
              SimpleNamespace(name="train.step", device_type=cuda_t,
                              is_user_annotation=True),
              SimpleNamespace(name="train.step", device_type=cpu_t,
                              is_user_annotation=False)]
    prof = SimpleNamespace(events=lambda: events)
    assert [e.name for e in profiling._device_events(prof)] == ["gemm"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1-stacked has no CPU mode (its "
                    "plain version is tested on the CPU elsewhere)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_each_k1_stacked_launch_counts_once(cuda):
    g, f2, c, t, per = 3, 16, 22, 257, 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(g * per, c, t, generator=gen).to(cuda)
    S = torch.randn(g, f2, c, generator=gen).to(cuda)
    W = torch.randn(g, f2, 32, generator=gen).to(cuda)
    A = torch.rand(g, f2, generator=gen).to(cuda) + 0.5
    B = torch.randn(g, f2, generator=gen).to(cuda)
    idx = fused.fold_index(g, per, cuda)
    launches = fused.block1_stacked.launches
    for _ in range(5):
        fused.block1_stacked(x, S, W, A, B, idx)
    torch.cuda.synchronize()
    assert fused.block1_stacked.launches - launches == 5
    assert trace.layer_counts() == {"k1_stacked.launches": 5}


@pytest.mark.gpu
def test_device_spans_read_their_cuda_events_under_the_profiler(cuda):
    from torch.profiler import ProfilerActivity, profile

    model = get_model("eegnet", n_channels=22, n_times=257, dropout_rate=0.0,
                      device="cpu")
    state = loop.init_fold_states(model, 2,
                                  torch.Generator().manual_seed(0)).to(cuda)
    x = torch.randn(2, 64, 22, 257, device=cuda)
    y = torch.randint(0, 4, (2, 64), device=cuda)
    w = torch.ones(2, 64, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            state, _, _ = steps.train_step(model, state, x, y, w,
                                           learning_rate=1e-3,
                                           adam_eps=1e-7)
        torch.cuda.synchronize()
    spans = trace.layer_spans()
    for phase in STEP_PHASES:
        got = [s.device_ms for s in spans if s.name == phase]
        assert len(got) == 3 and all(v is not None and v > 0 for v in got)
    assert all(s.device_ms is None for s in spans if s.name == "train.step")
    trace.reset_layers()
    steps.train_step(model, state, x, y, w, learning_rate=1e-3,
                     adam_eps=1e-7)
    torch.cuda.synchronize()
    assert all(s.device_ms is None for s in trace.layer_spans())
