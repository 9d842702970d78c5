"""The port's ladder tuner against the JAX package's, on the CPU.

``propose`` is the same pure function in both packages: a seeded grid of
``LadderStats``, ladders and coalescing windows gives equal proposals (or
``None`` in both).  ``collect`` over the port's metrics registry equals
the JAX ``collect`` over the same observations.  ``apply`` under 8
concurrent clients of a CPU engine drops no request and moves the
registry, the batcher and the journal as the JAX tuner does, with the
JAX ``ladder_retune`` keys.
"""

import threading
import time

import numpy as np
import pytest
from torch_port_cases import jax_variables, trials

from eegnetreplication_tpu.obs.metrics import (
    MetricsRegistry as JaxMetricsRegistry,
)
from eegnetreplication_tpu.serve import tuner as jax_tuner
from eegnetreplication_tpu_torch.obs.metrics import MetricsRegistry
from eegnetreplication_tpu_torch.serve import tuner
from eegnetreplication_tpu_torch.serve.batcher import MicroBatcher
from eegnetreplication_tpu_torch.serve.registry import ModelRegistry
from eegnetreplication_tpu_torch.serve.service import make_infer_fn
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    save_checkpoint,
)

LADDERS = [(1, 8, 32, 128), (1, 8, 32, 64, 128), (1, 4, 16), (1, 128),
           (1, 2, 8, 32, 128, 256), (1, 8, 32, 128, 256, 512), (1,)]
WAITS = [0.5, 2.0, 5.0, 20.0, 50.0]


class Recorder:
    """The journal surface the tuner writes to: events and a registry."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.events = []

    def event(self, name, **fields):
        self.events.append((name, fields))


def _random_stats(rng, buckets):
    dispatches = int(rng.choice([0, 5, 19, 20, 21, 60, 400]))
    counts, fills = {}, {}
    left = dispatches
    for b in buckets:
        if rng.rand() < 0.3 or left == 0:
            continue
        n = int(rng.randint(0, left + 1)) if b != buckets[-1] else left
        left -= n
        if n:
            counts[b] = n
            fills[b] = float(rng.choice([0.05, 0.31, 0.6, 0.61, 0.9, 0.95,
                                         1.0, rng.rand()]))
    trials_ = float(rng.choice([0.0, 1.0, 40.0 * max(dispatches, 1),
                                rng.rand() * 1e5]))
    return dict(window_s=float(rng.choice([0.5, 1.0, 30.0])),
                dispatches=dispatches, trials=trials_, bucket_counts=counts,
                bucket_fill_mean=fills)


@pytest.mark.parametrize("seed", range(40))
def test_propose_equals_the_jax_propose(seed):
    rng = np.random.RandomState(seed)
    for _ in range(25):
        buckets = LADDERS[rng.randint(len(LADDERS))]
        wait = float(rng.choice(WAITS))
        kw = _random_stats(rng, buckets)
        limits = dict(min_dispatches=int(rng.choice([1, 20])),
                      max_top=int(rng.choice([128, 256, 512])),
                      max_rungs=int(rng.choice([3, 5])))
        got = tuner.propose(tuner.LadderStats(**kw), buckets, wait, **limits)
        want = jax_tuner.propose(jax_tuner.LadderStats(**kw), buckets, wait,
                                 **limits)
        if want is None:
            assert got is None, (kw, buckets, wait)
        else:
            assert (got.buckets, got.max_wait_ms, got.reason) == \
                (want.buckets, want.max_wait_ms, want.reason)


def test_the_guardrails_are_the_jax_ones():
    for name in ("MAX_RUNGS", "MAX_TOP_BUCKET", "MIN_WAIT_MS", "MAX_WAIT_MS",
                 "MIN_DISPATCHES"):
        assert getattr(tuner, name) == getattr(jax_tuner, name), name


def _observe(registry, rng, n):
    for _ in range(n):
        b = int(rng.choice([1, 8, 32, 128]))
        k = int(rng.randint(1, b + 1))
        registry.observe("bucket_fill", k / b, bucket=str(b))
        registry.observe("batch_trials", k)


@pytest.mark.parametrize("seed", range(4))
def test_collect_equals_the_jax_collect(seed):
    port, ref = MetricsRegistry(), JaxMetricsRegistry()
    t_port = tuner.LadderTuner(None, None, journal=Recorder(port))
    t_ref = jax_tuner.LadderTuner(None, None, journal=Recorder(ref))
    for window in range(3):
        for registry in (port, ref):
            _observe(registry, np.random.RandomState(seed * 10 + window),
                     50 * (window + 1))
        got, want = t_port.collect(), t_ref.collect()
        assert got.dispatches == want.dispatches == 50 * (window + 1)
        assert got.trials == pytest.approx(want.trials, rel=0, abs=1e-9)
        assert got.bucket_counts == want.bucket_counts
        assert got.bucket_fill_mean.keys() == want.bucket_fill_mean.keys()
        for b, v in want.bucket_fill_mean.items():
            assert got.bucket_fill_mean[b] == pytest.approx(v, abs=1e-9)


@pytest.fixture(scope="module")
def registry_checkpoint(tmp_path_factory):
    c, t, f1, d = 22, 257, 8, 2
    params, bs = jax_variables(c, t, f1, d, seed=31)
    path = save_checkpoint(
        tmp_path_factory.mktemp("tuner") / "m.npz",
        from_jax_variables(params, bs),
        metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                  "F1": f1, "D": d})
    return path


def test_apply_under_eight_clients_drops_no_request(registry_checkpoint):
    journal = Recorder(MetricsRegistry())
    registry = ModelRegistry((1, 8, 32, 128), device="cpu", journal=journal)
    engine = registry.load(registry_checkpoint)
    batcher = MicroBatcher(make_infer_fn(registry), max_batch=128,
                           max_wait_ms=2.0, journal=journal)
    t = tuner.LadderTuner(registry, batcher, journal=journal)
    x = trials(40, 22, 257, seed=32)
    want = engine.infer(x)
    stop, failures, answered = threading.Event(), [], [0]
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            try:
                got = batcher.submit(x).result(30)
                if not (got == want).all():
                    failures.append("wrong answer")
                with lock:
                    answered[0] += 1
            except Exception as exc:  # noqa: BLE001 — counted
                failures.append(exc)

    threads = [threading.Thread(target=client) for _ in range(8)]
    for th in threads:
        th.start()
    try:
        time.sleep(0.3)
        t.apply(tuner.Proposal(buckets=(1, 8, 32, 64, 128), max_wait_ms=1.0,
                               reason="top_underfilled"))
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
        batcher.close()
    assert not failures and answered[0] > 8
    assert registry.active_buckets == (1, 8, 32, 64, 128)
    assert registry.retunes == 1 and t.retunes == 1
    assert registry.engine is not engine
    assert registry.engine.digest == engine.digest
    assert batcher.max_batch == 128 and batcher.max_wait_s == 0.001
    names = [n for n, _ in journal.events]
    assert names.count("ladder_retune") == 1
    # The load's programs, then the new ladder's, journaled as built.
    whats = [f["what"] for n, f in journal.events if n == "compile_end"]
    assert whats == [f"serve_forward_b{b}"
                     for b in (1, 8, 32, 128, 1, 8, 32, 64, 128)]


class _FakeRegistry:
    def __init__(self):
        self.active_buckets = (1, 8, 32, 128)
        self.serving_precision = "fp32"

    def retune(self, buckets):
        self.active_buckets = tuple(buckets)


class _FakeBatcher:
    max_wait_s = 0.005
    max_queue_trials = 512

    def reconfigure(self, *, max_batch=None, max_wait_ms=None):
        if max_wait_ms is not None:
            self.max_wait_s = max_wait_ms / 1000.0


def test_ladder_retune_keys_equal_the_jax_keys():
    port = Recorder(MetricsRegistry())
    ref = Recorder(JaxMetricsRegistry())
    stats = dict(window_s=1.0, dispatches=40, trials=1600.0,
                 bucket_counts={128: 40}, bucket_fill_mean={128: 0.3125})
    tuner.LadderTuner(_FakeRegistry(), _FakeBatcher(), journal=port).apply(
        tuner.Proposal((1, 8, 32, 64, 128), 5.0, "top_underfilled"),
        tuner.LadderStats(**stats))
    jax_tuner.LadderTuner(_FakeRegistry(), _FakeBatcher(),
                          journal=ref).apply(
        jax_tuner.Proposal((1, 8, 32, 64, 128), 5.0, "top_underfilled"),
        jax_tuner.LadderStats(**stats))
    (name, got), = port.events
    (ref_name, want), = ref.events
    assert name == ref_name == "ladder_retune"
    assert set(got) == set(want)
    got.pop("elapsed_s")
    want.pop("elapsed_s")
    assert got == want


def test_tune_once_journals_a_failed_retune_and_keeps_serving(caplog):
    """A failed retune journals nothing (as the JAX tuner), logs a
    warning, and the old ladder serves."""
    journal = Recorder(MetricsRegistry())
    registry = _FakeRegistry()

    def fails(buckets):
        raise RuntimeError("capture failed")

    registry.retune = fails
    t = tuner.LadderTuner(registry, _FakeBatcher(), journal=journal,
                          min_dispatches=1)
    for _ in range(40):
        journal.metrics.observe("bucket_fill", 40 / 128, bucket="128")
        journal.metrics.observe("batch_trials", 40)
    with caplog.at_level("WARNING"):
        assert t.tune_once() is None
    assert registry.active_buckets == (1, 8, 32, 128) and t.retunes == 0
    assert journal.events == []
    assert journal.metrics.get("ladder_retune_failures") is None
    (warning,) = [r for r in caplog.records
                  if "Ladder tune pass failed" in r.getMessage()]
    assert warning.levelname == "WARNING"
    assert "capture failed" in warning.getMessage()


def test_zoo_retune_moves_the_stacked_ladder(tmp_path):
    """``ModelZoo.retune`` rebuilds the stacked engine on the new ladder
    (same weights, same answers) and counts the retune."""
    from eegnetreplication_tpu_torch.serve.registry import ModelZoo

    c, t = 8, 64
    for z in range(3):
        params, bs = jax_variables(c, t, 8, 2, seed=40 + z)
        save_checkpoint(tmp_path / f"s{z}.npz", from_jax_variables(params, bs),
                        metadata={"model": "eegnet", "n_channels": c,
                                  "n_times": t, "F1": 8, "D": 2})
    journal = Recorder(MetricsRegistry())
    zoo = ModelZoo(str(tmp_path), buckets=(1, 8, 32), device="cpu",
                   gate_set=[("g", trials(16, c, t, seed=43))],
                   journal=journal)
    x = trials(20, c, t, seed=44)
    idx = np.arange(20) % 3
    want = zoo.infer(x, idx)
    old = zoo.stacked
    zoo.retune((1, 4, 16, 32))
    assert zoo.active_buckets == (1, 4, 16, 32) and zoo.retunes == 1
    assert zoo.stacked is not old and zoo.stacked.digest == old.digest
    np.testing.assert_array_equal(zoo.infer(x, idx), want)
    whats = [f["what"] for n, f in journal.events if n == "compile_end"]
    assert whats[-4:] == [f"zoo_forward_b{b}" for b in (1, 4, 16, 32)]
