"""The port's chunked runs, run snapshots, fold groups and snapshot writer.

Each case of the JAX package's ``tests/test_protocols.py`` (chunks, resume,
fold batching) and ``tests/test_resilience.py`` (generations, preemption)
has its counterpart here, on the port's ``within_subject_training`` /
``cross_subject_training`` with ``tests/synthetic.py``'s data on the CPU:

- a run in chunks, and a run stopped after a chunk and resumed from its
  snapshot, equal the unbroken run bit for bit, dropout on (the dropout
  generator's state travels in the carry; the shuffles are keyed by seed,
  global fold and epoch);
- a snapshot of another run is refused, one of the same geometry over other
  data starts fresh with a warning, a corrupt newest generation falls back
  to the one before and is quarantined, ``EEGTPU_SNAPSHOT_KEEP`` sets the
  generations kept, and a JAX run snapshot at the port's path is refused;
- grouped runs resume per group, warn and retrain across another grouping,
  and clean up every snapshot on completion;
- at dropout 0 a grouped run equals one group per fold (training losses
  within 1e-6, equal test accuracies; see ``_assert_close_per_fold``); an
  out-of-memory error halves the group and the run completes;
- the writer lands snapshots in order in both modes, surfaces a failed
  write at the next ``submit``, and a stop at a chunk boundary leaves the
  submitted snapshot on disk.
"""

import logging

import numpy as np
import pytest
import torch
from synthetic import make_loader

from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu.training import protocols as jax_protocols
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.training import async_ckpt, loop, protocols
from eegnetreplication_tpu_torch.training import checkpoint as ckpt

CFG = DEFAULT_TRAINING.replace(batch_size=16)
SNAP = "within_subject_eegnet.run.npz"
RESULT_FIELDS = ("best_val_acc", "min_val_loss", "train_losses",
                 "val_losses", "val_accuracies", "grad_norms",
                 "test_accuracy")


def port_loader(**kw):
    jax_loader = make_loader(**kw)

    def loader(subject, mode):
        ds = jax_loader(subject, mode)
        return BCICI2ADataset(X=ds.X, y=ds.y)

    return loader


@pytest.fixture
def paths(tmp_path):
    return Paths.from_root(tmp_path)


@pytest.fixture(autouse=True)
def _no_stop_request():
    preempt.clear()
    yield
    preempt.clear()


def _ws(paths, epochs=6, subjects=(1,), config=CFG, loader_kw=None, **kw):
    loader = port_loader(**(loader_kw or dict(n_trials=24, n_channels=4,
                                              n_times=64)))
    return protocols.within_subject_training(
        epochs=epochs, config=config, loader=loader, subjects=subjects,
        paths=paths, seed=0, save_models=False, device="cpu", **kw)


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a.fold_test_acc, b.fold_test_acc)
    for field in RESULT_FIELDS:
        assert torch.equal(getattr(a.folds, field), getattr(b.folds, field)), \
            field
    for field in ("params", "stats", "mu", "nu", "count"):
        assert torch.equal(getattr(a.folds.best_state, field),
                           getattr(b.folds.best_state, field)), field


def _messages(caplog):
    return [r.getMessage() for r in caplog.records]


# --- chunks and resume -----------------------------------------------------

def test_chunked_equals_one_pass_bitwise(paths):
    one_pass = _ws(paths)
    chunked = _ws(paths, checkpoint_every=2)
    _assert_bitwise(chunked, one_pass)
    assert chunked.fold_epochs_trained == 4 * 6
    assert not (paths.models / SNAP).exists()


@pytest.mark.parametrize("every", [2, 0])
def test_epoch_cadence_lines_logged(paths, caplog, every):
    with caplog.at_level(logging.INFO):
        _ws(paths, checkpoint_every=every)
    lines = [m for m in _messages(caplog) if m.startswith("Epoch: ")]
    assert any(m.startswith("Epoch: 1/6.. Train Loss: ") for m in lines)
    assert any(m.startswith("Epoch: 6/6.. ") for m in lines)
    assert all("Val Loss: " in m and "Val Acc: " in m for m in lines)
    assert len(lines) == 2


def test_crash_and_resume_bitwise_with_dropout(paths):
    assert CFG.dropout_within_subject > 0
    unbroken = _ws(paths, checkpoint_every=2)
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, checkpoint_every=2, _crash_after_chunk=1)
    snap = paths.models / SNAP
    assert snap.exists()
    resumed = _ws(paths, checkpoint_every=2, resume=True)
    _assert_bitwise(resumed, unbroken)
    assert resumed.fold_epochs_trained == 4 * 4    # epochs 3-6 only
    assert not snap.exists()


def test_stale_snapshot_rejected(paths):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, checkpoint_every=2, _crash_after_chunk=1)
    with pytest.raises(ValueError, match="different run"):
        _ws(paths, epochs=4, checkpoint_every=2, resume=True)


@pytest.mark.parametrize("change", [{"maxnorm_mode": "paper"},
                                    {"bn_mode": "torch"}])
def test_update_rule_change_rejected_on_resume(paths, change):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, checkpoint_every=2, _crash_after_chunk=1)
    with pytest.raises(ValueError, match="different run"):
        _ws(paths, config=CFG.replace(**change), checkpoint_every=2,
            resume=True)


def test_content_mismatch_resumes_fresh(paths, caplog):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, checkpoint_every=2, _crash_after_chunk=1)
    assert (paths.models / SNAP).exists()
    other = dict(n_trials=24, n_channels=4, n_times=64, class_sep=1.7)
    with caplog.at_level(logging.WARNING):
        result = _ws(paths, loader_kw=other, checkpoint_every=2, resume=True)
    assert any("not its data content" in m for m in _messages(caplog))
    assert result.fold_epochs_trained == 4 * 6
    np.testing.assert_array_equal(
        result.fold_test_acc, _ws(paths, loader_kw=other).fold_test_acc)
    assert not (paths.models / SNAP).exists()


def test_missing_snapshot_warns_and_trains(paths, caplog):
    with caplog.at_level(logging.WARNING):
        result = _ws(paths, checkpoint_every=2, resume=True)
    assert any("no snapshot" in m for m in _messages(caplog))
    assert result.fold_epochs_trained == 4 * 6


def test_corrupt_newest_generation_falls_back(paths, caplog):
    unbroken = _ws(paths, checkpoint_every=2)
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, checkpoint_every=2, _crash_after_chunk=2)
    snap = paths.models / SNAP
    gen1 = snap.with_name(snap.name + ".gen1")
    assert snap.exists() and gen1.exists()
    snap.write_bytes(snap.read_bytes()[: snap.stat().st_size // 2])
    with caplog.at_level(logging.WARNING):
        resumed = _ws(paths, checkpoint_every=2, resume=True)
    assert any("falling back to previous generation" in m
               for m in _messages(caplog))
    assert any("quarantined" in m for m in _messages(caplog))
    _assert_bitwise(resumed, unbroken)
    assert resumed.fold_epochs_trained == 4 * 4    # from epoch 2's gen1
    assert not snap.exists() and not gen1.exists()
    assert not list(paths.models.glob("*.corrupt"))


@pytest.mark.parametrize("keep, want", [("1", []), ("3", [".gen1", ".gen2"])])
def test_snapshot_keep_env_is_honoured(paths, monkeypatch, keep, want):
    monkeypatch.setenv("EEGTPU_SNAPSHOT_KEEP", keep)
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, checkpoint_every=2, _crash_after_chunk=3)
    got = sorted(p.name[len(SNAP):] for p in paths.models.glob(SNAP + "*"))
    assert got == [""] + want


def test_snapshot_keep_parses_the_env(monkeypatch):
    monkeypatch.setenv("EEGTPU_SNAPSHOT_KEEP", "5")
    assert ckpt.snapshot_keep() == 5
    monkeypatch.setenv("EEGTPU_SNAPSHOT_KEEP", "0")
    assert ckpt.snapshot_keep() == 1
    monkeypatch.setenv("EEGTPU_SNAPSHOT_KEEP", "bogus")
    assert ckpt.snapshot_keep() == ckpt.DEFAULT_SNAPSHOT_KEEP


def test_a_jax_run_snapshot_at_the_port_path_is_refused(paths):
    """The JAX protocol's snapshot of the same run (its carry stored by
    position, its signature without the port's carry layout) must never
    be poured into the port's carry."""
    loader = port_loader(n_trials=24, n_channels=4, n_times=64)
    ds = [loader(1, "Train").concat(loader(1, "Eval"))]
    pool_x, pool_y, offsets = protocols.build_pool(ds)
    folds = protocols.within_subject_folds(offsets, CFG)
    signature = {"protocol": "within_subject", "model": "eegnet",
                 "subjects": [1], "epochs": 6, "n_folds": 4,
                 "padded_folds": 4, "seed": 0, "maxnorm_mode": "reference",
                 "precision": "highest", "n_pool": int(len(pool_x)),
                 "train_pad": max(len(f[0]) for f in folds),
                 "val_pad": max(len(f[1]) for f in folds),
                 "pool_sha1": jax_protocols._pool_digest(
                     pool_x, pool_y.astype(np.int32))}
    snap = paths.models / SNAP
    jax_ckpt.save_run_snapshot(
        snap, (np.zeros((4, 3), np.float32), np.zeros(4, np.float32)),
        {"train_losses": np.zeros((4, 2), np.float32)}, epochs_done=2,
        signature=signature)
    with pytest.raises(ValueError, match="different run"):
        _ws(paths, checkpoint_every=2, resume=True)
    assert snap.exists()


def test_read_snapshot_signature_robust(tmp_path):
    assert ckpt.read_snapshot_signature(tmp_path / "missing.npz") is None
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"not a zip")
    assert ckpt.read_snapshot_signature(bad) is None
    assert list(tmp_path.glob("bad.npz*.corrupt"))
    unsigned = tmp_path / "unsigned.npz"
    np.savez(unsigned, x=np.zeros(3))
    assert ckpt.read_snapshot_signature(unsigned) is None


# --- auto chunking ---------------------------------------------------------

@pytest.mark.parametrize("epochs", [500, 120, 150, 104, 127, 101, 7])
def test_auto_chunk_size_prefers_divisors_like_jax(epochs):
    assert protocols._auto_chunk_size(epochs) \
        == jax_protocols._auto_chunk_size(epochs)


def test_auto_chunk_size_values():
    assert protocols._auto_chunk_size(500) == 50
    assert protocols._auto_chunk_size(120) == 40
    assert protocols._auto_chunk_size(127) == 50


def test_long_run_auto_chunks(paths):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws(paths, epochs=120, _crash_after_chunk=1)
    stored = ckpt.read_snapshot_signature(paths.models / SNAP)
    assert stored["epochs"] == 120


@pytest.mark.parametrize("epochs, every", [(4, None), (120, 0)])
def test_unchunked_runs_are_one_pass(paths, epochs, every):
    result = _ws(paths, epochs=epochs, checkpoint_every=every,
                 _crash_after_chunk=1)
    assert np.isfinite(result.avg_test_acc)   # the hook never fired
    assert not (paths.models / SNAP).exists()


def test_resume_needs_a_chunked_run(paths):
    with pytest.raises(ValueError, match="chunked run"):
        _ws(paths, epochs=4, resume=True)


@pytest.mark.parametrize("kw", [{"fold_batch": -1},
                                {"checkpoint_every": -2}])
def test_negative_group_or_cadence_rejected(paths, kw):
    with pytest.raises(ValueError, match=">= 0"):
        _ws(paths, **kw)


# --- groups ----------------------------------------------------------------

def _ws2(paths, **kw):
    return _ws(paths, epochs=4, subjects=(1, 2),
               loader_kw=dict(n_trials=32, n_channels=4, n_times=64), **kw)


def test_grouped_crash_and_resume_bitwise(paths):
    unbroken = _ws2(paths, fold_batch=3, checkpoint_every=2)
    assert unbroken.fold_batch == 3
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws2(paths, fold_batch=3, checkpoint_every=2, _crash_after_chunk=1)
    assert (paths.models / (SNAP + ".g0")).exists()
    resumed = _ws2(paths, fold_batch=3, checkpoint_every=2, resume=True)
    _assert_bitwise(resumed, unbroken)
    assert not list(paths.models.glob("*.run.npz*"))


def test_resume_across_a_group_size_change_warns_and_retrains(paths,
                                                              caplog):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws2(paths, fold_batch=4, checkpoint_every=2, _crash_after_chunk=1)
    with caplog.at_level(logging.WARNING):
        resumed = _ws2(paths, fold_batch=3, checkpoint_every=2, resume=True)
    assert any("different fold grouping" in m for m in _messages(caplog))
    assert not list(paths.models.glob("*.run.npz*"))
    _assert_bitwise(resumed, _ws2(paths, fold_batch=3, checkpoint_every=2))


def test_resume_across_batching_warns_and_cleans(paths, caplog):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws2(paths, checkpoint_every=2, _crash_after_chunk=1)
    assert (paths.models / SNAP).exists()
    with caplog.at_level(logging.WARNING):
        resumed = _ws2(paths, fold_batch=3, checkpoint_every=2, resume=True)
    assert any("ungrouped run snapshot" in m for m in _messages(caplog))
    assert not (paths.models / SNAP).exists()
    _assert_bitwise(resumed, _ws2(paths, fold_batch=3, checkpoint_every=2))


def test_resume_with_a_corrupt_group_snapshot(paths, caplog):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws2(paths, fold_batch=3, checkpoint_every=2, _crash_after_chunk=1)
    g0 = paths.models / (SNAP + ".g0")
    g0.write_bytes(b"not a zip archive")
    with caplog.at_level(logging.WARNING):
        resumed = _ws2(paths, fold_batch=3, checkpoint_every=2, resume=True)
    assert any("unreadable" in m for m in _messages(caplog))
    _assert_bitwise(resumed, _ws2(paths, fold_batch=3, checkpoint_every=2))


def test_ungrouped_completion_clears_stale_group_snapshots(paths):
    with pytest.raises(RuntimeError, match="injected crash"):
        _ws2(paths, fold_batch=3, checkpoint_every=2, _crash_after_chunk=1)
    assert list(paths.models.glob("*.run.npz.g*"))
    _ws2(paths, checkpoint_every=2)
    assert not list(paths.models.glob("*.run.npz*"))


def test_zero_opts_out_of_groups(paths):
    one = _ws2(paths)
    zero = _ws2(paths, fold_batch=0)
    assert zero.fold_batch is None
    _assert_bitwise(zero, one)


def _cs6(paths, **kw):
    """Six cross-subject folds at dropout 0 (3 subjects x 2 repeats, one
    train subject a fold)."""
    cfg = CFG.replace(dropout_cross_subject=0.0, cs_repeats_per_subject=2,
                      cs_train_subjects=1, cs_val_subjects=1)
    return protocols.cross_subject_training(
        epochs=3, config=cfg, subjects=(1, 2, 3), paths=paths, seed=0,
        save_models=False, device="cpu",
        loader=port_loader(n_trials=24, n_channels=4, n_times=64), **kw)


def _assert_close_per_fold(a, b):
    """Per fold: equal test accuracies and training losses within 1e-6.
    The validation losses are held to 1e-4: the temporal BatchNorm's scale
    and bias have a true gradient of 0 in training (the spatial BatchNorm
    removes them), so their gradients are rounding noise, which differs
    with the grouped convolutions' sizes and which Adam turns into steps of
    up to ~lr; eval mode sees the moved affine (5.4e-6 after 3 epochs)."""
    np.testing.assert_array_equal(a.fold_test_acc, b.fold_test_acc)
    torch.testing.assert_close(a.folds.train_losses, b.folds.train_losses,
                               atol=1e-6, rtol=0)
    for field in ("val_losses", "min_val_loss"):
        torch.testing.assert_close(getattr(a.folds, field),
                                   getattr(b.folds, field), atol=1e-4, rtol=0)


def test_grouped_equals_one_group_at_p0(paths):
    one = _cs6(paths, fold_batch=0)
    grouped = _cs6(paths, fold_batch=2)
    assert len(one.fold_test_acc) == 6 and grouped.fold_batch == 2
    _assert_close_per_fold(grouped, one)


def test_out_of_memory_halves_the_group_and_completes(paths, monkeypatch,
                                                      caplog, tmp_path):
    record = tmp_path / "limits" / "fold_batch.json"
    record.parent.mkdir()
    monkeypatch.setattr(protocols, "_fold_batch_limit_path", lambda: record)
    one = _cs6(paths, fold_batch=0)
    with caplog.at_level(logging.WARNING):
        halved = _cs6(paths, fold_batch=4, _fault_if_folds_over=2)
    assert any("halving the fold group to 2" in m for m in _messages(caplog))
    assert halved.fold_batch == 4
    assert halved.fault_retry_wall_s > 0
    assert halved.wall_seconds > halved.fault_retry_wall_s
    assert halved.fold_epochs_trained == 6 * 3
    _assert_close_per_fold(halved, one)
    import json
    assert [v["limit"] for v in json.loads(record.read_text()).values()] \
        == [2]


def test_other_errors_propagate_instead_of_halving(paths):
    with pytest.raises(RuntimeError, match="injected crash"):
        _cs6(paths, fold_batch=4, checkpoint_every=1, _crash_after_chunk=1)


def test_an_oom_in_one_group_propagates(paths):
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _cs6(paths, fold_batch=0, _fault_if_folds_over=2)


def test_effective_fold_batch_mirrors_the_grouping():
    for fold_batch, n in ((15, 90), (None, 90), (0, 90), (100, 90),
                          (90, 90)):
        assert protocols._effective_fold_batch(fold_batch, n) \
            == jax_protocols._effective_fold_batch(fold_batch, None, n)


def test_cs_auto_fold_batch(monkeypatch, tmp_path):
    monkeypatch.setattr(protocols, "_fold_batch_limit_path",
                        lambda: tmp_path / "limits.json")
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    n = protocols.CS_CARD_FOLD_BATCH + 1
    assert protocols._cs_auto_fold_batch(n, None, cpu) is None
    assert protocols._cs_auto_fold_batch(n, 45, cpu) == 45
    assert protocols._cs_auto_fold_batch(n, 0, card) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "H")
    assert protocols._cs_auto_fold_batch(n, None, card) \
        == protocols.CS_CARD_FOLD_BATCH
    assert protocols._cs_auto_fold_batch(n - 1, None, card) is None
    protocols._record_fold_batch_limit(7, card)
    assert protocols._cs_auto_fold_batch(n, None, card) == 7
    assert protocols._known_fold_batch_limit(cpu) is None


# --- the trainer's carry and keyed shuffles --------------------------------

def _trainer(n_folds=3, dropout=0.5, seed=0):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(60, 4, 64).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, 60))
    folds = [(np.arange(0, 30), np.arange(30, 40), np.arange(40, 60))] \
        * n_folds
    spec = loop.make_fold_spec(folds, train_pad=30, val_pad=10, test_pad=20)
    model = protocols.get_model("eegnet", n_channels=4, n_times=64,
                                dropout_rate=dropout, device="cpu")
    init = loop.init_fold_states(model, n_folds,
                                 torch.Generator().manual_seed(seed))
    return loop.FoldTrainer(model, x, y, spec, init, batch_size=16,
                            learning_rate=1e-3, adam_eps=1e-7)


def test_carry_restores_bitwise_including_the_dropout_stream():
    a = _trainer()
    for _ in range(4):
        a.run_epoch()
    b = _trainer()
    for _ in range(2):
        b.run_epoch()
    saved = {k: v.numpy() for k, v in b.carry().items()}
    c = _trainer()
    c.restore(saved)
    assert c.epoch == 2
    for _ in range(2):
        c.run_epoch()
    for name, value in a.carry().items():
        assert torch.equal(value, c.carry()[name]), name


def test_restore_refuses_a_carry_of_another_shape():
    carry = {k: v.numpy() for k, v in _trainer(n_folds=2).carry().items()}
    with pytest.raises(ValueError, match="state/params"):
        _trainer(n_folds=3).restore(carry)
    del carry["best_acc"]
    with pytest.raises(ValueError, match="lacks"):
        _trainer(n_folds=2).restore(carry)


def test_a_folds_batches_do_not_depend_on_its_group():
    spec = loop.make_fold_spec(
        [(np.arange(10 * g, 10 * g + 7 + g), [0], [0]) for g in range(6)],
        train_pad=12, val_pad=1, test_pad=1)
    whole = loop.keyed_slot_source(spec, 16, 5, range(6))
    part = loop.keyed_slot_source(spec.folds(3, 5), 16, 5, [3, 4])
    for epoch in (0, 7):
        w_idx, w_w = whole(epoch)
        p_idx, p_w = part(epoch)
        assert torch.equal(p_idx, w_idx[3:5]) and torch.equal(p_w, w_w[3:5])
    assert not torch.equal(whole(0)[0], whole(1)[0])


# --- the writer ------------------------------------------------------------

def _carry(fill):
    return {"state/params": torch.full((2, 3), float(fill)),
            "rng/dropout": torch.Generator().manual_seed(fill).get_state()}


@pytest.mark.parametrize("async_", [True, False])
def test_writer_lands_snapshots_in_order(tmp_path, async_):
    path = tmp_path / "snap.npz"
    writer = async_ckpt.SnapshotWriter(path, {"run": "t"}, async_=async_,
                                       keep=3)
    for fill in (1, 2, 3):
        writer.submit(_carry(fill), epochs_done=fill)
    writer.close()
    for gen, fill in (("", 3), (".gen1", 2), (".gen2", 1)):
        carry, done = ckpt.load_run_snapshot(
            tmp_path / f"snap.npz{gen}", {"run": "t"})
        assert done == fill
        np.testing.assert_array_equal(carry["state/params"],
                                      np.full((2, 3), fill, np.float32))
    assert [r["epochs_done"] for r in writer.records] == [1, 2, 3]
    assert all(r["ok"] and r["write_s"] > 0 for r in writer.records)
    assert writer.records[-1]["drain"] is async_


def test_writer_copies_the_carry_at_submit(tmp_path):
    carry = _carry(1)
    writer = async_ckpt.SnapshotWriter(tmp_path / "s.npz", {})
    writer.submit(carry, epochs_done=1)
    carry["state/params"].fill_(9.0)
    writer.close()
    got, _ = ckpt.load_run_snapshot(tmp_path / "s.npz", {})
    assert float(got["state/params"].max()) == 1.0


@pytest.mark.parametrize("async_", [True, False])
def test_a_failed_write_surfaces_at_the_next_submit(tmp_path, monkeypatch,
                                                    async_):
    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_run_snapshot", fail)
    writer = async_ckpt.SnapshotWriter(tmp_path / "s.npz", {}, async_=async_)
    if async_:
        writer.submit(_carry(1), epochs_done=1)
    with pytest.raises(async_ckpt.SnapshotWriteError, match="disk full"):
        writer.submit(_carry(2), epochs_done=2)
    assert writer.records[0]["ok"] is False
    writer.close()


def test_close_on_an_error_path_logs_instead_of_raising(tmp_path,
                                                        monkeypatch, caplog):
    monkeypatch.setattr(ckpt, "save_run_snapshot",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("x")))
    writer = async_ckpt.SnapshotWriter(tmp_path / "s.npz", {})
    writer.submit(_carry(1), epochs_done=1)
    with caplog.at_level(logging.WARNING):
        writer.close(raise_errors=False)
    assert any("failed during shutdown" in m for m in _messages(caplog))
    with pytest.raises(async_ckpt.SnapshotWriteError, match="closed"):
        writer.submit(_carry(2), epochs_done=2)


def test_drain_hook_commits_the_pending_write(tmp_path):
    writer = async_ckpt.SnapshotWriter(tmp_path / "s.npz", {})
    writer.submit(_carry(4), epochs_done=4)
    preempt.run_drain_hooks()
    assert ckpt.load_run_snapshot(tmp_path / "s.npz", {})[1] == 4
    assert writer._closed
    preempt.run_drain_hooks()    # idempotent: the hook is gone


def test_guard_runs_drain_hooks_when_a_stop_was_requested():
    ran = []
    preempt.add_drain_hook(lambda: ran.append(1))
    with preempt.guard():
        pass
    assert ran == []
    with preempt.guard():
        preempt.request()
    assert ran == [1]


def test_a_stop_at_a_chunk_boundary_leaves_the_snapshot(paths, monkeypatch):
    unbroken = _ws(paths, checkpoint_every=2)
    run_epoch = loop.FoldTrainer.run_epoch

    def stop_after_epoch_2(self):
        run_epoch(self)
        if self.epoch == 2:
            preempt.request()

    monkeypatch.setattr(loop.FoldTrainer, "run_epoch", stop_after_epoch_2)
    with pytest.raises(preempt.Preempted, match="--resume"):
        _ws(paths, checkpoint_every=2)
    monkeypatch.setattr(loop.FoldTrainer, "run_epoch", run_epoch)
    _, done = ckpt.load_run_snapshot(
        paths.models / SNAP,
        ckpt.read_snapshot_signature(paths.models / SNAP))
    assert done == 2
    preempt.clear()
    _assert_bitwise(_ws(paths, checkpoint_every=2, resume=True), unbroken)
