"""The torch port's CUDA kernels on a card (``gpu`` marker).

These skip on a host without CUDA.  The machine with the card has no JAX,
so this file imports none of it, and the repository's ``conftest.py`` (which
pins JAX to the CPU) must be skipped there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

K1 (``block1``) is held against its plain version ``block1_reference`` on
the same card at the serving shapes, atol/rtol 1e-5 (only the order of the
f32 sums differs), also at T on the edges of its time tile, at T=1125
and at B=1024; the engine's fused forward on the card against the
plain forward on the CPU at atol 1e-5 / rtol 1e-4.  K1's stacked form
(``block1_stacked``: G weight sets and an index per trial) is held against
``block1_stacked_reference`` at the shapes of ``chip_smoke.py`` phase 3b,
atol/rtol 1e-5; one fold-stacked train step on the card against the CPU at
dropout 0 (2e-3, the tolerance the CPU tests hold the port to against JAX);
one training epoch launches the stacked K1 once per validation batch; a
grouped cross-subject run on the card equals one group per fold at dropout
0 (2e-3); a carry snapshotted on the card through the asynchronous writer
and restored continues the unbroken run (2e-3) with the CUDA generator's
state restored.  K2
(``ems``) is held against ``ems_reference`` on the card at a session's (22, 345600) and the
edge shapes (K2's tile boundaries among them), atol/rtol 1e-4 (the JAX
package's Pallas-vs-scan tolerance).  Each kernel called three times on one
input gives the same bits.  The card's preprocessing path with
``EEGTPU_EMS_METHOD=pallas`` must launch K2 and never hand a CUDA tensor to
``ems_reference``.
"""

import numpy as np
import pytest
import torch

from eegnetreplication_tpu_torch.data import gdf, preprocess
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.ops import ems_kernel
from eegnetreplication_tpu_torch.ops import fused_eegnet as fused
from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.training import (
    async_ckpt,
    checkpoint,
    loop,
    protocols,
    steps,
)

pytestmark = pytest.mark.gpu

GEOMETRIES = {"product": (22, 257, 8, 2), "t256": (22, 256, 8, 2),
              "wide": (22, 257, 16, 4), "small": (8, 64, 8, 2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode (their "
                    "plain versions are tested on the CPU elsewhere)")
    torch.backends.cuda.matmul.allow_tf32 = False   # ems_reference's matmuls
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(c, t, f1, d, seed=0) -> EEGNet:
    g = torch.Generator().manual_seed(seed)
    model = EEGNet(c, t, F1=f1, D=d, device="cpu", generator=g)
    with torch.no_grad():
        for bn in (model.temporal[1], model.aggregation[0],
                   model.block_2[2]):
            n = bn.num_features
            bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
            bn.bias.copy_(0.2 * torch.randn(n, generator=g))
            bn.running_mean.copy_(0.3 * torch.randn(n, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model


def _trials(n, c, t, seed=1) -> torch.Tensor:
    return torch.from_numpy(
        np.random.RandomState(seed).randn(n, c, t).astype(np.float32))


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("batch", [1, 8, 32, 128])
def test_block1_kernel_matches_reference(cuda, geometry, batch):
    c, t, f1, d = GEOMETRIES[geometry]
    model = _model(c, t, f1, d).to(cuda)
    x = _trials(batch, c, t).to(cuda)
    with torch.no_grad():
        folded = fused.fold_block1_params(model.state_dict(),
                                          model.bn_epsilon)
        before = fused.block1.launches
        got = fused.block1(x, *folded)
        want = fused.block1_reference(x, *folded)
    torch.cuda.synchronize()
    assert fused.block1.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_block1_kernel_past_48kb_of_shared_memory(cuda):
    """T=1125 (250 Hz): a whole staged trial would need ~139 KB of shared
    memory; K1's blocks stage one time tile each, so it runs in the same
    ~10 KB as T=257."""
    model = _model(22, 1125, 8, 2).to(cuda)
    x = _trials(4, 22, 1125).to(cuda)
    with torch.no_grad():
        folded = fused.fold_block1_params(model.state_dict(),
                                          model.bn_epsilon)
        got = fused.block1(x, *folded)
        want = fused.block1_reference(x, *folded)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _block1_case(n, c, t, f1=8, d=2, seed=3):
    """Trials of any T with block 1's folded weights, which do not depend on
    T (an EEGNet of fewer than 32 samples has no classifier to build)."""
    model = _model(c, 257, f1, d, seed=seed)
    with torch.no_grad():
        folded = fused.fold_block1_params(model.state_dict(),
                                          model.bn_epsilon)
    return _trials(n, c, t, seed=seed), folded


# T at the edges of K1's time tile (4 * kPoolTile = 32 conv positions) and of
# its pool window, a trial longer than a 4.5 s window, and a batch of 1024.
K1_EDGES = [(1, 4), (1, 31), (1, 32), (1, 33), (1, 35), (1, 36), (1, 63),
            (1, 64), (1, 65), (1, 257), (1, 1125), (1024, 257)]


@pytest.mark.parametrize("batch, t", K1_EDGES,
                         ids=[f"B{b}-T{t}" for b, t in K1_EDGES])
def test_block1_kernel_at_time_tile_edges(cuda, batch, t):
    x, folded = _block1_case(batch, 22, t)
    x = x.to(cuda)
    folded = [v.to(cuda) for v in folded]
    with torch.no_grad():
        got = fused.block1(x, *folded)
        want = fused.block1_reference(x, *folded)
    torch.cuda.synchronize()
    assert got.shape == (batch, 16, t // 4)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("geometry", ["product", "wide"])
def test_block1_kernel_is_deterministic(cuda, geometry):
    c, t, f1, d = GEOMETRIES[geometry]
    x, folded = _block1_case(128, c, t, f1, d)
    x = x.to(cuda)
    folded = [v.to(cuda) for v in folded]
    with torch.no_grad():
        runs = [fused.block1(x, *folded) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_block1_refuses_cpu_weights_with_cuda_trials(cuda):
    model = _model(8, 64, 8, 2)
    with torch.no_grad():
        folded = fused.fold_block1_params(model.state_dict(),
                                          model.bn_epsilon)
    with pytest.raises(ValueError, match="is on cpu"):
        fused.block1(_trials(2, 8, 64).to(cuda), *folded)


@pytest.mark.parametrize("geometry", ["product", "wide"])
def test_engine_on_card_matches_plain_cpu_forward(cuda, geometry,
                                                  monkeypatch):
    c, t, f1, d = GEOMETRIES[geometry]
    engine = InferenceEngine(_model(c, t, f1, d), device=cuda)
    cpu_model = _model(c, t, f1, d)
    x = _trials(37, c, t)
    want = cpu_model(x).detach()

    def no_plain_on_card(*args):
        raise AssertionError("a CUDA tensor reached block1_reference")

    monkeypatch.setattr(fused, "block1_reference", no_plain_on_card)
    before = fused.block1.launches
    with torch.no_grad():
        got = engine.forward(x.to(cuda)).cpu()
    assert fused.block1.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(engine.infer(x.numpy()),
                                  want.argmax(-1).numpy())


EMS_SHAPES = {
    "session": ((22, 345600), {}),
    "signal": ((4, 3000), {}),
    "ragged": ((3, 700), {}),
    "init_100": ((1, 500), {"init_block_size": 100}),
    "init_past_T": ((2, 50), {}),
    "tile_plus_one": ((2, 4097), {}),
    "factor_0_1": ((4, 3000), {"factor_new": 0.1}),
    # K2's tile boundaries with many tiles a channel, and 64 channels.
    "tile_minus_one": ((1, 4095), {}),
    "one_tile": ((1, 4096), {}),
    "3_tiles_minus_one": ((1, 3 * 4096 - 1), {}),
    "3_tiles_plus_one": ((1, 3 * 4096 + 1), {}),
    "85_tiles_minus_one": ((1, 85 * 4096 - 1), {}),
    "85_tiles_plus_one": ((1, 85 * 4096 + 1), {}),
    "64_channels": ((64, 345600), {}),
}


@pytest.mark.parametrize("case", sorted(EMS_SHAPES))
def test_ems_kernel_matches_reference(cuda, case):
    shape, kw = EMS_SHAPES[case]
    rng = np.random.RandomState(len(case))
    x = torch.from_numpy((rng.randn(*shape) * 5.0 + 2.0).astype(np.float32))
    x = x.to(cuda)
    before = ems_kernel.ems.launches
    got = ems_kernel.ems(x, **kw)
    want = ems_kernel.ems_reference(x, **kw)
    torch.cuda.synchronize()
    assert ems_kernel.ems.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(22, 345600), (3, 3 * 4096 + 1)])
def test_ems_kernel_is_deterministic(cuda, shape):
    """K2 folds each tile's aggregates in a fixed order, never a prefix
    whose availability depends on timing: the same input, the same bits."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy((rng.randn(*shape) * 5.0 + 2.0).astype(np.float32))
    x = x.to(cuda)
    runs = [ems_kernel.ems(x) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


def test_ems_kernel_on_a_constant_signal_is_zero(cuda):
    got = ems_kernel.ems(torch.full((3, 400), 5.0, device=cuda),
                         init_block_size=100)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float(got.abs().max()) < 1e-3


def test_ems_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        ems_kernel.ems(torch.zeros(2, 10, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(C, T\)"):
        ems_kernel.ems(torch.zeros(2, 3, 10, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ems_kernel.ems(torch.zeros(10, 2, device=cuda).t())


def test_preprocessing_on_card_runs_k2_and_never_the_plain_version(
        cuda, monkeypatch):
    rng = np.random.RandomState(5)
    sig = (rng.randn(25, 5000) * 10.0 + 3.0).astype(np.float32)
    sig[2, 1000:1200] = np.nan
    rec = gdf.GDFRecording(signals=sig, sfreq=250.0, labels=[],
                           event_pos=np.array([300, 1301]),
                           event_typ=np.array([769, 770]))
    monkeypatch.setenv("EEGTPU_EMS_METHOD", "associative")
    want = preprocess.preprocess_recording(rec, device=cuda).data

    def no_plain_on_card(x, *args, **kwargs):
        raise AssertionError("a CUDA tensor reached ems_reference")

    monkeypatch.setattr(ems_kernel, "ems_reference", no_plain_on_card)
    monkeypatch.setenv("EEGTPU_EMS_METHOD", "pallas")
    before = ems_kernel.ems.launches
    got = preprocess.preprocess_recording(rec, device=cuda).data
    assert ems_kernel.ems.launches == before + 1
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def _stacked_weights(g, c=22, f2=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn((g, f2, c), generator=gen),
            0.2 * torch.randn((g, f2, 32), generator=gen),
            1.0 + 0.2 * torch.randn((g, f2), generator=gen),
            0.2 * torch.randn((g, f2), generator=gen))


K1_STACKED = [(g, b, t, False) for g in (1, 8, 36) for b in (1, 64)
              for t in (257, 1125)]
K1_STACKED += [(8, 64, 257, True), (36, 64, 257, True), (36, 1, 1125, True),
               # a cross-subject validation batch of 90 folds
               (90, 64, 257, False)]


@pytest.mark.parametrize("g, b, t, permuted", K1_STACKED,
                         ids=[f"G{g}-B{b}-T{t}{'-perm' if p else ''}"
                              for g, b, t, p in K1_STACKED])
def test_block1_stacked_kernel_matches_reference(cuda, g, b, t, permuted):
    S, W, A, B = (v.to(cuda) for v in _stacked_weights(g, seed=g + b + t))
    x = _trials(g * b, 22, t, seed=g * b).to(cuda)
    idx = fused.fold_index(g, b, cuda)
    if permuted:
        perm = torch.randperm(g * b, generator=torch.Generator().manual_seed(1))
        idx = idx[perm.to(cuda)].contiguous()
    before = fused.block1_stacked.launches
    with torch.no_grad():
        got = fused.block1_stacked(x, S, W, A, B, idx)
        want = fused.block1_stacked_reference(x, S, W, A, B, idx)
    torch.cuda.synchronize()
    assert fused.block1_stacked.launches == before + 1
    assert got.shape == (g * b, 16, t // 4)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_block1_stacked_kernel_is_deterministic_and_checks_idx(cuda):
    S, W, A, B = (v.to(cuda) for v in _stacked_weights(8, seed=5))
    x = _trials(512, 22, 257).to(cuda)
    idx = fused.fold_index(8, 64, cuda)
    with torch.no_grad():
        runs = [fused.block1_stacked(x, S, W, A, B, idx) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    bad = idx.clone()
    bad[7] = 8
    with pytest.raises(ValueError, match="outside"):
        fused.block1_stacked(x, S, W, A, B, bad)
    with pytest.raises(TypeError, match="int32"):
        fused.block1_stacked(x, S, W, A, B, idx.long())


def _fold_state(n_folds, c=22, t=257, seed=0):
    model = EEGNet(c, t, dropout_rate=0.0, device="cpu")
    return model, loop.init_fold_states(
        model, n_folds, torch.Generator().manual_seed(seed))


def test_one_stacked_train_step_on_card_matches_cpu(cuda):
    model, state = _fold_state(8)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(8, 64, 22, 257).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, (8, 64)))
    w = torch.ones(8, 64)
    w[3, 40:] = 0.0          # wrap-around padding slots
    w[5] = 0.0               # a fold with no real sample
    kw = dict(learning_rate=1e-3, adam_eps=1e-7)
    cpu, cpu_loss, cpu_gn = steps.train_step(model, state, x, y, w, **kw)
    card, loss, gn = steps.train_step(model, state.to(cuda), x.to(cuda),
                                      y.to(cuda), w.to(cuda), **kw)
    torch.testing.assert_close(loss.cpu(), cpu_loss, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(gn.cpu(), cpu_gn, atol=2e-3, rtol=2e-3)
    for field in ("params", "stats", "mu", "nu"):
        torch.testing.assert_close(getattr(card, field).cpu(),
                                   getattr(cpu, field), atol=2e-3, rtol=2e-3)
    assert card.count.cpu().tolist() == [1] * 5 + [0] + [1] * 2
    assert torch.equal(card.params[5].cpu(), state.params[5])


def test_one_epoch_launches_stacked_k1_once_per_validation_batch(cuda):
    model, state = _fold_state(4, seed=1)
    rng = np.random.RandomState(4)
    pool_x = torch.from_numpy(rng.randn(300, 22, 257).astype(np.float32))
    pool_y = torch.from_numpy(rng.randint(0, 4, 300))
    folds = [(np.arange(0, 150), np.arange(150, 230), np.arange(230, 300))
             for _ in range(4)]
    spec = loop.make_fold_spec(folds, train_pad=150, val_pad=80,
                               test_pad=70)
    trainer = loop.FoldTrainer(model, pool_x.to(cuda), pool_y.to(cuda), spec,
                               state, batch_size=64, learning_rate=1e-3,
                               adam_eps=1e-7)
    assert (trainer.train_steps, trainer.val_steps, trainer.test_steps) \
        == (3, 2, 2)
    before = fused.block1_stacked.launches
    trainer.run_epoch()
    assert fused.block1_stacked.launches == before + 2
    trainer.result()
    assert fused.block1_stacked.launches == before + 4


def _separable(subject, mode, n=48, c=22, t=257):
    rng = np.random.RandomState(10 * subject + (mode == "Eval"))
    y = rng.randint(0, 4, size=n)
    x = rng.standard_normal((n, c, t)).astype(np.float32)
    tt = np.arange(t) / 128.0
    for k in range(4):
        x[y == k] += np.sin(2 * np.pi * (6.0 + 4.0 * k) * tt).astype(
            np.float32)
    return BCICI2ADataset(X=x, y=y.astype(np.int64))


def test_grouped_cross_subject_run_on_card_matches_one_group(cuda, tmp_path):
    cfg = DEFAULT_TRAINING.replace(dropout_cross_subject=0.0,
                                   cs_repeats_per_subject=2)
    runs = {fb: protocols.cross_subject_training(
        epochs=2, config=cfg, loader=_separable, subjects=tuple(range(1, 8)),
        paths=Paths.from_root(tmp_path), save_models=False, device=cuda,
        fold_batch=fb) for fb in (0, 4)}
    assert runs[4].fold_batch == 4
    for field in ("train_losses", "val_losses", "min_val_loss"):
        torch.testing.assert_close(getattr(runs[4].folds, field),
                                   getattr(runs[0].folds, field),
                                   atol=2e-3, rtol=2e-3)


def test_card_snapshot_restores_and_continues_the_run(cuda, tmp_path):
    def trainer():
        rng = np.random.RandomState(6)
        x = torch.from_numpy(rng.randn(300, 22, 257).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 4, 300))
        folds = [(np.arange(0, 150), np.arange(150, 230),
                  np.arange(230, 300))] * 3
        spec = loop.make_fold_spec(folds, train_pad=150, val_pad=80,
                                   test_pad=70)
        model = EEGNet(22, 257, dropout_rate=0.5, device="cpu")
        init = loop.init_fold_states(model, 3,
                                     torch.Generator().manual_seed(2))
        return loop.FoldTrainer(
            model, x.to(cuda), y.to(cuda), spec, init, batch_size=64,
            learning_rate=1e-3, adam_eps=1e-7,
            dropout_generator=torch.Generator(device=cuda).manual_seed(5))

    unbroken = trainer()
    for _ in range(4):
        unbroken.run_epoch()
    first = trainer()
    for _ in range(2):
        first.run_epoch()
    path = tmp_path / "run.npz"
    writer = async_ckpt.SnapshotWriter(path, {"run": "card"})
    writer.submit(first.carry(), epochs_done=2)
    saved_rng = first.dropout_generator.get_state()
    del first                      # its device memory may be reused now
    torch.cuda.synchronize()
    writer.close()
    carry, done = checkpoint.load_run_snapshot(path, {"run": "card"})
    assert done == 2
    resumed = trainer()
    resumed.restore(carry)
    assert torch.equal(resumed.dropout_generator.get_state(), saved_rng)
    for _ in range(2):
        resumed.run_epoch()
    assert torch.equal(resumed.dropout_generator.get_state(),
                       unbroken.dropout_generator.get_state())
    want, got = unbroken.carry(), resumed.carry()
    for name in ("state/params", "history/train_losses",
                 "history/val_losses", "min_val_loss"):
        torch.testing.assert_close(got[name], want[name], atol=2e-3,
                                   rtol=2e-3)
