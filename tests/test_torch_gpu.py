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
atol/rtol 1e-5, and equals K1 bit for bit per weight set on the 90-fold
validation batch (fold-major and permuted); one fold-stacked train step on the card against the CPU at
dropout 0 (2e-3, the tolerance the CPU tests hold the port to against JAX);
one training epoch launches the stacked K1 once per validation batch; a
grouped cross-subject run on the card equals one group per fold at dropout
0 (2e-3); a carry snapshotted on the card through the asynchronous writer
and restored continues the unbroken run (2e-3) with the CUDA generator's
state restored.  Two 8-fold card runs are bitwise equal, and the
deterministic mode the card's runs select raises on none of the serving,
dataset and training paths.  K2
(``ems``) is held against ``ems_reference`` on the card at a session's (22, 345600) and the
edge shapes (K2's tile boundaries among them), atol/rtol 1e-4 (the JAX
package's Pallas-vs-scan tolerance).  Each kernel called three times on one
input gives the same bits.  The card's preprocessing path with
``EEGTPU_EMS_METHOD=pallas`` must launch K2 and never hand a CUDA tensor to
``ems_reference``.  K2s (``ems_stream``) equals its plain version bit for
bit at 1, 22 and 64 channels, pushes and longer chunks alike, the carry
threaded through.  Serving beyond one fp32 model: the int8 engine
launches K1 once per bucket chunk and matches the plain int8 forward on the
CPU (atol 1e-5 / rtol 1e-4); the stacked engine, fp32 and int8, launches
K1-stacked once per chunk and K1 never, and matches its CPU twin; a zoo of
nine tenants stacks through the gate on the card and answers as each
tenant's own engine.  The bucket ladder as captured CUDA graphs: a
replay's logits equal the eager forward's bit for bit at every bucket
(fp32, int8 and the nine-tenant stack), a replay counts the kernels its
graph holds and a capture counts none, a retune captures while another
thread replays and a session pushes K2s, a capture that would wait for
the device raises, and the profiler sees ``block1_kernel`` inside the
replays.  Online adaptation: the shadow's bucket-1 graph replays
bitwise the eager forward and launches K1 once per shadow eval, its
capture drops nothing while the zoo serves and a session pushes, two card
fine-tunes from one seed are bitwise equal, and a card fine-tune lies
within 2e-3 of the CPU one at dropout 0.  The model layer: ShallowConvNet
and DeepConvNet on the card against the CPU (logits at atol 1e-5 / rtol
1e-4, a stacked train step at 2e-3) with no K1 or K1-stacked launch, their
bucket graphs bitwise the eager forward; EEGNet's banded schedule against
the grouped convolutions on the card at T = 257 and 1125 (1e-5 forward,
1e-4 gradients) and bitwise across two runs; CSP+LDA and the
tangent-space classifier predicting on the card as on the CPU.  The
replica fleet: ``serve.fleet --replicas 2`` on the card answers
``/predict`` byte for byte as a replica does (but ``latency_ms``), with
``predict_trials``' predictions, every replica's K1 launches its warm runs
plus its graph replays.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

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


@pytest.mark.parametrize("order", ["fold-major", "permuted"])
def test_block1_stacked_equals_k1_bit_for_bit_per_set(cuda, order):
    """K1-stacked (``block1_stacked.cu``) keeps K1's order of every sum, so
    each trial equals K1 on the same trial and weight set to the bit: the
    90-fold validation batch, 5760 trials."""
    g, b = 90, 64
    S, W, A, B = (v.to(cuda) for v in _stacked_weights(g, seed=13))
    x = _trials(g * b, 22, 257, seed=14).to(cuda)
    idx = fused.fold_index(g, b, cuda)
    if order == "permuted":
        perm = torch.randperm(g * b, generator=torch.Generator().manual_seed(2))
        idx = idx[perm.to(cuda)].contiguous()
    with torch.no_grad():
        got = fused.block1_stacked(x, S, W, A, B, idx)
        for s in range(g):
            rows = (idx == s).nonzero()[:, 0]
            want = fused.block1(x[rows].contiguous(), S[s], W[s], A[s], B[s])
            assert torch.equal(got[rows], want), f"set {s}"


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_block1_stacked_on_a_misaligned_view(cuda, offset):
    """Trials that start 1-3 floats past a 16-byte boundary: K1-stacked's
    bulk row copies must not reach outside x (its first and last rows'
    edge chunks go float by float), and the answer is K1's."""
    g, b = 4, 33
    S, W, A, B = (v.to(cuda) for v in _stacked_weights(g, seed=15))
    x0 = _trials(g * b, 22, 257, seed=16).to(cuda)
    buf = torch.empty(x0.numel() + offset, device=cuda)
    x = buf[offset:].view(x0.shape)
    x.copy_(x0)
    idx = fused.fold_index(g, b, cuda)
    with torch.no_grad():
        got = fused.block1_stacked(x, S, W, A, B, idx)
        for s in range(g):
            rows = (idx == s).nonzero()[:, 0]
            want = fused.block1(x0[rows].contiguous(), S[s], W[s], A[s], B[s])
            assert torch.equal(got[rows], want), f"set {s}"


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


def _ws_on_card(cuda, tmp_path, name, epochs=2, **kw):
    """Within-subject training at 8 folds (2 separable subjects) on the
    card through the protocol, which selects the card's deterministic
    numerics (``utils/device.py``)."""
    return protocols.within_subject_training(
        epochs=epochs, loader=_separable, subjects=(1, 2),
        paths=Paths.from_root(tmp_path / name), save_models=False,
        device=cuda, **kw)


def test_two_card_runs_are_bitwise_equal(cuda, tmp_path):
    a, b = (_ws_on_card(cuda, tmp_path, n) for n in ("a", "b"))
    assert torch.are_deterministic_algorithms_enabled()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    for field in ("train_losses", "val_losses", "val_accuracies",
                  "grad_norms", "min_val_loss", "test_accuracy"):
        assert torch.equal(getattr(a.folds, field), getattr(b.folds, field)), \
            field
    for field in ("params", "stats", "mu", "nu", "count"):
        assert torch.equal(getattr(a.folds.best_state, field),
                           getattr(b.folds.best_state, field)), field


def test_card_run_beats_compile_then_step_and_keeps_its_bits(
        cuda, tmp_path, monkeypatch):
    """A supervised card run's heartbeats: ``compile`` before the first
    epoch, ``step`` after each epoch and at each chunk boundary, the file
    written; the weights equal a run with no heartbeat file bit for bit."""
    from eegnetreplication_tpu_torch.resil import heartbeat

    monkeypatch.delenv(heartbeat.HEARTBEAT_FILE_ENV, raising=False)
    heartbeat.reset_default()
    plain = _ws_on_card(cuda, tmp_path, "plain", checkpoint_every=1)
    beat_file = tmp_path / "hb" / "beat.json"
    monkeypatch.setenv(heartbeat.HEARTBEAT_FILE_ENV, str(beat_file))
    heartbeat.reset_default()
    beats = []
    real_beat = heartbeat.beat

    def spy(phase="step", **ctx):
        beats.append((phase, ctx))
        return real_beat(phase, **ctx)

    monkeypatch.setattr(heartbeat, "beat", spy)
    try:
        beaten = _ws_on_card(cuda, tmp_path, "beaten", checkpoint_every=1)
    finally:
        heartbeat.reset_default()
    assert [p for p, _ in beats] == ["compile"] + ["step"] * 4
    assert [ctx["epochs_done"] for _, ctx in beats] == [0, 1, 1, 2, 2]
    assert {ctx["n_folds"] for _, ctx in beats} == {8}
    got = heartbeat.read(beat_file)
    assert got is not None and got.phase == "step"
    for field in ("train_losses", "val_losses", "test_accuracy"):
        assert torch.equal(getattr(plain.folds, field),
                           getattr(beaten.folds, field)), field
    for field in ("params", "stats"):
        assert torch.equal(getattr(plain.folds.best_state, field),
                           getattr(beaten.folds.best_state, field)), field


def test_determinism_raises_on_no_path(cuda, tmp_path, monkeypatch):
    """Deterministic mode refuses ops it has no deterministic kernel for;
    none sits on the serving, dataset or training paths."""
    from eegnetreplication_tpu_torch.utils.device import resolve_device

    resolve_device(cuda)
    assert torch.are_deterministic_algorithms_enabled()
    engine = InferenceEngine(_model(22, 257, 8, 2), device=cuda)
    engine.warmup()
    assert engine.infer(_trials(8, 22, 257).numpy()).shape[0] == 8
    rng = np.random.RandomState(5)
    rec = gdf.GDFRecording(
        signals=(rng.randn(25, 5000) * 10.0).astype(np.float32),
        sfreq=250.0, labels=[], event_pos=np.array([300, 1301]),
        event_typ=np.array([769, 770]))
    for method in ("associative", "pallas"):
        monkeypatch.setenv("EEGTPU_EMS_METHOD", method)
        assert np.isfinite(preprocess.preprocess_recording(
            rec, device=cuda).data).all()
    chunked = _ws_on_card(cuda, tmp_path, "ws", epochs=2, checkpoint_every=1)
    assert np.isfinite(chunked.fold_min_val_loss).all()
    cfg = DEFAULT_TRAINING.replace(cs_repeats_per_subject=1)
    cs = protocols.cross_subject_training(
        epochs=1, config=cfg, loader=_separable, subjects=tuple(range(1, 8)),
        paths=Paths.from_root(tmp_path / "cs"), save_models=False,
        device=cuda, fold_batch=4)
    assert np.isfinite(cs.fold_min_val_loss).all()


# --- Serving beyond one fp32 model: int8 through K1, the zoo through
# K1-stacked -----------------------------------------------------------------

def test_int8_engine_on_card_launches_k1_and_matches_the_plain_cpu_forward(
        cuda, monkeypatch):
    from eegnetreplication_tpu_torch.ops import quant

    model = _model(22, 257, 8, 2)
    engine = InferenceEngine(model, (1, 8, 32, 128), device=cuda,
                             precision="int8")
    cpu = InferenceEngine(_model(22, 257, 8, 2), device="cpu",
                          precision="int8")
    x = _trials(37, 22, 257)
    want = quant.quantized_eval_forward_reference(cpu._qpack, x)

    def no_plain_on_card(*args):
        raise AssertionError("a CUDA tensor reached block1_reference")

    monkeypatch.setattr(fused, "block1_reference", no_plain_on_card)
    before = fused.block1.launches
    got = engine.forward(x.to(cuda)).cpu()
    assert fused.block1.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    before = fused.block1.launches
    preds = engine.infer(_trials(300, 22, 257).numpy())
    assert preds.shape == (300,)
    assert fused.block1.launches == before + 3      # one per bucket chunk


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_stacked_engine_on_card_launches_k1_stacked_once_per_chunk(
        cuda, precision):
    from eegnetreplication_tpu_torch.serve.zoo import StackedEngine

    members = [(f"s{z}", _model(22, 257, 8, 2, seed=z)) for z in range(9)]
    engine = StackedEngine(members, (1, 8, 32, 128), precision=precision,
                           device=cuda)
    cpu = StackedEngine([(m, _model(22, 257, 8, 2, seed=z))
                         for z, (m, _) in enumerate(members)],
                        precision=precision, device="cpu")
    x = _trials(128, 22, 257)
    idx = torch.arange(128, dtype=torch.int32) % 9
    with torch.no_grad():
        want = cpu.forward(x, idx)
    before = (fused.block1.launches, fused.block1_stacked.launches)
    got = engine.forward(x.to(cuda), idx.to(cuda)).cpu()
    assert (fused.block1.launches,
            fused.block1_stacked.launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    before = fused.block1_stacked.launches
    preds = engine.infer(_trials(200, 22, 257).numpy(),
                         np.arange(200) % 9)
    assert preds.shape == (200,)
    assert fused.block1_stacked.launches == before + 2


def test_zoo_on_card_stacks_nine_tenants_through_the_gate(cuda, tmp_path):
    from eegnetreplication_tpu_torch.serve.registry import ModelZoo

    for z in range(9):
        checkpoint.save_checkpoint(
            tmp_path / f"subject_{z + 1:02d}_best_model.npz",
            _model(22, 257, 8, 2, seed=z).state_dict(),
            metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                      "F1": 8, "D": 2})
    zoo = ModelZoo(str(tmp_path), device=cuda)
    assert zoo.stacked is not None and zoo.last_stack_gate.agreement == 1.0
    x = _trials(64, 22, 257).numpy()
    idx = np.arange(64) % 9
    got = zoo.infer(x, idx)
    for z, mid in enumerate(zoo.tenant_ids):
        solo = InferenceEngine(_model(22, 257, 8, 2, seed=z), device=cuda)
        np.testing.assert_array_equal(got[idx == z], solo.infer(x[idx == z]))


# --- K2s: the EMS carry over a stream's chunks ------------------------------

def _stream_signal(c, n, seed=11):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(c, n) * 5.0 + 9.0).astype(np.float32))


@pytest.mark.parametrize("n", [1, 2, 25, 64, 250, 1000, 4096, 15000])
@pytest.mark.parametrize("c", [1, 22, 64])
def test_ems_stream_kernel_matches_its_plain_version(cuda, c, n):
    """K2s against ``ems_stream_reference`` on the card, the carry
    threaded through 3 chunks; 1e-6 abs/rel (each operation is rounded on
    its own in both, so they should agree to the bit)."""
    x = _stream_signal(c, 3 * n).to(cuda)
    mean0, var0 = ems_kernel.seed_stats(x, 1000)
    mk, vk = torch.zeros_like(mean0), var0.clone()
    mp, vp = torch.zeros_like(mean0), var0.clone()
    before = ems_kernel.ems_stream.launches
    for k in range(3):
        chunk = x[:, k * n:(k + 1) * n].contiguous()
        got = ems_kernel.ems_stream(chunk, mean0, mk, vk)
        want = ems_kernel.ems_stream_reference(chunk, mean0, mp, vp)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(mk, mp, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(vk, vp, atol=1e-6, rtol=1e-6)
    assert ems_kernel.ems_stream.launches == before + 3


@pytest.mark.parametrize("c", [1, 22, 64])
def test_ems_stream_kernel_is_bitwise_its_plain_version(cuda, c):
    """K2s and ``ems_stream_reference`` round every operation on their own:
    out and the carry agree to the bit, for pushes (one warp) and longer
    chunks (the ring), the carry threaded through."""
    x = _stream_signal(c, 3948, seed=c).to(cuda)
    mean0, var0 = ems_kernel.seed_stats(x, 1000)
    mk, vk = torch.zeros_like(mean0), var0.clone()
    mp, vp = torch.zeros_like(mean0), var0.clone()
    pos = 0
    for n in (25, 1, 256, 257, 250, 512, 513, 1000, 1134):
        chunk = x[:, pos:pos + n].contiguous()
        got = ems_kernel.ems_stream(chunk, mean0, mk, vk)
        want = ems_kernel.ems_stream_reference(chunk, mean0, mp, vp)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"out at chunk of {n}"
        assert torch.equal(mk, mp) and torch.equal(vk, vp), f"carry at {n}"
        pos += n
    assert pos == 3948


@pytest.mark.parametrize("sizes", [[25], [64], [997], [1, 2, 3, 5, 7],
                                   [15000]])
def test_ems_stream_is_chunk_invariant_on_the_card(cuda, sizes):
    from eegnetreplication_tpu_torch.ops.ems import (
        StreamingEMS,
        scan_with_carry,
    )

    n = 2000 if sizes[0] < 25 else 15000
    x = _stream_signal(22, n, seed=12)
    out, m, v = scan_with_carry(x.to(cuda))
    ems = StreamingEMS(22, device=cuda)
    outs, pos, i = [], 0, 0
    while pos < n:
        step = sizes[i % len(sizes)]
        outs.append(ems.push(x[:, pos:pos + step].numpy()))
        pos, i = pos + step, i + 1
    state = ems.state_arrays()
    assert np.array_equal(np.concatenate(outs, axis=1), out.cpu().numpy())
    assert np.array_equal(state["m"], m.cpu().numpy())
    assert np.array_equal(state["v"], v.cpu().numpy())


def test_scan_on_the_card_is_one_k2s_launch_and_repeats(cuda):
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )

    x = _stream_signal(22, 15000, seed=13).to(cuda)
    before = ems_kernel.ems_stream.launches
    runs = [exponential_moving_standardize(x, method="scan")
            for _ in range(3)]
    assert ems_kernel.ems_stream.launches == before + 3
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    cpu = exponential_moving_standardize(x.cpu(), method="scan")
    torch.testing.assert_close(runs[0].cpu(), cpu, atol=1e-4, rtol=1e-4)


def test_streaming_ems_on_the_card_is_within_1e_4_of_the_cpu(cuda):
    from eegnetreplication_tpu_torch.ops.ems import StreamingEMS

    x = _stream_signal(22, 3000, seed=14).numpy()
    card, cpu = StreamingEMS(22, device=cuda), StreamingEMS(22, device="cpu")
    for pos in range(0, 3000, 25):
        got, want = card.push(x[:, pos:pos + 25]), cpu.push(
            x[:, pos:pos + 25])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for key, want in cpu.state_arrays().items():
        np.testing.assert_allclose(card.state_arrays()[key], want,
                                   atol=1e-4, rtol=1e-4, err_msg=key)


def test_ems_stream_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    mu, m, v = (torch.zeros(4, device=cuda) for _ in range(3))
    with pytest.raises(TypeError, match="float32"):
        ems_kernel.ems_stream(x.double(), mu, m, v)
    with pytest.raises(ValueError, match="contiguous"):
        ems_kernel.ems_stream(torch.zeros(8, 4, device=cuda).t(), mu, m, v)
    with pytest.raises(ValueError, match="distinct"):
        ems_kernel.ems_stream(x, mu, m, m)
    with pytest.raises(ValueError, match="is on"):
        ems_kernel.ems_stream(x, mu.cpu(), m, v)


def test_one_session_through_the_card_engine_counts_its_launches(cuda,
                                                                 tmp_path):
    """A session on the card: one K2s launch per non-empty push from the
    seeding push on, one K1 launch per coalesced forward, and the decisions
    of the offline pipeline (one-shot scan on the card, the same windows,
    the engine)."""
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.serve.batcher import MicroBatcher
    from eegnetreplication_tpu_torch.serve.sessions import (
        StreamSession,
        WindowDecision,
    )

    engine = InferenceEngine(_model(22, 257, 8, 2, seed=5), device=cuda)
    batcher = MicroBatcher(engine.infer, max_batch=128, max_wait_ms=1.0)
    x = _stream_signal(22, 5000, seed=15).numpy()
    session = StreamSession("g", n_channels=22, window=257, hop=64,
                            device=cuda)
    k2s, k1 = ems_kernel.ems_stream.launches, fused.block1.launches
    pushes = 0
    try:
        for pos in range(0, 5000, 25):
            ready = session.ingest(x[:, pos:pos + 25])
            pushes += session.ems.seeded
            futs = [(i, s, batcher.submit(w[None], priority=True))
                    for i, s, w in ready]
            for i, s, fut in futs:
                session.record(WindowDecision(i, s, int(fut.result(30)[0]),
                                              "ok", 0.0))
    finally:
        batcher.close()
    assert ems_kernel.ems_stream.launches - k2s == pushes == 200 - 39
    assert fused.block1.launches - k1 == batcher.batches
    std = exponential_moving_standardize(torch.from_numpy(x).to(cuda),
                                         method="scan").cpu().numpy()
    wins = np.stack([std[:, k * 64:k * 64 + 257]
                     for k in range((5000 - 257) // 64 + 1)])
    np.testing.assert_array_equal(session.preds(), engine.infer(wins))


# --- The bucket ladder as captured CUDA graphs -----------------------------

def _graph_engine(cuda, kind, buckets=(1, 8, 32, 128)):
    from eegnetreplication_tpu_torch.serve.zoo import StackedEngine

    if kind == "zoo":
        members = [(f"s{z}", _model(22, 257, 8, 2, seed=z)) for z in range(9)]
        return StackedEngine(members, buckets, device=cuda)
    return InferenceEngine(_model(22, 257, 8, 2, seed=4), buckets,
                           device=cuda, precision=kind)


def _bucket_args(cuda, kind, b, seed):
    x = _trials(b, 22, 257, seed=seed).to(cuda)
    if kind != "zoo":
        return (x,)
    idx = torch.from_numpy(
        np.random.RandomState(seed).randint(0, 9, b).astype(np.int32))
    return x, idx.to(cuda)


@pytest.mark.parametrize("kind", ["fp32", "int8", "zoo"])
def test_graph_replay_is_bitwise_the_eager_forward(cuda, kind):
    engine = _graph_engine(cuda, kind)
    engine.warmup()
    assert sorted(engine.graph_stats()) == [1, 8, 32, 128]
    for b in engine.buckets:
        args = _bucket_args(cuda, kind, b, seed=50 + b)
        with torch.inference_mode():
            eager = engine.forward(*args).cpu()
        replayed = engine.graph_logits(*args).cpu()
        assert torch.equal(replayed, eager), (kind, b)
        host = [a.cpu().numpy() for a in args]
        np.testing.assert_array_equal(engine.infer(*host),
                                      eager.argmax(-1).numpy())


@pytest.mark.parametrize("kind", ["fp32", "int8", "zoo"])
def test_graph_replays_count_their_kernel_launches(cuda, kind):
    from eegnetreplication_tpu_torch.serve.engine import BucketGraph

    counter = fused.block1_stacked if kind == "zoo" else fused.block1
    other = fused.block1 if kind == "zoo" else fused.block1_stacked
    engine = _graph_engine(cuda, kind)
    before = (counter.launches, other.launches, counter.captured)
    engine.warmup()
    # One eager warm run a bucket; the captures count nothing.
    assert counter.launches == before[0] + 4
    assert counter.captured == before[2] + 4
    assert other.launches == before[1]
    assert all(s["kernels"] == {counter.__name__: 1}
               for s in engine.graph_stats().values())
    launches, replays = counter.launches, BucketGraph.replays
    x = _trials(300, 22, 257).numpy()
    args = (x,) if kind != "zoo" else (x, np.arange(300) % 9)
    engine.infer(*args)                  # chunks 128 + 128 + 44 (-> 128)
    assert counter.launches == launches + 3
    assert BucketGraph.replays == replays + 3


def test_retune_captures_while_the_batcher_replays_and_a_session_pushes(
        cuda, tmp_path):
    """A retune's captures run while another thread replays the live
    engine's graphs and a third pushes a K2s session: nothing fails, every
    answer equals the eager forward's, and the new ladder serves."""
    from eegnetreplication_tpu_torch.serve.registry import ModelRegistry
    from eegnetreplication_tpu_torch.serve.sessions import StreamSession

    model = _model(22, 257, 8, 2, seed=6)
    path = checkpoint.save_checkpoint(
        tmp_path / "retune.npz", model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    registry = ModelRegistry((1, 8, 32, 128), device=cuda)
    registry.load(path)
    eager = InferenceEngine(_model(22, 257, 8, 2, seed=6), device=cuda)
    x = _trials(40, 22, 257, seed=7).numpy()
    want = eager.infer(x)
    stop, errors, answers = threading.Event(), [], []

    def serve():
        while not stop.is_set():
            try:
                answers.append(registry.infer(x))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

    def push():
        session = StreamSession("r", n_channels=22, window=257, hop=64,
                                device=cuda)
        sig = _stream_signal(22, 200_000, seed=8).numpy()
        pos = 0
        while not stop.is_set() and pos < sig.shape[1]:
            try:
                session.ingest(sig[:, pos:pos + 25])
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)
            pos += 25

    threads = [threading.Thread(target=serve), threading.Thread(target=push)]
    for th in threads:
        th.start()
    try:
        time.sleep(0.5)
        engine = registry.retune((1, 8, 32, 64, 128))
        time.sleep(0.5)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
    assert not errors, errors[:3]
    assert registry.retunes == 1 and engine.buckets == (1, 8, 32, 64, 128)
    assert sorted(engine.graph_stats()) == [1, 8, 32, 64, 128]
    assert answers and all((a == want).all() for a in answers)
    np.testing.assert_array_equal(registry.infer(x), want)


def test_a_failed_capture_raises_and_never_serves_eagerly(cuda, monkeypatch):
    engine = _graph_engine(cuda, "fp32", buckets=(1, 8))
    real = engine._graph_forward

    def waits_for_the_device(x):
        # A host wait inside the capture: not capturable.
        if torch.cuda.is_current_stream_capturing():
            float(x.sum())
        return real(x)

    monkeypatch.setattr(engine, "_graph_forward", waits_for_the_device)
    with pytest.raises(RuntimeError):
        engine.warmup()
    assert not engine._warmed and not engine.graph_stats()
    # The card is still usable.
    monkeypatch.setattr(engine, "_graph_forward", real)
    fresh = _graph_engine(cuda, "fp32", buckets=(1, 8))
    fresh.warmup()
    assert sorted(fresh.graph_stats()) == [1, 8]


def test_the_profiler_sees_block1_inside_graph_replays(cuda):
    from eegnetreplication_tpu_torch.utils import profiling

    engine = _graph_engine(cuda, "fp32")
    engine.warmup()
    x = _trials(128, 22, 257).numpy()
    row = profiling.engine_breakdown(engine, x, n_calls=5)
    names = [k["name"] for k in row["top_device_ms_per_call"]]
    assert any("block1_kernel" in n for n in names), names


# --- Online adaptation: the shadow and the fine-tune on the card ----------------

def _adapt_case(tmp_path, n_windows=40):
    """A product-width base checkpoint and a replay buffer of labeled,
    standardized cue windows (the drill's drifted stream)."""
    from eegnetreplication_tpu_torch.adapt.buffer import ReplayBuffer
    from eegnetreplication_tpu_torch.utils import adapt_drill

    base = checkpoint.save_checkpoint(
        tmp_path / "base.npz", _model(22, 257, 8, 2, seed=31).state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    cue = adapt_drill.CueStream(22, 257, seed=5)
    x, y = adapt_drill.drifted_windows(cue, n_windows, n_windows // 4,
                                       device="cpu")
    buf = ReplayBuffer()
    for k in range(n_windows):
        buf.observe("a", "s", k, x[k])
        buf.label("a", "s", k, int(y[k]))
    return base, buf, x


def _card_zoo(cuda, tmp_path, base, n=9):
    from eegnetreplication_tpu_torch.serve.registry import ModelZoo

    zoo_dir = tmp_path / "zoo"
    zoo_dir.mkdir(exist_ok=True)
    (zoo_dir / "a.npz").write_bytes(base.read_bytes())
    for z in range(1, n):
        checkpoint.save_checkpoint(
            zoo_dir / f"t{z}.npz", _model(22, 257, 8, 2, seed=z).state_dict(),
            metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                      "F1": 8, "D": 2})
    return ModelZoo(str(zoo_dir), default="a", device=cuda)


def _fine_tune(cuda, buf, base, out, seed=0, steps=20):
    from eegnetreplication_tpu_torch.adapt.worker import AdaptationWorker

    worker = AdaptationWorker(buf, out, steps=steps, batch_size=32,
                              seed=seed, device=cuda)
    return worker.fine_tune("a", base)


def test_shadow_graph_replay_is_bitwise_the_eager_bucket1_forward(
        cuda, tmp_path):
    from eegnetreplication_tpu_torch.serve.engine import (
        load_model_from_checkpoint,
    )

    base, buf, x = _adapt_case(tmp_path)
    cand = _fine_tune(cuda, buf, base, tmp_path / "adapt")
    zoo = _card_zoo(cuda, tmp_path, base)
    k1 = fused.block1.launches
    assert zoo.register_shadow("a", cand.path) == cand.digest
    engine, _ = zoo._shadows["a"]
    assert sorted(engine.graph_stats()) == [1]
    assert fused.block1.launches == k1 + 1          # the eager warm run
    for k in range(8):
        arg = torch.from_numpy(x[k:k + 1]).to(cuda)
        with torch.inference_mode():
            eager = engine.forward(arg).cpu()
        assert torch.equal(engine.graph_logits(arg).cpu(), eager)
        np.testing.assert_array_equal(zoo.shadow_infer("a", x[k:k + 1]),
                                      eager.argmax(-1).numpy())
    # The candidate's logits on the card against its plain CPU forward.
    cpu = InferenceEngine(load_model_from_checkpoint(cand.path,
                                                     device="cpu"),
                          (1,), device="cpu")
    with torch.inference_mode():
        got = engine.forward(torch.from_numpy(x).to(cuda)).cpu()
        want = cpu.forward(torch.from_numpy(x))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_k1_launches_equal_the_shadow_evals(cuda, tmp_path):
    from eegnetreplication_tpu_torch.adapt.shadow import ShadowEvaluator
    from eegnetreplication_tpu_torch.serve.engine import BucketGraph

    base, buf, x = _adapt_case(tmp_path)
    cand = _fine_tune(cuda, buf, base, tmp_path / "adapt", steps=5)
    zoo = _card_zoo(cuda, tmp_path, base)
    zoo.register_shadow("a", cand.path)
    k1, k1s = fused.block1.launches, fused.block1_stacked.launches
    replays = BucketGraph.replays
    shadow = ShadowEvaluator()
    shadow.start("a", lambda w: zoo.shadow_infer("a", w), cand.digest)
    for k in range(len(x)):
        shadow.tee("a", x[k], 0, label=k % 4 if k % 2 else None)
    assert shadow.drain(60)
    shadow.close()
    assert fused.block1.launches - k1 == len(x)      # one per shadow eval
    assert BucketGraph.replays - replays == len(x)
    assert fused.block1_stacked.launches == k1s


def test_two_card_fine_tunes_give_equal_digests(cuda, tmp_path):
    base, buf, _ = _adapt_case(tmp_path)
    first = _fine_tune(cuda, buf, base, tmp_path / "one", seed=4)
    second = _fine_tune(cuda, buf, base, tmp_path / "two", seed=4)
    other = _fine_tune(cuda, buf, base, tmp_path / "three", seed=5)
    assert first.digest == second.digest and first.loss == second.loss
    assert (tmp_path / "one" / "a.candidate.npz").read_bytes() == \
        (tmp_path / "two" / "a.candidate.npz").read_bytes()
    assert other.digest != first.digest     # the seed reaches dropout


def test_card_fine_tune_tracks_the_cpu_fine_tune(cuda, tmp_path,
                                                 monkeypatch):
    from eegnetreplication_tpu_torch.adapt.worker import AdaptationWorker
    from eegnetreplication_tpu_torch.serve import engine as engine_lib

    load = engine_lib.load_model_from_checkpoint

    def at_dropout_0(path, **kw):
        model = load(path, **kw)
        model.dropout_rate = 0.0
        return model

    monkeypatch.setattr(engine_lib, "load_model_from_checkpoint",
                        at_dropout_0)
    base, buf, _ = _adapt_case(tmp_path)
    out = {}
    for name, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        worker = AdaptationWorker(buf, tmp_path / name, steps=20,
                                  batch_size=32, seed=2, device=dev)
        cand = worker.fine_tune("a", base)
        out[name] = (cand, checkpoint.load_checkpoint(cand.path)[0])
    (card, card_sd), (cpu, cpu_sd) = out["card"], out["cpu"]
    for k in cpu_sd:
        tol = 20 * 1e-3 if k.startswith("temporal.1.") else 2e-3
        torch.testing.assert_close(card_sd[k], cpu_sd[k], rtol=2e-3,
                                   atol=tol, msg=k)
    assert abs(card.loss - cpu.loss) <= 2e-3 * (1 + abs(cpu.loss))


def test_register_shadow_during_predict_and_session_traffic_drops_nothing(
        cuda, tmp_path):
    """The shadow's capture runs while another thread serves mixed-tenant
    batches through the zoo's graphs and a third pushes a K2s session:
    nothing fails and every answer is the stack's."""
    from eegnetreplication_tpu_torch.serve.sessions import StreamSession

    base, buf, x = _adapt_case(tmp_path)
    cand = _fine_tune(cuda, buf, base, tmp_path / "adapt", steps=5)
    zoo = _card_zoo(cuda, tmp_path, base)
    trials = _trials(40, 22, 257, seed=9).numpy()
    idx = np.arange(40) % 9
    want = zoo.infer(trials, idx)
    stop, errors, answers = threading.Event(), [], []

    def serve():
        while not stop.is_set():
            try:
                answers.append(zoo.infer(trials, idx))
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

    def push():
        session = StreamSession("r", n_channels=22, window=257, hop=64,
                                device=cuda)
        sig = _stream_signal(22, 200_000, seed=8).numpy()
        pos = 0
        while not stop.is_set() and pos < sig.shape[1]:
            try:
                session.ingest(sig[:, pos:pos + 25])
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)
            pos += 25

    threads = [threading.Thread(target=serve), threading.Thread(target=push)]
    for th in threads:
        th.start()
    try:
        time.sleep(0.3)
        digest = zoo.register_shadow("a", cand.path)
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
    assert not errors, errors[:3]
    assert digest == cand.digest and answers
    assert all((a == want).all() for a in answers)
    assert zoo.shadow_infer("a", x[:1]).shape == (1,)


# --- The model layer: the baselines, the banded schedule, CSP and Riemann ---

BASELINE_NAMES = ("shallow_convnet", "deep_convnet")


def _baseline(name, seed=0):
    from eegnetreplication_tpu_torch.models import get_model

    return get_model(name, n_channels=22, n_times=257, device="cpu",
                     generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("name", BASELINE_NAMES)
def test_baseline_forward_on_the_card_matches_the_cpu(cuda, name):
    """Eval logits at atol 1e-5 / rtol 1e-4; a training step of 8 folds at
    dropout 0 within 2e-3 of the CPU's; neither launches K1 nor
    K1-stacked."""
    model = _baseline(name)
    x = torch.randn(64, 22, 257, generator=torch.Generator().manual_seed(1))
    want = model(x)
    fused.block1.launches = fused.block1_stacked.launches = 0
    got = model.to(cuda)(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    model = _baseline(name).to("cpu")
    model.dropout_rate = 0.0
    init = loop.init_fold_states(model, 8, torch.Generator().manual_seed(2))
    xs = torch.randn(8, 16, 22, 257,
                     generator=torch.Generator().manual_seed(3))
    y = torch.randint(0, 4, (8, 16), generator=torch.Generator().manual_seed(4))
    w = torch.ones(8, 16)
    kw = dict(learning_rate=1e-3, adam_eps=1e-7)
    _, want_loss, _ = steps.train_step(model, init, xs, y, w, **kw)
    _, got_loss, _ = steps.train_step(model, init.to(cuda), xs.to(cuda),
                                      y.to(cuda), w.to(cuda), **kw)
    torch.testing.assert_close(got_loss.cpu(), want_loss, atol=2e-3,
                               rtol=2e-3)
    assert fused.block1.launches == fused.block1_stacked.launches == 0


@pytest.mark.parametrize("name", BASELINE_NAMES)
def test_baseline_graph_replay_is_bitwise_the_eager_forward(cuda, name):
    engine = InferenceEngine(_baseline(name, seed=5), device=cuda)
    engine.warmup()
    assert sorted(engine.graph_stats()) == [1, 8, 32, 128]
    for b in engine.buckets:
        x = torch.randn(b, 22, 257, generator=torch.Generator().manual_seed(
            60 + b)).to(cuda)
        with torch.inference_mode():
            eager = engine.forward(x).cpu()
        assert torch.equal(engine.graph_logits(x).cpu(), eager), (name, b)
        assert engine.graph_stats()[b]["kernels"] == {}


@pytest.mark.parametrize("t", [257, 1125])
def test_banded_stacked_forward_on_the_card_matches_lax(cuda, t):
    """Logits, statistics and gradients of 8 stacked EEGNets under both
    schedules on the card (1e-5 forward, 1e-4 gradients)."""
    from eegnetreplication_tpu_torch.models.eegnet import stacked_forward

    model = EEGNet(22, t, device="cpu")
    init = loop.init_fold_states(model, 8, torch.Generator().manual_seed(7))
    x = torch.randn(8, 16, 22, t,
                    generator=torch.Generator().manual_seed(8)).to(cuda)
    out = {}
    for impl in ("lax", "banded"):
        state = init.to(cuda)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in state.param_views().items()}
        logits, new = stacked_forward(params, state.stat_views(), x,
                                      train=True, conv_impl=impl)
        grads = torch.autograd.grad(logits.square().sum(),
                                    list(params.values()))
        out[impl] = (logits.detach(), new, grads)
    torch.testing.assert_close(out["banded"][0], out["lax"][0], atol=1e-5,
                               rtol=1e-5)
    for k in out["lax"][1]:
        torch.testing.assert_close(out["banded"][1][k], out["lax"][1][k],
                                   atol=1e-5, rtol=1e-5)
    for a, b in zip(out["banded"][2], out["lax"][2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_two_banded_card_runs_are_bitwise_equal(cuda):
    model = EEGNet(22, 257, conv_impl="banded", device="cpu")
    init = loop.init_fold_states(model, 4, torch.Generator().manual_seed(9))
    xs = torch.randn(4, 32, 22, 257,
                     generator=torch.Generator().manual_seed(10)).to(cuda)
    y = torch.randint(0, 4, (4, 32),
                      generator=torch.Generator().manual_seed(11)).to(cuda)
    w = torch.ones(4, 32, device=cuda)
    runs = []
    for _ in range(2):
        state = init.to(cuda)
        gen = torch.Generator(device=cuda).manual_seed(12)
        for _ in range(3):
            state, _, _ = steps.train_step(model, state, xs, y, w,
                                           learning_rate=1e-3,
                                           adam_eps=1e-7, generator=gen)
        runs.append(state.params.cpu())
    assert torch.equal(runs[0], runs[1])


def test_csp_and_riemann_on_the_card_match_the_cpu(cuda):
    from eegnetreplication_tpu_torch.models import csp, riemann

    rng = np.random.RandomState(13)
    y = rng.randint(0, 4, 200)
    x = rng.randn(200, 22, 257).astype(np.float32)
    patterns = rng.randn(4, 22)
    for k in range(4):
        wave = np.sin(np.arange(257) * (0.2 + 0.1 * k))
        x[y == k] += (0.8 * patterns[k][:, None] * wave).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for fit in (csp.csp_lda_fit_predict, riemann.tangent_lda_fit_predict):
        want = fit(xt[:150], yt[:150], xt[150:])
        got = fit(xt[:150].to(cuda), yt[:150].to(cuda), xt[150:].to(cuda))
        assert got.is_cuda
        assert torch.equal(got.cpu(), want), fit.__name__
    want = csp.csp_transform(xt, csp.csp_fit(xt, yt))
    got = csp.csp_transform(xt.to(cuda), csp.csp_fit(xt.to(cuda),
                                                     yt.to(cuda)))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_a_two_replica_fleet_answers_as_predict(cuda, tmp_path):
    """``python -m eegnetreplication_tpu_torch.serve.fleet --replicas 2``
    on the card: both replicas live with one digest, and ``/predict``
    through the fleet answers byte for byte as a replica does (but its
    ``latency_ms``), with ``predict_trials``' predictions; every replica
    launched K1 (its warm runs plus its graph replays)."""
    import json
    import os
    import re
    import signal
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        load_model_from_checkpoint,
    )

    repo = Path(__file__).resolve().parents[1]
    model = _model(22, 257, 8, 2, seed=31)
    ckpt = checkpoint.save_checkpoint(
        tmp_path / "m.npz", model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    x = torch.randn(33, 22, 257,
                    generator=torch.Generator().manual_seed(32)).numpy()
    want = predict_trials(load_model_from_checkpoint(ckpt, device=cuda), x,
                          device=cuda)
    env = {k: v for k, v in os.environ.items() if k != "EEGTPU_PLATFORM"}
    env.update(EEGTPU_NO_LOG_FILE="1", EEGTPU_DATA_ROOT=str(tmp_path),
               PYTHONPATH=str(repo))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve.fleet",
         "--checkpoint", str(ckpt), "--replicas", "2", "--port", "0",
         "--metricsDir", str(tmp_path / "obs")],
        cwd=repo, env=env, stdout=subprocess.PIPE, text=True,
        start_new_session=True)

    def post(url, body):
        req = urllib.request.Request(
            url + "/predict", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read()

    try:
        url = None
        for line in proc.stdout:
            if line.startswith("fleet serving at "):
                url = line.split()[3]
                break
        assert url is not None, "the fleet exited before serving"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["n_live"] == 2 and len(health["serving_digests"]) == 1
        mask = re.compile(rb'"latency_ms": [-+0-9.eE]+')
        for n in (1, 33):
            body = json.dumps({"trials": x[:n].tolist()}).encode()
            got = post(url, body)
            direct = post(health["replicas"][0]["url"], body)
            assert mask.sub(b"", got) == mask.sub(b"", direct)
            assert json.loads(got)["predictions"] == want[:n].tolist()
        for row in health["replicas"]:
            with urllib.request.urlopen(row["url"] + "/healthz",
                                        timeout=30) as resp:
                h = json.loads(resp.read())
            launches = h["kernel_launches"]["block1"]
            assert launches > 0
            assert launches == len(h["buckets"]) + h["graph_replays"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            assert proc.wait(timeout=120) == 75
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
