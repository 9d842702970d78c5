"""The torch port's CUDA kernels on a card (``gpu`` marker).

These skip on a host without CUDA.  The machine with the card has no JAX,
so this file imports none of it, and the repository's ``conftest.py`` (which
pins JAX to the CPU) must be skipped there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

K1 (``block1``) is held against its plain version ``block1_reference`` on
the same card at the serving shapes, atol/rtol 1e-5 (only the order of the
f32 sums differs), also at T on the edges of its time tile, at T=1125
and at B=1024; the engine's fused forward on the card against the
plain forward on the CPU at atol 1e-5 / rtol 1e-4.  K2 (``ems``) is held
against ``ems_reference`` on the card at a session's (22, 345600) and the
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
