"""The torch port's CUDA kernels on a card (``gpu`` marker).

These skip on a host without CUDA.  The machine with the card has no JAX,
so this file imports none of it, and the repository's ``conftest.py`` (which
pins JAX to the CPU) must be skipped there:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

K1 (``block1``) is held against its plain version ``block1_reference`` on
the same card at the serving shapes, atol/rtol 1e-5 (only the order of the
f32 sums differs); the engine's fused forward on the card against the
plain forward on the CPU at atol 1e-5 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from eegnetreplication_tpu_torch.models import EEGNet
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
    """T=1125 (250 Hz) needs ~139 KB of shared memory per block: the
    opt-in attribute path."""
    model = _model(22, 1125, 8, 2).to(cuda)
    x = _trials(4, 22, 1125).to(cuda)
    with torch.no_grad():
        folded = fused.fold_block1_params(model.state_dict(),
                                          model.bn_epsilon)
        got = fused.block1(x, *folded)
        want = fused.block1_reference(x, *folded)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


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
