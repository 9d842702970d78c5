"""The torch port's fused block 1 against the JAX package's.

``fold_block1_params`` and ``block1_reference`` are held against the JAX
``fold_block1_params``, ``block1_reference`` and the Pallas kernel run in
interpret mode, at the product width (22x257), an even T (22x256), the
wide config and a small geometry, with perturbed BatchNorm; atol 1e-5 as
in ``tests/test_fused_eegnet.py`` (only the order of f32 sums differs).
The CUDA kernel itself runs only on a card: ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_cases import GEOMETRIES, jax_variables, port_model, trials

from eegnetreplication_tpu.ops import fused_eegnet as jax_fused
from eegnetreplication_tpu_torch.ops import build
from eegnetreplication_tpu_torch.ops import fused_eegnet as fused

ATOL = 1e-5

CASES = [("product", False), ("product", True), ("t256", True),
         ("wide", True), ("small", True)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{g}-{'bn' if p else 'init'}" for g, p in CASES])
def case(request):
    name, perturb = request.param
    c, t, f1, d = GEOMETRIES[name]
    params, bs = jax_variables(c, t, f1, d, perturb_bn=perturb)
    model = port_model(params, bs, c, t, f1, d)
    x = trials(3, c, t)
    jax_folded = jax_fused.fold_block1_params(params, bs)
    with torch.no_grad():
        folded = fused.fold_block1_params(model.state_dict(),
                                          model.bn_epsilon)
    return x, jax_folded, folded, model


def test_fold_matches_jax(case):
    _, jax_folded, folded, _ = case
    for name, want, got in zip("SWAB", jax_folded, folded):
        assert got.is_contiguous(), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=1e-6, err_msg=name)


def test_reference_matches_jax_reference(case):
    x, jax_folded, folded, _ = case
    want = jax_fused.block1_reference(jnp.asarray(x), *jax_folded)
    got = fused.block1_reference(torch.from_numpy(x), *folded)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_reference_matches_pallas_interpret(case):
    x, jax_folded, folded, _ = case
    want = jax_fused.block1_pallas(jnp.asarray(x), *jax_folded,
                                   interpret=True)
    got = fused.block1_reference(torch.from_numpy(x), *folded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(case):
    x, _, folded, _ = case
    before = fused.block1.launches
    got = fused.block1(torch.from_numpy(x), *folded)
    want = fused.block1_reference(torch.from_numpy(x), *folded)
    assert torch.equal(got, want)
    assert fused.block1.launches == before


def test_fused_forward_matches_plain_forward(case):
    x, _, _, model = case
    with torch.no_grad():
        want = model(torch.from_numpy(x))
        got = fused.fused_eval_forward(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=1e-4)


def _operands(c=4, t=16, f2=2, n=2):
    return (torch.zeros(n, c, t), torch.zeros(f2, c),
            torch.zeros(f2, fused.TEMPORAL_K), torch.zeros(f2),
            torch.zeros(f2))


@pytest.mark.parametrize("bad, error", [
    (lambda ops: (ops[0].double(),) + ops[1:], TypeError),
    (lambda ops: (ops[0].transpose(1, 2),) + ops[1:], ValueError),
    (lambda ops: (ops[0][0],) + ops[1:], ValueError),
    (lambda ops: ops[:1] + (torch.zeros(2, 5),) + ops[2:], ValueError),
    (lambda ops: ops[:2] + (torch.zeros(2, 16),) + ops[3:], ValueError),
    (lambda ops: (torch.zeros(2, 4, 3),) + ops[1:], ValueError),
], ids=["dtype", "contiguity", "rank", "S-shape", "W-taps", "short-T"])
def test_kernel_operand_checks_raise(bad, error):
    with pytest.raises(error):
        fused._check_operands(*bad(_operands()))


def test_unknown_device_raises():
    ops = [t.to("meta") for t in _operands()]
    with pytest.raises(ValueError, match="no kernel"):
        fused.block1(*ops)


def test_library_name_tracks_source_and_flags(monkeypatch):
    path = build.library_path("block1")
    assert path.parent == build.BUILD_DIR
    assert path == build.library_path("block1")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("block1") != path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    real_is_file = build.Path.is_file
    monkeypatch.setattr(
        build.Path, "is_file",
        lambda self: False if self.name == "nvcc" else real_is_file(self))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
