"""The torch port's EEGNet and fused forward against the JAX package.

Weights are drawn once with numpy and carried across with
``from_jax_variables``; the port's eval logits (plain ``EEGNet.forward``
and ``fused_eval_forward``) must match the JAX ``model.apply(train=False)``
and ``steps.eval_forward(..., allow_pallas=False)`` to rtol 1e-4 /
atol 1e-5 (the tolerances of ``test_parity_torch.py``), at the product
width, an even T, the wide config (F2=64) and a small geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_cases import (
    GEOMETRIES,
    PRODUCT,
    jax_model,
    jax_variables,
    port_model,
    trials,
)

from eegnetreplication_tpu.training.checkpoint import to_torch_state_dict
from eegnetreplication_tpu.training.steps import eval_forward
from eegnetreplication_tpu_torch.models import EEGNet, eegnet_wide
from eegnetreplication_tpu_torch.ops.fused_eegnet import fused_eval_forward

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def geometry(request):
    c, t, f1, d = GEOMETRIES[request.param]
    params, bs = jax_variables(c, t, f1, d, seed=5)
    x = trials(6, c, t, seed=6)
    return (c, t, f1, d), params, bs, x


def test_plain_forward_matches_jax_apply(geometry):
    (c, t, f1, d), params, bs, x = geometry
    want = jax_model(c, t, f1, d).apply(
        {"params": params, "batch_stats": bs}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port_model(params, bs, c, t, f1, d)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fused_forward_matches_jax_eval_forward(geometry):
    (c, t, f1, d), params, bs, x = geometry
    want = eval_forward(jax_model(c, t, f1, d), params, bs, jnp.asarray(x),
                        allow_pallas=False)
    with torch.no_grad():
        got = fused_eval_forward(port_model(params, bs, c, t, f1, d),
                                 torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.argmax(np.asarray(want), -1))


@pytest.mark.parametrize("name", ["product", "wide"])
def test_drawn_variables_have_the_flax_init_structure(name):
    """The parity tests draw the JAX tree with numpy instead of compiling
    ``model.init``; it must match what ``model.init`` makes."""
    c, t, f1, d = GEOMETRIES[name]
    shapes = jax.eval_shape(
        lambda: jax_model(c, t, f1, d).init(
            jax.random.PRNGKey(0), jnp.zeros((1, c, t)), train=False))
    params, bs = jax_variables(c, t, f1, d)
    want = jax.tree_util.tree_map(lambda s: (s.shape, str(s.dtype)),
                                  {"params": shapes["params"],
                                   "batch_stats": shapes["batch_stats"]})
    got = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                 {"params": params, "batch_stats": bs})
    assert got == want


def test_layer_names_are_the_reference_state_dict():
    c, t, f1, d = PRODUCT
    params, bs = jax_variables(c, t, f1, d)
    reference = to_torch_state_dict(params, bs, f1 * d, t // 32)
    model = EEGNet(c, t, F1=f1, D=d, device="cpu")
    assert set(model.state_dict()) == set(reference)
    for key, value in model.state_dict().items():
        assert tuple(value.shape) == np.shape(reference[key]), key


def test_eegnet_wide_geometry():
    model = eegnet_wide(device="cpu")
    assert (model.F1, model.D, model.F2) == (16, 4, 64)
    assert model.classifier.in_features == 64 * 8
    assert model.spatial.weight.shape == (64, 1, 22, 1)


def test_seeded_init_is_reproducible_and_torch_shaped():
    def make(seed):
        return EEGNet(device="cpu",
                      generator=torch.Generator().manual_seed(seed))

    a, b, c = make(1), make(1), make(2)
    for key in a.state_dict():
        assert torch.equal(a.state_dict()[key], b.state_dict()[key]), key
    assert not torch.equal(a.classifier.weight, c.classifier.weight)
    bound = 1.0 / np.sqrt(22)            # spatial conv fan-in: C x 1
    assert float(a.spatial.weight.detach().abs().max()) <= bound


def test_training_mode_forward_raises():
    """Training mode is ported (``models/norm.py``'s BatchNorm, checked
    against the JAX model in ``test_torch_training_units.py``); what it
    refuses is padding weights that do not match the batch."""
    model = EEGNet(8, 64, device="cpu")
    model.train()
    assert model(torch.zeros(2, 8, 64)).shape == (2, 4)
    with pytest.raises(ValueError, match="sample_weights"):
        model(torch.zeros(2, 8, 64), torch.ones(3))


def test_wrong_geometry_raises():
    model = EEGNet(8, 64, device="cpu")
    with pytest.raises(ValueError, match="Expected input"):
        model(torch.zeros(1, 8, 65))
