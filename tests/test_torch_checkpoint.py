"""Checkpoints cross between the JAX package and the torch port.

A native ``.npz`` or a reference ``.pth`` written by either package loads in
the other with equal weights and the same ``variables_digest``; a corrupted
``.npz`` raises ``IntegrityError`` in the port as in the JAX package.
"""

import json

import numpy as np
import pytest
import torch
from torch_port_cases import GEOMETRIES, PRODUCT, jax_variables, port_model

from eegnetreplication_tpu.resil import integrity as jax_integrity
from eegnetreplication_tpu.serve import engine as jax_engine
from eegnetreplication_tpu.training import checkpoint as jax_ckpt
from eegnetreplication_tpu_torch.resil import integrity
from eegnetreplication_tpu_torch.serve import engine
from eegnetreplication_tpu_torch.training import checkpoint as ckpt


def _meta(c, t, f1, d):
    return {"model": "eegnet", "n_channels": c, "n_times": t, "F1": f1,
            "D": d}


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key])
        else:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), key)


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.fixture(params=["product", "wide"])
def variables(request):
    c, t, f1, d = GEOMETRIES[request.param]
    params, bs = jax_variables(c, t, f1, d, seed=9)
    return (c, t, f1, d), params, bs


def test_port_npz_loads_in_jax(variables, tmp_path):
    geo, params, bs = variables
    model = port_model(params, bs, *geo)
    path = ckpt.save_checkpoint(tmp_path / "port.npz", model.state_dict(),
                                metadata=_meta(*geo))
    got_params, got_bs, meta = jax_ckpt.load_checkpoint(path)
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_bs, bs)
    assert meta == _meta(*geo)
    port_digest = engine.InferenceEngine(model, device="cpu").digest
    assert jax_engine.variables_digest(got_params, got_bs) == port_digest


def test_jax_npz_loads_in_port(variables, tmp_path):
    geo, params, bs = variables
    path = jax_ckpt.save_checkpoint(tmp_path / "jax.npz", params, bs,
                                    metadata=_meta(*geo))
    state_dict, meta = ckpt.load_checkpoint(path)
    assert meta == _meta(*geo)
    _assert_state_dicts_equal(state_dict,
                              ckpt.from_jax_variables(params, bs))
    model = engine.load_model_from_checkpoint(path, device="cpu")
    assert (model.n_channels, model.n_times, model.F1, model.D) == geo
    assert engine.InferenceEngine(model, device="cpu").digest \
        == jax_engine.variables_digest(params, bs)


def test_port_pth_loads_in_jax(variables, tmp_path):
    geo, params, bs = variables
    model = port_model(params, bs, *geo)
    path = ckpt.save_pth(tmp_path / "port.pth", model.state_dict())
    got_params, got_bs, meta = jax_ckpt.load_pth_auto(path)
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_bs, bs)
    c, t, f1, d = geo
    assert meta == {"model": "eegnet", "n_channels": c,
                    "n_times": (t // 32) * 32 + 1, "F1": f1, "D": d}


def test_jax_pth_loads_in_port(variables, tmp_path):
    geo, params, bs = variables
    c, t, f1, d = geo
    path = jax_ckpt.save_pth(tmp_path / "jax.pth", params, bs, f1 * d,
                             t // 32)
    state_dict, meta = ckpt.load_pth_auto(path)
    _, _, jax_meta = jax_ckpt.load_pth_auto(path)
    assert meta == jax_meta
    _assert_state_dicts_equal(state_dict,
                              ckpt.from_jax_variables(params, bs))
    model = engine.load_model_from_checkpoint(path, device="cpu")
    assert engine.InferenceEngine(model, device="cpu").digest \
        == jax_engine.variables_digest(params, bs)


def test_variables_roundtrip_is_exact(variables):
    geo, params, bs = variables
    got_params, got_bs = ckpt.to_jax_variables(
        ckpt.from_jax_variables(params, bs))
    _assert_trees_equal(got_params, params)
    _assert_trees_equal(got_bs, bs)


def test_classifier_permutation_matches_jax_export(variables):
    geo, params, bs = variables
    c, t, f1, d = geo
    want = jax_ckpt.to_torch_state_dict(params, bs, f1 * d, t // 32)
    got = ckpt.from_jax_variables(params, bs)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)


def test_content_digest_is_byte_identical_to_jax():
    rng = np.random.RandomState(0)
    flat = {"params/a/kernel": rng.randn(3, 4).astype(np.float32),
            "batch_stats/b/mean": rng.randn(5).astype(np.float32),
            "__step__": np.asarray(7, np.int64),
            "__signature__": np.frombuffer(b"{}", np.uint8)}
    assert integrity.content_digest(flat) \
        == jax_integrity.content_digest(flat)
    assert integrity.stamp(dict(flat))[integrity.DIGEST_KEY].tobytes() \
        == jax_integrity.stamp(dict(flat))[jax_integrity.DIGEST_KEY].tobytes()


def _saved(tmp_path):
    c, t, f1, d = PRODUCT
    params, bs = jax_variables(c, t, f1, d)
    model = port_model(params, bs, c, t, f1, d)
    return ckpt.save_checkpoint(tmp_path / "m.npz", model.state_dict(),
                                metadata=_meta(c, t, f1, d))


def test_tampered_npz_raises_and_is_quarantined(tmp_path):
    path = _saved(tmp_path)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    flat["params/classifier/bias"] = flat["params/classifier/bias"] + 1.0
    with open(path, "wb") as fh:
        np.savez(fh, **flat)
    with pytest.raises(integrity.IntegrityError, match="digest mismatch"):
        ckpt.load_checkpoint(path)
    assert not path.exists()
    assert (tmp_path / "m.npz.corrupt").exists()


def test_truncated_npz_raises_and_stays(tmp_path):
    path = _saved(tmp_path)
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(integrity.IntegrityError, match="unreadable"):
        engine.load_model_from_checkpoint(path, device="cpu")
    assert path.exists()


def test_non_eegnet_and_orbax_checkpoints_are_refused(tmp_path):
    """A checkpoint's ``model`` picks the registry's architecture: EEGNet
    weights labelled ``shallow_convnet`` do not load into one, while a
    ShallowConvNet the JAX package wrote does; a directory that is no
    Orbax checkpoint (no ``metadata.json``) is refused loudly."""
    c, t, f1, d = PRODUCT
    params, bs = jax_variables(c, t, f1, d)
    path = jax_ckpt.save_checkpoint(
        tmp_path / "mislabelled.npz", params, bs,
        metadata=dict(_meta(c, t, f1, d), model="shallow_convnet"))
    with pytest.raises(RuntimeError, match="ShallowConvNet"):
        engine.load_model_from_checkpoint(path, device="cpu")
    import jax
    import jax.numpy as jnp

    from eegnetreplication_tpu.models import get_model as jax_get_model

    shallow = jax_get_model("shallow_convnet", n_channels=6, n_times=64)
    variables = shallow.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 64)))
    path = jax_ckpt.save_checkpoint(
        tmp_path / "shallow.npz", variables["params"],
        variables["batch_stats"],
        metadata={"model": "shallow_convnet", "n_channels": 6,
                  "n_times": 64})
    model = engine.load_model_from_checkpoint(path, device="cpu")
    assert type(model).__name__ == "ShallowConvNet"
    assert (model.n_channels, model.n_times) == (6, 64)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(FileNotFoundError, match="no metadata.json"):
        engine.load_model_from_checkpoint(tmp_path / "orbax_dir",
                                          device="cpu")


def test_saved_metadata_is_plain_json(tmp_path):
    path = _saved(tmp_path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__metadata__"]).decode())
        assert integrity.DIGEST_KEY in data.files
    assert meta == _meta(*PRODUCT)
