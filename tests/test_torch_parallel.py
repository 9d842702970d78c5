"""The port's ``parallel/`` against the JAX package's, in one world of four
gloo ranks on the CPU.

The world runs once for the module (``utils/mesh_drill.py`` in a child
process that forks its four ranks; inputs drawn with numpy, weights from
the JAX initialization through ``from_jax_variables``).  Against it:

- the mesh shapes and ``ValueError``s of JAX ``tests/test_parallel.py``
  and the hybrid mesh of ``tests/test_multihost.py`` (two blocks of two);
- ``state_shard_spec`` shards the same logical axis of the same leaves as
  the JAX one for EEGNet and both baselines, and a model rank holds half
  the moment elements;
- the 2-rank DP step against JAX ``make_dp_train_step`` on a ``(1, 2, 1)``
  mesh (dropout 0, both BatchNorm modes) at the JAX test's tolerances:
  loss rtol 1e-5, parameters atol 1e-3 and statistics rtol 1e-4 / atol
  1e-6 after one step, the second step's loss rtol 1e-3; and against the
  port's own one-process step on the whole batch;
- the DP eval's loss sum and correct count against JAX
  ``make_dp_eval_step``;
- ZeRO (model axis 2) bitwise the replicated 2-rank step over 5 steps;
- ``ems_time_sharded`` over 2 and 4 ranks against the JAX function and the
  port's one-shot ``scan`` (atol 2e-4 / rtol 2e-3), and its shape checks.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_cases import child_env, jax_baseline, jax_model, jax_variables

from eegnetreplication_tpu.ops.ems import ems_time_sharded as jax_ems_sharded
from eegnetreplication_tpu.parallel import make_dp_eval_step as jax_dp_eval
from eegnetreplication_tpu.parallel import make_dp_train_step as jax_dp_step
from eegnetreplication_tpu.parallel import make_mesh as jax_make_mesh
from eegnetreplication_tpu.parallel import state_shard_spec as jax_shard_spec
from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu_torch.models import EEGNet, get_model
from eegnetreplication_tpu_torch.ops import ems as port_ems
from eegnetreplication_tpu_torch.parallel import mesh as mesh_lib
from eegnetreplication_tpu_torch.parallel import shardspec
from eegnetreplication_tpu_torch.training import steps
from eegnetreplication_tpu_torch.training.checkpoint import (
    _layers,
    from_jax_variables,
    to_jax_variables,
)
from eegnetreplication_tpu_torch.utils import mesh_drill

C, T, F1, D = 8, 64, 8, 2
BATCH, STEPS = 16, 5
EMS_SHAPE, EMS_BLOCK = (3, 2400), 300
LR, EPS = 1e-3, 1e-7


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("drill")
    inputs = mesh_drill.make_inputs(c=C, t=T, f1=F1, d=D, batch=BATCH,
                                    steps=STEPS, ems_shape=EMS_SHAPE,
                                    ems_block=EMS_BLOCK)
    params, stats = jax_variables(C, T, F1, D, seed=3, perturb_bn=False)
    for k, v in from_jax_variables(params, stats).items():
        if not k.endswith("num_batches_tracked"):
            inputs[f"sd/{k}"] = v.numpy()
    inputs["w"][1, -3:] = 0.0        # padding slots at weight 0
    np.savez(tmp / "in.npz", **inputs)
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.utils.mesh_drill",
         "--inputs", str(tmp / "in.npz"), "--out", str(tmp / "out.npz")],
        env=child_env(EEGTPU_PLATFORM="cpu", EEGTPU_NO_LOG_FILE="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(tmp / "out.npz") as f:
        rec = {k: f[k] for k in f.files}
    rec["info"] = json.loads(str(rec.pop("__json__")))
    return inputs, (params, stats), rec


# -- the mesh -----------------------------------------------------------------

def test_mesh_shapes_equal_the_jax_meshes(drill):
    shapes = drill[2]["info"]["shapes"]
    devs = jax.devices()[:4]
    for name, kw in (("default", {}), ("a", {"n_fold": 2, "n_data": 2}),
                     ("b", {"n_fold": 1, "n_data": 2, "n_model": 2}),
                     ("c", {"n_fold": 1, "n_data": 4}),
                     ("fold_model_4", {"n_model": 4})):
        assert shapes[name] == dict(jax_make_mesh(devices=devs, **kw).shape)
    assert shapes["b"] == {"fold": 1, "data": 2, "model": 2}
    assert list(shapes["a"]) == ["fold", "data", "model"]


def test_hybrid_mesh_keeps_data_lines_within_a_host(drill):
    shapes = drill[2]["info"]["shapes"]
    # JAX test_multihost: make_hybrid_mesh(n_data_per_host=2) over two
    # hosts; here two blocks of two ranks.
    assert shapes["hybrid"] == {"fold": 2, "data": 2, "model": 1}
    assert shapes["hybrid_data_ranks"] == [0, 1]


def test_bad_mesh_shapes_raise_like_jax(drill):
    errors = drill[2]["info"]["errors"]
    assert len(errors) == 4 and all("mesh shape" in e for e in errors)
    devs = jax.devices()[:4]
    for kw in ({"n_fold": 3, "n_data": 3}, {"n_fold": 4, "n_model": 3},
               {"n_fold": 3}):
        with pytest.raises(ValueError, match="mesh shape") as exc:
            jax_make_mesh(devices=devs, **kw)
        assert str(exc.value) in errors
    with pytest.raises(ValueError, match="mesh shape"):
        mesh_lib.make_mesh(n_fold=2)      # a world of one process


# -- spec trees --------------------------------------------------------------

def _solo_model_mesh(n_model):
    return mesh_lib.Mesh({"fold": 1, "data": 1, "model": n_model}, 0,
                         {"fold": 0, "data": 0, "model": 0},
                         tuple(range(n_model)))


FLAX_LEAF = {("conv", "weight"): "kernel", ("dense", "weight"): "kernel",
             ("dense", "bias"): "bias", ("bn", "weight"): "scale",
             ("bn", "bias"): "bias"}


def _jax_state(name):
    if name == "eegnet":
        model = jax_model(C, T, F1, D)
        params, stats = jax_variables(C, T, F1, D, perturb_bn=False)
    else:
        model, params, stats = jax_baseline(name, 22, 257)
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    return jax_steps.TrainState.create(
        {"params": params, "batch_stats": stats}, tx), params, stats


@pytest.mark.parametrize("name", ["eegnet", "shallow_convnet",
                                  "deep_convnet"])
def test_moment_specs_shard_the_jax_axis(name):
    jstate, params, stats = _jax_state(name)
    jspec = jax_shard_spec(jstate, jax_make_mesh(
        n_fold=1, n_model=2, devices=jax.devices()[:2]))
    geometry = ({"n_channels": C, "n_times": T} if name == "eegnet"
                else {"n_channels": 22, "n_times": 257})
    model = get_model(name, device="cpu", **geometry)
    layout = steps.StateLayout.of(model)
    sd = from_jax_variables(params, stats)
    state = steps.TrainState.create(layout, {k: v[None]
                                             for k, v in sd.items()})
    spec = shardspec.state_shard_spec(state, _solo_model_mesh(2))
    kinds = {prefix: (flax, kind)
             for flax, prefix, kind in _layers({n.rsplit(".", 1)[0]
                                                 for n in sd})}
    for port_name, shape in zip(layout.params.names, layout.params.shapes):
        prefix, leaf = port_name.rsplit(".", 1)
        flax, kind = kinds[prefix]
        flax_leaf = FLAX_LEAF[kind, leaf]
        jax_p = jspec.update[flax][flax_leaf]
        jax_dim = list(jax_p).index("model") if "model" in jax_p else None
        assert spec.jax_dims[port_name] == jax_dim, port_name
        port_dim = spec.update[port_name]
        assert (port_dim is None) == (jax_dim is None), port_name
        if port_dim is not None:
            flax_shape = np.shape(params[flax][flax_leaf])
            # the same logical axis: the same extent
            assert shape[port_dim] == flax_shape[jax_dim], port_name
            assert spec.state["mu"][port_name][port_dim] == "model"
    sharded = shardspec.shard_state(state, _solo_model_mesh(2), spec)
    full = state.mu.shape[1]
    divisible = all(d is not None for d in spec.update.values())
    if divisible:
        assert 2 * sharded.mu.shape[1] == full
    assert sharded.params.shape == state.params.shape


def test_fold_stacked_specs_and_placement_follow_jax():
    from eegnetreplication_tpu.parallel import shardspec as jax_specs

    tree = {"w": np.zeros((4, 6, 8), np.float32),
            "b": np.zeros((4, 3), np.float32)}
    for n_model in (1, 2):
        want = jax_specs.fold_stacked_spec_tree(tree, n_model=n_model)
        got = shardspec.fold_stacked_spec_tree(tree, n_model=n_model)
        assert got == {k: tuple(v) for k, v in want.items()}
    mapped = (False, True, True)
    assert shardspec.fold_mapped_specs(mapped) == tuple(
        tuple(p) for p in jax_specs.fold_mapped_specs(mapped))
    mesh = mesh_lib.Mesh({"fold": 2, "data": 1, "model": 1}, 1,
                         {"fold": 1, "data": 0, "model": 0}, (0, 1))
    stacked = torch.arange(12.0).reshape(6, 2)
    assert shardspec.padded_folds(5, mesh) == 6
    assert shardspec.fold_block(6, mesh) == (3, 6)
    assert torch.equal(shardspec.place_fold_stacked({"x": stacked}, mesh)[
        "x"], stacked[3:])
    assert shardspec.replicate(stacked, mesh) is stacked


def test_slices_join_back_to_the_flat_vector():
    model = EEGNet(C, T, device="cpu")
    state = steps.TrainState.create(
        steps.StateLayout.of(model),
        {k: v[None] for k, v in model.state_dict().items()})
    spec = shardspec.state_shard_spec(state, _solo_model_mesh(2))
    flat = torch.randn(3, state.params.shape[1])
    blocks = [spec.slice_flat(flat, i) for i in range(2)]
    assert torch.equal(spec.join_flat(blocks), flat)


# -- the DP step ------------------------------------------------------------

def _jax_dp(inputs, jax_weights, mode):
    params, stats = jax_weights
    mesh = jax_make_mesh(n_fold=1, n_data=2, devices=jax.devices()[:2])
    model = jax_model(C, T, F1, D).clone(dropout_rate=0.0, bn_mode=mode,
                                         bn_axis_name="data")
    tx = jax_steps.make_optimizer(LR, EPS)
    state = jax_steps.TrainState.create(
        {"params": params, "batch_stats": stats}, tx)
    step = jax_dp_step(model, tx, mesh)
    key = jax.random.PRNGKey(0)
    out = []
    for s in range(2):
        state, loss = step(state, jnp.asarray(inputs["x"][s]),
                           jnp.asarray(inputs["y"][s], jnp.int32),
                           jnp.asarray(inputs["w"][s]), key)
        out.append((state, float(loss)))
    return out


def _port_flat(params, stats, model):
    layout = steps.StateLayout.of(model)
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, params),
                            jax.tree_util.tree_map(np.asarray, stats))
    return (layout.params.flatten({k: sd[k][None]
                                   for k in layout.params.names})[0].numpy(),
            layout.stats.flatten({k: sd[k][None]
                                  for k in layout.stats.names})[0].numpy())


@pytest.mark.parametrize("mode", ["flax", "torch"])
def test_dp_step_matches_jax(drill, mode):
    inputs, weights, rec = drill
    (s1, loss1), (_, loss2) = _jax_dp(inputs, weights, mode)
    got = rec[f"dp/{mode}/loss"]
    np.testing.assert_allclose(got[0], loss1, rtol=1e-5)
    np.testing.assert_allclose(got[1], loss2, rtol=1e-3)
    want_p, want_s = _port_flat(s1.params, s1.batch_stats,
                                EEGNet(C, T, F1=F1, D=D, device="cpu"))
    np.testing.assert_allclose(rec[f"dp/{mode}/params1"], want_p, atol=1e-3)
    np.testing.assert_allclose(rec[f"dp/{mode}/stats1"], want_s, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["flax", "torch"])
def test_dp_step_matches_the_one_process_step(drill, mode):
    row = mesh_drill.summary(drill[2])[f"dp_{mode}"]
    assert row["ok"], row


def test_dp_eval_counts_equal_jax(drill):
    inputs, _, rec = drill
    model = EEGNet(C, T, F1=F1, D=D, device="cpu")
    layout = steps.StateLayout.of(model)
    sd = {**layout.params.views(torch.from_numpy(rec["dp/flax/params"])[None]),
          **layout.stats.views(torch.from_numpy(rec["dp/flax/stats"])[None])}
    params, stats = to_jax_variables({k: v[0] for k, v in sd.items()})
    mesh = jax_make_mesh(n_fold=1, n_data=2, devices=jax.devices()[:2])
    jmodel = jax_model(C, T, F1, D).clone(dropout_rate=0.0)
    tx = jax_steps.make_optimizer(LR, EPS)
    jstate = jax_steps.TrainState.create(
        {"params": params, "batch_stats": stats}, tx)
    loss_sum, correct = jax_dp_eval(jmodel, mesh)(
        jstate, jnp.asarray(inputs["x"][0]),
        jnp.asarray(inputs["y"][0], jnp.int32), jnp.asarray(inputs["w"][0]))
    assert float(rec["eval/correct"][0]) == float(correct)
    np.testing.assert_allclose(rec["eval/loss_sum"][0], float(loss_sum),
                               rtol=1e-5)


def test_zero_is_bitwise_the_replicated_step(drill):
    rec = drill[2]
    assert rec["zero/sharded"].shape[0] == STEPS
    assert np.array_equal(rec["zero/sharded"], rec["zero/replicated"])
    # every EEGNet leaf has an even dimension: half the moment elements a
    # model rank
    assert all(2 * int(n) == int(rec["zero/total_numel"])
               for n in rec["zero/local_numel"])


# -- the time-sharded EMS --------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_ems_time_sharded_matches_jax_and_the_one_shot_scan(drill, n):
    inputs, _, rec = drill
    factor, block = float(inputs["ems"][0]), int(inputs["ems"][1])
    got = rec[f"ems/{n}"]
    want = np.asarray(jax_ems_sharded(
        jnp.asarray(inputs["ems_x"]),
        jax_make_mesh(n_fold=1, n_data=n, devices=jax.devices()[:n]),
        "data", factor_new=factor, init_block_size=block))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(got, rec["ems/scan"], atol=2e-4, rtol=2e-3)


def _two_shard_mesh():
    solo = mesh_lib.AxisGroup("model", 1, 0, (0,))
    return mesh_lib.Mesh({"fold": 1, "data": 2, "model": 1}, 0,
                         {"fold": 0, "data": 0, "model": 0}, (0, 1),
                         {"data": mesh_lib.AxisGroup("data", 2, 0, (0, 1)),
                          "model": solo})


@pytest.mark.parametrize("t, block, match", [
    (1001, 100, "must divide"), (1000, 600, "exceeds the local shard")])
def test_ems_time_sharded_bad_shapes_raise_like_jax(t, block, match):
    x = np.random.default_rng(0).standard_normal((2, t)).astype(np.float32)
    with pytest.raises(ValueError, match=match) as port:
        port_ems.ems_time_sharded(torch.from_numpy(x), _two_shard_mesh(),
                                  "data", init_block_size=block)
    with pytest.raises(ValueError, match=match) as jax_exc:
        jax_ems_sharded(jnp.asarray(x), jax_make_mesh(
            n_fold=1, n_data=2, devices=jax.devices()[:2]), "data",
            init_block_size=block)
    assert str(port.value) == str(jax_exc.value)
