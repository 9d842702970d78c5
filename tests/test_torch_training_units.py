"""The torch port's training building blocks against the JAX package's.

On the same numpy-seeded inputs: the fold splits (equal exactly),
BatchNorm in both modes against flax ``nn.BatchNorm`` and the JAX
``TorchBatchNorm`` (outputs and new running statistics, with and without
padding slots, atol 1e-5), the weighted cross-entropy, both max-norm modes
and Adam against ``optax.adam(eps=1e-7)`` (a handful of steps, 1e-6), the
training-mode EEGNet forward against ``model.apply(train=True)`` at
dropout 0, and the stacked block 1 (K1's plain version) against the Pallas
kernel under ``jax.vmap`` in interpret mode and the JAX ``block1_reference``
(atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from torch_port_cases import jax_model, jax_variables, trials

from eegnetreplication_tpu.data import splits as jax_splits
from eegnetreplication_tpu.models.norm import TorchBatchNorm
from eegnetreplication_tpu.ops import fused_eegnet as jax_fused
from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu_torch.data import splits
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
from eegnetreplication_tpu_torch.models import EEGNet, get_model
from eegnetreplication_tpu_torch.models.norm import batch_norm_train
from eegnetreplication_tpu_torch.ops import fused_eegnet as fused
from eegnetreplication_tpu_torch.training import steps
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
    from_jax_variables_stacked,
)

ATOL = 1e-5


# --- splits ---------------------------------------------------------------

@pytest.mark.parametrize("n, k, seed", [(24, 4, 42), (64, 4, 42),
                                        (576, 4, 42), (577, 4, 7),
                                        (10, 3, 0)])
def test_kfold_and_inner_split_equal_jax(n, k, seed):
    want = jax_splits.kfold_indices(n, k, seed)
    got = splits.kfold_indices(n, k, seed)
    assert len(got) == len(want)
    for (tr, te), (jtr, jte) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
        for a, b in zip(splits.inner_train_val_split(tr),
                        jax_splits.inner_train_val_split(jtr)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("test_subject, fold", [(1, 1), (5, 47), (9, 90)])
def test_cross_subject_draw_equals_jax(test_subject, fold):
    for a, b in zip(splits.cross_subject_fold_subjects(test_subject, fold),
                    jax_splits.cross_subject_fold_subjects(test_subject,
                                                           fold)):
        np.testing.assert_array_equal(a, b)


def test_container_concat_and_subset():
    rng = np.random.RandomState(0)
    a = BCICI2ADataset(rng.randn(3, 2, 5).astype(np.float32),
                       np.array([0, 1, 2]))
    b = BCICI2ADataset(rng.randn(2, 2, 5).astype(np.float32),
                       np.array([3, 0]))
    c = a.concat(b)
    assert len(c) == 5 and (c.n_channels, c.n_times) == (2, 5)
    np.testing.assert_array_equal(c.y, [0, 1, 2, 3, 0])
    np.testing.assert_array_equal(c.subset(np.array([4, 0])).X,
                                  np.stack([b.X[1], a.X[0]]))


# --- BatchNorm ------------------------------------------------------------

def _bn_inputs(seed, b=6, h=3, w=7, f=4):
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(b, h, w, f) + 0.3).astype(np.float32)
    p = {"scale": (0.8 + 0.4 * rng.rand(f)).astype(np.float32),
         "bias": (0.2 * rng.randn(f)).astype(np.float32)}
    s = {"mean": (0.3 * rng.randn(f)).astype(np.float32),
         "var": (0.5 + rng.rand(f)).astype(np.float32)}
    return x, p, s


WEIGHTS = {"none": None, "padded": [1, 1, 1, 1, 0, 0],
           "all_padding": [0, 0, 0, 0, 0, 0]}


@pytest.mark.parametrize("mode", ["flax", "torch"])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
def test_batch_norm_matches_jax(mode, weights):
    x, p, s = _bn_inputs(3)
    w = None if WEIGHTS[weights] is None else np.asarray(WEIGHTS[weights],
                                                         np.float32)
    variables = {"params": p, "batch_stats": s}
    if mode == "flax":
        layer = nn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5)
        y, upd = layer.apply(variables, jnp.asarray(x),
                             mutable=["batch_stats"])
    else:
        layer = TorchBatchNorm(momentum=0.9, epsilon=1e-5)
        y, upd = layer.apply(variables, jnp.asarray(x),
                             use_running_average=False,
                             sample_weights=None if w is None
                             else jnp.asarray(w), mutable=["batch_stats"])
    # flax (B, H, W, F) -> the port's (B, G=1, F, H, W)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).unsqueeze(1)
    got, mean, var = batch_norm_train(
        xt, *(torch.from_numpy(v)[None] for v in (p["scale"], p["bias"],
                                                   s["mean"], s["var"])),
        None if w is None else torch.from_numpy(w)[None], mode=mode)
    np.testing.assert_allclose(got[:, 0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(y), atol=ATOL)
    np.testing.assert_allclose(mean[0].numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=ATOL)
    np.testing.assert_allclose(var[0].numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=ATOL)
    if mode == "torch" and weights == "all_padding":
        assert torch.equal(mean[0], torch.from_numpy(s["mean"]))
        assert torch.equal(var[0], torch.from_numpy(s["var"]))


def test_batch_norm_folds_are_independent():
    """Two stacked sets with their own padding give each set's own
    single-set result."""
    xs, ws = [], [[1, 1, 0, 0, 0, 0], [1, 1, 1, 1, 1, 0]]
    for seed in (4, 5):
        xs.append(torch.from_numpy(_bn_inputs(seed)[0]).permute(0, 3, 1, 2))
    _, p, s = _bn_inputs(4)
    args = [torch.from_numpy(v) for v in (p["scale"], p["bias"], s["mean"],
                                          s["var"])]
    for mode in ("flax", "torch"):
        both = batch_norm_train(
            torch.stack(xs, 1), *(a[None].repeat(2, 1) for a in args),
            torch.tensor(ws, dtype=torch.float32), mode=mode)
        for g in range(2):
            one = batch_norm_train(xs[g].unsqueeze(1), *(a[None] for a in
                                                         args),
                                   torch.tensor([ws[g]], dtype=torch.float32),
                                   mode=mode)
            torch.testing.assert_close(both[0][:, g], one[0][:, 0])
            torch.testing.assert_close(both[1][g], one[1][0])
            torch.testing.assert_close(both[2][g], one[2][0])


def test_unknown_bn_mode_raises():
    with pytest.raises(ValueError, match="bn_mode"):
        EEGNet(8, 64, device="cpu", bn_mode="batch")


# --- loss, max-norm, Adam -------------------------------------------------

@pytest.mark.parametrize("weights", ["ones", "padded", "zeros"])
def test_weighted_cross_entropy_matches_jax(weights):
    rng = np.random.RandomState(1)
    logits = (3.0 * rng.randn(2, 8, 4)).astype(np.float32)
    labels = rng.randint(0, 4, (2, 8))
    w = {"ones": np.ones((2, 8)), "zeros": np.zeros((2, 8)),
         "padded": np.array([[1] * 5 + [0] * 3, [1] * 8])}[weights]
    w = w.astype(np.float32)
    want = [jax_steps.weighted_cross_entropy(jnp.asarray(logits[g]),
                                             jnp.asarray(labels[g]),
                                             jnp.asarray(w[g]))
            for g in range(2)]
    got = steps.weighted_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _big_tree(seed):
    """A JAX EEGNet tree scaled up so both max-norm limits bind."""
    params, bs = jax_variables(8, 64, 8, 2, seed=seed)
    params = jax.tree_util.tree_map(lambda a: a * 7.0, params)
    return params, bs


def test_reference_maxnorm_clamps_the_same_gradients():
    grads, bs = _big_tree(2)
    want = jax_steps.clamp_reference_maxnorm(grads)
    got = steps.clamp_reference_maxnorm(from_jax_variables(grads, bs))
    ref = from_jax_variables(jax.tree_util.tree_map(np.asarray, want), bs)
    for name, value in got.items():
        torch.testing.assert_close(value, ref[name], atol=1e-6, rtol=0)
    assert float(got["spatial.weight"].abs().max()) <= 1.0
    assert float(got["classifier.weight"].abs().max()) <= 0.25
    assert float(got["temporal.0.weight"].abs().max()) > 1.0


def test_paper_maxnorm_projects_the_same_weights():
    params, bs = _big_tree(3)
    want = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, jax_steps.project_paper_maxnorm(params)), bs)
    sd = from_jax_variables(params, bs)
    got = steps.project_paper_maxnorm(sd)
    for name, value in got.items():
        torch.testing.assert_close(value, want[name], atol=1e-6, rtol=1e-6)
    # stacked: a leading fold axis changes nothing per fold
    stacked = {k: torch.stack([v, v * 0.01]) for k, v in sd.items()}
    both = steps.project_paper_maxnorm(stacked)
    torch.testing.assert_close(both["spatial.weight"][0],
                               got["spatial.weight"])
    torch.testing.assert_close(both["classifier.weight"][1],
                               stacked["classifier.weight"][1])


def test_adam_matches_optax():
    rng = np.random.RandomState(4)
    p0 = rng.randn(2, 37).astype(np.float32)
    grads = [(rng.randn(2, 37) * 10.0 ** rng.randint(-3, 2)).astype(
        np.float32) for _ in range(6)]
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-7)
    layout = steps.StateLayout(steps.FlatLayout(("w",), ((37,),)),
                               steps.FlatLayout((), ()))
    for g in range(2):
        params, opt = jnp.asarray(p0[g]), tx.init(jnp.asarray(p0[g]))
        state = steps.TrainState(layout, torch.from_numpy(p0[g:g + 1]),
                                 torch.zeros(1, 0), torch.zeros(1, 37),
                                 torch.zeros(1, 37),
                                 torch.zeros(1, dtype=torch.int32))
        for grad in grads:
            updates, opt = tx.update(jnp.asarray(grad[g]), opt, params)
            params = optax.apply_updates(params, updates)
            state = steps.adam_update(state, torch.from_numpy(grad[g:g + 1]),
                                      1e-3, 1e-7)
        np.testing.assert_allclose(state.params[0].numpy(),
                                   np.asarray(params), atol=1e-6)
        assert int(state.count[0]) == len(grads)


def test_get_model_names_the_roadmap_for_unported_models():
    """Every name of the JAX registry builds; an unknown name gets the JAX
    message, which lists the four."""
    assert get_model("eegnet_wide", device="cpu").F2 == 64
    assert type(get_model("shallow_convnet", device="cpu")).__name__ \
        == "ShallowConvNet"
    with pytest.raises(ValueError, match=r"Unknown model 'resnet'; "
                       r"available: \['deep_convnet', 'eegnet', "
                       r"'eegnet_wide', 'shallow_convnet'\]"):
        get_model("resnet")


# --- training-mode forward ------------------------------------------------

@pytest.mark.parametrize("bn_mode", ["flax", "torch"])
def test_training_forward_matches_jax_apply(bn_mode):
    c, t, f1, d = 8, 64, 8, 2
    params, bs = jax_variables(c, t, f1, d, seed=5)
    x = trials(6, c, t, seed=6)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    model = jax_model(c, t, f1, d).clone(dropout_rate=0.0, bn_mode=bn_mode)
    logits, upd = model.apply({"params": params, "batch_stats": bs},
                              jnp.asarray(x), train=True,
                              sample_weights=jnp.asarray(w),
                              mutable=["batch_stats"])
    port = EEGNet(c, t, F1=f1, D=d, dropout_rate=0.0, bn_mode=bn_mode,
                  device="cpu")
    port.load_state_dict(from_jax_variables(params, bs))
    port.train()
    got = port(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               atol=1e-4, rtol=1e-4)
    want = from_jax_variables(params, jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"]))
    for name, value in port.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(value, want[name], atol=ATOL,
                                       rtol=1e-5)


def test_stacked_eval_forward_matches_each_model():
    c, t, f1, d = 8, 64, 8, 2
    trees = [jax_variables(c, t, f1, d, seed=10 + g) for g in range(3)]
    models = []
    for p, s in trees:
        m = EEGNet(c, t, F1=f1, D=d, device="cpu")
        m.load_state_dict(from_jax_variables(p, s))
        models.append(m)
    stacked = from_jax_variables_stacked(
        *(jax.tree_util.tree_map(lambda *a: np.stack(a), *[tr[i] for tr in
                                                          trees])
          for i in (0, 1)))
    layout = steps.StateLayout.of(models[0])
    state = steps.TrainState.create(layout, stacked)
    x = torch.from_numpy(trials(3 * 5, c, t, seed=11)).reshape(3, 5, c, t)
    with torch.no_grad():
        want = torch.stack([models[g](x[g]) for g in range(3)])
        got = steps.eval_forward(models[0], state, x,
                                 fused.fold_index(3, 5, "cpu"))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-4)
    for g in range(3):
        sd = state.state_dict(g)
        for name, value in models[g].state_dict().items():
            torch.testing.assert_close(sd[name], value)


# --- K1 on stacked weights (its plain version) ----------------------------

def _stacked_case(g, t, seed, c=22, f1=8, d=2, b=2):
    trees = [jax_variables(c, max(t, 64), f1, d, seed=seed + i)
             for i in range(g)]
    folded = [jax_fused.fold_block1_params(p, s) for p, s in trees]
    jw = [jnp.stack([np.asarray(f[i]) for f in folded]) for i in range(4)]
    x = trials(g * b, c, t, seed=seed).reshape(g, b, c, t)
    return trees, jw, x


STACKED = [(1, 64), (3, 64), (1, 257), (3, 257)]


@pytest.mark.parametrize("g, t", STACKED,
                         ids=[f"G{g}-T{t}" for g, t in STACKED])
@pytest.mark.parametrize("permuted", [False, True],
                         ids=["ordered", "permuted"])
def test_block1_stacked_reference_matches_vmapped_pallas(g, t, permuted):
    trees, jw, x = _stacked_case(g, t, seed=20 + g + t)
    b = x.shape[1]
    pallas = jax.vmap(lambda xs, S, W, A, B: jax_fused.block1_pallas(
        xs, S, W, A, B, interpret=True))(jnp.asarray(x), *jw)
    jnp_ref = jax.vmap(jax_fused.block1_reference)(jnp.asarray(x), *jw)
    stacked = from_jax_variables_stacked(
        *(jax.tree_util.tree_map(lambda *a: np.stack(a),
                                 *[tr[i] for tr in trees]) for i in (0, 1)))
    folded = fused.fold_block1_params(stacked)
    for name, got, want in zip("SWAB", folded, jw):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   err_msg=name)
    xt = torch.from_numpy(x.reshape(g * b, *x.shape[2:]))
    idx = fused.fold_index(g, b, "cpu")
    order = (torch.randperm(g * b, generator=torch.Generator().manual_seed(1))
             if permuted else torch.arange(g * b))
    got = fused.block1_stacked(xt[order].contiguous(), *folded,
                               idx[order].contiguous())
    for want in (pallas, jnp_ref):
        want = np.asarray(want).reshape(g * b, *want.shape[2:])[order.numpy()]
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _stacked_operands(n=4, c=3, t=16, g=2, f2=2):
    return (torch.zeros(n, c, t), torch.zeros(g, f2, c),
            torch.zeros(g, f2, fused.TEMPORAL_K), torch.zeros(g, f2),
            torch.zeros(g, f2), torch.zeros(n, dtype=torch.int32))


@pytest.mark.parametrize("bad, error", [
    (lambda o: o[:5] + (o[5].long(),), TypeError),
    (lambda o: o[:5] + (o[5][:3],), ValueError),
    (lambda o: o[:1] + (o[1][0],) + o[2:], ValueError),
    (lambda o: o[:2] + (o[2][:1],) + o[3:], ValueError),
    (lambda o: (o[0].double(),) + o[1:], TypeError),
], ids=["idx-dtype", "idx-length", "S-unstacked", "W-sets", "x-dtype"])
def test_stacked_operand_checks_raise(bad, error):
    with pytest.raises(error):
        fused._check_operands(*bad(_stacked_operands()))


def test_stacked_index_range_is_checked():
    ops = _stacked_operands()
    idx = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        fused.block1_stacked(*ops[:5], idx)
    with pytest.raises(ValueError, match="outside"):
        fused._check_index_range(idx, 2)
    ok = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    fused._check_index_range(ok, 2)           # remembered at this version
    ok[2] = 5                                 # an in-place write: rechecked
    with pytest.raises(ValueError, match="outside"):
        fused._check_index_range(ok, 2)


def test_cpu_stacked_call_takes_the_plain_version_and_launches_nothing():
    _, jw, x = _stacked_case(2, 64, seed=30)
    folded = [torch.from_numpy(np.array(v)) for v in jw]
    xt = torch.from_numpy(x.reshape(4, *x.shape[2:]))
    idx = fused.fold_index(2, 2, "cpu")
    before = fused.block1_stacked.launches
    got = fused.block1_stacked(xt, *folded, idx)
    assert torch.equal(got, fused.block1_stacked_reference(xt, *folded, idx))
    assert fused.block1_stacked.launches == before
    # each set is the single-set kernel's plain version on its trials
    for g in range(2):
        torch.testing.assert_close(
            got[2 * g:2 * g + 2],
            fused.block1_reference(xt[2 * g:2 * g + 2],
                                   *(v[g] for v in folded)))
