"""The banded conv schedule (``ops/banded.py``, ``conv_impl``) against the
JAX package's and against the port's grouped-conv (``"lax"``) path.

- Every banded op, forward and VJP (a seeded cotangent), against the JAX
  banded op at T = 257 and past ``BANDED_TILE_T`` (the tiled form), and
  against the same convolution done by ``torch.nn.functional``; atol/rtol
  1e-5 forward and 1e-4 for gradients (f32 sums in another order).
- The fold-stacked EEGNet forward under ``"banded"`` against ``"lax"``:
  logits, new BatchNorm statistics and parameter gradients, at T = 257 and
  T = 1125 (tiled), train and eval, with block 1's first BatchNorm and
  spatial convolution composed or as ``ops/bn_spatial.py``'s op, and the
  K1-stacked eval path's block 2.
- ``conv_impl`` and ``EEGTPU_CONV_IMPL`` resolve, case by case, as in the
  JAX ``EEGNet`` (values and error texts), with "auto"'s default the port's
  ``AUTO_CONV_IMPL``.
- 40 stacked train steps of two folds under ``"banded"`` against the JAX
  ``EEGNet(conv_impl="banded")`` ``train_step``: losses and raw gradient
  norms within 2e-3.
- FLOPs count the minimal convolution under either schedule, as the JAX
  count does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_cases import jax_model, jax_variables

from eegnetreplication_tpu.models import EEGNet as JaxEEGNet
from eegnetreplication_tpu.ops import banded as jb
from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu.utils import flops as jax_flops
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.models import eegnet as eegnet_lib
from eegnetreplication_tpu_torch.ops import banded
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    fold_index,
    fused_eval_forward_stacked,
)
from eegnetreplication_tpu_torch.training import steps
from eegnetreplication_tpu_torch.training.checkpoint import (
    from_jax_variables,
)
from eegnetreplication_tpu_torch.utils import flops

FWD, GRAD = 1e-5, 1e-4
LENGTHS = (257, 600)       # untiled, and tiled past BANDED_TILE_T


def _nchw(kernel):
    """A flax conv kernel in the port's layout with a G = 1 axis."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(kernel, (3, 2, 0, 1))))[None]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _both(jax_fn, port_fn, jax_args, port_args, out_to_jax):
    """Forward and VJP of the JAX op and the port op on the same inputs;
    ``out_to_jax`` puts the port's output in the JAX op's layout."""
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in jax_args])
    cot = np.random.RandomState(0).randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    args = [a.clone().requires_grad_(True) for a in port_args]
    got = out_to_jax(port_fn(*args))
    _close(got.detach(), want, FWD)
    grads = torch.autograd.grad(got, args, torch.from_numpy(cot))
    return want_grads, grads


@pytest.mark.parametrize("t", LENGTHS)
def test_temporal_conv(t):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, t, 1).astype(np.float32)
    k = rng.randn(1, 32, 1, 8).astype(np.float32)
    jfn = functools.partial(jb.temporal_conv_banded, precision="highest")
    (jdx, jdk), (dx, dk) = _both(
        jfn, banded.temporal_conv_banded, (x, k),
        (torch.from_numpy(x[..., 0])[None], _nchw(k)), lambda o: o[0])
    _close(dx[0], jdx[..., 0], GRAD)
    _close(dk[0].permute(2, 3, 1, 0), jdk, GRAD)
    # the same convolution through torch's conv2d
    lax = F.conv2d(F.pad(torch.from_numpy(x[..., 0])[:, None], (15, 16)),
                   _nchw(k)[0])                          # (B, F1, C, T)
    got = banded.temporal_conv_banded(torch.from_numpy(x[..., 0])[None],
                                      _nchw(k))[0]
    _close(got, lax.permute(0, 2, 3, 1), FWD)


@pytest.mark.parametrize("t", LENGTHS)
def test_spatial_conv(t):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, t, 8).astype(np.float32)
    k = rng.randn(4, 1, 1, 16).astype(np.float32)
    jfn = functools.partial(jb.spatial_conv_banded, precision="highest")
    (jdx, jdk), (dx, dk) = _both(
        jfn, banded.spatial_conv_banded, (x, k),
        (torch.from_numpy(x)[None], _nchw(k)), lambda o: o[0][:, None])
    _close(dx[0], jdx, GRAD)
    _close(dk[0].permute(2, 3, 1, 0), jdk, GRAD)
    lax = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), _nchw(k)[0],
                   groups=8)                             # (B, F2, 1, T)
    got = banded.spatial_conv_banded(torch.from_numpy(x)[None], _nchw(k))[0]
    _close(got, lax[:, :, 0].transpose(1, 2), FWD)


@pytest.mark.parametrize("t", (64, 600))
def test_depthwise_conv(t):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 1, t, 16).astype(np.float32)
    k = rng.randn(1, 16, 1, 16).astype(np.float32)
    jfn = functools.partial(jb.depthwise_conv_banded, precision="highest")
    (jdx, jdk), (dx, dk) = _both(
        jfn, banded.depthwise_conv_banded, (x, k),
        (torch.from_numpy(x[:, 0])[None], _nchw(k)), lambda o: o[0][:, None])
    _close(dx[0], jdx[:, 0], GRAD)
    _close(dk[0].permute(2, 3, 1, 0), jdk, GRAD)
    lax = F.conv2d(F.pad(torch.from_numpy(x).permute(0, 3, 1, 2), (7, 8)),
                   _nchw(k)[0], groups=16)
    got = banded.depthwise_conv_banded(torch.from_numpy(x[:, 0])[None],
                                       _nchw(k))[0]
    _close(got, lax[:, :, 0].transpose(1, 2), FWD)


def test_pointwise_conv_and_pool():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 1, 64, 16).astype(np.float32)
    k = rng.randn(1, 1, 16, 16).astype(np.float32)
    jfn = functools.partial(jb.pointwise_conv_banded, precision="highest")
    (jdx, jdk), (dx, dk) = _both(
        jfn, banded.pointwise_conv_banded, (x, k),
        (torch.from_numpy(x[:, 0])[None], _nchw(k)), lambda o: o[0][:, None])
    _close(dx[0], jdx[:, 0], GRAD)
    _close(dk[0].permute(2, 3, 1, 0), jdk, GRAD)
    for window in (4, 8):
        h = rng.randn(3, 1, 66, 16).astype(np.float32)
        want = jb.avg_pool_width(jnp.asarray(h), window)
        _close(banded.avg_pool_width(torch.from_numpy(h), window), want, FWD)


@pytest.mark.parametrize("t", (257, 513, 1125))
def test_conv1d_and_its_tiled_form(t):
    """Tiled and untiled agree with each other and with JAX; the expansion
    is cached per (k, t, device) and is the JAX one-hot."""
    rng = np.random.RandomState(5)
    xp = rng.randn(2, 3, t + 15).astype(np.float32)
    taps = rng.randn(16, 5).astype(np.float32)
    want = jb.conv1d_same_banded(jnp.asarray(xp), jnp.asarray(taps), t,
                                 precision="highest")
    got = banded.conv1d_same_banded(torch.from_numpy(xp)[None],
                                    torch.from_numpy(taps)[None], t)[0]
    _close(got, want, FWD)
    tiled = banded.conv1d_same_banded_tiled(torch.from_numpy(xp)[None],
                                            torch.from_numpy(taps)[None], t)
    _close(tiled[0], want, FWD)
    e = banded.expansion(16, 40, "cpu")
    assert e is banded.expansion(16, 40, torch.device("cpu"))
    np.testing.assert_array_equal(e.numpy(), jb._expansion_host(16, 40))
    x = torch.arange(5.0)[None]
    assert banded.same_pad_1d(x, 16).tolist() == \
        np.asarray(jb.same_pad_1d(jnp.asarray(x.numpy()), 16)).tolist()


# --- the stacked EEGNet forward under both schedules -------------------------

def _stacked_sets(c, t, g=3, seed=6):
    sds = [from_jax_variables(*jax_variables(c, t, 8, 2, seed=seed + i))
           for i in range(g)]
    return {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]
            if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("t", (257, 1125))
@pytest.mark.parametrize("bn_mode", ["flax", "torch", "flax+bn_spatial"])
def test_stacked_forward_banded_equals_lax(t, bn_mode, monkeypatch):
    """``flax+bn_spatial``: the banded forward through ``ops/bn_spatial.py``
    (its plain twin here), the gate held open as on the card."""
    if bn_mode.endswith("+bn_spatial"):
        bn_mode = "flax"
        monkeypatch.setattr(eegnet_lib, "fuses_bn_spatial",
                            lambda x, **gate: gate["train"])
    c = 4
    state = _stacked_sets(c, t)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        3, 6, c, t).astype(np.float32))
    w = torch.ones(3, 6)
    w[1, 4:] = 0.0
    out = {}
    for impl in ("lax", "banded"):
        params = {k: v.clone().requires_grad_(True) for k, v in state.items()
                  if "running" not in k}
        stats = {k: v for k, v in state.items() if "running" in k}
        logits, new = eegnet_lib.stacked_forward(
            params, stats, x, train=True, sample_weights=w, bn_mode=bn_mode,
            conv_impl=impl, precision="highest")
        grads = torch.autograd.grad(logits.square().sum(),
                                    list(params.values()))
        evals, _ = eegnet_lib.stacked_forward(params, stats, x, train=False,
                                              conv_impl=impl,
                                              precision="highest")
        out[impl] = (logits.detach(), new, dict(zip(params, grads)),
                     evals.detach())
    lax, band = out["lax"], out["banded"]
    torch.testing.assert_close(band[0], lax[0], atol=FWD, rtol=FWD)
    torch.testing.assert_close(band[3], lax[3], atol=FWD, rtol=FWD)
    for k in lax[1]:
        torch.testing.assert_close(band[1][k], lax[1][k], atol=FWD, rtol=FWD)
    for k in lax[2]:
        torch.testing.assert_close(band[2][k], lax[2][k], atol=GRAD,
                                   rtol=GRAD, msg=k)


def test_the_k1_stacked_eval_path_takes_the_schedule():
    c, t = 4, 257
    state = _stacked_sets(c, t)
    params = {k: v for k, v in state.items() if "running" not in k}
    stats = {k: v for k, v in state.items() if "running" in k}
    x = torch.from_numpy(np.random.RandomState(8).randn(
        3, 5, c, t).astype(np.float32))
    idx = fold_index(3, 5, "cpu")
    lax = fused_eval_forward_stacked(params, stats, x, idx, conv_impl="lax")
    band = fused_eval_forward_stacked(params, stats, x, idx,
                                      conv_impl="banded")
    torch.testing.assert_close(band, lax, atol=FWD, rtol=FWD)
    plain, _ = eegnet_lib.stacked_forward(params, stats, x, train=False,
                                          precision="highest")
    torch.testing.assert_close(band, plain, atol=FWD, rtol=FWD)


# --- conv_impl resolution ---------------------------------------------------

IMPLS = ["auto", "banded", "lax", "conv"]
ENVS = [None, "", "auto", "banded", "lax", "conv"]


def _resolve(make, monkeypatch, env, impl):
    if env is None:
        monkeypatch.delenv("EEGTPU_CONV_IMPL", raising=False)
    else:
        monkeypatch.setenv("EEGTPU_CONV_IMPL", env)
    try:
        return make(impl), None
    except ValueError as exc:
        return None, str(exc)


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("impl", IMPLS)
def test_conv_impl_resolves_as_in_jax(env, impl, monkeypatch):
    want, want_err = _resolve(
        lambda i: JaxEEGNet(n_channels=4, n_times=64, conv_impl=i).conv_impl,
        monkeypatch, env, impl)
    got, got_err = _resolve(
        lambda i: EEGNet(4, 64, conv_impl=i, device="cpu").conv_impl,
        monkeypatch, env, impl)
    assert got_err == want_err
    if impl == "auto" and env in (None, "", "auto"):
        # the default: the JAX package's "banded", the port's card A/B
        assert want == "banded" and got == eegnet_lib.AUTO_CONV_IMPL
    else:
        assert got == want


def test_the_schedule_is_resolved_once_at_construction(monkeypatch):
    monkeypatch.setenv("EEGTPU_CONV_IMPL", "lax")
    model = EEGNet(4, 64, device="cpu")
    monkeypatch.setenv("EEGTPU_CONV_IMPL", "banded")
    assert model.conv_impl == "lax"
    assert model.fresh(torch.Generator()).conv_impl == "lax"
    with pytest.raises(ValueError, match="'banded' or 'lax'"):
        eegnet_lib.stacked_forward({}, {}, torch.zeros(1, 1, 4, 64),
                                   train=False, precision="highest",
                                   conv_impl="auto")


# --- the train step ----------------------------------------------------------

C, T, BATCH, N_STEPS = 8, 64, 16, 40


def test_banded_train_steps_track_the_jax_banded_step():
    rng = np.random.RandomState(9)
    y = rng.randint(0, 4, 96)
    x = rng.randn(96, C, T).astype(np.float32)
    tt = np.arange(T) / 64.0
    for k in range(4):
        x[y == k] += np.sin(2 * np.pi * (4 + 4 * k) * tt).astype(np.float32)
    jmodel = jax_model(C, T, 8, 2).clone(dropout_rate=0.0,
                                        conv_impl="banded")
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    jstep = jax.jit(functools.partial(jax_steps.train_step, jmodel, tx,
                                      return_grad_norm=True))
    sets = [jax_variables(C, T, 8, 2, seed=s, perturb_bn=False)
            for s in (10, 11)]
    jstates = [jax_steps.TrainState.create(
        {"params": p, "batch_stats": b}, tx) for p, b in sets]
    model = EEGNet(C, T, dropout_rate=0.0, conv_impl="banded", device="cpu")
    sds = [from_jax_variables(p, b) for p, b in sets]
    state = steps.TrainState.create(
        steps.StateLayout.of(model),
        {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]})
    key = jax.random.PRNGKey(0)
    got, want = [], []
    for s in range(N_STEPS):
        idx = rng.randint(0, 96, (2, BATCH))
        w = np.ones((2, BATCH), np.float32)
        w[1, 11:] = 0.0
        row = []
        for g in range(2):
            jstates[g], jl, jg = jstep(jstates[g], jnp.asarray(x[idx[g]]),
                                       jnp.asarray(y[idx[g]]),
                                       jnp.asarray(w[g]), key)
            row += [float(jl), float(jg)]
        want.append(row)
        state, loss, gn = steps.train_step(
            model, state, torch.from_numpy(x[idx]), torch.from_numpy(y[idx]),
            torch.from_numpy(w), learning_rate=1e-3, adam_eps=1e-7)
        got.append([float(loss[0]), float(gn[0]), float(loss[1]),
                    float(gn[1])])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_flops_count_the_minimal_conv_under_both_schedules():
    tx = jax_steps.make_optimizer()
    shape = (8, 128)
    jax_counts = {}
    for impl in ("banded", "lax"):
        port_model = EEGNet(8, 128, conv_impl=impl, device="cpu")
        jmodel = JaxEEGNet(n_channels=8, n_times=128, conv_impl=impl)
        jax_counts[impl] = jax_flops.train_step_flops(jmodel, tx, 16, shape)
        got = flops.train_step_flops(port_model, 16)
        assert abs(got / jax_counts[impl] - 1) <= 0.05, (impl, got)
        assert got == flops.train_step_flops(
            EEGNet(8, 128, conv_impl="lax", device="cpu"), 16)
    assert jax_counts["banded"] == jax_counts["lax"]
