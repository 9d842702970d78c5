"""60 train steps of the torch port against the JAX package's ``train_step``.

Both start from the same JAX-drawn state (carried across with
``from_jax_variables``), see the same 60 batches of 16 at dropout 0 in the
same order (some with wrap-around padding slots at weight 0, one with no
real sample), and must report the same batch losses and raw gradient norms
within rtol/atol 2e-3 (ROADMAP A.1's acceptance), in both ``bn_mode``s and
both ``maxnorm_mode``s.  On the batch with no real sample both report 0
and the port's state, Adam's step count included, does not move.  A second
fold stacked beside the first changes nothing for it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_cases import jax_model, jax_variables

from eegnetreplication_tpu.training import steps as jax_steps
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.training import steps
from eegnetreplication_tpu_torch.training.checkpoint import from_jax_variables

C, T, F1, D = 8, 64, 8, 2
BATCH = 16
N_STEPS = 60
EMPTY_STEP = 30
TOL = 2e-3


def _pool_and_batches(seed=0, pool_n=96):
    """A pool with a class signal and 60 (indices, weights) batches."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, pool_n)
    x = rng.randn(pool_n, C, T).astype(np.float32)
    t = np.arange(T) / 64.0
    for k in range(4):
        x[y == k] += np.sin(2 * np.pi * (4 + 4 * k) * t).astype(np.float32)
    batches = []
    for s in range(N_STEPS):
        idx = rng.randint(0, pool_n, BATCH)
        n_real = BATCH if s % 5 else rng.randint(1, BATCH)
        if s == EMPTY_STEP:
            n_real = 0
        batches.append((idx, (np.arange(BATCH) < n_real).astype(np.float32)))
    return x, y, batches


def _port_state(model, params, bs, n_folds=1):
    sd = from_jax_variables(params, bs)
    stacked = {k: torch.stack([v] * n_folds) for k, v in sd.items()}
    return steps.TrainState.create(steps.StateLayout.of(model), stacked)


@pytest.mark.parametrize("maxnorm_mode", ["reference", "paper"])
@pytest.mark.parametrize("bn_mode", ["flax", "torch"])
def test_sixty_steps_track_jax(bn_mode, maxnorm_mode):
    x, y, batches = _pool_and_batches()
    params, bs = jax_variables(C, T, F1, D, seed=1, perturb_bn=False)
    jmodel = jax_model(C, T, F1, D).clone(dropout_rate=0.0, bn_mode=bn_mode)
    tx = jax_steps.make_optimizer(1e-3, 1e-7)
    jstate = jax_steps.TrainState.create(
        {"params": params, "batch_stats": bs}, tx)
    jstep = jax.jit(functools.partial(
        jax_steps.train_step, jmodel, tx, maxnorm_mode=maxnorm_mode,
        return_grad_norm=True))
    model = EEGNet(C, T, F1=F1, D=D, dropout_rate=0.0, bn_mode=bn_mode,
                   device="cpu")
    state = _port_state(model, params, bs)
    key = jax.random.PRNGKey(0)
    got, want = [], []
    for s, (idx, w) in enumerate(batches):
        jstate, jloss, jgn = jstep(jstate, jnp.asarray(x[idx]),
                                   jnp.asarray(y[idx]), jnp.asarray(w), key)
        before = state
        state, loss, gn = steps.train_step(
            model, state, torch.from_numpy(x[idx])[None],
            torch.from_numpy(y[idx])[None], torch.from_numpy(w)[None],
            learning_rate=1e-3, adam_eps=1e-7, maxnorm_mode=maxnorm_mode)
        got.append((float(loss[0]), float(gn[0])))
        want.append((float(jloss), float(jgn)))
        if s == EMPTY_STEP:
            assert got[-1] == (0.0, 0.0) and want[-1] == (0.0, 0.0)
            for field in ("params", "stats", "mu", "nu", "count"):
                assert torch.equal(getattr(state, field),
                                   getattr(before, field)), field
    assert int(state.count[0]) == N_STEPS - 1
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=TOL, atol=TOL,
                               err_msg="batch losses")
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=TOL, atol=TOL,
                               err_msg="raw gradient norms")
    # the model learned something, so the losses were worth tracking
    assert got[-5:, 0].mean() < got[:5, 0].mean()


def test_a_stacked_fold_with_no_real_sample_stays_put():
    """Fold 1 sees only padding; fold 0 trains as it would alone."""
    x, y, batches = _pool_and_batches(seed=2)
    params, bs = jax_variables(C, T, F1, D, seed=3, perturb_bn=False)
    for bn_mode in ("flax", "torch"):
        model = EEGNet(C, T, F1=F1, D=D, dropout_rate=0.0, bn_mode=bn_mode,
                       device="cpu")
        alone, both = _port_state(model, params, bs), \
            _port_state(model, params, bs, n_folds=2)
        start = both
        for idx, w in batches[:8]:
            xb, yb = torch.from_numpy(x[idx]), torch.from_numpy(y[idx])
            wb = torch.from_numpy(w)
            alone, la, _ = steps.train_step(
                model, alone, xb[None], yb[None], wb[None],
                learning_rate=1e-3, adam_eps=1e-7)
            both, lb, gb = steps.train_step(
                model, both, torch.stack([xb, xb]), torch.stack([yb, yb]),
                torch.stack([wb, torch.zeros_like(wb)]), learning_rate=1e-3,
                adam_eps=1e-7)
            torch.testing.assert_close(lb[0], la[0], rtol=1e-6, atol=1e-6)
            assert float(lb[1]) == 0.0 and float(gb[1]) == 0.0
        # The temporal BatchNorm's scale and bias have a true gradient of 0
        # (each feeds one group of the spatial convolution, whose BatchNorm
        # removes a per-channel scale and constant), so their gradients are
        # rounding noise that differs between a grouped and a plain
        # convolution, and Adam turns noise into steps of ~lr.
        noise = {i for name in ("temporal.1.weight", "temporal.1.bias")
                 for i in range(*_span(model, name))}
        keep = [i for i in range(both.params.shape[1]) if i not in noise]
        torch.testing.assert_close(both.params[0, keep], alone.params[0, keep],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(both.params[0], alone.params[0],
                                   rtol=0, atol=8 * 1e-3)
        for field in ("params", "stats", "mu", "nu", "count"):
            assert torch.equal(getattr(both, field)[1],
                               getattr(start, field)[1]), field


def _span(model, name):
    layout = steps.StateLayout.of(model).params
    at = 0
    for n, shape in zip(layout.names, layout.shapes):
        size = int(np.prod(shape))
        if n == name:
            return at, at + size
        at += size
    raise KeyError(name)


def test_unknown_maxnorm_mode_raises():
    model = EEGNet(C, T, device="cpu")
    state = _port_state(model, *jax_variables(C, T, F1, D))
    with pytest.raises(ValueError, match="maxnorm_mode"):
        steps.train_step(model, state, torch.zeros(1, 2, C, T),
                         torch.zeros(1, 2, dtype=torch.int64),
                         torch.ones(1, 2), learning_rate=1e-3, adam_eps=1e-7,
                         maxnorm_mode="clip")
