"""``ops/bn_spatial.py``: ``temporal.1``'s training BatchNorm and the spatial
convolution as one op, and the gate that sends the banded training
forward to it.

- The plain twin of the kernels' arithmetic (f64 statistics, the forward,
  the hand-derived backward) against autograd through the composition it
  replaces (``models/norm.py::batch_norm_train`` in flax mode on the
  permuted view, then ``ops/banded.py::spatial_conv_banded``): the
  output, the running statistics and the gradients of ``h``, ``scale``,
  ``bias`` and the spatial kernel within 1e-5 of the largest value (f32
  sums in another order), over G, (F1, D), T, a constant feature where
  the variance clamp binds, and ``sample_weights`` present but unread.
- The gate (``models/eegnet.py::fuses_bn_spatial``) and what the model
  hands it; the launch plan and the layout the kernels take; the
  ``train.steps`` counter.
- On a card (``gpu``, skipped without one): the kernels against the twin
  at the 90-fold shape and a ragged one, two runs bitwise equal, the
  launch counts, and a refused launch raising.  On the card's machine:
  ``python -m pytest --noconftest -m gpu tests/test_torch_bn_spatial.py``.
"""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch_port_cases import child_env  # noqa: F401  (one torch thread)

from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.models import eegnet as eegnet_lib
from eegnetreplication_tpu_torch.models.norm import batch_norm_train
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.ops import banded, bn_spatial
from eegnetreplication_tpu_torch.training import loop, steps

SOURCE = (Path(bn_spatial.__file__).parent / "csrc" / "bn_spatial.cu"
          ).read_text()
TOL = 1e-5


def _operands(g, b, c, t, f1, d, seed=0, const=None, pad=0):
    """h ``(G, B, C, T, F1)`` (a slice of a longer time axis when
    ``pad``; feature 0 held at ``const`` when given), the BatchNorm's
    ``(G, F1)`` operands, the spatial kernel and an output cotangent."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(g, b, c, t + pad, f1, generator=gen) * 1.7 + 0.3
    if const is not None:
        h[..., 0] = const
    h = h[:, :, :, :t]
    return {
        "h": h,
        "scale": torch.rand(g, f1, generator=gen) + 0.5,
        "bias": torch.randn(g, f1, generator=gen),
        "mean": torch.randn(g, f1, generator=gen),
        "var": torch.rand(g, f1, generator=gen) + 0.5,
        "weight": torch.randn(g, f1 * d, 1, c, 1, generator=gen) / c ** 0.5,
        "dout": torch.randn(g, b, t, f1 * d, generator=gen),
    }


def _composition(h, scale, bias, mean, var, weight, sample_weights=None):
    """What the banded forward ran before the op (and still runs off the
    gate)."""
    y, new_mean, new_var = batch_norm_train(
        h.permute(1, 0, 4, 2, 3), scale, bias, mean, var, sample_weights,
        mode="flax", momentum=0.9, eps=1e-5)
    return (banded.spatial_conv_banded(y.permute(1, 0, 3, 4, 2), weight),
            new_mean, new_var)


def _run(fn, ops, **kw):
    """``fn``'s output, running statistics and gradients of (h, scale,
    bias, weight) under ``ops["dout"]``."""
    leaves = {k: ops[k].detach().clone().requires_grad_(True)
              for k in ("h", "scale", "bias", "weight")}
    out, new_mean, new_var = fn(leaves["h"], leaves["scale"],
                                leaves["bias"], ops["mean"], ops["var"],
                                leaves["weight"], **kw)
    grads = torch.autograd.grad(out, list(leaves.values()), ops["dout"])
    return [out.detach(), new_mean, new_var, *grads]


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()))


def _op(h, scale, bias, mean, var, weight):
    return bn_spatial.bn_spatial_train(h, scale, bias, mean, var, weight)


@pytest.mark.parametrize("t", [257, 600])
@pytest.mark.parametrize("f1, d", [(8, 2), (16, 4)])
@pytest.mark.parametrize("g", [1, 3])
def test_the_twin_matches_autograd_through_the_composition(g, f1, d, t):
    ops = _operands(g, 4, 3, t, f1, d, seed=g * 100 + f1 + t)
    _close(_run(_op, ops), _run(_composition, ops))


@pytest.mark.parametrize("pad", [0, 7])
def test_sample_weights_are_unread_and_strided_rows_are_taken(pad):
    """Flax mode reads no ``sample_weights``; ``h`` sliced out of a longer
    time axis (the tiled temporal convolution's output) needs no copy."""
    ops = _operands(2, 5, 4, 37, 8, 2, seed=3, pad=pad)
    w = torch.ones(2, 5)
    w[1, 3:] = 0.0
    _close(_run(_op, ops), _run(_composition, ops, sample_weights=w))


@pytest.mark.parametrize("const", [0.7, 0.5])
def test_a_constant_feature(const):
    """Feature 0 constant: at 0.7 the composition's f32 ``m2 - m^2`` is
    negative, so the clamp binds and its gradient is zero; at 0.5 it is
    exactly 0.  The twin's f64 variance is 0 to rounding either way.  Its
    scale gradient there is 0, as the composition's is in f64; in f32 the
    composition's mean is off 0.7 by a rounding, which its scale gradient
    amplifies by 1 / sqrt(eps), so that one number is held to the f64
    composition alone."""
    ops = _operands(2, 4, 3, 37, 8, 2, seed=5, const=const)
    x = ops["h"].permute(1, 0, 4, 2, 3)
    raw = (x * x).mean((0, 3, 4)) - x.mean((0, 3, 4)) ** 2
    assert bool((raw[:, 0] < 0).all()) == (const == 0.7)
    got = _run(_op, ops)
    exact = _run(_composition, {k: v.double() for k, v in ops.items()})
    _close(got, [v.float() for v in exact])
    f32 = _run(_composition, ops)
    for i, (a, b) in enumerate(zip(got, f32)):
        if i == 4:      # the scale gradient
            a, b = a[:, 1:], b[:, 1:]
        _close([a], [b])


def test_the_statistics_and_their_running_update():
    ops = _operands(3, 4, 3, 41, 8, 2, seed=9)
    h = ops["h"]
    stat, new_mean, new_var = bn_spatial.stats_reference(
        h, ops["scale"], ops["mean"], ops["var"], 0.9, 1e-5)
    hd = h.double()
    m = hd.mean((1, 2, 3))
    v = hd.var((1, 2, 3), correction=0)
    torch.testing.assert_close(stat[..., 0], m.float())
    torch.testing.assert_close(stat[..., 2], (1 / torch.sqrt(v + 1e-5))
                               .float())
    torch.testing.assert_close(stat[..., 1], stat[..., 2] * ops["scale"])
    assert bool((stat[..., 3] == 1).all())
    torch.testing.assert_close(new_mean, 0.9 * ops["mean"] + 0.1 * m.float())
    torch.testing.assert_close(new_var, 0.9 * ops["var"] + 0.1 * v.float())


def _fake_cuda(dtype=torch.float32):
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype)


GATE = dict(train=True, bn_mode="flax", precision="highest", bn_group=None,
            c=22, f1=8, d=2)


@pytest.mark.parametrize("change, fuses", [
    ({}, True),
    ({"bn_group": SimpleNamespace(active=False)}, True),
    ({"bn_mode": "torch"}, False),
    ({"precision": "high"}, False),
    ({"precision": None}, False),
    ({"bn_group": SimpleNamespace(active=True)}, False),
    ({"train": False}, False),
    ({"f1": 3}, False),
    ({"d": 3}, False),
])
def test_the_gate(change, fuses):
    assert eegnet_lib.fuses_bn_spatial(_fake_cuda(), **{**GATE, **change}) \
        is fuses


@pytest.mark.parametrize("x", [torch.zeros(1), torch.zeros(1).bfloat16(),
                               _fake_cuda(torch.bfloat16)])
def test_the_gate_sends_cpu_and_bf16_to_the_composition(x):
    assert eegnet_lib.fuses_bn_spatial(x, **GATE) is False


@pytest.mark.parametrize("kw, fuses", [
    ({}, True),
    ({"bn_mode": "torch"}, False),
    ({"precision": "high"}, False),
    ({"precision": None}, False),
    ({"dtype": torch.bfloat16}, False),
])
def test_the_model_hands_the_gate_its_fields(monkeypatch, kw, fuses):
    """``EEGNet.stacked`` passes its numerics and BatchNorm mode down; here
    (a CPU tensor) the composition runs and the op is never called."""
    seen, gate = [], eegnet_lib.fuses_bn_spatial

    def spy(x, **fields):
        seen.append(gate(_fake_cuda(x.dtype), **fields))
        return False

    def never(*a, **k):
        raise AssertionError("the op ran off the gate")

    monkeypatch.setattr(eegnet_lib, "fuses_bn_spatial", spy)
    monkeypatch.setattr(bn_spatial, "bn_spatial_train", never)
    model = EEGNet(4, 64, conv_impl="banded", device="cpu",
                   generator=torch.Generator().manual_seed(0), **kw)
    init = loop.init_fold_states(model, 2, torch.Generator().manual_seed(1))
    x = torch.randn(2, 3, 4, 64, generator=torch.Generator().manual_seed(2))
    model.stacked(init.param_views(), init.stat_views(), x, train=True)
    assert seen == [fuses]


def test_the_fused_forward_of_the_model_matches_its_composition(monkeypatch):
    """With the gate held open, the model's training forward takes the op
    (its twin on the CPU): logits, every running statistic and every
    parameter gradient as the composition gives them."""
    model = EEGNet(4, 64, dropout_rate=0.0, conv_impl="banded", device="cpu")
    init = loop.init_fold_states(model, 3, torch.Generator().manual_seed(4))
    x = torch.randn(3, 5, 4, 64, generator=torch.Generator().manual_seed(5))
    calls = []
    real_op = bn_spatial.bn_spatial_train

    def counted(*a, **k):
        calls.append(1)
        return real_op(*a, **k)

    monkeypatch.setattr(bn_spatial, "bn_spatial_train", counted)
    out = {}
    for fused in (False, True):
        monkeypatch.setattr(eegnet_lib, "fuses_bn_spatial",
                            lambda *a, fused=fused, **k: fused)
        params = {k: v.clone().requires_grad_(True)
                  for k, v in init.param_views().items()}
        logits, new = model.stacked(params, init.stat_views(), x, train=True)
        grads = torch.autograd.grad(logits.square().sum(),
                                    list(params.values()))
        out[fused] = ([logits.detach(), *new.values()], grads)
    assert len(calls) == 1
    assert list(new) == [k for k in init.stat_views()]
    _close(out[True][0], out[False][0])
    # temporal.1.bias's gradient is 0 but for rounding (aggregation.0
    # cancels a shift per feature), so gradients are held to the largest
    largest = max(float(v.abs().max()) for v in out[False][1])
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL * largest)


def test_train_steps_count_once_each():
    model = EEGNet(4, 64, conv_impl="banded", device="cpu")
    state = loop.init_fold_states(model, 2, torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 3, 4, 64, generator=gen)
    y = torch.randint(0, 4, (2, 3), generator=gen)
    w = torch.ones(2, 3)
    trace.reset_layers()
    for _ in range(3):
        state, _, _ = steps.train_step(model.train(), state, x, y, w,
                                       learning_rate=1e-3, adam_eps=1e-7)
    counts = trace.layer_counts()
    trace.reset_layers()
    assert counts["train.steps"] == 3
    assert "bn_spatial.forwards" not in counts      # the CPU runs no kernel


def _constexpr(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


def test_the_wrapper_plans_with_the_kernels_constants():
    assert bn_spatial.THREADS == _constexpr("kThreads")
    assert bn_spatial.TILE_FLOATS == _constexpr("kTileFloats")
    warps, f1_max = bn_spatial.THREADS // 32, _constexpr("kMaxF1")
    static = 2 * warps * f1_max * 8          # pass C's f64 reductions
    assert bn_spatial.SMEM_FLOATS == (48 * 1024 - static) // 4


@pytest.mark.parametrize("g, b, c, t, f1, d, aligned", [
    (90, 64, 22, 257, 8, 2, True), (1, 64, 22, 257, 16, 4, True),
    (3, 5, 3, 37, 8, 2, True), (2, 3, 5, 33, 2, 2, True),
    (8, 16, 22, 1125, 8, 2, True), (1, 1, 64, 1125, 32, 4, True),
    (4, 8, 22, 257, 8, 2, False), (2, 2, 3, 37, 1, 4, True),
])
def test_the_plan(g, b, c, t, f1, d, aligned):
    row = t * f1
    p = bn_spatial.plan(g, b, c, t, f1, d, row, aligned)
    assert p.vec == (4 if aligned and row % 4 == 0 else 1)
    step = 32 * p.vec
    assert p.tile % step == 0 and p.tile * d <= bn_spatial.TILE_FLOATS
    assert min(p.tile, row) * d + c * f1 * d <= bn_spatial.SMEM_FLOATS
    assert (p.n_tiles - 1) * p.tile < row <= p.n_tiles * p.tile
    # as few tiles as shared memory allows
    cap = (bn_spatial.SMEM_FLOATS - c * f1 * d) // d
    wanted = -(-row // min(cap, bn_spatial.TILE_FLOATS // d))
    assert p.n_tiles <= wanted
    assert p.tile == step or -(-row // (p.tile - step)) > wanted
    assert 1 <= p.per_fold <= -(-b * c // (bn_spatial.THREADS // 32))
    assert g * p.per_fold >= min(bn_spatial.TARGET_BLOCKS,
                                 g * -(-b * c // 8))


def test_row_pitch():
    h = torch.zeros(2, 3, 4, 40, 8)
    assert bn_spatial.row_pitch(h) == 320
    assert bn_spatial.row_pitch(h[:, :, :, :37]) == 320
    assert bn_spatial.row_pitch(torch.zeros(1, 1, 1, 5, 8)) == 40
    with pytest.raises(ValueError, match="evenly spaced"):
        bn_spatial.row_pitch(h.transpose(1, 2))
    with pytest.raises(ValueError, match="evenly spaced"):
        bn_spatial.row_pitch(h[..., :4])


def test_what_the_op_refuses():
    ops = _operands(2, 3, 4, 16, 8, 2)
    with pytest.raises(ValueError, match="does not fit"):
        bn_spatial.bn_spatial_train(ops["h"], ops["scale"], ops["bias"],
                                    ops["mean"], ops["var"],
                                    ops["weight"][:, :, :, :3])
    with pytest.raises(ValueError, match="no kernel for device"):
        bn_spatial.bn_spatial_train(ops["h"].to("meta"), ops["scale"],
                                    ops["bias"], ops["mean"], ops["var"],
                                    ops["weight"])


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bn_spatial kernels have no CPU "
                    "mode (their plain twin is tested on the CPU above)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the twin's einsums
    return torch.device("cuda", 0)


def _on(ops, dev):
    return {k: v.to(dev) for k, v in ops.items()}


# Output and input gradient: f32 per element, sums over C in another
# order.  The scale, bias and kernel gradients sum ~B*T (kernel) to
# ~B*C*T (BatchNorm) f32 products in blocks, then in f64; the twin's
# einsums sum in f32 in cuBLAS's order.
CARD_TOL = (1e-5, 1e-5, 1e-5, 1e-5, 1e-4, 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, pad", [
    ((90, 64, 22, 257, 8, 2), 0), ((3, 5, 3, 37, 8, 2), 0),
    ((2, 4, 22, 1125, 8, 2), 155), ((1, 8, 22, 257, 16, 4), 0),
])
def test_the_kernels_match_the_twin_on_the_card(cuda, shape, pad):
    ops = _on(_operands(*shape, seed=11, pad=pad), cuda)
    got = _run(_op, ops)
    launches = bn_spatial.bn_spatial_train.launches
    trace.reset_layers()
    again = _run(_op, ops)
    torch.cuda.synchronize()
    assert bn_spatial.bn_spatial_train.launches - launches == 6
    assert trace.layer_counts().get("bn_spatial.forwards") == 1
    trace.reset_layers()
    for a, b in zip(got, again):
        assert torch.equal(a, b)            # no atomics: bitwise repeatable
    h = ops["h"]
    g, b, c, t, f1 = h.shape
    s = ops["weight"][:, :, 0, :, 0].reshape(g, f1, -1, c).contiguous()
    stat, new_mean, new_var = bn_spatial.stats_reference(
        h, ops["scale"], ops["mean"], ops["var"], 0.9, 1e-5)
    out = bn_spatial.forward_reference(h, s, stat, ops["bias"])
    dh, dscale, dbias, ds = bn_spatial.backward_reference(
        h, ops["dout"], s, stat, ops["scale"], ops["bias"])
    want = [out, new_mean, new_var, dh, dscale, dbias,
            ds.reshape(ops["weight"].shape)]
    for a, b, tol in zip(got, want, CARD_TOL):
        torch.testing.assert_close(a, b, rtol=tol,
                                   atol=tol * float(b.abs().max()))


@pytest.mark.gpu
def test_a_refused_launch_raises(cuda):
    """A dout tile past a block's 48 KB of shared memory: the runtime
    refuses the launch and the wrapper raises."""
    ops = _on(_operands(1, 2, 3, 2048, 8, 2), cuda)
    h = ops["h"]
    s = ops["weight"][:, :, 0, :, 0].reshape(1, 8, 2, 3).contiguous()
    lib = bn_spatial._library()
    p = bn_spatial.plan(1, 2, 3, 2048, 8, 2, 2048 * 8, True)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    _, stat, _, _ = bn_spatial._launch_forward(
        lib, h, s, ops["scale"], ops["bias"], ops["mean"], ops["var"], 0.9,
        1e-5, 2048 * 8, p, stream)
    huge = bn_spatial.Plan(p.vec, p.per_fold, 2048 * 8, 1)   # 128 KB a block
    with pytest.raises(RuntimeError, match="backward launch failed"):
        bn_spatial._launch_backward(lib, h, ops["dout"], s, ops["scale"],
                                    ops["bias"], stat, 2048 * 8, huge, stream)
