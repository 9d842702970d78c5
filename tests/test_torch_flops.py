"""The port's FLOP counts against the JAX package's cost-model counts.

The JAX package lowers its step functions and reads XLA's HLO cost model
(``eegnetreplication_tpu/utils/flops.py``); the port counts EEGNet's work
in closed form from the shapes (``eegnetreplication_tpu_torch/utils/
flops.py``).  Both count convolutions at 2 FLOPs per multiply-accumulate
over the taps inside the input, elementwise ops at one per element, and
transcendentals at none.  They differ in three places, all small:

- the JAX count holds threefry's integer ops for each dropout mask (~42 an
  element); the port draws its masks with ``torch.rand`` and counts none;
- the JAX fused eval step computes all 32 taps over the padded time axis;
  the port counts the taps inside the signal, which is what makes a short
  trial's eval step (T=128 here) come out ~3% under JAX's;
- the per-element op counts of each elementwise pass are whole numbers
  read off the JAX step's HLO, not its exact op mix.

Both stay within 5% at the product width (the four anchors below, counted
by the JAX package on the CPU) and at a narrow shape.
"""

from types import SimpleNamespace

import pytest
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu_torch.utils import flops

TOLERANCE = 0.05

# JAX's counts at the product width (22 x 257, F1=8, D=2) with
# JAX_PLATFORMS=cpu; eval_step goes through the fused block-1 algebra,
# which is why it is below 64 forwards.
ANCHORS = {
    ("train_step", 64): 465_994_912,
    ("eval_step", 64): 34_066_112,
    ("eval_forward", 1): 3_227_028,
    ("eval_forward", 128): 413_049_344,
}

_PORT = {
    "train_step": flops.train_step_flops,
    "eval_step": flops.eval_step_flops,
    "eval_forward": flops.eval_forward_flops,
}


def _model(c, t, f1, d):
    return SimpleNamespace(n_channels=c, n_times=t, F1=f1, D=d, n_classes=4)


@pytest.mark.parametrize("what, batch", sorted(ANCHORS))
def test_product_width_counts_are_within_5pct_of_jax(what, batch):
    got = _PORT[what](_model(22, 257, 8, 2), batch)
    want = ANCHORS[(what, batch)]
    assert abs(got / want - 1) <= TOLERANCE, (what, batch, got, want)


@pytest.fixture(scope="module")
def jax_narrow_counts():
    """The JAX package's counts at a narrow shape (C=8, T=128, F1=8, D=2,
    batch 16), measured here."""
    from eegnetreplication_tpu.training.steps import make_optimizer
    from eegnetreplication_tpu.utils import flops as jax_flops
    from torch_port_cases import jax_model

    model, tx = jax_model(8, 128, 8, 2), make_optimizer()
    shape = (8, 128)
    return {
        "train_step": jax_flops.train_step_flops(model, tx, 16, shape),
        "eval_step": jax_flops.eval_step_flops(model, tx, 16, shape),
        "eval_forward": jax_flops.eval_forward_flops(model, 16, shape),
    }


@pytest.mark.parametrize("what", sorted(_PORT))
def test_narrow_shape_counts_are_within_5pct_of_jax(what,
                                                    jax_narrow_counts):
    want = jax_narrow_counts[what]
    assert want
    got = _PORT[what](_model(8, 128, 8, 2), 16)
    assert abs(got / want - 1) <= TOLERANCE, (what, got, want)


def test_fold_epoch_counts_the_scanners_slots():
    model = _model(22, 257, 8, 2)
    got = flops.fold_epoch_flops(model, batch_size=64, train_pad=1440,
                                 val_pad=864)
    want = (23 * flops.train_step_flops(model, 64)
            + 14 * flops.eval_step_flops(model, 64))
    assert got == want
    # the 90-fold cross-subject fold-epoch: ~11.2 GFLOP
    assert 10.5e9 < got < 11.5e9


@pytest.mark.parametrize("name, peak", [
    ("NVIDIA H100 80GB HBM3", 66.9e12),
    ("NVIDIA H100 PCIe", 51.2e12),
    ("NVIDIA A100-SXM4-40GB", None),
])
def test_peak_keys_on_the_card_name_and_has_no_tpu_default(name, peak,
                                                           monkeypatch):
    monkeypatch.delenv("EEGTPU_PEAK_FLOPS", raising=False)
    got, label = flops.assumed_peak_flops(name)
    assert got == peak
    assert "TPU" not in label and "v5e" not in label
    assert flops.mfu(1e12, name) == (None if peak is None else 1e12 / peak)


def test_peak_override(monkeypatch):
    monkeypatch.setenv("EEGTPU_PEAK_FLOPS", "1e12")
    assert flops.assumed_peak_flops("anything") == (1e12,
                                                    "EEGTPU_PEAK_FLOPS=1e12")


@pytest.mark.parametrize("device, card", [
    ("cpu", None), ("cuda", "NVIDIA H100 80GB HBM3"),
    ("cuda", "an unknown card")])
def test_throughput_line_has_gflops_and_mfu_only_on_a_known_card(
        device, card, monkeypatch):
    import torch

    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
    from eegnetreplication_tpu_torch.training import protocols

    monkeypatch.delenv("EEGTPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(protocols, "_device_kind", lambda d: card)
    lines = []
    monkeypatch.setattr(protocols.logger, "info",
                        lambda fmt, *a: lines.append(fmt % a))
    protocols._log_throughput(_model(22, 257, 8, 2), DEFAULT_TRAINING,
                              90.0, 1.0, 1440, 864, "90 folds x 1 epochs",
                              torch.device(device))
    (line,) = lines
    fe = flops.fold_epoch_flops(_model(22, 257, 8, 2), batch_size=64,
                                train_pad=1440, val_pad=864)
    assert line.startswith("Throughput: 90.00 fold-epochs/s")
    assert f"{90 * fe / 1e9:.2f} GFLOP/s" in line
    if card and "H100" in card:
        assert f"= {100 * 90 * fe / 66.9e12:.4f}% MFU (H100 SXM" in line
    else:
        assert "MFU" not in line
