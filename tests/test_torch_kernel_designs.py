"""The index and carry algebra of the port's two CUDA kernels, on the CPU.

The kernels themselves run only on a card (``test_torch_gpu.py``).  Here a
numpy float32 emulation of each design, built from the tile constants of
the CUDA sources (K1's ``constexpr``s read from ``block1.cu``; K2's as the
wrapper declares them, which must equal ``ems.cu``'s), is held against the
port's plain version and the JAX package's:

- K2 (``csrc/ems.cu``): (C, T) split into the kernel's tiles; per tile the
  zero-start mean aggregate ``b_m`` (per-thread serial spans, the
  warp-shuffle and warp-total scans), the fold of the predecessors' ``b_m``
  in the kernel's fixed lane order, the rerun for the deviations, the
  variance aggregate ``b_v``, its fold, and the output.  Against
  ``ems_reference`` and the JAX ``scan`` method at rtol/atol 1e-4, the JAX
  package's own Pallas-vs-scan tolerance.
- K1 (``csrc/block1.cu``): the grid over (trial, filter tile, time tile),
  each block's staged window with its halo and zero padding, the channel
  passes, the taps of one pool window per thread and the pooled-output
  index.  Against ``block1_reference`` and the JAX ``block1_reference`` at
  atol 1e-5 (only the order of the f32 sums differs).
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.ops import fused_eegnet as jax_fused
from eegnetreplication_tpu.ops.ems import (
    exponential_moving_standardize as jax_ems,
)
from eegnetreplication_tpu_torch.ops import ems_kernel
from eegnetreplication_tpu_torch.ops import fused_eegnet as fused

CSRC = Path(ems_kernel.__file__).resolve().parent / "csrc"
EMS_TOL = 1e-4
K1_ATOL = 1e-5
F32 = np.float32


def _constexprs(name: str) -> dict:
    text = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_wrapper_constants_are_the_kernels():
    k2 = _constexprs("ems")
    assert (k2["kThreads"], k2["kItems"]) == (ems_kernel.EMS_THREADS,
                                              ems_kernel.EMS_ITEMS)
    assert ems_kernel.EMS_TILE == ems_kernel.EMS_THREADS * ems_kernel.EMS_ITEMS
    k1 = _constexprs("block1")
    assert (k1["kTaps"], k1["kPadLeft"]) == (fused.TEMPORAL_K, fused.PAD_LEFT)
    assert k1["kWindow"] >= 4 * k1["kPoolTile"] + fused.TEMPORAL_K - 1


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------

THREADS = ems_kernel.EMS_THREADS
ITEMS = ems_kernel.EMS_ITEMS
TILE = ems_kernel.EMS_TILE
WARPS = THREADS // 32


def _warp_scan(b, spans, unit):
    """Inclusive Hillis-Steele scan along the last axis (the lanes), as
    ``warp_scan``: at offset o, lane l >= o adds c^(ITEMS unit o) times
    lane l - o."""
    o = 1
    while o < b.shape[-1]:
        nxt = b.copy()
        nxt[..., o:] = spans[unit * o] * b[..., :-o] + b[..., o:]
        b = nxt
        o *= 2
    return b


def _block_scan(part, spans):
    """``block_scan`` over the threads (last axis): the state entering each
    thread's span from a zero start at the tile start, and the tile's
    total."""
    lanes = part.reshape(*part.shape[:-1], WARPS, 32)
    incl = _warp_scan(lanes, spans, 1)
    excl = np.zeros_like(incl)
    excl[..., 1:] = incl[..., :-1]
    w_incl = _warp_scan(incl[..., 31], spans, 32)
    w_excl = np.zeros_like(w_incl)
    w_excl[..., 1:] = w_incl[..., :-1]
    entering = spans[:32] * w_excl[..., None] + excl
    return entering.reshape(part.shape), w_incl[..., -1]


def _fold(agg, tile_pow, init):
    """``fold`` for every tile k of every channel: lane l sums
    tile_pow[k-1-j] agg[j] over j = l, l+32, ... < k in order, a butterfly
    of xor shuffles adds the lanes, then tile_pow[k] init."""
    n_ch, tiles = agg.shape
    out = np.zeros((n_ch, tiles), F32)
    for k in range(tiles):
        lanes = np.zeros((n_ch, 32), F32)
        for j in range(k):
            lanes[:, j % 32] = tile_pow[k - 1 - j] * agg[:, j] \
                + lanes[:, j % 32]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        out[:, k] = tile_pow[k] * init + lanes[:, 0]
    return out


def emulate_k2(x, factor_new=1e-3, init_block_size=1000, eps=1e-10):
    """K2's decomposition of EMS over ``x (C, T)`` in numpy float32."""
    x = np.asarray(x, F32)
    n_ch, t_total = x.shape
    a, c = (F32(v) for v in ems_kernel.f32_coefficients(factor_new))
    mean0, var0 = (t.numpy() for t in ems_kernel.seed_stats(
        torch.from_numpy(x), init_block_size))
    tiles = ems_kernel.n_tiles(t_total)
    powers = ems_kernel._powers(float(c), tiles, torch.device("cpu")).numpy()
    spans, tile_pow = powers[:THREADS + 1], powers[THREADS + 1:]

    # Each tile as (C, tiles, THREADS, ITEMS); past T reads as z = 0.
    z = np.zeros((n_ch, tiles * TILE), F32)
    z[:, :t_total] = x - mean0[:, None]
    z = z.reshape(n_ch, tiles, THREADS, ITEMS)

    part = np.zeros(z.shape[:-1], F32)
    for s in range(ITEMS):
        part = c * part + a * z[..., s]
    m_enter, b_m = _block_scan(part, spans)
    m_in = _fold(b_m, tile_pow, np.zeros(n_ch, F32))
    m = spans[:THREADS] * m_in[..., None] + m_enter

    dev = np.zeros_like(z)
    part = np.zeros(z.shape[:-1], F32)
    for s in range(ITEMS):
        m = c * m + a * z[..., s]
        dev[..., s] = z[..., s] - m
        part = c * part + a * (dev[..., s] * dev[..., s])
    v_enter, b_v = _block_scan(part, spans)
    v_in = _fold(b_v, tile_pow, var0)
    v = spans[:THREADS] * v_in[..., None] + v_enter

    out = np.zeros_like(z)
    for s in range(ITEMS):
        v = c * v + a * (dev[..., s] * dev[..., s])
        out[..., s] = dev[..., s] / np.sqrt(v + F32(eps))
    return out.reshape(n_ch, -1)[:, :t_total]


# name -> ((C, T), kwargs, constant)
K2_CASES = {
    "one_tile": ((2, TILE), {}, None),
    "tile_minus_1": ((2, TILE - 1), {}, None),
    "tile_plus_1": ((2, TILE + 1), {}, None),
    "3_tiles_minus_1": ((2, 3 * TILE - 1), {}, None),
    "3_tiles_plus_1": ((3, 3 * TILE + 1), {}, None),
    "short_of_a_tile": ((3, 700), {}, None),
    "init_past_T": ((2, 50), {}, None),
    "init_100_two_tiles": ((1, 2 * TILE + 5), {"init_block_size": 100}, None),
    "constant": ((3, 2 * TILE + 3), {"init_block_size": 100}, 5.0),
    "factor_0_1": ((2, 2 * TILE + 7), {"factor_new": 0.1}, None),
}

_jax_scan = jax.jit(functools.partial(jax_ems, method="scan"),
                    static_argnames=("factor_new", "init_block_size"))


@functools.lru_cache(maxsize=None)
def _k2_case(name):
    (n_ch, t_total), kw, constant = K2_CASES[name]
    if constant is not None:
        x = np.full((n_ch, t_total), constant, F32)
    else:
        rng = np.random.RandomState(sorted(K2_CASES).index(name))
        x = (rng.randn(n_ch, t_total) * 5.0 + 2.0).astype(F32)
    return x, kw, emulate_k2(x, **kw)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_emulation_matches_ems_reference(case):
    x, kw, got = _k2_case(case)
    want = ems_kernel.ems_reference(torch.from_numpy(x), **kw).numpy()
    assert got.shape == x.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=EMS_TOL, atol=EMS_TOL)


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_emulation_matches_jax_scan(case):
    x, kw, got = _k2_case(case)
    want = np.asarray(_jax_scan(x, **kw))
    np.testing.assert_allclose(got, want, rtol=EMS_TOL, atol=EMS_TOL)


def test_k2_emulation_of_a_constant_signal_is_zero():
    _, _, got = _k2_case("constant")
    assert float(np.abs(got).max()) < 1e-3


@pytest.mark.parametrize("t_total, tiles", [
    (1, 1), (TILE - 1, 1), (TILE, 1), (TILE + 1, 2), (345_600, 85)])
def test_k2_tiles_per_channel(t_total, tiles):
    assert ems_kernel.n_tiles(t_total) == tiles


@pytest.mark.parametrize("factor_new", [1e-3, 0.1])
def test_k2_coefficients_are_float64_powers_rounded_once(factor_new):
    _, c = ems_kernel.f32_coefficients(factor_new)
    table = ems_kernel._powers(c, 85, torch.device("cpu")).numpy()
    assert table.dtype == np.float32 and table.shape == (THREADS + 1 + 85,)
    n = np.concatenate([ITEMS * np.arange(THREADS + 1),
                        TILE * np.arange(85)])
    np.testing.assert_array_equal(
        table, (np.float64(c) ** n.astype(np.float64)).astype(F32))
    assert table[0] == 1.0 and table[THREADS + 1] == 1.0


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------

_K1 = _constexprs("block1")
FT = _K1["kFTile"]
QT = _K1["kPoolTile"]
WINDOW = _K1["kWindow"]
ROWS = _K1["kRows"]
TIME_TILE = 4 * QT


def emulate_k1(x, S, W, A, B):
    """K1's grid over (trial, filter tile, time tile) in numpy float32:
    each block stages the WINDOW samples from tq * TIME_TILE - 15 (zero
    outside [0, T)), mixes them in passes of ROWS channels, and thread
    (f, q) computes pooled output tq * QT + q from window columns
    4 q + j + k."""
    x, S, W, A, B = (np.asarray(v, F32) for v in (x, S, W, A, B))
    n_b, n_c, t = x.shape
    f2 = S.shape[0]
    t_pool = t // 4
    n_tq = -(-t_pool // QT)
    n_ft = -(-f2 // FT)
    # Filters past F2 have zero weights and are never written.
    pad_f = n_ft * FT - f2
    S = np.pad(S, ((0, pad_f), (0, 0)))
    W = np.pad(W, ((0, pad_f), (0, 0)))
    A = np.pad(A, (0, pad_f))
    B = np.pad(B, (0, pad_f))

    # Window column p of time tile tq is sample tq * TIME_TILE - 15 + p.
    cols = (np.arange(n_tq)[:, None] * TIME_TILE - fused.PAD_LEFT
            + np.arange(WINDOW)[None, :])
    valid = (cols >= 0) & (cols < t)
    xs = np.where(valid, x[..., np.clip(cols, 0, t - 1)], F32(0.0))
    # xs: (n_b, C, n_tq, WINDOW).  The mix, a pass of ROWS channels at a
    # time, channels in order within it.
    mixed = np.zeros((n_b, n_ft * FT, n_tq, WINDOW), F32)
    for c0 in range(0, n_c, ROWS):
        for c in range(c0, min(c0 + ROWS, n_c)):
            mixed = S[None, :, c, None, None] * xs[:, None, c] + mixed

    # Thread (f, q): positions 4q + j read columns 4q + j + k.
    taps = (4 * np.arange(QT)[:, None, None] + np.arange(4)[None, :, None]
            + np.arange(fused.TEMPORAL_K)[None, None, :])
    assert taps.max() < WINDOW
    windows = mixed[..., taps]            # (n_b, F, n_tq, QT, 4, K)
    acc = np.zeros(windows.shape[:-1], F32)
    for k in range(fused.TEMPORAL_K):
        acc = W[None, :, None, None, None, k] * windows[..., k] + acc
    pre = A[None, :, None, None, None] * acc + B[None, :, None, None, None]
    act = np.where(pre > 0, pre, np.expm1(pre)).astype(F32)
    pooled = ((act[..., 0] + act[..., 1]) + (act[..., 2] + act[..., 3])) \
        * F32(0.25)                       # (n_b, F, n_tq, QT)
    # Pooled output q of the trial is tq * QT + (q within the tile).
    out = pooled.reshape(n_b, n_ft * FT, n_tq * QT)
    return out[:, :f2, :t_pool]


# name -> (B, C, T, F2)
K1_CASES = {
    "product": (3, 22, 257, 16),
    "t256": (2, 22, 256, 16),
    "wide": (2, 22, 257, 64),
    "small": (2, 8, 64, 16),
    "t4_one_pool": (2, 22, 4, 16),
    "t5": (2, 22, 5, 16),
    "t_time_tile_minus_1": (2, 22, TIME_TILE - 1, 16),
    "t_time_tile": (2, 22, TIME_TILE, 16),
    "t_time_tile_plus_3": (2, 22, TIME_TILE + 3, 16),
    "t_two_tiles_plus_2": (1, 22, 2 * TIME_TILE + 2, 16),
    "t1125": (1, 22, 1125, 16),
    "two_channel_passes": (2, ROWS + 6, 130, 16),
    "f2_not_a_tile": (2, 22, 257, 12),
}


@functools.lru_cache(maxsize=None)
def _k1_case(name):
    n_b, n_c, t, f2 = K1_CASES[name]
    rng = np.random.RandomState(sorted(K1_CASES).index(name))
    x = rng.randn(n_b, n_c, t).astype(F32)
    S = (rng.randn(f2, n_c) * 0.3).astype(F32)
    W = (rng.randn(f2, fused.TEMPORAL_K) * 0.2).astype(F32)
    A = (1.0 + 0.2 * rng.randn(f2)).astype(F32)
    B = (0.2 * rng.randn(f2)).astype(F32)
    return (x, S, W, A, B), emulate_k1(x, S, W, A, B)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_emulation_matches_block1_reference(case):
    ops, got = _k1_case(case)
    want = fused.block1_reference(*(torch.from_numpy(v) for v in ops))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want.numpy(), atol=K1_ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_emulation_matches_jax_block1_reference(case):
    ops, got = _k1_case(case)
    want = np.asarray(jax_fused.block1_reference(
        *(jnp.asarray(v) for v in ops)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=K1_ATOL, rtol=0)


@pytest.mark.parametrize("t, blocks_per_trial", [
    (4, 1), (TIME_TILE, 1), (TIME_TILE + 3, 1), (TIME_TILE + 4, 2),
    (257, 8), (1125, 36)])
def test_k1_time_tiles_per_trial(t, blocks_per_trial):
    """The launcher's n_tq: one time tile per QT pooled outputs, a ragged
    last one included."""
    assert -(-(t // 4) // QT) == blocks_per_trial
