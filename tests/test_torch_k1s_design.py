"""K1-stacked's walk (``csrc/block1_stacked.cu``) emulated on the CPU.

K1-stacked runs only on a card (``test_torch_gpu.py`` holds it to K1 bit
for bit there).  Here a numpy float32 emulation of its design, with the
tile constants read from the source's ``constexpr``s and the launch sized
by the wrapper's own ``stacked_plan``, is held against the port's plain
``block1_stacked_reference`` and the JAX package's ``block1_pallas`` under
``jax.vmap`` in interpret mode, at atol/rtol 1e-5 (only the order of the
f32 sums differs from the plain versions):

- persistent blocks walking contiguous ranges of work items (a trial and a
  time tile of ``kLongPool`` or ``kShortPool`` pooled outputs), the plan's
  choice between the two and its cover of every item exactly once;
- the ring of ``kStages`` stage slots, each restaging its weight set only
  when the set changes, so a fold-major batch restages a set once a slot;
- each item's window of ``kPos + 32`` samples landing at its row's
  misalignment, the columns outside [0, T) holding the neighbouring rows'
  floats (NaN here) that the mix reads as zeros;
- the mix over channels in order, the 32 taps in order, the affine, ELU
  and the pool, and NaN rows for an index outside [0, G);
- fold-major, permuted and out-of-range indices, T in {257, 1125}.
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
from eegnetreplication_tpu_torch.ops import fused_eegnet as fused

SOURCE = Path(fused.__file__).resolve().parent / "csrc" / "block1_stacked.cu"
TOL = 1e-5
F32 = np.float32
# A card of the H100's 132 SMs holding two blocks of either item length on
# each (what the smoke's card reports at C=22, F2=16).
SMS, PER_SM = 132, 2


def _constexprs() -> dict:
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


K = _constexprs()
THREADS, FTILE, STAGES = K["kThreads"], K["kFTile"], K["kStages"]
GROUPS = THREADS // FTILE


def test_constants_are_the_wrappers():
    assert (K["kLongPool"], K["kShortPool"]) == (fused.K1S_LONG_POOL,
                                                 fused.K1S_SHORT_POOL)
    assert (K["kTaps"], K["kPadLeft"]) == (fused.TEMPORAL_K, fused.PAD_LEFT)
    assert "block1_stacked" in fused.build.SOURCES
    for pool in (K["kLongPool"], K["kShortPool"]):
        pos = 4 * pool
        assert pos % GROUPS == 0 and (pos // GROUPS) % 4 == 0
    assert STAGES >= 2


def test_k1_lost_its_stacked_entry():
    text = (SOURCE.parent / "block1.cu").read_text()
    assert "eeg_block1_stacked_launch" not in text
    assert "kStacked" not in text
    assert "eeg_block1_stacked_launch" in SOURCE.read_text()


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------

PLANS = [(5760, 257), (2304, 257), (512, 257), (128, 257), (64, 257),
         (1, 257), (8, 1125), (300, 1125), (3, 4), (7, 33)]


@pytest.mark.parametrize("n, t", PLANS, ids=[f"N{n}-T{t}" for n, t in PLANS])
def test_plan_covers_every_item_once_within_the_card(n, t):
    pool, n_items, per, grid = fused.stacked_plan(n, t, SMS, PER_SM, PER_SM)
    assert pool in (fused.K1S_LONG_POOL, fused.K1S_SHORT_POOL)
    assert n_items == n * -(-(t // 4) // pool)
    assert grid <= SMS * PER_SM
    ranges = [range(j * per, min((j + 1) * per, n_items))
              for j in range(grid)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(i for r in ranges for i in r) == list(range(n_items))
    long_items = n * -(-(t // 4) // fused.K1S_LONG_POOL)
    assert (pool == fused.K1S_LONG_POOL) == (long_items >= SMS * PER_SM)


def test_plan_spreads_the_zoo_chunk_and_walks_the_validation_batch():
    # The zoo's 128-trial chunk: short items, one a block.
    assert fused.stacked_plan(128, 257, SMS, PER_SM, PER_SM) == (
        fused.K1S_SHORT_POOL, 128 * 2, 1, 256)
    # The 90-fold validation batch: whole trials, 22 a block.
    assert fused.stacked_plan(5760, 257, SMS, PER_SM, PER_SM) == (
        fused.K1S_LONG_POOL, 5760, 22, 262)


def test_plan_falls_back_to_short_items_and_raises_when_none_fits():
    assert fused.stacked_plan(5760, 257, SMS, 0, 3)[0] == fused.K1S_SHORT_POOL
    with pytest.raises(ValueError, match="shared memory"):
        fused.stacked_plan(10, 257, SMS, 0, 0)


# --------------------------------------------------------------------------
# The walk
# --------------------------------------------------------------------------

def emulate_k1s(x, S, W, A, B, idx, per_sm_long=PER_SM,
                per_sm_short=PER_SM, base=0, sms=SMS):
    """K1-stacked's launch over ``x (N, C, T)`` in numpy float32 on a card
    of ``sms`` SMs; returns ``(out (N, F2, T//4), restages per block)``.
    ``base`` is x's address in floats modulo 4."""
    x, S, W, A, B = (np.asarray(v, F32) for v in (x, S, W, A, B))
    idx = np.asarray(idx)
    n, c_n, t = x.shape
    g_n, f2 = S.shape[:2]
    t_pool = t // 4
    pool, n_items, per, grid = fused.stacked_plan(n, t, sms, per_sm_long,
                                                  per_sm_short)
    pos = 4 * pool
    win = pos + fused.TEMPORAL_K
    per_thread = pos // GROUPS
    n_tq = -(-t_pool // pool)
    out = np.full((n, f2, t_pool), -1.0, F32)
    restages = []
    for blk in range(grid):
        held = [None] * STAGES
        staged = 0
        for k, item in enumerate(range(blk * per,
                                       min((blk + 1) * per, n_items))):
            st = k % STAGES
            b, tq = divmod(item, n_tq)
            t0 = tq * pos
            g = int(idx[b])
            ok = 0 <= g < g_n
            if ok and held[st] != g:
                held[st] = g
                staged += 1
            # The window lands at column p + d; outside [0, T) the stage
            # holds other rows' floats (NaN here), read as zeros.
            cols = t0 - fused.PAD_LEFT + np.arange(win)
            inside = (cols >= 0) & (cols < t)
            xs = np.empty((c_n, win), F32)
            for r in range(c_n):
                d = (base + (b * c_n + r) * t + t0 - fused.PAD_LEFT) % 4
                row = np.full(win + 4, np.nan, F32)
                row[d + np.flatnonzero(inside)] = x[b, r, cols[inside]]
                xs[r] = np.where(inside, row[d:d + win], F32(0.0))
            if not ok:
                out[b, :, tq * pool:min((tq + 1) * pool, t_pool)] = np.nan
                continue
            Sg, Wg, Ag, Bg = S[g], W[g], A[g], B[g]
            for f0 in range(0, f2, FTILE):
                fs = slice(f0, min(f0 + FTILE, f2))
                mixed = np.zeros((fs.stop - f0, win), F32)
                for c in range(c_n):                  # channels in order
                    mixed = Sg[fs, c, None] * xs[None, c] + mixed
                acc = np.zeros((fs.stop - f0, pos), F32)
                for kk in range(fused.TEMPORAL_K):    # taps in order
                    acc = Wg[fs, kk, None] * mixed[:, kk:kk + pos] + acc
                pre = Ag[fs, None] * acc + Bg[fs, None]
                e = np.where(pre > 0, pre, np.expm1(pre)).astype(F32)
                e = e.reshape(e.shape[0], pool, 4)
                pooled = ((e[..., 0] + e[..., 1]) + (e[..., 2] + e[..., 3])) \
                    * F32(0.25)
                q = tq * pool + np.arange(pool)
                keep = q < t_pool
                # thread (f, pg) writes pooled outputs pg * per_thread / 4
                # onward: the tile's pooled outputs, each once.
                assert per_thread * GROUPS == pos
                out[b][fs, q[keep]] = pooled[:, keep]
        restages.append(staged)
    assert not (out == -1.0).any(), "an output was never written"
    return out, restages


def _case(g, b, t, seed, c=22, f2=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(g * b, c, t).astype(F32)
    S = (0.3 * rng.randn(g, f2, c)).astype(F32)
    W = (0.2 * rng.randn(g, f2, fused.TEMPORAL_K)).astype(F32)
    A = (1.0 + 0.2 * rng.randn(g, f2)).astype(F32)
    B = (0.2 * rng.randn(g, f2)).astype(F32)
    return x, S, W, A, B


def _index(g, b, order):
    idx = np.repeat(np.arange(g, dtype=np.int32), b)
    if order == "permuted":
        idx = idx[np.random.RandomState(g * b).permutation(g * b)]
    return idx


def _reference(x, S, W, A, B, idx):
    return fused.block1_stacked_reference(
        *(torch.from_numpy(np.ascontiguousarray(v)) for v in (x, S, W, A, B)),
        torch.from_numpy(np.ascontiguousarray(idx))).numpy()


# (G, B, T, order, item length: long/short)
WALKS = [(3, 4, 257, "fold-major", "long"), (3, 4, 257, "permuted", "long"),
         (3, 4, 257, "fold-major", "short"), (2, 3, 1125, "permuted", "long"),
         (2, 3, 1125, "fold-major", "short"), (4, 5, 64, "permuted", "long"),
         (2, 2, 33, "fold-major", "short")]


def _occupancy(length):
    return (PER_SM, PER_SM) if length == "long" else (0, PER_SM)


@functools.lru_cache(maxsize=None)
def _walk(case):
    g, b, t, order, length = case
    x, S, W, A, B = _case(g, b, t, seed=WALKS.index(case))
    idx = _index(g, b, order)
    base = WALKS.index(case) % 4
    got, _ = emulate_k1s(x, S, W, A, B, idx, *_occupancy(length), base=base)
    return (x, S, W, A, B, idx), got


@pytest.mark.parametrize("case", WALKS, ids=["-".join(map(str, w))
                                             for w in WALKS])
def test_walk_matches_block1_stacked_reference(case):
    ops, got = _walk(case)
    want = _reference(*ops)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", WALKS, ids=["-".join(map(str, w))
                                             for w in WALKS])
def test_walk_matches_the_vmapped_pallas_kernel(case):
    (x, S, W, A, B, idx), got = _walk(case)
    g, b = case[0], case[1]
    # The JAX package evaluates set g on its own batch: regroup the trials
    # by set, run the vmapped kernel, and put the rows back in idx's order.
    order = np.argsort(idx, kind="stable")
    grouped = x[order].reshape(g, b, *x.shape[1:])
    pallas = jax.vmap(lambda xs, s, w, a, bb: jax_fused.block1_pallas(
        xs, s, w, a, bb, interpret=True))(
        *(jnp.asarray(v) for v in (grouped, S, W, A, B)))
    want = np.empty_like(got)
    want[order] = np.asarray(pallas).reshape(g * b, *got.shape[1:])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("length", ["long", "short"])
def test_an_index_outside_the_sets_writes_nan_rows(length):
    g, b, t = 3, 4, 257
    x, S, W, A, B = _case(g, b, t, seed=7)
    idx = _index(g, b, "fold-major")
    bad = idx.copy()
    bad[1], bad[9] = g, -1
    got, _ = emulate_k1s(x, S, W, A, B, bad, *_occupancy(length))
    assert np.isnan(got[[1, 9]]).all()
    keep = np.ones(g * b, bool)
    keep[[1, 9]] = False
    want = _reference(x, S, W, A, B, idx)
    np.testing.assert_allclose(got[keep], want[keep], atol=TOL, rtol=TOL)


def _restages(order):
    """Restages of a 6-fold batch of 40 trials a fold on a card of two
    SMs (each block walks 120 items)."""
    g, b, t = 6, 40, 257
    x, S, W, A, B = _case(g, b, t, seed=11, c=4)
    idx = _index(g, b, order)
    got, restages = emulate_k1s(x, S, W, A, B, idx, per_sm_long=1,
                                per_sm_short=1, sms=2)
    np.testing.assert_allclose(got, _reference(x, S, W, A, B, idx),
                               atol=TOL, rtol=TOL)
    return idx, restages, fused.stacked_plan(g * b, t, 2, 1, 1)


def test_a_fold_major_batch_restages_a_set_once_a_slot():
    idx, restages, (pool, n_items, per, grid) = _restages("fold-major")
    assert pool == fused.K1S_LONG_POOL and per == 120
    for blk, staged in enumerate(restages):
        sets = set(idx[blk * per:(blk + 1) * per].tolist())
        assert staged <= STAGES * len(sets)
    assert sum(restages) <= STAGES * 6 + STAGES


def test_a_permuted_batch_restages_as_its_sets_change():
    idx, restages, (_, _, per, _) = _restages("permuted")
    fold_major = sum(_restages("fold-major")[1])
    assert sum(restages) > fold_major
    for blk, staged in enumerate(restages):
        items = idx[blk * per:(blk + 1) * per]
        changes = sum(1 for k in range(STAGES, len(items))
                      if items[k] != items[k - STAGES])
        assert staged == min(STAGES, len(items)) + changes
