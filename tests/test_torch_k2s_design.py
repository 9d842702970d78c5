"""K2s's partition (``csrc/ems_stream.cu``) emulated on the CPU.

K2s runs only on a card (``test_torch_gpu.py``).  Here a numpy float32
emulation of its design, one operation rounded at a time, with the tile,
ring and channel counts read from the source's ``constexpr``s, is held
against the port's plain version and the JAX package's carry:

- blocks of ``kChannels`` channels; tiles of ``kTile`` samples; the
  producer's copies into a staging slot (16-byte chunks from the aligned
  address at or below each chunk, 4-byte copies at the ragged ends, the
  row landing shifted by its misalignment) and its z = x - mean0 and a * z
  into ring slot ``i % kRing``; the m warp's chain m = c m + a z; the
  square warp's d = z - m and a d d; the v warp's chain v = c v + a d d;
  the output warp's division by the correctly rounded square root; and a
  push of at most ``kPush`` samples, the whole step on one warp;
- any chunking (1, 25, 997, ragged) of a stream, and any misalignment of
  x's rows, gives ``ems_stream_reference``'s bits, final carry included,
  and is within the EMS tolerance (1e-4) of the JAX ``_stream_chunk``;
- the ring's hand-offs (the mbarrier parities of the source, replayed
  under random interleavings of the five warp roles) never deadlock, and
  no slot is overwritten before its last reader is done with it; the two
  chain warps each have a scheduler of the SM to themselves.

numpy's float32 ``sqrt`` and division round correctly (as K2s's
``__fsqrt_rn``/``__fdiv_rn`` do); PyTorch's vectorized f32 ``sqrt`` on the
CPU does not, which is why the plain version roots in float64.
"""

import functools
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.ops import ems as jax_ems
from eegnetreplication_tpu_torch.ops import ems_kernel

SOURCE = Path(ems_kernel.__file__).resolve().parent / "csrc" / "ems_stream.cu"
F32 = np.float32
TOL = 1e-4          # the EMS tolerance test_torch_ems_stream.py uses


def _constexprs() -> dict:
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", SOURCE.read_text())}


K = _constexprs()
CHANNELS, TILE, RING, AHEAD = (K["kChannels"], K["kTile"], K["kRing"],
                               K["kAhead"])
GROUP, PUSH = K["kGroup"], K["kPush"]
PITCH = TILE + 4
CHUNKS = PITCH // 4


def test_constants_are_the_wrappers_and_leave_the_ring_slack():
    assert CHANNELS == ems_kernel.EMS_STREAM_CHANNELS
    assert 1 <= CHANNELS <= 32
    assert 2 <= AHEAD <= RING - 2
    assert TILE % GROUP == 0 and GROUP % 4 == 0
    assert PUSH <= TILE
    assert "kPitch = kTile + 4" in SOURCE.read_text()


def test_each_chain_warp_has_a_scheduler_of_its_own():
    """Warp w issues on the SM's scheduler w % 4: the m and v warps share
    theirs with no other role."""
    roles = {k: K[k] for k in ("kWarpM", "kWarpV", "kWarpProducer",
                               "kWarpOut", "kWarpSquare")}
    assert max(roles.values()) < K["kThreads"] // 32
    assert len(set(roles.values())) == len(roles)
    for chain in ("kWarpM", "kWarpV"):
        others = [w % 4 for k, w in roles.items() if k != chain]
        assert roles[chain] % 4 not in others


@functools.lru_cache(maxsize=None)
def _copy_plan(shift: int, length: int):
    """The producer's copies of a row's tile of ``length`` samples whose
    first sample sits ``shift`` floats past a 16-byte boundary: (staged
    column, tile sample) pairs and the count of 16-byte copies.  Asserts
    that every sample is copied exactly once, 16-byte copies only from an
    aligned address and only inside the row."""
    cols, samples, wide = [], [], 0
    for k in range(CHUNKS):
        j0 = 4 * k - shift
        if 0 <= j0 and j0 + 4 <= length:
            assert (shift + j0) % 4 == 0        # the source is aligned
            wide += 1
            cols += [4 * k + e for e in range(4)]
            samples += [j0 + e for e in range(4)]
        else:
            for e in range(4):
                if 0 <= j0 + e < length:
                    cols.append(4 * k + e)
                    samples.append(j0 + e)
    assert sorted(samples) == list(range(length))
    assert max(cols) < PITCH
    return np.array(cols), np.array(samples), wide


def emulate_k2s(x, mean0, m, v, factor_new=1e-3, eps=1e-10, base=0):
    """K2s over ``x (C, n)`` in numpy float32; ``m`` and ``v`` are updated
    in place.  ``base`` is x's address in floats modulo 4."""
    x = np.asarray(x, F32)
    n_ch, n = x.shape
    a, c = (F32(t) for t in ems_kernel.f32_coefficients(factor_new))
    eps = F32(eps)
    out = np.empty_like(x)
    if n <= PUSH:
        # A push: one warp stages z and runs the whole step a sample at a
        # time, each lane a channel.
        z = x - mean0[:, None]
        cm, cv = m.copy(), v.copy()
        d = np.empty_like(z)
        var = np.empty_like(z)
        for j in range(n):
            cm = c * cm + a * z[:, j]
            d[:, j] = z[:, j] - cm
            cv = c * cv + a * (d[:, j] * d[:, j])
            var[:, j] = cv
        m[:], v[:] = cm, cv
        return d / np.sqrt(var + eps)
    n_tiles = -(-n // TILE)
    for blk in range(-(-n_ch // CHANNELS)):
        ch0 = blk * CHANNELS
        rows = min(CHANNELS, n_ch - ch0)
        staged = np.full((AHEAD, CHANNELS, PITCH), np.nan, F32)
        zs, ps, ms, vs = (np.full((RING, CHANNELS, PITCH), np.nan, F32)
                          for _ in range(4))
        mu = mean0[ch0:ch0 + rows]
        cm, cv = m[ch0:ch0 + rows].copy(), v[ch0:ch0 + rows].copy()
        for i in range(n_tiles):
            t0 = i * TILE
            length = min(TILE, n - t0)
            s = i % RING
            # Producer: the tile's copies, then z and a * z into slot s.
            for r in range(rows):
                shift = (base + (ch0 + r) * n + t0) % 4
                cols, samples, _ = _copy_plan(shift, length)
                staged[i % AHEAD, r, cols] = x[ch0 + r, t0 + samples]
                zs[s, r, :length] = (
                    staged[i % AHEAD, r, shift:shift + length] - mu[r])
                ps[s, r, :length] = a * zs[s, r, :length]
            # The m warp: one lane a row, one step a sample.
            for j in range(length):
                cm = c * cm + ps[s, :rows, j]
                ms[s, :rows, j] = cm
            # The square warp: d = z - m over m, a * d * d over a * z.
            ms[s, :rows, :length] = zs[s, :rows, :length] - ms[s, :rows,
                                                              :length]
            dd = ms[s, :rows, :length]
            ps[s, :rows, :length] = a * (dd * dd)
            # The v warp.
            for j in range(length):
                cv = c * cv + ps[s, :rows, j]
                vs[s, :rows, j] = cv
            # The output warp.
            out[ch0:ch0 + rows, t0:t0 + length] = (
                ms[s, :rows, :length]
                / np.sqrt(vs[s, :rows, :length] + eps))
        m[ch0:ch0 + rows] = cm
        v[ch0:ch0 + rows] = cv
    return out


def _recording(c=3, n=2000, seed=23):
    rng = np.random.RandomState(seed)
    return (rng.randn(c, n) * 5.0 + 9.0).astype(F32)


def _seed(x, block=1000):
    mean0, var0 = ems_kernel.seed_stats(torch.from_numpy(x), block)
    return mean0.numpy(), var0.numpy()


def _sizes(chunking, n):
    if chunking == "ragged":
        cycle = [1, TILE - 1, 7, TILE, TILE + 3, 2 * TILE + 1, 64]
    else:
        cycle = [chunking]
    sizes, total, i = [], 0, 0
    while total < n:
        sizes.append(min(cycle[i % len(cycle)], n - total))
        total += sizes[-1]
        i += 1
    return sizes


def _stream(fn, x, mean0, var0, sizes):
    m, v = np.zeros_like(mean0), var0.copy()
    outs, pos = [], 0
    for s in sizes:
        outs.append(fn(x[:, pos:pos + s], m, v))
        pos += s
    return np.concatenate(outs, axis=1), m, v


def _plain(mean0):
    """``ems_stream_reference`` as a chunk function; it updates the numpy
    carry through the tensors that share its memory."""
    def chunk_fn(chunk, m, v):
        return ems_kernel.ems_stream_reference(
            torch.from_numpy(np.ascontiguousarray(chunk)),
            torch.from_numpy(mean0), torch.from_numpy(m),
            torch.from_numpy(v)).numpy()
    return chunk_fn


CHUNKINGS = [1, 25, 997, "ragged"]


@pytest.mark.parametrize("chunking", CHUNKINGS)
@pytest.mark.parametrize("base", [0, 1, 3])
def test_emulation_equals_the_plain_version_bitwise(chunking, base):
    x = _recording()
    mean0, var0 = _seed(x)
    want, wm, wv = _stream(_plain(mean0), x, mean0, var0, [x.shape[1]])
    # Each chunk is its own tensor, so its rows start where the stream's
    # chunk boundary and `base` put them.
    got, gm, gv = _stream(
        lambda ch, m, v: emulate_k2s(ch, mean0, m, v, base=base),
        x, mean0, var0, _sizes(chunking, x.shape[1]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("chunking", CHUNKINGS)
def test_emulation_equals_the_plain_version_chunk_by_chunk(chunking):
    x = _recording(c=2, n=1200, seed=29)
    mean0, var0 = _seed(x)
    sizes = _sizes(chunking, x.shape[1])
    want = _stream(_plain(mean0), x, mean0, var0, sizes)
    got = _stream(lambda ch, m, v: emulate_k2s(ch, mean0, m, v), x, mean0,
                  var0, sizes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("chunking", [25, 997, "ragged"])
def test_emulation_is_within_tolerance_of_the_jax_stream_chunk(chunking):
    x = _recording(c=3, n=1500, seed=31)
    mean0, var0 = _seed(x)
    a, c = ems_kernel.f32_coefficients(1e-3)

    def jax_chunk(chunk, m, v):
        mm, vv, out = jax_ems._stream_chunk(m, v, mean0, F32(a), F32(c),
                                            F32(1e-10), chunk)
        m[:], v[:] = np.asarray(mm), np.asarray(vv)
        return np.asarray(out)

    sizes = _sizes(chunking, x.shape[1])
    want, wm, wv = _stream(jax_chunk, x, mean0, var0, sizes)
    got, gm, gv = _stream(lambda ch, m, v: emulate_k2s(ch, mean0, m, v), x,
                          mean0, var0, sizes)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gm, wm, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gv, wv, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shift", range(4))
@pytest.mark.parametrize("length", [1, 3, 4, 5, 25, TILE - 1, TILE])
def test_copy_plan_covers_a_tile_once_with_aligned_wide_copies(shift,
                                                               length):
    _, _, wide = _copy_plan(shift, length)
    # Every whole aligned chunk inside the row is one 16-byte copy.
    assert wide == max(0, (length - (-shift % 4)) // 4)


@pytest.mark.parametrize("n, tiles", [(1, 0), (25, 0), (PUSH, 0),
                                      (PUSH + 1, 1), (TILE, 1),
                                      (TILE + 1, 2)])
def test_a_push_skips_the_ring_and_longer_chunks_fill_it(n, tiles):
    assert (0 if n <= PUSH else -(-n // TILE)) == tiles


def test_blocks_cover_the_channels():
    for n_ch in (1, 22, 64):
        blocks = -(-n_ch // CHANNELS)
        rows = [min(CHANNELS, n_ch - b * CHANNELS) for b in range(blocks)]
        assert sum(rows) == n_ch and min(rows) >= 1


# --- the ring's hand-offs ---------------------------------------------------

class _Barrier:
    """An mbarrier of one arrival: ``done`` counts completed phases; a wait
    on parity p passes once the phase of parity p has completed, i.e. while
    the current phase's parity differs from p."""

    def __init__(self):
        self.done = 0

    def passes(self, parity):
        return self.done % 2 != parity


def _roles(n_tiles, bars, slots, staged, log):
    """The five warp roles of the kernel as generators: each yields the
    barrier and parity it waits on, or None after a step.  A slot's state
    names the last role that wrote it."""
    full, stepped, squared, ready, empty = bars

    def producer():
        for i in range(AHEAD - 1):
            if i < n_tiles:
                assert staged[i % AHEAD] is None
                staged[i % AHEAD] = i
            yield None
        for j in range(n_tiles):
            if j >= RING:
                yield (empty[j % RING], ((j // RING) - 1) & 1)
            assert slots[j % RING] is None, "ring slot overwritten"
            assert staged[j % AHEAD] == j, "tile not staged"
            slots[j % RING] = ("z", j)
            staged[j % AHEAD] = None
            full[j % RING].done += 1
            yield None
            # Tile j + AHEAD - 1 goes into the staging slot tile j left.
            if j + AHEAD - 1 < n_tiles:
                assert staged[(j + AHEAD - 1) % AHEAD] is None
                staged[(j + AHEAD - 1) % AHEAD] = j + AHEAD - 1

    def stage(wait, before, after, signal):
        def role():
            for i in range(n_tiles):
                yield (wait[i % RING], (i // RING) & 1)
                assert slots[i % RING] == (before, i), (before, i)
                slots[i % RING] = (after, i)
                if signal is None:
                    slots[i % RING] = None
                    empty[i % RING].done += 1
                    log.append(("out", i))
                else:
                    signal[i % RING].done += 1
                yield None
        return role()

    return [producer(), stage(full, "z", "m", stepped),
            stage(stepped, "m", "q", squared),
            stage(squared, "q", "v", ready), stage(ready, "v", "out", None)]


@pytest.mark.parametrize("n_tiles", [1, AHEAD, RING - 1, RING, RING + 1,
                                     3 * RING + 2])
@pytest.mark.parametrize("seed", range(4))
def test_ring_never_deadlocks_or_overwrites_a_slot(n_tiles, seed):
    rng = random.Random(seed)
    bars = [[_Barrier() for _ in range(RING)] for _ in range(5)]
    slots, staged, log = [None] * RING, [None] * AHEAD, []
    roles = _roles(n_tiles, bars, slots, staged, log)
    waiting = [next(r) for r in roles]
    live = set(range(len(roles)))
    while live:
        runnable = [k for k in live
                    if waiting[k] is None or waiting[k][0].passes(
                        waiting[k][1])]
        assert runnable, f"deadlock at {log[-3:]}"
        k = rng.choice(runnable)
        try:
            waiting[k] = next(roles[k])
        except StopIteration:
            live.discard(k)
    assert [i for kind, i in log if kind == "out"] == list(range(n_tiles))
    assert all(s is None for s in slots)
