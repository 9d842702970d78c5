"""The port's EMS carry (K2s's plain version) and ``StreamingEMS`` against
the JAX package's carrier, on the CPU.

- ``StreamingEMS`` gives the JAX carrier's samples on the same stream and
  chunkings, within 1e-4 (the EMS tolerance the port is held to: the two
  seed statistics reduce in different orders): before the seed block
  fills, at the seeding push, after it, at ``flush`` of a short stream; it
  raises the JAX carrier's errors on bad input.
- Any chunking, sizes of 1 and primes included, gives the port's one-shot
  ``method="scan"`` bit for bit, final carry included.
- ``state_arrays`` has the JAX keys and dtypes; a JAX state continues in
  the port, and a port state in JAX, within 1e-4.
- A numpy float32 emulation of K2s's step (each operation rounded on its
  own, as ``csrc/ems_stream.cu`` writes it with ``__f*_rn``) equals
  ``ems_stream_reference`` bit for bit, and the wrapper's checks and CPU
  dispatch.
"""

import numpy as np
import pytest
import torch
import torch_port_cases  # noqa: F401 (caps torch's threads)

from eegnetreplication_tpu.ops import ems as jax_ems
from eegnetreplication_tpu_torch.ops import ems_kernel
from eegnetreplication_tpu_torch.ops.ems import (
    StreamingEMS,
    exponential_moving_standardize,
    scan_with_carry,
)

C, N, BLOCK = 4, 700, 50
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def recording():
    rng = np.random.RandomState(17)
    return (rng.randn(C, N) * 5.0 + 9.0).astype(np.float32)


def _port_stream(x, sizes, block=BLOCK):
    ems = StreamingEMS(x.shape[0], init_block_size=block, device="cpu")
    outs, pos, i = [], 0, 0
    while pos < x.shape[1]:
        n = sizes[i % len(sizes)]
        i += 1
        outs.append(ems.push(x[:, pos:pos + n]))
        pos += n
    return outs, ems


def _one_shot(x, block=BLOCK):
    out, m, v = scan_with_carry(torch.from_numpy(x), init_block_size=block)
    return out.numpy(), m.numpy(), v.numpy()


# --- against the JAX carrier -------------------------------------------------

@pytest.mark.parametrize("sizes", [[25], [64, 7], [N]])
def test_pushes_equal_the_jax_carrier(recording, sizes):
    jems = jax_ems.StreamingEMS(C, init_block_size=BLOCK)
    outs, pems = _port_stream(recording, sizes)
    pos = 0
    for i, got in enumerate(outs):
        n = sizes[i % len(sizes)]
        want = jems.push(recording[:, pos:pos + n])
        pos += n
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert pems.seeded and jems.seeded
    assert pems.n_emitted == jems.n_emitted == N


def test_before_at_and_after_the_seeding_push(recording):
    jems = jax_ems.StreamingEMS(C, init_block_size=BLOCK)
    pems = StreamingEMS(C, init_block_size=BLOCK, device="cpu")
    for lo, hi, emitted in ((0, 30, 0), (30, 49, 0), (49, 60, 60),
                            (60, 61, 1), (61, 61, 0), (61, 200, 139)):
        got = pems.push(recording[:, lo:hi])
        want = jems.push(recording[:, lo:hi])
        assert got.shape == want.shape == (C, emitted)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert (pems.seeded, pems.n_seen, pems.n_emitted) == \
            (jems.seeded, jems.n_seen, jems.n_emitted)


def test_flush_of_a_short_stream_equals_jax(recording):
    short = recording[:, :37]
    jems = jax_ems.StreamingEMS(C, init_block_size=BLOCK)
    pems = StreamingEMS(C, init_block_size=BLOCK, device="cpu")
    assert pems.push(short).shape == jems.push(short).shape == (C, 0)
    got, want = pems.flush(), jems.flush()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got, _one_shot(short)[0])
    assert pems.flush().shape == jems.flush().shape == (C, 0)
    fresh = StreamingEMS(C, device="cpu")
    assert fresh.flush().shape == (C, 0) and not fresh.seeded


@pytest.mark.parametrize("make", [
    lambda cls: cls(C).push(np.zeros((C + 1, 10), np.float32)),
    lambda cls: cls(C).push(np.zeros(10, np.float32)),
    lambda cls: cls(0),
    lambda cls: cls(C, init_block_size=0),
], ids=["channels", "one-d", "no-channels", "no-block"])
def test_bad_inputs_raise_like_jax(make):
    with pytest.raises(ValueError) as want:
        make(jax_ems.StreamingEMS)
    with pytest.raises(ValueError) as got:
        make(lambda *a, **k: StreamingEMS(*a, device="cpu", **k))
    assert str(got.value) == str(want.value)


# --- chunk invariance --------------------------------------------------------

@pytest.mark.parametrize("sizes", [[1], [2], [3, 5, 7, 11, 13], [97],
                                   [1, 50, 2, 251], [N]])
def test_any_chunking_equals_the_one_shot_scan_bitwise(recording, sizes):
    outs, ems = _port_stream(recording, sizes)
    out, m, v = _one_shot(recording)
    np.testing.assert_array_equal(np.concatenate(outs, axis=1), out)
    state = ems.state_arrays()
    np.testing.assert_array_equal(state["m"], m)
    np.testing.assert_array_equal(state["v"], v)


def test_scan_method_is_the_carry_from_a_fresh_start(recording):
    x = torch.from_numpy(recording)
    one = exponential_moving_standardize(x, init_block_size=BLOCK,
                                         method="scan")
    mean0, var0 = ems_kernel.seed_stats(x, BLOCK)
    m, v = torch.zeros_like(mean0), var0.clone()
    np.testing.assert_array_equal(
        ems_kernel.ems_stream(x, mean0, m, v).numpy(), one.numpy())
    want = jax_ems.raw_exponential_moving_standardize(
        recording, init_block_size=BLOCK, method="scan")
    np.testing.assert_allclose(one.numpy(), want, atol=ATOL, rtol=RTOL)
    # Leading axes fold into rows, and f64 stays f64 on the CPU.
    x3 = torch.from_numpy(recording.reshape(2, 2, N).astype(np.float64))
    got = exponential_moving_standardize(x3, init_block_size=BLOCK,
                                         method="scan")
    assert got.dtype == torch.float64 and got.shape == (2, 2, N)
    np.testing.assert_allclose(got.reshape(C, N).numpy(), one.numpy(),
                               atol=ATOL, rtol=RTOL)


# --- state round trips ------------------------------------------------------

@pytest.mark.parametrize("cut", [20, 300], ids=["before-seed", "seeded"])
def test_state_arrays_have_the_jax_keys_and_dtypes(recording, cut):
    jems = jax_ems.StreamingEMS(C, init_block_size=BLOCK)
    pems = StreamingEMS(C, init_block_size=BLOCK, device="cpu")
    jems.push(recording[:, :cut])
    pems.push(recording[:, :cut])
    got, want = pems.state_arrays(), jems.state_arrays()
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("cut", [20, 300], ids=["before-seed", "seeded"])
def test_a_jax_state_continues_in_the_port_and_back(recording, cut):
    jems = jax_ems.StreamingEMS(C, init_block_size=BLOCK)
    head = jems.push(recording[:, :cut])
    port = StreamingEMS.from_state(jems.state_arrays(), device="cpu")
    tail = port.push(recording[:, cut:])
    want = jax_ems.raw_exponential_moving_standardize(
        recording, init_block_size=BLOCK, method="scan")
    np.testing.assert_allclose(np.concatenate([head, tail], axis=1), want,
                               atol=ATOL, rtol=RTOL)

    pems = StreamingEMS(C, init_block_size=BLOCK, device="cpu")
    head = pems.push(recording[:, :cut])
    back = jax_ems.StreamingEMS.from_state(pems.state_arrays())
    tail = back.push(recording[:, cut:])
    np.testing.assert_allclose(np.concatenate([head, tail], axis=1), want,
                               atol=ATOL, rtol=RTOL)


def test_a_port_state_continues_in_the_port_bitwise(recording):
    pems = StreamingEMS(C, init_block_size=BLOCK, device="cpu")
    head = pems.push(recording[:, :333])
    clone = StreamingEMS.from_state(pems.state_arrays(), device="cpu")
    tail = clone.push(recording[:, 333:])
    np.testing.assert_array_equal(np.concatenate([head, tail], axis=1),
                                  _one_shot(recording)[0])


# --- K2s's rounding and the wrapper ------------------------------------------

def _numpy_k2s(x, mean0, m, v, factor_new=1e-3, eps=1e-10):
    """K2s's step in numpy float32, one rounding per operation, in the
    order ``csrc/ems_stream.cu::step`` applies them."""
    f = np.float32
    a, c, eps = f(factor_new), f(1.0 - factor_new), f(eps)
    out = np.empty_like(x)
    m, v = m.copy(), v.copy()
    for t in range(x.shape[1]):
        z = x[:, t] - mean0
        m = c * m + a * z
        d = z - m
        v = c * v + a * (d * d)
        out[:, t] = d / np.sqrt(v + eps)
    return out, m, v


@pytest.mark.parametrize("factor_new, n", [(1e-3, 700), (0.1, 64),
                                           (0.5, 33)])
def test_numpy_k2s_rounding_equals_the_plain_version(recording, factor_new,
                                                     n):
    x = recording[:, :n]
    rng = np.random.RandomState(5)
    mean0 = rng.randn(C).astype(np.float32)
    m0 = rng.randn(C).astype(np.float32)
    v0 = (rng.rand(C) + 0.5).astype(np.float32)
    want, wm, wv = _numpy_k2s(x, mean0, m0, v0, factor_new)
    m, v = torch.from_numpy(m0.copy()), torch.from_numpy(v0.copy())
    got = ems_kernel.ems_stream_reference(
        torch.from_numpy(x), torch.from_numpy(mean0), m, v, factor_new)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(m.numpy(), wm)
    np.testing.assert_array_equal(v.numpy(), wv)


def test_wrapper_dispatches_the_cpu_to_the_plain_version(recording):
    before = ems_kernel.ems_stream.launches
    x = torch.from_numpy(recording[:, :40])
    mean0, var0 = ems_kernel.seed_stats(x, BLOCK)
    m, v = torch.zeros_like(mean0), var0.clone()
    out = ems_kernel.ems_stream(x, mean0, m, v)
    assert out.shape == x.shape and ems_kernel.ems_stream.launches == before
    empty = ems_kernel.ems_stream(x[:, :0], mean0, m, v)
    assert empty.shape == (C, 0)


@pytest.mark.parametrize("bad, match", [
    (lambda x, mu, m, v: (x[0], mu, m, v), "x must be"),
    (lambda x, mu, m, v: (x, mu[:-1], m, v), "mean0 must be"),
    (lambda x, mu, m, v: (x, mu, m[:, None], v), "m must be"),
    (lambda x, mu, m, v: (x, mu, m, v.to("meta")), "v is on"),
    (lambda x, mu, m, v: tuple(t.to("meta") for t in (x, mu, m, v)),
     "no kernel"),
], ids=["x-rank", "mean0-shape", "m-shape", "device-mix", "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    x = torch.zeros(C, 8)
    args = bad(x, torch.zeros(C), torch.zeros(C), torch.ones(C))
    with pytest.raises(ValueError, match=match):
        ems_kernel.ems_stream(*args)


def test_kernel_source_states_the_wrapper_constants():
    src = (ems_kernel.build.CSRC_DIR / "ems_stream.cu").read_text()
    assert (f"constexpr int kChannels = {ems_kernel.EMS_STREAM_CHANNELS};"
            in src)
    assert "ems_stream" in ems_kernel.build.SOURCES
    # Every operation of the step rounded on its own: no fused
    # multiply-add, no plain operators, no fast approximations.
    code = src.split("namespace {", 1)[1].split("}  // namespace", 1)[0]
    step = code.split("float step(", 1)[1].split("\n}\n", 1)[0]
    body = step.split("{", 1)[1]
    for op in ("__fmul_rn", "__fadd_rn", "__fsub_rn"):
        assert op in body
    assert not any(tok in body for tok in ("*", " + ", " - ", "/"))
    assert "__fsub_rn(reg[k], mu[e / kTile])" in code             # z
    assert ("__fdiv_rn(dev[r][j], __fsqrt_rn(__fadd_rn(var[r][j], eps)))"
            in code)                                               # out
    assert "fmaf" not in code and "__f" + "mul_rz" not in code
