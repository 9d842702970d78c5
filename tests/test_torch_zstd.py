"""The port's zstd decoder and encoder (``utils/zstd.py``) against
tensorstore's and libzstd's own frames.

- Frames tensorstore writes as zarr chunks (``"compressor": {"id":
  "zstd", "level": L}``) at levels 1, 3, 9 and 19, over arrays whose bytes
  are uniform random (raw literals), random floats (Huffman-coded
  literals), constant (RLE), a ramp (long matches and repeat offsets) and
  over 128 KiB (several blocks), decode byte-equal.
- Frames of the ``zstandard`` binding (libzstd) cover what tensorstore
  does not write: content checksums (verified, and a wrong one raises),
  several frames and skippable frames in one buffer, negative levels and
  text.  A frame that needs a dictionary, a corrupt frame and a truncated
  one raise :class:`ZstdError` naming what was found.
- The encoder's frames (Raw blocks, with their content size) decode with
  the port's decoder, with libzstd, and as zarr chunks through
  tensorstore.
"""

import json

import numpy as np
import pytest
import tensorstore as ts
import torch_port_cases  # noqa: F401 — one torch thread per worker
import zstandard

from eegnetreplication_tpu_torch.utils import zstd

LEVELS = (1, 3, 9, 19)


def _array(kind: str) -> np.ndarray:
    rng = np.random.RandomState(7)
    if kind == "bytes":
        return rng.randint(0, 256, (64, 100)).astype(np.uint8)
    if kind == "random":
        return rng.randn(64, 100).astype(np.float32)
    if kind == "constant":
        return np.full((64, 100), 0.5, np.float32)
    if kind == "ramp":
        return np.arange(64 * 100, dtype=np.int32).reshape(64, 100)
    # over 128 KiB in one chunk: several blocks
    return rng.randn(200, 256).astype(np.float32)


def _tensorstore_chunk(tmp_path, arr: np.ndarray, level: int) -> bytes:
    """The chunk file tensorstore writes for ``arr`` as one zarr v2 chunk
    compressed with zstd at ``level``."""
    store = ts.open({
        "driver": "zarr", "kvstore": f"file://{tmp_path}/a",
        "metadata": {"compressor": {"id": "zstd", "level": level},
                     "shape": list(arr.shape), "chunks": list(arr.shape),
                     "dtype": arr.dtype.str}},
        create=True).result()
    store.write(arr).result()
    return (tmp_path / "a" / "0.0").read_bytes()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", ["bytes", "random", "constant", "ramp",
                                  "large"])
def test_tensorstore_frames_decode_byte_equal(tmp_path, kind, level):
    arr = _array(kind)
    frame = _tensorstore_chunk(tmp_path, arr, level)
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    assert zstd.decompress(frame) == arr.tobytes()


def test_the_cases_reach_compressed_blocks(tmp_path):
    # Level 1 over random floats Huffman-codes the literals and the ramp
    # is mostly matches: neither frame is stored raw.
    for kind in ("random", "ramp", "large"):
        arr = _array(kind)
        assert len(_tensorstore_chunk(tmp_path / kind, arr, 1)) \
            < arr.nbytes, kind


TEXT = b"the quick brown fox jumps over the lazy dog; " * 3000


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
@pytest.mark.parametrize("size", [0, 1, 31, 32, 33, 100, 5000, 300_000])
def test_libzstd_frames_with_checksums_decode(level, size):
    rng = np.random.RandomState(size)
    data = (rng.bytes(size // 2) + TEXT)[:size]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    assert zstd.decompress(frame) == data
    if size:
        want = zstandard.ZstdDecompressor().decompress(frame)
        assert want == data


def test_xxh64_matches_the_frames_checksums():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for n in (1, 7, 8, 31, 32, 33, 64, 1000):
        data = bytes(range(256)) * 4
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(
            data[:n])
        assert zstd.xxh64(data[:n]) & 0xFFFFFFFF == int.from_bytes(
            frame[-4:], "little")


def test_several_and_skippable_frames_concatenate():
    c = zstandard.ZstdCompressor(level=3)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"12345"
    buf = c.compress(b"abc" * 100) + skippable + c.compress(TEXT)
    assert zstd.decompress(buf) == b"abc" * 100 + TEXT


def test_a_bad_checksum_raises():
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True)
                      .compress(TEXT))
    frame[-1] ^= 0xFF
    with pytest.raises(zstd.ZstdError, match="checksum mismatch"):
        zstd.decompress(bytes(frame))


def test_a_dictionary_raises():
    samples = [TEXT[i:i + 400] + bytes([i % 256]) * 20
               for i in range(0, 40000, 97)]
    d = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(TEXT[:2000])
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(frame)


def _header_size(frame) -> int:
    """Magic, descriptor, window descriptor and content size."""
    fhd = frame[4]
    single = fhd & 0x20
    return 5 + (0 if single else 1) + {0: 1 if single else 0, 1: 2, 2: 4,
                                       3: 8}[fhd >> 6]


# Skewed bytes with no repeats to match: Huffman-coded literals.
SKEWED = bytes(np.random.RandomState(0).geometric(0.3, 5000)
               .clip(0, 255).astype(np.uint8))


@pytest.mark.parametrize("damage, match", [
    ("magic", "not a zstd frame"),
    ("reserved_bit", "reserved bit"),
    ("block_type", "reserved block type"),
    ("truncated", "truncated|past|ends"),
    ("huffman_tree", "Huffman"),
    ("trailing", "trailing bytes"),
])
def test_a_corrupt_frame_raises_and_names_it(damage, match):
    data = SKEWED if damage == "huffman_tree" else TEXT
    frame = bytearray(zstandard.ZstdCompressor(level=1).compress(data))
    hdr = _header_size(frame)
    if damage == "magic":
        frame[0] ^= 1
    elif damage == "reserved_bit":
        frame[4] |= 0x08
    elif damage == "block_type":
        frame[hdr] |= 0x06
    elif damage == "truncated":
        frame = frame[:len(frame) // 2]
    elif damage == "huffman_tree":
        assert (frame[hdr] >> 1) & 3 == 2  # a compressed block
        body = hdr + 3
        assert frame[body] & 3 == 2  # Huffman-coded literals
        size_format = (frame[body] >> 2) & 3
        tree = body + (3 if size_format < 2 else 4 + (size_format == 3))
        # 128 weights given as nibbles, all 15: more than 11 bits
        frame[tree] = 127 + 128
        frame[tree + 1:tree + 65] = b"\xff" * 64
    else:
        frame += b"\x00\x01"
    with pytest.raises(zstd.ZstdError, match=match):
        zstd.decompress(bytes(frame))


def test_empty_input_raises():
    with pytest.raises(zstd.ZstdError, match="empty"):
        zstd.decompress(b"")


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 131_072, 300_001])
def test_encoder_frames_decode_everywhere(size):
    data = np.random.RandomState(size).bytes(size)
    frame = zstd.compress(data)
    assert zstd.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=max(size, 1)) == data
    assert len(frame) <= size + 12 + 3 * (size // zstd.MAX_BLOCK + 1)


def test_encoder_chunks_read_back_through_tensorstore(tmp_path):
    arr = np.random.RandomState(3).randn(300, 130).astype(np.float32)
    root = tmp_path / "z"
    root.mkdir()
    (root / ".zarray").write_text(json.dumps({
        "chunks": [300, 130], "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": "<f4", "fill_value": None,
        "filters": None, "order": "C", "shape": [300, 130],
        "zarr_format": 2}))
    (root / "0.0").write_bytes(zstd.compress(arr.tobytes()))
    got = ts.open({"driver": "zarr", "kvstore": f"file://{root}"}
                  ).result().read().result()
    np.testing.assert_array_equal(got, arr)
