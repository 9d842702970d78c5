"""A read-only OCDBT key-value store over a directory, in plain Python.

OCDBT ("optionally cooperative distributed B+tree") is tensorstore's
key-value format, and the one Orbax writes a checkpoint's arrays into by
default.  The port reads it without tensorstore: the card's machine has
none.  This module follows tensorstore's storage format:

- Every manifest and B+tree node starts with a header: the magic
  (``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a node, big-endian),
  the encoded length (uint64, little-endian), the format version (varint,
  0) and the compression of the rest (varint: 0 none, 1 zstd, decoded by
  ``utils/zstd.py``), and ends with the CRC-32C of everything before it,
  checked on every read.
- The manifest ``manifest.ocdbt`` holds the config (uuid, manifest kind,
  the inline and node size limits, the version tree's arity, the
  compression) and, for the "single" kind, the version tree: the newest
  versions inline (generation, root height, root location and
  statistics, commit time) and references to version tree nodes of older
  ones.  The "numbered" kind keeps the config there and the versions in
  ``manifest.<generation as 16 hex digits>``; the largest one is read.
- A B+tree node is its height, a data-file table and its entries in
  columns: keys as a prefix length (shared with the previous key) and a
  suffix; a leaf then gives each value's length and kind (inline, or a
  reference into a data file) and the inline bytes; an interior node
  gives each child's common key prefix, location and statistics.  Keys
  below an interior entry are stored without that entry's common prefix.
- A data-file table lists paths as ``base path + relative path``, prefix
  compressed.  Paths resolve against the store root, after the base path
  of the file that holds the node: so a merged top-level manifest's
  references into ``ocdbt.process_0/d/...`` resolve, and nothing is ever
  found by searching the directory.

Only the newest generation is read; older versions are skipped.
"""

from __future__ import annotations

import re
from pathlib import Path

from eegnetreplication_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # the offset and length of an empty tree's root
_NUMBERED = re.compile(r"manifest\.([0-9a-f]{16})")


class OcdbtError(ValueError):
    """A file that is not OCDBT this reader can take."""


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum ending every manifest and node."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Forward reads over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def fail(self, msg: str) -> OcdbtError:
        return OcdbtError(f"{self.what}: {msg} (at byte {self.pos})")

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise self.fail("truncated")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise self.fail(f"truncated ({n} bytes asked)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.raw(n), "little")

    def done(self) -> None:
        if self.pos != len(self.data):
            raise self.fail(f"{len(self.data) - self.pos} bytes left over")


def _decode(data: bytes, magic: int, what: str) -> _Reader:
    """Check an encoded manifest or node and return a reader over its
    decoded body."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: {len(data)} bytes is too short")
    got = int.from_bytes(data[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{what}: header says {length} bytes, read "
                         f"{len(data)}")
    want = int.from_bytes(data[-4:], "little")
    crc = crc32c(data[:-4])
    if crc != want:
        raise OcdbtError(f"{what}: CRC-32C {crc:#010x} does not match the "
                         f"stored {want:#010x}")
    head = _Reader(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (only 0 is "
                         "known)")
    method = head.varint()
    body = head.data[head.pos:]
    if method == 1:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as exc:
            raise OcdbtError(f"{what}: {exc}") from exc
    elif method != 0:
        raise OcdbtError(f"{what}: compression format {method} (0 none, 1 "
                         "zstd)")
    return _Reader(body, what)


def _data_file_table(r: _Reader, transitive: str) -> list[tuple[str, str]]:
    """``(base path, relative path)`` of each data file a node or manifest
    names, the base path prefixed with that of the file holding it."""
    n = r.varint()
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files = []
    prev = b""
    for i in range(n):
        shared = prefix[i - 1] if i else 0
        if shared > len(prev):
            raise r.fail(f"data file {i} shares {shared} bytes of a "
                         f"{len(prev)}-byte path")
        path = prev[:shared] + r.raw(suffix[i])
        if base_len[i] > len(path):
            raise r.fail(f"data file {i}: base path longer than its path")
        prev = path
        text = path.decode()
        if text.startswith("/") or ".." in text.split("/"):
            raise r.fail(f"data file path {text!r} leaves the store")
        files.append((transitive + text[:base_len[i]], text[base_len[i]:]))
    return files


def _keys(r: _Reader, n: int, extra: bool) -> tuple[list[bytes], list[int]]:
    """A node's keys (prefix lengths, suffix lengths, for an interior node
    the subtree common prefix lengths, then the suffixes)."""
    prefix = r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if extra else []
    keys = []
    prev = b""
    for i in range(n):
        shared = prefix[i - 1] if i else 0
        if shared > len(prev):
            raise r.fail(f"key {i} shares {shared} bytes of a "
                         f"{len(prev)}-byte key")
        prev = prev[:shared] + r.raw(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The newest generation of an OCDBT store at a directory, read-only.

    The whole tree is read on construction (a checkpoint's is small):
    :meth:`list` and :meth:`read` then serve from memory and the data
    files.
    """

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self._values: dict[bytes, object] = {}
        manifest = self.root / "manifest.ocdbt"
        if not manifest.is_file():
            raise FileNotFoundError(f"{self.root}: no manifest.ocdbt")
        r = _decode(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest))
        kind = self._config(r)
        if kind == 1:
            r.done()
            numbered = sorted(
                (int(m.group(1), 16), p) for p in self.root.iterdir()
                if (m := _NUMBERED.fullmatch(p.name)))
            if not numbered:
                raise OcdbtError(f"{manifest}: numbered manifest kind, but "
                                 f"no manifest.<generation> in {self.root}")
            manifest = numbered[-1][1]
            r = _decode(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest))
            self._config(r)
        elif kind != 0:
            raise r.fail(f"manifest kind {kind} (0 single, 1 numbered)")
        root = self._versions(r)
        r.done()
        # The root's height (0: one leaf), None for an empty tree.
        self.height = None if root is None else root[0]
        if root is not None:
            self._walk(*root, prefix=b"")

    @staticmethod
    def _config(r: _Reader) -> int:
        r.raw(16)  # uuid
        kind = r.varint()
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.byte()  # version tree arity (log2)
        method = r.varint()
        if method == 1:
            r.uint(4)  # zstd level
        elif method != 0:
            raise r.fail(f"compression method {method} (0 none, 1 zstd)")
        return kind

    def _versions(self, r: _Reader):
        """The newest version's root as ``(height, location)``, or None for
        an empty tree; every column is read so that the body is checked to
        its end."""
        files = _data_file_table(r, "")
        n = r.varint()
        if n == 0:
            raise r.fail("no version in the manifest")
        r.varints(n)  # generation numbers
        heights = [r.byte() for _ in range(n)]
        file_ids = r.varints(n)
        offsets = r.varints(n)
        lengths = r.varints(n)
        for _ in range(3):  # keys, tree bytes, indirect value bytes
            r.varints(n)
        r.raw(8 * n)  # commit times
        m = r.varint()  # version tree nodes of older generations
        r.varints(m)  # generation numbers
        for _ in range(4):  # file ids, offsets, lengths, generations
            r.varints(m)
        r.raw(8 * m)  # commit times
        r.raw(m)  # heights
        if offsets[-1] == _NO_ROOT:
            return None
        return heights[-1], self._location(r, files, file_ids[-1],
                                           offsets[-1], lengths[-1])

    @staticmethod
    def _location(r: _Reader, files, file_id: int, offset: int,
                  length: int) -> tuple[str, str, int, int]:
        if file_id >= len(files):
            raise r.fail(f"data file {file_id} of a {len(files)}-file table")
        base, rel = files[file_id]
        return base, rel, offset, length

    def _read_range(self, base: str, rel: str, offset: int,
                    length: int) -> bytes:
        path = self.root / (base + rel)
        with open(path, "rb") as fh:
            fh.seek(offset)
            data = fh.read(length)
        if len(data) != length:
            raise OcdbtError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(data)} there")
        return data

    def _walk(self, height: int, loc: tuple, prefix: bytes) -> None:
        base, rel, offset, length = loc
        what = f"{self.root / (base + rel)}@{offset}"
        r = _decode(self._read_range(base, rel, offset, length), NODE_MAGIC,
                    what)
        got = r.byte()
        if got != height:
            raise r.fail(f"node height {got}, its parent says {height}")
        files = _data_file_table(r, base)
        n = r.varint()
        keys, common = _keys(r, n, extra=height > 0)
        if height > 0:
            file_ids, offsets, lengths = (r.varints(n) for _ in range(3))
            for _ in range(3):  # keys, tree bytes, indirect value bytes
                r.varints(n)
            r.done()
            for i, key in enumerate(keys):
                if common[i] > len(key):
                    raise r.fail(f"entry {i}: common prefix longer than its "
                                 "key")
                self._walk(height - 1, self._location(
                    r, files, file_ids[i], offsets[i], lengths[i]),
                    prefix + key[:common[i]])
            return
        lengths = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise r.fail(f"value kind {max(kinds)} (0 inline, 1 indirect)")
        n_ind = sum(kinds)
        file_ids = r.varints(n_ind)
        offsets = r.varints(n_ind)
        j = 0
        for i, key in enumerate(keys):
            if kinds[i]:
                self._values[prefix + key] = self._location(
                    r, files, file_ids[j], offsets[j], lengths[i])
                j += 1
            else:
                self._values[prefix + key] = r.raw(lengths[i])
        r.done()

    def list(self, prefix: str = "") -> list[str]:
        """The keys that start with ``prefix``, sorted."""
        p = prefix.encode()
        return sorted(k.decode() for k in self._values if k.startswith(p))

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` when it is absent."""
        value = self._values[key.encode()]
        if isinstance(value, bytes):
            return value
        return self._read_range(*value)
