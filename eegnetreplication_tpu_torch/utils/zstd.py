"""Zstandard frames (RFC 8878) in plain Python: a decoder and a minimal encoder.

Orbax checkpoints hold zstd in two places: the nodes and manifests of the
OCDBT key-value store (``training/ocdbt.py``) and the chunks of every zarr
array (``"compressor": {"id": "zstd"}``).  The card's machine has no zstd
module, so the port reads both through this decoder and nothing else.

:func:`decompress` takes one buffer of concatenated frames (skippable
frames are skipped) and implements the whole decoding side of the format:

- the frame header: window descriptor, single-segment flag, frame content
  size, dictionary ID (a nonzero one raises: no dictionary is supported);
- Raw, RLE and Compressed blocks, at most 128 KiB each;
- literals: raw, RLE, Huffman-coded with one or four streams (weights as
  nibbles or FSE-compressed) and treeless (the frame's previous table);
- sequences: FSE tables in predefined, RLE, compressed and repeat modes,
  the three repeat offsets, overlapping matches;
- the optional content checksum (:func:`xxh64`), verified when present.

Input the decoder cannot take raises :class:`ZstdError` naming what it
found.  :func:`compress` writes one frame of Raw blocks with its content
size: valid zstd that any reader takes, and no smaller than its input.
"""

from __future__ import annotations

MAGIC = 0xFD2FB528
MAX_BLOCK = 1 << 17  # 128 KiB: the largest block of any frame

_M64 = (1 << 64) - 1
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261

# Literal-length and match-length codes: baseline and extra bits (RFC 8878
# 3.1.1.3.2.1.1).
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]

# Predefined FSE distributions (RFC 8878 3.1.1.3.2.2).
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 5)

# (max symbol, max accuracy log) of each sequence field.
_LL_LIMITS = (35, 9)
_OF_LIMITS = (31, 8)
_ML_LIMITS = (52, 9)


class ZstdError(ValueError):
    """Input that is not a zstd frame this decoder can take."""


# --------------------------------------------------------------------------
# XXH64
# --------------------------------------------------------------------------

def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of ``data`` (the zstd content checksum's hash)."""
    data = bytes(data)
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        fb = int.from_bytes
        while i + 32 <= n:
            v1 = _round(v1, fb(data[i:i + 8], "little"))
            v2 = _round(v2, fb(data[i + 8:i + 16], "little"))
            v3 = _round(v3, fb(data[i + 16:i + 24], "little"))
            v4 = _round(v4, fb(data[i + 24:i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# --------------------------------------------------------------------------
# Bit streams
# --------------------------------------------------------------------------

class _BackBits:
    """A backward bit stream (``buf[start:end]``, read from its last bit
    towards its first, the way FSE and Huffman streams are written).  Bits
    read past the start are zeros; :attr:`pos` then goes negative."""

    __slots__ = ("buf", "start", "pos")

    def __init__(self, buf: bytes, start: int, end: int, what: str):
        if end <= start:
            raise ZstdError(f"{what}: empty bit stream")
        last = buf[end - 1]
        if last == 0:
            raise ZstdError(f"{what}: bit stream's last byte is 0 (no "
                            "end marker)")
        self.buf = buf
        self.start = start
        self.pos = (end - start - 1) * 8 + last.bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            lo = self.start + (p >> 3)
            return ((int.from_bytes(self.buf[lo:lo + 8], "little") >> (p & 7))
                    & ((1 << n) - 1))
        if p + n <= 0:
            return 0
        return ((int.from_bytes(self.buf[self.start:self.start + 8], "little")
                 << -p) & ((1 << n) - 1))


# --------------------------------------------------------------------------
# FSE
# --------------------------------------------------------------------------

def _read_ncount(buf: bytes, pos: int, max_symbol: int, max_log: int,
                 what: str) -> tuple[list[int], int, int]:
    """An FSE table description at ``buf[pos]``: ``(normalized counts,
    accuracy log, position after it)``."""
    chunk = bytes(buf[pos:pos + 512])
    v = int.from_bytes(chunk, "little")
    acc = (v & 15) + 5
    if acc > max_log:
        raise ZstdError(f"{what}: FSE accuracy log {acc} exceeds {max_log}")
    b = 4
    remaining = (1 << acc) + 1
    threshold = 1 << acc
    nbits = acc + 1
    norm: list[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                r = (v >> b) & 3
                b += 2
                norm.extend([0] * r)
                if r != 3:
                    break
        if len(norm) > max_symbol:
            raise ZstdError(f"{what}: FSE table names symbol {len(norm)} "
                            f"above {max_symbol}")
        mx = (2 * threshold - 1) - remaining
        low = (v >> b) & (threshold - 1)
        if low < mx:
            count = low
            b += nbits - 1
        else:
            count = (v >> b) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            b += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        prev0 = count == 0
        if remaining < 1:
            raise ZstdError(f"{what}: FSE probabilities exceed the table "
                            f"({1 << acc})")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if b > len(chunk) * 8:
        raise ZstdError(f"{what}: FSE table description is truncated")
    return norm, acc, pos + (b + 7) // 8


def _fse_table(norm: list[int], acc: int, what: str
               ) -> tuple[list[int], list[int], list[int]]:
    """The decoding table of a normalized distribution: per state, its
    symbol, the bits to read and the baseline of the next state."""
    size = 1 << acc
    if sum(-c if c < 0 else c for c in norm) != size:
        raise ZstdError(f"{what}: FSE probabilities do not sum to {size}")
    sym = [0] * size
    nxt = list(norm)
    high = size - 1
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError(f"{what}: FSE table spread does not close")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] = x + 1
        n = acc - (x.bit_length() - 1)
        nb[u] = n
        base[u] = (x << n) - size
    return sym, nb, base


# --------------------------------------------------------------------------
# Huffman
# --------------------------------------------------------------------------

def _huffman_weights_fse(buf: bytes, pos: int, end: int) -> list[int]:
    """Huffman weights compressed with FSE: two interleaved states over one
    backward stream."""
    what = "Huffman weights"
    norm, acc, p = _read_ncount(buf, pos, 255, 6, what)
    sym, nb, base = _fse_table(norm, acc, what)
    if p >= end:
        raise ZstdError(f"{what}: no bit stream after the FSE table")
    bits = _BackBits(buf, p, end, what)
    s1 = bits.read(acc)
    s2 = bits.read(acc)
    out: list[int] = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.pos < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ZstdError(f"{what}: more than 255 weights")
    return out


def _huffman_table(buf: bytes, pos: int) -> tuple[tuple, int]:
    """A Huffman tree description at ``buf[pos]``: ``((symbols, bits,
    table log), position after it)``; the table is indexed by the next
    ``table log`` bits of a stream."""
    header = buf[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        nbytes = (n + 1) // 2
        if pos + nbytes > len(buf):
            raise ZstdError("Huffman weights: truncated")
        weights = [(buf[pos + i // 2] >> 4) if i % 2 == 0
                   else (buf[pos + i // 2] & 15) for i in range(n)]
        pos += nbytes
    else:
        if pos + header > len(buf):
            raise ZstdError("Huffman weights: truncated")
        weights = _huffman_weights_fse(buf, pos, pos + header)
        pos += header
    if len(weights) > 255:
        raise ZstdError(f"Huffman weights: {len(weights)} symbols")
    if any(w > 11 for w in weights):
        raise ZstdError(f"Huffman weights: weight {max(weights)} above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights: all zero")
    log = total.bit_length()
    if log > 11:
        raise ZstdError(f"Huffman table log {log} above 11")
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise ZstdError(f"Huffman weights: the implied last weight is not a "
                        f"power of two ({rest})")
    weights.append(rest.bit_length())
    rank_count = [0] * (log + 1)
    for w in weights:
        rank_count[w] += 1
    start = [0] * (log + 2)
    nxt = 0
    for w in range(1, log + 1):
        start[w] = nxt
        nxt += rank_count[w] << (w - 1)
    size = 1 << log
    syms = bytearray(size)
    nbits = [0] * size
    for s, w in enumerate(weights):
        if w == 0:
            continue
        length = 1 << (w - 1)
        lo = start[w]
        syms[lo:lo + length] = bytes([s]) * length
        nbits[lo:lo + length] = [log + 1 - w] * length
        start[w] = lo + length
    return (bytes(syms), nbits, log), pos


def _huffman_stream(buf: bytes, start: int, end: int, n_out: int,
                    table: tuple, out: bytearray) -> None:
    """Decode ``n_out`` literals from one backward Huffman stream."""
    syms, nbits, log = table
    if end <= start:
        raise ZstdError("Huffman literals: empty stream")
    last = buf[end - 1]
    if last == 0:
        raise ZstdError("Huffman literals: stream's last byte is 0")
    pos = (end - start - 1) * 8 + last.bit_length() - 1
    mask = (1 << log) - 1
    fb = int.from_bytes
    head = fb(buf[start:start + 3], "little")
    append = out.append
    for _ in range(n_out):
        p = pos - log
        if p >= 0:
            lo = start + (p >> 3)
            idx = (fb(buf[lo:lo + 3], "little") >> (p & 7)) & mask
        else:
            idx = (head << -p) & mask
        append(syms[idx])
        pos -= nbits[idx]
    if pos != 0:
        raise ZstdError(f"Huffman literals: stream ends {pos} bits off its "
                        "start")


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

class _FrameState:
    """What a frame's blocks carry from one to the next."""

    __slots__ = ("out", "rep", "huffman", "ll", "of", "ml")

    def __init__(self):
        self.out = bytearray()
        self.rep = [1, 4, 8]
        self.huffman = None
        self.ll = self.of = self.ml = None


def _literals(buf: bytes, pos: int, end: int, st: _FrameState
              ) -> tuple[bytes, int]:
    """The literals section at ``buf[pos]``: ``(literals, position of the
    sequences section)``."""
    b0 = buf[pos]
    kind = b0 & 3
    fmt = (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, hsize = b0 >> 3, 1
        elif fmt == 1:
            size, hsize = (b0 >> 4) + (buf[pos + 1] << 4), 2
        else:
            size = (b0 >> 4) + (buf[pos + 1] << 4) + (buf[pos + 2] << 12)
            hsize = 3
        pos += hsize
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past the block")
            return bytes(buf[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("RLE literals run past the block")
        return bytes([buf[pos]]) * size, pos + 1
    # Huffman-compressed (kind 2) or treeless (kind 3)
    if fmt in (0, 1):
        v = int.from_bytes(buf[pos:pos + 3], "little")
        regen, comp, hsize = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
        n_streams = 1 if fmt == 0 else 4
    elif fmt == 2:
        v = int.from_bytes(buf[pos:pos + 4], "little")
        regen, comp, hsize = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
        n_streams = 4
    else:
        v = int.from_bytes(buf[pos:pos + 5], "little")
        regen, comp, hsize = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5
        n_streams = 4
    if regen > MAX_BLOCK:
        raise ZstdError(f"literals: {regen} bytes exceed a block")
    pos += hsize
    lit_end = pos + comp
    if lit_end > end:
        raise ZstdError("compressed literals run past the block")
    if kind == 2:
        st.huffman, pos = _huffman_table(buf, pos)
    elif st.huffman is None:
        raise ZstdError("treeless literals with no earlier Huffman table "
                        "in the frame")
    out = bytearray()
    if n_streams == 1:
        _huffman_stream(buf, pos, lit_end, regen, st.huffman, out)
    else:
        if pos + 6 > lit_end:
            raise ZstdError("Huffman literals: truncated jump table")
        s1, s2, s3 = (int.from_bytes(buf[pos + 2 * i:pos + 2 * i + 2],
                                     "little") for i in range(3))
        p = pos + 6
        bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, lit_end]
        if bounds[3] > lit_end:
            raise ZstdError("Huffman literals: jump table runs past the "
                            "literals")
        per = (regen + 3) // 4
        if 3 * per > regen:
            raise ZstdError(f"Huffman literals: {regen} literals do not "
                            "fill four streams")
        for i in range(4):
            n = per if i < 3 else regen - 3 * per
            _huffman_stream(buf, bounds[i], bounds[i + 1], n, st.huffman,
                            out)
    return bytes(out), lit_end


def _seq_table(buf: bytes, pos: int, mode: int, default, limits, prev,
               what: str) -> tuple[tuple, int, int]:
    """One sequence field's decoding table: ``(table, accuracy log,
    position after its description)``."""
    max_symbol, max_log = limits
    if mode == 0:
        norm, acc = default
        return _fse_table(norm, acc, what), acc, pos
    if mode == 1:
        s = buf[pos]
        if s > max_symbol:
            raise ZstdError(f"{what}: RLE symbol {s} above {max_symbol}")
        return ([s], [0], [0]), 0, pos + 1  # one state, no bits read
    if mode == 2:
        norm, acc, pos = _read_ncount(buf, pos, max_symbol, max_log, what)
        return _fse_table(norm, acc, what), acc, pos
    if prev is None:
        raise ZstdError(f"{what}: repeat mode with no earlier table in the "
                        "frame")
    return prev[0], prev[1], pos


def _compressed_block(buf: bytes, pos: int, end: int, st: _FrameState
                      ) -> None:
    literals, pos = _literals(buf, pos, end, st)
    out = st.out
    if pos >= end:
        raise ZstdError("block ends before its sequences section")
    b0 = buf[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("bytes after an empty sequences section")
        out += literals
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        nseq, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError(f"sequences: reserved bits set in modes {modes:#x}")
    st.ll = _seq_table(buf, pos, modes >> 6, _LL_DEFAULT, _LL_LIMITS, st.ll,
                       "literal lengths")
    pos = st.ll[2]
    st.of = _seq_table(buf, pos, (modes >> 4) & 3, _OF_DEFAULT, _OF_LIMITS,
                       st.of, "offsets")
    pos = st.of[2]
    st.ml = _seq_table(buf, pos, (modes >> 2) & 3, _ML_DEFAULT, _ML_LIMITS,
                       st.ml, "match lengths")
    pos = st.ml[2]
    (ll_sym, ll_nb, ll_base), ll_acc = st.ll[0], st.ll[1]
    (of_sym, of_nb, of_base), of_acc = st.of[0], st.of[1]
    (ml_sym, ml_nb, ml_base), ml_acc = st.ml[0], st.ml[1]
    bits = _BackBits(buf, pos, end, "sequences")
    read = bits.read
    ll_s = read(ll_acc)
    of_s = read(of_acc)
    ml_s = read(ml_acc)
    rep = st.rep
    lit = 0
    n_lit = len(literals)
    for i in range(nseq):
        ofc = of_sym[of_s]
        llc = ll_sym[ll_s]
        mlc = ml_sym[ml_s]
        ofv = (1 << ofc) + read(ofc)
        ml = _ML_BASE[mlc] + read(_ML_BITS[mlc])
        ll = _LL_BASE[llc] + read(_LL_BITS[llc])
        if ofv > 3:
            off = ofv - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            idx = ofv - 1 if ll else ofv
            if idx == 0:
                off = rep[0]
            elif idx == 1:
                off = rep[1]
                rep[1], rep[0] = rep[0], off
            elif idx == 2:
                off = rep[2]
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
            else:
                off = rep[0] - 1
                if off == 0:
                    raise ZstdError("sequences: repeat offset 1 minus 1 is 0")
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
        if i != nseq - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if ll:
            if lit + ll > n_lit:
                raise ZstdError(f"sequences: {lit + ll} literals asked of "
                                f"{n_lit}")
            out += literals[lit:lit + ll]
            lit += ll
        here = len(out)
        if off > here:
            raise ZstdError(f"sequences: offset {off} reaches before the "
                            f"frame's start ({here} bytes out; dictionaries "
                            "are not supported)")
        src = here - off
        if off >= ml:
            out += out[src:src + ml]
        else:
            seg = out[src:]
            q, r = divmod(ml, off)
            out += seg * q + seg[:r]
    if bits.pos != 0:
        raise ZstdError(f"sequences: bit stream ends {bits.pos} bits off its "
                        "start")
    out += literals[lit:]


# --------------------------------------------------------------------------
# Frames
# --------------------------------------------------------------------------

def _frame(buf: bytes, pos: int) -> tuple[bytes, int]:
    """Decode the frame whose header starts at ``buf[pos]`` (after the
    magic): ``(content, position after the frame)``."""
    n = len(buf)
    if pos >= n:
        raise ZstdError("truncated frame header")
    fhd = buf[pos]
    pos += 1
    fcs_flag = fhd >> 6
    single = (fhd >> 5) & 1
    if fhd & 0x08:
        raise ZstdError(f"frame header descriptor {fhd:#04x} has its "
                        "reserved bit set")
    has_checksum = (fhd >> 2) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    window = None
    if not single:
        wd = buf[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    dict_id = int.from_bytes(buf[pos:pos + did_size], "little")
    pos += did_size
    if dict_id:
        raise ZstdError(f"frame needs dictionary {dict_id}: dictionaries "
                        "are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > n:
        raise ZstdError("truncated frame header")
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(buf[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
        pos += fcs_size
    if single:
        window = fcs
    block_max = min(window, MAX_BLOCK)
    st = _FrameState()
    while True:
        if pos + 3 > n:
            raise ZstdError("truncated block header")
        bh = int.from_bytes(buf[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 3:
            raise ZstdError("reserved block type 3")
        if bsize > block_max:
            raise ZstdError(f"block of {bsize} bytes exceeds the frame's "
                            f"block maximum {block_max}")
        if btype == 0:
            if pos + bsize > n:
                raise ZstdError("raw block runs past the input")
            st.out += buf[pos:pos + bsize]
            pos += bsize
        elif btype == 1:
            if pos >= n:
                raise ZstdError("RLE block runs past the input")
            st.out += bytes([buf[pos]]) * bsize
            pos += 1
        else:
            if pos + bsize > n:
                raise ZstdError("compressed block runs past the input")
            before = len(st.out)
            _compressed_block(buf, pos, pos + bsize, st)
            if len(st.out) - before > block_max:
                raise ZstdError("compressed block decodes past the block "
                                "maximum")
            pos += bsize
        if last:
            break
    content = bytes(st.out)
    if fcs is not None and len(content) != fcs:
        raise ZstdError(f"frame decodes to {len(content)} bytes, its header "
                        f"says {fcs}")
    if has_checksum:
        if pos + 4 > n:
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(buf[pos:pos + 4], "little")
        got = xxh64(content) & 0xFFFFFFFF
        if got != want:
            raise ZstdError(f"content checksum mismatch: frame says "
                            f"{want:#010x}, content hashes to {got:#010x}")
        pos += 4
    return content, pos


def decompress(data: bytes) -> bytes:
    """The content of every frame in ``data``, concatenated."""
    buf = bytes(data)
    pos = 0
    parts: list[bytes] = []
    if not buf:
        raise ZstdError("empty input")
    while pos < len(buf):
        if pos + 4 > len(buf):
            raise ZstdError(f"{len(buf) - pos} trailing bytes after the last "
                            "frame")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        if magic == MAGIC:
            content, pos = _frame(buf, pos)
            parts.append(content)
        elif magic & 0xFFFFFFF0 == 0x184D2A50:
            size = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4 + size
            if pos > len(buf):
                raise ZstdError("skippable frame runs past the input")
        else:
            raise ZstdError(f"not a zstd frame: magic {magic:#010x} at byte "
                            f"{pos - 4}")
    return b"".join(parts)


def compress(data: bytes) -> bytes:
    """One zstd frame holding ``data`` in Raw blocks, with its content size
    and a 128 KiB window (no checksum)."""
    data = bytes(data)
    n = len(data)
    fcs_flag, fcs_size = (2, 4) if n < (1 << 32) else (3, 8)
    parts = [MAGIC.to_bytes(4, "little"),
             bytes([fcs_flag << 6, 7 << 3]),  # window 2**17
             n.to_bytes(fcs_size, "little")]
    starts = range(0, n, MAX_BLOCK) if n else [0]
    for i in starts:
        block = data[i:i + MAX_BLOCK]
        last = int(i + MAX_BLOCK >= n)
        parts.append((last | (len(block) << 3)).to_bytes(3, "little"))
        parts.append(block)
    return b"".join(parts)
