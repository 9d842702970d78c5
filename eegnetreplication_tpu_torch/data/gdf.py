"""GDF (General Data Format for biosignals) reader and writer, numpy only.

The port's copy of ``eegnetreplication_tpu/data/gdf.py``.  The reference
reads the BCI-IV-2a ``.gdf`` recordings through MNE
(``src/eegnet_repl/dataset.py:86``); this reader needs only numpy, so the
pipeline has no MNE dependency.  :func:`read_gdf` prefers the C++ reader
(:mod:`~eegnetreplication_tpu_torch.data.gdf_native`, built at first use)
and falls back to this one when it cannot be built or loaded.

Supports GDF v1.x and v2.x per the GDF specification (Schloegl 2006 and the
BioSig reference implementation):

- fixed 256-byte header; for both major versions the fields this reader needs
  sit at the same offsets: header length (in 256-byte blocks) at byte 184,
  number of data records at 236 (int64), record duration as a
  numerator/denominator uint32 pair at 244, and the channel count at 252;
- 256 bytes of channel header per channel, stored field-major (all labels,
  then all transducer strings, ...); v1 stores digital limits as int64 and an
  80-byte prefilter string, v2 stores float64 limits and a 68-byte prefilter
  followed by per-channel lowpass/highpass/notch floats;
- sample records interleaved channel-blocked per record, with per-channel
  sample type (GDFTYP) and samples-per-record;
- an event table after the data: mode byte, then (v >= 1.94) a 24-bit event
  count and float32 event sample rate, or (v < 1.94) a 24-bit sample rate and
  uint32 count; positions are uint32 **1-based** sample indices, types uint16;
  mode 3 adds per-event channel and duration arrays.

Samples are calibrated to physical units with the per-channel affine map
``phys = gain * dig + (physmin - gain * digmin)`` and returned as float32.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.utils.logging import logger

# GDFTYP -> numpy dtype (little-endian), per the GDF spec's type table.
_GDF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.dtype("<i2"), 4: np.dtype("<u2"),
    5: np.dtype("<i4"), 6: np.dtype("<u4"), 7: np.dtype("<i8"),
    8: np.dtype("<u8"), 16: np.dtype("<f4"), 17: np.dtype("<f8"),
}


@dataclass
class GDFRecording:
    """One continuous GDF recording in physical units.

    Attributes:
        signals: ``(n_channels, n_samples)`` float32, physical units.
        sfreq: sampling rate in Hz (of the highest-rate channel).
        labels: per-channel label strings.
        event_pos: ``(n_events,)`` int64 0-based sample indices.
        event_typ: ``(n_events,)`` int event type codes (e.g. 769..772 cues).
        event_durations: ``(n_events,)`` int64 durations in samples (0 when
            the file's event table is mode 1).
        version: GDF version float (e.g. 2.2).
    """

    signals: np.ndarray
    sfreq: float
    labels: list[str]
    event_pos: np.ndarray
    event_typ: np.ndarray
    event_durations: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    version: float = 2.2

    @property
    def n_channels(self) -> int:
        return self.signals.shape[0]

    @property
    def n_samples(self) -> int:
        return self.signals.shape[1]


def _decode(raw: bytes) -> str:
    return raw.split(b"\x00")[0].decode("ascii", errors="replace").strip()


def read_gdf(path: str | Path, prefer_native: bool = True) -> GDFRecording:
    """Read a GDF file; uses the C++ reader when built, else pure numpy."""
    path = Path(path)
    if prefer_native:
        from eegnetreplication_tpu_torch.data import gdf_native

        if gdf_native.available():
            return gdf_native.read_gdf(path)
    return read_gdf_python(path)


def read_gdf_python(path: str | Path) -> GDFRecording:
    """Pure-numpy GDF reader (v1.x and v2.x)."""
    path = Path(path)
    data = path.read_bytes()
    if len(data) < 256:
        raise ValueError(f"{path}: truncated GDF file ({len(data)} bytes)")

    magic = _decode(data[0:8])
    if not magic.startswith("GDF"):
        raise ValueError(f"{path}: not a GDF file (magic {magic!r})")
    try:
        version = float(magic.split(" ")[1])
    except (IndexError, ValueError):
        raise ValueError(f"{path}: unparsable GDF version {magic!r}")

    if version >= 1.9:
        # v2.x: header length is a uint16 count of 256-byte blocks at 184.
        header_len = struct.unpack_from("<H", data, 184)[0] * 256
    else:
        # v1.x: header length in bytes as int64 at 184.
        header_len = struct.unpack_from("<q", data, 184)[0]
    n_records = struct.unpack_from("<q", data, 236)[0]
    dur_num, dur_den = struct.unpack_from("<II", data, 244)
    n_channels = struct.unpack_from("<H", data, 252)[0]
    if n_records < 0:
        raise ValueError(f"{path}: unknown record count (streaming file)")
    min_header = 256 * (1 + n_channels)
    if not min_header <= header_len <= len(data):
        raise ValueError(
            f"{path}: bad GDF header length {header_len} "
            f"(need {min_header}..{len(data)} for {n_channels} channels)")
    record_dur = dur_num / dur_den if dur_den else 1.0

    # --- channel headers: field-major arrays of per-channel metadata ---
    ch = memoryview(data)[256:header_len]
    off = 0

    def take(nbytes_per_ch: int) -> memoryview:
        nonlocal off
        block = ch[off: off + nbytes_per_ch * n_channels]
        off += nbytes_per_ch * n_channels
        return block

    labels = [_decode(bytes(b)) for b in np.frombuffer(take(16), dtype="S16")]
    take(80)  # transducer type
    if version >= 1.9:
        take(6)   # physical dimension (obsolete text form)
        take(2)   # physical dimension code
        physmin = np.frombuffer(take(8), dtype="<f8")
        physmax = np.frombuffer(take(8), dtype="<f8")
        digmin = np.frombuffer(take(8), dtype="<f8")
        digmax = np.frombuffer(take(8), dtype="<f8")
        take(68)  # prefiltering description
        take(4)   # lowpass (float32)
        take(4)   # highpass (float32)
        take(4)   # notch (float32)
        spr = np.frombuffer(take(4), dtype="<u4").astype(np.int64)
        gdftyp = np.frombuffer(take(4), dtype="<u4")
    else:
        take(8)   # physical dimension text
        physmin = np.frombuffer(take(8), dtype="<f8")
        physmax = np.frombuffer(take(8), dtype="<f8")
        digmin = np.frombuffer(take(8), dtype="<i8").astype(np.float64)
        digmax = np.frombuffer(take(8), dtype="<i8").astype(np.float64)
        take(80)  # prefiltering description
        spr = np.frombuffer(take(4), dtype="<u4").astype(np.int64)
        gdftyp = np.frombuffer(take(4), dtype="<u4")

    if len(set(spr.tolist())) != 1:
        raise NotImplementedError(
            f"{path}: mixed samples-per-record {sorted(set(spr.tolist()))} "
            f"not supported"
        )
    spr0 = int(spr[0])
    sfreq = spr0 / record_dur

    dtypes = []
    for t in gdftyp.tolist():
        if t not in _GDF_DTYPES:
            raise NotImplementedError(f"{path}: unsupported GDFTYP {t}")
        dtypes.append(np.dtype(_GDF_DTYPES[t]))
    record_bytes = sum(d.itemsize * spr0 for d in dtypes)

    # --- data records: per record, channel-blocked sample runs ---
    body = memoryview(data)[header_len: header_len + n_records * record_bytes]
    if len(body) < n_records * record_bytes:
        raise ValueError(f"{path}: truncated data section")

    signals = np.empty((n_channels, n_records * spr0), dtype=np.float32)
    if len(set(d.str for d in dtypes)) == 1:
        # Homogeneous sample type (the BCI-IV-2a case): one vectorized reshape.
        raw = np.frombuffer(body, dtype=dtypes[0])
        raw = raw.reshape(n_records, n_channels, spr0)
        signals[:] = np.ascontiguousarray(raw.transpose(1, 0, 2)).reshape(
            n_channels, -1).astype(np.float32)
    else:
        offsets = np.cumsum([0] + [d.itemsize * spr0 for d in dtypes])
        for c, dt in enumerate(dtypes):
            for r in range(n_records):
                start = r * record_bytes + offsets[c]
                chunk = np.frombuffer(
                    body[start: start + dt.itemsize * spr0], dtype=dt
                )
                signals[c, r * spr0:(r + 1) * spr0] = chunk

    # Calibration dig -> phys per channel.
    denom = digmax - digmin
    gain = np.where(denom != 0, (physmax - physmin) / np.where(denom == 0, 1, denom), 1.0)
    offset_phys = physmin - gain * digmin
    signals *= gain[:, None].astype(np.float32)
    signals += offset_phys[:, None].astype(np.float32)

    # --- event table (optional) ---
    ev_start = header_len + n_records * record_bytes
    event_pos = np.zeros(0, np.int64)
    event_typ = np.zeros(0, np.int64)
    event_dur = np.zeros(0, np.int64)
    if ev_start + 8 <= len(data):
        ev = memoryview(data)[ev_start:]
        mode = ev[0]
        b1, b2, b3 = ev[1], ev[2], ev[3]
        # The 24-bit-count + float32-rate layout only applies from v1.94
        # (per the GDF spec and BioSig); GDF 1.90-1.93 still use the v1
        # layout (3-byte rate + uint32 count).
        if version >= 1.94:
            n_events = b1 + (b2 << 8) + (b3 << 16)
            cursor = 8  # bytes 4:8 are the float32 event sample rate
        else:
            n_events = struct.unpack_from("<I", ev, 4)[0]
            cursor = 8
        if cursor + 6 * n_events > len(ev):
            raise ValueError(f"{path}: truncated event table")
        pos = np.frombuffer(ev[cursor: cursor + 4 * n_events], dtype="<u4")
        cursor += 4 * n_events
        typ = np.frombuffer(ev[cursor: cursor + 2 * n_events], dtype="<u2")
        cursor += 2 * n_events
        event_pos = pos.astype(np.int64) - 1  # GDF positions are 1-based
        event_typ = typ.astype(np.int64)
        event_dur = np.zeros(n_events, np.int64)
        if mode == 3 and cursor + 6 * n_events <= len(ev):
            cursor += 2 * n_events  # per-event channel numbers
            dur = np.frombuffer(ev[cursor: cursor + 4 * n_events], dtype="<u4")
            event_dur = dur.astype(np.int64)

    logger.debug("Read %s: v%.2f, %d ch x %d samples @ %g Hz, %d events",
                 path.name, version, n_channels, signals.shape[1], sfreq,
                 len(event_pos))
    return GDFRecording(signals=signals, sfreq=sfreq, labels=labels,
                        event_pos=event_pos, event_typ=event_typ,
                        event_durations=event_dur, version=version)


def write_gdf(path: str | Path, signals: np.ndarray, sfreq: float,
              labels: list[str] | None = None,
              event_pos: np.ndarray | None = None,
              event_typ: np.ndarray | None = None,
              version: str = "2.20") -> Path:
    """Write a minimal spec-conformant GDF file (float32 samples).

    Exists for tests and tooling — the framework itself only reads GDF — and
    doubles as an executable statement of the layout the reader expects.
    One-second records; event table mode 1.
    """
    path = Path(path)
    signals = np.asarray(signals, dtype=np.float32)
    n_channels, n_samples = signals.shape
    spr = int(round(sfreq))
    if n_samples % spr:
        raise ValueError("n_samples must be a whole number of 1 s records")
    n_records = n_samples // spr
    labels = labels or [f"ch{i}" for i in range(n_channels)]
    vnum = float(version.split(" ")[-1] if " " in version else version)
    is_v2 = vnum >= 1.9          # fixed/channel header layout switches at 1.90
    ev_v2 = vnum >= 1.94         # event-table layout only switches at 1.94

    header = bytearray(256)
    header[0:8] = f"GDF {version}".encode("ascii")[:8].ljust(8)
    n_blocks = 1 + n_channels
    if is_v2:
        struct.pack_into("<H", header, 184, n_blocks)
    else:
        struct.pack_into("<q", header, 184, n_blocks * 256)
    struct.pack_into("<q", header, 236, n_records)
    struct.pack_into("<II", header, 244, 1, 1)  # 1 s per record
    struct.pack_into("<H", header, 252, n_channels)

    def field_block(per_ch: int, values: list[bytes]) -> bytes:
        return b"".join(v[:per_ch].ljust(per_ch, b"\x00") for v in values)

    f64 = lambda vals: b"".join(struct.pack("<d", v) for v in vals)
    i64 = lambda vals: b"".join(struct.pack("<q", int(v)) for v in vals)
    u32 = lambda vals: b"".join(struct.pack("<I", int(v)) for v in vals)

    # Identity calibration: phys and dig ranges both [-1, 1].
    hi, lo = [1.0] * n_channels, [-1.0] * n_channels
    chan = bytearray()
    chan += field_block(16, [l.encode() for l in labels])
    chan += bytes(80 * n_channels)                       # transducer
    if is_v2:
        chan += bytes(6 * n_channels)                    # physdim (obsolete)
        chan += bytes(2 * n_channels)                    # physdim code
        chan += f64(lo) + f64(hi)                        # physmin/max
        chan += f64(lo) + f64(hi)                        # digmin/max
        chan += bytes(68 * n_channels)                   # prefilter
        chan += bytes(4 * n_channels) * 3                # lp/hp/notch
    else:
        chan += bytes(8 * n_channels)                    # physdim text
        chan += f64(lo) + f64(hi)                        # physmin/max
        chan += i64(lo) + i64(hi)                        # digmin/max (int64)
        chan += bytes(80 * n_channels)                   # prefilter
    chan += u32([spr] * n_channels)                      # samples per record
    chan += u32([16] * n_channels)                       # GDFTYP float32
    chan += bytes(256 * n_channels - len(chan))          # reserved tail

    body = signals.reshape(n_channels, n_records, spr).transpose(1, 0, 2)
    body_bytes = np.ascontiguousarray(body).astype("<f4").tobytes()

    ev_bytes = b""
    if event_pos is not None and len(event_pos):
        n_ev = len(event_pos)
        ev = bytearray(8)
        ev[0] = 1  # mode
        if ev_v2:
            ev[1:4] = struct.pack("<I", n_ev)[:3]
            ev[4:8] = struct.pack("<f", sfreq)
        else:
            ev[1:4] = struct.pack("<I", int(sfreq))[:3]
            ev[4:8] = struct.pack("<I", n_ev)
        ev += u32(np.asarray(event_pos) + 1)  # 1-based positions
        ev += b"".join(struct.pack("<H", int(t)) for t in event_typ)
        ev_bytes = bytes(ev)

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(header) + bytes(chan) + body_bytes + ev_bytes)
    return path
