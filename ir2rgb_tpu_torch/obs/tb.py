"""TensorBoard event-file writer — dependency-free.

SURVEY.md §5 (metrics row) planned TensorBoard-format event files as the
structured-metrics output of the rebuild (the reference family offers
optional TensorBoard/visdom hooks in ``util/visualizer.py``). This module
writes the format directly — TFRecord framing with masked CRC32C and
hand-rolled protobuf encoding of the tiny Event/Summary subset scalars
and images need — so neither tensorflow nor the tensorboard package is a
runtime dependency (tests verify the output parses with the real
tensorboard reader when it is installed).

Wire format, for the record:
- file: sequence of TFRecords: ``<uint64 len><uint32 masked_crc(len)>
  <data><uint32 masked_crc(data)>``, little-endian, CRC32C (Castagnoli),
  mask = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32.
- data: an ``Event`` protobuf: wall_time(1, double), step(2, int64),
  file_version(3, string) or summary(5, message). ``Summary`` holds
  repeated ``Value`` (1): tag(1, string), simple_value(2, float) or
  image(4, message: height 1, width 2, colorspace 3, png bytes 4).

The port's copy of ``ir2rgb_tpu/obs/tb.py``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected poly 0x82F63B78). A native implementation
# is used when importable; the table-driven pure-Python fallback costs
# ~1 us/byte — irrelevant for scalar events at print_freq cadence, but
# ~0.3 s for a 300 KB PNG, so add_image on the fallback is NOT hot-path
# safe (fine at display_freq cadence; don't call it per step).
# ---------------------------------------------------------------------------

def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()

try:  # google-crc32c / crc32c native wheels, when present
    import crc32c as _native_crc32c

    def crc32c(data: bytes) -> int:
        return _native_crc32c.crc32c(data) & 0xFFFFFFFF
except Exception:
    def crc32c(data: bytes) -> int:
        c = 0xFFFFFFFF
        for b in data:
            c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
        return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding (wire format only — no schema compiler)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        # protobuf encodes negative int64 as 10-byte two's complement;
        # Python's sign-preserving >> would otherwise never terminate
        n &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _event(payload: bytes, step: Optional[int] = None,
           wall_time: Optional[float] = None) -> bytes:
    buf = _f_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        buf += _f_varint(2, int(step))
    return buf + payload


# ---------------------------------------------------------------------------

class TBEventWriter:
    """Append-only writer of ``events.out.tfevents.*`` files.

    One instance per run directory; ``add_scalar``/``add_image`` buffer
    nothing — each call appends one flushed record, so a crashed run's
    events are readable up to the last write."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._fh = open(self.path, "ab")
        # every event file starts with a file_version event
        self._write(_event(_f_bytes(3, b"brain.Event:2")))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header
                       + struct.pack("<I", _masked_crc(header))
                       + record
                       + struct.pack("<I", _masked_crc(record)))
        self._fh.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        val = _f_bytes(1, _f_bytes(1, tag.encode())
                       + _f_float(2, float(value)))
        self._write(_event(_f_bytes(5, val), step=step))

    def add_scalars(self, scalars, step: int) -> None:
        """dict of tag -> value, one Summary with several Values."""
        val = b"".join(
            _f_bytes(1, _f_bytes(1, t.encode()) + _f_float(2, float(v)))
            for t, v in scalars.items())
        self._write(_event(_f_bytes(5, val), step=step))

    def add_image(self, tag: str, png_bytes: bytes, height: int,
                  width: int, step: int, colorspace: int = 3) -> None:
        """``png_bytes``: an already-encoded PNG (colorspace 3 = RGB)."""
        img = (_f_varint(1, height) + _f_varint(2, width)
               + _f_varint(3, colorspace) + _f_bytes(4, png_bytes))
        val = _f_bytes(1, _f_bytes(1, tag.encode()) + _f_bytes(4, img))
        self._write(_event(_f_bytes(5, val), step=step))

    def flush(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()
