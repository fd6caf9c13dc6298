"""TensorBoard event-file writer, without TensorFlow.

The port's own copy of the JAX package's utils/tb_events.py, byte for byte
in what it writes: the same CRC32C table, varint and protobuf fields and
``EventsWriter``, so both packages write the same events file for the same
scalars, steps and wall times. The reference's tabular logger appends a
TensorBoard scalar event per ``dump_tabular()`` through TF's
``EventsWriter`` (es_distributed/tabular_logger.py:19-38, 131-153).

File layout per record:  uint64 LE length | masked_crc32c(length bytes) |
payload | masked_crc32c(payload). The first record is the
``file_version: "brain.Event:2"`` header event, as TF writes it.

Proto fields encoded (tensorflow.Event / tensorflow.Summary):
  Event.wall_time  = 1 (double)      Event.step     = 2 (int64)
  Event.file_version = 3 (string)    Event.summary  = 5 (message)
  Summary.value    = 1 (repeated Value)
  Value.tag        = 1 (string)      Value.simple_value = 2 (float)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ----------------------------------------------------------------- crc32c

_CRC_POLY = 0x82F63B78  # Castagnoli, reflected


def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC mask: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- proto encode


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _field_bytes(num: int, v: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(v)) + v


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _encode_value(tag: str, value: float) -> bytes:
    return _field_bytes(1, tag.encode()) + _field_float(2, float(value))


def encode_scalar_event(step: int, wall_time: float, scalars: Dict[str, float]) -> bytes:
    summary = b"".join(_field_bytes(1, _encode_value(k, v)) for k, v in scalars.items())
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def encode_version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


# ----------------------------------------------------------------- writer


class EventsWriter:
    """Append scalar events to an `events.out.tfevents.*` file.

    Mirrors the reference's writer lifecycle: file named with start time +
    hostname (tabular_logger.py pattern), version header first, one event
    per dump with an explicit global step."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        t = time.time()
        fname = f"events.out.tfevents.{int(t)}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(encode_version_event(t))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def write_scalars(
        self, step: int, scalars: Dict[str, float], wall_time: Optional[float] = None
    ) -> None:
        clean = {}
        for k, v in scalars.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            clean[k] = float(v)
        if not clean:
            return
        self._write_record(
            encode_scalar_event(step, wall_time if wall_time is not None else time.time(), clean)
        )
        self._f.flush()

    def close(self) -> None:
        self._f.close()
