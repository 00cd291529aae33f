"""Minimal TensorBoard scalar-event writer with no TensorFlow dependency (counterpart of robustpointclouds_tpu/core/tensorboard.py).

Writes standard `events.out.tfevents.*` files that TensorBoard reads by
hand-encoding the two protobufs involved (Event, Summary) and the TFRecord
framing (length + masked CRC32C), so no protobuf or TF package is needed;
the reference declares a TensorBoard logging backend for its runs.

Usage::

    tb = TensorBoardWriter(work_dir)
    tb.add_scalar("train/loss", 0.35, step=100)
    tb.close()
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# -- CRC32C (Castagnoli), table-driven ----------------------------------------
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire helpers -----------------------------------------------------
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


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(v)


def _field_bytes(num: int, b: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(b)) + b


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    sv = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, sv)  # Summary{ repeated value=1 }
    # Event{ wall_time=1, step=2, summary=5 }
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _file_version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3 }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class TensorBoardWriter:
    """Append-only scalar writer producing TensorBoard-compatible event files."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None):
        self._write_record(
            _scalar_event(tag, value, step, wall_time or time.time())
        )

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_scalar_events(path: str):
    """Parse a scalar event file back (for tests / inspection). Returns a list
    of (tag, value, step)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack("<Q", data[pos : pos + 8])
        payload = data[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        # parse Event fields
        p, step, summary = 0, 0, None
        while p < len(payload):
            key = payload[p]
            num, wire = key >> 3, key & 7
            p += 1
            if wire == 1:
                p += 8
            elif wire == 5:
                p += 4
            elif wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if num == 2:
                    step = v
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if num == 5:
                    summary = payload[p : p + ln]
                p += ln
        if summary:
            # Summary -> Value{tag, simple_value}
            sp = 0
            while sp < len(summary):
                key = summary[sp]
                sp += 1
                ln = 0
                shift = 0
                while True:
                    b = summary[sp]
                    sp += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                val = summary[sp : sp + ln]
                sp += ln
                vp, tag, sv = 0, None, None
                while vp < len(val):
                    k = val[vp]
                    vnum, vwire = k >> 3, k & 7
                    vp += 1
                    if vwire == 2:
                        l2 = 0
                        shift = 0
                        while True:
                            b = val[vp]
                            vp += 1
                            l2 |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        if vnum == 1:
                            tag = val[vp : vp + l2].decode()
                        vp += l2
                    elif vwire == 5:
                        if vnum == 2:
                            (sv,) = struct.unpack("<f", val[vp : vp + 4])
                        vp += 4
                    elif vwire == 1:
                        vp += 8
                    elif vwire == 0:
                        while val[vp] & 0x80:
                            vp += 1
                        vp += 1
                if tag is not None and sv is not None:
                    out.append((tag, sv, step))
    return out
