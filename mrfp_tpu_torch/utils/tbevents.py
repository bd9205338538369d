"""Pure-Python TensorBoard event-file writer and reader: a copy of
mrfp_tpu/utils/tbevents.py (that package's ``utils`` imports jax).

The reference harness logs scalars through tensorboardX
(utils/misc.py:115,249-254). The port ships no TB writer either, so this
module writes the tfevents on-disk format directly, scalars only, which is
all the reference ever wrote (acc/acc_cls/mean_iu/val_loss and train
loss/lr):

- TFRecord framing: <uint64 len><uint32 masked-crc32c(len)><data>
  <uint32 masked-crc32c(data)>, little-endian.
- Event protobuf, hand-encoded (field numbers from tensorflow's event.proto/
  summary.proto): Event{wall_time=1(double), step=2(int64),
  file_version=3(string), summary=5(Summary)};
  Summary{value=1(repeated Value)}; Value{tag=1(string),
  simple_value=2(float)}.
- CRC32C (Castagnoli, reflected poly 0x82F63B78) with TensorFlow's mask:
  rotr15(crc) + 0xa282ead8.

Files written here load in stock TensorBoard (`tensorboard --logdir run/tb`)
and are byte for byte what the JAX package writes for the same scalars and
wall times. ``read_tfevents`` is the matching reader, for tests and offline
extraction.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, Optional, Tuple

# --- CRC32C (table-driven, reflected 0x82F63B78) ---------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf wire encoding ----------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    value_msg = _bytes(1, tag.encode()) + _float(2, float(value))
    summary = _bytes(1, value_msg)
    return _double(1, wall_time) + _int64(2, int(step)) + _bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


class TBEventWriter:
    """Append-only scalar event file under ``logdir``."""

    def __init__(self, logdir: str, wall_time: Optional[float] = None):
        os.makedirs(logdir, exist_ok=True)
        t = time.time() if wall_time is None else wall_time
        fname = f"events.out.tfevents.{int(t)}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(t))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        t = time.time() if wall_time is None else wall_time
        self._write_record(_scalar_event(tag, value, step, t))

    def close(self) -> None:
        self._f.close()


# --- reader (round-trip tests + offline extraction) ------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    pos = 0
    while pos < len(buf):
        k, pos = _read_varint(buf, pos)
        field, wire = k >> 3, k & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            v, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            v, pos = buf[pos:pos + ln], pos + ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def read_tfevents(path: str, check_crc: bool = True):
    """Yield (tag, value, step, wall_time) scalar tuples from a tfevents
    file; the file_version header record is consumed and validated."""
    with open(path, "rb") as f:
        raw = f.read()
    pos, first = 0, True
    while pos < len(raw):
        header = raw[pos:pos + 8]
        (ln,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", raw[pos + 8:pos + 12])
        data = raw[pos + 12:pos + 12 + ln]
        (dcrc,) = struct.unpack("<I", raw[pos + 12 + ln:pos + 16 + ln])
        pos += 16 + ln
        if check_crc and hcrc != _masked_crc(header):
            raise ValueError(f"{path}: corrupt record header at byte {pos - 16 - ln}")
        if check_crc and dcrc != _masked_crc(data):
            raise ValueError(f"{path}: corrupt record payload at byte {pos - 16 - ln}")
        wall = step = None
        summary = version = None
        for field, _wire, v in _iter_fields(data):
            if field == 1:
                (wall,) = struct.unpack("<d", v)
            elif field == 2:
                step = v
            elif field == 3:
                version = v
            elif field == 5:
                summary = v
        if first:
            first = False
            if version is not None:
                if version != b"brain.Event:2":
                    raise ValueError(f"{path}: file_version {version!r}")
                continue
        if summary is None:
            continue
        for f1, _w, value_msg in _iter_fields(summary):
            if f1 != 1:
                continue
            tag, sv = None, None
            for f2, _w2, v2 in _iter_fields(value_msg):
                if f2 == 1:
                    tag = v2.decode()
                elif f2 == 2:
                    (sv,) = struct.unpack("<f", v2)
            if tag is not None and sv is not None:
                yield tag, sv, step or 0, wall or 0.0
