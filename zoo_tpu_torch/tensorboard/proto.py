"""Minimal protobuf wire-format codec, no protobuf dependency (a copy
of ``zoo_tpu/tensorboard/proto.py``).

Just enough of proto3 encoding to emit and parse TensorFlow ``Event`` /
``Summary`` messages. Wire types: 0=varint, 1=64-bit,
2=length-delimited, 5=32-bit.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

Value = Union[int, float, bytes, "Message"]


def encode_varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _key(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def field_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + encode_varint(value)


def field_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def field_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def field_bytes(field: int, value: bytes) -> bytes:
    if isinstance(value, str):
        value = value.encode("utf-8")
    return _key(field, 2) + encode_varint(len(value)) + value


field_message = field_bytes  # submessages are length-delimited too


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Value]]:
    """Yield (field_number, wire_type, raw_value) over a message body.
    Length-delimited values come back as bytes; callers recurse."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            val, pos = decode_varint(buf, pos)
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif wire == 2:
            ln, pos = decode_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            (val,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_fields(buf: bytes) -> Dict[int, List[Value]]:
    out: Dict[int, List[Value]] = {}
    for field, _, val in iter_fields(buf):
        out.setdefault(field, []).append(val)
    return out


def zigzag_to_int64(v: int) -> int:
    """Plain varint int64 decode (values ≥ 2^63 are negative)."""
    return v - (1 << 64) if v >= (1 << 63) else v
