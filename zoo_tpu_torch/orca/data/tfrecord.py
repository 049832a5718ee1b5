"""TFRecord reader and writer (counterpart of
``zoo_tpu/orca/data/tfrecord.py``).

The hot path is the C++ reader of :mod:`zoo_tpu_torch.native`
(CRC32C-checked streaming through ``ctypes``); the Python route
(``struct`` and a table CRC32C) runs where the library cannot be built.
Each call records the route it took (``native.routes()``). Files are
byte-compatible with the JAX package's writer both ways, and with
TensorFlow's. A sharded file set maps onto XShards partitions, one a
file.
"""

from __future__ import annotations

import ctypes
import glob as _glob
import struct
from typing import Callable, Iterable, Iterator, List, Optional

from zoo_tpu_torch import native as _native

__all__ = ["crc32c", "TFRecordCorruptError", "tfrecord_iterator",
           "read_tfrecord", "read_tfrecord_shards", "TFRecordWriter",
           "write_tfrecord"]

_PY_TABLE = None


def _py_crc32c_table():
    global _PY_TABLE
    if _PY_TABLE is None:
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            tbl.append(c)
        _PY_TABLE = tbl
    return _PY_TABLE


def _py_crc32c(data: bytes) -> int:
    tbl = _py_crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    lib = _native.load()
    _native.record_route("crc32c", lib is not None)
    if lib is not None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return lib.zoo_crc32c(buf, len(data))
    return _py_crc32c(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordCorruptError(IOError):
    pass


def _iter_native(path: str, check_crc: bool) -> Iterator[bytes]:
    lib = _native.load()
    h = lib.zoo_tfr_reader_open(path.encode(), 1 if check_crc else 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        while True:
            n = lib.zoo_tfr_reader_next(h, ctypes.byref(ptr))
            if n == -1:
                return
            if n == -2:
                raise TFRecordCorruptError(path)
            yield ctypes.string_at(ptr, n)
    finally:
        lib.zoo_tfr_reader_close(h)


def _iter_python(path: str, check_crc: bool) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if not hdr:
                return
            if len(hdr) != 12:
                raise TFRecordCorruptError(path)
            (length,) = struct.unpack("<Q", hdr[:8])
            (len_crc,) = struct.unpack("<I", hdr[8:])
            if check_crc and _masked_crc(hdr[:8]) != len_crc:
                raise TFRecordCorruptError(path)
            payload = f.read(length + 4)
            if len(payload) != length + 4:
                raise TFRecordCorruptError(path)
            data, (data_crc,) = payload[:-4], struct.unpack(
                "<I", payload[-4:])
            if check_crc and _masked_crc(data) != data_crc:
                raise TFRecordCorruptError(path)
            yield data


def tfrecord_iterator(path: str, check_crc: bool = True) -> Iterator[bytes]:
    """Stream raw records from one TFRecord file."""
    if _native.record_route("tfrecord_read", _native.available()) == \
            "native":
        return _iter_native(path, check_crc)
    return _iter_python(path, check_crc)


def _matched(paths) -> List[str]:
    if isinstance(paths, str):
        return sorted(_glob.glob(paths)) or [paths]
    return list(paths)


def read_tfrecord(paths, parse_fn: Optional[Callable[[bytes], object]] = None,
                  check_crc: bool = True) -> List[object]:
    """Records of a file, a glob or a list of files, in order, each
    through ``parse_fn`` when given."""
    out: List[object] = []
    for p in _matched(paths):
        for rec in tfrecord_iterator(p, check_crc):
            out.append(parse_fn(rec) if parse_fn else rec)
    return out


def read_tfrecord_shards(paths, parse_fn=None, check_crc: bool = True):
    """One XShards partition a file (the reference's one Hadoop split a
    task)."""
    from zoo_tpu_torch.orca.data.shard import LocalXShards

    return LocalXShards([read_tfrecord(p, parse_fn, check_crc)
                         for p in _matched(paths)])


class TFRecordWriter:
    """Append records to a TFRecord file (a context manager)."""

    def __init__(self, path: str):
        self._path = path
        self._lib = _native.load()
        self.route = _native.record_route("tfrecord_write",
                                          self._lib is not None)
        if self._lib is not None:
            self._h = self._lib.zoo_tfr_writer_open(path.encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
            self._f = None
        else:
            self._h = None
            self._f = open(path, "wb")

    def write(self, record: bytes):
        if self._h is not None:
            buf = (ctypes.c_uint8 * len(record)).from_buffer_copy(record)
            if self._lib.zoo_tfr_writer_write(self._h, buf, len(record)):
                raise IOError(f"write failed: {self._path}")
        else:
            hdr = struct.pack("<Q", len(record))
            self._f.write(hdr)
            self._f.write(struct.pack("<I", _masked_crc(hdr)))
            self._f.write(record)
            self._f.write(struct.pack("<I", _masked_crc(record)))

    def close(self):
        if self._h is not None:
            self._lib.zoo_tfr_writer_close(self._h)
            self._h = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_tfrecord(path: str, records: Iterable[bytes]):
    with TFRecordWriter(path) as w:
        for r in records:
            w.write(r)
