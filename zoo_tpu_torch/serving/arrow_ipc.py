"""The Arrow IPC stream format, by hand, for the Cluster Serving codecs.

The serving wire carries Arrow record batches (base64 of an IPC stream:
``client.py``). The JAX package reads and writes them with ``pyarrow``;
the port does not depend on it, and reads and writes the same bytes
with this module, in Python and numpy. It covers what the four codecs
need and nothing more:

* the encapsulated message framing: the ``0xFFFFFFFF`` continuation
  marker, the metadata length, the flatbuffer ``Message`` padded to 8
  bytes, the body (each buffer at an 8-byte offset), and the
  end-of-stream marker (a zero length);
* ``Schema`` and ``RecordBatch`` messages (no dictionaries, no
  compression), metadata version V5;
* the types ``Int`` (8-64 bits), ``FloatingPoint`` (16-64 bits),
  ``Utf8``, ``List`` and ``Struct_``, with validity bitmaps at every
  level (a struct's rows, its list children and their items).

A column is an :class:`Array`: its type, length, validity (``None``
when no slot is null) and buffers as numpy arrays. Flatbuffers are read
through their vtables and written front to back, each object after the
offset that points at it, scalars at their natural alignment (what the
flatbuffers verifier pyarrow runs checks).
"""

from __future__ import annotations

import struct as _bin
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ArrowType", "Field", "Array", "int32", "float32", "utf8",
           "list_", "struct", "primitive_array", "string_array",
           "list_array", "struct_array", "concat_nulls",
           "write_stream", "read_stream", "to_pylist", "to_numpy", "row",
           "list_values"]

_CONTINUATION = 0xFFFFFFFF
_V5 = 4                        # MetadataVersion.V5
# MessageHeader union
_SCHEMA, _RECORD_BATCH = 1, 3
# Type union
_T_INT, _T_FLOAT, _T_UTF8, _T_LIST, _T_STRUCT = 2, 3, 5, 12, 13
_PRECISION = {0: np.float16, 1: np.float32, 2: np.float64}


class ArrowType(NamedTuple):
    """``kind`` is ``int``, ``float``, ``utf8``, ``list`` or ``struct``;
    ``dtype`` the numpy dtype of an int or float type's values;
    ``children`` the child fields of a list (one, ``item``) or a
    struct."""
    kind: str
    dtype: Optional[np.dtype] = None
    children: Tuple["Field", ...] = ()

    def __str__(self):
        if self.kind in ("int", "float"):
            return str(self.dtype)
        if self.kind == "utf8":
            return "string"
        inner = ", ".join(f"{c.name}: {c.type}" for c in self.children)
        return f"{self.kind}<{inner}>"


class Field(NamedTuple):
    name: str
    type: ArrowType
    nullable: bool = True


def int32() -> ArrowType:
    return ArrowType("int", np.dtype("<i4"))


def float32() -> ArrowType:
    return ArrowType("float", np.dtype("<f4"))


def utf8() -> ArrowType:
    return ArrowType("utf8")


def list_(value_type: ArrowType) -> ArrowType:
    return ArrowType("list", children=(Field("item", value_type),))


def struct(fields: Sequence[Field]) -> ArrowType:
    return ArrowType("struct", children=tuple(fields))


class Array:
    """One column (or a child of one): ``valid`` is a bool array of
    ``length`` or ``None`` (no nulls); ``values`` the items of an int or
    float array; ``offsets`` (``length + 1`` int32) of a list or utf8
    array, whose items are ``children[0]`` or the bytes ``data``;
    ``children`` a struct's columns, each of ``length`` rows."""

    __slots__ = ("type", "length", "valid", "values", "offsets", "data",
                 "children")

    def __init__(self, type: ArrowType, length: int,
                 valid: Optional[np.ndarray] = None, values=None,
                 offsets=None, data: bytes = b"", children=()):
        self.type, self.length = type, int(length)
        self.valid = None if valid is None or valid.all() else \
            np.asarray(valid, bool)
        self.values, self.offsets, self.data = values, offsets, data
        self.children = list(children)

    @property
    def null_count(self) -> int:
        return 0 if self.valid is None else \
            int(self.length - self.valid.sum())

    def is_valid(self, i: int) -> bool:
        return self.valid is None or bool(self.valid[i])

    def __len__(self):
        return self.length


# -- building columns ---------------------------------------------------------
def primitive_array(values, type: ArrowType,
                    valid: Optional[np.ndarray] = None) -> Array:
    values = np.ascontiguousarray(values, dtype=type.dtype).reshape(-1)
    return Array(type, len(values), valid, values=values)


def string_array(values: Sequence[Optional[str]]) -> Array:
    """A utf8 column of ``values`` (``None`` for a null)."""
    enc = [b"" if v is None else v.encode() for v in values]
    offsets = np.zeros(len(enc) + 1, np.int32)
    offsets[1:] = np.cumsum([len(e) for e in enc])
    valid = np.array([v is not None for v in values], bool)
    return Array(utf8(), len(enc), valid, offsets=offsets,
                 data=b"".join(enc))


def list_array(lists: Sequence[Optional[np.ndarray]],
               value_type: ArrowType) -> Array:
    """A list column, one row per entry of ``lists`` (``None`` for a
    null row)."""
    lens = [0 if v is None else len(v) for v in lists]
    offsets = np.zeros(len(lists) + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    parts = [np.asarray(v, value_type.dtype).reshape(-1)
             for v in lists if v is not None]
    items = np.concatenate(parts) if parts else \
        np.zeros(0, value_type.dtype)
    valid = np.array([v is not None for v in lists], bool)
    return Array(list_(value_type), len(lists), valid, offsets=offsets,
                 children=[primitive_array(items, value_type)])


def struct_array(fields: Sequence[Field], children: Sequence[Array],
                 valid: Optional[np.ndarray] = None) -> Array:
    n = len(children[0]) if children else 0
    if any(len(c) != n for c in children):
        raise ValueError("struct children of different lengths")
    return Array(struct(fields), n, valid, children=children)


def concat_nulls(a: Array, n: int) -> Array:
    """``a`` followed by ``n`` null rows (the JAX codecs pad the shorter
    columns of a record batch so: ``pa.concat_arrays([a,
    pa.nulls(n)])``)."""
    if n == 0:
        return a
    valid = np.concatenate([np.ones(a.length, bool) if a.valid is None
                            else a.valid, np.zeros(n, bool)])
    kind = a.type.kind
    if kind in ("int", "float"):
        return Array(a.type, a.length + n, valid, values=np.concatenate(
            [a.values[:a.length], np.zeros(n, a.type.dtype)]))
    if kind in ("utf8", "list"):
        offsets = np.concatenate([a.offsets[:a.length + 1], np.full(
            n, a.offsets[a.length], np.int32)])
        return Array(a.type, a.length + n, valid, offsets=offsets,
                     data=a.data, children=a.children)
    return Array(a.type, a.length + n, valid,
                 children=[concat_nulls(c, n) for c in a.children])


# -- reading columns ----------------------------------------------------------
def to_pylist(a: Array) -> list:
    """The rows of ``a`` as Python objects (``None`` for a null; a
    struct row as a dict), as ``pyarrow``'s ``to_pylist`` gives them."""
    return [row(a, i) for i in range(a.length)]


def row(a: Array, i: int):
    """Row ``i`` of ``a`` as :func:`to_pylist` gives it."""
    if not a.is_valid(i):
        return None
    kind = a.type.kind
    if kind in ("int", "float"):
        return a.values[i].item()
    if kind == "utf8":
        return a.data[a.offsets[i]:a.offsets[i + 1]].decode()
    if kind == "list":
        child = a.children[0]
        return [row(child, j)
                for j in range(a.offsets[i], a.offsets[i + 1])]
    return {f.name: row(c, i)
            for f, c in zip(a.type.children, a.children)}


def to_numpy(a: Array) -> np.ndarray:
    """The values of an int or float column, nulls as NaN in a float
    column (``pyarrow``'s ``to_numpy(zero_copy_only=False)``)."""
    if a.type.kind not in ("int", "float"):
        raise TypeError(f"to_numpy of a {a.type} column")
    vals = a.values[:a.length]
    if a.valid is None:
        return vals.copy()
    if a.type.kind == "float":
        out = vals.copy()
        out[~a.valid] = np.nan
        return out
    out = vals.astype(np.float64)
    out[~a.valid] = np.nan
    return out


def list_values(a: Array, i: int) -> Optional[np.ndarray]:
    """Row ``i`` of a list column of ints or floats as a numpy array
    (``None`` for a null row)."""
    if not a.is_valid(i):
        return None
    return to_numpy(_slice(a.children[0], a.offsets[i], a.offsets[i + 1]))


def _slice(a: Array, start: int, stop: int) -> Array:
    return Array(a.type, stop - start, None if a.valid is None
                 else a.valid[start:stop], values=a.values[start:stop])


# -- flatbuffers: reading ------------------------------------------------------
class _Table:
    """A flatbuffer table at ``pos`` of ``buf``, read through its
    vtable; an absent field reads as its default."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - _bin.unpack_from("<i", buf, pos)[0]
        self.vt_len = _bin.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        o = 4 + 2 * slot
        if o >= self.vt_len:
            return 0
        off = _bin.unpack_from("<H", self.buf, self.vt + o)[0]
        return self.pos + off if off else 0

    def scalar(self, slot: int, fmt: str, default=0):
        p = self._field(slot)
        return _bin.unpack_from("<" + fmt, self.buf, p)[0] if p \
            else default

    def _deref(self, p: int) -> int:
        return p + _bin.unpack_from("<I", self.buf, p)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        p = self._field(slot)
        return _Table(self.buf, self._deref(p)) if p else None

    def vector(self, slot: int) -> Tuple[int, int]:
        """(start of the elements, count); (0, 0) if absent."""
        p = self._field(slot)
        if not p:
            return 0, 0
        v = self._deref(p)
        return v + 4, _bin.unpack_from("<I", self.buf, v)[0]

    def tables(self, slot: int) -> List["_Table"]:
        start, n = self.vector(slot)
        return [_Table(self.buf, self._deref(start + 4 * i))
                for i in range(n)]

    def string(self, slot: int) -> Optional[str]:
        start, n = self.vector(slot)
        return self.buf[start:start + n].decode() if start else None

    def structs(self, slot: int, fmt: str) -> List[tuple]:
        start, n = self.vector(slot)
        size = _bin.calcsize("<" + fmt)
        return [_bin.unpack_from("<" + fmt, self.buf, start + i * size)
                for i in range(n)]


def _root(buf: bytes) -> _Table:
    return _Table(buf, _bin.unpack_from("<I", buf, 0)[0])


# -- flatbuffers: writing ------------------------------------------------------
class _T(NamedTuple):
    """A table to write: ``fields`` of (slot, struct format or ``off``,
    value); an ``off`` field's value is a child object."""
    fields: tuple


class _Str(NamedTuple):
    value: bytes


class _Tables(NamedTuple):
    items: tuple


class _Structs(NamedTuple):
    data: bytes
    count: int


class _FlatWriter:
    """Front-to-back flatbuffer writer: the root offset, then each object
    before the objects it points at (an offset is unsigned and points
    forward), every scalar at its natural alignment from the start."""

    def __init__(self):
        self.buf = bytearray(4)

    def finish(self, root: _T) -> bytes:
        pos = self._write(root)
        _bin.pack_into("<I", self.buf, 0, pos)
        self._pad(8)
        return bytes(self.buf)

    def _pad(self, align: int, rem: int = 0):
        self.buf += b"\0" * ((rem - len(self.buf)) % align)

    def _write(self, obj) -> int:
        if isinstance(obj, _T):
            return self._table(obj)
        if isinstance(obj, _Str):
            self._pad(4)
            pos = len(self.buf)
            self.buf += _bin.pack("<I", len(obj.value)) + obj.value + b"\0"
            return pos
        if isinstance(obj, _Structs):
            self._pad(8, 4)           # elements 8-aligned after the count
            pos = len(self.buf)
            self.buf += _bin.pack("<I", obj.count) + obj.data
            return pos
        self._pad(4)                  # a vector of tables
        pos = len(self.buf)
        self.buf += _bin.pack("<I", len(obj.items))
        self.buf += b"\0" * (4 * len(obj.items))
        for i, item in enumerate(obj.items):
            slot = pos + 4 + 4 * i
            _bin.pack_into("<I", self.buf, slot, self._write(item) - slot)
        return pos

    def _table(self, t: _T) -> int:
        sizes = {f: (4 if fmt == "off" else _bin.calcsize("<" + fmt))
                 for f, (_, fmt, _) in enumerate(t.fields)}
        order = sorted(range(len(t.fields)), key=lambda f: -sizes[f])
        align = max([4] + list(sizes.values()))
        n_slots = 1 + max((s for s, _, _ in t.fields), default=-1)
        vt_size = 4 + 2 * n_slots
        self._pad(2)
        vt = len(self.buf)
        self.buf += b"\0" * vt_size
        self._pad(align)
        pos = len(self.buf)
        offs, cur = {}, 4
        for f in order:
            cur += -cur % sizes[f]
            offs[f] = cur
            cur += sizes[f]
        self.buf += b"\0" * cur
        _bin.pack_into("<i", self.buf, pos, pos - vt)
        _bin.pack_into("<HH", self.buf, vt, vt_size, cur)
        for f, (slot, fmt, value) in enumerate(t.fields):
            _bin.pack_into("<H", self.buf, vt + 4 + 2 * slot, offs[f])
            if fmt != "off":
                _bin.pack_into("<" + fmt, self.buf, pos + offs[f], value)
        for f, (slot, fmt, value) in enumerate(t.fields):
            if fmt == "off":
                at = pos + offs[f]
                _bin.pack_into("<I", self.buf, at, self._write(value) - at)
        return pos


# -- schema --------------------------------------------------------------------
def _type_table(t: ArrowType) -> Tuple[int, _T]:
    if t.kind == "int":
        return _T_INT, _T(((0, "i", t.dtype.itemsize * 8),
                           (1, "B", int(t.dtype.kind == "i"))))
    if t.kind == "float":
        prec = {2: 0, 4: 1, 8: 2}[t.dtype.itemsize]
        return _T_FLOAT, _T(((0, "h", prec),))
    return {"utf8": _T_UTF8, "list": _T_LIST,
            "struct": _T_STRUCT}[t.kind], _T(())


def _field_table(f: Field) -> _T:
    code, type_table = _type_table(f.type)
    return _T(((0, "off", _Str(f.name.encode())),
               (1, "B", int(f.nullable)),
               (2, "B", code),
               (3, "off", type_table),
               (5, "off", _Tables(tuple(_field_table(c)
                                        for c in f.type.children)))))


def _read_type(code: int, t: Optional[_Table],
               children: List[Field]) -> ArrowType:
    if code == _T_INT:
        bits, signed = t.scalar(0, "i"), t.scalar(1, "B")
        return ArrowType("int", np.dtype(f"<{'i' if signed else 'u'}"
                                         f"{bits // 8}"))
    if code == _T_FLOAT:
        return ArrowType("float", np.dtype(_PRECISION[t.scalar(0, "h")]))
    if code == _T_UTF8:
        return utf8()
    if code == _T_LIST:
        return ArrowType("list", children=tuple(children))
    if code == _T_STRUCT:
        return ArrowType("struct", children=tuple(children))
    raise ValueError(f"Arrow type {code} is not read here (int, float, "
                     "utf8, list and struct are)")


def _read_field(t: _Table) -> Field:
    children = [_read_field(c) for c in t.tables(5)]
    if t.table(4) is not None:
        raise ValueError("dictionary-encoded fields are not read here")
    return Field(t.string(0) or "",
                 _read_type(t.scalar(2, "B"), t.table(3), children),
                 bool(t.scalar(1, "B")))


# -- record batches ------------------------------------------------------------
def _bitmap(valid: np.ndarray) -> bytes:
    return np.packbits(valid, bitorder="little").tobytes()


def _flatten(a: Array, nodes: list, bufs: list):
    """Field nodes and buffers of ``a`` in the IPC order (pre-order)."""
    nodes.append((a.length, a.null_count))
    bufs.append(b"" if a.valid is None else _bitmap(a.valid))
    kind = a.type.kind
    if kind in ("int", "float"):
        bufs.append(a.values[:a.length].tobytes())
    elif kind == "utf8":
        bufs.append(a.offsets[:a.length + 1].astype("<i4").tobytes())
        bufs.append(bytes(a.data[:int(a.offsets[a.length])]))
    elif kind == "list":
        bufs.append(a.offsets[:a.length + 1].astype("<i4").tobytes())
        _flatten(a.children[0], nodes, bufs)
    else:
        for c in a.children:
            _flatten(c, nodes, bufs)


def _message(header_type: int, header: _T, body_len: int) -> bytes:
    meta = _FlatWriter().finish(_T(((0, "h", _V5), (1, "B", header_type),
                                 (2, "off", header), (3, "q", body_len))))
    return _bin.pack("<II", _CONTINUATION, len(meta)) + meta


def write_stream(fields: Sequence[Field],
                 batches: Sequence[Sequence[Array]]) -> bytes:
    """An IPC stream: the schema of ``fields``, one record batch per
    entry of ``batches`` (one :class:`Array` per field, all of one
    length), then the end-of-stream marker."""
    out = [_message(_SCHEMA, _T(((1, "off", _Tables(tuple(
        _field_table(f) for f in fields))),)), 0)]
    for columns in batches:
        if len(columns) != len(fields):
            raise ValueError(f"{len(columns)} columns for {len(fields)} "
                             "fields")
        n = len(columns[0]) if columns else 0
        if any(len(c) != n for c in columns):
            raise ValueError("record batch columns of different lengths")
        nodes, bufs = [], []
        for col in columns:
            _flatten(col, nodes, bufs)
        body, specs = bytearray(), []
        for b in bufs:
            specs.append((len(body), len(b)))
            body += b
            body += b"\0" * (-len(body) % 8)
        header = _T(((0, "q", n),
                     (1, "off", _Structs(b"".join(
                         _bin.pack("<qq", *x) for x in nodes),
                         len(nodes))),
                     (2, "off", _Structs(b"".join(
                         _bin.pack("<qq", *x) for x in specs),
                         len(specs)))))
        out.append(_message(_RECORD_BATCH, header, len(body)))
        out.append(bytes(body))
    out.append(_bin.pack("<II", _CONTINUATION, 0))
    return b"".join(out)


class _Reader:
    def __init__(self, nodes, buffers, body: memoryview):
        self.nodes, self.buffers, self.body = iter(nodes), iter(buffers), body

    def _buf(self) -> memoryview:
        off, n = next(self.buffers)
        if off + n > len(self.body):
            raise ValueError("an Arrow buffer runs past the message body")
        return self.body[off:off + n]

    def array(self, t: ArrowType) -> Array:
        length, null_count = next(self.nodes)
        vbuf = self._buf()
        valid = None
        if null_count and len(vbuf):
            valid = np.unpackbits(np.frombuffer(vbuf, np.uint8),
                                  bitorder="little")[:length].astype(bool)
        if t.kind in ("int", "float"):
            values = np.frombuffer(self._buf(), t.dtype, count=length)
            return Array(t, length, valid, values=values)
        if t.kind in ("utf8", "list"):
            obuf = self._buf()
            offsets = np.frombuffer(obuf, "<i4", count=length + 1) \
                if len(obuf) else np.zeros(length + 1, np.int32)
            if t.kind == "utf8":
                return Array(t, length, valid, offsets=offsets,
                             data=bytes(self._buf()))
            return Array(t, length, valid, offsets=offsets,
                         children=[self.array(t.children[0].type)])
        return Array(t, length, valid,
                     children=[self.array(c.type) for c in t.children])


def _messages(buf: bytes):
    """(flatbuffer Message, body) of each message up to the end-of-stream
    marker (or the end of ``buf``)."""
    pos = 0
    while pos + 8 <= len(buf):
        marker, n = _bin.unpack_from("<II", buf, pos)
        if marker != _CONTINUATION:
            raise ValueError("not an Arrow IPC stream (no continuation "
                             "marker)")
        pos += 8
        if n == 0:
            break
        msg = _root(buf[pos:pos + n])
        pos += n
        body_len = msg.scalar(3, "q")
        yield msg, memoryview(buf)[pos:pos + body_len]
        pos += body_len


def read_stream(buf: bytes) -> Tuple[List[Field], List[List[Array]]]:
    """The schema's fields and each record batch's columns of an IPC
    stream."""
    fields, batches = None, []
    for msg, body in _messages(buf):
        kind, header = msg.scalar(1, "B"), msg.table(2)
        if kind == _SCHEMA:
            fields = [_read_field(f) for f in header.tables(1)]
        elif kind == _RECORD_BATCH:
            if fields is None:
                raise ValueError("a record batch before the schema")
            if header.table(3) is not None:
                raise ValueError("compressed Arrow bodies are not read here")
            reader = _Reader(header.structs(1, "qq"),
                             header.structs(2, "qq"), body)
            batches.append([reader.array(f.type) for f in fields])
        else:
            raise ValueError(f"Arrow message type {kind} is not read here")
    if fields is None:
        raise ValueError("no Arrow schema in the stream")
    return fields, batches
