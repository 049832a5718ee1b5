"""Non-executable wire codec for the serving TCP door (counterpart of
``zoo_tpu/serving/codec.py``, whole: the two packages' frames are byte
for byte the same).

Replaces pickle on the socket (an unauthenticated ``pickle.loads`` is
remote code execution the moment the port is reachable): messages are a
JSON structure tree plus raw little-endian array buffers — nothing in the
frame can execute on either end. Supported values: dict / list / tuple /
str / int / float / bool / None / numpy ndarray (+ numpy scalars).

Frame: ``ZSRV`` magic + u32 header length + JSON header + concatenated
array buffers. Arrays appear in the JSON as
``{"__nd__": i, "dtype": ..., "shape": ...}`` placeholders indexing the
buffer list; tuples as ``{"__tuple__": [...]}``.
"""

from __future__ import annotations

import json
import struct
from typing import Any, List, Tuple

import numpy as np

_MAGIC = b"ZSRV"

# object/str dtypes could smuggle pickled payloads via np.frombuffer
# misuse on the peer; whitelist plain numeric/bool kinds only
_OK_KINDS = frozenset("biufc")


def _pack(obj: Any, bufs: List[bytes]):
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind not in _OK_KINDS:
            raise TypeError(f"unsupported array dtype {obj.dtype} "
                            "(numeric/bool arrays only)")
        idx = len(bufs)
        bufs.append(np.ascontiguousarray(obj).tobytes())
        return {"__nd__": idx, "dtype": obj.dtype.str,
                "shape": list(obj.shape)}
    if isinstance(obj, np.generic):
        return _pack(np.asarray(obj), bufs)
    if isinstance(obj, tuple):
        return {"__tuple__": [_pack(v, bufs) for v in obj]}
    if isinstance(obj, list):
        return [_pack(v, bufs) for v in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("dict keys must be str on the wire")
            if k in ("__nd__", "__tuple__"):
                raise TypeError(
                    f"dict key {k!r} is reserved by the wire format")
            out[k] = _pack(v, bufs)
        return out
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):  # a CPU tensor
        return _pack(np.asarray(obj), bufs)
    raise TypeError(f"unsupported wire type: {type(obj).__name__}")


def _unpack(node: Any, bufs: List[bytes]):
    if isinstance(node, dict):
        if "__nd__" in node:
            idx = node["__nd__"]
            if not isinstance(idx, int) or not 0 <= idx < len(bufs):
                raise ValueError("malformed frame")
            try:
                dt = np.dtype(node["dtype"])
                if dt.kind not in _OK_KINDS:
                    # mirror the encode-side whitelist: a wire-supplied
                    # unicode/object/structured dtype must die here as a
                    # protocol error, not deep inside the model
                    raise ValueError(f"dtype kind {dt.kind!r}")
                arr = np.frombuffer(bufs[idx], dtype=dt)
                # copy: frombuffer views are read-only; callers expect
                # mutable arrays (the old pickle wire returned them)
                return arr.reshape(node["shape"]).copy()
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError("malformed frame") from e
        if "__tuple__" in node:
            return tuple(_unpack(v, bufs) for v in node["__tuple__"])
        return {k: _unpack(v, bufs) for k, v in node.items()}
    if isinstance(node, list):
        return [_unpack(v, bufs) for v in node]
    return node


def dumps(obj: Any) -> bytes:
    bufs: List[bytes] = []
    tree = _pack(obj, bufs)
    header = json.dumps({"tree": tree,
                         "bufs": [len(b) for b in bufs]}).encode()
    return (_MAGIC + struct.pack(">I", len(header)) + header
            + b"".join(bufs))


def loads(blob: bytes) -> Any:
    if blob[:4] != _MAGIC:
        raise ValueError("bad frame magic (not a zoo serving message)")
    if len(blob) < 8:
        raise ValueError("malformed frame")
    (hlen,) = struct.unpack(">I", blob[4:8])
    if 8 + hlen > len(blob):
        raise ValueError("malformed frame")
    try:
        head = json.loads(blob[8:8 + hlen].decode())
        lens = head["bufs"]
        tree = head["tree"]
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError,
            TypeError) as e:
        raise ValueError("malformed frame") from e
    # declared buffer lengths must tile the frame body exactly — a
    # wire-supplied over-length otherwise surfaces as a confusing
    # numpy error deep inside _unpack instead of a protocol error here
    if (not isinstance(lens, list)
            or any(not isinstance(n, int) or n < 0 for n in lens)
            or 8 + hlen + sum(lens) != len(blob)):
        raise ValueError("malformed frame")
    bufs: List[bytes] = []
    off = 8 + hlen
    for n in lens:
        bufs.append(blob[off:off + n])
        off += n
    return _unpack(tree, bufs)
