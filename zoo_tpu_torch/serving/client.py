"""Cluster Serving client: the reference's Redis wire format (own copy of
``zoo_tpu/serving/client.py``).

``InputQueue.enqueue(uri, **data)`` XADDs ``{uri, data: b64(Arrow
record batch)}`` onto the ``serving_stream`` Redis stream; the serving
job answers with ``HSET cluster-serving_<stream>:<uri> value
b64(Arrow)``, read back by ``OutputQueue.query`` / ``dequeue``. The
schema is the reference's: a tensor is a struct column of four list
rows (``indiceData``, ``indiceShape``, ``data``, ``shape``), a string
list one ``|``-joined string, shorter columns null-padded to the
batch's length. The bytes are Arrow's IPC stream, written and read by
:mod:`zoo_tpu_torch.serving.arrow_ipc` (no ``pyarrow``), so a client or
a serving job of either package talks to the other, and to a real Redis
as well as the embedded one.
"""

from __future__ import annotations

import base64
import json
import time
import uuid
from typing import Dict, Optional

import numpy as np

from zoo_tpu_torch.serving import arrow_ipc as A
from zoo_tpu_torch.serving.resp import RedisClient, RedisError

RESULT_PREFIX = "cluster-serving_"

_TENSOR_FIELDS = (A.Field("indiceData", A.list_(A.int32())),
                  A.Field("indiceShape", A.list_(A.int32())),
                  A.Field("data", A.list_(A.float32())),
                  A.Field("shape", A.list_(A.int32())))
_TENSOR_TYPE = A.struct(_TENSOR_FIELDS)


def _tensor_column(rows) -> A.Array:
    """The struct column of a tensor: row ``i`` holds ``rows[i]`` in its
    ``i``-th field and nulls in the others (``pa.array([{"indiceData":
    ...}, {"indiceShape": ...}, {"data": ...}, {"shape": ...}])``)."""
    kids = []
    for i, f in enumerate(_TENSOR_FIELDS):
        lists = [None] * len(_TENSOR_FIELDS)
        lists[i] = rows[i]
        kids.append(A.list_array(lists, f.type.children[0].type))
    return A.struct_array(_TENSOR_FIELDS, kids)


def get_field_and_data(key, value):
    """The Arrow field and column of one input: a dense ndarray, a sparse
    ``[indices, values, shape]`` list, a string, a list of strings
    (joined with ``|``) or an image dict (``b64``, or ``path`` to read
    and encode)."""
    if isinstance(value, list):
        if not value:
            raise ValueError("empty list is not supported")
        if isinstance(value[0], str):
            return A.Field(key, A.utf8()), A.string_array(["|".join(value)])
        if isinstance(value[0], np.ndarray):
            if len(value) != 3:
                raise ValueError("sparse tensor needs [indices, values, "
                                 "shape]")
            indices, values, shape = value
            return A.Field(key, _TENSOR_TYPE), _tensor_column([
                indices.astype("int32").flatten(),
                np.asarray(indices.shape, "int32"),
                np.asarray(values, "float32").flatten(),
                np.asarray(shape, "int32")])
        raise TypeError("list of str or ndarray expected")
    if isinstance(value, str):
        return A.Field(key, A.utf8()), A.string_array([value])
    if isinstance(value, dict):
        b64 = value.get("b64")
        if b64 is None and "path" in value:
            with open(value["path"], "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
        if b64 is None:
            raise TypeError("dict input needs 'path' or 'b64'")
        return A.Field(key, A.utf8()), A.string_array([b64])
    if isinstance(value, np.ndarray):
        return A.Field(key, _TENSOR_TYPE), _tensor_column([
            np.zeros(0, "int32"), np.zeros(0, "int32"),
            value.astype("float32").flatten(),
            np.asarray(value.shape, "int32")])
    raise TypeError(f"unsupported input type {type(value)}")


def _b64(fields, columns) -> str:
    return base64.b64encode(A.write_stream(fields, [columns])).decode()


def _batches(b64str: str):
    return A.read_stream(base64.b64decode(b64str))


def encode_ndarray_b64(arr: np.ndarray) -> str:
    """A result as the serving sink writes it: a record batch of a
    float32 ``data`` column and an int32 ``shape`` column, the shorter
    null-padded (a 0-d array's shape is written ``[1]``)."""
    arr = np.asarray(arr)
    flat = arr.astype("float32").reshape(-1)
    shape = list(arr.shape) or [1]
    n = max(len(flat), len(shape))
    data = A.concat_nulls(A.primitive_array(flat, A.float32()),
                          n - len(flat))
    dims = A.concat_nulls(A.primitive_array(shape, A.int32()),
                          n - len(shape))
    return _b64([A.Field("data", A.float32()), A.Field("shape", A.int32())],
                [data, dims])


def decode_ndarray_b64(b64str: str):
    """A result written by :func:`encode_ndarray_b64` (either package's),
    as float32 of its shape; a list where the stream holds several
    batches."""
    _, batches = _batches(b64str)
    outs = []
    for columns in batches:
        data = A.to_numpy(columns[0])
        shape = [s for s in A.to_pylist(columns[1]) if s is not None]
        n = int(np.prod(shape)) if shape else len(data)
        outs.append(np.asarray(data[:n]).reshape(shape))
    return outs[0] if len(outs) == 1 else outs


def encode_input_b64(**data) -> str:
    """A request as ``InputQueue.enqueue`` XADDs it: one column per
    keyword, the shorter columns null-padded (tensors are 4-row structs,
    strings 1 row)."""
    fields, columns = [], []
    for key, value in data.items():
        f, col = get_field_and_data(key, value)
        fields.append(f)
        columns.append(col)
    n = max(len(c) for c in columns)
    return _b64(fields, [A.concat_nulls(c, n - len(c)) for c in columns])


def _first(col: A.Array, name: str, as_array: bool):
    """``next(r[name] for r in rows if r and r.get(name))`` over a struct
    column's rows: the first non-empty ``name`` entry of a valid row, as
    float32 values (``as_array``) or a Python list; ``None`` if none."""
    names = [f.name for f in col.type.children]
    if name not in names:
        return None
    child = col.children[names.index(name)]
    numeric_list = child.type.kind == "list" and \
        child.type.children[0].type.kind in ("int", "float")
    for i in range(col.length):
        if not (col.is_valid(i) and child.is_valid(i)):
            continue
        if as_array and numeric_list:
            vals = A.list_values(child, i)
            if len(vals):
                return vals.astype(np.float32)
            continue
        val = A.row(child, i)
        if val:
            return val
    return None


def decode_input_b64(b64str: str) -> Dict[str, np.ndarray]:
    """The serving side's decode of ``enqueue``'s payload: a tensor
    column as float32 of its shape (its ``data`` and ``shape`` rows), any
    other column as its first row's value."""
    fields, batches = _batches(b64str)
    out: Dict[str, np.ndarray] = {}
    for columns in batches:
        for field, col in zip(fields, columns):
            if field.type.kind == "struct":
                data = _first(col, "data", as_array=True)
                shape = _first(col, "shape", as_array=False)
                arr = np.asarray([] if data is None else data, np.float32)
                if shape:
                    arr = arr.reshape([s for s in shape if s is not None])
                out[field.name] = arr
            else:
                out[field.name] = A.row(col, 0)
    return out


class API:
    """Connect to Redis and make sure the consumer group exists."""

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None, name: str = "serving_stream"):
        self.name = name
        self.host = host or "localhost"
        self.port = int(port or 6379)
        self.db = RedisClient(self.host, self.port)
        try:
            self.db.xgroup_create(name, "serving", "$")
        except RedisError:
            pass  # the group exists


class InputQueue(API):
    def __init__(self, frontend_url: Optional[str] = None, **kwargs):
        self.frontend_url = frontend_url
        if frontend_url is None:
            super().__init__(**kwargs)
            self.output_queue = OutputQueue(**kwargs)
        self.input_threshold = 0.6
        self.interval_if_error = 1

    def enqueue(self, uri: str, **data):
        self._enqueue_data({"uri": uri, "data": encode_input_b64(**data)})

    def predict(self, request_data, timeout: float = 10.0):
        """Synchronous predict through the queue, or through the HTTP
        front end when one is configured: the reply's decoded array,
        ``"NaN"`` for a failed record, ``"[]"`` on timeout."""
        if self.frontend_url:
            import urllib.request

            req = urllib.request.Request(
                self.frontend_url + "/predict",
                data=request_data.encode()
                if isinstance(request_data, str) else request_data,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode())["predictions"]
        if isinstance(request_data, str):
            parsed = json.loads(request_data)["instances"][0]
            input_dict = {k: np.asarray(v) for k, v in parsed.items()}
        elif isinstance(request_data, dict):
            input_dict = request_data
        else:
            input_dict = {"t": request_data}
        uri = str(uuid.uuid4())
        self.enqueue(uri, **input_dict)
        deadline = time.monotonic() + timeout
        wait = 0.001
        while time.monotonic() < deadline:
            out = self.output_queue.query_and_delete(uri)
            if not isinstance(out, str) or out != "[]":
                return out
            time.sleep(wait)
            wait = min(wait * 2, 0.1)
        return "[]"

    def _enqueue_data(self, data: Dict[str, str]):
        info = self.db.info()
        maxmem = int(info.get("maxmemory", 0) or 0)
        if maxmem and info.get("used_memory", 0) >= \
                maxmem * self.input_threshold:
            raise RuntimeError("redis memory above input threshold; wait "
                               "for inference or delete records")
        self.db.xadd(self.name, data)


class OutputQueue(API):
    def dequeue(self) -> Dict[str, np.ndarray]:
        """Every result on the stream's hashes, deleted as read."""
        res = {}
        for key in self.db.keys(RESULT_PREFIX + self.name + ":*"):
            h = self.db.hgetall(key)
            uri = key.decode().split(":", 1)[1]
            val = h.get(b"value", b"").decode()
            res[uri] = "NaN" if val == "NaN" else decode_ndarray_b64(val)
            self.db.delete(key)
        return res

    def query_and_delete(self, uri: str):
        return self.query(uri, delete=True)

    def query(self, uri: str, delete: bool = False):
        """The result of ``uri``: its array, ``"NaN"``, or ``"[]"`` while
        there is none."""
        key = RESULT_PREFIX + self.name + ":" + uri
        h = self.db.hgetall(key)
        if not h:
            return "[]"
        if delete:
            self.db.delete(key)
        val = h[b"value"].decode()
        if val == "NaN":
            return val
        return decode_ndarray_b64(val)


def http_response_to_ndarray(response) -> np.ndarray:
    """A front end's ``/predict`` reply (a ``requests`` response or its
    JSON text) as an ndarray."""
    text = getattr(response, "text", response)
    body = json.loads(text) if isinstance(text, str) else text
    if isinstance(body, dict):
        for key in ("predictions", "prediction", "result", "value"):
            if key in body:
                body = body[key]
                break
    if isinstance(body, list) and body and isinstance(body[0], str):
        return np.stack([decode_ndarray_b64(b) for b in body])
    if isinstance(body, str):
        return decode_ndarray_b64(body)
    return np.asarray(body)
