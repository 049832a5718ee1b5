"""TensorBoard event files: own writer + scalar read-back (counterpart
of ``zoo_tpu/tensorboard/__init__.py``, the same file format).

A self-contained event-file writer with CRC32C-framed records, a
background flush thread, and scalar read-back powering
``get_train_summary(tag)`` / ``get_validation_summary(tag)``. No
tensorboard/tensorboardX dependency: Event/Summary protos are
hand-encoded (``proto.py``), record framing is the TFRecord layout with
its masked CRC32C computed here (:func:`crc32c`, a table-driven pure
Python CRC), and the files open in stock TensorBoard and in the JAX
package's reader.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from zoo_tpu_torch.tensorboard import proto

_FILE_VERSION = "brain.Event:2"

# Event proto fields (tensorflow/core/util/event.proto)
_EV_WALL_TIME = 1   # double
_EV_STEP = 2        # int64
_EV_FILE_VERSION = 3  # string
_EV_SUMMARY = 5     # Summary
# Summary / Summary.Value fields (tensorflow/core/framework/summary.proto)
_SUM_VALUE = 1
_VAL_TAG = 1
_VAL_SIMPLE = 2
_VAL_TENSOR = 8     # TF2 tf.summary.scalar writes a TensorProto instead
# TensorProto fields (tensorflow/core/framework/tensor.proto)
_TP_DTYPE = 1
_TP_CONTENT = 4
_TP_FLOAT_VAL = 5
_TP_DOUBLE_VAL = 6
_DT_FLOAT, _DT_DOUBLE = 1, 2


def _crc32c_table() -> List[int]:
    # reflected Castagnoli polynomial
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
        tbl.append(c)
    return tbl


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    tbl = _CRC32C_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """The TFRecord framing's masked CRC32C."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def scalar_event(tag: str, value: float, step: int,
                 wall_time: Optional[float] = None) -> bytes:
    sval = (proto.field_bytes(_VAL_TAG, tag.encode()) +
            proto.field_float(_VAL_SIMPLE, float(value)))
    summary = proto.field_message(_SUM_VALUE, sval)
    return (proto.field_double(_EV_WALL_TIME, wall_time or time.time()) +
            proto.field_varint(_EV_STEP, int(step)) +
            proto.field_message(_EV_SUMMARY, summary))


def version_event(wall_time: Optional[float] = None) -> bytes:
    return (proto.field_double(_EV_WALL_TIME, wall_time or time.time()) +
            proto.field_bytes(_EV_FILE_VERSION, _FILE_VERSION.encode()))


def frame_record(payload: bytes) -> bytes:
    """TFRecord framing: len u64le, masked-crc(len), payload,
    masked-crc(payload)."""
    hdr = struct.pack("<Q", len(payload))
    return (hdr + struct.pack("<I", _masked_crc(hdr)) + payload +
            struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Buffered event-file writer with a background flush thread."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{time.time():.6f}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._flush_secs = flush_secs
        self._closed = False
        self._q.put(frame_record(version_event()))
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        last_flush = time.time()
        while True:
            try:
                item = self._q.get(timeout=self._flush_secs)
            except queue.Empty:
                item = b""
            if item is None:
                break
            if isinstance(item, threading.Event):
                # flush barrier: everything enqueued before it is written
                self._f.flush()
                item.set()
                continue
            if item:
                self._f.write(item)
            if time.time() - last_flush >= self._flush_secs:
                self._f.flush()
                last_flush = time.time()
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        if not self._closed:
            self._q.put(frame_record(scalar_event(tag, value, step)))

    def add_event(self, event_bytes: bytes):
        if not self._closed:
            self._q.put(frame_record(event_bytes))

    def flush(self):
        """Block until everything queued so far is on disk. A sentinel
        barrier rides the queue behind the pending records, so there is no
        drained-but-unwritten race (queue.empty() can be true while the
        worker still holds the last record)."""
        if self._closed or not self._t.is_alive():
            if not self._f.closed:
                self._f.flush()
            return
        barrier = threading.Event()
        self._q.put(barrier)
        barrier.wait(timeout=30)

    def close(self):
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._t.join(timeout=10)
            self._f.close()


# ------------------------------------------------------------- read-back

def iter_event_records(path: str):
    """Yield raw Event payloads from one event file, stopping (not
    raising) at the first corrupt or truncated record.

    Crash-safety parity with the checkpoint reader: a writer killed
    mid-record, a torn tail, or flipped bytes must cost only the records
    at and after the damage — everything before it still parses. The
    length header's CRC is verified (a corrupt length would otherwise
    send the reader seeking megabytes into garbage); a record whose
    *payload* CRC fails is skipped while the scan continues, since the
    framing itself is still intact."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return  # clean EOF or truncated header
            (length,) = struct.unpack("<Q", hdr[:8])
            (len_crc,) = struct.unpack("<I", hdr[8:])
            if _masked_crc(hdr[:8]) != len_crc:
                return  # corrupt length: cannot resync past it
            payload = f.read(length + 4)
            if len(payload) < length + 4:
                return  # truncated record (writer died mid-write)
            data, (data_crc,) = payload[:-4], struct.unpack(
                "<I", payload[-4:])
            if _masked_crc(data) != data_crc:
                continue  # bit-rotted payload: skip, framing still holds
            yield data


def read_scalars(log_dir: str, tag: Optional[str] = None
                 ) -> Dict[str, List[Tuple[int, float, float]]]:
    """Parse every event file under ``log_dir``; returns
    ``{tag: [(step, wall_time, value), ...]}`` sorted by step."""
    out: Dict[str, List[Tuple[int, float, float]]] = {}
    if not os.path.isdir(log_dir):
        return out
    files = sorted(f for f in os.listdir(log_dir)
                   if f.startswith("events.out.tfevents"))
    for fname in files:
        for rec in iter_event_records(os.path.join(log_dir, fname)):
            try:
                _scan_record(rec, tag, out)
            except (ValueError, struct.error, IndexError, TypeError,
                    UnicodeDecodeError):
                continue  # CRC-valid but unparseable: skip, keep reading
    for v in out.values():
        v.sort(key=lambda r: r[0])
    return out


def _scan_record(rec: bytes, tag: Optional[str],
                 out: Dict[str, List[Tuple[int, float, float]]]):
    """Collect the scalars of one Event record into ``out`` (raises on a
    malformed record; ``read_scalars`` skips those)."""
    fields = proto.parse_fields(rec)
    if _EV_SUMMARY not in fields:
        return
    wall = float(fields.get(_EV_WALL_TIME, [0.0])[0])
    step = proto.zigzag_to_int64(int(fields.get(_EV_STEP, [0])[0]))
    for summary in fields[_EV_SUMMARY]:
        for fld, wire, sval in proto.iter_fields(summary):
            # only Summary.value (field 1, length-delimited); a
            # varint/fixed field from another producer would be an
            # int here and must not reach parse_fields
            if fld != _SUM_VALUE or wire != 2 or not isinstance(sval, bytes):
                continue
            vf = proto.parse_fields(sval)
            if _VAL_TAG not in vf:
                continue
            t = vf[_VAL_TAG][0].decode("utf-8")
            if tag is not None and t != tag:
                continue
            val = _extract_value(vf)
            if val is not None:
                out.setdefault(t, []).append((step, wall, val))


def _extract_value(vf) -> Optional[float]:
    """simple_value, or a scalar TensorProto (how TF2's
    tf.summary.scalar encodes it)."""
    if _VAL_SIMPLE in vf:
        return float(vf[_VAL_SIMPLE][0])
    if _VAL_TENSOR not in vf:
        return None
    tp = proto.parse_fields(vf[_VAL_TENSOR][0])
    dtype = int(tp.get(_TP_DTYPE, [_DT_FLOAT])[0])
    if _TP_CONTENT in tp and tp[_TP_CONTENT][0]:
        raw = tp[_TP_CONTENT][0]
        fmt = "<f" if dtype == _DT_FLOAT else "<d"
        return float(struct.unpack_from(fmt, raw, 0)[0])
    for fld in (_TP_FLOAT_VAL, _TP_DOUBLE_VAL):
        if fld in tp:
            v = tp[fld][0]
            if isinstance(v, bytes):  # packed repeated
                fmt = "<f" if fld == _TP_FLOAT_VAL else "<d"
                return float(struct.unpack_from(fmt, v, 0)[0])
            return float(v)
    return None


class Summary:
    """File-backed scalar summary with in-memory mirror and disk
    read-back (the ``TrainSummary``/``ValidationSummary`` API)."""

    def __init__(self, log_dir: Optional[str] = None, app_name: str = "zoo"):
        self.log_dir = (os.path.join(log_dir, app_name)
                        if log_dir is not None else None)
        self._scalars: Dict[str, List[Tuple[int, float]]] = {}
        self._writer = EventWriter(self.log_dir) if self.log_dir else None

    def add_scalar(self, tag: str, value: float, step: int):
        self._scalars.setdefault(tag, []).append((step, float(value)))
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """In-memory when available; otherwise parse back from disk (so a
        fresh process can read another run's summaries)."""
        if tag in self._scalars:
            return list(self._scalars[tag])
        if self.log_dir:
            if self._writer is not None:
                self._writer.flush()
            recs = read_scalars(self.log_dir, tag).get(tag, [])
            return [(step, val) for step, _, val in recs]
        return []

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


TrainSummary = Summary
ValidationSummary = Summary
