"""The port's TensorBoard event files (``zoo_tpu_torch/tensorboard``)
against the JAX package's: files the port writes read back in the JAX
reader and the reverse, the port's own CRC32C against the JAX package's
framing, and a truncated tail or a corrupt record costing only the
records at and after the damage.
"""

import os
import struct

import pytest

from zoo_tpu import tensorboard as jtb
from zoo_tpu.orca.data.tfrecord import _masked_crc as jax_masked_crc

from zoo_tpu_torch import tensorboard as ttb

SCALARS = [("Loss", 0.75, 8), ("Loss", 0.5, 16), ("Throughput", 1234.5, 16),
           ("Loss", 0.25, 24)]


def _write(mod, log_dir):
    s = mod.TrainSummary(str(log_dir), "app/train")
    for tag, value, step in SCALARS:
        s.add_scalar(tag, value, step)
    s.close()
    return os.path.join(str(log_dir), "app", "train")


def _expected(tag):
    return [(step, value) for t, value, step in SCALARS if t == tag]


@pytest.mark.parametrize("writer,reader", [(ttb, jtb), (jtb, ttb)],
                         ids=["port-writes-jax-reads",
                              "jax-writes-port-reads"])
def test_event_files_cross_packages(writer, reader, tmp_path):
    path = _write(writer, tmp_path)
    got = reader.read_scalars(path)
    for tag in ("Loss", "Throughput"):
        assert [(s, v) for s, _, v in got[tag]] == _expected(tag)
    back = reader.TrainSummary(str(tmp_path), "app/train")
    try:
        assert back.read_scalar("Loss") == _expected("Loss")
    finally:
        back.close()


def test_records_are_byte_identical_to_the_jax_framing():
    payload = ttb.scalar_event("Loss", 0.5, 3, wall_time=1.0)
    assert payload == jtb.scalar_event("Loss", 0.5, 3, wall_time=1.0)
    assert ttb.frame_record(payload) == jtb.frame_record(payload)
    for data in (b"", b"a", b"123456789", os.urandom(1000)):
        assert ttb._masked_crc(data) == jax_masked_crc(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283   # the CRC-32C check


def _event_file(path):
    return os.path.join(path, next(f for f in os.listdir(path)
                                   if f.startswith("events.out.tfevents")))


@pytest.mark.parametrize("reader", [ttb, jtb], ids=["port", "jax"])
def test_truncated_tail_keeps_the_records_before_it(reader, tmp_path):
    path = _write(ttb, tmp_path)
    f = _event_file(path)
    size = os.path.getsize(f)
    with open(f, "r+b") as fh:
        fh.truncate(size - 7)   # the last record loses its tail
    got = reader.read_scalars(path)
    assert [(s, v) for s, _, v in got["Loss"]] == _expected("Loss")[:-1]


@pytest.mark.parametrize("reader", [ttb, jtb], ids=["port", "jax"])
def test_corrupt_record_is_skipped_and_the_rest_read(reader, tmp_path):
    """Flip a byte inside the second record's payload: its payload CRC
    fails, the framing holds, so only that record is lost."""
    path = _write(ttb, tmp_path)
    f = _event_file(path)
    data = bytearray(open(f, "rb").read())
    offsets, pos = [], 0
    while pos < len(data):
        (length,) = struct.unpack("<Q", data[pos:pos + 8])
        offsets.append(pos)
        pos += 12 + length + 4
    # record 0 is the file-version event; record 1 is the first scalar
    victim = offsets[1] + 12 + 5
    data[victim] ^= 0xFF
    open(f, "wb").write(bytes(data))
    got = reader.read_scalars(path)
    assert [(s, v) for s, _, v in got["Loss"]] == _expected("Loss")[1:]
    assert [(s, v) for s, _, v in got["Throughput"]] == \
        _expected("Throughput")
