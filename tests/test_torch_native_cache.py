"""The port's native runtime (``zoo_tpu_torch/native``), TFRecord I/O and
tiered sample cache against the JAX package's: CRC32C known vectors;
TFRecord files written by each package (and each route) read by the
other; corruption detected on both routes; the cache's spill and
read-back; ``FeatureSet.ndarrays`` epochs; the route each call took;
and the cluster-launch helpers of ``util/utils.py``.

Everything here is exact: bytes, records, cached objects and helper
results compare equal.
"""

import os

import numpy as np
import pytest
import torch

import zoo_tpu.feature.common as jcommon
from zoo_tpu import native as jnative
from zoo_tpu.orca.data import tfrecord as jtfr
from zoo_tpu.orca.data.cache import TieredSampleCache as JCache

import zoo_tpu_torch.feature.common as tcommon
from zoo_tpu_torch import native
from zoo_tpu_torch.orca.data import tfrecord as tfr
from zoo_tpu_torch.orca.data.cache import (
    CachedDataset,
    DoubleBufferedIterator,
    TieredSampleCache,
)


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """Run a test on the port's native route, then on its Python one."""
    if request.param == "python":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_lib_tried", True)
    else:
        assert native.available(), "the g++ build of zoo_native.cc failed"
    native.reset_routes()
    yield request.param


def test_native_library_builds_from_the_ports_own_source():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.parent.parent == native.BUILD_ROOT
    assert native.SRC.parent.name == "native" and \
        native.SRC.parent.parent.name == "zoo_tpu_torch"


def test_crc32c_known_vectors(route):
    # RFC 3720's vectors, on the route under test and in the JAX package
    for data, want in ((b"", 0x0), (b"123456789", 0xE3069283),
                       (bytes(32), 0x8A9136AA)):
        assert tfr.crc32c(data) == jtfr.crc32c(data) == want
    assert native.routes()["crc32c"] == {route: 3}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tfrecord_files_cross_between_the_packages(tmp_path, route, writer):
    recs = [os.urandom(n) for n in (0, 1, 10, 1000, 65536)]
    a, b = str(tmp_path / "a.tfrecord"), str(tmp_path / "b.tfrecord")
    (tfr if writer == "port" else jtfr).write_tfrecord(a, recs)
    assert tfr.read_tfrecord(a) == jtfr.read_tfrecord(a) == recs
    # and the other way round, byte for byte
    (jtfr if writer == "port" else tfr).write_tfrecord(b, recs)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert tfr.read_tfrecord(b) == recs
    assert native.routes()["tfrecord_read"] == {route: 2}


def test_tfrecord_corruption_detected(tmp_path, route):
    path = str(tmp_path / "c.tfrecord")
    tfr.write_tfrecord(path, [b"x" * 100])
    raw = bytearray(open(path, "rb").read())
    raw[40] ^= 0xFF  # a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tfr.TFRecordCorruptError):
        tfr.read_tfrecord(path)
    with pytest.raises(jtfr.TFRecordCorruptError):
        jtfr.read_tfrecord(path)
    assert len(tfr.read_tfrecord(path, check_crc=False)) == 1
    # a truncated file too
    open(path, "wb").write(bytes(raw[:30]))
    with pytest.raises(tfr.TFRecordCorruptError):
        tfr.read_tfrecord(path)


def test_tfrecord_shards_and_parse_fn(tmp_path, route):
    for i in range(3):
        jtfr.write_tfrecord(str(tmp_path / f"part-{i}.tfrecord"),
                            [f"rec{i}-{j}".encode() for j in range(4)])
    pattern = str(tmp_path / "part-*.tfrecord")
    got = tfr.read_tfrecord_shards(pattern, parse_fn=bytes.decode)
    want = jtfr.read_tfrecord_shards(pattern, parse_fn=bytes.decode)
    assert got.collect() == want.collect()
    assert got.collect()[1] == [f"rec1-{j}" for j in range(4)]


def _samples():
    rs = np.random.RandomState(0)
    return [{"x": rs.randn(64, 8).astype(np.float32),
             "y": rs.randint(0, 5, 64)} for _ in range(12)]


def test_tiered_cache_spills_and_reads_back_as_jaxs(tmp_path, route):
    samples = _samples()
    budget = 3 * 2500   # a few samples stay in DRAM, the rest spill
    port = TieredSampleCache(dram_budget=budget, spill_dir=str(tmp_path))
    jax_ = JCache(dram_budget=budget, spill_dir=str(tmp_path))
    assert port.route == route
    for s in samples:
        assert port.put(s) == jax_.put(s)
    assert len(port) == len(jax_) == 12
    assert 0 < port.dram_used() == jax_.dram_used() <= budget
    assert port.spilled()
    for i in (11, 0, 5):
        a, b = port.get(i), jax_.get(i)
        assert np.array_equal(a["x"], b["x"]) and \
            np.array_equal(a["y"], b["y"])
    with pytest.raises(IndexError):
        port.get(12)
    port.close()
    jax_.close()


@pytest.mark.parametrize("tier", ["DRAM", "DISK_4", "PMEM"])
def test_feature_set_ndarrays_replays_epochs(tier, route):
    samples = _samples()
    fs = tcommon.FeatureSet.ndarrays(samples, tier)
    js = jcommon.FeatureSet.ndarrays(samples, tier)
    for _ in range(2):   # every epoch replays the same batches
        got, want = list(fs), list(js)
        assert len(got) == len(want) == 12
        for a, b in zip(got, want):
            assert np.array_equal(a["x"], b["x"])
    assert fs.dataset.cache.route == route
    assert native.routes()["cache"] == {route: 1}


def test_double_buffered_iterator_copies_to_the_device():
    ds = CachedDataset(_samples()[:4], store="DISK_2")
    with DoubleBufferedIterator(iter(ds), device="cpu") as it:
        got = list(it)
    assert [g["y"].dtype for g in got] == [torch.int32] * 4
    assert all(torch.equal(g["x"], torch.from_numpy(s["x"]))
               for g, s in zip(got, _samples()[:4]))
    ds.close()


def test_a_failed_build_is_never_silent(monkeypatch, caplog, tmp_path):
    """No g++ (or a refused build): ``load`` warns naming the cause, and
    the callers record the Python route."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "missing" / "zoo_native.so")
    monkeypatch.setenv("PATH", "")
    native.reset_routes()
    with caplog.at_level("WARNING", logger="zoo_tpu_torch.native"):
        assert native.load() is None
    assert any("g++" in r.getMessage() for r in caplog.records)
    assert tfr.crc32c(b"123456789") == 0xE3069283
    assert native.routes() == {"crc32c": {"python": 1}}
    assert jnative.available()   # the JAX package's own build is separate


# -- the cluster-launch helpers of util/utils.py (host code, as above) ----

def test_cluster_launch_helpers_match_jax(monkeypatch, tmp_path):
    import socket

    from zoo_tpu.util import utils as jutils

    from zoo_tpu_torch.util import utils as tutils

    for env in ({"CONDA_DEFAULT_ENV": "zoo"},
                {"CONDA_PREFIX": "/srv/conda/envs/torch"}, {}):
        monkeypatch.delenv("CONDA_DEFAULT_ENV", raising=False)
        monkeypatch.delenv("CONDA_PREFIX", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = []
        for mod in (tutils, jutils):
            try:
                got.append(mod.detect_conda_env_name())
            except RuntimeError as e:
                got.append(str(e))
        assert got[0] == got[1]
    (tmp_path / "real").mkdir()
    os.symlink(tmp_path / "real", tmp_path / "link")
    for follow in (True, False):
        assert tutils.convert_to_safe_path(str(tmp_path / "link"), follow) \
            == jutils.convert_to_safe_path(str(tmp_path / "link"), follow)

    class NoRoute:   # a host without a route: no packet is ever sent
        def __init__(self, *a):
            pass

        def connect(self, addr):
            raise OSError("unreachable")

        def close(self):
            pass

    monkeypatch.setattr(socket, "socket", NoRoute)
    assert tutils.get_node_ip() == jutils.get_node_ip() == "127.0.0.1"
