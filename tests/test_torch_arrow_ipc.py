"""The port's Arrow IPC codec against ``pyarrow`` and the JAX package.

The port reads and writes the serving wire's Arrow streams without
``pyarrow`` (``zoo_tpu_torch/serving/arrow_ipc.py``). Here, where
``pyarrow`` is installed:

* the four codecs of ``zoo_tpu_torch.serving.client`` against the JAX
  package's (which call ``pyarrow``), both directions: what the port
  encodes the JAX side decodes to the same arrays, and the reverse, and
  both encodings read back, through ``pyarrow``, as the same table
  (dense tensors of several ranks, 0-d arrays, strings, string lists,
  a sparse ``[indices, values, shape]`` input, a b64 image dict, the
  null-padded columns of a mixed request; ``hypothesis`` over shapes);
* the reader on streams ``pyarrow`` writes (validity bitmaps on
  structs, lists and their items, every int and float width, several
  batches; the pre-1.0 framing refused), and ``pyarrow``'s full validation of
  what the writer writes;
* ``zoo_tpu_torch.serving`` imported whole, and one tensor round-tripped,
  in a process where ``import pyarrow`` fails.
"""

import base64
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from zoo_tpu.serving import client as jax_client

from zoo_tpu_torch.serving import arrow_ipc as A
from zoo_tpu_torch.serving import client as port_client

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
rs = np.random.RandomState(0)

INPUTS = {
    "rank1": {"t": rs.randn(6).astype(np.float32)},
    "rank2": {"t": rs.randn(2, 3).astype(np.float32)},
    "rank4_image": {"image": rs.rand(1, 8, 8, 3).astype(np.float32)},
    "rank3_f64": {"t": rs.randn(3, 1, 2)},
    "scalar": {"s": np.array(3.5, np.float32)},
    "one_element": {"t": np.array([7.0], np.float32)},
    "empty": {"t": np.zeros((0, 3), np.float32)},
    "string": {"s": "hello|world"},
    "string_list": {"s": ["a", "bb", "ccc"]},
    "b64_image": {"img": {"b64": base64.b64encode(b"\x89PNG...").decode()}},
    "mixed": {"t": rs.randn(2, 2).astype(np.float32), "s": ["x", "y"],
              "img": {"b64": "QUJD"}},
}


def _table(b64str):
    return pa.ipc.open_stream(base64.b64decode(b64str)).read_all()


def _assert_same_table(a, b):
    """Equal schemas, null masks and values (NaN equal to NaN)."""
    assert a.schema.equals(b.schema), (a.schema, b.schema)
    for x, y in zip(a.columns, b.columns):
        assert x.is_null().to_pylist() == y.is_null().to_pylist()
        np.testing.assert_array_equal(x.to_numpy(zero_copy_only=False),
                                      y.to_numpy(zero_copy_only=False))


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("case", sorted(INPUTS))
def test_encode_input_matches_jax_both_directions(case):
    data = INPUTS[case]
    port_b64 = port_client.encode_input_b64(**data)
    jax_b64 = jax_client.encode_input_b64(**data)
    # the same table through pyarrow, schema included
    pt, jt = _table(port_b64), _table(jax_b64)
    assert pt.schema.equals(jt.schema), (pt.schema, jt.schema)
    assert pt.to_pylist() == jt.to_pylist()
    # each side decodes the other's payload as it decodes its own
    ref = jax_client.decode_input_b64(jax_b64)
    _assert_same(jax_client.decode_input_b64(port_b64), ref)
    _assert_same(port_client.decode_input_b64(jax_b64), ref)
    _assert_same(port_client.decode_input_b64(port_b64), ref)


def test_a_sparse_input_encodes_as_jax_and_decodes_as_jax():
    """The sparse form's rows carry indices, their shape, the values and
    the dense shape; the serving side's decode reshapes the values to
    the dense shape, so both packages refuse it alike unless every
    value is present."""
    idx = np.array([[0, 1], [1, 2]])
    sp = [idx, np.array([3.0, 4.0]), np.array([2, 3])]
    port_b64 = port_client.encode_input_b64(sp=sp)
    jax_b64 = jax_client.encode_input_b64(sp=sp)
    assert _table(port_b64).to_pylist() == _table(jax_b64).to_pylist()
    assert _table(port_b64).to_pylist()[0]["sp"]["indiceData"] == \
        [0, 1, 1, 2]
    for dec in (port_client.decode_input_b64, jax_client.decode_input_b64):
        for b in (port_b64, jax_b64):
            with pytest.raises(ValueError, match="reshape"):
                dec(b)
    full = [np.array([[0], [1]]), np.array([5.0, 6.0]), np.array([2])]
    _assert_same(port_client.decode_input_b64(
        jax_client.encode_input_b64(sp=full)),
        jax_client.decode_input_b64(port_client.encode_input_b64(sp=full)))


@pytest.mark.parametrize("bad,exc", [([], ValueError), ([1, 2], TypeError),
                                     ([np.zeros(2)], ValueError),
                                     ({"x": 1}, TypeError),
                                     (np.float32(1.0), TypeError)])
def test_unsupported_inputs_raise_as_jax(bad, exc):
    for enc in (port_client.encode_input_b64, jax_client.encode_input_b64):
        with pytest.raises(exc):
            enc(t=bad)


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3), np.float32(2.5),
    np.array(1.25), np.zeros((0, 3)), np.arange(5.0), np.ones((1, 1, 1, 4)),
    np.array([np.nan, np.inf, -0.0], np.float32), np.arange(24).reshape(
        2, 3, 4)], ids=lambda a: f"shape{np.shape(a)}")
def test_result_codec_matches_jax_both_directions(arr):
    port_b64 = port_client.encode_ndarray_b64(arr)
    jax_b64 = jax_client.encode_ndarray_b64(arr)
    _assert_same_table(_table(port_b64), _table(jax_b64))
    ref = jax_client.decode_ndarray_b64(jax_b64)
    for got in (port_client.decode_ndarray_b64(jax_b64),
                jax_client.decode_ndarray_b64(port_b64),
                port_client.decode_ndarray_b64(port_b64)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@settings(max_examples=60, deadline=None)
@given(shape=st.lists(st.integers(0, 5), min_size=0, max_size=4),
       seed=st.integers(0, 2 ** 16))
def test_codecs_match_jax_over_shapes(shape, seed):
    x = np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)
    ref = jax_client.decode_input_b64(jax_client.encode_input_b64(t=x))
    _assert_same(port_client.decode_input_b64(
        jax_client.encode_input_b64(t=x)), ref)
    _assert_same(jax_client.decode_input_b64(
        port_client.encode_input_b64(t=x)), ref)
    out = jax_client.decode_ndarray_b64(port_client.encode_ndarray_b64(x))
    back = port_client.decode_ndarray_b64(jax_client.encode_ndarray_b64(x))
    ref = jax_client.decode_ndarray_b64(jax_client.encode_ndarray_b64(x))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(back, ref)
    assert out.shape == back.shape == ref.shape


def test_the_reader_reads_what_pyarrow_writes():
    """Every width of int and float, strings, lists and structs with
    nulls at every level, two record batches."""
    ints = [pa.int8(), pa.int16(), pa.int32(), pa.int64(), pa.uint8(),
            pa.uint32()]
    floats = [pa.float16(), pa.float32(), pa.float64()]
    cols, names = [], []
    for i, t in enumerate(ints + floats):
        vals = [1, None, 3, 4] if t in ints else [1.5, None, -2.0, 0.25]
        cols.append(pa.array(vals, t))
        names.append(f"c{i}")
    cols.append(pa.array(["a", None, "", "ünï"]))
    cols.append(pa.array([[1, None], None, [], [4, 5, 6]],
                         pa.list_(pa.int32())))
    st_type = pa.struct([("xs", pa.list_(pa.float32())), ("n", pa.int32())])
    cols.append(pa.array([{"xs": [1.0, None], "n": 1}, None,
                          {"xs": None, "n": None}, {"xs": [], "n": 4}],
                         st_type))
    names += ["s", "l", "st"]
    batch = pa.RecordBatch.from_arrays(cols, names=names)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as w:
        w.write_batch(batch)
        w.write_batch(batch.slice(1, 2))
    fields, batches = A.read_stream(sink.getvalue().to_pybytes())
    assert [f.name for f in fields] == names
    assert len(batches) == 2
    for got, want in zip(batches, (batch, batch.slice(1, 2))):
        for i, col in enumerate(got):
            assert A.to_pylist(col) == want.column(i).to_pylist(), names[i]
    # the pre-1.0 framing (no continuation markers) is refused, not misread
    sink = pa.BufferOutputStream()
    opts = pa.ipc.IpcWriteOptions(use_legacy_format=True)
    with pa.ipc.new_stream(sink, batch.schema, options=opts) as w:
        w.write_batch(batch)
    with pytest.raises(ValueError, match="continuation"):
        A.read_stream(sink.getvalue().to_pybytes())


def test_pyarrow_validates_what_the_writer_writes():
    tt = port_client._TENSOR_TYPE
    fields = [A.Field("t", tt), A.Field("s", A.utf8()),
              A.Field("f", A.float32()), A.Field("i", A.int32())]
    cols = [port_client._tensor_column([np.zeros(0), None,
                                        np.arange(3.0), np.array([3])]),
            A.concat_nulls(A.string_array(["x", None]), 2),
            A.concat_nulls(A.primitive_array([1.0], A.float32()), 3),
            A.primitive_array([1, 2, 3, 4], A.int32(),
                              np.array([1, 0, 1, 0], bool))]
    empty = [A.struct_array(tt.children, [
        A.list_array([], f.type.children[0].type) for f in tt.children]),
             A.string_array([]), A.primitive_array([], A.float32()),
             A.primitive_array([], A.int32())]
    raw = A.write_stream(fields, [cols, [A.concat_nulls(c, 2)
                                         for c in empty]])
    reader = pa.ipc.open_stream(raw)
    got = list(reader)
    assert len(got) == 2
    for rb in got:
        rb.validate(full=True)
    assert got[0].to_pylist() == [
        {"t": {"indiceData": [], "indiceShape": None, "data": None,
               "shape": None}, "s": "x", "f": 1.0, "i": 1},
        {"t": {"indiceData": None, "indiceShape": None, "data": None,
               "shape": None}, "s": None, "f": None, "i": None},
        {"t": {"indiceData": None, "indiceShape": None,
               "data": [0.0, 1.0, 2.0], "shape": None},
         "s": None, "f": None, "i": 3},
        {"t": {"indiceData": None, "indiceShape": None, "data": None,
               "shape": [3]}, "s": None, "f": None, "i": None}]
    assert got[1].to_pylist() == [{"t": None, "s": None, "f": None,
                                   "i": None}] * 2
    # the framing: 8-byte aligned messages and bodies, then the EOS
    assert raw[-8:] == b"\xff\xff\xff\xff\x00\x00\x00\x00"
    assert len(raw) % 8 == 0


def test_serving_imports_and_round_trips_with_pyarrow_blocked():
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\n"
        "import importlib, pkgutil\n"
        "import numpy as np\n"
        "import zoo_tpu_torch.serving as S\n"
        "for m in pkgutil.walk_packages(S.__path__, 'zoo_tpu_torch.serving.'):\n"
        "    importlib.import_module(m.name)\n"
        "from zoo_tpu_torch.serving import client as C\n"
        "from zoo_tpu_torch.serving import ClusterServing, InputQueue\n"
        "x = np.arange(12, dtype=np.float32).reshape(3, 4)\n"
        "got = C.decode_input_b64(C.encode_input_b64(t=x))['t']\n"
        "assert got.shape == (3, 4) and (got == x).all()\n"
        "assert (C.decode_ndarray_b64(C.encode_ndarray_b64(x)) == x).all()\n"
        "assert 'pyarrow' not in {k for k, v in sys.modules.items() if v}\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ROOT},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
