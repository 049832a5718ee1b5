"""The port's Caffe loader (``zoo_tpu_torch.models.caffe_loader``) against
the JAX loader: every case of ``tests/test_caffe_loader.py`` (binary
parse, forward, prototxt topology, parser basics, TRAIN-phase skip,
deconvolution, AVE pad denominator, all-caps types, missing bottom,
fine-tune), plus LRN (both regions), a grouped and dilated conv, the
V1 binary layout, legacy blob dims and ``double_data``, and the rest
of the layer types. Both loaders read the same hand-encoded files (the
port's wire helpers write them), so the nets need no conversion."""

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.models import caffe_loader as J

from zoo_tpu_torch.convert import caffe_net_from_jax
from zoo_tpu_torch.models import caffe_loader as T
from zoo_tpu_torch.pipeline.inference import InferenceModel
from zoo_tpu_torch.tensorboard import proto as wire

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _blob(arr, legacy=False, double=False):
    arr = np.asarray(arr, np.float32)
    if legacy:
        dims = (1,) * (4 - arr.ndim) + arr.shape
        out = b"".join(wire.field_varint(f, d) for f, d in zip(
            (1, 2, 3, 4), dims))
    else:
        out = wire.field_bytes(7, b"".join(wire.field_varint(1, d)
                                           for d in arr.shape))
    if double:
        return out + b"".join(wire.field_double(9, float(v))
                              for v in arr.reshape(-1))
    return out + b"".join(wire.field_float(5, float(v))
                          for v in arr.reshape(-1))


def _layer(name, type_, bottoms, tops, blobs=(), param_field=None,
           param_bytes=b""):
    out = wire.field_bytes(1, name.encode())
    out += wire.field_bytes(2, type_.encode())
    for b in bottoms:
        out += wire.field_bytes(3, b.encode())
    for t in tops:
        out += wire.field_bytes(4, t.encode())
    for bl in blobs:
        out += wire.field_bytes(7, _blob(bl))
    if param_field:
        out += wire.field_bytes(param_field, param_bytes)
    return out


def _net(path, shape, layers, name=b"testnet"):
    net = wire.field_bytes(1, name) + wire.field_bytes(3, b"data")
    for d in shape:
        net += wire.field_varint(4, d)
    for l in layers:
        net += wire.field_bytes(100, l)
    path.write_bytes(net)
    return str(path)


def _make_model(tmp_path):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    fc_w = (0.1 * rng.randn(2, 4 * 4 * 4)).astype(np.float32)
    fc_b = (0.1 * rng.randn(2)).astype(np.float32)
    conv_param = (wire.field_varint(1, 4) + wire.field_varint(4, 3)
                  + wire.field_varint(6, 1) + wire.field_varint(3, 1))
    pool_param = (wire.field_varint(1, 0) + wire.field_varint(2, 2)
                  + wire.field_varint(3, 2))
    ip_param = wire.field_varint(1, 2)
    path = _net(tmp_path / "model.caffemodel", (1, 3, 8, 8), [
        _layer("conv1", "Convolution", ["data"], ["conv1"], [w, b], 106,
               conv_param),
        _layer("relu1", "ReLU", ["conv1"], ["conv1"]),
        _layer("pool1", "Pooling", ["conv1"], ["pool1"], (), 121,
               pool_param),
        _layer("fc1", "InnerProduct", ["pool1"], ["fc1"], [fc_w, fc_b], 117,
               ip_param),
        _layer("prob", "Softmax", ["fc1"], ["prob"])])
    return path, (w, b, fc_w, fc_b)


def _numpy_forward(x, w, b, fc_w, fc_b):
    n, _, h, w_ = x.shape
    co, ci, kh, kw = w.shape
    xp = np.pad(x, [(0, 0), (0, 0), (1, 1), (1, 1)])
    conv = np.zeros((n, co, h, w_), np.float32)
    for i in range(h):
        for j in range(w_):
            patch = xp[:, :, i:i + kh, j:j + kw]
            conv[:, :, i, j] = np.einsum("nchw,ochw->no", patch, w) + b
    relu = np.maximum(conv, 0)
    pool = relu.reshape(n, co, 4, 2, 4, 2).max(axis=(3, 5))
    fc = pool.reshape(n, -1) @ fc_w.T + fc_b
    e = np.exp(fc - fc.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _both(def_path, path):
    return (J.load_caffe(def_path, path),
            T.load_caffe(def_path, path, device="cpu"))


def _same_outputs(jnet, tnet, x, rtol=1e-5, atol=1e-6):
    want = np.asarray(jnet.predict(x, batch_size=len(x)))
    got = tnet.predict(x, batch_size=len(x), device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    return got


def test_binary_parse(tmp_path):
    path, _ = _make_model(tmp_path)
    with open(path, "rb") as f:
        data = f.read()
    t, j = T.CaffeNetParameter(data), J.CaffeNetParameter(data)
    assert t.name == j.name == "testnet"
    assert [l.type for l in t.layers] == [l.type for l in j.layers] == [
        "Convolution", "ReLU", "Pooling", "InnerProduct", "Softmax"]
    assert t.inputs == j.inputs == ["data"]
    assert t.input_shapes == j.input_shapes == [(1, 3, 8, 8)]
    for a, b in zip(t.layers, j.layers):
        assert (a.name, a.bottoms, a.tops, a.attrs) == \
            (b.name, b.bottoms, b.tops, b.attrs)
        assert all(np.array_equal(u, v) for u, v in zip(a.blobs, b.blobs))
    assert t.layers[0].blobs[0].shape == (4, 3, 3, 3)


def test_legacy_blob_dims_double_data_and_v1_layers(tmp_path):
    """A legacy (num, channels, height, width) blob with ``double_data``
    inside a V1 ``layers`` entry (enum type 4 = Convolution)."""
    rng = np.random.RandomState(7)
    w = rng.randn(2, 3, 3, 3)
    b = rng.randn(2)
    v1 = (wire.field_bytes(4, b"c") + wire.field_varint(5, 4)
          + wire.field_bytes(2, b"data") + wire.field_bytes(3, b"c")
          + wire.field_bytes(6, _blob(w, legacy=True, double=True))
          + wire.field_bytes(6, _blob(b, legacy=True))
          + wire.field_bytes(10, wire.field_varint(1, 2)
                             + wire.field_varint(4, 3)))
    net = wire.field_bytes(3, b"data")
    for d in (1, 3, 5, 5):
        net += wire.field_varint(4, d)
    net += wire.field_bytes(2, v1)
    (tmp_path / "v1.caffemodel").write_bytes(net)
    t = T.CaffeNetParameter(net)
    j = J.CaffeNetParameter(net)
    assert [l.type for l in t.layers] == [l.type for l in j.layers] == \
        ["Convolution"]
    assert t.layers[0].blobs[0].shape == j.layers[0].blobs[0].shape == \
        (2, 3, 3, 3)
    assert t.layers[0].blobs[1].shape == (2,)
    assert np.array_equal(t.layers[0].blobs[0], j.layers[0].blobs[0])
    jnet, tnet = _both(None, str(tmp_path / "v1.caffemodel"))
    _same_outputs(jnet, tnet, rng.randn(2, 3, 5, 5).astype(np.float32))


def test_forward_matches_numpy(tmp_path):
    path, (w, b, fc_w, fc_b) = _make_model(tmp_path)
    jnet, tnet = _both(None, path)
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    got = _same_outputs(jnet, tnet, x)
    np.testing.assert_allclose(got, _numpy_forward(x, w, b, fc_w, fc_b),
                               rtol=1e-4, atol=1e-5)
    # InferenceModel.load_caffe holds the same net
    im = InferenceModel().load_caffe(None, path, device="cpu")
    np.testing.assert_array_equal(im.predict(x), got)


DEPLOY = """
name: "testnet"
input: "data"
input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc1" type: "InnerProduct" bottom: "pool1" top: "fc1"
        inner_product_param { num_output: 2 } }
layer { name: "prob" type: "Softmax" bottom: "fc1" top: "prob" }
"""


def test_prototxt_topology(tmp_path):
    path, (w, b, fc_w, fc_b) = _make_model(tmp_path)
    def_path = tmp_path / "deploy.prototxt"
    def_path.write_text(DEPLOY)
    jnet, tnet = _both(str(def_path), path)
    x = np.random.RandomState(2).randn(2, 3, 8, 8).astype(np.float32)
    got = _same_outputs(jnet, tnet, x)
    np.testing.assert_allclose(got, _numpy_forward(x, w, b, fc_w, fc_b),
                               rtol=1e-4, atol=1e-5)
    assert tnet._built_shapes == jnet._built_shapes == [(None, 3, 8, 8)]


def test_prototxt_parser_basics():
    text = ('name: "n" # comment\nlayer { name: "l" include { phase: '
            'TRAIN } }\nx: 1.5e-3 y: -2 flag: true s: \'q\'')
    assert T.parse_prototxt(text) == J.parse_prototxt(text)
    net = T.parse_prototxt(text)
    assert net["name"] == ["n"]
    assert net["layer"][0]["include"][0]["phase"] == ["TRAIN"]
    assert net["flag"] == [True] and net["x"] == [1.5e-3]
    with pytest.raises(ValueError, match="parse error"):
        T.parse_prototxt("name: @")


def test_train_phase_layers_skipped(tmp_path):
    path, _ = _make_model(tmp_path)
    deploy = """
    input: "data"
    input_dim: 1 input_dim: 3 input_dim: 8 input_dim: 8
    layer { name: "aug" type: "Data" top: "data" include { phase: TRAIN } }
    layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
            convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
    """
    def_path = tmp_path / "d.prototxt"
    def_path.write_text(deploy)
    jnet, tnet = _both(str(def_path), path)
    assert [l.name for l in tnet.caffe_layers] == \
        [l.name for l in jnet.caffe_layers] == ["conv1"]
    _same_outputs(jnet, tnet,
                  np.random.RandomState(3).randn(2, 3, 8, 8).astype(
                      np.float32))


@pytest.mark.parametrize("stride,pad,group,dilation", [
    (2, 1, 1, 1), (3, 0, 1, 1), (2, 2, 1, 1), (2, 1, 3, 1), (1, 0, 1, 2)])
def test_deconvolution_matches_jax_and_torch(tmp_path, stride, pad, group,
                                             dilation):
    """Caffe's Deconvolution == ``ConvTranspose2d`` with weights (in,
    out/g, kh, kw); the port computes it as JAX does (a fractionally-
    strided conv) and is held to both."""
    rng = np.random.RandomState(4)
    cin, cout, k = 3 * group, 5 * group, 4
    w = rng.randn(cin, cout // group, k, k).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    conv_param = (wire.field_varint(1, cout) + wire.field_varint(4, k)
                  + wire.field_varint(6, stride) + wire.field_varint(3, pad)
                  + wire.field_varint(5, group)
                  + wire.field_varint(18, dilation))
    path = _net(tmp_path / "deconv.caffemodel", (1, cin, 6, 6), [
        _layer("up", "Deconvolution", ["data"], ["up"], [w, b], 106,
               conv_param)])
    jnet, tnet = _both(None, path)
    x = rng.randn(2, cin, 6, 6).astype(np.float32)
    got = _same_outputs(jnet, tnet, x, rtol=1e-5, atol=1e-5)
    tconv = torch.nn.ConvTranspose2d(cin, cout, k, stride=stride,
                                     padding=pad, groups=group,
                                     dilation=dilation)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(w))
        tconv.bias.copy_(torch.from_numpy(b))
        ref = tconv(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("k,s,p,size", [(3, 2, 1, 4), (3, 2, 0, 7),
                                        (2, 2, 0, 5), (3, 3, 1, 8),
                                        (3, 1, 1, 6)])
def test_pooling_ceil_mode_and_ave_pad_denominator(tmp_path, mode, k, s, p,
                                                   size):
    """Caffe's ceil-mode extra row and column, and AVE over the window
    clipped to the padded extent: the corner of an all-ones input with
    k=3, s=2, p=1 is 4/9, not 1."""
    pool_param = (wire.field_varint(1, mode) + wire.field_varint(2, k)
                  + wire.field_varint(3, s) + wire.field_varint(4, p))
    path = _net(tmp_path / "pool.caffemodel", (1, 2, size, size), [
        _layer("p", "Pooling", ["data"], ["p"], (), 121, pool_param)])
    jnet, tnet = _both(None, path)
    rs = np.random.RandomState(5)
    _same_outputs(jnet, tnet, rs.randn(2, 2, size, size).astype(np.float32))
    ones = _same_outputs(jnet, tnet, np.ones((1, 2, size, size), np.float32))
    if (mode, k, s, p, size) == (1, 3, 2, 1, 4):
        np.testing.assert_allclose(ones[0, 0, 0, 0], 4.0 / 9.0, rtol=1e-5)
        np.testing.assert_allclose(ones[0, 0, 1, 1], 1.0, rtol=1e-5)


def test_global_pooling(tmp_path):
    pool_param = wire.field_varint(1, 1) + wire.field_varint(12, 1)
    path = _net(tmp_path / "gp.caffemodel", (1, 3, 5, 6), [
        _layer("p", "Pooling", ["data"], ["p"], (), 121, pool_param)])
    jnet, tnet = _both(None, path)
    out = _same_outputs(jnet, tnet, np.random.RandomState(6).randn(
        2, 3, 5, 6).astype(np.float32))
    assert out.shape == (2, 3, 1, 1)


@pytest.mark.parametrize("region", [0, 1])
def test_lrn_matches_jax(tmp_path, region):
    """LRN scales alpha by the window (size, or size^2 within the
    channel)."""
    lrn = (wire.field_varint(1, 5) + wire.field_float(2, 1e-2)
           + wire.field_float(3, 0.75) + wire.field_varint(4, region)
           + wire.field_float(5, 2.0))
    path = _net(tmp_path / "lrn.caffemodel", (1, 7, 6, 6), [
        _layer("n", "LRN", ["data"], ["n"], (), 118, lrn)])
    jnet, tnet = _both(None, path)
    x = 3 * np.random.RandomState(8).randn(2, 7, 6, 6).astype(np.float32)
    _same_outputs(jnet, tnet, x)


@pytest.mark.parametrize("group,dilation,bias", [(2, 1, True),
                                                 (3, 2, True),
                                                 (1, 1, False)])
def test_grouped_dilated_conv_matches_jax(tmp_path, group, dilation, bias):
    rng = np.random.RandomState(9)
    cin, cout = 6, 6 * (2 if group == 2 else 1)
    w = rng.randn(cout, cin // group, 3, 3).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    conv = (wire.field_varint(1, cout) + wire.field_varint(4, 3)
            + wire.field_varint(5, group) + wire.field_varint(3, 1)
            + wire.field_varint(18, dilation)
            + wire.field_varint(13, 2) + wire.field_varint(14, 1)
            + (b"" if bias else wire.field_varint(2, 0)))
    path = _net(tmp_path / "g.caffemodel", (1, cin, 9, 8), [
        _layer("c", "Convolution", ["data"], ["c"],
               [w, b] if bias else [w], 106, conv)])
    jnet, tnet = _both(None, path)
    _same_outputs(jnet, tnet, rng.randn(2, cin, 9, 8).astype(np.float32))


def test_the_other_layer_types_match_jax(tmp_path):
    """Every remaining layer type of the interpreter in one net:
    Split/Slice/Concat/Eltwise (SUM with coefficients, PROD, MAX), the
    activations, Power, BatchNorm/Scale/Bias, PReLU, Flatten/Reshape,
    Dropout and Softmax."""
    rng = np.random.RandomState(10)
    c = 4
    ones = np.ones((c,), np.float32)
    f = wire.field_float
    v = wire.field_varint
    layers = [
        _layer("sp", "Split", ["data"], ["a", "b"]),
        _layer("sl", "Slice", ["a"], ["a1", "a2"], (), 0),
        _layer("cat", "Concat", ["a1", "a2"], ["cat"], (), 104, v(2, 1)),
        _layer("sum", "Eltwise", ["cat", "b"], ["sum"], (), 110,
               v(1, 1) + f(2, 0.5) + f(2, -2.0)),
        _layer("prod", "Eltwise", ["sum", "b"], ["prod"], (), 110, v(1, 0)),
        _layer("mx", "Eltwise", ["prod", "sum"], ["mx"], (), 110, v(1, 2)),
        _layer("bn", "BatchNorm", ["mx"], ["bn"],
               [rng.randn(c), rng.rand(c) + 0.5], 139, f(3, 1e-3)),
        _layer("sc", "Scale", ["bn"], ["sc"], [rng.randn(c), rng.randn(c)]),
        _layer("bi", "Bias", ["sc"], ["bi"], [rng.randn(c)]),
        _layer("pr", "PReLU", ["bi"], ["pr"], [0.1 * ones]),
        _layer("lr", "ReLU", ["pr"], ["lr"], (), 123, f(1, 0.2)),
        _layer("el", "ELU", ["lr"], ["el"], (), 140, f(1, 0.7)),
        _layer("sg", "Sigmoid", ["el"], ["sg"]),
        _layer("th", "TanH", ["sg"], ["th"]),
        _layer("bl", "BNLL", ["th"], ["bl"]),
        _layer("pw", "Power", ["bl"], ["pw"], (), 122,
               f(1, 2.0) + f(2, 0.5) + f(3, 1.0)),
        _layer("ab", "AbsVal", ["pw"], ["ab"]),
        _layer("lg", "Log", ["ab"], ["lg"]),
        _layer("ex", "Exp", ["lg"], ["ex"]),
        _layer("dr", "Dropout", ["ex"], ["dr"], (), 108, f(1, 0.5)),
        _layer("fl", "Flatten", ["dr"], ["fl"]),
        _layer("rs", "Reshape", ["fl"], ["rs"], (), 133,
               wire.field_bytes(1, v(1, 0) + v(1, c) + v(1, 12))),
        _layer("fc", "InnerProduct", ["rs"], ["fc"],
               [0.1 * rng.randn(3, c * 12), rng.randn(3)], 117,
               v(1, 3) + v(5, 1)),
        _layer("sm", "Softmax", ["fc"], ["sm"]),
    ]
    path = _net(tmp_path / "all.caffemodel", (1, c, 3, 4), layers)
    jnet, tnet = _both(None, path)
    _same_outputs(jnet, tnet, rng.randn(2, c, 3, 4).astype(np.float32),
                  rtol=1e-5, atol=1e-6)
    # BatchNorm's third blob, the moving-average scale factor (the JAX
    # net reads it with float() inside jit and cannot trace it)
    mean, var = rng.randn(c), rng.rand(c) + 0.5
    bn = _net(tmp_path / "bn.caffemodel", (1, c, 3, 4), [
        _layer("bn", "BatchNorm", ["data"], ["bn"],
               [mean, var, np.array([2.0])], 139, f(3, 1e-3))])
    x = rng.randn(2, c, 3, 4).astype(np.float32)
    want = (x - (mean / 2).reshape(1, c, 1, 1)) / np.sqrt(
        (var / 2).reshape(1, c, 1, 1) + 1e-3)
    np.testing.assert_allclose(T.load_caffe(None, bn, device="cpu").predict(
        x, device="cpu"), want, rtol=1e-5, atol=1e-6)
    bad = _net(tmp_path / "bad.caffemodel", (1, c, 3, 4), [
        _layer("w", "Weird", ["data"], ["w"])])
    with pytest.raises(NotImplementedError, match="Weird"):
        T.load_caffe(None, bad, device="cpu").predict(
            np.zeros((1, c, 3, 4), np.float32), device="cpu")


def test_new_format_allcaps_types_not_mangled(tmp_path):
    """'ELU' is a legitimate new-format type name, not a V1 enum."""
    path, _ = _make_model(tmp_path)
    deploy = """
    input: "data"
    input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
    layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
            convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
    layer { name: "e" type: "ELU" bottom: "conv1" top: "e" }
    layer { name: "ip" type: "INNER_PRODUCT" bottom: "e" top: "ip"
            inner_product_param { num_output: 2 } }
    """
    def_path = tmp_path / "elu.prototxt"
    def_path.write_text(deploy)
    jnet, tnet = _both(str(def_path), path)
    assert [l.type for l in tnet.caffe_layers] == \
        [l.type for l in jnet.caffe_layers] == [
        "Convolution", "ELU", "InnerProduct"]


def test_missing_bottom_raises(tmp_path):
    path, _ = _make_model(tmp_path)
    deploy = """
    input: "data"
    input_shape { dim: 1 dim: 3 dim: 8 dim: 8 }
    layer { name: "conv1" type: "Convolution" bottom: "nope" top: "conv1"
            convolution_param { num_output: 4 kernel_size: 3 pad: 1 } }
    """
    def_path = tmp_path / "bad.prototxt"
    def_path.write_text(deploy)
    jnet, tnet = _both(str(def_path), path)
    for call in (lambda: jnet.predict(np.zeros((1, 3, 8, 8), np.float32),
                                      batch_size=1),
                 lambda: tnet.predict(np.zeros((1, 3, 8, 8), np.float32),
                                      batch_size=1, device="cpu")):
        with pytest.raises(KeyError, match="undefined bottom"):
            call()


def test_finetune_caffe_model(tmp_path):
    """A loaded net trains like any model (blobs are params): 12 epochs
    of Adam, losses and final blobs against the JAX fit of the same
    files, evaluate before and after."""
    path, _ = _make_model(tmp_path)
    jnet, tnet = _both(None, path)
    x = np.random.RandomState(3).randn(8, 3, 8, 8).astype(np.float32)
    yt = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    for net in (jnet, tnet):
        net.compile(optimizer="adam", loss="categorical_crossentropy")
    h0 = tnet.evaluate(x, yt, batch_size=8, device="cpu")
    np.testing.assert_allclose(h0["loss"], jnet.evaluate(
        x, yt, batch_size=8)["loss"], rtol=1e-5)
    want = jnet.fit(x, yt, batch_size=8, nb_epoch=12, verbose=0)
    got = tnet.fit(x, yt, batch_size=8, nb_epoch=12, verbose=0,
                   device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    h1 = tnet.evaluate(x, yt, batch_size=8, device="cpu")
    assert h1["loss"] < h0["loss"]
    for k, arr in jnet.params["caffe"]["w"].items():
        np.testing.assert_allclose(
            tnet.params["caffe"]["w"][k].detach().numpy(), np.asarray(arr),
            atol=1e-4, err_msg=k)
    # the JAX net's trained blobs carried over predict the same
    moved = caffe_net_from_jax(jnet, device="cpu")
    np.testing.assert_allclose(
        moved.predict(x, batch_size=8, device="cpu"),
        np.asarray(jnet.predict(x, batch_size=8)), rtol=1e-5, atol=1e-6)


def test_a_saved_caffe_net_loads(tmp_path):
    path, _ = _make_model(tmp_path)
    tnet = T.load_caffe(None, path, device="cpu")
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    want = tnet.predict(x, device="cpu")
    tnet.save(str(tmp_path / "caffe.model"))
    back = T.CaffeNet.load(str(tmp_path / "caffe.model"), device="cpu")
    assert np.array_equal(back.predict(x, device="cpu"), want)


def test_load_caffe_raises_without_a_card(tmp_path, monkeypatch):
    path, _ = _make_model(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.load_caffe(None, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceModel().load_caffe(None, path)
