"""The port's text and sequence slice against the JAX package:
``TextSet`` (word index and arrays), ``Conv1D`` and the 1-D/2-D pooling,
padding, upsampling and cropping layers, and the models built on the
recurrent layers and dropout: ``TextClassifier`` (cnn, lstm, gru),
``AnomalyDetector`` and ``SessionRecommender`` (forward, a 2-epoch
``fit`` and ``save``/``load``).

The models get the JAX model's weights (``keras_params_from_jax``) and
its layer names (dropout keys are ``fold_in(rng, crc32(name))``, so a
``fit`` draws JAX's masks only under the same names).

Tolerances: ``TextSet`` exact; layer outputs and gradients within 1e-5
absolute in f32 (sums in another order); model outputs within 1e-5;
``fit`` per-epoch losses within rtol 1e-4 and every parameter within
1e-4 absolute, as the other f32 fit tests hold them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.feature.text import TextSet as JTextSet
from zoo_tpu.models.anomalydetection import AnomalyDetector as JAnomaly
from zoo_tpu.models.recommendation import SessionRecommender as JSession
from zoo_tpu.models.textclassification import TextClassifier as JText
from zoo_tpu.pipeline.api.keras import layers as jlayers

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.feature.text import TextSet
from zoo_tpu_torch.models.anomalydetection import AnomalyDetector
from zoo_tpu_torch.models.recommendation import SessionRecommender
from zoo_tpu_torch.models.textclassification import TextClassifier
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    tree_leaves,
    tree_map,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet

jax.config.update("jax_platforms", "cpu")

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lambda", "mu", "nu", "xi", "omicron"]


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(
                v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _corpus(root, n_docs=12, seed=0):
    """``root/<category>/<i>.txt``: three categories of random words,
    digits, punctuation and capitals."""
    rs = np.random.RandomState(seed)
    for c in ("sci", "sport", "world"):
        os.makedirs(os.path.join(root, c))
        for i in range(n_docs // 3):
            words = [WORDS[j] if rs.rand() > 0.2 else str(j)
                     for j in rs.zipf(1.5, rs.randint(3, 30)) % len(WORDS)]
            text = " ".join(w.capitalize() if rs.rand() > 0.7 else w
                            for w in words) + ", the end!"
            with open(os.path.join(root, c, f"{i}.txt"), "w") as f:
                f.write(text)


def _chain(ts, **kw):
    return ts.tokenize().normalize().word2idx(**kw).shape_sequence(
        10).generate_sample()


@pytest.mark.parametrize("kw", [{}, {"max_words_num": 6},
                                {"remove_topN": 2, "min_freq": 2}])
def test_text_set_gives_jaxs_word_index_and_arrays(tmp_path, kw):
    _corpus(str(tmp_path / "c"))
    jt = _chain(JTextSet.read(str(tmp_path / "c")), **kw)
    tt = _chain(TextSet.read(str(tmp_path / "c")), **kw)
    assert tt.get_word_index() == jt.get_word_index()
    (jx, jy), (tx, ty) = jt.to_arrays(), tt.to_arrays()
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    assert tx.dtype == np.int32 and tx.shape == (12, 10)
    assert [s[1] for s in tt.get_samples()] == tt.get_labels()
    for jp, tp in zip(jt.random_split([0.75, 0.25], seed=3),
                      tt.random_split([0.75, 0.25], seed=3)):
        assert tp.get_uris() == jp.get_uris()
    tt.save_word_index(str(tmp_path / "wi.json"))
    other = TextSet.read(str(tmp_path / "c")).load_word_index(
        str(tmp_path / "wi.json"))
    assert other.get_word_index() == jt.get_word_index()


def test_text_set_read_csv_and_truncation(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("a,Alpha beta beta 12 gamma\nb,delta delta delta\n")
    for mode in ("pre", "post"):
        j = JTextSet.read_csv(str(path)).tokenize().normalize().word2idx() \
            .shape_sequence(2, trunc_mode=mode)
        t = TextSet.read_csv(str(path)).tokenize().normalize().word2idx() \
            .shape_sequence(2, trunc_mode=mode)
        assert t.get_uris() == ["a", "b"]
        assert np.array_equal(t.to_arrays()[0], j.to_arrays()[0])
        assert t.to_arrays()[1] is None


def _layer_check(jl, tl, x, tol=1e-5):
    jp = jl.build(jax.random.PRNGKey(1), (None,) + x.shape[1:])
    tp = keras_params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    jy = jl.call(jp, jnp.asarray(x))
    w = np.linspace(-1, 1, int(np.prod(jy.shape)),
                    dtype=np.float32).reshape(jy.shape)
    jgp, jgx = jax.grad(lambda p, a: (jl.call(p, a) * w).sum(),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    tree = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl.call(tree, tx)
    assert tuple(ty.shape) == tuple(jy.shape)
    assert tl.compute_output_shape((None,) + x.shape[1:]) == \
        jl.compute_output_shape((None,) + x.shape[1:])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=tol)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(),
                                tree_leaves(tree) + [tx])
    want = _flat(jax.tree_util.tree_map(np.asarray, jgp))
    for k, g in zip(_flat(tree), grads[:-1]):
        np.testing.assert_allclose(g.numpy(), want[k], atol=tol, err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), atol=tol)


@pytest.mark.parametrize("border_mode", ["valid", "same"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [3, 5])
def test_conv1d_matches_jax(border_mode, stride, k):
    x = np.random.RandomState(k).randn(2, 11, 4).astype(np.float32)
    kw = dict(border_mode=border_mode, subsample_length=stride,
              activation="relu")
    _layer_check(jlayers.Conv1D(6, k, **kw), tlayers.Conv1D(6, k, **kw), x)


@pytest.mark.parametrize("name,kw", [
    ("MaxPooling1D", {}), ("MaxPooling1D", {"pool_length": 3, "stride": 2,
                                            "border_mode": "same"}),
    ("AveragePooling1D", {}),
    ("AveragePooling1D", {"pool_length": 3, "stride": 2,
                          "border_mode": "same"}),
    ("GlobalMaxPooling1D", {}), ("GlobalAveragePooling1D", {}),
    ("ZeroPadding1D", {"padding": 2}), ("UpSampling1D", {"length": 3}),
    ("Cropping1D", {"cropping": (1, 2)})])
def test_1d_layers_match_jax(name, kw):
    x = np.random.RandomState(0).randn(2, 9, 3).astype(np.float32)
    _layer_check(getattr(jlayers, name)(**kw), getattr(tlayers, name)(**kw),
                 x)


@pytest.mark.parametrize("order", ["th", "tf"])
@pytest.mark.parametrize("name,kw", [
    ("AveragePooling2D", {}),
    ("AveragePooling2D", {"pool_size": (3, 2), "strides": (2, 1),
                          "border_mode": "same"}),
    ("GlobalMaxPooling2D", {}), ("ZeroPadding2D", {"padding": (1, 2)}),
    ("UpSampling2D", {"size": (2, 3)}),
    ("Cropping2D", {"cropping": ((1, 0), (0, 2))})])
def test_2d_layers_match_jax(order, name, kw):
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    _layer_check(getattr(jlayers, name)(dim_ordering=order, **kw),
                 getattr(tlayers, name)(dim_ordering=order, **kw), x)


@pytest.mark.parametrize("name,kw,shape,out", [
    ("Reshape", {"target_shape": (3, -1)}, (2, 4, 6), (2, 3, 8)),
    ("Permute", {"dims": (2, 1)}, (2, 4, 6), (2, 6, 4)),
    ("RepeatVector", {"n": 3}, (2, 5), (2, 3, 5)),
    ("InputLayer", {}, (2, 5), (2, 5))])
def test_shape_layers_match_jax(name, kw, shape, out):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    _layer_check(getattr(jlayers, name)(**kw), getattr(tlayers, name)(**kw),
                 x)
    assert getattr(tlayers, name)(**kw).call(
        {}, torch.from_numpy(x)).shape == out


def _pair(jm, tm, seed=0):
    """The JAX model's weights and layer names on the port's model."""
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(seed)))
    tm.params = keras_params_from_jax(tree, "cpu")
    assert [type(a).__name__ for a in jm.layers] == \
        [type(b).__name__ for b in tm.layers]
    for a, b in zip(jm.layers, tm.layers):
        b.name = a.name
    return tree


def _fit_both(jm, tm, xs, y, opt="adam", loss=
              "sparse_categorical_crossentropy", batch=4):
    for m in (jm, tm):
        m.compile(optimizer=opt, loss=loss)
    _pair(jm, tm)
    want = jm.fit(xs, y, batch_size=batch, nb_epoch=2, shuffle=True,
                  seed=1, verbose=0)
    got = tm.fit(xs, y, batch_size=batch, nb_epoch=2, shuffle=True, seed=1,
                 verbose=0, device="cpu")
    assert tm._step == jm._step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    have = _flat(tm.params)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray,
                                             jm.params)).items():
        np.testing.assert_allclose(have[k], v, atol=1e-4, err_msg=k)


TEXT_CFG = dict(class_num=3, token_length=8, sequence_length=12, vocab=30,
                encoder_output_dim=6, hidden_drop=0.2)


@pytest.mark.parametrize("encoder", ["cnn", "lstm", "gru"])
def test_text_classifier_forward_and_fit_match_jax(encoder):
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 30, (16, 12)).astype(np.int32)
    y = rs.randint(0, 3, 16).astype(np.int32)
    jm = JText(encoder=encoder, **TEXT_CFG)
    tm = TextClassifier(encoder=encoder, **TEXT_CFG)
    _pair(jm, tm)
    np.testing.assert_allclose(tm.predict(ids, device="cpu"),
                               np.asarray(jm.predict(ids)), atol=1e-5)
    _fit_both(jm, tm, ids, y)


def test_text_classifier_from_a_text_set_saves_and_loads(tmp_path):
    _corpus(str(tmp_path / "c"), n_docs=9)
    ts = TextSet.read(str(tmp_path / "c")).tokenize().normalize() \
        .word2idx(max_words_num=10).shape_sequence(12)
    x, y = ts.to_arrays()
    m = TextClassifier(encoder="lstm", **dict(TEXT_CFG, vocab=11))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    hist = m.fit(x, y, batch_size=3, nb_epoch=1, verbose=0, device="cpu")
    assert np.isfinite(hist["loss"]).all()
    path = str(tmp_path / "m.model")
    m.save(path)
    back = KerasNet.load(path, device="cpu")
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  m.predict(x, device="cpu"))
    with pytest.raises(ValueError, match="encoder"):
        TextClassifier(3, encoder="rnn")


def test_anomaly_detector_matches_jax():
    series = np.sin(np.arange(80) / 4.0).astype(np.float32) + \
        0.1 * np.random.RandomState(0).randn(80).astype(np.float32)
    x, y = AnomalyDetector.unroll(series, 6)
    jx, jy = JAnomaly.unroll(series, 6)
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    x, y = x[:72], y[:72]
    kw = dict(hidden_layers=(4, 6, 3), dropouts=(0.2, 0.2, 0.2))
    jm, tm = JAnomaly((6, 1), **kw), AnomalyDetector((6, 1), **kw)
    _pair(jm, tm)
    np.testing.assert_allclose(tm.predict(x, device="cpu"),
                               np.asarray(jm.predict(x)), atol=1e-5)
    _fit_both(jm, tm, x, y, loss="mse", batch=8)
    pred = tm.predict(x, device="cpu")
    assert tm.detect_anomalies(y, pred, 3) == \
        jm.detect_anomalies(y, pred, 3)


@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_matches_jax(history, tmp_path):
    kw = dict(item_embed=5, rnn_hidden_layers=(6, 4), session_length=7,
              include_history=history, mlp_hidden_layers=(5,),
              history_length=3)
    jm, tm = JSession(20, **kw), SessionRecommender(20, **kw)
    rs = np.random.RandomState(4)
    xs = [rs.randint(0, 21, (12, 7)).astype(np.int32)]
    if history:
        xs.append(rs.randint(0, 21, (12, 3)).astype(np.int32))
    y = rs.randint(0, 21, 12).astype(np.int32)
    _pair(jm, tm)
    feed = xs if history else xs[0]
    np.testing.assert_allclose(tm.predict(feed, device="cpu"),
                               np.asarray(jm.predict(feed)), atol=1e-5)
    assert tm.recommend_for_session(feed, 3, device="cpu") == \
        [[(i, pytest.approx(p, abs=1e-5)) for i, p in row]
         for row in jm.recommend_for_session(feed, 3)]
    _fit_both(jm, tm, feed, y)
    path = str(tmp_path / "s.model")
    tm.save(path)
    np.testing.assert_array_equal(
        KerasNet.load(path, device="cpu").predict(feed, device="cpu"),
        tm.predict(feed, device="cpu"))


def test_keras_params_from_jax_carries_the_sequence_trees():
    """``W``/``U``/``b`` of each recurrent layer, ``Bidirectional``'s
    ``{fw, bw}`` pair and ``Conv1D``'s ``(k, cin, cout)`` by name and
    shape."""
    from zoo_tpu.pipeline.api.keras import Sequential as JSeq
    jm = JSeq()
    jm.add(jlayers.Conv1D(4, 3, input_shape=(9, 5)))
    jm.add(jlayers.Bidirectional(jlayers.LSTM(3, return_sequences=True)))
    jm.add(jlayers.GRU(2))
    want = _flat(jax.tree_util.tree_map(np.asarray, jm.build()))
    got = _flat(keras_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.params), "cpu"))
    assert set(got) == set(want) == {
        "000_convolution1d/W", "000_convolution1d/b",
        "001_bidirectional/fw/W", "001_bidirectional/fw/U",
        "001_bidirectional/fw/b", "001_bidirectional/bw/W",
        "001_bidirectional/bw/U", "001_bidirectional/bw/b",
        "002_gru/W", "002_gru/U", "002_gru/b"}
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(
            got[k], want[k])
    assert got["000_convolution1d/W"].shape == (3, 5, 4)
