"""The port's Seq2seq (``zoo_tpu_torch.models.seq2seq``) against the JAX
package's on the same seeded numpy inputs, the JAX model's weights
carried over by ``keras_params_from_jax``, on the CPU: every cell type
under every bridge (dense, densenonlinear, customized, and none: the
states passed through), teacher-forced and greedy.

Tolerances (f32): forward (greedy decoding) within 1e-5 absolute; the
losses of 4 ``fit`` steps (one step an epoch) within 1e-4 relative; the
``infer`` outputs within 1e-5.
"""

import jax
import numpy as np
import pytest

from zoo_tpu.models.seq2seq import Bridge as JBridge
from zoo_tpu.models.seq2seq import RNNDecoder as JDecoder
from zoo_tpu.models.seq2seq import RNNEncoder as JEncoder
from zoo_tpu.models.seq2seq import Seq2seq as JSeq2seq
from zoo_tpu.pipeline.api.keras import layers as jlayers

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.seq2seq import (
    Bridge,
    RNNDecoder,
    RNNEncoder,
    Seq2seq,
)
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers

jax.config.update("jax_platforms", "cpu")

N, T, F, H = 16, 5, 3, 6


def _data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(N, T, F).astype(np.float32)
    y = x[:, ::-1].copy()
    dec = np.concatenate([np.zeros((N, 1, F), np.float32), y[:, :-1]], 1)
    return x, y, dec


def _make(pkg, rnn, bridge, layers=1):
    E, D, B, S, L = pkg
    if bridge is None:
        br = None
    elif bridge == "customized":
        states = 2 if rnn == "lstm" else 1
        br = B.initialize_from_keras_layer(L.Dense(states * layers * H,
                                                   activation="tanh"))
    else:
        br = B.initialize(bridge, H)
    return S(E.initialize(rnn, layers, H), D.initialize(rnn, layers, H),
             (T, F), (T, F), br, L.Dense(F))


JAX = (JEncoder, JDecoder, JBridge, JSeq2seq, jlayers)
PORT = (RNNEncoder, RNNDecoder, Bridge, Seq2seq, tlayers)


def _pair(jm, tm, seed=0):
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(seed)))
    tm.params = keras_params_from_jax(tree, "cpu")
    for a, b in zip(jm.layers, tm.layers):
        b.name = a.name


@pytest.mark.parametrize("bridge", ["dense", "densenonlinear",
                                    "customized", None])
@pytest.mark.parametrize("rnn", ["lstm", "gru", "simplernn"])
def test_seq2seq_forward_and_fit_match_jax(rnn, bridge):
    """Two stacked layers under the dense bridge (its states split
    across them), one under the others."""
    x, y, dec = _data()
    layers = 2 if bridge == "dense" else 1
    jm, tm = _make(JAX, rnn, bridge, layers), _make(PORT, rnn, bridge,
                                                    layers)
    _pair(jm, tm)
    np.testing.assert_allclose(tm.predict([x, dec], device="cpu"),
                               np.asarray(jm.predict([x, dec])), atol=1e-5)
    for m in (jm, tm):
        m.compile(optimizer="adam", loss="mse")
    want = jm.fit([x, dec], y, batch_size=N, nb_epoch=4, verbose=0, seed=1)
    got = tm.fit([x, dec], y, batch_size=N, nb_epoch=4, verbose=0, seed=1,
                 device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_greedy_infer_matches_jax_with_and_without_a_stop_sign():
    x, y, dec = _data(1)
    jm, tm = _make(JAX, "lstm", "dense", 1), _make(PORT, "lstm", "dense", 1)
    _pair(jm, tm, seed=3)
    start = np.full(F, 0.5, np.float32)
    want = jm.infer(x[0], start_sign=start, max_seq_len=6)
    got = tm.infer(x[0], start_sign=start, max_seq_len=6, device="cpu")
    assert got.shape == want.shape == (1, 7, F)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[0, 0], start)
    # a stop sign equal to the third generated step trims after it
    stop = got[0, 3]
    want = jm.infer(x[0], start_sign=start, max_seq_len=6,
                    stop_sign=np.asarray(want[0, 3]))
    got = tm.infer(x[0], start_sign=start, max_seq_len=6, stop_sign=stop,
                   device="cpu")
    assert got.shape == want.shape == (1, 4, F)
    np.testing.assert_allclose(got, want, atol=1e-5)
    batch = tm.infer(x[:3], start_sign=start, max_seq_len=4, device="cpu")
    assert batch.shape == (3, 5, F)
    np.testing.assert_allclose(
        batch, jm.infer(x[:3], start_sign=start, max_seq_len=4), atol=1e-5)
    with pytest.raises(ValueError, match="single sample"):
        tm.infer(x[:2], start_sign=start, max_seq_len=3,
                 stop_sign=stop, device="cpu")


def test_free_run_training_matches_jax():
    """The simplified single-input form self-feeds in training too, from
    a zero start token, for ``target_length`` steps."""
    rs = np.random.RandomState(2)
    x = rs.randn(N, 7, 2).astype(np.float32)
    y = rs.randn(N, 3, 4).astype(np.float32)
    kw = dict(input_length=7, input_dim=2, target_length=3, output_dim=4,
              rnn_type="gru", hidden_size=5, num_layers=2)
    jm, tm = JSeq2seq(**kw), Seq2seq(**kw)
    _pair(jm, tm)
    np.testing.assert_allclose(tm.predict(x, device="cpu"),
                               np.asarray(jm.predict(x)), atol=1e-5)
    for m in (jm, tm):
        m.compile(optimizer="adam", loss="mse")
    want = jm.fit(x, y, batch_size=N, nb_epoch=3, verbose=0, seed=2)
    got = tm.fit(x, y, batch_size=N, nb_epoch=3, verbose=0, seed=2,
                 device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    with pytest.raises(ValueError, match="two-input"):
        tm.infer(x[0], start_sign=np.zeros(4), device="cpu")


def test_teacher_forcing_through_embeddings_matches_jax():
    """Int-id encoder and decoder inputs through embeddings: the decoder
    reads the ids it is given, in training and in predict."""
    rs = np.random.RandomState(4)
    enc = rs.randint(0, 9, (N, T)).astype(np.int32)
    dec = rs.randint(0, 9, (N, T)).astype(np.int32)
    y = rs.randn(N, T, 9).astype(np.float32)

    def make(pkg):
        E, D, B, S, L = pkg
        return S(E.initialize("lstm", 1, H, embedding=L.Embedding(9, 4)),
                 D.initialize("lstm", 1, H, embedding=L.Embedding(9, 4)),
                 (T,), (T,), B.initialize("dense", H), L.Dense(9))

    jm, tm = make(JAX), make(PORT)
    _pair(jm, tm)
    np.testing.assert_allclose(tm.predict([enc, dec], device="cpu"),
                               np.asarray(jm.predict([enc, dec])),
                               atol=1e-5)
    for m in (jm, tm):
        m.compile(optimizer="adam", loss="mse")
    want = jm.fit([enc, dec], y, batch_size=N, nb_epoch=2, verbose=0)
    got = tm.fit([enc, dec], y, batch_size=N, nb_epoch=2, verbose=0,
                 device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_seq2seq_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="lstm\\|gru\\|simplernn"):
        RNNEncoder.initialize("rnn", 1, 4)
    with pytest.raises(ValueError, match="bridge_type"):
        Bridge.initialize("conv", 4)
    with pytest.raises(ValueError, match="keras layer"):
        Bridge("customized", 4)
    with pytest.raises(ValueError, match="encoder, decoder"):
        Seq2seq()
    with pytest.raises(TypeError, match="cannot be None"):
        Seq2seq(RNNEncoder.initialize("gru", 1, 4),
                RNNDecoder.initialize("gru", 1, 4))
