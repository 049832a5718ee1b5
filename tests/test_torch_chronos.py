"""The port's Chronos (``zoo_tpu_torch.chronos``: TSDataset, the LSTM,
TCN, Seq2Seq, MTNet, TCMF and ARIMA forecasters, the detectors) against
the JAX package's on the same seeded numpy inputs, on the CPU, the JAX
package run without an orca context so the batch sizes match.

Tolerances: TSDataset's arrays exactly equal. Forecasts within 1e-5
absolute and fit losses within 1e-4 relative of JAX's with the JAX
model's weights (and layer names, from which the dropout keys derive)
carried over; the dropout masks are bit-equal to JAX's eager ones, and
JAX's jitted step multiplies by the reciprocal of the keep rate where
the eager layer divides, one f32 ulp apart on some elements, well
inside 1e-4. TCMF forecasts within 1e-4 relative (k x k ridge solves
by another LAPACK path). ARIMA within 1e-6 relative (the same numpy and
scipy path). A model that the JAX package builds inside its own ``fit``
(the AE detector's, TCMF's TCN) starts in the port from the weights
the JAX ``fit`` draws, through :func:`_jax_initial_weights`.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest

from zoo_tpu.chronos import forecaster as jfc
from zoo_tpu.chronos.data import TSDataset as JTS
from zoo_tpu.chronos.detector import anomaly as janom
from zoo_tpu.chronos.forecaster.tcn_forecaster import (
    _CausalConvBlock as JBlock,
)
from zoo_tpu.pipeline.api.keras import Sequential as JSequential
from zoo_tpu.pipeline.api.keras import layers as jlayers

from zoo_tpu_torch.chronos import forecaster as tfc
from zoo_tpu_torch.chronos.data import TSDataset, dt_features, roll_windows
from zoo_tpu_torch.chronos.detector import anomaly as tanom
from zoo_tpu_torch.chronos.forecaster.tcn_forecaster import (
    _CausalConvBlock as TBlock,
)
from zoo_tpu_torch.convert import keras_params_from_jax, tcmf_from_jax
from zoo_tpu_torch.pipeline.api.keras import layers as tlayers
from zoo_tpu_torch.pipeline.api.keras.engine import topology

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.array(
                v.detach() if hasattr(v, "detach") else v)
    return out


def _frame(n=60, ids=("a",), seed=0, nan_at=()):
    t = pd.date_range("2024-12-28", periods=n, freq="7h")
    rows = []
    for j, sid in enumerate(ids):
        rs = np.random.RandomState(seed + j)
        v = np.sin(np.arange(n) * 2 * np.pi / 24) + 0.05 * rs.randn(n)
        rows.append(pd.DataFrame({"ts": t, "value": v,
                                  "extra": rs.randn(n).astype(np.float32),
                                  "id": sid}))
    df = pd.concat(rows, ignore_index=True)
    for i in nan_at:
        df.loc[i, "value"] = np.nan
    # shuffled rows: from_pandas sorts them
    return df.sample(frac=1.0, random_state=seed).reset_index(drop=True)


def _pair_ts(df, **kw):
    kw = dict(dict(dt_col="ts", target_col="value"), **kw)
    return JTS.from_pandas(df, **kw), TSDataset.from_pandas(df, **kw)


def _same_rolled(a, b, lookback=6, horizon=2):
    a.roll(lookback, horizon)
    b.roll(lookback, horizon)
    (ax, ay), (bx, by) = a.to_numpy(), b.to_numpy()
    assert ax.dtype == bx.dtype and np.array_equal(ax, bx)
    assert (ay is None and by is None) or (
        ay.dtype == by.dtype and np.array_equal(ay, by))


# ---------------------------------------------------------------- TSDataset

@pytest.mark.parametrize("horizon", [0, 1, 3, [1, 4]])
@pytest.mark.parametrize("ids", [("a",), ("b", "a", "c")])
def test_roll_matches_jax_and_never_crosses_an_id(ids, horizon):
    df = _frame(30, ids)
    kw = dict(id_col="id", extra_feature_col="extra") if len(ids) > 1 \
        else dict(extra_feature_col=["extra"])
    a, b = _pair_ts(df, **kw)
    _same_rolled(a, b, 5, horizon)
    x, _ = b.to_numpy()
    per_id = 30 - 5 - (max(horizon) if isinstance(horizon, list)
                       else horizon) + 1
    assert x.shape == (len(ids) * per_id, 5, 2)
    # each id's windows are its own rows, in order
    for g, sid in enumerate(sorted(ids)):
        own = df[df["id"] == sid].sort_values("ts")
        vals = own[["value", "extra"]].to_numpy().astype(np.float32)
        np.testing.assert_array_equal(x[g * per_id:(g + 1) * per_id],
                                      roll_windows(vals, None, 5,
                                                   horizon)[0][:per_id])


def test_from_numpy_rolls_as_from_pandas_and_needs_no_frame():
    df = _frame(40, ("b", "a"))
    cols = {c: df[c].to_numpy() for c in ("ts", "value", "extra", "id")}
    b = TSDataset.from_numpy(cols, dt_col="ts", target_col="value",
                             id_col="id", extra_feature_col="extra")
    assert isinstance(b.df, dict)
    a = JTS.from_pandas(df, dt_col="ts", target_col="value", id_col="id",
                        extra_feature_col="extra")
    a.gen_dt_feature(["HOUR", "WEEKDAY"])
    b.gen_dt_feature(["HOUR", "WEEKDAY"])
    _same_rolled(a, b, 7, 3)
    assert isinstance(b.df, dict)
    one = df[df["id"] == "a"]
    cols = {c: one[c].to_numpy() for c in ("ts", "value", "extra")}
    for parts in zip(JTS.from_pandas(one, "ts", "value", with_split=True,
                                     val_ratio=0.2, test_ratio=0.1),
                     TSDataset.from_numpy(cols, "ts", "value",
                                          with_split=True, val_ratio=0.2,
                                          test_ratio=0.1)):
        _same_rolled(*parts, 2, 1)


def test_dt_features_are_pandas_calendar_fields():
    """Every calendar feature, over stamps that cross year ends and ISO
    week 53 / week 1 boundaries, equals pandas' ``.dt`` fields."""
    t = pd.date_range("2019-12-25", "2027-01-08", freq="5h37min")
    got = dt_features(t.to_numpy())
    dt = t.to_series().dt
    want = {"HOUR": dt.hour, "DAY": dt.day, "MONTH": dt.month,
            "WEEKDAY": dt.weekday, "MINUTE": dt.minute,
            "DAYOFYEAR": dt.dayofyear,
            "WEEKOFYEAR": dt.isocalendar().week,
            "IS_WEEKEND": (dt.weekday >= 5).astype(np.int64)}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.to_numpy(np.int64),
                                      err_msg=k)
    with pytest.raises(ValueError, match="dt feature"):
        dt_features(t.to_numpy(), ["SECOND"])


@pytest.mark.parametrize("op", [
    ("impute", ("last",)), ("impute", ("const", 7.0)),
    ("impute", ("linear",)), ("deduplicate", ()),
    ("resample", ("1D",)), ("gen_dt_feature", ()),
    ("gen_rolling_feature", (4, "minimal")),
    ("gen_rolling_feature", (5, "comprehensive")),
    ("gen_global_feature", ("minimal",)),
    ("gen_global_feature", ("comprehensive",))],
    ids=lambda o: "-".join(map(str, (o[0],) + tuple(o[1]))))
def test_table_operations_match_jax(op):
    name, args = op
    df = _frame(48, ("b", "a"), nan_at=(3, 4, 50))
    if name == "deduplicate":
        df = pd.concat([df, df.iloc[:7]], ignore_index=True)
    a, b = _pair_ts(df, id_col="id", extra_feature_col="extra")
    if name not in ("impute", "resample"):
        a.impute("last")
        b.impute("last")
    getattr(a, name)(*args)
    getattr(b, name)(*args)
    assert a.feature_col == b.feature_col
    pd.testing.assert_frame_equal(b.to_pandas(), a.to_pandas(),
                                  check_exact=True)
    _same_rolled(a, b, 3, 1)


def test_scale_unscale_match_jax():
    from sklearn.preprocessing import StandardScaler

    df = _frame(40)
    a, b = _pair_ts(df, extra_feature_col="extra")
    a.scale(StandardScaler())
    b.scale(StandardScaler())
    pd.testing.assert_frame_equal(b.to_pandas(), a.to_pandas(),
                                  check_exact=True)
    _same_rolled(a, b, 5, 2)
    y = b.to_numpy()[1]
    assert np.array_equal(b.unscale_numpy(y), a.unscale_numpy(y))
    a.unscale()
    b.unscale()
    pd.testing.assert_frame_equal(b.to_pandas(), a.to_pandas(),
                                  check_exact=True)
    cols = {c: df[c].to_numpy() for c in df}
    n = TSDataset.from_numpy(cols, "ts", "value", extra_feature_col="extra")
    n.scale(StandardScaler())
    _same_rolled(a.scale(StandardScaler()), n, 5, 2)


def test_roll_refuses_windows_longer_than_every_series():
    b = TSDataset.from_pandas(_frame(10), "ts", "value")
    with pytest.raises(ValueError, match="exceeds every series"):
        b.roll(8, 4)
    with pytest.raises(RuntimeError, match="roll"):
        TSDataset.from_pandas(_frame(10), "ts", "value").to_numpy()


# ------------------------------------------------------------- forecasters

def _carry(jf, tf, seed=0):
    """Build both forecasters' models, the JAX one's weights and layer
    names onto the port's."""
    jf._build()
    tf._ensure_model()
    jm, tm = jf.model, tf.model
    tree = jax.tree_util.tree_map(np.asarray, jm.build(
        jax.random.PRNGKey(seed)))
    tm.params = keras_params_from_jax(tree, "cpu")
    assert [type(a).__name__ for a in jm.layers] == \
        [type(b).__name__ for b in tm.layers]
    for a, b in zip(jm.layers, tm.layers):
        b.name = a.name


def _windows(n=40, lookback=8, horizon=2, feat=2, targets=1, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n + lookback + horizon)
    base = np.sin(t * 2 * np.pi / 12)[:, None] + 0.1 * rs.randn(
        len(t), feat)
    vals = base.astype(np.float32)
    return roll_windows(vals, vals[:, :targets], lookback, horizon)


FORECASTERS = {
    "lstm": (lambda M, **d: M.LSTMForecaster(
        8, 2, 1, hidden_dim=[5, 4], dropout=0.2, future_seq_len=2, **d),
        dict(horizon=2)),
    "lstm-rmsprop": (lambda M, **d: M.LSTMForecaster(
        8, 2, 1, hidden_dim=5, dropout=0.0, optimizer="rmsprop",
        lr=0.01, **d), dict(horizon=1)),
    "tcn": (lambda M, **d: M.TCNForecaster(
        8, 2, 2, 1, num_channels=[5, 4], kernel_size=3, dropout=0.2, **d),
        dict(horizon=2)),
    "seq2seq": (lambda M, **d: M.Seq2SeqForecaster(
        8, 3, 2, 1, lstm_hidden_dim=5, lstm_layer_num=2, **d),
        dict(horizon=3)),
    "mtnet": (lambda M, **d: M.MTNetForecaster(
        target_dim=1, feature_dim=2, long_series_num=3, series_length=2,
        ar_window_size=2, cnn_height=2, cnn_hid_size=4, rnn_hid_size=3,
        **d), dict(horizon=1)),
}


@pytest.mark.parametrize("kind", sorted(FORECASTERS))
def test_forecaster_predict_and_fit_match_jax(kind):
    make, data = FORECASTERS[kind]
    jf, tf = make(jfc), make(tfc, device="cpu")
    x, y = _windows(**data)
    _carry(jf, tf)
    np.testing.assert_allclose(tf.predict(x), jf.predict(x), atol=1e-5)
    epochs = 3 if kind == "seq2seq" else 2   # seq2seq: 1 free-run epoch
    want = jf.fit((x, y), epochs=epochs, batch_size=8, seed=3)
    got = tf.fit((x, y), epochs=epochs, batch_size=8, seed=3)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(tf.predict(x), jf.predict(x), atol=1e-4)
    jm, tm = jf.evaluate((x, y), ["mse", "smape", "r2"]), \
        tf.evaluate((x, y), ["mse", "smape", "r2"])
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-3)


def test_seq2seq_forecaster_validation_and_refit_match_jax():
    """A second ``fit`` after the free-run fine-tune recompiles the
    teacher-phase optimizer, in both packages."""
    make, data = FORECASTERS["seq2seq"]
    jf, tf = make(jfc), make(tfc, device="cpu")
    x, y = _windows(**data)
    _carry(jf, tf)
    for epochs in (3, 1):
        want = jf.fit((x, y), epochs=epochs, batch_size=8,
                      validation_data=(x[:8], y[:8]))
        got = tf.fit((x, y), epochs=epochs, batch_size=8,
                     validation_data=(x[:8], y[:8]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert tf.model._core.train_self_feed is False


def test_forecasters_from_a_tsdataset_and_its_guard(monkeypatch):
    ts = TSDataset.from_pandas(_frame(50), "ts", "value",
                               extra_feature_col="extra")
    ts.roll(6, 2)
    f = tfc.LSTMForecaster.from_tsdataset(ts, hidden_dim=3, device="cpu")
    assert (f.past_seq_len, f.input_feature_num, f.output_feature_num) == \
        (6, 2, 1)
    f.future_seq_len = 2
    f._ctor_args["future_seq_len"] = 2
    hist = f.fit(ts, epochs=1, batch_size=8)
    assert np.isfinite(hist["loss"]).all()
    assert f.model._guard is not None   # ZOO_GUARD unset: on
    assert f.predict(ts).shape == (len(ts.numpy_x), 2, 1)
    t = tfc.TCNForecaster.from_tsdataset(ts, num_channels=[3],
                                         device="cpu")
    s = tfc.Seq2SeqForecaster.from_tsdataset(ts, lstm_hidden_dim=3,
                                             device="cpu")
    assert t.future_seq_len == s.future_seq_len == 2
    m = tfc.MTNetForecaster.from_tsdataset(ts, past_seq_len=6,
                                           cnn_hid_size=3, rnn_hid_size=3,
                                           device="cpu")
    assert m.past_seq_len == 6 and ts.numpy_y.shape[1] == 1
    with pytest.raises(ValueError, match="even"):
        tfc.MTNetForecaster.from_tsdataset(ts, past_seq_len=5)
    monkeypatch.setenv("ZOO_GUARD", "0")
    g = tfc.LSTMForecaster(6, 2, 1, hidden_dim=3, device="cpu")
    g.fit(ts, epochs=1, batch_size=8)
    assert g.model._guard is None


def test_forecaster_weight_files_cross_both_ways(tmp_path):
    make, data = FORECASTERS["tcn"]
    jf, tf = make(jfc), make(tfc, device="cpu")
    x, y = _windows(**data)
    _carry(jf, tf, seed=4)
    tf.fit((x, y), epochs=1, batch_size=8)
    p = str(tmp_path / "port.pkl")
    tf.save(p)
    back = make(tfc, device="cpu").load(p)
    np.testing.assert_array_equal(back.predict(x), tf.predict(x))
    jback = make(jfc).load(p)
    np.testing.assert_allclose(jback.predict(x), tf.predict(x), atol=1e-5)
    jf.fit((x, y), epochs=1, batch_size=8)
    q = str(tmp_path / "jax.pkl")
    jf.save(q)
    np.testing.assert_allclose(make(tfc, device="cpu").load(q).predict(x),
                               jf.predict(x), atol=1e-5)


def test_dilated_reference_conv_matches_jax_with_its_gradients():
    """The TCN block (two dilated causal convs, the 1x1 skip) forward
    and its gradients in every weight and the input, dropout off."""
    x = np.random.RandomState(2).randn(3, 11, 4).astype(np.float32)
    jl, tl = JBlock(5, 3, dilation=4), TBlock(5, 3, dilation=4)
    jp = jl.build(jax.random.PRNGKey(1), (None, 11, 4))
    import torch
    tp = {k: v.requires_grad_() for k, v in keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu").items()}
    w = np.linspace(-1, 1, 3 * 11 * 5, dtype=np.float32).reshape(3, 11, 5)

    def jloss(p, a):
        return (jl.call(p, a) * w).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jax.numpy.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tl.call(tp, tx)
    np.testing.assert_allclose(ty.detach().numpy(),
                               np.asarray(jl.call(jp, x)), atol=1e-5)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(),
                                [tp[k] for k in sorted(tp)] + [tx])
    for k, g in zip(sorted(tp), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx),
                               atol=1e-4)


def test_keras_params_from_jax_carries_the_chronos_trees():
    """Every leaf of the Seq2seq core's tree (cells, bridge, generator,
    embeddings), the TCN blocks' and MTNet's, by name and shape."""
    from zoo_tpu.models.seq2seq import Bridge, RNNDecoder, RNNEncoder
    from zoo_tpu.models.seq2seq import Seq2seq as JS2S

    emb = jlayers.Embedding(7, 3)
    s2s = JS2S(RNNEncoder.initialize("gru", 2, 4, embedding=emb),
               RNNDecoder.initialize("lstm", 1, 4,
                                     embedding=jlayers.Embedding(7, 2)),
               (5,), (4,), Bridge.initialize("densenonlinear", 4),
               jlayers.Dense(7))
    trees = {"seq2seq": s2s.build(jax.random.PRNGKey(0))}
    for kind in ("tcn", "mtnet"):
        jf = FORECASTERS[kind][0](jfc)
        jf._build()
        trees[kind] = jf.model.build(jax.random.PRNGKey(0))
    expect = {
        "seq2seq": {"000__seq2seqcore/" + k for k in (
            "enc_emb/E", "dec_emb/E", "bridge/w", "bridge/b", "gen/W",
            "gen/b", "enc_0/W", "enc_0/U", "enc_0/b", "enc_1/W",
            "enc_1/U", "enc_1/b", "dec_0/W", "dec_0/U", "dec_0/b")},
        "tcn": {"000__causalconvblock/W1", "000__causalconvblock/b1",
                "000__causalconvblock/W2", "000__causalconvblock/b2",
                "000__causalconvblock/Wskip", "001__causalconvblock/W1",
                "001__causalconvblock/b1", "001__causalconvblock/W2",
                "001__causalconvblock/b2", "001__causalconvblock/Wskip",
                "003_dense/W", "003_dense/b"}}
    for name, tree in trees.items():
        want = _flat(jax.tree_util.tree_map(np.asarray, tree))
        got = _flat(keras_params_from_jax(jax.tree_util.tree_map(
            np.asarray, tree), "cpu"))
        assert set(got) == set(want)
        if name in expect:
            assert set(want) == expect[name]
        for k in want:
            assert got[k].shape == want[k].shape and np.array_equal(
                got[k], want[k]), (name, k)
    assert set(_flat(jax.tree_util.tree_map(np.asarray,
                                            trees["mtnet"]))) == {
        "001_convolution1d/W", "001_convolution1d/b", "002_gru/W",
        "002_gru/U", "002_gru/b", "008_dense/W", "008_dense/b",
        "010_dense/W"}
    assert _flat(trees["tcn"])["000__causalconvblock/W1"].shape == (3, 2, 5)


# -------------------------------------------------------------------- TCMF

def _panel(m=12, t=60, seed=0):
    """``examples/tcmf_panel_forecast.py``'s panel at a small size."""
    rs = np.random.RandomState(seed)
    x1 = np.empty(t, np.float32)
    x1[0] = 0.2
    for i in range(1, t):
        x1[i] = 0.95 * x1[i - 1] + (0.4 if x1[i - 1] < 0 else -0.4)
    x2 = np.empty(t, np.float32)
    x2[0] = -0.3
    for i in range(1, t):
        x2[i] = 0.9 * x2[i - 1] + (0.5 if x2[i - 1] < 0.1 else -0.6)
    F = rs.randn(m, 2).astype(np.float32)
    return (F @ np.stack([x1, x2]) + 0.01 * rs.randn(m, t)).astype(
        np.float32)


def _jax_twin(tm):
    """The JAX model of the port model ``tm``'s structure (its layers'
    classes and sizes), whose ``build`` draws the weights the JAX
    ``fit`` of that structure starts from."""
    jm = JSequential()
    for layer in tm.layers:
        if isinstance(layer, tlayers.Dense):
            jl = jlayers.Dense(layer.output_dim, bias=layer.bias)
        elif isinstance(layer, TBlock):
            jl = JBlock(layer.channels, layer.kernel_size, layer.dilation,
                        layer.dropout)
        elif isinstance(layer, tlayers.LSTM):
            jl = jlayers.LSTM(layer.output_dim,
                              return_sequences=layer.return_sequences)
        elif isinstance(layer, tlayers.Dropout):
            jl = jlayers.Dropout(layer.p)
        else:
            jl = jlayers.Lambda(layer.function,
                                output_shape=layer._output_shape)
        jm.add(jl)
    return jm


@pytest.fixture
def _jax_initial_weights(monkeypatch):
    """Models that the port builds inside a ``fit`` start from the
    weights the JAX ``fit`` of the same structure draws
    (``PRNGKey(seed)``)."""
    real = topology.KerasNet.build

    def build(self, generator=None, input_shapes=None, device=None):
        if self.params is None and generator is not None:
            tree = _jax_twin(self).build(
                jax.random.PRNGKey(generator.initial_seed()),
                [tuple(s) for s in input_shapes])
            self._built_shapes = [tuple(s) for s in input_shapes]
            self.params = keras_params_from_jax(
                jax.tree_util.tree_map(np.asarray, tree), generator.device)
            return self.params
        return real(self, generator, input_shapes, device)

    monkeypatch.setattr(topology.KerasNet, "build", build)


@pytest.mark.parametrize("temporal", ["ar", "tcn"])
def test_tcmf_fit_and_forecast_match_jax(temporal, tmp_path,
                                         _jax_initial_weights):
    Y = _panel()
    train, test = Y[:, :-4], Y[:, -4:]
    kw = dict(rank=2, ar_lag=6, temporal_model=temporal, normalize=True)
    if temporal == "tcn":
        kw.update(tcn_epochs=4, dropout=0.0, lr=2e-3, kernel_size=3,
                  num_channels_X=[4, 4])
    jf, tf = jfc.TCMFForecaster(**kw), tfc.TCMFForecaster(device="cpu",
                                                          **kw)
    want, got = jf.fit({"y": train}), tf.fit({"y": train})
    assert got["mse"] == pytest.approx(want["mse"], rel=1e-4)
    for k in ("F", "X", "ar"):
        np.testing.assert_allclose(getattr(tf, k), getattr(jf, k),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tf.predict(4), jf.predict(4), rtol=1e-4,
                               atol=1e-5)
    # the JAX forecaster's state carried over forecasts as it does
    carried = tcmf_from_jax(jf, "cpu")
    np.testing.assert_allclose(carried.predict(4), jf.predict(4),
                               rtol=1e-4, atol=1e-6)
    assert tf.evaluate({"y": test})["mse"] == pytest.approx(
        jf.evaluate({"y": test})["mse"], rel=1e-3)
    # save/load: the port's files, and the JAX package's
    p = str(tmp_path / "port.npz")
    tf.save(p)
    np.testing.assert_array_equal(
        tfc.TCMFForecaster.load(p, device="cpu").predict(4), tf.predict(4))
    q = str(tmp_path / "jax.npz")
    jf.save(q)
    np.testing.assert_allclose(
        tfc.TCMFForecaster.load(q, device="cpu").predict(4), jf.predict(4),
        rtol=1e-4, atol=1e-6)
    tf.fit_incremental({"y": test})
    jf.fit_incremental({"y": test})
    np.testing.assert_allclose(tf.predict(3), jf.predict(3), rtol=1e-3,
                               atol=1e-4)


def test_tcmf_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="temporal_model"):
        tfc.TCMFForecaster(temporal_model="lstm")
    with pytest.raises(ValueError, match="ar_lag \\+ 8"):
        tfc.TCMFForecaster(rank=2, ar_lag=6, temporal_model="tcn",
                           device="cpu").fit(_panel(t=12))
    with pytest.raises(RuntimeError, match="fit"):
        tfc.TCMFForecaster().predict(2)


# ------------------------------------------------------------------- ARIMA

@pytest.mark.parametrize("order", [(2, 0, 1), (1, 1, 2), (2, 2, 0)])
def test_arima_matches_jax(order, tmp_path):
    rs = np.random.RandomState(1)
    y = np.cumsum(0.3 * rs.randn(90)) + np.sin(np.arange(90) / 3.0)
    jf, tf = jfc.ARIMAForecaster(*order), tfc.ARIMAForecaster(*order)
    want = jf.fit(y[:80], validation_data=y[80:])
    got = tf.fit(y[:80], validation_data=y[80:])
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6)
    np.testing.assert_allclose(tf.params, jf.params, rtol=1e-6)
    np.testing.assert_allclose(tf.predict(10), jf.predict(10), rtol=1e-6)
    assert tf.evaluate(y[80:], ["rmse", "mae"]) == pytest.approx(
        jf.evaluate(y[80:], ["rmse", "mae"]), rel=1e-6)
    p = str(tmp_path / "a.npz")
    jf.save(p)
    np.testing.assert_allclose(tfc.ARIMAForecaster().load(p).predict(10),
                               jf.predict(10), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tfc.ARIMAForecaster(seasonality_mode=True)


def test_prophet_is_gated_as_in_jax():
    try:
        import prophet  # noqa: F401
        pytest.skip("prophet is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="prophet"):
        tfc.ProphetForecaster()


# --------------------------------------------------------------- detectors

def _spiky(n=160, seed=0):
    rs = np.random.RandomState(seed)
    y = np.sin(np.arange(n) * 2 * np.pi / 20) + 0.05 * rs.randn(n)
    spikes = [37, 91, 130]
    y[spikes] += 3.0
    return y.astype(np.float32), spikes


def test_threshold_and_dbscan_detectors_match_jax():
    y, spikes = _spiky()
    pred = np.sin(np.arange(len(y)) * 2 * np.pi / 20)
    for yp in (pred, None):
        a = janom.ThresholdDetector().set_params(ratio=0.02).fit(y, yp)
        b = tanom.ThresholdDetector().set_params(ratio=0.02).fit(y, yp)
        assert b.th == a.th
        np.testing.assert_array_equal(b.score(), a.score())
        np.testing.assert_array_equal(b.anomaly_indexes(),
                                      a.anomaly_indexes())
    b = tanom.ThresholdDetector().set_params(threshold=1.0).fit(y, pred)
    assert set(spikes) <= set(b.anomaly_indexes().tolist())
    np.testing.assert_array_equal(b.score(y[:10], pred[:10]),
                                  np.abs(y[:10] - pred[:10]))
    pts = np.stack([y[:-1], y[1:]], axis=1)
    a = janom.DBScanDetector(eps=0.3, min_samples=4).fit(pts)
    b = tanom.DBScanDetector(eps=0.3, min_samples=4).fit(pts)
    np.testing.assert_array_equal(b.anomaly_indexes(), a.anomaly_indexes())
    with pytest.raises(RuntimeError, match="fit"):
        tanom.DBScanDetector().score()


def test_ae_detector_matches_jax(_jax_initial_weights):
    y, spikes = _spiky()
    kw = dict(roll_len=8, ratio=0.05, batch_size=32, epochs=3, lr=0.01)
    a = janom.AEDetector(**kw).fit(y)
    b = tanom.AEDetector(device="cpu", **kw).fit(y)
    np.testing.assert_array_equal(b._roll(y), a._roll(y))
    np.testing.assert_allclose(b.score(), a.score(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(b.anomaly_indexes(), a.anomaly_indexes())
    assert spikes[0] in b.anomaly_indexes()


# ------------------------------------------------------------------ purity

def test_forecaster_package_imports_without_optional_packages():
    """The forecasters, detectors, AutoTS and automl import with pandas,
    scikit-learn, prophet and ray blocked, and forecast from numpy."""
    code = (
        "import sys\n"
        "for m in ('pandas', 'sklearn', 'prophet', 'ray'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import zoo_tpu_torch.chronos.forecaster as F\n"
        "import zoo_tpu_torch.chronos.detector, zoo_tpu_torch.chronos.data\n"
        "import zoo_tpu_torch.chronos.autots\n"
        "import zoo_tpu_torch.automl.search, zoo_tpu_torch.automl.tpe\n"
        "import zoo_tpu_torch.automl.common.metrics\n"
        "from zoo_tpu_torch.chronos.data import TSDataset\n"
        "v = np.sin(np.arange(40.0)).astype('f4')\n"
        "ts = TSDataset.from_numpy({'v': v}, None, 'v').roll(6, 1)\n"
        "f = F.LSTMForecaster(6, 1, 1, hidden_dim=3, device='cpu')\n"
        "f.fit(ts, epochs=1, batch_size=8)\n"
        "print(f.predict(ts).shape)\n"
        "assert 'jax' not in sys.modules and 'zoo_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "(34, 1, 1)" in r.stdout
