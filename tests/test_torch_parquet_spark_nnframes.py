"""The port's parquet datasets, Spark adapter and NNFrames against the
JAX package's: parquet part files and the ``_orca_metadata.json``
sidecar written by each package are byte-equal and read back by the
other (arrays, XShards, batches, an image folder); ``spark_dataframe_
to_shards`` over the JAX tests' pandas-backed stub gives the same shards
and ``fit`` from the stub equals ``fit`` from the arrays; ``NNClassifier``
and ``NNEstimator`` fit and transform as the JAX ones do from the same
weights; ``NNImageReader.readImages`` reads the same frame.

Tolerances: files, shards and frames are exact; ``fit`` from a Spark
DataFrame is bit-equal to ``fit`` from its arrays; against the JAX
NNFrames the f32 predictions and params hold to 1e-5 absolute (a small
MLP, its products summed in another order).
"""

import os
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.data import parquet_dataset as jpq
from zoo_tpu.orca.data import spark as jspark
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from zoo_tpu.pipeline import nnframes as jnn

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.data import parquet_dataset as tpq
from zoo_tpu_torch.orca.data import spark as tspark
from zoo_tpu_torch.pipeline import nnframes as tnn
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.layers import Dense

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_spark_ingestion import DataFrame as SparkStub  # noqa: E402

jax.config.update("jax_platforms", "cpu")
pytest.importorskip("pyarrow")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


# ------------------------------------------------------------- parquet

def _images(n=40, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 6, 5, 3).astype(np.float32),
            rs.randint(0, 10, n))


def _same_dir(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f


@pytest.mark.parametrize("block_size", [16, 1000])
def test_parquet_ndarrays_cross_between_the_packages(tmp_path, block_size):
    imgs, labels = _images()
    pj, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    jpq.write_parquet("ndarray", pj, imgs, labels, block_size=block_size)
    tpq.write_parquet("ndarray", pp, imgs, labels, block_size=block_size)
    _same_dir(pj, pp)   # part files and sidecar, byte for byte
    for src in (pj, pp):
        mine = tpq.read_parquet("arrays", src)
        theirs = jpq.read_parquet("arrays", src)
        assert mine.keys() == theirs.keys() == {"image", "label"}
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype
            assert np.array_equal(mine[k], theirs[k])
        assert np.array_equal(mine["image"], imgs)
        ms = tpq.read_parquet("xshards", src, num_shards=4).collect()
        js = jpq.read_parquet("xshards", src, num_shards=4).collect()
        assert len(ms) == len(js) == 4
        for a, b in zip(ms, js):
            assert all(np.array_equal(a[k], b[k]) for k in a)
        mb = list(tpq.read_parquet("batched", src, batch_size=16))
        jb = list(jpq.read_parquet("batched", src, batch_size=16))
        assert [len(b["label"]) for b in mb] == [16, 16, 8]
        for a, b in zip(mb, jb):
            assert all(np.array_equal(a[k], b[k]) for k in a)


def test_parquet_append_and_image_folder(tmp_path):
    import cv2

    rs = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        d = tmp_path / "imgs" / cls
        d.mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(d / f"{i}.png"),
                        (rs.rand(5, 4, 3) * 255).astype(np.uint8))
    out = {}
    for name, mod in (("jax", jpq), ("port", tpq)):
        path = str(tmp_path / name)
        mod.write_parquet("image_folder", path, str(tmp_path / "imgs"),
                          {"cat": 0, "dog": 1}, block_size=4)
        out[name] = path
    # the origin column holds the same paths, so the files are equal too
    _same_dir(out["jax"], out["port"])
    got = tpq.read_parquet("arrays", out["jax"])
    want = jpq.read_parquet("arrays", out["port"])
    assert got["image"] == want["image"] and \
        np.array_equal(got["label"], want["label"])
    imgs, labels = _images(8)
    for mod, path in ((jpq, str(tmp_path / "ja")),
                      (tpq, str(tmp_path / "pa"))):
        mod.write_parquet("ndarray", path, imgs[:4], labels[:4])
        mod.write_parquet("ndarray", path, imgs[4:], labels[4:],
                          write_mode="append")
    _same_dir(str(tmp_path / "ja"), str(tmp_path / "pa"))
    with pytest.raises(FileExistsError):
        tpq.write_parquet("ndarray", str(tmp_path / "pa"), imgs, labels,
                          write_mode="error")
    with pytest.raises(ValueError, match="unknown format"):
        tpq.read_parquet("csv", str(tmp_path / "pa"))


# --------------------------------------------------------------- spark

def _spark_frame(n=60, parts=3):
    rs = np.random.RandomState(0)
    pdf = pd.DataFrame({"f1": rs.randn(n).astype(np.float32),
                        "f2": rs.randn(n).astype(np.float32),
                        "vec": [rs.randn(3).astype(np.float32).tolist()
                                for _ in range(n)],
                        "label": (rs.rand(n) > 0.5).astype(np.float32)})
    return pdf, SparkStub(pdf, num_partitions=parts)


@pytest.mark.parametrize("features,labels", [
    (["f1", "f2"], ["label"]), (["vec"], ["label"]), (["f1"], [])])
def test_spark_dataframe_to_shards_matches_jax(tmp_path, features, labels):
    _, df = _spark_frame()
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    assert tspark.is_spark_dataframe(df) and \
        not tspark.is_spark_dataframe(pd.DataFrame({"a": [1]}))
    mine = tspark.spark_dataframe_to_shards(
        df, features, labels, staging_dir=str(tmp_path / "p"))
    theirs = jspark.spark_dataframe_to_shards(
        df, features, labels, staging_dir=str(tmp_path / "j"))
    a, b = mine.collect(), theirs.collect()
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    # a single reader reclaims the staged files
    assert os.listdir(str(tmp_path / "p")) == []


def test_spark_edge_columns_and_refusals(tmp_path):
    import decimal
    pdf = pd.DataFrame({"d": [decimal.Decimal("1.5"), None, 2],
                        "n": [1.0, np.nan, 3.0], "s": ["a", "b", "c"]})
    df = SparkStub(pdf, num_partitions=1)
    for cols in (["d", "n"],):
        mine = tspark.spark_dataframe_to_shards(df, cols, staging_dir=str(
            tmp_path)).collect()[0]
        theirs = jspark.spark_dataframe_to_shards(df, cols, staging_dir=str(
            tmp_path)).collect()[0]
        assert np.array_equal(mine["x"], theirs["x"], equal_nan=True)
    for mod in (tspark, jspark):
        with pytest.raises(TypeError, match="non-numeric"):
            mod.spark_dataframe_to_shards(df, ["s"], staging_dir=str(
                tmp_path))
        with pytest.raises(ValueError, match="not found"):
            mod.spark_dataframe_to_shards(df, ["zz"])


def test_fit_from_a_spark_dataframe_equals_fit_from_its_arrays():
    pdf, df = _spark_frame(n=64)
    runs = []
    for data in ("spark", "arrays"):
        m = Sequential()
        m.add(Dense(4, input_shape=(2,), activation="relu"))
        m.add(Dense(1))
        m.compile(optimizer="sgd", loss="mse")
        m.build(torch.Generator().manual_seed(0), [(None, 2)], device="cpu")
        if data == "spark":
            h = m.fit(df, batch_size=16, nb_epoch=2, verbose=0,
                      feature_cols=["f1", "f2"], label_cols=["label"],
                      device="cpu")
        else:
            x = np.stack([pdf["f1"].to_numpy(), pdf["f2"].to_numpy()], 1)
            h = m.fit(x, pdf["label"].to_numpy(), batch_size=16, nb_epoch=2,
                      verbose=0, device="cpu")
        runs.append((h["loss"], [np.array(t.detach())
                                 for t in tree_leaves(m.params)]))
    assert runs[0][0] == runs[1][0]
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(runs[0][1], runs[1][1]))
    with pytest.raises(ValueError, match="label_cols"):
        Sequential().add(Dense(1, input_shape=(2,))).compile(
            "sgd", "mse").fit(df, np.zeros(64), device="cpu")


# ------------------------------------------------------------ NNFrames

def _frame(n=256, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    df = pd.DataFrame({f"f{i}": x[:, i] for i in range(4)})
    df["label"] = (x[:, 0] + x[:, 1] > 0).astype(np.int32)
    df["target"] = x.sum(axis=1).astype(np.float32)
    return df


def _mlp_pair(out, activation=None):
    jm, tm = JSeq(), Sequential()
    for m, D in ((jm, JDense), (tm, Dense)):
        m.add(D(16, input_shape=(4,), activation="relu"))
        m.add(D(out, activation=activation))
    tree = jax.tree_util.tree_map(np.asarray, jm.build())
    tm.params = keras_params_from_jax(tree, "cpu")
    return jm, tm


def _close_params(jm, tm):
    want = sorted((np.asarray(a) for a in
                   jax.tree_util.tree_leaves(jm.params)), key=np.shape)
    have = sorted((np.array(t.detach()) for t in tree_leaves(tm.params)),
                  key=np.shape)
    assert len(want) == len(have)
    for a, b in zip(want, have):
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_nnclassifier_fit_and_transform_match_jax():
    df = _frame()
    cols = ["f0", "f1", "f2", "f3"]
    jm, tm = _mlp_pair(2, "softmax")
    outs = []
    for mod, m, kw in ((jnn, jm, {}), (tnn, tm, {"device": "cpu"})):
        clf = (mod.NNClassifier(m, features_col=cols, label_col="label",
                                **kw)
               .setBatchSize(32).setMaxEpoch(3).setLearningRate(0.01))
        model = clf.fit(df)
        out = model.transform(df)
        probs = model._predict(df)
        outs.append((out, probs, model))
    _close_params(jm, tm)
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-5)
    assert list(outs[1][0].columns) == list(outs[0][0].columns)
    agree = (outs[1][0]["prediction"] == outs[0][0]["prediction"]).mean()
    assert agree == 1.0
    assert (outs[1][0]["prediction"] == df["label"]).mean() > 0.6
    # the transformer maps over shards too
    from zoo_tpu_torch.orca.data import XShards
    shards = XShards.partition(df, num_shards=3)
    got = pd.concat(outs[1][2].transform(shards).collect(),
                    ignore_index=True)
    assert got["prediction"].tolist() == outs[1][0]["prediction"].tolist()


def test_nnestimator_regression_matches_jax():
    df = _frame()
    jm, tm = _mlp_pair(1)
    preds = []
    for mod, m, kw in ((jnn, jm, {}), (tnn, tm, {"device": "cpu"})):
        est = (mod.NNEstimator(m, "mse", features_col=["f0", "f1", "f2",
                                                       "f3"],
                               label_col="target", **kw)
               .setBatchSize(32).setMaxEpoch(2).setLearningRate(0.01))
        out = est.fit(df).transform(df)
        preds.append(out["prediction"].to_numpy())
    _close_params(jm, tm)
    np.testing.assert_allclose(preds[1], preds[0], atol=1e-5)


def test_nn_image_reader_reads_jaxs_frame(tmp_path, monkeypatch):
    import cv2

    rs = np.random.RandomState(0)
    for cls in ("red", "blue"):
        d = tmp_path / "imgs" / cls
        d.mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(d / f"{i}.png"),
                        (rs.rand(6, 7, 3) * 255).astype(np.uint8))
    (tmp_path / "imgs" / ".ipynb_checkpoints").mkdir()
    mine = tnn.NNImageReader.readImages(str(tmp_path / "imgs"))
    theirs = jnn.NNImageReader.readImages(str(tmp_path / "imgs"))
    assert list(mine.columns) == list(theirs.columns)
    assert mine.attrs["label_map"] == theirs.attrs["label_map"]
    assert mine["origin"].tolist() == theirs["origin"].tolist()
    assert np.array_equal(mine["label"], theirs["label"])
    for a, b in zip(mine["image"], theirs["image"]):
        assert np.array_equal(a, b)
    f = tnn.RowToImageFeature()(mine["image"][0])
    assert np.array_equal(f["image"], mine["image"][0])
    assert f["image"] is not mine["image"][0]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tnn.NNImageReader.readImages(str(tmp_path / "imgs"))
