"""The port's shard core (``zoo_tpu_torch.orca.data``: ``XShards``,
``LocalXShards``, the pandas readers) against the JAX package's, every
case of ``tests/test_xshards.py`` that needs no second process; XShards
into the Keras ``fit``/``evaluate``/``predict`` and the estimator (a fit
from numpy-dict shards is bit-equal to the fit from the same arrays);
and the README's Quick start on the CPU at a small NCF against the JAX
Quick start."""

import importlib.util
import os
import pickle

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from zoo_tpu.orca import OrcaContext as JOrcaContext
from zoo_tpu.orca import init_orca_context as jinit
from zoo_tpu.orca import stop_orca_context as jstop
from zoo_tpu.orca.data import LocalXShards as JLocal
from zoo_tpu.orca.data import XShards as JXShards
from zoo_tpu.orca.data import pandas as jpandas
from zoo_tpu.orca.learn.keras import Estimator as JaxEstimator

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.recommendation import NeuralCF
from zoo_tpu_torch.orca import OrcaContext as TOrcaContext
from zoo_tpu_torch.orca import init_orca_context as tinit
from zoo_tpu_torch.orca import stop_orca_context as tstop
from zoo_tpu_torch.orca.data import LocalXShards, XShards
from zoo_tpu_torch.orca.data import file as tfile
from zoo_tpu_torch.orca.data import pandas as tpandas
from zoo_tpu_torch.orca.data.shard import shards_for_process
from zoo_tpu_torch.orca.learn.keras import Estimator
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves, tree_map
from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _contexts():
    """Both packages' contexts on one CPU device, stopped at the end;
    the reader flags reset (a context another file left set is stopped
    first)."""
    jstop()
    tstop()
    jinit(devices=jax.devices("cpu")[:1], cores=4)
    tinit(devices=["cpu"], cores=4)
    yield
    jstop()
    tstop()
    for cls in (JOrcaContext, TOrcaContext):
        cls.pandas_read_backend = "pandas"
        cls.shard_size = None


@pytest.fixture()
def csv_dir(tmp_path):
    for i in range(3):
        df = pd.DataFrame({
            "user": np.arange(i * 10, i * 10 + 10),
            "item": np.arange(10),
            "label": np.random.RandomState(i).randint(0, 2, 10),
        })
        df.to_csv(tmp_path / f"part{i}.csv", index=False)
    return str(tmp_path)


def _same_shards(got, want):
    g, w = got.collect(), want.collect()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, pd.DataFrame):
            pd.testing.assert_frame_equal(a, b)
        elif isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [None, 1, 3, 4, 7, 200])
def test_partition_ndarray_and_dict(n):
    x = np.arange(100).reshape(50, 2)
    _same_shards(XShards.partition(x, num_shards=n),
                 JXShards.partition(x, num_shards=n))
    d = {"x": np.arange(10), "y": (np.arange(10) * 2, np.ones(10))}
    got, want = XShards.partition(d, n), JXShards.partition(d, n)
    assert got.num_partitions() == want.num_partitions()
    for a, b in zip(got.collect(), want.collect()):
        np.testing.assert_array_equal(a["x"], b["x"])
        for u, v in zip(a["y"], b["y"]):
            np.testing.assert_array_equal(u, v)
    stacked = got.stack_numpy()
    np.testing.assert_array_equal(stacked["x"], d["x"])
    df = pd.DataFrame({"a": np.arange(9), "b": np.arange(9.0)})
    _same_shards(XShards.partition(df, n), JXShards.partition(df, n))
    with pytest.raises(ValueError):
        XShards.partition("not data")


def test_transform_and_repartition():
    for mk in (lambda: np.arange(12.0),
               lambda: {"x": np.arange(12.0), "y": np.arange(12)},
               lambda: pd.DataFrame({"v": np.arange(12.0)})):
        def double(a, k):
            return {n: v * k for n, v in a.items()} \
                if isinstance(a, dict) else a * k

        t = XShards.partition(mk(), num_shards=3).transform_shard(double, 2)
        j = JXShards.partition(mk(), num_shards=3).transform_shard(double, 2)
        _same_shards(t, j)
        for n in (1, 5, 12):
            _same_shards(t.repartition(n), j.repartition(n))
    # objects that are not rows regroup whole
    objs = [["a"], ["b"], ["c"]]
    _same_shards(LocalXShards(objs).repartition(2), JLocal(objs).repartition(2))


def test_read_csv(csv_dir):
    t, j = tpandas.read_csv(csv_dir), jpandas.read_csv(csv_dir)
    _same_shards(t, j)
    assert t.num_partitions() == 3 and len(t) == 30
    stacked = t.stack_numpy(["user", "label"])
    want = j.stack_numpy(["user", "label"])
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k])
    _same_shards(tpandas.read_csv(csv_dir, num_shards=2),
                 jpandas.read_csv(csv_dir, num_shards=2))
    _same_shards(tpandas.read_csv(os.path.join(csv_dir, "part*.csv"),
                                  usecols=["user", "label"]),
                 jpandas.read_csv(os.path.join(csv_dir, "part*.csv"),
                                  usecols=["user", "label"]))
    with pytest.raises(ValueError, match="not found"):
        t.stack_numpy(["nope"])
    with pytest.raises(FileNotFoundError):
        tpandas.read_csv(os.path.join(csv_dir, "none*.csv"))


def test_read_csv_arrow_backend(csv_dir):
    for cls in (JOrcaContext, TOrcaContext):
        cls.pandas_read_backend = "arrow"
    t = tpandas.read_csv(csv_dir)
    _same_shards(t, jpandas.read_csv(csv_dir))
    assert set(t.collect()[0].columns) == {"user", "item", "label"}
    _same_shards(tpandas.read_csv(csv_dir, header=None,
                                  names=["a", "b", "c"]),
                 jpandas.read_csv(csv_dir, header=None,
                                  names=["a", "b", "c"]))


@pytest.mark.parametrize("size", [7, 10, 30, 100])
def test_shard_size_flag(csv_dir, size):
    for cls in (JOrcaContext, TOrcaContext):
        cls.shard_size = size
    t, j = tpandas.read_csv(csv_dir), jpandas.read_csv(csv_dir)
    _same_shards(t, j)
    assert t.num_partitions() == -(-30 // size) and len(t) == 30


def test_read_json_and_parquet(tmp_path):
    df = pd.DataFrame({"a": np.arange(6), "b": list("uvwxyz")})
    df.to_json(tmp_path / "d.json", orient="records")
    _same_shards(tpandas.read_json(str(tmp_path / "d.json"),
                                   orient="records"),
                 jpandas.read_json(str(tmp_path / "d.json"),
                                   orient="records"))
    pq = tmp_path / "pq"
    pq.mkdir()
    for i in range(2):
        df.iloc[i * 3:(i + 1) * 3].to_parquet(pq / f"p{i}.parquet")
    _same_shards(tpandas.read_parquet(str(pq)),
                 jpandas.read_parquet(str(pq)))


def test_readers_name_a_missing_package(csv_dir, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError, match="pandas"):
        tpandas.read_csv(csv_dir)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.csv", None)
    TOrcaContext.pandas_read_backend = "arrow"
    with pytest.raises(ImportError, match="pyarrow"):
        tpandas.read_csv(csv_dir)


def test_partition_by_and_unique():
    df = pd.DataFrame({"k": [1, 2, 1, 3, 2, 1], "v": range(6)})
    t = LocalXShards([df.iloc[:3], df.iloc[3:]]).partition_by(
        "k", num_partitions=2)
    _same_shards(t, JLocal([df.iloc[:3], df.iloc[3:]]).partition_by(
        "k", num_partitions=2))
    seen = {}
    for i, p in enumerate(t.collect()):
        for k in p["k"].unique():
            assert seen.setdefault(k, i) == i
    _same_shards(LocalXShards([df]).partition_by(["k", "v"], 3),
                 JLocal([df]).partition_by(["k", "v"], 3))
    parts = [np.array([1, 2, 2]), np.array([3, 1])]
    np.testing.assert_array_equal(LocalXShards(parts).unique(),
                                  JLocal(parts).unique())


def test_split_and_zip():
    pairs = [(np.ones(2), np.zeros(2)), (np.ones(3), np.zeros(3))]
    xs, ys = LocalXShards(pairs).split()
    jxs, jys = JLocal(pairs).split()
    _same_shards(xs, jxs)
    _same_shards(ys, jys)
    _same_shards(xs.zip(ys), jxs.zip(jys))
    assert LocalXShards([np.ones(2)]).split()[0].num_partitions() == 1
    with pytest.raises(ValueError):
        xs.zip(LocalXShards([np.ones(1)]))
    with pytest.raises(ValueError):
        xs.zip([np.ones(1)])
    assert len(LocalXShards([np.ones(4), 7, "abc"])) == \
        len(JLocal([np.ones(4), 7, "abc"])) == 8


def test_save_load_pickle_both_ways(tmp_path):
    d = {"x": np.arange(10.0), "y": np.arange(10)}
    df = pd.DataFrame({"a": np.arange(4), "b": list("wxyz")})
    for data in (np.arange(10), d, df):
        XShards.partition(data, num_shards=2).save_pickle(
            str(tmp_path / "t"))
        JXShards.partition(data, num_shards=2).save_pickle(
            str(tmp_path / "j"))
        _same_shards(LocalXShards.load_pickle(str(tmp_path / "j")),
                     JLocal.load_pickle(str(tmp_path / "t")))
        _same_shards(LocalXShards.load_pickle(str(tmp_path / "t")),
                     JXShards.partition(data, num_shards=2))
        for sub in ("t", "j"):
            tfile.rmtree(str(tmp_path / sub))


def test_load_pickle_refuses_a_file_naming_os_system(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    d = tmp_path / "evil"
    d.mkdir()
    with open(d / "part-00000.pkl", "wb") as f:
        pickle.dump(Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        LocalXShards.load_pickle(str(d))


def test_shards_for_process():
    s = XShards.partition(np.arange(10), num_shards=5)
    assert shards_for_process(s).num_partitions() == 5
    with pytest.warns(UserWarning, match="dropping 1"):
        got = shards_for_process(s, 1, 2)
    assert [p.tolist() for p in got.collect()] == [[2, 3], [6, 7]]
    with pytest.raises(ValueError, match="repartition"):
        shards_for_process(s, 0, 6)


def test_file_helpers(tmp_path):
    p = str(tmp_path / "sub" / "a.txt")
    tfile.makedirs(os.path.dirname(p))
    tfile.write_text("file://" + p, "one\ntwo\n")
    assert tfile.open_text(p) == ["one", "two"]
    assert tfile.exists(p) and not tfile.exists(p + ".no")
    (tmp_path / "sub" / ".hidden").write_text("x")
    from zoo_tpu.orca.data import file as jfile
    for pattern in (str(tmp_path / "sub"), str(tmp_path / "sub" / "*.txt"),
                    p):
        assert tfile.list_files(pattern) == jfile.list_files(pattern)
    tfile.rmtree(str(tmp_path / "sub"))
    assert not tfile.exists(str(tmp_path / "sub"))
    with pytest.raises(NotImplementedError):
        tfile.makedirs("s3://bucket/x")


def test_image_set_to_xshards():
    from zoo_tpu.feature.image import ImageSet as JImageSet
    from zoo_tpu_torch.feature.image import ImageSet

    imgs = [np.full((4, 5, 3), i, np.uint8) for i in range(7)]
    for n in (2, 3, None):
        t = ImageSet.from_arrays([i.copy() for i in imgs]).to_xshards(n)
        j = JImageSet.from_arrays([i.copy() for i in imgs]).to_xshards(n)
        assert [len(p) for p in t.collect()] == [len(p) for p in j.collect()]
        assert [[int(f["image"][0, 0, 0]) for f in p] for p in t.collect()] \
            == [[int(f["image"][0, 0, 0]) for f in p] for p in j.collect()]


# -- XShards into fit / evaluate / predict --------------------------------

def _flagship():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._flagship(small=True)


def _ncf_pair():
    jm = _flagship()
    jm.build(jax.random.PRNGKey(0), [(None, 2)])
    tm = NeuralCF(user_count=64, item_count=64, class_num=5, user_embed=8,
                  item_embed=8, hidden_layers=(16, 8), mf_embed=8)
    tm.compile(optimizer=Adam(lr=0.001),
               loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), "cpu")
    return jm, tm


def _ratings(n=320, seed=0):
    rs = np.random.RandomState(seed)
    return pd.DataFrame({"user": rs.randint(0, 64, n),
                         "item": rs.randint(0, 64, n),
                         "label": rs.randint(0, 5, n)})


def _leaves(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]


def test_readme_quick_start_matches_jax(tmp_path):
    """``init_orca_context`` -> ``read_csv`` -> ``Estimator.from_keras(
    NeuralCF)`` -> ``fit``/``evaluate``/``predict`` -> ``stop``, both
    packages on one CPU device (the JAX Quick start's f32 policy: its
    bf16 one drifts apart in both frameworks), no ``device=`` given to
    the port: the context places it."""
    df = _ratings()
    for i in range(4):
        df.iloc[i * 80:(i + 1) * 80].to_csv(tmp_path / f"r{i}.csv",
                                            index=False)
    jm, tm = _ncf_pair()
    jshards = jpandas.read_csv(str(tmp_path), num_shards=8)
    tshards = tpandas.read_csv(str(tmp_path), num_shards=8)
    cols = dict(feature_cols=["user", "item"], label_cols=["label"])
    je = JaxEstimator.from_keras(jm)
    te = Estimator.from_keras(tm)
    want = je.fit(jshards, epochs=3, batch_size=32, **cols)
    got = te.fit(tshards, epochs=3, batch_size=32, **cols)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    ev_t = te.evaluate(tshards, batch_size=64, **cols)
    ev_j = je.evaluate(jshards, batch_size=64, **cols)
    assert set(ev_t) == set(ev_j)
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=1e-4)
    np.testing.assert_allclose(
        te.predict(tshards, batch_size=64, feature_cols=["user", "item"]),
        np.asarray(je.predict(jshards, batch_size=64,
                              feature_cols=["user", "item"])), atol=1e-4)
    assert tm._params_device() == torch.device("cpu")
    for a, b in zip(tree_leaves(tm.params),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-4)


def test_numpy_dict_shards_fit_bit_equal_to_arrays():
    """The same rows as numpy-dict shards (after a ``transform_shard``)
    and as arrays: per-epoch losses, final params and Adam state, and
    ``evaluate``/``predict`` bit-equal; ragged tail included (300 rows,
    B = 32)."""
    _, start = _ncf_pair()
    df = _ratings(300)
    x = np.stack([df.user.to_numpy(), df.item.to_numpy()],
                 axis=1).astype(np.int32)
    y = df.label.to_numpy().astype(np.int32)
    shards = XShards.partition({"x": x, "y": y}, num_shards=8
                               ).transform_shard(lambda s: dict(s))
    runs = {}
    for label, data in (("arrays", {"x": x, "y": y}), ("shards", shards)):
        _, m = _ncf_pair()
        m.params = tree_map(torch.clone, start.params)
        est = Estimator.from_keras(m)
        hist = est.fit(data, epochs=2, batch_size=32)
        runs[label] = (hist["loss"], _leaves(m.params),
                       _leaves(m._opt_state), est.evaluate(data,
                                                           batch_size=64),
                       est.predict(data, batch_size=64))
    (la, pa, oa, ea, ya), (ls, ps, os_, es, ys) = runs["arrays"], \
        runs["shards"]
    assert la == ls and ea == es
    assert all(torch.equal(a, b) for a, b in zip(pa, ps))
    assert all(torch.equal(a, b) for a, b in zip(oa, os_))
    assert np.array_equal(ya, ys)


def test_dataframe_shards_need_feature_cols():
    shards = XShards.partition(_ratings(64), num_shards=2)
    _, m = _ncf_pair()
    with pytest.raises(ValueError, match="feature_cols"):
        m.fit(shards, batch_size=32, nb_epoch=1, verbose=0)
    with pytest.raises(ValueError, match="unsupported shard type"):
        m.fit(LocalXShards([np.zeros((4, 2))]), batch_size=2, nb_epoch=1)
