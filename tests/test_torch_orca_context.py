"""The port's runtime context (``zoo_tpu_torch.orca.init_orca_context``,
``common/context.py``, ``parallel/mesh.py``'s layout half,
``common/nncontext.py``, ``common/envcheck.py``, ``ray``) against the
JAX package's on one CPU device, and the port's readers of the context.

Every test stops both packages' contexts when it starts and when it
ends: a JAX context left set changes how JAX tests later on the same
worker shard their batches, and a port context left set changes the
default device of later port tests."""

import dataclasses
import logging
import threading

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.common import context as jctx
from zoo_tpu.orca import OrcaContext as JOrcaContext
from zoo_tpu.orca import init_orca_context as jinit
from zoo_tpu.orca import stop_orca_context as jstop
from zoo_tpu.parallel import mesh as jmesh

from zoo_tpu_torch.common import context as tctx
from zoo_tpu_torch.orca import OrcaContext as TOrcaContext
from zoo_tpu_torch.orca import init_orca_context as tinit
from zoo_tpu_torch.orca import stop_orca_context as tstop
from zoo_tpu_torch.parallel import mesh as tmesh

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _stop_both_contexts():
    # a context another file left set on this worker would make every
    # init here a second call with other arguments
    jstop()
    tstop()
    yield
    jstop()
    tstop()


def _jax_one():
    return jax.devices("cpu")[:1]


def test_init_reinit_and_stop_match_jax():
    j = jinit(cluster_mode="local", cores=2, devices=_jax_one())
    t = tinit(cluster_mode="local", cores=2, devices=["cpu"])
    assert (t.platform, t.num_devices, t.cores, t.cluster_mode) == \
        (j.platform, j.num_devices, j.cores, j.cluster_mode) == \
        ("cpu", 1, 2, "local")
    assert dict(t.mesh.shape) == dict(j.mesh.shape)
    assert t.mesh.axis_names == tuple(j.mesh.axis_names)
    assert t.mesh.size == j.mesh.size == 1
    assert t.devices == (torch.device("cpu"),)
    assert t.axis_size("data") == j.axis_size("data") == 1
    assert (t.num_processes, t.process_index) == \
        (j.num_processes, j.process_index)
    assert tctx.get_runtime_context() is t
    # the same arguments, or a default call, return the context
    assert tinit(cluster_mode="local", cores=2, devices=["cpu"]) is t
    assert tinit() is t and jinit() is j
    # other arguments raise in both
    for init, devs in ((jinit, _jax_one()), (tinit, ["cpu"])):
        with pytest.raises(RuntimeError, match="twice"):
            init(mesh_axes={"data": -1}, devices=devs)
    tstop()
    assert tctx.get_runtime_context(required=False) is None
    with pytest.raises(RuntimeError, match="init_orca_context"):
        tctx.get_runtime_context()


@pytest.mark.parametrize("kwargs", [
    dict(cluster_mode="not-a-mode"),
    dict(cluster_mode="local", num_nodes=2),
    dict(mesh_axes={"data": 2}),
    dict(mesh_axes={"bogus": 1}),
    dict(mesh_axes={"data": -1, "model": -1}),
], ids=["mode", "local-nodes", "data-2", "unknown-axis", "two-wildcards"])
def test_argument_checks_match_jax(kwargs):
    with pytest.raises(ValueError):
        jinit(devices=_jax_one(), **kwargs)
    with pytest.raises(ValueError) as e:
        tinit(devices=["cpu"], **kwargs)
    if kwargs.get("mesh_axes") == {"data": 2}:
        assert "ROADMAP A.14" in str(e.value)
    assert tctx.get_runtime_context(required=False) is None


def test_a_world_above_one_names_a14(monkeypatch):
    with pytest.raises(RuntimeError, match="A.14"):
        tinit(cluster_mode="k8s", num_nodes=2, devices=["cpu"])
    monkeypatch.setenv("ZOO_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="A.14"):
        tinit(cluster_mode="spark-submit", devices=["cpu"])
    with pytest.raises(ValueError, match="A.14"):
        tinit(devices=["cpu", "cpu"])
    monkeypatch.setenv("ZOO_NUM_PROCESSES", "1")
    assert tinit(cluster_mode="yarn", devices=["cpu"]).platform == "cpu"


@pytest.mark.parametrize("value,falls_back", [("2", True), ("-1", False),
                                              ("1", False)])
def test_env_axes_fallback_matches_jax(monkeypatch, caplog, value,
                                       falls_back):
    monkeypatch.setenv("ZOO_MESH_DATA", value)
    assert tmesh.mesh_axes_from_env() == jmesh.mesh_axes_from_env()
    with caplog.at_level(logging.WARNING):
        j = jinit(devices=_jax_one())
        t = tinit(devices=["cpu"])
    assert dict(t.mesh.shape) == dict(j.mesh.shape)
    warned = [r for r in caplog.records if "ZOO_MESH_" in r.getMessage()]
    assert len(warned) == (2 if falls_back else 0)


def test_no_card_and_no_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit()
    with pytest.raises(RuntimeError, match="CUDA"):
        tinit(devices=["cuda"])
    assert tctx.get_runtime_context(required=False) is None


def test_the_thread_local_scope_matches_jax():
    t = tinit(devices=["cpu"])
    other = dataclasses.replace(t, cores=7)
    seen = {}

    def worker():
        seen["worker"] = tctx.get_runtime_context()

    with tctx.runtime_context_scope(other):
        assert tctx.get_runtime_context() is other
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert seen["worker"] is t and tctx.get_runtime_context() is t
    # the JAX scope behaves alike
    j = jinit(devices=_jax_one())
    jother = dataclasses.replace(j, cores=7)
    with jctx.runtime_context_scope(jother):
        assert jctx.get_runtime_context() is jother
    assert jctx.get_runtime_context() is j


def test_orca_context_flags_match_jax():
    for cls in (JOrcaContext, TOrcaContext):
        cls.pandas_read_backend = "ARROW"
        assert cls.pandas_read_backend == "arrow"
        cls.pandas_read_backend = "pandas"
        with pytest.raises(ValueError):
            cls.pandas_read_backend = "dask"
        cls.shard_size = 1000
        assert cls.shard_size == 1000
        with pytest.raises(ValueError):
            cls.shard_size = 0
        cls.shard_size = None
        cls.train_data_store = "disk_2"
        assert cls.train_data_store == "DISK_2"
        with pytest.raises(ValueError):
            cls.train_data_store = "PMEM"
        cls.train_data_store = "DRAM"
        with pytest.raises(RuntimeError, match="SparkContext"):
            cls.get_spark_context()


def test_debug_nans_makes_a_nonfinite_loss_fatal():
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense

    def nan_loss(y, p):
        return torch.log(-torch.abs(p) - 1.0).mean()

    m = Sequential().add(Dense(4, input_shape=(3,)))
    m.compile(optimizer="sgd", loss=nan_loss)
    x = np.random.RandomState(0).randn(16, 3).astype(np.float32)
    y = np.zeros((16, 4), np.float32)
    assert tctx.ZooContext.debug_nans is False
    tctx.ZooContext.debug_nans = True
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises((FloatingPointError, RuntimeError)):
            m.fit(x, y, batch_size=8, nb_epoch=1, verbose=0, device="cpu")
    finally:
        tctx.ZooContext.debug_nans = False
    assert not torch.is_anomaly_enabled()
    # off, the same fit reports the NaN and carries on
    assert np.isnan(m.fit(x, y, batch_size=8, nb_epoch=1, verbose=0,
                          device="cpu")["loss"][0])


@pytest.mark.parametrize("shape,size,taken", [
    ((8, 6), 2, ()), ((8, 6), 3, ()), ((8, 6), 2, (0,)), ((5, 7), 2, ()),
    ((), 2, ())])
def test_pick_divisible_dim_matches_jax(shape, size, taken):
    assert tmesh.pick_divisible_dim(shape, size, taken) == \
        jmesh.pick_divisible_dim(shape, size, taken)


@pytest.mark.parametrize("n,axes", [
    (8, {"data": -1}), (8, {"data": 2, "model": 4}), (8, {"fsdp": -1,
                                                          "data": 2}),
    (6, {"data": 4}), (8, {"data": 0}), (1, {"seq": -1})])
def test_mesh_layout_matches_jax(n, axes):
    try:
        want = jmesh._factor_shape(n, axes, jmesh.DEFAULT_AXES)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh._factor_shape(n, axes, tmesh.DEFAULT_AXES)
        return
    assert tmesh._factor_shape(n, axes, tmesh.DEFAULT_AXES) == want
    jm = jmesh.build_mesh(jax.devices("cpu")[:n], axis_sizes=axes)
    tm = tmesh.build_mesh([torch.device("cpu")] * n, axis_sizes=axes)
    assert dict(tm.shape) == dict(jm.shape) and tm.size == jm.size
    assert tmesh.data_axes(tm) == jmesh.data_axes(jm)
    for b in (8, 12, 16):
        try:
            expect = jmesh.validate_batch_size(b, jm)
        except ValueError:
            with pytest.raises(ValueError):
                tmesh.validate_batch_size(b, tm)
            continue
        assert tmesh.validate_batch_size(b, tm) == expect


def test_shardings_are_the_identity_on_one_device_and_name_a14_beyond():
    one = tmesh.build_mesh([torch.device("cpu")])
    for fn in (lambda m: tmesh.batch_sharding(m, 2),
               lambda m: tmesh.stacked_batch_sharding(m, 3),
               tmesh.replicated_sharding,
               lambda m: tmesh.fsdp_param_sharding(m, (4, 4))):
        assert fn(one) == torch.device("cpu")
        with pytest.raises(NotImplementedError, match="A.14"):
            fn(tmesh.build_mesh([torch.device("cpu")] * 2))


def test_publish_mesh_metrics():
    from zoo_tpu_torch.obs.metrics import get_registry
    tinit(devices=["cpu"])
    text = get_registry().render_prometheus()
    assert 'zoo_mesh_axis_size{axis="data"} 1' in text


def test_envcheck_collect_matches_jax_shape(monkeypatch):
    from zoo_tpu.common import envcheck as jenv
    from zoo_tpu_torch.common import envcheck as tenv

    rows = tenv.collect()
    assert all(isinstance(n, str) and isinstance(ok, bool) and
               isinstance(d, str) for n, ok, d in rows)
    names = [n for n, _, _ in rows]
    assert {"python", "torch", "device", "nvcc", "orca context"} <= \
        set(names)
    assert all(ok for _, ok, _ in rows), rows
    assert tenv.main() == 0
    tinit(devices=["cpu"])
    ctx_row = dict((n, d) for n, _, d in tenv.collect())["orca context"]
    assert "platform=cpu" in ctx_row and "'data': 1" in ctx_row
    # a partial launcher config fails the preflight in both packages
    monkeypatch.setenv("ZOO_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.delenv("ZOO_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("ZOO_PROCESS_ID", raising=False)
    coord = [(ok, d) for n, ok, d in tenv.collect() if n == "coordinator"]
    jcoord = [(ok, d) for n, ok, d in jenv.collect() if n == "coordinator"]
    assert coord == jcoord and coord[0][0] is False
    assert tenv.main() == 1
    monkeypatch.setenv("ZOO_NUM_PROCESSES", "1")
    monkeypatch.setenv("ZOO_PROCESS_ID", "0")
    coord = [(ok, d) for n, ok, d in tenv.collect() if n == "coordinator"]
    jcoord = [(ok, d) for n, ok, d in jenv.collect() if n == "coordinator"]
    assert coord == jcoord and coord[0][0] is True


def test_init_nncontext_boots_the_context():
    from zoo_tpu.common import nncontext as jnn
    from zoo_tpu_torch.common import init_nncontext, nncontext as tnn

    j = jnn.init_nncontext()
    t = init_nncontext(devices=["cpu"])
    assert t is tctx.get_runtime_context() and t.cluster_mode == \
        j.cluster_mode == "local"
    tstop()
    jstop()
    assert tnn.init_spark_on_local(cores=3, devices=["cpu"]).cores == \
        jnn.init_spark_on_local(cores=3).cores == 3
    tstop()
    assert tnn.init_spark_on_local(cores="*", devices=["cpu"]).cores == \
        tctx.default_cores()
    tstop()
    with pytest.warns(UserWarning, match="init_spark_on_yarn"):
        with pytest.raises(RuntimeError, match="A.14"):
            tnn.init_spark_on_yarn(num_executors=2, devices=["cpu"])
    with pytest.warns(UserWarning):
        assert tnn.init_spark_on_yarn(num_executors=1, executor_cores=2,
                                      devices=["cpu"]).cores == 2


def test_ray_context_matches_jax():
    from zoo_tpu import ray as jray
    from zoo_tpu_torch import ray as tray

    for mod, orca in ((jray, JOrcaContext), (tray, TOrcaContext)):
        ctx = mod.RayContext(object_store_memory="2g")
        assert mod.RayContext.get(initialize=False) is ctx
        assert orca.get_ray_context() is ctx and not ctx.initialized
        with pytest.raises(RuntimeError, match="no ray"):
            ctx.init()
        ctx.stop()
    for mem in (123, "2g", "512M", "1.5k", "64b", "100"):
        assert tray._to_bytes(mem) == jray._to_bytes(mem)


def test_entry_points_take_the_context_device(monkeypatch, tmp_path):
    """With no card, a CPU context lets ``fit``/``predict`` and the
    estimator run without ``device=``; without the context they raise;
    ``device=`` still wins over the context."""
    from zoo_tpu_torch.orca.learn.keras import Estimator
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.RandomState(0).randn(32, 4).astype(np.float32)
    m = Sequential().add(Dense(1, input_shape=(4,)))
    m.compile("adam", "mse")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.fit(x, x[:, :1], batch_size=8, nb_epoch=1, verbose=0)
    tinit(devices=["cpu"])
    est = Estimator.from_keras(m, model_dir=str(tmp_path / "est"))
    assert len(est.fit({"x": x, "y": x[:, :1]}, epochs=1,
                       batch_size=8)["loss"]) == 1
    assert est.predict(x).shape == (32, 1)
    assert est._device() == torch.device("cpu")
    assert est._restore_mesh() is None
    est.load_orca_checkpoint(str(tmp_path / "est"))
    assert m._params_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.predict(x, device="cuda")


def test_automl_sub_contexts_match_jax():
    """Concurrent trials get no sub-context on a one-device context, in
    both packages, and none without a context; a context of more
    devices (built directly, as the port's init refuses more than one)
    raises naming A.14. Trials run under the live context."""
    from zoo_tpu.automl import search as jsearch
    from zoo_tpu_torch.automl import search as tsearch

    eng = tsearch.LocalSearchEngine(n_parallel=2, partition_devices=True)
    assert eng._sub_contexts() == []
    tinit(devices=["cpu"])
    jinit(devices=_jax_one())
    jeng = jsearch.LocalSearchEngine(n_parallel=2, partition_devices=True)
    assert eng._sub_contexts() == jeng._sub_contexts() == []
    devs = [torch.device("cpu")] * 2
    big = tctx.RuntimeContext("local", "cpu", tuple(devs),
                              tmesh.build_mesh(devs), 1, 0, 4)
    with tctx.runtime_context_scope(big):
        with pytest.raises(NotImplementedError, match="A.14"):
            eng._sub_contexts()
    seen = []
    lock = threading.Lock()

    def trial(cfg):
        with lock:
            seen.append(len(tctx.get_runtime_context().devices))
        return {"mse": float(cfg["a"])}

    from zoo_tpu_torch.automl import hp
    eng.compile(trial, {"a": hp.grid_search([0, 1, 2, 3])})
    eng.run()
    assert seen == [1] * 4


def test_llama_ring_attention_checks_the_seq_axis():
    from zoo_tpu.models.llm.llama import Llama as JLlama
    from zoo_tpu.models.llm.llama import tiny_llama_config as jcfg
    from zoo_tpu_torch.models.llm import Llama, tiny_llama_config

    ids = torch.zeros((1, 8), dtype=torch.long)
    tinit(devices=["cpu"])
    jinit(devices=_jax_one())
    m = Llama.from_seed(tiny_llama_config(), device="cpu",
                        attention_impl="ring")
    with pytest.raises(ValueError, match="seq axis"):
        m(ids)
    with pytest.raises(ValueError, match="seq axis"):
        JLlama(jcfg(), attention_impl="ring")._seq_mesh()
    seq2 = tmesh.build_mesh([torch.device("cpu")] * 2,
                            axis_sizes={"seq": 2})
    m2 = Llama.from_seed(tiny_llama_config(), device="cpu",
                         attention_impl="ring", mesh=seq2)
    with pytest.raises(NotImplementedError, match="A.14"):
        m2(ids)


def test_the_anomaly_detector_batch_under_a_context():
    from zoo_tpu_torch.chronos.detector import AEDetector

    tinit(devices=["cpu"])
    y = np.sin(np.arange(120.0) / 5).astype(np.float32)
    d = AEDetector(roll_len=8, batch_size=32, epochs=1, device="cpu")
    d.fit(y)
    assert d.score().shape == (120,)
