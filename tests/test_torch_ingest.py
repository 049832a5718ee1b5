"""The port's staged ingest (``zoo_tpu_torch/orca/data/ingest.py``)
against the JAX package's: ``staged_pipeline``'s order, stats, error
propagation and thread release; ``ReadaheadController``'s decision trail
on the same scripted stats; ``StagingBufferPool``'s rotation,
starvation and generation fence; the CPU aliasing case (the put stage
copies, so recycling and overwriting a buffer never changes a batch
already yielded); and the staged ``fit`` against ``ZOO_FEED_STAGING=off``
and against the JAX ``fit``.

Tolerances: the pipeline, controller and pool checks are exact; the
staged ``fit`` is bit-equal to the unstaged one (losses, params and
optimizer state: the same CPU arithmetic on the same bytes); against the
JAX ``fit`` the f32 per-epoch losses hold to rtol 1e-5 and the params to
1e-5 absolute (an MLP's few products, summed in another order).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import zoo_tpu.orca.data.ingest as jing
from zoo_tpu.common import context as jax_context
from zoo_tpu.pipeline.api.keras.engine.topology import Sequential as JSeq
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense

import zoo_tpu_torch.orca.data.ingest as ting
from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.orca.data import (
    ExchangeConfig,
    SharedValue,
    async_device_ingest,
    fetch_many,
    iter_fetch,
    rebalance_shards,
)
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.layers import Dense

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("depth", [1, 2])
def test_staged_pipeline_order_and_stats(depth):
    stages = [("double", lambda x: 2 * x), ("inc", lambda x: x + 1)]
    got = {}
    for name, mod in (("port", ting), ("jax", jing)):
        stats = mod.PipelineStats()
        with mod.staged_pipeline(iter(range(20)), stages, depth=depth,
                                 stats=stats) as pipe:
            got[name] = (list(pipe), dict(stats.items))
        assert stats.overlap_ratio() == stats.overlap_ratio()  # not NaN
    assert got["port"] == got["jax"]
    assert got["port"][0] == [2 * i + 1 for i in range(20)]
    assert got["port"][1] == {"source": 20, "double": 20, "inc": 20}


def test_staged_pipeline_propagates_stage_error():
    def boom(x):
        if x == 3:
            raise ValueError("stage blew up")
        return x

    for mod in (ting, jing):
        with mod.staged_pipeline(iter(range(10)), [("boom", boom)]) as pipe:
            with pytest.raises(ValueError, match="stage blew up"):
                list(pipe)


def test_staged_pipeline_close_joins_its_threads():
    """``close()`` stops and joins every stage thread (the JAX close
    only signals): once it returns True no thread is left."""
    release = threading.Event()

    def slow(x):
        release.wait(5)
        return x

    before = set(threading.enumerate())
    pipe = ting.staged_pipeline(iter(range(100)), [("a", slow), ("b", None)])
    pipe.join_timeout = 60.0   # a loaded host: the bound is not the point
    it = iter(pipe)
    threading.Timer(0.2, release.set).start()
    assert pipe.close()
    with pytest.raises(StopIteration):
        next(it)
    left = [t for t in set(threading.enumerate()) - before
            if t.is_alive() and not isinstance(t, threading.Timer)]
    assert not left


def test_async_device_ingest_copies_to_the_device_narrowed():
    items = [{"x": np.arange(4, dtype=np.float64) + i,
              "y": np.arange(2, dtype=np.int64)} for i in range(5)]
    with async_device_ingest(iter(items), device="cpu") as pipe:
        got = list(pipe)
    assert [g["x"].dtype for g in got] == [torch.float32] * 5
    assert [g["y"].dtype for g in got] == [torch.int32] * 5
    assert all(np.array_equal(g["x"].numpy(), it["x"])
               for g, it in zip(got, items))


def test_the_exchange_raises_naming_its_item():
    assert SharedValue(3).value == 3
    for fn in (rebalance_shards, fetch_many, iter_fetch, ExchangeConfig):
        with pytest.raises(NotImplementedError, match="A.15 item 9"):
            fn()


# ---------------------------------------------------------- controller

class _Config:
    def __init__(self, multiget, concurrency):
        self.multiget, self.concurrency = multiget, concurrency


class _ScriptedStats:
    def __init__(self):
        self.busy = {"source": 0.0}
        self._w = 0.0

    def wall(self):
        return self._w


def _walk(mod):
    cfg, st = _Config(8, 2), _ScriptedStats()
    c = mod.ReadaheadController(cfg, st, window=1, max_concurrency=8,
                                max_chunk=32)
    trail = []
    script = [(float(i), 0.9 * i) for i in range(1, 3)] + [(3.0, 2.7)] + \
        [(float(i), 2.7) for i in range(4, 24)] + \
        [(24.0 + i, 2.7 + 0.8 * (i + 1)) for i in range(4)]
    for wall, src in script:
        st._w, st.busy["source"] = wall, src
        c.on_chunk(8, 1 << 20, 0.1)
        trail.append((cfg.concurrency, cfg.multiget))
    return c.decisions, trail, c


def test_readahead_controller_decision_trail_matches_jax():
    port, trail, c = _walk(ting)
    jaxs, jtrail, _ = _walk(jing)
    assert port == jaxs and trail == jtrail
    # grows concurrency to its cap, then the chunk; unwinds to both floors
    assert (8, 8) in port and (8, 16) in port
    assert (1, c.min_chunk) in port


# ---------------------------------------------------------------- pool

def _pool_arrs():
    rs = np.random.RandomState(0)
    return [rs.randn(40, 3).astype(np.float32),
            rs.randint(0, 9, 40).astype(np.int64)]


def test_staging_buffer_pool_rotates_and_preserves_contents():
    arrs = _pool_arrs()
    got = {}
    for name, mod in (("port", ting), ("jax", jing)):
        pool = mod.StagingBufferPool(arrs, rows=8, nbufs=3)
        a = pool.take(arrs, np.arange(8))
        b = pool.take(arrs, np.arange(8, 16))
        assert a[0].base is not b[0].base   # distinct buffers
        pool.recycle()
        c = pool.take(arrs, np.arange(16, 20))  # ragged tail: a prefix
        assert c[0].shape == (4, 3)
        got[name] = [np.array(v) for v in a + b + c]
        pool.reset()
    # the port narrows int64 to int32 in the buffer, as device_put does
    assert [g.dtype for g in got["port"]] == [np.float32, np.int32] * 3
    for p, j in zip(got["port"], got["jax"]):
        assert np.array_equal(p, j)


def test_staging_buffer_pool_starvation_is_loud():
    arrs = [np.zeros((4, 2), np.float32)]
    for mod in (ting, jing):
        pool = mod.StagingBufferPool(arrs, rows=2, nbufs=1)
        pool.take(arrs, np.arange(2))
        with pytest.raises(RuntimeError, match="starved"):
            pool.take(arrs, np.arange(2), timeout=0.05)


def test_staging_buffer_pool_fences_stale_generation():
    arrs = [np.arange(20, dtype=np.float32).reshape(10, 2)]
    pool = ting.StagingBufferPool(arrs, rows=4, nbufs=2)
    gen1 = pool.reset()
    pool.take(arrs, np.arange(4), gen=gen1)           # epoch 1 in flight
    gen2 = pool.reset()                               # epoch 2 begins
    new = pool.take(arrs, np.arange(4, 8), gen=gen2)
    pool.recycle(gen=gen1)   # a zombie put thread: must not free gen 2's
    stale = pool.take(arrs, np.arange(4), gen=gen1)   # plain copies
    assert stale[0].base is not new[0].base
    assert np.array_equal(stale[0], arrs[0][:4])
    pool.recycle(gen=gen2)
    pool.take(arrs, np.arange(4), gen=gen2, timeout=0.5)
    pool.take(arrs, np.arange(4), gen=gen2, timeout=0.5)
    with pytest.raises(RuntimeError, match="starved"):
        pool.take(arrs, np.arange(4), gen=gen2, timeout=0.05)


def test_take_rounds_as_astype_does():
    """``np.take(..., out=)`` into the narrowed buffer rounds each
    float64 exactly as ``astype(float32)`` does (and narrows int64 as
    ``astype(int32)``)."""
    rs = np.random.RandomState(1)
    arrs = [rs.randn(64, 5) * 1e3, rs.randint(-2 ** 31, 2 ** 31, 64)]
    pool = ting.StagingBufferPool(arrs, rows=64, nbufs=1)
    idx = rs.permutation(64)
    got = pool.take(arrs, idx)
    for g, a in zip(got, arrs):
        want = a[idx].astype(ting.narrowed_dtype(a.dtype))
        assert g.dtype == want.dtype and g.tobytes() == want.tobytes()


@pytest.mark.parametrize("staging", ["auto", "off"])
def test_cpu_pool_outcome_matches_jax_and_never_aliases(monkeypatch,
                                                         staging):
    """On the CPU ``tensor.to("cpu")`` would alias a buffer; the port's
    put stage copies instead. Pool or no pool is the JAX package's
    outcome on the same inputs; a batch already yielded is unchanged
    after its buffer is recycled and overwritten."""
    monkeypatch.setenv("ZOO_FEED_STAGING", staging)
    arrs = _pool_arrs()
    port = ting.StagingBufferPool.maybe_create(arrs, rows=8, device="cpu")
    jpool = jing.StagingBufferPool.maybe_create(arrs, rows=8)
    assert (port is None) == (jpool is None) == (staging == "off")
    if port is None:
        return
    assert not port.pinned
    sliced = port.take(arrs, np.arange(8))
    staged = port.to_device(sliced, "cpu")
    want = [t.clone() for t in staged]
    for s, t in zip(sliced, staged):
        assert t.data_ptr() != torch.from_numpy(s).data_ptr()
    # the buffer is back in the pool: the next takes reuse it
    for _ in range(4):
        port.take(arrs, np.arange(8, 16))
    for buf in port._slots:
        for b in buf:
            b[...] = 0
    assert all(torch.equal(a, b) for a, b in zip(staged, want))


# ------------------------------------------------------------------ fit

def _mlp(J, lr=0.05):
    m = (JSeq if J else Sequential)()
    D = JDense if J else Dense
    m.add(D(16, input_shape=(8,), activation="relu"))
    m.add(D(1))
    m.compile(optimizer="sgd", loss="mse")
    return m


def _data(dtype=np.float32):
    rs = np.random.RandomState(0)
    x = rs.randn(256, 8)
    return x.astype(dtype), (x @ rs.randn(8, 1)).astype(dtype)


def _state(m):
    return [np.array(t.detach()) for t in tree_leaves(m.params)] + \
        [np.array(t) for t in tree_leaves(m._opt_state)
         if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_staged_fit_is_bit_equal_to_unstaged_and_matches_jax(monkeypatch,
                                                             dtype):
    takes = []
    take = ting.StagingBufferPool.take

    def spy(self, arrs, idx, **kw):
        takes.append(len(idx))
        return take(self, arrs, idx, **kw)

    monkeypatch.setattr(ting.StagingBufferPool, "take", spy)
    x, y = _data(dtype)
    jm = _mlp(True)
    tree = jax.tree_util.tree_map(np.asarray, jm.build())
    ref = jm.fit(x, y, batch_size=32, nb_epoch=2, shuffle=True, seed=11,
                 verbose=0)
    runs = {}
    for staging in ("auto", "off"):
        monkeypatch.setenv("ZOO_FEED_STAGING", staging)
        n0 = len(takes)
        m = _mlp(False)
        m.params = keras_params_from_jax(tree, "cpu")
        h = m.fit(x, y, batch_size=32, nb_epoch=2, shuffle=True, seed=11,
                  verbose=0, device="cpu")
        runs[staging] = (h["loss"], _state(m), len(takes) - n0,
                         m._staging_pool)
    assert runs["auto"][2] > 0 and runs["auto"][3] is not None
    assert runs["off"][2] == 0 and runs["off"][3] is None
    assert runs["auto"][0] == runs["off"][0]
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(runs["auto"][1], runs["off"][1]))
    np.testing.assert_allclose(runs["auto"][0], ref["loss"], rtol=1e-5)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(jm.params)]
    have = [np.array(t.detach()) for t in tree_leaves(m.params)]
    assert len(want) == len(have)
    for a, b in zip(sorted(want, key=np.shape), sorted(have, key=np.shape)):
        np.testing.assert_allclose(b, a, atol=1e-5)


def test_staged_fit_runs_the_guard_seam_on_the_pool(monkeypatch):
    """The poison-batch seam still corrupts the host superbatch in place
    (now a staging buffer) and the guard skips the poisoned steps."""
    from zoo_tpu_torch.orca.learn.guard import GuardConfig, TrainingGuard
    from zoo_tpu_torch.util.resilience import inject

    x, y = _data()
    m = _mlp(False)
    m.build(torch.Generator().manual_seed(0), [(None, 8)], device="cpu")
    m.set_guard(TrainingGuard(GuardConfig(max_skips=100)))
    seen = []

    def poison(site, arrays=None, idx=None, **kw):
        seen.append(type(arrays[0]).__name__)
        arrays[0][...] = np.nan

    with inject("fit.batch", action=poison, exc=None, times=1):
        h = m.fit(x, y, batch_size=32, nb_epoch=1, verbose=0, device="cpu")
    assert seen == ["ndarray"] and m._staging_pool is not None
    assert np.isfinite(h["loss"]).all()
    assert all(np.isfinite(np.array(t.detach())).all()
               for t in tree_leaves(m.params))
