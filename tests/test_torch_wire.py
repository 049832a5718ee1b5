"""The port's wire path against the JAX package's: the codec, the
framing (CRC trailer included), the ``generate`` frame sequence of
``ServingServer``, the rest of the wire contract (resume, deadlines,
disconnects, duplicate ids, the small ops, the constructor's predict
settings as the JAX door takes them, and the ops that still wait),
streams across packages in both directions, and the metrics registry's
text exposition.

The LLM servers run the tiny config of ``tests/test_torch_serving.py``
(vocab 64, hidden 32, 2 blocks, 4 heads over 2 KV heads, 2 slots,
4-token blocks, 24 blocks, 6-entry tables, buckets 8/16) with the JAX
model's weights carried over by ``params_from_jax``. Every test keeps a
time limit of its own (``timeout`` marker, enforced by SIGALRM in
``tests/torch_time_limit.py``), so a hung server fails its test instead
of stalling the run.
"""

import socket
import threading
import time

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.obs import metrics as jax_metrics
from zoo_tpu.serving import codec as jax_codec
from zoo_tpu.serving import server as jax_server
from zoo_tpu.serving import tcp_client as jax_tcp
from zoo_tpu.serving.llm.engine import LLMEngine as JaxEngine
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel
from zoo_tpu.util import integrity as jax_integrity
from zoo_tpu.util import resilience as jax_resilience

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.obs import metrics as port_metrics
from zoo_tpu_torch.serving import codec as port_codec
from zoo_tpu_torch.serving import server as port_server
from zoo_tpu_torch.serving import tcp_client as port_tcp
from zoo_tpu_torch.serving.llm.engine import LLMEngine
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel
from zoo_tpu_torch.util import integrity as port_integrity
from zoo_tpu_torch.util import resilience as port_resilience

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)
SHAPE = dict(num_slots=2, block_size=4, num_blocks=24,
             max_blocks_per_seq=6, prefill_buckets=(8, 16))
SEEDED = {"temperature": 0.9, "top_k": 16, "seed": 1234}
PACKAGES = {"port": (port_server, port_tcp, port_codec),
            "jax": (jax_server, jax_tcp, jax_codec)}


# --------------------------------------------------------------- servers

@pytest.fixture(scope="module")
def weights():
    cfg = JaxConfig(**ARCH)
    base = JaxModel(cfg, seed=0, **SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, base.params)
    return base, params_from_jax(tree, "cpu")


def port_engine(weights):
    model = PagedLlamaModel(LlamaConfig(**ARCH), params=weights[1],
                            device="cpu", **SHAPE)
    return LLMEngine(model).start()


@pytest.fixture(scope="module")
def servers(weights):
    """One port server and one JAX server over the same weights."""
    port = port_server.ServingServer(
        None, llm_engine=port_engine(weights), port=0).start()
    ref = jax_server.ServingServer(
        None, llm_engine=JaxEngine(weights[0]).start(), port=0).start()
    yield {"port": port, "jax": ref}
    port.stop()
    ref.stop()


def stream(pkg, srv, msg):
    conn = PACKAGES[pkg][1]._Connection(srv.host, srv.port)
    try:
        return list(conn.stream(dict(msg)))
    finally:
        conn.close()


def rpc(pkg, srv, msg):
    conn = PACKAGES[pkg][1]._Connection(srv.host, srv.port)
    try:
        return conn.rpc(dict(msg))
    finally:
        conn.close()


def tokens_of(frames):
    return [t for f in frames for t in f.get("tokens") or ()]


def wait_free(eng, budget=10.0):
    end = time.monotonic() + budget
    while eng.allocator.used_blocks and time.monotonic() < end:
        time.sleep(0.02)
    return eng.allocator.used_blocks


# ----------------------------------------------------------------- codec

_DTYPES = ["bool", "int8", "uint8", "int32", "int64", "float16",
           "float32", "float64", "complex64"]
_arrays = st.builds(
    lambda dt, shape, seed: np.asarray(
        np.random.RandomState(seed).randn(*shape) * 50).astype(dt),
    st.sampled_from(_DTYPES),
    st.lists(st.integers(0, 3), min_size=0, max_size=3).map(tuple),
    st.integers(0, 2 ** 31 - 1))
_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 53, 2 ** 53),
    st.floats(allow_nan=False), st.text(max_size=8), _arrays,
    _arrays.map(lambda a: a.reshape(-1)[0] if a.size else np.int8(1)))
_keys = st.text(max_size=6).filter(lambda k: k not in ("__nd__",
                                                       "__tuple__"))
_trees = st.recursive(_scalars, lambda kids: st.one_of(
    st.lists(kids, max_size=4), st.lists(kids, max_size=3).map(tuple),
    st.dictionaries(_keys, kids, max_size=4)), max_leaves=12)


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


@settings(max_examples=80, deadline=None)
@given(_trees)
def test_codec_dumps_byte_equal_and_each_loads_the_other(tree):
    blob = port_codec.dumps(tree)
    assert blob == jax_codec.dumps(tree)
    got = port_codec.loads(blob)
    assert _same(got, jax_codec.loads(blob))
    # both packages decode it alike (numpy scalars as 0-d arrays), and
    # a decoded tree encodes to the same bytes
    assert port_codec.dumps(got) == blob


@pytest.mark.parametrize("bad", [
    np.array(["a"]), np.array([object()], dtype=object), {1: 2},
    {"__nd__": 1}, {"__tuple__": []}, {1, 2}, b"raw"],
    ids=["str-array", "object-array", "int-key", "nd-key", "tuple-key",
         "set", "bytes"])
def test_codec_refuses_what_jax_refuses(bad):
    for codec in (port_codec, jax_codec):
        with pytest.raises(TypeError):
            codec.dumps(bad)


@pytest.mark.parametrize("blob", [
    b"XXXX\x00\x00\x00\x00", b"ZSRV\x00\x00\x00\x10{}",
    b"ZSRV\x00\x00\x00\x0b{\"tree\":1}",
    port_codec.dumps({"a": np.zeros(3)})[:-1],
    port_codec.dumps({"a": np.zeros(3)}) + b"\x00"],
    ids=["magic", "short-header", "no-bufs", "short-body", "long-body"])
def test_codec_malformed_frames_raise_value_error_in_both(blob):
    for codec in (port_codec, jax_codec):
        with pytest.raises(ValueError):
            codec.loads(blob)


# --------------------------------------------------------------- framing

MSG = {"op": "generate", "id": "abc", "prompt": np.arange(7, dtype=np.int32),
       "nested": [1, 2.5, None, {"k": (True, "v")}], "x": np.eye(2)}


@pytest.mark.parametrize("crc", [False, True], ids=["plain", "crc"])
@pytest.mark.parametrize("sender,receiver", [("port", "jax"),
                                             ("jax", "port"),
                                             ("port", "port")])
def test_frames_arrive_equal_across_packages(sender, receiver, crc):
    a, b = socket.socketpair()
    try:
        PACKAGES[sender][0]._send_msg(a, MSG, crc=crc)
        got, had_crc = PACKAGES[receiver][0]._recv_frame(b)
        assert had_crc is crc
        assert _same(got, MSG)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("sender,receiver", [("port", "jax"),
                                             ("jax", "port")])
def test_a_flipped_bit_raises_frame_corrupt_on_the_receiver(sender,
                                                            receiver):
    res = {"port": (port_resilience, port_integrity),
           "jax": (jax_resilience, jax_integrity)}
    inject = res[sender][0].inject
    a, b = socket.socketpair()
    try:
        with inject("serving.wire.corrupt",
                    action=res[sender][1].corrupt_action):
            PACKAGES[sender][0]._send_msg(a, MSG, crc=True)
        with pytest.raises(res[receiver][1].FrameCorrupt):
            PACKAGES[receiver][0]._recv_frame(b)
    finally:
        a.close()
        b.close()


def test_crc_helpers_equal_jax():
    buf = port_codec.dumps(MSG)
    assert port_integrity.frame_crc(buf) == jax_integrity.frame_crc(buf)
    assert port_integrity.flip_bit(buf, 13) == jax_integrity.flip_bit(
        buf, 13)
    assert issubclass(port_integrity.FrameCorrupt, ConnectionError)
    assert port_resilience.FrameCorrupt is port_integrity.FrameCorrupt


# ------------------------------------------------------- generate frames

def _frame_shape(frames):
    """What must match between the packages: the keys of content and
    terminal frames, the consecutive ``seq`` numbers, every token, and
    the terminal frame's outcome, n_tokens and role (how tokens are
    chunked into frames follows each engine's tick timing)."""
    *body, last = frames
    return {"content_keys": sorted({tuple(sorted(f)) for f in body}),
            "last_keys": sorted(last),
            "seqs_consecutive": [f["seq"] for f in frames] ==
            list(range(len(frames))),
            "tokens": tokens_of(frames),
            "outcome": last["outcome"], "n_tokens": last["n_tokens"],
            "roles": sorted({f.get("role") for f in frames}, key=str)}


@pytest.mark.timeout(180)
@pytest.mark.parametrize("sampling", [{}, SEEDED], ids=["greedy",
                                                         "seeded"])
def test_generate_frame_sequence_equals_jax(servers, sampling):
    msg = {"op": "generate", "id": f"gen-{bool(sampling)}",
           "prompt": [5, 9, 1, 33, 2], "max_new_tokens": 12, **sampling}
    got = _frame_shape(stream("port", servers["port"], msg))
    ref = _frame_shape(stream("port", servers["jax"], msg))
    assert got == ref
    assert got["n_tokens"] == 12 and got["outcome"] == "ok"
    assert got["roles"] == ["mixed"] and got["seqs_consecutive"]


# ---------------------------------------------------- the wire contract

@pytest.mark.parametrize("sampling", [{}, SEEDED], ids=["greedy",
                                                         "seeded"])
def test_resume_from_skips_exactly_the_prefix(servers, sampling):
    srv = servers["port"]
    full = tokens_of(stream("port", srv, {
        "op": "generate", "id": f"full-{bool(sampling)}",
        "prompt": [3, 1, 4, 1, 5], "max_new_tokens": 10, **sampling}))
    for k in (1, 4, 9):
        frames = stream("port", srv, {
            "op": "generate", "id": f"resume-{k}-{bool(sampling)}",
            "prompt": [3, 1, 4, 1, 5], "max_new_tokens": 10,
            "resume_from": k, **sampling})
        assert tokens_of(frames) == full[k:]
        assert frames[-1]["n_tokens"] == 10


def test_deadline_zero_expires_like_jax(servers):
    msg = {"op": "generate", "id": "late", "prompt": [1, 2],
           "max_new_tokens": 4, "deadline_ms": 0}
    got = stream("port", servers["port"], msg)
    ref = stream("port", servers["jax"], msg)
    assert len(got) == 1 and got[0]["outcome"] == "expired"
    assert got[0]["expired"] is True
    assert sorted(got[0]) == sorted(ref[0])


def test_dropped_connection_frees_the_streams_blocks(weights):
    eng = port_engine(weights)
    srv = port_server.ServingServer(None, llm_engine=eng, port=0).start()
    try:
        conn = port_tcp._Connection(srv.host, srv.port)
        it = conn.stream({"op": "generate", "prompt": [3, 1],
                          "max_new_tokens": 20})
        first = next(it)
        assert first.get("tokens") or first.get("done") is False
        conn.close()   # walk away mid-stream
        assert wait_free(eng) == 0, "disconnect leaked blocks"
    finally:
        srv.stop()


def test_a_duplicate_id_joins_the_live_stream(weights):
    eng = port_engine(weights)
    srv = port_server.ServingServer(None, llm_engine=eng, port=0).start()
    try:
        msg = {"op": "generate", "id": "dup", "prompt": [7, 7, 2],
               "max_new_tokens": 16}
        out = [None, None]

        def run(i):
            out[i] = tokens_of(stream("port", srv, msg))

        ts = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert out[0] == out[1] and len(out[0]) == 16
        # one stream decoded, not two
        assert eng.stats()["generated_tokens"] == 16
    finally:
        srv.stop()
    assert eng.allocator.used_blocks == 0


def test_ping_version_stats_and_llm_stats_answer(servers):
    srv = servers["port"]
    assert rpc("port", srv, {"op": "ping"}) == {"ok": True,
                                                "role": "mixed"}
    v = rpc("port", srv, {"op": "version"})
    assert v["ok"] is True and v["version"] is None
    # the stats op reads the predict door's stage timers, as the JAX
    # door answers it on an llm-only replica
    st = rpc("port", srv, {"op": "stats"})
    ref = rpc("port", servers["jax"], {"op": "stats"})
    assert {k: sorted(v) if isinstance(v, dict) else v
            for k, v in st.items()} == \
        {k: sorted(v) if isinstance(v, dict) else v for k, v in ref.items()}
    assert st["total"]["count"] == 0
    st_port = rpc("port", srv, {"op": "llm_stats"})["stats"]
    st_jax = rpc("port", servers["jax"], {"op": "llm_stats"})["stats"]
    assert st_port["role"] == st_jax["role"] == "mixed"
    for key in ("slots", "active", "blocks_used", "blocks_free",
                "num_blocks", "generated_tokens", "decode_steps"):
        assert key in st_port and key in st_jax, key
    assert st_port["decode_attention_impl"] == "dense"   # CPU: plain


# (the reload and stats cases became cases of the frame-parity test in
# tests/test_torch_predict.py: both ops are served now; debug_dump and
# chaos are served too, and their frames are held to the JAX door's here)
@pytest.mark.parametrize("msg", [
    {"op": "kv_migrate", "phase": "commit", "id": "m"},
    {"op": "debug_dump"},
    {"op": "chaos", "site": "s", "delay_ms": 5},
    {"op": "generate", "id": "h", "prompt": [1, 2], "max_new_tokens": 2,
     "handoff": ["127.0.0.1", 1]},
], ids=["kv_migrate", "debug_dump", "chaos", "handoff"])
def test_refused_ops_name_their_roadmap_item(servers, msg, monkeypatch):
    """Every op is answered as the JAX door answers it: a commit with no
    begin on the connection is refused, a handoff whose push finds no
    peer ends ``handoff`` with ``migrated`` false, ``chaos`` is refused
    without ``ZOO_CHAOS_ALLOW`` (same frame), and ``debug_dump`` returns
    a bundle with the JAX bundle's keys (its body is this process's)."""
    monkeypatch.delenv("ZOO_CHAOS_ALLOW", raising=False)

    def ask(pkg):
        conn = port_tcp._Connection(servers[pkg].host, servers[pkg].port)
        try:
            return list(conn.stream(dict(msg))) \
                if msg["op"] == "generate" else conn.rpc(dict(msg))
        finally:
            conn.close()

    resp = ask("port")
    ref = ask("jax")
    if msg["op"] == "debug_dump":
        assert resp["ok"] is True and sorted(resp) == sorted(ref)
        assert sorted(resp["bundle"]) == sorted(ref["bundle"])
        assert resp["bundle"]["reason"] == "debug_dump"
        return
    assert resp == ref
    if msg["op"] == "chaos":
        assert "ZOO_CHAOS_ALLOW" in resp["error"] and not resp.get("ok")
    elif msg["op"] == "generate":
        assert resp[-1]["outcome"] == "handoff"
        assert resp[-1]["migrated"] is False
    else:
        assert resp["adopted"] is False and not resp["ok"]
        assert "commit without a begin" in resp["error"]


def test_predict_answers_with_the_jax_routing_error(servers):
    msg = {"op": "predict", "uri": "u", "data": np.zeros((1, 2))}
    got = rpc("port", servers["port"], msg)
    ref = rpc("port", servers["jax"], msg)
    assert got["error"] == ref["error"]


def test_constructor_refuses_what_waits(weights, monkeypatch):
    """A predict model and a reload loader are taken as the JAX door
    takes them, and so is a tenant config."""
    from zoo_tpu_torch.serving.ha import SyntheticModel

    loader = lambda s: (SyntheticModel(), "v2")  # noqa: E731
    for mod in (port_server, jax_server):
        srv = mod.ServingServer(SyntheticModel(), port=0,
                                model_loader=loader, version="v1")
        assert srv.reload_model("any", warm=False)["version"] == "v2"
        srv._server.server_close()
    from zoo_tpu.serving import tenancy as jax_tenancy
    from zoo_tpu_torch.serving import tenancy as port_tenancy
    monkeypatch.setenv("ZOO_TENANT_CONFIG", "gold:weight=2")
    for tenancy, mod in ((port_tenancy, port_server),
                         (jax_tenancy, jax_server)):
        tenancy.reset_registry(None)
        try:
            srv = mod.ServingServer(None, llm_engine=object(), port=0)
            assert srv.tenancy.enabled
            assert srv.tenancy.config("gold").weight == 2.0
            srv._server.server_close()
        finally:
            tenancy.reset_registry(None)


def _door_settings(srv):
    return {"batch_size": srv.batch_size, "max_wait_ms": srv.max_wait_ms,
            "num_replicas": len(srv._replicas), "max_queue": srv.max_queue,
            "dedup_cache": None if srv._dedup_cache is None
            else srv._dedup_cache._cap}


@pytest.mark.parametrize("kwargs", [
    {"batch_size": 32}, {"max_wait_ms": 1.0}, {"num_replicas": 2},
    {"max_queue": 16}, {"dedup_cache": 0}],
    ids=["batch_size", "max_wait_ms", "num_replicas", "max_queue",
         "dedup_cache"])
def test_predict_door_settings_are_refused_not_ignored(kwargs):
    # each predict-door setting takes effect as in the JAX door
    from zoo_tpu_torch.serving.ha import SyntheticModel
    got = port_server.ServingServer(SyntheticModel(), port=0, **kwargs)
    ref = jax_server.ServingServer(SyntheticModel(), port=0, **kwargs)
    assert _door_settings(got) == _door_settings(ref)
    (key, value), = kwargs.items()
    assert _door_settings(got)[key] == (None if key == "dedup_cache"
                                        else value)
    for srv in (got, ref):
        srv._server.server_close()


def test_positional_jax_arguments_past_port_are_refused():
    # the JAX signature is kept: its fourth positional is batch_size
    from zoo_tpu_torch.serving.ha import SyntheticModel
    got = port_server.ServingServer(SyntheticModel(), "127.0.0.1", 0, 8,
                                    2.5, 3)
    ref = jax_server.ServingServer(SyntheticModel(), "127.0.0.1", 0, 8,
                                   2.5, 3)
    assert _door_settings(got) == _door_settings(ref)
    assert (got.batch_size, got.max_wait_ms) == (8, 2.5)
    for srv in (got, ref):
        srv._server.server_close()


def test_dedup_cache_evicts_like_jax():
    caches = [port_server._DedupCache(2), jax_server._DedupCache(2)]
    for c in caches:
        c.put("a", 1)
        c.put("b", 2)
        c.get("a")
        c.put("c", 3)
    assert [[c.get(k) for k in "abc"] for c in caches] == \
        [[1, None, 3]] * 2


# ------------------------------------------------- cross-package streams

@pytest.mark.timeout(180)
@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")])
def test_streams_cross_packages(servers, client, server):
    msg = {"op": "generate", "id": f"x-{client}", "prompt": [8, 6, 4],
           "max_new_tokens": 9, **SEEDED}
    got = stream(client, servers[server], msg)
    same = stream(server, servers[server], dict(msg, id=f"y-{client}"))
    assert tokens_of(got) == tokens_of(same)
    assert got[-1]["outcome"] == "ok" and got[-1]["n_tokens"] == 9


# --------------------------------------------------------------- metrics

def _drive_registry(m):
    reg = m.MetricsRegistry()
    c = reg.counter("zoo_x_total", "things\nwith a newline",
                    labels=("kind",))
    g = reg.gauge("zoo_depth", "depth")
    h = reg.histogram("zoo_lat_seconds", "lat", labels=("stage",),
                      buckets=(0.01, 0.1, 1.0))
    d = reg.histogram("zoo_default_seconds", "default buckets")
    c.labels(kind='a"b').inc()
    c.labels(kind="plain").inc(2.5)
    g.set(3)
    g.dec(0.25)
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.labels(stage="total").observe(v)
    d.observe(1e-3)
    t = m.StatTimer(histogram=h.labels(stage="batch"))
    t.record(0.02)
    reg.disable()
    c.labels(kind="plain").inc()   # frozen
    return reg.render_prometheus(), reg.snapshot(), t.stats()


def test_metrics_text_exposition_equals_jax():
    assert _drive_registry(port_metrics) == _drive_registry(jax_metrics)
    with pytest.raises(ValueError):
        port_metrics.MetricsRegistry().counter("bad name")


def test_frames_carry_the_ambient_trace_like_jax():
    """``_stamp_trace``: inside a trace context a frame carries the
    request's trace and the open span as its parent; an explicit trace
    wins; outside any context nothing is stamped."""
    from zoo_tpu.obs import tracing as jax_tracing
    from zoo_tpu_torch.obs import tracing as port_tracing

    out = {}
    for name, tcp, tr in (("port", port_tcp, port_tracing),
                          ("jax", jax_tcp, jax_tracing)):
        got = [tcp._stamp_trace({"op": "ping"})]
        with tr.trace_context("ab" * 16, parent_span="pp"):
            got.append(tcp._stamp_trace({"op": "ping"}))
            got.append(tcp._stamp_trace({"op": "ping", "trace": "mine"}))
        got.append(tcp._stamp_trace({"op": "ping"}))
        out[name] = got
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"op": "ping", "trace": "ab" * 16,
                              "pspan": "pp"}
