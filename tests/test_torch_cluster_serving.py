"""The port's Cluster Serving against the JAX package's.

* The six tests of ``tests/test_cluster_serving.py``, on a port stack
  (``EmbeddedRedis`` + ``ClusterServing`` + ``FrontEnd`` over a port
  ``InferenceModel`` on the CPU): enqueue/query, sync predict and
  batching, dequeue, the HTTP front end, the NaN contract, the string
  and sparse schema. Replies equal the model's direct ``predict``
  within the JAX tests' tolerances (1e-5 through the queue, 1e-4 over
  HTTP's JSON).
* The mixed fleet: a JAX ``InputQueue``/``OutputQueue`` against a port
  ``EmbeddedRedis`` + ``ClusterServing``, and a port client against a
  JAX ``EmbeddedRedis`` + ``ClusterServing``, both serving one MLP's
  weights (built in JAX, carried over by ``keras_params_from_jax``):
  every reply within 1e-6 of the other package's direct ``predict``
  (f32; XLA and PyTorch sum the products in another order).
* The fallback is counted: a ragged batch retries its records alone,
  answers ``"NaN"`` for the one that fails again, and ``metrics()`` (over
  ``GET /metrics`` too) shows the fallback batch, the retried records
  and the NaN reply; a record that does not decode costs only itself.
* The front end's headers: ``X-Zoo-Trace`` and ``X-Zoo-Tenant`` echoed
  on every reply (and a ``http.predict`` span under the trace, parented
  to ``X-Zoo-Parent-Span``), a tenant past its bucket gets 429 with its
  refill hint, an expired ``X-Zoo-Deadline-Ms`` 504, a malformed one
  400; each reply's status, body and echoed headers equal the JAX door's.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from zoo_tpu.common import context as jax_context
from zoo_tpu.pipeline.api.keras.engine.topology import (
    Sequential as JSequential,
)
from zoo_tpu.pipeline.api.keras.layers import Dense as JDense
from zoo_tpu.pipeline.inference import InferenceModel as JInferenceModel
from zoo_tpu.serving import client as jax_client
from zoo_tpu.serving import cluster_serving as jax_cs
from zoo_tpu.serving import redis_embedded as jax_redis
from zoo_tpu.serving import tenancy as jax_tenancy

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.obs import tracing
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.layers import Dense
from zoo_tpu_torch.pipeline.inference import InferenceModel
from zoo_tpu_torch.serving import (
    ClusterServing,
    EmbeddedRedis,
    FrontEnd,
    InputQueue,
    OutputQueue,
)
from zoo_tpu_torch.serving import client as port_client
from zoo_tpu_torch.serving import tenancy as port_tenancy

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _port_mlp():
    m = Sequential()
    m.add(Dense(4, input_shape=(6,), activation="relu"))
    m.add(Dense(2))
    m.compile(optimizer="adam", loss="mse")
    m.build(device="cpu")
    return InferenceModel().load_keras(m, device="cpu")


@pytest.fixture()
def serving_stack():
    r = EmbeddedRedis().start()
    im = _port_mlp()
    cs = ClusterServing(im, redis_port=r.port).start()
    yield r, im, cs
    cs.stop()
    r.stop()


def _wait_query(oq, uri, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = oq.query(uri)
        if not (isinstance(out, str) and out == "[]"):
            return out
        time.sleep(0.02)
    raise TimeoutError(uri)


def _post(url, body, headers=None, timeout=15):
    """(status, decoded JSON body, response headers) of a POST."""
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


# ------------------------------------------ the JAX tests, on the port


def test_enqueue_query_roundtrip(serving_stack):
    r, im, cs = serving_stack
    iq = InputQueue(port=r.port)
    oq = OutputQueue(port=r.port)
    x = np.random.RandomState(0).randn(6).astype(np.float32)
    iq.enqueue("req-1", t=x)
    out = _wait_query(oq, "req-1")
    ref = im.predict(x[None])[0]
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)
    # query consumed nothing; query_and_delete removes
    assert not isinstance(oq.query("req-1"), str)
    oq.query_and_delete("req-1")
    assert oq.query("req-1") == "[]"


def test_sync_predict_and_batching(serving_stack):
    r, im, cs = serving_stack
    iq = InputQueue(port=r.port)
    rs = np.random.RandomState(1)
    xs = rs.randn(5, 6).astype(np.float32)
    outs = [np.asarray(iq.predict(xs[i])) for i in range(5)]
    refs = im.predict(xs)
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, refs[i], atol=1e-5)
    assert cs.records_out >= 5
    stats = cs.metrics()
    assert stats["inference"]["count"] >= 1


def test_dequeue_all(serving_stack):
    r, im, cs = serving_stack
    iq = InputQueue(port=r.port)
    oq = OutputQueue(port=r.port)
    x = np.random.RandomState(2).randn(6).astype(np.float32)
    iq.enqueue("a", t=x)
    iq.enqueue("b", t=x * 2)
    _wait_query(oq, "a")
    _wait_query(oq, "b")
    res = oq.dequeue()
    assert set(res) == {"a", "b"}
    assert oq.dequeue() == {}  # drained


def test_http_frontend(serving_stack):
    r, im, cs = serving_stack
    iq = InputQueue(port=r.port)
    fe = FrontEnd(cs, iq).start()
    try:
        x = np.random.RandomState(3).randn(6).astype(np.float32)
        body = json.dumps({"instances": [{"t": x.tolist()}]}).encode()
        code, resp, _ = _post(f"http://{fe.host}:{fe.port}/predict", body,
                              {"Content-Type": "application/json"})
        assert code == 200
        val = json.loads(json.loads(resp["predictions"][0])["value"])
        got = np.asarray(val["data"]).reshape(val["shape"])
        ref = im.predict(x[None])[0]
        np.testing.assert_allclose(got, ref, atol=1e-4)
        met = json.loads(urllib.request.urlopen(
            f"http://{fe.host}:{fe.port}/metrics", timeout=15).read())
        assert met["records_out"] >= 1
    finally:
        fe.stop()


def test_nan_contract_on_bad_input(serving_stack):
    """Unpredictable records answer "NaN", not silence."""
    r, im, cs = serving_stack
    iq = InputQueue(port=r.port)
    oq = OutputQueue(port=r.port)
    bad = np.random.RandomState(4).randn(17).astype(np.float32)  # wrong dim
    iq.enqueue("bad-1", t=bad)
    out = _wait_query(oq, "bad-1")
    assert out == "NaN"


def test_string_and_sparse_schema_roundtrip(serving_stack):
    x = np.arange(6, dtype=np.float32)
    b64 = port_client.encode_input_b64(s=["a", "b", "c"], t=x.reshape(2, 3))
    out = port_client.decode_input_b64(b64)
    assert out["s"] == "a|b|c"
    np.testing.assert_allclose(out["t"], x.reshape(2, 3))


# --------------------------------------------------------- mixed fleet


def _jax_mlp():
    m = JSequential()
    m.add(JDense(4, input_shape=(6,), activation="relu"))
    m.add(JDense(2))
    m.compile(optimizer="adam", loss="mse")
    m.build()
    jim = JInferenceModel()
    jim.load_keras(m)
    tm = Sequential()
    tm.add(Dense(4, input_shape=(6,), activation="relu"))
    tm.add(Dense(2))
    tm.compile(optimizer="adam", loss="mse")
    tm.params = keras_params_from_jax(
        jax.tree_util.tree_map(np.asarray, m.params), "cpu")
    return jim, InferenceModel().load_keras(tm, device="cpu")


MIXED_TOL = 1e-6


def _drive(client_mod, port, xs, direct):
    """Queue enqueue/query, sync predict and dequeue through
    ``client_mod``'s queues; every reply against ``direct``."""
    iq = client_mod.InputQueue(port=port)
    oq = client_mod.OutputQueue(port=port)
    for i, x in enumerate(xs[:3]):
        iq.enqueue(f"m-{i}", t=x)
    for i in range(3):
        np.testing.assert_allclose(np.asarray(_wait_query(oq, f"m-{i}")),
                                   direct[i], rtol=0, atol=MIXED_TOL)
    for i in range(3, len(xs)):
        np.testing.assert_allclose(np.asarray(iq.predict(xs[i])),
                                   direct[i], rtol=0, atol=MIXED_TOL)
    got = oq.dequeue()
    assert set(got) == {"m-0", "m-1", "m-2"}
    assert oq.dequeue() == {}


def test_mixed_fleet_serves_across_packages():
    jim, tim = _jax_mlp()
    xs = np.random.RandomState(5).randn(8, 6).astype(np.float32)
    jax_direct = np.asarray(jim.predict(xs))
    port_direct = tim.predict(xs)
    np.testing.assert_allclose(port_direct, jax_direct, rtol=0,
                               atol=MIXED_TOL)
    # JAX clients -> port server
    r = EmbeddedRedis().start()
    cs = ClusterServing(tim, redis_port=r.port).start()
    try:
        _drive(jax_client, r.port, xs, jax_direct)
        assert cs.metrics()["nan_records"] == 0
    finally:
        cs.stop()
        r.stop()
    # port clients -> JAX server
    jr = jax_redis.EmbeddedRedis().start()
    jcs = jax_cs.ClusterServing(jim, redis_port=jr.port).start()
    try:
        _drive(port_client, jr.port, xs, port_direct)
    finally:
        jcs.stop()
        jr.stop()


# ------------------------------------------------------ fallback count


def test_the_fallback_and_nan_replies_are_counted(serving_stack):
    r, im, cs = serving_stack
    # hold the consumer so the three records land in one batch
    gate = threading.Event()
    real = im.predict

    def gated(x, batch_size=None):
        gate.wait(10)
        return real(x, batch_size=batch_size)

    im.predict = gated
    iq = InputQueue(port=r.port)
    oq = OutputQueue(port=r.port)
    rs = np.random.RandomState(6)
    good = rs.randn(2, 6).astype(np.float32)
    iq.enqueue("ok-0", t=good[0])
    time.sleep(0.3)          # the consumer now waits in the first batch
    iq.enqueue("ok-1", t=good[1])
    iq.enqueue("ragged", t=rs.randn(5).astype(np.float32))
    iq._enqueue_data({"uri": "garbled", "data": "bm90IGFycm93"})
    gate.set()
    assert not isinstance(_wait_query(oq, "ok-0"), str)
    np.testing.assert_allclose(np.asarray(_wait_query(oq, "ok-1")),
                               real(good[1:2])[0], atol=1e-5)
    assert _wait_query(oq, "ragged") == "NaN"
    assert _wait_query(oq, "garbled") == "NaN"
    m = cs.metrics()
    assert (m["fallback_batches"], m["fallback_records"],
            m["nan_records"]) == (1, 2, 2), m
    assert m["records_out"] == 4 and m["batches"] == 2
    fe = FrontEnd(cs, iq).start()
    try:
        met = json.loads(urllib.request.urlopen(
            f"http://{fe.host}:{fe.port}/metrics", timeout=15).read())
        assert met["fallback_records"] == 2 and met["nan_records"] == 2
    finally:
        fe.stop()


# ------------------------------------------------------ front end door


class _Serving:
    def metrics(self):
        return {"records_out": 0}


class _IQ:
    def predict(self, data):
        return np.asarray(data["t"]) * 2.0


def _doors():
    port = FrontEnd(_Serving(), _IQ(), host="127.0.0.1", port=0).start()
    jax_fe = jax_cs.FrontEnd(_Serving(), _IQ(), host="127.0.0.1",
                             port=0).start()
    return {"port": port, "jax": jax_fe}


def _ask(doors, path, body, headers):
    out = {}
    for name, fe in doors.items():
        code, payload, hdrs = _post(f"http://{fe.host}:{fe.port}{path}",
                                    body, headers)
        # the refill hint is a time: each door's own, within its bucket
        hint = payload.pop("retry_after_ms", None)
        if hint is not None:
            assert 0 < hint <= 2000, (name, hint)
            payload["retry_after_ms"] = True
        out[name] = (code, payload, hdrs.get("X-Zoo-Trace"),
                     hdrs.get("X-Zoo-Tenant"))
    assert out["port"] == out["jax"], out
    return out["port"]


def test_front_end_headers_deadline_and_tenant_shed_match_jax(
        tmp_path, monkeypatch):
    doors = _doors()
    body = json.dumps({"instances": [{"t": [1.0, 2.0]},
                                     {"t": [3.0]}]}).encode()
    try:
        code, payload, trace, tenant = _ask(
            doors, "/predict", body,
            {"X-Zoo-Trace": "t-1", "X-Zoo-Tenant": "acme"})
        assert (code, trace, tenant) == (200, "t-1", "acme")
        val = json.loads(json.loads(payload["predictions"][1])["value"])
        assert val == {"data": [6.0], "shape": [1]}
        # an expired budget: 504 before any instance, trace echoed
        code, payload, trace, _ = _ask(
            doors, "/predict", body,
            {"X-Zoo-Deadline-Ms": "0", "X-Zoo-Trace": "t-2"})
        assert (code, payload["expired"], payload["completed"], trace) == \
            (504, True, 0, "t-2")
        code, _, _, _ = _ask(doors, "/predict", body,
                             {"X-Zoo-Deadline-Ms": "30000"})
        assert code == 200
        code, payload, _, _ = _ask(doors, "/predict", body,
                                   {"X-Zoo-Deadline-Ms": "soon"})
        assert code == 400 and "X-Zoo-Deadline-Ms" in payload["error"]
        code, _, _, _ = _ask(doors, "/predict", b"{}", {})
        assert code == 400
        # a tenant past its bucket: 429 with the refill hint, echoed
        spec = "acme:rate=0.5,burst=1"
        port_tenancy.reset_registry(port_tenancy.TenantRegistry(spec))
        jax_tenancy.reset_registry(jax_tenancy.TenantRegistry(spec))
        for expect in (200, 429):
            code, payload, _, tenant = _ask(doors, "/predict", body,
                                            {"X-Zoo-Tenant": "acme"})
            assert (code, tenant) == (expect, "acme")
        assert payload["reason"] == "rate" and payload["retryable"]
        assert payload["retry_after_ms"] is True
    finally:
        port_tenancy.reset_registry(None)
        jax_tenancy.reset_registry(None)
        for fe in doors.values():
            fe.stop()


def test_front_end_span_is_under_the_callers_trace(tmp_path):
    fe = FrontEnd(_Serving(), _IQ(), host="127.0.0.1", port=0).start()
    tracing.trace_to(str(tmp_path))
    try:
        body = json.dumps({"instances": [{"t": [1.0]}]}).encode()
        code, _, hdrs = _post(f"http://{fe.host}:{fe.port}/predict", body,
                              {"X-Zoo-Trace": "tr-9",
                               "X-Zoo-Parent-Span": "p-1"})
        assert code == 200 and hdrs.get("X-Zoo-Trace") == "tr-9"
    finally:
        tracing.stop_tracing()
        fe.stop()
    spans = [e for e in tracing.read_trace(str(tmp_path))
             if e.get("name") == "http.predict"]
    assert [(s["trace"], s["parent"]) for s in spans] == [("tr-9", "p-1")]
