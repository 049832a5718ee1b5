"""The port's predict door against the JAX package's.

* Frames: the request and reply frames of ``predict``, ``stats``,
  ``version`` and ``reload`` are byte-identical between the two
  packages' ``TCPInputQueue`` and ``ServingServer`` over the same
  synthetic model (a recording proxy sits between client and server;
  request ids come from a patched ``uuid4``, and a constant
  ``perf_counter`` makes the stage timers and the reload time the same).
* Scripted door sequences give the same reply dicts from both doors:
  dedup join, version bounce, breaker shed, dead-on-arrival, the
  ``max_queue`` rejection, padding and the drain, with its timeout.
* Across packages: a JAX ``HAServingClient`` against port servers and a
  port client against JAX servers, version pins included.
* The slice end to end: a small Keras image model built in JAX, its
  weights saved by JAX, loaded by the port, saved as the port's model
  file, published to a port registry, served from a ``registry:`` spec
  and queried through the port's ``HAServingClient``: replies equal the
  JAX ``InferenceModel.predict`` on the same weights within 1e-6, and a
  ``reload`` to a second version mid-load fails no request and mixes no
  batch (each reply equals the model of the version it echoes).

Every test keeps a time limit of its own (``tests/torch_time_limit.py``).
"""

import socket
import struct
import threading
import time
import uuid

import jax
import numpy as np
import pytest

from zoo_tpu.pipeline.inference import inference_model as jinf
from zoo_tpu.serving import ha as jax_ha
from zoo_tpu.serving import ha_client as jax_ha_client
from zoo_tpu.serving import registry as jax_registry
from zoo_tpu.serving import server as jax_server
from zoo_tpu.serving import tcp_client as jax_tcp
from zoo_tpu.util import resilience as jax_resilience

from zoo_tpu_torch.models.image import resnet as tresnet
from zoo_tpu_torch.serving import ha as port_ha
from zoo_tpu_torch.serving import ha_client as port_ha_client
from zoo_tpu_torch.serving import registry as port_registry
from zoo_tpu_torch.serving import server as port_server
from zoo_tpu_torch.serving import tcp_client as port_tcp
from zoo_tpu_torch.util import resilience as port_resilience

from test_torch_resnet import _images, _no_mesh, _pair  # noqa: F401
from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

PKG = {"port": (port_server, port_tcp, port_ha, port_ha_client,
                port_resilience),
       "jax": (jax_server, jax_tcp, jax_ha, jax_ha_client,
               jax_resilience)}


def _x(v, rows=1, cols=3):
    return np.full((rows, cols), float(v), np.float32)


class _Gate:
    """A model whose predict waits for ``release`` and records every
    batch's shape (package-independent, so both doors serve the same
    object type)."""

    def __init__(self, fail=False):
        self.release = threading.Event()
        self.shapes = []
        self.entered = threading.Event()
        self.fail = fail

    def predict(self, x, batch_size=None):
        self.shapes.append(tuple(np.shape(x)))
        self.entered.set()
        self.release.wait(30)
        if self.fail:
            raise RuntimeError("gate model: inference failed")
        return np.asarray(x) * 2.0


def _raw(srv, msg):
    """One request on a fresh plain socket (no client stamping), the
    decoded reply."""
    s = socket.create_connection((srv.host, srv.port))
    try:
        port_server._send_msg(s, msg)
        return port_server._recv_msg(s)
    finally:
        s.close()


def _raw_async(srv, msg, out, key):
    t = threading.Thread(target=lambda: out.__setitem__(key,
                                                        _raw(srv, msg)))
    t.start()
    return t


def _wait(cond, budget=10.0):
    end = time.monotonic() + budget
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    return cond()


# --------------------------------------------------------------- frames

class _Proxy:
    """Forwards one TCP connection to ``target`` and records the bytes
    each way."""

    def __init__(self, target):
        self.target = target
        self.up, self.down = bytearray(), bytearray()
        self._ls = socket.socket()
        self._ls.bind(("127.0.0.1", 0))
        self._ls.listen(1)
        self.host, self.port = self._ls.getsockname()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        c, _ = self._ls.accept()
        s = socket.create_connection(self.target)

        def pump(a, b, buf):
            while True:
                try:
                    data = a.recv(1 << 16)
                except OSError:
                    data = b""
                if not data:
                    try:
                        b.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    return
                buf.extend(data)
                b.sendall(data)

        t = threading.Thread(target=pump, args=(s, c, self.down),
                             daemon=True)
        t.start()
        pump(c, s, self.up)
        t.join(10)
        c.close()
        s.close()
        self._ls.close()

    def join(self):
        self._t.join(10)


def _frames(buf):
    """Split recorded wire bytes into frames (length word, payload and
    the CRC trailer when flagged)."""
    out, i = [], 0
    while i < len(buf):
        (word,) = struct.unpack(">I", bytes(buf[i:i + 4]))
        n = 4 + (word & 0x7FFFFFFF) + (4 if word & 0x80000000 else 0)
        out.append(bytes(buf[i:i + n]))
        i += n
    return out


@pytest.fixture
def frame_registry(tmp_path):
    reg = jax_registry.ModelRegistry(str(tmp_path / "registry"))
    reg.publish(spec="synthetic:double", alias="prod")
    reg.publish(spec="synthetic:double:1")
    return reg


@pytest.mark.timeout(120)
@pytest.mark.parametrize("op", ["predict", "stats", "version", "reload"])
def test_frames_are_byte_identical(op, frame_registry, monkeypatch):
    ids = iter(range(1000))
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(ids) + 7))
    monkeypatch.setattr(time, "perf_counter", lambda: 42.0)
    spec = f"registry:{frame_registry.root}:prod"
    recorded = {}
    for name, (srv_mod, tcp_mod, ha_mod, _, _) in PKG.items():
        ids = iter(range(1000))
        model, version = ha_mod.resolve_model_spec(spec, batch_size=4)
        srv = srv_mod.ServingServer(model, batch_size=4, max_wait_ms=1.0,
                                    version=version,
                                    model_spec=spec).start()
        try:
            proxy = _Proxy((srv.host, srv.port))
            q = tcp_mod.TCPInputQueue(proxy.host, proxy.port)
            replies = [q.predict(_x(1.5, rows=2))]   # a batch to count
            if op == "predict":
                replies.append(q.predict(_x(3.0, rows=3, cols=5)))
                q.enqueue("img-1", t=np.arange(6, dtype=np.int32))
                replies.append(q.pop_result("img-1"))
            elif op == "stats":
                replies.append(q.stats())
            elif op == "version":
                replies.append(q.version())
            else:
                replies.append(q._conn.rpc({
                    "op": "reload",
                    "spec": f"registry:{frame_registry.root}:v2"}))
                replies.append(q.version())
            q.close()
            proxy.join()
        finally:
            srv.stop()
        recorded[name] = (_frames(proxy.up), _frames(proxy.down), replies)
    (up_p, down_p, rep_p), (up_j, down_j, rep_j) = recorded["port"], \
        recorded["jax"]
    assert len(up_p) == len(down_p) >= 2
    assert up_p == up_j, "request frames differ"
    assert down_p == down_j, "reply frames differ"
    if op == "reload":
        assert rep_p[1]["ok"] and rep_p[1]["version"] == "v2"
        assert rep_p[2]["version"] == "v2"


# ------------------------------------------------------ scripted doors

def _door(pkg, model, **kw):
    srv_mod = PKG[pkg][0]
    kw.setdefault("batch_size", 4)
    kw.setdefault("max_wait_ms", 1.0)
    return srv_mod.ServingServer(model, **kw).start()


def _scenario_dedup_and_padding(pkg):
    gate = _Gate()
    srv = _door(pkg, gate, version="v1")
    out = {}
    try:
        msg = {"op": "predict", "uri": "u", "id": "same",
               "data": _x(2.0, rows=3)}
        t1 = _raw_async(srv, msg, out, "a")
        assert gate.entered.wait(10)
        t2 = _raw_async(srv, msg, out, "b")   # joins the pending one
        time.sleep(0.2)
        gate.release.set()
        t1.join(10)
        t2.join(10)
        out["c"] = _raw(srv, {"op": "predict", "uri": "v", "id": "six",
                              "data": _x(1.0, rows=6)})
        out["shapes"] = list(gate.shapes)
    finally:
        srv.stop()
    return out


def _scenario_bounce_breaker_doa(pkg):
    gate = _Gate(fail=True)
    gate.release.set()
    breaker = PKG[pkg][4].CircuitBreaker(failure_threshold=1,
                                         recovery_timeout=30.0)
    srv = _door(pkg, gate, version="v1", breaker=breaker)
    out = {}
    try:
        out["bounce"] = _raw(srv, {"op": "predict", "uri": "u", "id": "1",
                                   "model_version": "v2",
                                   "data": _x(1.0)})
        out["same_version"] = _raw(srv, {"op": "predict", "uri": "u",
                                         "id": "2", "model_version": "v1",
                                         "data": _x(1.0)})
        out["shed"] = _raw(srv, {"op": "predict", "uri": "u", "id": "3",
                                 "data": _x(1.0)})
    finally:
        srv.stop()
    srv = _door(pkg, gate, version="v1")
    try:
        out["doa"] = _raw(srv, {"op": "predict", "uri": "u", "id": "4",
                                "deadline_ms": 0, "data": _x(1.0)})
        out["llm"] = _raw(srv, {"op": "generate", "id": "5",
                                "prompt": [1], "max_new_tokens": 1})
        out["llm_stats"] = _raw(srv, {"op": "llm_stats", "id": "6"})
    finally:
        srv.stop()
    return out


def _scenario_max_queue(pkg):
    gate = _Gate()
    srv = _door(pkg, gate, max_queue=1, batch_size=2, max_wait_ms=7.0)
    out = {}
    try:
        t1 = _raw_async(srv, {"op": "predict", "uri": "a", "id": "a",
                              "data": _x(1.0)}, out, "a")
        assert gate.entered.wait(10)
        t2 = _raw_async(srv, {"op": "predict", "uri": "b", "id": "b",
                              "data": _x(2.0)}, out, "b")
        assert _wait(lambda: srv._queue.qsize() == 1)
        out["c"] = _raw(srv, {"op": "predict", "uri": "c", "id": "c",
                              "data": _x(3.0)})
        gate.release.set()
        t1.join(10)
        t2.join(10)
    finally:
        srv.stop()
    return out


def _scenario_drain(pkg):
    gate = _Gate()
    srv = _door(pkg, gate)
    out = {}
    t1 = _raw_async(srv, {"op": "predict", "uri": "a", "id": "a",
                          "data": _x(1.0)}, out, "in_flight")
    assert gate.entered.wait(10)
    drained = {}
    td = threading.Thread(target=lambda: drained.setdefault(
        "ok", srv.drain(timeout=20.0)))
    td.start()
    assert _wait(lambda: srv._draining.is_set())
    out["late"] = _raw(srv, {"op": "predict", "uri": "b", "id": "b",
                             "data": _x(2.0)})
    gate.release.set()
    t1.join(10)
    td.join(20)
    out["drained"] = drained["ok"]
    # a drain whose budget runs out reports it
    gate2 = _Gate()
    srv2 = _door(pkg, gate2)
    t2 = _raw_async(srv2, {"op": "predict", "uri": "c", "id": "c",
                           "data": _x(3.0)}, {}, "x")
    assert gate2.entered.wait(10)
    out["timed_out_drain"] = srv2.drain(timeout=0.2)
    gate2.release.set()
    t2.join(10)
    return out


SCENARIOS = {"dedup_and_padding": _scenario_dedup_and_padding,
             "bounce_breaker_doa": _scenario_bounce_breaker_doa,
             "max_queue": _scenario_max_queue,
             "drain": _scenario_drain}


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tolist())
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scripted_door_sequences_reply_as_jax(name):
    got = _plain(SCENARIOS[name]("port"))
    ref = _plain(SCENARIOS[name]("jax"))
    assert got == ref
    if name == "dedup_and_padding":
        # one execution for the two same-id requests, padded to 4; the
        # six-row request padded to 8
        assert got["shapes"] == [[4, 3], [8, 3]]
        assert got["a"] == got["b"]
    if name == "bounce_breaker_doa":
        assert got["bounce"]["version_mismatch"] and \
            got["shed"]["retry_after_ms"] == 30000
        assert got["doa"]["expired"]
    if name == "max_queue":
        assert got["c"]["shed"] and got["c"]["retry_after_ms"] == 7
    if name == "drain":
        assert got["drained"] is True and got["late"]["draining"]
        assert got["timed_out_drain"] is False


def test_tenancy_still_waits_for_its_item(monkeypatch):
    with pytest.raises(NotImplementedError, match="A.4"):
        port_server.ServingServer(_Gate(), port=0, tenancy=object())
    monkeypatch.setenv("ZOO_TENANT_CONFIG", "gold:weight=2")
    with pytest.raises(NotImplementedError, match="A.4"):
        port_server.ServingServer(_Gate(), port=0)


def _versions_across_a_swap(srv_mod):
    """The versions echoed by a request whose batch is in flight while
    ``reload_model`` swaps v1 for v2, and by one sent after the swap."""
    old, new = _Gate(), _Gate()
    new.release.set()
    srv = srv_mod.ServingServer(
        old, batch_size=2, max_wait_ms=1.0, version="v1",
        model_loader=lambda spec: (new, "v2")).start()
    out = {}
    try:
        t = _raw_async(srv, {"op": "predict", "uri": "a", "id": "a",
                             "data": _x(1.0)}, out, "a")
        assert old.entered.wait(10)
        info = srv.reload_model("whatever", warm=False)
        assert info["version"] == "v2" and srv.version == "v2"
        old.release.set()
        t.join(10)
        out["b"] = _raw(srv, {"op": "predict", "uri": "b", "id": "b",
                              "data": _x(1.0)})
    finally:
        srv.stop()
    np.testing.assert_array_equal(out["a"]["result"], _x(2.0))
    return out["a"]["version"], out["b"]["version"]


def test_a_reply_echoes_the_version_that_computed_it():
    """A batch in flight across a hot-swap answers with the version of
    the model that ran it. This is a deliberate break from the JAX
    door's frames, pinned here: that door echoes the version live at
    reply time, which the swap has moved on, so its in-flight reply
    names v2 though v1 computed it."""
    assert _versions_across_a_swap(port_server) == ("v1", "v2")
    assert _versions_across_a_swap(jax_server) == ("v2", "v2")


# ------------------------------------------------------ across packages

@pytest.mark.timeout(120)
@pytest.mark.parametrize("client,server", [("jax", "port"),
                                           ("port", "jax")])
def test_ha_clients_cross_packages(client, server):
    srv_mod, _, ha_mod, _, _ = PKG[server]
    cli_mod = PKG[client][3]
    servers = [srv_mod.ServingServer(ha_mod.SyntheticModel(), port=0,
                                     batch_size=4, max_wait_ms=1.0,
                                     version=v).start()
               for v in ("v1", "v2")]
    try:
        cli = cli_mod.HAServingClient(
            [(s.host, s.port) for s in servers], hedge=False,
            deadline_ms=20_000)
        for i in range(6):
            np.testing.assert_array_equal(cli.predict(_x(i)), _x(2 * i))
        # a pinned request lands on the seat that serves the version,
        # failing over from the one that bounces it
        for v in ("v2", "v1", "v2"):
            resp = cli.rpc({"op": "predict", "uri": "p", "data": _x(4.0),
                            "model_version": v})
            assert resp["version"] == v
            np.testing.assert_array_equal(resp["result"], _x(8.0))
        cli.pin_version("v1")
        assert {cli.rpc({"op": "predict", "uri": "q",
                         "data": _x(1.0)})["version"]
                for _ in range(4)} == {"v1"}
        stats = cli.stats()
        assert [sorted(s) for s in stats] == \
            [["batch", "inference", "total", "version"]] * 2
        cli.close()
    finally:
        for s in servers:
            s.stop()


def test_ab_split_parses_and_validates_like_jax(monkeypatch):
    for text in ("v2=0.1,v3=0.05", " v2 = 0.5 ", ""):
        assert port_ha_client._parse_ab_split(text) == \
            jax_ha_client._parse_ab_split(text)
    for bad in ("v2", "v2=x"):
        with pytest.raises(ValueError, match="malformed"):
            port_ha_client._parse_ab_split(bad)
    for bad in ({"v2": 1.5}, {"v2": 0.6, "v3": 0.6}):
        with pytest.raises(ValueError):
            port_ha_client._validate_ab_split(bad)
    assert port_ha_client._parse_tenant_pins("gold=v2,free=v1") == \
        jax_ha_client._parse_tenant_pins("gold=v2,free=v1")
    monkeypatch.setenv("ZOO_SERVE_AB_SPLIT", "v2=1.0")
    monkeypatch.setenv("ZOO_TENANT_AB_PINS", "gold=v1")
    cli = port_ha_client.HAServingClient([("127.0.0.1", 1)])
    assert cli._draw_version() == "v2" and \
        cli._draw_version("gold") == "v1"
    cli.pin_version(None)
    cli.pin_version("v3", tenant="free")
    assert cli._draw_version() is None and \
        cli._draw_version("free") == "v3"
    cli.close()


# ------------------------------------------------ the slice end to end

@pytest.mark.timeout(300)
def test_the_slice_end_to_end(tmp_path):
    # 1. two small Keras image models built in JAX, weights saved by JAX
    jm1, _ = _pair()
    jm2 = _pair()[0]
    jm2.params = jax.tree_util.tree_map(lambda a: a * 1.25, jm2.params)
    ref = {}
    x = _images(8, seed=3)
    for v, jm in (("v1", jm1), ("v2", jm2)):
        jm.save_weights(str(tmp_path / f"{v}.pkl"))
        ref[v] = jinf.InferenceModel().load_keras(jm).predict(
            x, batch_size=4)
    # 2. the port loads the weights, saves its model file, publishes
    reg = port_registry.ModelRegistry(str(tmp_path / "registry"))
    for v in ("v1", "v2"):
        tm = tresnet.ResNet(10, (1, 1), bottleneck=True,
                            input_shape=(32, 32, 3))
        tm.compile("adamw", "sparse_categorical_crossentropy")
        tm.load_weights(str(tmp_path / f"{v}.pkl"), device="cpu")
        tm.save(str(tmp_path / f"{v}.zoo"))
        assert reg.publish(str(tmp_path / f"{v}.zoo"),
                           alias="prod" if v == "v1" else None) == v
    # 3. served from the registry spec, queried through the HA client
    spec = f"registry:{reg.root}:prod"
    model, version = port_ha.resolve_model_spec(spec, batch_size=4,
                                                device="cpu")
    assert version == "v1"
    srv = port_server.ServingServer(model, batch_size=4, max_wait_ms=2.0,
                                    version=version,
                                    model_spec=spec).start()
    cli = port_ha_client.HAServingClient([(srv.host, srv.port)],
                                         deadline_ms=60_000)
    try:
        # 4. replies equal the JAX InferenceModel's
        for i in range(len(x)):
            np.testing.assert_allclose(cli.predict(x[i:i + 1]),
                                       ref["v1"][i:i + 1], rtol=0,
                                       atol=1e-6)
        # 5. a reload to v2 mid-load: zero failures, no mixed batch
        replies, errors = [], []
        lock = threading.Lock()

        def load(c):
            for i in range(6):
                k = (c + i) % len(x)
                try:
                    r = cli.rpc({"op": "predict", "uri": f"{c}-{i}",
                                 "data": x[k:k + 1]})
                    with lock:
                        replies.append((k, r))
                except Exception as e:  # noqa: BLE001 — counted
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=load, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        assert _wait(lambda: len(replies) >= 6, 60)
        info = port_tcp._Connection(srv.host, srv.port).rpc(
            {"op": "reload", "spec": f"registry:{reg.root}:v2"})
        for t in threads:
            t.join(120)
    finally:
        cli.close()
        srv.stop()
    assert info["ok"] and info["version"] == "v2" and \
        info["previous"] == "v1"
    assert not errors and len(replies) == 24
    seen = set()
    for k, r in replies:
        seen.add(r["version"])
        np.testing.assert_allclose(r["result"], ref[r["version"]][k:k + 1],
                                   rtol=0, atol=1e-6)
    assert seen <= {"v1", "v2"} and "v1" in seen
