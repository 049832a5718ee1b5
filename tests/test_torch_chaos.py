"""The port's chaos harness against the JAX package's: ``ChaosSchedule``
resolves the same fault sequence for the same (spec, seed, replicas)
over Hypothesis-drawn specs, refuses the same malformed specs with the
same message, reads the same env defaults, dispatches window edges in
order, survives action errors and reseeds the injector so p-draws
replay as JAX's do; the wire ``chaos`` op is refused without
``ZOO_CHAOS_ALLOW`` and arms and clears a site in the serving process;
the ``chaos`` / ``debug_dump`` / shed replies are byte-equal to the JAX
door's (a bundle's body apart); and the ``check_chaos_storm`` copy runs
as a subprocess.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from zoo_tpu.obs import flight as jax_flight
from zoo_tpu.serving import ha as jax_ha
from zoo_tpu.serving import server as jax_server
from zoo_tpu.util import resilience as jax_res

from zoo_tpu_torch.obs import flight as port_flight
from zoo_tpu_torch.serving import ha as port_ha
from zoo_tpu_torch.serving import server as port_server
from zoo_tpu_torch.serving.tcp_client import _Connection
from zoo_tpu_torch.util import resilience as port_res

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jax_res, jax_server, jax_ha, jax_flight),
        "port": (port_res, port_server, port_ha, port_flight)}


# ------------------------------------------------------- ChaosSchedule

def _time_tok(draw):
    a = draw(st.floats(0.0, 20.0, allow_nan=False).map(lambda v: round(v, 3)))
    if draw(st.booleans()):
        b = draw(st.floats(0.0, 20.0, allow_nan=False).map(
            lambda v: round(v, 3)))
        lo, hi = min(a, b), max(a, b)
        return f"{lo:g}~{hi:g}", hi
    return f"{a:g}", a


@st.composite
def chaos_specs(draw):
    events = []
    for _ in range(draw(st.integers(0, 6))):
        kind = draw(st.sampled_from(["kill", "slow", "corrupt", "drop",
                                     "diskfull", "x_y"]))
        t0, hi0 = _time_tok(draw)
        when = t0
        if draw(st.booleans()):
            # a window: its close draws from past the open's range
            lo1 = hi0 + draw(st.floats(0.0, 5.0).map(lambda v: round(v, 3)))
            if draw(st.booleans()):
                when += f"-{lo1:g}~{lo1 + 1.5:g}"
            else:
                when += f"-{lo1:g}"
        params = []
        for key in draw(st.lists(st.sampled_from(
                ["replica", "delay_ms", "p", "times", "site"]),
                unique=True, max_size=3)):
            params.append(key + "=" + draw(st.sampled_from(
                ["?", "1", "80", "0.15", "2.5e-1", "serving.infer",
                 "-3"])))
        events.append(f"{kind}@{when}" + (":" + ",".join(params)
                                          if params else ""))
    sep = draw(st.sampled_from([";", " ; ", ";;"]))
    return sep.join(events)


@settings(max_examples=120, deadline=None)
@given(spec=chaos_specs(), seed=st.integers(0, 2**31 - 1),
       replicas=st.integers(1, 7))
def test_resolved_sequence_equals_jax(spec, seed, replicas):
    got = port_res.ChaosSchedule(spec, seed=seed, replicas=replicas)
    ref = jax_res.ChaosSchedule(spec, seed=seed, replicas=replicas)
    assert got.resolved() == ref.resolved()
    assert got.horizon == ref.horizon
    assert [repr(e) for e in got.events] == [repr(e) for e in ref.events]


@pytest.mark.parametrize("spec,replicas", [
    ("kill:replica=0", None), ("slow@3.0-1.0", None),
    ("kill@1.0:replica=?", None), ("kill@1.0:replica", None),
    ("kill@", None), ("kill@x", None), ("kill@1.0~", None),
    ("slow@1-2-3", 2), ("kill@1.0:replica=?", 0),
])
def test_malformed_specs_are_refused_alike(spec, replicas):
    errs = []
    for mod in (port_res, jax_res):
        with pytest.raises(ValueError) as e:
            mod.ChaosSchedule(spec, seed=0, replicas=replicas)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_env_defaults_equal_jax(monkeypatch):
    monkeypatch.setenv("ZOO_CHAOS_SPEC",
                       "kill@1.5~2.5:replica=?;slow@0.2-1:delay_ms=40")
    monkeypatch.setenv("ZOO_CHAOS_SEED", "99")
    got, ref = port_res.ChaosSchedule(replicas=3), \
        jax_res.ChaosSchedule(replicas=3)
    assert got.seed == ref.seed == 99
    assert got.resolved() == ref.resolved()
    monkeypatch.setenv("ZOO_CHAOS_SEED", "")
    assert port_res.ChaosSchedule(replicas=3).seed == 0


def test_run_dispatches_window_edges_in_order():
    calls = []
    s = port_res.ChaosSchedule("a@0.01-0.05:x=1;b@0.02;c@0.03", seed=0)
    s.run({"a": lambda ev, ph: calls.append(("a", ph)),
           "b": lambda ev, ph: calls.append(("b", ph))})   # no c action
    assert s.join(timeout=5.0)
    assert calls == [("a", "start"), ("b", "start"), ("a", "end")]
    stopped = port_res.ChaosSchedule("a@5.0", seed=0)
    stopped.run({"a": lambda ev, ph: calls.append("late")})
    stopped.stop()
    assert stopped.join(timeout=5.0) and "late" not in calls


def test_action_errors_never_kill_the_run():
    calls = []

    def boom(ev, ph):
        raise RuntimeError("chaos action bug")

    s = port_res.ChaosSchedule("a@0.0;b@0.02", seed=0)
    s.run({"a": boom, "b": lambda ev, ph: calls.append("b")})
    assert s.join(timeout=5.0)
    assert calls == ["b"]


def test_reseeded_p_draws_replay_like_jax():
    seqs = {}
    for name, (res, *_rest) in PKGS.items():
        runs = []
        for _ in range(2):
            inj = res.FaultInjector()
            s = res.ChaosSchedule("noop@0.0", seed=123)
            s.run({"noop": lambda ev, ph: None}, injector=inj)
            assert s.join(timeout=5.0)
            inj.inject("x", exc=None, action=lambda **k: None, p=0.5)
            fired = []
            for _ in range(64):
                before = inj.fired("x")
                inj.fire("x")
                fired.append(inj.fired("x") > before)
            runs.append(fired)
        assert runs[0] == runs[1], "p-draws did not replay under one seed"
        seqs[name] = runs[0]
    assert seqs["port"] == seqs["jax"]
    assert 0 < sum(seqs["port"]) < 64


# ------------------------------------------------- the wire chaos op

def _door(pkg, **kw):
    _res, server, ha, _fl = PKGS[pkg]
    return server.ServingServer(ha.SyntheticModel(), port=0, batch_size=2,
                                max_wait_ms=1.0, **kw).start()


def _raw_reply(srv, msg):
    """One request's reply frame as the bytes on the wire."""
    sock = socket.create_connection((srv.host, srv.port), timeout=10)
    try:
        port_server._send_msg(sock, msg)
        head = port_server._recv_exact(sock, 4)
        (word,) = struct.unpack(">I", head)
        body = port_server._recv_exact(sock, word & 0x7FFFFFFF)
        return bytes(head) + bytes(body)
    finally:
        sock.close()


def test_chaos_op_refused_without_allow_env(monkeypatch):
    monkeypatch.delenv("ZOO_CHAOS_ALLOW", raising=False)
    srv = _door("port")
    try:
        conn = _Connection(srv.host, srv.port)
        resp = conn.rpc({"op": "chaos", "site": "serving.infer",
                         "delay_ms": 50})
        assert "error" in resp and "ZOO_CHAOS_ALLOW" in resp["error"]
        out = conn.rpc({"op": "predict", "uri": "u",
                        "data": np.ones((1, 2), np.float32)})
        np.testing.assert_allclose(out["result"], 2.0)
        conn.close()
    finally:
        srv.stop()
    assert "serving.infer" not in port_res.default_injector._sites


@pytest.mark.parametrize("allow", ["1", "true"])
def test_chaos_op_arms_and_clears_the_serving_process(monkeypatch, allow,
                                                      tmp_path):
    monkeypatch.setenv("ZOO_CHAOS_ALLOW", allow)
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "64")
    monkeypatch.delenv("ZOO_OBS_POSTMORTEM_DIR", raising=False)
    port_flight.reset_for_tests()
    srv = _door("port")
    x = np.ones((1, 2), np.float32)
    try:
        conn = _Connection(srv.host, srv.port)
        assert conn.rpc({"op": "chaos", "site": "serving.infer",
                         "delay_ms": 120})["ok"]
        t0 = time.perf_counter()
        conn.rpc({"op": "predict", "uri": "u", "data": x})
        assert time.perf_counter() - t0 >= 0.1, "the delay did not bite"
        assert port_res.default_injector.fired("serving.infer") >= 1
        assert conn.rpc({"op": "chaos", "site": "serving.infer",
                         "clear": 1})["ok"]
        t0 = time.perf_counter()
        conn.rpc({"op": "predict", "uri": "u", "data": x})
        assert time.perf_counter() - t0 < 0.1, "clear did not disarm"
        # an error arm with a budget: exactly `times` failures
        assert conn.rpc({"op": "chaos", "site": "serving.infer",
                         "error": "connection", "times": 1})["ok"]
        bad = conn.rpc({"op": "predict", "uri": "u", "data": x})
        good = conn.rpc({"op": "predict", "uri": "u", "data": x})
        assert "injected fault" in bad["error"] and "result" in good
        conn.close()
        kinds = [e["kind"] for e in port_flight.flight_recorder().events()]
        assert kinds.count("chaos_arm") == 2 and "chaos_clear" in kinds
    finally:
        port_res.clear_faults()
        srv.stop()
        port_flight.reset_for_tests()


CHAOS_MSGS = [
    {"op": "chaos", "id": "c1"},
    {"op": "chaos", "id": "c2", "site": "serving.infer", "clear": 1},
    {"op": "chaos", "id": "c3", "site": "llm.decode", "delay_ms": 5,
     "times": 2},
    {"op": "chaos", "id": "c4", "site": "flight.spill", "error": "oserror",
     "p": 0.5},
    {"op": "chaos", "id": "c5", "site": "x", "error": "disk"},
    {"op": "chaos", "id": "c6", "site": "x"},
    {"op": "chaos", "id": "c7", "site": "x", "delay_ms": 1,
     "trace": "ab" * 16, "tenant": "t"},
]


@pytest.mark.parametrize("allow", [None, "1"])
def test_chaos_frames_are_byte_equal_to_jax(monkeypatch, allow):
    if allow is None:
        monkeypatch.delenv("ZOO_CHAOS_ALLOW", raising=False)
    else:
        monkeypatch.setenv("ZOO_CHAOS_ALLOW", allow)
    doors = {k: _door(k, version="v3") for k in PKGS}
    try:
        for msg in CHAOS_MSGS:
            assert _raw_reply(doors["port"], msg) == \
                _raw_reply(doors["jax"], msg), msg
    finally:
        for k, (res, _s, _h, _f) in PKGS.items():
            res.clear_faults()
            doors[k].stop()


def test_debug_dump_frame_equals_jax_apart_from_the_bundle(monkeypatch):
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "64")
    monkeypatch.delenv("ZOO_OBS_POSTMORTEM_DIR", raising=False)
    for _r, _s, _h, fl in PKGS.values():
        fl.reset_for_tests()
        fl.record_event("marker", n=1)
    doors = {k: _door(k) for k in PKGS}
    try:
        replies = {}
        for k, srv in doors.items():
            conn = _Connection(srv.host, srv.port)
            replies[k] = conn.rpc({"op": "debug_dump", "id": "d",
                                   "trace": "cd" * 16})
            conn.close()
    finally:
        for k, srv in doors.items():
            srv.stop()
            PKGS[k][3].reset_for_tests()
    bundles = {k: r.pop("bundle") for k, r in replies.items()}
    assert replies["port"] == replies["jax"]
    assert sorted(bundles["port"]) == sorted(bundles["jax"])
    for b in bundles.values():
        assert b["reason"] == "debug_dump" and b["pid"] == os.getpid()
        assert [e["kind"] for e in b["ring"]] == ["marker"]
        assert "counters" in b["metrics"]


def test_shed_replies_are_byte_equal_to_jax_and_echo_the_trace(
        monkeypatch):
    """A queue-full shed, a version bounce and a dead-on-arrival request,
    each carrying a trace: the same reply bytes as the JAX door's, the
    trace echoed, and the shed in each package's flight ring."""
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "64")
    monkeypatch.delenv("ZOO_OBS_POSTMORTEM_DIR", raising=False)
    release = threading.Event()

    class _Block:
        def predict(self, x, batch_size=None):
            release.wait(timeout=15)
            return np.asarray(x) * 2.0

    x = np.zeros((1, 2), np.float32)
    tid = "fe" * 16
    frames, kinds = {}, {}
    for name, (_r, server, _h, fl) in PKGS.items():
        fl.reset_for_tests()
        release.clear()
        srv = server.ServingServer(_Block(), port=0, batch_size=1,
                                   max_wait_ms=0.0, max_queue=1,
                                   version="v1").start()
        threads = []
        try:
            def fire():
                conn = _Connection(srv.host, srv.port)
                try:
                    conn.rpc({"op": "predict", "uri": "u", "data": x})
                finally:
                    conn.close()

            # one request holds the batcher, one fills the bounded
            # queue; the third sheds at the door
            for _ in range(2):
                threads.append(threading.Thread(target=fire))
                threads[-1].start()
                time.sleep(0.4)
            out = [_raw_reply(srv, {"op": "predict", "id": "q", "uri": "u",
                                    "data": x, "trace": tid,
                                    "pspan": "ps" * 8, "tenant": "t"})]
            out.append(_raw_reply(srv, {"op": "predict", "id": "v",
                                        "uri": "u", "data": x,
                                        "model_version": "v9",
                                        "trace": tid}))
            out.append(_raw_reply(srv, {"op": "predict", "id": "e",
                                        "uri": "u", "data": x,
                                        "deadline_ms": 0, "trace": tid}))
            frames[name] = out
        finally:
            release.set()
            for t in threads:
                t.join(timeout=20)
            srv.stop()
        kinds[name] = [(e["kind"], e.get("reason"))
                       for e in fl.flight_recorder().events()]
        fl.reset_for_tests()
    assert frames["port"] == frames["jax"]
    assert all(tid.encode() in f for f in frames["port"])
    assert kinds["port"] == kinds["jax"]
    assert ("shed", "queue_full") in kinds["port"]


# ------------------------------------------------------ the storm copy

@pytest.mark.chaos
@pytest.mark.timeout(320)
def test_check_chaos_storm_copy_runs_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "zoo_tpu_torch.scripts.check_chaos_storm",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "CHAOS STORM OK" in r.stdout
