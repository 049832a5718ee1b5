"""The port's HA layer against the JAX package's: retry backoff, the
circuit breaker, fault injection and gray-failure ejection follow the
same sequences on a fixed seed and a fake clock; ``HAServingClient``
failover with resume equals the reference stream (greedy and seeded);
the first-token hedge joins the live stream on a same-seat landing; a
whole-stream deadline raises; no KV block leaks; the supervisor respawns
a killed worker; the client's request ops, the group's predict specs,
health and lifecycle calls and the replica entry behave as the JAX
package's on the same inputs (what still waits refuses, naming its
ROADMAP item); and the four chaos-smoke copies (``zoo_tpu_torch/scripts``)
run as subprocesses with ``--device cpu`` under their JAX originals'
markers.

Every test keeps a time limit of its own (``timeout`` marker, enforced
by SIGALRM; subprocesses by their own timeout), so a hung replica fails
its test and never stalls the run.
"""

import os
import random
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.serving import ejection as jax_ejection
from zoo_tpu.serving import ha as jax_ha
from zoo_tpu.serving import ha_client as jax_ha_client
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel
from zoo_tpu.util import resilience as jax_resilience

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.orca.bootstrap import ProcessMonitor, WorkerProcess
from zoo_tpu_torch.serving import ejection as port_ejection
from zoo_tpu_torch.serving import ha as port_ha
from zoo_tpu_torch.serving import ha_client as port_ha_client
from zoo_tpu_torch.serving import replica as port_replica
from zoo_tpu_torch.serving.ha_client import HAServingClient
from zoo_tpu_torch.serving.llm.engine import LLMEngine
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel
from zoo_tpu_torch.serving.server import ServingServer
from zoo_tpu_torch.serving.tcp_client import _Connection
from zoo_tpu_torch.util import resilience as port_resilience

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)
SHAPE = dict(num_slots=2, block_size=4, num_blocks=24,
             max_blocks_per_seq=6, prefill_buckets=(8, 16))
SEEDED = {"temperature": 0.9, "top_k": 16, "seed": 77}


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# ------------------------------------------------ retries and the breaker

@pytest.mark.parametrize("jitter", [True, False])
def test_retry_policy_follows_jax_on_a_fixed_seed(jitter):
    def run(mod):
        slept = []
        rng = random.Random(5)
        pol = mod.RetryPolicy(max_attempts=5, base_delay=0.05,
                              max_delay=0.3, jitter=jitter,
                              sleep=slept.append, rng=rng.random)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise ConnectionResetError("reset")
            return "ok"

        out = pol.call(flaky)
        with pytest.raises(mod.RetryError) as e:
            pol.call(lambda: (_ for _ in ()).throw(TimeoutError("t")))
        with pytest.raises(KeyError):     # not retried
            pol.call(lambda: {}["k"])
        return out, slept, e.value.attempts, [pol.backoff(a)
                                              for a in range(1, 8)]

    assert run(port_resilience) == run(jax_resilience)


def test_retry_deadline_gives_up_like_jax():
    def run(mod):
        pol = mod.RetryPolicy(max_attempts=10, base_delay=1.0,
                              jitter=False, deadline=0.5,
                              sleep=lambda s: None)
        with pytest.raises(mod.RetryError) as e:
            pol.call(lambda: (_ for _ in ()).throw(OSError("x")))
        return e.value.attempts, str(e.value).split(":")[0]

    assert run(port_resilience) == run(jax_resilience)


def test_circuit_breaker_transitions_follow_jax():
    def run(mod):
        clock = FakeClock()
        b = mod.CircuitBreaker(failure_threshold=3, recovery_timeout=5.0,
                               half_open_max=1, clock=clock)
        seq = []
        script = ["f", "f", "s", "f", "f", "f", "a", "t6", "a", "a", "f",
                  "t6", "a", "s", "a", "f", "f", "f", "t6", "a", "t6",
                  "a", "a"]
        for op in script:
            if op == "f":
                b.record_failure()
            elif op == "s":
                b.record_success()
            elif op == "a":
                seq.append(b.allow())
            else:
                clock.t += float(op[1:])
            seq.append(b.state)
        with pytest.raises(mod.CircuitOpenError):
            b.record_failure()
            b.call(lambda: 1)
        return seq

    assert run(port_resilience) == run(jax_resilience)


def test_fault_injection_replays_jax_on_a_seed():
    def run(mod):
        inj = mod.FaultInjector(seed=9)
        inj.inject("site", exc=OSError("boom"), p=0.4, times=6)
        fired = []
        for _ in range(40):
            try:
                inj.fire("site")
                fired.append(0)
            except OSError:
                fired.append(1)
        with mod.inject("other", times=1) as armed:
            with pytest.raises(mod.InjectedFault):
                mod.fault_point("other")
            mod.fault_point("other")
        return fired, armed.fired, inj.fired("site")

    assert run(port_resilience) == run(jax_resilience)


def test_heartbeat_file_ages(tmp_path):
    path = str(tmp_path / "hb")
    assert port_resilience.heartbeat_age(path) is None
    port_resilience.touch_heartbeat(path)
    assert 0.0 <= port_resilience.heartbeat_age(path) < 5.0
    t = port_resilience.start_heartbeat_thread(path, interval=0.05)
    assert t is port_resilience.start_heartbeat_thread(path)


def test_ejection_decisions_follow_jax():
    """One scripted latency/error stream for three seats, the same
    decisions step by step (probation, ejection, backoff probe,
    canary, readmission)."""
    rs = np.random.RandomState(3)
    script = []
    for step in range(160):
        seat = step % 3
        slow = seat == 2 and 20 <= step < 90
        err = seat == 1 and 100 <= step < 112
        script.append((seat, float(rs.uniform(0.02, 0.03))
                       * (40 if slow else 1), err))

    def run(mod):
        clock = FakeClock()
        cfg = mod.EjectionConfig(enabled=True, factor=3.0, min_ms=25.0,
                                 min_samples=5, alpha=0.35,
                                 probation_s=1.5, probe_interval_s=0.5,
                                 readmit_base_s=1.0, readmit_max_s=30.0,
                                 error_rate=0.6)
        ctl = mod.EjectionController(cfg, clock=clock)
        scores = [ctl.new_score(f"s{i}") for i in range(3)]
        seq = []
        for seat, dt, err in script:
            clock.t += 0.1
            if err:
                scores[seat].record_error(cfg.alpha)
            else:
                scores[seat].record(dt, cfg.alpha)
            ctl.evaluate(scores)
            seq.append(tuple(ctl.state_of(s) for s in scores) +
                       (ctl.take_canary(scores[seat]),))
        return seq, [e[1:] for e in ctl.events], \
            [s.snapshot() for s in scores]

    got, ref = run(port_ejection), run(jax_ejection)
    assert got == ref
    assert {e[0] for e in got[1]} >= {"probation", "ejected", "probe"}


# ------------------------------------------------- in-process failover

@pytest.fixture(scope="module")
def params():
    base = JaxModel(JaxConfig(**ARCH), seed=0, **SHAPE)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, base.params),
                           "cpu")


def serve(params, slow_s=0.0):
    model = PagedLlamaModel(LlamaConfig(**ARCH), params=params,
                            device="cpu", **SHAPE)
    if slow_s:
        step = model.decode_step

        def decode_step(*a, **k):
            time.sleep(slow_s)
            return step(*a, **k)

        model.decode_step = decode_step
    eng = LLMEngine(model).start()
    return eng, ServingServer(None, llm_engine=eng, port=0).start()


def reference(params, prompt, n, sampling):
    eng, srv = serve(params)
    try:
        conn = _Connection(srv.host, srv.port)
        frames = list(conn.stream({"op": "generate", "id": "ref",
                                   "prompt": prompt, "max_new_tokens": n,
                                   **sampling}))
        conn.close()
    finally:
        srv.stop()
    return [t for f in frames for t in f.get("tokens") or ()]


@pytest.mark.timeout(180)
@pytest.mark.parametrize("sampling", [{}, SEEDED], ids=["greedy",
                                                         "seeded"])
def test_failover_resumes_midstream_equal_to_reference(params, sampling):
    prompt = (np.arange(5) * 3 + 1) % ARCH["vocab"]
    ref = reference(params, prompt, 12, sampling)
    (e1, s1), (e2, s2) = serve(params, slow_s=0.01), serve(params)
    failovers = port_ha_client._failover.value
    try:
        cli = HAServingClient([(s1.host, s1.port), (s2.host, s2.port)],
                              hedge=False, deadline_ms=120_000)
        got = []
        for tok in cli.generate(prompt, 12, **sampling):
            got.append(tok)
            if len(got) == 3:
                s1.stop()   # primary dies mid-stream
        assert got == ref, f"failover stream diverged: {got} vs {ref}"
        assert port_ha_client._failover.value == failovers + 1
        cli.close()
    finally:
        s2.stop()
    assert e1.allocator.used_blocks == 0
    assert e2.allocator.used_blocks == 0


@pytest.mark.timeout(120)
def test_first_token_hedge_joins_the_live_stream_on_the_same_seat(params):
    """Both endpoints name one seat: the hedge fires after 1 ms, lands on
    the same engine with the same id and joins the live stream — one
    stream decoded, the reference's tokens delivered once."""
    prompt = np.array([9, 2, 7, 4])
    ref = reference(params, prompt, 10, {})
    eng, srv = serve(params, slow_s=0.02)
    fired = port_ha_client._hedge.labels(event="fired").value
    try:
        cli = HAServingClient([(srv.host, srv.port)] * 2, hedge=True,
                              hedge_delay_ms=1, deadline_ms=60_000)
        got = list(cli.generate(prompt, 10))
        assert got == ref
        assert port_ha_client._hedge.labels(event="fired").value == \
            fired + 1
        st = eng.stats()
        assert st["generated_tokens"] == 10, st   # decoded once
        cli.close()
    finally:
        srv.stop()
    assert eng.allocator.used_blocks == 0


@pytest.mark.timeout(120)
def test_whole_stream_deadline_raises(params):
    eng, srv = serve(params, slow_s=0.05)
    try:
        cli = HAServingClient([(srv.host, srv.port)], hedge=False,
                              deadline_ms=300)
        got = []
        with pytest.raises(port_resilience.DeadlineExceeded):
            for tok in cli.generate([1, 2, 3], 20):
                got.append(tok)
        assert len(got) < 20
        cli.close()
        end = time.monotonic() + 10
        while eng.allocator.used_blocks and time.monotonic() < end:
            time.sleep(0.02)
        assert eng.allocator.used_blocks == 0
    finally:
        srv.stop()


@pytest.mark.timeout(60)
def test_client_rpc_update_topology_and_refusals(params):
    """The request ops of both packages' clients against one llm-only
    port replica: the same answers (stage timers, the routing error of
    a predict, the A/B split)."""
    eng, srv = serve(params)
    try:
        ep = [(srv.host, srv.port)]
        cli = HAServingClient(ep, hedge=False, deadline_ms=10_000)
        ref = jax_ha_client.HAServingClient(ep, hedge=False,
                                            deadline_ms=10_000)
        assert cli.rpc({"op": "ping"})["ok"] is True
        topo = cli.update_topology()
        assert topo[f"{srv.host}:{srv.port}"]["role"] == "mixed"
        got, want = cli.stats(), ref.stats()
        assert [sorted(s) for s in got] == [sorted(s) for s in want] == \
            [["batch", "inference", "role", "total"]]
        assert got[0]["inference"]["count"] == 0
        assert list(cli.ejection_states().values())[0]["role"] == "mixed"
        for c in (cli, ref):
            with pytest.raises(RuntimeError, match="generate op only"):
                c.predict(np.zeros(2))
        msg = {"op": "predict", "data": np.zeros(2)}
        assert cli.rpc(msg)["error"] == ref.rpc(msg)["error"]
        cli.refresh_endpoints(ep + [(srv.host, 1)])
        assert len(cli.ejection_states()) == 2
        cli.close()
        ref.close()
        ab = HAServingClient(ep, ab_split={"v2": 0.1})
        jab = jax_ha_client.HAServingClient(ep, ab_split={"v2": 0.1})
        assert ab._ab_split == jab._ab_split == {"v2": 0.1}
        ab.close()
        jab.close()
    finally:
        srv.stop()


# ------------------------------------------ supervision and the replica

@pytest.mark.timeout(60)
def test_process_monitor_respawns_a_killed_worker():
    w = WorkerProcess([sys.executable, "-c", "import time; time.sleep(60)"],
                      dict(os.environ), "sleeper")
    mon = ProcessMonitor([w], max_restarts=2, poll_interval=0.05).start()
    try:
        first = w.proc.pid
        os.kill(first, signal.SIGKILL)
        end = time.monotonic() + 20
        while (w.restarts < 1 or w.proc.pid == first) and \
                time.monotonic() < end:
            time.sleep(0.05)
        assert w.restarts == 1 and w.proc.pid != first
        assert mon.alive() == ["sleeper"]
    finally:
        mon.stop()
    assert mon.alive() == []


def test_replica_group_and_specs_refuse_what_waits():
    """Both packages' ReplicaGroup on the same specs: predict specs and
    the batcher's settings reach the replica command line, an unstarted
    group probes as all down, a group off the registry has no lifecycle
    API; roles other than mixed (A.5) still refuse in the port."""
    with pytest.raises(ValueError, match="llm spec"):
        port_ha.resolve_model_spec("llama:tiny")
    for pkg in (port_ha, jax_ha):
        g = pkg.ReplicaGroup("synthetic:double", num_replicas=1,
                             batch_size=32, max_wait_ms=1.0)
        cmd = g._monitor.workers[0].cmd
        for flag, value in (("--batch-size", "32"),
                            ("--max-wait-ms", "1.0"),
                            ("--metrics-port", str(g.metrics_ports[0]))):
            assert cmd[cmd.index(flag) + 1] == value
    with pytest.raises(NotImplementedError, match="A.5"):
        port_ha.ReplicaGroup("llama:tiny", num_replicas=2,
                             roles=["prefill", "decode"])
    g = port_ha.ReplicaGroup("llama:tiny", num_replicas=2, device="cpu")
    ref = jax_ha.ReplicaGroup("llama:tiny", num_replicas=2)
    assert "--device" in g._monitor.workers[0].cmd
    assert g.healthz(timeout=0.5) == ref.healthz(timeout=0.5) == \
        [None, None]
    for group in (g, ref):
        with pytest.raises(RuntimeError, match="model registry"):
            group.rolling_update("v2")
    with pytest.raises(ValueError, match="A.5"):
        LLMEngine(PagedLlamaModel(LlamaConfig(**ARCH), device="cpu",
                                  **SHAPE), role="prefill")


@pytest.mark.timeout(120)
@pytest.mark.parametrize("args,needle", [
    ([], "no CUDA device"),
    (["--metrics-port", "BUSY"], "Address already in use"),
    (["--batch-size", "eight"], "invalid int value"),
], ids=["no-device-no-card", "metrics-port", "batch-size"])
def test_replica_entry_refuses_loudly(args, needle):
    """Boots that cannot serve fail loudly, as the JAX replica's do on
    the same arguments: a metrics port already taken, a batch size that
    is not a number (and, in the port, no card without ``--device``)."""
    if args == [] and __import__("torch").cuda.is_available():
        pytest.skip("a card is present: --device unset serves on it")
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    args = [str(busy.getsockname()[1]) if a == "BUSY" else a
            for a in args]
    if "--metrics-port" not in args:
        args = args + ["--metrics-port", "-1"]
    try:
        entries = [("zoo_tpu_torch",
                    [] if needle == "no CUDA device" else
                    ["--device", "cpu"])]
        if needle != "no CUDA device":
            entries.append(("zoo_tpu", []))
        for pkg, extra in entries:
            cmd = [sys.executable, "-m", f"{pkg}.serving.replica",
                   "--model", "synthetic:double"] + extra + args
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                               text=True, timeout=100)
            assert r.returncode != 0 and needle in r.stderr, \
                (pkg, r.stderr[-2000:])
            assert "REPLICA READY" not in r.stdout
    finally:
        busy.close()


@pytest.mark.timeout(120)
def test_replica_serves_predict_with_its_exporter():
    """``--metrics-port 0 --batch-size 4``: the replica reports its
    metrics port, answers predict through the batcher and its
    ``/healthz`` and ``/metrics`` doors, as the JAX replica does."""
    import json
    import urllib.request

    from zoo_tpu_torch.obs.exporters import validate_prometheus_text
    from zoo_tpu_torch.serving.tcp_client import TCPInputQueue

    proc = subprocess.Popen(
        [sys.executable, "-m", "zoo_tpu_torch.serving.replica",
         "--model", "synthetic:double", "--device", "cpu",
         "--metrics-port", "0", "--batch-size", "4",
         "--max-wait-ms", "1"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().split()
        assert line[:2] == ["REPLICA", "READY"], line
        host, port = line[2].rsplit(":", 1)
        mport = int(line[3].split("=")[1])
        q = TCPInputQueue(host, int(port))
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_array_equal(q.predict(x), 2 * x)
        assert q.stats()["inference"]["count"] == 1
        q.close()
        base = f"http://{host}:{mport}"
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            assert json.loads(r.read())["ok"] is True
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            text = r.read().decode()
        assert not validate_prometheus_text(text)
        assert 'zoo_serving_requests_total{outcome="ok"} 1' in text
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_replica_refuses_to_serve_without_its_kernels(monkeypatch,
                                                     tmp_path):
    """A CUDA replica whose kernel libraries are missing and cannot be
    built fails at boot instead of serving."""
    import torch
    from zoo_tpu_torch.ops.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_results", {})
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="refusing to serve"):
        port_replica.load_serving_kernels(torch.device("cuda"))
    port_replica.load_serving_kernels(torch.device("cpu"))   # no-op


# ---------------------------------------------------- the script copies

def _script(name, marker_ok):
    r = subprocess.run(
        [sys.executable, "-m", f"zoo_tpu_torch.scripts.{name}",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert marker_ok in r.stdout


@pytest.mark.chaos
@pytest.mark.timeout(320)
def test_check_llm_serving_copy_runs_on_cpu():
    _script("check_llm_serving", "LLM SERVING OK")


@pytest.mark.perf
@pytest.mark.timeout(320)
def test_check_spec_decode_copy_runs_on_cpu():
    _script("check_spec_decode", "SPEC DECODE OK")


@pytest.mark.perf
@pytest.mark.timeout(320)
def test_check_prefix_cache_copy_runs_on_cpu():
    _script("check_prefix_cache", "PREFIX CACHE OK")


@pytest.mark.chaos
@pytest.mark.timeout(180)
def test_check_serving_ha_copy_runs_on_cpu():
    """The 3-replica SIGKILL smoke of the predict door
    (``scripts/check_serving_ha.py``'s copy), under its JAX original's
    marker and time limit."""
    _script("check_serving_ha", "SERVING HA OK")

