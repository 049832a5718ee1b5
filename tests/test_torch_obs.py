"""The port's observability against the JAX package's, on the same
inputs: trace spans and events (the JSONL records equal apart from ts,
pid and host), the timeline merger and its CLI copy, the flight ring
(bounds, spill, bundle keys, the breaker / retry / ejection feeds, the
crash handler), the SLO watchdog (the same verdicts, gauges and edge
events on the same series and fake clock; the env rules and
``/healthz``), the telemetry catalog (every family and event kind the
port creates is declared with JAX's labels), the cluster merge (and the
c10d store across two gloo processes), the engine's per-stream spans
and ring records on the tiny Llama, ``synthllm`` streams, the predict
door's quant-path gauge, a trace id crossing the packages on the wire,
the postmortem harvest of a dead CPU replica, and the
``check_trace_e2e`` copy as a subprocess.
"""

import json
import os
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import zoo_tpu.obs as jax_obs
from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.obs import aggregate as jax_aggregate
from zoo_tpu.obs import catalog as jax_catalog
from zoo_tpu.obs import flight as jax_flight
from zoo_tpu.obs import metrics as jax_metrics
from zoo_tpu.obs import slo as jax_slo
from zoo_tpu.obs import timeline as jax_timeline
from zoo_tpu.obs import tracing as jax_tracing
from zoo_tpu.serving import ejection as jax_ejection
from zoo_tpu.serving import ha_client as jax_ha_client
from zoo_tpu.serving import server as jax_server
from zoo_tpu.serving.llm import spec as jax_spec
from zoo_tpu.serving.llm import synthetic as jax_synthetic
from zoo_tpu.serving.llm.engine import LLMEngine as JaxEngine
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel
from zoo_tpu.util import resilience as jax_resilience

import zoo_tpu_torch.obs as port_obs
from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.obs import aggregate as port_aggregate
from zoo_tpu_torch.obs import catalog as port_catalog
from zoo_tpu_torch.obs import flight as port_flight
from zoo_tpu_torch.obs import metrics as port_metrics
from zoo_tpu_torch.obs import slo as port_slo
from zoo_tpu_torch.obs import timeline as port_timeline
from zoo_tpu_torch.obs import tracing as port_tracing
from zoo_tpu_torch.serving import ejection as port_ejection
from zoo_tpu_torch.serving import ha_client as port_ha_client
from zoo_tpu_torch.serving import server as port_server
from zoo_tpu_torch.serving.llm import spec as port_spec
from zoo_tpu_torch.serving.llm import synthetic as port_synthetic
from zoo_tpu_torch.serving.llm.engine import LLMEngine
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel
from zoo_tpu_torch.util import resilience as port_resilience

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

pytestmark = pytest.mark.obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {
    "jax": types.SimpleNamespace(
        obs=jax_obs, tracing=jax_tracing, flight=jax_flight, slo=jax_slo,
        timeline=jax_timeline, metrics=jax_metrics,
        aggregate=jax_aggregate, resilience=jax_resilience,
        ejection=jax_ejection, server=jax_server, spec=jax_spec,
        synthetic=jax_synthetic, ha_client=jax_ha_client),
    "port": types.SimpleNamespace(
        obs=port_obs, tracing=port_tracing, flight=port_flight,
        slo=port_slo, timeline=port_timeline, metrics=port_metrics,
        aggregate=port_aggregate, resilience=port_resilience,
        ejection=port_ejection, server=port_server, spec=port_spec,
        synthetic=port_synthetic, ha_client=port_ha_client),
}
ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)


@pytest.fixture()
def fresh_flight(tmp_path, monkeypatch):
    """Both packages' recorders at capacity 8, spilling into tmp."""
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "8")
    recs = {}
    for name, P in PKG.items():
        monkeypatch.setenv("ZOO_OBS_POSTMORTEM_DIR",
                           str(tmp_path / f"pm-{name}"))
        P.flight.reset_for_tests()
        recs[name] = P.flight.flight_recorder()
    yield recs
    for P in PKG.values():
        P.flight.reset_for_tests()


def _no_ts(events, drop=("ts",)):
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


# ------------------------------------------------------------- tracing

def _trace_scenario(P, d):
    """The same calls on either package; returns its normalised JSONL
    records and the context reads."""
    P.tracing.trace_to(d)
    reads = []
    try:
        reads.append((P.tracing.ambient_trace_id(),
                      P.tracing.current_span_id()))
        with P.tracing.span("outer", step=3) as s_outer:
            reads.append(P.tracing.current_span_id() == s_outer)
            with P.tracing.span("inner"):
                P.tracing.emit_event("tick", k=2)
        with P.tracing.trace_context("req" * 8, parent_span="remote"):
            reads.append(P.tracing.ambient_trace_id())
            with P.tracing.span("handler", rid="x") as s_h:
                P.tracing.emit_span("engine.work", 1.5, 0.25,
                                    trace="other" * 4, parent=s_h,
                                    ok=False, tokens=7)
                P.tracing.emit_event("admit")
            reads.append(len(P.tracing.active_spans()))
        with pytest.raises(ValueError):
            with P.tracing.span("fails"):
                raise ValueError("boom")
        with P.tracing.trace_context(None):
            reads.append(P.tracing.ambient_trace_id())
        proc = P.tracing.current_trace_id()
        path = P.tracing.trace_file_path()
    finally:
        P.tracing.stop_tracing()
    assert os.path.basename(path).startswith("trace-")
    events = P.tracing.read_trace(d)
    ids = {}

    def norm_id(v):
        if v is None:
            return None
        return ids.setdefault(v, f"s{len(ids)}")

    out = []
    for e in events:
        e = dict(e)
        assert e.pop("pid", os.getpid()) == os.getpid()
        e.pop("ts")
        if "dur_s" in e and e["ev"] == "E":
            assert e.pop("dur_s") >= 0
        if e.get("trace") == proc:
            e["trace"] = "<process>"
        for k in ("span", "parent"):
            if k in e:
                e[k] = norm_id(e[k]) if e[k] != "remote" else "remote"
        out.append(e)
    return out, reads


def test_trace_records_equal_jax(tmp_path):
    got, got_reads = _trace_scenario(PKG["port"], str(tmp_path / "p"))
    ref, ref_reads = _trace_scenario(PKG["jax"], str(tmp_path / "j"))
    assert got == ref
    assert got_reads == ref_reads == [(None, None), True, "req" * 8, 0,
                                      None]
    names = [e["name"] for e in got]
    assert "engine.work" in names and "fails" in names


def test_disabled_span_is_one_check_and_a_no_op(tmp_path):
    port_tracing.stop_tracing()
    assert not port_tracing.tracing_enabled()
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with port_tracing.span("hot", i=1):
            pass
    per_ns = (time.perf_counter() - t0) / n * 1e9
    assert port_tracing.emit_event("x") is None
    assert port_tracing.emit_span("x", 0.0, 0.0) is None
    assert port_tracing.active_spans() == []
    # the bench's ceiling for a disabled span (bench_obs_trace)
    assert per_ns < 100_000, per_ns


def test_iter_jsonl_skips_torn_lines_like_jax(tmp_path):
    p = tmp_path / "t.jsonl"
    with open(p, "wb") as f:
        f.write(b'{"a": 1}\n\n{"b": [1, 2]}\n{"torn": \n[1, 2]\n')
        f.write(b'{"c": "\xff\xfe"}\n{"d": 4}\n{"e": 5')
    assert list(port_tracing.iter_jsonl(str(p))) == \
        list(jax_tracing.iter_jsonl(str(p)))
    assert list(port_tracing.iter_jsonl(str(tmp_path / "none"))) == []


# ------------------------------------------------------------ timeline

def _fleet_files(d):
    """Three process files of one request (a client, a replica that
    finished, one killed mid-span with a torn tail) plus noise."""
    os.makedirs(d, exist_ok=True)
    tid = "ab" * 16
    files = {
        "trace-h-1.jsonl": [
            {"ev": "X", "name": "client.generate", "trace": tid,
             "span": "root", "ts": 1.0, "dur_s": 5.0, "ok": True,
             "pid": 1, "attrs": {"attempts": 2}},
            {"ev": "X", "name": "client.attempt", "trace": tid,
             "span": "a0", "parent": "root", "ts": 1.01, "dur_s": 1.0,
             "ok": False, "pid": 1},
            {"ev": "X", "name": "client.attempt", "trace": tid,
             "span": "a1", "parent": "root", "ts": 2.1, "dur_s": 3.0,
             "ok": True, "pid": 1},
            {"ev": "B", "name": "unrelated", "trace": "zz" * 16,
             "span": "zz", "ts": 0.5, "pid": 1}],
        "trace-h-2.jsonl": [
            {"ev": "B", "name": "server.generate", "trace": tid,
             "span": "g1", "parent": "a0", "pid": 2, "ts": 1.5},
            {"ev": "I", "name": "llm.admit", "trace": tid, "span": "i1",
             "ts": 1.6, "pid": 2, "attrs": {"prompt_tokens": 9}},
            {"ev": "E", "name": "server.generate", "trace": tid,
             "span": "g1", "ts": 2.0, "dur_s": 0.5, "ok": True}],
        "trace-h-3.jsonl": [
            {"ev": "E", "name": "llm.prefill", "trace": tid,
             "span": "orphan", "ts": 2.2, "dur_s": 0.1, "ok": True,
             "pid": 3},
            {"ev": "B", "name": "server.generate", "trace": tid,
             "span": "g2", "parent": "a1", "pid": 3, "ts": 2.2}],
    }
    for name, evs in files.items():
        with open(os.path.join(d, name), "w") as f:
            for e in evs:
                f.write(json.dumps(e) + "\n")
    with open(os.path.join(d, "trace-h-3.jsonl"), "a") as f:
        f.write('{"ev": "E", "name": "server.gen')   # the kill
    with open(os.path.join(d, "other.txt"), "w") as f:
        f.write("not a trace file\n")
    return tid


def test_timeline_merge_equals_jax(tmp_path):
    d = str(tmp_path / "fleet")
    tid = _fleet_files(d)
    out = {}
    for name, P in PKG.items():
        T = P.timeline
        events = T.load_events(d)
        traces = T.group_traces(events)
        tl = T.build_timeline(traces[tid])
        out[name] = (events, sorted(traces), tl,
                     T.to_chrome_trace(tl, trace_id=tid),
                     T.render_text(tl), T.merge_timeline(d, tid),
                     T.render_text([]), T.load_events(str(tmp_path / "x")))
    assert out["port"] == out["jax"]
    tl = out["port"][2]
    assert any(e["open"] for e in tl)             # the killed span
    assert {e["file"] for e in tl} == {"trace-h-1.jsonl", "trace-h-2.jsonl",
                                       "trace-h-3.jsonl"}


def test_trace_timeline_cli_copy_behaves_like_jax(tmp_path):
    d = str(tmp_path / "fleet")
    tid = _fleet_files(d)
    jax_cli = [sys.executable, os.path.join(ROOT, "scripts",
                                            "trace_timeline.py")]
    port_cli = [sys.executable, "-m", "zoo_tpu_torch.scripts.trace_timeline"]
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}

    def run(cli, *args):
        r = subprocess.run(cli + list(args), cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=60)
        return r.returncode, r.stdout, r.stderr

    for args in ([d, "--list"], [d, "--trace", tid], [d],
                 [d, "--trace", "nope"], [str(tmp_path / "empty")]):
        assert run(port_cli, *args) == run(jax_cli, *args), args
    cp, cj = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    rp = run(port_cli, d, "--trace", tid, "--chrome", cp)
    rj = run(jax_cli, d, "--trace", tid, "--chrome", cj)
    assert rp[0] == rj[0] == 0
    assert json.load(open(cp)) == json.load(open(cj))


# ------------------------------------------------------ flight recorder

def test_flight_ring_spill_and_bundle_equal_jax(fresh_flight):
    out = {}
    for name, rec in fresh_flight.items():
        P = PKG[name]
        assert rec.enabled and rec.capacity == 8
        for i in range(20):
            rec.record("tick", i=i, tag="x")
        spilled = P.flight.read_spill(rec.spill_path)
        with open(rec.spill_path, "ab") as f:
            f.write(b'{"ts": 1, "kind": "to')          # a torn tail
        torn = P.flight.read_spill(rec.spill_path)
        path = rec.dump("unit-test")
        bundle = json.load(open(path))
        live = rec.snapshot_bundle("debug_dump")
        out[name] = (_no_ts(rec.events()), _no_ts(spilled), len(torn),
                     sorted(bundle), bundle["reason"],
                     _no_ts(bundle["ring"]), sorted(live),
                     sorted(bundle["metrics"]),
                     os.path.basename(path).split("-")[0],
                     os.path.basename(rec.spill_path) ==
                     f"flight-{os.getpid()}.jsonl")
    assert out["port"] == out["jax"]
    ring = out["port"][0]
    assert [e["i"] for e in ring] == list(range(12, 20))
    assert [e["i"] for e in out["port"][1]] == list(range(20))


def test_flight_disabled_costs_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "0")
    monkeypatch.setenv("ZOO_OBS_POSTMORTEM_DIR", str(tmp_path / "pm"))
    port_flight.reset_for_tests()
    try:
        rec = port_flight.flight_recorder()
        assert not rec.enabled and rec.spill_path is None
        t0 = time.perf_counter()
        for _ in range(10000):
            rec.record("x", a=1)
        assert (time.perf_counter() - t0) / 10000 < 50e-6
        assert rec.events() == []
        assert not os.path.exists(str(tmp_path / "pm"))
        assert port_flight.install_crash_handlers() is False
    finally:
        port_flight.reset_for_tests()


def test_breaker_retry_and_ejection_feed_the_ring_like_jax(fresh_flight):
    out = {}
    for name, rec in fresh_flight.items():
        P = PKG[name]
        R = P.resilience
        br = R.CircuitBreaker(failure_threshold=1, recovery_timeout=60)
        br.record_failure()
        pol = R.RetryPolicy(max_attempts=2, sleep=lambda s: None)
        with pytest.raises(R.RetryError):
            pol.call(lambda: (_ for _ in ()).throw(ConnectionError("d")))
        br._state = br.HALF_OPEN
        br.record_success()
        clock = [100.0]
        ctl = P.ejection.EjectionController(
            P.ejection.EjectionConfig(enabled=True, min_ms=1.0,
                                      min_samples=2, probation_s=0.1),
            clock=lambda: clock[0])
        seats = [ctl.new_score(f"s{i}") for i in range(3)]
        for _ in range(6):
            for i, s in enumerate(seats):
                s.record(0.2 if i == 0 else 0.01, ctl.cfg.alpha)
            clock[0] += 0.2
            ctl.evaluate(seats)
        out[name] = _no_ts(rec.events())
    assert out["port"] == out["jax"]
    kinds = [e["kind"] for e in out["port"]]
    assert {"breaker_open", "retry_giveup", "breaker_closed"} <= set(kinds)
    assert any(k.startswith("replica_") for k in kinds), kinds


def test_crash_handler_dumps_on_excepthook_like_jax(tmp_path):
    """The unhandled-exception path, end to end in a subprocess of each
    package: the same bundle keys and ring kinds."""
    out = {}
    for name in ("jax", "port"):
        pm = str(tmp_path / f"pm-{name}")
        mod = "zoo_tpu" if name == "jax" else "zoo_tpu_torch"
        code = (
            "import os\n"
            f"os.environ['ZOO_OBS_POSTMORTEM_DIR'] = r'{pm}'\n"
            f"from {mod}.obs.flight import install_crash_handlers, "
            "record_event\n"
            "assert install_crash_handlers()\n"
            "record_event('about_to_die', step=7)\n"
            "raise RuntimeError('boom')\n")
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": ROOT},
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0 and "boom" in proc.stderr
        bundles = [f for f in os.listdir(pm) if f.startswith("postmortem-")]
        assert len(bundles) == 1, os.listdir(pm)
        bundle = json.load(open(os.path.join(pm, bundles[0])))
        spill = [f for f in os.listdir(pm) if f.startswith("flight-")]
        out[name] = (sorted(bundle), bundle["reason"],
                     [e["kind"] for e in bundle["ring"]], len(spill))
    assert out["port"] == out["jax"]
    assert out["port"][2] == ["about_to_die", "unhandled_exception"]


def test_sigterm_handler_dumps_then_chains_the_previous_one(tmp_path):
    pm = str(tmp_path / "pm")
    code = (
        "import os, signal, sys\n"
        f"os.environ['ZOO_OBS_POSTMORTEM_DIR'] = r'{pm}'\n"
        "from zoo_tpu_torch.obs.flight import install_crash_handlers\n"
        "signal.signal(signal.SIGTERM, lambda s, f: sys.exit(42))\n"
        "assert install_crash_handlers()\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 42, proc.stderr
    bundle = [f for f in os.listdir(pm) if f.startswith("postmortem-")]
    assert json.load(open(os.path.join(pm, bundle[0])))["reason"] == \
        "signal-15"


# --------------------------------------------------------- SLO watchdog

class _FakeTime:
    def __init__(self):
        self.t = 5000.0

    def monotonic(self):
        return self.t

    def time(self):
        return self.t


SLO_ENV = {"ZOO_SLO_TTFT_P99_S": "0.5", "ZOO_SLO_INTER_TOKEN_P99_S": "0.05",
           "ZOO_SLO_ERROR_RATE": "0.2", "ZOO_SLO_SHED_RATE": "0.1",
           "ZOO_SLO_KV_UTIL": "0.9", "ZOO_SLO_SPEC_ACCEPT_FLOOR": "0.4",
           "ZOO_SLO_TENANT_SHED_RATE": "0.25"}


def _slo_run(P, monkeypatch):
    """The same series, clock and env on one package's watchdog: the
    verdicts, published gauges and edge events of every pass."""
    clock = _FakeTime()
    monkeypatch.setattr(P.slo, "time", clock)
    reg = P.metrics.MetricsRegistry()
    ttft = reg.histogram("zoo_llm_ttft_seconds", "x")
    gap = reg.histogram("zoo_llm_inter_token_seconds", "x")
    req = reg.counter("zoo_serving_requests_total", "x",
                      labels=("outcome",))
    streams = reg.counter("zoo_llm_streams_total", "x", labels=("outcome",))
    shed = reg.counter("zoo_serve_shed_total", "x", labels=("reason",))
    used = reg.gauge("zoo_llm_kv_blocks_used", "x")
    free = reg.gauge("zoo_llm_kv_blocks_free", "x")
    prop = reg.counter("zoo_llm_spec_proposed_tokens_total", "x")
    acc = reg.counter("zoo_llm_spec_accepted_tokens_total", "x")
    t_shed = reg.counter("zoo_tenant_shed_total", "x",
                         labels=("tenant", "reason"))
    t_adm = reg.counter("zoo_tenant_admitted_total", "x",
                        labels=("tenant",))
    w = P.slo.SLOWatchdog(registry=reg, window_s=10.0, interval_s=1.0)
    rs = np.random.RandomState(3)
    steps = []
    for step in range(12):
        hot = 3 <= step <= 6
        for _ in range(20):
            ttft.observe(float(rs.uniform(0.6, 2.0) if hot
                               else rs.uniform(0.01, 0.2)))
            gap.observe(float(rs.uniform(0.001, 0.03)))
        req.labels(outcome="ok").inc(10)
        req.labels(outcome="error").inc(10 if hot else 0)
        streams.labels(outcome="ok").inc(3)
        shed.labels(reason="queue_full").inc(2 if step % 4 == 0 else 0)
        used.set(100 if hot else 20)
        free.set(10 if hot else 90)
        prop.inc(10)
        acc.inc(2 if hot else 8)
        t_adm.labels(tenant="greedy").inc(4)
        t_shed.labels(tenant="greedy", reason="rate").inc(
            6 if hot else 0)
        t_adm.labels(tenant="victim").inc(3)
        clock.t += 1.0 + step % 3
        st = w.evaluate()
        st = dict(st)
        st.pop("ts")
        gauges = sorted(
            (g["name"], tuple(sorted(g["labels"].items())), g["value"])
            for g in P.metrics.get_registry().snapshot()["gauges"]
            if g["name"] in ("zoo_slo_burn_rate", "zoo_slo_breach",
                             "zoo_slo_rules_armed", "zoo_tenant_burn_rate"))
        steps.append((st, gauges))
    return (steps, _no_ts(P.flight.flight_recorder().events()),
            P.slo.last_status()["ok"])


def test_slo_verdicts_gauges_and_events_equal_jax(monkeypatch):
    for k, v in SLO_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "512")
    monkeypatch.delenv("ZOO_OBS_POSTMORTEM_DIR", raising=False)
    out = {}
    for name, P in PKG.items():
        P.flight.reset_for_tests()
        try:
            out[name] = _slo_run(P, monkeypatch)
        finally:
            P.slo._set_status(None)
            P.flight.reset_for_tests()
    assert out["port"] == out["jax"]
    steps, events, _ = out["port"]
    breached = {b for st, _ in steps for b in st["breaches"]}
    assert {"ttft_p99", "error_rate", "kv_util", "spec_accept",
            "tenant_shed_rate[greedy]"} <= breached, breached
    kinds = [e["kind"] for e in events]
    assert "slo_breach" in kinds and "slo_clear" in kinds


def test_slo_quantile_and_floor_rules_equal_jax():
    cases = [([0.1, 1.0], [0, 0, 0], 0.99), ([0.1, 1.0], [98, 1, 1], 0.5),
             ([0.1, 1.0], [0, 0, 5], 0.99), ([0.1, 0.2, 0.4], [1, 1, 1, 1],
                                            0.7)]
    for c in cases:
        assert port_slo.quantile_from_counts(*c) == \
            jax_slo.quantile_from_counts(*c)
    for fn, obj, floor in ((lambda d, l: 0.2, 0.4, True),
                           (lambda d, l: 0.0, 0.4, True),
                           (lambda d, l: 0.3, 0.1, False),
                           (lambda d, l: None, 0.1, False)):
        assert port_slo.SLORule("r", fn, obj, floor).evaluate({}, {}) == \
            jax_slo.SLORule("r", fn, obj, floor).evaluate({}, {})


def test_slo_env_rules_and_healthz_like_jax(monkeypatch):
    monkeypatch.setenv("ZOO_SLO_ERROR_RATE", "0.25")
    monkeypatch.setenv("ZOO_SLO_TTFT_P99_S", "0.5")
    monkeypatch.delenv("ZOO_HEARTBEAT_FILE", raising=False)
    monkeypatch.delenv("ZOO_SLO_FAIL_HEALTHZ", raising=False)
    assert [(r.name, r.objective, r.floor)
            for r in port_slo.default_rules()] == \
        [(r.name, r.objective, r.floor) for r in jax_slo.default_rules()]
    verdict = {"ok": False, "breaches": ["error_rate"], "rules": {}}
    bodies = {}
    for name, P in PKG.items():
        P.slo._set_status(verdict)
        ex = P.obs.MetricsExporter(
            registry=P.metrics.MetricsRegistry()).start()
        try:
            with urllib.request.urlopen(ex.url + "/healthz",
                                        timeout=10) as resp:
                body = json.loads(resp.read().decode())
            monkeypatch.setenv("ZOO_SLO_FAIL_HEALTHZ", "1")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(ex.url + "/healthz", timeout=10)
            monkeypatch.delenv("ZOO_SLO_FAIL_HEALTHZ")
            bodies[name] = (body, ei.value.code)
        finally:
            ex.stop()
            P.slo._set_status(None)
    assert bodies["port"] == bodies["jax"]
    assert bodies["port"][0]["slo"] == verdict and \
        bodies["port"][0]["ok"] is True and bodies["port"][1] == 503


def test_watchdog_thread_starts_only_with_an_objective(monkeypatch):
    for k in SLO_ENV:
        monkeypatch.delenv(k, raising=False)
    assert port_slo.SLOWatchdog().start()._thread is None
    monkeypatch.setenv("ZOO_SLO_ERROR_RATE", "0.5")
    w = port_slo.SLOWatchdog(interval_s=0.05).start()
    try:
        assert w._thread is not None
        deadline = time.monotonic() + 10
        while port_slo.last_status() is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert "error_rate" in port_slo.last_status()["rules"]
    finally:
        w.stop()
        port_slo._set_status(None)


# ----------------------------------------------------------- catalog

def test_catalog_is_the_jax_catalog():
    assert port_catalog.METRICS == jax_catalog.METRICS
    assert port_catalog.EVENT_KINDS == jax_catalog.EVENT_KINDS
    assert port_obs.__all__ == jax_obs.__all__


def _port_sources():
    pkg = os.path.join(ROOT, "zoo_tpu_torch")
    for dp, dns, fns in os.walk(pkg):
        dns[:] = [d for d in dns if d != "__pycache__"]
        for fn in sorted(fns):
            if fn.endswith(".py"):
                yield os.path.relpath(os.path.join(dp, fn), ROOT)


def test_every_family_and_event_kind_of_the_port_is_declared():
    """The port's stand-in for zoo-lint's telemetry pass: every
    ``counter``/``gauge``/``histogram`` creation site with a literal
    ``zoo_*`` name, and every literal ``record_event`` kind, against the
    catalog (names, kinds and label names as JAX declares them)."""
    import ast

    ctors = ("counter", "gauge", "histogram")
    created, emitted, bad = set(), set(), []
    for rel in _port_sources():
        tree = ast.parse(open(os.path.join(ROOT, rel)).read(), rel)
        aliases = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.endswith("obs.metrics"):
                for a in node.names:
                    if a.name in ctors:
                        aliases[a.asname or a.name] = a.name
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            f = node.func
            fname = f.id if isinstance(f, ast.Name) else \
                f.attr if isinstance(f, ast.Attribute) else None
            arg = node.args[0]
            kind = fname if fname in ctors else aliases.get(fname)
            if kind and isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) and \
                    arg.value.startswith("zoo_"):
                labels = ()
                for kw in node.keywords:
                    if kw.arg == "labels":
                        labels = tuple(e.value for e in kw.value.elts)
                decl = port_catalog.METRICS.get(arg.value)
                created.add(arg.value)
                if decl != (kind, labels):
                    bad.append(f"{rel}:{node.lineno} {arg.value} "
                               f"{kind}{labels} declared {decl}")
            if fname == "record_event":
                vals = [arg] if not isinstance(arg, ast.IfExp) else \
                    [arg.body, arg.orelse]
                for v in vals:
                    if isinstance(v, ast.Constant):
                        emitted.add(v.value)
                        if v.value not in port_catalog.EVENT_KINDS:
                            bad.append(f"{rel}:{node.lineno} event "
                                       f"{v.value!r} undeclared")
    assert not bad, "\n".join(bad)
    # what this slice ported is created and emitted in the port
    assert {"zoo_llm_ttft_seconds", "zoo_llm_inter_token_seconds",
            "zoo_slo_burn_rate", "zoo_tenant_burn_rate",
            "zoo_flight_events_total", "zoo_llm_kv_blocks_cached",
            "zoo_quant_path_info"} <= created
    assert {"replica_boot", "shed", "tenant_shed", "drain", "engine_tick",
            "llm_preempt", "llm_stream_end", "corrupt_request_dropped",
            "chaos_arm", "chaos_clear", "kv_migrate_out", "kv_migrate_in",
            "kv_handoff_abort", "slo_breach", "slo_clear"} <= emitted


# ------------------------------------------------------- cluster view

def test_merge_snapshots_and_single_process_aggregate_equal_jax():
    snaps = []
    for i in range(3):
        r = port_metrics.MetricsRegistry()
        r.counter("zoo_c", "x", labels=("k",)).labels(k="a").inc(i + 1)
        r.gauge("zoo_g", "x").set(10 * i)
        h = r.histogram("zoo_h", "x")
        for v in (0.001 * (i + 1), 0.3, 2.0):
            h.observe(v)
        snaps.append(r.snapshot())
    assert port_aggregate.merge_snapshots(snaps) == \
        jax_aggregate.merge_snapshots(snaps)
    reg = port_metrics.MetricsRegistry()
    reg.counter("zoo_x", "x").inc(3)
    view = port_aggregate.aggregate_cluster(reg)
    assert view == jax_aggregate.merge_snapshots([reg.snapshot()])
    assert port_aggregate.last_cluster_view() is view
    ex = port_obs.MetricsExporter(registry=reg).start()
    try:
        with urllib.request.urlopen(ex.url + "/cluster", timeout=10) as r:
            assert json.loads(r.read().decode()) == view
        ex.set_cluster_view({"processes": 9})
        with urllib.request.urlopen(ex.url + "/cluster", timeout=10) as r:
            assert json.loads(r.read().decode()) == {"processes": 9}
    finally:
        ex.stop()


def test_snapshot_thread_appends_lines(tmp_path):
    reg = port_metrics.MetricsRegistry()
    reg.counter("zoo_x", "x").inc(2)
    path = str(tmp_path / "snap.jsonl")
    t = port_obs.start_snapshot_thread(path, interval=0.05, registry=reg)
    assert t.daemon
    deadline = time.monotonic() + 10
    while len(list(port_tracing.iter_jsonl(path))) < 2:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    rec = next(port_tracing.iter_jsonl(path))
    assert rec["metrics"]["counters"][0]["value"] == 2.0


_GLOO = r"""
import os, sys, json
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[2],
                        world_size=2, rank=rank)
from zoo_tpu_torch.obs import aggregate, metrics, tracing
tracing.set_trace_id("rank-%d" % rank)
tid = tracing.share_trace_id(timeout_s=30)
reg = metrics.MetricsRegistry()
reg.counter("zoo_c", "x").inc(rank + 1)
reg.gauge("zoo_g", "x").set(5 * rank)
view = aggregate.aggregate_cluster(reg, timeout_s=30)
print(json.dumps({"tid": tid, "view": view}))
dist.barrier()
dist.destroy_process_group()
"""


def test_share_trace_id_and_aggregate_over_the_c10d_store(tmp_path):
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = str(tmp_path / "gloo.py")
    open(script, "w").write(_GLOO)
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, script, str(r), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        o, e = p.communicate(timeout=100)
        assert p.returncode == 0, e[-3000:]
        outs.append(json.loads(o.strip().splitlines()[-1]))
    assert outs[0]["tid"] == outs[1]["tid"] == "rank-0"
    assert outs[0]["view"] == outs[1]["view"]
    view = outs[0]["view"]
    assert view["processes"] == 2
    assert view["counters"] == [{"name": "zoo_c", "labels": {},
                                 "value": 3.0}]
    assert view["gauges"] == [{"name": "zoo_g", "labels": {}, "max": 5.0,
                               "min": 0.0}]


# ------------------------------------------------------------- engine

def _drain(handles, budget=120.0):
    end = time.monotonic() + budget
    for h in handles:
        while not h.done:
            assert time.monotonic() < end, "streams did not finish"
            h.wait_new(len(h.tokens), 0.5)


def _traced_engine_run(P, engine, prompts, n, d):
    """Streams of one engine under tracing and a fresh ring: per trace
    id the span/event names with their deterministic attributes, and
    the per-stream ring records. Every prompt is queued before the
    engine's loop starts, so the first tick admits them all in both
    packages (submitted to a running loop, a prompt landed in the first
    or a later tick as the threads were scheduled)."""
    P.flight.reset_for_tests()
    P.tracing.trace_to(d)
    eng = engine
    try:
        hs = [eng.submit(p, n, rid=f"r{i}", trace_id=f"t{i}",
                         parent_span="ps") for i, p in enumerate(prompts)]
        eng.start()
        _drain(hs)
        assert [h.trace_id for h in hs] == [f"t{i}"
                                            for i in range(len(hs))]
        toks = [h.tokens for h in hs]
    finally:
        eng.stop()
        P.tracing.stop_tracing()
    keep = {"llm.admit": ("prompt_tokens", "cache_hit_tokens", "cow_fork",
                          "resumed", "rid", "tenant"),
            "llm.prefill": ("start", "tokens", "total", "rid"),
            "llm.stream": ("outcome", "tokens", "preempts", "rid"),
            "llm.preempt": ("generated", "reason", "rid"),
            "llm.first_token": ("rid",)}
    per = {}
    for e in P.tracing.read_trace(d):
        attrs = e.get("attrs") or {}
        per.setdefault(e["trace"], []).append(
            (e["ev"], e["name"], e.get("parent"),
             tuple((k, attrs.get(k)) for k in keep.get(e["name"], ()))))
    ring = sorted((e for e in _no_ts(P.flight.flight_recorder().events())
                   if e["kind"] in ("llm_stream_end", "llm_preempt")),
                  key=lambda e: (e["rid"], e["kind"], e.get("generated",
                                                            0)))
    P.flight.reset_for_tests()
    return toks, {k: sorted(v) for k, v in per.items()}, ring


@pytest.mark.parametrize("case", ["bucket", "preempt"])
def test_engine_spans_and_ring_per_stream_equal_jax(tmp_path, case,
                                                    monkeypatch):
    monkeypatch.setenv("ZOO_OBS_FLIGHT_CAP", "512")
    monkeypatch.delenv("ZOO_OBS_POSTMORTEM_DIR", raising=False)
    if case == "bucket":
        shape = dict(num_slots=2, block_size=4, num_blocks=24,
                     max_blocks_per_seq=6, prefill_buckets=(8, 16))
        rs = np.random.RandomState(11)
        prompts = [rs.randint(0, ARCH["vocab"], (n,)) for n in (3, 9, 14)]
        n = 6
    else:
        shape = dict(num_slots=2, block_size=4, num_blocks=8,
                     max_blocks_per_seq=8, prefill_buckets=(8, 32))
        prompts = [np.arange(2, 8) % 64, np.arange(3, 9) % 64]
        n = 14
    # the preempt case ticks in step (``overlap=False``): under the
    # overlapped loop the readback thread applies tick N's tokens while
    # tick N+1 is scheduled, so how many tokens a stream holds when the
    # pool runs dry, and so which stream is preempted at which count,
    # follows the threads' timing in either package
    overlap = None if case == "bucket" else False
    jm = JaxModel(JaxConfig(**ARCH), seed=0, **shape)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    pm = PagedLlamaModel(LlamaConfig(**ARCH),
                         params=params_from_jax(tree, "cpu"), device="cpu",
                         **shape)
    ref = _traced_engine_run(PKG["jax"], JaxEngine(jm, overlap=overlap),
                             prompts, n, str(tmp_path / "j"))
    got = _traced_engine_run(PKG["port"], LLMEngine(pm, overlap=overlap),
                             prompts, n, str(tmp_path / "p"))
    assert got == ref
    names = {x[1] for evs in got[1].values() for x in evs}
    assert {"llm.admit", "llm.first_token", "llm.stream",
            "llm.prefill"} <= names
    if case == "preempt":
        assert "llm.preempt" in names
        assert any(e["kind"] == "llm_preempt" for e in got[2])


def test_engine_publishes_the_jax_families(monkeypatch):
    """The zoo_llm_* gauges and histograms move on a port engine's run:
    ttft once per stream, kv pool gauges back to an empty pool."""
    reg = port_metrics.get_registry()

    def hist_count(name):
        return sum(h["count"] for h in reg.snapshot()["histograms"]
                   if h["name"] == name)

    def gauge(name):
        return [g["value"] for g in reg.snapshot()["gauges"]
                if g["name"] == name]

    t0 = hist_count("zoo_llm_ttft_seconds")
    eng = port_spec.build_llm_engine("synthllm:slots=2,block=4,blocks=32",
                                     start=True)
    try:
        hs = [eng.submit([1, 2, 3], 5, rid=f"g{i}") for i in range(3)]
        _drain(hs)
    finally:
        eng.stop()
    assert hist_count("zoo_llm_ttft_seconds") - t0 == 3
    assert gauge("zoo_llm_kv_blocks_used") == [0.0]
    assert gauge("zoo_llm_slot_occupancy") == [0.0]


def test_synthllm_streams_equal_jax():
    spec = "synthllm:slots=2,block=4,blocks=64,tables=8,max_prompt=24"
    rs = np.random.RandomState(4)
    prompts = [[int(t) for t in rs.randint(0, 97, size=int(k))]
               for k in rs.randint(1, 20, size=8)]
    out = {}
    for name, P in PKG.items():
        eng = P.spec.build_llm_engine(spec)
        try:
            hs = [eng.submit(p, 9, rid=f"s{i}",
                             sampling={"temperature": 0.9, "seed": 5}
                             if i % 2 else None)
                  for i, p in enumerate(prompts)]
            _drain(hs)
            out[name] = [h.tokens for h in hs]
        finally:
            eng.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == port_synthetic.reference(prompts[0], 9) == \
        jax_synthetic.reference(prompts[0], 9)
    assert port_spec.is_llm_spec(spec) and jax_spec.is_llm_spec(spec)
    with pytest.raises(ValueError, match="unknown synthllm"):
        port_spec.build_llm_engine("synthllm:bogus=1", start=False)


def test_quant_path_gauge_equals_jax():
    from zoo_tpu.pipeline.inference import inference_model as jim
    from zoo_tpu_torch.pipeline.inference import inference_model as pim
    published = (("int8", None), ("bf16-fallback", 0.7312), ("bf16", None))
    for path, speedup in published:
        jim._publish_quant_path(path, speedup)
        pim._publish_quant_path(path, speedup)
    # the series this test published (another test on the same worker
    # may have published others to one registry only)
    mine = {(("path", p), ("speedup", "-" if v is None else f"{v:.3f}"))
            for p, v in published}

    def series(reg, only=mine):
        return sorted((tuple(sorted(g["labels"].items())), g["value"])
                      for g in reg.snapshot()["gauges"]
                      if g["name"] == "zoo_quant_path_info" and (
                          only is None or
                          tuple(sorted(g["labels"].items())) in only))

    got = series(port_metrics.get_registry())
    assert len(got) == 3
    assert got == series(jax_metrics.get_registry())
    assert [v for _, v in series(port_metrics.get_registry(),
                                 None)].count(1.0) == 1


# --------------------------------------------- trace ids on the wire

@pytest.mark.timeout(120)
@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_one_trace_id_across_the_packages(tmp_path, direction):
    server_pkg, client_pkg = (("port", "jax")
                              if direction.startswith("jax_client")
                              else ("jax", "port"))
    S, C = PKG[server_pkg], PKG[client_pkg]
    spec = "synthllm:slots=2,block=4,blocks=64,tables=8,max_prompt=24"
    eng = S.spec.build_llm_engine(spec)
    srv = S.server.ServingServer(None, port=0, llm_engine=eng).start()
    S.tracing.trace_to(str(tmp_path / "server"))
    C.tracing.trace_to(str(tmp_path / "client"))
    tid = "c0ffee" * 5 + "00"
    try:
        cli = C.ha_client.HAServingClient([(srv.host, srv.port)],
                                          hedge=False)
        toks = list(cli.generate([1, 2, 3], 6, trace_id=tid))
        cli.close()
        # the hop's span is written after its terminal frame went out
        deadline = time.monotonic() + 30
        while not any(e.get("name") == "server.generate" for e in
                      S.tracing.read_trace(str(tmp_path / "server"))):
            assert time.monotonic() < deadline, "no server.generate span"
            time.sleep(0.05)
    finally:
        S.tracing.stop_tracing()
        C.tracing.stop_tracing()
        srv.stop()
    assert toks == port_synthetic.reference([1, 2, 3], 6)
    server_ev = S.tracing.read_trace(str(tmp_path / "server"))
    client_ev = C.tracing.read_trace(str(tmp_path / "client"))
    snames = {e["name"] for e in server_ev if e.get("trace") == tid}
    cnames = {e["name"] for e in client_ev if e.get("trace") == tid}
    assert {"server.generate", "llm.admit", "llm.stream"} <= snames
    assert {"client.generate", "client.attempt"} <= cnames
    # the server span parents under the client's root span
    root = next(e["span"] for e in client_ev
                if e["name"] == "client.generate")
    assert next(e for e in server_ev if e["name"] == "server.generate"
                )["parent"] == root


# -------------------------------------------------- postmortem harvest

def test_a_dead_cpu_replicas_spill_is_harvested(tmp_path):
    """A real replica process (synthetic model, CPU) killed with
    SIGKILL leaves only its flight spill; the harvest packages it into
    a bundle whose ring holds its boot."""
    from zoo_tpu_torch.serving.ha import ReplicaGroup

    log_dir = str(tmp_path / "group")
    group = ReplicaGroup("synthetic:double", num_replicas=1, max_restarts=0,
                         log_dir=log_dir, device="cpu")
    group.start(timeout=120)
    try:
        assert group.harvest_postmortems() == []     # live: nothing
        group.kill_replica(0)
        deadline = time.monotonic() + 30
        bundles = []
        while not bundles:
            assert time.monotonic() < deadline, "nothing harvested"
            bundles = group.harvest_postmortems()
            time.sleep(0.2)
    finally:
        group.stop()
    assert os.path.dirname(bundles[0]) == group.postmortem_dir()
    bundle = json.load(open(bundles[0]))
    assert bundle["reason"] == "harvested" and bundle["replica"] == 0
    kinds = [e["kind"] for e in bundle["ring"]]
    assert kinds[0] == "replica_boot", kinds
    assert group.harvest_postmortems() == []


def test_harvest_packages_a_torn_spill_like_jax(tmp_path):
    from zoo_tpu.serving.ha import ReplicaGroup as JaxGroup
    from zoo_tpu_torch.serving.ha import ReplicaGroup
    out = {}
    for name, G in (("jax", JaxGroup), ("port", ReplicaGroup)):
        log_dir = str(tmp_path / name)
        group = G("synthetic:double", num_replicas=1, log_dir=log_dir)
        fdir = os.path.join(log_dir, "flight", "replica-0")
        os.makedirs(fdir)
        with open(os.path.join(fdir, "flight-99999.jsonl"), "w") as f:
            f.write(json.dumps({"ts": 1.0, "kind": "shed",
                                "reason": "queue_full"}) + "\n")
            f.write(json.dumps({"ts": 2.0, "kind": "engine_tick"}) + "\n")
            f.write('{"ts": 3.0, "kind": "to')
        with open(os.path.join(fdir, "postmortem-h-1-1.json"), "w") as f:
            json.dump({"reason": "signal-15"}, f)
        got = group.harvest_postmortems()
        bundles = {os.path.basename(p): json.load(open(p)) for p in got}
        for b in bundles.values():
            b.pop("ts", None)
        out[name] = (bundles, group.harvest_postmortems(),
                     sorted(os.listdir(fdir)))
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 2


# ------------------------------------------------------ the script copy

@pytest.mark.timeout(320)
def test_check_trace_e2e_copy_runs_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "zoo_tpu_torch.scripts.check_trace_e2e",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "TRACE E2E OK" in r.stdout
