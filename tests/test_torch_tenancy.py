"""The port's multi-tenant QoS against the JAX package's, on the same
inputs: tenant specs, token buckets (under a fake clock), salted prefix
hashes, the weighted-fair / priority-class scheduler over one fake model
on both engines, the allocator's tenant partitions under a random churn,
the HA client's per-tenant backoff, streams of the tiny Llama through a
class preemption (equal to the JAX engine's tokens), the door's tenant
sheds, the per-tenant SLO (``zoo_tenant_burn_rate``, mirroring
``tests/test_tenancy.py::test_slo_*`` and held to the JAX watchdog's
verdict), the ``check_tenancy`` copy and the smoke's tenancy phase on
the CPU.
"""

import importlib.util
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.serving import ha_client as jax_ha_client
from zoo_tpu.serving import server as jax_server
from zoo_tpu.serving import tenancy as jax_tenancy
from zoo_tpu.serving.llm import engine as jax_engine
from zoo_tpu.serving.llm import kv_cache as jax_kv
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.serving import ha_client as port_ha_client
from zoo_tpu_torch.serving import server as port_server
from zoo_tpu_torch.serving import tenancy as port_tenancy
from zoo_tpu_torch.serving import tcp_client as port_tcp
from zoo_tpu_torch.serving.llm import engine as port_engine
from zoo_tpu_torch.serving.llm import kv_cache as port_kv
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel

from test_torch_engine import _FakeModel, _reference
from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jax_tenancy, jax_engine, jax_kv),
        "port": (port_tenancy, port_engine, port_kv)}


@pytest.fixture(autouse=True)
def _clean_registry(monkeypatch):
    """Tenancy off by default in both packages: no env config, and both
    process registries dropped so they re-read the clean environment."""
    for var in ("ZOO_TENANT_CONFIG", "ZOO_QOS", "ZOO_TENANT",
                "ZOO_TENANT_AB_PINS"):
        monkeypatch.delenv(var, raising=False)
    for t, _, _ in PKGS.values():
        t.reset_registry(None)
    yield
    for t, _, _ in PKGS.values():
        t.reset_registry(None)


class _Clock:
    """A monotonic clock that moves only when told to."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for t, _, _ in PKGS.values():
        monkeypatch.setattr(t, "time", c)
    return c


def _fields(cfgs):
    return {n: (c.name, c.weight, c.priority, c.rate, c.burst,
                c.max_kv_blocks, c.max_slots) for n, c in cfgs.items()}


# ----------------------------------------------------------- spec parsing

@pytest.mark.parametrize("spec,kw", [
    ("gold:weight=4,class=0,rate=50,burst=100,kv=64,slots=2;free:rate=5",
     {}),
    ("good:rate=5;:rate=1;bad:nope=3;worse:rate=abc;also_good", {}),
    ("a;b:weight=9", {"default_weight": 2.0, "default_class": 3,
                      "default_rate": 7.0}),
    ("", {}),
    (" x : weight = 0 , slots=-3 ;y:kv=2.7", {}),
], ids=["fields", "malformed", "defaults", "empty", "clamped"])
def test_parse_tenant_spec_equals_jax(spec, kw):
    got = port_tenancy.parse_tenant_spec(spec, **kw)
    assert _fields(got) == _fields(jax_tenancy.parse_tenant_spec(spec, **kw))
    if "gold" in got:
        g, f = got["gold"], got["free"]
        assert (g.weight, g.priority, g.rate, g.burst, g.max_kv_blocks,
                g.max_slots) == (4.0, 0, 50.0, 100.0, 64, 2)
        assert (f.rate, f.weight, f.priority, f.max_kv_blocks,
                f.max_slots) == (5.0, 1.0, 1, 0, 0)
    if "also_good" in got:
        assert set(got) == {"good", "also_good"}


# ----------------------------------------------------------- token bucket

# (seconds to advance the clock, op): "take" = try_acquire, "hint" =
# retry_after_ms
_SCRIPT = [(0.0, "take"), (0.0, "take"), (0.0, "take"), (0.0, "hint"),
           (0.05, "hint"), (0.05, "take"), (0.0, "take"), (0.3, "hint"),
           (0.3, "take"), (0.3, "take"), (0.3, "take"), (5.0, "hint"),
           (0.0, "take"), (0.0, "take"), (0.0, "take"), (0.0, "hint")]


@pytest.mark.parametrize("rate,burst", [(10.0, 2.0), (200.0, 1.0),
                                        (0.5, 0.0), (0.0, 0.0),
                                        (3.0, 7.5)])
def test_token_bucket_equals_jax_under_a_fake_clock(clock, rate, burst):
    out = {}
    for name, (t, _, _) in PKGS.items():
        clock.t = 1000.0
        b = t._TokenBucket(rate, burst)
        seq = []
        for dt, op in _SCRIPT:
            clock.t += dt
            seq.append(b.try_acquire() if op == "take"
                       else b.retry_after_ms())
        out[name] = seq
    assert out["port"] == out["jax"]
    if rate == 10.0:
        # burst 2 spent, ~100 ms to refill one token at 10/s
        assert out["port"][:3] == [True, True, False]
        assert 0 < out["port"][3] <= 200
    if rate == 0.0:
        assert all(x is True or x == 0 for x in out["port"])


def test_token_bucket_refills(clock):
    for t, _, _ in PKGS.values():
        b = t._TokenBucket(rate=200.0, burst=1.0)
        assert b.try_acquire() and not b.try_acquire()
        clock.t += 0.02                      # 200/s -> ~4 tokens, cap 1
        assert b.try_acquire()


# ----------------------------------------------- registry enable / salt

def test_registry_enable_and_inert_equal_jax():
    for t, _, _ in PKGS.values():
        assert t.registry().enabled is False     # clean env singleton
        assert t.TenantRegistry(spec="", qos=True).enabled is False
        assert t.TenantRegistry(spec="a:rate=1", qos=False).enabled is False
        assert t.TenantRegistry(spec="a:rate=1", qos=True).enabled is True
        reg = t.TenantRegistry(spec="", qos=True)
        assert reg.admit("anyone") == (True, 0)
        assert reg.salt("anyone") == b""
        assert reg.config("nobody").name == t.DEFAULT_TENANT


def test_registry_reads_the_environment_like_jax(monkeypatch):
    monkeypatch.setenv("ZOO_TENANT_CONFIG", "gold:class=0;free:rate=3")
    monkeypatch.setenv("ZOO_TENANT_DEFAULT_WEIGHT", "2.5")
    monkeypatch.setenv("ZOO_TENANT_DEFAULT_CLASS", "4")
    monkeypatch.setenv("ZOO_TENANT_DEFAULT_RATE", "9")
    regs = {n: t.TenantRegistry() for n, (t, _, _) in PKGS.items()}
    assert _fields(regs["port"].configs) == _fields(regs["jax"].configs)
    assert _fields({"": regs["port"].config(None)}) == \
        _fields({"": regs["jax"].config(None)})
    monkeypatch.setenv("ZOO_QOS", "0")
    assert not port_tenancy.TenantRegistry().enabled
    assert not jax_tenancy.TenantRegistry().enabled


@pytest.mark.parametrize("tenant", [None, "", "a", "b", "ünï"])
@pytest.mark.parametrize("n", [0, 3, 8, 13])
def test_salted_hash_bytes_equal_jax(tenant, n):
    regs = {name: t.TenantRegistry(spec="a:rate=0;b:rate=0", qos=True)
            for name, (t, _, _) in PKGS.items()}
    tokens = list(range(100, 100 + n))
    got = port_kv.prefix_block_hashes(tokens, 4,
                                      salt=regs["port"].salt(tenant))
    ref = jax_kv.prefix_block_hashes(tokens, 4,
                                     salt=regs["jax"].salt(tenant))
    assert got == ref and len(got) == n // 4
    if not tenant:
        assert got == port_kv.prefix_block_hashes(tokens, 4)
    elif n >= 4:
        assert got != port_kv.prefix_block_hashes(tokens, 4)


def test_retry_hint_is_per_tenant(clock):
    """A shed of tenant A is hinted from A's OWN bucket; B's hint stays
    its own clock — both packages, the same numbers."""
    out = {}
    for name, (t, _, _) in PKGS.items():
        clock.t = 1000.0
        reg = t.TenantRegistry(
            spec="greedy:rate=0.001,burst=1;victim:rate=1000", qos=True)
        out[name] = [reg.admit("greedy"), reg.admit("greedy"),
                     reg.admit("victim"),
                     reg.bucket("victim").retry_after_ms()]
    assert out["port"] == out["jax"]
    (ok1, h1), (ok2, h2), (ok3, h3), vh = out["port"]
    assert ok1 and h1 == 0 and not ok2 and h2 > 100_000
    assert ok3 and h3 == 0 and vh == 1


# --------------------------------------------------- fake engine harness

def _tick(eng):
    eng._sweep()
    eng._admit()
    eng._prefill_tick()
    eng._grow_or_preempt()
    eng._decode_tick()


def _run_to_completion(eng, handles, ticks=400):
    for _ in range(ticks):
        _tick(eng)
        if all(h.done for h in handles):
            return
    raise AssertionError(
        [(h.outcome, h.error, list(h.tokens)) for h in handles])


def _model(**kw):
    shape = dict(num_slots=2, block_size=4, num_blocks=32,
                 max_blocks_per_seq=8, max_prompt_len=24)
    shape.update(kw)
    return _FakeModel(**shape)


def _both(scenario):
    """Run ``scenario(tenancy_module, engine_module)`` on both packages;
    the port's result must equal the JAX package's."""
    out = {name: scenario(t, e) for name, (t, e, _) in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# -------------------------------------------------- engine admission QoS

def test_engine_rate_shed_and_queue_hint_isolation():
    def scenario(t, e):
        reg = t.TenantRegistry(
            spec="greedy:rate=0.001,burst=1;victim:rate=0", qos=True)
        eng = e.LLMEngine(_model(), max_waiting=2, tenancy=reg)
        eng.submit([1, 2, 3], 4, rid="g1", tenant="greedy")
        with pytest.raises(e.AdmissionError) as ei:
            eng.submit([1, 2, 3], 4, rid="g2", tenant="greedy")
        joined = eng.submit([1, 2, 3], 4, rid="g1", tenant="greedy") is \
            eng.get("g1")
        eng.submit([4, 5, 6], 4, rid="v1", tenant="victim")
        with pytest.raises(e.AdmissionError) as ei2:
            eng.submit([7, 8, 9], 4, rid="v2", tenant="victim")
        return (ei.value.reason, ei.value.tenant,
                ei.value.retry_after_ms > 100_000, joined,
                ei2.value.reason, ei2.value.tenant,
                ei2.value.retry_after_ms)

    assert _both(scenario) == ("rate", "greedy", True, True, "queue_full",
                               "victim", 200)


def test_engine_unlabeled_traffic_bit_identical():
    """Tenancy off, or on with all traffic unlabeled: FIFO admission and
    the same streams, in both packages."""
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4]]

    def run(t, e, spec):
        eng = e.LLMEngine(_model(num_slots=1),
                          tenancy=t.TenantRegistry(spec=spec, qos=True))
        hs = [eng.submit(p, 5, rid=f"r{i}") for i, p in enumerate(prompts)]
        _run_to_completion(eng, hs)
        return ([list(h.tokens) for h in hs], [h.admit_seq for h in hs],
                eng.stats()["qos"])

    def scenario(t, e):
        return run(t, e, ""), run(t, e, "gold:weight=4,class=0,rate=50")

    off, on = _both(scenario)
    assert off[2] is False and on[2] is True
    assert off[1] == [1, 2, 3, 4] == on[1]
    assert off[0] == on[0] == [_reference(p, 5) for p in prompts]


# ------------------------------------------------- weighted-fair picking

def test_pop_next_waiter_priority_then_deficit_then_fifo():
    def scenario(t, e):
        reg = t.TenantRegistry(
            spec="paid:class=0,weight=1;a:weight=3;b:weight=1", qos=True)
        eng = e.LLMEngine(_model(num_slots=4), tenancy=reg)
        for rid, ten, p in (("a1", "a", [1, 2]), ("a2", "a", [1, 2]),
                            ("b1", "b", [3, 4]), ("p1", "paid", [5, 6])):
            eng.submit(p, 4, rid=rid, tenant=ten)
        order = []
        for served in ({"paid": 10_000, "a": 0, "b": 0}, {"a": 29, "b": 11},
                       {"a": 34, "b": 11}, None, None):
            if served is not None:
                eng._tenant_served = served
            with eng._lock:
                h = eng._pop_next_waiter()
            order.append(None if h is None else h.id)
        return order

    assert _both(scenario) == ["p1", "a1", "b1", "a2", None]


@pytest.mark.parametrize("seed", range(6))
def test_pop_next_waiter_order_equals_jax_on_a_scripted_queue(seed):
    """A seeded random queue (tenants of random class, weight and quotas;
    some streams already admitted, holding slots and blocks) popped to
    empty under random served-token tallies: the same order in both
    packages."""
    def scenario(t, e):
        rs = np.random.RandomState(seed)
        names = ["t0", "t1", "t2", "t3"]
        spec = ";".join(
            f"{n}:class={rs.randint(0, 3)},weight={rs.randint(1, 5)},"
            f"slots={rs.randint(0, 3)},kv={rs.choice([0, 6, 12])}"
            for n in names)
        eng = e.LLMEngine(_model(num_slots=3, num_blocks=64),
                          tenancy=t.TenantRegistry(spec=spec, qos=True))
        for i in range(3):              # admitted streams hold quota
            eng.submit(list(range(1, 2 + rs.randint(1, 9))), 4,
                       rid=f"live{i}", tenant=names[rs.randint(0, 4)])
        eng._admit()
        for i in range(12):
            eng.submit(list(range(1, 2 + rs.randint(1, 16))), 4,
                       rid=f"w{i}", tenant=names[rs.randint(0, 5) % 4])
        order = []
        while True:
            eng._tenant_served = {n: int(rs.randint(0, 50)) for n in names}
            with eng._lock:
                h = eng._pop_next_waiter()
            if h is None:
                break
            order.append(h.id)
        return sorted(s.handle.id for s in eng._slots if s.handle), order

    _both(scenario)


def test_slot_quota_skips_tenant_without_blocking_queue():
    def scenario(t, e):
        reg = t.TenantRegistry(spec="capped:slots=1;other:rate=0", qos=True)
        eng = e.LLMEngine(_model(num_slots=2), tenancy=reg)
        c1 = eng.submit([1, 2, 3], 6, rid="c1", tenant="capped")
        c2 = eng.submit([1, 2, 3], 6, rid="c2", tenant="capped")
        o1 = eng.submit([4, 5, 6], 3, rid="o1", tenant="other")
        _tick(eng)
        live = sorted(s.handle.id for s in eng._slots
                      if s.handle is not None)
        waiting = eng.stats()["tenants"]["capped"]["waiting"]
        _run_to_completion(eng, [c1, c2, o1])
        return (live, waiting, [h.outcome for h in (c1, c2, o1)],
                c2.admit_seq > o1.admit_seq)

    assert _both(scenario) == (["c1", "o1"], 1, ["ok"] * 3, True)


def test_kv_quota_skips_tenant_without_blocking_queue():
    def scenario(t, e):
        reg = t.TenantRegistry(spec="capped:kv=2;other:rate=0", qos=True)
        eng = e.LLMEngine(_model(num_slots=2, block_size=4), tenancy=reg)
        big = eng.submit(list(range(1, 10)), 2, rid="big", tenant="capped")
        ok = eng.submit([4, 5, 6], 3, rid="ok", tenant="other")
        small = eng.submit([7, 8], 3, rid="small", tenant="capped")
        for _ in range(200):
            _tick(eng)
            if ok.done and small.done:
                break
        return (ok.outcome, small.outcome, big.done,
                eng.stats()["tenants"]["capped"]["waiting"])

    assert _both(scenario) == ("ok", "ok", False, 1)


def test_weighted_fair_victim_jumps_greedy_backlog():
    def scenario(t, e):
        reg = t.TenantRegistry(spec="greedy:rate=0;victim:rate=0", qos=True)
        eng = e.LLMEngine(_model(num_slots=1), tenancy=reg)
        gs = [eng.submit([10 + i, 11 + i], 4, rid=f"g{i}", tenant="greedy")
              for i in range(3)]
        v = eng.submit([1, 2, 3], 4, rid="v", tenant="victim")
        _run_to_completion(eng, gs + [v])
        return v.admit_seq, list(v.tokens), [list(g.tokens) for g in gs]

    seq, toks, _ = _both(scenario)
    assert seq == 2 and toks == _reference([1, 2, 3], 4)


# -------------------------------------------------- class-based preempts

def _class_preemption(t, e):
    """Both slots held by best-effort streams; a paid (class 0) stream
    arrives: the youngest best-effort stream is preempted for it and
    resumes by re-prefill."""
    reg = t.TenantRegistry(spec="paid:class=0;free:class=1", qos=True)
    eng = e.LLMEngine(_model(num_slots=2, num_blocks=32), tenancy=reg)
    counter = e._tenant_preempted.labels(tenant="free", reason="class")
    before = counter.value
    f1 = eng.submit([1, 2, 3, 4], 8, rid="f1", tenant="free")
    f2 = eng.submit([5, 6, 7, 8], 8, rid="f2", tenant="free")
    for _ in range(3):
        _tick(eng)
    decoding = not f1.done and not f2.done
    p = eng.submit([9, 10, 11], 6, rid="p", tenant="paid")
    _tick(eng)
    _tick(eng)
    live = sorted(s.handle.id for s in eng._slots if s.handle is not None)
    moved = counter.value - before
    _run_to_completion(eng, [f1, f2, p])
    return (decoding, live, moved, [h.outcome for h in (f1, f2, p)],
            f2.preempts >= 1, [list(h.tokens) for h in (f1, f2, p)])


def test_class_preemption_resumes_victim_byte_identical():
    decoding, live, moved, outcomes, preempted, toks = \
        _both(_class_preemption)
    assert decoding and live == ["f1", "p"] and moved == 1
    assert outcomes == ["ok"] * 3 and preempted
    assert toks == [_reference([1, 2, 3, 4], 8), _reference([5, 6, 7, 8], 8),
                    _reference([9, 10, 11], 6)]


def test_class_preemption_never_evicts_a_peer():
    def scenario(t, e):
        reg = t.TenantRegistry(spec="a:class=1;b:class=1", qos=True)
        eng = e.LLMEngine(_model(num_slots=1, num_blocks=32), tenancy=reg)
        a = eng.submit([1, 2, 3], 6, rid="a", tenant="a")
        for _ in range(2):
            _tick(eng)
        b = eng.submit([4, 5, 6], 6, rid="b", tenant="b")
        _tick(eng)
        held = eng._slots[0].handle.id
        _run_to_completion(eng, [a, b])
        return held, a.preempts

    assert _both(scenario) == ("a", 0)


def test_kv_growth_never_evicts_a_higher_class():
    """A best-effort stream that needs a block the pool cannot fund
    requeues itself instead of evicting a paid stream's KV."""
    def scenario(t, e):
        reg = t.TenantRegistry(spec="paid:class=0;free:class=1", qos=True)
        eng = e.LLMEngine(_model(num_slots=2, block_size=2, num_blocks=9,
                                 max_blocks_per_seq=16),
                          tenancy=reg)
        p = eng.submit([1, 2, 3], 9, rid="p", tenant="paid")
        f = eng.submit([4, 5, 6], 9, rid="f", tenant="free")
        _run_to_completion(eng, [p, f])
        return p.preempts, f.preempts > 0, list(p.tokens), list(f.tokens)

    pp, fp, pt, ft = _both(scenario)
    assert pp == 0 and fp
    assert pt == _reference([1, 2, 3], 9) and ft == _reference([4, 5, 6], 9)


# ------------------------------------------- prefix-cache partitioning

def test_partition_eviction_prefers_own_then_shared():
    def scenario(t, e):
        kv = {"jax": jax_kv, "port": port_kv}[
            "jax" if t is jax_tenancy else "port"]
        a = kv.BlockAllocator(num_blocks=10, block_size=4,
                              prefix_cache=True)
        hv = kv.prefix_block_hashes(list(range(12)), 4,
                                    salt=b"tenant:victim")
        hg = kv.prefix_block_hashes(list(range(100, 116)), 4,
                                    salt=b"tenant:greedy")
        cross = kv._cross_evictions.labels(tenant="greedy")
        a.set_tenant("v1", "victim")
        got = [a.allocate("v1", 3)]
        a.register_blocks("v1", hv)
        a.free("v1")
        a.set_tenant("g1", "greedy")
        got.append(a.allocate("g1", 4))
        a.register_blocks("g1", hg)
        a.free("g1")
        c0 = cross.value
        a.set_tenant("g2", "greedy")
        got.append(a.allocate("g2", 5))
        mid = (a.match_prefix(hv), cross.value - c0)
        a.set_tenant("g3", "greedy")
        got.append(a.allocate("g3", 3))
        return got, mid, cross.value - c0, a.match_prefix(hv) < 3, \
            a.used_by_tenant()

    got, mid, crossed, lost, used = _both(scenario)
    assert mid == (3, 0) and crossed == 2 and lost
    assert used == {"greedy": 8}


def test_untagged_eviction_is_plain_lru():
    for kv in (jax_kv, port_kv):
        a = kv.BlockAllocator(num_blocks=4, block_size=4, prefix_cache=True)
        h1 = kv.prefix_block_hashes([1, 2, 3, 4], 4)
        h2 = kv.prefix_block_hashes([5, 6, 7, 8], 4)
        for seq, h in (("x", h1), ("y", h2)):
            a.allocate(seq, 1)
            a.register_blocks(seq, h)
        a.free("x")
        a.free("y")
        a.allocate("z", 2)
        assert a.match_prefix(h1) == 0 and a.match_prefix(h2) == 1


_TENANTS = ["", "a", "b"]
_ops = st.lists(st.tuples(
    st.sampled_from(["alloc", "free", "tag", "acquire", "adopt", "grow",
                     "register"]),
    st.integers(0, 7), st.integers(1, 5), st.integers(0, 2),
    st.integers(0, 5)), min_size=1, max_size=60)


@settings(max_examples=60, deadline=None)
@given(ops=_ops, nb=st.integers(6, 24), prefix=st.booleans())
def test_allocator_churn_equals_jax(ops, nb, prefix):
    """A random churn of allocate / free / set_tenant / acquire_prefix /
    adopt_blocks / grow_to / register_blocks on both allocators gives the
    same block ids, the same stats() and the same partitions, step by
    step."""
    allocs = {"jax": jax_kv.BlockAllocator(nb, 4, prefix_cache=prefix),
              "port": port_kv.BlockAllocator(nb, 4, prefix_cache=prefix)}
    chains = [jax_kv.prefix_block_hashes(
        list(range(c * 50, c * 50 + 4 * 5)), 4, salt=s)
        for c in range(3) for s in (b"", b"tenant:a")]

    def step(a, op, seq, n, t, c):
        sid = f"s{seq}"
        h = chains[c]
        try:
            if op == "alloc":
                return a.allocate(sid, n)
            if op == "free":
                return a.free(sid)
            if op == "tag":
                return a.set_tenant(sid, _TENANTS[t])
            if op == "acquire":
                return a.acquire_prefix(sid, h[:n])
            if op == "adopt":
                return a.adopt_blocks(sid, h[:n], n + t % 2)
            if op == "grow":
                return a.grow_to(sid, 4 * n + t)
            return a.register_blocks(sid, h[:n])
        except ValueError as err:
            return ("ValueError", str(err))

    for op in ops:
        got = {k: step(a, *op) for k, a in allocs.items()}
        assert got["port"] == got["jax"], op
        st_ = {k: a.stats() for k, a in allocs.items()}
        assert st_["port"] == st_["jax"], op
        assert allocs["port"]._part_of == allocs["jax"]._part_of
        assert allocs["port"].used_by_tenant() == \
            allocs["jax"].used_by_tenant()
        assert allocs["port"]._owners == allocs["jax"]._owners


# ------------------------------------------------ HA client tenant bits

def _clients(**kw):
    return {name: mod.HAServingClient([("127.0.0.1", 1)], deadline_ms=0,
                                      hedge=False, **kw)
            for name, mod in (("jax", jax_ha_client),
                              ("port", port_ha_client))}


def test_parse_tenant_pins_equals_jax():
    for text in ("gold=v2, free=v1", ""):
        assert port_ha_client._parse_tenant_pins(text) == \
            jax_ha_client._parse_tenant_pins(text)
    for bad in ("gold", "=v2"):
        for mod in (port_ha_client, jax_ha_client):
            with pytest.raises(ValueError):
                mod._parse_tenant_pins(bad)


def test_client_tenant_pin_overrides_split():
    for c in _clients(tenant_pins={"gold": "v2"}).values():
        c.pin_version("v1")
        assert c._draw_version("free") == "v1"
        assert c._draw_version(None) == "v1"
        assert c._draw_version("gold") == "v2"
        c.pin_version("v3", tenant="gold")
        assert c._draw_version("gold") == "v3"
        c.pin_version(None, tenant="gold")
        assert c._draw_version("gold") == "v1"


def test_client_tenant_backoff_is_isolated_and_capped(monkeypatch):
    monkeypatch.setenv("ZOO_TENANT_BACKOFF_CAP_MS", "1500")
    for c in _clients().values():
        # only a RATE shed arms the clock; queue sheds fail over instead
        c._note_tenant_backoff("victim", {"retry_after_ms": 5000})
        c._note_tenant_backoff("victim", {"reason": "queue_full",
                                          "retry_after_ms": 5000})
        assert "victim" not in c._tenant_retry_at
        c._note_tenant_backoff("greedy", {"reason": "rate",
                                          "retry_after_ms": 60_000})
        until = c._tenant_retry_at["greedy"]
        assert 1.4 < until - time.monotonic() <= 1.55
        t0 = time.monotonic()
        c._tenant_backoff_wait("victim", None)
        c._tenant_backoff_wait(None, None)
        assert time.monotonic() - t0 < 0.05


def test_client_tenant_backoff_waits_out_the_hint():
    c = _clients()["port"]
    c._note_tenant_backoff("g", {"reason": "rate", "retry_after_ms": 120})
    t0 = time.monotonic()
    c._tenant_backoff_wait("g", None)
    assert 0.08 <= time.monotonic() - t0 <= 1.0
    t0 = time.monotonic()
    c._tenant_backoff_wait("g", None)
    assert time.monotonic() - t0 < 0.05


# ------------------------------------------- the door's tenant sheds

@pytest.mark.timeout(60)
def test_door_relays_the_shedding_tenants_own_hint():
    """Generate: the engine's rate shed reaches the wire with its reason
    and the greedy bucket's hint; predict: the door charges the same
    registry's bucket and sheds. The victim is never shed. The port's
    frames equal the JAX door's."""
    from zoo_tpu.serving.ha import SyntheticModel as JaxSynthetic
    from zoo_tpu_torch.serving.ha import SyntheticModel as PortSynthetic

    frames = {}
    for name, (t, e, _), srv_mod, synth in (
            ("jax", PKGS["jax"], jax_server, JaxSynthetic),
            ("port", PKGS["port"], port_server, PortSynthetic)):
        reg = t.TenantRegistry(
            spec="greedy:rate=0.001,burst=1;victim:rate=0", qos=True)
        eng = e.LLMEngine(_model(), tenancy=reg).start()
        srv = srv_mod.ServingServer(synth(), llm_engine=eng, port=0,
                                    tenancy=reg).start()
        got = []
        try:
            for i, ten in enumerate(("greedy", "greedy", "victim")):
                conn = port_tcp._Connection(srv.host, srv.port)
                try:
                    fs = list(conn.stream({
                        "op": "generate", "id": f"g{i}", "prompt": [1, 2],
                        "max_new_tokens": 3, "tenant": ten}))
                    # how the tokens split into frames is timing
                    last = {k: v for k, v in fs[-1].items()
                            if k not in ("seq", "tokens")}
                    last["all_tokens"] = [x for f in fs
                                          for x in f.get("tokens") or ()]
                    got.append(last)
                    # the door charges the same registry's bucket
                    got.append(conn.rpc({
                        "op": "predict", "uri": "u", "id": f"p{i}",
                        "tenant": ten,
                        "data": np.ones((1, 2), np.float32)}))
                finally:
                    conn.close()
        finally:
            srv.stop()
            eng.stop()
        for f in got:
            if "result" in f:
                f["result"] = np.asarray(f["result"]).tolist()
            if "retry_after_ms" in f:
                f["retry_after_ms"] = f["retry_after_ms"] > 100_000
            f.pop("error", None)
        frames[name] = got
    assert frames["port"] == frames["jax"]
    shed = frames["port"][2]
    assert shed["shed"] and shed["reason"] == "rate" and \
        shed["tenant"] == "greedy" and shed["retry_after_ms"] is True
    for f in frames["port"][1], frames["port"][3]:
        assert f["shed"] and f["reason"] == "rate"
    assert frames["port"][4]["outcome"] == "ok"
    assert "result" in frames["port"][5]


# ----------------------------- the tiny Llama through a class preemption

ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)
SHAPE = dict(num_slots=2, block_size=4, num_blocks=24,
             max_blocks_per_seq=8, prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def llama():
    base = JaxModel(JaxConfig(**ARCH), seed=0, **SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, base.params)
    return base, params_from_jax(tree, "cpu")


@pytest.mark.timeout(240)
@pytest.mark.parametrize("sampling", [None, {"temperature": 0.9,
                                             "top_k": 16, "seed": 7}],
                         ids=["greedy", "seeded"])
def test_llama_streams_through_a_class_preemption_equal_jax(llama,
                                                             sampling):
    """Two best-effort streams of the tiny Llama decode on both slots; a
    paid stream preempts the younger one, which resumes by re-prefill.
    Every stream's tokens equal the JAX engine's on the same weights,
    and the preempted one's equal its own unpreempted run."""
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, ARCH["vocab"], (n,)) for n in (9, 6, 5)]

    def models():
        return {"jax": JaxModel(JaxConfig(**ARCH), params=llama[0].params,
                                **SHAPE),
                "port": PagedLlamaModel(LlamaConfig(**ARCH),
                                        params=llama[1], device="cpu",
                                        **SHAPE)}

    def run(name, model, spec):
        t, e, _ = PKGS[name]
        eng = e.LLMEngine(model, overlap=False,
                          tenancy=t.TenantRegistry(spec=spec, qos=True))
        hs = [eng.submit(prompts[0], 10, rid="f1", tenant="free",
                         sampling=sampling),
              eng.submit(prompts[1], 10, rid="f2", tenant="free",
                         sampling=sampling)]
        for _ in range(4):
            _tick(eng)
        hs.append(eng.submit(prompts[2], 6, rid="p", tenant="paid",
                             sampling=sampling))
        _run_to_completion(eng, hs)
        st_ = eng.stats()
        eng.stop()
        return ([list(h.tokens) for h in hs], [h.preempts for h in hs],
                st_["blocks_used"])

    spec = "paid:class=0;free:class=1"
    out = {name: run(name, m, spec) for name, m in models().items()}
    assert out["port"] == out["jax"]
    toks, preempts, used = out["port"]
    assert preempts == [0, 1, 0] and used == 0
    solo = {name: run(name, m, "") for name, m in models().items()}
    assert solo["port"] == solo["jax"]
    assert solo["port"][0] == toks and solo["port"][1] == [0, 0, 0]


# ------------------------------------------------------------ chaos smoke

# ------------------------------------------------------------ tenant SLO

def test_slo_per_tenant_burn_and_breach(monkeypatch):
    """``ZOO_SLO_TENANT_SHED_RATE``: one verdict per tenant over the
    window, the burn published as ``zoo_tenant_burn_rate``, equal to the
    JAX watchdog's on the same series."""
    monkeypatch.setenv("ZOO_SLO_TENANT_SHED_RATE", "0.1")
    from zoo_tpu.obs import metrics as jax_metrics
    from zoo_tpu.obs import slo as jax_slo
    from zoo_tpu_torch.obs import metrics as port_metrics
    from zoo_tpu_torch.obs import slo as port_slo

    out = {}
    for name, M, S in (("port", port_metrics, port_slo),
                       ("jax", jax_metrics, jax_slo)):
        shed = M.counter("zoo_tenant_shed_total",
                         "Requests shed per tenant",
                         labels=("tenant", "reason"))
        adm = M.counter("zoo_tenant_admitted_total",
                        "Requests admitted per tenant", labels=("tenant",))
        w = S.SLOWatchdog(rules=[])
        w.evaluate()                             # baseline snapshot
        for _ in range(5):
            shed.labels(tenant="slo-greedy", reason="rate").inc()
            adm.labels(tenant="slo-greedy").inc()
        for _ in range(10):
            adm.labels(tenant="slo-victim").inc()
        status = w.evaluate()
        burn = M.gauge("zoo_tenant_burn_rate", "Per-tenant burn rate",
                       labels=("tenant", "slo"))
        out[name] = (status["tenants"], status["breaches"], status["ok"],
                     burn.labels(tenant="slo-greedy",
                                 slo="shed_rate").value)
        S._set_status(None)
    assert out["port"] == out["jax"]
    tenants, breaches, ok, burn = out["port"]
    g = tenants["slo-greedy"]
    assert g["breached"] and g["shed_rate"] == pytest.approx(0.5)
    assert g["burn_rate"] == pytest.approx(5.0) == burn
    v = tenants["slo-victim"]
    assert not v["breached"] and v["shed_rate"] == 0.0
    assert "tenant_shed_rate[slo-greedy]" in breaches and ok is False


def test_slo_tenant_objective_arms_the_watchdog(monkeypatch):
    from zoo_tpu_torch.obs.slo import SLOWatchdog
    for k in ("ZOO_SLO_TTFT_P99_S", "ZOO_SLO_INTER_TOKEN_P99_S",
              "ZOO_SLO_ERROR_RATE", "ZOO_SLO_SHED_RATE", "ZOO_SLO_KV_UTIL",
              "ZOO_SLO_SPEC_ACCEPT_FLOOR", "ZOO_SLO_TENANT_SHED_RATE"):
        monkeypatch.delenv(k, raising=False)
    assert SLOWatchdog(rules=[]).start()._thread is None
    monkeypatch.setenv("ZOO_SLO_TENANT_SHED_RATE", "0.05")
    w = SLOWatchdog(rules=[]).start()
    try:
        assert w._thread is not None
    finally:
        w.stop()


@pytest.mark.chaos
@pytest.mark.timeout(300)
def test_check_tenancy_script_runs():
    """The port's copy of ``scripts/check_tenancy.py`` on the CPU: a
    greedy flood against a paced victim over 3 replicas with a mid-storm
    SIGKILL — victims byte-identical, never shed, the greedy tenant
    throttled, no cross-tenant eviction, the seat respawned."""
    proc = subprocess.run(
        [sys.executable, "-m", "zoo_tpu_torch.scripts.check_tenancy",
         "--device", "cpu", "--duration", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=280)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TENANCY OK" in proc.stdout


@pytest.mark.timeout(240)
def test_smoke_tenancy_phase_runs_on_the_cpu(capsys):
    """The smoke's tenancy phase (``tenancy_run``) at ``llama:tiny`` on
    the CPU: every stream equal to its reference, greedy shed with its
    own hint and capped at 6 slots, each victim ahead of the greedy
    waiters, a class preemption, no block held."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    import zoo_tpu_torch.ops.kernels as K
    smoke.phase_tiny_tenancy(torch, K, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if '"tenancy-tiny"' in ln]
    runs = [ln.split('"run": "')[1].split('"')[0] for ln in lines]
    assert runs == ["unloaded", "flood_qos_off", "flood_qos_on",
                    "class_preempt", "fair_share", "victim_ratios"]
