"""The port's disaggregated serving against the JAX package's:
``adopt_blocks`` on both allocators, the prefill/decode engines' park /
take / offer / adopt cycle over the tiny Llama (streams equal the JAX
engine's), the TTL sweep and ``stop()`` of parked state, the
``kv_migrate`` wire (frames answered as the JAX door answers them), the
HA client's role routing and handoff pair, the mixed fleet (a
``zoo_tpu`` prefill seat handing its KV to a ``zoo_tpu_torch`` decode
seat and the reverse, f32 and int8 caches, streams byte-identical to the
JAX direct run), the ``check_disagg`` copy and the smoke's disaggregation
phase on the CPU.
"""

import importlib.util
import os
import random
import socket
import subprocess
import sys
import time
from collections import Counter

import jax
import numpy as np
import pytest

from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.serving import server as jax_server
from zoo_tpu.serving.llm import engine as jax_engine
from zoo_tpu.serving.llm import kv_cache as jax_kv
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.serving import server as port_server
from zoo_tpu_torch.serving import tcp_client as port_tcp
from zoo_tpu_torch.serving.ha_client import HAServingClient
from zoo_tpu_torch.serving.llm import engine as port_engine
from zoo_tpu_torch.serving.llm import kv_cache as port_kv
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel

from torch_time_limit import _time_limit  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)
SHAPE = dict(num_slots=2, block_size=4, num_blocks=32,
             max_blocks_per_seq=10, prefill_buckets=(8, 16, 32))
SEEDED = {"temperature": 0.9, "top_k": 16, "seed": 11}
# 18 and 17 tokens end inside a block; 16 ends on a block boundary
PROMPTS = [[(3 * i + 1) % 64 for i in range(18)],
           [(5 * i + 2) % 64 for i in range(17)],
           [(7 * i + 3) % 64 for i in range(16)]]
MIGRATE_MIN = 12
# the mixed fleet's caches: a JAX prefill seat exports a bf16 cache as
# ml_dtypes bfloat16, which neither package's codec sends; the port
# exports bf16 rows widened to f32, so its own bf16 handoff is held too
KVS = ("f32", "int8")


def _drain(handles, budget=120.0):
    end = time.monotonic() + budget
    for h in handles:
        while not h.done:
            assert time.monotonic() < end, "streams did not finish"
            h.wait_new(len(h.tokens), 0.5)


def _settled(engines, budget=10.0):
    end = time.monotonic() + budget
    while any(e.allocator.used_blocks for e in engines) and \
            time.monotonic() < end:
        time.sleep(0.02)
    return [e.allocator.used_blocks for e in engines]


# ------------------------------------------- adopt_blocks: property test

def _check_invariants(alloc):
    st = alloc.stats()
    assert st["blocks_used"] + st["blocks_free"] + st["blocks_cached"] \
        == alloc.num_blocks - 1, st
    distinct = {b for t in alloc._owners.values() for b in t}
    assert st["blocks_used"] == len(distinct), (st, distinct)
    want = Counter(b for t in alloc._owners.values() for b in t)
    assert dict(alloc._ref) == dict(want), (alloc._ref, want)


@pytest.mark.parametrize("seed", [20817, 3, 99])
def test_adopt_blocks_random_interleavings_equal_jax(seed):
    """Seeded random alloc / adopt / free interleavings on both
    allocators: the same tables and verdicts step by step, zero leaks,
    refcounts equal to the ownership tables, adopted hashes matchable,
    exhaustion rolled back."""
    rng = random.Random(seed)
    allocs = [kv.BlockAllocator(num_blocks=24, block_size=4,
                                prefix_cache=True)
              for kv in (jax_kv, port_kv)]
    live, chains, seq_n = [], [], 0
    for _ in range(400):
        op = rng.random()
        if op < 0.35 and len(live) < 10:
            seq_n += 1
            sid = f"loc{seq_n}"
            toks = [rng.randrange(97) for _ in range(rng.randrange(4, 20))]
            hashes = port_kv.prefix_block_hashes(toks, 4)
            outs = []
            for a in allocs:
                reused = a.acquire_prefix(sid, hashes)
                need = a.blocks_for_tokens(len(toks)) - len(reused)
                if need > 0 and a.allocate(sid, need) is None:
                    a.free(sid)
                    outs.append(None)
                else:
                    a.register_blocks(sid, hashes)
                    outs.append(a.blocks_of(sid))
            assert outs[0] == outs[1]
            if outs[0] is not None:
                live.append(sid)
                if hashes:
                    chains.append(hashes)
        elif op < 0.65:
            seq_n += 1
            sid = f"mig{seq_n}"
            if chains and rng.random() < 0.5:
                hashes = list(rng.choice(chains))
            else:
                toks = [rng.randrange(97)
                        for _ in range(rng.randrange(4, 20))]
                hashes = port_kv.prefix_block_hashes(toks, 4)
            if not hashes:
                continue
            n_blocks = len(hashes) + rng.randrange(0, 2)
            before = allocs[1].stats()
            outs = [a.adopt_blocks(sid, hashes, n_blocks) for a in allocs]
            assert outs[0] == outs[1]
            if outs[1] is None:
                after = allocs[1].stats()
                assert after["blocks_used"] == before["blocks_used"]
                assert after["live_sequences"] == before["live_sequences"]
            else:
                table, n_reused = outs[1]
                assert len(table) == len(set(table)) == n_blocks
                assert 0 <= n_reused < n_blocks
                assert allocs[1].match_prefix(hashes) >= 1
                live.append(sid)
                chains.append(hashes)
        elif live:
            sid = live.pop(rng.randrange(len(live)))
            assert allocs[0].free(sid) == allocs[1].free(sid)
        for a in allocs:
            _check_invariants(a)
        assert allocs[0].stats() == allocs[1].stats()
    for sid in live:
        for a in allocs:
            a.free(sid)
    for a in allocs:
        _check_invariants(a)
        assert a.stats()["blocks_used"] == 0
        assert a.stats()["live_sequences"] == 0


def test_adopt_blocks_last_block_never_aliased():
    for kv in (jax_kv, port_kv):
        alloc = kv.BlockAllocator(num_blocks=16, block_size=4,
                                  prefix_cache=True)
        hashes = kv.prefix_block_hashes(list(range(12)), 4)
        table, n_reused = alloc.adopt_blocks("a", hashes, 3)
        assert n_reused == 0
        table2, n_reused2 = alloc.adopt_blocks("b", hashes, 3)
        assert n_reused2 == 2
        assert table2[:2] == table[:2] and table2[2] != table[2]
        with pytest.raises(ValueError):
            alloc.adopt_blocks("a", hashes, 3)
        alloc.free("a")
        alloc.free("b")
        assert alloc.stats()["blocks_used"] == 0


def test_adopt_blocks_without_prefix_cache_allocates_fresh():
    for kv in (jax_kv, port_kv):
        alloc = kv.BlockAllocator(num_blocks=16, block_size=4)
        hashes = kv.prefix_block_hashes(list(range(8)), 4)
        table, n_reused = alloc.adopt_blocks("a", hashes, 2)
        assert n_reused == 0 and len(table) == 2
        assert alloc.adopt_blocks("b", hashes, 16) is None   # no room
        alloc.free("a")
        assert alloc.stats()["blocks_used"] == 0


# ------------------------------------------------------ the tiny Llama

@pytest.fixture(scope="module")
def weights():
    base = JaxModel(JaxConfig(**ARCH), seed=0, **SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, base.params)
    return base, params_from_jax(tree, "cpu")


def _jax_model(weights, kv):
    return JaxModel(JaxConfig(**ARCH), params=weights[0].params,
                    kv_dtype=kv, **SHAPE)


def _port_model(weights, kv):
    return PagedLlamaModel(LlamaConfig(**ARCH), params=weights[1],
                           device="cpu", kv_dtype=kv, **SHAPE)


@pytest.fixture(scope="module")
def jax_direct(weights):
    """The JAX engine's direct streams of ``PROMPTS`` (8 new tokens),
    greedy and seeded, per cache dtype."""
    out = {}
    for kv in KVS + ("bf16",):
        eng = jax_engine.LLMEngine(_jax_model(weights, kv)).start()
        try:
            for seeded in (False, True):
                hs = [eng.submit(p, 8, rid=f"d{seeded}{i}",
                                 sampling=SEEDED if seeded else None)
                      for i, p in enumerate(PROMPTS)]
                _drain(hs)
                assert all(h.outcome == "ok" for h in hs)
                out[(kv, seeded)] = [list(h.tokens) for h in hs]
        finally:
            eng.stop()
    return out


def _engines(weights, kv, pkg="port"):
    if pkg == "port":
        mk, mod = _port_model, port_engine
    else:
        mk, mod = _jax_model, jax_engine
    return (mod.LLMEngine(mk(weights, kv), role="prefill").start(),
            mod.LLMEngine(mk(weights, kv), role="decode").start())


def _handoff(P, D, prompt, n, rid, sampling=None):
    """The park -> take -> offer -> release -> adopt cycle by hand (the
    door does it over the wire)."""
    h1 = P.submit(prompt, n, rid=rid, sampling=sampling, handoff=True)
    _drain([h1])
    assert h1.outcome == "handoff", (h1.outcome, h1.error)
    payload = P.take_handoff(rid)
    assert payload is not None
    payload = dict(payload, kv=P.model.export_kv_blocks(payload["blocks"]))
    assert D.offer_adopted(payload)
    P.release_handoff(rid)
    h2 = D.submit(prompt, n, rid=rid, sampling=sampling,
                  adopt=D.pop_adopted(rid))
    _drain([h2])
    assert h2.outcome == "ok", (h2.outcome, h2.error)
    return list(h2.tokens)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("kv", KVS + ("bf16",))
def test_engine_adopt_then_decode_equals_jax(weights, jax_direct, kv):
    """Prefilled on a prefill engine, decoded on a decode engine with no
    prefill call there: greedy and seeded streams equal the JAX engine's
    direct ones (the block-aligned 16-token prompt included), and the
    JAX pair hands off the unaligned prompts to the same tokens."""
    P, D = _engines(weights, kv)
    try:
        for seeded in (False, True):
            got = [_handoff(P, D, p, 8, f"r{seeded}{i}",
                            SEEDED if seeded else None)
                   for i, p in enumerate(PROMPTS)]
            assert got == jax_direct[(kv, seeded)]
        assert P.stats()["handoffs_out"] == D.stats()["handoffs_in"] == 6
        counts = D.model.compile_counts()
        assert counts["prefill"] == counts["prefill_chunk"] == 0
        assert _settled([P, D]) == [0, 0]
    finally:
        P.stop()
        D.stop()
    JP, JD = _engines(weights, kv, "jax")
    try:
        got = [_handoff(JP, JD, p, 8, f"j{i}") for i, p in
               enumerate(PROMPTS[:2])]
        assert got == jax_direct[(kv, False)][:2]
    finally:
        JP.stop()
        JD.stop()


@pytest.mark.timeout(120)
def test_engine_adoption_miss_replays_identically(weights, jax_direct):
    P, D = _engines(weights, "f32")
    try:
        h1 = P.submit(PROMPTS[0], 8, rid="r-miss", handoff=True)
        _drain([h1])
        assert P.release_handoff("r-miss")
        assert not P.release_handoff("r-miss")
        assert P.take_handoff("r-miss") is None
        h2 = D.submit(PROMPTS[0], 8, rid="r-miss")
        _drain([h2])
        assert list(h2.tokens) == jax_direct[("f32", False)][0]
        assert D.stats()["handoffs_in"] == 0
        assert _settled([P, D]) == [0, 0]
    finally:
        P.stop()
        D.stop()


def test_parked_and_staged_state_age_out_and_stop_frees(weights,
                                                        monkeypatch):
    """A parked handoff nobody takes is freed by the TTL sweep, a staged
    adoption past the TTL is not handed out, a payload of another block
    size or without KV rows is refused, and ``stop()`` frees what is
    still parked — both packages alike."""
    monkeypatch.setenv("ZOO_KV_MIGRATE_TTL_MS", "50")
    for mk, mod in ((_port_model, port_engine), (_jax_model, jax_engine)):
        P = mod.LLMEngine(mk(weights, "f32"), role="prefill").start()
        try:
            for rid in ("a", "b"):
                h = P.submit(PROMPTS[1], 4, rid=rid, handoff=True)
                _drain([h])
            payload = P.take_handoff("b")   # taken: the sweep spares it
            time.sleep(0.15)
            P._wake.set()
            end = time.monotonic() + 5
            while P.stats()["parked_handoffs"] > 1 and \
                    time.monotonic() < end:
                time.sleep(0.01)
            assert P.stats()["parked_handoffs"] == 1
            assert P.allocator.blocks_of("a") == []
            assert P.allocator.blocks_of("b")
            kv = P.model.export_kv_blocks(payload["blocks"])
            assert not P.offer_adopted(dict(payload, kv=kv, block_size=8))
            assert not P.offer_adopted(dict(payload, kv=None))
            assert P.offer_adopted(dict(payload, kv=kv))
            time.sleep(0.1)
            assert P.pop_adopted("b") is None
        finally:
            P.stop()
        assert P.allocator.used_blocks == 0


# ------------------------------------------------------------ the wire

def _serve(engine, mod):
    return mod.ServingServer(None, llm_engine=engine, port=0).start()


@pytest.fixture()
def disagg_pair(weights):
    P, D = _engines(weights, "f32")
    sp, sd = _serve(P, port_server), _serve(D, port_server)
    yield sp, sd, P, D
    sp.stop()
    sd.stop()
    P.stop()
    D.stop()


def _client(sp, sd, **kw):
    return HAServingClient([(sp.host, sp.port), (sd.host, sd.port)],
                           hedge=False, migrate_min_tokens=MIGRATE_MIN,
                           **kw)


@pytest.mark.timeout(120)
def test_wire_handoff_stream_identity_and_role_advertise(disagg_pair,
                                                         jax_direct):
    sp, sd, P, D = disagg_pair
    cli = _client(sp, sd)
    try:
        topo = cli.update_topology()
        assert sorted(v["role"] for v in topo.values()) == \
            ["decode", "prefill"]
        for seeded in (False, True):
            got = [list(cli.generate(p, 8, **(SEEDED if seeded else {})))
                   for p in PROMPTS]
            assert got == jax_direct[("f32", seeded)]
        assert P.stats()["handoffs_out"] == D.stats()["handoffs_in"] == 6
        assert _settled([P, D]) == [0, 0]
    finally:
        cli.close()


@pytest.mark.timeout(120)
def test_wire_short_prompt_skips_handoff(disagg_pair):
    sp, sd, P, D = disagg_pair
    cli = _client(sp, sd)
    try:
        cli.update_topology()
        short = [(2 * i + 3) % 64 for i in range(6)]
        got = list(cli.generate(short, 5))
        assert len(got) == 5
        assert P.stats()["handoffs_out"] == 0
        assert D.model.compile_counts()["prefill"] == 1
    finally:
        cli.close()


@pytest.mark.timeout(120)
def test_wire_prefill_role_sheds_plain_generate(disagg_pair, weights):
    """A plain generate at a prefill seat is shed retryable and the frame
    advertises the role, as the JAX door's prefill seat answers."""
    sp = disagg_pair[0]
    JP = jax_engine.LLMEngine(_jax_model(weights, "f32"), role="prefill")
    jsp = _serve(JP.start(), jax_server)
    try:
        frames = {}
        for name, srv in (("port", sp), ("jax", jsp)):
            conn = port_tcp._Connection(srv.host, srv.port)
            frames[name] = list(conn.stream({
                "op": "generate", "id": "t-shed", "prompt": [1, 2, 3],
                "max_new_tokens": 4}))
            conn.close()
        assert frames["port"] == frames["jax"]
        last = frames["port"][-1]
        assert last["shed"] and last["retryable"] and \
            last["role"] == "prefill"
    finally:
        jsp.stop()
        JP.stop()


@pytest.mark.timeout(120)
def test_wire_cold_client_learns_roles_passively(disagg_pair, jax_direct):
    sp, sd, P, D = disagg_pair
    cli = _client(sp, sd)
    try:
        short = [(2 * i + 3) % 64 for i in range(6)]
        for _ in range(2):
            assert len(list(cli.generate(short, 5))) == 5
        assert any(ep.seen_role == "prefill" for ep in cli._eps)
        assert list(cli.generate(PROMPTS[0], 8)) == \
            jax_direct[("f32", False)][0]
        assert P.stats()["handoffs_out"] == 1
        assert D.stats()["handoffs_in"] == 1
    finally:
        cli.close()


@pytest.mark.timeout(120)
def test_kv_migrate_frames_answer_like_jax(weights):
    """begin/block/commit by hand on one connection: an adopted commit, a
    commit of another block size (refused by the engine), a commit past
    its deadline, and a commit with no begin — the port's replies equal
    the JAX door's, and the staged payload binds at the generate."""
    src = _port_model(weights, "f32")
    kv = src.export_kv_blocks([1, 2, 3, 4, 5])
    hashes = port_kv.prefix_block_hashes(PROMPTS[1], 4)
    begin = {"op": "kv_migrate", "phase": "begin", "prompt": PROMPTS[1],
             "first": 7, "sampling": [0.0, 0, 1.0, 0],
             "hashes": [h.hex() for h in hashes], "max_new": 4,
             "aux": {}, "block_size": 4, "n_blocks": 5}
    replies = {}
    for name, (mk, emod, smod) in (("port", (_port_model, port_engine,
                                             port_server)),
                                   ("jax", (_jax_model, jax_engine,
                                            jax_server))):
        eng = emod.LLMEngine(mk(weights, "f32"), role="decode").start()
        srv = _serve(eng, smod)
        # frames on a raw socket: begin and block frames are unanswered,
        # only a commit is
        sock = socket.create_connection((srv.host, srv.port))
        got = []
        try:
            for rid, extra, commit in (
                    ("m1", {}, {}),
                    ("m2", {"block_size": 8}, {}),
                    ("m3", {}, {"deadline_ms": 0}),
                    ("m4", None, {})):
                if extra is not None:
                    smod._send_msg(sock, dict(begin, id=rid, **extra))
                    for i in range(0, 5, 2):
                        smod._send_msg(sock, {
                            "op": "kv_migrate", "phase": "block", "id": rid,
                            "index": i,
                            "kv": {k: a[:, i:i + 2] for k, a in kv.items()}})
                smod._send_msg(sock, {"op": "kv_migrate", "phase": "commit",
                                      "id": rid, **commit})
                got.append(smod._recv_msg(sock))
        finally:
            sock.close()
        h = eng.submit(PROMPTS[1], 4, rid="m1",
                       adopt=eng.pop_adopted("m1"))
        _drain([h])
        got.append((list(h.tokens), eng.stats()["handoffs_in"],
                    eng.model.compile_counts()["prefill"]))
        srv.stop()
        eng.stop()
        replies[name] = got
    assert replies["port"] == replies["jax"]
    ok, small, late, orphan, (toks, n_in, prefills) = replies["port"]
    assert ok["ok"] and ok["adopted"]
    assert small["ok"] and not small["adopted"]
    assert late["expired"] and not late["adopted"]
    assert not orphan["ok"] and "without a begin" in orphan["error"]
    assert toks[0] == 7 and n_in == 1 and prefills == 0


# --------------------------------------------------- the mixed fleet

@pytest.mark.timeout(300)
@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("prefill_pkg", ["jax", "port"])
def test_mixed_fleet_streams_equal_jax(weights, jax_direct, kv,
                                       prefill_pkg):
    """A prefill seat of one package hands its KV over the wire to a
    decode seat of the other; every stream, greedy and seeded, is
    byte-identical to the JAX direct run. The JAX decode seat fails to
    adopt a prompt that ends on a block boundary (its import writes the
    payload's rows into the table's extra decode block), so the JAX
    decode direction runs the two unaligned prompts."""
    decode_pkg = "port" if prefill_pkg == "jax" else "jax"
    mods = {"jax": (_jax_model, jax_engine, jax_server),
            "port": (_port_model, port_engine, port_server)}
    engines, servers = [], []
    for pkg, role in ((prefill_pkg, "prefill"), (decode_pkg, "decode")):
        mk, emod, smod = mods[pkg]
        engines.append(emod.LLMEngine(mk(weights, kv), role=role).start())
        servers.append(_serve(engines[-1], smod))
    n = len(PROMPTS) if decode_pkg == "port" else 2
    cli = _client(*servers)
    try:
        cli.update_topology()
        for seeded in (False, True):
            got = [list(cli.generate(p, 8, **(SEEDED if seeded else {})))
                   for p in PROMPTS[:n]]
            assert got == jax_direct[(kv, seeded)][:n]
        P, D = engines
        assert P.stats()["handoffs_out"] == D.stats()["handoffs_in"] == \
            2 * n
        assert D.stats()["kv_cache_dtype"] == kv
        assert D.model.compile_counts()["prefill"] == 0
        assert _settled(engines) == [0, 0]
    finally:
        cli.close()
        for srv in servers:
            srv.stop()
        for e in engines:
            e.stop()


# ------------------------------------------------- routing unit tests

def _fake_client(n=3, **kw):
    eps = [("127.0.0.1", 20000 + i) for i in range(n)]
    kw.setdefault("eject", False)
    kw.setdefault("hedge", False)
    return HAServingClient(eps, **kw)


def test_plan_generate_demotes_prefill_and_ranks_affinity():
    cli = _fake_client(3, migrate_min_tokens=8, route_prefix_weight=1.0,
                       route_occ_weight=0.5)
    a, b, c = cli._eps
    a.seen_role, b.seen_role, c.seen_role = "prefill", "decode", "decode"
    prompt = list(range(16))
    cli._note_affinity(cli._prompt_sig(prompt), c)
    for _ in range(3):
        order, _sig = cli._plan_generate(prompt)
        assert order[0] is c and order[-1] is a
    assert cli._handoff_pair(order, len(prompt)) == (a, c)
    assert cli._handoff_pair(order, 4) is None
    cli.close()


def test_handoff_pair_needs_both_roles(monkeypatch):
    cli = _fake_client(2, migrate_min_tokens=4)
    order, _sig = cli._plan_generate(list(range(8)))
    assert cli._handoff_pair(order, 8) is None
    cli._eps[0].seen_role = "prefill"
    cli._eps[1].seen_role = "decode"
    order, _sig = cli._plan_generate(list(range(8)))
    assert cli._handoff_pair(order, 8) == (cli._eps[0], cli._eps[1])
    cli.close()
    monkeypatch.setenv("ZOO_KV_MIGRATE_MIN_TOKENS", "30")
    cli = _fake_client(2)
    cli._eps[0].seen_role = "prefill"
    order, _sig = cli._plan_generate(list(range(8)))
    assert cli._handoff_pair(order, 29) is None
    assert cli._handoff_pair(order, 30) is not None
    cli.close()


# ------------------------------------------------------- chaos smoke

@pytest.mark.chaos
@pytest.mark.timeout(300)
def test_check_disagg_script_runs():
    """The port's copy of ``scripts/check_disagg.py`` on the CPU: 1
    prefill + 2 decode replicas under a mixed storm, the prefill seat
    SIGKILLed during a handoff storm — every stream byte-identical, zero
    leaked blocks, the seat back with its role."""
    proc = subprocess.run(
        [sys.executable, "-m", "zoo_tpu_torch.scripts.check_disagg",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=280)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DISAGG CHAOS OK" in proc.stdout


@pytest.mark.timeout(240)
def test_smoke_disagg_phase_runs_on_the_cpu(capsys):
    """The smoke's disaggregation phase (``disagg_run``) at
    ``llama:tiny`` on the CPU, f32 and int8: streams equal the direct
    run's, three handoffs each way, the decode seat prefills only the
    short prompt, a failed push falls back to a re-prefill, no block
    held."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    import zoo_tpu_torch.ops.kernels as K
    smoke.phase_tiny_disagg(torch, K, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if '"disagg-tiny"' in ln]
    assert len(lines) == 4
    assert all('"streams_equal_direct": true' in ln or
               '"stream_equal_direct": true' in ln for ln in lines)
