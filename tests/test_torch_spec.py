"""Speculative decoding in the port against the JAX package's, on the
same weights and inputs: the prompt-lookup drafter, the allocator's
``grow_to``, ``verify_step``'s ids, and engine streams with ``spec_k=4``
token for token, greedy and seeded, across the overlapped and
synchronous loops, chunked prefill, the prefix cache, an int8 cache, a
preemption, a per-request ``spec_k=0`` and eos or ``max_new`` inside an
accepted run; and the port's speculative streams against its own plain
ones.

The model is ``tests/test_spec_decode.py``'s real-model matrix: vocab
64, hidden 32, 2 blocks, 4 heads over 2 KV heads, 2 slots, 4-token
blocks, 48 blocks, 10-entry tables, buckets 8/32; weights are the JAX
model's, converted with ``params_from_jax``. The JAX side runs as its own
tests run it on the CPU (``prefill_impl`` resolves to dense there).
"""

import time

import jax
import numpy as np
import pytest

from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.serving.llm import speculative as jax_spec
from zoo_tpu.serving.llm.engine import LLMEngine as JaxEngine
from zoo_tpu.serving.llm.kv_cache import BlockAllocator as JaxAllocator
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel
from zoo_tpu.serving.llm.spec import parse_llm_spec as jax_parse

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.serving.llm import speculative as spec
from zoo_tpu_torch.serving.llm.engine import LLMEngine
from zoo_tpu_torch.serving.llm.kv_cache import BlockAllocator
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel
from zoo_tpu_torch.serving.llm.spec import build_llm_engine, parse_llm_spec

jax.config.update("jax_platforms", "cpu")

ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)
SHAPE = dict(num_slots=2, block_size=4, num_blocks=48,
             max_blocks_per_seq=10, prefill_buckets=(8, 32))
K = 4
SPEC_KEYS = ("spec_k", "spec_ngram", "spec_proposed_tokens",
             "spec_accepted_tokens", "spec_accept_rate",
             "spec_draft_hit_rate")


@pytest.fixture(scope="module")
def weights():
    base = JaxModel(JaxConfig(**ARCH), seed=0, **SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, base.params)
    return base.params, params_from_jax(tree, "cpu")


@pytest.fixture(scope="module")
def workload():
    """A repetitive prompt (greedy), a noise prompt and the repetitive
    one again (both seeded), as the JAX matrix draws them."""
    rs = np.random.RandomState(3)
    motif = rs.randint(0, 64, (5,))
    prompts = [np.tile(motif, 4).astype(np.int32),
               rs.randint(0, 64, (9,)).astype(np.int32),
               np.tile(motif, 4).astype(np.int32)]
    sampling = [None, dict(temperature=0.9, top_k=16, top_p=0.95, seed=11),
                dict(temperature=1.1, seed=5)]
    return prompts, sampling


def _jax(weights, shape=SHAPE, **kw):
    return JaxModel(JaxConfig(**ARCH), params=weights[0], **shape, **kw)


def _port(weights, shape=SHAPE, **kw):
    return PagedLlamaModel(LlamaConfig(**ARCH), params=weights[1],
                           device="cpu", **shape, **kw)


def _generate(engine, prompts, n, sampling=None, spec_ks=None,
              budget=120.0):
    eng = engine.start()
    try:
        hs = [eng.submit(p, n, rid=f"g{i}",
                         sampling=sampling[i] if sampling else None,
                         spec_k=spec_ks[i] if spec_ks else None)
              for i, p in enumerate(prompts)]
        end = time.monotonic() + budget
        while not all(h.done for h in hs):
            assert time.monotonic() < end, [(h.outcome, h.error) for h in hs]
            time.sleep(0.002)
        assert all(h.outcome == "ok" for h in hs), \
            [(h.outcome, h.error) for h in hs]
        assert eng.allocator.used_blocks == 0
        return [list(h.tokens) for h in hs], eng.stats()
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_spec_streams(weights, workload):
    """The JAX engine's speculative streams on the base shape."""
    return _generate(JaxEngine(_jax(weights, spec_k=K)), workload[0], 12,
                     workload[1])[0]


# ------------------------------------------------------------- drafter

@pytest.mark.parametrize("context,k,n", [
    ([1, 2, 3, 1, 2, 3, 1, 2], 7, 3), ([5, 6, 7, 8], 4, 3),
    ([7, 2, 9, 5, 2, 8, 5, 2], 1, 2), ([1, 2, 1, 2], 0, 3), ([1], 4, 3),
    ([], 4, 3), ([4, 4, 4, 4, 4], 6, 3), ([3, 9, 3, 9, 3], 5, 1)])
def test_propose_tokens_equals_jax(context, k, n):
    got = spec.propose_tokens(context, k, n)
    assert got.dtype == np.int32
    assert list(got) == list(jax_spec.propose_tokens(context, k, n))


def test_prompt_lookup_equals_jax_on_random_contexts():
    """The incremental index against the JAX copy and the rescanning
    drafter, on random contexts split at random points."""
    rs = np.random.RandomState(7)
    for _ in range(300):
        L = rs.randint(2, 40)
        ctx = rs.randint(0, 5, (L,)).astype(np.int32)
        k, n = int(rs.randint(1, 8)), int(rs.randint(1, 5))
        split = int(rs.randint(1, L))
        ours, ref = spec.PromptLookup(ctx[:split], n), \
            jax_spec.PromptLookup(ctx[:split], n)
        ours.extend(ctx[split:])
        ref.extend(ctx[split:])
        assert list(ours.propose(k)) == list(ref.propose(k)) == \
            list(spec.propose_tokens(ctx, k, n)), (ctx, k, n, split)


@pytest.mark.parametrize("draft,verified", [
    ([3, 4, 9], [3, 4, 1, 2]), ([], [7]), ([5], [5, 6]), ([9], [5, 6]),
    ([1, 2, 3, 4], [1, 2, 3, 4, 5])])
def test_accept_length_equals_jax(draft, verified):
    assert spec.accept_length(draft, verified) == \
        jax_spec.accept_length(draft, verified)


# ---------------------------------------------------- allocator support

def test_grow_to_equals_jax():
    """The same operations on both allocators: the same capacities, the
    same blocks, the same free lists."""
    ours, ref = BlockAllocator(8, 4), JaxAllocator(8, 4)
    ops = [("allocate", "s", 1), ("grow_to", "s", 10),
           ("allocate", "t", 1), ("grow_to", "s", 100),
           ("grow_to", "ghost", 8), ("grow_to", "t", 5), ("free", "s"),
           ("grow_to", "t", 9), ("grow_to", "t", 3)]
    for op, *args in ops:
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args), op
        for sid in ("s", "t"):
            assert ours.blocks_of(sid) == ref.blocks_of(sid), op
        assert ours.free_blocks == ref.free_blocks, op


def test_grow_to_takes_cached_blocks_but_never_referenced_ones():
    from zoo_tpu_torch.serving.llm.kv_cache import prefix_block_hashes
    a = BlockAllocator(6, 4, prefix_cache=True)
    a.allocate("c", 1)
    a.register_blocks("c", prefix_block_hashes(np.arange(4), 4))
    a.free("c")                                # parks on the cached LRU
    a.allocate("a", 3)
    a.allocate("b", 1)
    assert a.cached_blocks == 1
    assert a.grow_to("b", 40) == 8             # the cached block only
    assert a.cached_blocks == 0 and len(a.blocks_of("a")) == 3


# --------------------------------------------------------- verify_step

@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_verify_step_ids_equal_jax(weights, kv, sampled):
    """Both models prefill the same prompts into the same tables, then
    score the same (slots, K + 1) candidates; slot 0's rows run past the
    40-token context (trash block, clamped rope row)."""
    tables = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                       [11, 12, 13, 14, 0, 0, 0, 0, 0, 0]], np.int32)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 64, (30,)), rs.randint(0, 64, (9,))]
    lanes = (np.zeros(2, np.float32), np.zeros(2, np.int32),
             np.ones(2, np.float32), np.zeros(2, np.uint32))
    if sampled:
        lanes = (np.array([0.9, 1.1], np.float32), np.array([16, 0], np.int32),
                 np.array([0.95, 1.0], np.float32),
                 np.array([11, 2 ** 32 - 5], np.uint32))
    jm, pm = _jax(weights, spec_k=K, kv_dtype=kv), \
        _port(weights, spec_k=K, kv_dtype=kv)
    for m in (jm, pm):
        for p, row in zip(prompts, tables):
            m.prefill(p, row)
    for pos in ([30, 9], [37, 12]):
        toks = rs.randint(0, 64, (2, K + 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        ref = np.asarray(jm.verify_step(toks, tables, pos, lanes))
        got = pm.read_tokens(pm.verify_step(toks, tables, pos, lanes))
        assert got.shape == (2, K + 1) and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    assert pm.compile_counts()["verify"] == 2


def test_verify_step_enforces_its_shape(weights):
    lanes = (np.zeros(2, np.float32), np.zeros(2, np.int32),
             np.ones(2, np.float32), np.zeros(2, np.uint32))
    tables = np.zeros((2, 10), np.int32)
    with pytest.raises(ValueError, match="census"):
        _port(weights, spec_k=2).verify_step(
            np.zeros((2, 5), np.int32), tables, np.zeros(2, np.int32), lanes)
    with pytest.raises(RuntimeError, match="spec_k"):
        _port(weights, spec_k=0).verify_step(
            np.zeros((2, 1), np.int32), tables, np.zeros(2, np.int32), lanes)
    with pytest.raises(ValueError, match="spec_k"):
        _port(weights, spec_k=-1)


# ------------------------------------------------------ engine streams

@pytest.mark.parametrize("variant", [
    dict(), dict(overlap=False), dict(model=dict(prefill_chunk=4)),
    dict(model=dict(kv_dtype="int8")), dict(prefix_cache=True),
    dict(model=dict(kv_dtype="int8", prefill_chunk=4), prefix_cache=True)],
    ids=["overlap", "sync", "chunk4", "int8", "prefix", "int8-prefix-chunk4"])
def test_spec_streams_equal_jax(weights, workload, jax_spec_streams,
                                variant):
    """Greedy and seeded streams with spec_k=4, port against the JAX
    package's speculative engine on the same variant, token for
    token."""
    variant = dict(variant)
    mkw = variant.pop("model", {})
    prompts, sampling = workload
    ref = jax_spec_streams if not mkw and not variant else _generate(
        JaxEngine(_jax(weights, spec_k=K, **mkw),
                  prefix_cache=variant.get("prefix_cache")),
        prompts, 12, sampling)[0]
    got, st = _generate(LLMEngine(_port(weights, spec_k=K, **mkw),
                                  **variant), prompts, 12, sampling)
    assert got == ref
    c = st["compiles"]
    assert c["verify"] > 0 and c["decode"] == 0, c
    assert st["spec_accepted_tokens"] > 0, st
    if variant.get("prefix_cache"):
        assert st["prefix_hit_tokens"] > 0, st


@pytest.mark.parametrize("overlap", [True, False])
def test_spec_streams_equal_the_ports_plain_streams(weights, workload,
                                                    overlap):
    """Speculation changes no token: spec_k=4 streams equal the same
    model's streams with the engine at spec_k=0 (no verify pass)."""
    prompts, sampling = workload
    model = _port(weights, spec_k=K)
    plain, pst = _generate(LLMEngine(model, spec_k=0, overlap=overlap),
                           prompts, 12, sampling)
    got, st = _generate(LLMEngine(model, overlap=overlap), prompts, 12,
                        sampling)
    assert got == plain
    assert pst["spec_k"] == 0 and pst["compiles"]["verify"] == 0
    assert st["spec_k"] == K


def test_spec_across_a_real_preemption_equals_jax():
    """A pool that cannot hold both streams: the youngest is evicted
    mid-speculation and resumed by re-prefill in both packages; the
    streams agree with each other and with plain decode."""
    shape = dict(num_slots=2, block_size=4, num_blocks=8,
                 max_blocks_per_seq=8, prefill_buckets=(8, 32))
    jm = JaxModel(JaxConfig(**ARCH), seed=0, spec_k=3, **shape)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                             "cpu")
    prompts = [np.arange(2, 8) % 64, np.arange(3, 9) % 64]
    ref, _ = _generate(JaxEngine(jm), prompts, 14)
    model = PagedLlamaModel(LlamaConfig(**ARCH), params=params,
                            device="cpu", spec_k=3, **shape)
    got, st = _generate(LLMEngine(model), prompts, 14)
    assert st["preempts"] > 0, "pool sizing failed to preempt"
    assert st["spec_proposed_tokens"] > 0
    assert got == ref
    plain, _ = _generate(LLMEngine(model, spec_k=0), prompts, 14)
    assert got == plain


def test_per_request_spec_k_zero_equals_jax(weights, workload):
    """spec_k=0 on a request: that stream drafts nothing but still rides
    the verify pass; its tokens do not change."""
    prompts, sampling = workload
    caps = [0, None, 2]
    ref, _ = _generate(JaxEngine(_jax(weights, spec_k=K)), prompts, 12,
                       sampling, caps)
    eng = LLMEngine(_port(weights, spec_k=K))
    got, st = _generate(eng, prompts, 12, sampling, caps)
    assert got == ref
    assert st["compiles"]["decode"] == 0
    with pytest.raises(ValueError, match="spec_k"):
        eng.submit(prompts[0], 4, spec_k=-1)


def _accepted_spans(engine):
    """Per applied verify lane that accepted a draft: the stream indices
    of its accepted draft tokens, and of all it emitted (the model's own
    next token too), recorded by wrapping the engine's apply step."""
    drafted, emitted = set(), set()
    apply = engine._apply_spec

    def recording(snapshot, arr):
        for i, h, _, draft in snapshot:
            n = spec.accept_length(draft, arr[i])
            if n:
                drafted.update(len(h.tokens) + j for j in range(n))
                emitted.update(len(h.tokens) + j for j in range(n + 1))
        apply(snapshot, arr)

    engine._apply_spec = recording
    return drafted, emitted


class _CyclicModel:
    """A deterministic model both engines drive: the canonical token
    after ``x`` is ``(x + 1) % 4`` in prefill, decode and verify alike,
    so a cyclic prompt's drafts are all accepted (``tests/
    test_spec_decode.py``'s fake)."""

    def __init__(self, eos_id=None, spec_k=3):
        self.num_slots, self.spec_k, self.eos_id = 2, spec_k, eos_id
        self.block_size, self.num_blocks = 4, 64
        self.max_blocks_per_seq, self.max_prompt_len = 8, 30
        self.max_context, self.prefill_chunk_size = 32, 0
        self.suffix_chunk_size = 4

    def prefill(self, prompt, row, sampling=None):
        return (int(prompt[-1]) + 1) % 4

    def decode_step(self, prev, host, use, tables, pos, lanes):
        prev = np.zeros_like(host) if prev is None else prev
        return (np.where(np.asarray(use), host, prev) + 1) % 4

    def verify_step(self, tokens, tables, positions, lanes):
        return (np.asarray(tokens) + 1) % 4

    def read_tokens(self, batch):
        return np.asarray(batch)


def test_eos_inside_an_accepted_run_equals_jax():
    """eos = 2 first comes as an accepted draft token of the cyclic
    stream: both engines stop there, as plain decode does."""
    cyclic = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    eng = LLMEngine(_CyclicModel(eos_id=2))
    drafted, _ = _accepted_spans(eng)
    got, st = _generate(eng, [cyclic], 10)
    ref, _ = _generate(JaxEngine(_CyclicModel(eos_id=2)), [cyclic], 10)
    plain, _ = _generate(LLMEngine(_CyclicModel(eos_id=2), spec_k=0),
                         [cyclic], 10)
    assert got == ref == plain == [[0, 1, 2]]
    assert 2 in drafted and st["spec_accepted_tokens"] > 0


class _FailingVerify(_CyclicModel):
    def verify_step(self, tokens, tables, positions, lanes):
        raise RuntimeError("device lost")


@pytest.mark.parametrize("overlap", [True, False])
def test_a_failed_verify_pass_ends_its_streams_loudly(overlap):
    """A verify pass that raises ends the streams it carried with an
    error, frees their blocks and leaves the scheduler running."""
    eng = LLMEngine(_FailingVerify(), overlap=overlap).start()
    try:
        h = eng.submit(np.array([0, 1, 2, 3, 0, 1], np.int32), 8)
        end = time.monotonic() + 30
        while not h.done:
            assert time.monotonic() < end
            h.wait_new(len(h.tokens), 0.5)
        assert h.outcome == "error" and "device lost" in h.error
        assert h.tokens == [2]          # the prefill's token only
        assert eng.allocator.used_blocks == 0
        assert eng._thread.is_alive()
    finally:
        eng.stop()


def test_eos_inside_a_speculative_pass_equals_jax(weights, workload):
    """On the real model: eos is the first occurrence of a token the
    greedy stream emits in a verify pass that accepted drafts; the
    stream stops there in the port, the JAX engine and plain decode."""
    prompt = workload[0][0]
    eng = LLMEngine(_port(weights, spec_k=K))
    _, emitted = _accepted_spans(eng)
    (stream,), _ = _generate(eng, [prompt], 24)
    cut = 1 + min(i for i in emitted if stream.index(stream[i]) == i)
    eos = stream[cut - 1]
    ref, _ = _generate(JaxEngine(_jax(weights, spec_k=K, eos_id=eos)),
                       [prompt], 24)
    got, _ = _generate(LLMEngine(_port(weights, spec_k=K, eos_id=eos)),
                       [prompt], 24)
    plain, _ = _generate(LLMEngine(_port(weights, eos_id=eos)), [prompt], 24)
    assert got == ref == plain == [stream[:cut]]


@pytest.mark.parametrize("n", [1, 2, 5, 11])
def test_max_new_inside_an_accepted_run_equals_jax(weights, workload, n):
    prompt = workload[0][0]
    ref, _ = _generate(JaxEngine(_jax(weights, spec_k=K)), [prompt], n)
    got, _ = _generate(LLMEngine(_port(weights, spec_k=K)), [prompt], n)
    assert got == ref and len(got[0]) == n


def test_stats_carry_the_spec_keys(weights, workload):
    prompts, sampling = workload
    _, st = _generate(LLMEngine(_port(weights, spec_k=K), spec_ngram=2),
                      prompts, 8, sampling)
    _, jst = _generate(JaxEngine(_jax(weights, spec_k=K), spec_ngram=2),
                       prompts, 8, sampling)
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["spec_k"] == K and st["spec_ngram"] == 2
    assert 0.0 < st["spec_accept_rate"] <= 1.0
    assert 0.0 < st["spec_draft_hit_rate"] <= 1.0


def test_engine_budget_clamped_to_the_models_width(weights):
    model = _port(weights, spec_k=3)
    assert LLMEngine(model, spec_k=99).spec_k == 3
    off = LLMEngine(model, spec_k=0)
    assert off.spec_k == 0 and not off._spec
    assert LLMEngine(_port(weights), spec_k=4).spec_k == 0


# --------------------------------------------------------- spec grammar

@pytest.mark.parametrize("text", [
    "llama:tiny:spec_k=4,spec_ngram=2,prefill_impl=dense",
    "llama:tiny:spec_k=0", "llama:tiny:slots=2,spec_ngram=5"])
def test_spec_keys_parse_as_jax(text):
    assert parse_llm_spec(text) == jax_parse(text)


def test_spec_precedence_env_spec_kwargs(monkeypatch):
    """env < spec < kwargs, for the model's spec_k and the engine's
    spec_ngram, as the JAX package resolves them."""
    small = "llama:tiny:slots=2,block=4,blocks=16,tables=4,buckets=8"
    monkeypatch.setenv("ZOO_LLM_SPEC_K", "2")
    monkeypatch.setenv("ZOO_LLM_SPEC_NGRAM", "4")
    e = build_llm_engine(small, device="cpu", start=False)
    assert (e.model.spec_k, e.spec_k, e.spec_ngram) == (2, 2, 4)
    e = build_llm_engine(small + ",spec_k=3,spec_ngram=1", device="cpu",
                         start=False)
    assert (e.model.spec_k, e.spec_k, e.spec_ngram) == (3, 3, 1)
    e = build_llm_engine(small + ",spec_k=3,spec_ngram=1", device="cpu",
                         start=False, spec_k=1, spec_ngram=2)
    assert (e.model.spec_k, e.spec_k, e.spec_ngram) == (1, 1, 2)
    monkeypatch.delenv("ZOO_LLM_SPEC_K")
    monkeypatch.delenv("ZOO_LLM_SPEC_NGRAM")
    e = build_llm_engine(small, device="cpu", start=False)
    assert (e.spec_k, e._spec, e.spec_ngram) == (0, False, 3)


def test_cpu_drive_through_build_llm_engine():
    """The documented CPU drive: ``llama:tiny:spec_k=4`` on a tiled
    motif, greedy, with the stats keys."""
    eng = build_llm_engine("llama:tiny:spec_k=4", device="cpu")
    try:
        motif = np.random.RandomState(5).randint(0, 256, (16,))
        toks, st = None, None
        h = eng.submit(np.tile(motif, 4), 16, spec_k=4)
        while not h.done:
            h.wait_new(len(h.tokens), 1.0)
        toks, st = h.tokens, eng.stats()
    finally:
        eng.stop()
    assert h.outcome == "ok" and len(toks) == 16
    assert st["compiles"]["verify"] > 0 and st["compiles"]["decode"] == 0
    assert set(SPEC_KEYS) <= set(st)
