"""The port's serving stack against the JAX package's, on the same
weights: greedy streams from ``zoo_tpu_torch``'s ``PagedLlamaModel`` +
``LLMEngine`` must equal ``zoo_tpu``'s token for token, across the
bucket and chunked prefill paths, f32/bf16/int8 caches, a real
preemption and the prefix cache, with no KV block leaked.

The config is the one of ``tests/test_llm_serving.py``'s shared model:
vocab 64, hidden 32, 2 blocks, 4 heads over 2 KV heads, 2 slots, 4-token
blocks, 24 blocks, 6-entry tables, buckets 8/16. Weights are the JAX
model's, converted with ``params_from_jax``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.models.llm.llama import LlamaConfig as JaxConfig
from zoo_tpu.serving.llm import model as jax_model_mod
from zoo_tpu.serving.llm.engine import LLMEngine as JaxEngine
from zoo_tpu.serving.llm.model import PagedLlamaModel as JaxModel

from zoo_tpu_torch.convert import params_from_jax
from zoo_tpu_torch.models.llm.llama import LlamaConfig
from zoo_tpu_torch.serving.llm import model as tmodel
from zoo_tpu_torch.serving.llm.engine import LLMEngine
from zoo_tpu_torch.serving.llm.kv_cache import (
    BlockAllocator,
    prefix_block_hashes,
)
from zoo_tpu_torch.serving.llm.model import PagedLlamaModel
from zoo_tpu_torch.serving.llm.spec import build_llm_engine, parse_llm_spec

jax.config.update("jax_platforms", "cpu")

ARCH = dict(vocab=64, hidden=32, n_block=2, n_head=4, n_kv_head=2,
            intermediate=64, rope_theta=10000.0)
SHAPE = dict(num_slots=2, block_size=4, num_blocks=24,
             max_blocks_per_seq=6, prefill_buckets=(8, 16))


def _drain(handles, budget=120.0):
    end = time.monotonic() + budget
    for h in handles:
        while not h.done:
            assert time.monotonic() < end, "streams did not finish"
            h.wait_new(len(h.tokens), 0.5)


def _streams(engine, prompts, n):
    eng = engine.start()
    try:
        hs = [eng.submit(p, n, rid=f"r{i}") for i, p in enumerate(prompts)]
        _drain(hs)
        assert all(h.outcome == "ok" for h in hs), \
            [(h.outcome, h.error) for h in hs]
        assert eng.allocator.used_blocks == 0
        return [h.tokens for h in hs], eng
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def weights():
    cfg = JaxConfig(**ARCH)
    base = JaxModel(cfg, seed=0, **SHAPE)
    tree = jax.tree_util.tree_map(np.asarray, base.params)
    return cfg, base, tree, params_from_jax(tree, "cpu")


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(11)
    return [rs.randint(0, ARCH["vocab"], (n,)) for n in (3, 9, 14)]


def _port(weights, **kw):
    shape = dict(SHAPE)
    shape.update(kw)
    return PagedLlamaModel(LlamaConfig(**ARCH), params=weights[3],
                           device="cpu", **shape)


def _jax(weights, **kw):
    shape = dict(SHAPE)
    shape.update(kw)
    return JaxModel(weights[0], params=weights[1].params, **shape)


@pytest.fixture(scope="module")
def jax_greedy(weights, prompts):
    return _streams(JaxEngine(weights[1]), prompts, 7)[0]


@pytest.mark.parametrize("variant", [
    {},                                   # bucket prefill, f32 cache
    {"prefill_chunk": 4},                 # chunked prefill
    {"kv_dtype": "bf16"},
    {"kv_dtype": "int8"},
    {"kv_dtype": "int8", "prefill_chunk": 4},
], ids=["bucket", "chunk4", "bf16", "int8", "int8-chunk4"])
def test_greedy_streams_equal_jax(weights, prompts, jax_greedy, variant):
    ref = jax_greedy if not variant.get("kv_dtype") else \
        _streams(JaxEngine(_jax(weights, **variant)), prompts, 7)[0]
    model = _port(weights, **variant)
    got, eng = _streams(LLMEngine(model), prompts, 7)
    assert got == ref
    counts = model.compile_counts()
    if variant.get("prefill_chunk"):
        assert counts["prefill"] == 0 and counts["prefill_chunk"] > 0
    else:
        assert counts["prefill"] == 3 and counts["prefill_chunk"] == 0
    assert counts["decode"] > 0


def test_sync_loop_streams_equal_jax(weights, prompts, jax_greedy):
    """Same tokens with the synchronous loop and the overlapped one."""
    got, _ = _streams(LLMEngine(_port(weights), overlap=False), prompts, 7)
    assert got == jax_greedy


def test_preempt_resume_equals_jax():
    """A 7-usable-block pool cannot hold two 20-token streams: the
    youngest is preempted and resumed by re-prefill in both packages,
    and the streams still agree token for token."""
    shape = dict(num_slots=2, block_size=4, num_blocks=8,
                 max_blocks_per_seq=8, prefill_buckets=(8, 32))
    jm = JaxModel(JaxConfig(**ARCH), seed=0, **shape)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    prompts = [np.arange(2, 8) % 64, np.arange(3, 9) % 64]
    ref, _ = _streams(JaxEngine(jm), prompts, 14)
    pm = PagedLlamaModel(LlamaConfig(**ARCH),
                         params=params_from_jax(tree, "cpu"), device="cpu",
                         **shape)
    got, eng = _streams(LLMEngine(pm), prompts, 14)
    assert eng.stats()["preempts"] > 0, "pool sizing failed to preempt"
    assert got == ref


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_prefix_cache_streams_equal_jax(weights, prefix_cache):
    """Prompts sharing a 9-token prefix (two full blocks plus one
    token): with the cache on, later streams bind the cached blocks and
    feed only their suffix; the tokens match the JAX engine either
    way. The block-aligned prompt is admitted while the first stream
    still holds the shared blocks, so it takes the copy-on-write
    fork."""
    rs = np.random.RandomState(4)
    shared = rs.randint(0, 64, (9,))
    prompts = [np.concatenate([shared, rs.randint(0, 64, (n,))])
               for n in (2, 5)] + [shared[:8]]

    def run(engine_cls, model):
        eng = engine_cls(model, prefix_cache=prefix_cache).start()
        try:
            h0 = eng.submit(prompts[0], 12, rid="p0")
            while not h0.tokens and not h0.done:   # blocks registered
                h0.wait_new(0, 0.5)
            h2 = eng.submit(prompts[2], 5, rid="p2")
            _drain([h0, h2])
            h1 = eng.submit(prompts[1], 5, rid="p1")
            _drain([h1])
            assert all(h.outcome == "ok" for h in (h0, h1, h2))
            assert eng.allocator.used_blocks == 0
            return [h0.tokens, h1.tokens, h2.tokens], eng.stats()
        finally:
            eng.stop()

    ref, jstats = run(JaxEngine, weights[1])
    got, stats = run(LLMEngine, _port(weights))
    assert got == ref
    assert stats["prefix_hit_tokens"] == jstats["prefix_hit_tokens"]
    if prefix_cache:
        assert stats["prefix_hit_tokens"] > 0
        assert stats["compiles"]["copy_block"] > 0


def test_sampled_streams_replay_across_prefill_paths(weights, prompts):
    """Seeded sampling is keyed by (seed, token index) only: bucket and
    chunked prefill draw the same tokens for the same request ids."""
    samp = {"temperature": 0.9, "top_k": 16, "top_p": 0.95}

    def run(model):
        eng = LLMEngine(model).start()
        try:
            hs = [eng.submit(p, 7, rid=f"s{i}", sampling=samp)
                  for i, p in enumerate(prompts)]
            _drain(hs)
            return [h.tokens for h in hs]
        finally:
            eng.stop()

    a = run(_port(weights))
    b = run(_port(weights, prefill_chunk=4))
    assert a == b


def test_kv_export_import_round_trip(weights):
    model = _port(weights, kv_dtype="bf16")
    model._cache["k"][:, 3] = torch.randn_like(
        model._cache["k"][:, 3].float()).to(torch.bfloat16)
    data = model.export_kv_blocks([3])
    model.import_kv_blocks([5], data)
    assert torch.equal(model._cache["k"][:, 5], model._cache["k"][:, 3])
    model.copy_block(3, 7)
    assert torch.equal(model._cache["k"][:, 7], model._cache["k"][:, 3])


# ------------------------------------------------------------- sampling

@pytest.mark.parametrize("temp,topk,topp", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.6),
    (0.9, 8, 0.9), (2.0, 1, 0.5),
])
def test_sample_one_matches_jax_with_the_same_noise(monkeypatch, temp,
                                                    topk, topp):
    rs = np.random.RandomState(int(temp * 10) + topk)
    logits = (rs.randn(64) * 3).astype(np.float32)
    for trial in range(4):
        noise = rs.gumbel(size=64).astype(np.float32)
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape, dtype: jnp.asarray(noise))
        ref = int(jax_model_mod._sample_one(
            jnp.asarray(logits), jnp.float32(temp), jnp.int32(topk),
            jnp.float32(topp), jax.random.PRNGKey(0)))
        got = int(tmodel._sample_one(torch.from_numpy(logits), temp, topk,
                                     topp, torch.from_numpy(noise)))
        assert got == ref, (trial, temp, topk, topp)


def test_gumbel_noise_is_stateless_per_token():
    seeds = torch.tensor([7, 7, 8])
    idx = torch.tensor([3, 4, 3])
    a = tmodel.gumbel_noise(seeds, idx, 128)
    b = tmodel.gumbel_noise(seeds, idx, 128)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    # roughly standard Gumbel: mean ~ 0.577
    big = tmodel.gumbel_noise(torch.tensor([1]), torch.tensor([1]), 20000)
    assert abs(float(big.mean()) - 0.5772) < 0.05


# ------------------------------------------------------ specs and the pool

def test_parse_llm_spec_forms():
    cfg, eng = parse_llm_spec("llama:tiny")
    assert cfg["hidden"] == 64 and eng == {}
    cfg, eng = parse_llm_spec(
        "llama:tiny:seed=3,slots=4,block=8,blocks=64,buckets=16/64,kv=int8")
    assert eng == {"seed": 3, "num_slots": 4, "block_size": 8,
                   "num_blocks": 64, "prefill_buckets": (16, 64),
                   "kv_dtype": "int8"}
    cfg, _ = parse_llm_spec("llama:vocab=128256,hidden=4096,n_block=32,"
                            "n_head=32,n_kv_head=8,intermediate=14336")
    assert cfg == {"vocab": 128256, "hidden": 4096, "n_block": 32,
                   "n_head": 32, "n_kv_head": 8, "intermediate": 14336}
    assert LlamaConfig(**cfg).rope_theta == 500000.0
    for bad in ("llama:gguf", "llama:tiny:slots", "llama:tiny:tp=2"):
        with pytest.raises(ValueError):
            parse_llm_spec(bad)


def test_build_llm_engine_on_cpu(monkeypatch):
    monkeypatch.setenv("ZOO_LLM_KV_BLOCKS", "20")
    eng = build_llm_engine("llama:tiny:slots=2,block=4,tables=8,"
                           "buckets=8/32,chunk=4", device="cpu",
                           start=False)
    assert eng.model.num_blocks == 20 and eng.model.prefill_chunk_size == 4
    assert eng.model.decode_attention_impl == "dense"
    toks, _ = _streams(eng, [np.arange(1, 12)], 4)
    assert len(toks[0]) == 4


@pytest.mark.parametrize("device,want", [
    ("cpu", ("dense", "dense", "f32")),
    ("cuda", ("flash", "flash", "int8")),
    ("cuda:1", ("flash", "flash", "int8"))])
def test_auto_dispatch_follows_the_device_type(monkeypatch, device, want):
    # any CUDA device gets the kernels (which raise off Hopper); only the
    # CPU gets the plain versions
    for knob in ("ZOO_LLM_DECODE_IMPL", "ZOO_LLM_PREFILL_IMPL",
                 "ZOO_LLM_KV_DTYPE"):
        monkeypatch.delenv(knob, raising=False)
    got = (tmodel.resolve_decode_impl("auto", torch.device(device)),
           tmodel.resolve_prefill_impl("auto", torch.device(device)),
           tmodel.resolve_kv_dtype("auto", torch.device(device)))
    assert got == want
    assert tmodel.resolve_decode_impl("dense", device) == "dense"
    assert tmodel.resolve_kv_dtype(None, device) == "f32"


def test_prefix_hashes_match_jax_chain():
    from zoo_tpu.serving.llm.kv_cache import prefix_block_hashes as jh
    toks = np.arange(37) % 11
    assert prefix_block_hashes(toks, 8) == jh(toks, 8)


def test_allocator_cow_and_accounting():
    a = BlockAllocator(8, 4, prefix_cache=True)
    hs = prefix_block_hashes(np.arange(8), 4)
    assert a.allocate("x", 2) is not None
    a.register_blocks("x", hs)
    assert a.acquire_prefix("y", hs) == a.blocks_of("x")
    assert a.shared_blocks == 2
    src, dst = a.make_writable("y", 1)
    assert src == a.blocks_of("x")[1] and dst not in a.blocks_of("x")
    a.free("x")
    a.free("y")
    assert a.used_blocks == 0 and a.cached_blocks == 2
    assert a.allocate("z", 7) is not None   # evicts the cached blocks
    assert a.match_prefix(hs) == 0
