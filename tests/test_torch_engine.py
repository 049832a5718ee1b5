"""The port's engine copy against the JAX package's engine, scenario by
scenario, on one deterministic fake model.

``zoo_tpu_torch.serving.llm.engine`` is an own copy of
``zoo_tpu.serving.llm.engine`` (without its telemetry; tenancy and the
handoff are held to the JAX engine in ``tests/test_torch_tenancy.py``
and ``tests/test_torch_disagg.py``). Each scenario here runs on BOTH
engines over the same fake model, which has the ``PagedLlamaModel``
surface but no framework at all,
and checks the same outcomes: tokens against the closed-form reference,
outcomes, freed blocks, and — for the white-box ticked scenarios — the
exact sequence of model calls, which must be identical between the two
schedulers.
"""

import time

import numpy as np
import pytest

from zoo_tpu.serving.llm import engine as jax_engine
from zoo_tpu.util.resilience import Deadline as JaxDeadline

from zoo_tpu_torch.serving.llm import engine as torch_engine
from zoo_tpu_torch.util.resilience import Deadline as TorchDeadline

ENGINES = {"jax": (jax_engine, JaxDeadline),
           "torch": (torch_engine, TorchDeadline)}


@pytest.fixture(params=sorted(ENGINES))
def E(request):
    """(engine module, Deadline class) of one package."""
    return ENGINES[request.param]


class _FakeModel:
    """Greedy lanes: next token = ``(2*tok + pos) % 97``; sampled lanes:
    ``(31*seed + 7*pos + 3*tok) % 97`` — pure functions of the slot's own
    state, so preemption's re-prefill is provably seamless (the same
    model the JAX package's scheduler tests use)."""

    def __init__(self, num_slots=2, block_size=4, num_blocks=8,
                 max_blocks_per_seq=4, max_prompt_len=12,
                 decode_delay=0.0, eos_id=None, prefill_chunk=0):
        self.num_slots = num_slots
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = max_blocks_per_seq
        self.max_context = block_size * max_blocks_per_seq
        self.max_prompt_len = max_prompt_len
        self.prefill_chunk_size = prefill_chunk
        self.decode_delay = decode_delay
        self.eos_id = eos_id
        self.calls = []    # ("prefill", n) / ("chunk", start, n) / ("decode",)

    @staticmethod
    def _next(tok, pos, temp=0.0, seed=0):
        if temp > 0:
            return (31 * int(seed) + 7 * int(pos) + 3 * int(tok)) % 97
        return (2 * int(tok) + int(pos)) % 97

    def prefill(self, prompt, block_table_row, sampling=None):
        self.calls.append(("prefill", len(prompt)))
        t, _, _, s = sampling or (0.0, 0, 1.0, 0)
        return self._next(prompt[-1], len(prompt), t, s)

    def prefill_chunk(self, chunk, start, total_len, block_table_row,
                      sampling=None):
        self.calls.append(("chunk", int(start), len(chunk)))
        t, _, _, s = sampling or (0.0, 0, 1.0, 0)
        return self._next(chunk[-1], total_len, t, s)

    def decode_step(self, prev, host_tokens, use_host, block_tables,
                    positions, sampling):
        if self.decode_delay:
            time.sleep(self.decode_delay)
        self.calls.append(("decode",))
        prev = np.zeros_like(host_tokens) if prev is None else \
            np.asarray(prev)
        toks = np.where(np.asarray(use_host), host_tokens, prev)
        temps, _, _, seeds = sampling
        return np.array([self._next(t, p + 1, tt, s) for t, p, tt, s in
                         zip(toks, positions, temps, seeds)], np.int32)

    def read_tokens(self, batch):
        return np.asarray(batch)


def _reference(prompt, n, temp=0.0, seed=0):
    seq = list(prompt)
    out = []
    for _ in range(n):
        out.append(_FakeModel._next(seq[-1], len(seq), temp, seed))
        seq.append(out[-1])
    return out


def _drain(handles, budget=20.0):
    end = time.monotonic() + budget
    while not all(h.done for h in handles):
        if time.monotonic() > end:
            raise AssertionError(f"streams stuck: "
                                 f"{[h.outcome for h in handles]}")
        time.sleep(0.005)


def _wait_freed(eng, budget=5.0):
    end = time.monotonic() + budget
    while eng.allocator.used_blocks and time.monotonic() < end:
        time.sleep(0.01)
    return eng.allocator.used_blocks


def _ticks(eng, handles, n):
    for _ in range(n):
        eng._sweep()
        eng._admit()
        eng._prefill_tick()
        eng._grow_or_preempt()
        eng._decode_tick()
        if all(h.done for h in handles):
            return


@pytest.mark.parametrize("overlap", [False, True])
def test_more_streams_than_slots(E, overlap):
    eng = E[0].LLMEngine(_FakeModel(num_blocks=32, max_blocks_per_seq=8),
                         overlap=overlap).start()
    try:
        prompts = [[3, 5], [7], [1, 2, 3], [9, 9], [4], [8, 1]]
        hs = [eng.submit(p, 5) for p in prompts]
        _drain(hs)
        for p, h in zip(prompts, hs):
            assert h.outcome == "ok" and h.tokens == _reference(p, 5)
        assert eng.allocator.used_blocks == 0
        assert eng.allocator.live_sequences() == 0
    finally:
        eng.stop()


def test_short_streams_pass_a_long_one(E):
    """Continuous batching: short streams admitted behind a long one
    finish while it still decodes."""
    eng = E[0].LLMEngine(_FakeModel(num_blocks=64, max_blocks_per_seq=8,
                                    decode_delay=0.002)).start()
    try:
        long_h = eng.submit([1], 25)
        short = [eng.submit([2 + i], 2) for i in range(3)]
        _drain(short)
        assert not long_h.done
        _drain([long_h])
        assert long_h.tokens == _reference([1], 25)
    finally:
        eng.stop()


def _oneshot_calls(E):
    model = _FakeModel(num_blocks=64, max_blocks_per_seq=8)
    eng = E[0].LLMEngine(model, mode="oneshot")
    h1, h2, h3 = eng.submit([1], 4), eng.submit([2], 4), eng.submit([3], 2)
    _ticks(eng, [h1, h2], 3)
    assert h1.done and h2.done and not h3.tokens
    _ticks(eng, [h3], 2)
    assert h3.tokens == _reference([3], 2)
    eng.stop()
    return model.calls


def test_oneshot_waits_for_the_wave_like_jax():
    assert _oneshot_calls(ENGINES["torch"]) == _oneshot_calls(ENGINES["jax"])


def test_deadlines(E):
    mod, Deadline = E
    eng = mod.LLMEngine(_FakeModel(num_blocks=32, max_blocks_per_seq=8,
                                   decode_delay=0.01)).start()
    try:
        dead = eng.submit([1, 2], 4, deadline=Deadline.from_ms(0.0))
        _drain([dead])
        assert dead.outcome == "expired" and dead.tokens == []
        h = eng.submit([5], 10_000, deadline=Deadline.from_ms(120.0))
        _drain([h], budget=10.0)
        assert h.outcome == "expired"
        assert 0 < len(h.tokens) < 10_000
        assert h.tokens == _reference([5], len(h.tokens))
        assert _wait_freed(eng) == 0, "expiry leaked KV blocks"
    finally:
        eng.stop()


def test_cancel_and_stop_free_blocks(E):
    eng = E[0].LLMEngine(_FakeModel(num_blocks=32, max_blocks_per_seq=8,
                                    decode_delay=0.01)).start()
    h = eng.submit([5, 6], 10_000)
    live = eng.submit([1], 10_000)
    while not (h.tokens and live.tokens):
        time.sleep(0.005)
    assert eng.cancel(h.id)
    _drain([h])
    assert h.outcome == "cancelled" and not eng.cancel(h.id)
    eng.stop()
    assert live.outcome == "cancelled"
    assert eng.allocator.used_blocks == 0


def test_admission_sheds_and_duplicate_ids_join(E):
    mod = E[0]
    eng = mod.LLMEngine(_FakeModel(num_slots=1, decode_delay=0.01),
                        max_waiting=2).start()
    try:
        running = eng.submit([1], 1000, rid="run")
        while not running.tokens:
            time.sleep(0.005)
        assert eng.submit([9, 9], 5, rid="run") is running
        eng.submit([2], 4)
        eng.submit([3], 4)
        with pytest.raises(mod.AdmissionError) as ei:
            eng.submit([4], 4)
        assert ei.value.retry_after_ms > 0
    finally:
        eng.stop()


def test_rejects_bad_prompts(E):
    eng = E[0].LLMEngine(_FakeModel(num_slots=1, block_size=2, num_blocks=4,
                                    max_blocks_per_seq=16,
                                    max_prompt_len=64))
    for prompt, n in ((list(range(65)), 4), ([], 4), ([1], 0)):
        with pytest.raises(ValueError):
            eng.submit(prompt, n)
    with pytest.raises(ValueError, match="whole pool"):
        eng.submit(list(range(20)), 4)
    eng.stop()


def test_pool_exhaustion_context_ceiling_and_eos(E):
    mod = E[0]
    eng = mod.LLMEngine(_FakeModel(num_slots=1, block_size=2, num_blocks=3,
                                   max_blocks_per_seq=16,
                                   max_prompt_len=3)).start()
    try:
        h = eng.submit([1], 50)
        _drain([h])
        assert h.outcome == "error" and "kv cache exhausted" in h.error
        assert eng.allocator.used_blocks == 0
    finally:
        eng.stop()
    eng = mod.LLMEngine(_FakeModel(num_slots=1, block_size=2, num_blocks=32,
                                   max_blocks_per_seq=3,
                                   max_prompt_len=4)).start()
    try:
        h = eng.submit([1, 2], 50)
        _drain([h])
        assert h.outcome == "ok" and h.truncated
        assert h.tokens == _reference([1, 2], len(h.tokens)) and \
            len(h.tokens) < 50
    finally:
        eng.stop()
    ref = _reference([6], 10)
    for overlap in (False, True):
        eng = mod.LLMEngine(_FakeModel(eos_id=ref[3], num_blocks=32,
                                       max_blocks_per_seq=8,
                                       decode_delay=0.002),
                            overlap=overlap).start()
        try:
            h = eng.submit([6], 50)
            _drain([h])
            assert h.outcome == "ok" and h.tokens == ref[:4]
        finally:
            eng.stop()


def _preempt_run(E, sampling=None, chunk=0):
    model = _FakeModel(block_size=2, num_blocks=7, max_blocks_per_seq=6,
                       max_prompt_len=8, prefill_chunk=chunk)
    eng = E[0].LLMEngine(model, overlap=False)
    a = eng.submit([1, 2], 9, sampling=sampling)
    b = eng.submit([3, 4], 9, sampling=sampling)
    _ticks(eng, [a, b], 80)
    t, s = (sampling["temperature"], sampling["seed"]) if sampling \
        else (0.0, 0)
    assert a.tokens == _reference([1, 2], 9, t, s)
    assert b.tokens == _reference([3, 4], 9, t, s)
    assert eng.allocator.used_blocks == 0
    eng.stop()
    return model.calls, a.preempts + b.preempts


@pytest.mark.parametrize("sampling,chunk", [
    (None, 0), ({"temperature": 1.0, "seed": 5}, 0), (None, 2)],
    ids=["greedy", "sampled", "chunked"])
def test_preemption_resumes_exactly_like_jax(sampling, chunk):
    """Two streams on a pool that cannot hold both: the youngest is
    preempted and re-prefilled from prompt + generated; the port's
    scheduler makes exactly the JAX scheduler's model calls."""
    calls_t, pre_t = _preempt_run(ENGINES["torch"], sampling, chunk)
    calls_j, pre_j = _preempt_run(ENGINES["jax"], sampling, chunk)
    assert pre_t == pre_j > 0
    assert calls_t == calls_j


def _chunk_interleave_calls(E):
    model = _FakeModel(num_blocks=64, max_blocks_per_seq=8,
                       max_prompt_len=32, prefill_chunk=4)
    eng = E[0].LLMEngine(model, overlap=False)
    a = eng.submit([1], 30)
    _ticks(eng, [], 3)
    before = len(a.tokens)
    long_h = eng.submit(list(range(1, 13)), 4)
    progress = []
    for _ in range(2):
        _ticks(eng, [], 1)
        progress.append(len(a.tokens))
    assert not long_h.tokens and progress == [before + 1, before + 2]
    _ticks(eng, [a, long_h], 40)
    assert a.tokens == _reference([1], 30)
    assert long_h.tokens == _reference(list(range(1, 13)), 4)
    assert eng.allocator.used_blocks == 0
    eng.stop()
    return model.calls


def test_chunked_prefill_interleaves_like_jax():
    assert _chunk_interleave_calls(ENGINES["torch"]) == \
        _chunk_interleave_calls(ENGINES["jax"])


def test_failures_end_streams_loudly(E):
    """A failed readback ends its streams with an error and the engine
    keeps serving; a failed prefill ends only its own stream."""
    mod = E[0]

    class _Flaky(_FakeModel):
        reads = 0

        def read_tokens(self, batch):
            self.reads += 1
            if self.reads == 3:
                raise RuntimeError("injected readback failure")
            return super().read_tokens(batch)

        def prefill(self, prompt, row, sampling=None):
            if len(prompt) >= 5:
                raise RuntimeError("injected prefill failure")
            return super().prefill(prompt, row, sampling)

    eng = mod.LLMEngine(_Flaky(num_blocks=32, max_blocks_per_seq=8),
                        overlap=True).start()
    try:
        h = eng.submit([4], 30)
        _drain([h])
        assert h.outcome == "error" and "tokens lost" in h.error
        assert h.tokens == _reference([4], len(h.tokens))
        assert _wait_freed(eng) == 0
        bad = eng.submit([1, 2, 3, 4, 5], 4)
        good = eng.submit([9], 5)
        _drain([bad, good])
        assert bad.outcome == "error" and "prefill failed" in bad.error
        assert good.outcome == "ok" and good.tokens == _reference([9], 5)
        assert _wait_freed(eng) == 0
    finally:
        eng.stop()


def test_sampling_lanes_are_isolated_and_seed_is_checkpointed(E):
    ref = _reference([5], 6, temp=1.0, seed=42)
    for neighbor in (dict(temperature=5.0, seed=123), dict(temperature=0.0)):
        eng = E[0].LLMEngine(_FakeModel(num_blocks=64,
                                        max_blocks_per_seq=8)).start()
        try:
            a = eng.submit([5], 6, sampling=dict(temperature=1.0, seed=42))
            b = eng.submit([7], 6, sampling=neighbor)
            _drain([a, b])
        finally:
            eng.stop()
        assert a.tokens == ref
    eng = E[0].LLMEngine(_FakeModel(num_blocks=32, max_blocks_per_seq=8,
                                    decode_delay=0.01)).start()
    try:
        h = eng.submit([3], 1000, sampling=dict(temperature=1.0, seed=77))
        while not h.tokens:
            time.sleep(0.005)
        assert eng.allocator.get_aux(h.id)["seed"] == 77
    finally:
        eng.stop()


@pytest.mark.parametrize("spec,env", [
    (None, None), (dict(temperature=0.8, top_k=40, top_p=0.9, seed=7), None),
    (None, "temperature=0.5,top_k=10"), (dict(temperature=0.0),
                                         "temperature=0.5,top_k=10"),
    ("temperature=0.3,seed=4", None)])
def test_parse_sampling_equals_jax(monkeypatch, spec, env):
    if env is None:
        monkeypatch.delenv("ZOO_LLM_SAMPLING", raising=False)
    else:
        monkeypatch.setenv("ZOO_LLM_SAMPLING", env)
    assert torch_engine.parse_sampling(spec, "rid-1") == \
        jax_engine.parse_sampling(spec, "rid-1")
    assert torch_engine.stream_seed("rid-1") == \
        jax_engine.stream_seed("rid-1")


@pytest.mark.parametrize("bad,match", [
    (dict(temp=1.0), "unknown sampling"), (dict(top_p=0.0), "top_p"),
    (dict(temperature=-1.0), "temperature"), ("temperature", "malformed")])
def test_parse_sampling_rejects_like_jax(monkeypatch, bad, match):
    monkeypatch.delenv("ZOO_LLM_SAMPLING", raising=False)
    for mod in (torch_engine, jax_engine):
        with pytest.raises(ValueError, match=match):
            mod.parse_sampling(bad, "r")
