"""Iteration-level (continuous) batching engine for autoregressive decode
(counterpart of ``zoo_tpu/serving/llm/engine.py``).

Every decode iteration the engine re-schedules: finished, expired and
aborted streams free their slot and KV blocks, waiting requests are
admitted into free slots the same tick, and the one fixed-shape decode
tick runs over whatever mix of old and new sequences the slots hold.

* **Overlapped tick pipeline** (``ZOO_LLM_OVERLAP``, default on): tick
  N+1's input tokens are tick N's on-device output, so the scheduler
  prepares the next tick while the device runs the current one and a
  readback thread streams each finished batch to its streams. At most
  two ticks are in flight; a lane whose slot was re-assigned between
  dispatch and readback is discarded (sampling is a pure function of
  seed and token index, so a discarded token is re-drawn identically).
* **Chunked prefill** (``ZOO_LLM_PREFILL_CHUNK``): prompts are fed in
  fixed-size chunks, at most one budget per tick, between decode ticks.
* **Preemption**: when a running sequence needs a block and the pool is
  dry, the youngest-admitted stream is evicted and re-queued with its
  prompt + generated tokens; its resumed stream is byte-identical.
* **Prefix cache** (``ZOO_LLM_PREFIX_CACHE``): a shared prompt prefix
  costs its KV blocks once, with copy-on-write of a shared last block.
* **Speculative decoding** (model ``spec_k`` / ``ZOO_LLM_SPEC_K``): the
  n-gram prompt-lookup drafter proposes up to k tokens a slot, one
  verify pass scores them, and the longest accepted prefix plus the
  model's own next token is emitted. Every emitted token is the one
  plain decode draws at its position, so speculative streams equal
  plain ones, greedy and seeded. Drafts are funded from free blocks
  only (never by preempting).
* Deadlines are checked at submission, admission and every scheduler
  pass; the waiting queue is bounded; a duplicate request id joins the
  live stream.

This copy leaves out the reference's tenancy (ROADMAP A.4), the
disaggregated handoff (A.5) and telemetry (A.6). Streams are read by
cursor; ``GenHandle.subscribe``/``unsubscribe`` count the readers, so
the serving door cancels a stream only when its last reader drops.
The model is any object with the
:class:`~zoo_tpu_torch.serving.llm.model.PagedLlamaModel` surface.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
import time
import zlib
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.serving.llm.kv_cache import (
    BlockAllocator,
    prefix_block_hashes,
)
from zoo_tpu_torch.serving.llm.speculative import PromptLookup, accept_length
from zoo_tpu_torch.util.resilience import Deadline, env_int


class AdmissionError(RuntimeError):
    """Retryable door rejection: the waiting queue is full."""

    def __init__(self, msg: str, retry_after_ms: int = 100):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms


def stream_seed(rid: str) -> int:
    """Deterministic per-stream seed from the request id, stable across
    processes, so a retry with the same id replays the same draws."""
    return zlib.crc32(rid.encode("utf-8")) & 0xFFFFFFFF


def parse_sampling(spec, rid: str) -> Tuple[float, int, float, int]:
    """Normalise a sampling request to ``(temperature, top_k, top_p,
    seed)``. ``spec``: None (greedy unless ``ZOO_LLM_SAMPLING`` sets
    defaults), a dict of ``temperature``/``top_k``/``top_p``/``seed``,
    or ``"temperature=0.8,top_k=40"``. A missing seed derives from the
    request id."""
    merged: Dict[str, float] = {}
    for source in (knob_value("ZOO_LLM_SAMPLING"), spec):
        if not source:
            continue
        if isinstance(source, str):
            parts = {}
            for kv in source.split(","):
                if not kv.strip():
                    continue
                if "=" not in kv:
                    raise ValueError(
                        f"malformed sampling component {kv!r} "
                        "(expected key=value)")
                k, v = kv.split("=", 1)
                parts[k.strip()] = v.strip()
            source = parts
        unknown = set(source) - {"temperature", "top_k", "top_p", "seed"}
        if unknown:
            raise ValueError(f"unknown sampling keys {sorted(unknown)}")
        merged.update(source)
    temp = float(merged.get("temperature", 0.0))
    topk = int(merged.get("top_k", 0))
    topp = float(merged.get("top_p", 1.0))
    if temp < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temp}")
    if not (0.0 < topp <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {topp}")
    seed = int(merged["seed"]) & 0xFFFFFFFF if "seed" in merged \
        else stream_seed(rid)
    return temp, topk, topp, seed


class GenHandle:
    """One stream: the scheduler appends tokens, any number of readers
    follow them by cursor (frames are never consumed destructively)."""

    def __init__(self, rid: str, prompt: np.ndarray, max_new: int,
                 deadline: Optional[Deadline],
                 sampling: Tuple[float, int, float, int] = None,
                 spec_k: Optional[int] = None):
        self.id = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = int(max_new)
        self.deadline = deadline
        # speculative budget: None = the engine's, 0 = no drafts (the
        # stream still rides the verify pass with an empty draft), 1..k
        # a cap
        self.spec_k = spec_k
        # the drafter's incremental index, built at the first draft and
        # extended as tokens land (engine-owned, under its lock)
        self.lookup: Optional[PromptLookup] = None
        self.lookup_len = 0   # generated tokens already indexed
        self.sampling = sampling if sampling is not None else \
            (0.0, 0, 1.0, stream_seed(rid))
        self.tokens: List[int] = []
        self.outcome: Optional[str] = None   # None = live
        self.error: Optional[str] = None
        self.truncated = False
        self.created = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.preempts = 0
        self.cancelled = threading.Event()
        self._cond = threading.Condition()
        self._subs = 0            # streaming readers (subscribe)
        # scheduler-side state (owned by the engine under its lock)
        self.gen_count = 0        # tokens applied so far
        self.sched_count = 0      # tokens dispatched (>= gen_count)
        self.admit_seq = -1       # admission order (preempt youngest)
        self.effective_prompt: Optional[np.ndarray] = None  # after a
        #                           preemption: prompt + generated
        self.block_hashes: list = []
        self.hashed_len = -1
        self.cache_hit_tokens = 0

    @property
    def done(self) -> bool:
        return self.outcome is not None

    def push(self, tok: int):
        with self._cond:
            self.tokens.append(int(tok))
            now = time.perf_counter()
            if self.first_token_at is None:
                self.first_token_at = now
            self.last_token_at = now
            self._cond.notify_all()

    def finish(self, outcome: str, error: Optional[str] = None):
        with self._cond:
            if self.outcome is not None:
                return
            self.outcome = outcome
            self.error = error
            # finished handles live on in the dedup LRU: drop the index
            self.lookup = None
            self._cond.notify_all()

    def cancel(self):
        """Client-side abort: the scheduler frees the slot and blocks at
        its next sweep."""
        self.cancelled.set()
        with self._cond:
            self._cond.notify_all()

    def wait_new(self, cursor: int, timeout: Optional[float]) -> tuple:
        """Block until tokens beyond ``cursor`` exist or the stream
        ends. Returns ``(new_tokens, done)``; both empty/False on
        timeout."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if len(self.tokens) > cursor:
                    return self.tokens[cursor:], self.outcome is not None
                if self.outcome is not None:
                    return [], True
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    return [], False
                self._cond.wait(rem if rem is None or rem < 0.5 else 0.5)

    def subscribe(self) -> int:
        """Register a streaming reader (a server handler, a joined
        duplicate, a hedge). The stream is only auto-cancelled when the
        LAST reader drops — a hedge loser's disconnect must not kill
        the winner's stream."""
        with self._cond:
            self._subs += 1
            return self._subs

    def unsubscribe(self) -> int:
        with self._cond:
            self._subs -= 1
            return self._subs

    def ttft(self) -> Optional[float]:
        return None if self.first_token_at is None else \
            self.first_token_at - self.created


class _Slot:
    __slots__ = ("handle", "last_token", "position", "phase",
                 "prefill_pos", "epoch", "host_token", "use_host",
                 "pending_copy", "spec_inflight")

    def __init__(self):
        self.handle: Optional[GenHandle] = None
        self.last_token = 0
        self.spec_inflight = False  # a verify pass for this seat is
        #                           dispatched and not applied yet
        self.position = 0        # cache index the NEXT token is written at
        self.phase = "decode"    # "prefill" while chunks are pending
        self.prefill_pos = 0     # prompt tokens already fed
        self.pending_copy = None  # (src, dst) CoW copy owed before the
        #                           slot's next prefill write
        self.epoch = 0           # bumped whenever the slot is cleared:
        #                           older in-flight lanes are discarded
        self.host_token = 0      # prefill token for the first decode
        self.use_host = False    # next tick feeds host_token


class LLMEngine:
    """``LLMEngine(model).start()`` -> ``submit()`` streams until
    ``stop()``. ``mode="oneshot"`` is the request-level baseline: a wave
    is admitted only when every slot is empty. ``overlap=None`` reads
    ``ZOO_LLM_OVERLAP`` (continuous mode only). ``spec_k=None`` takes
    the model's verify width, and any value is clamped to it (0 runs
    plain decode on a speculative model); ``spec_ngram=None`` reads
    ``ZOO_LLM_SPEC_NGRAM``. ``role=None`` reads ``ZOO_LLM_ROLE``: the
    replica's role in a disaggregated pool, advertised on every reply
    frame; only ``mixed`` is served until ROADMAP A.5 ports the
    prefill/decode handoff."""

    def __init__(self, model, mode: str = "continuous",
                 max_waiting: Optional[int] = None,
                 overlap: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 role: Optional[str] = None):
        if mode not in ("continuous", "oneshot"):
            raise ValueError(f"unknown scheduling mode {mode!r}")
        if role is None:
            role = knob_value("ZOO_LLM_ROLE")
        if role in ("prefill", "decode"):
            raise ValueError(
                f"replica role {role!r} needs the prefill/decode KV "
                "handoff, which the port does not have yet (ROADMAP A.5, "
                "disaggregation); serve role 'mixed'")
        if role != "mixed":
            raise ValueError(
                f"unknown replica role {role!r} (expected prefill, "
                "decode, or mixed)")
        self.role = role
        self.model = model
        self.mode = mode
        model_k = int(getattr(model, "spec_k", 0) or 0)
        self.spec_k = max(0, min(model_k if spec_k is None else int(spec_k),
                                 model_k))
        self._spec = self.spec_k > 0 and hasattr(model, "verify_step")
        if spec_ngram is None:
            spec_ngram = knob_value("ZOO_LLM_SPEC_NGRAM")
        self.spec_ngram = max(1, int(spec_ngram))
        self._spec_lanes = 0           # verify lanes applied
        self._spec_drafted_lanes = 0   # ... with a non-empty draft
        self._spec_proposed_n = 0
        self._spec_accepted_n = 0
        if overlap is None:
            overlap = knob_value("ZOO_LLM_OVERLAP")
        self.overlap = bool(overlap) and mode == "continuous"
        if prefix_cache is None:
            prefix_cache = knob_value("ZOO_LLM_PREFIX_CACHE")
        self.prefix_cache = bool(prefix_cache)
        self.max_waiting = max_waiting if max_waiting is not None else \
            env_int("ZOO_LLM_MAX_WAITING", 256)
        self.allocator = BlockAllocator(model.num_blocks, model.block_size,
                                        prefix_cache=self.prefix_cache)
        self._hit_tokens = 0
        self._miss_tokens = 0
        self._preempt_count = 0
        self._slots = [_Slot() for _ in range(model.num_slots)]
        self._wait: Deque[GenHandle] = collections.deque()  # guarded-by: _lock
        # ONE reentrant state lock: the scheduler holds it across each
        # pass, the readback thread while applying a batch
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._admit_counter = 0
        # id -> handle for live streams plus an LRU of finished ones
        self._by_id: "collections.OrderedDict[str, GenHandle]" = \
            collections.OrderedDict()   # guarded-by: _lock
        self._finished_cap = env_int("ZOO_LLM_FINISHED_CACHE", 256)
        self._decode_steps = 0
        self._generated = 0
        self._chunk = int(getattr(model, "prefill_chunk_size", 0) or 0)
        self._prefill_budget = env_int("ZOO_LLM_PREFILL_BUDGET",
                                       self._chunk) if self._chunk else 0
        self._rbq: "_queue.Queue" = _queue.Queue()
        self._inflight = threading.Semaphore(2)
        self._rb_thread: Optional[threading.Thread] = None
        # set when a dispatch or readback failed: the device token chain
        # must be re-seeded from host state before the next dispatch
        self._chain_broken = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LLMEngine":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zoo-llm-scheduler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # everything still live is cancelled and its blocks freed: the
        # pool accounts to zero on shutdown
        with self._lock:
            live = [s.handle for s in self._slots if s.handle] + \
                list(self._wait)
            self._wait.clear()
            for s in self._slots:
                s.handle = None
                s.epoch += 1
        for h in live:
            self.allocator.free(h.id)
            h.finish("cancelled", "engine stopped")

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, rid: Optional[str] = None,
               deadline: Optional[Deadline] = None,
               sampling=None, spec_k: Optional[int] = None) -> GenHandle:
        """Queue one generation (``sampling`` as :func:`parse_sampling`;
        ``spec_k`` caps this stream's drafts, None = the engine's, 0 =
        none, and never raises the engine's width). Raises
        :class:`AdmissionError` when the waiting queue is full and
        ``ValueError`` for a prompt no prefill path can hold."""
        if spec_k is not None and int(spec_k) < 0:
            raise ValueError("spec_k must be >= 0")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self.model.max_prompt_len:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prefill capacity ({self.model.max_prompt_len})")
        usable = self.allocator.num_blocks - 1
        if self.allocator.blocks_for_tokens(prompt.size + 1) > usable:
            raise ValueError(
                f"prompt of {prompt.size} tokens needs more KV blocks "
                f"than the whole pool holds ({usable} usable x "
                f"{self.allocator.block_size} tokens)")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if rid is None:
            import uuid
            rid = uuid.uuid4().hex
        params = parse_sampling(sampling, rid)
        with self._lock:
            prior = self._by_id.get(rid)
            if prior is not None:
                return prior   # a duplicate id joins the live stream
            if len(self._wait) >= self.max_waiting:
                raise AdmissionError(
                    f"llm waiting queue full ({len(self._wait)} streams, "
                    f"bound {self.max_waiting}); retry another replica",
                    retry_after_ms=200)
            h = GenHandle(rid, prompt, max_new_tokens, deadline,
                          sampling=params,
                          spec_k=None if spec_k is None else int(spec_k))
            self._by_id[rid] = h
            self._trim_finished_locked()
            self._wait.append(h)
        self._wake.set()
        return h

    def get(self, rid: str) -> Optional[GenHandle]:
        with self._lock:
            return self._by_id.get(rid)

    def cancel(self, rid: str) -> bool:
        h = self.get(rid)
        if h is None or h.done:
            return False
        h.cancel()
        self._wake.set()
        return True

    def _trim_finished_locked(self):
        while len(self._by_id) > self._finished_cap:
            for k, h in self._by_id.items():
                if h.done:
                    del self._by_id[k]
                    break
            else:
                return

    # -- scheduler ---------------------------------------------------------
    def _finish_slot(self, slot: _Slot, outcome: str,
                     error: Optional[str] = None):
        h = slot.handle
        slot.handle = None
        slot.epoch += 1   # any in-flight lane for this seat is stale now
        slot.spec_inflight = False
        self.allocator.free(h.id)
        h.finish(outcome, error)

    def _expired(self, h: GenHandle) -> bool:
        return h.deadline is not None and h.deadline.expired()

    def _sweep(self):
        """Free slots whose stream ended out of band (client cancel,
        deadline expiry)."""
        for slot in self._slots:
            h = slot.handle
            if h is None:
                continue
            if h.cancelled.is_set():
                self._finish_slot(slot, "cancelled", "stream aborted")
            elif self._expired(h):
                self._finish_slot(
                    slot, "expired",
                    "deadline expired mid-stream (generation stopped, "
                    f"{h.gen_count} tokens emitted)")

    def _admit(self):
        if self.mode == "oneshot" and any(s.handle is not None
                                          for s in self._slots):
            return
        for slot in self._slots:
            if slot.handle is not None:
                continue
            with self._lock:
                h = self._wait.popleft() if self._wait else None
            if h is None:
                break
            if h.cancelled.is_set():
                h.finish("cancelled", "aborted while queued")
                continue
            if self._expired(h):
                h.finish("expired", "deadline expired in the waiting "
                                    "queue (never admitted)")
                continue
            prompt = h.effective_prompt if h.effective_prompt \
                is not None else h.prompt
            if self.allocator.blocks_for_tokens(len(prompt) + 1) > \
                    self.allocator.num_blocks - 1:
                h.finish("error",
                         f"resumed context of {len(prompt)} tokens "
                         "exceeds the whole KV pool")
                continue
            # prefix cache: hash the prompt's full blocks and probe for
            # the longest cached run; the LAST prompt token is always
            # recomputed (its forward produces the first generated token)
            hashes = []
            if self.prefix_cache:
                if h.block_hashes and h.hashed_len == len(prompt):
                    hashes = h.block_hashes
                else:
                    hashes = prefix_block_hashes(prompt,
                                                 self.allocator.block_size)
                    h.block_hashes = hashes
                    h.hashed_len = len(prompt)
            matched = self.allocator.match_prefix(hashes)
            start = min(matched * self.allocator.block_size,
                        len(prompt) - 1)
            if not self.allocator.can_admit(
                    len(prompt), cached_blocks=matched,
                    needs_cow=matched * self.allocator.block_size > start):
                # KV pressure: requeue at the head, stop admitting
                with self._lock:
                    self._wait.appendleft(h)
                break
            if not self._bind_blocks(slot, h, prompt, hashes):
                with self._lock:
                    self._wait.appendleft(h)
                break
            self.allocator.set_aux(h.id, seed=h.sampling[3],
                                   resumed_at=len(prompt))
            slot.handle = h
            slot.epoch += 1
            self._admit_counter += 1
            h.admit_seq = self._admit_counter
            h.admitted_at = time.perf_counter()
            # admission only BINDS; the device prefill runs in
            # _prefill_tick outside the engine lock
            slot.phase = "prefill"
            slot.prefill_pos = h.cache_hit_tokens
            slot.position = 0

    def _bind_blocks(self, slot: _Slot, h: GenHandle, prompt: np.ndarray,
                     hashes: list) -> bool:
        """Acquire the cached prefix, allocate the private remainder and
        fork the last matched block when the recompute write lands in it
        (the device copy is owed via ``slot.pending_copy``). False, with
        everything released, on an allocation race."""
        bs = self.allocator.block_size
        got = self.allocator.acquire_prefix(h.id, hashes)
        start = min(len(got) * bs, len(prompt) - 1)
        need = self.allocator.blocks_for_tokens(len(prompt)) - len(got)
        if need > 0 and self.allocator.allocate(h.id, need) is None:
            self.allocator.free(h.id)
            return False
        slot.pending_copy = None
        if len(got) * bs > start:
            try:
                slot.pending_copy = self.allocator.make_writable(
                    h.id, len(got) - 1)
            except MemoryError:
                self.allocator.free(h.id)
                return False
        h.cache_hit_tokens = start
        if self.prefix_cache:
            self._hit_tokens += start
            self._miss_tokens += len(prompt) - start
        return True

    def _enter_decode(self, slot: _Slot, h: GenHandle, first: int,
                      prompt_len: int):
        """Prompt fully prefilled: publish its blocks to the prefix
        cache, push the first token and arm the decode chain."""
        self.allocator.register_blocks(h.id, h.block_hashes)
        slot.phase = "decode"
        slot.position = prompt_len
        slot.last_token = first
        slot.host_token = first
        slot.use_host = True
        h.push(first)
        h.gen_count += 1
        h.sched_count += 1
        self._generated += 1
        eos = getattr(self.model, "eos_id", None)
        if h.gen_count >= h.max_new or (eos is not None and first == eos):
            self._finish_slot(slot, "ok")

    def _select_prefill(self) -> List[tuple]:
        """Under the lock: claim this tick's prefill work (whole prompts,
        or up to one budget of chunks, oldest admission first)."""
        pending = sorted((s for s in self._slots
                          if s.handle is not None and s.phase == "prefill"),
                         key=lambda s: s.handle.admit_seq)
        budget = self._prefill_budget if self._chunk else None
        work = []
        for slot in pending:
            h = slot.handle
            prompt = h.effective_prompt if h.effective_prompt \
                is not None else h.prompt
            n = len(prompt)
            start = slot.prefill_pos
            if start >= n:
                continue
            if budget is None:
                take = n - start
            else:
                if budget <= 0:
                    break
                take = min(self._chunk, n - start)
                budget -= take
            slot.prefill_pos = start + take
            copy = slot.pending_copy
            slot.pending_copy = None
            work.append((slot, h, slot.epoch, prompt, start, take, n,
                         self._table_row(self.allocator.blocks_of(h.id)),
                         copy))
        return work

    def _run_prefill(self, work) -> List[tuple]:
        """OUTSIDE the lock: run the claimed prefill device calls."""
        results = []
        for slot, h, epoch, prompt, start, take, n, row, copy in work:
            try:
                if copy is not None:
                    # the copy-on-write copy owed from admission, before
                    # this sequence's first write lands in the fork
                    self.model.copy_block(*copy)
                if self._chunk:
                    tok = self.model.prefill_chunk(
                        prompt[start:start + take], start, n, row,
                        sampling=h.sampling)
                elif start == 0:
                    tok = self.model.prefill(prompt, row,
                                             sampling=h.sampling)
                else:
                    # cache-hit prompt with buckets: feed the uncached
                    # suffix through the chunk path
                    C = int(getattr(self.model, "suffix_chunk_size", 0)
                            or self.model.block_size)
                    tok = None
                    for s0 in range(start, start + take, C):
                        tok = self.model.prefill_chunk(
                            prompt[s0:min(s0 + C, n)], s0, n, row,
                            sampling=h.sampling)
            except Exception as e:  # noqa: BLE001 — a prefill failure
                # ends THIS stream loudly, not the scheduler thread
                results.append((slot, h, epoch, start, take, n, None, e))
                continue
            results.append((slot, h, epoch, start, take, n, tok, None))
        return results

    def _apply_prefill(self, results):
        """Under the lock: land prefill results; a slot that moved on
        while the device ran is skipped."""
        for slot, h, epoch, start, take, n, tok, err in results:
            if slot.handle is not h or slot.epoch != epoch or h.done:
                continue
            if err is not None:
                self._finish_slot(slot, "error", f"prefill failed: {err!r}")
                continue
            if start + take >= n:
                self._enter_decode(slot, h, tok, n)

    def _prefill_tick(self):
        with self._lock:
            work = self._select_prefill()
        if not work:
            return
        results = self._run_prefill(work)
        with self._lock:
            self._apply_prefill(results)

    def _table_row(self, blocks: Sequence[int]) -> np.ndarray:
        row = np.zeros((self.model.max_blocks_per_seq,), np.int32)
        row[:len(blocks)] = blocks
        return row

    def _grow_or_preempt(self) -> None:
        """Every decoding slot must own the block its next write lands
        in; when the pool is dry, evict the youngest-admitted stream."""
        bs = self.model.block_size
        for slot in self._slots:
            h = slot.handle
            if h is None or slot.phase != "decode":
                continue
            needed = slot.position // bs + 1
            while True:
                if needed > self.model.max_blocks_per_seq:
                    # the context ceiling: a truncated-but-successful
                    # stream, once every dispatched token is applied
                    if h.sched_count == h.gen_count:
                        h.truncated = True
                        self._finish_slot(slot, "ok")
                    break
                if len(self.allocator.blocks_of(h.id)) >= needed:
                    break
                if self.allocator.allocate(h.id, 1) is not None:
                    continue
                victim = self._pick_victim(exclude=h)
                if victim is None:
                    self._finish_slot(
                        slot, "error",
                        "kv cache exhausted: sequence cannot grow and no "
                        "other stream is preemptible")
                    break
                self._preempt(victim)

    def _pick_victim(self, exclude: GenHandle) -> Optional[_Slot]:
        """The youngest-admitted other stream."""
        best = None
        for slot in self._slots:
            if slot.handle is None or slot.handle is exclude:
                continue
            if best is None or slot.handle.admit_seq > best.handle.admit_seq:
                best = slot
        return best

    def _preempt(self, slot: _Slot):
        """Evict a running stream: free its blocks and requeue it with
        prompt := prompt + everything applied so far. Decode is a pure
        function of (seed, token index), so the resumed continuation is
        what the stream would have produced."""
        h = slot.handle
        resumed = np.concatenate([h.prompt, np.asarray(h.tokens, np.int32)])
        if len(resumed) > self.model.max_prompt_len:
            h.truncated = True
            self._finish_slot(slot, "ok")
            return
        h.effective_prompt = resumed
        h.sched_count = h.gen_count
        h.preempts += 1
        self._preempt_count += 1
        slot.handle = None
        slot.epoch += 1
        slot.spec_inflight = False
        self.allocator.free(h.id)
        with self._lock:
            self._wait.appendleft(h)

    def _build_tick(self, device_chain: bool):
        """Assemble the fixed-shape decode operands (one lane per slot;
        idle lanes write to the trash block and are never read).
        ``device_chain`` feeds continuing lanes from the previous tick's
        device batch. Advances positions and dispatch counters. None
        when no lane decodes."""
        m = self.model
        S = m.num_slots
        host = np.zeros((S,), np.int32)
        use = np.zeros((S,), bool)
        tables = np.zeros((S, m.max_blocks_per_seq), np.int32)
        positions = np.zeros((S,), np.int32)
        temps = np.zeros((S,), np.float32)
        topks = np.zeros((S,), np.int32)
        topps = np.ones((S,), np.float32)
        seeds = np.zeros((S,), np.uint32)
        ctx = m.max_blocks_per_seq * m.block_size
        snapshot = []
        for i, slot in enumerate(self._slots):
            h = slot.handle
            if h is None or slot.phase != "decode" or h.done:
                continue
            if h.sched_count >= h.max_new or slot.position >= ctx:
                continue   # all dispatched: idles until readback settles
            snapshot.append((i, h, slot.epoch))
            tables[i] = self._table_row(self.allocator.blocks_of(h.id))
            positions[i] = slot.position
            if device_chain:
                if slot.use_host:
                    use[i] = True
                    host[i] = slot.host_token
                    slot.use_host = False
            else:
                use[i] = True
                host[i] = slot.last_token
            temps[i], topks[i], topps[i], seeds[i] = h.sampling
            slot.position += 1
            h.sched_count += 1
        if not snapshot:
            return None
        return (host, use, tables, positions,
                (temps, topks, topps, seeds), snapshot)

    def _fail_lanes(self, snapshot, err: BaseException):
        """A dispatched batch's tokens are lost: end its streams loudly
        and have the device chain re-seeded. Under the lock. A decode
        lane is (slot, handle, epoch); a verify lane adds its draft."""
        for i, h, epoch, *_ in snapshot:
            slot = self._slots[i]
            if slot.handle is h and slot.epoch == epoch and not h.done:
                self._finish_slot(
                    slot, "error",
                    f"decode tick failed, stream tokens lost: {err!r}")
        self._chain_broken = True

    def _apply_tokens(self, snapshot, arr: np.ndarray):
        """Apply one readback batch; lanes whose slot moved on are
        discarded."""
        eos = getattr(self.model, "eos_id", None)
        for i, h, epoch in snapshot:
            slot = self._slots[i]
            if slot.handle is not h or slot.epoch != epoch or h.done:
                continue
            tok = int(arr[i])
            slot.last_token = tok
            h.push(tok)
            h.gen_count += 1
            self._generated += 1
            if h.gen_count >= h.max_new or (eos is not None and tok == eos):
                self._finish_slot(slot, "ok")

    def _decode_tick(self) -> bool:
        """The synchronous tick: host-fed lanes, blocking readback."""
        with self._lock:
            built = self._build_tick(device_chain=False)
        if built is None:
            return False
        host, use, tables, positions, lanes, snapshot = built
        try:
            batch = self.model.decode_step(None, host, use, tables,
                                           positions, lanes)
            arr = self.model.read_tokens(batch)
        except Exception as e:  # noqa: BLE001 — lost tokens end their
            # streams loudly instead of leaving a hole and a wedged slot
            with self._lock:
                self._fail_lanes(snapshot, e)
            return True
        self._decode_steps += 1
        with self._lock:
            self._apply_tokens(snapshot, arr)
        return True

    # -- speculative decoding ----------------------------------------------
    def _draft_for(self, h: GenHandle) -> np.ndarray:
        """Up to the stream's budget of drafted tokens continuing prompt +
        generated (which ends with the verify pass's row 0), from the
        stream's incremental prompt-lookup index. Under the lock."""
        k = self.spec_k if h.spec_k is None else min(h.spec_k, self.spec_k)
        if k <= 0:
            return np.zeros((0,), np.int32)
        if h.lookup is None:
            h.lookup = PromptLookup(h.prompt, self.spec_ngram)
        if h.lookup_len < len(h.tokens):
            h.lookup.extend(h.tokens[h.lookup_len:])
            h.lookup_len = len(h.tokens)
        return h.lookup.propose(k)

    def _build_spec_tick(self):
        """Under the lock: one fixed-shape verify batch, (slots, spec_k +
        1) rows, row 0 the incoming token and rows 1.. the draft,
        zero-padded. The draft is funded from free blocks only
        (``grow_to``) and clamped to owned blocks, the context and the
        stream's remaining budget, so every token the accept step can
        emit has a real cache row. A seat whose verify pass is still in
        flight idles: the accept length decides its next position. None
        when no lane verifies."""
        m = self.model
        S, T = m.num_slots, self.spec_k + 1
        ctx = m.max_blocks_per_seq * m.block_size
        tokens = np.zeros((S, T), np.int32)
        tables = np.zeros((S, m.max_blocks_per_seq), np.int32)
        positions = np.zeros((S,), np.int32)
        temps = np.zeros((S,), np.float32)
        topks = np.zeros((S,), np.int32)
        topps = np.ones((S,), np.float32)
        seeds = np.zeros((S,), np.uint32)
        snapshot = []
        for i, slot in enumerate(self._slots):
            h = slot.handle
            if h is None or slot.phase != "decode" or h.done or \
                    slot.spec_inflight:
                continue
            if h.sched_count >= h.max_new or slot.position >= ctx:
                continue
            draft = self._draft_for(h)
            if len(draft):
                cap_tokens = self.allocator.grow_to(
                    h.id, min(slot.position + len(draft) + 1, ctx))
                cap = min(cap_tokens - 1 - slot.position,
                          ctx - 1 - slot.position,
                          h.max_new - h.gen_count - 1)
                draft = draft[:max(0, cap)]
            tokens[i, 0] = slot.last_token
            tokens[i, 1:1 + len(draft)] = draft
            tables[i] = self._table_row(self.allocator.blocks_of(h.id))
            positions[i] = slot.position
            temps[i], topks[i], topps[i], seeds[i] = h.sampling
            slot.spec_inflight = True
            snapshot.append((i, h, slot.epoch, [int(x) for x in draft]))
        if not snapshot:
            return None
        return (tokens, tables, positions, (temps, topks, topps, seeds),
                snapshot)

    def _apply_spec(self, snapshot, arr: np.ndarray):
        """Apply one verify readback: each lane emits its longest accepted
        draft prefix plus the model's own next token (``arr[i, j]`` is the
        canonical token after the draft's first ``j`` tokens), stopping at
        eos or the budget. A lane whose slot moved on is discarded."""
        eos = getattr(self.model, "eos_id", None)
        for i, h, epoch, draft in snapshot:
            slot = self._slots[i]
            if slot.handle is not h or slot.epoch != epoch or h.done:
                continue
            slot.spec_inflight = False
            out = arr[i]
            accept = accept_length(draft, out)
            self._spec_lanes += 1
            if draft:
                self._spec_drafted_lanes += 1
                self._spec_proposed_n += len(draft)
                self._spec_accepted_n += accept
            for tok in (int(t) for t in out[:accept + 1]):
                slot.position += 1
                slot.last_token = tok
                h.push(tok)
                h.gen_count += 1
                h.sched_count = h.gen_count
                self._generated += 1
                if h.gen_count >= h.max_new or (eos is not None and
                                                tok == eos):
                    self._finish_slot(slot, "ok")
                    break

    def _spec_tick(self) -> bool:
        """The synchronous verify tick: build, dispatch, block on the
        readback, apply."""
        with self._lock:
            built = self._build_spec_tick()
        if built is None:
            return False
        tokens, tables, positions, lanes, snapshot = built
        try:
            batch = self.model.verify_step(tokens, tables, positions, lanes)
            arr = self.model.read_tokens(batch)
        except Exception as e:  # noqa: BLE001 — lost lanes end their
            # streams loudly, as a decode tick's do
            with self._lock:
                self._fail_lanes(snapshot, e)
            return True
        self._decode_steps += 1
        with self._lock:
            self._apply_spec(snapshot, arr)
        return True

    # -- overlap pipeline --------------------------------------------------
    def _readback_loop(self):
        while True:
            item = self._rbq.get()
            if item is None:
                return
            kind, batch, snapshot = item
            try:
                arr = self.model.read_tokens(batch)
            except Exception as e:  # noqa: BLE001 — these lanes' tokens
                # are gone: end the streams, re-seed the device chain
                with self._lock:
                    self._fail_lanes(snapshot, e)
                self._inflight.release()
                self._wake.set()
                continue
            with self._lock:
                if kind == "spec":
                    self._apply_spec(snapshot, arr)
                else:
                    self._apply_tokens(snapshot, arr)
            self._decode_steps += 1
            self._inflight.release()
            self._wake.set()

    def _loop_overlapped(self):
        """Dispatch tick N, then schedule tick N+1 while the device runs
        and the readback thread streams tick N-1 out. Continuing lanes
        consume tick N's on-device batch."""
        self._rb_thread = threading.Thread(
            target=self._readback_loop, daemon=True,
            name="zoo-llm-readback")
        self._rb_thread.start()
        prev_batch = None
        try:
            while not self._stop.is_set():
                with self._lock:
                    broken = self._chain_broken
                if broken:
                    # drain the pipeline, then re-seed surviving decode
                    # slots from their last APPLIED token
                    grabbed = 0
                    while grabbed < 2 and not self._stop.is_set():
                        if self._inflight.acquire(timeout=0.5):
                            grabbed += 1
                    with self._lock:
                        self._chain_broken = False
                        for slot in self._slots:
                            if slot.handle is not None and \
                                    slot.phase == "decode":
                                slot.use_host = True
                                slot.host_token = slot.last_token
                    prev_batch = None
                    for _ in range(grabbed):
                        self._inflight.release()
                    if self._stop.is_set():
                        return
                with self._lock:
                    self._sweep()
                    self._admit()
                self._prefill_tick()
                with self._lock:
                    self._grow_or_preempt()
                    built = self._build_spec_tick() if self._spec \
                        else self._build_tick(device_chain=True)
                if built is None:
                    prev_batch = None
                    self._wake.wait(0.005)
                    self._wake.clear()
                    continue
                while not self._inflight.acquire(timeout=0.5):
                    if self._stop.is_set():
                        return
                if self._spec:
                    # verify passes are host-fed and never chain on the
                    # device (the accept length decides each seat's next
                    # position); every ready seat rides one pass, so in
                    # steady state one pass is in flight, and a seat
                    # entering decode mid-pass rides a second
                    tokens, tables, positions, lanes, snapshot = built
                    try:
                        batch = self.model.verify_step(
                            tokens, tables, positions, lanes)
                    except Exception as e:  # noqa: BLE001
                        with self._lock:
                            self._fail_lanes(snapshot, e)
                        self._inflight.release()
                        continue
                    self._rbq.put(("spec", batch, snapshot))
                    prev_batch = None
                    continue
                host, use, tables, positions, lanes, snapshot = built
                try:
                    prev_batch = self.model.decode_step(
                        prev_batch, host, use, tables, positions, lanes)
                except Exception as e:  # noqa: BLE001 — fail the built
                    # lanes loudly and re-seed instead of dying
                    with self._lock:
                        self._fail_lanes(snapshot, e)
                    self._inflight.release()
                    continue
                self._rbq.put(("decode", prev_batch, snapshot))
        finally:
            self._rbq.put(None)
            if self._rb_thread is not None:
                self._rb_thread.join(timeout=10)

    def _loop_sync(self):
        while not self._stop.is_set():
            with self._lock:
                self._sweep()
                self._admit()
            self._prefill_tick()
            with self._lock:
                self._grow_or_preempt()
            if not (self._spec_tick() if self._spec else
                    self._decode_tick()):
                # also parks the loop while the queue is only KV-gated
                self._wake.wait(0.005)
                self._wake.clear()

    def _loop(self):
        if self.overlap:
            self._loop_overlapped()
        else:
            self._loop_sync()

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict:
        m = self.model
        out = {"mode": self.mode,
               "role": self.role,
               "overlap": self.overlap,
               "slots": m.num_slots,
               "prefill_chunk": self._chunk,
               "decode_attention_impl": getattr(
                   m, "decode_attention_impl", "host"),
               "prefill_attention_impl": getattr(
                   m, "prefill_attention_impl", "host"),
               "kv_cache_dtype": getattr(m, "kv_cache_dtype", "f32"),
               "kv_bytes_per_token": getattr(m, "kv_bytes_per_token", None),
               "prefix_cache": self.prefix_cache,
               "prefix_hit_tokens": self._hit_tokens,
               "prefix_miss_tokens": self._miss_tokens,
               "preempts": self._preempt_count,
               "active": sum(1 for s in self._slots if s.handle),
               "waiting": len(self._wait),
               "decode_steps": self._decode_steps,
               "generated_tokens": self._generated,
               "spec_k": self.spec_k if self._spec else 0,
               "spec_ngram": self.spec_ngram,
               "spec_proposed_tokens": self._spec_proposed_n,
               "spec_accepted_tokens": self._spec_accepted_n,
               "spec_accept_rate": (
                   self._spec_accepted_n / self._spec_proposed_n
                   if self._spec_proposed_n else 0.0),
               "spec_draft_hit_rate": (
                   self._spec_drafted_lanes / self._spec_lanes
                   if self._spec_lanes else 0.0)}
        out.update(self.allocator.stats())
        if hasattr(m, "compile_counts"):
            out["compiles"] = m.compile_counts()
        return out
