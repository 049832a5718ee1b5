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
* **Tenancy** (``tenancy=`` / ``ZOO_TENANT_CONFIG``, see
  :mod:`zoo_tpu_torch.serving.tenancy`): each tenant's token bucket
  gates submission with its own retry hint; the next waiter is the
  lowest priority class, then the lowest served tokens / weight, then
  FIFO, skipping tenants over their slot or KV quota; a waiter of a
  higher class preempts the youngest stream of the lowest class; the
  prefix cache is salted and partitioned per tenant. Without a config
  every decision is the single-tenant FIFO one.
* **Disaggregation** (``role=`` / ``ZOO_LLM_ROLE``): a ``handoff``
  stream prefills only and parks its blocks for the door to push to a
  decode replica (:meth:`LLMEngine.take_handoff`); a staged
  ``kv_migrate`` payload (:meth:`LLMEngine.offer_adopted`) is bound at
  admission and enters decode with the prefill seat's first token,
  running no prefill call here.

Telemetry is the reference's: the ``zoo_llm_*`` and ``zoo_tenant_*``
families, the ``llm.stream`` / ``llm.prefill`` spans and the
``llm.admit`` / ``llm.first_token`` / ``llm.preempt`` events under each
stream's request trace id (``GenHandle.trace_id``), and the flight-ring
records (``llm_stream_end``, ``tenant_shed``, ``engine_tick`` every
128th decode step, ``kv_handoff_abort``, ``kv_migrate_out``/``_in``,
``llm_preempt``). All of it is host work outside the tick's device
calls: none adds a device sync. Streams are read by cursor; ``GenHandle.subscribe``/``unsubscribe``
count the readers, so the serving door cancels a stream only when its
last reader drops.
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
from zoo_tpu_torch.obs.flight import record_event
from zoo_tpu_torch.obs.metrics import counter, gauge, histogram
from zoo_tpu_torch.obs.tracing import emit_event, emit_span
from zoo_tpu_torch.serving.llm.kv_cache import (
    BlockAllocator,
    prefix_block_hashes,
)
from zoo_tpu_torch.serving.llm.speculative import PromptLookup, accept_length
from zoo_tpu_torch.serving.tenancy import registry as tenant_registry
from zoo_tpu_torch.util.resilience import Deadline, env_int

_tokens = counter(
    "zoo_llm_tokens_total", "Tokens processed by the LLM engine "
    "(prefill = prompt tokens, decode = generated tokens)",
    labels=("kind",))
_steps = counter(
    "zoo_llm_decode_steps_total",
    "Fixed-shape decode iterations executed")
_ttft = histogram(
    "zoo_llm_ttft_seconds",
    "Time from stream submission to its first generated token")
# per-stream token-cadence families: tick-phase
# timing says how busy the ENGINE is; these say what each REQUEST
# experienced — the p99s the SLO watchdog burns against
_inter_token = histogram(
    "zoo_llm_inter_token_seconds",
    "Gap between consecutive generated tokens of one stream, as "
    "observed at the engine's readback (what a streaming client feels "
    "between frames)")
_stream_ttft = histogram(
    "zoo_llm_stream_ttft_seconds",
    "Per-stream time-to-first-token by final outcome (streams that "
    "never produced a token observe their full lifetime under their "
    "terminal outcome)", labels=("outcome",))
_occupancy = gauge(
    "zoo_llm_slot_occupancy",
    "Decode slots holding a live sequence right now")
_waiting = gauge(
    "zoo_llm_waiting_streams", "Streams queued behind admission "
    "(no free slot or no free KV blocks)")
_preempts = counter(
    "zoo_llm_preempt_total",
    "Running streams evicted to free KV blocks (re-queued, resumed by "
    "re-prefill)")
_streams = counter(
    "zoo_llm_streams_total", "Finished streams by outcome "
    "(ok / expired / cancelled / error)", labels=("outcome",))
_dedup = counter(
    "zoo_llm_stream_dedup_total",
    "Duplicate stream ids joined to an existing stream instead of "
    "decoding twice")
# tick-pipeline families: where each engine tick
# spends its time, and how much of the wall clock the device is busy —
# the overlap the async pipeline exists to create
_tick_seconds = histogram(
    "zoo_llm_tick_seconds",
    "Per-phase engine tick latency (schedule = sweep/admit/grow host "
    "work, prefill = prompt chunk executions, decode = dispatch-to-"
    "ready device time, readback = applying a ready batch to streams)",
    labels=("phase",))
_overlap_ratio = gauge(
    "zoo_llm_tick_overlap_ratio",
    "Device-busy time / wall time over the recent decode window (1.0 "
    "= the scheduler never leaves the device idle)")
# prefix-cache families: prompt tokens whose KV
# was reused from a cached prefix vs computed fresh, and the HBM cost
# of one cached token under the active cache dtype
_prefix_hits = counter(
    "zoo_llm_prefix_cache_hit_tokens_total",
    "Prompt tokens admitted onto CACHED prefix blocks (prefill skipped "
    "straight past them)")
_prefix_misses = counter(
    "zoo_llm_prefix_cache_miss_tokens_total",
    "Prompt tokens prefilled fresh while prefix caching was enabled")
_kv_bytes_per_token = gauge(
    "zoo_llm_kv_bytes_per_token",
    "HBM bytes one cached token costs (K+V rows across layers, plus "
    "int8 scale rows) under the engine model's KV cache dtype")
# speculative-decoding families: how many tokens
# the drafter proposed, how many the verify pass accepted (the
# amortization the feature exists for), the per-pass accept-length
# distribution, and how often the drafter had anything to propose
_spec_proposed = counter(
    "zoo_llm_spec_proposed_tokens_total",
    "Draft tokens proposed by the n-gram prompt-lookup drafter and "
    "scored by a verify pass")
_spec_accepted = counter(
    "zoo_llm_spec_accepted_tokens_total",
    "Draft tokens accepted by the verify pass (each one is a decoded "
    "token that cost no extra HBM pass)")
_spec_accept_len = histogram(
    "zoo_llm_spec_accept_len",
    "Accepted-prefix length per verify pass with a non-empty draft "
    "(0 = the first draft token already mismatched)",
    buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
_spec_hit_rate = gauge(
    "zoo_llm_spec_draft_hit_rate",
    "Fraction of decode lanes the prompt-lookup drafter produced at "
    "least one proposal for (cumulative, republished from "
    "engine.stats())")
# per-tenant admission, shedding, preemption and live occupancy
_tenant_admitted = counter(
    "zoo_tenant_admitted_total",
    "Requests admitted past the tenant token bucket, per tenant",
    labels=("tenant",))
_tenant_shed = counter(
    "zoo_tenant_shed_total",
    "Requests shed per tenant and reason (rate = the tenant's own "
    "token bucket ran dry, queue_full = the shared waiting queue was "
    "at bound, slots/kv = per-tenant quota)", labels=("tenant", "reason"))
_tenant_preempted = counter(
    "zoo_tenant_preempted_total",
    "Streams preempted per OWNING tenant and reason (kv = pool "
    "pressure, class = displaced by a higher-priority tenant)",
    labels=("tenant", "reason"))
_tenant_kv = gauge(
    "zoo_tenant_kv_blocks",
    "Live KV blocks owned per tenant partition",
    labels=("tenant",))
_tenant_slots = gauge(
    "zoo_tenant_decode_slots",
    "Decode slots held per tenant right now", labels=("tenant",))


class AdmissionError(RuntimeError):
    """Retryable door rejection: the waiting queue is full, or the
    tenant's admission bucket ran dry. With tenancy on,
    ``retry_after_ms`` comes from the SHEDDING tenant's own bucket
    refill; ``reason`` is ``rate`` or ``queue_full``."""

    def __init__(self, msg: str, retry_after_ms: int = 100,
                 tenant: str = "", reason: str = "queue_full"):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms
        self.tenant = tenant
        self.reason = reason


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
                 spec_k: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 parent_span: Optional[str] = None,
                 tenant: str = ""):
        self.id = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = int(max_new)
        self.deadline = deadline
        # the tenant whose bucket admitted the stream, whose quotas its
        # slot and blocks count against and whose class orders
        # preemption ("" = unlabeled)
        self.tenant = tenant or ""
        # request-scoped trace identity (rides the wire from the HA
        # client): every lifecycle event of the stream carries it, so
        # the timeline merger joins this replica's work into the
        # request's fleet-wide trace
        self.trace_id = trace_id
        self.parent_span = parent_span
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
        self.created_wall = time.time()
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
        # disaggregation: hold_handoff parks the stream after prefill
        # (outcome "handoff") instead of decoding; adopt carries a
        # staged kv_migrate payload that admission binds instead of
        # prefilling
        self.hold_handoff = False
        self.adopt: Optional[Dict] = None

    @property
    def done(self) -> bool:
        return self.outcome is not None

    def push(self, tok: int):
        with self._cond:
            self.tokens.append(int(tok))
            now = time.perf_counter()
            if self.first_token_at is None:
                self.first_token_at = now
                _ttft.observe(now - self.created)
            else:
                # the gap a streaming client felt between two frames
                # (preemption pauses and failover stalls land here)
                _inter_token.observe(now - self.last_token_at)
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
        _streams.labels(outcome=outcome).inc()
        now = time.perf_counter()
        # ttft by outcome: a stream that died waiting observes its whole
        # lifetime
        _stream_ttft.labels(outcome=outcome).observe(
            (self.first_token_at or now) - self.created)
        record_event("llm_stream_end", rid=self.id, outcome=outcome,
                     tokens=len(self.tokens), preempts=self.preempts,
                     tenant=self.tenant or None, error=error)
        emit_span("llm.stream", self.created_wall, now - self.created,
                  trace=self.trace_id, parent=self.parent_span,
                  ok=outcome == "ok", rid=self.id, outcome=outcome,
                  tokens=len(self.tokens), preempts=self.preempts,
                  tenant=self.tenant or None)

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
    replica's role in a disaggregated pool (``prefill`` parks finished
    prompts for the handoff, ``decode`` adopts migrated KV, ``mixed``
    does both), advertised on every reply frame. ``tenancy=None`` takes
    the process registry (:func:`~zoo_tpu_torch.serving.tenancy.
    registry`, ``ZOO_TENANT_CONFIG``)."""

    def __init__(self, model, mode: str = "continuous",
                 max_waiting: Optional[int] = None,
                 overlap: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 role: Optional[str] = None,
                 tenancy=None):
        if mode not in ("continuous", "oneshot"):
            raise ValueError(f"unknown scheduling mode {mode!r}")
        if role is None:
            role = knob_value("ZOO_LLM_ROLE")
        if role not in ("prefill", "decode", "mixed"):
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
        # the QoS registry every admission and scheduling decision
        # consults; disabled (no tenant config) it is inert
        self.tenancy = tenancy if tenancy is not None \
            else tenant_registry()
        # served prefill + decode tokens per tenant, the weighted-fair
        # pick's numerator (guarded-by: _lock)
        self._tenant_served: Dict[str, int] = {}
        self._tenant_gauged: set = set()
        self.allocator = BlockAllocator(model.num_blocks, model.block_size,
                                        prefix_cache=self.prefix_cache)
        self._hit_tokens = 0
        self._miss_tokens = 0
        self._kv_bpt = getattr(model, "kv_bytes_per_token", None)
        if self._kv_bpt:
            _kv_bytes_per_token.set(float(self._kv_bpt))
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
        # (ready time, device-busy seconds) of the recent ticks: the
        # overlap gauge
        self._busy_win: Deque[Tuple[float, float]] = \
            collections.deque(maxlen=64)
        # set when a dispatch or readback failed: the device token chain
        # must be re-seeded from host state before the next dispatch
        self._chain_broken = False
        # disaggregation (guarded-by: _lock): _handoffs parks prefilled
        # sequences (blocks still OWNED) until the door pushes and
        # releases them; _adopted stages incoming kv_migrate payloads
        # until their generate arrives. Both age out on the migrate TTL,
        # so a dead peer never pins blocks.
        self._handoffs: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()
        self._adopted: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()
        self._handoff_ttl = max(
            0.05, float(knob_value("ZOO_KV_MIGRATE_TTL_MS")) / 1000.0)
        self._adopted_cap = 64
        self._handoffs_out = 0
        self._handoffs_in = 0

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
        # parked handoffs hold blocks with no slot: free them too
        with self._lock:
            parked = list(self._handoffs)
            self._handoffs.clear()
            self._adopted.clear()
        for rid in parked:
            self.allocator.free(rid)
        self._publish()

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, rid: Optional[str] = None,
               deadline: Optional[Deadline] = None,
               sampling=None, spec_k: Optional[int] = None,
               trace_id: Optional[str] = None,
               parent_span: Optional[str] = None,
               handoff: bool = False, adopt: Optional[Dict] = None,
               tenant: Optional[str] = None) -> GenHandle:
        """Queue one generation (``sampling`` as :func:`parse_sampling`;
        ``spec_k`` caps this stream's drafts, None = the engine's, 0 =
        none, and never raises the engine's width). ``trace_id`` /
        ``parent_span`` stamp every lifecycle event of the stream with
        the request's wire trace. Raises
        :class:`AdmissionError` when the waiting queue is full or the
        tenant's bucket is dry, and ``ValueError`` for a prompt no
        prefill path can hold.

        ``handoff=True`` prefills only: the stream ends with outcome
        ``"handoff"`` and its blocks parked for :meth:`take_handoff`.
        ``adopt`` (from :meth:`pop_adopted`) binds a migrated payload
        instead of prefilling. ``tenant`` names the stream's tenant."""
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
        tenant = tenant or ""
        with self._lock:
            prior = self._by_id.get(rid)
            if prior is not None:
                # a duplicate id joins the live stream, never charged to
                # the tenant's bucket again
                _dedup.inc()
                return prior
            if self.tenancy.enabled:
                ok, hint = self.tenancy.admit(tenant)
                if not ok:
                    label = tenant or "default"
                    _tenant_shed.labels(tenant=label, reason="rate").inc()
                    record_event("tenant_shed", rid=rid, tenant=label,
                                 reason="rate", retry_after_ms=hint)
                    raise AdmissionError(
                        f"tenant {label!r} rate limited "
                        f"(refill in {hint}ms)",
                        retry_after_ms=hint, tenant=tenant, reason="rate")
            if len(self._wait) >= self.max_waiting:
                hint = 200
                if self.tenancy.enabled:
                    # THIS tenant's refill when it is rate-limited, the
                    # generic hint for a tenant within its rate
                    own = self.tenancy.bucket(tenant).retry_after_ms()
                    hint = own if own > 1 else 200
                    _tenant_shed.labels(tenant=tenant or "default",
                                        reason="queue_full").inc()
                raise AdmissionError(
                    f"llm waiting queue full ({len(self._wait)} streams, "
                    f"bound {self.max_waiting}); retry another replica",
                    retry_after_ms=hint, tenant=tenant)
            if self.tenancy.enabled:
                _tenant_admitted.labels(tenant=tenant or "default").inc()
            h = GenHandle(rid, prompt, max_new_tokens, deadline,
                          sampling=params,
                          spec_k=None if spec_k is None else int(spec_k),
                          trace_id=trace_id, parent_span=parent_span,
                          tenant=tenant)
            h.hold_handoff = bool(handoff)
            h.adopt = adopt
            self._by_id[rid] = h
            self._trim_finished_locked()
            self._wait.append(h)
            _waiting.set(len(self._wait))
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
    def _tick_flight(self):
        """Every 128th decode step drops a tick summary into the flight
        ring: a postmortem then shows what the engine ran in its last
        seconds, at a cost that never lands on every tick."""
        if self._decode_steps % 128:
            return
        record_event("engine_tick", steps=self._decode_steps,
                     occupancy=sum(1 for s in self._slots if s.handle),
                     waiting=len(self._wait),
                     generated=self._generated)

    def _publish(self):
        """Republish the occupancy gauges, and the per-tenant slot and
        KV gauges with tenancy on."""
        with self._lock:
            _occupancy.set(sum(1 for s in self._slots if s.handle))
            _waiting.set(len(self._wait))
            if self.tenancy.enabled:
                slots_by: Dict[str, int] = {}
                for t, n in self._slots_by_tenant().items():
                    k = t or "default"
                    slots_by[k] = slots_by.get(k, 0) + n
                kv_by: Dict[str, int] = {}
                for t, n in self.allocator.used_by_tenant().items():
                    k = t or "default"
                    kv_by[k] = kv_by.get(k, 0) + n
                live = set(slots_by) | set(kv_by)
                # tenants gauged before are set to 0, not left stale
                for t in self._tenant_gauged | live:
                    _tenant_slots.labels(tenant=t).set(slots_by.get(t, 0))
                    _tenant_kv.labels(tenant=t).set(kv_by.get(t, 0))
                self._tenant_gauged |= live
        # republished on every scheduler pass so the engine actually
        # serving owns the process-global gauge
        if self._kv_bpt:
            _kv_bytes_per_token.set(float(self._kv_bpt))

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
        deadline expiry), and expire parked handoffs and staged
        adoptions past the migrate TTL."""
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
        now = time.perf_counter()
        for rid in [r for r, p in self._handoffs.items()
                    if not p.get("taken")
                    and now - p["t0"] > self._handoff_ttl]:
            self._handoffs.pop(rid, None)
            self.allocator.free(rid)
            record_event("kv_handoff_abort", rid=rid, reason="ttl")
        for rid in [r for r, p in self._adopted.items()
                    if now - p["staged_at"] > self._handoff_ttl]:
            self._adopted.pop(rid, None)

    def _slots_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self._slots:
            if s.handle is not None:
                t = s.handle.tenant
                out[t] = out.get(t, 0) + 1
        return out

    def _pop_next_waiter(self) -> Optional[GenHandle]:
        """Under the lock: the next stream to admit. Tenancy off: FIFO.
        Tenancy on: among waiters whose tenant has slot and KV headroom,
        the lowest priority class, then the lowest served tokens /
        weight, then the oldest (FIFO within a tenant). A tenant over
        quota is skipped, so its backlog never blocks the queue."""
        if not self._wait:
            return None
        reg = self.tenancy
        if not reg.enabled:
            return self._wait.popleft()
        slots_by = self._slots_by_tenant()
        kv_by = self.allocator.used_by_tenant()
        best = None
        best_key = None
        for h in self._wait:
            cfg = reg.config(h.tenant)
            if h.cancelled.is_set() or self._expired(h):
                # dead anyway: let admission finish it
                best = h
                break
            if cfg.max_slots and \
                    slots_by.get(h.tenant, 0) >= cfg.max_slots:
                continue
            if cfg.max_kv_blocks:
                prompt = h.effective_prompt \
                    if h.effective_prompt is not None else h.prompt
                need = self.allocator.blocks_for_tokens(len(prompt) + 1)
                if kv_by.get(h.tenant, 0) + need > cfg.max_kv_blocks:
                    continue
            key = (cfg.priority,
                   self._tenant_served.get(h.tenant, 0) / cfg.weight)
            if best_key is None or key < best_key:
                best, best_key = h, key
        if best is not None:
            self._wait.remove(best)
        return best

    def _admit(self):
        if self.mode == "oneshot" and any(s.handle is not None
                                          for s in self._slots):
            return
        for slot in self._slots:
            if slot.handle is not None:
                continue
            with self._lock:
                h = self._pop_next_waiter()
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
            if self.tenancy.enabled and h.tenant:
                # the tenant partition is set BEFORE any block moves
                self.allocator.set_tenant(h.id, h.tenant)
            if h.adopt is not None:
                # a migrated stream binds its adopted table and enters
                # decode directly, with no prefill work
                if not self._bind_adopted(slot, h, prompt):
                    with self._lock:
                        self._wait.appendleft(h)
                    break
                continue
            # prefix cache: hash the prompt's full blocks (tenant-salted)
            # and probe for the longest cached run; the LAST prompt token
            # is always recomputed (its forward produces the first
            # generated token)
            hashes = []
            if self.prefix_cache:
                if h.block_hashes and h.hashed_len == len(prompt):
                    hashes = h.block_hashes
                else:
                    hashes = prefix_block_hashes(
                        prompt, self.allocator.block_size,
                        salt=self.tenancy.salt(h.tenant))
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
            self._note_served(h, len(prompt) - h.cache_hit_tokens)
            emit_event("llm.admit", trace=h.trace_id,
                       parent=h.parent_span, rid=h.id,
                       queue_wait_s=round(h.admitted_at - h.created, 6),
                       prompt_tokens=int(len(prompt)),
                       cache_hit_tokens=int(h.cache_hit_tokens),
                       cow_fork=slot.pending_copy is not None,
                       resumed=h.effective_prompt is not None,
                       tenant=h.tenant or None)
            # admission only BINDS; the device prefill runs in
            # _prefill_tick outside the engine lock
            slot.phase = "prefill"
            slot.prefill_pos = h.cache_hit_tokens
            slot.position = 0
        if self.tenancy.enabled:
            self._preempt_for_class()
        self._publish()

    def _note_served(self, h: GenHandle, n: int):
        """Charge ``n`` tokens of service to the stream's tenant."""
        if n > 0 and self.tenancy.enabled:
            self._tenant_served[h.tenant] = \
                self._tenant_served.get(h.tenant, 0) + int(n)

    def _preempt_for_class(self):
        """When every slot is held and an eligible waiter (within its
        slot quota) is of a strictly higher priority class, preempt the
        youngest stream of the lowest class below it: a paid tier
        displaces best-effort streams, never a peer. One victim a pass;
        the freed slot admits the waiter on the next pass, and the
        victim resumes by re-prefill."""
        reg = self.tenancy
        with self._lock:
            if not self._wait or \
                    any(s.handle is None for s in self._slots):
                return
            slots_by = self._slots_by_tenant()
            best_cls = None
            for h in self._wait:
                if h.cancelled.is_set() or self._expired(h):
                    continue
                cfg = reg.config(h.tenant)
                if cfg.max_slots and \
                        slots_by.get(h.tenant, 0) >= cfg.max_slots:
                    continue
                if best_cls is None or cfg.priority < best_cls:
                    best_cls = cfg.priority
            if best_cls is None:
                return
            victim = None
            victim_key = None
            for slot in self._slots:
                hh = slot.handle
                if hh is None:
                    continue
                c = reg.config(hh.tenant).priority
                if c <= best_cls:
                    continue   # same or higher priority: never evicted
                key = (c, hh.admit_seq)
                if victim_key is None or key > victim_key:
                    victim, victim_key = slot, key
            if victim is not None:
                self._preempt(victim, reason="class")

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
            _prefix_hits.inc(start)
            _prefix_misses.inc(len(prompt) - start)
        return True

    def _enter_decode(self, slot: _Slot, h: GenHandle, first: int,
                      prompt_len: int):
        """Prompt fully prefilled: publish its blocks to the prefix
        cache, push the first token and arm the decode chain (or park
        the stream for its handoff)."""
        if h.hold_handoff:
            self._park_handoff(slot, h, first, prompt_len)
            return
        self.allocator.register_blocks(h.id, h.block_hashes)
        slot.phase = "decode"
        slot.position = prompt_len
        slot.last_token = first
        slot.host_token = first
        slot.use_host = True
        emit_event("llm.first_token", trace=h.trace_id,
                   parent=h.parent_span, rid=h.id)
        h.push(first)
        h.gen_count += 1
        h.sched_count += 1
        self._generated += 1
        self._note_served(h, 1)
        _tokens.labels(kind="decode").inc()
        eos = getattr(self.model, "eos_id", None)
        if h.gen_count >= h.max_new or (eos is not None and first == eos):
            self._finish_slot(slot, "ok")

    # -- disaggregated handoff ---------------------------------------------
    def _park_handoff(self, slot: _Slot, h: GenHandle, first: int,
                      prompt_len: int):
        """A handoff stream finished its prefill: publish the prefix
        locally, park the migration payload with the blocks still OWNED,
        free the slot and end the stream with outcome ``"handoff"``. The
        door then pushes the payload and calls :meth:`release_handoff`.
        Under the lock."""
        self.allocator.register_blocks(h.id, h.block_hashes)
        prompt = h.effective_prompt if h.effective_prompt is not None \
            else h.prompt
        self._handoffs[h.id] = {
            "rid": h.id,
            "prompt": [int(t) for t in prompt],
            "first": int(first),
            "sampling": list(h.sampling),
            "hashes": list(h.block_hashes),
            "blocks": self.allocator.blocks_of(h.id),
            "block_size": self.allocator.block_size,
            "aux": self.allocator.get_aux(h.id),
            "max_new": h.max_new,
            "tenant": h.tenant,
            "t0": time.perf_counter(),
        }
        slot.handle = None
        slot.epoch += 1
        slot.spec_inflight = False
        self._handoffs_out += 1
        record_event("kv_migrate_out", rid=h.id,
                     blocks=len(self._handoffs[h.id]["blocks"]),
                     prompt_tokens=int(prompt_len))
        h.finish("handoff")
        self._publish()

    def take_handoff(self, rid: str) -> Optional[Dict]:
        """The parked payload for ``rid``, marked in-push so the TTL
        sweep leaves its blocks alone until :meth:`release_handoff`;
        None when nothing is parked (expired, already released)."""
        with self._lock:
            payload = self._handoffs.get(rid)
            if payload is not None:
                payload["taken"] = True
            return payload

    def release_handoff(self, rid: str) -> bool:
        """Free a parked handoff's blocks (pushed, or the push failed
        and the client re-prefills elsewhere)."""
        with self._lock:
            payload = self._handoffs.pop(rid, None)
        if payload is None:
            return False
        self.allocator.free(rid)
        return True

    def offer_adopted(self, payload: Dict) -> bool:
        """Stage an incoming kv_migrate payload until its generate
        arrives (bounded LRU; ages out on the migrate TTL). The
        allocator is not touched here. Refused (False) on a block size
        mismatch, or when this model holds KV state and the payload
        carries none."""
        if int(payload.get("block_size") or 0) != \
                self.allocator.block_size:
            return False
        if hasattr(self.model, "import_kv_blocks") and \
                payload.get("kv") is None:
            return False
        payload = dict(payload)
        payload["staged_at"] = time.perf_counter()
        with self._lock:
            self._adopted[str(payload["rid"])] = payload
            while len(self._adopted) > self._adopted_cap:
                self._adopted.popitem(last=False)
        return True

    def pop_adopted(self, rid: str) -> Optional[Dict]:
        """Claim the staged payload for ``rid`` (None = never staged or
        aged out: the caller submits a plain re-prefill, which yields
        the same stream)."""
        with self._lock:
            payload = self._adopted.pop(rid, None)
        if payload is None:
            return None
        if time.perf_counter() - payload["staged_at"] > self._handoff_ttl:
            return None
        return payload

    def _bind_adopted(self, slot: _Slot, h: GenHandle,
                      prompt: np.ndarray) -> bool:
        """Admission of a migrated stream: bind the adopted table
        (aliasing a locally matchable prefix), import the wire KV rows
        into the fresh blocks and enter decode with the prefill seat's
        first token, with no prefill call. False when the pool cannot
        fund the table yet (requeue). Under the lock."""
        payload = h.adopt
        hashes = [bytes(x) for x in payload.get("hashes") or ()]
        n_blocks = self.allocator.blocks_for_tokens(len(prompt) + 1)
        got = self.allocator.adopt_blocks(h.id, hashes, n_blocks)
        if got is None:
            return False
        table, n_reused = got
        h.adopt = None
        h.block_hashes = hashes
        h.hashed_len = len(prompt)
        kv = payload.get("kv")
        fn = getattr(self.model, "import_kv_blocks", None)
        if kv is not None and fn is not None:
            # fresh rows only: aliased prefix blocks already hold the
            # same K/V (the hash-match guarantee). The payload holds the
            # prompt's blocks; a prompt that ends on a block boundary
            # has one more row in this table, its empty decode frontier
            n_kv = min(len(table), int(next(iter(kv.values())).shape[1]))
            fn(table[n_reused:n_kv], kv, start=n_reused)
        bs = self.allocator.block_size
        local_hit = min(n_reused * bs, len(prompt) - 1)
        h.cache_hit_tokens = local_hit
        if self.prefix_cache and local_hit:
            # aliased rows are prefix-cache hits; the migrated remainder
            # is neither hit nor miss: no prefill ran
            self._hit_tokens += local_hit
            _prefix_hits.inc(local_hit)
        self.allocator.set_aux(h.id, seed=h.sampling[3],
                               resumed_at=len(prompt))
        slot.handle = h
        slot.epoch += 1
        slot.spec_inflight = False
        slot.pending_copy = None
        self._admit_counter += 1
        h.admit_seq = self._admit_counter
        h.admitted_at = time.perf_counter()
        self._handoffs_in += 1
        emit_event("llm.admit", trace=h.trace_id,
                   parent=h.parent_span, rid=h.id,
                   queue_wait_s=round(h.admitted_at - h.created, 6),
                   prompt_tokens=int(len(prompt)),
                   cache_hit_tokens=int(local_hit),
                   cow_fork=False, resumed=False, adopted=True,
                   tenant=h.tenant or None)
        record_event("kv_migrate_in", rid=h.id,
                     blocks=len(table) - n_reused, reused=n_reused)
        self._enter_decode(slot, h, int(payload["first"]), len(prompt))
        return True

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
            t0 = time.perf_counter()
            t0_wall = time.time()
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
            dur = time.perf_counter() - t0
            _tick_seconds.labels(phase="prefill").observe(dur)
            _tokens.labels(kind="prefill").inc(take)
            emit_span("llm.prefill", t0_wall, dur, trace=h.trace_id,
                      parent=h.parent_span, rid=h.id, start=int(start),
                      tokens=int(take), total=int(n))
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
        self._publish()

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
                    if self.tenancy.enabled and any(
                            s.handle is not None and s.handle is not h
                            for s in self._slots):
                        # every other live stream outranks h: requeue h
                        # itself (it resumes by re-prefill) rather than
                        # evict a higher class's KV or fail h
                        self._preempt(slot)
                        break
                    self._finish_slot(
                        slot, "error",
                        "kv cache exhausted: sequence cannot grow and no "
                        "other stream is preemptible")
                    break
                self._preempt(victim)

    def _pick_victim(self, exclude: GenHandle) -> Optional[_Slot]:
        """The stream to evict when ``exclude`` needs a block: the
        youngest-admitted other stream, within the lowest priority class
        and never of a class that outranks ``exclude``'s (tenancy on)."""
        reg = self.tenancy
        ex_cls = reg.config(exclude.tenant).priority if reg.enabled else 0
        best = None
        best_key = None
        for slot in self._slots:
            if slot.handle is None or slot.handle is exclude:
                continue
            if reg.enabled:
                c = reg.config(slot.handle.tenant).priority
                if c < ex_cls:
                    continue   # outranks the grower: never its victim
                key = (c, slot.handle.admit_seq)
            else:
                key = (0, slot.handle.admit_seq)
            if best_key is None or key > best_key:
                best, best_key = slot, key
        return best

    def _preempt(self, slot: _Slot, reason: str = "kv"):
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
        _preempts.inc()
        if self.tenancy.enabled:
            _tenant_preempted.labels(tenant=h.tenant or "default",
                                     reason=reason).inc()
        emit_event("llm.preempt", trace=h.trace_id,
                   parent=h.parent_span, rid=h.id,
                   generated=int(h.gen_count), reason=reason,
                   tenant=h.tenant or None)
        record_event("llm_preempt", rid=h.id,
                     generated=int(h.gen_count), reason=reason,
                     tenant=h.tenant or None)
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
        self._publish()

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
            self._note_served(h, 1)
            _tokens.labels(kind="decode").inc()
            if h.gen_count >= h.max_new or (eos is not None and tok == eos):
                self._finish_slot(slot, "ok")
        self._publish()

    def _decode_tick(self) -> bool:
        """The synchronous tick: host-fed lanes, blocking readback."""
        with self._lock:
            built = self._build_tick(device_chain=False)
        if built is None:
            return False
        host, use, tables, positions, lanes, snapshot = built
        t0 = time.perf_counter()
        try:
            batch = self.model.decode_step(None, host, use, tables,
                                           positions, lanes)
            arr = self.model.read_tokens(batch)
        except Exception as e:  # noqa: BLE001 — lost tokens end their
            # streams loudly instead of leaving a hole and a wedged slot
            with self._lock:
                self._fail_lanes(snapshot, e)
            return True
        t1 = time.perf_counter()
        _tick_seconds.labels(phase="decode").observe(t1 - t0)
        self._note_busy(t0, t1)
        self._decode_steps += 1
        _steps.inc()
        self._tick_flight()
        with self._lock:
            self._apply_tokens(snapshot, arr)
        _tick_seconds.labels(phase="readback").observe(
            time.perf_counter() - t1)
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
                _spec_proposed.inc(len(draft))
                _spec_accepted.inc(accept)
                _spec_accept_len.observe(accept)
            for tok in (int(t) for t in out[:accept + 1]):
                slot.position += 1
                slot.last_token = tok
                h.push(tok)
                h.gen_count += 1
                h.sched_count = h.gen_count
                self._generated += 1
                self._note_served(h, 1)
                _tokens.labels(kind="decode").inc()
                if h.gen_count >= h.max_new or (eos is not None and
                                                tok == eos):
                    self._finish_slot(slot, "ok")
                    break
        if self._spec_lanes:
            _spec_hit_rate.set(self._spec_drafted_lanes / self._spec_lanes)
        self._publish()

    def _spec_tick(self) -> bool:
        """The synchronous verify tick: build, dispatch, block on the
        readback, apply."""
        with self._lock:
            built = self._build_spec_tick()
        if built is None:
            return False
        tokens, tables, positions, lanes, snapshot = built
        t0 = time.perf_counter()
        try:
            batch = self.model.verify_step(tokens, tables, positions, lanes)
            arr = self.model.read_tokens(batch)
        except Exception as e:  # noqa: BLE001 — lost lanes end their
            # streams loudly, as a decode tick's do
            with self._lock:
                self._fail_lanes(snapshot, e)
            return True
        t1 = time.perf_counter()
        _tick_seconds.labels(phase="decode").observe(t1 - t0)
        self._note_busy(t0, t1)
        self._decode_steps += 1
        _steps.inc()
        self._tick_flight()
        with self._lock:
            self._apply_spec(snapshot, arr)
        _tick_seconds.labels(phase="readback").observe(
            time.perf_counter() - t1)
        return True

    # -- overlap pipeline --------------------------------------------------
    def _note_busy(self, t_start: float, t_ready: float):
        """Record one tick's busy interval (clipped to start after the
        previous ready, so two in-flight ticks never count the same
        wall time twice) and refresh the overlap gauge."""
        last = self._busy_win[-1][0] if self._busy_win else 0.0
        busy = max(0.0, t_ready - max(t_start, last))
        self._busy_win.append((t_ready, busy))
        if len(self._busy_win) >= 2:
            win = list(self._busy_win)
            wall = win[-1][0] - win[0][0]
            if wall > 0:
                _overlap_ratio.set(
                    min(1.0, sum(b for _, b in win[1:]) / wall))

    def _readback_loop(self):
        while True:
            item = self._rbq.get()
            if item is None:
                return
            kind, batch, snapshot, t_dispatch = item
            try:
                arr = self.model.read_tokens(batch)
            except Exception as e:  # noqa: BLE001 — these lanes' tokens
                # are gone: end the streams, re-seed the device chain
                with self._lock:
                    self._fail_lanes(snapshot, e)
                self._inflight.release()
                self._wake.set()
                continue
            t_ready = time.perf_counter()
            _tick_seconds.labels(phase="decode").observe(
                t_ready - t_dispatch)
            self._note_busy(t_dispatch, t_ready)
            with self._lock:
                if kind == "spec":
                    self._apply_spec(snapshot, arr)
                else:
                    self._apply_tokens(snapshot, arr)
            _tick_seconds.labels(phase="readback").observe(
                time.perf_counter() - t_ready)
            self._decode_steps += 1
            _steps.inc()
            self._tick_flight()
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
                t0 = time.perf_counter()
                with self._lock:
                    self._sweep()
                    self._admit()
                t1 = time.perf_counter()
                self._prefill_tick()
                t2 = time.perf_counter()
                with self._lock:
                    self._grow_or_preempt()
                    built = self._build_spec_tick() if self._spec \
                        else self._build_tick(device_chain=True)
                _tick_seconds.labels(phase="schedule").observe(
                    (t1 - t0) + (time.perf_counter() - t2))
                if built is None:
                    prev_batch = None
                    self._wake.wait(0.005)
                    self._wake.clear()
                    continue
                while not self._inflight.acquire(timeout=0.5):
                    if self._stop.is_set():
                        return
                t_d = time.perf_counter()
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
                    self._rbq.put(("spec", batch, snapshot, t_d))
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
                self._rbq.put(("decode", prev_batch, snapshot, t_d))
        finally:
            self._rbq.put(None)
            if self._rb_thread is not None:
                self._rb_thread.join(timeout=10)

    def _loop_sync(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            with self._lock:
                self._sweep()
                self._admit()
            t1 = time.perf_counter()
            self._prefill_tick()
            t2 = time.perf_counter()
            with self._lock:
                self._grow_or_preempt()
            _tick_seconds.labels(phase="schedule").observe(
                (t1 - t0) + (time.perf_counter() - t2))
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
                   if self._spec_lanes else 0.0),
               "handoffs_out": self._handoffs_out,
               "handoffs_in": self._handoffs_in,
               "parked_handoffs": len(self._handoffs),
               "qos": self.tenancy.enabled}
        if self.tenancy.enabled:
            with self._lock:
                slots_by = self._slots_by_tenant()
                kv_by = self.allocator.used_by_tenant()
                waiting_by: Dict[str, int] = {}
                for w in self._wait:
                    waiting_by[w.tenant] = waiting_by.get(w.tenant, 0) + 1
                names = set(slots_by) | set(kv_by) | set(waiting_by) \
                    | set(self._tenant_served)
                out["tenants"] = {
                    (t or "default"): {
                        "slots": slots_by.get(t, 0),
                        "kv_blocks": kv_by.get(t, 0),
                        "waiting": waiting_by.get(t, 0),
                        "served_tokens": self._tenant_served.get(t, 0),
                    } for t in sorted(names)}
        out.update(self.allocator.stats())
        if hasattr(m, "compile_counts"):
            out["compiles"] = m.compile_counts()
        return out
