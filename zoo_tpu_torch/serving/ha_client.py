"""High-availability serving client: failover and hedging over a
replica group (counterpart of ``zoo_tpu/serving/ha_client.py``).

* **round-robin over healthy replicas** — a per-endpoint
  :class:`CircuitBreaker` takes a replica out of rotation after
  consecutive transport failures and probes it back in after a short
  recovery window; gray-failure ejection (:mod:`.ejection`) orders the
  rest;
* **failover with resume** — a transport error or a retryable shed
  mid-stream moves the stream to the next replica inside the SAME
  deadline, with ``resume_from`` = tokens already received: replicas
  hold the same weights and sample as a pure function of (seed, token
  index), so the fresh replica regenerates the same stream and sends
  only the unseen suffix;
* **first-token hedge** — when no frame has arrived within the
  p95-tracked hedge delay, ONE duplicate stream (same request id) starts
  on the next replica and the first content frame wins.

``predict`` and the other request/response ops take the same failover
and a hedge of the whole request (same id, so the server's dedup cache
absorbs a same-seat landing). Every request carries one id and one
:class:`Deadline` end to end. A/B routing: ``ab_split`` /
``ZOO_SERVE_AB_SPLIT`` pins fractions of predict traffic to registry
versions, ``tenant_pins`` / ``ZOO_TENANT_AB_PINS`` one tenant's, and
:meth:`HAServingClient.pin_version` either; a pinned request bounced by
a replica serving another version fails over to one that serves it.
What waits, each for its ROADMAP item: the per-tenant shed backoff
(A.4), the prefill→decode handoff pair (A.5; the plan never pairs), and
the client spans (A.6).
"""

from __future__ import annotations

import hashlib
import os
import queue as _queue
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zoo_tpu_torch.common.knobs import value as _knob_value
from zoo_tpu_torch.obs.metrics import counter, histogram
from zoo_tpu_torch.serving.ejection import (
    EJECTED,
    PROBATION,
    EjectionConfig,
    EjectionController,
)
from zoo_tpu_torch.serving.tcp_client import _Connection
from zoo_tpu_torch.util.resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryError,
    RetryPolicy,
    env_float,
)

__all__ = ["HAServingClient", "NoReplicaAvailable"]

_hedge = counter(
    "zoo_serve_hedge_total", "Hedged duplicates, by event (fired = "
    "duplicate sent after the hedge delay; won = the duplicate's answer "
    "was the one used)", labels=("event",))
_failover = counter(
    "zoo_serve_failover_total",
    "Requests moved to another replica after a transport failure or a "
    "retryable shed")
_attempt_seconds = histogram(
    "zoo_serve_client_attempt_seconds",
    "Per-attempt client-observed RPC latency (successful attempts; "
    "feeds the hedge-delay p95)")
# A/B routing families: per-pinned-version outcome and end-to-end
# latency, what a promotion gate compares a canary against the
# incumbent on
_ab_requests = counter(
    "zoo_serve_ab_requests_total",
    "Logical client requests by pinned model version and outcome "
    "(version=unpinned for traffic the A/B split left on the "
    "incumbent)", labels=("version", "outcome"))
_ab_latency = histogram(
    "zoo_serve_ab_latency_seconds",
    "End-to-end client-observed request latency by pinned model "
    "version (includes failover/hedging)", labels=("version",))
_route_affinity = counter(
    "zoo_serve_route_affinity_total",
    "Generate routing decisions by decisive reason (prefix affinity, "
    "decode occupancy, replica role, disaggregated handoff, or plain "
    "round-robin)", labels=("reason",))

#: prompt tokens hashed into the routing prefix signature
_AFFINITY_PREFIX_TOKENS = 16


def _parse_ab_split(text: str) -> Dict[str, float]:
    """``"v2=0.1,v3=0.05"`` → ``{"v2": 0.1, "v3": 0.05}``."""
    out: Dict[str, float] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        version, sep, frac = part.partition("=")
        try:
            if not sep:
                raise ValueError("missing '='")
            out[version.strip()] = float(frac)
        except ValueError as e:
            raise ValueError(
                f"malformed ZOO_SERVE_AB_SPLIT entry {part!r} "
                f"(expected e.g. \"v2=0.1,v3=0.05\"): {e}") from None
    return out


def _validate_ab_split(split: Dict[str, float]):
    for v, f in split.items():
        if not (0.0 <= f <= 1.0):
            raise ValueError(f"A/B fraction for {v!r} out of [0,1]: {f}")
    if sum(split.values()) > 1.0 + 1e-9:
        raise ValueError(f"A/B fractions sum past 1.0: {split}")


def _parse_tenant_pins(text: str) -> Dict[str, str]:
    """``ZOO_TENANT_AB_PINS="gold=v2,free=v1"`` → per-tenant version
    pins: the named tenant's traffic is pinned to that registry version
    ahead of the fractional A/B split."""
    out: Dict[str, str] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        tenant, sep, version = part.partition("=")
        if not sep or not tenant.strip() or not version.strip():
            raise ValueError(
                f"malformed ZOO_TENANT_AB_PINS entry {part!r} "
                "(expected e.g. \"gold=v2,free=v1\")")
        out[tenant.strip()] = version.strip()
    return out


class NoReplicaAvailable(ConnectionError):
    """Every replica in the group failed or shed this request inside its
    budget; ``__cause__`` / ``last_error`` is the final failure.
    A :class:`ConnectionError`, so outer retry layers treat it as
    transient."""

    def __init__(self, msg: str, last_error=None):
        super().__init__(msg)
        self.last_error = last_error


class _LatencyTracker:
    """Ring of recent successful-attempt latencies; p95 drives the hedge
    delay (hedge only the slowest ~5%, the Tail-at-Scale budget that
    bounds duplicate load to a few percent)."""

    def __init__(self, size: int = 128, min_samples: int = 16):
        self._ring: List[float] = []
        self._size = size
        self._min = min_samples
        self._i = 0
        self._lock = threading.Lock()

    def add(self, dt: float):
        with self._lock:
            if len(self._ring) < self._size:
                self._ring.append(dt)
            else:
                self._ring[self._i] = dt
                self._i = (self._i + 1) % self._size
        _attempt_seconds.observe(dt)

    def p95(self) -> Optional[float]:
        with self._lock:
            if len(self._ring) < self._min:
                return None
            s = sorted(self._ring)
        return s[min(len(s) - 1, int(0.95 * len(s)))]


class _Endpoint:
    """One replica seat: address + breaker + a small idle-connection
    stack (a hedge needs a second live connection while the primary's
    is blocked in recv, so connections are checked out per attempt)."""

    def __init__(self, host: str, port: int, tls: bool, cafile,
                 verify: bool, breaker: CircuitBreaker, score=None):
        self.host, self.port = host, int(port)
        self._tls, self._cafile, self._verify = tls, cafile, verify
        self.breaker = breaker
        # gray-failure rolling score (docs/fault_tolerance.md): EWMA
        # latency/error per seat, walked through probation/ejection by
        # the client's EjectionController
        self.score = score
        # the registry version this seat last echoed ("vN"); None until
        # a reply teaches us — steers version-pinned routing without
        # probe round-trips, and is only a HINT (the server enforces)
        self.seen_version: Optional[str] = None
        # the replica role this seat last advertised (prefill/decode/
        # mixed, docs/disaggregated_serving.md) — learned from reply
        # frames; a prefill seat sheds plain generates, so the planner
        # keeps it out of the front
        self.seen_role: Optional[str] = None
        self._idle: List[_Connection] = []
        self._lock = threading.Lock()

    def acquire(self) -> _Connection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        # in-place transport retries are the failover loop's job: one
        # attempt per checkout keeps hedge timing predictable
        return _Connection(self.host, self.port, tls=self._tls,
                           cafile=self._cafile, verify=self._verify,
                           retry=RetryPolicy(max_attempts=1))

    def release(self, conn: _Connection, healthy: bool):
        if not healthy:
            conn.close()
            return
        with self._lock:
            if len(self._idle) < 4:
                self._idle.append(conn)
                return
        conn.close()

    def close(self):
        with self._lock:
            conns, self._idle = self._idle, []
        for c in conns:
            c.close()

    def __repr__(self):
        return f"_Endpoint({self.host}:{self.port})"


class HAServingClient:
    """``HAServingClient(group.endpoints()).predict(x)`` — one logical
    request over N replicas; ``.generate(prompt, n)`` one logical token
    stream.

    Knob defaults come from the ``ZOO_SERVE_*`` env: ``deadline_ms``
    (``ZOO_SERVE_DEADLINE_MS``, default 30 000; <= 0 disables),
    ``hedge`` (``ZOO_SERVE_HEDGE``, default on), ``hedge_delay_ms``
    (``ZOO_SERVE_HEDGE_DELAY_MS``, default 0 = track p95 and use it,
    starting from 50 ms until enough samples), breaker recovery
    (``ZOO_SERVE_BREAKER_RECOVERY``, default 1 s — a dead replica is
    re-probed quickly because its supervisor respawns it on the same
    port)."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 deadline_ms: Optional[float] = None,
                 hedge: Optional[bool] = None,
                 hedge_delay_ms: Optional[float] = None,
                 tls: bool = False, cafile: Optional[str] = None,
                 verify: bool = True,
                 breaker_failures: int = 2,
                 breaker_recovery: Optional[float] = None,
                 ab_split: Optional[Dict[str, float]] = None,
                 eject: Optional[bool] = None,
                 ejection_config: Optional[EjectionConfig] = None,
                 migrate_min_tokens: Optional[int] = None,
                 route_prefix_weight: Optional[float] = None,
                 route_occ_weight: Optional[float] = None,
                 tenant: Optional[str] = None,
                 tenant_pins: Optional[Dict[str, str]] = None):
        """``eject`` toggles gray-failure ejection (default: the
        ``ZOO_EJECT`` env, on); ``ejection_config`` overrides the full
        ``ZOO_EJECT_*`` knob set. ``route_prefix_weight`` /
        ``route_occ_weight`` override ``ZOO_ROUTE_PREFIX_WEIGHT`` /
        ``ZOO_ROUTE_OCC_WEIGHT``, the plan re-ranking weights for prefix
        affinity and decode occupancy (0 disables a signal).
        ``migrate_min_tokens`` gates the prefill→decode handoff pair,
        which waits for ROADMAP A.5: the plan never pairs. ``ab_split``
        (default ``ZOO_SERVE_AB_SPLIT``) pins fractions of predict
        traffic to registry versions; ``tenant_pins`` (default
        ``ZOO_TENANT_AB_PINS``) pins named tenants' traffic ahead of
        the split."""
        if not endpoints:
            raise ValueError("HAServingClient needs at least one endpoint")
        self._ejector = EjectionController(
            ejection_config or EjectionConfig(enabled=eject))
        if deadline_ms is None:
            deadline_ms = env_float("ZOO_SERVE_DEADLINE_MS", 30000.0)
        self.deadline_ms = deadline_ms if deadline_ms > 0 else None
        if hedge is None:
            hedge = os.environ.get("ZOO_SERVE_HEDGE", "1") not in (
                "0", "false", "off")
        self.hedge = bool(hedge)
        if hedge_delay_ms is None:
            hedge_delay_ms = env_float("ZOO_SERVE_HEDGE_DELAY_MS", 0.0)
        self._hedge_delay_ms = hedge_delay_ms  # 0 = p95-tracked
        self._breaker_failures = breaker_failures
        self._breaker_recovery = breaker_recovery \
            if breaker_recovery is not None \
            else env_float("ZOO_SERVE_BREAKER_RECOVERY", 1.0)
        self._tls, self._cafile, self._verify = tls, cafile, verify
        self._eps = [self._make_endpoint(h, p) for h, p in endpoints]
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._lat = _LatencyTracker()
        # A/B version pinning: fractions of traffic stamped with the
        # wire field ``model_version``; the remainder rides unpinned on
        # whatever the replicas serve
        if ab_split is None:
            ab_split = _parse_ab_split(
                os.environ.get("ZOO_SERVE_AB_SPLIT", ""))
        self._ab_lock = threading.Lock()
        self._ab_split = dict(ab_split or {})
        _validate_ab_split(self._ab_split)
        self._ab_rng = random.Random()
        # the tenant stamped on every request (ZOO_TENANT; per-call
        # tenant= overrides); the server echoes it. Per-tenant version
        # pins are consulted ahead of the fractional split
        self.tenant = tenant if tenant is not None \
            else (os.environ.get("ZOO_TENANT") or None)
        if tenant_pins is None:
            tenant_pins = _parse_tenant_pins(
                os.environ.get("ZOO_TENANT_AB_PINS", ""))
        self._ab_pins: Dict[str, str] = dict(tenant_pins or {})
        self._route_prefix_w = float(
            route_prefix_weight if route_prefix_weight is not None
            else _knob_value("ZOO_ROUTE_PREFIX_WEIGHT"))
        self._route_occ_w = float(
            route_occ_weight if route_occ_weight is not None
            else _knob_value("ZOO_ROUTE_OCC_WEIGHT"))
        self._affinity: "OrderedDict[bytes, Tuple[str, int]]" = \
            OrderedDict()
        self._affinity_lock = threading.Lock()

    def _make_endpoint(self, host: str, port: int) -> _Endpoint:
        return _Endpoint(
            host, port, self._tls, self._cafile, self._verify,
            CircuitBreaker(failure_threshold=self._breaker_failures,
                           recovery_timeout=self._breaker_recovery),
            score=self._ejector.new_score(f"{host}:{port}"))

    # -- topology / routing state -----------------------------------------
    def refresh_endpoints(self, endpoints: Sequence[Tuple[str, int]]):
        """Retarget the client onto a new endpoint list WITHOUT losing
        per-endpoint state for seats that survive: a surviving
        ``(host, port)`` keeps its breaker (health memory), idle
        connections and learned role; only genuinely new seats
        start cold, and removed seats have their connections closed.
        This is what a rolling update / future group resize calls
        instead of rebuilding the client."""
        if not endpoints:
            raise ValueError("refresh_endpoints needs at least one "
                             "endpoint")
        with self._rr_lock:
            old = {(ep.host, ep.port): ep for ep in self._eps}
            self._eps = [
                old.pop((h, int(p)), None) or self._make_endpoint(h, p)
                for h, p in endpoints]
            self._rr %= len(self._eps)
        for ep in old.values():  # seats no longer in the group
            ep.close()

    def set_ab_split(self, split: Optional[Dict[str, float]]):
        """Replace the A/B split (``{"v2": 0.1}`` = pin 10% of traffic
        to v2); None/{} returns all traffic to unpinned."""
        split = dict(split or {})
        _validate_ab_split(split)
        with self._ab_lock:
            self._ab_split = split

    def pin_version(self, version: Optional[str], fraction: float = 1.0,
                    tenant: Optional[str] = None):
        """Shorthand: route ``fraction`` of traffic to ``version``
        (1.0 = everything; ``None`` clears the split). With
        ``tenant=``, pin (or clear) that ONE tenant's traffic instead
        — a per-tenant pin wins over the fractional split, so a gold
        tier can ride the stable version while the split canaries
        everyone else."""
        if tenant is not None:
            with self._ab_lock:
                if version is None:
                    self._ab_pins.pop(tenant, None)
                else:
                    self._ab_pins[tenant] = version
            return
        self.set_ab_split(
            {version: float(fraction)} if version is not None else {})

    def _draw_version(self, tenant: Optional[str] = None
                      ) -> Optional[str]:
        with self._ab_lock:
            if tenant and tenant in self._ab_pins:
                return self._ab_pins[tenant]
            if not self._ab_split:
                return None
            split = list(self._ab_split.items())
        r = self._ab_rng.random()
        acc = 0.0
        for version, frac in split:
            acc += frac
            if r < acc:
                return version
        return None

    # -- public API --------------------------------------------------------
    def predict(self, x, deadline_ms: Optional[float] = None,
                uri: str = "_sync_",
                model_version: Optional[str] = None) -> np.ndarray:
        """``model_version`` pins this request to one registry version
        (bypassing the A/B split); unset, the split decides. A pinned
        request is bounced retryable by replicas serving a different
        version, so failover lands it on one that matches."""
        msg = {"op": "predict", "uri": uri, "data": np.asarray(x)}
        if model_version is not None:
            msg["model_version"] = model_version
        resp = self.rpc(msg, deadline_ms=deadline_ms)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp["result"]

    def generate(self, prompt, max_new_tokens: int,
                 deadline_ms: Optional[float] = None,
                 hedge: Optional[bool] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 tenant: Optional[str] = None):
        """Stream one generation over the replica group: yields tokens
        (ints) as frames arrive. ``temperature``/``top_k``/``top_p``/
        ``seed`` select on-device sampling (unset = greedy, or the
        server's ``ZOO_LLM_SAMPLING`` default); the seed defaults to a
        stable hash of the request id on the server, so every attempt
        of this stream — retries, hedges, failover resumes — draws the
        same tokens on any replica. ``spec_k`` caps the stream's
        speculative-decoding draft budget on the replica (None = the
        replica's ``ZOO_LLM_SPEC_K`` deployment default, 0 = no
        drafting for this stream); speculative or not, the token
        stream is byte-identical, so failover may freely land a
        resumed stream on a replica with a different budget.
        ``trace_id`` rides every attempt's wire frame when given (the
        port mints none: spans wait for ROADMAP A.6).

        The HA contracts, applied per stream:

        * **deadline** — one budget covers the whole stream; the engine
          expires it mid-decode and this raises
          :class:`DeadlineExceeded`.
        * **failover with resume** — a transport failure or retryable
          shed mid-stream moves to the next replica with
          ``resume_from = tokens_already_received``. Replicas hold
          bit-identical weights and decode greedily, so the fresh
          replica regenerates the same stream and sends only the
          unseen suffix: the caller observes a pause, never a gap,
          duplicate, or error.
        * **first-token hedge** — when no frame has arrived within the
          p95-tracked hedge delay, ONE duplicate stream starts on the
          next replica (same id, so a same-replica landing joins the
          live stream via the engine's dedup instead of decoding
          twice); whichever produces the first content frame becomes
          the stream, the loser's connection closes (its server drops
          the last subscriber and frees the KV blocks).
        """
        rid = uuid.uuid4().hex
        tid = trace_id
        dl = Deadline.from_ms(
            deadline_ms if deadline_ms is not None else self.deadline_ms)
        use_hedge = self.hedge if hedge is None else bool(hedge)
        # tenant identity: per-call override, else the client-wide
        # tenant (ZOO_TENANT); it rides the frame and is echoed back
        ten = tenant if tenant is not None else self.tenant
        prompt = np.asarray(prompt)
        received = 0
        results: "_queue.Queue" = _queue.Queue()
        attempts: List[Dict] = []
        # the plan never pairs a prefill->decode handoff: that waits
        # for ROADMAP A.5 (disaggregation)
        order, sig = self._plan_generate(prompt)
        # every endpoint may be tried twice (once pre-, once post-
        # failure) before the stream gives up
        budget = 2 * len(order)
        candidates = list(order) + list(order)
        chosen: Optional[Dict] = None
        last_err: Optional[BaseException] = None

        def claim_conn(att):
            """Take exclusive ownership of the attempt's connection
            (None when the other side — releaser or killer — already
            took it)."""
            with att["conn_lock"]:
                conn, att["conn"] = att["conn"], None
            return conn

        def fire(ep: _Endpoint, is_hedge: bool = False):
            att = {"ep": ep, "stop": threading.Event(), "conn": None,
                   "hedge": is_hedge, "dead": False,
                   "resume_from": received,
                   "t0": time.perf_counter(),
                   # exactly-once connection ownership: the attempt
                   # thread RELEASES (pool) and kill() CLOSES — whoever
                   # claims the conn under this lock first wins, so a
                   # connection already handed back to the pool can
                   # never be closed under a NEW request that checked
                   # it out (the close would not even wake that
                   # request's blocked recv — it would stall for its
                   # whole deadline)
                   "conn_lock": threading.Lock()}
            attempts.append(att)

            def run():
                # exactly ONE terminal event per attempt ("err"/"end"),
                # stopped or not — the arbiter's in_flight counter
                # depends on it
                try:
                    conn = ep.acquire()
                except OSError as e:
                    ep.breaker.record_failure()
                    self._score_err(ep)
                    results.put(("err", att, e))
                    return
                att["conn"] = conn
                msg = {"op": "generate", "id": rid,
                       "prompt": prompt,
                       "max_new_tokens": int(max_new_tokens),
                       "resume_from": received}
                if tid is not None:
                    msg["trace"] = tid
                if ten is not None:
                    msg["tenant"] = ten
                for key, val in (("temperature", temperature),
                                 ("top_k", top_k), ("top_p", top_p),
                                 ("seed", seed), ("spec_k", spec_k)):
                    if val is not None:
                        msg[key] = val
                try:
                    for frame in conn.stream(dict(msg), deadline=dl):
                        results.put(("frame", att, frame))
                        if att["stop"].is_set():
                            break
                except Exception as e:  # noqa: BLE001 — the arbiter
                    # owns the verdict; a leaked exception would strand
                    # in_flight and hang the stream
                    if not (att["stop"].is_set()
                            or isinstance(e, DeadlineExceeded)):
                        ep.breaker.record_failure()
                        self._score_err(ep)
                    mine = claim_conn(att)
                    if mine is not None:
                        ep.release(mine, healthy=False)
                    results.put(("err", att, e))
                    return
                mine = claim_conn(att)
                if mine is not None:
                    ep.release(mine, healthy=not att["stop"].is_set())
                results.put(("end", att, None))

            threading.Thread(target=run, daemon=True,
                             name="zoo-ha-stream").start()
            return att

        def kill(att):
            att["stop"].set()
            conn = claim_conn(att)
            if conn is not None:
                conn.close()  # the server sees the drop; when this was
                #               the last subscriber it cancels the
                #               stream and frees its KV blocks.
                # claim_conn: an attempt whose thread ALREADY released
                # this connection (pool) must never have it closed here
                # — a fresh request may have checked it out, and the
                # close would stall that request's blocked recv for its
                # whole deadline (the bug the chaos storm caught)

        def others_racing(att):
            return any(a is not att and not a["dead"]
                       and not a["stop"].is_set() for a in attempts)

        def can_fire():
            return bool(candidates) and budget > 0 and (
                dl is None or not dl.expired())

        in_flight = 1
        budget -= 1
        fire(candidates.pop(0))
        hedged = False
        try:
            while in_flight:
                can_hedge = (use_hedge and not hedged and chosen is None
                             and can_fire())
                timeout = self._hedge_delay() if can_hedge else None
                if dl is not None:
                    rem = max(0.0, dl.remaining()) + 0.5
                    timeout = rem if timeout is None else min(timeout,
                                                              rem)
                try:
                    kind, att, payload = results.get(timeout=timeout)
                except _queue.Empty:
                    if can_hedge:
                        hedged = True
                        _hedge.labels(event="fired").inc()
                        budget -= 1
                        in_flight += 1
                        fire(candidates.pop(0), is_hedge=True)
                        continue
                    raise DeadlineExceeded(
                        "stream deadline expired waiting for frames"
                    ) from last_err
                if kind in ("err", "end"):
                    in_flight -= 1
                    att["dead"] = True
                    if att["stop"].is_set():
                        continue
                    if kind == "end":
                        continue
                    last_err = payload
                    if isinstance(payload, DeadlineExceeded):
                        raise payload
                    if att is chosen:
                        chosen = None
                    # failover-with-resume: only when nobody else is
                    # still racing for (or producing) frames
                    if chosen is None and not others_racing(att) \
                            and can_fire():
                        _failover.inc()
                        budget -= 1
                        in_flight += 1
                        fire(candidates.pop(0))
                    continue
                frame = payload
                # every reply frame advertises the seat's replica role
                # (docs/disaggregated_serving.md) — learn it passively,
                # shed bounces included, so the NEXT plan keeps prefill
                # seats out of the plain-generate front
                if frame.get("role") is not None:
                    self._learn_role(att["ep"], frame["role"])
                if att["stop"].is_set() or (chosen is not None
                                            and att is not chosen):
                    continue
                if frame.get("shed") and frame.get("retryable"):
                    kill(att)
                    last_err = NoReplicaAvailable(
                        frame.get("error", "shed"), None)
                    if att is chosen:
                        chosen = None
                    if not others_racing(att) and can_fire():
                        _failover.inc()
                        budget -= 1
                        in_flight += 1
                        fire(candidates.pop(0))
                    continue
                if frame.get("done") and \
                        frame.get("outcome") == "cancelled":
                    # the replica gave up the stream (engine stopped /
                    # graceful shutdown) — not a client cancel, we are
                    # still here reading. Tokens in the terminal frame
                    # are a valid prefix (greedy decode); keep them and
                    # resume the remainder on another replica, same as
                    # a transport loss. Any still-racing attempt (an
                    # unresolved hedge) was fired with an OLDER
                    # resume_from — kill it BEFORE advancing the
                    # cursor, or its stream could later be adopted and
                    # re-deliver these tokens
                    for other in attempts:
                        if other is not att and not other["dead"] \
                                and not other["stop"].is_set():
                            kill(other)
                    for tok in frame.get("tokens") or ():
                        received += 1
                        yield int(tok)
                    kill(att)
                    last_err = NoReplicaAvailable(
                        frame.get("error", "stream cancelled by "
                                           "replica"), None)
                    if att is chosen:
                        chosen = None
                    if not others_racing(att) and can_fire():
                        _failover.inc()
                        budget -= 1
                        in_flight += 1
                        fire(candidates.pop(0))
                    continue
                if chosen is None and (frame.get("tokens")
                                       or frame.get("done")):
                    chosen = att
                    att["ep"].breaker.record_success()
                    # the gray-failure signal for a stream is its
                    # time-to-first-content — a 50x-slow decoder shows
                    # up here long before any transport error would
                    self._score_ok(att["ep"],
                                   time.perf_counter() - att["t0"])
                    # remember which seat streams this prompt prefix —
                    # the NEXT same-prefix generate plans it first and
                    # rides its (local or adopted) KV prefix cache
                    self._note_affinity(sig, att["ep"])
                    if att["hedge"]:
                        _hedge.labels(event="won").inc()
                    for other in attempts:
                        if other is not att and not other["dead"] \
                                and not other["stop"].is_set():
                            kill(other)
                if att is not chosen:
                    continue
                if frame.get("expired") or \
                        frame.get("outcome") == "expired":
                    raise DeadlineExceeded(
                        frame.get("error",
                                  "server expired the stream"))
                for tok in frame.get("tokens") or ():
                    received += 1
                    yield int(tok)
                if frame.get("done"):
                    if frame.get("outcome") not in ("ok", None):
                        raise RuntimeError(
                            frame.get("error",
                                      f"stream {frame.get('outcome')}"))
                    return
            if dl is not None and dl.expired():
                raise DeadlineExceeded(
                    "stream deadline expired during failover"
                ) from last_err
            raise NoReplicaAvailable(
                f"all {len(self._eps)} replica(s) failed the stream: "
                f"{last_err!r}", last_err)
        finally:
            for att in attempts:
                kill(att)

    # -- gray-failure scoring (docs/fault_tolerance.md) --------------------
    def _score_ok(self, ep: _Endpoint, dt: float):
        if ep.score is not None:
            ep.score.record(dt, self._ejector.cfg.alpha)

    def _score_err(self, ep: _Endpoint):
        if ep.score is not None:
            ep.score.record_error(self._ejector.cfg.alpha)

    def ejection_states(self) -> Dict[str, Dict]:
        """Per-seat gray-failure snapshot — state, EWMA latency, error
        rate (what the chaos storm and the bench assert on)."""
        return {f"{ep.host}:{ep.port}": ep.score.snapshot()
                for ep in self._eps if ep.score is not None}

    def ejection_events(self) -> List[tuple]:
        """The controller's bounded ``(ts, event, seat)`` transition
        log (monotonic timestamps) — detect-to-eject latency reads
        straight off it."""
        with self._ejector._lock:
            return list(self._ejector.events)

    def stats(self) -> List[Optional[Dict]]:
        """Per-replica stage-timer stats (None for a down replica)."""
        out = []
        for ep in self._eps:
            conn = None
            try:
                conn = ep.acquire()
                out.append(conn.rpc({"op": "stats"}))
                ep.release(conn, healthy=True)
            except (OSError, RetryError):
                # a single-attempt connection reports a transport
                # failure as RetryError; the conn must not return to
                # the idle stack
                if conn is not None:
                    ep.release(conn, healthy=False)
                out.append(None)
        return out

    def close(self):
        for ep in self._eps:
            ep.close()

    def _plan(self, version: Optional[str] = None) -> List[_Endpoint]:
        """Rotation for one request: every endpoint exactly once,
        healthy (breaker-admitted, not gray-degraded) seats first,
        starting at the round-robin cursor. Gray-failure states
        (docs/fault_tolerance.md) order the tail: PROBATION seats ride
        behind every active seat (failover/hedge traffic only) except
        when their canary probe is due — then ONE probation seat is
        deliberately planned FIRST so live traffic can prove its
        recovery; open-breaker seats follow; EJECTED seats come dead
        last, reached only when everything else failed. A pinned
        ``version`` additionally floats seats KNOWN to serve it (or not
        yet known) ahead of seats last seen on a different version,
        within each health tier — a hint only; mismatched seats stay in
        the plan because a hot-swap may have moved them since."""
        with self._rr_lock:
            eps = list(self._eps)
            start = self._rr
            self._rr = (self._rr + 1) % len(eps)
        order = [eps[(start + i) % len(eps)] for i in range(len(eps))]
        self._ejector.evaluate([ep.score for ep in order])
        canary: List[_Endpoint] = []
        active: List[_Endpoint] = []
        probation: List[_Endpoint] = []
        dark: List[_Endpoint] = []
        ejected: List[_Endpoint] = []
        for ep in order:
            state = self._ejector.state_of(ep.score)
            if state == EJECTED:
                ejected.append(ep)  # breaker probe not consumed: the
                continue            # seat is out of rotation anyway
            if state == PROBATION and not canary \
                    and self._ejector.take_canary(ep.score):
                canary.append(ep)
                continue
            if not ep.breaker.allow():
                dark.append(ep)
            elif state == PROBATION:
                probation.append(ep)
            else:
                active.append(ep)
        tiers = [t for t in (canary, active, probation, dark, ejected)
                 if t]
        if version is None:
            return [ep for tier in tiers for ep in tier]
        # version preference WITHIN each health tier: a dead seat last
        # seen on the pinned version must never outrank a healthy seat
        # that merely bounced us once
        out = []
        for tier in tiers:
            match = [ep for ep in tier
                     if ep.seen_version in (None, version)]
            out += match + [ep for ep in tier if ep not in match]
        return out

    # -- disaggregated routing (docs/disaggregated_serving.md) -------------
    def _learn_role(self, ep: _Endpoint, role):
        """A reply frame advertised the seat's replica role — remember
        it on the endpoint (planning) and its gray-failure score
        (snapshots/postmortems)."""
        ep.seen_role = str(role)
        if ep.score is not None:
            ep.score.note_role(role)

    def _prompt_sig(self, prompt) -> bytes:
        """Routing prefix signature: a stable hash of the prompt's
        first ``_AFFINITY_PREFIX_TOKENS`` tokens, so prompts sharing a
        preamble (the prefix-cache win) map to one affinity entry."""
        toks = np.asarray(prompt).reshape(-1)[:_AFFINITY_PREFIX_TOKENS]
        h = hashlib.blake2b(b"zoo-route-affinity-v1", digest_size=16)
        for t in toks:
            h.update(int(t).to_bytes(8, "little", signed=True))
        return h.digest()

    def _note_affinity(self, sig: bytes, ep: _Endpoint):
        with self._affinity_lock:
            self._affinity[sig] = (ep.host, ep.port)
            self._affinity.move_to_end(sig)
            while len(self._affinity) > 512:
                self._affinity.popitem(last=False)

    def _plan_generate(self, prompt) -> Tuple[List[_Endpoint], bytes]:
        """Plan for one generate stream: the health-tiered ``_plan()``
        rotation, re-ranked for disaggregation —

        * seats last seen as ``role=prefill`` sink to the back: they
          shed plain generates, so fronting one burns a failover;
        * the rest rank by ``ZOO_ROUTE_PREFIX_WEIGHT`` × prefix
          affinity (this client streamed a same-prefix prompt there
          before) minus ``ZOO_ROUTE_OCC_WEIGHT`` × decode occupancy
          (EWMA busy/total slots from ``llm_stats``), stable-sorted so
          round-robin still breaks ties.

        Emits one ``zoo_serve_route_affinity_total`` sample with the
        decisive reason, and returns the plan plus the prompt's
        affinity signature."""
        order = self._plan()
        sig = self._prompt_sig(prompt)
        with self._affinity_lock:
            aff_seat = self._affinity.get(sig)
        pw, ow = self._route_prefix_w, self._route_occ_w

        def occ(ep: _Endpoint) -> float:
            s = ep.score
            return s.occupancy if s is not None \
                and s.occupancy is not None else 0.0

        serve = [ep for ep in order if ep.seen_role != "prefill"]
        prefill = [ep for ep in order if ep.seen_role == "prefill"]
        serve.sort(key=lambda ep: -(
            pw * (1.0 if (ep.host, ep.port) == aff_seat else 0.0)
            - ow * occ(ep)))
        reason = "rr"
        if serve:
            if pw > 0 and (serve[0].host, serve[0].port) == aff_seat:
                reason = "prefix"
            elif ow > 0 and len({round(occ(ep), 3)
                                 for ep in serve}) > 1:
                reason = "occupancy"
            elif prefill:
                reason = "role"
        _route_affinity.labels(reason=reason).inc()
        return serve + prefill, sig

    def update_topology(self, deadline_ms: float = 2000.0
                        ) -> Dict[str, Optional[Dict]]:
        """Poll every seat's ``llm_stats`` once and refresh the routing
        signals: advertised role and decode occupancy (busy/total
        slots, EWMA-smoothed onto the seat's score). Optional — roles
        are also learned passively from reply frames (a prefill seat
        teaches its role with its first shed) — but one poll primes
        the planner before any traffic has bounced. Returns the raw
        stats per seat (None for a seat that didn't answer)."""
        out: Dict[str, Optional[Dict]] = {}
        for ep in list(self._eps):
            conn = None
            try:
                conn = ep.acquire()
                resp = conn.rpc({"op": "llm_stats"},
                                deadline=Deadline.from_ms(deadline_ms))
                ep.release(conn, healthy=True)
            except (OSError, RetryError):
                if conn is not None:
                    ep.release(conn, healthy=False)
                out[f"{ep.host}:{ep.port}"] = None
                continue
            if resp.get("role") is not None:
                self._learn_role(ep, resp["role"])
            st = resp.get("stats") or {}
            if st.get("role") is not None:
                self._learn_role(ep, st["role"])
            slots = st.get("slots") or 0
            if slots and ep.score is not None:
                ep.score.note_occupancy(
                    float(st.get("active") or 0) / float(slots))
            out[f"{ep.host}:{ep.port}"] = st
        return out

    def _hedge_delay(self) -> float:
        if self._hedge_delay_ms > 0:
            return self._hedge_delay_ms / 1000.0
        p95 = self._lat.p95()
        return p95 if p95 is not None else 0.05

    def rpc(self, msg: Dict, deadline_ms: Optional[float] = None) -> Dict:
        """One request/response op (``predict``, ``ping``, ``version``,
        ``stats``, ``llm_stats``) over the group, with failover and a
        hedged duplicate. A predict without ``model_version`` draws one
        from the tenant's pin, then the A/B split; the pin (or its
        absence) holds across every attempt of the request."""
        # own copy: the shared id must ride EVERY attempt of this call,
        # but never leak into the caller's dict
        msg = dict(msg)
        msg.setdefault("id", uuid.uuid4().hex)
        if self.tenant is not None and "tenant" not in msg:
            msg["tenant"] = self.tenant
        is_predict = msg.get("op") == "predict"
        if is_predict and "model_version" not in msg:
            drawn = self._draw_version(msg.get("tenant"))
            if drawn is not None:
                msg["model_version"] = drawn
        want = msg.get("model_version")
        if not is_predict:
            # probes must not pollute the per-version series
            return self._rpc_attempts(msg, deadline_ms, want)
        ab_label = want if want is not None else "unpinned"
        t_req = time.perf_counter()
        try:
            resp = self._rpc_attempts(msg, deadline_ms, want)
        except DeadlineExceeded:
            _ab_requests.labels(version=ab_label,
                                outcome="expired").inc()
            raise
        except Exception:
            _ab_requests.labels(version=ab_label, outcome="failed").inc()
            raise
        _ab_requests.labels(
            version=ab_label,
            outcome="error" if "error" in resp else "ok").inc()
        _ab_latency.labels(version=ab_label).observe(
            time.perf_counter() - t_req)
        return resp

    def _rpc_attempts(self, msg: Dict, deadline_ms: Optional[float],
                      want: Optional[str] = None) -> Dict:
        dl = Deadline.from_ms(
            deadline_ms if deadline_ms is not None else self.deadline_ms)
        plan = self._plan(version=want)
        # every seat may be tried twice (once pre-, once post-failure)
        # before the request gives up — the same budget generate() has
        # always had. One corrupt frame / reset per seat must not
        # exhaust a 3-seat group: transient faults are per-CONNECTION,
        # and the second pass rides a fresh one.
        candidates = list(plan) + list(plan)
        results: "_queue.Queue" = _queue.Queue()
        in_flight = 0
        last_err: Optional[BaseException] = None
        hedge_ep: Optional[_Endpoint] = None  # who got the duplicate

        def fire(ep: _Endpoint):
            nonlocal in_flight
            in_flight += 1

            def run():
                t0 = time.perf_counter()
                try:
                    conn = ep.acquire()
                except OSError as e:
                    ep.breaker.record_failure()
                    self._score_err(ep)
                    results.put(("err", ep, e))
                    return
                try:
                    # per-attempt copy: each attempt stamps its own
                    # remaining deadline_ms without racing the others
                    resp = conn.rpc(dict(msg), deadline=dl)
                except Exception as e:  # noqa: BLE001 — every attempt
                    # failure must reach the arbiter; a leaked exception
                    # would strand in_flight and hang the request
                    ep.release(conn, healthy=False)
                    if not isinstance(e, DeadlineExceeded):
                        # RetryError wraps the underlying transport
                        # failure; either way the seat just failed
                        ep.breaker.record_failure()
                        self._score_err(ep)
                    results.put(("err", ep, e))
                    return
                ep.release(conn, healthy=True)
                results.put(("ok", ep, resp, time.perf_counter() - t0))

            threading.Thread(target=run, daemon=True,
                             name="zoo-ha-attempt").start()

        fire(candidates.pop(0))
        hedged = False
        while in_flight:
            # phase 1: wait only up to the hedge delay, then duplicate
            # to the next replica (same id — the server dedups)
            can_hedge = (self.hedge and not hedged and candidates
                         and (dl is None or not dl.expired()))
            if can_hedge:
                delay = self._hedge_delay()
                if dl is not None:
                    delay = min(delay, max(0.0, dl.remaining()))
                try:
                    item = results.get(timeout=delay)
                except _queue.Empty:
                    hedged = True
                    _hedge.labels(event="fired").inc()
                    hedge_ep = candidates.pop(0)
                    fire(hedge_ep)
                    continue
            else:
                timeout = None
                if dl is not None:
                    timeout = max(0.0, dl.remaining()) + 0.5
                try:
                    item = results.get(timeout=timeout)
                except _queue.Empty:
                    raise DeadlineExceeded(
                        f"deadline expired with {in_flight} attempt(s) "
                        "still in flight") from last_err
            in_flight -= 1
            if item[0] == "ok":
                _kind, ep, resp, dt = item
                if resp.get("version") is not None:
                    # every frame teaches us what this seat serves —
                    # version-mismatch bounces included, so the NEXT
                    # pinned request plans around it
                    ep.seen_version = resp["version"]
                if resp.get("role") is not None:
                    self._learn_role(ep, resp["role"])
                if resp.get("shed") and resp.get("retryable"):
                    # overload shed or version bounce: the replica is
                    # alive — fail over without charging its breaker
                    last_err = NoReplicaAvailable(
                        resp.get("error", "shed"), None)
                    if candidates and (dl is None or not dl.expired()):
                        _failover.inc()
                        fire(candidates.pop(0))
                    continue
                if resp.get("expired"):
                    raise DeadlineExceeded(resp.get(
                        "error", "server reported deadline expired"))
                ep.breaker.record_success()
                self._lat.add(dt)
                self._score_ok(ep, dt)
                if ep is hedge_ep:
                    # the hedged DUPLICATE answered first (a failover
                    # attempt winning is not a hedge win)
                    _hedge.labels(event="won").inc()
                return resp
            _kind, ep, err = item
            last_err = err
            if isinstance(err, DeadlineExceeded):
                raise err
            if candidates and (dl is None or not dl.expired()):
                _failover.inc()
                fire(candidates.pop(0))
        if dl is not None and dl.expired():
            raise DeadlineExceeded(
                "deadline expired during failover") from last_err
        raise NoReplicaAvailable(
            f"all {len(self._eps)} replica(s) failed or shed the "
            f"request: {last_err!r}", last_err)
