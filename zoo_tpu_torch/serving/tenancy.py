"""Multi-tenant QoS config: tenant identities, token-bucket admission,
and the fairness/priority parameters the serving stack schedules by
(counterpart of ``zoo_tpu/serving/tenancy.py``).

The stack threads a ``tenant`` id through every layer:

* the wire carries ``tenant`` beside ``trace``, echoed on every reply
  including sheds;
* :class:`~zoo_tpu_torch.serving.server.ServingServer` and
  :class:`~zoo_tpu_torch.serving.llm.engine.LLMEngine` gate admission
  on the tenant's **token bucket** and compute ``retry_after_ms`` from
  THAT bucket's refill time — one tenant's flood never inflates another
  tenant's backoff hint;
* the engine scheduler spends decode slots **weighted-fair** across
  tenants (lowest served-work/weight first), enforces per-tenant KV and
  slot quotas, and preempts **youngest-within-lowest-priority-class**,
  so a paid tier displaces best-effort streams, never a peer;
* the :class:`~zoo_tpu_torch.serving.llm.kv_cache.BlockAllocator`
  partitions the prefix cache per tenant (tenant-salted content hashes
  and per-tenant eviction), so one tenant's LRU churn cannot evict
  another tenant's hot system prompt.

The whole layer is a no-op when no tenant config exists:
:attr:`TenantRegistry.enabled` is False, every request maps to the
unlabeled :data:`DEFAULT_TENANT`, hash salting is empty, and the
scheduler keeps the exact FIFO / youngest-first behaviour.

Config comes from ``ZOO_TENANT_CONFIG``, a semicolon-separated spec::

    gold:weight=4,class=0,rate=50,burst=100,kv=64,slots=2;free:rate=5

with per-field defaults from the ``ZOO_TENANT_DEFAULT_*`` knobs.
``class`` is the priority class — LOWER is more important (class 0
preempts class 1). ``rate`` is requests/second (0 = unlimited),
``burst`` the bucket depth, ``kv`` a cap on live KV blocks, ``slots``
a cap on concurrent decode slots (0 = unlimited for all three).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

from zoo_tpu_torch.util.resilience import env_float, env_int

logger = logging.getLogger(__name__)

__all__ = [
    "DEFAULT_TENANT", "TenantConfig", "TenantRegistry",
    "parse_tenant_spec", "registry", "reset_registry",
]

#: the unlabeled tenant: requests with no ``tenant`` field land here,
#: and its empty hash salt and default weight/class keep the
#: single-tenant path exactly as it is without tenancy
DEFAULT_TENANT = ""


class TenantConfig:
    """One tenant's QoS parameters. ``priority`` is the preemption
    class (lower = more important); ``weight`` scales the tenant's
    share of decode slots under contention; ``rate``/``burst``
    parameterize the admission token bucket; ``max_kv_blocks`` /
    ``max_slots`` are hard caps on live resources (0 = unlimited)."""

    __slots__ = ("name", "weight", "priority", "rate", "burst",
                 "max_kv_blocks", "max_slots")

    def __init__(self, name: str, weight: float = 1.0,
                 priority: int = 1, rate: float = 0.0,
                 burst: float = 0.0, max_kv_blocks: int = 0,
                 max_slots: int = 0):
        self.name = str(name)
        self.weight = max(1e-6, float(weight))
        self.priority = int(priority)
        self.rate = max(0.0, float(rate))
        self.burst = max(0.0, float(burst))
        self.max_kv_blocks = max(0, int(max_kv_blocks))
        self.max_slots = max(0, int(max_slots))

    def __repr__(self):
        return (f"TenantConfig({self.name!r}, weight={self.weight}, "
                f"class={self.priority}, rate={self.rate}, "
                f"burst={self.burst}, kv={self.max_kv_blocks}, "
                f"slots={self.max_slots})")


_FIELD_KEYS = {"weight": "weight", "class": "priority",
               "rate": "rate", "burst": "burst",
               "kv": "max_kv_blocks", "slots": "max_slots"}


def parse_tenant_spec(spec: str, default_weight: float = 1.0,
                      default_class: int = 1,
                      default_rate: float = 0.0
                      ) -> Dict[str, TenantConfig]:
    """Parse ``ZOO_TENANT_CONFIG`` (see the module docstring). A
    malformed entry is skipped with a warning rather than failing a
    replica at boot."""
    out: Dict[str, TenantConfig] = {}
    for entry in (spec or "").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, _, fields = entry.partition(":")
        name = name.strip()
        if not name:
            logger.warning("bad tenant entry %r: empty name", entry)
            continue
        kw = {"weight": default_weight, "priority": default_class,
              "rate": default_rate}
        ok = True
        for field in fields.split(","):
            field = field.strip()
            if not field:
                continue
            key, eq, val = field.partition("=")
            attr = _FIELD_KEYS.get(key.strip())
            if attr is None or not eq:
                logger.warning("bad tenant field %r in %r", field, entry)
                ok = False
                break
            try:
                kw[attr] = float(val)
            except ValueError:
                logger.warning("bad tenant value %r in %r", field, entry)
                ok = False
                break
        if ok:
            out[name] = TenantConfig(name, **kw)
    return out


class _TokenBucket:
    """Token bucket: ``rate`` tokens/second refill up to ``burst``
    capacity; a request costs one token. ``rate <= 0`` means unlimited
    (always admits, zero retry hint). Thread-safe."""

    def __init__(self, rate: float, burst: float = 0.0):
        self.rate = max(0.0, float(rate))
        self.burst = float(burst) if burst > 0 else max(1.0, self.rate)
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float):
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_ms(self, n: float = 1.0) -> int:
        """Milliseconds until THIS bucket can fund ``n`` tokens — the
        per-tenant shed hint (never another tenant's backlog)."""
        if self.rate <= 0:
            return 0
        with self._lock:
            self._refill(time.monotonic())
            deficit = n - self._tokens
            if deficit <= 0:
                return 1
            return max(1, int(deficit / self.rate * 1000.0) + 1)


class TenantRegistry:
    """Tenant configs and admission buckets, normally built once from
    the environment (:func:`registry`). :attr:`enabled` is the switch
    every caller gates on: False (no config, or ``ZOO_QOS=0``) leaves
    the stack exactly single-tenant."""

    def __init__(self, spec: Optional[str] = None,
                 qos: Optional[bool] = None,
                 default_weight: Optional[float] = None,
                 default_class: Optional[int] = None,
                 default_rate: Optional[float] = None):
        if spec is None:
            spec = os.environ.get("ZOO_TENANT_CONFIG", "")
        if qos is None:
            qos = env_int("ZOO_QOS", 1) != 0
        if default_weight is None:
            default_weight = env_float("ZOO_TENANT_DEFAULT_WEIGHT", 1.0)
        if default_class is None:
            default_class = env_int("ZOO_TENANT_DEFAULT_CLASS", 1)
        if default_rate is None:
            default_rate = env_float("ZOO_TENANT_DEFAULT_RATE", 0.0)
        self._default = TenantConfig(DEFAULT_TENANT,
                                     weight=default_weight,
                                     priority=default_class,
                                     rate=default_rate)
        self.configs = parse_tenant_spec(
            spec, default_weight=default_weight,
            default_class=default_class, default_rate=default_rate)
        self.enabled = bool(qos) and bool(self.configs)
        self._buckets: Dict[str, _TokenBucket] = {}
        self._lock = threading.Lock()

    def config(self, tenant: Optional[str]) -> TenantConfig:
        """The tenant's config; unknown and unlabeled tenants get the
        default one (``ZOO_TENANT_DEFAULT_*``)."""
        return self.configs.get(tenant or DEFAULT_TENANT, self._default)

    def bucket(self, tenant: Optional[str]) -> _TokenBucket:
        name = tenant or DEFAULT_TENANT
        with self._lock:
            b = self._buckets.get(name)
            if b is None:
                cfg = self.config(name)
                b = _TokenBucket(cfg.rate, cfg.burst)
                self._buckets[name] = b
            return b

    def admit(self, tenant: Optional[str]) -> Tuple[bool, int]:
        """Charge one request to the tenant's bucket: ``(admitted,
        retry_after_ms)``, the hint from the SHEDDING tenant's own
        refill time, 0 when admitted or when the layer is disabled."""
        if not self.enabled:
            return True, 0
        b = self.bucket(tenant)
        if b.try_acquire():
            return True, 0
        return False, b.retry_after_ms()

    def salt(self, tenant: Optional[str]) -> bytes:
        """Per-tenant prefix-hash salt: distinct tenants never share (or
        collide with) each other's prefix-cache entries. Empty when
        disabled or for the default tenant, so unlabeled traffic hashes
        exactly as without tenancy."""
        if not self.enabled or not tenant:
            return b""
        return b"tenant:" + tenant.encode("utf-8", "replace")


_registry: Optional[TenantRegistry] = None
_registry_lock = threading.Lock()


def registry() -> TenantRegistry:
    """The process-wide registry, built lazily from the environment."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = TenantRegistry()
        return _registry


def reset_registry(reg: Optional[TenantRegistry] = None):
    """Swap (or drop, to re-read the environment) the process registry,
    after ``ZOO_TENANT_*`` changed."""
    global _registry
    with _registry_lock:
        _registry = reg
