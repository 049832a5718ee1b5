"""Paged KV-cache block allocator with content-hash prefix sharing and
copy-on-write, tenant partitions and migration adoption (counterpart of
``zoo_tpu/serving/llm/kv_cache.py``, with its pool gauges).

KV memory is a pool of fixed-size token blocks handed out from a free
list: a sequence owns ``ceil(tokens / block_size)`` blocks listed in its
block table; blocks return to the pool the moment the stream finishes,
aborts or is preempted; and admission is gated on the free list.

With ``prefix_cache=True`` every FULL prompt block is keyed by a
rolling content hash (:func:`prefix_block_hashes`), blocks carry a
refcount, a block reaching refcount 0 with a registered hash parks on a
cached-free LRU (still matchable, reclaimed lazily), eviction never
touches a referenced block, and a sequence about to write into a shared
block forks it first (:meth:`BlockAllocator.make_writable`).

With tenancy on, hashes are salted per tenant, freed cached blocks park
in their tenant's partition, and eviction reclaims the requester's own
partition first, then the shared ``""`` one, and another tenant's only
as a last resort (counted). Untagged, eviction is the one global LRU.

:meth:`BlockAllocator.adopt_blocks` binds a sequence whose KV another
replica prefilled and streamed over ``kv_migrate``: the locally
matchable leading blocks are aliased, the rest taken fresh and
registered under the incoming hashes.

Block 0 is reserved as the trash block: inactive decode slots point
their table at it, so a fixed-shape tick always has a legal write
target.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zoo_tpu_torch.obs.metrics import counter, gauge

_migrated_blocks = counter(
    "zoo_llm_kv_migrated_blocks_total",
    "KV blocks adopted from another replica's prefill via kv_migrate "
    "(fresh blocks materialized for wire payloads; locally-matched "
    "prefix blocks are counted as prefix-cache hits instead)")
_blocks_used = gauge(
    "zoo_llm_kv_blocks_used",
    "KV-cache blocks currently owned by live sequences")
_blocks_free = gauge(
    "zoo_llm_kv_blocks_free",
    "KV-cache blocks on the allocator free list")
_blocks_shared = gauge(
    "zoo_llm_kv_blocks_shared",
    "KV-cache blocks referenced by MORE than one live sequence "
    "(prefix-cache hits sharing a prompt's blocks)")
_blocks_cached = gauge(
    "zoo_llm_kv_blocks_cached",
    "Refcount-0 blocks parked on the prefix-cache LRU (matchable, "
    "reclaimed lazily)")
_cross_evictions = counter(
    "zoo_tenant_kv_cross_evictions_total",
    "Cached-free blocks evicted ACROSS tenant partitions (last-resort "
    "reclaim when the requester's own and the shared partitions are "
    "both empty)", labels=("tenant",))


def prefix_block_hashes(tokens: Sequence[int],
                        block_size: int,
                        salt: bytes = b"") -> List[bytes]:
    """Rolling content hash per FULL block of ``tokens``: block ``i``'s
    key digests (key of block ``i-1``, the block's token ids), so equal
    keys imply the whole prefix through block ``i`` is identical.
    Partial trailing tokens produce no hash. ``salt`` folds a namespace
    (the tenant) into the chain seed; the empty salt is the unlabeled
    chain. Same bytes as the JAX package's chain."""
    out: List[bytes] = []
    prev = b"zoo-kv-prefix-v1" + salt
    n_full = len(tokens) // block_size
    if not n_full:
        return out
    buf = np.ascontiguousarray(
        np.asarray(tokens[:n_full * block_size], dtype="<i4")).tobytes()
    stride = block_size * 4
    for i in range(n_full):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(buf[i * stride:(i + 1) * stride])
        prev = h.digest()
        out.append(prev)
    return out


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size token blocks.
    ``prefix_cache=False`` keeps every block private and returns freed
    blocks straight to the free list."""

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        self._lock = threading.Lock()
        # LIFO free list: a just-freed block is re-handed warm
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owners: Dict[str, List[int]] = {}
        self._ref: Dict[int, int] = {}            # absent = 0
        self._hash_of: Dict[int, bytes] = {}
        self._by_hash: Dict[bytes, int] = {}
        # refcount-0 cached blocks, LRU first
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # tenant partitions: a parked block's owner tenant, and each
        # sequence's tenant (empty everywhere when tenancy is off)
        self._part_of: Dict[int, str] = {}
        self._tenant_of: Dict[str, str] = {}
        # per-SEQUENCE replay state (the sampling seed), never per block
        self._aux: Dict[str, Dict] = {}
        self._publish()

    # -- accounting --------------------------------------------------------
    def _publish(self):
        _blocks_free.set(len(self._free))
        _blocks_used.set(self.num_blocks - 1 - len(self._free)
                         - len(self._cached))
        _blocks_shared.set(sum(1 for r in self._ref.values() if r > 1))
        _blocks_cached.set(len(self._cached))

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def cached_blocks(self) -> int:
        with self._lock:
            return len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Blocks referenced by at least one live sequence (a shared
        block counts once)."""
        with self._lock:
            return self.num_blocks - 1 - len(self._free) \
                - len(self._cached)

    @property
    def shared_blocks(self) -> int:
        with self._lock:
            return sum(1 for r in self._ref.values() if r > 1)

    def blocks_of(self, seq_id: str) -> List[int]:
        with self._lock:
            return list(self._owners.get(seq_id, ()))

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.block_size))

    def set_tenant(self, seq_id: str, tenant: str):
        """Tag ``seq_id`` with its tenant partition BEFORE it acquires
        blocks: its freed cached blocks park in that partition and its
        allocations evict from it first. Untagged sequences live in the
        shared ``""`` partition."""
        with self._lock:
            if tenant:
                self._tenant_of[seq_id] = str(tenant)
            else:
                self._tenant_of.pop(seq_id, None)

    def used_by_tenant(self) -> Dict[str, int]:
        """Physical blocks owned per tenant partition (a block shared by
        two of a tenant's sequences counts once)."""
        with self._lock:
            seen: Dict[str, set] = {}
            for seq, blocks in self._owners.items():
                t = self._tenant_of.get(seq, "")
                seen.setdefault(t, set()).update(blocks)
            return {t: len(s) for t, s in seen.items()}

    def set_aux(self, seq_id: str, **aux):
        with self._lock:
            self._aux.setdefault(seq_id, {}).update(aux)

    def get_aux(self, seq_id: str) -> Optional[Dict]:
        with self._lock:
            aux = self._aux.get(seq_id)
            return dict(aux) if aux is not None else None

    # -- allocation --------------------------------------------------------
    def can_admit(self, prompt_len: int, cached_blocks: int = 0,
                  needs_cow: bool = False) -> bool:
        """Enough blocks for a prompt PLUS its first decode block.
        ``cached_blocks`` (the expected prefix hit) is counted
        conservatively — as if every matched block sat on the
        cached-free LRU — and ``needs_cow`` budgets the fork."""
        need = self.blocks_for_tokens(prompt_len + 1)
        need -= min(int(cached_blocks), need)
        if needs_cow:
            need += 1
        with self._lock:
            evictable = max(0, len(self._cached) - int(cached_blocks))
            return len(self._free) + evictable >= need

    def _evict_one(self, tenant: str = ""):
        """Under the lock: reclaim one cached-free block. A tagged
        requester takes the LRU block of its OWN partition, then of the
        shared ``""`` one, and only when both are empty the global LRU
        head (a counted cross-tenant eviction); an untagged requester
        takes the global LRU head."""
        blk = None
        if tenant:
            for b in self._cached:                  # LRU -> MRU order
                if self._part_of.get(b, "") == tenant:
                    blk = b
                    break
            if blk is None:
                for b in self._cached:
                    if not self._part_of.get(b, ""):
                        blk = b
                        break
            if blk is None:
                blk = next(iter(self._cached))      # cross-tenant
                _cross_evictions.labels(tenant=tenant).inc()
            self._cached.pop(blk)
        else:
            blk, _ = self._cached.popitem(last=False)
        self._part_of.pop(blk, None)
        h = self._hash_of.pop(blk, None)
        if h is not None:
            self._by_hash.pop(h, None)
        self._free.append(blk)

    def _take_free(self, n: int, tenant: str = "") -> Optional[List[int]]:
        """Under the lock: pop ``n`` blocks, evicting cached-free blocks
        (``tenant``'s partition first) when the free list runs short.
        Referenced blocks are never evicted."""
        while len(self._free) < n and self._cached:
            self._evict_one(tenant)
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def allocate(self, seq_id: str, n_blocks: int) -> Optional[List[int]]:
        """Grow ``seq_id`` by ``n_blocks`` private blocks, all or
        nothing (None when the pool cannot cover the ask)."""
        if n_blocks <= 0:
            raise ValueError("n_blocks must be positive")
        with self._lock:
            got = self._take_free(n_blocks,
                                  self._tenant_of.get(seq_id, ""))
            if got is None:
                return None
            for b in got:
                self._ref[b] = 1
            self._owners.setdefault(seq_id, []).extend(got)
            self._publish()
            return got

    def grow_to(self, seq_id: str, n_tokens: int) -> int:
        """Grow ``seq_id``, one free (or evictable cached-free) block at
        a time, until it holds ``n_tokens``, stopping quietly when the
        pool runs dry; never preempts. Returns the token capacity (owned
        blocks x block_size), 0 for an unknown sequence. Speculation
        funds its draft rows through this and clamps the draft to what
        it got."""
        with self._lock:
            blocks = self._owners.get(seq_id)
            if blocks is None:
                return 0
            want = self.blocks_for_tokens(n_tokens)
            tenant = self._tenant_of.get(seq_id, "")
            while len(blocks) < want:
                got = self._take_free(1, tenant)
                if got is None:
                    break
                self._ref[got[0]] = 1
                blocks.extend(got)
            self._publish()
            return len(blocks) * self.block_size

    # -- prefix cache ------------------------------------------------------
    def match_prefix(self, hashes: Sequence[bytes]) -> int:
        """How many LEADING hashes are matchable now (read-only hint)."""
        if not self.prefix_cache:
            return 0
        with self._lock:
            n = 0
            for h in hashes:
                if h not in self._by_hash:
                    break
                n += 1
            return n

    def acquire_prefix(self, seq_id: str,
                       hashes: Sequence[bytes]) -> List[int]:
        """Bind the longest cached prefix to ``seq_id`` (refcount bumps,
        off the cached-free LRU); returns the matched block ids."""
        if not self.prefix_cache:
            return []
        with self._lock:
            if self._owners.get(seq_id):
                raise ValueError(
                    f"acquire_prefix must run before {seq_id!r} owns "
                    "blocks (the prefix is table rows 0..n)")
            got: List[int] = []
            for h in hashes:
                blk = self._by_hash.get(h)
                if blk is None:
                    break
                self._ref[blk] = self._ref.get(blk, 0) + 1
                self._cached.pop(blk, None)
                self._part_of.pop(blk, None)
                got.append(blk)
            if got:
                self._owners.setdefault(seq_id, []).extend(got)
                self._publish()
            return got

    def register_blocks(self, seq_id: str, hashes: Sequence[bytes]):
        """Publish ``seq_id``'s leading blocks under their hashes; first
        writer wins, so a CoW fork never shadows the shared original."""
        if not self.prefix_cache:
            return
        with self._lock:
            blocks = self._owners.get(seq_id, ())
            for i, h in enumerate(hashes):
                if i >= len(blocks):
                    break
                if h in self._by_hash:
                    continue
                blk = blocks[i]
                if blk in self._hash_of:
                    continue
                self._hash_of[blk] = h
                self._by_hash[h] = blk

    def adopt_blocks(self, seq_id: str, hashes: Sequence[bytes],
                     n_blocks: int) -> Optional[Tuple[List[int], int]]:
        """Bind a migrated sequence: another replica prefilled
        ``seq_id`` and streamed its KV over ``kv_migrate``; hold an
        ``n_blocks``-long table for it. Leading ``hashes`` matchable
        HERE are aliased as :meth:`acquire_prefix` aliases them (their
        wire bytes are redundant); the rest comes fresh off the free
        list and is registered under the incoming hashes, so the next
        local prompt sharing the prefix hits it.

        Returns ``(block_table, n_reused)`` — the caller copies wire
        bytes into ``block_table[n_reused:]`` only — or None, with the
        aliases rolled back, when the pool cannot fund the remainder.
        The LAST block is never aliased, even on a full match: it is
        the sequence's private decode write frontier."""
        if n_blocks <= 0:
            raise ValueError("n_blocks must be positive")
        with self._lock:
            if self._owners.get(seq_id):
                raise ValueError(
                    f"adopt_blocks must run before {seq_id!r} owns "
                    "blocks (the adopted table is rows 0..n)")
            tenant = self._tenant_of.get(seq_id, "")
            reused: List[int] = []
            if self.prefix_cache:
                for h in hashes[:n_blocks - 1]:
                    blk = self._by_hash.get(h)
                    if blk is None:
                        break
                    # referenced BEFORE the fresh remainder is funded,
                    # so its eviction cannot take this block
                    self._ref[blk] = self._ref.get(blk, 0) + 1
                    self._cached.pop(blk, None)
                    self._part_of.pop(blk, None)
                    reused.append(blk)
            fresh = self._take_free(n_blocks - len(reused), tenant)
            if fresh is None:
                # roll the aliases back exactly as free() would
                for b in reversed(reused):
                    r = self._ref.get(b, 1) - 1
                    if r > 0:
                        self._ref[b] = r
                        continue
                    self._ref.pop(b, None)
                    if b in self._hash_of:
                        self._cached[b] = None
                        self._cached.move_to_end(b)   # MRU end
                        if tenant:
                            self._part_of[b] = tenant
                    else:
                        self._free.append(b)
                self._publish()
                return None
            for b in fresh:
                self._ref[b] = 1
            table = reused + fresh
            self._owners[seq_id] = list(table)
            if self.prefix_cache:
                # publish the incoming hashes over the fresh rows, first
                # writer wins (register_blocks' rule)
                for i, h in enumerate(hashes):
                    if i >= len(table):
                        break
                    if h in self._by_hash:
                        continue
                    blk = table[i]
                    if blk in self._hash_of:
                        continue
                    self._hash_of[blk] = h
                    self._by_hash[h] = blk
            self._publish()
            _migrated_blocks.inc(len(fresh))
            return table, len(reused)

    def make_writable(self, seq_id: str,
                      index: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write gate before writing table row ``index``: a
        shared block (ref > 1) is replaced by a fresh private one and
        ``(src, dst)`` returned for the caller to copy; a private block
        returns None. Raises MemoryError when the fork cannot be
        funded."""
        with self._lock:
            blocks = self._owners.get(seq_id)
            if not blocks or index >= len(blocks):
                raise KeyError(f"{seq_id!r} has no block at row {index}")
            src = blocks[index]
            if self._ref.get(src, 1) <= 1:
                return None
            got = self._take_free(1, self._tenant_of.get(seq_id, ""))
            if got is None:
                raise MemoryError(
                    "copy-on-write fork needs a free block and the "
                    "pool is exhausted")
            dst = got[0]
            self._ref[dst] = 1
            self._ref[src] -= 1
            blocks[index] = dst
            self._publish()
            return src, dst

    def free(self, seq_id: str) -> int:
        """Release every block of ``seq_id``: refcounts drop by one; a
        block at 0 returns to the free list, or parks on the cached-free
        LRU (in its tenant's partition) when its hash is registered.
        Idempotent."""
        with self._lock:
            blocks = self._owners.pop(seq_id, None)
            self._aux.pop(seq_id, None)
            tenant = self._tenant_of.pop(seq_id, "")
            if not blocks:
                return 0
            for b in reversed(blocks):
                r = self._ref.get(b, 1) - 1
                if r > 0:
                    self._ref[b] = r
                    continue
                self._ref.pop(b, None)
                if b in self._hash_of:
                    self._cached[b] = None
                    self._cached.move_to_end(b)   # MRU end
                    if tenant:
                        self._part_of[b] = tenant
                else:
                    self._free.append(b)
            self._publish()
            return len(blocks)

    def drop_cached(self) -> int:
        """Flush the cached-free LRU back to the free list."""
        with self._lock:
            n = len(self._cached)
            while self._cached:
                self._evict_one()
            if n:
                self._publish()
            return n

    def live_sequences(self) -> int:
        with self._lock:
            return len(self._owners)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            cached = len(self._cached)
            return {"num_blocks": self.num_blocks,
                    "block_size": self.block_size,
                    "blocks_used": self.num_blocks - 1 - len(self._free)
                    - cached,
                    "blocks_free": len(self._free),
                    "blocks_cached": cached,
                    "blocks_shared": sum(1 for r in self._ref.values()
                                         if r > 1),
                    "prefix_cache": self.prefix_cache,
                    "live_sequences": len(self._owners)}
