"""Paged KV-cache block allocator with content-hash prefix sharing and
copy-on-write (counterpart of ``zoo_tpu/serving/llm/kv_cache.py``,
without its tenant partitions, metric gauges, migration adoption and
speculative growth, which later slices of the port bring).

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


def prefix_block_hashes(tokens: Sequence[int],
                        block_size: int) -> List[bytes]:
    """Rolling content hash per FULL block of ``tokens``: block ``i``'s
    key digests (key of block ``i-1``, the block's token ids), so equal
    keys imply the whole prefix through block ``i`` is identical.
    Partial trailing tokens produce no hash. Same chain as the JAX
    package's for unsalted traffic."""
    out: List[bytes] = []
    prev = b"zoo-kv-prefix-v1"
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
        # per-SEQUENCE replay state (the sampling seed), never per block
        self._aux: Dict[str, Dict] = {}

    # -- accounting --------------------------------------------------------
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

    def _evict_one(self):
        """Under the lock: reclaim the LRU cached-free block."""
        blk, _ = self._cached.popitem(last=False)
        h = self._hash_of.pop(blk, None)
        if h is not None:
            self._by_hash.pop(h, None)
        self._free.append(blk)

    def _take_free(self, n: int) -> Optional[List[int]]:
        """Under the lock: pop ``n`` blocks, evicting cached-free blocks
        when the free list runs short. Referenced blocks are never
        evicted."""
        while len(self._free) < n and self._cached:
            self._evict_one()
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def allocate(self, seq_id: str, n_blocks: int) -> Optional[List[int]]:
        """Grow ``seq_id`` by ``n_blocks`` private blocks, all or
        nothing (None when the pool cannot cover the ask)."""
        if n_blocks <= 0:
            raise ValueError("n_blocks must be positive")
        with self._lock:
            got = self._take_free(n_blocks)
            if got is None:
                return None
            for b in got:
                self._ref[b] = 1
            self._owners.setdefault(seq_id, []).extend(got)
            return got

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
                got.append(blk)
            if got:
                self._owners.setdefault(seq_id, []).extend(got)
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
            got = self._take_free(1)
            if got is None:
                raise MemoryError(
                    "copy-on-write fork needs a free block and the "
                    "pool is exhausted")
            dst = got[0]
            self._ref[dst] = 1
            self._ref[src] -= 1
            blocks[index] = dst
            return src, dst

    def free(self, seq_id: str) -> int:
        """Release every block of ``seq_id``: refcounts drop by one; a
        block at 0 returns to the free list, or parks on the cached-free
        LRU when its hash is registered. Idempotent."""
        with self._lock:
            blocks = self._owners.pop(seq_id, None)
            self._aux.pop(seq_id, None)
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
                else:
                    self._free.append(b)
            return len(blocks)

    def drop_cached(self) -> int:
        """Flush the cached-free LRU back to the free list."""
        with self._lock:
            n = len(self._cached)
            while self._cached:
                self._evict_one()
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
