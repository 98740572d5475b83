"""Automatic prefix cache: content-addressed reuse of KV blocks
(counterpart of ``paddle_tpu/inference/prefix_cache.py``).

Serving traffic is dominated by requests that share a prefix: a system
prompt, few-shot examples, a retrieval template.  Prefilling that prefix
again for every request spends the same FLOPs and HBM bytes each time.

* **Content addressing by hash chain.**  Every FULL block of
  ``block_size`` tokens gets the id ``sha256(parent id, block tokens)``.
  The chain makes the id a digest of the whole prefix up to and including
  the block, so one dict keyed by chained id is a radix index over token
  prefixes: walking a prompt block by block descends the tree, and the
  first id missing is the divergence point.  The hash is the reference's
  byte for byte, so chain ids and resident pages cross-check against the
  JAX engine.
* **Refcounts, not ownership.**  A cached block counts the engine slots
  that map its page read-only.  At zero refs it stays resident (its page
  is not on the engine's free list), so a hot prefix survives between
  requests.
* **LRU eviction only under allocation pressure**, least recently released
  zero-ref blocks first, leaves first (a parent is never evicted before a
  cached child: the child would strand a page the radix walk can no
  longer reach).  A slot that maps a block maps its parent too, so
  ``parent.refcount >= child.refcount`` and leaf-first order is always
  possible.
* **Copy-on-write.**  The engine never writes a shared page: an admission
  whose first decode write would land inside a fully matched block copies
  that page into a private one first (``ContinuousBatchingEngine._admit``);
  a prompt that diverges mid-block needs no copy, since matching stops at
  the last full shared block.

The cache holds host metadata only (ids, page numbers, refcounts).  The K/V
bytes stay in the engine's paged pools and the paged-attention kernels
read them unchanged: a shared page is a block-table entry that appears in
more than one row.
"""

from __future__ import annotations

import hashlib
import heapq

import numpy as np

__all__ = ["PrefixCache", "CachedBlock"]


class CachedBlock:
    """One cached full block: its physical page and chain metadata."""

    __slots__ = ("hash", "page", "parent", "refcount", "children", "last_used")

    def __init__(self, hash_: str, page: int, parent: str | None):
        self.hash = hash_
        self.page = page            # physical page index in the engine pool
        self.parent = parent        # chained id of the previous block
        self.refcount = 0           # slots mapping this page now
        self.children = 0           # cached blocks whose parent this is
        self.last_used = 0          # LRU tick of the last drop to zero refs


class PrefixCache:
    """Block-granular content-addressed index over a paged KV pool.

    Host control plane only: the engine owns the pools and the free list,
    this class the id -> block index and the refcount / LRU bookkeeping.
    Every pool page is in exactly one of: the engine's free list, a slot's
    private blocks, this cache."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._by_hash: dict[str, CachedBlock] = {}
        self._tick = 0
        # lazy min-heap of (last_used, id) eviction candidates: pushed when
        # a block becomes a zero-ref leaf, checked when popped (still
        # resident, still a leaf, still zero-ref, tick current)
        self._evict_heap: list[tuple[int, str]] = []
        # zero-ref blocks, counted as they change (read on every admission)
        self._n_zero_ref = 0

    # ---------------- hashing / lookup ----------------

    @staticmethod
    def chain_hash(parent: str | None, tokens) -> str:
        """Content id of a full block: sha256 of the parent id and the
        block's int32 token bytes."""
        h = hashlib.sha256()
        h.update(b"root" if parent is None else parent.encode("ascii"))
        h.update(b"|")
        h.update(np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes())
        return h.hexdigest()

    def chain_hashes(self, token_ids, n_blocks: int) -> list[str]:
        """Chained ids of the first ``n_blocks`` full blocks of a stream."""
        ids = np.asarray(token_ids, np.int32).ravel()
        out: list[str] = []
        parent = None
        bs = self.block_size
        for b in range(n_blocks):
            parent = self.chain_hash(parent, ids[b * bs:(b + 1) * bs])
            out.append(parent)
        return out

    def match(self, token_ids) -> list[CachedBlock]:
        """The longest cached chain of full blocks that prefixes
        ``token_ids``.  Touches no refcount: the caller acquires what it
        maps, before any allocation that could evict."""
        ids = np.asarray(token_ids, np.int32).ravel()
        bs = self.block_size
        out: list[CachedBlock] = []
        parent = None
        for b in range(ids.size // bs):
            h = self.chain_hash(parent, ids[b * bs:(b + 1) * bs])
            e = self._by_hash.get(h)
            if e is None:
                break
            out.append(e)
            parent = h
        return out

    # ---------------- refcounting ----------------

    def acquire(self, block: CachedBlock) -> None:
        """Pin a matched block: a nonzero refcount cannot be evicted."""
        if block.refcount == 0:
            self._n_zero_ref -= 1
        block.refcount += 1

    def release(self, hash_: str) -> None:
        """Drop one slot's reference; at zero the block becomes an LRU
        candidate but stays resident."""
        e = self._by_hash[hash_]
        assert e.refcount > 0, f"release of zero-ref cached block {hash_[:8]}"
        e.refcount -= 1
        if e.refcount == 0:
            self._n_zero_ref += 1
            self._tick += 1
            e.last_used = self._tick
            if e.children == 0:
                heapq.heappush(self._evict_heap, (e.last_used, e.hash))

    # ---------------- registration ----------------

    def register(self, parent: str | None, tokens, page: int,
                 refcount: int = 0) -> CachedBlock | None:
        """Insert one full block (content ``tokens`` on ``page``).  Returns
        the new entry, which now owns ``page``; or None when the id is
        already cached or the parent is gone (the caller keeps the page
        private and frees it as usual, so no page is tracked twice)."""
        h = self.chain_hash(parent, tokens)
        pe = None if parent is None else self._by_hash.get(parent)
        if h in self._by_hash or (parent is not None and pe is None):
            # already cached, or the parent was evicted since the caller
            # matched (the block would be unreachable by the radix walk)
            return None
        e = CachedBlock(h, int(page), parent)
        e.refcount = int(refcount)
        if refcount == 0:
            self._n_zero_ref += 1
            self._tick += 1
            e.last_used = self._tick
            heapq.heappush(self._evict_heap, (e.last_used, h))
        if pe is not None:
            pe.children += 1
        self._by_hash[h] = e
        return e

    # ---------------- eviction (allocation pressure only) ----------------

    def evictable_count(self) -> int:
        """Pages reclaimable now: the zero-ref blocks (repeated leaf
        eviction reaches every one of them)."""
        return self._n_zero_ref

    def evict(self, n: int) -> list[tuple[str, int]]:
        """Reclaim up to ``n`` pages, least recently used zero-ref leaves
        first, as ``(id, page)`` pairs.  Stale heap records are skipped;
        evicting a leaf may make its parent a leaf, which is pushed at once
        so a chain drains oldest first."""
        pairs: list[tuple[str, int]] = []
        while len(pairs) < n and self._evict_heap:
            tick, h = heapq.heappop(self._evict_heap)
            victim = self._by_hash.get(h)
            if (victim is None or victim.refcount != 0
                    or victim.children != 0 or victim.last_used != tick):
                continue
            del self._by_hash[h]
            self._n_zero_ref -= 1
            if victim.parent is not None:
                pe = self._by_hash.get(victim.parent)
                if pe is not None:
                    pe.children -= 1
                    if pe.children == 0 and pe.refcount == 0:
                        heapq.heappush(self._evict_heap,
                                       (pe.last_used, pe.hash))
            pairs.append((victim.hash, victim.page))
        return pairs

    # ---------------- accounting ----------------

    def resident_blocks(self) -> int:
        """Pages the cache owns now (referenced and zero-ref)."""
        return len(self._by_hash)

    def resident_pages(self) -> list[int]:
        return [e.page for e in self._by_hash.values()]
