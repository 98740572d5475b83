"""The host KV tier: a host-RAM page store behind the prefix cache
(counterpart of ``paddle_tpu/inference/kv_tier.py``).

Without it, LRU eviction of the prefix cache frees zero-ref chains, and an
evicted system prompt is a full re-prefill.  :class:`HostKVTier` keeps the
evicted pages in host memory instead, keyed by the prefix cache's chain
hash, under a byte budget (``PADDLE_TPU_HOST_TIER_MIB``, default 256) with
its own LRU, so the set of resident prefixes scales with the host, not the
card.

The transport:

* :meth:`ship_out`, device to host: one page (one pool block's K and V,
  ``[L, nkv, block_size, hd]`` each, every layer's bytes for that block)
  goes into the tier under its chain hash.  Quantized pools ship their
  per-(page, kv head) f32 scales with the codes (int4 codes packed two a
  byte, as the pools hold them), so the round trip is byte-exact.  The
  entry COPIES what it is given: the engine demotes a batch with one
  gathered read and hands each page as a view of that slab, and a kept
  view would hold the whole slab while ``nbytes`` counts one page.
  Content-addressed: shipping a hash the tier holds refreshes its recency
  and returns the entry it has.
* :meth:`ship_in`, host to device: looks a hash up, counts the re-admit
  and returns the entry, whose host tensors the engine copies into a free
  pool page.  A private tier (one engine) removes the entry: a block lives
  either in the pool or in the tier, never in both.  A shared tier
  (``shared=True``, the fleet's prefix store) keeps it, so every replica
  can re-admit the chain; ``cross_readmits`` counts re-admits of a chain
  another replica (``owner``) demoted.

Eviction is LRU over unpinned entries, counted in bytes: an insert that
would exceed the budget evicts the least recently used entries first, and
is refused (``ship_out`` returns None; the block goes dead, as every
eviction did before the tier) when even that cannot make room.
:meth:`pin` / :meth:`unpin` protect entries an engine matched but has not
restored yet (the chunked cursor restores at the token budget's pace, so
a plan spans steps); :meth:`discard` drops an entry whatever its pins: the
``tier_drop`` fault's seam, after which the engine falls back to prefill.

The host copies are torch CPU tensors, page-locked when the page comes
from a CUDA card, so the engine's H2D restore can be an asynchronous copy
on the current stream.  ``nbytes`` counts what the reference counts for
the same shapes and dtypes, so budgets, LRU order, ``evictions`` and
``drops`` agree with the reference's tier call for call.  Under tensor
parallelism each rank's engine ships its own kv heads of a page
(``shards`` = the degree) and the entry counts the whole page, as the
reference's tier counts the page it gathers from every shard.
This module only keeps books and host buffers; the device halves of the
transport (the gathered D2H read, the pool write) belong to the engine.
"""

from __future__ import annotations

import heapq

import torch

from ..utils.envflags import env_int

__all__ = ["HostKVTier", "TierEntry", "DEFAULT_TIER_MIB"]

#: the byte budget (MiB) when ``PADDLE_TPU_HOST_TIER_MIB`` is unset
DEFAULT_TIER_MIB = 256


def _tier_budget_bytes() -> int:
    """``PADDLE_TPU_HOST_TIER_MIB`` in bytes (a non-integer or sub-1 value
    warns once and keeps the default)."""
    return env_int("PADDLE_TPU_HOST_TIER_MIB", DEFAULT_TIER_MIB,
                   minimum=1) * (1 << 20)


def _host_copy(t) -> torch.Tensor:
    """A contiguous CPU tensor that owns a copy of ``t`` (a tensor or an
    array).  A page from the card is copied into page-locked memory, and
    the copy blocks until the bytes are on the host."""
    t = torch.as_tensor(t)
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                      pin_memory=t.is_cuda)
    return out.copy_(t)


class TierEntry:
    """One demoted page: host copies of a block's K and V (and the
    per-(page, kv head) scales of a quantized pool), keyed by the block's
    chain hash.  ``owner`` is the last demoter (a replica label), so a
    shared tier can count cross-replica re-admits.  ``shards``: the host
    copies are one of that many equal kv-head slices of the page (a
    tensor-parallel rank's), and ``nbytes`` counts the whole page."""

    __slots__ = ("hash", "k", "v", "k_scale", "v_scale", "nbytes", "pins",
                 "last_used", "owner")

    def __init__(self, hash_: str, k, v, k_scale=None, v_scale=None,
                 owner=None, shards: int = 1):
        self.hash = hash_
        self.k = _host_copy(k)
        self.v = _host_copy(v)
        self.k_scale = None if k_scale is None else _host_copy(k_scale)
        self.v_scale = None if v_scale is None else _host_copy(v_scale)
        self.nbytes = int(shards) * sum(t.numel() * t.element_size()
                                        for t in (self.k, self.v,
                                                  self.k_scale, self.v_scale)
                                        if t is not None)
        self.pins = 0
        self.last_used = 0
        self.owner = owner

    def __repr__(self):
        return (f"TierEntry({self.hash[:8]}, {self.nbytes}B, "
                f"pins={self.pins})")


class HostKVTier:
    """Byte-budgeted host page store keyed by chain hash (module
    docstring).

    ``budget_bytes``: the LRU's ceiling; None reads
    ``PADDLE_TPU_HOST_TIER_MIB`` (default :data:`DEFAULT_TIER_MIB`).
    ``shared=True``: the fleet-wide store, whose :meth:`ship_in` keeps the
    entry.

    Counters: ``demotions``, ``readmits``, ``cross_readmits`` (a shared
    tier's re-admits of a chain another replica demoted), ``evictions``
    (LRU drops under the budget) and ``drops`` (refused inserts: the block
    went dead because even evicting every unpinned entry could not fit
    it)."""

    def __init__(self, budget_bytes: int | None = None,
                 shared: bool = False):
        self.budget_bytes = (int(budget_bytes) if budget_bytes is not None
                             else _tier_budget_bytes())
        if self.budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1, got {self.budget_bytes}")
        self.shared = bool(shared)
        self._by_hash: dict[str, TierEntry] = {}
        self.used_bytes = 0
        self._tick = 0
        # lazy min-heap of (last_used, hash): stale records (touched since,
        # pinned, gone) are skipped when popped
        self._lru_heap: list[tuple[int, str]] = []
        self.demotions = 0
        self.readmits = 0
        self.cross_readmits = 0
        self.evictions = 0
        self.drops = 0

    # ---------------- internals ----------------

    def _touch(self, e: TierEntry) -> None:
        self._tick += 1
        e.last_used = self._tick
        heapq.heappush(self._lru_heap, (e.last_used, e.hash))

    def _remove(self, e: TierEntry) -> None:
        del self._by_hash[e.hash]
        self.used_bytes -= e.nbytes

    def _evict_for(self, need: int) -> bool:
        """Drop LRU unpinned entries until ``need`` more bytes fit; False
        when they cannot (everything left is pinned)."""
        while self.used_bytes + need > self.budget_bytes:
            while self._lru_heap:
                tick, h = heapq.heappop(self._lru_heap)
                victim = self._by_hash.get(h)
                if (victim is None or victim.last_used != tick
                        or victim.pins > 0):
                    continue            # stale record, or pinned
                self._remove(victim)
                self.evictions += 1
                break
            else:
                return False
        return True

    # ---------------- transport ----------------

    def ship_out(self, hash_: str, k_page, v_page, *, k_scale=None,
                 v_scale=None, owner=None,
                 shards: int = 1) -> TierEntry | None:
        """Device to host: demote one page under its chain hash (the pages
        and scales are tensors, on the card or the host, or arrays).
        Returns the resident entry, or None when the page cannot fit even
        after LRU eviction (the caller frees the device page, as before the
        tier).  A hash already held refreshes its recency, takes ``owner``
        as its last demoter and counts as a demotion (the chain hash is a
        digest of the bytes, so they are the same).  ``shards``: the page
        is one tensor-parallel rank's kv-head slice of that many
        (:class:`TierEntry`)."""
        e = self._by_hash.get(hash_)
        if e is not None:
            e.owner = owner
            self.demotions += 1
            self._touch(e)
            return e
        e = TierEntry(hash_, k_page, v_page, k_scale, v_scale, owner=owner,
                      shards=shards)
        if not self._evict_for(e.nbytes):
            self.drops += 1
            return None
        self._by_hash[hash_] = e
        self.used_bytes += e.nbytes
        self.demotions += 1
        self._touch(e)
        return e

    def ship_in(self, hash_: str, *, owner=None,
                keep: bool | None = None) -> TierEntry | None:
        """Host to device: look one page up for re-admission; the caller
        copies ``entry.k`` / ``entry.v`` (and the scales) into its pool.
        None on a miss (evicted, or discarded by a ``tier_drop``): the
        caller falls back to prefill.  ``keep`` defaults to ``shared``: a
        private tier removes the entry, a shared one keeps it."""
        e = self._by_hash.get(hash_)
        if e is None:
            return None
        self.readmits += 1
        if (self.shared and e.owner is not None and owner is not None
                and e.owner != owner):
            self.cross_readmits += 1
        if keep is None:
            keep = self.shared
        if keep:
            self._touch(e)
        else:
            self._remove(e)
        return e

    # ---------------- pinning / invalidation ----------------

    def pin(self, hash_: str) -> bool:
        """Protect an entry from LRU eviction while an engine holds a
        restore plan over it.  False on a miss."""
        e = self._by_hash.get(hash_)
        if e is None:
            return False
        e.pins += 1
        return True

    def unpin(self, hash_: str) -> None:
        e = self._by_hash.get(hash_)
        if e is not None and e.pins > 0:
            e.pins -= 1
            if e.pins == 0:
                self._touch(e)      # back in the LRU at current recency

    def discard(self, hash_: str) -> bool:
        """Drop an entry whatever its pins: the ``tier_drop`` seam, and a
        private tier's dedup when an engine computes a block afresh.  True
        when something was removed."""
        e = self._by_hash.get(hash_)
        if e is None:
            return False
        self._remove(e)
        return True

    # ---------------- introspection ----------------

    def __contains__(self, hash_: str) -> bool:
        return hash_ in self._by_hash

    def __len__(self) -> int:
        return len(self._by_hash)

    def stats(self) -> dict:
        """The counters, the entry count and the bytes held."""
        return {
            "entries": len(self._by_hash),
            "used_bytes": int(self.used_bytes),
            "budget_bytes": int(self.budget_bytes),
            "demotions": int(self.demotions),
            "readmits": int(self.readmits),
            "cross_readmits": int(self.cross_readmits),
            "evictions": int(self.evictions),
            "drops": int(self.drops),
        }
