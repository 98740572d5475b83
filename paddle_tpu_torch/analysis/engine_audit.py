"""Serving-engine invariant auditor, ``PADDLE_TPU_ENGINE_AUDIT=1``
(counterpart of ``paddle_tpu/analysis/engine_audit.py``).

The paged engine and its prefix cache keep a few host-side invariants
that the whole memory model rests on.  One bookkeeping slip (a page freed
twice, a leaked reference, a missed copy-on-write) silently corrupts KV
bytes of *other* requests, and shows only when the allocator, the block
tables and the cache are checked against each other.  With the switch on,
the engine calls :func:`audit_engine` after admission and after every
decode, mixed and verify step, and the fleet router calls
:func:`audit_fleet` after every fleet step; a violation raises
:class:`EngineAuditError` naming the invariant.

The paged engine gets every invariant; the dense slot-cache engine
(``paged=False``) gets I6's bounds and I8 only, as the reference's does:
it has no allocator, block table or cache to corrupt.

I1  page partition: every pool page is in exactly one of {the free list,
    a slot's private pages, the prefix cache}, without duplicates, and
    together they are the pool.  The device pools hold exactly ONE spill
    page past the allocator's range, on every decode arm (the reference
    grows it on its fused arm only; the port keeps it on all of them,
    since every unfused write that drops lands there too).  Under tensor
    parallelism every leaf of a rank's pools (codes and scales) keeps the
    whole page axis and exactly nkv/tp kv heads: one host allocator then
    accounts every rank's pool exactly (the reference checks that its
    pools' sharding splits the kv-heads axis alone).
I2  block-table rows: row i lists [shared pages..., private pages...] in
    order and the unallocated sentinel after them.
I3  refcounts: each cached block's refcount is the number of slots that
    map it; the cache's zero-ref counter agrees with a scan.
I4  copy-on-write: no cached page is a slot's private (writable) page.
I5  chain shape: a slot's shared list is a parent-linked hash chain from
    None; each cached block's ``children`` count agrees with a scan.
I6  position bounds: a seated slot has 0 <= pos <= max_seq and pos <=
    ``_written`` <= max_seq (a verify step writes up to K+1 rows, then
    rolls pos back past the rejected drafts: pos may trail the high-water
    mark, never lead it), and its mapped pages cover every written
    position.
I7  chunked-prefill progress (engines with ``enable_chunked_prefill``): a
    prefilling slot holds a request, its cursor lies in [0, prompt
    length] and inside its mapped pages, and no slot is packed as both a
    decode and a prefill lane of one mixed step.
I8  terminal ownership: a request in a terminal status is neither seated
    nor queued (pages and references are slot-keyed, so with I1 it owns
    none); every seated request is RUNNING, every queued one PENDING.
I10 host KV tier (engines with a tier): a block lives in exactly one of
    {the pool, the tier, dead}.  A private tier holds no hash the prefix
    cache holds; a fleet's shared tier relaxes that clause (one replica's
    demoted copy may sit beside another's resident one, byte-identical by
    the content address).  The tier's accounting closes (:func:`
    audit_tier`), and every hash in a slot's restore plan is still in the
    tier or the cache.
I9  fleet ownership (:func:`audit_fleet`): every live fleet rid has
    exactly one owner, alive and holding a copy; a hedge-pending rid
    counts as its primary's, with one extra copy on the hedge target; no
    replica serves a rid the router does not route to it; terminal fleet
    requests are in no routing registry.

The audit is O(pool + slots x blocks) host work a step, reading host
state only (no device sync): small next to a device step, but not free,
hence opt-in.
"""

from __future__ import annotations

from ..utils.envflags import env_bool

__all__ = ["EngineAuditError", "audit_engine", "audit_fleet",
           "audit_tier", "audit_enabled"]


class EngineAuditError(AssertionError):
    """A serving-engine invariant does not hold (engine state is corrupt)."""


def audit_enabled() -> bool:
    """``PADDLE_TPU_ENGINE_AUDIT`` ('' or '0' off, '1' on; anything else
    warns once and keeps it off)."""
    return env_bool("PADDLE_TPU_ENGINE_AUDIT", False)


def _fail(invariant: str, detail: str):
    raise EngineAuditError(f"engine audit {invariant} violated: {detail}")


def audit_engine(eng) -> None:
    """Cross-check a ContinuousBatchingEngine's host state; raises
    :class:`EngineAuditError` on the first violated invariant."""
    from ..inference.serving import TERMINAL_STATUSES

    B = eng.max_batch
    # I6's bounds first: dense and paged alike
    for s in range(B):
        if eng._slot_req[s] is None:
            continue
        pos = int(eng._pos[s])
        if not 0 <= pos <= eng.max_seq:
            _fail("I6", f"slot {s} pos {pos} outside [0, {eng.max_seq}]")
        w = int(eng._written[s])
        if w > eng.max_seq:
            _fail("I6", f"slot {s} written high-water {w} beyond "
                        f"max_seq {eng.max_seq}")
        if pos > w:
            _fail("I6", f"slot {s} pos {pos} ahead of written high-water "
                        f"{w}: speculative rollback may trail the device's "
                        f"writes but pos must never pass them")

    # I8: terminal ownership, dense and paged alike
    seated = {id(r) for r in eng._slot_req if r is not None}
    queued = {id(r) for r in eng._queue}
    for req in eng._reqs.values():
        if req.status in TERMINAL_STATUSES:
            if id(req) in seated:
                _fail("I8", f"rid {req.rid} is {req.status} (terminal) but "
                            f"still seated on a slot: its pages were never "
                            f"released")
            if id(req) in queued:
                _fail("I8", f"rid {req.rid} is {req.status} (terminal) but "
                            f"still waiting in the queue (zombie: it would "
                            f"be re-admitted)")
    for s in range(B):
        req = eng._slot_req[s]
        if req is not None and req.status != "RUNNING":
            _fail("I8", f"slot {s} seats rid {req.rid} with status "
                        f"{req.status} (seated requests must be RUNNING)")
    for req in eng._queue:
        if req.status != "PENDING":
            _fail("I8", f"queued rid {req.rid} has status {req.status} "
                        f"(queued requests must be PENDING)")
    if not eng.paged:
        return

    nb = eng.num_blocks
    free = list(eng._free)
    cache = eng._pcache
    cached_pages = cache.resident_pages() if cache is not None else []
    private = [p for s in range(B) for p in eng._slot_blocks[s]]

    # I1: exact partition of the pool
    if len(free) != len(set(free)):
        _fail("I1", f"duplicate pages in the free list: {sorted(free)}")
    if len(private) != len(set(private)):
        _fail("I1", f"page owned by two slots: {sorted(private)}")
    if len(cached_pages) != len(set(cached_pages)):
        _fail("I1", f"page cached twice: {sorted(cached_pages)}")
    # I4 ahead of I1's overlap clause, which would otherwise report a page
    # both cached and private as a plain double owner (the reference
    # checks I4 after it, where it can never fire): cached pages are
    # read-only, never a slot's writable page
    leaked = set(cached_pages) & set(private)
    if leaked:
        _fail("I4", f"cache-resident pages mapped writable: {sorted(leaked)}")
    everything = sorted(free + private + cached_pages)
    if everything != sorted(set(everything)):
        seen, dup = set(), set()
        for p in free + private + cached_pages:
            (dup if p in seen else seen).add(p)
        _fail("I1", f"pages in two owners at once: {sorted(dup)} "
                    f"(free/slot/cache overlap)")
    if everything != list(range(nb)):
        missing = sorted(set(range(nb)) - set(everything))
        extra = sorted(set(everything) - set(range(nb)))
        _fail("I1", f"pool accounting does not close: missing={missing} "
                    f"out-of-range={extra}")
    # the spill page: one past the allocator's range on every arm (the
    # reference's fused arm only).  Missing, a dropped write would land on
    # page num_blocks - 1; a second one means the pool's layout drifted.
    # The partition above proves the allocator never hands it out.  A
    # quantized pool is a {"q", "scale"} pair: its codes carry the pages
    pool_k = eng.cache_k["q"] if isinstance(eng.cache_k, dict) \
        else eng.cache_k
    phys = int(pool_k.shape[1])
    if phys != nb + 1:
        _fail("I1", f"device pool has {phys} physical pages, expected "
                    f"{nb + 1} (num_blocks={nb} + the spill page)")
    if getattr(eng, "tp", 1) > 1:
        # a rank's pools shard kv heads alone: a leaf with another page
        # count would give the ranks different capacities, and the one
        # host allocator would misaccount all but one of them
        heads = eng.cfg.num_key_value_heads // eng.tp
        for nm, pool in (("cache_k", eng.cache_k), ("cache_v", eng.cache_v)):
            leaves = (pool.items() if isinstance(pool, dict)
                      else (("", pool),))
            for leaf_nm, leaf in leaves:
                if tuple(leaf.shape[1:3]) != (nb + 1, heads):
                    _fail("I1", f"TP pool {nm}{'.' + leaf_nm if leaf_nm else ''}"
                                f" is {tuple(leaf.shape)}: a rank keeps all "
                                f"{nb + 1} pages and {heads} of the "
                                f"{eng.cfg.num_key_value_heads} kv heads "
                                f"(tp={eng.tp})")

    by_hash = cache._by_hash if cache is not None else {}

    # I2: table rows mirror shared + private, the sentinel elsewhere
    for s in range(B):
        shared = eng._slot_shared[s]
        owned = eng._slot_blocks[s]
        row = eng._table[s]
        expect = [by_hash[h].page if h in by_hash else None for h in shared] \
            + list(owned)
        if len(expect) > eng.max_blocks:
            # before the row[i] loop: an over-long list would otherwise
            # surface as a bare IndexError, not the named invariant
            _fail("I2", f"slot {s} maps {len(expect)} blocks but the table "
                        f"row holds max_blocks={eng.max_blocks}")
        for i, want in enumerate(expect):
            if want is None:
                _fail("I2", f"slot {s} maps evicted cached block "
                            f"{shared[i][:8]}")
            if int(row[i]) != want:
                _fail("I2", f"slot {s} table[{i}]={int(row[i])} but "
                            f"allocator says page {want}")
        for i in range(len(expect), eng.max_blocks):
            if int(row[i]) != nb:
                _fail("I2", f"slot {s} table[{i}]={int(row[i])} past the "
                            f"mapped blocks (sentinel {nb} expected)")
        # I6 continued: the mapped pages cover every written position,
        # a verify step's rejected drafts included (the device wrote their
        # K/V before the rollback), hence the high-water mark, not pos
        if eng._slot_req[s] is not None and expect:
            covered = len(expect) * eng.block_size
            pos = min(int(eng._pos[s]), eng.max_seq)
            hw = min(int(eng._written[s]), eng.max_seq)
            if pos > covered:
                _fail("I6", f"slot {s} pos {pos} beyond mapped pages "
                            f"({covered} positions)")
            if hw > covered:
                _fail("I6", f"slot {s} written high-water {hw} beyond "
                            f"mapped pages ({covered} positions): "
                            f"multi-token append outran its allocation")

    # I7: chunked-prefill progress (only when the feature is live)
    if eng._chunked:
        for s in range(B):
            ids = eng._prefill_ids[s]
            if ids is None:
                continue
            if eng._slot_req[s] is None:
                _fail("I7", f"slot {s} is mid-prefill with no request "
                            f"seated")
            cur = int(eng._prefilled[s])
            if not 0 <= cur <= ids.size:
                _fail("I7", f"slot {s} prefill cursor {cur} outside "
                            f"[0, {ids.size}] (prompt length)")
            covered = (len(eng._slot_shared[s])
                       + len(eng._slot_blocks[s])) * eng.block_size
            if cur > covered:
                _fail("I7", f"slot {s} prefilled {cur} positions but its "
                            f"mapped pages cover only {covered}: a chunk "
                            f"scattered K/V into unallocated pages")
        dec, pre = eng._last_pack
        overlap = set(dec) & set(pre)
        if overlap:
            _fail("I7", f"slot(s) {sorted(overlap)} packed as BOTH decode "
                        f"and prefill in one mixed step")

    if cache is None:
        return

    # I3: refcount == slot mappings; the zero-ref counter == a scan
    mapped: dict[str, int] = {}
    for s in range(B):
        for h in eng._slot_shared[s]:
            mapped[h] = mapped.get(h, 0) + 1
    for h, e in by_hash.items():
        if e.refcount != mapped.get(h, 0):
            _fail("I3", f"block {h[:8]} refcount={e.refcount} but "
                        f"{mapped.get(h, 0)} slot(s) map it")
    for h in mapped:
        if h not in by_hash:
            _fail("I3", f"slot maps block {h[:8]} that is not resident")
    n_zero = sum(1 for e in by_hash.values() if e.refcount == 0)
    if cache._n_zero_ref != n_zero:
        _fail("I3", f"zero-ref counter {cache._n_zero_ref} != scan {n_zero}")

    # I5: chain shape, parent links and children counts
    kids: dict[str, int] = {}
    for e in by_hash.values():
        if e.parent is not None:
            kids[e.parent] = kids.get(e.parent, 0) + 1
    for h, e in by_hash.items():
        if e.children != kids.get(h, 0):
            _fail("I5", f"block {h[:8]} children={e.children} but scan "
                        f"finds {kids.get(h, 0)}")
    for s in range(B):
        parent = None
        for h in eng._slot_shared[s]:
            e = by_hash.get(h)
            if e is None:
                _fail("I5", f"slot {s} chain references evicted {h[:8]}")
            if e.parent != parent:
                _fail("I5", f"slot {s} shared chain broken at {h[:8]}: "
                            f"parent {str(e.parent)[:8]} != previous "
                            f"{str(parent)[:8]}")
            parent = h

    # I10: a block in exactly one of {the pool, the host tier, dead}
    tier = eng._tier
    if tier is None:
        return
    audit_tier(tier)
    if not tier.shared:
        # a private tier moves blocks: demotion takes the hash out of the
        # prefix cache as the page ships, a restore or a fresh compute
        # takes it out of the tier
        both = set(by_hash) & set(tier._by_hash)
        if both:
            _fail("I10", f"block(s) {sorted(h[:8] for h in both)} "
                         f"resident in BOTH the HBM prefix cache and "
                         f"the private host tier — demote/re-admit "
                         f"must MOVE a block, never fork it")
    for s in range(B):
        for _b, h, _p in eng._tier_plan[s]:
            if eng._slot_req[s] is None:
                _fail("I10", f"slot {s} holds a tier-restore plan "
                             f"with no request seated (plan leak: "
                             f"its pins would starve the tier LRU)")
            if h not in tier._by_hash and h not in by_hash:
                _fail("I10", f"slot {s} plans to restore block "
                             f"{h[:8]} which is resident in neither "
                             f"the tier nor the HBM cache (the pin "
                             f"window broke: only a tier_drop "
                             f"injection may discard a pinned entry, "
                             f"and that seam drops the plan "
                             f"atomically)")


def audit_tier(tier) -> None:
    """I10's tier-internal half: a :class:`~paddle_tpu_torch.inference.
    kv_tier.HostKVTier`'s entries are each keyed by their own hash, their
    bytes sum exactly to ``used_bytes`` within the budget, and no pin count
    is negative; a mismatch means demote / restore / evict bookkeeping
    corrupted the store (the failure that serves one prompt's KV bytes to
    another).  Raises :class:`EngineAuditError` on the first violation."""
    total = 0
    for h, e in tier._by_hash.items():
        if e.hash != h:
            _fail("I10", f"tier entry keyed {h[:8]} carries hash "
                         f"{e.hash[:8]} (content address forged: ship_in "
                         f"would restore the wrong bytes)")
        if e.pins < 0:
            _fail("I10", f"tier entry {h[:8]} has negative pin count "
                         f"{e.pins} (unbalanced pin/unpin)")
        if e.nbytes <= 0:
            _fail("I10", f"tier entry {h[:8]} accounts {e.nbytes} bytes "
                         f"(empty payload)")
        total += e.nbytes
    if total != tier.used_bytes:
        _fail("I10", f"tier byte accounting does not close: entries sum "
                     f"to {total} but used_bytes={tier.used_bytes}")
    if tier.used_bytes > tier.budget_bytes:
        _fail("I10", f"tier over budget: used_bytes={tier.used_bytes} > "
                     f"budget_bytes={tier.budget_bytes} (eviction must "
                     f"run BEFORE insert, never after)")


def audit_fleet(router) -> None:
    """I9, fleet single ownership: a FleetRouter's routing registries
    against its replicas' live requests.  Every live fleet rid has exactly
    one owner (a hedge-pending rid counts as its primary's until
    first-writer-wins resolves; the hedge target holds the one sanctioned
    extra copy), owners are alive and hold the work, and no replica serves
    a rid the router does not route to it.  The router's invariants only:
    each replica audits its own I1-I8 and I10 (:func:`audit_engine`).
    Raises :class:`EngineAuditError` on the first violation."""
    from ..inference.serving import TERMINAL_STATUSES

    for rid, req in router._reqs.items():
        if req.status in TERMINAL_STATUSES:
            _fail("I9", f"rid {rid} is {req.status} (terminal) but still "
                        f"in the fleet's live registry (zombie: it would "
                        f"keep an owner and copies)")
        owner = router._owner.get(rid)
        if owner is None:
            _fail("I9", f"live rid {rid} has no owning replica (orphaned: "
                        f"no one will ever step it)")
        if router.replicas[owner] is None or router.health[owner] == "DEAD":
            _fail("I9", f"live rid {rid} is owned by DEAD replica {owner}")
        copies = router._copies.get(rid, {})
        if owner not in copies:
            _fail("I9", f"live rid {rid}'s owner (replica {owner}) holds "
                        f"no copy of it")
        hedge = router._hedge.get(rid)
        if hedge == owner:
            _fail("I9", f"rid {rid} hedged onto its own owner (replica "
                        f"{owner}): first-writer-wins could never resolve")
        sanctioned = {owner} | ({hedge} if hedge is not None else set())
        extra = set(copies) - sanctioned
        if extra:
            _fail("I9", f"rid {rid} has copies on replica(s) "
                        f"{sorted(extra)} beyond owner {owner}"
                        + (f" and hedge {hedge}" if hedge is not None
                           else "")
                        + " — double ownership banks one stream twice")
    for rid in router._owner:
        if rid not in router._reqs:
            _fail("I9", f"owner-map entry for rid {rid} which is not a "
                        f"live fleet request")
    for rid in router._hedge:
        if rid not in router._reqs:
            _fail("I9", f"hedge-map entry for rid {rid} which is not a "
                        f"live fleet request")
    for rid, copies in router._copies.items():
        if rid not in router._reqs:
            # each leaked copy pins a Request (its prompt and output
            # lists) for the router's lifetime
            _fail("I9", f"replica-local copies (on replica(s) "
                        f"{sorted(copies)}) registered for rid {rid} "
                        f"which is not a live fleet request")
    for r, eng in enumerate(router.replicas):
        if eng is None:
            continue
        for rid in eng._reqs:
            if rid < 0:
                continue        # warm-up rids (negative) are never routed
            if rid not in router._reqs:
                _fail("I9", f"replica {r} serves rid {rid} unknown to the "
                            f"router (a cancelled/failed-over copy was "
                            f"never released)")
            if r not in router._copies.get(rid, {}):
                _fail("I9", f"replica {r} serves rid {rid} but the router "
                            f"records no copy there (untracked ownership)")
