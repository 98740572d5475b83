"""The port's host KV tier against the reference on the CPU.

Same f32 tiny Llama, the JAX parameter tree bridged through
``paddle_tpu_torch.utils.convert``, the same request streams (made with
numpy from a seed).  The JAX engines run through their plain references
(``PADDLE_TPU_DISABLE_PALLAS=paged_attention``) and are shared through one
module fixture.  Following ``tests/test_kv_tier.py``:

- ``HostKVTier`` call for call against the reference's: the same sequence
  of ``ship_out`` / ``ship_in`` / ``pin`` / ``unpin`` / ``discard`` on the
  same seeded pages (fp, int8 with scales, packed int4 with scales) under
  a budget that evicts and drops: equal ``stats()`` after every call and
  equal bytes back; ``ship_out`` copies a slab's views; the shared tier's
  ``cross_readmits``;
- the tier-on engine, every serving feature on, on a stream that evicts
  and then revisits demoted prefixes, greedy and seeded, bucketed and
  chunked: tokens, the five ``tier_*`` statistics, the prefix statistics
  and the tier's own counters equal the JAX engine's, and the tokens equal
  the port's tier-off engine's;
- the demote and re-admit round trip, restores paced by the token budget
  (step by step as the JAX engine), the graceful-off chunked engine
  restoring at admission, ``tier_drop`` falling back to prefill, the kill
  switches (``PADDLE_TPU_HOST_KV_TIER=0`` leaves the pre-tier engine's
  tokens and page order) and the constructor's requirements, the flags
  and their typo warnings, every evicted block demoted.

The reference's fleet and I10-audit cases are in
``tests/test_torch_fleet.py``; its tensor-parallel cases wait for the
port's tensor parallelism (ROADMAP A7).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.kv_tier import HostKVTier as JTier
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.kv_tier import HostKVTier
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.inference.serving import Request
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import envflags
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

_KW = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64)
#: every serving feature on over a pool far smaller than the working set
ALL_ON = dict(max_batch=2, max_seq=64, chunk=1, block_size=8, num_blocks=8,
              enable_prefix_caching=True, enable_speculation=True,
              enable_chunked_prefill=True, prefill_chunk=5)
#: one 30-token prompt served alone (three full 8-token blocks and a tail)
SINGLE = dict(max_batch=1, max_seq=64, chunk=1, block_size=8, num_blocks=8,
              enable_prefix_caching=True, enable_chunked_prefill=True,
              prefill_chunk=5)
TIER_STATS = ("tier_bytes", "tier_demotions", "tier_evictions", "tier_hits",
              "tier_readmits")
STATS = TIER_STATS + ("prefix_hits", "prefix_evictions",
                      "prefill_tokens_computed", "prefill_tokens_cached",
                      "preemptions", "decode_steps", "mixed_steps",
                      "spec_steps")
#: (chunked, sampled) engine runs held to the JAX engine
RUNS = [(True, False), (True, True), (False, False)]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(**_KW),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(**_KW),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _revisit_stream(cls, sampled=False):
    """Two 16-token prefix families with tails of their own, three
    disjoint 40-token prompts that turn the 8-page pool over, then three
    requests that revisit the families' demoted prefixes (the sampled run
    draws top-p on every other request)."""
    rs = np.random.RandomState(7)
    fam = [rs.randint(0, 128, (16,)).astype(np.int32) for _ in range(2)]
    tails = [rs.randint(0, 128, (n,)).astype(np.int32)
             for n in (6, 9, 5, 8, 7, 4)]
    reqs = [cls(rid=i, prompt_ids=np.concatenate([fam[i % 2], t]),
                max_new_tokens=8,
                temperature=0.9 if sampled and i % 2 else 0.0,
                top_p=0.9 if sampled else 1.0,
                seed=40 + i if sampled else None)
            for i, t in enumerate(tails)]
    rs = np.random.RandomState(8)
    reqs += [cls(rid=20 + i, prompt_ids=rs.randint(0, 128, (40,)).astype(
        np.int32), max_new_tokens=4) for i in range(3)]
    reqs += [cls(rid=30 + i, prompt_ids=np.concatenate(
        [fam[i % 2], rs.randint(0, 128, (5 + i,)).astype(np.int32)]),
        max_new_tokens=6, temperature=0.8 if sampled and i else 0.0,
        top_p=0.9, seed=60 + i) for i in range(3)]
    return reqs


def _roundtrip(make, cls, tier):
    """Serve a 30-token prompt, push its chain out of the pool with three
    disjoint 40-token prompts, serve it again: (engine, first tokens,
    revisit tokens)."""
    rs = np.random.RandomState(3)
    P = rs.randint(0, 128, (30,)).astype(np.int32)
    eng = make(enable_host_kv_tier=tier)
    first = eng.serve([cls(rid=0, prompt_ids=P, max_new_tokens=4)])[0]
    rs2 = np.random.RandomState(4)
    for i in range(3):
        q = rs2.randint(0, 128, (40,)).astype(np.int32)
        eng.serve([cls(rid=10 + i, prompt_ids=q, max_new_tokens=4)])
    again = eng.serve([cls(rid=1, prompt_ids=P, max_new_tokens=4)])[1]
    return eng, first, again


def _paced(make, cls):
    """A 30-token prompt served, its whole chain demoted, then revisited
    step by step at a 9-token budget: (engine, first tokens, the revisit
    request, tier_readmits after each step while the plan lasts)."""
    P = np.random.RandomState(17).randint(0, 128, (30,)).astype(np.int32)
    eng = make(token_budget=9, enable_host_kv_tier=True)
    first = eng.serve([cls(rid=0, prompt_ids=P, max_new_tokens=4)])[0]
    eng._reclaim(eng._pcache.resident_blocks())
    revisit = cls(rid=1, prompt_ids=P, max_new_tokens=4)
    eng.add_request(revisit)
    assert eng.step()
    per_step = [eng.stats["tier_readmits"]]
    while eng._tier_plan[0]:
        assert eng.step(), "a restore-only step reported idle mid-plan"
        per_step.append(eng.stats["tier_readmits"])
    while eng.step() or eng._queue:
        pass
    return eng, first, revisit, per_step


def _engines(models):
    jcfg, jparams, tcfg, tparams = models

    def jmake(**kw):
        return JEngine(jcfg, jparams, paged=True, **kw)

    def tmake(**kw):
        return ContinuousBatchingEngine(tcfg, tparams, device="cpu", **kw)

    return jmake, tmake


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine's tier-on runs: each of ``RUNS`` on the revisit
    stream, the round trip and the paced restore."""
    jmake, _ = _engines(models)
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    runs = {}
    for chunked, sampled in RUNS:
        eng = jmake(**dict(ALL_ON, enable_chunked_prefill=chunked),
                    enable_host_kv_tier=True)
        out = eng.serve(_revisit_stream(JRequest, sampled))
        runs[chunked, sampled] = (out, {k: eng.stats[k] for k in STATS},
                                  eng._tier.stats())
    eng, first, again = _roundtrip(lambda **kw: jmake(**SINGLE, **kw),
                                   JRequest, True)
    runs["roundtrip"] = (first, again, {k: eng.stats[k] for k in STATS})
    eng, first, revisit, per_step = _paced(
        lambda **kw: jmake(**SINGLE, **kw), JRequest)
    runs["paced"] = (first, revisit.output_ids, per_step,
                     {k: eng.stats[k] for k in STATS})
    mp.undo()
    return runs


# ---------------- the tier alone ----------------

def _pages(kind, rs, layers=2):
    """One page's (k, v, k_scale, v_scale) as numpy arrays: fp f32, int8
    codes, or int4 codes packed two a byte (half head_dim), the last two
    with per-(layer, kv head) f32 scales."""
    shape = (layers, 2, 8, 8 if kind == "int4" else 16)
    if kind == "fp":
        return (rs.randn(*shape).astype(np.float32),
                rs.randn(*shape).astype(np.float32), None, None)
    return tuple(rs.randint(-128, 128, shape).astype(np.int8)
                 for _ in range(2)) + tuple(
        rs.rand(layers, 2).astype(np.float32) for _ in range(2))


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_tier_calls_match_reference(kind):
    """The same calls on the same pages into both tiers, under a budget of
    three pages: equal stats() after every call (LRU evictions, a pinned
    entry kept, a refused insert, a dedup, the private tier's move) and
    equal bytes out of every ship_in."""
    rs = np.random.RandomState({"fp": 0, "int8": 1, "int4": 2}[kind])
    pages = {f"h{i}": _pages(kind, rs) for i in range(9)}
    pages["huge"] = _pages(kind, rs, layers=16)
    one = sum(a.nbytes for a in pages["h0"] if a is not None)
    ref, mine = JTier(budget_bytes=3 * one), HostKVTier(budget_bytes=3 * one)
    script = ([("out", f"h{i}") for i in range(5)]
              + [("pin", "h3"), ("out", "h5"), ("out", "h6"), ("out", "h7"),
                 ("out", "huge"), ("in", "h3"), ("in", "h0"), ("unpin", "h3"),
                 ("out", "h7"), ("in", "h7"), ("discard", "h6"),
                 ("discard", "h6"), ("out", "h8"), ("pin", "h8"),
                 ("pin", "h5"), ("out", "h1"), ("out", "h2"), ("unpin", "h8"),
                 ("out", "h2"), ("in", "h5"), ("in", "h8")])
    for op, h in script:
        if op == "out":
            k, v, ks, vs = pages[h]
            a = ref.ship_out(h, k, v, k_scale=ks, v_scale=vs)
            b = mine.ship_out(h, _torch(k), _torch(v), k_scale=_torch(ks),
                              v_scale=_torch(vs))
            assert (a is None) == (b is None), (op, h)
        elif op == "in":
            a, b = ref.ship_in(h), mine.ship_in(h)
            assert (a is None) == (b is None), (op, h)
            if a is not None:
                for x, y in ((a.k, b.k), (a.v, b.v), (a.k_scale, b.k_scale),
                             (a.v_scale, b.v_scale)):
                    assert (x is None) == (y is None)
                    if x is not None:
                        assert y.numpy().tobytes() == x.tobytes()
                        assert str(y.dtype).endswith(str(x.dtype))
                assert b.nbytes == a.nbytes
        else:
            assert getattr(mine, op)(h) == getattr(ref, op)(h), (op, h)
        assert mine.stats() == ref.stats(), (op, h)
        assert (h in mine) == (h in ref) and len(mine) == len(ref)
    st = mine.stats()
    assert st["evictions"] > 0 and st["drops"] > 0 and st["readmits"] > 0


def test_ship_out_copies_slab_views():
    """The engine hands the tier views of one gathered slab: each entry
    owns a copy of its page, and ``nbytes`` counts exactly that page."""
    slab = torch.randn(2, 5, 2, 8, 16)
    tier = HostKVTier(budget_bytes=1 << 20)
    e = tier.ship_out("h", slab[:, 1], slab[:, 2])
    for t in (e.k, e.v):
        assert t.untyped_storage().data_ptr() != \
            slab.untyped_storage().data_ptr()
        assert t.is_contiguous()
    assert torch.equal(e.k, slab[:, 1]) and torch.equal(e.v, slab[:, 2])
    assert e.nbytes == 2 * 2 * 2 * 8 * 16 * 4
    slab.zero_()
    assert not torch.equal(e.k, slab[:, 1])


def test_shared_tier_keeps_entries_and_counts_cross_readmits():
    rs = np.random.RandomState(2)
    page = rs.randn(1, 1, 8, 16).astype(np.float32)
    ref = JTier(budget_bytes=1 << 20, shared=True)
    mine = HostKVTier(budget_bytes=1 << 20, shared=True)
    for tier, p in ((ref, page), (mine, torch.from_numpy(page))):
        tier.ship_out("h", p, p, owner="0")
        assert tier.ship_in("h", owner="1") is not None
        assert "h" in tier, "a shared tier keeps the entry"
        assert tier.cross_readmits == 1
        assert tier.ship_in("h", owner="0") is not None
        assert tier.cross_readmits == 1   # its own demoter: not cross
        tier.ship_out("h", p, p, owner="1")   # re-stamps the owner
        tier.ship_in("h", owner="1")
        assert tier.cross_readmits == 1
    assert mine.stats() == ref.stats()


# ---------------- the engine against the JAX engine ----------------

@pytest.mark.parametrize("chunked,sampled", RUNS,
                         ids=["chunked-greedy", "chunked-seeded",
                              "bucketed-greedy"])
def test_engine_matches_jax(models, jax_runs, chunked, sampled):
    """Every feature on (prefix cache, chunked prefill or bucketed,
    speculation, graceful mode), a pool that evicts, revisits of demoted
    prefixes: the tier-on engine's tokens, statistics and tier counters
    are the JAX engine's, its tokens the tier-off engine's."""
    _, tmake = _engines(models)
    kw = dict(ALL_ON, enable_chunked_prefill=chunked)
    eng = tmake(**kw, enable_host_kv_tier=True)
    out = eng.serve(_revisit_stream(Request, sampled))
    jout, jstats, jtier = jax_runs[chunked, sampled]
    assert out == jout
    assert {k: eng.stats[k] for k in STATS} == jstats
    assert eng._tier.stats() == jtier
    st = eng.stats
    assert st["tier_demotions"] > 0 and st["tier_hits"] > 0
    assert st["tier_readmits"] > 0
    off = tmake(**kw)
    assert off.serve(_revisit_stream(Request, sampled)) == out
    assert all(off.stats[k] == 0 for k in TIER_STATS)


def test_demote_readmit_roundtrip(models, jax_runs):
    """A chain pushed out of the pool by disjoint traffic comes back
    through the tier on its revisit: hits, restores, fewer prefill tokens
    computed, the restore histogram and the flight records, the tokens a
    tier-off engine emits, and the JAX engine's statistics."""
    _, tmake = _engines(models)

    def make(**kw):
        return tmake(**SINGLE, **kw)

    eng, first, again = _roundtrip(make, Request, True)
    off, first_o, again_o = _roundtrip(make, Request, False)
    jfirst, jagain, jstats = jax_runs["roundtrip"]
    assert first == first_o == jfirst and again == again_o == jagain
    assert again == first
    assert {k: eng.stats[k] for k in STATS} == jstats
    assert eng.stats["tier_hits"] > 0 and eng.stats["tier_readmits"] > 0
    assert off.stats["tier_readmits"] == 0
    assert (eng.stats["prefill_tokens_computed"]
            < off.stats["prefill_tokens_computed"])
    assert eng._h_h2d.count == eng.stats["tier_readmits"]
    assert "paddle_tpu_serving_h2d_restore_seconds_count" in \
        eng.metrics.expose()
    kinds = {e["kind"] for e in eng._flight.events()}
    assert {"tier_match", "tier_demote", "tier_readmit"} <= kinds


def test_restores_are_paced_by_token_budget(models, jax_runs):
    """A demoted three-block chain restores one block a step at a 9-token
    budget, restore-only steps keep the serve going, and the readmits step
    by step and the tokens are the JAX engine's."""
    _, tmake = _engines(models)
    eng, first, revisit, per_step = _paced(
        lambda **kw: tmake(**SINGLE, **kw), Request)
    jfirst, jtokens, jper_step, jstats = jax_runs["paced"]
    deltas = [b - a for a, b in zip(per_step, per_step[1:])]
    assert all(d <= 1 for d in deltas) and per_step[0] <= 2, per_step
    assert per_step == jper_step
    assert revisit.output_ids == first == jtokens == jfirst
    assert {k: eng.stats[k] for k in STATS} == jstats
    assert eng.stats["tier_readmits"] >= 2


def test_graceful_off_chunked_restores_at_admission(monkeypatch, models):
    """With graceful mode off a chunked admission maps its whole prompt's
    pages at once, so the tier restores at admission, as the bucketed
    engine does."""
    monkeypatch.setenv("PADDLE_TPU_GRACEFUL", "0")
    _, tmake = _engines(models)
    eng, first, again = _roundtrip(lambda **kw: tmake(**SINGLE, **kw),
                                   Request, True)
    assert again == first
    assert eng.stats["tier_readmits"] > 0
    assert not any(eng._tier_plan)


def test_tier_drop_falls_back_to_prefill(monkeypatch, models):
    """Every restore finds its entry gone: the engine prefills instead,
    finishes every request and emits the tier-off tokens."""
    _, tmake = _engines(models)
    ref = tmake(**ALL_ON).serve(_revisit_stream(Request))
    monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT", "tier_drop@count=-1")
    eng = tmake(**ALL_ON, enable_host_kv_tier=True)
    assert eng.serve(_revisit_stream(Request)) == ref
    assert eng.stats["tier_hits"] > 0 and eng.stats["tier_readmits"] == 0
    assert all(r is None for r in eng._slot_req)
    assert any(e["kind"] == "fault" and e["fault"] == "tier_drop"
               for e in eng._flight.events())


def test_kill_switches_and_requirements(monkeypatch, models):
    """``PADDLE_TPU_HOST_KV_TIER=0`` wins over the constructor and leaves
    the pre-tier engine's tokens and page order; ``PADDLE_TPU_PREFIX_CACHE
    =0`` turns the tier off too; the tier needs the prefix cache, and a
    budget of at least one byte."""
    _, tmake = _engines(models)
    plain = tmake(**ALL_ON)
    ref = plain.serve(_revisit_stream(Request))
    monkeypatch.setenv("PADDLE_TPU_HOST_KV_TIER", "0")
    eng = tmake(**ALL_ON, enable_host_kv_tier=True,
                host_tier=HostKVTier(budget_bytes=1 << 20))
    assert eng._tier is None
    assert eng.serve(_revisit_stream(Request)) == ref
    assert eng._pcache.resident_pages() == plain._pcache.resident_pages()
    assert eng._free == plain._free
    monkeypatch.delenv("PADDLE_TPU_HOST_KV_TIER")
    monkeypatch.setenv("PADDLE_TPU_PREFIX_CACHE", "0")
    eng = tmake(**ALL_ON, enable_host_kv_tier=True)
    assert eng._tier is None and eng._pcache is None
    monkeypatch.delenv("PADDLE_TPU_PREFIX_CACHE")
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        tmake(max_batch=1, max_seq=64, block_size=8, num_blocks=8,
              enable_host_kv_tier=True)
    with pytest.raises(ValueError, match="budget_bytes"):
        HostKVTier(budget_bytes=0)


def test_flags_registered_and_typos_warn(monkeypatch):
    assert envflags.BOOL_FLAGS["PADDLE_TPU_HOST_KV_TIER"] is True
    assert "PADDLE_TPU_HOST_TIER_MIB" in envflags.__doc__
    monkeypatch.setenv("PADDLE_TPU_HOST_KV_TIER", "off")
    envflags._warned.clear()
    with pytest.warns(UserWarning, match="PADDLE_TPU_HOST_KV_TIER"):
        assert envflags.env_bool("PADDLE_TPU_HOST_KV_TIER", True) is True
    for raw, match in (("lots", "PADDLE_TPU_HOST_TIER_MIB"),
                       ("0", "below the minimum")):
        monkeypatch.setenv("PADDLE_TPU_HOST_TIER_MIB", raw)
        envflags._warned.clear()
        with pytest.warns(UserWarning, match=match):
            assert HostKVTier().budget_bytes == 256 << 20
    monkeypatch.setenv("PADDLE_TPU_HOST_TIER_MIB", "3")
    assert HostKVTier().budget_bytes == 3 << 20


def test_evicted_blocks_feed_the_tier(models):
    """Every (hash, page) pair a pressure eviction returns lands in the
    tier under that hash."""
    _, tmake = _engines(models)
    eng = tmake(max_batch=1, max_seq=64, block_size=8, num_blocks=8,
                enable_prefix_caching=True, enable_host_kv_tier=True)
    rs = np.random.RandomState(11)
    eng.serve([Request(rid=0, prompt_ids=rs.randint(0, 128, (20,)).astype(
        np.int32), max_new_tokens=4)])
    hashes = set(eng._pcache._by_hash)
    for i in range(3):
        q = rs.randint(0, 128, (40,)).astype(np.int32)
        eng.serve([Request(rid=10 + i, prompt_ids=q, max_new_tokens=4)])
    evicted = hashes - set(eng._pcache._by_hash)
    assert evicted, "pressure never evicted the first chain"
    assert all(h in eng._tier for h in evicted)
