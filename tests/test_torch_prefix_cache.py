"""The port's prefix cache against the JAX engine on the CPU.

Same f32 tiny Llama (``LlamaConfig.tiny``), the JAX parameter tree bridged
through ``paddle_tpu_torch.utils.convert``, the same request streams (made
with numpy from a seed).  The JAX engine runs with
``enable_prefix_caching=True, paged=True`` through its plain references
(``PADDLE_TPU_DISABLE_PALLAS=paged_attention``, as in
``test_torch_chunked_spec.py``), once per stream and mode, shared through
one module fixture.  Following ``tests/test_prefix_cache.py``:

- a shared-prefix stream (greedy and seeded top-p; prompts that diverge
  mid-block; two repeats of a block-aligned prompt whose every block is
  cached, so each takes a copy-on-write page), bucketed and chunked, on fp
  and int8 pools: tokens, the cache statistics, the chain ids and the
  resident pages equal the JAX engine's, the cache-on tokens equal the
  port's cache-off tokens (fp and int8), and no page is written while the
  cache holds it;
- a pool far smaller than the working set: LRU eviction, leaf first, and
  preempt-then-resume through the donated prefix, equal to the JAX engine;
- a full hit skips prefill; the hash chain separates near-miss prefixes
  and is the reference's byte for byte; eviction is LRU and leaf-first;
- the kill switch ``PADDLE_TPU_PREFIX_CACHE``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.prefix_cache import PrefixCache as JCache
from paddle_tpu.inference.serving import ContinuousBatchingEngine, Request
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.prefix_cache import PrefixCache as TCache
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

# two slots, 8-token pages, room for every request (SHARED) or a pool that
# evicts and preempts (PRESSURE)
ENGINE = dict(max_batch=2, max_seq=64, chunk=2, block_size=8)
CHUNKED = dict(enable_chunked_prefill=True, prefill_chunk=8)
STATS = ("prefix_hits", "prefix_blocks_reused", "cow_copies",
         "prefix_evictions", "prefill_tokens_computed",
         "prefill_tokens_cached", "preemptions", "prefills", "decode_steps",
         "mixed_steps", "prefill_chunks")


def _shared_stream(cls):
    """A 20-token shared prefix (two full blocks and half a third) with
    its own tail per request, greedy and seeded top-p; rids 2 and 4 are
    the prefix's first 16 tokens alone, a block-aligned prompt whose two
    blocks are cached by then (copy-on-write)."""
    rs = np.random.RandomState(7)
    shared = rs.randint(1, 256, 20).astype(np.int32)
    tails = [rs.randint(1, 256, n).astype(np.int32) for n in (5, 7, 3)]
    prompts = [np.concatenate([shared, tails[0]]),
               np.concatenate([shared, tails[1]]), shared[:16],
               np.concatenate([shared, tails[2]]), shared[:16]]
    temps = (0.0, 1.2, 0.0, 0.9, 1.1)
    return [cls(rid=i, prompt_ids=p, max_new_tokens=8, temperature=t,
                top_p=0.9, seed=40 + i)
            for i, (p, t) in enumerate(zip(prompts, temps))]


def _pressure_stream(cls):
    """Two 16-token prefixes shared by alternate requests, and three
    arithmetic prompts that outgrow a 10-page pool together (one sampled):
    eviction of zero-ref blocks and preemption through donated blocks."""
    rs = np.random.RandomState(19)
    pre = [rs.randint(1, 256, 16).astype(np.int32) for _ in range(2)]
    tails = [rs.randint(1, 256, n).astype(np.int32) for n in (6, 9, 5, 8)]
    reqs = [cls(rid=i, prompt_ids=np.concatenate([pre[i % 2], t]),
                max_new_tokens=8) for i, t in enumerate(tails)]
    reqs += [cls(rid=10 + i, prompt_ids=np.arange(1 + i, 40 - 5 * i,
                                                   dtype=np.int32),
                 max_new_tokens=10, temperature=0.9 if i == 1 else 0.0,
                 top_p=0.85, seed=100 + i) for i in range(3)]
    return reqs


STREAMS = {"shared": (_shared_stream, dict(num_blocks=24)),
           "pressure": (_pressure_stream, dict(num_blocks=10))}
#: (stream, chunked, kv_quant) runs held to the JAX engine
RUNS = [("shared", False, None), ("shared", True, None),
        ("shared", False, "int8"), ("shared", True, "int8"),
        ("pressure", False, None), ("pressure", True, None)]


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _cache_state(eng):
    """The cache's chain ids and resident pages, in insertion order."""
    return list(eng._pcache._by_hash), eng._pcache.resident_pages()


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine with the prefix cache on each of ``RUNS``: key ->
    (tokens, stats, chain ids, resident pages)."""
    jcfg, jparams, _, _ = models
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    runs = {}
    for key in RUNS:
        stream, chunked, kvq = key
        build, eng_kw = STREAMS[stream]
        eng = ContinuousBatchingEngine(
            jcfg, jparams, paged=True, kv_quant=kvq,
            enable_prefix_caching=True, **ENGINE, **eng_kw,
            **(CHUNKED if chunked else {}))
        out = eng.serve(build(Request))
        runs[key] = (out, {k: eng.stats[k] for k in STATS},
                     *_cache_state(eng))
    mp.undo()
    return runs


def _pool_pages(eng, pages):
    """The bytes of ``pages`` in every pool tensor (codes and scales)."""
    out = []
    for pool in (eng.cache_k, eng.cache_v):
        for t in (pool.values() if isinstance(pool, dict) else (pool,)):
            out.append(t[:, pages].clone())
    return out


def _serve_port(models, stream, chunked=False, kv_quant=None, cache=True,
                **kw):
    """The port's engine on a stream; with the cache on, every step checks
    that no page the cache held before the step was written during it
    (the engine never writes a shared page).  Returns (tokens, engine,
    pages checked)."""
    _, _, tcfg, tparams = models
    build, eng_kw = STREAMS[stream]
    eng = tserving.ContinuousBatchingEngine(
        tcfg, tparams, paged=True, device="cpu", kv_quant=kv_quant,
        enable_prefix_caching=cache, **ENGINE, **{**eng_kw, **kw},
        **(CHUNKED if chunked else {}))
    checked = [0]
    if cache:
        step = eng.step

        def guarded_step():
            held = dict(zip(*_cache_state(eng)))
            before = _pool_pages(eng, list(held.values()))
            busy = step()
            now = dict(zip(*_cache_state(eng)))
            # the pages one block held before and after the step
            kept = [i for i, (h, p) in enumerate(held.items())
                    if now.get(h) == p]
            after = _pool_pages(eng, list(held.values()))
            for a, b in zip(before, after):
                assert torch.equal(a[:, kept], b[:, kept]), \
                    "a page the cache held was written"
            checked[0] += len(kept)
            return busy

        eng.step = guarded_step
    out = eng.serve(build(tserving.Request))
    return out, eng, checked[0]


def _pool_accounting(eng):
    """After a drain every page is in exactly one place: the free list or
    the cache, and every cached block is zero-ref."""
    assert all(not b for b in eng._slot_blocks)
    assert all(not h for h in eng._slot_shared)
    free = list(eng._free)
    cached = eng._pcache.resident_pages()
    assert len(free) == len(set(free))
    assert sorted(free + cached) == list(range(eng.num_blocks))
    assert eng._pcache.evictable_count() == eng._pcache.resident_blocks()


@pytest.mark.parametrize("key", RUNS, ids=lambda k: "-".join(map(str, k)))
def test_prefix_cache_matches_jax(models, jax_runs, key):
    """Tokens, the cache statistics, the chain ids and the resident pages
    equal the JAX engine's; no held page is written; the pool accounts."""
    stream, chunked, kvq = key
    got, eng, checked = _serve_port(models, stream, chunked, kvq)
    want, jstats, jhashes, jpages = jax_runs[key]
    assert got == want
    assert {k: eng.stats[k] for k in STATS} == jstats
    assert _cache_state(eng) == (jhashes, jpages)
    assert checked > 0
    _pool_accounting(eng)
    st = eng.stats
    assert st["prefix_hits"] > 0 and st["prefill_tokens_cached"] > 0
    if stream == "shared":
        assert st["cow_copies"] == 2, "rids 2 and 4 copy their last block"
        assert got[2] != got[4], "the copies' streams diverge"
        assert st["prefix_evictions"] == 0
    else:
        assert st["prefix_evictions"] > 0 and st["preemptions"] > 0


@pytest.mark.parametrize("chunked", [False, True])
def test_cache_on_off_token_identical(models, jax_runs, chunked):
    """On fp pools the cache changes what is computed, not what is
    emitted: the cache-off port engine emits the same tokens and computes
    more prefill tokens."""
    for stream in STREAMS:
        off, eng, _ = _serve_port(models, stream, chunked, cache=False)
        assert eng._pcache is None
        want, jstats, _, _ = jax_runs[(stream, chunked, None)]
        assert off == want
        assert eng.stats["prefill_tokens_cached"] == 0
        assert (eng.stats["prefill_tokens_computed"]
                > jstats["prefill_tokens_computed"])


@pytest.mark.parametrize("chunked", [False, True])
def test_quant_cache_on_off_token_identical(models, jax_runs, chunked):
    """On int8 pools too the cache changes what is computed, not what is
    emitted here, although a chunked hit streams its tail in other chunks
    than the cache-off run (so other write events requantize its pages):
    the cache-off port engine emits the cache-on JAX engine's tokens."""
    off, eng, _ = _serve_port(models, "shared", chunked, "int8", cache=False)
    assert eng._pcache is None
    want, jstats, _, _ = jax_runs[("shared", chunked, "int8")]
    assert off == want
    assert (eng.stats["prefill_tokens_computed"]
            > jstats["prefill_tokens_computed"])


def test_full_hit_skips_prefill(models):
    """A block-aligned prompt whose every block is cached: no prefill runs,
    no prompt token is computed again, and the stream repeats."""
    _, _, tcfg, tparams = models
    prompt = np.arange(5, 21, dtype=np.int32)     # two full 8-token blocks
    eng = tserving.ContinuousBatchingEngine(
        tcfg, tparams, paged=True,
        device="cpu", max_batch=1, max_seq=64, chunk=1,
        block_size=8, num_blocks=10, enable_prefix_caching=True)
    first = eng.serve([tserving.Request(rid=0, prompt_ids=prompt,
                                        max_new_tokens=4)])
    prefills, computed = (eng.stats["prefills"],
                          eng.stats["prefill_tokens_computed"])
    second = eng.serve([tserving.Request(rid=1, prompt_ids=prompt,
                                         max_new_tokens=4)])
    assert second[1] == first[0]
    assert eng.stats["prefills"] == prefills
    assert eng.stats["prefill_tokens_computed"] == computed
    assert eng.stats["prefill_tokens_cached"] == 15
    assert eng.stats["cow_copies"] == 1
    _pool_accounting(eng)


def test_hash_chain_matches_jax_and_separates_prefixes():
    """The chain ids are the reference's byte for byte, and separate a
    different token in a block, the same block under another parent, and
    other block boundaries over one stream; the radix walk returns the
    longest cached chain and stops at a divergent block."""
    pc, jpc = TCache(block_size=4), JCache(block_size=4)
    rs = np.random.RandomState(0)
    streams = [rs.randint(0, 1000, (8,)).astype(np.int32) for _ in range(50)]
    for j in range(8):
        v = streams[0].copy()
        v[j] = (v[j] + 1) % 1000
        streams.append(v)
    seen = set()
    for s in streams:
        hs = pc.chain_hashes(s, 2)
        assert hs == jpc.chain_hashes(s, 2)
        seen.update(hs)
    assert len(seen) >= 2 * 50 + 8 + 1
    blk = np.arange(4, dtype=np.int32)
    assert pc.chain_hash(None, blk) != pc.chain_hash("deadbeef", blk)
    assert (TCache(3).chain_hashes(np.arange(6), 1)
            != TCache(2).chain_hashes(np.arange(6), 1))
    a = np.arange(8, dtype=np.int32)
    h = pc.chain_hashes(a, 2)
    pc.register(None, a[:4], page=0)
    assert [e.hash for e in pc.match(a)] == h[:1]
    pc.register(h[0], a[4:8], page=1)
    assert [e.hash for e in pc.match(a)] == h
    b = a.copy()
    b[5] += 1
    assert [e.hash for e in pc.match(b)] == h[:1]


def test_eviction_is_lru_and_leaf_first():
    """A chain's root goes only after its cached child; a referenced block
    is never evicted; ``evict`` returns (id, page) pairs; the zero-ref
    count follows every change."""
    pc = TCache(block_size=4)
    a = np.arange(8, dtype=np.int32)
    h = pc.chain_hashes(a, 2)
    pc.register(None, a[:4], page=0)
    pc.register(h[0], a[4:8], page=1)
    other = pc.register(None, np.arange(100, 104, dtype=np.int32), page=2)
    assert pc.evictable_count() == 3
    assert pc.evict(1) == [(h[1], 1)]
    pc.acquire(other)
    assert pc.evictable_count() == 1
    assert pc.evict(10) == [(h[0], 0)]
    pc.release(other.hash)
    assert pc.evict(10) == [(other.hash, 2)]
    assert pc.resident_blocks() == 0 == pc.evictable_count()
    # a block whose parent left the index is refused (it would be
    # unreachable), and so is content already cached; neither counts
    assert pc.register(h[0], a[4:8], page=3) is None
    pc.register(None, a[:4], page=4)
    assert pc.register(None, a[:4], page=5) is None
    assert pc.evictable_count() == 1 == pc.resident_blocks()
    assert pc.evict(10) == [(h[0], 4)] and pc.evictable_count() == 0


def test_kill_switch(models, jax_runs, monkeypatch):
    """``PADDLE_TPU_PREFIX_CACHE=0`` turns the cache off whatever the
    argument says (and the engine serves the cache-off stream); a value
    other than 0/1 warns and keeps the default."""
    _, _, tcfg, tparams = models
    monkeypatch.setenv("PADDLE_TPU_PREFIX_CACHE", "0")
    eng = tserving.ContinuousBatchingEngine(
        tcfg, tparams, paged=True,
        device="cpu", enable_prefix_caching=True, **ENGINE,
        **STREAMS["shared"][1])
    assert eng._pcache is None
    got = eng.serve(_shared_stream(tserving.Request))
    assert got == jax_runs[("shared", False, None)][0]
    assert eng.stats["prefix_hits"] == 0
    monkeypatch.setenv("PADDLE_TPU_PREFIX_CACHE", "off")
    with pytest.warns(UserWarning, match="PADDLE_TPU_PREFIX_CACHE"):
        eng = tserving.ContinuousBatchingEngine(
            tcfg, tparams, paged=True,
            device="cpu", enable_prefix_caching=True,
            **ENGINE)
    assert eng._pcache is not None
