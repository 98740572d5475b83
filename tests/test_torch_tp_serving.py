"""The port's tensor-parallel serving against the reference on the CPU.

The reference's tiny f32 Llama of ``tests/test_tp_serving.py`` (vocab 128,
hidden 64, 2 layers, 8 heads over 4 kv heads, ffn 128), its parameter tree
bridged through ``paddle_tpu_torch.utils.convert``, the reference test's
request streams (made with numpy from a seed).  The JAX engines run at
``tensor_parallel=2`` over the conftest's forced host devices, through
their plain references (``PADDLE_TPU_DISABLE_PALLAS=paged_attention``),
shared by one module fixture.  The port's two ranks come from ONE spawn
for the whole module: two processes in a gloo group whose store is a file
under the module's temporary directory (no port to collide on), each
running every scenario and writing what it saw to a file.  The spawn runs
while the parent serves the JAX engines.  Held to the reference:

- ``shard_serving_params``: each rank's slice bit-equal to the device
  shard of ``jax.device_put(params, NamedSharding(mesh,
  serving_param_specs(...)))``, fp, int8 and int4 trees;
- the all-features stream (prefix cache, speculation with 3 drafts,
  chunked prefill of 8, greedy and seeded rows, the auditor on) at tp=2:
  tokens equal to the JAX tp=2 engine's and the port's tp=1 engine's, the
  reference test's five counters equal to the JAX engine's, the same on
  both ranks; the pool closes on each rank; both ranks' logits equal bit
  for bit after every step; 2 x layers all-reduces a forward;
- weight-only int8 at tp=2 token-identical to the JAX tp=2 engine;
- the all-features stream over int8 and int4 KV pools at tp=2
  token-identical to the port's tp=1 engine;
- the host KV tier on at tp=2 under a budget that evicts: tokens and the
  ``tier_*`` statistics equal to the JAX tp=2 engine's (each rank's tier
  holds its kv heads of a page and counts the whole page);
- a snapshot at tp=2 restored on the port's and on the JAX engine's tp=1
  engine gives the uninterrupted stream;
- a deadline that one rank's clock alone finds passed: both ranks expire
  the request at the same step, their logits equal bit for bit after
  every step, their tokens the port's tp=1 engine's with the request
  cancelled at that step;
- in the ranks: a degree other than the group's size raises, a valid
  ``PADDLE_TPU_TP`` replaces the constructor's value and one other than
  the group's size warns and serves on one rank; an explicit
  ``process_group``; no JAX module loaded.

Without any process: the constructor's validation, ``PADDLE_TPU_TP`` and
its warnings, tp=1 running no collective, the auditor's I1 clause for a
rank's pools.

Tolerance: none; tokens, counters, statistics and shards compare exactly.

The spawned ranks import this module: it imports no JAX at the top, only
inside the functions the parent runs.
"""

import dataclasses
import datetime
import json
import os
import sys
import time
import types
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch.analysis.engine_audit import (EngineAuditError,
                                                    audit_engine)
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.kv_tier import HostKVTier
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                Request)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import envflags
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TP = 2
_KW = dict(vocab=128, hidden=64, layers=2, heads=8, kv_heads=4, inter=128)
BASE = dict(max_batch=2, max_seq=64, block_size=8)
#: the reference's all-features engine
ALL_ON = dict(BASE, num_blocks=24, enable_prefix_caching=True,
              enable_speculation=True, num_draft_tokens=3,
              enable_chunked_prefill=True, prefill_chunk=8)
COUNTERS = ("prefix_hits", "mixed_steps", "spec_steps", "decode_steps",
            "preemptions")
#: the tier run: every feature on over an 8-page pool, a budget of three
#: whole pages (L 2 x 4 kv heads x 8 x 8 f32, K and V), so the tier evicts
TIER = dict(BASE, num_blocks=8, enable_prefix_caching=True,
            enable_speculation=True, enable_chunked_prefill=True,
            prefill_chunk=5)
TIER_BUDGET = 3 * 2 * (2 * 4 * 8 * 8 * 4)
TIER_STATS = ("tier_bytes", "tier_demotions", "tier_evictions", "tier_hits",
              "tier_readmits", "prefix_hits", "prefix_evictions",
              "prefill_tokens_computed", "prefill_tokens_cached")
#: KV pool formats the ranks serve the all-features stream on, held to
#: the port's tp=1 engine
KV_QUANTS = ("int8", "int4")
#: the snapshot run: steps served before the snapshot
SNAP_STEPS = 3
#: the deadline run: the step before which rank 1's clock jumps past
#: request 0's deadline (the tp=1 engine cancels request 0 there instead)
EXPIRE_STEP = 3
#: seconds the parent waits for the ranks
RANKS_TIMEOUT_S = 300


def _cfg():
    return dataclasses.replace(tllama.LlamaConfig.tiny(**_KW),
                               dtype=torch.float32)


# ---------------- the request streams (either package's Request) --------

def _mixed_requests(cls):
    """The reference's all-features stream: four requests over a shared
    16-token prefix, greedy and seeded in turn, and a 40-token prompt that
    streams through the chunked prefill."""
    rs = np.random.RandomState(3)
    shared = np.arange(16, dtype=np.int32)
    reqs = []
    for i in range(4):
        tail = rs.randint(0, 128, (6,)).astype(np.int32)
        reqs.append(cls(rid=i, prompt_ids=np.concatenate([shared, tail]),
                        max_new_tokens=8,
                        temperature=0.7 if i % 2 else 0.0, seed=11 + i))
    reqs.append(cls(rid=99, prompt_ids=rs.randint(0, 128, (40,))
                    .astype(np.int32), max_new_tokens=5))
    return reqs


def _int8_requests(cls):
    """The reference's weight-only int8 stream."""
    rs = np.random.RandomState(2)
    return [cls(rid=i, prompt_ids=rs.randint(0, 128, (7,)).astype(np.int32),
                max_new_tokens=5) for i in range(2)]


def _tier_requests(cls):
    """Two 16-token prefix families, three disjoint 40-token prompts that
    turn the 8-page pool over, then three requests revisiting the demoted
    families (every other one sampled)."""
    rs = np.random.RandomState(7)
    fam = [rs.randint(0, 128, (16,)).astype(np.int32) for _ in range(2)]
    reqs = [cls(rid=i, prompt_ids=np.concatenate(
        [fam[i % 2], rs.randint(0, 128, (5 + i,)).astype(np.int32)]),
        max_new_tokens=6) for i in range(4)]
    rs = np.random.RandomState(8)
    reqs += [cls(rid=20 + i, prompt_ids=rs.randint(0, 128, (40,)).astype(
        np.int32), max_new_tokens=4) for i in range(3)]
    reqs += [cls(rid=30 + i, prompt_ids=np.concatenate(
        [fam[i % 2], rs.randint(0, 128, (5 + i,)).astype(np.int32)]),
        max_new_tokens=6, temperature=0.8 if i % 2 else 0.0, top_p=0.9,
        seed=60 + i) for i in range(3)]
    return reqs


def _snap_request(cls):
    p = np.random.RandomState(3).randint(0, 128, (9,)).astype(np.int32)
    return cls(rid=0, prompt_ids=p, max_new_tokens=8, temperature=0.6,
               seed=5)


def _deadline_requests(cls):
    """Three requests on two slots: request 0 with a deadline no clock
    reaches unaided, request 2 queued until a slot frees."""
    rs = np.random.RandomState(5)
    return [cls(rid=i, prompt_ids=rs.randint(0, 128, (7,)).astype(np.int32),
                max_new_tokens=8, deadline_s=1e6 if i == 0 else None)
            for i in range(3)]


def _pool_closes(eng) -> bool:
    cached = (list(eng._pcache.resident_pages())
              if eng._pcache is not None else [])
    private = [p for row in eng._slot_blocks for p in row]
    return sorted(eng._free + cached + private) == list(range(eng.num_blocks))


def _drain(eng):
    while eng.step() or eng._queue:
        pass


# ---------------- the ranks ----------------

def _stepwise(eng, before=None):
    """Serve what is queued step by step (``before(n)`` runs ahead of step
    n, 1-based): after each step the all-reduces and the forward calls it
    ran, the last logits and every live request's token count."""
    calls = [0]
    apply = tserving.transformer_apply

    def counted(*a, **k):
        calls[0] += 1
        return apply(*a, **k)

    tserving.transformer_apply = counted
    steps = []
    try:
        while True:
            if before is not None:
                before(len(steps) + 1)
            ar0, f0 = tllama.TP_COUNTERS["all_reduce"], calls[0]
            eng.last_logits = None
            busy = eng.step()
            steps.append({
                "all_reduce": tllama.TP_COUNTERS["all_reduce"] - ar0,
                "forwards": calls[0] - f0,
                "logits": (None if eng.last_logits is None
                           else eng.last_logits.clone()),
                "tokens": {rid: len(q.output_ids)
                           for rid, q in eng._reqs.items()}})
            if not busy and not eng._queue:
                break
    finally:
        tserving.transformer_apply = apply
    return steps


def _rank_scenarios(rank, tree):
    cfg = _cfg()
    params = params_from_numpy(tree, device="cpu")

    def make(**kw):
        return ContinuousBatchingEngine(cfg, params, paged=True, device="cpu",
                                        tensor_parallel=TP, **kw)

    out = {"rank": rank}
    # the all-features stream with the auditor on
    os.environ["PADDLE_TPU_ENGINE_AUDIT"] = "1"
    try:
        eng = make(**ALL_ON)
        reqs = _mixed_requests(Request)
        for r in reqs:
            eng.add_request(r)
        steps = _stepwise(eng)
    finally:
        del os.environ["PADDLE_TPU_ENGINE_AUDIT"]
    out["all"] = {"tokens": {r.rid: r.output_ids for r in reqs},
                  "counters": {k: eng.stats[k] for k in COUNTERS},
                  "steps": steps, "pool_closes": _pool_closes(eng),
                  "tp": eng.tp, "rank_of_engine": eng._tp_rank}
    # the same stream over int8 and int4 KV pools
    out["kv"] = {kvq: make(**ALL_ON, kv_quant=kvq).serve(
        _mixed_requests(Request)) for kvq in KV_QUANTS}
    # weight-only int8 through an explicit process group
    group = dist.new_group([0, 1])
    eng = make(**BASE, quant="int8", process_group=group)
    out["int8"] = eng.serve(_int8_requests(Request))
    # the host tier under a budget that evicts
    eng = make(**TIER, enable_host_kv_tier=True,
               host_tier=HostKVTier(budget_bytes=TIER_BUDGET))
    tokens = eng.serve(_tier_requests(Request))
    out["tier"] = {"tokens": tokens,
                   "stats": {k: eng.stats[k] for k in TIER_STATS},
                   "tier": eng._tier.stats()}
    # a deadline that rank 1's clock alone finds passed: both ranks
    # expire it at once and seat the queued request in its slot
    eng = make(**BASE)
    reqs = _deadline_requests(Request)
    for r in reqs:
        eng.add_request(r)

    def clock_jump(step):
        if rank == 1 and step == EXPIRE_STEP:
            reqs[0]._submit_s -= 2e6

    out["deadline"] = {"steps": _stepwise(eng, clock_jump),
                       "tokens": {r.rid: r.output_ids for r in reqs},
                       "status": {r.rid: r.status for r in reqs}}
    # a snapshot mid-serve, then the rest of the serve
    eng = make(**BASE)
    req = _snap_request(Request)
    eng.add_request(req)
    for _ in range(SNAP_STEPS):
        eng.step()
    out["snapshot"] = json.dumps(eng.snapshot())
    _drain(eng)
    out["uninterrupted"] = req.output_ids
    # validation against the group
    try:
        ContinuousBatchingEngine(cfg, params, paged=True, device="cpu",
                                 tensor_parallel=4, **BASE)
        out["tp4_error"] = None
    except ValueError as e:
        out["tp4_error"] = str(e)
    os.environ["PADDLE_TPU_TP"] = "2"
    try:
        out["env_tp2"] = ContinuousBatchingEngine(
            cfg, params, paged=True, device="cpu", **BASE).tp
        os.environ["PADDLE_TPU_TP"] = "4"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["env_tp4"] = ContinuousBatchingEngine(
                cfg, params, paged=True,
                device="cpu", tensor_parallel=2, **BASE).tp
        out["env_tp4_warnings"] = [str(w.message) for w in caught]
    finally:
        del os.environ["PADDLE_TPU_TP"]
    out["forbidden"] = sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib",
                                                     "paddle_tpu"))
    return out


def _rank_main(rank, tmp, tree):
    """One rank: join the file-store gloo group, run every scenario, write
    what it saw to ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=TP,
                            timeout=datetime.timedelta(seconds=60))
    try:
        torch.save(_rank_scenarios(rank, tree), os.path.join(
            tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------- the module fixture ----------------

def _jax_models():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.models import llama as jllama

    jcfg = jllama.LlamaConfig.tiny(**_KW)
    jcfg.dtype = jnp.float32
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _jax_runs(jcfg, jparams, snapshot=None):
    """The JAX engine's runs: the tp=2 all-features, int8 and tier
    streams, the uninterrupted tp=1 snapshot stream, and (given) the
    ranks' snapshot restored on a tp=1 engine."""
    from paddle_tpu.inference.kv_tier import HostKVTier as JTier
    from paddle_tpu.inference.serving import ContinuousBatchingEngine as JE
    from paddle_tpu.inference.serving import Request as JRequest

    def make(tp, **kw):
        return JE(jcfg, jparams, paged=True, tensor_parallel=tp, **kw)

    runs = {}
    mp_ = pytest.MonkeyPatch()
    mp_.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    try:
        if snapshot is not None:
            eng = make(1, **BASE)
            restored = eng.restore(snapshot)
            _drain(eng)
            return restored[0].output_ids
        mp_.setenv("PADDLE_TPU_ENGINE_AUDIT", "1")
        eng = make(TP, **ALL_ON)
        runs["all"] = (eng.serve(_mixed_requests(JRequest)),
                       {k: eng.stats[k] for k in COUNTERS})
        mp_.delenv("PADDLE_TPU_ENGINE_AUDIT")
        runs["int8"] = make(TP, **BASE, quant="int8").serve(
            _int8_requests(JRequest))
        eng = make(TP, **TIER, enable_host_kv_tier=True,
                   host_tier=JTier(budget_bytes=TIER_BUDGET))
        runs["tier"] = (eng.serve(_tier_requests(JRequest)),
                        {k: eng.stats[k] for k in TIER_STATS},
                        eng._tier.stats())
        runs["snap_ref"] = make(1, **BASE).serve(
            [_snap_request(JRequest)])[0]
    finally:
        mp_.undo()
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (spawned first, run while the parent serves the
    JAX engines and the port's tp=1 engine), the JAX runs, the port's tp=1
    runs and the two tp=1 restores of the ranks' snapshot."""
    jcfg, jparams, tree = _jax_models()
    tmp = str(tmp_path_factory.mktemp("tp_ranks"))
    ctx = mp.spawn(_rank_main, args=(tmp, tree), nprocs=TP, join=False)
    try:
        jax_runs = _jax_runs(jcfg, jparams)
        params = params_from_numpy(tree, device="cpu")
        tp1 = {kvq: ContinuousBatchingEngine(
            _cfg(), params, paged=True,
            device="cpu", kv_quant=kvq, **ALL_ON).serve(
                _mixed_requests(Request)) for kvq in (None,) + KV_QUANTS}
        eng = ContinuousBatchingEngine(_cfg(), params, paged=True,
                                       device="cpu", **BASE)
        reqs = _deadline_requests(Request)
        for r in reqs:
            eng.add_request(r)
        _stepwise(eng, lambda n: n == EXPIRE_STEP and eng.cancel(0))
        tp1["deadline"] = {r.rid: r.output_ids for r in reqs}
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(TP)]
    snap = json.loads(ranks[0]["snapshot"])
    eng = ContinuousBatchingEngine(_cfg(), params, paged=True,
                                   device="cpu", **BASE)
    restored = eng.restore(snap)
    _drain(eng)
    return {"ranks": ranks, "jax": jax_runs, "tp1": tp1, "tree": tree,
            "jcfg": jcfg, "jparams": jparams, "snap": snap,
            "port_restored": restored[0].output_ids,
            "jax_restored": _jax_runs(jcfg, jparams, snapshot=snap)}


# ---------------- the shards ----------------

@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_shard_serving_params_matches_reference(runs, quant):
    """Each rank's slice is the reference's device shard bit for bit:
    fp leaves split on their Megatron dim, weight-only leaves through the
    transposed layout (a row-parallel leaf's scales whole), the rest
    replicated."""
    import jax
    from jax.sharding import Mesh, NamedSharding

    from paddle_tpu.inference import quantize_layer_params as jquantize
    from paddle_tpu.models import llama as jllama

    jcfg, jparams = runs["jcfg"], runs["jparams"]
    if quant is not None:
        jparams = jquantize(jparams, quant)
    full = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    mesh = Mesh(np.asarray(jax.devices()[:TP]), ("tp",))
    specs = jllama.serving_param_specs(jcfg, quant=quant)
    sharded = jax.device_put(jparams, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    cfg = _cfg()
    for rank in range(TP):
        mine = tllama.shard_serving_params(cfg, full, rank, TP, quant)
        want = params_from_numpy(jax.tree_util.tree_map(
            lambda a: np.asarray(a.addressable_shards[rank].data), sharded),
            device="cpu")
        flat_mine = _flatten(mine)
        flat_want = _flatten(want)
        assert flat_mine.keys() == flat_want.keys()
        for k, t in flat_want.items():
            assert flat_mine[k].dtype == t.dtype, k
            assert torch.equal(flat_mine[k], t), (rank, k)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


def test_shard_serving_params_rejects_bad_splits():
    cfg = _cfg()
    params = tllama.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tllama.shard_serving_params(cfg, params, 2, 2)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        tllama.shard_serving_params(cfg, params, 0, 3)
    with pytest.raises(ValueError, match="quant='int8'"):
        tllama.shard_serving_params(cfg, params, 0, 2, "int8")


# ---------------- the ranks against the reference ----------------

def test_tp2_all_features_match_jax_and_tp1(runs):
    """The all-features stream at tp=2: the JAX tp=2 engine's tokens and
    counters, the port's tp=1 tokens, on both ranks; the pool closes on
    each rank."""
    want_tokens, want_counters = runs["jax"]["all"]
    assert runs["tp1"][None] == want_tokens
    for r, got in enumerate(runs["ranks"]):
        assert got["all"]["tp"] == TP and got["all"]["rank_of_engine"] == r
        assert got["all"]["tokens"] == want_tokens, r
        assert got["all"]["counters"] == want_counters, r
        assert got["all"]["pool_closes"], r
    assert want_counters["prefix_hits"] > 0
    assert want_counters["mixed_steps"] > 0
    assert want_counters["spec_steps"] > 0


@pytest.mark.parametrize("kv_quant", KV_QUANTS)
def test_tp2_quantized_pools_match_tp1(runs, kv_quant):
    """The all-features stream over int8 / int4 KV pools at tp=2 (each
    rank's pages and per-(page, kv head) scales hold its kv heads):
    the port's tp=1 engine's tokens on both ranks."""
    for got in runs["ranks"]:
        assert got["kv"][kv_quant] == runs["tp1"][kv_quant]


def test_tp2_ranks_agree_after_every_step(runs):
    """Replicated sampling needs the same all-reduced rows on every rank:
    after each step both ranks hold the same logits bit for bit and every
    request the same number of tokens."""
    a, b = (r["all"]["steps"] for r in runs["ranks"])
    assert len(a) == len(b) > 0
    scored = 0
    for i, (sa, sb) in enumerate(zip(a, b)):
        assert sa["tokens"] == sb["tokens"], i
        assert (sa["logits"] is None) == (sb["logits"] is None), i
        if sa["logits"] is not None:
            scored += 1
            assert torch.equal(sa["logits"], sb["logits"]), i
    assert scored > 10


def test_tp2_two_all_reduces_a_layer_a_forward(runs):
    """Each forward pays exactly the reference's two all-reduces a layer,
    on every step and in total."""
    L = _KW["layers"]
    for got in runs["ranks"]:
        steps = got["all"]["steps"]
        for i, st in enumerate(steps):
            assert st["all_reduce"] == 2 * L * st["forwards"], i
        total = sum(st["forwards"] for st in steps)
        assert total == (got["all"]["counters"]["decode_steps"])
        assert sum(st["all_reduce"] for st in steps) == 2 * L * total > 0


def test_tp2_deadline_expires_on_every_rank_at_once(runs):
    """Request 0's deadline passes on rank 1's clock alone, just before
    step ``EXPIRE_STEP``: both ranks expire it at that step (the overdue
    set is agreed), seat the queued request in its slot, hold the same
    logits bit for bit after every step, and emit the tp=1 engine's
    tokens with request 0 cancelled at that step."""
    a, b = (r["deadline"] for r in runs["ranks"])
    for got in (a, b):
        assert got["status"] == {0: "EXPIRED", 1: "FINISHED", 2: "FINISHED"}
        gone = next(i for i, st in enumerate(got["steps"])
                    if 0 not in st["tokens"])
        assert gone + 1 == EXPIRE_STEP
        assert 0 < len(got["tokens"][0]) < 8
    assert a["tokens"] == b["tokens"] == runs["tp1"]["deadline"]
    assert len(a["steps"]) == len(b["steps"])
    for i, (sa, sb) in enumerate(zip(a["steps"], b["steps"])):
        assert sa["tokens"] == sb["tokens"], i
        assert (sa["logits"] is None) == (sb["logits"] is None), i
        if sa["logits"] is not None:
            assert torch.equal(sa["logits"], sb["logits"]), i


def test_tp2_int8_weight_only_matches_jax(runs):
    """Weight-only int8 at tp=2 (quantized whole, then sliced; through an
    explicit process group) emits the JAX tp=2 engine's tokens."""
    for got in runs["ranks"]:
        assert got["int8"] == runs["jax"]["int8"]


def test_tp2_host_tier_matches_jax(runs):
    """The host tier at tp=2 under a budget that evicts: the JAX tp=2
    engine's tokens, ``tier_*`` and prefix statistics and tier counters,
    each rank's tier counting the whole page of its kv-head slice."""
    want_tokens, want_stats, want_tier = runs["jax"]["tier"]
    for got in runs["ranks"]:
        assert got["tier"]["tokens"] == want_tokens
        assert got["tier"]["stats"] == want_stats
        assert got["tier"]["tier"] == want_tier
    assert want_stats["tier_readmits"] > 0
    assert want_stats["tier_evictions"] > 0


def test_tp2_snapshot_restores_across_degree_and_packages(runs):
    """A snapshot at tp=2 records the degree; restored on the port's and
    on the JAX engine's tp=1 engine it completes the uninterrupted
    stream, which the ranks also served."""
    snap = runs["snap"]
    assert snap["engine"]["tp"] == TP
    want = runs["jax"]["snap_ref"]
    assert len(want) == 8
    assert runs["port_restored"] == want
    assert runs["jax_restored"] == want
    for got in runs["ranks"]:
        assert got["uninterrupted"] == want


def test_tp_validation_against_the_group(runs):
    """In a group of two: tensor_parallel=4 (a divisor of the kv heads)
    raises for the group's size; ``PADDLE_TPU_TP=2`` replaces the
    constructor's 1; ``PADDLE_TPU_TP=4`` warns (a degree other than the
    group's size) and serves on one rank."""
    for got in runs["ranks"]:
        assert "differs from the process group's size 2" in got["tp4_error"]
        assert got["env_tp2"] == 2
        assert got["env_tp4"] == 1
        assert any("differs from the process group's size 2" in w
                   for w in got["env_tp4_warnings"])


def test_ranks_import_no_jax(runs):
    for got in runs["ranks"]:
        assert got["forbidden"] == []


# ---------------- without any process ----------------

def _engine(**kw):
    params = tllama.init_params(_cfg(), device="cpu")
    return ContinuousBatchingEngine(_cfg(), params, paged=True, device="cpu",
                                    **{**BASE, **kw})


def test_ctor_validation_raises():
    """A bad constructor value raises, naming the kv heads' divisors; a
    degree above 1 without an initialized process group raises."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="degree 0 < 1"):
        _engine(tensor_parallel=0)
    with pytest.raises(ValueError, match=r"valid divisors: \[1, 2, 4\]"):
        _engine(tensor_parallel=3)
    with pytest.raises(ValueError, match="intermediate_size=128"):
        _engine(tensor_parallel=3)
    with pytest.raises(ValueError, match="initialized torch.distributed"):
        _engine(tensor_parallel=2)


def test_env_tp_override_and_warnings(monkeypatch):
    """``PADDLE_TPU_TP``: unset leaves the constructor's value; a value
    that is not an integer, does not divide the kv heads or the ffn width,
    or is not the group's size warns once naming the valid degrees and
    serves on one card."""
    assert envflags.env_tp(4, 2) is None
    for raw, msg in (("two", "not an integer"),
                     ("3", "does not divide kv_heads"),
                     ("0", "< 1"),
                     ("2", "needs an initialized torch.distributed")):
        envflags._warned.clear()
        monkeypatch.setenv("PADDLE_TPU_TP", raw)
        with pytest.warns(UserWarning, match=msg):
            assert _engine(tensor_parallel=2).tp == 1
    monkeypatch.setenv("PADDLE_TPU_TP", "16")
    envflags._warned.clear()
    with pytest.warns(UserWarning, match=r"valid degrees .*\[1, 8\]"):
        assert envflags.env_tp(kv_heads=16, device_count=8) == 1
    monkeypatch.setenv("PADDLE_TPU_TP", "4")
    with pytest.warns(UserWarning, match="intermediate_size=6"):
        assert envflags.env_tp(8, 4, intermediate_size=6) == 1
    monkeypatch.setenv("PADDLE_TPU_TP", "4")
    assert envflags.env_tp(kv_heads=8, device_count=4) == 4
    assert "PADDLE_TPU_TP" in envflags.__doc__


def test_tp1_runs_no_collective(monkeypatch):
    """tp=1 builds the single-card engine: no group, no view, and a serve
    that reaches no collective."""
    def refuse(*a, **k):
        raise AssertionError("a tp=1 engine ran a collective")

    monkeypatch.setattr(dist, "all_reduce", refuse)
    before = tllama.TP_COUNTERS["all_reduce"]
    eng = _engine(**ALL_ON)
    assert eng.tp == 1 and eng._tp_group is None and eng._body_cfg is eng.cfg
    out = eng.serve(_mixed_requests(Request))
    assert all(len(v) > 0 for v in out.values())
    assert tllama.TP_COUNTERS["all_reduce"] == before
    assert eng.snapshot()["engine"]["tp"] == 1


def test_rank_params_takes_the_full_tree_or_a_rank_slice():
    """What a rank's engine accepts as ``params``: the full tree only,
    sliced (quantized whole first under ``quant``); a tree already shaped
    as a rank's slice raises."""
    cfg = _cfg()
    full = tllama.init_params(cfg, device="cpu")
    rank = types.SimpleNamespace(tp=TP, _tp_rank=1,
                                 device=torch.device("cpu"))
    take = ContinuousBatchingEngine._rank_params
    want = tllama.shard_serving_params(cfg, full, 1, TP)
    got = take(rank, cfg, full, None)
    for k, t in _flatten(want).items():
        assert torch.equal(_flatten(got)[k], t), k
    q8 = take(rank, cfg, full, "int8")["layers"]["wo"]
    assert q8["qweight"].shape == (2, 64, 64 // TP)
    assert q8["scale"].shape == (2, 64)
    for quant in (None, "int8"):
        with pytest.raises(ValueError, match="must be the full tree"):
            take(rank, cfg, want, quant)


def test_audit_i1_rank_pools_keep_pages_and_their_heads():
    """I1 under tensor parallelism: a rank's pools keep every page and
    nkv/tp kv heads; a pool holding all the heads at tp=2 is caught."""
    eng = _engine(num_blocks=8)
    audit_engine(eng)
    eng.tp = TP              # a rank whose pools were built unsharded
    with pytest.raises(EngineAuditError, match="I1.*2 of the 4 kv heads"):
        audit_engine(eng)
    eng = _engine(num_blocks=8, kv_quant="int8")
    eng.tp = TP
    with pytest.raises(EngineAuditError, match="cache_k.q"):
        audit_engine(eng)


def test_tier_entry_counts_whole_page():
    """A rank's tier entry holds its kv-head slice and counts the whole
    page: ``shards`` times its own bytes."""
    k = torch.randn(2, 2, 8, 8)
    tier = HostKVTier(budget_bytes=1 << 20)
    e = tier.ship_out("h", k, k.clone(), shards=TP)
    assert e.nbytes == TP * 2 * k.numel() * 4 == tier.used_bytes
