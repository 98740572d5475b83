"""The port's fleet router and engine auditor against the reference on the
CPU.

Same f32 tiny Llama as ``tests/test_fleet.py`` (vocab 128, hidden 32, 2
layers, 4 heads; ``max_batch`` 2, ``max_seq`` 64, block 8), the JAX
parameter tree bridged through ``paddle_tpu_torch.utils.convert``, the
same request streams (made with numpy from a seed).  One module fixture
runs each shared scenario once on a JAX ``FleetRouter`` (through its plain
references, ``PADDLE_TPU_DISABLE_PALLAS=paged_attention``): the
single-engine parity, the hot-prefix affinity, the overload spill,
failover mid-decode and mid-prefill-chunk (the latter with
``PADDLE_TPU_ASYNC_HOST`` on and off), the hedge and the shared host
tier.  The port's router runs the same scenario with the auditor on, and
after every fleet step its replicas' health, owners, hedges, each
replica's ``journal()`` and the router's own journal cache equal the JAX
router's; at the end the tokens (greedy and seeded), statuses and every
``FLEET_STAT_SCHEMA`` counter are equal.

The reference's other contracts run on the port alone: backpressure and
its accounting, the invalid request, replay exempt from backpressure, the
fleet lost, a permanent stall declared DEAD, degrade and heal, draining,
the drain of a dead replica, ``stall_dead_steps`` validation, graceful
mode required, cancel of every copy, the mixed-plan partition, a replica
clause refused without a fleet; the six I9 violations of
``tests/test_fleet.py``; one corrupted state per engine invariant (I1-I8,
I10), each raising ``EngineAuditError`` that names it; an audited serve
with every feature and a chaos plan on, equal to the audit-off serve.

The reference's ``test_failover_token_identity_mid_prefill_chunk`` reads
the router's journal cache right after two steps, which the async host
runtime (on by default) fills only at a death or hedge boundary; the
port's router does the same (its cache is None there), so this file reads
the victim's prefill cursor from the replica's own ``journal()``, and
compares the cache itself in the async-off run.
"""

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.fleet import FleetRouter as JFleet
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.analysis.engine_audit import (EngineAuditError,
                                                    audit_engine,
                                                    audit_fleet)
from paddle_tpu_torch.inference.faults import FaultPlan
from paddle_tpu_torch.inference.fleet import FleetRouter
from paddle_tpu_torch.inference.observability import FLEET_STAT_SCHEMA
from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                Request)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import envflags
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

_KW = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64)
#: plain replicas
PLAIN = dict(max_batch=2, max_seq=64, chunk=1, block_size=8)
#: every serving feature on
FULL = dict(max_batch=2, max_seq=64, chunk=1, block_size=8,
            enable_prefix_caching=True, enable_speculation=True,
            num_draft_tokens=3, enable_chunked_prefill=True,
            prefill_chunk=8, num_blocks=16)
#: one request at a time over an 8-page pool, chunked, the tier shared
TIER = dict(max_batch=1, max_seq=64, chunk=1, block_size=8, num_blocks=8,
            enable_prefix_caching=True, enable_chunked_prefill=True,
            prefill_chunk=5, enable_host_kv_tier=True)
SHARED = np.random.RandomState(5).randint(0, 128, (8,)).astype(np.int32)
HEDGE_SHARED = np.random.RandomState(9).randint(0, 128, (8,)) \
    .astype(np.int32)


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


@contextlib.contextmanager
def _env(**kv):
    """Set the given variables (None: unset) for the block."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mixed_batch(cls, seed, n=3, prompt_len=11, new=6, shared=None):
    """Half greedy, half seeded top-p; with ``shared`` the prompts extend
    one self-similar base (prefix-cache hits and n-gram drafts)."""
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        if shared is not None:
            p = np.tile(shared, 4)[:prompt_len + i].astype(np.int32)
        else:
            p = rs.randint(0, 128, (prompt_len + i,)).astype(np.int32)
        kw = dict(temperature=0.8, top_p=0.9, seed=7 + i) if i % 2 else {}
        reqs.append(cls(rid=i, prompt_ids=p, max_new_tokens=new, **kw))
    return reqs


def _norm(d):
    """A journal with ``deadline_remaining_s`` blanked (each side computes
    it when read)."""
    if d is None:
        return None
    return {**d, **{k: [dict(e, deadline_remaining_s=None) for e in d[k]]
                    for k in ("running", "queued")}}


def _state(fleet) -> dict:
    """What the two routers must agree on after every fleet step."""
    return {"health": list(fleet.health), "owner": dict(fleet._owner),
            "hedge": dict(fleet._hedge),
            "journals": [None if e is None else _norm(e.journal())
                         for e in fleet.replicas],
            "cache": [_norm(j) for j in fleet._journal]}


def _run_all(fleet, reqs, tick):
    for r in reqs:
        fleet.add_request(r)
    tick()
    while fleet.step():
        tick()


# ---------------- the shared scenarios ----------------

def _parity(fleet, R, tick):
    reqs = _mixed_batch(R, 0)
    _run_all(fleet, reqs, tick)
    return reqs


def _affinity(fleet, R, tick):
    """A prompt whose chain replica 0 holds routes there although replica
    1 is less loaded."""
    rs = np.random.RandomState(1)
    prefix = rs.randint(0, 128, (17,)).astype(np.int32)   # 2 full blocks
    warm = R(rid=0, prompt_ids=prefix, max_new_tokens=2)
    _run_all(fleet, [warm], tick)
    filler = R(rid=1, prompt_ids=rs.randint(0, 128, (9,)).astype(np.int32),
               max_new_tokens=30)
    hot = R(rid=2, prompt_ids=np.concatenate(
        [prefix, rs.randint(0, 128, (6,)).astype(np.int32)]),
        max_new_tokens=3)
    _run_all(fleet, [filler, hot], tick)
    return [warm, filler, hot]


def _spill(fleet, R, tick):
    """The chain holder's queue is full: the hot request spills."""
    rs = np.random.RandomState(2)
    prefix = rs.randint(0, 128, (17,)).astype(np.int32)
    warm = R(rid=0, prompt_ids=prefix, max_new_tokens=2)
    _run_all(fleet, [warm], tick)
    reqs = [warm]
    for rid in (1, 2):
        reqs.append(R(rid=rid, prompt_ids=rs.randint(0, 128, (9,))
                      .astype(np.int32), max_new_tokens=30))
        fleet.add_request(reqs[-1])
        fleet.step()
        tick()
    reqs.append(R(rid=3, prompt_ids=rs.randint(0, 128, (9,))
                  .astype(np.int32), max_new_tokens=30))
    reqs.append(R(rid=4, prompt_ids=np.concatenate(
        [prefix, rs.randint(0, 128, (6,)).astype(np.int32)]),
        max_new_tokens=2))
    _run_all(fleet, reqs[3:], tick)
    return reqs


def _mid_decode(fleet, R, tick):
    reqs = _mixed_batch(R, 5, prompt_len=17, new=8, shared=SHARED)
    _run_all(fleet, reqs, tick)
    return reqs


def _mid_prefill(fleet, R, tick):
    """A 40-token prompt mid-chunked-prefill on the victim at the crash."""
    rs = np.random.RandomState(6)
    reqs = [R(rid=0, prompt_ids=rs.randint(0, 128, (40,)).astype(np.int32),
              max_new_tokens=6, temperature=0.6, seed=3),
            R(rid=1, prompt_ids=rs.randint(0, 128, (9,)).astype(np.int32),
              max_new_tokens=6)]
    _run_all(fleet, reqs, tick)
    return reqs


def _hedge(fleet, R, tick):
    reqs = _mixed_batch(R, 9, n=2, prompt_len=17, new=8, shared=HEDGE_SHARED)
    _run_all(fleet, reqs, tick)
    return reqs


def _shared_tier(fleet, R, tick):
    """Replica 0 computes and demotes a chain; drained, it leaves the
    revisit to replica 1, which re-admits the chain from the shared
    tier."""
    rs = np.random.RandomState(5)
    P = rs.randint(0, 128, (30,)).astype(np.int32)
    reqs = [R(rid=0, prompt_ids=P, max_new_tokens=4)]
    _run_all(fleet, reqs[-1:], tick)
    for i in range(3):          # pressure demotes P's chain to the tier
        reqs.append(R(rid=100 + i, prompt_ids=rs.randint(0, 128, (40,))
                      .astype(np.int32), max_new_tokens=4))
        _run_all(fleet, reqs[-1:], tick)
    fleet.drain(0)
    reqs.append(R(rid=1, prompt_ids=P, max_new_tokens=4))
    _run_all(fleet, reqs[-1:], tick)
    return reqs


#: name -> (script, engine kw, router kw, env)
SCENARIOS = {
    "parity": (_parity, PLAIN, {}, {}),
    "affinity": (_affinity, dict(PLAIN, enable_prefix_caching=True), {}, {}),
    "spill": (_spill, dict(PLAIN, max_batch=1, max_queue=1,
                           enable_prefix_caching=True), {}, {}),
    "mid_decode": (_mid_decode, FULL, {},
                   {"PADDLE_TPU_FAULT_INJECT":
                    "replica_crash@step=7,replica=0"}),
    "mid_prefill": (_mid_prefill, FULL, {},
                    {"PADDLE_TPU_FAULT_INJECT":
                     "replica_crash@step=3,replica=0"}),
    "mid_prefill_sync": (_mid_prefill, FULL, {},
                         {"PADDLE_TPU_FAULT_INJECT":
                          "replica_crash@step=3,replica=0",
                          "PADDLE_TPU_ASYNC_HOST": "0"}),
    "hedge": (_hedge, FULL, {"stall_steps": 3},
              {"PADDLE_TPU_FAULT_INJECT": "replica_stall@replica=0,count=8"}),
    "shared_tier": (_shared_tier, TIER, {}, {}),
}


def _drive(Fleet, R, cfg, params, name, **extra_env):
    """Run one scenario; returns (router, requests, the state after every
    fleet step)."""
    script, ekw, fkw, env = SCENARIOS[name]
    states = []
    with _env(**env, **extra_env):
        fleet = Fleet(cfg, params, n_replicas=2, **fkw, **ekw,
                      **({"paged": True} if Fleet is JFleet
                         else {"device": "cpu"}))
        reqs = script(fleet, R, lambda: states.append(_state(fleet)))
    return fleet, reqs, states


def _summary(fleet, reqs) -> dict:
    tier = fleet.host_tier
    return {"tokens": {r.rid: list(r.output_ids) for r in reqs},
            "status": {r.rid: r.status for r in reqs},
            "stats": {k: fleet.stats[k] for k in FLEET_STAT_SCHEMA},
            "tier": None if tier is None else tier.stats()}


@pytest.fixture(scope="module")
def jax_runs(models):
    """Each shared scenario once on the JAX router: its state after every
    fleet step and its summary at the end."""
    jcfg, jparams = models[:2]
    out = {}
    for name in SCENARIOS:
        fleet, reqs, states = _drive(
            JFleet, JRequest, jcfg, jparams, name,
            PADDLE_TPU_DISABLE_PALLAS="paged_attention")
        out[name] = (states, _summary(fleet, reqs))
    return out


@pytest.fixture(scope="module")
def port_runs(models):
    """The same scenarios on the port's router, audited after every step
    (each replica's I1-I8 and I10, the router's I9 and the journal's
    equivalence to ``snapshot()``)."""
    tcfg, tparams = models[2:]
    out = {}
    for name in SCENARIOS:
        fleet, reqs, states = _drive(FleetRouter, Request, tcfg, tparams,
                                     name, PADDLE_TPU_ENGINE_AUDIT="1")
        out[name] = (fleet, reqs, states)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fleet_matches_jax_router_every_step(name, jax_runs, port_runs):
    """Health, owners, hedges, every replica's journal and the router's
    journal cache after every fleet step; tokens, statuses, the fleet
    counters and the shared tier's counters at the end."""
    jstates, jsum = jax_runs[name]
    fleet, reqs, states = port_runs[name]
    assert len(states) == len(jstates)
    for i, (mine, theirs) in enumerate(zip(states, jstates)):
        assert mine == theirs, f"{name}: fleet step {i}"
    assert _summary(fleet, reqs) == jsum
    assert all(r.status == "FINISHED" for r in reqs)
    for eng in fleet.replicas:
        if eng is not None:
            audit_engine(eng)
    audit_fleet(fleet)


def test_fleet_parity_with_single_engine(models, port_runs):
    """A fault-free fleet emits the single engine's streams, every
    request has a fleet TTFT, and the live registries prune."""
    fleet, reqs, _ = port_runs["parity"]
    eng = ContinuousBatchingEngine(*models[2:], device="cpu", **PLAIN)
    assert eng.serve(_mixed_batch(Request, 0)) == {
        r.rid: r.output_ids for r in reqs}
    assert all(r.ttft_s is not None for r in reqs)
    assert fleet.stats["routed_spill"] == len(reqs)
    assert fleet._reqs == {} and fleet._owner == {} and fleet._copies == {}


def test_routing_affinity_and_spill(port_runs):
    """Affinity: the hot request joins the chain holder although the other
    replica is idle.  Spill: with the holder's queue full it goes to the
    other replica."""
    _, _, states = port_runs["affinity"]
    owners = [s["owner"] for s in states if 2 in s["owner"]]
    assert owners and owners[0] == {1: 0, 2: 0}
    assert port_runs["affinity"][0].stats["routed_affinity"] == 1
    fleet, _, states = port_runs["spill"]
    first = next(s["owner"] for s in states if 4 in s["owner"])
    assert first[1] == 0 and first[2] == 1 and first[3] == 0
    assert first[4] == 1
    assert fleet.stats["routed_spill"] == 5


def test_failover_mid_decode_replays(port_runs):
    fleet, reqs, _ = port_runs["mid_decode"]
    assert fleet.stats["failovers"] == 1 and fleet.stats["replayed_tokens"] > 0
    assert fleet.health[0] == "DEAD" and fleet.replicas[0] is None
    assert all(len(r.output_ids) == 8 for r in reqs)


@pytest.mark.parametrize("name", ["mid_prefill", "mid_prefill_sync"])
def test_failover_mid_prefill_chunk(name, port_runs):
    """At the crash step the victim was mid-prefill: its own journal held
    the cursor.  Async on, the router's cache stayed None until the death
    pulled it; off, the per-step snapshot() filled it."""
    fleet, reqs, states = port_runs[name]
    before = states[2]           # after add + two fleet steps
    run = before["journals"][0]["running"]
    assert run and run[0]["rid"] == 0 and 0 < run[0]["prefilled"] < 40
    if name == "mid_prefill":
        assert before["cache"][0] is None
    else:
        assert before["cache"][0]["running"][0]["prefilled"] \
            == run[0]["prefilled"]
        assert fleet.stats["journal_full_rebuilds"] > 0
    assert fleet.stats["failovers"] == 1
    assert all(r.status == "FINISHED" for r in reqs)


def test_hedge_discards_late_answer(port_runs):
    fleet, reqs, _ = port_runs["hedge"]
    assert fleet.stats["hedges"] >= 1
    assert all(len(r.output_ids) == 8 for r in reqs)
    assert fleet.replicas[0]._reqs == {}
    assert fleet._hedge == {} and fleet._reqs == {}


def test_shared_tier_cross_readmit(port_runs):
    fleet, reqs, _ = port_runs["shared_tier"]
    assert reqs[-1].output_ids == reqs[0].output_ids
    assert fleet.host_tier.demotions > 0
    assert fleet.host_tier.cross_readmits > 0
    assert fleet.replicas[1].stats["tier_readmits"] > 0
    assert all(e._tier is fleet.host_tier for e in fleet.replicas)


# ---------------- the reference's other contracts, on the port ----------

def _fleet(models, spec=None, n_replicas=2, **kw):
    with _env(PADDLE_TPU_FAULT_INJECT=spec, PADDLE_TPU_ENGINE_AUDIT="1"):
        return FleetRouter(*models[2:], n_replicas=n_replicas, device="cpu",
                           **kw)


def _req(rs, rid, n=9, new=6, **kw):
    return Request(rid=rid, prompt_ids=rs.randint(0, 128, (n,))
                   .astype(np.int32), max_new_tokens=new, **kw)


def _audit_survivors(fleet):
    for eng in fleet.replicas:
        if eng is not None:
            audit_engine(eng)
    audit_fleet(fleet)


def test_backpressure_rejected_accounting(models):
    fleet = _fleet(models, **dict(PLAIN, max_batch=1, max_queue=1))
    rs = np.random.RandomState(3)
    reqs = [_req(rs, i, new=3) for i in range(6)]
    got = fleet.serve(reqs)
    shed = [r for r in reqs if r.status == "REJECTED"]
    assert len(shed) == 4 and all("queue is full" in r.error for r in shed)
    assert fleet.stats["fleet_rejected"] == 4
    served = [r for r in reqs if r.status == "FINISHED"]
    assert len(served) == 2 and all(len(got[r.rid]) == 3 for r in served)
    _audit_survivors(fleet)


def test_invalid_request_rejected_not_raised(models):
    fleet = _fleet(models, **PLAIN)
    rs = np.random.RandomState(4)
    good = _req(rs, 0, new=3)
    bad = _req(rs, 1, temperature=float("nan"))
    got = fleet.serve([good, bad])
    assert good.status == "FINISHED" and len(got[0]) == 3
    assert bad.status == "REJECTED" and "finite" in bad.error


def test_failover_replay_exempt_from_backpressure(models):
    fleet = _fleet(models, "replica_crash@step=4,replica=0",
                   **dict(PLAIN, max_batch=1, max_queue=1))
    rs = np.random.RandomState(7)
    reqs = [_req(rs, i) for i in range(3)]
    fleet.add_request(reqs[0])
    fleet.add_request(reqs[1])
    fleet.step()
    fleet.add_request(reqs[2])
    assert fleet._owner[2] == 0
    while fleet.step():
        pass
    assert fleet.stats["failovers"] == 1
    assert all(r.status == "FINISHED" and len(r.output_ids) == 6
               for r in reqs)
    _audit_survivors(fleet)


def test_fleet_lost_fails_accepted_work(models):
    fleet = _fleet(models, "replica_crash@replica=0;replica_crash@replica=1",
                   **PLAIN)
    rs = np.random.RandomState(8)
    req = _req(rs, 0)
    fleet.serve([req])
    assert req.status == "FAILED" and "no surviving replica" in req.error
    late = _req(rs, 1, new=2)
    fleet.add_request(late)
    assert late.status == "REJECTED" and "DEAD" in late.error
    assert fleet.stats["fleet_rejected"] == 1


def test_permanent_stall_escalates_to_dead(models):
    fleet = _fleet(models, "replica_stall@replica=0,count=-1", n_replicas=1,
                   stall_steps=2, stall_dead_steps=5, **PLAIN)
    req = _req(np.random.RandomState(15), 0)
    fleet.serve([req])
    assert fleet.health[0] == "DEAD" and fleet.stats["failovers"] == 1
    assert req.status == "FAILED" and "no surviving replica" in req.error
    assert "stalled for" in req.error


def test_stall_dead_steps_must_exceed_stall_steps(models):
    with pytest.raises(ValueError, match="stall_dead_steps"):
        _fleet(models, n_replicas=1, stall_steps=5, stall_dead_steps=5,
               **PLAIN)


def test_stall_degrades_then_heals(models):
    fleet = _fleet(models, "replica_slow@replica=0,count=3", slow_after=2,
                   heal_after=2, **PLAIN)
    req = _req(np.random.RandomState(10), 0, new=20)
    fleet.add_request(req)
    seen = set()
    while fleet.step():
        seen.add(fleet.health[0])
    assert "DEGRADED" in seen and fleet.health[0] == "HEALTHY"
    assert req.status == "FINISHED"
    _audit_survivors(fleet)


def test_draining(models):
    """In-flight work on a draining replica finishes where it is, new work
    goes elsewhere; a fully drained fleet's rejection names the drain; a
    dead replica cannot be drained."""
    fleet = _fleet(models, **PLAIN)
    rs = np.random.RandomState(11)
    inflight = _req(rs, 0, new=12)
    fleet.add_request(inflight)
    assert fleet._owner[0] == 0
    fleet.step()
    fleet.drain(0)
    newcomers = [_req(rs, 1 + i, new=4) for i in range(3)]
    for r in newcomers:
        fleet.add_request(r)
    assert all(fleet._owner[r.rid] == 1 for r in newcomers)
    while fleet.step():
        pass
    assert inflight.status == "FINISHED" and len(inflight.output_ids) == 12
    assert all(r.status == "FINISHED" for r in newcomers)
    assert fleet.health[0] == "DRAINING"
    _audit_survivors(fleet)
    fleet.drain(1)
    late = _req(rs, 9, new=2)
    fleet.add_request(late)
    assert late.status == "REJECTED"
    assert "DRAINING" in late.error and "queue is full" not in late.error
    dead = _fleet(models, "replica_crash@step=1,replica=0", **PLAIN)
    dead.step()
    with pytest.raises(ValueError, match="DEAD"):
        dead.drain(0)


def test_fleet_requires_graceful(models):
    with _env(PADDLE_TPU_GRACEFUL="0"):
        with pytest.raises(RuntimeError, match="GRACEFUL"):
            _fleet(models, **PLAIN)


def test_fleet_cancel_cancels_every_copy(models):
    """A cancel reaches the owner's copy and a pending hedge's."""
    fleet = _fleet(models, **PLAIN)
    req = _req(np.random.RandomState(14), 0, new=50)
    fleet.add_request(req)
    for _ in range(3):
        fleet.step()
    # a hedge twin on replica 1, as _detect_stalls would place it
    fleet._journal_pull(0)
    fleet._hedge[0] = fleet._replay(0, fleet._journal_entry(0, 0),
                                    exclude={0}, source=0, link="hedge")
    assert fleet._hedge[0] == 1 and set(fleet._copies[0]) == {0, 1}
    copies = dict(fleet._copies[0])
    assert fleet.cancel(0) is True
    assert req.status == "CANCELLED" and len(req.output_ids) > 0
    assert all(c.status == "CANCELLED" for c in copies.values())
    assert fleet.cancel(0) is False and fleet.cancel(99) is False
    assert fleet.step() is False
    _audit_survivors(fleet)


def test_fleet_partitions_mixed_spec(models):
    fleet = _fleet(models, "replica_crash@step=99,replica=0;"
                           "slot_error@rid=1,step=2,replica=1;"
                           "cache_error@step=5", **PLAIN)
    assert [c.kind for c in fleet._faults._clauses] == ["replica_crash"]
    assert [c.kind for c in fleet.replicas[0]._faults._clauses] \
        == ["cache_error"]
    assert [c.kind for c in fleet.replicas[1]._faults._clauses] \
        == ["slot_error", "cache_error"]
    assert all(c.replica is None for c in fleet.replicas[1]._faults._clauses)
    plan = fleet._faults
    assert not plan.fire("replica_crash", step=99, replica=1)
    assert plan.fire("replica_crash", step=99, replica=0)


def test_replica_clause_requires_fleet(models, monkeypatch):
    """Without a fleet the engine's parse refuses a replica-scoped kind or
    key with a warning naming the FleetRouter, injection off, and the
    engine serves normally; the router's parse takes the same spec."""
    for raw in ("replica_crash@step=2,replica=0;alloc_fail@step=3",
                "alloc_fail@replica=1"):
        monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT", raw)
        envflags._warned.clear()
        with pytest.warns(UserWarning, match="FleetRouter"):
            assert not FaultPlan.from_env()
    monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT",
                       "replica_crash@step=2,replica=0;alloc_fail@step=3")
    envflags._warned.clear()
    with pytest.warns(UserWarning, match="FleetRouter"):
        eng = ContinuousBatchingEngine(*models[2:], device="cpu", **PLAIN)
    assert not eng._faults
    req = _req(np.random.RandomState(13), 0, new=3)
    assert len(eng.serve([req])[0]) == 3 and req.status == "FINISHED"
    monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT",
                       "replica_stall@replica=1,count=4,p=0.5,seed=3")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert FaultPlan.from_env(fleet=True)


# ---------------- I9: fleet single ownership ----------------

def _live_fleet(models):
    fleet = _fleet(models, **PLAIN)
    rs = np.random.RandomState(12)
    for i in range(2):
        fleet.add_request(_req(rs, i, new=20))
    fleet.step()
    audit_fleet(fleet)
    return fleet


def _orphan(f):
    del f._owner[0]


def _double_owner(f):
    other = 1 - f._owner[0]
    copy = f.replicas[other].adopt(f._journal_entry(f._owner[0], 0))
    f._copies[0][other] = copy


def _untracked(f):
    del f._copies[0][f._owner[0]]


def _zombie(f):
    f._reqs[0].status = "FAILED"


def _self_hedge(f):
    f._hedge[0] = f._owner[0]


def _leaked_copy(f):
    stale = f._copies[0][f._owner[0]]
    f.cancel(0)
    audit_fleet(f)
    f._copies[0] = {0: stale}


@pytest.mark.parametrize("corrupt", [_orphan, _double_owner, _untracked,
                                     _zombie, _self_hedge, _leaked_copy],
                         ids=lambda f: f.__name__.strip("_"))
def test_audit_i9_violations(models, corrupt):
    fleet = _live_fleet(models)
    corrupt(fleet)
    with pytest.raises(EngineAuditError, match="I9"):
        audit_fleet(fleet)


# ---------------- I1-I8, I10: one corrupted engine state each ----------

def _busy_engine(models):
    """An audited engine with every feature and the tier on, stepped until
    one slot is mid-prefill with blocks cached and the other decoding."""
    with _env(PADDLE_TPU_ENGINE_AUDIT="1"):
        eng = ContinuousBatchingEngine(*models[2:], device="cpu",
                                       **dict(FULL, enable_host_kv_tier=True))
    rs = np.random.RandomState(21)
    eng.add_request(Request(rid=0, prompt_ids=np.tile(SHARED, 2),
                            max_new_tokens=20))
    for _ in range(3):
        eng.step()
    eng.add_request(Request(rid=1, prompt_ids=np.concatenate(
        [np.tile(SHARED, 2), rs.randint(0, 128, (30,)).astype(np.int32)]),
        max_new_tokens=20))
    eng.step()
    assert eng._prefill_ids[1] is not None and eng._prefill_ids[0] is None
    assert eng._slot_shared[1] and eng._slot_blocks[0]
    audit_engine(eng)
    return eng


def _i1(e):
    e._free.append(e._free[0])


def _i2(e):
    e._table[0, 0] = (e._table[0, 0] + 1) % e.num_blocks


def _i3(e):
    e._pcache._by_hash[e._slot_shared[1][0]].refcount += 1


def _i4(e):
    e._slot_blocks[0].append(e._pcache.resident_pages()[0])


def _i5(e):
    e._pcache._by_hash[e._slot_shared[1][0]].children += 1


def _i6(e):
    e._pos[0] = int(e._written[0]) + 2


def _i7(e):
    e._prefilled[1] = 99


def _i8(e):
    e._slot_req[0].status = "FAILED"


def _i10(e):
    e._tier.ship_out("f" * 64, torch.zeros(2, 2, 8, 8),
                     torch.zeros(2, 2, 8, 8))
    e._tier.used_bytes += 1


@pytest.mark.parametrize("inv, corrupt", [
    ("I1", _i1), ("I2", _i2), ("I3", _i3), ("I4", _i4), ("I5", _i5),
    ("I6", _i6), ("I7", _i7), ("I8", _i8), ("I10", _i10)],
    ids=lambda x: x if isinstance(x, str) else "")
def test_audit_engine_violation_named(models, inv, corrupt):
    eng = _busy_engine(models)
    corrupt(eng)
    with pytest.raises(EngineAuditError, match=rf"{inv} violated"):
        audit_engine(eng)


def test_audit_flag(monkeypatch):
    """``PADDLE_TPU_ENGINE_AUDIT`` is registered off by default, and a
    value other than 0 or 1 warns once and keeps it off."""
    from paddle_tpu_torch.analysis.engine_audit import audit_enabled

    assert envflags.BOOL_FLAGS["PADDLE_TPU_ENGINE_AUDIT"] is False
    monkeypatch.delenv("PADDLE_TPU_ENGINE_AUDIT", raising=False)
    assert audit_enabled() is False
    monkeypatch.setenv("PADDLE_TPU_ENGINE_AUDIT", "1")
    assert audit_enabled() is True
    monkeypatch.setenv("PADDLE_TPU_ENGINE_AUDIT", "yes")
    envflags._warned.clear()
    with pytest.warns(UserWarning, match="PADDLE_TPU_ENGINE_AUDIT"):
        assert audit_enabled() is False


def test_audit_runs_after_each_step_and_dumps(models):
    """The engine audits inside step(): a corrupt mixed-step packing
    raises out of the next step, with an ``engine_audit_error`` dump."""
    eng = _busy_engine(models)
    eng._last_pack = ((1,), (1,))
    dumps = []
    eng._flight.dump = lambda reason, extra=None: dumps.append(reason)
    with pytest.raises(EngineAuditError, match="I7"):
        eng.step()
    assert dumps == ["engine_audit_error"]


def test_audited_chaos_serve_equals_unaudited(models):
    """Every feature, the shared tier and a chaos plan on (a replica crash
    and one clause of each engine kind): the audited fleet runs clean and
    emits the audit-off fleet's tokens and statuses.  Off, no replica
    audits."""
    plan = ("replica_crash@step=9,replica=1;cache_error@step=1;"
            "alloc_fail@step=2;kernel_error@step=3;slot_error@rid=2")
    runs = []
    for audit in ("1", "0"):
        with _env(PADDLE_TPU_FAULT_INJECT=plan,
                  PADDLE_TPU_ENGINE_AUDIT=audit):
            fleet = FleetRouter(*models[2:], device="cpu",
                                **dict(FULL, enable_host_kv_tier=True))
        assert all(e._audit_every_step == (audit == "1")
                   for e in fleet.replicas)
        reqs = _mixed_batch(Request, 5, n=4, prompt_len=17, new=8,
                            shared=SHARED)
        fleet.serve(reqs)
        assert fleet.stats["failovers"] == 1
        runs.append(({r.rid: r.output_ids for r in reqs},
                     {r.rid: r.status for r in reqs}))
    assert runs[0] == runs[1]
    assert list(runs[0][1].values()).count("FAILED") == 1
