"""The port's fault tolerance against the JAX engine on the CPU.

The engine cases of ``tests/test_fault_tolerance.py`` (not the host KV tier,
the engine audit or the fleet), each run by both packages on the same f32
tiny Llama (the JAX tree bridged through ``utils/convert.py``) under the
same ``PADDLE_TPU_FAULT_INJECT``: statuses, errors, tokens and the ladder's
statistics equal the JAX engine's (run through its plain references,
``PADDLE_TPU_DISABLE_PALLAS=paged_attention``).  Every serve carries
greedy and seeded top-p requests.

- each chaos kind (``alloc_fail``, ``kernel_error``, ``nan_logits``,
  ``slot_error``, ``cache_error``, and ``nan_logits`` on the chunked and
  speculative steps): only the victim fails, and every other stream is a
  victim-free serve's;
- graceful off: each kind raises (``nan_logits`` is inert there);
- the overload ladder's rungs 1-5;
- deadlines, ``cancel``, ``max_queue``, invalid requests REJECTED;
- ``snapshot`` / ``restore`` token-identical mid-decode and mid-chunked
  prefill, the remaining deadline re-armed, an unknown version and a
  topology mismatch refused, and a JSON snapshot of either package
  restored on the other;
- an exception a kernel wrapper raises is never retried;
- the fault-spec grammar.
"""

import dataclasses
import json
import time
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference import faults as tfaults
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.faults import FaultInjected, FaultPlan
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.utils import envflags
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TRequest = tserving.Request
TERMINAL = tserving.TERMINAL_STATUSES
ENGINE = dict(max_batch=2, max_seq=64, chunk=1, block_size=8)
STATS = ("requests_failed", "requests_rejected", "requests_cancelled",
         "requests_expired", "degrade_evict", "degrade_spec_off",
         "degrade_budget_shrink", "degrade_preempt", "nan_guard_trips",
         "kernel_error_retries", "preemptions", "prefix_hits",
         "prefix_evictions", "decode_steps", "decode_tokens", "mixed_steps",
         "spec_steps")


@pytest.fixture(scope="module")
def models():
    """The reference tests' tiny model (vocab 128, h 32, 2 layers)."""
    kw = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64)
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(**kw),
                               dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(**kw),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return {"jax": (jcfg, jparams), "port": (tcfg, tparams)}


def _engine(models, side, **kw):
    cfg, params = models[side]
    if side == "jax":
        return JEngine(cfg, params, paged=True, **{**ENGINE, **kw})
    return tserving.ContinuousBatchingEngine(cfg, params, paged=True,
                                             device="cpu",
                                             **{**ENGINE, **kw})


class _Env:
    """The chaos environment of one run: the fault plan, graceful or not,
    and the JAX engine on its plain references (read while it serves)."""

    def __init__(self, spec=None, graceful=True):
        self.mp = pytest.MonkeyPatch()
        self.mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
        if spec:
            self.mp.setenv("PADDLE_TPU_FAULT_INJECT", spec)
        else:
            self.mp.delenv("PADDLE_TPU_FAULT_INJECT", raising=False)
        self.mp.setenv("PADDLE_TPU_GRACEFUL", "1" if graceful else "0")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _mixed_batch(cls, seed, n=4, prompt_len=11, new=6):
    """Half greedy, half seeded temperature + top-p."""
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        p = rs.randint(0, 128, (prompt_len + i,)).astype(np.int32)
        kw = (dict(temperature=0.8, top_p=0.9, seed=7 + i) if i % 2 else {})
        reqs.append(cls(rid=i, prompt_ids=p, max_new_tokens=new, **kw))
    return reqs


def _serve_both(models, build, spec=None, graceful=True, **kw):
    """Both engines on ``build(cls)`` under one environment: side ->
    (engine, requests, tokens)."""
    out = {}
    with _Env(spec, graceful):
        for side, cls in (("jax", JRequest), ("port", TRequest)):
            eng = _engine(models, side, **kw)
            reqs = build(cls)
            out[side] = (eng, reqs, eng.serve(reqs))
    return out


def _same_as_jax(runs):
    """Statuses, errors, tokens and the ladder's statistics agree."""
    (jeng, jreqs, jout), (teng, treqs, tout) = runs["jax"], runs["port"]
    assert tout == jout
    assert ([(r.rid, r.status, r.error) for r in treqs]
            == [(r.rid, r.status, r.error) for r in jreqs])
    assert ({k: teng.stats[k] for k in STATS}
            == {k: jeng.stats[k] for k in STATS})
    assert all(r.status in TERMINAL for r in treqs)
    _pool_closes(teng)


def _pool_closes(eng):
    """Every page is free or a zero-ref cache resident; nothing seated."""
    cached = (list(eng._pcache.resident_pages())
              if eng._pcache is not None else [])
    assert sorted(eng._free + cached) == list(range(eng.num_blocks))
    assert all(r is None for r in eng._slot_req)
    assert eng._reqs == {}


def _fault_free(models, build, **kw):
    with _Env():
        eng = _engine(models, "port", **kw)
        return eng.serve(build(TRequest))


def _spec_reqs(cls):
    """Self-similar prompts, so the n-gram drafter proposes."""
    base = np.random.RandomState(4).randint(0, 128, (8,)).astype(np.int32)
    return [cls(rid=i, prompt_ids=np.tile(base, 3)[:20 + i].astype(np.int32),
                max_new_tokens=8,
                **({"temperature": 0.7, "seed": 11 + i} if i % 2 else {}))
            for i in range(3)]


FULL = dict(enable_prefix_caching=True, enable_speculation=True,
            num_draft_tokens=3, enable_chunked_prefill=True, prefill_chunk=8,
            num_blocks=16)

#: kind -> (spec, the requests' factory, engine kwargs, failed rids)
CHAOS = {
    "alloc_fail": ("alloc_fail@step=3", lambda c: _mixed_batch(c, 0), {},
                   ()),
    "kernel_error": ("kernel_error@step=2", lambda c: _mixed_batch(c, 0), {},
                     ()),
    "nan_logits": ("nan_logits@slot=0,step=3", lambda c: _mixed_batch(c, 1),
                   {}, (0,)),
    "slot_error": ("slot_error@rid=1,step=4", lambda c: _mixed_batch(c, 2),
                   {}, (1,)),
    "cache_error": ("cache_error@step=1",
                    lambda c: _mixed_batch(c, 3, prompt_len=17),
                    {"enable_prefix_caching": True}, ()),
    "nan_logits_spec_chunked": ("nan_logits@slot=1,step=5", _spec_reqs, FULL,
                                (1,)),
}


@pytest.mark.parametrize("kind", list(CHAOS))
def test_chaos_matches_jax(models, kind):
    """One fault kind: statuses, errors, tokens and statistics are the
    JAX engine's; only the victim fails (with ``error``), and every other
    stream is a serve's that never contained the victim."""
    spec, build, kw, victims = CHAOS[kind]
    runs = _serve_both(models, build, spec, **kw)
    _same_as_jax(runs)
    teng, treqs, tout = runs["port"]
    assert sorted(r.rid for r in treqs if r.status == "FAILED") == \
        list(victims)
    for r in treqs:
        if r.rid in victims:
            assert r.error and (r.error.startswith("non-finite")
                                or "slot_error" in r.error)
    if kind == "kernel_error":
        assert teng.stats["kernel_error_retries"] == 1
    if kind.startswith("nan_logits"):
        assert teng.stats["nan_guard_trips"] == 1
    if kind == "nan_logits_spec_chunked":
        assert teng.stats["mixed_steps"] > 0 and teng.stats["spec_steps"] > 0
    ref = _fault_free(models, lambda c: [r for r in build(c)
                                         if r.rid not in victims], **kw)
    for r in treqs:
        if r.rid not in victims:
            assert tout[r.rid] == ref[r.rid]


def test_kernel_error_persistent_reraises(models):
    """A dispatch fault past the retry limit means the step cannot run:
    graceful mode re-raises instead of spinning."""
    with _Env("kernel_error@count=-1"):
        eng = _engine(models, "port")
    eng.add_request(TRequest(rid=0, prompt_ids=np.arange(1, 10,
                                                         dtype=np.int32),
                             max_new_tokens=2))
    with pytest.raises(FaultInjected):
        for _ in range(10):
            eng.step()
    assert eng.stats["kernel_error_retries"] == eng._kernel_err_limit + 1


def test_kernel_exception_is_never_retried(models, monkeypatch):
    """An exception a kernel wrapper raises (a failed launch) is not an
    injected fault: graceful mode neither retries the step nor runs the
    plain version in its place; the error leaves ``step``."""
    with _Env("kernel_error@step=5"):
        eng = _engine(models, "port")
    calls = []

    def failing(*a, **k):
        calls.append(1)
        raise RuntimeError("fused_decode_step: CUDA kernel launch failed "
                           "with cudaError 700")

    monkeypatch.setattr(tserving._da, "fused_paged_decode_step", failing)
    eng.add_request(TRequest(rid=0, prompt_ids=np.arange(1, 10,
                                                         dtype=np.int32),
                             max_new_tokens=4))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        eng.step()
    assert calls == [1]
    assert eng.stats["kernel_error_retries"] == 0
    assert eng.stats["decode_steps"] == 0


def test_guard_poison_row_only_when_armed(models):
    """Graceful mode guards every step, but adds the NaN poison row only on
    a step where a ``nan_logits`` clause armed a slot; the guard flags a
    non-finite active row and zeroes it, and leaves finite rows alone."""
    with _Env("nan_logits@slot=1,step=1"):
        eng = _engine(models, "port")
    assert eng._guard_kw() == {"guard": True, "poison": None}
    eng.add_request(TRequest(rid=0, prompt_ids=np.arange(1, 10,
                                                         dtype=np.int32),
                             max_new_tokens=4))
    eng.add_request(TRequest(rid=1, prompt_ids=np.arange(2, 12,
                                                         dtype=np.int32),
                             max_new_tokens=4))
    eng._admit()
    eng._step_no = 1
    eng._arm_poison()
    kw = eng._guard_kw()
    assert kw["guard"] and kw["poison"].tolist() == [False, True]
    logits = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    active = torch.tensor([True, True])
    out, bad = eng._guard_logits(logits, active, kw["poison"])
    assert bad.tolist() == [False, True]
    assert torch.equal(out, torch.tensor([[0.0, 1.0, 2.0], [0.0, 0.0, 0.0]]))
    out, bad = eng._guard_logits(logits, active)
    assert not bad.any() and torch.equal(out, logits)


@pytest.mark.parametrize("kind", ["alloc_fail", "kernel_error", "slot_error",
                                  "cache_error", "nan_logits"])
def test_graceful_off(models, kind):
    """``PADDLE_TPU_GRACEFUL=0``: each fault raises out of ``step`` or
    ``serve``, as in the JAX engine (the pool-exhaustion message names the
    rid, the pages and the evictable count, word for word the JAX
    engine's); ``nan_logits`` is inert (no guard, no poison operand) and
    the streams are the graceful fault-free serve's."""
    if kind == "alloc_fail":
        errs = []
        with _Env("alloc_fail@step=9", graceful=False):
            for side, cls in (("jax", JRequest), ("port", TRequest)):
                eng = _engine(models, side)
                eng.add_request(cls(rid=42, prompt_ids=np.random.RandomState(
                    5).randint(0, 128, (9,)).astype(np.int32),
                    max_new_tokens=30))
                with pytest.raises(RuntimeError) as ei:
                    for _ in range(40):
                        eng.step()
                errs.append(str(ei.value))
        assert errs[1] == errs[0]
        assert "rid=42" in errs[1] and "evictable" in errs[1]
        return
    spec = {"kernel_error": "kernel_error@step=2",
            "slot_error": "slot_error@rid=0,step=3",
            "cache_error": "cache_error@step=1",
            "nan_logits": "nan_logits@slot=0,step=2"}[kind]
    kw = {"enable_prefix_caching": True} if kind == "cache_error" else {}
    with _Env(spec, graceful=False):
        eng = _engine(models, "port", **kw)
        assert eng._guard_kw() == {"guard": False, "poison": None}
        reqs = _mixed_batch(TRequest, 9, n=4 if kind == "nan_logits" else 2,
                            prompt_len=17 if kind == "cache_error" else 11)
        if kind != "nan_logits":
            with pytest.raises(FaultInjected):
                eng.serve(reqs)
            return
        got = eng.serve(reqs)
    assert got == _fault_free(models, lambda c: _mixed_batch(c, 9))
    assert all(r.status == "FINISHED" for r in reqs)
    assert eng.stats["nan_guard_trips"] == 0


def _rung1(c):
    rs = np.random.RandomState(10)
    return [c(rid=0, prompt_ids=rs.randint(0, 128, (17,)).astype(np.int32),
              max_new_tokens=2),
            c(rid=1, prompt_ids=rs.randint(0, 128, (30,)).astype(np.int32),
              max_new_tokens=30)]


def _rung2(c):
    base = np.random.RandomState(11).randint(0, 128, (6,)).astype(np.int32)
    return [c(rid=i, prompt_ids=np.tile(base, 4)[:21 + i].astype(np.int32),
              max_new_tokens=18) for i in range(2)]


def _rung3(c):
    rs = np.random.RandomState(12)
    return [c(rid=0, prompt_ids=rs.randint(0, 128, (9,)).astype(np.int32),
              max_new_tokens=7),
            c(rid=1, prompt_ids=rs.randint(0, 128, (49,)).astype(np.int32),
              max_new_tokens=4)]


def _rung4(c):
    rs = np.random.RandomState(13)
    return [c(rid=i, prompt_ids=rs.randint(0, 128, (12,)).astype(np.int32),
              max_new_tokens=24) for i in range(3)]


def _rung5(c):
    rs = np.random.RandomState(14)
    return [c(rid=0, prompt_ids=rs.randint(0, 128, (9,)).astype(np.int32),
              max_new_tokens=30),
            c(rid=1, prompt_ids=rs.randint(0, 128, (9,)).astype(np.int32),
              max_new_tokens=6)]


#: rung -> (the requests' factory, spec, engine kwargs, the rung's counter)
RUNGS = {
    1: (_rung1, None, dict(enable_prefix_caching=True, num_blocks=8),
        "degrade_evict"),
    2: (_rung2, None, dict(enable_speculation=True, num_draft_tokens=4,
                           num_blocks=8), "degrade_spec_off"),
    3: (_rung3, None, dict(enable_chunked_prefill=True, prefill_chunk=8,
                           num_blocks=8), "degrade_budget_shrink"),
    4: (_rung4, None, dict(num_blocks=8), "degrade_preempt"),
    5: (_rung5, "alloc_fail@step=9", dict(max_batch=1,
                                          enable_prefix_caching=True),
        "requests_failed"),
}


@pytest.mark.parametrize("rung", list(RUNGS))
def test_ladder_rung_matches_jax(models, rung):
    """Each rung of the overload ladder as the JAX engine takes it: 1
    evicts cache leaves ahead of the allocator, 2 suspends speculation
    for a step, 3 shrinks the mixed step's prefill rows, 4 preempts the
    youngest, 5 fails only the request no rung can satisfy (its error
    names the pinned cache pages); rungs 1 and 3 preempt no one, rungs
    1-4 fail no one, and every stream that finishes is the roomy
    fault-free serve's."""
    build, spec, kw, counter = RUNGS[rung]
    if rung == 1:
        # the warm request retires and donates its blocks first
        runs = {}
        with _Env(spec):
            for side, cls in (("jax", JRequest), ("port", TRequest)):
                eng = _engine(models, side, **kw)
                warm, req = build(cls)
                out = {**eng.serve([warm]), **eng.serve([req])}
                runs[side] = (eng, [warm, req], out)
    else:
        runs = _serve_both(models, build, spec, **kw)
    _same_as_jax(runs)
    teng, treqs, tout = runs["port"]
    assert teng.stats[counter] >= 1
    if rung in (1, 3):
        assert teng.stats["preemptions"] == 0
    if rung == 4:
        assert teng.stats["degrade_preempt"] == teng.stats["preemptions"]
    if rung == 5:
        hog = treqs[0]
        assert hog.status == "FAILED" and "pool exhausted" in hog.error
        assert "pinned cached" in hog.error and hog.output_ids
        assert treqs[1].status == "FINISHED"
    else:
        assert all(r.status == "FINISHED" for r in treqs)
    roomy = dict(max_batch=1) if rung == 5 else {**kw, "num_blocks": 16}
    ref = _fault_free(models, lambda c: [r for r in build(c)
                                         if not (rung == 5 and r.rid == 0)],
                      **roomy)
    for rid, toks in ref.items():
        assert tout[rid] == toks


def test_deadlines(models):
    """A running request past its deadline ends EXPIRED with its partial
    output; a queued one expires before it is seated."""
    with _Env():
        eng = _engine(models, "port", max_batch=1)
    rs = np.random.RandomState(15)
    run = TRequest(rid=0, prompt_ids=rs.randint(0, 128, (9,))
                   .astype(np.int32), max_new_tokens=40, deadline_s=10.0)
    dead = TRequest(rid=1, prompt_ids=rs.randint(0, 128, (9,))
                    .astype(np.int32), max_new_tokens=4, deadline_s=0.0)
    live = TRequest(rid=2, prompt_ids=rs.randint(0, 128, (9,))
                    .astype(np.int32), max_new_tokens=4)
    for r in (run, dead, live):
        eng.add_request(r)
    for _ in range(3):
        eng.step()
    assert dead.status == "EXPIRED" and dead.output_ids == []
    assert "queued" in dead.error
    run._submit_s -= 11.0                 # the budget is spent
    while eng.step() or eng._queue:
        pass
    assert run.status == "EXPIRED" and "deadline" in run.error
    assert 0 < len(run.output_ids) < 40
    assert live.status == "FINISHED" and len(live.output_ids) == 4
    assert eng.stats["requests_expired"] == 2
    _pool_closes(eng)


def test_cancel(models, monkeypatch):
    """Cancel a queued request, a decoding one (its partial output stays)
    and one mid-prefill (the chunked cursor's pages free); a terminal or
    unknown rid gives False; graceful off, cancel raises."""
    with _Env():
        eng = _engine(models, "port", max_batch=1)
        chunked = _engine(models, "port", enable_chunked_prefill=True,
                          prefill_chunk=4)
    rs = np.random.RandomState(17)
    running = TRequest(rid=0, prompt_ids=rs.randint(0, 128, (9,))
                       .astype(np.int32), max_new_tokens=50)
    queued = TRequest(rid=1, prompt_ids=rs.randint(0, 128, (9,))
                      .astype(np.int32), max_new_tokens=50)
    eng.add_request(running)
    eng.add_request(queued)
    for _ in range(3):
        eng.step()
    assert eng.cancel(1) is True and queued.status == "CANCELLED"
    assert queued not in eng._queue
    assert eng.cancel(0) is True and running.status == "CANCELLED"
    assert running.output_ids
    assert eng.cancel(0) is False and eng.cancel(999) is False
    assert eng.stats["requests_cancelled"] == 2
    _pool_closes(eng)
    assert eng.step() is False
    req = TRequest(rid=0, prompt_ids=rs.randint(0, 128, (40,))
                   .astype(np.int32), max_new_tokens=8)
    chunked.add_request(req)
    chunked.step()
    assert chunked._prefill_ids[0] is not None
    assert chunked.cancel(0) is True and req.status == "CANCELLED"
    _pool_closes(chunked)
    monkeypatch.setenv("PADDLE_TPU_GRACEFUL", "0")
    off = _engine(models, "port")
    with pytest.raises(RuntimeError, match="GRACEFUL"):
        off.cancel(0)


def test_max_queue_and_invalid_requests(models, monkeypatch):
    """Backpressure: with ``max_queue`` requests waiting a newcomer ends
    REJECTED (graceful off: raises); an invalid request is refused at
    validation, and ``serve`` ends it REJECTED while the rest run."""
    with _Env():
        eng = _engine(models, "port", max_batch=1, max_queue=2)
    rs = np.random.RandomState(19)
    reqs = [TRequest(rid=i, prompt_ids=rs.randint(0, 128, (9,))
                     .astype(np.int32), max_new_tokens=3) for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    shed = [r for r in reqs if r.status == "REJECTED"]
    assert len(shed) == 2 and all("queue full" in r.error for r in shed)
    assert eng.stats["requests_rejected"] == 2
    while eng.step() or eng._queue:
        pass
    assert sum(r.status == "FINISHED" for r in reqs) == 2
    ids = rs.randint(0, 128, (5,)).astype(np.int32)
    for bad in (dict(temperature=float("nan")),
                dict(temperature=float("inf")), dict(top_p=float("nan")),
                dict(deadline_s=float("nan")), dict(deadline_s=-1.0)):
        with pytest.raises(ValueError):
            eng.add_request(TRequest(rid=9, prompt_ids=ids, **bad))
    good = TRequest(rid=0, prompt_ids=ids, max_new_tokens=3)
    bad = TRequest(rid=1, prompt_ids=ids, temperature=float("nan"))
    got = eng.serve([good, bad])
    assert good.status == "FINISHED" and len(got[0]) == 3
    assert bad.status == "REJECTED" and "finite" in bad.error
    assert got[1] == []
    monkeypatch.setenv("PADDLE_TPU_GRACEFUL", "0")
    off = _engine(models, "port", max_batch=1, max_queue=0)
    with pytest.raises(RuntimeError, match="queue full"):
        off.add_request(TRequest(rid=0, prompt_ids=ids))


def _snap_reqs(cls):
    rs = np.random.RandomState(23)
    return [cls(rid=0, prompt_ids=rs.randint(0, 128, (9,)).astype(np.int32),
                max_new_tokens=12),
            cls(rid=1, prompt_ids=rs.randint(0, 128, (13,)).astype(np.int32),
                max_new_tokens=12, temperature=0.9, top_p=0.85, seed=5),
            cls(rid=2, prompt_ids=rs.randint(0, 128, (33,)).astype(np.int32),
                max_new_tokens=12)]


def _chunk_reqs(cls):
    rs = np.random.RandomState(24)
    return [cls(rid=0, prompt_ids=rs.randint(0, 128, (37,)).astype(np.int32),
                max_new_tokens=6, temperature=0.6, seed=3)]


SNAPS = {"decode": (_snap_reqs, {}, 5),
         "chunked_prefill": (_chunk_reqs, dict(enable_chunked_prefill=True,
                                               prefill_chunk=4), 3)}


@pytest.fixture(scope="module")
def snap_sources(models):
    """where -> (the uninterrupted JAX serve's tokens, side -> the JSON
    snapshot after the first steps, side -> those requests), made once for
    every (src, dst) case of ``where``."""
    cache = {}

    def get(where):
        if where not in cache:
            build, kw, steps = SNAPS[where]
            with _Env():
                want = _engine(models, "jax", **kw).serve(build(JRequest))
                snaps, reqs1 = {}, {}
                for side, cls in (("jax", JRequest), ("port", TRequest)):
                    eng = _engine(models, side, **kw)
                    reqs1[side] = build(cls)
                    for r in reqs1[side]:
                        eng.add_request(r)
                    for _ in range(steps):
                        eng.step()
                    snaps[side] = json.dumps(eng.snapshot())
            cache[where] = (want, snaps, reqs1)
        return cache[where]

    return get


@pytest.mark.parametrize("where", list(SNAPS))
@pytest.mark.parametrize("src,dst", [("port", "port"), ("jax", "port"),
                                     ("port", "jax")])
def test_snapshot_restore(models, snap_sources, where, src, dst):
    """Serve a few steps on ``src``, snapshot through ``json.dumps``,
    restore on a fresh ``dst`` engine and finish: every request's stream
    is the uninterrupted JAX serve's (greedy and seeded).  Taken at the
    same step, the two packages' snapshots are the same JSON.  The
    uninterrupted serve and the snapshots are each ``where``'s, shared by
    its three cases."""
    _, kw, _ = SNAPS[where]
    want, snaps, reqs1 = snap_sources(where)
    assert snaps["port"] == snaps["jax"]
    with _Env():
        snap = json.loads(snaps[src])
        if where == "chunked_prefill":
            assert snap["running"][0]["prefilled"] > 0
        else:
            assert snap["queued"] and any(j["output_ids"]
                                          for j in snap["running"])
        eng2 = _engine(models, dst, **kw)
        restored = eng2.restore(snap)
        while eng2.step() or eng2._queue:
            pass
    done = {r.rid: r for r in reqs1[src] if r.finished}
    for rid, toks in want.items():
        r = next((q for q in restored if q.rid == rid), None) or done[rid]
        assert r.output_ids == toks and r.status == "FINISHED"
    if dst == "port":
        _pool_closes(eng2)


def test_restore_rearms_remaining_deadline_and_refuses(models):
    """The journal carries the unspent budget and a restore re-arms the
    deadline with it (an entry without it falls back to ``deadline_s``);
    an unknown version and a topology mismatch are refused, naming the
    field."""
    with _Env():
        eng1 = _engine(models, "port")
        eng2 = _engine(models, "port")
        eng3 = _engine(models, "port")
        int8 = _engine(models, "port", kv_quant="int8")
    req = TRequest(rid=0, prompt_ids=np.arange(1, 10, dtype=np.int32),
                   max_new_tokens=10_000, deadline_s=10.0)
    eng1.add_request(req)
    eng1.step()
    req._submit_s = time.perf_counter() - 8.0         # 80% spent
    snap = eng1.snapshot()
    j = snap["running"][0]
    assert j["deadline_s"] == 10.0 and 1.5 < j["deadline_remaining_s"] < 2.1
    restored = eng2.restore(snap)[0]
    assert restored.deadline_s < 2.5
    restored._submit_s -= restored.deadline_s + 0.1
    eng2.step()
    assert restored.status == "EXPIRED"
    del j["deadline_remaining_s"]
    assert eng3.adopt(j).deadline_s == 10.0
    with pytest.raises(ValueError, match="version"):
        eng3.restore({"version": 99, "running": [], "queued": []})
    with pytest.raises(ValueError, match="kv_quant"):
        int8.restore(snap)
    bad = json.loads(json.dumps(snap))
    bad["engine"]["model"] = bad["engine"]["model"].replace("dtfloat32",
                                                            "dtbfloat16")
    with pytest.raises(ValueError, match="model"):
        eng3.restore(bad)
    bad["engine"] = dict(snap["engine"], tp=4)        # tp may differ
    assert len(eng3.restore(bad)) == 1


def test_fault_spec_grammar(monkeypatch):
    """The grammar of ``PADDLE_TPU_FAULT_INJECT``: a valid plan parses
    without a warning and fires as written; an unknown kind, an unknown
    key, a non-numeric value or a replica-scoped kind warns (with a
    did-you-mean where one is close) and disables injection;
    ``tier_drop`` parses (it has no seam until the host tier);
    ``PADDLE_TPU_GRACEFUL`` takes only 0 or 1."""
    monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT",
                       "alloc_fail@step=7;nan_logits@slot=2,step=11;"
                       "kernel_error@p=0.5,seed=9,count=-1;tier_drop")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan = FaultPlan.from_env()
    assert plan
    assert plan.fire("alloc_fail", step=7) is True
    assert plan.fire("alloc_fail", step=7) is False
    assert plan.fire("nan_logits", step=11, slot=1) is False
    assert plan.fire("nan_logits", step=11, slot=2) is True
    draws = [plan.fire("kernel_error", step=s) for s in range(40)]
    assert 0 < sum(draws) < 40
    again = FaultPlan.from_env()
    assert [again.fire("kernel_error", step=s) for s in range(40)] == draws
    for raw, word in (("aloc_fail@step=2;nan_logits@step=3", "alloc_fail"),
                      ("alloc_fail@stp=2", "stp"),
                      ("alloc_fail@step=two", "two"),
                      ("replica_crash@step=9", "fleet"),
                      ("alloc_fail@replica=1", "fleet")):
        monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT", raw)
        envflags._warned.clear()
        with pytest.warns(UserWarning, match=word):
            assert not FaultPlan.from_env()
    assert "tier_drop" in tfaults.KNOWN_KINDS
    monkeypatch.setenv("PADDLE_TPU_GRACEFUL", "off")
    envflags._warned.clear()
    with pytest.warns(UserWarning, match="GRACEFUL"):
        assert envflags.env_bool("PADDLE_TPU_GRACEFUL", True) is True
