"""The port's dense serving modes against the JAX package on the CPU.

The reference's default engine, ``ContinuousBatchingEngine(paged=False)``
(one ``max_seq`` lane of KV cache a slot), its ``GenerationEngine`` and its
``RecordEvent`` spans, each run by both packages on the same f32 tiny
Llama (2 layers; one weight tree made with numpy from a seed, bridged to
the port through ``utils/convert.py``), with the same requests (prompts
from a seeded numpy RNG, half greedy, half seeded temperature + top-p):

- the dense engine at ``chunk`` 1 and 4 and under ``quant='int8'``: tokens
  identical, every lane's K/V cache within 1e-5, and at ``chunk`` 1 and
  under ``quant`` the logits of one more decode step too;
- the NaN guard, an injected ``kernel_error``, ``cancel`` and deadlines in
  dense mode: the same statuses, errors and tokens, and the same sequence
  of span names (the reference's read through its own export);
- ``snapshot`` -> JSON -> ``restore`` equal to the uninterrupted serve, and
  a paged / dense mismatch refused by both packages;
- each paged-only option refused with the reference's ``ValueError``;
  the reference's dense validation cases and ``max_queue`` backpressure;
- ``PADDLE_TPU_ENGINE_AUDIT=1`` clean on a dense serve (I6, I8);
- a two-replica dense ``FleetRouter``: the same owners after every fleet
  step and the same tokens;
- ``GenerationEngine`` greedy, at ``temperature`` 0.8 with a seed, and
  under ``quant`` int8 / int4: tokens identical, logits within 1e-5;
- every argument the two engines share with the reference's has the
  reference's default (``paged=False`` among them).

Every JAX program runs once, in the module fixture ``jax_runs``.
"""

import dataclasses
import inspect
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu.inference import GenerationEngine as JGen
from paddle_tpu.inference.fleet import FleetRouter as JFleet
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.inference import GenerationEngine as TGen
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.fleet import FleetRouter as TFleet
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TRequest = tserving.Request
TEngine = tserving.ContinuousBatchingEngine
# four lanes of 64 positions; six requests, so lanes are reused
ENGINE = dict(max_batch=4, max_seq=64)
#: the fault plan of the chaos serve: the NaN guard trips on slot 1 at step
#: 3, and step 5's dispatch fails once (retried)
PLAN = "nan_logits@step=3,slot=1;kernel_error@step=5"
SPAN_PREFIXES = ("serving/", "fleet/", "prefix_cache/", "kv_tier/")


@pytest.fixture(scope="module")
def models():
    """The tiny config in both packages and one weight tree made with
    numpy from a seed (norms 1, matrices N(0, 0.02^2) as ``init_params``
    draws them), shaped as the JAX package's ``init_params`` shapes it."""
    kw = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64)
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(**kw),
                               dtype=jnp.float32)
    rs = np.random.RandomState(0)

    def draw(path, leaf):
        if "norm" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (rs.standard_normal(leaf.shape) * 0.02).astype(np.float32)

    weights = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: jllama.init_params(jcfg)))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(**kw),
                               dtype=torch.float32)
    return {"jax": (jcfg, jax.tree_util.tree_map(jnp.asarray, weights)),
            "port": (tcfg, params_from_numpy(weights, device="cpu"))}


def _requests(cls, seed=0, n=6):
    """Half greedy, half seeded temperature + top-p; prompts of 9-14
    tokens (one prefill bucket), budgets of 5-10 tokens."""
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        p = rs.randint(0, 128, (9 + i,)).astype(np.int32)
        kw = dict(temperature=0.8, top_p=0.9, seed=11 + i) if i % 2 else {}
        reqs.append(cls(rid=i, prompt_ids=p, max_new_tokens=5 + i, **kw))
    return reqs


def _engine(models, side, **kw):
    cfg, params = models[side]
    if side == "jax":
        return JEngine(cfg, params, **{**ENGINE, **kw})
    return TEngine(cfg, params, device="cpu", **{**ENGINE, **kw})


def _lanes(eng):
    """Each lane's K/V cache below its last request's final position
    (numpy, [L, nkv, pos, hd] per lane, K and V)."""
    out = []
    for s in range(eng.max_batch):
        p = int(eng._pos[s])
        for pool in (eng.cache_k, eng.cache_v):
            out.append(np.asarray(pool)[:, s, :, :p])
    return out


def _next_logits(eng, side):
    """The logits of one more dense decode step from the engine's end
    state: every lane active at its position, its last token fed."""
    tok, pos = eng._last_tok.astype(np.int32), eng._pos.astype(np.int32)
    active = np.ones(eng.max_batch, bool)
    if side == "jax":
        logits, _, _ = jax.jit(eng._decode_one)(
            eng.params, eng.cache_k, eng.cache_v, jnp.asarray(tok),
            jnp.asarray(pos), jnp.asarray(active))
        return np.asarray(logits)
    return eng._decode_one(torch.as_tensor(tok).long(),
                           torch.as_tensor(pos).long(),
                           torch.as_tensor(active), None).numpy()


def _spans(prof, path):
    """The span names a package's export writes, in the order they
    ended."""
    prof.export(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e["name"].startswith(SPAN_PREFIXES)]


def _chaos(models, side, tmp_path, monkeypatch):
    """The dense chaos serve: ``PLAN``, a request whose deadline passed
    before it was seated, one running and one queued request cancelled
    after step 2, then an invalid request through ``serve``.  Returns
    (requests, their tokens, the span names)."""
    cls = JRequest if side == "jax" else TRequest
    prof = jprofiler.Profiler() if side == "jax" else tprofiler.Profiler()
    _spans(prof, tmp_path / f"{side}_drain.json")
    monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT", PLAN)
    eng = _engine(models, side, max_batch=2)
    monkeypatch.delenv("PADDLE_TPU_FAULT_INJECT")
    reqs = _requests(cls, seed=5)
    reqs[4].deadline_s = 0.0
    for r in reqs:
        eng.add_request(r)
    for _ in range(2):
        eng.step()
    assert eng.cancel(reqs[0].rid) and eng.cancel(reqs[5].rid)
    while eng.step() or eng._queue:
        pass
    bad = cls(rid=9, prompt_ids=np.arange(1, 5, dtype=np.int32),
              temperature=float("nan"))
    eng.serve([bad])
    reqs.append(bad)
    names = _spans(prof, tmp_path / f"{side}_spans.json")
    return reqs, {r.rid: list(r.output_ids) for r in reqs}, names


@pytest.fixture(scope="module")
def jax_runs(models, tmp_path_factory):
    """Every JAX run of the module, once, its RMSNorm through the JAX
    package's plain reference (``PADDLE_TPU_DISABLE_PALLAS=rms_norm``: the
    Pallas kernel itself is held against the port's in
    ``test_torch_kernels.py``)."""
    mp = pytest.MonkeyPatch()
    mp.delenv("PADDLE_TPU_FAULT_INJECT", raising=False)
    mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "rms_norm")
    tmp = tmp_path_factory.mktemp("dense_spans")
    out = {}
    try:
        for name, kw in (("chunk1", {}), ("chunk4", dict(chunk=4)),
                         ("int8", dict(quant="int8"))):
            eng = _engine(models, "jax", **kw)
            toks = eng.serve(_requests(JRequest))
            # chunk 4 scans chunk 1's decode step: its logits are chunk 1's
            out[name] = (toks, _lanes(eng), None if name == "chunk4"
                         else _next_logits(eng, "jax"))
        out["chaos"] = _chaos(models, "jax", tmp, mp)
        out["fleet"] = _fleet_run(models, "jax")
        jcfg, jparams = models["jax"]
        prompt = _prompt()
        ge = JGen(jcfg, jparams, max_seq=32)
        logits, *_ = ge._prefill(ge.params, jnp.asarray(prompt),
                                 *ge.init_cache(prompt.shape[0]))
        out["gen"] = {
            "greedy": ge.generate(prompt, max_new_tokens=6),
            "sampled": ge.generate(prompt, max_new_tokens=6,
                                   temperature=0.8, seed=3),
            "logits": np.asarray(logits)}
        for quant in ("int8", "int4"):
            ge = JGen(jcfg, jparams, max_seq=32, quant=quant)
            out["gen"][quant] = ge.generate(prompt, max_new_tokens=6)
    finally:
        mp.undo()
    return out


def _prompt():
    return np.random.RandomState(7).randint(0, 128, (2, 9)).astype(np.int32)


def _fleet_run(models, side):
    """Two dense replicas of two slots serving the six requests greedily:
    the owner map after every fleet step, and the tokens."""
    cfg, params = models[side]
    if side == "jax":
        fleet, cls = JFleet(cfg, params, n_replicas=2, max_batch=2,
                            max_seq=64), JRequest
    else:
        fleet, cls = TFleet(cfg, params, n_replicas=2, max_batch=2,
                            max_seq=64, device="cpu"), TRequest
    assert all(not e.paged for e in fleet.replicas)
    reqs = _requests(cls, seed=3)
    for r in reqs:
        r.temperature = 0.0         # greedy: one decode program a replica
        fleet.add_request(r)
    owners = []
    while fleet.step():
        owners.append(dict(fleet._owner))
    return owners, {r.rid: list(r.output_ids) for r in reqs}


# ---------------- the dense continuous-batching engine ----------------

@pytest.mark.parametrize("name,kw", [("chunk1", {}), ("chunk4", dict(chunk=4)),
                                     ("int8", dict(quant="int8"))])
def test_dense_engine_matches_jax(models, jax_runs, monkeypatch, name, kw):
    """Tokens identical; each lane's K/V and one more step's logits within
    1e-5.  With the auditor on, its dense invariants (I6, I8) hold after
    admission and after every step; B1 runs 2L + 1 times a forward."""
    want_toks, want_lanes, want_logits = jax_runs[name]
    monkeypatch.setenv("PADDLE_TPU_ENGINE_AUDIT", "1")
    eng = _engine(models, "port", **kw)
    assert not eng.paged and eng._audit_every_step
    assert eng.cache_k.shape == (2, 4, 2, 64, 8)
    tk.reset_counters()
    got = eng.serve(_requests(TRequest))
    assert got == want_toks
    L = eng.cfg.num_hidden_layers
    forwards = eng.stats["decode_steps"] + eng.stats["prefills"]
    assert tk.PLAIN_CALLS["rms_norm"] == (2 * L + 1) * forwards
    for name_ in ("fused_decode_step", "fused_layer_mlp", "paged_prefill"):
        assert tk.PLAIN_CALLS[name_] == 0
    for a, b in zip(_lanes(eng), want_lanes):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    if want_logits is not None:
        np.testing.assert_allclose(_next_logits(eng, "port"), want_logits,
                                   atol=1e-5, rtol=1e-5)


def test_dense_chaos_matches_jax(models, jax_runs, tmp_path, monkeypatch):
    """The NaN guard, a retried dispatch fault, an expired and two
    cancelled requests and an invalid one: statuses, errors and tokens
    equal, and the same span names in the same order."""
    want_reqs, want_toks, want_spans = jax_runs["chaos"]
    reqs, toks, spans = _chaos(models, "port", tmp_path, monkeypatch)
    assert toks == want_toks
    assert ([(r.status, r.error) for r in reqs]
            == [(r.status, r.error) for r in want_reqs])
    assert {r.status for r in reqs} == {"FINISHED", "FAILED", "CANCELLED",
                                        "EXPIRED", "REJECTED"}
    assert spans == want_spans
    assert {"serving/failed", "serving/kernel_error_retry",
            "serving/cancelled", "serving/expired",
            "serving/rejected"} <= set(spans)


def test_dense_snapshot_restore(models, jax_runs):
    """snapshot mid-serve -> JSON -> a fresh dense engine: the completed
    serve is the uninterrupted JAX serve; a paged snapshot on a dense
    engine, and the reverse, raise in both packages."""
    want = jax_runs["chunk1"][0]
    eng1 = _engine(models, "port")
    reqs = _requests(TRequest)
    for r in reqs:
        eng1.add_request(r)
    for _ in range(4):
        eng1.step()
    snap = json.loads(json.dumps(eng1.snapshot()))
    assert snap["engine"]["paged"] is False
    assert snap["engine"]["block_size"] is None
    running = [j["rid"] for j in snap["running"]]
    assert running == [eng1._slot_req[s].rid for s in range(4)
                       if eng1._slot_req[s] is not None]
    eng2 = _engine(models, "port")
    restored = eng2.restore(snap)
    assert any(r.output_ids for r in restored)
    while eng2.step() or eng2._queue:
        pass
    got = {r.rid: list(r.output_ids) for r in reqs}
    got.update({r.rid: list(r.output_ids) for r in restored})
    assert got == want
    paged = _engine(models, "port", paged=True, block_size=16).snapshot()
    for side in ("port", "jax"):
        with pytest.raises(ValueError, match="paged"):
            _engine(models, side).restore(paged)
        with pytest.raises(ValueError, match="block_size"):
            _engine(models, side, paged=True, block_size=16).restore(snap)


def test_dense_validation(models):
    """The reference's dense cases of ``tests/test_fault_tolerance.py``: a
    non-finite or negative sampling parameter or deadline is refused at
    ``add_request``, and ``restore`` refuses an unknown version."""
    eng = _engine(models, "port")
    ids = np.arange(1, 6, dtype=np.int32)
    for bad in (dict(temperature=float("nan")),
                dict(temperature=float("inf")), dict(top_p=float("nan")),
                dict(deadline_s=float("nan")), dict(deadline_s=-1.0)):
        with pytest.raises(ValueError):
            eng.add_request(TRequest(rid=0, prompt_ids=ids, **bad))
    with pytest.raises(ValueError, match="version"):
        eng.restore({"version": 99, "running": [], "queued": []})


def test_dense_bounded_queue(models):
    """``max_queue`` on a dense engine: with one lane and room for two,
    two of four requests queue and two are shed REJECTED at submission;
    the queued two are served."""
    eng = _engine(models, "port", max_batch=1, max_queue=2)
    reqs = [TRequest(rid=i, prompt_ids=np.arange(1 + i, 10 + i,
                                                 dtype=np.int32),
                     max_new_tokens=3) for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    assert [r.status for r in reqs] == ["PENDING"] * 2 + ["REJECTED"] * 2
    assert all("queue full" in r.error for r in reqs[2:])
    while eng.step() or eng._queue:
        pass
    assert [r.status for r in reqs[:2]] == ["FINISHED"] * 2
    assert eng.stats["requests_rejected"] == 2


PAGED_ONLY = [
    (dict(kv_quant="int8"), "kv_quant requires paged=True"),
    (dict(tensor_parallel=2), "tensor_parallel > 1 requires paged=True"),
    (dict(enable_prefix_caching=True),
     "enable_prefix_caching requires paged=True"),
    (dict(enable_prefix_caching=True, enable_host_kv_tier=True),
     "enable_prefix_caching requires paged=True"),
    (dict(enable_host_kv_tier=True), "enable_host_kv_tier requires paged"),
    (dict(enable_speculation=True), "enable_speculation requires paged=True"),
    (dict(enable_chunked_prefill=True),
     "enable_chunked_prefill requires paged=True"),
]


@pytest.mark.parametrize("kw,msg", PAGED_ONLY)
def test_paged_only_options_refused(models, kw, msg):
    """Each paged-only option on a dense engine raises ``ValueError``; the
    port's message is the reference's (a refused degree also names the
    port's own problems with it)."""
    with pytest.raises(ValueError, match=msg) as want:
        _engine(models, "jax", **kw)
    with pytest.raises(ValueError, match=msg) as got:
        _engine(models, "port", **kw)
    if "tensor_parallel" not in kw:
        assert str(got.value) == str(want.value)


def test_dense_ignores_block_geometry(models):
    """``block_size`` / ``num_blocks`` are the paged engine's: a dense
    engine takes any, and its pools are [L, B, nkv, max_seq, hd]."""
    eng = _engine(models, "port", block_size=48, num_blocks=1)
    assert eng.block_size is None and eng.cache_v.shape[1:4] == (4, 2, 64)
    with pytest.raises(ValueError, match="multiple of block_size"):
        _engine(models, "port", paged=True, block_size=48)


def test_dense_fleet_matches_jax(models, jax_runs):
    assert _fleet_run(models, "port") == jax_runs["fleet"]


# ---------------- GenerationEngine ----------------

@pytest.mark.parametrize("mode", ["greedy", "sampled", "int8", "int4"])
def test_generation_engine_matches_jax(models, jax_runs, mode):
    cfg, params = models["port"]
    want = jax_runs["gen"][mode]
    quant = mode if mode.startswith("int") else None
    ge = TGen(cfg, params, max_seq=32, quant=quant, device="cpu")
    tk.reset_counters()
    if mode == "sampled":
        got = ge.generate(_prompt(), max_new_tokens=6, temperature=0.8,
                          seed=3)
    else:
        got = ge.generate(_prompt(), max_new_tokens=6)
    assert got.dtype == np.int32 and got.shape == (2, 15)
    np.testing.assert_array_equal(got, want)
    # one prefill and a decode step a token but the last: 2L + 1 norms each
    assert tk.PLAIN_CALLS["rms_norm"] == 5 * 6
    if mode == "greedy":
        logits, *_ = ge._prefill_impl(torch.as_tensor(_prompt()).long(),
                                      *ge.init_cache(2))
        np.testing.assert_allclose(logits.numpy(), jax_runs["gen"]["logits"],
                                   atol=1e-5, rtol=1e-5)


def test_generation_engine_refuses_overlong(models):
    cfg, params = models["port"]
    ge = TGen(cfg, params, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ge.generate(_prompt(), max_new_tokens=8)


# ---------------- the constructors' defaults ----------------

@pytest.mark.parametrize("port,ref", [(TEngine, JEngine), (TGen, JGen)])
def test_defaults_are_the_references(port, ref):
    """Every argument the port's constructor shares with the reference's
    has the reference's default (``paged=False``: the dense engine)."""
    mine = inspect.signature(port.__init__).parameters
    theirs = inspect.signature(ref.__init__).parameters
    shared = set(mine) & set(theirs) - {"self"}
    assert set(theirs) - {"self"} <= shared
    assert {n: mine[n].default for n in shared} == \
        {n: theirs[n].default for n in shared}
    if port is TEngine:
        assert mine["paged"].default is False
