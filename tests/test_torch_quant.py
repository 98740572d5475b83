"""The port's weight-only quantized serving against the JAX package on the
CPU.

- ``quantize_layer_params`` on f32 and bf16 trees, int8 and int4: codes
  (int4 unpacked) and scales bit for bit against the reference's;
- the weight bridge of a JAX-quantized tree (``jnp.int4`` codes packed two
  a byte on the way in, unpacked on the way out), exact both ways;
- ``wmat`` against the reference's ``_dequant_2d`` bit for bit, f32 and
  bf16 (the multiply in the model dtype);
- the engine under ``quant='int8'`` and ``'int4'``, greedy and seeded
  top-p requests, token-identical to the JAX engine with equal step
  statistics: int8 bucketed with the prefix cache on, int4 bucketed over
  an int8 KV pool, int4 chunked + speculative over an int8 KV pool with
  the prefix cache on; and int8 chunked + speculative with the prefix
  cache on, token-identical to the JAX int8 bucketed run (on fp pools
  chunking and speculation leave the stream as it is).  The JAX engine
  runs through its plain references
  (``PADDLE_TPU_DISABLE_PALLAS=paged_attention``), both with
  ``PADDLE_TPU_GRACEFUL=0``; its three runs are shared by one module
  fixture.  Under ``quant`` the fused MLP half is off and the fused decode
  step still runs (plain-version counts);
- a quantized snapshot through JSON restored in both directions between
  the packages, and a quant mismatch refused;
- the reference's ``test_cb_engine_int8_serves``.

Tolerance: none; codes, scales, dequantized matrices and tokens compare
exactly.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference import quantize_layer_params as jquantize
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.inference.serving import Request as JRequest
from paddle_tpu.models import llama as jllama
from paddle_tpu.nn.quant import _dequant_2d as jdequant
from paddle_tpu_torch.inference import quantize_layer_params, wmat
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.utils.convert import params_from_numpy, params_to_numpy
from torch_threads import one_torch_thread  # noqa: F401

TRequest = tserving.Request
QUANTS = ("int8", "int4")
LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ENGINE = dict(max_batch=2, max_seq=64, chunk=2, block_size=8, num_blocks=8)
CHUNKED_SPEC = dict(enable_chunked_prefill=True, prefill_chunk=8,
                    token_budget=5, enable_speculation=True,
                    num_draft_tokens=4, spec_ngram=3)
#: label -> (quant, features, the JAX run it is held to): each quant
#: bucketed and chunked + speculative, the prefix cache and an int8 KV pool
#: each under both; the first three are JAX runs too
RUNS = {"int8_bucketed_prefix": ("int8", dict(enable_prefix_caching=True),
                                 "int8_bucketed_prefix"),
        "int4_bucketed_kv8": ("int4", dict(kv_quant="int8"),
                              "int4_bucketed_kv8"),
        "int4_chunked_spec_kv8_prefix": (
            "int4", dict(CHUNKED_SPEC, kv_quant="int8",
                         enable_prefix_caching=True),
            "int4_chunked_spec_kv8_prefix"),
        "int8_chunked_spec_prefix": ("int8", dict(CHUNKED_SPEC,
                                                  enable_prefix_caching=True),
                                     "int8_bucketed_prefix")}
JAX_RUNS = sorted({want for _, _, want in RUNS.values()})
STATS = ("decode_steps", "decode_tokens", "prefills", "preemptions",
         "mixed_steps", "prefill_chunks", "spec_steps", "spec_drafted_tokens",
         "spec_accepted_tokens", "prefix_hits", "prefix_blocks_reused",
         "prefill_tokens_cached", "prefill_tokens_computed")
#: the snapshot run: its label, and the steps served before the snapshot
SNAP_RUN, SNAP_STEPS = "int8_bucketed_prefix", 4


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _jax_tree(dtype):
    cfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)
    return cfg, jllama.init_params(cfg, jax.random.key(0))


@pytest.fixture(scope="module")
def trees():
    """(dtype name, quant) -> (JAX quantized tree, the port's tree of the
    same weights quantized by the port); dtype name -> fp port tree."""
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        _, jparams = _jax_tree(dt)
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                                    device="cpu")
        out[name] = tparams
        for quant in QUANTS:
            out[name, quant] = (jquantize(jparams, quant),
                                quantize_layer_params(tparams, quant))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_layer_params_matches_jax(trees, dtype, quant):
    """Codes (int4 unpacked) and scales bit for bit, every matmul leaf;
    embed, lm_head and the norms stay the fp tensors."""
    jq, tq = trees[dtype, quant]
    fp = trees[dtype]
    for name in LEAVES:
        got = params_to_numpy(tq["layers"][name], quant)
        want = jq["layers"][name]
        L, K, N = fp["layers"][name].shape
        assert got["qweight"].shape == (L, N, K)
        assert got["qweight"].dtype == np.int8
        np.testing.assert_array_equal(
            got["qweight"], np.asarray(want["qweight"]).astype(np.int8))
        assert got["scale"].dtype == np.float32
        np.testing.assert_array_equal(_bits(got["scale"]),
                                      _bits(want["scale"]))
    packed = tq["layers"]["wq"]["qweight"]
    assert packed.dtype == torch.int8
    assert packed.shape[-1] == (fp["layers"]["wq"].shape[1]
                                // (2 if quant == "int4" else 1))
    for name in ("input_norm", "post_norm"):
        assert tq["layers"][name] is fp["layers"][name]
    assert tq["embed"] is fp["embed"] and tq["lm_head"] is fp["lm_head"]


@pytest.mark.parametrize("quant", QUANTS)
def test_bridge_of_jax_quantized_tree_is_exact(trees, quant):
    """A JAX-quantized tree through ``params_from_numpy`` is the port's
    quantized tree byte for byte (int4 packed), and ``params_to_numpy``
    gives the JAX codes and scales back."""
    jq, tq = trees["float32", quant]
    host = jax.tree_util.tree_map(np.asarray, jq["layers"])
    bridged = params_from_numpy(host, device="cpu")
    back = params_to_numpy(bridged, quant)
    for name in LEAVES:
        for key in ("qweight", "scale"):
            assert torch.equal(bridged[name][key], tq["layers"][name][key])
        np.testing.assert_array_equal(back[name]["qweight"],
                                      host[name]["qweight"].astype(np.int8))
        np.testing.assert_array_equal(_bits(back[name]["scale"]),
                                      _bits(host[name]["scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", QUANTS)
def test_wmat_matches_dequant_2d(trees, dtype, quant):
    """``wmat`` of every layer's quantized leaf is the reference's
    ``_dequant_2d`` in the model dtype bit for bit; an fp leaf passes
    through unchanged."""
    jq, tq = trees[dtype, quant]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    for name in LEAVES:
        jleaf, tleaf = jq["layers"][name], tq["layers"][name]
        for li in range(tleaf["scale"].shape[0]):
            got = wmat({k: v[li] for k, v in tleaf.items()}, tdt, quant)
            want = jdequant(jleaf["qweight"][li], jleaf["scale"][li], jdt)
            assert got.dtype == tdt
            np.testing.assert_array_equal(_bits(params_to_numpy(got)),
                                          _bits(want))
    fp = trees[dtype]["layers"]["wq"][0]
    assert wmat(fp, tdt, quant) is fp


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts():
    """Two prompts that repeat a random span (the drafter proposes on
    them), a 30-token random one, a short random one."""
    rs = np.random.RandomState(2)
    return [np.tile(rs.randint(1, 256, size=6), 4).astype(np.int32),
            rs.randint(1, 256, size=30).astype(np.int32),
            np.tile(rs.randint(1, 256, size=5), 5).astype(np.int32),
            rs.randint(1, 256, size=9).astype(np.int32)]


def _requests(cls):
    """Greedy (rid 0, 2) and seeded top-p (rid 1, 3) requests."""
    return [cls(rid=i, prompt_ids=p, max_new_tokens=16,
                temperature=1.5 if i % 2 else 0.0, top_p=0.8, seed=7 + i)
            for i, p in enumerate(_prompts())]


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = _jax_tree(jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _env():
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_GRACEFUL", "0")
    mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    mp.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", raising=False)
    return mp


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine on the request stream in each of ``RUNS``: label ->
    (engine, tokens, stats).  The ``SNAP_RUN`` serve is stepped by hand and
    snapshotted (JSON) after ``SNAP_STEPS`` steps: ``"snapshot"`` -> the
    JSON text."""
    jcfg, jparams, _, _ = models
    mp = _env()
    runs = {}
    for label in JAX_RUNS:
        quant, feats, _ = RUNS[label]
        eng = JEngine(jcfg, jparams, paged=True, quant=quant, **ENGINE,
                      **feats)
        reqs = _requests(JRequest)
        for r in reqs:
            eng.add_request(r)
        for n in range(10_000):
            if n == SNAP_STEPS and label == SNAP_RUN:
                runs["snapshot"] = json.dumps(eng.snapshot())
            if not eng.step() and not eng._queue:
                break
        runs[label] = (eng, {r.rid: r.output_ids for r in reqs},
                       {k: eng.stats[k] for k in STATS})
    mp.undo()
    return runs


def _port_engine(models, quant, **feats):
    _, _, tcfg, tparams = models
    mp = _env()
    try:
        return tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                                 device="cpu",
                                                 quant=quant, **ENGINE,
                                                 **feats)
    finally:
        mp.undo()


@pytest.mark.parametrize("label", list(RUNS))
def test_quant_engine_matches_jax(models, jax_runs, label):
    """Tokens equal the JAX engine's, and the step statistics too where it
    ran the same configuration; every decode step of every layer took the
    fused decode step, none the fused MLP."""
    quant, feats, against = RUNS[label]
    eng = _port_engine(models, quant, **feats)
    tk.reset_counters()
    got = eng.serve(_requests(TRequest))
    _, want, jstats = jax_runs[against]
    assert got == want
    st = {k: eng.stats[k] for k in STATS}
    if against == label:
        assert st == jstats
    L = eng.cfg.num_hidden_layers
    fused = ("fused_decode_step" if feats.get("kv_quant") is None
             else "fused_quant_decode_step")
    plain_steps = st["decode_steps"] - st["mixed_steps"] - st["spec_steps"]
    assert plain_steps > 0
    assert tk.PLAIN_CALLS[fused] == L * plain_steps
    assert tk.PLAIN_CALLS["fused_layer_mlp"] == 0
    if "enable_speculation" in feats:
        assert st["mixed_steps"] > 0 and st["spec_steps"] > 0
    if "enable_prefix_caching" in feats:
        assert st["prefix_hits"] > 0
    cached = list(eng._pcache.resident_pages()) if eng._pcache else []
    assert sorted(eng._free + cached) == list(range(eng.num_blocks))


def test_fused_mlp_off_under_quant(models, jax_runs):
    """Under ``quant`` the fused MLP half is off in both packages and the
    fused decode arm is still chosen; without it the fused MLP is on."""
    for quant in QUANTS:
        eng = _port_engine(models, quant)
        assert eng._fused and not eng._fused_mlp
        assert eng.quant == quant
        assert isinstance(eng.params["layers"]["w_up"], dict)
        assert not jax_runs[f"{quant}_bucketed_" + (
            "prefix" if quant == "int8" else "kv8")][0]._fused_mlp
    fp = _port_engine(models, None)
    assert fp._fused and fp._fused_mlp
    with pytest.raises(KeyError):
        _port_engine(models, "int2")


def test_quant_snapshot_restores_across_packages(models, jax_runs):
    """A JSON snapshot of the quantized JAX engine restores on a fresh
    port engine, and the port's snapshot at the same step (the same JSON)
    on the JAX engine; each finishes with the uninterrupted serve's tokens.
    Restoring on an engine of another ``quant`` raises, naming it."""
    quant, feats, _ = RUNS[SNAP_RUN]
    jeng, want, _ = jax_runs[SNAP_RUN]
    src = _port_engine(models, quant, **feats)
    reqs = _requests(TRequest)
    for r in reqs:
        src.add_request(r)
    for _ in range(SNAP_STEPS):
        src.step()
    snap = json.dumps(src.snapshot())
    assert snap == jax_runs["snapshot"]
    j = json.loads(snap)
    assert j["engine"]["quant"] == quant
    assert j["queued"] and any(e["output_ids"] for e in j["running"])
    done = {r.rid: r.output_ids for r in reqs if r.finished}
    for side in ("port", "jax"):
        if side == "port":
            eng = _port_engine(models, quant, **feats)
            restored = eng.restore(json.loads(jax_runs["snapshot"]))
        else:
            # the JAX run's own engine, idle after its serve: its compiled
            # steps are reused
            mp = _env()
            eng = jeng
            restored = eng.restore(json.loads(snap))
        while eng.step() or eng._queue:
            pass
        if side == "jax":
            mp.undo()
        got = {**done, **{r.rid: r.output_ids for r in restored}}
        assert got == want, side
    for other in ("int4", None):
        with pytest.raises(ValueError, match="quant"):
            _port_engine(models, other, **feats).restore(json.loads(snap))
    with pytest.raises(ValueError, match="quant"):
        jax_runs["int4_bucketed_kv8"][0].restore(
            json.loads(json.dumps(_port_engine(
                models, "int8", kv_quant="int8").snapshot())))


def test_cb_engine_int8_serves():
    """The reference's ``test_cb_engine_int8_serves`` on the port (paged;
    the reference's tiny bf16 model, from the port's initializer): three
    requests through an int8 engine of two slots, four tokens each, the
    first one's greedy stream the fp engine's."""
    tcfg = tllama.LlamaConfig.tiny(vocab=64, hidden=32, layers=2, heads=4,
                                   kv_heads=2, inter=64)
    params = tllama.init_params(tcfg, seed=0, device="cpu")
    eng = tserving.ContinuousBatchingEngine(tcfg, params, paged=True,
                                            max_batch=2,
                                            max_seq=64, chunk=2,
                                            quant="int8", device="cpu")
    reqs = [TRequest(rid=i, prompt_ids=np.arange(1, 6, dtype=np.int32),
                     max_new_tokens=4) for i in range(3)]
    got = eng.serve(reqs)
    assert all(len(v) == 4 for v in got.values())
    fp = tserving.ContinuousBatchingEngine(tcfg, params, paged=True,
                                           max_batch=2,
                                           max_seq=64, chunk=2, device="cpu")
    ref = fp.serve([TRequest(rid=9, prompt_ids=np.arange(1, 6,
                                                         dtype=np.int32),
                             max_new_tokens=4)])
    assert got[0] == ref[9]
