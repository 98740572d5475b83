"""The port's chunked-prefill mixed step and n-gram speculation against the
JAX package on the CPU.

The JAX walks run as the JAX package's own tests run them here (Pallas in
interpret mode).  Its engines run through its plain references
(``PADDLE_TPU_DISABLE_PALLAS=paged_attention``: the gather oracles of the
decode, prefill and verify walks, each arm's pool bytes the fused arm's by
the reference's own guarantee), which keeps four engine runs inside the
test budget, and with ``PADDLE_TPU_GRACEFUL=0``: faults raise, and a
chunked admission maps its whole prompt's pages at once.  The port's engine
runs in the same mode for the comparisons, and once more in its default
graceful mode (chunk-by-chunk page mapping), whose tokens must be the same.
The port's side runs its plain PyTorch versions (CPU
tensors always take them; ``chip_smoke.py`` and ``test_torch_cuda.py``
hold the CUDA kernels against them on the card).  Inputs are f32, made with
numpy from a seed, handed to both.

- the ragged multi-row walks' plain versions (``paged_attention_prefill``
  over fp, int8 and int4 pools; ``paged_attention_verify``) against the
  Pallas kernels: a decode lane, a chunk that crosses a page, a ragged
  chunk over a long prefix, an inactive lane; rows past q_len exactly 0;
- ``NGramDrafter`` exact against the reference's;
- the engine on one request stream (greedy and seeded top-p, prompts that
  repeat themselves so the drafter proposes, a pool small enough that a
  slot is preempted while its prompt streams in): chunked, speculative and
  both together, token-identical to the JAX engine in the same mode and to
  the JAX bucketed speculation-off engine, with equal step statistics and
  launch counts by kind; on int8 pools (chunked + speculation: the mixed
  step, and the verify step through the prefill walk with rejected drafts
  left in their pages) tokens and pool codes equal to the JAX engine's,
  tokens also to its bucketed engine's; on int4 pools the same against the
  JAX engine's int4 run;
- EOS under speculation cuts each stream where the bucketed one ends;
- the kill switches and the validation errors.

Tolerance: attention outputs at atol = rtol = 1e-5 (sums in other orders);
tokens and codes exact; scales within rtol 1e-5 (test_torch_kv_quant.py).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine, Request
from paddle_tpu.inference.speculative import NGramDrafter as JDrafter
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.inference.speculative import NGramDrafter as TDrafter
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
f32 = np.float32
# two slots, 8-token pages, an 8-page pool: a 30-token prompt streaming at
# <= 8 rows a step (budget 5) is preempted while an older slot decodes
ENGINE = dict(max_batch=2, max_seq=64, chunk=2, block_size=8, num_blocks=8)
CHUNKED = dict(enable_chunked_prefill=True, prefill_chunk=8, token_budget=5)
SPEC = dict(enable_speculation=True, num_draft_tokens=4, spec_ngram=3)
STATS = ("decode_steps", "decode_tokens", "prefills", "preemptions",
         "decode_stall_steps", "mixed_steps", "prefill_chunks", "spec_steps",
         "spec_drafted_tokens", "spec_accepted_tokens",
         "spec_rejected_tokens")


# ---------------------------------------------------------------------------
# the multi-row walks
# ---------------------------------------------------------------------------

def _rows_case(mode, T, lens, q_lens, seed):
    """b = len(lens) lanes, 4/2 heads, head_dim 16, block 8, 6 table
    pages; lane i owns its live pages of a shuffled 24-page pool, the rest
    of its table the sentinel 24 (the engine's spill page, zeros); a lane of
    length 1 owns none (an inactive lane reads the spill page)."""
    rs = np.random.RandomState(seed)
    b, nh, nkv, hd, bs, mb, nb = len(lens), 4, 2, 16, 8, 6, 24
    q = rs.randn(b, T, nh, hd).astype(f32)
    kc = rs.randn(nb + 1, nkv, bs, hd).astype(f32)
    vc = rs.randn(nb + 1, nkv, bs, hd).astype(f32)
    kc[nb] = vc[nb] = 0
    ks = vs = None
    if mode:
        enc = jax.jit(lambda x: jpa.quantize_kv_cache(x, mode))
        kc, ks = (np.asarray(a) for a in enc(jnp.asarray(kc)))
        vc, vs = (np.asarray(a) for a in enc(jnp.asarray(vc)))
    perm = rs.permutation(nb).astype(np.int32)
    tables = np.full((b, mb), nb, np.int32)
    for i, n in enumerate(lens):
        n = -(-n // bs) if n > 1 else 0
        tables[i, :n] = perm[i * mb:i * mb + n]
    return (q, kc, vc, tables, np.asarray(lens, np.int32),
            np.asarray(q_lens, np.int32), ks, vs)


#: a decode lane; a 6-row chunk at positions 5..10 (crossing page 0 -> 1);
#: a ragged 3-row final chunk over a 37-token prefix; an inactive lane
ROWS = dict(T=6, lens=[30, 11, 40, 1], q_lens=[1, 6, 3, 1])


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_prefill_walk_matches_pallas(mode):
    q, kc, vc, tables, lens, qlens, ks, vs = _rows_case(mode, seed=0, **ROWS)
    want = np.asarray(jpa.paged_attention_prefill(
        *map(jnp.asarray, (q, kc, vc, tables, lens, qlens)), kv_quant=mode,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs)))
    tk.reset_counters()
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    got = tda.paged_prefill_attention(
        *map(t, (q, kc, vc, tables, lens, qlens)), kv_quant=mode,
        k_scale=t(ks), v_scale=t(vs)).numpy()
    assert tk.PLAIN_CALLS["paged_prefill"] == 1
    for i, n in enumerate(qlens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)
        assert (got[i, n:] == 0).all() and (want[i, n:] == 0).all()


def test_verify_walk_matches_pallas():
    """The K + 1 = 5 row verify over fp pools, ragged q_lens."""
    q, kc, vc, tables, lens, qlens, _, _ = _rows_case(
        None, 5, [5, 30, 8, 17], [5, 1, 3, 5], seed=1)
    want = np.asarray(jpa.paged_attention_verify(
        *map(jnp.asarray, (q, kc, vc, tables, lens, qlens))))
    tk.reset_counters()
    got = tda.paged_verify_attention(
        *map(torch.from_numpy, (q, kc, vc, tables, lens, qlens))).numpy()
    assert tk.PLAIN_CALLS["paged_verify"] == 1
    for i, n in enumerate(qlens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)
        assert (got[i, n:] == 0).all() and (want[i, n:] == 0).all()


def test_ngram_drafter_matches_jax():
    rs = np.random.RandomState(2)
    contexts = [rs.randint(0, 6, size=n) for n in (1, 2, 3, 7, 20, 60)]
    contexts += [np.tile(rs.randint(0, 50, size=5), 4)[:-2],
                 np.arange(10), np.array([3, 3, 3, 3])]
    for k, n in ((4, 3), (1, 1), (6, 2)):
        jd, td = JDrafter(k, n), TDrafter(k, n)
        for ctx in contexts:
            want, got = jd.propose(ctx), td.propose(ctx)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="num_draft_tokens"):
        TDrafter(0)


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
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX engine on the request stream, once per mode (shared by the
    tests below): label -> (tokens, stats, pools).  Chunked + speculation
    runs on int8 and int4 pools only: its routing reads no pool bytes, and
    on this stream its int8 tokens are the fp engines' too, so the int8
    run is the reference of the fp combined mode as well, and the fp
    bucketed run the int8 engine's bucketed reference (two JAX engine runs
    less)."""
    jcfg, jparams, _, _ = models
    mp = pytest.MonkeyPatch()
    mp.setenv("PADDLE_TPU_GRACEFUL", "0")
    mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "paged_attention")
    runs = {}
    for label, kv_quant, feats in (("bucketed", None, {}),
                                   ("chunked", None, CHUNKED),
                                   ("spec", None, SPEC),
                                   ("both_int8", "int8", {**CHUNKED, **SPEC}),
                                   ("both_int4", "int4", {**CHUNKED, **SPEC})):
        eng = ContinuousBatchingEngine(jcfg, jparams, paged=True,
                                       kv_quant=kv_quant, **ENGINE, **feats)
        out = eng.serve(_requests(Request))
        runs[label] = (out, {k: eng.stats[k] for k in STATS},
                       (eng.cache_k, eng.cache_v))
    mp.undo()
    return runs


def _serve_port(models, kv_quant=None, graceful=False, **feats):
    """The port's engine on the request stream, graceful off as the JAX
    runs (``graceful=True``: its default mode)."""
    _, _, tcfg, tparams = models
    with pytest.MonkeyPatch.context() as mp:
        if not graceful:
            mp.setenv("PADDLE_TPU_GRACEFUL", "0")
        eng = tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                                device="cpu",
                                                kv_quant=kv_quant, **ENGINE,
                                                **feats)
    streaming_victims = []
    preempt = eng._preempt

    def spy(slot):    # was the victim still streaming its prompt in?
        streaming_victims.append(eng._chunked
                                 and eng._prefill_ids[slot] is not None)
        preempt(slot)

    eng._preempt = spy
    tk.reset_counters()
    out = eng.serve(_requests(tserving.Request))
    return out, eng, dict(tk.PLAIN_CALLS), streaming_victims


@pytest.mark.parametrize("label", ["chunked", "spec", "both"])
def test_engine_modes_match_jax(models, jax_runs, label, monkeypatch):
    """Each mode: tokens and step statistics equal the JAX engine's in that
    mode (for chunked + speculation its int8 run's, see ``jax_runs``),
    tokens equal the bucketed speculation-off engine's, and the
    launch counts by kind prove the routing: every layer of every mixed
    step took ``paged_prefill``, of every verify step ``paged_verify``,
    and the remaining decode steps the fused decode step."""
    monkeypatch.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", raising=False)
    feats = {"chunked": CHUNKED, "spec": SPEC,
             "both": {**CHUNKED, **SPEC}}[label]
    got, eng, calls, victims = _serve_port(models, **feats)
    want, jstats, _ = jax_runs["both_int8" if label == "both" else label]
    assert got == want
    assert got == jax_runs["bucketed"][0]
    st = {k: eng.stats[k] for k in STATS}
    assert st == jstats
    L = eng.cfg.num_hidden_layers
    mixed, spec = st["mixed_steps"], st["spec_steps"]
    assert calls["paged_prefill"] == L * mixed
    assert calls["paged_verify"] == L * spec
    assert calls["fused_decode_step"] == L * (st["decode_steps"] - mixed
                                              - spec)
    if "enable_chunked_prefill" in feats:
        assert mixed > 0 and st["prefills"] == 0
        assert st["decode_stall_steps"] == 0
        assert any(victims), "a slot was preempted mid-prefill"
    if "enable_speculation" in feats:
        assert spec > 0 and st["spec_rejected_tokens"] > 0
        # accepted drafts: a verify step banked a run of tokens
        assert st["spec_accepted_tokens"] > 0
        assert (st["spec_accepted_tokens"] + st["spec_rejected_tokens"]
                == st["spec_drafted_tokens"])
        assert eng.spec_acceptance_rate == (st["spec_accepted_tokens"]
                                            / st["spec_drafted_tokens"])
    assert sorted(eng._free) == list(range(eng.num_blocks))


@pytest.mark.parametrize("label,kv_quant", [("chunked", None),
                                            ("spec", None),
                                            ("both", None),
                                            ("both", "int8")])
def test_graceful_engine_tokens_match(models, jax_runs, label, kv_quant):
    """The port's default engine (graceful: the NaN/inf guard on every
    step, a streaming prompt's pages mapped chunk by chunk) emits the
    tokens of the graceful-off JAX run on the same stream, and fails
    nothing."""
    feats = {"chunked": CHUNKED, "spec": SPEC,
             "both": {**CHUNKED, **SPEC}}[label]
    got, eng, _, _ = _serve_port(models, kv_quant=kv_quant, graceful=True,
                                 **feats)
    assert eng._graceful
    want = jax_runs["both_int8" if label == "both" else label][0]
    assert got == want
    assert eng.stats["requests_failed"] == eng.stats["nan_guard_trips"] == 0
    assert sorted(eng._free) == list(range(eng.num_blocks))


def test_int8_chunked_spec_matches_jax_pools(models, jax_runs):
    """On int8 pools, chunked + speculation: tokens and statistics equal
    the JAX engine's, the verify step goes through the prefill walk, and
    the pools' codes over the first num_blocks pages are equal (rejected
    drafts' stale rows included: they take part in their page's
    requantize in both), with the scales within rtol 1e-5.  On this
    stream the tokens also equal the JAX bucketed engine's (requantizing
    per write event can move a code, so the reference guarantees this
    only between the arms of one configuration)."""
    got, eng = _check_quant_chunked_spec(models, jax_runs, "int8")
    assert got == jax_runs["bucketed"][0]


def test_int4_chunked_spec_matches_jax_pools(models, jax_runs):
    """The int8 test's checks on packed-int4 pools, against the JAX
    engine's int4 run: tokens and statistics equal, the verify step
    through the prefill walk, codes over the first num_blocks pages equal
    and scales within rtol 1e-5."""
    _check_quant_chunked_spec(models, jax_runs, "int4")


def _check_quant_chunked_spec(models, jax_runs, kv_quant):
    """The port's chunked + speculative engine on ``kv_quant`` pools held
    to the JAX engine's run on the same pools; returns its tokens and
    engine."""
    got, eng, calls, victims = _serve_port(models, kv_quant=kv_quant,
                                           **CHUNKED, **SPEC)
    want, jstats, jpools = jax_runs[f"both_{kv_quant}"]
    assert got == want
    st = {k: eng.stats[k] for k in STATS}
    assert st == jstats
    assert st["spec_rejected_tokens"] > 0 and any(victims)
    assert st["spec_accepted_tokens"] > 0
    L = eng.cfg.num_hidden_layers
    assert calls["paged_prefill"] == L * (st["mixed_steps"]
                                          + st["spec_steps"])
    assert calls["paged_verify"] == 0
    nb = eng.num_blocks
    for tpool, jpool in zip((eng.cache_k, eng.cache_v), jpools):
        ref = params_from_numpy(jpool, device="cpu")
        assert torch.equal(tpool["q"][:, :nb], ref["q"][:, :nb])
        torch.testing.assert_close(tpool["scale"][:, :nb],
                                   ref["scale"][:, :nb], rtol=1e-5, atol=0)
    return got, eng


def test_kill_switches_and_validation(models, jax_runs, monkeypatch):
    """``PADDLE_TPU_SPECULATE=0`` / ``PADDLE_TPU_CHUNKED_PREFILL=0`` turn
    the features off whatever the arguments say (even an invalid
    prefill_chunk is then not read) and the engine serves the bucketed
    stream; a value other than 0/1 warns and keeps the default; a
    prefill_chunk below 1 raises."""
    _, _, tcfg, tparams = models
    monkeypatch.setenv("PADDLE_TPU_SPECULATE", "0")
    monkeypatch.setenv("PADDLE_TPU_CHUNKED_PREFILL", "0")
    eng = tserving.ContinuousBatchingEngine(
        tcfg, tparams, paged=True, device="cpu", **ENGINE, **SPEC,
        **{**CHUNKED, "prefill_chunk": 0})
    assert eng._spec is None and not eng._chunked
    assert eng.serve(_requests(tserving.Request)) == jax_runs["bucketed"][0]
    assert eng.stats["mixed_steps"] == eng.stats["spec_steps"] == 0
    monkeypatch.setenv("PADDLE_TPU_CHUNKED_PREFILL", "off")
    with pytest.warns(UserWarning, match="PADDLE_TPU_CHUNKED_PREFILL"):
        eng = tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                                device="cpu",
                                                **ENGINE, **CHUNKED)
    assert eng._chunked and eng._token_budget == 5
    monkeypatch.delenv("PADDLE_TPU_CHUNKED_PREFILL")
    monkeypatch.delenv("PADDLE_TPU_SPECULATE")
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                          device="cpu",
                                          **ENGINE, enable_chunked_prefill=True,
                                          prefill_chunk=0)
    eng = tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                            device="cpu",
                                            **ENGINE,
                                            enable_chunked_prefill=True)
    assert eng._token_budget == 128 + ENGINE["max_batch"]
    eng = tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                            device="cpu",
                                            **ENGINE, **SPEC)
    assert eng._spec_qmax == 5 and eng.spec_acceptance_rate == 0.0


def test_spec_eos_trims_as_bucketed(models, jax_runs):
    """EOS ends a speculative stream where it ends the bucketed one (the
    verify step banks its run token by token and retires at EOS): for
    EOS tokens taken from the greedy request's bucketed stream, every
    speculative stream is the JAX bucketed stream cut after its first
    EOS, with verify steps run."""
    _, _, tcfg, tparams = models
    streams = jax_runs["bucketed"][0]
    for eos in streams[0][2:14:3]:
        eng = tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                                device="cpu",
                                                **ENGINE, **SPEC)
        reqs = _requests(tserving.Request)
        for r in reqs:
            r.eos_token_id = eos
        got = eng.serve(reqs)
        assert eng.stats["spec_steps"] > 0
        assert got == {rid: s[:s.index(eos) + 1] if eos in s else s
                       for rid, s in streams.items()}
        assert got[0][-1] == eos
