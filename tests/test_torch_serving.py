"""The port's serving slice against the JAX engine on the CPU.

Same f32 tiny Llama (``LlamaConfig.tiny`` with dtype float32), the JAX
parameter tree bridged through ``paddle_tpu_torch.utils.convert``, the same
requests (prompts from a seeded numpy RNG):

- greedy token streams are identical to ``paddle_tpu``'s
  ``ContinuousBatchingEngine(paged=True)`` (fused decode + fused MLP, Pallas
  in interpret mode), with a pool small enough that both engines preempt;
- sampled tokens lie inside each step's nucleus (top-p mask computed from
  the JAX model's logits with the reference's formula): the port draws
  from torch generators, not JAX's threefry keys, so sampled streams are
  not token-identical to JAX's; they are replayable, also across a
  preemption;
- the decoder seams match the JAX ones within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.inference.serving import ContinuousBatchingEngine, Request
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.inference import serving as tserving
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.utils.convert import params_from_numpy

# max_batch 2, max_seq 64, block 16, 5 pages: two 31-token prompts fit at
# admission (2 pages each) and must grow to 3 pages each while decoding
ENGINE = dict(max_batch=2, max_seq=64, chunk=2, block_size=16, num_blocks=5)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, lens, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, size=n).astype(np.int32) for n in lens]


def test_greedy_tokens_identical_to_jax_with_preemption(models):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(0, (31, 31, 9, 20))
    jeng = ContinuousBatchingEngine(jcfg, jparams, paged=True, **ENGINE)
    assert jeng._fused and jeng._fused_mlp
    want = jeng.serve([Request(rid=i, prompt_ids=p, max_new_tokens=8)
                       for i, p in enumerate(prompts)])
    teng = tserving.ContinuousBatchingEngine(tcfg, tparams, device="cpu",
                                             **ENGINE)
    tk.reset_counters()
    got = teng.serve([tserving.Request(rid=i, prompt_ids=p, max_new_tokens=8)
                      for i, p in enumerate(prompts)])
    assert got == want
    assert jeng.stats["preemptions"] > 0 and teng.stats["preemptions"] > 0
    # every layer of every decode step went through the fused hooks
    L = tcfg.num_hidden_layers
    steps = teng.stats["decode_steps"]
    assert tk.PLAIN_CALLS["fused_decode_step"] == L * steps
    assert tk.PLAIN_CALLS["fused_layer_mlp"] == L * steps
    assert (tk.PLAIN_CALLS["rms_norm"]
            == (L + 1) * steps + (2 * L + 1) * teng.stats["prefills"])
    assert sorted(teng._free) == list(range(teng.num_blocks))
    assert (teng._table == teng.num_blocks).all()


def _nucleus(logits, temp, top_p):
    """The reference sampler's keep mask (serving.py _sample_tokens)."""
    scaled = logits.astype(jnp.float32) / max(temp, 1e-6)
    order = jnp.argsort(-scaled, axis=-1)
    sprob = jax.nn.softmax(jnp.take_along_axis(scaled, order, axis=-1), -1)
    keep_sorted = (jnp.cumsum(sprob, axis=-1) - sprob) < top_p
    keep = jnp.zeros_like(keep_sorted).at[
        jnp.arange(scaled.shape[0])[:, None], order].set(keep_sorted)
    return np.asarray(keep)


def test_sampled_tokens_inside_nucleus_and_replayable(models):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(1, (31, 31, 12))
    temps = (0.0, 1.5, 1.5)

    def run(num_blocks):
        eng = tserving.ContinuousBatchingEngine(
            tcfg, tparams, device="cpu", **{**ENGINE,
                                            "num_blocks": num_blocks})
        reqs = [tserving.Request(rid=i, prompt_ids=p, max_new_tokens=8,
                                 temperature=t, top_p=0.8, seed=7 + i)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        return eng.serve(reqs), eng.stats["preemptions"]

    got, pre = run(5)
    again, pre_roomy = run(8)
    assert pre > 0 and pre_roomy == 0
    assert got == again, "sampled streams replay across a preemption"
    for rid in (1, 2):
        seq = np.zeros(48, np.int32)   # one padded length: one compile
        seq[:prompts[rid].size + 8] = np.concatenate(
            [prompts[rid], np.asarray(got[rid], np.int32)])
        logits = jllama.forward(jcfg, jparams, jnp.asarray(seq[None]),
                                use_flash=False, remat=False)[0]
        s0 = prompts[rid].size
        keep = _nucleus(logits[s0 - 1:s0 + 7], temps[rid], 0.8)
        for i, tok in enumerate(got[rid]):
            assert keep[i, tok], f"rid {rid} token {i} outside the nucleus"
        assert keep.sum(-1).max() > 1, "the nucleus left a choice"


def test_decoder_layer_tail_matches_jax(models):
    """The post-attention seam, composed and through the fused MLP hook."""
    jcfg, jparams, tcfg, tparams = models
    rs = np.random.RandomState(4)
    h = jcfg.hidden_size
    x = rs.randn(3, 1, h).astype(np.float32)
    attn = rs.randn(3, 1, h).astype(np.float32)
    jlp = {k: v[1] for k, v in jparams["layers"].items()}
    tlp = {k: v[1] for k, v in tparams["layers"].items()}

    def jmlp(h_res, attn_y, lp):
        h1, y = jpa.fused_layer_mlp(h_res[:, 0], attn_y[:, 0],
                                    lp["post_norm"], lp["w_gate"],
                                    lp["w_up"], lp["w_down"],
                                    jcfg.rms_norm_eps)
        return h1[:, None], y[:, None]

    def tmlp(h_res, attn_y, lp):
        h1, y = tpa.fused_layer_mlp(h_res[:, 0], attn_y[:, 0],
                                    lp["post_norm"], lp["w_gate"],
                                    lp["w_up"], lp["w_down"],
                                    tcfg.rms_norm_eps)
        return h1[:, None], y[:, None]

    for jfn, tfn in ((None, None), (jmlp, tmlp)):
        want = jllama.decoder_layer_tail(jcfg, jnp.asarray(x),
                                         jnp.asarray(attn), jlp, mlp_fn=jfn)
        got = tllama.decoder_layer_tail(tcfg, torch.from_numpy(x),
                                        torch.from_numpy(attn), tlp,
                                        mlp_fn=tfn)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_init_params_shapes_and_seed(models):
    """The port's own initializer: the reference's shapes and dtypes,
    std 0.02, and the same tensors from the same seed."""
    jcfg, jparams, tcfg, _ = models
    a = tllama.init_params(tcfg, seed=3, device="cpu")
    b = tllama.init_params(tcfg, seed=3, device="cpu")
    shapes = jax.tree_util.tree_map(lambda v: tuple(v.shape), jparams)
    assert jax.tree_util.tree_map(lambda v: tuple(v.shape), a) == shapes
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert abs(a["layers"]["w_gate"].std().item() - 0.02) < 2e-3
    assert (a["final_norm"] == 1).all()
