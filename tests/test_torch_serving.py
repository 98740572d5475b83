"""The port's serving slice against the JAX engine on the CPU.

Same f32 tiny Llama (``LlamaConfig.tiny`` with dtype float32), the JAX
parameter tree bridged through ``paddle_tpu_torch.utils.convert``, the same
requests (prompts from a seeded numpy RNG):

- greedy token streams are identical to ``paddle_tpu``'s
  ``ContinuousBatchingEngine(paged=True)`` (fused decode + fused MLP, Pallas
  in interpret mode), with a pool small enough that both engines preempt;
- the sampler's threefry keys are bit-equal to ``jax.random``'s and its
  Gumbel noise equal to within float32 rounding of ``log``; seeded sampled
  (temperature + top-p) streams are identical to the JAX engine's, also
  across a preemption; the ``GenerationEngine``'s ``split`` /
  ``categorical`` draws equal ``jax.random``'s in float32 and bfloat16;
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
from paddle_tpu_torch.ops.kernels import sampling as tsampling
from paddle_tpu_torch.utils import threefry
from paddle_tpu_torch.utils.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

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
    teng = tserving.ContinuousBatchingEngine(tcfg, tparams, paged=True,
                                             device="cpu",
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


@pytest.mark.parametrize("seed,pos", [(0, 0), (7, 33), (-5, 100),
                                      (2**31 - 1, 2047), (-2**31, 5)])
def test_threefry_keys_and_gumbel_match_jax(seed, pos):
    """Keys bit-equal, the uniform bits under the noise bit-equal, the
    Gumbel noise within 1e-6: ``log`` is the platform's (XLA's CPU, GPU
    and TPU logs differ among themselves in the last bit), and a last-bit
    difference in the inner log moves ``-log(-log(u))`` by up to ~2^-23
    absolute where the noise is near 0."""
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0),
                                                 jnp.int32(seed)),
                              jnp.int32(pos))
    key = threefry.sample_keys(np.int32(seed), np.int32(pos))
    np.testing.assert_array_equal(key.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    n = 4099
    tiny = float(np.finfo(np.float32).tiny)
    want_u = np.asarray(jax.random.uniform(jkey, (n,), jnp.float32,
                                           minval=tiny))
    got_u = threefry.uniform(key, n, tiny).numpy()
    np.testing.assert_array_equal(got_u.view(np.uint32),
                                  want_u.view(np.uint32))
    want_g = np.asarray(jax.random.gumbel(jkey, (n,), jnp.float32))
    got_g = threefry.gumbel(key, n).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)


def test_gumbel_noise_rows_match_jax():
    """The sampler's batched draw (int32 seeds and int64 positions as the
    engine holds them, one row per sampled lane) is each row's
    ``jax.random.gumbel`` under its key, to the tolerance above."""
    seeds, pos, n = [3, -7, 2**31 - 1], [0, 41, 2047], 1000
    got = tsampling.gumbel_noise(torch.tensor(seeds, dtype=torch.int32),
                                 torch.tensor(pos), n).numpy()
    for row, (s, p) in enumerate(zip(seeds, pos)):
        jkey = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), jnp.int32(s)), jnp.int32(p))
        want = np.asarray(jax.random.gumbel(jkey, (n,), jnp.float32))
        np.testing.assert_allclose(got[row], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3, -7, 2**31 - 1])
def test_split_and_categorical_match_jax(seed):
    """The ``GenerationEngine`` sampler's chain, ``key(seed)`` -> ``split``
    -> ``categorical(sub, logits / temperature)``, over three splits and
    [4, 4099] logits in float32 and bfloat16: every key bit-equal, every
    drawn token equal; for bfloat16 the uniform bits and the Gumbel noise
    bit-equal too (its ``log`` is taken in float32 and rounded to 8
    mantissa bits, which hides the platforms' last-bit differences)."""
    jkey, key = jax.random.key(seed), threefry.prng_key(np.int32(seed))
    rs = np.random.RandomState(seed & 0xFFFF)
    n = 4 * 4099
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        key, sub = threefry.split(key)
        for j, t in ((jkey, key), (jsub, sub)):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jax.random.key_data(j)).astype(np.int64))
        logits = (rs.standard_normal((4, 4099)) * 3).astype(np.float32)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = jax.random.categorical(
                jsub, jnp.asarray(logits).astype(jdt) / 0.8, axis=-1)
            got = threefry.categorical(
                sub, torch.as_tensor(logits).to(tdt) / 0.8)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tiny = float(jnp.finfo(jnp.bfloat16).tiny)
        want_u = np.asarray(jax.random.uniform(jsub, (n,), jnp.bfloat16,
                                               minval=tiny))
        got_u = threefry.uniform(sub, n, tiny, torch.bfloat16)
        np.testing.assert_array_equal(got_u.view(torch.int16).numpy(),
                                      want_u.view(np.int16))
        want_g = np.asarray(jax.random.gumbel(jsub, (n,), jnp.bfloat16))
        got_g = threefry.gumbel(sub, n, torch.bfloat16)
        np.testing.assert_array_equal(got_g.view(torch.int16).numpy(),
                                      want_g.view(np.int16))


def test_sampled_tokens_identical_to_jax_with_preemption(models):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(1, (31, 31, 12))
    temps = (0.0, 1.5, 1.5)
    seeds = (7, -3, 2**31 - 1)

    def reqs(cls):
        return [cls(rid=i, prompt_ids=p, max_new_tokens=8, temperature=t,
                    top_p=0.8, seed=s)
                for i, (p, t, s) in enumerate(zip(prompts, temps, seeds))]

    jeng = ContinuousBatchingEngine(jcfg, jparams, paged=True, **ENGINE)
    want = jeng.serve(reqs(Request))

    def run(num_blocks):
        eng = tserving.ContinuousBatchingEngine(
            tcfg, tparams, paged=True, device="cpu", **{**ENGINE,
                                            "num_blocks": num_blocks})
        return eng.serve(reqs(tserving.Request)), eng.stats["preemptions"]

    tk.reset_counters()
    got, pre = run(5)
    assert tk.PLAIN_CALLS["gumbel_noise"] > 0
    again, pre_roomy = run(8)
    assert pre > 0 and pre_roomy == 0 and jeng.stats["preemptions"] > 0
    assert got == want, "sampled streams are the JAX engine's tokens"
    assert again == want, "and replay across a preemption"
    assert got[1] != want[0] and got[1] != got[2], "the draws differ"


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
