"""The port's training step against ``paddle_tpu``'s on the CPU.

Same f32 tiny Llama (``LlamaConfig.tiny`` with dtype float32), the JAX
parameter tree and optimizer state bridged through
``paddle_tpu_torch.utils.convert``, the same batch (ids and labels from a
seeded numpy RNG).  The JAX side is ``build_train_step`` on a 1-device
``make_mesh``, flash attention in Pallas interpret mode; one compiled step
gives the reference's loss, gnorm and state, and its gradients are read
back from the first moment (``m = (1 - beta1) * g * clip_scale`` after
one step from zeros, exact to f32 rounding).

Tolerances: atol = rtol = 1e-5 for the loss and gnorm; per leaf,
``|d| <= 1e-5 |ref| + 1e-6 max|ref|`` for gradients and moments (the two
sides sum in other orders).  New parameters: AdamW's first update is
``lr * m_hat / (sqrt(v_hat) + eps) ~ lr * sign(g)``, so where a gradient
element is within float noise of 0 its sign, and the update, may flip:
there the parameters agree within 2 * lr, elsewhere (``|g| > 1e-6
max|g|``) at atol = rtol = 1e-5 (near ``|g| ~ eps`` the update amplifies
the gradients' relative noise, so the per-leaf bound is too tight).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.utils import convert

B, S, LR, BETA1 = 2, 16, 3e-4, 0.9


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= lim).all(), (
        name, float(np.abs(got - want).max()), float(np.abs(want).max()))


@pytest.fixture(scope="module")
def ref():
    """The reference's first train step from init: inputs, the state
    before and after, its loss and its gradients."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(), dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    rs = np.random.RandomState(0)
    ids = rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    step, opt_init, _, _ = jllama.build_train_step(jcfg, jllama.make_mesh(),
                                                   lr=LR, beta1=BETA1)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    p0 = to_np(jparams)
    o0 = to_np(opt_init(jparams))
    loss, p1, o1 = step(jax.tree_util.tree_map(jnp.asarray, p0),
                        jax.tree_util.tree_map(jnp.asarray, o0),
                        jnp.asarray(ids), jnp.asarray(labels))
    p1, o1 = to_np(p1), to_np(o1)
    gnorm = float(o1["gnorm"])
    clip = min(1.0, 1.0 / max(gnorm, 1e-6))
    grads = jax.tree_util.tree_map(
        lambda m: m / np.float32(1 - BETA1) / np.float32(clip), o1["m"])
    return dict(tcfg=tcfg, ids=ids, labels=labels, p0=p0, o0=o0,
                loss=float(loss), p1=p1, o1=o1, grads=grads)


def _torch_loss_and_grads(r):
    params = convert.params_from_numpy(r["p0"], device="cpu")
    leaves = tllama.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(r["tcfg"], params, torch.from_numpy(r["ids"]),
                          torch.from_numpy(r["labels"]))
    return loss, torch.autograd.grad(loss, leaves)


def test_loss_and_grads_match_jax(ref, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_REMAT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_XENT_CHUNK", raising=False)
    tk.reset_counters()
    loss, grads = _torch_loss_and_grads(ref)
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=1e-5,
                               rtol=1e-5)
    want = tllama.tree_leaves(ref["grads"])
    assert len(grads) == len(want) == 12
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), w, f"grad leaf {i}")
    # full recompute: each layer's flash forward runs again in the backward
    L = ref["tcfg"].num_hidden_layers
    assert (tk.PLAIN_CALLS["flash_attention_fwd"],
            tk.PLAIN_CALLS["flash_attention_dkv"],
            tk.PLAIN_CALLS["flash_attention_dq"]) == (2 * L, L, L)


@pytest.mark.parametrize("variant", ["remat_none", "remat_dots",
                                     "xent_chunk_8"])
def test_recompute_policies_and_chunked_xent_keep_loss_and_grads(
        ref, variant, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_REMAT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_XENT_CHUNK", raising=False)
    loss0, grads0 = _torch_loss_and_grads(ref)
    if variant.startswith("remat"):
        monkeypatch.setenv("PADDLE_TPU_REMAT", variant.split("_")[1])
    else:
        monkeypatch.setenv("PADDLE_TPU_XENT_CHUNK", "8")
    tk.reset_counters()
    loss, grads = _torch_loss_and_grads(ref)
    L = ref["tcfg"].num_hidden_layers
    fwd = tk.PLAIN_CALLS["flash_attention_fwd"]
    assert fwd == (L if variant == "remat_none" else 2 * L)
    np.testing.assert_allclose(loss.item(), loss0.item(), atol=1e-6,
                               rtol=1e-6)
    for a, b in zip(grads, grads0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7,
                                   rtol=1e-6)


def test_train_step_matches_jax(ref):
    tcfg = ref["tcfg"]
    step, opt_init = tllama.build_train_step(tcfg, lr=LR, beta1=BETA1)
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    opt = convert.opt_state_from_numpy(ref["o0"], device="cpu")
    fresh = opt_init(convert.params_from_numpy(ref["p0"], device="cpu"))
    for a, b in zip(tllama.tree_leaves(fresh), tllama.tree_leaves(opt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    loss, new_params, new_opt = step(params, opt,
                                     torch.from_numpy(ref["ids"]),
                                     torch.from_numpy(ref["labels"]))
    assert new_params is params and new_opt is opt      # updated in place
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=1e-5,
                               rtol=1e-5)
    got = convert.opt_state_to_numpy(new_opt)
    want = ref["o1"]
    assert got["step"] == want["step"] == 1
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], atol=1e-5,
                               rtol=1e-5)
    grads = tllama.tree_leaves(ref["grads"])
    for key in ("m", "v"):
        for i, (a, b) in enumerate(zip(tllama.tree_leaves(got[key]),
                                       tllama.tree_leaves(want[key]))):
            _close(a, b, f"{key} leaf {i}")
    for tree, wtree in ((got["master"], want["master"]),
                        (convert.params_to_numpy(new_params), ref["p1"])):
        for i, (a, b, g) in enumerate(zip(tllama.tree_leaves(tree),
                                          tllama.tree_leaves(wtree),
                                          grads)):
            live = np.abs(g) > 1e-6 * np.abs(g).max()
            np.testing.assert_allclose(a[live], b[live], atol=1e-5,
                                       rtol=1e-5, err_msg=f"param leaf {i}")
            assert (np.abs(a - b)[~live] <= 2 * LR).all()


def test_flops_and_param_count_match_jax(ref):
    jcfg = dataclasses.replace(jllama.LlamaConfig.llama3_8b(),
                               num_hidden_layers=4)
    tcfg = dataclasses.replace(tllama.LlamaConfig.llama3_8b(),
                               num_hidden_layers=4)
    assert tllama.flops_per_token(tcfg) == jllama.flops_per_token(jcfg)
    assert (tllama.attn_flops_per_token(tcfg, 2048)
            == jllama.attn_flops_per_token(jcfg, 2048))
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    assert tllama.count_params(params) == jllama.count_params(ref["p0"])
