"""The port's MoE decoder (``paddle_tpu_torch/models/moe_llama.py``)
against ``paddle_tpu/models/moe_llama.py`` on the CPU.

A tiny f32 config (``MoEConfig.tiny``: 4 experts, top-2, 2 layers), every
leaf drawn with numpy from a seed in the shapes ``jax.eval_shape`` gives
``init_params``, the same token batch.  Every JAX call is jitted and run
once in one module fixture: ``moe_ffn`` on each engine at a capacity
factor that drops pairs (dense, sort) and at one that drops none (dense,
sort, ragged), with the gradients of ``sum(out * cot) + aux + z``; the
logits; ``value_and_grad`` of ``loss_fn`` on the dense engine (the tiny
config's own); two steps of ``build_train_step`` on a one-device mesh on
the sort engine (the one DeepSeekMoE-16B's 64 experts resolve to), whose
first-step gradients are read back from the first moment (``m = (1 -
beta1) * g * clip`` after one step from zeros).  The reference's flash
attention and RMSNorm run through its plain references
(``PADDLE_TPU_DISABLE_PALLAS``), as in ``test_torch_dense_serving.py``;
the port's forward runs its plain flash and its composed attention.

Tolerances: atol = rtol = 1e-5 for outputs, losses and gnorm; per leaf
``|d| <= 1e-5 |ref| + 1e-6 max|ref|`` for gradients and moments (sums in
other orders), as ``test_torch_train.py``; the parameters after AdamW as
there: where a gradient element is within float noise of 0 its update's
sign may flip, so those elements agree within 2 lr.  Each step is held
from the reference's state before it; the port's two steps chained (its
flipped elements move its second gradients by up to 2e-5 of a leaf's
max) are held at the loss and gnorm.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import llama as jllama
from paddle_tpu.models import moe_llama as jmoe
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models import moe_llama as tmoe
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.utils import convert
from torch_threads import one_torch_thread  # noqa: F401

B, S, LR, BETA1 = 2, 16, 3e-4, 0.9
#: (engine, capacity factor): 0.5 gives cap 8 of 64 (token, k) pairs over
#: 4 experts, so queues overflow; 4.0 gives cap 64, so none can
VARIANTS = (("dense", 0.5), ("sort", 0.5), ("dense", 4.0), ("sort", 4.0),
            ("ragged", 4.0))
FFN_LEAVES = ("router", "e_gate", "e_up", "e_down")
#: the reference's plain references for its two Pallas kernels on this path
PLAIN_PALLAS = "flash_attention,rms_norm"


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= lim).all(), (
        name, float(np.abs(got - want).max()), float(np.abs(want).max()))


def _random_tree(shapes, rs):
    """Every leaf random: norms near 1, the router at 0.5 (varied
    routing), the rest at 0.05."""
    def leaf(path, sd):
        name = path[-1].key
        if name.endswith("norm"):
            x = 1.0 + 0.1 * rs.standard_normal(sd.shape)
        else:
            x = (0.5 if name == "router" else 0.05) \
                * rs.standard_normal(sd.shape)
        return x.astype(sd.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tcfg(**kw):
    return dataclasses.replace(tmoe.MoEConfig.tiny(), dtype=torch.float32,
                               **kw)


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_DISABLE_PALLAS", PLAIN_PALLAS)
        return _reference_runs()


def _reference_runs():
    jcfg = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=jnp.float32)
    rs = np.random.RandomState(0)
    p0 = _random_tree(jax.eval_shape(lambda: jmoe.init_params(jcfg)), rs)
    ids = rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels = rs.randint(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    x = rs.standard_normal((B, S, jcfg.hidden_size)).astype(np.float32)
    cot = rs.standard_normal((B, S, jcfg.hidden_size)).astype(np.float32)
    lp0 = {k: v[0] for k, v in p0["layers"].items()}

    @jax.jit
    def ffn_all(x, lp, cot):
        res = {}
        for mode, cf in VARIANTS:
            cfg = dataclasses.replace(jcfg, dispatch=mode,
                                      capacity_factor=cf)

            def f(x, sub):
                out, aux, z = jmoe.moe_ffn(cfg, x, {**lp, **sub})
                return jnp.sum(out * cot) + aux + z, (out, aux, z)

            sub = {k: lp[k] for k in FFN_LEAVES}
            (_, outs), grads = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(x, sub)
            res[f"{mode}_{cf}"] = (outs, grads)
        return res

    @jax.jit
    def dense_runs(p, ids, labels):
        return (jmoe.forward(jcfg, p, ids, use_flash=False),
                jax.value_and_grad(
                    lambda q: jmoe.loss_fn(jcfg, q, ids, labels))(p))

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    logits, dense = to_np(dense_runs(jp, ids, labels))
    ffn = to_np(ffn_all(x, lp0, cot))
    scfg = dataclasses.replace(jcfg, dispatch="sort")
    step, opt_init, shardings, _ = jmoe.build_train_step(
        scfg, jllama.make_mesh(), lr=LR, beta1=BETA1)
    # committed to the step's shardings, so its second call reuses the
    # first's compile
    p = jax.device_put(p0, shardings)
    o = opt_init(p)
    o0 = to_np(o)
    states = []
    for _ in range(2):
        loss, p, o = step(p, o, jnp.asarray(ids), jnp.asarray(labels))
        states.append((float(loss), to_np(p), to_np(o)))
    o1 = states[0][2]
    clip = min(1.0, 1.0 / max(float(o1["gnorm"]), 1e-6))
    sort = (states[0][0], jax.tree_util.tree_map(
        lambda m: m / np.float32(1 - BETA1) / np.float32(clip), o1["m"]))
    return dict(p0=p0, o0=o0, ids=ids, labels=labels, x=x, cot=cot,
                lp0=lp0, ffn=ffn, logits=logits,
                grads={"dense": dense, "sort": sort}, states=states)


def test_presets_match_reference():
    for name in ("deepseek_moe_16b", "qwen2_moe_a14b", "tiny"):
        j = dataclasses.asdict(getattr(jmoe.MoEConfig, name)())
        t = dataclasses.asdict(getattr(tmoe.MoEConfig, name)())
        assert str(j.pop("dtype").dtype) == "bfloat16"
        assert t.pop("dtype") == torch.bfloat16
        assert j == t, name
    c = tmoe.MoEConfig.deepseek_moe_16b()
    assert (c.head_dim, tmoe.resolved_dispatch(c)) == (128, "sort")


@pytest.mark.parametrize("dispatch", ["auto", "dense", "sort", "ragged",
                                      "gshard"])
@pytest.mark.parametrize("experts", [4, 9, 64])
def test_resolved_dispatch_matches_reference(dispatch, experts):
    jc = dataclasses.replace(jmoe.MoEConfig.tiny(experts=experts),
                             dispatch=dispatch)
    tc = dataclasses.replace(tmoe.MoEConfig.tiny(experts=experts),
                             dispatch=dispatch)
    try:
        want = jmoe.resolved_dispatch(jc)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmoe.resolved_dispatch(tc)
        assert str(got.value) == str(e)
    else:
        assert tmoe.resolved_dispatch(tc) == want


@pytest.mark.parametrize("mode,cf", VARIANTS,
                         ids=[f"{m}_{c}" for m, c in VARIANTS])
def test_moe_ffn_matches_reference(ref, mode, cf):
    (out_w, aux_w, z_w), (gx_w, gsub_w) = ref["ffn"][f"{mode}_{cf}"]
    cfg = _tcfg(dispatch=mode, capacity_factor=cf)
    lp = convert.params_from_numpy(ref["lp0"], device="cpu")
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    sub = [lp[k].requires_grad_(True) for k in FFN_LEAVES]
    out, aux, z = tmoe.moe_ffn(cfg, x, lp)
    np.testing.assert_allclose(out.detach().numpy(), out_w, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux.item(), aux_w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(z.item(), z_w, atol=1e-5, rtol=1e-5)
    total = (out * torch.from_numpy(ref["cot"])).sum() + aux + z
    gx, *gsub = torch.autograd.grad(total, [x] + sub)
    _close(gx.numpy(), gx_w, "dx")
    for k, g in zip(FFN_LEAVES, gsub):
        _close(g.numpy(), gsub_w[k], k)
    # the drop cases drop, the others keep every (token, k) pair
    with torch.no_grad():
        _, _, topk_i, _, _ = tmoe.route(cfg, x.reshape(B * S, -1),
                                        lp["router"])
    counts = torch.bincount(topk_i.reshape(-1), minlength=cfg.num_experts)
    cap = tmoe.capacity(cfg, B * S)
    assert cap == (8 if cf == 0.5 else 64)
    assert (int(counts.max()) > cap) == (cf == 0.5)


def test_top_k_breaks_ties_to_the_lower_index():
    p = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k(p, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    jv, ji = jax.lax.top_k(jnp.asarray(p.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches_reference(ref, use_flash):
    tk.reset_counters()
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    with torch.no_grad():
        got = tmoe.forward(_tcfg(), params, torch.from_numpy(ref["ids"]),
                           use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), ref["logits"], atol=1e-5,
                               rtol=1e-5)
    L = 2
    assert tk.PLAIN_CALLS["rms_norm"] == 2 * L + 1
    assert tk.PLAIN_CALLS["flash_attention_fwd"] == (L if use_flash else 0)


@pytest.mark.parametrize("mode", ["dense", "sort"])
def test_loss_and_grads_match_reference(ref, mode):
    """Every gradient leaf of ``loss_fn`` (ce + aux + z) under full
    recompute: dense against ``jax.value_and_grad``, sort against the
    reference train step's first gradients."""
    loss_w, grads_w = ref["grads"][mode]
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    cfg = _tcfg(dispatch=mode)
    tk.reset_counters()
    loss, grads = tmoe.loss_and_grads(cfg, params,
                                      torch.from_numpy(ref["ids"]),
                                      torch.from_numpy(ref["labels"]))
    np.testing.assert_allclose(loss.item(), float(loss_w), atol=1e-5,
                               rtol=1e-5)
    want = tllama.tree_leaves(grads_w)
    assert len(grads) == len(want) == 16
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g.numpy(), w, f"grad leaf {i}")
    L = 2
    assert (tk.PLAIN_CALLS["flash_attention_fwd"],
            tk.PLAIN_CALLS["flash_attention_dkv"],
            tk.PLAIN_CALLS["flash_attention_dq"],
            tk.PLAIN_CALLS["rms_norm"]) == (2 * L, L, L, 4 * L + 1)


def test_two_train_steps_match_reference(ref):
    """Each step from the reference's state before it (step 2 from the
    reference's step 1, so both see the same inputs), then the port's own
    two steps chained: their losses and gnorms."""
    cfg = _tcfg(dispatch="sort")
    step, opt_init = tmoe.build_train_step(cfg, lr=LR, beta1=BETA1)
    fresh = opt_init(convert.params_from_numpy(ref["p0"], device="cpu"))
    o0 = convert.opt_state_from_numpy(ref["o0"], device="cpu")
    for a, b in zip(tllama.tree_leaves(fresh), tllama.tree_leaves(o0)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ids, labels = (torch.from_numpy(ref[k]) for k in ("ids", "labels"))
    before = [(ref["p0"], ref["o0"])] + [st[1:] for st in ref["states"][:-1]]
    m_prev = [np.zeros_like(m) for m in tllama.tree_leaves(ref["o0"]["m"])]
    for n, ((p_in, o_in), (loss_w, p_w, o_w)) in enumerate(
            zip(before, ref["states"]), start=1):
        params = convert.params_from_numpy(p_in, device="cpu")
        opt = convert.opt_state_from_numpy(o_in, device="cpu")
        loss, new_params, new_opt = step(params, opt, ids, labels)
        assert new_params is params and new_opt is opt      # in place
        np.testing.assert_allclose(loss.item(), loss_w, atol=1e-5,
                                   rtol=1e-5)
        got = convert.opt_state_to_numpy(new_opt)
        assert got["step"] == o_w["step"] == n
        np.testing.assert_allclose(got["gnorm"], o_w["gnorm"], atol=1e-5,
                                   rtol=1e-5)
        for key in ("m", "v"):
            for i, (a, b) in enumerate(zip(tllama.tree_leaves(got[key]),
                                           tllama.tree_leaves(o_w[key]))):
                _close(a, b, f"step {n} {key} leaf {i}")
        # this step's gradients (times its clip) from the reference's m
        m_now = tllama.tree_leaves(o_w["m"])
        live = [np.abs(g) > 1e-6 * np.abs(g).max() for g in
                (m - BETA1 * mp for m, mp in zip(m_now, m_prev))]
        m_prev = m_now
        for tree, wtree in ((got["master"], o_w["master"]),
                            (convert.params_to_numpy(new_params), p_w)):
            for i, (a, b, lv) in enumerate(zip(tllama.tree_leaves(tree),
                                               tllama.tree_leaves(wtree),
                                               live)):
                np.testing.assert_allclose(
                    a[lv], b[lv], atol=1e-5, rtol=1e-5,
                    err_msg=f"step {n} param leaf {i}")
                assert (np.abs(a - b)[~lv] <= 2 * LR).all()
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    opt = opt_init(params)
    for loss_w, _, o_w in ref["states"]:
        loss, params, opt = step(params, opt, ids, labels)
        np.testing.assert_allclose(loss.item(), loss_w, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(opt["gnorm"].item(), o_w["gnorm"],
                                   atol=1e-5, rtol=1e-5)


def test_param_counts_match_reference(ref):
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    assert tmoe.count_params(params) == jmoe.count_params(ref["p0"])
    for name in ("deepseek_moe_16b", "qwen2_moe_a14b", "tiny"):
        jc = getattr(jmoe.MoEConfig, name)()
        tc = getattr(tmoe.MoEConfig, name)()
        assert (tmoe.active_params_per_token(tc)
                == jmoe.active_params_per_token(jc))
    tc = tmoe.MoEConfig.deepseek_moe_16b()
    assert tmoe.flops_per_token(tc, 2048) == (
        6.0 * jmoe.active_params_per_token(jmoe.MoEConfig.deepseek_moe_16b())
        + jllama.attn_flops_per_token(tc, 2048))


def test_bf16_tree_with_f32_router_converts_bit_for_bit():
    """A bf16 MoE tree keeps its f32 router through the weight bridge,
    every leaf's bits unchanged both ways."""
    jcfg = jmoe.MoEConfig.tiny()
    shapes = jax.eval_shape(lambda: jmoe.init_params(jcfg))
    tree = _random_tree(shapes, np.random.RandomState(1))
    params = convert.params_from_numpy(tree, device="cpu")
    assert params["layers"]["router"].dtype == torch.float32
    assert params["layers"]["e_gate"].dtype == torch.bfloat16
    shapes_t = tmoe.init_params(tmoe.MoEConfig.tiny(), device="cpu")
    back = convert.params_to_numpy(params)
    for (a, b, t) in zip(tllama.tree_leaves(back), tllama.tree_leaves(tree),
                         tllama.tree_leaves(shapes_t)):
        bits = b.view(np.uint16) if b.dtype.name == "bfloat16" else b
        assert a.dtype == bits.dtype and np.array_equal(a, bits)
    for a, t in zip(tllama.tree_leaves(params), tllama.tree_leaves(shapes_t)):
        assert a.shape == t.shape and a.dtype == t.dtype
