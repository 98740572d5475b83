"""The port's DiT (``paddle_tpu_torch/models/dit.py``) and the threefry
draws of its loss against ``paddle_tpu/models/dit.py`` and ``jax.random``
on the CPU.

A tiny f32 config (``DiTConfig.tiny``: 8x8x4 latents, patch 2, 16 tokens,
h 64, 2 blocks, 10 classes), EVERY leaf drawn with numpy from a seed in the
shapes ``jax.eval_shape`` gives ``init_params`` (at init the adaLN-Zero
leaves are 0, so a fresh model outputs 0 and its blocks get no gradient),
a batch of 8 latents and labels, the key ``PRNGKey(3)`` (whose bernoulli
draw drops one label to the null class).  Every JAX call is jitted and run
once in one module fixture: the timestep embedding, ``forward``,
``value_and_grad`` of ``loss_fn`` and two steps of ``build_train_step`` on
a one-device mesh.  The reference's flash attention runs through its plain
reference (``PADDLE_TPU_DISABLE_PALLAS``), the port's through its plain
flash.

Tolerances: atol = rtol = 1e-5 for outputs and losses; per leaf ``|d| <=
1e-5 |ref| + 1e-6 max|ref|`` for gradients and moments; the parameters
after AdamW as ``test_torch_train.py`` (elements whose gradient is within
float noise of 0 within 2 lr).  The draws: uniform and bernoulli bits
equal; normals within 4 float32 ulps (``erf_inv``: the port's is XLA's
polynomial, whose ``log1p`` differs; 3 ulps at most on these draws).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.models import dit as jdit
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.models import dit as tdit
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.utils import convert, threefry
from torch_threads import one_torch_thread  # noqa: F401

B, SEED, LR, BETA1 = 8, 3, 1e-4, 0.9


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= lim).all(), (
        name, float(np.abs(got - want).max()), float(np.abs(want).max()))


def _random_tree(shapes, rs):
    """Every leaf random at 0.05 (the zero-initialised ones too)."""
    return jax.tree_util.tree_map(
        lambda sd: (0.05 * rs.standard_normal(sd.shape)).astype(sd.dtype),
        shapes)


def _tcfg():
    return dataclasses.replace(tdit.DiTConfig.tiny(), dtype=torch.float32)


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_DISABLE_PALLAS", "flash_attention")
        return _reference_runs()


def _reference_runs():
    jcfg = dataclasses.replace(jdit.DiTConfig.tiny(), dtype=jnp.float32)
    rs = np.random.RandomState(0)
    p0 = _random_tree(jax.eval_shape(lambda: jdit.init_params(jcfg)), rs)
    c, s = jcfg.in_channels, jcfg.image_size
    x0 = rs.standard_normal((B, c, s, s)).astype(np.float32)
    y = rs.randint(0, jcfg.num_classes, (B,)).astype(np.int32)
    t = rs.uniform(0, 999, (B,)).astype(np.float32)
    key = jax.random.PRNGKey(SEED)

    @jax.jit
    def runs(p, x0, y, t, key):
        k1, k2, k3 = jax.random.split(key, 3)
        draws = (jax.random.split(key, 3),
                 jax.random.uniform(k1, (B,), jnp.float32),
                 jax.random.normal(k2, x0.shape, jnp.float32),
                 jax.random.bernoulli(k3, 0.1, (B,)),
                 jax.random.bernoulli(k3, 0.5, (2, 64)))
        return (jdit.timestep_embedding(t, 256),
                jdit.forward(jcfg, p, x0, t, y),
                jax.value_and_grad(
                    lambda q: jdit.loss_fn(jcfg, q, x0, y, key))(p), draws)

    to_np = lambda tr: jax.tree_util.tree_map(np.asarray, tr)
    temb, out, (loss, grads), draws = to_np(runs(p0, x0, y, t, key))
    step, opt_init, shardings, _ = jdit.build_train_step(
        jcfg, jllama.make_mesh(), beta1=BETA1)
    # committed to the step's shardings, so its second call reuses the
    # first's compile
    p = jax.device_put(p0, shardings)
    o = opt_init(p)
    o0 = to_np(o)
    states = []
    for _ in range(2):
        lo, p, o = step(p, o, jnp.asarray(x0), jnp.asarray(y), key)
        states.append((float(lo), to_np(p), to_np(o)))
    return dict(p0=p0, o0=o0, x0=x0, y=y, t=t, temb=temb, out=out,
                loss=float(loss), grads=grads, draws=draws, states=states)


def _inputs(r):
    return (torch.from_numpy(r["x0"]), torch.from_numpy(r["y"]),
            threefry.prng_key(SEED))


def test_presets_match_reference():
    for name in ("dit_xl_2", "tiny"):
        j = dataclasses.asdict(getattr(jdit.DiTConfig, name)())
        t = dataclasses.asdict(getattr(tdit.DiTConfig, name)())
        assert str(j.pop("dtype").dtype) == "bfloat16"
        assert t.pop("dtype") == torch.bfloat16
        assert j == t, name
    c = tdit.DiTConfig.dit_xl_2()
    assert (c.head_dim, c.num_patches, c.out_channels) == (72, 256, 4)


def test_timestep_embedding_matches_reference(ref):
    got = tdit.timestep_embedding(torch.from_numpy(ref["t"]), 256)
    np.testing.assert_allclose(got.numpy(), ref["temb"], atol=1e-5,
                               rtol=1e-5)


def test_forward_matches_reference(ref):
    tk.reset_counters()
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    with torch.no_grad():
        got = tdit.forward(_tcfg(), params, torch.from_numpy(ref["x0"]),
                           torch.from_numpy(ref["t"]),
                           torch.from_numpy(ref["y"]))
    assert got.shape == ref["out"].shape == (B, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), ref["out"], atol=1e-5, rtol=1e-5)
    assert tk.PLAIN_CALLS["flash_attention_fwd"] == 2


def test_loss_and_grads_match_reference(ref):
    tk.reset_counters()
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    loss, grads = tdit.loss_and_grads(_tcfg(), params, *_inputs(ref))
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=1e-5,
                               rtol=1e-5)
    want = tllama.tree_leaves(ref["grads"])
    assert len(grads) == len(want) == 20
    for i, (g, w) in enumerate(zip(grads, want)):
        assert np.abs(w).max() > 0, f"leaf {i} has a gradient"
        _close(g.numpy(), w, f"grad leaf {i}")
    # each block's flash forward runs again in the recomputed backward
    assert (tk.PLAIN_CALLS["flash_attention_fwd"],
            tk.PLAIN_CALLS["flash_attention_dkv"],
            tk.PLAIN_CALLS["flash_attention_dq"]) == (4, 2, 2)


def test_two_train_steps_match_reference(ref):
    """Each step from the reference's state before it (step 2 from the
    reference's step 1); the state has no gnorm, as the reference's."""
    step, opt_init = tdit.build_train_step(_tcfg(), beta1=BETA1)
    fresh = opt_init(convert.params_from_numpy(ref["p0"], device="cpu"))
    assert sorted(fresh) == sorted(ref["o0"]) == ["m", "master", "step", "v"]
    o0 = convert.opt_state_from_numpy(ref["o0"], device="cpu")
    for a, b in zip(tllama.tree_leaves(fresh), tllama.tree_leaves(o0)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    before = [(ref["p0"], ref["o0"])] + [st[1:] for st in ref["states"][:-1]]
    m_prev = [np.zeros_like(m) for m in tllama.tree_leaves(ref["o0"]["m"])]
    for n, ((p_in, o_in), (loss_w, p_w, o_w)) in enumerate(
            zip(before, ref["states"]), start=1):
        params = convert.params_from_numpy(p_in, device="cpu")
        opt = convert.opt_state_from_numpy(o_in, device="cpu")
        loss, new_params, new_opt = step(params, opt, *_inputs(ref))
        assert new_params is params and new_opt is opt      # in place
        np.testing.assert_allclose(loss.item(), loss_w, atol=1e-5,
                                   rtol=1e-5)
        got = convert.opt_state_to_numpy(new_opt)
        assert got["step"] == o_w["step"] == n
        for key in ("m", "v"):
            for i, (a, b) in enumerate(zip(tllama.tree_leaves(got[key]),
                                           tllama.tree_leaves(o_w[key]))):
                _close(a, b, f"step {n} {key} leaf {i}")
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


def test_param_count_matches_reference(ref):
    params = convert.params_from_numpy(ref["p0"], device="cpu")
    assert tdit.count_params(params) == jdit.count_params(ref["p0"])
    xl = jax.eval_shape(lambda: jdit.init_params(jdit.DiTConfig.dit_xl_2()))
    n = jdit.count_params(xl)
    assert n == sum(int(np.prod(sd.shape))
                    for sd in jax.tree_util.tree_leaves(xl))
    assert 6.7e8 < n < 6.8e8


def test_threefry_draws_match_jax_random(ref):
    """The loss's three draws from one split key: uniform and bernoulli
    bit for bit, normal within 4 ulps; a draw that drops a label."""
    keys, u, nrm, drop, half = ref["draws"]
    t1, t2, t3 = threefry.split(threefry.prng_key(SEED), 3)
    assert np.array_equal(keys, torch.stack([t1, t2, t3]).numpy())
    shape = (B, 4, 8, 8)
    assert np.array_equal(threefry.uniform(t1, B).numpy(), u)
    got = threefry.normal(t2, shape).numpy()
    ulps = np.abs(got - nrm) / np.spacing(np.abs(nrm))
    assert got.shape == shape and ulps.max() <= 4, ulps.max()
    assert np.array_equal(threefry.bernoulli(t3, 0.1, (B,)).numpy(), drop)
    assert drop.sum() == 1
    assert np.array_equal(threefry.bernoulli(t3, 0.5, (2, 64)).numpy(), half)


def test_bf16_tree_converts_bit_for_bit():
    shapes = jax.eval_shape(lambda: jdit.init_params(jdit.DiTConfig.tiny()))
    tree = _random_tree(shapes, np.random.RandomState(1))
    params = convert.params_from_numpy(tree, device="cpu")
    back = convert.params_to_numpy(params)
    ref_t = tdit.init_params(tdit.DiTConfig.tiny(), device="cpu")
    for a, b in zip(tllama.tree_leaves(back), tllama.tree_leaves(tree)):
        assert np.array_equal(a, b.view(np.uint16))
    for a, t in zip(tllama.tree_leaves(params), tllama.tree_leaves(ref_t)):
        assert a.shape == t.shape and a.dtype == t.dtype == torch.bfloat16
