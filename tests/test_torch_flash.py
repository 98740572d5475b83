"""The port's flash attention against ``paddle_tpu``'s on the CPU.

The JAX side runs ``flash_attention_bshd`` as its own tests run it here
(Pallas in interpret mode: the forward, dK/dV and dQ kernels), gradients
through ``jax.vjp``; the port runs its plain versions of the same three
kernels under ``torch.autograd``.  Inputs and the output cotangent are f32,
made with numpy from a seed.  atol = rtol = 1e-5: both sides compute in
f32 and sum in other orders.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)

# (b, sq, skv, hq, hkv, d, causal, mask, segments)
CASES = {
    "full_gqa": (2, 16, 16, 4, 2, 16, False, None, None),
    "causal_gqa": (2, 16, 16, 4, 2, 16, True, None, None),
    "ragged_40": (1, 40, 40, 4, 2, 8, True, None, None),
    # sq != skv, top-left causal, and q segment 7 matches no kv segment:
    # those rows attend nothing and must come out 0
    "sq_ne_skv_zero_rows": (2, 24, 40, 4, 2, 16, True, None, "pair"),
    "bool_mask": (2, 16, 24, 4, 2, 16, False, "bool", None),
    "additive_mask": (1, 16, 16, 4, 2, 16, True, "add", None),
    "segments": (2, 32, 32, 2, 1, 16, True, None, "ids"),
}


def _inputs(b, sq, skv, hq, hkv, d, mask, seg, seed=0):
    rs = np.random.RandomState(seed)
    f = np.float32
    q = rs.randn(b, sq, hq, d).astype(f)
    k = rs.randn(b, skv, hkv, d).astype(f)
    v = rs.randn(b, skv, hkv, d).astype(f)
    g = rs.randn(b, sq, hq, d).astype(f)
    m = None
    if mask == "bool":
        m = rs.rand(b, 1, sq, skv) > 0.3
        m[0, 0, 3] = False                    # one fully masked row
    elif mask == "add":
        m = (rs.randn(1, hq, sq, skv) * 2).astype(f)
    segs = None
    if seg == "ids":
        ids = np.sort(rs.randint(0, 3, size=(b, sq)), axis=1).astype(np.int32)
        segs = ids
    elif seg == "pair":
        q_ids = np.sort(rs.randint(0, 3, size=(b, sq)), axis=1)
        q_ids[:, -5:] = 7
        kv_ids = np.sort(rs.randint(0, 3, size=(b, skv)), axis=1)
        segs = (q_ids.astype(np.int32), kv_ids.astype(np.int32))
    return q, k, v, g, m, segs


def _jax_run(q, k, v, g, m, segs, causal):
    """out and the cotangents of q, k, v (and an additive mask), jitted
    (interpret-mode Pallas compiles ~3x faster than it runs eagerly)."""
    diff_mask = m is not None and m.dtype != np.bool_

    @jax.jit
    def run(q, k, v, g, m, segs):
        def f(q, k, v, *mm):
            mask = mm[0] if diff_mask else m
            return jfa.flash_attention_bshd(q, k, v, attn_mask=mask,
                                            causal=causal, segment_ids=segs)

        primals = (q, k, v, m) if diff_mask else (q, k, v)
        out, vjp = jax.vjp(f, *primals)
        return (out,) + vjp(g)

    return [np.asarray(x) for x in run(q, k, v, g, m, segs)]


def _torch_run(q, k, v, g, m, segs, causal):
    tq, tk_, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    leaves = [tq, tk_, tv]
    tm = None
    if m is not None:
        tm = torch.tensor(m, requires_grad=m.dtype != np.bool_)
        if m.dtype != np.bool_:
            leaves.append(tm)
    seg_t = (None if segs is None else
             tuple(torch.from_numpy(s) for s in segs)
             if isinstance(segs, tuple) else torch.from_numpy(segs))
    out = tfa.flash_attention_bshd(tq, tk_, tv, attn_mask=tm, causal=causal,
                                   segment_ids=seg_t)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_and_grads_match_pallas(case):
    b, sq, skv, hq, hkv, d, causal, mask, seg = CASES[case]
    q, k, v, g, m, segs = _inputs(b, sq, skv, hq, hkv, d, mask, seg)
    want = _jax_run(q, k, v, g, m, segs, causal)
    tk.reset_counters()
    calls = (tfa.KERNEL_CALLS, tfa.FALLBACK_CALLS)
    got = _torch_run(q, k, v, g, m, segs, causal)
    assert (tfa.KERNEL_CALLS, tfa.FALLBACK_CALLS) == (calls[0] + 1, calls[1])
    for name in ("flash_attention_fwd", "flash_attention_dkv",
                 "flash_attention_dq"):
        assert tk.PLAIN_CALLS[name] == 1 and tk.LAUNCHES[name] == 0
    names = ["out", "dq", "dk", "dv", "dmask"]
    for name, a, e in zip(names, got, want):
        np.testing.assert_allclose(a, e, err_msg=name, **TOL)
    if seg == "pair" or mask == "bool":
        # rows with nothing to attend are exactly 0, as are their dq
        if seg == "pair":
            dead = (segs[0][:, :, None] != segs[1][:, None, :]).all(-1)
        else:
            dead = ~m[:, 0].any(-1)
        assert dead.any()
        assert (got[0][dead] == 0).all() and (got[1][dead] == 0).all()


@pytest.mark.parametrize("why", ["head_dim", "disabled"])
def test_routing_to_composed_matches_pallas(why, monkeypatch):
    """head_dim % 8 != 0 and the operator switch take the composed oracle,
    counted as the reference counts them."""
    d = 12 if why == "head_dim" else 16
    if why == "disabled":
        monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS",
                           "flash_attention")
        monkeypatch.setenv("PADDLE_TPU_DISABLE_PALLAS", "flash_attention")
    q, k, v, g, m, segs = _inputs(2, 16, 16, 4, 2, d, None, "ids", seed=3)
    want = _jax_run(q, k, v, g, m, segs, True)
    calls = (tfa.KERNEL_CALLS, tfa.FALLBACK_CALLS)
    tk.reset_counters()
    got = _torch_run(q, k, v, g, m, segs, True)
    assert (tfa.KERNEL_CALLS, tfa.FALLBACK_CALLS) == (calls[0], calls[1] + 1)
    assert sum(tk.PLAIN_CALLS.values()) == 0
    for a, e in zip(got, want):
        np.testing.assert_allclose(a, e, **TOL)


def test_mask_forms_and_errors():
    """2D and 3D masks broadcast as [1, 1, sq, skv] and [b, 1, sq, skv];
    a mask that does not broadcast raises."""
    q, k, v, _, _, _ = _inputs(2, 8, 8, 2, 2, 8, None, None, seed=5)
    tq, tk_, tv = (torch.from_numpy(x) for x in (q, k, v))
    rs = np.random.RandomState(6)
    m3 = torch.from_numpy(rs.rand(2, 8, 8) > 0.2)
    a = tfa.flash_attention_bshd(tq, tk_, tv, attn_mask=m3)
    b = tfa.flash_attention_bshd(tq, tk_, tv, attn_mask=m3[:, None])
    assert torch.equal(a, b)
    m2 = m3[0]
    a = tfa.flash_attention_bshd(tq, tk_, tv, attn_mask=m2)
    b = tfa.flash_attention_bshd(tq, tk_, tv, attn_mask=m2[None, None])
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seq dims"):
        tfa.flash_attention_bshd(tq, tk_, tv, attn_mask=m3[:, :4])
    with pytest.raises(ValueError, match="batch/head"):
        tfa.flash_attention_bshd(tq, tk_, tv,
                                 attn_mask=torch.ones(3, 1, 8, 8, dtype=bool))
