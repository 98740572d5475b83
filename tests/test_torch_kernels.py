"""Kernel modules of the PyTorch port against ``paddle_tpu``'s kernel front
doors on the CPU.

The JAX side runs as its own tests run it here: Pallas in interpret mode.
The port's side runs its plain PyTorch versions (a CPU tensor always takes
the plain version; the CUDA kernels are held against these on the card by
``chip_smoke.py``).  Inputs are f32, made with numpy from a seed, handed to
both.  Tolerance atol = rtol = 1e-5: the two sides sum in other orders
(the Pallas arms differ from their own XLA references by ~1e-7).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu.ops.pallas import swiglu as jswiglu
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import rms_norm as trms
from paddle_tpu_torch.ops.kernels import rope as trope
from paddle_tpu_torch.ops.kernels import swiglu as tswiglu

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("rows,h", [(5, 48), (300, 32)])
def test_rms_norm_matches_pallas(rows, h):
    rs = np.random.RandomState(0)
    x = rs.randn(rows, h).astype(np.float32)
    w = (1 + 0.1 * rs.randn(h)).astype(np.float32)
    want = jrms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    tk.reset_counters()
    got = trms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert tk.PLAIN_CALLS["rms_norm"] == 1 and tk.LAUNCHES["rms_norm"] == 0
    _close(got, want)


# op -> (JAX function, port function, input shapes); each takes and returns
# arrays of one framework
BACKWARDS = {
    "rms_norm": (lambda x, w: jrms.rms_norm(x, w, 1e-5),
                 lambda x, w: trms.rms_norm(x, w, 1e-5),
                 [(3, 5, 48), (48,)]),
    "swiglu": (jswiglu.swiglu, tswiglu.swiglu, [(4, 40), (4, 40)]),
    "rope": (lambda q, k, c, s_: jnp.concatenate(
                 [t.reshape(2, 6, -1) for t in
                  jrope.apply_rotary_pos_emb(q, k, c, s_)], -1),
             lambda q, k, c, s_: torch.cat(
                 [t.reshape(2, 6, -1) for t in
                  trope.apply_rotary_pos_emb(q, k, c, s_)], -1),
             [(2, 6, 4, 16), (2, 6, 2, 16), (1, 6, 16), (1, 6, 16)]),
}


@pytest.mark.parametrize("op", list(BACKWARDS))
def test_backward_matches_jax(op):
    """The gradients the training path takes through each op: rms_norm's
    and swiglu's closed-form backwards (the reference's custom_vjp), rope's
    autograd (XLA's autodiff on the JAX side)."""
    jfn, tfn, shapes = BACKWARDS[op]
    rs = np.random.RandomState(7)
    xs = [rs.randn(*sh).astype(np.float32) for sh in shapes]
    if op == "rms_norm":
        xs[1] = 1 + 0.1 * xs[1]
    g = rs.randn(*np.shape(jfn(*map(jnp.asarray, xs)))).astype(np.float32)
    want_out, vjp = jax.vjp(jfn, *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(g))
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    out = tfn(*ts)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    _close(out.detach(), want_out)
    for a, b in zip(got, want):
        _close(a, b)


def _decode_case(rs):
    """b=4 lanes over a 12-page pool (+ the spill page 12), block 8, table
    width 4: lane 0 appends at position 0 (lens 0), lane 1 at a page
    boundary (lens 8 -> row 0 of its second page), lane 2 mid-page, lane 3
    is DROPPED (writeable 0, sentinel table, write page = spill).  The
    spill page starts non-zero so the kernel's zero flush shows."""
    b, nh, nkv, hd, bs, mb, nb = 4, 4, 2, 16, 8, 4, 12
    nbp = nb + 1
    f = np.float32
    q = rs.randn(b, nh, hd).astype(f)
    k_new = rs.randn(b, nkv, hd).astype(f)
    v_new = rs.randn(b, nkv, hd).astype(f)
    ang = rs.rand(b, hd // 2).astype(f) * 3
    ang = np.concatenate([ang, ang], -1)
    cos, sin = np.cos(ang).astype(f), np.sin(ang).astype(f)
    kc = rs.randn(nbp, nkv, bs, hd).astype(f)
    vc = rs.randn(nbp, nkv, bs, hd).astype(f)
    tables = np.full((b, mb), nb, np.int32)
    tables[0, :1] = [7]
    tables[1, :2] = [3, 9]
    tables[2, :2] = [0, 5]
    lens = np.array([0, 8, 13, 0], np.int32)
    wable = np.array([1, 1, 1, 0], np.int32)
    wblk = np.array([7, 9, 5, nb], np.int32)
    return q, k_new, v_new, cos, sin, kc, vc, tables, lens, wblk, wable


@pytest.mark.parametrize("num_shards", [None, 4])
def test_fused_decode_step_matches_pallas(num_shards):
    """Output and BOTH pools: the appends, the untouched pages, and the
    spill page the dropped lane zeros.  num_shards=4 puts more shards than
    live pages on every lane (empty shards emit the empty partial)."""
    case = _decode_case(np.random.RandomState(1))
    jo, jk, jv = jpa.fused_decode_step(*map(jnp.asarray, case),
                                       num_shards=num_shards)
    tcase = [torch.from_numpy(a.copy()) for a in case]
    tk.reset_counters()
    to, tkc, tvc = tda.fused_paged_decode_step(*tcase,
                                               num_shards=num_shards)
    assert tk.PLAIN_CALLS["fused_decode_step"] == 1
    assert tkc.data_ptr() == tcase[5].data_ptr(), "pool updated in place"
    _close(to, jo)
    _close(tkc, jk)
    _close(tvc, jv)
    nb = case[5].shape[0] - 1
    assert (tkc[nb] == 0).all() and (tvc[nb] == 0).all()


@pytest.mark.parametrize("max_blocks,num_shards",
                         [(1, None), (4, None), (8, None), (32, None),
                          (512, None), (4, 8), (6, 4)])
def test_flash_decode_shards_matches_jax(max_blocks, num_shards):
    assert (tpa.flash_decode_shards(max_blocks, num_shards)
            == jpa.flash_decode_shards(max_blocks, num_shards))


@pytest.mark.parametrize("B,h,inter", [(3, 32, 64), (8, 64, 512)])
def test_fused_layer_mlp_matches_pallas(B, h, inter):
    """inter=512 takes two of the TPU kernel's 256-column blocks."""
    rs = np.random.RandomState(3)
    f = np.float32
    args = [rs.randn(B, h).astype(f), rs.randn(B, h).astype(f),
            (1 + 0.1 * rs.randn(h)).astype(f),
            (rs.randn(h, inter) / np.sqrt(h)).astype(f),
            (rs.randn(h, inter) / np.sqrt(h)).astype(f),
            (rs.randn(inter, h) / np.sqrt(inter)).astype(f)]
    jh1, jy = jpa.fused_layer_mlp(*map(jnp.asarray, args), 1e-5)
    tk.reset_counters()
    th1, ty = tpa.fused_layer_mlp(*map(torch.from_numpy, args), 1e-5)
    assert tk.PLAIN_CALLS["fused_layer_mlp"] == 1
    _close(th1, jh1)
    _close(ty, jy)


@pytest.mark.parametrize("inter", [64, 512, 11008, 14336])
def test_fused_mlp_slices(inter):
    """The CUDA grid's ffn slices: one per SM (132) unless a slice would
    pass 128 columns; 112-column slices at Llama-3-8B's 14336."""
    n = tpa.fused_mlp_splits(inter)
    cols = tpa.fused_mlp_block_cols(inter)
    assert cols % 4 == 0 and cols <= 128 and n * cols >= inter
    assert n == min(inter // 4, 132)
    assert tpa.fused_mlp_supported(4096, inter)
    if inter == 14336:
        assert (n, cols) == (132, 112)


def test_dispatch_rules(monkeypatch):
    """CPU tensors take the plain version; a device mix or a device that is
    neither CPU nor CUDA raises; the operator switch parses tokens."""
    cpu = torch.zeros(2)
    assert not tk.use_kernel("rms_norm", cpu, cpu)
    with pytest.raises(ValueError):
        tk.use_kernel("rms_norm", torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        tk.use_kernel("rms_norm", cpu, torch.zeros(2, device="meta"))
    monkeypatch.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", raising=False)
    assert not tk.kernel_disabled("rms_norm")
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "rms_norm")
    assert tk.kernel_disabled("rms_norm")
    assert not tk.kernel_disabled("fused_layer_mlp")
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "all")
    assert tk.kernel_disabled("fused_layer_mlp")
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "rms_nrm")
    with pytest.warns(UserWarning, match="did you mean 'rms_norm'"):
        assert not tk.kernel_disabled("rms_norm")
