"""Context parallelism: ring attention and Ulysses attention (counterpart of
``paddle_tpu/ops/ring_attention.py``).

Both run on one rank's shard of the sequence, ``[b, s_local, h, d]``,
the global sequence being the shards in the order of the ``axis``'s
positions of a :class:`~paddle_tpu_torch.distributed.mesh.Mesh`:

- :func:`ring_attention`: q stays; the compact (GQA) K/V rotate around the
  axis with :func:`~paddle_tpu_torch.distributed.mesh.ppermute` while an
  f32 online-softmax accumulator folds in one block a step.  The
  reference composes it from ``lax`` einsums, no Pallas kernel, so here
  it is torch ops too;
- :func:`ulysses_attention`: an all-to-all swaps the split from sequence
  to heads, the flash kernels (``flash_attention_bshd``) run on the whole
  sequence of the local heads, and a second all-to-all swaps back.

Gradients come from autograd through the collectives' transposes.
"""

from __future__ import annotations

import math

import torch

from ..distributed import mesh as dmesh

NEG_INF = -1e30


def _block_attn_update(q, k, v, m, l, acc, scale, mask):
    """One online-softmax step.  q [b, sq, h, d], k / v [b, skv, h, d];
    m, l [b, h, sq, 1]; acc [b, h, sq, d]; mask [sq, skv] bool (True =
    attend) or None.  A fully masked row leaves m, l and acc as they were
    (the ``NEG_INF / 2`` guards)."""
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    vh = v.transpose(1, 2).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    m_cur = s.amax(-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    dead = m_new <= NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m_new)
    p = torch.exp(torch.where(dead, NEG_INF, s - m_safe))
    alpha = torch.where(dead, 1.0, torch.exp(m - m_new))
    l_new = alpha * l + p.sum(-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return m_new, l_new, acc_new


def ring_attention(q, k, v, mesh, axis: str = "sep", causal: bool = True,
                   scale=None):
    """Ring attention over ``mesh``'s ``axis``: q, k, v are this rank's
    shards ``[b, s_local, h(_kv), d]``; returns its output shard.  The
    K/V pair rotates as one tensor, one exchange a step and ``n - 1`` in
    all (the reference's last rotation feeds nothing); the causal mask
    comes from global positions."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    b, s_loc, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kv_rep = h // k.shape[2]
    dev = q.device
    rows = torch.arange(s_loc, device=dev)[:, None]
    cols = torch.arange(s_loc, device=dev)[None, :]
    m = torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for r in range(n):
        src = (idx - r) % n             # whose block this K/V is
        mask = None
        if causal:
            mask = idx * s_loc + rows >= src * s_loc + cols
        kk, vv = kv.unbind(0)
        if kv_rep > 1:
            kk = kk.repeat_interleave(kv_rep, dim=2)
            vv = vv.repeat_interleave(kv_rep, dim=2)
        m, l, acc = _block_attn_update(q, kk, vv, m, l, acc, scale, mask)
        if r < n - 1:
            kv = dmesh.ppermute(kv, mesh, axis, 1)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe).to(q.dtype).transpose(1, 2)


def ulysses_attention(q, k, v, mesh, axis: str = "sep", causal: bool = True,
                      scale=None, use_flash: bool = True):
    """Ulysses over ``mesh``'s ``axis``: all-to-all seq -> heads, local
    attention on the whole sequence, all-to-all back.  Local q heads must
    divide by the axis size; with fewer kv heads than positions the kv
    heads are repeated to the q heads first (their gradient sums back over
    the repeats)."""
    from .kernels import flash_attention as fa

    n = mesh.axis_size(axis)
    if k.shape[2] != q.shape[2] and k.shape[2] < n:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def seq2head(t):
        return dmesh.all_to_all(t, mesh, axis, split_axis=2, concat_axis=1)

    qg, kg, vg = seq2head(q), seq2head(k), seq2head(v)
    if use_flash:
        out = fa.flash_attention_bshd(qg, kg, vg, causal=causal, scale=scale)
    else:
        out = fa._composed_attention(qg, kg, vg, None, causal,
                                     scale or 1.0 / math.sqrt(q.shape[-1]))
    return dmesh.all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)
