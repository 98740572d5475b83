"""Flash attention with its backward (counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``).

Three kernels, each with its plain PyTorch version beside it:

- ``flash_fwd`` (the reference's ``_fwd_kernel``): FlashAttention forward,
  online softmax in f32, emits ``out`` and the row log-sum-exp ``lse``;
- ``flash_dkv`` (``_dkv_kernel``): dK and dV, the GQA group summed in the
  block's accumulator;
- ``flash_dq`` (``_dq_kernel``): dQ.

Each has two hand-written routes, chosen by :func:`flash_route` from
(dtype, head_dim) alone: ``"tc"`` for bf16/f16 at head_dim 64 or 128
(``csrc/flash_fwd_tc.cu``, ``csrc/flash_bwd_tc.cu``: wgmma tensor cores
with f32 accumulators, P and dS entering their products as hi + lo parts
of the input dtype) and ``"cc"`` for every other shape
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``: f32 on the CUDA cores).  A
route never changes because a launch failed; a failed launch raises.

Semantics are the reference's: q/k/v upcast to f32, logits
``dot(q, k) * scale``, then the mask (bool -> ``NEG_INF``, additive ->
``+ mask``), the segment-id mask, **top-left** causal ``row >= col``;
``_safe_exp`` is exactly 0 where a logit is ``<= NEG_INF / 2``, and a row
with nothing to attend outputs 0 with ``lse = NEG_INF``.  The backward
recomputes ``p = safe_exp(s - lse)`` and uses ``delta = rowsum(dO * O)``
in f32 (computed here in PyTorch, as the reference computes it in XLA).

Layouts: the public entry and the kernels take BSHD tensors
(``[batch, seq, heads, head_dim]``, contiguous); ``lse``/``delta`` are
``[batch, q_heads, sq]`` f32.  GQA reads kv head ``h // rep`` for q head
``h`` and never repeats K/V.  Lengths are arbitrary: the kernels
bounds-check ragged tiles instead of padding copies.

Routing (``flash_attention_bshd``): ``head_dim % 8 != 0``,
``hq % hkv != 0`` or ``PADDLE_TPU_TORCH_DISABLE_KERNELS`` naming
``flash_attention`` (or ``all``) take the composed oracle
``_composed_attention`` and count ``FALLBACK_CALLS``, as the reference
routes; everything else counts ``KERNEL_CALLS`` and goes through
:class:`_FlashCore`, whose three steps dispatch by device: CPU tensors
take the plain versions, CUDA tensors launch the kernels or raise (head
dims over 256 included).
"""

from __future__ import annotations

import math

import torch

from . import (DTYPE_CODE, LAUNCHES, check_cuda_tensor, check_launch,
               kernel_disabled, library, pick_route, ptr, stream_ptr,
               use_kernel)

#: dtype codes of the flash entry points: the library's, plus float16
_DTYPE = {**DTYPE_CODE, torch.float16: 2}

NEG_INF = -1e30

#: how often the public entry took the kernel path vs the composed oracle
#: (counterparts of the reference's trace-time counters)
KERNEL_CALLS = 0
FALLBACK_CALLS = 0

#: largest head_dim the CUDA kernels take (a multiple of 8)
MAX_HEAD_DIM = 256
#: kv positions the plain versions take per step of their recurrence
_REF_BLOCK = 512

#: mask kinds the C entry points take
_MASK_NONE, _MASK_BOOL, _MASK_ADD = 0, 1, 2


def _safe_exp(s: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """exp(s - shift), exactly 0 where ``s`` is fully masked (also when the
    shift is NEG_INF itself)."""
    return torch.where(s > 0.5 * NEG_INF, torch.exp(s - shift),
                       torch.zeros((), dtype=s.dtype, device=s.device))


def _normalize_mask(attn_mask, b, hq, sq, skv):
    """[b|1, h|1, sq, skv] (or the 2D/3D forms) -> ([mb*mh, sq, skv]
    contiguous, mb, mh)."""
    m = attn_mask
    if m.ndim == 2:
        m = m[None, None]
    elif m.ndim == 3:
        m = m[:, None]
    if m.shape[2] in (1, sq) and m.shape[3] in (1, skv):
        # broadcastable seq dims (e.g. a [b, 1, 1, skv] key-padding mask):
        # materialize
        if m.shape[2] != sq or m.shape[3] != skv:
            m = m.expand(*m.shape[:2], sq, skv)
    else:
        raise ValueError(f"attn_mask seq dims {tuple(m.shape[2:])} != "
                         f"({sq}, {skv})")
    mb, mh = m.shape[0], m.shape[1]
    if mb not in (1, b) or mh not in (1, hq):
        raise ValueError(f"attn_mask batch/head dims {tuple(m.shape[:2])} "
                         f"not broadcastable to ({b}, {hq})")
    return m.reshape(mb * mh, sq, skv).contiguous(), mb, mh


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def _masked_logits(qf, k, mask, mb, mh, segs, scale, causal, j0, j1):
    """Logits of q against kv positions [j0, j1) with every mask applied,
    in the reference's order.  qf [b, sq, hkv, rep, d] f32, k [b, skv,
    hkv, d] -> [b, hkv, rep, sq, j1 - j0] f32."""
    b, sq, hkv, rep, _ = qf.shape
    kf = k[:, j0:j1].float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kf) * scale
    if mask is not None:
        m = mask.view(mb, mh, sq, -1)[..., j0:j1]
        m = (m.reshape(mb, hkv, rep, sq, j1 - j0) if mh > 1
             else m[:, :, None])
        if m.dtype == torch.bool:
            s = torch.where(m, s, NEG_INF)
        else:
            s = s + m.float()
    if segs is not None:
        q_seg, kv_seg = segs
        ok = q_seg[:, :, None] == kv_seg[:, None, j0:j1]
        s = torch.where(ok[:, None, None], s, NEG_INF)
    if causal:
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(j0, j1, device=s.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    return s


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[b, s, hq, d] -> f32 [b, s, hkv, rep, d] (a view of the group)."""
    b, s, hq, d = x.shape
    return x.float().reshape(b, s, hkv, hq // hkv, d)


def _rows(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """[b, hq, sq] row statistics -> [b, hkv, rep, sq, 1]."""
    b, hq, sq = t.shape
    return t.reshape(b, hkv, hq // hkv, sq)[..., None]


def flash_fwd_ref(q, k, v, mask=None, mb=1, mh=1, segs=None, scale=1.0,
                  causal=False):
    """The forward kernel's arithmetic: the FA2 recurrence over kv blocks.
    q [b, sq, hq, d], k/v [b, skv, hkv, d] -> (out [b, sq, hq, d] in q's
    dtype, lse [b, hq, sq] f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = _grouped(q, hkv)
    m = torch.full((b, hkv, hq // hkv, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(b, hkv, hq // hkv, sq, d, dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, skv, _REF_BLOCK):
        j1 = min(j0 + _REF_BLOCK, skv)
        s = _masked_logits(qf, k, mask, mb, mh, segs, scale, causal, j0, j1)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = _safe_exp(s, m_new)
        alpha = _safe_exp(m, m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgrqk,bkgd->bgrqd", p,
                                         v[:, j0:j1].float())
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    lse = (m + torch.log(l_safe)).reshape(b, hq, sq)
    return out.to(q.dtype), lse


def _probs_and_ds(qf, k, v, dof, lse, delta, mask, mb, mh, segs, scale,
                  causal, j0, j1, ds_scale=None):
    """Recomputed p and ds = p * (dp - delta) * ds_scale (default: the
    logits' scale) for kv [j0, j1)."""
    hkv = k.shape[2]
    s = _masked_logits(qf, k, mask, mb, mh, segs, scale, causal, j0, j1)
    p = _safe_exp(s, _rows(lse, hkv))
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dof, v[:, j0:j1].float())
    return p, p * (dp - _rows(delta, hkv)) * (scale if ds_scale is None
                                               else ds_scale)


def flash_dkv_ref(q, k, v, do, lse, delta, mask=None, mb=1, mh=1, segs=None,
                  scale=1.0, causal=False):
    """dK, dV (in k's and v's dtypes), the q-head group summed in f32."""
    hkv = k.shape[2]
    qf, dof = _grouped(q, hkv), _grouped(do, hkv)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for j0 in range(0, k.shape[1], _REF_BLOCK):
        j1 = min(j0 + _REF_BLOCK, k.shape[1])
        p, ds = _probs_and_ds(qf, k, v, dof, lse, delta, mask, mb, mh, segs,
                              scale, causal, j0, j1)
        dv[:, j0:j1] = torch.einsum("bgrqk,bqgrd->bkgd", p, dof).to(v.dtype)
        dk[:, j0:j1] = torch.einsum("bgrqk,bqgrd->bkgd", ds, qf).to(k.dtype)
    return dk, dv


def flash_dq_ref(q, k, v, do, lse, delta, mask=None, mb=1, mh=1, segs=None,
                 scale=1.0, causal=False):
    """dQ in q's dtype, accumulated over kv blocks in f32."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf, dof = _grouped(q, hkv), _grouped(do, hkv)
    dq = torch.zeros_like(qf)
    for j0 in range(0, k.shape[1], _REF_BLOCK):
        j1 = min(j0 + _REF_BLOCK, k.shape[1])
        _, ds = _probs_and_ds(qf, k, v, dof, lse, delta, mask, mb, mh, segs,
                              scale, causal, j0, j1)
        dq += torch.einsum("bgrqk,bkgd->bqgrd", ds, k[:, j0:j1].float())
    return dq.reshape(b, sq, hq, d).to(q.dtype)


def _mask_grad(q, k, v, do, lse, delta, mask, mb, mh, segs, scale, causal):
    """Cotangent of an additive mask (the reference's ``_xla_mask_grad``,
    plain PyTorch there and here): ds = p * (dp - delta), no ``scale`` (the
    mask adds to the post-scale logits), summed over the broadcast group
    -> [mb*mh, sq, skv] f32.  O(sq * skv) memory."""
    b, sq, hq, _ = q.shape
    hkv = k.shape[2]
    _, ds = _probs_and_ds(_grouped(q, hkv), k, v, _grouped(do, hkv), lse,
                          delta, mask, mb, mh, segs, scale, causal, 0,
                          k.shape[1], ds_scale=1.0)
    g = ds.reshape(b, hq, sq, -1)
    if mb == 1:
        g = g.sum(0, keepdim=True)
    if mh == 1:
        g = g.sum(1, keepdim=True)
    return g.reshape(mb * mh, sq, -1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_shapes(name, q, k, v):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16, float16)")
    if d % 8 or d > MAX_HEAD_DIM or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}: "
                         f"the kernel takes head_dim a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} and hq a multiple of hkv")
    check_cuda_tensor(f"{name} q", q, (b, sq, hq, d), q.dtype, q.device)
    check_cuda_tensor(f"{name} k", k, (b, skv, hkv, d), q.dtype, q.device)
    check_cuda_tensor(f"{name} v", v, (b, skv, hkv, d), q.dtype, q.device)
    _check_aligned(name, q, k, v)
    return b, sq, skv, hq, hkv, d


def _check_aligned(name, *tensors):
    """The kernels read rows with 16-byte loads."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a tensor of shape {tuple(t.shape)} "
                             f"is not 16-byte aligned")


def _opt_args(name, q, mask, mb, mh, segs, sq, skv):
    """(mask ptr, mask kind, q_seg ptr, kv_seg ptr) after checking them."""
    b, dev = q.shape[0], q.device
    if mask is None:
        mptr, kind = None, _MASK_NONE
    else:
        kind = _MASK_BOOL if mask.dtype == torch.bool else _MASK_ADD
        check_cuda_tensor(f"{name} mask", mask, (mb * mh, sq, skv),
                          torch.bool if kind == _MASK_BOOL else torch.float32,
                          dev)
        mptr = ptr(mask)
    if segs is None:
        return mptr, kind, None, None
    q_seg, kv_seg = segs
    check_cuda_tensor(f"{name} q_seg", q_seg, (b, sq), torch.int32, dev)
    check_cuda_tensor(f"{name} kv_seg", kv_seg, (b, skv), torch.int32, dev)
    return mptr, kind, ptr(q_seg), ptr(kv_seg)


#: dtypes and head dims of the tensor-core kernels (csrc/flash_fwd_tc.cu,
#: csrc/flash_bwd_tc.cu; csrc/paged_prefill_tc.cu by the same rule)
TC_DTYPES = (torch.bfloat16, torch.float16)
TC_HEAD_DIMS = (64, 128)


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which hand-written kernel the forward, dK/dV and dQ take on the
    card: ``"tc"`` (wgmma tensor cores) for bf16/f16 at head_dim 64 or 128,
    ``"cc"`` (the f32 CUDA-core kernels) for every other shape the wrappers
    take."""
    return "tc" if dtype in TC_DTYPES and head_dim in TC_HEAD_DIMS else "cc"


def _pick_route(name, q, route):
    """``route`` (None: :func:`flash_route`) after checking it fits q."""
    return pick_route(name, q, route, flash_route(q.dtype, q.shape[-1]))


def flash_fwd_cuda(q, k, v, mask=None, mb=1, mh=1, segs=None, scale=1.0,
                   causal=False, route=None):
    """Launch ``csrc/flash_fwd_tc.cu`` or ``csrc/flash_fwd.cu`` (``route``,
    default :func:`flash_route`): (out, lse) as :func:`flash_fwd_ref`.  An
    additive mask must be f32 (``_FlashCore`` converts it)."""
    b, sq, skv, hq, hkv, d = _check_shapes("flash_fwd", q, k, v)
    mptr, kind, qs, ks = _opt_args("flash_fwd", q, mask, mb, mh, segs, sq,
                                   skv)
    route = _pick_route("flash_fwd", q, route)
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    lib = library()
    fn = lib.ptt_flash_fwd_tc if route == "tc" else lib.ptt_flash_fwd
    err = fn(ptr(q), ptr(k), ptr(v), mptr, qs, ks, ptr(out), ptr(lse), b, sq,
             skv, hq, hkv, d, mb, mh, kind, int(causal), float(scale),
             _DTYPE[q.dtype], stream_ptr(q.device))
    check_launch("flash_fwd", err)
    LAUNCHES["flash_attention_fwd"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_fwd_tc"] += 1
    return out, lse


def _check_bwd(name, q, do, lse, delta):
    b, sq, hq, _ = q.shape
    check_cuda_tensor(f"{name} do", do, tuple(q.shape), q.dtype, q.device)
    _check_aligned(name, do)
    check_cuda_tensor(f"{name} lse", lse, (b, hq, sq), torch.float32,
                      q.device)
    check_cuda_tensor(f"{name} delta", delta, (b, hq, sq), torch.float32,
                      q.device)


def flash_dkv_cuda(q, k, v, do, lse, delta, mask=None, mb=1, mh=1,
                   segs=None, scale=1.0, causal=False, route=None):
    """Launch the dK/dV kernel of ``csrc/flash_bwd_tc.cu`` or
    ``csrc/flash_bwd.cu`` (``route``, default :func:`flash_route`)."""
    b, sq, skv, hq, hkv, d = _check_shapes("flash_dkv", q, k, v)
    _check_bwd("flash_dkv", q, do, lse, delta)
    mptr, kind, qs, ks = _opt_args("flash_dkv", q, mask, mb, mh, segs, sq,
                                   skv)
    route = _pick_route("flash_dkv", q, route)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = library()
    fn = lib.ptt_flash_dkv_tc if route == "tc" else lib.ptt_flash_dkv
    err = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), mptr, qs,
             ks, ptr(dk), ptr(dv), b, sq, skv, hq, hkv, d, mb, mh, kind,
             int(causal), float(scale), _DTYPE[q.dtype],
             stream_ptr(q.device))
    check_launch("flash_dkv", err)
    LAUNCHES["flash_attention_dkv"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_dkv_tc"] += 1
    return dk, dv


def flash_dq_cuda(q, k, v, do, lse, delta, mask=None, mb=1, mh=1, segs=None,
                  scale=1.0, causal=False, route=None):
    """Launch the dQ kernel of ``csrc/flash_bwd_tc.cu`` or
    ``csrc/flash_bwd.cu`` (``route``, default :func:`flash_route`)."""
    b, sq, skv, hq, hkv, d = _check_shapes("flash_dq", q, k, v)
    _check_bwd("flash_dq", q, do, lse, delta)
    mptr, kind, qs, ks = _opt_args("flash_dq", q, mask, mb, mh, segs, sq,
                                   skv)
    route = _pick_route("flash_dq", q, route)
    dq = torch.empty_like(q)
    lib = library()
    fn = lib.ptt_flash_dq_tc if route == "tc" else lib.ptt_flash_dq
    err = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), mptr, qs,
             ks, ptr(dq), b, sq, skv, hq, hkv, d, mb, mh, kind, int(causal),
             float(scale), _DTYPE[q.dtype], stream_ptr(q.device))
    check_launch("flash_dq", err)
    LAUNCHES["flash_attention_dq"] += 1
    if route == "tc":
        LAUNCHES["flash_attention_dq_tc"] += 1
    return dq


def flash_fwd(q, k, v, **kw):
    if use_kernel("flash_attention_fwd", q, k, v,
                  switch="flash_attention"):
        return flash_fwd_cuda(q, k, v, **kw)
    return flash_fwd_ref(q, k, v, **kw)


def flash_dkv(q, k, v, do, lse, delta, **kw):
    if use_kernel("flash_attention_dkv", q, k, v, do,
                  switch="flash_attention"):
        return flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return flash_dkv_ref(q, k, v, do, lse, delta, **kw)


def flash_dq(q, k, v, do, lse, delta, **kw):
    if use_kernel("flash_attention_dq", q, k, v, do,
                  switch="flash_attention"):
        return flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    return flash_dq_ref(q, k, v, do, lse, delta, **kw)


class _FlashCore(torch.autograd.Function):
    """Counterpart of the reference's ``_flash_attention_core``
    ``custom_vjp``: forward saves q, k, v, out, lse (and the mask and
    segments); backward computes delta, then dK/dV and dQ, and the
    additive mask's cotangent in plain PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, mask, q_seg, kv_seg, mb, mh, scale, causal):
        segs = None if q_seg is None else (q_seg, kv_seg)
        kmask = mask
        if mask is not None and mask.dtype != torch.bool:
            kmask = mask.float().contiguous()     # exact for bf16/f16
        kw = dict(mask=kmask, mb=mb, mh=mh, segs=segs, scale=scale,
                  causal=causal)
        out, lse = flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, kmask, q_seg, kv_seg)
        ctx.meta = (mb, mh, scale, causal,
                    None if mask is None else mask.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kmask, q_seg, kv_seg = ctx.saved_tensors
        mb, mh, scale, causal, mask_dtype = ctx.meta
        segs = None if q_seg is None else (q_seg, kv_seg)
        do = do.contiguous()
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        kw = dict(mask=kmask, mb=mb, mh=mh, segs=segs, scale=scale,
                  causal=causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
        dq = flash_dq(q, k, v, do, lse, delta, **kw)
        dmask = None
        if ctx.needs_input_grad[3]:
            dmask = _mask_grad(q, k, v, do, lse, delta, kmask, mb, mh, segs,
                               scale, causal).to(mask_dtype)
        return dq, dk, dv, dmask, None, None, None, None, None, None


def _segment_pair(segment_ids, device):
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        q_ids = kv_ids = segment_ids
    return (torch.as_tensor(q_ids, device=device).to(torch.int32)
            .contiguous(),
            torch.as_tensor(kv_ids, device=device).to(torch.int32)
            .contiguous())


def flash_attention_bshd(q, k, v, attn_mask=None, causal=False, scale=None,
                         segment_ids=None):
    """q [b, sq, hq, d], k/v [b, skv, hkv, d] -> [b, sq, hq, d].

    GQA without repeating K/V; ``causal`` is top-left (``row >= col``);
    ``attn_mask`` [b|1, h|1, sq, skv] (or its 2D/3D forms), bool or
    additive (differentiable); ``segment_ids`` ([b, s] ints, or a
    (q_ids, kv_ids) pair) keeps attention within equal ids.  Rows with
    nothing to attend output 0."""
    global KERNEL_CALLS, FALLBACK_CALLS
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d % 8 != 0 or hq % hkv != 0 or kernel_disabled("flash_attention"):
        FALLBACK_CALLS += 1
        if segment_ids is not None:
            # fold the segment ids into the mask so packing survives the
            # composed path
            q_ids, kv_ids = _segment_pair(segment_ids, q.device)
            seg_ok = q_ids[:, None, :, None] == kv_ids[:, None, None, :]
            if attn_mask is None:
                attn_mask = seg_ok
            elif attn_mask.dtype == torch.bool:
                attn_mask = attn_mask & seg_ok
            else:
                attn_mask = attn_mask + torch.where(seg_ok, 0.0, NEG_INF)
        return _composed_attention(q, k, v, attn_mask, causal, scale)
    KERNEL_CALLS += 1
    mask, mb, mh = None, 1, 1
    if attn_mask is not None:
        mask, mb, mh = _normalize_mask(attn_mask, b, hq, sq, skv)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg, kv_seg = _segment_pair(segment_ids, q.device)
    return _FlashCore.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mask, q_seg, kv_seg, mb, mh, float(scale),
                            bool(causal))


def _composed_attention(q, k, v, attn_mask, causal, scale):
    """The oracle: whole logits in f32, softmax, fully masked rows 0."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    if attn_mask is not None and attn_mask.ndim == 3:
        # [b, sq, skv] is per batch (as _normalize_mask reads it), not a
        # right-aligned broadcast over heads
        attn_mask = attn_mask[:, None]
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    if causal:
        tri = torch.ones(logits.shape[-2], logits.shape[-1], dtype=torch.bool,
                         device=logits.device).tril()
        logits = torch.where(tri, logits, NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = torch.where(attn_mask, logits, NEG_INF)
        else:
            logits = logits + attn_mask.float()
    all_masked = (logits <= 0.5 * NEG_INF).all(-1, keepdim=True)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(all_masked, 0.0, p)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    return out.to(q.dtype).transpose(1, 2)
