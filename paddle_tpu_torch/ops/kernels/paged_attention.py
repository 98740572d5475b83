"""Paged-attention decode kernels, decode half and MLP half (counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``).

Ported so far: the fused decode step (rope + KV-page append + split-K
attention, ``csrc/fused_decode.cu``) and the fused post-attention MLP half
(residual + RMSNorm + SwiGLU, ``csrc/fused_mlp.cu``), each with its plain
PyTorch version beside it, plus the helpers they share with the reference:
``kernel_supported``, ``flash_decode_shards``, ``paged_attention_reference``,
``fused_mlp_block_cols`` and ``fused_mlp_supported``.  The split-K partials
are merged on the card by the kernel's second launch (the reference's
``_flash_combine``); the plain version attends over the whole row at once.  The unfused decode kernels, verify, chunked
prefill and the quantized fused step are still to port (ROADMAP.md).

Layouts are the reference's: pools ``[nbp, nkv, block_size, head_dim]``
(in the serving engine ``nbp = num_blocks + 1``, the last page being the
SPILL page dropped writes land on), block tables ``[b, max_blocks]``
int32.  Unlike JAX, PyTorch updates the pools IN PLACE: the fused decode
step writes the appended row straight into the pool tensors it is given
and returns them.
"""

from __future__ import annotations

import math

import torch

from . import (DTYPE_CODE, LAUNCHES, check_cuda_tensor, check_launch,
               library, ptr, stream_ptr, use_kernel)
from .rms_norm import rms_norm_ref
from .rope import apply_rotary_pos_emb
from .swiglu import swiglu

NEG_INF = -1e30

#: split-K shard sizing, as the reference: one shard per this many table
#: pages, at most _FLASH_MAX_SHARDS
_FLASH_PAGES_PER_SHARD = 4
_FLASH_MAX_SHARDS = 8


def kernel_supported(num_heads: int, num_kv_heads: int, head_dim: int,
                     block_size: int) -> bool:
    """Shapes the paged decode kernels take.  The CUDA kernel runs one
    thread per head_dim element (head_dim a multiple of 32 up to 1024) and
    keeps up to 8 q heads per kv head in registers.  (The operational
    opt-outs are the dispatch's: ``ops/kernels.use_kernel``.)"""
    return (head_dim % 32 == 0 and head_dim <= 1024
            and block_size % 8 == 0
            and num_heads % num_kv_heads == 0
            and num_heads // num_kv_heads <= 8)


def flash_decode_shards(max_blocks: int, num_shards: int | None = None) -> int:
    """Shard count of a split-K decode launch from the table width
    (8 at max_seq 2048 / block 64); ``num_shards`` overrides; always
    clamped to [1, max_blocks]."""
    if num_shards is None:
        num_shards = min(_FLASH_MAX_SHARDS,
                         max_blocks // _FLASH_PAGES_PER_SHARD)
    return max(1, min(int(num_shards), max_blocks))


def paged_attention_reference(q, key_cache, value_cache, block_tables,
                              seq_lens, scale=None):
    """The gather oracle: every slot's KV read out to max_blocks * bs, the
    ragged tail masked.  q [b, nh, hd]; caches [nbp, nkv, bs, hd];
    block_tables [b, max_blocks]; seq_lens [b].  Returns [b, nh, hd]; slots
    with seq_len == 0 return zeros.  fp caches only in this slice."""
    nbp, nkv, bs, hd = key_cache.shape
    b, nh, _ = q.shape
    rep = nh // nkv
    S = block_tables.shape[1] * bs
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    safe = block_tables.long().clamp(0, nbp - 1)
    k_seq = key_cache[safe].transpose(1, 2).reshape(b, nkv, S, hd)
    v_seq = value_cache[safe].transpose(1, 2).reshape(b, nkv, S, hd)
    qg = q.reshape(b, nkv, rep, hd)
    logits = torch.einsum("bngd,bnsd->bngs", qg.float(), k_seq.float()) * scale
    cols = torch.arange(S, device=q.device)
    mask = cols[None, None, None, :] < seq_lens.long()[:, None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(seq_lens[:, None, None, None] > 0, p, torch.zeros_like(p))
    out = torch.einsum("bngs,bnsd->bngd", p, v_seq.float())
    return out.reshape(b, nh, hd).to(q.dtype)


def fused_decode_step_reference(q, k_new, v_new, cos, sin, key_cache,
                                value_cache, block_tables, seq_lens,
                                write_blk, writeable, scale=None,
                                num_shards=None):
    """Plain version of the fused decode step: rope in the input dtype
    (``apply_rotary_pos_emb``), a one-row scatter of the roped k and raw v
    into ``write_blk`` for writeable lanes, gather-oracle attention over
    ``seq_lens + 1``.  It then applies the kernel's spill contract: a lane
    with ``writeable == 0`` zeros its write page (the spill page in the
    engine) when the page walk reaches it, i.e. ``seq_lens // bs < S * P``
    for the launch's S shards of P pages.  Updates the pools in place and
    returns ``(out, key_cache, value_cache)``."""
    b, nh, hd = q.shape
    nbp, nkv, bs, _ = key_cache.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q_r, k_r = apply_rotary_pos_emb(q[:, None], k_new[:, None],
                                    cos[:, None, :], sin[:, None, :])
    q_r, k_r = q_r[:, 0], k_r[:, 0]
    lens = seq_lens.long()
    wable = writeable.bool()
    off = lens % bs
    blk = write_blk.long().clamp(0, nbp - 1)
    lanes = torch.nonzero(wable).flatten()
    key_cache[blk[lanes], :, off[lanes]] = k_r[lanes].to(key_cache.dtype)
    value_cache[blk[lanes], :, off[lanes]] = v_new[lanes].to(value_cache.dtype)
    out = paged_attention_reference(q_r, key_cache, value_cache, block_tables,
                                    lens + 1, scale=scale)
    max_blocks = block_tables.shape[1]
    S = flash_decode_shards(max_blocks, num_shards)
    walked = lens // bs < S * (-(-max_blocks // S))
    dropped = torch.nonzero(~wable & walked).flatten()
    key_cache[blk[dropped]] = 0
    value_cache[blk[dropped]] = 0
    return out, key_cache, value_cache


def fused_decode_step_cuda(q, k_new, v_new, cos, sin, key_cache, value_cache,
                           block_tables, seq_lens, write_blk, writeable,
                           scale=None, num_shards=None):
    """Launch ``csrc/fused_decode.cu``: the page walk (pools updated in
    place) and the exact log-sum-exp merge of its split-K partials."""
    b, nh, hd = q.shape
    nbp, nkv, bs, hd_p = key_cache.shape
    dev, dt = q.device, q.dtype
    if dt not in DTYPE_CODE:
        raise ValueError(f"fused_decode_step: dtype {dt} not supported")
    if not kernel_supported(nh, nkv, hd, bs) or hd_p != hd:
        raise ValueError(f"fused_decode_step: unsupported shape nh={nh} "
                         f"nkv={nkv} hd={hd} block_size={bs}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    max_blocks = block_tables.shape[1]
    S = flash_decode_shards(max_blocks, num_shards)
    P = -(-max_blocks // S)
    rep = nh // nkv
    for name, t, shape in (("q", q, (b, nh, hd)), ("k_new", k_new, (b, nkv, hd)),
                           ("v_new", v_new, (b, nkv, hd)), ("cos", cos, (b, hd)),
                           ("sin", sin, (b, hd)),
                           ("key_cache", key_cache, (nbp, nkv, bs, hd)),
                           ("value_cache", value_cache, (nbp, nkv, bs, hd))):
        check_cuda_tensor(f"fused_decode_step {name}", t, shape, dt, dev)
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens),
                    ("write_blk", write_blk), ("writeable", writeable)):
        check_cuda_tensor(f"fused_decode_step {name}", t,
                          (b, max_blocks) if name == "block_tables" else (b,),
                          torch.int32, dev)
    m = torch.empty((b, nkv, S, rep), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, nkv, S, rep, hd), dtype=torch.float32, device=dev)
    out = torch.empty((b, nh, hd), dtype=dt, device=dev)
    err = library().ptt_fused_decode(
        ptr(q), ptr(k_new), ptr(v_new), ptr(cos), ptr(sin), ptr(key_cache),
        ptr(value_cache), ptr(block_tables), ptr(seq_lens), ptr(write_blk),
        ptr(writeable), ptr(m), ptr(l), ptr(acc), ptr(out), b, nh, nkv, hd,
        nbp, bs, max_blocks, S, P, float(scale), DTYPE_CODE[dt],
        stream_ptr(dev))
    check_launch("fused_decode_step", err)
    LAUNCHES["fused_decode_step"] += 1
    return out, key_cache, value_cache


def fused_decode_step(q, k_new, v_new, cos, sin, key_cache, value_cache,
                      block_tables, seq_lens, write_blk, writeable,
                      scale=None, num_shards=None):
    """Fused RoPE + KV-page append + split-K paged attention for ONE decode
    token per slot.

    Args:
      q: [b, num_heads, head_dim] PRE-rope query.
      k_new/v_new: [b, num_kv_heads, head_dim] PRE-rope key / value of the
        token being appended.
      cos/sin: [b, head_dim] rope rows at each slot's append position.
      key_cache/value_cache: [nbp, num_kv_heads, block_size, head_dim] fp
        pools, updated IN PLACE.
      block_tables: [b, max_blocks] int32 physical page ids.
      seq_lens: [b] int32 PRE-append lengths (the append position).
      write_blk: [b] int32 physical append page (the spill page for
        dropped lanes).
      writeable: [b] int32 0/1; 0 drops the append.

    Returns ``(out [b, num_heads, head_dim], key_cache, value_cache)``:
    attention over columns < seq_lens + 1, the appended token included.
    CPU tensors take :func:`fused_decode_step_reference`; CUDA tensors
    launch the kernel (or the plain version under the explicit
    ``fused_decode_step`` opt-out)."""
    args = (q, k_new, v_new, cos, sin, key_cache, value_cache, block_tables,
            seq_lens, write_blk, writeable)
    if use_kernel("fused_decode_step", *args):
        small = [t.contiguous() for t in args[:5]]
        return fused_decode_step_cuda(*small, *args[5:], scale=scale,
                                      num_shards=num_shards)
    return fused_decode_step_reference(*args, scale=scale,
                                       num_shards=num_shards)


# ---------------------------------------------------------------------------
# fused post-attention MLP half
# ---------------------------------------------------------------------------

#: the widest ffn column slice one block of the CUDA kernel owns (32 lanes
#: x 4 columns).  The TPU streamed 256-column blocks through one core in
#: order; the card runs the slices in parallel, one per SM.
_MLP_BLOCK_COLS = 128
#: SMs of an H100, the default slice count
_H100_SMS = 132
#: rows one launch of the CUDA kernel takes (its per-thread accumulators);
#: the wrapper launches once per 8 rows
_MLP_ROWS = 8
#: shared memory one block may use on Hopper
_MAX_SMEM = 227 * 1024


def fused_mlp_splits(inter: int, num_sms: int = _H100_SMS) -> int:
    """ffn column slices of a fused MLP launch, one block each: one per SM,
    more only where a slice would pass 128 columns.  Block i owns an even
    share of the ``inter / 4`` groups of 4 columns."""
    return min(inter // 4, max(num_sms, -(-inter // _MLP_BLOCK_COLS)))


def fused_mlp_block_cols(inter: int, num_sms: int = _H100_SMS) -> int:
    """The widest ffn column slice one block owns (the card's counterpart
    of the TPU kernel's block width): 112 at F = 14336 on 132 SMs."""
    return 4 * -(-(inter // 4) // fused_mlp_splits(inter, num_sms))


def fused_mlp_supported(hidden: int, inter: int) -> bool:
    """Shapes the fused MLP kernel takes: 4-column groups, 16-byte row
    loads, the normalised rows in shared memory."""
    smem = max(hidden * _MLP_ROWS, 16 * 2 * _MLP_ROWS * _MLP_BLOCK_COLS) * 4
    return (hidden % 8 == 0 and inter % 4 == 0
            and smem + (_MLP_BLOCK_COLS * _MLP_ROWS + 32) * 4 <= _MAX_SMEM)


def fused_layer_mlp_reference(x, attn_y, norm_w, w_gate, w_up, w_down, eps):
    """The unfused composition: residual add, rms_norm (its plain
    version, so this stays plain PyTorch on the card), swiglu MLP.
    Returns ``(h1, y)`` with the down projection UN-reduced."""
    h1 = x + attn_y
    xn = rms_norm_ref(h1, norm_w, eps)
    y = swiglu(xn @ w_gate, xn @ w_up) @ w_down
    return h1, y


_SMS: dict = {}


def _num_sms(dev: torch.device) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def fused_layer_mlp_cuda(x, attn_y, norm_w, w_gate, w_up, w_down, eps):
    """Launch ``csrc/fused_mlp.cu``, once per 8 rows."""
    B, h = x.shape
    inter = w_gate.shape[1]
    dev, dt = x.device, x.dtype
    if dt not in DTYPE_CODE or not fused_mlp_supported(h, inter):
        raise ValueError(f"fused_layer_mlp: unsupported h={h} inter={inter} "
                         f"dtype={dt}")
    for name, t, shape in (("x", x, (B, h)), ("attn_y", attn_y, (B, h)),
                           ("norm_w", norm_w, (h,)),
                           ("w_gate", w_gate, (h, inter)),
                           ("w_up", w_up, (h, inter)),
                           ("w_down", w_down, (inter, h))):
        check_cuda_tensor(f"fused_layer_mlp {name}", t, shape, dt, dev)
    h1 = torch.empty_like(x)
    y = torch.empty_like(x)
    nsplit = fused_mlp_splits(inter, _num_sms(dev))
    partial = torch.empty((nsplit, min(B, _MLP_ROWS), h), dtype=torch.float32,
                          device=dev)
    for r0 in range(0, B, _MLP_ROWS):
        rows = min(_MLP_ROWS, B - r0)
        err = library().ptt_fused_mlp(
            ptr(x[r0]), ptr(attn_y[r0]), ptr(norm_w), ptr(w_gate),
            ptr(w_up), ptr(w_down), ptr(h1[r0]), ptr(y[r0]), ptr(partial),
            rows, h, inter, nsplit, float(eps), DTYPE_CODE[dt],
            stream_ptr(dev))
        check_launch("fused_layer_mlp", err)
        LAUNCHES["fused_layer_mlp"] += 1
    return h1, y


def fused_layer_mlp(x, attn_y, norm_w, w_gate, w_up, w_down, eps):
    """Fused post-attention layer half for the decode step: residual add +
    post RMSNorm + SwiGLU MLP.

    Args:
      x: [B, h] residual stream entering the layer half.
      attn_y: [B, h] attention output projection.
      norm_w: [h] post-norm weight; w_gate/w_up: [h, inter]; w_down:
        [inter, h].
      eps: rms epsilon.

    Returns ``(h1, y)``: ``h1 = x + attn_y`` and ``y`` the UN-reduced down
    projection; the caller closes the layer with ``h1 + y``."""
    args = (x, attn_y, norm_w, w_gate, w_up, w_down)
    if use_kernel("fused_layer_mlp", *args):
        return fused_layer_mlp_cuda(*[a.contiguous() for a in args], eps)
    return fused_layer_mlp_reference(*args, eps)
