"""Paged-attention decode kernels, decode half and MLP half (counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``).

Ported: the quantized-KV storage helpers and the requantized appends
(plain PyTorch, XLA in the reference); the gather oracle
``paged_attention_reference`` for fp, int8 and packed-int4 pools; the
unfused decode attention ``paged_attention_decode`` over the sequential
walk, on two routes (:func:`decode_route`: the tensor-core
``csrc/paged_decode_tc.cu``, split over the KV axis and merged in the same
launch, the CUDA-core ``csrc/paged_decode.cu`` ``ptt_paged_decode``) and
the split-K walk, also on two routes (:func:`flash_decode_route`: the same
tensor-core kernel over the caller's shards, merged in the launch; the
CUDA-core ``ptt_flash_decode``, its partials merged by a second launch,
the reference's ``_flash_combine``, whose plain version is here too); the
fused decode step for fp pools (rope + KV-page append + split-K attention)
and for int8 / packed-int4 pools (rope + requantized append +
dequant-on-read attention), both on two routes (:func:`decode_route`: the
tensor-core ``csrc/fused_decode_tc.cu``, its split-K partials merged in
the same launch, the CUDA-core ``csrc/fused_decode.cu`` /
``csrc/fused_quant_decode.cu``); the ragged multi-row walks of the
chunked-prefill mixed step (``paged_attention_prefill``, fp / int8 / int4
pools) and of the speculative verify step (``paged_attention_verify``, fp
pools), both one walk on two routes (:func:`paged_rows_route`: the
tensor-core ``csrc/paged_prefill_tc.cu`` with its split over the KV axis,
the CUDA-core ``csrc/paged_prefill.cu``); and the fused post-attention MLP
half (residual + RMSNorm + SwiGLU, ``csrc/fused_mlp.cu``).  Each kernel has
its plain PyTorch version beside it, with the helpers they share with the
reference: ``kernel_supported``, ``flash_decode_shards``,
``fused_mlp_block_cols`` and ``fused_mlp_supported``.

Layouts are the reference's: pools ``[nbp, nkv, block_size, head_dim]``
(in the serving engine ``nbp = num_blocks + 1``, the last page being the
SPILL page dropped writes land on), quantized pools int8
``[nbp, nkv, block_size, head_dim]`` or, packed two int4 codes a byte,
``[..., head_dim // 2]``, with per-(page, kv head) f32 scales
``[nbp, nkv]``; block tables ``[b, max_blocks]`` int32.  Unlike JAX,
PyTorch updates the pools IN PLACE: the appends and the fused decode steps
write straight into the pool (and scale) tensors they are given and return
them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import (DTYPE_CODE, KV_FORMAT_CODE, LAUNCHES, check_cuda_tensor,
               check_launch, kernel_disabled, library, pick_route, ptr,
               stream_ptr, use_kernel)
from .flash_attention import flash_route
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
    """Shapes the paged decode kernels take.  Each CUDA kernel runs one
    thread per head_dim element (head_dim a multiple of 32 up to 1024,
    which also keeps a packed-int4 row a multiple of 16 bytes for the page
    copies) and keeps up to 8 q heads per kv head in registers.  (The
    operational opt-outs are the dispatch's: ``ops/kernels.use_kernel``.)"""
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


# ---------------------------------------------------------------------------
# quantized-KV storage helpers (plain PyTorch: XLA in the reference)
# ---------------------------------------------------------------------------

_QUANT_BOUND = {"int8": 127.0, "int4": 7.0}


def quantize_kv_cache(cache, mode: str):
    """Quantize a ``[num_blocks, nkv, bs, hd]`` KV cache for dequant-on-read:
    per-(page, kv head) symmetric absmax scales.  Returns ``(q, scale
    [num_blocks, nkv] f32)``, q int8 for 'int8' or, for 'int4', adjacent
    head-dim pairs packed two nibbles a byte into int8 ``[..., hd // 2]``
    (element 2i in the low nibble, 2i+1 in the high one)."""
    return _quant_encode_page(cache.float(), mode)


def _unpack_int4(packed):
    """``[..., hd // 2]`` nibble pairs (any integer dtype) -> f32
    ``[..., hd]`` in [-7, 7]; arithmetic shifts sign-extend each nibble."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = (p << 24) >> 28
    both = torch.stack([lo, hi], dim=-1)
    return both.reshape(*p.shape[:-1], p.shape[-1] * 2).float()


def _dequant_page(raw, scale, kv_quant):
    """Stored KV -> f32 (dequantized with ``scale`` when ``kv_quant``)."""
    if kv_quant == "int8":
        return raw.float() * scale
    if kv_quant == "int4":
        return _unpack_int4(raw) * scale
    return raw.float()


def dequantize_kv_cache(q, scale, mode: str, dtype=torch.float32):
    """Inverse of :func:`quantize_kv_cache`."""
    x = _unpack_int4(q) if mode == "int4" else q.float()
    return (x * scale[:, :, None, None]).to(dtype)


def _quant_encode_page(x, kv_quant: str):
    """f32 page content ``[..., bs, hd]`` -> (codes ``[..., bs, hd_store]``
    int8, scale ``[...]`` f32): scale = absmax * (1 / bound), codes =
    clip(round(x / max(scale, 1e-10)), -bound, bound) (``torch.round``
    rounds half to even, as ``jnp.round``).  The reference writes
    ``absmax / bound``; its compiled programs (XLA, whose engines store the
    pools) turn that division by a constant into a multiply by the f32
    reciprocal, so the port multiplies too and stores the same bytes.  The
    ONE encode every append path calls: the plain appends here and, in the
    same arithmetic, the fused kernel's in-register requantize."""
    bound = _QUANT_BOUND[kv_quant]
    absmax = x.abs().amax(dim=(-2, -1))
    scale = (absmax * (1.0 / bound)).float()
    q = torch.round(x / scale.clamp(min=1e-10)[..., None, None]) \
        .clamp(-bound, bound)
    if kv_quant == "int8":
        return q.to(torch.int8), scale
    pairs = q.to(torch.int32).reshape(*q.shape[:-1], q.shape[-1] // 2, 2)
    packed = (pairs[..., 0] & 0xF) | ((pairs[..., 1] & 0xF) << 4)
    return packed.to(torch.int8), scale


def _dequant_page_content(codes, scale, kv_quant: str):
    """Inverse of :func:`_quant_encode_page` on page content: codes
    ``[..., bs, hd_store]`` + scale ``[...]`` -> f32 ``[..., bs, hd]``."""
    x = _unpack_int4(codes) if kv_quant == "int4" else codes.float()
    return x * scale[..., None, None]


def quant_append_decode(qpool, scale, rows, blk, off, writeable,
                        kv_quant: str):
    """Requantized single-row KV append into an int8 / packed-int4 pool,
    IN PLACE: gather the write page, dequantize it with its old scale,
    insert the row, recompute the page's scale, requantize, write page and
    scale back.  The plain version of the fused quant kernel's append, and
    the kill-switched decode arm's.

    qpool [nbp, nkv, bs, hd_store] int8; scale [nbp, nkv] f32; rows
    [b, nkv, hd] (the roped k or raw v row, any fp dtype); blk [b] physical
    write page; off [b] row offset; writeable [b] -- 0 drops the append
    (page and scale untouched), as does a page outside the pool.  Lanes
    that write own distinct pages (the allocator's invariant); a dropped
    lane writes its page's own bytes back, so nothing here waits for the
    device to pick the lanes.  Returns ``(qpool, scale)``."""
    nbp = qpool.shape[0]
    blk = blk.long()
    keep = writeable.bool() & (blk >= 0) & (blk < nbp)
    pages = blk.clamp(0, nbp - 1)
    old_q, old_s = qpool[pages], scale[pages]
    deq = _dequant_page_content(old_q, old_s, kv_quant)
    deq[torch.arange(len(pages), device=deq.device), :, off.long()] = \
        rows.float()
    codes, nsc = _quant_encode_page(deq, kv_quant)
    qpool[pages] = torch.where(keep[:, None, None, None], codes, old_q)
    scale[pages] = torch.where(keep[:, None], nsc, old_s)
    return qpool, scale


def quant_append_rows(qpool, scale, rows, table, row_pos, valid,
                      kv_quant: str):
    """Requantized MULTI-row KV append (one write event: a prefill bucket,
    a mixed step's chunk or a verify step's draft window) into an int8 /
    packed-int4 pool, IN PLACE.  A slot's live rows are consecutive
    positions, so the event touches at most ``(T-1)//bs + 2`` logical
    pages: only that window of each slot's table row is gathered and
    dequantized, the rows inserted at their positions, the scales
    recomputed, and the dirty pages (those that received a row) take the
    new codes; every other page keeps its exact bytes.

    Nothing here waits for the device (no ``nonzero``, no boolean-mask
    indexing): every row is scattered, a dropped one into an extra window
    slot that is cut off; every window entry is written back, a dirty one
    with its new codes and a clean or sentinel one (clamped to the pool)
    with the bytes its page ends up holding -- its own, or the new codes of
    the dirty entry that aliases the page -- so writes to one page agree
    and their order does not matter.

    qpool [nbp, nkv, bs, hd_store]; scale [nbp, nkv] f32; rows
    [B, T, nkv, hd]; table [B, max_blocks] physical page ids; row_pos
    [B, T] absolute position of each row; valid [B, T] -- rows with 0 are
    dropped.  Returns ``(qpool, scale)``."""
    nbp, bs = qpool.shape[0], qpool.shape[2]
    B, maxblk = table.shape
    T = rows.shape[1]
    dev = qpool.device
    nwin = min(maxblk, (T - 1) // bs + 2)
    valid = valid.bool()
    safe_pos = torch.where(valid, row_pos.long(), 0)
    lblk, loff = safe_pos // bs, safe_pos % bs           # [B, T]
    # window start: the slot's first live logical page (0 if none live)
    lmin = torch.where(valid, lblk, maxblk).amin(dim=1)
    p0 = torch.where(lmin == maxblk, 0, lmin)            # [B]
    win = (p0[:, None] + torch.arange(nwin, device=dev)).clamp(0, maxblk - 1)
    wtab = table.long().gather(1, win)                   # [B, nwin]
    pages = wtab.clamp(0, nbp - 1)
    old_q, old_s = qpool[pages], scale[pages]
    deq = _dequant_page_content(old_q, old_s, kv_quant)
    # invalid rows (and, as the reference's drop, rows outside the window)
    # land in window slot nwin, which is cut off below
    wblk = lblk - p0[:, None]
    wblk = torch.where(valid & (wblk < nwin), wblk, nwin)
    deq = torch.cat([deq, deq.new_zeros((B, 1) + deq.shape[2:])], dim=1)
    deq[torch.arange(B, device=dev)[:, None], wblk, :, loff] = rows.float()
    codes, nsc = _quant_encode_page(deq[:, :nwin], kv_quant)
    dirty = (wblk[:, :, None] == torch.arange(nwin, device=dev)).any(dim=1)
    dirty &= (wtab >= 0) & (wtab < nbp)
    # entry e's page ends up with the codes of the dirty entry that targets
    # it (the allocator gives each dirty page one owner), else its own bytes
    E = B * nwin
    flat = pages.reshape(E)
    hits = (flat[:, None] == flat[None, :]) & dirty.reshape(1, E)
    src = hits.to(torch.int32).argmax(dim=1)
    has = hits.any(dim=1)
    new_q = torch.where(has[:, None, None, None],
                        codes.reshape(E, *codes.shape[2:])[src],
                        old_q.reshape(E, *old_q.shape[2:]))
    new_s = torch.where(has[:, None], nsc.reshape(E, -1)[src],
                        old_s.reshape(E, -1))
    qpool[flat] = new_q
    scale[flat] = new_s
    return qpool, scale


# ---------------------------------------------------------------------------
# the gather oracle and the split-K combine
# ---------------------------------------------------------------------------

def _check_storage(name, q, key_cache, kv_quant, k_scale, v_scale) -> int:
    """The reference's argument asserts (as ValueError); returns head_dim."""
    if kv_quant not in (None, "int8", "int4"):
        raise ValueError(f"{name}: kv_quant must be None, 'int8' or 'int4', "
                         f"got {kv_quant!r}")
    hd = q.shape[-1]
    hd_store = key_cache.shape[-1]
    if hd_store != (hd // 2 if kv_quant == "int4" else hd) or (
            kv_quant == "int4" and hd % 2):
        raise ValueError(f"{name}: pool head_dim {hd_store} does not store "
                         f"q's {hd} as kv_quant={kv_quant!r}")
    if kv_quant and (k_scale is None or v_scale is None):
        raise ValueError(f"{name}: quantized KV pools need k_scale/v_scale")
    return hd


def _gather_kv(cache, cache_scale, pages, kv_quant):
    """Pages ``[b, n]`` of one pool -> f32 ``[b, nkv, n * bs, hd]``: gather
    first, then dequantize only what was gathered (dequantizing the whole
    pool would materialise every page at full precision)."""
    x = cache[pages]                              # [b, n, nkv, bs, hd_st]
    if kv_quant:
        x = _dequant_page(x, cache_scale[pages][..., None, None], kv_quant)
    b, n, nkv, bs, hd = x.shape
    return x.float().transpose(1, 2).reshape(b, nkv, n * bs, hd)


def paged_attention_reference(q, key_cache, value_cache, block_tables,
                              seq_lens, scale=None, kv_quant=None,
                              k_scale=None, v_scale=None):
    """The gather oracle: every slot's KV read out to max_blocks * bs, the
    ragged tail masked.  q [b, nh, hd]; caches [nbp, nkv, bs, hd] (or
    quantized storage per ``kv_quant`` with ``k_scale``/``v_scale``
    [nbp, nkv] f32); block_tables [b, max_blocks]; seq_lens [b].  Returns
    [b, nh, hd] in q's dtype; slots with seq_len == 0 return zeros."""
    hd = _check_storage("paged_attention_reference", q, key_cache, kv_quant,
                        k_scale, v_scale)
    nbp, nkv = key_cache.shape[:2]
    b, nh, _ = q.shape
    rep = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    safe = block_tables.long().clamp(0, nbp - 1)
    k_seq = _gather_kv(key_cache, k_scale, safe, kv_quant)
    v_seq = _gather_kv(value_cache, v_scale, safe, kv_quant)
    S = k_seq.shape[2]
    qg = q.reshape(b, nkv, rep, hd)
    logits = torch.einsum("bngd,bnsd->bngs", qg.float(), k_seq) * scale
    cols = torch.arange(S, device=q.device)
    mask = cols[None, None, None, :] < seq_lens.long()[:, None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(seq_lens[:, None, None, None] > 0, p, torch.zeros_like(p))
    out = torch.einsum("bngs,bnsd->bngd", p, v_seq)
    return out.reshape(b, nh, hd).to(q.dtype)


def _flash_combine(m, l, acc):
    """Log-sum-exp merge of per-shard partials: m/l [b, nkv, S, group, 1]
    f32, acc [b, nkv, S, group, hd] f32 -> [b, nkv, group, hd].  Each
    shard's contribution is rescaled to the global max, so the result is
    the sequential walk's softmax; all shards empty (seq_len == 0) -> 0."""
    m_max = m.amax(dim=2, keepdim=True)
    w = torch.where(m > 0.5 * NEG_INF, torch.exp(m - m_max),
                    torch.zeros_like(m))
    l_tot = (w * l).sum(dim=2)
    acc_tot = (w * acc).sum(dim=2)
    return acc_tot / torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)


def flash_decode_reference(q, key_cache, value_cache, block_tables, seq_lens,
                           scale, num_shards, kv_quant=None, k_scale=None,
                           v_scale=None):
    """Plain version of the split-K decode.  Shard s attends the logical
    pages [s * P, (s + 1) * P) (table column clamped to the table width,
    page id to the pool, as ``_resolve_page``) over columns < seq_lens and
    emits its raw partial (m, l, acc); a shard with no live column emits
    m = -1e30, l = 0, acc = 0.  :func:`_flash_combine` merges the partials.
    Returns [b, nh, hd] in q's dtype."""
    b, nh, hd = q.shape
    nbp, nkv, bs, _ = key_cache.shape
    rep = nh // nkv
    max_blocks = block_tables.shape[1]
    S = num_shards
    P = -(-max_blocks // S)
    dev = q.device
    j = torch.arange(S * P, device=dev)
    pages = block_tables.long()[:, j.clamp(max=max_blocks - 1)] \
        .clamp(0, nbp - 1)                                   # [b, S * P]
    k = _gather_kv(key_cache, k_scale, pages, kv_quant)
    v = _gather_kv(value_cache, v_scale, pages, kv_quant)
    k = k.reshape(b, nkv, S, P * bs, hd)
    v = v.reshape(b, nkv, S, P * bs, hd)
    s = torch.einsum("bngd,bnstd->bnsgt", q.reshape(b, nkv, rep, hd).float(),
                     k) * scale
    cols = (j[:, None] * bs + torch.arange(bs, device=dev)).reshape(S, P * bs)
    live = cols[None] < seq_lens.long()[:, None, None]       # [b, S, P*bs]
    s = torch.where(live[:, None, :, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                         # [b,nkv,S,rep,1]
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bnsgt,bnstd->bnsgd", p, v)
    return _flash_combine(m, l, acc).reshape(q.shape).to(q.dtype)


# ---------------------------------------------------------------------------
# unfused paged decode attention: the sequential and the split-K walk
# ---------------------------------------------------------------------------

def decode_shards(max_blocks: int, num_shards: int | None = None) -> int:
    """The split-K fan-out a decode launch takes: 1 (the sequential walk)
    under the ``flash_decode`` switch, which wins over an explicit
    ``num_shards``, else :func:`flash_decode_shards`."""
    if kernel_disabled("flash_decode"):
        return 1
    return flash_decode_shards(max_blocks, num_shards)


def decode_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which hand-written kernel the fused decode steps (fp and quantized
    pools) and the unfused sequential walk take on the card, by the rule of
    :func:`~.flash_attention.flash_route`: ``"tc"`` (mma.sync tensor cores,
    ``csrc/fused_decode_tc.cu`` / ``csrc/paged_decode_tc.cu``) for bf16/f16
    q at head_dim 64 or 128, ``"cc"`` (the CUDA-core kernels) for every
    other shape the wrappers take (they take f32 and bf16 q)."""
    return flash_route(dtype, head_dim)


#: (device, stream) -> the tensor-core decode kernels' merge tickets, one
#: int32 a (slot, kv head), zero between launches (each launch leaves them
#: zero); one buffer a stream, so launches on two streams never share one
_TICKETS: dict = {}


def _decode_tickets(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                        device=dev)
    return t


def _check_walk(name, q, key_cache, value_cache, block_tables, seq_lens,
                kv_quant, k_scale, v_scale):
    """Wrapper-side validation of a paged walk's operands."""
    b, nh, hd = q.shape
    nbp, nkv, bs, hd_st = key_cache.shape
    dt, dev = q.dtype, q.device
    if dt not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dt} not supported")
    if not kernel_supported(nh, nkv, hd, bs):
        raise ValueError(f"{name}: unsupported shape nh={nh} nkv={nkv} "
                         f"hd={hd} block_size={bs}")
    pool_dt = torch.int8 if kv_quant else dt
    check_cuda_tensor(f"{name} q", q, (b, nh, hd), dt, dev)
    for pname, t in (("key_cache", key_cache), ("value_cache", value_cache)):
        check_cuda_tensor(f"{name} {pname}", t, (nbp, nkv, bs, hd_st),
                          pool_dt, dev)
    if kv_quant:
        for pname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda_tensor(f"{name} {pname}", t, (nbp, nkv),
                              torch.float32, dev)
    check_cuda_tensor(f"{name} block_tables", block_tables,
                      (b, block_tables.shape[1]), torch.int32, dev)
    check_cuda_tensor(f"{name} seq_lens", seq_lens, (b,), torch.int32, dev)


def _scale_ptrs(kv_quant, k_scale, v_scale):
    if kv_quant:
        return ptr(k_scale), ptr(v_scale)
    return ctypes.c_void_p(0), ctypes.c_void_p(0)


#: the sequential walk's tensor-core route splits a lane's walk into runs
#: of this many table pages, at most _SEQ_MAX_SPLITS of them (the most
#: ``csrc/paged_decode_tc.cu`` launches: ``kMaxSplits``)
_SEQ_PAGES_PER_SPLIT = 4
_SEQ_MAX_SPLITS = 16


def seq_decode_splits(max_blocks: int) -> int:
    """Splits of the sequential walk's tensor-core launch, from the table
    width alone (8 at max_seq 2048 / block 64): runs of about
    ``_SEQ_PAGES_PER_SPLIT`` pages, at most ``_SEQ_MAX_SPLITS``, none past
    the table.  Its own rule, not :func:`decode_shards`, which the
    ``flash_decode`` switch sets to 1."""
    S = max(1, min(_SEQ_MAX_SPLITS, -(-max_blocks // _SEQ_PAGES_PER_SPLIT)))
    return -(-max_blocks // -(-max_blocks // S))


def paged_decode_cuda(q, key_cache, value_cache, block_tables, seq_lens,
                      scale, kv_quant=None, k_scale=None, v_scale=None,
                      route=None):
    """Launch the sequential walk on ``route`` (default
    :func:`decode_route`): ``csrc/paged_decode_tc.cu``'s
    ``ptt_paged_decode_tc`` (tensor cores, the walk split over the KV axis
    in :func:`seq_decode_splits` runs of table pages, merged in the same
    launch) or ``csrc/paged_decode.cu``'s
    ``ptt_paged_decode`` (one block per slot and kv head); returns
    [b, nh, hd]."""
    _check_walk("paged_decode", q, key_cache, value_cache, block_tables,
                seq_lens, kv_quant, k_scale, v_scale)
    b, nh, hd = q.shape
    nbp, nkv, bs, _ = key_cache.shape
    max_blocks = block_tables.shape[1]
    dev = q.device
    route = pick_route("paged_decode", q, route, decode_route(q.dtype, hd))
    out = torch.empty_like(q)
    head = (ptr(q), ptr(key_cache), ptr(value_cache),
            *_scale_ptrs(kv_quant, k_scale, v_scale), ptr(block_tables),
            ptr(seq_lens))
    tail = (float(scale), DTYPE_CODE[q.dtype], KV_FORMAT_CODE[kv_quant],
            stream_ptr(dev))
    if route == "tc":
        S = seq_decode_splits(max_blocks)
        P = -(-max_blocks // S)
        rep = nh // nkv
        m = torch.empty((b, nkv, S, rep), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        acc = torch.empty((b, nkv, S, rep, hd), dtype=torch.float32,
                          device=dev)
        err = library().ptt_paged_decode_tc(
            *head, ptr(m), ptr(l), ptr(acc),
            ptr(_decode_tickets(dev, b * nkv)), ptr(out), b, nh, nkv, hd,
            nbp, bs, max_blocks, S, P, *tail)
    else:
        err = library().ptt_paged_decode(
            *head, ptr(out), b, nh, nkv, hd, nbp, bs, max_blocks, *tail)
    check_launch("paged_decode", err)
    LAUNCHES["paged_decode"] += 1
    if route == "tc":
        LAUNCHES["paged_decode_tc"] += 1
    return out


#: the most shards the split-K walk's tensor-core launch takes
#: (``csrc/paged_decode_tc.cu`` ``kMaxSplitKShards``: its in-launch merge
#: keeps m and l of every shard in shared memory)
_SPLITK_MAX_SHARDS = 64


def flash_decode_route(dtype: torch.dtype, head_dim: int,
                       num_shards: int) -> str:
    """Which hand-written kernel the split-K walk takes on the card:
    ``"tc"`` (``csrc/paged_decode_tc.cu`` ``ptt_flash_decode_tc``: mma.sync,
    the shards' partials merged in the same launch) where
    :func:`decode_route` names the tensor cores and ``num_shards`` is at
    most ``_SPLITK_MAX_SHARDS``; ``"cc"`` (``csrc/paged_decode.cu``
    ``ptt_flash_decode`` and its combine launch) for every other shape."""
    if decode_route(dtype, head_dim) == "tc" and \
            num_shards <= _SPLITK_MAX_SHARDS:
        return "tc"
    return "cc"


def flash_decode_cuda(q, key_cache, value_cache, block_tables, seq_lens,
                      scale, num_shards, kv_quant=None, k_scale=None,
                      v_scale=None, route=None):
    """Launch the split-K walk over ``num_shards`` shards of
    ``ceil(max_blocks / num_shards)`` table pages on ``route`` (default
    :func:`flash_decode_route`): ``csrc/paged_decode_tc.cu``'s
    ``ptt_flash_decode_tc`` (tensor cores, the partials merged in the same
    launch) or ``csrc/paged_decode.cu``'s ``ptt_flash_decode`` and the
    combine of its partials; returns [b, nh, hd]."""
    _check_walk("flash_decode", q, key_cache, value_cache, block_tables,
                seq_lens, kv_quant, k_scale, v_scale)
    b, nh, hd = q.shape
    nbp, nkv, bs, _ = key_cache.shape
    max_blocks = block_tables.shape[1]
    S = num_shards
    P = -(-max_blocks // S)
    rep = nh // nkv
    dev = q.device
    route = pick_route("flash_decode", q, route,
                       flash_decode_route(q.dtype, hd, S), f", {S} shards")
    m = torch.empty((b, nkv, S, rep), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, nkv, S, rep, hd), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    head = (ptr(q), ptr(key_cache), ptr(value_cache),
            *_scale_ptrs(kv_quant, k_scale, v_scale), ptr(block_tables),
            ptr(seq_lens), ptr(m), ptr(l), ptr(acc))
    tail = (b, nh, nkv, hd, nbp, bs, max_blocks, S, P, float(scale),
            DTYPE_CODE[q.dtype], KV_FORMAT_CODE[kv_quant], stream_ptr(dev))
    if route == "tc":
        err = library().ptt_flash_decode_tc(
            *head, ptr(_decode_tickets(dev, b * nkv)), ptr(out), *tail)
    else:
        err = library().ptt_flash_decode(*head, ptr(out), *tail)
    check_launch("flash_decode", err)
    LAUNCHES["flash_decode"] += 1
    if route == "tc":
        LAUNCHES["flash_decode_tc"] += 1
    return out


def paged_attention_decode(q, key_cache, value_cache, block_tables, seq_lens,
                           scale=None, kv_quant=None, k_scale=None,
                           v_scale=None, num_shards=None):
    """Ragged paged-attention decode over a block-table KV cache, one query
    token per slot.

    Args:
      q: [b, num_heads, head_dim], roped.
      key_cache/value_cache: [nbp, num_kv_heads, block_size, head_dim]
        pages of q's dtype, or quantized storage per ``kv_quant``: 'int8'
        int8 of the same shape, 'int4' int8 ``[..., head_dim // 2]`` with
        two codes a byte (:func:`quantize_kv_cache`).
      block_tables: [b, max_blocks] int32 physical page ids; entries past a
        slot's live pages may be sentinels (clamped, never attended).
      seq_lens: [b] int32 valid KV length per slot (0 -> zeros).
      k_scale/v_scale: [nbp, num_kv_heads] f32 (quantized pools).
      num_shards: split-K override; None picks :func:`flash_decode_shards`
        from the table width; 1 is the sequential walk.

    Returns [b, num_heads, head_dim] in q's dtype.  Routes as the
    reference: the split-K walk when :func:`decode_shards` fans out (the
    ``flash_decode`` switch restores the sequential walk), the sequential
    walk otherwise, the gather oracle under ``paged_attention``.  CUDA
    tensors launch the kernel (``paged_decode`` / ``flash_decode``) or
    raise; CPU tensors take the plain versions (:func:`paged_attention_
    reference` for the sequential walk, :func:`flash_decode_reference` for
    the split-K one)."""
    hd = _check_storage("paged_attention_decode", q, key_cache, kv_quant,
                        k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    oracle = kernel_disabled("paged_attention")
    S = 1 if oracle else decode_shards(block_tables.shape[1], num_shards)
    name = "flash_decode" if S > 1 else "paged_decode"
    scales = (k_scale, v_scale) if kv_quant else ()
    args = (q, key_cache, value_cache, block_tables, seq_lens)
    kw = dict(kv_quant=kv_quant, k_scale=k_scale, v_scale=v_scale)
    if use_kernel(name, *args, *scales, switch="paged_attention"):
        small = (q.contiguous(), key_cache, value_cache,
                 block_tables.int().contiguous(), seq_lens.int().contiguous())
        if S > 1:
            return flash_decode_cuda(*small, scale, S, **kw)
        return paged_decode_cuda(*small, scale, **kw)
    if S > 1:
        return flash_decode_reference(*args, scale, S, **kw)
    return paged_attention_reference(*args, scale=scale, **kw)


# ---------------------------------------------------------------------------
# ragged multi-row paged attention: chunked prefill and speculative verify
# ---------------------------------------------------------------------------

def _row_lens(seq_lens, q_lens, T: int):
    """[b, T] visible KV positions of each query row: row t of a slot sits
    at position ``seq_lens - q_lens + t`` and sees ``seq_lens - (q_lens - 1
    - t)`` positions; rows at or past ``q_lens`` see none."""
    t = torch.arange(T, device=seq_lens.device)[None, :]
    ql = q_lens.long()[:, None]
    return torch.where(t < ql, seq_lens.long()[:, None] - (ql - 1 - t), 0)


def paged_prefill_reference(q, key_cache, value_cache, block_tables,
                            seq_lens, q_lens, scale=None, kv_quant=None,
                            k_scale=None, v_scale=None):
    """The gather oracle of the ragged multi-row walk (the plain version of
    both ``paged_prefill`` and ``paged_verify``): every slot's pages read
    out to max_blocks * bs (quantized pages dequantized after the gather),
    each row under its own causal mask (:func:`_row_lens`).  q [b, T, nh,
    hd]; caches [nbp, nkv, bs, hd] (or quantized storage per ``kv_quant``
    with ``k_scale``/``v_scale`` [nbp, nkv] f32); block_tables [b,
    max_blocks]; seq_lens [b] total written length incl. the rows; q_lens
    [b] live rows.  Returns [b, T, nh, hd] in q's dtype; rows with nothing
    to attend (past q_lens, or an empty window) are exact zeros."""
    hd = _check_storage("paged_prefill_reference", q, key_cache, kv_quant,
                        k_scale, v_scale)
    nbp, nkv = key_cache.shape[:2]
    b, T, nh, _ = q.shape
    rep = nh // nkv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    safe = block_tables.long().clamp(0, nbp - 1)
    k_seq = _gather_kv(key_cache, k_scale, safe, kv_quant)
    v_seq = _gather_kv(value_cache, v_scale, safe, kv_quant)
    S = k_seq.shape[2]
    qg = q.reshape(b, T, nkv, rep, hd)
    logits = torch.einsum("btngd,bnsd->btngs", qg.float(), k_seq) * scale
    row_len = _row_lens(seq_lens, q_lens, T)[:, :, None, None, None]
    cols = torch.arange(S, device=q.device)
    logits = torch.where(cols < row_len, logits,
                         torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(row_len > 0, p, torch.zeros_like(p))
    out = torch.einsum("btngs,bnsd->btngd", p, v_seq)
    return out.reshape(b, T, nh, hd).to(q.dtype)


def paged_verify_reference(q, key_cache, value_cache, block_tables,
                           seq_lens, q_lens, scale=None):
    """The verify walk's plain version: :func:`paged_prefill_reference` over
    fp pools (verify is its T = K+1 case)."""
    return paged_prefill_reference(q, key_cache, value_cache, block_tables,
                                   seq_lens, q_lens, scale=scale)


def _check_rows(name, q, key_cache, value_cache, block_tables, seq_lens,
                q_lens, kv_quant, k_scale, v_scale):
    """Wrapper-side validation of a multi-row walk's operands: the shared
    paged predicate, and head_dim at most 256 (the f32 q, K and V tiles of
    a block stay in shared memory)."""
    b, T, nh, hd = q.shape
    nbp, nkv, bs, hd_st = key_cache.shape
    dt, dev = q.dtype, q.device
    if dt not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dt} not supported")
    if not kernel_supported(nh, nkv, hd, bs) or hd > 256:
        raise ValueError(f"{name}: unsupported shape nh={nh} nkv={nkv} "
                         f"hd={hd} block_size={bs}")
    check_cuda_tensor(f"{name} q", q, (b, T, nh, hd), dt, dev)
    pool_dt = torch.int8 if kv_quant else dt
    for pname, t in (("key_cache", key_cache), ("value_cache", value_cache)):
        check_cuda_tensor(f"{name} {pname}", t, (nbp, nkv, bs, hd_st),
                          pool_dt, dev)
    if kv_quant:
        for pname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda_tensor(f"{name} {pname}", t, (nbp, nkv),
                              torch.float32, dev)
    check_cuda_tensor(f"{name} block_tables", block_tables,
                      (b, block_tables.shape[1]), torch.int32, dev)
    for pname, t in (("seq_lens", seq_lens), ("q_lens", q_lens)):
        check_cuda_tensor(f"{name} {pname}", t, (b,), torch.int32, dev)


#: rows of a tensor-core row tile (one warpgroup's wgmma M) and columns of
#: a KV tile
ROWS_TILE = 64
#: the split over the KV axis: at most this many blocks a few-row lane,
#: one per _ROWS_TILES_PER_SPLIT of the table's KV tiles; a longer lane's
#: row tile in at most _ROWS_LONG_SPLITS, from _ROWS_LONG_WALK KV tiles up
_ROWS_MAX_SPLITS = 8
_ROWS_TILES_PER_SPLIT = 4
_ROWS_LONG_SPLITS = 2
_ROWS_LONG_WALK = 16


def paged_rows_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which hand-written walk the multi-row paged attention (prefill and
    verify) takes on the card, by the rule of
    :func:`~.flash_attention.flash_route`: ``"tc"`` (wgmma tensor cores,
    split over the KV axis) for bf16/f16 q at head_dim 64 or 128, ``"cc"``
    (the f32 CUDA-core walk) for every other shape the wrappers take (they
    take f32 and bf16 q)."""
    return flash_route(dtype, head_dim)


def rows_max_splits(max_blocks: int, block_size: int) -> int:
    """Blocks a lane's KV walk may split into, fixed on the host from the
    table width alone (no host sync): one per _ROWS_TILES_PER_SPLIT KV
    tiles the table can reach, 1 to _ROWS_MAX_SPLITS (8 at max_seq 2048)."""
    tiles = -(-max_blocks * block_size // ROWS_TILE)
    return max(1, min(_ROWS_MAX_SPLITS, tiles // _ROWS_TILES_PER_SPLIT))


def rows_split(n_tiles: int, max_splits: int, few_rows: bool):
    """The KV-tile ranges ``[(start, end), ...]`` the blocks of one row
    tile walk (csrc/paged_prefill_tc.cu ``rows_split``, the same rule): a
    lane whose live rows fit one row tile (``few_rows``: a decode lane,
    verify rows) splits its ``n_tiles`` into up to ``max_splits`` runs of
    equal length (the last shorter), none empty; a longer lane's row tile
    into up to two from _ROWS_LONG_WALK tiles up, else one.  Every tile
    lies in exactly one range (one empty range when there is none)."""
    if few_rows:
        n = min(max_splits, n_tiles)
    else:
        n = (min(_ROWS_LONG_SPLITS, max_splits)
             if n_tiles >= _ROWS_LONG_WALK else 1)
    n = max(1, n)
    per = -(-n_tiles // n)
    n = -(-n_tiles // per) if per else 1
    return [(s * per, min(n_tiles, (s + 1) * per)) for s in range(n)]


def paged_prefill_cuda(q, key_cache, value_cache, block_tables, seq_lens,
                       q_lens, scale, kv_quant=None, k_scale=None,
                       v_scale=None, name="paged_prefill", route=None):
    """Launch the multi-row walk on ``route`` (default
    :func:`paged_rows_route`): ``csrc/paged_prefill_tc.cu``'s
    ``ptt_paged_prefill_tc`` (grid: slot x kv head, 64-row tiles and their
    splits over the KV axis, then the combine of the partials) or
    ``csrc/paged_prefill.cu``'s ``ptt_paged_prefill`` (slot x kv head,
    64-row tiles); returns [b, T, nh, hd].  ``name`` is the kernel the
    launch counts as: ``paged_verify`` for the verify step's K+1 rows over
    fp pools (B10, the same walk)."""
    _check_rows(name, q, key_cache, value_cache, block_tables,
                seq_lens, q_lens, kv_quant, k_scale, v_scale)
    b, T, nh, hd = q.shape
    nbp, nkv, bs, _ = key_cache.shape
    max_blocks = block_tables.shape[1]
    route = pick_route(name, q, route, paged_rows_route(q.dtype, hd))
    out = torch.empty_like(q)
    head = (ptr(q), ptr(key_cache), ptr(value_cache),
            *_scale_ptrs(kv_quant, k_scale, v_scale), ptr(block_tables),
            ptr(seq_lens), ptr(q_lens), ptr(out))
    tail = (float(scale), DTYPE_CODE[q.dtype], KV_FORMAT_CODE[kv_quant],
            stream_ptr(q.device))
    if route == "tc":
        splits = rows_max_splits(max_blocks, bs)
        rows = T * (nh // nkv)
        prow = min(ROWS_TILE, rows)
        parts = (ctypes.c_void_p(0),) * 3
        if splits > 1:
            # a partial slot for each block the walk launches: the split
            # blocks of every row tile and the further ones of row tile 0
            ts = min(_ROWS_LONG_SPLITS, splits)
            slots = -(-rows // ROWS_TILE) * ts + splits - ts
            m = torch.empty((b * nkv, slots, prow), dtype=torch.float32,
                            device=q.device)
            l = torch.empty_like(m)
            acc = torch.empty((b * nkv, slots, prow, hd),
                              dtype=torch.float32, device=q.device)
            parts = (ptr(m), ptr(l), ptr(acc))
        err = library().ptt_paged_prefill_tc(
            *head, *parts, b, T, nh, nkv, hd, nbp, bs, max_blocks, splits,
            *tail)
    else:
        err = library().ptt_paged_prefill(
            *head, b, T, nh, nkv, hd, nbp, bs, max_blocks, *tail)
    check_launch(name, err)
    LAUNCHES[name] += 1
    if route == "tc":
        LAUNCHES[f"{name}_tc"] += 1
    return out


def _small_rows(q, block_tables, seq_lens, q_lens):
    return (q.contiguous(), block_tables.int().contiguous(),
            seq_lens.int().contiguous(), q_lens.int().contiguous())


def paged_attention_prefill(q, key_cache, value_cache, block_tables,
                            seq_lens, q_lens, scale=None, kv_quant=None,
                            k_scale=None, v_scale=None):
    """Ragged chunked prefill over a block-table KV cache (the serving
    engine's mixed prefill/decode step).

    Args:
      q: [b, T, num_heads, head_dim], roped: per slot up to ``T`` query
        rows at consecutive positions (row t at ``seq_lens - q_lens + t``):
        a prefill chunk, or one pending decode token (``q_lens == 1``).
      key_cache/value_cache: [nbp, num_kv_heads, block_size, head_dim]
        pages of q's dtype with every row's K/V already written, or
        quantized storage per ``kv_quant`` (:func:`quantize_kv_cache`).
      block_tables: [b, max_blocks] int32 physical page ids.
      seq_lens: [b] int32 total written length incl. the rows.
      q_lens: [b] int32 live rows (1..T).
      k_scale/v_scale: [nbp, num_kv_heads] f32 (quantized pools).

    Returns [b, T, num_heads, head_dim] in q's dtype: row t attends the
    written prefix and the rows through itself; rows at or past q_lens are
    zeros.  CUDA tensors launch ``paged_prefill`` or raise; CPU tensors,
    or the ``paged_attention`` switch, take :func:`paged_prefill_reference`
    (the reference's one launch-or-gather decision for the paged family)."""
    hd = _check_storage("paged_attention_prefill", q, key_cache, kv_quant,
                        k_scale, v_scale)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    scales = (k_scale, v_scale) if kv_quant else ()
    args = (q, key_cache, value_cache, block_tables, seq_lens, q_lens)
    kw = dict(kv_quant=kv_quant, k_scale=k_scale, v_scale=v_scale)
    if use_kernel("paged_prefill", *args, *scales, switch="paged_attention"):
        q_, t_, s_, ql_ = _small_rows(q, block_tables, seq_lens, q_lens)
        return paged_prefill_cuda(q_, key_cache, value_cache, t_, s_, ql_,
                                  scale, **kw)
    return paged_prefill_reference(*args, scale=scale, **kw)


def paged_attention_verify(q, key_cache, value_cache, block_tables, seq_lens,
                           q_lens, scale=None):
    """Ragged multi-token verification over fp pools (the speculative
    target step): q [b, K+1, num_heads, head_dim] (row 0 the pending token,
    rows 1.. the drafts, at consecutive positions), the pools holding every
    row's K/V, seq_lens [b] the total written length incl. the drafts,
    q_lens [b] live rows.  Row t attends everything up to and including its
    own position, never the later drafts.  Returns [b, K+1, nh, hd]; rows
    past q_lens are zeros.  Dispatch as :func:`paged_attention_prefill`
    (kernel ``paged_verify``); quantized pools go through the prefill walk,
    as in the reference."""
    hd = _check_storage("paged_attention_verify", q, key_cache, None, None,
                        None)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    args = (q, key_cache, value_cache, block_tables, seq_lens, q_lens)
    if use_kernel("paged_verify", *args, switch="paged_attention"):
        q_, t_, s_, ql_ = _small_rows(q, block_tables, seq_lens, q_lens)
        return paged_prefill_cuda(q_, key_cache, value_cache, t_, s_, ql_,
                                  scale, name="paged_verify")
    return paged_verify_reference(*args, scale=scale)


# ---------------------------------------------------------------------------
# fused decode step over fp pools
# ---------------------------------------------------------------------------

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
    dropped = _dropped_walked(lens, wable, bs, block_tables.shape[1],
                              num_shards)
    key_cache[blk[dropped]] = 0
    value_cache[blk[dropped]] = 0
    return out, key_cache, value_cache


def _dropped_walked(lens, wable, bs, max_blocks, num_shards):
    """The lanes whose dropped append zeroes its write page (the spill page
    in the engine): ``wable == 0`` and the write page ``lens // bs`` inside
    the launch's walk of S shards of P pages."""
    S = decode_shards(max_blocks, num_shards)
    walked = lens // bs < S * (-(-max_blocks // S))
    return torch.nonzero(~wable & walked).flatten()


def fused_decode_step_cuda(q, k_new, v_new, cos, sin, key_cache, value_cache,
                           block_tables, seq_lens, write_blk, writeable,
                           scale=None, num_shards=None, route=None):
    """Launch the page walk (pools updated in place) and the exact
    log-sum-exp merge of its split-K partials on ``route`` (default
    :func:`decode_route`): ``csrc/fused_decode_tc.cu``'s
    ``ptt_fused_decode_tc`` (one launch, the merge inside it) or
    ``csrc/fused_decode.cu``'s ``ptt_fused_decode`` (the walk, then the
    combine launch)."""
    b, nh, hd = q.shape
    nbp, nkv, bs, hd_p = key_cache.shape
    dev, dt = q.device, q.dtype
    if dt not in DTYPE_CODE:
        raise ValueError(f"fused_decode_step: dtype {dt} not supported")
    if not kernel_supported(nh, nkv, hd, bs) or hd_p != hd:
        raise ValueError(f"fused_decode_step: unsupported shape nh={nh} "
                         f"nkv={nkv} hd={hd} block_size={bs}")
    route = pick_route("fused_decode_step", q, route, decode_route(dt, hd))
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    max_blocks = block_tables.shape[1]
    S = decode_shards(max_blocks, num_shards)
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
    head = (ptr(q), ptr(k_new), ptr(v_new), ptr(cos), ptr(sin),
            ptr(key_cache), ptr(value_cache), ptr(block_tables),
            ptr(seq_lens), ptr(write_blk), ptr(writeable), ptr(m), ptr(l),
            ptr(acc))
    tail = (b, nh, nkv, hd, nbp, bs, max_blocks, S, P, float(scale),
            DTYPE_CODE[dt], stream_ptr(dev))
    if route == "tc":
        err = library().ptt_fused_decode_tc(
            *head, ptr(_decode_tickets(dev, b * nkv)), ptr(out), *tail)
    else:
        err = library().ptt_fused_decode(*head, ptr(out), *tail)
    check_launch("fused_decode_step", err)
    LAUNCHES["fused_decode_step"] += 1
    if route == "tc":
        LAUNCHES["fused_decode_step_tc"] += 1
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
# fused decode step over int8 / packed-int4 pools
# ---------------------------------------------------------------------------

def fused_quant_decode_step_reference(q, k_new, v_new, cos, sin, kq, ksc,
                                      vq, vsc, block_tables, seq_lens,
                                      write_blk, writeable, kv_quant,
                                      scale=None, num_shards=None):
    """Plain version of the quantized fused decode step, the unfused
    composition: rope in the input dtype (``apply_rotary_pos_emb``), the
    requantized appends (:func:`quant_append_decode`, the same encode the
    kernel runs), dequant-on-read gather-oracle attention over
    ``seq_lens + 1``.  It then applies the kernel's spill contract: a lane
    with ``writeable == 0`` whose write page the walk reaches writes zero
    codes and a zero scale there (the spill page in the engine).  Updates
    codes and scales in place and returns ``(out, kq, ksc, vq, vsc)``."""
    b, nh, hd = q.shape
    nbp, nkv, bs, _ = kq.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    q_r, k_r = apply_rotary_pos_emb(q[:, None], k_new[:, None],
                                    cos[:, None, :], sin[:, None, :])
    q_r, k_r = q_r[:, 0], k_r[:, 0]
    lens = seq_lens.long()
    off = lens % bs
    quant_append_decode(kq, ksc, k_r, write_blk, off, writeable, kv_quant)
    quant_append_decode(vq, vsc, v_new, write_blk, off, writeable, kv_quant)
    out = paged_attention_reference(q_r, kq, vq, block_tables, lens + 1,
                                    scale=scale, kv_quant=kv_quant,
                                    k_scale=ksc, v_scale=vsc)
    blk = write_blk.long().clamp(0, nbp - 1)
    dropped = blk[_dropped_walked(lens, writeable.bool(), bs,
                                  block_tables.shape[1], num_shards)]
    for t in (kq, ksc, vq, vsc):
        t[dropped] = 0
    return out, kq, ksc, vq, vsc


def fused_quant_decode_step_cuda(q, k_new, v_new, cos, sin, kq, ksc, vq, vsc,
                                 block_tables, seq_lens, write_blk, writeable,
                                 kv_quant, scale=None, num_shards=None,
                                 route=None):
    """Launch the page walk with the in-kernel requantized append (codes and
    scales updated in place) and the log-sum-exp merge of its split-K
    partials on ``route`` (default :func:`decode_route`):
    ``csrc/fused_decode_tc.cu``'s ``ptt_fused_quant_decode_tc`` (one
    launch) or ``csrc/fused_quant_decode.cu``'s ``ptt_fused_quant_decode``
    (the walk, then the combine launch)."""
    b, nh, hd = q.shape
    nbp, nkv, bs, hd_st = kq.shape
    dev, dt = q.device, q.dtype
    if dt not in DTYPE_CODE:
        raise ValueError(f"fused_quant_decode_step: dtype {dt} not supported")
    if not kernel_supported(nh, nkv, hd, bs):
        raise ValueError(f"fused_quant_decode_step: unsupported shape "
                         f"nh={nh} nkv={nkv} hd={hd} block_size={bs}")
    route = pick_route("fused_quant_decode_step", q, route,
                       decode_route(dt, hd))
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    max_blocks = block_tables.shape[1]
    S = decode_shards(max_blocks, num_shards)
    P = -(-max_blocks // S)
    rep = nh // nkv
    for name, t, shape, tdt in (
            ("q", q, (b, nh, hd), dt), ("k_new", k_new, (b, nkv, hd), dt),
            ("v_new", v_new, (b, nkv, hd), dt), ("cos", cos, (b, hd), dt),
            ("sin", sin, (b, hd), dt),
            ("key_codes", kq, (nbp, nkv, bs, hd_st), torch.int8),
            ("value_codes", vq, (nbp, nkv, bs, hd_st), torch.int8),
            ("key_scale", ksc, (nbp, nkv), torch.float32),
            ("value_scale", vsc, (nbp, nkv), torch.float32),
            ("block_tables", block_tables, (b, max_blocks), torch.int32),
            ("seq_lens", seq_lens, (b,), torch.int32),
            ("write_blk", write_blk, (b,), torch.int32),
            ("writeable", writeable, (b,), torch.int32)):
        check_cuda_tensor(f"fused_quant_decode_step {name}", t, shape, tdt,
                          dev)
    m = torch.empty((b, nkv, S, rep), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((b, nkv, S, rep, hd), dtype=torch.float32, device=dev)
    out = torch.empty((b, nh, hd), dtype=dt, device=dev)
    head = (ptr(q), ptr(k_new), ptr(v_new), ptr(cos), ptr(sin), ptr(kq),
            ptr(vq), ptr(ksc), ptr(vsc), ptr(block_tables), ptr(seq_lens),
            ptr(write_blk), ptr(writeable), ptr(m), ptr(l), ptr(acc))
    tail = (b, nh, nkv, hd, nbp, bs, max_blocks, S, P, float(scale),
            DTYPE_CODE[dt], KV_FORMAT_CODE[kv_quant], stream_ptr(dev))
    if route == "tc":
        err = library().ptt_fused_quant_decode_tc(
            *head, ptr(_decode_tickets(dev, b * nkv)), ptr(out), *tail)
    else:
        err = library().ptt_fused_quant_decode(*head, ptr(out), *tail)
    check_launch("fused_quant_decode_step", err)
    LAUNCHES["fused_quant_decode_step"] += 1
    if route == "tc":
        LAUNCHES["fused_quant_decode_step_tc"] += 1
    return out, kq, ksc, vq, vsc


def fused_quant_decode_step(q, k_new, v_new, cos, sin, kq, ksc, vq, vsc,
                            block_tables, seq_lens, write_blk, writeable,
                            kv_quant, scale=None, num_shards=None):
    """Fused RoPE + requantized KV-page append + split-K dequant-on-read
    paged attention for ONE decode token per slot over int8 / packed-int4
    pools.

    Args mirror :func:`fused_decode_step` with the fp pools replaced by
    quantized storage: ``kq``/``vq`` [nbp, nkv, block_size, hd_store] int8
    codes (hd_store = head_dim, or head_dim // 2 packed int4) and
    ``ksc``/``vsc`` [nbp, nkv] f32 per-(page, kv head) scales, all updated
    IN PLACE.  A dropped lane writes zero codes and a zero scale to its
    write page (the engine's spill page).

    Returns ``(out [b, nh, hd], kq, ksc, vq, vsc)``: attention over columns
    < seq_lens + 1, reading the write page's requantized bytes.  CPU
    tensors take :func:`fused_quant_decode_step_reference`; CUDA tensors
    launch the kernel, or the plain version under the ``fused_quant_append``
    or ``fused_decode_step`` switch."""
    hd = _check_storage("fused_quant_decode_step", q, kq, kv_quant, ksc, vsc)
    if kv_quant is None:
        raise ValueError("fused_quant_decode_step: kv_quant must be 'int8' "
                         "or 'int4'")
    args = (q, k_new, v_new, cos, sin, kq, ksc, vq, vsc, block_tables,
            seq_lens, write_blk, writeable)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if use_kernel("fused_quant_decode_step", *args,
                  switch=("fused_decode_step", "fused_quant_append")):
        small = [t.contiguous() for t in args[:5]]
        return fused_quant_decode_step_cuda(*small, *args[5:], kv_quant,
                                            scale=scale,
                                            num_shards=num_shards)
    return fused_quant_decode_step_reference(*args, kv_quant, scale=scale,
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
