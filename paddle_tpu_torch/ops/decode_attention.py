"""Decode-path attention with paged KV caches (counterpart of
``paddle_tpu/ops/decode_attention.py``).

Ported: the serving engine's front doors ``paged_decode_attention`` (the
unfused decode arm), ``fused_paged_decode_step`` (fp pools) and
``fused_paged_quant_decode_step`` (int8 / packed-int4 pools).  The verify
and chunked-prefill front doors follow with their kernels.
"""

from __future__ import annotations

__all__ = ["paged_decode_attention", "fused_paged_decode_step",
           "fused_paged_quant_decode_step"]


def paged_decode_attention(q, key_cache, value_cache, block_tables, seq_lens,
                           scale=None, kv_quant=None, k_scale=None,
                           v_scale=None, num_shards=None):
    """Ragged paged-attention decode, one query token per slot: the split-K
    walk when the shard heuristic fans out (``flash_decode`` switches it to
    the sequential walk; ``num_shards`` overrides the heuristic), the
    sequential walk otherwise, the gather oracle under ``paged_attention``.
    Both walks read only each slot's live pages, dequantizing int8 /
    packed-int4 pages on read (``kv_quant`` with per-page scales).

    Shapes: q [b, nh, hd] roped; caches [nbp, nkv, block_size, hd] (or
    quantized storage, hd // 2 for int4); block_tables [b, max_blocks];
    seq_lens [b]; k_scale/v_scale [nbp, nkv] f32.  Returns [b, nh, hd]."""
    from .kernels import paged_attention as _pa

    return _pa.paged_attention_decode(
        q, key_cache, value_cache, block_tables, seq_lens, scale=scale,
        kv_quant=kv_quant, k_scale=k_scale, v_scale=v_scale,
        num_shards=num_shards)


def fused_paged_decode_step(q, k_new, v_new, cos, sin, key_cache,
                            value_cache, block_tables, seq_lens, write_blk,
                            writeable, scale=None, num_shards=None):
    """Fused RoPE + KV-append + paged attention for one decode token per
    slot: ONE kernel launch per layer that rotates q/k, inserts the new k/v
    into the slot's write page before the score dot and commits the row in
    place.  In the serving engine the pools carry one extra SPILL page
    (physical index num_blocks) that dropped writes land on.

    Shapes: q [b, nh, hd] PRE-rope; k_new/v_new [b, nkv, hd] pre-rope;
    cos/sin [b, hd]; caches [num_blocks(+1), nkv, block_size, hd];
    block_tables [b, max_blocks]; seq_lens [b] PRE-append lengths;
    write_blk [b]; writeable [b].  Returns (out [b, nh, hd], key_cache,
    value_cache), the caches updated in place."""
    from .kernels import paged_attention as _pa

    return _pa.fused_decode_step(
        q, k_new, v_new, cos, sin, key_cache, value_cache, block_tables,
        seq_lens, write_blk, writeable, scale=scale, num_shards=num_shards)


def fused_paged_quant_decode_step(q, k_new, v_new, cos, sin, key_codes,
                                  key_scale, value_codes, value_scale,
                                  block_tables, seq_lens, write_blk,
                                  writeable, kv_quant, scale=None,
                                  num_shards=None):
    """Fused RoPE + REQUANTIZED KV-page append + dequant-on-read paged
    attention for one decode token per slot over int8 / packed-int4 pools:
    ONE kernel launch per layer that recomputes the dirty page's scale and
    commits its codes and scale in place (the unfused arm pays a
    requantizing gather/scatter per pool instead).  The
    ``fused_quant_append`` (or ``fused_decode_step``) switch routes to the
    requantized-append + gather-oracle composition, whose pool bytes are
    the kernel's.

    Shapes: q [b, nh, hd] PRE-rope; k_new/v_new [b, nkv, hd] pre-rope;
    cos/sin [b, hd]; key_codes/value_codes [num_blocks(+1), nkv,
    block_size, hd_store] int8 (hd_store = hd, or hd // 2 packed int4);
    key_scale/value_scale [num_blocks(+1), nkv] f32; block_tables
    [b, max_blocks]; seq_lens [b] PRE-append lengths; write_blk [b];
    writeable [b].  Returns (out [b, nh, hd], key_codes, key_scale,
    value_codes, value_scale), updated in place."""
    from .kernels import paged_attention as _pa

    return _pa.fused_quant_decode_step(
        q, k_new, v_new, cos, sin, key_codes, key_scale, value_codes,
        value_scale, block_tables, seq_lens, write_blk, writeable, kv_quant,
        scale=scale, num_shards=num_shards)
