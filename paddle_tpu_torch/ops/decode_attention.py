"""Decode-path attention with paged KV caches (counterpart of
``paddle_tpu/ops/decode_attention.py``).

This slice ports the serving engine's front door, ``fused_paged_decode_step``.
The other front doors (the unfused paged decode, verify and chunked-prefill
attention, the quantized fused step) follow with their kernels.
"""

from __future__ import annotations

__all__ = ["fused_paged_decode_step"]


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
