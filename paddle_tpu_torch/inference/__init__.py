"""LLM inference (counterpart of ``paddle_tpu/inference/__init__.py``).

This slice ports the cache-threading transformer body shared by the
serving engine, :func:`transformer_apply`, over fp or quantized KV pools,
and :func:`lm_head_logits`.
The reference's layer ``lax.scan`` is a Python loop over the stacked layer
weights here; fp weights only (weight-only quantization comes later).
"""

from __future__ import annotations

import math

import torch


def transformer_apply(cfg, params, x, cache_k, cache_v, write_fn, mask, cos,
                      sin, attend_fn=None, fused_fn=None, mlp_fused_fn=None):
    """Transformer body over per-layer KV caches.

    ``cache_k``/``cache_v`` are the stacked pools ``[L, ...]``, or for
    quantized pools ``{"q": codes [L, ...], "scale": scales [L, ...]}``
    pairs; layer ``l`` reads and writes the view ``cache_k[l]`` (for a pair
    ``{"q": codes[l], "scale": scales[l]}``) IN PLACE (the reference
    threads the pools through its scan functionally and donates them).

    ``write_fn(cache_layer, kv) -> (committed, attend_view)`` commits new
    K/V into one layer's cache and returns the view attention reads.
    ``mask`` broadcasts against logits [b, nkv, rep, s, S].
    ``attend_fn(q [b, s, nh, hd], k_view, v_view) -> [b, s, nh*hd]``
    overrides the dense masked attend.

    ``fused_fn(q_pre, k_pre, v, cache_k_layer, cache_v_layer) -> (attn,
    cache_k_layer, cache_v_layer)`` replaces rope -> write_fn -> attend with
    ONE call (the serving decode path passes the fused decode step); q/k
    arrive PRE-rope and ``mask``/``write_fn``/``attend_fn`` are unused.

    ``mlp_fused_fn(h_res, attn_y, lp) -> (h1, y)`` fuses each layer's
    post-attention half.  Unlike the reference, the per-layer INPUT norm
    stays the ``rms_norm`` dispatch in this mode too: XLA fused the
    reference's inline norm into the QKV matmuls, eager PyTorch has no such
    fusion, so the kernel (same f32 math) is the cheaper path on the card.

    Returns (final-normed hidden [b, s, h], cache_k, cache_v)."""
    from ..models.llama import decoder_layer_tail
    from ..ops.kernels import rms_norm as rms
    from ..ops.kernels import rope as rope_mod

    b, s = x.shape[:2]
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    rep = nh // nkv

    def attend(q, k_all, v_all):
        # dense masked GQA attend: q heads grouped per kv head inside the
        # einsum, so the cache is never repeated in memory
        qg = q.reshape(b, s, nkv, rep, hd)
        logits = torch.einsum("bsngd,bnSd->bngsS", qg.float(),
                              k_all.float()) / math.sqrt(hd)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bngsS,bnSd->bsngd", p.to(v_all.dtype), v_all)
        return out.reshape(b, s, nh * hd)

    def layer_view(cache, li):
        if isinstance(cache, dict):
            return {key: t[li] for key, t in cache.items()}
        return cache[li]

    attend = attend_fn or attend
    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        lp = {name: w[li] for name, w in layers.items()}
        ck, cv = layer_view(cache_k, li), layer_view(cache_v, li)
        xn = rms.rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q = (xn @ lp["wq"]).reshape(b, s, nh, hd)
        k = (xn @ lp["wk"]).reshape(b, s, nkv, hd)
        v = (xn @ lp["wv"]).reshape(b, s, nkv, hd)
        if fused_fn is not None:
            attn, _, _ = fused_fn(q, k, v, ck, cv)
        else:
            q, k = rope_mod.apply_rotary_pos_emb(q, k, cos, sin)
            _, k_att = write_fn(ck, k)
            _, v_att = write_fn(cv, v)
            attn = attend(q, k_att, v_att)
        x = decoder_layer_tail(cfg, x, attn, lp, mlp_fn=mlp_fused_fn)
    return rms.rms_norm(x, params["final_norm"], cfg.rms_norm_eps), cache_k, \
        cache_v


def lm_head_logits(cfg, params, x_last):
    """Project final hidden state(s) through the (possibly tied) LM head."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(cfg.dtype)
    return x_last @ head
