"""LLM inference (counterpart of ``paddle_tpu/inference/__init__.py``).

This module holds the cache-threading transformer body shared by the
serving engine, :func:`transformer_apply`, over fp or quantized KV pools,
and :func:`lm_head_logits`; ``FleetRouter`` (``fleet.py``) is exported
lazily, as the reference exports it, so importing the package does not
pull in the serving stack.
The reference's layer ``lax.scan`` is a Python loop over the stacked layer
weights here.  The layer matmul weights are fp, or weight-only quantized
by :func:`quantize_layer_params` (``quant`` 'int8' / 'int4'), each then
dequantized by :func:`wmat` where a matmul reads it.
"""

from __future__ import annotations

import math

import torch


def transformer_apply(cfg, params, x, cache_k, cache_v, write_fn, mask, cos,
                      sin, attend_fn=None, fused_fn=None, mlp_fused_fn=None,
                      quant=None, tp_group=None):
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

    ``quant`` (None, 'int8', 'int4') says how the layer matmul leaves are
    stored (:func:`quantize_layer_params`); each matmul reads its weight
    through :func:`wmat`.

    ``tp_group`` (the reference's ``tp_axis``): a ``torch.distributed``
    group when this body runs on one rank of the serving engine's
    ``tensor_parallel`` mode.  ``cfg`` then carries the rank's head counts
    (nh/tp query heads, nkv/tp kv heads over the same head_dim), the pools
    and the layer weights are the rank's shards, and the residual stream
    stays replicated through the two all-reduces a layer of
    ``models/llama.decoder_layer_tail``.  None (every single-card engine)
    runs no collective.

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

    def w(entry, dt):
        return wmat(entry, dt, quant)

    attend = attend_fn or attend
    layers = params["layers"]
    for li in range(cfg.num_hidden_layers):
        lp = {name: layer_view(t, li) for name, t in layers.items()}
        ck, cv = layer_view(cache_k, li), layer_view(cache_v, li)
        dt = x.dtype
        xn = rms.rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q = (xn @ w(lp["wq"], dt)).reshape(b, s, nh, hd)
        k = (xn @ w(lp["wk"], dt)).reshape(b, s, nkv, hd)
        v = (xn @ w(lp["wv"], dt)).reshape(b, s, nkv, hd)
        if fused_fn is not None:
            attn, _, _ = fused_fn(q, k, v, ck, cv)
        else:
            q, k = rope_mod.apply_rotary_pos_emb(q, k, cos, sin)
            _, k_att = write_fn(ck, k)
            _, v_att = write_fn(cv, v)
            attn = attend(q, k_att, v_att)
        x = decoder_layer_tail(cfg, x, attn, lp, wmat=w, mlp_fn=mlp_fused_fn,
                               tp_group=tp_group)
    return rms.rms_norm(x, params["final_norm"], cfg.rms_norm_eps), cache_k, \
        cache_v


def wmat(entry, dt, quant=None):
    """Dense ``[in, out]`` matrix of a layer matmul leaf: fp as stored, or
    a weight-only quantized ``{'qweight': [out, in], 'scale': [out]}``
    dict (``quant='int4'``: packed codes ``[out, in // 2]``) dequantized
    into ``dt`` (``nn/quant._dequant_2d``)."""
    if isinstance(entry, dict):
        from ..nn.quant import _dequant_2d

        return _dequant_2d(entry["qweight"], entry["scale"], dt,
                           int4=quant == "int4")
    return entry


_QUANT_ALGOS = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@torch.no_grad()
def quantize_layer_params(params, quant: str):
    """Weight-only-quantize the stacked per-layer matmul weights of a llama
    param tree (embed, lm_head and the norms stay fp).  Each ``[L, K, N]``
    leaf becomes ``{'qweight': [L, N, K] int8 (int4: packed [L, N, K //
    2]), 'scale': [L, N] f32}``, the reference's layout.  One layer at a
    time: the f32 working copy is one layer's, never the whole leaf's.
    An unknown ``quant`` raises ``KeyError``, as the reference's does."""
    from ..nn.quant import _quantize_2d

    algo = _QUANT_ALGOS[quant]
    out = dict(params)
    layers = dict(params["layers"])
    for name in _MATMUL_LEAVES:
        w = layers[name]
        qs, ss = None, None
        for li in range(w.shape[0]):
            q, s = _quantize_2d(w[li], algo)
            if qs is None:
                qs = q.new_empty((w.shape[0], *q.shape))
                ss = s.new_empty((w.shape[0], *s.shape))
            qs[li], ss[li] = q, s
        layers[name] = {"qweight": qs, "scale": ss}
    out["layers"] = layers
    return out


def lm_head_logits(cfg, params, x_last):
    """Project final hidden state(s) through the (possibly tied) LM head."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(cfg.dtype)
    return x_last @ head


def __getattr__(name):
    # the fleet router pulls in the whole serving stack (serving.py,
    # fleet.py): loaded at its first use
    if name == "FleetRouter":
        from .fleet import FleetRouter

        return FleetRouter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
