"""LLM inference (counterpart of ``paddle_tpu/inference/__init__.py``).

This module holds the cache-threading transformer body shared by the
serving engines, :func:`transformer_apply`, over fp or quantized KV pools,
:func:`lm_head_logits`, and :class:`GenerationEngine`, the reference's
simplest generation entry point (a dense KV cache, greedy or temperature
decoding of one batch); ``ContinuousBatchingEngine``, ``Request`` and
``FleetRouter`` are exported lazily, as the reference exports them, so
importing the package does not pull in the serving stack.
The reference's layer ``lax.scan`` is a Python loop over the stacked layer
weights here.  The layer matmul weights are fp, or weight-only quantized
by :func:`quantize_layer_params` (``quant`` 'int8' / 'int4'), each then
dequantized by :func:`wmat` where a matmul reads it.
"""

from __future__ import annotations

import math

import numpy as np
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


def check_params_device(params, device) -> None:
    """An engine's ``params`` must live on its device: ``ValueError``
    naming both otherwise."""
    for leaf in [params["embed"], *params["layers"].values()]:
        if leaf.device != device:
            raise ValueError(f"params live on {leaf.device}, engine device "
                             f"is {device}")


def lm_head_logits(cfg, params, x_last):
    """Project final hidden state(s) through the (possibly tied) LM head."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(cfg.dtype)
    return x_last @ head


class GenerationEngine:
    """Greedy or temperature decoding for the Llama family over a dense KV
    cache (the reference's ``paddle_tpu.inference.GenerationEngine``):
    one prefill of the whole prompt batch, then one decode step a token,
    each an eager pass over :func:`transformer_apply` whose RMSNorms run
    the ``rms_norm`` kernel on the card.

    ``quant``: None, 'int8' or 'int4' -- the layer matmul weights
    weight-only quantized at construction (:func:`quantize_layer_params`).
    ``device`` defaults to the CUDA card and must hold ``params``.  The
    cache is ``[L, b, nkv, max_seq, head_dim]`` in ``cfg.dtype``, written
    in place.  A ``temperature > 0`` draw is the reference's
    ``jax.random.categorical`` under keys split from
    ``jax.random.key(seed)`` (``utils/threefry.py``), so a seeded stream is
    the reference's tokens."""

    def __init__(self, cfg, params, max_seq: int = 512,
                 quant: str | None = None, device=None):
        from .. import resolve_device
        from ..ops.kernels import rope as rope_mod

        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.cfg = cfg
        self.max_seq = max_seq
        if quant is not None:
            params = quantize_layer_params(params, quant)
        self.params = params
        self.quant = quant
        self._cos, self._sin = rope_mod.rope_cos_sin(
            max_seq, cfg.head_dim, base=cfg.rope_theta, dtype=cfg.dtype,
            device=self.device)                      # [1, max_seq, hd]

    def init_cache(self, batch):
        """Zeroed K and V caches ``[L, batch, nkv, max_seq, head_dim]``."""
        cfg = self.cfg
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads,
                 self.max_seq, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.dtype, device=self.device))

    def _forward_tokens(self, ids, cache_k, cache_v, start_pos: int):
        """Run ``ids`` [b, s] at positions start_pos .. start_pos + s - 1:
        their K/V go into the caches at those positions (in place), each
        attends every cached key at or before its own position.  Returns
        (logits of the last token [b, V], cache_k, cache_v)."""
        cfg = self.cfg
        b, s = ids.shape
        x = self.params["embed"][ids].to(cfg.dtype)
        cos = self._cos[:, start_pos:start_pos + s]
        sin = self._sin[:, start_pos:start_pos + s]
        kv_pos = torch.arange(self.max_seq, device=self.device)
        q_pos = start_pos + torch.arange(s, device=self.device)
        mask = kv_pos[None, None, None, None, :] <= q_pos[:, None]

        def write(ck, k):
            # ck [b, nkv, S, hd] a layer's cache; k [b, s, nkv, hd] roped
            ck[:, :, start_pos:start_pos + s] = k.transpose(1, 2)
            return ck, ck

        x, cache_k, cache_v = transformer_apply(
            cfg, self.params, x, cache_k, cache_v, write, mask, cos, sin,
            quant=self.quant)
        return lm_head_logits(cfg, self.params, x[:, -1]), cache_k, cache_v

    def _prefill_impl(self, ids, cache_k, cache_v):
        return self._forward_tokens(ids, cache_k, cache_v, 0)

    def _decode_impl(self, cache_k, cache_v, token, pos: int):
        return self._forward_tokens(token, cache_k, cache_v, pos)

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0):
        """prompt_ids ``[b, s0]`` int -> numpy int32 ``[b, s0 +
        max_new_tokens]``: the prompt, then each step's token, greedy at
        ``temperature`` 0, else drawn from ``logits / temperature`` with
        the key split off ``jax.random.key(seed)`` for that step, as the
        reference draws it.  The last token's logits are never read, so
        its decode step is not run."""
        from ..utils import threefry

        prompt_ids = np.asarray(prompt_ids)
        b, s0 = prompt_ids.shape
        if s0 + max_new_tokens > self.max_seq:
            raise ValueError(f"prompt length {s0} + max_new_tokens "
                             f"{max_new_tokens} exceeds max_seq "
                             f"{self.max_seq}")
        cache_k, cache_v = self.init_cache(b)
        ids = torch.as_tensor(prompt_ids.astype(np.int64), device=self.device)
        logits, cache_k, cache_v = self._prefill_impl(ids, cache_k, cache_v)
        key = threefry.prng_key(seed, self.device)
        out = [ids]
        for i in range(max_new_tokens):
            if temperature > 0:
                key, sub = threefry.split(key)
                nxt = threefry.categorical(sub, logits / temperature)
            else:
                nxt = logits.argmax(dim=-1)
            out.append(nxt[:, None])
            if i + 1 < max_new_tokens:
                logits, cache_k, cache_v = self._decode_impl(
                    cache_k, cache_v, nxt[:, None], s0 + i)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def __getattr__(name):
    # the serving engine and the fleet router pull in the whole serving
    # stack (serving.py, fleet.py): loaded at their first use
    if name in ("ContinuousBatchingEngine", "Request"):
        from . import serving

        return getattr(serving, name)
    if name == "FleetRouter":
        from .fleet import FleetRouter

        return FleetRouter
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
