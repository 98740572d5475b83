"""Llama family (counterpart of ``paddle_tpu/models/llama.py``), serving half.

This slice ports the configuration, the parameter initializer and the
shared post-attention decoder seams the serving path runs through.  The
parameter dict has the reference's layout: layer weights stacked over a
leading layer dimension, matmul weights ``[L, in, out]``.  Tensor
parallelism (``tp_axis``) and the training path come in later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.kernels import rms_norm as rms
from ..ops.kernels import swiglu as swiglu_mod


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b():
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        )

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
             seq=128):
        return LlamaConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, max_position_embeddings=seq,
        )


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> dict:
    """Parameter dict with the reference's shapes: normal(0, 0.02) matmul
    and embedding weights, unit norms, layer weights stacked over a leading
    layer dim.  Drawn from ``generator`` (or one seeded with ``seed`` on
    ``device``), in f32, then cast to ``cfg.dtype``.  The numbers differ
    from ``jax.random``'s for the same seed; parity tests bridge the JAX
    tree instead (utils/convert.py)."""
    from .. import resolve_device

    dev = resolve_device(device) if generator is None else generator.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    L = cfg.num_hidden_layers
    std = 0.02

    def init(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(std).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params = {
        "embed": init((v, h)),
        "final_norm": ones((h,)),
        "layers": {
            "input_norm": ones((L, h)),
            "post_norm": ones((L, h)),
            "wq": init((L, h, nh * hd)),
            "wk": init((L, h, nkv * hd)),
            "wv": init((L, h, nkv * hd)),
            "wo": init((L, nh * hd, h)),
            "w_gate": init((L, h, i)),
            "w_up": init((L, h, i)),
            "w_down": init((L, i, h)),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init((h, v))
    return params


def decoder_attn_residual(x, attn, lp):
    """Attention output projection + residual (``tp_axis=None``)."""
    return x + attn @ lp["wo"]


def decoder_mlp_residual(cfg, x, lp):
    """post-norm + swiglu MLP + residual."""
    xn = rms.rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    y = swiglu_mod.swiglu(xn @ lp["w_gate"], xn @ lp["w_up"]) @ lp["w_down"]
    return x + y


def decoder_layer_tail(cfg, x, attn, lp, mlp_fn=None):
    """The post-attention half of a decoder layer in one seam.

    ``mlp_fn=None`` composes :func:`decoder_attn_residual` and
    :func:`decoder_mlp_residual`.  With ``mlp_fn(h_res, attn_y, lp) ->
    (h1, y)`` the residual add + post RMSNorm + SwiGLU MLP run through the
    caller's fused implementation (the serving decode path passes
    ``ops/kernels/paged_attention.fused_layer_mlp``) and the layer closes
    with ``h1 + y``."""
    if mlp_fn is None:
        x = decoder_attn_residual(x, attn, lp)
        return decoder_mlp_residual(cfg, x, lp)
    attn_y = attn @ lp["wo"]
    h1, y = mlp_fn(x, attn_y, lp)
    return h1 + y
