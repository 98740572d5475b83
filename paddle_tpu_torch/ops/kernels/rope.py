"""Rotary position embedding (counterpart of ``paddle_tpu/ops/pallas/rope.py``).

Plain PyTorch: the reference has no kernel here (XLA composes it), so the
port has none either.  Rotate-half formulation, math in the input dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(seq_len: int, head_dim: int, base: float = 10000.0,
                 dtype: torch.dtype = torch.float32, device=None):
    """cos/sin tables [1, seq_len, head_dim] for positions 0..seq_len-1
    (f32 math, cast to ``dtype``)."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                            device=device) / head_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[None, :]
    freqs = torch.einsum("bs,d->bsd", pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q, k: [b, s, h, d]; cos, sin: [b_or_1, s, d], broadcast over heads."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    q2 = q * c + _rotate_half(q) * s
    k2 = k * c + _rotate_half(k) * s
    return q2.to(q.dtype), k2.to(k.dtype)
