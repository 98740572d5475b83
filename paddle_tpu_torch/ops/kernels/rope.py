"""Rotary position embedding (counterpart of ``paddle_tpu/ops/pallas/rope.py``).

Plain PyTorch: the reference has no kernel here (XLA composes it), so the
port has none either.  Rotate-half formulation, math in the input dtype.
In f32 the reference's compiled programs contract ``x * cos + rot * sin``
into ``fma(x, cos, rot * sin)`` (XLA's CPU compiler, inside its Pallas
kernels in interpret mode too), so the port rounds that sum once as well
(:func:`fma_f32`); bf16 / f16 round every operation to the input dtype.
"""

from __future__ import annotations

import math

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


def fma_f32(a, b, c):
    """``a * b + c`` rounded once to f32, as an FMA: the f64 product of two
    f32 values is exact, the f64 sum is made round-to-odd (its TwoSum error
    decides the last bit), and round-to-odd at 53 bits then rounding to 24
    is the correctly rounded result.  Differentiable: the last-bit fix is a
    constant offset."""
    p = a.double() * b.double()
    s = p + c.double()
    with torch.no_grad():
        t = s - p
        err = (p - (s - t)) + (c.double() - t)
        even = (s.view(torch.int64) & 1) == 0
        toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
        fix = torch.where((err != 0) & even,
                          torch.nextafter(s, toward) - s, 0.0)
    return (s + fix).float()


def _rope(x, c, s):
    rot = _rotate_half(x) * s
    if x.dtype == torch.float32:
        return fma_f32(x, c, rot)
    return (x * c + rot).to(x.dtype)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q, k: [b, s, h, d]; cos, sin: [b_or_1, s, d], broadcast over heads."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return _rope(q, c, s), _rope(k, c, s)
