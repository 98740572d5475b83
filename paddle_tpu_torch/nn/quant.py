"""Weight-only quantization (counterpart of ``paddle_tpu/nn/quant``).

Ported: what the serving engine's weight-only mode needs, the raw-tensor
cores :func:`_quantize_2d` (per-channel, ``group_size=-1``) and
:func:`_dequant_2d`, with the reference's arithmetic in its order.

Storage follows the reference: a ``[K, N]`` weight is stored TRANSPOSED
``[N, K]`` with float32 per-channel scales ``[N]``.  int8 codes are int8.
The reference stores int4 codes as ``jnp.int4``, which XLA packs two a
byte; torch has no int4 dtype, so the port packs them itself into int8
``[N, K // 2]``, element 2i in the low nibble and 2i+1 in the high one:
the KV pools' layout (``ops/kernels/paged_attention._pack_int4``).  The
dequantize here is eager: the reference's XLA fuses the multiply into
the consuming matmul's read, the port writes the dense matrix first.
"""

from __future__ import annotations

import torch

from ..ops.kernels.paged_attention import _pack_int4, _unpack_int4

_BOUNDS = {"weight_only_int8": 127.0, "llm.int8": 127.0,
           "weight_only_int4": 7.0}


def _quantize_2d(w, algo: str, group_size: int = -1):
    """``w`` [K, N] -> (q [N, K] int8, or [N, K // 2] packed int4; scale
    [N] f32): scale = absmax / bound over each column, q = clip(round(w /
    max(scale, 1e-10)), -bound, bound), rounding half to even as
    ``jnp.round`` does, in f32."""
    if w.dim() != 2:
        raise ValueError(f"weight must be rank-2, got {tuple(w.shape)}")
    if group_size != -1:
        raise NotImplementedError("only per-channel scales (group_size=-1) "
                                  "are ported")
    if algo not in _BOUNDS:
        raise ValueError(f"unknown algo {algo!r}")
    bound = _BOUNDS[algo]
    w32 = w.float()
    absmax = w32.abs().amax(dim=0)                          # [N]
    # a true division on every device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, which rounds otherwise
    scale = absmax / torch.full_like(absmax, bound)
    q = torch.round(w32 / scale.clamp(min=1e-10)[None, :])
    q = q.clamp(-bound, bound).T                            # [N, K]
    if algo == "weight_only_int4":
        if q.shape[1] % 2:
            raise ValueError(f"int4 weights need an even input dim (got "
                             f"{q.shape[1]}): two codes pack a byte")
        return _pack_int4(q), scale
    return q.to(torch.int8).contiguous(), scale


def _dequant_2d(q, s, dt, int4: bool = False):
    """The stored ``[N, K]`` codes (``int4``: packed ``[N, K // 2]``) and
    scales ``[N]`` -> the dense ``[K, N]`` matrix in ``dt``.  The multiply
    runs in ``dt``, as the reference's ``q.T.astype(dt) * s.astype(dt)``:
    in bf16 the scale and the product round to bf16.  The int8 codes meet
    the ``dt`` scale in ONE elementwise pass (type promotion converts
    each code to ``dt`` exactly, then multiplies), so the codes are read
    once and the matrix written once."""
    codes = _unpack_int4(q, torch.int8) if int4 else q
    return codes.T * s[None, :].to(dt)
