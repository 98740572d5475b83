"""Fused RMSNorm (counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``).

``rms_norm_ref`` is the plain version: the reference's exact f32 math.
``rms_norm`` is differentiable: its forward dispatches by device (CPU
tensors take the plain version, CUDA tensors launch ``csrc/rms_norm.cu``)
and its backward is the reference's closed form ``_rms_vjp_bwd`` in plain
PyTorch with the same f32 math and casts (the reference computes it in
XLA, so no kernel is owed).
"""

from __future__ import annotations

import torch

from . import (DTYPE_CODE, LAUNCHES, check_cuda_tensor, check_launch,
               library, ptr, stream_ptr, use_kernel)

#: 16-byte vectors one block of the kernel holds per row (256 threads x 8)
_MAX_VECS = 256 * 8


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` in f32, rounded to x's dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)


def rms_norm_cuda(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` viewed as [rows, h]."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    rows = x2.shape[0]
    vec = 16 // x.element_size()
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"rms_norm: dtype {x.dtype} not supported")
    if h % vec or h // vec > _MAX_VECS:
        raise ValueError(f"rms_norm: hidden size {h} must be a multiple of "
                         f"{vec} and at most {vec * _MAX_VECS}")
    check_cuda_tensor("rms_norm x", x2, (rows, h), x.dtype, x.device)
    check_cuda_tensor("rms_norm w", w, (h,), x.dtype, x.device)
    out = torch.empty_like(x2)
    err = library().ptt_rms_norm(ptr(x2), ptr(w), ptr(out), rows, h,
                                 float(eps), DTYPE_CODE[x.dtype],
                                 stream_ptr(x.device))
    check_launch("rms_norm", err)
    LAUNCHES["rms_norm"] += 1
    return out.reshape(x.shape)


def rms_norm_bwd(x, w, g, eps):
    """(dx, dw) of ``rms_norm`` for the cotangent g (``_rms_vjp_bwd``)."""
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = gf * wf
    # d/dx [x * inv]: inv * (gw - xhat * mean(gw * xhat))
    dx = inv * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
    dw = (gf * xhat).sum(dim=tuple(range(x.ndim - 1)))
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if use_kernel("rms_norm", x, w):
            return rms_norm_cuda(x.contiguous(), w, eps)
        return rms_norm_ref(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d], weight: [d]."""
    return _RMSNorm.apply(x, weight, eps)
