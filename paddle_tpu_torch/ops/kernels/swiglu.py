"""SwiGLU (counterpart of ``paddle_tpu/ops/pallas/swiglu.py``).

Plain PyTorch: ``silu(x) * y`` with the inner math in f32, rounded to x's
dtype.  The reference has no kernel here (XLA fuses it).  The backward is
the reference's ``custom_vjp`` in closed form, with its f32 math and casts:
autograd of the forward would round in other places in bf16.
"""

from __future__ import annotations

import torch


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        xf = x.float()
        return (xf * torch.sigmoid(xf) * y.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        xf, yf, gf = x.float(), y.float(), g.float()
        sig = torch.sigmoid(xf)
        silu = xf * sig
        dsilu = sig * (1 + xf * (1 - sig))
        return (gf * yf * dsilu).to(x.dtype), (gf * silu).to(y.dtype)


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _SwiGLU.apply(x, y)
