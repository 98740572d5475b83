"""SwiGLU (counterpart of ``paddle_tpu/ops/pallas/swiglu.py``).

Plain PyTorch: ``silu(x) * y`` with the inner math in f32, rounded to x's
dtype.  The reference has no kernel here (XLA fuses it); the backward
belongs to the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (F.silu(x.float()) * y.float()).to(x.dtype)
