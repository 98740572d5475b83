"""paddle_tpu_torch: the PyTorch + CUDA port of ``paddle_tpu``.

The package keeps ``paddle_tpu``'s module layout and names, so the
counterpart of ``paddle_tpu/X/Y.py`` is ``paddle_tpu_torch/X/Y.py``.  It
imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``paddle_tpu``: the JAX package is the reference the port is tested
against, not a dependency.

Every kernel that ``paddle_tpu`` wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (``sm_90a``) here, with its plain PyTorch version beside
it (``ops/kernels``).  Entry points run on the CUDA card unless the caller
passes a CPU device; they never drop to the CPU on their own.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the first
    CUDA card.  Raises when no card is present — the port never falls back
    to the CPU silently; pass ``device="cpu"`` to run the plain versions."""
    if not torch.cuda.is_available():
        raise RuntimeError("paddle_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device`` with its index (None ->
    :func:`default_device`).
    A CUDA device with no card present raises here, at construction, not
    deep inside the first launch."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"paddle_tpu_torch: device {dev} requested "
                               f"but no CUDA device is available")
        if dev.index is None:   # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
