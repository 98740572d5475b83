"""Gumbel noise of the serving sampler.

The reference draws each sampled token as ``argmax(gumbel(key) +
logits)`` with ``key = fold_in(fold_in(PRNGKey(0), seed), pos)``
(``jax.random.categorical`` inside its decode program).
``gumbel_noise_ref`` is the plain version, ``utils/threefry.py``'s chain
in PyTorch integer ops; ``gumbel_noise`` dispatches by device (CPU tensors
take the plain version, CUDA tensors launch ``csrc/gumbel.cu``, which
computes the same bits in one launch instead of the chain's hundreds).
"""

from __future__ import annotations

import torch

from . import (LAUNCHES, check_cuda_tensor, check_launch, library, ptr,
               stream_ptr, use_kernel)
from ...utils import threefry


def gumbel_noise_ref(seeds: torch.Tensor, pos: torch.Tensor,
                     n: int) -> torch.Tensor:
    """float32 noise [rows, n] for int32 seeds [rows] and positions
    [rows]."""
    return threefry.gumbel(threefry.sample_keys(seeds, pos), n)


def gumbel_noise_cuda(seeds: torch.Tensor, pos: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Launch the CUDA kernel; seeds int32 and positions int64, [rows]."""
    rows = seeds.shape[0]
    check_cuda_tensor("gumbel_noise seeds", seeds, (rows,), torch.int32,
                      seeds.device)
    check_cuda_tensor("gumbel_noise pos", pos, (rows,), torch.int64,
                      seeds.device)
    if not 0 < n < 2 ** 31:
        raise ValueError(f"gumbel_noise: n {n} must be in [1, 2**31)")
    out = torch.empty(rows, n, dtype=torch.float32, device=seeds.device)
    err = library().ptt_gumbel_noise(ptr(seeds), ptr(pos), ptr(out), rows, n,
                                     stream_ptr(seeds.device))
    check_launch("gumbel_noise", err)
    LAUNCHES["gumbel_noise"] += 1
    return out


def gumbel_noise(seeds: torch.Tensor, pos: torch.Tensor,
                 n: int) -> torch.Tensor:
    if use_kernel("gumbel_noise", seeds, pos):
        return gumbel_noise_cuda(seeds, pos, n)
    return gumbel_noise_ref(seeds, pos, n)
