"""The part of ``jax.random`` the serving sampler uses, in torch integer ops.

The reference engine keys each sampled token with
``fold_in(fold_in(PRNGKey(0), seed), pos)`` and draws it with
``jax.random.categorical`` (``paddle_tpu/inference/serving.py``
``_sample_tokens``).  This module reproduces those bits exactly, so a
seeded sampled stream of the port is token-identical to the reference's:

- :func:`threefry2x32`: the Threefry-2x32 block cipher (20 rounds, key
  schedule with the 0x1BD11BDA parity constant), as ``jax._src.prng``'s
  ``_threefry2x32_lowering``;
- :func:`prng_key`: ``PRNGKey(seed)`` for a 32-bit seed, the key
  ``(0, seed)``;
- :func:`fold_in`: ``threefry_2x32(key, threefry_seed(uint32(data)))``,
  i.e. the cipher applied to the count pair ``(0, data)``.  An int32 seed
  or position enters as its two's-complement uint32 bits, as
  ``jnp.asarray(data, dtype='uint32')`` converts it;
- :func:`random_bits32` / :func:`uniform` / :func:`gumbel`: the
  random-bits -> uniform -> Gumbel chain of ``categorical`` in its default
  ("low") mode, float32.

The bit layout of a ``[V]`` draw is the one of
``jax_threefry_partitionable=True`` (the default from JAX 0.5 on): element
``i`` of the draw is ``hi ^ lo`` of the cipher applied to the 64-bit count
``i`` split into the pair ``(i >> 32, i & 0xFFFFFFFF)``.  The other mode
(counts ``0..2n-1`` split in halves) is not ported.

uint32 arithmetic is emulated in int64 tensors with ``& 0xFFFFFFFF`` after
every add and shift, so the same code runs on CPU and CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number (``finfo(float32).tiny``)
_TINY = 1.1754943508222875e-38


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count pair (x0, x1) under the key (k0, k1).

    All four are int64 tensors holding uint32 values, broadcast together;
    returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _u32(x, device) -> torch.Tensor:
    """Integers (Python, numpy or tensor; int32 seeds may be negative) as
    int64 tensors of their uint32 bits."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 32-bit seeds: keys ``[..., 2]``
    (int64 holding uint32) = (0, seed)."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and 32-bit data broadcast
    together -> new keys ``[..., 2]``."""
    d = _u32(data, key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` uint32 draws per key (``[..., 2]`` -> ``[..., n]`` int64),
    the partitionable layout: element i is ``hi ^ lo`` of the cipher on
    the count (0, i) (n < 2**32, so the high count word is 0)."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., :1], key[..., 1:], torch.zeros_like(lo),
                          lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """float32 uniforms in [minval, 1) from :func:`random_bits32`: the 23
    high bits become the mantissa of a float in [1, 2), minus 1, then
    ``max(minval, u * (1 - minval) + minval)`` in float32 as
    ``jax.random._uniform`` computes it."""
    bits = (random_bits32(key, n) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars as Python floats (exact), so no host-to-device copy
    lo = float(np.float32(minval))
    span = float(np.float32(1.0) - np.float32(minval))
    return (u * span + lo).clamp(min=lo)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low"):
    ``-log(-log(uniform(minval=tiny)))``, ``[..., n]``."""
    return -torch.log(-torch.log(uniform(key, n, _TINY)))


def sample_keys(seeds, positions, device=None) -> torch.Tensor:
    """The reference sampler's per-token keys
    ``fold_in(fold_in(PRNGKey(0), seed), pos)`` for int32 seeds and
    positions broadcast together -> ``[..., 2]``."""
    s = _u32(seeds, device)
    base = prng_key(torch.zeros_like(s))
    return fold_in(fold_in(base, s), _u32(positions, device))
