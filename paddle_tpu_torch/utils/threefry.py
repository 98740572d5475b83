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
  ("low") mode, float32 or bfloat16;
- :func:`normal` and :func:`bernoulli`: ``jax.random.normal`` (float32,
  ``sqrt(2) * erf_inv`` of a uniform draw in ``(-1, 1)``, XLA's
  polynomial :func:`erf_inv32`) and
  ``jax.random.bernoulli`` (mode "low": a float32 uniform draw ``< p``),
  the draws of the DiT loss (``models/dit.py``);
- :func:`split` and :func:`categorical`: ``jax.random.split(key)`` and
  ``jax.random.categorical(key, logits, axis=-1)`` over a ``[..., V]``
  logits array in float32 or bfloat16, the draw of the reference's
  ``GenerationEngine`` at ``temperature > 0`` (its key is
  ``jax.random.key(seed)``, the same bits as :func:`prng_key`).

The bit layout of a ``[V]`` draw is the one of
``jax_threefry_partitionable=True`` (the default from JAX 0.5 on): element
``i`` of the draw is ``hi ^ lo`` of the cipher applied to the 64-bit count
``i`` split into the pair ``(i >> 32, i & 0xFFFFFFFF)``.  The other mode
(counts ``0..2n-1`` split in halves) is not ported.

uint32 arithmetic is emulated in int64 tensors with ``& 0xFFFFFFFF`` after
every add and shift, so the same code runs on CPU and CUDA tensors.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


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


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            dtype: torch.dtype = torch.float32,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)`` in
    [minval, maxval) from :func:`random_bits32`, float32 or bfloat16: the
    high bits of a float32 draw (23), or the low byte of each draw (its 7
    high bits) for bfloat16, as ``jax.random._uniform`` takes 8 random
    bits for a float with fewer than 8 mantissa bits, become the mantissa
    of a float in [1, 2), minus 1; then ``max(minval, u * (maxval - minval) + minval)``
    in ``dtype``, as ``jax.random._uniform`` computes it."""
    bits = random_bits32(key, n)
    if dtype == torch.float32:
        u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(dtype) - 1.0
    elif dtype == torch.bfloat16:
        u = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(dtype) - 1.0
    else:
        raise TypeError(f"uniform: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    # the scalars rounded to dtype as Python floats (exact), so no
    # host-to-device copy
    lo = torch.tensor(minval, dtype=dtype)
    lo, span = float(lo), float(torch.tensor(maxval, dtype=dtype) - lo)
    return (u * span + lo).clamp(min=lo)


def gumbel(key: torch.Tensor, n: int,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), dtype)`` (mode "low"), float32 or
    bfloat16: ``-log(-log(uniform(minval=tiny)))``, ``[..., n]``."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(key, n, tiny, dtype)))


#: XLA's ``ErfInv32`` coefficients (Giles' single-precision polynomial),
#: for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (``jax.lax.erf_inv``): ``w = -log1p(-x^2)``,
    a degree-8 polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, each
    step an FMA as XLA's CPU compiler contracts it, times x; +-1 map to
    +-float32 max.  ``torch.erfinv`` is the correctly rounded function and
    lies up to ~63 ulps from this one in the tails; this one lies within 2
    ulps of XLA's (their ``log1p`` differ)."""
    from ..ops.kernels.rope import fma_f32

    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, a, b).to(x.dtype)
        p = c if p is None else fma_f32(p, w, c)
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1, x * big, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` for one key ``[2]``:
    ``sqrt(2) * erf_inv(u)`` with ``u`` the float32 uniform draw in
    ``[nextafter(-1, 0), 1)`` over the flattened shape, as
    ``jax.random._normal_real`` computes it.  The uniform bits equal
    ``jax.random``'s; through :func:`erf_inv32` the normals lie within 4
    float32 ulps of its (3 at most on the tests' draws)."""
    shape = tuple(shape)
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, math.prod(shape), minval=lo, maxval=1.0)
    sqrt2 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))
    return (sqrt2 * erf_inv32(u)).reshape(shape)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low") for one key
    ``[2]`` and a Python float ``p``: the float32 uniform draw over the
    flattened shape ``< float32(p)``, bool."""
    shape = tuple(shape)
    p32 = float(torch.tensor(p, dtype=torch.float32))
    return (uniform(key, math.prod(shape)) < p32).reshape(shape)


def sample_keys(seeds, positions, device=None) -> torch.Tensor:
    """The reference sampler's per-token keys
    ``fold_in(fold_in(PRNGKey(0), seed), pos)`` for int32 seeds and
    positions broadcast together -> ``[..., 2]``."""
    s = _u32(seeds, device)
    base = prng_key(torch.zeros_like(s))
    return fold_in(fold_in(base, s), _u32(positions, device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one key ``[2]`` -> ``[num, 2]``:
    key i is the cipher on the count (0, i), the partitionable layout."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for one key
    ``[2]``: ``argmax(gumbel(key, logits.shape, logits.dtype) + logits)``
    in ``logits.dtype`` (float32 or bfloat16), element ``i`` of the
    row-major draw from the count ``i`` as in :func:`random_bits32`."""
    noise = gumbel(key, logits.numel(), logits.dtype)
    return (noise.reshape(logits.shape) + logits).argmax(dim=-1)
