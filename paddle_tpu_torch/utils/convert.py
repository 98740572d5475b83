"""Weight bridge: numpy arrays (e.g. a JAX parameter tree read leaf by leaf
with ``np.asarray``) into the port's tensors, and back.  The same calls
carry KV pools: a quantized pool is the JAX engine's ``{"q": int8 codes,
"scale": f32 scales}`` pytree, the port engine's ``cache_k`` /
``cache_v`` pair, exactly.

bf16 arrives from JAX as an ``ml_dtypes`` bfloat16 array.  Its bits are
viewed as uint16 and reinterpreted as ``torch.bfloat16`` without any
arithmetic, so the round trip is exact.  The port itself never imports
JAX or ml_dtypes: a bf16 array is recognised by its dtype's name.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.int8): torch.int8,
                np.dtype(np.uint8): torch.uint8,
                np.dtype(np.bool_): torch.bool}


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One array -> tensor on ``device`` (None: the CUDA card, raising
    without one), bit-exact (bf16 included)."""
    device = resolve_device(device)
    # a C-ordered copy that keeps 0-d scalars 0-d (ascontiguousarray would
    # make them [1])
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        bits = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if arr.dtype not in _NP_TO_TORCH:
        raise TypeError(f"unsupported dtype {arr.dtype}")
    return torch.from_numpy(arr).to(device)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy.  A bf16 tensor comes back as its raw bits, a
    uint16 array (view it as ``ml_dtypes.bfloat16`` to get the values)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree, device=None):
    """A nested dict (or list/tuple) of arrays -> the same structure of
    tensors on ``device`` (None: the CUDA card, raising without one).
    Takes JAX parameter trees and pools alike (fp pools, and quantized
    ``{"q", "scale"}`` pairs: int8 and f32 leaves come over bit for bit):
    every leaf goes through ``np.asarray`` then :func:`tensor_from_numpy`."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy` (bf16 leaves as uint16 bits)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return numpy_from_tensor(tree)


_OPT_KEYS = ("step", "m", "v", "master", "gnorm")


def opt_state_from_numpy(state, device=None):
    """The reference train step's optimizer state ``{step, m, v, master,
    gnorm}`` (each leaf read with ``np.asarray``) -> the port's, on
    ``device`` (None: the CUDA card): ``step`` int32 and ``gnorm`` f32
    scalars, ``m``/``v``/``master`` f32 trees shaped like the params."""
    if set(state) != set(_OPT_KEYS):
        raise ValueError(f"optimizer state keys {sorted(state)}, expected "
                         f"{sorted(_OPT_KEYS)}")
    return params_from_numpy({k: state[k] for k in _OPT_KEYS}, device)


def opt_state_to_numpy(state):
    """Inverse of :func:`opt_state_from_numpy`."""
    return params_to_numpy({k: state[k] for k in _OPT_KEYS})
