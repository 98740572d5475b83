"""Weight bridge: numpy arrays (e.g. a JAX parameter tree read leaf by leaf
with ``np.asarray``) into the port's tensors, and back.  The same calls
carry KV pools: a quantized pool is the JAX engine's ``{"q": int8 codes,
"scale": f32 scales}`` pytree, the port engine's ``cache_k`` /
``cache_v`` pair, exactly.

bf16 arrives from JAX as an ``ml_dtypes`` bfloat16 array.  Its bits are
viewed as uint16 and reinterpreted as ``torch.bfloat16`` without any
arithmetic, so the round trip is exact.  The port itself never imports
JAX or ml_dtypes: a bf16 array is recognised by its dtype's name.

A weight-only int4 tree (``quantize_layer_params(params, 'int4')`` in
either package) stores ``jnp.int4`` codes ``[..., K]`` in JAX and packed
int8 ``[..., K // 2]`` in the port (two nibbles a byte, the KV pools'
layout).  An ``int4`` array (``ml_dtypes``) is widened to int8 and packed
on the way in; :func:`params_to_numpy` with ``quant='int4'`` unpacks the
``qweight`` leaves to int8 codes ``[..., K]``.  Both directions are exact.

On a training mesh (``models/llama.py``'s ``make_mesh``),
:func:`shard_params` / :func:`shard_opt_state` cut one rank's shard of a
whole tree by the reference's partition specs, the shard the reference
gives the device at that mesh position (with ``param_specs(pp=True)``
a rank holds its stage's L / P layers of every stacked leaf);
:func:`gather_params` puts the shards back together (for checks).
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
    if arr.dtype.name == "int4":
        from ..ops.kernels.paged_attention import _pack_int4

        if arr.shape[-1] % 2:
            raise ValueError(f"an int4 array packs two codes a byte along "
                             f"its last dim, got shape {arr.shape}")
        return _pack_int4(torch.from_numpy(arr.astype(np.int8))).to(device)
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


def params_to_numpy(tree, quant=None):
    """Inverse of :func:`params_from_numpy` (bf16 leaves as uint16 bits).
    ``quant='int4'``: the packed ``qweight`` leaves of a weight-only int4
    tree come back unpacked, int8 codes ``[..., K]``."""
    if isinstance(tree, dict):
        if quant == "int4" and "qweight" in tree:
            from ..ops.kernels.paged_attention import _unpack_int4

            return {k: (numpy_from_tensor(_unpack_int4(v, torch.int8))
                        if k == "qweight" else params_to_numpy(v, quant))
                    for k, v in tree.items()}
        return {k: params_to_numpy(v, quant) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v, quant) for v in tree)
    return numpy_from_tensor(tree)


_OPT_KEYS = ("step", "m", "v", "master", "gnorm")


def _opt_keys(state) -> tuple:
    """The state's keys in order: the reference's LM train steps keep
    ``gnorm``, its DiT train step does not."""
    keys = _OPT_KEYS if "gnorm" in state else _OPT_KEYS[:-1]
    if set(state) != set(keys):
        raise ValueError(f"optimizer state keys {sorted(state)}, expected "
                         f"{sorted(_OPT_KEYS)} (gnorm optional)")
    return keys


def opt_state_from_numpy(state, device=None):
    """The reference train step's optimizer state ``{step, m, v, master,
    gnorm}`` (``gnorm`` absent for the DiT's; each leaf read with
    ``np.asarray``) -> the port's, on ``device`` (None: the CUDA card):
    ``step`` int32 and ``gnorm`` f32 scalars, ``m``/``v``/``master`` f32
    trees shaped like the params."""
    return params_from_numpy({k: state[k] for k in _opt_keys(state)}, device)


def opt_state_to_numpy(state):
    """Inverse of :func:`opt_state_from_numpy`."""
    return params_to_numpy({k: state[k] for k in _opt_keys(state)})


def _check_tree(cfg, params):
    if ("lm_head" in params) == cfg.tie_word_embeddings:
        has = "has" if "lm_head" in params else "lacks"
        raise ValueError(f"tie_word_embeddings={cfg.tie_word_embeddings} "
                         f"but the tree {has} lm_head")


def _walk(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_params(cfg, params, specs, mesh, device=None):
    """This rank's shard of a whole parameter tree of the port: each leaf
    cut by its spec (``llama.param_specs``, which may list ``lm_head``
    for a tied tree) for ``mesh``'s position, the shard the reference
    gives device ``mesh.rank``, copied to ``device`` (None: where the
    leaf lies)."""
    from ..distributed.mesh import shard_leaf

    _check_tree(cfg, params)
    def cut(t, spec):
        t = shard_leaf(t, spec, mesh)
        return t if device is None else t.to(device)

    return _walk(cut, params, specs)


def shard_opt_state(cfg, state, specs, mesh, device=None):
    """This rank's shard of a whole optimizer state ``{step, m, v, master,
    gnorm}``: ``m``, ``v`` and ``master`` as :func:`shard_params`,
    ``step`` and ``gnorm`` replicated."""
    return {k: (shard_params(cfg, state[k], specs, mesh, device)
                if k in ("m", "v", "master")
                else state[k] if device is None else state[k].to(device))
            for k in _opt_keys(state)}


def gather_params(cfg, params, specs, mesh):
    """The whole tree from every rank's :func:`shard_params` shard (a
    collective: every rank of the mesh calls it)."""
    from ..distributed.mesh import unshard_leaf

    _check_tree(cfg, params)
    return _walk(lambda t, spec: unshard_leaf(t, spec, mesh), params, specs)
