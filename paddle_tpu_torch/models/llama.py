"""Llama family (counterpart of ``paddle_tpu/models/llama.py``).

Ported: the configuration, the parameter initializer, the decoder seams
the serving path runs through, and the single-device training path:
``forward`` -> ``loss_fn`` -> ``build_train_step`` (AdamW with f32 master
weights, exactly the reference's update).  The parameter dict has the
reference's layout: layer weights stacked over a leading layer dimension,
matmul weights ``[L, in, out]``.

Tensor-parallel serving: :data:`MEGATRON_SPLIT` and
:func:`shard_serving_params`, one rank's slice of the serving tree in the
layout of the reference's ``serving_param_specs``, and the two all-reduce
boundaries of each layer in the decoder seams (``tp_group``:
:func:`_tp_all_reduce` over a ``torch.distributed`` group, where the
reference runs ``psum`` inside ``shard_map``).

How the reference's JAX mechanisms map here:

- the layer ``lax.scan`` is a Python loop over the stacked weights
  (``unbind`` once, so their gradient is stacked once);
- ``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant), with
  the reference's ``PADDLE_TPU_REMAT`` policies: ``full`` (default),
  ``none``, and ``dots`` (selective checkpointing that saves the outputs
  of 2-D matrix products, as ``dots_with_no_batch_dims_saveable`` does);
- ``jax.value_and_grad`` is ``torch.autograd.grad``; the jitted, donated
  train step updates the parameter and optimizer tensors in place.

Not ported yet: the training meshes and their specs, pipeline schedules
and context parallel attention (ROADMAP A11), and the eager Layer surface
(A12).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.kernels import flash_attention as fa
from ..ops.kernels import rms_norm as rms
from ..ops.kernels import rope as rope_mod
from ..ops.kernels import swiglu as swiglu_mod


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b():
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        )

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
             seq=128):
        return LlamaConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, max_position_embeddings=seq,
        )


def init_params(cfg: LlamaConfig, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> dict:
    """Parameter dict with the reference's shapes: normal(0, 0.02) matmul
    and embedding weights, unit norms, layer weights stacked over a leading
    layer dim.  Drawn from ``generator`` (or one seeded with ``seed`` on
    ``device``), in f32, then cast to ``cfg.dtype``.  The numbers differ
    from ``jax.random``'s for the same seed; parity tests bridge the JAX
    tree instead (utils/convert.py)."""
    from .. import resolve_device

    dev = resolve_device(device) if generator is None else generator.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    L = cfg.num_hidden_layers
    std = 0.02

    def init(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(std).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    params = {
        "embed": init((v, h)),
        "final_norm": ones((h,)),
        "layers": {
            "input_norm": ones((L, h)),
            "post_norm": ones((L, h)),
            "wq": init((L, h, nh * hd)),
            "wk": init((L, h, nkv * hd)),
            "wv": init((L, h, nkv * hd)),
            "wo": init((L, nh * hd, h)),
            "w_gate": init((L, h, i)),
            "w_up": init((L, h, i)),
            "w_down": init((L, i, h)),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init((h, v))
    return params


#: the Megatron split of each decoder matmul leaf: 'col' splits the output
#: dim over the tensor-parallel ranks (ColumnParallelLinear), 'row' the
#: input dim (RowParallelLinear).  The reference's one table, read by its
#: training and serving specs alike
MEGATRON_SPLIT = {"wq": "col", "wk": "col", "wv": "col",
                  "w_gate": "col", "w_up": "col",
                  "wo": "row", "w_down": "row"}

#: collectives the tensor-parallel seams ran in this process
#: (:func:`_tp_all_reduce`); a caller resets it by assigning 0
TP_COUNTERS = {"all_reduce": 0}


def serving_matmul_shapes(cfg: LlamaConfig) -> dict:
    """The full ``[L, in, out]`` shape of each layer matmul leaf."""
    L, h, i = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    q = cfg.num_attention_heads * cfg.head_dim
    kv = cfg.num_key_value_heads * cfg.head_dim
    return {"wq": (L, h, q), "wk": (L, h, kv), "wv": (L, h, kv),
            "wo": (L, q, h), "w_gate": (L, h, i), "w_up": (L, h, i),
            "w_down": (L, i, h)}


def shard_serving_params(cfg: LlamaConfig, params: dict, rank: int, tp: int,
                         quant: str | None = None) -> dict:
    """Rank ``rank``'s slice of the serving tree over ``tp`` ranks: the
    shard the reference's ``serving_param_specs(cfg, quant)`` gives device
    ``rank`` of a 1-D mesh.  Column-parallel leaves (:data:`MEGATRON_SPLIT`)
    split their output dim, row-parallel ones their input dim; the norms,
    ``embed`` and ``lm_head`` are replicated (returned as they are).

    ``quant`` ('int8' / 'int4'): the matmul leaves are weight-only
    ``{'qweight': [L, out, in], 'scale': [L, out]}`` dicts (int4 codes
    packed two a byte, ``[L, out, in // 2]``), split through the
    transposed layout; a row-parallel leaf keeps every scale, so the
    dequantize stays shard-local.  Quantize the FULL tree first and slice
    it after: a row-parallel scale is an absmax over the whole input dim,
    so a quantized slice would carry other scales and other codes.

    The split leaves are contiguous copies on the leaves' device; a dim
    that ``tp`` does not divide raises ``ValueError``."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside [0, {tp})")

    def split(t, dim):
        n = t.shape[dim]
        if n % tp:
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} leaf does "
                             f"not split {tp} ways")
        w = n // tp
        return t.narrow(dim, rank * w, w).contiguous()

    def leaf(name, t):
        how = MEGATRON_SPLIT.get(name)
        if how is None:
            return t                         # the norms: replicated
        if isinstance(t, dict) != (quant is not None):
            kind = "a weight-only dict" if isinstance(t, dict) else "a tensor"
            raise ValueError(f"layer leaf {name!r} is {kind} but "
                             f"quant={quant!r}")
        if quant is None:
            return split(t, 2 if how == "col" else 1)
        if how == "col":
            return {"qweight": split(t["qweight"], 1),
                    "scale": split(t["scale"], 1)}
        return {"qweight": split(t["qweight"], 2), "scale": t["scale"]}

    out = dict(params)
    out["layers"] = {k: leaf(k, v) for k, v in params["layers"].items()}
    return out


def _tp_all_reduce(y, group):
    """The tensor-parallel boundary: ``group=None`` is the single-card
    path (no collective); else ``y`` is a row-parallel partial sum that a
    sum all-reduce over the group completes, counted in
    :data:`TP_COUNTERS`.  A failing collective raises."""
    if group is None:
        return y
    y = y.contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    TP_COUNTERS["all_reduce"] += 1
    return y


def decoder_attn_residual(x, attn, lp, wmat=None, tp_group=None):
    """Attention output projection + residual: ``wo`` is row-parallel,
    so under tensor parallelism (``tp_group``) ``attn @ wo`` is a partial
    sum and the all-reduce here is the layer's first boundary.
    ``wmat(leaf, dtype)`` resolves weight-only-quantized leaves (serving);
    None reads the leaf raw."""
    wo = lp["wo"] if wmat is None else wmat(lp["wo"], x.dtype)
    return x + _tp_all_reduce(attn @ wo, tp_group)


def decoder_mlp_residual(cfg, x, lp, wmat=None, tp_group=None):
    """post-norm + swiglu MLP + residual (``wmat`` as above): ``w_gate``
    and ``w_up`` are column-parallel, ``w_down`` row-parallel, and the
    all-reduce completing the down projection is the layer's second
    boundary."""
    def w(n):
        return lp[n] if wmat is None else wmat(lp[n], x.dtype)

    xn = rms.rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    y = swiglu_mod.swiglu(xn @ w("w_gate"), xn @ w("w_up")) @ w("w_down")
    return x + _tp_all_reduce(y, tp_group)


def decoder_layer_tail(cfg, x, attn, lp, wmat=None, mlp_fn=None,
                       tp_group=None):
    """The post-attention half of a decoder layer in one seam.

    ``mlp_fn=None`` composes :func:`decoder_attn_residual` and
    :func:`decoder_mlp_residual`.  With ``mlp_fn(h_res, attn_y, lp) ->
    (h1, y)`` the residual add + post RMSNorm + SwiGLU MLP run through the
    caller's fused implementation (the serving decode path passes
    ``ops/kernels/paged_attention.fused_layer_mlp``), which returns the
    down projection ``y`` UN-reduced, and the layer closes with ``h1 +
    y``.  Either way ``tp_group`` puts the layer's two all-reduces after
    the attention output projection and after the down projection.
    ``wmat(leaf, dtype)`` resolves weight-only-quantized leaves (serving);
    the training path passes none and reads fp leaves."""
    if mlp_fn is None:
        x = decoder_attn_residual(x, attn, lp, wmat=wmat, tp_group=tp_group)
        return decoder_mlp_residual(cfg, x, lp, wmat=wmat, tp_group=tp_group)
    wo = lp["wo"] if wmat is None else wmat(lp["wo"], x.dtype)
    h1, y = mlp_fn(x, _tp_all_reduce(attn @ wo, tp_group), lp)
    return h1 + _tp_all_reduce(y, tp_group)


# ---------------------------------------------------------------------------
# training path (single device)
# ---------------------------------------------------------------------------

def _layer_forward(cfg: LlamaConfig, x, lp, cos, sin):
    """One transformer block; x [b, s, h]."""
    b, s, _ = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    xn = rms.rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = (xn @ lp["wq"]).reshape(b, s, nh, hd)
    k = (xn @ lp["wk"]).reshape(b, s, nkv, hd)
    v = (xn @ lp["wv"]).reshape(b, s, nkv, hd)
    q, k = rope_mod.apply_rotary_pos_emb(q, k, cos, sin)
    attn = fa.flash_attention_bshd(q, k, v, causal=True)
    return decoder_layer_tail(cfg, x, attn.reshape(b, s, nh * hd), lp)


def _embed_rope(cfg: LlamaConfig, params, input_ids):
    """Token embedding + rope tables for the sequence length."""
    x = F.embedding(input_ids.long(), params["embed"]).to(cfg.dtype)
    cos, sin = rope_mod.rope_cos_sin(x.shape[1], cfg.head_dim,
                                     base=cfg.rope_theta, dtype=cfg.dtype,
                                     device=x.device)
    return x, cos, sin


def _norm_and_head(cfg: LlamaConfig, params, x):
    """Final rms_norm + the (possibly tied) lm head weight."""
    xn = rms.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(cfg.dtype)
    return xn, head


def _final_head(cfg: LlamaConfig, params, x):
    xn, head = _norm_and_head(cfg, params, x)
    return xn @ head


#: ops whose outputs the ``dots`` policy saves: matrix products without a
#: batch dimension (``x @ W`` on [b, s, h] dispatches as a 2-D mm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(body):
    """The recompute policy, ``PADDLE_TPU_REMAT`` read at every call:
    'full' (default: recompute the whole block in the backward), 'dots'
    (save matmul outputs, recompute the rest), 'none'."""
    policy = os.environ.get("PADDLE_TPU_REMAT", "full")
    if policy == "none":
        return body
    if policy == "dots":
        return lambda *a: checkpoint(
            body, *a, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _dots_policy))
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def forward(cfg: LlamaConfig, params, input_ids, return_hidden=False):
    """Logits [b, s, V] for [b, s] token ids (``return_hidden``: the last
    hidden states instead, for the chunked loss).  The layer loop runs
    each block under the recompute policy."""
    x, cos, sin = _embed_rope(cfg, params, input_ids)

    def body(h, lp):
        return _layer_forward(cfg, h, lp, cos, sin)

    layer = _remat_wrap(body)
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    for leaves in per_layer:
        x = layer(x, dict(zip(names, leaves)))
    if return_hidden:
        return x
    return _final_head(cfg, params, x)


def _xent(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -picked.mean()


def _xent_chunk_env() -> int:
    """``PADDLE_TPU_XENT_CHUNK=<positions>``: sequence-chunked
    cross-entropy.  0/unset = off."""
    raw = os.environ.get("PADDLE_TPU_XENT_CHUNK", "0")
    try:
        return int(raw)
    except ValueError:
        # a typo silently disabling chunking would resurface the OOM the
        # flag exists to prevent
        raise ValueError(
            f"PADDLE_TPU_XENT_CHUNK must be an integer, got {raw!r}") from None


def _chunk_logp_sum(xc, lbl, head):
    logp = torch.log_softmax((xc @ head).float(), dim=-1)
    return logp.gather(-1, lbl.long()[..., None]).sum()


def head_xent(cfg: LlamaConfig, params, x, labels):
    """final_norm + lm head + cross entropy.  With PADDLE_TPU_XENT_CHUNK
    the head matmul + log_softmax run per sequence
    chunk, each under its own checkpoint, so the full [b, s, V] f32 logits
    never exist at once; the numbers are the unchunked ones (log_softmax
    is per position)."""
    chunk = _xent_chunk_env()
    b, s, _ = x.shape
    if chunk <= 0 or s <= chunk or s % chunk:
        return _xent(_final_head(cfg, params, x), labels)
    xn, head = _norm_and_head(cfg, params, x)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        tot = tot + checkpoint(_chunk_logp_sum, xn[:, i:i + chunk],
                               labels[:, i:i + chunk], head,
                               use_reentrant=False)
    return -tot / (b * s)


def loss_fn(cfg: LlamaConfig, params, input_ids, labels):
    if _xent_chunk_env() > 0:
        x = forward(cfg, params, input_ids, return_hidden=True)
        return head_xent(cfg, params, x, labels)
    return _xent(forward(cfg, params, input_ids), labels)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in the reference's ``tree_flatten`` order
    (keys sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def value_and_grad(fn, params):
    """(``fn(params)``, its gradients in :func:`tree_leaves` order, each in
    its parameter's dtype): the reference's ``jax.value_and_grad``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = fn(params)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def loss_and_grads(cfg: LlamaConfig, params, input_ids, labels):
    """(loss, gradients) of :func:`loss_fn` (:func:`value_and_grad`)."""
    return value_and_grad(lambda p: loss_fn(cfg, p, input_ids, labels),
                          params)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the f32 sum of squares, summed leaf by leaf in order (one
    leaf's f32 copy at a time)."""
    total = 0
    for g in grads:
        gf = g.float()
        total = total + (gf * gf).sum()
    return torch.sqrt(total)


def adamw_init(params, gnorm: bool = True) -> dict:
    """The reference's optimizer state for ``params``: ``step`` (int32 0),
    f32 zero moments ``m`` / ``v``, f32 ``master`` copies, and (``gnorm``)
    the pre-clip gradient norm, an f32 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": _tree_map(zeros, params), "v": _tree_map(zeros, params),
             "master": _tree_map(lambda p: p.float().clone(), params)}
    if gnorm:
        state["gnorm"] = torch.zeros((), dtype=torch.float32, device=dev)
    return state


@torch.no_grad()
def adamw_update(leaves, grads, opt_state, lr, weight_decay, beta1, beta2,
                 grad_clip) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's AdamW update, IN PLACE on the parameter leaves and
    ``opt_state``'s ``m`` / ``v`` / ``master`` (all in :func:`tree_leaves`
    order): the f32 global-norm clip ``scale = min(1, clip / max(gnorm,
    1e-6))``, bias corrections from an f32 step, decoupled decay, the f32
    master cast back to each parameter's dtype.  Returns (step, gnorm);
    the caller stores them."""
    gnorm = global_norm(grads)
    scale_f = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-6), max=1.0)
    step = opt_state["step"] + 1
    b1c = 1 - beta1 ** step.float()
    b2c = 1 - beta2 ** step.float()
    for p, g, m, v, w in zip(leaves, grads, tree_leaves(opt_state["m"]),
                             tree_leaves(opt_state["v"]),
                             tree_leaves(opt_state["master"])):
        g = g.float() * scale_f
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * g * g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + 1e-8)
        w.mul_(1 - lr * weight_decay).sub_(lr * update)
        p.copy_(w)
    return step, gnorm


def adamw_train_step(loss_and_grads_fn, lr, weight_decay, beta1, beta2,
                     grad_clip, keep_gnorm=True):
    """(train_step, opt_init) around ``loss_and_grads_fn(params, *batch)
    -> (loss, grads)``: ``train_step(params, opt_state, *batch) -> (loss,
    params, opt_state)`` runs it, then :func:`adamw_update`, updating the
    parameter and optimizer tensors IN PLACE (the reference donates them)
    and returning the same dicts; the state keeps ``gnorm`` when
    ``keep_gnorm`` (the reference's LM train steps do, its DiT's not)."""

    def train_step(params, opt_state, *batch):
        loss, grads = loss_and_grads_fn(params, *batch)
        step, gnorm = adamw_update(tree_leaves(params), grads, opt_state, lr,
                                   weight_decay, beta1, beta2, grad_clip)
        opt_state["step"] = step
        if keep_gnorm:
            opt_state["gnorm"] = gnorm
        return loss, params, opt_state

    return train_step, lambda params: adamw_init(params, keep_gnorm)


def build_train_step(cfg: LlamaConfig, lr=3e-4, weight_decay=0.1, beta1=0.9,
                     beta2=0.95, grad_clip=1.0):
    """(train_step, opt_init) for one device, the reference's
    ``build_train_step`` on a 1-device mesh: ``train_step(params,
    opt_state, input_ids, labels) -> (loss, new_params, new_opt)``,
    :func:`loss_and_grads` then AdamW (:func:`adamw_train_step`); gnorm is
    reckoned leaf by leaf, so no f32 copy of all the gradients exists at
    once."""
    return adamw_train_step(
        lambda params, ids, labels: loss_and_grads(cfg, params, ids, labels),
        lr, weight_decay, beta1, beta2, grad_clip)


def flops_per_token(cfg: LlamaConfig) -> float:
    """Training FLOPs/token ~ 6 * matmul params (attention's quadratic term
    is :func:`attn_flops_per_token`)."""
    h, i, v, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    per_layer = h * (nh * hd) + 2 * h * (nkv * hd) + (nh * hd) * h + 3 * h * i
    return 6.0 * (L * per_layer + v * h)


def attn_flops_per_token(cfg: LlamaConfig, seq: int,
                         causal: bool = True) -> float:
    """Attention's two [s, hd] x [hd, s] products per head, forward and
    backward (x3); causal counts the lower triangle, an average kv length
    of (s + 1) / 2."""
    eff = (seq + 1) / 2.0 if causal else float(seq)
    return (6.0 * 2.0 * eff * cfg.head_dim * cfg.num_attention_heads
            * cfg.num_hidden_layers)


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
