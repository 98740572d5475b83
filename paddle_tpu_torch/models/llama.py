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

Hybrid-parallel training (the reference's ``build_train_step(cfg,
make_mesh(dp, mp, sharding, sep))`` without pipelining): :func:`make_mesh`
lays the ``torch.distributed`` ranks out over the reference's axes
(``distributed/mesh.py``), :func:`param_specs` is the reference's table of
partition specs as tuples, and each rank holds the shard of every leaf
that table gives the device at its position.  ``build_train_step(cfg,
mesh)`` runs the step on those shards with the collectives written out:

- ``mp``: Megatron splits (:data:`MEGATRON_SPLIT`): column-parallel
  ``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up`` behind ``copy_to``,
  row-parallel ``wo`` / ``w_down`` then ``psum``; K/V replicated when
  ``mp`` does not divide the kv heads (each rank computes the kv heads of
  its own q heads, so their gradient is summed over ``mp``); the
  vocab-parallel embedding (a masked local lookup, then ``psum``) and head
  and cross-entropy (max, sum-exp and target-logit all-reduces: no rank
  holds ``[b, s, V]``);
- ``sharding`` (ZeRO): each leaf all-gathered over its sharded dim where
  it is used, inside the recomputed block, so its gradient is a
  reduce-scatter and full recompute gathers again;
- ``dp`` and ``sharding`` split the batch, ``sep`` the sequence (rope
  tables sliced to the rank's positions; ring or Ulysses attention,
  ``ops/ring_attention.py``); the loss is the global token mean;
- gradients are summed over every axis whose ranks saw other data for a
  leaf they both hold, and over ``mp`` for the replicated K/V; the
  clipping norm sums each leaf's squares over the axes it is split on.

The pipeline axis (``pp`` > 1; ``distributed/fleet/pipeline.py``): each
``pp`` rank holds its stage's L / P layers (``param_specs(pp=True)``).
``pipeline_schedule`` 'gpipe' / 'fthenb' runs :func:`loss_fn_pp` through
autograd (:func:`forward_pp`: every stage embeds, stage 0 feeds the
pipeline, the last stage's outputs come back whole to every stage, which
then runs the head); the default and '1f1b' / 'eager_1f1b', 'vpp' /
'interleave' and 'zb' / 'zero_bubble' run :func:`loss_and_grads_1f1b`,
the executed clock with stage 0 owning the embedding and the last stage
the head, so ``embed``, ``lm_head`` and ``final_norm`` have their
gradients summed over ``pp`` too.  Both compose with dp, sharding (the
ZeRO gathers inside the recomputed stage), mp and sep: a rank's
microbatch ``m`` is rows ``m`` of its own batch shard split M ways (the
reference splits the global batch first, so its microbatch holds other
rows; both sum the same tokens).

Not ported yet: the MoE and DiT meshes (ROADMAP A11), and the eager Layer
surface with ``PipelineLayer`` / ``PipelineParallel`` (A12).
"""

from __future__ import annotations

import dataclasses
import os
import types

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed import mesh as dmesh
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


def _row_reduce(y, tp_group, mesh):
    """A row-parallel product's boundary: the training mesh's
    differentiable ``psum`` over ``mp``, else the serving all-reduce."""
    if mesh is not None:
        return dmesh.psum(y, mesh, "mp")
    return _tp_all_reduce(y, tp_group)


def decoder_attn_residual(x, attn, lp, wmat=None, tp_group=None, mesh=None):
    """Attention output projection + residual: ``wo`` is row-parallel,
    so under tensor parallelism (``tp_group``, or a training ``mesh``'s
    ``mp``) ``attn @ wo`` is a partial sum and the all-reduce here is the
    layer's first boundary.  ``wmat(leaf, dtype)`` resolves
    weight-only-quantized leaves (serving); None reads the leaf raw."""
    wo = lp["wo"] if wmat is None else wmat(lp["wo"], x.dtype)
    return x + _row_reduce(attn @ wo, tp_group, mesh)


def decoder_mlp_residual(cfg, x, lp, wmat=None, tp_group=None, mesh=None):
    """post-norm + swiglu MLP + residual (``wmat`` as above): ``w_gate``
    and ``w_up`` are column-parallel (on a training ``mesh`` behind
    ``copy_to``), ``w_down`` row-parallel, and the all-reduce completing
    the down projection is the layer's second boundary."""
    def w(n):
        return lp[n] if wmat is None else wmat(lp[n], x.dtype)

    xn = rms.rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    if mesh is not None:
        xn = dmesh.copy_to(xn, mesh, "mp")
    y = swiglu_mod.swiglu(xn @ w("w_gate"), xn @ w("w_up")) @ w("w_down")
    return x + _row_reduce(y, tp_group, mesh)


def decoder_layer_tail(cfg, x, attn, lp, wmat=None, mlp_fn=None,
                       tp_group=None, mesh=None):
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
    the training path passes none and reads fp leaves, and on a ``mesh``
    puts the differentiable collectives of its ``mp`` axis where the
    serving all-reduces go."""
    if mlp_fn is None:
        x = decoder_attn_residual(x, attn, lp, wmat=wmat, tp_group=tp_group,
                                  mesh=mesh)
        return decoder_mlp_residual(cfg, x, lp, wmat=wmat, tp_group=tp_group,
                                    mesh=mesh)
    wo = lp["wo"] if wmat is None else wmat(lp["wo"], x.dtype)
    h1, y = mlp_fn(x, _tp_all_reduce(attn @ wo, tp_group), lp)
    return h1 + _tp_all_reduce(y, tp_group)


# ---------------------------------------------------------------------------
# training path (one device, or one rank of a mesh: ``plan``)
# ---------------------------------------------------------------------------

def _layer_forward(cfg: LlamaConfig, x, lp, cos, sin, plan=None):
    """One transformer block; x [b, s, h].  On a mesh (``plan``, see
    :func:`_mesh_plan`) ``lp`` holds this rank's shards: the ZeRO dims are
    gathered here, inside the recomputed block, and the q / k / v heads
    are the rank's own."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    mesh = None if plan is None else plan.mesh
    if mesh is not None:
        lp = {n: _zero_gather(plan, t, plan.specs["layers"][n][1:])
              for n, t in lp.items()}
    xn = rms.rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    wk, wv = lp["wk"], lp["wv"]
    if mesh is not None:
        xn = dmesh.copy_to(xn, mesh, "mp")
        if plan.kv is not None:         # K/V replicated over mp
            lo, n = plan.kv
            wk, wv = (w[:, lo * hd:(lo + n) * hd] for w in (wk, wv))
    q = (xn @ lp["wq"]).reshape(b, s, -1, hd)
    k = (xn @ wk).reshape(b, s, -1, hd)
    v = (xn @ wv).reshape(b, s, -1, hd)
    q, k = rope_mod.apply_rotary_pos_emb(q, k, cos, sin)
    if plan is not None and plan.attn_fn is not None:
        attn = plan.attn_fn(q, k, v)
    else:
        attn = fa.flash_attention_bshd(q, k, v, causal=True)
    return decoder_layer_tail(cfg, x, attn.reshape(b, s, -1), lp, mesh=mesh)


def _embed(cfg: LlamaConfig, params, input_ids, plan):
    """The token embedding on a mesh: the vocab-parallel lookup (rows
    outside the rank's vocab slice read 0, then ``psum`` over ``mp``) of
    the table gathered over ``sharding``."""
    mesh = plan.mesh
    table = _zero_gather(plan, params["embed"], plan.specs["embed"])
    ids = input_ids.long()
    if mesh.shape["mp"] > 1:
        vl = table.shape[0]
        ids = ids - mesh.axis_index("mp") * vl
        inside = (ids >= 0) & (ids < vl)
        x = F.embedding(ids.clamp(0, vl - 1), table) \
            * inside[..., None].to(table.dtype)
        x = dmesh.psum(x, mesh, "mp")
    else:
        x = F.embedding(ids, table)
    return x.to(cfg.dtype)


def _rope(cfg: LlamaConfig, s: int, plan, device):
    """The rope tables of this rank's ``s`` positions of the
    ``sep``-split sequence."""
    mesh = plan.mesh
    cos, sin = rope_mod.rope_cos_sin(s * mesh.shape["sep"], cfg.head_dim,
                                     base=cfg.rope_theta, dtype=cfg.dtype,
                                     device=device)
    at = mesh.axis_index("sep") * s
    return cos[:, at:at + s], sin[:, at:at + s]


def _embed_rope(cfg: LlamaConfig, params, input_ids, plan=None):
    """Token embedding + rope tables for the sequence length.  On a mesh:
    :func:`_embed` and the tables of the rank's positions (:func:`_rope`)."""
    if plan is None:
        x = F.embedding(input_ids.long(), params["embed"]).to(cfg.dtype)
        cos, sin = rope_mod.rope_cos_sin(x.shape[1], cfg.head_dim,
                                         base=cfg.rope_theta,
                                         dtype=cfg.dtype, device=x.device)
        return x, cos, sin
    x = _embed(cfg, params, input_ids, plan)
    return (x,) + _rope(cfg, x.shape[1], plan, x.device)


def _norm_and_head(cfg: LlamaConfig, params, x, plan=None):
    """Final rms_norm + the (possibly tied) lm head weight; on a mesh the
    normed states behind ``copy_to`` and the rank's vocab columns of the
    head, ``[h, V / mp]``, gathered over ``sharding``."""
    xn = rms.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if plan is not None:
        xn = dmesh.copy_to(xn, plan.mesh, "mp")
        if head is None:
            return xn, _zero_gather(plan, params["embed"],
                                    plan.specs["embed"]).T.to(cfg.dtype)
        return xn, _zero_gather(plan, head, plan.specs["lm_head"])
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


def _run_layers(cfg: LlamaConfig, layers, x, cos, sin, plan=None):
    """The layer loop over the stacked ``layers`` (their leading dim),
    each block under the recompute policy where autograd records (a
    pipeline's forward-only ticks run the blocks bare)."""
    def body(h, lp):
        return _layer_forward(cfg, h, lp, cos, sin, plan)

    layer = _remat_wrap(body) if torch.is_grad_enabled() else body
    names = list(layers)
    for leaves in zip(*(layers[n].unbind(0) for n in names)):
        x = layer(x, dict(zip(names, leaves)))
    return x


def forward(cfg: LlamaConfig, params, input_ids, return_hidden=False,
            plan=None):
    """Logits [b, s, V] for [b, s] token ids (``return_hidden``: the last
    hidden states instead, for the chunked loss).  The layer loop runs
    each block under the recompute policy.  On a mesh (``plan``): this
    rank's shard of the hidden states, or of the logits, ``[b, s, V /
    mp]``."""
    x, cos, sin = _embed_rope(cfg, params, input_ids, plan)
    x = _run_layers(cfg, params["layers"], x, cos, sin, plan)
    if return_hidden:
        return x
    if plan is not None:
        xn, head = _norm_and_head(cfg, params, x, plan)
        return xn @ head
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


def _vocab_parallel_nll(plan, xc, lbl, head):
    """Sum over the positions of ``-log softmax(xc @ head)[label]`` with
    the vocabulary split over ``mp``: this rank's logits ``[.., V / mp]``
    f32, their max (an all-reduce outside autograd: the shift cancels in
    the gradient), the sum of exponentials and the label's logit (zero on
    the ranks whose slice misses it) each summed over ``mp``."""
    mesh = plan.mesh
    z = (xc @ head).float()
    vl = z.shape[-1]
    m = dmesh.pmax(z.amax(-1, keepdim=True), mesh, "mp")
    se = dmesh.psum(torch.exp(z - m).sum(-1, keepdim=True), mesh, "mp")
    local = lbl.long() - mesh.axis_index("mp") * vl
    inside = (local >= 0) & (local < vl)
    zt = z.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    zt = dmesh.psum(torch.where(inside, zt, 0.0), mesh, "mp")
    return (m[..., 0] + torch.log(se[..., 0]) - zt).sum()


def head_xent(cfg: LlamaConfig, params, x, labels, plan=None):
    """final_norm + lm head + cross entropy.  With PADDLE_TPU_XENT_CHUNK
    the head matmul + log_softmax run per sequence
    chunk, each under its own checkpoint, so the full [b, s, V] f32 logits
    never exist at once; the numbers are the unchunked ones (log_softmax
    is per position).  On a mesh (``plan``): x is this rank's shard, the
    head vocab-parallel (:func:`_vocab_parallel_nll`, chunked the same
    way over the rank's positions), and the loss the mean over every
    token of the global batch, summed over ``dp``, ``sharding`` and
    ``sep``."""
    chunk = _xent_chunk_env()
    b, s, _ = x.shape
    if plan is not None:
        xn, head = _norm_and_head(cfg, params, x, plan)
        if chunk <= 0 or s <= chunk or s % chunk:
            tot = _vocab_parallel_nll(plan, xn, labels, head)
        else:
            tot = sum(checkpoint(_vocab_parallel_nll, plan,
                                 xn[:, i:i + chunk], labels[:, i:i + chunk],
                                 head, use_reentrant=False)
                      for i in range(0, s, chunk))
        data = ("dp", "sharding", "sep")
        return dmesh.psum(tot / (b * s * plan.mesh.axis_size(data)),
                          plan.mesh, data)
    if chunk <= 0 or s <= chunk or s % chunk:
        return _xent(_final_head(cfg, params, x), labels)
    xn, head = _norm_and_head(cfg, params, x)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        tot = tot + checkpoint(_chunk_logp_sum, xn[:, i:i + chunk],
                               labels[:, i:i + chunk], head,
                               use_reentrant=False)
    return -tot / (b * s)


def loss_fn(cfg: LlamaConfig, params, input_ids, labels, plan=None):
    """The mean next-token cross entropy (on a mesh: of the global batch,
    from this rank's shards of the parameters and the batch)."""
    if plan is not None or _xent_chunk_env() > 0:
        x = forward(cfg, params, input_ids, return_hidden=True, plan=plan)
        return head_xent(cfg, params, x, labels, plan)
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


def loss_and_grads(cfg: LlamaConfig, params, input_ids, labels, mesh=None,
                   sep_attn_impl="ring", num_microbatches=None):
    """(loss, gradients) of :func:`loss_fn` (:func:`value_and_grad`).

    On a ``mesh`` of more than one position: ``params`` and the batch are
    this rank's shards (:func:`param_specs`, :data:`DATA_SPEC`), the loss
    is the global one (the same on every rank), and the gradients are this
    rank's shards of the global gradients, summed over the axes
    :func:`_sync_axes` names (the first half of the reference's mesh
    train step).  With ``pp`` > 1 the loss is :func:`loss_fn_pp`'s over
    ``num_microbatches`` (default: pp) microbatches, GPipe's step."""
    if mesh is None or mesh.size == 1:
        return value_and_grad(lambda p: loss_fn(cfg, p, input_ids, labels),
                              params)
    plan = _mesh_plan(cfg, mesh, sep_attn_impl)
    if mesh.shape["pp"] > 1:
        M = num_microbatches or mesh.shape["pp"]
        fn = lambda p: loss_fn_pp(cfg, p, input_ids, labels, mesh, M,
                                  sep_attn_impl, plan=plan)
    else:
        fn = lambda p: loss_fn(cfg, p, input_ids, labels, plan)
    loss, grads = value_and_grad(fn, params)
    return loss, _sync_grads(cfg, plan, grads)


def _sync_grads(cfg: LlamaConfig, plan, grads) -> tuple:
    """Each gradient shard summed over its :func:`_sync_axes`, leaf by
    leaf in :func:`tree_leaves` order (the same order on every rank)."""
    return tuple(
        dmesh.all_reduce_(g.contiguous(), plan.mesh,
                          _sync_axes(plan, name, spec))
        for (name, spec), g in zip(named_specs(cfg, plan.specs), grads))


def _check_microbatches(mesh, b: int, M: int):
    """The reference's refusals of a pipeline's batch of ``b`` rows a
    rank: it asserts on the global batch and on a microbatch's rows over
    the batch axes."""
    K = mesh.axis_size(("dp", "sharding"))
    if (b * K) % M:
        raise AssertionError(f"batch {b * K} not divisible by "
                             f"num_microbatches {M}")
    batch_axes = tuple(a for a in ("dp", "sharding") if mesh.shape[a] > 1)
    if batch_axes and ((b * K) // M) % K:
        raise AssertionError(f"microbatch {(b * K) // M} not divisible by "
                             f"batch axes {batch_axes} product {K}")


def forward_pp(cfg: LlamaConfig, params, input_ids, mesh, num_microbatches,
               sep_attn_impl="ring", plan=None):
    """The pipeline-parallel forward (the reference's GPipe region): every
    stage embeds this rank's batch shard (``copy_to`` over ``pp``: the
    cotangent stage 0 sends back reaches every stage's embedding, the
    transpose of the reference's pp-replicated input), splits it into
    ``num_microbatches``, and :func:`gpipe_stacked` runs the stages.
    Returns the last stage's hidden states, whole on every stage."""
    from ..distributed.fleet.pipeline import gpipe_stacked

    plan = plan or _mesh_plan(cfg, mesh, sep_attn_impl)
    M = num_microbatches
    b, s = input_ids.shape
    _check_microbatches(mesh, b, M)
    x, cos, sin = _embed_rope(cfg, params, input_ids, plan)
    x = dmesh.copy_to(x, mesh, "pp")
    h = x.shape[-1]
    outs = gpipe_stacked(
        lambda xin: _run_layers(cfg, params["layers"], xin, cos, sin, plan),
        x.reshape(M, b // M, s, h), mesh, "pp")
    return outs.reshape(b, s, h)


def loss_fn_pp(cfg: LlamaConfig, params, input_ids, labels, mesh,
               num_microbatches, sep_attn_impl="ring", plan=None):
    """The global mean loss through :func:`forward_pp` (the chunked head
    under ``PADDLE_TPU_XENT_CHUNK``, as :func:`head_xent`)."""
    plan = plan or _mesh_plan(cfg, mesh, sep_attn_impl)
    x = forward_pp(cfg, params, input_ids, mesh, num_microbatches,
                   sep_attn_impl, plan=plan)
    return head_xent(cfg, params, x, labels, plan)


def _vpp_reorder(tree, mesh, C: int, inverse=False) -> dict:
    """The stacked leaves of ``tree`` (this rank's ``C * Lv`` rows a
    leaf) from the natural layer order over ``pp`` (rank ``r`` holds
    virtual stages ``r * C + j``) to the stage-major one (rank ``r``
    holds virtual stages ``c * P + r``, chunk ``c`` at rows ``c * Lv``),
    or back (``inverse``): each chunk that changes rank goes through
    :func:`~paddle_tpu_torch.distributed.mesh.exchange` (one call a leaf,
    the destination chunk its tag), the reference's in-step reshard."""
    P, r = mesh.shape["pp"], mesh.axis_index("pp")

    def home(v):        # rank, local chunk of virtual stage v in the source
        return (v % P, v // P) if inverse else (v // C, v % C)

    def dest(v):
        return (v // C, v % C) if inverse else (v % P, v // P)

    out = {}
    for name in sorted(tree):
        w = tree[name]
        pieces = w.reshape((C, w.shape[0] // C) + tuple(w.shape[1:]))
        new = torch.empty_like(pieces)
        sends, recvs, slots = [], [], []
        for v in range(P * C):
            (src, j), (dst, c) = home(v), dest(v)
            if src == r and dst == r:
                new[c] = pieces[j]
            elif src == r:
                sends.append((dst, pieces[j], c))
            elif dst == r:
                recvs.append((src, pieces[0], c))
                slots.append(c)
        for c, t in zip(slots, dmesh.exchange(mesh, "pp", sends, recvs)):
            new[c] = t
        out[name] = new.reshape(w.shape)
    return out


def loss_and_grads_1f1b(cfg: LlamaConfig, params, input_ids, labels, mesh,
                        num_microbatches, num_chunks=1, zero_bubble=False,
                        sep_attn_impl="ring"):
    """The pipeline step on the executed 1F1B clock
    (:func:`~paddle_tpu_torch.distributed.fleet.pipeline.one_f_one_b_stacked`):
    stage 0 owns the embedding, the last stage ``final_norm``, the head
    and the loss, one microbatch at a time.  ``num_chunks`` C > 1 is VPP:
    the state keeps the natural layer order, so the step moves the layer
    weights to the stage-major order over ``pp`` and their gradients back
    (:func:`_vpp_reorder`).  ``zero_bubble``: ZB-H1.  Returns (loss,
    gradients) as :func:`loss_and_grads`: this rank's shards, summed over
    :func:`_sync_axes` (the stage-owned leaves over ``pp`` too; a tied
    ``embed`` holds the embedding's and the head's gradients)."""
    from ..distributed.fleet.pipeline import one_f_one_b_stacked

    b, s = input_ids.shape
    M, C = num_microbatches, num_chunks
    _check_microbatches(mesh, b, M)
    P, L = mesh.shape["pp"], cfg.num_hidden_layers
    if L % (P * C):
        raise AssertionError((L, P, C))
    plan = _mesh_plan(cfg, mesh, sep_attn_impl, pp_owned=True)
    tied = "lm_head" not in params
    cos, sin = _rope(cfg, s, plan, input_ids.device)
    stacked = params["layers"]
    if C > 1:
        with torch.no_grad():
            stacked = _vpp_reorder(stacked, mesh, C)
    head = "embed" if tied else "lm_head"
    act = torch.empty((b // M, s, cfg.hidden_size), dtype=cfg.dtype,
                      device=input_ids.device)
    loss, dep, dsp, dhp = one_f_one_b_stacked(
        lambda ep, ids: _embed(cfg, ep, ids, plan),
        lambda sp, x, c: _run_layers(cfg, sp, x, cos, sin, plan),
        lambda hp, y, lbl: head_xent(cfg, hp, y, lbl, plan),
        {"embed": params["embed"]}, stacked,
        {"final_norm": params["final_norm"], head: params[head]},
        list(input_ids.reshape(M, b // M, s)),
        list(labels.reshape(M, b // M, s)), mesh, act,
        num_chunks=C, zero_bubble=zero_bubble,
        seq_axis="sep" if mesh.shape["sep"] > 1 else None)

    def whole(acc, p):      # this stage's f32 sum, or zeros, in p's dtype
        return (torch.zeros_like(p) if acc is None
                else acc.to(p.dtype))

    layers = {n: g.to(params["layers"][n].dtype) for n, g in dsp.items()}
    if C > 1:
        layers = _vpp_reorder(layers, mesh, C, inverse=True)
    embed = whole(dep["embed"], params["embed"])
    if tied and dhp["embed"] is not None:
        embed = embed + dhp["embed"].to(embed.dtype)
    grads = {"embed": embed, "layers": layers,
             "final_norm": whole(dhp["final_norm"], params["final_norm"])}
    if not tied:
        grads["lm_head"] = whole(dhp["lm_head"], params["lm_head"])
    return loss, _sync_grads(cfg, plan, tree_leaves(grads))


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
                 grad_clip, norm=global_norm) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """The reference's AdamW update, IN PLACE on the parameter leaves and
    ``opt_state``'s ``m`` / ``v`` / ``master`` (all in :func:`tree_leaves`
    order): the f32 global-norm clip ``scale = min(1, clip / max(gnorm,
    1e-6))``, bias corrections from an f32 step, decoupled decay, the f32
    master cast back to each parameter's dtype.  Returns (step, gnorm);
    the caller stores them.  Elementwise, so on a mesh it runs as it is on
    each rank's shards; ``norm(grads)`` gives the clipping norm (a mesh's:
    :func:`_mesh_global_norm`)."""
    gnorm = norm(grads)
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
                     grad_clip, keep_gnorm=True, norm=global_norm):
    """(train_step, opt_init) around ``loss_and_grads_fn(params, *batch)
    -> (loss, grads)``: ``train_step(params, opt_state, *batch) -> (loss,
    params, opt_state)`` runs it, then :func:`adamw_update`, updating the
    parameter and optimizer tensors IN PLACE (the reference donates them)
    and returning the same dicts; the state keeps ``gnorm`` when
    ``keep_gnorm`` (the reference's LM train steps do, its DiT's not);
    ``norm`` as :func:`adamw_update`'s."""

    def train_step(params, opt_state, *batch):
        loss, grads = loss_and_grads_fn(params, *batch)
        step, gnorm = adamw_update(tree_leaves(params), grads, opt_state, lr,
                                   weight_decay, beta1, beta2, grad_clip,
                                   norm=norm)
        opt_state["step"] = step
        if keep_gnorm:
            opt_state["gnorm"] = gnorm
        return loss, params, opt_state

    return train_step, lambda params: adamw_init(params, keep_gnorm)


def build_train_step(cfg: LlamaConfig, mesh=None, lr=3e-4, weight_decay=0.1,
                     beta1=0.9, beta2=0.95, grad_clip=1.0,
                     num_microbatches=None, sep_attn_impl="ring",
                     pipeline_schedule=None, num_chunks=None):
    """The reference's ``build_train_step``.

    ``mesh=None``: (train_step, opt_init) for one device, the reference's
    step on a 1-device mesh: ``train_step(params, opt_state, input_ids,
    labels) -> (loss, new_params, new_opt)``, :func:`loss_and_grads` then
    AdamW (:func:`adamw_train_step`); gnorm is reckoned leaf by leaf, so
    no f32 copy of all the gradients exists at once.

    With a ``mesh`` (:func:`make_mesh`): (train_step, opt_init,
    param_specs, data_spec), the same step on this rank's shards of the
    parameters, the optimizer state (``opt_init`` of the parameter
    shards: ``m`` / ``v`` / ``master`` follow the parameters' specs,
    ``step`` and ``gnorm`` are whole) and the batch (``data_spec``, the
    reference's ``P(("dp", "sharding"), "sep")``), with the mesh's
    collectives (:func:`loss_and_grads`) and the sharded clipping norm; on
    a one-position mesh, the one-device step.  ``sep_attn_impl`` picks
    ring or Ulysses attention when ``sep`` > 1.

    With ``pp`` > 1 the layers are staged over it (``param_specs(pp=
    True)``) and run ``num_microbatches`` (default: pp) microbatches on
    ``pipeline_schedule``: None, '1f1b' and 'eager_1f1b' the executed 1F1B
    clock (:func:`loss_and_grads_1f1b`), 'vpp' / 'interleave' the same
    with ``num_chunks`` (default 2) chunks a stage, 'zb' / 'zero_bubble'
    ZB-H1, 'gpipe' / 'fthenb' GPipe through autograd
    (:func:`loss_fn_pp`).  A schedule the mesh cannot run raises the
    reference's error."""
    if mesh is None:
        return adamw_train_step(
            lambda params, ids, labels: loss_and_grads(cfg, params, ids,
                                                       labels),
            lr, weight_decay, beta1, beta2, grad_clip)
    pp = mesh.shape["pp"]
    if pp > 1:
        if cfg.num_hidden_layers % pp:
            raise AssertionError(f"{cfg.num_hidden_layers} layers not "
                                 f"divisible by pp={pp}")
        num_microbatches = num_microbatches or pp
    schedule = "1f1b" if pipeline_schedule is None else pipeline_schedule
    known = ("1f1b", "eager_1f1b", "vpp", "interleave", "zb", "zero_bubble",
             "gpipe", "fthenb")
    if schedule not in known:
        raise ValueError(f"unknown pipeline_schedule {schedule!r} "
                         f"(expected one of {known})")
    use_1f1b = pp > 1 and schedule in (
        "1f1b", "eager_1f1b", "vpp", "interleave", "zb", "zero_bubble")
    if pipeline_schedule is not None and pp <= 1:
        raise ValueError(f"pipeline_schedule={pipeline_schedule!r} needs a "
                         f"mesh with pp > 1 (got pp={pp})")
    if num_chunks is not None and num_chunks > 1 and schedule not in (
            "vpp", "interleave"):
        raise ValueError(f"num_chunks={num_chunks} requires pipeline_schedule"
                         f"='vpp'/'interleave', got {schedule!r}")
    chunks = (num_chunks or 2) if schedule in ("vpp", "interleave") else 1
    zb = schedule in ("zb", "zero_bubble")
    specs = param_specs(cfg, pp=pp > 1, mp=mesh.shape["mp"])
    if mesh.size == 1:
        step, opt_init = build_train_step(cfg, lr=lr,
                                          weight_decay=weight_decay,
                                          beta1=beta1, beta2=beta2,
                                          grad_clip=grad_clip)
        return step, opt_init, specs, DATA_SPEC
    plan = _mesh_plan(cfg, mesh, sep_attn_impl)
    if use_1f1b:
        fn = lambda params, ids, labels: loss_and_grads_1f1b(
            cfg, params, ids, labels, mesh, num_microbatches,
            num_chunks=chunks, zero_bubble=zb, sep_attn_impl=sep_attn_impl)
    else:
        fn = lambda params, ids, labels: loss_and_grads(
            cfg, params, ids, labels, mesh, sep_attn_impl, num_microbatches)
    step, opt_init = adamw_train_step(
        fn, lr, weight_decay, beta1, beta2, grad_clip,
        norm=lambda grads: _mesh_global_norm(cfg, plan, grads))
    return step, opt_init, specs, DATA_SPEC


# ---------------------------------------------------------------------------
# the training mesh: specs, the per-rank plan, gradient sync, the norm
# ---------------------------------------------------------------------------

#: the batch's spec: rows over dp x sharding, the sequence over sep
DATA_SPEC = (("dp", "sharding"), "sep")
#: the axes that split the batch
_DATA_AXES = ("dp", "sharding", "sep")
#: the leaves the 1F1B clock's first (embed) and last (head) stage own
_PP_OWNED = ("embed", "lm_head", "final_norm")


def param_specs(cfg: LlamaConfig, pp: bool = False, mp: int = 1) -> dict:
    """The reference's partition specs of the parameter tree, as tuples
    (one entry a dim: None, or the mesh axis splitting it): the Megatron
    splits over ``mp`` (:data:`MEGATRON_SPLIT`; ``wk`` / ``wv`` replicated
    when ``mp`` does not divide the kv heads), ZeRO over ``sharding`` on
    the other dim of each matrix, the vocab-parallel ``embed`` and
    ``lm_head``, replicated norms.  As the reference's, it lists
    ``lm_head`` for a tied tree too (the port skips keys the tree lacks).
    ``pp=True``: the stacked layer dim over 'pp', each stage's contiguous
    slice of the layers."""
    layer_dim = "pp" if pp else None
    kv_col = None if cfg.num_key_value_heads % mp else "mp"

    def mat(name):
        tensor = kv_col if name in ("wk", "wv") else "mp"
        if MEGATRON_SPLIT[name] == "col":
            return (layer_dim, "sharding", tensor)
        return (layer_dim, tensor, "sharding")

    return {"embed": ("mp", "sharding"), "final_norm": (None,),
            "layers": {"input_norm": (layer_dim, None),
                       "post_norm": (layer_dim, None),
                       **{name: mat(name) for name in MEGATRON_SPLIT}},
            "lm_head": ("sharding", "mp")}


def make_mesh(dp=1, mp=1, sharding=1, sep=1, pp=1) -> dmesh.Mesh:
    """The hybrid mesh over the initialised default process group (one
    rank a position, :class:`~paddle_tpu_torch.distributed.mesh.Mesh`,
    laid out as the reference's ``devices.reshape(dp, pp, sharding, sep,
    mp)``); a world size other than ``dp * mp * sharding * sep * pp``
    raises ``ValueError``.  Without a process group a one-position mesh is
    the single-device one."""
    return dmesh.Mesh(dp=dp, pp=pp, sharding=sharding, sep=sep, mp=mp)


def sep_attention(mesh, axis: str = "sep", impl: str = "ring"):
    """Context-parallel attention over ``mesh``'s sequence axis: an
    ``attn_fn(q, k, v)`` (BSHD, this rank's sequence shard) running
    Ulysses (``impl='ulysses'``) or ring attention (any other)."""
    from ..ops import ring_attention as ra

    def attn_fn(q, k, v):
        if impl == "ulysses":
            return ra.ulysses_attention(q, k, v, mesh, axis, causal=True)
        return ra.ring_attention(q, k, v, mesh, axis, causal=True)

    return attn_fn


def _kv_heads(cfg: LlamaConfig, mp: int, rank: int):
    """(first, count) of the kv heads the q heads of ``mp`` rank ``rank``
    read when ``wk`` / ``wv`` are replicated over ``mp`` (``mp`` does not
    divide the kv heads); None when they split.  The rank's q heads must
    read their kv heads in flash attention's GQA order."""
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if nh % mp:
        raise ValueError(f"mp={mp} does not divide {nh} attention heads")
    if nkv % mp == 0:
        return None
    group, local = nh // nkv, nh // mp
    first = rank * local // group
    count = ((rank + 1) * local - 1) // group - first + 1
    if local % count or any((rank * local + i) // group - first
                            != i // (local // count) for i in range(local)):
        raise ValueError(f"mp={mp}: a rank's {local} q heads do not read "
                         f"their kv heads in GQA order ({nh} / {nkv} heads)")
    return first, count


def _mesh_plan(cfg: LlamaConfig, mesh, sep_attn_impl="ring",
               pp_owned=False):
    """What one rank's step reads besides its shards: the mesh, the specs
    (the layers over ``pp`` when it is > 1), the kv heads of its q heads
    (:func:`_kv_heads`), the sequence-parallel attention (None without
    ``sep``), and whether the stage-owned leaves (:data:`_PP_OWNED`) have
    their gradients on one stage only (the 1F1B clock: summed over
    ``pp``)."""
    return types.SimpleNamespace(
        mesh=mesh, pp_owned=pp_owned,
        specs=param_specs(cfg, pp=mesh.shape["pp"] > 1,
                          mp=mesh.shape["mp"]),
        kv=_kv_heads(cfg, mesh.shape["mp"], mesh.coords["mp"]),
        attn_fn=(sep_attention(mesh, "sep", sep_attn_impl)
                 if mesh.shape["sep"] > 1 else None))


def _zero_gather(plan, t, spec):
    """Leaf ``t`` whole over ``sharding`` (ZeRO): the dim ``spec`` splits
    over it all-gathered, so its gradient is reduce-scattered back."""
    if "sharding" in spec:
        return dmesh.all_gather(t, plan.mesh, "sharding",
                                spec.index("sharding"))
    return t


def named_specs(cfg: LlamaConfig, specs) -> list:
    """(name, spec) of every leaf of the parameter tree, in
    :func:`tree_leaves` order (``lm_head`` only when untied)."""
    out = []
    for k in sorted(specs):
        if k == "lm_head" and cfg.tie_word_embeddings:
            continue
        if isinstance(specs[k], dict):
            out += [(f"{k}/{n}", specs[k][n]) for n in sorted(specs[k])]
        else:
            out.append((k, specs[k]))
    return out


def _sync_axes(plan, name: str, spec) -> tuple:
    """The axes a leaf's gradient is summed over after the backward: each
    batch axis (dp, sharding, sep) it is not split on (its ranks saw other
    data; a leaf split over ``sharding`` got that sum from its ZeRO
    reduce-scatter), ``mp`` for the replicated K/V, whose every rank
    computed the gradient of its own kv heads only, and ``pp`` for the
    stage-owned leaves of the 1F1B clock (``plan.pp_owned``).  A
    replicated leaf that feeds a ``copy_to`` (the norms) has its whole
    gradient on every ``mp`` rank already; under GPipe every stage runs
    the head and, through ``forward_pp``'s ``copy_to``, the embedding's
    backward, so their gradients are whole on every ``pp`` rank too."""
    split = dmesh.spec_axes(spec)
    axes = [a for a in _DATA_AXES if a not in split]
    if plan.kv is not None and name in ("layers/wk", "layers/wv"):
        axes.append("mp")
    if plan.pp_owned and name in _PP_OWNED:
        axes.append("pp")
    return tuple(a for a in dmesh.AXES if a in axes)


def _mesh_global_norm(cfg: LlamaConfig, plan, grads) -> torch.Tensor:
    """The global f32 norm of the sharded gradients: each leaf's sum of
    squares, those of the leaves split over the same axes summed over
    those axes (never over the axes a leaf is replicated on), then all of
    it in one fixed order, so every rank gets the same bits."""
    mesh, parts = plan.mesh, {}
    for (_, spec), g in zip(named_specs(cfg, plan.specs), grads):
        gf = g.float()
        axes = tuple(a for a in dmesh.AXES if a in dmesh.spec_axes(spec)
                     and mesh.shape[a] > 1)
        parts[axes] = parts.get(axes, 0) + (gf * gf).sum()
    total = 0
    for axes, v in parts.items():
        total = total + dmesh.all_reduce_(v, mesh, axes)
    return torch.sqrt(total)


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
