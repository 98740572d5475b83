"""MoE decoder LM (counterpart of ``paddle_tpu/models/moe_llama.py``).

DeepSeekMoE / Qwen2-MoE structure: each layer is Llama's attention half
followed by ``num_shared_experts`` always-on shared experts (one SwiGLU
block of width ``intermediate_size * num_shared_experts``) plus ``E``
routed experts under top-k token-choice gating, with the Switch
load-balance loss and the router z-loss.  The parameter dict has the
reference's layout: layer weights stacked ``[L, ...]``, routed experts
``[L, E, h, mi]`` / ``[L, E, mi, h]``, the ``router`` leaf in f32 in a
tree of ``cfg.dtype``.

Three dispatch engines behind one routing front end (:func:`moe_ffn`),
the reference's:

- ``dense``: the GShard one-hot formulation, capacity-bounded dispatch
  and combine tensors ``[g, E, C]`` and their einsums;
- ``sort``: a stable sort of the (token, k) pairs by expert, a scatter
  into an ``[E * C, h]`` buffer, the expert products, a gather and an
  ``index_add`` back; the same queue order and capacity drops as
  ``dense``;
- ``ragged``: DROPLESS; the reference's ``lax.ragged_dot`` becomes one
  product per expert over its contiguous group, the group sizes read to
  the host once a layer (and again in a recomputed forward).  Opt-in,
  never chosen by ``"auto"``.

The scatter, gather and einsums are XLA ops in the reference (no Pallas
kernel), so they are ordinary torch ops here.  The TPU kernels this path
runs are the port's: ``rms_norm`` (B1) twice a layer and once at the end,
and causal flash attention (B2-B4).

How the reference's JAX mechanisms map here: the layer ``lax.scan``
under ``jax.checkpoint`` is a Python loop over the ``unbind``-ed stacked
weights, each block under ``torch.utils.checkpoint`` (non-reentrant) when
``remat``, carrying ``(x, aux, z)``; ``jax.value_and_grad`` is
``torch.autograd.grad``; the jitted, donated train step updates the
parameters and optimizer state in place (``llama.adamw_train_step``).

Not ported yet: ``param_specs``, ``serving_param_specs`` and
``make_mesh`` (JAX mesh layouts with no single-card consumer) and the
expert-parallel dispatch collectives (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import flash_attention as fa
from ..ops.kernels import rms_norm as rms
from ..ops.kernels import rope as rope_mod
from ..ops.kernels import swiglu as swiglu_mod
from . import llama


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 4096       # shared-expert (dense) ffn width
    moe_intermediate_size: int = 1024   # per-routed-expert ffn width
    num_hidden_layers: int = 12
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    num_experts: int = 8
    num_shared_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    # 'dense' | 'sort' | 'ragged' | 'auto' (sort from
    # _SORT_DISPATCH_MIN_EXPERTS experts on, else dense)
    dispatch: str = "auto"
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def deepseek_moe_16b():
        """DeepSeekMoE-16B structure: 64 routed + 2 shared experts (shared
        width 2 x 1408 = 2816), top-6; 'auto' dispatch resolves to sort."""
        return MoEConfig(
            vocab_size=102400, hidden_size=2048, intermediate_size=1408,
            moe_intermediate_size=1408, num_hidden_layers=28,
            num_attention_heads=16, num_key_value_heads=16,
            num_experts=64, num_shared_experts=2, top_k=6,
        )

    @staticmethod
    def qwen2_moe_a14b():
        """Qwen2-57B-A14B structure: 64 routed + a shared block of width
        8 x 2560 = 20480, top-8."""
        return MoEConfig(
            vocab_size=151936, hidden_size=3584, intermediate_size=2560,
            moe_intermediate_size=2560, num_hidden_layers=28,
            num_attention_heads=28, num_key_value_heads=4,
            num_experts=64, num_shared_experts=8, top_k=8,
        )

    @staticmethod
    def tiny(vocab=256, hidden=64, layers=2, heads=4, kv_heads=2,
             experts=4, top_k=2, inter=128, moe_inter=64):
        return MoEConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            moe_intermediate_size=moe_inter, num_hidden_layers=layers,
            num_attention_heads=heads, num_key_value_heads=kv_heads,
            num_experts=experts, top_k=top_k, max_position_embeddings=256,
        )


def init_params(cfg: MoEConfig, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> dict:
    """Parameter dict with the reference's shapes: normal(0, 0.02) matmul,
    embedding and router weights, unit norms, drawn in f32 from
    ``generator`` (or one seeded with ``seed`` on ``device``) and cast to
    ``cfg.dtype``, except the router, which stays f32.  The numbers differ
    from ``jax.random``'s; parity tests bridge a tree instead
    (utils/convert.py)."""
    from .. import resolve_device

    dev = resolve_device(device) if generator is None else generator.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, i, mi, v = (cfg.hidden_size, cfg.intermediate_size,
                   cfg.moe_intermediate_size, cfg.vocab_size)
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    L, E, S = cfg.num_hidden_layers, cfg.num_experts, cfg.num_shared_experts

    def init(shape, dtype=cfg.dtype):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(0.02).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": init((v, h)),
        "final_norm": ones((h,)),
        "lm_head": init((h, v)),
        "layers": {
            "input_norm": ones((L, h)),
            "post_norm": ones((L, h)),
            "wq": init((L, h, nh * hd)),
            "wk": init((L, h, nkv * hd)),
            "wv": init((L, h, nkv * hd)),
            "wo": init((L, nh * hd, h)),
            "s_gate": init((L, h, i * S)),
            "s_up": init((L, h, i * S)),
            "s_down": init((L, i * S, h)),
            "router": init((L, h, E), torch.float32),
            "e_gate": init((L, E, h, mi)),
            "e_up": init((L, E, h, mi)),
            "e_down": init((L, E, mi, h)),
        },
    }


#: 'auto' dispatch takes the sort engine from this many experts on
_SORT_DISPATCH_MIN_EXPERTS = 9


def resolved_dispatch(cfg: MoEConfig) -> str:
    """The dispatch engine a config actually runs: 'dense'|'sort'|'ragged'."""
    mode = cfg.dispatch
    if mode == "auto":
        mode = ("sort" if cfg.num_experts >= _SORT_DISPATCH_MIN_EXPERTS
                else "dense")
    if mode not in ("dense", "sort", "ragged"):
        raise ValueError(
            f"MoEConfig.dispatch must be 'auto'|'dense'|'sort'|'ragged', "
            f"got {cfg.dispatch!r}")
    return mode


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Slots an expert's queue holds: ``max(ceil(capacity_factor * K * g /
    E), 1)``, from shapes alone, as the reference reckons it."""
    return max(int(math.ceil(cfg.capacity_factor * cfg.top_k * tokens
                             / cfg.num_experts)), 1)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, ties to the lower index (a stable descending sort;
    ``torch.topk`` does not order ties)."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return probs.gather(-1, idx), idx


def route(cfg: MoEConfig, xf: torch.Tensor, router: torch.Tensor):
    """The routing front end on ``xf`` [g, h]: (probs [g, E] f32, the
    renormalised top-k weights and their experts [g, K], aux, z)."""
    E = cfg.num_experts
    logits = xf.float() @ router                               # [g, E]
    probs = torch.softmax(logits, dim=-1)
    # z-loss: keeps router logits small (numerics at scale)
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    topk_p, topk_i = top_k(probs, cfg.top_k)
    topk_p = topk_p / torch.clamp(topk_p.sum(-1, keepdim=True), min=1e-9)
    # aux load-balance loss (Switch: E * sum_e f_e * P_e) on the first pick
    frac_tokens = F.one_hot(topk_i[:, 0], E).float().mean(0)
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum()
    return probs, topk_p, topk_i, aux, z_loss


def moe_ffn(cfg: MoEConfig, x: torch.Tensor, lp: dict):
    """Routed-expert FFN for x [b, s, h] -> (out, aux_loss, z_loss), by
    the engine :func:`resolved_dispatch` names."""
    b, s, h = x.shape
    xf = x.reshape(b * s, h)
    _, topk_p, topk_i, aux, z_loss = route(cfg, xf, lp["router"])
    cap = capacity(cfg, b * s)
    engine = {"sort": _dispatch_sort, "ragged": _dispatch_ragged,
              "dense": _dispatch_dense}[resolved_dispatch(cfg)]
    out = engine(cfg, xf, lp, topk_p, topk_i, cap)
    return out.reshape(b, s, h), aux, z_loss


def _expert_compute(lp, expert_in):
    """Per-expert SwiGLU FFN on stacked batches [E, C, h] -> [E, C, h]."""
    gate = torch.bmm(expert_in, lp["e_gate"])
    up = torch.bmm(expert_in, lp["e_up"])
    return torch.bmm(swiglu_mod.swiglu(gate, up), lp["e_down"])


def _queue_positions(topk_i: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, k) pair's place in its expert's queue, counted in
    row-major (token, k) order (the dense engine's cumsum)."""
    g, K = topk_i.shape
    flat = F.one_hot(topk_i.reshape(g * K), E)                 # [g*K, E]
    pos = torch.cumsum(flat, dim=0) - flat                     # slots before
    return (pos * flat).sum(-1).reshape(g, K)


def _dispatch_dense(cfg, xf, lp, topk_p, topk_i, cap):
    E = cfg.num_experts
    pos = _queue_positions(topk_i, E)
    keep = pos < cap                                           # drop overflow
    slots = torch.arange(cap, device=xf.device)
    experts = torch.arange(E, device=xf.device)
    oh_e = (topk_i[..., None] == experts).to(xf.dtype)         # [g, K, E]
    oh_c = ((pos[..., None] == slots) & keep[..., None]).to(xf.dtype)
    combine = torch.einsum("gke,gkc,gk->gec", oh_e, oh_c,
                           topk_p.to(xf.dtype))
    dispatch = torch.einsum("gke,gkc->gec", oh_e, oh_c)
    expert_in = torch.einsum("gec,gh->ech", dispatch, xf)      # [E, C, h]
    expert_out = _expert_compute(lp, expert_in)
    return torch.einsum("gec,ech->gh", combine, expert_out)


def _sorted_pairs(topk_i: torch.Tensor, E: int):
    """The (token, k) pairs stably sorted by expert: (order, expert of
    each sorted pair, per-expert counts)."""
    flat_e = topk_i.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    counts = torch.bincount(flat_e, minlength=E)
    return order, flat_e[order], counts


def _dispatch_sort(cfg, xf, lp, topk_p, topk_i, cap):
    g, h = xf.shape
    E, K = cfg.num_experts, cfg.top_k
    N = g * K
    order, sorted_e, counts = _sorted_pairs(topk_i, E)
    # the stable order keeps row-major (token, k) order within an expert:
    # the dense engine's queue positions and capacity drops exactly
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(N, device=xf.device) - starts[sorted_e]
    keep = pos_sorted < cap
    slot = sorted_e * cap + pos_sorted                         # [N]
    tok = order // K
    # dropped pairs write the buffer's extra last row, which no expert
    # reads, so their gradient is zero; kept slots are unique
    buf = xf.new_zeros((E * cap + 1, h)).index_copy(
        0, torch.where(keep, slot, E * cap), xf[tok])
    expert_out = _expert_compute(lp, buf[:E * cap].view(E, cap, h))
    gathered = expert_out.reshape(E * cap, h)[torch.where(keep, slot, 0)]
    gathered = gathered * keep[:, None].to(xf.dtype)
    w = topk_p.reshape(N)[order].to(xf.dtype)
    return xf.new_zeros((g, h)).index_add(0, tok, gathered * w[:, None])


def _dispatch_ragged(cfg, xf, lp, topk_p, topk_i, cap):
    """DROPLESS: the pairs grouped by expert, one product per expert over
    its group (the reference's three ``lax.ragged_dot``), no capacity and
    no padding; ``cap`` is ignored.  Equal to dense / sort where they drop
    nothing."""
    g, h = xf.shape
    E, K = cfg.num_experts, cfg.top_k
    order, _, counts = _sorted_pairs(topk_i, E)
    tok = order // K
    groups = xf[tok].split(counts.tolist())     # the one host read a layer
    out = []
    for e, xs in enumerate(groups):
        if xs.shape[0]:
            act = swiglu_mod.swiglu(xs @ lp["e_gate"][e], xs @ lp["e_up"][e])
            out.append(act @ lp["e_down"][e])
    out_s = torch.cat(out) if out else xf.new_zeros((0, h))
    w = topk_p.reshape(g * K)[order].to(xf.dtype)
    return xf.new_zeros((g, h)).index_add(0, tok, out_s * w[:, None])


def _layer_forward(cfg: MoEConfig, x, lp, cos, sin, use_flash=True):
    b, s, h = x.shape
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    xn = rms.rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = (xn @ lp["wq"]).reshape(b, s, nh, hd)
    kk = (xn @ lp["wk"]).reshape(b, s, nkv, hd)
    vv = (xn @ lp["wv"]).reshape(b, s, nkv, hd)
    q, kk = rope_mod.apply_rotary_pos_emb(q, kk, cos, sin)
    if use_flash:
        attn = fa.flash_attention_bshd(q, kk, vv, causal=True)
    else:
        attn = fa._composed_attention(q, kk, vv, None, True,
                                      1.0 / math.sqrt(hd))
    # the attention output projection + residual: llama's decoder half,
    # shared as in the reference
    x = llama.decoder_attn_residual(x, attn.reshape(b, s, nh * hd), lp)
    xn = rms.rms_norm(x, lp["post_norm"], cfg.rms_norm_eps)
    shared = swiglu_mod.swiglu(xn @ lp["s_gate"], xn @ lp["s_up"]) \
        @ lp["s_down"]
    routed, aux, z = moe_ffn(cfg, xn, lp)
    return x + shared + routed, aux, z


def forward(cfg: MoEConfig, params, input_ids, use_flash=True, remat=True,
            return_aux=False):
    """Logits [b, s, V] for [b, s] token ids (``return_aux``: with the
    layer-mean aux and z losses).  ``remat`` recomputes each block in the
    backward (the reference's ``jax.checkpoint`` over the scan body)."""
    x, cos, sin = llama._embed_rope(cfg, params, input_ids)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, aux, z, lp):
        x2, a, zz = _layer_forward(cfg, x, lp, cos, sin, use_flash)
        return x2, aux + a, z + zz

    layer = ((lambda *a: checkpoint(body, *a, use_reentrant=False))
             if remat else body)
    names = list(params["layers"])
    aux = z = zero
    for leaves in zip(*(params["layers"][n].unbind(0) for n in names)):
        x, aux, z = layer(x, aux, z, dict(zip(names, leaves)))
    x = rms.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = x @ params["lm_head"]
    if return_aux:
        L = cfg.num_hidden_layers
        return logits, aux / L, z / L
    return logits


def loss_fn(cfg: MoEConfig, params, input_ids, labels):
    """``ce + aux_loss_weight * aux + z_loss_weight * z``."""
    logits, aux, z = forward(cfg, params, input_ids, return_aux=True)
    ce = llama._xent(logits, labels)
    return ce + cfg.aux_loss_weight * aux + cfg.z_loss_weight * z


def loss_and_grads(cfg: MoEConfig, params, input_ids, labels):
    """(loss, gradients) of :func:`loss_fn` (``llama.value_and_grad``)."""
    return llama.value_and_grad(
        lambda p: loss_fn(cfg, p, input_ids, labels), params)


def build_train_step(cfg: MoEConfig, lr=3e-4, weight_decay=0.1, beta1=0.9,
                     beta2=0.95, grad_clip=1.0):
    """(train_step, opt_init) for one device, the reference's
    ``build_train_step`` on a 1-device mesh: the MoE loss, then the
    reference's AdamW (``llama.adamw_train_step``), parameters and state
    ``{step, m, v, master, gnorm}`` updated in place."""
    return llama.adamw_train_step(
        lambda params, ids, labels: loss_and_grads(cfg, params, ids, labels),
        lr, weight_decay, beta1, beta2, grad_clip)


def count_params(params) -> int:
    return llama.count_params(params)


def active_params_per_token(cfg: MoEConfig) -> int:
    """Active (per-token) parameter count — the MoE MFU denominator."""
    h, i, mi = cfg.hidden_size, cfg.intermediate_size, cfg.moe_intermediate_size
    nh, nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    per_layer = (h * nh * hd + 2 * h * nkv * hd + nh * hd * h
                 + 3 * h * i * cfg.num_shared_experts
                 + 3 * h * mi * cfg.top_k + h * cfg.num_experts)
    return cfg.num_hidden_layers * per_layer + 2 * cfg.vocab_size * h


def flops_per_token(cfg: MoEConfig, seq: int) -> float:
    """Training FLOPs a token for MFU: 6 x :func:`active_params_per_token`
    plus the causal attention term of ``llama.attn_flops_per_token``."""
    return (6.0 * active_params_per_token(cfg)
            + llama.attn_flops_per_token(cfg, seq))
