"""Diffusion Transformer (counterpart of ``paddle_tpu/models/dit.py``).

DiT-XL/2 style: a patchify projection to tokens; a sinusoidal timestep
embedding through a two-layer MLP plus a label embedding (with a null
class for classifier-free guidance) give the conditioning vector ``c``;
``depth`` blocks of adaLN-Zero attention and MLP modulated by ``c``; a
final adaLN and linear layer, unpatchified.  Trained with the reference's
rectified-flow loss: ``x_t = (1 - t) x0 + t eps``, the model's output
against the velocity ``eps - x0``.

The parameter dict has the reference's layout (block weights stacked
``[depth, ...]``; the adaLN modulation and the final layer zero at init,
so a fresh model outputs 0 and its blocks get no gradient at the first
step).  The loss draws its timesteps, noise and label dropout with
``utils/threefry`` from a ``[2]`` key split in 3, the bits of the
reference's ``jax.random`` calls.

The one TPU kernel on this path is flash attention (B2-B4), non-causal;
at DiT-XL/2's head_dim 72 the card runs its CUDA-core route
(``flash_attention.flash_route``).  Layer norm, GELU and the modulation
are XLA ops in the reference, plain torch ops here.

Not ported yet: ``param_specs`` and ``make_mesh`` (JAX mesh layouts with
no single-card consumer; ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import flash_attention as fa
from ..ops.kernels import rope as rope_mod
from ..utils import threefry
from . import llama


@dataclasses.dataclass
class DiTConfig:
    image_size: int = 32          # latent spatial size (SD3 latents: 32x32)
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    learn_sigma: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def out_channels(self):
        return self.in_channels * (2 if self.learn_sigma else 1)

    @staticmethod
    def dit_xl_2():
        return DiTConfig(hidden_size=1152, depth=28, num_heads=16)

    @staticmethod
    def tiny(image=8, patch=2, channels=4, hidden=64, depth=2, heads=4,
             classes=10):
        return DiTConfig(image_size=image, patch_size=patch,
                         in_channels=channels, hidden_size=hidden,
                         depth=depth, num_heads=heads, num_classes=classes)


#: the Cephes float32 exp: log2(e), ln 2 split in two, the polynomial
_LOG2E, _LN2_HI, _LN2_LO = 1.44269504088896341, 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as the reference's compiled CPU programs compute it
    (the Cephes polynomial, the range reduction and every polynomial step
    an FMA): bit-equal to XLA's on 2^20 draws in [-20, 20], where
    ``torch.exp`` parts by one ulp on ~10% of them.  A timestep up to 999
    multiplies that ulp into its embedding's argument."""
    fma = rope_mod.fma_f32
    fx = torch.floor(x * _LOG2E + 0.5)
    xr = fma(fx, torch.full_like(x, -_LN2_HI), x)
    xr = fma(fx, torch.full_like(x, -_LN2_LO), xr)
    y = torch.full_like(x, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = fma(y, xr, torch.full_like(x, c))
    y = fma(y, xr * xr, xr) + 1.0
    return torch.ldexp(y, fx.to(torch.int32))


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal timestep embedding [b, dim] (f32); t: [b] in [0, 1000)."""
    half = dim // 2
    freqs = _exp_f32(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32,
                                    device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def init_params(cfg: DiTConfig, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> dict:
    """Parameter dict with the reference's shapes: normal(0, 0.02)
    projections and embeddings, zero biases, and the adaLN-Zero leaves
    (``mod_w`` / ``mod_b`` / ``final_*``) zero; drawn in f32 from
    ``generator`` (or one seeded with ``seed`` on ``device``), cast to
    ``cfg.dtype``."""
    from .. import resolve_device

    dev = resolve_device(device) if generator is None else generator.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    h, d = cfg.hidden_size, cfg.depth
    p, c = cfg.patch_size, cfg.in_channels
    mlp = int(h * cfg.mlp_ratio)
    out = p * p * cfg.out_channels

    def init(shape):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(0.02).to(cfg.dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    return {
        "patch_w": init((p * p * c, h)),
        "patch_b": zeros((h,)),
        "pos_embed": init((cfg.num_patches, h)),
        "t_mlp1": init((256, h)),
        "t_mlp1_b": zeros((h,)),
        "t_mlp2": init((h, h)),
        "t_mlp2_b": zeros((h,)),
        # +1 class for the classifier-free-guidance null token
        "label_embed": init((cfg.num_classes + 1, h)),
        "blocks": {
            "mod_w": zeros((d, h, 6 * h)),
            "mod_b": zeros((d, 6 * h)),
            "wqkv": init((d, h, 3 * h)),
            "wo": init((d, h, h)),
            "mlp1": init((d, h, mlp)),
            "mlp1_b": zeros((d, mlp)),
            "mlp2": init((d, mlp, h)),
            "mlp2_b": zeros((d, h)),
        },
        "final_mod_w": zeros((h, 2 * h)),
        "final_mod_b": zeros((2 * h,)),
        "final_w": zeros((h, out)),
        "final_b": zeros((out,)),
    }


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _layer_norm(x, eps=1e-6):
    """Layer norm without affine in f32, the population variance (the
    reference's ``jnp.var``: the mean of squared deviations)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def _block_forward(cfg: DiTConfig, x, c, bp):
    """One DiT block with adaLN-Zero; x [b, n, h], c [b, h]."""
    b, n, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    mod = F.silu(c) @ bp["mod_w"] + bp["mod_b"]
    shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = mod.chunk(6, dim=-1)

    xn = _modulate(_layer_norm(x), shift_a, scale_a)
    qkv = (xn @ bp["wqkv"]).reshape(b, n, 3, nh, hd)
    attn = fa.flash_attention_bshd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                   causal=False)
    x = x + gate_a[:, None, :] * (attn.reshape(b, n, nh * hd) @ bp["wo"])

    xn = _modulate(_layer_norm(x), shift_m, scale_m)
    hmid = F.gelu((xn @ bp["mlp1"]) + bp["mlp1_b"], approximate="tanh")
    return x + gate_m[:, None, :] * ((hmid @ bp["mlp2"]) + bp["mlp2_b"])


def forward(cfg: DiTConfig, params, x, t, y, remat=True):
    """Predicted velocity for latents x [b, c, H, W], timesteps t [b] and
    labels y [b] (``num_classes`` is the null class).  ``remat``
    recomputes each block in the backward."""
    b, c, H, W = x.shape
    p = cfg.patch_size
    hgrid, wgrid = H // p, W // p

    # patchify: [b, c, H, W] -> [b, n, p*p*c]
    xp = x.reshape(b, c, hgrid, p, wgrid, p).permute(0, 2, 4, 3, 5, 1)
    xp = xp.reshape(b, hgrid * wgrid, p * p * c)
    tok = (xp.to(cfg.dtype) @ params["patch_w"]) + params["patch_b"]
    tok = tok + params["pos_embed"][None]

    temb = timestep_embedding(t, 256).to(cfg.dtype)
    cvec = F.silu((temb @ params["t_mlp1"]) + params["t_mlp1_b"])
    cvec = (cvec @ params["t_mlp2"]) + params["t_mlp2_b"]
    cvec = cvec + params["label_embed"][y.long()]

    def body(tok, bp):
        return _block_forward(cfg, tok, cvec, bp)

    block = ((lambda *a: checkpoint(body, *a, use_reentrant=False))
             if remat else body)
    names = list(params["blocks"])
    for leaves in zip(*(params["blocks"][n].unbind(0) for n in names)):
        tok = block(tok, dict(zip(names, leaves)))

    mod = F.silu(cvec) @ params["final_mod_w"] + params["final_mod_b"]
    shift, scale = mod.chunk(2, dim=-1)
    tok = _modulate(_layer_norm(tok), shift, scale)
    out = (tok @ params["final_w"]) + params["final_b"]

    # unpatchify: [b, n, p*p*oc] -> [b, oc, H, W]
    oc = cfg.out_channels
    out = out.reshape(b, hgrid, wgrid, p, p, oc).permute(0, 5, 1, 3, 2, 4)
    return out.reshape(b, oc, H, W)


def loss_fn(cfg: DiTConfig, params, x0, y, key):
    """Rectified-flow loss (SD3 style) for latents x0 [b, c, H, W] (f32),
    labels y [b] and a threefry key [2]: t uniform, eps normal, labels
    dropped to the null class with ``class_dropout_prob``; the f32 mean
    squared error of the output against ``eps - x0``."""
    b = x0.shape[0]
    k1, k2, k3 = threefry.split(key, 3)
    t = threefry.uniform(k1, b)
    eps = threefry.normal(k2, x0.shape)
    drop = threefry.bernoulli(k3, cfg.class_dropout_prob, (b,))
    y = torch.where(drop, cfg.num_classes, y.long())
    tt = t[:, None, None, None]
    xt = (1 - tt) * x0 + tt * eps
    v_pred = forward(cfg, params, xt.to(cfg.dtype), t * 999.0, y)
    return (v_pred.float() - (eps - x0)).square().mean()


def loss_and_grads(cfg: DiTConfig, params, x0, y, key):
    """(loss, gradients) of :func:`loss_fn` (``llama.value_and_grad``)."""
    return llama.value_and_grad(lambda p: loss_fn(cfg, p, x0, y, key),
                                params)


def build_train_step(cfg: DiTConfig, lr=1e-4, weight_decay=0.0, beta1=0.9,
                     beta2=0.999, grad_clip=1.0):
    """(train_step, opt_init) for one device, the reference's
    ``build_train_step`` on a 1-device mesh: ``train_step(params,
    opt_state, x0, y, key) -> (loss, params, opt_state)``, the reference's
    AdamW (``llama.adamw_train_step``) in place, state ``{step, m, v,
    master}`` (no gnorm, as the reference keeps none)."""
    return llama.adamw_train_step(
        lambda params, x0, y, key: loss_and_grads(cfg, params, x0, y, key),
        lr, weight_decay, beta1, beta2, grad_clip, keep_gnorm=False)


def count_params(params) -> int:
    return llama.count_params(params)


def flops_per_token(cfg: DiTConfig, n_params: int) -> float:
    """Training FLOPs a patch token for MFU: ``6 * n_params`` (every
    parameter counted as a matmul weight) plus the non-causal attention
    term, ``llama.attn_flops_per_token``'s over ``num_patches`` keys."""
    attn = (6.0 * 2.0 * cfg.num_patches * cfg.head_dim * cfg.num_heads
            * cfg.depth)
    return 6.0 * n_params + attn
