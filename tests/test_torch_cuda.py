"""The port's CUDA kernels against their plain versions ON THE CARD.

Marked ``cuda``: without an NVIDIA card every test here skips (a CUDA
kernel has no CPU mode).  On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use.)

Small but real shapes (head_dim 128, block 64, bf16), so a run builds the
kernel library once and takes seconds.  ``chip_smoke.py`` repeats these
checks at Llama-3-8B widths and times them.
"""

import pytest
import torch

from paddle_tpu_torch.ops import kernels as tk
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import rms_norm as trms

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels cannot run here")
    return torch.device("cuda", torch.cuda.current_device())


def _randn(g, dev, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


#: relative tolerance per dtype: one bf16 ulp (2^-7), or f32 sums taken in
#: another order
ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -16}


def test_rms_norm_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = _randn(g, dev, 5, 3, 512)
    w = _randn(g, dev, 512, std=0.1) + 1
    tk.reset_counters()
    got = trms.rms_norm(x, w, 1e-5)
    assert tk.LAUNCHES["rms_norm"] == 1
    want = trms.rms_norm_ref(x, w, 1e-5)
    # same f32 math summed in another order: within one bf16 ulp
    assert ((got.float() - want.float()).abs()
            <= want.float().abs() * 2.0 ** -7 + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_decode_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    b, nh, nkv, hd, bs, mb = 4, 8, 2, 128, 64, 8
    nb = b * mb
    q, kn, vn = (_randn(g, dev, b, nh, hd, dtype=dtype),
                 _randn(g, dev, b, nkv, hd, dtype=dtype),
                 _randn(g, dev, b, nkv, hd, dtype=dtype))
    ang = torch.rand(b, hd // 2, generator=g, device=dev) * 3
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    kc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    vc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    kc[nb] = 0
    vc[nb] = 0
    lens = torch.tensor([0, 64, 300, 0], dtype=torch.int32, device=dev)
    wable = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    tables = torch.full((b, mb), nb, dtype=torch.int32, device=dev)
    tables[0, :1] = torch.tensor([3])
    tables[1, :2] = torch.tensor([9, 4])
    tables[2, :5] = torch.tensor([1, 7, 12, 20, 30])
    wblk = torch.tensor([3, 4, 30, nb], dtype=torch.int32, device=dev)
    args = (q, kn, vn, cos, sin)
    tail = (tables, lens, wblk, wable)
    k2, v2 = kc.clone(), vc.clone()
    tk.reset_counters()
    out, _, _ = tpa.fused_decode_step(*args, kc, vc, *tail, num_shards=4)
    assert tk.LAUNCHES["fused_decode_step"] == 1
    want, _, _ = tpa.fused_decode_step_reference(*args, k2, v2, *tail,
                                                 num_shards=4)
    d = (out.float() - want.float()).abs()
    # one ulp of the value plus half an ulp of the largest output of the
    # same (slot, q head): each lane is held to its own scale
    ref = want.float().abs()
    assert (d <= ref * ULP[dtype]
            + ref.amax(dim=-1, keepdim=True) * ULP[dtype] / 2).all()
    # the committed rows: the same rope arithmetic on both sides (f32 may
    # contract a multiply-add into an FMA in the kernel)
    assert torch.allclose(kc, k2, rtol=ULP[dtype], atol=1e-6)
    assert torch.equal(vc, v2)
    assert (kc[nb] == 0).all()


@pytest.mark.parametrize("dtype,B", [(torch.bfloat16, 5),
                                     (torch.bfloat16, 11),
                                     (torch.float32, 3)])
def test_fused_mlp_kernel_matches_plain(dev, dtype, B):
    """B = 11 takes two launches (8 rows each at most)."""
    g = torch.Generator(device=dev).manual_seed(2)
    h, F = 512, 1792
    r = lambda *s, std=1.0: _randn(g, dev, *s, std=std, dtype=dtype)
    x, ay = r(B, h), r(B, h, std=0.1)
    nw = r(h, std=0.1) + 1
    wg, wu = r(h, F, std=0.02), r(h, F, std=0.02)
    wd = r(F, h, std=0.02)
    tk.reset_counters()
    h1, y = tpa.fused_layer_mlp(x, ay, nw, wg, wu, wd, 1e-5)
    assert tk.LAUNCHES["fused_layer_mlp"] == -(-B // 8)
    h1_p, y_p = tpa.fused_layer_mlp_reference(x, ay, nw, wg, wu, wd, 1e-5)
    assert torch.equal(h1, h1_p)
    d = (y.float() - y_p.float()).abs()
    assert (d <= y_p.float().abs() * 2 * ULP[dtype]
            + y_p.float().abs().max() * ULP[dtype]).all()
