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
from torch_threads import one_torch_thread  # noqa: F401

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
@pytest.mark.parametrize("h", [64, 256, 2048, 4096, "widest"])
@pytest.mark.parametrize("rows", [1, 7, 8, 1500, 4096])
def test_rms_norm_shapes_match_plain(dev, dtype, h, rows):
    """The kernel against the plain version at every register size it is
    built for (16-byte vectors a thread: bf16 64, 256 and 2048 take 1, 4096
    takes 2; f32 64 and 256 take 1, 2048 takes 2, 4096 takes 4; the widest
    row it takes, bf16 16384 and f32 8192, takes 8) and at the decode
    step's, a prefill's and the train step's row counts: within one ulp of
    the dtype plus f32 sums in another order."""
    if h == "widest":
        h = 256 * 8 * (16 // torch.tensor([], dtype=dtype).element_size())
    g = torch.Generator(device=dev).manual_seed(rows + h)
    x = _randn(g, dev, rows, h, dtype=dtype)
    w = _randn(g, dev, h, std=0.1, dtype=dtype) + 1
    want = trms.rms_norm_ref(x, w, 1e-5).float()
    tk.reset_counters()
    got = trms.rms_norm_cuda(x, w, 1e-5)
    assert tk.LAUNCHES["rms_norm"] == 1
    torch.cuda.synchronize()
    assert ((got.float() - want).abs()
            <= want.abs() * ULP[dtype] + 1e-6).all()


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


#: flash kernels vs their plain versions: both compute in f32 from the same
#: inputs and sum in other orders; the outputs round once to the input
#: dtype.  Per element: one ulp of the value (a rounding that lands on the
#: other side) plus a floor relative to the tensor's largest value (f32
#: sums over up to skv * rep terms, where dk/dv cancel)
FLASH_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -10),
             torch.float16: (2.0 ** -10, 2.0 ** -12),
             torch.float32: (2.0 ** -16, 2.0 ** -16)}


def _flash_close(name, got, want, dtype):
    rel, floor = FLASH_TOL[dtype]
    ref = want.float().abs()
    d = (got.float() - want.float()).abs()
    ok = d <= ref * rel + ref.max() * floor
    assert ok.all(), (name, d.max().item(), ref.max().item())


# (b, sq, skv, hq, hkv, d, causal, mask, segments, dtype)
FLASH_CASES = {
    "bf16_gqa_causal_ragged": (2, 200, 200, 8, 2, 128, True, None, None,
                               torch.bfloat16),
    "f32_full": (1, 96, 130, 4, 4, 64, False, None, None, torch.float32),
    "f16_d256": (1, 70, 70, 2, 1, 256, True, None, None, torch.float16),
    "bf16_sq_ne_skv_segments": (2, 100, 160, 4, 2, 128, True, None, "pair",
                                torch.bfloat16),
    "bf16_bool_mask": (2, 64, 96, 4, 2, 40, False, "bool", None,
                       torch.bfloat16),
    "f32_additive_mask": (1, 80, 80, 4, 2, 128, True, "add", None,
                          torch.float32),
    # the tensor-core route (bf16/f16, head_dim 64 or 128)
    "f16_gqa_causal_ragged": (2, 200, 200, 8, 2, 128, True, None, None,
                              torch.float16),
    "bf16_d64_bool_mask": (2, 64, 96, 4, 2, 64, False, "bool", None,
                           torch.bfloat16),
    "bf16_long_sq_ne_skv_segments": (1, 300, 517, 8, 2, 128, True, None,
                                     "pair", torch.bfloat16),
    "f16_d64_full_additive_mask": (1, 80, 144, 4, 2, 64, False, "add", None,
                                   torch.float16),
    "bf16_full_sq_gt_skv_ragged": (2, 130, 70, 4, 4, 128, False, None, None,
                                   torch.bfloat16),
    "f16_d64_causal_segments": (2, 190, 190, 4, 1, 64, True, None, "pair",
                                torch.float16),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain(dev, case):
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    b, sq, skv, hq, hkv, d, causal, mask, seg, dtype = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(3)
    q = _randn(g, dev, b, sq, hq, d, dtype=dtype)
    k = _randn(g, dev, b, skv, hkv, d, dtype=dtype)
    v = _randn(g, dev, b, skv, hkv, d, dtype=dtype)
    do = _randn(g, dev, b, sq, hq, d, dtype=dtype)
    m, mb, mh = None, 1, 1
    if mask == "bool":
        m, mb, mh = torch.rand(b, 1, sq, skv, generator=g, device=dev) > 0.3, \
            b, 1
        m[0, 0, 5] = False
        m = m.reshape(b, sq, skv)
    elif mask == "add":
        m, mb, mh = torch.randn(1, hq, sq, skv, generator=g, device=dev) \
            .reshape(hq, sq, skv), 1, hq
    segs = None
    if seg == "pair":
        q_ids = torch.randint(0, 3, (b, sq), generator=g, device=dev) \
            .sort(-1).values.int()
        q_ids[:, -7:] = 9             # rows with nothing to attend
        kv_ids = torch.randint(0, 3, (b, skv), generator=g, device=dev) \
            .sort(-1).values.int()
        segs = (q_ids.contiguous(), kv_ids.contiguous())
    kw = dict(mask=m, mb=mb, mh=mh, segs=segs, scale=d ** -0.5,
              causal=causal)
    route = tfa.flash_route(dtype, d)
    # the rule's route, then (where it is the tensor-core one) the CUDA-core
    # route on the same inputs: both held to the plain versions
    for r in (route, "cc") if route == "tc" else (route,):
        tk.reset_counters()
        out, lse = tfa.flash_fwd_cuda(q, k, v, route=r, **kw)
        out_p, lse_p = tfa.flash_fwd_ref(q, k, v, **kw)
        _flash_close("out", out, out_p, dtype)
        live = lse_p > -1e29
        assert torch.allclose(lse[live], lse_p[live], rtol=1e-5, atol=1e-5)
        assert (lse[~live] == lse_p[~live]).all()
        if seg == "pair":
            assert (out[:, -7:] == 0).all()
        delta = (out_p.float() * do.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        dk, dv = tfa.flash_dkv_cuda(q, k, v, do, lse_p, delta, route=r, **kw)
        dq = tfa.flash_dq_cuda(q, k, v, do, lse_p, delta, route=r, **kw)
        dk_p, dv_p = tfa.flash_dkv_ref(q, k, v, do, lse_p, delta, **kw)
        dq_p = tfa.flash_dq_ref(q, k, v, do, lse_p, delta, **kw)
        torch.cuda.synchronize()
        for name, a, e in (("dk", dk, dk_p), ("dv", dv, dv_p),
                           ("dq", dq, dq_p)):
            _flash_close(name, a, e, dtype)
        if seg == "pair":
            assert (dq[:, -7:] == 0).all()
        tc = int(r == "tc")
        assert {n: tk.LAUNCHES[n] for n in (
            "flash_attention_fwd", "flash_attention_dkv", "flash_attention_dq",
            "flash_attention_fwd_tc", "flash_attention_dkv_tc",
            "flash_attention_dq_tc")} == \
            {"flash_attention_fwd": 1, "flash_attention_dkv": 1,
             "flash_attention_dq": 1, "flash_attention_fwd_tc": tc,
             "flash_attention_dkv_tc": tc, "flash_attention_dq_tc": tc}


def test_flash_autograd_launches_and_refuses_large_heads(dev):
    """Through the public entry: one launch of each kernel for a forward and
    a backward; a head_dim the kernels do not take raises (no fallback)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    g = torch.Generator(device=dev).manual_seed(4)
    q = _randn(g, dev, 1, 128, 4, 128).requires_grad_()
    k = _randn(g, dev, 1, 128, 2, 128).requires_grad_()
    v = _randn(g, dev, 1, 128, 2, 128).requires_grad_()
    tk.reset_counters()
    tfa.flash_attention_bshd(q, k, v, causal=True).float().square().sum() \
        .backward()
    assert (tk.LAUNCHES["flash_attention_fwd"],
            tk.LAUNCHES["flash_attention_dkv"],
            tk.LAUNCHES["flash_attention_dq"]) == (1, 1, 1)
    assert (tk.LAUNCHES["flash_attention_fwd_tc"],
            tk.LAUNCHES["flash_attention_dkv_tc"],
            tk.LAUNCHES["flash_attention_dq_tc"]) == (1, 1, 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))
    big = _randn(g, dev, 1, 16, 2, 264)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_bshd(big, big, big)


def test_flash_switch_is_the_documented_token(dev, monkeypatch):
    """Only ``flash_attention`` (or ``all``) takes the flash path off its
    kernels, to the counted composed route; the per-kernel counter names
    are no switch."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    g = torch.Generator(device=dev).manual_seed(5)
    q = _randn(g, dev, 1, 64, 4, 64)
    k = _randn(g, dev, 1, 64, 2, 64)
    env = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
    monkeypatch.setenv(env, "flash_attention_fwd")
    tk.reset_counters()
    with pytest.warns(UserWarning, match="unrecognized"):
        tfa.flash_attention_bshd(q, k, k, causal=True)
    assert tk.LAUNCHES["flash_attention_fwd"] == 1
    monkeypatch.setenv(env, "flash_attention")
    tk.reset_counters()
    fallbacks = tfa.FALLBACK_CALLS
    tfa.flash_attention_bshd(q, k, k, causal=True)
    assert tk.LAUNCHES["flash_attention_fwd"] == 0
    assert tfa.FALLBACK_CALLS == fallbacks + 1


def test_gumbel_noise_kernel_matches_plain(dev):
    """The sampler's noise kernel against the threefry chain on the card:
    the cipher's bits are exact, so only the logs' last bits may differ."""
    from paddle_tpu_torch.ops.kernels import sampling as tsampling

    seeds = torch.tensor([0, -5, 7, 2**31 - 1], dtype=torch.int32,
                         device=dev)
    pos = torch.tensor([0, 100, 2047, 5], device=dev)
    tk.reset_counters()
    got = tsampling.gumbel_noise(seeds, pos, 5000)
    assert tk.LAUNCHES["gumbel_noise"] == 1
    want = tsampling.gumbel_noise_ref(seeds, pos, 5000)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _paged_case(g, dev, mode, dtype, b=4, nh=8, nkv=2, hd=128, bs=64, mb=8):
    """Pools of random rows (quantized per page for int8 / int4), a table
    of distinct pages with sentinel entries past each lane's live pages,
    lengths 0, a page boundary, mid-table and the full table."""
    nb = b * mb
    q = _randn(g, dev, b, nh, hd, dtype=dtype)
    kc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    vc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    ks = vs = None
    if mode:
        kc, ks = tpa.quantize_kv_cache(kc, mode)
        vc, vs = tpa.quantize_kv_cache(vc, mode)
    lens = torch.tensor([0, bs, 300, mb * bs][:b], dtype=torch.int32,
                        device=dev)
    tables = torch.full((b, mb), nb, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    for i in range(b):
        n = max(1, -(-int(lens[i]) // bs))
        tables[i, :n] = perm[i * mb:i * mb + n]
    return q, kc, vc, tables, lens, ks, vs


def _attn_close(got, want, dtype):
    """One ulp of the value plus half an ulp of the largest output of the
    same (slot, q head): f32 sums in another order, one rounding."""
    ref = want.float().abs()
    d = (got.float() - want.float()).abs()
    assert (d <= ref * ULP[dtype]
            + ref.amax(dim=-1, keepdim=True) * ULP[dtype] / 2).all(), \
        d.max().item()


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernels_match_plain(dev, mode, dtype):
    """The sequential walk (num_shards 1) and the split-K walk (2 and 4
    shards) against their plain versions; the zero-length lane is 0."""
    g = torch.Generator(device=dev).manual_seed(6)
    q, kc, vc, tables, lens, ks, vs = _paged_case(g, dev, mode, dtype)
    kw = dict(kv_quant=mode, k_scale=ks, v_scale=vs)
    args = (q, kc, vc, tables, lens)
    want = tpa.paged_attention_reference(*args, **kw)
    for num_shards, name in ((1, "paged_decode"), (None, "flash_decode"),
                             (4, "flash_decode")):
        tk.reset_counters()
        got = tpa.paged_attention_decode(*args, num_shards=num_shards, **kw)
        # both walks at bf16 take the tensor-core route, counted beside
        # their total
        tc = dtype == torch.bfloat16
        assert {k: v for k, v in tk.LAUNCHES.items() if v} == (
            {name: 1, f"{name}_tc": 1} if tc else {name: 1})
        torch.cuda.synchronize()
        _attn_close(got, want, dtype)
        if num_shards != 1:
            plain = tpa.flash_decode_reference(
                *args, 128 ** -0.5, tpa.decode_shards(8, num_shards), **kw)
            _attn_close(got, plain, dtype)
        assert (got[0] == 0).all()


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("rep,hd", [(4, 128), (8, 64), (8, 128)])
def test_paged_decode_tc_matches_plain(dev, mode, rep, hd, monkeypatch):
    """The sequential walk on the tensor cores (bf16 q) against its plain
    version: a zero-length lane (exactly 0), one column, one page, a page
    and a column, mid-table, the full 2048-token table; sentinel entries
    past each lane's live pages; the split rule as committed (8 splits),
    held to no split, and set to runs of 2 pages (16 splits, the most a
    launch takes: the in-launch merge reads its partials in two batches).
    Twice each: the merge tickets are left zero, so a launch repeats bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(20 + rep + hd)
    nkv, bs, mb = 2, 64, 32
    lens_l = [0, 1, bs, bs + 1, 700, mb * bs]
    b, nb = len(lens_l), len(lens_l) * mb
    q = _randn(g, dev, b, rep * nkv, hd)
    kc = _randn(g, dev, nb + 1, nkv, bs, hd)
    vc = _randn(g, dev, nb + 1, nkv, bs, hd)
    ks = vs = None
    if mode:
        kc, ks = tpa.quantize_kv_cache(kc, mode)
        vc, vs = tpa.quantize_kv_cache(vc, mode)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    tables = torch.full((b, mb), nb + 7, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    for i, n in enumerate(lens_l):
        tables[i, :-(-n // bs)] = perm[i * mb:i * mb - (-n // bs)]
    kw = dict(kv_quant=mode, k_scale=ks, v_scale=vs)
    args = (q, kc, vc, tables, lens)
    want = tpa.paged_attention_reference(*args, **kw)
    rules = (({}, 8), ({"_SEQ_MAX_SPLITS": 1}, 1),
             ({"_SEQ_PAGES_PER_SPLIT": 2}, 16))
    for consts, splits in rules:
        with monkeypatch.context() as mp:
            for name, value in consts.items():
                mp.setattr(tpa, name, value)
            assert tpa.seq_decode_splits(mb) == splits
            outs = []
            for _ in range(2):
                tk.reset_counters()
                outs.append(tpa.paged_decode_cuda(*args, hd ** -0.5, **kw))
                assert tk.LAUNCHES["paged_decode"] == 1
                assert tk.LAUNCHES["paged_decode_tc"] == 1
        torch.cuda.synchronize()
        _attn_close(outs[0], want, torch.bfloat16)
        assert torch.equal(outs[0], outs[1])
        assert (outs[0][0] == 0).all()
    cc = tpa.paged_decode_cuda(*args, hd ** -0.5, **kw, route="cc")
    torch.cuda.synchronize()
    _attn_close(cc, want, torch.bfloat16)


def test_paged_decode_tc_refuses_other_shapes(dev):
    """"tc" is refused for f32 q and for head_dim 96 (no fall back); the
    default route of such a shape launches the CUDA-core walk."""
    g = torch.Generator(device=dev).manual_seed(16)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 96)):
        q, kc, vc, tables, lens, ks, vs = _paged_case(g, dev, "int8", dtype,
                                                      hd=hd)
        args = (q, kc, vc, tables, lens, hd ** -0.5)
        kw = dict(kv_quant="int8", k_scale=ks, v_scale=vs)
        with pytest.raises(ValueError, match="route 'tc'"):
            tpa.paged_decode_cuda(*args, **kw, route="tc")
        tk.reset_counters()
        tpa.paged_decode_cuda(*args, **kw)
        assert tk.LAUNCHES["paged_decode"] == 1
        assert tk.LAUNCHES["paged_decode_tc"] == 0


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("rep,hd", [(4, 128), (8, 64), (8, 128)])
def test_flash_decode_tc_matches_plain(dev, mode, rep, hd):
    """The split-K walk on the tensor cores (bf16 q) against its plain
    version at the same shard count: a zero-length lane (exactly 0), one
    column, one page, a page and a column, mid-table, the full 2048-token
    table; sentinel entries past each lane's live pages; 2, 8, 16 and 32
    shards of a 32-page table (at 32 most shards lie past a lane's live
    pages, and the full lane's merge reads its partials in four batches).
    Twice each: the merge tickets are left zero, so a launch repeats bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(40 + rep + hd)
    nkv, bs, mb = 2, 64, 32
    lens_l = [0, 1, bs, bs + 1, 700, mb * bs]
    b, nb = len(lens_l), len(lens_l) * mb
    q = _randn(g, dev, b, rep * nkv, hd)
    kc = _randn(g, dev, nb + 1, nkv, bs, hd)
    vc = _randn(g, dev, nb + 1, nkv, bs, hd)
    ks = vs = None
    if mode:
        kc, ks = tpa.quantize_kv_cache(kc, mode)
        vc, vs = tpa.quantize_kv_cache(vc, mode)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    tables = torch.full((b, mb), nb + 7, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    for i, n in enumerate(lens_l):
        tables[i, :-(-n // bs)] = perm[i * mb:i * mb - (-n // bs)]
    kw = dict(kv_quant=mode, k_scale=ks, v_scale=vs)
    args = (q, kc, vc, tables, lens, hd ** -0.5)
    for S in (2, 8, 16, 32):
        assert tpa.flash_decode_route(torch.bfloat16, hd, S) == "tc"
        want = tpa.flash_decode_reference(*args, S, **kw)
        outs = []
        for _ in range(2):
            tk.reset_counters()
            outs.append(tpa.flash_decode_cuda(*args, S, **kw))
            assert {k: v for k, v in tk.LAUNCHES.items() if v} == {
                "flash_decode": 1, "flash_decode_tc": 1}
        torch.cuda.synchronize()
        _attn_close(outs[0], want, torch.bfloat16)
        assert torch.equal(outs[0], outs[1])
        assert (outs[0][0] == 0).all()
    cc = tpa.flash_decode_cuda(*args, 8, **kw, route="cc")
    torch.cuda.synchronize()
    _attn_close(cc, tpa.flash_decode_reference(*args, 8, **kw),
                torch.bfloat16)


def test_flash_decode_past_the_tc_shards_takes_the_cuda_cores(dev):
    """65 shards of a 128-page table are more than the tensor-core launch
    merges: the rule names the CUDA-core walk, an explicit ``"tc"`` raises
    (no fall back), and the default launch is the CUDA-core walk, within
    the tolerance of its plain version."""
    g = torch.Generator(device=dev).manual_seed(17)
    q, kc, vc, tables, lens, ks, vs = _paged_case(g, dev, "int8",
                                                  torch.bfloat16, mb=128)
    args = (q, kc, vc, tables, lens, 128 ** -0.5, 65)
    kw = dict(kv_quant="int8", k_scale=ks, v_scale=vs)
    assert tpa.flash_decode_route(torch.bfloat16, 128, 65) == "cc"
    with pytest.raises(ValueError, match="route 'tc' .* 65 shards"):
        tpa.flash_decode_cuda(*args, **kw, route="tc")
    tk.reset_counters()
    got = tpa.flash_decode_cuda(*args, **kw)
    assert {k: v for k, v in tk.LAUNCHES.items() if v} == {"flash_decode": 1}
    torch.cuda.synchronize()
    _attn_close(got, tpa.flash_decode_reference(*args, **kw), torch.bfloat16)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_quant_decode_kernel_matches_plain(dev, mode, dtype):
    """Output within the attention tolerance; codes and scales bit-equal to
    the plain composition (the same correctly rounded f32 steps; a code one
    step apart would show a last-bit difference in the roped k row); pages
    no lane writes untouched; the spill page zero codes and scales."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, nkv, hd, bs, mb = 4, 2, 128, 64, 8
    nb = b * mb
    q, kc, vc, _, _, ks, vs = _paged_case(g, dev, mode, dtype)
    # appends at position 0, at a page boundary and mid-page; lane 3 is
    # dropped (sentinel table, write page = the spill page nb)
    lens = torch.tensor([0, 64, 300, 0], dtype=torch.int32, device=dev)
    wable = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device=dev)
    tables = torch.full((b, mb), nb, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    for i in range(3):
        n = int(lens[i]) // bs + 1
        tables[i, :n] = perm[i * mb:i * mb + n]
    lanes = torch.arange(b, device=dev)
    wblk = torch.where(wable == 1, tables[lanes, (lens // bs).long()],
                       torch.full_like(lens, nb)).int()
    kn, vn = (_randn(g, dev, b, nkv, hd, dtype=dtype) for _ in range(2))
    ang = torch.rand(b, hd // 2, generator=g, device=dev) * 3
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    kc[nb], ks[nb] = 5, 1.0          # the spill page starts non-zero
    pools = (kc, ks, vc, vs)
    plain = [t.clone() for t in pools]
    small = (q, kn, vn, cos, sin)
    tail = (tables, lens, wblk, wable)
    tk.reset_counters()
    out, *got = tpa.fused_quant_decode_step(*small, *pools, *tail, mode)
    assert tk.LAUNCHES["fused_quant_decode_step"] == 1
    want, *ref = tpa.fused_quant_decode_step_reference(*small, *plain, *tail,
                                                       mode)
    torch.cuda.synchronize()
    _attn_close(out[:3], want[:3], dtype)
    for a, e in zip(got, ref):
        assert torch.equal(a, e)
    assert (got[0][nb] == 0).all() and (got[1][nb] == 0).all()
    keep = [p for p in range(nb) if p not in {int(x) for x in wblk[:3]}]
    assert torch.equal(got[0][keep], plain[0][keep])


def _fused_case(g, dev, mode, bs, hd, nh=8, nkv=2, max_seq=1024):
    """The fused decode step's inputs at block ``bs``, head_dim ``hd``:
    appends at position 0, at the first row of a new page (``bs``), mid
    page and near the table's end, and a dropped lane (sentinel table,
    write page = the spill page, which starts non-zero).  Pools of random
    rows, quantized per page for int8 / int4."""
    lens_l = [0, bs, 300, max_seq - 3, 0]
    wable_l = [1, 1, 1, 1, 0]
    b, mb = len(lens_l), max_seq // bs
    nb = b * mb
    dtype = torch.bfloat16
    q, kn, vn = (_randn(g, dev, b, h, hd, dtype=dtype)
                 for h in (nh, nkv, nkv))
    ang = torch.rand(b, hd // 2, generator=g, device=dev) * 3
    ang = torch.cat([ang, ang], -1)
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    kc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    vc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    pools = (kc, vc)
    if mode:
        kq, ks = tpa.quantize_kv_cache(kc, mode)
        vq, vs = tpa.quantize_kv_cache(vc, mode)
        kq[nb], ks[nb] = 5, 1.0
        pools = (kq, ks, vq, vs)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    wable = torch.tensor(wable_l, dtype=torch.int32, device=dev)
    tables = torch.full((b, mb), nb, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    for i, (n, w) in enumerate(zip(lens_l, wable_l)):
        if w:
            tables[i, :n // bs + 1] = perm[i * mb:i * mb + n // bs + 1]
    lanes = torch.arange(b, device=dev)
    wblk = torch.where(wable == 1, tables[lanes, (lens // bs).long()],
                       torch.full_like(lens, nb)).int()
    return (q, kn, vn, cos, sin), pools, (tables, lens, wblk, wable), nb


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("bs,hd", [(64, 128), (16, 64), (64, 64), (16, 128)])
def test_fused_decode_routes_match_plain(dev, mode, bs, hd):
    """B7 (fp pools) and B11 (int8 / int4) on both routes against the plain
    version: the output within the attention tolerance for every live lane
    (several shards a lane: the in-launch merge of the tensor-core route),
    the pools bit-equal to the plain composition's (fp: the committed rows;
    quantized: every code and scale), pages no lane writes untouched, the
    spill page zeroed; each launch counted on its route's counter."""
    g = torch.Generator(device=dev).manual_seed(14)
    small, pools, tail, nb = _fused_case(g, dev, mode, bs, hd)
    name = "fused_quant_decode_step" if mode else "fused_decode_step"
    assert tpa.decode_shards(tail[0].shape[1]) > 1
    plain = [t.clone() for t in pools]
    if mode:
        want, *ref = tpa.fused_quant_decode_step_reference(*small, *plain,
                                                           *tail, mode)
    else:
        want, *ref = tpa.fused_decode_step_reference(*small, *plain, *tail)
    written = {int(x) for x, w in zip(tail[2], tail[3]) if w}
    keep = [p for p in range(nb) if p not in written]
    for route in ("tc", "cc"):
        got_pools = [t.clone() for t in pools]
        tk.reset_counters()
        if mode:
            out, *got = tpa.fused_quant_decode_step_cuda(
                *small, *got_pools, *tail, mode, route=route)
        else:
            out, *got = tpa.fused_decode_step_cuda(*small, *got_pools, *tail,
                                                   route=route)
        torch.cuda.synchronize()
        assert tk.LAUNCHES[name] == 1
        assert tk.LAUNCHES[f"{name}_tc"] == int(route == "tc")
        assert sum(tk.LAUNCHES.values()) == 1 + int(route == "tc")
        _attn_close(out[:4], want[:4], torch.bfloat16)
        for i, (a, e) in enumerate(zip(got, ref)):
            if mode is None and i == 0:
                # the roped k rows: the same bf16 rope arithmetic on both
                # sides, held to one ulp as the CUDA-core test holds them
                assert torch.allclose(a, e, rtol=2.0 ** -7, atol=1e-6)
            else:
                assert torch.equal(a, e), route
        for a, e in zip(got, pools):
            assert torch.equal(a[keep], e[keep]), route
            assert (a[nb] == 0).all(), route


def test_fused_decode_tc_refuses_other_shapes(dev):
    """"tc" is refused for f32 q and for head_dim 96 (no fall back); the
    default route of such a shape launches the CUDA-core kernel."""
    g = torch.Generator(device=dev).manual_seed(15)
    small, pools, tail, _ = _fused_case(g, dev, None, 64, 128)
    f32 = [t.float() for t in small]
    fpools = [t.float() for t in pools]
    with pytest.raises(ValueError, match="route 'tc'"):
        tpa.fused_decode_step_cuda(*f32, *fpools, *tail, route="tc")
    tk.reset_counters()
    tpa.fused_decode_step_cuda(*f32, *fpools, *tail)
    assert tk.LAUNCHES["fused_decode_step"] == 1
    assert tk.LAUNCHES["fused_decode_step_tc"] == 0
    small96, pools96, tail96, _ = _fused_case(g, dev, "int8", 64, 96)
    with pytest.raises(ValueError, match="route 'tc'"):
        tpa.fused_quant_decode_step_cuda(*small96, *pools96, *tail96, "int8",
                                         route="tc")
    tk.reset_counters()
    tpa.fused_quant_decode_step_cuda(*small96, *pools96, *tail96, "int8")
    assert tk.LAUNCHES["fused_quant_decode_step"] == 1
    assert tk.LAUNCHES["fused_quant_decode_step_tc"] == 0


def test_decode_switch_tokens_route_as_the_reference(dev, monkeypatch):
    """``flash_decode`` turns the split-K walk into the sequential one,
    ``paged_attention`` sends decode attention to the gather oracle (no
    launch), ``fused_quant_append`` and ``fused_decode_step`` send the
    quantized fused step to its plain composition; a misspelt token warns
    and switches nothing."""
    g = torch.Generator(device=dev).manual_seed(8)
    q, kc, vc, tables, lens, ks, vs = _paged_case(g, dev, "int8",
                                                  torch.bfloat16)
    kw = dict(kv_quant="int8", k_scale=ks, v_scale=vs)
    args = (q, kc, vc, tables, lens)
    env = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
    for token, launched in (("flash_decode", ("paged_decode",
                                              "paged_decode_tc")),
                            ("paged_attention", ())):
        monkeypatch.setenv(env, token)
        tk.reset_counters()
        tpa.paged_attention_decode(*args, **kw)
        assert {k: v for k, v in tk.LAUNCHES.items() if v} == {
            k: 1 for k in launched}
    assert tk.PLAIN_CALLS["paged_decode"] == 1
    b, nkv, hd = q.shape[0], kc.shape[1], q.shape[2]
    small = (q, q[:, :nkv].contiguous(), q[:, :nkv].contiguous(),
             torch.ones(b, hd, dtype=q.dtype, device=dev),
             torch.zeros(b, hd, dtype=q.dtype, device=dev))
    wblk = tables[:, 0].contiguous()
    wable = torch.ones(b, dtype=torch.int32, device=dev)
    for token in ("fused_quant_append", "fused_decode_step"):
        monkeypatch.setenv(env, token)
        tk.reset_counters()
        tpa.fused_quant_decode_step(*small, kc, ks, vc, vs, tables, lens,
                                    wblk, wable, "int8")
        assert tk.LAUNCHES["fused_quant_decode_step"] == 0
        assert tk.PLAIN_CALLS["fused_quant_decode_step"] == 1
    monkeypatch.setenv(env, "flash_decod")
    tk.reset_counters()
    with pytest.warns(UserWarning, match="did you mean 'flash_decode'"):
        tpa.paged_attention_decode(*args, **kw)
    assert tk.LAUNCHES["flash_decode"] == 1


def _rows_case(g, dev, mode, dtype, T, lens, q_lens, bs=64, mb=8, hd=128):
    """A multi-row walk's inputs: b = len(lens) lanes, 8/2 heads, head_dim
    ``hd``, block ``bs``, ``mb`` table pages; lane i owns ceil(lens[i] /
    bs) pages of a shuffled pool (at least one), the rest of its table the
    sentinel nb (the spill page, all zeros)."""
    b, nh, nkv = len(lens), 8, 2
    nb = b * mb
    q = _randn(g, dev, b, T, nh, hd, dtype=dtype)
    kc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    vc = _randn(g, dev, nb + 1, nkv, bs, hd, dtype=dtype)
    kc[nb] = 0
    vc[nb] = 0
    ks = vs = None
    if mode:
        kc, ks = tpa.quantize_kv_cache(kc, mode)
        vc, vs = tpa.quantize_kv_cache(vc, mode)
    tables = torch.full((b, mb), nb, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    for i, n in enumerate(lens):
        n = -(-n // bs) if n > 1 else 0
        tables[i, :n] = perm[i * mb:i * mb + n]
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return q, kc, vc, tables, as_i32(lens), as_i32(q_lens), ks, vs


def _rows_close(got, want, q_lens, dtype):
    """The decode attention's tolerance per (slot, row, q head); rows at or
    past q_len exactly 0 on both sides."""
    for i, n in enumerate(q_lens.tolist()):
        _attn_close(got[i, :n], want[i, :n], dtype)
        assert (got[i, n:] == 0).all() and (want[i, n:] == 0).all()


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_prefill_kernel_matches_plain(dev, mode, dtype):
    """B9 over one mixed-step lane mix at T 16: a decode lane, a chunk that
    crosses a page boundary, a ragged final chunk of 5 rows over a long
    prefix, and an inactive lane (length 1 on the spill page)."""
    g = torch.Generator(device=dev).manual_seed(9)
    q, kc, vc, tables, lens, qlens, ks, vs = _rows_case(
        g, dev, mode, dtype, 16, [300, 70, 500, 1], [1, 16, 5, 1])
    args = (q, kc, vc, tables, lens, qlens)
    kw = dict(kv_quant=mode, k_scale=ks, v_scale=vs)
    tk.reset_counters()
    got = tpa.paged_attention_prefill(*args, **kw)
    tc = int(dtype == torch.bfloat16)      # paged_rows_route
    assert tk.LAUNCHES["paged_prefill"] == 1
    assert tk.LAUNCHES["paged_prefill_tc"] == tc
    assert sum(tk.LAUNCHES.values()) == 1 + tc
    want = tpa.paged_prefill_reference(*args, **kw)
    torch.cuda.synchronize()
    _rows_close(got, want, qlens, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_verify_kernel_matches_plain(dev, dtype, monkeypatch):
    """B10 at K + 1 = 5 rows over fp pools, ragged q_lens; the
    ``paged_attention`` switch sends both walks to the oracle, no launch."""
    g = torch.Generator(device=dev).manual_seed(10)
    q, kc, vc, tables, lens, qlens, _, _ = _rows_case(
        g, dev, None, dtype, 5, [5, 300, 64, 130], [5, 1, 3, 5])
    args = (q, kc, vc, tables, lens, qlens)
    tk.reset_counters()
    got = tpa.paged_attention_verify(*args)
    tc = int(dtype == torch.bfloat16)      # paged_rows_route
    assert tk.LAUNCHES["paged_verify"] == 1
    assert tk.LAUNCHES["paged_verify_tc"] == tc
    assert sum(tk.LAUNCHES.values()) == 1 + tc
    want = tpa.paged_verify_reference(*args)
    torch.cuda.synchronize()
    _rows_close(got, want, qlens, dtype)
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "paged_attention")
    tk.reset_counters()
    plain = tpa.paged_attention_verify(*args)
    tpa.paged_attention_prefill(*args)
    assert not any(tk.LAUNCHES.values())
    assert tk.PLAIN_CALLS["paged_verify"] == 1
    assert tk.PLAIN_CALLS["paged_prefill"] == 1
    assert torch.equal(plain, want)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
@pytest.mark.parametrize("bs,hd", [(64, 128), (16, 64)])
def test_paged_rows_routes_match_plain(dev, mode, bs, hd):
    """B9 / B10 on both routes against the plain version, at two block
    sizes (16: a KV tile spans four pages, each column resolving its own)
    and both tensor-core head dims.  The table reaches 1024 positions, so
    the tensor-core walk splits a few-row lane's KV walk in up to 4
    blocks: 16-row lanes of long prefixes (64 live rows, a whole tile), a
    decode lane, ragged chunks, an inactive lane; then the verify rows
    (fp pools: B10; quantized: the prefill walk, as the verify step takes
    on quantized pools).  Rows past q_len exactly 0."""
    g = torch.Generator(device=dev).manual_seed(11)
    mb = 1024 // bs
    assert tpa.rows_max_splits(mb, bs) == 4
    for T, lens, q_lens in ((16, [1000, 700, 64, 1, 333, 1024], [16, 9, 16,
                                                               1, 3, 1]),
                            (5, [5, 1024, 300, 77], [5, 5, 2, 4])):
        q, kc, vc, tables, lens_t, qlens, ks, vs = _rows_case(
            g, dev, mode, torch.bfloat16, T, lens, q_lens, bs=bs, mb=mb,
            hd=hd)
        args = (q, kc, vc, tables, lens_t, qlens)
        kw = dict(kv_quant=mode, k_scale=ks, v_scale=vs)
        verify = T == 5 and mode is None
        name = "paged_verify" if verify else "paged_prefill"
        want = tpa.paged_prefill_reference(*args, **kw)
        for route in ("tc", "cc"):
            tk.reset_counters()
            got = tpa.paged_prefill_cuda(*args, hd ** -0.5, name=name,
                                         route=route, **kw)
            torch.cuda.synchronize()
            assert tk.LAUNCHES[name] == 1
            assert tk.LAUNCHES[f"{name}_tc"] == int(route == "tc")
            _rows_close(got, want, qlens, torch.bfloat16)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_paged_rows_tc_without_split(dev, mode):
    """A table too narrow to split (2 pages of 64: one split, no partials,
    no combine launch): the tensor-core walk alone against the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, kc, vc, tables, lens, qlens, ks, vs = _rows_case(
        g, dev, mode, torch.bfloat16, 16, [100, 128, 1, 70], [4, 16, 1, 0],
        mb=2)
    assert tpa.rows_max_splits(tables.shape[1], 64) == 1
    args = (q, kc, vc, tables, lens, qlens)
    kw = dict(kv_quant=mode, k_scale=ks, v_scale=vs)
    tk.reset_counters()
    got = tpa.paged_attention_prefill(*args, **kw)
    assert tk.LAUNCHES["paged_prefill_tc"] == 1
    want = tpa.paged_prefill_reference(*args, **kw)
    torch.cuda.synchronize()
    _rows_close(got, want, qlens, torch.bfloat16)


def test_paged_rows_tc_refuses_other_shapes(dev):
    """"tc" is refused where the rule names "cc" (no fall back); the
    default route of such a shape launches the CUDA-core walk."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, kc, vc, tables, lens, qlens, _, _ = _rows_case(
        g, dev, None, torch.float32, 4, [30, 9], [4, 2])
    args = (q, kc, vc, tables, lens, qlens)
    with pytest.raises(ValueError, match="route 'tc'"):
        tpa.paged_prefill_cuda(*args, 0.1, route="tc")
    tk.reset_counters()
    tpa.paged_prefill_cuda(*args, 0.1)
    assert tk.LAUNCHES["paged_prefill"] == 1
    assert tk.LAUNCHES["paged_prefill_tc"] == 0


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_chunked_spec_engine_launches_on_the_card(dev, kv_quant,
                                                  monkeypatch):
    """A 2-layer f32 engine at head_dim 128 with chunked prefill and
    speculation on self-repeating prompts (drafts accepted and rejected):
    every layer of every mixed step
    launches ``paged_prefill``, of every verify step ``paged_verify`` (fp
    pools) or ``paged_prefill`` (int8 pools).  Greedy streams equal the
    same engine's with every kernel off and, on fp pools, the bucketed
    speculation-off engine's (int8 requantizes per write event, so the
    event grouping moves its codes)."""
    import dataclasses

    import numpy as np

    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=2,
                               kv_heads=1, inter=512), dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device=dev)
    rs = np.random.RandomState(0)
    prompts = [np.tile(rs.randint(1, 512, size=7), 12).astype(np.int32),
               rs.randint(1, 512, size=40).astype(np.int32),
               np.tile(rs.randint(1, 512, size=5), 20).astype(np.int32)]

    def serve(**kw):
        eng = serving.ContinuousBatchingEngine(
            cfg, params, paged=True, max_batch=2, max_seq=256, block_size=64,
            kv_quant=kv_quant, device=dev, **kw)
        tk.reset_counters()
        out = eng.serve([serving.Request(rid=i, prompt_ids=p,
                                         max_new_tokens=24)
                         for i, p in enumerate(prompts)])
        return out, eng, dict(tk.LAUNCHES)

    feats = dict(enable_chunked_prefill=True, prefill_chunk=32,
                 enable_speculation=True)
    base, _, _ = serve()
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "all")
    plain, _, off = serve(**feats)
    assert not any(off.values())
    monkeypatch.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS")
    got, eng, launches = serve(**feats)
    st, L = eng.stats, cfg.num_hidden_layers
    assert st["mixed_steps"] > 0 and st["spec_steps"] > 0
    # drafts both accepted (a verify step banked a run) and rejected
    assert st["spec_accepted_tokens"] > 0 and st["spec_rejected_tokens"] > 0
    if kv_quant is None:
        assert launches["paged_prefill"] == L * st["mixed_steps"]
        assert launches["paged_verify"] == L * st["spec_steps"]
    else:
        assert launches["paged_prefill"] == L * (st["mixed_steps"]
                                                 + st["spec_steps"])
        assert launches["paged_verify"] == 0
    assert got == plain
    if kv_quant is None:
        assert got == base


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_tier_round_trip_on_the_card(dev, kv_quant):
    """The host KV tier's transport on the card: two pages demoted with one
    gathered read into page-locked host copies, the first page recycled and
    overwritten at once, then restored into that same page; its bytes
    (codes and scales) are the originals', also when the page-locked
    buffers are freed and new ones written before the copy is waited
    for."""
    import dataclasses

    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab=256, hidden=256, layers=2, heads=2,
                               kv_heads=1, inter=512), dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=0, device=dev)
    eng = serving.ContinuousBatchingEngine(
        cfg, params, paged=True,
        max_batch=1, max_seq=256, block_size=64, num_blocks=8,
        kv_quant=kv_quant, enable_prefix_caching=True,
        enable_host_kv_tier=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    leaves = [t for pair in eng._pool_leaves() for t in pair if t is not None]
    for t in leaves:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=g, device=dev) + 0.5)
    orig = [t[:, 3].clone() for t in leaves]
    eng._demote([("h3", 3), ("h5", 5)])
    assert eng.stats["tier_demotions"] == 2 and len(eng._tier) == 2
    for t in leaves:           # the recycled page is overwritten at once
        t[:, 3].fill_(-7)
    entry = eng._tier.ship_in("h3")
    assert entry.k.is_pinned() and "h3" not in eng._tier
    assert (entry.k_scale is not None) == (kv_quant is not None)
    eng._tier_write(3, entry)
    del entry
    junk = [torch.empty(t[:, 3].shape, dtype=t.dtype,
                        pin_memory=True).fill_(9) for t in leaves]
    torch.cuda.synchronize()
    for t, want in zip(leaves, orig):
        assert torch.equal(t[:, 3], want)
    assert all(j.eq(9).all() for j in junk)


def test_fleet_failover_on_the_card(dev, monkeypatch):
    """A 2-layer f32 fleet of two replicas at head_dim 128, the prefix
    cache on, replica 1 crashed mid-decode: one failover, every request
    FINISHED, each replica step through the kernels (the fused decode
    step, the fused MLP, rms_norm), and the tokens (greedy and seeded)
    those of the same fleet with every kernel off."""
    import dataclasses

    import numpy as np

    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.fleet import FleetRouter
    from paddle_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=2,
                               kv_heads=1, inter=512), dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device=dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 512, size=n).astype(np.int32)
               for n in (70, 33, 90, 12)]

    def serve():
        monkeypatch.setenv("PADDLE_TPU_FAULT_INJECT",
                           "replica_crash@step=6,replica=1")
        fleet = FleetRouter(cfg, params, paged=True, n_replicas=2, max_batch=2,
                            max_seq=256, block_size=64,
                            enable_prefix_caching=True, device=dev)
        monkeypatch.delenv("PADDLE_TPU_FAULT_INJECT")
        reqs = [serving.Request(rid=i, prompt_ids=p, max_new_tokens=16,
                                temperature=0.8 if i % 2 else 0.0,
                                top_p=0.9, seed=5 + i)
                for i, p in enumerate(prompts)]
        tk.reset_counters()
        out = fleet.serve(reqs)
        assert fleet.stats["failovers"] == 1
        assert fleet.stats["replayed_tokens"] > 0
        assert all(r.status == "FINISHED" for r in reqs)
        return out, dict(tk.LAUNCHES)

    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "all")
    plain, off = serve()
    assert not any(off.values())
    monkeypatch.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS")
    got, launches = serve()
    assert all(launches[k] > 0 for k in ("fused_decode_step",
                                         "fused_layer_mlp", "rms_norm",
                                         "gumbel_noise"))
    assert got == plain


def test_dense_engine_on_the_card(dev, monkeypatch):
    """A 2-layer dense engine (``paged=False``) on the card: B1 launches
    2L + 1 times each forward (every prefill and decode step), no paged
    kernel runs, and its tokens are its kernels-off run's; the
    GenerationEngine launches B1 2L + 1 times each forward too.  (The
    greedy streams are compared: a sampled one's Gumbel noise is the
    plain chain's only to float32 rounding of ``log``.)"""
    import dataclasses

    import numpy as np

    from paddle_tpu_torch.inference import GenerationEngine, serving
    from paddle_tpu_torch.models import llama

    cfg = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab=512, hidden=256, layers=2, heads=2,
                               kv_heads=1, inter=512), dtype=torch.float32)
    params = llama.init_params(cfg, seed=0, device=dev)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(1, 512, size=n).astype(np.int32)
               for n in (9, 40, 17)]

    def serve():
        eng = serving.ContinuousBatchingEngine(cfg, params, max_batch=2,
                                               max_seq=128, chunk=2,
                                               device=dev)
        tk.reset_counters()
        out = eng.serve([serving.Request(rid=i, prompt_ids=p,
                                         max_new_tokens=12,
                                         temperature=0.8 * (i % 2), seed=i)
                         for i, p in enumerate(prompts)])
        return out, eng, dict(tk.LAUNCHES)

    got, eng, launches = serve()
    assert not eng.paged
    L = cfg.num_hidden_layers
    forwards = eng.stats["decode_steps"] + eng.stats["prefills"]
    assert launches["rms_norm"] == (2 * L + 1) * forwards
    assert launches["gumbel_noise"] > 0
    for name in ("fused_decode_step", "fused_layer_mlp", "paged_prefill",
                 "paged_decode", "flash_decode"):
        assert launches[name] == 0
    monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "all")
    plain, _, off = serve()
    assert not any(off.values())
    monkeypatch.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS")
    assert [got[0], got[2]] == [plain[0], plain[2]]
    ge = GenerationEngine(cfg, params, max_seq=64, device=dev)
    tk.reset_counters()
    out = ge.generate(np.stack([prompts[0], prompts[2][:9]]),
                      max_new_tokens=5, temperature=0.8, seed=1)
    assert out.shape == (2, 14) and ((out >= 0) & (out < 512)).all()
    assert tk.LAUNCHES["rms_norm"] == (2 * L + 1) * 5


def _grads_kernels_vs_plain(monkeypatch, run):
    """``run(which)`` -> (loss, grads) with the kernels and with every
    kernel off: (loss pair, gradient pairs, the kernel run's launches);
    the plain run launches nothing."""
    out = {}
    for which in ("kernels", "plain"):
        if which == "plain":
            monkeypatch.setenv("PADDLE_TPU_TORCH_DISABLE_KERNELS", "all")
        tk.reset_counters()
        loss, grads = run(which)
        out[which] = (loss.item(), grads, dict(tk.LAUNCHES))
    monkeypatch.delenv("PADDLE_TPU_TORCH_DISABLE_KERNELS")
    assert not any(out["plain"][2].values())
    return out


def _assert_grads_close(out):
    """chip_smoke's phase 9 tolerances: the loss within 2^-8 x 12, every
    leaf's largest error within 2^-5 of the leaf's largest value."""
    (lk, gk, _), (lp, gp, _) = out["kernels"], out["plain"]
    assert abs(lk - lp) <= 2.0 ** -8 * 12
    for a, b in zip(gk, gp):
        assert ((a.float() - b.float()).abs().max()
                <= 2.0 ** -5 * b.float().abs().max())


def test_moe_train_kernels_match_plain(dev, monkeypatch):
    """A 2-layer bf16 MoE (16 experts, top-4: the sort engine; head_dim 128:
    the tensor-core flash route) on the card: its loss and every gradient
    leaf with the kernels and with every kernel off, the plain run
    replaying the kernel run's routing (in bf16 the two round the router's
    input differently, which moves a near-tied pick), and one train step's
    launches."""
    import dataclasses

    from paddle_tpu_torch.models import moe_llama as tmoe

    cfg = dataclasses.replace(
        tmoe.MoEConfig.tiny(vocab=1024, hidden=256, layers=2, heads=2,
                            kv_heads=2, experts=16, top_k=4, inter=256,
                            moe_inter=128), dtype=torch.bfloat16)
    assert tmoe.resolved_dispatch(cfg) == "sort"
    g = torch.Generator(device=dev).manual_seed(0)
    ids = torch.randint(0, 1024, (2, 256), generator=g, device=dev)
    labels = torch.randint(0, 1024, (2, 256), generator=g, device=dev)
    top_k, picks = tmoe.top_k, []

    def recorded(probs, k):
        vals, idx = top_k(probs, k)
        picks.append(idx)
        return vals, idx

    def replayed(probs, k):
        idx = picks.pop(0)
        return probs.gather(-1, idx), idx

    def run(which):
        monkeypatch.setattr(tmoe, "top_k",
                            recorded if which == "kernels" else replayed)
        params = tmoe.init_params(cfg, seed=1, device=dev)
        return tmoe.loss_and_grads(cfg, params, ids, labels)

    out = _grads_kernels_vs_plain(monkeypatch, run)
    assert not picks                 # every routing call replayed
    L = cfg.num_hidden_layers
    launches = out["kernels"][2]
    assert (launches["flash_attention_fwd_tc"],
            launches["flash_attention_dkv_tc"],
            launches["flash_attention_dq_tc"],
            launches["rms_norm"]) == (2 * L, L, L, 4 * L + 1)
    _assert_grads_close(out)
    monkeypatch.setattr(tmoe, "top_k", top_k)
    step, opt_init = tmoe.build_train_step(cfg)
    params = tmoe.init_params(cfg, seed=1, device=dev)
    opt = opt_init(params)
    tk.reset_counters()
    loss, params, opt = step(params, opt, ids, labels)
    assert torch.isfinite(loss) and torch.isfinite(opt["gnorm"])
    assert tk.LAUNCHES["flash_attention_fwd_tc"] == 2 * L


def test_dit_train_kernels_match_plain(dev, monkeypatch):
    """A 2-block bf16 DiT at head_dim 72 (the CUDA-core flash route), EVERY
    leaf random (at init the adaLN-Zero leaves are 0): its loss and every
    gradient leaf with the kernels and with every kernel off; no
    tensor-core launch."""
    import dataclasses

    from paddle_tpu_torch.models import dit as tdit
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.utils import threefry

    cfg = dataclasses.replace(
        tdit.DiTConfig.tiny(image=16, hidden=144, depth=2, heads=2),
        dtype=torch.bfloat16)
    assert cfg.head_dim == 72
    g = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn(8, 4, 16, 16, generator=g, device=dev)
    y = torch.randint(0, 10, (8,), generator=g, device=dev)
    key = threefry.prng_key(0, device=dev)

    def run(which):
        params = tdit.init_params(cfg, seed=1, device=dev)
        gw = torch.Generator(device=dev).manual_seed(2)
        with torch.no_grad():
            for leaf in llama.tree_leaves(params):
                leaf.copy_(torch.randn(leaf.shape, generator=gw,
                                       device=dev) * 0.05)
        return tdit.loss_and_grads(cfg, params, x0, y, key)

    out = _grads_kernels_vs_plain(monkeypatch, run)
    launches = out["kernels"][2]
    D = cfg.depth
    assert (launches["flash_attention_fwd"], launches["flash_attention_dkv"],
            launches["flash_attention_dq"]) == (2 * D, D, D)
    assert not any(launches[f"flash_attention_{p}_tc"]
                   for p in ("fwd", "dkv", "dq"))
    _assert_grads_close(out)
