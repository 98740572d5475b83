#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-sweep 3-14

Drives ``paddle_tpu_torch`` only (it imports no JAX and nothing of
``paddle_tpu``) through its phases, each printing JSON lines, and exits
non-zero as soon as one fails:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the CUDA kernels compiled with ``nvcc`` for sm_90a from the
   sources in this checkout (seconds, whether a build was cached, each
   kernel's registers and spills, and any compiler warning);
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (Llama-3-8B widths, bf16, batch 8, block 64,
   max_seq 2048; rms_norm also at a prefill's and the train step's rows;
   the sampler's Gumbel noise over the 128256-token vocabulary): errors
   against stated tolerances, and CUDA-event times
   of the kernel, the plain version, one PyTorch library call where one
   computes the same function, and the bound (the least time the card
   could take: bytes over 3.35 TB/s or operations over the bf16 peak);
4. flash kernels: the forward, dK/dV and dQ kernels against their plain
   versions at the training shape (batch 2, 2048 tokens, 32/8 heads,
   head_dim 128, bf16, causal), timed like phase 3 (library: PyTorch's
   scaled_dot_product_attention and its backward), and on ragged,
   sq != skv, masked and packed (segment ids) cases; the forward and
   dK/dV on both routes, the tensor-core kernels the rule picks and the
   CUDA-core kernels timed beside them;
5. paged kernels: the sequential and the split-K paged decode over bf16,
   int8 and packed-int4 pools, and the fused requantizing decode step over
   int8 and int4 pools, at the serving shapes with ragged lengths (0 to
   2048), timed like phase 3, both walks on both routes (the tensor-core
   kernel ``decode_route`` / ``flash_decode_route`` picks, split over the
   KV axis and merged in the launch, and the CUDA-core one) and also at 8
   lanes of 512; the requantized codes and scales held bit
   for bit (their share reported), untouched pages exact, the spill page
   zeroed; both fused decode steps (phase 3's over bf16 pools too) on both
   routes, the tensor-core kernel ``decode_route`` picks and the CUDA-core
   one, at that lane mix and at the decode step's 8 lanes of 512;
   the ragged chunked-prefill walk at 128 rows over bf16, int8 and
   int4 pools on one mixed-step lane mix, and the speculative verify walk
   at 5 rows over bf16 pools, rows past each lane's q_len exactly 0;
6. serve: the continuous-batching engine serving Llama-3-8B at full width
   and depth (random bf16 weights from a seed) to 12 requests on fp pools,
   then on int8 pools; the launch counts prove each decode step of each
   layer went through the pool kind's fused decode kernel, on its
   tensor-core route, and the fused MLP and no other decode kernel; a
   profile of four decode steps each,
   and the sampler timed alone; then the same weights with chunked prefill
   (chunk 128) and n-gram speculation (K 4) on 12 requests, half of whose
   prompts repeat a span, on bf16 and on int8 pools, each held to a
   reference on the same requests (bf16: the bucketed speculation-off
   engine; int8: the same configuration with every kernel off): every
   greedy token both runs scored from the same context (up to and
   including the first token where they part) has its whole logit row
   within ``SERVE_LOGIT_TOL`` of the reference's; the launch counts prove
   every layer of every mixed step went through the prefill walk and of
   every verify step through the verify walk (the prefill walk on int8
   pools), each on the tensor-core route, and a profile of four mixed
   steps;
7. arms: a 4-layer full-width model serves the same greedy requests on
   each decode arm of bf16, int8 and int4 pools (the fused step; the
   unfused split-K and sequential walks that
   ``PADDLE_TPU_TORCH_DISABLE_KERNELS=fused_decode_step`` /
   ``fused_quant_append`` [``,flash_decode``] rebuild the engine on; and
   ``all``, every kernel off): each arm launches its own decode kernel
   only, every launch of the fused, the split-K and the sequential arms on
   the tensor-core route, and its logits and greedy streams agree with the
   plain arm's;
8. train: Llama-3-8B widths cut to 4 layers take 5 AdamW steps on one
   batch of 2 x 2048 seeded tokens with full recompute; the loss falls,
   and the launch counts prove every layer went through the three flash
   kernels, each on its tensor-core route; step time,
   tokens/s, model FLOPs utilization, peak memory and
   a torch.profiler breakdown of one step;
9. train kernels vs plain: a 2-layer full-width model's loss, gradient
   norm and every gradient leaf with the kernels and with
   ``PADDLE_TPU_TORCH_DISABLE_KERNELS=all``.

The line before the last lists every kernel with its numbers; the last line
is ``{"ok": true, "device": {...}}``.  ``--serve-sweep FIRST-LAST`` runs
only phases 1, 2 and phase 6's chunked + speculative serves at each
request seed in the range (the script's own run uses seed 3), reporting
each serve's largest logit difference against ``SERVE_LOGIT_TOL`` without
failing on it.  Without a CUDA card, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
F32_OPS = 67e12                 # H100 SXM float32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))
#: the two routes of a two-route kernel at bf16, d 128: the tensor-core
#: kernel the rule picks (flash_route, paged_rows_route), and the CUDA-core
#: kernel
ROUTES = ("tc", "cc")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(torch, fn, reps: int = 21, flush=None) -> float:
    """Median device time of one call of ``fn`` over ``reps`` calls, after
    warm-up, from CUDA events around the call.  ``flush`` (outside the
    events) evicts L2 between calls.  A GPU-side sleep queued before the
    start event lets the host enqueue the whole call before the device
    reaches it, so the host's Python time between launches is not counted
    as device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(20_000_000)   # ~10 ms of device spin
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", "nvidia_smi": line, **dev,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev, line


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    info = dict(kernels.BUILD_INFO)
    kernels.library()
    regs = [ln.strip() for ln in info.get("ptxas", "").splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or "spill" in ln or "warning" in ln.lower()
            or "Performance Loss" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "cached": info["cached"], "library": os.path.relpath(info["path"],
                                                               ROOT),
          "ptxas": regs})


#: the fused decode steps' lane mixes: (label, lengths before the append,
#: writeable): the smoke mix (an append at 0, at page boundaries, mid-page
#: and near the table's end, the last lane dropped) and the decode step's
#: serve shape (8 lanes at 512, the profile's contexts)
DECODE_MIXES = (("smoke_mix", [0, 64, 127, 1000, 1500, 2046, 333, 0],
                 [1, 1, 1, 1, 1, 1, 1, 0]),
                ("serve_8x512", [512] * 8, [1] * 8))


def _decode_tail(torch, perm, lens_l, wable_l, bs, max_blocks, hd):
    """Tables, lengths, write pages, writeable flags and the rope rows of a
    fused decode step's lane mix: a writeable lane owns lens // bs + 1
    pages of ``perm``, a dropped lane's table is the sentinel nb (its write
    page the spill page)."""
    dev = perm.device
    B = len(lens_l)
    nb = B * max_blocks
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    wable = torch.tensor(wable_l, dtype=torch.int32, device=dev)
    tables = torch.full((B, max_blocks), nb, dtype=torch.int32, device=dev)
    for b in range(B):
        if wable_l[b]:
            n = lens_l[b] // bs + 1
            tables[b, :n] = perm[b * max_blocks:b * max_blocks + n]
    lanes = torch.arange(B, device=dev)
    wblk = torch.where(wable == 1, tables[lanes, (lens // bs).long()],
                       torch.full_like(lens, nb)).int()
    inv_freq = 1.0 / (500000.0 ** (torch.arange(0, hd, 2, device=dev).float()
                                   / hd))
    ang = lens.float()[:, None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    return (tables, lens, wblk, wable), (ang.cos().to(torch.bfloat16),
                                         ang.sin().to(torch.bfloat16))


def _b7_case(torch, pa, q, k_new, v_new, kp0, vp0, perm, lens_l, wable_l,
             flush) -> dict:
    """B7 on one lane mix, on both routes from the same pools: the output
    within the attention tolerance of the plain version, pages off the
    appended rows exact, committed rows within 1 ulp, the spill page
    zeroed; times of both routes, the plain version and the bound."""
    nbp, nkv, bs, hd = kp0.shape
    B, nh = q.shape[:2]
    nb, max_blocks = nbp - 1, (nbp - 1) // B
    tail, (cos, sin) = _decode_tail(torch, perm, lens_l, wable_l, bs,
                                    max_blocks, hd)
    tables, lens, wblk, wable = tail
    args = (q, k_new, v_new, cos, sin)
    kq, vq = kp0.clone(), vp0.clone()
    o_p, _, _ = pa.fused_decode_step_reference(*args, kq, vq, *tail)
    touched = torch.zeros(nbp, nkv, bs, dtype=torch.bool, device=q.device)
    for b in range(B):
        if wable_l[b]:
            touched[int(wblk[b]), :, lens_l[b] % bs] = True
    keep = ~touched
    keep[nb] = False
    routes = {}
    for route in ROUTES:
        kp, vp = kp0.clone(), vp0.clone()
        o_k, _, _ = pa.fused_decode_step_cuda(*args, kp, vp, *tail,
                                              route=route)
        torch.cuda.synchronize()
        errs, ok = _attn_err(torch, o_k, o_p)
        check(ok, f"fused_decode_step ({route}): output tolerance")
        for name, new, ref, old in (("key", kp, kq, kp0),
                                    ("value", vp, vq, vp0)):
            check(bool(torch.equal(new[keep], old[keep])),
                  f"fused_decode_step ({route}) {name} pool: untouched rows "
                  f"unchanged")
            d = (new[touched].float() - ref[touched].float()).abs()
            check(bool((d <= ref[touched].float().abs() * 2.0 ** -7).all()),
                  f"fused_decode_step ({route}) {name} pool: committed rows "
                  f"within 1 ulp")
            if not all(wable_l):
                check(bool((new[nb] == 0).all()),
                      f"fused_decode_step ({route}) {name} spill page holds "
                      f"zeros")
        routes[route] = {**errs, "ms": time_ms(
            torch, lambda: pa.fused_decode_step_cuda(*args, kp, vp, *tail,
                                                     route=route),
            flush=flush)}
    # the bytes the function must move: a writeable lane reads its lens
    # cached rows of K and V (the appended row comes from k_new/v_new) and
    # writes that row once per kv head to each pool; a dropped lane reads
    # the pool's row at its position (its output attends over it), and each
    # spill page it zeroes is written once per kv head and pool
    rows_read = sum(n if w else n + 1 for n, w in zip(lens_l, wable_l))
    rows_written = sum(wable_l)
    spill_pages = len({int(wblk[b]) for b in range(B) if not wable_l[b]})
    row_bytes = nkv * hd * 2 * 2                  # one token's K and V rows
    kv_bytes = ((rows_read + rows_written) * row_bytes
                + spill_pages * nkv * bs * hd * 2 * 2)
    small = ((q.numel() + 2 * k_new.numel() + 2 * cos.numel()
              + o_p.numel()) * 2
             + (tables.numel() + lens.numel() + wblk.numel()
                + wable.numel()) * 4)
    flops = 4 * nh * hd * int((lens + 1).sum())
    bnd, by = bound_ms(kv_bytes + small, flops)
    return {**routes["tc"], "lens": lens_l, "writeable": wable_l,
            "route": "tc (decode_route)",
            "cuda_core": routes["cc"],
            "tolerance": "|d| <= 2^-7|ref| + 2^-8 max|ref[slot, head]| (f32 "
                         "order, bf16 rounding); pools exact off the "
                         "appended rows",
            "bound_bytes": kv_bytes + small,
            "shards": pa.flash_decode_shards(max_blocks),
            "untouched_pool_rows_exact": True, "committed_rows_within_1_ulp":
            True, "spill_page_zeros": not all(wable_l),
            "plain_ms": time_ms(torch, lambda: pa.fused_decode_step_reference(
                *args, kq, vq, *tail), flush=flush),
            "library_ms": None, "bound_ms": bnd, "bound_by": by}


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version at the serving path's shapes.
    Returns name -> measured numbers for the final kernels line."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import rms_norm as rms

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    B, h, nh, nkv, hd, F = 8, 4096, 32, 8, 128, 14336
    bs, max_seq, eps = 64, 2048, 1e-5
    max_blocks = max_seq // bs
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf16)

    out = {}

    # ---- rms_norm: the decode step's [8, 1, 4096] rows (33 launches a
    # step), a prefill's [1, 1500, 4096] and the train step's [2, 2048,
    # 4096] (17 launches a step at 4 layers)
    w = (1.0 + 0.1 * torch.randn(h, generator=g, device=dev)).to(bf16)
    res = {}
    for label, shape in (("decode", (B, 1, h)), ("prefill", (1, 1500, h)),
                         ("train", (2, 2048, h))):
        x = randn(*shape)
        got = rms.rms_norm_cuda(x, w, eps)
        ref = rms.rms_norm_ref(x, w, eps)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        # one bf16 ulp of each element: both sides compute the same f32
        # math, summed in a different order, then round to bf16
        tol = ref.float().abs() * 2.0 ** -7 + 1e-6
        check(bool((err <= tol).all()), f"rms_norm {label} within 1 ulp")
        rows = x.numel() // h
        bnd, by = bound_ms(rows * h * 2 * 2 + h * 2, rows * h * 4)
        res[label] = {
            "shape": list(shape), "max_abs_err": err.max().item(),
            "worst_err_over_tol": (err / tol).max().item(),
            "tolerance": "1 bf16 ulp per element (|d| <= 2^-7|ref|)",
            "ms": time_ms(torch, lambda: rms.rms_norm_cuda(x, w, eps),
                          flush=flush),
            "plain_ms": time_ms(torch, lambda: rms.rms_norm_ref(x, w, eps),
                                flush=flush),
            "library_ms": time_ms(torch, lambda: torch.nn.functional.rms_norm(
                x, (h,), w, eps), flush=flush),
            "bound_ms": bnd, "bound_by": by}
    emit({"phase": "kernel", "name": "rms_norm", **res})
    out["rms_norm"] = dict(res["decode"])

    # ---- fused decode step (B7) on both routes: the smoke mix (live
    # lengths 0 to 2046, page boundaries, one dropped lane on the spill
    # page), then the decode step's serve shape (8 lanes at 512)
    nb = B * max_blocks
    nbp = nb + 1
    kp0, vp0 = randn(nbp, nkv, bs, hd), randn(nbp, nkv, bs, hd)
    kp0[nb] = 0
    vp0[nb] = 0
    q, k_new, v_new = randn(B, nh, hd), randn(B, nkv, hd), randn(B, nkv, hd)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    cases = {}
    for label, lens_l, wable_l in DECODE_MIXES:
        cases[label] = _b7_case(torch, pa, q, k_new, v_new, kp0, vp0, perm,
                                lens_l, wable_l, flush)
    res = dict(cases["smoke_mix"], serve_8x512=cases["serve_8x512"])
    emit({"phase": "kernel", "name": "fused_decode_step", **res})
    out["fused_decode_step"] = res
    del kp0, vp0

    # ---- fused MLP half at the decode step's [8, 4096] rows
    x, ay = randn(B, h), randn(B, h, std=0.1)
    nw = (1.0 + 0.1 * torch.randn(h, generator=g, device=dev)).to(bf16)
    wg, wu = randn(h, F, std=0.02), randn(h, F, std=0.02)
    wd = randn(F, h, std=0.02)
    h1_k, y_k = pa.fused_layer_mlp_cuda(x, ay, nw, wg, wu, wd, eps)
    h1_p, y_p = pa.fused_layer_mlp_reference(x, ay, nw, wg, wu, wd, eps)
    torch.cuda.synchronize()
    check(bool(torch.equal(h1_k, h1_p)), "fused_layer_mlp h1 exact")
    err = (y_k.float() - y_p.float()).abs()
    # gate/up/down dots summed in another order (split columns, k-groups,
    # block partials vs cuBLAS) before each bf16 rounding: g or u may land
    # one ulp apart, which moves y by a few ulps of its scale
    tol = y_p.float().abs() * 2.0 ** -6 + y_p.float().abs().max() * 2.0 ** -7
    check(bool((err <= tol).all()), "fused_layer_mlp y tolerance")
    nbytes = 3 * h * F * 2 + 4 * B * h * 2 + h * 2
    bnd, by = bound_ms(nbytes, 2 * B * 3 * h * F)
    res = {"max_abs_err": err.max().item(),
           "max_rel_err": (err / y_p.float().abs().clamp(min=1e-3)).max()
           .item(),
           "tolerance": "|d| <= 2^-6|ref| + 2^-7 max|ref|; h1 exact",
           "slices": pa.fused_mlp_splits(F), "block_cols": pa.fused_mlp_block_cols(F),
           "ms": time_ms(torch, lambda: pa.fused_layer_mlp_cuda(
               x, ay, nw, wg, wu, wd, eps), flush=flush),
           "plain_ms": time_ms(torch, lambda: pa.fused_layer_mlp_reference(
               x, ay, nw, wg, wu, wd, eps), flush=flush),
           "library_ms": None, "bound_ms": bnd, "bound_by": by}
    emit({"phase": "kernel", "name": "fused_layer_mlp", **res})
    out["fused_layer_mlp"] = res

    # ---- the sampler's Gumbel noise over the full vocabulary: the serve
    # phase's two sampled lanes, and a full batch of eight
    from paddle_tpu_torch.ops.kernels import sampling

    V = 128256
    res = {}
    for label, rows in (("serve", 2), ("batch", B)):
        seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows,), generator=g,
                              device=dev, dtype=torch.int32)
        pos = torch.randint(0, max_seq, (rows,), generator=g, device=dev)
        got = sampling.gumbel_noise_cuda(seeds, pos, V)
        ref = sampling.gumbel_noise_ref(seeds, pos, V)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        # the cipher's bits are exact; logf's last bit may differ from
        # PyTorch's log, which moves -log(-log(u)) by ~2^-23 absolute
        check(bool((err <= 1e-6 + 1e-6 * ref.abs()).all()),
              f"gumbel_noise {label} within 1e-6")
        # per element: 20 cipher rounds of 5 integer ops, 17 key-schedule
        # adds, 3 bit ops to a float, 4 float ops, 2 logs and 2 negations
        bnd, by = bound_ms(rows * V * 4 + rows * 12, rows * V * 128,
                           peak=F32_OPS)
        res[label] = {
            "rows": rows, "n": V, "max_abs_err": err.max().item(),
            "bit_equal_share": (got == ref).float().mean().item(),
            "tolerance": "|d| <= 1e-6 + 1e-6|ref| (the logs' last bit)",
            "ms": time_ms(torch, lambda: sampling.gumbel_noise_cuda(
                seeds, pos, V), flush=flush),
            "plain_ms": time_ms(torch, lambda: sampling.gumbel_noise_ref(
                seeds, pos, V), flush=flush),
            "library_ms": None, "bound_ms": bnd, "bound_by": by,
            "bound_peak": "67 T/s float32 CUDA-core rate"}
    emit({"phase": "kernel", "name": "gumbel_noise", **res})
    out["gumbel_noise"] = dict(res["serve"])
    del scratch
    return out


def _attn_err(torch, got, want) -> tuple[dict, bool]:
    """The decode attention tolerance (as the fused decode step's): f32
    sums in another order, one rounding to bf16: |d| <= 2^-7|ref| + 2^-8
    max|ref| of the same (slot, q head); lanes with nothing to attend are
    exactly 0 on both sides."""
    ref = want.float().abs()
    err = (got.float() - want.float()).abs()
    tol = ref * 2.0 ** -7 + ref.amax(dim=-1, keepdim=True) * 2.0 ** -8
    ok = bool((err <= tol).all())
    return {"max_abs_err": err.max().item(),
            "worst_err_over_tol": torch.where(err == 0, 0.0, err / tol).max()
            .item()}, ok


def phase_paged_kernels(torch) -> dict:
    """B5 (the sequential walk) and B6 (the split-K walk) over bf16, int8
    and int4 pools, and B11 (the fused requantizing decode step) over int8
    and int4 pools, each against its plain version at the serving shapes:
    batch 8, 32/8 heads, head_dim 128, block 64, max_seq 2048 (32 table
    pages, 8 shards).  Returns name -> {format: numbers}."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    B, nh, nkv, hd, bs, max_seq = 8, 32, 8, 128, 64, 2048
    max_blocks = max_seq // bs
    nb = B * max_blocks
    nbp = nb + 1
    scale = hd ** -0.5
    S = pa.flash_decode_shards(max_blocks)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    perm = torch.randperm(nb, generator=g, device=dev).int()

    def table(pages):
        t = torch.full((B, max_blocks), nb, dtype=torch.int32, device=dev)
        for b, n in enumerate(pages):
            t[b, :n] = perm[b * max_blocks:b * max_blocks + n]
        return t

    row_bytes = {"bf16": hd * 2, "int8": hd, "int4": hd // 2}
    kp, vp = randn(nbp, nkv, bs, hd), randn(nbp, nkv, bs, hd)
    pools = {"bf16": (kp, vp, None, None)}
    for mode in ("int8", "int4"):
        pools[mode] = (*pa.quantize_kv_cache(kp, mode),
                       *pa.quantize_kv_cache(vp, mode))
        pools[mode] = (pools[mode][0], pools[mode][2], pools[mode][1],
                       pools[mode][3])
    q = randn(B, nh, hd)
    out = {"paged_decode": {}, "flash_decode": {}, "fused_quant_decode_step":
           {}}

    # ---- B5 / B6: lengths 0 and 2048 and spread between, and the serve
    # shape (8 lanes at 512); each on both routes (the tensor-core walk
    # split over the KV axis and merged in the launch, which the route
    # rules pick at bf16 q, and the CUDA-core walk)
    check(pa.decode_route(bf16, hd) == "tc",
          "the sequential walk takes the tensor-core route at bf16, d 128")
    check(pa.flash_decode_route(bf16, hd, S) == "tc",
          f"the split-K walk takes the tensor-core route at bf16, d 128, "
          f"{S} shards")
    mixes = (("smoke_mix", [0, 2048, 64, 127, 1000, 1500, 333, 1777]),
             ("serve_8x512", [512] * B))
    for label, lens_l in mixes:
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        pages = [-(-int(n) // bs) for n in lens_l]
        tables = table(pages)
        live = sum(pages)
        for fmt, (kc, vc, ks, vs) in pools.items():
            kvq = None if fmt == "bf16" else fmt
            kw = dict(kv_quant=kvq, k_scale=ks, v_scale=vs)
            # the bytes the function must move: each live page's K and V
            # rows (and its two scales) once, q and the output, the live
            # table entries and the lengths
            nbytes = (live * nkv * bs * row_bytes[fmt] * 2
                      + (live * nkv * 4 * 2 if kvq else 0)
                      + q.numel() * 2 * 2 + live * 4 + B * 4)
            bnd, by = bound_ms(nbytes, 4 * nh * hd * int(lens.sum()))
            kerns = [("paged_decode", route,
                      lambda r=route: pa.paged_decode_cuda(
                          q, kc, vc, tables, lens, scale, **kw, route=r),
                      lambda: pa.paged_attention_reference(
                          q, kc, vc, tables, lens, scale=scale, **kw))
                     for route in ROUTES]
            kerns += [("flash_decode", route,
                       lambda r=route: pa.flash_decode_cuda(
                           q, kc, vc, tables, lens, scale, S, **kw, route=r),
                       lambda: pa.flash_decode_reference(
                           q, kc, vc, tables, lens, scale, S, **kw))
                      for route in ROUTES]
            plain_ms = {}
            for name, route, kern, plain in kerns:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                errs, ok = _attn_err(torch, got, want)
                what = f"{name} {route or ''} {fmt} {label}"
                check(ok, f"{what}: within the attention tolerance")
                check(bool((got[lens == 0] == 0).all()
                           and (want[lens == 0] == 0).all()),
                      f"{what}: a zero-length lane is exactly 0")
                r = {**errs, "ms": time_ms(torch, kern, flush=flush),
                     "bound_bytes": nbytes, "bound_ms": bnd,
                     "bound_by": by, "library_ms": None,
                     "tolerance": "|d| <= 2^-7|ref| + 2^-8 "
                                  "max|ref[slot, head]|"}
                if name not in plain_ms:
                    plain_ms[name] = time_ms(torch, plain, flush=flush)
                r["plain_ms"] = plain_ms[name]
                # the tensor-core route's numbers at the top of the format's
                # (smoke mix) or the mix's entry, the CUDA-core route's
                # under "cuda_core", whatever the order of ROUTES
                dst = out[name].setdefault(fmt, {})
                if label != "smoke_mix":
                    dst = dst.setdefault(label, {})
                if route == "tc":
                    dst.update(r, **({"shards": S} if name == "flash_decode"
                                     else {"splits": pa.seq_decode_splits(
                                         max_blocks)}))
                else:
                    dst["cuda_core"] = r

    # ---- B11 on both routes: the smoke mix (appends at 0, at a page
    # boundary, mid-page, at the last position; the last lane dropped) and
    # the serve shape (8 lanes at 512)
    k_new, v_new = randn(B, nkv, hd), randn(B, nkv, hd)
    for fmt in ("int8", "int4"):
        res = {}
        for label, lens_l, wable_l in DECODE_MIXES:
            if label == "smoke_mix":
                lens_l = [2047 if n == 2046 else n for n in lens_l]
            res[label] = _b11_case(torch, pa, q, k_new, v_new, pools[fmt],
                                   perm, lens_l, wable_l, fmt, row_bytes,
                                   flush)
        out["fused_quant_decode_step"][fmt] = dict(
            res["smoke_mix"], serve_8x512=res["serve_8x512"])
    out.update(_rows_kernels(torch, pa, pools, table, randn, row_bytes,
                             flush))
    for name, res in out.items():
        emit({"phase": "kernel", "name": name,
              "library": "none: no single PyTorch call computes it", **res})
    del scratch, pools, kp, vp
    torch.cuda.empty_cache()
    return out


def _b11_case(torch, pa, q, k_new, v_new, pool, perm, lens_l, wable_l,
              fmt, row_bytes, flush) -> dict:
    """B11 over one pool format and lane mix, on both routes from the same
    pools (the spill page starting non-zero): the output within the
    attention tolerance, the requantized codes and scales bit for bit
    (their share reported; codes within one step and scales within 2^-7
    checked), pages no lane writes unchanged, the spill page zero codes and
    scales; times of both routes, the plain version and the bound."""
    kq, vq, ks, vs = pool
    nbp, nkv, bs = kq.shape[:3]
    B, nh, hd = q.shape
    nb, max_blocks = nbp - 1, (nbp - 1) // B
    tail, (cos, sin) = _decode_tail(torch, perm, lens_l, wable_l, bs,
                                    max_blocks, hd)
    small = (q, k_new, v_new, cos, sin)
    lens_pre, wblk = tail[1], tail[2]
    written = sorted({int(p) for p, w in zip(wblk.tolist(), wable_l) if w})
    untouched = [p for p in range(nb) if p not in written]
    base = [t.clone() for t in (kq, ks, vq, vs)]
    base[0][nb], base[1][nb] = 5, 1.0    # a non-zero spill page
    base[2][nb], base[3][nb] = 5, 1.0
    plain_pools = [t.clone() for t in base]
    o_p, *ref = pa.fused_quant_decode_step_reference(*small, *plain_pools,
                                                     *tail, fmt)
    codes = (lambda c: pa._unpack_int4(c) if fmt == "int4" else c.float())
    routes = {}
    for route in ROUTES:
        kern_pools = [t.clone() for t in base]
        o_k, *new = pa.fused_quant_decode_step_cuda(*small, *kern_pools,
                                                    *tail, fmt, route=route)
        torch.cuda.synchronize()
        errs, ok = _attn_err(torch, o_k, o_p)
        check(ok, f"fused_quant_decode_step {fmt} ({route}): output "
                  f"tolerance")
        equal, culprits = {}, []
        for label, a, e in (("key_codes", new[0], ref[0]),
                            ("key_scale", new[1], ref[1]),
                            ("value_codes", new[2], ref[2]),
                            ("value_scale", new[3], ref[3])):
            eq = a == e
            equal[label] = eq.float().mean().item()
            if "codes" in label:
                step = (codes(a) - codes(e)).abs().max().item()
                check(step <= 1, f"{fmt} ({route}) {label} within one step "
                                 f"({step})")
                bad = (~eq).flatten(2).any(-1).nonzero().tolist()
            else:
                rel = ((a - e).abs() / e.abs().clamp(min=1e-30)).max().item()
                check(rel <= 2.0 ** -7, f"{fmt} ({route}) {label} within "
                                        f"2^-7 ({rel})")
                bad = (~eq).nonzero().tolist()
            culprits += [{"pool": label, "page_head": pg} for pg in bad[:8]]
        for i, label in ((0, "key codes"), (1, "key scales"),
                         (2, "value codes"), (3, "value scales")):
            check(bool(torch.equal(new[i][untouched], base[i][untouched])),
                  f"{fmt} ({route}) {label}: pages no lane writes are "
                  f"unchanged")
            if not all(wable_l):
                check(bool((new[i][nb] == 0).all()),
                      f"{fmt} ({route}) {label}: the spill page holds zeros")
        routes[route] = {**errs, "bit_equal_share": equal,
                         "differing": culprits,
                         "ms": time_ms(torch, lambda: pa
                                       .fused_quant_decode_step_cuda(
                                           *small, *kern_pools, *tail, fmt,
                                           route=route), flush=flush)}
    # bytes: each lane's walked pages (codes and scales of K and V), the
    # requantized write page rewritten per (lane, head) and pool, the spill
    # page zeroed, the small operands
    walked = sum(-(-(n + 1) // bs) for n in lens_l)
    page = nkv * bs * row_bytes[fmt] * 2 + nkv * 4 * 2
    nbytes = ((walked + B) * page
              + (q.numel() * 2 + 2 * k_new.numel() + 2 * cos.numel()) * 2
              + walked * 4 + 4 * B * 4)
    bnd, by = bound_ms(nbytes, 4 * nh * hd * int((lens_pre + 1).sum()))
    return {**routes["tc"], "lens": lens_l, "writeable": wable_l,
            "route": "tc (decode_route)", "cuda_core": routes["cc"],
            "tolerance": "output as the decode attention; codes within one "
                         "step, scales within 2^-7 relative (bit-equal "
                         "expected); untouched pages exact; spill zeros",
            "shards": pa.flash_decode_shards(max_blocks),
            "bound_bytes": nbytes, "bound_ms": bnd, "bound_by": by,
            "plain_ms": time_ms(torch,
                                lambda: pa.fused_quant_decode_step_reference(
                                    *small, *plain_pools, *tail, fmt),
                                flush=flush),
            "library_ms": None}


def _row_pairs(lens, qlens):
    """The visible (row, column) pairs of a multi-row walk: row t of a lane
    sees len - (qlen - 1 - t) positions."""
    return sum(sum(n - (ql - 1 - t) for t in range(ql))
               for n, ql in zip(lens, qlens))


def _rows_kernels(torch, pa, pools, table, randn, row_bytes, flush) -> dict:
    """B9 (the chunked-prefill walk) at T 128 over bf16, int8 and int4
    pools on one mixed-step lane mix, and B10 (the verify walk) at K+1 = 5
    rows over bf16 pools, each on both routes against its plain version:
    the attention tolerance per (slot, row, q head), rows past each lane's
    q_len exactly 0 on both sides; timed on both routes.  Then, check
    only, B9 at T 16 on every format, where every lane's live rows fit one
    row tile, so the long lanes split their KV walk with up to 64 live rows
    a split (the timed mixes split their decode and verify lanes)."""
    B, nh, nkv, hd, bs = 8, 32, 8, 128, 64
    scale = hd ** -0.5
    dev = torch.device("cuda")
    out = {"paged_prefill": {}, "paged_verify": {}}
    cases = (
        # decode lanes (2048, 1000, 333 and an inactive lane of length 1
        # on the spill page), three 128-row prefill chunks (lengths 128,
        # 768, 1920) and a final ragged chunk of 37 rows at length 1500
        ("paged_prefill", 128, [2048, 1000, 333, 1, 128, 768, 1920, 1500],
         [1, 1, 1, 1, 128, 128, 128, 37], ("bf16", "int8", "int4"), True),
        ("paged_verify", 5, [5, 2048, 64, 127, 1000, 1500, 333, 1777],
         [5, 5, 1, 3, 5, 2, 5, 4], ("bf16",), True),
        # 16-row chunks over long prefixes, ragged, a decode lane, an
        # inactive lane
        ("paged_prefill", 16, [2048, 1500, 64, 700, 1, 333, 128, 2000],
         [16, 9, 16, 3, 1, 16, 16, 14], ("bf16", "int8", "int4"), False))
    split_case = {}
    for name, T, lens_l, qlens_l, fmts, timed in cases:
        pages = [-(-n // bs) if n > 1 else 0 for n in lens_l]
        tables = table(pages)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        qlens = torch.tensor(qlens_l, dtype=torch.int32, device=dev)
        q = randn(B, T, nh, hd)
        live = sum(max(p, 1) for p in pages)     # the inactive lane reads
        pairs = _row_pairs(lens_l, qlens_l)      # its one (spill) page
        live_rows = torch.arange(T, device=dev)[None, :] < qlens[:, None]
        for fmt in fmts:
            kc, vc, ks, vs = pools[fmt]
            kvq = None if fmt == "bf16" else fmt
            kw = dict(kv_quant=kvq, k_scale=ks, v_scale=vs)
            if name == "paged_verify":
                kw = dict(name="paged_verify")
            args = (q, kc, vc, tables, lens, qlens)
            kern = lambda r: lambda: pa.paged_prefill_cuda(*args, scale,
                                                           route=r, **kw)
            if name == "paged_prefill":
                plain = lambda: pa.paged_prefill_reference(
                    *args, scale=scale, kv_quant=kvq, k_scale=ks, v_scale=vs)
            else:
                plain = lambda: pa.paged_verify_reference(*args, scale=scale)
            want = plain()
            errs = {}
            for route in ROUTES:
                got = kern(route)()
                torch.cuda.synchronize()
                errs[route], ok = _attn_err(torch, got[live_rows],
                                            want[live_rows])
                check(ok, f"{name} {fmt} T {T} ({route}): within the "
                          f"attention tolerance")
                check(bool((got[~live_rows] == 0).all()
                           and (want[~live_rows] == 0).all()),
                      f"{name} {fmt} T {T} ({route}): rows past q_len are "
                      f"exactly 0")
            if not timed:
                split_case[fmt] = {f"worst_err_over_tol_{r}": e[
                    "worst_err_over_tol"] for r, e in errs.items()}
                continue
            # bytes: each lane's live pages of K and V (and their scales)
            # once, q's live rows (t < q_len: the walk reads no other), the
            # whole output, the live table entries, the lengths;
            # operations: 4 hd flops a visible (row, column) pair and q head
            nbytes = (live * nkv * bs * row_bytes[fmt] * 2
                      + (live * nkv * 4 * 2 if kvq else 0)
                      + sum(qlens_l) * nh * hd * 2 + q.numel() * 2
                      + live * 4 + 2 * B * 4)
            flops = 4 * hd * nh * pairs
            bnd, by = bound_ms(nbytes, flops)
            out[name][fmt] = {
                **errs["tc"], "rows": T, "lens": lens_l, "q_lens": qlens_l,
                "tolerance": "|d| <= 2^-7|ref| + 2^-8 max|ref[slot, row, "
                             "head]|; rows past q_len exactly 0",
                "rows_past_q_len_zero": True, "bound_bytes": nbytes,
                "bound_flops": flops, "bound_ms": bnd, "bound_by": by,
                "route": "tc (paged_rows_route)",
                "max_splits": pa.rows_max_splits(tables.shape[1], bs),
                "ms": time_ms(torch, kern("tc"), flush=flush),
                "cuda_core": {"ms": time_ms(torch, kern("cc"), flush=flush),
                              **errs["cc"]},
                "plain_ms": time_ms(torch, plain, flush=flush),
                "library_ms": None}
    emit({"phase": "rows_split_case", "rows": 16, "formats": split_case})
    return out


def make_requests(Request, np, n: int, vocab: int, sampled: int, seed: int,
                  repeat: bool = False, new: int = 64):
    """n requests with 64-1500-token prompts, ``new`` new tokens each, the
    last ``sampled`` top-p 0.9.  ``repeat``: every other prompt tiles a
    random span of 16-96 tokens, the self-repeating traffic
    (summarization, extraction, RAG) prompt-lookup drafting is for."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1501, size=n)
    reqs = []
    for i, s0 in enumerate(lens):
        temp = 0.8 if i >= n - sampled else 0.0
        ids = rng.integers(0, vocab, size=int(s0)).astype(np.int32)
        if repeat and i % 2 == 0:
            span = ids[:int(rng.integers(16, 97))]
            ids = np.tile(span, -(-int(s0) // span.size))[:int(s0)]
        reqs.append(Request(rid=i, prompt_ids=ids, max_new_tokens=new,
                            temperature=temp, top_p=0.9, seed=100 + i))
    return reqs


#: the decode kernel of each pool kind's fused arm
FUSED_DECODE = {None: "fused_decode_step", "int8": "fused_quant_decode_step",
                "int4": "fused_quant_decode_step"}
DECODE_KERNELS = ("fused_decode_step", "fused_quant_decode_step",
                  "flash_decode", "paged_decode")


def _serve_llama(torch, np, cfg, params, kv_quant, t_init) -> dict:
    """Serve the 12 requests on one engine; launch counts prove every
    decode step of every layer went through the fused decode kernel of the
    pool kind and the fused MLP, and no other decode kernel ran."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.ops import kernels

    eng = ContinuousBatchingEngine(cfg, params, max_batch=8, max_seq=2048,
                                   block_size=64, kv_quant=kv_quant,
                                   device="cuda")
    reqs = make_requests(Request, np, 12, cfg.vocab_size, sampled=2, seed=0)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counters()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    st = eng.stats
    steps, prefills = st["decode_steps"], st["prefills"]
    L = cfg.num_hidden_layers
    for r in reqs:
        check(r.finished and len(r.output_ids) == r.max_new_tokens,
              f"request {r.rid} finished with {r.max_new_tokens} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.output_ids),
              f"request {r.rid} token ids in the vocabulary")
    # the engine raises on non-finite logits of any active lane at every
    # step; the last step's logits are checked here as well
    check(bool(torch.isfinite(eng.last_logits).all()), "last logits finite")
    decode = FUSED_DECODE[kv_quant]
    for name in (decode, f"{decode}_tc"):
        check(launches[name] == L * steps,
              f"{name} launches {launches[name]} == {L} x {steps} decode "
              f"steps (every one on the tensor-core route)")
    others = {k: launches[k] for k in DECODE_KERNELS if k != decode}
    check(not any(others.values()), f"no other decode kernel ran: {others}")
    check(launches["fused_layer_mlp"] == L * steps,
          f"fused MLP launches {launches['fused_layer_mlp']} == {L} x {steps}")
    check(launches["rms_norm"] == (L + 1) * steps + (2 * L + 1) * prefills,
          f"rms_norm launches {launches['rms_norm']} == {L + 1} x {steps} + "
          f"{2 * L + 1} x {prefills}")
    # one noise launch a decode step with a sampled lane seated
    check(0 < launches["gumbel_noise"] <= steps,
          f"gumbel_noise launches {launches['gumbel_noise']} in (0, {steps}]")
    emit({"phase": "serve", "model": "llama3_8b", "layers": L,
          "kv_quant": kv_quant, "requests": len(reqs),
          "sampled": sum(r.temperature > 0 for r in reqs),
          "prompt_tokens": int(sum(len(r.prompt_ids) for r in reqs)),
          "decode_steps": steps, "prefills": prefills,
          "preemptions": st["preemptions"], "launches": launches,
          "launches_per_decode_step": {decode: L, f"{decode}_tc": L,
                                       "fused_layer_mlp": L,
                                       "rms_norm": L + 1},
          "decode_tokens": st["decode_tokens"],
          "decode_tokens_per_s": eng.decode_tokens_per_s,
          "decode_time_s": st["decode_time_s"],
          "prefill_time_s": st["prefill_time_s"],
          "mean_ttft_s": statistics.mean(r.ttft_s for r in reqs),
          "wall_s": wall, "init_params_s": t_init,
          "kv_pool_gb": sum(t.numel() * t.element_size() for pool in
                            (eng.cache_k, eng.cache_v) for t in
                            (pool.values() if isinstance(pool, dict)
                             else [pool])) / 1e9,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    phase_profile(torch, np, eng, Request, decode)
    if kv_quant is None:
        phase_sampler(torch, eng)
    del eng
    torch.cuda.empty_cache()
    return launches


def phase_serve(torch, np, smi: str) -> tuple[dict, dict, dict]:
    """Llama-3-8B at full width and depth (random bf16 weights from a seed)
    serves the 12 requests on fp pools, then on int8 pools (the fused
    requantizing decode step), then chunked + speculative on both pool
    kinds, from the same weights.  Returns the launches of the fp serve,
    the int8 serve and the two chunked + speculative serves."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fp = _serve_llama(torch, np, cfg, params, None, t_init)
    q8 = _serve_llama(torch, np, cfg, params, "int8", t_init)
    cs = {}
    for kvq in (None, "int8"):
        launches, _ = _serve_chunked_spec(torch, np, cfg, params, kvq, smi)
        for k, v in launches.items():
            cs[k] = cs.get(k, 0) + v
    del params
    torch.cuda.empty_cache()
    return fp, q8, cs


def serve_sweep(torch, np, smi: str, seeds: list[int]) -> None:
    """``--serve-sweep``: the chunked + speculative serve's logit check of
    phase 6 at each request seed, on bf16 and int8 pools, each line
    reporting the largest logit difference against ``SERVE_LOGIT_TOL``
    without failing on it (the readings the bound is set from)."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    worst = {}
    for seed in seeds:
        for kvq in (None, "int8"):
            _, res = _serve_chunked_spec(torch, np, cfg, params, kvq, smi,
                                         seed=seed, sweep=True)
            key = kvq or "bf16"
            worst[key] = max(worst.get(key, 0.0), res["max_abs_logit_diff"])
    emit({"phase": "serve_sweep_summary", "seeds": seeds,
          "max_abs_logit_diff": worst,
          "logit_tolerance": {k or "bf16": v
                              for k, v in SERVE_LOGIT_TOL.items()}})


#: pool kind -> the largest |z_run - z_ref| over a whole 128256-entry
#: logit row that the 32-layer chunked + speculative serve may show against
#: its reference at a token both runs scored from the same context (every
#: index up to and including the first one whose greedy tokens differ):
#: bf16 activations rounded at other places (batched matmul shapes, kernel
#: vs plain attention) through 32 layers.  Set on the parent's CUDA-core
#: decode kernels, before the tensor-core decode route existed, from
#: ``--serve-sweep 3-14`` on one H100 ("NVIDIA H100 80GB HBM3, 700.00 W"):
#: the largest reading of each pool kind times 1.25, rounded up to a
#: multiple of 1/32.  Readings at request seeds 3..14, bf16 pools against
#: the bucketed engine: 0.34375 0.29492 0.30908 0.31787 0.32812 0.32422
#: 0.28516 0.31055 0.30469 0.34180 0.32031 0.34375 (max 0.34375 -> 0.4375);
#: int8 pools against the kernels-off run: 0.54102 0.34375 0.29980 0.32397
#: 0.54761 0.34277 0.35156 0.31299 0.62598 0.42188 0.56055 0.34766 (max
#: 0.62598 -> 0.8125)
SERVE_LOGIT_TOL = {None: 0.4375, "int8": 0.8125}


def _serve_stepwise(torch, eng, reqs) -> dict:
    """Serve ``reqs`` step by step; returns rid -> [tokens, V] logits, for
    each greedy request the logit row that chose each of its tokens.  The
    serving module's ``lm_head_logits`` is wrapped to keep every row the
    engine scores: a decode step's [B, V], a mixed step's emit rows [B, V],
    a verify step's [B, Q, V] (row t chose the token t after the pending
    one; rows past the accepted run scored rejected drafts and are not
    kept).  The engine itself runs unchanged."""
    from paddle_tpu_torch.inference import serving

    head = serving.lm_head_logits
    calls = []

    def capture(cfg, params, x):
        z = head(cfg, params, x)
        calls.append(z)
        return z

    for r in reqs:
        eng.add_request(r)
    rows = {r.rid: [] for r in reqs if r.temperature == 0}
    serving.lm_head_logits = capture
    try:
        while True:
            before = {r.rid: len(r.output_ids) for r in reqs}
            # a request retired by this step held its slot before it, one
            # admitted by it holds its slot after it
            slot_of = {r.rid: s for s, r in enumerate(eng._slot_req)
                       if r is not None}
            calls.clear()
            if not eng.step() and not eng._queue:
                break
            slot_of.update({r.rid: s for s, r in enumerate(eng._slot_req)
                            if r is not None})
            for r in reqs:
                new = len(r.output_ids) - before[r.rid]
                if new and r.rid in rows:
                    s = slot_of[r.rid]
                    seq = torch.cat([z[s].reshape(-1, z.shape[-1])
                                     for z in calls])
                    rows[r.rid].append(seq[:new].clone())
    finally:
        serving.lm_head_logits = head
    return {rid: torch.cat(v) if v else None for rid, v in rows.items()}


def _logit_check(torch, reqs, rows, ref_reqs, ref_rows) -> dict:
    """The greedy requests of a run against its reference: the tokens agree
    up to index i and differ at i (i = the length when they never part),
    so at every index <= i both runs scored the same context, and the
    largest |z_run - z_ref| over those rows is what the run's numbers
    moved.  At the parting the reference's top-2 gap is at most twice the
    difference there (else the captured rows are not the ones that chose
    the tokens: checked)."""
    worst, agree, total, parted = 0.0, 0, 0, []
    for a, b in zip(reqs, ref_reqs):
        if a.temperature > 0:
            continue
        za, zb = rows[a.rid], ref_rows[b.rid]
        check(za.shape[0] == len(a.output_ids)
              and zb.shape[0] == len(b.output_ids),
              f"rid {a.rid}: one logit row for each emitted token")
        n = min(len(a.output_ids), len(b.output_ids))
        i = next((j for j in range(n) if a.output_ids[j] != b.output_ids[j]),
                 n)
        agree += i
        total += n
        d = (za[:i + 1].float() - zb[:i + 1].float()).abs().amax(dim=-1)
        worst = max(worst, d.max().item())
        if i < n:
            top2 = zb[i].float().topk(2).values
            gap = (top2[0] - top2[1]).item()
            parted.append({"rid": a.rid, "token": i, "ref_top2_gap": gap,
                           "max_abs_logit_diff": d[i].item()})
            check(gap <= 2 * d[i].item(),
                  f"rid {a.rid} token {i}: the reference's top-2 gap {gap} "
                  f"is at most twice the logit difference {d[i].item()}")
    return {"max_abs_logit_diff": worst, "greedy_tokens_agreeing": agree,
            "greedy_tokens": total,
            "greedy_agreeing_share": agree / total if total else None,
            "diverged": parted}


def _serve_chunked_spec(torch, np, cfg, params, kv_quant, smi, seed=3,
                        sweep=False) -> tuple[dict, dict]:
    """Chunked prefill (chunk 128, the default token budget of 136) and
    n-gram speculation (K 4, ngram 3) on 12 requests (request seed
    ``seed``), half of whose prompts repeat a span, against a reference on
    the same requests and pool kind.  256 new tokens a request: the
    random-weight model does not copy its context, so the drafter proposes
    only where a generated token repeats one already in the context, which
    12 requests of 64 new tokens never did on the H100.  The launch counts
    prove every layer of every mixed step went through ``paged_prefill``,
    of every verify step through ``paged_verify`` (``paged_prefill`` on
    int8 pools: only the prefill walk dequantizes), and of every other
    decode step through the pool kind's fused decode kernel.  On bf16 pools
    the reference is the bucketed speculation-off engine; on int8 pools,
    whose requantization is lossy per write event (a chunk, a verify window
    with its rejected drafts), so that event grouping moves the codes by
    design, it is the same chunked + speculative configuration with every
    kernel off (the reference's own guarantee is between the arms of one
    configuration).  Every greedy token both runs scored from the same
    context has its whole logit row within ``SERVE_LOGIT_TOL`` of the
    reference's (``_logit_check``).  ``sweep``: no bucketed run on int8
    pools (its numbers are reported only), no profile, and the logit bound
    reported instead of checked.  Returns the chunked + speculative run's
    launches and the logit check's result."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.ops import kernels

    base = dict(max_batch=8, max_seq=2048, block_size=64, kv_quant=kv_quant,
                device="cuda")
    feats = dict(enable_chunked_prefill=True, prefill_chunk=128,
                 enable_speculation=True, num_draft_tokens=4, spec_ngram=3)
    env = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
    against = "bucketed" if kv_quant is None else "plain"
    runs = {}
    for label, kw, disable in (("bucketed", {}, None),
                               ("chunked_spec", feats, None),
                               ("plain", feats, "all")):
        if label == "plain" and kv_quant is None:
            continue
        if label == "bucketed" and kv_quant and sweep:
            continue
        if disable:
            os.environ[env] = disable
        eng = ContinuousBatchingEngine(cfg, params, **base, **kw)
        reqs = make_requests(Request, np, 12, cfg.vocab_size, sampled=2,
                             seed=seed, repeat=True, new=256)
        kernels.reset_counters()
        t0 = time.perf_counter()
        rows = _serve_stepwise(torch, eng, reqs)
        torch.cuda.synchronize()
        runs[label] = (eng, reqs, rows, dict(kernels.LAUNCHES),
                       time.perf_counter() - t0)
        os.environ.pop(env, None)
    if "plain" in runs:
        check(not any(runs["plain"][3].values()),
              f"the plain run launched no kernel: {runs['plain'][3]}")
    eng, reqs, rows, launches, wall = runs["chunked_spec"]
    _, tok_reqs, tok_rows, _, _ = runs[against]
    st, L = eng.stats, cfg.num_hidden_layers
    mixed, spec = st["mixed_steps"], st["spec_steps"]
    plain_steps = st["decode_steps"] - mixed - spec
    for r in reqs:
        check(r.finished and len(r.output_ids) == r.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.output_ids),
              f"chunked+spec request {r.rid}: {r.max_new_tokens} tokens in "
              f"the vocabulary")
    check(mixed > 0 and spec > 0,
          f"mixed steps {mixed} and verify steps {spec} both ran")
    check(st["prefills"] == 0 and st["decode_stall_steps"] == 0,
          "no bucketed prefill, no decode stall")
    # every walk and fused decode step on the tensor-core route
    want = {"paged_prefill": L * (mixed + (spec if kv_quant else 0)),
            "paged_verify": 0 if kv_quant else L * spec,
            "paged_prefill_tc": L * (mixed + (spec if kv_quant else 0)),
            "paged_verify_tc": 0 if kv_quant else L * spec,
            FUSED_DECODE[kv_quant]: L * plain_steps,
            f"{FUSED_DECODE[kv_quant]}_tc": L * plain_steps,
            "fused_layer_mlp": L * plain_steps,
            "rms_norm": (L + 1) * plain_steps + (2 * L + 1) * (mixed + spec)}
    for name, n in want.items():
        check(launches[name] == n, f"{kv_quant} chunked+spec: {name} "
                                   f"launches {launches[name]} == {n}")
    others = {k: launches[k] for k in DECODE_KERNELS
              if k != FUSED_DECODE[kv_quant]}
    check(not any(others.values()), f"no other decode kernel ran: {others}")
    check(launches["gumbel_noise"] > 0, "the sampled lanes drew noise")
    logits = _logit_check(torch, reqs, rows, tok_reqs, tok_rows)
    del rows, tok_rows
    tol = SERVE_LOGIT_TOL[kv_quant]
    within = logits["max_abs_logit_diff"] <= tol
    if sweep:
        emit({"phase": "serve_sweep", "seed": seed, "kv_quant": kv_quant,
              "nvidia_smi": smi, "greedy_against": against,
              "logit_tolerance": tol, "within_tolerance": within,
              **logits, "launches": {k: v for k, v in launches.items() if v},
              "decode_steps": st["decode_steps"], "mixed_steps": mixed,
              "spec_steps": spec, "wall_s": wall})
        del runs, eng, tok_reqs
        torch.cuda.empty_cache()
        return launches, logits
    ref_eng, ref_reqs, _, _, ref_wall = runs["bucketed"]
    emit({"phase": "serve_chunked_spec", "model": "llama3_8b", "layers": L,
          "kv_quant": kv_quant, "nvidia_smi": smi, "requests": len(reqs),
          "sampled": sum(r.temperature > 0 for r in reqs),
          "repeating_prompts": sum(i % 2 == 0 for i in range(len(reqs))),
          "prompt_tokens": int(sum(len(r.prompt_ids) for r in reqs)),
          "prefill_chunk": 128, "token_budget": eng._token_budget,
          "num_draft_tokens": 4, "spec_ngram": 3, "new_tokens": 256,
          "decode_steps": st["decode_steps"], "mixed_steps": mixed,
          "prefill_chunks": st["prefill_chunks"], "spec_steps": spec,
          "plain_decode_steps": plain_steps,
          "spec_drafted_tokens": st["spec_drafted_tokens"],
          "spec_accepted_tokens": st["spec_accepted_tokens"],
          "spec_acceptance_rate": eng.spec_acceptance_rate,
          "decode_stall_steps": st["decode_stall_steps"],
          "preemptions": st["preemptions"], "launches": launches,
          "decode_tokens": st["decode_tokens"],
          "decode_tokens_per_s": eng.decode_tokens_per_s,
          "mean_ttft_s": statistics.mean(r.ttft_s for r in reqs),
          "wall_s": wall,
          "tokens_per_wall_s": sum(len(r.output_ids) for r in reqs) / wall,
          "request_seed": seed, "greedy_against": against,
          "logit_tolerance": tol, **logits,
          "bucketed": {"decode_tokens_per_s": ref_eng.decode_tokens_per_s,
                       "mean_ttft_s": statistics.mean(r.ttft_s
                                                      for r in ref_reqs),
                       "prefill_time_s": ref_eng.stats["prefill_time_s"],
                       "decode_stall_steps":
                           ref_eng.stats["decode_stall_steps"],
                       "decode_steps": ref_eng.stats["decode_steps"],
                       "wall_s": ref_wall,
                       "tokens_per_wall_s": sum(len(r.output_ids)
                                                for r in ref_reqs)
                       / ref_wall}})
    check(within, f"{kv_quant} chunked+spec: every greedy token scored "
                  f"from the {against} run's context has its logit row "
                  f"within {tol} of it (max {logits['max_abs_logit_diff']})")
    del runs, ref_eng, tok_reqs
    phase_profile(torch, np, eng, Request, FUSED_DECODE[kv_quant])
    del eng
    torch.cuda.empty_cache()
    return launches, logits


#: device-kernel name fragments -> the layer they belong to (the split-K
#: combine kernel and the tensor-core fused decode kernel,
#: ``decode_tc_kernel<true, ...>`` for both pool kinds, go with the decode
#: kernel the profiled engine runs; ``decode_tc_kernel<false, ...>`` is the
#: sequential walk)
_KERNEL_GROUPS = (("fused_quant_decode", "fused_quant_decode_step"),
                  ("rows_kernel", "paged_prefill / paged_verify"),
                  ("rows_tc_kernel", "paged_prefill / paged_verify"),
                  ("rows_combine_kernel", "paged_prefill / paged_verify"),
                  ("fused_decode", "fused_decode_step"),
                  ("paged_walk", "paged_decode / flash_decode"),
                  ("decode_tc_kernel<false", "paged_decode / flash_decode"),
                  ("mlp_partial", "fused_layer_mlp"),
                  ("mlp_reduce", "fused_layer_mlp"),
                  ("rms_norm_kernel", "rms_norm"),
                  ("gemm", "matmul"), ("gemv", "matmul"),
                  ("cutlass", "matmul"), ("sm90_xmma", "matmul"),
                  ("nvjet", "matmul"))


def phase_profile(torch, np, eng, Request, decode) -> None:
    """Where a full-depth step's time goes: torch.profiler over four steps
    of eight 512-token requests (the engine of phase 6, after its serve:
    decode steps, or on a chunked engine mixed steps streaming the
    prompts), device time summed by layer (the split-K combine kernel with
    ``decode``, the fused decode kernel it follows), and the device's busy
    share of the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    for i in range(eng.max_batch):
        eng.add_request(Request(rid=1000 + i, prompt_ids=rng.integers(
            0, eng.cfg.vocab_size, size=512).astype(np.int32),
            max_new_tokens=8))
    eng.step()                      # admission + prefills + 1 decode step
    torch.cuda.synchronize()
    steps = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict[str, float] = {}
    other: dict[str, float] = {}
    total = 0.0
    for evt in prof.key_averages():
        cuda_kind = torch.autograd.DeviceType.CUDA
        if getattr(evt, "device_type", cuda_kind) != cuda_kind:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if not dev_us:
            continue
        total += dev_us
        name = evt.key.lower()
        group = decode if ("combine_kernel" in name
                           or "decode_tc_kernel<true" in name) else next(
            (g for frag, g in _KERNEL_GROUPS if frag in name), "other")
        groups[group] = groups.get(group, 0.0) + dev_us
        if group == "other":
            other[evt.key[:60]] = dev_us / steps / 1e3
    while eng.step() or eng._queue:  # finish the profiled requests
        pass
    emit({"phase": "profile", "kv_quant": eng.kv_quant,
          "step_kind": "mixed" if eng._chunked else "decode",
          "decode_steps": steps, "batch": eng.max_batch,
          "context": 512, "wall_ms_per_step": wall / steps * 1e3,
          "device_ms_per_step": ({g: v / steps / 1e3
                                  for g, v in sorted(groups.items())}
                                 if total else "not measured"),
          "device_busy_share": total / 1e6 / wall if total else None,
          "other_top": dict(sorted(other.items(),
                                   key=lambda kv: -kv[1])[:6])})


def phase_sampler(torch, eng) -> None:
    """The decode step's sampler alone at batch 8 over the full vocabulary:
    greedy only, one sampled lane, all eight sampled (nucleus sort plus the
    threefry Gumbel draw on the sampled rows).  Host ms is the time to
    enqueue one call, device ms its CUDA-event time, wall ms one call
    between two synchronizations."""
    B, V = eng.max_batch, eng.cfg.vocab_size
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    logits = (torch.randn(B, V, generator=g, device=dev) * 3).to(
        eng.last_logits.dtype)
    pos = torch.arange(500, 500 + B, device=dev)
    seeds = torch.arange(-3, B - 3, dtype=torch.int32, device=dev)
    topp = torch.full((B,), 0.9, device=dev)
    greedy = logits.argmax(dim=-1)
    res = {}
    for label, lanes in (("greedy", []), ("1_sampled", [B - 1]),
                         ("8_sampled", list(range(B)))):
        temp = torch.zeros(B, device=dev)
        temp[lanes] = 0.8
        rows = torch.tensor(lanes, dtype=torch.long, device=dev) \
            if lanes else None

        def call():
            return eng._sample_tokens(logits, pos, temp, topp, seeds, rows)

        tok = call()
        torch.cuda.synchronize()
        off = [s for s in range(B) if s not in lanes]
        check(bool(torch.equal(tok[off], greedy[off])),
              f"sampler {label}: greedy lanes take the argmax")
        check(bool(((tok >= 0) & (tok < V)).all()),
              f"sampler {label}: tokens in the vocabulary")
        host, wall = [], []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            wall.append((time.perf_counter() - t0) * 1e3)
        res[label] = {"host_ms": statistics.median(host),
                      "device_ms": time_ms(torch, call),
                      "wall_ms": statistics.median(wall)}
    emit({"phase": "sampler", "batch": B, "vocab": V, **res})


#: the decode arms of each pool kind: label -> (switch tokens, the decode
#: kernel the arm must launch); "plain" launches no kernel
ARMS = {None: (("fused", None, "fused_decode_step"),
               ("split_k", "fused_decode_step", "flash_decode"),
               ("sequential", "fused_decode_step,flash_decode",
                "paged_decode"),
               ("plain", "all", None))}
for _q in ("int8", "int4"):
    ARMS[_q] = (("fused", None, "fused_quant_decode_step"),
                ("split_k", "fused_quant_append", "flash_decode"),
                ("sequential", "fused_quant_append,flash_decode",
                 "paged_decode"),
                ("plain", "all", None))


def _serve_greedy(torch, np, eng, Request, cfg) -> tuple:
    """The 10 greedy requests; returns them, each one's top-2 logit gaps
    per emitted token, and the first decode step's logits of the seated
    lanes (chunk 1, so every step's logits are seen)."""
    from paddle_tpu_torch.ops import kernels

    reqs = [r for r in make_requests(Request, np, 12, cfg.vocab_size,
                                     sampled=2, seed=0)
            if r.temperature == 0.0]
    for r in reqs:
        eng.add_request(r)
    kernels.reset_counters()
    gaps = {r.rid: [] for r in reqs}
    first = None
    while True:
        seated = [(s, r) for s, r in enumerate(eng._slot_req)]
        if not eng.step() and not eng._queue:
            break
        if eng.last_logits is None:
            continue
        lg = eng.last_logits.float()
        if first is None:
            # the seated lanes of the first decode step (inactive lanes
            # compute garbage that is never read)
            rows = [s for s, r in enumerate(eng._slot_req) if r is not None]
            first = lg[rows].clone()
        top2 = lg.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().tolist()
        for s, r in enumerate(eng._slot_req):
            if r is None and seated[s][1] is not None:
                r = seated[s][1]
            if r is not None and len(gaps[r.rid]) < len(r.output_ids):
                gaps[r.rid].append(gap[s])
    return reqs, gaps, first, dict(kernels.LAUNCHES)


def phase_arms(torch, np) -> dict:
    """4 full-width layers serve the same 10 greedy requests on every decode
    arm of each pool kind (bf16, int8, int4): the fused step, the unfused
    split-K and sequential walks the switches rebuild the engine on, and
    every kernel off (``all``).  Each arm launches its own decode kernel and
    no other; its first-step logits are within 0.125 of the plain arm's and
    its greedy streams part from the plain arm's only after a near tie.
    Returns the arms' decode-kernel launches summed over pool kinds."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=4)
    params = llama.init_params(cfg, seed=1, device="cuda")
    env = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
    # logits of two arms: f32 sums in another order and bf16 roundings at
    # other places through 4 layers; measured, then held to this bound
    logit_tol = 0.125
    totals = {k: 0 for k in DECODE_KERNELS + ("paged_decode_tc",
                                              "flash_decode_tc")}
    summary = {}
    for kvq, arms in ARMS.items():
        runs = {}
        for label, tokens, kernel in arms:
            if tokens is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = tokens
            eng = ContinuousBatchingEngine(cfg, params, max_batch=8,
                                           max_seq=2048, block_size=64,
                                           kv_quant=kvq, device="cuda")
            reqs, gaps, first, launches = _serve_greedy(torch, np, eng,
                                                        Request, cfg)
            os.environ.pop(env, None)
            decode = {k: launches[k] for k in DECODE_KERNELS}
            if kernel is None:
                check(not any(launches.values()),
                      f"{kvq} plain arm launched no kernel: {launches}")
            else:
                check(decode[kernel] == cfg.num_hidden_layers
                      * eng.stats["decode_steps"],
                      f"{kvq} {label} arm: {kernel} every layer of every "
                      f"step ({decode})")
                check(launches[f"{kernel}_tc"] == decode[kernel],
                      f"{kvq} {label} arm: every {kernel} launch on the "
                      f"tensor-core route ({launches})")
                if label in ("split_k", "sequential"):
                    totals[f"{kernel}_tc"] += decode[kernel]
                check(not any(v for k, v in decode.items() if k != kernel),
                      f"{kvq} {label} arm: no other decode kernel "
                      f"({decode})")
                check((launches["fused_layer_mlp"] > 0) == (label == "fused"),
                      f"{kvq} {label} arm: the fused MLP rides the fused arm "
                      f"only")
                check(launches["rms_norm"] > 0,
                      f"{kvq} {label} arm launched rms_norm")
                totals[kernel] += decode[kernel]
            runs[label] = (reqs, gaps, first, decode)
            del eng
        rp, gp, fp, _ = runs["plain"]
        res = {}
        for label, (rk, gk, fk, decode) in runs.items():
            if label == "plain":
                continue
            d = (fk - fp).abs().max().item()
            check(d <= logit_tol, f"{kvq} {label}: first decode step logits "
                                  f"within {logit_tol} of the plain arm")
            agree = total = 0
            diverged = []
            for a, b in zip(rk, rp):
                n = min(len(a.output_ids), len(b.output_ids))
                i = next((j for j in range(n)
                          if a.output_ids[j] != b.output_ids[j]), n)
                agree += i
                total += max(len(a.output_ids), len(b.output_ids))
                if i < n:
                    gap = min(gk[a.rid][i], gp[b.rid][i])
                    diverged.append({"rid": a.rid, "token": i,
                                     "top2_gap": gap})
                    check(gap < logit_tol,
                          f"{kvq} {label}: rid {a.rid} diverged at token {i} "
                          f"only after a near tie (gap {gap})")
            res[label] = {"first_step_logits_max_abs_diff": d,
                          "greedy_tokens_agreeing": agree,
                          "greedy_tokens": total, "diverged": diverged,
                          "decode_launches": decode}
        summary[kvq or "bf16"] = res
        emit({"phase": "arms", "kv_quant": kvq,
              "layers": cfg.num_hidden_layers, "logit_tolerance": logit_tol,
              "against": "plain (PADDLE_TPU_TORCH_DISABLE_KERNELS=all)",
              **res})
    del params
    torch.cuda.empty_cache()
    return totals


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_dkv",
                 "flash_attention_dq")

#: flash kernels vs their plain versions (bf16 in and out): both compute in
#: f32 from the same inputs, summed in other orders, then round once to
#: bf16.  Per element one bf16 ulp of the value plus 2^-10 of the tensor's
#: largest value (f32 sums of up to 2048 * rep terms, where dK/dV cancel)
FLASH_REL, FLASH_FLOOR = 2.0 ** -7, 2.0 ** -10


def _flash_err(got, want) -> dict:
    ref = want.float().abs()
    err = (got.float() - want.float()).abs()
    tol = ref * FLASH_REL + ref.max() * FLASH_FLOOR
    return {"max_abs_err": err.max().item(),
            "max_rel_err": (err / ref.clamp(min=1e-3)).max().item(),
            "worst_err_over_tol": (err / tol).max().item()}


def _flash_case(torch, tfa, g, dev, b, sq, skv, hq, hkv, d, causal,
                mask=None, segs=None):
    """Inputs of one flash case: q, k, v, do (bf16 BSHD) and the kwargs of
    the kernels and plain versions."""
    bf16 = torch.bfloat16
    q = torch.randn(b, sq, hq, d, generator=g, device=dev).to(bf16)
    k = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(bf16)
    v = torch.randn(b, skv, hkv, d, generator=g, device=dev).to(bf16)
    do = torch.randn(b, sq, hq, d, generator=g, device=dev).to(bf16)
    kw = dict(mask=None, mb=1, mh=1, segs=segs, scale=d ** -0.5,
              causal=causal)
    if mask is not None:
        kw["mask"], kw["mb"], kw["mh"] = tfa._normalize_mask(mask, b, hq, sq,
                                                             skv)
        if kw["mask"].dtype != torch.bool:
            kw["mask"] = kw["mask"].float()
    return q, k, v, do, kw


def _flash_check(torch, tfa, q, k, v, do, kw, label) -> dict:
    """The three kernels against their plain versions on one case, each on
    both routes; returns the errors by route and the tensors the timing
    reuses."""
    out_p, lse_p = tfa.flash_fwd_ref(q, k, v, **kw)
    delta = (out_p.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk_p, dv_p = tfa.flash_dkv_ref(q, k, v, do, lse_p, delta, **kw)
    dq_p = tfa.flash_dq_ref(q, k, v, do, lse_p, delta, **kw)
    live = lse_p > -1e29
    dead = (~live).transpose(1, 2)
    res = {"dead_rows": int(dead.sum())}
    for route in ROUTES:
        out, lse = tfa.flash_fwd_cuda(q, k, v, route=route, **kw)
        dk, dv = tfa.flash_dkv_cuda(q, k, v, do, lse_p, delta, route=route,
                                    **kw)
        dq = tfa.flash_dq_cuda(q, k, v, do, lse_p, delta, route=route, **kw)
        torch.cuda.synchronize()
        r = res[route] = {
            "fwd": _flash_err(out, out_p),
            "lse_max_abs_err": (lse - lse_p)[live].abs().max().item(),
            "dkv": {"dk": _flash_err(dk, dk_p), "dv": _flash_err(dv, dv_p)},
            "dq": _flash_err(dq, dq_p)}
        worst = max(r["fwd"]["worst_err_over_tol"],
                    r["dkv"]["dk"]["worst_err_over_tol"],
                    r["dkv"]["dv"]["worst_err_over_tol"],
                    r["dq"]["worst_err_over_tol"])
        check(worst <= 1.0, f"flash {label} ({route}): kernels within "
                            f"tolerance of the plain versions (worst "
                            f"err/tol {worst})")
        check(r["lse_max_abs_err"] <= 1e-4 and bool(
            (lse[~live] == lse_p[~live]).all()), f"flash {label} "
                                                 f"({route}): lse")
        # rows with nothing to attend: out and dq exactly 0, lse -1e30
        if dead.any():
            check(bool((out[dead] == 0).all() and (dq[dead] == 0).all()),
                  f"flash {label} ({route}): fully masked rows are "
                  f"exactly 0")
    return res, (lse_p, delta)


def _route_errs(r: dict, part: str) -> dict:
    """One route's errors of the forward, of dK/dV (the worse of dk and
    dv) or of dQ, from ``_flash_check``."""
    if part in ("fwd", "dq"):
        return r[part]
    return {key: max(r["dkv"]["dk"][key], r["dkv"]["dv"][key])
            for key in r["dkv"]["dk"]}


def phase_flash_kernels(torch) -> dict:
    """The three flash kernels against their plain versions: timed at the
    training shape, then correctness-only on ragged, sq != skv, masked and
    packed cases.  Returns name -> numbers for the kernels line."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    b, s, hq, hkv, d = 2, 2048, 32, 8, 128
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()

    q, k, v, do, kw = _flash_case(torch, tfa, g, dev, b, s, s, hq, hkv, d,
                                  True)
    res, (lse, delta) = _flash_check(torch, tfa, q, k, v, do, kw,
                                     "train shape")
    # the work this data needs: causal pairs, 4/8/6 d-long multiply-adds
    # (2 flops) a pair for fwd (s, pv), dK/dV (s, dp, dv, dk), dQ (s, dp, dq)
    pairs = b * hq * s * (s + 1) // 2
    el = 2                                           # bf16 bytes
    qb, kvb, rowb = b * s * hq * d * el, b * s * hkv * d * el, b * hq * s * 4
    bounds = {"fwd": bound_ms(qb + 2 * kvb + qb + rowb, 4 * d * pairs),
              "dkv": bound_ms(2 * qb + 2 * kvb + 2 * rowb + 2 * kvb,
                              8 * d * pairs),
              "dq": bound_ms(2 * qb + 2 * kvb + 2 * rowb + qb, 6 * d * pairs)}
    # yardsticks: PyTorch's SDPA in BHSD (at sq == skv its bottom-right
    # causal is the kernels' top-left), forward, and its whole backward
    # (no single call computes dK/dV or dQ alone)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_forward():
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_fwd = time_ms(torch, lib_forward, flush=flush)
    out_t = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    do_t = do.transpose(1, 2).contiguous()
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), do_t, retain_graph=True), flush=flush)
    del out_t
    # each kernel on the route the rule picks (the tensor cores) and,
    # timed beside it on the same inputs, the CUDA-core route
    timed = {
        "fwd": (lambda r: lambda: tfa.flash_fwd_cuda(q, k, v, route=r, **kw),
                lambda: tfa.flash_fwd_ref(q, k, v, **kw), lib_fwd),
        "dkv": (lambda r: lambda: tfa.flash_dkv_cuda(q, k, v, do, lse, delta,
                                                     route=r, **kw),
                lambda: tfa.flash_dkv_ref(q, k, v, do, lse, delta, **kw),
                lib_bwd),
        "dq": (lambda r: lambda: tfa.flash_dq_cuda(q, k, v, do, lse, delta,
                                                   route=r, **kw),
               lambda: tfa.flash_dq_ref(q, k, v, do, lse, delta, **kw),
               lib_bwd)}
    out = {}
    for part, (kern, plain, lib) in timed.items():
        name = {"fwd": "flash_attention_fwd", "dkv": "flash_attention_dkv",
                "dq": "flash_attention_dq"}[part]
        errs = _route_errs(res["tc"], part)
        bnd, by = bounds[part]
        routes = {"route": "tc (flash_route)",
                  "cuda_core": {"ms": time_ms(torch, kern("cc"), flush=flush),
                                **_route_errs(res["cc"], part)}}
        out[name] = {
            "shape": {"b": b, "sq": s, "skv": s, "hq": hq, "hkv": hkv,
                      "d": d, "dtype": "bfloat16", "causal": True},
            **errs, "tolerance": "|d| <= 2^-7|ref| + 2^-10 max|ref| (f32 "
                                 "order, one bf16 rounding)",
            "ms": time_ms(torch, kern("tc"), flush=flush),
            "plain_ms": time_ms(torch, plain, flush=flush),
            "library_ms": lib,
            "library_call": ("scaled_dot_product_attention forward"
                             if part == "fwd" else
                             "scaled_dot_product_attention backward: "
                             "dq+dk+dv together"),
            "bound_ms": bnd, "bound_by": by, "causal_pairs": pairs,
            **routes}
        emit({"phase": "kernel", "name": name, **out[name]})
    del q, k, v, do, lse, delta, qt, kt, vt, do_t

    # correctness-only cases
    cases = []
    cases.append(("ragged_1000", dict(b=2, sq=1000, skv=1000, causal=True)))
    q_ids = torch.randint(0, 3, (1, 700), generator=g, device=dev) \
        .sort(-1).values.int()
    q_ids[:, -10:] = 99                   # q rows that match no kv segment
    kv_ids = torch.randint(0, 3, (1, 1000), generator=g, device=dev) \
        .sort(-1).values.int()
    cases.append(("sq_ne_skv_causal_dead_rows",
                  dict(b=1, sq=700, skv=1000, causal=True,
                       segs=(q_ids.contiguous(), kv_ids.contiguous()))))
    bool_mask = torch.rand(2, 1, 512, 512, generator=g, device=dev) > 0.3
    bool_mask[1, 0, 7] = False            # one fully masked row
    cases.append(("bool_mask", dict(b=2, sq=512, skv=512, causal=False,
                                    mask=bool_mask)))
    add_mask = torch.randn(1, hq, 512, 512, generator=g, device=dev) * 2
    cases.append(("additive_mask", dict(b=1, sq=512, skv=512, causal=True,
                                        mask=add_mask)))
    seg = torch.randint(0, 4, (2, 1024), generator=g, device=dev) \
        .sort(-1).values.int().contiguous()
    cases.append(("segment_ids", dict(b=2, sq=1024, skv=1024, causal=True,
                                      segs=(seg, seg))))
    small = {}
    for label, c in cases:
        qq, kk, vv, dd, kw = _flash_case(
            torch, tfa, g, dev, c["b"], c["sq"], c["skv"], hq, hkv, d,
            c["causal"], mask=c.get("mask"), segs=c.get("segs"))
        r, _ = _flash_check(torch, tfa, qq, kk, vv, dd, kw, label)
        small[label] = {"dead_rows": r["dead_rows"], **{
            f"worst_err_over_tol_{route}": max(
                r[route]["fwd"]["worst_err_over_tol"],
                r[route]["dq"]["worst_err_over_tol"],
                r[route]["dkv"]["dk"]["worst_err_over_tol"],
                r[route]["dkv"]["dv"]["worst_err_over_tol"])
            for route in ROUTES}}
    check(small["sq_ne_skv_causal_dead_rows"]["dead_rows"] > 0
          and small["bool_mask"]["dead_rows"] > 0,
          "the dead-row cases have rows with nothing to attend")
    emit({"phase": "flash_cases", "cases": small})
    del scratch
    torch.cuda.empty_cache()
    return out


#: device-kernel name fragments of a train step -> group
_TRAIN_GROUPS = (("flash_fwd_tc_kernel", "flash_fwd_tc"),
                 ("flash_dkv_tc_kernel", "flash_dkv_tc"),
                 ("flash_dq_tc_kernel", "flash_dq_tc"),
                 ("flash_fwd_kernel", "flash_fwd"),
                 ("flash_dkv_kernel", "flash_dkv"),
                 ("flash_dq_kernel", "flash_dq"),
                 ("rms_norm_kernel", "rms_norm"),
                 ("gemm", "matmul"), ("gemv", "matmul"),
                 ("cutlass", "matmul"), ("sm90_xmma", "matmul"),
                 ("nvjet", "matmul"))


def _device_groups(torch, prof, groups_of) -> tuple[dict, float, dict]:
    """Device microseconds by group from a profile, their total, and the
    largest 'other' kernels."""
    groups: dict[str, float] = {}
    other: dict[str, float] = {}
    total = 0.0
    cuda_kind = torch.autograd.DeviceType.CUDA
    for evt in prof.key_averages():
        if getattr(evt, "device_type", cuda_kind) != cuda_kind:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if not dev_us:
            continue
        total += dev_us
        name = evt.key.lower()
        group = next((gr for frag, gr in groups_of if frag in name), "other")
        groups[group] = groups.get(group, 0.0) + dev_us
        if group == "other":
            key = evt.key[:60]
            other[key] = other.get(key, 0.0) + dev_us
    return groups, total, other


def phase_train(torch, np) -> dict:
    """Llama-3-8B widths cut to 4 layers (AdamW keeps ~16 bytes a parameter:
    32 layers' 8.0B would need ~130 GB, 4 layers' 1.92B fit in 80 GB), one
    batch of 2 x 2048 seeded tokens, full recompute, 5 steps."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=4)
    L, b, s, steps = cfg.num_hidden_layers, 2, 2048, 5
    os.environ["PADDLE_TPU_REMAT"] = "full"
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(cfg, seed=3, device="cuda")
    train_step, opt_init = llama.build_train_step(cfg)
    opt = opt_init(params)
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")
    torch.cuda.synchronize()
    kernels.reset_counters()
    calls0 = (tfa.KERNEL_CALLS, tfa.FALLBACK_CALLS)
    losses, gnorms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, opt = train_step(params, opt, ids, labels)
        losses.append(loss.item())          # synchronizes
        gnorms.append(opt["gnorm"].item())
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    fallbacks = tfa.FALLBACK_CALLS - calls0[1]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"losses {losses} and gnorms {gnorms} finite")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.5,
          f"step-1 loss {losses[0]} near ln(V) = "
          f"{math.log(cfg.vocab_size)}")
    check(losses[-1] < losses[0], f"the loss falls: {losses}")
    # every forward, dK/dV and dQ launch took the tensor-core route
    want = {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_fwd_tc": 2 * L * steps,
            "flash_attention_dkv": L * steps,
            "flash_attention_dkv_tc": L * steps,
            "flash_attention_dq": L * steps,
            "flash_attention_dq_tc": L * steps,
            "rms_norm": (4 * L + 1) * steps}
    for name, n in want.items():
        check(launches[name] == n, f"{name} launches {launches[name]} == "
                                   f"{n} (full recompute, {steps} steps)")
    check(fallbacks == 0, f"no composed-attention fallback ({fallbacks})")
    step_s = statistics.median(times[1:])
    tok_s = b * s / step_s
    flops_tok = llama.flops_per_token(cfg) + llama.attn_flops_per_token(
        cfg, s)
    res = {"phase": "train", "model": "llama3_8b widths, 4 layers",
           "params": llama.count_params(params), "batch": b, "seq": s,
           "remat": "full", "steps": steps, "losses": losses,
           "gnorms": gnorms, "step_s": times, "step_ms_median_2_5":
           step_s * 1e3, "tokens_per_s": tok_s,
           "mfu_excluding_recompute": flops_tok * tok_s / BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "flash_fallback_calls": fallbacks,
           "launches_per_step": {k: v // steps for k, v in want.items()}}
    emit(res)

    # one profiled step: device time by kernel group, busy share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, params, opt = train_step(params, opt, ids, labels)
        loss.item()
        wall = time.perf_counter() - t0
    groups, total, other = _device_groups(torch, prof, _TRAIN_GROUPS)
    emit({"phase": "train_profile", "wall_ms": wall * 1e3,
          "device_ms": ({k: v / 1e3 for k, v in sorted(groups.items())}
                        if total else "not measured"),
          "device_ms_total": total / 1e3 if total else None,
          "device_busy_share": total / 1e6 / wall if total else None,
          "other_top_ms": {k: v / 1e3 for k, v in sorted(
              other.items(), key=lambda kv: -kv[1])[:10]}})
    del params, opt, loss
    os.environ.pop("PADDLE_TPU_REMAT", None)
    torch.cuda.empty_cache()
    return launches


def phase_train_end_to_end(torch, np) -> None:
    """2 full-width layers: loss, gradient norm and every gradient leaf with
    the kernels and with every kernel disabled (flash -> the composed
    oracle, rms_norm -> its plain version), from the same parameters and
    batch."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=2)
    b, s = 2, 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")
    env = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
    # tolerances: bf16 activations rounded in other places (the flash
    # kernels round attention once from f32; the composed path rounds the
    # same f32 math at another point) through 2 layers forward and back.
    # The loss averages 4096 positions (|d| within 2^-8 of ~12); gnorm and
    # each leaf's max error relative to the leaf's max within a few bf16
    # ulps (2^-5)
    loss_tol, gnorm_rel_tol, leaf_rel_tol = 2.0 ** -8 * 12, 2.0 ** -5, \
        2.0 ** -5
    runs = {}
    for label, disable in (("kernels", None), ("plain", "all")):
        if disable is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = disable
        params = llama.init_params(cfg, seed=7, device="cuda")
        kernels.reset_counters()
        loss, grads = llama.loss_and_grads(cfg, params, ids, labels)
        gnorm = llama.global_norm(grads).item()
        launches = dict(kernels.LAUNCHES)
        os.environ.pop(env, None)
        if disable is None:
            check(all(launches[k] > 0 for k in FLASH_KERNELS + (
                "flash_attention_fwd_tc", "flash_attention_dkv_tc",
                "flash_attention_dq_tc", "rms_norm")),
                  f"kernel run launched the train kernels: {launches}")
        else:
            check(all(v == 0 for v in launches.values()),
                  f"plain run launched no kernel: {launches}")
        runs[label] = (loss.item(), gnorm, grads, launches)
        del params
    (lk, gk, dk, lnk), (lp, gp, dp, _) = runs["kernels"], runs["plain"]
    leaf_err = [((a.float() - b_.float()).abs().max()
                 / b_.float().abs().max()).item() for a, b_ in zip(dk, dp)]
    check(abs(lk - lp) <= loss_tol, f"loss {lk} vs {lp} within {loss_tol}")
    check(abs(gk - gp) <= gnorm_rel_tol * gp,
          f"gnorm {gk} vs {gp} within {gnorm_rel_tol} relative")
    check(max(leaf_err) <= leaf_rel_tol,
          f"gradient leaves within {leaf_rel_tol} of their max: {leaf_err}")
    emit({"phase": "train_end_to_end", "layers": cfg.num_hidden_layers,
          "loss": {"kernels": lk, "plain": lp}, "loss_tolerance": loss_tol,
          "gnorm": {"kernels": gk, "plain": gp},
          "gnorm_rel_tolerance": gnorm_rel_tol,
          "leaf_max_err_over_leaf_max": leaf_err,
          "leaf_tolerance": leaf_rel_tol, "kernel_launches": lnk})
    del runs, dk, dp
    torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    seeds = None
    if argv:
        if len(argv) != 2 or argv[0] != "--serve-sweep":
            print("usage: chip_smoke.py [--serve-sweep FIRST-LAST]",
                  file=sys.stderr)
            return 2
        first, last = (int(x) for x in argv[1].split("-"))
        seeds = list(range(first, last + 1))
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from paddle_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, smi = phase_device(torch)
    phase_build(kernels)
    if seeds is not None:
        serve_sweep(torch, np, smi, seeds)
        return 0
    measured = phase_kernels(torch)
    measured.update(phase_flash_kernels(torch))
    # the paged kernels' line entries: the decode walks' int8 numbers (the
    # quantized serving path's pools), the multi-row walks' bf16 numbers
    measured.update({k: v["bf16" if k in ("paged_prefill", "paged_verify")
                          else "int8"]
                     for k, v in phase_paged_kernels(torch).items()})
    launches, q8_launches, cs_launches = phase_serve(torch, np, smi)
    arm_launches = phase_arms(torch, np)
    train_launches = phase_train(torch, np)
    phase_train_end_to_end(torch, np)
    # each kernel's launches on the main paths that run it: the fp and the
    # int8 serve, the decode arms (the unfused walks), the train step
    for k in ("rms_norm", "fused_layer_mlp", "gumbel_noise",
              "fused_quant_decode_step_tc", "fused_decode_step_tc"):
        launches[k] += q8_launches[k] + cs_launches[k]
    # the unfused walks' entries are the tensor-core kernel, the route
    # every launch of the sequential and the split-K arms took
    launches.update({k: arm_launches[f"{k}_tc"] for k in ("paged_decode",
                                                        "flash_decode")})
    # the flash entries are the tensor-core kernels, the route every
    # launch of the train step took; the multi-row walks' likewise of the
    # chunked + speculative serves, the fused decode steps' of the serves
    launches.update({k: train_launches[f"{k}_tc"] for k in FLASH_KERNELS})
    launches.update({k: launches[f"{k}_tc"] for k in (
        "fused_decode_step", "fused_quant_decode_step")})
    launches.update({k: cs_launches[f"{k}_tc"] for k in ("paged_prefill",
                                                         "paged_verify")})
    launches["rms_norm"] += train_launches["rms_norm"]
    pa = "paddle_tpu/ops/pallas/paged_attention.py"
    fa = "paddle_tpu/ops/pallas/flash_attention.py"
    sources = {"rms_norm": ("rms_norm.cu", "paddle_tpu/ops/pallas/"
                                           "rms_norm.py:20"),
               "fused_decode_step": ("fused_decode_tc.cu", f"{pa}:1377"),
               "fused_layer_mlp": ("fused_mlp.cu", f"{pa}:2020"),
               "flash_attention_fwd": ("flash_fwd_tc.cu", f"{fa}:173"),
               "flash_attention_dkv": ("flash_bwd_tc.cu", f"{fa}:295"),
               "flash_attention_dq": ("flash_bwd_tc.cu", f"{fa}:344"),
               # no TPU kernel: the reference's jax.random.categorical
               # draw, which XLA compiles into its decode program
               "gumbel_noise": ("gumbel.cu", "paddle_tpu/inference/"
                                "serving.py:1246"),
               "paged_decode": ("paged_decode_tc.cu", f"{pa}:412"),
               "flash_decode": ("paged_decode_tc.cu", f"{pa}:594"),
               "fused_quant_decode_step": ("fused_decode_tc.cu",
                                           f"{pa}:1720"),
               "paged_prefill": ("paged_prefill_tc.cu", f"{pa}:1126"),
               "paged_verify": ("paged_prefill_tc.cu", f"{pa}:927")}
    line = []
    for name, (src, replaces) in sources.items():
        m = measured[name]
        line.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                     "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                     "bound_by": m["bound_by"],
                     "library_ms": m["library_ms"]})
    emit({"kernels": line})
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
