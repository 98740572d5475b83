#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-sweep 3-14
    python3 chip_smoke.py --only pipeline

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
   and the sampler timed alone; then the same weights' first 8 layers
   (``CHUNKED_SPEC_LAYERS``) with chunked prefill
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
   ``PADDLE_TPU_TORCH_DISABLE_KERNELS=all``;
10. prefix cache (run after phase 6): Llama-3-8B at full width and depth
    serves 16 requests, four 1024-token system prompts each shared by
    four requests with tails of their own, two of them repeating a
    block-aligned prompt (copy-on-write), bucketed and chunked, on bf16
    and int8 pools, with the cache on and off, and on a 64-page pool where
    LRU eviction fires (its first ``CHUNKED_SPEC_LAYERS`` layers): launch
    counts prove the path (rms_norm, the fused
    decode step, the fused MLP, chunked the prefill walk), the on and off
    runs' logit rows agree within ``SERVE_LOGIT_TOL`` (int8 chunked:
    ``PREFIX_INT8_CHUNKED_TOL``), and the evicting pool's cache statistics
    repeat exactly with every kernel off; the prefill tokens saved, the
    mean TTFT on and off, and tokens over the whole wall;
11. chaos: 4 full-width layers serve 12 requests under a fault plan with
    one clause of each kind (``CHAOS_PLAN``): only the ``nan_logits`` and
    ``slot_error`` victims fail, one dispatch fault is retried, untouched
    requests emit the fault-free run's tokens exactly and preempted ones
    pass the logit check; a JSON snapshot taken mid-serve restores on a
    fresh engine whose streams pass the logit check; one decode step timed
    with and without the NaN/inf guard; each FAILED victim left a flight
    dump holding its fault record;
12. weight-only quant: Llama-3-8B widths, random bf16 weights (phase 6's
    seed): layer 0's codes, scales and dequantized matrices made on the
    card equal the CPU's bit for bit; the resident layer-weight bytes
    bf16 / int8 / int4; phase 6's 12 requests through a 32-layer
    ``quant='int8'`` bucketed serve over bf16 pools and a 32-layer
    ``quant='int4'`` chunked (128) serve over int8 pools, launch counts
    proving every layer of every decode step ran B7 / B11 on the tensor
    cores, every mixed step's the prefill walk, ``rms_norm`` every layer,
    the fused MLP never; decode tokens/s, a profile of four decode steps
    and the dequantize of a step's weights timed alone, against the bound
    (weight bytes over 3.35 TB/s); the first decode step's logits int8
    against bf16 weights (reported); both configurations on the first
    ``CHUNKED_SPEC_LAYERS`` layers with the kernels and with every kernel
    off, every logit row within ``SERVE_LOGIT_TOL``;
13. observability: 4 full-width layers serve phase 6's 12 requests with
    observability on, ``PADDLE_TPU_METRICS=0``, and both switches off:
    identical tokens and equal synchronizing-call counts
    (``torch.cuda.set_sync_debug_mode("warn")``), every schema counter in
    the exposition with its value, queued / prefill / decode spans for
    every request in the exported chrome trace, one step-histogram
    observation a step; the wall per step of each run;
14. host KV tier: Llama-3-8B at full width and depth serves phase 10's
    shared-prefix stream on its 64-page pool with the tier on
    (``PADDLE_TPU_HOST_TIER_MIB`` 1024) and off, bucketed on bf16 and
    chunked on int8 pools, and the bf16 tier-on serve again with every
    kernel off: the tier-on runs demote, hit and restore, compute fewer
    prefill tokens, launch the path's kernels; the on and off runs' logit
    rows agree within ``SERVE_LOGIT_TOL`` (int8 chunked
    ``PREFIX_INT8_CHUNKED_TOL``); the kernels-off run repeats the prefix
    and tier statistics exactly; one page of each pool kind goes out and
    back into a recycled, overwritten page byte for byte; the revisiting
    requests' mean TTFT on and off and one bf16 page's D2H / H2D GB/s;
15. async host runtime: 4 full-width layers, every feature on, stepped
    with ``PADDLE_TPU_ASYNC_HOST`` 1 and 0 in two rounds in turns: the
    same tokens and synchronizing calls, ``journal()`` equal to
    ``snapshot()`` mid-serve, one journal flush a launched step (none
    off), and phase 18's guard around every window (as many as
    ``host_overlap_steps`` on, one a launched step off); the host-gap
    histogram's mean and the wall a step on and off;
16. fleet: two Llama-3-8B replicas (32 layers, random bf16 weights)
    behind one ``FleetRouter``, sharing one weight set (the bytes the
    fleet adds are its two KV pools: printed and gated); phase 10's
    stream routed by prefix affinity (every later request of a system
    prompt on its chain's replica), then again with replica 1 crashed
    mid-decode (one failover, the replayed streams' logit rows within
    ``SERVE_LOGIT_TOL`` of the uninterrupted fleet's); launch counts
    summed over the replicas prove B1, B7, B8 and the Gumbel kernel on
    every step; the shared host tier re-admits on replica 1 a chain
    replica 0 demoted; then at 4 layers a permanent stall (hedged, then
    DEAD at ``stall_dead_steps``), a drain, and a chunked chaos serve with
    ``PADDLE_TPU_ENGINE_AUDIT=1`` (no invariant breaks; B9 too; the
    audit's host ms a fleet step).
17. tensor-parallel serving: B7, B8 and B9 at one rank's shapes of
    Llama-3-8B at tp=2 (16 q / 4 kv heads, 7168 ffn columns) against their
    plain versions; the one-card engine (32 layers, random bf16 weights
    from phase 6's seed, made layer by layer) serves phase 6's 12 requests
    bucketed and chunked (128-row chunks, a token budget of 8 x 128);
    then two ranks, each a spawned process on the one card in a gloo group
    (NCCL refuses two ranks on one device; gloo stages each all-reduce
    through the host), each making the same weights into a tree on the
    host that its engine slices onto the card, serve the same requests
    the same two ways: every step of every
    serve launches B1, B7 (tensor cores), B8, the Gumbel kernel where it
    drew and B9 (chunked) in every layer, and at tp=2 exactly 2 x 32
    all-reduces a forward; both ranks emit the same tokens and logit rows
    bit for bit, and on identical histories their rows are within
    ``SERVE_LOGIT_TOL`` of the one-card engine's; each rank's layer
    weights and pools are half the one-card engine's; the gate's control
    (both ranks skipping the last layer's MLP all-reduce, 4 tokens a
    request) reads above that tolerance; the wall a step of each and the
    decode step's all-reduce alone.
18. host contracts: (a) the static gate, ``python -m
    paddle_tpu_torch.analysis --host --json`` run in this process on this
    checkout: exit 0, the raw finding count equal to ``budgets.toml``'s
    ceiling, no undeclared transition, dead edge or protocol finding, the
    pass's seconds; (b) its dynamic twin on the card: before the first
    serve, ``_install_overlap_guard`` wraps
    ``ContinuousBatchingEngine._host_overlap`` (in this script only, and
    in each of phase 17's rank processes) so that every window runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing CUDA call
    in any window of any serve of phases 6-17 raises.  Gates: a self-test
    (``.item()`` of a CUDA tensor inside the guarded real method) raised;
    no window raised anywhere else; every serve phase guarded windows,
    phase 15 as many as ``host_overlap_steps`` in its async-on serves, and
    each rank of phase 17 its own; prints the windows guarded a phase.
19. dense serving: the dense slot-cache engine (``paged=False``) and the
    ``GenerationEngine`` at Llama-3-8B width (``phase_dense``).
20. MoE (DeepSeekMoE-16B widths: h 2048, 16 heads of 128, 64 routed
    experts of 1408, 2 shared, top-6, vocabulary 102400, random bf16
    weights): (a) one layer's routed FFN on 2 x 2048 tokens through the
    dense, sort and ragged engines: dense and sort give every (token, k)
    pair the same expert slot and outputs within the MLP's tolerance,
    ragged equals sort at a capacity that drops nothing, each engine
    timed; (b) ``MOE_LAYERS`` layers take 5 AdamW steps of 2 x 2048 tokens
    on the sort engine under full recompute: the loss falls, the launch
    counts prove B1 and the three flash kernels (tensor cores) in every
    layer; step time, tokens/s, MFU over the active parameters, peak
    memory, a profile of one step by group (expert matmuls, dispatch,
    other matmuls, flash, AdamW); (c) ``MOE_E2E_LAYERS`` layers' loss,
    gradient norm and every gradient leaf with the kernels and with every
    kernel off, the plain run replaying the kernel run's routing.
21. DiT (DiT-XL/2 at full depth: 28 blocks, h 1152, 16 heads of 72,
    32x32x4 latents, patch 2): (a) 5 AdamW steps of the rectified-flow
    loss on 32 seeded latents: the step-1 loss 2 (a fresh model outputs
    0), falling; every block's flash forward, dK/dV and dQ on the
    CUDA-core route (head_dim 72), no tensor-core launch; step time,
    images/s, tokens/s, MFU, peak memory, a profile of one step; (b)
    ``DIT_E2E_BLOCKS`` blocks with every leaf random, kernels against
    every kernel off as 20 (c); (c) the three flash kernels at DiT's shape
    (b 32, s 256, non-causal) against their plain versions, timed beside
    SDPA and the bound: the kernels line's ``flash_attention_*_cc``.
22. hybrid-parallel training (``phase_dist_train``; Llama-3-8B widths,
    ``DIST_LAYERS`` = 2 layers, 1.487B parameters, phase 8's 2 x 2048
    seeded tokens, full recompute): the three flash kernels at a rank's
    16 / 4 heads and B1 at a rank's 2048 rows against their plain
    versions; the one-card ``build_train_step(cfg)`` as the reference
    (its step-1 gradients, two steps' loss and gnorm); then gloo ranks
    on the one card, each holding its shard of ``param_specs``: two
    ranks at mp=2, sharding=2, dp=2, sep=2 ring and sep=2 Ulysses in
    turn, then four at sharding=2 x mp=2.  Gates a rank and a mesh: the
    loss and gnorm of both steps and the step-1 gradient shards of
    ``DIST_GRAD_LEAVES`` within phase 9's tolerances of the one-card
    step's; every leaf two ranks hold equal bit for bit after step 2;
    launches exact (B1 4L + 1, flash 2L / L / L on the tensor cores, none
    under the ring) and the collectives as ``_dist_expected`` predicts;
    the ranks' peak memory together below the card's.  Reports each
    rank's step ms, the collectives' wall share and GB, peak GB.
23. the pipeline axis (``phase_pipeline``; Llama-3-8B widths,
    ``PP_LAYERS`` = 4 layers, 4 x 1024 seeded tokens in ``PP_MICRO`` = 4
    microbatches, full recompute): the three flash kernels at a
    microbatch's 32 / 8 and 16 / 4 heads and B1 at its 1024 rows against
    their plain versions; the one-card step as the reference; then gloo
    ranks on the one card, each holding its stage of ``param_specs(pp=
    True)``: two at pp=2 under gpipe, 1f1b, vpp (2 chunks) and zb in turn,
    four at pp=2 x mp=2 under 1f1b.  Gates a rank and a mesh as phase
    22's (loss, gnorm, gradient shards, bit-equal shared leaves, memory),
    launches exact by the clock (``_pp_launches``), collectives and bytes
    as ``_pp_expected`` predicts, and each stage's executed sub-ticks
    against the oracles (``_pp_order``).

The line before the last lists every kernel with its numbers; the last line
is ``{"ok": true, "device": {...}}``.  ``--serve-sweep FIRST-LAST`` runs
only phases 1, 2 and phase 6's chunked + speculative serves at each
request seed in the range (the script's own run uses seed 3), reporting
each serve's largest logit difference against ``SERVE_LOGIT_TOL`` without
failing on it; ``--prefix-sweep FIRST-LAST`` likewise runs phase 10's
int8 chunked serve with the cache on and off at each request seed (the
script's own run uses seed 5); ``--tier-probe FIRST-LAST`` serves phase
14's bucketed bf16 stream at each request seed four times in turns (tier
off, on, on, off) and reports each serve's
wall, prefill, decode and demotion seconds and TTFT; ``--only
{dist_train,pipeline}`` runs phases 1, 2 and that phase alone.  A line ``{"phase": "seconds", ...}``
before the kernels line gives each phase's time.  Without a CUDA card, or
without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

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
                                   paged=True, block_size=64,
                                   kv_quant=kv_quant, device="cuda")
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
          "prefill_time_s": eng.prefill_time_s,
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
    kinds, from the same weights' first ``CHUNKED_SPEC_LAYERS`` layers.
    Returns the launches of the fp serve,
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
    cfg, params = _first_layers(cfg, params, CHUNKED_SPEC_LAYERS)
    for kvq in (None, "int8"):
        launches, _ = _serve_chunked_spec(torch, np, cfg, params, kvq, smi)
        for k, v in launches.items():
            cs[k] = cs.get(k, 0) + v
    del params
    torch.cuda.empty_cache()
    return fp, q8, cs


#: the depth of phase 6's chunked + speculative serves (the model's first
#: layers), cut from 32 to keep the script's time when phases 10-11 came
CHUNKED_SPEC_LAYERS = 8


def _first_layers(cfg, params, n: int) -> tuple:
    """The model cut to its first ``n`` layers (views of the stacked layer
    weights)."""
    return (dataclasses.replace(cfg, num_hidden_layers=n),
            {**params, "layers": {k: v[:n]
                                  for k, v in params["layers"].items()}})


def serve_sweep(torch, np, smi: str, seeds: list[int]) -> None:
    """``--serve-sweep``: the chunked + speculative serve's logit check of
    phase 6 at each request seed, on bf16 and int8 pools, each line
    reporting the largest logit difference against ``SERVE_LOGIT_TOL``
    without failing on it (the readings the bound is set from)."""
    from paddle_tpu_torch.models import llama

    cfg, params = _first_layers(
        llama.LlamaConfig.llama3_8b(),
        llama.init_params(llama.LlamaConfig.llama3_8b(), seed=0,
                          device="cuda"), CHUNKED_SPEC_LAYERS)
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
#: 0.62598 -> 0.8125).  The chunked + speculative serves have run
#: ``CHUNKED_SPEC_LAYERS`` layers since, held to the same bounds.
SERVE_LOGIT_TOL = {None: 0.4375, "int8": 0.8125}
#: phase 10's int8 chunked serve, cache on against cache off, every greedy
#: request: the same rule (the largest reading times 1.25, rounded up to a
#: multiple of 1/32) over ``--prefix-sweep 5-10`` on one H100 ("NVIDIA
#: H100 80GB HBM3, 700.00 W"): 0.81641 0.98047 0.80273 0.72231 0.93555
#: 0.67188 at request seeds 5..10 (max 0.98047 -> 1.25).  The cache moves
#: which of a request's tokens a mixed step computes (the ragged prefill
#: walk over int8 pages, the eager multi-row requantize) and which a fused
#: decode step does (B11), since a hit's prefill is shorter: seed 5's
#: largest reading, 0.81641, is rid 7's, a request that reads no cached
#: page and streams the same chunks with the cache on and off.
PREFIX_INT8_CHUNKED_TOL = 1.25


@contextlib.contextmanager
def _spied(torch, engines, rows=None):
    """Wrap each engine's ``step``, ``_admit`` and ``_sample_tokens`` and
    the serving module's ``lm_head_logits`` (the engines themselves run
    unchanged).  The head keeps every row an engine scores: a decode
    step's [B, V], a mixed step's emit rows [B, V], a verify step's
    [B, Q, V] (row t chose the token t after the pending one; rows past
    the accepted run scored rejected drafts and are not kept).  After each
    step, each request of ``rows`` (rid -> list; greedy requests only) that
    the step extended gets the rows that chose its new tokens, at the slot
    it held: a request retired by the step held its slot before it, one
    admitted by it from the admission on (a resumed request may bank its
    last token and retire in that step).  Yields, an engine each, the
    steps whose sampler was called with sampled lanes (one Gumbel launch
    each)."""
    from paddle_tpu_torch.inference import serving

    head = serving.lm_head_logits
    calls = []
    sampled = [0] * len(engines)

    def cap(cfg, params, x):
        z = head(cfg, params, x)
        calls.append(z)
        return z

    for i, eng in enumerate(engines):
        step, admit, sample = eng.step, eng._admit, eng._sample_tokens
        slot_of: dict = {}

        def seat(eng=eng, slot_of=slot_of):
            slot_of.update({q.rid: s for s, q in enumerate(eng._slot_req)
                            if q is not None})

        def admit_spy(admit=admit, seat=seat):
            admit()
            seat()

        def sample_spy(*args, sample=sample, i=i):
            sampled[i] += args[5] is not None
            return sample(*args)

        def step_spy(eng=eng, step=step, seat=seat, slot_of=slot_of):
            held = dict(eng._reqs)
            before = {rid: len(q.output_ids) for rid, q in held.items()}
            slot_of.clear()
            seat()
            calls.clear()
            out = step()
            for rid, q in held.items():
                new = len(q.output_ids) - before[rid]
                if new and rows is not None and rid in rows:
                    z = torch.cat([y[slot_of[rid]].reshape(-1, y.shape[-1])
                                   for y in calls])
                    rows[rid].append(z[:new].clone())
            return out

        eng.step, eng._admit, eng._sample_tokens = (step_spy, admit_spy,
                                                    sample_spy)
    serving.lm_head_logits = cap
    try:
        yield sampled
    finally:
        serving.lm_head_logits = head
        for eng in engines:
            del eng.step, eng._admit, eng._sample_tokens


def _serve_stepwise(torch, eng, reqs, steps=None, add=True) -> dict:
    """Serve ``reqs`` step by step; returns rid -> [tokens, V] logits, for
    each greedy request the logit row that chose each of its tokens
    (``_spied``).  ``steps``: stop after that many steps; ``add=False``:
    the requests are queued already (a restore)."""
    for r in reqs if add else ():
        eng.add_request(r)
    rows = {r.rid: [] for r in reqs if r.temperature == 0}
    with _spied(torch, [eng], rows):
        n = 0
        while steps is None or n < steps:
            n += 1
            if not eng.step() and not eng._queue:
                break
    return {rid: torch.cat(v) if v else None for rid, v in rows.items()}


def _logit_check(torch, reqs, rows, ref_reqs, ref_rows) -> dict:
    """The greedy requests of a run against its reference: the tokens agree
    up to index i and differ at i (i = the length when they never part),
    so at every index <= i both runs scored the same context, and the
    largest |z_run - z_ref| over those rows is what the run's numbers
    moved (``worst``: its rid and token; ``per_rid``: each request's).  At
    the parting the reference's top-2 gap is at most twice the difference
    there (else the captured rows are not the ones that chose the tokens:
    checked)."""
    worst, agree, total, parted = 0.0, 0, 0, []
    at, per_rid = None, {}
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
        mine = d.max().item()
        per_rid[a.rid] = mine
        if at is None or mine > worst:
            worst, at = mine, {"rid": a.rid, "token": int(d.argmax())}
        if i < n:
            top2 = zb[i].float().topk(2).values
            gap = (top2[0] - top2[1]).item()
            parted.append({"rid": a.rid, "token": i, "ref_top2_gap": gap,
                           "max_abs_logit_diff": d[i].item()})
            check(gap <= 2 * d[i].item(),
                  f"rid {a.rid} token {i}: the reference's top-2 gap {gap} "
                  f"is at most twice the logit difference {d[i].item()}")
    return {"max_abs_logit_diff": worst, "worst": at, "per_rid": per_rid,
            "greedy_tokens_agreeing": agree, "greedy_tokens": total,
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

    base = dict(max_batch=8, max_seq=2048, paged=True, block_size=64,
                kv_quant=kv_quant, device="cuda")
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
                       "prefill_time_s": ref_eng.prefill_time_s,
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


def make_prefix_requests(Request, np, vocab: int, seed: int = 5):
    """The shared-prefix stream: 4 distinct 1024-token system prompts, each
    shared by 4 requests with a 64-448-token tail of their own; rids 14 and
    15 repeat rid 2's and rid 3's whole prompt, block-aligned (tails of 128
    and 192 tokens), so that their every block is cached when they arrive
    (the copy-on-write path).  64 new tokens a request; rids 9 and 12
    sample (top-p 0.9), the other 14 are greedy."""
    rng = np.random.default_rng(seed)
    # the lengths first: they, not the vocabulary, set the schedule
    tails = [int(n) for n in rng.integers(64, 449, size=14)]
    tails[2], tails[3] = 128, 192
    systems = [rng.integers(0, vocab, size=1024).astype(np.int32)
               for _ in range(4)]
    prompts = [np.concatenate([systems[i % 4],
                               rng.integers(0, vocab, size=tails[i])
                               .astype(np.int32)]) for i in range(14)]
    prompts += [prompts[2].copy(), prompts[3].copy()]
    return [Request(rid=i, prompt_ids=p, max_new_tokens=64,
                    temperature=0.8 if i in (9, 12) else 0.0, top_p=0.9,
                    seed=200 + i) for i, p in enumerate(prompts)]


#: the statistics a prefix-cache serve must repeat exactly with every kernel
#: off (the host's scheduling reads no arithmetic)
PREFIX_STATS = ("prefix_hits", "prefix_blocks_reused", "cow_copies",
                "prefix_evictions", "prefill_tokens_computed",
                "prefill_tokens_cached", "preemptions", "prefills",
                "decode_steps", "mixed_steps")


def _prefix_serve(torch, np, cfg, params, kv_quant, chunked, cache,
                  disable=None, num_blocks=256, stepwise=True,
                  seed=5, tier=False) -> tuple:
    """One serve of the shared-prefix stream at Llama-3-8B width (batch 8,
    max_seq 2048, block 64; by default a pool of 256 pages, every slot's
    whole context, so the cache evicts nothing); returns (engine,
    requests, logit rows or None, launches, wall seconds, schedule): the
    schedule holds ``cow_rids``, the requests that took a copy-on-write
    page, ``chunks``, rid -> the [first position, rows] of each prompt
    chunk the mixed steps streamed for it, ``mixed_decode_rows``, rid ->
    the tokens a mixed step decoded for it (the others came from fused
    decode steps), ``restored_rids``, the requests for which the host KV
    tier restored a page, and ``demote_s``, the host seconds of the tier's
    demotions, whose copies to the host block until done (``tier``: the
    tier on, with a budget of ``TIER_MIB``)."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.ops import kernels

    kw = dict(max_batch=8, max_seq=2048, paged=True, block_size=64,
              kv_quant=kv_quant, enable_prefix_caching=cache,
              num_blocks=num_blocks, enable_host_kv_tier=tier, device="cuda")
    if chunked:
        kw.update(enable_chunked_prefill=True, prefill_chunk=128)
    env = {"PADDLE_TPU_TORCH_DISABLE_KERNELS": disable,
           "PADDLE_TPU_HOST_TIER_MIB": TIER_MIB if tier else None}
    os.environ.update({k: v for k, v in env.items() if v})
    sched = {"cow_rids": [], "chunks": {}, "mixed_decode_rows": {},
             "restored_rids": set(), "demote_s": 0.0}
    try:
        eng = ContinuousBatchingEngine(cfg, params, **kw)
        copy, mixed = eng._copy_page, eng._mixed_impl
        restore, demote = eng._restore_tier_block, eng._demote

        def restore_spy(slot, req, *args):
            n = eng.stats["tier_readmits"]
            ok = restore(slot, req, *args)
            if eng.stats["tier_readmits"] > n:
                sched["restored_rids"].add(req.rid)
            return ok

        def demote_spy(pairs):
            t = time.perf_counter()
            demote(pairs)
            sched["demote_s"] += time.perf_counter() - t

        eng._restore_tier_block, eng._demote = restore_spy, demote_spy

        def copy_spy(dst, src):
            # called by the admission of the queue's head
            sched["cow_rids"].append(eng._queue[0].rid)
            copy(dst, src)

        def mixed_spy(tokens, pos, active, q_lens, *args, **kwargs):
            p, q = pos.tolist(), q_lens.tolist()
            for s, req in enumerate(eng._slot_req):
                if req is None:
                    continue
                if eng._prefill_ids[s] is not None:
                    sched["chunks"].setdefault(req.rid, []).append(
                        [p[s], q[s]])
                else:
                    rows = sched["mixed_decode_rows"]
                    rows[req.rid] = rows.get(req.rid, 0) + 1
            return mixed(tokens, pos, active, q_lens, *args, **kwargs)

        eng._copy_page, eng._mixed_impl = copy_spy, mixed_spy
        reqs = make_prefix_requests(Request, np, cfg.vocab_size, seed)
        kernels.reset_counters()
        t0 = time.perf_counter()
        if stepwise:
            rows = _serve_stepwise(torch, eng, reqs)
        else:
            rows = None
            eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k in env:
            os.environ.pop(k, None)
    for r in reqs:
        check(r.status == "FINISHED" and len(r.output_ids) == 64
              and all(0 <= t < cfg.vocab_size for t in r.output_ids),
              f"prefix serve rid {r.rid}: 64 tokens in the vocabulary")
    check(len(sched["cow_rids"]) == eng.stats["cow_copies"],
          "one copy-on-write admission a copy")
    return eng, reqs, rows, dict(kernels.LAUNCHES), wall, sched


def _tail_chunks_same(on, off) -> dict:
    """rid -> whether the cache-on run streamed its uncached tail in the
    chunks the cache-off run streamed the same positions in (a chunk
    boundary inside a page splits that page's write into two events, and
    on int8 pools each event requantizes the page)."""
    out = {}
    for rid, chunks in on["chunks"].items():
        first = chunks[0][0]
        out[rid] = chunks == [c for c in off["chunks"].get(rid, [])
                              if c[0] >= first]
    return out


def _prefix_launch_check(eng, launches, kv_quant, L) -> None:
    """The path went through its kernels: the input and final norms (B1),
    the pool kind's fused decode step (B7 / B11) on its tensor-core route
    and the fused MLP (B8) in every layer of every decode step, the ragged
    prefill walk (B9) in every layer of every mixed step, and the bucketed
    prefills' and tail prefills' norms in every layer."""
    st = eng.stats
    mixed, prefills = st["mixed_steps"], st["prefills"]
    plain = st["decode_steps"] - mixed
    decode = FUSED_DECODE[kv_quant]
    want = {decode: L * plain, f"{decode}_tc": L * plain,
            "fused_layer_mlp": L * plain, "paged_prefill": L * mixed,
            "paged_prefill_tc": L * mixed,
            "rms_norm": (L + 1) * plain + (2 * L + 1) * (prefills + mixed)}
    for name, n in want.items():
        check(launches[name] == n,
              f"prefix serve {kv_quant}: {name} launches {launches[name]} "
              f"== {n}")
    others = {k: launches[k] for k in DECODE_KERNELS if k != decode}
    check(not any(others.values()), f"no other decode kernel ran: {others}")
    check(launches["gumbel_noise"] > 0, "the sampled lanes drew noise")


def phase_prefix_cache(torch, np, smi: str) -> dict:
    """Llama-3-8B at full width and depth (random bf16 weights from a
    seed) serves the shared-prefix stream bucketed and chunked (chunk 128)
    on bf16 and int8 pools, with the prefix cache on and off, and once on a
    64-page pool where LRU eviction fires (its first
    ``CHUNKED_SPEC_LAYERS`` layers).  Gates: every request finishes;
    the cache-on run's launch counts prove its path (B1, B7 / B11, B8,
    chunked B9); each run takes two copy-on-write pages; every logit row
    the on and the off run scored from the same context agrees within
    ``SERVE_LOGIT_TOL`` (int8 chunked: ``PREFIX_INT8_CHUNKED_TOL``); and
    the evicting pool's serve repeats exactly the same hits, reused
    blocks, copies, evictions and prefill tokens computed with every
    kernel off (``PADDLE_TPU_TORCH_DISABLE_KERNELS=all``).  Prints the
    prefill tokens saved, the mean TTFT on and off and the tokens over the
    whole wall.  Returns the cache-on runs' launches, summed."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_hidden_layers
    total: dict = {}
    for kvq in (None, "int8"):
        for chunked in (False, True):
            eng, reqs, rows, launches, wall, sched = _prefix_serve(
                torch, np, cfg, params, kvq, chunked, True)
            oeng, oreqs, orows, _, owall, osched = _prefix_serve(
                torch, np, cfg, params, kvq, chunked, False)
            _prefix_launch_check(eng, launches, kvq, L)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            st, ost = eng.stats, oeng.stats
            check(st["prefix_hits"] > 0 and ost["prefix_hits"] == 0,
                  "the cache-on run hit, the cache-off run did not")
            check(st["cow_copies"] == 2,
                  f"the two block-aligned repeats copied their last block "
                  f"({st['cow_copies']})")
            logits = _logit_check(torch, reqs, rows, oreqs, orows)
            tol = (PREFIX_INT8_CHUNKED_TOL if kvq is not None and chunked
                   else SERVE_LOGIT_TOL[kvq])
            del rows, orows
            schedule = None
            if chunked:
                schedule = {
                    "tail_chunks_same": _tail_chunks_same(sched, osched),
                    "mixed_decode_rows_on": sched["mixed_decode_rows"],
                    "mixed_decode_rows_off": osched["mixed_decode_rows"]}
            emit({"phase": "prefix_cache", "model": "llama3_8b",
                  "layers": L, "kv_quant": kvq, "chunked": chunked,
                  "nvidia_smi": smi, "requests": len(reqs),
                  "num_blocks": eng.num_blocks,
                  "stats_on": {k: st[k] for k in PREFIX_STATS},
                  "stats_off": {k: ost[k] for k in PREFIX_STATS},
                  "cow_rids": sched["cow_rids"], "schedule": schedule,
                  "prefill_tokens_saved": ost["prefill_tokens_computed"]
                  - st["prefill_tokens_computed"],
                  "mean_ttft_s_on": statistics.mean(r.ttft_s for r in reqs),
                  "mean_ttft_s_off": statistics.mean(r.ttft_s
                                                     for r in oreqs),
                  "tokens_per_wall_s_on": 64 * len(reqs) / wall,
                  "tokens_per_wall_s_off": 64 * len(oreqs) / owall,
                  "wall_s_on": wall, "wall_s_off": owall,
                  "prefill_time_s_on": eng.prefill_time_s,
                  "prefill_time_s_off": oeng.prefill_time_s,
                  "logit_tolerance": tol, **logits,
                  "launches": {k: v for k, v in launches.items() if v}})
            check(logits["max_abs_logit_diff"] <= tol,
                  f"prefix cache {kvq} chunked={chunked}: every logit row "
                  f"the cache-on and -off runs scored from the same context "
                  f"within {tol} (max {logits['max_abs_logit_diff']} at "
                  f"{logits['worst']})")
            del eng, oeng, reqs, oreqs
            torch.cuda.empty_cache()
    # a 64-page pool: four 16-page prefixes and eight slots outgrow it,
    # so zero-ref blocks are evicted (LRU, leaf first) and slots preempted.
    # On the first CHUNKED_SPEC_LAYERS layers: the statistics it holds
    # exact are the host's schedule, which reads no arithmetic, and phase
    # 14 serves the same pool at full depth
    cfg8, params8 = _first_layers(cfg, params, CHUNKED_SPEC_LAYERS)
    eng, reqs, _, launches, wall, _ = _prefix_serve(
        torch, np, cfg8, params8, None, False, True, num_blocks=64,
        stepwise=False)
    _prefix_launch_check(eng, launches, None, CHUNKED_SPEC_LAYERS)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    peng, _, _, _, pwall, _ = _prefix_serve(
        torch, np, cfg8, params8, None, False, True, disable="all",
        num_blocks=64, stepwise=False)
    mine = {k: eng.stats[k] for k in PREFIX_STATS}
    plain = {k: peng.stats[k] for k in PREFIX_STATS}
    emit({"phase": "prefix_cache_evict", "model": "llama3_8b",
          "layers": CHUNKED_SPEC_LAYERS,
          "nvidia_smi": smi, "num_blocks": 64, "stats_on": mine,
          "stats_kernels_off": plain, "wall_s": wall,
          "wall_s_kernels_off": pwall,
          "tokens_per_wall_s": 64 * len(reqs) / wall,
          "mean_ttft_s": statistics.mean(r.ttft_s for r in reqs)})
    check(mine["prefix_evictions"] > 0, "the 64-page pool evicted")
    check(plain == mine, f"kernels-off statistics {plain} == kernels-on "
                         f"{mine}")
    del eng, peng, params
    torch.cuda.empty_cache()
    return total


def prefix_sweep(torch, np, smi: str, seeds: list[int]) -> None:
    """``--prefix-sweep``: phase 10's int8 chunked serve with the cache on
    and off at each request seed, each line reporting the on / off logit
    check over every greedy request (each request's largest difference,
    the copy-on-write requests, and whether each hit streamed its tail in
    the cache-off run's chunks) without failing on it: the readings
    ``PREFIX_INT8_CHUNKED_TOL`` is set from."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    worst = {"all": 0.0, "no_cow": 0.0}
    for seed in seeds:
        eng, reqs, rows, _, _, sched = _prefix_serve(
            torch, np, cfg, params, "int8", True, True, seed=seed)
        oeng, oreqs, orows, _, _, osched = _prefix_serve(
            torch, np, cfg, params, "int8", True, False, seed=seed)
        res = _logit_check(torch, reqs, rows, oreqs, orows)
        cow = set(sched["cow_rids"])
        no_cow = max(v for r, v in res["per_rid"].items() if r not in cow)
        worst["all"] = max(worst["all"], res["max_abs_logit_diff"])
        worst["no_cow"] = max(worst["no_cow"], no_cow)
        emit({"phase": "prefix_sweep", "seed": seed, "nvidia_smi": smi,
              "cow_rids": sorted(cow),
              "max_abs_logit_diff": res["max_abs_logit_diff"],
              "worst": res["worst"], "max_abs_logit_diff_no_cow": no_cow,
              "per_rid": res["per_rid"],
              "tail_chunks_same": _tail_chunks_same(sched, osched),
              "greedy_agreeing_share": res["greedy_agreeing_share"]})
        del eng, oeng, reqs, oreqs, rows, orows
        torch.cuda.empty_cache()
    emit({"phase": "prefix_sweep_summary", "seeds": seeds,
          "max_abs_logit_diff": worst,
          "logit_tolerance": PREFIX_INT8_CHUNKED_TOL})


def tier_probe(torch, np, smi: str, seeds: list[int]) -> None:
    """``--tier-probe``: phase 14's bucketed bf16 serve at each request
    seed, four times in turns in one process (tier off, on, on, off),
    each line reporting the wall, the
    prefill, decode and demotion seconds, the mean TTFT and the mean TTFT
    of the requests the tier restored a page for: the spread of the serve
    beside the tier's own costs."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    for seed in seeds:
        runs, revisit = [], None
        for tier in (False, True, True, False):
            eng, reqs, _, _, wall, sched = _prefix_serve(
                torch, np, cfg, params, None, False, True, num_blocks=64,
                stepwise=False, seed=seed, tier=tier)
            if tier:
                revisit = sorted(sched["restored_rids"])
            runs.append(({r.rid: r.ttft_s for r in reqs}, {
                "phase": "tier_probe", "seed": seed, "nvidia_smi": smi,
                "tier": tier, "wall_s": wall,
                "prefill_time_s": eng.prefill_time_s,
                "decode_time_s": eng.stats["decode_time_s"],
                "demote_s": sched["demote_s"],
                "tier_readmits": eng.stats["tier_readmits"],
                "prefill_tokens_computed":
                    eng.stats["prefill_tokens_computed"]}))
            del eng, reqs
            torch.cuda.empty_cache()
        for ttft, line in runs:
            emit({**line, "mean_ttft_s": statistics.mean(ttft.values()),
                  "revisit_rids": revisit,
                  "revisit_mean_ttft_s": statistics.mean(
                      ttft[r] for r in revisit) if revisit else None})


#: the chaos serve's fault plan: one clause of each kind the engine polls.
#: Step 1's first cache registration is rid 0's (a prompt no one shares);
#: step 2's first page grab is rid 4's (its 320-token prompt fills its
#: pages, so its second decode write opens a page), and the refusal
#: preempts the youngest slot; step 3's launch is retried; the lane in
#: slot 2 is poisoned at step 5; rid 3's token banking fails at step 6.
CHAOS_PLAN = ("cache_error@step=1;alloc_fail@step=2;kernel_error@step=3;"
              "nan_logits@slot=2,step=5;slot_error@rid=3,step=6")


def make_chaos_requests(Request, np, vocab: int, seed: int = 9):
    """12 requests, 32 new tokens each: rid 0 a 200-token prompt of its
    own, rid 4 a 320-token one (five full pages), the rest a shared
    256-token system prompt and a 40-300-token tail; rids 5 and 10
    sample (top-p 0.9)."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(40, 301, size=12)]
    system = rng.integers(0, vocab, size=256).astype(np.int32)
    reqs = []
    for i in range(12):
        if i in (0, 4):
            ids = rng.integers(0, vocab, size=200 if i == 0 else 320)
        else:
            ids = np.concatenate([system,
                                  rng.integers(0, vocab, size=lens[i])])
        reqs.append(Request(rid=i, prompt_ids=ids.astype(np.int32),
                            max_new_tokens=32,
                            temperature=0.8 if i in (5, 10) else 0.0,
                            top_p=0.9, seed=300 + i))
    return reqs


def phase_chaos(torch, np, smi: str) -> dict:
    """4 full-width layers, bf16, the fused arm, the prefix cache on:
    the chaos stream with and without ``CHAOS_PLAN``.  Gates: the
    ``nan_logits`` and ``slot_error`` victims end FAILED with an error,
    one injected dispatch fault is retried, no other request fails; every
    request no fault touched (as victim or by preemption) emits exactly
    the fault-free run's tokens (a decode row is computed from its own row
    at the fixed batch shape), and the preempted ones pass the logit
    check.  Then a snapshot taken mid-serve goes through ``json.dumps``
    into a fresh engine, whose streams pass the logit check against the
    uninterrupted run.  Last, one decode step timed with the guard (the
    graceful step) and without it (device ms and wall).  Returns the
    chaos serve's launches."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=4)
    params = llama.init_params(cfg, seed=2, device="cuda")
    kw = dict(max_batch=8, max_seq=2048, paged=True, block_size=64,
              num_blocks=256, enable_prefix_caching=True, device="cuda")
    env = "PADDLE_TPU_FAULT_INJECT"
    tol = SERVE_LOGIT_TOL[None]

    def build():
        return make_chaos_requests(Request, np, cfg.vocab_size)

    def serve(plan=None):
        if plan:
            os.environ[env] = plan
        try:
            eng = ContinuousBatchingEngine(cfg, params, **kw)
        finally:
            os.environ.pop(env, None)
        check(eng._graceful and eng._fused and bool(eng._faults) == bool(plan),
              "the graceful fused engine, with the plan when one is given")
        reqs = build()
        preempted = []
        preempt = eng._preempt

        def spy(slot):
            preempted.append(eng._slot_req[slot].rid)
            preempt(slot)

        eng._preempt = spy
        kernels.reset_counters()
        rows = _serve_stepwise(torch, eng, reqs)
        return eng, reqs, rows, preempted, dict(kernels.LAUNCHES)

    ref_eng, ref_reqs, ref_rows, ref_pre, _ = serve()
    check(not ref_pre and all(r.status == "FINISHED" for r in ref_reqs),
          "the fault-free run finishes every request without preempting")
    eng, reqs, rows, preempted, launches = serve(CHAOS_PLAN)
    st = eng.stats
    victims = {2, 3}
    failed = {r.rid: r.error for r in reqs if r.status == "FAILED"}
    check(set(failed) == victims and all(failed.values()),
          f"only the nan_logits and slot_error victims failed, with an "
          f"error: {failed}")
    check(st["nan_guard_trips"] == 1 and st["kernel_error_retries"] == 1,
          f"one guard trip and one retried dispatch fault "
          f"({st['nan_guard_trips']}, {st['kernel_error_retries']})")
    check(st["requests_failed"] == 2 and len(preempted) >= 1,
          f"two requests failed, the refused page grab preempted "
          f"({preempted})")
    check(st["prefix_hits"] > 0, "the shared system prompt hit")
    for rid in sorted(victims):
        dump = next((d for d in eng._flight.dumps
                     if d["reason"] == f"request_failed rid={rid}"), None)
        check(dump is not None and any(
            e["kind"] == "fault" and e.get("rid") == rid
            for e in dump["events"]),
              f"FAILED rid {rid} left a flight dump holding its fault record")
    flight = {d["reason"]: [e for e in d["events"] if e["kind"] == "fault"]
              for d in eng._flight.dumps}
    touched = victims | set(preempted)
    exact = [r.rid for r in reqs if r.rid not in touched]
    for r, ref in zip(reqs, ref_reqs):
        if r.rid not in victims:
            check(r.status == "FINISHED" and len(r.output_ids) == 32,
                  f"chaos rid {r.rid} finished")
        if r.rid in exact:
            check(r.output_ids == ref.output_ids,
                  f"chaos rid {r.rid}, untouched, emits the fault-free "
                  f"run's tokens")
    pick = [i for i, r in enumerate(reqs)
            if r.rid in touched - victims]
    chaos_logits = _logit_check(torch, [reqs[i] for i in pick], rows,
                                [ref_reqs[i] for i in pick], ref_rows)
    check(chaos_logits["max_abs_logit_diff"] <= tol,
          f"the preempted streams' logits within {tol} of the fault-free "
          f"run's ({chaos_logits['max_abs_logit_diff']})")
    del eng, rows
    # snapshot mid-serve -> JSON -> a fresh engine
    eng1 = ContinuousBatchingEngine(cfg, params, **kw)
    reqs1 = build()
    rows1 = _serve_stepwise(torch, eng1, reqs1, steps=12)
    snap = json.dumps(eng1.snapshot())
    del eng1
    eng2 = ContinuousBatchingEngine(cfg, params, **kw)
    restored = eng2.restore(json.loads(snap))
    check(restored and any(r.output_ids for r in restored),
          "the snapshot holds requests mid-stream")
    rows2 = _serve_stepwise(torch, eng2, restored, add=False)
    by_rid = {r.rid: r for r in reqs1}
    by_rid.update({r.rid: r for r in restored})
    final = [by_rid[r.rid] for r in ref_reqs]
    joined = {}
    for r in final:
        if r.temperature == 0:
            parts = [x for x in (rows1.get(r.rid), rows2.get(r.rid))
                     if x is not None]
            joined[r.rid] = torch.cat(parts) if parts else None
    for r in final:
        check(r.status == "FINISHED" and len(r.output_ids) == 32,
              f"restored rid {r.rid} finished")
    restore_logits = _logit_check(torch, final, joined, ref_reqs, ref_rows)
    check(restore_logits["max_abs_logit_diff"] <= tol,
          f"the restored streams' logits within {tol} of the uninterrupted "
          f"run's ({restore_logits['max_abs_logit_diff']})")
    del eng2, rows1, rows2, joined, ref_rows
    # the guard's cost: one decode step of 8 seated lanes, graceful (the
    # guard), graceful on a step a nan_logits clause armed (the guard and
    # the poison row) and graceful off (neither)
    eng = ContinuousBatchingEngine(cfg, params, **kw)
    for r in build()[:8]:
        eng.add_request(r)
    eng.step()
    dev = eng.device
    active = np.asarray([r is not None for r in eng._slot_req])
    check(active.all(), "eight lanes seated for the timing")
    args = (torch.as_tensor(eng._last_tok, device=dev).long(),
            torch.as_tensor(eng._pos, device=dev).long(),
            torch.as_tensor(active, device=dev),
            torch.as_tensor(eng._temp, device=dev),
            torch.as_tensor(eng._topp, device=dev),
            torch.as_tensor(eng._table, device=dev),
            torch.as_tensor(eng._seed, device=dev), None)
    armed = {"guard": True,
             "poison": torch.zeros(8, dtype=torch.bool, device=dev)}
    guard = {}
    for label, kw in (("graceful", {"guard": True}),
                      ("graceful_armed", armed), ("graceful_off", {})):
        def one(kw=kw):
            eng._chunk_scan(*args, **kw)

        walls = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        guard[label] = {"device_ms": time_ms(torch, one),
                        "wall_ms": statistics.median(walls)}
    logits_bytes = 8 * cfg.vocab_size * 2
    emit({"phase": "chaos", "model": "llama3_8b",
          "layers": cfg.num_hidden_layers,
          "nvidia_smi": smi, "plan": CHAOS_PLAN, "requests": len(reqs),
          "failed": failed, "preempted": preempted,
          "untouched_exact": exact,
          "stats": {k: st[k] for k in (
              "requests_failed", "nan_guard_trips", "kernel_error_retries",
              "preemptions", "degrade_preempt", "prefix_hits",
              "decode_steps")},
          "chaos_logits": chaos_logits, "restore_logits": restore_logits,
          "flight_dump_faults": flight,
          "snapshot_bytes": len(snap), "logit_tolerance": tol,
          "guard": guard,
          "guard_device_ms": guard["graceful"]["device_ms"]
          - guard["graceful_off"]["device_ms"],
          "guard_bound_ms": 3 * logits_bytes / HBM_BYTES_PER_S * 1e3})
    del eng, params
    torch.cuda.empty_cache()
    return launches


#: phase 12's weight-only quantized serves at full depth: (quant, KV pool
#: kind, chunked prefill)
QUANT_SERVES = (("int8", None, False), ("int4", "int8", True))
#: kernel-name fragments of the eager elementwise and copy passes, the
#: weight-only dequantize's (``.to(bf16)``, the scale multiply, int4's
#: unpack) and a few small ones of the step's own, for phase 12's profiles
DEQUANT_GROUPS = (("elementwise", "elementwise (dequant)"),
                  ("copy_kernel", "elementwise (dequant)"),
                  ("catarray", "elementwise (dequant)"))


def _quant_layer_check(torch, params) -> dict:
    """Layer 0's seven matmul weights quantized on the card and on the
    CPU from the same bf16 tensors, int8 and int4: codes and scales bit for
    bit, and the dequantized bf16 matrices (``wmat``) too."""
    from paddle_tpu_torch.inference import _MATMUL_LEAVES, _QUANT_ALGOS, wmat
    from paddle_tpu_torch.nn.quant import _quantize_2d

    checked = {}
    for quant, algo in _QUANT_ALGOS.items():
        for name in _MATMUL_LEAVES:
            w = params["layers"][name][0]
            qg, sg = _quantize_2d(w, algo)
            qc, sc = _quantize_2d(w.cpu(), algo)
            check(torch.equal(qg.cpu(), qc)
                  and torch.equal(sg.cpu().view(torch.int32),
                                  sc.view(torch.int32)),
                  f"{quant} {name}: codes and scales on the card equal the "
                  f"CPU's bit for bit")
            dg = wmat({"qweight": qg, "scale": sg}, torch.bfloat16, quant)
            dc = wmat({"qweight": qc, "scale": sc}, torch.bfloat16, quant)
            check(torch.equal(dg.cpu().contiguous().view(torch.int16),
                              dc.contiguous().view(torch.int16)),
                  f"{quant} {name}: the dequantized matrix on the card "
                  f"equals the CPU's bit for bit")
            checked[f"{quant}:{name}"] = list(qg.shape)
    return checked


def _quant_launch_check(eng, launches, L) -> None:
    """Every layer of every decode step through the pool kind's fused
    decode kernel on its tensor-core route, chunked every layer of every
    mixed step through the prefill walk (tensor cores), ``rms_norm`` every
    layer twice and once more a step (no fused MLP: its post norm is the
    kernel too), and the fused MLP never."""
    st = eng.stats
    mixed, steps = st["mixed_steps"], st["decode_steps"]
    decode = FUSED_DECODE[eng.kv_quant]
    want = {decode: L * (steps - mixed), f"{decode}_tc": L * (steps - mixed),
            "paged_prefill": L * mixed, "paged_prefill_tc": L * mixed,
            "fused_layer_mlp": 0,
            "rms_norm": (2 * L + 1) * (steps + st["prefills"])}
    for name, n in want.items():
        check(launches[name] == n,
              f"quant {eng.quant} kv {eng.kv_quant}: {name} launches "
              f"{launches[name]} == {n}")
    others = {k: launches[k] for k in DECODE_KERNELS if k != decode}
    check(not any(others.values()), f"no other decode kernel ran: {others}")
    check(launches["gumbel_noise"] > 0, "the sampled lanes drew noise")


def _quant_engine(cfg, params, quant, kv_quant, chunked):
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    feats = (dict(enable_chunked_prefill=True, prefill_chunk=128)
             if chunked else {})
    return ContinuousBatchingEngine(cfg, params, max_batch=8, max_seq=2048,
                                    paged=True, block_size=64,
                                    kv_quant=kv_quant, quant=quant,
                                    device="cuda", **feats)


def phase_quant(torch, np, smi: str) -> dict:
    """Weight-only quantized serving at Llama-3-8B widths (random bf16
    weights, phase 6's seed): layer 0 quantized on the card against the
    CPU; the resident layer-weight bytes bf16 / int8 / int4; phase 6's 12
    requests through a 32-layer int8 bucketed serve over bf16 pools and a
    32-layer int4 chunked (128) serve over int8 pools, launch counts
    proving the path (B7 / B11 every layer of every decode step, B9 of
    every mixed step, rms_norm, no fused MLP); decode tokens/s; a profile
    of four decode steps each and the dequantize of one step's weights
    timed alone; the first decode step's logits of int8 against bf16
    weights (reported, no gate); then both configurations on the first
    ``CHUNKED_SPEC_LAYERS`` layers with the kernels and with
    ``PADDLE_TPU_TORCH_DISABLE_KERNELS=all``, every logit row both scored
    from the same context within ``SERVE_LOGIT_TOL`` of the pool kind.
    Returns the two 32-layer serves' launches."""
    from paddle_tpu_torch.inference import (_MATMUL_LEAVES,
                                            quantize_layer_params, wmat)
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_hidden_layers
    layer_check = _quant_layer_check(torch, params)
    weight_bytes = {}
    m0 = torch.cuda.memory_allocated()
    probe = [torch.empty_like(params["layers"][n]) for n in _MATMUL_LEAVES]
    weight_bytes["bf16"] = torch.cuda.memory_allocated() - m0
    del probe
    for quant in ("int8", "int4"):
        m0 = torch.cuda.memory_allocated()
        qp = quantize_layer_params(params, quant)
        weight_bytes[quant] = torch.cuda.memory_allocated() - m0
        del qp
    torch.cuda.empty_cache()
    reqs_of = lambda: make_requests(Request, np, 12, cfg.vocab_size,
                                    sampled=2, seed=0)
    # the first decode step's logits with bf16 weights (bucketed, bf16
    # pools): the reference for the int8 serve's first step
    eng = _quant_engine(cfg, params, None, None, False)
    for r in reqs_of():
        eng.add_request(r)
    eng.step()
    first_bf16 = eng.last_logits.float().clone()
    del eng
    torch.cuda.empty_cache()
    total, serves = {}, {}
    for quant, kvq, chunked in QUANT_SERVES:
        eng = _quant_engine(cfg, params, quant, kvq, chunked)
        check(eng._fused and not eng._fused_mlp,
              f"{quant}: the fused decode arm, no fused MLP")
        reqs = reqs_of()
        kernels.reset_counters()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        eng.step()
        first = eng.last_logits.float().clone()
        while eng.step() or eng._queue:
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for r in reqs:
            check(r.status == "FINISHED"
                  and len(r.output_ids) == r.max_new_tokens
                  and all(0 <= t < cfg.vocab_size for t in r.output_ids),
                  f"{quant} request {r.rid}: {r.max_new_tokens} tokens in "
                  f"the vocabulary")
        check(bool(torch.isfinite(eng.last_logits).all()),
              "last logits finite")
        _quant_launch_check(eng, launches, L)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        st = eng.stats
        layers = eng.params["layers"]

        def dequant_step(layers=layers, quant=quant):
            for name in _MATMUL_LEAVES:
                leaf = layers[name]
                for li in range(L):
                    wmat({k: t[li] for k, t in leaf.items()},
                         torch.bfloat16, quant)

        # one decode step's dequantize alone, replayed as a CUDA graph so
        # the host's 2 x 224 launches do not bound the device time
        dequant_step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            dequant_step()
        dq_ms = time_ms(torch, graph.replay, reps=5)
        del graph
        res = {"quant": quant, "kv_quant": kvq, "chunked": chunked,
               "decode_steps": st["decode_steps"],
               "mixed_steps": st["mixed_steps"],
               "prefills": st["prefills"],
               "decode_tokens": st["decode_tokens"],
               "decode_tokens_per_s": eng.decode_tokens_per_s,
               "mean_ttft_s": statistics.mean(r.ttft_s for r in reqs),
               "wall_s": wall, "launches": {k: v for k, v in
                                            launches.items() if v},
               "dequant_device_ms_per_step": dq_ms,
               "dequant_bound_ms": (weight_bytes[quant]
                                    + weight_bytes["bf16"])
               / HBM_BYTES_PER_S * 1e3}
        if not chunked:
            res["first_step_max_abs_logit_diff_vs_bf16"] = (
                first - first_bf16).abs().max().item()
        serves[quant] = res
        emit({"phase": "quant_serve", "model": "llama3_8b", "layers": L,
              "nvidia_smi": smi, "requests": len(reqs), **res})
        phase_profile(torch, np, eng, Request, FUSED_DECODE[kvq],
                      extra_groups=DEQUANT_GROUPS, settle=chunked)
        del eng, layers
        torch.cuda.empty_cache()
    # the same two configurations at CHUNKED_SPEC_LAYERS depth, kernels on
    # against every kernel off
    cfg8, params8 = _first_layers(cfg, params, CHUNKED_SPEC_LAYERS)
    env = "PADDLE_TPU_TORCH_DISABLE_KERNELS"
    checks = {}
    for quant, kvq, chunked in QUANT_SERVES:
        runs = {}
        for label in ("kernels", "plain"):
            if label == "plain":
                os.environ[env] = "all"
            try:
                eng = _quant_engine(cfg8, params8, quant, kvq, chunked)
                reqs = reqs_of()
                kernels.reset_counters()
                rows = _serve_stepwise(torch, eng, reqs)
            finally:
                os.environ.pop(env, None)
            runs[label] = (reqs, rows, dict(kernels.LAUNCHES))
            del eng
        check(not any(runs["plain"][2].values()),
              f"{quant}: the plain run launched no kernel")
        logits = _logit_check(torch, runs["kernels"][0], runs["kernels"][1],
                              runs["plain"][0], runs["plain"][1])
        tol = SERVE_LOGIT_TOL[kvq]
        checks[quant] = {"kv_quant": kvq, "chunked": chunked,
                         "logit_tolerance": tol, **logits}
        check(logits["max_abs_logit_diff"] <= tol,
              f"{quant} kv {kvq}: every logit row both runs scored from "
              f"the same context within {tol} of the plain run's "
              f"(max {logits['max_abs_logit_diff']})")
        del runs
        torch.cuda.empty_cache()
    emit({"phase": "quant", "model": "llama3_8b", "nvidia_smi": smi,
          "layer_check": layer_check,
          "layer_weight_bytes": weight_bytes,
          "weight_bound_ms_per_decode_step": {
              k: v / HBM_BYTES_PER_S * 1e3 for k, v in weight_bytes.items()},
          "serves": serves, "logit_checks_layers": CHUNKED_SPEC_LAYERS,
          "logit_checks": checks})
    del params, params8
    torch.cuda.empty_cache()
    return total


def phase_observability(torch, np, smi: str) -> dict:
    """4 full-width layers, bf16, phase 6's 12 requests, served three
    ways: observability on (the default), ``PADDLE_TPU_METRICS=0``, and
    ``PADDLE_TPU_METRICS=0 PADDLE_TPU_FLIGHT_RECORDER=0``, each under
    ``torch.cuda.set_sync_debug_mode("warn")`` with the warnings counted,
    in two rounds in turns (after a warm-up serve).  Gates: identical
    token streams and equal synchronizing-call counts across the three
    (and across the rounds); the default run's ``metrics.expose()`` holds every
    schema counter with its ``stats`` value, its exported chrome trace
    parses and has ``queued``, ``prefill`` and ``decode`` spans for every
    request, and its step histogram counted every step.  Reports the wall
    per step of each run.  Returns the default run's launches."""
    import collections
    import tempfile
    import warnings

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference.observability import ENGINE_STAT_SCHEMA
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=4)
    params = llama.init_params(cfg, seed=0, device="cuda")
    # a warm-up serve, so no first use lands in one run (the process's
    # first switch to the "warn" mode warns once by itself)
    warm = ContinuousBatchingEngine(cfg, params, max_batch=8, max_seq=2048,
                                    paged=True, block_size=64, device="cuda")
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            warm.serve(make_requests(Request, np, 12, cfg.vocab_size,
                                     sampled=2, seed=0)[:3])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    del warm
    modes = (("default", {}), ("metrics_off", {"PADDLE_TPU_METRICS": "0"}),
             ("all_off", {"PADDLE_TPU_METRICS": "0",
                          "PADDLE_TPU_FLIGHT_RECORDER": "0"}))
    runs, out, sites, walls = {}, {}, {}, {}
    # two rounds in turns (ABC, CBA): the wall a step is reported per run
    for label, env in modes + modes[::-1]:
        os.environ.update(env)
        try:
            eng = ContinuousBatchingEngine(cfg, params, max_batch=8,
                                           max_seq=2048, paged=True,
                                           block_size=64, device="cuda")
        finally:
            for k in env:
                os.environ.pop(k)
        check((eng.metrics is not None) == (label == "default")
              and (eng._flight is not None) == (label != "all_off"),
              f"{label}: the registry and the recorder as switched")
        reqs = make_requests(Request, np, 12, cfg.vocab_size, sampled=2,
                             seed=0)
        profiler.clear_host_events()
        kernels.reset_counters()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                eng.serve(reqs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        synced = [f"{os.path.basename(w.filename)}:{w.lineno}"
                  for w in caught if "synchroniz" in str(w.message)]
        st = eng.stats
        walls.setdefault(label, []).append(
            {"decode_ms_per_step": st["decode_time_s"] / st["decode_steps"]
             * 1e3, "serve_wall_ms_per_step": wall / st["decode_steps"]
             * 1e3})
        if label in runs:
            check(collections.Counter(synced) == sites[label]
                  and [r.output_ids for r in reqs]
                  == [r.output_ids for r in runs[label][1]],
                  f"{label}: the second round repeats the first's tokens "
                  f"and synchronizing calls")
            continue
        sites[label] = collections.Counter(synced)
        runs[label] = (eng, reqs)
        out[label] = {"sync_warnings": len(synced),
                      "decode_steps": st["decode_steps"]}
        if label == "default":
            launches = dict(kernels.LAUNCHES)
            text = eng.metrics.expose()
            missing = [k for k, (kind, _) in ENGINE_STAT_SCHEMA.items()
                       if kind == "counter" and
                       f"paddle_tpu_serving_{k} {int(st[k])}\n" not in text]
            check(not missing, f"the exposition holds every schema "
                               f"counter with its stats value: {missing}")
            check(eng._h_step.count == st["decode_steps"],
                  f"the step histogram counted {eng._h_step.count} of "
                  f"{st['decode_steps']} steps")
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                profiler.Profiler().export(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            spans = {}
            for e in events:
                if e.get("ph") == "X":
                    spans.setdefault(e["tid"], set()).add(e["name"])
            lacking = [r.rid for r in reqs
                       if not {"queued", "prefill", "decode"}
                       <= spans.get(r.rid, set())]
            check(not lacking, f"queued, prefill and decode spans for "
                               f"every request (lacking: {lacking})")
            out[label].update({
                "trace_events": len(events),
                "exposition_bytes": len(text),
                "step_histogram_count": eng._h_step.count,
                "host_gap_histogram_count": eng._h_hostgap.count,
                "slo_goodput_at_60s": eng.slo.goodput_at(60.0, 60.0)[
                    "tokens"],
                "flight_events": len(eng._flight)})
    base = [r.output_ids for r in runs["default"][1]]
    for label in out:
        out[label]["walls"] = walls[label]
        out[label]["decode_ms_per_step_mean"] = statistics.mean(
            w["decode_ms_per_step"] for w in walls[label])
    emit({"phase": "observability", "model": "llama3_8b",
          "layers": cfg.num_hidden_layers, "nvidia_smi": smi,
          "requests": len(base), "runs": out,
          "sync_sites": dict(sites["default"]),
          "sync_sites_differing": {
              label: dict((sites[label] - sites["default"])
                          + (sites["default"] - sites[label]))
              for label in ("metrics_off", "all_off")}})
    for label in ("metrics_off", "all_off"):
        check([r.output_ids for r in runs[label][1]] == base,
              f"{label}: the token streams equal the default run's")
        check(out[label]["sync_warnings"] == out["default"]["sync_warnings"],
              f"{label}: as many synchronizing calls as with observability "
              f"on ({out[label]['sync_warnings']} vs "
              f"{out['default']['sync_warnings']})")
    del runs, params
    torch.cuda.empty_cache()
    return launches


#: phase 14's host tier budget (MiB): the four 1024-token system prompts are
#: 64 bf16 pages, 512 MiB, so the budget never bounds them
TIER_MIB = "1024"
#: the host tier's statistics, repeated exactly with every kernel off
TIER_STATS = ("tier_demotions", "tier_hits", "tier_readmits",
              "tier_evictions", "tier_bytes")


def _tier_transport(torch, cfg, params) -> dict:
    """One page of each pool kind (bf16, int8, packed int4, 32 layers)
    through the engine's tier transport: two pages demoted with one
    gathered read, the first recycled and overwritten at once, then
    restored into that same page, its page-locked buffer freed and new
    page-locked buffers written before the copy is waited for.  Gates: the
    page's codes and scales ``torch.equal`` to the originals, and the
    entry's bytes (K and V, and the scales) as the pool's layout gives
    them.  Times one bf16 page's D2H and H2D (K and V, contiguous,
    page-locked host memory; CUDA events), its D2H into pageable memory,
    and the engine's restore (``_tier_write``, into the pool's strided
    page)."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim)
    out = {}
    g = torch.Generator(device="cuda").manual_seed(14)
    for kvq in (None, "int8", "int4"):
        eng = ContinuousBatchingEngine(
            cfg, params, max_batch=1, max_seq=2048, paged=True, block_size=64,
            num_blocks=32, kv_quant=kvq, enable_prefix_caching=True,
            enable_host_kv_tier=True, device="cuda")
        leaves = [t for pair in eng._pool_leaves() for t in pair
                  if t is not None]
        for t in leaves:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
            else:
                t.copy_(torch.rand(t.shape, generator=g, device="cuda")
                        + 0.5)
        orig = [t[:, 3].clone() for t in leaves]
        eng._demote([("p3", 3), ("p5", 5)])
        for t in leaves:
            t[:, 3].fill_(-7)
        entry = eng._tier.ship_in("p3")
        check(entry.k.is_pinned(), "the tier's host copies are page-locked")
        codes = L * nkv * 64 * (hd // 2 if kvq == "int4" else hd) * (
            2 if kvq is None else 1)
        want = 2 * codes + (0 if kvq is None else 2 * L * nkv * 4)
        check(entry.nbytes == want,
              f"{kvq}: a page is {entry.nbytes} bytes, {want} expected")
        eng._tier_write(3, entry)
        del entry
        junk = [torch.empty(t[:, 3].shape, dtype=t.dtype,
                            pin_memory=True).fill_(9) for t in leaves]
        torch.cuda.synchronize()
        equal = all(torch.equal(t[:, 3], w) for t, w in zip(leaves, orig))
        check(equal and all(bool(j.eq(9).all()) for j in junk),
              f"{kvq}: the restored page equals the original")
        out[kvq or "bf16"] = {"page_bytes": want, "codes_bytes": 2 * codes,
                              "scale_bytes": want - 2 * codes,
                              "equal": equal}
        if kvq is None:
            page = [t[:, 1].contiguous() for t in leaves]
            host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                    for p in page]

            def d2h():
                for h, p in zip(host, page):
                    h.copy_(p, non_blocking=True)

            def h2d():
                for h, p in zip(host, page):
                    p.copy_(h, non_blocking=True)

            pageable = [torch.empty(p.shape, dtype=p.dtype) for p in page]

            def d2h_pageable():
                for h, p in zip(pageable, page):
                    h.copy_(p)

            entry = eng._tier.ship_in("p5")
            nbytes = sum(p.numel() * p.element_size() for p in page)
            ms = {"d2h": time_ms(torch, d2h), "h2d": time_ms(torch, h2d),
                  "restore": time_ms(torch,
                                     lambda: eng._tier_write(6, entry)),
                  "d2h_pageable": time_ms(torch, d2h_pageable)}
            out["bf16"].update({f"{k}_ms": v for k, v in ms.items()})
            out["bf16"].update({f"{k}_gb_per_s": nbytes / v / 1e6
                                for k, v in ms.items()})
        del eng, leaves, orig
        torch.cuda.empty_cache()
    return out


def phase_kv_tier(torch, np, smi: str) -> dict:
    """Llama-3-8B at full width and depth (random bf16 weights from a
    seed) serves phase 10's shared-prefix stream on its 64-page pool,
    where eviction fires, with the host KV tier on and off: bucketed on
    bf16 pools, chunked (128) on int8 pools; then the bf16 tier-on serve
    again with every kernel off; then the tier's transport for each pool
    kind (``_tier_transport``).  Gates: every request finishes; each
    tier-on run demotes, hits and restores, each tier-off run does none
    of it; the tier-on run computes fewer prefill tokens than the
    tier-off run; its launch counts prove the path (B1, B7 / B11, B8,
    chunked B9); every logit row the on and off runs scored from the same
    context agrees within ``SERVE_LOGIT_TOL`` (int8 chunked:
    ``PREFIX_INT8_CHUNKED_TOL``); the kernels-off serve repeats the
    prefix and tier statistics exactly.  Prints the prefill tokens saved
    beside 64 x ``tier_readmits``, the mean TTFT on and off of the
    requests the tier restored a page for, ``tier_bytes``, and the page
    transport's GB/s.  Returns the tier-on runs' launches, summed."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    L = cfg.num_hidden_layers
    total: dict = {}
    stats = PREFIX_STATS + TIER_STATS
    bf16_on = None
    for kvq, chunked in ((None, False), ("int8", True)):
        eng, reqs, rows, launches, wall, sched = _prefix_serve(
            torch, np, cfg, params, kvq, chunked, True, num_blocks=64,
            tier=True)
        oeng, oreqs, orows, _, owall, _ = _prefix_serve(
            torch, np, cfg, params, kvq, chunked, True, num_blocks=64)
        _prefix_launch_check(eng, launches, kvq, L)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        st, ost = eng.stats, oeng.stats
        check(all(st[k] > 0 for k in ("tier_demotions", "tier_hits",
                                      "tier_readmits"))
              and not any(ost[k] for k in TIER_STATS),
              f"{kvq}: the tier-on run demoted, hit and restored, the "
              f"tier-off run did none of it")
        saved = ost["prefill_tokens_computed"] - st["prefill_tokens_computed"]
        check(saved > 0, f"{kvq}: fewer prefill tokens computed with the "
                         f"tier ({saved} saved)")
        logits = _logit_check(torch, reqs, rows, oreqs, orows)
        tol = PREFIX_INT8_CHUNKED_TOL if chunked else SERVE_LOGIT_TOL[kvq]
        del rows, orows
        revisit = sorted(sched["restored_rids"])
        ttft = {r.rid: r.ttft_s for r in reqs}
        ottft = {r.rid: r.ttft_s for r in oreqs}
        emit({"phase": "kv_tier", "model": "llama3_8b", "layers": L,
              "kv_quant": kvq, "chunked": chunked, "nvidia_smi": smi,
              "num_blocks": eng.num_blocks, "tier_mib": int(TIER_MIB),
              "requests": len(reqs),
              "stats_on": {k: st[k] for k in stats},
              "stats_off": {k: ost[k] for k in stats},
              "tier": eng._tier.stats(),
              "prefill_tokens_saved": saved,
              "block_x_readmits": 64 * st["tier_readmits"],
              "revisit_rids": revisit,
              "revisit_mean_ttft_s_on": statistics.mean(
                  ttft[r] for r in revisit),
              "revisit_mean_ttft_s_off": statistics.mean(
                  ottft[r] for r in revisit),
              "mean_ttft_s_on": statistics.mean(ttft.values()),
              "mean_ttft_s_off": statistics.mean(ottft.values()),
              "h2d_dispatch_s_mean": eng._h_h2d.sum / eng._h_h2d.count,
              "demote_s_on": sched["demote_s"],
              "prefill_time_s_on": eng.prefill_time_s,
              "prefill_time_s_off": oeng.prefill_time_s,
              "wall_s_on": wall, "wall_s_off": owall,
              "logit_tolerance": tol, **logits,
              "launches": {k: v for k, v in launches.items() if v}})
        check(logits["max_abs_logit_diff"] <= tol,
              f"tier {kvq} chunked={chunked}: every logit row the tier-on "
              f"and -off runs scored from the same context within {tol} "
              f"(max {logits['max_abs_logit_diff']} at {logits['worst']})")
        if kvq is None:
            bf16_on = {k: st[k] for k in stats}
        del eng, oeng, reqs, oreqs
        torch.cuda.empty_cache()
    peng, _, _, _, pwall, _ = _prefix_serve(
        torch, np, cfg, params, None, False, True, disable="all",
        num_blocks=64, stepwise=False, tier=True)
    plain = {k: peng.stats[k] for k in stats}
    del peng
    torch.cuda.empty_cache()
    transport = _tier_transport(torch, cfg, params)
    emit({"phase": "kv_tier_plain", "nvidia_smi": smi,
          "stats_kernels_off": plain, "wall_s_kernels_off": pwall,
          "transport": transport})
    check(plain == bf16_on, f"kernels-off statistics {plain} == kernels-on "
                            f"{bf16_on}")
    del params
    torch.cuda.empty_cache()
    return total


def phase_async_host(torch, np, smi: str) -> dict:
    """4 full-width layers, bf16, phase 6's 12 requests (every other
    prompt repeating a span) with every feature on (prefix cache, chunked
    prefill 128, speculation, the host tier, graceful mode), stepped to
    the end with ``PADDLE_TPU_ASYNC_HOST`` at 1 and at 0, in two rounds in
    turns after a warm-up serve, each under
    ``torch.cuda.set_sync_debug_mode("warn")`` with the warnings counted.
    Gates: identical tokens in every run; ``journal()`` equals
    ``snapshot()`` at step 20 (``deadline_remaining_s`` aside); on, one
    journal flush a launched step (``host_overlap_steps`` ==
    ``decode_steps`` at chunk 1), off, none; phase 18's guard around every
    window (``host_overlap_steps`` of them on, one a launched step off);
    the same synchronizing calls on and off.  Prints the tokens' sha256,
    the host-gap histogram's mean and the wall a step, on and off.
    Returns the first run's launches."""
    import collections
    import hashlib
    import warnings

    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=4)
    params = llama.init_params(cfg, seed=0, device="cuda")
    kw = dict(max_batch=8, max_seq=2048, paged=True, block_size=64,
              enable_prefix_caching=True, enable_chunked_prefill=True,
              prefill_chunk=128, enable_speculation=True,
              enable_host_kv_tier=True, device="cuda")

    def reqs_():
        return make_requests(Request, np, 12, cfg.vocab_size, sampled=2,
                             seed=0, repeat=True)

    warm = ContinuousBatchingEngine(cfg, params, **kw)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            warm.serve(reqs_()[:3])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    del warm
    runs, sites, launches = {}, {}, None
    for label in ("on", "off", "off", "on"):
        os.environ["PADDLE_TPU_ASYNC_HOST"] = "1" if label == "on" else "0"
        try:
            eng = ContinuousBatchingEngine(cfg, params, **kw)
        finally:
            os.environ.pop("PADDLE_TPU_ASYNC_HOST")
        check(eng._async_host == (label == "on"), f"{label}: as switched")
        reqs = reqs_()
        for r in reqs:
            eng.add_request(r)
        kernels.reset_counters()
        torch.cuda.synchronize()
        n, same = 0, None
        g0 = _GUARD["windows"].get("async_host", 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                while eng.step() or eng._queue:
                    n += 1
                    if n == 20:
                        j, snap = eng.journal(), eng.snapshot()
                        same = all(
                            [dict(e, deadline_remaining_s=None)
                             for e in j[k]]
                            == [dict(e, deadline_remaining_s=None)
                                for e in snap[k]]
                            for k in ("running", "queued"))
                        same = same and j["engine"] == snap["engine"]
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(same is True, f"{label}: journal() == snapshot() at step 20")
        check(all(r.status == "FINISHED" for r in reqs),
              f"{label}: every request finished")
        st = eng.stats
        want = st["decode_steps"] if label == "on" else 0
        check(st["host_overlap_steps"] == want,
              f"{label}: host_overlap_steps {st['host_overlap_steps']} == "
              f"{want}")
        # the sync guard ran around every window: the flushes on, the
        # empty windows of every launched step off
        guarded = _GUARD["windows"].get("async_host", 0) - g0
        want = st["host_overlap_steps"] if label == "on" else st[
            "decode_steps"]
        check(guarded == want > 0, f"{label}: {guarded} windows guarded == "
                                   f"{want}")
        synced = collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))
        h = eng._h_hostgap
        run = {"tokens": [r.output_ids for r in reqs],
               "sync_warnings": sum(synced.values()),
               "steps": st["decode_steps"],
               "mixed_steps": st["mixed_steps"],
               "spec_steps": st["spec_steps"],
               "host_overlap_steps": st["host_overlap_steps"],
               "guarded_windows": guarded,
               "journal_incremental_updates":
                   st["journal_incremental_updates"],
               "journal_flush_s_mean": (eng._h_jupdate.sum
                                        / eng._h_jupdate.count
                                        if eng._h_jupdate.count else None),
               "host_gap_s_mean": h.sum / h.count,
               "step_ms_mean": st["decode_time_s"] / st["decode_steps"]
               * 1e3, "serve_wall_s": wall}
        if launches is None:
            launches = dict(kernels.LAUNCHES)
            L, mixed, spec = (cfg.num_hidden_layers, st["mixed_steps"],
                              st["spec_steps"])
            want = {"paged_prefill_tc": L * mixed,
                    "paged_verify_tc": L * spec,
                    "fused_decode_step_tc": L * (st["decode_steps"] - mixed
                                                 - spec)}
            check(all(launches[k] == n for k, n in want.items())
                  and launches["fused_layer_mlp"] > 0
                  and launches["rms_norm"] > 0,
                  f"the path's kernels: {want} vs "
                  f"{ {k: launches[k] for k in want} }")
        if label in sites:
            check(synced == sites[label], f"{label}: the second round's "
                                          f"synchronizing calls")
        sites[label] = synced
        runs.setdefault(label, []).append(run)
        del eng
    base = runs["on"][0]["tokens"]
    check(all(r["tokens"] == base for rs in runs.values() for r in rs),
          "the same tokens with the async host runtime on and off")
    check(sites["on"] == sites["off"], f"the same synchronizing calls on "
                                       f"and off: {dict(sites['on'])} vs "
                                       f"{dict(sites['off'])}")
    for rs in runs.values():
        for r in rs:
            del r["tokens"]
    digest = hashlib.sha256(json.dumps(
        [[int(t) for t in out] for out in base]).encode()).hexdigest()
    emit({"phase": "async_host", "model": "llama3_8b",
          "layers": cfg.num_hidden_layers, "nvidia_smi": smi,
          "requests": len(base), "tokens_sha256": digest, "runs": runs,
          "sync_sites": dict(sites["on"])})
    del params
    torch.cuda.empty_cache()
    return launches


#: phase 16's replicas: phase 10's serving geometry (batch 8, max_seq 2048,
#: block 64, 256 pages: every slot's whole context), the prefix cache on
FLEET_KW = dict(max_batch=8, max_seq=2048, paged=True, block_size=64,
                num_blocks=256, enable_prefix_caching=True, device="cuda")
#: the fleet step of phase 16's injected crash of replica 1: mid-decode
#: (both replicas seat eight requests from step 2 on, and the first of
#: them retires near step 65)
FLEET_CRASH_STEP = 30
#: phase 16's stall and drain runs (4 layers): the fleet step the stall
#: of replica 0 starts at (mid-decode), and the router's stall thresholds
FLEET_STALL_FROM, FLEET_STALL_STEPS, FLEET_STALL_DEAD = 8, 3, 12
#: phase 16's audited chaos serve: ``CHAOS_PLAN``'s kinds on both replicas,
#: the two that fail a request aimed at decode lanes (a poison bit set on a
#: lane the chunked step leaves idle clears unused): slot 0 at engine step
#: 40 and rid 3's first decode bank
FLEET_CHAOS_PLAN = ("cache_error@step=1;alloc_fail@step=2;"
                    "kernel_error@step=3;nan_logits@slot=0,step=40;"
                    "slot_error@rid=3")


def _fleet_stepwise(torch, fleet, reqs, first=4, capture=True) -> dict:
    """Serve ``reqs`` on ``fleet``: the first ``first`` routed and one
    fleet step run (their prompts prefilled and their chains cached), then
    the rest.  Every replica is spied on (``_spied``): for each greedy
    request the logit row that chose each of its tokens, whichever replica
    chose it (``capture``).  Returns {"rows", "owner": rid -> the replica
    it was routed to, "steps": fleet steps, "engines": every replica (a
    dead one too), "sampled": each replica's steps that drew noise}."""
    rows = {r.rid: [] for r in reqs if r.temperature == 0} if capture \
        else None
    engines = list(fleet.replicas)
    owner = {}
    with _spied(torch, engines, rows) as sampled:
        for q in reqs[:first]:
            fleet.add_request(q)
            owner[q.rid] = fleet._owner.get(q.rid)
        fleet.step()
        steps = 1
        for q in reqs[first:]:
            fleet.add_request(q)
            owner[q.rid] = fleet._owner.get(q.rid)
        while fleet.step():
            steps += 1
        torch.cuda.synchronize()
    return {"rows": {rid: torch.cat(v) if v else None
                     for rid, v in (rows or {}).items()},
            "owner": owner, "steps": steps, "engines": engines,
            "sampled": sampled}


def _fleet_launch_check(run, launches, L, label, sampling=True) -> dict:
    """Every replica's decode steps ran the fused decode step (B7) on its
    tensor-core route and the fused MLP (B8) in every layer, its prefills
    and decode steps the norms (B1: 2L + 1 a prefill, L + 1 a decode step,
    the post-attention norm being inside B8), its mixed steps the prefill
    walk (B9) in every layer, and each step that sampled one Gumbel launch;
    summed over the replicas, a dead one included.  ``sampling``: the
    stream holds sampled requests, so some step must have drawn."""
    engines, sampled = run["engines"], run["sampled"]
    st = {k: sum(e.stats[k] for e in engines)
          for k in ("decode_steps", "mixed_steps", "prefills")}
    plain = st["decode_steps"] - st["mixed_steps"]
    want = {"fused_decode_step": L * plain, "fused_decode_step_tc": L * plain,
            "fused_layer_mlp": L * plain,
            "paged_prefill": L * st["mixed_steps"],
            "paged_prefill_tc": L * st["mixed_steps"],
            "rms_norm": (L + 1) * plain
            + (2 * L + 1) * (st["prefills"] + st["mixed_steps"]),
            "gumbel_noise": sum(sampled)}
    for name, n in want.items():
        check(launches[name] == n, f"fleet {label}: {name} launches "
                                   f"{launches[name]} == {n}")
    others = {k: launches[k] for k in DECODE_KERNELS
              if k != "fused_decode_step"}
    check(not any(others.values()), f"fleet {label}: no other decode "
                                    f"kernel ran: {others}")
    check(launches["fused_decode_step_tc"] > 0
          and (sum(sampled) > 0) == sampling,
          f"fleet {label}: decode steps ran, sampled lanes "
          f"{'ran' if sampling else 'none'}")
    return {**st, "sampled_steps": sampled,
            "per_replica_decode_steps": [e.stats["decode_steps"]
                                         for e in engines]}


def _make_fleet(cfg, params, env=None, **kw):
    """A two-replica FleetRouter with ``env`` set while it is built (a
    fault plan, the auditor, the tier's budget)."""
    from paddle_tpu_torch.inference.fleet import FleetRouter

    env = env or {}
    os.environ.update(env)
    try:
        return FleetRouter(cfg, params, n_replicas=2, **kw)
    finally:
        for k in env:
            os.environ.pop(k, None)


def _fleet_tier(torch, np, cfg, params, vocab) -> dict:
    """The shared host tier: one request of system prompt A served on
    replica 0, three of other system prompts after it on the same replica
    (a 32-page pool: their pages evict A's chain, which demotes to the
    tier), then replica 0 drained and A revisited with a new tail on
    replica 1, which re-admits A's blocks from the tier replica 0 filled."""
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.ops import kernels

    fleet = _make_fleet(cfg, params, {"PADDLE_TPU_HOST_TIER_MIB": TIER_MIB},
                        **dict(FLEET_KW, num_blocks=32,
                               enable_host_kv_tier=True))
    check(fleet.host_tier is not None and fleet.host_tier.shared
          and all(e._tier is fleet.host_tier for e in fleet.replicas),
          "the replicas share one host tier")
    rng = np.random.default_rng(16)
    systems = [rng.integers(0, vocab, size=1024).astype(np.int32)
               for _ in range(4)]

    def req(rid, system, tail):
        return Request(rid=rid, prompt_ids=np.concatenate(
            [systems[system], rng.integers(0, vocab, size=tail)
             .astype(np.int32)]), max_new_tokens=16)

    reqs = [req(0, 0, 64)] + [req(100 + i, 1 + i, 448) for i in range(3)]
    engines = list(fleet.replicas)
    kernels.reset_counters()
    t0 = time.perf_counter()
    with _spied(torch, engines) as sampled:
        for q in reqs:
            fleet.serve([q])
            check(fleet._reqs == {} and q.status == "FINISHED",
                  f"tier serve rid {q.rid} finished")
        owners_before = [e.stats["tier_demotions"] for e in engines]
        fleet.drain(0)
        revisit = req(1, 0, 96)
        fleet.serve([revisit])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    counted = _fleet_launch_check({"engines": engines, "sampled": sampled},
                                  launches, cfg.num_hidden_layers, "tier",
                                  sampling=False)
    tier = fleet.host_tier.stats()
    r1 = fleet.replicas[1].stats
    out = {"demotions_by_replica": owners_before, "tier": tier,
           "replica1_tier_readmits": r1["tier_readmits"],
           "replica1_prefill_tokens_cached": r1["prefill_tokens_cached"],
           "revisit_status": revisit.status, "wall_s": wall,
           "health": list(fleet.health), "failovers":
           fleet.stats["failovers"], "counted": counted,
           "launches": launches}
    check(fleet.stats["failovers"] == 0
          and fleet.health == ["DRAINING", "HEALTHY"],
          f"the tier serve lost no replica: {out}")
    check(revisit.status == "FINISHED" and len(revisit.output_ids) == 16,
          "the revisit finished on replica 1")
    check(owners_before[0] > 0 and tier["cross_readmits"] > 0
          and r1["tier_readmits"] > 0,
          f"replica 1 re-admitted replica 0's demoted chain: {out}")
    del fleet
    torch.cuda.empty_cache()
    return out


def _fleet_stall(torch, np, cfg, params, vocab) -> dict:
    """4 layers, batch 4 a replica, eight requests: from fleet step
    ``FLEET_STALL_FROM`` on (mid-decode) replica 0 stalls for good
    (``replica_stall@replica=0,count=-1`` armed then: the grammar's
    ``step`` key pins a clause to one step).  After ``FLEET_STALL_STEPS``
    its four requests hedge onto replica 1, whose slots are busy, so no
    hedge wins before replica 0 is declared DEAD at ``FLEET_STALL_DEAD``
    steps without progress; the twins inherit the requests."""
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.ops import kernels

    fleet = _make_fleet(cfg, params, stall_steps=FLEET_STALL_STEPS,
                        stall_dead_steps=FLEET_STALL_DEAD,
                        **dict(FLEET_KW, max_batch=4, num_blocks=128,
                               enable_prefix_caching=False))
    reqs = make_requests(Request, np, 8, vocab, sampled=2, seed=0)
    engines = list(fleet.replicas)
    kernels.reset_counters()
    with _spied(torch, engines) as sampled:
        for q in reqs:
            fleet.add_request(q)
        steps, dead_at, hedged = 0, None, set()
        while True:
            steps += 1
            if steps == FLEET_STALL_FROM:
                os.environ["PADDLE_TPU_FAULT_INJECT"] = \
                    "replica_stall@replica=0,count=-1"
                try:
                    fleet._arm_faults_from_env()
                finally:
                    os.environ.pop("PADDLE_TPU_FAULT_INJECT")
            busy = fleet.step()
            hedged |= set(fleet._hedge)
            if dead_at is None and fleet.health[0] == "DEAD":
                dead_at = steps
            if not busy:
                break
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    counted = _fleet_launch_check({"engines": engines, "sampled": sampled},
                                  launches, cfg.num_hidden_layers, "stall")
    st = dict(fleet.stats)
    out = {"steps": steps, "stalled_from": FLEET_STALL_FROM,
           "last_progress_0": fleet._last_progress[0], "dead_at": dead_at,
           "hedged_rids": sorted(hedged), "stats": st,
           "health": list(fleet.health), "counted": counted,
           "statuses": [q.status for q in reqs], "launches": launches}
    check(st["hedges"] >= 1 and st["failovers"] == 1
          and fleet.health == ["DEAD", "HEALTHY"],
          f"the stall hedged and then killed replica 0: {out}")
    check(dead_at is not None
          and dead_at - fleet._last_progress[0] == FLEET_STALL_DEAD,
          f"replica 0 declared DEAD at stall_dead_steps: {out}")
    check(all(q.status == "FINISHED" and len(q.output_ids) == 64
              for q in reqs) and fleet._copies == {},
          f"every request finished once, none banked twice: {out}")
    del fleet
    torch.cuda.empty_cache()
    return out


def _fleet_drain(torch, np, cfg, params, vocab) -> dict:
    """4 layers, batch 4 a replica: eight requests, replica 1 drained
    after four fleet steps, four more requests after that."""
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.ops import kernels

    fleet = _make_fleet(cfg, params, **dict(FLEET_KW, max_batch=4,
                                            num_blocks=128,
                                            enable_prefix_caching=False))
    reqs = make_requests(Request, np, 12, vocab, sampled=2, seed=1, new=32)
    engines = list(fleet.replicas)
    kernels.reset_counters()
    with _spied(torch, engines) as sampled:
        for q in reqs[:8]:
            fleet.add_request(q)
        for _ in range(4):
            fleet.step()
        inflight = {rid: c[1] for rid, c in fleet._copies.items() if 1 in c}
        fleet.drain(1)
        for q in reqs[8:]:
            fleet.add_request(q)
        late_owner = {q.rid: fleet._owner.get(q.rid) for q in reqs[8:]}
        while fleet.step():
            pass
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    counted = _fleet_launch_check({"engines": engines, "sampled": sampled},
                                  launches, cfg.num_hidden_layers, "drain")
    out = {"inflight_on_drained": sorted(inflight),
           "late_owner": late_owner, "health": list(fleet.health),
           "failovers": fleet.stats["failovers"], "counted": counted,
           "launches": launches}
    check(fleet.stats["failovers"] == 0
          and fleet.health == ["HEALTHY", "DRAINING"],
          f"the drain lost no replica: {out}")
    check(inflight and all(c.status == "FINISHED" and len(c.output_ids) == 32
                           for c in inflight.values()),
          f"the drained replica finished its in-flight requests: {out}")
    check(all(o == 0 for o in late_owner.values())
          and not fleet.replicas[1]._reqs
          and all(q.status == "FINISHED" for q in reqs),
          f"the drained replica took no new work: {out}")
    del fleet
    torch.cuda.empty_cache()
    return out


def _fleet_audited_chaos(torch, np, cfg, params, vocab) -> dict:
    """4 layers, phase 10's stream, chunked (128) with the prefix cache,
    ``PADDLE_TPU_ENGINE_AUDIT=1``, ``FLEET_CHAOS_PLAN`` on both replicas
    and replica 1 crashed at ``FLEET_CRASH_STEP``: no invariant
    breaks in any replica or the router (the audits are wrapped, so one
    that raised inside a replica's step, which the router would count as
    that replica's death, is seen), and the audits' host seconds a fleet
    step."""
    from paddle_tpu_torch.inference import fleet as fleet_mod
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.ops import kernels

    spent, raised, calls = [0.0], [], [0]

    def timed_audit(fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            except Exception as e:
                raised.append(repr(e))
                raise
            finally:
                spent[0] += time.perf_counter() - t
                calls[0] += 1
        return run

    kw = dict(FLEET_KW, enable_chunked_prefill=True, prefill_chunk=128)
    saved = (serving.audit_engine, fleet_mod.audit_fleet)
    serving.audit_engine = timed_audit(saved[0])
    fleet_mod.audit_fleet = timed_audit(saved[1])
    try:
        fleet = _make_fleet(cfg, params, {
            "PADDLE_TPU_ENGINE_AUDIT": "1",
            "PADDLE_TPU_FAULT_INJECT": f"replica_crash@step="
                                       f"{FLEET_CRASH_STEP},replica=1;"
                                       + FLEET_CHAOS_PLAN}, **kw)
        check(fleet._audit_every_step
              and all(e._audit_every_step for e in fleet.replicas),
              "every replica and the router audit")
        fleet._audit_journal_equiv = timed_audit(fleet._audit_journal_equiv)
        reqs = make_prefix_requests(Request, np, vocab)
        kernels.reset_counters()
        run = _fleet_stepwise(torch, fleet, reqs, capture=False)
    finally:
        serving.audit_engine, fleet_mod.audit_fleet = saved
    L = cfg.num_hidden_layers
    launches = dict(kernels.LAUNCHES)
    counted = _fleet_launch_check(run, launches, L, "audited chaos")
    st = dict(fleet.stats)
    statuses = [q.status for q in reqs]
    out = {"steps": run["steps"], "stats": st, "statuses": statuses,
           "audit_calls": calls[0], "audit_s": spent[0],
           "audit_ms_per_fleet_step": spent[0] / run["steps"] * 1e3,
           "audit_raised": raised, "counted": counted}
    check(not raised and st["failovers"] == 1
          and fleet.health == ["HEALTHY", "DEAD"],
          f"no EngineAuditError from a replica or the router, replica 1's "
          f"crash the one death: {out}")
    check(all(s in ("FINISHED", "FAILED") for s in statuses)
          and statuses.count("FAILED") >= 1
          and counted["mixed_steps"] > 0,
          f"the chaos serve ended, its victims FAILED: {out}")
    del fleet, run
    torch.cuda.empty_cache()
    return {**out, "launches": launches}


def phase_fleet(torch, np, smi: str) -> dict:
    """Two Llama-3-8B replicas (32 layers, random bf16 weights from a
    seed) behind one ``FleetRouter``, sharing one weight set.  Gates:
    building the fleet adds no second weight set (the allocated bytes rise
    by no more than the two KV pools and a 64 MiB margin, and both
    engines hold the caller's tensors); phase 10's stream (the first
    request of each system prompt routed and stepped once, then the rest)
    routes by affinity (``routed_affinity`` > 0, every later request of a
    system prompt on the replica holding its chain), loses no replica (no
    failover, both HEALTHY: a fault escaping a replica's step would be a
    silent failover) and finishes at 64 tokens each; the same stream with
    replica 1 crashed at ``FLEET_CRASH_STEP`` (mid-decode) fails over
    once, replays its tokens, finishes every request, and every logit row
    scored from the same context as the uninterrupted fleet's is within
    ``SERVE_LOGIT_TOL``; the shared host tier re-admits on replica 1 a
    chain replica 0 demoted (``_fleet_tier``).  Then at 4 layers: the
    stall (``_fleet_stall``), the drain (``_fleet_drain``) and the audited
    chaos serve (``_fleet_audited_chaos``, chunked: B9 too).  Every run
    holds its failovers and health to the deaths it planned, and its
    launch counts prove every replica step ran B1, B7 (tensor cores), B8
    and, where it sampled, the sampler's kernel.  Returns the launches of
    every serve, summed."""
    from paddle_tpu_torch.inference.serving import Request
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = _make_fleet(cfg, params, **FLEET_KW)
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - before
    pools = sum(t.numel() * t.element_size() for e in fleet.replicas
                for t in (e.cache_k, e.cache_v))
    weights = sum(t.numel() * t.element_size()
                  for t in [params["embed"], *params["layers"].values(),
                            *(params[k] for k in ("final_norm", "lm_head")
                              if k in params)])
    shared = all(e.params["layers"][k].data_ptr()
                 == params["layers"][k].data_ptr()
                 for e in fleet.replicas for k in params["layers"])
    memory = {"weight_bytes": weights, "fleet_alloc_bytes": rise,
              "two_pool_bytes": pools, "margin_bytes": 64 << 20,
              "weights_shared": shared}
    emit({"phase": "fleet_memory", "nvidia_smi": smi, **memory})
    check(shared and rise <= pools + (64 << 20),
          f"the fleet added no second weight set: {memory}")

    def serve(fl):
        reqs = make_prefix_requests(Request, np, V)
        kernels.reset_counters()
        t0 = time.perf_counter()
        run = _fleet_stepwise(torch, fl, reqs)
        run["wall_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        run["counted"] = _fleet_launch_check(run, launches, L, "serve")
        add(launches)
        for q in reqs:
            check(q.status == "FINISHED" and len(q.output_ids) == 64
                  and all(0 <= t < V for t in q.output_ids),
                  f"fleet rid {q.rid}: FINISHED at 64 tokens")
        return reqs, run

    reqs, run = serve(fleet)
    st = dict(fleet.stats)
    holder = {q.rid: run["owner"][q.rid] for q in reqs[:4]}
    astray = [q.rid for q in reqs[4:]
              if run["owner"][q.rid] != holder[q.rid % 4]]
    routing = {"stats": st, "owner": run["owner"], "steps": run["steps"],
               "wall_s": run["wall_s"], **run["counted"],
               "prefix_hits": [e.stats["prefix_hits"]
                               for e in run["engines"]]}
    emit({"phase": "fleet_routing", "model": "llama3_8b", "layers": L,
          "nvidia_smi": smi, **routing})
    check(st["failovers"] == 0 and fleet.health == ["HEALTHY", "HEALTHY"],
          f"the uninterrupted serve lost no replica (a fault escaping a "
          f"replica's step is a failover): {routing}")
    check(st["routed_affinity"] > 0 and not astray,
          f"every later request of a system prompt joined its chain's "
          f"replica (astray: {astray})")
    del fleet
    torch.cuda.empty_cache()

    crash = _make_fleet(cfg, params, {
        "PADDLE_TPU_FAULT_INJECT":
            f"replica_crash@step={FLEET_CRASH_STEP},replica=1"}, **FLEET_KW)
    creqs, crun = serve(crash)
    cst = dict(crash.stats)
    replayed = sorted(rid for rid, o in run["owner"].items() if o == 1)
    logits = _logit_check(torch, creqs, crun["rows"], reqs, run["rows"])
    tol = SERVE_LOGIT_TOL[None]
    failover = {"stats": cst, "steps": crun["steps"],
                "wall_s": crun["wall_s"], "replayed_rids": replayed,
                "health": list(crash.health), **crun["counted"],
                "replayed_max_abs_logit_diff": max(
                    (logits["per_rid"][r] for r in replayed
                     if r in logits["per_rid"]), default=None),
                "logit_tolerance": tol, **logits}
    emit({"phase": "fleet_failover", "model": "llama3_8b", "layers": L,
          "nvidia_smi": smi, "plan": f"replica_crash@step="
                                     f"{FLEET_CRASH_STEP},replica=1",
          **failover})
    check(cst["failovers"] == 1 and cst["replayed_tokens"] > 0
          and crash.health == ["HEALTHY", "DEAD"],
          f"one failover replayed replica 1's tokens: {cst}")
    check(logits["max_abs_logit_diff"] <= tol,
          f"fleet failover: every logit row scored from the uninterrupted "
          f"fleet's context within {tol} (max "
          f"{logits['max_abs_logit_diff']} at {logits['worst']})")
    del crash, crun, run, reqs, creqs
    torch.cuda.empty_cache()

    tier = _fleet_tier(torch, np, cfg, params, V)
    add(tier.pop("launches"))
    emit({"phase": "fleet_tier", "model": "llama3_8b", "layers": L,
          "nvidia_smi": smi, **tier})

    cfg4, params4 = _first_layers(cfg, params, 4)
    stall = _fleet_stall(torch, np, cfg4, params4, V)
    drain = _fleet_drain(torch, np, cfg4, params4, V)
    audited = _fleet_audited_chaos(torch, np, cfg4, params4, V)
    for run in (stall, drain, audited):
        add(run.pop("launches"))
    emit({"phase": "fleet_small", "model": "llama3_8b", "layers": 4,
          "nvidia_smi": smi, "stall": stall, "drain": drain,
          "audited_chaos": audited})
    del params, params4
    torch.cuda.empty_cache()
    return total


#: phase 17's degree, and its serving geometry: phase 6's (batch 8,
#: max_seq 2048, block 64, the default pool of half the worst case)
TP_DEGREE = 2
TP_KW = dict(max_batch=8, max_seq=2048, paged=True, block_size=64,
             device="cuda")
#: phase 17's two serves of phase 6's 12 requests: bucketed, and chunked in
#: 128-row chunks under a token budget that fills the mixed step's 8 x 128
#: rows.  The step computes every one of those rows (C9d) and its two
#: all-reduces a layer move them all through the host (gloo on one card),
#: so phase 6's budget of 136 would run about four times the steps for the
#: same prompts
TP_MODES = (("bucketed", {}),
            ("chunked", dict(enable_chunked_prefill=True, prefill_chunk=128,
                             token_budget=8 * 128)))
#: new tokens a request of phase 17's control serve (``_tp_control``):
#: its rows are compared while its tokens follow the one-card engine's
TP_CONTROL_TOKENS = 4
#: phase 17's memory gate: a rank's layer weights and its pools against
#: half the one-card engine's, relative (a rank keeps both norms of every
#: layer whole: 0.5 MiB of the 14 GB of layer weights)
TP_BYTES_MARGIN = 1e-3


def _tp_params(torch, cfg, where: str, seed: int = 0) -> dict:
    """Random bf16 weights from ``seed``, the whole model, made on the card
    layer by layer and kept on ``where``: each layer's matmul leaf is drawn
    in f32 (a generator seeded from (seed, leaf, layer)) and cast to bf16
    on the card, then copied into its place; the norms are ones.  The
    one-card engine keeps them on the card; a rank keeps them on the host,
    so the card holds only the slice its engine makes of them."""
    from paddle_tpu_torch.models import llama

    dev = torch.device(TP_KW["device"])
    g = torch.Generator(device=dev)
    L, h, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size

    def draw(shape, key):
        g.manual_seed(seed * 1_000_003 + key)
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return w.mul_(0.02).to(cfg.dtype)

    layers = {}
    for j, (name, shape) in enumerate(
            llama.serving_matmul_shapes(cfg).items()):
        leaf = torch.empty(shape, dtype=cfg.dtype, device=where)
        for li in range(L):
            leaf[li].copy_(draw(shape[1:], 1000 * (j + 1) + li))
        layers[name] = leaf
    ones = torch.ones((L, h), dtype=cfg.dtype, device=where)
    layers.update(input_norm=ones, post_norm=ones.clone())
    return {"embed": draw((V, h), 1).to(where),
            "lm_head": draw((h, V), 2).to(where),
            "final_norm": torch.ones(h, dtype=cfg.dtype, device=where),
            "layers": layers}


def _engine_bytes(eng) -> dict:
    """The engine's resident layer-weight bytes and KV pool bytes."""
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    return {"layer_weight_bytes": nbytes(eng.params["layers"]),
            "pool_bytes": nbytes(eng.cache_k) + nbytes(eng.cache_v)}


def _tp_serve(torch, eng, reqs, L: int) -> dict:
    """Serve ``reqs`` on ``eng`` step by step, every greedy request's logit
    rows captured (``_spied``), and hold every step's launches to its work:
    each plain decode step runs the fused decode step (B7, on its
    tensor-core route) and the fused MLP (B8) in every layer, each mixed
    step the prefill walk (B9, tensor cores) in every layer, the norms
    (B1) L + 1 a decode step and 2L + 1 a prefill or mixed step, the
    sampler's Gumbel kernel once a step that drew; every forward pays 2L
    all-reduces at tp > 1 and none at tp = 1; no other decode kernel
    runs.  Returns the rows, the launches, the steps and each step's
    wall."""
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    rows = {r.rid: [] for r in reqs if r.temperature == 0}
    for r in reqs:
        eng.add_request(r)
    forwards = [0]
    apply = serving.transformer_apply

    def counted(*args, **kw):
        forwards[0] += 1
        return apply(*args, **kw)

    def launches():
        return {k: kernels.LAUNCHES[k] for k in kernels.LAUNCHES}

    keys = ("decode_steps", "mixed_steps", "spec_steps", "prefills")
    kernels.reset_counters()
    llama.TP_COUNTERS["all_reduce"] = 0
    walls = []
    serving.transformer_apply = counted
    try:
        with _spied(torch, [eng], rows) as sampled:
            while True:
                l0 = launches()
                a0, f0, n0 = (llama.TP_COUNTERS["all_reduce"], forwards[0],
                              sampled[0])
                s0 = {k: eng.stats[k] for k in keys}
                t0 = time.perf_counter()
                busy = eng.step()
                walls.append(time.perf_counter() - t0)
                d = {k: eng.stats[k] - s0[k] for k in keys}
                plain = d["decode_steps"] - d["mixed_steps"] - d["spec_steps"]
                want = {"fused_decode_step": L * plain,
                        "fused_decode_step_tc": L * plain,
                        "fused_layer_mlp": L * plain,
                        "paged_prefill": L * d["mixed_steps"],
                        "paged_prefill_tc": L * d["mixed_steps"],
                        "rms_norm": (L + 1) * plain
                        + (2 * L + 1) * (d["prefills"] + d["mixed_steps"]),
                        "gumbel_noise": sampled[0] - n0}
                got = {k: kernels.LAUNCHES[k] - l0[k] for k in want}
                step = len(walls)
                check(got == want, f"tp={eng.tp} step {step}: launches "
                                   f"{got} == {want}")
                fw = forwards[0] - f0
                ar = llama.TP_COUNTERS["all_reduce"] - a0
                check(fw == plain + d["mixed_steps"] + d["prefills"]
                      and ar == (2 * L * fw if eng.tp > 1 else 0),
                      f"tp={eng.tp} step {step}: {ar} all-reduces for {fw} "
                      f"forward(s) of {L} layers")
                if not busy and not eng._queue:
                    break
    finally:
        serving.transformer_apply = apply
    torch.cuda.synchronize()
    total = launches()
    others = {k: total[k] for k in DECODE_KERNELS if k != "fused_decode_step"}
    check(not any(others.values()) and total["fused_decode_step_tc"] > 0
          and total["gumbel_noise"] > 0,
          f"tp={eng.tp}: the fused decode step and the sampler ran, no "
          f"other decode kernel: {others}")
    return {"rows": {rid: torch.cat(v) for rid, v in rows.items()},
            "launches": total, "steps": len(walls),
            "all_reduces": llama.TP_COUNTERS["all_reduce"],
            "sampled_steps": sampled[0], "step_wall_s": walls,
            "stats": {k: eng.stats[k] for k in
                      keys + ("decode_tokens", "decode_time_s",
                              "preemptions")}}


def _tp_run(torch, np, cfg, params, tp: int, mode: str, kw: dict) -> dict:
    """One phase-17 serve: phase 6's 12 requests (64 new tokens, the last
    two sampled) on an engine of degree ``tp`` in ``mode``; every request
    finishes with 64 tokens in the vocabulary.  Adds the tokens, the
    wall, the wall a step and the engine's bytes to ``_tp_serve``'s
    result."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)

    eng = ContinuousBatchingEngine(cfg, params, tensor_parallel=tp,
                                   **TP_KW, **kw)
    nbytes = _engine_bytes(eng)
    reqs = make_requests(Request, np, 12, cfg.vocab_size, sampled=2, seed=0)
    t0 = time.perf_counter()
    run = _tp_serve(torch, eng, reqs, cfg.num_hidden_layers)
    run["wall_s"] = time.perf_counter() - t0
    for r in reqs:
        check(r.finished and len(r.output_ids) == r.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.output_ids),
              f"tp={tp} {mode} request {r.rid}: {r.max_new_tokens} tokens "
              f"in the vocabulary")
    st = run["stats"]
    run.update(nbytes, mode=mode,
               tokens={r.rid: list(r.output_ids) for r in reqs},
               temperature={r.rid: r.temperature for r in reqs},
               wall_per_step_s=run["wall_s"] / run["steps"],
               decode_wall_per_step_s=st["decode_time_s"]
               / st["decode_steps"],
               allocated_bytes=torch.cuda.memory_allocated())
    del eng
    torch.cuda.empty_cache()
    return run


def _tp_control(torch, np, cfg, params, tp: int) -> dict:
    """The logit gate's control: a rank whose last layer skips its MLP
    all-reduce (so its residual carries only its own half of that MLP's
    output, the smallest structural fault a rank can have) serves phase
    6's requests bucketed for ``TP_CONTROL_TOKENS`` tokens each.  Every
    rank skips the same collective, so the group stays in step.  Returns
    the greedy requests' logit rows and the tokens."""
    from paddle_tpu_torch.inference.serving import (ContinuousBatchingEngine,
                                                    Request)
    from paddle_tpu_torch.models import llama

    eng = ContinuousBatchingEngine(cfg, params, tensor_parallel=tp,
                                   **TP_KW)
    reqs = make_requests(Request, np, 12, cfg.vocab_size, sampled=2, seed=0,
                         new=TP_CONTROL_TOKENS)
    rows = {r.rid: [] for r in reqs if r.temperature == 0}
    for r in reqs:
        eng.add_request(r)
    reduce, calls = llama._tp_all_reduce, [0]

    def skip_last_mlp(y, group):
        calls[0] += 1
        if calls[0] % (2 * cfg.num_hidden_layers) == 0:
            return y
        return reduce(y, group)

    llama._tp_all_reduce = skip_last_mlp
    try:
        with _spied(torch, [eng], rows):
            while eng.step() or eng._queue:
                pass
    finally:
        llama._tp_all_reduce = reduce
    torch.cuda.synchronize()
    out = {"rows": {rid: torch.cat(v).cpu() for rid, v in rows.items()},
           "tokens": {r.rid: list(r.output_ids) for r in reqs},
           "skipped": calls[0] // (2 * cfg.num_hidden_layers)}
    del eng
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, tmp: str, tp: int) -> None:
    """One rank of phase 17, a spawned process on the one card: joins the
    gloo group (a file store in ``tmp``), makes its slice of the weights
    (``_tp_params``), serves both of ``TP_MODES`` at ``tensor_parallel=tp``
    (``_tp_run``: every step's launches and all-reduces gated), serves
    the logit gate's control (``_tp_control``), times the decode step's
    all-reduce alone, and saves what it saw to ``tmp/rank{rank}.pt``:
    rank 0 its logit rows, every rank a digest of them and the windows its
    sync guard (``_install_overlap_guard``, phase 18) ran around."""
    import datetime
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    _install_overlap_guard(torch)
    _GUARD["phase"] = "tp"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=tp,
                            timeout=datetime.timedelta(seconds=300))
    try:
        cfg = llama.LlamaConfig.llama3_8b()
        t0 = time.perf_counter()
        params = _tp_params(torch, cfg, "cpu")
        torch.cuda.synchronize()
        out = {"rank": rank, "init_params_s": time.perf_counter() - t0,
               "serves": {}}
        for mode, kw in TP_MODES:
            run = _tp_run(torch, np, cfg, params, tp, mode, kw)
            rows = run.pop("rows")
            h = hashlib.sha256()
            for rid in sorted(rows):
                h.update(rows[rid].view(torch.int16).cpu().numpy().tobytes())
            run["rows_sha256"] = h.hexdigest()
            if rank == 0:
                run["rows"] = {rid: v.cpu() for rid, v in rows.items()}
            out["serves"][mode] = run
        control = _tp_control(torch, np, cfg, params, tp)
        if rank == 0:
            out["control"] = control
        del params
        # the decode step's all-reduce alone: [8, 1, 4096] bf16 through
        # gloo, staged through the host
        y = torch.ones((8, 1, cfg.hidden_size), dtype=cfg.dtype,
                       device=TP_KW["device"])
        for _ in range(3):
            dist.all_reduce(y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(64):
            dist.all_reduce(y)
        torch.cuda.synchronize()
        out["all_reduce_decode_ms"] = (time.perf_counter() - t0) / 64 * 1e3
        out["guard"] = {"windows": _GUARD["windows"].get("tp", 0),
                        "errors": _GUARD["errors"]}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tp_kernel_checks(torch) -> dict:
    """The path's kernels at one rank's shapes of Llama-3-8B at tp=2,
    each against its plain version: the fused decode step (B7) at 16 q /
    4 kv heads on phase 3's two lane mixes (``_b7_case``: both routes,
    pools exact off the appended rows), the fused MLP (B8) at 7168 ffn
    columns (phase 3's tolerance), the prefill walk (B9) at 16 / 4 heads
    on phase 5's 128-row mixed-step lanes (the attention tolerance, rows
    past q_len exactly 0).  The shape rules take each shape; on the card
    an unsupported one raises."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    B, h, hd, bs, max_seq, eps = 8, 4096, 128, 64, 2048, 1e-5
    nh, nkv, F = 32 // TP_DEGREE, 8 // TP_DEGREE, 14336 // TP_DEGREE
    max_blocks = max_seq // bs
    nb = B * max_blocks
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    check(pa.kernel_supported(nh, nkv, hd, bs)
          and pa.fused_mlp_supported(h, F),
          f"the kernels take a rank's shapes: {nh}/{nkv} heads, ffn {F}")

    def flush():
        scratch.zero_()

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=dev) * std).to(bf16)

    kp0, vp0 = randn(nb + 1, nkv, bs, hd), randn(nb + 1, nkv, bs, hd)
    kp0[nb] = 0
    vp0[nb] = 0
    q, k_new, v_new = randn(B, nh, hd), randn(B, nkv, hd), randn(B, nkv, hd)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    out = {"heads": [nh, nkv], "ffn": F}
    for label, lens_l, wable_l in DECODE_MIXES:
        res = _b7_case(torch, pa, q, k_new, v_new, kp0, vp0, perm, lens_l,
                       wable_l, flush)
        out[f"fused_decode_step_{label}"] = {
            k: res[k] for k in ("max_abs_err", "worst_err_over_tol", "ms",
                                "plain_ms", "bound_ms")}
    x, ay = randn(B, h), randn(B, h, std=0.1)
    nw = (1.0 + 0.1 * torch.randn(h, generator=g, device=dev)).to(bf16)
    wg, wu = randn(h, F, std=0.02), randn(h, F, std=0.02)
    wd = randn(F, h, std=0.02)
    h1_k, y_k = pa.fused_layer_mlp_cuda(x, ay, nw, wg, wu, wd, eps)
    h1_p, y_p = pa.fused_layer_mlp_reference(x, ay, nw, wg, wu, wd, eps)
    torch.cuda.synchronize()
    err = (y_k.float() - y_p.float()).abs()
    tol = y_p.float().abs() * 2.0 ** -6 + y_p.float().abs().max() * 2.0 ** -7
    check(bool(torch.equal(h1_k, h1_p)) and bool((err <= tol).all()),
          f"fused_layer_mlp at ffn {F}: h1 exact, y within tolerance")
    bnd, by = bound_ms(3 * h * F * 2 + 4 * B * h * 2 + h * 2,
                       2 * B * 3 * h * F)
    out["fused_layer_mlp"] = {
        "max_abs_err": err.max().item(),
        "tolerance": "|d| <= 2^-6|ref| + 2^-7 max|ref|; h1 exact",
        "ms": time_ms(torch, lambda: pa.fused_layer_mlp_cuda(
            x, ay, nw, wg, wu, wd, eps), flush=flush),
        "plain_ms": time_ms(torch, lambda: pa.fused_layer_mlp_reference(
            x, ay, nw, wg, wu, wd, eps), flush=flush),
        "bound_ms": bnd, "bound_by": by}
    lens_l = [2048, 1000, 333, 1, 128, 768, 1920, 1500]
    qlens_l = [1, 1, 1, 1, 128, 128, 128, 37]
    tables = torch.full((B, max_blocks), nb, dtype=torch.int32, device=dev)
    pages = [-(-n // bs) if n > 1 else 0 for n in lens_l]
    for b, p in enumerate(pages):
        tables[b, :p] = perm[b * max_blocks:b * max_blocks + p]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    qlens = torch.tensor(qlens_l, dtype=torch.int32, device=dev)
    qr = randn(B, 128, nh, hd)
    args = (qr, kp0, vp0, tables, lens, qlens)
    scale = hd ** -0.5
    got = pa.paged_prefill_cuda(*args, scale, route="tc")
    want = pa.paged_prefill_reference(*args, scale=scale)
    torch.cuda.synchronize()
    live = torch.arange(128, device=dev)[None, :] < qlens[:, None]
    errs, ok = _attn_err(torch, got[live], want[live])
    check(ok and bool((got[~live] == 0).all()),
          f"paged_prefill at {nh}/{nkv} heads: within the attention "
          f"tolerance, rows past q_len exactly 0")
    # phase 5's bound: each lane's live pages (the inactive lane its one
    # spill page) of K and V once, q's live rows, the output, the table
    # entries and lengths; 4 hd flops a visible (row, column) pair a head
    live_pages = sum(max(p, 1) for p in pages)
    bnd, by = bound_ms(live_pages * nkv * bs * hd * 2 * 2
                       + sum(qlens_l) * nh * hd * 2 + qr.numel() * 2
                       + live_pages * 4 + 2 * B * 4,
                       4 * hd * nh * _row_pairs(lens_l, qlens_l))
    out["paged_prefill"] = {
        **errs, "rows": 128, "lens": lens_l, "q_lens": qlens_l,
        "tolerance": "|d| <= 2^-7|ref| + 2^-8 max|ref[slot, row, head]|; "
                     "rows past q_len exactly 0",
        "ms": time_ms(torch, lambda: pa.paged_prefill_cuda(
            *args, scale, route="tc"), flush=flush),
        "plain_ms": time_ms(torch, lambda: pa.paged_prefill_reference(
            *args, scale=scale), flush=flush),
        "bound_ms": bnd, "bound_by": by}
    del scratch, kp0, vp0
    torch.cuda.empty_cache()
    return out


def phase_tp(torch, np, smi: str) -> dict:
    """Tensor-parallel serving at tp=2 on one card: two ranks, each a
    spawned process on cuda:0 in a gloo group (NCCL refuses two ranks on
    one device; gloo stages each all-reduce of a CUDA tensor through the
    host).  First the path's kernels at a rank's shapes
    (``_tp_kernel_checks``); then the one-card engine (the same weights
    whole) serves phase 6's 12 requests bucketed and chunked
    (``TP_MODES``), its logit rows captured; then the two ranks, each
    making the same weights on the card layer by layer into a tree on the
    host that its engine slices, serve the same requests the same two
    ways.  Gates: every step of every serve
    runs its kernels and, at tp=2, 2 x 32 all-reduces a forward
    (``_tp_serve``); both ranks emit the same tokens and the same logit
    rows bit for bit; on identical histories rank 0's rows are within
    ``SERVE_LOGIT_TOL`` of the one-card engine's (``_logit_check``);
    each rank's layer weights and pools are half the one-card engine's,
    within ``TP_BYTES_MARGIN``; the gate's control, ranks that skip their
    last layer's MLP all-reduce (``_tp_control``), reads above
    ``SERVE_LOGIT_TOL``.  Reports the wall a step of each, and the decode
    step's all-reduce alone (host-staged gloo, not NCCL).  Returns the
    launches of every serve, summed."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from paddle_tpu_torch.models import llama

    checks = _tp_kernel_checks(torch)
    emit({"phase": "tp_kernels", "nvidia_smi": smi, **checks})
    cfg = llama.LlamaConfig.llama3_8b()
    L = cfg.num_hidden_layers
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    params = _tp_params(torch, cfg, TP_KW["device"])
    one = {}
    for mode, kw in TP_MODES:
        one[mode] = _tp_run(torch, np, cfg, params, 1, mode, kw)
        add(one[mode]["launches"])
    del params
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp")
    try:
        t0 = time.perf_counter()
        mp.spawn(_tp_rank, args=(tmp, TP_DEGREE), nprocs=TP_DEGREE,
                 join=True)
        ranks_wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(TP_DEGREE)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {}
    tol = SERVE_LOGIT_TOL[None]
    for mode, _ in TP_MODES:
        ref = one[mode]
        runs = [r["serves"][mode] for r in ranks]
        check(all(run["tokens"] == runs[0]["tokens"]
                  and run["rows_sha256"] == runs[0]["rows_sha256"]
                  for run in runs),
              f"tp {mode}: every rank emitted the same tokens and the same "
              f"logit rows bit for bit")
        mine = [types.SimpleNamespace(rid=rid, temperature=t,
                                      output_ids=runs[0]["tokens"][rid])
                for rid, t in ref["temperature"].items()]
        theirs = [types.SimpleNamespace(rid=rid, temperature=t,
                                        output_ids=ref["tokens"][rid])
                  for rid, t in ref["temperature"].items()]
        rows = {rid: v.to(TP_KW["device"])
                for rid, v in runs[0].pop("rows").items()}
        ref_rows = ref.pop("rows")
        if mode == "bucketed":      # the control's reference, cut to size
            n = TP_CONTROL_TOKENS
            control_ref = ([types.SimpleNamespace(
                rid=b.rid, temperature=b.temperature,
                output_ids=b.output_ids[:n]) for b in theirs],
                {rid: v[:n] for rid, v in ref_rows.items()})
        logits = _logit_check(torch, mine, rows, theirs, ref_rows)
        del rows
        check(logits["max_abs_logit_diff"] <= tol,
              f"tp {mode}: every logit row scored from the one-card "
              f"engine's context within {tol} (max "
              f"{logits['max_abs_logit_diff']} at {logits['worst']})")
        ratios = {}
        for key in ("layer_weight_bytes", "pool_bytes"):
            ratios[key] = [run[key] / ref[key] for run in runs]
            check(all(abs(x - 0.5) <= 0.5 * TP_BYTES_MARGIN
                      for x in ratios[key]),
                  f"tp {mode}: each rank's {key} half the one-card "
                  f"engine's within {TP_BYTES_MARGIN}: {ratios[key]}")
        for run in runs:
            add(run["launches"])
        keep = ("steps", "all_reduces", "sampled_steps", "stats", "wall_s",
                "wall_per_step_s", "decode_wall_per_step_s",
                "layer_weight_bytes", "pool_bytes", "allocated_bytes",
                "launches")
        summary[mode] = {
            "one_card": {k: ref[k] for k in keep},
            "ranks": [{k: run[k] for k in keep} for run in runs],
            "byte_ratios": ratios, "logit_tolerance": tol, **logits}
        emit({"phase": "tp_serve", "model": "llama3_8b", "layers": L,
              "tp": TP_DEGREE, "mode": mode, "nvidia_smi": smi,
              "transport": "gloo, CUDA tensors staged through the host, two "
                           "ranks on one card",
              **summary[mode]})
    # the control: the last layer's MLP all-reduce skipped on every rank
    control = ranks[0]["control"]
    mine = [types.SimpleNamespace(rid=b.rid, temperature=b.temperature,
                                  output_ids=control["tokens"][b.rid])
            for b in control_ref[0]]
    rows = {rid: v.to(TP_KW["device"])
            for rid, v in control.pop("rows").items()}
    caught = _logit_check(torch, mine, rows, *control_ref)
    del rows, control_ref
    check(control["skipped"] > 0 and caught["max_abs_logit_diff"] > tol,
          f"tp control: a rank that skips its last layer's MLP all-reduce "
          f"is caught by the logit gate ({caught['max_abs_logit_diff']} > "
          f"{tol})")
    emit({"phase": "tp_control", "nvidia_smi": smi,
          "fault": "the last layer's MLP all-reduce skipped on both ranks",
          "tokens_a_request": TP_CONTROL_TOKENS,
          "forwards_skipped": control["skipped"], "logit_tolerance": tol,
          "sound_max_abs_logit_diff": {
              m: summary[m]["max_abs_logit_diff"] for m in summary},
          **{k: caught[k] for k in ("max_abs_logit_diff", "worst",
                                    "per_rid", "greedy_agreeing_share")}})
    _GUARD["ranks"] = [r["guard"] for r in ranks]
    emit({"phase": "tp", "nvidia_smi": smi, "ranks_wall_s": ranks_wall,
          "init_params_s": [r["init_params_s"] for r in ranks],
          "all_reduce_decode_ms": [r["all_reduce_decode_ms"] for r in ranks],
          "all_reduce_note": "[8, 1, 4096] bf16 through gloo on one card, "
                             "staged through the host: not NCCL's time"})
    return total


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


def phase_profile(torch, np, eng, Request, decode, extra_groups=(),
                  settle=False) -> None:
    """Where a full-depth step's time goes: torch.profiler over four steps
    of eight 512-token requests (the engine of phase 6, after its serve:
    decode steps, or on a chunked engine mixed steps streaming the
    prompts; ``settle``: decode steps after the prompts streamed in),
    device time summed by layer (the split-K combine kernel with
    ``decode``, the fused decode kernel it follows; ``extra_groups``,
    name fragments -> layer, are tried first), and the device's busy share
    of the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    for i in range(eng.max_batch):
        eng.add_request(Request(rid=1000 + i, prompt_ids=rng.integers(
            0, eng.cfg.vocab_size, size=512).astype(np.int32),
            max_new_tokens=40 if settle else 8))
    eng.step()                      # admission + prefills + 1 decode step
    while settle and any(i is not None for i in eng._prefill_ids):
        eng.step()
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
            (g for frag, g in (*extra_groups, *_KERNEL_GROUPS)
             if frag in name),
            "other")
        groups[group] = groups.get(group, 0.0) + dev_us
        if group == "other":
            other[evt.key[:60]] = dev_us / steps / 1e3
    while eng.step() or eng._queue:  # finish the profiled requests
        pass
    emit({"phase": "profile", "paged": eng.paged, "kv_quant": eng.kv_quant,
          "quant": eng.quant,
          "step_kind": ("mixed" if eng._chunked and not settle
                        else "decode"),
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
                                           max_seq=2048, paged=True,
                                           block_size=64, kv_quant=kvq,
                                           device="cuda")
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


def _flash_check(torch, tfa, q, k, v, do, kw, label,
                 routes=ROUTES) -> dict:
    """The three kernels against their plain versions on one case, each on
    ``routes`` (default both); returns the errors by route and the tensors
    the timing reuses.  Each kernel runs before the plain version it is
    held to, so no output of a kernel can sit in a recycled block that
    still holds the plain values."""
    fwd = {route: tfa.flash_fwd_cuda(q, k, v, route=route, **kw)
           for route in routes}
    out_p, lse_p = tfa.flash_fwd_ref(q, k, v, **kw)
    delta = (out_p.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = {route: (tfa.flash_dkv_cuda(q, k, v, do, lse_p, delta, route=route,
                                      **kw),
                   tfa.flash_dq_cuda(q, k, v, do, lse_p, delta, route=route,
                                     **kw))
           for route in routes}
    torch.cuda.synchronize()
    dk_p, dv_p = tfa.flash_dkv_ref(q, k, v, do, lse_p, delta, **kw)
    dq_p = tfa.flash_dq_ref(q, k, v, do, lse_p, delta, **kw)
    live = lse_p > -1e29
    dead = (~live).transpose(1, 2)
    res = {"dead_rows": int(dead.sum())}
    for route in routes:
        (out, lse), ((dk, dv), dq) = fwd[route], bwd[route]
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


def _device_groups(torch, prof, groups_of,
                   ranges=()) -> tuple[dict, float, dict]:
    """Device microseconds by group from a profile, their total, and the
    largest 'other' kernels.  ``ranges``: the names of ``record_function``
    ranges, whose span the device timeline also carries (left out)."""
    groups: dict[str, float] = {}
    other: dict[str, float] = {}
    total = 0.0
    cuda_kind = torch.autograd.DeviceType.CUDA
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", cuda_kind) != cuda_kind
                or evt.key in ranges):
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


def _kernels_vs_plain(torch, label, run, leaves_of) -> dict:
    """``run(which)`` -> (loss, grads) with the kernels ('kernels') and
    with ``PADDLE_TPU_TORCH_DISABLE_KERNELS=all`` ('plain'), from the same
    parameters and batch: the loss, gradient norm and every gradient leaf
    held to phase 9's tolerances; the kernel run launched each of
    ``leaves_of``, the plain run nothing."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

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
    for which, disable in (("kernels", None), ("plain", "all")):
        if disable is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = disable
        kernels.reset_counters()
        try:
            loss, grads = run(which)
        finally:
            os.environ.pop(env, None)
        launches = dict(kernels.LAUNCHES)
        if disable is None:
            check(all(launches[k] > 0 for k in leaves_of),
                  f"{label}: the kernel run launched {leaves_of}: "
                  f"{launches}")
        else:
            check(all(v == 0 for v in launches.values()),
                  f"{label}: the plain run launched no kernel: {launches}")
        runs[which] = (loss.item(), llama.global_norm(grads).item(), grads,
                       launches)
    (lk, gk, dk, lnk), (lp, gp, dp, _) = runs["kernels"], runs["plain"]
    leaf_err = [((a.float() - b_.float()).abs().max()
                 / b_.float().abs().max()).item() for a, b_ in zip(dk, dp)]
    check(abs(lk - lp) <= loss_tol,
          f"{label}: loss {lk} vs {lp} within {loss_tol}")
    check(abs(gk - gp) <= gnorm_rel_tol * gp,
          f"{label}: gnorm {gk} vs {gp} within {gnorm_rel_tol} relative")
    check(max(leaf_err) <= leaf_rel_tol,
          f"{label}: gradient leaves within {leaf_rel_tol} of their max: "
          f"{leaf_err}")
    return {"loss": {"kernels": lk, "plain": lp}, "loss_tolerance": loss_tol,
            "gnorm": {"kernels": gk, "plain": gp},
            "gnorm_rel_tolerance": gnorm_rel_tol,
            "leaf_max_err_over_leaf_max": leaf_err,
            "leaf_tolerance": leaf_rel_tol, "kernel_launches": lnk}


def phase_train_end_to_end(torch, np) -> None:
    """2 full-width layers: loss, gradient norm and every gradient leaf with
    the kernels and with every kernel disabled (flash -> the composed
    oracle, rms_norm -> its plain version), from the same parameters and
    batch."""
    from paddle_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=2)
    b, s = 2, 2048
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                        device="cuda")
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device="cuda")

    def run(which):
        params = llama.init_params(cfg, seed=7, device="cuda")
        return llama.loss_and_grads(cfg, params, ids, labels)

    res = _kernels_vs_plain(torch, "train", run, FLASH_KERNELS + (
        "flash_attention_fwd_tc", "flash_attention_dkv_tc",
        "flash_attention_dq_tc", "rms_norm"))
    emit({"phase": "train_end_to_end", "layers": cfg.num_hidden_layers,
          **res})
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 20-21: the MoE decoder (A10's moe_llama) and the DiT (A10's dit)
# ---------------------------------------------------------------------------

#: phase 20's depth: DeepSeekMoE-16B's 28 layers would be ~16.4B
#: parameters, ~260 GB under AdamW's 16 bytes a parameter; 4 layers are
#: 2.77B (587.8M a layer, 419.4M of embedding and head)
MOE_LAYERS = 4
#: depth of the kernels-vs-plain runs of phases 20 (c) and 21 (b)
MOE_E2E_LAYERS, DIT_E2E_BLOCKS = 2, 4
#: dispatch engines against each other (bf16 out): the MLP's tolerance,
#: one bf16 ulp of the value twice over plus one of the output's largest
DISPATCH_REL, DISPATCH_FLOOR = 2.0 ** -6, 2.0 ** -7
#: the DiT's step-1 loss: a fresh model outputs exactly 0 (adaLN-Zero), so
#: it is mean((eps - x0)^2) over 32 x 4 x 32 x 32 draws of N(0, 2): 2
#: within 6 standard deviations (sqrt(8 / 131072) = 0.0078)
DIT_LOSS0, DIT_LOSS0_TOL = 2.0, 0.05

#: ops whose kernels form a train step's MoE dispatch group (the stable
#: sort, the scatter into the expert buffer, the gathers, ``index_add``,
#: and their backward)
_DISPATCH_OPS = frozenset({
    "aten::sort", "aten::index_copy", "aten::index_copy_", "aten::index",
    "aten::index_add", "aten::index_add_", "aten::index_select",
    "aten::index_put_", "aten::_index_put_impl_", "aten::bincount",
    "aten::cumsum"})
#: kernels launched through ctypes, grouped by name
_HAND_KERNELS = _TRAIN_GROUPS[:7]


def _step_groups(torch, prof) -> tuple[dict, float]:
    """Device ms of a profiled train step by group, each kernel by the op
    that launched it: the hand kernels by name, AdamW (every kernel under
    the step's ``adamw`` range), the expert matmuls (``aten::bmm``), the
    other matmuls (``aten::mm`` / ``addmm``), the MoE dispatch ops
    (:data:`_DISPATCH_OPS`, the embedding's excluded), the rest 'other',
    and 'unlinked' for device time no op claims.  Returns (groups, total
    device ms)."""
    cuda = torch.autograd.DeviceType.CUDA
    _, total, _ = _device_groups(torch, prof, (), ranges=("adamw",))
    groups: dict[str, float] = {}
    linked = 0.0
    for e in prof.events():
        if e.device_type == cuda or not e.kernels:
            continue
        chain, p = set(), e
        while p is not None:
            chain.add(p.name)
            p = p.cpu_parent
        for kern in e.kernels:
            name = kern.name.lower()
            group = next((gr for frag, gr in _HAND_KERNELS if frag in name),
                         None)
            if group is None:
                if "adamw" in chain:
                    group = "adamw"
                elif chain & {"aten::embedding",
                              "aten::embedding_dense_backward"}:
                    group = "other"
                elif e.name in _DISPATCH_OPS:
                    group = "dispatch"
                else:
                    group = {"aten::bmm": "expert matmuls",
                             "aten::mm": "matmuls",
                             "aten::addmm": "matmuls"}.get(e.name, "other")
            groups[group] = groups.get(group, 0.0) + kern.duration
            linked += kern.duration
    if total > linked:
        groups["unlinked"] = total - linked
    return {k: v / 1e3 for k, v in sorted(groups.items())}, total / 1e3


def _profiled_step(torch, step_fn) -> dict:
    """One train step under torch.profiler, AdamW inside an ``adamw``
    range: device ms by op group and by kernel, the busy share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.models import llama

    update = llama.adamw_update

    def traced(*a, **kw):
        with record_function("adamw"):
            return update(*a, **kw)

    llama.adamw_update = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn()
            wall = time.perf_counter() - t0
    finally:
        llama.adamw_update = update
    by_op, total = _step_groups(torch, prof)
    by_kernel, _, other = _device_groups(torch, prof, _TRAIN_GROUPS,
                                         ranges=("adamw",))
    return {"wall_ms": wall * 1e3,
            "device_ms_by_op": by_op if total else "not measured",
            "device_ms_by_kernel": ({k: v / 1e3 for k, v in sorted(
                by_kernel.items())} if total else "not measured"),
            "device_ms_total": total or None,
            "device_busy_share": total / 1e3 / wall if total else None,
            "other_top_ms": {k: v / 1e3 for k, v in sorted(
                other.items(), key=lambda kv: -kv[1])[:8]}}


def _close_err(got, want, rel, floor) -> dict:
    ref = want.float().abs()
    err = (got.float() - want.float()).abs()
    tol = ref * rel + ref.max() * floor
    return {"max_abs_err": err.max().item(),
            "worst_err_over_tol": (err / tol).max().item()}


def phase_moe_dispatch(torch, np, dev="cuda") -> dict:
    """Phase 20 (a): one layer's ``moe_ffn`` at DeepSeekMoE-16B widths
    (h 2048, 64 experts of 1408, top-6) on 2 x 2048 tokens, random bf16
    weights (the router f32): the dense and sort engines give every
    (token, k) pair the same expert slot (so the same keep mask) and
    outputs within the MLP's tolerance; the dropless ragged engine equals
    sort at a capacity that drops nothing; aux and z; each engine's time
    (CUDA events; ragged includes its one host read of the group sizes).
    Dense and sort are compared at the config's capacity factor and at
    0.5, where queues certainly overflow."""
    from paddle_tpu_torch.models import moe_llama as tmoe

    base = tmoe.MoEConfig.deepseek_moe_16b()
    h, E, mi, K = (base.hidden_size, base.num_experts,
                   base.moe_intermediate_size, base.top_k)
    b, s = 2, 2048
    tokens = b * s
    g = torch.Generator(device=dev)
    g.manual_seed(20)

    def rand(*shape, dtype=torch.bfloat16, std=0.02):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    lp = {"router": rand(h, E, dtype=torch.float32), "e_gate": rand(E, h, mi),
          "e_up": rand(E, h, mi), "e_down": rand(E, mi, h)}
    x = rand(b, s, h, std=1.0)
    cfg = {m: dataclasses.replace(base, dispatch=m)
           for m in ("dense", "sort", "ragged")}
    with torch.no_grad():
        _, _, topk_i, aux, z = tmoe.route(base, x.reshape(tokens, h),
                                          lp["router"])
        order, sorted_e, counts = tmoe._sorted_pairs(topk_i, E)
        cases = {}
        # the config's capacity factor, and half the mean queue (drops
        # certain)
        for cf in (base.capacity_factor, 0.5):
            c = {m: dataclasses.replace(cfg[m], capacity_factor=cf)
                 for m in ("dense", "sort")}
            cap = tmoe.capacity(c["sort"], tokens)
            pos = tmoe._queue_positions(topk_i, E)
            slot_dense = torch.where(pos < cap, topk_i * cap + pos, -1)
            pos_s = (torch.arange(tokens * K, device=dev)
                     - (torch.cumsum(counts, 0) - counts)[sorted_e])
            slot_s = torch.where(pos_s < cap, sorted_e * cap + pos_s, -1)
            slot_sort = torch.empty_like(slot_s).index_copy_(
                0, order, slot_s).reshape(tokens, K)
            check(torch.equal(slot_dense, slot_sort),
                  f"dense and sort at capacity {cap}: the same expert slot "
                  f"and keep mask for every (token, k) pair")
            outs = {m: tmoe.moe_ffn(c[m], x, lp) for m in ("dense", "sort")}
            check(all(torch.equal(o[1], aux) and torch.equal(o[2], z)
                      for o in outs.values()),
                  "aux and z shared by the engines")
            cases[f"capacity_factor_{cf}"] = {
                "capacity": cap, "pairs_dropped": int((slot_dense < 0).sum()),
                **_close_err(outs["sort"][0], outs["dense"][0],
                             DISPATCH_REL, DISPATCH_FLOOR)}
        check(cases["capacity_factor_0.5"]["pairs_dropped"] > 0,
              f"capacity factor 0.5 drops pairs: {cases}")
        sort_vs_dense = cases
        # a capacity factor whose cap holds the fullest expert's queue
        most = int(counts.max())
        nodrop = {m: dataclasses.replace(
            cfg[m], capacity_factor=most * E / (K * tokens))
            for m in ("sort", "ragged")}
        cap_nd = tmoe.capacity(nodrop["sort"], tokens)
        check(cap_nd >= most, f"no-drop cap {cap_nd} >= {most}")
        ragged_vs_sort = _close_err(
            tmoe.moe_ffn(nodrop["ragged"], x, lp)[0],
            tmoe.moe_ffn(nodrop["sort"], x, lp)[0],
            DISPATCH_REL, DISPATCH_FLOOR)
        for label, err in (*cases.items(),
                           ("ragged vs sort (no drops)", ragged_vs_sort)):
            check(err["worst_err_over_tol"] <= 1.0,
                  f"moe dispatch {label} within tolerance ({err})")
        ms = {m: time_ms(torch, lambda m=m: tmoe.moe_ffn(cfg[m], x, lp))
              for m in ("dense", "sort", "ragged")}
    res = {"phase": "moe_dispatch", "tokens": tokens, "experts": E,
           "top_k": K, "pairs": tokens * K, "largest_queue": most,
           "no_drop_capacity": cap_nd, "aux": aux.item(), "z": z.item(),
           "sort_vs_dense": sort_vs_dense,
           "ragged_vs_sort_no_drops": ragged_vs_sort,
           "tolerance": "|d| <= 2^-6|ref| + 2^-7 max|ref|",
           "ms": ms}
    emit(res)
    del lp, x, outs
    torch.cuda.empty_cache()
    return res


def phase_moe_train(torch, np, dev="cuda") -> dict:
    """Phase 20 (b): DeepSeekMoE-16B widths cut to ``MOE_LAYERS`` layers
    (the sort engine, full recompute) take 5 AdamW steps on one batch of
    2 x 2048 seeded tokens; the loss falls; the launch counts prove every
    layer went through B1 and the three flash kernels on the tensor-core
    route; step ms, tokens/s, MFU over the active parameters, peak GB, and
    one profiled step by group."""
    from paddle_tpu_torch.models import moe_llama as tmoe
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    cfg = dataclasses.replace(tmoe.MoEConfig.deepseek_moe_16b(),
                              num_hidden_layers=MOE_LAYERS)
    L, b, s, steps = cfg.num_hidden_layers, 2, 2048, 5
    check(tmoe.resolved_dispatch(cfg) == "sort", "64 experts dispatch by sort")
    torch.cuda.reset_peak_memory_stats()
    params = tmoe.init_params(cfg, seed=21, device=dev)
    train_step, opt_init = tmoe.build_train_step(cfg)
    opt = opt_init(params)
    g = torch.Generator(device=dev)
    g.manual_seed(22)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    torch.cuda.synchronize()
    kernels.reset_counters()
    fallbacks0 = tfa.FALLBACK_CALLS
    losses, gnorms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, opt = train_step(params, opt, ids, labels)
        losses.append(loss.item())          # synchronizes
        gnorms.append(opt["gnorm"].item())
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    fallbacks = tfa.FALLBACK_CALLS - fallbacks0
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"moe losses {losses} and gnorms {gnorms} finite")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.5,
          f"moe step-1 loss {losses[0]} near ln(V) = "
          f"{math.log(cfg.vocab_size)}")
    check(losses[-1] < losses[0], f"the moe loss falls: {losses}")
    want = {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_fwd_tc": 2 * L * steps,
            "flash_attention_dkv": L * steps,
            "flash_attention_dkv_tc": L * steps,
            "flash_attention_dq": L * steps,
            "flash_attention_dq_tc": L * steps,
            "rms_norm": (4 * L + 1) * steps}
    for name, n in want.items():
        check(launches[name] == n, f"moe {name} launches {launches[name]} "
                                   f"== {n} (full recompute, {steps} steps)")
    check(fallbacks == 0, f"no composed-attention fallback ({fallbacks})")
    step_s = statistics.median(times[1:])
    tok_s = b * s / step_s
    res = {"phase": "moe_train",
           "model": f"deepseek_moe_16b widths, {L} layers",
           "params": tmoe.count_params(params),
           "active_params_per_token": tmoe.active_params_per_token(cfg),
           "dispatch": "sort", "batch": b, "seq": s, "remat": "full",
           "steps": steps, "losses": losses, "gnorms": gnorms,
           "step_s": times, "step_ms_median_2_5": step_s * 1e3,
           "tokens_per_s": tok_s,
           "mfu_active_excluding_recompute":
               tmoe.flops_per_token(cfg, s) * tok_s / BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "flash_fallback_calls": fallbacks,
           "launches_per_step": {k: v // steps for k, v in want.items()}}
    emit(res)

    def one_step():
        nonlocal params, opt
        loss, params, opt = train_step(params, opt, ids, labels)
        loss.item()

    emit({"phase": "moe_train_profile", **_profiled_step(torch, one_step)})
    del params, opt
    torch.cuda.empty_cache()
    return launches


class _RoutingReplay:
    """Holds a kernels-vs-plain comparison of a MoE model to one routing:
    ``moe_llama.top_k`` patched to record each call's experts ('record')
    and to hand them back in call order ('replay'), counting the pairs the
    replaying run would have routed otherwise.  In bf16 the kernels and the
    plain versions round the router's input differently, which moves the
    k-th pick of a token whose k-th and (k+1)-th probabilities nearly tie:
    one such pair moves whole rows of the expert gradients."""

    def __init__(self, tmoe):
        self.tmoe, self.top_k = tmoe, tmoe.top_k
        self.mode, self.idx, self.at, self.moved, self.pairs = (
            "record", [], 0, 0, 0)
        tmoe.top_k = self

    def __call__(self, probs, k):
        vals, idx = self.top_k(probs, k)
        if self.mode == "record":
            self.idx.append(idx)
            return vals, idx
        rec = self.idx[self.at]
        self.at += 1
        same = (rec.sort(-1).values == idx.sort(-1).values).all(-1)
        self.moved += int((~same).sum())
        self.pairs += idx.shape[0]
        return probs.gather(-1, rec), rec

    def restore(self):
        self.tmoe.top_k = self.top_k


def phase_moe_end_to_end(torch, np, dev="cuda") -> None:
    """Phase 20 (c): ``MOE_E2E_LAYERS`` full-width DeepSeekMoE-16B layers,
    loss, gradient norm and every gradient leaf with the kernels and with
    every kernel off, from the same parameters and batch, the plain run
    replaying the kernel run's routing (:class:`_RoutingReplay`)."""
    from paddle_tpu_torch.models import moe_llama as tmoe

    cfg = dataclasses.replace(tmoe.MoEConfig.deepseek_moe_16b(),
                              num_hidden_layers=MOE_E2E_LAYERS)
    b, s = 2, 2048
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=dev)
    replay = _RoutingReplay(tmoe)

    def run(which):
        replay.mode = "record" if which == "kernels" else "replay"
        params = tmoe.init_params(cfg, seed=24, device=dev)
        return tmoe.loss_and_grads(cfg, params, ids, labels)

    try:
        res = _kernels_vs_plain(torch, "moe", run, FLASH_KERNELS + (
            "flash_attention_fwd_tc", "flash_attention_dkv_tc",
            "flash_attention_dq_tc", "rms_norm"))
    finally:
        replay.restore()
    check(replay.at == len(replay.idx) == 2 * cfg.num_hidden_layers,
          f"the plain run replayed every routing call ({replay.at} of "
          f"{len(replay.idx)})")
    emit({"phase": "moe_end_to_end", "layers": cfg.num_hidden_layers,
          "tokens_rerouted_without_replay": replay.moved,
          "tokens_routed": replay.pairs, **res})
    torch.cuda.empty_cache()


def phase_dit_train(torch, np, dev="cuda") -> dict:
    """Phase 21 (a): DiT-XL/2 at full depth (28 blocks, h 1152, 16 heads of
    72, 32x32x4 latents, patch 2: 256 tokens) takes 5 AdamW steps on one
    batch of 32 seeded latents and labels under one key; the step-1 loss
    is ``DIT_LOSS0`` within ``DIT_LOSS0_TOL``, the loss falls; the launch
    counts prove every block went through the three flash kernels on the
    CUDA-core route (head_dim 72: no ``_tc`` launch); step ms, images/s,
    tokens/s, MFU, peak GB, one profiled step by group."""
    from paddle_tpu_torch.models import dit as tdit
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.utils import threefry

    cfg = tdit.DiTConfig.dit_xl_2()
    D, b, steps = cfg.depth, 32, 5
    check(tfa.flash_route(cfg.dtype, cfg.head_dim) == "cc",
          f"head_dim {cfg.head_dim} takes the CUDA-core flash route")
    torch.cuda.reset_peak_memory_stats()
    params = tdit.init_params(cfg, seed=25, device=dev)
    n_params = tdit.count_params(params)
    train_step, opt_init = tdit.build_train_step(cfg)
    opt = opt_init(params)
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    c, hw = cfg.in_channels, cfg.image_size
    x0 = torch.randn(b, c, hw, hw, generator=g, device=dev)
    y = torch.randint(0, cfg.num_classes, (b,), generator=g, device=dev)
    key = threefry.prng_key(27, device=dev)
    torch.cuda.synchronize()
    kernels.reset_counters()
    fallbacks0 = tfa.FALLBACK_CALLS
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, opt = train_step(params, opt, x0, y, key)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    fallbacks = tfa.FALLBACK_CALLS - fallbacks0
    check(all(math.isfinite(v) for v in losses),
          f"dit losses {losses} finite")
    check(abs(losses[0] - DIT_LOSS0) <= DIT_LOSS0_TOL,
          f"dit step-1 loss {losses[0]} within {DIT_LOSS0_TOL} of "
          f"{DIT_LOSS0} (the zero-init output against eps - x0)")
    check(losses[-1] < losses[0], f"the dit loss falls: {losses}")
    want = {"flash_attention_fwd": 2 * D * steps,
            "flash_attention_dkv": D * steps,
            "flash_attention_dq": D * steps,
            "flash_attention_fwd_tc": 0, "flash_attention_dkv_tc": 0,
            "flash_attention_dq_tc": 0, "rms_norm": 0}
    for name, n in want.items():
        check(launches[name] == n, f"dit {name} launches {launches[name]} "
                                   f"== {n} (full recompute, {steps} steps)")
    check(fallbacks == 0, f"no composed-attention fallback ({fallbacks})")
    step_s = statistics.median(times[1:])
    tok_s = b * cfg.num_patches / step_s
    res = {"phase": "dit_train", "model": "dit_xl_2 (full depth)",
           "params": n_params, "batch": b, "tokens_per_image":
           cfg.num_patches, "remat": "full", "steps": steps,
           "losses": losses, "step_s": times,
           "step_ms_median_2_5": step_s * 1e3, "images_per_s": b / step_s,
           "tokens_per_s": tok_s,
           "mfu_excluding_recompute":
               tdit.flops_per_token(cfg, n_params) * tok_s / BF16_FLOPS,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "flash_fallback_calls": fallbacks,
           "launches_per_step": {k: v // steps for k, v in want.items()}}
    emit(res)

    def one_step():
        nonlocal params, opt
        loss, params, opt = train_step(params, opt, x0, y, key)
        loss.item()

    emit({"phase": "dit_train_profile", **_profiled_step(torch, one_step)})
    del params, opt
    torch.cuda.empty_cache()
    return launches


def phase_dit_end_to_end(torch, np, dev="cuda") -> None:
    """Phase 21 (b): ``DIT_E2E_BLOCKS`` DiT-XL/2 blocks with EVERY leaf
    random (at init the adaLN-Zero leaves are 0 and the blocks get no
    gradient), loss, gradient norm and every gradient leaf with the
    kernels and with every kernel off."""
    from paddle_tpu_torch.models import dit as tdit
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.utils import threefry

    cfg = dataclasses.replace(tdit.DiTConfig.dit_xl_2(),
                              depth=DIT_E2E_BLOCKS)
    b = 32
    g = torch.Generator(device=dev)
    g.manual_seed(28)
    c, hw = cfg.in_channels, cfg.image_size
    x0 = torch.randn(b, c, hw, hw, generator=g, device=dev)
    y = torch.randint(0, cfg.num_classes, (b,), generator=g, device=dev)
    key = threefry.prng_key(29, device=dev)

    def run(which):
        params = tdit.init_params(cfg, seed=30, device=dev)
        gw = torch.Generator(device=dev)
        gw.manual_seed(31)
        with torch.no_grad():
            for leaf in llama.tree_leaves(params):
                leaf.copy_(torch.randn(leaf.shape, generator=gw,
                                       device=dev) * 0.02)
        return tdit.loss_and_grads(cfg, params, x0, y, key)

    res = _kernels_vs_plain(torch, "dit", run, FLASH_KERNELS)
    check(all(res["kernel_launches"][f"{k}_tc"] == 0 for k in FLASH_KERNELS),
          "dit: every flash launch on the CUDA-core route")
    emit({"phase": "dit_end_to_end", "blocks": cfg.depth, **res})
    torch.cuda.empty_cache()


def phase_dit_flash(torch) -> dict:
    """Phase 21 (c): the three flash kernels at DiT-XL/2's shape (b 32,
    s 256, 16 heads of 72, non-causal, bf16), on the CUDA-core route the
    rule gives head_dim 72, against their plain versions and timed beside
    them, SDPA non-causal and the bound.  Returns name -> numbers for the
    kernels line (``flash_attention_*_cc``)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4322)
    b, s, hq, hkv, d = 32, 256, 16, 16, 72
    check(tfa.flash_route(torch.bfloat16, d) == "cc",
          "head_dim 72 takes the CUDA-core route")
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)

    def flush():
        scratch.zero_()

    q, k, v, do, kw = _flash_case(torch, tfa, g, dev, b, s, s, hq, hkv, d,
                                  False)
    res, (lse, delta) = _flash_check(torch, tfa, q, k, v, do, kw,
                                     "dit shape", routes=("cc",))
    pairs = b * hq * s * s
    el = 2
    qb, kvb, rowb = b * s * hq * d * el, b * s * hkv * d * el, b * hq * s * 4
    bounds = {"fwd": bound_ms(qb + 2 * kvb + qb + rowb, 4 * d * pairs),
              "dkv": bound_ms(2 * qb + 2 * kvb + 2 * rowb + 2 * kvb,
                              8 * d * pairs),
              "dq": bound_ms(2 * qb + 2 * kvb + 2 * rowb + qb, 6 * d * pairs)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_forward():
        with torch.no_grad():
            return sdpa(qt, kt, vt)

    lib_fwd = time_ms(torch, lib_forward, flush=flush)
    out_t = sdpa(qt, kt, vt)
    do_t = do.transpose(1, 2).contiguous()
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), do_t, retain_graph=True), flush=flush)
    del out_t
    timed = {
        "fwd": (lambda: tfa.flash_fwd_cuda(q, k, v, **kw),
                lambda: tfa.flash_fwd_ref(q, k, v, **kw), lib_fwd),
        "dkv": (lambda: tfa.flash_dkv_cuda(q, k, v, do, lse, delta, **kw),
                lambda: tfa.flash_dkv_ref(q, k, v, do, lse, delta, **kw),
                lib_bwd),
        "dq": (lambda: tfa.flash_dq_cuda(q, k, v, do, lse, delta, **kw),
               lambda: tfa.flash_dq_ref(q, k, v, do, lse, delta, **kw),
               lib_bwd)}
    out = {}
    for part, (kern, plain, lib) in timed.items():
        name = f"flash_attention_{part}_cc"
        bnd, by = bounds[part]
        out[name] = {
            "shape": {"b": b, "sq": s, "skv": s, "hq": hq, "hkv": hkv,
                      "d": d, "dtype": "bfloat16", "causal": False},
            **_route_errs(res["cc"], part),
            "tolerance": "|d| <= 2^-7|ref| + 2^-10 max|ref| (f32 order, "
                         "one bf16 rounding)",
            "route": "cc (flash_route at head_dim 72)",
            "ms": time_ms(torch, kern, flush=flush),
            "plain_ms": time_ms(torch, plain, flush=flush),
            "library_ms": lib,
            "library_call": ("scaled_dot_product_attention forward"
                             if part == "fwd" else
                             "scaled_dot_product_attention backward: "
                             "dq+dk+dv together"),
            "bound_ms": bnd, "bound_by": by, "pairs": pairs}
        emit({"phase": "kernel", "name": name, **out[name]})
    del q, k, v, do, lse, delta, qt, kt, vt, do_t, scratch
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 22: hybrid-parallel training (A11's first slice) as gloo ranks
# ---------------------------------------------------------------------------

#: phase 22's depth: 2 layers of Llama-3-8B widths are 1.487B parameters,
#: ~23.8 GB a whole replica under AdamW's 16 bytes a parameter, which dp=2
#: and sep=2 hold on each of two ranks sharing one card (phase 8's 4
#: layers, ~31 GB a replica, would not fit twice)
DIST_LAYERS = 2
#: the spawns: (ranks, ((label, mesh axes, sep attention), ...)); a spawn
#: runs its meshes in turn, each mesh's tensors freed before the next
DIST_RUNS = ((2, (("mp2", {"mp": 2}, "ring"),
                  ("sharding2", {"sharding": 2}, "ring"),
                  ("dp2", {"dp": 2}, "ring"),
                  ("sep2_ring", {"sep": 2}, "ring"),
                  ("sep2_ulysses", {"sep": 2}, "ulysses"))),
             (4, (("sharding2_mp2", {"sharding": 2, "mp": 2}, "ring"),)))
#: the leaves whose step-1 gradient shards every rank holds to the
#: one-card step's: the vocab-parallel embedding and head, a
#: column-parallel and a row-parallel matrix, one with its ZeRO split on
#: each dim
DIST_GRAD_LEAVES = ("embed", "lm_head", "layers/wq", "layers/w_gate",
                    "layers/w_down")
#: phase 9's tolerances (bf16 through 2 layers forward and back): the
#: loss within 2^-8 of ~12, gnorm and each gradient leaf's largest error
#: within 2^-5 of the reference's (the leaf's largest value)
DIST_LOSS_TOL, DIST_REL_TOL = 2.0 ** -8 * 12, 2.0 ** -5
#: the device of the ranks' tensors (a CPU rehearsal sets "cpu")
DIST_KW = {"device": "cuda"}
DIST_SEED = 11


def _dist_cfg():
    from paddle_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                               num_hidden_layers=DIST_LAYERS)


def _dist_batch(torch, cfg, dev):
    """Phase 8's batch: 2 x 2048 seeded token ids and labels."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    return tuple(torch.randint(0, cfg.vocab_size, (2, 2048), generator=g,
                               device=dev) for _ in range(2))


def _dist_expected(label: str, L: int) -> dict:
    """The collectives one step of a rank runs, predicted from the design
    (full recompute; the recompute stops at the last tensor the backward
    saved, before a layer's MLP ``psum``).  Under mp: each layer's two
    row-parallel ``psum`` and the first again in the recompute (3L), its
    two ``copy_to`` cotangent sums (2L), the embedding's ``psum``, the
    head's ``copy_to`` and its sum-exp and label-logit sums, one max.  A
    batch axis: the loss's sum, and one sum a leaf the axis does not
    split (dp, sep: all 12; sharding: the 3 norms).  The clipping norm:
    one sum for the leaves split over the same live axes.  ZeRO: each
    layer's 7 matrices gathered in the forward and the recompute and
    reduce-scattered once, ``embed`` and ``lm_head`` once each.  The ring
    at sep=2: one K/V exchange a layer in the forward, the recompute and
    the backward, each staged through the host; Ulysses: four all-to-alls
    a layer, three times."""
    mp_sums = 5 * L + 4
    zero = {"all_gather": 14 * L + 2, "reduce_scatter": 7 * L + 2}
    table = {
        "mp2": {"all_reduce": mp_sums + 1, "all_reduce_max": 1},
        "sharding2": {"all_reduce": 1 + 3 + 1, **zero},
        "dp2": {"all_reduce": 1 + 12},
        "sep2_ring": {"all_reduce": 1 + 12, "ppermute": 3 * L,
                      "host_staged": 3 * L},
        "sep2_ulysses": {"all_reduce": 1 + 12, "all_to_all": 12 * L},
        "sharding2_mp2": {"all_reduce": mp_sums + 1 + 3 + 1,
                          "all_reduce_max": 1, **zero},
    }
    want = dict.fromkeys(("all_reduce", "all_reduce_max", "all_gather",
                          "reduce_scatter", "all_to_all", "ppermute",
                          "host_staged"), 0)
    want.update(table[label])
    if DIST_KW["device"] != "cuda":
        want["host_staged"] = 0
    return want


def _dist_checksums(torch, cfg, mesh, specs, trees) -> dict:
    """Every leaf of ``trees`` (the parameters and the f32 masters) whose
    shard two ranks hold is the same bits on both: each rank's integer
    checksums of its shards (the bits summed, and weighted by position),
    one all-gather of them, then the ranks at equal coordinates on a
    leaf's split axes compared."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.models import llama

    named = llama.named_specs(cfg, specs)
    chunk = 1 << 24
    pos = torch.arange(chunk, device=DIST_KW["device"]) % 65521 + 1
    sums = []
    for tree in trees:
        for leaf in llama.tree_leaves(tree):
            bits = leaf.detach().contiguous().view(
                torch.int16 if leaf.element_size() == 2 else torch.int32)
            bits = bits.reshape(-1)
            plain = weighted = 0
            for i in range(0, bits.numel(), chunk):
                part = bits[i:i + chunk].long()
                plain = plain + part.sum()
                weighted = weighted + (part * pos[:part.numel()]).sum()
            sums += [plain, weighted]
    mine = torch.stack(sums).cpu()
    every = torch.empty(mesh.size * mine.numel(), dtype=mine.dtype)
    dist.all_gather_into_tensor(every, mine)
    every = every.view(mesh.size, -1)
    coords = [mesh.coords_of(r) for r in range(mesh.size)]
    compared, unequal = 0, []
    for t in range(len(trees)):
        for i, (name, spec) in enumerate(named):
            j = 2 * (t * len(named) + i)
            axes = dmesh.spec_axes(spec)
            held = {}
            for r in range(mesh.size):
                key = tuple(coords[r][a] for a in axes)
                if key in held:
                    compared += 1
                    if not torch.equal(every[r, j:j + 2],
                                       every[held[key], j:j + 2]):
                        unequal.append((t, name, r, held[key]))
                else:
                    held[key] = r
    return {"compared": compared, "unequal": unequal}


def _dist_mesh_run(torch, cfg, ref, label, kw, impl) -> dict:
    """One mesh on this rank: the rank's shards of the seeded weights and
    batch, its step-1 gradient shards of ``DIST_GRAD_LEAVES`` against the
    one-card step's (``ref``), then two train steps (the first with each
    collective timed between two synchronizations, the second untimed for
    the step's wall), each step's loss, gnorm, launches and collectives,
    the replicated leaves' checksums after step 2, the peak memory."""
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.utils import convert

    dev = torch.device(DIST_KW["device"])
    torch.cuda.reset_peak_memory_stats()
    mesh = llama.make_mesh(**kw)
    step, opt_init, specs, dspec = llama.build_train_step(
        cfg, mesh, sep_attn_impl=impl)
    full = llama.init_params(cfg, seed=DIST_SEED, device=dev)
    params = convert.shard_params(cfg, full, specs, mesh)
    del full
    torch.cuda.empty_cache()
    ids, labels = (dmesh.shard_leaf(t, dspec, mesh)
                   for t in _dist_batch(torch, cfg, dev))
    _, grads = llama.loss_and_grads(cfg, params, ids, labels, mesh, impl)
    grad_err = {}
    for (name, spec), g in zip(llama.named_specs(cfg, specs), grads):
        if name in DIST_GRAD_LEAVES:
            want = dmesh.shard_leaf(ref["grads"][name], spec, mesh).to(dev)
            grad_err[name] = ((g.float() - want.float()).abs().max()
                              / ref["grad_max"][name]).item()
    del grads, want
    opt = opt_init(params)
    torch.cuda.synchronize()
    steps, fallbacks = [], tfa.FALLBACK_CALLS
    for i in range(2):
        dmesh.TIMING["on"] = i == 0
        dmesh.reset_counters()
        kernels.reset_counters()
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, ids, labels)
        loss = loss.item()              # synchronizes
        wall = time.perf_counter() - t0
        dmesh.TIMING["on"] = False
        steps.append({"loss": loss, "gnorm": opt["gnorm"].item(),
                      "wall_ms": wall * 1e3,
                      "collectives": dict(dmesh.COUNTERS),
                      "launches": dict(kernels.LAUNCHES)})
    same = _dist_checksums(torch, cfg, mesh, specs, (params, opt["master"]))
    out = {"coords": mesh.coords, "grad_err": grad_err, "steps": steps,
           "replicated": same,
           "flash_fallbacks": tfa.FALLBACK_CALLS - fallbacks,
           "step_ms": steps[1]["wall_ms"],
           "collective_s_step1": steps[0]["collectives"]["seconds"],
           "collective_share_step1": steps[0]["collectives"]["seconds"]
           / (steps[0]["wall_ms"] / 1e3),
           "collective_gb_a_step": steps[1]["collectives"]["bytes"] / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, opt, ids, labels
    torch.cuda.empty_cache()
    return out


def _dist_rank(rank: int, tmp: str, world: int, meshes) -> None:
    """One rank of phase 22, a spawned process on the one card: joins the
    gloo group (a file store in ``tmp``), runs each of ``meshes`` in turn
    (``_dist_mesh_run``) and saves what it saw to
    ``tmp/rank{world}_{rank}.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    if DIST_KW["device"] == "cuda":
        torch.cuda.set_device(0)
    os.environ["PADDLE_TPU_REMAT"] = "full"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        cfg = _dist_cfg()
        ref = torch.load(os.path.join(tmp, "ref.pt"), mmap=True,
                         weights_only=True)
        out = {"rank": rank, "meshes": {}}
        for label, kw, impl in meshes:
            t0 = time.perf_counter()
            out["meshes"][label] = _dist_mesh_run(torch, cfg, ref, label, kw,
                                                  impl)
            out["meshes"][label]["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(tmp, f"rank{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dist_kernel_checks(torch) -> dict:
    """The path's kernels at a rank's shapes: the three flash kernels at
    mp=2's and Ulysses' local heads (b 2, s 2048, 16 / 4 heads of 128,
    causal) on the tensor-core route, and B1 at 2048 rows of 4096 (one
    rank's rows under dp, sharding or sep), each against its plain
    version (phase 4's and phase 3's tolerances)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import rms_norm as rms

    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    q, k, v, do, kw = _flash_case(torch, tfa, g, "cuda", 2, 2048, 2048, 16,
                                  4, 128, True)
    check(tfa.flash_route(q.dtype, 128) == "tc",
          "a rank's flash shape takes the tensor-core route")
    res, _ = _flash_check(torch, tfa, q, k, v, do, kw, "rank 16/4 heads",
                          routes=("tc",))
    x = torch.randn(1, 2048, 4096, generator=g, device="cuda").to(
        torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(4096, generator=g, device="cuda")).to(
        torch.bfloat16)
    got, want = rms.rms_norm_cuda(x, w, 1e-5), rms.rms_norm_ref(x, w, 1e-5)
    err = (got.float() - want.float()).abs()
    check(bool((err <= want.float().abs() * 2.0 ** -7 + 1e-6).all()),
          "rms_norm at a rank's 2048 rows within 1 ulp")
    return {"flash_16_4_heads": res["tc"],
            "rms_norm_2048_rows_max_abs_err": err.max().item()}


def phase_dist_train(torch, np, smi: str) -> dict:
    """Hybrid-parallel training at Llama-3-8B widths (``DIST_LAYERS``
    layers) as gloo ranks sharing the one card (NCCL refuses two ranks on
    one device; gloo stages CUDA tensors through the host).  First the
    path's kernels at a rank's shapes (``_dist_kernel_checks``); then the
    one-card ``build_train_step(cfg)`` on the same seeded weights and
    batch, whose step-1 gradients of ``DIST_GRAD_LEAVES`` and two steps'
    loss and gnorm are the reference (saved to a temp dir; its tensors
    freed before the spawns); then the spawns of ``DIST_RUNS``.  Gates, a
    rank and a mesh: steps 1-2 loss within ``DIST_LOSS_TOL`` and gnorm
    within ``DIST_REL_TOL`` of the reference's; each gradient shard's
    largest error within ``DIST_REL_TOL`` of its leaf's largest value;
    every leaf two ranks hold equal bit for bit after step 2; a step's
    launches exact (B1 4L + 1, flash 2L / L / L every one on the tensor
    cores, none under the ring) and its collectives as
    ``_dist_expected`` predicts; the ranks' peak memory together below
    the card's.  Reports each rank's step ms, the collectives' wall share
    of step 1 and its GB, and the peak GB.  Returns the ranks' launches,
    summed."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from paddle_tpu_torch.models import llama

    checks = _dist_kernel_checks(torch)
    emit({"phase": "dist_kernels", "nvidia_smi": smi, **checks})
    cfg = _dist_cfg()
    L, dev = cfg.num_hidden_layers, DIST_KW["device"]
    os.environ["PADDLE_TPU_REMAT"] = "full"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist")
    total: dict = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        params = llama.init_params(cfg, seed=DIST_SEED, device=dev)
        one = {"params": llama.count_params(params), "losses": [],
               "gnorms": [], "wall_ms": []}
        ids, labels = _dist_batch(torch, cfg, dev)
        _, grads = llama.loss_and_grads(cfg, params, ids, labels)
        names = [n for n, _ in llama.named_specs(cfg, llama.param_specs(cfg))]
        keep = {n: g for n, g in zip(names, grads) if n in DIST_GRAD_LEAVES}
        torch.save({"grads": {n: g.cpu() for n, g in keep.items()},
                    "grad_max": {n: g.float().abs().max().item()
                                 for n, g in keep.items()}},
                   os.path.join(tmp, "ref.pt"))
        del grads, keep
        step, opt_init = llama.build_train_step(cfg)
        opt = opt_init(params)
        for _ in range(2):
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, ids, labels)
            one["losses"].append(loss.item())
            one["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            one["gnorms"].append(opt["gnorm"].item())
        one["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, opt, loss, ids, labels
        torch.cuda.empty_cache()
        check(all(math.isfinite(x) for x in one["losses"] + one["gnorms"]),
              f"dist reference: finite losses {one['losses']} and gnorms "
              f"{one['gnorms']}")
        emit({"phase": "dist_reference", "nvidia_smi": smi,
              "model": f"llama3_8b widths, {L} layers", **one})
        capacity = (torch.cuda.mem_get_info()[1] if dev == "cuda"
                    else float("inf"))
        for world, meshes in DIST_RUNS:
            t0 = time.perf_counter()
            mp.spawn(_dist_rank, args=(tmp, world, meshes), nprocs=world,
                     join=True)
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(tmp, f"rank{world}_{r}.pt"),
                                weights_only=False) for r in range(world)]
            for label, kw, impl in meshes:
                runs = [r["meshes"][label] for r in ranks]
                _dist_gates(cfg, label, kw, impl, one, runs, capacity)
                for run in runs:
                    for s in run["steps"]:
                        for k, v in s["launches"].items():
                            total[k] = total.get(k, 0) + v
                emit({"phase": "dist_train", "mesh": label, "axes": kw,
                      "sep_attention": impl if kw.get("sep") else None,
                      "ranks": world, "nvidia_smi": smi,
                      "model": f"llama3_8b widths, {L} layers, 2 x 2048 "
                               f"tokens, full recompute",
                      "transport": "gloo on one card: CUDA tensors staged "
                                   "through the host, not NCCL",
                      "one_card": {k: one[k] for k in ("losses", "gnorms")},
                      "per_rank": [{
                          "coords": {a: c for a, c in run["coords"].items()
                                     if kw.get(a, 1) > 1},
                          "losses": [s["loss"] for s in run["steps"]],
                          "gnorms": [s["gnorm"] for s in run["steps"]],
                          "grad_err_over_leaf_max": run["grad_err"],
                          "step_ms": run["step_ms"],
                          "step1_ms": run["steps"][0]["wall_ms"],
                          "collective_s_step1": run["collective_s_step1"],
                          "collective_share_step1":
                              run["collective_share_step1"],
                          "collective_gb_a_step":
                              run["collective_gb_a_step"],
                          "collectives_a_step": {
                              k: v for k, v in
                              run["steps"][1]["collectives"].items()
                              if k not in ("bytes", "seconds") and v},
                          "peak_gb": run["peak_gb"],
                          "replicated_compared":
                              run["replicated"]["compared"],
                          "seconds": run["seconds"]} for run in runs],
                      "spawn_s": spawn_s})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("PADDLE_TPU_REMAT", None)
    return total


def _dist_gates(cfg, label, kw, impl, one, runs, capacity) -> None:
    """Phase 22's gates on one mesh's ranks (see ``phase_dist_train``)."""
    L = cfg.num_hidden_layers
    ring = impl == "ring" and kw.get("sep", 1) > 1
    flash = {"flash_attention_fwd": 0 if ring else 2 * L,
             "flash_attention_fwd_tc": 0 if ring else 2 * L,
             "flash_attention_dkv": 0 if ring else L,
             "flash_attention_dkv_tc": 0 if ring else L,
             "flash_attention_dq": 0 if ring else L,
             "flash_attention_dq_tc": 0 if ring else L}
    want_l = {"rms_norm": 4 * L + 1, **flash}
    want_c = _dist_expected(label, L)
    for r, run in enumerate(runs):
        who = f"dist {label} rank {r}"
        for i, s in enumerate(run["steps"]):
            check(abs(s["loss"] - one["losses"][i]) <= DIST_LOSS_TOL,
                  f"{who} step {i + 1}: loss {s['loss']} vs the one-card "
                  f"{one['losses'][i]} within {DIST_LOSS_TOL}")
            check(abs(s["gnorm"] - one["gnorms"][i])
                  <= DIST_REL_TOL * one["gnorms"][i],
                  f"{who} step {i + 1}: gnorm {s['gnorm']} vs "
                  f"{one['gnorms'][i]} within {DIST_REL_TOL} relative")
            got_l = {k: s["launches"][k] for k in want_l}
            check(got_l == want_l, f"{who} step {i + 1}: launches {got_l} "
                                   f"== {want_l}")
            got_c = {k: s["collectives"][k] for k in want_c}
            check(got_c == want_c, f"{who} step {i + 1}: collectives "
                                   f"{got_c} == {want_c}")
        check(set(run["grad_err"]) == set(DIST_GRAD_LEAVES)
              and max(run["grad_err"].values()) <= DIST_REL_TOL,
              f"{who}: step-1 gradient shards within {DIST_REL_TOL} of "
              f"their leaf's max: {run['grad_err']}")
        check(run["flash_fallbacks"] == 0,
              f"{who}: no composed-attention fallback")
        check(not run["replicated"]["unequal"]
              and run["replicated"]["compared"] > 0,
              f"{who}: every leaf two ranks hold is equal bit for bit "
              f"({run['replicated']})")
    peak = sum(run["peak_gb"] for run in runs) * 1e9
    check(peak < capacity, f"dist {label}: the ranks' peaks together "
                           f"{peak / 1e9} GB below the card's "
                           f"{capacity / 1e9} GB")


# ---------------------------------------------------------------------------
# phase 23: the pipeline axis (A11 b) as gloo ranks
# ---------------------------------------------------------------------------

#: phase 23's depth: VPP at pp=2 x 2 chunks needs L % 4 == 0; a pp=2
#: rank then holds embed + lm_head and 2 of the 4 layers, 1.487B
#: parameters, phase 22's dp=2 rank
PP_LAYERS = 4
#: phase 8's 4096 tokens a step as 4 rows of 1024, in 4 microbatches (ZB
#: needs M >= 2(P - 1) + 1 = 3, VPP M % P == 0)
PP_BATCH, PP_MICRO = (4, 1024), 4
#: the spawns: (ranks, ((label, mesh axes, pipeline_schedule,
#: num_chunks), ...)), each mesh from the same seeded weights
PP_RUNS = ((2, (("gpipe", {"pp": 2}, "gpipe", None),
                ("1f1b", {"pp": 2}, "1f1b", None),
                ("vpp", {"pp": 2}, "vpp", 2),
                ("zb", {"pp": 2}, "zb", None))),
           (4, (("pp2_mp2_1f1b", {"pp": 2, "mp": 2}, "1f1b", None),)))
PP_SEED = 13
#: a stage's loss within 2^-8 of the one-card loss at that step, relative:
#: step 2's loss is ~0.11, so phase 22's absolute 2^-8 x 12 would hold it
#: to 43% of its value (read on one H100: up to 3.3e-3 relative, gpipe)
PP_LOSS_REL = 2.0 ** -8


def _pp_cfg():
    from paddle_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                               num_hidden_layers=PP_LAYERS)


def _pp_batch(torch, cfg, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    return tuple(torch.randint(0, cfg.vocab_size, PP_BATCH, generator=g,
                               device=dev) for _ in range(2))


def _pp_chunks(schedule: str, num_chunks) -> int:
    return (num_chunks or 2) if schedule in ("vpp", "interleave") else 1


def _pp_clock(P: int, M: int, C: int, zb: bool, s: int) -> list:
    """Stage ``s``'s sub-ticks on the reference's global clock, from its
    formulas (not the engine's code): ``order_f`` takes P microbatches at
    a time round-robin over the C chunks; tick k runs the F of
    ``order_f[k - s]``, the B of ``order_f[k - D + s]`` with its chunk
    mirrored (D = 2(P - 1) + (C - 1)P), and under ZB the W of microbatch
    k - s - M for the first min(M, D - s).  Returns (k, phase, m, c)."""
    order = ([(g + r % P, r // P) for g in range(0, M, P)
              for r in range(P * C)] if C > 1 else
             [(m, 0) for m in range(M)])
    D = 2 * (P - 1) + (C - 1) * P
    out = []
    for k in range(M * C + D):
        if 0 <= k - s < M * C:
            out.append((k, "F") + order[k - s])
        if 0 <= k - D + s < M * C:
            m, c = order[k - D + s]
            out.append((k, "B", m, C - 1 - c))
        if zb and 0 <= k - s - M < min(M, D - s):
            out.append((k, "W", k - s - M, 0))
    return out


def _pp_evals(schedule: str, P: int, M: int, C: int, s: int) -> dict:
    """What one step of stage ``s`` evaluates: stage forwards without
    autograd (``f``: each F sub-tick but the last stage's last chunk,
    fused into its B), stage forwards with autograd and their backward
    (``b``: each B, and under ZB each W, but stage 0's deferred B, which
    defers all), head evaluations (``head``) and embeddings (``emb``).
    GPipe: M forwards with autograd and their backward, one head and one
    embedding on the whole batch."""
    if schedule in ("gpipe", "fthenb"):
        return {"f": 0, "b": M, "head": 1, "emb": 1}
    zb = schedule in ("zb", "zero_bubble")
    z = min(M, 2 * (P - 1) - s)
    ticks = _pp_clock(P, M, C, zb, s)
    last = lambda c: s == P - 1 and c == C - 1
    return {"f": sum(ph == "F" and not last(c) for _, ph, _, c in ticks),
            "b": sum(ph == "W" or (ph == "B" and not (zb and s == 0
                                                       and m < z))
                     for _, ph, m, c in ticks),
            "head": sum(ph in ("B", "W") and last(c)
                        for _, ph, _, c in ticks),
            "emb": M if s == 0 else 0}


def _pp_launches(schedule: str, P: int, M: int, C: int, L: int,
                 s: int) -> dict:
    """The kernel launches of one step of stage ``s`` (full recompute:
    a block's backward recomputes it, B1 twice and the flash forward once):
    a forward of a chunk's Lv layers runs B1 2Lv and the flash forward Lv
    times, a backward evaluation 4Lv, 2Lv, and dK/dV and dQ Lv each; a head
    evaluation runs the final norm once (:func:`_pp_evals`)."""
    e = _pp_evals(schedule, P, M, C, s)
    Lv = L // P // (1 if schedule in ("gpipe", "fthenb") else C)
    flash = {"flash_attention_fwd": Lv * e["f"] + 2 * Lv * e["b"],
             "flash_attention_dkv": Lv * e["b"],
             "flash_attention_dq": Lv * e["b"]}
    return {"rms_norm": 2 * Lv * e["f"] + 4 * Lv * e["b"] + e["head"],
            **flash, **{f"{k}_tc": v for k, v in flash.items()}}


def _pp_expected(cfg, schedule: str, kw: dict, C: int, s: int) -> dict:
    """The collectives of one step of stage ``s`` and the bytes it sends,
    predicted from the design.

    1F1B clock (:func:`_pp_clock`): a stage sends the activation of each
    F sub-tick but the last stage's last chunk and the cotangent of each B
    but stage 0's chunk 0, and receives its neighbours' (open chain at C =
    1, ring else), each tensor one ``send_recv``, a tick with any one
    host-staged call; the loss summed over pp, and ``embed``,
    ``final_norm``, ``lm_head``'s gradients (the stage-owned leaves);
    VPP moves each of the 9 layer leaves' one off-rank chunk out and one
    in, the weights before the step and the gradients after (one staged
    call a leaf each way).  GPipe: M + P - 2 open-chain shifts and as many
    transposes (each staged; a stage sends where it has a neighbour), the
    last stage's outputs summed over pp and the embedding's cotangent
    (``copy_to``).  The clipping norm: one sum a set of live split axes.
    mp adds phase 22's sums: two ``psum`` a layer in each forward, and in
    a backward evaluation the first again (the recompute) and two
    ``copy_to`` cotangent sums; the embedding's ``psum``; the head's
    ``copy_to`` cotangent, sum-exp and label-logit sums and one max."""
    from paddle_tpu_torch.models import llama

    P, M, mp = kw.get("pp", 1), PP_MICRO, kw.get("mp", 1)
    L, h, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    gpipe = schedule in ("gpipe", "fthenb")
    Lv = L // P // (1 if gpipe else C)
    rows, seq = PP_BATCH
    tok = rows // M * seq                   # a microbatch's positions
    act = tok * h * 2
    want = dict.fromkeys(("all_reduce", "all_reduce_max", "all_gather",
                          "reduce_scatter", "all_to_all", "ppermute",
                          "send_recv", "host_staged"), 0)
    split = {("pp",), ("pp", "mp") if mp > 1 else ("pp",)}
    if mp > 1:
        split.add(("mp",))
    want["all_reduce"] += len(split)
    nbytes = 4 * len(split)
    if gpipe:
        T = M + P - 1
        want["ppermute"] = want["host_staged"] = 2 * (T - 1)
        nbytes += act * (T - 1) * ((s < P - 1) + (s > 0))
        want["all_reduce"] += 2
        nbytes += 2 * M * act
        tok_head = tok_emb = M * tok
    else:
        zb = schedule in ("zb", "zero_bubble")
        prv, nxt = ((s - 1) % P, (s + 1) % P) if C > 1 else (s - 1, s + 1)
        mine = _pp_clock(P, M, C, zb, s)
        sends = [k for k, ph, m, c in mine
                 if (ph == "F" and not (s == P - 1 and c == C - 1))
                 or (ph == "B" and not (s == 0 and c == 0))]
        recvs = []
        if 0 <= prv < P:
            recvs += [k for k, ph, m, c in _pp_clock(P, M, C, zb, prv)
                      if ph == "F" and not (prv == P - 1 and c == C - 1)]
        if 0 <= nxt < P:
            recvs += [k for k, ph, m, c in _pp_clock(P, M, C, zb, nxt)
                      if ph == "B" and not (nxt == 0 and c == 0)]
        want["send_recv"] = len(sends) + len(recvs)
        want["host_staged"] = len(set(sends) | set(recvs))
        nbytes += act * len(sends)
        want["all_reduce"] += 1 + 3
        nbytes += 4 + (2 * V * h // mp + h) * 2
        if C > 1:
            shapes = llama.serving_matmul_shapes(cfg)
            per_layer = sum(math.prod(v[1:]) for v in shapes.values()) + 2 * h
            want["send_recv"] += 2 * 2 * 9
            want["host_staged"] += 2 * 9
            nbytes += 2 * Lv * per_layer * 2
        tok_head, tok_emb = tok, tok
    if mp > 1:
        e = _pp_evals(schedule, P, M, C, s)
        lay = 2 * Lv * e["f"] + 5 * Lv * e["b"]
        want["all_reduce"] += lay + e["emb"] + 3 * e["head"]
        want["all_reduce_max"] += e["head"]
        nbytes += lay * act + e["emb"] * tok_emb * h * 2 \
            + e["head"] * (tok_head * h * 2 + 3 * tok_head * 4)
    if DIST_KW["device"] != "cuda":
        want["host_staged"] = 0
    want["bytes"] = nbytes
    return want


def _pp_order(schedule: str, P: int, M: int, C: int, s: int,
              trace) -> dict:
    """Stage ``s``'s executed sub-ticks against the port's copy of the
    reference's oracles (``distributed/fleet/pipeline.py``'s docstring
    says which): 1F1B / VPP equal ``schedule_interleave(P, M, C)``'s line;
    ZB's F and B ticks equal ``schedule_interleave(P, M, 1)``'s and its W
    ticks are microbatches 0 .. Z(s) - 1, each after its B; GPipe runs
    ``schedule_fthenb``'s forwards, then its backwards reversed."""
    from paddle_tpu_torch.distributed.fleet import pipeline as pl

    line = lambda ticks: pl.format_schedule([ticks]).split(": ", 1)[1]
    got = line(trace)
    if schedule in ("gpipe", "fthenb"):
        ref = pl.schedule_fthenb(P, M)[s]
        want = line([t for t in ref if t.phase == "F"]
                    + [t for t in reversed(ref) if t.phase == "B"])
        return {"executed": got, "oracle": line(ref), "ok": got == want}
    oracle = pl.schedule_interleave(P, M, C)[s]
    if schedule not in ("zb", "zero_bubble"):
        return {"executed": got, "oracle": line(oracle),
                "ok": got == line(oracle)}
    fb = [t for t in trace if t.phase != "W"]
    w = [t.mb for t in trace if t.phase == "W"]
    z = min(M, 2 * (P - 1) - s)
    after_b = all(trace.index(pl.Tick(s, m, "W")) >
                  trace.index(pl.Tick(s, m, "B")) for m in w)
    return {"executed": got, "oracle": line(oracle),
            "ok": line(fb) == line(oracle) and w == list(range(z))
            and after_b}


def _pp_mesh_run(torch, cfg, ref, label, kw, schedule, num_chunks) -> dict:
    """One pipeline mesh on this rank (phase 22's ``_dist_mesh_run`` for
    the pp axis): the rank's shards of the seeded weights and batch, its
    step-1 gradient shards of ``DIST_GRAD_LEAVES`` against the one-card
    step's, then two train steps (the first with each collective timed,
    the second untimed), each step's loss, gnorm, launches, collectives
    and executed sub-ticks, the replicated leaves' checksums after step
    2, the peak memory."""
    from paddle_tpu_torch.distributed import mesh as dmesh
    from paddle_tpu_torch.distributed.fleet import pipeline as pl
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.utils import convert

    dev = torch.device(DIST_KW["device"])
    torch.cuda.reset_peak_memory_stats()
    mesh = llama.make_mesh(**kw)
    C = _pp_chunks(schedule, num_chunks)
    step, opt_init, specs, dspec = llama.build_train_step(
        cfg, mesh, num_microbatches=PP_MICRO, pipeline_schedule=schedule,
        num_chunks=num_chunks)
    full = llama.init_params(cfg, seed=PP_SEED, device=dev)
    params = convert.shard_params(cfg, full, specs, mesh)
    del full
    torch.cuda.empty_cache()
    ids, labels = (dmesh.shard_leaf(t, dspec, mesh)
                   for t in _pp_batch(torch, cfg, dev))
    if schedule == "gpipe":
        _, grads = llama.loss_and_grads(cfg, params, ids, labels, mesh,
                                        num_microbatches=PP_MICRO)
    else:
        _, grads = llama.loss_and_grads_1f1b(
            cfg, params, ids, labels, mesh, PP_MICRO, num_chunks=C,
            zero_bubble=schedule == "zb")
    grad_err = {}
    for (name, spec), g in zip(llama.named_specs(cfg, specs), grads):
        if name in DIST_GRAD_LEAVES:
            want = dmesh.shard_leaf(ref["grads"][name], spec, mesh).to(dev)
            grad_err[name] = ((g.float() - want.float()).abs().max()
                              / ref["grad_max"][name]).item()
    del grads, want
    opt = opt_init(params)
    torch.cuda.synchronize()
    steps, fallbacks = [], tfa.FALLBACK_CALLS
    for i in range(2):
        dmesh.TIMING["on"] = i == 0
        dmesh.reset_counters()
        kernels.reset_counters()
        t0 = time.perf_counter()
        loss, params, opt = step(params, opt, ids, labels)
        loss = loss.item()              # synchronizes
        wall = time.perf_counter() - t0
        dmesh.TIMING["on"] = False
        steps.append({"loss": loss, "gnorm": opt["gnorm"].item(),
                      "wall_ms": wall * 1e3,
                      "collectives": dict(dmesh.COUNTERS),
                      "launches": dict(kernels.LAUNCHES),
                      "trace": list(pl.TRACE)})
    same = _dist_checksums(torch, cfg, mesh, specs, (params, opt["master"]))
    out = {"coords": mesh.coords, "stage": mesh.coords["pp"],
           "grad_err": grad_err, "steps": steps, "replicated": same,
           "chunks": C, "flash_fallbacks": tfa.FALLBACK_CALLS - fallbacks,
           "step_ms": steps[1]["wall_ms"],
           "collective_s_step1": steps[0]["collectives"]["seconds"],
           "collective_share_step1": steps[0]["collectives"]["seconds"]
           / (steps[0]["wall_ms"] / 1e3),
           "collective_gb_a_step": steps[1]["collectives"]["bytes"] / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, opt, ids, labels
    torch.cuda.empty_cache()
    return out


def _pp_rank(rank: int, tmp: str, world: int, meshes) -> None:
    """One rank of phase 23 (a spawned process on the one card, as
    ``_dist_rank``): runs each of ``meshes`` in turn and saves what it
    saw to ``tmp/pp{world}_{rank}.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    if DIST_KW["device"] == "cuda":
        torch.cuda.set_device(0)
    os.environ["PADDLE_TPU_REMAT"] = "full"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pp{world}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        cfg = _pp_cfg()
        ref = torch.load(os.path.join(tmp, "ref.pt"), mmap=True,
                         weights_only=True)
        out = {"rank": rank, "meshes": {}}
        for label, kw, schedule, chunks in meshes:
            t0 = time.perf_counter()
            out["meshes"][label] = _pp_mesh_run(torch, cfg, ref, label, kw,
                                                schedule, chunks)
            out["meshes"][label]["seconds"] = time.perf_counter() - t0
        torch.save(out, os.path.join(tmp, f"pp{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _pp_kernel_checks(torch) -> dict:
    """The path's kernels at a stage's shapes: the three flash kernels at
    a microbatch (b 1, s 1024, causal) with 32 / 8 heads and mp=2's 16 /
    4, head_dim 128, on the tensor-core route, and B1 at a microbatch's
    1024 rows of 4096, each against its plain version (phase 4's and
    phase 3's tolerances)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa
    from paddle_tpu_torch.ops.kernels import rms_norm as rms

    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    out = {}
    for hq, hkv in ((32, 8), (16, 4)):
        q, k, v, do, kw = _flash_case(torch, tfa, g, "cuda", 1, 1024, 1024,
                                      hq, hkv, 128, True)
        check(tfa.flash_route(q.dtype, 128) == "tc",
              "a stage's flash shape takes the tensor-core route")
        res, _ = _flash_check(torch, tfa, q, k, v, do, kw,
                              f"stage {hq}/{hkv} heads", routes=("tc",))
        out[f"flash_{hq}_{hkv}_heads"] = res["tc"]
    x = torch.randn(1, 1024, 4096, generator=g, device="cuda").to(
        torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(4096, generator=g, device="cuda")).to(
        torch.bfloat16)
    got, want = rms.rms_norm_cuda(x, w, 1e-5), rms.rms_norm_ref(x, w, 1e-5)
    err = (got.float() - want.float()).abs()
    check(bool((err <= want.float().abs() * 2.0 ** -7 + 1e-6).all()),
          "rms_norm at a microbatch's 1024 rows within 1 ulp")
    out["rms_norm_1024_rows_max_abs_err"] = err.max().item()
    return out


def phase_pipeline(torch, np, smi: str) -> dict:
    """The pipeline axis at Llama-3-8B widths (``PP_LAYERS`` layers,
    ``PP_BATCH`` tokens in ``PP_MICRO`` microbatches, full recompute) as
    gloo ranks sharing the one card (phase 22's transport).  First the
    path's kernels at a stage's shapes (``_pp_kernel_checks``); then the
    one-card ``build_train_step(cfg)`` on the same seeded weights and
    batch, whose step-1 gradients of ``DIST_GRAD_LEAVES`` and two steps'
    loss and gnorm are the reference (its tensors freed before the
    spawns); then the spawns of ``PP_RUNS``: two ranks at pp=2 under
    gpipe, 1f1b, vpp (2 chunks) and zb in turn, four at pp=2 x mp=2
    under 1f1b.  Gates, a rank and a mesh: steps 1-2 loss within
    ``PP_LOSS_REL`` and gnorm within ``DIST_REL_TOL`` of the reference's,
    relative; each gradient shard's largest error within
    ``DIST_REL_TOL`` of its leaf's largest value; every leaf two ranks
    hold equal bit for bit after step 2; a step's launches exact
    (``_pp_launches``, every flash launch on the tensor cores) and its
    collectives and bytes as ``_pp_expected`` predicts; the executed
    sub-ticks as ``_pp_order`` reads them against the oracles; the ranks'
    peak memory together below the card's.  Reports each rank's step ms,
    the collectives' wall share of step 1 and GB a step, the peak GB and
    the executed and oracle orders.  Returns the ranks' launches,
    summed."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from paddle_tpu_torch.models import llama

    checks = _pp_kernel_checks(torch)
    emit({"phase": "pipeline_kernels", "nvidia_smi": smi, **checks})
    cfg = _pp_cfg()
    L, dev = cfg.num_hidden_layers, DIST_KW["device"]
    os.environ["PADDLE_TPU_REMAT"] = "full"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp")
    total: dict = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        params = llama.init_params(cfg, seed=PP_SEED, device=dev)
        one = {"params": llama.count_params(params), "losses": [],
               "gnorms": [], "wall_ms": []}
        ids, labels = _pp_batch(torch, cfg, dev)
        _, grads = llama.loss_and_grads(cfg, params, ids, labels)
        names = [n for n, _ in llama.named_specs(cfg, llama.param_specs(cfg))]
        keep = {n: g for n, g in zip(names, grads) if n in DIST_GRAD_LEAVES}
        torch.save({"grads": {n: g.cpu() for n, g in keep.items()},
                    "grad_max": {n: g.float().abs().max().item()
                                 for n, g in keep.items()}},
                   os.path.join(tmp, "ref.pt"))
        del grads, keep
        step, opt_init = llama.build_train_step(cfg)
        opt = opt_init(params)
        for _ in range(2):
            t0 = time.perf_counter()
            loss, params, opt = step(params, opt, ids, labels)
            one["losses"].append(loss.item())
            one["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            one["gnorms"].append(opt["gnorm"].item())
        one["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, opt, loss, ids, labels
        torch.cuda.empty_cache()
        check(all(math.isfinite(x) for x in one["losses"] + one["gnorms"]),
              f"pipeline reference: finite losses {one['losses']} and "
              f"gnorms {one['gnorms']}")
        emit({"phase": "pipeline_reference", "nvidia_smi": smi,
              "model": f"llama3_8b widths, {L} layers", **one})
        capacity = (torch.cuda.mem_get_info()[1] if dev == "cuda"
                    else float("inf"))
        for world, meshes in PP_RUNS:
            t0 = time.perf_counter()
            mp.spawn(_pp_rank, args=(tmp, world, meshes), nprocs=world,
                     join=True)
            spawn_s = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(tmp, f"pp{world}_{r}.pt"),
                                weights_only=False) for r in range(world)]
            for label, kw, schedule, chunks in meshes:
                runs = [r["meshes"][label] for r in ranks]
                orders = _pp_gates(cfg, label, kw, schedule, one, runs,
                                   capacity)
                for run in runs:
                    for s in run["steps"]:
                        for k, v in s["launches"].items():
                            total[k] = total.get(k, 0) + v
                emit({"phase": "pipeline", "mesh": label, "axes": kw,
                      "schedule": schedule, "chunks": runs[0]["chunks"],
                      "microbatches": PP_MICRO, "ranks": world,
                      "nvidia_smi": smi,
                      "model": f"llama3_8b widths, {L} layers, "
                               f"{PP_BATCH[0]} x {PP_BATCH[1]} tokens, "
                               f"full recompute",
                      "transport": "gloo on one card: CUDA tensors staged "
                                   "through the host, not NCCL",
                      "one_card": {k: one[k] for k in ("losses", "gnorms")},
                      "per_rank": [{
                          "coords": {a: c for a, c in run["coords"].items()
                                     if kw.get(a, 1) > 1},
                          "losses": [s["loss"] for s in run["steps"]],
                          "gnorms": [s["gnorm"] for s in run["steps"]],
                          "grad_err_over_leaf_max": run["grad_err"],
                          "step_ms": run["step_ms"],
                          "step1_ms": run["steps"][0]["wall_ms"],
                          "collective_s_step1": run["collective_s_step1"],
                          "collective_share_step1":
                              run["collective_share_step1"],
                          "collective_gb_a_step":
                              run["collective_gb_a_step"],
                          "collectives_a_step": {
                              k: v for k, v in
                              run["steps"][1]["collectives"].items()
                              if k not in ("bytes", "seconds") and v},
                          "launches_a_step": {
                              k: v for k, v in
                              run["steps"][1]["launches"].items() if v},
                          "peak_gb": run["peak_gb"],
                          "replicated_compared":
                              run["replicated"]["compared"],
                          "seconds": run["seconds"]} for run in runs],
                      "orders": orders, "spawn_s": spawn_s})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("PADDLE_TPU_REMAT", None)
    return total


def _pp_gates(cfg, label, kw, schedule, one, runs, capacity) -> dict:
    """Phase 23's gates on one mesh's ranks (see ``phase_pipeline``);
    returns each stage's executed and oracle orders."""
    L, P = cfg.num_hidden_layers, kw.get("pp", 1)
    orders = {}
    for r, run in enumerate(runs):
        who, s, C = f"pipeline {label} rank {r}", run["stage"], run["chunks"]
        want_l = _pp_launches(schedule, P, PP_MICRO, C, L, s)
        want_c = _pp_expected(cfg, schedule, kw, C, s)
        for i, st in enumerate(run["steps"]):
            check(abs(st["loss"] - one["losses"][i])
                  <= PP_LOSS_REL * one["losses"][i],
                  f"{who} step {i + 1}: loss {st['loss']} vs the one-card "
                  f"{one['losses'][i]} within {PP_LOSS_REL} relative")
            check(abs(st["gnorm"] - one["gnorms"][i])
                  <= DIST_REL_TOL * one["gnorms"][i],
                  f"{who} step {i + 1}: gnorm {st['gnorm']} vs "
                  f"{one['gnorms'][i]} within {DIST_REL_TOL} relative")
            got_l = {k: st["launches"][k] for k in want_l}
            check(got_l == want_l, f"{who} step {i + 1}: launches {got_l} "
                                   f"== {want_l}")
            got_c = {k: st["collectives"][k] for k in want_c}
            check(got_c == want_c, f"{who} step {i + 1}: collectives "
                                   f"{got_c} == {want_c}")
            order = _pp_order(schedule, P, PP_MICRO, C, s, st["trace"])
            check(order["ok"], f"{who} step {i + 1}: executed order "
                               f"{order['executed']} against the oracle "
                               f"{order['oracle']}")
        orders[f"stage{s}"] = {k: order[k] for k in ("executed", "oracle")}
        check(set(run["grad_err"]) == set(DIST_GRAD_LEAVES)
              and max(run["grad_err"].values()) <= DIST_REL_TOL,
              f"{who}: step-1 gradient shards within {DIST_REL_TOL} of "
              f"their leaf's max: {run['grad_err']}")
        check(run["flash_fallbacks"] == 0,
              f"{who}: no composed-attention fallback")
        check(not run["replicated"]["unequal"]
              and run["replicated"]["compared"] > 0,
              f"{who}: every leaf two ranks hold is equal bit for bit "
              f"({run['replicated']})")
    peak = sum(run["peak_gb"] for run in runs) * 1e9
    check(peak < capacity, f"pipeline {label}: the ranks' peaks together "
                           f"{peak / 1e9} GB below the card's "
                           f"{capacity / 1e9} GB")
    return orders


#: phase 18's sync guard: the phase ``timed`` runs (``"tp"`` in a rank
#: process), the windows of ``ContinuousBatchingEngine._host_overlap`` it
#: guarded in each phase, every error a window raised as (phase, message),
#: and phase 17's ranks' own ``{"windows", "errors"}``
#: phase 19's paged-only kernels: none may launch on a dense engine's or
#: the GenerationEngine's path (the fused decode step and MLP half, the
#: paged walks)
PAGED_KERNELS = ("fused_decode_step", "fused_quant_decode_step",
                 "fused_layer_mlp", "paged_prefill", "paged_verify",
                 "paged_decode", "flash_decode")
#: phase 19's GenerationEngine batch: 4 prompts of 512 tokens, 32 new
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 32
#: phase 19's quantized dense serve: the first layers, ``chunk`` 4
DENSE_QUANT_LAYERS, DENSE_QUANT_CHUNK = 4, 4


def _dense_launch_check(eng, launches, label) -> dict:
    """A dense serve's launches: ``rms_norm`` 2L + 1 times each forward
    (every prefill, every decode step of every chunk), no paged kernel.
    With kernels on; returns the forward count."""
    L = eng.cfg.num_hidden_layers
    forwards = eng.stats["decode_steps"] + eng.stats["prefills"]
    check(launches["rms_norm"] == (2 * L + 1) * forwards,
          f"{label}: rms_norm launches {launches['rms_norm']} == "
          f"{2 * L + 1} x {forwards} forwards")
    paged = {k: launches[k] + launches.get(f"{k}_tc", 0)
             for k in PAGED_KERNELS}
    check(not any(paged.values()), f"{label}: no paged kernel ran: {paged}")
    return forwards


def _guarded_serve(torch, eng, reqs, steps=None, add=True) -> dict:
    """``_serve_stepwise`` with the sync guard's windows counted: each of
    the engine's overlap windows ran through the guard (phase 18 checks
    none raised)."""
    before = _GUARD["windows"].get(_GUARD["phase"], 0)
    steps0 = eng.stats["host_overlap_steps"]
    rows = _serve_stepwise(torch, eng, reqs, steps=steps, add=add)
    guarded = _GUARD["windows"].get(_GUARD["phase"], 0) - before
    windows = eng.stats["host_overlap_steps"] - steps0
    check(windows > 0 and guarded == windows,
          f"every overlap window of the serve was guarded ({guarded} of "
          f"{windows})")
    return rows


def _dense_numbers(eng, reqs, wall) -> dict:
    st = eng.stats
    return {"decode_steps": st["decode_steps"], "prefills": st["prefills"],
            "decode_tokens": st["decode_tokens"],
            "decode_tokens_per_s": eng.decode_tokens_per_s,
            "decode_step_wall_ms": (st["decode_time_s"]
                                    / max(st["decode_steps"], 1)
                                    * eng.chunk * 1e3),
            "prefill_time_s": eng.prefill_time_s,
            "mean_ttft_s": statistics.mean(r.ttft_s for r in reqs),
            "wall_s": wall}


def _dense_rms_checks(torch, h) -> dict:
    """B1 at the GenerationEngine's rows (its prefill's [4, 512, h] and a
    decode step's [4, 1, h]) against its plain version, 1 bf16 ulp."""
    from paddle_tpu_torch.ops.kernels import rms_norm as rms

    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    w = (1.0 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(
        torch.bfloat16)
    out = {}
    for label, shape in (("gen_prefill", (GEN_BATCH, GEN_PROMPT, h)),
                         ("gen_decode", (GEN_BATCH, 1, h))):
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        got = rms.rms_norm_cuda(x, w, 1e-5)
        ref = rms.rms_norm_ref(x, w, 1e-5)
        err = (got.float() - ref.float()).abs()
        tol = ref.float().abs() * 2.0 ** -7 + 1e-6
        check(bool((err <= tol).all()), f"rms_norm {label} within 1 ulp")
        rows = x.numel() // h
        bnd, by = bound_ms(rows * h * 2 * 2 + h * 2, rows * h * 4)
        out[label] = {"shape": list(shape), "max_abs_err": err.max().item(),
                      "ms": time_ms(torch,
                                    lambda: rms.rms_norm_cuda(x, w, 1e-5)),
                      "plain_ms": time_ms(torch,
                                          lambda: rms.rms_norm_ref(x, w,
                                                                   1e-5)),
                      "bound_ms": bnd, "bound_by": by}
    return out


def phase_dense(torch, np, smi: str) -> dict:
    """Phase 19, the dense slot-cache engine (``paged=False``, the
    reference's default) and the GenerationEngine at Llama-3-8B width, the
    weights phase 6's.  (a) The 32-layer dense engine serves phase 6's 12
    requests bucketed, in turns with the paged bf16 engine on the same
    weights (dense, paged, dense: the first dense serve warms the card for
    the paged one, the second gives the warm dense numbers); every greedy
    logit row the first two scored from the same context agrees within
    ``SERVE_LOGIT_TOL``, the two dense serves emit the same tokens; B1 2L + 1 times a forward and
    no paged kernel; every overlap window guarded; a profile of the dense
    decode step (``phase_profile``).  (b) The first
    ``DENSE_QUANT_LAYERS`` layers under ``quant='int8'`` at ``chunk`` 4,
    against the same serve with ``PADDLE_TPU_TORCH_DISABLE_KERNELS=all``,
    row for row.  (c) ``GenerationEngine.generate`` at 32 layers on 4
    prompts of 512 tokens, 32 new: greedy, each token's logit row against
    the dense engine's for the same prompts; at temperature 0.8, tokens in
    the vocabulary; B1 2L + 1 times a forward.  Returns the phase's
    launches (the kernels-on runs)."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import kernels

    Engine, Request = serving.ContinuousBatchingEngine, serving.Request
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, seed=0, device="cuda")
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    tol = SERVE_LOGIT_TOL[None]
    total = {k: 0 for k in kernels.LAUNCHES}

    def requests():
        return make_requests(Request, np, 12, V, sampled=2, seed=0)

    def run(eng, reqs):
        kernels.reset_counters()
        t0 = time.perf_counter()
        rows = _guarded_serve(torch, eng, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r in reqs:
            check(r.status == "FINISHED"
                  and len(r.output_ids) == r.max_new_tokens
                  and all(0 <= t < V for t in r.output_ids),
                  f"rid {r.rid}: {r.max_new_tokens} tokens in the "
                  f"vocabulary")
        return rows, dict(kernels.LAUNCHES), wall

    # (a) the 32-layer dense serve against the paged bf16 engine, in turns
    # (dense, paged, dense): rows from the first of each, the numbers of
    # all three, a profile of the last dense engine's steps
    runs = {}
    for label, paged in (("dense", False), ("paged_bf16", True),
                         ("dense_2", False)):
        eng = Engine(cfg, params, max_batch=8, max_seq=2048, paged=paged,
                     block_size=64, device="cuda")
        if not paged:
            check(tuple(eng.cache_k.shape)
                  == (L, 8, cfg.num_key_value_heads, 2048, cfg.head_dim),
                  f"dense pools {tuple(eng.cache_k.shape)}")
        reqs = requests()
        rows, launches, wall = run(eng, reqs)
        if not paged:
            forwards = _dense_launch_check(eng, launches, label)
            check(0 < launches["gumbel_noise"] <= eng.stats["decode_steps"],
                  f"{label}: gumbel_noise launches "
                  f"{launches['gumbel_noise']}")
            check(bool(torch.isfinite(eng.last_logits).all()),
                  f"{label}: last logits finite")
            for k, v in launches.items():
                total[k] += v
        runs[label] = (reqs, rows, _dense_numbers(eng, reqs, wall),
                       launches)
        if label == "dense_2":
            pool_gb = 2 * eng.cache_k.numel() * eng.cache_k.element_size() \
                / 1e9
            phase_profile(torch, np, eng, Request, "none")
        del eng
        torch.cuda.empty_cache()
    (reqs, rows, _, launches), (ref_reqs, ref_rows, _, _) = (
        runs["dense"], runs["paged_bf16"])
    check([r.output_ids for r in reqs]
          == [r.output_ids for r in runs["dense_2"][0]],
          "the two dense serves emit the same tokens")
    served = _logit_check(torch, reqs, rows, ref_reqs, ref_rows)
    check(served["max_abs_logit_diff"] <= tol,
          f"dense vs paged logit rows within {tol} "
          f"({served['max_abs_logit_diff']})")
    emit({"phase": "dense_serve", "nvidia_smi": smi, "layers": L,
          "requests": len(reqs),
          "prompt_tokens": int(sum(len(r.prompt_ids) for r in reqs)),
          "kv_pool_gb": pool_gb, "forwards": forwards,
          "launches": {k: v for k, v in launches.items() if v},
          **{label: run_[2] for label, run_ in runs.items()},
          "logit_tolerance": tol, **served})
    del runs

    # (b) DENSE_QUANT_LAYERS layers, quant='int8', chunk 4: kernels on vs
    # every kernel off
    qcfg, qparams = _first_layers(cfg, params, DENSE_QUANT_LAYERS)
    quant = {}
    for label in ("on", "off"):
        if label == "off":
            os.environ["PADDLE_TPU_TORCH_DISABLE_KERNELS"] = "all"
        try:
            eng = Engine(qcfg, qparams, max_batch=8, max_seq=2048,
                         chunk=DENSE_QUANT_CHUNK, quant="int8", device="cuda")
            qreqs = requests()
            qrows, qlaunches, qwall = run(eng, qreqs)
        finally:
            os.environ.pop("PADDLE_TPU_TORCH_DISABLE_KERNELS", None)
        if label == "on":
            _dense_launch_check(eng, qlaunches, "int8 dense serve")
            for k, v in qlaunches.items():
                total[k] += v
        else:
            check(not any(qlaunches.values()),
                  f"kernels off: nothing launched {qlaunches}")
        quant[label] = (qreqs, qrows, _dense_numbers(eng, qreqs, qwall),
                        qlaunches)
        del eng
        torch.cuda.empty_cache()
    qcheck = _logit_check(torch, quant["on"][0], quant["on"][1],
                          quant["off"][0], quant["off"][1])
    check(qcheck["max_abs_logit_diff"] <= tol,
          f"int8 dense kernels on vs off within {tol} "
          f"({qcheck['max_abs_logit_diff']})")
    emit({"phase": "dense_quant", "layers": DENSE_QUANT_LAYERS,
          "chunk": DENSE_QUANT_CHUNK, "quant": "int8",
          "on": quant["on"][2], "off": quant["off"][2],
          "launches": {k: v for k, v in quant["on"][3].items() if v},
          "logit_tolerance": tol, **qcheck})

    # (c) the GenerationEngine, greedy and sampled, and the dense engine on
    # the same prompts
    rng = np.random.default_rng(19)
    prompts = rng.integers(0, V, size=(GEN_BATCH, GEN_PROMPT)).astype(
        np.int32)
    ge = GenerationEngine(cfg, params, max_seq=GEN_PROMPT + GEN_NEW,
                          device="cuda")
    inference = sys.modules["paddle_tpu_torch.inference"]
    head = inference.lm_head_logits
    calls = []

    def cap(cfg_, params_, x):
        z = head(cfg_, params_, x)
        calls.append(z.clone())
        return z

    gen = {}
    for label, kw in (("greedy", {}), ("sampled", dict(temperature=0.8,
                                                        seed=3))):
        calls.clear()
        kernels.reset_counters()
        inference.lm_head_logits = cap
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ge.generate(prompts, max_new_tokens=GEN_NEW, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            inference.lm_head_logits = head
        glaunches = dict(kernels.LAUNCHES)
        check(out.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
              and (out[:, :GEN_PROMPT] == prompts).all()
              and ((out >= 0) & (out < V)).all(),
              f"GenerationEngine {label}: the prompts and {GEN_NEW} tokens "
              f"in the vocabulary")
        check(len(calls) == GEN_NEW and glaunches["rms_norm"]
              == (2 * L + 1) * GEN_NEW,
              f"GenerationEngine {label}: {len(calls)} forwards, rms_norm "
              f"launches {glaunches['rms_norm']} == {2 * L + 1} x {GEN_NEW}")
        others = {k: v for k, v in glaunches.items() if v and k != "rms_norm"}
        check(not others, f"GenerationEngine {label}: only B1 launched, "
                          f"the draw is the plain threefry chain: {others}")
        for k, v in glaunches.items():
            total[k] += v
        gen[label] = {"wall_s": wall, "tokens_per_s":
                      GEN_BATCH * GEN_NEW / wall, "rms_norm": glaunches[
                          "rms_norm"], "draw_launches": glaunches[
                          "gumbel_noise"], "tokens": out[:, GEN_PROMPT:],
                      "rows": torch.stack(calls, dim=1)}   # [b, new, V]
    del ge
    torch.cuda.empty_cache()
    dense = Engine(cfg, params, max_batch=8, max_seq=2048, device="cuda")
    dreqs = [Request(rid=i, prompt_ids=prompts[i], max_new_tokens=GEN_NEW)
             for i in range(GEN_BATCH)]
    drows, dlaunches, _ = run(dense, dreqs)
    _dense_launch_check(dense, dlaunches, "dense serve of the prompts")
    for k, v in dlaunches.items():
        total[k] += v
    del dense
    torch.cuda.empty_cache()
    greedy = gen["greedy"]
    gen_reqs = [types.SimpleNamespace(rid=i, temperature=0.0,
                                      output_ids=[int(t) for t in
                                                  greedy["tokens"][i]])
                for i in range(GEN_BATCH)]
    gcheck = _logit_check(torch, gen_reqs,
                          {i: greedy["rows"][i] for i in range(GEN_BATCH)},
                          dreqs, drows)
    check(gcheck["max_abs_logit_diff"] <= tol,
          f"GenerationEngine vs the dense engine within {tol} "
          f"({gcheck['max_abs_logit_diff']})")
    emit({"phase": "generation_engine", "layers": L, "batch": GEN_BATCH,
          "prompt": GEN_PROMPT, "new_tokens": GEN_NEW,
          **{label: {k: v for k, v in g.items()
                     if k not in ("tokens", "rows")}
             for label, g in gen.items()},
          "rms_norm_checks": _dense_rms_checks(torch, cfg.hidden_size),
          "logit_tolerance": tol, **gcheck})
    del params, gen
    torch.cuda.empty_cache()
    return total


_GUARD = {"phase": None, "windows": {}, "errors": [], "ranks": []}
#: the phases (``timed``'s names) that serve through the engine: 6, 7 (the
#: decode arms), 10-17 and 19
_SERVE_PHASES = ("serve", "prefix_cache", "chaos", "quant", "observability",
                 "kv_tier", "async_host", "fleet", "tp", "dense", "arms")


def _install_overlap_guard(torch) -> None:
    """Wrap ``ContinuousBatchingEngine._host_overlap`` (in this process;
    the package is not changed) so that each window runs under
    ``torch.cuda.set_sync_debug_mode("error")``, with the mode it found
    restored after it (phases 13 and 15 count syncs under ``"warn"``): a
    synchronizing CUDA call inside the window, the work that runs while the
    card executes the step's launches, raises.  Counts the windows a phase
    and records each error before it propagates, so that one a fleet
    swallows as a replica's death still fails phase 18."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    inner = ContinuousBatchingEngine._host_overlap
    if getattr(inner, "sync_guarded", False):
        return

    def guarded(self):
        phase = _GUARD["phase"]
        _GUARD["windows"][phase] = _GUARD["windows"].get(phase, 0) + 1
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(self)
        except Exception as e:
            _GUARD["errors"].append((phase, f"{type(e).__name__}: {e}"))
            raise
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    guarded.sync_guarded = True
    ContinuousBatchingEngine._host_overlap = guarded


def phase_host_contracts(torch, smi: str) -> None:
    """Phase 18.  (a) The static gate on this checkout: ``python -m
    paddle_tpu_torch.analysis --host --json`` in this process; exit 0, the
    raw count equal to ``budgets.toml``'s ceiling, no undeclared
    transition, dead edge or protocol finding.  (b) The sync guard: a
    self-test through the installed guard and the real method (a journal
    flush that reads a CUDA tensor with ``.item()``) must raise and leave
    the debug mode as it found it; no other window raised, in this process
    or a rank's; every serve phase's windows and each phase-17 rank's were
    guarded.  Prints the windows guarded a phase and the pass's seconds."""
    import io

    from paddle_tpu_torch.analysis import __main__ as analysis_cli
    from paddle_tpu_torch.analysis.report import load_budgets
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = analysis_cli.main(["--host", "--json"])
    wall = time.perf_counter() - t0
    doc = json.loads(buf.getvalue())
    summary = doc["host_contracts"]
    (budget,) = [b for b in load_budgets() if b.target == "host"]
    ceiling = budget.ceilings["host_contract_violations"]
    check(rc == 0 and doc["ok"] and doc["findings"] == [],
          f"host-contract gate: exit {rc}, active findings {doc['findings']}"
          f", budget findings {doc['budget_findings']}")
    check(summary["violations"] == ceiling,
          f"host-contract raw count {summary['violations']} == the "
          f"budget's ceiling {ceiling}")
    check(all(summary[k] == 0 for k in ("undeclared_transitions",
                                        "dead_edges", "protocol")),
          f"no undeclared transition, dead edge or protocol finding: "
          f"{summary}")

    def sync_in_window():
        return torch.ones(1, device="cuda").item()

    probe = types.SimpleNamespace(_async_host=True,
                                  stats={"host_overlap_steps": 0},
                                  _jflush=sync_in_window)
    mode = torch.cuda.get_sync_debug_mode()
    errors = len(_GUARD["errors"])
    _GUARD["phase"] = "self_test"
    raised = None
    try:
        ContinuousBatchingEngine._host_overlap(probe)
    except RuntimeError as e:
        raised = str(e)
    _GUARD["phase"] = "host_contracts"
    check(raised is not None and "synchroniz" in raised
          and len(_GUARD["errors"]) == errors + 1,
          f"the guard's self-test: .item() inside a window raised "
          f"({raised})")
    check(torch.cuda.get_sync_debug_mode() == mode,
          "the guard restored the sync debug mode it found")
    windows = dict(_GUARD["windows"])
    others = [e for e in _GUARD["errors"] if e[0] != "self_test"]
    ranks = _GUARD["ranks"]
    check(not others and not any(r["errors"] for r in ranks),
          f"no synchronizing call inside any window: {others} "
          f"{[r['errors'] for r in ranks]}")
    check(all(windows.get(p, 0) > 0 for p in _SERVE_PHASES),
          f"every serve phase's windows were guarded: {windows}")
    check(len(ranks) == TP_DEGREE and all(r["windows"] > 0 for r in ranks),
          f"each rank of phase 17 guarded its windows: {ranks}")
    emit({"phase": "host_contracts", "nvidia_smi": smi,
          "gate_exit": rc, "pass_seconds": doc["seconds"],
          "gate_wall_s": wall, "host_contracts": summary,
          "ceiling": ceiling, "allowlisted": len(doc["allowlisted"]),
          "guarded_windows": windows,
          "rank_guarded_windows": [r["windows"] for r in ranks],
          "self_test": raised})


#: ``--only NAME``: phases 1 and 2, then this phase alone (no kernels line
#: and no result line: the contract's run is the script without arguments)
ONLY = {"dist_train": phase_dist_train, "pipeline": phase_pipeline}


def main(argv: list[str]) -> int:
    sweeps = {"--serve-sweep": serve_sweep, "--prefix-sweep": prefix_sweep,
              "--tier-probe": tier_probe}
    sweep = seeds = only = None
    if argv:
        if len(argv) != 2 or not (argv[0] in sweeps or argv[0] == "--only"
                                  and argv[1] in ONLY):
            print("usage: chip_smoke.py [--serve-sweep FIRST-LAST | "
                  "--prefix-sweep FIRST-LAST | --tier-probe FIRST-LAST | "
                  f"--only {{{','.join(ONLY)}}}]", file=sys.stderr)
            return 2
        if argv[0] == "--only":
            only = argv[1]
        else:
            sweep = sweeps[argv[0]]
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
    _install_overlap_guard(torch)
    if sweep is not None:
        sweep(torch, np, smi, seeds)
        return 0
    if only is not None:
        t0 = time.perf_counter()
        ONLY[only](torch, np, smi)
        emit({"phase": "seconds", only: time.perf_counter() - t0})
        return 0
    seconds = {}

    def timed(name, fn, *args):
        _GUARD["phase"] = name
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"chip_smoke: phase {name} took {seconds[name]:.1f} s",
              file=sys.stderr, flush=True)
        return out

    measured = timed("kernels", phase_kernels, torch)
    measured.update(timed("flash_kernels", phase_flash_kernels, torch))
    # the paged kernels' line entries: the decode walks' int8 numbers (the
    # quantized serving path's pools), the multi-row walks' bf16 numbers
    measured.update({k: v["bf16" if k in ("paged_prefill", "paged_verify")
                          else "int8"]
                     for k, v in timed("paged_kernels", phase_paged_kernels,
                                       torch).items()})
    launches, q8_launches, cs_launches = timed("serve", phase_serve, torch,
                                               np, smi)
    # this slice's paths: the prefix-cache serves and the chaos serve
    slice_launches = timed("prefix_cache", phase_prefix_cache, torch, np,
                           smi)
    for k, v in timed("chaos", phase_chaos, torch, np, smi).items():
        slice_launches[k] += v
    # the weight-only quantized serves, observability, the host KV tier,
    # the async host runtime, the fleet, tensor-parallel serving and the
    # dense engines (phase 19), every window of each serve under the sync
    # guard (phase 18)
    for phase, fn in (("quant", phase_quant),
                      ("observability", phase_observability),
                      ("kv_tier", phase_kv_tier),
                      ("async_host", phase_async_host),
                      ("fleet", phase_fleet), ("tp", phase_tp),
                      ("dense", phase_dense)):
        for k, v in timed(phase, fn, torch, np, smi).items():
            slice_launches[k] += v
    arm_launches = timed("arms", phase_arms, torch, np)
    train_launches = timed("train", phase_train, torch, np)
    timed("train_end_to_end", phase_train_end_to_end, torch, np)
    # phases 20-21: the MoE decoder and the DiT, trained
    timed("moe_dispatch", phase_moe_dispatch, torch, np)
    moe_launches = timed("moe_train", phase_moe_train, torch, np)
    timed("moe_end_to_end", phase_moe_end_to_end, torch, np)
    dit_launches = timed("dit_train", phase_dit_train, torch, np)
    timed("dit_end_to_end", phase_dit_end_to_end, torch, np)
    measured.update(timed("dit_flash", phase_dit_flash, torch))
    # phase 22: hybrid-parallel training as gloo ranks
    dist_launches = timed("dist_train", phase_dist_train, torch, np, smi)
    # phase 23: the pipeline axis as gloo ranks
    pp_launches = timed("pipeline", phase_pipeline, torch, np, smi)
    timed("host_contracts", phase_host_contracts, torch, smi)
    emit({"phase": "seconds", **seconds})
    # each kernel's launches on the main paths that run it: the fp and the
    # int8 serve, the prefix-cache and chaos serves, the decode arms (the
    # unfused walks), the train step
    for k in ("rms_norm", "fused_layer_mlp", "gumbel_noise",
              "fused_quant_decode_step_tc", "fused_decode_step_tc"):
        launches[k] += q8_launches[k] + cs_launches[k] + slice_launches[k]
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
    launches.update({k: cs_launches[f"{k}_tc"] + slice_launches[f"{k}_tc"]
                     for k in ("paged_prefill", "paged_verify")})
    launches["rms_norm"] += train_launches["rms_norm"]
    # the MoE train step's tensor-core flash and rms_norm launches; the
    # DiT's flash launches, every one on the CUDA-core route, are the
    # entries of the CUDA-core kernels
    for k in FLASH_KERNELS:
        launches[k] += moe_launches[f"{k}_tc"]
        launches[f"{k}_cc"] = dit_launches[k] - dit_launches[f"{k}_tc"]
    launches["rms_norm"] += moe_launches["rms_norm"]
    # the mesh train steps' ranks: B1 and the tensor-core flash kernels
    launches["rms_norm"] += dist_launches["rms_norm"]
    for k in FLASH_KERNELS:
        launches[k] += dist_launches[f"{k}_tc"]
    # the pipeline stages' ranks: likewise
    launches["rms_norm"] += pp_launches["rms_norm"]
    for k in FLASH_KERNELS:
        launches[k] += pp_launches[f"{k}_tc"]
    pa = "paddle_tpu/ops/pallas/paged_attention.py"
    fa = "paddle_tpu/ops/pallas/flash_attention.py"
    sources = {"rms_norm": ("rms_norm.cu", "paddle_tpu/ops/pallas/"
                                           "rms_norm.py:20"),
               "fused_decode_step": ("fused_decode_tc.cu", f"{pa}:1377"),
               "fused_layer_mlp": ("fused_mlp.cu", f"{pa}:2020"),
               "flash_attention_fwd": ("flash_fwd_tc.cu", f"{fa}:173"),
               "flash_attention_dkv": ("flash_bwd_tc.cu", f"{fa}:295"),
               "flash_attention_dq": ("flash_bwd_tc.cu", f"{fa}:344"),
               "flash_attention_fwd_cc": ("flash_fwd.cu", f"{fa}:173"),
               "flash_attention_dkv_cc": ("flash_bwd.cu", f"{fa}:295"),
               "flash_attention_dq_cc": ("flash_bwd.cu", f"{fa}:344"),
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
