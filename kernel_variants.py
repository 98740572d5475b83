#!/usr/bin/env python3
"""Design variants of the tensor-core dQ (``csrc/flash_bwd_tc.cu``) and
multi-row paged walk (``csrc/paged_prefill_tc.cu``), timed and checked on
one NVIDIA card against the committed kernels.

    python3 kernel_variants.py

Each variant is the committed source with one edit (the edits are listed
below), compiled with the library's own nvcc flags into a temporary
directory and swapped in for the library; the wrappers in
``paddle_tpu_torch.ops.kernels`` launch it as they launch the committed
kernel.  Every variant is timed in the same process as the committed one
(CUDA events, L2 flushed, as ``chip_smoke.py`` times), in turns, and held
to the same plain versions and tolerances as ``chip_smoke.py`` (probes
that skip work are timed only).  Prints JSON lines; the last one is
``{"ok": true, ...}``.  Without a card, or without the package beside it,
exits non-zero.

- dQ at the training shape (b 2, s 2048, 32/8 heads, d 128, bf16, causal)
  and three smaller cases: dS rounded once instead of hi + lo; the P
  exponentials no longer overlapped with the dP product.
- The paged walk on ``chip_smoke.py``'s mixed-step lane mix (bf16 / int8 /
  int4), on sub-mixes (the 1920-token chunk lane alone, the decode lanes
  alone, no live row) and the verify mix: P rounded once; a three-stage
  ring; no split of a long chunk tile; a four-way split from 8 KV tiles;
  the first combine kernel (one thread a column, the splits' loads in a
  runtime loop); probes without the K/V copies and without the products.
- P rounded once against hi + lo over 40 random lane mixes (T 5, 16, 32
  and 128; lengths up to 2048) on every pool format: the worst error over
  the attention tolerance, and the cases beyond it.
- The tensor-core fused decode step (``csrc/fused_decode_tc.cu``, B7 over
  bf16 pools and B11 over int8 / int4 pools) on lane mixes of one page, four
  pages (one shard), five and nine pages (two and three shards: the
  in-launch merge) and ``chip_smoke.py``'s smoke mix, beside the CUDA-core
  route: the write-page requantize one row at a time with the library
  division (``paged.cuh``'s earlier ``requant_page``); its code inlined
  twice (once for K, once for V); P rounded once; a two-stage ring; probes
  without the merge of the shards and without the products (the kernel
  lives in ``csrc/paged_tc.cuh``).
- ``parent DIR``: the same fused decode step from another checkout's
  ``csrc`` (``DIR/paddle_tpu_torch/ops/kernels/csrc``, for example the
  parent commit unpacked with ``git archive``), timed in turns with this
  checkout's on the same lane mixes: what a change to the shared code
  costs B7 and B11; then the two builds' fused kernels compared
  instruction for instruction (``cuobjdump -sass``); with ``rmsnorm``,
  that checkout's rms_norm beside this one's.
- The sequential paged decode (``csrc/paged_decode_tc.cu``, B5) on the
  smoke mix, 8 lanes of 512, the 2048-token lane alone and one page a
  lane, over bf16 / int8 / int4 pools: the committed split rule (runs of 4
  table pages), runs of 2 and of 8 pages, no split, and the CUDA-core
  walk.
- The split-K paged decode on the tensor cores (``ptt_flash_decode_tc``,
  B6) under the reference's shard rule (``flash_decode_shards``: at most 8
  shards) against the sequential walk's runs of 4 pages (B5, and B6 given
  that partition), at 32 table pages (max_seq 2048: the same partition)
  and 64 (max_seq 4096: 8 shards of 8 pages against 16 runs of 4), on lane
  mixes over bf16 / int8 / int4 pools, beside B6's CUDA-core route.
- rms_norm at 8 to 4096 rows of 4096 bf16, L2 flushed and warm: the
  kernel as committed; with the weight loaded after the reduction; with 8
  vectors of registers a thread whatever the row; one warp a row (the weight in shared memory, a grid sized to
  the SMs' residency, the next row's loads in flight); ``F.rms_norm``; a
  probe (timed only): the launch alone.

    python3 kernel_variants.py [dq] [rows] [decode] [seqdecode] [splitk]
                               [rmsnorm] [parent DIR]

runs the named parts (dq, rows and decode by default).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

#: dQ: dS rounded once (the lo product dropped)
DQ_SINGLE = ("flash_bwd_tc.cu",
             "      mma_rs<D, 1, T>(dq, dl[kk], dkd);\n", "")
#: dQ: S and dP in one commit group, P computed after both
DQ_NO_OVERLAP = [
    ("flash_bwd_tc.cu", """      mma_ss<BKV, 0, T>(s, desc_k(sQ + a), desc_k(sK + b), kc > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = (kc >> 2) * (BQ * 128) + (kc & 3) * 32;
      const uint32_t b = (kc >> 2) * (BKV * 128) + (kc & 3) * 32;
      mma_ss<BKV, 0, T>(dp, desc_k(sO + a), desc_k(sV + b), kc > 0);
    }
    wgmma_commit();
    fence_regs(dp);
    wgmma_wait<1>();
    fence_regs(s);
""", """      mma_ss<BKV, 0, T>(s, desc_k(sQ + a), desc_k(sK + b), kc > 0);
      mma_ss<BKV, 0, T>(dp, desc_k(sO + a), desc_k(sV + b), kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
"""),
    ("flash_bwd_tc.cu", """    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < NS; ++i)
      dp[i] =""", """#pragma unroll
    for (int i = 0; i < NS; ++i)
      dp[i] =""")]
_LONG = "constexpr int kLongSplits = 2, kLongWalk = 16;"
_OLD_COMBINE = """template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    rows_combine_kernel(const RowsTcParams p) {
  const Lane ln(p, blockIdx.x);
  const int tile = blockIdx.y, r0 = tile * kBR;
  if (r0 >= ln.live) return;
  const int nr = min(ln.live - r0, kBR);
  const int nkt = (ln.row_len(r0 + nr - 1) + kBKV - 1) / kBKV;
  int per, n;
  rows_split(nkt, p.max_splits, ln.live <= kBR, per, n);
  if (n <= 1) return;
  const size_t lane =
      (size_t)blockIdx.x * lane_blocks(p.n_tiles, p.max_splits);
  T* ob = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < nr * D; idx += kThreads) {
    const int row = idx / D, d = idx % D;
    float m_max = kNeg;
    for (int s = 0; s < n; ++s)
      m_max = fmaxf(m_max, p.pm[(lane + split_slot(tile, s, p.n_tiles,
                                                   p.max_splits)) *
                                    p.prow + row]);
    float l_tot = 0.f, a_tot = 0.f;
    for (int s = 0; s < n; ++s) {
      const size_t at =
          (lane + split_slot(tile, s, p.n_tiles, p.max_splits)) * p.prow +
          row;
      const float ms = p.pm[at];
      const float w = ms > 0.5f * kNeg ? expf(ms - m_max) : 0.f;
      l_tot += w * p.pl[at];
      a_tot += w * p.pacc[at * D + d];
    }
    ob[ln.row_off(p, r0 + row, D) + d] =
        ptt::from_f32<T>(a_tot / (l_tot == 0.f ? 1.f : l_tot));
  }
}

"""
ROWS = "paged_prefill_tc.cu"
#: paged walk variants: name -> (edits, long-tile split count the host
#: sizes the partials for, checked?)
ROWS_VARIANTS = {
    "p_single": ([(ROWS, "      mma_rs<D, 1, T>(o, pl[kk], dvd);\n", "")],
                 2, True),
    "stages3": ([(ROWS, "constexpr int kStages = 2;",
                  "constexpr int kStages = 3;")], 2, True),
    "no_long_split": ([(ROWS, _LONG, "constexpr int kLongSplits = 2, "
                        "kLongWalk = 1 << 30;")], 2, True),
    "split4_from8": ([(ROWS, _LONG, "constexpr int kLongSplits = 4, "
                       "kLongWalk = 8;")], 4, True),
    "first_combine": ([(ROWS, None, _OLD_COMBINE)], 2, True),
    "probe_no_kv_copies": ([(ROWS, "      cp_async16(s0 + dst, p.kpool + at, "
                             "ok);\n      cp_async16(s0 + BKV * RB + dst, "
                             "p.vpool + at, ok);\n", "")], 2, False),
    "probe_no_products": ([(ROWS, "      mma_ss<BKV, 0, T>(s, desc_k(sQ + a), "
                            "desc_k(sK + b), kc > 0);",
                            "      if (kc == 0) for (int i = 0; i < NS; ++i) "
                            "s[i] = 0.f;"),
                           (ROWS, "      mma_rs<D, 1, T>(o, ph[kk], dvd);\n"
                            "      mma_rs<D, 1, T>(o, pl[kk], dvd);\n", "")],
                          2, False),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _replace_combine(text: str, new: str) -> str:
    """The committed combine kernel (from its template line to the launch
    helper) replaced by ``new``."""
    start = text.index("template <typename T, int D>\n__global__ void "
                       "__launch_bounds__(kThreads)\n    rows_combine_kernel")
    end = text.index("template <typename T, int F, int D>\nint launch(")
    return text[:start] + new + text[end:]


def build_variant(kernels, tmp: str, tag: str, edits, sources, csrc=None):
    """The library's ``sources`` (from ``csrc``, default this checkout's)
    with ``edits`` applied, built with its nvcc flags into ``tmp/tag``;
    returns the loaded ctypes library."""
    d = os.path.join(tmp, tag)
    shutil.copytree(csrc or kernels.CSRC, os.path.join(d, "csrc"))
    for fname, old, new in edits:
        path = os.path.join(d, "csrc", fname)
        with open(path) as f:
            text = f.read()
        if old is None:
            text = _replace_combine(text, new)
        elif isinstance(old, tuple):  # (start marker, end marker): a span
            start, end = text.index(old[0]), text.index(old[1])
            text = text[:start] + new + text[end:]
        else:
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: edit target not found once in "
                                   f"{fname}: {old[:60]!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    nvcc = kernels._nvcc()

    def one(src):
        obj = os.path.join(d, src + ".o")
        res = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-c",
                              os.path.join(d, "csrc", src), "-o", obj],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{tag}: nvcc failed on {src}:\n"
                               f"{res.stderr[-3000:]}")
        return obj

    with ThreadPoolExecutor(len(sources)) as pool:
        objs = list(pool.map(one, sources))
    lib_path = os.path.join(d, "lib.so")
    res = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o",
                          lib_path, *objs], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{tag}: link failed:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in kernels._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def dq_variants(torch, cs, kernels, tmp) -> None:
    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    committed = kernels.library()
    srcs = ("flash_bwd_tc.cu",)
    libs = {"committed": committed,
            "ds_single": build_variant(kernels, tmp, "ds_single",
                                       [DQ_SINGLE], srcs),
            "no_overlap": build_variant(kernels, tmp, "no_overlap",
                                        DQ_NO_OVERLAP, srcs)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    cases = {}
    for label, (b, sq, skv, d, causal) in (
            ("train_shape", (2, 2048, 2048, 128, True)),
            ("ragged_1000", (2, 1000, 1000, 128, True)),
            ("sq_ne_skv", (1, 700, 1000, 128, True)),
            ("full_d64", (2, 300, 517, 64, False))):
        q, k, v, do, kw = cs._flash_case(torch, tfa, g, dev, b, sq, skv, 32,
                                         8, d, causal)
        out, lse = tfa.flash_fwd_ref(q, k, v, **kw)
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        cases[label] = ((q, k, v, do, lse, delta), kw,
                        tfa.flash_dq_ref(q, k, v, do, lse, delta, **kw))
    for rnd in range(2):
        for tag, lib in libs.items():
            kernels._lib = lib
            res = {"kernel": "flash_dq_tc", "variant": tag, "round": rnd}
            for label, (args, kw, want) in cases.items():
                got = tfa.flash_dq_cuda(*args, route="tc", **kw)
                torch.cuda.synchronize()
                res[f"worst_err_over_tol_{label}"] = cs._flash_err(
                    got, want)["worst_err_over_tol"]
            args, kw, _ = cases["train_shape"]
            res["ms_train_shape"] = cs.time_ms(
                torch, lambda: tfa.flash_dq_cuda(*args, route="tc", **kw),
                flush=flush)
            emit(res)
    kernels._lib = committed


def _pools(torch, pa, g, dev, nbp, nkv, bs, hd):
    """bf16 K/V pools from ``g`` and their int8 / int4 encodings."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    kp, vp = randn(nbp, nkv, bs, hd), randn(nbp, nkv, bs, hd)
    pools = {"bf16": (kp, vp, None, None)}
    for mode in ("int8", "int4"):
        kq, ks = pa.quantize_kv_cache(kp, mode)
        vq, vs = pa.quantize_kv_cache(vp, mode)
        pools[mode] = (kq, vq, ks, vs)
    return pools


def _table(torch, perm, lens, B, max_blocks, nb, bs, dev):
    t = torch.full((B, max_blocks), nb, dtype=torch.int32, device=dev)
    for i, n in enumerate(lens):
        n = -(-n // bs) if n > 1 else 0
        t[i, :n] = perm[i * max_blocks:i * max_blocks + n]
    return t


def rows_variants(torch, cs, kernels, tmp) -> None:
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    committed = kernels.library()
    libs = {"committed": (committed, 2, True)}
    for tag, (edits, long_splits, checked) in ROWS_VARIANTS.items():
        libs[tag] = (build_variant(kernels, tmp, tag, edits, (ROWS,)),
                     long_splits, checked)
    dev = torch.device("cuda")
    B, nh, nkv, hd, bs, max_seq = 8, 32, 8, 128, 64, 2048
    max_blocks = max_seq // bs
    nb = B * max_blocks
    g = torch.Generator(device=dev)
    g.manual_seed(2024)
    pools = _pools(torch, pa, g, dev, nb + 1, nkv, bs, hd)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    mix = [2048, 1000, 333, 1, 128, 768, 1920, 1500]
    mixes = {
        # chip_smoke.py's mixed-step lane mix and verify mix
        "mixed": (128, mix, [1, 1, 1, 1, 128, 128, 128, 37],
                  ("bf16", "int8", "int4")),
        "mixed_1920_chunk_only": (128, mix, [0, 0, 0, 0, 0, 0, 128, 0],
                                  ("bf16",)),
        "mixed_decode_lanes_only": (128, mix, [1, 1, 1, 1, 0, 0, 0, 0],
                                    ("bf16",)),
        "mixed_no_live_row": (128, mix, [0] * 8, ("bf16",)),
        "verify": (5, [5, 2048, 64, 127, 1000, 1500, 333, 1777],
                   [5, 5, 1, 3, 5, 2, 5, 4], ("bf16",))}
    data = {}
    for name, (T, lens, qlens, fmts) in mixes.items():
        data[name] = (T, _table(torch, perm, lens, B, max_blocks, nb, bs,
                                dev),
                      torch.tensor(lens, dtype=torch.int32, device=dev),
                      torch.tensor(qlens, dtype=torch.int32, device=dev),
                      torch.randn(B, T, nh, hd, generator=g, device=dev)
                      .to(torch.bfloat16), fmts)
    long_splits = pa._ROWS_LONG_SPLITS
    for rnd in range(2):
        for tag, (lib, splits, checked) in libs.items():
            kernels._lib = lib
            pa._ROWS_LONG_SPLITS = splits
            res = {"kernel": "paged_rows_tc", "variant": tag, "round": rnd}
            for name, (T, tables, lens, qlens, q, fmts) in data.items():
                for fmt in fmts:
                    kc, vc, ks, vs = pools[fmt]
                    kw = dict(kv_quant=None if fmt == "bf16" else fmt,
                              k_scale=ks, v_scale=vs)
                    args = (q, kc, vc, tables, lens, qlens)
                    def fn():
                        return pa.paged_prefill_cuda(*args, hd ** -0.5,
                                                     route="tc", **kw)

                    entry = {"ms": cs.time_ms(torch, fn, flush=flush)}
                    live = (torch.arange(T, device=dev)[None, :]
                            < qlens[:, None])
                    if checked and bool(live.any()):
                        got = fn()
                        want = pa.paged_prefill_reference(
                            *args, scale=hd ** -0.5, **kw)
                        torch.cuda.synchronize()
                        errs, ok = cs._attn_err(torch, got[live], want[live])
                        entry["worst_err_over_tol"] = errs[
                            "worst_err_over_tol"]
                        entry["ok"] = ok and bool((got[~live] == 0).all())
                    res[f"{name}_{fmt}"] = entry
            emit(res)
    pa._ROWS_LONG_SPLITS = long_splits
    kernels._lib = committed
    rounding_sweep(torch, cs, kernels, pa, {
        "committed": committed,
        "p_single": libs["p_single"][0]})


def rounding_sweep(torch, cs, kernels, pa, libs) -> None:
    """P hi + lo against P rounded once over 40 random lane mixes."""
    dev = torch.device("cuda")
    B, nh, nkv, hd, bs, max_seq = 8, 32, 8, 128, 64, 2048
    max_blocks = max_seq // bs
    nb = B * max_blocks
    worst = {tag: {} for tag in libs}
    beyond = {tag: 0 for tag in libs}
    for seed in range(40):
        g = torch.Generator(device=dev)
        g.manual_seed(1000 + seed)
        pools = _pools(torch, pa, g, dev, nb + 1, nkv, bs, hd)
        perm = torch.randperm(nb, generator=g, device=dev).int()
        T = (128, 16, 5, 32)[seed % 4]
        lens = torch.randint(1, max_seq + 1, (B,), generator=g, device=dev)
        qlens = torch.minimum(torch.randint(0, T + 1, (B,), generator=g,
                                            device=dev), lens)
        qlens[0] = min(T, int(lens[0]))
        tables = _table(torch, perm, lens.tolist(), B, max_blocks, nb, bs,
                        dev)
        lens, qlens = lens.int(), qlens.int()
        q = torch.randn(B, T, nh, hd, generator=g, device=dev) \
            .to(torch.bfloat16)
        live = torch.arange(T, device=dev)[None, :] < qlens[:, None]
        for fmt, (kc, vc, ks, vs) in pools.items():
            kw = dict(kv_quant=None if fmt == "bf16" else fmt, k_scale=ks,
                      v_scale=vs)
            args = (q, kc, vc, tables, lens, qlens)
            want = pa.paged_prefill_reference(*args, scale=hd ** -0.5, **kw)
            for tag, lib in libs.items():
                kernels._lib = lib
                got = pa.paged_prefill_cuda(*args, hd ** -0.5, route="tc",
                                            **kw)
                torch.cuda.synchronize()
                errs, ok = cs._attn_err(torch, got[live], want[live])
                beyond[tag] += not (ok and bool((got[~live] == 0).all()))
                worst[tag][fmt] = max(worst[tag].get(fmt, 0.0),
                                      errs["worst_err_over_tol"])
    kernels._lib = libs["committed"]
    emit({"kernel": "paged_rows_tc", "sweep": "P hi + lo vs rounded once",
          "cases": 40 * 3, "worst_err_over_tol": worst,
          "cases_beyond_tolerance": beyond})


#: ``paged.cuh``'s requantize as the CUDA-core decode kernels first ran it:
#: one row at a time (read, library division, a byte store to the tile and
#: one to the pool)
_SERIAL_REQUANT = """template <int F>
__device__ __forceinline__ float requant_page(unsigned char* tile, int ld,
                                              float old_sc, int wrow,
                                              float ins, unsigned char* dst,
                                              int bs, int hd, float* red) {
  const int d = threadIdx.x;
  const int row_bytes = KV<float, F>::row_bytes(hd);
  const float bound = F == kInt4 ? 7.f : 127.f;
  const float inv_bound = F == kInt4 ? 1.f / 7.f : 1.f / 127.f;
  float amax = 0.f;
  for (int t = 0; t < bs; ++t) {
    const float x = t == wrow ? ins : KV<float, F>::load1(tile + t * ld, d,
                                                          old_sc);
    amax = fmaxf(amax, fabsf(x));
  }
  amax = block_max(amax, red);  // every read of the old tile is done
  const float sc = __fmul_rn(amax, inv_bound);
  const float den = fmaxf(sc, 1e-10f);
  for (int t = 0; t < bs; ++t) {
    const float x = t == wrow ? ins : KV<float, F>::load1(tile + t * ld, d,
                                                          old_sc);
    const int c = (int)fminf(fmaxf(rintf(__fdiv_rn(x, den)), -bound), bound);
    if constexpr (F == kInt8) {
      tile[t * ld + d] = (unsigned char)c;
      dst[(size_t)t * row_bytes + d] = (unsigned char)c;
    } else {
      const int hi = __shfl_down_sync(0xffffffffu, c, 1);
      if ((d & 1) == 0) {
        const unsigned char byte =
            (unsigned char)((c & 0xF) | ((hi & 0xF) << 4));
        tile[t * ld + d / 2] = byte;
        dst[(size_t)t * row_bytes + d / 2] = byte;
      }
    }
  }
  __syncthreads();  // the tile's new codes are visible to every thread
  return sc;
}

"""
DEC = "fused_decode_tc.cu"
WALK = "paged_tc.cuh"
#: fused decode variants: name -> (edits, checked?)
DECODE_VARIANTS = {
    "requant_serial": ([("paged.cuh", ("template <int F>\n__device__ "
                                       "__forceinline__ float requant_page(",
                                       "// Exact log-sum-exp merge"),
                         _SERIAL_REQUANT)], True),
    "requant_inlined_twice": ([(WALK, "#pragma unroll 1\n          for (int "
                                "kv = 0; kv < 2; ++kv) {", "#pragma unroll\n"
                                "          for (int kv = 0; kv < 2; ++kv) {")],
                              True),
    "p_single": ([(WALK, "        mma16816(o[n], l0, l2, vb[0], vb[1]);\n",
                   ""),
                  (WALK, "        mma16816(o[n + 1], l0, l2, vb[2], vb[3]);"
                   "\n", "")], True),
    "stages2": ([(WALK, "constexpr int kStages = 3;",
                  "constexpr int kStages = 2;")], True),
    "probe_no_merge": ([(WALK, "  if (nlive > 1) {\n    // the ticket",
                         "  if (false) {\n    // the ticket")], False),
    "probe_no_products": ([(WALK, "for (int c0 = 16 * warp; c0 < ncol;",
                            "for (int c0 = 16 * warp; c0 < 0;")], False),
}
def _sass(kernels, obj: str) -> dict:
    """``cuobjdump -sass`` of an object file: the fused decode kernels'
    instructions (addresses and encodings dropped) by "F<format>_D<hd>"."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            m = re.search(r"decode_tc_kernelI(?:Lb1E)?Li(\d+)ELi(\d+)E",
                          name)
            key = f"F{m.group(1)}_D{m.group(2)}" if m else None
            if key:
                out[key] = []
        elif key:
            ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if ins:
                out[key].append(" ".join(ins.split()))
    return out


def sass_vs_parent(kernels, tmp) -> None:
    """The fused decode kernels' machine code against the parent
    checkout's (built by ``decode_variants``): instruction for instruction,
    per pool format and head_dim."""
    mine = _sass(kernels, str(kernels.build().parent /
                              "fused_decode_tc.o"))
    theirs = _sass(kernels, os.path.join(tmp, "parent", DEC + ".o"))
    res = {"kernel": "fused_decode_tc", "variant": "sass_vs_parent"}
    for key in sorted(set(mine) | set(theirs)):
        a, b_ = mine.get(key, []), theirs.get(key, [])
        res[key] = {"instructions": len(a), "parent_instructions": len(b_),
                    "identical": a == b_,
                    "lines_differing": sum(x != y for x, y in zip(a, b_))
                    + abs(len(a) - len(b_))}
    emit(res)


#: lane mixes of the fused decode step (lengths before the append, all
#: lanes writeable but the smoke mix's last)
DECODE_MIXES = {"1_page": [62] * 8, "4_pages": [254] * 8,
                "5_pages": [300] * 8, "9_pages": [512] * 8}


def decode_variants(torch, cs, kernels, tmp, parent=None) -> None:
    """The fused decode step's variants, or with ``parent`` (a checkout's
    root) the committed kernel in turns with that checkout's, three
    rounds, no CUDA-core route."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    committed = kernels.library()
    libs = {"committed": (committed, True)}
    if parent is None:
        for tag, (edits, checked) in DECODE_VARIANTS.items():
            libs[tag] = (build_variant(kernels, tmp, tag, edits, (DEC,)),
                         checked)
        extra = [("cuda_core", (committed, True))]
    else:
        libs["parent"] = (build_variant(
            kernels, tmp, "parent", [], (DEC,), csrc=os.path.join(
                parent, "paddle_tpu_torch", "ops", "kernels", "csrc")), True)
        extra = []
    dev = torch.device("cuda")
    B, nh, nkv, hd, bs, max_blocks = 8, 32, 8, 128, 64, 32
    nb = B * max_blocks
    g = torch.Generator(device=dev)
    g.manual_seed(77)
    pools = _pools(torch, pa, g, dev, nb + 1, nkv, bs, hd)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    q = torch.randn(B, nh, hd, generator=g, device=dev).to(torch.bfloat16)
    kv_new = [torch.randn(B, nkv, hd, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    mixes = dict(DECODE_MIXES)
    _, smoke_lens, smoke_wable = cs.DECODE_MIXES[0]
    mixes["smoke_mix"] = smoke_lens
    for rnd in range(2 if parent is None else 3):
        order = list(libs.items()) + extra
        if parent is not None and rnd % 2:
            order.reverse()         # committed, parent, parent, committed
        for tag, (lib, checked) in order:
            kernels._lib = lib
            route = "cc" if tag == "cuda_core" else "tc"
            res = {"kernel": "fused_decode_tc", "variant": tag, "round": rnd}
            for name, lens in mixes.items():
                wable = smoke_wable if name == "smoke_mix" else [1] * B
                tail, (cos, sin) = cs._decode_tail(torch, perm, lens, wable,
                                                   bs, max_blocks, hd)
                small = (q, *kv_new, cos, sin)
                for fmt, (kc, vc, ks, vs) in pools.items():
                    pl = [kc, vc] if fmt == "bf16" else [kc, ks, vc, vs]
                    if fmt == "bf16":
                        def run(pl_):
                            return pa.fused_decode_step_cuda(
                                *small, *pl_, *tail, route=route)

                        def plain(pl_):
                            return pa.fused_decode_step_reference(
                                *small, *pl_, *tail)
                    else:
                        def run(pl_):
                            return pa.fused_quant_decode_step_cuda(
                                *small, *pl_, *tail, fmt, route=route)

                        def plain(pl_):
                            return pa.fused_quant_decode_step_reference(
                                *small, *pl_, *tail, fmt)
                    mine = [t.clone() for t in pl]
                    entry = {"ms": cs.time_ms(torch, lambda: run(mine),
                                              flush=flush)}
                    if checked:
                        got = run([t.clone() for t in pl])
                        want = plain([t.clone() for t in pl])
                        torch.cuda.synchronize()
                        errs, ok = cs._attn_err(torch, got[0][:7],
                                                want[0][:7])
                        entry["worst_err_over_tol"] = errs[
                            "worst_err_over_tol"]
                        entry["ok"] = ok
                        if fmt != "bf16":
                            entry["pools_bit_equal"] = all(
                                bool(torch.equal(a, b_))
                                for a, b_ in zip(got[1:], want[1:]))
                    res[f"{name}_{fmt}"] = entry
            emit(res)
    kernels._lib = committed


#: sequential-walk lane mixes (live lengths): chip_smoke's smoke mix and
#: serve shape, the 2048-token lane alone, one page a lane
SEQ_MIXES = {"smoke_mix": [0, 2048, 64, 127, 1000, 1500, 333, 1777],
             "serve_8x512": [512] * 8, "lane_2048": [2048] + [0] * 7,
             "1_page": [64] * 8}


def seqdecode_variants(torch, cs, kernels) -> None:
    """B5 on the tensor cores under other split rules (the module's
    ``_SEQ_PAGES_PER_SPLIT`` / ``_SEQ_MAX_SPLITS`` set for the variant: no
    rebuild), and the CUDA-core walk."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    dev = torch.device("cuda")
    B, nh, nkv, hd, bs, max_blocks = 8, 32, 8, 128, 64, 32
    nb = B * max_blocks
    g = torch.Generator(device=dev)
    g.manual_seed(2025)
    pools = _pools(torch, pa, g, dev, nb + 1, nkv, bs, hd)
    perm = torch.randperm(nb, generator=g, device=dev).int()
    q = torch.randn(B, nh, hd, generator=g, device=dev).to(torch.bfloat16)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    variants = {"committed": ("tc", {}),
                "runs_of_2": ("tc", {"_SEQ_PAGES_PER_SPLIT": 2}),
                "runs_of_8": ("tc", {"_SEQ_PAGES_PER_SPLIT": 8}),
                "no_split": ("tc", {"_SEQ_MAX_SPLITS": 1}),
                "cuda_core": ("cc", {})}
    rule = {name: getattr(pa, name)
            for name in ("_SEQ_PAGES_PER_SPLIT", "_SEQ_MAX_SPLITS")}
    tables = {}
    for name, lens in SEQ_MIXES.items():
        t = torch.full((B, max_blocks), nb, dtype=torch.int32, device=dev)
        for i, n in enumerate(lens):
            t[i, :-(-n // bs)] = perm[i * max_blocks:i * max_blocks
                                      - (-n // bs)]
        tables[name] = (t, torch.tensor(lens, dtype=torch.int32, device=dev))
    for rnd in range(2):
        for tag, (route, consts) in variants.items():
            for name, value in {**rule, **consts}.items():
                setattr(pa, name, value)
            res = {"kernel": "paged_decode", "variant": tag, "round": rnd,
                   "splits": (pa.seq_decode_splits(max_blocks)
                              if route == "tc" else None)}
            for name, (t, lens) in tables.items():
                for fmt, (kc, vc, ks, vs) in pools.items():
                    kw = dict(kv_quant=None if fmt == "bf16" else fmt,
                              k_scale=ks, v_scale=vs)

                    def run():
                        return pa.paged_decode_cuda(
                            q, kc, vc, t, lens, hd ** -0.5, **kw,
                            route=route)

                    got = run()
                    want = pa.paged_attention_reference(
                        q, kc, vc, t, lens, scale=hd ** -0.5, **kw)
                    torch.cuda.synchronize()
                    errs, ok = cs._attn_err(torch, got, want)
                    res[f"{name}_{fmt}"] = {
                        "ms": cs.time_ms(torch, run, flush=flush),
                        "worst_err_over_tol": errs["worst_err_over_tol"],
                        "ok": ok}
            emit(res)
    for name, value in rule.items():
        setattr(pa, name, value)


#: split-K lane mixes (live lengths) by table width: chip_smoke's smoke
#: mix and serve shape and the longest lane alone at 32 pages; the smoke
#: mix's lengths doubled, 8 lanes of 1024 and the 4096-token lane alone at
#: 64
SPLITK_MIXES = {32: {k: SEQ_MIXES[k] for k in ("smoke_mix", "serve_8x512",
                                               "lane_2048")},
                64: {"smoke_mix_x2": [2 * n for n in SEQ_MIXES["smoke_mix"]],
                     "serve_8x1024": [1024] * 8,
                     "lane_4096": [4096] + [0] * 7}}


def splitk_variants(torch, cs, kernels) -> None:
    """B6 on the tensor cores under the reference's shard rule against the
    sequential walk's runs of 4 table pages (B5's own launch, and B6 given
    B5's partition: the same kernel, so the same time), and B6's CUDA-core
    route, at 32 and 64 table pages; each held to its plain version."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    dev = torch.device("cuda")
    B, nh, nkv, hd, bs = 8, 32, 8, 128, 64
    scale = hd ** -0.5
    g = torch.Generator(device=dev)
    g.manual_seed(2026)
    q = torch.randn(B, nh, hd, generator=g, device=dev).to(torch.bfloat16)
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    for max_blocks, mixes in SPLITK_MIXES.items():
        nb = B * max_blocks
        pools = _pools(torch, pa, g, dev, nb + 1, nkv, bs, hd)
        perm = torch.randperm(nb, generator=g, device=dev).int()
        tables = {}
        for name, lens in mixes.items():
            t = torch.full((B, max_blocks), nb, dtype=torch.int32, device=dev)
            for i, n in enumerate(lens):
                t[i, :-(-n // bs)] = perm[i * max_blocks:i * max_blocks
                                          - (-n // bs)]
            tables[name] = (t, torch.tensor(lens, dtype=torch.int32,
                                            device=dev))
        shard_rule = pa.flash_decode_shards(max_blocks)
        runs_of_4 = pa.seq_decode_splits(max_blocks)
        # variant -> (kernel, route, shards); the sequential walk takes its
        # splits from seq_decode_splits, here runs of 4 pages
        variants = {"b6_shard_rule": ("flash_decode", "tc", shard_rule),
                    "b6_runs_of_4": ("flash_decode", "tc", runs_of_4),
                    "b5_runs_of_4": ("paged_decode", "tc", runs_of_4),
                    "b6_cuda_core": ("flash_decode", "cc", shard_rule)}
        for rnd in range(2):
            for tag, (kernel, route, shards) in variants.items():
                res = {"kernel": kernel, "variant": tag, "round": rnd,
                       "table_pages": max_blocks, "shards": shards,
                       "pages_a_shard": -(-max_blocks // shards)}
                for name, (t, lens) in tables.items():
                    for fmt, (kc, vc, ks, vs) in pools.items():
                        kw = dict(kv_quant=None if fmt == "bf16" else fmt,
                                  k_scale=ks, v_scale=vs)
                        args = (q, kc, vc, t, lens, scale)
                        if kernel == "flash_decode":
                            def run():
                                return pa.flash_decode_cuda(
                                    *args, shards, **kw, route=route)

                            want = pa.flash_decode_reference(*args, shards,
                                                             **kw)
                        else:
                            def run():
                                return pa.paged_decode_cuda(*args, **kw,
                                                            route=route)

                            want = pa.paged_attention_reference(
                                *args[:5], scale=scale, **kw)
                        got = run()
                        torch.cuda.synchronize()
                        errs, ok = cs._attn_err(torch, got, want)
                        res[f"{name}_{fmt}"] = {
                            "ms": cs.time_ms(torch, run, flush=flush),
                            "worst_err_over_tol": errs["worst_err_over_tol"],
                            "ok": ok}
                emit(res)
        del pools


RMS = "rms_norm.cu"
#: rms_norm variants of the warp kernel: name -> edits
#: the one-warp-a-row design this redesign also tried: the block's first
#: warp loads the weight into shared memory beside each warp's first row,
#: a grid sized to the SMs' residency walks the rows, each warp loading its
#: next row before it reduces the current one (16-byte vectors: VPL a lane)
_WARP_A_ROW = """constexpr int kWarpRows = 4;

template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kWarpRows, 2)
    rms_norm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int rows, float eps) {
  constexpr int V = 16 / sizeof(T);
  constexpr int H = 32 * VPL * V;
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * (blockDim.x >> 5);
  int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  auto load = [&](uint4 (&r)[VPL], int at) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)at * H);
#pragma unroll
    for (int i = 0; i < VPL; ++i) r[i] = xr[lane + 32 * i];
  };
  __shared__ uint4 ws[32 * VPL];
  uint4 cur[VPL];
  if (row < rows) load(cur, row);
  if (threadIdx.x < 32) {
    uint4 wr[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      wr[i] = reinterpret_cast<const uint4*>(w)[lane + 32 * i];
#pragma unroll
    for (int i = 0; i < VPL; ++i) ws[lane + 32 * i] = wr[i];
  }
  __syncthreads();
  while (row < rows) {
    const int next = row + nwarps;
    uint4 nxt[VPL];
    if (next < rows) load(nxt, next);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const T* e = reinterpret_cast<const T*>(&cur[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ptt::to_f32(e[j]);
        ss += f * f;
      }
    }
    ss = ptt::warp_sum(ss);
    const float inv = rsqrtf(ss / (float)H + eps);
    uint4* outr = reinterpret_cast<uint4*>(out + (size_t)row * H);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const uint4 wv = ws[lane + 32 * i];
      const T* e = reinterpret_cast<const T*>(&cur[i]);
      const T* we = reinterpret_cast<const T*>(&wv);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j)
        oe[j] = ptt::from_f32<T>(ptt::to_f32(e[j]) * inv * ptt::to_f32(we[j]));
      outr[lane + 32 * i] = o;
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) cur[i] = nxt[i];
    row = next;
  }
}

template <typename T, int VPL>
int warp_launch(const void* x, const void* w, void* out, int rows, float eps,
                cudaStream_t stream) {
  auto kernel = rms_norm_warp_kernel<T, VPL>;
  int dev = 0, sms = 0, resident = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                32 * kWarpRows, 0);
  const int wpb = min(kWarpRows, max(1, (rows + sms - 1) / sms));
  const int blocks = min((rows + wpb - 1) / wpb, sms * resident);
  kernel<<<blocks, 32 * wpb, 0, stream>>>((const T*)x, (const T*)w, (T*)out,
                                          rows, eps);
  return (int)cudaGetLastError();
}

"""
_FIXED_VPT = ("""  auto fn = vpt <= 1   ? launch<T, 1>
            : vpt <= 2 ? launch<T, 2>
            : vpt <= 4 ? launch<T, 4>
                       : launch<T, kMaxVecPerThread>;""",
              """  (void)vpt;
  auto fn = launch<T, kMaxVecPerThread>;""")
_W_AFTER = [(RMS, "      regs[i] = xr[v];\n      wregs[i] = wr[v];",
             "      regs[i] = xr[v];"),
            (RMS, "      const uint4 wv = wregs[i];",
             "      const uint4 wv = wr[v];")]
#: rms_norm variants: name -> (edits, checked?)
RMS_VARIANTS = {
    # the weight loaded after the reduction (a second round trip)
    "weight_after": (_W_AFTER, True),
    # every launch with 8 vectors of registers a thread, whatever the row
    "unsized_registers": ([(RMS, *_FIXED_VPT)], True),
    # one warp a row (bf16 at h 4096: 16 vectors a lane)
    "warp_a_row": ([(RMS, "}  // namespace\n", _WARP_A_ROW
                     + "}  // namespace\n"),
                    (RMS, "      dispatch<__nv_bfloat16>(x, w, out, rows, h, "
                     "eps, stream);", "      warp_launch<__nv_bfloat16, 16>"
                     "(x, w, out, rows, eps, stream);")], True),
    # probe (wrong output, timed only): the launch alone
    "probe_empty": ([(RMS, "  constexpr int V = 16 / sizeof(T);  // elements "
                      "per 16-byte vector\n", "  if (h > 0) return;\n  "
                      "constexpr int V = 16 / sizeof(T);  // elements per "
                      "16-byte vector\n")], False),
}


def rmsnorm_variants(torch, cs, kernels, tmp, parent=None) -> None:
    """rms_norm's variants, and with ``parent`` (a checkout's root) that
    checkout's kernel beside them."""
    from paddle_tpu_torch.ops.kernels import rms_norm as rms

    committed = kernels.library()
    libs = {"committed": (committed, True)}
    if parent is not None:
        libs["parent"] = (build_variant(
            kernels, tmp, "rms_parent", [], (RMS,), csrc=os.path.join(
                parent, "paddle_tpu_torch", "ops", "kernels", "csrc")), True)
    for tag, (edits, checked) in RMS_VARIANTS.items():
        libs[tag] = (build_variant(kernels, tmp, tag, edits, (RMS,)), checked)
    libs["F.rms_norm"] = (None, True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    h, eps = 4096, 1e-5
    w = (1.0 + 0.1 * torch.randn(h, generator=g, device=dev)).to(
        torch.bfloat16)
    xs = {rows: torch.randn(rows, h, generator=g, device=dev).to(
        torch.bfloat16) for rows in (8, 32, 132, 264, 528, 1500, 4096)}
    scratch = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    flush = scratch.zero_
    for rnd in range(2):
        for tag, (lib, checked) in libs.items():
            kernels._lib = lib or committed
            res = {"kernel": "rms_norm", "variant": tag, "round": rnd}
            for rows, x in xs.items():
                if lib is None:
                    def run():
                        return torch.nn.functional.rms_norm(x, (h,), w, eps)
                else:
                    def run():
                        return rms.rms_norm_cuda(x, w, eps)
                # flushed, as chip_smoke times; warm, as in the decode step
                # where the previous kernel just wrote x
                res[f"rows_{rows}"] = {
                    "ms": cs.time_ms(torch, run, flush=flush),
                    "warm_ms": cs.time_ms(torch, run)}
                if checked:
                    got = run().float()
                    want = rms.rms_norm_ref(x, w, eps).float()
                    tol = want.abs() * 2.0 ** -7 + 1e-6
                    res[f"rows_{rows}"]["worst_err_over_tol"] = (
                        (got - want).abs() / tol).max().item()
            emit(res)
    kernels._lib = committed


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"kernel_variants: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
        from paddle_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"kernel_variants: the repository is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = sys.argv[1:] or ["dq", "rows", "decode"]
    parent = None
    if "parent" in parts:
        i = parts.index("parent")
        if i + 1 >= len(parts):
            parts = ["?"]
        else:
            parent = parts.pop(i + 1)
    if set(parts) - {"dq", "rows", "decode", "seqdecode", "splitk",
                     "rmsnorm", "parent"}:
        print("usage: kernel_variants.py [dq] [rows] [decode] [seqdecode] "
              "[splitk] [rmsnorm] [parent DIR]", file=sys.stderr)
        return 2
    _, smi = cs.phase_device(torch)
    kernels.build()
    with tempfile.TemporaryDirectory() as tmp:
        if "dq" in parts:
            dq_variants(torch, cs, kernels, tmp)
        if "rows" in parts:
            rows_variants(torch, cs, kernels, tmp)
        if "decode" in parts:
            decode_variants(torch, cs, kernels, tmp)
        if parent is not None:
            decode_variants(torch, cs, kernels, tmp, parent=parent)
            sass_vs_parent(kernels, tmp)
        if "seqdecode" in parts:
            seqdecode_variants(torch, cs, kernels)
        if "splitk" in parts:
            splitk_variants(torch, cs, kernels)
        if "rmsnorm" in parts:
            rmsnorm_variants(torch, cs, kernels, tmp, parent=parent)
    emit({"ok": True, "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
