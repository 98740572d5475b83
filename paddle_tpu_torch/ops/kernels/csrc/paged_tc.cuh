// The tensor-core decode kernel over a paged KV pool, one template shared
// by the fused decode steps (fused_decode_tc.cu, B7 / B11: kFused) and the
// unfused paged decode (paged_decode_tc.cu, B5): ONE query token per slot
// against its live K / V pages over fp, int8 or packed-int4 pools, bf16 q
// at head_dim 64 or 128 (D), F the pool's storage (paged.cuh).  Grid
// (slot, kv head, shard) of D threads; S shards of P table pages, each
// block's range cut by the device lens, so no host sync; shards past a
// lane's live pages exit at once.
//  - The front, fused only: rope in the input dtype (paged.cuh
//    `rope_elem`), the write-page insert (fp) or `requant_page` (codes and
//    scales bit-equal to the plain composition; its code run for K, then
//    V) on the write page once it has landed and before it is scored, and
//    the spill-page zeroing of a dropped lane.  The unfused walk takes q
//    roped, appends nothing, and writes an empty lane's output as exactly
//    0.  Every global value the prologue needs is loaded in one batch.
//  - The walk: a ring of three page tiles (two in flight), 16-byte
//    cp.async into rows padded by 16 bytes (paged.cuh `load_page`); on
//    quantized pools the ring carries the raw codes, and once a page has
//    landed its live rows expand to bf16 in a padded tile (codes are exact
//    in bf16).  Each warp scores 16-column chunks of the page (chunk c to
//    warp c mod warps) with warp-level `mma.sync.m16n8k16` (bf16 in, f32
//    accumulate), `ldmatrix` from the padded rows (272-byte rows shift 16
//    bytes a row: conflict-free): the head group's rep <= 8 q rows pad to
//    the 16 rows of one m16 tile (wgmma would pad them to 64), S = q K^T
//    for 16 columns at once, then O += P V with P straight from the S
//    registers, in hi + lo bf16 parts (one rounding of P used up to 0.72
//    of the attention tolerance in the tensor-core prefill walk).  Each
//    warp keeps its own online softmax (m, l, the m16 x D accumulator in
//    registers).  Columns at or past the page's live count read a zero row
//    and score -1e30.  Quantized: the page's k scale multiplies S and its
//    v scale P before P V (the row sums take P unscaled).
//  - The merge: the block's warps through shared memory in warp order.  A
//    lane whose walk fits one shard writes its output directly.  Otherwise
//    each shard block writes its partial (m, l, acc), and the last of the
//    lane's live shards to finish (an atomic ticket a (slot, kv head),
//    which that block resets to 0 for the next launch) merges the partials
//    in shard order with `_flash_combine`'s arithmetic: deterministic, and
//    no second launch.
// One kernel body with the front under `kFused`, not a walk with a page
// hook: the hook form (as many instructions, another register allocation)
// made the fused bf16 step 1-4% slower on the H100.  In this form the
// fused bf16 step compiles to the machine code of a kernel written for it
// alone, instruction for instruction, and the quantized ones to within 10
// of ~3400 instructions (`kernel_variants.py parent`).
// Not used: wgmma (the tiles are too small to feed it), TMA.
#pragma once

#include "paged.cuh"
#include "wgmma.cuh"

namespace ptt {
namespace tc {

using T = __nv_bfloat16;

constexpr int kRows = 8;  // q rows a block keeps (rep <= kMaxRep = 8)

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// d[4] += A[16 x 16] B[16 x 8]; rows 8-15 of A are zero (a1 = a3 = 0)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

constexpr int kStages = 3;    // page tiles in the cp.async ring
constexpr int kPre = 4;       // table entries the prologue loads
constexpr int kMaxShards = 8;  // shards the merge reads in one batch
// shards a launch takes: the merge keeps m and l of every (shard, row) in
// the ring's first 4 KB
constexpr int kMaxLaunchShards = 64;

// Shared memory of a block, in bytes: [region A: the ring of raw K / V
// tiles, reused after the walk for the warps' merge] [expanded bf16 K / V
// tiles (quantized pools)] [q tile, kRows bf16 rows] [a zero row] [the
// stages' page scales] [32-float reduction scratch] [the ticket]
template <int F, int D>
struct Smem {
  static constexpr int kWarps = D / 32;
  __host__ __device__ static int ld_raw() {
    return KV<T, F>::row_bytes(D) + kRowPad;
  }
  static constexpr int kLdX = 2 * D + kRowPad;
  __host__ __device__ static size_t ring(int bs) {
    return 2 * kStages * (size_t)bs * ld_raw();
  }
  // the warps' merge, and the shards' merge: m and l of every (shard,
  // row), the acc rows of kMaxShards shards, the running sums
  static constexpr size_t kShardMerge =
      2 * kMaxLaunchShards * kRows + (size_t)(kMaxShards + 1) * kRows * D;
  static constexpr size_t kMerge =
      ((size_t)kWarps * kRows * (D + 2) > kShardMerge
           ? (size_t)kWarps * kRows * (D + 2)
           : kShardMerge) *
      sizeof(float);
  __host__ __device__ static size_t region_a(int bs) {
    const size_t r = ring(bs);
    return ((r > kMerge ? r : kMerge) + 15) & ~(size_t)15;
  }
  __host__ __device__ static size_t xtiles(int bs) {
    return F == kFp ? 0 : 2 * (size_t)bs * kLdX;
  }
  __host__ __device__ static size_t total(int bs) {
    return region_a(bs) + xtiles(bs) + (size_t)(kRows + 1) * kLdX + 32 +
           32 * sizeof(float) + 16;
  }
};

// A launch's operands; the fused step's alone (k_new, v_new, cos, sin,
// wblk, wable) are unused by the unfused walk, whose pools it only reads
struct Params {
  const T* q;  // [b, nh, D]: the fused step ropes it, the unfused walk
               // takes it roped
  const T* k_new;
  const T* v_new;
  const T* cos;
  const T* sin;
  unsigned char* kpool;
  unsigned char* vpool;
  float* ksc;  // [nbp, nkv] (quantized pools)
  float* vsc;
  const int* tables;
  const int* lens;
  const int* wblk;
  const int* wable;
  float* m_out;  // [b, nkv, S, rep]
  float* l_out;
  float* acc_out;  // [b, nkv, S, rep, hd]
  int* tickets;    // [b * nkv], zero between launches
  T* out;          // [b, nh, hd]
  int nh, nkv, nbp, bs, max_blocks, S, P;
  float scale;
};

template <bool kFused, int F, int D>
__global__ void __launch_bounds__(D) decode_tc_kernel(const Params p) {
  using SM = Smem<F, D>;
  constexpr int NW = SM::kWarps, LDX = SM::kLdX, NO = D / 8;
  constexpr bool kQuant = F != kFp;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = p.nh / p.nkv, bs = p.bs;
  const int ldr = SM::ld_raw(), row_bytes = KV<T, F>::row_bytes(D);
  unsigned char* ring = smem;  // [kStages][K, V][bs][ldr]
  unsigned char* xk = smem + SM::region_a(bs);  // [bs][LDX] (quantized)
  unsigned char* xv = xk + bs * LDX;
  unsigned char* qt = xk + SM::xtiles(bs);  // [kRows][LDX]
  unsigned char* zrow = qt + kRows * LDX;   // [LDX] zeros
  float* scs = reinterpret_cast<float*>(zrow + LDX);  // [kStages][k, v]
  float* red = scs + 8;                               // [32]
  int* tk_sh = reinterpret_cast<int*>(red + 32);

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int j0 = s * p.P;
  // the reference's `_fused_walk_page` (`_resolve_page` unfused)
  auto page_of = [&](int j) {
    const int col = min(j, p.max_blocks - 1);
    return min(max(p.tables[(size_t)b * p.max_blocks + col], 0), p.nbp - 1);
  };
  // every global value the prologue needs, loaded in one batch (nothing
  // here depends on another load): the lane's scalars, the shard's first
  // table entries, the q rows and (fused) the rope rows
  const int len_pre = p.lens[b];
  bool on = false;  // fused: whether the lane writes, and its write page
  int wb = 0;
  if constexpr (kFused) {
    on = p.wable[b] == 1;
    wb = min(max(p.wblk[b], 0), p.nbp - 1);
  }
  int pg[kPre];
#pragma unroll
  for (int i = 0; i < kPre; ++i) pg[i] = page_of(j0 + i);
  float c = 0.f, sn = 0.f;
  if constexpr (kFused) {
    c = to_f32(p.cos[(size_t)b * D + d]);
    sn = to_f32(p.sin[(size_t)b * D + d]);
  }
  float qv[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if constexpr (kFused)
      qv[r] = r < rep ? rope_elem(p.q + ((size_t)b * p.nh + (size_t)h * rep +
                                         r) * D, d, D / 2, c, sn)
                      : 0.f;
    else
      qv[r] = r < rep ? to_f32(p.q[((size_t)b * p.nh + (size_t)h * rep + r) *
                                       D + d])
                      : 0.f;
  }
  const size_t row_off = ((size_t)b * p.nkv + h) * D;
  float k_ins = 0.f;  // fused: the roped k row and the v row it appends
  T k_roped, v_raw;
  if constexpr (kFused) {
    k_ins = rope_elem(p.k_new + row_off, d, D / 2, c, sn);
    k_roped = from_f32<T>(k_ins);
    v_raw = p.v_new[row_off + d];
  }

  // fused: the appended token included
  const int length = kFused ? len_pre + 1 : len_pre;
  const int npages = (length + bs - 1) / bs;
  const int nlive = min(p.S, (npages + p.P - 1) / p.P);
  if constexpr (!kFused) {
    if (nlive == 0) {  // an empty lane: exactly 0
      if (s == 0)
        for (int r = 0; r < rep; ++r)
          p.out[((size_t)b * p.nh + (size_t)h * rep + r) * D + d] =
              from_f32<T>(0.f);
      return;
    }
  }
  if (s >= nlive) return;  // no live page: no partial, no ticket
  const int wpage = len_pre / bs, wrow = len_pre % bs;
  const size_t page_bytes = (size_t)bs * row_bytes;
  const int j1 = min(j0 + p.P, npages);

  // page `page`'s K / V tiles (and, quantized, its two scales) into stage
  // st, one cp.async group
  auto prefetch = [&](int page, int st) {
    const size_t base = ((size_t)page * p.nkv + h) * page_bytes;
    unsigned char* kt = ring + (size_t)st * 2 * bs * ldr;
    if constexpr (kQuant) {
      if (d < 2)
        wg::cp_async4(wg::smem_u32(scs + 2 * st + d),
                      (d ? p.vsc : p.ksc) + (size_t)page * p.nkv + h, true);
    }
    load_page(kt, kt + bs * ldr, p.kpool + base, p.vpool + base, bs,
              row_bytes, ldr);  // commits the group
  };
  const int n = j1 - j0;
  auto pid = [&](int i) {  // the page id of page j0 + i
    int v = -1;
#pragma unroll
    for (int u = 0; u < kPre; ++u) v = i == u ? pg[u] : v;
    return v >= 0 ? v : page_of(j0 + i);
  };
  // the first kStages - 1 pages in flight; then one page ahead a step
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    if (i < n) prefetch(pid(i), i);
  int nxt = kStages - 1 < n ? pid(kStages - 1) : 0;

  // the q tile (rows past rep zero) and the zero row
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    reinterpret_cast<T*>(qt + r * LDX)[d] = from_f32<T>(qv[r]);
  for (int i = d; i < LDX / 4; i += D) reinterpret_cast<int*>(zrow)[i] = 0;
  __syncthreads();  // the q tile

  // q's A fragments, rows 0-7 (rows 8-15 of the m16 tile are zero)
  uint32_t qa[D / 16][2];
  {
    const uint32_t a0 = wg::smem_u32(qt) + (lane & 7) * LDX +
                        ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x2(a0 + kk * 32, qa[kk][0], qa[kk][1]);
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m_run = kNegInf, l_run = 0.f;  // row g of this warp
  const uint32_t zaddr = wg::smem_u32(zrow);

  for (int i = 0; i < n; ++i) {
    const int j = j0 + i, st = i % kStages;
    unsigned char* kt = ring + (size_t)st * 2 * bs * ldr;
    unsigned char* vt = kt + bs * ldr;
    // this page's group is complete when at most the later in-flight ones
    // (the next kStages - 2 pages) are pending
    if (i + 1 < n)
      cp_async_wait<kStages - 2>();
    else
      cp_async_wait<0>();
    __syncthreads();  // page j has landed; every warp is past page j - 1
    if (i + kStages - 1 < n) {  // into the stage the previous page left
      prefetch(nxt, (st + kStages - 1) % kStages);
      if (i + kStages < n) nxt = pid(i + kStages);
    }
    const int ncol = min(bs, length - j * bs);
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      ks = scs[2 * st];
      vs = scs[2 * st + 1];
    }
    if (kFused && j == wpage) {  // the fused step's write page
      if constexpr (kQuant) {
        const size_t widx = (size_t)wb * p.nkv + h;
        if (on) {
          // K, then V, through one copy of requant_page's code: each
          // launch fetches its instructions from device memory (between
          // two launches the decode step streams the layer's weights
          // through L2), so code run once costs its fetch.  requant_page's
          // barriers order these reads of the old scales before thread 0
          // writes the new ones
#pragma unroll 1
          for (int kv = 0; kv < 2; ++kv) {
            const float sc = requant_page<F>(
                kv ? vt : kt, ldr, kv ? vs : ks, wrow,
                kv ? to_f32(v_raw) : k_ins,
                (kv ? p.vpool : p.kpool) + widx * page_bytes, bs, D, red);
            ks = kv ? ks : sc;
            vs = kv ? sc : vs;
          }
          if (d == 0) {
            p.ksc[widx] = ks;
            p.vsc[widx] = vs;
          }
        } else {
          __syncthreads();  // every thread has read the old scales
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          uint4* kz = reinterpret_cast<uint4*>(p.kpool + widx * page_bytes);
          uint4* vz = reinterpret_cast<uint4*>(p.vpool + widx * page_bytes);
          for (int e = d; e < (int)(page_bytes / 16); e += D) {
            kz[e] = zero;
            vz[e] = zero;
          }
          if (d == 0) {
            p.ksc[widx] = 0.f;
            p.vsc[widx] = 0.f;
          }
        }
      } else {
        const size_t wbase = ((size_t)wb * p.nkv + h) * (size_t)bs * D;
        T* kpool = reinterpret_cast<T*>(p.kpool);
        T* vpool = reinterpret_cast<T*>(p.vpool);
        if (on) {
          reinterpret_cast<T*>(kt + wrow * ldr)[d] = k_roped;
          reinterpret_cast<T*>(vt + wrow * ldr)[d] = v_raw;
          kpool[wbase + (size_t)wrow * D + d] = k_roped;
          vpool[wbase + (size_t)wrow * D + d] = v_raw;
        } else {
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          uint4* kz = reinterpret_cast<uint4*>(kpool + wbase);
          uint4* vz = reinterpret_cast<uint4*>(vpool + wbase);
          for (int e = d; e < (int)(page_bytes / 16); e += D) {
            kz[e] = zero;
            vz[e] = zero;
          }
        }
        __syncthreads();  // the inserted row
      }
    }
    const unsigned char* ktile = kt;
    const unsigned char* vtile = vt;
    int ld = ldr;
    if constexpr (kQuant) {
      // the live rows' codes (requantized on the write page) as bf16: 8
      // codes -> one 16-byte chunk
      constexpr int CPR = D / 8;
      for (int i = d; i < 2 * ncol * CPR; i += D) {
        const int kv = i / (ncol * CPR), rem = i % (ncol * CPR);
        const int r = rem / CPR, cc = rem % CPR;
        const unsigned char* src = (kv ? vt : kt) + r * ldr;
        float x[8];
        if constexpr (F == kInt8) {
          const uint2 w = *reinterpret_cast<const uint2*>(src + 8 * cc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = (float)(int)(signed char)(w.x >> (8 * e));
            x[4 + e] = (float)(int)(signed char)(w.y >> (8 * e));
          }
        } else {
          const unsigned w = *reinterpret_cast<const unsigned*>(src + 4 * cc);
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = nibble(w >> (4 * e));
        }
        *reinterpret_cast<uint4*>((kv ? xv : xk) + r * LDX + 16 * cc) =
            make_uint4(wg::pack2<T>(x[0], x[1]), wg::pack2<T>(x[2], x[3]),
                       wg::pack2<T>(x[4], x[5]), wg::pack2<T>(x[6], x[7]));
      }
      __syncthreads();  // the expanded tiles
      ktile = xk;
      vtile = xv;
      ld = LDX;
    }
    const uint32_t kbase = wg::smem_u32(ktile), vbase = wg::smem_u32(vtile);
    const float sscale = p.scale * ks;
    for (int c0 = 16 * warp; c0 < ncol; c0 += 16 * NW) {
      // S = q K^T over columns c0 .. c0 + 15: n-tile 0 = columns c0 + 0-7,
      // n-tile 1 = c0 + 8-15; the lane's ldmatrix row is column kr
      const int kr = c0 + (lane & 7) + ((lane >> 4) << 3);
      const uint32_t ka =
          (kr < ncol ? kbase + kr * ld : zaddr) + ((lane >> 3) & 1) * 16;
      // two accumulators a tile (even and odd k steps) halve the chain
      // of dependent products
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(ka + kk * 32, kb);
        mma16816(s[kk & 1], qa[kk][0], qa[kk][1], kb[0], kb[1]);
        mma16816(s[2 + (kk & 1)], qa[kk][0], qa[kk][1], kb[2], kb[3]);
      }
      // row g's scores of columns c0 + 2t, 2t + 1, 8 + 2t, 9 + 2t
      float x[4] = {s[0][0] + s[1][0], s[0][1] + s[1][1],
                    s[2][0] + s[3][0], s[2][1] + s[3][1]};
      float mx = m_run;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c0 + 8 * (i >> 1) + 2 * t4 + (i & 1);
        x[i] = col < ncol ? x[i] * sscale : kNegInf;
        mx = fmaxf(mx, x[i]);
      }
      mx = wg::quad_max(mx);
      const float alpha = m_run > 0.5f * kNegInf ? expf(m_run - mx) : 0.f;
      m_run = mx;
      float pv[4], psum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = x[i] > 0.5f * kNegInf ? expf(x[i] - mx) : 0.f;
        psum += e;
        pv[i] = e * vs;  // P V takes p times the page's v scale
      }
      l_run = alpha * l_run + psum;  // per-thread partial; alpha the quad's
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha;
        o[n][1] *= alpha;
      }
      // P as the A fragment (row g: columns 2t.. and 8 + 2t..), hi + lo
      const uint32_t h0 = wg::pack2<T>(pv[0], pv[1]);
      const uint32_t h2 = wg::pack2<T>(pv[2], pv[3]);
      const float2 b0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&h0));
      const float2 b2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&h2));
      const uint32_t l0 = wg::pack2<T>(pv[0] - b0.x, pv[1] - b0.y);
      const uint32_t l2 = wg::pack2<T>(pv[2] - b2.x, pv[3] - b2.y);
      // O += P V: V rows c0 .. c0 + 15, head_dim columns 16 at a time
      const int vr = c0 + (lane & 7) + (((lane >> 3) & 1) << 3);
      const uint32_t va = (vr < ncol ? vbase + vr * ld : zaddr) +
                          (lane >> 4) * 16;
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldsm_x4_t(va + n * 16, vb);
        mma16816(o[n], h0, h2, vb[0], vb[1]);
        mma16816(o[n], l0, l2, vb[0], vb[1]);
        mma16816(o[n + 1], h0, h2, vb[2], vb[3]);
        mma16816(o[n + 1], l0, l2, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes scratch

  // the warps' states, merged in warp order
  float* wo = reinterpret_cast<float*>(ring);  // [NW][kRows][D]
  float* wm = wo + NW * kRows * D;             // [NW][kRows]
  float* wl = wm + NW * kRows;                 // [NW][kRows]
  l_run = wg::quad_sum(l_run);
  if (g < rep) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(&wo[(warp * kRows + g) * D + 8 * n +
                                     2 * t4]) = make_float2(o[n][0], o[n][1]);
    if (t4 == 0) {
      wm[warp * kRows + g] = m_run;
      wl[warp * kRows + g] = l_run;
    }
  }
  __syncthreads();
  // one row at a time: this shard's output when it is the lane's only
  // live shard, else its partial (m, l, acc)
  const size_t lane_part = ((size_t)b * p.nkv + h) * p.S;
  const size_t part = (lane_part + s) * rep;
  T* ob = p.out + ((size_t)b * p.nh + (size_t)h * rep) * D;
  for (int r = 0; r < rep; ++r) {
    float m_r = kNegInf;
    for (int w = 0; w < NW; ++w) m_r = fmaxf(m_r, wm[w * kRows + r]);
    float l_r = 0.f, a_r = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float mw = wm[w * kRows + r];
      const float wt = mw > 0.5f * kNegInf ? expf(mw - m_r) : 0.f;
      l_r += wt * wl[w * kRows + r];
      a_r += wt * wo[(w * kRows + r) * D + d];
    }
    if (nlive == 1) {
      ob[(size_t)r * D + d] = from_f32<T>(a_r / (l_r == 0.f ? 1.f : l_r));
    } else {
      p.acc_out[(part + r) * D + d] = a_r;
      if (d == 0) {
        p.m_out[part + r] = m_r;
        p.l_out[part + r] = l_r;
      }
    }
  }
  if (nlive > 1) {
    // the ticket: the last live shard to get here merges
    __threadfence();
    __syncthreads();
    if (d == 0) *tk_sh = atomicAdd(p.tickets + (size_t)b * p.nkv + h, 1);
    __syncthreads();
    if (*tk_sh != nlive - 1) return;
    if (d == 0) p.tickets[(size_t)b * p.nkv + h] = 0;
    __threadfence();
    // `_flash_combine` over the live shards in order, combine_kernel's
    // arithmetic (shards past them would add exact zeros).  m and l of
    // every (shard, row) come into shared memory in one batch of loads;
    // thread r < rep computes row r's shard weights and their sum over l;
    // then the acc rows of up to kMaxShards shards at a time come in
    // (16-byte loads, four in flight a thread), and each thread merges its
    // column
    float* sm = reinterpret_cast<float*>(ring);  // [nlive][rep] m, weights
    float* sl = sm + kMaxLaunchShards * kRows;   // [nlive][rep] l, then sums
    float* sa = sl + kMaxLaunchShards * kRows;   // [kMaxShards][rep][D]
    float* srun = sa + kMaxShards * kRows * D;   // [rep][D] running sums
    auto load_acc = [&](int q0, int q1) {
      const float4* src = reinterpret_cast<const float4*>(
          p.acc_out + (lane_part + q0) * rep * D);
#pragma unroll 4
      for (int i = d; i < (q1 - q0) * rep * D / 4; i += D)
        reinterpret_cast<float4*>(sa)[i] = __ldcg(src + i);
    };
    for (int i = d; i < nlive * rep; i += D) {
      sm[i] = __ldcg(p.m_out + lane_part * rep + i);
      sl[i] = __ldcg(p.l_out + lane_part * rep + i);
    }
    load_acc(0, min(nlive, kMaxShards));
    __syncthreads();
    if (d < rep) {
      float m_max = kNegInf;
      for (int q = 0; q < nlive; ++q) m_max = fmaxf(m_max, sm[q * rep + d]);
      float l_tot = 0.f;
      for (int q = 0; q < nlive; ++q) {
        const float m = sm[q * rep + d];
        const float w = m > 0.5f * kNegInf ? expf(m - m_max) : 0.f;
        l_tot += w * sl[q * rep + d];
        sm[q * rep + d] = w;
      }
      sl[d] = l_tot == 0.f ? 1.f : l_tot;  // row d's l read above
    }
    __syncthreads();
    for (int q0 = 0; q0 < nlive; q0 += kMaxShards) {
      const int q1 = min(nlive, q0 + kMaxShards);
      if (q0) {  // the next batch, once every thread is done with this one
        __syncthreads();
        load_acc(q0, q1);
        __syncthreads();
      }
      for (int r = 0; r < rep; ++r) {
        float a_tot = q0 ? srun[r * D + d] : 0.f;
        for (int q = q0; q < q1; ++q)
          a_tot += sm[q * rep + r] * sa[((q - q0) * rep + r) * D + d];
        if (q1 < nlive)
          srun[r * D + d] = a_tot;
        else
          ob[(size_t)r * D + d] = from_f32<T>(a_tot / sl[r]);
      }
    }
  }
}

template <bool kFused, int F, int D>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = Smem<F, D>::total(p.bs);
  auto kernel = decode_tc_kernel<kFused, F, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(b, p.nkv, p.S), D, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool kFused, int F>
int launch_width(const Params& p, int b, int hd, cudaStream_t stream) {
  if (hd == 64) return launch<kFused, F, 64>(p, b, stream);
  if (hd == 128) return launch<kFused, F, 128>(p, b, stream);
  return (int)cudaErrorInvalidValue;
}

// The kernel of pool format kv_format (paged.cuh's kFp, kInt8, kInt4) at
// head_dim hd (64 or 128; any other returns cudaErrorInvalidValue
// unlaunched), grid (b, nkv, S); returns cudaGetLastError()
template <bool kFused>
int launch_format(const Params& p, int b, int hd, int kv_format,
                  cudaStream_t stream) {
  if (kv_format == kInt8) return launch_width<kFused, kInt8>(p, b, hd, stream);
  if (kv_format == kInt4) return launch_width<kFused, kInt4>(p, b, hd, stream);
  return launch_width<kFused, kFp>(p, b, hd, stream);
}
}  // namespace tc
}  // namespace ptt
