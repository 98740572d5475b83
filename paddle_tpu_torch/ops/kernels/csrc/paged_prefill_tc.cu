// Ragged multi-row paged attention on the tensor cores, split over the KV
// axis: the chunked-prefill rows of the mixed step and the K+1 rows of
// the speculative verify step over fp, int8 or
// packed-int4 pools, for bf16 q at head_dim 64 or 128 (the route
// `paged_attention.paged_rows_route` names "tc"; every other shape takes
// the CUDA-core walk of paged_prefill.cu).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_prefill_kernel`
// (B9) and `_verify_kernel` (B10, its T = K+1 case over fp pools).  On the
// TPU both ran the grid (slots, kv_heads, pages) with the page axis in
// order and the slot's whole q tile (row t * rep + g = query token t,
// grouped head g) in VMEM, m, l, acc carried in scratch from page to page.
// Row t sits at position len - qlen + t and sees row_len = len - (qlen - 1
// - t) KV positions (clamped to the table's reach, max_blocks * bs); rows
// at or past qlen see none and are exactly 0.
//
// Bound on the H100: the score and PV products do 4 * hd flops per visible
// (row, column) pair and q head.  The mixed step's lane mix (chip_smoke.py)
// does ~200 flops per byte of live K/V, under the bf16 ridge: bytes bound
// it (0.013 ms at Llama-3-8B widths on bf16 pools, against 0.0065 ms of
// operations), and int4 pools are bound by operations.
//
// Design:
//  - Tiles of 64 rows (one warpgroup's wgmma M) in the t * rep + g order,
//    128 threads a block, two blocks an SM.  The block's q rows are staged
//    once, in the model dtype, into the 128-byte swizzle of wgmma.cuh (rows
//    past qlen zero-filled); KV tiles are 64 columns.
//  - S = Q K^T (m64n64k16, both K-major from shared memory) and O += P V
//    (m64nDk16, P from the S accumulator registers, V MN-major) on wgmma
//    with f32 accumulators; the online softmax runs on the accumulator
//    registers as in flash_fwd_tc.cu, with one uniform branch a tile: no
//    element test where every row sees the whole tile.  P enters P V as
//    hi + lo parts of bf16 (two products): rounded once it met the
//    attention tolerance, but with less margin (PERF.md).
//  - K/V columns are copied with 16-byte cp.async in a ring of kStages
//    tiles, kStages - 1 ahead of the products.  Each column resolves its
//    page through the block table with the reference's `_resolve_page`
//    clamps, so any block size works; at block size 64 a tile is one
//    (page, kv head) run of contiguous rows.
//  - Quantized pools: int8 codes and int4 nibbles are small integers,
//    exact in bf16.  The ring carries the raw codes; each tile is expanded
//    to bf16 in shared memory before its products, and the per-(page, kv
//    head) f32 scales are applied outside them: S's column j times the k
//    scale of j's page, P's column j times the v scale before P enters
//    P V (the row sums l take P unscaled).  The reference dequantizes
//    code x scale in f32 and then sums in f32; here q . code is summed in
//    f32 and scaled once, and P x v_scale enters P V in its hi + lo parts,
//    so the two round at other places: within the attention tolerance,
//    which chip_smoke.py and the card tests hold.
//  - The split over the KV axis.  A lane whose live rows fit one tile
//    (a decode lane, verify rows) walks its columns in up to `max_splits`
//    blocks, and a row tile of a longer lane (a prefill chunk) with a long
//    walk (kLongWalk KV tiles) in two, each block over a contiguous run of
//    KV tiles (rows_split below).  The split count is fixed on the host
//    from the table width and the ranges come from the device lens, so
//    the launch needs no host sync.  Each split writes its raw partials
//    (m, l, acc in f32) for its live rows only, and a second launch merges
//    them in split order as the reference's `_flash_combine`:
//    deterministic.  A block walks 64 rows, so a 128-row chunk's tiles
//    already run side by side; their split is capped at two because each
//    split moves 64 rows of f32 partials (bytes the bound does not have).
//  - A row tile with no live row writes zeros and exits.
// Not yet used: TMA, a producer warp with setmaxnreg, overlap of a tile's
// softmax with the previous tile's P V product.  Tried on the H100 and no
// faster: a three-stage ring, a four-way split of the long chunk tiles
// (kernel_variants.py, PERF.md), every page id of a tile read before its
// first copy.
#include "paged.cuh"
#include "wgmma.cuh"

namespace {

using namespace ptt::wg;

constexpr int kBR = 64, kBKV = 64, kThreads = 128;
constexpr int kStages = 2;  // KV tiles in the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg = -1e30f;

struct RowsTcParams {
  const void* q;  // [b, T, nh, hd]
  const unsigned char* kpool;
  const unsigned char* vpool;
  const float* ksc;  // [nbp, nkv] (quantized pools)
  const float* vsc;
  const int* tables;  // [b, max_blocks]
  const int* lens;    // [b] total written length incl. the rows
  const int* qlens;   // [b] live rows
  void* out;          // [b, T, nh, hd]
  float* pm;          // [b * nkv, slots, prow] split partials
  float* pl;
  float* pacc;  // [b * nkv, slots, prow, hd]
  int T, nh, nkv, nbp, bs, max_blocks, n_tiles, max_splits, prow;
  float scale;
};

// A row tile of a lane with more rows than one tile splits its walk in at
// most kLongSplits blocks, and only from kLongWalk KV tiles up.
constexpr int kLongSplits = 2, kLongWalk = 16;
// the most blocks a row tile's walk splits into (the combine's registers)
constexpr int kMaxSplits = 8;

// How a row tile's nkt KV tiles are split: `n` blocks of `per` tiles
// (the last may be shorter, none empty).  A lane whose live rows fit one
// tile (`few`: a decode lane, verify rows) splits in up to max_splits; a
// longer lane's tile in up to kLongSplits, if its walk is long.
// paged_attention.rows_split is the same rule.
__device__ __forceinline__ void rows_split(int nkt, int max_splits, bool few,
                                           int& per, int& n) {
  n = few ? min(max_splits, nkt)
          : (nkt >= kLongWalk ? min(kLongSplits, max_splits) : 1);
  if (n < 1) n = 1;
  per = (nkt + n - 1) / n;
  n = per > 0 ? (nkt + per - 1) / per : 1;
}

// Blocks a (slot, kv head) launches: ts = min(kLongSplits, max_splits) for
// each row tile, and the rest of max_splits for row tile 0 (the one a
// few-row lane fills).  Block y and partial slot of (tile, split):
__host__ __device__ __forceinline__ int tile_splits(int max_splits) {
  return max_splits < kLongSplits ? max_splits : kLongSplits;
}
__host__ __device__ __forceinline__ int lane_blocks(int n_tiles,
                                                    int max_splits) {
  const int ts = tile_splits(max_splits);
  return n_tiles * ts + max_splits - ts;
}
__device__ __forceinline__ int split_slot(int tile, int split, int n_tiles,
                                          int max_splits) {
  const int ts = tile_splits(max_splits);
  return split < ts ? tile * ts + split : n_tiles * ts + split - ts;
}

// The geometry of one (slot, kv head) the walk and the combine share.
struct Lane {
  int b, h, rep, R, live, len, qlen, reach;
  __device__ Lane(const RowsTcParams& p, int bh) {
    b = bh / p.nkv;
    h = bh % p.nkv;
    rep = p.nh / p.nkv;
    R = p.T * rep;
    len = p.lens[b];
    qlen = min(max(p.qlens[b], 0), p.T);
    live = min(qlen * rep, R);
    reach = p.max_blocks * p.bs;
  }
  // visible columns of row r (0 for rows past qlen)
  __device__ int row_len(int r) const {
    const int t = r / rep;
    return r < live ? max(min(len - (qlen - 1 - t), reach), 0) : 0;
  }
  // element offset of row r's head_dim vector in q / out
  __device__ size_t row_off(const RowsTcParams& p, int r, int hd) const {
    return (((size_t)b * p.T + r / rep) * p.nh + (size_t)h * rep + r % rep) *
           hd;
  }
};

__device__ __forceinline__ int resolve_page(const RowsTcParams& p, int b,
                                            int j) {
  const int col = min(j / p.bs, p.max_blocks - 1);
  return min(max(p.tables[(size_t)b * p.max_blocks + col], 0), p.nbp - 1);
}

// bytes of one stage of the ring: K and V (swizzled T tiles for fp pools,
// raw code rows for quantized ones), then 2 x 64 f32 column scales, in a
// whole number of KB so every stage stays 1024-byte aligned
template <int F, int D>
__host__ __device__ constexpr uint32_t rows_stage_bytes() {
  constexpr uint32_t rb = F == ptt::kFp ? D * 2 : F == ptt::kInt8 ? D : D / 2;
  constexpr uint32_t raw = 2 * kBKV * rb + (F == ptt::kFp ? 0 : 2 * kBKV * 4);
  return (raw + 1023) & ~1023u;
}
// q tile, the expanded K and V tiles (quantized pools), the ring, slack
template <int F, int D>
__host__ __device__ constexpr size_t rows_smem_bytes() {
  return (size_t)kBR * D * 2 + (F == ptt::kFp ? 0 : 2 * kBKV * D * 2) +
         kStages * rows_stage_bytes<F, D>() + 1024;
}

// swizzled byte offset of 16-byte chunk c of row r in a [R rows][D] tile
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

template <typename T, int F, int D>
__global__ void __launch_bounds__(kThreads, 2)
    rows_tc_kernel(const RowsTcParams p) {
  constexpr int BR = kBR, BKV = kBKV, NT = kThreads;
  constexpr int NO = D / 2, NS = BKV / 2;  // accumulator floats a thread
  constexpr bool kQuant = F != ptt::kFp;
  constexpr int RB = F == ptt::kFp ? D * 2 : F == ptt::kInt8 ? D : D / 2;
  constexpr uint32_t QB = BR * D * 2, KVB = BKV * D * 2;
  constexpr uint32_t SB = rows_stage_bytes<F, D>();
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  // quantized pools: the expanded K and V tiles, then the ring
  const uint32_t sKx = sQ + QB, sVx = sKx + KVB;
  const uint32_t sRing = kQuant ? sVx + KVB : sQ + QB;
  char* gbase = smem_raw + (sQ - raw);  // generic pointer of sQ

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int bh = blockIdx.x;
  const Lane ln(p, bh);
  // blockIdx.y < n_tiles * ts: split y % ts of row tile n_tiles - 1 -
  // y / ts (heaviest first); past it: the further splits of row tile 0
  const int y = blockIdx.y, ts = tile_splits(p.max_splits);
  const int tile = y < p.n_tiles * ts ? p.n_tiles - 1 - y / ts : 0;
  const int split = y < p.n_tiles * ts ? y % ts : y - p.n_tiles * ts + ts;
  const int r0 = tile * BR;
  const int r_end = min(r0 + BR, ln.R);
  T* ob = static_cast<T*>(p.out);

  if (r0 >= ln.live) {  // no live row: zeros (once), then done
    if (split == 0) {
      constexpr int CPR = D / 8;
      for (int idx = tid; idx < (r_end - r0) * CPR; idx += NT) {
        const int r = r0 + idx / CPR, c = idx % CPR;
        *reinterpret_cast<uint4*>(ob + ln.row_off(p, r, D) + 8 * c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  // the tile's widest row: its last live one
  const int ncol = ln.row_len(min(r_end, ln.live) - 1);
  const int nkt = (ncol + BKV - 1) / BKV;
  int per, nsplit;
  rows_split(nkt, p.max_splits, ln.live <= BR, per, nsplit);
  if (split >= nsplit) return;
  const int kt0 = split * per, kt1 = min(nkt, kt0 + per);
  const bool partial = nsplit > 1;

  // q rows of the tile, zero past the live ones
  {
    const T* qb = static_cast<const T*>(p.q);
    constexpr int CPR = D / 8;
#pragma unroll
    for (int n = 0; n < BR * CPR / NT; ++n) {
      const int idx = n * NT + tid;
      const int r = idx / CPR, c = idx % CPR;
      const bool ok = r0 + r < ln.live;
      cp_async16(sQ + swz<BR>(r, c),
                 qb + (ok ? ln.row_off(p, r0 + r, D) : 0) + 8 * c, ok);
    }
  }
  // KV tile kt into stage st: fp pools straight into the swizzled tiles,
  // quantized ones as raw code rows plus each column's two scales
  auto prefetch = [&](int kt, int st) {
    const uint32_t s0 = sRing + st * SB;
    const int j0 = kt * BKV;
    constexpr int CPR = RB / 16;  // 16-byte chunks a stored row
#pragma unroll
    for (int n = 0; n < BKV * CPR / NT; ++n) {
      const int idx = n * NT + tid;
      const int c = idx / CPR, k = idx % CPR, j = j0 + c;
      const bool ok = j < ncol;
      size_t at = 0;
      if (ok) {
        const int page = resolve_page(p, ln.b, j);
        at = (((size_t)page * p.nkv + ln.h) * p.bs + j % p.bs) * RB + 16 * k;
      }
      const uint32_t dst =
          kQuant ? (uint32_t)(c * RB + 16 * k) : swz<BKV>(c, k);
      cp_async16(s0 + dst, p.kpool + at, ok);
      cp_async16(s0 + BKV * RB + dst, p.vpool + at, ok);
    }
    if constexpr (kQuant) {
      const int c = tid % BKV, j = j0 + c;
      const bool ok = j < ncol;
      const size_t ph =
          ok ? (size_t)resolve_page(p, ln.b, j) * p.nkv + ln.h : 0;
      cp_async4(s0 + 2 * BKV * RB + 4 * tid, (tid < BKV ? p.ksc : p.vsc) + ph,
                ok);
    }
  };
  // the q tile joins the first group; kStages - 1 tiles ahead of the
  // products, one group a tile (empty past the walk's end)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (kt0 + i < kt1) prefetch(kt0 + i, i);
    cp_async_commit();
  }

  const int row0 = r0 + 16 * warp + g, row1 = row0 + 8;
  const int rl0 = ln.row_len(row0), rl1 = ln.row_len(row1);
  // every row of the tile live and seeing at least `full` columns: the
  // first row sees the fewest
  const bool all_live = r0 + BR <= ln.live;
  const int full = ln.row_len(r0);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int it = kt - kt0, j0 = kt * BKV;
    if (kt + kStages - 1 < kt1)
      prefetch(kt + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const uint32_t st = sRing + (it % kStages) * SB;
    const char* gst = gbase + (st - sQ);
    uint32_t sK = st, sV = st + BKV * RB;
    const float* ks_col = reinterpret_cast<const float*>(gst + 2 * BKV * RB);
    const float* vs_col = ks_col + BKV;
    if constexpr (kQuant) {
      __syncthreads();  // every thread's copies of this stage have landed
      // expand the codes to T: 16 raw bytes -> 2 (int8) or 4 (int4)
      // 16-byte chunks of the swizzled tiles
      constexpr int CPR = RB / 16;
      constexpr int OUT = F == ptt::kInt8 ? 2 : 4;
#pragma unroll
      for (int n = 0; n < 2 * BKV * CPR / NT; ++n) {
        const int idx = n * NT + tid;
        const int kv = idx / (BKV * CPR), rem = idx % (BKV * CPR);
        const int c = rem / CPR, k = rem % CPR;
        const uint4 w = *reinterpret_cast<const uint4*>(
            gst + kv * BKV * RB + c * RB + 16 * k);
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        char* dst = gbase + ((kv ? sVx : sKx) - sQ);
#pragma unroll
        for (int u = 0; u < OUT; ++u) {
          uint32_t h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float a, b2;
            if constexpr (F == ptt::kInt8) {
              // byte 8u + 2e and 8u + 2e + 1 of the 16
              const uint32_t wd = words[(8 * u + 2 * e) >> 2];
              const int sh = 8 * ((8 * u + 2 * e) & 3);
              a = (float)(int)(signed char)(wd >> sh);
              b2 = (float)(int)(signed char)(wd >> (sh + 8));
            } else {
              // byte 4u + e holds elements 2 (4u + e) and 2 (4u + e) + 1
              const uint32_t wd = words[u];
              a = ptt::nibble(wd >> (8 * e));
              b2 = ptt::nibble(wd >> (8 * e + 4));
            }
            h[e] = pack2<T>(a, b2);
          }
          *reinterpret_cast<uint4*>(dst + swz<BKV>(c, OUT * k + u)) =
              make_uint4(h[0], h[1], h[2], h[3]);
        }
      }
      sK = sKx;
      sV = sVx;
    }
    fence_proxy_async();
    __syncthreads();

    float s[NS];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = (kc >> 2) * (BR * 128) + (kc & 3) * 32;
      const uint32_t b = (kc >> 2) * (BKV * 128) + (kc & 3) * 32;
      mma_ss<BKV, 0, T>(s, desc_k(sQ + a), desc_k(sK + b), kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // logits (times the k scale of each column's page), masked by each
    // row's own visibility law where it can bite
    const bool plain = all_live && j0 + BKV <= full;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float x = s[i] * p.scale * (kQuant ? ks_col[c] : 1.f);
      s[i] = plain || j0 + c < ((i & 2) ? rl1 : rl0) ? x : kNeg;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < NS / 4; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = m0 > 0.5f * kNeg ? exp2f((m0 - mx0) * kLog2e) : 0.f;
    const float a1 = m1 > 0.5f * kNeg ? exp2f((m1 - mx1) * kLog2e) : 0.f;
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -m0 * kLog2e, nm1 = -m1 * kLog2e;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float e = s[i] > 0.5f * kNeg
                          ? exp2f(fmaf(s[i], kLog2e, (i & 2) ? nm1 : nm0))
                          : 0.f;
      if (i & 2)
        rs1 += e;
      else
        rs0 += e;
      // P V takes p times the v scale of the column's page
      s[i] = kQuant ? e * vs_col[8 * (i >> 2) + 2 * t4 + (i & 1)] : e;
    }
    l0 = a0 * l0 + rs0;  // per-thread partial sums; alpha is the quad's
    l1 = a1 * l1 + rs1;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a1 : a0;

    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      acc_to_a_split<T>(s, kk, ph[kk], pl[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t dvd = desc_mn(sV + kk * 2048, BKV * 128);
      mma_rs<D, 1, T>(o, ph[kk], dvd);
      mma_rs<D, 1, T>(o, pl[kk], dvd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // an empty walk leaves the q tile's copies in flight

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  // this split's partial rows (row - r0 of its slot)
  const size_t prow0 =
      ((size_t)bh * lane_blocks(p.n_tiles, p.max_splits) +
       split_slot(tile, split, p.n_tiles, p.max_splits)) *
          p.prow -
      r0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    const float l = half ? l1 : l0;
    if (row >= r_end) continue;
    if (partial && row < ln.live) {  // raw partials, merged by the combine
      if (t4 == 0) {
        p.pm[prow0 + row] = half ? m1 : m0;
        p.pl[prow0 + row] = l;
      }
      float* acc = p.pacc + (prow0 + row) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<float2*>(acc + 8 * c + 2 * t4) =
            make_float2(o[4 * c + 2 * half], o[4 * c + 2 * half + 1]);
    } else if (!partial || split == 0) {
      // finished rows: acc / l, exactly 0 where l == 0 (rows past qlen)
      const float ls = l == 0.f ? 1.f : l;
      T* dst = ob + ln.row_off(p, row, D);
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(dst + 8 * c + 2 * t4) =
            pack2<T>(o[4 * c + 2 * half] / ls, o[4 * c + 2 * half + 1] / ls);
    }
  }
}

// The split tiles' partials merged in split order as `_flash_combine`:
// out = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - max m) (0 for a
// split that saw nothing of the row).  Grid (b * nkv, row tiles); tiles
// that did not split exit.  Each row's weights over l are computed once
// into shared memory; then every thread merges 4 columns of a row, its
// loads of the splits' partials independent of each other.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    rows_combine_kernel(const RowsTcParams p) {
  __shared__ float wt[kMaxSplits][kBR];
  const Lane ln(p, blockIdx.x);
  const int tile = blockIdx.y, r0 = tile * kBR;
  if (r0 >= ln.live) return;
  const int nr = min(ln.live - r0, kBR);  // the tile's live rows
  const int nkt = (ln.row_len(r0 + nr - 1) + kBKV - 1) / kBKV;
  int per, n;
  rows_split(nkt, p.max_splits, ln.live <= kBR, per, n);
  if (n <= 1) return;
  const size_t lane =
      (size_t)blockIdx.x * lane_blocks(p.n_tiles, p.max_splits);
  size_t at[kMaxSplits];  // partial row 0 of each split's slot
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    at[s] = s < n ? (lane + split_slot(tile, s, p.n_tiles, p.max_splits)) *
                        p.prow
                  : 0;
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    float m[kMaxSplits], m_max = kNeg;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      m[s] = s < n ? p.pm[at[s] + r] : kNeg;
      m_max = fmaxf(m_max, m[s]);
    }
    float w[kMaxSplits], l_tot = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      w[s] = m[s] > 0.5f * kNeg ? expf(m[s] - m_max) : 0.f;
      l_tot += w[s] * (s < n ? p.pl[at[s] + r] : 0.f);
    }
    const float inv = 1.f / (l_tot == 0.f ? 1.f : l_tot);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) wt[s][r] = w[s] * inv;
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < nr * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), d = 4 * (idx % (D / 4));
    float4 a[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      a[s] = s < n ? *reinterpret_cast<const float4*>(
                         p.pacc + (at[s] + r) * D + d)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      const float ws = wt[s][r];
      o.x += ws * a[s].x;
      o.y += ws * a[s].y;
      o.z += ws * a[s].z;
      o.w += ws * a[s].w;
    }
    T* dst = ob + ln.row_off(p, r0 + r, D) + d;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack2<T>(o.x, o.y), pack2<T>(o.z, o.w));
  }
}

template <typename T, int F, int D>
int launch(const RowsTcParams& p, int b, cudaStream_t stream) {
  constexpr size_t smem = rows_smem_bytes<F, D>();
  auto kernel = rows_tc_kernel<T, F, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * p.nkv, lane_blocks(p.n_tiles, p.max_splits));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.max_splits <= 1) return (int)e;
  rows_combine_kernel<T, D>
      <<<dim3(b * p.nkv, p.n_tiles), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch_width(const RowsTcParams& p, int b, int hd, cudaStream_t stream) {
  if (hd == 64) return launch<T, F, 64>(p, b, stream);
  if (hd == 128) return launch<T, F, 128>(p, b, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As ptt_paged_prefill (paged_prefill.cu), for bf16 q (dtype 1) at hd 64 or
// 128 only (anything else returns cudaErrorInvalidValue unlaunched), with
// the split partials: pm, pl [b * nkv, slots, prow] and pacc [b * nkv,
// slots, prow, hd] f32, slots = n_tiles * min(2, max_splits) + max_splits -
// min(2, max_splits) (n_tiles = ceil(T * nh / nkv / 64)), prow = min(64,
// T * nh / nkv), unused when max_splits is 1.  A second launch merges the
// partials when max_splits > 1.  Returns cudaGetLastError().
extern "C" int ptt_paged_prefill_tc(
    const void* q, const void* kpool, const void* vpool, const void* ksc,
    const void* vsc, const void* tables, const void* lens, const void* qlens,
    void* out, void* pm, void* pl, void* pacc, int b, int T, int nh, int nkv,
    int hd, int nbp, int bs, int max_blocks, int max_splits, float scale,
    int dtype, int kv_format, cudaStream_t stream) {
  if (b == 0 || T == 0) return (int)cudaGetLastError();
  if (dtype != ptt::kBF16 || max_splits < 1 || max_splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const int R = T * (nh / nkv);
  RowsTcParams p{q,
                 static_cast<const unsigned char*>(kpool),
                 static_cast<const unsigned char*>(vpool),
                 static_cast<const float*>(ksc),
                 static_cast<const float*>(vsc),
                 static_cast<const int*>(tables),
                 static_cast<const int*>(lens),
                 static_cast<const int*>(qlens),
                 out,
                 static_cast<float*>(pm),
                 static_cast<float*>(pl),
                 static_cast<float*>(pacc),
                 T,
                 nh,
                 nkv,
                 nbp,
                 bs,
                 max_blocks,
                 (R + kBR - 1) / kBR,
                 max_splits,
                 R < kBR ? R : kBR,
                 scale};
  using T16 = __nv_bfloat16;
  if (kv_format == ptt::kInt8)
    return launch_width<T16, ptt::kInt8>(p, b, hd, stream);
  if (kv_format == ptt::kInt4)
    return launch_width<T16, ptt::kInt4>(p, b, hd, stream);
  return launch_width<T16, ptt::kFp>(p, b, hd, stream);
}
