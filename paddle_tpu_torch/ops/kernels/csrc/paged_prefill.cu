// Ragged multi-row paged attention over fp, int8 or packed-int4 KV pools:
// the chunked-prefill rows of the mixed step and the K+1 rows of the
// speculative verify step, each row under its own causal law.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_prefill_kernel`
// (B9; fp / int8 / int4 pools dequantized on read) and `_verify_kernel`
// (B10; fp pools, the T = K+1 case of B9).  On the TPU both ran the decode
// kernel's grid (slots, kv_heads, pages) with the page axis in order and
// the WHOLE q tile of the slot and kv head, R = pad8(T * rep) rows (row
// t * rep + g = query token t, grouped head g), in VMEM, with m, l, acc
// carried in scratch from page to page.  Row t sits at position
// len - qlen + t and sees row_len = len - (qlen - 1 - t) KV positions
// (0 for rows at or past qlen, which finalize to zeros).  Front doors
// `paged_attention_prefill` / `paged_attention_verify`.
//
// Bound on the H100: the score and PV products do 4 * hd flops per
// visible (row, column) pair and q head.  A 128-row chunk reuses each K/V
// column for 512 row-heads (~500 flops a byte), a decode lane for 4: the
// mixed step's mix (chip_smoke.py) does ~200 flops per byte of live K/V,
// under the bf16 ridge, so bytes bound it (0.013 ms at Llama-3-8B widths
// against 0.0065 ms of operations).
//
// Design (a first, simple kernel on the CUDA cores in f32):
//  - R rows do not fit a block's registers or shared memory (512 rows x
//    128 f32 at chunk 128, rep 4), so the rows are tiled: grid (slot x kv
//    head, row tiles of 64 rows), heaviest tiles (the last rows, which see
//    the most) first, 256 threads; the TPU's sequential page axis becomes a
//    loop inside the block over 64-column KV tiles;
//  - a tile walks KV columns only up to the row_len of its last live row
//    (the causal skip) and reads each K/V column once; a tile whose rows
//    are all at or past qlen (most of a mixed step's B x T rows are
//    padding) writes zeros and exits;
//  - each KV column resolves its own page through the block table with
//    the reference's `_resolve_page` clamps (table column to the table
//    width, page id to the pool), so any block size works; quantized
//    columns are dequantized as they are staged (paged.cuh's storage
//    formats: code (f32) times the page's scale, one rounding), so the
//    tiles are f32 in shared memory and the inner loops are format-free; a
//    thread issues all of its staging loads before it converts any (a
//    chain of dependent loads a column made a long lane latency-bound);
//  - the score and PV loops are the flash forward kernel's (flash.cuh):
//    each thread owns 4 rows x 4 columns of the logits tile and the same 4
//    rows x head_dim / 16 columns of the accumulator; row max and sum are
//    half-warp shuffles; masked logits give exactly 0 (`safe_exp`);
//  - a warp whose 8 rows are all dead (a decode lane's tile holds 4 live
//    rows of 64, a verify tile 20) skips the score and PV loops: it only
//    stages K/V columns and meets the barriers, so a long decode lane's
//    walk costs the loads and one warp's products, not 64 rows';
//  - finalize: acc / l, l == 0 -> exact zeros.
// Not yet used: tensor cores, TMA / cp.async double buffering of the page
// columns, a split over the KV axis for the few long rows of decode lanes.
#include "flash.cuh"
#include "paged.cuh"

namespace {

using ptt::KV;
using ptt::flash::axpy4;
using ptt::flash::dot4;
using ptt::flash::half_warp_max;
using ptt::flash::half_warp_sum;
using ptt::flash::kBQ;
using ptt::flash::kNegInf;
using ptt::flash::ld4;
using ptt::flash::safe_exp;
using ptt::flash::store4;

struct RowsParams {
  const void* q;          // [b, T, nh, hd]
  const unsigned char* kpool;
  const unsigned char* vpool;
  const float* ksc;       // [nbp, nkv] (quantized pools)
  const float* vsc;
  const int* tables;      // [b, max_blocks]
  const int* lens;        // [b] total written length incl. the rows
  const int* qlens;       // [b] live rows
  void* out;              // [b, T, nh, hd]
  int T, nh, nkv, hd, nbp, bs, max_blocks;
  float scale;
};

// Columns [j0, j0 + BKV) of one kv head's K or V as f32 rows of dst
// ([BKV][ld]); columns at or past ncol read as zeros.  Each column
// resolves its page as `_resolve_page`.  A thread stages at most kPer
// 4-element groups (BKV * hd / 4 <= 8 * 256) and issues all of its loads
// before it converts any, so they are in flight together.
template <typename T, int F, int BKV>
__device__ __forceinline__ void load_cols(float* dst, int ld,
                                          const unsigned char* pool,
                                          const float* sc,
                                          const RowsParams& p, int b, int h,
                                          int j0, int ncol) {
  constexpr int kPer = 8;
  const int row_bytes = KV<T, F>::row_bytes(p.hd);
  const int g4 = p.hd / 4, total = BKV * g4;
  const unsigned char* src[kPer];
  float s[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    const int c = idx / g4, j = j0 + c;
    src[k] = nullptr;
    s[k] = 1.f;
    if (idx < total && j < ncol) {
      const int col = min(j / p.bs, p.max_blocks - 1);
      const int page =
          min(max(p.tables[(size_t)b * p.max_blocks + col], 0), p.nbp - 1);
      const size_t ph = (size_t)page * p.nkv + h;
      if constexpr (F != ptt::kFp) s[k] = sc[ph];
      src[k] = pool + (ph * p.bs + (size_t)(j % p.bs)) * row_bytes;
    }
  }
  float v[kPer][4];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = ((threadIdx.x + k * blockDim.x) % g4) * 4;
    v[k][0] = v[k][1] = v[k][2] = v[k][3] = 0.f;
    if (src[k] != nullptr) KV<T, F>::load4(src[k], e, s[k], v[k]);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    if (idx < total) {
      const int c = idx / g4, e = (idx - c * g4) * 4;
      *reinterpret_cast<float4*>(dst + c * ld + e) =
          make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
    }
  }
}

template <typename T, int F, int BKV, int DCH>
__global__ void __launch_bounds__(256) rows_kernel(const RowsParams p) {
  constexpr int CC = BKV / 16;  // kv columns per thread
  constexpr int PT = kBQ + 4;   // row stride of the staged probabilities
  extern __shared__ float4 smem4[];
  const int d = p.hd, DP = d + 4, nc4 = d / 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;                    // [BKV][DP]
  float* Vs = Ks + BKV * DP;                    // [BKV][DP]
  float* Pt = Vs + BKV * DP;                    // [BKV][PT], transposed p
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / p.nkv, h = blockIdx.x % p.nkv;
  const int rep = p.nh / p.nkv, R = p.T * rep;
  // heaviest (last) row tiles first: they see the most columns
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int len = p.lens[b], qlen = min(p.qlens[b], p.T);
  const T* qb = static_cast<const T*>(p.q);
  T* ob = static_cast<T*>(p.out);
  // row r of this (slot, kv head) is q[b, r / rep, h * rep + r % rep]
  auto row_off = [&](int r) {
    return (((size_t)b * p.T + r / rep) * p.nh + (size_t)h * rep + r % rep) *
           d;
  };
  // visible columns of row r, clamped to the table's reach as the
  // reference's gather of max_blocks pages clamps them
  const int S = p.max_blocks * p.bs;
  auto row_len = [&](int r) {
    const int t = r / rep;
    return r < R && t < qlen ? min(len - (qlen - 1 - t), S) : 0;
  };
  const int r_end = min(r0 + kBQ, R);
  if (r0 / rep >= qlen) {  // every row of the tile is padding: zeros
    for (int idx = tid; idx < (r_end - r0) * nc4; idx += blockDim.x) {
      const int r = r0 + idx / nc4, c = (idx % nc4) * 4;
      store4<T>(ob + row_off(r) + c, make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  // the tile's widest row: its last live one
  const int ncol = row_len(min(r_end, qlen * rep) - 1);

  for (int idx = tid; idx < kBQ * nc4; idx += blockDim.x) {
    const int r = idx / nc4, c = (idx - r * nc4) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row_len(r0 + r) > 0) ptt::load4(qb + row_off(r0 + r) + c, v);
    *reinterpret_cast<float4*>(Qs + r * DP + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  // a row's visible length grows with t up to the last live row, so warp
  // w (rows 8w .. 8w + 7) computes iff the last of its rows below
  // qlen * rep sees something: a warp-uniform test, as the half-warp
  // shuffles need
  const int w_first = r0 + (tid >> 5) * 8;
  const int w_last = min(w_first + 7, min(qlen * rep, R) - 1);
  const bool warp_live = w_last >= w_first && row_len(w_last) > 0;
  int rl[4];
  float m[4], l[4];
  float4 acc[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rl[r] = row_len(r0 + ty * 4 + r);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < DCH; ++k) acc[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j0 = 0; j0 < ncol; j0 += BKV) {
    __syncthreads();  // the previous tile's loops are done with Ks, Vs
    load_cols<T, F, BKV>(Ks, DP, p.kpool, p.ksc, p, b, h, j0, ncol);
    load_cols<T, F, BKV>(Vs, DP, p.vpool, p.vsc, p, b, h, j0, ncol);
    __syncthreads();
    if (!warp_live) continue;

    float s[4][CC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < nc4; ++c4) {
      float4 qv[4], kv[CC];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = ld4(Qs + (ty * 4 + r) * DP + c4 * 4);
#pragma unroll
      for (int c = 0; c < CC; ++c) kv[c] = ld4(Ks + (tx + 16 * c) * DP + c4 * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CC; ++c) s[r][c] = dot4(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        // the per-row causal law: column j visible iff j < row_len
        s[r][c] = j0 + tx + 16 * c < rl[r] ? s[r][c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = half_warp_max(mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        s[r][c] = safe_exp(s[r][c], m_new);
        rs += s[r][c];
      }
      rs = half_warp_sum(rs);
      const float alpha = safe_exp(m[r], m_new);
      l[r] = alpha * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int k = 0; k < DCH; ++k) {
        acc[r][k].x *= alpha;
        acc[r][k].y *= alpha;
        acc[r][k].z *= alpha;
        acc[r][k].w *= alpha;
      }
    }
    // a row's probabilities are written and read by the 16 lanes that own
    // the row (one half-warp), so the warp's own barrier orders them
#pragma unroll
    for (int c = 0; c < CC; ++c)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * c) * PT + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncwarp();

    const int jn = min(BKV, ncol - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 pv = ld4(Pt + jj * PT + ty * 4);
#pragma unroll
      for (int k = 0; k < DCH; ++k) {
        const int ch = tx + 16 * k;
        if (ch < nc4) {
          const float4 vv = ld4(Vs + jj * DP + ch * 4);
          axpy4(acc[0][k], pv.x, vv);
          axpy4(acc[1][k], pv.y, vv);
          axpy4(acc[2][k], pv.z, vv);
          axpy4(acc[3][k], pv.w, vv);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty * 4 + r;
    if (row >= R) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int ch = tx + 16 * k;
      if (ch < nc4) {
        const float4 a = acc[r][k];
        store4<T>(ob + row_off(row) + ch * 4,
                  make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls));
      }
    }
  }
}

template <typename T, int F, int BKV, int DCH>
int launch(const RowsParams& p, int b, cudaStream_t stream) {
  const size_t DP = p.hd + 4;
  const size_t smem =
      (kBQ * DP + 2 * BKV * DP + BKV * (size_t)(kBQ + 4)) * sizeof(float);
  auto kernel = rows_kernel<T, F, BKV, DCH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int R = p.T * (p.nh / p.nkv);
  const dim3 grid(b * p.nkv, (R + kBQ - 1) / kBQ);
  kernel<<<grid, 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch_width(const RowsParams& p, int b, cudaStream_t stream) {
  return p.hd <= 128 ? launch<T, F, 64, 2>(p, b, stream)
                     : launch<T, F, 32, 4>(p, b, stream);
}

int dispatch(const void* q, const void* kpool, const void* vpool,
             const void* ksc, const void* vsc, const void* tables,
             const void* lens, const void* qlens, void* out, int b, int T,
             int nh, int nkv, int hd, int nbp, int bs, int max_blocks,
             float scale, int dtype, int kv_format, cudaStream_t stream) {
  if (b == 0 || T == 0) return (int)cudaGetLastError();
  RowsParams p{q,
               static_cast<const unsigned char*>(kpool),
               static_cast<const unsigned char*>(vpool),
               static_cast<const float*>(ksc),
               static_cast<const float*>(vsc),
               static_cast<const int*>(tables),
               static_cast<const int*>(lens),
               static_cast<const int*>(qlens),
               out, T, nh, nkv, hd, nbp, bs, max_blocks, scale};
  using ptt::kInt4;
  using ptt::kInt8;
  using ptt::kFp;
  if (dtype == ptt::kBF16) {
    using T16 = __nv_bfloat16;
    return kv_format == kInt8   ? launch_width<T16, kInt8>(p, b, stream)
           : kv_format == kInt4 ? launch_width<T16, kInt4>(p, b, stream)
                                : launch_width<T16, kFp>(p, b, stream);
  }
  return kv_format == kInt8   ? launch_width<float, kInt8>(p, b, stream)
         : kv_format == kInt4 ? launch_width<float, kInt4>(p, b, stream)
                              : launch_width<float, kFp>(p, b, stream);
}

}  // namespace

// B9, the chunked-prefill rows, and B10, the speculative verify rows (fp
// pools, T = K+1: the same walk).  q [b, T, nh, hd] (roped); pools [nbp,
// nkv, bs, hd_store] of the q dtype (kv_format 0), int8 codes (1) or
// packed int4 (2, hd_store = hd / 2); scales ksc, vsc [nbp, nkv] f32
// (quantized pools only, else unused); tables [b, max_blocks], lens [b]
// (total written length incl. the rows), qlens [b] (live rows) int32; out
// like q.  hd a multiple of 32 up to 256, nh % nkv == 0 (the wrapper
// checks).  Returns cudaGetLastError().
extern "C" int ptt_paged_prefill(const void* q, const void* kpool,
                                 const void* vpool, const void* ksc,
                                 const void* vsc, const void* tables,
                                 const void* lens, const void* qlens,
                                 void* out, int b, int T, int nh, int nkv,
                                 int hd, int nbp, int bs, int max_blocks,
                                 float scale, int dtype, int kv_format,
                                 cudaStream_t stream) {
  return dispatch(q, kpool, vpool, ksc, vsc, tables, lens, qlens, out, b, T,
                  nh, nkv, hd, nbp, bs, max_blocks, scale, dtype, kv_format,
                  stream);
}
