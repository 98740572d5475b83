// Unfused paged decode attention over fp, int8 or packed-int4 KV pools:
// the sequential walk and the split-K walk, for ONE query token per slot
// (q already roped, the new token already in the pool).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_paged_kernel`
// (sequential; grid (slots, kv_heads, pages) with the page axis run in
// order and the online-softmax state in VMEM scratch, finalized on the
// last page) and `_flash_kernel` (split-K; grid (slots, kv_heads, shards,
// pages_per_shard), each shard emitting its raw partial (m, l, acc) for
// the XLA combine `_flash_combine`).  Both dequantize int8 / packed-int4
// pages on read with per-(page, kv head) f32 scales (`_dequant_page`).
// Front door `paged_attention_decode`.
//
// Bound on the H100: memory.  Each (slot, kv head) reads its live K and V
// rows once (2 * len * head_dim * bytes: 1 byte an element for int8, half
// for int4) plus one scale a page; q and the output are small.  ~4 flops
// per K/V element read, far under the ridge, so CUDA-core FMAs keep up.
//
// Design: one templated walk for both (paged.cuh holds the page loads,
// the storage formats and the one-page online-softmax update it shares
// with the fused decode kernels).  Grid (slot, kv_head, shard), head_dim
// threads a block; shard s loops over logical pages [s * P, (s + 1) * P)
// that hold live columns (< seq_lens), so dead pages cost nothing, with
// the next page's tiles copied by cp.async while the current one is
// scored.  The page id resolves as the reference's `_resolve_page`: the
// table column clamps to the table width (j = s * P + p can pass it) and
// the entry to [0, nbp - 1].  Quantized tiles stay codes in shared memory
// (1/2 or 1/4 of the bf16 bytes) and are dequantized in registers as they
// are read; int4 rows are copied whole (64 bytes at head_dim 128) and
// unpacked in registers.
//  - `ptt_paged_decode` (the sequential kernel): S = 1, P = max_blocks;
//    the block finalizes acc / l itself (l == 0, an empty slot, -> 0).
//    The CUDA-core route of the sequential walk: bf16 q at head_dim 64 or
//    128 takes paged_decode_tc.cu (`paged_attention.decode_route`).
//  - `ptt_flash_decode` (split-K): S shards emit partials; an empty shard
//    emits m = -1e30, l = 0, acc = 0; paged.cuh's combine kernel merges
//    them (a second launch).
// Not used here: tensor cores (paged_decode_tc.cu runs the sequential walk
// on them with mma.sync), TMA.
#include "paged.cuh"

namespace {

using namespace ptt;

template <typename T, int F, bool FINAL>
__global__ void paged_walk_kernel(
    const T* __restrict__ q, const unsigned char* __restrict__ kpool,
    const unsigned char* __restrict__ vpool, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out,
    T* __restrict__ out, int nh, int nkv, int hd, int nbp, int bs,
    int max_blocks, int S, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = nh / nkv;
  const int row_bytes = KV<T, F>::row_bytes(hd), ld = row_bytes + kRowPad;
  unsigned char* tiles = smem;                           // [2][2][bs][ld]
  float* qs = reinterpret_cast<float*>(tiles + 4 * bs * ld);  // [rep][hd]
  float* pt = qs + rep * hd;                             // [bs][kMaxRep]
  float* ms = pt + bs * kMaxRep;                         // [rep]
  float* ls = ms + rep;                                  // [rep]
  float* al = ls + rep;                                  // [rep]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int d = threadIdx.x;  // blockDim.x == hd
  const int length = lens[b];
  const size_t page_bytes = (size_t)bs * row_bytes;
  const int j0 = s * P;
  const int j1 = min((s + 1) * P, length > 0 ? (length + bs - 1) / bs : 0);

  auto page_of = [&](int j) {
    const int col = min(j, max_blocks - 1);
    return min(max(tables[(size_t)b * max_blocks + col], 0), nbp - 1);
  };
  auto page_base = [&](int j) {  // byte offset of page j's (page, h) tile
    return ((size_t)page_of(j) * nkv + h) * page_bytes;
  };
  if (j0 < j1) {
    const size_t base = page_base(j0);
    load_page(tiles, tiles + bs * ld, kpool + base, vpool + base, bs,
              row_bytes, ld);
  }
  for (int r = 0; r < rep; ++r)
    qs[r * hd + d] = to_f32(q[((size_t)b * nh + (size_t)h * rep + r) * hd + d]);
  if (d < rep) {
    ms[d] = kNegInf;
    ls[d] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    const unsigned char* kt = tiles + (size_t)buf * 2 * bs * ld;
    const unsigned char* vt = kt + bs * ld;
    if (j + 1 < j1) {  // prefetch the next page into the other buffer
      unsigned char* kn = tiles + (size_t)(buf ^ 1) * 2 * bs * ld;
      const size_t base = page_base(j + 1);
      load_page(kn, kn + bs * ld, kpool + base, vpool + base, bs, row_bytes,
                ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j's tiles (and, at j0, qs/ms/ls) are visible
    float ks = 1.f, vs = 1.f;
    if constexpr (F != kFp) {
      const size_t sidx = (size_t)page_of(j) * nkv + h;
      ks = ksc[sidx];
      vs = vsc[sidx];
    }
    page_update<T, F>(kt, vt, ld, ks, vs, qs, pt, ms, ls, al, acc, rep, hd,
                      min(bs, length - j * bs), scale);
  }
  __syncthreads();  // ms/ls of an empty walk are set before they are read

  if constexpr (FINAL) {
    for (int r = 0; r < rep; ++r) {
      const float l = ls[r];
      out[((size_t)b * nh + (size_t)h * rep + r) * hd + d] =
          from_f32<T>(acc[r] / (l == 0.f ? 1.f : l));
    }
  } else {
    const size_t part = (((size_t)b * nkv + h) * S + s) * rep;
    for (int r = 0; r < rep; ++r) acc_out[(part + r) * hd + d] = acc[r];
    if (d < rep) {
      m_out[part + d] = ms[d];
      l_out[part + d] = ls[d];
    }
  }
}

template <typename T, int F>
int launch(const void* q, const void* kpool, const void* vpool,
           const float* ksc, const float* vsc, const int* tables,
           const int* lens, float* m, float* l, float* acc, void* out, int b,
           int nh, int nkv, int hd, int nbp, int bs, int max_blocks, int S,
           int P, float scale, cudaStream_t stream) {
  const int rep = nh / nkv;
  const int ld = KV<T, F>::row_bytes(hd) + kRowPad;
  const size_t smem = walk_smem(bs, ld, rep, hd);
  const bool final_ = S == 1;  // the sequential walk finalizes in-kernel
  auto kernel = final_ ? paged_walk_kernel<T, F, true>
                       : paged_walk_kernel<T, F, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(b, nkv, S), hd, smem, stream>>>(
      (const T*)q, (const unsigned char*)kpool, (const unsigned char*)vpool,
      ksc, vsc, tables, lens, m, l, acc, (T*)out, nh, nkv, hd, nbp, bs,
      max_blocks, S, P, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || final_) return (int)e;
  combine_kernel<T><<<dim3(b, nkv), hd, 0, stream>>>(m, l, acc, (T*)out, nkv,
                                                     rep, hd, S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_format(int kv_format, const void* q, const void* kpool,
                  const void* vpool, const float* ksc, const float* vsc,
                  const int* tables, const int* lens, float* m, float* l,
                  float* acc, void* out, int b, int nh, int nkv, int hd,
                  int nbp, int bs, int max_blocks, int S, int P, float scale,
                  cudaStream_t stream) {
  auto fn = kv_format == kInt8   ? launch<T, kInt8>
            : kv_format == kInt4 ? launch<T, kInt4>
                                 : launch<T, kFp>;
  return fn(q, kpool, vpool, ksc, vsc, tables, lens, m, l, acc, out, b, nh,
            nkv, hd, nbp, bs, max_blocks, S, P, scale, stream);
}

int dispatch(const void* q, const void* kpool, const void* vpool,
             const void* ksc, const void* vsc, const void* tables,
             const void* lens, void* m, void* l, void* acc, void* out, int b,
             int nh, int nkv, int hd, int nbp, int bs, int max_blocks, int S,
             int P, float scale, int dtype, int kv_format,
             cudaStream_t stream) {
  if (b == 0) return (int)cudaGetLastError();
  auto fn = dtype == kBF16 ? launch_format<__nv_bfloat16> : launch_format<float>;
  return fn(kv_format, q, kpool, vpool, (const float*)ksc, (const float*)vsc,
            (const int*)tables, (const int*)lens, (float*)m, (float*)l,
            (float*)acc, out, b, nh, nkv, hd, nbp, bs, max_blocks, S, P, scale,
            stream);
}

}  // namespace

// The sequential kernel.  q [b, nh, hd] (roped); pools [nbp, nkv, bs,
// hd_store] of the q dtype (kv_format 0), int8 codes (1) or packed int4
// (2, hd_store = hd / 2); scales ksc, vsc [nbp, nkv] f32 (quantized pools
// only, else unused); tables [b, max_blocks], lens [b] int32; out [b, nh,
// hd].  hd a multiple of 32 up to 1024, nh / nkv <= 8 (the wrapper
// checks).  Returns cudaGetLastError().
extern "C" int ptt_paged_decode(const void* q, const void* kpool,
                                const void* vpool, const void* ksc,
                                const void* vsc, const void* tables,
                                const void* lens, void* out, int b, int nh,
                                int nkv, int hd, int nbp, int bs,
                                int max_blocks, float scale, int dtype,
                                int kv_format, cudaStream_t stream) {
  return dispatch(q, kpool, vpool, ksc, vsc, tables, lens, nullptr, nullptr,
                  nullptr, out, b, nh, nkv, hd, nbp, bs, max_blocks, 1,
                  max_blocks, scale, dtype, kv_format, stream);
}

// The split-K kernel and its combine: as above, with S > 1 shards of P
// pages and the f32 partials m, l [b, nkv, S, rep], acc [b, nkv, S, rep,
// hd] as scratch.
extern "C" int ptt_flash_decode(const void* q, const void* kpool,
                                const void* vpool, const void* ksc,
                                const void* vsc, const void* tables,
                                const void* lens, void* m, void* l, void* acc,
                                void* out, int b, int nh, int nkv, int hd,
                                int nbp, int bs, int max_blocks, int S, int P,
                                float scale, int dtype, int kv_format,
                                cudaStream_t stream) {
  return dispatch(q, kpool, vpool, ksc, vsc, tables, lens, m, l, acc, out, b,
                  nh, nkv, hd, nbp, bs, max_blocks, S, P, scale, dtype,
                  kv_format, stream);
}
