// Fused decode step over int8 / packed-int4 KV pools: rope(q, k) + the
// REQUANTIZED KV-page append + split-K dequant-on-read paged attention for
// ONE decode token per slot, one launch per layer (plus the combine).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py
// `_fused_quant_decode_kernel` (front door `fused_quant_decode_step`).  On
// the TPU its grid was (slots, kv_heads, shards, pages_per_shard): each
// walked page dequantized in VMEM, and at the write page the page was
// dequantized with its OLD scale, the roped k row (raw v row) inserted,
// the per-page scale recomputed, the page requantized
// (`_quant_encode_page`) and codes and scale committed through aliased
// outputs pinned to the write page; attention at the write page read the
// requantize -> dequantize round trip.
//
// Bound on the H100: memory.  Each (slot, kv head) reads its live K and V
// codes once (1 byte an element for int8, half for int4) plus a scale a
// page, and rewrites one page of codes and one scale per pool; q, the new
// rows and the f32 partials are small.
//
// Design: fused_decode.cu's walk (grid (slot, kv_head, shard), head_dim
// threads, cp.async double-buffered code tiles, the online softmax of
// paged.cuh's `page_update`, its rope and its combine) with paged.cuh's
// quantized tiles.  On the write page (j == lens / bs, always the last live
// page, so exactly one block per (slot, head) gets there):
//  - a writeable lane runs `requant_page` on its K and V tiles: dequantize
//    with the old scale, insert the row (roped in the input dtype, as
//    apply_rotary_pos_emb; v raw), absmax over all bs rows (stale rows of a
//    reused page included, as the reference), scale = absmax * (1 / bound)
//    as the reference's compiled programs compute it, codes by rintf (half
//    to even) of a correctly rounded division, clipped.  It
//    commits the whole page of codes to pool page `wblk` and the new scale
//    in place, and keeps the new codes in its tile, so attention reads the
//    round trip.  The rope is the plain version's (paged.cuh
//    `rope_elem`), no FMA contraction reaches the encode (round-to-nearest
//    intrinsics), and no fast math is used, so the codes and scales equal
//    the plain composition's bit for bit;
//  - a lane with wable == 0 writes ZERO codes over page `wblk` (the spill
//    page) and a zero scale; its attention reads the old tile with the old
//    scale (the reference's `k_deq` branch).  Several dropped lanes write
//    the same zeros, and inactive lanes may read the spill page meanwhile:
//    only discarded outputs depend on that order, never the pools.
// Each live lane's write page is its own (the allocator's invariant), so no
// other block reads or writes it during the launch.
// The CUDA-core route (`paged_attention.decode_route` "cc"): f32 q, and
// head dims other than 64 and 128.  bf16 q at head_dim 64 or 128 takes
// the tensor-core fused_decode_tc.cu, which pads the head group to one
// m16 tile of mma.sync and merges the shards inside its launch.
#include "paged.cuh"

namespace {

using namespace ptt;

template <typename T, int F>
__global__ void fused_quant_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const T* __restrict__ cos,
    const T* __restrict__ sin, unsigned char* __restrict__ kpool,
    unsigned char* __restrict__ vpool, float* __restrict__ ksc,
    float* __restrict__ vsc, const int* __restrict__ tables,
    const int* __restrict__ lens, const int* __restrict__ wblk,
    const int* __restrict__ wable, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int nh, int nkv,
    int hd, int nbp, int bs, int max_blocks, int S, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = nh / nkv;
  const int row_bytes = KV<T, F>::row_bytes(hd), ld = row_bytes + kRowPad;
  unsigned char* tiles = smem;                           // [2][2][bs][ld]
  float* qs = reinterpret_cast<float*>(tiles + 4 * bs * ld);  // [rep][hd]
  float* pt = qs + rep * hd;                             // [bs][kMaxRep]
  float* ms = pt + bs * kMaxRep;                         // [rep]
  float* ls = ms + rep;                                  // [rep]
  float* al = ls + rep;                                  // [rep]
  float* red = al + rep;                                 // [32]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int d = threadIdx.x;  // blockDim.x == hd
  const int half = hd / 2;
  const int len_pre = lens[b];
  const int length = len_pre + 1;  // the appended token included
  const bool on = wable[b] == 1;
  const int wpage = len_pre / bs, wrow = len_pre % bs;
  const int wb = min(max(wblk[b], 0), nbp - 1);
  const size_t page_bytes = (size_t)bs * row_bytes;
  const int j0 = s * P;
  const int j1 = min((s + 1) * P, (length + bs - 1) / bs);  // live pages

  auto page_of = [&](int j) {
    const int col = min(j, max_blocks - 1);
    return min(max(tables[(size_t)b * max_blocks + col], 0), nbp - 1);
  };
  if (j0 < j1) {
    const size_t base = ((size_t)page_of(j0) * nkv + h) * page_bytes;
    load_page(tiles, tiles + bs * ld, kpool + base, vpool + base, bs,
              row_bytes, ld);
  }

  const float c = to_f32(cos[(size_t)b * hd + d]);
  const float sn = to_f32(sin[(size_t)b * hd + d]);
  for (int r = 0; r < rep; ++r) {
    const T* qrow = q + ((size_t)b * nh + (size_t)h * rep + r) * hd;
    qs[r * hd + d] = rope_elem(qrow, d, half, c, sn);
  }
  if (d < rep) {
    ms[d] = kNegInf;
    ls[d] = 0.f;
  }
  const size_t row_off = ((size_t)b * nkv + h) * hd;
  // the inserted rows as the reference's `rows.astype(f32)`: k roped in
  // the input dtype, v raw
  const float k_ins = rope_elem(k_new + row_off, d, half, c, sn);
  const float v_ins = to_f32(v_new[row_off + d]);
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    unsigned char* kt = tiles + (size_t)buf * 2 * bs * ld;
    unsigned char* vt = kt + bs * ld;
    const int page = page_of(j);
    if (j + 1 < j1) {  // prefetch the next page into the other buffer
      unsigned char* kn = tiles + (size_t)(buf ^ 1) * 2 * bs * ld;
      const size_t base = ((size_t)page_of(j + 1) * nkv + h) * page_bytes;
      load_page(kn, kn + bs * ld, kpool + base, vpool + base, bs, row_bytes,
                ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j's tiles (and, at j0, qs/ms/ls) are visible
    float ks = ksc[(size_t)page * nkv + h];
    float vs = vsc[(size_t)page * nkv + h];
    if (j == wpage) {
      const size_t widx = (size_t)wb * nkv + h;
      if (on) {
        // requant_page's barriers order these reads of the old scales
        // before thread 0 writes the new ones
        ks = requant_page<F>(kt, ld, ks, wrow, k_ins, kpool + widx * page_bytes,
                             bs, hd, red);
        vs = requant_page<F>(vt, ld, vs, wrow, v_ins, vpool + widx * page_bytes,
                             bs, hd, red);
        if (d == 0) {
          ksc[widx] = ks;
          vsc[widx] = vs;
        }
      } else {
        __syncthreads();  // every thread has read the old scales
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        uint4* kz = reinterpret_cast<uint4*>(kpool + widx * page_bytes);
        uint4* vz = reinterpret_cast<uint4*>(vpool + widx * page_bytes);
        const int nvec = (int)(page_bytes / 16);
        for (int i = d; i < nvec; i += blockDim.x) {
          kz[i] = zero;
          vz[i] = zero;
        }
        if (d == 0) {
          ksc[widx] = 0.f;
          vsc[widx] = 0.f;
        }
      }
    }
    page_update<T, F>(kt, vt, ld, ks, vs, qs, pt, ms, ls, al, acc, rep, hd,
                      min(bs, length - j * bs), scale);
  }
  __syncthreads();  // ms/ls of an empty shard are set before the emit

  const size_t part = (((size_t)b * nkv + h) * S + s) * rep;
  for (int r = 0; r < rep; ++r) acc_out[(part + r) * hd + d] = acc[r];
  if (d < rep) {
    m_out[part + d] = ms[d];
    l_out[part + d] = ls[d];
  }
}

template <typename T, int F>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* cos, const void* sin, void* kpool, void* vpool,
           float* ksc, float* vsc, const int* tables, const int* lens,
           const int* wblk, const int* wable, float* m, float* l, float* acc,
           void* out, int b, int nh, int nkv, int hd, int nbp, int bs,
           int max_blocks, int S, int P, float scale, cudaStream_t stream) {
  const int rep = nh / nkv;
  const size_t smem = walk_smem(bs, KV<T, F>::row_bytes(hd) + kRowPad, rep, hd);
  auto kernel = fused_quant_decode_kernel<T, F>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(b, nkv, S), hd, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (const T*)cos,
      (const T*)sin, (unsigned char*)kpool, (unsigned char*)vpool, ksc, vsc,
      tables, lens, wblk, wable, m, l, acc, nh, nkv, hd, nbp, bs, max_blocks,
      S, P, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<T><<<dim3(b, nkv), hd, 0, stream>>>(m, l, acc, (T*)out, nkv,
                                                     rep, hd, S);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, nh, hd]; k_new, v_new [b, nkv, hd]; cos, sin [b, hd]; code pools
// [nbp, nkv, bs, hd] int8 (kv_format 1) or [nbp, nkv, bs, hd / 2] packed
// int4 (2), and scales ksc, vsc [nbp, nkv] f32, all updated in place;
// tables [b, max_blocks], lens, wblk, wable [b] int32; partials m, l
// [b, nkv, S, rep], acc [b, nkv, S, rep, hd] f32 scratch; out [b, nh, hd].
// hd a multiple of 32 up to 1024, nh / nkv <= 8 (the wrapper checks).
// Returns cudaGetLastError().
extern "C" int ptt_fused_quant_decode(
    const void* q, const void* k_new, const void* v_new, const void* cos,
    const void* sin, void* kpool, void* vpool, void* ksc, void* vsc,
    const void* tables, const void* lens, const void* wblk,
    const void* wable, void* m, void* l, void* acc, void* out, int b, int nh,
    int nkv, int hd, int nbp, int bs, int max_blocks, int S, int P,
    float scale, int dtype, int kv_format, cudaStream_t stream) {
  if (b == 0) return (int)cudaGetLastError();
  const bool bf = dtype == kBF16, i4 = kv_format == kInt4;
  auto fn = bf ? (i4 ? launch<__nv_bfloat16, kInt4> : launch<__nv_bfloat16, kInt8>)
               : (i4 ? launch<float, kInt4> : launch<float, kInt8>);
  return fn(q, k_new, v_new, cos, sin, kpool, vpool, (float*)ksc, (float*)vsc,
            (const int*)tables, (const int*)lens, (const int*)wblk,
            (const int*)wable, (float*)m, (float*)l, (float*)acc, out, b, nh,
            nkv, hd, nbp, bs, max_blocks, S, P, scale, stream);
}
