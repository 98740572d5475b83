// Fused decode step: rope(q, k) + KV-page append + split-K paged attention
// for ONE decode token per slot, one launch per layer.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_fused_decode_kernel`
// (front door `fused_decode_step`).  On the TPU its grid was (slots,
// kv_heads, shards, pages_per_shard) with the page axis run in order, a page
// tile DMA'd into VMEM per grid step and the online-softmax state carried
// in VMEM scratch from step to step; the split-K partials were merged by an
// XLA combine (`_flash_combine`).
//
// Bound on the H100: memory.  Each (slot, kv head) reads its live K and V
// pages once (2 * live_tokens * head_dim * bytes) and writes one row per
// pool; q, the new rows and the f32 partials are small.  The arithmetic is
// ~4 flops per K/V element read, two orders of magnitude under the
// tensor-core ridge, so CUDA-core FMAs keep up.
//
// Design: grid (slot, kv_head, shard), head_dim threads a block.  Blocks run
// in parallel in no order, so the TPU's sequential page axis becomes a loop
// inside the block over the shard's pages, with the online-softmax state
// (m, l in shared memory, each thread's head_dim column of acc in
// registers) living for the block's lifetime.  Each block:
//  - ropes its q head group and the new k row in the INPUT dtype, rounding
//    after every multiply and add exactly as apply_rotary_pos_emb does in
//    PyTorch (the fused step must feed the score dot the same values the
//    unfused composition reads); the roped k is rounded through the pool
//    dtype before the dot;
//  - walks pages j of its shard while j * bs < lens + 1 (pages past the
//    live count are never read).  The page id resolves as the reference's
//    `_fused_walk_page`: the table column clamps to the table width and the
//    entry clips to [0, nbp - 1], so a sentinel entry reads the SPILL page;
//  - double-buffers the page tiles: while it scores page j, cp.async copies
//    page j + 1's K and V (16-byte chunks) into the other buffer.  Tile rows
//    are padded by 16 bytes so the score loop's 8-byte bf16 row reads from
//    the 8 rows of a half-warp hit 8 different bank groups;
//  - on the write page (j == lens / bs): a writeable lane inserts the roped
//    k row and the raw v row into its tiles BEFORE the score dot and
//    commits that row to the pool page `wblk` in place; a lane with
//    wable == 0 writes ZEROS over page `wblk` (the spill page) for its
//    head instead, so the spill page never holds uninitialised bits.
//    Several dropped lanes write the same zeros to the spill page, and
//    other dropped lanes may read it meanwhile: a benign race, since every
//    writer writes zeros and a dropped lane's output is discarded;
//  - scores only the live columns (< lens + 1) of each page (paged.cuh's
//    `page_update`, shared with the unfused and the quantized decode):
//    two adjacent lanes share one column, each summing half of head_dim
//    for every row of the head group, one shuffle to finish;
//  - emits its raw partial (m, l, acc); an empty shard emits m = -1e30,
//    l = 0, acc = 0.
// A second small kernel merges the S partials of each (slot, kv head) with
// the exact log-sum-exp of `_flash_combine` and writes the output in the
// input dtype.
// The CUDA-core route (`paged_attention.decode_route` "cc"): f32 q, and
// head dims other than 64 and 128.  bf16 q at head_dim 64 or 128 takes
// the tensor-core fused_decode_tc.cu, which pads the head group to one
// m16 tile of mma.sync and merges the shards inside its launch.
#include "paged.cuh"

namespace {

using namespace ptt;

template <typename T>
__global__ void fused_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const T* __restrict__ cos,
    const T* __restrict__ sin, T* __restrict__ kpool, T* __restrict__ vpool,
    const int* __restrict__ tables, const int* __restrict__ lens,
    const int* __restrict__ wblk, const int* __restrict__ wable,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int nh, int nkv, int hd, int nbp, int bs,
    int max_blocks, int S, int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = nh / nkv;
  const int row_bytes = hd * (int)sizeof(T), ld = row_bytes + kRowPad;
  unsigned char* tiles = smem;                           // [2][2][bs][ld]
  float* qs = reinterpret_cast<float*>(tiles + 4 * bs * ld);  // [rep][hd]
  float* pt = qs + rep * hd;                             // [bs][kMaxRep]
  float* ms = pt + bs * kMaxRep;                         // [rep]
  float* ls = ms + rep;                                  // [rep]
  float* al = ls + rep;                                  // [rep]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int d = threadIdx.x;  // blockDim.x == hd
  const int half = hd / 2;
  const int len_pre = lens[b];
  const int length = len_pre + 1;  // the appended token included
  const bool on = wable[b] == 1;
  const int wpage = len_pre / bs, wrow = len_pre % bs;
  const int wb = min(max(wblk[b], 0), nbp - 1);
  const size_t page_elems = (size_t)bs * hd;
  const int j0 = s * P;
  const int j1 = min((s + 1) * P, (length + bs - 1) / bs);  // live pages
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(kpool);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(vpool);

  auto page_base = [&](int j) {  // byte offset of page j's (page, h) tile
    const int col = min(j, max_blocks - 1);
    const int page = min(max(tables[(size_t)b * max_blocks + col], 0), nbp - 1);
    return ((size_t)page * nkv + h) * page_elems * sizeof(T);
  };
  if (j0 < j1) {
    const size_t base = page_base(j0);
    load_page(tiles, tiles + bs * ld, kp + base, vp + base, bs, row_bytes, ld);
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
  const T k_roped = from_f32<T>(rope_elem(k_new + row_off, d, half, c, sn));
  const T v_raw = v_new[row_off + d];
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    unsigned char* kt = tiles + (size_t)buf * 2 * bs * ld;
    unsigned char* vt = kt + bs * ld;
    if (j + 1 < j1) {  // prefetch the next page into the other buffer
      unsigned char* kn = tiles + (size_t)(buf ^ 1) * 2 * bs * ld;
      const size_t base = page_base(j + 1);
      load_page(kn, kn + bs * ld, kp + base, vp + base, bs, row_bytes, ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j's tiles (and, at j0, qs/ms/ls) are visible
    if (j == wpage) {
      const size_t wbase = ((size_t)wb * nkv + h) * page_elems;
      if (on) {
        reinterpret_cast<T*>(kt + wrow * ld)[d] = k_roped;
        reinterpret_cast<T*>(vt + wrow * ld)[d] = v_raw;
        kpool[wbase + (size_t)wrow * hd + d] = k_roped;
        vpool[wbase + (size_t)wrow * hd + d] = v_raw;
      } else {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        uint4* kz = reinterpret_cast<uint4*>(kpool + wbase);
        uint4* vz = reinterpret_cast<uint4*>(vpool + wbase);
        const int nvec = (int)(page_elems * sizeof(T) / 16);
        for (int i = d; i < nvec; i += blockDim.x) {
          kz[i] = zero;
          vz[i] = zero;
        }
      }
      __syncthreads();
    }
    page_update<T, kFp>(kt, vt, ld, 1.f, 1.f, qs, pt, ms, ls, al, acc, rep,
                        hd, min(bs, length - j * bs), scale);
  }
  __syncthreads();  // ms/ls of an empty shard are set before the emit

  const size_t part = (((size_t)b * nkv + h) * S + s) * rep;
  for (int r = 0; r < rep; ++r) acc_out[(part + r) * hd + d] = acc[r];
  if (d < rep) {
    m_out[part + d] = ms[d];
    l_out[part + d] = ls[d];
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new,
           const void* cos, const void* sin, void* kpool, void* vpool,
           const int* tables, const int* lens, const int* wblk,
           const int* wable, float* m, float* l, float* acc, void* out, int b,
           int nh, int nkv, int hd, int nbp, int bs, int max_blocks, int S,
           int P, float scale, cudaStream_t stream) {
  const int rep = nh / nkv;
  const size_t smem = walk_smem(bs, hd * (int)sizeof(T) + kRowPad, rep, hd);
  auto kernel = fused_decode_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(b, nkv, S), hd, smem, stream>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (const T*)cos,
      (const T*)sin, (T*)kpool, (T*)vpool, tables, lens, wblk, wable, m, l,
      acc, nh, nkv, hd, nbp, bs, max_blocks, S, P, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<T><<<dim3(b, nkv), hd, 0, stream>>>(m, l, acc, (T*)out, nkv,
                                                     rep, hd, S);
  return (int)cudaGetLastError();
}

}  // namespace

// q [b, nh, hd]; k_new, v_new [b, nkv, hd]; cos, sin [b, hd]; pools
// [nbp, nkv, bs, hd] (updated in place); tables [b, max_blocks], lens,
// wblk, wable [b] int32; partials m, l [b, nkv, S, rep], acc
// [b, nkv, S, rep, hd] f32 scratch; out [b, nh, hd].  hd a multiple of 32
// up to 1024, nh / nkv <= 8, bs even (the wrapper checks).  Returns
// cudaGetLastError().
extern "C" int ptt_fused_decode(const void* q, const void* k_new,
                                const void* v_new, const void* cos,
                                const void* sin, void* kpool, void* vpool,
                                const void* tables, const void* lens,
                                const void* wblk, const void* wable, void* m,
                                void* l, void* acc, void* out, int b, int nh,
                                int nkv, int hd, int nbp, int bs,
                                int max_blocks, int S, int P, float scale,
                                int dtype, cudaStream_t stream) {
  if (b == 0) return (int)cudaGetLastError();
  auto fn = dtype == ptt::kBF16 ? launch<__nv_bfloat16> : launch<float>;
  return fn(q, k_new, v_new, cos, sin, kpool, vpool, (const int*)tables,
            (const int*)lens, (const int*)wblk, (const int*)wable, (float*)m,
            (float*)l, (float*)acc, out, b, nh, nkv, hd, nbp, bs, max_blocks,
            S, P, scale, stream);
}
