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
//    are padded by 8 elements so the score loop's 8-byte row reads from 16
//    different rows hit 16 different bank pairs;
//  - on the write page (j == lens / bs): a writeable lane inserts the roped
//    k row and the raw v row into its tiles BEFORE the score dot and
//    commits that row to the pool page `wblk` in place; a lane with
//    wable == 0 writes ZEROS over page `wblk` (the spill page) for its
//    head instead, so the spill page never holds uninitialised bits.
//    Several dropped lanes write the same zeros to the spill page, and
//    other dropped lanes may read it meanwhile: a benign race, since every
//    writer writes zeros and a dropped lane's output is discarded;
//  - scores only the live columns (< lens + 1) of each page: two adjacent
//    lanes share one column, each summing half of head_dim for every row of
//    the head group, one shuffle to finish;
//  - emits its raw partial (m, l, acc); an empty shard emits m = -1e30,
//    l = 0, acc = 0.
// A second small kernel merges the S partials of each (slot, kv head) with
// the exact log-sum-exp of `_flash_combine` and writes the output in the
// input dtype.
// Not yet used: tensor cores (a 4-row head group is too small a tile), TMA.
#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRep = 8;  // q heads per kv head a launch takes
constexpr int kPad = 8;     // tile row padding (elements)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive elements as f32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

template <typename T>
__device__ __forceinline__ float rope_elem(const T* __restrict__ x, int d,
                                           int half, float c, float s) {
  // x * cos + rotate_half(x) * sin, every op rounded to T (PyTorch's eager
  // arithmetic in dtype T); negation is exact
  const float xd = ptt::to_f32(x[d]);
  const float rot =
      d < half ? -ptt::to_f32(x[d + half]) : ptt::to_f32(x[d - half]);
  return ptt::round_to<T>(ptt::round_to<T>(xd * c) +
                          ptt::round_to<T>(rot * s));
}

// copy one page's K and V tiles (bs rows of hd elements, contiguous in the
// pool) into padded shared tiles, 16 bytes a cp.async
template <typename T>
__device__ __forceinline__ void load_page(T* kt, T* vt, const T* ksrc,
                                          const T* vsrc, int bs, int hd,
                                          int ld) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = hd / E;
  for (int i = threadIdx.x; i < bs * per_row; i += blockDim.x) {
    const int row = i / per_row, col = (i % per_row) * E;
    cp_async16(kt + row * ld + col, ksrc + (size_t)row * hd + col);
    cp_async16(vt + row * ld + col, vsrc + (size_t)row * hd + col);
  }
  cp_async_commit();
}

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
  const int ld = hd + kPad;
  T* tiles = reinterpret_cast<T*>(smem);                 // [2][2][bs][ld]
  float* qs = reinterpret_cast<float*>(tiles + 4 * bs * ld);  // [rep][hd]
  float* pt = qs + rep * hd;                             // [bs][kMaxRep]
  float* ms = pt + bs * kMaxRep;                         // [rep]
  float* ls = ms + rep;                                  // [rep]
  float* al = ls + rep;                                  // [rep]

  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int d = threadIdx.x;  // blockDim.x == hd
  const int lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  const int half = hd / 2;
  const int len_pre = lens[b];
  const int length = len_pre + 1;  // the appended token included
  const bool on = wable[b] == 1;
  const int wpage = len_pre / bs, wrow = len_pre % bs;
  const int wb = min(max(wblk[b], 0), nbp - 1);
  const size_t page_elems = (size_t)bs * hd;
  const int j0 = s * P;
  const int j1 = min((s + 1) * P, (length + bs - 1) / bs);  // live pages

  auto page_base = [&](int j) {
    const int col = min(j, max_blocks - 1);
    const int page = min(max(tables[(size_t)b * max_blocks + col], 0), nbp - 1);
    return ((size_t)page * nkv + h) * page_elems;
  };
  if (j0 < j1) {
    const size_t base = page_base(j0);
    load_page(tiles, tiles + bs * ld, kpool + base, vpool + base, bs, hd, ld);
  }

  const float c = ptt::to_f32(cos[(size_t)b * hd + d]);
  const float sn = ptt::to_f32(sin[(size_t)b * hd + d]);
  for (int r = 0; r < rep; ++r) {
    const T* qrow = q + ((size_t)b * nh + (size_t)h * rep + r) * hd;
    qs[r * hd + d] = rope_elem(qrow, d, half, c, sn);
  }
  if (d < rep) {
    ms[d] = kNegInf;
    ls[d] = 0.f;
  }
  const size_t row_off = ((size_t)b * nkv + h) * hd;
  const T k_roped = ptt::from_f32<T>(rope_elem(k_new + row_off, d, half, c, sn));
  const T v_raw = v_new[row_off + d];
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    T* kt = tiles + (size_t)buf * 2 * bs * ld;
    T* vt = kt + bs * ld;
    if (j + 1 < j1) {  // prefetch the next page into the other buffer
      T* kn = tiles + (size_t)(buf ^ 1) * 2 * bs * ld;
      const size_t base = page_base(j + 1);
      load_page(kn, kn + bs * ld, kpool + base, vpool + base, bs, hd, ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j's tiles (and, at j0, qs/ms/ls) are visible
    if (j == wpage) {
      const size_t wbase = ((size_t)wb * nkv + h) * page_elems;
      if (on) {
        kt[wrow * ld + d] = k_roped;
        vt[wrow * ld + d] = v_raw;
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
    const int ncol = min(bs, length - j * bs);  // live columns of this page
    // scores: lanes 2t and 2t+1 share column t, interleaving 4-element
    // chunks of head_dim.  The loop bound is uniform over the block, so
    // every lane reaches the shuffle; lanes past the live columns idle.
    for (int t0 = 0; t0 < ncol; t0 += blockDim.x >> 1) {
      const int t = t0 + (d >> 1), hf = d & 1;
      const bool live = t < ncol;
      float sc[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) sc[r] = 0.f;
      for (int e = 4 * hf; live && e < hd; e += 8) {
        float kv[4];
        load4(kt + t * ld + e, kv);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float4 qv = *reinterpret_cast<const float4*>(&qs[r * hd + e]);
            sc[r] += qv.x * kv[0] + qv.y * kv[1] + qv.z * kv[2] + qv.w * kv[3];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], 1);
        if (live && hf == 0 && r < rep) pt[t * kMaxRep + r] = sc[r] * scale;
      }
    }
    __syncthreads();
    for (int r = warp; r < rep; r += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < ncol; t += 32) mx = fmaxf(mx, pt[t * kMaxRep + r]);
      mx = ptt::warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int t = lane; t < ncol; t += 32) {
        const float p = expf(pt[t * kMaxRep + r] - m_new);
        pt[t * kMaxRep + r] = p;
        psum += p;
      }
      psum = ptt::warp_sum(psum);
      if (lane == 0) {
        const float alpha = m_prev > 0.5f * kNegInf ? expf(m_prev - m_new) : 0.f;
        ls[r] = alpha * ls[r] + psum;
        al[r] = alpha;
        ms[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) acc[r] *= al[r];
    for (int t = 0; t < ncol; ++t) {
      const float v = ptt::to_f32(vt[t * ld + d]);
      const float4 pa = *reinterpret_cast<const float4*>(&pt[t * kMaxRep]);
      const float4 pb = *reinterpret_cast<const float4*>(&pt[t * kMaxRep + 4]);
      const float pv[kMaxRep] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] += pv[r] * v;
    }
    __syncthreads();  // the next page's scores overwrite pt; its prefetch
                      // targets the buffer read above
  }
  __syncthreads();  // ms/ls of an empty shard are set before the emit

  const size_t part = (((size_t)b * nkv + h) * S + s) * rep;
  for (int r = 0; r < rep; ++r) acc_out[(part + r) * hd + d] = acc[r];
  if (d < rep) {
    m_out[part + d] = ms[d];
    l_out[part + d] = ls[d];
  }
}

// Exact log-sum-exp merge of the S partials of each (slot, kv head), as
// `_flash_combine`: out = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = exp(m_s - max m) (0 for an empty shard); all shards empty -> 0.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               T* __restrict__ out, int nkv, int rep, int hd,
                               int S) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * nkv + h) * S;
  for (int r = 0; r < rep; ++r) {
    float m_max = kNegInf;
    for (int s = 0; s < S; ++s) m_max = fmaxf(m_max, m[(base + s) * rep + r]);
    float l_tot = 0.f, a_tot = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = m[(base + s) * rep + r];
      const float w = ms > 0.5f * kNegInf ? expf(ms - m_max) : 0.f;
      l_tot += w * l[(base + s) * rep + r];
      a_tot += w * acc[((base + s) * rep + r) * hd + d];
    }
    out[(((size_t)b * nkv + h) * rep + r) * hd + d] =
        ptt::from_f32<T>(a_tot / (l_tot == 0.f ? 1.f : l_tot));
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
  const size_t smem = 4 * (size_t)bs * (hd + kPad) * sizeof(T) +
                      ((size_t)rep * hd + (size_t)bs * kMaxRep + 3 * rep) *
                          sizeof(float);
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
