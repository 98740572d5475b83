// Shared pieces of the paged-attention decode kernels (fused_decode.cu,
// paged_decode.cu, fused_quant_decode.cu): cp.async page loads, the three
// KV storage formats read as f32, rope in the input dtype, the one-page
// online-softmax update, the page requantize, and the split-K combine.
//
// Page tiles live in shared memory as raw bytes, `ld` bytes a row (the
// row's bytes plus kRowPad, so every row starts 16-byte aligned for
// cp.async).  A block runs one thread per head_dim element.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRep = 8;    // q heads per kv head a launch takes
constexpr int kRowPad = 16;   // tile row padding (bytes)

// KV storage formats (the wrapper's `kv_format` code)
enum KVFormat { kFp = 0, kInt8 = 1, kInt4 = 2 };

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

// a nibble (low 4 bits of x) sign-extended by arithmetic shifts, as the
// reference's `_unpack_int4`
__device__ __forceinline__ float nibble(unsigned x) {
  return (float)((int)(x << 28) >> 28);
}

// One head_dim row of a page in each storage format: its bytes, and
// elements read as f32.  Quantized elements are dequantized as the
// reference's `_dequant_page`: code (f32) times the page's scale, one
// correctly rounded multiply.  int4 packs element 2i in the low nibble of
// byte i and 2i+1 in the high one.
template <typename T, int F>
struct KV;
template <typename T>
struct KV<T, kFp> {
  __host__ __device__ static int row_bytes(int hd) { return hd * (int)sizeof(T); }
  __device__ static void load4(const unsigned char* row, int e, float,
                               float* o) {
    ptt::load4(reinterpret_cast<const T*>(row) + e, o);
  }
  __device__ static float load1(const unsigned char* row, int d, float) {
    return to_f32(reinterpret_cast<const T*>(row)[d]);
  }
};
template <typename T>
struct KV<T, kInt8> {
  __host__ __device__ static int row_bytes(int hd) { return hd; }
  __device__ static void load4(const unsigned char* row, int e, float sc,
                               float* o) {
    const unsigned v = *reinterpret_cast<const unsigned*>(row + e);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __fmul_rn((float)((int)(v << (24 - 8 * i)) >> 24), sc);
  }
  __device__ static float load1(const unsigned char* row, int d, float sc) {
    return __fmul_rn((float)reinterpret_cast<const signed char*>(row)[d], sc);
  }
};
template <typename T>
struct KV<T, kInt4> {
  __host__ __device__ static int row_bytes(int hd) { return hd / 2; }
  __device__ static void load4(const unsigned char* row, int e, float sc,
                               float* o) {
    const unsigned v = *reinterpret_cast<const unsigned short*>(row + e / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __fmul_rn(nibble(v >> (4 * i)), sc);
  }
  __device__ static float load1(const unsigned char* row, int d, float sc) {
    const unsigned byte = row[d >> 1];
    return __fmul_rn(nibble((d & 1) ? byte >> 4 : byte), sc);
  }
};

// x * cos + rotate_half(x) * sin at element d, the plain version's
// arithmetic (rope.py), so the kernel feeds the score dot and the pools the
// values the unfused composition computes: in f32 one FMA,
// fma(x, cos, rot * sin), as the reference's compiled programs contract it;
// in bf16 / f16 every op rounded to T, with explicit round-to-nearest
// intrinsics so the compiler contracts nothing.  Negation is exact.
template <typename T>
__device__ __forceinline__ float rope_elem(const T* __restrict__ x, int d,
                                           int half, float c, float s) {
  const float xd = to_f32(x[d]);
  const float rot = d < half ? -to_f32(x[d + half]) : to_f32(x[d - half]);
  if constexpr (std::is_same_v<T, float>)
    return __fmaf_rn(xd, c, __fmul_rn(rot, s));
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(xd, c)),
                               round_to<T>(__fmul_rn(rot, s))));
}

// copy one page's K and V tiles (bs rows of row_bytes, contiguous in the
// pool) into padded shared tiles, 16 bytes a cp.async
__device__ __forceinline__ void load_page(unsigned char* kt, unsigned char* vt,
                                          const unsigned char* ksrc,
                                          const unsigned char* vsrc, int bs,
                                          int row_bytes, int ld) {
  const int per_row = row_bytes / 16;
  for (int i = threadIdx.x; i < bs * per_row; i += blockDim.x) {
    const int row = i / per_row, col = (i % per_row) * 16;
    cp_async16(kt + row * ld + col, ksrc + (size_t)row * row_bytes + col);
    cp_async16(vt + row * ld + col, vsrc + (size_t)row * row_bytes + col);
  }
  cp_async_commit();
}

// Max of v over the whole block; every thread gets it.  `scratch` holds 32
// floats of shared memory; every thread of the block must call it.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_max(lane < nwarps ? scratch[lane] : kNegInf);
}

// One page of the online softmax (the reference's `_online_softmax_update`
// over the live columns only): the scores of columns < ncol of the K tile
// against the f32 q rows in `qs` ([rep][hd]), the running max / sum in
// ms / ls, and each thread's head_dim column of the accumulators, acc,
// rescaled and advanced by p . V.  ksc / vsc are the page's scales (unused
// for fp tiles).  Lanes 2t and 2t+1 share column t, interleaving 4-element
// chunks of head_dim; the loop bound is uniform over the block, so every
// lane reaches the shuffle.  `pt` ([bs][kMaxRep]) stages the scores, `al`
// ([rep]) the rescale factors.  Every thread calls it (it synchronizes,
// and it ends with a barrier so the caller may overwrite the tiles).
template <typename T, int F>
__device__ __forceinline__ void page_update(
    const unsigned char* kt, const unsigned char* vt, int ld, float ksc,
    float vsc, const float* qs, float* pt, float* ms, float* ls, float* al,
    float* acc, int rep, int hd, int ncol, float scale) {
  const int d = threadIdx.x;
  const int lane = d & 31, warp = d >> 5, nwarps = blockDim.x >> 5;
  for (int t0 = 0; t0 < ncol; t0 += blockDim.x >> 1) {
    const int t = t0 + (d >> 1), hf = d & 1;
    const bool live = t < ncol;
    float sc[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) sc[r] = 0.f;
    for (int e = 4 * hf; live && e < hd; e += 8) {
      float kv[4];
      KV<T, F>::load4(kt + t * ld, e, ksc, kv);
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
    mx = warp_max(mx);
    const float m_prev = ms[r];
    const float m_new = fmaxf(m_prev, mx);
    float psum = 0.f;
    for (int t = lane; t < ncol; t += 32) {
      const float p = expf(pt[t * kMaxRep + r] - m_new);
      pt[t * kMaxRep + r] = p;
      psum += p;
    }
    psum = warp_sum(psum);
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
    const float v = KV<T, F>::load1(vt + t * ld, d, vsc);
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

// Requantize one page held in a shared tile, as the reference's
// `quant_append_decode` / `_quant_encode_page`: dequantize every row with
// the OLD scale, put `ins` (this thread's element of the new row) at row
// wrow, take the absmax over all bs rows (stale rows included), scale =
// absmax * (1 / bound) (the reference's compiled programs turn its
// `absmax / bound` into this multiply by the f32 reciprocal), codes =
// clip(rint(x / max(scale, 1e-10)), -bound, bound) (rint rounds half to
// even, as jnp.round and torch.round; the division is correctly rounded).
// The codes go back into the tile, then from it to `dst`, the pool page;
// returns the new scale.  Thread d owns column d; every thread calls it.
//
// Each pass reads eight rows before it uses them (bs is a multiple of 8),
// the encode writes them back only after their eight divisions, which
// carry no branch, and the page goes to the pool in 16-byte copies: one
// row at a time (each row's read, library division and byte stores one
// chain of dependent steps per thread, 64 rows long) the write page cost
// its launch 12 us (int8) to 20 us (int4) more on the H100
// (kernel_variants.py, "requant_serial").  The division x / den is
// Markstein's: q = RN(x * r) with r = RN(1 / den) is
// within an ulp of x / den, the residual x - q den is exact in one FMA,
// and RN(q + residual * r) is the correctly rounded quotient, for every
// den here (1e-10 <= den <= 2^100, |x| <= 128 den) wherever the quotient
// is a normal float; a subnormal quotient rounds to the code 0 either way.
// A larger or non-finite den takes the library division.  For int4 the
// even thread of a pair packs its code with its neighbour's (a shuffle
// after both have read the byte, so the write cannot overtake the read).
template <int F>
__device__ __forceinline__ float requant_page(unsigned char* tile, int ld,
                                              float old_sc, int wrow,
                                              float ins, unsigned char* dst,
                                              int bs, int hd, float* red) {
  const int d = threadIdx.x;
  const int row_bytes = KV<float, F>::row_bytes(hd);
  const float bound = F == kInt4 ? 7.f : 127.f;
  const float inv_bound = F == kInt4 ? 1.f / 7.f : 1.f / 127.f;
  auto rows8 = [&](int t0, float (&x)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = t0 + u == wrow ? ins : KV<float, F>::load1(tile + (t0 + u) * ld,
                                                        d, old_sc);
  };
  float amax = 0.f;
  for (int t0 = 0; t0 < bs; t0 += 8) {
    float x[8];
    rows8(t0, x);
#pragma unroll
    for (int u = 0; u < 8; ++u) amax = fmaxf(amax, fabsf(x[u]));
  }
  amax = block_max(amax, red);  // every read of the old tile is done
  const float sc = __fmul_rn(amax, inv_bound);
  const float den = fmaxf(sc, 1e-10f);
  auto encode = [&](auto div) {
    for (int t0 = 0; t0 < bs; t0 += 8) {
      float x[8];
      rows8(t0, x);
      int c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        c[u] = (int)fminf(fmaxf(rintf(div(x[u])), -bound), bound);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int t = t0 + u;
        if constexpr (F == kInt8) {
          tile[t * ld + d] = (unsigned char)c[u];
        } else {
          const int hi = __shfl_down_sync(0xffffffffu, c[u], 1);
          if ((d & 1) == 0)
            tile[t * ld + d / 2] =
                (unsigned char)((c[u] & 0xF) | ((hi & 0xF) << 4));
        }
      }
    }
  };
  if (den <= 0x1p100f) {
    const float r = __frcp_rn(den);
    encode([&](float x) {
      const float q = __fmul_rn(x, r);
      return __fmaf_rn(__fmaf_rn(-q, den, x), r, q);
    });
  } else {
    encode([&](float x) { return __fdiv_rn(x, den); });
  }
  __syncthreads();  // the tile's new codes are visible to every thread
  // the page's codes to the pool, 16 bytes a store
  const int chunks = row_bytes / 16;
  for (int i = d; i < bs * chunks; i += blockDim.x) {
    const int t = i / chunks, k = i % chunks;
    *reinterpret_cast<uint4*>(dst + (size_t)t * row_bytes + 16 * k) =
        *reinterpret_cast<const uint4*>(tile + t * ld + 16 * k);
  }
  return sc;
}

// Exact log-sum-exp merge of the S partials of each (slot, kv head), as
// `_flash_combine`: out = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = exp(m_s - max m) (0 for an empty shard); all shards empty -> 0.
// Grid (b, nkv), head_dim threads.
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
        from_f32<T>(a_tot / (l_tot == 0.f ? 1.f : l_tot));
  }
}

// shared memory of a walk block: the double-buffered K/V tiles, the f32 q
// rows, the staged scores, m / l / alpha and a 32-float reduction scratch
inline size_t walk_smem(int bs, int ld, int rep, int hd) {
  return 4 * (size_t)bs * ld +
         ((size_t)rep * hd + (size_t)bs * kMaxRep + 3 * rep + 32) *
             sizeof(float);
}

}  // namespace ptt
