// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the launch parameters, the tile loader, the logit masks in the
// reference's order, and vector helpers.  Header-only.
//
// Layouts: q, out, dout, dq [b, sq, hq, d]; k, v, dk, dv [b, skv, hkv, d]
// (BSHD, contiguous, d a multiple of 8 up to 256); lse, delta [b, hq, sq]
// f32; mask [mb * mh, sq, skv] bool or f32 (mb in {1, b}, mh in {1, hq});
// q_seg [b, sq], kv_seg [b, skv] int32.
#pragma once

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;  // q rows of a tile, in every kernel
constexpr int kMaskNone = 0, kMaskBool = 1, kMaskAdd = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const void* mask;
  const int* q_seg;
  const int* kv_seg;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int b, sq, skv, hq, hkv, d, mb, mh, mask_kind, causal;
  float scale;
};

// exp(s - shift), exactly 0 where s is fully masked (the reference's
// `_safe_exp`; also 0 when the shift itself is kNegInf)
__device__ __forceinline__ float safe_exp(float s, float shift) {
  return s > 0.5f * kNegInf ? expf(s - shift) : 0.f;
}

// The [sq, skv] plane of the mask that q head h of batch `batch` reads.
__device__ __forceinline__ const char* mask_plane(const Params& p, int batch,
                                                  int h) {
  if (p.mask_kind == kMaskNone) return nullptr;
  const size_t row =
      (size_t)(p.mb > 1 ? batch : 0) * p.mh + (p.mh > 1 ? h : 0);
  const size_t esz = p.mask_kind == kMaskBool ? 1 : 4;
  return static_cast<const char*>(p.mask) + row * p.sq * p.skv * esz;
}

// The logit s (already scaled) of q row i against kv column j after every
// mask, in the reference's order: mask tile (bool -> kNegInf, additive ->
// + mask), segments, causal top-left (row >= col).  Out-of-range rows and
// columns (ragged tiles) are masked.
__device__ __forceinline__ float masked_logit(const Params& p, float s,
                                              const char* plane,
                                              const int* qs, const int* ks,
                                              int i, int j) {
  if (i >= p.sq || j >= p.skv) return kNegInf;
  const size_t at = (size_t)i * p.skv + j;
  if (p.mask_kind == kMaskBool) {
    if (!reinterpret_cast<const unsigned char*>(plane)[at]) s = kNegInf;
  } else if (p.mask_kind == kMaskAdd) {
    s += reinterpret_cast<const float*>(plane)[at];
  }
  if (qs != nullptr && qs[i] != ks[j]) s = kNegInf;
  if (p.causal && i < j) s = kNegInf;
  return s;
}

// Rows [r0, r0 + nrows) of one head of a BSHD tensor (row r at
// src + r * stride) into f32 shared memory [nrows][ld]; rows at or past
// rmax read as zeros.  16-byte loads: d is a multiple of 8, so every row
// of every head starts on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t stride, int r0, int nrows,
                                          int rmax, int d) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = d / V;
  for (int idx = threadIdx.x; idx < nrows * vpr; idx += blockDim.x) {
    const int r = idx / vpr, c = (idx - r * vpr) * V;
    float f[V];
    if (r0 + r < rmax) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = to_f32(e[u]);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < V; u += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + u) =
          make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
  }
}

// Four f32 values rounded to T, stored at dst (16-byte aligned for f32,
// 8-byte for the 2-byte types).
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    uint2 u;
    T* e = reinterpret_cast<T*>(&u);
    e[0] = from_f32<T>(v.x);
    e[1] = from_f32<T>(v.y);
    e[2] = from_f32<T>(v.z);
    e[3] = from_f32<T>(v.w);
    *reinterpret_cast<uint2*>(dst) = u;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc += s * v
__device__ __forceinline__ void axpy4(float4& acc, float s, float4 v) {
  acc.x = fmaf(s, v.x, acc.x);
  acc.y = fmaf(s, v.y, acc.y);
  acc.z = fmaf(s, v.z, acc.z);
  acc.w = fmaf(s, v.w, acc.w);
}

__device__ __forceinline__ float comp(float4 v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// max / sum over the 16 lanes of a half warp (lanes that share a tile row)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fill the launch parameters shared by the three C entry points.
inline Params make_params(int b, int sq, int skv, int hq, int hkv, int d,
                          int mb, int mh, int mask_kind, int causal,
                          float scale, const void* mask, const void* q_seg,
                          const void* kv_seg) {
  Params p{};
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.d = d;
  p.mb = mb;
  p.mh = mh;
  p.mask_kind = mask_kind;
  p.causal = causal;
  p.scale = scale;
  p.mask = mask;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  return p;
}

}  // namespace flash
}  // namespace ptt
