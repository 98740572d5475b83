// FlashAttention-2 forward: out = softmax(mask(q k^T * scale)) v per q head,
// and the row log-sum-exp lse the backward recomputes probabilities from.
//
// The CUDA-core route (`flash_attention.flash_route` "cc"): f32, and bf16 /
// f16 at every head_dim other than 64 and 128 (a multiple of 8 up to 256).
// bf16 / f16 at head_dim 64 or 128 take the tensor-core kernel of
// flash_fwd_tc.cu.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_flash_fwd`).  On the TPU its grid was (b*hq, q blocks, kv
// blocks) with the kv axis run in order and m, l, acc carried in VMEM
// scratch from step to step; K/V blocks were indexed `bh // rep` (GQA
// without copies) and sequences were padded to the block grid.
//
// Bound on the H100: operations.  Causal attention at the training shape
// (b 2, s 2048, 32 q heads, d 128) does 4 * d * b * hq * s(s+1)/2 = 68.7
// GFLOP over 33.6 MB of q, k, v, out and lse: about 2000 flops a byte, far
// above the card's ridge, so the tensor cores' 989 TFLOP/s set the bound.
//
// Design (a simple kernel; it runs on the CUDA cores in f32 and does not
// reach that bound): grid (b*hq, q tiles of 64 rows), 256
// threads.  Blocks run in parallel in no order, so the TPU's sequential kv
// axis becomes a loop inside the block, with the online-softmax state
// living in registers for the block's lifetime:
//  - the q tile and each K/V tile are converted to f32 once, into shared
//    memory (rows padded by 4 floats so 8 lanes reading 8 rows with 16-byte
//    loads hit 8 different bank groups).  K/V come from kv head h / rep, so
//    GQA never copies K/V;
//  - each thread owns 4 q rows x (BKV / 16) kv columns of the logits tile
//    (columns strided by 16 lanes) and the same 4 rows x d / 16 columns of
//    the accumulator; row max and row sum are half-warp shuffles;
//  - logits are dot(q_f32, k_f32) * scale, then the mask, segments, causal
//    row >= col and the ragged bounds, in the reference's order, and
//    `_safe_exp` (exactly 0 for masked logits);
//  - kv tiles above the diagonal or past skv are never visited; ragged
//    tails are bounds-checked, nothing is padded or copied;
//  - finalize: l == 0 -> out 0 and lse = m + log(1) = -1e30, as the
//    reference.  Output in q's dtype, lse f32.
// Not yet used: tensor cores (wgmma), TMA or cp.async double buffering,
// warp specialisation.  BKV is 64 for d <= 128 and 32 up to d 256, so the
// f32 tiles fit in shared memory.
#include "flash.cuh"

namespace {

using namespace ptt::flash;

template <typename T, int BKV, int DCH>
__global__ void __launch_bounds__(256)
    flash_fwd_kernel(const Params p) {
  constexpr int CC = BKV / 16;  // kv columns per thread
  constexpr int PT = kBQ + 4;   // row stride of the staged probabilities
  extern __shared__ float4 smem4[];
  const int d = p.d, DP = d + 4, nc4 = d / 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;                    // [BKV][DP]
  float* Vs = Ks + BKV * DP;                    // [BKV][DP]
  float* Pt = Vs + BKV * DP;                    // [BKV][PT], transposed p
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, batch = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  // heaviest (last) q tiles first: under causal they visit the most kv
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const size_t qstride = (size_t)p.hq * d, kstride = (size_t)p.hkv * d;
  const T* qb = static_cast<const T*>(p.q) + (size_t)batch * p.sq * qstride +
                (size_t)h * d;
  const T* kb = static_cast<const T*>(p.k) +
                (size_t)batch * p.skv * kstride + (size_t)hk * d;
  const T* vb = static_cast<const T*>(p.v) +
                (size_t)batch * p.skv * kstride + (size_t)hk * d;
  const char* plane = mask_plane(p, batch, h);
  const int* qs = p.q_seg ? p.q_seg + (size_t)batch * p.sq : nullptr;
  const int* ks = p.q_seg ? p.kv_seg + (size_t)batch * p.skv : nullptr;

  load_rows<T>(Qs, DP, qb, qstride, q0, kBQ, p.sq, d);

  float m[4], l[4];
  float4 acc[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int k = 0; k < DCH; ++k) acc[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + kBQ, p.sq) - 1) / BKV + 1);

  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * BKV;
    __syncthreads();  // the previous tile's PV loop is done with Vs, Pt
    load_rows<T>(Ks, DP, kb, kstride, j0, BKV, p.skv, d);
    load_rows<T>(Vs, DP, vb, kstride, j0, BKV, p.skv, d);
    __syncthreads();

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
      const int i = q0 + ty * 4 + r;
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        s[r][c] = masked_logit(p, s[r][c] * p.scale, plane, qs, ks, i,
                               j0 + tx + 16 * c);
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
#pragma unroll
    for (int c = 0; c < CC; ++c)
      *reinterpret_cast<float4*>(Pt + (tx + 16 * c) * PT + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    const int jn = min(BKV, p.skv - j0);
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

  T* ob = static_cast<T*>(p.out) + (size_t)batch * p.sq * qstride +
          (size_t)h * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.sq) continue;
    const float ls = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int ch = tx + 16 * k;
      if (ch < nc4) {
        const float4 a = acc[r][k];
        store4<T>(ob + (size_t)i * qstride + ch * 4,
                  make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls));
      }
    }
    if (tx == 0) p.lse[(size_t)bh * p.sq + i] = m[r] + logf(ls);
  }
}

template <typename T, int BKV, int DCH>
int launch(const Params& p, cudaStream_t stream) {
  const size_t DP = p.d + 4;
  const size_t smem =
      (kBQ * DP + 2 * BKV * DP + BKV * (size_t)(kBQ + 4)) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, BKV, DCH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hq, (p.sq + kBQ - 1) / kBQ);
  kernel<<<grid, 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  return p.d <= 128 ? launch<T, 64, 2>(p, stream)
                    : launch<T, 32, 4>(p, stream);
}

}  // namespace

// q [b, sq, hq, d], k, v [b, skv, hkv, d] (BSHD, contiguous, d % 8 == 0,
// d <= 256, hq % hkv == 0: the wrapper checks); out like q; lse [b, hq, sq]
// f32; mask/q_seg/kv_seg optional (NULL).  Returns cudaGetLastError().
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* mask, const void* q_seg,
                             const void* kv_seg, void* out, void* lse, int b,
                             int sq, int skv, int hq, int hkv, int d, int mb,
                             int mh, int mask_kind, int causal, float scale,
                             int dtype, cudaStream_t stream) {
  ptt::flash::Params p = ptt::flash::make_params(
      b, sq, skv, hq, hkv, d, mb, mh, mask_kind, causal, scale, mask, q_seg,
      kv_seg);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  if (dtype == ptt::kBF16) return dispatch<__nv_bfloat16>(p, stream);
  if (dtype == ptt::kF16) return dispatch<__half>(p, stream);
  return dispatch<float>(p, stream);
}
