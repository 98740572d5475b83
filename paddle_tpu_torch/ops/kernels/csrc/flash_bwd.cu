// FlashAttention-2 backward: dK/dV and dQ, two kernels with no atomics.
//
// The CUDA-core route (`flash_attention.flash_route` "cc") of dK/dV and
// dQ: f32, and bf16 / f16 at every head_dim other than 64 and 128 (a
// multiple of 8 up to 256); bf16 / f16 at head_dim 64 or 128 take the
// tensor-core kernels of flash_bwd_tc.cu.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dkv_kernel` and
// `_dq_kernel` (launched by `_flash_bwd`).  On the TPU the dk/dv grid was
// (b*hkv, kv blocks, rep * q blocks) with the group's q blocks walked in
// order into VMEM accumulators, and the dq grid (b*hq, q blocks, kv
// blocks) with kv in order.  Both recompute p = exp(s - lse) exactly from
// the forward's lse; delta = rowsum(dO * O) comes in precomputed (XLA
// there, PyTorch here).  Splitting dK/dV from dQ keeps every output owned
// by one block: the backward is deterministic, and so is a recompute under
// activation checkpointing.
//
// Bound on the H100: operations.  Causal at the training shape (b 2,
// s 2048, 32 q heads, d 128): dK/dV does 8 * d * P flops (s, dp, dv, dk)
// and dQ 6 * d * P (s, dp, dq) with P = b * hq * s(s+1)/2 = 134M pairs,
// about a thousand flops per byte moved: tensor-core bound (989 TFLOP/s).
//
// Design (a simple kernel on the CUDA cores in f32, like flash_fwd.cu,
// whose tile scheme it shares):
//  - dK/dV: grid (b*hkv, kv tiles of BKV rows), 4 * BKV threads.  The
//    block keeps its K and V tile in shared memory (f32) and walks every q
//    tile of every q head of its kv group (the TPU's rep * q-block axis;
//    causal: only tiles at or below the diagonal).  Per q tile it computes
//    s^T and dp^T for its 4 kv rows x 4 q columns per thread, p =
//    safe_exp(s - lse), ds = p (dp - delta) scale, stages p and ds in
//    shared memory and accumulates dv += p^T do and dk += ds^T q in f32
//    registers (the GQA group sum happens there).  Written once, in k's
//    and v's dtype;
//  - dQ: grid (b*hq, q tiles of 64 rows), 256 threads; walks kv tiles
//    (causal: up to the diagonal), recomputes p and ds the same way and
//    accumulates dq += ds k in f32 registers.  Written once, in q's dtype.
// BKV is 64 for d <= 128 and 32 up to d 256 (shared-memory budget).
#include "flash.cuh"

namespace {

using namespace ptt::flash;

template <typename T, int BKV, int DCH>
__global__ void __launch_bounds__(4 * BKV)
    flash_dkv_kernel(const Params p) {
  constexpr int CQ = kBQ / 16;  // q columns per thread
  constexpr int PS = BKV + 4;   // row stride of the staged p and ds
  extern __shared__ float4 smem4[];
  const int d = p.d, DP = d + 4, nc4 = d / 4;
  float* Ks = reinterpret_cast<float*>(smem4);  // [BKV][DP]
  float* Vs = Ks + BKV * DP;                    // [BKV][DP]
  float* Qs = Vs + BKV * DP;                    // [kBQ][DP]
  float* Os = Qs + kBQ * DP;                    // [kBQ][DP], dO
  float* Ps = Os + kBQ * DP;                    // [kBQ][PS]
  float* Ds = Ps + kBQ * PS;                    // [kBQ][PS]
  float* Ls = Ds + kBQ * PS;                    // [kBQ], lse
  float* Es = Ls + kBQ;                         // [kBQ], delta
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bkv = blockIdx.x, batch = bkv / p.hkv, hk = bkv % p.hkv;
  const int rep = p.hq / p.hkv;
  const int j0 = blockIdx.y * BKV;
  const size_t qstride = (size_t)p.hq * d, kstride = (size_t)p.hkv * d;
  const size_t koff = (size_t)batch * p.skv * kstride + (size_t)hk * d;
  load_rows<T>(Ks, DP, static_cast<const T*>(p.k) + koff, kstride, j0, BKV,
               p.skv, d);
  load_rows<T>(Vs, DP, static_cast<const T*>(p.v) + koff, kstride, j0, BKV,
               p.skv, d);
  const int* qs = p.q_seg ? p.q_seg + (size_t)batch * p.sq : nullptr;
  const int* ks = p.q_seg ? p.kv_seg + (size_t)batch * p.skv : nullptr;

  float4 ak[4][DCH], av[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      ak[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      av[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  const int n_q = (p.sq + kBQ - 1) / kBQ;
  const int qt0 = p.causal ? j0 / kBQ : 0;

  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;
    const size_t bh = (size_t)batch * p.hq + h;
    const size_t qoff = (size_t)batch * p.sq * qstride + (size_t)h * d;
    const char* plane = mask_plane(p, batch, h);
    for (int qt = qt0; qt < n_q; ++qt) {
      const int i0 = qt * kBQ;
      __syncthreads();  // the previous tile's accumulation is done
      load_rows<T>(Qs, DP, static_cast<const T*>(p.q) + qoff, qstride, i0,
                   kBQ, p.sq, d);
      load_rows<T>(Os, DP, static_cast<const T*>(p.dout) + qoff, qstride,
                   i0, kBQ, p.sq, d);
      for (int x = tid; x < kBQ; x += blockDim.x) {
        const bool in = i0 + x < p.sq;
        Ls[x] = in ? p.lse_in[bh * p.sq + i0 + x] : 0.f;
        Es[x] = in ? p.delta[bh * p.sq + i0 + x] : 0.f;
      }
      __syncthreads();

      // s^T and dp^T: rows = this thread's 4 kv rows, columns = its q rows
      float s[4][CQ], dp[4][CQ];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CQ; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
      for (int c4 = 0; c4 < nc4; ++c4) {
        float4 kv[4], vv[4], qv[CQ], ov[CQ];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          kv[r] = ld4(Ks + (ty * 4 + r) * DP + c4 * 4);
          vv[r] = ld4(Vs + (ty * 4 + r) * DP + c4 * 4);
        }
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          qv[c] = ld4(Qs + (tx + 16 * c) * DP + c4 * 4);
          ov[c] = ld4(Os + (tx + 16 * c) * DP + c4 * 4);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < CQ; ++c) {
            s[r][c] = dot4(qv[c], kv[r], s[r][c]);
            dp[r][c] = dot4(ov[c], vv[r], dp[r][c]);
          }
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int il = tx + 16 * c;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float sv = masked_logit(p, s[r][c] * p.scale, plane, qs, ks,
                                        i0 + il, j0 + ty * 4 + r);
          const float pr = safe_exp(sv, Ls[il]);
          s[r][c] = pr;
          dp[r][c] = pr * (dp[r][c] - Es[il]) * p.scale;
        }
        *reinterpret_cast<float4*>(Ps + il * PS + ty * 4) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
        *reinterpret_cast<float4*>(Ds + il * PS + ty * 4) =
            make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q over the tile's q rows
      const int in = min(kBQ, p.sq - i0);
      for (int ii = 0; ii < in; ++ii) {
        const float4 p4 = ld4(Ps + ii * PS + ty * 4);
        const float4 d4 = ld4(Ds + ii * PS + ty * 4);
#pragma unroll
        for (int k = 0; k < DCH; ++k) {
          const int ch = tx + 16 * k;
          if (ch < nc4) {
            const float4 o4 = ld4(Os + ii * DP + ch * 4);
            const float4 q4 = ld4(Qs + ii * DP + ch * 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              axpy4(av[r][k], comp(p4, r), o4);
              axpy4(ak[r][k], comp(d4, r), q4);
            }
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + koff;
  T* dvb = static_cast<T*>(p.dv) + koff;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty * 4 + r;
    if (j >= p.skv) continue;
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int ch = tx + 16 * k;
      if (ch < nc4) {
        store4<T>(dkb + (size_t)j * kstride + ch * 4, ak[r][k]);
        store4<T>(dvb + (size_t)j * kstride + ch * 4, av[r][k]);
      }
    }
  }
}

template <typename T, int BKV, int DCH>
__global__ void __launch_bounds__(256) flash_dq_kernel(const Params p) {
  constexpr int CC = BKV / 16;  // kv columns per thread
  constexpr int PT = kBQ + 4;   // row stride of the staged ds (transposed)
  extern __shared__ float4 smem4[];
  const int d = p.d, DP = d + 4, nc4 = d / 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][DP]
  float* Os = Qs + kBQ * DP;                    // [kBQ][DP], dO
  float* Ks = Os + kBQ * DP;                    // [BKV][DP]
  float* Vs = Ks + BKV * DP;                    // [BKV][DP]
  float* Dt = Vs + BKV * DP;                    // [BKV][PT]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, batch = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const size_t qstride = (size_t)p.hq * d, kstride = (size_t)p.hkv * d;
  const size_t qoff = (size_t)batch * p.sq * qstride + (size_t)h * d;
  const size_t koff = (size_t)batch * p.skv * kstride + (size_t)hk * d;
  const T* kb = static_cast<const T*>(p.k) + koff;
  const T* vb = static_cast<const T*>(p.v) + koff;
  const char* plane = mask_plane(p, batch, h);
  const int* qs = p.q_seg ? p.q_seg + (size_t)batch * p.sq : nullptr;
  const int* ks = p.q_seg ? p.kv_seg + (size_t)batch * p.skv : nullptr;

  load_rows<T>(Qs, DP, static_cast<const T*>(p.q) + qoff, qstride, q0, kBQ,
               p.sq, d);
  load_rows<T>(Os, DP, static_cast<const T*>(p.dout) + qoff, qstride, q0,
               kBQ, p.sq, d);
  float lse[4], dl[4];
  float4 acc[4][DCH];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    lse[r] = i < p.sq ? p.lse_in[(size_t)bh * p.sq + i] : 0.f;
    dl[r] = i < p.sq ? p.delta[(size_t)bh * p.sq + i] : 0.f;
#pragma unroll
    for (int k = 0; k < DCH; ++k) acc[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + kBQ, p.sq) - 1) / BKV + 1);

  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * BKV;
    __syncthreads();  // the previous tile's dq loop is done with Ks, Dt
    load_rows<T>(Ks, DP, kb, kstride, j0, BKV, p.skv, d);
    load_rows<T>(Vs, DP, vb, kstride, j0, BKV, p.skv, d);
    __syncthreads();

    float s[4][CC], dp[4][CC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < nc4; ++c4) {
      float4 qv[4], ov[4], kv[CC], vv[CC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = ld4(Qs + (ty * 4 + r) * DP + c4 * 4);
        ov[r] = ld4(Os + (ty * 4 + r) * DP + c4 * 4);
      }
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        kv[c] = ld4(Ks + (tx + 16 * c) * DP + c4 * 4);
        vv[c] = ld4(Vs + (tx + 16 * c) * DP + c4 * 4);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          s[r][c] = dot4(qv[r], kv[c], s[r][c]);
          dp[r][c] = dot4(ov[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float sv = masked_logit(p, s[r][c] * p.scale, plane, qs, ks,
                                      q0 + ty * 4 + r, j0 + tx + 16 * c);
        const float pr = safe_exp(sv, lse[r]);
        ds[r] = pr * (dp[r][c] - dl[r]) * p.scale;
      }
      *reinterpret_cast<float4*>(Dt + (tx + 16 * c) * PT + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    const int jn = min(BKV, p.skv - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 d4 = ld4(Dt + jj * PT + ty * 4);
#pragma unroll
      for (int k = 0; k < DCH; ++k) {
        const int ch = tx + 16 * k;
        if (ch < nc4) {
          const float4 k4 = ld4(Ks + jj * DP + ch * 4);
          axpy4(acc[0][k], d4.x, k4);
          axpy4(acc[1][k], d4.y, k4);
          axpy4(acc[2][k], d4.z, k4);
          axpy4(acc[3][k], d4.w, k4);
        }
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= p.sq) continue;
#pragma unroll
    for (int k = 0; k < DCH; ++k) {
      const int ch = tx + 16 * k;
      if (ch < nc4) store4<T>(dqb + (size_t)i * qstride + ch * 4, acc[r][k]);
    }
  }
}

template <typename T, int BKV, int DCH>
int launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t DP = p.d + 4;
  const size_t smem = (2 * BKV * DP + 2 * kBQ * DP +
                       2 * kBQ * (size_t)(BKV + 4) + 2 * kBQ) *
                      sizeof(float);
  auto kernel = flash_dkv_kernel<T, BKV, DCH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hkv, (p.skv + BKV - 1) / BKV);
  kernel<<<grid, 4 * BKV, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int BKV, int DCH>
int launch_dq(const Params& p, cudaStream_t stream) {
  const size_t DP = p.d + 4;
  const size_t smem =
      (2 * kBQ * DP + 2 * BKV * DP + BKV * (size_t)(kBQ + 4)) * sizeof(float);
  auto kernel = flash_dq_kernel<T, BKV, DCH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hq, (p.sq + kBQ - 1) / kBQ);
  kernel<<<grid, 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dkv(const Params& p, cudaStream_t stream) {
  return p.d <= 128 ? launch_dkv<T, 64, 2>(p, stream)
                    : launch_dkv<T, 32, 4>(p, stream);
}

template <typename T>
int dispatch_dq(const Params& p, cudaStream_t stream) {
  return p.d <= 128 ? launch_dq<T, 64, 2>(p, stream)
                    : launch_dq<T, 32, 4>(p, stream);
}

}  // namespace

// q, dout [b, sq, hq, d], k, v [b, skv, hkv, d] (BSHD, contiguous, d % 8
// == 0, d <= 256, hq % hkv == 0: the wrapper checks); lse, delta [b, hq,
// sq] f32; mask/q_seg/kv_seg optional (NULL); dk, dv like k.  Returns
// cudaGetLastError().
extern "C" int ptt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* mask,
                             const void* q_seg, const void* kv_seg, void* dk,
                             void* dv, int b, int sq, int skv, int hq,
                             int hkv, int d, int mb, int mh, int mask_kind,
                             int causal, float scale, int dtype,
                             cudaStream_t stream) {
  ptt::flash::Params p = ptt::flash::make_params(
      b, sq, skv, hq, hkv, d, mb, mh, mask_kind, causal, scale, mask, q_seg,
      kv_seg);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  if (b == 0 || hkv == 0 || skv == 0) return (int)cudaGetLastError();
  if (dtype == ptt::kBF16) return dispatch_dkv<__nv_bfloat16>(p, stream);
  if (dtype == ptt::kF16) return dispatch_dkv<__half>(p, stream);
  return dispatch_dkv<float>(p, stream);
}

// As ptt_flash_dkv; dq like q.
extern "C" int ptt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* mask,
                            const void* q_seg, const void* kv_seg, void* dq,
                            int b, int sq, int skv, int hq, int hkv, int d,
                            int mb, int mh, int mask_kind, int causal,
                            float scale, int dtype, cudaStream_t stream) {
  ptt::flash::Params p = ptt::flash::make_params(
      b, sq, skv, hq, hkv, d, mb, mh, mask_kind, causal, scale, mask, q_seg,
      kv_seg);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  if (dtype == ptt::kBF16) return dispatch_dq<__nv_bfloat16>(p, stream);
  if (dtype == ptt::kF16) return dispatch_dq<__half>(p, stream);
  return dispatch_dq<float>(p, stream);
}
