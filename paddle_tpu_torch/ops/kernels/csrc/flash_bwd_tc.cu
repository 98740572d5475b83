// FlashAttention backward on the tensor cores: dK/dV and dQ, for bf16 / f16
// with head_dim 64 or 128 (the route `flash_attention.flash_route` names
// "tc"; every other dtype and head_dim takes the CUDA-core kernels of
// flash_bwd.cu).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_dkv_kernel` and
// `_dq_kernel` (launched by `_flash_bwd`).  The TPU's dk/dv grid (b*hkv,
// kv blocks, rep * q blocks) walked the kv group's q blocks in order into
// VMEM accumulators; its dq grid (b*hq, q blocks, kv blocks) walked the kv
// blocks in order.
//
// Bound on the H100: operations.  Causal at the training shape (b 2,
// s 2048, 32 q heads, d 128) dK/dV does 8 * d * b * hq * s(s+1)/2 = 137
// GFLOP (s, dp, dv, dk) and dQ 6 * d * b * hq * s(s+1)/2 = 103 GFLOP (s,
// dp, dq) over about 70 MB each: tensor-core bound (0.139 / 0.104 ms at
// 989 TFLOP/s).
//
// dK/dV (FlashAttention-3's transposed form): grid (b*hkv, kv tiles of
// 64 rows, heaviest first under causal), 128 threads = one warpgroup a
// block, two blocks an SM.  The block's K and V tiles stay resident in
// shared memory (128-byte-swizzled bf16/f16, wgmma.cuh; no f32 copies); it
// walks the rep q heads of its kv group x the q tiles (64 rows) at or
// below the diagonal, with Q, dO, lse and delta in a two-stage cp.async
// ring, one tile ahead of the products.  Per q tile:
//  - S^T = K Q^T and dP^T = V dO^T on wgmma (m64n64k16, A = K or V and
//    B = Q or dO, all K-major from shared memory);
//  - P^T = safe_exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale
//    in registers; lse and delta are per column here, read from shared
//    memory; element masks only where they can bite, as in flash_fwd_tc.cu;
//  - dV += P^T dO and dK += dS^T Q on wgmma (m64nDk16) with A = P^T or
//    dS^T from registers (the accumulator layout is the A fragment) and
//    B = dO or Q MN-major from shared memory.  P^T and dS^T each enter as
//    hi + lo parts of the input dtype (two products): rounded once they
//    miss the tolerances the plain version is held to.
// The GQA group sum stays in the f32 accumulators; each dK/dV row is owned
// by one block and written once, so there are no atomics and the result
// is deterministic.
//
// dQ (the forward's shape, flash_fwd_tc.cu): grid (b*hq, q tiles of 64
// rows, heaviest first under causal), one warpgroup a block, two blocks an
// SM.  The block's Q and dO tiles stay resident in shared memory and each
// thread keeps the lse and delta of its two rows in registers; K and V
// tiles (64 rows) come through a two-stage cp.async ring, one tile ahead.
// Per kv tile up to the diagonal:
//  - S = Q K^T and dP = dO V^T on wgmma (m64n64k16, all K-major), in two
//    commit groups: P = safe_exp(S scale - lse) is computed while the dP
//    product still runs, with the forward's uniform mask branch a tile;
//  - dS = P (dP - delta) scale in registers;
//  - dQ += dS K on wgmma (m64nDk16), dS from registers as hi + lo parts of
//    the input dtype and K MN-major from shared memory (the same tile the
//    S product read K-major).
// dQ is written once in q's dtype: no atomics, deterministic.  GQA: K/V of
// kv head h / rep, never copied; the rep heads of a group read the same
// tiles through L2.
// Not yet used: TMA, a producer warp with setmaxnreg, overlap between
// products of consecutive tiles.
#include "flash.cuh"
#include "wgmma.cuh"

namespace {

using namespace ptt::flash;
using namespace ptt::wg;

// One warpgroup (128 threads) owns 64 kv rows and walks q tiles of 64.
constexpr int kBKV = 64, kBQ = 64, kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Q, dO, then lse and delta in a 1024-byte slot, so every stage's tiles
// stay 1024-byte aligned
template <int D>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  static_assert(2 * kBQ * 4 <= 1024, "lse and delta fit the slot");
  return (size_t)2 * kBQ * D * 2 + 1024;
}
// K, V, two stages, alignment slack
template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return (size_t)2 * kBKV * D * 2 + 2 * dkv_stage_bytes<D>() + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dkv_tc_kernel(const Params p) {
  constexpr int BKV = kBKV, BQ = kBQ, NT = kThreads;
  constexpr int NA = D / 2, NS = BQ / 2;  // accumulator floats a thread
  constexpr uint32_t KVB = BKV * D * 2, QB = BQ * D * 2;
  constexpr uint32_t SB = dkv_stage_bytes<D>();
  extern __shared__ char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u, sV = sK + KVB;
  const uint32_t sSt = sV + KVB;  // stage s at sSt + s SB: Q, dO, lse, delta
  const char* gSt = smem_raw + (sSt - raw);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int bkv = blockIdx.x, batch = bkv / p.hkv, hk = bkv % p.hkv;
  const int rep = p.hq / p.hkv;
  const int j0 = blockIdx.y * BKV;
  const int row0 = j0 + 16 * warp + g, row1 = row0 + 8;  // kv rows
  const size_t qstride = (size_t)p.hq * D, kstride = (size_t)p.hkv * D;
  const size_t koff = (size_t)batch * p.skv * kstride + (size_t)hk * D;
  const int* qs = p.q_seg ? p.q_seg + (size_t)batch * p.sq : nullptr;
  const int* ks = p.q_seg ? p.kv_seg + (size_t)batch * p.skv : nullptr;
  // no mask and no segments: only causal and the ragged q edge mask
  const bool bare = p.mask_kind == kMaskNone && qs == nullptr;

  load_tile<T, BKV, D, NT>(sK, static_cast<const T*>(p.k) + koff, kstride,
                           j0, p.skv);
  load_tile<T, BKV, D, NT>(sV, static_cast<const T*>(p.v) + koff, kstride,
                           j0, p.skv);

  const int n_q = (p.sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(j0 / BQ, n_q) : 0;
  const int per_head = n_q - qt0, n_it = rep * per_head;

  // Q, dO rows and their lse, delta of step `it` into stage `st`
  auto prefetch = [&](int it, int st) {
    const int h = hk * rep + it / per_head;
    const int i0 = (qt0 + it % per_head) * BQ;
    const size_t qoff = (size_t)batch * p.sq * qstride + (size_t)h * D;
    const uint32_t s = sSt + st * SB;
    load_tile<T, BQ, D, NT>(s, static_cast<const T*>(p.q) + qoff, qstride,
                            i0, p.sq);
    load_tile<T, BQ, D, NT>(s + QB, static_cast<const T*>(p.dout) + qoff,
                            qstride, i0, p.sq);
    if (tid < 2 * BQ) {
      const int c = tid % BQ;
      const bool ok = i0 + c < p.sq;
      const float* src = (tid < BQ ? p.lse_in : p.delta) +
                         ((size_t)batch * p.hq + h) * p.sq + (ok ? i0 + c : 0);
      cp_async4(s + 2 * QB + 4 * tid, src, ok);
    }
  };
  if (n_it > 0) prefetch(0, 0);
  cp_async_commit();

  float dv[NA], dk[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dv[i] = dk[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      prefetch(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int h = hk * rep + it / per_head;
    const int i0 = (qt0 + it % per_head) * BQ;
    const uint32_t sQ = sSt + (it & 1) * SB, sO = sQ + QB;
    const float* Ls =
        reinterpret_cast<const float*>(gSt + (it & 1) * SB + 2 * QB);
    const float* Es = Ls + BQ;

    float s[NS], dp[NS];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = (kc >> 2) * (BKV * 128) + (kc & 3) * 32;
      const uint32_t b = (kc >> 2) * (BQ * 128) + (kc & 3) * 32;
      mma_ss<BQ, 0, T>(s, desc_k(sK + a), desc_k(sQ + b), kc > 0);
      mma_ss<BQ, 0, T>(dp, desc_k(sV + a), desc_k(sO + b), kc > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool plain = bare && i0 + BQ <= p.sq && j0 + BKV <= p.skv &&
                       !(p.causal && i0 < j0 + BKV - 1);
    // logits, then p = exp(x - lse) = 2^(x log2e - lse log2e), exactly 0
    // where masked; one uniform branch a tile, as in the forward
    if (plain) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);  // q column
        s[i] = exp2f(fmaf(s[i] * p.scale, kLog2e, -Ls[c] * kLog2e));
      }
    } else {
      if (bare) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = i0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          s[i] = col >= p.sq || (p.causal && col < ((i & 2) ? row1 : row0))
                     ? kNegInf
                     : s[i] * p.scale;
        }
      } else {
        const char* plane = mask_plane(p, batch, h);
#pragma unroll
        for (int i = 0; i < NS; ++i)
          s[i] = masked_logit(p, s[i] * p.scale, plane, qs, ks,
                              i0 + 8 * (i >> 2) + 2 * t4 + (i & 1),
                              (i & 2) ? row1 : row0);
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = s[i] > 0.5f * kNegInf
                   ? exp2f(fmaf(s[i], kLog2e, -Ls[c] * kLog2e))
                   : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 8 * (i >> 2) + 2 * t4 + (i & 1);
      dp[i] = s[i] * (dp[i] - Es[c]) * p.scale;  // dS^T
    }
    // dV += P^T dO, dK += dS^T Q, each operand in hi + lo parts of T
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4],
        dl[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a_split<T>(s, kk, ph[kk], pl[kk]);
      acc_to_a_split<T>(dp, kk, dh[kk], dl[kk]);
    }
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t dod = desc_mn(sO + kk * 2048, BQ * 128);
      const uint64_t dqd = desc_mn(sQ + kk * 2048, BQ * 128);
      mma_rs<D, 1, T>(dv, ph[kk], dod);
      mma_rs<D, 1, T>(dv, pl[kk], dod);
      mma_rs<D, 1, T>(dk, dh[kk], dqd);
      mma_rs<D, 1, T>(dk, dl[kk], dqd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // n_it == 0 leaves the K/V copies in flight

  T* dkb = static_cast<T*>(p.dk) + koff;
  T* dvb = static_cast<T*>(p.dv) + koff;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (row0 < p.skv) {
      const size_t at = (size_t)row0 * kstride + col;
      *reinterpret_cast<uint32_t*>(dkb + at) =
          pack2<T>(dk[4 * c], dk[4 * c + 1]);
      *reinterpret_cast<uint32_t*>(dvb + at) =
          pack2<T>(dv[4 * c], dv[4 * c + 1]);
    }
    if (row1 < p.skv) {
      const size_t at = (size_t)row1 * kstride + col;
      *reinterpret_cast<uint32_t*>(dkb + at) =
          pack2<T>(dk[4 * c + 2], dk[4 * c + 3]);
      *reinterpret_cast<uint32_t*>(dvb + at) =
          pack2<T>(dv[4 * c + 2], dv[4 * c + 3]);
    }
  }
}

template <typename T, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_dkv_tc_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hkv, (p.skv + kBKV - 1) / kBKV);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dkv(const Params& p, cudaStream_t stream) {
  if (p.d == 64) return launch_dkv<T, 64>(p, stream);
  if (p.d == 128) return launch_dkv<T, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// Q, dO, two stages of K and V, alignment slack
template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * kBQ + 4 * kBKV) * D * 2 + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_dq_tc_kernel(const Params p) {
  constexpr int BQ = kBQ, BKV = kBKV, NT = kThreads;
  constexpr int NA = D / 2, NS = BKV / 2;  // accumulator floats a thread
  constexpr uint32_t QB = BQ * D * 2, KVB = BKV * D * 2;
  extern __shared__ char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u, sO = sQ + QB;
  const uint32_t sKV = sO + QB;  // stage s: K at sKV + 2 s KVB, V after it

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int bh = blockIdx.x, batch = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const size_t qstride = (size_t)p.hq * D, kstride = (size_t)p.hkv * D;
  const size_t qoff = (size_t)batch * p.sq * qstride + (size_t)h * D;
  const T* kb = static_cast<const T*>(p.k) +
                (size_t)batch * p.skv * kstride + (size_t)hk * D;
  const T* vb = static_cast<const T*>(p.v) +
                (size_t)batch * p.skv * kstride + (size_t)hk * D;
  const char* plane = mask_plane(p, batch, h);
  const int* qs = p.q_seg ? p.q_seg + (size_t)batch * p.sq : nullptr;
  const int* ks = p.q_seg ? p.kv_seg + (size_t)batch * p.skv : nullptr;
  const bool bare = p.mask_kind == kMaskNone && qs == nullptr;

  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BQ, p.sq) - 1) / BKV + 1);

  load_tile<T, BQ, D, NT>(sQ, static_cast<const T*>(p.q) + qoff, qstride,
                          q0, p.sq);
  load_tile<T, BQ, D, NT>(sO, static_cast<const T*>(p.dout) + qoff, qstride,
                          q0, p.sq);
  if (n_kv > 0) {
    load_tile<T, BKV, D, NT>(sKV, kb, kstride, 0, p.skv);
    load_tile<T, BKV, D, NT>(sKV + KVB, vb, kstride, 0, p.skv);
  }
  cp_async_commit();
  // the lse and delta of this thread's two rows; rows past sq have q = dO
  // = 0 and lse = delta = 0, so their dS is 0
  const float* lrow = p.lse_in + (size_t)bh * p.sq;
  const float* erow = p.delta + (size_t)bh * p.sq;
  const float nl0 = row0 < p.sq ? -lrow[row0] * kLog2e : 0.f;
  const float nl1 = row1 < p.sq ? -lrow[row1] * kLog2e : 0.f;
  const float e0 = row0 < p.sq ? erow[row0] : 0.f;
  const float e1 = row1 < p.sq ? erow[row1] : 0.f;

  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int j0 = it * BKV;
    if (it + 1 < n_kv) {
      const uint32_t nxt = sKV + ((it + 1) & 1) * 2 * KVB;
      load_tile<T, BKV, D, NT>(nxt, kb, kstride, j0 + BKV, p.skv);
      load_tile<T, BKV, D, NT>(nxt + KVB, vb, kstride, j0 + BKV, p.skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sKV + (it & 1) * 2 * KVB, sV = sK + KVB;

    float s[NS], dp[NS];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = (kc >> 2) * (BQ * 128) + (kc & 3) * 32;
      const uint32_t b = (kc >> 2) * (BKV * 128) + (kc & 3) * 32;
      mma_ss<BKV, 0, T>(s, desc_k(sQ + a), desc_k(sK + b), kc > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t a = (kc >> 2) * (BQ * 128) + (kc & 3) * 32;
      const uint32_t b = (kc >> 2) * (BKV * 128) + (kc & 3) * 32;
      mma_ss<BKV, 0, T>(dp, desc_k(sO + a), desc_k(sV + b), kc > 0);
    }
    wgmma_commit();
    fence_regs(dp);
    wgmma_wait<1>();
    fence_regs(s);

    // p = exp(x - lse) = 2^(x log2e - lse log2e), exactly 0 where masked;
    // one uniform branch a tile, as in the forward
    const bool plain = bare && j0 + BKV <= p.skv &&
                       !(p.causal && j0 + BKV - 1 > q0);
    if (plain) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = exp2f(fmaf(s[i] * p.scale, kLog2e, (i & 2) ? nl1 : nl0));
    } else {
      if (bare) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
          s[i] = col >= p.skv || (p.causal && col > ((i & 2) ? row1 : row0))
                     ? kNegInf
                     : s[i] * p.scale;
        }
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          s[i] = masked_logit(p, s[i] * p.scale, plane, qs, ks,
                              (i & 2) ? row1 : row0,
                              j0 + 8 * (i >> 2) + 2 * t4 + (i & 1));
      }
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = s[i] > 0.5f * kNegInf
                   ? exp2f(fmaf(s[i], kLog2e, (i & 2) ? nl1 : nl0))
                   : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < NS; ++i)
      dp[i] = s[i] * (dp[i] - ((i & 2) ? e1 : e0)) * p.scale;  // dS

    // dQ += dS K, dS in hi + lo parts of T, K MN-major
    uint32_t dh[BKV / 16][4], dl[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      acc_to_a_split<T>(dp, kk, dh[kk], dl[kk]);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t dkd = desc_mn(sK + kk * 2048, BKV * 128);
      mma_rs<D, 1, T>(dq, dh[kk], dkd);
      mma_rs<D, 1, T>(dq, dl[kk], dkd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // n_kv == 0 leaves the q tile's copies in flight

  T* dqb = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row0 * qstride + col) =
          pack2<T>(dq[4 * c], dq[4 * c + 1]);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row1 * qstride + col) =
          pack2<T>(dq[4 * c + 2], dq[4 * c + 3]);
  }
}

template <typename T, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_dq_tc_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hq, (p.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const Params& p, cudaStream_t stream) {
  if (p.d == 64) return launch_dq<T, 64>(p, stream);
  if (p.d == 128) return launch_dq<T, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As ptt_flash_dkv (flash_bwd.cu), for bf16 / f16 (dtype 1 / 2) and d 64
// or 128 only; anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int ptt_flash_dkv_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* mask,
                                const void* q_seg, const void* kv_seg,
                                void* dk, void* dv, int b, int sq, int skv,
                                int hq, int hkv, int d, int mb, int mh,
                                int mask_kind, int causal, float scale,
                                int dtype, cudaStream_t stream) {
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
  return (int)cudaErrorInvalidValue;
}

// As ptt_flash_dq (flash_bwd.cu), for bf16 / f16 (dtype 1 / 2) and d 64 or
// 128 only; anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int ptt_flash_dq_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* mask,
                               const void* q_seg, const void* kv_seg,
                               void* dq, int b, int sq, int skv, int hq,
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
  p.dq = dq;
  if (b == 0 || hq == 0 || sq == 0) return (int)cudaGetLastError();
  if (dtype == ptt::kBF16) return dispatch_dq<__nv_bfloat16>(p, stream);
  if (dtype == ptt::kF16) return dispatch_dq<__half>(p, stream);
  return (int)cudaErrorInvalidValue;
}
