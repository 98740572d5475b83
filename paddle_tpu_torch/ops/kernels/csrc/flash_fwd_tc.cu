// FlashAttention forward on the tensor cores: out = softmax(mask(q k^T *
// scale)) v per q head, and the row log-sum-exp lse, for bf16 / f16 with
// head_dim 64 or 128 (the route `flash_attention.flash_route` names "tc";
// every other dtype and head_dim takes the CUDA-core kernel of
// flash_fwd.cu).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel`
// (launched by `_flash_fwd`), whose grid walked the kv blocks of one
// (b*hq, q block) in order with m, l, acc in VMEM scratch.
//
// Bound on the H100: operations.  Causal attention at the training shape
// (b 2, s 2048, 32 q heads, d 128) does 4 * d * b * hq * s(s+1)/2 = 68.7
// GFLOP over 33.6 MB: about 2000 flops a byte, far above the card's ridge,
// so the tensor cores' 989 TFLOP/s bf16 set the bound (0.069 ms).
//
// Design: grid (b*hq, q tiles of 64 rows, heaviest first under causal),
// 128 threads = one warpgroup a block, two blocks an SM (one block's
// softmax runs while the other's products hold the tensor cores).
//  - Both products run on wgmma with f32 accumulators.  S = Q K^T is
//    m64n64k16 with Q and K read K-major from shared memory; O += P V is
//    m64nDk16 with P from registers (the S accumulator is the A fragment)
//    and V MN-major from shared memory (the transpose bit), so P never
//    goes through shared memory.
//  - P enters as two parts of the input dtype, hi = P rounded and lo = the
//    rounding error rounded (two products into O): P rounded once misses
//    the tolerances the plain version is held to.  q, k, v enter exactly.
//  - K and V tiles (64 rows) sit in a two-stage ring of 128-byte-swizzled
//    bf16/f16 tiles in shared memory, filled by 16-byte cp.async copies
//    one tile ahead of the products (wgmma.cuh); no f32 copies.  Ragged
//    rows are zero-filled by the copy and masked below.  GQA: K/V of kv
//    head h / rep, never copied.
//  - The online softmax runs on the accumulator registers: each thread
//    holds 2 rows x 16 columns of S; row max and row sum are quad
//    shuffles; the row sum stays a per-thread partial until the end; the
//    exponent is one FMA and ex2.
//  - Element masks only where they can bite: none on interior tiles; the
//    causal and ragged-kv test alone on tiles crossing the diagonal or the
//    edge; the full chain (bool or additive mask, segment ids, causal, in
//    the reference's order: flash.cuh masked_logit) when a mask or
//    segments are given.  kv tiles above the diagonal are never visited.
//  - A row with nothing to attend ends with l == 0: out 0, lse = -1e30
//    exactly, as the reference.
// Not yet used: TMA, a producer warp with setmaxnreg.  Tried and measured
// no faster on the H100 (PERF.md): the softmax of tile j overlapped
// with the P V product of tile j - 1 inside the warpgroup, 128-row tiles
// of two warpgroups sharing each K/V tile, and two q tiles a block.
#include "flash.cuh"
#include "wgmma.cuh"

namespace {

using namespace ptt::flash;
using namespace ptt::wg;

constexpr float kLog2e = 1.4426950408889634f;

// One warpgroup (128 threads) owns a tile of 64 q rows; kv tiles of 64.
constexpr int kBQ = 64, kBKV = 64, kThreads = 128;

// q tile, two stages of K and V, alignment slack
template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return (size_t)(kBQ + 4 * kBKV) * D * 2 + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_tc_kernel(const Params p) {
  constexpr int BQ = kBQ, BKV = kBKV, NT = kThreads;
  constexpr int NO = D / 2, NS = BKV / 2;  // accumulator floats a thread
  constexpr uint32_t QB = BQ * D * 2, KVB = BKV * D * 2;
  extern __shared__ char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + QB;  // stage s: K at sKV + 2 s KVB, V after it

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t4 = tid & 3;
  const int bh = blockIdx.x, batch = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  const size_t qstride = (size_t)p.hq * D, kstride = (size_t)p.hkv * D;
  const T* qb = static_cast<const T*>(p.q) + (size_t)batch * p.sq * qstride +
                (size_t)h * D;
  const T* kb = static_cast<const T*>(p.k) +
                (size_t)batch * p.skv * kstride + (size_t)hk * D;
  const T* vb = static_cast<const T*>(p.v) +
                (size_t)batch * p.skv * kstride + (size_t)hk * D;
  const char* plane = mask_plane(p, batch, h);
  const int* qs = p.q_seg ? p.q_seg + (size_t)batch * p.sq : nullptr;
  const int* ks = p.q_seg ? p.kv_seg + (size_t)batch * p.skv : nullptr;
  // no mask and no segments: only causal and the ragged kv edge mask
  const bool bare = p.mask_kind == kMaskNone && qs == nullptr;

  int n_kv = (p.skv + BKV - 1) / BKV;
  if (p.causal) n_kv = min(n_kv, (min(q0 + BQ, p.sq) - 1) / BKV + 1);

  load_tile<T, BQ, D, NT>(sQ, qb, qstride, q0, p.sq);
  if (n_kv > 0) {
    load_tile<T, BKV, D, NT>(sKV, kb, kstride, 0, p.skv);
    load_tile<T, BKV, D, NT>(sKV + KVB, vb, kstride, 0, p.skv);
  }
  cp_async_commit();

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

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

    float s[NS];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      mma_ss<BKV, 0, T>(
          s,
          desc_k(sQ + (kc >> 2) * (BQ * 128) + (kc & 3) * 32),
          desc_k(sK + (kc >> 2) * (BKV * 128) + (kc & 3) * 32), kc > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // logits: scaled, then masked where a mask can bite (one uniform
    // branch a tile, so the plain loop carries no masking code)
    const bool plain = bare && j0 + BKV <= p.skv &&
                       !(p.causal && j0 + BKV - 1 > q0);
    if (plain) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= p.scale;
    } else if (bare) {
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
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int c = 0; c < NS / 4; ++c) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * c], s[4 * c + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = safe_exp(m0, mx0), a1 = safe_exp(m1, mx1);
    m0 = mx0;
    m1 = mx1;
    // p = exp(s - m) = 2^(s log2e - m log2e), exactly 0 for a masked s
    const float nm0 = -m0 * kLog2e, nm1 = -m1 * kLog2e;
    if (plain) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = exp2f(fmaf(s[i], kLog2e, (i & 2) ? nm1 : nm0));
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = s[i] > 0.5f * kNegInf
                   ? exp2f(fmaf(s[i], kLog2e, (i & 2) ? nm1 : nm0))
                   : 0.f;
    }
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int c = 0; c < NS / 4; ++c) {
      rs0 += s[4 * c] + s[4 * c + 1];
      rs1 += s[4 * c + 2] + s[4 * c + 3];
    }
    l0 = a0 * l0 + rs0;  // per-thread partial sums; alpha is the quad's
    l1 = a1 * l1 + rs1;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? a1 : a0;

    // O += P V with P split into hi + lo parts of T (two products)
    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      acc_to_a_split<T>(s, kk, ph[kk], pl[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t dvd = desc_mn(sV + kk * 2048, BKV * 128);
      mma_rs<D, 1, T>(o, ph[kk], dvd);
      mma_rs<D, 1, T>(o, pl[kk], dvd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // n_kv == 0 leaves the q tile's copy in flight

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  T* ob = static_cast<T*>(p.out) + (size_t)batch * p.sq * qstride +
          (size_t)h * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t4;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * qstride + col) =
          pack2<T>(o[4 * c] / ls0, o[4 * c + 1] / ls0);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * qstride + col) =
          pack2<T>(o[4 * c + 2] / ls1, o[4 * c + 3] / ls1);
  }
  if (t4 == 0) {
    if (row0 < p.sq) p.lse[(size_t)bh * p.sq + row0] = m0 + logf(ls0);
    if (row1 < p.sq) p.lse[(size_t)bh * p.sq + row1] = m1 + logf(ls1);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.b * p.hq, (p.sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.d == 64) return launch<T, 64>(p, stream);
  if (p.d == 128) return launch<T, 128>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As ptt_flash_fwd (flash_fwd.cu), for bf16 / f16 (dtype 1 / 2) and d 64
// or 128 only; anything else returns cudaErrorInvalidValue unlaunched.
extern "C" int ptt_flash_fwd_tc(const void* q, const void* k, const void* v,
                                const void* mask, const void* q_seg,
                                const void* kv_seg, void* out, void* lse,
                                int b, int sq, int skv, int hq, int hkv,
                                int d, int mb, int mh, int mask_kind,
                                int causal, float scale, int dtype,
                                cudaStream_t stream) {
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
  return (int)cudaErrorInvalidValue;
}
