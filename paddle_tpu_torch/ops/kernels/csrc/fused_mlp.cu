// Fused post-attention layer half for the decode step: residual add, post
// RMSNorm and the SwiGLU MLP, for a decode batch's [B, h] activations.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_fused_mlp_kernel`
// (front door `fused_layer_mlp`).  On the TPU its grid walked the ffn
// dimension in order, streaming one column block of w_gate / w_up and the
// matching row block of w_down per grid step, and accumulated the down
// projection in VMEM scratch across steps.
//
// Bound on the H100: memory.  The three weight matrices are read once,
// 3 * h * F * bytes (352 MB a layer at Llama-3-8B widths in bf16, ~105 us
// at 3.35 TB/s); the activations are a few KB.  At B <= 8 rows the
// arithmetic is 2 * B flops per weight element read, far under the
// tensor-core ridge, so CUDA-core FMAs keep up and the work is to keep
// enough weight bytes in flight.
//
// Design: blocks run in parallel, so the ffn dimension is SPLIT across
// blocks instead of walked: the wrapper launches one block per SM (more
// only if a slice would pass 128 columns) and block i owns an even share,
// a multiple of 4, of the columns of w_gate / w_up and the same rows of
// w_down (132 slices of 108-112 columns at F = 14336 on an H100).  Each
// block of 16 warps
//  1. recomputes h1 = x + attn_y (rounded to T) and the f32 RMSNorm of h1,
//     rounded to T, for its rows into shared memory as f32 [h][8], so one
//     k step's eight row values are two broadcast 16-byte loads (the
//     activations are tiny next to the block's weight slice, so every
//     block recomputing them beats a second launch);
//  2. computes its columns of g = xn @ w_gate and u = xn @ w_up with
//     f32 accumulation: lane l owns columns 4l..4l+3 (8-byte loads, a warp
//     reads 256 contiguous bytes of a weight row), warp w a sixteenth of
//     the h rows; the sixteen warp partials are added in a fixed order
//     through shared memory (reusing the xn buffer) and rounded to T;
//  3. act = T(silu_f32(g) * u_f32), the swiglu formula;
//  4. writes its f32 partial act @ w_down[slice]: thread t owns output
//     columns 8t..8t+7 (16-byte loads of each w_down row).
// A second small kernel sums the partials over the blocks in block order,
// rounds to T, and writes h1.  No atomics, so the result is
// deterministic.  y stays the un-reduced down projection: the caller owns
// the residual add (and, later, the tensor-parallel all-reduce).
// Not yet used: tensor cores, TMA, cp.async staging of the weight stream.
#include "common.cuh"

namespace {

constexpr int kRows = 8;      // rows a launch takes (the wrapper chunks B)
constexpr int kCols = 128;    // widest ffn slice a block owns: 32 lanes x 4
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;

// four consecutive elements as f32 (8-byte load for bf16, 16 for f32)
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
__global__ void __launch_bounds__(kThreads, 1)
    mlp_partial_kernel(const T* __restrict__ x, const T* __restrict__ ay,
                       const T* __restrict__ nw, const T* __restrict__ wg,
                       const T* __restrict__ wu, const T* __restrict__ wd,
                       float* __restrict__ partial, int B, int h, int F,
                       float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  // xs: [h][kRows] f32 normalised rows; after step 2 the same bytes hold
  // red: [kWarps][2][kRows][kCols] f32 partial dot products
  float* xs = reinterpret_cast<float*>(smem);
  float* red = xs;
  const size_t big = max((size_t)h * kRows, (size_t)kWarps * 2 * kRows * kCols);
  float* act = xs + big;                 // [kCols][kRows]
  float* scratch = act + kCols * kRows;  // [32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's slice [f0, f0 + width) of the F / 4 column groups of 4
  const int groups = F / 4;
  const int f0 = (int)((long long)blockIdx.x * groups / gridDim.x) * 4;
  const int width =
      (int)((long long)(blockIdx.x + 1) * groups / gridDim.x) * 4 - f0;

  // 1. h1 = T(x + attn_y); xn = T(h1 * rsqrt(mean(h1^2) + eps) * w)
  for (int bi = 0; bi < kRows; ++bi) {
    if (bi >= B) {  // padding rows: zeros (never stored)
      for (int k = tid; k < h; k += kThreads) xs[(size_t)k * kRows + bi] = 0.f;
      continue;
    }
    float ss = 0.f;
    for (int k = tid; k < h; k += kThreads) {
      const size_t i = (size_t)bi * h + k;
      const float v =
          ptt::round_to<T>(ptt::to_f32(x[i]) + ptt::to_f32(ay[i]));
      xs[(size_t)k * kRows + bi] = v;
      ss += v * v;
    }
    ss = ptt::block_sum(ss, scratch);
    const float inv = rsqrtf(ss / (float)h + eps);
    for (int k = tid; k < h; k += kThreads) {
      float* e = &xs[(size_t)k * kRows + bi];
      *e = ptt::round_to<T>(*e * inv * ptt::to_f32(nw[k]));
    }
  }
  __syncthreads();

  // 2. this block's columns of xn @ w_gate and xn @ w_up (lanes past the
  //    slice's width idle)
  float ag[4][kRows], au[4][kRows];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) ag[c][r] = au[c][r] = 0.f;
  if (4 * lane < width) {
    const int kchunk = (h + kWarps - 1) / kWarps;
    const int k0 = warp * kchunk, k1 = min(h, k0 + kchunk);
    const T* gp = wg + f0 + 4 * lane;
    const T* up = wu + f0 + 4 * lane;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float g4[4], u4[4];
      load4(gp + (size_t)k * F, g4);
      load4(up + (size_t)k * F, u4);
      const float4 xa = *reinterpret_cast<const float4*>(&xs[(size_t)k * kRows]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&xs[(size_t)k * kRows + 4]);
      const float xv[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ag[c][r] += xv[r] * g4[c];
          au[c][r] += xv[r] * u4[c];
        }
    }
  }
  __syncthreads();  // every warp is done reading xs: reuse it as red
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      red[(((size_t)warp * 2 + 0) * kRows + r) * kCols + 4 * lane + c] = ag[c][r];
      red[(((size_t)warp * 2 + 1) * kRows + r) * kCols + 4 * lane + c] = au[c][r];
    }
  __syncthreads();

  // 3. act = T(silu(g) * u), g and u summed over the warps in order and
  //    rounded to T first
  for (int i = tid; i < kRows * width; i += kThreads) {
    const int r = i / width, c = i % width;
    float g = 0.f, u = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      g += red[(((size_t)w * 2 + 0) * kRows + r) * kCols + c];
      u += red[(((size_t)w * 2 + 1) * kRows + r) * kCols + c];
    }
    g = ptt::round_to<T>(g);
    u = ptt::round_to<T>(u);
    act[c * kRows + r] = ptt::round_to<T>(g / (1.f + expf(-g)) * u);
  }
  __syncthreads();

  // 4. f32 partial of act @ w_down[f0:f0+width] for every output column
  for (int n0 = 8 * tid; n0 < h; n0 += 8 * kThreads) {
    float acc[8][kRows];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[j][r] = 0.f;
    const T* dp = wd + (size_t)f0 * h + n0;
#pragma unroll 4
    for (int c = 0; c < width; ++c) {
      float w8[8];
      load4(dp + (size_t)c * h, w8);
      load4(dp + (size_t)c * h + 4, w8 + 4);
      const float4 aa = *reinterpret_cast<const float4*>(&act[c * kRows]);
      const float4 ab = *reinterpret_cast<const float4*>(&act[c * kRows + 4]);
      const float av[kRows] = {aa.x, aa.y, aa.z, aa.w, ab.x, ab.y, ab.z, ab.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[j][r] += av[r] * w8[j];
    }
    for (int r = 0; r < B; ++r) {
      float4* out = reinterpret_cast<float4*>(
          partial + ((size_t)blockIdx.x * B + r) * h + n0);
      out[0] = make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
      out[1] = make_float4(acc[4][r], acc[5][r], acc[6][r], acc[7][r]);
    }
  }
}

// y = T(sum over blocks of the partials, in block order); h1 = T(x + attn_y)
template <typename T>
__global__ void mlp_reduce_kernel(const T* __restrict__ x,
                                  const T* __restrict__ ay,
                                  const float* __restrict__ partial,
                                  T* __restrict__ h1, T* __restrict__ y,
                                  int n, int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < nsplit; ++p) s += partial[(size_t)p * n + i];
  y[i] = ptt::from_f32<T>(s);
  h1[i] = ptt::from_f32<T>(ptt::to_f32(x[i]) + ptt::to_f32(ay[i]));
}

template <typename T>
int launch(const void* x, const void* ay, const void* nw, const void* wg,
           const void* wu, const void* wd, void* h1, void* y, float* partial,
           int B, int h, int F, int nsplit, float eps, cudaStream_t stream) {
  const size_t big = max((size_t)h * kRows, (size_t)kWarps * 2 * kRows * kCols);
  const size_t smem = (big + kCols * kRows + 32) * sizeof(float);
  auto kernel = mlp_partial_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<nsplit, kThreads, smem, stream>>>(
      (const T*)x, (const T*)ay, (const T*)nw, (const T*)wg, (const T*)wu,
      (const T*)wd, partial, B, h, F, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = B * h;
  mlp_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      (const T*)x, (const T*)ay, partial, (T*)h1, (T*)y, n, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// x, attn_y [B, h]; norm_w [h]; w_gate, w_up [h, F]; w_down [F, h];
// outputs h1, y [B, h]; partial [nsplit, B, h] f32 scratch.  B <= 8,
// F % 4 == 0, F <= 128 * nsplit <= 32 * F, h % 8 == 0 and h * 32 bytes of
// shared memory (the wrapper checks).  Returns cudaGetLastError().
extern "C" int ptt_fused_mlp(const void* x, const void* ay, const void* nw,
                             const void* wg, const void* wu, const void* wd,
                             void* h1, void* y, void* partial, int B, int h,
                             int F, int nsplit, float eps, int dtype,
                             cudaStream_t stream) {
  if (B == 0) return (int)cudaGetLastError();
  auto fn = dtype == ptt::kBF16 ? launch<__nv_bfloat16> : launch<float>;
  return fn(x, ay, nw, wg, wu, wd, h1, y, (float*)partial, B, h, F, nsplit,
            eps, stream);
}
