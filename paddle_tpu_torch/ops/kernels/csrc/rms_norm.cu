// RMSNorm forward: out = x * rsqrt(mean(x^2) + eps) * w, row-wise.
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py `_rms_kernel` (launched by
// `_rms_fwd_pallas`), which normalised 256-row blocks resident in VMEM.
//
// Bound on the H100: memory.  Each row is read once and written once and
// the weight is read once: rows*h*2*bytes + h*bytes over 3.35 TB/s.  The
// arithmetic (3 flops an element) is far below the card's rate.  At the
// decode step's 8 rows the bound is 0.04 us: what costs time there is the
// chain of dependent steps a launch takes (device-memory round trips, the
// reduction's barriers, a cold instruction fetch); at a prefill's or a
// train step's thousands of rows, how many rows each SM keeps in flight.
//
// Design: one block a row, so the row's sum of squares is a block
// reduction and the row never leaves registers: each thread loads its
// 16-byte vectors of x and of the weight in one batch of loads (a row
// costs one device-memory round trip), accumulates the f32 sum of squares,
// and after the reduction scales the same registers and stores them.  The
// registers a thread holds are sized at compile time to the row (1, 2, 4
// or 8 vectors), so a 4096-wide bf16 row takes 2 and the SM keeps many
// rows in flight.  Rows are independent, so a ragged row count needs no
// padding (the TPU kernel padded to its 256-row block grid).  f32 math
// whatever the input type, the output rounded to the input type: the
// reference's exact formula (sums in another order).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVecPerThread = 8;  // h <= 256 * 8 * (16 / sizeof(T))

// VPT 16-byte vectors a thread at most (1, 2, 4 or kMaxVecPerThread): the
// registers a row needs, no more
template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int h, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float scratch[32];
  const int row = blockIdx.x;
  const int nvec = h / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  // the row and the weight in one batch of loads
  uint4 regs[VPT], wregs[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      regs[i] = xr[v];
      wregs[i] = wr[v];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      const T* e = reinterpret_cast<const T*>(&regs[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ptt::to_f32(e[j]);
        ss += f * f;
      }
    }
  }
  ss = ptt::block_sum(ss, scratch);
  const float inv = rsqrtf(ss / (float)h + eps);
  uint4* outr = reinterpret_cast<uint4*>(out + (size_t)row * h);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      const uint4 wv = wregs[i];
      const T* e = reinterpret_cast<const T*>(&regs[i]);
      const T* we = reinterpret_cast<const T*>(&wv);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j)
        oe[j] = ptt::from_f32<T>(ptt::to_f32(e[j]) * inv * ptt::to_f32(we[j]));
      outr[v] = o;
    }
  }
}

template <typename T, int VPT>
void launch(const void* x, const void* w, void* out, int rows, int h,
                  float eps, cudaStream_t stream) {
  rms_norm_kernel<T, VPT><<<rows, kThreads, 0, stream>>>(
      (const T*)x, (const T*)w, (T*)out, h, eps);
}

template <typename T>
void dispatch(const void* x, const void* w, void* out, int rows, int h,
                    float eps, cudaStream_t stream) {
  const int vpt = (h / (16 / (int)sizeof(T)) + kThreads - 1) / kThreads;
  auto fn = vpt <= 1   ? launch<T, 1>
            : vpt <= 2 ? launch<T, 2>
            : vpt <= 4 ? launch<T, 4>
                       : launch<T, kMaxVecPerThread>;
  fn(x, w, out, rows, h, eps, stream);
}

}  // namespace

// x [rows, h], w [h], out [rows, h]; h a multiple of 16 / sizeof(T) and at
// most 256 * 8 vectors (the wrapper checks both).  Returns cudaGetLastError().
extern "C" int ptt_rms_norm(const void* x, const void* w, void* out, int rows,
                            int h, float eps, int dtype, cudaStream_t stream) {
  if (rows > 0) {
    if (dtype == ptt::kBF16)
      dispatch<__nv_bfloat16>(x, w, out, rows, h, eps, stream);
    else
      dispatch<float>(x, w, out, rows, h, eps, stream);
  }
  return (int)cudaGetLastError();
}

