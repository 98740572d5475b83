// Gumbel noise of the serving sampler, bit for bit the reference's draw:
// noise[r, i] = gumbel(fold_in(fold_in(PRNGKey(0), seed[r]), pos[r]))[i].
//
// Replaces: no TPU kernel.  The reference draws this noise inside
// `jax.random.categorical` (paddle_tpu/inference/serving.py
// `_sample_tokens`), which XLA compiles into the decode program.  In eager
// PyTorch the same chain (utils/threefry.py: two fold_ins, the random
// bits, uniform, Gumbel) is ~430 separate launches a decode step, and the
// step is host-bound; this kernel is one launch.
//
// Bound on the H100: the output write (rows * n * 4 bytes) against the
// integer work of one Threefry-2x32 block (20 rounds) per element, both
// far below a microsecond of device time at batch 8 x 128256; the launch
// itself dominates.
//
// Design: one thread per kPerThread consecutive-stride elements of a row
// (grid.y = rows).  Every thread derives its row's key itself (two
// cipher blocks), so no shared memory or barrier is needed.  Element i is
// the partitionable layout's `hi ^ lo` of the cipher on the count (0, i);
// the uniform and Gumbel steps use round-to-nearest intrinsics with no
// contraction into FMAs and the accurate logf, the float ops the plain
// version's PyTorch calls make one at a time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 of the count (x0, x1) under the key (k0, k1), as
// jax._src.prng's lowering: 5 groups of 4 rounds, key injection after each.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void gumbel_kernel(const int32_t* __restrict__ seeds,
                              const int64_t* __restrict__ pos,
                              float* __restrict__ out, int n) {
  const int row = blockIdx.y;
  // fold_in(fold_in((0, 0), seed), pos): the cipher on the count (0, data)
  uint32_t k0 = 0u, k1 = (uint32_t)seeds[row];
  threefry2x32(0u, 0u, k0, k1);
  uint32_t p0 = 0u, p1 = (uint32_t)pos[row];
  threefry2x32(k0, k1, p0, p1);
  const float tiny = 1.17549435e-38f;  // finfo(float32).tiny
  float* o = out + (size_t)row * n;
  const int base = blockIdx.x * kThreads * kPerThread + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    if (i < n) {
      uint32_t y0 = 0u, y1 = (uint32_t)i;
      threefry2x32(p0, p1, y0, y1);
      const uint32_t bits = ((y0 ^ y1) >> 9) | 0x3F800000u;
      const float u = __fsub_rn(__uint_as_float(bits), 1.0f);
      // max(tiny, u * (1 - tiny) + tiny); 1 - tiny is 1.0f in float32
      const float uu = fmaxf(tiny, __fadd_rn(__fmul_rn(u, 1.0f), tiny));
      o[i] = -logf(-logf(uu));
    }
  }
}

}  // namespace

// seeds [rows] int32, pos [rows] int64, out [rows, n] float32.  Returns
// cudaGetLastError().
extern "C" int ptt_gumbel_noise(const void* seeds, const void* pos, void* out,
                                int rows, int n, cudaStream_t stream) {
  if (rows > 0 && n > 0) {
    const dim3 grid((n + kThreads * kPerThread - 1) / (kThreads * kPerThread),
                    rows);
    gumbel_kernel<<<grid, kThreads, 0, stream>>>(
        (const int32_t*)seeds, (const int64_t*)pos, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
