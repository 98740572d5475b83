// Hopper building blocks of the tensor-core kernels (flash_fwd_tc.cu,
// flash_bwd_tc.cu, paged_prefill_tc.cu): warpgroup matrix multiplies
// (wgmma) with their shared
// memory descriptors, 16-byte cp.async copies into the 128-byte swizzle the
// descriptors name, and the fences between them.  Header-only; sm_90a.
//
// Shared-memory tiles.  A [R rows][D cols] tile of 2-byte values is kept as
// D / 64 column blocks of R x 128 bytes (one 128-byte swizzle atom wide);
// row r of a block starts at r * 128 and its 16-byte chunk c sits at chunk
// c ^ (r % 8).  Every block starts 1024-byte aligned, so the hardware's
// swizzle (address bits 4-6 XOR bits 7-9) and ours agree.  The same tile
// serves as
//  - a K-major operand (rows = M or N, columns = K): 8-row groups 1024
//    bytes apart (SBO), one k16 step = +32 bytes inside the atom, the next
//    64 columns = the next block;
//  - an MN-major operand (rows = K, columns = N, the transpose bit set):
//    8-row groups 1024 bytes apart (SBO), the next 64 columns of N = the
//    next block (LBO = R * 128), one k16 step = +16 rows = +2048 bytes.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 64-bit wgmma matrix descriptor of a 128-byte-swizzled operand at shared
// address `addr`: leading / stride byte offsets, layout type 1 (SW128).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major operand: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16, 1024);
}
// MN-major operand whose 64-wide column blocks are `block_bytes` apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr,
                                            uint32_t block_bytes) {
  return desc(addr, block_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cp.async writes through the generic proxy; wgmma reads through the async
// proxy: this orders the two (after the wait, before the barrier)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, or a zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of one head of a BSHD tensor (row r at src + r *
// stride, D values) into the swizzled tile at shared address dst, by the
// block's NT threads; rows at or past rmax are zero-filled.
template <typename T, int R, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          size_t stride, int r0, int rmax) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert((R * CPR) % NT == 0, "whole passes");
#pragma unroll
  for (int n = 0; n < R * CPR / NT; ++n) {
    const int idx = n * NT + (int)threadIdx.x;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < rmax;
    // column block c / 8, row r, 16-byte chunk c % 8 swizzled by r % 8
    const uint32_t at =
        (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + at, src + (size_t)(ok ? r0 + r : 0) * stride + c * 8,
               ok);
  }
}

// two f32 -> one 32-bit register of two T (the first in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The m64nNk16 accumulator (N / 2 f32 a thread) of columns [16 kk, 16 kk +
// 16) is the A fragment of the next product: a[0] = (row g, cols 2t, 2t+1),
// a[1] = (row g+8, same), a[2] / a[3] = the same 8 columns on.  So a
// probability tile never leaves the registers.  It goes in two parts of T:
// hi = the values rounded to T, lo = the rounding error rounded to T; two
// products (hi, then lo) into one accumulator carry the operand to about 16
// significant bits (one rounding to bf16 alone misses the tolerances).
template <typename T, int NACC>
__device__ __forceinline__ void acc_to_a_split(const float (&s)[NACC], int kk,
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
    hi[r] = pack2<T>(x, y);
    float2 back;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      back = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[r]));
    else
      back = __half22float2(*reinterpret_cast<const __half2*>(&hi[r]));
    lo[r] = pack2<T>(x - back.x, y - back.y);
  }
}

#define PTT_ACC32                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define PTT_ACC64                                                           \
  PTT_ACC32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PTT_REG32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PTT_REG64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// A and B from shared memory; operand numbers after the NR accumulators:
// desc a, desc b, scale-d, trans-b
#define PTT_WGMMA_SS(N, NR, TY, IA, IB, IS, IT)                            \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " PTT_REG##NR ", %" IA ", %" IB ", p, 1, 1, 0, %" IT      \
               ";\n}\n"                                                   \
               : PTT_ACC##NR                                              \
               : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B))
// A from four registers; then desc b, scale-d, trans-b
#define PTT_WGMMA_RS(N, NR, TY, A0, A1, A2, A3, IB, IS, IT)                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY \
               " " PTT_REG##NR ", {%" A0 ", %" A1 ", %" A2 ", %" A3        \
               "}, %" IB ", p, 1, 1, %" IT ";\n}\n"                         \
               : PTT_ACC##NR                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(scale_d), "n"(TRANS_B))

// D[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory; scale_d 0
// overwrites D.  TRANS_B 0: B K-major, 1: MN-major.
template <int N, int TRANS_B, typename T>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "m64n64 or m64n128");
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (kBF16)
      PTT_WGMMA_SS(64, 32, "bf16", "32", "33", "34", "35");
    else
      PTT_WGMMA_SS(64, 32, "f16", "32", "33", "34", "35");
  } else {
    if constexpr (kBF16)
      PTT_WGMMA_SS(128, 64, "bf16", "64", "65", "66", "67");
    else
      PTT_WGMMA_SS(128, 64, "f16", "64", "65", "66", "67");
  }
}

// D[64 x N] += A[64 x 16] B[16 x N], A from registers (acc_to_a_split), B from
// shared memory.
template <int N, int TRANS_B, typename T>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "m64n64 or m64n128");
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  const int scale_d = 1;
  if constexpr (N == 64) {
    if constexpr (kBF16)
      PTT_WGMMA_RS(64, 32, "bf16", "32", "33", "34", "35", "36", "37", "38");
    else
      PTT_WGMMA_RS(64, 32, "f16", "32", "33", "34", "35", "36", "37", "38");
  } else {
    if constexpr (kBF16)
      PTT_WGMMA_RS(128, 64, "bf16", "64", "65", "66", "67", "68", "69",
                   "70");
    else
      PTT_WGMMA_RS(128, 64, "f16", "64", "65", "66", "67", "68", "69", "70");
  }
}

#undef PTT_WGMMA_SS
#undef PTT_WGMMA_RS

// max / sum over the 4 lanes of a quad (the lanes that share an
// accumulator row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace wg
}  // namespace ptt
