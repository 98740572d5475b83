// Fused decode step on the tensor cores: rope(q, k) + the KV-page append
// (fp pools) or the REQUANTIZED page append (int8 / packed-int4 pools) +
// split-K paged attention for ONE decode token per slot, bf16 q at
// head_dim 64 or 128 (the route `paged_attention.decode_route` names "tc";
// every other shape takes the CUDA-core fused_decode.cu /
// fused_quant_decode.cu).  One launch per layer: the split-K partials are
// merged inside the launch.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_fused_decode_kernel`
// (B7) and `_fused_quant_decode_kernel` (B11).  On the TPU both ran the
// grid (slots, kv_heads, shards, pages_per_shard) with the page axis in
// order, a page tile DMA'd into VMEM per step and the online-softmax state
// in VMEM scratch; an XLA combine (`_flash_combine`) merged the shards.
//
// Bound on the H100: memory.  Each (slot, kv head) reads its live K and V
// pages once and rewrites one row (fp) or one page of codes and a scale
// (quantized) per pool; ~4 flops per K/V element read.  What costs time
// is not the bytes but the chain of dependent steps of each block: the
// CUDA-core kernels score a page column by column (two lanes a column, the
// head group's 4 rows at a time) and run P V over the columns in order,
// and a second launch merges the shards.  Every launch also fetches its
// instructions from device memory (between two launches the decode step
// streams a layer's weights through L2), so code that runs once costs its
// fetch: the loops that run once a launch stay rolled.
//
// Design: paged_tc.cuh's kernel with its fused front (`kFused`).  The
// front is the CUDA-core kernels' own, bit for bit: the grid (slot, kv
// head, shard) of head_dim threads, `decode_shards` shards of P table
// pages, rope in the input dtype, the write-page insert before the score,
// the spill-page zeroing of a dropped lane, and on quantized pools
// `requant_page`.  What changes is the score and the P V product (warp
// `mma.sync` over 16-column chunks, P in hi + lo bf16 parts) and the merge
// of the shards inside the launch by the last live shard's block (an
// atomic ticket a (slot, kv head)); paged_tc.cuh says why and how.
#include "paged_tc.cuh"

namespace {

using namespace ptt;
using namespace ptt::tc;

int run(const void* q, const void* k_new, const void* v_new, const void* cos,
        const void* sin, void* kpool, void* vpool, void* ksc, void* vsc,
        const void* tables, const void* lens, const void* wblk,
        const void* wable, void* m, void* l, void* acc, void* tickets,
        void* out, int b, int nh, int nkv, int hd, int nbp, int bs,
        int max_blocks, int S, int P, float scale, int dtype, int kv_format,
        cudaStream_t stream) {
  if (b == 0) return (int)cudaGetLastError();
  if (dtype != kBF16 || nh % nkv != 0 || nh / nkv > kRows || S < 1 ||
      S > kMaxLaunchShards)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const T*>(q),
                 static_cast<const T*>(k_new),
                 static_cast<const T*>(v_new),
                 static_cast<const T*>(cos),
                 static_cast<const T*>(sin),
                 static_cast<unsigned char*>(kpool),
                 static_cast<unsigned char*>(vpool),
                 static_cast<float*>(ksc),
                 static_cast<float*>(vsc),
                 static_cast<const int*>(tables),
                 static_cast<const int*>(lens),
                 static_cast<const int*>(wblk),
                 static_cast<const int*>(wable),
                 static_cast<float*>(m),
                 static_cast<float*>(l),
                 static_cast<float*>(acc),
                 static_cast<int*>(tickets),
                 static_cast<T*>(out),
                 nh,
                 nkv,
                 nbp,
                 bs,
                 max_blocks,
                 S,
                 P,
                 scale};
  return launch_format<true>(p, b, hd, kv_format, stream);
}

}  // namespace

// As ptt_fused_decode (fused_decode.cu), for bf16 (dtype 1) at hd 64 or
// 128 only (anything else returns cudaErrorInvalidValue unlaunched), plus
// tickets [b * nkv] int32, zero before the launch and left zero by it;
// the partials m, l, acc are written only for lanes whose walk spans more
// than one shard, and the output is merged in the same launch.
extern "C" int ptt_fused_decode_tc(
    const void* q, const void* k_new, const void* v_new, const void* cos,
    const void* sin, void* kpool, void* vpool, const void* tables,
    const void* lens, const void* wblk, const void* wable, void* m, void* l,
    void* acc, void* tickets, void* out, int b, int nh, int nkv, int hd,
    int nbp, int bs, int max_blocks, int S, int P, float scale, int dtype,
    cudaStream_t stream) {
  return run(q, k_new, v_new, cos, sin, kpool, vpool, nullptr, nullptr,
             tables, lens, wblk, wable, m, l, acc, tickets, out, b, nh, nkv,
             hd, nbp, bs, max_blocks, S, P, scale, dtype, kFp, stream);
}

// As ptt_fused_quant_decode (fused_quant_decode.cu), for bf16 at hd 64 or
// 128 only, with tickets and the in-launch merge as ptt_fused_decode_tc.
extern "C" int ptt_fused_quant_decode_tc(
    const void* q, const void* k_new, const void* v_new, const void* cos,
    const void* sin, void* kpool, void* vpool, void* ksc, void* vsc,
    const void* tables, const void* lens, const void* wblk,
    const void* wable, void* m, void* l, void* acc, void* tickets, void* out,
    int b, int nh, int nkv, int hd, int nbp, int bs, int max_blocks, int S,
    int P, float scale, int dtype, int kv_format, cudaStream_t stream) {
  if (kv_format != kInt8 && kv_format != kInt4)
    return (int)cudaErrorInvalidValue;
  return run(q, k_new, v_new, cos, sin, kpool, vpool, ksc, vsc, tables, lens,
             wblk, wable, m, l, acc, tickets, out, b, nh, nkv, hd, nbp, bs,
             max_blocks, S, P, scale, dtype, kv_format, stream);
}
