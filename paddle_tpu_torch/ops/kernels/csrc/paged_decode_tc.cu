// Unfused paged decode attention on the tensor cores, both walks of the
// unfused decode arms: ONE query token per slot (q already roped, the new
// token already in the pool) against its live K / V pages over fp, int8 or
// packed-int4 pools, bf16 q at head_dim 64 or 128.  One launch, no
// partials exposed.
//  - `ptt_paged_decode_tc`, the sequential route (the route
//    `paged_attention.decode_route` names "tc"; every other shape takes
//    paged_decode.cu's `ptt_paged_decode`).
//  - `ptt_flash_decode_tc`, the split-K route (the route
//    `paged_attention.flash_decode_route` names "tc": that shape and at
//    most 64 shards; every other takes paged_decode.cu's
//    `ptt_flash_decode` and its combine launch).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_paged_kernel` (B5),
// which ran the grid (slots, kv_heads, pages) with the page axis in order
// and the online-softmax state in VMEM scratch, finalized on the last
// page; and `_flash_kernel` (B6), which ran the grid (slots, kv_heads,
// shards, pages), each shard's partial (m, l, acc) written out for
// `_flash_combine` to merge in XLA.
//
// Bound on the H100: memory.  Each (slot, kv head) reads its live K and V
// rows once (2 * len * head_dim * bytes: 1 byte an element for int8, half
// for int4) plus two scales a page; q and the output are small; ~4 flops
// per K/V element read.  What held the CUDA-core kernels back was their
// chain of dependent steps: one block a (slot, kv head) walked up to 32
// pages in order (the sequential walk), or one block a shard walked its
// pages (the split-K walk), scoring each page column by column, and the
// split-K walk's partials made a round trip through device memory to a
// second launch.
//
// Design: paged_tc.cuh's kernel without its fused front (`kFused`
// false), split over the KV axis inside the launch: grid (slot, kv head,
// split), S splits of P table pages, where S comes from the table width
// (the sequential route: `paged_attention.seq_decode_splits`, not the
// split-K route's `decode_shards`, which the `flash_decode` switch sets to
// 1) or is the caller's shard count (the split-K route: the reference's
// `flash_decode_shards` or the caller's `num_shards`), and each block's
// range is cut by the device lens, so no host sync; splits past a lane's
// live pages exit at once.  Each block scores its pages with
// `mma.sync.m16n8k16`, 16 columns a warp, P in hi + lo bf16 parts; the
// last live split block of each (slot, kv head) merges the partials in
// split order with `_flash_combine`'s arithmetic (an atomic ticket):
// deterministic, and no second launch.  Page ids resolve as the
// reference's `_resolve_page` (the column clamped to the table width, the
// entry to [0, nbp - 1]).  A lane with no live column writes exactly 0.
#include "paged_tc.cuh"

namespace {

using namespace ptt;
using namespace ptt::tc;

// splits the sequential route takes: `paged_attention._SEQ_MAX_SPLITS`
constexpr int kMaxSplits = 16;
// shards the split-K route takes: `paged_attention._SPLITK_MAX_SHARDS`,
// the most the kernel's merge holds
constexpr int kMaxSplitKShards = 64;
static_assert(kMaxSplitKShards <= kMaxLaunchShards,
              "the merge keeps m and l of at most kMaxLaunchShards shards");

// the walk of either route, at most max_splits splits
int walk(const void* q, const void* kpool, const void* vpool,
         const void* ksc, const void* vsc, const void* tables,
         const void* lens, void* m, void* l, void* acc, void* tickets,
         void* out, int b, int nh, int nkv, int hd, int nbp, int bs,
         int max_blocks, int S, int P, float scale, int dtype, int kv_format,
         cudaStream_t stream, int max_splits) {
  if (b == 0) return (int)cudaGetLastError();
  if (dtype != kBF16 || nh % nkv != 0 || nh / nkv > kRows || S < 1 ||
      S > max_splits || (long)S * P < max_blocks)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const T*>(q);
  p.kpool = static_cast<unsigned char*>(const_cast<void*>(kpool));
  p.vpool = static_cast<unsigned char*>(const_cast<void*>(vpool));
  p.ksc = static_cast<float*>(const_cast<void*>(ksc));
  p.vsc = static_cast<float*>(const_cast<void*>(vsc));
  p.tables = static_cast<const int*>(tables);
  p.lens = static_cast<const int*>(lens);
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.acc_out = static_cast<float*>(acc);
  p.tickets = static_cast<int*>(tickets);
  p.out = static_cast<T*>(out);
  p.nh = nh;
  p.nkv = nkv;
  p.nbp = nbp;
  p.bs = bs;
  p.max_blocks = max_blocks;
  p.S = S;
  p.P = P;
  p.scale = scale;
  return launch_format<false>(p, b, hd, kv_format, stream);
}

}  // namespace

// q [b, nh, hd] bf16 (roped); pools [nbp, nkv, bs, hd_store] bf16
// (kv_format 0), int8 codes (1) or packed int4 (2, hd_store = hd / 2);
// scales ksc, vsc [nbp, nkv] f32 (quantized pools only, else unused);
// tables [b, max_blocks], lens [b] int32; the partials m, l [b, nkv, S,
// rep] and acc [b, nkv, S, rep, hd] f32 (written only for lanes whose walk
// spans more than one split); tickets [b * nkv] int32, zero before the
// launch and left zero by it; out [b, nh, hd].  S splits of P table pages
// (S * P >= max_blocks, S <= 16); hd 64 or 128, nh / nkv <= 8, dtype bf16
// (anything else returns cudaErrorInvalidValue unlaunched).  Returns
// cudaGetLastError().
extern "C" int ptt_paged_decode_tc(const void* q, const void* kpool,
                                   const void* vpool, const void* ksc,
                                   const void* vsc, const void* tables,
                                   const void* lens, void* m, void* l,
                                   void* acc, void* tickets, void* out, int b,
                                   int nh, int nkv, int hd, int nbp, int bs,
                                   int max_blocks, int S, int P, float scale,
                                   int dtype, int kv_format,
                                   cudaStream_t stream) {
  return walk(q, kpool, vpool, ksc, vsc, tables, lens, m, l, acc, tickets,
              out, b, nh, nkv, hd, nbp, bs, max_blocks, S, P, scale, dtype,
              kv_format, stream, kMaxSplits);
}

// The split-K route: as ptt_paged_decode_tc, with the caller's S shards of
// P = ceil(max_blocks / S) table pages, 1 <= S <= 64 (shard s attends the
// logical pages [s P, (s + 1) P), the reference's `_flash_kernel`).
extern "C" int ptt_flash_decode_tc(const void* q, const void* kpool,
                                   const void* vpool, const void* ksc,
                                   const void* vsc, const void* tables,
                                   const void* lens, void* m, void* l,
                                   void* acc, void* tickets, void* out, int b,
                                   int nh, int nkv, int hd, int nbp, int bs,
                                   int max_blocks, int S, int P, float scale,
                                   int dtype, int kv_format,
                                   cudaStream_t stream) {
  return walk(q, kpool, vpool, ksc, vsc, tables, lens, m, l, acc, tickets,
              out, b, nh, nkv, hd, nbp, bs, max_blocks, S, P, scale, dtype,
              kv_format, stream, kMaxSplitKShards);
}
