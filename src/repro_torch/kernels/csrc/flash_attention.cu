// Hand-written Hopper (sm_90a) causal flash attention of the LM prefill.
//
// flash_attention — replaces src/repro/kernels/flash_attention.py:65
//   (flash_attention_pallas, body _flash_kernel).  For every (batch * head)
//   slice and query row i it computes
//     o[i] = sum_{j <= i} softmax_j((q[i] . k[j]) * scale) v[j]
//   with scale = hd^-0.5, an fp32 online softmax (running max m and running
//   sum l, masked scores NEG_INF = -1e30 so the exponents stay finite),
//   fp32 accumulation, and the output acc / max(l, 1e-30) rounded once to
//   the input type (bf16 or fp32).  q is (BH, S, hd); k and v are
//   (BH / groups, S, hd), and q head bh reads KV head bh / groups
//   ((bh / H) * KV + (bh % H) / G for BH = B * H, H = KV * G), so GQA and
//   MQA need no expanded copy of K and V.  S is any length: keys at or past
//   S are masked, queries past S are not stored.  hd is 32, 64, 128 or 256
//   (every head dim of the repo's configs).
//
//   Bound on the H100: operations.  Causal attention does 4 * hd flops per
//   (query, key <= query) pair, 2 * hd * S * (S + 1) a head, against
//   (2 * BH + 2 * BKV) * S * hd * 2 bytes of q, k, v and o in bf16: (S + 1)
//   / 4 flops per byte for MHA whatever hd is, more for GQA and MQA.  The
//   card's bf16 tensor cores do 989 TFLOP/s against 3.35 TB/s (295 flops a
//   byte), so from S ~ 1,200 (MHA; ~660 for paligemma's MQA) the
//   operations set the bound at every hd: at S = 1966, (16, S, 128) MHA,
//   0.0163 ms; at paligemma's S = 2047, (8, S, 256) over one KV head,
//   0.0170 ms.
//
//   bf16 (the served type): flash_fwd_wgmma, Hopper's shape (wgmma fed
//   by TMA, warp-specialised, persistent).  A block is 384 threads, one
//   an SM: warpgroup 0 is the producer (one thread issues every TMA load,
//   after setmaxnreg.dec to 24 registers), warpgroups 1 and 2 compute
//   (setmaxnreg.inc to 240).  The grid is min(SMs, jobs) blocks.
//   - Units and jobs.  A unit is 64 query rows of one q head; a job is two
//     units that read the same K/V tiles, one a consumer warpgroup.  The
//     host picks the pairing from the counts: more pair jobs than SMs,
//     pairs of one causal extent (the same query tile in q heads 2p and
//     2p + 1 of a KV head under GQA and MQA; tiles t - 1 and t of a q head
//     under MHA and for the last q head of an odd group, as arctic's 7);
//     at most one pair job an SM, tile t with tile n_qt - 1 - t (every job
//     n_qt + 1 tiles of rows, so the one round is balanced); at most one
//     unit an SM, one unit a job.  Blocks walk the jobs in one static
//     order (longest first, a block's place in a round alternating ends),
//     no atomics and no split of the keys, so every output row is written
//     once in a fixed summation order and two runs give identical bits.
//   - Loads.  Q, K and V arrive by cp.async.bulk.tensor through 3-D
//     tensor maps over (heads, S, hd), encoded at each call
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
//     library needs no libcuda) and passed as __grid_constant__: boxes of
//     64 columns (128 B, 128B swizzle; hd 32: 32 columns, 64 B, 64B
//     swizzle) by 64 rows (Q) or BK rows (K, V); rows past S arrive as
//     zeros.  K and V have their own full and empty mbarriers a stage: K
//     is released after its S = Q K^T, V after its P V one tile later.
//   - S = Q K^T: wgmma m64nBKk16, Q and K both from shared memory
//     (K-major, swizzled descriptors), fp32 accumulators.  Then the mask
//     (on the diagonal's tiles and past S only, behind a warp-uniform
//     branch), the raw rows' maxima (the scale is positive, so max(s) *
//     scale = max(s * scale) exactly), and p = 2^(s * scale log2 e - m)
//     as one FFMA and one ex2.approx.ftz: the fp32 scores are scaled after
//     the product, never q rounded to bf16 after scaling (hd^-0.5 is not a
//     power of two at hd 32 or 128).  Each row lives in four lanes of one
//     warp, so its sums run in a fixed order.
//   - O += P V: wgmma m64nHDk16 with P as the register A operand (the
//     score accumulator's layout is the A fragment's: P never goes to
//     shared memory) and V from shared memory through its transpose bit.
//     P is split into a bf16 high half and a bf16 low half (p - hi,
//     rounded) and both go through the tensor cores, so P is carried to
//     about 2^-16 relative, as the Pallas kernel and the plain version
//     keep P in fp32; P rounded to bf16 alone would carry an error of 2^-9
//     on every p.  The split makes half again as many products.
//   - Overlap.  Tile kt's S = Q K^T is issued together with tile kt - 1's
//     P V, so that product runs during tile kt's softmax; and the two
//     consumer warpgroups issue their products in turns (named barriers 1
//     and 2, FlashAttention-3's ping-pong), each taking the job's tile
//     count + 1 turns, with empty turns past its unit's extent.
//   - Epilogue: O / max(l, 1e-30) rounded once to bf16, stored from the
//     registers as bf16 pairs, rows below S only.
//   Tiles: BK = 128 keys at hd 32-128, 48 at hd 256 (its O accumulator is
//   128 fp32 registers a thread; 48-key tiles leave room for the scores
//   and both halves of P beside it).  K/V stages: 4 / 4 / 2 / 3 at hd 32 /
//   64 / 128 / 256.  Dynamic shared memory (2 Q tiles, the K and V stages,
//   the barriers, 1 KB to align the tiles to the swizzle's 1024 B):
//   74,912 / 148,640 / 164,960 / 214,144 B.  Registers: 168 at launch (the
//   384-thread bound), 240 a consumer thread after setmaxnreg; spills:
//   `-Xptxas -v` in the build log (chip_smoke.py fails on a spill).
//   What the compiler needs (ptxas C7520/C7515 otherwise serialise every
//   wgmma): warp and warpgroup indices read through a shuffle, the
//   mbarrier spin inside the PTX, predicated (not branched) arrivals, and
//   every wgmma group waited for on every path (tile 0 peeled).  Tried
//   and left out: a clock-based trap in the barrier wait (its registers
//   cost 13% at hd 128), 64-key tiles at hd 256 (6% faster, but a 16 B
//   spill), three stages at hd 128 (no gain), the mask on every tile
//   without a branch (slower at hd 128).  Left for a later pass: a TMA
//   store epilogue, and the second P V product of the split (a fifth of
//   the time at hd 128, measured by leaving it out).
//
//   fp32 (a parity type, not a served one): flash_fwd_f32, the CUDA-core
//   body — one block of 8 warps per (bh, 64-query tile), fp32 Q/K/V/P
//   tiles in shared memory, a lane scoring keys lane and lane + 32 and
//   accumulating hd / 32 output columns — exact to fp32 rounding (TF32
//   would keep three digits against a 1e-4 tolerance).  q * scale is taken
//   in fp32 before the product.  At hd 256 its tiles take 213,248 B of
//   dynamic shared memory (one block an SM).
#include <cuda.h>          // CUtensorMap
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows of a unit (bf16), of a block (fp32)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, one producer warp and two consumer warpgroups.
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;   // warpgroup 0 loads, 1 and 2 compute
constexpr int CONSUMERS = 2;      // consumer warpgroups, one unit each

template <int HD>
struct WgTile {
  // Keys per K/V tile: at hd 256 the O accumulator holds 128 registers a
  // thread, and 48-key tiles leave the scores and P room beside it.
  static constexpr int BK = HD == 256 ? 48 : 128;
  static constexpr int STAGES = HD <= 64 ? 4 : HD == 128 ? 2 : 3;  // ring
  static constexpr int BOX = HD == 32 ? 32 : 64;      // columns a TMA box
  static constexpr int ROW_B = BOX * 2;               // its row: 64 or 128 B
  static constexpr uint64_t SWIZZLE = HD == 32 ? 2 : 1;  // 64B or 128B
  static constexpr int Q_BYTES = BQ * HD * 2;         // one unit's Q
  static constexpr int KV_BYTES = BK * HD * 2;        // one K (or V) tile
  static constexpr int BAR_OFF = CONSUMERS * Q_BYTES + 2 * STAGES * KV_BYTES;
  // + the mbarriers, + slack to align the tiles to the swizzle's 1024 B.
  static constexpr int SMEM = BAR_OFF + 8 * (4 * STAGES + 2 * CONSUMERS) +
                              1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Arrives on the barrier where `pred` holds: a predicated instruction,
// not a branch, so no divergent region forms around the wgmma near it.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"((uint32_t)pred)
      : "memory");
}

// Waits until the barrier has completed the phase of the given parity.
// The spin stays inside the PTX, so the compiler sees no divergent branch
// around the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 3-D tensor map (column, row, head) into shared memory; its
// bytes complete on `bar`.  Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int r, int h) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(h)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (given in bytes, kept in 16-byte units) and the
// swizzle of the tile.
template <int HD>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (WgTile<HD>::SWIZZLE << 62);
}

// Named barrier `id` over the two consumer warpgroups (256 threads): a
// warpgroup waits at it (sync) for the other's arrival (arrive).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are
// still running (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator's registers at this point of the program, so the
// compiler moves no access to them across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                      \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define WG_D32(i) \
  WG_D8(i), WG_D8((i) + 8), WG_D8((i) + 16), WG_D8((i) + 24)
#define WG_W8(i)                                                      \
  "=f"(d[(i)]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]), "=f"(d[(i) + 3]), \
      "=f"(d[(i) + 4]), "=f"(d[(i) + 5]), "=f"(d[(i) + 6]), "=f"(d[(i) + 7])
#define WG_W32(i) \
  WG_W8(i), WG_W8((i) + 8), WG_W8((i) + 16), WG_W8((i) + 24)

// S = Q K^T: d (64 x N fp32) = (wgmma_ss_init) or += (wgmma_ss) A (64 x
// 16, shared) * B (16 x N, shared), both K-major; N = 2 * size of d.  The
// init form only writes d, so the compiler keeps no earlier scores live.
__device__ __forceinline__ void wgmma_ss_init(float (&d)[24], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : WG_W8(0), WG_W8(8), WG_W8(16)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_init(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_W32(0), WG_W32(32)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "l"(da), "l"(db), "r"(1));
}


// O += P V: d (64 x N fp32) += A (64 x 16 bf16, registers) * B (16 x N,
// shared, MN-major: V's rows are keys, its columns contiguous).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D32(0), WG_D32(32), WG_D32(64), WG_D32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


#undef WG_W32
#undef WG_W8
#undef WG_D32
#undef WG_D8

// 2^x on the SFU (denormal results flush to zero: a p below 2^-126 of the
// row's largest, which is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The pair (x0, x1) (x0 in the low half, the lower column) as a bf16 high
// part and the bf16 rounding of what it leaves: x = hi + lo to ~2^-16.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// One job of a block: two units (64 query rows of one q head each) that
// read the same K/V tiles of KV head `kvh`, the first `n_kt` of them.
struct Job {
  int kvh, head[CONSUMERS], tile[CONSUMERS], n_kt;
};

// How a launch pairs its units into jobs (chosen on the host from the
// counts, so every block knows every job's units).
enum Pairing : int {
  SAME_EXTENT = 0,  // more pair jobs than SMs: pairs of one causal extent
  LONG_SHORT = 1,   // a pair job an SM at most: tile t with n_qt - 1 - t
  SINGLE = 2,       // a unit an SM at most: one unit a job
};

// The jobs in one static order.
// SAME_EXTENT, longest first: level t (from the last query tile down)
// holds the jobs whose longest unit is query tile t: first, KV head by KV
// head, the pairs of q heads (2p, 2p + 1) of a KV head at tile t (GQA and
// MQA: one causal extent); then, when a KV head has an odd number of q
// heads (MHA included), its last q head's tiles (t - 1, t) for odd t, or
// tile t alone when it is the last and even.  Jobs are read in increasing
// index, so a cursor walks the levels.
// LONG_SHORT, KV head by KV head: q heads 2p and 2p + 1 at tiles t and
// n_qt - 1 - t; an odd KV head's last q head at its tiles t and
// n_qt - 1 - t (the middle tile alone).  Every job then holds n_qt + 1
// tiles of rows, so one round of them is balanced.
// SINGLE, longest first: tile n_qt - 1 of every q head, then the tile
// before, and so on.
struct Schedule {
  int S, n_qt, n_kv, groups, pairs, odd, bk, mode;
  int t;     // the SAME_EXTENT cursor's level
  int base;  // index of its first job

  __device__ Schedule(int S_, int n_kv_, int groups_, int bk_, int mode_)
      : S(S_), n_qt((S_ + BQ - 1) / BQ), n_kv(n_kv_), groups(groups_),
        pairs(groups_ / 2), odd(groups_ & 1), bk(bk_), mode(mode_),
        t(n_qt - 1), base(0) {}

  __device__ int count(int lvl) const {
    return n_kv * pairs +
           (odd && ((lvl & 1) || lvl == n_qt - 1) ? n_kv : 0);
  }

  __device__ Job at(int j) {
    Job job;
    if (mode == SINGLE) {
      const int bh = n_kv * groups;
      job.head[0] = job.head[1] = j % bh;
      job.kvh = job.head[0] / groups;
      job.tile[0] = n_qt - 1 - j / bh;
      job.tile[1] = -1;
    } else if (mode == LONG_SHORT) {
      const int per_kv = pairs * n_qt + (odd ? (n_qt + 1) / 2 : 0);
      job.kvh = j / per_kv;
      int r = j % per_kv;
      if (r < pairs * n_qt) {
        job.head[0] = job.kvh * groups + 2 * (r / n_qt);
        job.head[1] = job.head[0] + 1;
        r %= n_qt;
      } else {
        r -= pairs * n_qt;
        job.head[0] = job.head[1] = job.kvh * groups + groups - 1;
      }
      job.tile[0] = r;
      job.tile[1] = (job.head[0] == job.head[1] && 2 * r == n_qt - 1)
                        ? -1
                        : n_qt - 1 - r;
    } else {
      while (j >= base + count(t)) {
        base += count(t);
        --t;
      }
      const int r = j - base, same = n_kv * pairs;
      if (r < same) {
        job.kvh = r / pairs;
        job.head[0] = job.kvh * groups + 2 * (r % pairs);
        job.head[1] = job.head[0] + 1;
        job.tile[0] = job.tile[1] = t;
      } else {
        job.kvh = r - same;
        job.head[0] = job.head[1] = job.kvh * groups + groups - 1;
        job.tile[0] = (t & 1) ? t - 1 : t;
        job.tile[1] = (t & 1) ? t : -1;
      }
    }
    const int last = job.tile[0] > job.tile[1] ? job.tile[0] : job.tile[1];
    job.n_kt = (min((last + 1) * BQ, S) + bk - 1) / bk;
    return job;
  }
};

// Block b's r-th job: rounds of the grid's size, the block's place in a
// round alternating ends (b, then G - 1 - b), so a block that took one of
// the longer jobs of a round takes one of the shorter of the next.
__device__ __forceinline__ int job_index(int r, int b, int G) {
  return r * G + ((r & 1) ? G - 1 - b : b);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, int S, int n_kv, int groups,
                int pairing, int n_jobs, float scale_log2) {
  using T = WgTile<HD>;
  constexpr int BK = T::BK, STAGES = T::STAGES, ROW_B = T::ROW_B;
  constexpr int PER_BOX = T::BOX / 16;  // k-steps of 16 in a box's row
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                              // [2][Q_BYTES]
  const uint32_t k_s = q_s + CONSUMERS * T::Q_BYTES;      // [STAGES][..]
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;        // [STAGES][..]
  // full_k, full_v: the stage's K (V) tile has landed (one arrival and its
  // bytes); empty_k, empty_v: the 8 consumer warps are done with it (K
  // after its S = Q K^T, V after its P V, one tile later); q_full,
  // q_empty: the same for each consumer's Q tile (its 4 warps).
  const uint32_t full_k = base + T::BAR_OFF, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES;
  const uint32_t empty_v = empty_k + 8 * STAGES;
  const uint32_t q_full = empty_v + 8 * STAGES;
  const uint32_t q_empty = q_full + 8 * CONSUMERS;

  // Warp and warpgroup indices read through a shuffle: the compiler then
  // knows them warp-uniform, and the wgmma paths are not divergent to it.
  const int warp = __shfl_sync(FULL, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 4 * CONSUMERS);
      mbar_init(empty_v + 8 * s, 4 * CONSUMERS);
    }
    for (int u = 0; u < CONSUMERS; ++u) {
      mbar_init(q_full + 8 * u, 1);
      mbar_init(q_empty + 8 * u, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int G = gridDim.x, b = blockIdx.x;
  Schedule sched(S, n_kv, groups, BK, pairing);
  if (warp < 4) {
    // Producer: one thread issues every TMA load of the block's jobs.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 0 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0, q_phase[CONSUMERS] = {0, 0};
      for (int r = 0;; ++r) {
        const int j = job_index(r, b, G);
        if (j >= n_jobs) break;
        const Job job = sched.at(j);
#pragma unroll
        for (int u = 0; u < CONSUMERS; ++u) {
          if (job.tile[u] < 0) continue;
          mbar_wait(q_empty + 8 * u, q_phase[u] ^ 1);
          q_phase[u] ^= 1;
          mbar_expect_tx(q_full + 8 * u, T::Q_BYTES);
#pragma unroll
          for (int c = 0; c < HD / T::BOX; ++c)
            tma_load(q_s + u * T::Q_BYTES + c * BQ * ROW_B, &q_map,
                     q_full + 8 * u, c * T::BOX, job.tile[u] * BQ,
                     job.head[u]);
        }
        for (int kt = 0; kt < job.n_kt; ++kt) {
          const uint32_t kd = k_s + stage * T::KV_BYTES;
          const uint32_t vd = v_s + stage * T::KV_BYTES;
          mbar_wait(empty_k + 8 * stage, phase ^ 1);
          mbar_expect_tx(full_k + 8 * stage, T::KV_BYTES);
#pragma unroll
          for (int c = 0; c < HD / T::BOX; ++c)
            tma_load(kd + c * BK * ROW_B, &k_map, full_k + 8 * stage,
                     c * T::BOX, kt * BK, job.kvh);
          mbar_wait(empty_v + 8 * stage, phase ^ 1);
          mbar_expect_tx(full_v + 8 * stage, T::KV_BYTES);
#pragma unroll
          for (int c = 0; c < HD / T::BOX; ++c)
            tma_load(vd + c * BK * ROW_B, &v_map, full_v + 8 * stage,
                     c * T::BOX, kt * BK, job.kvh);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup u computes unit u of each job.  Warp wq of it
    // owns query rows 16 wq + g and 16 wq + g + 8 of the unit; lane
    // (g, t4) holds the accumulator columns 8 j + 2 t4 and + 1.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int u = (warp >> 2) - 1, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t qa = q_s + u * T::Q_BYTES;
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    float s[BK / 2], acc[HD / 2];
    uint32_t ph[BK / 16][4], pl[BK / 16][4];  // P of the pending P V
    if (u == 1) bar_arrive(1);  // warpgroup 0 takes the first turn
    for (int r = 0;; ++r) {
      const int j = job_index(r, b, G);
      if (j >= n_jobs) break;
      const Job job = sched.at(j);
      const int tile = u ? job.tile[1] : job.tile[0];
      const int head = u ? job.head[1] : job.head[0];
      const int n_kt = tile < 0 ? 0 : (min((tile + 1) * BQ, S) + BK - 1) / BK;
      const int wrow = tile * BQ + wq * 16;  // this warp's first row
      const int row0 = wrow + g;              // and rows row0, row0 + 8
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      // S = Q K^T of the tile in `stage` on the tensor cores, both
      // operands in shared memory: issued and committed, not waited for.
      auto issue_qk = [&]() {
        const uint32_t ka = k_s + stage * T::KV_BYTES;
        wgmma_ss_init(s, gmma_desc<HD>(qa, 16, 8 * ROW_B),
                      gmma_desc<HD>(ka, 16, 8 * ROW_B));
#pragma unroll
        for (int ks = 1; ks < HD / 16; ++ks) {
          const uint32_t off = (ks / PER_BOX) * ROW_B, in = (ks % PER_BOX) * 32;
          wgmma_ss(s, gmma_desc<HD>(qa + off * BQ + in, 16, 8 * ROW_B),
                   gmma_desc<HD>(ka + off * BK + in, 16, 8 * ROW_B));
        }
        wgmma_commit();
      };
      // O += P V of the tile in `p_stage`: P, split into bf16 hi and lo
      // halves, is the register A operand (the accumulator's layout is the
      // A fragment's).  Issued and committed, not waited for.
      int p_stage = 0;
      uint32_t p_phase = 0;
      auto issue_pv = [&]() {
        const uint32_t va = v_s + p_stage * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv =
              gmma_desc<HD>(va + kk * 16 * ROW_B, BK * ROW_B, 8 * ROW_B);
          wgmma_rs(acc, ph[kk], dv);
          wgmma_rs(acc, pl[kk], dv);
        }
        wgmma_commit();
      };
      // Tile kt's scores once its S has landed: release its K, mask, online
      // softmax (scores times scale log2 e, in fp32) into s; returns the
      // rows' correction factors.  Entry 4 j + e is row row0 + 8 (e / 2),
      // key k0 + 8 j + 2 t4 + e % 2.
      auto softmax = [&](int kt, float& c0, float& c1) {
        fence_regs(s);
        __syncwarp();
        mbar_arrive_if(empty_k + 8 * stage, lane == 0);
        mbar_arrive_if(q_empty + 8 * u, lane == 0 && kt == n_kt - 1);
        // Mask where a warp's rows cross the tile's keys (the diagonal's
        // tiles) or keys pass S, behind a warp-uniform branch; then the raw
        // rows' maxima: the scale is positive, so max(s) * scale =
        // max(s * scale) exactly.
        const int k0 = kt * BK;
        const bool edge = k0 + BK - 1 > wrow || k0 + BK > S;
        const int d0 = row0 - (k0 + 2 * t4), lim = S - (k0 + 2 * t4);
        if (edge) {
#pragma unroll
          for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jj = 8 * jn + (e & 1);  // key - (k0 + 2 t4)
              const bool out = (jj > d0 + (e >> 1) * 8) | (jj >= lim);
              s[4 * jn + e] = out ? NEG_INF : s[4 * jn + e];
            }
          }
        }
        float mr0 = NEG_INF, mr1 = NEG_INF;
#pragma unroll
        for (int jn = 0; jn < BK / 8; ++jn) {
          mr0 = fmaxf(mr0, fmaxf(s[4 * jn], s[4 * jn + 1]));
          mr1 = fmaxf(mr1, fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
        }
        mr0 = fmaxf(mr0, __shfl_xor_sync(FULL, mr0, 1));
        mr0 = fmaxf(mr0, __shfl_xor_sync(FULL, mr0, 2));
        mr1 = fmaxf(mr1, __shfl_xor_sync(FULL, mr1, 1));
        mr1 = fmaxf(mr1, __shfl_xor_sync(FULL, mr1, 2));
        const float mx0 = fmaxf(m0, mr0 * scale_log2);
        const float mx1 = fmaxf(m1, mr1 * scale_log2);
        c0 = ex2(m0 - mx0);
        c1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        // p = 2^(s * scale log2 e - m): one FFMA and one ex2 a score.
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * jn + e] =
                ex2(fmaf(s[4 * jn + e], scale_log2, e < 2 ? -m0 : -m1));
          rs0 += s[4 * jn] + s[4 * jn + 1];
          rs1 += s[4 * jn + 2] + s[4 * jn + 3];
        }
        // l is this thread's share of its rows' sums (its columns); the
        // four threads of a row are added once, at the end.
        l0 = l0 * c0 + rs0;
        l1 = l1 * c1 + rs1;
      };
      // Rescale O, split P into ph / pl, and make this tile the pending
      // P V's.
      auto rescale_and_split = [&](float c0, float c1) {
#pragma unroll
        for (int jn = 0; jn < HD / 8; ++jn) {
          acc[4 * jn] *= c0;
          acc[4 * jn + 1] *= c0;
          acc[4 * jn + 2] *= c1;
          acc[4 * jn + 3] *= c1;
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], ph[kk][i],
                       pl[kk][i]);
        }
        p_stage = stage;
        p_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      };

      // Turns: the two warpgroups issue their products in alternation,
      // each taking job.n_kt + 1 turns a job (FlashAttention-3's ping-pong),
      // so one's softmax runs while the other's products occupy the tensor
      // cores.  Every mbarrier wait comes before the turn that needs it.
      auto turn_begin = [&]() { bar_sync(1 + u); };
      auto turn_end = [&]() { bar_arrive(2 - u); };
      if (n_kt > 0) {
        // Turn 0: tile 0's S = Q K^T.  Turn kt: tile kt's S = Q K^T with
        // tile kt - 1's P V, so the tensor cores also run that product
        // during this tile's softmax.  Turn n_kt: the last tile's P V.
        // Every wgmma group is waited for on every path.
        float c0, c1;
        mbar_wait(q_full + 8 * u, q_phase);
        mbar_wait(full_k + 8 * stage, phase);
        turn_begin();
        wgmma_fence();
        issue_qk();
        turn_end();
        wgmma_wait<0>();
        softmax(0, c0, c1);
        rescale_and_split(c0, c1);
        for (int kt = 1; kt < n_kt; ++kt) {
          mbar_wait(full_k + 8 * stage, phase);
          mbar_wait(full_v + 8 * p_stage, p_phase);
          turn_begin();
          wgmma_fence();
          issue_qk();
          issue_pv();
          turn_end();
          wgmma_wait<1>();
          softmax(kt, c0, c1);
          wgmma_wait<0>();
          fence_regs(acc);
          __syncwarp();
          mbar_arrive_if(empty_v + 8 * p_stage, lane == 0);
          rescale_and_split(c0, c1);
        }
        mbar_wait(full_v + 8 * p_stage, p_phase);
        turn_begin();
        wgmma_fence();
        issue_pv();
        turn_end();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        mbar_arrive_if(empty_v + 8 * p_stage, lane == 0);
      }
      // The job's tiles past this unit's extent, each released before the
      // empty turn that lets the other warpgroup reach the tile after it.
      for (int k = n_kt > 0 ? n_kt + 1 : 0; k <= job.n_kt; ++k) {
        if (k > n_kt) {
          mbar_wait(full_k + 8 * stage, phase);
          mbar_wait(full_v + 8 * stage, phase);
          __syncwarp();
          mbar_arrive_if(empty_k + 8 * stage, lane == 0);
          mbar_arrive_if(empty_v + 8 * stage, lane == 0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        turn_begin();
        turn_end();
      }
      if (n_kt == 0) continue;
      q_phase ^= 1;

      l0 += __shfl_xor_sync(FULL, l0, 1);
      l0 += __shfl_xor_sync(FULL, l0, 2);
      l1 += __shfl_xor_sync(FULL, l1, 1);
      l1 += __shfl_xor_sync(FULL, l1, 2);
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = o + ((long long)head * S + row0) * HD + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        if (row0 < S)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * jn) =
              __floats2bfloat162_rn(acc[4 * jn] / d0, acc[4 * jn + 1] / d0);
        if (row0 + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * HD + 8 * jn) =
              __floats2bfloat162_rn(acc[4 * jn + 2] / d1,
                                    acc[4 * jn + 3] / d1);
      }
    }
    if (u == 0) bar_sync(1);  // the other's last arrival: none left open
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, fp32 tiles in shared memory.
// ---------------------------------------------------------------------------

constexpr int BK32 = 64;                // keys per K/V tile
constexpr int F32_WARPS = 8;
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int ROWS = BQ / F32_WARPS;    // query rows per warp

template <int HD>
constexpr int f32_smem_floats() {
  // Qs [BQ][HD], Ks [BK32][HD + 1] (odd stride: a lane per key row, no bank
  // conflicts), Vs [BK32][HD], Ps [F32_WARPS][ROWS][BK32].
  return BQ * HD + BK32 * (HD + 1) + BK32 * HD + F32_WARPS * ROWS * BK32;
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int S,
              int groups, float scale) {
  constexpr int DPL = HD / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK32 * (HD + 1);
  float* Ps = Vs + BK32 * HD;

  const int n_qt = (S + BQ - 1) / BQ;
  const long long bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // longest first
  const int q0 = qt * BQ;
  const long long kvh = bh / groups;
  const float* qb = q + bh * (long long)S * HD;
  const float* kb = k + kvh * (long long)S * HD;
  const float* vb = v + kvh * (long long)S * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * ROWS;
  float* Pw = Ps + warp * ROWS * BK32;

  for (int e = tid; e < BQ * HD; e += F32_THREADS) {
    const int r = e / HD, c = e % HD, s = q0 + r;
    Qs[e] = s < S ? __fmul_rn(qb[(long long)s * HD + c], scale) : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
  }

  // BQ == BK32: query tile qt meets key tiles 0..qt; keys >= S are masked.
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK32;
    __syncthreads();  // Qs written; the previous tile's readers are done
    for (int e = tid; e < BK32 * HD; e += F32_THREADS) {
      const int r = e / HD, c = e % HD, s = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = kb[(long long)s * HD + c];
        vx = vb[(long long)s * HD + c];
      }
      Ks[r * (HD + 1) + c] = kx;
      Vs[r * HD + c] = vx;
    }
    __syncthreads();

    float s0[ROWS], s1[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s0[i] = s1[i] = 0.f;
    const float* ka = Ks + lane * (HD + 1);
    const float* kb2 = Ks + (lane + 32) * (HD + 1);
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float a = ka[d], b = kb2[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = Qs[(r0 + i) * HD + d];
        s0[i] = fmaf(qv, a, s0[i]);
        s1[i] = fmaf(qv, b, s1[i]);
      }
    }

    const int ja = k0 + lane, jb = k0 + lane + 32;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q0 + r0 + i;
      const float a = (ja <= qp && ja < S) ? s0[i] : NEG_INF;
      const float b = (jb <= qp && jb < S) ? s1[i] : NEG_INF;
      float mx = fmaxf(a, b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[i][t] *= corr;
      Pw[i * BK32 + lane] = pa;
      Pw[i * BK32 + lane + 32] = pb;
    }
    __syncwarp();
    for (int j = 0; j < BK32; ++j) {
      float vj[DPL];
#pragma unroll
      for (int t = 0; t < DPL; ++t) vj[t] = Vs[j * HD + lane + 32 * t];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Pw[i * BK32 + j];
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[i][t] = fmaf(p, vj[t], acc[i][t]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q0 + r0 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* out = o + (bh * S + qp) * HD;
#pragma unroll
    for (int t = 0; t < DPL; ++t) out[lane + 32 * t] = acc[i][t] / den;
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// The driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no link against libcuda.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a contiguous (heads, S, HD) bf16 tensor, boxes of `rows` rows
// by WgTile<HD>::BOX columns, swizzled as the wgmma descriptors read them;
// rows past S read as zeros.
template <int HD>
bool encode_map(CUtensorMap* map, const void* base, long long heads, int S,
                int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)S * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)WgTile<HD>::BOX, (cuuint32_t)rows,
                             1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                long long bh, int S, int groups, float scale,
                cudaStream_t stream) {
  using T = WgTile<HD>;
  const long long n_kv = bh / groups;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map<HD>(&q_map, q, bh, S, BQ) ||
      !encode_map<HD>(&k_map, k, n_kv, S, T::BK) ||
      !encode_map<HD>(&v_map, v, n_kv, S, T::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Pairs of one causal extent keep both consumer warpgroups busy on every
  // K/V tile; when the pairs fit in one round, a long unit with a short
  // one balances the SMs; when the units do, one unit an SM ends soonest.
  const long long n_qt = (S + BQ - 1) / BQ, units = bh * n_qt;
  const long long pair_jobs =
      n_kv * (n_qt * (groups / 2) + (groups & 1 ? (n_qt + 1) / 2 : 0));
  const int pairing = units <= sms ? SINGLE
                      : pair_jobs <= sms ? LONG_SHORT : SAME_EXTENT;
  const long long n_jobs = pairing == SINGLE ? units : pair_jobs;
  const int grid = (int)(n_jobs < sms ? n_jobs : sms);
  flash_fwd_wgmma<HD><<<grid, WG_THREADS, T::SMEM, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), S, (int)n_kv,
      groups, pairing, (int)n_jobs, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               long long bh, int S, int groups, float scale,
               cudaStream_t stream) {
  constexpr int bytes = f32_smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = bh * ((S + BQ - 1) / BQ);
  flash_fwd_f32<HD><<<(unsigned)n_blocks, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, groups, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           long long bh, int S, int groups, int is_bf16, float scale,
           cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, o, bh, S, groups, scale, stream)
                 : launch_f32<HD>(q, k, v, o, bh, S, groups, scale, stream);
}

}  // namespace

extern "C" {

// q, o: (bh, s, hd); k, v: (bh / groups, s, hd); all contiguous, 16-byte
// aligned, of one type (bf16 when is_bf16, else fp32).  hd in {32, 64,
// 128, 256}.  Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    long long bh, int s, int hd, int groups, int is_bf16,
                    float scale, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (bh * ((s + BQ - 1) / BQ) >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b16 = is_bf16;
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, bh, s, groups, b16, scale, st);
    case 64: return launch<64>(q, k, v, o, bh, s, groups, b16, scale, st);
    case 128: return launch<128>(q, k, v, o, bh, s, groups, b16, scale, st);
    case 256: return launch<256>(q, k, v, o, bh, s, groups, b16, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
