// K2 — blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_kernel
// (its pl.pallas_call over the body _flash_kernel).  It computes what
// _flash_kernel computes:
//
//   * scores are q.k scaled by 1/sqrt(hd) in float32;
//   * key k is allowed for query row r (position qp = r + Sk - Sq, the
//     suffix alignment) iff k < Sk, and k <= qp when causal, and
//     k > qp - window when a window is given;
//   * the running max m, denominator l and accumulator acc are float32,
//     with the NEG_INF = -1e30 guards of the Pallas kernel: a row whose
//     keys are all masked so far keeps m = NEG_INF, its probabilities
//     are 0 and its correction factor is 0;
//   * out = acc / max(l, 1e-30), cast to q's type, so a fully masked row
//     gives 0.
//
// Layout: q, o (B, H, Sq, hd); k, v (B, KV, Sk, hd), contiguous; the KV
// head of query head h is h / (H / KV), so GQA reads the KV head in
// place and never replicates it.  Types: float, bfloat16, float16; any
// hd that is a multiple of 8 (so a 16-bit row is a multiple of 16 bytes,
// as TMA wants); 16-bit tensors 16-byte aligned.  hd <= 256 runs the two
// kernels below; hd > 256 the wide kernel (last).
//
// Bound on the H100 SXM: operations.  At gemma3-1b's global layer (B=1,
// H=4, S=4096, hd=256, causal) the band holds ~8.4M allowed (q, k) pairs
// per head, 4 flops per pair and head-dim element: ~34.4 GFLOP, or ~35 us
// at the bf16 tensor-core rate of 989 TFLOP/s (~0.51 ms at float32's
// 67 TFLOP/s on FMAs), against ~21 MB of q, k, v and o, or ~6 us at
// 3.35 TB/s.  A local layer (window 512) is ~8.1 GFLOP.
//
// Design.
//
//   * Work order (both kernels).  An item is one (b, h, q tile); its work
//     is the number of key tiles in its causal/window band (a local
//     layer's item visits ~9 tiles, not S/64).  The wrapper
//     (flash_attention.py::work_order) lists the items longest band
//     first across all batches and heads; a persistent grid of
//     (#SMs x blocks per SM) blocks takes them from that list through an
//     atomic counter, so each block takes the next item when it is free
//     (greedy, longest first: modelled on 132 SMs at the global shape,
//     the last SM ends within a few tiles of the mean, where one block
//     per tile in launch order gives one SM twice the mean).
//   * bfloat16 / float16 (flash_fwd_wgmma_kernel): 160 threads, one
//     consumer warpgroup of 64 query rows and one producer warp.
//       - The producer takes an item, loads its Q tile once and its K and
//         V tiles into a ring of stages with TMA (cp.async.bulk.tensor, 3-D
//         maps {hd, S, B*heads}: a ragged tile reads zeros, never the next
//         head's rows; hd past its end reads zeros too).  Every box is 64
//         columns (128 bytes) x 64 rows with the 128-byte swizzle, so
//         hd = 256 is 4 boxes of 8 KB per tile.  Each load completes on an
//         mbarrier; the consumers free a stage on another.
//       - The consumers compute S = Q K^T with wgmma.mma_async, both
//         operands K-major in shared memory, f32 accumulators; the online
//         softmax in registers (row max and sum across the 4 lanes of a
//         row; p = 2^(s c - m c), c = scale log2(e), in one FMA and one
//         ex2.approx; the mask only on tiles that cut the diagonal, the
//         window edge or Sk; O's rescale skipped when no row's max moved);
//         P rounded to the input type in registers as the A operand of
//         O += P V, with V read MN-major through wgmma's transpose bit
//         (never transposed by hand).  Rows >= Sq are never stored.
//       - Tiles: 64 query rows (one warpgroup; an item of 128 rows would
//         leave SMs idle at B=1, 4 heads) x 64 keys.  Shared memory at
//         hd=256: Q 32 KB + 3 stages x (K 32 KB + V 32 KB) = 224 KB (+1 KB
//         to align the swizzled boxes), one block per SM; at hd <= 128, 2
//         stages, 80 KB and two blocks per SM.
//       - Tile t's S = Q K^T is issued before tile t - 1's O += P V, and
//         tile t's softmax runs while the tensor cores do that product;
//         the rescale of O waits for it.  Two P fragments (the one in
//         flight and the next) are live.
//       - Registers: the 64 x 256 f32 O accumulator is 128 a thread, S 32,
//         P 2 x 16 (214 used).  A block of 160 threads may give each
//         thread up to 255, so at hd = 256 one block runs per SM.  ptxas
//         gives every layout with two consumer warpgroups per SM (two
//         blocks, or one of 320 or 384 threads) 168 registers a thread,
//         with or without setmaxnreg: too few for O, S and P, and the
//         consumers would spill and serialize their wgmmas.
//       - What bounds it: one warpgroup per SM, so the tensor cores wait
//         while it issues S = Q K^T, rescales O and waits on barriers (only
//         the softmax overlaps P V); at B=1 the longest band (64 rows x
//         4096 keys) runs on one SM from start to end, so the launch lasts
//         at least that item's time.  On an H100 SXM (700 W) at the global
//         shape it ran at ~38% of the bf16 tensor-core rate.
//   * float32 (flash_fwd_f32_kernel): float32 products on FMAs (no TF32),
//     128 threads, 32 query rows x 32 keys per tile.
//       - S: the two halves of the block each take half of hd; a thread
//         holds 4 rows x 4 keys of S and reads Q and K rows (hd-major,
//         rows padded to hd + 4 floats so 8 lanes hit 8 bank groups) as
//         float4: 8 shared loads per 64 FMAs.  The halves' partial sums
//         meet in shared memory; one half runs the softmax and writes P
//         transposed.
//       - O: a thread holds 8 rows x hd/32 columns and reads P (2 float4,
//         broadcast across the warp) and V (float4) per key: 4 shared
//         loads per 64 FMAs at hd=256.
//       - K and V tiles come by cp.async into one buffer each, staggered:
//         K of the next tile loads during this tile's softmax and P V, V
//         of the next tile during the next Q K^T.
//       - Shared memory at hd=256: 108,288 bytes, two blocks (8 warps)
//         per SM.  What bounds it: on an H100 SXM (700 W) at the global
//         shape it ran at ~34% of the float32 FMA rate; the suspect is the
//         shared-memory port (if a 128-bit shared load takes 4 of its
//         cycles however many lanes share the address, Q K^T needs more
//         of them than FMA issue slots), then the half block that idles
//         in the softmax.
//   * head_dim > 256, any type (flash_fwd_wide_kernel): a block's q, k
//     and v tiles at such a head dim no longer fit the SM's shared memory
//     beside a ring of K/V stages, so each block owns a slice of at most
//     256 of the output's columns (hd 288: 256 + 32; 512: 256 + 256) for
//     32 query rows, and forms S = Q K^T over the whole head dim from
//     64-column slices of Q and K staged through shared memory (widened
//     to float32), then O += P V on its own columns, register-tiled FMAs
//     (128 threads, 8 S values and 64 O columns a thread; ~50 KB of
//     shared memory).  Each slice recomputes S: at hd 512 that is twice
//     the Q K^T work.  Right first; not tuned.
//
// Built by nvcc (-gencode arch=compute_90a,code=sm_90a) into a shared
// library with a plain C entry, loaded with ctypes by
// src/repro_torch/kernels/flash_attention.py.  The TMA maps are encoded on
// the host per call through cuTensorMapEncodeTiled, reached with
// cudaGetDriverEntryPoint, so the library needs no -lcuda; the grid size
// and the shared-memory attribute are set once per kernel and device, and
// the work counter resets itself at the end of each launch, so a call
// enqueues one kernel and nothing else.  The kernels launch on the
// caller's stream; the entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>
#include <utility>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The key tiles [lo, hi) that query rows [q0, q0 + rows) may see: the
// kernels' twin of flash_attention.py::band_tiles.
struct Band {
  int lo, hi;
};

__device__ __forceinline__ Band band(int q0, int rows, int Sq, int Sk,
                                     int bk, int causal, int use_window,
                                     int window) {
  const int off = Sk - Sq;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + rows + off);
  if (use_window) k_lo = max(0, q0 + off - window + 1);
  const int lo = k_lo / bk;
  return {lo, k_hi > k_lo ? (k_hi + bk - 1) / bk : lo};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The next item of the work list for this block, or -1 when none is left.
// Every block takes until it is refused, once, so the launch's last take
// of the counter is refusal number gridDim.x: it sets the counter back to
// 0 for the next launch on the stream, and the host never clears it.
__device__ __forceinline__ int take_item(const int* items, int n_items,
                                         int* next) {
  const int it = atomicAdd(next, 1);
  if (it < n_items) return items[it];
  if (it == n_items + (int)gridDim.x - 1) atomicExch(next, 0);
  return -1;
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: wgmma fed by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 64;        // query rows of an item: one warpgroup
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 160;  // warps 0-3 consumers, warp 4 the producer
constexpr int BOX = 64 * 64 * 2;   // bytes of one 64-row x 64-column box

// K/V ring depth: 3 at hd = 256 (one block per SM), 2 at hd <= 128 (two
// blocks per SM)
__host__ __device__ constexpr int stages(int hd_max) {
  return hd_max > 128 ? 3 : 2;
}

// 1024 bytes to align the swizzled boxes, Q and the K and V rings, the
// barriers
constexpr size_t smem_bytes(int hd_max) {
  return 1024 + (size_t)(hd_max / 64) * BOX * (1 + 2 * stages(hd_max)) +
         128;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// phase that never completes (a lost arrival or a short TMA copy) traps
// after 4 s, so the launch fails instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// One box (64 columns x its rows, of one head) of a 3-D map into shared
// memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After wgmma_wait: the registers an asynchronous product wrote or
// read are live here, so the compiler neither reads them earlier nor
// reuses them before.
template <int N>
__device__ __forceinline__ void hold_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void hold_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, f32) (+)= a (64 x 16) * b (16 x 64), both K-major in shared
// memory: descriptors desc_a + OFF and desc_b + OFF (in 16-byte units)
#define K2_WGMMA_SS_N64(TY, OFF) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      ".reg .b64 da, db;\n" \
      "setp.ne.b32 p, %34, 0;\n" \
      "add.s64 da, %32, %35;\n" \
      "add.s64 db, %33, %35;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, da, db, p, 1, 1, 0, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(OFF))

// d (64 x 64, f32) (+)= a (64 x 16, 16-bit pairs in registers) * b (16 x
// 64, MN-major in shared memory at desc_b + OFF: the transpose bit is set)
#define K2_WGMMA_RS_N64(TY, OFF) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      ".reg .b64 da, db;\n" \
      "setp.ne.b32 p, %37, 0;\n" \
      "add.s64 db, %36, %38;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
        "r"(scale_d), "n"(OFF))

// d (64 x 128, f32) (+)= a (64 x 16, 16-bit pairs in registers) * b (16 x
// 128, MN-major in shared memory at desc_b + OFF: the transpose bit is set)
#define K2_WGMMA_RS_N128(TY, OFF) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      ".reg .b64 da, db;\n" \
      "setp.ne.b32 p, %69, 0;\n" \
      "add.s64 db, %68, %70;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, db, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
        "r"(scale_d), "n"(OFF))

// d (64 x 256, f32) (+)= a (64 x 16, 16-bit pairs in registers) * b (16 x
// 256, MN-major in shared memory at desc_b + OFF: the transpose bit is set)
#define K2_WGMMA_RS_N256(TY, OFF) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      ".reg .b64 da, db;\n" \
      "setp.ne.b32 p, %133, 0;\n" \
      "add.s64 db, %132, %134;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, {%128, %129, %130, %131}, db, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
        "r"(scale_d), "n"(OFF))

template <typename T, int OFF>
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    K2_WGMMA_SS_N64("bf16", OFF);
  } else {
    K2_WGMMA_SS_N64("f16", OFF);
  }
}

template <typename T, int N, int OFF>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64) {
    if constexpr (bf16) {
      K2_WGMMA_RS_N64("bf16", OFF);
    } else {
      K2_WGMMA_RS_N64("f16", OFF);
    }
  } else if constexpr (N == 128) {
    if constexpr (bf16) {
      K2_WGMMA_RS_N128("bf16", OFF);
    } else {
      K2_WGMMA_RS_N128("f16", OFF);
    }
  } else {
    static_assert(N == 256, "wgmma_pv: N is 64, 128 or 256");
    if constexpr (bf16) {
      K2_WGMMA_RS_N256("bf16", OFF);
    } else {
      K2_WGMMA_RS_N256("f16", OFF);
    }
  }
}

// S (64 x 64) = Q K^T over hd in steps of 16 columns: step kk lies in box
// kk / 4 (BOX bytes apart) at byte (kk % 4) * 32 of each swizzled 128-byte
// row, in Q's tile and in K's; the offsets are immediates, so no register
// holds a descriptor per step.
template <typename T, int... KK>
__device__ __forceinline__ void qk_steps(float (&s)[BK / 2], uint64_t dq,
                                         uint64_t dk,
                                         std::integer_sequence<int, KK...>) {
  (wgmma_qk<T, ((KK / 4) * BOX + (KK % 4) * 32) / 16>(s, dq, dk, 1), ...);
}

// O (64 x HD) += P V over the tile's keys in steps of 16: V's step kk is
// two groups of 8 swizzled 128-byte rows, 1024 bytes apart (16 rows =
// 2048 bytes a step)
template <typename T, int HD, int... KK>
__device__ __forceinline__ void pv_steps(float (&o)[HD / 2],
                                         const uint32_t (&p)[sizeof...(KK)]
                                                            [4],
                                         uint64_t dv,
                                         std::integer_sequence<int, KK...>) {
  (wgmma_pv<T, HD, KK * 2048 / 16>(o, p[KK], dv, 1), ...);
}

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

// S = Q K^T for the K tile at descriptor dk, once it has landed on `full`
template <typename T, int HD>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint64_t* full,
                                         uint32_t parity, uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  mbar_wait(full, parity);
  wgmma_fence();
  qk_steps<T>(s, dq, dk, std::make_integer_sequence<int, HD / 16>{});
  wgmma_commit();
}

// O += P V for the V tile at descriptor dv, once it has landed on `full`
template <typename T, int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint64_t* full, uint32_t parity,
                                         uint64_t dv) {
  mbar_wait(full, parity);
  wgmma_fence();
  pv_steps<T, HD>(o, p, dv, std::make_integer_sequence<int, BK / 16>{});
  wgmma_commit();
}

// Whether the mask refuses some pair of the 64 x 64 tile of rows from
// position qp (the tile's first row) and keys from k0: the tile cuts the
// diagonal, the window's edge or the end of the keys.
__device__ __forceinline__ bool cuts_tile(int k0, int qp, int Sk,
                                          int causal, int use_window,
                                          int window) {
  return (causal && k0 + BK - 1 > qp) || k0 + BK > Sk ||
         (use_window && k0 < qp + BQ - window);
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; -1e29 and below: 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile's scores s (thread's rows qp0 and
// qp0 + 8, keys k0 + 8j + 2c + e): the rows' running max m (of the raw
// scores) and sum l, the factor corr that the rows' accumulators take,
// and P in the input type as wgmma's A fragments.  p = 2^(s scale log2(e)
// - m scale log2(e)) in one FMA; a masked score is NEG_INF, whose p is 0
// (as is every p of a row whose keys are all masked so far: its max
// stays NEG_INF and is taken as 0).  The mask is applied only when
// `edge` says the tile cuts the diagonal, the window's edge or Sk.
template <typename T>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&p)[BK / 16][4], bool edge, int k0, int qp0, int c, int Sk,
    int causal, int use_window, int window, float scale_log2) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = qp0 + 8 * hr;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * hr + e];
        if (edge) {
          const int kp = k0 + 8 * j + 2 * c + e;
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (!use_window || kp > qp - window);
          x = ok ? x : NEG_INF;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[hr], mx);
    const float m_scaled = m_new <= NEG_INF / 2 ? 0.f : m_new * scale_log2;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * hr + e];
        x = ex2(fmaf(x, scale_log2, -m_scaled));
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    corr[hr] = m[hr] <= NEG_INF / 2 ? 0.f : ex2((m[hr] - m_new) * scale_log2);
    l[hr] = l[hr] * corr[hr] + rs;
    m[hr] = m_new;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack2<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

}  // namespace wg

// Items of 64 query rows; HD = hd rounded up to 64, 128 or 256.
//
// Fragments: in a wgmma accumulator of 64 x N, thread (warp w, lane with
// g = lane / 4, c = lane % 4) holds rows 16w + g and 16w + g + 8, columns
// 8j + 2c and 8j + 2c + 1 of each 8-column block j: d[4j + 0, 1] on the
// first row, d[4j + 2, 3] on the second.  The A operand from registers
// has the same layout per 16-column step, so S's accumulators become P's
// A fragments without moving between threads.
template <typename T, int HD>
__global__ void __launch_bounds__(wg::THREADS, HD > 128 ? 1 : 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, const int* __restrict__ items,
                       int n_items, int* __restrict__ next, int H,
                       int group, int Sq, int Sk, int hd, int causal,
                       int use_window, int window, float scale_log2) {
  using namespace wg;
  constexpr int NB = HD / 64;          // 64-column boxes of a row
  constexpr int TILE = NB * BOX;       // bytes of a 64-row tile
  constexpr int STAGES = stages(HD);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + TILE;             // [STAGES] tiles
  uint8_t* Vs = Ks + STAGES * TILE;    // [STAGES] tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * TILE);
  uint64_t* q_free = q_full + 1;
  uint64_t* k_full = q_free + 1;       // [STAGES]
  uint64_t* v_full = k_full + STAGES;  // [STAGES]
  uint64_t* kv_free = v_full + STAGES; // [STAGES]
  volatile int* item_slot = reinterpret_cast<volatile int*>(kv_free + STAGES);

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int off = Sk - Sq;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_free, 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(kv_free + s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4) {
    // ---- producer: one lane takes items and keeps the ring full -------
    if (lane == 0) {
      const int KV = H / group;
      int stage = 0;
      uint32_t free_parity = 1, q_parity = 1;   // first waits pass
      for (;;) {
        mbar_wait(q_free, q_parity);             // Q of the last item read
        q_parity ^= 1;
        const int item = take_item(items, n_items, next);
        *item_slot = item;                       // published by q_full
        if (item < 0) {
          mbar_arrive(q_full);
          break;
        }
        const int bh = item / n_qt, qt = item - bh * n_qt;
        const int b = bh / H, kvh = b * KV + (bh - b * H) / group;
        mbar_expect_tx(q_full, TILE);
        for (int j = 0; j < NB; ++j)
          tma_load(Qs + j * BOX, &tq, q_full, j * 64, qt * BQ, bh);
        const Band bd = band(qt * BQ, min(BQ, Sq - qt * BQ), Sq, Sk, BK,
                             causal, use_window, window);
        for (int t = bd.lo; t < bd.hi; ++t) {
          mbar_wait(kv_free + stage, free_parity);
          mbar_expect_tx(k_full + stage, TILE);
          for (int j = 0; j < NB; ++j)
            tma_load(Ks + stage * TILE + j * BOX, &tk, k_full + stage,
                     j * 64, t * BK, kvh);
          mbar_expect_tx(v_full + stage, TILE);
          for (int j = 0; j < NB; ++j)
            tma_load(Vs + stage * TILE + j * BOX, &tv, v_full + stage,
                     j * 64, t * BK, kvh);
          if (++stage == STAGES) {
            stage = 0;
            free_parity ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: one warpgroup, 64 query rows ----------------------
    const int g = lane >> 2, c = lane & 3;
    const int r0 = warp * 16 + g;        // tile rows r0 and r0 + 8
    const uint64_t dq = sw128_desc(smem_addr(Qs), 16, 1024);
    int stage = 0;
    uint32_t full_parity = 0, q_parity = 0;
    for (;;) {
      mbar_wait(q_full, q_parity);
      q_parity ^= 1;
      const int item = *item_slot;
      if (item < 0) break;
      const int bh = item / n_qt, qt = item - bh * n_qt;
      const int q0 = qt * BQ;
      const Band bd = band(q0, min(BQ, Sq - q0), Sq, Sk, BK, causal,
                           use_window, window);

      float acc[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      // Tile t's S = Q K^T is issued ahead of tile t - 1's O += P V, so
      // tile t's softmax runs while the tensor cores do that product.
      // (stage, full_parity) walks the ring for K, (vstage, v_parity) one
      // tile behind it for V.  The first tile is peeled off, so that no
      // wgmma sits in a branch inside the loop.
      const uint64_t dk = sw128_desc(smem_addr(Ks), 16, 1024);
      const uint64_t dv = sw128_desc(smem_addr(Vs), BOX, 1024);
      const int qp0 = q0 + r0 + off;     // this thread's first row
      if (bd.lo < bd.hi) {
        uint32_t p[BK / 16][4];          // P of the tile whose P V is next
        float corr[2];
        {
          float s[BK / 2];
          issue_qk<T, HD>(s, k_full + stage, full_parity, dq,
                          dk + stage * TILE / 16);
          wgmma_wait<0>();
          hold_regs(s);
          if (bd.lo == bd.hi - 1) mbar_arrive(q_free);
          const int k0 = bd.lo * BK;
          online_softmax<T>(s, m, l, corr, p,
                            cuts_tile(k0, q0 + off, Sk, causal,
                                      use_window, window),
                            k0, qp0, c, Sk, causal, use_window, window,
                            scale_log2);
        }
        int vstage = stage;
        uint32_t v_parity = full_parity;
        if (++stage == STAGES) {
          stage = 0;
          full_parity ^= 1;
        }
        for (int t = bd.lo + 1; t < bd.hi; ++t) {
          float s[BK / 2];
          issue_qk<T, HD>(s, k_full + stage, full_parity, dq,
                          dk + stage * TILE / 16);
          issue_pv<T, HD>(acc, p, v_full + vstage, v_parity,
                          dv + vstage * TILE / 16);
          wgmma_wait<1>();               // S done; P V may run on
          hold_regs(s);
          if (t == bd.hi - 1) mbar_arrive(q_free);
          if (++stage == STAGES) {
            stage = 0;
            full_parity ^= 1;
          }
          uint32_t p_next[BK / 16][4];
          const int k0 = t * BK;
          online_softmax<T>(s, m, l, corr, p_next,
                            cuts_tile(k0, q0 + off, Sk, causal,
                                      use_window, window),
                            k0, qp0, c, Sk, causal, use_window, window,
                            scale_log2);
          wgmma_wait<0>();
          hold_regs(acc);
          hold_regs(p);
          mbar_arrive(kv_free + vstage);
          if (++vstage == STAGES) {
            vstage = 0;
            v_parity ^= 1;
          }
          if (corr[0] != 1.f || corr[1] != 1.f)   // a row's max moved
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
              acc[4 * j] *= corr[0];
              acc[4 * j + 1] *= corr[0];
              acc[4 * j + 2] *= corr[1];
              acc[4 * j + 3] *= corr[1];
            }
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) p[kk][e] = p_next[kk][e];
        }
        issue_pv<T, HD>(acc, p, v_full + vstage, v_parity,   // the last
                        dv + vstage * TILE / 16);            // tile's P V
        wgmma_wait<0>();
        hold_regs(acc);
        hold_regs(p);
        mbar_arrive(kv_free + vstage);
      } else {
        mbar_arrive(q_free);
      }

      T* ob = o + (size_t)bh * Sq * hd;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = q0 + r0 + 8 * hr;
        if (r < Sq) {
          const float inv = 1.f / fmaxf(l[hr], 1e-30f);
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            if (8 * j < hd)
              *reinterpret_cast<uint32_t*>(ob + (size_t)r * hd + 8 * j +
                                           2 * c) =
                  pack2<T>(acc[4 * j + 2 * hr] * inv,
                           acc[4 * j + 2 * hr + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: register-tiled FMAs
// ---------------------------------------------------------------------------

namespace f32k {

constexpr int BQ = 32;        // query rows of an item
constexpr int BK = 32;        // keys per K/V tile
constexpr int THREADS = 128;

// Qs, Ks [32][HD + 4]; Vs [32][HD]; Pt [32][36]; Sx [32][33]; rows [32]
constexpr size_t smem_bytes(int hd_max) {
  return sizeof(float) * ((size_t)(BQ + BK) * (hd_max + 4) +
                          (size_t)BK * hd_max + BK * (BQ + 4) +
                          BQ * (BK + 1) + BQ);
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace f32k

// Items of 32 query rows; HD = hd rounded up to 64, 128 or 256.
//
// Threads: for S, half = tid / 64 takes hd columns [half * hd/2,
// (half + 1) * hd/2), and within it (rg, kg) = ((tid % 64) / 8, tid % 8)
// holds rows rg + 8i and keys kg + 8j (i, j < 4); the 8 lanes of a row
// group share their Q loads and read 8 distinct K rows.  For O, warp ty
// holds rows 8ty .. 8ty + 7 and lane tx columns W tx + 32 W j (W-wide
// vectors, j < HD / (32 W)).
template <int HD>
__global__ void __launch_bounds__(f32k::THREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     const int* __restrict__ items, int n_items,
                     int* __restrict__ next, int H, int group, int Sq,
                     int Sk, int hd, int causal, int use_window, int window,
                     float scale) {
  using namespace f32k;
  constexpr int LD = HD + 4;           // Q and K row stride (floats)
  constexpr int LP = BQ + 4;           // Pt row stride
  constexpr int LS = BK + 1;           // Sx row stride
  constexpr int W = HD >= 128 ? 4 : 2; // O columns per vector
  constexpr int NV = HD / (32 * W);    // vectors of O columns a thread holds
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);   // [BQ][LD]
  float* Ks = Qs + BQ * LD;                        // [BK][LD]
  float* Vs = Ks + BK * LD;                        // [BK][HD]
  float* Pt = Vs + BK * HD;                        // [BK][LP], P transposed
  float* Sx = Pt + BK * LP;                        // [BQ][LS], upper half's S
  float* rowv = Sx + BQ * LS;                      // [BQ], corr, then l
  __shared__ int item_slot;

  const int tid = threadIdx.x;
  const int half = tid >> 6, rg = (tid & 63) >> 3, kg = tid & 7;
  const int ty = tid >> 5, tx = tid & 31;
  const int KV = H / group, n_qt = (Sq + BQ - 1) / BQ, off = Sk - Sq;
  const int chunks = hd / 4;           // 16-byte chunks of a row
  const int dh = hd / 2;               // each half's columns of hd

  for (;;) {
    if (tid == 0) item_slot = take_item(items, n_items, next);
    __syncthreads();
    const int item = item_slot;
    if (item < 0) break;
    const int bh = item / n_qt, qt = item - bh * n_qt;
    const int b = bh / H, kvh = b * KV + (bh - b * H) / group;
    const int q0 = qt * BQ, rows = min(BQ, Sq - q0);
    const float* kb = k + (size_t)kvh * Sk * hd;
    const float* vb = v + (size_t)kvh * Sk * hd;
    const Band bd = band(q0, rows, Sq, Sk, BK, causal, use_window, window);

    // rows [r0, r0 + 32) of src (n of them real, the rest zero) into dst
    // as one cp.async group (an empty group when n < 0)
    auto load_rows = [&](float* dst, int ld, const float* src, int r0,
                         int n) {
      for (int idx = tid; n >= 0 && idx < 32 * chunks; idx += THREADS) {
        const int r = idx / chunks, cc = (idx - r * chunks) * 4;
        const bool in = r < n;
        cp_async16(dst + r * ld + cc,
                   in ? src + (size_t)(r0 + r) * hd + cc : src, in);
      }
      cp_async_commit();
    };
    auto keys_of = [&](int t) {   // real keys of tile t; -1 past the band
      return t < bd.hi ? min(BK, Sk - t * BK) : -1;
    };
    load_rows(Qs, LD, q + (size_t)bh * Sq * hd, q0, rows);
    load_rows(Ks, LD, kb, bd.lo * BK, keys_of(bd.lo));
    load_rows(Vs, HD, vb, bd.lo * BK, keys_of(bd.lo));

    float acc[8][NV * W];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < NV * W; ++e) acc[i][e] = 0.f;
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
    }

    for (int t = bd.lo; t < bd.hi; ++t) {
      const int k0 = t * BK;
      cp_async_wait<1>();              // Q and K(t) here; V(t) may not be
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      const float* qr = Qs + rg * LD + half * dh;
      const float* kr = Ks + kg * LD + half * dh;
#pragma unroll 2
      for (int d = 0; d < dh; d += 4) {
        float4 a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qr + 8 * i * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bb[j] = *reinterpret_cast<const float4*>(kr + 8 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, bb[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, bb[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, bb[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, bb[j].w, s[i][j]);
          }
      }
      if (half)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Sx[(rg + 8 * i) * LS + kg + 8 * j] = s[i][j];
      __syncthreads();                 // Ks read; the partial sums stored
      load_rows(Ks, LD, kb, k0 + BK, keys_of(t + 1));

      if (!half) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + 8 * i, qp = q0 + r + off;
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kp = k0 + kg + 8 * j;
            const bool ok = kp < Sk && (!causal || kp <= qp) &&
                            (!use_window || kp > qp - window);
            const float x = (s[i][j] + Sx[r * LS + kg + 8 * j]) * scale;
            s[i][j] = ok ? x : NEG_INF;
            mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int w = 1; w < 8; w <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float m_new = fmaxf(m[i], mx);
          const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p =
                s[i][j] <= NEG_INF / 2 ? 0.f : expf(s[i][j] - m_safe);
            Pt[(kg + 8 * j) * LP + r] = p;
            rs += p;
          }
#pragma unroll
          for (int w = 1; w < 8; w <<= 1)
            rs += __shfl_xor_sync(0xffffffffu, rs, w);
          const float corr =
              m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_safe);
          l[i] = l[i] * corr + rs;
          m[i] = m_new;
          if (kg == 0) rowv[r] = corr;
        }
      }
      cp_async_wait<1>();              // V(t) here; K(t + 1) may not be
      __syncthreads();                 // and P, the corrections stored

      {
        float cr[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cr[i] = rowv[8 * ty + i];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < NV * W; ++e) acc[i][e] *= cr[i];
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 pa = *reinterpret_cast<const float4*>(Pt + kk * LP +
                                                           8 * ty);
        const float4 pb = *reinterpret_cast<const float4*>(Pt + kk * LP +
                                                           8 * ty + 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        float vv[NV * W];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const float* vp = Vs + kk * HD + W * tx + 32 * W * j;
          if constexpr (W == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vp);
            vv[4 * j] = x.x;
            vv[4 * j + 1] = x.y;
            vv[4 * j + 2] = x.z;
            vv[4 * j + 3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(vp);
            vv[2 * j] = x.x;
            vv[2 * j + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < NV * W; ++e)
            acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
      }
      __syncthreads();                 // Vs, Pt and the corrections read
      load_rows(Vs, HD, vb, k0 + BK, keys_of(t + 1));
    }
    cp_async_wait<0>();
    if (!half && kg == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) rowv[rg + 8 * i] = l[i];
    __syncthreads();

    float* ob = o + (size_t)bh * Sq * hd;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * ty + i;
      if (r < rows) {
        const float denom = fmaxf(rowv[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int col = W * tx + 32 * W * j;
          if (col < hd)
#pragma unroll
            for (int e = 0; e < W; ++e)
              ob[(size_t)(q0 + r) * hd + col + e] = acc[i][W * j + e] / denom;
        }
      }
    }
    __syncthreads();                   // rowv and item_slot read
  }
}

// ---------------------------------------------------------------------------
// head_dim > 256, any type: register-tiled FMAs over head-dim slices
// ---------------------------------------------------------------------------

namespace widek {

constexpr int BQ = 32;        // query rows of a block
constexpr int BK = 32;        // keys per tile
constexpr int DS = 64;        // head-dim slice of Q and K staged for S
constexpr int DV = 256;       // output columns a block owns
constexpr int THREADS = 128;  // thread t: row t / 4, quarter t % 4
constexpr int LDS = DS + 1;   // padded row of a Q or K slice (floats)
constexpr int LDP = BK + 1;   // padded row of P

constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * LDS + BK * LDS + BK * DV + BQ * LDP);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

}  // namespace widek

// One block per (32-row q tile, 256-column slice of the output's head
// dim, b * H + h).  Per key tile of its band: S = Q K^T over the whole
// head dim, staged through shared memory 64 columns at a time (float32,
// 16-bit inputs widened as they load); the online softmax in registers
// (a row's 4 threads meet by shuffles); P through shared memory; O += P V
// on the block's own columns.  Thread t holds S at row t / 4, keys
// 8 (t % 4) .. + 7, and O at that row, columns 16 g + 4 (t % 4) .. + 3
// (g < 16).
template <typename T>
__global__ void __launch_bounds__(widek::THREADS)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      int group, int Sq, int Sk, int hd, int causal,
                      int use_window, int window, float scale) {
  using namespace widek;
  extern __shared__ __align__(16) float wsm[];
  float* Qs = wsm;                   // (row, d) of one slice
  float* Ks = Qs + BQ * LDS;         // (key, d) of one slice
  float* Vs = Ks + BK * LDS;         // (key, column) of the block's columns
  float* Ps = Vs + BK * DV;          // (row, key)
  const int tid = threadIdx.x, r = tid >> 2, quarter = tid & 3;
  const int q0 = blockIdx.x * BQ, d0 = blockIdx.y * DV;
  const int bh = blockIdx.z, h = bh % H, b = bh / H;
  const long kvh = (long)b * (H / group) + h / group;
  const T* qp = q + (long)bh * Sq * hd;
  const T* kp = k + kvh * Sk * hd;
  const T* vp = v + kvh * Sk * hd;
  const int rows = min(BQ, Sq - q0);
  const int dv = min(DV, hd - d0);
  const int qpos = q0 + r + Sk - Sq;    // this thread's row, in key order

  float acc[DV / 4];
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  const Band bd = band(q0, rows, Sq, Sk, BK, causal, use_window, window);
  for (int t = bd.lo; t < bd.hi; ++t) {
    const int k0 = t * BK;
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    for (int ds = 0; ds < hd; ds += DS) {
      for (int e = tid; e < BQ * DS; e += THREADS) {
        const int rr = e / DS, dd = e % DS, d = ds + dd;
        Qs[rr * LDS + dd] = (rr < rows && d < hd)
                                ? to_f32(qp[(long)(q0 + rr) * hd + d])
                                : 0.f;
        Ks[rr * LDS + dd] = (k0 + rr < Sk && d < hd)
                                ? to_f32(kp[(long)(k0 + rr) * hd + d])
                                : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < DS; ++dd) {
        const float a = Qs[r * LDS + dd];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j] = fmaf(a, Ks[(quarter * 8 + j) * LDS + dd], s[j]);
      }
      __syncthreads();
    }
    // the online softmax: masked keys get probability 0
    bool ok[8];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = k0 + quarter * 8 + j;
      ok[j] = r < rows && kk < Sk && (!causal || kk <= qpos) &&
              (!use_window || kk > qpos - window);
      s[j] *= scale;
      if (ok[j]) mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      Ps[r * LDP + quarter * 8 + j] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * corr + ps;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) acc[i] *= corr;
    // V's rows of this tile, the block's columns
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int kk = e / DV, c = e % DV;
      Vs[e] = (k0 + kk < Sk && c < dv)
                  ? to_f32(vp[(long)(k0 + kk) * hd + d0 + c])
                  : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < BK; ++kk) {
      const float p = Ps[r * LDP + kk];
#pragma unroll
      for (int g = 0; g < DV / 16; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vs + kk * DV + g * 16 + quarter * 4);
        acc[g * 4 + 0] = fmaf(p, vv.x, acc[g * 4 + 0]);
        acc[g * 4 + 1] = fmaf(p, vv.y, acc[g * 4 + 1]);
        acc[g * 4 + 2] = fmaf(p, vv.z, acc[g * 4 + 2]);
        acc[g * 4 + 3] = fmaf(p, vv.w, acc[g * 4 + 3]);
      }
    }
    __syncthreads();
  }
  if (r >= rows) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* out = o + ((long)bh * Sq + q0 + r) * hd + d0;
#pragma unroll
  for (int g = 0; g < DV / 16; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = g * 16 + quarter * 4 + e;
      if (c < dv) store(out + c, acc[g * 4 + e] * inv);
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map {hd, rows, heads} of a contiguous (heads, rows, hd) tensor,
// read in 64 x 64 boxes with the 128-byte swizzle; reads past any end give
// zeros.
template <typename T>
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                int hd, int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * sizeof(T),
                                 (cuuint64_t)hd * rows * sizeof(T)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                std::is_same<T, __half>::value
                    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const int* items;
  int* next;
  int n_items, B, H, KV, Sq, Sk, hd, causal, use_window, window;
  float scale;
  cudaStream_t stream;
};

constexpr int MAX_DEVICES = 64;

// A persistent grid: as many blocks as fit on the card at once, or one
// per item when there are fewer items.  The blocks that fit are found once
// per kernel and device (fits[device], 0 until then), with the shared
// memory attribute set on that first call.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kern, int threads, size_t smem,
                              int n_items, int* fits, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (fits[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, threads, smem)) != cudaSuccess)
      return err;
    fits[dev] = sms * std::max(per_sm, 1);
  }
  *grid = std::min(n_items, fits[dev]);
  return cudaSuccess;
}

// The work list holds one item per (b, h, q tile) of the kernel's BQ rows:
// a list made for another tile size would decode to the wrong tiles.
inline bool items_fit(const Args& a, int bq) {
  return a.n_items == a.B * a.H * ((a.Sq + bq - 1) / bq);
}

template <typename T, int HD>
cudaError_t launch_wgmma(const Args& a) {
  if (!items_fit(a, wg::BQ)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // with no keys no K/V tile is ever loaded: q stands in for the maps
  const bool keys = a.Sk > 0;
  CUtensorMap tq, tk, tv;
  if (!tensor_map<T>(&tq, encode, a.q, a.hd, a.Sq, a.B * a.H) ||
      !tensor_map<T>(&tk, encode, keys ? a.k : a.q, a.hd, keys ? a.Sk : 1,
                     a.B * a.KV) ||
      !tensor_map<T>(&tv, encode, keys ? a.v : a.q, a.hd, keys ? a.Sk : 1,
                     a.B * a.KV))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<T, HD>;
  const size_t smem = wg::smem_bytes(HD);
  static int fits[MAX_DEVICES] = {};
  int grid = 0;
  cudaError_t err =
      launch_persistent(kern, wg::THREADS, smem, a.n_items, fits, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, wg::THREADS, smem, a.stream>>>(
      tq, tk, tv, static_cast<T*>(a.o), a.items, a.n_items, a.next, a.H,
      a.H / a.KV, a.Sq, a.Sk, a.hd, a.causal, a.use_window, a.window,
      a.scale * LOG2E);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  if (!items_fit(a, f32k::BQ)) return cudaErrorInvalidValue;
  auto kern = flash_fwd_f32_kernel<HD>;
  const size_t smem = f32k::smem_bytes(HD);
  static int fits[MAX_DEVICES] = {};
  int grid = 0;
  cudaError_t err =
      launch_persistent(kern, f32k::THREADS, smem, a.n_items, fits, &grid);
  if (err != cudaSuccess) return err;
  kern<<<grid, f32k::THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.items,
      a.n_items, a.next, a.H, a.H / a.KV, a.Sq, a.Sk, a.hd, a.causal,
      a.use_window, a.window, a.scale);
  return cudaGetLastError();
}

// head_dim > 256: one block per (q tile, 256-column slice, b * H + h)
template <typename T>
cudaError_t launch_wide(const Args& a) {
  static bool attr[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  auto kern = flash_fwd_wide_kernel<T>;
  const size_t smem = widek::smem_bytes();
  if (!attr[dev]) {
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return err;
    attr[dev] = true;
  }
  const dim3 grid((a.Sq + widek::BQ - 1) / widek::BQ,
                  (a.hd + widek::DV - 1) / widek::DV, a.B * a.H);
  kern<<<grid, widek::THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.H, a.H / a.KV,
      a.Sq, a.Sk, a.hd, a.causal, a.use_window, a.window, a.scale);
  return cudaGetLastError();
}

// hd rounded up to 64, 128 or 256 picks the kernel's tile width
template <typename T>
cudaError_t dispatch_hd(const Args& a) {
  if constexpr (std::is_same<T, float>::value) {
    if (a.hd <= 64) return launch_f32<64>(a);
    if (a.hd <= 128) return launch_f32<128>(a);
    return launch_f32<256>(a);
  } else {
    if (a.hd <= 64) return launch_wgmma<T, 64>(a);
    if (a.hd <= 128) return launch_wgmma<T, 128>(a);
    return launch_wgmma<T, 256>(a);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  items: the int32 work list
// (n_items codes (b * H + h) * n_q_tiles + q_tile, 32-row tiles for
// float32 and 64-row tiles otherwise; any other count is refused); next:
// an int32 counter, 0 before the first launch, that the blocks count up as
// they take items and the launch's last block sets back to 0 (so launches
// that share one counter must not overlap: one per stream).  Returns a
// cudaError_t.
int k2_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, const void* items, void* next,
                           int n_items, int dtype, int B, int H, int KV,
                           int Sq, int Sk, int hd, int causal,
                           int use_window, int window, float scale,
                           void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 || KV <= 0 || H % KV != 0 || B <= 0 ||
      Sq <= 0 || Sk < 0 || n_items <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<const int*>(items),
               static_cast<int*>(next), n_items, B, H, KV, Sq, Sk, hd,
               causal, use_window, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(a);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(a);
    default:
      return (int)dispatch_hd<__half>(a);
  }
}

// head_dim > 256 (a multiple of 8): the wide kernel, on a grid of its own
// (no work list).  dtype as above.  Returns a cudaError_t.
int k2_flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                                void* o, int dtype, int B, int H, int KV,
                                int Sq, int Sk, int hd, int causal,
                                int use_window, int window, float scale,
                                void* stream) {
  if (hd <= 256 || hd % 8 || KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 ||
      Sk < 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, nullptr, nullptr, 0, B, H, KV, Sq, Sk, hd,
               causal, use_window, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return (int)launch_wide<float>(a);
    case 1:
      return (int)launch_wide<__nv_bfloat16>(a);
    default:
      return (int)launch_wide<__half>(a);
  }
}

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
