// K3 — the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_kernel (its
// pl.pallas_call over the body _ssd_kernel).  It computes what
// _ssd_kernel computes, without the D*x skip (the wrapper
// repro_torch.kernels.ops.ssd_scan adds it).  Per (b, h) the sequence is
// cut into chunks of q steps; within a chunk a = cumsum(dt * A)
// (float32, a <= 0), and with h_prev the (N, P) float32 state entering
// the chunk (zero for the first):
//
//   y_i = sum_{j <= i, same chunk} (C_i . B_j) e^{a_i - a_j} dt_j x_j
//         + e^{a_i} C_i . h_prev
//   h  <- h_prev e^{a_last} + sum_j e^{a_last - a_j} dt_j B_j x_j^T
//
// y is written in x's type.  Steps past S (the last chunk may be short)
// are masked in the kernels: they add nothing, as the Pallas kernel's
// zero padding (dt = 0) adds nothing, and no padded copy is made.  The
// output does not depend on q but for rounding; the wrapper takes
// q = min(chunk, S, 256), the chunk the output pass holds C.B^T for.
//
// Layout: x, y (B, S, H, P); dt (B, S, H) float32 (post-softplus);
// A (H,) float32 (negative); Bm, Cm (B, S, N), one group shared by all
// heads; all contiguous.  x, Bm, Cm share one type: float32, bfloat16 or
// float16.  Any N <= 256, P, S.
//
// Bound on the H100 SXM: operations in float32, bytes in 16 bits.  At
// mamba2-130m's shape (B=2, S=4096, H=24, P=64, N=128, chunk 256) the
// chunked algorithm needs ~9.6 GFLOP (6.8 at its best chunk, 16): ~0.10
// ms at the float32 FMA rate of 67 TFLOP/s, against ~110 MB (float32)
// or ~55 MB (bfloat16) of x, B, C, dt and y, 0.033 / 0.017 ms at 3.35
// TB/s.
//
// What held the first version (four grids of float32 FMAs) at ~10x its
// bound: C.B^T formed again for every head (24 times at mamba2-130m,
// ~2/3 of the output pass's FMAs), every product on FMAs from shared
// memory (25% of the FMA rate), 16-bit inputs widened as they load.
//
// Design.  The Pallas grid walks the chunks of one (b, h) in order on
// one core, carrying the state in VMEM.  On the card that is 48
// sequences of 16 chunks at mamba2-130m's shape, too few to fill 132
// SMs, so the work is the SSD split of models/ssm.py::ssd_chunked, in
// five launches on the caller's stream:
//
//   1. ssd_cumsum: one warp per (b, h, chunk) scans dt * A (float32,
//      32 steps per shuffle scan) into acum (B, H, nc, q) and a_last
//      (B, H, nc);
//   2. ssd_chunk_state: one block per (b, h, chunk, 128 x 64 tile of the
//      (N, P) state) forms the chunk's own contribution
//      B^T (w o x), w_j = e^{a_last - a_j} dt_j, in float32 scratch
//      (B, H, nc, N, P);
//   3. ssd_chunk_cb: one block per (b, chunk, causal 64 x 64 tile) forms
//      C.B^T ONCE for all heads (one group), in float32 scratch
//      (B, nc, q, q): 8.4 MB at mamba2-130m's shape, read back from L2;
//   4. ssd_state_scan: one thread per (b, h, state element) walks the
//      chunks in order, h <- h e^{a_last} + contribution, and writes the
//      state entering each chunk over that chunk's contribution;
//   5. ssd_chunk_output: one block per (b, h, chunk, 64-row tile of the
//      chunk): per 64 columns of P, e^{a_i} C_i . h_prev, plus the
//      scores (C.B^T masked before the exp: above the diagonal a_i - a_j
//      > 0 could overflow; then e^{a_i - a_j} dt_j), formed in registers
//      from the C.B^T tile as the A operand of scores . x.  Four warps
//      and ~55 KB of shared memory (float32) a block, so several blocks
//      share an SM and hide each other's loads (3072 blocks at
//      mamba2-130m's shape).
//
// Every product runs on the tensor cores with mma.sync, float32
// accumulators, each warp 16 rows of its block's tile (the state pass:
// eight warps, 64 columns each; C.B^T: eight warps, 32 columns each; the
// output: four warps, 64 columns each):
//   * 16-bit inputs: m16n8k16 in their own type.  A product with a
//     float32 operand (the scores, w o x, h_prev) takes it as two 16-bit
//     halves, hi + lo (lo = the rounding residual), in two products, so
//     that it keeps ~16 bits more than one rounding would;
//   * float32 inputs: 3xTF32 on m16n8k8 (each operand split into TF32 hi
//     and lo; a_hi b_lo + a_lo b_hi + a_hi b_hi), as K1's products are.
// Tiles of x, B and C (and h_prev in float32) come to shared memory by
// cp.async, 16 bytes at a time, zero-filled past the edges; operands
// whose rows run along K are read by ldmatrix (with .trans in 16 bits,
// where a tile runs the other way), float32 ones that run the other way
// by single shared loads from rows padded to 72 floats (conflict-free).
// wgmma and TMA are later work.
//
// Built by nvcc (-gencode arch=compute_90a,code=sm_90a) into a shared
// library with a plain C entry, loaded with ctypes by
// src/repro_torch/kernels/ssd_scan.py, which allocates the scratch.  The
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int T = 64;          // tile side: rows, keys, state rows, P cols
constexpr int LDA = 72;        // padded row (elements) of a 64-wide tile
constexpr int LDF = 68;        // ... of a float32 tile read by ldmatrix
constexpr int MAX_N = 256;
constexpr int MAX_Q = 256;     // chunk whose C.B^T tile the output holds

template <typename Ty>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<Ty, float>::value;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename Ty>
__device__ __forceinline__ Ty from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// Two 16-bit values (k, k + 1) in one 32-bit register, k in the low half.
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(__half lo, __half hi) {
  __half2 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo in 16 bits: hi rounded, lo the rounding residual, rounded.
template <typename Ty>
__device__ __forceinline__ void split16(float x, Ty& hi, Ty& lo) {
  hi = from_f32<Ty>(x);
  lo = from_f32<Ty>(x - to_f32(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a b on m16n8k16 in 16 bits, float32 accumulators.
template <typename Ty>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  if constexpr (std::is_same<Ty, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A float32 fragment split into TF32 hi + lo (lo the rounding residual).
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ explicit Split(const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      hi[i] = tf32(x[i]);
      lo[i] = tf32(x[i] - __uint_as_float(hi[i]));
    }
  }
};

// c += a b on m16n8k8 at 3xTF32: a, b float32 fragments (a: rows g, g+8
// at k t, t+4; b: k t, t+4 at column g) split into TF32 hi + lo;
// a_hi b_lo + a_lo b_hi + a_hi b_hi.
__device__ __forceinline__ void mma3(float (&c)[4], const Split<4>& a,
                                     const Split<2>& b) {
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.hi);
}

// A fragment (16 rows from m0, K step from k0) of a tile stored
// row-major [m][k]: by ldmatrix (16-bit: k16 step; float32: k8 step).
template <typename Ty>
__device__ __forceinline__ void frag_a_rows(uint32_t (&a)[4], const Ty* s,
                                            int ld, int m0, int k0,
                                            int lane) {
  constexpr int W = is_f32<Ty>() ? 4 : 8;
  ldsm_x4(a, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * W);
}

// B fragment (8 columns from n0, K step from k0) of a tile stored
// [n][k]: by ldmatrix.
template <typename Ty>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2], const Ty* s,
                                            int ld, int n0, int k0,
                                            int lane) {
  constexpr int W = is_f32<Ty>() ? 4 : 8;
  ldsm_x2(b, s + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * W);
}

// 16 bits: A fragment of a tile stored [k][m] (ldmatrix.trans), B
// fragment of a tile stored [k][n] (ldmatrix.trans).
template <typename Ty>
__device__ __forceinline__ void frag_a_cols16(uint32_t (&a)[4], const Ty* s,
                                              int ld, int m0, int k0,
                                              int lane) {
  const int mi = lane >> 3;
  ldsm_x4_t(a, s + (k0 + (mi >> 1) * 8 + (lane & 7)) * ld + m0 +
                   (mi & 1) * 8);
}
template <typename Ty>
__device__ __forceinline__ void frag_b_cols16(uint32_t (&b)[2], const Ty* s,
                                              int ld, int n0, int k0,
                                              int lane) {
  ldsm_x2_t(b, s + (k0 + (lane & 15)) * ld + n0);
}

// float32: the same two fragments by single shared loads (rows of LDA =
// 72 floats: the 32 lanes hit 32 banks).
__device__ __forceinline__ void frag_a_cols32(float (&a)[4], const float* s,
                                              int ld, int m0, int k0,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  a[0] = s[(k0 + t) * ld + m0 + g];
  a[1] = s[(k0 + t) * ld + m0 + g + 8];
  a[2] = s[(k0 + t + 4) * ld + m0 + g];
  a[3] = s[(k0 + t + 4) * ld + m0 + g + 8];
}
__device__ __forceinline__ void frag_b_cols32(float (&b)[2], const float* s,
                                              int ld, int n0, int k0,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  b[0] = s[(k0 + t) * ld + n0 + g];
  b[1] = s[(k0 + t + 4) * ld + n0 + g];
}

template <int N>
__device__ __forceinline__ void as_float(float (&f)[N],
                                         const uint32_t (&u)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = __uint_as_float(u[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows [0, 64) x columns [0, 64) of a shared tile (row stride ld) from
// global rows g + r * gstride, columns [0, cols), rows r < rows; zeros
// elsewhere.  With vec (every row 16-byte aligned) by cp.async, 16 bytes
// at a time (a partial chunk zero-filled); else element by element.
// Completes at the next cp_async_wait_all() and __syncthreads().
// Strided by the block's threads.
template <typename Ty>
__device__ __forceinline__ void stage(Ty* s, int ld, const Ty* g,
                                      long gstride, int rows, int cols,
                                      bool vec) {
  constexpr int CH = 16 / sizeof(Ty);
  if (vec) {
    for (int e = threadIdx.x; e < T * (T / CH); e += blockDim.x) {
      const int r = e / (T / CH), c = (e % (T / CH)) * CH;
      const int n = r < rows ? min(CH, cols - c) : 0;
      const Ty* src = n > 0 ? g + r * gstride + c : g;
      cp_async16(s + r * ld + c, src, n > 0 ? n * (int)sizeof(Ty) : 0);
    }
  } else {
    for (int e = threadIdx.x; e < T * T; e += blockDim.x) {
      const int r = e / T, c = e % T;
      s[r * ld + c] =
          (r < rows && c < cols) ? g[r * gstride + c] : from_f32<Ty>(0.f);
    }
  }
}

// 1. acum[b, h, c, i] = sum_{k <= i} dt[b, c*q + k, h] * A[h] for the
// chunk's valid steps; a_last[b, h, c] = acum at its last valid step.
__global__ void __launch_bounds__(256)
    ssd_cumsum(const float* __restrict__ dt, const float* __restrict__ A,
               float* __restrict__ acum, float* __restrict__ a_last, int B,
               int S, int H, int q, int nc) {
  const int lane = threadIdx.x % 32;
  const long idx = (long)blockIdx.x * 8 + threadIdx.x / 32;
  if (idx >= (long)B * H * nc) return;
  const int c = (int)(idx % nc);
  const long bh = idx / nc;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const int L = min(q, S - c * q);
  const float a_h = A[h];
  const float* dtp = dt + ((long)b * S + (long)c * q) * H + h;
  float* out = acum + idx * q;
  float carry = 0.f;
  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    float v = i < L ? dtp[(long)i * H] * a_h : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (i < L) out[i] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) a_last[idx] = carry;
}


// 2. state[b, h, c, n, p] = sum_j w_j B[j, n] x[j, p], w_j = e^{a_last -
// a_j} dt_j, over the chunk's valid steps j, for one 128 x 64 tile of
// (n, p): the product B^T (w o x) on the tensor cores, K = j in tiles
// of 64; an x tile is loaded once for 128 state rows.  Warp w owns state
// rows n0 + 16w .. + 15.  float32 scales x by w as its fragments load;
// 16 bits form w o x as hi + lo halves in shared memory first.
constexpr int STATE_THREADS = 256;
constexpr int TN = 128;              // state rows of a block
constexpr int LDB = TN + 8;          // padded row of its B tile

template <typename Ty>
size_t state_smem_bytes() {
  return sizeof(Ty) * (size_t)T * LDB + sizeof(Ty) * (size_t)T * LDA +
         (is_f32<Ty>() ? 0 : 2 * sizeof(Ty) * (size_t)T * LDA) +
         sizeof(float) * T;
}

template <typename Ty>
__global__ void __launch_bounds__(STATE_THREADS)
    ssd_chunk_state(const Ty* __restrict__ x, const float* __restrict__ dt,
                    const Ty* __restrict__ Bm, const float* __restrict__ acum,
                    const float* __restrict__ a_last,
                    float* __restrict__ state, int S, int H, int P, int N,
                    int q, int nc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ty* Bs = reinterpret_cast<Ty*>(smem);      // (j, n)
  Ty* Xs = Bs + T * LDB;                     // (j, p)
  Ty* Wh = Xs + T * LDA;                     // 16 bits: w o x, hi
  Ty* Wl = Wh + T * LDA;                     //                 lo
  float* w = reinterpret_cast<float*>(Wh + (is_f32<Ty>() ? 0 : 2 * T * LDA));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_p = (P + T - 1) / T;
  const int n0 = (blockIdx.x / tiles_p) * TN, p0 = (blockIdx.x % tiles_p) * T;
  const int c = blockIdx.y;
  const long bh = blockIdx.z;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const int L = min(q, S - c * q);
  const long row0 = (long)b * S + (long)c * q;   // (b, c*q) in (B, S)
  const float* a = acum + (bh * nc + c) * q;
  const float al = a_last[bh * nc + c];
  constexpr int KS = is_f32<Ty>() ? 8 : 16;

  float acc[8][4] = {};
  for (int j0 = 0; j0 < L; j0 += T) {
    const int rows = min(T, L - j0);
    for (int half = 0; half < TN; half += T)
      stage(Bs + half, LDB, Bm + (row0 + j0) * N + n0 + half, N, rows,
            N - n0 - half, vec);
    stage(Xs, LDA, x + ((row0 + j0) * H + h) * P + p0, (long)H * P, rows,
          P - p0, vec);
    if (tid < T)
      w[tid] = tid < rows
                   ? expf(al - a[j0 + tid]) * dt[(row0 + j0 + tid) * H + h]
                   : 0.f;
    cp_async_wait_all();
    __syncthreads();
    if constexpr (!is_f32<Ty>()) {
      for (int e = tid; e < T * T; e += STATE_THREADS) {
        const int jj = e / T, pp = e % T;
        split16(w[jj] * to_f32(Xs[jj * LDA + pp]), Wh[jj * LDA + pp],
                Wl[jj * LDA + pp]);
      }
      __syncthreads();
    }
    for (int kk = 0; kk < T; kk += KS) {
      if constexpr (is_f32<Ty>()) {
        float fa[4];
        frag_a_cols32(fa, Bs, LDB, warp * 16, kk, lane);
        const Split<4> sa(fa);
        const float w0 = w[kk + t], w1 = w[kk + t + 4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float fb[2];
          frag_b_cols32(fb, Xs, LDA, nt * 8, kk, lane);
          fb[0] *= w0;
          fb[1] *= w1;
          mma3(acc[nt], sa, Split<2>(fb));
        }
      } else {
        uint32_t ua[4];
        frag_a_cols16(ua, Bs, LDB, warp * 16, kk, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_cols16(bl_, Wl, LDA, nt * 8, kk, lane);
          frag_b_cols16(bh_, Wh, LDA, nt * 8, kk, lane);
          mma16<Ty>(acc[nt], ua, bl_);
          mma16<Ty>(acc[nt], ua, bh_);
        }
      }
    }
    __syncthreads();
  }
  float* out = state + (bh * nc + c) * (long)N * P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + warp * 16 + g + (e >> 1) * 8;
      const int p = p0 + nt * 8 + 2 * t + (e & 1);
      if (n < N && p < P) out[(long)n * P + p] = acc[nt][e];
    }
}

// 3. Walk the chunks of each (b, h) in order: the state entering chunk c
// replaces chunk c's contribution; h <- h e^{a_last[c]} + contribution.
// The contributions of 8 chunks are loaded ahead of their updates, so
// that the loads are in flight together.
__global__ void __launch_bounds__(256)
    ssd_state_scan(float* __restrict__ state,
                   const float* __restrict__ a_last, int NP, int nc) {
  const long e = (long)blockIdx.x * 256 + threadIdx.x;
  if (e >= NP) return;
  const long bh = blockIdx.y;
  float* s = state + bh * nc * (long)NP + e;
  const float* al = a_last + bh * nc;
  float hcur = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float contrib[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      contrib[u] = c0 + u < nc ? s[(long)(c0 + u) * NP] : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        s[(long)c * NP] = hcur;
        hcur = fmaf(hcur, expf(al[c]), contrib[u]);
      }
    }
  }
}


constexpr int CB_THREADS = 256;    // the C.B^T pass: eight warps
// The output pass: four row groups of 16 rows, OUT_COLS column groups of
// 64 / OUT_COLS columns (warp w: rows 16 (w % 4), columns group w / 4).
constexpr int OUT_COLS = 1;
constexpr int OUT_THREADS = 128 * OUT_COLS;
constexpr int OUT_NT = 8 / OUT_COLS;       // n-tiles of 8 columns a warp

// 4a. C.B^T of one (b, chunk): the 64 x 64 tile (row tile rt, key tile
// kt <= rt) of C_i . B_j over N in slices of 64, into float32 scratch
// cb (B, nc, qp, qp), qp = q rounded up to 64; the heads share it.  Warp
// w: rows 16 (w % 4) .. + 15, keys 32 (w / 4) .. + 31 of the tile.
template <typename Ty>
__global__ void __launch_bounds__(CB_THREADS)
    ssd_chunk_cb(const Ty* __restrict__ Bm, const Ty* __restrict__ Cm,
                 float* __restrict__ cb, int S, int N, int q, int nc,
                 int vec) {
  constexpr int KS = is_f32<Ty>() ? 8 : 16;
  constexpr int LDC = is_f32<Ty>() ? LDF : LDA;
  __shared__ __align__(16) Ty Cs[T * LDC];     // (i, n) slice
  __shared__ __align__(16) Ty Bs[T * LDC];     // (j, n) slice
  const int rt = blockIdx.x, kt = blockIdx.y;
  if (kt > rt) return;
  const int b = blockIdx.z / nc, c = blockIdx.z % nc;
  const int L = min(q, S - c * q), i0 = rt * T, j0 = kt * T;
  if (i0 >= L) return;
  const int qp = (q + T - 1) / T * T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * 16, nt0 = (warp >> 2) * 4;
  const long row0 = (long)b * S + (long)c * q;
  float acc[4][4] = {};
  for (int ns = 0; ns < N; ns += T) {
    stage(Cs, LDC, Cm + (row0 + i0) * N + ns, N, L - i0, N - ns, vec);
    stage(Bs, LDC, Bm + (row0 + j0) * N + ns, N, L - j0, N - ns, vec);
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < T; kk += KS) {
      uint32_t ua[4];
      frag_a_rows(ua, Cs, LDC, m0, kk, lane);
      float fa[4];
      as_float(fa, ua);
      const Split<4> sa(fa);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t ub[2];
        frag_b_rows(ub, Bs, LDC, (nt0 + nt) * 8, kk, lane);
        if constexpr (is_f32<Ty>()) {
          float fb[2];
          as_float(fb, ub);
          mma3(acc[nt], sa, Split<2>(fb));
        } else {
          mma16<Ty>(acc[nt], ua, ub);
        }
      }
    }
    __syncthreads();
  }
  float* out = cb + ((long)blockIdx.z * qp + i0) * qp + j0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(long)(m0 + g + (e >> 1) * 8) * qp + (nt0 + nt) * 8 + 2 * t +
          (e & 1)] = acc[nt][e];
}

// Shared memory of the output pass, in bytes, for a chunk of q steps.
template <typename Ty>
size_t output_smem_bytes(int q) {
  const int qp = (q + T - 1) / T * T;
  const size_t small = sizeof(float) * (size_t)(T + 2 * qp);
  const int ldc = is_f32<Ty>() ? LDF : LDA;
  const size_t cs = sizeof(Ty) * (size_t)T * ldc;
  const size_t cbt = sizeof(float) * (size_t)T * LDF;
  // h_prev (float32, or hi + lo halves) and an x tile share a place
  const size_t h = is_f32<Ty>() ? sizeof(float) * (size_t)T * LDA
                                : 2 * sizeof(Ty) * (size_t)T * LDA;
  const size_t xt = sizeof(Ty) * (size_t)T * LDA;
  return small + cs + cbt + (h > xt ? h : xt);
}

// 4b. y rows i0 .. i0 + 63 of one chunk and head: per 64 columns of P,
// e^{a_i} C_i . h_prev + sum_{j <= i} (C_i . B_j) e^{a_i - a_j} dt_j x_j,
// the C.B^T tiles read from cb.  Warp w: rows 16 (w % 4) .. + 15,
// columns (64 / OUT_COLS) (w / 4) .. of the output tile.
template <typename Ty>
__global__ void __launch_bounds__(OUT_THREADS)
    ssd_chunk_output(const Ty* __restrict__ x, const float* __restrict__ dt,
                     const Ty* __restrict__ Cm, const float* __restrict__ cb,
                     const float* __restrict__ acum,
                     const float* __restrict__ state, Ty* __restrict__ y,
                     int S, int H, int P, int N, int q, int nc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = is_f32<Ty>() ? 8 : 16;
  constexpr int LDC = is_f32<Ty>() ? LDF : LDA;
  const int qp = (q + T - 1) / T * T;
  float* ai = reinterpret_cast<float*>(smem);
  float* aj = ai + T;
  float* dtj = aj + qp;
  float* CBt = dtj + qp;                             // (i, j) of a key tile
  Ty* Cs = reinterpret_cast<Ty*>(CBt + T * LDF);     // (i, n) slice
  float* Hs = reinterpret_cast<float*>(Cs + T * LDC);  // (n, p), float32
  Ty* Hh = Cs + T * LDC;                             // (n, p), 16-bit hi
  Ty* Hl = Hh + T * LDA;                             //          ... lo
  Ty* Xs = Cs + T * LDC;                             // (j, p): aliases H

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * 16, nt0 = (warp >> 2) * OUT_NT;
  const int rt = blockIdx.x, i0 = rt * T, c = blockIdx.y;
  const long bh = blockIdx.z;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const int L = min(q, S - c * q);
  if (i0 >= L) return;
  const long row0 = (long)b * S + (long)c * q;
  const int keys = (rt + 1) * T;                     // keys 0 .. keys - 1
  const float* a = acum + (bh * nc + c) * q;
  const float* cbp = cb + ((long)(b * nc + c) * qp + i0) * qp;
  const float* hp = state + (bh * nc + c) * (long)N * P;
  if (tid < T) ai[tid] = i0 + tid < L ? a[i0 + tid] : 0.f;
  for (int j = tid; j < keys; j += OUT_THREADS) {
    aj[j] = j < L ? a[j] : 0.f;
    dtj[j] = j < L ? dt[(row0 + j) * H + h] : 0.f;
  }
  __syncthreads();
  const int r_lo = m0 + g, r_hi = m0 + g + 8;       // this thread's rows
  const float ea_lo = expf(ai[r_lo]), ea_hi = expf(ai[r_hi]);
  for (int p0 = 0; p0 < P; p0 += T) {
    float acc[OUT_NT][4] = {};
    // inter-chunk: e^{a_i} C_i . h_prev (h_prev is zero in chunk 0)
    if (c > 0) {
      for (int ns = 0; ns < N; ns += T) {
        stage(Cs, LDC, Cm + (row0 + i0) * N + ns, N, L - i0, N - ns, vec);
        if constexpr (is_f32<Ty>()) {
          stage(Hs, LDA, hp + (long)ns * P + p0, P, N - ns, P - p0, vec);
        } else {
          // 4 columns a thread, as one 16-byte load where they all lie
          // inside the state and vec says rows are aligned
#pragma unroll 4
          for (int e = tid; e < T * T / 4; e += OUT_THREADS) {
            const int nn = e / (T / 4), pp = (e % (T / 4)) * 4;
            const float* src = hp + (long)(ns + nn) * P + p0 + pp;
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (ns + nn < N) {
              if (vec && p0 + pp + 3 < P) {
                const float4 f = *reinterpret_cast<const float4*>(src);
                v[0] = f.x;
                v[1] = f.y;
                v[2] = f.z;
                v[3] = f.w;
              } else {
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  if (p0 + pp + u < P) v[u] = src[u];
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              split16(v[u], Hh[nn * LDA + pp + u], Hl[nn * LDA + pp + u]);
          }
        }
        cp_async_wait_all();
        __syncthreads();
        for (int kk = 0; kk < T; kk += KS) {
          uint32_t ua[4];
          frag_a_rows(ua, Cs, LDC, m0, kk, lane);
          float fa[4];
          as_float(fa, ua);
          const Split<4> sa(fa);
#pragma unroll
          for (int nt = 0; nt < OUT_NT; ++nt) {
            const int n0 = (nt0 + nt) * 8;
            if constexpr (is_f32<Ty>()) {
              float fb[2];
              frag_b_cols32(fb, Hs, LDA, n0, kk, lane);
              mma3(acc[nt], sa, Split<2>(fb));
            } else {
              uint32_t bh_[2], bl_[2];
              frag_b_cols16(bl_, Hl, LDA, n0, kk, lane);
              frag_b_cols16(bh_, Hh, LDA, n0, kk, lane);
              mma16<Ty>(acc[nt], ua, bl_);
              mma16<Ty>(acc[nt], ua, bh_);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int nt = 0; nt < OUT_NT; ++nt) {
        acc[nt][0] *= ea_lo;
        acc[nt][1] *= ea_lo;
        acc[nt][2] *= ea_hi;
        acc[nt][3] *= ea_hi;
      }
    }
    // intra-chunk: scores . x over the key tiles at or below the diagonal
    for (int kt = 0; kt <= rt; ++kt) {
      stage(CBt, LDF, cbp + kt * T, qp, T, T, true);
      stage(Xs, LDA, x + ((row0 + kt * T) * H + h) * P + p0, (long)H * P,
            L - kt * T, P - p0, vec);
      cp_async_wait_all();
      __syncthreads();
      // the score at (row r, key kt * 64 + jl): C.B^T masked before the
      // exp (above the diagonal a_i - a_j > 0 could overflow)
      auto score = [&](int r, int jl) {
        const int i = i0 + r, j = kt * T + jl;
        return (j <= i && i < L)
                   ? CBt[r * LDF + jl] * expf(ai[r] - aj[j]) * dtj[j]
                   : 0.f;
      };
      for (int kk = 0; kk < T; kk += KS) {
        if constexpr (is_f32<Ty>()) {
          const float fa[4] = {score(r_lo, kk + t), score(r_hi, kk + t),
                               score(r_lo, kk + t + 4),
                               score(r_hi, kk + t + 4)};
          const Split<4> sa(fa);
#pragma unroll
          for (int nt = 0; nt < OUT_NT; ++nt) {
            float fb[2];
            frag_b_cols32(fb, Xs, LDA, (nt0 + nt) * 8, kk, lane);
            mma3(acc[nt], sa, Split<2>(fb));
          }
        } else {
          const int rr[4] = {r_lo, r_hi, r_lo, r_hi};
          const int jj[4] = {kk + 2 * t, kk + 2 * t, kk + 2 * t + 8,
                             kk + 2 * t + 8};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            Ty h0, l0, h1, l1;
            split16(score(rr[e], jj[e]), h0, l0);
            split16(score(rr[e], jj[e] + 1), h1, l1);
            ah[e] = pack(h0, h1);
            al[e] = pack(l0, l1);
          }
#pragma unroll
          for (int nt = 0; nt < OUT_NT; ++nt) {
            uint32_t ub[2];
            frag_b_cols16(ub, Xs, LDA, (nt0 + nt) * 8, kk, lane);
            mma16<Ty>(acc[nt], al, ub);
            mma16<Ty>(acc[nt], ah, ub);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < OUT_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + (e < 2 ? r_lo : r_hi);
        const int p = p0 + (nt0 + nt) * 8 + 2 * t + (e & 1);
        if (i < L && p < P)
          y[((row0 + i) * H + h) * P + p] = from_f32<Ty>(acc[nt][e]);
      }
  }
}

template <typename Ty>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* acum,
                   float* a_last, float* state, float* cb, int B, int S,
                   int H, int P, int N, int q, int vec, cudaStream_t stream) {
  const int nc = (S + q - 1) / q;
  const int tiles_p = (P + T - 1) / T;
  const int row_tiles = (q + T - 1) / T;
  const long triples = (long)B * H * nc;
  ssd_cumsum<<<(unsigned)((triples + 7) / 8), 256, 0, stream>>>(
      dt, A, acum, a_last, B, S, H, q, nc);
  const size_t smem_state = state_smem_bytes<Ty>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<Ty>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_state);
  if (err != cudaSuccess) return err;
  const dim3 grid_state(((N + TN - 1) / TN) * tiles_p, nc, B * H);
  ssd_chunk_state<Ty><<<grid_state, STATE_THREADS, smem_state, stream>>>(
      static_cast<const Ty*>(x), dt, static_cast<const Ty*>(Bm), acum,
      a_last, state, S, H, P, N, q, nc, vec);
  const dim3 grid_cb(row_tiles, row_tiles, B * nc);
  ssd_chunk_cb<Ty><<<grid_cb, CB_THREADS, 0, stream>>>(
      static_cast<const Ty*>(Bm), static_cast<const Ty*>(Cm), cb, S, N, q,
      nc, vec);
  const dim3 grid_scan((N * P + 255) / 256, B * H);
  ssd_state_scan<<<grid_scan, 256, 0, stream>>>(state, a_last, N * P, nc);
  const size_t smem = output_smem_bytes<Ty>(q);
  err = cudaFuncSetAttribute(
      ssd_chunk_output<Ty>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_out(row_tiles, nc, B * H);
  ssd_chunk_output<Ty><<<grid_out, OUT_THREADS, smem, stream>>>(
      static_cast<const Ty*>(x), dt, static_cast<const Ty*>(Cm), cb, acum,
      state, static_cast<Ty*>(y), S, H, P, N, q, nc, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm and y): 0 float32, 1 bfloat16, 2 float16.  q <=
// 256.  vec: every row of x, Bm, Cm and the state starts 16-byte aligned
// (cp.async).  Scratch, float32: acum (B*H*nc*q), a_last (B*H*nc), state
// (B*H*nc*N*P), cb (B*nc*qp*qp), nc = ceil(S / q), qp = q rounded up to
// 64.  Returns a cudaError_t.
int k3_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* acum,
                    void* a_last, void* state, void* cb, int dtype, int B,
                    int S, int H, int P, int N, int q, int vec,
                    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      q <= 0 || q > MAX_Q || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ac = static_cast<float*>(acum);
  float* al = static_cast<float*>(a_last);
  float* st = static_cast<float*>(state);
  float* cbf = static_cast<float*>(cb);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, dtf, Af, Bm, Cm, y, ac, al, st, cbf, B, S,
                                H, P, N, q, vec, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, ac, al, st,
                                        cbf, B, S, H, P, N, q, vec, s);
    default:
      return (int)launch<__half>(x, dtf, Af, Bm, Cm, y, ac, al, st, cbf, B,
                                 S, H, P, N, q, vec, s);
  }
}

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
