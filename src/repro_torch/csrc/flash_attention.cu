// K2 — blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_kernel
// (its pl.pallas_call over the body _flash_kernel).  It computes what
// _flash_kernel computes:
//
//   * q is scaled by 1/sqrt(hd) in float32;
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
// hd <= 256 that is a multiple of 8; 16-bit tensors 16-byte aligned
// (the tiles are read 16 bytes at a time).
//
// Bound on the H100 SXM: operations.  At gemma3-1b's global layer (B=1,
// H=4, S=4096, hd=256, causal) the band holds ~8.4M allowed (q, k) pairs
// per head, 4 flops per pair and head-dim element: ~34.4 GFLOP, or ~35 us
// at the bf16 tensor-core rate of 989 TFLOP/s, against ~21 MB of q, k, v
// and o, or ~6 us at 3.35 TB/s.  A local layer (window 512) is ~8.1 GFLOP.
//
// Design (right and simple first; wgmma, TMA, cp.async pipelining and
// warp specialisation are later work):
//
//   * The TPU's sequential KV grid dimension becomes a loop inside the
//     block.  One block takes one (b, h, 64-row q tile) and walks only
//     the 64-key tiles inside its causal/window band: a local layer's
//     block visits ~9 tiles, not S/64.  Blocks are issued heaviest-first
//     (the last q tiles of a causal layer hold the longest bands).
//   * bfloat16 and float16 run on the tensor cores (flash_fwd_mma_kernel,
//     4 warps of 16 query rows): S = Q K^T and O += P V are
//     mma.sync.m16n8k16 products with float32 accumulators, the
//     accumulator and the running max/sum in registers, and Q, K and V^T
//     tiles in the input type in shared memory (104,448 bytes at hd=256,
//     two blocks per SM), rows padded so each warp's fragment loads fall
//     in distinct banks.  P is rounded to the input type for the second
//     product, as GPU flash kernels do; the row sums are not.
//   * float32 keeps float32 products (no TF32) and runs on FMAs
//     (flash_fwd_kernel, 256 threads): float32 tiles in shared memory
//     (213,760 bytes at hd=256, one block per SM; Q and K rows strided
//     hd+1 so a half-warp's 16 key rows fall in 16 banks), 4 rows x 4
//     keys of S per thread, P through shared memory, 4 rows x hd/16
//     columns of O per thread in registers.
//   * Ragged edges (Sq, Sk not multiples of 64; hd a multiple of 8 but
//     not of 16) are masked or zero-filled in the kernel: no padded
//     copies of q, k or v in device memory.
//
// Built by nvcc (-gencode arch=compute_90a,code=sm_90a) into a shared
// library with a plain C entry, loaded with ctypes by
// src/repro_torch/kernels/flash_attention.py.  The kernel launches on the
// caller's stream; the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // thread (ty, tx): ty = tid / 16, tx = tid % 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float row_max16(float x) {
  // the 16 threads of a row are 16 consecutive lanes of one warp
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (size_t)(BQ * ld + BK * ld + BK * hd + BQ * (BK + 1));
}

// Thread (ty, tx) owns query rows ty*4 + i (i < 4) of the tile: score
// columns tx + 16*j (j < 4) and output columns tx + 16*j (j < HDMAX/16).
template <int HDMAX>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int group, int Sq, int Sk, int hd, int causal,
                 int use_window, int window, float scale) {
  constexpr int NJ = HDMAX / 16;
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;              // [BQ][ld], q * scale
  float* Ks = Qs + BQ * ld;      // [BK][ld]
  float* Vs = Ks + BK * ld;      // [BK][hd]
  float* Ps = Vs + BK * hd;      // [BQ][BK + 1]

  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int KV = H / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qi * BQ;
  const int off = Sk - Sq;

  const float* qb = q + (size_t)(b * H + h) * Sq * hd;
  const float* kb = k + (size_t)(b * KV + h / group) * Sk * hd;
  const float* vb = v + (size_t)(b * KV + h / group) * Sk * hd;
  float* ob = o + (size_t)(b * H + h) * Sq * hd;

  const int rows = min(BQ, Sq - q0);
  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, c = idx - r * hd;
    Qs[r * ld + c] = r < rows ? qb[(size_t)(q0 + r) * hd + c] * scale : 0.f;
  }

  // the band of keys any row of this tile may see
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + rows + off);
  if (use_window) k_lo = max(0, q0 + off - window + 1);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int t_lo = k_lo / BK;
  const int t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // Q stored; the last tile's K, V, P are read
    for (int idx = tid; idx < BK * hd; idx += THREADS) {
      const int r = idx / hd, c = idx - r * hd;
      const bool in = k0 + r < Sk;
      const size_t g = (size_t)(k0 + r) * hd + c;
      Ks[r * ld + c] = in ? kb[g] : 0.f;
      Vs[r * hd + c] = in ? vb[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + off;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Sk && (!causal || kp <= qp) &&
                (!use_window || kp > qp - window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      const float corr = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = Vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rows) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < hd)
          ob[(size_t)(q0 + r) * hd + d] = acc[i][j] / denom;
      }
    }
  }
}

template <int HDMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int Sq, int Sk, int hd, int causal,
                   int use_window, int window, float scale,
                   cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HDMAX>;
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / KV, Sq,
      Sk, hd, causal, use_window, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 / float16: tensor cores through mma.sync.m16n8k16
// ---------------------------------------------------------------------------

constexpr int MQ = 64;          // query rows per block: 16 per warp
constexpr int MK = 64;          // keys per KV tile
constexpr int MTHREADS = 128;   // 4 warps

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  // d (16x8, f32) += a (16x16, row) * b (16x8, col)
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// head_dim padded to the mma depth of 16; Q, K rows and V^T rows padded by
// 8 elements, so the fragment loads of a warp fall in 32 distinct banks
__host__ __device__ __forceinline__ int padded_hd(int hd) {
  return (hd + 15) & ~15;
}

size_t mma_smem_bytes(int hd) {
  const int hp = padded_hd(hd);
  return 2 * ((size_t)(MQ + MK) * (hp + 8) + (size_t)hp * (MK + 8));
}

// Warp w owns tile rows w*16 .. w*16+15; in the mma fragment layouts a
// lane (g = lane/4, t = lane%4) holds rows g and g+8, columns 2t and 2t+1
// of each 8-wide tile.  S = Q K^T and O += P V are m16n8k16 products
// with f32 accumulators; P is rounded to T for the second product (the
// row sums l stay unrounded f32).  The scale 1/sqrt(hd) multiplies S in
// f32, so q is never rounded after scaling.
template <typename T, int HDMAX>
__global__ void __launch_bounds__(MTHREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int group, int Sq, int Sk, int hd, int causal,
                     int use_window, int window, float scale) {
  constexpr int NT = HDMAX / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hp = padded_hd(hd);
  const int ldq = hp + 8;         // row stride of Qs and Ks (elements)
  const int ldv = MK + 8;         // row stride of Vt
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [MQ][ldq]
  T* Ks = Qs + MQ * ldq;                     // [MK][ldq]
  T* Vt = Ks + MK * ldq;                     // [hp][ldv], V transposed

  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int KV = H / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qi * MQ;
  const int off = Sk - Sq;

  const T* qb = q + (size_t)(b * H + h) * Sq * hd;
  const T* kb = k + (size_t)(b * KV + h / group) * Sk * hd;
  const T* vb = v + (size_t)(b * KV + h / group) * Sk * hd;
  T* ob = o + (size_t)(b * H + h) * Sq * hd;

  const int rows = min(MQ, Sq - q0);
  const int chunks = hp / 8;      // 16-byte chunks of a padded row
  for (int idx = tid; idx < MQ * chunks; idx += MTHREADS) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows && c < hd)
      x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * hd + c);
    *reinterpret_cast<uint4*>(Qs + r * ldq + c) = x;
  }

  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(Sk, q0 + rows + off);
  if (use_window) k_lo = max(0, q0 + off - window + 1);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;   // this lane's tile rows: r0 and r0 + 8

  const int t_lo = k_lo / MK;
  const int t_hi = k_hi > k_lo ? (k_hi + MK - 1) / MK : t_lo;
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * MK;
    __syncthreads();   // Q stored; the last tile's K and V^T are read
    for (int idx = tid; idx < MK * chunks; idx += MTHREADS) {
      // K: row-major, a row's chunks on consecutive threads; V: the key
      // is the fastest index, so the transposed stores hit distinct banks
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      const int vr = idx % MK, vc = (idx / MK) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk && c < hd)
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * hd + c);
      if (k0 + vr < Sk && vc < hd)
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + vr) * hd + vc);
      *reinterpret_cast<uint4*>(Ks + r * ldq + c) = kx;
      const T* ve = reinterpret_cast<const T*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(vc + e) * ldv + vr] = ve[e];
    }
    __syncthreads();

    float s[MK / 8][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < hp; kk += 16) {
      const T* qa = Qs + r0 * ldq + kk + 2 * t;
      const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * ldq), lds32(qa + 8),
                             lds32(qa + 8 * ldq + 8)};
#pragma unroll
      for (int j = 0; j < MK / 8; ++j) {
        const T* kp = Ks + (j * 8 + g) * ldq + kk + 2 * t;
        const uint32_t bb[2] = {lds32(kp), lds32(kp + 8)};
        Mma<T>::run(s[j], a, bb);
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = q0 + r0 + 8 * hr + off;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < MK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + j * 8 + 2 * t + e;
          const bool ok = kp < Sk && (!causal || kp <= qp) &&
                          (!use_window || kp > qp - window);
          float& x = s[j][2 * hr + e];
          x = ok ? x * scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < MK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * hr + e];
          x = x <= NEG_INF / 2 ? 0.f : expf(x - m_safe);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = m[hr] <= NEG_INF / 2 ? 0.f : expf(m[hr] - m_safe);
      l[hr] = l[hr] * corr + rs;
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * hr] *= corr;
        acc[j][2 * hr + 1] *= corr;
      }
    }

    // P as the A operand: key tiles 2kk and 2kk+1 make the k-step kk
    uint32_t pa[MK / 16][4];
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      pa[kk][0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < hd) {
#pragma unroll
        for (int kk = 0; kk < MK / 16; ++kk) {
          const T* vp = Vt + (j * 8 + g) * ldv + kk * 16 + 2 * t;
          const uint32_t bb[2] = {lds32(vp), lds32(vp + 8)};
          Mma<T>::run(acc[j], pa[kk], bb);
        }
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr;
    if (r < rows) {
      const float denom = fmaxf(l[hr], 1e-30f);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < hd)
          *reinterpret_cast<uint32_t*>(ob + (size_t)(q0 + r) * hd + d) =
              Mma<T>::pack(acc[j][2 * hr] / denom,
                           acc[j][2 * hr + 1] / denom);
      }
    }
  }
}

template <typename T, int HDMAX>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KV, int Sq, int Sk, int hd,
                       int causal, int use_window, int window, float scale,
                       cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<T, HDMAX>;
  const size_t smem = mma_smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + MQ - 1) / MQ, H, B);
  kern<<<grid, MTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / KV, Sq, Sk, hd,
      causal, use_window, window, scale);
  return cudaGetLastError();
}

// float32 takes the FMA kernel; bfloat16 and float16 the mma.sync one
template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int Sq, int Sk, int hd,
                        int causal, int use_window, int window, float scale,
                        cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    if (hd <= 64)
      return launch<64>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal,
                        use_window, window, scale, stream);
    if (hd <= 128)
      return launch<128>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal,
                         use_window, window, scale, stream);
    return launch<256>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal, use_window,
                       window, scale, stream);
  } else {
    if (hd <= 64)
      return launch_mma<T, 64>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal,
                               use_window, window, scale, stream);
    if (hd <= 128)
      return launch_mma<T, 128>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal,
                                use_window, window, scale, stream);
    return launch_mma<T, 256>(q, k, v, o, B, H, KV, Sq, Sk, hd, causal,
                              use_window, window, scale, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns a cudaError_t.
int k2_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KV, int Sq,
                           int Sk, int hd, int causal, int use_window,
                           int window, float scale, void* stream) {
  if (hd <= 0 || hd > 256 || KV <= 0 || H % KV != 0 || B <= 0 || Sq <= 0 ||
      Sk < 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(q, k, v, o, B, H, KV, Sq, Sk, hd,
                                     causal, use_window, window, scale, s);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk,
                                             hd, causal, use_window, window,
                                             scale, s);
    default:
      return (int)dispatch_hd<__half>(q, k, v, o, B, H, KV, Sq, Sk, hd,
                                      causal, use_window, window, scale, s);
  }
}

const char* k2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
