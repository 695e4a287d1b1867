// K3 — the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_kernel (its
// pl.pallas_call over the body _ssd_kernel).  It computes what
// _ssd_kernel computes, without the D*x skip (the wrapper
// repro_torch.kernels.ops.ssd_scan adds it).  Per (b, h) the sequence is
// cut into chunks of q = min(chunk, S) steps; within a chunk
// a = cumsum(dt * A) (float32, a <= 0), and with h_prev the (N, P)
// float32 state entering the chunk (zero for the first):
//
//   y_i = sum_{j <= i, same chunk} (C_i . B_j) e^{a_i - a_j} dt_j x_j
//         + e^{a_i} C_i . h_prev
//   h  <- h_prev e^{a_last} + sum_j e^{a_last - a_j} dt_j B_j x_j^T
//
// y is written in x's type.  Steps past S (the last chunk may be short)
// are masked in the kernels: they add nothing, as the Pallas kernel's
// zero padding (dt = 0) adds nothing, and no padded copy is made.
//
// Layout: x, y (B, S, H, P); dt (B, S, H) float32 (post-softplus);
// A (H,) float32 (negative); Bm, Cm (B, S, N), one group shared by all
// heads; all contiguous.  x, Bm, Cm share one type: float32, bfloat16 or
// float16.  N <= 256 (the output pass holds a 64-row C tile and a 64-row
// B tile across all N in shared memory); any P, S, q.
//
// Bound on the H100 SXM: operations.  At mamba2-130m's shape (B=2,
// S=4096, H=24, P=64, N=128, chunk 256: 768 (b, h, chunk) triples of
// 32,896 causal pairs) the chunked algorithm needs ~10 GFLOP when C.B^T
// is formed once per (b, chunk) (~16 GFLOP once per head): ~0.15 ms at
// the float32 rate of 67 TFLOP/s, against ~110 MB of float32 x, B, C,
// dt and y, ~0.033 ms at 3.35 TB/s.
//
// Design (right and simple first; tensor cores, TMA and wgmma are later
// work).  The Pallas grid walks the chunks of one (b, h) in order on
// one core, carrying the state in VMEM.  On the card that is 48
// sequences of 16 chunks at mamba2-130m's shape, too few to fill 132
// SMs, so the work is the SSD split of models/ssm.py::ssd_chunked, in
// four launches on the caller's stream:
//
//   1. ssd_cumsum: one warp per (b, h, chunk) scans dt * A (float32,
//      32 steps per shuffle scan) into acum (B, H, nc, q) and a_last
//      (B, H, nc);
//   2. ssd_chunk_state: one block per (b, h, chunk, 64x64 tile of the
//      (N, P) state) forms the chunk's own contribution
//      sum_j e^{a_last - a_j} dt_j B_j x_j^T, in float32 scratch
//      (B, H, nc, N, P);
//   3. ssd_state_scan: one thread per (b, h, state element) walks the
//      chunks in order, h <- h e^{a_last} + contribution, and writes the
//      state entering each chunk over that chunk's contribution;
//   4. ssd_chunk_output: one block per (b, h, chunk, 64-row tile of the
//      chunk, 64 columns of P) forms e^{a_i} C_i . h_prev, then walks
//      the 64-key tiles at or below the diagonal: S = C B^T (masked
//      before the exp: above the diagonal a_i - a_j > 0 could overflow,
//      and inf * 0 is NaN), scaled by e^{a_i - a_j} dt_j, then S x.
//      y is written once, in x's type.
//
// Every product is float32 FMAs on tiles in shared memory (inputs of
// 16 bits are widened as they load), 256 threads holding 4 x 4 outputs
// each, read as float4 from tiles whose rows are padded to 68 floats.
// C.B^T is formed again for every head (the ~16 GFLOP count).
//
// Built by nvcc (-gencode arch=compute_90a,code=sm_90a) into a shared
// library with a plain C entry, loaded with ctypes by
// src/repro_torch/kernels/ssd_scan.py, which allocates the scratch.  The
// entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // tile side: rows, keys, state rows, P cols
constexpr int LD = T + 4;      // padded row of a shared tile (float4-aligned)
constexpr int THREADS = 256;   // thread (ty, tx): ty = tid / 16, tx = tid % 16
constexpr int MAX_N = 256;

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

// acc[r][c] += sum_k a[k][ty*4 + r] * b[k][tx*4 + c] over k < K, for
// row-padded (LD) shared tiles.
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* a,
                                         const float* b, int K, int ty,
                                         int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * LD + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * LD + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// 1. acum[b, h, c, i] = sum_{k <= i} dt[b, c*q + k, h] * A[h] for the
// chunk's valid steps; a_last[b, h, c] = acum at its last valid step.
__global__ void __launch_bounds__(THREADS)
    ssd_cumsum(const float* __restrict__ dt, const float* __restrict__ A,
               float* __restrict__ acum, float* __restrict__ a_last, int B,
               int S, int H, int q, int nc) {
  const int lane = threadIdx.x % 32;
  const long idx = (long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
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

// 2. state[b, h, c, n, p] = sum_j e^{a_last - a_j} dt_j B[j, n] x[j, p]
// over the chunk's valid steps j, for one 64 x 64 tile of (n, p).
template <typename Ty>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_state(const Ty* __restrict__ x, const float* __restrict__ dt,
                    const Ty* __restrict__ Bm, const float* __restrict__ acum,
                    const float* __restrict__ a_last,
                    float* __restrict__ state, int S, int H, int P, int N,
                    int q, int nc) {
  __shared__ __align__(16) float Ws[T * LD];   // (j, n): w_j B[j, n]
  __shared__ __align__(16) float Xs[T * LD];   // (j, p)
  __shared__ float w[T];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles_p = (P + T - 1) / T;
  const int n0 = (blockIdx.x / tiles_p) * T, p0 = (blockIdx.x % tiles_p) * T;
  const int c = blockIdx.y;
  const long bh = blockIdx.z;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const int L = min(q, S - c * q);
  const long row0 = (long)b * S + (long)c * q;   // (b, c*q) in (B, S)
  const float* a = acum + (bh * nc + c) * q;
  const float al = a_last[bh * nc + c];

  float acc[4][4] = {};
  for (int j0 = 0; j0 < L; j0 += T) {
    const int rows = min(T, L - j0);
    if (tid < T)
      w[tid] = tid < rows
                   ? expf(al - a[j0 + tid]) * dt[(row0 + j0 + tid) * H + h]
                   : 0.f;
    __syncthreads();
    for (int e = tid; e < T * T; e += THREADS) {
      const int jj = e / T, cc = e % T;
      const long row = row0 + j0 + jj;
      Ws[jj * LD + cc] = (jj < rows && n0 + cc < N)
                             ? w[jj] * to_f32(Bm[row * N + n0 + cc])
                             : 0.f;
      Xs[jj * LD + cc] = (jj < rows && p0 + cc < P)
                             ? to_f32(x[(row * H + h) * P + p0 + cc])
                             : 0.f;
    }
    __syncthreads();
    tile_fma(acc, Ws, Xs, rows, ty, tx);
    __syncthreads();
  }
  float* out = state + (bh * nc + c) * (long)N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + ty * 4 + r;
    if (n >= N) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx * 4 + cc;
      if (p < P) out[(long)n * P + p] = acc[r][cc];
    }
  }
}

// 3. Walk the chunks of each (b, h) in order: the state entering chunk c
// replaces chunk c's contribution; h <- h e^{a_last[c]} + contribution.
__global__ void __launch_bounds__(THREADS)
    ssd_state_scan(float* __restrict__ state,
                   const float* __restrict__ a_last, int NP, int nc) {
  const long e = (long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= NP) return;
  const long bh = blockIdx.y;
  float* s = state + bh * nc * (long)NP + e;
  float hcur = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float contrib = s[(long)c * NP];
    s[(long)c * NP] = hcur;
    hcur = fmaf(hcur, expf(a_last[bh * nc + c]), contrib);
  }
}

// 4. y rows i0..i0+63 of one chunk, columns p0..p0+63:
// e^{a_i} C_i . h_prev + sum_{j <= i} (C_i . B_j) e^{a_i - a_j} dt_j x_j.
template <typename Ty>
__global__ void __launch_bounds__(THREADS)
    ssd_chunk_output(const Ty* __restrict__ x, const float* __restrict__ dt,
                     const Ty* __restrict__ Bm, const Ty* __restrict__ Cm,
                     const float* __restrict__ acum,
                     const float* __restrict__ state, Ty* __restrict__ y,
                     int S, int H, int P, int N, int q, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // (n, i): C rows of this tile
  float* Bs = Cs + N * LD;           // (n, j): B rows of a key tile; first
                                     // (n, p): h_prev
  float* Xs = Bs + N * LD;           // (j, p)
  float* Ss = Xs + T * LD;           // (j, i): masked scores
  float* ai = Ss + T * LD;
  float* aj = ai + T;
  float* dtj = aj + T;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles_p = (P + T - 1) / T;
  const int i0 = (blockIdx.x / tiles_p) * T, p0 = (blockIdx.x % tiles_p) * T;
  const int c = blockIdx.y;
  const long bh = blockIdx.z;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const int L = min(q, S - c * q);
  if (i0 >= L) return;
  const long row0 = (long)b * S + (long)c * q;
  const float* a = acum + (bh * nc + c) * q;
  const float* hp = state + (bh * nc + c) * (long)N * P;

  for (int e = tid; e < T * N; e += THREADS) {
    const int ii = e / N, n = e % N;
    Cs[n * LD + ii] =
        i0 + ii < L ? to_f32(Cm[(row0 + i0 + ii) * N + n]) : 0.f;
  }
  for (int e = tid; e < N * T; e += THREADS) {
    const int n = e / T, pp = e % T;
    Bs[n * LD + pp] = p0 + pp < P ? hp[(long)n * P + p0 + pp] : 0.f;
  }
  if (tid < T) ai[tid] = i0 + tid < L ? a[i0 + tid] : 0.f;
  __syncthreads();

  // inter-chunk: e^{a_i} C_i . h_prev
  float acc[4][4] = {};
  tile_fma(acc, Cs, Bs, N, ty, tx);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float d = expf(ai[ty * 4 + r]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] *= d;
  }
  __syncthreads();

  // intra-chunk: the key tiles at or below the diagonal
  for (int j0 = 0; j0 <= i0 && j0 < L; j0 += T) {
    const int rows = min(T, L - j0);
    for (int e = tid; e < T * N; e += THREADS) {
      const int jj = e / N, n = e % N;
      Bs[n * LD + jj] =
          jj < rows ? to_f32(Bm[(row0 + j0 + jj) * N + n]) : 0.f;
    }
    for (int e = tid; e < T * T; e += THREADS) {
      const int jj = e / T, pp = e % T;
      Xs[jj * LD + pp] =
          (jj < rows && p0 + pp < P)
              ? to_f32(x[((row0 + j0 + jj) * H + h) * P + p0 + pp])
              : 0.f;
    }
    if (tid < T) {
      aj[tid] = tid < rows ? a[j0 + tid] : 0.f;
      dtj[tid] = tid < rows ? dt[(row0 + j0 + tid) * H + h] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    tile_fma(s, Cs, Bs, N, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty * 4 + r, i = i0 + il;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int jl = tx * 4 + cc, j = j0 + jl;
        // mask first: above the diagonal a_i - a_j > 0 may overflow
        s[r][cc] = (j <= i && jl < rows && i < L)
                       ? s[r][cc] * expf(ai[il] - aj[jl]) * dtj[jl]
                       : 0.f;
      }
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      *reinterpret_cast<float4*>(Ss + (tx * 4 + cc) * LD + ty * 4) =
          make_float4(s[0][cc], s[1][cc], s[2][cc], s[3][cc]);
    __syncthreads();
    tile_fma(acc, Ss, Xs, rows, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i >= L) continue;
    Ty* out = y + ((row0 + i) * H + h) * P;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int p = p0 + tx * 4 + cc;
      if (p < P) out[p] = from_f32<Ty>(acc[r][cc]);
    }
  }
}

size_t output_smem_bytes(int N) {
  return sizeof(float) * ((size_t)2 * N * LD + 2 * T * LD + 3 * T);
}

template <typename Ty>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* acum,
                   float* a_last, float* state, int B, int S, int H, int P,
                   int N, int q, cudaStream_t stream) {
  const int nc = (S + q - 1) / q;
  const int tiles_p = (P + T - 1) / T;
  const long triples = (long)B * H * nc;
  ssd_cumsum<<<(unsigned)((triples + THREADS / 32 - 1) / (THREADS / 32)),
               THREADS, 0, stream>>>(dt, A, acum, a_last, B, S, H, q, nc);
  const dim3 grid_state(((N + T - 1) / T) * tiles_p, nc, B * H);
  ssd_chunk_state<Ty><<<grid_state, THREADS, 0, stream>>>(
      static_cast<const Ty*>(x), dt, static_cast<const Ty*>(Bm), acum,
      a_last, state, S, H, P, N, q, nc);
  const dim3 grid_scan((N * P + THREADS - 1) / THREADS, B * H);
  ssd_state_scan<<<grid_scan, THREADS, 0, stream>>>(state, a_last, N * P,
                                                     nc);
  const size_t smem = output_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_output<Ty>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_out(((q + T - 1) / T) * tiles_p, nc, B * H);
  ssd_chunk_output<Ty><<<grid_out, THREADS, smem, stream>>>(
      static_cast<const Ty*>(x), dt, static_cast<const Ty*>(Bm),
      static_cast<const Ty*>(Cm), acum, state, static_cast<Ty*>(y), S, H, P,
      N, q, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm and y): 0 float32, 1 bfloat16, 2 float16.
// Scratch, float32: acum (B*H*nc*q), a_last (B*H*nc), state
// (B*H*nc*N*P), nc = ceil(S / q).  Returns a cudaError_t.
int k3_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, void* acum,
                    void* a_last, void* state, int dtype, int B, int S, int H,
                    int P, int N, int q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
      q <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* ac = static_cast<float*>(acum);
  float* al = static_cast<float*>(a_last);
  float* st = static_cast<float*>(state);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, dtf, Af, Bm, Cm, y, ac, al, st, B, S, H,
                                P, N, q, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, ac, al, st, B,
                                        S, H, P, N, q, s);
    default:
      return (int)launch<__half>(x, dtf, Af, Bm, Cm, y, ac, al, st, B, S, H,
                                 P, N, q, s);
  }
}

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
