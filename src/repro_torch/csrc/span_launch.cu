// K1's launch: one cuLaunchKernel of a span kernel that Triton compiled.
//
// The span kernel itself (src/repro_torch/kernels/span_kernel.py, which
// replaces src/repro/core/pallas_lower.py::execute_span) is Triton's
// cubin, unchanged.  What this file replaces is Triton's Python launch
// path, which binds the arguments, recomputes their specialisation and
// looks up its cache on every call: 0.015-0.05 ms of host time a launch
// on the H100's host, more than the device time of a short span.  The
// wrapper (span_kernel._Launcher) reads the compiled kernel once (its
// CUfunction, threads, dynamic shared memory and the parameters Triton
// appends after the user's pointers) and then calls k1_launch with the
// launch and the pointer values packed in one array: one ctypes call of
// one argument, one driver call.
//
// Built by nvcc (-gencode arch=compute_90a,code=sm_90a) into a shared
// library with a plain C entry, loaded with ctypes by
// src/repro_torch/kernels/span_kernel.py.  cuLaunchKernel and
// cuGetErrorString are taken from the driver the runtime already loaded
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.  No device
// code: the launch is asynchronous on the caller's stream, and the entry
// returns the CUresult of the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef CUresult (*LaunchKernel)(CUfunction, unsigned, unsigned, unsigned,
                                 unsigned, unsigned, unsigned, unsigned,
                                 CUstream, void**, void**);
typedef CUresult (*GetErrorString)(CUresult, const char**);

constexpr int MAX_PARAMS = 256;

template <typename F>
F driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<F>(p);
}

}  // namespace

extern "C" {

// One launch described by a packed array of 64-bit words: {function (a
// CUfunction handle), grid, threads, dynamic shared memory bytes, stream,
// n, then the n kernel parameters, each a 64-bit pointer value, in the
// kernel's parameter order}: one ctypes argument.  Returns a CUresult.
int k1_launch(const uint64_t* blob) {
  static LaunchKernel launch = driver_entry<LaunchKernel>("cuLaunchKernel");
  if (launch == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const int n = (int)blob[5];
  const unsigned grid = (unsigned)blob[1];
  if (n < 0 || n > MAX_PARAMS || grid == 0)
    return (int)CUDA_ERROR_INVALID_VALUE;
  void* params[MAX_PARAMS];
  for (int i = 0; i < n; ++i) params[i] = const_cast<uint64_t*>(blob + 6 + i);
  return (int)launch(reinterpret_cast<CUfunction>(blob[0]), grid, 1, 1,
                     (unsigned)blob[2], 1, 1, (unsigned)blob[3],
                     reinterpret_cast<CUstream>(blob[4]), params, nullptr);
}

const char* k1_error_string(int err) {
  static GetErrorString get =
      driver_entry<GetErrorString>("cuGetErrorString");
  const char* text = nullptr;
  if (get == nullptr || get(static_cast<CUresult>(err), &text) != CUDA_SUCCESS
      || text == nullptr)
    return "unknown CUresult";
  return text;
}

}  // extern "C"
