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
//
// k1_load loads a cubin that Triton compiled in another process, kept by
// the persistent compile store (src/repro_torch/core/aot_store.py):
// cuModuleLoadData and cuModuleGetFunction, and for a kernel over 48 KB
// of shared memory the opt-in that Triton's own loader sets, so that a
// store hit compiles and loads nothing through Triton.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef CUresult (*LaunchKernel)(CUfunction, unsigned, unsigned, unsigned,
                                 unsigned, unsigned, unsigned, unsigned,
                                 CUstream, void**, void**);
typedef CUresult (*GetErrorString)(CUresult, const char**);
typedef CUresult (*ModuleLoadData)(CUmodule*, const void*);
typedef CUresult (*ModuleGetFunction)(CUfunction*, CUmodule, const char*);
typedef CUresult (*FuncSetCacheConfig)(CUfunction, CUfunc_cache);
typedef CUresult (*FuncGetAttribute)(int*, CUfunction_attribute, CUfunction);
typedef CUresult (*FuncSetAttribute)(CUfunction, CUfunction_attribute, int);
typedef CUresult (*CtxGetDevice)(CUdevice*);
typedef CUresult (*DeviceGetAttribute)(int*, CUdevice_attribute, CUdevice);

constexpr int SMEM_DEFAULT = 49152;   // bytes a block gets without opt-in

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

// Load a cubin image and look up its kernel ``name`` in the current
// device's primary context (made current first, as PyTorch's runtime
// calls make it); a kernel taking more than 48 KB of dynamic shared
// memory gets the opt-in.  Writes the CUfunction handle to *function and
// returns a CUresult.
int k1_load(const void* image, const char* name, int shared,
            uint64_t* function) {
  static ModuleLoadData load_data =
      driver_entry<ModuleLoadData>("cuModuleLoadData");
  static ModuleGetFunction get_function =
      driver_entry<ModuleGetFunction>("cuModuleGetFunction");
  static FuncSetCacheConfig set_cache =
      driver_entry<FuncSetCacheConfig>("cuFuncSetCacheConfig");
  static FuncGetAttribute get_attr =
      driver_entry<FuncGetAttribute>("cuFuncGetAttribute");
  static FuncSetAttribute set_attr =
      driver_entry<FuncSetAttribute>("cuFuncSetAttribute");
  static CtxGetDevice ctx_device = driver_entry<CtxGetDevice>("cuCtxGetDevice");
  static DeviceGetAttribute device_attr =
      driver_entry<DeviceGetAttribute>("cuDeviceGetAttribute");
  if (load_data == nullptr || get_function == nullptr ||
      set_cache == nullptr || get_attr == nullptr || set_attr == nullptr ||
      ctx_device == nullptr || device_attr == nullptr)
    return (int)CUDA_ERROR_NOT_FOUND;
  if (cudaFree(nullptr) != cudaSuccess) return (int)CUDA_ERROR_NOT_INITIALIZED;
  CUmodule module;
  CUresult r = load_data(&module, image);
  if (r != CUDA_SUCCESS) return (int)r;
  CUfunction fn;
  r = get_function(&fn, module, name);
  if (r != CUDA_SUCCESS) return (int)r;
  if (shared > SMEM_DEFAULT) {
    CUdevice dev;
    int optin = 0, static_smem = 0;
    if ((r = ctx_device(&dev)) != CUDA_SUCCESS) return (int)r;
    r = device_attr(&optin,
                    CU_DEVICE_ATTRIBUTE_MAX_SHARED_MEMORY_PER_BLOCK_OPTIN, dev);
    if (r != CUDA_SUCCESS) return (int)r;
    if (optin > SMEM_DEFAULT) {
      if ((r = set_cache(fn, CU_FUNC_CACHE_PREFER_SHARED)) != CUDA_SUCCESS)
        return (int)r;
      r = get_attr(&static_smem, CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES, fn);
      if (r != CUDA_SUCCESS) return (int)r;
      r = set_attr(fn, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                   optin - static_smem);
      if (r != CUDA_SUCCESS) return (int)r;
    }
  }
  *function = (uint64_t)fn;
  return (int)CUDA_SUCCESS;
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
