// K6 on Hopper: the fresh-compile probe, out = x * salt + 1 on a (16, 128)
// f32 array, with `salt` baked into the object at build time.
//
// Replaces the compile-service probe of config 0 in the repository root's
// bench_all.py (its Pallas kernel `x_ref * salt + 1` in two (8, 128)
// blocks).  The plain PyTorch version is
// fractalrenderer_tpu_torch/ops/_cuda.py:compile_probe_plain; the two agree
// bit for bit (one f32 multiply and one f32 add, unfused under
// -fmad=false).
//
// Design.  ops/_cuda.py:compile_probe draws a random 24-bit salt and builds
// this file alone with -DFR_PROBE_SALT=<salt>.0f into a fresh directory, so
// every probe compiles an object no cache has seen; its time is nvcc's, the
// load's, one launch's and a scalar fetch's.  The file lives outside
// csrc/*.cu, so it never enters the main kernel library or its hash.  Two
// blocks of 8 x 128 threads, one element each, as the TPU kernel's two
// (8, 128) blocks.
//
// What bounds it.  Bytes: 8 KiB in and 8 KiB out, well under a launch's
// own latency; the meaningful figure is the build-to-fetch wall time.

#include <cuda_runtime.h>

#ifndef FR_PROBE_SALT
#error "build with -DFR_PROBE_SALT=<24-bit integer>.0f"
#endif

namespace {

__global__ void __launch_bounds__(1024)
    compile_probe_kernel(const float* __restrict__ x,
                         float* __restrict__ out) {
  const int i = (blockIdx.x * blockDim.y + threadIdx.y) * blockDim.x +
                threadIdx.x;
  out[i] = x[i] * FR_PROBE_SALT + 1.0f;
}

}  // namespace

extern "C" {

// Launch K6 on `stream` over the 16 x 128 f32 arrays x and out.  Returns
// the cudaError_t of the launch.
int fr_compile_probe(const void* x, void* out, void* stream) {
  compile_probe_kernel<<<2, dim3(128, 8), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* fr_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
