// K5 on Hopper: the FP32 peak probe, `chains` independent fused
// multiply-add chains of `k` steps per element, summed.
//
// Replaces fractalrenderer_tpu/utils/diag.py:measure_vpu_peak (its inner
// kernel).  The plain PyTorch version is
// fractalrenderer_tpu_torch/utils/diag.py:fma_chains_plain; the two agree
// bit for bit whenever every accumulator stays >= 0.5 (the probe's input is
// all ones, so every accumulator starts >= 1).
//
// Design.  One thread per element in row-major blocks of 256 threads, so
// the one load and the one store of a warp are coalesced; the accumulators
// live in registers (`chains` is a template parameter, 1, 2, 4 or 8, and
// the chain loop is unrolled), and the step loop is unrolled 16 deep so
// the loop's own instructions take a few percent of the issue slots.
//
// What bounds it.  Operations: 2 flops per step per chain against 4 B in
// and 4 B out per element, so the SMs' FP32 FMA issue rate (128 lanes per
// SM per clock) is the bound; the probe measures it, and the bounds of the
// other kernels divide by what it measures.  A tail of the last wave of
// blocks (2 M threads are ~7.75 waves of 2048 resident threads on 132
// SMs) costs a few percent.
//
// Exactness.  Every source builds with -fmad=false, under which
// `acc * m + 0.5f` would issue FMUL + FADD and measure half the peak; the
// step is __fmaf_rn, which issues FFMA under that flag.  One fmaf is the
// exact product plus 0.5 rounded once; the plain version's f64 step is
// exact for acc >= 0.5 (a 48-bit product plus 0.5 fits in 53 bits), so its
// one rounding to f32 gives the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <int kChains>
__global__ void __launch_bounds__(kBlock)
    peak_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int k) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float a = x[i];
  float acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) acc[c] = a + static_cast<float>(c);
#pragma unroll 16
  for (int s = 0; s < k; ++s) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      acc[c] = __fmaf_rn(acc[c], 1.000001f, 0.5f);
  }
  float sum = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) sum = sum + acc[c];
  out[i] = sum;
}

template <int kChains>
void launch(const float* x, float* out, int n, int k, cudaStream_t s) {
  peak_kernel<kChains><<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(x, out,
                                                                     n, k);
}

}  // namespace

extern "C" {

// Launch K5 on `stream`: out[i] = sum over c < chains of k fmaf steps from
// x[i] + c, for n contiguous f32 elements.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a chain count without an instance).
int fr_fma_peak(const void* x, void* out, int n, int k, int chains,
                void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: launch<1>(xf, of, n, k, s); break;
    case 2: launch<2>(xf, of, n, k, s); break;
    case 4: launch<4>(xf, of, n, k, s); break;
    case 8: launch<8>(xf, of, n, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
