// K2 on Hopper: the double-double Mandelbrot escape kernel (precision
// tier 2).
//
// Replaces fractalrenderer_tpu/ops/dd_escape.py:_make_kernel (with the dd
// arithmetic of fractalrenderer_tpu/ops/dd.py).  The plain PyTorch version
// is fractalrenderer_tpu_torch/ops/dd_escape.py:dd_escape_fields_plain; the
// two agree bit for bit on n, zx and zy.
//
// Design.  One thread per pixel in 32x8 blocks, each with its own break
// (the TPU kernel's 16-iteration bursts with a tile-wide any() exit do not
// carry over).  The 11 scalar parameters arrive by value.  z and c are
// (hi, lo) f32 pairs held in registers; each iteration is three dd
// products (each a two_prod of one exact fmaf, csrc/dd.cuh), three dd
// adds and an f32 |z|^2.  |z|^2 computes zr.hi^2, zi.hi^2, zr.hi*zr.lo
// and zi.hi*zi.lo; the next iteration's two squares take those four
// products from registers (dd_sqr_carried) instead of computing them
// again, which nvcc does not do across the loop's back edge, and one
// counter serves as the loop index and the count: 68 SASS instructions per
// iteration against 73.
//
// What bounds it (PERF.md, Findings).  Instruction issue: the loop's trips
// times its 68 instructions take ~95% of the kernel's time at one warp
// instruction per scheduler per clock.  Under -fmad=false an unfused add
// or multiply issues at half the FP32 FLOP rate, so the kernel reads at
// most ~50% of its operation bound; and a warp runs until its slowest lane
// escapes (10% of the issued lane iterations idle at Seahorse 1e-9).
// Memory is 12 B per pixel written.
//
// Exactness.  The dd operations come from csrc/dd.cuh (two_prod by one
// fmaf, nothing else contracted: build with -fmad=false).

#include <cuda_runtime.h>

#include <cstring>

#include "dd.cuh"
#include "warp_counters.cuh"

namespace {

// Parameter layout: fractalrenderer_tpu/ops/dd_escape.py:30-32.
constexpr int kND = 11;
constexpr int D_CXH = 0, D_CXL = 1, D_CYH = 2, D_CYL = 3, D_ZH = 4, D_ZL = 5,
              D_LIMIT = 6, D_BAIL2 = 7, D_OFFX = 8, D_OFFY = 9;

struct DDParams {
  float v[kND];
};

// dd_mul(a, a) given its products p = a.hi * a.hi and x = a.hi * a.lo:
// the cross term a.hi * a.lo + a.lo * a.hi adds one product to itself.
__device__ __forceinline__ dd_t dd_sqr_carried(dd_t a, float p, float x) {
  float e = __fmaf_rn(a.hi, a.hi, -p);
  e = e + (x + x);
  const float hi = p + e;
  return {hi, e - (hi - p)};
}

// ops/dd.py ddc_square_add and ddc_mag2 for one iteration: z <- z^2 + c,
// then |z|^2 as a plain f32.  pr, pi, xr and xi hold zr.hi^2, zi.hi^2,
// zr.hi*zr.lo and zi.hi*zi.lo of z on entry (|z|^2's products) and of the
// new z on return.
__device__ __forceinline__ float dd_step(dd_t& zr, dd_t& zi, dd_t cr,
                                         dd_t ci, float& pr, float& pi,
                                         float& xr, float& xi) {
  const dd_t zr2 = dd_sqr_carried(zr, pr, xr);
  const dd_t zi2 = dd_sqr_carried(zi, pi, xi);
  const dd_t zrzi = dd_mul(zr, zi);
  const dd_t neg_zi2 = {-zi2.hi, -zi2.lo};
  zr = dd_add(dd_add(zr2, neg_zi2), cr);
  const dd_t two_zrzi = {zrzi.hi * 2.0f, zrzi.lo * 2.0f};  // exact
  zi = dd_add(two_zrzi, ci);
  pr = zr.hi * zr.hi;
  pi = zi.hi * zi.hi;
  xr = zr.hi * zr.lo;
  xi = zi.hi * zi.lo;
  return pr + pi + 2.0f * (xr + xi);
}

// One thread per pixel in 32x8 blocks; kCount adds the per-warp counters
// (the trips buffer), in a twin of the kernel.
template <bool kCount>
__global__ void __launch_bounds__(256)
    dd_escape_kernel(DDParams p, int width, int height, int map_height,
                     int row0, int* n_out, float* zx_out, float* zy_out,
                     int* trips) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;
  const unsigned lanes = row_lanes(width);
  WarpStamp t_start{}, t_loop{};
  if (kCount) t_start = warp_stamp();

  // centered mapping in dd: uv = (pix + off - 0.5*size)/size.y
  const float wf = static_cast<float>(width);
  const float hf = static_cast<float>(map_height);
  const float ux = (static_cast<float>(col) + p.v[D_OFFX] - 0.5f * wf) / hf;
  const float uy =
      (static_cast<float>(lrow + row0) + p.v[D_OFFY] - 0.5f * hf) / hf;
  const dd_t zoom = {p.v[D_ZH], p.v[D_ZL]};
  const dd_t cr = dd_add({p.v[D_CXH], p.v[D_CXL]}, dd_mul_float(zoom, ux));
  const dd_t ci = dd_add({p.v[D_CYH], p.v[D_CYL]}, dd_mul_float(zoom, uy));

  const int limit = static_cast<int>(p.v[D_LIMIT]);
  const float bail2 = p.v[D_BAIL2];

  // peel update 0: z1 = c; n counts the updates after it (at most
  // limit - 1)
  dd_t zr = cr, zi = ci;
  float pr = zr.hi * zr.hi, pi = zi.hi * zi.hi;
  float xr = zr.hi * zr.lo, xi = zi.hi * zi.lo;
  float mag = pr + pi + 2.0f * (xr + xi);
  const int last = limit - 1;
  int n = 0;
  for (; n < last; ++n) {
    if (!(mag <= bail2)) break;
    mag = dd_step(zr, zi, cr, ci, pr, pi, xr, xi);
  }
  if (kCount) {
    __syncwarp(lanes);
    t_loop = warp_stamp();
  }
  const size_t idx = static_cast<size_t>(lrow) * width + col;
  n_out[idx] = (mag <= bail2) ? limit : n;
  zx_out[idx] = zr.hi + zr.lo;
  zy_out[idx] = zi.hi + zi.lo;
  if (kCount) {
    finish_row_trips(warp_row(trips), lanes, n, true, t_start, t_loop);
  }
}

dim3 grid_for(int width, int height) {
  return dim3((width + 31) / 32, (height + 7) / 8);
}

}  // namespace

extern "C" {

// Launch K2 on `stream`.  `params` (11 floats) is a host array copied into
// the kernel's by-value argument; writes n (int32), zx, zy (f32), each
// (height, width), row-major.  `trips`, if not null, receives the per-warp
// counters (csrc/warp_counters.cuh), one zeroed row of kTripFields int32
// for each warp of the launch's 32x8 blocks.  Returns the cudaError_t of
// the launch.
int fr_dd_escape(const float* params, int width, int height, int map_height,
                 int row0, void* n_out, void* zx_out, void* zy_out,
                 void* stream, void* trips) {
  DDParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 blocks = grid_for(width, height);
  int* const n = static_cast<int*>(n_out);
  float* const zx = static_cast<float*>(zx_out);
  float* const zy = static_cast<float*>(zy_out);
  if (trips != nullptr) {
    dd_escape_kernel<true><<<blocks, block, 0, s>>>(
        p, width, height, map_height, row0, n, zx, zy,
        static_cast<int*>(trips));
  } else {
    dd_escape_kernel<false><<<blocks, block, 0, s>>>(
        p, width, height, map_height, row0, n, zx, zy, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
