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
// adds and an f32 |z|^2.
//
// What bounds it.  f32 ALU work: ~73 operations per iteration (the fmaf
// counted as two), about nine times K1's Mandelbrot loop, and divergence
// at the set boundary.  Memory is 12 B per pixel written.
//
// Exactness.  The dd operations come from csrc/dd.cuh (two_prod by one
// fmaf, nothing else contracted: build with -fmad=false).

#include <cuda_runtime.h>

#include <cstring>

#include "dd.cuh"

namespace {

// Parameter layout: fractalrenderer_tpu/ops/dd_escape.py:30-32.
constexpr int kND = 11;
constexpr int D_CXH = 0, D_CXL = 1, D_CYH = 2, D_CYL = 3, D_ZH = 4, D_ZL = 5,
              D_LIMIT = 6, D_BAIL2 = 7, D_OFFX = 8, D_OFFY = 9;

struct DDParams {
  float v[kND];
};

// ops/dd.py ddc_square_add: z^2 + c with dd components.
__device__ __forceinline__ void ddc_square_add(dd_t& zr, dd_t& zi,
                                               dd_t cr, dd_t ci) {
  const dd_t zr2 = dd_mul(zr, zr);
  const dd_t zi2 = dd_mul(zi, zi);
  const dd_t zrzi = dd_mul(zr, zi);
  const dd_t neg_zi2 = {-zi2.hi, -zi2.lo};
  const dd_t new_r = dd_add(dd_add(zr2, neg_zi2), cr);
  const dd_t two_zrzi = {zrzi.hi * 2.0f, zrzi.lo * 2.0f};  // exact
  zi = dd_add(two_zrzi, ci);
  zr = new_r;
}

// ops/dd.py ddc_mag2: |z|^2 as a plain f32.
__device__ __forceinline__ float ddc_mag2(dd_t zr, dd_t zi) {
  return zr.hi * zr.hi + zi.hi * zi.hi +
         2.0f * (zr.hi * zr.lo + zi.hi * zi.lo);
}

__global__ void __launch_bounds__(256)
    dd_escape_kernel(DDParams p, int width, int height, int map_height,
                     int row0, int* n_out, float* zx_out, float* zy_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;

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

  // peel update 0: z1 = c
  dd_t zr = cr, zi = ci;
  float mag = ddc_mag2(zr, zi);
  int survived = 0;
  for (int i = 1; i < limit; ++i) {
    if (!(mag <= bail2)) break;
    ++survived;
    ddc_square_add(zr, zi, cr, ci);
    mag = ddc_mag2(zr, zi);
  }
  const size_t idx = static_cast<size_t>(lrow) * width + col;
  n_out[idx] = (mag <= bail2) ? limit : survived;
  zx_out[idx] = zr.hi + zr.lo;
  zy_out[idx] = zi.hi + zi.lo;
}

}  // namespace

extern "C" {

// Launch K2 on `stream`.  `params` (11 floats) is a host array copied into
// the kernel's by-value argument; writes n (int32), zx, zy (f32), each
// (height, width), row-major.  Returns the cudaError_t of the launch.
int fr_dd_escape(const float* params, int width, int height, int map_height,
                 int row0, void* n_out, void* zx_out, void* zy_out,
                 void* stream) {
  DDParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  dd_escape_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      p, width, height, map_height, row0, static_cast<int*>(n_out),
      static_cast<float*>(zx_out), static_cast<float*>(zy_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
