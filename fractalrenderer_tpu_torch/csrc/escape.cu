// K1 on Hopper: the Mandelbrot escape-time kernel with the analytic interior
// skip and the fused colour epilogue.
//
// Replaces fractalrenderer_tpu/ops/escape.py:_make_kernel (family
// "mandelbrot", with _iter_chunk and _cardioid_or_bulb).  The plain PyTorch
// version is fractalrenderer_tpu_torch/ops/escape.py:escape_fields_plain;
// the two agree bit for bit on n, zx and zy.
//
// Design.  One thread per pixel in 32x8 blocks, so the threads of a warp
// write neighbouring addresses of one row.  Each thread leaves its own loop
// when its pixel escapes: the TPU kernel's CHUNK bursts with a tile-wide
// any() exit existed because a vector unit has no per-lane branch, and a
// warp already retires lanes one by one.  Nothing is staged through shared
// memory; the 19 scalar parameters and the colour table arrive by value as
// kernel arguments (constant bank).
//
// What bounds it.  The f32 ALU work of the loop (one compare, six mul/add
// per iteration), and divergence inside a warp: a warp runs until its
// slowest lane escapes, so warps that straddle the set boundary idle most
// of their lanes.  Memory is minor: 12 B per pixel written in either mode
// (n, zx, zy or r, g, b).  Making it fast (warp-level work redistribution,
// persistent blocks) is later work.
//
// Exactness.  Build with -fmad=false and without --use_fast_math: the
// reference counts rest on the shaders' operation order with no fused
// multiply-add, IEEE division in the mapping and subnormals kept (the
// colour floors of 1e-38 are subnormal).  Every literal is an f32 equal to
// numpy.float32 of the Python constant; constants Python folds in double
// (palette spans, 1/gamma, ln 2) come in the table from the wrapper.

#include <cuda_runtime.h>

#include <cstring>

namespace {

// Parameter layout: fractalrenderer_tpu/ops/escape.py:46-52.
constexpr int kNParams = 19;
constexpr int P_CX = 0, P_CY = 1, P_ZOOM = 2, P_OFFX = 3, P_OFFY = 4,
              P_BAIL2 = 5, P_LIMIT = 6, P_COFF = 12, P_CSCALE = 13,
              P_BRIGHT = 14, P_SAT = 15, P_CONTRAST = 16;

// Colour table layout: ops/palettes.py:palette_table plus two constants
// appended by ops/escape.py:color_table.
constexpr int kTableLen = 32;
constexpr int T_KIND = 0, T_EXPO = 1, T_GRAY = 2, T_LO = 3, T_SPAN = 7,
              T_HI = 11, T_COL = 15, T_INV_GAMMA = 30, T_LOG2 = 31;

constexpr int kMaxLimit = (1 << 24) - 1;  // f32 counter ceiling

struct Params {
  float v[kNParams];
};

struct ColorTable {
  float v[kTableLen];
};

__device__ __forceinline__ float fract(float t) { return t - floorf(t); }

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// _cardioid_or_bulb: main cardioid or period-2 bulb (exact interior).
__device__ __forceinline__ bool cardioid_or_bulb(float cr, float ci) {
  float xq = cr - 0.25f;
  float y2 = ci * ci;
  float q = xq * xq + y2;
  bool in_cardioid = q * (q + xq) <= 0.25f * y2;
  float xb = cr + 1.0f;
  bool in_bulb = xb * xb + y2 <= 0.0625f;
  return in_cardioid || in_bulb;
}

// palettes.palette_color_planar for one static spec: fract, pre-transform,
// then the first segment whose upper bound exceeds t.
__device__ void palette_rgb(const ColorTable& tb, float t, float rgb[3]) {
  t = fract(t);
  const int kind = static_cast<int>(tb.v[T_KIND]);
  if (kind == 1) {
    t = powf(t, tb.v[T_EXPO]);
  } else if (kind == 2) {
    t = clip01(t);
    t = t * t * (3.0f - 2.0f * t);
  } else if (kind == 3) {
    t = fract(t);
  } else if (kind == 4) {
    t = powf(fract(t), tb.v[T_EXPO]);
  }
  if (tb.v[T_GRAY] != 0.0f) {
    rgb[0] = rgb[1] = rgb[2] = t;
    return;
  }
  int seg = 4;
  for (int i = 0; i < 4; ++i) {
    if (t < tb.v[T_HI + i]) {
      seg = i;
      break;
    }
  }
  if (seg == 4) {
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = tb.v[T_COL + 12 + ch];
    return;
  }
  const float f = (t - tb.v[T_LO + seg]) / tb.v[T_SPAN + seg];
  for (int ch = 0; ch < 3; ++ch) {
    rgb[ch] = tb.v[T_COL + 3 * seg + ch] * (1.0f - f) +
              tb.v[T_COL + 3 * (seg + 1) + ch] * f;
  }
}

__device__ __forceinline__ float aces(float c) {
  return clip01((c * (2.51f * c + 0.03f)) / (c * (2.43f * c + 0.59f) + 0.14f));
}

template <bool kFused>
__global__ void __launch_bounds__(256)
    escape_mandelbrot_kernel(Params p, ColorTable tb, int width, int height,
                             int map_height, int row0, int max_iter_cap,
                             int interior_skip, int interior_style,
                             int clamp_mins, int with_post, void* out0,
                             void* out1, void* out2) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;

  // ops/mapping.map_centered at the global row.
  const float pxf = static_cast<float>(col);
  const float pyf = static_cast<float>(lrow + row0);
  const float w = static_cast<float>(width);
  const float h = static_cast<float>(map_height);
  const float ux = (pxf + p.v[P_OFFX] - 0.5f * w) / h;
  const float uy = (pyf + p.v[P_OFFY] - 0.5f * h) / h;
  const float cr = p.v[P_CX] + ux * p.v[P_ZOOM];
  const float ci = p.v[P_CY] + uy * p.v[P_ZOOM];

  // The static cap is real: the limit is clamped to it and to the f32
  // counter ceiling.
  const float limit_f = fminf(
      p.v[P_LIMIT], static_cast<float>(min(max_iter_cap, kMaxLimit)));
  const int limit = static_cast<int>(limit_f);
  const float bail2 = p.v[P_BAIL2];

  int n;
  float zx, zy;
  if (interior_skip && cardioid_or_bulb(cr, ci)) {
    // Provably interior: n = limit, z = 0.
    n = limit;
    zx = 0.0f;
    zy = 0.0f;
  } else {
    // Update 0 is always applied (the shaders update before the first
    // escape check).
    const float zx0 = 0.0f, zy0 = 0.0f;
    const float sqx0 = zx0 * zx0, sqy0 = zy0 * zy0;
    zx = sqx0 - sqy0 + cr;
    zy = (2.0f * zx0) * zy0 + ci;
    float sqx = zx * zx, sqy = zy * zy;
    int survived = 0;
    for (int i = 1; i < limit; ++i) {
      // Escape latch on the frozen z: the escaping update is applied while
      // the pre-update z was still inside.
      if (!(sqx + sqy <= bail2)) break;
      ++survived;
      const float x = sqx - sqy + cr;
      const float y = (2.0f * zx) * zy + ci;
      zx = x;
      zy = y;
      sqx = zx * zx;
      sqy = zy * zy;
    }
    n = (sqx + sqy <= bail2) ? limit : survived;
  }

  const size_t idx = static_cast<size_t>(lrow) * width + col;
  if (!kFused) {
    static_cast<int*>(out0)[idx] = n;
    static_cast<float*>(out1)[idx] = zx;
    static_cast<float*>(out2)[idx] = zy;
    return;
  }

  // coloring.color_mandelbrot_planar with max_iterations = the clamped
  // limit.
  const float log2c = tb.v[T_LOG2];
  const float max_iter = limit_f;
  const float nf = static_cast<float>(n);
  const float mag2 = zx * zx + zy * zy;
  const float log_zn = logf(fmaxf(mag2, 1e-38f)) / 2.0f;
  const float mu = logf(fmaxf(log_zn, 1e-38f) / log2c) / log2c;
  const float nu = (nf < max_iter) ? nf + 1.0f - mu : nf;
  const float t = clip01(nu / max_iter * p.v[P_CSCALE]);
  float rgb[3];
  palette_rgb(tb, t + p.v[P_COFF], rgb);
  if (interior_style == 1 && nf >= max_iter) {
    rgb[0] = rgb[1] = rgb[2] = 0.0f;
  }

  if (with_post) {
    // coloring.post_chain_planar: enhance -> ACES -> gamma.
    float bri = p.v[P_BRIGHT], sat = p.v[P_SAT], con = p.v[P_CONTRAST];
    if (clamp_mins) {
      bri = fmaxf(bri, 0.1f);
      sat = fmaxf(sat, 0.0f);
      con = fmaxf(con, 0.1f);
    }
    float e[3];
    for (int ch = 0; ch < 3; ++ch) e[ch] = (rgb[ch] * bri - 0.5f) * con + 0.5f;
    const float gray = e[0] * 0.299f + e[1] * 0.587f + e[2] * 0.114f;
    const float inv_gamma = tb.v[T_INV_GAMMA];
    for (int ch = 0; ch < 3; ++ch) {
      const float c = clip01(gray * (1.0f - sat) + e[ch] * sat);
      rgb[ch] = powf(fmaxf(aces(c), 0.0f), inv_gamma);
    }
  }
  static_cast<float*>(out0)[idx] = rgb[0];
  static_cast<float*>(out1)[idx] = rgb[1];
  static_cast<float*>(out2)[idx] = rgb[2];
}

}  // namespace

extern "C" {

// Launch K1 on `stream`.  `params` (19 floats) and `table` (32 floats) are
// host arrays copied into the kernel's by-value arguments.  fused = 0 writes
// n (int32), zx, zy (f32); fused = 1 writes r, g, b (f32); each (height,
// width), row-major.  Returns the cudaError_t of the launch.
int fr_escape_mandelbrot(const float* params, const float* table, int width,
                         int height, int map_height, int row0,
                         int max_iter_cap, int interior_skip, int fused,
                         int interior_style, int clamp_mins, int with_post,
                         void* out0, void* out1, void* out2, void* stream) {
  Params p;
  std::memcpy(p.v, params, sizeof(p.v));
  ColorTable tb;
  std::memcpy(tb.v, table, sizeof(tb.v));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused) {
    escape_mandelbrot_kernel<true><<<grid, block, 0, s>>>(
        p, tb, width, height, map_height, row0, max_iter_cap, interior_skip,
        interior_style, clamp_mins, with_post, out0, out1, out2);
  } else {
    escape_mandelbrot_kernel<false><<<grid, block, 0, s>>>(
        p, tb, width, height, map_height, row0, max_iter_cap, interior_skip,
        interior_style, clamp_mins, with_post, out0, out1, out2);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
