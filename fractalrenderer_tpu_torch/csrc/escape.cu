// K1 on Hopper: the escape-time kernel of the four 2D families (Mandelbrot,
// Julia, Burning Ship, Phoenix) with the trap, stripe and derivative
// outputs, the analytic interior skip and the fused colour epilogue, which
// can also quantize the finished colour into the caller's uint8 or uint16
// planes.
//
// Replaces fractalrenderer_tpu/ops/escape.py:_make_kernel (with _iter_chunk
// and _cardioid_or_bulb).  The plain PyTorch version is
// fractalrenderer_tpu_torch/ops/escape.py:escape_fields_plain; the two agree
// bit for bit on n, zx, zy, trap and dzx/dzy (the stripe goes through sinf,
// which may differ from torch.sin by an ulp per term).
//
// Design.  One thread per pixel in 32x8 blocks, so the threads of a warp
// write neighbouring addresses of one row.  Each thread leaves its own loop
// when its pixel escapes: the TPU kernel's CHUNK bursts with a tile-wide
// any() exit existed because a vector unit has no per-lane branch, and a
// warp already retires lanes one by one.  The family and fields-vs-fused
// mode are template parameters (8 instances, each with a twin that keeps
// the per-warp counters of csrc/warp_counters.cuh); the remaining options
// arrive as warp-uniform flags.  The 19 scalar parameters, the colour
// table and the output pointers arrive by value as kernel arguments
// (constant bank).  The fused instances but Phoenix's copy the table into
// shared memory once per block and read the palette's entries at a
// pixel's segment there: indexed at a per-lane offset, the by-value table
// compiled to chains of predicated constant loads (~360 instructions a
// pixel) or to a copy on the stack.  logf(bailout), the same for every
// pixel of a launch, is taken ahead of the loop, and an interior pixel's
// smooth value, which the colourers discard, is not computed (Mandelbrot,
// Julia, Burning Ship).
//
// What bounds it (PERF.md, Findings).  The fused frames: the colour epilogue
// (two or three logf, the palette's powf, the post chain's three powf and
// ACES divisions), a long dependent chain per pixel.  The fields frames: the
// loop's f32 ALU work (one compare and six to ten mul/add per iteration,
// plus a sqrt or a sinf when a trap or the stripe is tracked) and
// divergence inside a warp, which runs until its slowest lane escapes
// (86-90% of its lanes busy on the main views).  Memory is minor: 12 to
// 28 B per pixel written, 3 or 6 B with the quantized planes.

// Exactness.  Build with -fmad=false and without --use_fast_math: the
// reference counts rest on the shaders' operation order with no fused
// multiply-add, IEEE division in the mapping and subnormals kept (the
// colour floors of 1e-38 are subnormal).  Every literal is an f32 equal to
// numpy.float32 of the Python constant; constants Python folds in double
// (palette spans, 1/gamma, ln 2) come in the table from the wrapper.  min,
// max and clamp propagate NaN as torch.minimum/maximum/clamp do.  The
// quantized store repeats models/common.quantize_image operation for
// operation (see quantize8).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "warp_counters.cuh"

namespace {

// Parameter layout: fractalrenderer_tpu/ops/escape.py:46-52.
constexpr int kNParams = 19;
constexpr int P_CX = 0, P_CY = 1, P_ZOOM = 2, P_OFFX = 3, P_OFFY = 4,
              P_BAIL2 = 5, P_LIMIT = 6, P_A0 = 7, P_A1 = 8, P_A2 = 9,
              P_A3 = 10, P_COFF = 12, P_CSCALE = 13, P_BRIGHT = 14,
              P_SAT = 15, P_CONTRAST = 16, P_BAILOUT = 17, P_STRIPE = 18;

// Colour table layout: ops/palettes.py:palette_table plus two constants
// appended by ops/escape.py:color_table.
constexpr int kTableLen = 32;
constexpr int C_KIND = 0, C_EXPO = 1, C_GRAY = 2, C_LO = 3, C_SPAN = 7,
              C_HI = 11, C_COL = 15, C_INV_GAMMA = 30, C_LOG2 = 31;

// Families (ops/escape.py:FAMILIES) and launch flags (ops/escape.py:F_*).
constexpr int kMandelbrot = 0, kJulia = 1, kBurningShip = 2, kPhoenix = 3;
constexpr int F_FUSED = 1, F_SKIP = 2, F_JULIA = 4, F_TRAP = 8,
              F_STRIPE = 16, F_DERIV = 32, F_CLAMP = 64, F_POST = 128,
              F_Q8 = 256, F_Q16 = 512;
// Output slots (ops/escape.py:OUTPUT_SLOTS); fused mode writes r, g, b to
// slots 0-2, as f32 or, under F_Q8 / F_Q16, quantized.
constexpr int O_N = 0, O_ZX = 1, O_ZY = 2, O_TRAP = 3, O_STRIPE = 4,
              O_DZX = 5, O_DZY = 6;
constexpr int kMaxOutputs = 7;

constexpr int kMaxLimit = (1 << 24) - 1;  // f32 counter ceiling

// numpy.float32(math.pi) and numpy.float32(math.pi / 2) (ops/trig.py).
constexpr float kPi = 3.14159274f;
constexpr float kPi2 = 1.57079637f;

struct Params {
  float v[kNParams];
};

struct ColorTable {
  float v[kTableLen];
};

struct Outputs {
  void* p[kMaxOutputs];
};

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.minimum / torch.maximum: NaN-propagating.
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
// torch.clamp(x, lo, hi) and clamp_min: NaN stays NaN.
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clip01(float x) {
  return isnan_(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float fract(float t) { return t - floorf(t); }

// models/common.quantize_image on one value: torch.clamp(x, 0, 1) (NaN
// stays NaN), an f32 multiply by 255 (65535), a separate f32 add of 0.5
// (-fmad=false keeps the two apart), then the float-to-integer cast of
// PyTorch's CUDA copy_ (c10::static_cast_with_inter_type): through int64
// for uint8, direct for uint16.
__device__ __forceinline__ uint8_t quantize8(float x) {
  const float v = clip01(x) * 255.0f + 0.5f;
  return static_cast<uint8_t>(static_cast<int64_t>(v));
}
__device__ __forceinline__ uint16_t quantize16(float x) {
  const float v = clip01(x) * 65535.0f + 0.5f;
  return static_cast<uint16_t>(v);
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

// Mandelbrot's combined orbit trap on z (mandelbrot.comp:162-166), given
// sqx = zx*zx and sqy = zy*zy.
__device__ __forceinline__ float combined_trap(float zx, float zy, float sqx,
                                               float sqy, float cr,
                                               float ci) {
  const float mag = sqrtf(sqx + sqy);
  const float d_axes = tmin(fabsf(zx), fabsf(zy));
  const float dxc = zx - cr;
  const float dyc = zy - ci;
  const float d_c = sqrtf(dxc * dxc + dyc * dyc);
  return tmin(mag, tmin(d_axes, d_c));
}

// ops/trig.py atan / atan2: the 11-term odd polynomial with the reciprocal
// range reduction (the JAX package's Phoenix stripes use it on every path).
__device__ __forceinline__ float poly_atan(float x) {
  const float ax = fabsf(x);
  const bool inv = ax > 1.0f;
  const float t = inv ? 1.0f / tmax(ax, 1e-38f) : ax;
  const float s = t * t;
  float p = -0.0117212f;
  p = p * s + 0.05265332f;
  p = p * s + -0.11643287f;
  p = p * s + 0.19354346f;
  p = p * s + -0.33262348f;
  p = p * s + 0.99997726f;
  float r = t * p;
  r = inv ? kPi2 - r : r;
  return x < 0.0f ? -r : r;
}

__device__ __forceinline__ float poly_atan2(float y, float x) {
  const float safe_x =
      fabsf(x) < 1e-38f ? (x < 0.0f ? -1e-38f : 1e-38f) : x;
  const float base = poly_atan(y / safe_x);
  const float add = y >= 0.0f ? kPi : -kPi;
  float r = x < 0.0f ? base + add : base;
  if (x == 0.0f && y > 0.0f) r = kPi2;
  if (x == 0.0f && y < 0.0f) r = -kPi2;
  if (x == 0.0f && y == 0.0f) r = 0.0f;
  return r;
}

// palettes.palette_color_planar for one static spec: fract, pre-transform,
// then the first segment whose upper bound exceeds t.  The kind, the
// exponent, the grey flag and the bounds are read at fixed offsets of the
// by-value table; the reads at the pixel's segment go to `st`, the block's
// copy of the table in shared memory (one LDS each: indexing the by-value
// table at a per-lane offset compiles to a chain of predicated constant
// loads, or to a copy on the stack).
__device__ __forceinline__ void palette_rgb(const ColorTable& tb,
                                            const float* st, float t,
                                            float rgb[3]) {
  t = fract(t);
  const int kind = static_cast<int>(tb.v[C_KIND]);
  if (kind == 1) {
    t = powf(t, tb.v[C_EXPO]);
  } else if (kind == 2) {
    t = clip01(t);
    t = t * t * (3.0f - 2.0f * t);
  } else if (kind == 3) {
    t = fract(t);
  } else if (kind == 4) {
    t = powf(fract(t), tb.v[C_EXPO]);
  }
  if (tb.v[C_GRAY] != 0.0f) {
    rgb[0] = rgb[1] = rgb[2] = t;
    return;
  }
  int seg = 4;
  for (int i = 0; i < 4; ++i) {
    if (t < tb.v[C_HI + i]) {
      seg = i;
      break;
    }
  }
  if (seg == 4) {
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = tb.v[C_COL + 12 + ch];
    return;
  }
  const float f = (t - st[C_LO + seg]) / st[C_SPAN + seg];
  const float* lo = st + C_COL + 3 * seg;
  for (int ch = 0; ch < 3; ++ch) {
    rgb[ch] = lo[ch] * (1.0f - f) + lo[3 + ch] * f;
  }
}

__device__ __forceinline__ float aces(float c) {
  return clip01((c * (2.51f * c + 0.03f)) / (c * (2.43f * c + 0.59f) + 0.14f));
}

// coloring.smooth_nu_loglog (Mandelbrot, Phoenix).  An interior pixel's
// smooth value is discarded (it reports nf), so with kSkipInterior its
// logarithms are not taken: for z = 0 they run the subnormal slow paths.
template <bool kSkipInterior>
__device__ __forceinline__ float smooth_loglog(float nf, float zx, float zy,
                                               float max_iter, float log2c) {
  if (kSkipInterior && !(nf < max_iter)) return nf;
  const float mag2 = zx * zx + zy * zy;
  const float log_zn = logf(clamp_lo(mag2, 1e-38f)) / 2.0f;
  const float mu = logf(clamp_lo(log_zn, 1e-38f) / log2c) / log2c;
  return (nf < max_iter) ? nf + 1.0f - mu : nf;
}

// coloring.smooth_nu_bailout (Julia, Burning Ship), given log_bail =
// logf(bailout) (the same for every pixel of a launch).
__device__ __forceinline__ float smooth_bailout(float nf, float zx, float zy,
                                                float max_iter,
                                                float log_bail,
                                                float log2c) {
  if (!(nf < max_iter)) return nf;
  const float len_sq = zx * zx + zy * zy;
  const float quot = logf(clamp_lo(len_sq, 1e-38f)) / log_bail;
  return nf + 1.0f - logf(clamp_lo(quot, 1e-38f)) / log2c;
}

// The per-family planar colourers of ops/coloring.py as the fused path
// calls them: no trap or stripe consumers (Mandelbrot's trap placeholder is
// 1e20, the ship's 1e10 with stripe 0).  `log_bail` is logf(bailout)
// (Julia, Burning Ship).
template <int kFamily>
__device__ __forceinline__ void color_pixel(const Params& p,
                                            const ColorTable& tb,
                                            const float* st, int n, float zx,
                                            float zy, float max_iter,
                                            float log_bail,
                                            int interior_style,
                                            float rgb[3]) {
  const float log2c = tb.v[C_LOG2];
  const float nf = static_cast<float>(n);
  const bool interior = nf >= max_iter;
  if (kFamily == kMandelbrot) {
    // color_mandelbrot_planar, styles 0 and 1
    const float nu = smooth_loglog<true>(nf, zx, zy, max_iter, log2c);
    const float t = clip01(nu / max_iter * p.v[P_CSCALE]);
    palette_rgb(tb, st, t + p.v[P_COFF], rgb);
    if (interior_style == 1 && interior) rgb[0] = rgb[1] = rgb[2] = 0.0f;
  } else if (kFamily == kJulia) {
    // color_julia_planar
    const float s = smooth_bailout(nf, zx, zy, max_iter, log_bail, log2c);
    palette_rgb(tb, st, p.v[P_COFF] + (s / max_iter) * p.v[P_CSCALE], rgb);
    if (interior) rgb[0] = rgb[1] = rgb[2] = 0.0f;
  } else if (kFamily == kBurningShip) {
    // color_burning_ship_planar without the trap blend: styles 1 and 2
    // need the trap or the stripe, so they colour the interior black
    const float s = smooth_bailout(nf, zx, zy, max_iter, log_bail, log2c);
    palette_rgb(tb, st, p.v[P_COFF] + (s / max_iter) * p.v[P_CSCALE], rgb);
    if (interior) {
      if (interior_style == 3) {
        const float dist = sqrtf(zx * zx + zy * zy);
        palette_rgb(tb, st, clip01(dist * 0.5f), rgb);
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = rgb[ch] * 0.4f;
      } else {
        rgb[0] = rgb[1] = rgb[2] = 0.0f;
      }
    }
  } else {
    // color_phoenix_planar: pow(t, 0.8) and the flow stripes, with the
    // control > 0.01 gate folded into the weight; the interior test stays
    // a select here: Phoenix's colour has work (the flow stripes' angle)
    // to schedule beside the logarithms
    const float s = smooth_loglog<false>(nf, zx, zy, max_iter, log2c);
    const float t = powf(clamp_lo(s / max_iter, 0.0f), 0.8f);
    palette_rgb(tb, st, t, rgb);
    const float control = clamp_lo(p.v[P_STRIPE], 0.0f);
    const float amplitude = clip01(control * 0.05f);
    const float angle = poly_atan2(zy, zx);
    const float stripe_mod = 0.5f + 0.5f * sinf(angle * control + s * 0.25f);
    const float adaptive = amplitude * (1.0f - expf(-0.004f * s * s));
    float stp[3];
    palette_rgb(tb, st, fract(t + 0.1f * stripe_mod), stp);
    const float w = adaptive * stripe_mod * (control > 0.01f ? 1.0f : 0.0f);
    for (int ch = 0; ch < 3; ++ch) {
      rgb[ch] = rgb[ch] * (1.0f - w) + stp[ch] * w;
    }
  }
}

// One thread per pixel in 32x8 blocks; kCount adds the per-warp counters
// (the trips buffer), in a twin of each instance.
template <int kFamily, bool kFused, bool kCount>
__global__ void __launch_bounds__(256)
    escape_kernel(Params p, ColorTable tb, int width, int height,
                  int map_height, int row0, int max_iter_cap, int flags,
                  int interior_style, Outputs out, int* __restrict__ trips) {
  // The palette's entries at a pixel's segment: the block's copy of the
  // table in shared memory, copied at fixed offsets (a per-thread offset
  // into the by-value table would copy it to the stack).  Phoenix reads
  // the by-value table, which costs it no select chains and saves the
  // copy and the barrier (PERF.md, Findings).
  constexpr bool kShared = kFused && kFamily != kPhoenix;
  __shared__ float st_shared[kTableLen];
  if (kShared) {
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      for (int k = 0; k < kTableLen; ++k) st_shared[k] = tb.v[k];
    }
    __syncthreads();
  }
  const float* const st = kShared ? st_shared : tb.v;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;
  WarpStamp t_start{}, t_loop{};
  if (kCount) t_start = warp_stamp();

  // Tracking exists only in fields mode; the fused instances drop it at
  // compile time.
  const bool track_trap = !kFused && (flags & F_TRAP);
  const bool track_stripe = !kFused && (flags & F_STRIPE);
  const bool track_deriv =
      !kFused && kFamily == kMandelbrot && (flags & F_DERIV);
  const bool skip_ok = kFamily == kMandelbrot && (flags & F_SKIP);

  // ops/mapping.map_centered (== map_uv) at the global row.
  const float pxf = static_cast<float>(col);
  const float pyf = static_cast<float>(lrow + row0);
  const float w = static_cast<float>(width);
  const float h = static_cast<float>(map_height);
  const float ux = (pxf + p.v[P_OFFX] - 0.5f * w) / h;
  const float uy = (pyf + p.v[P_OFFY] - 0.5f * h) / h;
  const float mx = p.v[P_CX] + ux * p.v[P_ZOOM];
  const float my = p.v[P_CY] + uy * p.v[P_ZOOM];

  // Julia iterates from the pixel with a fixed c; the others from 0 with
  // c = the pixel.  Phoenix in Julia mode adds (a0, a1) instead of c.
  const bool julia = kFamily == kJulia;
  const float zx0 = julia ? mx : 0.0f;
  const float zy0 = julia ? my : 0.0f;
  const float cr = julia ? p.v[P_A0] : mx;
  const float ci = julia ? p.v[P_A1] : my;
  const bool phoenix_julia = kFamily == kPhoenix && (flags & F_JULIA);
  const float add_re = phoenix_julia ? p.v[P_A0] : cr;
  const float add_im = phoenix_julia ? p.v[P_A1] : ci;
  const float pp = p.v[P_A2], rr = p.v[P_A3];
  const float trap_r = kFamily == kBurningShip ? p.v[P_A0] : 0.0f;
  const float stripe_d = p.v[P_A1];

  // The static cap is real: the limit is clamped to it and to the f32
  // counter ceiling.
  const float limit_f = fminf(
      p.v[P_LIMIT], static_cast<float>(min(max_iter_cap, kMaxLimit)));
  const int limit = static_cast<int>(limit_f);
  const float bail2 = p.v[P_BAIL2];

  // The smooth colour's logf(bailout), the same for every pixel of a
  // launch, taken ahead of the loop (Julia, Burning Ship).
  const float log_bail =
      kFused && (kFamily == kJulia || kFamily == kBurningShip)
          ? logf(p.v[P_BAILOUT])
          : 0.0f;

  // Peel update 0 (always applied: the shaders update before the first
  // escape check).
  const float sqx0 = zx0 * zx0, sqy0 = zy0 * zy0;
  float x1, y1;
  if (kFamily == kBurningShip) {
    x1 = sqx0 - sqy0 + cr;
    y1 = fabsf((2.0f * zx0) * zy0) + ci;
  } else if (kFamily == kPhoenix) {
    x1 = sqx0 - sqy0 + add_re + rr * 0.0f + pp * zx0;
    y1 = (2.0f * zx0) * zy0 + add_im + rr * 0.0f + pp * zy0;
  } else {
    x1 = sqx0 - sqy0 + cr;
    y1 = (2.0f * zx0) * zy0 + ci;
  }

  // Initial aux values (escape.py:272-294).
  float trap = 0.0f, stripe = 0.0f, dzx = 1.0f, dzy = 0.0f;
  if (track_trap) {
    if (kFamily == kMandelbrot) {
      trap = tmin(1e20f, combined_trap(x1, y1, x1 * x1, y1 * y1, cr, ci));
    } else {
      trap = 1.0f * tmin(1e10f, fabsf(0.0f - trap_r));
    }
  }

  int n;
  float zx, zy;
  int iters = 0;  // the pixel's loop updates, for the counters
  bool looped = false;
  if (skip_ok && cardioid_or_bulb(cr, ci)) {
    // Provably interior: n = limit, z = 0, aux at their initial values.
    n = limit;
    zx = 0.0f;
    zy = 0.0f;
  } else {
    zx = x1;
    zy = y1;
    float sqx = zx * zx, sqy = zy * zy;
    float px = zx0, py = zy0;
    int survived = 0;
    for (int i = 1; i < limit; ++i) {
      // Escape latch on the frozen z: the escaping update is applied while
      // the pre-update z was still inside.
      const float mag2 = sqx + sqy;
      if (!(mag2 <= bail2)) break;
      ++survived;
      float x, y;
      if (kFamily == kBurningShip) {
        // traps and stripes use the pre-update z
        if (track_trap) trap = tmin(trap, fabsf(sqrtf(mag2) - trap_r));
        if (track_stripe) stripe = stripe + sinf(zy * stripe_d);
        x = sqx - sqy + cr;
        y = fabsf((2.0f * zx) * zy) + ci;
      } else if (kFamily == kPhoenix) {
        x = sqx - sqy + add_re + rr * px + pp * zx;
        y = (2.0f * zx) * zy + add_im + rr * py + pp * zy;
        px = zx;
        py = zy;
      } else {
        x = sqx - sqy + cr;
        y = (2.0f * zx) * zy + ci;
      }
      if (track_deriv) {
        // dz <- 2*z*dz + 1 with the pre-update z
        const float ndx = 2.0f * (zx * dzx - zy * dzy) + 1.0f;
        const float ndy = 2.0f * (zx * dzy + zy * dzx);
        dzx = ndx;
        dzy = ndy;
      }
      zx = x;
      zy = y;
      sqx = zx * zx;
      sqy = zy * zy;
      if (kFamily == kMandelbrot && track_trap) {
        // combined trap on the updated z
        trap = tmin(trap, combined_trap(zx, zy, sqx, sqy, cr, ci));
      }
    }
    n = (sqx + sqy <= bail2) ? limit : survived;
    iters = survived;
    looped = true;
  }
  const unsigned lanes = kCount ? row_lanes(width) : 0u;
  if (kCount) {
    __syncwarp(lanes);
    t_loop = warp_stamp();
  }

  const size_t idx = static_cast<size_t>(lrow) * width + col;
  if (!kFused) {
    // fixed slots, so the pointer array is never indexed at run time
    static_cast<int*>(out.p[O_N])[idx] = n;
    static_cast<float*>(out.p[O_ZX])[idx] = zx;
    static_cast<float*>(out.p[O_ZY])[idx] = zy;
    if (track_trap) static_cast<float*>(out.p[O_TRAP])[idx] = trap;
    if (track_stripe) static_cast<float*>(out.p[O_STRIPE])[idx] = stripe;
    if (track_deriv) {
      static_cast<float*>(out.p[O_DZX])[idx] = dzx;
      static_cast<float*>(out.p[O_DZY])[idx] = dzy;
    }
  } else {
    // Colour with max_iterations = the clamped limit.
    float rgb[3];
    color_pixel<kFamily>(p, tb, st, n, zx, zy, limit_f, log_bail,
                         interior_style, rgb);
    if (flags & F_POST) {
      // coloring.post_chain_planar: enhance -> ACES -> gamma.
      float bri = p.v[P_BRIGHT], sat = p.v[P_SAT], con = p.v[P_CONTRAST];
      if (flags & F_CLAMP) {
        bri = clamp_lo(bri, 0.1f);
        sat = clamp_lo(sat, 0.0f);
        con = clamp_lo(con, 0.1f);
      }
      float e[3];
      for (int ch = 0; ch < 3; ++ch) {
        e[ch] = (rgb[ch] * bri - 0.5f) * con + 0.5f;
      }
      const float gray = e[0] * 0.299f + e[1] * 0.587f + e[2] * 0.114f;
      const float inv_gamma = tb.v[C_INV_GAMMA];
      for (int ch = 0; ch < 3; ++ch) {
        const float c = clip01(gray * (1.0f - sat) + e[ch] * sat);
        rgb[ch] = powf(clamp_lo(aces(c), 0.0f), inv_gamma);
      }
    }
    // the store flags are the same for the whole launch: one uniform branch
    if (flags & F_Q8) {
      static_cast<uint8_t*>(out.p[0])[idx] = quantize8(rgb[0]);
      static_cast<uint8_t*>(out.p[1])[idx] = quantize8(rgb[1]);
      static_cast<uint8_t*>(out.p[2])[idx] = quantize8(rgb[2]);
    } else if (flags & F_Q16) {
      static_cast<uint16_t*>(out.p[0])[idx] = quantize16(rgb[0]);
      static_cast<uint16_t*>(out.p[1])[idx] = quantize16(rgb[1]);
      static_cast<uint16_t*>(out.p[2])[idx] = quantize16(rgb[2]);
    } else {
      static_cast<float*>(out.p[0])[idx] = rgb[0];
      static_cast<float*>(out.p[1])[idx] = rgb[1];
      static_cast<float*>(out.p[2])[idx] = rgb[2];
    }
  }
  if (kCount) {
    finish_row_trips(warp_row(trips), lanes, iters, looped, t_start, t_loop);
  }
}

dim3 grid_for(int width, int height) {
  return dim3((width + 31) / 32, (height + 7) / 8);
}

template <int kFamily, bool kFused, bool kCount>
void launch(cudaStream_t s, const Params& p, const ColorTable& tb, int width,
            int height, int map_height, int row0, int max_iter_cap,
            int flags, int interior_style, const Outputs& out, int* trips) {
  escape_kernel<kFamily, kFused, kCount>
      <<<grid_for(width, height), dim3(32, 8), 0, s>>>(
          p, tb, width, height, map_height, row0, max_iter_cap, flags,
          interior_style, out, trips);
}

template <int kFamily>
void launch_family(bool fused, cudaStream_t s, const Params& p,
                   const ColorTable& tb, int width, int height,
                   int map_height, int row0, int max_iter_cap, int flags,
                   int interior_style, const Outputs& out, int* trips) {
  const bool count = trips != nullptr;
  if (fused && count) {
    launch<kFamily, true, true>(s, p, tb, width, height, map_height, row0,
                                max_iter_cap, flags, interior_style, out,
                                trips);
  } else if (fused) {
    launch<kFamily, true, false>(s, p, tb, width, height, map_height, row0,
                                 max_iter_cap, flags, interior_style, out,
                                 trips);
  } else if (count) {
    launch<kFamily, false, true>(s, p, tb, width, height, map_height, row0,
                                 max_iter_cap, flags, interior_style, out,
                                 trips);
  } else {
    launch<kFamily, false, false>(s, p, tb, width, height, map_height, row0,
                                  max_iter_cap, flags, interior_style, out,
                                  trips);
  }
}

}  // namespace

extern "C" {

// Launch K1 on `stream`.  `family` indexes ops/escape.py:FAMILIES; `params`
// (19 floats) and `table` (32 floats) are host arrays copied into the
// kernel's by-value arguments; `flags` is a sum of the F_* bits.  Fields
// mode writes n (int32) to out0, zx and zy (f32) to out1 and out2, and the
// tracked trap, stripe, dzx and dzy (f32) to out3 to out6; fused mode
// writes r, g, b to out0 to out2: f32, or with F_Q8 in `flags` the uint8
// (uint8_t)(int64_t)(clamp(x, 0, 1) * 255.0f + 0.5f), with F_Q16 the
// uint16 (uint16_t)(clamp(x, 0, 1) * 65535.0f + 0.5f) (clamp keeping NaN,
// a multiply then a separate add: models/common.quantize_image's
// expression); each (height, width), row-major.
// The pointers of outputs not written may be null.  `trips`, if not null,
// receives the per-warp counters (csrc/warp_counters.cuh), one zeroed row
// of kTripFields int32 for each warp of the launch's 32x8 blocks.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// unknown family).
int fr_escape(int family, const float* params, const float* table, int width,
              int height, int map_height, int row0, int max_iter_cap,
              int flags, int interior_style, void* out0, void* out1,
              void* out2, void* out3, void* out4, void* out5, void* out6,
              void* stream, void* trips) {
  Params p;
  std::memcpy(p.v, params, sizeof(p.v));
  ColorTable tb;
  std::memcpy(tb.v, table, sizeof(tb.v));
  const Outputs out = {{out0, out1, out2, out3, out4, out5, out6}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = flags & F_FUSED;
  int* const t = static_cast<int*>(trips);
  switch (family) {
    case kMandelbrot:
      launch_family<kMandelbrot>(fused, s, p, tb, width, height, map_height,
                                 row0, max_iter_cap, flags, interior_style,
                                 out, t);
      break;
    case kJulia:
      launch_family<kJulia>(fused, s, p, tb, width, height, map_height, row0,
                            max_iter_cap, flags, interior_style, out, t);
      break;
    case kBurningShip:
      launch_family<kBurningShip>(fused, s, p, tb, width, height,
                                  map_height, row0, max_iter_cap, flags,
                                  interior_style, out, t);
      break;
    case kPhoenix:
      launch_family<kPhoenix>(fused, s, p, tb, width, height, map_height,
                              row0, max_iter_cap, flags, interior_style, out,
                              t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
