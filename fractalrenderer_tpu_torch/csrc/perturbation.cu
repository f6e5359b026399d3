// K3 on Hopper: the perturbation deep-zoom kernel, Mandelbrot family, with
// per-pixel (Zhuoran) rebasing and the series-skip start, in three delta
// tiers: f32, double-double and floatexp (dd mantissa + i32 exponent).
//
// Replaces fractalrenderer_tpu/ops/perturbation.py:_make_kernel in its
// in-kernel-rounds rebase form (``rebase=True, inkernel_rounds > 0``),
// Mandelbrot branches only: f32 update :1091-1136, dd update :970-1025,
// floatexp update :764-790 then :846-877, series initialisation
// :500-564, mapping :441-467, outputs :1265-1282.  The plain PyTorch
// version is fractalrenderer_tpu_torch/ops/perturbation.py:
// perturbation_fields_plain; the two agree bit for bit on n, zx, zy, want
// and rounds.
//
// Design.  One thread per pixel in 32x8 blocks; the 41 scalar parameters
// arrive by value, the reference orbit as 2 (f32 tier) or 4 (dd and
// floatexp tiers: hi and lo of the f64 orbit) f32 streams in global
// memory, read through the read-only cache.  The tier is a template
// parameter (three instances).  Each lane iterates
//     d <- 2 Z_i d + d^2 + dc
// against the orbit until it escapes, its budget runs out, or its full
// value |Z_{i+1} + d| drops below |d| (or it reaches the orbit's end):
// then it rebases (d <- Z_{i+1} + d) and at once restarts at orbit index 0
// with z, nf and d carried over, up to max_passes rounds.  The TPU kernel
// runs the rounds per tile (a lane wanting a rebase freezes until its
// tile's round ends); a lane's iteration sequence is the same either way,
// and the rounds plane here is per pixel (its max equals the TPU's
// passes).  A lane still wanting after max_passes rounds leaves with
// want = 1 for the host's HP fallback.
//
// What bounds it.  f32 ALU work: per iteration ~20 operations in the f32
// tier, ~300 in the dd tier (seven dd products, each a Dekker two_prod
// with two Veltkamp splits) and ~350 in the floatexp tier, times the
// pixel's iteration count (up to max_iter for interior pixels), and
// divergence between lanes of a warp.  The orbit (<= 16 B per entry) stays
// in L2; warps read it at one index until their lanes' first rebases,
// after which each lane reads its own index.  Memory written: 16 B per
// pixel.
//
// Exactness.  Build with -fmad=false (csrc/dd.cuh).  2^k is built in the
// exponent field, floor(log2|x|) read from it, and the exponent clip kept
// in i32, as the TPU kernel does; the iteration counter is an f32 compared
// against the f32 limit.

#include <cuda_runtime.h>

#include <cstring>

#include "dd.cuh"

namespace {

// Parameter layout: fractalrenderer_tpu/ops/perturbation.py:49-54.
constexpr int kNQ = 41;
enum {
  Q_CXH, Q_CXL, Q_CYH, Q_CYL, Q_PSH, Q_PSL, Q_LIMIT, Q_BAIL2, Q_REFLEN,
  Q_GLITCH_TOL, Q_SHIFTXH, Q_SHIFTXL, Q_SHIFTYH, Q_SHIFTYL, Q_OFFX,
  Q_OFFY, Q_AR, Q_AI, Q_BR, Q_BI, Q_CR, Q_CI, Q_NSKIP, Q_ROW0,
  Q_ARL, Q_AIL, Q_BRL, Q_BIL, Q_CRL, Q_CIL, Q_SEXP, Q_M0, Q_FIRST,
  Q_Z0XH, Q_Z0XL, Q_Z0YH, Q_Z0YL, Q_PP, Q_RR, Q_SE0, Q_AROW0
};

struct PertParams {
  float v[kNQ];
};

constexpr int kF32 = 0, kDD = 1, kFX = 2;
// Exponent of an exact floatexp zero (perturbation.py:61).
constexpr int kEZero = -(1 << 24);
constexpr int kEMax = 1 << 24;

// perturbation.py _pow2: 2^k for integer k through the exponent field
// (0 below 2^-126, 2^127 above).
__device__ __forceinline__ float pow2i(int k) {
  const int kc = min(max(k, -126), 127);
  const float f = __int_as_float((kc + 127) << 23);
  return k < -126 ? 0.0f : f;
}

// perturbation.py _expo: floor(log2 |x|) from the exponent field.
__device__ __forceinline__ int expo(float x) {
  return ((__float_as_int(x) >> 23) & 0xFF) - 127;
}

// torch.maximum / jnp.maximum: NaN-propagating.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ int clip_exp(int e) {
  return min(max(e, kEZero), kEMax);
}

__device__ __forceinline__ dd_t scl(dd_t v, float f) {
  return {v.hi * f, v.lo * f};
}

// Complex product of dd components (the series Horner's cmul_dd).
__device__ __forceinline__ void cmul_dd(dd_t ar, dd_t ai, dd_t br, dd_t bi,
                                        dd_t& rr, dd_t& ri) {
  rr = dd_sub(dd_mul(ar, br), dd_mul(ai, bi));
  ri = dd_add(dd_mul(ar, bi), dd_mul(ai, br));
}

template <int kTier>
__global__ void __launch_bounds__(256)
    pert_mandelbrot_kernel(PertParams p, const float* __restrict__ ore,
                           const float* __restrict__ oim,
                           const float* __restrict__ orl,
                           const float* __restrict__ oil, int width,
                           int height, int map_height, int max_passes,
                           int* __restrict__ n_out, float* __restrict__ zx_out,
                           float* __restrict__ zy_out,
                           float* __restrict__ want_out,
                           float* __restrict__ rounds_out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int lrow = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || lrow >= height) return;
  const int row = lrow + static_cast<int>(p.v[Q_ROW0]);

  const int limit = static_cast<int>(p.v[Q_LIMIT]);
  const float limit_f = p.v[Q_LIMIT];
  const float bail2 = p.v[Q_BAIL2];
  const int pert_end = static_cast<int>(p.v[Q_REFLEN]) - 1;

  // dc = step * (pixel - size/2 + offset) + shift, in dd (:441-467)
  const dd_t step = {p.v[Q_PSH], p.v[Q_PSL]};
  const float half_w = static_cast<float>(width) * 0.5f;
  const float half_h = static_cast<float>(map_height) * 0.5f;
  const float nx = (static_cast<float>(col) - half_w) + p.v[Q_OFFX];
  const float ny = (static_cast<float>(row) - half_h) + p.v[Q_OFFY];
  const dd_t dcx = dd_add(dd_mul_float(step, nx),
                          {p.v[Q_SHIFTXH], p.v[Q_SHIFTXL]});
  const dd_t dcy = dd_add(dd_mul_float(step, ny),
                          {p.v[Q_SHIFTYH], p.v[Q_SHIFTYL]});
  const float delta_r = dd_to_float(dcx);
  const float delta_i = dd_to_float(dcy);
  const int s_exp = static_cast<int>(p.v[Q_SEXP]);
  const int n0 = static_cast<int>(p.v[Q_NSKIP]);

  // series initial delta d_{n0} = ((C dc + B) dc + A) dc (:500-564)
  float dz0r, dz0i;
  dd_t dzr, dzi;  // dd tier: the delta; floatexp tier: its mantissa
  int ex = 0;     // floatexp tier: the delta's exponent
  if constexpr (kTier == kF32) {
    float hr = p.v[Q_CR], hi = p.v[Q_CI];
    float tr = hr * delta_r - hi * delta_i + p.v[Q_BR];
    float tj = hr * delta_i + hi * delta_r + p.v[Q_BI];
    hr = tr;
    hi = tj;
    tr = hr * delta_r - hi * delta_i + p.v[Q_AR];
    tj = hr * delta_i + hi * delta_r + p.v[Q_AI];
    hr = tr;
    hi = tj;
    dz0r = hr * delta_r - hi * delta_i;
    dz0i = hr * delta_i + hi * delta_r;
  } else {
    dd_t tr = {p.v[Q_CR], p.v[Q_CRL]}, tj = {p.v[Q_CI], p.v[Q_CIL]};
    cmul_dd(tr, tj, dcx, dcy, tr, tj);
    tr = dd_add(tr, {p.v[Q_BR], p.v[Q_BRL]});
    tj = dd_add(tj, {p.v[Q_BI], p.v[Q_BIL]});
    cmul_dd(tr, tj, dcx, dcy, tr, tj);
    tr = dd_add(tr, {p.v[Q_AR], p.v[Q_ARL]});
    tj = dd_add(tj, {p.v[Q_AI], p.v[Q_AIL]});
    cmul_dd(tr, tj, dcx, dcy, dzr, dzi);
    if constexpr (kTier == kFX) {
      // the Horner value sits at exponent Q_SE0: renormalise (:550-561)
      const float mag0 = tmax(fabsf(dzr.hi), fabsf(dzi.hi));
      const bool zero0 = mag0 == 0.0f;
      const int k0 = zero0 ? 0 : expo(mag0);
      const float f0 = pow2i(-k0);
      dzr = scl(dzr, f0);
      dzi = scl(dzi, f0);
      ex = zero0 ? kEZero
                 : clip_exp(static_cast<int>(p.v[Q_SE0]) + k0);
      const float dfac0 = pow2i(ex);
      dz0r = dd_to_float(dzr) * dfac0;
      dz0i = dd_to_float(dzi) * dfac0;
    } else {
      dz0r = dd_to_float(dzr);
      dz0i = dd_to_float(dzi);
    }
  }
  float zfr = __ldg(ore + n0) + dz0r;
  float zfi = __ldg(oim + n0) + dz0i;
  float dr = dz0r, di = dz0i;  // f32 tier delta
  float nf = static_cast<float>(n0 - 1);

  int i = n0;
  int rounds = 1;
  bool want = false;
  for (;;) {
    for (;;) {
      const float mag2 = zfr * zfr + zfi * zfi;
      if (!(mag2 <= bail2 && i < pert_end && nf < limit_f)) break;
      nf = nf + 1.0f;
      const float zr = __ldg(ore + i), zi = __ldg(oim + i);
      const float zr1 = __ldg(ore + i + 1), zi1 = __ldg(oim + i + 1);
      bool want_now;
      if constexpr (kTier == kF32) {
        // :1091-1136
        const float t1r = 2.0f * (zr * dr - zi * di);
        const float t1i = 2.0f * (zr * di + zi * dr);
        const float t2r = dr * dr - di * di;
        const float t2i = (2.0f * dr) * di;
        float ndr = t1r + t2r + delta_r;
        float ndi = t1i + t2i + delta_i;
        const float relr = zr1 + ndr;
        const float reli = zi1 + ndi;
        const float zm2 = relr * relr + reli * reli;
        const float dm2 = ndr * ndr + ndi * ndi;
        want_now = (zm2 < dm2 || i + 1 >= pert_end) && nf < limit_f;
        if (want_now) {
          ndr = relr;
          ndi = reli;
        }
        dr = ndr;
        di = ndi;
        zfr = relr;
        zfi = reli;
      } else {
        const float zrl = __ldg(orl + i), zil = __ldg(oil + i);
        const float zrl1 = __ldg(orl + i + 1), zil1 = __ldg(oil + i + 1);
        const dd_t z2r = {zr * 2.0f, zrl * 2.0f};  // 2Z in dd
        const dd_t z2i = {zi * 2.0f, zil * 2.0f};
        const dd_t t1r = dd_sub(dd_mul(dzr, z2r), dd_mul(dzi, z2i));
        const dd_t t1i = dd_add(dd_mul(dzi, z2r), dd_mul(dzr, z2i));
        const dd_t sq_r = dd_sub(dd_mul(dzr, dzr), dd_mul(dzi, dzi));
        const dd_t rz = dd_mul(dzr, dzi);
        const dd_t sq_i = {rz.hi * 2.0f, rz.lo * 2.0f};
        if constexpr (kTier == kDD) {
          // :970-1025, non-Julia branch
          dd_t ndr = dd_add(dd_add(t1r, sq_r), dcx);
          dd_t ndi = dd_add(dd_add(t1i, sq_i), dcy);
          const float rel_r = (zr1 + ndr.hi) + (zrl1 + ndr.lo);
          const float rel_i = (zi1 + ndi.hi) + (zil1 + ndi.lo);
          const float zm2 = rel_r * rel_r + rel_i * rel_i;
          const float dm2 = ndr.hi * ndr.hi + ndi.hi * ndi.hi;
          want_now = (zm2 < dm2 || i + 1 >= pert_end) && nf < limit_f;
          if (want_now) {  // rebase: d <- Z_{i+1} + d, in dd
            ndr = dd_add({zr1, zrl1}, ndr);
            ndi = dd_add({zi1, zil1}, ndi);
          }
          dzr = ndr;
          dzi = ndi;
          zfr = rel_r;
          zfi = rel_i;
        } else {
          // :764-790: the three terms at exponents ex, 2ex and -s aligned
          // to their max by exact powers of two, then renormalised
          const int e2 = ex + ex;
          const int emax = max(max(ex, e2), -s_exp);
          const float fA = pow2i(ex - emax);
          const float fB = pow2i(e2 - emax);
          dd_t nmr = dd_add(scl(t1r, fA), scl(sq_r, fB));
          dd_t nmi = dd_add(scl(t1i, fA), scl(sq_i, fB));
          const float fC = pow2i(-s_exp - emax);
          nmr = dd_add(nmr, scl(dcx, fC));
          nmi = dd_add(nmi, scl(dcy, fC));
          const float mag = tmax(fabsf(nmr.hi), fabsf(nmi.hi));
          const bool zero = mag == 0.0f;
          const int k = zero ? 0 : expo(mag);
          const float fN = pow2i(-k);
          nmr = scl(nmr, fN);
          nmi = scl(nmi, fN);
          int nex = zero ? kEZero : clip_exp(emax + k);
          // :846-877: z_full = Z + m 2^ex; Zhuoran test; rebase to exp 0
          const float dfac = pow2i(nex);
          const float nzfr = (zr1 + nmr.hi * dfac) + (zrl1 + nmr.lo * dfac);
          const float nzfi = (zi1 + nmi.hi * dfac) + (zil1 + nmi.lo * dfac);
          const float zm2 = nzfr * nzfr + nzfi * nzfi;
          const float dm2 =
              (nmr.hi * nmr.hi + nmi.hi * nmi.hi) * pow2i(nex + nex);
          want_now = (zm2 < dm2 || i + 1 >= pert_end) && nf < limit_f;
          if (want_now) {
            nmr = dd_add({zr1, zrl1}, {nmr.hi * dfac, nmr.lo * dfac});
            nmi = dd_add({zi1, zil1}, {nmi.hi * dfac, nmi.lo * dfac});
            nex = 0;
          }
          dzr = nmr;
          dzi = nmi;
          ex = nex;
          zfr = nzfr;
          zfi = nzfi;
        }
      }
      ++i;
      if (want_now) {
        want = true;
        break;
      }
    }
    // the lane's next round: restart at orbit index 0, state carried over
    if (want && rounds < max_passes) {
      want = false;
      i = 0;
      ++rounds;
      continue;
    }
    break;
  }

  // :1265-1282 (the budget ran out = interior)
  const size_t idx = static_cast<size_t>(lrow) * width + col;
  n_out[idx] = nf >= limit_f ? limit : static_cast<int>(fmaxf(nf, 0.0f));
  zx_out[idx] = zfr;
  zy_out[idx] = zfi;
  want_out[idx] = want ? 1.0f : 0.0f;
  rounds_out[idx] = static_cast<float>(rounds);
}

}  // namespace

extern "C" {

// Launch K3 (tier 0 = f32, 1 = dd, 2 = floatexp deltas) on `stream`.
// `params` (41 floats) is a host array copied into the kernel's by-value
// argument; the orbit streams are device arrays (the lo streams unused by
// the f32 tier); writes n (int32), zx, zy, want and rounds (f32), each
// (height, width), row-major.  Returns the cudaError_t of the launch.
int fr_perturbation(int tier, const float* params, const void* ore,
                    const void* oim, const void* orl, const void* oil,
                    int width, int height, int map_height, int max_passes,
                    void* n_out, void* zx_out, void* zy_out, void* want_out,
                    void* rounds_out, void* stream) {
  PertParams p;
  std::memcpy(p.v, params, sizeof(p.v));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* re = static_cast<const float*>(ore);
  const auto* im = static_cast<const float*>(oim);
  const auto* rl = static_cast<const float*>(orl);
  const auto* il = static_cast<const float*>(oil);
  auto* n = static_cast<int*>(n_out);
  auto* zx = static_cast<float*>(zx_out);
  auto* zy = static_cast<float*>(zy_out);
  auto* want = static_cast<float*>(want_out);
  auto* rounds = static_cast<float*>(rounds_out);
  switch (tier) {
    case kF32:
      pert_mandelbrot_kernel<kF32><<<grid, block, 0, s>>>(
          p, re, im, rl, il, width, height, map_height, max_passes, n, zx, zy,
          want, rounds);
      break;
    case kDD:
      pert_mandelbrot_kernel<kDD><<<grid, block, 0, s>>>(
          p, re, im, rl, il, width, height, map_height, max_passes, n, zx, zy,
          want, rounds);
      break;
    case kFX:
      pert_mandelbrot_kernel<kFX><<<grid, block, 0, s>>>(
          p, re, im, rl, il, width, height, map_height, max_passes, n, zx, zy,
          want, rounds);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
