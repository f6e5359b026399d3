// Floatexp (dd mantissa + i32 exponent) and Burning Ship diffabs device
// arithmetic for K3 (csrc/pert_kernel.cuh): one definition of the operation
// order of fractalrenderer_tpu/ops/perturbation.py:64-242 and of the port's
// plain versions (fractalrenderer_tpu_torch/ops/perturbation.py _rfe_*,
// _cfe_*, _diffabs, _dd_diffabs).
//
// A real floatexp x = (m, e) is dd_value(m) * 2^e; a complex one (r, i, e)
// shares one exponent between its components, normalised on
// max(|r.hi|, |i.hi|).  Exponent kEZero marks an exact zero.  2^k is built in
// the exponent field, floor(log2|x|) read from it, and exponents are clipped
// in i32, as the TPU kernel does; build with -fmad=false (csrc/dd.cuh).

#ifndef FR_FLOATEXP_CUH_
#define FR_FLOATEXP_CUH_

#include "dd.cuh"

// Exponent of an exact floatexp zero (perturbation.py:61).
constexpr int kEZero = -(1 << 24);
constexpr int kEMax = 1 << 24;

// perturbation.py _pow2: 2^k for integer k through the exponent field
// (0 below 2^-126, 2^127 above).
static __device__ __forceinline__ float pow2i(int k) {
  const int kc = min(max(k, -126), 127);
  const float f = __int_as_float((kc + 127) << 23);
  return k < -126 ? 0.0f : f;
}

// perturbation.py _expo: floor(log2 |x|) from the exponent field.
static __device__ __forceinline__ int expo(float x) {
  return ((__float_as_int(x) >> 23) & 0xFF) - 127;
}

// torch.maximum / jnp.maximum: NaN-propagating.
static __device__ __forceinline__ float tmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

static __device__ __forceinline__ int clip_exp(int e) {
  return min(max(e, kEZero), kEMax);
}

static __device__ __forceinline__ dd_t scl(dd_t v, float f) {
  return {v.hi * f, v.lo * f};
}

// Complex product of dd components: (ar + i ai)(br + i bi).
static __device__ __forceinline__ void cmul_dd(dd_t ar, dd_t ai, dd_t br,
                                               dd_t bi, dd_t& rr, dd_t& ri) {
  rr = dd_sub(dd_mul(ar, br), dd_mul(ai, bi));
  ri = dd_add(dd_mul(ar, bi), dd_mul(ai, br));
}

struct rfe_t {
  dd_t m;
  int e;
};

struct cfe_t {
  dd_t r, i;
  int e;
};

// _rfe_norm: mantissa hi -> [1, 2), or an exact zero -> kEZero.
static __device__ __forceinline__ rfe_t rfe_norm(dd_t m, int ex) {
  const bool zero = m.hi == 0.0f;
  const int k = zero ? 0 : expo(m.hi);
  return {scl(m, pow2i(-k)), zero ? kEZero : clip_exp(ex + k)};
}

static __device__ __forceinline__ rfe_t rfe_from_dd(float hi, float lo) {
  return rfe_norm({hi, lo}, 0);
}

static __device__ __forceinline__ rfe_t rfe_add(rfe_t a, rfe_t b) {
  const int em = max(a.e, b.e);
  return rfe_norm(dd_add(scl(a.m, pow2i(a.e - em)), scl(b.m, pow2i(b.e - em))),
                  em);
}

static __device__ __forceinline__ rfe_t rfe_mul(rfe_t a, rfe_t b) {
  return rfe_norm(dd_mul(a.m, b.m), a.e + b.e);
}

static __device__ __forceinline__ rfe_t rfe_neg(rfe_t a) {
  return {dd_neg(a.m), a.e};
}

// Exact multiply by 2^k (kEZero stays absorbing).
static __device__ __forceinline__ rfe_t rfe_scale_pow2(rfe_t a, int k) {
  return {a.m, a.e == kEZero ? a.e : a.e + k};
}

static __device__ __forceinline__ rfe_t rfe_select(bool c, rfe_t a,
                                                   rfe_t b) {
  return c ? a : b;
}

static __device__ __forceinline__ float rfe_to_f32(rfe_t a) {
  return dd_to_float(a.m) * pow2i(a.e);
}

static __device__ __forceinline__ cfe_t cfe_norm(dd_t mr, dd_t mi, int ex) {
  const float mag = tmax(fabsf(mr.hi), fabsf(mi.hi));
  const bool zero = mag == 0.0f;
  const int k = zero ? 0 : expo(mag);
  const float f = pow2i(-k);
  return {scl(mr, f), scl(mi, f), zero ? kEZero : clip_exp(ex + k)};
}

// Join two real floatexps into one complex floatexp.
static __device__ __forceinline__ cfe_t cfe_from_rr(rfe_t x, rfe_t y) {
  const int em = max(x.e, y.e);
  return cfe_norm(scl(x.m, pow2i(x.e - em)), scl(y.m, pow2i(y.e - em)), em);
}

static __device__ __forceinline__ cfe_t cfe_add(cfe_t a, cfe_t b) {
  const int em = max(a.e, b.e);
  const float fa = pow2i(a.e - em), fb = pow2i(b.e - em);
  return cfe_norm(dd_add(scl(a.r, fa), scl(b.r, fb)),
                  dd_add(scl(a.i, fa), scl(b.i, fb)), em);
}

static __device__ __forceinline__ cfe_t cfe_mul(cfe_t a, cfe_t b) {
  dd_t mr, mi;
  cmul_dd(a.r, a.i, b.r, b.i, mr, mi);
  return cfe_norm(mr, mi, a.e + b.e);
}

// |a|^2 < |b|^2 at hi-mantissa precision.
static __device__ __forceinline__ bool cfe_mag2_lt(cfe_t a, cfe_t b) {
  const float ma = a.r.hi * a.r.hi + a.i.hi * a.i.hi;
  const float mb = b.r.hi * b.r.hi + b.i.hi * b.i.hi;
  const int em = max(a.e, b.e);
  return ma * pow2i(2 * (a.e - em)) < mb * pow2i(2 * (b.e - em));
}

// _diffabs: |X + d| - |X| by sign cases (exact in the four cases).
static __device__ __forceinline__ float diffabs(float X, float d) {
  const float s = X + d;
  if (X >= 0.0f) return s >= 0.0f ? d : -(2.0f * X + d);
  return s >= 0.0f ? 2.0f * X + d : -d;
}

// _dd_sign_nonneg: the sign of a dd value at full dd accuracy.
static __device__ __forceinline__ bool dd_sign_nonneg(dd_t v) {
  return (v.hi > 0.0f) || (v.hi == 0.0f && v.lo >= 0.0f);
}

static __device__ __forceinline__ dd_t dd_abs_by(dd_t v, bool pos) {
  return pos ? v : dd_neg(v);
}

// _dd_diffabs: the signs of X and X + d decided at dd accuracy.
static __device__ __forceinline__ dd_t dd_diffabs(dd_t X, dd_t d) {
  const dd_t t = dd_add({X.hi * 2.0f, X.lo * 2.0f}, d);
  const dd_t s = dd_add(X, d);
  const bool xpos = dd_sign_nonneg(X);
  const bool spos = dd_sign_nonneg(s);
  if (xpos) return spos ? d : dd_neg(t);
  return spos ? t : dd_neg(d);
}

#endif  // FR_FLOATEXP_CUH_
