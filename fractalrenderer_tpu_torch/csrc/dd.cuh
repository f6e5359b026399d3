// Double-double (two-f32) device arithmetic shared by K2
// (csrc/dd_escape.cu) and K3 (csrc/perturbation.cu): one definition of the
// dd operation order, that of fractalrenderer_tpu/ops/dd.py and of the
// port's plain versions (fractalrenderer_tpu_torch/ops/dd.py).
//
// Exactness.  Build with -fmad=false and without --use_fast_math: the error
// terms of two_sum and two_prod only hold when no operation is contracted
// or reassociated, and the dd operation order is the JAX package's.
//
// two_prod is one exact fmaf: err = fmaf(a, b, -p) is the rounding error of
// p = a * b, exactly, wherever it is representable.  The TPU kernel needed
// Dekker's two Veltkamp splits and four partial products (its VPU has no
// f32 FMA); the card issues the product and its error in two instructions
// instead of ~16.  The plain versions (ops/dd.py two_prod) compute the same
// number with no fused operation: a * b in f64 is exact (24 + 24 bits <=
// 53), subtracting f64(p) is exact, and the one rounding to f32 is the
// fmaf's.  That equals Dekker's error wherever neither the product nor its
// exact error is subnormal; in that zone the fmaf is the correctly rounded one
// (and XLA:CPU, which runs the JAX reference in the tests, flushes it).
// Only two_prod is fused: dd_mul's cross terms stay unfused, because
// fusing them would round differently from the JAX package.

#ifndef FR_DD_CUH_
#define FR_DD_CUH_

struct dd_t {
  float hi, lo;
};

// ops/dd.py two_prod: a * b = p + err exactly (one fmaf; __fmaf_rn issues
// FFMA under -fmad=false too).
static __device__ __forceinline__ void two_prod(float a, float b, float& p,
                                                float& err) {
  p = a * b;
  err = __fmaf_rn(a, b, -p);
}

// ops/dd.py dd_add.
static __device__ __forceinline__ dd_t dd_add(dd_t a, dd_t b) {
  const float s = a.hi + b.hi;
  const float v = s - a.hi;
  const float t = ((b.hi - v) + (a.hi - (s - v))) + (a.lo + b.lo);
  const float hi = s + t;
  return {hi, t - (hi - s)};
}

// ops/dd.py dd_neg and dd_sub (an add of the negation, as there).
static __device__ __forceinline__ dd_t dd_neg(dd_t a) {
  return {-a.hi, -a.lo};
}
static __device__ __forceinline__ dd_t dd_sub(dd_t a, dd_t b) {
  return dd_add(a, dd_neg(b));
}

// ops/dd.py dd_mul_float.
static __device__ __forceinline__ dd_t dd_mul_float(dd_t a, float b) {
  float p, e;
  two_prod(a.hi, b, p, e);
  float lo = a.lo * b + e;
  const float hi = p + lo;
  lo = lo - (hi - p);
  return {hi, lo};
}

// ops/dd.py dd_mul.
static __device__ __forceinline__ dd_t dd_mul(dd_t a, dd_t b) {
  float p, e;
  two_prod(a.hi, b.hi, p, e);
  e = e + (a.hi * b.lo + a.lo * b.hi);
  const float hi = p + e;
  return {hi, e - (hi - p)};
}

// ops/dd.py dd_to_float.
static __device__ __forceinline__ float dd_to_float(dd_t a) {
  return a.hi + a.lo;
}

#endif  // FR_DD_CUH_
